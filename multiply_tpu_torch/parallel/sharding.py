"""Several devices: the rays of each step split over processes, one rank a
process, parameters replicated, gradients summed by one collective a step.

Counterpart of `multiply_tpu/parallel/sharding.py`. JAX runs one program over
a 1-D `rays` mesh and lets XLA insert the gradient all-reduce; here each rank
is a process with its own host thread (the step is launch-bound, so one
thread issuing to N devices would serialise N times its launches), joined by
`torch.distributed`:
  * `init_ray_group` / `close_ray_group` take the place of `make_mesh`: a
    `RayGroup` holds the rank, the world size, the rank's device and the
    backend; rendezvous goes through a file (`FileStore`), never a port;
  * `replicate` broadcasts rank 0's tensors into every rank's own;
  * `shard_batch`, `shard_render_inputs` and `shard_noise` are pure functions
    of (rank, world): per-ray fields are chosen by name and split, everything
    else is kept whole;
  * `sharded_train_step` is `TrainStep.step` on this rank's share of the rays:
    the loss is written so that the ranks' shares sum to the whole batch's
    loss (`models/loss.py::RayShare`), so the SUM of their gradients is the
    one-device gradient, and the update is taken on the summed gradients;
  * `launch` runs a function on several ranks: rank 0 in the calling process
    (it is the controller, as JAX's single program is), the others spawned.

With `gloo` on CUDA tensors every collective stages through the host
explicitly (`RayGroup._host`): two ranks on one card, as the smoke run has,
cannot use NCCL, and the backend is never switched behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models.loss import RayShare

RAY_AXIS = "rays"
# Batch fields that carry a per-ray leading axis (engine/train.py Batch);
# everything else (camera pose, intrinsics, frame index, scale) replicates.
PER_RAY_FIELDS = ("uv", "rgb", "sam_mask")
# the training noise's per-ray draws and their ray axis (`MultiplyRenderer.draw_noise`);
# every other key (sampler_perm, eik_*, surface_idx, zero_pose_idx, interp_idx) is whole on each rank
RAY_NOISE_AXES = {"sampler_u": 1, "bg_u": 0}


@dataclass
class RayGroup:
    """One rank's view of the process group that splits the rays."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def _host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _run(self, op: Callable, t: torch.Tensor, *args) -> torch.Tensor:
        """`op(t, *args)` in place; `gloo` works on a host copy of a CUDA tensor."""
        if self._host(t):
            host = t.cpu()
            op(host, *args)
            t.copy_(host)
        else:
            op(t, *args)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        return self._run(dist.all_reduce, t)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` into every rank's, in place; returns it."""
        return self._run(dist.broadcast, t, 0)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (the same shape on each), concatenated in rank order along axis 0."""
        src = t.cpu() if self._host(t) else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)

    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, device=None if self.backend == "gloo" else self.device)
        return box[0]


def init_ray_group(rank: int, world_size: int, device, backend: str, init_file: str,
                   timeout_s: float = 120.0) -> RayGroup:
    """Join the default process group through the file `init_file` (a
    `FileStore`: no port, so parallel test runs and machines without a network
    work). A rank that never arrives, or a collective that never ends, raises
    after `timeout_s` instead of hanging."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return RayGroup(rank, world_size, device, backend)


def close_ray_group(group: RayGroup) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# trees of tensors
# ----------------------------------------------------------------------


class _Slot(int):
    """Where a tensor stood in a flattened tree."""


def _walk(obj, fn):
    """`obj` rebuilt with every tensor replaced by `fn(tensor)`, through dicts,
    lists, tuples, NamedTuples and dataclasses; other leaves are kept."""
    if torch.is_tensor(obj) or isinstance(obj, _Slot):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _walk(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_walk(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(v, fn) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _walk(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _tensors(tree) -> list[torch.Tensor]:
    found: list = []
    _walk(tree, lambda t: found.append(t))
    return found


def replicate(tree, group: RayGroup) -> None:
    """Overwrite every tensor of `tree` (parameters, `AdamState`s, body tables,
    `PersonState`, ...: the same shapes on every rank) with rank 0's, in place:
    one broadcast per dtype of the tensors concatenated. Non-tensor leaves (an
    Adam step count) are equal on every rank by construction and stay."""
    by_dtype: dict = {}
    for t in _tensors(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = group.broadcast(torch.cat([t.reshape(-1).to(group.device) for t in ts]))
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def broadcast_tree(tree, group: RayGroup):
    """Rank 0's `tree` on every rank (the others pass None): its structure and
    each tensor's shape and dtype in one object broadcast, then the tensors'
    bytes in one more. Tensors land on the rank's device."""
    if group.rank == 0:
        tensors = _tensors(tree)
        slots = iter(range(len(tensors)))
        layout = (_walk(tree, lambda t: _Slot(next(slots))), [(t.shape, t.dtype) for t in tensors])
    else:
        tensors, layout = None, None
    skeleton, meta = group.broadcast_object(layout)
    if not meta:
        return skeleton
    sizes = [_padded_bytes(shape, dtype) for shape, dtype in meta]
    if group.rank == 0:
        buf = torch.cat([_as_bytes(t.to(group.device), n) for t, n in zip(tensors, sizes)])
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=group.device)
    group.broadcast(buf)
    parts = buf.split(sizes)
    out = [p[: _nbytes(shape, dtype)].view(dtype).view(shape) for p, (shape, dtype) in zip(parts, meta)]
    return _walk(skeleton, lambda s: out[s])


def _nbytes(shape, dtype) -> int:
    return torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()


def _padded_bytes(shape, dtype) -> int:
    return -(-_nbytes(shape, dtype) // 8) * 8  # 8-byte aligned, so each part views as its dtype


def _as_bytes(t: torch.Tensor, size: int) -> torch.Tensor:
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return torch.cat([raw, raw.new_zeros(size - raw.numel())])


# ----------------------------------------------------------------------
# shares of the rays
# ----------------------------------------------------------------------


def _split(x: torch.Tensor, rank: int, world: int, what: str, pad_what: str = "ray batch", axis: int = 0):
    n = x.shape[axis]
    if n % world != 0:
        raise ValueError(f"{what} has {n} rays, not divisible by the {world}-rank group — pad the {pad_what} "
                         f"to a multiple of {world} (e.g. {-(-n // world) * world})")
    k = n // world
    return x.narrow(axis, rank * k, k)


def shard_rays(tree, group: RayGroup):
    """This rank's share of every tensor whose leading axis the world size
    divides; other tensors (scalars, and what does not divide) are kept whole."""
    w = group.world

    def take(x):
        if x.ndim >= 1 and x.shape[0] >= w and x.shape[0] % w == 0:
            return _split(x, group.rank, w, "tensor")
        return x

    return _walk(tree, take)


def shard_batch(batch, rank: int, world: int):
    """This rank's share of a training `Batch`: the per-ray fields, by name,
    split into `world` equal parts; the per-frame fields whole (a (4, 4)
    camera pose on 4 ranks is not a ray axis). A ray count that `world` does
    not divide raises instead of giving some rank more rays."""
    return dataclasses.replace(batch, **{
        name: _split(getattr(batch, name), rank, world, f"batch.{name}")
        for name in PER_RAY_FIELDS if getattr(batch, name) is not None
    })


def shard_render_inputs(inputs, rank: int, world: int):
    """This rank's share of a `RenderInputs`: `uv` split, everything else
    (camera, per-person SMPL parameters, indices) whole."""
    return inputs._replace(uv=_split(inputs.uv, rank, world, "inputs.uv", "pixel chunk"))


def shard_noise(noise: dict, rank: int, world: int) -> dict:
    """This rank's share of the whole batch's step noise
    (`TrainStep.draw_noise`): the per-ray draws, by name, split along their ray
    axis; the rest whole. A W-rank step so sees exactly the random numbers of
    the one-device step."""
    return {k: _split(v, rank, world, f"noise[{k!r}]", axis=RAY_NOISE_AXES[k]) if k in RAY_NOISE_AXES else v
            for k, v in noise.items()}


def sharded_train_step(builder, group: RayGroup) -> Callable:
    """`builder.step` (a `TrainStep`) over the group. The callable takes the
    whole batch and its whole noise, the same on every rank, and:
      1. computes this rank's share of the loss (per-ray terms over the whole
         batch's counts, the others weighted 1/W);
      2. differentiates it (no collective inside the graph);
      3. sums the gradients over the ranks in one flat buffer, and the logged
         terms in one small one;
      4. takes the masked Adam update behind the non-finite skip on the summed
         gradients and the summed loss, so every rank takes the same decision
         and the replicas stay bitwise equal."""
    share = RayShare(group.world, group.all_reduce_sum)

    def step(ts, batch, noise=None, generator=None, pose_batch=None):
        if noise is None:
            raise ValueError("a sharded step takes the whole batch's noise (TrainStep.draw_noise), drawn once")
        local = shard_batch(batch, group.rank, group.world)
        _, logs, grads = builder.loss_and_grads(ts, local, shard_noise(noise, group.rank, group.world),
                                                pose_batch=pose_batch, share=share)
        names = list(grads)
        flat = group.all_reduce_sum(torch.cat([grads[k].reshape(-1) for k in names]))
        grads = {k: g.view_as(grads[k]) for k, g in zip(names, flat.split([grads[k].numel() for k in names]))}
        keys = [k for k, v in logs.items() if torch.is_tensor(v)]
        summed = group.all_reduce_sum(torch.stack([logs[k].detach().float() for k in keys]))
        logs.update(zip(keys, summed.unbind()))
        return builder.update(ts, batch.mode, logs["loss"], logs, grads)

    return step


# ----------------------------------------------------------------------
# processes
# ----------------------------------------------------------------------


def _run_rank(rank, fn, args, devices, backend, init_file, timeout_s, threads=None):
    if threads is not None:
        torch.set_num_threads(threads)
    group = init_ray_group(rank, len(devices), devices[rank], backend, init_file, timeout_s)
    try:
        return fn(group, *args)
    finally:
        close_ray_group(group)


def _spawned_rank(i, *rest):
    _run_rank(i + 1, *rest)


def launch(fn: Callable, args: tuple, devices: list, backend: str, init_file: str, timeout_s: float = 120.0):
    """`fn(group, *args)` on `len(devices)` ranks, rank r on `devices[r]`:
    rank 0 in this process, the others spawned (`fn` must be a module-level
    function; `args` are pickled). Returns rank 0's result. `init_file` is the
    rendezvous file, removed before and after. The spawned ranks are joined
    within `timeout_s` of rank 0's end and terminated if they have not ended;
    a rank that failed makes this raise. CPU ranks split this process's
    threads between them."""
    import torch.multiprocessing as mp

    os.makedirs(os.path.dirname(os.path.abspath(init_file)), exist_ok=True)
    if os.path.exists(init_file):
        os.remove(init_file)
    cpu = all(torch.device(d).type == "cpu" for d in devices)
    threads = max(1, torch.get_num_threads() // len(devices)) if cpu else None
    rest = (fn, args, list(devices), backend, init_file, timeout_s)
    ctx = None
    if len(devices) > 1:
        ctx = mp.start_processes(_spawned_rank, args=(*rest, threads), nprocs=len(devices) - 1, join=False,
                                 start_method="spawn")
    own_threads = torch.get_num_threads()
    try:
        result = _run_rank(0, *rest, threads)
        if ctx is not None:
            _join(ctx, timeout_s)
        return result
    finally:
        torch.set_num_threads(own_threads)  # rank 0 ran in this process on its share
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        if os.path.exists(init_file):
            os.remove(init_file)


def _join(ctx, timeout_s: float) -> None:
    """Join spawned ranks; a failure in one raises here (`ProcessRaisedException`)."""
    import time

    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            raise TimeoutError(f"spawned ranks still running {timeout_s:.0f} s after rank 0 ended")
