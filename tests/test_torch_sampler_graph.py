"""The render layer's sampler replayed as CUDA graphs (`models/sampler_graph.py`).

Without a card: the policy that decides which call runs eagerly, captures or
replays; the static buffers' layout; the renderer's CPU path, which runs the
eager chain and counts `sampler.eager`; the chain of every configured branch,
which must move no data to or from the host, as a capture refuses that. Marked `cuda` (skipped where there is
no NVIDIA GPU): replay against the eager chain at taichi01's widths, bit for
bit, across new rays, noise and poses, an in-place Adam step and a replaced
parameter, with the counters a replay advances. This file imports nothing of
JAX, so on a machine with a card and no JAX it runs alone:

    python -m pytest tests/test_torch_sampler_graph.py -m cuda --noconftest -q
"""

import copy
import os
import pickle

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multiply_tpu_torch.models import sampler_graph
from multiply_tpu_torch.models.sampler_graph import CAPACITY, CAPTURE, EAGER, MEMORY, REPLAY, GraphPolicy, SamplerGraphs
from multiply_tpu_torch.ops import knn_cuda
from multiply_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counter(name: str) -> int:
    return sum(n for k, _, n in profiling.records()["counters"] if k == name)


# ---------------------------------------------------------------------------
# the policy, without a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("repeats", [2, 3, 10])
def test_policy_first_sighting_eager_second_captures_then_replays(repeats):
    policy = GraphPolicy()
    plans = []
    for _ in range(repeats):
        plan = policy.plan("a")
        if plan == CAPTURE:
            policy.keep("a", object())
        plans.append(plan)
    assert plans == [EAGER, CAPTURE] + [REPLAY] * (repeats - 2)


def test_policy_a_signature_seen_once_stays_eager():
    """A full-frame render: 512-pixel chunks, then one ragged last chunk."""
    policy = GraphPolicy()
    plans = []
    for key in ["chunk"] * 5 + ["ragged"]:
        plan = policy.plan(key)
        if plan == CAPTURE:
            policy.keep(key, object())
        plans.append(plan)
    assert plans == [EAGER, CAPTURE, REPLAY, REPLAY, REPLAY, EAGER]
    assert list(policy.graphs) == ["chunk"] and list(policy.seen) == ["ragged"]


@pytest.mark.parametrize("extra", [1, 2, 3])
def test_policy_keeps_at_most_capacity_graphs_least_recent_out(extra):
    policy = GraphPolicy()
    keys = [f"k{i}" for i in range(CAPACITY + extra)]
    for key in keys:
        for _ in range(2):
            if policy.plan(key) == CAPTURE:
                policy.keep(key, object())
    assert list(policy.graphs) == keys[-CAPACITY:]
    # an evicted signature is a new one again: eager first, then a capture
    assert policy.plan(keys[0]) == EAGER and policy.plan(keys[0]) == CAPTURE
    # a replay makes its graph the most recent one
    policy.plan(keys[-CAPACITY])
    assert next(reversed(policy.graphs)) == keys[-CAPACITY]


def test_policy_remembers_a_bounded_number_of_signatures():
    policy = GraphPolicy()
    for i in range(MEMORY + 3):
        assert policy.plan(i) == EAGER
    assert list(policy.seen) == list(range(3, MEMORY + 3)) and not policy.graphs
    assert policy.plan(0) == EAGER  # forgotten
    assert policy.plan(MEMORY + 2) == CAPTURE


def test_graphs_start_empty_in_a_copy_or_a_pickle():
    graphs = SamplerGraphs()
    graphs.policy.keep("k", object())
    graphs.policy.seen["s"] = None
    for other in (copy.deepcopy(graphs), pickle.loads(pickle.dumps(graphs))):
        assert not other.policy.graphs and not other.policy.seen
        assert other._stream is None and other._pool is None


@pytest.mark.parametrize("case", ["expanded", "strided", "scalar", "contiguous"])
def test_static_buffers_are_laid_out_as_the_inputs(case):
    def make(base):  # a signature includes the strides: a later call's input is laid out alike
        return {"expanded": base[0, 1:4].expand(5, 3), "strided": base[:, ::2], "scalar": base[1, 1],
                "contiguous": base}[case]

    base = torch.arange(24.0).reshape(4, 6)
    t, later = make(base), make(base * 2)
    rec = sampler_graph._Recorded({"x": t, "none": None}, ())
    assert rec.views["none"] is None
    view = rec.views["x"]
    assert view.shape == t.shape and view.stride() == t.stride()
    rec.load({"x": later, "none": None})
    assert torch.equal(view, later)


def test_nn1_holes_take_only_cuda_calls_and_close_on_errors():
    q, r = torch.randn(2, 5, 3), torch.randn(2, 7, 3)
    taken = []
    with knn_cuda.nn1_holes(lambda *a: taken.append(a)):
        d2, idx = knn_cuda.nn1(q, r)  # CPU tensors: the plain version, no hole
    assert not taken and d2.shape == (2, 5, 1)
    with pytest.raises(RuntimeError):
        with knn_cuda.nn1_holes(lambda *a: None):
            raise RuntimeError("inside")
    assert knn_cuda._holes.fn is None


# ---------------------------------------------------------------------------
# the renderer on the CPU: the eager chain, as before
# ---------------------------------------------------------------------------


def _small_conf(implicit=(), rendering=(), **top):
    """A small model config; `implicit` and `rendering` update its two foreground nets."""
    from multiply_tpu_torch.config import Config

    dims = [64] * 4
    return Config({
        "dim_frame_encoding": 32,
        "implicit_network": {"feature_vector_size": 16, "d_in": 3, "d_out": 1, "dims": dims,
                             "init": "geometry", "bias": 0.6, "skip_in": [2], "weight_norm": True,
                             "multires": 6, "cond": "smpl", "scene_bounding_sphere": 3.0, **dict(implicit)},
        "rendering_network": {"feature_vector_size": 16, "mode": "pose_no_view", "d_in": 14,
                              "d_out": 3, "dims": [32], "weight_norm": True, "multires_view": -1,
                              **dict(rendering)},
        "bg_implicit_network": {"feature_vector_size": 16, "d_in": 4, "d_out": 1, "dims": [32, 32],
                                "init": "none", "bias": 0.0, "skip_in": [], "weight_norm": False,
                                "multires": 4, "cond": "frame"},
        "bg_rendering_network": {"feature_vector_size": 16, "mode": "nerf_frame_encoding", "d_in": 3,
                                 "d_out": 3, "dims": [16], "weight_norm": False, "multires_view": 2},
        "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
        "ray_sampler": {"near": 0.0, "eps": 0.1, "add_tiny": 1e-6, "N_samples": 8, "N_samples_eval": 16,
                        "N_samples_extra": 4, "beta_iters": 3, "max_total_iters": 3,
                        "N_samples_inverse_sphere": 4},
        **top,
    })


class _Spy:
    """Wraps a renderer's `sampler_graphs`: keeps each call's chain, inputs,
    flags, result and what the call advanced `nn1.launches` and
    `sampler.points` by."""

    def __init__(self, renderer):
        self.graphs, self.calls = renderer.sampler_graphs, []
        renderer.sampler_graphs = self

    def __call__(self, chain, inputs, flags, leaves):
        nn1, points = knn_cuda.nn1.launches, _counter("sampler.points")
        out = self.graphs(chain, inputs, flags, leaves)
        self.calls.append({"chain": chain, "inputs": inputs, "flags": flags, "out": out,
                           "nn1": knn_cuda.nn1.launches - nn1, "points": _counter("sampler.points") - points})
        return out


def _program(dev, P, conf, num_verts=386, frames=4, grid_res=16):
    from multiply_tpu_torch.body.smpl import synthetic_body_model
    from multiply_tpu_torch.data.synthetic import make_scene
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    model = synthetic_body_model(num_verts=num_verts, device=dev)
    scene = make_scene(num_frames=frames, num_persons=P, height=24, width=32, model=model, device=dev)
    renderer = MultiplyRenderer(conf, P, frames, generator=torch.Generator(dev).manual_seed(0), device=dev)
    state = renderer.build_person_state(scene.servers, grid_res=grid_res)
    return scene, renderer, state


@pytest.fixture(scope="module")
def cpu_program():
    """One small program on the CPU for the module's CPU tests (the grid only feeds the training extras)."""
    return _program("cpu", 2, _small_conf(), frames=2, grid_res=8)


def _call_inputs(scene, renderer, state, dev, R, i, epoch=600):
    """Call i's render request and noise: new rays, a new frame's poses with
    jitter (new SMPL verts), new noise."""
    from multiply_tpu_torch.models.renderer import RenderInputs

    gen = torch.Generator(dev).manual_seed(1000 + i)
    f = i % len(scene.poses)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    uv = torch.rand((R, 2), generator=gen, device=dev) * t([scene.width, scene.height])
    thetas = t(scene.poses[f]) + 0.05 * torch.randn(t(scene.poses[f]).shape, generator=gen, device=dev)
    inputs = RenderInputs(uv=uv, pose=t(scene.cam_pose[f]), intrinsics=t(scene.intrinsics), scale=t(scene.scale),
                          transl=t(scene.transl[f]), thetas=thetas, betas=t(scene.betas), frame_idx=f, epoch=epoch)
    noise = renderer.draw_noise(R, state.server.verts_c.shape[-2], generator=gen)
    return inputs, noise


def _eager(call):
    """The chain run eagerly on a call's inputs: (result, points it counted)."""
    tally = []
    with torch.no_grad():
        out = call["chain"](call["inputs"], tally.append)
    return out, sum(tally)


@pytest.mark.parametrize("bbox", [False, True], ids=["sphere", "bbox"])
def test_cpu_render_runs_the_eager_chain_and_counts_it(cpu_program, bbox, monkeypatch):
    """CPU tensors never take a graph: every call runs the chain eagerly,
    counts `sampler.eager`, and gives what the sampler gives on the renderer's
    own SDF (the code before the graphs)."""
    from multiply_tpu_torch.models.ray_sampler import error_bound_sample
    from multiply_tpu_torch.models.renderer import OUTLIER_SDF

    scene, renderer, state = cpu_program
    monkeypatch.setattr(renderer, "bbox_ray_range", bbox)
    monkeypatch.setattr(renderer, "sampler_graphs", renderer.sampler_graphs)  # the spy is taken off after
    spy = _Spy(renderer)
    eager, caps, reps = (_counter(f"sampler.{n}") for n in ("eager", "graph_captures", "graph_replays"))
    for i in range(2):
        for train in (True, False):
            inputs, noise = _call_inputs(scene, renderer, state, "cpu", 16, i)
            with torch.no_grad():
                renderer.render(state, inputs, train=train, noise=noise if train else None)
            call = spy.calls[-1]
            assert call["flags"] == (train, False)
            inp = call["inputs"]
            assert (inp["near"] is None) == (not bbox) and (inp["u"] is None) == (not train)

            def sdf_only(pts, inp=inp, train=train):
                x_c, outlier = state.deformer.inverse(pts, inp["tfs"], inp["verts"])
                sdf = renderer._implicit(x_c, inp["cond"], inp["betas"])[..., 0]
                return sdf if train else torch.where(outlier, OUTLIER_SDF, sdf)

            with torch.no_grad():
                want = error_bound_sample(
                    renderer.sampler_cfg, sdf_only, inp["ray_o"], inp["ray_d"], inp["beta0"], 2,
                    noise={"u": noise["sampler_u"], "perm": noise["sampler_perm"]} if train else None,
                    ray_range=(inp["near"], inp["far"]) if bbox else None)
            assert torch.equal(call["out"]["z_vals"], want["z_vals"])
            assert torch.equal(call["out"]["beta_final"], want["beta_final"])
            cfg = renderer.sampler_cfg
            # z0 and the far ends, then one evaluation a later round
            assert call["points"] == 2 * 16 * (cfg.N_samples_eval * cfg.max_total_iters + 1) and call["nn1"] == 0
    assert _counter("sampler.eager") - eager == 4
    assert (_counter("sampler.graph_captures") - caps, _counter("sampler.graph_replays") - reps) == (0, 0)
    assert not spy.graphs.policy.graphs and not spy.graphs.policy.seen


class _HostTraffic(TorchDispatchMode):
    """Records the operations that a CUDA graph capture refuses: a tensor made
    from host data (`lift_fresh`: `torch.tensor`, indexing by a list, which
    copies from the host on the card) and a read back to the host (`.item()`,
    `nonzero`, indexing by a boolean mask)."""

    REFUSED = (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default)
    INDEXED = (torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default, torch.ops.aten.index_put_.default)

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED or (
            func in self.INDEXED and any(t is not None and t.dtype == torch.bool for t in args[1])
        ):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


# every branch of `_implicit` and of the sampler that a configuration selects
CHAIN_VARIANTS = {
    "smpl": {},
    "bf16-bbox": {"sampler_bf16": True, "bbox_ray_range": True},
    "fourier": {"implicit": {"embedder_mode": "fourier"}},
    "smpl_tri": {"implicit": {"cond": "smpl_tri", "triplane_resolution": 8}, "sampler_bf16": True},
    "multi_triplane": {"implicit": {"cond": "smpl_tri", "multi_triplane": True, "triplane_res": [8, 4]}},
    "shared_net": {"use_person_encoder": True, "sampler_bf16": True,
                   "implicit": {"cond": "smpl_id", "offset_head": True, "beta_encoding": True},
                   "rendering": {"mode": "pose_id_no_view"}},
}


@pytest.mark.parametrize("variant", list(CHAIN_VARIANTS))
def test_sampler_chain_moves_no_data_to_or_from_the_host(variant):
    """What a capture refuses, seen on the CPU: the chain of every configured
    branch, training and full-frame, makes no tensor from host data and reads
    nothing back, so on the card it records as one graph."""
    scene, renderer, state = _program("cpu", 2, _small_conf(**CHAIN_VARIANTS[variant]), frames=2, grid_res=8)
    spy = _Spy(renderer)
    for train in (True, False):
        inputs, noise = _call_inputs(scene, renderer, state, "cpu", 16, 0)
        with torch.no_grad():
            renderer.render(state, inputs, train=train, noise=noise if train else None)
        with _HostTraffic() as mode:
            _eager(spy.calls[-1])
        assert mode.found == [], f"train={train}: {mode.found}"


def test_implicit_leaves_are_what_the_chain_reads(cpu_program):
    _, renderer, _ = cpu_program
    leaves = {t.data_ptr() for t in renderer._implicit_leaves()}
    assert leaves == {p.data_ptr() for p in renderer.fg_implicit.parameters()}
    assert renderer.beta.data_ptr() not in leaves


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the nn1 kernel have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _taichi01_conf(preset="taichi01_model", **top):
    """taichi01's model config; `taichi01_fast_model` adds `sampler_bf16` and
    `bbox_ray_range` (the sampler's near and far as inputs), as the synthetic
    configurations do."""
    from multiply_tpu_torch.config import load_config

    return load_config(os.path.join(ROOT, "confs", "model", f"{preset}.yaml"), top or None)


def _check_call(call, plan):
    """The call's result equals the eager chain's bit for bit, and it
    advanced `nn1.launches` and `sampler.points` as an eager call does."""
    want, points = _eager(call)
    for k in ("z_vals", "beta_final"):
        got = call["out"][k]
        err = (got - want[k]).abs().max().item()
        assert torch.equal(got, want[k]), f"{plan} call: {k} differs from eager by {err}"
    assert call["points"] == points and points > 0
    return call["nn1"]


@pytest.mark.cuda
@pytest.mark.parametrize("P,preset,top", [
    (2, "taichi01_model", {}), (3, "taichi01_model", {}), (2, "taichi01_model", {"sampler_bf16": True}),
    (2, "taichi01_fast_model", {}), (3, "taichi01_fast_model", {}),
    (2, "taichi01_fast_model", {"implicit_network": {"cond": "smpl_tri"}}),
    (2, "taichi01_model", {"implicit_network": {"cond": "smpl_tri", "multi_triplane": True}}),
], ids=["P2", "P3", "P2-bf16", "P2-fast", "P3-fast", "P2-fast-triplane", "P2-multi-triplane"])
def test_replay_is_bit_equal_to_eager_on_card(cuda_device, P, preset, top):
    """taichi01's widths and sampler (5 rounds x 128 evaluations, 10 bisection
    steps) at R = 512 on the 6,890-vertex body: eager, capture, then replays
    with new rays, noise and poses, after an in-place Adam step on the
    implicit net, and after a parameter is given new storage. The fast preset
    hands the sampler the box's near and far; `cond: smpl_tri` adds the
    tri-plane (or the pyramid) to the chain."""
    dev = cuda_device
    scene, renderer, state = _program(dev, P, _taichi01_conf(preset, **top), num_verts=6890)
    assert renderer.bbox_ray_range == (preset == "taichi01_fast_model")
    spy = _Spy(renderer)
    names = ("eager", "graph_captures", "graph_replays")

    def render(i):
        before = [_counter(f"sampler.{n}") for n in names]
        inputs, noise = _call_inputs(scene, renderer, state, dev, 512, i)
        renderer.render(state, inputs, train=True, noise=noise)
        torch.cuda.synchronize()
        return tuple(_counter(f"sampler.{n}") - b for n, b in zip(names, before))

    assert render(0) == (1, 0, 0)
    assert (spy.calls[-1]["inputs"]["near"] is not None) == renderer.bbox_ray_range
    eager_nn1 = _check_call(spy.calls[-1], EAGER)
    cfg = renderer.sampler_cfg
    assert eager_nn1 == cfg.max_total_iters + 1  # z0, far, one a later round
    assert render(1) == (0, 1, 0)
    assert _check_call(spy.calls[-1], CAPTURE) == eager_nn1
    for i in (2, 3, 4):
        assert render(i) == (0, 0, 1)
        assert _check_call(spy.calls[-1], REPLAY) == eager_nn1

    # an in-place Adam step on the implicit net: the graph reads the new weights
    opt = torch.optim.Adam(renderer.fg_implicit.parameters(), lr=1e-3)
    gen = torch.Generator(dev).manual_seed(7)
    for p in renderer.fg_implicit.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device=dev)
    ptrs = [p.data_ptr() for p in renderer.fg_implicit.parameters()]
    opt.step()
    assert ptrs == [p.data_ptr() for p in renderer.fg_implicit.parameters()]
    before = spy.calls[-1]["out"]["z_vals"]
    assert render(4) == (0, 0, 1)
    assert _check_call(spy.calls[-1], REPLAY) == eager_nn1
    assert not torch.equal(spy.calls[-1]["out"]["z_vals"], before)  # same rays and noise, new weights

    # a parameter given new storage: captured anew, then replayed
    layer = renderer.fg_implicit.lins[3]
    layer.weight.data = layer.weight.data.clone()
    assert render(5) == (0, 1, 0)
    assert _check_call(spy.calls[-1], CAPTURE) == eager_nn1
    assert render(6) == (0, 0, 1)
    assert _check_call(spy.calls[-1], REPLAY) == eager_nn1
    assert len(spy.graphs.policy.graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["taichi01_model", "taichi01_fast_model"])
def test_eval_chunks_replay_and_the_ragged_chunk_stays_eager_on_card(cuda_device, preset):
    """Full-frame renders (`train=False`): repeated 512-ray chunks replay,
    the last, shorter chunk runs eagerly; every result equals the eager chain."""
    dev = cuda_device
    scene, renderer, state = _program(dev, 2, _taichi01_conf(preset), num_verts=6890)
    spy = _Spy(renderer)
    plans = []
    for i, R in enumerate([512, 512, 512, 512, 200]):
        before = (_counter("sampler.eager"), _counter("sampler.graph_captures"))
        inputs, _ = _call_inputs(scene, renderer, state, dev, R, i)
        with torch.no_grad():
            renderer.render(state, inputs, train=False)
        torch.cuda.synchronize()
        after = (_counter("sampler.eager"), _counter("sampler.graph_captures"))
        plan = EAGER if after[0] > before[0] else CAPTURE if after[1] > before[1] else REPLAY
        plans.append(plan)
        _check_call(spy.calls[-1], plan)
    assert plans == [EAGER, CAPTURE, REPLAY, REPLAY, EAGER]
