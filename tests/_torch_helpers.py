"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

Builds the JAX package's small training program (`_build(full_scale=False)`)
and the port's counterpart from the same converted weights and state, and
draws the training noise along the JAX key path so both see the same numbers.
Everything runs on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def knn_direct(query, refs, k=1, chunk_size=8192):
    """What the TPU's NN kernel computes (direct differences, first index on
    ties), for the JAX side of whole-slice parity on the CPU. K > 1 keeps the
    JAX package's own path."""
    if k != 1:
        from multiply_tpu.ops.knn import knn

        return knn(query, refs, k=k, chunk_size=chunk_size)
    d = query[:, None, :] - refs[None, :, :]
    d2 = (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2
    idx = jnp.argmin(d2, axis=-1)[:, None]
    return jnp.maximum(jnp.take_along_axis(d2, idx, -1), 0.0), idx


@pytest.fixture
def direct_knn(monkeypatch):
    """Route the JAX package's K=1 NN through `knn_direct` in this test process."""
    import multiply_tpu.ops.knn_pallas as kp

    monkeypatch.setattr(kp, "knn_auto", knn_direct)


def npify(tree):
    return jax.tree.map(np.asarray, tree)


def jax_noise(key, renderer, num_rays: int, num_verts: int, surface_logits=None, pose_verts=None,
              interp_samples: int = 5120) -> dict:
    """The JAX renderer's training draws for `key`, in the port's noise layout.
    `surface_logits` (P, V) adds the SMPL-surface draw, `pose_verts` (the
    padded vertex count of a pose batch) the interpenetration samples; the
    zero-pose draw is always there."""
    P, cfg = renderer.P, renderer.sampler_cfg
    M = cfg.N_samples_eval * cfg.max_total_iters
    u, perm = [], []
    for k in jax.random.split(key, P):
        ks = jax.random.split(k, 4)
        u.append(jax.random.uniform(ks[0], (num_rays, cfg.N_samples)))
        perm.append(jax.random.permutation(ks[1], M)[: cfg.N_samples_extra])
    ek = jax.random.split(key, 2 * P)
    noise = {
        "sampler_u": np.stack(u),
        "sampler_perm": np.stack(perm).astype(np.int64),
        "bg_u": jax.random.uniform(
            jax.random.fold_in(key, 17), (num_rays, cfg.N_samples_inverse_sphere)
        ),
        "eik_idx": np.stack(
            [np.asarray(jax.random.randint(ek[p], (512,), 0, num_verts)) for p in range(P)]
        ).astype(np.int64),
        "eik_normal": np.stack([np.asarray(jax.random.normal(ek[P + p], (512, 3))) for p in range(P)]),
    }
    noise["zero_pose_idx"] = np.stack(
        [np.asarray(jax.random.randint(k, (2000,), 0, num_verts)) for k in jax.random.split(jax.random.fold_in(key, 31), P)]
    ).astype(np.int64)
    if surface_logits is not None:
        ks = jax.random.split(jax.random.fold_in(key, 23), P)
        noise["surface_idx"] = np.stack(
            [np.asarray(jax.random.categorical(ks[p], surface_logits[p], shape=(num_rays,))) for p in range(P)]
        ).astype(np.int64)
    noise = {k: torch.tensor(np.array(v)) for k, v in noise.items()}
    if pose_verts is not None:
        k7 = jax.random.fold_in(key, 7)
        n = min(interp_samples, pose_verts)
        noise["interp_idx"] = [
            torch.tensor(np.asarray(jax.random.randint(jax.random.fold_in(k7, p), (n,), 0, pose_verts)).astype(np.int64))
            for p in range(P)
        ]
    return noise


TINY = {
    "dim_frame_encoding": 8,
    "implicit_network": {"feature_vector_size": 16, "d_in": 3, "d_out": 1, "dims": [32, 32, 32],
                         "init": "geometry", "bias": 0.6, "skip_in": [2], "weight_norm": True,
                         "multires": 4, "cond": "smpl", "scene_bounding_sphere": 3.0},
    "rendering_network": {"feature_vector_size": 16, "mode": "pose_no_view", "d_in": 14, "d_out": 3,
                          "dims": [32], "weight_norm": True, "multires_view": -1},
    "bg_implicit_network": {"feature_vector_size": 16, "d_in": 4, "d_out": 1, "dims": [32, 32],
                            "init": "none", "bias": 0.0, "skip_in": [], "weight_norm": False,
                            "multires": 4, "cond": "frame"},
    "bg_rendering_network": {"feature_vector_size": 16, "mode": "nerf_frame_encoding", "d_in": 3,
                             "d_out": 3, "dims": [16], "weight_norm": False, "multires_view": 2},
    "density": {"params_init": {"beta": 0.1}, "beta_min": 1e-4},
    "ray_sampler": {"near": 0.0, "eps": 0.1, "add_tiny": 1e-6, "N_samples": 8, "N_samples_eval": 16,
                    "N_samples_extra": 4, "beta_iters": 3, "max_total_iters": 2,
                    "N_samples_inverse_sphere": 4},
    "loss": {},
}


def tiny_conf(**updates) -> dict:
    """A copy of the tiny model config; `a__b=v` sets conf["a"]["b"] = v."""
    import copy

    conf = copy.deepcopy(TINY)
    for key, value in updates.items():
        *path, last = key.split("__")
        node = conf
        for k in path:
            node = node[k]
        node[last] = value
    return conf


@functools.lru_cache(maxsize=3)
def tiny_scene(num_persons: int = 2):
    from multiply_tpu.data.synthetic import make_scene

    return make_scene(num_frames=2, num_persons=num_persons, height=24, width=32)


@functools.lru_cache(maxsize=3)
def tiny_person_state(num_persons: int = 2):
    """The JAX per-person state of the tiny scene (it does not depend on the
    model config), with uneven surface-sampling logits."""
    from multiply_tpu.config import Config as JaxConfig
    from multiply_tpu.models.renderer import MultiplyRenderer as JaxRenderer

    scene = tiny_scene(num_persons)
    logits = [np.linspace(-1.0, 1.0, s.verts_c.shape[0]).astype(np.float32) * (p + 1)
              for p, s in enumerate(scene.servers)]
    jr = JaxRenderer(JaxConfig(tiny_conf()), num_persons=num_persons, num_frames=2)
    return jr.build_person_state(scene.servers, surface_logits=logits, grid_res=8)


def tiny_program(conf: dict, loss_kw: dict | None = None, rays: int = 24, jitter: float = 0.03,
                 interp_samples: int = 64, num_persons: int = 2):
    """(JAX objects, port objects) of a tiny training program of `num_persons`
    persons built from `conf` on both sides, the JAX weights (jittered so that
    no path stays at its silent initial value) carried across by
    `convert.load_params`."""
    from multiply_tpu.body.params import BodyParamTable as JaxTable
    from multiply_tpu.config import Config as JaxConfig
    from multiply_tpu.data.synthetic import sample_rays
    from multiply_tpu.engine.train import Batch as JaxBatch
    from multiply_tpu.engine.train import TrainStep as JaxTrainStep
    from multiply_tpu.models.loss import LossConfig as JaxLossConfig
    from multiply_tpu.models.renderer import MultiplyRenderer as JaxRenderer
    from multiply_tpu_torch import convert
    from multiply_tpu_torch.body.params import BodyParamTable
    from multiply_tpu_torch.config import Config
    from multiply_tpu_torch.engine.train import Batch, TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    import copy

    loss_kw = dict(sam_start_epoch=0, **(loss_kw or {}))
    scene = tiny_scene(num_persons)
    P, F = len(scene.servers), scene.images.shape[0]
    jr = JaxRenderer(JaxConfig(copy.deepcopy(conf)), num_persons=P, num_frames=F)
    jstate = tiny_person_state(num_persons)
    jb = JaxTrainStep(jr, jstate, JaxLossConfig(**loss_kw), interp_samples=interp_samples)
    tables = [
        JaxTable.create(F, betas=scene.betas[p], global_orient=scene.poses[:, p, :3],
                        transl=scene.transl[:, p], body_pose=scene.poses[:, p, 3:])
        for p in range(P)
    ]
    from multiply_tpu.engine.optim import adam_init
    from multiply_tpu.engine.train import TrainState as JaxTrainState

    # one compiled init instead of an eager op-by-op one; the jitter in numpy
    leaves, treedef = jax.tree.flatten(jax.jit(jr.init_params)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    net = jax.tree.unflatten(
        treedef, [jnp.asarray(np.asarray(a) + jitter * rng.standard_normal(a.shape).astype(np.float32)) for a in leaves]
    )
    params = {"net": net, "body": jax.tree.map(lambda *xs: jnp.stack(xs), *tables)}
    jts = JaxTrainState(params=params, opt_joint=adam_init(params), opt_pose=adam_init(params["body"]),
                        epoch=jnp.zeros((), jnp.int32))
    r = sample_rays(scene, 1, rays, np.random.default_rng(0))
    jbatch = JaxBatch(
        uv=jnp.asarray(r["uv"]), rgb=jnp.asarray(r["rgb"]), pose=jnp.asarray(scene.cam_pose[1]),
        intrinsics=jnp.asarray(scene.intrinsics), frame_idx=jnp.asarray(1),
        smpl_scale=jnp.asarray(scene.scale), sam_mask=jnp.asarray(r["sam"]),
    )

    renderer = MultiplyRenderer(Config(copy.deepcopy(conf)), P, F, device="cpu")
    state = convert.person_state_from_jax(npify(jstate), device="cpu")
    stepper = TrainStep(renderer, state, LossConfig(**loss_kw), interp_samples=interp_samples)
    ts = stepper.init_state(BodyParamTable(*(torch.zeros(np.shape(x)) for x in jts.params["body"])))
    convert.load_params(ts.params(), npify(jts.params))  # raises on a leaf left over or missing
    b = npify(jbatch)
    batch = Batch(
        uv=torch.tensor(b.uv), rgb=torch.tensor(b.rgb), pose=torch.tensor(b.pose),
        intrinsics=torch.tensor(b.intrinsics), frame_idx=int(b.frame_idx),
        smpl_scale=torch.tensor(b.smpl_scale), sam_mask=torch.tensor(b.sam_mask),
    )
    return (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch)


def jax_step_with_grads(jb, jts, jbatch, key, jpose=None):
    """JAX's `TrainStep.step` in one compiled program: (its forward logs, the
    gradients it hands its joint Adam (every leaf, whatever the mode), the new
    train state), as numpy. The gradients are taken from inside the step, so
    the forward and backward are traced and compiled once."""
    import multiply_tpu.engine.train as jtrain

    adam_update, seen = jtrain.adam_update, []

    def spy(grads, *args, **kw):
        seen.append(grads)
        return adam_update(grads, *args, **kw)

    @jax.jit
    def jax_step(t, b, k, pb):
        seen.clear()
        new_t, logs = jb.step(t, b, k, pose_batch=pb)
        return {n: v for n, v in logs.items() if n not in ("lr", "update_skipped")}, seen[0], new_t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "adam_update", spy)
        return npify(jax_step(jts, jbatch, key, jpose))


def assert_step_matches(jax_side, port_side, epoch: int, key, jpose=None, pose=None, mode: int = 0,
                        loss_rtol: float = 2e-5, grad_rel: float = 1e-2):
    """One training step on both sides from the same weights and noise: every
    log, every gradient leaf and the updated parameters. Tolerances as in
    test_torch_step.py: the losses are f32 means over the same samples (f32
    rounding); gradients pass through second-order autograd in another
    summation order (1% of each leaf's largest entry); Adam's first step is
    ~lr*sign(g), so an entry whose gradient is near zero may move by up to
    2*lr differently, the others agree to f32 rounding of the parameter.
    Returns (logs, grads, jax logs)."""
    import copy

    from multiply_tpu_torch import convert

    jr, jstate, jb, jts, jbatch = jax_side
    renderer, state, stepper, ts, batch = port_side
    jts = jts._replace(epoch=jnp.asarray(epoch))
    jbatch = jbatch._replace(mode=jnp.asarray(mode))
    ts, batch = copy.deepcopy(ts), copy.copy(batch)
    ts.epoch, batch.mode = epoch, mode

    jlogs, jgrads, jnew = jax_step_with_grads(jb, jts, jbatch, key, jpose)
    noise = jax_noise(
        key, jr, batch.uv.shape[0], state.server.verts_c.shape[1], np.asarray(jstate.surface_sample_logits),
        None if pose is None else pose.verts_c.shape[1], stepper.interp_samples,
    )
    loss, logs, grads = stepper.loss_and_grads(ts, batch, noise=noise, pose_batch=pose)
    assert set(logs) == set(jlogs), set(logs) ^ set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]), rtol=loss_rtol, atol=1e-7, err_msg=k)
    assert set(grads) == set(ts.params())
    for name, g in grads.items():
        assert_leaf_close(name, convert.to_flax_layout(name, g), convert.flax_leaf(jgrads, name), rel=grad_rel, atol=1e-9)

    before = {k: p.detach().clone() for k, p in ts.params().items()}
    ts, step_logs = stepper.step(ts, batch, noise=noise, pose_batch=pose)
    assert step_logs["update_skipped"] == 0.0
    lr = stepper.lr
    for name, p in ts.params().items():
        f = 0.1 if name.startswith("body.") else 1.0
        got, want = convert.to_flax_layout(name, p), convert.flax_leaf(jnew.params, name)
        strict = np.abs(convert.flax_leaf(jgrads, name)) > 1e-5
        np.testing.assert_allclose(got, want, atol=2 * lr * f + 1e-6, err_msg=name)
        np.testing.assert_allclose(got[strict], want[strict], atol=2e-6, err_msg=name)
    return logs, grads, jlogs, before, ts, jnew


@functools.lru_cache(maxsize=1)
def small_program():
    """(JAX objects, port objects) of the small training program, same weights."""
    from __graft_entry__ import _build

    from multiply_tpu_torch import convert
    from multiply_tpu_torch.body.params import BodyParamTable
    from multiply_tpu_torch.config import Config
    from multiply_tpu_torch.engine.train import Batch, TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    scene, jr, jstate, jb, jts, jbatch = _build(full_scale=False)
    renderer = MultiplyRenderer(Config(jr.conf.to_dict()), jr.P, jr.num_frames, device="cpu")
    state = convert.person_state_from_jax(npify(jstate), device="cpu")
    stepper = TrainStep(renderer, state, LossConfig(sam_start_epoch=0))
    body = BodyParamTable(*(torch.zeros(np.shape(x)) for x in jts.params["body"]))
    ts = stepper.init_state(body)
    convert.load_params(ts.params(), npify(jts.params))
    b = npify(jbatch)
    batch = Batch(
        uv=torch.tensor(b.uv), rgb=torch.tensor(b.rgb), pose=torch.tensor(b.pose),
        intrinsics=torch.tensor(b.intrinsics), frame_idx=int(b.frame_idx),
        smpl_scale=torch.tensor(b.smpl_scale), sam_mask=torch.tensor(b.sam_mask),
    )
    return (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch)


def assert_leaf_close(name, got, want, rel, atol=0.0):
    """|got - want| <= rel * max|want| + atol, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    bound = rel * np.abs(want).max() + atol if want.size else atol
    assert err <= bound, f"{name}: max err {err:.3g} > {bound:.3g}"


def assert_update_matches(name, before, got, want, jax_grads, port_grads, step, grad_rel=5e-2):
    """One parameter leaf's change over one or more Adam steps (`got - before`)
    against the JAX package's from the same start (`want - before`), entry by
    entry, within a tenth of one Adam step (`step`: the learning rate times the
    leaf's factor) plus one f32 spacing of the value, which each side rounds
    its update to. `jax_grads` and `port_grads` hold each step's gradient
    (pytree layout).

    Each step's gradients must first agree within `grad_rel` of JAX's largest
    on the leaf: summed in another order, through a sampler whose discrete
    choices follow the f32 rounding, they part by a few percent of it on tiny
    programs. Adam normalises each entry's step, so an entry whose gradient is
    no larger than that noise moves by up to 2 x step either way: an entry
    whose two gradients part by more than a tenth of JAX's in some step is
    exempt, and the test shows them when any other entry parts. Returns the
    number of exempt entries that parted."""
    before, got, want = (np.asarray(a, np.float64) for a in (before, got, want))
    assert got.shape == want.shape == before.shape, (name, got.shape, want.shape, before.shape)
    gj, gp = (np.stack([np.broadcast_to(np.asarray(x, np.float64), got.shape) for x in gs])
              for gs in (jax_grads, port_grads))
    assert len(gj) == len(gp), (name, len(gj), len(gp))
    for t, (a, b) in enumerate(zip(gj, gp)):
        err, top = np.abs(b - a).max(initial=0.0), np.abs(a).max(initial=0.0)
        assert err <= grad_rel * top, f"{name}: step {t}'s gradient parts from JAX's by {err:.3g} > {grad_rel} x {top:.3g}"
    gap = np.abs((got - before) - (want - before))
    bound = 0.1 * step + np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    unresolved = (np.abs(gp - gj) > 0.1 * np.abs(gj)).any(axis=0)
    off = gap > bound
    bad = off & ~unresolved
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} of {gap.size} entries part from JAX's update by up to {gap[bad].max():.3g} "
        f"(a tenth of a step is {0.1 * step:.3g}; JAX's update there {(want - before)[bad][:4]}, the port's "
        f"{(got - before)[bad][:4]}; the gradients by step, JAX's {gj[:, bad][:, :4].tolist()}, the port's "
        f"{gp[:, bad][:, :4].tolist()})"
    )
    return int((off & unresolved).sum())


def adam_step_grads(names, pairs, b1=0.9) -> dict:
    """The gradient of one JAX Adam step per port parameter name, recovered
    from the optimizer states around it: `pairs` holds (before, after) of each
    optimizer (numpy pytrees of `AdamState`). A leaf whose count advanced saw
    (mu' - b1 mu) / (1 - b1), and exactly zero where mu' is b1 mu as f32
    rounds it; the others saw zero."""
    from multiply_tpu_torch import convert

    def holds(state, name):
        try:
            convert.flax_leaf(state.count, name)
            return True
        except (KeyError, AttributeError):  # an optimizer over part of the parameters
            return False

    out = {}
    for name in names:
        held = [(s0, s1) for s0, s1 in pairs if holds(s0, name)]
        assert held, name
        g = np.zeros(convert.flax_leaf(held[0][0].mu, name).shape)
        for s0, s1 in held:
            if int(convert.flax_leaf(s1.count, name)) != int(convert.flax_leaf(s0.count, name)):
                m0, m1 = (convert.flax_leaf(s.mu, name).astype(np.float32) for s in (s0, s1))
                decayed = np.float32(b1) * m0
                g = g + np.where(m1 == decayed, 0.0, (m1.astype(np.float64) - decayed) / (1 - b1))
        out[name] = g
    return out


def record_adam_grads(monkeypatch, module, prefix: str = "") -> list:
    """Record the gradients that each call of `module.adam_update` (the port's
    Adam) is handed for the leaves it may update, in pytree layout under
    `prefix + name`, zero on the leaves the call leaves inactive; returns the
    list it fills, one dict a call."""
    from multiply_tpu_torch import convert

    calls, adam_update = [], module.adam_update

    def recorded(grads, state, params, lr, lr_factors, active, *args, **kw):
        calls.append({prefix + k: convert.to_flax_layout(prefix + k, grads[k]) * float(bool(active[k]))
                      for k in params})
        return adam_update(grads, state, params, lr, lr_factors, active, *args, **kw)

    monkeypatch.setattr(module, "adam_update", recorded)
    return calls
