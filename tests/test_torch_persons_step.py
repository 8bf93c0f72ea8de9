"""One person and three persons through the port's renderer, training step
and pose losses, against the JAX package on the CPU.

The JAX package is generic in the person count P and ships P = 1
(`tests/test_single_person.py`) and P = 3 (`confs/synthetic_p3.yaml`,
`tests/test_renderer.py::test_three_person_render`). Where P enters: the
pairwise composite (no pair at P = 1, six ordered pairs at P = 3), the sorted
composite's person-major ties, the interpenetration loss's partners and the
silhouette colours. Each P builds one tiny program (`tiny_program`, the
2-frame 24 x 32 scene of P persons side by side) and the composites are
switched on it, so each JAX step is compiled once per case. Tolerances are
`assert_step_matches`'s, as at P = 2.

The JAX side's K=1 NN runs as direct differences (`direct_knn`), which is
what its TPU kernel computes, so both sides pick the same vertices.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_step_matches, direct_knn, jax_noise, npify, tiny_conf, tiny_program, tiny_scene  # noqa: F401
from multiply_tpu.engine import pose_losses as jpl
from multiply_tpu.engine.train import PoseLossBatch as JaxPoseLossBatch
from multiply_tpu.models.renderer import RenderInputs as JaxRenderInputs
from multiply_tpu_torch.engine import pose_losses
from multiply_tpu_torch.engine.train import MODE_POSE_ONLY, PoseLossBatch
from multiply_tpu_torch.models.renderer import RenderInputs
from test_mesh_ops import icosphere

# the pose-loss weights of confs/model/synthetic_p3_model.yaml, and a silhouette
# weight so that all three pose terms are on
LOSS_KW = dict(depth_order_weight=0.1, interpenetration_weight=0.005, silhouette_weight=0.05)


@functools.lru_cache(maxsize=2)
def program(num_persons: int):
    return tiny_program(tiny_conf(), LOSS_KW, num_persons=num_persons)


@contextlib.contextmanager
def switched(jr, renderer, **flags):
    """The renderer options `flags` set on both sides for the block."""
    old = {k: getattr(renderer, k) for k in flags}
    for k, v in flags.items():
        setattr(jr, k, v)
        setattr(renderer, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(jr, k, v)
            setattr(renderer, k, v)


def _t(x):
    return torch.tensor(np.asarray(x))


def _with_epoch(ts, epoch):
    """A copy of a port train state at `epoch` (the cached program's stays as it is)."""
    ts = copy.deepcopy(ts)
    ts.epoch = epoch
    return ts


@pytest.mark.parametrize("num_persons", [1, 3])
def test_render_matches_jax_with_both_composites(direct_knn, num_persons):
    """`render(train=False)` of P persons against JAX's, each composite: the
    composited outputs to 1e-4 (as at P = 2), `acc_person_list` (R, P) summing
    to `acc_map`, and `acc_map` at most 1 (the full-f32 cross sum)."""
    (jr, jstate, _, jts, jbatch), (renderer, state, _, ts, batch) = program(num_persons)
    jbody, idx = jts.params["body"], 1
    jin = JaxRenderInputs(
        uv=jbatch.uv, pose=jbatch.pose, intrinsics=jbatch.intrinsics, scale=jbatch.smpl_scale,
        transl=jbody.transl[:, idx], thetas=jnp.concatenate([jbody.global_orient[:, idx], jbody.body_pose[:, idx]], -1),
        betas=jbody.betas[:, 0], frame_idx=jnp.asarray(idx), epoch=jnp.asarray(1000),
    )
    inputs = RenderInputs(
        uv=batch.uv, pose=batch.pose, intrinsics=batch.intrinsics, scale=batch.smpl_scale,
        transl=ts.body.transl[:, idx], thetas=ts.body.thetas(idx), betas=ts.body.betas[:, 0], frame_idx=idx, epoch=1000,
    )
    out = {}
    for matmul in (True, False):
        with switched(jr, renderer, composite_matmul=matmul):
            want = npify(jax.jit(lambda p, s, i: jr.render(p, s, i, train=False))(jts.params["net"], jstate, jin))
            with torch.no_grad():
                got = renderer.render(state, inputs, train=False)
        for k in ("rgb_values", "acc_map", "normal_values", "acc_person_list", "bg_transmittance"):
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=f"{k} matmul={matmul}")
        np.testing.assert_array_equal(got["hit"].numpy(), want["hit"])
        assert got["acc_person_list"].shape == (batch.uv.shape[0], num_persons)
        np.testing.assert_allclose(got["acc_person_list"].sum(-1).numpy(), got["acc_map"].numpy(), atol=1e-5)
        assert float(got["acc_map"].max()) <= 1.0
        out[matmul] = got
    assert float(out[True]["acc_map"].max()) > 0.5  # the rays reach the bodies
    for k in ("rgb_values", "acc_map", "acc_person_list"):
        np.testing.assert_allclose(out[False][k].numpy(), out[True][k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("composite", ["matmul", "sort"])
@pytest.mark.parametrize("num_persons", [1, 3])
def test_train_step_matches_jax(direct_knn, num_persons, composite):
    """A joint step at epoch 30 (pose conditioning and the in-shape term on):
    every log, every gradient leaf and the update."""
    jax_side, port_side = program(num_persons)
    with switched(jax_side[0], port_side[0], composite_matmul=composite == "matmul"):
        logs, grads, *_ = assert_step_matches(jax_side, port_side, epoch=30, key=jax.random.PRNGKey(3))
    assert float(logs["loss"].detach()) > 0
    assert all(grads["net.fg_implicit.lins.0.weight"][p].abs().max() > 0 for p in range(num_persons))


def test_sampler_bf16_step_stays_in_a_band_around_jax_at_three_persons(direct_knn):
    """`sampler_bf16` with `bbox_ray_range`, as `synthetic_p3_model.yaml` sets
    them, at P = 3: the step's loss within 5% of JAX's (the band of
    `test_torch_variant_steps.py`: bf16 moves samples, which moves every later
    number), every gradient finite and f32."""
    (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch) = program(3)
    epoch, key = 30, jax.random.PRNGKey(3)
    jts = jts._replace(epoch=jnp.asarray(epoch))
    with switched(jr, renderer, sampler_bf16=True, bbox_ray_range=True):
        _, jlogs = jax.jit(lambda t, b, k: jb._forward_loss(t.params, jstate, b, t.epoch, k, None))(jts, jbatch, key)
        ts = _with_epoch(ts, epoch)
        noise = jax_noise(key, jr, batch.uv.shape[0], state.server.verts_c.shape[1])
        loss, logs, grads = stepper.loss_and_grads(ts, batch, noise=noise)
    assert abs(float(loss.detach()) - float(jlogs["loss"])) <= 0.05 * float(jlogs["loss"])
    assert all(torch.isfinite(g).all() and g.dtype == torch.float32 for g in grads.values())


# ---------------------------------------------------------------------------
# the pose losses
# ---------------------------------------------------------------------------


def _spheres(num_persons):
    """Icospheres padded to (300, 600) as the trainer pads meshes, overlapping
    along the view axis: each person 0.6 m nearer and 0.15 m to the side of
    the one before."""
    v, f = icosphere(2)
    verts, faces = [], []
    for p in range(num_persons):
        pv = np.zeros((300, 3), np.float32)
        pv[: len(v)] = v * 0.5 + np.array([0.15 * p, 0.05 * p, 3.0 - 0.6 * p], np.float32)
        pf = np.zeros((600, 3), np.int64)
        pf[: len(f)] = f
        verts.append(pv)
        faces.append(pf)
    return verts, faces


def _sam_probs(n, num_persons, seed):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, num_persons, n)
    p = np.where(owner[:, None] == np.arange(num_persons)[None], 0.93, 0.06 / max(num_persons - 1, 1))
    p = p.astype(np.float32)
    p[::7] = 0.2 / num_persons  # not confident: excluded
    return p


@pytest.mark.parametrize("num_persons", [1, 3])
def test_pose_losses_match_jax(num_persons):
    """The three pose terms of P meshes with pinned samples and rays, value
    and d/d verts (tolerances of `test_torch_pose.py`). At P = 1 the
    interpenetration term has no partner: zero on both sides."""
    verts, faces = _spheres(num_persons)
    rng = np.random.default_rng(2)
    idx = [rng.integers(0, 162, 200) for _ in range(num_persons)]  # among the real vertices
    d = np.concatenate([rng.uniform(-0.3, 0.3, (90, 2)), np.ones((90, 1))], -1).astype(np.float32)
    o, d = np.zeros((90, 3), np.float32), d / np.linalg.norm(d, axis=-1, keepdims=True)
    sam = _sam_probs(90, num_persons, 4)
    jfaces, tfaces = [jnp.asarray(f) for f in faces], [_t(f) for f in faces]

    def jax_terms(*vs):
        vs = list(vs)
        i = jpl.interpenetration_loss(vs, jfaces, jax.random.PRNGKey(0), sample_idx=[jnp.asarray(x) for x in idx])
        dep, _ = jpl.sparse_depth_order_loss(jnp.asarray(o), jnp.asarray(d), vs, jfaces, jnp.asarray(sam),
                                             scale_to_full=1.7)
        sil = jpl.sparse_silhouette_loss(jnp.asarray(o), jnp.asarray(d), vs, jfaces, jnp.asarray(sam))
        return jnp.stack([i, dep, sil])

    jverts = [jnp.asarray(v) for v in verts]
    want, want_g = npify(jax.jit(lambda *vs: (jax_terms(*vs), jax.jacrev(jax_terms, argnums=tuple(range(num_persons)))(*vs)))(*jverts))
    tv = [_t(v).requires_grad_(True) for v in verts]
    got = torch.stack([
        pose_losses.interpenetration_loss(tv, tfaces, sample_idx=[_t(x) for x in idx]),
        pose_losses.sparse_depth_order_loss(_t(o), _t(d), tv, tfaces, _t(sam), scale_to_full=1.7)[0],
        pose_losses.sparse_silhouette_loss(_t(o), _t(d), tv, tfaces, _t(sam)),
    ])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-7)
    assert want[2] > 0
    if num_persons == 1:
        assert want[0] == 0 and want[1] == 0 and float(got[0].detach()) == 0
    else:
        assert (want > 0).all(), want
    for term in range(3):
        if want[term] == 0:
            continue
        g = torch.autograd.grad(got[term], tv, retain_graph=True)
        for a, b in zip(g, want_g):
            b = b[term]
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-5 * float(np.abs(b).max() + 1), err_msg=term)


def test_pose_only_step_matches_jax_at_three_persons(direct_knn):
    """A MODE_POSE_ONLY step at P = 3 with a pose batch, persons 1 and 2 moved
    into the person before them on the batch's frame: every log (the three
    pose terms non-zero), every gradient leaf, and the update (only `body.*`,
    through the pose optimizer)."""
    (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch) = program(3)
    scene = tiny_scene(3)
    transl = np.asarray(jts.params["body"].transl).copy()
    for p in (1, 2):
        transl[p, 1] = transl[p - 1, 1] + np.array([0.08, 0.0, -0.12], np.float32)
    jts = jts._replace(params={"net": jts.params["net"], "body": jts.params["body"]._replace(transl=jnp.asarray(transl))})
    ts = _with_epoch(ts, ts.epoch)
    with torch.no_grad():
        ts.body.transl.copy_(_t(transl))

    V, F = 512, 1024
    verts_c, faces = np.zeros((3, V, 3), np.float32), np.zeros((3, F, 3), np.int64)
    for p, s in enumerate(scene.servers):
        v, f = np.asarray(s.verts_c), np.asarray(s.model.faces)
        verts_c[p, : len(v)], faces[p, : len(f)] = v, f
    uv = np.asarray(jbatch.uv)
    probs = 1.0 / (1.0 + np.exp(-np.asarray(jbatch.sam_mask)))
    jpose = JaxPoseLossBatch(*(jnp.asarray(x) for x in (verts_c, faces.astype(np.int32), uv, probs, np.float32(1.5))))
    pose = PoseLossBatch(_t(verts_c), _t(faces), _t(uv), _t(probs.astype(np.float32)), 1.5)

    logs, grads, jlogs, before, new_ts, jnew = assert_step_matches(
        (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch), epoch=300,
        key=jax.random.PRNGKey(5), jpose=jpose, pose=pose, mode=MODE_POSE_ONLY)
    for k in ("pose_depth_order_loss", "pose_silhouette_loss", "pose_interpenetration_loss"):
        assert float(logs[k].detach()) > 0, k
    for k, p in new_ts.params().items():
        assert torch.equal(p, before[k]) != k.startswith("body."), k
    assert all(c == 1 for c in new_ts.opt_pose.count.values())
    assert all(c == 0 for c in new_ts.opt_joint.count.values())
