"""The port's pose-opt losses and the pose-only training step against the JAX
package on the CPU: values and gradients with respect to the vertices (f32,
tolerances stated per test), with meshes padded by degenerate 0,0,0 faces as
the trainer pads them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_step_matches, direct_knn, tiny_conf, tiny_program, tiny_scene  # noqa: F401
from multiply_tpu.engine import pose_losses as jpl
from multiply_tpu.engine.train import PoseLossBatch as JaxPoseLossBatch
from multiply_tpu.ops import mesh_ops as jmesh
from multiply_tpu_torch.engine import pose_losses
from multiply_tpu_torch.engine.train import MODE_POSE_ONLY, PoseLossBatch
from multiply_tpu_torch.ops import mesh_ops
from test_mesh_ops import icosphere


def _t(x):
    return torch.tensor(np.asarray(x))


def _padded_sphere(subdiv, scale, offset, n_verts, n_faces):
    """An icosphere padded to (n_verts, n_faces): zero vertices, 0,0,0 faces."""
    v, f = icosphere(subdiv)
    verts = np.zeros((n_verts, 3), np.float32)
    verts[: len(v)] = v * scale + np.asarray(offset, np.float32)
    faces = np.zeros((n_faces, 3), np.int64)
    faces[: len(f)] = f
    return verts, faces


def _rays(n, seed, spread=0.35):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    d = np.concatenate([rng.uniform(-spread, spread, (n, 2)), np.ones((n, 1))], -1).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("soft_tau", [0.0, 0.01])
def test_ray_mesh_intersect_soft_matches_jax(soft_tau):
    """t, hit, t_soft and d(sum t_soft + t)/d verts, with padding faces: no
    hit on them and no NaN in the backward (their determinant is 0). Small
    chunks so that the running minimum and the streaming logsumexp cross tiles."""
    verts, faces = _padded_sphere(2, 0.6, (0.1, 0.0, 2.5), 200, 400)
    o, d = _rays(70, 0)
    kw = dict(soft_tau=soft_tau, chunk_size=32, face_chunk=128)

    def jf(v):
        out = jmesh.ray_mesh_intersect(jnp.asarray(o), jnp.asarray(d), v, jnp.asarray(faces), **kw)
        return jnp.sum(jnp.where(out["hit"], out["t_soft"] + out["t"], 0.0)), out

    (_, want), want_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(verts))
    tv = _t(verts).requires_grad_(True)
    got = mesh_ops.ray_mesh_intersect(_t(o), _t(d), tv, _t(faces), **kw)
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(want["hit"]))
    assert 10 < int(got["hit"].sum()) < 70  # some rays hit, some miss
    for k in ("t", "t_soft"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    (g,) = torch.autograd.grad(torch.where(got["hit"], got["t_soft"] + got["t"], 0.0).sum(), tv)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-5)
    # under no_grad (no checkpointing) the values are the same
    with torch.no_grad():
        plain = mesh_ops.ray_mesh_intersect(_t(o), _t(d), tv, _t(faces), **kw)
    assert torch.equal(plain["t_soft"], got["t_soft"].detach())


def test_ray_mesh_intersect_default_chunks_split_rays_only():
    """`chunk_size=None` (256 rays on the CPU; on a GPU as many as
    `CUDA_TILE_ELEMS` allows) gives what one chunk of every ray and small
    chunks give, with and without the soft depth: values to 1e-6, gradients
    (summed over chunks in another grouping) to the JAX test's 1e-4 / 1e-5."""
    verts, faces = _padded_sphere(2, 0.6, (0.1, 0.0, 2.5), 200, 400)
    o, d = _rays(600, 1)
    for soft_tau in (0.0, 0.01):
        outs, grads = [], []
        for chunk in (None, 600, 48):
            tv = _t(verts).requires_grad_(True)
            out = mesh_ops.ray_mesh_intersect(_t(o), _t(d), tv, _t(faces), soft_tau=soft_tau, chunk_size=chunk)
            (g,) = torch.autograd.grad(torch.where(out["hit"], out["t_soft"] + out["t"], 0.0).sum(), tv)
            outs.append(out)
            grads.append(g)
        assert 100 < int(outs[0]["hit"].sum()) < 600
        for out, g in zip(outs[1:], grads[1:]):
            assert torch.equal(out["hit"], outs[0]["hit"])
            for k in ("t", "t_soft"):
                torch.testing.assert_close(out[k], outs[0][k], rtol=0.0, atol=1e-6)
            torch.testing.assert_close(g, grads[0], rtol=1e-4, atol=1e-5)


def test_winding_inside_matches_jax():
    verts, faces = _padded_sphere(2, 1.0, (0.0, 0.0, 0.0), 200, 400)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.3, 1.3, (300, 3)).astype(np.float32)
    want = np.asarray(jpl.winding_inside(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces),
                                         chunk_size=64, face_chunk=128))
    got = pose_losses.winding_inside(_t(pts), _t(verts).requires_grad_(True), _t(faces), chunk_size=64, face_chunk=128)
    assert got.dtype == torch.bool and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    inside = np.linalg.norm(pts, axis=-1) < 0.95
    assert got.numpy()[inside].all() and 0 < got.sum() < 300


def _two_meshes():
    # overlapping spheres along the view axis; person 1 in front
    a = _padded_sphere(3, 0.5, (0.0, 0.0, 3.0), 700, 1400)
    b = _padded_sphere(3, 0.5, (0.15, 0.05, 2.4), 700, 1400)
    return [a[0], b[0]], [a[1], b[1]]


def test_interpenetration_loss_matches_jax():
    """Value and d/d verts of both meshes with pinned sample indices: rtol 1e-4."""
    verts, faces = _two_meshes()
    rng = np.random.default_rng(2)
    idx = [rng.integers(0, 642, 300) for _ in range(2)]  # among the real vertices

    def jf(v0, v1):
        return jpl.interpenetration_loss([v0, v1], [jnp.asarray(f) for f in faces], jax.random.PRNGKey(0),
                                         sample_idx=[jnp.asarray(i) for i in idx])

    want, want_g = jax.value_and_grad(jf, argnums=(0, 1))(*(jnp.asarray(v) for v in verts))
    tv = [_t(v).requires_grad_(True) for v in verts]
    got = pose_losses.interpenetration_loss(tv, [_t(f) for f in faces], sample_idx=[_t(i) for i in idx])
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for g, wg in zip(torch.autograd.grad(got, tv), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4, atol=1e-6)
    # without pinned indices it draws them from the generator, at most num_samples
    drawn = pose_losses.draw_interpenetration_samples([700, 50], 64, torch.Generator().manual_seed(0), "cpu")
    assert [len(d) for d in drawn] == [64, 50] and int(drawn[1].max()) < 50
    again = pose_losses.interpenetration_loss(tv, [_t(f) for f in faces], torch.Generator().manual_seed(0), 64)
    assert torch.isfinite(again)


def _sam_probs(n, seed):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, 2, n)
    p = np.where(owner[:, None] == np.arange(2)[None], 0.93, 0.03).astype(np.float32)
    p[::7] = 0.2  # not confident: excluded
    return p


@pytest.mark.parametrize("which", ["depth_order", "silhouette"])
def test_sparse_pixel_losses_match_jax(which):
    """Value and d/d verts: rtol 1e-4 (f32, streaming logsumexp over tiles)."""
    verts, faces = _two_meshes()
    o, d = _rays(90, 3, spread=0.25)
    sam = _sam_probs(90, 4)
    jfaces = [jnp.asarray(f) for f in faces]

    def jf(v0, v1):
        if which == "depth_order":
            return jpl.sparse_depth_order_loss(jnp.asarray(o), jnp.asarray(d), [v0, v1], jfaces, jnp.asarray(sam),
                                               scale_to_full=1.7)
        return jpl.sparse_silhouette_loss(jnp.asarray(o), jnp.asarray(d), [v0, v1], jfaces, jnp.asarray(sam)), None

    (want, want_frac), want_g = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(*(jnp.asarray(v) for v in verts))
    tv = [_t(v).requires_grad_(True) for v in verts]
    tf = [_t(f) for f in faces]
    if which == "depth_order":
        got, frac = pose_losses.sparse_depth_order_loss(_t(o), _t(d), tv, tf, _t(sam), scale_to_full=1.7)
        np.testing.assert_allclose(float(frac), float(want_frac), atol=1e-6)
        assert 0 < float(frac) < 1
    else:
        got = pose_losses.sparse_silhouette_loss(_t(o), _t(d), tv, tf, _t(sam))
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    grads = torch.autograd.grad(got, tv)
    assert any(float(g.abs().max()) > 0 for g in grads)
    for g, wg in zip(grads, want_g):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-3, atol=1e-5 * float(np.abs(np.asarray(wg)).max() + 1))


def test_person_colors_and_schedule_match_jax():
    np.testing.assert_array_equal(np.asarray(pose_losses.PERSON_COLORS, np.float32), np.asarray(jpl.PERSON_COLORS))
    for e in (0, 300, 1000, 2000):
        assert pose_losses.depth_loss_schedule(0.1, e, 1000) == pytest.approx(float(jpl.depth_loss_schedule(0.1, e, 1000)))


def test_pose_only_step_matches_jax(direct_knn):
    """A MODE_POSE_ONLY step with a pose batch: every log (the three pose_*
    among them), every gradient leaf, and the update: only `body.*` moves,
    through the pose optimizer, and no `net.*` leaf does."""
    loss_kw = dict(depth_order_weight=0.1, silhouette_weight=0.05, interpenetration_weight=0.005)
    jax_side, port_side = tiny_program(tiny_conf(), loss_kw)
    (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch) = jax_side, port_side
    scene = tiny_scene()

    # person 1 steps in front of and into person 0 on the batch's frame
    transl = np.asarray(jts.params["body"].transl).copy()
    transl[1, 1] = transl[0, 1] + np.array([0.08, 0.0, -0.12], np.float32)
    jts = jts._replace(params={"net": jts.params["net"], "body": jts.params["body"]._replace(transl=jnp.asarray(transl))})
    with torch.no_grad():
        ts.body.transl.copy_(_t(transl))

    # the canonical body meshes, padded as the trainer pads them
    V, F = 512, 1024
    verts_c, faces = np.zeros((2, V, 3), np.float32), np.zeros((2, F, 3), np.int64)
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
    assert all(int(c) == 1 for c in jax.tree.leaves(jnew.opt_pose.count))
