"""The port's mesh geometry, SDF-grid bake, cameras and synthetic scene
against the JAX package, on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (thread count)
from multiply_tpu.body import smpl as jsmpl
from multiply_tpu.data.synthetic import make_scene as jax_make_scene
from multiply_tpu.data.synthetic import sample_rays as jax_sample_rays
from multiply_tpu.ops import mesh_ops as jmesh
from multiply_tpu.utils import cameras as jcam
from multiply_tpu_torch.data.synthetic import make_scene, sample_rays
from multiply_tpu_torch.ops import mesh_ops
from multiply_tpu_torch.utils import cameras


def _t(x):
    return torch.tensor(np.asarray(x))


def _mesh():
    jm = jsmpl.synthetic_body_model()
    return np.asarray(jm.v_template), np.asarray(jm.faces)


def test_signed_distance_and_grid_bake_match_jax():
    verts, faces = _mesh()
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((300, 3)) * 0.5).astype(np.float32)
    got = mesh_ops.signed_distance(_t(pts), _t(verts), _t(faces).long(), chunk_size=128, face_chunk=256)
    want = jmesh.signed_distance(jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces), chunk_size=128)
    # exact point-triangle distance in f32; the winding-number sign agrees
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    g_t = mesh_ops.sdf_grid(_t(verts), _t(faces).long(), res=10)
    g_j = jmesh.sdf_grid(jnp.asarray(verts), jnp.asarray(faces), res=10)
    for k in ("grid", "origin", "spacing"):
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]), atol=1e-5, err_msg=k)
    q = (rng.standard_normal((200, 3)) * 0.8).astype(np.float32)
    np.testing.assert_allclose(
        mesh_ops.grid_query(g_t, _t(q)).numpy(), np.asarray(jmesh.grid_query(g_j, jnp.asarray(q))), atol=1e-5
    )


def test_ray_mesh_and_ray_box_match_jax():
    verts, faces = _mesh()
    rng = np.random.default_rng(1)
    o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (257, 1))
    d = rng.standard_normal((257, 3)).astype(np.float32) * 0.25 + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = mesh_ops.ray_mesh_intersect(_t(o), _t(d), _t(verts), _t(faces).long(), chunk_size=64, face_chunk=300)
    want = jmesh.ray_mesh_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), jnp.asarray(faces))
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(want["hit"]))
    assert got["hit"].any() and not got["hit"].all()
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]), rtol=1e-5)

    lo, hi = np.array([-0.3, -1.0, -0.3], np.float32), np.array([0.3, 0.7, 0.3], np.float32)
    got = mesh_ops.ray_aabb_range(_t(o), _t(d), _t(lo), _t(hi))
    want = jmesh.ray_aabb_range(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_cameras_match_jax():
    rng = np.random.default_rng(2)
    uv = (rng.random((64, 2)) * 40).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, -2.5]
    intr = np.array([[36.0, 0.5, 20.37], [0, 36.0, 16.23], [0, 0, 1]], np.float32)
    d_t, loc_t = cameras.get_camera_params(_t(uv), _t(pose), _t(intr))
    d_j, loc_j = jcam.get_camera_params(jnp.asarray(uv), jnp.asarray(pose), jnp.asarray(intr))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_j))
    o = loc_t.expand_as(d_t)
    np.testing.assert_allclose(
        cameras.get_sphere_intersections(o, d_t, r=3.0).numpy(),
        np.asarray(jcam.get_sphere_intersections(jnp.asarray(o.numpy()), d_j, r=3.0)), atol=1e-5,
    )
    np.testing.assert_array_equal(cameras.pixel_grid(5, 3), jcam.pixel_grid(5, 3))


def test_make_scene_and_sample_rays_match_jax():
    got = make_scene(num_frames=2, num_persons=2, height=24, width=32, device="cpu")
    want = jax_make_scene(num_frames=2, num_persons=2, height=24, width=32, cache_dir=None)
    for k in ("poses", "transl", "betas", "scale", "cam_pose", "intrinsics"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    # the same ray-mesh hits up to f32 rounding on a silhouette edge
    assert (got.masks == want.masks).mean() > 0.998
    assert np.abs(got.images - want.images).max(-1).astype(bool).mean() < 0.002
    assert got.intrinsics[0, 2] % 1 != 0  # sub-pixel principal point
    r_t = sample_rays(got, 1, 50, np.random.default_rng(3))
    r_j = jax_sample_rays(want, 1, 50, np.random.default_rng(3))
    np.testing.assert_array_equal(r_t["uv"], r_j["uv"])
    np.testing.assert_array_equal(r_t["sam"], r_j["sam"])
