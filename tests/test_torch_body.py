"""The port's body model, server, parameter tables, skinning and deformer
against the JAX package, on the CPU with the same seeded numpy inputs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import direct_knn, npify  # noqa: F401
from multiply_tpu.body import smpl as jsmpl
from multiply_tpu.body.params import BodyParamTable as JaxTable
from multiply_tpu.body.server import SMPLServer as JaxServer
from multiply_tpu.body.server import canonical_pose_params as jax_cano
from multiply_tpu.body.server import smpl_server_forward as jax_forward
from multiply_tpu.models.deformer import SMPLDeformer as JaxDeformer
from multiply_tpu_torch import convert
from multiply_tpu_torch.body import smpl
from multiply_tpu_torch.body.params import BodyParamTable
from multiply_tpu_torch.body.server import (
    SMPLServer,
    canonical_pose_params,
    smpl_server_forward,
    stack_servers,
)
from multiply_tpu_torch.models.deformer import SMPLDeformer
from multiply_tpu_torch.ops import skinning as sk

jsk = importlib.import_module("multiply_tpu.ops.skinning")

# f32 LBS through a 24-joint chain of 4x4 products: rounding grows with depth
ATOL = 2e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _pose(rng, n=1):
    return (rng.standard_normal((n, 72)) * 0.3).astype(np.float32)


def test_synthetic_body_model_is_the_same_body():
    jm, tm = jsmpl.synthetic_body_model(), smpl.synthetic_body_model(device="cpu")
    for f in jsmpl.BodyModel._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    assert tm.faces.dtype == torch.int64


def test_rodrigues_and_lbs_match_jax():
    rng = np.random.default_rng(0)
    pose, betas = _pose(rng, 3), rng.standard_normal((3, 10)).astype(np.float32)
    np.testing.assert_allclose(
        smpl.rodrigues(_t(pose.reshape(-1, 3))).numpy(),
        np.asarray(jsmpl.rodrigues(jnp.asarray(pose.reshape(-1, 3)))), atol=1e-6,
    )
    jm, tm = jsmpl.synthetic_body_model(), smpl.synthetic_body_model(device="cpu")
    got = smpl.lbs(tm, _t(betas), _t(pose))  # batched over 3 bodies
    for i in range(3):
        want = npify(jsmpl.lbs(jm, jnp.asarray(betas[i]), jnp.asarray(pose[i])))
        for k in ("verts", "joints", "all_joints", "A", "T", "v_posed"):
            np.testing.assert_allclose(got[k][i].numpy(), want[k], atol=ATOL, err_msg=k)


def test_server_forward_stacked_persons_match_jax():
    rng = np.random.default_rng(1)
    jm, tm = jsmpl.synthetic_body_model(), smpl.synthetic_body_model(device="cpu")
    betas = rng.standard_normal((2, 10)).astype(np.float32) * 0.3
    np.testing.assert_allclose(canonical_pose_params(device="cpu").numpy(), np.asarray(jax_cano()))
    jservers = [JaxServer.create(jm, betas=betas[p]) for p in range(2)]
    server = stack_servers([SMPLServer.create(tm, betas=betas[p]) for p in range(2)])
    scale = np.array([1.0, 0.9], np.float32)
    transl = rng.standard_normal((2, 3)).astype(np.float32) * 0.2
    thetas = _pose(rng, 2)
    got = smpl_server_forward(server, _t(scale), _t(transl), _t(thetas), _t(betas))
    for p in range(2):
        np.testing.assert_allclose(server.tfs_c_inv[p].numpy(), np.asarray(jservers[p].tfs_c_inv), atol=1e-5)
        want = npify(jax_forward(jservers[p], jnp.asarray(scale[p]), jnp.asarray(transl[p]),
                                 jnp.asarray(thetas[p]), jnp.asarray(betas[p])))
        for k in want:
            np.testing.assert_allclose(got[k][p].numpy(), want[k], atol=ATOL, err_msg=k)
    # and the server carried across from the JAX package gives the same answer
    stacked = npify(jax.tree.map(lambda *x: jnp.stack(x), *jservers))
    conv = smpl_server_forward(convert.server_from_jax(stacked, "cpu"), _t(scale), _t(transl), _t(thetas))
    np.testing.assert_allclose(conv["smpl_verts"].numpy(), got["smpl_verts"].numpy(), atol=ATOL)


def test_body_param_table_matches_jax():
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((10,), (5, 3), (5, 3), (5, 69))]
    jt = JaxTable.create(5, *arrs)
    tables = [BodyParamTable.create(5, *arrs, device="cpu"), BodyParamTable.create(5, device="cpu")]
    stacked = BodyParamTable.stack(tables)
    np.testing.assert_array_equal(stacked.thetas(3)[0].detach().numpy(), np.asarray(jt.thetas(3)))
    np.testing.assert_array_equal(tables[0].transl[2].detach().numpy(), np.asarray(jt.transl[2]))
    assert not stacked.body_pose[1].any() and stacked.betas.shape == (2, 1, 10)


def test_skinning_rows_match_jax():
    rng = np.random.default_rng(3)
    w = rng.random((50, 24)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    tfs[:, :3, :] += rng.standard_normal((24, 3, 4)).astype(np.float32) * 0.1
    x = rng.standard_normal((50, 3)).astype(np.float32)
    g = rng.standard_normal((50, 3)).astype(np.float32)
    m_t, m_j = sk.blend_affine_rows(_t(w), _t(tfs)), jsk.blend_affine_rows(jnp.asarray(w), jnp.asarray(tfs))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)
    for name in ("affine_apply_rows", "affine_inverse_apply_rows"):
        np.testing.assert_allclose(
            getattr(sk, name)(m_t, _t(x)).numpy(),
            np.asarray(getattr(jsk, name)(m_j, jnp.asarray(x))), atol=1e-5, err_msg=name,
        )
    r9 = sk.rotation_inverse_rows(m_t)
    np.testing.assert_allclose(r9.numpy(), np.asarray(jsk.rotation_inverse_rows(m_j)), atol=1e-5)
    np.testing.assert_allclose(
        sk.covector_apply_rows(r9, _t(g)).numpy(),
        np.asarray(jsk.covector_apply_rows(jsk.rotation_inverse_rows(m_j), jnp.asarray(g))), atol=1e-5,
    )
    # round trip: inverse after forward is the identity
    back = sk.affine_inverse_apply_rows(m_t, sk.affine_apply_rows(m_t, _t(x)))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_deformer_matches_jax(direct_knn, k):
    rng = np.random.default_rng(4)
    jm, tm = jsmpl.synthetic_body_model(), smpl.synthetic_body_model(device="cpu")
    jserver, server = JaxServer.create(jm), SMPLServer.create(tm)
    thetas = _pose(rng)[0]
    jout = jax_forward(jserver, jnp.ones(()), jnp.zeros(3), jnp.asarray(thetas))
    tout = smpl_server_forward(server, torch.ones(()), torch.zeros(3), _t(thetas))
    x_d = (rng.standard_normal((400, 3)) * 0.4).astype(np.float32)
    jd, td = JaxDeformer.create(jserver), SMPLDeformer.create(server)

    xc_j, out_j = jd.inverse(jnp.asarray(x_d), jout["smpl_tfs"], jout["smpl_verts"], k=k)
    xc_t, out_t = td.inverse(_t(x_d), tout["smpl_tfs"], tout["smpl_verts"], k=k)
    np.testing.assert_allclose(xc_t.numpy(), np.asarray(xc_j), atol=ATOL)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))

    xd_j, m_j = jd.forward_jacobian_rows(xc_j, jout["smpl_tfs"], k=k)
    xd_t, m_t = td.forward_jacobian_rows(xc_t, tout["smpl_tfs"], k=k)
    np.testing.assert_allclose(xd_t.numpy(), np.asarray(xd_j), atol=ATOL)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=ATOL)
    np.testing.assert_allclose(td.forward(xc_t, tout["smpl_tfs"], k=k).numpy(), xd_t.numpy(), atol=1e-6)


def test_skinning_weights_are_detached():
    tm = smpl.synthetic_body_model(device="cpu")
    server = SMPLServer.create(tm)
    pts = (torch.randn(30, 3, generator=torch.Generator().manual_seed(0)) * 0.3).requires_grad_(True)
    w, outlier = sk.query_skinning_weights(pts, server.verts_c, server.weights_c.requires_grad_(True))
    assert not w.requires_grad and not outlier.requires_grad
    np.testing.assert_allclose(w.sum(-1).detach().numpy(), 1.0, atol=1e-5)


def test_single_neighbour_shortcut_equals_general_formula():
    """At k = 1 the weights are the nearest vertex's row and the clamp is
    skipped: bit for bit what the confidence-weighted formula of k > 1 gives
    for one neighbour, far points (d2 > the clamp) included."""
    from multiply_tpu_torch.ops.knn_cuda import nn1

    rng = np.random.default_rng(5)
    server = stack_servers([SMPLServer.create(smpl.synthetic_body_model(device="cpu")) for _ in range(2)])
    pts = _t((rng.standard_normal((2, 600, 3)) * 0.6).astype(np.float32))
    pts[:, :20] *= 8.0  # beyond DIST_CLAMP
    got_w, got_out = sk.query_skinning_weights(pts, server.verts_c, server.weights_c, k=1)

    d2, idx = nn1(pts, server.verts_c)
    d2 = d2.clamp_max(sk.DIST_CLAMP)
    conf = torch.exp(-d2)
    conf = conf / conf.sum(-1, keepdim=True)
    want_w = (sk._take_rows(server.weights_c, idx) * conf[..., None]).sum(-2)
    want_out = torch.sqrt(d2[..., 0]) > sk.OUTLIER_DIST
    assert (d2 == sk.DIST_CLAMP).any() and want_out.any() and not want_out.all()
    assert torch.equal(got_w, want_w) and torch.equal(got_out, want_out)
    assert got_w.shape == (2, 600, 24) and got_w.is_contiguous() == want_w.is_contiguous()
