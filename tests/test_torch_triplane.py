"""The port's grid sampling and tri-planes against the JAX package on the
CPU: values, first and second derivatives (f32, 1e-5), the modules with
carried weights, and whole training steps under `cond: smpl_tri`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_step_matches, direct_knn, npify, tiny_conf, tiny_program  # noqa: F401
from multiply_tpu.models import triplane as jtri
from multiply_tpu.ops import grid_sample as jgs
from multiply_tpu_torch import convert
from multiply_tpu_torch.models import triplane
from multiply_tpu_torch.ops import grid_sample


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("dims", [2, 3])
def test_grid_sample_values_and_derivatives_match_jax(dims):
    """Values, d/d coords, d/d image and the second derivatives that the
    eikonal term's backward needs: d/d image and d/d coords of |d out/d coords|^2.
    Coordinates reach past [-1, 1] (border padding). f32 on both sides: 1e-5."""
    rng = np.random.default_rng(dims)
    shape = (4, 9, 13) if dims == 2 else (3, 5, 7, 6)
    img = rng.standard_normal(shape).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (60, dims)).astype(np.float32)
    w = rng.standard_normal((60, shape[0])).astype(np.float32)
    jf = jgs.grid_sample_2d if dims == 2 else jgs.grid_sample_3d
    tf = grid_sample.grid_sample_2d if dims == 2 else grid_sample.grid_sample_3d

    def j_first(im, c):
        return jax.grad(lambda cc: jnp.sum(jf(im, cc) * w))(c)

    def j_second(im, c):
        return jnp.sum(j_first(im, c) ** 2)

    want = jf(jnp.asarray(img), jnp.asarray(coords))
    want_g = j_first(jnp.asarray(img), jnp.asarray(coords))
    want_gi = jax.grad(lambda im: jnp.sum(jf(im, jnp.asarray(coords)) * w))(jnp.asarray(img))
    want_h_img, want_h_c = jax.grad(j_second, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(coords))

    ti, tc = _t(img).requires_grad_(True), _t(coords).requires_grad_(True)
    out = tf(ti, tc)
    g, gi = torch.autograd.grad((out * _t(w)).sum(), (tc, ti), create_graph=True)
    h_img, h_c = torch.autograd.grad((g**2).sum(), (ti, tc))
    for name, got, ref in (("value", out, want), ("d coords", g, want_g), ("d image", gi, want_gi),
                           ("second, image", h_img, want_h_img), ("second, coords", h_c, want_h_c)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5, err_msg=name)
    assert float(h_img.abs().max()) > 0 and float(h_c.abs().max()) > 0

    # leading batch axes: each entry as if sampled alone
    batched = tf(torch.stack([ti, 2 * ti]), torch.stack([tc, -tc]))
    torch.testing.assert_close(batched[0], out)
    torch.testing.assert_close(batched[1], tf(2 * ti, -tc))


def _eikonal_like(sdf_of_pts, pts):
    """mean (|d sdf / d pts| - 1)^2: differentiates through the lookup twice."""
    (g,) = torch.autograd.grad(sdf_of_pts(pts).sum(), pts, create_graph=True)
    return ((g.norm(dim=-1) - 1.0) ** 2).mean()


def test_triplane_matches_flax_to_second_order():
    rng = np.random.default_rng(3)
    P, N = 2, 40
    pts = rng.uniform(-0.9, 0.9, (P, N, 3)).astype(np.float32)
    jm = jtri.TriPlane(features=8, resolution=16)
    params = jax.jit(jax.vmap(lambda k: jm.init(k, jnp.zeros((2, 3)))))(jax.random.split(jax.random.PRNGKey(0), P))
    want = jax.vmap(jm.apply)(params, jnp.asarray(pts))

    def j_eik(p):
        g = jax.grad(lambda x: jnp.sum(jax.vmap(jm.apply)(p, x)[..., 0]))(jnp.asarray(pts))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    want_eik, want_g = jax.jit(jax.value_and_grad(j_eik))(params)

    net = triplane.TriPlane(features=8, resolution=16, stack=P, device="cpu")
    named = {f"net.triplane.{k}": p for k, p in net.named_parameters()}
    convert.load_params(named, {"net": {"triplane": npify(params)}})
    tp = _t(pts).requires_grad_(True)
    np.testing.assert_allclose(net(tp).detach().numpy(), np.asarray(want), atol=1e-6)
    eik = _eikonal_like(lambda x: net(x)[..., 0], tp)
    (g_planes,) = torch.autograd.grad(eik, net.planes)
    np.testing.assert_allclose(float(eik.detach()), float(want_eik), rtol=1e-5)
    np.testing.assert_allclose(g_planes.numpy(), np.asarray(want_g["params"]["planes"]), atol=1e-6, rtol=1e-4)
    assert float(g_planes.abs().max()) > 0
    # the one-person form, as sample_triplane takes it
    one = triplane.sample_triplane(net.planes[1], tp[1])
    torch.testing.assert_close(one, net(tp)[1])


def test_triplane_multi_matches_flax():
    rng = np.random.default_rng(4)
    P, N = 2, 30
    pts = rng.uniform(-0.9, 0.9, (P, N, 3)).astype(np.float32)
    jm = jtri.TriPlaneMulti(features=8, resolutions=(8, 4), adapter_width=16)
    params = jax.jit(jax.vmap(lambda k: jm.init(k, jnp.zeros((2, 3)))))(jax.random.split(jax.random.PRNGKey(1), P))
    # the last layer starts at +-1e-5: scale it up so the outputs are not ~0
    params = jax.tree.map(lambda a: a, params)
    params["params"]["Dense_2"]["kernel"] = params["params"]["Dense_2"]["kernel"] * 1e4
    want_f, want_d = jax.jit(jax.vmap(jm.apply))(params, jnp.asarray(pts))
    want_g = jax.jit(jax.grad(lambda p: jnp.sum(jax.vmap(jm.apply)(p, jnp.asarray(pts))[1] ** 2)))(params)

    net = triplane.TriPlaneMulti(features=8, resolutions=(8, 4), adapter_width=16, stack=P, device="cpu")
    named = {f"net.triplane.{k}": p for k, p in net.named_parameters()}
    assert {convert.flax_path(n)[0][2:] for n in named} == {
        ("params",) + p for p in convert.flax_leaf_paths(npify(params)["params"])}
    convert.load_params(named, {"net": {"triplane": npify(params)}})
    feat, dsdf = net(_t(pts))
    assert feat.shape == (P, N, 8) and dsdf.shape == (P, N)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(want_f), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dsdf.detach().numpy(), np.asarray(want_d), atol=1e-6, rtol=1e-5)
    grads = torch.autograd.grad((dsdf**2).sum(), list(named.values()))
    for name, g in zip(named, grads):
        np.testing.assert_allclose(convert.to_flax_layout(name, g), convert.flax_leaf({"net": {"triplane": npify(want_g)}}, name),
                                   atol=1e-6, rtol=1e-4, err_msg=name)
    # a fresh module starts silent, so the geometric SDF init survives switching it on
    fresh = triplane.TriPlaneMulti(features=8, resolutions=(8, 4), stack=P, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    f0, d0 = fresh(_t(pts))
    assert float(f0.detach().abs().max()) < 1e-3 and float(d0.detach().abs().max()) < 1e-3


TRI_VARIANTS = {
    "smpl_tri": tiny_conf(implicit_network__cond="smpl_tri", implicit_network__triplane_resolution=8),
    "multi_triplane": tiny_conf(implicit_network__cond="smpl_tri", implicit_network__multi_triplane=True,
                                implicit_network__triplane_res=[8, 4]),
}


@pytest.mark.parametrize("variant", list(TRI_VARIANTS))
def test_triplane_train_step_matches_jax(direct_knn, variant):
    """The whole step under tri-plane conditioning: the eikonal term and the
    normals differentiate through the plane lookup twice."""
    jax_side, port_side = tiny_program(TRI_VARIANTS[variant])
    logs, grads, *_ = assert_step_matches(jax_side, port_side, epoch=30, key=jax.random.PRNGKey(3))
    new = [k for k in grads if "triplane" in k]
    assert new and all(float(grads[k].abs().max()) > 0 for k in new), new
