"""The modules behind the port's other model configurations against the JAX
package on the CPU, from converted weights and the same inputs (f32,
tolerance stated per test): the offset head, the beta encoder, the implicit
net under `smpl_id` / `smpl_tri` conditioning with the layer-0 hook, the
rendering net's other modes, the sampler's ray range, and the weight paths of
every variant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import npify, tiny_conf
from multiply_tpu.config import Config as JaxConfig
from multiply_tpu.models import networks as jnet
from multiply_tpu.models import ray_sampler as jrs
from multiply_tpu.models.renderer import MultiplyRenderer as JaxRenderer
from multiply_tpu_torch import convert
from multiply_tpu_torch.config import Config
from multiply_tpu_torch.models import networks, ray_sampler
from multiply_tpu_torch.models.renderer import MultiplyRenderer

P, N = 2, 30


def _t(x):
    return torch.tensor(np.asarray(x))


def _load(module, flax_params, name):
    named = {f"net.{name}.{k}": p for k, p in module.named_parameters()}
    assert {convert.flax_path(n)[0][2:] for n in named} == convert.flax_leaf_paths(npify(flax_params))
    convert.load_params(named, {"net": {name: npify(flax_params)}})


def _stacked_init(module, *args, seed=0, jitter=0.05, **kwargs):
    """P independent flax inits, jittered so that no weight stays at a silent start."""
    params = jax.jit(jax.vmap(lambda k: module.init(k, *args, **kwargs)))(jax.random.split(jax.random.PRNGKey(seed), P))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + jitter * rng.standard_normal(a.shape).astype(np.float32)), params)


def test_offset_head_and_beta_encoder_match_flax():
    rng = np.random.default_rng(0)
    shared = rng.standard_normal((P, N, 1 + 16)).astype(np.float32)
    cond = rng.standard_normal((P, 133)).astype(np.float32)
    inp = rng.standard_normal((P, N, 27)).astype(np.float32)
    betas = rng.standard_normal((P, 10)).astype(np.float32)
    for no_feat in (False, True):
        jm = jnet.OffsetHead(feature_vector_size=16, width=24, no_head_feature=no_feat)
        params = _stacked_init(jm, shared[0], cond[0], inp[0])
        want = jax.vmap(jm.apply)(params, jnp.asarray(shared), jnp.asarray(cond), jnp.asarray(inp))
        head = networks.OffsetHead(17 + 133 + 27, 16, width=24, no_head_feature=no_feat, stack=P, device="cpu")
        _load(head, params, "offset_head")
        got = head(_t(shared), _t(cond), _t(inp))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    jb = jnet.BetaEncoder(width=24)
    bparams = _stacked_init(jb, betas[0], 2)
    want = jax.vmap(lambda p, b: jb.apply(p, b, N))(bparams, jnp.asarray(betas))
    enc = networks.BetaEncoder(24, stack=P, device="cpu")
    _load(enc, bparams, "beta_encoder")
    got = enc(_t(betas))
    assert got.shape == (P, 1, 24)
    np.testing.assert_allclose(got.expand(P, N, 24).detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    # both start near zero, so the shared field dominates at the start
    fresh = networks.OffsetHead(17 + 133 + 27, 16, stack=P, device="cpu", generator=torch.Generator().manual_seed(0))
    out = fresh(_t(shared), _t(cond), _t(inp))
    assert float((out[..., 0] - _t(shared)[..., 0]).detach().abs().max()) < 1e-3


@pytest.mark.parametrize("cond,shared_net", [("smpl_id", True), ("smpl_tri", False)])
def test_implicit_net_conditioning_variants_match_flax(cond, shared_net):
    """`smpl_id`: one unstacked net, a per-person (pose + latent) vector and the
    layer-0 hook. `smpl_tri`: a per-point conditioning (pose + tri-plane feature)."""
    rng = np.random.default_rng(1)
    conf = dict(tiny_conf()["implicit_network"], cond=cond)
    jm = jnet.ImplicitNet.from_config(JaxConfig(conf))
    x = (rng.standard_normal((P, N, 3)) * 0.5).astype(np.float32)
    cvec = rng.standard_normal((P, 133) if shared_net else (P, N, 133)).astype(np.float32)
    extra = rng.standard_normal((P, 1, 32)).astype(np.float32) * 0.1
    init = lambda k: jm.init(k, jnp.zeros((2, 3)), jnp.zeros((133,)))  # noqa: E731
    if shared_net:
        params = jax.jit(init)(jax.random.PRNGKey(0))
        params = jax.tree.map(lambda a: a + 0.05 * np.random.default_rng(2).standard_normal(a.shape).astype(np.float32), params)
        want = jax.vmap(lambda xx, cc, ee: jm.apply(params, xx, cc, layer0_extra=jnp.broadcast_to(ee, (N, 32))))(
            jnp.asarray(x), jnp.asarray(cvec), jnp.asarray(extra))
    else:
        params = _stacked_init(jm, jnp.zeros((2, 3)), jnp.zeros((133,)))
        want = jax.vmap(jm.apply)(params, jnp.asarray(x), jnp.asarray(cvec))
    net = networks.ImplicitNet.from_config(Config(conf), stack=None if shared_net else P, device="cpu")
    _load(net, params, "fg_implicit")
    assert net.lins[0].weight.dim() == (2 if shared_net else 3)
    got = net(_t(x), _t(cvec), layer0_extra=_t(extra) if shared_net else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["idr", "nerf", "pose_id_no_view"])
def test_rendering_net_other_modes_match_flax(mode):
    rng = np.random.default_rng(3)
    conf = {"mode": mode, "d_in": 9, "d_out": 3, "dims": [32, 32], "feature_vector_size": 16,
            "weight_norm": True, "multires_view": 4 if mode == "idr" else -1}
    jm = jnet.RenderingNet.from_config(JaxConfig(conf))
    pts, nrm, view = (rng.standard_normal((P, N, 3)).astype(np.float32) for _ in range(3))
    pose = rng.standard_normal((P, 69)).astype(np.float32)
    latent = rng.standard_normal((P, 64)).astype(np.float32)
    feat = rng.standard_normal((P, N, 16)).astype(np.float32)
    params = _stacked_init(jm, pts[0], nrm[0], view[0], pose[0], feat[0], id_latent=latent[0], jitter=0.0)
    want = jax.vmap(lambda p, *a: jm.apply(p, *a[:5], id_latent=a[5]))(
        params, *(jnp.asarray(a) for a in (pts, nrm, view, pose, feat, latent)))
    net = networks.RenderingNet.from_config(Config(conf), stack=P, device="cpu")
    _load(net, params, "fg_render")
    got = net(_t(pts), _t(nrm), _t(view), _t(pose), _t(feat), id_latent=_t(latent))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(NotImplementedError):
        networks.RenderingNet(mode="no such mode", device="cpu")


def test_error_bound_sampler_ray_range_matches_jax():
    """Per-ray [near, far] clipping: the far end is capped by the sphere exit
    and kept 1e-4 past the near end. Tolerances as for the unclipped sampler:
    inverse-CDF sampling multiplies a cumulative-sum rounding difference by
    bin width / bin mass, so most depths agree to 1e-5 and all to 2e-3."""
    rng = np.random.default_rng(4)
    R = 40
    cfg_d = tiny_conf()["ray_sampler"]
    ray_o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (R, 1))
    ray_d = rng.standard_normal((R, 3)).astype(np.float32) * 0.15 + np.array([0, 0, 1], np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    near = rng.uniform(1.5, 2.0, R).astype(np.float32)
    far = (near + rng.uniform(0.5, 1.5, R)).astype(np.float32)
    far[:3] = 50.0  # past the sphere: capped
    far[3:6] = near[3:6] - 0.2  # before the near end: lifted to near + 1e-4
    sdf_j = lambda p: jnp.sqrt((p * p).sum(-1)) - 0.5  # noqa: E731
    want = jrs.error_bound_sample(jrs.SamplerConfig.from_config(JaxConfig(cfg_d)), sdf_j, jnp.asarray(ray_o),
                                  jnp.asarray(ray_d), jnp.asarray(0.05), ray_range=(jnp.asarray(near), jnp.asarray(far)))
    got = ray_sampler.error_bound_sample(
        ray_sampler.SamplerConfig.from_config(Config(cfg_d)), lambda p: (p * p).sum(-1).sqrt() - 0.5, _t(ray_o),
        _t(ray_d), 0.05, 1, ray_range=(_t(near)[None], _t(far)[None]))
    z, wz = got["z_vals"][0].numpy(), np.asarray(want["z_vals"])
    err = np.abs(z - wz)
    assert (err <= 1e-5).mean() > 0.95 and err.max() <= 2e-3, (err.max(), (err > 1e-5).mean())
    assert (z[:, 0] >= near - 1e-6).all() and (z[6:, -1] <= far[6:] + 1e-5).all() and (z[:3, -1] < 10).all()


WEIGHT_VARIANTS = {
    "shared": tiny_conf(use_person_encoder=True, implicit_network__cond="smpl_id", implicit_network__offset_head=True,
                        implicit_network__beta_encoding=True, rendering_network__mode="pose_id_no_view"),
    "shared_smpl": tiny_conf(use_person_encoder=True),  # cond stays 'smpl': the latent widens it all the same
    "smpl_tri": tiny_conf(implicit_network__cond="smpl_tri", implicit_network__triplane_resolution=8),
    "multi_triplane_head": tiny_conf(implicit_network__cond="smpl_tri", implicit_network__multi_triplane=True,
                                     implicit_network__triplane_res=[8, 4], implicit_network__offset_head=True,
                                     implicit_network__no_head_feature=True),
    "shadow": tiny_conf(bg_rendering_network__d_out=4),
}


@pytest.mark.parametrize("variant", list(WEIGHT_VARIANTS))
def test_weights_of_every_variant_carry_across(variant):
    """A JAX parameter pytree of each variant loads into the port with no leaf
    left over or missing on either side, and every shape agrees."""
    conf = WEIGHT_VARIANTS[variant]
    jr = JaxRenderer(JaxConfig(conf), num_persons=P, num_frames=2)
    tree = npify(jax.jit(jr.init_params)(jax.random.PRNGKey(0)))
    renderer = MultiplyRenderer(Config(conf), P, 2, device="cpu")
    named = {f"net.{k}": p for k, p in renderer.named_parameters()}
    body = {"x": np.zeros(1, np.float32)}
    named["body.x"] = torch.nn.Parameter(torch.ones(1))
    convert.load_params(named, {"net": tree, "body": body})
    for name, p in named.items():
        np.testing.assert_array_equal(convert.to_flax_layout(name, p), convert.flax_leaf({"net": tree, "body": body}, name))
    # a leaf too many on either side is refused
    extra = dict(tree, stray=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="left over"):
        convert.load_params(named, {"net": extra, "body": body})
    fewer = {k: v for k, v in tree.items() if k != "beta"}
    with pytest.raises(ValueError, match="missing"):
        convert.load_params(named, {"net": fewer, "body": body})
    if "shared" in variant:
        assert tree["fg_implicit"]["params"]["lin0"]["kernel"].ndim == 2
        assert renderer.fg_render.lins[0].weight.shape[0] == P


def test_total_loss_new_terms_match_jax():
    """The SMPL-surface, zero-pose and depth-order terms with their schedules,
    and the `depth_order` ranking itself: f32 rounding (rtol 1e-6)."""
    from multiply_tpu.models import loss as jloss
    from multiply_tpu_torch.models import loss

    rng = np.random.default_rng(7)
    R = 48
    out = {
        "rgb_values": rng.random((R, 3)).astype(np.float32),
        "grad_theta": rng.standard_normal((60, 3)).astype(np.float32),
        "acc_map": rng.random(R).astype(np.float32),
        "acc_person_list": rng.random((R, P)).astype(np.float32),
        "index_in_surface": rng.random(R) > 0.5,
        "smpl_surface_loss": np.float32(0.4),
        "zero_pose_loss": np.float32(0.7),
    }
    gt = rng.random((R, 3)).astype(np.float32)
    kw = dict(sam_start_epoch=20, smpl_surface_weight=0.5, zero_pose_weight=0.3, smpl_surface_milestone=80,
              zero_pose_milestone=100, depth_loss_milestone=60)
    for epoch in (0, 30, 90, 500):
        got, logs = loss.total_loss(loss.LossConfig(**kw), {k: _t(v) for k, v in out.items()}, _t(gt), epoch,
                                    depth_order_loss=_t(np.float32(1.3)))
        want, jlogs = jloss.total_loss(jloss.LossConfig(**kw), out, gt, epoch, depth_order_loss=np.float32(1.3))
        assert set(logs) == set(jlogs)
        for k in logs:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-6, atol=1e-8, err_msg=f"{k}@{epoch}")
    t_front, t_owner = rng.random(R).astype(np.float32) * 3, rng.random(R).astype(np.float32) * 3
    valid = rng.random(R) > 0.3
    np.testing.assert_allclose(float(loss.depth_order(_t(t_front), _t(t_owner), _t(valid))),
                               float(jloss.depth_order(t_front, t_owner, valid)), rtol=1e-6)
