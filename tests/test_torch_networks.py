"""The port's networks, sampler, losses, optimizer and config against the
JAX package, on the CPU from converted weights and the same inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import npify
from multiply_tpu.config import load_config as jax_load_config
from multiply_tpu.engine import optim as joptim
from multiply_tpu.models import loss as jloss
from multiply_tpu.models import networks as jnet
from multiply_tpu.models import ray_sampler as jrs
from multiply_tpu.ops import density as jdens
from multiply_tpu.ops import embedders as jemb
from multiply_tpu_torch import convert
from multiply_tpu_torch.config import Config, load_config
from multiply_tpu_torch.engine import optim
from multiply_tpu_torch.models import loss, networks, ray_sampler
from multiply_tpu_torch.models.renderer import MultiplyRenderer
from multiply_tpu_torch.ops import density, embedders

FG = {"d_in": 3, "d_out": 1, "dims": [64, 64, 64, 64], "feature_vector_size": 16, "skip_in": [2],
      "multires": 6, "cond": "smpl", "init": "geometry", "bias": 0.6, "weight_norm": True}
BG = {"d_in": 4, "d_out": 1, "dims": [32, 32], "feature_vector_size": 16, "skip_in": [],
      "multires": 10, "cond": "frame", "init": "none", "bias": 0.0, "weight_norm": False}


def _t(x):
    return torch.tensor(np.asarray(x))


def _load(module, flax_params, name="fg_implicit"):
    named = {f"net.{name}.{k}": p for k, p in module.named_parameters()}
    convert.load_params(named, {"net": {name: npify(flax_params)}})


def test_leaf_ops_match_jax():
    x = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    for m in (-1, 4):
        np.testing.assert_allclose(embedders.positional_encoding(_t(x), m).numpy(),
                                   np.asarray(jemb.positional_encoding(jnp.asarray(x), m)), atol=1e-6)
        assert embedders.embedding_dim(m) == jemb.embedding_dim(m)
    beta = np.float32(0.07)
    np.testing.assert_allclose(density.laplace_density(_t(x), _t(beta)).numpy(),
                               np.asarray(jdens.laplace_density(jnp.asarray(x), beta)), rtol=1e-6)
    np.testing.assert_allclose(density.laplace_beta(_t(-x)).numpy(), np.asarray(jdens.laplace_beta(-x)))


@pytest.mark.parametrize("conf,stack", [(FG, 2), (BG, None)])
def test_implicit_net_matches_flax(conf, stack):
    rng = np.random.default_rng(1)
    cfg = Config(dict(conf))
    jm = jnet.ImplicitNet.from_config(cfg)
    n_in, c = conf["d_in"], networks.COND_DIMS[conf["cond"]]
    P = stack or 1
    x = rng.standard_normal((P, 50, n_in)).astype(np.float32) * 0.5
    cond = rng.standard_normal((P, c)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), P)
    params = jax.vmap(lambda k: jm.init(k, jnp.zeros((2, n_in)), jnp.zeros((c,))))(keys)
    # break the geometric init's zero columns so every weight is exercised
    params = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    want = jax.vmap(jm.apply)(params, jnp.asarray(x), jnp.asarray(cond))
    want_g = jax.vmap(jax.grad(lambda p, xx, cc: jm.apply(p, xx, cc)[:, 0].sum(), argnums=1))(
        params, jnp.asarray(x), jnp.asarray(cond))

    net = networks.ImplicitNet.from_config(cfg, stack=stack, device="cpu")
    _load(net, params if stack else jax.tree.map(lambda a: a[0], params))
    xt = _t(x if stack else x[0]).requires_grad_(True)
    out = net(xt, _t(cond if stack else cond[0]))
    (g,) = torch.autograd.grad(out[..., 0].sum(), xt)
    np.testing.assert_allclose(out.detach().numpy().reshape(want.shape), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(g.numpy().reshape(want_g.shape), np.asarray(want_g), atol=2e-4, rtol=1e-4)


def test_geometric_init_follows_the_reference_layout():
    """The SAL init as in the JAX package: layer 0 sees only raw xyz, the skip
    layer's PE columns start at zero, the last layer has mean sqrt(pi/in) and
    bias -0.6, and each weight-norm g starts at the row norm."""
    net = networks.ImplicitNet.from_config(Config(FG), stack=2, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    w0, w2, wl = (net.lins[i].weight.detach() for i in (0, 2, 4))
    assert w0[..., 3:].abs().max() == 0 and w0[..., :3].abs().min() > 0
    assert w2[..., -36:].abs().max() == 0  # the 39 - 3 PE columns of the skip input
    assert abs(wl.mean().item() - (np.pi / 64) ** 0.5) < 1e-4
    assert torch.all(net.lins[4].bias == -0.6)
    for lin in net.lins:
        torch.testing.assert_close(lin.g, lin.weight.norm(dim=-1))
    assert not torch.equal(net.lins[1].weight[0], net.lins[1].weight[1])  # persons drawn apart


@pytest.mark.parametrize("mode", ["pose_no_view", "nerf_frame_encoding"])
def test_rendering_net_matches_flax(mode):
    rng = np.random.default_rng(2)
    if mode == "pose_no_view":
        conf = {"mode": mode, "d_in": 14, "d_out": 3, "dims": [32, 32], "feature_vector_size": 16,
                "weight_norm": True, "multires_view": -1}
    else:
        conf = {"mode": mode, "d_in": 3, "d_out": 3, "dims": [24], "feature_vector_size": 16,
                "weight_norm": False, "multires_view": 4}
    jm = jnet.RenderingNet.from_config(Config(conf), dim_frame_encoding=8)
    n = 40
    pts, nrm, view = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(3))
    pose = rng.standard_normal((69,)).astype(np.float32)
    feat = rng.standard_normal((n, 16)).astype(np.float32)
    fl = rng.standard_normal((8,)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), pts, nrm, view, pose, feat, frame_latent=fl)
    want = jm.apply(params, pts, nrm, view, pose, feat, frame_latent=fl)
    net = networks.RenderingNet.from_config(Config(conf), dim_frame_encoding=8, device="cpu")
    _load(net, params, "fg_render")
    got = net(_t(pts), _t(nrm), _t(view), _t(pose), _t(feat), frame_latent=_t(fl))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)


SAMPLER = {"near": 0.0, "N_samples": 16, "N_samples_eval": 32, "N_samples_extra": 8, "eps": 0.1,
           "beta_iters": 5, "max_total_iters": 3, "N_samples_inverse_sphere": 8}


def _sphere_sdf(lib):
    return lambda p: (p * p).sum(-1) ** 0.5 - 0.5 if lib is jnp else (p * p).sum(-1).sqrt() - 0.5


@pytest.mark.parametrize("train", [False, True])
def test_error_bound_sampler_matches_jax(train):
    rng = np.random.default_rng(4)
    R = 48
    ray_o = np.tile(np.array([[0.0, 0.0, -2.5]], np.float32), (R, 1))
    ray_d = rng.standard_normal((R, 3)).astype(np.float32) * 0.15 + np.array([0, 0, 1], np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    cfg_j = jrs.SamplerConfig.from_config(Config(SAMPLER))
    cfg_t = ray_sampler.SamplerConfig.from_config(Config(SAMPLER))
    key = jax.random.PRNGKey(5) if train else None
    want = jrs.error_bound_sample(cfg_j, _sphere_sdf(jnp), jnp.asarray(ray_o), jnp.asarray(ray_d),
                                  jnp.asarray(0.05), key=key)
    noise = None
    if train:
        ks = jax.random.split(key, 4)
        noise = {"u": _t(jax.random.uniform(ks[0], (R, 16)))[None],
                 "perm": _t(np.asarray(jax.random.permutation(ks[1], 96)[:8]).astype(np.int64))[None]}
    got = ray_sampler.error_bound_sample(cfg_t, lambda p: _sphere_sdf(torch)(p), _t(ray_o), _t(ray_d),
                                         0.05, 1, noise=noise)
    # the same f32 algorithm, but the cumulative sums round in another order,
    # and inverse-CDF sampling multiplies a CDF error by bin width / bin mass
    # (up to ~1e4 in empty space): most depths agree to 1e-5, all to 2e-3
    err = np.abs(got["z_vals"][0].numpy() - np.asarray(want["z_vals"]))
    assert (err <= 1e-5).mean() > 0.95 and err.max() <= 2e-3, (err.max(), (err > 1e-5).mean())
    np.testing.assert_allclose(got["beta_final"][0].numpy(), np.asarray(want["beta_final"]), rtol=1e-5)


def test_sample_cdf_matches_jax_with_flat_stretches():
    rng = np.random.default_rng(6)
    pdf = rng.random((5, 20)).astype(np.float32)
    pdf[:, 5:9] = 0.0  # flat stretch: the bracket must skip zero-width bins
    cdf = np.concatenate([np.zeros((5, 1)), np.cumsum(pdf / pdf.sum(-1, keepdims=True), -1)], -1).astype(np.float32)
    bins = np.sort(rng.random((5, 21)).astype(np.float32), -1)
    u = np.concatenate([rng.random((5, 30)), np.ones((5, 1)), np.zeros((5, 1))], -1).astype(np.float32)
    np.testing.assert_allclose(ray_sampler._sample_cdf(_t(bins), _t(cdf), _t(u)).numpy(),
                               np.asarray(jrs._sample_cdf(jnp.asarray(bins), jnp.asarray(cdf), jnp.asarray(u))),
                               atol=1e-6)


def test_total_loss_matches_jax():
    rng = np.random.default_rng(7)
    R, P = 64, 2
    out = {
        "rgb_values": rng.random((R, 3)).astype(np.float32),
        "grad_theta": rng.standard_normal((100, 3)).astype(np.float32),
        "acc_map": (rng.random(R) * 1.1).astype(np.float32),  # some past 1: the bce clamp
        "acc_person_list": rng.random((R, P)).astype(np.float32),
        "index_in_surface": rng.random(R) > 0.5,
        "temporal_loss": np.float32(0.3),
    }
    gt, sam = rng.random((R, 3)).astype(np.float32), rng.standard_normal((R, P)).astype(np.float32) * 5
    for epoch in (0, 30, 260):
        cfg = loss.LossConfig(sam_start_epoch=20)
        got, logs = loss.total_loss(cfg, {k: _t(v) for k, v in out.items()}, _t(gt), epoch, _t(sam))
        want, jlogs = jloss.total_loss(jloss.LossConfig(sam_start_epoch=20), out, gt, epoch, sam)
        for k in logs:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-6, atol=1e-8, err_msg=f"{k}@{epoch}")
    acc = _t(np.array([1.2, 0.5], np.float32)).requires_grad_(True)
    loss.bce_opacity(acc).backward()
    assert torch.isfinite(acc.grad).all() and acc.grad[0] == 0


def test_adam_and_lr_schedule_match_jax():
    rng = np.random.default_rng(8)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    active = [{"a": True, "b": True}, {"a": True, "b": False}, {"a": True, "b": True}]
    jp, js = p0, joptim.adam_init(p0)
    tp = {k: _t(v).clone() for k, v in p0.items()}
    ts = optim.adam_init(tp)
    for g, a in zip(grads, active):
        jp, js = joptim.adam_update(g, js, jp, jnp.asarray(1e-2), {"a": 1.0, "b": 0.1}, a)
        ts = optim.adam_update({k: _t(v) for k, v in g.items()}, ts, tp, 1e-2, {"a": 1.0, "b": 0.1}, a)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-5)
        assert ts.count[k] == int(js.count[k])
    for e in (0, 199, 200, 499, 500, 900):
        assert optim.multistep_lr(5e-4, e, (200, 500), 0.5) == pytest.approx(
            float(joptim.multistep_lr(5e-4, jnp.asarray(e), (200, 500), 0.5)), rel=1e-6)


def test_config_loads_like_jax_and_unported_options_raise():
    for path in ("confs/taichi01_base.yaml", "confs/model/taichi01_model.yaml"):
        assert load_config(path).to_dict() == jax_load_config(path).to_dict()
    # the quaternion camera pose came with the data layer: a (7,) pose gives
    # the rays of its 4x4 form; what the port still refuses are mode strings
    # that the JAX package does not know either
    from multiply_tpu_torch.utils.cameras import get_camera_params

    uv = torch.rand((4, 2)) * 10
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.3, -0.2, 1.5])
    pose = torch.eye(4)
    pose[:3, 3] = quat[4:]
    for got, want in zip(get_camera_params(uv, quat, torch.eye(3)), get_camera_params(uv, pose, torch.eye(3))):
        torch.testing.assert_close(got, want)
    with pytest.raises(NotImplementedError):
        networks.RenderingNet(mode="view_only", device="cpu")
    # every option that was refused before now builds
    conf = load_config("confs/model/taichi01_model.yaml")
    for key, value in (("sampler_bf16", True), ("bbox_ray_range", True), ("composite_matmul", False)):
        ok = Config(conf.to_dict())
        ok[key] = value
        assert getattr(MultiplyRenderer(_reduced(ok), 2, 4, device="cpu"), key) == value


def _reduced(conf):
    """The same configuration at a reduced width, so that it builds fast on the CPU."""
    conf = Config(conf.to_dict())
    for net, dims, skip in (("implicit_network", [128] * 4, [2]), ("bg_implicit_network", [128] * 4, [2])):
        conf[net]["dims"] = dims
        if conf[net]["skip_in"]:
            conf[net]["skip_in"] = skip
    conf["rendering_network"]["dims"] = [64, 64]
    return conf


MODEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "confs", "model")
MODEL_FILES = sorted(f[:-5] for f in os.listdir(MODEL_DIR) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", MODEL_FILES)
def test_every_model_config_loads_and_builds_a_renderer(name):
    """Each file under confs/model/ loads through the port's `load_config` as
    the JAX package loads it, and the port builds its renderer from it (at a
    reduced width) with every option the file sets."""
    path = f"confs/model/{name}.yaml"
    conf = load_config(path)
    assert conf.to_dict() == jax_load_config(path).to_dict()
    persons = conf.implicit_network.get("number_person", 2)
    renderer = MultiplyRenderer(_reduced(conf), persons, conf.num_training_frames, device="cpu")
    assert renderer.sampler_bf16 == bool(conf.get("sampler_bf16", False))
    assert renderer.bbox_ray_range == bool(conf.get("bbox_ray_range", False))
    assert renderer.frame_latent.shape == (conf.num_training_frames, conf.get("dim_frame_encoding", 32))
    assert renderer.fg_implicit.lins[0].weight.shape[0] == persons
    loss.LossConfig.from_config(conf.loss)
    if name == "taichi01_fast_model":
        assert renderer.sampler_bf16 and renderer.bbox_ray_range
        composed = load_config("confs/taichi01_base.yaml", overrides={"model": conf.to_dict()})
        assert composed.model.sampler_bf16 and composed.dataset.to_dict() == load_config("confs/taichi01_base.yaml").dataset.to_dict()
