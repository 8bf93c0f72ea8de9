"""Whole training steps of the port's other model configurations against the
JAX package, on the CPU at a tiny size: loss, every gradient leaf and the
updated parameters, with the JAX weights carried across by `convert.py` (which
raises on any leaf left over or missing) and the JAX key path's noise handed in.

The JAX side's K=1 NN runs as direct differences (`direct_knn`), which is what
its TPU kernel computes, so both sides pick the same vertices.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import assert_step_matches, direct_knn, jax_noise, tiny_conf, tiny_program  # noqa: F401

VARIANTS = {
    # the renderer's options together: box-clipped ray ranges, the sorted
    # composite, a shadow channel, and the SMPL-surface and zero-pose terms
    "options": (
        tiny_conf(bbox_ray_range=True, composite_matmul=False, bg_rendering_network__d_out=4,
                  loss={"smpl_surface_weight": 0.5, "zero_pose_weight": 0.3}),
        dict(smpl_surface_weight=0.5, zero_pose_weight=0.3),
    ),
    # one shared shape net with identity latents, per-person offset heads and beta encoders
    "shared": (
        tiny_conf(use_person_encoder=True, implicit_network__cond="smpl_id", implicit_network__offset_head=True,
                  implicit_network__beta_encoding=True, rendering_network__mode="pose_id_no_view"),
        {},
    ),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_train_step_matches_jax(direct_knn, variant):
    conf, loss_kw = VARIANTS[variant]
    jax_side, port_side = tiny_program(conf, loss_kw)
    logs, grads, jlogs, *_ = assert_step_matches(jax_side, port_side, epoch=30, key=jax.random.PRNGKey(3))
    new = [k for k in grads if any(s in k for s in ("triplane", "offset_head", "beta_encoder", "person_latent", "lin_id"))]
    if variant == "options":
        assert float(logs["smpl_surface_loss"].detach()) > 0 and float(logs["zero_pose_loss"].detach()) > 0
    else:
        assert new and all(float(grads[k].abs().max()) > 0 for k in new), new
    if variant == "shared":  # the shared net has no person axis, the render nets keep theirs
        renderer = port_side[0]
        assert renderer.fg_implicit.lins[0].weight.dim() == 2 and renderer.fg_render.lins[0].weight.dim() == 3


def test_sort_composite_matches_the_pairwise_one():
    """The port's two composites on the same weights and noise: equal up to
    float association (rtol 1e-5 on the composited outputs)."""
    from multiply_tpu_torch.models.renderer import RenderInputs

    _, (renderer, state, stepper, ts, batch) = tiny_program(tiny_conf())
    inputs = RenderInputs(
        uv=batch.uv, pose=batch.pose, intrinsics=batch.intrinsics, scale=batch.smpl_scale,
        transl=ts.body.transl[:, 1], thetas=ts.body.thetas(1), betas=ts.body.betas[:, 0], frame_idx=1, epoch=30,
    )
    noise = renderer.draw_noise(batch.uv.shape[0], 386, torch.Generator().manual_seed(0))
    out = {}
    for flag in (True, False):
        renderer.composite_matmul = flag
        with torch.no_grad():
            out[flag] = renderer.render(state, inputs, train=True, noise=noise)
    renderer.composite_matmul = True
    for k in ("rgb_values", "normal_values", "acc_map", "acc_person_list", "bg_transmittance"):
        np.testing.assert_allclose(out[False][k].numpy(), out[True][k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    # the sorted weights are the pairwise ones in depth order
    np.testing.assert_allclose(np.sort(out[False]["weights"].numpy(), -1), np.sort(out[True]["weights"].numpy(), -1),
                               rtol=1e-5, atol=1e-7)


def test_cond_zero_forces_the_zero_pose_conditioning():
    from multiply_tpu_torch.models.renderer import RenderInputs

    _, (renderer, state, stepper, ts, batch) = tiny_program(tiny_conf())
    kw = dict(uv=batch.uv, pose=batch.pose, intrinsics=batch.intrinsics, scale=batch.smpl_scale,
              transl=ts.body.transl[:, 1], thetas=ts.body.thetas(1), betas=ts.body.betas[:, 0], frame_idx=1)
    noise = renderer.draw_noise(batch.uv.shape[0], 386, torch.Generator().manual_seed(0))
    with torch.no_grad():
        posed = renderer.render(state, RenderInputs(epoch=30, **kw), train=True, noise=noise)
        forced = renderer.render(state, RenderInputs(epoch=30, **kw), train=True, noise=noise, cond_zero=True)
        early = renderer.render(state, RenderInputs(epoch=0, **kw), train=True, noise=noise)
    assert torch.equal(forced["rgb_values"], early["rgb_values"])
    assert not torch.equal(forced["rgb_values"], posed["rgb_values"])


def test_sampler_bf16_step_stays_in_a_band_around_jax(direct_knn):
    """`sampler_bf16`: the sampler's SDF function against JAX's, and the whole
    step's loss against JAX's.

    bfloat16 keeps 8 bits of mantissa, and the two frameworks round the weight
    norm, the matmul accumulation and softplus at different points, so the SDF
    values agree only to a few bf16 ulps of the layer widths' sums: 0.03
    absolute here, against f32's 1e-5. The sampler only places samples, but a
    sample that moves changes every later number of the step, so the loss is
    held to a band (5% of JAX's loss), not to f32 rounding."""
    conf = tiny_conf(sampler_bf16=True, bbox_ray_range=True)
    (jr, jstate, jb, jts, jbatch), (renderer, state, stepper, ts, batch) = tiny_program(conf)
    epoch, key = 30, jax.random.PRNGKey(3)

    # the sampler's SDF function: the implicit net with every leaf cast to bf16
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 200, 3)) * 0.4).astype(np.float32)
    cond = (rng.standard_normal((2, 69)) * 0.3).astype(np.float32)
    bundle16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jr.implicit_bundle(jts.params["net"]))
    want = jax.vmap(lambda b, xx, cc: jr._implicit(b, xx, cc.astype(jnp.bfloat16))[:, 0].astype(jnp.float32),
                    in_axes=(jr.bundle_axes(), 0, 0))(bundle16, jnp.asarray(x), jnp.asarray(cond))
    with torch.no_grad():
        got16 = renderer._implicit(torch.tensor(x), torch.tensor(cond), bundle=renderer.implicit_bundle(torch.bfloat16))
        got32 = renderer._implicit(torch.tensor(x), torch.tensor(cond))[..., 0]
    assert got16.dtype == torch.bfloat16
    got16 = got16[..., 0].float()
    np.testing.assert_allclose(got16.numpy(), np.asarray(want), atol=0.03)
    assert float((got16 - got32).abs().max()) > 0  # it really ran in another precision

    jts = jts._replace(epoch=jnp.asarray(epoch))
    _, jlogs = jax.jit(lambda t, b, k: jb._forward_loss(t.params, jstate, b, t.epoch, k, None))(jts, jbatch, key)
    ts = copy.deepcopy(ts)
    ts.epoch = epoch
    noise = jax_noise(key, jr, batch.uv.shape[0], 386)
    loss, logs, grads = stepper.loss_and_grads(ts, batch, noise=noise)
    assert abs(float(loss.detach()) - float(jlogs["loss"])) <= 0.05 * float(jlogs["loss"])
    assert all(torch.isfinite(g).all() for g in grads.values())
    # nothing downstream of the sampler runs in bf16: every gradient is f32
    assert all(g.dtype == torch.float32 for g in grads.values())
