"""The port's slice as a whole against the JAX package, on the CPU, from the
same converted weights and state: `render(train=False)`, and one training
step with the JAX key path's noise injected (loss, every gradient leaf and
the updated parameters).

The JAX side's K=1 NN runs as direct differences (`direct_knn`), which is
what its TPU kernel computes, so both sides pick the same vertices.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import assert_leaf_close, direct_knn, jax_noise, npify, small_program  # noqa: F401

from multiply_tpu.models.renderer import RenderInputs as JaxRenderInputs
from multiply_tpu_torch import convert
from multiply_tpu_torch.models.renderer import RenderInputs


def test_render_eval_matches_jax(direct_knn):
    (jr, jstate, _, jts, jbatch), (renderer, state, _, ts, batch) = small_program()
    jbody = jts.params["body"]
    idx = 1
    jin = JaxRenderInputs(
        uv=jbatch.uv, pose=jbatch.pose, intrinsics=jbatch.intrinsics, scale=jbatch.smpl_scale,
        transl=jbody.transl[:, idx], thetas=jnp.concatenate([jbody.global_orient[:, idx], jbody.body_pose[:, idx]], -1),
        betas=jbody.betas[:, 0], frame_idx=jnp.asarray(idx), epoch=jnp.asarray(1000),
    )
    want = npify(jax.jit(lambda p, s, i: jr.render(p, s, i, train=False))(jts.params["net"], jstate, jin))
    inputs = RenderInputs(
        uv=batch.uv, pose=batch.pose, intrinsics=batch.intrinsics, scale=batch.smpl_scale,
        transl=ts.body.transl[:, idx], thetas=ts.body.thetas(idx), betas=ts.body.betas[:, 0],
        frame_idx=idx, epoch=1000,
    )
    with torch.no_grad():
        got = renderer.render(state, inputs, train=False)
    # f32 on both sides; the sampler and MLPs sum in another order, so allow
    # a few ulps amplified through the 3-round sampler and the composite
    for k in ("rgb_values", "acc_map", "normal_values", "acc_person_list", "bg_transmittance"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["hit"].numpy(), want["hit"])


def test_train_step_matches_jax(direct_knn):
    (jr, jstate, jb, jts, jbatch), (renderer, state, builder, ts, batch) = small_program()
    epoch = 30  # pose conditioning on, in-shape term on
    jts = jts._replace(epoch=jnp.asarray(epoch))
    ts = copy.deepcopy(ts)
    ts.epoch = epoch
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jax_step(t, b, k):
        (_, logs), grads = jax.value_and_grad(jb._forward_loss, has_aux=True)(
            t.params, jstate, b, t.epoch, k, None
        )
        new_t, _ = jb.step(t, b, k)
        return logs, grads, new_t.params

    jlogs, jgrads, jnew = npify(jax_step(jts, jbatch, key))
    noise = jax_noise(key, jr, batch.uv.shape[0], state.server.verts_c.shape[1])

    loss, logs, grads = builder.loss_and_grads(ts, batch, noise=noise)
    # every term is an f32 mean over the same samples: agree to f32 rounding
    for k in ("loss", "rgb_loss", "eikonal_loss", "bce_loss", "in_shape_loss", "sam_mask_loss"):
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]), rtol=2e-5, atol=1e-7, err_msg=k)

    # gradients pass through second-order autograd (normals, eikonal) in
    # another summation order: 1% of each leaf's largest entry (seen: <0.2%)
    assert set(grads) == set(ts.params())
    for name, g in grads.items():
        assert_leaf_close(name, convert.to_flax_layout(name, g), convert.flax_leaf(jgrads, name), rel=1e-2, atol=1e-9)

    ts, step_logs = builder.step(ts, batch, noise=noise)
    assert step_logs["update_skipped"] == 0.0
    # Adam's first step is lr*f*g/(|g|+eps): ~lr*f*sign(g), so an entry whose
    # gradient is near zero may move by up to 2*lr*f differently; elsewhere
    # the step agrees to f32 rounding of the parameter
    lr = builder.lr
    for name, p in ts.params().items():
        f = 0.1 if name.startswith("body.") else 1.0
        got = convert.to_flax_layout(name, p)
        want = convert.flax_leaf(jnew, name)
        g = np.abs(convert.flax_leaf(jgrads, name))
        strict = g > 1e-5
        np.testing.assert_allclose(got, want, atol=2 * lr * f + 1e-6, err_msg=name)
        np.testing.assert_allclose(got[strict], want[strict], atol=2e-6, err_msg=name)


def test_train_step_modes_and_nonfinite_skip():
    """Pose-only mode moves only the body through the pose optimizer; a
    non-finite gradient drops the whole update, moments included."""
    from multiply_tpu_torch.engine.train import MODE_DELAYED_POSE, MODE_POSE_ONLY

    _, (renderer, state, builder, ts, batch) = small_program()
    ts, batch = copy.deepcopy(ts), copy.copy(batch)
    gen = torch.Generator().manual_seed(0)
    before = {k: p.detach().clone() for k, p in ts.params().items()}

    batch.mode = MODE_POSE_ONLY
    ts, logs = builder.step(ts, batch, generator=gen)
    assert logs["update_skipped"] == 0.0
    for k, p in ts.params().items():
        assert torch.equal(p, before[k]) != k.startswith("body."), k
    assert all(c == 1 for c in ts.opt_pose.count.values())
    assert all(c == 0 for c in ts.opt_joint.count.values())

    batch.mode = MODE_DELAYED_POSE
    ts, _ = builder.step(ts, batch, generator=gen)
    assert ts.opt_joint.count["net.frame_latent"] == 1 and ts.opt_joint.count["net.beta"] == 1
    assert ts.opt_joint.count["net.fg_implicit.lins.0.weight"] == 0
    assert ts.opt_joint.count["body.transl"] == 1

    snapshot = copy.deepcopy((ts.params(), ts.opt_joint, ts.opt_pose))
    with torch.no_grad():
        ts.model.bg_render.lins[0].bias[0] = float("nan")  # NaN loss and grads
    nan_params = {k: p.detach().clone() for k, p in ts.params().items()}
    batch.mode = 0
    ts, logs = builder.step(ts, batch, generator=gen)
    assert logs["update_skipped"] == 1.0
    for k, p in ts.params().items():
        assert torch.allclose(p, nan_params[k], rtol=0, atol=0, equal_nan=True), k
    assert ts.opt_joint.count == snapshot[1].count and ts.opt_pose.count == snapshot[2].count
    for k in ts.opt_joint.mu:
        assert torch.equal(ts.opt_joint.mu[k], snapshot[1].mu[k]), k
