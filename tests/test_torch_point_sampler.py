"""The port's point sampler against `multiply_tpu.ops.point_sampler`: the
numbers `jax.random` drew, handed to the port as its noise, give the same
samples, occupancy targets and skinning weights (1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiply_tpu.ops import point_sampler as jps
from multiply_tpu_torch.ops import point_sampler as tps


def joints():
    rng = np.random.default_rng(0)
    return rng.normal(0, 0.4, (24, 3)).astype(np.float32)


def test_default_bone_ids_match_jax():
    assert np.array_equal(tps.default_bone_ids().numpy(), np.asarray(jps.default_bone_ids()))


@pytest.mark.parametrize("n,ratio", [(64, 0.125), (7, 0.125), (40, 0.5), (16, 0.0)])
def test_points_in_space_match_jax(n, ratio):
    """Local gaussians plus int(n * ratio) global uniforms; none when that is 0."""
    key = jax.random.PRNGKey(n)
    pc = np.random.default_rng(n).normal(0, 0.5, (n, 3)).astype(np.float32)
    want = np.asarray(jps.sample_points_in_space(key, jnp.asarray(pc), 0.02, 0.7, ratio))
    k1, k2 = jax.random.split(key)
    n_global = int(n * ratio)
    noise = {"normal": torch.as_tensor(np.array(jax.random.normal(k1, (n, 3)))),
             "uniform": torch.as_tensor(np.array(jax.random.uniform(k2, (n_global, 3))))}
    got = tps.sample_points_in_space(torch.as_tensor(pc), 0.02, 0.7, ratio, noise=noise)
    assert got.shape == want.shape == (n + n_global, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    drawn = tps.sample_points_in_space(torch.as_tensor(pc), 0.02, 0.7, ratio,
                                       generator=torch.Generator().manual_seed(0))
    assert drawn.shape == want.shape and (drawn[n:].abs() <= 0.7).all()


@pytest.mark.parametrize("jitter", [0.001, 0.5])
def test_points_on_bones_match_jax(jitter):
    """The bones' jittered positions, clipped to [0, 1] (the large jitter
    clips many), and the 0.01 occupancy targets."""
    key = jax.random.PRNGKey(3)
    J = joints()
    ws, wo = jps.sample_points_on_bones(key, jnp.asarray(J), num_per_bone=6, jitter=jitter)
    noise = torch.as_tensor(np.array(jax.random.normal(key, (23, 6))))
    gs, go = tps.sample_points_on_bones(torch.as_tensor(J), num_per_bone=6, jitter=jitter, noise=noise)
    assert gs.shape == (23 * 6, 3)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=0, atol=1e-6)
    bones = np.array(jps.default_bone_ids())[:5]
    ws, _ = jps.sample_points_on_bones(key, jnp.asarray(J), jnp.asarray(bones), num_per_bone=3, jitter=jitter)
    noise = torch.as_tensor(np.array(jax.random.normal(key, (5, 3))))
    gs, _ = tps.sample_points_on_bones(torch.as_tensor(J), torch.as_tensor(bones), num_per_bone=3, jitter=jitter,
                                       noise=noise)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)


def test_joints_with_one_hot_weights_match_jax():
    J = joints()
    ws, ww = jps.sample_joints(jnp.asarray(J))
    gs, gw = tps.sample_joints(torch.as_tensor(J))
    assert np.array_equal(gs.numpy(), np.asarray(ws)) and np.array_equal(gw.numpy(), np.asarray(ww))
    assert gw.shape == (24 + 23, 24) and (gw.sum(-1) == 1).all()
