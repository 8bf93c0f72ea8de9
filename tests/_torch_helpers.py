"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

Builds the JAX package's small training program (`_build(full_scale=False)`)
and the port's counterpart from the same converted weights and state, and
draws the training noise along the JAX key path so both see the same numbers.
Everything runs on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def knn_direct(query, refs, k=1, chunk_size=8192):
    """What the TPU's NN kernel computes (direct differences, first index on
    ties), for the JAX side of whole-slice parity on the CPU. K > 1 keeps the
    JAX package's own path."""
    if k != 1:
        from multiply_tpu.ops.knn import knn

        return knn(query, refs, k=k, chunk_size=chunk_size)
    d = query[:, None, :] - refs[None, :, :]
    d2 = (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2
    idx = jnp.argmin(d2, axis=-1)[:, None]
    return jnp.maximum(jnp.take_along_axis(d2, idx, -1), 0.0), idx


@pytest.fixture
def direct_knn(monkeypatch):
    """Route the JAX package's K=1 NN through `knn_direct` in this test process."""
    import multiply_tpu.ops.knn_pallas as kp

    monkeypatch.setattr(kp, "knn_auto", knn_direct)


def npify(tree):
    return jax.tree.map(np.asarray, tree)


def jax_noise(key, renderer, num_rays: int, num_verts: int) -> dict:
    """The JAX renderer's training draws for `key`, in the port's noise layout."""
    P, cfg = renderer.P, renderer.sampler_cfg
    M = cfg.N_samples_eval * cfg.max_total_iters
    u, perm = [], []
    for k in jax.random.split(key, P):
        ks = jax.random.split(k, 4)
        u.append(jax.random.uniform(ks[0], (num_rays, cfg.N_samples)))
        perm.append(jax.random.permutation(ks[1], M)[: cfg.N_samples_extra])
    ek = jax.random.split(key, 2 * P)
    noise = {
        "sampler_u": np.stack(u),
        "sampler_perm": np.stack(perm).astype(np.int64),
        "bg_u": jax.random.uniform(
            jax.random.fold_in(key, 17), (num_rays, cfg.N_samples_inverse_sphere)
        ),
        "eik_idx": np.stack(
            [np.asarray(jax.random.randint(ek[p], (512,), 0, num_verts)) for p in range(P)]
        ).astype(np.int64),
        "eik_normal": np.stack([np.asarray(jax.random.normal(ek[P + p], (512, 3))) for p in range(P)]),
    }
    return {k: torch.tensor(np.array(v)) for k, v in noise.items()}


@functools.lru_cache(maxsize=1)
def small_program():
    """(JAX objects, port objects) of the small training program, same weights."""
    from __graft_entry__ import _build

    from multiply_tpu_torch import convert
    from multiply_tpu_torch.body.params import BodyParamTable
    from multiply_tpu_torch.config import Config
    from multiply_tpu_torch.engine.train import Batch, TrainStep
    from multiply_tpu_torch.models.loss import LossConfig
    from multiply_tpu_torch.models.renderer import MultiplyRenderer

    scene, jr, jstate, jb, jts, jbatch = _build(full_scale=False)
    renderer = MultiplyRenderer(Config(jr.conf.to_dict()), jr.P, jr.num_frames, device="cpu")
    state = convert.person_state_from_jax(npify(jstate), device="cpu")
    builder = TrainStep(renderer, state, LossConfig(sam_start_epoch=0))
    body = BodyParamTable(*(torch.zeros(np.shape(x)) for x in jts.params["body"]))
    ts = builder.init_state(body)
    convert.load_params(ts.params(), npify(jts.params))
    b = npify(jbatch)
    batch = Batch(
        uv=torch.tensor(b.uv), rgb=torch.tensor(b.rgb), pose=torch.tensor(b.pose),
        intrinsics=torch.tensor(b.intrinsics), frame_idx=int(b.frame_idx),
        smpl_scale=torch.tensor(b.smpl_scale), sam_mask=torch.tensor(b.sam_mask),
    )
    return (jr, jstate, jb, jts, jbatch), (renderer, state, builder, ts, batch)


def assert_leaf_close(name, got, want, rel, atol=0.0):
    """|got - want| <= rel * max|want| + atol, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    bound = rel * np.abs(want).max() + atol if want.size else atol
    assert err <= bound, f"{name}: max err {err:.3g} > {bound:.3g}"
