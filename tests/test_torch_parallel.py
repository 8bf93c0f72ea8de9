"""Several devices in the port (`multiply_tpu_torch/parallel/`), on the CPU.

The shares of a batch are pure functions of (rank, world) and are tested as
such. Everything that needs processes runs in one module-scoped launch of 2
`gloo` ranks (`_torch_parallel_worker.py`, which imports no JAX), started
before the JAX side compiles so that the two overlap:
  (b) the 2-rank step against JAX's `sharded_train_step` on a 2-device mesh
      (loss, every gradient leaf, the update, with `assert_step_matches`'s
      tolerances) and against the port's 1-process step (1e-6 relative); the
      ranks' parameters bitwise equal;
  (c) a batch whose rays through the SMPL interior are all rank 0's: the step
      passes (b)'s check there, and a planted average of per-rank means fails it;
  (d) the 2-rank `Evaluator` render equal to the 1-rank render.
Every join and process group has a timeout, so a deadlock fails the tests.
"""

import copy
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from _torch_helpers import adam_step_grads, assert_leaf_close, jax_noise, knn_direct, npify, tiny_conf, tiny_program
from multiply_tpu_torch import convert
from multiply_tpu_torch.engine.evaluator import Evaluator
from multiply_tpu_torch.engine.train import Batch
from multiply_tpu_torch.models.renderer import RenderInputs
from multiply_tpu_torch.parallel import shard_batch, shard_noise, shard_rays, shard_render_inputs
from multiply_tpu_torch.parallel.sharding import PER_RAY_FIELDS, RayGroup

EPOCH = 0  # the in-shape and SAM terms on
LOSS_KEYS = ("loss", "rgb_loss", "eikonal_loss", "bce_loss", "in_shape_loss", "sam_mask_loss", "temporal_loss",
             "smpl_surface_loss", "zero_pose_loss")
PIXEL_PER_BATCH = 251  # rounds up to 252 on 2 ranks; the 24x32 frame ends in a 12-pixel chunk
JOIN_S = 150.0


def _batch(rays=8, with_sam=True):
    return Batch(uv=torch.arange(2 * rays, dtype=torch.float32).reshape(rays, 2), rgb=torch.rand(rays, 3),
                 pose=torch.eye(4), intrinsics=torch.eye(3), frame_idx=0, smpl_scale=torch.ones(2),
                 sam_mask=torch.rand(rays, 2) if with_sam else None)


def test_shard_batch_rejects_indivisible_rays():
    """60 rays on 8 ranks raise, with JAX's wording, instead of giving some
    rank more rays."""
    with pytest.raises(ValueError, match="not divisible .* pad the ray batch to a multiple of 8"):
        shard_batch(_batch(60), 0, 8)


def test_shard_batch_keeps_the_pose_whole_on_4_ranks():
    """A (4, 4) camera pose on 4 ranks stays whole: field names, not shapes,
    decide what is per-ray. `uv` splits."""
    b = _batch(64, with_sam=False)
    shares = [shard_batch(b, r, 4) for r in range(4)]
    assert all(s.sam_mask is None and s.pose is b.pose and s.uv.shape == (16, 2) for s in shares)
    full = _batch(64)
    for name in PER_RAY_FIELDS:
        assert torch.equal(torch.cat([getattr(shard_batch(full, r, 4), name) for r in range(4)]), getattr(full, name))


def test_shard_render_inputs_splits_uv_only():
    inputs = RenderInputs(uv=torch.rand(12, 2), pose=torch.eye(4), intrinsics=torch.eye(3), scale=torch.ones(2),
                          transl=torch.zeros(2, 3), thetas=torch.zeros(2, 72), betas=torch.zeros(2, 10),
                          frame_idx=1, epoch=3)
    share = shard_render_inputs(inputs, 1, 2)
    assert torch.equal(share.uv, inputs.uv[6:])
    assert all(getattr(share, f) is getattr(inputs, f) for f in inputs._fields if f != "uv")
    with pytest.raises(ValueError, match="pad the pixel chunk to a multiple of 5"):
        shard_render_inputs(inputs, 0, 5)


def test_shard_noise_splits_the_per_ray_draws_by_key():
    """`sampler_u` splits on its ray axis (1) and `bg_u` on axis 0; the
    per-person and per-vertex draws stay whole, whatever their shapes (here
    `surface_idx`, (P, R), has a ray-sized axis and stays whole)."""
    P, R = 2, 8
    noise = {"sampler_u": torch.rand(P, R, 5), "sampler_perm": torch.randint(0, 9, (P, 4)), "bg_u": torch.rand(R, 4),
             "eik_idx": torch.randint(0, 9, (P, R)), "eik_normal": torch.rand(P, R, 3),
             "surface_idx": torch.randint(0, 9, (P, R)), "zero_pose_idx": torch.randint(0, 9, (P, R)),
             "interp_idx": [torch.arange(R), torch.arange(R)]}
    shares = [shard_noise(noise, r, 2) for r in range(2)]
    assert torch.equal(torch.cat([s["sampler_u"] for s in shares], 1), noise["sampler_u"])
    assert torch.equal(torch.cat([s["bg_u"] for s in shares], 0), noise["bg_u"])
    assert shares[1]["sampler_u"].shape == (P, R // 2, 5)
    for s in shares:
        for k in ("sampler_perm", "eik_idx", "eik_normal", "surface_idx", "zero_pose_idx", "interp_idx"):
            assert s[k] is noise[k], k


def test_shard_rays_splits_what_divides():
    group = RayGroup(rank=1, world=4, device=torch.device("cpu"), backend="gloo")
    tree = {"a": torch.arange(8), "b": torch.arange(6), "s": torch.tensor(3.0), "n": 5}
    out = shard_rays(tree, group)
    assert torch.equal(out["a"], torch.tensor([2, 3])) and out["b"] is tree["b"]
    assert out["s"] is tree["s"] and out["n"] == 5


# ----------------------------------------------------------------------
# two ranks
# ----------------------------------------------------------------------


def _split_batch(port, noise, scene, rng):
    """(uv, rgb, sam) of a batch whose first half of rays pass through the
    SMPL interior and whose second half do not, with `noise` at their
    positions: on 2 ranks, rank 0 holds every in-shape ray and rank 1 none."""
    renderer, state, _, ts, batch = port
    R = batch.uv.shape[0]
    H, W = scene.height, scene.width
    pool = rng.permutation(H * W)
    uv = batch.uv.clone()
    tried, idx = R, batch.frame_idx
    for _ in range(60):
        inputs = RenderInputs(uv=uv, pose=batch.pose, intrinsics=batch.intrinsics, scale=batch.smpl_scale,
                              transl=ts.body.transl[:, idx], thetas=ts.body.thetas(idx), betas=ts.body.betas[:, 0],
                              frame_idx=idx, epoch=EPOCH)
        with torch.no_grad():
            inside = renderer.render(state, inputs, train=True, noise=noise)["index_in_surface"]
        wrong = torch.cat([~inside[: R // 2], inside[R // 2:]]).nonzero()[:, 0].tolist()
        if not wrong:
            break
        for i in wrong:
            p = pool[tried]
            tried += 1
            uv[i] = torch.tensor([p % W, p // W], dtype=torch.float32)
    assert not wrong, f"no split found: rays {wrong} still on the wrong side"
    px, py = uv[:, 0].long().numpy(), uv[:, 1].long().numpy()
    return uv, scene.images[idx][py, px], scene.sam_logits[idx][py, px]


def _jax_sharded_step(step, mesh, jts, jbatch, key):
    """JAX's `sharded_train_step` on the mesh: its logs and parameters, and
    the Adam states around it (whence its gradients)."""
    from multiply_tpu.engine.train import MODE_JOINT as JAX_MODE_JOINT
    from multiply_tpu.parallel import replicate
    from multiply_tpu.parallel.sharding import shard_batch as jax_shard_batch

    jts = jts._replace(epoch=jnp.asarray(EPOCH))
    jbatch = jbatch._replace(mode=jnp.asarray(JAX_MODE_JOINT))
    new, logs = step(replicate(jts, mesh), jax_shard_batch(jbatch, mesh), key)
    new, logs, before = npify(new), npify(logs), npify(jts)
    return {"logs": logs, "params": new.params,
            "pairs": [(before.opt_joint, new.opt_joint), (before.opt_pose, new.opt_pose)]}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import multiply_tpu.ops.knn_pallas as kp
    from multiply_tpu.parallel import make_mesh
    from multiply_tpu.parallel.sharding import sharded_train_step as jax_sharded_train_step

    from _torch_helpers import tiny_scene

    tmp = tmp_path_factory.mktemp("two_ranks")
    jax_side, port = tiny_program(tiny_conf(), rays=24)
    jr, jstate, jb, jts, jbatch = jax_side
    renderer, state, stepper, ts, batch = port
    key = jax.random.PRNGKey(3)
    R, V = batch.uv.shape[0], state.server.verts_c.shape[1]
    noise = jax_noise(key, jr, R, V, np.asarray(jstate.surface_sample_logits), None, stepper.interp_samples)
    scene = tiny_scene()
    uv_c, rgb_c, sam_c = _split_batch(port, noise, scene, np.random.default_rng(5))
    batch_c = copy.copy(batch)
    batch_c.uv, batch_c.rgb, batch_c.sam_mask = uv_c, torch.as_tensor(rgb_c), torch.as_tensor(sam_c)
    jbatch_c = jbatch._replace(uv=jnp.asarray(uv_c.numpy()), rgb=jnp.asarray(rgb_c), sam_mask=jnp.asarray(sam_c))

    H, W = scene.height, scene.width
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    item = {"uv": np.stack([px.ravel(), py.ravel()], -1).astype(np.float32), "img_size": (H, W), "idx": 0,
            "pose": scene.cam_pose[0], "intrinsics": scene.intrinsics, "smpl_scale": scene.scale,
            "rgb": scene.images[0].reshape(-1, 3)}
    inputs_path = str(tmp / "inputs.pt")
    torch.save({"stepper": stepper, "ts": ts, "epoch": EPOCH, "item": item, "pixel_per_batch": PIXEL_PER_BATCH,
                "cases": {"b": (batch, noise, False), "c": (batch_c, noise, False), "c_fault": (batch_c, noise, True)}},
               inputs_path)
    proc = multiprocessing.get_context("spawn").Process(target=worker.run_ranks, args=(inputs_path, str(tmp)))
    proc.start()
    try:
        # meanwhile: JAX's sharded step, the port's 1-process step and render
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kp, "knn_auto", knn_direct)
            mesh = make_mesh(2)
            step = jax_sharded_train_step(jb.step, mesh)  # one compile for both batches
            jax_b, jax_c = (_jax_sharded_step(step, mesh, jts, b, key) for b in (jbatch, jbatch_c))
        one = copy.deepcopy(ts)
        one.epoch = EPOCH
        _, one_logs, one_grads = stepper.loss_and_grads(one, batch, noise=noise)
        one, _ = stepper.step(one, batch, noise=noise)
        render_1 = Evaluator(renderer, state, [], pixel_per_batch=PIXEL_PER_BATCH).render_image(ts.body, item,
                                                                                                 epoch=100)
    finally:
        proc.join(JOIN_S)
        if proc.is_alive():
            proc.terminate()
    assert proc.exitcode == 0, f"the 2-rank run ended with {proc.exitcode}"
    ranks = {f: [torch.load(tmp / f"{f}_{r}.pt", weights_only=False) for r in (0, 1)]
             for f in ("b", "c", "c_fault", "render")}
    return {"jax": {"b": jax_b, "c": jax_c}, "ranks": ranks, "lr": stepper.lr, "render_1": render_1,
            "one": {"logs": {k: float(v.detach()) for k, v in one_logs.items()}, "grads": one_grads,
                    "params": {k: p.detach() for k, p in one.params().items()}}}


def check_against_jax(port: dict, jax: dict, lr: float) -> None:
    """(b)'s check: `assert_step_matches`'s tolerances on the logged terms,
    every gradient leaf (JAX's recovered from its Adam moments) and the
    updated parameters."""
    for k in LOSS_KEYS:
        np.testing.assert_allclose(port["logs"][k], float(jax["logs"][k]), rtol=2e-5, atol=1e-7, err_msg=k)
    jgrads = adam_step_grads(list(port["grads"]), jax["pairs"])
    for name, g in port["grads"].items():
        assert_leaf_close(name, convert.to_flax_layout(name, g), jgrads[name], rel=1e-2, atol=1e-9)
    for name, p in port["params"].items():
        f = 0.1 if name.startswith("body.") else 1.0
        got, want = convert.to_flax_layout(name, p), convert.flax_leaf(jax["params"], name)
        strict = np.abs(jgrads[name]) > 1e-5
        np.testing.assert_allclose(got, want, atol=2 * lr * f + 1e-6, err_msg=name)
        np.testing.assert_allclose(got[strict], want[strict], atol=2e-6, err_msg=name)


def test_two_rank_step_matches_jax_sharded_step(two_ranks):
    rank0 = two_ranks["ranks"]["b"][0]
    assert rank0["logs"]["update_skipped"] == 0.0
    check_against_jax(rank0, two_ranks["jax"]["b"], two_ranks["lr"])


def test_two_rank_step_matches_the_one_process_step(two_ranks):
    """The summed shares are the 1-process loss and gradient to f32
    rounding: every logged term and every gradient leaf within 1e-6 of its
    largest entry, every updated parameter within 1e-6 of the leaf's largest."""
    rank0, one = two_ranks["ranks"]["b"][0], two_ranks["one"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(rank0["logs"][k], one["logs"][k], rtol=1e-6, atol=1e-9, err_msg=k)
    for name, g in one["grads"].items():
        assert_leaf_close(name, rank0["grads"][name].numpy(), g.numpy(), rel=1e-6, atol=1e-12)
    for name, p in one["params"].items():
        assert_leaf_close(name, rank0["params"][name].numpy(), p.numpy(), rel=1e-6)


@pytest.mark.parametrize("case", ["b", "c"])
def test_ranks_parameters_are_bitwise_equal(two_ranks, case):
    r0, r1 = two_ranks["ranks"][case]
    assert r0["logs"] == r1["logs"]
    assert all(torch.equal(p, r1["params"][k]) for k, p in r0["params"].items())


def test_whole_batch_denominators_hold_where_a_per_rank_mean_fails(two_ranks):
    """(c): rank 0 holds every ray through the SMPL interior, rank 1 none
    (their in-shape fractions of the whole batch's count are 1 and 0). The
    step still passes (b)'s check against JAX; the same step with each rank's
    own means averaged over the ranks does not."""
    correct, fault = two_ranks["ranks"]["c"], two_ranks["ranks"]["c_fault"]
    assert [float(r["fractions"][2]) for r in correct] == [1.0, 0.0]
    check_against_jax(correct[0], two_ranks["jax"]["c"], two_ranks["lr"])
    with pytest.raises(AssertionError):
        check_against_jax(fault[0], two_ranks["jax"]["c"], two_ranks["lr"])


def test_two_rank_render_matches_one_rank(two_ranks):
    """(d): `pixel_per_batch` 251 rounds up to 252; each rank renders half of
    every chunk (the last one, 12 pixels, too) and both ranks hold the whole
    gathered frame."""
    r0, r1 = two_ranks["ranks"]["render"]
    one = two_ranks["render_1"]
    assert r0["chunk"] == 252
    for k in ("rgb_image", "fg_image", "normal_image", "mask_image", "instance_images"):
        np.testing.assert_allclose(r0["render"][k], one[k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(r0["render"][k], r1["render"][k], err_msg=k)
    np.testing.assert_allclose(r0["render"]["psnr"], one["psnr"], rtol=1e-6)
