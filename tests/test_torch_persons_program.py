"""One person and three persons through the port's program against the JAX
package on the CPU: the scene maker, the SAM prompts and the decoder's
padded inputs, the epoch-end stages, one epoch of each training mode, the
opt_depth loop, the counterpart of `tests/test_single_person.py`, and the
entries on `confs/synthetic_p3.yaml`.

The three-person trainers are `confs/synthetic_p3.yaml` (the paper's MMM
configuration: P = 3, `synthetic_model` widths, mesh refresh every 20 epochs,
pose correction from 24, opt_depth at 30, instance masks + SAM at 50) with
these cuts, all for the CPU's time unless said otherwise:
  * 2 frames of 24 x 32 (the config: 4 of 48 x 64), 32 rays a step (128);
  * canonical grid res 8 and no mesh up-sampling (32 and 2): the stages and
    the pose batches extract meshes from it;
  * opt_depth: 2 iterations a frame on 96 pixels in 32-ray chunks, 48
    interpenetration samples, meshes padded to 1024 (100, 4096, 5120, 8192);
  * `sampler_bf16` off: bf16 cannot be matched bit for bit (the step's loss
    is held to a band at P = 3 in `test_torch_persons_step.py`);
  * learning rate 1e-5 (3e-3), so that an epoch's four steps stay on JAX's
    path (each change is held to a tenth of one Adam step all the same).
One JAX and one port trainer share a run directory and start from the same
jittered weights and per-person state (carried across by `convert`); the
port's step noise is JAX's key path's, handed in through `builder.draw_noise`,
as in `tests/test_torch_trainer.py`. The JAX side's K=1 search runs through
direct differences, as the TPU kernel computes it.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import adam_step_grads, jax_noise, knn_direct, npify, record_adam_grads
from multiply_tpu.config import load_config as jax_load_config
from multiply_tpu.data.synthetic import make_scene as jax_make_scene
from multiply_tpu.data.synthetic_sequence import SyntheticSequence as JaxSequence
from multiply_tpu.engine import instance_masks as j_masks
from multiply_tpu.engine import sam_stage as j_sam
from multiply_tpu.engine import trainer as j_trainer
from multiply_tpu.models import sam as j_sam_model
from multiply_tpu.models.renderer import MultiplyRenderer as JaxRenderer
from multiply_tpu_torch import convert
from multiply_tpu_torch.cli import test as cli_test
from multiply_tpu_torch.cli import train as cli_train
from multiply_tpu_torch.config import load_config
from multiply_tpu_torch.data.synthetic import SyntheticScene
from multiply_tpu_torch.data.synthetic import make_scene
from multiply_tpu_torch.data.synthetic_sequence import SyntheticSequence
from multiply_tpu_torch.engine import instance_masks as t_masks
from multiply_tpu_torch.engine import sam_stage as t_sam
from multiply_tpu_torch.engine import train as t_train
from multiply_tpu_torch.engine import trainer as t_trainer
from multiply_tpu_torch.engine.train import MODE_JOINT, MODE_POSE_ONLY
from multiply_tpu_torch.models import sam as t_sam_model
from test_torch_trainer import assert_updates_match

CONFS = os.path.join(os.path.dirname(__file__), "..", "confs")
P3_CONF = os.path.join(CONFS, "synthetic_p3.yaml")
P3_FRAMES, P3_HW, P3_RAYS = 2, (24, 32), 32
P3_OVERRIDES = {
    "model": {
        "learning_rate": 1.0e-5, "sampler_bf16": False, "num_training_frames": P3_FRAMES, "cano_grid_res": 8,
        "cano_mesh_res_up": 0, "it_per_loop": 2, "depth_render_rays": 32, "depth_pixel_samples": 96,
        "pose_pixel_samples": 64, "interp_samples": 48, "mesh_pad_bucket": 1024,
    },
    "dataset": {"train": {"num_sample": P3_RAYS, "end_frame": P3_FRAMES, "height": P3_HW[0], "width": P3_HW[1]}},
}
# tests/test_single_person.py's configuration (its meshes without up-sampling,
# for the CPU's time: the JAX test extracts none), and the trainer test's
# learning rate
P1_CONF = os.path.join(CONFS, "synthetic_base.yaml")
P1_FRAMES, P1_HW, P1_RAYS = 2, (28, 36), 48
P1_OVERRIDES = {
    "model": {
        "learning_rate": 1.0e-5,
        "implicit_network": {"dims": [32, 32], "skip_in": [], "multires": 2, "feature_vector_size": 32,
                             "number_person": 1},
        "rendering_network": {"dims": [32], "feature_vector_size": 32},
        "bg_implicit_network": {"dims": [32, 32], "multires": 2, "feature_vector_size": 32},
        "bg_rendering_network": {"dims": [16], "feature_vector_size": 32},
        "ray_sampler": {"N_samples": 8, "N_samples_eval": 16, "N_samples_extra": 4, "beta_iters": 3,
                        "max_total_iters": 2, "N_samples_inverse_sphere": 4},
        "dim_frame_encoding": 8, "depth_epoch": [], "cano_grid_res": 12, "cano_mesh_res_up": 0,
        "num_training_frames": P1_FRAMES, "it_per_loop": 2, "depth_render_rays": 32, "depth_pixel_samples": 96,
        "interp_samples": 48, "mesh_pad_bucket": 1024,
    },
    "dataset": {"train": {"num_sample": P1_RAYS, "end_frame": P1_FRAMES, "num_person": 1,
                          "height": P1_HW[0], "width": P1_HW[1]}},
}


@pytest.fixture
def jax_knn(monkeypatch):
    import multiply_tpu.ops.knn_pallas as kp

    monkeypatch.setattr(kp, "knn_auto", knn_direct)


def make_pair(run_dir, conf_path, overrides, num_persons, frames, hw, rays):
    """(JAX trainer, port trainer) over one scene and run directory, the JAX
    weights jittered and carried into the port with the per-person state."""
    from train import build_servers as jax_build_servers

    import multiply_tpu.ops.knn_pallas as kp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kp, "knn_auto", knn_direct)
        # one compiled init instead of an eager op-by-op one (as `tiny_program`)
        init = JaxRenderer.init_params
        mp.setattr(JaxRenderer, "init_params", lambda self, key: jax.jit(lambda k: init(self, k))(key))
        jconf = jax_load_config(conf_path, overrides=overrides)
        scene = jax_make_scene(num_frames=frames, num_persons=num_persons, height=hw[0], width=hw[1])
        jseq = JaxSequence(scene, num_sample=rays, run_dir=run_dir)
        jtr = j_trainer.Trainer(jconf, jseq, jax_build_servers(jconf, jseq), run_dir=run_dir,
                                segmenter=j_sam.PriorSegmenter())
        conf = load_config(conf_path, overrides=overrides)
        arrays = {f: getattr(scene, f) for f in SyntheticScene._fields if f != "servers"}
        seq = SyntheticSequence(SyntheticScene(servers=[], **arrays), num_sample=rays, run_dir=run_dir)
        tr = t_trainer.Trainer(conf, seq, cli_train.build_servers(conf, seq, "cpu"), run_dir=run_dir,
                               segmenter=t_sam.PriorSegmenter(), device="cpu")
        assert tr.num_person == jtr.num_person == num_persons
        rng = np.random.default_rng(11)
        net = jax.tree.map(lambda a: a + 0.03 * rng.standard_normal(a.shape).astype(np.float32),
                           npify(jtr.ts.params["net"]))
        jtr.ts = jtr.ts._replace(params={"net": jax.tree.map(jnp.asarray, net), "body": jtr.ts.params["body"]})
        convert.load_params(tr.ts.params(), npify(jtr.ts.params))  # raises on a leaf left over or missing
        tr.person_state = convert.person_state_from_jax(npify(jtr.person_state), device="cpu")
        tr.builder.state = tr.person_state
    return jtr, tr


@pytest.fixture(scope="module")
def p3(tmp_path_factory):
    return make_pair(str(tmp_path_factory.mktemp("p3")), P3_CONF, P3_OVERRIDES, 3, P3_FRAMES, P3_HW, P3_RAYS)


def body_tree(state):
    """An Adam state over the body table, under the name its leaves carry in
    the port (`body.<leaf>`)."""
    return state._replace(mu={"body": state.mu}, count={"body": state.count})


def record_steps(jtr, tr, mp):
    """Each step's logs, mode and gradients on both sides (JAX's from its Adam
    moments), the port handed the noise of the JAX trainer's key path for the
    coming epoch (with the interpenetration draw of a pose-only step)."""
    keys = list(jax.random.split(jtr.key, tr.num_frames + 1)[1:])
    rec = types.SimpleNamespace(jlogs=[], logs=[], jgrads=[], pgrads=[], modes=[], jmodes=[])
    calls = record_adam_grads(mp, t_train)
    jstep, step = jtr._step, tr.builder.step
    names = list(tr.ts.params())

    def jax_recorded(ts, batch, *args, **kw):
        before = npify(ts)  # the step donates `ts`
        ts, out = jstep(ts, batch, *args, **kw)
        after = npify(ts)
        rec.jgrads.append(adam_step_grads(names, [(before.opt_joint, after.opt_joint),
                                                  (body_tree(before.opt_pose), body_tree(after.opt_pose))]))
        rec.jlogs.append(npify(out))
        rec.jmodes.append(int(batch.mode))
        return ts, out

    def recorded(ts, batch, **kw):
        first = len(calls)
        ts, out = step(ts, batch, **kw)
        rec.logs.append({k: float(v) for k, v in out.items()})
        rec.modes.append(batch.mode)
        grads = {}  # a step calls Adam once per optimizer
        for call in calls[first:]:
            for k, g in call.items():
                grads[k] = grads.get(k, 0.0) + g
        rec.pgrads.append(grads)
        return ts, out

    def draw_noise(batch, pose_batch=None, generator=None):
        return jax_noise(keys.pop(0), jtr.renderer, batch.uv.shape[0], tr.person_state.server.verts_c.shape[1],
                         pose_verts=None if pose_batch is None else pose_batch.verts_c.shape[1],
                         interp_samples=tr.interp_samples)

    mp.setattr(jtr, "_step", jax_recorded)
    mp.setattr(tr.builder, "step", recorded)
    mp.setattr(tr.builder, "draw_noise", draw_noise)
    return rec


def run_epoch(jtr, tr, epoch):
    """One `train_epoch` on each side from JAX's parameters at `epoch`: the
    steps' losses and modes agree, and every parameter's change."""
    convert.load_params(tr.ts.params(), npify(jtr.ts.params))
    before = npify(jtr.ts.params)
    jtr.epoch = tr.epoch = epoch
    with pytest.MonkeyPatch.context() as mp:
        import multiply_tpu.ops.knn_pallas as kp

        mp.setattr(kp, "knn_auto", knn_direct)
        rec = record_steps(jtr, tr, mp)
        jout = jtr.train_epoch()
        out = tr.train_epoch()
    assert len(rec.logs) == len(rec.jlogs) == tr.num_frames
    assert rec.modes == rec.jmodes
    # the loss to 1e-4 (`tests/test_torch_trainer.py`); each term to 1e-3: the
    # inverse-CDF sampler's depths in empty space part by ~1e-4 relative, which
    # the opacity terms (bce, in-shape, SAM mask) see before their small weights
    for i, (got, want) in enumerate(zip(rec.logs, rec.jlogs)):
        assert set(want) <= set(got) | {"lr"}, set(want) - set(got)
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-4, err_msg=f"step {i}")
        for k in set(want) - {"lr"}:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-3, atol=1e-6, err_msg=f"step {i} {k}")
        assert got["update_skipped"] == 0.0
    for k in ("n_joint", "n_pose_only", "n_delayed_pose"):
        assert out[k] == jout[k], k
    assert_updates_match(tr, jtr, before, rec.jgrads, rec.pgrads)
    return rec


# ---------------------------------------------------------------------------
# pieces: the scene, the prompts and what reaches SAM's decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_persons", [1, 3])
def test_make_scene_matches_jax(num_persons):
    """The port's scene maker at P persons (`base_x = linspace(-0.5, 0.5, P)`)
    against JAX's: every array."""
    got = make_scene(num_frames=2, num_persons=num_persons, height=20, width=28, device="cpu")
    want = jax_make_scene(num_frames=2, num_persons=num_persons, height=20, width=28)
    for f in ("masks", "poses", "transl", "betas", "scale", "cam_pose", "intrinsics", "sam_logits"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.images, want.images)
    assert got.masks.shape[-1] == num_persons and all(got.masks[..., p].any() for p in range(num_persons))


def _three_overlapping(H=64, W=96, seed=0):
    """One frame of three overlapping bodies, person 0 in front of 1 in front
    of 2, each with its 27 keypoints on its own visible pixels: every prompt
    then holds 27 positives, 10 random negatives and 54 partner keypoints."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((3, H, W), bool)
    for p in range(3):
        masks[p, 8:56, 10 + 26 * p: 44 + 26 * p] = True
    masks[1] &= ~masks[0]
    masks[2] &= ~(masks[0] | masks[1])
    kps = np.zeros((3, 27, 2), np.float32)
    for p in range(3):
        ys, xs = np.nonzero(masks[p])
        pick = rng.choice(len(xs), 27, replace=False)
        kps[p] = np.stack([xs[pick], ys[pick]], -1)
    return masks, kps


class _Decoder:
    """Records what a predictor hands SAM's decoder; returns the mask input
    (zeros without one) as the next logits, so the chain goes on."""

    def __init__(self):
        self.calls = []

    def __call__(self, pts, lbl, m):
        pts, lbl = np.asarray(pts), np.asarray(lbl)
        m = None if m is None else np.asarray(m)
        self.calls.append((pts, lbl, m))
        return np.zeros((256, 256), np.float32) if m is None else m[None]


def _jax_predictor(decoder):
    pred = j_sam_model.SamPredictor.__new__(j_sam_model.SamPredictor)
    pred.params, pred._embed = None, None
    pred._decode = lambda params, emb, pts, lbl, m: (decoder(pts, lbl, m), None)

    def set_image(img):
        pred._orig_hw = img.shape[:2]
        pred._scale = j_sam_model.IMG_SIZE / max(img.shape[:2])

    pred.set_image = set_image
    return pred


def _port_predictor(decoder):
    pred = t_sam_model.SamPredictor.__new__(t_sam_model.SamPredictor)
    pred.model = types.SimpleNamespace(img_size=1024, decode=lambda emb, pts, lbl, m: (
        torch.as_tensor(decoder(pts.numpy(), lbl.numpy(), None if m is None else m.numpy())), None))
    pred.device, pred._embed = torch.device("cpu"), None

    def set_image(img):
        pred._orig_hw = img.shape[:2]
        pred._scale = pred.model.img_size / max(img.shape[:2])

    pred.set_image = set_image
    return pred


@pytest.mark.parametrize("num_persons", [1, 3])
def test_sam_prompts_and_decoder_inputs_match_jax(num_persons, tmp_path):
    """`build_sam_prompts` from the same generator, then the SAM stage
    (`SamSegmenter`, three chained predicts a person) with both packages'
    `SamPredictor` over a recording decoder: the padded points, labels and
    mask input of every call, element for element. At P = 3 each prompt
    passes `MAX_POINTS` (27 + 10 + 54 points and two box corners), so the
    corners are cut off; at P = 1 no partner adds a negative."""
    masks, kps = _three_overlapping()
    masks, kps = masks[:num_persons], kps[:num_persons]
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    theirs = j_masks.build_sam_prompts(masks, kps, rng_j)
    ours = t_masks.build_sam_prompts(masks, kps, rng_t)
    assert len(ours) == len(theirs) == num_persons
    for o, t in zip(ours, theirs):
        assert o.keys() == t.keys()
        for k in o:
            assert o[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(o[k], t[k], err_msg=k)
        assert (o["labels"] == 1).sum() == 27
        assert (o["labels"] == 0).sum() == (10 if num_persons == 1 else 10 + 54)
    assert len(ours[0]["points"]) + 2 > t_sam_model.MAX_POINTS or num_persons == 1

    img = np.zeros((*masks.shape[1:], 3), np.uint8)
    out, decoders = {}, {}
    for side, predictor, stage in (("jax", _jax_predictor, j_sam), ("port", _port_predictor, t_sam)):
        run_dir = str(tmp_path / side)
        os.makedirs(os.path.join(run_dir, "stage_instance_mask", "00050"))
        np.save(os.path.join(run_dir, "stage_instance_mask", "00050", "all_person_smpl_mask.npy"), masks[None])
        np.save(os.path.join(run_dir, "stage_instance_mask", "00050", "2d_keypoint.npy"), kps[None].astype(np.int32))
        decoders[side] = _Decoder()
        out[side] = stage.SamSegmenter(predictor(decoders[side]), [img])(50, run_dir=run_dir)
    calls, jcalls = decoders["port"].calls, decoders["jax"].calls
    assert len(calls) == len(jcalls) == 3 * num_persons
    for (pts, lbl, m), (jpts, jlbl, jm) in zip(calls, jcalls):
        assert pts.shape == (t_sam_model.MAX_POINTS, 2) and lbl.dtype == jlbl.dtype
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(lbl, jlbl)
        np.testing.assert_array_equal(m, jm)
        assert (2 in lbl) == (num_persons == 1)  # the box corners survive only at P = 1
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# three persons: synthetic_p3, one epoch of each mode and the stages
# ---------------------------------------------------------------------------

STAGE_FILES = ("stage_instance_mask/{epoch:05d}/all_person_smpl_mask.npy stage_instance_mask/{epoch:05d}/2d_keypoint.npy "
               "stage_sam_mask/{epoch:05d}/sam_opt_mask.npy")


def with_sam_masks(tr):
    """The SAM stage's files in the pair's run directory (both sequences read
    them), written by the port's stages unless a test wrote them already."""
    if not glob.glob(os.path.join(tr.run_dir, "stage_sam_mask", "*", "sam_opt_mask.npy")):
        tr.instance_mask_stage()
        tr.sam_stage()


def test_joint_epoch_at_three_persons_matches_jax(p3):
    """Epoch 25, after pose correction (24): every step joint."""
    jtr, tr = p3
    rec = run_epoch(jtr, tr, 25)
    assert rec.modes == [MODE_JOINT] * P3_FRAMES


def test_stages_at_three_persons_match_jax(p3):
    """Epoch 50's instance-mask and SAM stages from the same parameters: the
    files (F, 3, H, W) / (F, 3, 27, 2) / (F, 3, H, W), each person on some
    pixel; then the mesh refresh, both sides' grids."""
    jtr, tr = p3
    convert.load_params(tr.ts.params(), npify(jtr.ts.params))
    jtr.epoch = tr.epoch = 50
    got = {}
    for name, side in (("port", tr), ("jax", jtr)):  # one run directory: each side's files in turn
        side.instance_mask_stage()
        side.sam_stage()
        got[name] = {f: np.load(os.path.join(tr.run_dir, f)) for f in STAGE_FILES.format(epoch=50).split()}
    for f, v in got["port"].items():
        np.testing.assert_array_equal(v, got["jax"][f], err_msg=f)
    masks, kps, sam = got["port"].values()
    assert masks.shape == sam.shape == (P3_FRAMES, 3, *P3_HW) and kps.shape == (P3_FRAMES, 3, 27, 2)
    assert all(masks[:, p].any() for p in range(3))
    jtr.refresh_canonical_state()
    tr.refresh_canonical_state()
    np.testing.assert_allclose(tr.person_state.cano_grid["grid"].numpy(),
                               np.asarray(jtr.person_state.cano_grid["grid"]), atol=1e-5)


def test_pose_only_epoch_at_three_persons_matches_jax(p3):
    """Epoch 30 in the pose window with SAM masks from epoch 50's stage:
    `depth_end` off on both sides (the config turns it on, which leaves the
    window to opt_depth), so each step is pose-only with a `PoseLossBatch`
    of the three persons' meshes: the depth-order and interpenetration terms
    of the config's weights."""
    jtr, tr = p3
    with_sam_masks(tr)
    jtr.seq._refresh_sam()
    tr.seq._refresh_sam()
    jtr.depth_end = tr.depth_end = False
    try:
        rec = run_epoch(jtr, tr, 30)
    finally:
        jtr.depth_end = tr.depth_end = True
    assert rec.modes == [MODE_POSE_ONLY] * P3_FRAMES
    assert any(log["pose_depth_order_loss"] > 0 for log in rec.logs)
    assert all(np.isfinite(log["pose_interpenetration_loss"]) for log in rec.logs)


def test_opt_depth_frame_at_three_persons_matches_jax(p3, jax_knn, monkeypatch):
    """One `_opt_depth_frame` (the config's epoch-30 stage) with 2 iterations:
    the three meshes, every iteration's loss (depth order over the persons'
    pairs + interpenetration + render) and the body parameters' change."""
    jtr, tr = p3
    with_sam_masks(tr)
    jtr.seq._refresh_sam()
    tr.seq._refresh_sam()
    convert.load_params(tr.ts.params(), npify(jtr.ts.params))
    jtr.epoch = tr.epoch = 30
    meshes = {"jax": [], "port": []}
    for side, module in (("jax", j_trainer), ("port", t_trainer)):
        original = module.generate_mesh

        def recorded(*args, side=side, original=original, **kw):
            out = original(*args, **kw)
            meshes[side].append(out)
            return out

        monkeypatch.setattr(module, "generate_mesh", recorded)
    key, ks = jtr.key, []
    for _ in range(tr.it_per_loop):
        key, k = jax.random.split(key)
        ks.append(k)
    jvals, vals, jgrads = [], [], []
    jgrad = jtr._depth_grad_fn()
    body_names = [k for k in tr.ts.params() if k.startswith("body.")]

    def jax_recorded(*args):
        out = jgrad(*args)
        jvals.append(float(out[2]))
        jgrads.append(adam_step_grads(body_names, [(body_tree(npify(args[1])), body_tree(npify(out[1])))]))
        return out

    jtr._depth_grad = jax_recorded

    def draw_noise(batch, pose_batch=None, generator=None):
        k = ks.pop(0)
        noise = jax_noise(jax.random.fold_in(k, 3), jtr.renderer, batch.uv.shape[0],
                          tr.person_state.server.verts_c.shape[1])
        V = pose_batch.verts_c.shape[1]
        noise["interp_idx"] = [
            torch.tensor(np.asarray(jax.random.randint(jax.random.fold_in(k, p), (min(tr.interp_samples, V),), 0, V)))
            for p in range(tr.num_person)
        ]
        return noise

    monkeypatch.setattr(tr.builder, "draw_noise", draw_noise)
    depth_loss = tr._depth_loss

    def recorded_loss(*args, **kw):
        val, parts = depth_loss(*args, **kw)
        vals.append(float(val.detach()))
        return val, parts

    monkeypatch.setattr(tr, "_depth_loss", recorded_loss)
    pgrads = record_adam_grads(monkeypatch, t_trainer, prefix="body.")
    before = npify(jtr.ts.params)
    jtr._opt_depth_frame(0)
    tr._opt_depth_frame(0)
    assert len(meshes["port"]) == len(meshes["jax"]) == 3
    for (v, f), (jv, jf) in zip(meshes["port"], meshes["jax"]):
        np.testing.assert_array_equal(f, jf)
        # a vertex sits on a grid edge (0.2-0.3 m at res 8) at the ratio of the
        # SDF at its ends, so the nets' f32 rounding moves it by up to ~1e-5
        np.testing.assert_allclose(v, jv, atol=5e-5)
    assert len(vals) == len(jvals) == tr.it_per_loop
    np.testing.assert_allclose(vals, jvals, rtol=1e-4)
    assert_updates_match(tr, jtr, before, jgrads, pgrads, body_factor=1.0)


# ---------------------------------------------------------------------------
# one person: the counterpart of tests/test_single_person.py
# ---------------------------------------------------------------------------


def test_single_person_training_and_stages_match_jax(tmp_path):
    """`tests/test_single_person.py`'s program at P = 1 on both sides: the
    first epoch held to JAX's within a tenth of an Adam step, then the
    instance-mask and SAM stages (files equal, (F, 1, H, W)), prompts without
    partners; then the port's mesh refresh and one opt_depth frame, which
    JAX's test does not run (finite, the grid and the body moved)."""
    jtr, tr = make_pair(str(tmp_path), P1_CONF, P1_OVERRIDES, 1, P1_FRAMES, P1_HW, P1_RAYS)
    rec = run_epoch(jtr, tr, 0)
    assert all(np.isfinite(log["loss"]) for log in rec.logs)

    got = {}
    for name, side in (("port", tr), ("jax", jtr)):  # one run directory: each side's files in turn
        side.instance_mask_stage()
        side.sam_stage()
        got[name] = {f: np.load(os.path.join(tr.run_dir, f)) for f in STAGE_FILES.format(epoch=0).split()}
    for f, v in got["port"].items():
        np.testing.assert_array_equal(v, got["jax"][f], err_msg=f)
    masks, kps, sam = got["port"].values()
    assert masks.shape == sam.shape == (P1_FRAMES, 1, *P1_HW) and masks.any()
    prompts = t_masks.build_sam_prompts(masks[0], kps[0], np.random.default_rng(0))
    assert len(prompts) == 1 and (prompts[0]["labels"] == 1).sum() >= 1
    assert (prompts[0]["labels"] == 0).sum() == 10  # no partner negatives

    grid = tr.person_state.cano_grid["grid"].clone()
    tr.refresh_canonical_state()
    assert not torch.equal(grid, tr.person_state.cano_grid["grid"])
    tr.seq._refresh_sam()
    transl = tr.ts.body.transl.detach().clone()
    tr.epoch = 1
    tr._opt_depth_frame(0)
    assert torch.isfinite(tr.ts.body.transl).all() and not torch.equal(transl, tr.ts.body.transl.detach())


# ---------------------------------------------------------------------------
# the entries on confs/synthetic_p3.yaml
# ---------------------------------------------------------------------------


def test_train_and_test_entries_on_synthetic_p3(tmp_path):
    """`cli/train.py` reads the person count from `dataset.train` (3 here, as
    JAX's entry does), trains epoch 0 with its stages, and `cli/test.py`
    renders one frame of the three persons; the port alone, at the cuts above
    and narrower nets."""
    sets = ("model.sampler_bf16=False", "model.cano_grid_res=8", "model.cano_mesh_res_up=0",
            "model.implicit_network.dims=[32,32]", "model.implicit_network.skip_in=[]",
            "model.rendering_network.dims=[32]", "model.bg_implicit_network.dims=[32,32]",
            f"dataset.train.num_sample={P3_RAYS}", f"dataset.train.end_frame={P3_FRAMES}",
            f"dataset.train.height={P3_HW[0]}", f"dataset.train.width={P3_HW[1]}",
            f"model.num_training_frames={P3_FRAMES}", "dataset.valid.pixel_per_batch=256",
            "dataset.test.pixel_per_batch=256")
    argv = ["--conf", P3_CONF, "--run_dir", str(tmp_path), "--device", "cpu", "--max_epochs", "1",
            *(f"--set={s}" for s in sets)]
    tr, conf, _ = cli_train.build_trainer(cli_train.parse_args(argv))
    assert tr.num_person == 3 and tr.renderer.P == 3 and conf.model.implicit_network.number_person == 3
    assert isinstance(tr.segmenter, t_sam.PriorSegmenter)
    cli_train.main(argv)
    masks = np.load(os.path.join(tmp_path, "stage_instance_mask", "00000", "all_person_smpl_mask.npy"))
    assert masks.shape == (P3_FRAMES, 3, *P3_HW)
    for p in range(3):
        assert os.path.exists(os.path.join(tmp_path, "val", f"epoch_00000_person_{p}.ply"))
    cli_test.main(["--conf", P3_CONF, "--run_dir", str(tmp_path), "--device", "cpu", "--frames", "1",
                   *(f"--set={s}" for s in sets)])
    assert glob.glob(os.path.join(tmp_path, "test", "**", "*.png"), recursive=True)
