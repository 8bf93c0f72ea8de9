"""The SAM stage of the port against the JAX package's, on the CPU:
`build_sam_prompts` (the same prompts from the same generator),
`ColorPromptPredictor`, `SamPredictor` (`set_image`, three chained
`predict`s, `logits_to_full_res`) and `SamSegmenter` end to end with either
predictor, compared on the `sam_opt_mask.npy` each side writes.

The SAM weights are one random official state dict (`vit_test`, 128-pixel
input; the JAX package's `IMG_SIZE` is patched to match while its side runs),
loaded by the JAX package's `port_torch_checkpoint` and by the port's strict
loader.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
import _torch_sam as oracle
import multiply_tpu.engine.instance_masks as jim
import multiply_tpu.engine.sam_stage as jstage
import multiply_tpu.models.sam as jsam
from multiply_tpu_torch.engine import instance_masks as tim
from multiply_tpu_torch.engine import sam_stage as tstage
from multiply_tpu_torch.models import sam as tsam

IMG = 128


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(JAX predictor, port predictor) with the same weights; the JAX one is
    used only inside `jax_size()`."""
    sd = oracle.make_state_dict(jsam.VIT_CONFIGS["vit_test"], IMG, seed=0)
    path = str(tmp_path_factory.mktemp("sam") / "vit_test.pth")
    torch.save(sd, path)
    with jax_size():
        theirs = jsam.SamPredictor(jsam.Sam(variant="vit_test"), jsam.port_torch_checkpoint(path, "vit_test"))
    model = tsam.Sam("vit_test", img_size=IMG)
    model.load_state_dict(sd, strict=True)
    return theirs, tsam.SamPredictor(model)


@contextlib.contextmanager
def jax_size():
    """The JAX package's SAM at the test's input size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam, "IMG_SIZE", IMG)
        yield


def scene(F=2, P=2, H=48, W=64, seed=0, empty=False):
    """Instance masks (F, P, H, W) and keypoints (F, P, 27, 2) of two
    overlapping bodies; with `empty`, person 1 is missing in frame 0."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((F, P, H, W), bool)
    kps = np.zeros((F, P, 27, 2), np.float32)
    for f in range(F):
        for p in range(P):
            y0, x0 = int(rng.integers(2, H // 3)), int(rng.integers(2 + p * W // 3, W // 3 + p * W // 3))
            y1, x1 = min(H, y0 + int(rng.integers(H // 3, H // 2))), min(W, x0 + int(rng.integers(W // 4, W // 2)))
            masks[f, p, y0:y1, x0:x1] = True
            kps[f, p] = rng.uniform([x0 - 3, y0 - 3], [x1 + 3, y1 + 3], (27, 2))
        masks[f, 1] &= ~masks[f, 0]  # person 0 is in front
    if empty:
        masks[0, 1] = False
    return masks, kps


@pytest.mark.parametrize("kind", ["overlapping", "empty person", "large frame"])
def test_build_sam_prompts_matches_jax(kind):
    masks, kps = scene(**{"overlapping": {}, "empty person": {"empty": True},
                          "large frame": {"H": 270, "W": 360, "seed": 3}}[kind])
    for f in range(masks.shape[0]):
        rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
        theirs = jim.build_sam_prompts(masks[f], kps[f], rng_j)
        ours = tim.build_sam_prompts(masks[f], kps[f], rng_t)
        assert len(ours) == len(theirs)
        for o, t in zip(ours, theirs):
            assert o.keys() == t.keys()
            for k in o:
                assert o[k].dtype == t[k].dtype, k
                np.testing.assert_array_equal(o[k], t[k], err_msg=k)
        assert rng_j.integers(0, 2**31) == rng_t.integers(0, 2**31)


def test_color_prompt_predictor_matches_jax():
    rng = np.random.default_rng(4)
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    prior_low = (rng.standard_normal((256, 256)) * 6).astype(np.float32)
    prior_full = (rng.standard_normal((48, 64)) * 6).astype(np.float32)
    cases = [
        (np.array([[10, 12], [40, 30], [5, 5]]), np.array([1, 1, 0]), np.array([2.0, 3.0, 50.0, 40.0]), prior_low),
        (np.array([[10, 12], [40, 30]]), np.array([1, 1]), None, prior_full),
        (np.array([[10, 12]]), np.array([0]), None, None),
        (np.array([[63, 47], [0, 0]]), np.array([1, 0]), np.array([-3.0, 4.0, 70.0, 60.0]), None),
    ]
    theirs, ours = jstage.ColorPromptPredictor(), tstage.ColorPromptPredictor()
    theirs.set_image(img)
    ours.set_image(img)
    for pts, lbl, box, prior in cases:
        t = theirs.predict(pts, lbl, box, prior)
        o = ours.predict(pts, lbl, box, prior)
        assert o.dtype == t.dtype and o.shape == t.shape
        np.testing.assert_allclose(o, t, atol=1e-5, rtol=1e-5)


def test_sam_predictor_chain_matches_jax(predictors):
    """set_image on a 100x150 frame (resized to 85x128, padded), three chained
    predicts from a 256x256 prior (resized to the decoder's 32x32), then
    `logits_to_full_res`; and one prompt of more than 64 points, whose box
    corners are cut off."""
    theirs, ours = predictors
    rng = np.random.default_rng(5)
    img = (rng.random((100, 150, 3)) * 255).astype(np.uint8)
    pts = rng.uniform(0, 100, (6, 2)).astype(np.float32)
    lbl = np.array([1, 1, 1, 0, 0, 0])
    box = np.array([10.0, 5.0, 120.0, 90.0], np.float32)
    prior = (rng.standard_normal((256, 256)) * 8).astype(np.float32)
    many = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    with jax_size():
        theirs.set_image(img)
        t_logits, t_out = prior, []
        for _ in range(3):
            t_logits = theirs.predict(pts, lbl, box, t_logits)
            t_out.append(t_logits)
        t_full = theirs.logits_to_full_res(t_logits)
        t_many = theirs.predict(many, np.ones(70, np.int32), box, None)
    ours.set_image(img)
    o_logits, o_out = prior, []
    for _ in range(3):
        o_logits = ours.predict(pts, lbl, box, o_logits)
        o_out.append(o_logits)
    o_full = ours.logits_to_full_res(o_logits)
    o_many = ours.predict(many, np.ones(70, np.int32), box, None)
    assert ours._embed.shape == (IMG // 16, IMG // 16, 256)
    assert o_full.shape == (100, 150) and o_out[0].shape == (IMG // 4, IMG // 4)
    for o, t in zip(o_out + [o_full, o_many], t_out + [t_full, t_many]):
        np.testing.assert_allclose(o, np.asarray(t), atol=2e-3, rtol=2e-3)


def _stage_files(run_dir, masks, kps, epoch=0):
    stage = os.path.join(run_dir, "stage_instance_mask", f"{epoch:05d}")
    os.makedirs(stage, exist_ok=True)
    np.save(os.path.join(stage, "all_person_smpl_mask.npy"), masks)
    np.save(os.path.join(stage, "2d_keypoint.npy"), kps)


@pytest.mark.parametrize("backend", ["sam", "color"])
def test_sam_segmenter_end_to_end_matches_jax(predictors, backend, tmp_path):
    """Both stages from the same stage files and frames; each writes
    stage_sam_mask/00000/sam_opt_mask.npy (F, P, H, W)."""
    masks, kps = scene(empty=True)
    rng = np.random.default_rng(6)
    images = [(rng.random((48, 64, 3)) * 255).astype(np.uint8) for _ in range(masks.shape[0])]
    out = {}
    for side in ("jax", "port"):
        run_dir = str(tmp_path / side)
        _stage_files(run_dir, masks, kps)
        if backend == "sam":
            predictor = predictors[0] if side == "jax" else predictors[1]
        else:
            predictor = (jstage if side == "jax" else tstage).ColorPromptPredictor()
        frames = [lambda im=im: im for im in images] if side == "port" else images  # callables too
        seg = (jstage if side == "jax" else tstage).SamSegmenter(predictor, frames)
        if side == "jax":
            with jax_size():
                seg(0, run_dir=run_dir)
        else:
            seg(0, run_dir=run_dir)
        out[side] = np.load(os.path.join(run_dir, "stage_sam_mask", "00000", "sam_opt_mask.npy"))
    assert out["port"].shape == masks.shape and out["port"].dtype == np.float32
    assert np.isfinite(out["port"]).all()
    np.testing.assert_allclose(out["port"], out["jax"], atol=2e-3, rtol=2e-3)
