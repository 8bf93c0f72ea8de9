"""The port's trainer-driven example drivers run on the CPU at tiny widths:
`longrun_synthetic.run` from the corrupted start with its schedule compressed
(it crosses a mask stage, a delayed-pose epoch, a pose-opt epoch and the
final opt_depth), `optdepth_demo` on that run's directory, and
`mask_refinement_demo`, whose certainty ranking must flag the corrupted
frames. Port only, apart from the JAX drivers' helpers and row keys, read
from their files; the repository's own runlogs must stay as they were.
"""

import ast
import glob
import hashlib
import json
import math
import os

import numpy as np
import pytest

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from multiply_tpu_torch.cli.train import parse_overrides
from multiply_tpu_torch.config import Config
from multiply_tpu_torch.data.synthetic import make_scene
from multiply_tpu_torch.examples import longrun_synthetic, mask_refinement_demo, optdepth_demo
from test_torch_examples import ROOT, jax_driver
from test_torch_fit import TINY

# TINY's widths, sampler and pose/depth sizes; the drivers set frames, schedule and depth epochs
NARROW = tuple(s for s in TINY if not s.startswith(
    ("model.depth_epoch", "model.num_training_frames", "dataset.train.end_frame")))
# 2 frames and one opt_depth iteration a frame for the long run and its demo
SHORT = ("dataset.train.end_frame=2", "model.it_per_loop=1")
# the long run's schedule compressed to 4 epochs in segments of 2: epoch 0's
# stages, a delayed-pose epoch 1, a pose-opt epoch 2 (the stages again), then
# joint epochs past the pose-correction epoch 3
SCHEDULE = ("model.pose_correction_epoch=3", "model.pose_start_epoch=2", "model.pose_end_epoch=4",
            "model.pose_opt_interval=2", "model.loss.sam_start_epoch=1")
REPO_RECORDS = ("RUNLOG.md", "RUNLOG_CORRUPT.md", "docs/runlog*/*")


def narrow(conf, sets):
    data = conf.to_dict()

    def update(node, over):
        for k, v in over.items():
            if isinstance(v, dict) and isinstance(node.get(k), dict):
                update(node[k], v)
            else:
                node[k] = v

    update(data, parse_overrides(list(sets)))
    return Config(data)


def records_digest():
    out = {}
    for pattern in REPO_RECORDS:
        for path in sorted(glob.glob(os.path.join(ROOT, pattern))):
            with open(path, "rb") as f:
                out[os.path.relpath(path, ROOT)] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three drivers, one after the other, into a temporary directory;
    the repository's runlogs hashed before and after."""
    before = records_digest()
    d = tmp_path_factory.mktemp("torch_examples")
    run_dir, out = str(d / "longrun"), str(d / "RUNLOG_CORRUPT.md")
    args = longrun_synthetic.parse_args(["--epochs", "4", "--segment", "2", "--corrupt_masks", "--pose_noise", "0.05",
                                         "--segmenter", "color", "--device", "cpu", "--run_dir", run_dir, "--out", out])
    conf = narrow(longrun_synthetic.build_conf(args), NARROW + SHORT + SCHEDULE)
    longrun = longrun_synthetic.run(conf, args)

    od_args = optdepth_demo.parse_args(["--run_dir", run_dir, "--out", str(d / "RUNLOG.md"), "--frames", "1",
                                        "--device", "cpu"])
    optdepth = optdepth_demo.run(narrow(optdepth_demo.build_conf(od_args), NARROW + SHORT), od_args)

    md_args = mask_refinement_demo.parse_args(["--epochs", "2", "--segment", "2", "--frames", "4", "--device", "cpu",
                                               "--run_dir", str(d / "maskdemo"), "--out", str(d / "RUNLOG_MASKS.md")])
    masks = mask_refinement_demo.run(narrow(mask_refinement_demo.build_conf(md_args), NARROW), md_args)
    return {"dir": d, "conf": conf, "longrun": longrun, "optdepth": optdepth, "masks": masks,
            "records": (before, records_digest())}


def metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_row_keys(name, var):
    """The keys of the dict literal that the JAX driver assigns to `var`."""
    tree = ast.parse(open(os.path.join(ROOT, "examples", f"{name}.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == var and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
    raise LookupError(var)


def test_longrun_crosses_every_stage_of_the_schedule(runs):
    d = runs["dir"]
    recs = [r for r in metrics(str(d / "longrun")) if "loss" in r]
    assert [r["epoch"] for r in recs] == [0, 1, 2, 3]
    assert all(math.isfinite(r["loss"]) and r["update_skipped"] == 0.0 for r in recs)
    assert [(r["n_joint"], r["n_delayed_pose"], r["n_pose_only"]) for r in recs] == [
        (2.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 0.0, 2.0), (2.0, 0.0, 0.0)]
    assert recs[2]["pose_depth_order_loss"] > 0 or recs[2]["pose_interpenetration_loss"] > 0
    for epoch in (0, 2):
        assert os.path.exists(d / "longrun" / "stage_sam_mask" / f"{epoch:05d}" / "sam_opt_mask.npy")
    # the final opt_depth pass: its depth maps at epoch 4, translations moved
    assert glob.glob(str(d / "longrun" / "stage_depth_map" / "00004" / "*" / "front" / "*.png"))
    lr = runs["longrun"]
    assert 0 < lr["transl_delta"] < 0.01 and math.isfinite(lr["psnr_after"])
    assert os.path.exists(d / "longrun" / "checkpoints" / "last")


def test_longrun_rows_and_start_are_the_jax_drivers(runs):
    lr = runs["longrun"]
    rows = lr["rows"]
    assert [r["epoch"] for r in rows] == [2, 4]
    assert all(list(r) == jax_row_keys("longrun_synthetic", "row") for r in rows)
    assert [r["n_delayed_pose"] for r in rows] == [1.0, 0.0]
    assert rows[0]["pose_depth_order_loss"] == 0.0 and rows[1]["certain"] == 1
    # the initial IoU: JAX's helpers on the same (narrowed) scene
    train = runs["conf"].dataset.train
    scene = make_scene(train.end_frame, 2, train.height, train.width, device="cpu")
    jax_lr = jax_driver("longrun_synthetic")
    assert lr["iou0"] == jax_lr.gt_iou(jax_lr.corrupt_sam_logits(scene, np.random.default_rng(0)), scene.masks)
    # the translation noise: JAX's numpy draw after a corruption that draws nothing
    assert lr["transl_err0"] == float(np.abs(np.random.default_rng(0).uniform(-0.05, 0.05, (2, 2, 3))
                                             .astype(np.float32)).max())


def test_longrun_writes_its_runlog_beside_out_and_leaves_the_repository_records(runs):
    d = runs["dir"]
    text = (d / "RUNLOG_CORRUPT.md").read_text()
    assert "**Corrupted start:**" in text and "| 4 |" in text
    assert "![first](runlog_corrupt/val_first.png)" in text and (d / "runlog_corrupt" / "val_last.png").exists()
    before, after = runs["records"]
    assert before and after == before


def test_optdepth_demo_on_the_long_run(runs):
    res = runs["optdepth"]
    with open(runs["dir"] / "longrun" / "optdepth_demo.json") as f:
        saved = json.load(f)
    assert list(saved) == ["err0", "err1", "rmse0", "rmse1", "psnr0", "psnr1", "wall_s"]
    assert all(math.isfinite(v) for v in saved.values())
    assert saved["err0"] <= 0.08 and saved["rmse1"] != saved["rmse0"]
    assert res["frames"] == 1 and saved == {k: res[k] for k in saved}
    assert "## opt_depth perturbation demo" in (runs["dir"] / "RUNLOG.md").read_text()


def test_mask_demo_flags_the_corrupted_frames(runs):
    res = runs["masks"]
    assert res["bad_frames"] == [2, 3]
    (row,) = res["rows"]
    assert list(row) == jax_row_keys("mask_refinement_demo", "row")
    assert row["uncertain"] == res["bad_frames"]
    assert row["n_delayed"] == 2 and math.isfinite(row["psnr"])
    assert (runs["dir"] / "RUNLOG_MASKS.md").exists()
