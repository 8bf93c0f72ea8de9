"""The port's example drivers (`multiply_tpu_torch/examples/`) against the JAX
drivers under `examples/`, on the CPU.

The JAX drivers are imported by file path (their top level imports only
argparse and numpy) and their helpers compared bit for bit with the port's
on the JAX package's scene and on the port's: the mask corruptions (OpenCV's
dilation there, `dilate_box` here), the IoUs and the split translation rmse.
The runlog writers give the same markdown with matplotlib hidden. Then the
minimal demo and the scaling curve run on the CPU at small sizes; the
trainer-driven drivers run in `test_torch_examples_runs.py`.
"""

import argparse
import ast
import importlib
import importlib.util
import math
import os
import sys
import types

import numpy as np
import pytest

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from multiply_tpu.data.synthetic import make_scene as jax_make_scene
from multiply_tpu_torch.data.synthetic import make_scene as torch_make_scene
from multiply_tpu_torch.examples import longrun_synthetic, mask_refinement_demo, optdepth_demo
from multiply_tpu_torch.utils.io import read_png, write_png

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DRIVERS = ("train_synthetic", "longrun_synthetic", "optdepth_demo", "mask_refinement_demo", "scaling_curve")


def jax_driver(name):
    """A JAX driver under `examples/`, imported by file path."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scenes():
    """The JAX package's scene and the port's, at the drivers' 4 frames of 48x64."""
    return {"jax": jax_make_scene(4, 2, 48, 64, cache_dir=None), "torch": torch_make_scene(4, 2, 48, 64, device="cpu")}


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_longrun_corruption_and_gt_iou_match_the_jax_driver(scenes, source):
    jax_lr = jax_driver("longrun_synthetic")
    scene = scenes[source]
    ours = longrun_synthetic.corrupt_sam_logits(scene, np.random.default_rng(0))
    theirs = jax_lr.corrupt_sam_logits(scene, np.random.default_rng(0))
    np.testing.assert_array_equal(ours, theirs)
    assert (ours != scene.sam_logits).any()
    iou = longrun_synthetic.gt_iou(ours, scene.masks)
    assert iou == jax_lr.gt_iou(theirs, scene.masks)
    assert round(iou, 3) == 0.566  # RUNLOG_CORRUPT.md's initial IoU
    assert longrun_synthetic.gt_iou(scene.sam_logits, scene.masks) == jax_lr.gt_iou(scene.sam_logits, scene.masks) == 1.0


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_mask_demo_corruption_and_supervision_iou_match_the_jax_driver(scenes, source):
    jax_md = jax_driver("mask_refinement_demo")
    scene = scenes[source]
    bad = [2, 3]
    ours = mask_refinement_demo.corrupt_sam_logits(scene, bad, np.random.default_rng(7))
    theirs = jax_md.corrupt_sam_logits(scene, bad, np.random.default_rng(7))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[:2], scene.sam_logits[:2])
    corrupted = scene._replace(sam_logits=ours)
    refined = np.where(np.random.default_rng(1).random(ours.shape) < 0.9, scene.sam_logits, -scene.sam_logits)
    for masks in (None, refined):
        seq = types.SimpleNamespace(_sam_masks=masks)
        assert mask_refinement_demo.supervision_iou(seq, corrupted) == jax_md.supervision_iou(seq, corrupted)


def test_split_rmse_is_the_jax_closure(scenes):
    """`split_rmse` against the formula of the JAX driver's closure, on the
    scene's camera axis and random errors."""
    fwd = np.asarray(scenes["torch"].cam_pose[0][:3, 2], np.float32)
    fwd = fwd / np.linalg.norm(fwd)
    e = np.random.default_rng(0).uniform(-0.08, 0.08, (2, 3, 3)).astype(np.float32)
    d = e @ fwd
    ip = e - d[..., None] * fwd
    closure = (float(np.sqrt(np.mean(d**2))), float(np.sqrt(np.mean(np.sum(ip**2, -1) / 2))))
    assert optdepth_demo.split_rmse(e, fwd) == closure
    tilted = np.array([0.6, 0.0, 0.8], np.float32)
    assert optdepth_demo.split_rmse(e, tilted)[0] != closure[0]


def longrun_rows(n=3):
    rows = []
    for i in range(n):
        rows.append({
            "epoch": 20 * (i + 1), "psnr": 17.5 + 0.3 * i if i != 1 else float("nan"), "mask_iou": 0.64 + 0.1 * i,
            "gt_iou": 0.75 + 0.1 * i, "certain": 2, "n_delayed_pose": 2.0 - i, "transl_rmse_cm": 3.1 - 0.01 * i,
            "loss": 0.066, "rgb_loss": 0.063, "sam_mask_loss": 0.1 * i, "pose_depth_order_loss": 27.67 * i,
            "pose_interpenetration_loss": 0.00176 * i, "wall_s": 10.0 * i,
        })
    return rows


def is_figure_line(line):
    return line.startswith("![") or line == "First vs last validation render (GT | prediction):"


@pytest.mark.parametrize("corrupt", [False, True])
def test_longrun_runlog_is_the_jax_drivers(tmp_path, monkeypatch, corrupt):
    """With matplotlib hidden, both write the same markdown, apart from the
    device the wall-clock line names; the port also
    copies the validation renders beside its runlog (and links them), the JAX
    driver's figures would go under docs/. Neither writes anything there."""
    jax_lr = jax_driver("longrun_synthetic")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    run_dir = tmp_path / "run"
    (run_dir / "val").mkdir(parents=True)
    for epoch in (0, 20):
        write_png(str(run_dir / "val" / f"epoch_{epoch:05d}.png"), np.full((4, 8, 3), epoch, np.uint8))
    args = argparse.Namespace(corrupt_masks=corrupt, pose_noise=0.05 if corrupt else 0.0,
                              device="cuda" if corrupt else "cpu")
    rows = longrun_rows()
    call = (rows, 17.9, 18.0, 0.0123, 600.0, str(run_dir))
    jax_lr.write_runlog(str(tmp_path / "jax.md"), None, *call, args=args)
    out = tmp_path / "out" / "RUNLOG_CORRUPT.md"
    longrun_synthetic.write_runlog(str(out), None, *call, args=args)
    theirs = (tmp_path / "jax.md").read_text().splitlines()
    ours = out.read_text().splitlines()
    # the same text with the run's device in place of the JAX driver's host CPU, then the figures' block
    # (after the JAX driver's own end)
    assert ours[: len(theirs)] == [line.replace("(single host CPU core,", f"(on {args.device},") for line in theirs]
    assert sum("single host CPU core" in line for line in theirs) == 1
    assert all(is_figure_line(line) or not line for line in ours[len(theirs):])
    assert [line for line in ours if line.startswith("![")] == ["![first](runlog_corrupt/val_first.png)",
                                                             "![last](runlog_corrupt/val_last.png)"]
    assert read_png(str(tmp_path / "out" / "runlog_corrupt" / "val_last.png"))[0, 0, 0] == 20
    assert not (tmp_path / "docs").exists()


def test_mask_demo_runlog_is_the_jax_drivers(tmp_path, monkeypatch, scenes):
    jax_md = jax_driver("mask_refinement_demo")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    rows = [{"epoch": 20 * (i + 1), "psnr": 17.0 + i, "sup_iou": 0.7 + 0.1 * i, "uncertain": [3, 4, 5][: 3 - i],
             "transl_rmse": 0.04 - 0.01 * i, "n_delayed": 60 - 20 * i, "n_pose_only": 6 * i, "wall_s": 5.0 * i}
            for i in range(3)]
    seq = types.SimpleNamespace(_sam_masks=None)
    call = (rows, 0.62, 0.047, [3, 4, 5], 300.0, str(tmp_path), seq, scenes["torch"])
    jax_md.write_runlog(str(tmp_path / "jax.md"), *call)
    mask_refinement_demo.write_runlog(str(tmp_path / "RUNLOG_MASKS.md"), *call)
    assert (tmp_path / "RUNLOG_MASKS.md").read_text() == (tmp_path / "jax.md").read_text()
    assert not (tmp_path / "docs").exists()


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_defaults_are_the_card_and_outputs_torch_examples(name):
    """`--device cuda` by default, and every default path under
    outputs/torch_examples/ (the JAX drivers' RUNLOG.md and docs/runlog*/
    are theirs); the minimal demo writes no file unless asked."""
    module = importlib.import_module(f"multiply_tpu_torch.examples.{name}")
    args = module.parse_args([])
    assert args.device == "cuda"
    paths = {k: getattr(args, k) for k in ("out", "run_dir") if hasattr(args, k)}
    if name == "train_synthetic":
        assert paths == {"out": ""}
    else:
        assert paths and all(p.startswith(os.path.join("outputs", "torch_examples") + os.sep) for p in paths.values())
    tree = ast.parse(open(os.path.join(ROOT, "examples", f"{name}.py")).read())
    jax_flags = {node.args[0].value[2:] for node in ast.walk(tree)
                 if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"}
    missing = jax_flags - {"platform", "cpu"} - set(vars(args))
    assert not missing, f"{name}: JAX flags without a counterpart: {missing}"


def test_train_synthetic_on_the_cpu(tmp_path):
    from multiply_tpu_torch.examples import train_synthetic

    out = tmp_path / "demo.png"
    res = train_synthetic.main(["--steps", "3", "--rays", "32", "--frames", "1", "--device", "cpu", "--out", str(out)])
    assert len(res["losses"]) == 3 and all(math.isfinite(v) for v in res["losses"])
    assert res["skipped"] == [0.0, 0.0, 0.0]
    assert math.isfinite(res["psnr"])
    assert read_png(str(out)).shape == (36, 96, 3)


def test_scaling_curve_on_cpu_ranks(tmp_path):
    """World sizes 1 and 2 as gloo ranks: finite losses, the same collectives
    in every step of every rank (3 all-reduces: counts, gradients, logged
    terms), and the first step's loss of 2 ranks the one-rank loss."""
    from multiply_tpu_torch.examples import scaling_curve

    rows = scaling_curve.main(["--device", "cpu", "--worlds", "1,2", "--iters", "1", "--rays", "64",
                               "--run_dir", str(tmp_path)])
    assert [r["world"] for r in rows] == [1, 2]
    for r in rows:
        assert all(math.isfinite(v) for v in r["losses"])
        assert r["collectives"] == 3, r["collectives_by_rank"]
        assert r["collectives_by_kind"] == {"all_reduce_sum": 6, "broadcast": 0, "all_gather": 0}
    assert len(rows[1]["collectives_by_rank"]) == 2
    np.testing.assert_allclose(rows[1]["losses"][0], rows[0]["losses"][0], rtol=1e-5)

def jax_overrides(name, args):
    """The JAX driver's `load_config(..., overrides=...)` dict, evaluated with `args`."""
    tree = ast.parse(open(os.path.join(ROOT, "examples", f"{name}.py")).read())
    call = next(node for node in ast.walk(tree) if isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "load_config")
    expr = next(k.value for k in call.keywords if k.arg == "overrides")
    return eval(compile(ast.Expression(expr), name, "eval"), {"args": args})


@pytest.mark.parametrize("name, argv", [
    ("longrun_synthetic", []), ("longrun_synthetic", ["--parity"]), ("longrun_synthetic", ["--bf16"]),
    ("optdepth_demo", ["--render_rays", "512"]), ("mask_refinement_demo", ["--frames", "4"]),
])
def test_build_conf_is_the_jax_drivers_overrides(name, argv):
    """`build_conf` composes `confs/synthetic_base.yaml` with the very
    overrides the JAX driver writes inline in its `main`."""
    from multiply_tpu_torch.config import load_config

    module = importlib.import_module(f"multiply_tpu_torch.examples.{name}")
    args = module.parse_args(argv)
    want = load_config(os.path.join(ROOT, "confs", "synthetic_base.yaml"), overrides=jax_overrides(name, args))
    assert module.build_conf(args).to_dict() == want.to_dict()
