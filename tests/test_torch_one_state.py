"""`multiply_tpu_torch/examples/one_state.py` on the CPU at tiny widths: a
long-run state captured after a segment, restored into new trainers, and
the step and every stage run from it on two devices. On the card the devices
are the card and the CPU (`chip_smoke.py` path L); here both are the CPU, so
every gap is exactly 0, and a planted fault must show."""

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from multiply_tpu_torch.engine.train import MODE_POSE_ONLY
from multiply_tpu_torch.examples import longrun_synthetic, one_state
from test_torch_examples_runs import NARROW, SCHEDULE, narrow


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """The compressed long run (tiny widths, 2 frames, epochs 0-3 in
    segments of 2, from the corrupted start), captured after its second
    segment: SAM masks picked up, a pose-opt epoch behind it."""
    d = tmp_path_factory.mktemp("one_state")
    args = longrun_synthetic.parse_args(["--epochs", "4", "--segment", "2", "--corrupt_masks", "--pose_noise", "0.05",
                                         "--segmenter", "color", "--device", "cpu", "--run_dir", str(d / "run"),
                                         "--out", str(d / "RUNLOG.md")])
    conf = narrow(longrun_synthetic.build_conf(args), NARROW + ("dataset.train.end_frame=2", "model.it_per_loop=1")
                  + SCHEDULE)
    states = {}
    longrun_synthetic.run(conf, args, on_segment=lambda tr, row: states.update(
        {row["epoch"]: (one_state.capture(tr), tr.seq.scene)}))
    state, scene = states[4]
    return conf, scene, state, d


def test_capture_restores_the_trainer(captured):
    conf, scene, state, d = captured
    tr = one_state.build_trainer(conf, scene, "cpu", str(d / "restored"))
    one_state.restore(tr, state)
    again = one_state.capture(tr)
    assert again["epoch"] == state["epoch"] == 4
    for k, v in state["params"].items():
        assert torch.equal(again["params"][k], v), k
    for which in ("opt_joint", "opt_pose"):
        for part in ("mu", "nu", "count"):
            for k, v in state[which][part].items():
                w = again[which][part][k]
                assert (torch.equal(w, v) if torch.is_tensor(v) else w == v), (which, part, k)
    for k, v in state["cano_grid"].items():
        assert torch.equal(again["cano_grid"][k], v), k
    assert again["rng"] == state["rng"]
    assert state["pickup"]["masks"] is not None
    np.testing.assert_array_equal(again["pickup"]["masks"], state["pickup"]["masks"])
    np.testing.assert_array_equal(again["pickup"]["iou"], state["pickup"]["iou"])
    assert sorted(again["files"]) == sorted(state["files"]) and len(state["files"]) >= 3
    # the restored sequence reads the restored files and nothing newer
    tr.seq._refresh_sam()
    assert tr.seq.sam_pickup.path.endswith("sam_opt_mask.npy")
    np.testing.assert_array_equal(tr.seq._sam_masks, state["pickup"]["masks"])


def test_host_noise_is_the_trainers_draw_from_a_cpu_generator(captured):
    conf, scene, state, d = captured
    tr = one_state.build_trainer(conf, scene, "cpu", str(d / "noise"))
    one_state.restore(tr, state)
    item = tr.seq.get_train_item(0, np.random.default_rng(1))
    batch = tr.make_batch(item, MODE_POSE_ONLY)
    pose_batch = tr.pose_loss_batch(0, np.random.default_rng(2), params=tr._params_snapshot())
    got = one_state.host_noise(tr.builder, batch.uv.shape[0], pose_batch, torch.Generator().manual_seed(5), "cpu")
    want = tr.builder.draw_noise(batch, pose_batch, torch.Generator().manual_seed(5))
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(*(x if isinstance(x, list) else [x] for x in (got[k], want[k]))):
            assert torch.equal(g, w), k


def test_two_devices_from_one_state_agree(captured):
    """Both "devices" the CPU: every check runs, every gap is 0, no problem."""
    conf, scene, state, d = captured
    gaps = one_state.compare_devices(conf, scene, state, ("cpu", "cpu:0"), str(d / "check"))
    assert one_state.problems(gaps) == []
    # the long run's sampler is bfloat16: each step also runs with it in f32
    for name in ("joint_step", "pose_step", "opt_depth", "joint_step_bf16", "pose_step_bf16", "opt_depth_bf16"):
        g = gaps[name]["cpu"]
        assert g["grads"] and max(g["grads"].values()) == 0.0 and max(g["terms"].values()) == 0.0, name
        assert g["finite"], name
    mesh = gaps["mesh_refresh"]["cpu"]
    assert mesh["same_faces"] and mesh["vertex_gap"] == 0.0 and mesh["bake_gap"] == 0.0, mesh
    assert gaps["instance_mask"]["cpu"] == {"pixels": 0, "off_edge": 0, "keypoint_px": 0.0}
    assert gaps["sam"]["cpu"] == {"abs": 0.0}
    assert "epoch 4" in one_state.summary(gaps)


def test_a_planted_gap_is_a_problem(captured):
    """A state whose parameters part by a step on one device: the check names
    the step's gradients and the stages that read them."""
    conf, scene, state, d = captured
    real = one_state.restore

    def restore_shifted(tr, st):
        real(tr, st)
        if tr.device == torch.device("cpu") and tr.run_dir.endswith("cpu"):
            with torch.no_grad():
                tr.ts.params()["body.transl"].add_(0.01)

    one_state.restore = restore_shifted
    try:
        gaps = one_state.compare_devices(conf, scene, state, ("cpu", "cpu:0"), str(d / "planted"),
                                         checks=("joint_step", "instance_mask", "opt_depth"))
    finally:
        one_state.restore = real
    found = one_state.problems(gaps)
    assert any(p.startswith("joint_step") for p in found), found
    assert any(p.startswith("opt_depth") for p in found), found
    assert any(p.startswith("keypoints") for p in found), found
    assert "mesh_refresh" not in gaps and "pose_step" not in gaps and "sam" not in gaps


@pytest.mark.parametrize("masks,edge", [
    ([[0, 0, 0], [0, 1, 0], [0, 0, 0]], [[0, 1, 0], [1, 1, 1], [0, 1, 0]]),
    ([[1, 1, 1], [1, 1, 1], [1, 1, 1]], [[0, 0, 0], [0, 0, 0], [0, 0, 0]]),
    ([[1, 1, 0], [1, 1, 0], [0, 0, 0]], [[0, 1, 1], [1, 1, 1], [1, 1, 0]]),
])
def test_mask_edge(masks, edge):
    np.testing.assert_array_equal(one_state.mask_edge(np.asarray(masks, bool)), np.asarray(edge, bool))
