"""Three defects of the JAX package that the port repairs in its own code:
the SAM pickup published field by field, the pose-only window written twice,
and `--set` arguments without a value. Each result stays the JAX package's
wherever that one is defined."""

import itertools
import os
import threading
import types

import numpy as np
import pytest

from multiply_tpu_torch.cli.train import parse_overrides
from multiply_tpu_torch.data.synthetic import make_scene
from multiply_tpu_torch.data.synthetic_sequence import SyntheticSequence
from multiply_tpu_torch.engine.train import MODE_DELAYED_POSE, MODE_JOINT, MODE_POSE_ONLY
from multiply_tpu_torch.engine.trainer import Trainer
from multiply_tpu_torch.utils.io import atomic_np_save

F, P, H, W = 4, 2, 12, 16


def publish(run_dir: str, k: int) -> None:
    """Stage files of epoch k whose masks and certainty both encode k: frame
    0's person 0 covers k % (H W) + 1 pixels, every instance mask the frame."""
    sam = np.full((F, P, H, W), -1.0, np.float32)
    sam[0, 0].reshape(-1)[: k % (H * W) + 1] = 1.0
    for stage, name, arr in (("stage_instance_mask", "all_person_smpl_mask.npy", np.ones((F, P, H, W), bool)),
                             ("stage_sam_mask", "sam_opt_mask.npy", sam)):
        d = os.path.join(run_dir, stage, f"{k:05d}")
        os.makedirs(d, exist_ok=True)
        atomic_np_save(os.path.join(d, name), arr)


def consistent(pickup) -> bool:
    """The pickup's masks and certainty come from one epoch's files."""
    if pickup.masks is None:
        return bool(np.all(pickup.iou == 1.0))
    covered = int((pickup.masks[0, :, :, 0] > 0).sum())
    return covered == round(float(pickup.iou[0]) * P * H * W)


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_frames=F, num_persons=P, height=H, width=W, device="cpu")


def test_sam_pickup_readers_never_pair_new_masks_with_old_certainty(scene, tmp_path):
    """Eight reader threads against one publisher that picks up 60 epochs of
    stage files: every snapshot a reader takes, through `sam_pickup` or
    through a training item's certainty beside its masks, is one epoch's."""
    seq = SyntheticSequence(scene, num_sample=16, using_sam=False, run_dir=str(tmp_path))
    epochs = 60
    for k in range(epochs):  # files first, so that the publisher's loop only reads and publishes
        publish(str(tmp_path), k)
    stop, bad, seen = threading.Event(), [], set()

    def reader():
        while not stop.is_set():
            pickup = seq.sam_pickup
            if not consistent(pickup):
                bad.append(pickup.path)
            seen.add(pickup.path)

    def publisher():
        from multiply_tpu_torch.data import dataset

        real = dataset.latest_stage_file
        try:
            for k in range(epochs):  # each epoch's files become the latest in turn
                dataset.latest_stage_file = lambda run_dir, stage, name, k=k: os.path.join(
                    run_dir, stage, f"{k:05d}", name)
                seq._refresh_sam()
        finally:
            dataset.latest_stage_file = real

    readers = [threading.Thread(target=reader) for _ in range(8)]
    for t in readers:
        t.start()
    publisher()
    stop.set()
    for t in readers:
        t.join()
    assert not bad, f"inconsistent pickups: {bad[:5]}"
    assert seq.sam_pickup.path.endswith(f"{epochs - 1:05d}/sam_opt_mask.npy")
    assert len(seen) > 1
    # the old names read the one tuple; setting one replaces the tuple whole
    assert seq._sam_masks is seq.sam_pickup.masks and seq.smpl_sam_iou is seq.sam_pickup.iou
    before = seq.sam_pickup
    seq.uncertain_threshold = 0.5
    assert seq.sam_pickup is not before and seq.sam_pickup.masks is before.masks
    assert seq.sam_pickup.threshold == 0.5


def test_training_item_reads_one_pickup(scene, tmp_path):
    """A training item's certainty and masks are those of the pickup in
    force: the certainty flag against its threshold, the sampled mask logits
    from its masks."""
    seq = SyntheticSequence(scene, num_sample=32, using_sam=True, run_dir=str(tmp_path))
    publish(str(tmp_path), 7)
    item = seq.get_train_item(0, np.random.default_rng(0))
    pickup = seq.sam_pickup
    assert pickup.path.endswith("00007/sam_opt_mask.npy") and consistent(pickup)
    assert item["is_certain"] == bool(pickup.iou[0] >= pickup.threshold)
    assert set(np.unique(item["sam_mask"])) <= {-1.0, 1.0}


def schedule(epoch, start, interval, opt_epoch, end, depth_end, using_sam):
    return types.SimpleNamespace(epoch=epoch, pose_start_epoch=start, pose_opt_interval=interval,
                                 pose_opt_epoch=opt_epoch, pose_end_epoch=end, depth_end=depth_end,
                                 using_sam=using_sam, pose_correction_epoch=100)


SCHEDULES = list(itertools.product((0, 60, 200), (1, 10, 7), (1, 3), (160, 1000), (False, True), (True, False)))


@pytest.mark.parametrize("start,interval,opt_epoch,end,depth_end,using_sam", SCHEDULES[::3])
def test_pose_window_is_select_modes_pose_only_condition(start, interval, opt_epoch, end, depth_end, using_sam):
    """Over epochs 0-240 of each schedule: the producer's `_pose_window` holds
    exactly when `_select_mode` gives a pose-only step to a frame with SAM
    masks, and every mode is the one the JAX package's rule gives."""
    for epoch in range(241):
        tr = schedule(epoch, start, interval, opt_epoch, end, depth_end, using_sam)
        tr._pose_epoch = types.MethodType(Trainer._pose_epoch, tr)
        window = Trainer._pose_window(tr)
        modes = {(c, s): Trainer._select_mode(tr, c, s) for c in (True, False) for s in (True, False)}
        assert window == (modes[(True, True)] == MODE_POSE_ONLY) == (modes[(False, True)] == MODE_POSE_ONLY)
        pose = (using_sam and epoch >= start and epoch % interval < opt_epoch and epoch < end and not depth_end)
        for (certain, has_sam), mode in modes.items():
            want = MODE_JOINT
            if using_sam:
                if pose and has_sam:
                    want = MODE_POSE_ONLY
                elif epoch < 100 and not certain:
                    want = MODE_DELAYED_POSE
            assert mode == want, (epoch, certain, has_sam)


@pytest.mark.parametrize("arg,words", [
    ("model.stage_overlap", "expected key.path=value"),
    ("model..learning_rate=1", "empty part"),
    ("=3", "empty part"),
    ("model.loss=1|model.loss.sam_start_epoch=5", "not a mapping"),
])
def test_set_arguments_that_cannot_be_read_raise_naming_them(arg, words):
    args = arg.split("|")
    with pytest.raises(ValueError, match=words) as err:
        parse_overrides(args)
    assert repr(args[-1]) in str(err.value)


def test_set_arguments_still_parse_as_before():
    assert parse_overrides(["model.loss.sam_start_epoch=40", "model.depth_epoch=[20]", "seed=3", "a.b=",
                            "model.loss.rgb_weight=0.5", "x=a=b"]) == {
        "model": {"loss": {"sam_start_epoch": 40, "rgb_weight": 0.5}, "depth_epoch": [20]}, "seed": 3,
        "a": {"b": None}, "x": "a=b"}
