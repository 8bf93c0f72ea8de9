"""The port's ViTPose against `transformers` and the JAX package's detector.

Tiny models (hidden 32, 2 layers, 64x48 crops) are built in `transformers`
with seeded non-trivial weights and written with `save_pretrained`, as
safetensors and as `pytorch_model.bin`. The same directory goes through
`multiply_tpu_torch` (its own reader, network and host processing) and
through `VitPoseForPoseEstimation` / `VitPoseImageProcessor`, which the JAX
package's `VitPoseDetector` wraps:

- heatmaps of both decoders, both weight formats, a non-default feature
  stage and LayerNorm epsilon: within 1e-5;
- `pixel_values` of boxes partly outside a noisy image at a non-default
  input size: within 1e-6;
- keypoints and scores of `post_process_pose_estimation`: within 1e-4 px;
- the whole detector and `trace.vitpose_keypoints` against the JAX package's
  on the same frames: within 1e-3 px;
- ViTPose+ (`num_experts` 2) raises in both.
"""

import copy

import numpy as np
import pytest
import torch
from transformers import VitPoseBackboneConfig, VitPoseConfig, VitPoseForPoseEstimation, VitPoseImageProcessor

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from multiply_tpu.preprocessing import trace as jtrace
from multiply_tpu.preprocessing import vitpose as jvitpose
from multiply_tpu_torch.models import vitpose as tmodel
from multiply_tpu_torch.preprocessing import trace as ttrace
from multiply_tpu_torch.preprocessing import vitpose as tvitpose
from multiply_tpu_torch.preprocessing import vitpose_processing as tproc
from multiply_tpu_torch.utils import hf_checkpoint
from test_preprocessing import make_trace_inputs

INPUT_HW = (64, 48)


def _hf_model(seed, simple=True, **backbone):
    """A tiny `VitPoseForPoseEstimation` with every parameter moved off its
    initial value (non-zero position embeddings, BatchNorm statistics)."""
    torch.manual_seed(seed)
    bb = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, image_size=list(INPUT_HW))
    bb.update(backbone)
    cfg = VitPoseConfig(backbone_config=VitPoseBackboneConfig(**bb), num_labels=17, use_simple_decoder=simple)
    model = VitPoseForPoseEstimation(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0, 0.1)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0)
        model.head.conv.bias.add_(1.0)  # positive maxima: the detections clear the confidence floor
    return model


def _checkpoint(path, model, safe=True, processor=True):
    model.save_pretrained(str(path), safe_serialization=safe)
    if processor:
        VitPoseImageProcessor(size={"height": INPUT_HW[0], "width": INPUT_HW[1]}).save_pretrained(str(path))
    return str(path)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
@pytest.mark.parametrize("simple", [True, False], ids=["simple", "classic"])
def test_heatmaps_match_transformers(tmp_path, simple, safe):
    model = _hf_model(0, simple, out_indices=[1], layer_norm_eps=1e-6)
    ckpt = _checkpoint(tmp_path, model, safe, processor=False)
    cfg = tmodel.VitPoseConfig.from_dict(hf_checkpoint.read_config(ckpt))
    assert (cfg.out_index, cfg.layer_norm_eps, cfg.use_simple_decoder, cfg.num_labels) == (1, 1e-6, simple, 17)
    ours = tmodel.VitPose(cfg)
    state = hf_checkpoint.read_state_dict(ckpt)
    assert set(state) == set(ours.state_dict()) == set(model.state_dict())
    ours.load_state_dict(state, strict=True)
    ref = VitPoseForPoseEstimation.from_pretrained(ckpt).eval()
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 3, *INPUT_HW)), dtype=torch.float32)
    with torch.no_grad():
        want, got = ref(pixel_values=x).heatmaps, ours(x)
    assert got.shape == want.shape == (3, 17, 16, 12)
    assert want.abs().max() > 0.5
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_safetensors_reader_takes_half_bfloat_and_shards(tmp_path):
    model = _hf_model(2)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    for dtype in (torch.float16, torch.bfloat16):
        d = tmp_path / str(dtype)
        copy.deepcopy(model).to(dtype).save_pretrained(str(d), max_shard_size="20KB")
        assert (d / "model.safetensors.index.json").exists()
        state = hf_checkpoint.read_state_dict(str(d))
        assert set(state) == set(want)
        for k, v in state.items():
            assert v.dtype == (dtype if want[k].is_floating_point() else want[k].dtype), k
            assert torch.equal(v, want[k].to(v.dtype)), k


@pytest.mark.parametrize("settings", [{}, {"image_mean": [0.5, 0.4, 0.3], "image_std": [0.2, 0.3, 0.25]},
                                      {"do_normalize": False}, {"do_rescale": False}],
                         ids=["imagenet", "own-mean-std", "no-normalize", "no-rescale"])
def test_pixel_values_match_the_image_processor(settings):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    boxes = np.array([[-10, 5, 50, 70], [60, 40, 80, 70], [30.5, 20.25, 10, 40], [100, -20, 40, 30]], np.float32)
    size = (80, 56)
    proc = VitPoseImageProcessor(size={"height": size[0], "width": size[1]}, **settings)
    want = proc(images=img, boxes=[boxes], return_tensors="pt")["pixel_values"].numpy()
    got = tproc.preprocess(img, boxes, tproc.ProcessorConfig(proc.to_dict()))
    assert got.dtype == want.dtype and got.shape == want.shape == (4, 3, *size)
    np.testing.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()), rtol=0)
    if not settings:  # boxes partly outside: the warp fills zeros there, normalised to -mean/std
        assert np.isclose(got[0, 0, :, 0], -0.485 / 0.229, atol=1e-5).all()


def test_keypoints_match_post_process_pose_estimation():
    rng = np.random.default_rng(4)
    D, K, h, w = 3, 17, 16, 12
    y, x = np.mgrid[0:h, 0:w]
    peaks = rng.uniform([1, 1], [h - 2, w - 2], (D, K, 2))
    heatmaps = np.exp(-((y - peaks[..., :1, None]) ** 2 + (x - peaks[..., 1:, None]) ** 2) / 4.0)
    heatmaps = (heatmaps + rng.normal(0, 0.02, heatmaps.shape)).astype(np.float32)
    heatmaps[0, 3] -= 2.0  # a map with no positive value
    boxes = np.array([[10, 20, 30, 60], [-5, 0, 40, 20], [50.5, 10.25, 25, 25]], np.float32)

    class Out:
        pass

    out = Out()
    out.heatmaps = torch.from_numpy(heatmaps)
    proc = VitPoseImageProcessor(size={"height": 64, "width": 48})
    want = proc.post_process_pose_estimation(out, boxes=[boxes])[0]
    kp, scores = tproc.postprocess(heatmaps, boxes, tproc.ProcessorConfig(proc.to_dict()))
    assert kp.shape == (D, K, 2) and scores.shape == (D, K)
    for i, r in enumerate(want):
        np.testing.assert_allclose(kp[i], r["keypoints"].numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(scores[i], r["scores"].numpy(), atol=1e-6, rtol=0)


def test_detector_and_vitpose_keypoints_match_jax(tmp_path):
    ckpt = _checkpoint(tmp_path, _hf_model(5))
    ours, theirs = tvitpose.VitPoseDetector(checkpoint=ckpt, device="cpu"), jvitpose.VitPoseDetector(checkpoint=ckpt)
    inputs, *_ = make_trace_inputs(F=2, P=2)
    rng = np.random.default_rng(5)
    images = [np.clip(img.astype(np.float32) + rng.normal(0, 30, img.shape), 0, 255).astype(np.uint8)
              for img in inputs.images]
    boxes = np.array([[5, 3, 30, 45], [40, -5, 50, 70]], np.float32)
    got, want = ours(images[0], boxes), theirs(images[0], boxes)
    assert len(got) == len(want) == 2 and ours(images[0], np.zeros((0, 4))) == []
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (17, 3)
        np.testing.assert_allclose(g[:, :2], w[:, :2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g[:, 2], w[:, 2], atol=1e-5, rtol=0)
    got = ttrace.vitpose_keypoints(images, inputs.keypoints_2d, checkpoint=ckpt, device="cpu")
    want = jtrace.vitpose_keypoints(images, inputs.keypoints_2d, checkpoint=ckpt)
    assert not np.array_equal(got, inputs.keypoints_2d), "no track took a detection"
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_config_without_checkpoint_and_experts(tmp_path):
    """A `config` dict gives the model its input size and the processor's
    defaults otherwise; ViTPose+ is refused by the port and fails in JAX's
    forward; an activation other than ViTPose's erf-GELU is refused."""
    cfg = _hf_model(6).config
    det = tvitpose.VitPoseDetector(config=cfg.to_dict(), device="cpu")
    assert (det.processor.height, det.processor.width) == INPUT_HW
    dets = det(np.zeros((40, 30, 3), np.uint8), np.array([[0, 0, 20, 30]], np.float32))
    assert len(dets) == 1 and dets[0].shape == (17, 3) and np.isfinite(dets[0]).all()
    ckpt = _checkpoint(tmp_path / "no_processor", _hf_model(6), processor=False)
    proc = tvitpose.VitPoseDetector(checkpoint=ckpt, device="cpu").processor
    assert (proc.height, proc.width) == (256, 192)
    moe = _hf_model(7, num_experts=2, part_features=8)
    with pytest.raises(ValueError, match="dataset_index"):
        tvitpose.VitPoseDetector(config=moe.config.to_dict(), device="cpu")
    with pytest.raises(ValueError, match="dataset_index"):
        jvitpose.VitPoseDetector(config=moe.config)(np.zeros((40, 30, 3), np.uint8), np.array([[0, 0, 20, 30.0]]))
    relu = cfg.to_dict()
    relu["backbone_config"]["hidden_act"] = "relu"
    with pytest.raises(ValueError, match="gelu"):
        tvitpose.VitPoseDetector(config=relu, device="cpu")
    with pytest.raises(FileNotFoundError):
        tvitpose.VitPoseDetector(checkpoint=str(tmp_path / "missing"), device="cpu")
