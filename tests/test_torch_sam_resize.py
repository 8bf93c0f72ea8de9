"""`multiply_tpu_torch/utils/resize.py::resize_linear` against OpenCV's
`cv2.resize` (INTER_LINEAR), which the JAX package's SAM path calls six
times: uint8 bit for bit, float32 within 1e-5.

The shapes are the SAM path's: the 0/1 uint8 canvas of the mask prior
(side x side -> 256 x 256), the uint8 RGB frame to a long side of 1024, the
float32 low-resolution logits up to 1024 and the crop back to the frame;
then random shapes and channel counts.
"""

import cv2
import numpy as np
import pytest
import torch

from multiply_tpu_torch.utils.resize import resize_linear

FRAMES = [(270, 360), (540, 960), (940, 1280), (100, 150), (48, 64), (40, 52)]


def _long_side(h, w, side=1024):
    s = side / max(h, w)
    return int(round(w * s)), int(round(h * s))


def _canvas(h, w, rng):
    """A 0/1 person mask in the top-left of a square canvas, as
    `build_sam_prompts` draws it."""
    side = max(h, w)
    canvas = np.zeros((side, side), np.uint8)
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    canvas[y0:y0 + rng.integers(2, h - y0 + 1), x0:x0 + rng.integers(2, w - x0 + 1)] = 1
    canvas[:h, :w] &= (rng.random((h, w)) > 0.05).astype(np.uint8)
    return canvas


@pytest.mark.parametrize("hw", FRAMES + [(256, 512)], ids=str)
def test_uint8_on_the_sam_path_is_bit_exact(hw):
    rng = np.random.default_rng(sum(hw))
    h, w = hw
    for _ in range(3):
        canvas = _canvas(h, w, rng)
        np.testing.assert_array_equal(resize_linear(canvas, (256, 256)), cv2.resize(canvas, (256, 256)))
    frame = (rng.random((h, w, 3)) * 256).astype(np.uint8)
    dsize = _long_side(h, w)
    np.testing.assert_array_equal(resize_linear(frame, dsize), cv2.resize(frame, dsize))
    small = _long_side(h, w, 128)  # the test size of the predictor
    np.testing.assert_array_equal(resize_linear(frame, small), cv2.resize(frame, small))


def test_uint8_random_shapes_are_bit_exact():
    rng = np.random.default_rng(0)
    for _ in range(150):
        h, w, H, W = (int(v) for v in rng.integers(1, 300, 4))
        c = int(rng.choice([0, 3, 4]))
        x = (rng.random((h, w) if c == 0 else (h, w, c)) * 256).astype(np.uint8)
        np.testing.assert_array_equal(resize_linear(x, (W, H)), cv2.resize(x, (W, H)), err_msg=f"{x.shape} -> {H, W}")
        mask = (rng.random((h, w)) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(resize_linear(mask, (W, H)), cv2.resize(mask, (W, H)))


@pytest.mark.parametrize("hw", FRAMES, ids=str)
def test_float32_on_the_sam_path(hw):
    rng = np.random.default_rng(sum(hw) + 1)
    h, w = hw
    logits = (rng.standard_normal((256, 256)) * 8).astype(np.float32)
    for dsize in ((1024, 1024), (max(h, w),) * 2, (64, 64)):
        np.testing.assert_allclose(resize_linear(logits, dsize), cv2.resize(logits, dsize), atol=1e-5, rtol=1e-5)
    up = cv2.resize(logits, (1024, 1024))
    nw, nh = _long_side(h, w)
    crop = np.ascontiguousarray(up[:nh, :nw])
    np.testing.assert_allclose(resize_linear(crop, (w, h)), cv2.resize(crop, (w, h)), atol=1e-5, rtol=1e-5)


def test_float32_random_shapes_and_torch_input():
    rng = np.random.default_rng(1)
    for _ in range(100):
        h, w, H, W = (int(v) for v in rng.integers(2, 300, 4))
        x = (rng.standard_normal((h, w, 3) if rng.random() < 0.3 else (h, w)) * 10).astype(np.float32)
        np.testing.assert_allclose(resize_linear(x, (W, H)), cv2.resize(x, (W, H)), atol=1e-5, rtol=1e-5)
    x = (rng.random((30, 40, 3)) * 256).astype(np.uint8)
    out = resize_linear(torch.from_numpy(x), (50, 20))
    assert torch.is_tensor(out) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), cv2.resize(x, (50, 20)))
