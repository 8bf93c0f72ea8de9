"""ViTPose's image processing on the host: box -> crop -> pixels, heatmaps -> keypoints.

Counterpart of `transformers`' `VitPoseImageProcessor`
(`models/vitpose/image_processing_vitpose.py`), which the JAX package calls,
in numpy and scipy with the same operations and dtypes:

- each COCO box [x, y, w, h] becomes a center and a scale: the box widened
  or heightened to the model input's aspect ratio, over a normalize factor of
  200, times a padding of 1.25;
- the crop is the unbiased (UDP) warp of that box onto the input size,
  computed by `scipy.ndimage.affine_transform(order=1)` on each uint8 channel
  with the inverted matrix, rows and columns swapped;
- pixels are rescaled by 1/255 in float64, cast to float32 and normalised
  with the mean and std (ImageNet's unless the preprocessor config says);
- keypoints are each heatmap's argmax, refined by DARK (a Gaussian filter of
  sigma 0.8, the log, one Newton step on the local Taylor expansion) and
  mapped back through the box; the scores are the heatmap maxima.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.linalg import inv
from scipy.ndimage import affine_transform, gaussian_filter

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NORMALIZE_FACTOR = 200.0
DARK_KERNEL = 11  # `post_process_pose_estimation`'s kernel_size


class ProcessorConfig:
    """The settings of `preprocessor_config.json` that the processing reads,
    with `VitPoseImageProcessor`'s defaults."""

    def __init__(self, d: dict | None = None, size: tuple[int, int] | None = None):
        d = d or {}
        if not d.get("do_affine_transform", True):
            raise ValueError("do_affine_transform=False: the port always crops the boxes")
        s = d.get("size") or {}
        self.height, self.width = size if size is not None else (int(s.get("height", 256)), int(s.get("width", 192)))
        self.do_rescale = bool(d.get("do_rescale", True))
        self.rescale_factor = float(d.get("rescale_factor", 1 / 255))
        self.do_normalize = bool(d.get("do_normalize", True))
        self.mean = tuple(d.get("image_mean") or IMAGENET_MEAN)
        self.std = tuple(d.get("image_std") or IMAGENET_STD)


def box_to_center_and_scale(box, image_width: int, image_height: int):
    """COCO box -> (center (2,), scale (2,)) float32, the box grown to the
    aspect ratio `image_width / image_height`, over NORMALIZE_FACTOR, padded
    by 1.25."""
    x, y, w, h = box[:4]
    aspect = image_width / image_height
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect * h:
        h = w * 1.0 / aspect
    elif w < aspect * h:
        w = h * aspect
    scale = np.array([w / NORMALIZE_FACTOR, h / NORMALIZE_FACTOR], dtype=np.float32)
    return center, scale * 1.25


def get_warp_matrix(size_input, size_dst, size_target) -> np.ndarray:
    """The (2, 3) float32 UDP affine matrix from a region of `size_target`
    centred in `size_input` onto `size_dst` (all (w, h)), without rotation."""
    m = np.zeros((2, 3), dtype=np.float32)
    sx, sy = size_dst[0] / size_target[0], size_dst[1] / size_target[1]
    m[0, 0], m[1, 1] = sx, sy
    m[0, 2] = sx * (-0.5 * size_input[0] + 0.5 * size_target[0])
    m[1, 2] = sy * (-0.5 * size_input[1] + 0.5 * size_target[1])
    return m


def warp_affine(src: np.ndarray, m: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) -> out_hw + (C,) in src's dtype: each channel pulled through
    the inverse of the forward (2, 3) matrix `m` with bilinear interpolation
    and zeros outside."""
    m_inv = inv(np.vstack([m, [0, 0, 1]]))
    # (x, y) -> (row, col) order for scipy
    m_inv[0, 0], m_inv[0, 1], m_inv[1, 0], m_inv[1, 1], m_inv[0, 2], m_inv[1, 2] = (
        m_inv[1, 1], m_inv[1, 0], m_inv[0, 1], m_inv[0, 0], m_inv[1, 2], m_inv[0, 2])
    return np.stack([affine_transform(src[..., i], m_inv, output_shape=out_hw, order=1)
                     for i in range(src.shape[-1])], axis=-1)


def preprocess(image: np.ndarray, boxes: np.ndarray, cfg: ProcessorConfig) -> np.ndarray:
    """(H, W, 3) uint8 image and (D, 4) COCO boxes -> (D, 3, h, w) float32
    model inputs."""
    crops = []
    for box in boxes:
        center, scale = box_to_center_and_scale(box, cfg.width, cfg.height)
        m = get_warp_matrix(center * 2.0, np.array((cfg.width, cfg.height)) - 1.0, scale * NORMALIZE_FACTOR)
        crop = warp_affine(image, m, (cfg.height, cfg.width))
        if cfg.do_rescale:
            crop = (crop.astype(np.float64) * cfg.rescale_factor).astype(np.float32)
        if cfg.do_normalize:
            if not np.issubdtype(crop.dtype, np.floating):
                crop = crop.astype(np.float32)
            crop = (crop - np.array(cfg.mean, crop.dtype)) / np.array(cfg.std, crop.dtype)
        crops.append(np.ascontiguousarray(crop.transpose(2, 0, 1)))
    return np.stack(crops)


def get_keypoint_predictions(heatmaps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, K, h, w) -> argmax coordinates (B, K, 2) float32 (-1 where the
    maximum is not positive) and the maxima (B, K, 1)."""
    B, K, _, w = heatmaps.shape
    flat = heatmaps.reshape((B, K, -1))
    idx = np.argmax(flat, 2).reshape((B, K, 1))
    scores = np.amax(flat, 2).reshape((B, K, 1))
    preds = np.tile(idx, (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = preds[:, :, 0] % w
    preds[:, :, 1] = preds[:, :, 1] // w
    return np.where(np.tile(scores, (1, 1, 2)) > 0.0, preds, -1), scores


def dark_refine(coords: np.ndarray, heatmaps: np.ndarray) -> np.ndarray:
    """DARK (distribution-aware) sub-pixel refinement of `coords` (B, K, 2)
    on their heatmaps (B, K, h, w), in place: the heatmaps smoothed (sigma
    0.8, radius (DARK_KERNEL - 1) // 2), clipped to [0.001, 50] and logged,
    then one Newton step from the gradient and Hessian of central
    differences (edge-padded)."""
    B, K, h, w = heatmaps.shape
    r = (DARK_KERNEL - 1) // 2
    hm = np.array([[gaussian_filter(m, sigma=0.8, radius=(r, r), axes=(0, 1)) for m in maps] for maps in heatmaps])
    hm = np.log(np.clip(hm, 0.001, 50))
    pad = np.pad(hm, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge").flatten()
    index = coords[..., 0] + 1 + (coords[..., 1] + 1) * (w + 2)
    index += (w + 2) * (h + 2) * np.arange(0, B * K).reshape(-1, K)
    index = index.astype(int).reshape(-1, 1)
    i_ = pad[index]
    ix1, iy1, ix1y1 = pad[index + 1], pad[index + w + 2], pad[index + w + 3]
    ix1_y1_, ix1_, iy1_ = pad[index - w - 3], pad[index - 1], pad[index - 2 - w]
    grad = np.concatenate([0.5 * (ix1 - ix1_), 0.5 * (iy1 - iy1_)], axis=1).reshape(B, K, 2, 1)
    dxx = ix1 - 2 * i_ + ix1_
    dyy = iy1 - 2 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + i_ + i_ - ix1_ - iy1_ + ix1_y1_)
    hess = np.concatenate([dxx, dxy, dxy, dyy], axis=1).reshape(B, K, 2, 2)
    hess = np.linalg.inv(hess + np.finfo(np.float32).eps * np.eye(2))
    coords -= np.einsum("ijmn,ijnk->ijmk", hess, grad).squeeze()
    return coords


def transform_preds(coords: np.ndarray, center: np.ndarray, scale: np.ndarray, heatmap_hw) -> np.ndarray:
    """(K, 2) heatmap coordinates -> image pixels through the box's center
    and scale (the unbiased mapping: heatmap size - 1 spans the box)."""
    scale = scale * 200.0
    scale_y = scale[1] / (heatmap_hw[0] - 1.0)
    scale_x = scale[0] / (heatmap_hw[1] - 1.0)
    out = np.ones_like(coords)
    out[:, 0] = coords[:, 0] * scale_x + center[0] - scale[0] * 0.5
    out[:, 1] = coords[:, 1] * scale_y + center[1] - scale[1] * 0.5
    return out


def postprocess(heatmaps: np.ndarray, boxes: np.ndarray, cfg: ProcessorConfig) -> tuple[np.ndarray, np.ndarray]:
    """(D, K, h, w) heatmaps of the D boxes -> keypoints (D, K, 2) in image
    pixels and scores (D, K), both float32."""
    D, _, h, w = heatmaps.shape
    centers = np.zeros((D, 2), dtype=np.float32)
    scales = np.zeros((D, 2), dtype=np.float32)
    for i in range(D):
        centers[i], scales[i] = box_to_center_and_scale(boxes[i], image_width=cfg.width, image_height=cfg.height)
    coords, scores = get_keypoint_predictions(heatmaps)
    preds = dark_refine(coords, heatmaps)
    for i in range(D):
        preds[i] = transform_preds(preds[i], centers[i], scales[i], (h, w))
    return preds, scores[..., 0]
