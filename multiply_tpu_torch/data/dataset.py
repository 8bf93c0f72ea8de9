"""Hi4D-format sequence dataset: preprocessed images, masks, SMPL parameters
and cameras, weighted and edge ray sampling, and the pickup of the SAM masks
that the epoch-end stages write.

Counterpart of `multiply_tpu/data/dataset.py`, host numpy throughout, with
the same `np.random.Generator` draws in the same order, so both packages
sample the same rays. Images are read by `utils/io.read_png` and the mask
band by `scipy.ndimage`, in place of OpenCV, with OpenCV's results:
  * `imread_bgr` is `cv2.imread(path)` (gray repeated, alpha dropped);
  * `gray_nonzero` is `cv2.cvtColor(img, COLOR_BGR2GRAY) > 0`, with OpenCV's
    fixed-point BT.601 weights;
  * `edge_band` is `cv2.dilate(m, 5x5) - cv2.erode(m, 5x5) > 0`: outside the
    image the dilation sees 0 and the erosion sees 1, so the border erodes
    nothing;
  * `dilate_box` is `cv2.dilate(m, ones((k, k)))`, with OpenCV's anchor for
    an even k.

Layout on disk, and of the refinement-loop files in the run directory:

    <root>/image/*.png            frames
    <root>/mask/<p>/*.png         per-person initial masks
    <root>/poses.npy              (F, P, 72)
    <root>/normalize_trans.npy    (F, P, 3)
    <root>/mean_shape.npy         (P, 10)
    <root>/gender.npy             (P,) strings
    <root>/cameras_normalize.npz  scale_mat_%d / world_mat_%d
    <run>/stage_instance_mask/<epoch>/all_person_smpl_mask.npy  (F, P, H, W)
    <run>/stage_sam_mask/<epoch>/sam_opt_mask.npy               (F, P, H, W) logits
"""

from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np
import scipy.ndimage

from ..utils.cameras import load_K_Rt_from_P
from ..utils.io import read_png

# OpenCV's BGR -> gray weights in 14-bit fixed point (0.114, 0.587, 0.299)
_GRAY_WEIGHTS = (1868, 9617, 4899)
_BOX5 = np.ones((5, 5), bool)


def imread_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 in BGR order, as `cv2.imread(path)` gives it."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


def gray_nonzero(bgr: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY) > 0` for a uint8 image."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    wb, wg, wr = _GRAY_WEIGHTS
    return ((b * wb + g * wg + r * wr + (1 << 13)) >> 14) > 0


def edge_band(mask: np.ndarray) -> np.ndarray:
    """Pixels within 2 of the mask's boundary: a 5x5 box dilation minus a 5x5
    box erosion, with OpenCV's border handling."""
    m = np.asarray(mask) > 0
    dilated = scipy.ndimage.binary_dilation(m, _BOX5, border_value=0)
    eroded = scipy.ndimage.binary_erosion(m, _BOX5, border_value=1)
    return dilated & ~eroded


def dilate_box(mask: np.ndarray, size: int) -> np.ndarray:
    """`cv2.dilate(mask, np.ones((size, size)))` of a uint8 image: OpenCV
    anchors the box at (size // 2, size // 2), so each output pixel takes the
    maximum from size // 2 pixels before it to size // 2 - 1 after it, as
    `maximum_filter`'s window does; outside the image counts as 0."""
    return scipy.ndimage.maximum_filter(mask, size=size, mode="constant", cval=0)


def bilinear_sample(img: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of (H, W, C) or (H, W) at float (row, col)."""
    single = img.ndim == 2
    if single:
        img = img[..., None]
    H, W = img.shape[:2]
    r0 = np.clip(np.floor(rows).astype(np.int32), 0, H - 2)
    c0 = np.clip(np.floor(cols).astype(np.int32), 0, W - 2)
    fr = (rows - r0)[:, None]
    fc = (cols - c0)[:, None]
    v = (
        img[r0, c0] * (1 - fr) * (1 - fc)
        + img[r0, c0 + 1] * (1 - fr) * fc
        + img[r0 + 1, c0] * fr * (1 - fc)
        + img[r0 + 1, c0 + 1] * fr * fc
    )
    return v[..., 0] if single else v


def weighted_sampling(data: dict, img_size, num_sample: int, rng: np.random.Generator) -> tuple[dict, np.ndarray]:
    """90% of rays in the union-mask bbox, 10% uniform, values interpolated at
    sub-pixel positions. Returns (samples, indices of the uniform rays that fell
    outside the bbox)."""
    mask = data["object_mask"]
    where = np.asarray(np.where(mask))
    bbox_min = where.min(axis=1)
    bbox_max = where.max(axis=1)

    n_bbox = int(num_sample * 0.9)
    s_bbox = rng.random((n_bbox, 2)) * (bbox_max - bbox_min) + bbox_min
    n_unif = num_sample - n_bbox
    s_unif = rng.random((n_unif, 2)) * (img_size[0] - 1, img_size[1] - 1)

    outside = np.where(
        (s_unif[:, 0] < bbox_min[0]) | (s_unif[:, 0] > bbox_max[0])
        | (s_unif[:, 1] < bbox_min[1]) | (s_unif[:, 1] > bbox_max[1])
    )[0] + n_bbox

    idx = np.concatenate([s_bbox, s_unif], axis=0)  # (N, 2) = (row, col)
    return {k: bilinear_sample(v, idx[:, 0], idx[:, 1]) for k, v in data.items()}, outside


def edge_sampling(data: dict, num_sample: int, rng: np.random.Generator,
                  ratio_mask: float = 0.5, ratio_edge: float = 0.4) -> dict:
    """50% mask / 40% edge / 10% random integer-pixel sampling, for the
    delayed-pose (uncertain) frames."""
    n_mask = int(num_sample * ratio_mask)
    n_edge = int(num_sample * ratio_edge)
    n_rand = num_sample - n_mask - n_edge
    mask = data["person_mask"].reshape(-1)
    edge = data["edge_mask"].reshape(-1)

    mask_loc = np.where(mask)[0]
    edge_loc = np.where(edge)[0]
    if len(mask_loc) == 0:
        mask_loc = np.arange(len(mask))
    if len(edge_loc) == 0:
        edge_loc = mask_loc

    indices = np.concatenate([
        mask_loc[rng.integers(0, len(mask_loc), n_mask)],
        edge_loc[rng.integers(0, len(edge_loc), n_edge)],
        rng.integers(0, len(mask), n_rand),
    ])
    return {
        k: v.reshape(len(mask), -1)[indices]
        for k, v in data.items()
        if k not in ("person_mask", "edge_mask")
    }


def sam_iou_certainty(sam: np.ndarray, smpl_mask_path: str | None, ratio_uncertain: float):
    """(per-frame IoU of SAM masks vs instance masks, the uncertainty
    threshold), or None without instance masks. `sam` is (F, P, H, W) logits."""
    if smpl_mask_path is None:
        return None
    smpl_mask = np.load(smpl_mask_path) > 0.8
    sam_bin = sam > 0.0
    inter = np.logical_and(sam_bin, smpl_mask).sum(axis=(2, 3))
    union = np.logical_or(sam_bin, smpl_mask).sum(axis=(2, 3))
    iou = (inter / np.maximum(union, 1)).mean(axis=-1)
    return iou, np.sort(iou)[int(len(iou) * ratio_uncertain)]


class SamPickup(NamedTuple):
    """What a sequence has picked up from the refinement stages: the SAM file
    read, its masks (F, H, W, P) logits, and the per-frame certainty with its
    threshold. Published in one assignment, so a reader on another thread
    never pairs new masks with the old certainty."""

    path: str
    masks: np.ndarray | None
    iou: np.ndarray
    threshold: float


def read_sam_pickup(run_dir: str, current: SamPickup, ratio_uncertain: float) -> SamPickup:
    """The latest stage files as a new `SamPickup`, or `current` when there is
    nothing newer or the file is missing or half-written (a writer's race).
    Without instance masks the certainty stays as it was."""
    path = latest_stage_file(run_dir, "stage_sam_mask", "sam_opt_mask.npy")
    if path is None or path == current.path:
        return current
    try:
        sam = np.load(path)  # (F, P, H, W) logits
        certainty = sam_iou_certainty(
            sam, latest_stage_file(run_dir, "stage_instance_mask", "all_person_smpl_mask.npy"), ratio_uncertain,
        )
    except (OSError, ValueError):
        return current
    iou, threshold = certainty if certainty is not None else (current.iou, current.threshold)
    return SamPickup(path, sam.transpose(0, 2, 3, 1), iou, threshold)


class SamPickupFields:
    """The pickup's fields under their old names (`_sam_path`, `_sam_masks`,
    `smpl_sam_iou`, `uncertain_threshold`); a reader that needs two of them
    together reads `sam_pickup` once. Setting a field replaces the whole tuple."""

    sam_pickup: SamPickup

    def _set_pickup(self, **fields) -> None:
        self.sam_pickup = self.sam_pickup._replace(**fields)

    _sam_path = property(lambda self: self.sam_pickup.path, lambda self, v: self._set_pickup(path=v))
    _sam_masks = property(lambda self: self.sam_pickup.masks, lambda self, v: self._set_pickup(masks=v))
    smpl_sam_iou = property(lambda self: self.sam_pickup.iou, lambda self, v: self._set_pickup(iou=v))
    uncertain_threshold = property(lambda self: self.sam_pickup.threshold,
                                   lambda self, v: self._set_pickup(threshold=v))

    def _refresh_sam(self) -> None:
        self.sam_pickup = read_sam_pickup(self.run_dir, self.sam_pickup, self.ratio_uncertain)


def latest_stage_file(run_dir: str, stage: str, name: str) -> str | None:
    """`<run_dir>/<stage>/<latest epoch>/<name>`, or None without a stage dir."""
    dirs = sorted(glob.glob(os.path.join(run_dir, stage, "*")))
    return os.path.join(dirs[-1], name) if dirs else None


class Hi4DSequence(SamPickupFields):
    """A preprocessed multi-person sequence and its refinement-loop state."""

    def __init__(
        self,
        root: str,
        start_frame: int = 0,
        end_frame: int | None = None,
        num_sample: int = 512,
        using_sam: bool = True,
        ratio_uncertain: float = 0.5,
        run_dir: str = ".",
        edge_sampling_on: bool = False,
    ):
        self.root = root
        self.run_dir = run_dir
        self.num_sample = num_sample
        self.using_sam = using_sam
        self.ratio_uncertain = ratio_uncertain
        self.edge_sampling_on = edge_sampling_on

        def layout_error(msg: str) -> None:
            raise FileNotFoundError(
                f"{root}: {msg}\nExpected the preprocessed layout the "
                "reference's preprocessing (or `python -m "
                "multiply_tpu.preprocessing`) emits — see docs/REAL_DATA.md "
                "for the full file list."
            )

        if not os.path.isdir(root):
            layout_error("directory does not exist")
        img_paths = sorted(glob.glob(os.path.join(root, "image", "*.png")))
        if not img_paths:
            layout_error("no PNG frames under image/ (expected image/0000.png ...)")
        if end_frame is None:
            end_frame = len(img_paths)
        if end_frame > len(img_paths):
            layout_error(f"end_frame={end_frame} but only {len(img_paths)} frames in image/")
        self.training_indices = list(range(start_frame, end_frame))
        self.img_paths = [img_paths[i] for i in self.training_indices]
        self.n_images = len(self.img_paths)
        try:
            first = imread_bgr(self.img_paths[0])
        except (OSError, ValueError) as e:
            layout_error(f"{self.img_paths[0]} is not a readable image ({e})")
        self.img_size = first.shape[:2]  # (H, W)

        mask_folders = sorted(d for d in glob.glob(os.path.join(root, "mask", "*")) if os.path.isdir(d))
        if mask_folders:
            self.mask_paths = []
            for folder in mask_folders:
                pngs = sorted(glob.glob(f"{folder}/*.png"))
                if len(pngs) < end_frame:
                    layout_error(f"mask dir {folder} has {len(pngs)} PNGs, need >= {end_frame} (one per frame)")
                self.mask_paths.append([pngs[i] for i in self.training_indices])
        else:
            # single-person flat layout: one mask dir, params without a person axis
            flat = sorted(glob.glob(os.path.join(root, "mask", "*.png")))
            if len(flat) < end_frame:
                layout_error(
                    "mask/ must hold either one subdirectory of PNGs per "
                    f"person or one PNG per frame (found {len(flat)} PNGs, "
                    f"0 subdirectories, need {end_frame} frames)"
                )
            self.mask_paths = [[flat[i] for i in self.training_indices]]

        for name in ("mean_shape.npy", "poses.npy", "normalize_trans.npy", "cameras_normalize.npz"):
            if not os.path.exists(os.path.join(root, name)):
                layout_error(f"missing {name}")
        self.shape = np.atleast_2d(np.load(os.path.join(root, "mean_shape.npy")))
        self.num_person = self.shape.shape[0]
        if mask_folders and len(mask_folders) != self.num_person:
            layout_error(
                f"mean_shape.npy has {self.num_person} persons but mask/ has "
                f"{len(mask_folders)} per-person subdirectories"
            )
        poses = np.load(os.path.join(root, "poses.npy"))
        trans = np.load(os.path.join(root, "normalize_trans.npy"))
        if poses.shape[0] < end_frame or trans.shape[0] < end_frame:
            layout_error(
                f"poses.npy/normalize_trans.npy cover {poses.shape[0]}/"
                f"{trans.shape[0]} frames, need >= {end_frame}"
            )
        if poses.ndim == 3 and poses.shape[1] != self.num_person:
            layout_error(
                f"poses.npy person axis is {poses.shape[1]} but "
                f"mean_shape.npy has {self.num_person} persons"
            )
        if poses.shape[-1] != 72:
            layout_error(
                f"poses.npy last axis is {poses.shape[-1]}, expected 72 "
                "(SMPL global_orient + body_pose, axis-angle)"
            )
        poses = poses[self.training_indices]
        trans = trans[self.training_indices]
        if poses.ndim == 2:  # (F, 72) single person -> (F, 1, 72)
            poses = poses[:, None, :]
            trans = trans[:, None, :]
        self.poses = poses
        self.trans = trans
        gender_path = os.path.join(root, "gender.npy")
        self.genders = (
            [str(g) for g in np.load(gender_path)] if os.path.exists(gender_path)
            else ["neutral"] * self.num_person
        )

        cam = np.load(os.path.join(root, "cameras_normalize.npz"))
        missing_keys = [
            k for i in self.training_indices for k in (f"scale_mat_{i}", f"world_mat_{i}") if k not in cam
        ]
        if missing_keys:
            layout_error(
                "cameras_normalize.npz lacks per-frame keys "
                f"{missing_keys[:4]}{'...' if len(missing_keys) > 4 else ''} "
                "(expected scale_mat_%d / world_mat_%d for every frame index)"
            )
        self.P, self.C, self.intrinsics, self.pose = [], [], [], []
        self.scale_mats, self.world_mats = [], []
        self.scale = 1.0 / cam[f"scale_mat_{self.training_indices[0]}"][0, 0]
        for i in self.training_indices:
            scale_mat = cam[f"scale_mat_{i}"].astype(np.float32)
            world_mat = cam[f"world_mat_{i}"].astype(np.float32)
            self.scale_mats.append(scale_mat)
            self.world_mats.append(world_mat)
            P = world_mat @ scale_mat
            self.P.append(P)
            self.C.append(-np.linalg.solve(P[:3, :3], P[:3, 3]))
            intr, pose = load_K_Rt_from_P(P[:3, :4])
            self.intrinsics.append(intr[:3, :3])
            self.pose.append(pose)

        edge_dir = os.path.join(root, "edge")
        self.edge_paths = sorted(glob.glob(f"{edge_dir}/*.png")) if os.path.isdir(edge_dir) else None

        # SAM refinement pickup state
        self.sam_pickup = SamPickup("", None, np.ones(self.n_images), 0.0)

    def __len__(self) -> int:
        return self.n_images

    # -- items -----------------------------------------------------------

    def load_frame(self, idx: int) -> dict:
        """Full-resolution frame data (host arrays)."""
        img = imread_bgr(self.img_paths[idx])[:, :, ::-1].astype(np.float32) / 255.0
        masks = [gray_nonzero(imread_bgr(paths[idx])) for paths in self.mask_paths]
        union = np.stack(masks, -1).sum(-1)
        H, W = self.img_size
        uv = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), axis=-1).astype(np.float32)
        return {"img": img, "mask_union": union, "uv": uv, "masks": masks}

    def get_train_item(self, idx: int, rng: np.random.Generator) -> dict:
        if self.using_sam:
            self._refresh_sam()
        frame = self.load_frame(idx)
        pickup = self.sam_pickup
        sam = pickup.masks[idx] if pickup.masks is not None else None
        is_certain = bool(pickup.iou[idx] >= pickup.threshold)

        data = {"rgb": frame["img"], "uv": frame["uv"], "object_mask": frame["mask_union"]}
        if sam is not None:
            data["sam_mask"] = sam
        samples, _ = weighted_sampling(data, self.img_size, self.num_sample, rng)

        out = {
            "uv": samples["uv"].astype(np.float32),
            "rgb": samples["rgb"].astype(np.float32),
            "intrinsics": self.intrinsics[idx],
            "pose": self.pose[idx],
            "P": self.P[idx],
            "C": self.C[idx],
            "smpl_pose": self.poses[idx].astype(np.float32),  # (P, 72)
            "smpl_trans": self.trans[idx].astype(np.float32),
            "smpl_shape": self.shape.astype(np.float32),
            "smpl_scale": np.full(self.num_person, self.scale, np.float32),
            "idx": idx,
            "is_certain": is_certain,
        }
        if sam is not None:
            out["sam_mask"] = samples["sam_mask"].astype(np.float32)

        if self.edge_sampling_on or not is_certain:
            person = frame["mask_union"] > 0
            if self.edge_paths is not None:
                e = gray_nonzero(imread_bgr(self.edge_paths[idx]))
            else:  # an edge band from the mask union when there are no edge maps
                e = edge_band(person)
            edata = {"rgb": frame["img"], "uv": frame["uv"], "person_mask": person,
                     "edge_mask": np.logical_and(person, e)}
            if sam is not None:
                edata["sam_mask"] = sam
            es = edge_sampling(edata, self.num_sample, rng)
            out["edge_uv"] = es["uv"].astype(np.float32)
            out["edge_rgb"] = es["rgb"].astype(np.float32)
            if sam is not None:
                out["edge_sam_mask"] = es["sam_mask"].astype(np.float32)
        return out

    def get_eval_item(self, idx: int) -> dict:
        """Full-image item for validation and test rendering."""
        if self.using_sam:
            self._refresh_sam()
        frame = self.load_frame(idx)
        H, W = self.img_size
        return {
            "uv": frame["uv"].reshape(-1, 2),
            "rgb": frame["img"].reshape(-1, 3),
            "intrinsics": self.intrinsics[idx],
            "pose": self.pose[idx],
            "P": self.P[idx],
            "smpl_pose": self.poses[idx].astype(np.float32),
            "smpl_trans": self.trans[idx].astype(np.float32),
            "smpl_shape": self.shape.astype(np.float32),
            "smpl_scale": np.full(self.num_person, self.scale, np.float32),
            "idx": idx,
            "img_size": (H, W),
            "masks": frame["masks"],
        }


def novel_view_cameras(seq, gt_cameras: dict, current_view: int, novel_view: int) -> list[dict]:
    """Per-frame projection for a held-out GT camera: relate the training
    camera to the GT current view, carry that relation onto the GT target
    view, rescale the intrinsics by the training/GT focal ratio and re-apply
    the scene's normalisation matrix. `gt_cameras` holds ids, intrinsics and
    extrinsics (rgb_cameras.npz)."""
    ids = np.asarray(gt_cameras["ids"])
    c_cur = int(np.where(ids == current_view)[0][0])
    c_tgt = int(np.where(ids == novel_view)[0][0])
    K_cur = np.asarray(gt_cameras["intrinsics"][c_cur])
    E_cur = np.asarray(gt_cameras["extrinsics"][c_cur])
    K_tgt = np.asarray(gt_cameras["intrinsics"][c_tgt])
    E_tgt = np.asarray(gt_cameras["extrinsics"][c_tgt])

    out = []
    for scale_mat, world_mat in zip(seq.scale_mats, seq.world_mats):
        intr_train, pose_train = load_K_Rt_from_P(world_mat[:3, :4])
        scale_factor = K_cur[0, 0] / intr_train[0, 0]
        R3 = pose_train[:3, :3].T
        t3 = -R3 @ pose_train[:3, 3]
        R1, t1 = E_cur[:3, :3], E_cur[:3, 3]
        Rab = R3.T @ R1
        tab = R3.T @ (t1 - t3)
        R4 = E_tgt[:3, :3] @ Rab.T
        t4 = E_tgt[:3, 3] - R4 @ tab

        K_scaled = K_tgt[:3, :3].copy()
        K_scaled[:2] /= scale_factor
        novel_world = np.eye(4, dtype=np.float64)
        novel_world[:3, :4] = K_scaled @ np.concatenate([R4, t4.reshape(3, 1)], axis=1)
        P = (novel_world @ scale_mat).astype(np.float32)
        intr, pose = load_K_Rt_from_P(P[:3, :4])
        out.append({"P": P, "intrinsics": intr[:3, :3], "pose": pose})
    return out
