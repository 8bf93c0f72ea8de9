"""TRACE tracker output -> `TraceInputs`.

Counterpart of `multiply_tpu/preprocessing/trace.py` (host numpy). TRACE
writes one flat array per detection; `reorganize_idx` maps detections to
frames and `track_ids` to persons, and the reformat gives [person, frame,
...] arrays. The keypoints are external COCO-17 detections matched to the
tracks when given, else TRACE's own projected joints (`pj2d_org`).

Frames, PNG or JPEG, are read by `utils/io.read_image` (RGB, as
`cv2.imread(..., cv2.IMREAD_COLOR)[:, :, ::-1]` gives them). With a
`vitpose_checkpoint`, the ViTPose model (`vitpose.VitPoseDetector`) detects
the keypoints on the caller's device.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.io import read_image
from .matching import keypoint_center, match_detections_to_tracks, skeleton_nms
from .pipeline import TraceInputs

# TRACE's pj2d_org: the 24 SMPL joints, then nose, eyes and ears at 24-28
TRACE_TO_COCO17 = np.asarray([24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8])
# BODY_25; -1 has no SMPL counterpart and gets confidence 0
TRACE_TO_OPENPOSE25 = np.asarray([24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                                  25, 26, 27, 28, -1, -1, -1, -1, -1, -1])


def reformat_trace_output(outputs: dict) -> dict:
    """Flat per-detection TRACE arrays -> {key: (P, F, ...)}. Frames are the
    sorted unique `reorganize_idx`, persons the ranks of the sorted unique
    track ids; "valid" (P, F) marks where a track was detected."""
    reorganize_idx = np.asarray(outputs["reorganize_idx"]).reshape(-1)
    track_ids = np.asarray(outputs["track_ids"]).reshape(-1)
    frame_of = {int(v): i for i, v in enumerate(np.unique(reorganize_idx))}
    person_of = {int(v): i for i, v in enumerate(np.unique(track_ids))}
    P, F = len(person_of), len(frame_of)
    rows = [(person_of[int(track_ids[d])], frame_of[int(reorganize_idx[d])]) for d in range(len(track_ids))]
    valid = np.zeros((P, F), bool)
    for p, f in rows:
        valid[p, f] = True

    def gather(key):
        src = np.asarray(outputs[key])
        out = np.zeros((P, F) + src.shape[1:], np.float32)
        for d, (p, f) in enumerate(rows):
            out[p, f] = src[d]
        return out

    return {
        "smpl_thetas": gather("smpl_thetas"), "smpl_betas": gather("smpl_betas"), "cam_trans": gather("cam_trans"),
        "joints": gather("j3d"), "pj2d_org": gather("pj2d_org"), "valid": valid,
    }


def load_trace_results(path: str) -> dict:
    """The raw TRACE npz (key 'outputs', a pickled dict), the reformatted one
    (key 'results') or an npz of the reformatted arrays themselves."""
    data = np.load(path, allow_pickle=True)
    if "results" in data.files:
        return dict(data["results"][()])
    if "outputs" in data.files:
        return reformat_trace_output(dict(data["outputs"][()]))
    return {k: data[k] for k in data.files}


def keypoints_from_pj2d(pj2d: np.ndarray, kp_format: str = "coco17") -> np.ndarray:
    """(P, F, J >= 29, 2 | 3) projected joints -> (F, P, 17 | 25, 3); a joint
    is confident (1) unless it is at the origin or beyond 1e5 pixels."""
    idx = TRACE_TO_COCO17 if kp_format == "coco17" else TRACE_TO_OPENPOSE25
    has = (idx >= 0).astype(np.float32)
    xy = pj2d[..., :2][:, :, np.maximum(idx, 0)]
    P, F = pj2d.shape[:2]
    kp = np.zeros((F, P, len(idx), 3), np.float32)
    kp[..., :2] = np.moveaxis(xy, 0, 1) * has[None, None, :, None]
    valid = np.moveaxis(np.all(np.abs(xy) < 1e5, axis=-1) & np.any(xy != 0, axis=-1), 0, 1)
    kp[..., 2] = valid.astype(np.float32) * has[None, None]
    return kp


def load_keypoint_npys(kp_dir: str, tracked_kp: np.ndarray, nms_center_px: float = 50.0, nms_kp_px: float = 30.0,
                       gate_px: float = 200.0, sel: list[int] | None = None) -> np.ndarray:
    """Per-frame detection files `<raw frame>.npy` of (D, 17, 3) -> per-track
    (F, P, 17, 3) keypoints: duplicates dropped, survivors matched to the
    tracks of `tracked_kp` by center; unmatched tracks keep `tracked_kp`.
    `sel` maps raw frame numbers to rows (files of other frames are skipped)."""
    F, P = tracked_kp.shape[:2]
    out = tracked_kp.copy()
    row_of = {int(v): i for i, v in enumerate(sel)} if sel is not None else None
    for path in sorted(glob.glob(os.path.join(kp_dir, "*.npy"))):
        f = int(os.path.splitext(os.path.basename(path))[0])
        if row_of is not None:
            if f not in row_of:
                continue
            f = row_of[f]
        if f >= F:
            continue
        dets = np.asarray(np.load(path), np.float32)
        if dets.ndim == 2:
            dets = dets[None]
        kept = skeleton_nms(list(dets), center_thresh=nms_center_px, kp_thresh=nms_kp_px)
        centers = np.stack([keypoint_center(tracked_kp[f, p]) for p in range(P)])
        for track_idx, det_idx in enumerate(match_detections_to_tracks(kept, centers, gate_px=gate_px)):
            if det_idx is not None:
                out[f, track_idx] = kept[det_idx]
    return out


def vitpose_keypoints(images: list[np.ndarray], tracked_kp: np.ndarray, checkpoint: str | None = None,
                      detector=None, box_pad: float = 0.2, device="cuda") -> np.ndarray:
    """Per frame, a padded COCO box [x, y, w, h] around each track's anchor
    keypoints prompts `detector(image, boxes) -> [(17, 3)]` (by default the
    ViTPose model of `checkpoint` on `device`); the detections are
    de-duplicated and matched back to the tracks, which keep their anchors
    where nothing matched."""
    from .vitpose import VitPoseDetector, detect_and_track

    if detector is None:
        detector = VitPoseDetector(checkpoint=checkpoint, device=device)
    P = tracked_kp.shape[1]
    out = tracked_kp.copy()
    for f, img in enumerate(images):
        boxes = []
        for p in range(P):
            kp = tracked_kp[f, p]
            ok = kp[:, 2] > 0
            if not ok.any():
                continue
            (x0, y0), (x1, y1) = kp[ok, :2].min(0), kp[ok, :2].max(0)
            w, h = x1 - x0, y1 - y0
            boxes.append([x0 - box_pad * w, y0 - box_pad * h, w * (1 + 2 * box_pad), h * (1 + 2 * box_pad)])
        if not boxes:
            continue
        centers = np.stack([keypoint_center(tracked_kp[f, p]) for p in range(P)])
        kp_f = detect_and_track(detector, img, np.asarray(boxes, np.float32), centers)
        for p in range(P):
            if kp_f[p, :, 2].any():
                out[f, p] = kp_f[p]
    return out


def trace_inputs_from_files(trace_npz: str, frames_dir: str, K: np.ndarray | None = None,
                            genders: list[str] | None = None, keypoints_dir: str | None = None, start: int = 0,
                            end: int | None = None, skip: int = 1, kp_format: str = "coco17",
                            vitpose_checkpoint: str | None = None, device="cuda") -> TraceInputs:
    """`TraceInputs` from a TRACE npz and a directory of PNG and JPEG frames,
    with optional per-frame keypoint npys or a ViTPose checkpoint (run on
    `device`). Without K: focal max(H, W) and the principal point
    (W // 2, H // 2)."""
    results = load_trace_results(trace_npz)
    thetas = np.asarray(results["smpl_thetas"], np.float32)  # (P, F, 72)
    betas_pf = np.asarray(results["smpl_betas"], np.float32)[..., :10]
    cam_trans = np.asarray(results["cam_trans"], np.float32)
    P, F_trace = thetas.shape[:2]

    frame_files = sorted(glob.glob(os.path.join(frames_dir, "*.png")) + glob.glob(os.path.join(frames_dir, "*.jpg")))
    end = min(end if end is not None else F_trace, F_trace, len(frame_files))
    sel = list(range(start, end, skip))
    images = [read_image(frame_files[f]) for f in sel]

    if K is None:
        H, W = images[0].shape[:2]
        focal = float(max(H, W))
        K = np.array([[focal, 0.0, W // 2], [0.0, focal, H // 2], [0.0, 0.0, 1.0]], np.float32)

    kp = keypoints_from_pj2d(results["pj2d_org"], kp_format)[sel]
    if keypoints_dir is not None:
        kp = load_keypoint_npys(keypoints_dir, kp, sel=sel)
    elif vitpose_checkpoint is not None:
        if kp_format != "coco17":
            raise ValueError("ViTPose inference emits COCO-17 keypoints")
        kp = vitpose_keypoints(images, kp, checkpoint=vitpose_checkpoint, device=device)

    # mean shape over the frames each track was detected in
    if "valid" in results:
        v = np.asarray(results["valid"], bool)[..., None]
        betas_mean = (betas_pf * v).sum(axis=1) / np.maximum(v.sum(axis=1), 1)
    else:
        betas_mean = betas_pf.mean(axis=1)

    return TraceInputs(
        images=images, poses=np.moveaxis(thetas, 0, 1)[sel], betas=betas_mean,
        trans=np.moveaxis(cam_trans, 0, 1)[sel], keypoints_2d=kp,
        genders=list(genders) if genders is not None else ["neutral"] * P, K=np.asarray(K, np.float32),
    )
