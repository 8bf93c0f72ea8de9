"""Preprocessing: tracked SMPL estimates and keypoints -> training directory.

Counterpart of `multiply_tpu/preprocessing/pipeline.py`, without OpenCV:

  1. external: frame extraction, TRACE tracking, keypoints (`TraceInputs`);
  2. mask: PnP translation init from the SMPL joints and the keypoints;
  3. refine: keypoint refinement (`refine.py`), on the device;
  4. final: downscale (`utils/resize.resize_linear`, OpenCV's INTER_LINEAR),
     SMPL masks from the host z-buffer dilated by a 20 x 20 box
     (`data/dataset.dilate_box`), per-frame scene centering, and
     image/*.png, mask/<p>/*.png (`utils/io.write_png`), poses.npy,
     normalize_trans.npy, mean_shape.npy, gender.npy, cameras.npz,
     max_human_sphere.npy;
  5. camera normalisation -> cameras_normalize.npz.

The SMPL forwards run once a frame for all persons on the servers' device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..body.server import SMPLServer, smpl_server_forward, stack_servers
from ..data.dataset import dilate_box
from ..engine.instance_masks import project_depth
from ..native import rasterize_depth
from ..utils.io import write_png
from ..utils.resize import resize_linear
from .cameras import estimate_translation_pnp, max_human_sphere_radius, normalize_cameras
from .refine import SMPL_TO_COCO17, SMPL_TO_OPENPOSE25, RefineConfig, refine_sequence

FILES = ("poses.npy", "normalize_trans.npy", "mean_shape.npy", "gender.npy", "max_human_sphere.npy",
         "cameras.npz", "cameras_normalize.npz")


@dataclass
class TraceInputs:
    """Tracker outputs per person, indexed [frame, person, ...]."""

    images: list[np.ndarray]  # F x (H, W, 3) uint8 RGB
    poses: np.ndarray  # (F, P, 72) axis-angle
    betas: np.ndarray  # (P, 10)
    trans: np.ndarray  # (F, P, 3) camera-space translations (may be coarse)
    keypoints_2d: np.ndarray  # (F, P, 17 | 25, 3) keypoints and confidence
    genders: list[str]
    K: np.ndarray  # (3, 3) intrinsics


def _posed(server: SMPLServer, transl, poses, betas) -> dict:
    """All persons of a stacked server, posed, on its device."""
    dev = server.verts_c.device
    P = server.betas.shape[0]

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    with torch.no_grad():
        return smpl_server_forward(server, torch.ones(P, device=dev), t(transl), t(poses), t(betas))


def init_translations_pnp(servers: list[SMPLServer], inputs: TraceInputs) -> np.ndarray:
    """(F, P, 3) EPnP translations of the SMPL joints against the keypoints
    where at least 6 keypoints have confidence > 0.3, else the tracker's."""
    F, P = inputs.poses.shape[:2]
    joint_map = SMPL_TO_COCO17 if inputs.keypoints_2d.shape[2] == 17 else SMPL_TO_OPENPOSE25
    has = joint_map >= 0
    server = stack_servers(servers)
    out = np.zeros((F, P, 3), np.float32)
    for f in range(F):
        joints = _posed(server, np.zeros((P, 3)), inputs.poses[f], inputs.betas)["smpl_all_jnts"].cpu().numpy()
        for p in range(P):
            j3d = joints[p][np.maximum(joint_map, 0)]
            kp = inputs.keypoints_2d[f, p]
            conf = (kp[:, 2] > 0.3) & has
            out[f, p] = (estimate_translation_pnp(j3d[conf], kp[conf, :2], inputs.K) if conf.sum() >= 6
                         else inputs.trans[f, p])
    return out


def finalize_sequence(out_root: str, inputs: TraceInputs, servers: list[SMPLServer], poses: np.ndarray,
                      trans: np.ndarray, betas: np.ndarray, scale_factor: int = 2, mask_dilate: int = 20,
                      scene_bounding_sphere: float = 3.0) -> None:
    """The `final` stage and the camera normalisation: write the training
    directory from refined poses (F, P, 72), translations (F, P, 3) and the
    mean shape (P, 10)."""
    F, P = poses.shape[:2]
    H, W = inputs.images[0].shape[:2]
    Hs, Ws = H // scale_factor, W // scale_factor
    K = inputs.K.copy()
    K[:2] /= scale_factor
    os.makedirs(os.path.join(out_root, "image"), exist_ok=True)
    for p in range(P):
        os.makedirs(os.path.join(out_root, "mask", str(p)), exist_ok=True)

    server = stack_servers(servers)
    faces = [s.model.faces.cpu().numpy() for s in servers]
    normalize_trans = trans.copy()
    all_verts, P_mats = [], {}
    Rt = np.eye(4, dtype=np.float32)[:3]
    for f in range(F):
        write_png(os.path.join(out_root, "image", f"{f:04d}.png"), resize_linear(inputs.images[f], (Ws, Hs)))
        # per-frame scene centering: the persons' mean goes to the origin, the camera the other way
        shift = trans[f].mean(axis=0)
        normalize_trans[f] = trans[f] - shift
        Rt_f = Rt.copy()
        Rt_f[:3, 3] += Rt[:3, :3] @ shift
        P_mat = np.eye(4, dtype=np.float32)
        P_mat[:3, :4] = K @ Rt_f
        P_mats[f"cam_{f}"] = P_mat
        verts = _posed(server, normalize_trans[f], poses[f], betas)["smpl_verts"].cpu().numpy()
        for p in range(P):
            all_verts.append(verts[p])
            depth = rasterize_depth(project_depth(P_mat, verts[p]).astype(np.float32), faces[p], Ws, Hs)
            mask = dilate_box((np.isfinite(depth) * 255).astype(np.uint8), mask_dilate)
            write_png(os.path.join(out_root, "mask", str(p), f"{f:04d}.png"), mask)

    np.save(os.path.join(out_root, "poses.npy"), poses.astype(np.float32))
    np.save(os.path.join(out_root, "normalize_trans.npy"), normalize_trans.astype(np.float32))
    np.save(os.path.join(out_root, "mean_shape.npy"), betas.astype(np.float32))
    np.save(os.path.join(out_root, "gender.npy"), np.asarray(inputs.genders))
    sphere = max_human_sphere_radius(np.concatenate(all_verts))
    np.save(os.path.join(out_root, "max_human_sphere.npy"), sphere)
    np.savez(os.path.join(out_root, "cameras.npz"), **P_mats)
    normalized = normalize_cameras(P_mats, max_human_sphere=sphere, scene_bounding_sphere=scene_bounding_sphere)
    np.savez(os.path.join(out_root, "cameras_normalize.npz"), **normalized)


def preprocess_sequence(out_root: str, inputs: TraceInputs, servers: list[SMPLServer], refine_iters: int = 150,
                        scale_factor: int = 2) -> dict:
    """The whole chain from tracker outputs to a training directory. The
    keypoint layout follows the keypoint count (17 COCO, 25 BODY_25). Returns
    the seconds of each stage: {"pnp": s, "refine": s, "finalize": s}."""
    dev = servers[0].verts_c.device
    seconds = {}
    t0 = time.perf_counter()
    trans0 = init_translations_pnp(servers, inputs)
    seconds["pnp"] = time.perf_counter() - t0

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    cfg = RefineConfig(iters=refine_iters, is_vitpose=inputs.keypoints_2d.shape[2] == 17)
    poses, trans, betas = (x.cpu().numpy() for x in refine_sequence(
        stack_servers(servers), t(inputs.K), torch.eye(3, device=dev), torch.zeros(3, device=dev),
        t(inputs.poses), t(trans0), t(inputs.betas), t(inputs.keypoints_2d), cfg))
    seconds["refine"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    finalize_sequence(out_root, inputs, servers, poses, trans, betas, scale_factor=scale_factor)
    seconds["finalize"] = time.perf_counter() - t0
    return seconds
