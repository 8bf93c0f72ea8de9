"""A `SyntheticScene` behind the `Hi4DSequence` interface, so the whole
trainer (epoch loop, refinement stages, opt_depth) runs without preprocessed
video data.

Counterpart of `multiply_tpu/data/synthetic_sequence.py`: the same draws from
the caller's generator in the same order.
"""

from __future__ import annotations

import numpy as np

from .dataset import SamPickup, SamPickupFields, edge_band, edge_sampling, weighted_sampling
from .synthetic import SyntheticScene


class SyntheticSequence(SamPickupFields):
    def __init__(self, scene: SyntheticScene, num_sample: int = 128, using_sam: bool = True,
                 ratio_uncertain: float = 0.5, run_dir: str = "."):
        self.scene = scene
        self.num_sample = num_sample
        self.using_sam = using_sam
        self.ratio_uncertain = ratio_uncertain
        self.run_dir = run_dir

        self.num_person = scene.betas.shape[0]
        self.shape = scene.betas
        self.poses = scene.poses
        self.trans = scene.transl
        self.scale = 1.0
        self.genders = ["neutral"] * self.num_person

        # projection P = K [R|t] of the scene camera (world -> pixel)
        Rt = np.linalg.inv(scene.cam_pose[0])[:3, :4]
        self._P = np.eye(4, dtype=np.float32)
        self._P[:3, :4] = scene.intrinsics @ Rt
        H, W = scene.height, scene.width
        self._uv = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), axis=-1).astype(np.float32)

        self.sam_pickup = SamPickup("", None, np.ones(len(scene.images)), 0.0)

    def __len__(self) -> int:
        return len(self.scene.images)

    def load_frame(self, idx: int) -> dict:
        """Full-image arrays in the `Hi4DSequence.load_frame` layout."""
        masks = [self.scene.masks[idx][..., p] for p in range(self.num_person)]
        return {"img": self.scene.images[idx], "mask_union": np.stack(masks, -1).sum(-1), "uv": self._uv,
                "masks": masks}

    def get_train_item(self, idx: int, rng: np.random.Generator) -> dict:
        if self.using_sam:
            self._refresh_sam()
        scene = self.scene
        data = {"rgb": scene.images[idx], "uv": self._uv, "object_mask": scene.masks[idx].any(-1)}
        pickup = self.sam_pickup
        sam = pickup.masks[idx] if pickup.masks is not None else scene.sam_logits[idx]
        data["sam_mask"] = sam
        samples, _ = weighted_sampling(data, (scene.height, scene.width), self.num_sample, rng)
        is_certain = bool(pickup.iou[idx] >= pickup.threshold)
        out = {
            "uv": samples["uv"].astype(np.float32),
            "rgb": samples["rgb"].astype(np.float32),
            "sam_mask": samples["sam_mask"].astype(np.float32),
            "intrinsics": scene.intrinsics,
            "pose": scene.cam_pose[idx],
            "P": self._P,
            "smpl_pose": scene.poses[idx],
            "smpl_trans": scene.transl[idx],
            "smpl_shape": scene.betas,
            "smpl_scale": scene.scale,
            "idx": idx,
            "is_certain": is_certain,
        }
        if not is_certain:
            # uncertain frames get 50/40/10 mask/edge/random rays for the
            # delayed-pose step; the edge band comes from the mask union
            person = data["object_mask"] > 0
            es = edge_sampling(
                {"rgb": data["rgb"], "uv": data["uv"], "sam_mask": sam, "person_mask": person,
                 "edge_mask": edge_band(person)},
                self.num_sample, rng,
            )
            out["edge_uv"] = es["uv"].astype(np.float32)
            out["edge_rgb"] = es["rgb"].astype(np.float32)
            out["edge_sam_mask"] = es["sam_mask"].astype(np.float32)
        return out

    def get_eval_item(self, idx: int) -> dict:
        scene = self.scene
        return {
            "uv": self._uv.reshape(-1, 2),
            "rgb": scene.images[idx].reshape(-1, 3),
            "intrinsics": scene.intrinsics,
            "pose": scene.cam_pose[idx],
            "P": self._P,
            "smpl_pose": scene.poses[idx],
            "smpl_trans": scene.transl[idx],
            "smpl_shape": scene.betas,
            "smpl_scale": scene.scale,
            "idx": idx,
            "img_size": (scene.height, scene.width),
            "masks": [scene.masks[idx][..., p] for p in range(self.num_person)],
        }
