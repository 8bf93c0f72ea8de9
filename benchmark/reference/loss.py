"""Training losses with epoch-keyed schedules.

Counterpart of `multiply_tpu/models/loss.py`: L1 RGB, eikonal, BCE opacity
(with the clamp before the logs), in-shape, SAM instance-mask clip loss,
temporal pose smoothness, the SMPL-surface clamp, depth-order decay and
zero-pose decay. Masked means replace boolean indexing so every term keeps a
fixed shape.

Rays split over ranks (`parallel/sharding.py`): with a `RayShare`, each term
is this rank's share of the whole batch's term, so that the shares sum to the
one-device loss. A per-ray mean is the rank's own mean times its count over
the whole batch's (one all-reduce of the counts a step): an average of the
ranks' means is a different loss whenever their counts differ. A term that
reads no per-ray data (eikonal, temporal, SMPL surface, zero pose) is computed
whole on every rank and weighted 1/W.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LossConfig(NamedTuple):
    eikonal_weight: float = 0.1
    bce_weight: float = 5e-3
    opacity_sparse_weight: float = 3e-3
    in_shape_weight: float = 1e-2
    sam_mask_weight: float = 3e-2
    smpl_surface_weight: float = 0.0
    zero_pose_weight: float = 0.0
    temporal_loss_weight: float = 1.0
    sam_start_epoch: int = 200
    increase_sam: bool = False
    milestone: int = 200
    smpl_surface_milestone: int = 800
    depth_loss_milestone: int = 1000
    zero_pose_milestone: int = 1000
    depth_order_weight: float = 0.005
    silhouette_weight: float = 0.0
    interpenetration_weight: float = 0.0
    eps: float = 1e-6

    @staticmethod
    def from_config(opt) -> "LossConfig":
        return LossConfig(
            eikonal_weight=opt.eikonal_weight,
            bce_weight=opt.bce_weight,
            opacity_sparse_weight=opt.opacity_sparse_weight,
            in_shape_weight=opt.in_shape_weight,
            sam_mask_weight=opt.sam_mask_weight,
            smpl_surface_weight=opt.get("smpl_surface_weight", 0),
            zero_pose_weight=opt.get("zero_pose_weight", 0),
            temporal_loss_weight=opt.get("temporal_loss_weight", 1.0),
            sam_start_epoch=opt.get("sam_start_epoch", 200),
            increase_sam=bool(opt.get("increase_sam", False)),
            milestone=opt.get("milestone", 200),
            smpl_surface_milestone=opt.get("smpl_surface_milestone", 800),
            depth_loss_milestone=opt.get("depth_loss_milestone", 1000),
            zero_pose_milestone=opt.get("zero_pose_milestone", 1000),
            depth_order_weight=opt.get("depth_order_weight", 0.005),
            silhouette_weight=opt.get("silhouette_weight", 0.0),
            interpenetration_weight=opt.get("interpenetration_loss_weight", 0.0),
        )


class RayShare(NamedTuple):
    """This call sees one rank's share of a ray batch split over `world`
    ranks; `sum` adds a tensor over the ranks, in place (a detached all-reduce)."""

    world: int
    sum: Callable[[torch.Tensor], torch.Tensor]


def ray_fractions(share: RayShare, outputs: dict) -> torch.Tensor:
    """This rank's count over the whole batch's, of the finite colours (the
    L1 term's mask), of the rays (the opacity and SAM terms) and of the rays
    through the SMPL interior (the in-shape term): (3,), detached. Each is
    exactly 1 on one rank."""
    rgb = outputs["rgb_values"]
    inside = outputs.get("index_in_surface")
    local = torch.stack([
        torch.isfinite(rgb).all(-1).sum(), torch.tensor(rgb.shape[0], device=rgb.device),
        inside.sum() if inside is not None else torch.zeros((), dtype=torch.long, device=rgb.device),
    ]).float()
    return local / share.sum(local.clone()).clamp_min(1.0)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over masked entries; 0 when the mask is empty."""
    s = torch.where(mask, x, torch.zeros_like(x)).sum()
    n = mask.sum()
    return torch.where(n > 0, s / n.clamp_min(1), _zero(s))


def rgb_l1(rgb_values: torch.Tensor, rgb_gt: torch.Tensor) -> torch.Tensor:
    """L1 with per-pixel non-finite filtering."""
    finite = torch.isfinite(rgb_values).all(-1, keepdim=True)
    zero = torch.zeros_like(rgb_values)
    err = (torch.where(finite, rgb_values, zero) - torch.where(finite, rgb_gt, zero)).abs()
    return masked_mean(err, finite.expand_as(err))


def eikonal(grad_theta: torch.Tensor) -> torch.Tensor:
    return ((grad_theta.norm(dim=-1) - 1.0) ** 2).mean()


def bce_opacity(acc_map: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Entropy sharpening of accumulated opacity. acc is clamped to [0, 1]
    before the logs: composite rounding can push it past 1, and a NaN there
    would poison every gradient upstream (masking the value does not stop it)."""
    a = acc_map.clamp(0.0, 1.0)
    loss = -(a * torch.log(a + eps) + (1 - a) * torch.log(1 - a + eps)).mean() * 2
    return torch.where(torch.isfinite(loss), loss, _zero(loss))


def in_shape(acc_map: torch.Tensor, index_in_surface: torch.Tensor) -> torch.Tensor:
    """Pull opacity toward 1 on rays through the SMPL interior."""
    loss = masked_mean((acc_map - 1.0).abs(), index_in_surface)
    return torch.where(torch.isfinite(loss), loss, _zero(loss))


def sam_mask_clip(sam_mask_logits: torch.Tensor, acc_person: torch.Tensor) -> torch.Tensor:
    """Per-person opacity vs sigmoid(SAM logits), skipping pixels where both
    confidently agree, normalized by pixels x persons."""
    n_pix, n_person = sam_mask_logits.shape
    sam = torch.sigmoid(sam_mask_logits)
    valid = (sam.sum(1) <= 1.0 + 1e-2)[:, None]
    min_min = (acc_person < 0.04) & (sam < 0.04)
    max_max = (acc_person > 0.96) & (sam > 0.96)
    clip = ~(min_min | max_max) & valid
    diff = (acc_person - sam).abs()
    return torch.where(clip, diff, torch.zeros_like(diff)).sum() / (n_pix * n_person)


def depth_order(t_front: torch.Tensor, t_correct: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softplus ranking that pushes the person SAM says owns a pixel (depth
    `t_correct`) in front of the geometrically frontmost one (`t_front`),
    summed over the `valid` pixels where both are defined."""
    rank = torch.log1p(torch.exp(t_correct - t_front))
    return torch.where(valid, rank, torch.zeros_like(rank)).sum()


def total_loss(cfg: LossConfig, outputs: dict, rgb_gt: torch.Tensor, epoch: int,
               sam_mask_logits: torch.Tensor | None = None,
               depth_order_loss: torch.Tensor | None = None,
               share: RayShare | None = None) -> tuple[torch.Tensor, dict]:
    """Combine all terms with the reference's epoch schedules; with `share`,
    each term (and the total) is this rank's share of the whole batch's."""
    epoch = float(epoch)
    rgb_loss = rgb_l1(outputs["rgb_values"], rgb_gt)
    zero = _zero(rgb_loss)
    eik_loss = eikonal(outputs["grad_theta"])
    bce_loss = bce_opacity(outputs["acc_map"], cfg.eps)
    opacity_sparse_loss = zero  # disabled in the reference

    in_shape_loss = zero
    if outputs.get("index_in_surface") is not None and epoch < 250:
        in_shape_loss = in_shape(outputs["acc_map"], outputs["index_in_surface"])

    curr = min(float(cfg.milestone), epoch)
    temporal_loss = outputs.get("temporal_loss", zero)
    smpl_surface_loss = outputs.get("smpl_surface_loss", zero) * cfg.smpl_surface_weight
    sam_loss = zero
    if sam_mask_logits is not None and epoch >= cfg.sam_start_epoch:
        sam_loss = sam_mask_clip(sam_mask_logits, outputs["acc_person_list"])
    if depth_order_loss is None or epoch < cfg.sam_start_epoch:
        depth_order_loss = zero
    else:
        depth_order_loss = depth_order_loss * (
            1.0 - min(float(cfg.depth_loss_milestone), epoch) / cfg.depth_loss_milestone
        )
    zero_pose_loss = (
        outputs.get("zero_pose_loss", zero) * cfg.zero_pose_weight
        * (1.0 - min(float(cfg.zero_pose_milestone), epoch) / cfg.zero_pose_milestone)
    )
    increase = min(1.0, epoch / 100.0) if cfg.increase_sam else 1.0
    if share is not None:
        f_rgb, f_ray, f_in = ray_fractions(share, outputs).unbind()
        rgb_loss, bce_loss, in_shape_loss, sam_loss = (
            rgb_loss * f_rgb, bce_loss * f_ray, in_shape_loss * f_in, sam_loss * f_ray)
        eik_loss, temporal_loss, smpl_surface_loss, zero_pose_loss = (
            t / share.world for t in (eik_loss, temporal_loss, smpl_surface_loss, zero_pose_loss))

    loss = (
        rgb_loss
        + cfg.eikonal_weight * eik_loss
        + cfg.bce_weight * bce_loss
        + cfg.opacity_sparse_weight * (1 + curr**2 / 40) * opacity_sparse_loss
        + cfg.in_shape_weight * (1 - curr / cfg.milestone) * in_shape_loss
        + temporal_loss * cfg.temporal_loss_weight
        + cfg.sam_mask_weight * sam_loss * increase
        + smpl_surface_loss * (1 - min(float(cfg.smpl_surface_milestone), epoch) / cfg.smpl_surface_milestone)
        + depth_order_loss
        + zero_pose_loss
    )
    return loss, {
        "loss": loss,
        "rgb_loss": rgb_loss,
        "eikonal_loss": eik_loss,
        "bce_loss": bce_loss,
        "opacity_sparse_loss": opacity_sparse_loss,
        "in_shape_loss": in_shape_loss,
        "temporal_loss": temporal_loss,
        "sam_mask_loss": sam_loss,
        "smpl_surface_loss": smpl_surface_loss,
        "depth_order_loss": depth_order_loss,
        "zero_pose_loss": zero_pose_loss,
    }
