"""SMPL nearest-vertex skinning deformer: posed space <-> canonical space.

Counterpart of `multiply_tpu/models/deformer.py`. All tensors may carry a
leading person axis; then one `nn1` launch serves every person.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .server import SMPLServer
from .skinning import (
    affine_apply_rows,
    affine_inverse_apply_rows,
    blend_affine_rows,
    query_skinning_weights,
)


class SMPLDeformer(NamedTuple):
    verts_c: torch.Tensor  # (..., V, 3) canonical verts
    weights_c: torch.Tensor  # (..., V, J) canonical LBS weights

    @staticmethod
    def create(server: SMPLServer) -> "SMPLDeformer":
        return SMPLDeformer(verts_c=server.verts_c, weights_c=server.weights_c)

    def query_weights(self, x, smpl_verts=None, k: int = 1):
        """Blended skinning weights for points x (..., N, 3) and the outlier
        mask (..., N); KNN against `smpl_verts` (posed) or the canonical verts."""
        verts = self.verts_c if smpl_verts is None else smpl_verts
        return query_skinning_weights(x, verts, self.weights_c, k=k)

    def inverse(self, x_d, smpl_tfs, smpl_verts, k: int = 1):
        """Deformed -> canonical warp: (x_c (..., N, 3), outlier (..., N))."""
        weights, outlier = self.query_weights(x_d, smpl_verts=smpl_verts, k=k)
        return affine_inverse_apply_rows(blend_affine_rows(weights, smpl_tfs), x_d), outlier

    def forward(self, x_c, smpl_tfs, k: int = 1):
        """Canonical -> deformed warp (weights from the canonical KNN)."""
        weights, _ = self.query_weights(x_c, k=k)
        return affine_apply_rows(blend_affine_rows(weights, smpl_tfs), x_c)

    def forward_jacobian_rows(self, x_c, smpl_tfs, k: int = 1):
        """(deformed points, blended affine as (..., 12, N) rows). The weights
        are detached, so the rotation block is the exact Jacobian of the warp."""
        weights, _ = self.query_weights(x_c, k=k)
        m = blend_affine_rows(weights, smpl_tfs)
        return affine_apply_rows(m, x_c), m
