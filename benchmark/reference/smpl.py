"""SMPL body model as plain functions on tensors.

Counterpart of `multiply_tpu/body/smpl.py`: shape and pose blend shapes,
Rodrigues, the kinematic chain and linear blend skinning. Every function takes
optional leading batch dimensions (persons), so a stacked `BodyModel` and
stacked betas/poses run in one call.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int64,
)
NUM_JOINTS = 24
NUM_BETAS = 10
FACE_VERTEX_IDS = {"nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583}


class BodyModel(NamedTuple):
    """Tensor bundle for one SMPL-topology body model (or a stack of them)."""

    v_template: torch.Tensor  # (..., V, 3)
    shapedirs: torch.Tensor  # (..., V, 3, NB)
    posedirs: torch.Tensor  # (..., (J-1)*9, V*3)
    joint_regressor: torch.Tensor  # (..., J, V)
    lbs_weights: torch.Tensor  # (..., V, J)
    faces: torch.Tensor  # (..., F, 3) int64
    extra_joint_idxs: torch.Tensor  # (..., E) int64

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[-2]


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), with the +1e-8
    norm regularizer of the reference batch_rodrigues."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir.unbind(-1)
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1)
    K = K.reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor):
    """(..., J, 3, 3) rotations + (..., J, 3) rest joints -> posed joints
    (..., J, 3) and per-joint transforms A (..., J, 4, 4) acting on rest points."""
    parents = SMPL_PARENTS
    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[..., :1, :]), joints[..., parents[1:], :]], dim=-2
    )
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)  # (..., J, 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    local_tfs = torch.cat([top, bottom], dim=-2)  # (..., J, 4, 4)

    chain = [local_tfs[..., 0, :, :]]
    for j in range(1, NUM_JOINTS):
        chain.append(chain[parents[j]] @ local_tfs[..., j, :, :])
    transforms = torch.stack(chain, dim=-3)

    posed_joints = transforms[..., :3, 3]
    correction = torch.einsum("...jab,...jb->...ja", transforms[..., :3, :3], joints)
    A = torch.cat(
        [
            torch.cat(
                [transforms[..., :3, :3], (transforms[..., :3, 3] - correction)[..., None]],
                dim=-1,
            ),
            transforms[..., 3:, :],
        ],
        dim=-2,
    )
    return posed_joints, A


def lbs(
    model: BodyModel,
    betas: torch.Tensor,  # (..., NB)
    full_pose: torch.Tensor,  # (..., J*3)
    v_template: torch.Tensor | None = None,
    pose_blend: bool = True,
) -> dict:
    """Linear blend skinning. Returns verts (..., V, 3), joints (..., J, 3),
    all_joints (..., J+E, 3), A (..., J, 4, 4), T (..., V, 4, 4), W (..., V, J),
    v_posed (..., V, 3)."""
    if v_template is None:
        v_shaped = model.v_template + torch.einsum("...l,...mkl->...mk", betas, model.shapedirs)
    else:
        v_shaped = v_template

    joints = model.joint_regressor @ v_shaped  # (..., J, 3)
    rot_mats = rodrigues(full_pose.reshape(full_pose.shape[:-1] + (NUM_JOINTS, 3)))

    if pose_blend:
        ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
        pose_feature = (rot_mats[..., 1:, :, :] - ident).flatten(-3)  # (..., (J-1)*9)
        pose_offsets = torch.einsum("...k,...kv->...v", pose_feature, model.posedirs)
        v_posed = v_shaped + pose_offsets.reshape(pose_offsets.shape[:-1] + (-1, 3))
    else:
        v_posed = v_shaped

    posed_joints, A = _rigid_transform_chain(rot_mats, joints)
    W = model.lbs_weights
    T = torch.einsum("...vj,...jab->...vab", W, A)
    verts = torch.einsum("...vab,...vb->...va", T[..., :3, :3], v_posed) + T[..., :3, 3]
    # ids past the last vertex (the face keypoints' fixed ids on a body with
    # fewer than 6890 vertices) read the last vertex, as JAX's gather clamps
    idx = model.extra_joint_idxs.clamp(max=verts.shape[-2] - 1)
    if idx.dim() == 1:
        extra = verts[..., idx, :]
    else:
        extra = torch.take_along_dim(verts, idx[..., None], dim=-2)
    all_joints = torch.cat([posed_joints, extra], dim=-2)
    return {
        "verts": verts,
        "joints": posed_joints,
        "all_joints": all_joints,
        "A": A,
        "T": T,
        "W": W,
        "v_posed": v_posed,
    }


# ---------------------------------------------------------------------------
# Loading real SMPL pickles (chumpy-free) and synthesizing test models.
# ---------------------------------------------------------------------------


class _ChumpyStubUnpickler(pickle.Unpickler):
    """Unpickle MPI SMPL .pkl files without chumpy installed."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):

            class _Ch:
                def __setstate__(self, state):
                    self.__dict__.update(state)

                @property
                def r(self):
                    return np.asarray(self.__dict__.get("x"))

            return _Ch
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "r"):
        x = x.r
    if hasattr(x, "toarray"):  # scipy sparse J_regressor
        x = x.toarray()
    return np.asarray(x)


def _from_numpy(v_template, shapedirs, posedirs, j_regressor, weights, faces, extra, device):
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return BodyModel(
        v_template=t(v_template, torch.float32),
        shapedirs=t(shapedirs, torch.float32),
        posedirs=t(posedirs, torch.float32),
        joint_regressor=t(j_regressor, torch.float32),
        lbs_weights=t(weights, torch.float32),
        faces=t(faces, torch.int64),
        extra_joint_idxs=t(extra, torch.int64),
    )


def load_smpl_model(
    model_path: str, gender: str = "neutral", num_betas: int = NUM_BETAS, device="cuda"
) -> BodyModel:
    """Load an MPI SMPL pickle (v1.x): a directory holding SMPL_{GENDER}.pkl or a file."""
    path = (
        os.path.join(model_path, f"SMPL_{gender.upper()}.pkl")
        if os.path.isdir(model_path)
        else model_path
    )
    with open(path, "rb") as f:
        data = _ChumpyStubUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    extra = [FACE_VERTEX_IDS[k] for k in ("nose", "reye", "leye", "rear", "lear")]
    return _from_numpy(
        _to_np(data["v_template"]),
        _to_np(data["shapedirs"])[:, :, :num_betas],
        posedirs.reshape(-1, posedirs.shape[-1]).T,
        _to_np(data["J_regressor"]),
        _to_np(data["weights"]),
        _to_np(data["f"]),
        extra,
        device,
    )


def synthetic_body_model(
    num_verts: int = 386, seed: int = 0, num_betas: int = NUM_BETAS, device="cuda"
) -> BodyModel:
    """Small closed "capsule person" with SMPL joint topology, for tests/demos.

    The same arrays as `multiply_tpu.body.smpl.synthetic_body_model` with the
    same arguments (numpy, seeded), so both packages see one body.
    """
    rng = np.random.default_rng(seed)
    J = np.array(
        [
            (0.0, 0.0, 0.0), (0.07, -0.08, 0.0), (-0.07, -0.08, 0.0), (0.0, 0.11, 0.0),
            (0.10, -0.48, 0.0), (-0.10, -0.48, 0.0), (0.0, 0.25, 0.0), (0.09, -0.88, 0.0),
            (-0.09, -0.88, 0.0), (0.0, 0.31, 0.0), (0.11, -0.95, 0.10), (-0.11, -0.95, 0.10),
            (0.0, 0.46, 0.0), (0.08, 0.38, 0.0), (-0.08, 0.38, 0.0), (0.0, 0.56, 0.0),
            (0.17, 0.40, 0.0), (-0.17, 0.40, 0.0), (0.43, 0.40, 0.0), (-0.43, 0.40, 0.0),
            (0.68, 0.40, 0.0), (-0.68, 0.40, 0.0), (0.76, 0.40, 0.0), (-0.76, 0.40, 0.0),
        ],
        dtype=np.float32,
    )

    n_ring, n_seg = 8, (num_verts - 2) // 8
    ys = np.linspace(-1.0, 0.62, n_seg)
    radius = 0.22
    verts, faces = [], []
    for i, y in enumerate(ys):
        for k in range(n_ring):
            a = 2 * np.pi * k / n_ring
            r = radius * (0.9 + 0.2 * np.sin(i * 1.7))
            verts.append((r * np.cos(a), y, r * np.sin(a)))
    for i in range(n_seg - 1):
        for k in range(n_ring):
            a0, a1 = i * n_ring + k, i * n_ring + (k + 1) % n_ring
            b0, b1 = a0 + n_ring, a1 + n_ring
            faces.append((a0, b0, a1))
            faces.append((a1, b0, b1))
    bot = len(verts)
    verts.append((0.0, ys[0] - 0.05, 0.0))
    top = len(verts)
    verts.append((0.0, ys[-1] + 0.05, 0.0))
    for k in range(n_ring):
        faces.append((k, (k + 1) % n_ring, bot))
        base = (n_seg - 1) * n_ring
        faces.append((base + (k + 1) % n_ring, base + k, top))

    v_template = np.array(verts, dtype=np.float32)
    faces = np.array(faces, dtype=np.int64)
    V = v_template.shape[0]

    d = np.linalg.norm(v_template[:, None, :] - J[None, :, :], axis=-1)
    w = np.exp(-d / 0.08)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    j_regressor = np.zeros((NUM_JOINTS, V), dtype=np.float32)
    for j in range(NUM_JOINTS):
        j_regressor[j, np.argsort(d[:, j])[:4]] = 0.25

    shapedirs = (rng.standard_normal((V, 3, num_betas)) * 0.01).astype(np.float32)
    posedirs = (rng.standard_normal(((NUM_JOINTS - 1) * 9, V * 3)) * 1e-4).astype(np.float32)
    extra = rng.integers(0, V, size=5)
    return _from_numpy(
        v_template, shapedirs, posedirs, j_regressor, lbs_weights, faces, extra, device
    )
