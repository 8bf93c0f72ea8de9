"""Write a synthetic body model as an MPI-format SMPL pickle.

Counterpart of `multiply_tpu/body/synthetic_pickle.py`: the dict layout of
the licensed SMPL pickles (v_template, shapedirs (V, 3, NB), posedirs
(V, 3, (J-1)*9), J_regressor (J, V), weights (V, J), kintree_table (2, J), f)
as float64 arrays, `f` uint32, pickle protocol 2, written from the port's
`BodyModel`, so `load_smpl_model` of either package reads it. The default
6890 vertices is real SMPL's count: the face keypoints' fixed vertex ids
(`smpl.FACE_VERTEX_IDS`, up to 6260) then index real vertices.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .smpl import NUM_JOINTS, SMPL_PARENTS, BodyModel, synthetic_body_model

GENDERS = ("male", "female", "neutral")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def body_model_to_mpi_dict(model: BodyModel) -> dict:
    """Invert `load_smpl_model`'s read transforms back to the pickle layout."""
    V = int(model.v_template.shape[-2])
    posedirs = _np(model.posedirs).astype(np.float64)  # ((J-1)*9, V*3)
    kintree = np.stack([SMPL_PARENTS.astype(np.int64), np.arange(NUM_JOINTS, dtype=np.int64)])
    kintree[0, 0] = -1
    return {
        "v_template": _np(model.v_template).astype(np.float64),
        "shapedirs": _np(model.shapedirs).astype(np.float64),
        "posedirs": posedirs.T.reshape(V, 3, (NUM_JOINTS - 1) * 9),
        "J_regressor": _np(model.joint_regressor).astype(np.float64),
        "weights": _np(model.lbs_weights).astype(np.float64),
        "kintree_table": kintree,
        "f": _np(model.faces).astype(np.uint32),
    }


def write_mpi_pickle(model: BodyModel, path: str) -> str:
    with open(path, "wb") as f:
        pickle.dump(body_model_to_mpi_dict(model), f, protocol=2)
    return path


def write_synthetic_smpl_dir(out_dir: str, num_verts: int = 6890, seed: int = 0) -> str:
    """SMPL_{MALE,FEMALE,NEUTRAL}.pkl, one shared synthetic body, in `out_dir`
    (the layout of a directory of the licensed models)."""
    os.makedirs(out_dir, exist_ok=True)
    model = synthetic_body_model(num_verts=num_verts, seed=seed, device="cpu")
    for g in GENDERS:
        write_mpi_pickle(model, os.path.join(out_dir, f"SMPL_{g.upper()}.pkl"))
    return out_dir
