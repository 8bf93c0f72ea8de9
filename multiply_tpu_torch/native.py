"""ctypes bindings for the native host C++ layer: the MISE octree, marching
tetrahedra and the z-buffer depth rasterizer.

Counterpart of `multiply_tpu/native.py`, over the same sources in
`native/src/`, which this package compiles itself into
`multiply_tpu_torch/_build/libmultiply_host.so` on first use
(`cuda_build.build_host`); it never loads a library built elsewhere. The
device stays the compute engine: MISE hands batches of query points to an SDF
evaluated on the card; the octree bookkeeping, the triangulation and the depth
maps run on the host.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from . import cuda_build

NATIVE_SRC = os.path.join(os.path.dirname(cuda_build.PKG_DIR), "native", "src")
SOURCES = ("mise.cpp", "marching.cpp", "rasterizer.cpp")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build_host("multiply_host", [os.path.join(NATIVE_SRC, s) for s in SOURCES]))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.mise_create.restype = ctypes.c_void_p
    lib.mise_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mise_destroy.restype = None
    lib.mise_destroy.argtypes = [ctypes.c_void_p]
    lib.mise_resolution.restype = ctypes.c_int
    lib.mise_resolution.argtypes = [ctypes.c_void_p]
    lib.mise_query.restype = ctypes.c_int64
    lib.mise_query.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
    lib.mise_update.restype = None
    lib.mise_update.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.mise_num_active.restype = ctypes.c_int64
    lib.mise_num_active.argtypes = [ctypes.c_void_p]
    lib.mise_to_dense.restype = None
    lib.mise_to_dense.argtypes = [ctypes.c_void_p, f32p]

    lib.march_run.restype = ctypes.c_void_p
    lib.march_run.argtypes = [f32p, ctypes.c_int64, ctypes.c_float]
    lib.march_num_verts.restype = ctypes.c_int64
    lib.march_num_verts.argtypes = [ctypes.c_void_p]
    lib.march_num_faces.restype = ctypes.c_int64
    lib.march_num_faces.argtypes = [ctypes.c_void_p]
    lib.march_get.restype = None
    lib.march_get.argtypes = [ctypes.c_void_p, f32p, i64p]
    lib.march_destroy.restype = None
    lib.march_destroy.argtypes = [ctypes.c_void_p]

    lib.rasterize_depth.restype = None
    lib.rasterize_depth.argtypes = [
        f32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, f32p, ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class MISE:
    """Octree isosurface refinement: query() -> evaluate the SDF -> update()."""

    def __init__(self, resolution_0: int, depth: int, threshold: float):
        self._lib = _lib()
        self._h = self._lib.mise_create(resolution_0, depth, float(threshold))
        self.resolution = self._lib.mise_resolution(self._h)

    def query(self) -> np.ndarray:
        """Full-grid integer coordinates (N, 3) of the points to evaluate next."""
        n = self._lib.mise_query(self._h, None, 0)
        out = np.empty((n, 3), np.int64)
        if n:
            self._lib.mise_query(self._h, _ip(out), n)
        return out

    def update(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float32)
        self._lib.mise_update(self._h, _fp(values), len(values))

    @property
    def num_active(self) -> int:
        return self._lib.mise_num_active(self._h)

    def to_dense(self) -> np.ndarray:
        n = self.resolution + 1
        out = np.empty((n, n, n), np.float32)
        self._lib.mise_to_dense(self._h, _fp(out))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mise_destroy(self._h)
            self._h = None


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate the iso level of a cubic grid: (verts (V, 3) in grid
    coordinates, faces (F, 3) int64)."""
    lib = _lib()
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3 or not grid.shape[0] == grid.shape[1] == grid.shape[2]:
        raise ValueError(f"marching_tetrahedra takes a cubic grid, got {grid.shape}")
    h = lib.march_run(_fp(grid), grid.shape[0], float(iso))
    nv, nf = lib.march_num_verts(h), lib.march_num_faces(h)
    verts = np.empty((nv, 3), np.float32)
    faces = np.empty((nf, 3), np.int64)
    lib.march_get(h, _fp(verts), _ip(faces))
    lib.march_destroy(h)
    return verts, faces


def rasterize_depth(verts_pix: np.ndarray, faces: np.ndarray, width: int, height: int,
                    return_face_id: bool = False):
    """Z-buffer of a mesh whose vertices are (x pixel, y pixel, camera depth):
    (height, width) float32 depth, inf where no face covers the pixel, and with
    `return_face_id` the (height, width) int32 index of the face seen there."""
    lib = _lib()
    verts_pix = np.ascontiguousarray(verts_pix, np.float32)
    faces = np.ascontiguousarray(faces, np.int64)
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts_pix)):
        raise ValueError("rasterize_depth: face index out of range")
    depth = np.empty((height, width), np.float32)
    fid = np.empty((height, width), np.int32) if return_face_id else None
    lib.rasterize_depth(_fp(verts_pix), len(verts_pix), _ip(faces), len(faces), width, height, _fp(depth),
                        fid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if return_face_id else None)
    return (depth, fid) if return_face_id else depth
