"""Preprocessing camera utilities: PnP translation init and the camera
normalisation that fits the scene into the renderer's bounding sphere.

Counterpart of `multiply_tpu/preprocessing/cameras.py`, without OpenCV.
`estimate_translation_pnp` is what `cv2.solvePnPRansac(..., flags=
SOLVEPNP_EPNP, reprojectionError=20, iterationsCount=100)` does in OpenCV
5.0 with no distortion (its `calib3d/src/solvepnp.cpp`, `ptsetreg.cpp`,
`epnp.cpp`), in float64 numpy on the host:

  * The flag is not a USAC one, so the classic RANSAC runs: minimal sets of
    5 correspondences, each solved by EPnP; a point is an inlier when its
    squared reprojection error, in float32, is at most 20 ** 2; a model
    replaces the best one when it has more inliers than the best so far and
    at least 5; the iteration count then shrinks to
    round(log(0.01) / log(1 - w ** 5)), w the inlier share (confidence 0.99).
    With exactly 5 correspondences EPnP runs once on all of them.
  * Without a model of at least 5 inliers there is no answer
    (`INVALID_TRANS`). Otherwise EPnP runs again on all the inliers of the
    best model, and its translation is the result.
  * EPnP: four control points (the centroid and the principal axes scaled
    by sqrt(eigenvalue / n)), barycentric weights, the 12 x 12 system M^T M
    whose four smallest right singular vectors span the solution; three
    estimates of the betas (from 4, 3 and 5 unknowns of the 6 x 10 distance
    system), each refined by 5 Gauss-Newton steps, each giving R and t by
    Procrustes; the one with the least mean reprojection error is kept
    (N = 1, then 2, then 3 on strict improvement).

OpenCV draws its minimal sets from its own generator; the port's come from
`np.random.default_rng(seed)`, so only the final refit can be compared: with
all correspondences inliers, or with gross outliers that no reasonable model
takes in, both refit on the same set, and there they agree to 1e-13 relative
(`tests/test_torch_preprocessing.py`). That needs OpenCV's own SVD of the 3 x 3
PW0^T PW0 (`jacobi_svd`): its axes' signs choose the control points, and
mirrored ones give another answer once the pixels are noisy. The signs of the
other two SVDs cancel (the betas take the null vectors' signs; U V^T is one
rotation whatever the pairs' signs).
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.cameras import load_K_Rt_from_P

INVALID_TRANS = np.ones(3) * -1
MODEL_POINTS = 5


def jacobi_svd(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(singular values, U^T) of a small square float64 matrix by OpenCV's
    one-sided Jacobi SVD (`JacobiSVDImpl_` in its `core/src/lapack.cpp`, the
    double case), in its order and with its signs.

    The columns of `a` are rotated pairwise until orthogonal, each rotation
    taking the sign its formula gives; the singular values are the columns'
    norms, sorted by OpenCV's selection sort, and U^T's rows the normalised
    columns. A zero singular value leaves its row zero, where OpenCV draws a
    random vector orthogonal to the others."""
    at = np.array(a, np.float64).T.copy()
    n = len(at)
    eps = 10 * np.finfo(np.float64).eps
    w = (at * at).sum(1)
    for _ in range(max(n, 30)):
        changed = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                p = float(at[i] @ at[j])
                if abs(p) <= eps * math.sqrt(w[i] * w[j]):
                    continue
                p *= 2
                beta = w[i] - w[j]
                gamma = math.hypot(p, beta)
                if beta < 0:
                    s = math.sqrt((gamma - beta) * 0.5 / gamma)
                    c = p / (gamma * s * 2)
                else:
                    c = math.sqrt((gamma + beta) / (gamma * 2))
                    s = p / (gamma * c * 2)
                at[i], at[j] = c * at[i] + s * at[j], -s * at[i] + c * at[j]
                w[i], w[j] = at[i] @ at[i], at[j] @ at[j]
                changed = True
        if not changed:
            break
    w = np.sqrt((at * at).sum(1))
    for i in range(n - 1):
        j = i
        for k in range(i + 1, n):
            if w[j] < w[k]:
                j = k
        w[[i, j]], at[[i, j]] = w[[j, i]], at[[j, i]]
    inv = np.divide(1.0, w, out=np.zeros_like(w), where=w > np.finfo(np.float64).tiny)
    return w, at * inv[:, None]


def _control_points(pws: np.ndarray) -> np.ndarray:
    """The centroid and the principal axes scaled by sqrt(eigenvalue / n), the
    axes with the signs of OpenCV's SVD of PW0^T PW0: with noisy pixels,
    mirrored control points give another EPnP answer."""
    c0 = pws.mean(0)
    centered = pws - c0
    d, ut = jacobi_svd(centered.T @ centered)
    k = np.sqrt(d / len(pws))
    return np.concatenate([c0[None], c0[None] + k[:, None] * ut], axis=0)  # (4, 3)


def _betas_approx(L: np.ndarray, rho: np.ndarray, which: int) -> np.ndarray:
    """EPnP's three closed-form guesses at the betas (epnp.cpp
    find_betas_approx_1/2/3)."""
    betas = np.zeros(4)
    if which == 1:
        b = np.linalg.lstsq(L[:, [0, 1, 3, 6]], rho, rcond=None)[0]
        betas[0] = math.sqrt(abs(b[0]))
        sign = -1.0 if b[0] < 0 else 1.0
        betas[1:] = sign * b[1:] / betas[0]
        return betas
    cols = [0, 1, 2] if which == 2 else [0, 1, 2, 3, 4]
    b = np.linalg.lstsq(L[:, cols], rho, rcond=None)[0]
    if b[0] < 0:
        betas[0] = math.sqrt(-b[0])
        betas[1] = math.sqrt(-b[2]) if b[2] < 0 else 0.0
    else:
        betas[0] = math.sqrt(b[0])
        betas[1] = math.sqrt(b[2]) if b[2] > 0 else 0.0
    if b[1] < 0:
        betas[0] = -betas[0]
    if which == 3:
        betas[2] = b[3] / betas[0]
    return betas


def _gauss_newton(L: np.ndarray, rho: np.ndarray, betas: np.ndarray) -> np.ndarray:
    b = betas.copy()
    for _ in range(5):
        A = np.stack([
            2 * L[:, 0] * b[0] + L[:, 1] * b[1] + L[:, 3] * b[2] + L[:, 6] * b[3],
            L[:, 1] * b[0] + 2 * L[:, 2] * b[1] + L[:, 4] * b[2] + L[:, 7] * b[3],
            L[:, 3] * b[0] + L[:, 4] * b[1] + 2 * L[:, 5] * b[2] + L[:, 8] * b[3],
            L[:, 6] * b[0] + L[:, 7] * b[1] + L[:, 8] * b[2] + 2 * L[:, 9] * b[3],
        ], axis=1)
        quad = np.array([b[0] * b[0], b[0] * b[1], b[1] * b[1], b[0] * b[2], b[1] * b[2], b[2] * b[2],
                         b[0] * b[3], b[1] * b[3], b[2] * b[3], b[3] * b[3]])
        q, r = np.linalg.qr(A)
        b = b + np.linalg.solve(r, q.T @ (rho - L @ quad))
    return b


def _pose_from_betas(betas, vs, alphas, pws, us, K) -> tuple[np.ndarray, np.ndarray, float]:
    ccs = sum(betas[i] * vs[i] for i in range(4))  # (4, 3) control points in the camera
    pcs = alphas @ ccs
    if pcs[0, 2] < 0:
        pcs = -pcs
    pc0, pw0 = pcs.mean(0), pws.mean(0)
    U, _, Vt = np.linalg.svd((pcs - pc0).T @ (pws - pw0))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    t = pc0 - R @ pw0
    cam = pws @ R.T + t
    proj = K[:2, :2].diagonal() * cam[:, :2] / cam[:, 2:3] + K[:2, 2]
    return R, t, float(np.linalg.norm(us - proj, axis=-1).mean())


def epnp(pws: np.ndarray, us: np.ndarray, K: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """EPnP of (n, 3) world points and (n, 2) pixels under intrinsics K:
    (R, t) of the best of the three beta estimates."""
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cws = _control_points(pws)
    alphas = np.empty((len(pws), 4))
    alphas[:, 1:] = (pws - cws[0]) @ np.linalg.inv((cws[1:] - cws[0]).T).T
    alphas[:, 0] = 1.0 - alphas[:, 1:].sum(1)
    M = np.zeros((2 * len(pws), 12))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - us[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - us[:, 1:])
    ut = np.linalg.svd(M.T @ M)[2]
    vs = [ut[11 - i].reshape(4, 3) for i in range(4)]
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    dv = np.array([[v[a] - v[b] for a, b in pairs] for v in vs])  # (4, 6, 3)
    dot = lambda i, j: (dv[i] * dv[j]).sum(-1)  # noqa: E731
    L = np.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2), dot(2, 2),
                  2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)], axis=1)  # (6, 10)
    rho = np.array([((cws[a] - cws[b]) ** 2).sum() for a, b in pairs])
    best = None
    for which in (1, 2, 3):
        R, t, err = _pose_from_betas(_gauss_newton(L, rho, _betas_approx(L, rho, which)), vs, alphas, pws, us, K)
        if best is None or err < best[2]:
            best = (R, t, err)
    return best[0], best[1]


def _squared_errors(R, t, pws, us, K) -> np.ndarray:
    cam = pws @ R.T + t
    proj = (cam @ K.T)
    proj = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
    return ((us.astype(np.float32) - proj) ** 2).sum(-1)


def _ransac_iters(confidence: float, outlier_share: float, max_iters: int) -> int:
    num = math.log(max(1.0 - confidence, np.finfo(float).tiny))
    denom = 1.0 - (1.0 - outlier_share) ** MODEL_POINTS
    if denom < np.finfo(float).tiny:
        return 0
    denom = math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * -denom else int(np.round(num / denom))


def ransac_epnp(joints_3d: np.ndarray, joints_2d: np.ndarray, K: np.ndarray, reprojection_error: float = 20.0,
                iterations: int = 100, confidence: float = 0.99,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray] | None:
    """(translation, inlier mask) of EPnP + RANSAC on (J, 3) model-space
    joints and their (J, 2) pixels, or None when no model has 5 inliers."""
    pws = np.asarray(joints_3d, np.float32).astype(np.float64)
    us = np.asarray(joints_2d, np.float32).astype(np.float64)
    K = np.asarray(K, np.float64)
    n = len(pws)
    if n < MODEL_POINTS:
        raise ValueError(f"ransac_epnp takes at least {MODEL_POINTS} correspondences, got {n}")
    if n == MODEL_POINTS:
        return epnp(pws, us, K)[1], np.ones(n, bool)
    rng = np.random.default_rng(seed)
    thresh = np.float32(reprojection_error * reprojection_error)
    best_count, best_mask, niters, it = 0, None, iterations, 0
    while it < niters:
        sub = rng.choice(n, MODEL_POINTS, replace=False)
        R, t = epnp(pws[sub], us[sub], K)
        mask = _squared_errors(R, t, pws, us, K) <= thresh
        count = int(mask.sum())
        if count > max(best_count, MODEL_POINTS - 1):
            best_count, best_mask = count, mask
            niters = _ransac_iters(confidence, (n - count) / n, niters)
        it += 1
    if best_mask is None:
        return None
    return epnp(pws[best_mask], us[best_mask], K)[1], best_mask


def estimate_translation_pnp(joints_3d: np.ndarray, joints_2d: np.ndarray, K: np.ndarray) -> np.ndarray:
    """EPnP + RANSAC translation from (J, 3) model-space joints and their (J, 2)
    detected pixels; `INVALID_TRANS` when no model has 5 inliers."""
    found = ransac_epnp(joints_3d, joints_2d, K)
    return INVALID_TRANS if found is None else found[0]


def camera_center(P: np.ndarray) -> np.ndarray:
    """The camera center of a (3 or 4, 4) projection: its null vector, as
    `cv2.decomposeProjectionMatrix` gives it."""
    return load_K_Rt_from_P(np.asarray(P))[1][:3, 3].astype(np.float64)


def normalize_cameras(cameras: dict, max_human_sphere: float, scene_bounding_sphere: float = 3.0) -> dict:
    """scale_mat_%d / world_mat_%d so that the scene (cameras and humans)
    fits a sphere of radius `scene_bounding_sphere`."""
    idxs = sorted(int(k.split("_")[-1]) for k in cameras if k.startswith("cam_"))
    centers = np.stack([camera_center(np.asarray(cameras[f"cam_{i}"])) for i in idxs])
    max_radius = max(np.linalg.norm(centers, axis=-1).max() * 1.1, max_human_sphere * 1.1)
    normalization = np.eye(4, dtype=np.float32)
    normalization[0, 0] = normalization[1, 1] = normalization[2, 2] = max_radius / scene_bounding_sphere
    out = {}
    for i in idxs:
        out[f"scale_mat_{i}"] = normalization
        out[f"world_mat_{i}"] = np.asarray(cameras[f"cam_{i}"], np.float32).copy()
    return out


def max_human_sphere_radius(all_verts: np.ndarray) -> float:
    """Radius of the origin-centered sphere holding every posed vertex."""
    return float(np.linalg.norm(all_verts.reshape(-1, 3), axis=-1).max())
