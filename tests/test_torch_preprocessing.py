"""The port's preprocessing chain against the JAX package's and OpenCV.

Same inputs, made from a numpy seed, through `multiply_tpu.preprocessing` and
`multiply_tpu_torch.preprocessing`: the synthetic SMPL pickle (both loaders),
rotations, the keypoint refinement (each leaf's change within a tenth of an
Adam step), interpolation, matching, TRACE loading, PnP and the camera
center (against OpenCV, which the port does not use), the mask dilation and
the resize, `finalize_sequence` file by file, the ViTPose glue and the
external-binary stages. Then the port's own chain on one directory:
preprocessing -> train -> test.
"""

import glob
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_helpers  # noqa: F401  (sets the CPU thread count)
from _torch_helpers import assert_update_matches
from multiply_tpu.body import smpl as jsmpl
from multiply_tpu.body import synthetic_pickle as jpickle
from multiply_tpu.body.server import smpl_server_forward as jforward
from multiply_tpu.preprocessing import cameras as jcams
from multiply_tpu.preprocessing import interpolation as jinterp
from multiply_tpu.preprocessing import matching as jmatch
from multiply_tpu.preprocessing import pipeline as jpipe
from multiply_tpu.preprocessing import refine as jref
from multiply_tpu.preprocessing import rotations as jrot
from multiply_tpu.preprocessing import trace as jtrace
from multiply_tpu.preprocessing import video as jvideo
from multiply_tpu.preprocessing import vitpose as jvitpose
from multiply_tpu_torch.body import smpl as tsmpl
from multiply_tpu_torch.body import synthetic_pickle as tpickle
from multiply_tpu_torch.body.server import SMPLServer as TServer
from multiply_tpu_torch.body.server import stack_servers
from multiply_tpu_torch.data.dataset import dilate_box
from multiply_tpu_torch.preprocessing import cameras as tcams
from multiply_tpu_torch.preprocessing import interpolation as tinterp
from multiply_tpu_torch.preprocessing import matching as tmatch
from multiply_tpu_torch.preprocessing import pipeline as tpipe
from multiply_tpu_torch.preprocessing import refine as tref
from multiply_tpu_torch.preprocessing import rotations as trot
from multiply_tpu_torch.preprocessing import trace as ttrace
from multiply_tpu_torch.preprocessing import video as tvideo
from multiply_tpu_torch.preprocessing import vitpose as tvitpose
from multiply_tpu_torch.utils.io import read_png, write_png
from multiply_tpu_torch.utils.resize import resize_linear
from test_preprocessing import _raw_trace_npz, make_trace_inputs

ROOT = os.path.join(os.path.dirname(__file__), "..")


def t32(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def port_servers(betas, num_verts=386):
    model = tsmpl.synthetic_body_model(num_verts=num_verts, device="cpu")
    return [TServer.create(model, betas=b) for b in np.asarray(betas)]


# ---------------------------------------------------------------------------
# the synthetic SMPL pickle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_verts", [386, 6890])
def test_pickles_of_both_packages_are_equal_and_load_alike(tmp_path, num_verts):
    """Both writers give the same arrays, dtypes and layout (exact); the port's
    `load_smpl_model` on JAX's file equals JAX's loader on it (exact)."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpickle.write_synthetic_smpl_dir(jdir, num_verts=num_verts, seed=0)
    tpickle.write_synthetic_smpl_dir(tdir, num_verts=num_verts, seed=0)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [f"SMPL_{g}.pkl" for g in ("FEMALE", "MALE", "NEUTRAL")]
    with open(os.path.join(jdir, "SMPL_MALE.pkl"), "rb") as f:
        jd = pickle.load(f)
    with open(os.path.join(tdir, "SMPL_MALE.pkl"), "rb") as f:
        td = pickle.load(f)
    assert jd.keys() == td.keys()
    for k in jd:
        assert jd[k].dtype == td[k].dtype and np.array_equal(jd[k], td[k]), k
    assert td["posedirs"].shape == (num_verts, 3, 207) and td["kintree_table"][0, 0] == -1
    assert td["f"].dtype == np.uint32 and td["v_template"].dtype == np.float64

    jm = jsmpl.load_smpl_model(jdir, gender="male")
    tm = tsmpl.load_smpl_model(jdir, gender="male", device="cpu")
    for name, a, b in zip(jm._fields, jm, tm):
        assert np.array_equal(np.asarray(a).astype(np.float64), b.numpy().astype(np.float64)), name
    # the arrays are the synthetic body's, at every vertex count
    src = tsmpl.synthetic_body_model(num_verts=num_verts, device="cpu")
    for name in ("v_template", "shapedirs", "posedirs", "joint_regressor", "lbs_weights", "faces"):
        assert torch.equal(getattr(tm, name), getattr(src, name)), name


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


def _rotation_cases():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(24, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.1, 3.0, 12), [1e-3, 3e-3, 1e-2, 0.05],
                             [np.pi - 1e-2, np.pi - 3e-2, np.pi - 0.05, np.pi - 0.1], rng.uniform(0.1, 3.0, 4)])
    return (axes * angles[:, None]).astype(np.float32)


def test_rotations_match_jax_in_value_and_gradient():
    """At random rotations and near 0 and pi: every conversion's value and the
    gradient of a weighted sum of it, within 1e-5 of the largest. Near 0 and pi
    the axis-angle's gradient runs through arccos at a slope of 1 / sin, where
    one rounding of the cosine moves it by ~1e-5 relative: those rows are held
    to 1e-4 relative, entry by entry."""
    aa = _rotation_cases()
    rng = np.random.default_rng(1)
    mats = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    d6 = rng.normal(size=(24, 6)).astype(np.float32)
    cases = {
        "axis_angle_to_rot6d": (jrot.axis_angle_to_rot6d, trot.axis_angle_to_rot6d, aa),
        "matrix_to_rot6d": (jrot.matrix_to_rot6d, trot.matrix_to_rot6d, mats),
        "rot6d_to_matrix": (jrot.rot6d_to_matrix, trot.rot6d_to_matrix, d6),
        "matrix_to_axis_angle": (jrot.matrix_to_axis_angle, trot.matrix_to_axis_angle, mats),
    }
    for name, (jf, tf, x) in cases.items():
        want = np.asarray(jf(jnp.asarray(x)))
        w = rng.normal(size=want.shape).astype(np.float32)
        xt = t32(x).requires_grad_(True)
        got = tf(xt)
        (g,) = torch.autograd.grad((got * t32(w)).sum(), xt)
        jg = np.asarray(jax.grad(lambda y: jnp.sum(jf(y) * w))(jnp.asarray(x)))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)
        edge = np.zeros(len(x), bool)
        edge[12:20] = True
        np.testing.assert_allclose(g.numpy()[~edge], jg[~edge], rtol=0, atol=1e-5 * np.abs(jg[~edge]).max(),
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy()[edge], jg[edge], rtol=1e-4, atol=1e-5 * np.abs(jg[~edge]).max(),
                                   err_msg=name)
    # axis-angle survives the round trip near 0 and pi
    back = trot.matrix_to_axis_angle(t32(mats)).numpy()
    np.testing.assert_allclose(back[12:16], aa[12:16], atol=2e-4)


# ---------------------------------------------------------------------------
# keypoint refinement
# ---------------------------------------------------------------------------


def _refine_case(kp_format):
    """Two persons of the 386-vertex body, corrupted initial poses and
    translations, keypoints from the true bodies with random confidences."""
    inputs, jservers, poses_true, trans_true = make_trace_inputs(F=2, P=2)
    rng = np.random.default_rng(5)
    joint_map = jref.SMPL_TO_COCO17 if kp_format == "coco17" else np.maximum(np.asarray(jref.SMPL_TO_OPENPOSE25), 0)
    kps = np.zeros((2, 2, len(joint_map), 3), np.float32)
    for f in range(2):
        for p in range(2):
            out = jforward(jservers[p], jnp.ones(()), jnp.asarray(trans_true[f, p]), jnp.asarray(poses_true[f, p]),
                           jnp.asarray(inputs.betas[p]))
            pix = jref.project(out["smpl_all_jnts"][jnp.asarray(joint_map)], jnp.asarray(inputs.K), jnp.eye(3),
                               jnp.zeros(3))
            kps[f, p, :, :2] = np.asarray(pix) + rng.normal(0, 1.0, (len(joint_map), 2))
            kps[f, p, :, 2] = rng.uniform(0.5, 1.0, len(joint_map))
    last = (poses_true[0] + rng.normal(0, 0.03, poses_true[0].shape)).astype(np.float32)
    return inputs, jservers, kps, last


@pytest.mark.parametrize("kp_format", ["coco17", "openpose25"])
def test_refine_frame_matches_jax(monkeypatch, kp_format):
    """Five iterations: the per-iteration losses within 1e-4 relative, each
    iteration's gradients within 5% of JAX's largest, and each leaf's change
    within a tenth of an Adam step (0.1 x lr) of JAX's."""
    inputs, jservers, kps, last = _refine_case(kp_format)
    cfg = jref.RefineConfig(iters=5, is_vitpose=kp_format == "coco17")
    K, R, t = jnp.asarray(inputs.K), jnp.eye(3), jnp.zeros(3)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jservers)
    init = (inputs.poses[0], inputs.trans[0], inputs.betas)
    (jp, jt, jb), jl = jref.refine_frame(jstack, K, R, t, *map(jnp.asarray, init), jnp.asarray(kps[0]),
                                         jnp.asarray(last), cfg)

    # JAX's gradients along its own trajectory: its person loss, re-run step by step
    if cfg.is_vitpose:
        joint_map, weights = jnp.asarray(jref.SMPL_TO_COCO17), jnp.ones(17)
    else:
        joint_map = jnp.maximum(jnp.asarray(jref.SMPL_TO_OPENPOSE25), 0)
        weights = jnp.ones(25).at[jnp.asarray(jref.OPENPOSE_IGNORED)].set(0.0)
        weights = jnp.where(jnp.asarray(jref.SMPL_TO_OPENPOSE25) >= 0, weights, 0.0)

    def person_loss(params, srv, kp, lp):
        pose, transl, betas = params
        out = jforward(srv, jnp.ones(()), transl, pose, betas)
        pix = jref.project(out["smpl_all_jnts"][joint_map], K, R, t)
        conf = kp[:, 2] * weights
        j2d = jnp.mean(conf[:, None] ** 2 * jref.GMoF(cfg.rho)(kp[:, :2] - pix))
        temporal = jnp.mean(jnp.square(jrot.axis_angle_to_rot6d(lp.reshape(24, 3))
                                       - jrot.axis_angle_to_rot6d(pose.reshape(24, 3))))
        return cfg.j2d_weight * j2d + cfg.temporal_weight * temporal

    grad_fn = jax.jit(jax.vmap(jax.value_and_grad(person_loss)))
    opt = optax.adam(cfg.lr, eps=1e-8)
    params = tuple(map(jnp.asarray, init))
    state = opt.init(params)
    jax_grads, losses = [], []
    for _ in range(cfg.iters):
        loss, g = grad_fn(params, jstack, jnp.asarray(kps[0]), jnp.asarray(last))
        jax_grads.append([np.asarray(x) for x in g])
        losses.append(np.asarray(loss))
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(np.stack(losses, -1), np.asarray(jl), rtol=1e-6)
    for a, b in zip(params, (jp, jt, jb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    recorded, adam_update = [], tref.adam_update

    def recording(grads, *args, **kw):
        recorded.append({k: v.numpy().copy() for k, v in grads.items()})
        return adam_update(grads, *args, **kw)

    monkeypatch.setattr(tref, "adam_update", recording)
    server = stack_servers(port_servers(inputs.betas))
    (tp, tt, tb), tl = tref.refine_frame(server, t32(inputs.K), torch.eye(3), torch.zeros(3), *map(t32, init),
                                         t32(kps[0]), t32(last), tref.RefineConfig(**cfg._asdict()))
    assert tl.shape == (2, cfg.iters)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for i, (name, before, got, want) in enumerate(zip(("pose", "transl", "betas"), init, (tp, tt, tb), (jp, jt, jb))):
        assert_update_matches(name, before, got.numpy(), np.asarray(want), [g[i] for g in jax_grads],
                              [r[name] for r in recorded], step=cfg.lr)


def test_refine_sequence_chains_the_last_pose(monkeypatch):
    """Frame 0's temporal term is against its own initial pose, frame 1's
    against frame 0's refined pose; every frame starts from the given betas;
    the result's betas are the mean over frames; and the whole chain stays
    within a tenth of an Adam step of JAX's."""
    inputs, jservers, kps, _ = _refine_case("coco17")
    cfg = jref.RefineConfig(iters=3)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jservers)
    want = jref.refine_sequence(jstack, jnp.asarray(inputs.K), jnp.eye(3), jnp.zeros(3), jnp.asarray(inputs.poses),
                                jnp.asarray(inputs.trans), jnp.asarray(inputs.betas), jnp.asarray(kps), cfg)
    calls, refine_frame = [], tref.refine_frame

    def recording(server, K, R, t, pose, transl, betas, kp, last, cfg):
        out = refine_frame(server, K, R, t, pose, transl, betas, kp, last, cfg)
        calls.append((pose.clone(), betas.clone(), last.clone(), out[0][0].clone(), out[0][2].clone()))
        return out

    monkeypatch.setattr(tref, "refine_frame", recording)
    server = stack_servers(port_servers(inputs.betas))
    got = tref.refine_sequence(server, t32(inputs.K), torch.eye(3), torch.zeros(3), t32(inputs.poses),
                               t32(inputs.trans), t32(inputs.betas), t32(kps), tref.RefineConfig(iters=3))
    assert len(calls) == 2
    assert torch.equal(calls[0][2], calls[0][0]) and torch.equal(calls[1][2], calls[0][3])
    assert all(torch.equal(c[1], t32(inputs.betas)) for c in calls)
    assert torch.equal(got[2], (calls[0][4] + calls[1][4]) / 2)
    for name, a, b in zip(("poses", "transl", "betas"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=0.1 * cfg.lr, err_msg=name)


# ---------------------------------------------------------------------------
# interpolation, matching, TRACE loading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid_frames", [[2, 3, 6], [4], []])
def test_interpolation_matches_jax(valid_frames):
    """Leading, middle and trailing gaps; one valid frame; none."""
    rng = np.random.default_rng(2)
    F = 9
    poses = rng.normal(0, 0.4, (F, 72)).astype(np.float32)
    trans = rng.normal(0, 1.0, (F, 3)).astype(np.float32)
    valid = np.isin(np.arange(F), valid_frames)
    for a, b in zip(tinterp.interpolate_missing_frames(poses, trans, valid),
                    jinterp.interpolate_missing_frames(poses, trans, valid)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_matching_matches_jax():
    """NMS with duplicates, Hungarian matching with a gated-out track."""
    rng = np.random.default_rng(3)
    base = [np.concatenate([rng.uniform(0, 400, (17, 2)), rng.uniform(0.2, 1, (17, 1))], 1).astype(np.float32)
            for _ in range(4)]
    dets = base + [base[1] + np.array([2.0, 2.0, -0.1], np.float32), base[3] + np.array([1.0, -1.0, 0.05], np.float32)]
    for kw in ({}, {"center_thresh": 5.0, "kp_thresh": 5.0}, {"center_thresh": 500.0, "kp_thresh": 500.0}):
        a, b = tmatch.skeleton_nms(dets, **kw), jmatch.skeleton_nms(dets, **kw)
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    centers = np.stack([tmatch.keypoint_center(d) for d in base[:3]] + [np.array([5000.0, 5000.0])])
    assert np.array_equal(centers[:3], np.stack([jmatch.keypoint_center(d) for d in base[:3]]))
    got = tmatch.match_detections_to_tracks(dets, centers, gate_px=150.0)
    assert got == jmatch.match_detections_to_tracks(dets, centers, gate_px=150.0) and got[3] is None
    assert tmatch.match_detections_to_tracks([], centers) == [None] * 4


def _frames_dir(path, images):
    path.mkdir()
    for f, img in enumerate(images):
        write_png(str(path / f"{f:04d}.png"), img)
    return str(path)


def test_trace_loading_matches_jax(tmp_path):
    """A shuffled raw TRACE npz with 1-based track ids: the reformat, the
    TraceInputs from PNG frames (given K and the default K, COCO-17 and
    BODY_25, a start/skip selection) and the keypoint npys' matching."""
    inputs, servers, *_ = make_trace_inputs(F=3, P=2)
    rng = np.random.default_rng(4)
    inputs.images = [rng.integers(0, 256, (60, 81, 3), dtype=np.uint8) for _ in range(3)]
    npz = str(tmp_path / "trace.npz")
    _raw_trace_npz(npz, inputs, servers)
    frames = _frames_dir(tmp_path / "frames", inputs.images)

    a, b = ttrace.load_trace_results(npz), jtrace.load_trace_results(npz)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    kp_dir = tmp_path / "kp"
    kp_dir.mkdir()
    for f in range(3):
        dets = inputs.keypoints_2d[f, ::-1] + np.array([3.0, -2.0, 0.0], np.float32)
        np.save(str(kp_dir / f"{f:04d}.npy"), dets)
    for kw in ({"K": inputs.K}, {}, {"kp_format": "openpose25", "start": 1}, {"skip": 2, "genders": ["male", "female"]},
               {"keypoints_dir": str(kp_dir), "start": 1}):
        got, want = ttrace.trace_inputs_from_files(npz, frames, **kw), jtrace.trace_inputs_from_files(npz, frames, **kw)
        assert len(got.images) == len(want.images) and all(np.array_equal(x, y) for x, y in zip(got.images, want.images))
        for name in ("poses", "betas", "trans", "keypoints_2d", "K"):
            x, y = getattr(got, name), getattr(want, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), (kw, name)
        assert got.genders == want.genders


def test_jpeg_frames_and_the_vitpose_model_are_refused(tmp_path):
    """(The name is kept from when both were refused.) JPEG frames, alone and
    sorted among PNG ones, give the images that JAX's `cv2.imread` gives; a
    ViTPose checkpoint gives JAX's keypoints, and the entry runs with
    `--vitpose` on JPEG frames on the CPU."""
    from multiply_tpu_torch.preprocessing.__main__ import main
    from test_torch_vitpose import _checkpoint, _hf_model

    inputs, servers, *_ = make_trace_inputs(F=3, P=2)
    npz = str(tmp_path / "trace.npz")
    _raw_trace_npz(npz, inputs, servers)
    rng = np.random.default_rng(12)
    images = [np.clip(img.astype(np.float32) + rng.normal(0, 30, img.shape), 0, 255).astype(np.uint8)
              for img in inputs.images]
    frames, mixed = tmp_path / "frames", tmp_path / "mixed"
    frames.mkdir()
    mixed.mkdir()
    for f, img in enumerate(images):
        cv2.imwrite(str(frames / f"{f:04d}.jpg"), img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
        if f == 1:
            write_png(str(mixed / f"{f:04d}.png"), img)
        else:
            cv2.imwrite(str(mixed / f"{f:04d}.jpg"), img[:, :, ::-1])
    ckpt = _checkpoint(tmp_path / "vitpose", _hf_model(8))
    for d, kw in ((frames, {}), (mixed, {"skip": 2}), (frames, {"vitpose_checkpoint": ckpt})):
        got = ttrace.trace_inputs_from_files(npz, str(d), device="cpu", **kw)
        want = jtrace.trace_inputs_from_files(npz, str(d), **kw)
        assert len(got.images) == len(want.images) and all(np.array_equal(x, y) for x, y in zip(got.images, want.images))
        np.testing.assert_allclose(got.keypoints_2d, want.keypoints_2d, atol=1e-3, rtol=0)
    assert not np.array_equal(got.keypoints_2d, ttrace.trace_inputs_from_files(npz, str(frames)).keypoints_2d)

    out = str(tmp_path / "out")
    seconds = main(["--trace", npz, "--frames", str(frames), "--out", out, "--vitpose", ckpt, "--refine_iters", "2",
                    "--scale_factor", "1", "--device", "cpu"])
    assert set(seconds) == {"pnp", "refine", "finalize"}
    missing = [f for f in (*tpipe.FILES, *(f"image/{i:04d}.png" for i in range(3))) if not os.path.exists(
        os.path.join(out, f))]
    assert not missing, missing


# ---------------------------------------------------------------------------
# cameras: PnP and the camera center, against OpenCV
# ---------------------------------------------------------------------------

PNP_K = np.array([[720.0, 0, 360], [0, 720.0, 270], [0, 0, 1]])
OUTLIERS = (2, 7, 12)


def _pnp_case(seed, outliers):
    """COCO-17 joints of the posed 386-vertex body at 3.5-6 m, each pixel
    moved by at most 1 px; with `outliers`, three of them by 200-300 px."""
    rng = np.random.default_rng(seed)
    body = tsmpl.synthetic_body_model(device="cpu")
    pose = torch.as_tensor(rng.normal(0, 0.2, 72), dtype=torch.float32)
    X = tsmpl.lbs(body, torch.zeros(10), pose)["all_joints"].numpy()[tref.SMPL_TO_COCO17].astype(np.float32)
    t = np.array([rng.uniform(-1, 1), rng.uniform(-0.3, 0.3), rng.uniform(3.5, 6)])
    uvw = (X @ PNP_K.T + t @ PNP_K.T)
    uv = uvw[:, :2] / uvw[:, 2:]
    ang = rng.uniform(0, 2 * np.pi, len(uv))
    uv = uv + rng.uniform(0, 1, len(uv))[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    if outliers:
        uv[list(OUTLIERS)] += rng.uniform(200, 300, (3, 2)) * rng.choice([-1, 1], (3, 2))
    return X, uv.astype(np.float32)


@pytest.mark.parametrize("outliers", [False, True], ids=["all_inliers", "three_outliers"])
def test_pnp_translation_against_opencv(outliers):
    """`cv2.solvePnPRansac(EPNP, 20 px, 100 iterations)` against the port on
    twelve bodies. Both refit EPnP on the same inlier set (all points, or all
    but the three outliers, which both reject), so the RANSAC draws do not
    matter. Every body within 1e-7 relative (measured with OpenCV 5.0: 4e-14
    at worst, once the control points take OpenCV's axis signs)."""
    worst = 0.0
    for seed in range(12):
        X, uv = _pnp_case(seed, outliers)
        ok, _, tvec, inliers = cv2.solvePnPRansac(X, uv, PNP_K, None, flags=cv2.SOLVEPNP_EPNP,
                                                  reprojectionError=20, iterationsCount=100)
        t_port, mask = tcams.ransac_epnp(X, uv, PNP_K)
        expected = np.setdiff1d(np.arange(17), OUTLIERS if outliers else [])
        assert ok and np.array_equal(np.sort(inliers[:, 0]), expected), seed
        assert np.array_equal(np.nonzero(mask)[0], expected), seed
        assert np.array_equal(tcams.estimate_translation_pnp(X, uv, PNP_K), t_port)
        rel = np.linalg.norm(t_port - tvec[:, 0]) / np.linalg.norm(tvec)
        assert rel <= 1e-7, (seed, rel)
        worst = max(worst, rel)
    print(f"worst relative distance from OpenCV's translation: {worst:.3g}")


def _pca_clouds(n_clouds: int):
    """Seeded point clouds for EPnP's PCA: COCO-17 bodies of the posed
    386-vertex body (a third of them), and random clouds, a third of them flat
    (one axis 1e-3 of the others) and rotated."""
    rng = np.random.default_rng(21)
    body = tsmpl.synthetic_body_model(device="cpu")
    poses = torch.as_tensor(rng.normal(0, 0.3, (n_clouds // 3, 72)), dtype=torch.float32)
    joints = [tsmpl.lbs(body, torch.zeros(10), p)["all_joints"].numpy()[tref.SMPL_TO_COCO17] for p in poses]
    clouds = [j.astype(np.float32).astype(np.float64) for j in joints]
    for i in range(n_clouds - len(clouds)):
        X = rng.normal(size=(int(rng.integers(5, 30)), 3)) * rng.uniform(0.05, 2.0, 3)
        if i % 2:
            X[:, 2] *= 1e-3
            X = X @ cv2.Rodrigues(rng.normal(size=3))[0].T
        clouds.append(X)
    return clouds


def test_pnp_control_point_axes_take_opencvs_signs():
    """`cameras.jacobi_svd` of each cloud's PW0^T PW0 (EPnP's control-point
    axes) equals `cv2.SVDecomp`'s singular values and U^T, signs included,
    on 600 clouds. A cloud whose two eigenvalues lie within 1e-6 relative of
    each other is left out (its axes' signs turn on rounding) and counted."""
    left_out, compared = 0, 0
    for X in _pca_clouds(600):
        c = X - X.mean(0)
        A = c.T @ c
        w, u, _ = cv2.SVDecomp(A)
        if (np.abs(np.diff(w[:, 0])) <= 1e-6 * w[0, 0]).any():
            left_out += 1
            continue
        d, ut = tcams.jacobi_svd(A)
        np.testing.assert_allclose(d, w[:, 0], rtol=0, atol=1e-12 * w[0, 0])
        np.testing.assert_allclose(ut, u.T, rtol=0, atol=1e-9)
        compared += 1
    print(f"{compared} clouds compared, {left_out} left out for eigenvalues within 1e-6")
    assert compared >= 500


def test_pnp_other_svd_signs_do_not_reach_the_answer(monkeypatch):
    """EPnP's other two SVDs (the 12 x 12 M^T M, whose null vectors the betas
    scale, and Procrustes' U V^T) with their singular vectors' signs flipped
    at random in pairs: the translation is the same bit for bit."""
    import types

    svd = np.linalg.svd
    rng = np.random.default_rng(3)

    def flipped(a, *args, **kw):
        u, s, vt = svd(a, *args, **kw)
        f = rng.choice([-1.0, 1.0], len(s))
        return u * f, s, vt * f[:, None]

    cases = [_pnp_case(seed, outliers) for seed in range(6) for outliers in (False, True)]
    want = [tcams.ransac_epnp(X, uv, PNP_K)[0] for X, uv in cases]
    monkeypatch.setattr(tcams, "np", types.SimpleNamespace(**{**vars(np), "linalg": types.SimpleNamespace(
        **{**vars(np.linalg), "svd": flipped})}))
    for (X, uv), t in zip(cases, want):
        assert np.array_equal(tcams.ransac_epnp(X, uv, PNP_K)[0], t)


def test_pnp_without_inliers_is_invalid_as_in_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(0, 0.3, (8, 3)).astype(np.float32)
    uv = rng.uniform(-5e4, 5e4, (8, 2)).astype(np.float32)
    assert np.array_equal(jcams.estimate_translation_pnp(X, uv, PNP_K), jcams.INVALID_TRANS)
    assert np.array_equal(tcams.estimate_translation_pnp(X, uv, PNP_K), tcams.INVALID_TRANS)


def test_camera_center_and_normalisation_match_opencv_and_jax():
    rng = np.random.default_rng(8)
    cams = {}
    for i in range(6):
        R = cv2.Rodrigues(rng.normal(0, 0.5, 3))[0]
        P = np.eye(4)
        P[:3, :4] = PNP_K @ np.concatenate([R, rng.normal(0, 2, (3, 1))], 1)
        want = cv2.decomposeProjectionMatrix(P[:3, :4])[2]
        np.testing.assert_allclose(tcams.camera_center(P), (want[:3] / want[3])[:, 0], rtol=1e-5, atol=1e-5)
        cams[f"cam_{i}"] = P.astype(np.float32)
    for sphere in (0.5, 40.0):
        got, want = tcams.normalize_cameras(cams, sphere), jcams.normalize_cameras(cams, sphere)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    verts = rng.normal(size=(3, 50, 3))
    assert tcams.max_human_sphere_radius(verts) == jcams.max_human_sphere_radius(verts)


# ---------------------------------------------------------------------------
# the final stage against OpenCV and JAX
# ---------------------------------------------------------------------------


def test_mask_dilation_and_resize_match_opencv():
    """The even 20 x 20 box (anchored at (10, 10): 10 px before, 9 after) on
    an asymmetric mask touching the borders, and the 3-channel x2 downscale,
    bit for bit."""
    m = np.zeros((61, 77), np.uint8)
    m[30, 40] = 255
    m[0, 5:9] = 255
    m[45:60, 76] = 255
    m[12:14, 0] = 255
    m[50, 20:23] = 255
    assert np.array_equal(dilate_box(m, 20), cv2.dilate(m, np.ones((20, 20), np.uint8)))
    rng = np.random.default_rng(9)
    for H, W in ((540, 720), (61, 83)):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        assert np.array_equal(resize_linear(img, (W // 2, H // 2)), cv2.resize(img, (W // 2, H // 2)))


def _decoded_dir(root):
    files = sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                   if os.path.isfile(p))
    return files


def test_finalize_sequence_matches_jax_file_by_file(tmp_path):
    """The same refined parameters through both packages' final stage: PNGs
    decoded bit for bit, cameras.npz and the world matrices exact, the scale
    matrices and the .npy files to 1e-6 (they follow the posed vertices,
    which each package's SMPL forward rounds its own way), gender.npy equal;
    and JAX's Hi4DSequence reads the port's directory as it reads JAX's."""
    inputs, jservers, *_ = make_trace_inputs(F=2, P=2)
    rng = np.random.default_rng(10)
    inputs.images = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2)]
    inputs.genders = ["male", "female"]
    poses = (inputs.poses + rng.normal(0, 0.02, inputs.poses.shape)).astype(np.float32)
    trans = (inputs.trans + rng.normal(0, 0.02, inputs.trans.shape)).astype(np.float32)
    betas = inputs.betas
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpipe.finalize_sequence(jdir, inputs, jservers, poses, trans, betas)
    tpipe.finalize_sequence(tdir, inputs, port_servers(betas), poses, trans, betas)
    files = _decoded_dir(jdir)
    assert files == _decoded_dir(tdir)
    for f in files:
        a, b = os.path.join(tdir, f), os.path.join(jdir, f)
        if f.endswith(".png"):
            assert np.array_equal(read_png(a), read_png(b)), f
        elif f.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), f
            for k in za.files:
                if k.startswith("scale_mat"):
                    np.testing.assert_allclose(za[k], zb[k], rtol=1e-6, err_msg=k)
                else:
                    assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), (f, k)
        elif f == "gender.npy":
            assert np.array_equal(np.load(a), np.load(b))
        else:
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=f)
    assert set(tpipe.FILES) <= set(files)
    assert all(read_png(os.path.join(tdir, "mask", str(p), "0000.png")).any() for p in range(2))

    from multiply_tpu.data.dataset import Hi4DSequence

    sj, st = Hi4DSequence(jdir, num_sample=16, using_sam=False), Hi4DSequence(tdir, num_sample=16, using_sam=False)
    for f in range(2):
        a, b = st.load_frame(f), sj.load_frame(f)
        for k in ("img", "mask_union", "uv"):
            assert np.array_equal(a[k], b[k]), k
        a, b = st.get_train_item(f, np.random.default_rng(f)), sj.get_train_item(f, np.random.default_rng(f))
        for k in ("uv", "rgb", "smpl_pose", "smpl_shape"):
            assert np.array_equal(a[k], b[k]), k
        for k in ("intrinsics", "pose", "smpl_trans"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the ViTPose glue and the external binaries
# ---------------------------------------------------------------------------


class StubDetector:
    """Detections near each prompt box's center, plus a weak one and a
    duplicate."""

    def __call__(self, image, boxes):
        rng = np.random.default_rng(int(image.sum()) % 1000)
        dets = []
        for x, y, w, h in boxes:
            kp = np.concatenate([rng.uniform([x, y], [x + w, y + h], (17, 2)), rng.uniform(0.5, 1, (17, 1))], 1)
            dets.append(kp.astype(np.float32))
        dets.append(dets[0] + np.array([1.0, 1.0, -0.2], np.float32))
        dets.append(np.concatenate([dets[-1][:, :2] + 60, np.full((17, 1), 0.1)], 1).astype(np.float32))
        return dets


def test_detect_and_track_matches_jax():
    inputs, *_ = make_trace_inputs(F=2, P=2)
    images = [np.full((60, 80, 3), 10 * f, np.uint8) for f in range(2)]
    boxes = np.array([[10, 5, 20, 40], [45, 5, 20, 40]], np.float32)
    centers = np.array([[20, 25], [55, 25]], np.float32)
    got = tvitpose.detect_and_track(StubDetector(), images[0], boxes, centers)
    assert np.array_equal(got, jvitpose.detect_and_track(StubDetector(), images[0], boxes, centers))
    far = np.array([[20, 25], [900, 900]], np.float32)
    got = tvitpose.detect_and_track(StubDetector(), images[1], boxes, far)
    assert np.array_equal(got, jvitpose.detect_and_track(StubDetector(), images[1], boxes, far)) and not got[1].any()
    a = ttrace.vitpose_keypoints(images, inputs.keypoints_2d, detector=StubDetector())
    assert np.array_equal(a, jtrace.vitpose_keypoints(images, inputs.keypoints_2d, detector=StubDetector()))


def test_video_stages_run_the_same_commands_as_jax(tmp_path, monkeypatch):
    """Stub `ffmpeg` and `trace2` on PATH log their argv: both packages run the
    same commands and return the same files; without them, the same message."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.log"
    (bin_dir / "ffmpeg").write_text(f'#!/bin/sh\necho "$@" >> {calls}\nfor last; do :; done\n'
                                    'd=$(dirname "$last"); : > "$d/0001.png"; : > "$d/0002.png"\n')
    (bin_dir / "trace2").write_text(f'#!/bin/sh\necho "$@" >> {calls}\n'
                                    'for a; do case "$a" in --results_save_dir=*) d=${a#*=};; esac; done\n'
                                    'mkdir -p "$d/seq"; : > "$d/seq/out.npz"\n')
    for b in ("ffmpeg", "trace2"):
        (bin_dir / b).chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    outs = []
    for pkg in (tvideo, jvideo):
        frames = pkg.extract_frames("raw.mp4", str(tmp_path / "frames"), time_start="00:00:01", time_duration="00:00:05")
        npz = pkg.run_trace(str(tmp_path / "frames"), str(tmp_path / "res"), subject_num=3, extra_args=["--x"])
        outs.append((frames, npz))
    assert outs[0] == outs[1]
    lines = calls.read_text().splitlines()
    assert len(lines) == 4 and lines[0] == lines[2] and lines[1] == lines[3]
    assert "-ss 00:00:01 -t 00:00:05 -vsync 0" in lines[0] and "--subject_num=3" in lines[1]

    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    msgs = []
    for pkg in (tvideo, jvideo):
        with pytest.raises(pkg.MissingBinaryError, match="ffmpeg") as e:
            pkg.extract_frames("v.mp4", str(tmp_path / "f2"))
        with pytest.raises(pkg.MissingBinaryError, match="trace2") as e2:
            pkg.run_trace(str(tmp_path / "f2"), str(tmp_path / "r2"), 2)
        msgs.append((str(e.value), str(e2.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the port's chain on one directory
# ---------------------------------------------------------------------------


def test_preprocess_train_test_one_directory(tmp_path, capsys):
    """`python -m multiply_tpu_torch.preprocessing` (CPU, 5 refinement
    iterations, full resolution) -> the training entry on
    `confs/taichi01_base.yaml` at the tiny widths of `test_torch_fit.TINY`, 2
    epochs, with the MPI-format pickle that `write_synthetic_smpl_dir` wrote
    -> the test entry on one frame, all on the directory the port wrote."""
    from multiply_tpu_torch.cli import test as cli_test
    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.data.dataset import Hi4DSequence
    from multiply_tpu_torch.preprocessing.__main__ import main as preprocess_main
    from test_torch_fit import TINY

    inputs, servers, *_ = make_trace_inputs(F=2, P=2)
    npz = str(tmp_path / "trace.npz")
    _raw_trace_npz(npz, inputs, servers)
    rng = np.random.default_rng(11)
    frames = _frames_dir(tmp_path / "frames", [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2)])
    smpl_dir = tpickle.write_synthetic_smpl_dir(str(tmp_path / "smpl"), num_verts=386)
    data_root = str(tmp_path / "data")
    seconds = preprocess_main(["--trace", npz, "--frames", frames, "--out", data_root, "--focal", "80", "--center", "40",
                               "30", "--refine_iters", "5", "--scale_factor", "1", "--device", "cpu", "--smpl_model",
                               os.path.join(smpl_dir, "SMPL_NEUTRAL.pkl")])
    assert set(seconds) == {"pnp", "refine", "finalize"}
    seq = Hi4DSequence(data_root, num_sample=16, using_sam=False)
    assert len(seq) == 2 and seq.num_person == 2 and seq.load_frame(0)["mask_union"].sum() > 20

    sets = [s for s in TINY if not s.startswith(("dataset.train.height", "dataset.train.width"))]
    sets += ["model.smpl_init=false", f"smpl_model_path={smpl_dir}"]
    run_dir = str(tmp_path / "run")
    common = ["--conf", os.path.join(ROOT, "confs", "taichi01_base.yaml"), "--data_root", data_root, "--run_dir",
              run_dir, "--device", "cpu", *(f"--set={s}" for s in sets)]
    capsys.readouterr()
    trainer = cli_train.main([*common, "--max_epochs", "2"])
    out = capsys.readouterr().out
    assert "falling back to the SYNTHETIC test body" not in out, "the train entry did not load the pickle"
    assert trainer.epoch == 2 and os.path.exists(os.path.join(run_dir, "checkpoints", "last"))
    assert trainer.servers[0].verts_c.shape == (386, 3)
    test_dir = cli_test.main([*common, "--frames", "1"])
    for sub in ("test_rendering", "test_fg_rendering", "test_normal", "test_mask"):
        assert glob.glob(os.path.join(test_dir, sub, "*.png")), sub
    assert read_png(os.path.join(test_dir, "test_rendering", "0000.png")).shape == (60, 160, 3)
