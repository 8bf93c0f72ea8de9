"""The port's data layer against the JAX package's and against OpenCV.

Same seeds, same outputs: the samplers, `Hi4DSequence`'s items and SAM
pickup on a fake preprocessed sequence, and `novel_view_cameras`, against
`multiply_tpu.data.dataset`; the PNG reader, the image reads, the gray test
and the mask band that replace OpenCV, against OpenCV; the camera
decomposition and the quaternion pose against OpenCV and the JAX package.
Also: no module of `multiply_tpu_torch` imports JAX, flax, the JAX package,
OpenCV, imageio, PIL, orbax, optax or transformers; and the training entry
builds a synthetic sequence as the JAX entry does.
"""

import ast
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from multiply_tpu.data import dataset as jds
from multiply_tpu.utils import cameras as jcam
from multiply_tpu_torch.data import dataset as tds
from multiply_tpu_torch.utils import cameras as tcam
from multiply_tpu_torch.utils.io import read_png, write_png

PKG = os.path.join(os.path.dirname(__file__), "..", "multiply_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "multiply_tpu", "cv2", "imageio", "PIL", "orbax", "optax", "transformers", "safetensors"}


def test_port_imports_none_of_the_forbidden_packages():
    """Every import statement of the package, module level or inside a function."""
    found = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                found += [(path, m) for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not found, found


# ---------------------------------------------------------------------------
# PNG and OpenCV replacements
# ---------------------------------------------------------------------------


def _png_filters(path):
    """The set of row filter types a PNG file uses."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        header = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else header
        if kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H, _, color = header[:4]
    stride = W * {0: 1, 2: 3, 6: 4}[color] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(H)}


def _filter_exercising_image(channels, rng):
    """Rows of noise, horizontal ramps, repeated rows and smooth 2-D fields, so
    that an adaptive encoder picks several filter types."""
    H, W = 64, 48
    y, x = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W, channels), np.float64)
    for c in range(channels):
        img[..., c] = 40 + 3 * x + 2 * y + 17 * c
    img[8:16] = img[8:9]  # repeated rows
    img[16:24] += rng.integers(0, 256, (8, W, channels))  # noise
    img[24:40] = (128 + 100 * np.sin(x[24:40] / 5.0 + y[24:40] / 7.0))[..., None] + 5 * np.arange(channels)
    img[40:48] = (x[40:48] * 5)[..., None]  # ramps
    img[48:56] = (60 + (x[48:56] + y[48:56]) * 2 + rng.integers(0, 3, (8, W)))[..., None]
    img = np.mod(img, 256).astype(np.uint8)
    for r in range(56, H):  # each byte the mean of its left and upper neighbours: the Average filter's rows
        img[r, 0] = rng.integers(0, 256, channels)
        for c in range(1, W):
            img[r, c] = (img[r, c - 1].astype(np.int64) + img[r - 1, c]) // 2
    return img


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    files = []
    for channels in (1, 3, 4):
        img = _filter_exercising_image(channels, rng)
        arr = img[..., 0] if channels == 1 else img
        p_cv, p_pil = str(d / f"cv_{channels}.png"), str(d / f"pil_{channels}.png")
        cv2.imwrite(p_cv, arr)
        PIL.Image.fromarray(arr).save(p_pil)
        files += [(p_cv, channels), (p_pil, channels)]
        for kind in ("NONE", "SUB", "UP", "AVG", "PAETH"):  # each filter forced on every row
            path = str(d / f"cv_{channels}_{kind}.png")
            cv2.imwrite(path, arr, [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{kind}")])
            files.append((path, channels))
    return files


def test_png_files_use_every_filter_type(png_files):
    used = set().union(*(_png_filters(p) for p, _ in png_files))
    assert used == {0, 1, 2, 3, 4}, used


def test_read_png_matches_cv2(png_files):
    for path, channels in png_files:
        got = read_png(path)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)  # BGR(A) order
        if channels == 3:
            want = want[..., ::-1]
        elif channels == 4:
            want = want[..., [2, 1, 0, 3]]
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_imread_bgr_matches_cv2_imread(png_files):
    for path, _ in png_files:
        np.testing.assert_array_equal(tds.imread_bgr(path), cv2.imread(path), err_msg=path)


def test_write_png_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((7, 9), (7, 9, 3), (7, 9, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"w{len(shape)}.png")
        write_png(path, img)
        np.testing.assert_array_equal(read_png(path), img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back, img if img.ndim == 2 else img[..., [2, 1, 0, 3][: img.shape[-1]]])


def test_read_png_refuses_other_formats(tmp_path):
    path = str(tmp_path / "p.png")
    PIL.Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png(path)
    path16 = str(tmp_path / "g16.png")
    cv2.imwrite(path16, np.arange(16, dtype=np.uint16).reshape(4, 4) * 1000)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(path16)


def test_gray_nonzero_matches_cv2():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 4, (40, 50, 3)).astype(np.uint8)  # values where the rounding decides
    img[:5] = rng.integers(0, 256, (5, 50, 3))
    want = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) > 0
    np.testing.assert_array_equal(tds.gray_nonzero(img), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_band_matches_cv2_morphology(seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((30, 41), np.uint8)
    for _ in range(4):  # boxes, some touching the image border
        y0, x0 = rng.integers(-3, 25), rng.integers(-3, 35)
        m[max(y0, 0) : y0 + rng.integers(2, 14), max(x0, 0) : x0 + rng.integers(2, 14)] = 1
    m[rng.random(m.shape) < 0.02] = 1
    k = np.ones((5, 5), np.uint8)
    want = (cv2.dilate(m, k) - cv2.erode(m, k)) > 0
    np.testing.assert_array_equal(tds.edge_band(m), want)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def test_load_K_Rt_from_P_matches_cv2():
    rng = np.random.default_rng(3)
    for i in range(40):
        K = np.array([[rng.uniform(50, 900), rng.uniform(-5, 5), rng.uniform(10, 500)],
                      [0, rng.uniform(50, 900), rng.uniform(10, 500)], [0, 0, 1]])
        q = rng.standard_normal(4)
        R = np.asarray(jcam.quat_to_rot(jnp.asarray(q / np.linalg.norm(q))), np.float64)
        t = rng.standard_normal(3) * 3
        P = (1 if i % 2 else -1) * rng.uniform(0.2, 5) * K @ np.concatenate([R, t[:, None]], 1)
        intr, pose = tcam.load_K_Rt_from_P(P)
        Kc, Rc, tc = cv2.decomposeProjectionMatrix(P)[:3]
        np.testing.assert_allclose(intr[:3, :3], Kc / Kc[2, 2], rtol=1e-5, atol=1e-5 * abs(Kc).max())
        np.testing.assert_allclose(pose[:3, :3], Rc.T, atol=1e-5)
        np.testing.assert_allclose(pose[:3, 3], (tc[:3] / tc[3])[:, 0], rtol=1e-5, atol=1e-5)
        jintr, jpose = jcam.load_K_Rt_from_P(P)
        np.testing.assert_allclose(intr, jintr, rtol=1e-5, atol=1e-5 * abs(jintr).max())
        np.testing.assert_allclose(pose, jpose, rtol=1e-5, atol=1e-5)


def test_quaternion_pose_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(10):
        q = rng.standard_normal(4).astype(np.float32)
        q[0] = abs(q[0]) + 0.5  # trace(R) > -1, as rot_to_quat assumes
        R = tcam.quat_to_rot(torch.tensor(q))
        np.testing.assert_allclose(R.numpy(), np.asarray(jcam.quat_to_rot(jnp.asarray(q))), atol=1e-6)
        np.testing.assert_allclose(tcam.rot_to_quat(R).numpy(), np.asarray(jcam.rot_to_quat(jnp.asarray(R.numpy()))),
                                   atol=1e-5)
        pose7 = np.concatenate([q, rng.standard_normal(3).astype(np.float32)])
        np.testing.assert_allclose(tcam.pose_from_quat7(torch.tensor(pose7)).numpy(),
                                   np.asarray(jcam.pose_from_quat7(jnp.asarray(pose7))), atol=1e-6)
        uv = rng.uniform(0, 64, (16, 2)).astype(np.float32)
        K = np.array([[60.0, 0.3, 31.2], [0, 58.0, 22.7], [0, 0, 1]], np.float32)
        d, c = tcam.get_camera_params(torch.tensor(uv), torch.tensor(pose7), torch.tensor(K))
        jd, jc = jcam.get_camera_params(jnp.asarray(uv), jnp.asarray(pose7), jnp.asarray(K))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _frame_data(seed, H=30, W=40, P=2):
    rng = np.random.default_rng(seed)
    mask = np.zeros((H, W), np.int64)
    mask[6:22, 9:31] = 1
    mask[10:14, 12:15] = 2
    uv = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).astype(np.float32)
    return {"rgb": rng.random((H, W, 3)).astype(np.float32), "uv": uv, "object_mask": mask,
            "sam_mask": rng.standard_normal((H, W, P)).astype(np.float32)}


@pytest.mark.parametrize("n", [1, 64, 513])
def test_weighted_sampling_matches_jax(n):
    data = _frame_data(n)
    got, got_out = tds.weighted_sampling(data, (30, 40), n, np.random.default_rng(7))
    want, want_out = jds.weighted_sampling(data, (30, 40), n, np.random.default_rng(7))
    np.testing.assert_array_equal(got_out, want_out)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.random((11, 13, 3))
    rows, cols = rng.uniform(-1, 12, 200), rng.uniform(-1, 14, 200)
    np.testing.assert_array_equal(tds.bilinear_sample(img, rows, cols), jds.bilinear_sample(img, rows, cols))
    np.testing.assert_array_equal(tds.bilinear_sample(img[..., 0], rows, cols), jds.bilinear_sample(img[..., 0], rows, cols))


@pytest.mark.parametrize("case", ["both", "no_edge", "empty"])
def test_edge_sampling_matches_jax(case):
    data = _frame_data(3)
    person = data.pop("object_mask") > 0
    edge = tds.edge_band(person) & person
    if case == "no_edge":
        edge[:] = False
    if case == "empty":
        person[:] = False
    data.update(person_mask=person, edge_mask=edge)
    got = tds.edge_sampling(data, 100, np.random.default_rng(9))
    want = jds.edge_sampling(data, 100, np.random.default_rng(9))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Hi4DSequence on a fake preprocessed sequence
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    """The layout of tests/test_dataset.py's fake sequence, with masks written
    both as gray and as colour PNGs, and an edge map directory left out."""
    root = str(tmp_path_factory.mktemp("seq"))
    F, P, H, W = 3, 2, 30, 40
    os.makedirs(os.path.join(root, "image"))
    rng = np.random.default_rng(0)
    for f in range(F):
        cv2.imwrite(os.path.join(root, "image", f"{f:04d}.png"), (rng.random((H, W, 3)) * 255).astype(np.uint8))
    for p in range(P):
        d = os.path.join(root, "mask", str(p))
        os.makedirs(d)
        for f in range(F):
            m = np.zeros((H, W), np.uint8)
            m[5 + 5 * p : 20 + 5 * p, 10 + 10 * p : 25 + 10 * p] = 255
            m[0, f] = 1  # a value that OpenCV's gray conversion keeps; as colour, one it drops
            img = m if p == 0 else np.stack([np.zeros_like(m), np.zeros_like(m), m], -1)
            cv2.imwrite(os.path.join(d, f"{f:04d}.png"), img)
    np.save(os.path.join(root, "mean_shape.npy"), rng.standard_normal((P, 10)).astype(np.float32))
    np.save(os.path.join(root, "poses.npy"), rng.standard_normal((F, P, 72)).astype(np.float32) * 0.1)
    np.save(os.path.join(root, "normalize_trans.npy"), rng.standard_normal((F, P, 3)).astype(np.float32))
    np.save(os.path.join(root, "gender.npy"), np.asarray(["male", "female"]))
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    cams = {}
    for f in range(F):
        Rt = np.eye(4)[:3]
        Rt[:3, 3] = [0.1 * f, 0, 4.0]
        P44 = np.eye(4, dtype=np.float32)
        P44[:3, :4] = K @ Rt
        cams[f"world_mat_{f}"] = P44
        cams[f"scale_mat_{f}"] = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    np.savez(os.path.join(root, "cameras_normalize.npz"), **cams)
    return root, (F, P, H, W)


def _assert_items_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        if k == "masks":
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def _pair(root, run_dir, **kw):
    return (tds.Hi4DSequence(root, run_dir=run_dir, **kw), jds.Hi4DSequence(root, run_dir=run_dir, **kw))


def test_hi4d_sequence_items_match_jax(fake_root, tmp_path):
    root, (F, P, H, W) = fake_root
    seq, jseq = _pair(root, str(tmp_path), num_sample=64, edge_sampling_on=True)
    assert (seq.img_size, seq.num_person, seq.genders, seq.scale) == (jseq.img_size, jseq.num_person, jseq.genders, jseq.scale)
    for f in range(F):
        _assert_items_equal(seq.get_train_item(f, np.random.default_rng(f)), jseq.get_train_item(f, np.random.default_rng(f)))
        _assert_items_equal(seq.get_eval_item(f), jseq.get_eval_item(f))
        for name in ("intrinsics", "pose", "P", "C"):
            np.testing.assert_allclose(getattr(seq, name)[f], getattr(jseq, name)[f], rtol=1e-5, atol=1e-5)


def test_hi4d_sam_pickup_and_certainty_match_jax(fake_root, tmp_path):
    root, (F, P, H, W) = fake_root
    run = str(tmp_path)
    rng = np.random.default_rng(1)
    smpl = np.zeros((F, P, H, W), bool)
    smpl[:, 0, 5:20, 10:25] = True
    smpl[:, 1, 10:25, 20:35] = True
    sam = np.where(smpl, 8.0, -8.0).astype(np.float32)
    sam[1, 0, :, :] = -8.0  # frame 1 disagrees: low IoU, uncertain
    sam[2] += rng.standard_normal(sam[2].shape).astype(np.float32) * 3
    for stage, name, arr in (("stage_instance_mask", "all_person_smpl_mask.npy", smpl),
                             ("stage_sam_mask", "sam_opt_mask.npy", sam)):
        os.makedirs(os.path.join(run, stage, "00050"))
        np.save(os.path.join(run, stage, "00050", name), arr)
    seq, jseq = _pair(root, run, num_sample=48, ratio_uncertain=0.5)
    for f in range(F):
        got, want = seq.get_train_item(f, np.random.default_rng(10 + f)), jseq.get_train_item(f, np.random.default_rng(10 + f))
        _assert_items_equal(got, want)
    np.testing.assert_array_equal(seq._sam_masks, jseq._sam_masks)
    np.testing.assert_allclose(seq.smpl_sam_iou, jseq.smpl_sam_iou, rtol=1e-12)
    assert seq.uncertain_threshold == jseq.uncertain_threshold
    assert not seq.get_train_item(1, np.random.default_rng(0))["is_certain"]
    assert "edge_uv" in seq.get_train_item(1, np.random.default_rng(0))


def test_hi4d_layout_errors_match_jax(fake_root, tmp_path):
    root, _ = fake_root
    for kw in ({"end_frame": 9}, {}):
        path = root if kw else str(tmp_path / "missing")
        with pytest.raises(FileNotFoundError) as got:
            tds.Hi4DSequence(path, **kw)
        with pytest.raises(FileNotFoundError) as want:
            jds.Hi4DSequence(path, **kw)
        assert str(got.value) == str(want.value)


def test_novel_view_cameras_match_jax(fake_root):
    root, _ = fake_root
    seq, jseq = _pair(root, ".", num_sample=8, using_sam=False)
    rng = np.random.default_rng(6)
    gt = {"ids": np.array([4, 7, 9]),
          "intrinsics": np.stack([np.array([[120.0 + 10 * i, 0, 20], [0, 118.0, 15], [0, 0, 1]]) for i in range(3)]),
          "extrinsics": np.stack([np.concatenate([np.eye(3) + 0.05 * rng.standard_normal((3, 3)),
                                                  rng.standard_normal((3, 1))], 1) for _ in range(3)])}
    got = tds.novel_view_cameras(seq, gt, current_view=7, novel_view=9)
    want = jds.novel_view_cameras(jseq, gt, current_view=7, novel_view=9)
    for g, w in zip(got, want):
        for k in ("P", "intrinsics", "pose"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5 * max(1.0, abs(w[k]).max()), err_msg=k)


def test_synthetic_sequence_ignores_ratio_uncertain_as_the_jax_entry_does(tmp_path):
    """`--set dataset.train.ratio_uncertain=0.2` on `confs/synthetic_base.yaml`:
    the JAX entry (`train.py`) builds its SyntheticSequence without the key,
    so at the default 0.5; the port's entry ends with the same
    `uncertain_threshold` once the stage files are picked up."""
    from multiply_tpu.config import load_config as jax_load_config
    from multiply_tpu.data.synthetic import make_scene as jax_make_scene
    from multiply_tpu.data.synthetic_sequence import SyntheticSequence as JaxSequence
    from multiply_tpu_torch.cli import train as cli_train
    from multiply_tpu_torch.config import load_config

    sets = ["dataset.train.ratio_uncertain=0.2", "dataset.train.end_frame=5", "dataset.train.height=12",
            "dataset.train.width=16"]
    conf_path = os.path.join(os.path.dirname(__file__), "..", "confs", "synthetic_base.yaml")
    run = str(tmp_path)
    seq = cli_train.build_sequence(load_config(conf_path, overrides=cli_train.parse_overrides(sets)), run, device="cpu")
    train_opt = jax_load_config(conf_path, overrides=cli_train.parse_overrides(sets)).dataset.train
    assert train_opt.ratio_uncertain == 0.2
    scene = jax_make_scene(num_frames=train_opt.get("end_frame", 4), num_persons=train_opt.get("num_person", 2),
                           height=train_opt.get("height", 48), width=train_opt.get("width", 64))
    jseq = JaxSequence(scene, num_sample=train_opt.num_sample, using_sam=train_opt.get("using_SAM", True), run_dir=run)
    F, P, H, W = 5, 2, 12, 16
    smpl = np.zeros((F, P, H, W), bool)
    smpl[:, :, 2:10, 3:12] = True
    sam = np.where(smpl, 8.0, -8.0).astype(np.float32)
    for f in range(F):  # frame f's SAM masks lose f + 1 rows: five different IoUs
        sam[f, :, 2 : 3 + f] = -8.0
    for stage, name, arr in (("stage_instance_mask", "all_person_smpl_mask.npy", smpl),
                             ("stage_sam_mask", "sam_opt_mask.npy", sam)):
        os.makedirs(os.path.join(run, stage, "00000"))
        np.save(os.path.join(run, stage, "00000", name), arr)
    seq._refresh_sam()
    jseq._refresh_sam()
    assert len(set(np.round(jseq.smpl_sam_iou, 9))) == F
    assert seq.ratio_uncertain == jseq.ratio_uncertain == 0.5
    assert seq.uncertain_threshold == jseq.uncertain_threshold
