"""The port's mesh-over-image visualisation against
`multiply_tpu.engine.visualize`: shaded frames bit for bit, PNGs equal to
JAX's, and the port's own GIF writer decoded by Pillow (frames, size, 100 ms
a frame, looping, each frame within its palette's quantisation of its PNG)."""

import os

import numpy as np
import PIL.Image
import pytest

from multiply_tpu import native as jnative
from multiply_tpu.engine import visualize as jvis
from multiply_tpu_torch import native as tnative
from multiply_tpu_torch.engine import visualize as tvis
from multiply_tpu_torch.utils.io import gif_palette, read_png, write_gif
from test_mesh_ops import icosphere
from test_visualize import make_proj


def scene(n_meshes, H=40, W=52):
    rng = np.random.default_rng(n_meshes)
    v, f = icosphere(2)
    meshes = [(v * (0.8 + 0.3 * i) + np.array([0.35 * i, -0.2 * i, 0.1 * i]), f) for i in range(n_meshes)]
    return rng.random((H, W, 3)).astype(np.float32), meshes, make_proj(H, W)


def test_face_ids_match_jax():
    img, meshes, P = scene(1)
    vp = tvis.project_depth(P, meshes[0][0]).astype(np.float32)
    d1, f1 = tnative.rasterize_depth(vp, meshes[0][1], 52, 40, return_face_id=True)
    d2, f2 = jnative.rasterize_depth(vp, meshes[0][1], 52, 40, return_face_id=True)
    assert np.array_equal(d1, d2) and np.array_equal(f1, f2) and (f1[np.isfinite(d1)] >= 0).all()


@pytest.mark.parametrize("n_meshes", [1, 2])
def test_shading_matches_jax_bit_for_bit(n_meshes):
    """One mesh, and two overlapping ones where the nearer wins each pixel."""
    img, meshes, P = scene(n_meshes)
    got = tvis.shade_mesh_over_image(img, meshes, P)
    want = jvis.shade_mesh_over_image(img, meshes, P)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    changed = np.abs(got - img).sum(-1) > 0
    assert 0.05 < changed.mean() < 0.9


def _check_gif(path, pngs):
    im = PIL.Image.open(path)
    assert im.format == "GIF" and im.n_frames == len(pngs) and im.size == pngs[0].shape[1::-1]
    assert im.info.get("loop") == 0
    palette, index = gif_palette(pngs)
    for i, png in enumerate(pngs):
        im.seek(i)
        assert im.info["duration"] == 100
        dec = np.asarray(im.convert("RGB"))
        assert np.array_equal(dec, palette[index[i]])
        # the colour cube's half step per channel (6, 7, 6 levels), or exact
        bound = np.array([26, 22, 26]) if len(np.unique(np.concatenate([p.reshape(-1, 3) for p in pngs]), axis=0)) > 256 else 0
        assert (np.abs(dec.astype(int) - png).max(axis=(0, 1)) <= bound).all()


def test_export_writes_jax_pngs_and_a_gif(tmp_path):
    img, meshes, P = scene(2)
    imgs = [img, img[::-1].copy(), np.full_like(img, 0.8)]
    meshes_per_frame = [meshes, meshes[:1], meshes[1:]]
    tvis.export_visualization(str(tmp_path / "port"), imgs, meshes_per_frame, [P] * 3)
    jvis.export_visualization(str(tmp_path / "jax"), imgs, meshes_per_frame, [P] * 3)
    pngs = []
    for i in range(3):
        a = read_png(str(tmp_path / "port" / f"{i:04d}.png"))
        assert np.array_equal(a, np.asarray(PIL.Image.open(tmp_path / "jax" / f"{i:04d}.png").convert("RGB")))
        pngs.append(a)
    with open(tmp_path / "port" / "sequence.gif", "rb") as f:
        head = f.read()
    assert head.startswith(b"GIF89a") and head.count(b"\x21\xf9\x04") == 3
    _check_gif(str(tmp_path / "port" / "sequence.gif"), pngs)
    tvis.export_visualization(str(tmp_path / "nogif"), imgs[:1], meshes_per_frame[:1], [P], gif=False)
    assert os.listdir(tmp_path / "nogif") == ["0000.png"]


@pytest.mark.parametrize("colours", ["few", "many"])
def test_gif_writer_round_trips_through_pillow(tmp_path, colours):
    """At most 256 colours come back exact; more go through the colour cube.
    270 x 360 frames of noise make the LZW table fill and restart."""
    rng = np.random.default_rng(0)
    if colours == "few":
        frames = [(rng.integers(0, 5, (33, 47, 3)) * 60).astype(np.uint8) for _ in range(4)]
    else:
        frames = [rng.integers(0, 256, (270, 360, 3), dtype=np.uint8) for _ in range(2)]
    write_gif(str(tmp_path / "a.gif"), frames, fps=10)
    _check_gif(str(tmp_path / "a.gif"), frames)
