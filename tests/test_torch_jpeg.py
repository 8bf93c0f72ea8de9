"""The port's JPEG decoder (`multiply_tpu_torch/utils/jpeg.py`) against OpenCV.

Every file here is written by `cv2.imencode`, Pillow or the fixture script's
own encoder (`tests/data/torch_jpeg/make_fixtures.py`: YCCK, arithmetic
coding, 12-bit and lossless files) and decoded by
`cv2.imdecode(..., cv2.IMREAD_COLOR)[:, :, ::-1]`, the JAX package's frame
reader; the port must give the same pixels bit for bit: the five sampling
factors that OpenCV writes, progressive, restart intervals, optimised tables,
grey, odd sizes, Pillow's files, every EXIF orientation, CMYK and YCCK,
arithmetic coding and lossless files. The modes that OpenCV reads as None
must raise with their names, and the committed fixtures must decode to their
committed PNGs. `chip_smoke.encode_jpeg`, the scaffold that makes path V's
frames where there is no encoder, is held to OpenCV's encoder.
"""

import glob
import importlib.util
import io
import os

import cv2
import numpy as np
import PIL.Image
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multiply_tpu_torch.utils.io import read_image, read_png, write_png
from multiply_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_jpeg")
_spec = importlib.util.spec_from_file_location("make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
MODES = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
         "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3], "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}
SIZES = [(1, 1), (2, 3), (17, 33), (16, 16), (31, 2), (540, 720)]


def _image(h, w, seed):
    """Smooth colour waves plus noise, or pure noise for odd seeds."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _opencv(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]


def _assert_same(data: bytes):
    want, got = _opencv(data), decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    diff = np.argwhere(got != want)
    assert not len(diff), f"{len(diff)} values differ, first at {diff[:3].tolist()}"


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("mode", list(MODES))
def test_opencv_files_decode_bit_for_bit(sampling, mode):
    for i, (h, w) in enumerate(SIZES):
        for quality in (95, 50):
            ok, buf = cv2.imencode(".jpg", _image(h, w, i), [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                                           *MODES[mode]])
            _assert_same(buf.tobytes())


@pytest.mark.parametrize("progressive", [False, True])
def test_grayscale_is_repeated_in_three_channels(progressive):
    for i, (h, w) in enumerate(SIZES):
        ok, buf = cv2.imencode(".jpg", _image(h, w, i)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                                 cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
        _assert_same(buf.tobytes())
        got = decode_jpeg(buf.tobytes())
        assert np.array_equal(got[..., 0], got[..., 1]) and np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("options", [{}, {"progressive": True}, {"optimize": True, "quality": 30},
                                     {"subsampling": 0, "quality": 95}, {"subsampling": 1}],
                         ids=["default", "progressive", "optimize", "444", "422"])
def test_pillow_files(options):
    for i, (h, w) in enumerate([(37, 53), (1, 1), (64, 40)]):
        bio = io.BytesIO()
        PIL.Image.fromarray(_image(h, w, i)).save(bio, "JPEG", **options)
        _assert_same(bio.getvalue())


def _with_orientation(img, orientation, subsampling=2):
    exif = PIL.Image.Exif()
    exif[0x0112] = orientation
    bio = io.BytesIO()
    PIL.Image.fromarray(img).save(bio, "JPEG", quality=90, subsampling=subsampling, exif=exif.tobytes())
    return bio.getvalue()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_opencv_applies_it(orientation):
    img = _image(37, 53, 0)
    for subsampling in (0, 2):
        data = _with_orientation(img, orientation, subsampling)
        _assert_same(data)
        assert decode_jpeg(data).shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))


@settings(max_examples=15, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 3))
def test_exif_orientation_6_over_sizes(h, w, seed):
    data = _with_orientation(_image(h, w, seed), 6)
    _assert_same(data)
    assert decode_jpeg(data).shape == (w, h, 3)


def test_rgb_component_ids_are_not_colour_converted():
    """No JFIF marker and component ids 'R', 'G', 'B': libjpeg keeps the
    samples as RGB."""
    ok, buf = cv2.imencode(".jpg", _image(24, 40, 0), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    data = bytearray(buf.tobytes())
    assert data[2:4] == b"\xff\xe0"
    data = data[:2] + data[4 + ((data[4] << 8) | data[5]):]  # drop the JFIF APP0 segment
    sof, sos = data.find(b"\xff\xc0"), data.find(b"\xff\xda")
    for k in range(3):
        data[sof + 10 + 3 * k] = data[sos + 5 + 2 * k] = b"RGB"[k]
    _assert_same(bytes(data))


def _patched(offset_from_sof, value):
    ok, buf = cv2.imencode(".jpg", _image(16, 16, 0))
    data = bytearray(buf.tobytes())
    data[data.find(b"\xff\xc0") + offset_from_sof] = value
    return bytes(data)


def _lossless(**kw):
    return make_fixtures.write_lossless(_image(9, 13, 0), 1, **kw)


def _with_jfif(data: bytes) -> bytes:
    return data[:2] + make_fixtures.segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") + data[2:]


REFUSED = {
    "hierarchical": lambda: _patched(1, 0xC5),
    "12-bit": lambda: _patched(4, 12),
    "lossless arithmetic": lambda: _lossless().replace(b"\xff\xc3", b"\xff\xcb", 1),
    "lossless 12-bit": lambda: make_fixtures.write_lossless(_image(9, 13, 0).astype(np.int64) * 16, 1, precision=12),
    "lossless YCbCr": lambda: _with_jfif(_lossless()),
    "lossless greyscale": lambda: make_fixtures.write_lossless(_image(9, 13, 0)[..., :1], 1),
}


@pytest.mark.parametrize("mode", list(REFUSED))
def test_refused_modes_raise_with_their_name(mode):
    """Each mode that `cv2.imread` reads as None (the JAX chain then fails on
    indexing None) raises, naming itself and OpenCV."""
    data = REFUSED[mode]()
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(NotImplementedError, match=f"{mode}.*OpenCV.*reads none"):
        decode_jpeg(data)


def test_cmyk_is_refused_and_garbage_is_malformed():
    """(Named from when CMYK was refused.) Pillow's CMYK file decodes to
    OpenCV's pixels; garbage is malformed."""
    bio = io.BytesIO()
    PIL.Image.fromarray(_image(16, 16, 0)).convert("CMYK").save(bio, "JPEG")
    _assert_same(bio.getvalue())
    ok, buf = cv2.imencode(".jpg", _image(16, 16, 0))
    bad_dc = bytearray(buf.tobytes())
    dht = bad_dc.find(b"\xff\xc4")
    assert bad_dc[dht + 4] == 0x00  # the first table is a DC table: its first symbol becomes size 16
    bad_dc[dht + 5 + 16] = 16
    for data in (b"", b"\xff\xd8\xff\xd9", b"\x89PNG\r\n\x1a\n", bytes(bad_dc)):
        with pytest.raises(ValueError, match="malformed"):
            decode_jpeg(data)


def _cmyk(h, w, seed, factors, coding, transform, progressive=False, restart=0):
    c, m, y, k = make_fixtures.cmyk_planes(h, w, seed)
    planes = [*make_fixtures.ycc(255 - np.stack([c, m, y], -1)), k] if transform == 2 else [c, m, y, k]
    return make_fixtures.write_jpeg(planes, factors, w, h, coding=coding, progressive=progressive, restart=restart,
                                    adobe=transform, jfif=False)


ENCODED = {
    **{f"arithmetic-{name}-{'progressive' if prog else 'sequential'}-rst{rst}": (
        lambda f=f, prog=prog, rst=rst, i=i: make_fixtures.write_jpeg(
            make_fixtures.ycc(make_fixtures.scene(23 + i, 37 - i, i).astype(np.float64)), f, 37 - i, 23 + i,
            coding="arithmetic", progressive=prog, restart=rst, dac=(i % 2, 1 + i % 3, 1 + 7 * i)))
       for i, (name, f) in enumerate({"420": [(2, 2), (1, 1), (1, 1)], "444": [(1, 1)] * 3,
                                      "422": [(2, 1), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)]}.items())
       for prog in (False, True) for rst in (0, 2)},
    "arithmetic-grey-progressive": lambda: make_fixtures.write_jpeg(
        [make_fixtures.scene(19, 21, 5)[..., 1].astype(np.float64)], [(1, 1)], 21, 19, coding="arithmetic",
        progressive=True, restart=1),
    **{f"{'ycck' if t == 2 else 'cmyk'}-{coding}": (lambda t=t, coding=coding: _cmyk(
        29, 34, 7, [(2, 2), (1, 1), (1, 1), (2, 2)], coding, t, progressive=coding == "arithmetic", restart=1))
       for t in (0, 2) for coding in ("huffman", "arithmetic")},
    "cmyk-no-adobe-marker": lambda: _cmyk(13, 9, 8, [(1, 1)] * 4, "huffman", None),
    **{f"lossless-predictor{p}": (lambda p=p: make_fixtures.write_lossless(make_fixtures.scene(17, 23, p), p,
                                                                          point_transform=p % 3))
       for p in range(1, 8)},
    "lossless-6bit": lambda: make_fixtures.write_lossless(make_fixtures.scene(11, 7, 9) >> 2, 4, precision=6),
    "lossless-cmyk": lambda: make_fixtures.write_lossless(
        np.stack(make_fixtures.cmyk_planes(13, 17, 10), -1).astype(np.uint8), 6),
}


@pytest.mark.parametrize("name", list(ENCODED))
def test_encoded_modes_decode_bit_for_bit(name):
    """The modes that neither OpenCV nor Pillow writes, from the fixture
    script's encoder: arithmetic coding (sequential and progressive, every
    sampling, restarts, conditioning tables through DAC), CMYK and YCCK,
    lossless with each predictor and point transform."""
    _assert_same(ENCODED[name]())


def test_read_image_tells_the_format_by_its_signature(tmp_path):
    img = _image(20, 30, 0)
    write_png(str(tmp_path / "a.jpg"), img)  # a PNG whatever its name
    assert np.array_equal(read_image(str(tmp_path / "a.jpg")), img)
    write_png(str(tmp_path / "g.png"), img[..., 0])
    assert np.array_equal(read_image(str(tmp_path / "g.png")), np.repeat(img[..., :1], 3, -1))
    ok, buf = cv2.imencode(".jpg", img)
    (tmp_path / "b.png").write_bytes(buf.tobytes())  # a JPEG whatever its name
    assert np.array_equal(read_image(str(tmp_path / "b.png")), _opencv(buf.tobytes()))
    (tmp_path / "c.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither"):
        read_image(str(tmp_path / "c.jpg"))


COMMITTED = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))


def test_the_committed_fixtures_are_all_there():
    assert COMMITTED == sorted(["sampling_444", "sampling_422", "sampling_420", "sampling_440", "sampling_411",
                                "progressive", "restart", "gray", "exif6", "frame_540x720", "cmyk", "ycck",
                                "arith_sequential", "arith_progressive_restart", "bits12", "lossless"])


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_fixtures_decode_to_their_opencv_pixels(name):
    """Each fixture against its PNG of OpenCV's pixels; a fixture without a
    PNG is one that OpenCV reads as None, and the port refuses it."""
    path = os.path.join(FIXTURES, f"{name}.jpg")
    if not os.path.exists(path[:-4] + ".png"):
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None
        with pytest.raises(NotImplementedError, match="OpenCV.*reads none"):
            read_jpeg(path)
        return
    want = read_png(path[:-4] + ".png")
    assert np.array_equal(read_jpeg(path), want), path
    assert np.array_equal(want, cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]), path


def _tables(data: bytes) -> dict:
    """The quantisation and Huffman tables of a JPEG's header, by kind and slot."""
    out, i = {}, 2
    while data[i + 1] != 0xDA:
        length = (data[i + 2] << 8) | data[i + 3]
        seg, p = data[i + 4:i + 2 + length], 0
        while data[i + 1] in (0xDB, 0xC4) and p < len(seg):
            n = 65 if data[i + 1] == 0xDB else 17 + sum(seg[p + 1:p + 17])
            out[(data[i + 1], seg[p])] = seg[p + 1:p + n]
            p += n
        i += 2 + length
    return out


def test_chip_smoke_scaffold_encoder_writes_what_opencv_reads():
    """`chip_smoke.encode_jpeg`, which makes path V's frames on a machine
    without an encoder: OpenCV's tables at the same quality (Annex K), OpenCV
    and the port decode its files alike, and the frames keep OpenCV's own
    encoder's PSNR."""
    import chip_smoke

    rng = np.random.default_rng(7)
    img = (100 + 40 * rng.random((67, 90, 3))).astype(np.uint8)
    img[10:40, 20:60] = (230, 110, 90)
    ours = chip_smoke.encode_jpeg(img)
    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, chip_smoke.JPEG_QUALITY])
    assert _tables(ours) == _tables(buf.tobytes())
    _assert_same(ours)
    psnr = [10 * np.log10(255 ** 2 / ((decode_jpeg(d).astype(np.float64) - img) ** 2).mean())
            for d in (ours, buf.tobytes())]
    assert psnr[0] > chip_smoke.JPEG_MIN_PSNR and abs(psnr[0] - psnr[1]) < 0.5, psnr
