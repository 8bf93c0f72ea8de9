"""Writes the JPEG fixtures of `tests/test_torch_jpeg.py` and `tests/test_torch_cuda.py`
beside this file, each with a PNG of the pixels that OpenCV decodes from it
(`cv2.imread(path, cv2.IMREAD_COLOR)`, saved in RGB order).

    python tests/data/torch_jpeg/make_fixtures.py

Needs OpenCV and Pillow, which write the files; the port decodes them without
either. The images are drawn from a numpy seed: smooth shapes over a gradient
with a little noise (none on the 540x720 frame), so that the files stay small.
"""

import io
import os

import cv2
import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}


def scene(h, w, seed, noise=2.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 120 * x / w, 80 + 100 * y / h, 150 - 60 * (x + y) / (w + h)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.3) * min(h, w) + 1
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(20, 235, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write(name, data):
    with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
        f.write(data)
    decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
    ok, png = cv2.imencode(".png", np.ascontiguousarray(decoded[:, :, ::-1]), [cv2.IMWRITE_PNG_COMPRESSION, 9])
    with open(os.path.join(HERE, f"{name}.png"), "wb") as f:
        f.write(png.tobytes())


def encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
    return buf.tobytes()


def main():
    for i, (name, factor) in enumerate(SAMPLING.items()):
        write(f"sampling_{name}", encode(scene(45, 61, i), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor))
    write("progressive", encode(scene(51, 67, 10), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    write("restart", encode(scene(49, 83, 11), cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    ok, buf = cv2.imencode(".jpg", scene(37, 29, 12)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    write("gray", buf.tobytes())
    exif = PIL.Image.Exif()
    exif[0x0112] = 6
    bio = io.BytesIO()
    PIL.Image.fromarray(scene(33, 47, 13)).save(bio, "JPEG", quality=90, exif=exif.tobytes())
    write("exif6", bio.getvalue())
    write("frame_540x720", encode(scene(540, 720, 14, noise=0.0)))


if __name__ == "__main__":
    main()
