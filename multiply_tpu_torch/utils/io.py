"""Small host-IO helpers: atomic .npy publishing and an 8-bit PNG codec.

The epoch-end stages may run in a background thread while the data producer
polls their output files, so `atomic_np_save` writes to a temporary file and
`os.replace`s it: a reader never sees a half-written array.

`write_png` / `read_png` replace `imageio`, `cv2.imwrite` and `cv2.imread`,
which the port does not depend on; `read_image` reads a PNG or a JPEG
(`utils/jpeg.py`) as `cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]` does. They take 8-bit gray, RGB and RGBA
images, non-interlaced; the reader undoes all five row filters and raises on
any other PNG (palette, gray + alpha, 16-bit, interlaced).

`write_gif` replaces `imageio.mimsave(..., fps=...)`: a looping GIF89a with
one global palette, the frames' own colours when they have at most 256,
else a 6 x 7 x 6 colour cube with each channel rounded to its nearest level.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def atomic_np_save(path: str, arr: np.ndarray) -> None:
    """np.save that readers can never observe half-written."""
    tmp = f"{path}.tmp{os.getpid()}.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) or (H, W, 1 | 3 | 4) uint8 array as a PNG (filter 0 on
    every row, zlib level 6), through a temporary file and `os.replace`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1|3|4), got {img.shape}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    data = (
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPES[C], 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter on one row (bytes as int16, prior row decoded)."""
    out = np.zeros_like(line)
    n = len(line)
    for i in range(n):
        a = int(out[i - bpp]) if i >= bpp else 0
        b = int(prior[i])
        c = int(prior[i - bpp]) if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (int(line[i]) + pred) & 0xFF
    return out


def _average_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = np.zeros_like(line)
    for i in range(len(line)):
        a = int(out[i - bpp]) if i >= bpp else 0
        out[i] = (int(line[i]) + ((a + int(prior[i])) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, H: int, W: int, bpp: int) -> np.ndarray:
    stride = W * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != H * (stride + 1):
        raise ValueError(f"PNG image data has {data.size} bytes, expected {H * (stride + 1)}")
    data = data.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.int16)
    for y in range(H):
        kind, line = int(data[y, 0]), data[y, 1:].astype(np.int16)
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: a running sum along each byte lane of the row
            row = np.cumsum(line.reshape(W, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            row = (line + prior) & 0xFF
        elif kind == 3:
            row = _average_row(line, prior, bpp)
        elif kind == 4:
            row = _paeth_row(line, prior, bpp)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = row
        prior = out[y].astype(np.int16)
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4) PNG, in
    the file's channel order. Raises ValueError on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    W, H, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, interlace {interlace}); "
            "8-bit gray, RGB or RGBA, non-interlaced, is supported"
        )
    C = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), H, W, C).reshape(H, W, C)
    return img[..., 0] if C == 1 else img


_CUBE = (6, 7, 6)  # levels of R, G, B in the palette of frames with more than 256 colours


def gif_palette(frames: list[np.ndarray]) -> tuple[np.ndarray, list[np.ndarray]]:
    """(palette (256, 3) uint8, per frame (H, W) uint8 indices) of (H, W, 3)
    uint8 frames: their exact colours when there are at most 256, else the
    colour cube."""
    flat = np.concatenate([f.reshape(-1, 3) for f in frames])
    colours, inverse = np.unique(flat, axis=0, return_inverse=True)
    if len(colours) <= 256:
        palette = np.zeros((256, 3), np.uint8)
        palette[: len(colours)] = colours
        index = inverse.reshape(-1).astype(np.uint8)
    else:
        levels = np.asarray(_CUBE)
        q = np.rint(flat.astype(np.float64) * (levels - 1) / 255.0).astype(np.int64)
        index = ((q[:, 0] * levels[1] + q[:, 1]) * levels[2] + q[:, 2]).astype(np.uint8)
        grid = np.stack(np.meshgrid(*(np.arange(n) for n in _CUBE), indexing="ij"), -1).reshape(-1, 3)
        palette = np.zeros((256, 3), np.uint8)
        palette[: len(grid)] = np.rint(grid * 255.0 / (levels - 1)).astype(np.uint8)
    sizes = np.cumsum([0] + [f.shape[0] * f.shape[1] for f in frames])
    return palette, [index[a:b].reshape(f.shape[:2]) for a, b, f in zip(sizes[:-1], sizes[1:], frames)]


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of 8-bit indices, codes packed LSB first."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size, next_code, table = min_size + 1, eoi + 1, {}
    emit(clear, size)
    w = indices[0]
    for c in indices[1:]:
        key = (w, c)
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, size)
        if next_code >= (1 << size) and size < 12:
            size += 1
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
        else:
            emit(clear, size)
            size, next_code, table = min_size + 1, eoi + 1, {}
        w = c
    emit(w, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: list[np.ndarray], fps: float = 10.0) -> None:
    """A looping GIF89a of (H, W, 3) uint8 frames, 1 / fps seconds each (in
    hundredths), through a temporary file and `os.replace`."""
    H, W = frames[0].shape[:2]
    palette, indices = gif_palette(frames)
    delay = int(round(100.0 / fps))
    data = bytearray(b"GIF89a" + struct.pack("<HHBBB", W, H, 0xF7, 0, 0) + palette.tobytes())
    data += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for idx in indices:
        data += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        data += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0) + b"\x08"
        code = _lzw(idx.tobytes())
        for i in range(0, len(code), 255):
            block = code[i : i + 255]
            data += bytes([len(block)]) + block
        data += b"\x00"
    data += b"\x3b"
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(bytes(data))
    os.replace(tmp, path)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG or JPEG file, told apart by its signature:
    grey repeated in three channels, alpha dropped."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head.startswith(PNG_SIGNATURE):
        img = read_png(path)
        return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
    from .jpeg import JPEG_SIGNATURE, read_jpeg

    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
