"""JPEG decoding on the host, pixel for pixel as `cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]`.

The decoder is C++ (`csrc/jpeg_decode.cpp`): 8-bit files, sequential and
progressive, Huffman- or arithmetic-coded, lossless files of 2-8 bits, with
restart intervals, every integral sampling factor, grey, YCbCr, RGB, CMYK and
YCCK and the EXIF orientation, decoded with libjpeg's integer IDCT, fancy
upsampling and fixed-point colour tables and OpenCV's CMYK conversion, as
OpenCV's libjpeg-turbo does. It is built with `cuda_build.build_host` into
`_build/libjpeg_decode.so` on first use and loaded with `ctypes`, as
`native.py` loads its library. The modes that `cv2.imread` reads as None
(12-bit samples, hierarchical coding, lossless files of more than 8 bits,
arithmetic-coded or needing a colour conversion) raise `NotImplementedError`
naming the mode; a malformed file raises `ValueError`.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .. import cuda_build

SOURCE = os.path.join(cuda_build.CSRC_DIR, "jpeg_decode.cpp")
JPEG_SIGNATURE = b"\xff\xd8\xff"
_ERRLEN = 512


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(cuda_build.build_host("jpeg_decode", [SOURCE]))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_dims.restype = ctypes.c_int
    lib.jpeg_dims.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode_rgb.restype = ctypes.c_int
    lib.jpeg_decode_rgb.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    return lib


def _raise(code: int, err: ctypes.Array) -> None:
    msg = err.value.decode(errors="replace")
    raise (NotImplementedError if code == 2 else ValueError)(msg)


def decode_jpeg(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of a JPEG file's bytes, oriented as its
    EXIF tag says."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERRLEN)
    dims = (ctypes.c_int32 * 2)()
    code = lib.jpeg_dims(ptr, len(buf), dims, err, _ERRLEN)
    if code:
        _raise(code, err)
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    code = lib.jpeg_decode_rgb(ptr, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size, err,
                               _ERRLEN)
    if code:
        _raise(code, err)
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
