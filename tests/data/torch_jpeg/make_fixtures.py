"""Writes the JPEG fixtures of `tests/test_torch_jpeg.py` and `tests/test_torch_cuda.py`
beside this file, each with a PNG of the pixels that OpenCV decodes from it
(`cv2.imread(path, cv2.IMREAD_COLOR)`, saved in RGB order).

    python tests/data/torch_jpeg/make_fixtures.py

Needs OpenCV and Pillow. OpenCV and Pillow write the baseline, progressive,
restart, grey, EXIF and CMYK files; the modes that neither writes (YCCK,
arithmetic coding, 12-bit samples, lossless) come from this script's own
encoder (`write_jpeg`: a float DCT, flat Huffman tables or the T.81 Annex D
QM coder with conditioning tables, restart intervals and the progressive
scans of Annex G, and the Annex H predictors). The port decodes every file
without OpenCV. A mode that OpenCV reads as None gets no PNG: the port must
refuse it. The images are drawn from a numpy seed: smooth shapes over a
gradient with a little noise (none on the 540x720 frame), so that the files
stay small.
"""

import io
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
          14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39,
          46, 53, 60, 61, 54, 47, 55, 62, 63)
# T.81 Annex K.1 at quality 90 (the Annex K tables scaled as libjpeg scales them), natural order
QUANT = (np.clip((np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
                            56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
                            104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]) * 20
                  + 50) // 100, 1, 255),
         np.clip((np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
                           + [47, 66] + [99] * 38) * 20 + 50) // 100, 1, 255))

# T.81 Table D.2 (libjpeg's jaricom.c, with its entry 113, a fixed estimate of one half): Qe, next index after
# an LPS, after an MPS, and whether an LPS switches the MPS sense
QE = ((0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
      (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
      (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
      (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
      (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
      (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
      (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
      (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
      (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
      (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
      (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
      (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
      (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
      (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
      (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
      (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
      (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
      (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
      (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
      (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
      (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
      (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0),
      (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))


def scene(h, w, seed, noise=2.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 120 * x / w, 80 + 100 * y / h, 150 - 60 * (x + y) / (w + h)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.3) * min(h, w) + 1
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(20, 235, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---- the encoder ----

def segment(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def stuff(data: bytes) -> bytes:
    return data.replace(b"\xff", b"\xff\x00")


def ycc(rgb):
    """JFIF's RGB -> YCbCr of (..., 3) floats, and of libjpeg's YCCK input (1 - CMY as RGB)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return [0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


class Component:
    """One component: its id, sampling factors, quantisation table index and
    the (rows, cols) of its 8x8 blocks' quantised coefficients, zigzag order."""

    def __init__(self, cid, h, v, tq, plane, mcux, mcuy, hmax, vmax, width, height, precision, qt):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.width = -(-width * h // hmax)
        self.height = -(-height * v // vmax)
        bh, bw = mcuy * v * 8, mcux * h * 8
        p = np.pad(plane[: self.height, : self.width], ((0, max(0, bh - self.height)), (0, max(0, bw - self.width))),
                   mode="edge")[:bh, :bw]
        u = np.arange(8)
        dct = np.sqrt(2 / 8) * np.cos((2 * u[None] + 1) * u[:, None] * np.pi / 16)
        dct[0] /= np.sqrt(2)
        blocks = (p - (1 << (precision - 1))).reshape(bh // 8, 8, bw // 8, 8).transpose(0, 2, 1, 3)
        q = np.rint(dct @ blocks @ dct.T / np.asarray(qt).reshape(8, 8)).astype(np.int64)
        self.coef = q.reshape(q.shape[0], q.shape[1], 64)[..., list(ZIGZAG)]


def frame_components(planes, factors, width, height, precision, qts, tqs, ids=None):
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    comps = []
    for i, (plane, (h, v)) in enumerate(zip(planes, factors)):
        fy, fx = vmax // v, hmax // h  # a subsampled plane: the mean of each fy x fx cell
        H2, W2 = -(-height // fy) * fy, -(-width // fx) * fx
        full = np.pad(plane, ((0, H2 - height), (0, W2 - width)), mode="edge")
        sub = full.reshape(H2 // fy, fy, W2 // fx, fx).mean((1, 3))
        comps.append(Component(ids[i] if ids else i + 1, h, v, tqs[i], sub, mcux, mcuy, hmax, vmax, width, height,
                               precision, qts[tqs[i]]))
    return comps, mcux, mcuy


def scan_blocks(comps, mcux, mcuy):
    """(component index, block row, block col) in a scan's order: MCU by MCU
    when it holds several components, else the component's own blocks."""
    if len(comps) == 1:
        c = comps[0]
        for by in range(-(-c.height // 8)):
            for bx in range(-(-c.width // 8)):
                yield 0, by, bx, True
        return
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, c in enumerate(comps):
                for y in range(c.v):
                    for x in range(c.h):
                        yield ci, my * c.v + y, mx * c.h + x, (y, x) == (c.v - 1, c.h - 1) and ci == len(comps) - 1


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, code: str):
        self.bits.append(code)

    def flush(self) -> bytes:
        s = "".join(self.bits)
        s += "1" * (-len(s) % 8)
        self.bits = []
        return stuff(int(s, 2).to_bytes(len(s) // 8, "big")) if s else b""


def flat_table(symbols, length):
    """A Huffman table that gives every symbol a code of `length` bits: (DHT counts, symbols, {symbol: code})."""
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    return counts, list(symbols), {s: format(i, f"0{length}b") for i, s in enumerate(symbols)}


def magnitude(v):
    size = int(abs(v)).bit_length()
    return size, (format(v if v >= 0 else v + (1 << size) - 1, f"0{size}b") if size else "")


class QMEncoder:
    """T.81 Annex D's arithmetic encoder, the code register kept whole (no
    carry to propagate): the output is the shortest tail of the final
    interval's lower end that the decoder's zero fill keeps inside it."""

    def __init__(self):
        self.c, self.a, self.shifts = 0, 0x10000, 0

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nlps, nmps, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (switch << 7) ^ nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) | nmps
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.shifts += 1

    def flush(self) -> bytes:
        t = ((self.c + self.a - 1) >> 16) << 16
        if t < self.c:
            t += 0x8000
        bits = self.shifts + 16
        nbytes = -(-bits // 8)
        data = (t << (8 * nbytes - bits)).to_bytes(nbytes, "big").rstrip(b"\x00")
        return stuff(data)


class ArithStats:
    """The conditioning state of one scan: 64 DC and 256 AC bins a table, the
    fixed bin, each component's DC prediction and context."""

    def __init__(self, ncomp):
        self.dc = [[0] * 64 for _ in range(4)]
        self.ac = [[0] * 256 for _ in range(4)]
        self.fixed = [113]
        self.last_dc = [0] * ncomp
        self.dc_ctx = [0] * ncomp


def arith_magnitude(enc, stats, i0, v, big_bin, extra_first=False):
    """Figures F.8-F.9: the magnitude category of v > 0 (less one) and its
    bits, from bin i0 of `stats`; categories above the first go to `big_bin`
    (X1). For AC coefficients, the second category bit is coded at i0 too."""
    m, i = 0, i0
    v -= 1
    if v:
        enc.encode(stats, i, 1)
        m, v2 = 1, v
        if extra_first:
            v2 >>= 1
            if v2:
                enc.encode(stats, i, 1)
                m <<= 1
                i = big_bin
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(stats, i, 1)
                    m <<= 1
                    i += 1
        else:
            i = big_bin
            while v2 >> 1:
                v2 >>= 1
                enc.encode(stats, i, 1)
                m <<= 1
                i += 1
    enc.encode(stats, i, 0)
    i += 14
    mm = m
    while mm >> 1:
        mm >>= 1
        enc.encode(stats, i, 1 if mm & v else 0)
    return m


def arith_dc(enc, st: ArithStats, ci, tbl, diff, dc_l, dc_u):
    """Figure F.4 with the conditioning of F.1.4.4.1.2."""
    bins, s0 = st.dc[tbl], st.dc_ctx[ci]
    if diff == 0:
        enc.encode(bins, s0, 0)
        st.dc_ctx[ci] = 0
        return
    enc.encode(bins, s0, 1)
    sign = diff < 0
    enc.encode(bins, s0 + 1, int(sign))
    st.dc_ctx[ci] = 8 if sign else 4
    m = arith_magnitude(enc, bins, s0 + 2 + int(sign), abs(diff), 20)
    if m < (1 << dc_l) >> 1:
        st.dc_ctx[ci] = 0
    elif m > (1 << dc_u) >> 1:
        st.dc_ctx[ci] += 8


def arith_ac(enc, st: ArithStats, tbl, zz, ss, se, al, kx):
    """Figure F.5 over zigzag positions ss..se of one block, point transform al."""
    bins = st.ac[tbl]

    def shifted(k):
        v = int(zz[k])
        return v >> al if v >= 0 else -((-v) >> al)

    ke = se
    while ke >= ss and shifted(ke) == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(bins, i, 0)
        while shifted(k) == 0:
            enc.encode(bins, i + 1, 0)
            i += 3
            k += 1
        v = shifted(k)
        enc.encode(bins, i + 1, 1)
        enc.encode(st.fixed, 0, int(v < 0))
        arith_magnitude(enc, bins, i + 2, abs(v), 189 if k <= kx else 217, extra_first=True)
        k += 1
    if k <= se:
        enc.encode(bins, 3 * (k - 1), 1)


def arith_ac_refine(enc, st: ArithStats, tbl, zz, ss, se, ah, al):
    """Figure G.10: one bit plane (al) of positions ss..se after the planes above it (ah)."""
    bins = st.ac[tbl]

    def mag(k, shift):
        return abs(int(zz[k])) >> shift

    ke = se
    while ke >= ss and mag(ke, al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and mag(kex, ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(bins, i, 0)
        while True:
            m = mag(k, al)
            if m:
                if m >> 1:
                    enc.encode(bins, i + 2, m & 1)
                else:
                    enc.encode(bins, i + 1, 1)
                    enc.encode(st.fixed, 0, int(zz[k] < 0))
                break
            enc.encode(bins, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(bins, 3 * (k - 1), 1)


def encode_scan(comps, tbls, mcux, mcuy, coding, restart, ss=0, se=63, ah=0, al=0, progressive=False, huff=None,
                dac=(0, 1, 5)):
    """The entropy-coded data of one scan (RSTn markers included); `tbls`
    holds each scan component's table index."""
    dc_l, dc_u, kx = dac
    out, units, done = [], [], 0
    blocks = list(scan_blocks(comps, mcux, mcuy))
    # restart units: an MCU, or a block in a one-component scan
    unit = []
    for b in blocks:
        unit.append(b)
        if b[3]:
            units.append(unit)
            unit = []
    interval = restart or len(units)
    for start in range(0, len(units), interval):
        if start:
            out.append(bytes([0xFF, 0xD0 + (start // interval - 1) % 8]))
        chunk = [b for u in units[start:start + interval] for b in u]
        if coding == "huffman":
            bw, pred = BitWriter(), [0] * len(comps)
            for ci, by, bx, _ in chunk:
                zz = comps[ci].coef[by, bx]
                dc_codes, ac_codes = huff
                size, bits = magnitude(int(zz[0]) - pred[ci])
                pred[ci] = int(zz[0])
                bw.put(dc_codes[size] + bits)
                last = 0
                for k in np.flatnonzero(zz[1:]) + 1:
                    run = k - last - 1
                    while run > 15:
                        bw.put(ac_codes[0xF0])
                        run -= 16
                    size, bits = magnitude(int(zz[k]))
                    bw.put(ac_codes[run << 4 | size] + bits)
                    last = k
                if last < 63:
                    bw.put(ac_codes[0x00])
            out.append(bw.flush())
        else:
            enc, st = QMEncoder(), ArithStats(len(comps))
            for ci, by, bx, _ in chunk:
                zz = comps[ci].coef[by, bx]
                tbl = tbls[ci]
                if not progressive:
                    arith_dc(enc, st, ci, tbl, int(zz[0]) - st.last_dc[ci], dc_l, dc_u)
                    st.last_dc[ci] = int(zz[0])
                    arith_ac(enc, st, tbl, zz, 1, 63, 0, kx)
                elif ss == 0 and ah == 0:
                    v = int(zz[0]) >> al
                    arith_dc(enc, st, ci, tbl, v - st.last_dc[ci], dc_l, dc_u)
                    st.last_dc[ci] = v
                elif ss == 0:
                    enc.encode(st.fixed, 0, (int(zz[0]) >> al) & 1)
                elif ah == 0:
                    arith_ac(enc, st, tbl, zz, ss, se, al, kx)
                else:
                    arith_ac_refine(enc, st, tbl, zz, ss, se, ah, al)
            out.append(enc.flush())
    return b"".join(out)


def progressive_script(ncomp):
    """(Ss, Se, Ah, Al, component or None for all) of a progressive file that
    runs every procedure of Annex G and leaves every coefficient complete."""
    first = [(0, 0, 0, 1, None), (1, 5, 0, 2, 0), (6, 63, 0, 2, 0)] + [(1, 63, 0, 1, c) for c in range(1, ncomp)]
    return first + [(1, 63, 2, 1, 0), (0, 0, 1, 0, None)] + [(1, 63, 1, 0, c) for c in range(ncomp)]


def write_jpeg(planes, factors, width, height, *, coding="huffman", progressive=False, precision=8, restart=0,
               adobe=None, jfif=True, ids=None, dac=None):
    """A JPEG file of float `planes` (already in the file's colour space)."""
    ncomp = len(planes)
    tqs = [0] + [1] * (ncomp - 1) if ncomp > 1 else [0]
    if ncomp == 4:
        tqs = [0, 1, 1, 0]
    qts = [np.asarray(q, np.int64) * (16 if precision == 12 else 1) for q in QUANT]
    comps, mcux, mcuy = frame_components(planes, factors, width, height, precision, qts, tqs, ids)
    pq = 1 if precision == 12 else 0
    head = b"\xff\xd8"
    if jfif:
        head += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    head += segment(0xDB, b"".join(bytes([pq << 4 | i]) + b"".join(
        struct.pack(">H" if pq else ">B", int(q[z])) for z in ZIGZAG) for i, q in enumerate(qts)))
    if restart:
        head += segment(0xDD, struct.pack(">H", restart))
    sof = {("huffman", False): 0xC1 if precision == 12 else 0xC0, ("huffman", True): 0xC2,
           ("arithmetic", False): 0xC9, ("arithmetic", True): 0xCA}[(coding, progressive)]
    head += segment(sof, struct.pack(">BHHB", precision, height, width, ncomp)
                    + b"".join(bytes([c.id, c.h << 4 | c.v, c.tq]) for c in comps))
    huff = None
    if coding == "huffman":
        dc_symbols = range(16 if precision == 12 else 12)
        ac_symbols = [0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 15 if precision == 12 else 11)]
        tables = [flat_table(dc_symbols, 5), flat_table(ac_symbols, 8)]
        head += segment(0xC4, b"".join(bytes([cls << 4 | 0]) + bytes(t[0]) + bytes(t[1])
                                       for cls, t in enumerate(tables)))
        huff = (tables[0][2], tables[1][2])
    elif dac is not None:
        l, u, k = dac
        head += segment(0xCC, bytes([0x00, u << 4 | l, 0x01, u << 4 | l, 0x10, k, 0x11, k]))
    dac = dac or (0, 1, 5)
    body = b""
    script = progressive_script(ncomp) if progressive else ((0, 63, 0, 0, None),)
    for ss, se, ah, al, which in script:
        sc = comps if which is None else [comps[which]]
        idx = range(ncomp) if which is None else [which]
        tbls = [0 if i == 0 or coding == "huffman" else 1 for i in idx]  # Huffman: one pair of tables
        sel = bytes(b for i, t in zip(idx, tbls) for b in (comps[i].id, t * 0x11))
        body += segment(0xDA, bytes([len(sc)]) + sel + bytes([ss, se, ah << 4 | al]))
        body += encode_scan(sc, tbls, mcux, mcuy, coding, restart, ss, se, ah, al, progressive, huff=huff, dac=dac)
    return head + body + b"\xff\xd9"


def write_lossless(img, predictor, precision=8, point_transform=0):
    """An Annex H lossless (SOF3) file of an (H, W, C) image of `precision`-bit
    samples, interleaved, one flat Huffman table, no restart interval, no
    JFIF marker; three components are R, G, B (no colour transform)."""
    H, W, C = img.shape
    ids = b"RGB" if C == 3 else bytes(range(1, C + 1))
    x = img.astype(np.int64) >> point_transform
    counts, symbols, codes = flat_table(range(17), 5)
    bw = BitWriter()
    for y in range(H):
        for xx in range(W):
            for c in range(C):
                if y == 0:  # the first line: 2^(P - Pt - 1), then the left neighbour
                    px = x[y, xx - 1, c] if xx else 1 << (precision - point_transform - 1)
                elif xx == 0:  # a line's first sample: the one above
                    px = x[y - 1, xx, c]
                else:
                    ra, rb, rc = x[y, xx - 1, c], x[y - 1, xx, c], x[y - 1, xx - 1, c]
                    px = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                          7: (ra + rb) >> 1}[predictor]
                diff = (int(x[y, xx, c]) - int(px)) & 0xFFFF
                diff = diff - 0x10000 if diff >= 0x8000 else diff
                size, bits = magnitude(diff) if diff != -0x8000 else (16, "")
                bw.put(codes[size] + bits)
    head = (b"\xff\xd8" + segment(0xC3, struct.pack(">BHHB", precision, H, W, C)
                                  + b"".join(bytes([i, 0x11, 0]) for i in ids))
            + segment(0xC4, bytes([0x00]) + bytes(counts) + bytes(symbols)))
    sos = segment(0xDA, bytes([C]) + b"".join(bytes([i, 0x00]) for i in ids) + bytes([predictor, 0, point_transform]))
    return head + sos + bw.flush() + b"\xff\xd9"


# ---- the fixtures ----

def opencv_pixels(data):
    """cv2.imread's IMREAD_COLOR pixels in RGB order, or None where it reads none."""
    import cv2

    decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if decoded is None else decoded[:, :, ::-1]


def write(name, data):
    import cv2

    with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
        f.write(data)
    decoded = opencv_pixels(data)
    if decoded is None:
        return
    ok, png = cv2.imencode(".png", np.ascontiguousarray(decoded[:, :, ::-1]), [cv2.IMWRITE_PNG_COMPRESSION, 9])
    with open(os.path.join(HERE, f"{name}.png"), "wb") as f:
        f.write(png.tobytes())


def encode(img, *params):
    import cv2

    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
    return buf.tobytes()


def cmyk_planes(h, w, seed):
    """Four ink planes as Adobe files store them (inverted: 255 is no ink)."""
    rgb = scene(h, w, seed).astype(np.float64)
    k = np.clip(255 - 0.5 * (255 - rgb.min(-1)), 0, 255)
    return [rgb[..., 0], rgb[..., 1], rgb[..., 2], k]


def new_modes():
    """{name: file bytes} of the modes this script's encoder writes."""
    files = {}
    c, m, y, k = cmyk_planes(35, 43, 20)
    files["ycck"] = write_jpeg([*ycc(255 - np.stack([c, m, y], -1)), k], [(2, 2), (1, 1), (1, 1), (2, 2)], 43, 35,
                               adobe=2, jfif=False)
    img = scene(41, 53, 21).astype(np.float64)
    files["arith_sequential"] = write_jpeg(ycc(img), [(2, 2), (1, 1), (1, 1)], 53, 41, coding="arithmetic",
                                           dac=(1, 3, 3))
    img = scene(45, 59, 22).astype(np.float64)
    files["arith_progressive_restart"] = write_jpeg(ycc(img), [(2, 1), (1, 1), (1, 1)], 59, 45, coding="arithmetic",
                                                    progressive=True, restart=3)
    img = scene(27, 38, 23).astype(np.float64) * 16
    files["bits12"] = write_jpeg(ycc(img), [(1, 1), (1, 1), (1, 1)], 38, 27, precision=12)
    files["lossless"] = write_lossless(scene(23, 31, 24), predictor=7)
    return files


def main():
    import cv2
    import PIL.Image

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
    bio = io.BytesIO()
    PIL.Image.fromarray(np.stack(cmyk_planes(39, 45, 25), -1).astype(np.uint8), "CMYK").save(bio, "JPEG", quality=90)
    write("cmyk", bio.getvalue())
    for name, data in new_modes().items():
        write(name, data)


if __name__ == "__main__":
    main()
