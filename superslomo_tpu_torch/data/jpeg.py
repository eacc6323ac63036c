"""JPEG frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for baseline and extended sequential JPEG frames,
with no cv2.

``imread`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit, for 8-bit Huffman-coded
files of one interleaved scan (SOF0 or SOF1): grey (replicated to three
channels) or three components (YCbCr, or RGB where the file says so as
libjpeg reads it), sampled 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 or at other
integer factors, with or without restart intervals; the APP1 EXIF
orientation is applied as cv2 applies it (``data/exif.py``).

It refuses, with NotImplementedError naming the file and the feature,
progressive, lossless, hierarchical and arithmetic-coded files, other
precisions than 8 bits (12-bit), other component counts than 1 and 3 (CMYK
and YCCK have 4), and a sequential file split into several scans. A truncated
or corrupt file raises ValueError naming the file (libjpeg would warn and
fill in grey).

The markers are parsed here (SOI, APPn, DQT, DHT, SOFn, DRI, SOS). The
scan's entropy decode, the IDCT, the chroma upsampling and the colour
conversion are one host C++ routine, ``csrc/jpeg_decode.cpp`` (built at first
use by ``ops/cuda_build.py``, called through ctypes with the GIL released, so
the Loader's threads decode in parallel). Its stages are those of the
libjpeg-turbo 3.1 that cv2 bundles, at cv2's defaults: the slow-integer IDCT
in the arithmetic of its x86 SIMD version (which saturates where
``jidctint.c``'s range-limit table wraps: cv2 clamps an out-of-range sample),
fancy chroma upsampling (``jdsample.c``), and the fixed-point YCbCr to RGB of
``jdcolor.c``. ``decode_plain`` is the same function in numpy and Python,
for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import struct

import numpy as np

from superslomo_tpu_torch.data.exif import apply_orientation, orientation
from superslomo_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "jpeg_decode.cpp"
SIGNATURE = b"\xff\xd8\xff"
_REFUSED = {  # SOFn markers that are not sequential Huffman coding
    0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
    **{m: f"hierarchical JPEG (SOF{m - 0xC0})" for m in (0xC5, 0xC6, 0xC7)},
    **{m: f"arithmetic-coded JPEG (SOF{m - 0xC0})" for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)},
}
_COLOURS = {"grey": 0, "ycbcr": 1, "rgb": 2}
_ERRORS = {1: "the scan ends before its last block (truncated)", 2: "a Huffman code not in its table",
           3: "a missing or misnumbered restart marker",
           4: "a bad Huffman table (more codes than their lengths hold, or a DC symbol past 15)",
           5: "a scan component names an undefined Huffman table"}
_PAST_END_BITS = 2048  # more than one block's codes can take: a truncated scan ends inside its zero bits
_NATURAL = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))


@dataclasses.dataclass
class Header:
    """What the markers before the scan say."""

    width: int
    height: int
    components: list  # per frame component: (h, v, its quantisation table: 64 values, natural order)
    scan: list  # per scan component, in scan order: (frame index, DC table, AC table)
    huffman: dict  # (class: 0 DC / 1 AC, table) → (16 code counts, symbols)
    restart: int  # MCUs between restart markers, 0 for none
    colour: str  # "grey", "ycbcr" or "rgb"
    orientation: int  # EXIF orientation, 1-8
    scan_start: int  # the offset of the entropy-coded data


def read_header(data: bytes, path: str = "<bytes>") -> Header:
    """Parse the markers of the JPEG ``data`` up to its first scan."""
    if data[:3] != SIGNATURE:
        raise ValueError(f"{path}: not a JPEG file")
    quant, huffman, frame, restart, exif = {}, {}, None, 0, None
    jfif = adobe = False
    adobe_transform = None
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: no marker at byte {pos} before the scan (truncated or corrupt)")
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: ends before its scan (truncated)")
        marker = data[pos]
        pos += 1
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # standalone markers
            continue
        if marker in (0xD8, 0xD9):
            raise ValueError(f"{path}: marker {marker:#04x} before the scan")
        if pos + 2 > len(data):
            raise ValueError(f"{path}: ends inside a marker segment (truncated)")
        (length,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2 : pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"{path}: ends inside a marker segment (truncated)")
        pos += length
        if marker in _REFUSED:
            raise NotImplementedError(f"{path}: {_REFUSED[marker]} is not read; only baseline and extended "
                                      "sequential Huffman JPEG")
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and exif is None and body[:6] == b"Exif\x00\x00":
            exif = body[6:]
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, adobe_transform = True, body[11]
        elif marker == 0xDB:
            _read_dqt(body, quant, path)
        elif marker == 0xC4:
            _read_dht(body, huffman, path)
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError(f"{path}: a short DRI segment")
            (restart,) = struct.unpack_from(">H", body)
        elif marker in (0xC0, 0xC1):
            frame = _read_sof(body, path)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: a scan before the frame header (SOF)")
            break
    precision, h, w, comps = frame
    ids = [c[0] for c in comps]
    ns = body[0] if body else 0
    if len(body) < 1 + 2 * ns + 3 or ns == 0:
        raise ValueError(f"{path}: a malformed SOS segment")
    scan = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids:
            raise ValueError(f"{path}: the scan names component {cid}, which the frame lacks")
        scan.append((ids.index(cid), tables >> 4, tables & 15))
    if ns < len(comps):
        raise NotImplementedError(f"{path}: a sequential JPEG split into several scans ({ns} of {len(comps)} "
                                  "components in the first) is not read")
    if len(scan) != len({s[0] for s in scan}):
        raise ValueError(f"{path}: the scan names a component twice")
    components = []
    for _, ch, cv, tq in comps:
        if tq not in quant:
            raise ValueError(f"{path}: quantisation table {tq} is not defined")
        components.append((ch, cv, quant[tq].copy()))
    for _, td, ta in scan:
        if (0, td) not in huffman or (1, ta) not in huffman:
            raise ValueError(f"{path}: Huffman table DC {td} or AC {ta} is not defined")
    if len(comps) == 1:
        colour = "grey"
    elif jfif:
        colour = "ycbcr"
    elif adobe:
        colour = "rgb" if adobe_transform == 0 else "ycbcr"
    else:  # libjpeg's guess from the component ids
        colour = "rgb" if ids == [82, 71, 66] else "ycbcr"
    return Header(w, h, components, scan, huffman, restart, colour,
                  orientation(exif) if exif is not None else 1, pos)


def _read_dqt(body, quant, path):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        size = 64 * (pq + 1)
        if pq > 1 or tq > 3 or pos + 1 + size > len(body):
            raise ValueError(f"{path}: a malformed DQT segment")
        values = np.frombuffer(body, ">u2" if pq else np.uint8, 64, pos + 1).astype(np.uint16)
        table = np.empty(64, np.uint16)
        table[_NATURAL] = values  # zigzag → natural order
        quant[tq] = table
        pos += 1 + size


def _read_dht(body, huffman, path):
    pos = 0
    while pos < len(body):
        tc, th = body[pos] >> 4, body[pos] & 15
        counts = tuple(body[pos + 1 : pos + 17])
        n = sum(counts)
        if tc > 1 or th > 3 or len(counts) != 16 or n > 256 or pos + 17 + n > len(body):
            raise ValueError(f"{path}: a malformed DHT segment")
        huffman[(tc, th)] = (counts, bytes(body[pos + 17 : pos + 17 + n]))
        pos += 17 + n


def _read_sof(body, path):
    if len(body) < 6:
        raise ValueError(f"{path}: a short SOF segment")
    precision, h, w, nf = struct.unpack_from(">BHHB", body)
    if precision != 8:
        raise NotImplementedError(f"{path}: {precision}-bit JPEG is not read; only 8-bit")
    if nf != 3 and nf != 1:
        kind = " (CMYK or YCCK)" if nf == 4 else ""
        raise NotImplementedError(f"{path}: a JPEG of {nf} components{kind} is not read; only grey or 3 components")
    if len(body) < 6 + 3 * nf:
        raise ValueError(f"{path}: a short SOF segment")
    if h == 0 or w == 0:
        raise ValueError(f"{path}: a frame of {w}x{h} (a DNL height is not read)")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(nf)]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    for cid, ch, cv, tq in comps:
        if not (1 <= ch <= 4 and 1 <= cv <= 4) or tq > 3:
            raise ValueError(f"{path}: component {cid} has sampling {ch}x{cv}, quantisation table {tq}")
        if nf > 1 and (hmax % ch or vmax % cv):
            raise NotImplementedError(f"{path}: component {cid}'s sampling {ch}x{cv} is not an integer fraction "
                                      f"of {hmax}x{vmax}")
    if nf > 1 and sum(c[1] * c[2] for c in comps) > 10:
        raise ValueError(f"{path}: more than 10 blocks an MCU")
    return precision, h, w, comps


# --------------------------------------------------------------------------- #
# the scan: the compiled routine and its plain version


def _declare(lib: ctypes.CDLL) -> None:
    lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5
    lib.jpeg_decode.restype = ctypes.c_int64


def _sampling(header: Header, frame_index: int) -> tuple:
    """(h, v) of a frame component as the scan lays its blocks out: one
    block an MCU in a single-component scan."""
    return header.components[frame_index][:2] if len(header.components) > 1 else (1, 1)


def decode(data: bytes, header: Header, path: str = "<bytes>") -> np.ndarray:
    """The scan of ``data`` decoded by the compiled routine to a (H, W, 3)
    uint8 RGB array (no orientation applied)."""
    frame = np.array([header.width, header.height, len(header.components), header.restart,
                      _COLOURS[header.colour]], np.int32)
    comps = np.array([[fi, *_sampling(header, fi), td, ta] for fi, td, ta in header.scan], np.int32)
    quant = np.ascontiguousarray(np.stack([q for _, _, q in header.components]), np.uint16)
    huff = np.zeros((8, 272), np.uint8)
    for (tc, th), (counts, symbols) in header.huffman.items():
        huff[tc * 4 + th, :16] = counts
        huff[tc * 4 + th, 16 : 16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((header.height, header.width, 3), np.uint8)
    lib = cuda_build.load_library(SOURCE, _declare)
    err = lib.jpeg_decode(buf.ctypes.data + header.scan_start, len(data) - header.scan_start, frame.ctypes.data,
                          comps.ctypes.data, quant.ctypes.data, huff.ctypes.data, out.ctypes.data)
    if err:
        raise ValueError(f"{path}: {_ERRORS.get(err, f'error {err}')}")
    return out


def imread(path: str, data: bytes | None = None) -> np.ndarray:
    """Decode the JPEG at ``path`` (or its bytes ``data``) to a (H, W, 3)
    uint8 RGB array with its EXIF orientation applied, as
    ``cv2.imread(path)[..., ::-1]`` does."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    header = read_header(data, path)
    return apply_orientation(decode(data, header, path), header.orientation)


def _lookup(counts, symbols, dc: bool, path: str) -> list:
    """A canonical Huffman table as a list over every 16-bit window: (code
    length << 8) | symbol of the code the window starts with, -1 where none.
    Refuses the tables that the compiled routine's ``build_huffman`` refuses."""
    if dc and any(s > 15 for s in symbols):
        raise ValueError(f"{path}: {_ERRORS[4]}")
    lut = np.full(1 << 16, -1, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        if code + n >= 1 << length:  # the all-ones code stays free, as libjpeg requires
            raise ValueError(f"{path}: {_ERRORS[4]}")
        for _ in range(n):
            shift = 16 - length
            lut[code << shift : (code + 1) << shift] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


def _entropy_decode_plain(data: bytes, header: Header, path: str) -> list:
    """Every scan component's coefficients, a (by, bx, 64) int16 array in
    natural order (the DC values undifferenced), by a Python Huffman decoder."""
    hmax = max(_sampling(header, fi)[0] for fi, _, _ in header.scan)
    vmax = max(_sampling(header, fi)[1] for fi, _, _ in header.scan)
    W, H = header.width, header.height
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    layout = [(_sampling(header, fi), _lookup(*header.huffman[(0, td)], True, path),
               _lookup(*header.huffman[(1, ta)], False, path)) for fi, td, ta in header.scan]
    coefs = [np.zeros((mcuy * v, mcux * h, 64), np.int32) for (h, v), _, _ in layout]
    flat = [c.reshape(-1) for c in coefs]
    natural = _NATURAL.tolist() + [63] * 16
    marker = re.compile(rb"\xff[^\x00\xff]")

    def segment(start):
        """The bits from ``start`` to the next marker as the 16-bit window at
        each bit (zero bits past the end, as the compiled routine feeds them),
        their count, and where the marker starts."""
        m = marker.search(data, start)
        end = m.start() if m else len(data)
        stop = end
        while stop > start and data[stop - 1] == 0xFF:  # fill bytes before the marker
            stop -= 1
        raw = np.frombuffer(data[start:stop].replace(b"\xff\x00", b"\xff"), np.uint8)
        n = raw.size * 8
        bits = np.concatenate([np.unpackbits(raw), np.zeros(_PAST_END_BITS + 16, np.uint8)]).astype(np.int32)
        w = np.zeros(n + _PAST_END_BITS, np.int32)
        for i in range(16):
            w = (w << 1) | bits[i : i + n + _PAST_END_BITS]
        return memoryview(w), n, end

    window, n_bits, pos = segment(header.scan_start)
    bit = 0
    preds = [0] * len(layout)
    for m in range(mcux * mcuy):
        if header.restart and m and m % header.restart == 0:
            if n_bits - bit >= 8:
                raise ValueError(f"{path}: {_ERRORS[3]}")
            if data[pos : pos + 2] != bytes([0xFF, 0xD0 + (m // header.restart - 1) % 8]):
                raise ValueError(f"{path}: {_ERRORS[3]}")
            window, n_bits, pos = segment(pos + 2)
            bit = 0
            preds = [0] * len(layout)
        my, mx = divmod(m, mcux)
        for c, ((h, v), dc, ac) in enumerate(layout):
            out, bx = flat[c], mcux * h
            for dy in range(v):
                for dx in range(h):
                    base = ((my * v + dy) * bx + mx * h + dx) * 64
                    e = dc[window[bit]]
                    if e < 0 or (e & 255) > 15:
                        raise ValueError(f"{path}: {_ERRORS[2]}")
                    bit += e >> 8
                    s = e & 255
                    if s:
                        val = window[bit] >> (16 - s)
                        bit += s
                        preds[c] += val - (1 << s) + 1 if val < 1 << (s - 1) else val
                    out[base] = preds[c]
                    k = 1
                    while k < 64:
                        e = ac[window[bit]]
                        if e < 0:
                            raise ValueError(f"{path}: {_ERRORS[2]}")
                        bit += e >> 8
                        r, s = (e >> 4) & 15, e & 15
                        if s:
                            k += r
                            val = window[bit] >> (16 - s)
                            bit += s
                            out[base + natural[k]] = val - (1 << s) + 1 if val < 1 << (s - 1) else val
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                    if bit > n_bits:
                        raise ValueError(f"{path}: {_ERRORS[1]}")
    return [c.astype(np.int16) for c in coefs]  # JCOEF: a DC sum past 16 bits wraps, as libjpeg's cast does


def _wrap16(x):
    return x.astype(np.int16).astype(np.int64)


def _descale(x, n):
    return (x + (1 << (n - 1))).astype(np.int32).astype(np.int64) >> n


_F = dict(F029=2446, F039=3196, F054=4433, F076=6270, F089=7373, F117=9633, F150=12299, F184=15137, F196=16069,
          F205=16819, F256=20995, F307=25172)


def _idct_1d_plain(i, shift):
    """The compiled routine's ``idct_1d`` over arrays: ``i`` the 8 inputs."""
    f = _F
    tmp2 = i[2] * f["F054"] + i[6] * (f["F054"] - f["F184"])
    tmp3 = i[2] * (f["F054"] + f["F076"]) + i[6] * f["F054"]
    t0, t1 = _wrap16(i[0] + i[4]) << 13, _wrap16(i[0] - i[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = t0 + tmp3, t0 - tmp3, t1 + tmp2, t1 - tmp2
    z3, z4 = _wrap16(i[7] + i[3]), _wrap16(i[5] + i[1])
    z3s = z3 * (f["F117"] - f["F196"]) + z4 * f["F117"]
    z4s = z3 * f["F117"] + z4 * (f["F117"] - f["F039"])
    o0 = i[7] * (f["F029"] - f["F089"]) + i[1] * -f["F089"] + z3s
    o3 = i[7] * -f["F089"] + i[1] * (f["F150"] - f["F089"]) + z4s
    o1 = i[5] * (f["F205"] - f["F256"]) + i[3] * -f["F256"] + z4s
    o2 = i[5] * -f["F256"] + i[3] * (f["F307"] - f["F256"]) + z3s
    out = [tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0, tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]
    return [_descale(x, shift) for x in out]


def _idct_plain(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(by, bx, 64) coefficients → the (by * 8, bx * 8) uint8 plane."""
    by, bx, _ = coef.shape
    c = coef.reshape(-1, 8, 8).astype(np.int64)
    deq = _wrap16(c * q.reshape(8, 8).astype(np.int64))
    cols = _idct_1d_plain([deq[:, r, :] for r in range(8)], 11)  # over each column: row r of every column
    ws = np.clip(np.stack(cols, axis=1), -32768, 32767)
    dc_only = ~np.any(c[:, 1:, :] != 0, axis=(1, 2))
    ws[dc_only] = _wrap16(deq[dc_only, :1, :] * 4)
    rows = _idct_1d_plain([ws[:, :, k] for k in range(8)], 18)
    px = (np.clip(np.stack(rows, axis=2), -128, 127) + 128).astype(np.uint8)
    return px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


def _upsample_plain(a: np.ndarray, hexp: int, vexp: int) -> np.ndarray:
    """A component's (dh, dw) samples to (dh * vexp, dw * hexp), as the
    compiled routine's ``upsample``."""
    a = a.astype(np.int32)
    dh, dw = a.shape
    up, down = np.vstack([a[:1], a[:-1]]), np.vstack([a[1:], a[-1:]])
    if hexp == 2 and vexp == 2 and dw > 2:
        sums = np.stack([3 * a + up, 3 * a + down], axis=1).reshape(2 * dh, dw)
        left, right = np.hstack([sums[:, :1], sums[:, :-1]]), np.hstack([sums[:, 1:], sums[:, -1:]])
        out = np.stack([(3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4], axis=2)
    elif hexp == 2 and vexp == 1 and dw > 2:
        left, right = np.hstack([a[:, :1], a[:, :-1]]), np.hstack([a[:, 1:], a[:, -1:]])
        out = np.stack([(3 * a + left + 1) >> 2, (3 * a + right + 2) >> 2], axis=2)
    elif hexp == 1 and vexp == 2:
        out = np.stack([(3 * a + up + 1) >> 2, (3 * a + down + 2) >> 2], axis=1)
    else:
        out = np.repeat(np.repeat(a, vexp, axis=0), hexp, axis=1)
    return out.reshape(dh * vexp, dw * hexp).astype(np.uint8)


def decode_plain(data: bytes, header: Header, path: str = "<bytes>") -> np.ndarray:
    """The plain version of ``decode``: the entropy decode in Python, the
    IDCT, upsampling and colour conversion vectorised in numpy."""
    W, H = header.width, header.height
    coefs = _entropy_decode_plain(data, header, path)
    planes = [None] * len(header.components)
    hmax = max(_sampling(header, fi)[0] for fi, _, _ in header.scan)
    vmax = max(_sampling(header, fi)[1] for fi, _, _ in header.scan)
    for (fi, _, _), coef in zip(header.scan, coefs):
        h, v = _sampling(header, fi)
        hexp, vexp = hmax // h, vmax // v
        plane = _idct_plain(coef, header.components[fi][2])[: -(-H // vexp), : -(-W // hexp)]
        planes[fi] = (_upsample_plain(plane, hexp, vexp) if (hexp, vexp) != (1, 1) else plane)[:H, :W]
    if header.colour == "grey":
        return np.repeat(planes[0][..., None], 3, axis=2)
    if header.colour == "rgb":
        return np.stack(planes, axis=2)
    y, cb, cr = (p.astype(np.int64) for p in planes)
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r, cb_b = (91881 * x + half) >> 16, (116130 * x + half) >> 16
    cr_g, cb_g = -46802 * x, -22554 * x + half
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)
