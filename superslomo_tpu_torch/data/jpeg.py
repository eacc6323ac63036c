"""JPEG frame decoder: the counterpart of ``cv2.imread(path)`` (its
``IMREAD_COLOR`` default) for sequential and progressive Huffman JPEG frames,
with no cv2.

``imread`` returns the (H, W, 3) uint8 RGB array that
``cv2.imread(path)[..., ::-1]`` returns, bit for bit, for 8-bit Huffman-coded
files, baseline, extended sequential (SOF0, SOF1) or progressive (SOF2), in
one scan or in several: grey (replicated to three channels), three components
(YCbCr, or RGB where the file says so as libjpeg reads it) or four (CMYK, or
YCCK, as libjpeg reads the Adobe marker; turned to RGB as cv2 turns CMYK),
sampled 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 or at other integer factors, with
or without restart intervals, which may change between scans; the APP1 EXIF
orientation is applied as cv2 applies it (``data/exif.py``).

A progressive file whose scans leave any of the first ten coefficients
unrefined, as one cut off after its first scans (with or without its EOI),
is block-smoothed as libjpeg smooths it (``jdcoefct.c::decompress_smooth_data``:
the coefficients still zero estimated from the 5x5 blocks' DC values, and the
DC too where no AC coefficient of a component is known).

It refuses, with NotImplementedError naming the file and the feature,
lossless, hierarchical and arithmetic-coded files, other precisions than 8
bits (12-bit) and other component counts than 1, 3 and 4. A scan cut off
inside its data, a corrupt file, or a scan whose parameters libjpeg refuses
(``JERR_BAD_PROGRESSION``), raises ValueError naming the file (libjpeg would
warn and fill in grey where the data runs out).

The markers are parsed here (SOI, APPn, DQT, DHT, SOFn, DRI, SOS, EOI), with
each scan's tables, restart interval and entropy-coded bytes; a component's
quantisation table is the one in force at the first scan that holds it, as
libjpeg latches it. The scans' entropy decode, the IDCT, the chroma
upsampling and the colour conversion are one host C++ routine,
``csrc/jpeg_decode.cpp`` (built at first use by ``ops/cuda_build.py``, called
through ctypes with the GIL released, so the Loader's threads decode in
parallel): one pass for a file of one scan of every component, coefficient
buffers and an output pass for any other. Its stages are those of the
libjpeg-turbo 3.1 that cv2 bundles, at cv2's defaults: the progressive decode
of ``jdphuff.c``, the slow-integer IDCT in the arithmetic of its x86 SIMD
version (which saturates where ``jidctint.c``'s range-limit table wraps: cv2
clamps an out-of-range sample), fancy chroma upsampling (``jdsample.c``), and
the fixed-point YCbCr to RGB of ``jdcolor.c``. ``decode_plain`` is the same
function in numpy and Python, for the tests.

A TIFF's JPEG strips and tiles come through the same decode
(``data/tiff.py``): ``with_tables`` puts the JPEGTables field's tables before
an abbreviated stream, and the caller sets ``Header.colour`` as libtiff sets
libjpeg's colour space: "ycbcr" (to RGB) or "raw" (the components as
stored, (H, W, components)), whatever the stream's markers say.
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
_FRAMES = {0xC0: False, 0xC1: False, 0xC2: True}  # SOFn read → progressive
_REFUSED = {  # SOFn markers that are neither sequential nor progressive Huffman coding
    0xC3: "lossless JPEG (SOF3)",
    **{m: f"hierarchical JPEG (SOF{m - 0xC0})" for m in (0xC5, 0xC6, 0xC7)},
    **{m: f"arithmetic-coded JPEG (SOF{m - 0xC0})" for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)},
}
_COLOURS = {"grey": 0, "ycbcr": 1, "rgb": 2, "cmyk": 3, "ycck": 4, "raw": 5}
_ERRORS = {1: "the scan ends before its last block (truncated)", 2: "a Huffman code not in its table",
           3: "a missing or misnumbered restart marker",
           4: "a bad Huffman table (more codes than their lengths hold, or a DC symbol past 15)",
           5: "a scan component names an undefined Huffman table", 6: "a bad progression",
           8: "the scan ends at a marker before its last block"}
_BAD_PROGRESSION = 6
_PAST_END_BITS = 2048  # more than one block's codes can take: a truncated scan ends inside its zero bits
_NATURAL = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))
_SMOOTHED = _NATURAL[:10].tolist()  # the coefficients libjpeg's block smoothing estimates: zigzag 0-9
_END_OF_SCAN = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")  # the marker after a scan's entropy-coded data
_SCAN_FIELDS = 21  # the compiled routine's scan record: 9 fields, then 4 x (frame index, DC slot, AC slot)


@dataclasses.dataclass
class Scan:
    """One scan: its SOS and what was in force when it began."""

    comps: list  # per scan component, in scan order: (frame index, DC table, AC table)
    ss: int  # spectral selection start and end, zigzag positions
    se: int
    ah: int  # successive approximation: the bit position of the previous scan and of this one
    al: int
    huffman: dict  # (class: 0 DC / 1 AC, table) → (16 code counts, symbols), the tables defined before it
    restart: int  # MCUs between restart markers, 0 for none
    start: int  # the offset of its entropy-coded data
    end: int  # the offset of the marker after that data (the file's length where none follows)


@dataclasses.dataclass
class Header:
    """What the markers say. ``scan``, ``huffman``, ``restart`` and
    ``scan_start`` are the first scan's; ``scans`` holds every scan."""

    width: int
    height: int
    components: list  # per frame component: (h, v, its quantisation table: 64 values, natural order)
    scan: list  # per first-scan component, in scan order: (frame index, DC table, AC table)
    huffman: dict  # (class: 0 DC / 1 AC, table) → (16 code counts, symbols)
    restart: int  # MCUs between restart markers, 0 for none
    colour: str  # "grey", "ycbcr", "rgb", "cmyk" or "ycck"; or "raw", set by a caller: the components as stored
    orientation: int  # EXIF orientation, 1-8
    scan_start: int  # the offset of the entropy-coded data
    scans: list  # every Scan, in file order
    progressive: bool

    @property
    def one_pass(self) -> bool:
        """One sequential scan of every component: decoded MCU by MCU, with
        no coefficient buffer (libjpeg's single-scan case)."""
        return not self.progressive and len(self.scans) == 1 and len(self.scan) == len(self.components)


def read_header(data: bytes, path: str = "<bytes>") -> Header:
    """Parse the markers of the JPEG ``data``: up to its first scan where
    that scan is sequential and holds every component (libjpeg then reads
    the file as one scan), else every scan up to EOI or the end of the data."""
    if data[:3] != SIGNATURE:
        raise ValueError(f"{path}: not a JPEG file")
    quant, huffman, frame, restart, exif = {}, {}, None, 0, None
    jfif, adobe_transform, progressive = False, None, False
    latched, scans, first = {}, [], None
    pos = 2
    while True:
        if pos >= len(data) and scans:  # no EOI: libjpeg warns and decodes the scans it read
            break
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: no marker at byte {pos} {'after a' if scans else 'before the'} scan "
                             "(truncated or corrupt)")
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            if scans:
                break
            raise ValueError(f"{path}: ends before its scan (truncated)")
        marker = data[pos]
        pos += 1
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # standalone markers
            continue
        if marker == 0xD9 and scans:  # EOI
            break
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
            raise NotImplementedError(f"{path}: {_REFUSED[marker]} is not read; only baseline, extended "
                                      "sequential and progressive Huffman JPEG")
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and exif is None and body[:6] == b"Exif\x00\x00":
            exif = body[6:]
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDB:
            _read_dqt(body, quant, path)
        elif marker == 0xC4:
            _read_dht(body, huffman, path)
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError(f"{path}: a short DRI segment")
            (restart,) = struct.unpack_from(">H", body)
        elif marker in _FRAMES:
            if frame is not None:
                raise ValueError(f"{path}: a second frame header (SOF)")
            frame, progressive = _read_sof(body, path), _FRAMES[marker]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: a scan before the frame header (SOF)")
            scan = _read_sos(body, frame, progressive, huffman, restart, pos, path)
            for fi, _, _ in scan.comps:  # latched at the first scan that holds the component
                tq = frame[3][fi][3]
                if fi not in latched:
                    if tq not in quant:
                        raise ValueError(f"{path}: quantisation table {tq} is not defined")
                    latched[fi] = quant[tq].copy()
            if first is None:
                first = (_colour(frame[3], jfif, adobe_transform), orientation(exif) if exif is not None else 1)
            if not scans and not progressive and len(scan.comps) == len(frame[3]):
                scan.end = len(data)  # the one-pass case: the routine stops at the marker after it
                scans.append(scan)
                break
            found = _END_OF_SCAN.search(data, pos)
            scan.end = pos = found.start() if found else len(data)
            scans.append(scan)
    _, h, w, comps = frame
    components = [(ch, cv, latched.get(fi, np.zeros(64, np.uint16))) for fi, (_, ch, cv, _) in enumerate(comps)]
    return Header(w, h, components, scans[0].comps, scans[0].huffman, scans[0].restart, first[0], first[1],
                  scans[0].start, scans, progressive)


def _colour(comps, jfif: bool, adobe_transform) -> str:
    """The frame's colour space as libjpeg's ``default_decompress_parms``
    decides it from the markers before the first scan."""
    if len(comps) == 1:
        return "grey"
    if len(comps) == 4:  # Adobe transform 0: CMYK, 2 (or another, with a warning): YCCK; no Adobe marker: CMYK
        return "cmyk" if adobe_transform in (None, 0) else "ycck"
    if jfif:
        return "ycbcr"
    if adobe_transform is not None:
        return "rgb" if adobe_transform == 0 else "ycbcr"
    return "rgb" if [c[0] for c in comps] == [82, 71, 66] else "ycbcr"  # libjpeg's guess from the ids


def _tables_used(scan: Scan, progressive: bool) -> list:
    """The (class, table) keys the scan decodes with: DC and AC for a
    sequential scan; DC for a first DC scan, none for a DC refinement, AC
    for an AC scan."""
    if not progressive:
        return [k for _, td, ta in scan.comps for k in ((0, td), (1, ta))]
    if scan.ss == 0:
        return [(0, td) for _, td, _ in scan.comps] if scan.ah == 0 else []
    return [(1, ta) for _, _, ta in scan.comps]


def _read_sos(body, frame, progressive, huffman, restart, start, path) -> Scan:
    ids = [c[0] for c in frame[3]]
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 1 + 2 * ns + 3:
        raise ValueError(f"{path}: a malformed SOS segment")
    comps = []
    for i in range(ns):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids:
            raise ValueError(f"{path}: the scan names component {cid}, which the frame lacks")
        comps.append((ids.index(cid), tables >> 4, tables & 15))
    if len(comps) != len({c[0] for c in comps}):
        raise ValueError(f"{path}: the scan names a component twice")
    if ns > 1 and sum(frame[3][fi][1] * frame[3][fi][2] for fi, _, _ in comps) > 10:
        raise ValueError(f"{path}: more than 10 blocks an MCU")
    ss, se, a = body[1 + 2 * ns : 4 + 2 * ns]
    scan = Scan(comps, ss, se, a >> 4, a & 15, dict(huffman), restart, start, start)
    for cls, t in _tables_used(scan, progressive):
        if (cls, t) not in huffman:
            raise ValueError(f"{path}: Huffman table {('DC', 'AC')[cls]} {t} is not defined")
    return scan


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
    if nf not in (1, 3, 4):
        raise NotImplementedError(f"{path}: a JPEG of {nf} components is not read; only grey, 3 or 4 components")
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
    return precision, h, w, comps


# --------------------------------------------------------------------------- #
# the scans: the compiled routine and its plain version


@dataclasses.dataclass
class _Geometry:
    """A frame component's layout: its sampling (1x1 in a grey frame), its own
    size in samples and in blocks, and its coefficient buffer's block grid
    (the MCU-padded one of an interleaved scan)."""

    h: int
    v: int
    width: int
    height: int
    block_cols: int
    block_rows: int
    grid_cols: int
    grid_rows: int


def _geometry(header: Header) -> tuple:
    """(hmax, vmax, MCU columns, MCU rows of an interleaved scan, a
    _Geometry per frame component), as libjpeg's ``initial_setup`` lays
    them out."""
    sampling = [c[:2] for c in header.components] if len(header.components) > 1 else [(1, 1)]
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    W, H = header.width, header.height
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    geo = []
    for h, v in sampling:
        width, height = -(-W * h // hmax), -(-H * v // vmax)
        geo.append(_Geometry(h, v, width, height, -(-width // 8), -(-height // 8), mcux * h, mcuy * v))
    return hmax, vmax, mcux, mcuy, geo


def _bad_progression(scan: Scan) -> bool:
    """The scan parameters libjpeg's ``start_pass_phuff_decoder`` refuses."""
    if scan.ss == 0:
        bad = scan.se != 0
    else:
        bad = scan.ss > scan.se or scan.se > 63 or len(scan.comps) != 1
    return bad or (scan.ah != 0 and scan.al != scan.ah - 1) or scan.al > 13


def _needs_smoothing(header: Header, coef_bits: np.ndarray) -> bool:
    """libjpeg's ``smoothing_ok`` after the last scan of a progressive file:
    every component's quantisation table latched with its first ten values
    nonzero, every DC known, and some coefficient among each block's first
    ten (zigzag) not refined to its last bit."""
    if not header.progressive or not all(q[_SMOOTHED].all() for _, _, q in header.components):
        return False
    return bool((coef_bits[:, 0] >= 0).all() and (coef_bits[:, 1:10] != 0).any())


# libjpeg-turbo's estimates of zigzag 1-9 (and of the DC, where no AC is known)
# from the 5x5 DC neighbourhood, as (zigzag, {DC number 1-25: weight}): where
# some AC coefficient of the component is known, then where none is (change_dc)
_AC_KNOWN = {1: {11: -7, 12: 50, 14: -50, 15: 7}, 2: {3: -7, 8: 50, 18: -50, 23: 7},
             3: {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
             4: {10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1, 24: -1, 4: 1, 6: -1, 7: 10, 9: -10},
             5: {11: -1, 12: 13, 13: -24, 14: 13, 15: -1}}
_AC_NONE = {
    1: {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38, 14: -38, 15: 3, 16: -3, 17: 13,
        19: -13, 20: 3, 21: -1, 22: -1, 24: 1, 25: 1},
    2: {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1, 16: 1, 17: -13, 18: -38, 19: -13,
        20: 1, 21: 1, 22: 3, 23: 3, 24: 3, 25: 1},
    3: {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2, 23: 1},
    4: {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1},
    5: {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5, 19: 2},
    6: {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}, 7: {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1},
    8: {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}, 9: {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1},
    0: {1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6, 11: -8, 12: 42, 13: 152, 14: 42,
        15: -8, 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2, 22: -6, 23: -8, 24: -6, 25: -2},
}


def _estimate_plain(num, q: int, al: int):
    """The compiled routine's ``estimate`` over arrays: num / (q * 256)
    rounded half away from zero, below 2^al in magnitude where al > 0."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num >= 0, pred, -pred)


def _smooth_plain(coef: np.ndarray, g: _Geometry, q: np.ndarray, T: int, bits) -> np.ndarray:
    """The compiled routine's ``smooth_block`` over a component's (grid_rows,
    grid_cols, 64) coefficients: its (block_rows, block_cols, 64) blocks
    smoothed as libjpeg's ``decompress_smooth_data`` smooths them."""
    by = np.arange(g.block_rows)
    r = by // g.v
    last = g.block_rows % g.v or g.v
    block_rows = np.where(r == T - 1, last, g.v)
    ibr, ibrs = r * block_rows + by % g.v, block_rows * T
    rows = [None, np.where(ibr > 0, by - 1, by), by, np.where(ibr < ibrs - 1, by + 1, by)]
    rows[0] = np.where(ibr > 1, by - 2, rows[1])
    rows.append(np.where(ibr < ibrs - 2, by + 2, rows[3]))
    dc = coef[..., 0]
    bx = np.arange(g.block_cols)
    D = {1 + 5 * i + j: dc[rows[i]][:, np.clip(bx + j - 2, 0, g.block_cols - 1)] for i in range(5) for j in range(5)}
    out = coef[: g.block_rows, : g.block_cols].copy()
    change_dc = all(b == -1 for b in bits[1:10])
    weights = _AC_NONE if change_dc else _AC_KNOWN
    for k in range(1, 10 if change_dc else 6):
        pos = _SMOOTHED[k]
        if bits[k] != 0:
            num = int(q[0]) * sum(w * D[n] for n, w in weights[k].items())
            out[..., pos] = np.where(out[..., pos] == 0, _estimate_plain(num, int(q[pos]), bits[k]), out[..., pos])
    if change_dc:
        out[..., 0] = _estimate_plain(int(q[0]) * sum(w * D[n] for n, w in weights[0].items()), int(q[0]), 0)
    return out.astype(np.int16)


def _raise(err: int, header: Header, path: str):
    code, index = err & 255, err >> 8
    if code == _BAD_PROGRESSION:
        s = header.scans[index]
        raise ValueError(f"{path}: scan {index}: {_ERRORS[code]} (Ss {s.ss}, Se {s.se}, Ah {s.ah}, Al {s.al})")
    where = f"scan {index}: " if not header.one_pass else ""
    raise ValueError(f"{path}: {where}{_ERRORS.get(code, f'error {code}')}")


def _declare(lib: ctypes.CDLL) -> None:
    lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5
    lib.jpeg_decode.restype = ctypes.c_int64
    lib.jpeg_decode_scans.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
                                      + [ctypes.c_void_p] * 3)
    lib.jpeg_decode_scans.restype = ctypes.c_int64


def _huffman_rows(tables) -> np.ndarray:
    """Huffman tables as the routine's rows: 16 code counts, then 256 symbols."""
    rows = np.zeros((max(len(tables), 1), 272), np.uint8)
    for i, (counts, symbols) in enumerate(tables):
        rows[i, :16] = counts
        rows[i, 16 : 16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    return rows


def _scan_records(header: Header, data_len: int) -> tuple:
    """The routine's (n_scans, 21) int64 scan records and its Huffman rows:
    each distinct table once, named by its row ("slot"), -1 where a scan
    does not decode with a table."""
    slots, tables = {}, []
    records = np.full((len(header.scans), _SCAN_FIELDS), -1, np.int64)
    for i, s in enumerate(header.scans):
        used = set(_tables_used(s, header.progressive))
        records[i, :9] = [s.start, s.end - s.start, s.end >= data_len, s.restart, len(s.comps), s.ss, s.se, s.ah,
                          s.al]
        for j, (fi, td, ta) in enumerate(s.comps):
            row = [fi]
            for key in ((0, td), (1, ta)):
                if key not in used:
                    row.append(-1)
                    continue
                table = (key[0], *s.huffman[key])
                if table not in slots:
                    slots[table] = len(tables)
                    tables.append(table)
                row.append(slots[table])
            records[i, 9 + 3 * j : 12 + 3 * j] = row
    return records, np.array([t[0] for t in tables] or [0], np.uint8), _huffman_rows([t[1:] for t in tables])


def decode(data: bytes, header: Header, path: str = "<bytes>") -> np.ndarray:
    """The scans of ``data`` decoded by the compiled routine to a (H, W, 3)
    uint8 RGB array (no orientation applied); for ``header.colour`` "raw",
    (H, W, components) of the components as stored."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((header.height, header.width, len(header.components) if header.colour == "raw" else 3), np.uint8)
    quant = np.ascontiguousarray(np.stack([q for _, _, q in header.components]), np.uint16)
    lib = cuda_build.load_library(SOURCE, _declare)
    if header.one_pass:
        _, _, _, _, geo = _geometry(header)
        frame = np.array([header.width, header.height, len(header.components), header.restart,
                          _COLOURS[header.colour]], np.int32)
        comps = np.array([[fi, geo[fi].h, geo[fi].v, td, ta] for fi, td, ta in header.scan], np.int32)
        huff = np.zeros((8, 272), np.uint8)
        for (tc, th), (counts, symbols) in header.huffman.items():
            huff[tc * 4 + th] = _huffman_rows([(counts, symbols)])[0]
        err = lib.jpeg_decode(buf.ctypes.data + header.scan_start, len(data) - header.scan_start, frame.ctypes.data,
                              comps.ctypes.data, quant.ctypes.data, huff.ctypes.data, out.ctypes.data)
    else:
        frame = np.array([header.width, header.height, len(header.components), _COLOURS[header.colour],
                          int(header.progressive)], np.int32)
        sampling = np.array([[g.h, g.v] for g in _geometry(header)[4]], np.int32)
        records, classes, huff = _scan_records(header, len(data))
        err = lib.jpeg_decode_scans(buf.ctypes.data, frame.ctypes.data, sampling.ctypes.data, quant.ctypes.data,
                                    len(records), records.ctypes.data, len(classes), classes.ctypes.data,
                                    huff.ctypes.data, out.ctypes.data)
    if err:
        _raise(err, header, path)
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


def with_tables(stream: bytes, tables: bytes | None, path: str = "<bytes>") -> bytes:
    """A TIFF strip's or tile's JPEG ``stream`` (an abbreviated datastream)
    preceded by the marker segments of the TIFF's JPEGTables field
    ``tables``, a tables-only datastream, as libjpeg reads the pair: the
    tables first, the stream's own markers after them (a table the stream
    defines again replaces the field's). A field that is not a tables-only
    datastream (no SOI; a frame or scan header in it) raises ValueError,
    as libtiff's "Bogus JPEGTables field"; its segments end at its EOI or,
    as libtiff's source then inserts one, at the field's end; between
    segments, bytes are passed over as libjpeg's ``next_marker`` passes
    them."""
    if stream[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: a JPEG strip or tile that does not start with SOI")
    if not tables:
        return stream
    if tables[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: a JPEGTables field that does not start with SOI")
    segments, pos = [], 2
    while True:  # libjpeg's next_marker: bytes before a 0xFF skipped, fill bytes too, a stuffed 0 passed
        while pos < len(tables) and tables[pos] != 0xFF:
            pos += 1
        while pos < len(tables) and tables[pos] == 0xFF:
            pos += 1
        if pos >= len(tables):
            break
        marker = tables[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker in (0xDA, 0xD8) or marker in _FRAMES or marker in _REFUSED:
            raise ValueError(f"{path}: a JPEGTables field holding marker {marker:#04x}, not tables alone")
        length = struct.unpack_from(">H", tables, pos)[0] if pos + 2 <= len(tables) else 0
        if length < 2 or pos + length > len(tables):
            raise ValueError(f"{path}: a JPEGTables field cut inside a marker segment")
        segments.append(bytes([0xFF, marker]) + tables[pos:pos + length])
        pos += length
    return b"\xff\xd8" + b"".join(segments) + stream[2:]


class _ScanError(Exception):
    """An error code of the compiled routine, raised by the plain decode."""

    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


def _lookup(counts, symbols, dc: bool) -> list:
    """A canonical Huffman table as a list over every 16-bit window: (code
    length << 8) | symbol of the code the window starts with, -1 where none.
    Refuses the tables that the compiled routine's ``build_huffman`` refuses."""
    if dc and any(s > 15 for s in symbols):
        raise _ScanError(4)
    lut = np.full(1 << 16, -1, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        if code + n >= 1 << length:  # the all-ones code stays free, as libjpeg requires
            raise _ScanError(4)
        for _ in range(n):
            shift = 16 - length
            lut[code << shift : (code + 1) << shift] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


def _w16(x: int) -> int:
    """``x`` cast to a 16-bit JCOEF, as libjpeg stores a coefficient."""
    return ((x + 32768) & 0xFFFF) - 32768


def _extend(val: int, s: int) -> int:
    return val - (1 << s) + 1 if val < 1 << (s - 1) else val


def _scan_plain(data: bytes, header: Header, scan: Scan, coefs: list, geometry: tuple) -> None:
    """Decode ``scan`` into ``coefs`` (per frame component a flat list over
    its buffer's blocks, natural order) by a Python Huffman decoder: a
    sequential scan's blocks whole, or one band or bit of a progressive scan
    as ``jdphuff.c`` decodes it."""
    _, _, mcux, mcuy, geo = geometry
    if len(scan.comps) == 1:  # non-interleaved: an MCU is one block of the component's own grid
        fi = scan.comps[0][0]
        cols, rows, units = geo[fi].block_cols, geo[fi].block_rows, [(fi, 1, 1)]
    else:
        cols, rows, units = mcux, mcuy, [(fi, geo[fi].h, geo[fi].v) for fi, _, _ in scan.comps]
    used = set(_tables_used(scan, header.progressive))
    tables = {key: _lookup(*scan.huffman[key], key[0] == 0) for key in used}
    dcs = [tables.get((0, td)) for _, td, _ in scan.comps]
    acs = [tables.get((1, ta)) for _, _, ta in scan.comps]
    kind = ("sequential" if not header.progressive else
            ("dc_first", "dc_refine")[scan.ah > 0] if scan.ss == 0 else ("ac_first", "ac_refine")[scan.ah > 0])
    ss, se, p1, m1 = scan.ss, scan.se, 1 << scan.al, -1 << scan.al
    natural = _NATURAL.tolist() + [63] * 16
    marker = re.compile(rb"\xff[^\x00\xff]")
    end_code = 1 if scan.end >= len(data) or header.one_pass else 8

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

    window, n_bits, pos = segment(scan.start)
    bit, eobrun = 0, 0
    preds = [0] * len(units)
    for m in range(cols * rows):
        if scan.restart and m and m % scan.restart == 0:
            if n_bits - bit >= 8:
                raise _ScanError(3)
            if data[pos : pos + 2] != bytes([0xFF, 0xD0 + (m // scan.restart - 1) % 8]):
                raise _ScanError(3)
            window, n_bits, pos = segment(pos + 2)
            bit, eobrun = 0, 0
            preds = [0] * len(units)
        my, mx = divmod(m, cols)
        for c, (fi, h, v) in enumerate(units):
            out, gw = coefs[fi], geo[fi].grid_cols
            for dy in range(v):
                for dx in range(h):
                    base = ((my * v + dy) * gw + mx * h + dx) * 64
                    if kind in ("sequential", "dc_first"):
                        e = dcs[c][window[bit]]
                        if e < 0 or (e & 255) > 15:
                            raise _ScanError(2)
                        bit += e >> 8
                        s = e & 255
                        if s:
                            preds[c] += _extend(window[bit] >> (16 - s), s)
                            bit += s
                        out[base] = _w16(preds[c] << scan.al) if kind == "dc_first" else _w16(preds[c])
                    if kind == "sequential":
                        ac, k = acs[c], 1
                        while k < 64:
                            e = ac[window[bit]]
                            if e < 0:
                                raise _ScanError(2)
                            bit += e >> 8
                            r, s = (e >> 4) & 15, e & 15
                            if s:
                                k += r
                                out[base + natural[k]] = _extend(window[bit] >> (16 - s), s)
                                bit += s
                            elif r != 15:
                                break
                            else:
                                k += 15
                            k += 1
                    elif kind == "dc_refine":
                        if window[bit] >> 15:
                            out[base] |= p1
                        bit += 1
                    elif kind == "ac_first":
                        if eobrun:
                            eobrun -= 1
                        else:
                            ac, k = acs[c], ss
                            while k <= se:
                                e = ac[window[bit]]
                                if e < 0:
                                    raise _ScanError(2)
                                bit += e >> 8
                                r, s = (e >> 4) & 15, e & 15
                                if s:
                                    k += r
                                    out[base + natural[k]] = _w16(_extend(window[bit] >> (16 - s), s) << scan.al)
                                    bit += s
                                elif r == 15:
                                    k += 15
                                else:  # EOBr: this band and the next 2^r + (r bits) - 1 bands are zero
                                    eobrun = (1 << r) + (window[bit] >> (16 - r) if r else 0) - 1
                                    bit += r
                                    break
                                k += 1
                    elif kind == "ac_refine":
                        ac, k = acs[c], ss
                        if eobrun == 0:
                            while k <= se:
                                e = ac[window[bit]]
                                if e < 0:
                                    raise _ScanError(2)
                                bit += e >> 8
                                r, s = (e >> 4) & 15, e & 15
                                if s:  # a newly nonzero coefficient, its sign in the next bit
                                    s = p1 if window[bit] >> 15 else m1
                                    bit += 1
                                elif r != 15:
                                    eobrun = (1 << r) + (window[bit] >> (16 - r) if r else 0)
                                    bit += r
                                    break
                                while True:  # past r zero coefficients, correcting the nonzero ones on the way
                                    at = base + natural[k]
                                    if out[at]:
                                        if window[bit] >> 15 and not out[at] & p1:
                                            out[at] = _w16(out[at] + (p1 if out[at] >= 0 else m1))
                                        bit += 1
                                    else:
                                        r -= 1
                                        if r < 0:
                                            break
                                    k += 1
                                    if k > se:
                                        break
                                if s:
                                    out[base + natural[k]] = s
                                k += 1
                        if eobrun > 0:  # the rest of the band: correction bits of the nonzero coefficients
                            while k <= se:
                                at = base + natural[k]
                                if out[at]:
                                    if window[bit] >> 15 and not out[at] & p1:
                                        out[at] = _w16(out[at] + (p1 if out[at] >= 0 else m1))
                                    bit += 1
                                k += 1
                            eobrun -= 1
                    if bit > n_bits:
                        raise _ScanError(end_code)


_F = dict(F029=2446, F039=3196, F054=4433, F076=6270, F089=7373, F117=9633, F150=12299, F184=15137, F196=16069,
          F205=16819, F256=20995, F307=25172)


def _wrap16(x):
    return x.astype(np.int16).astype(np.int64)


def _descale(x, n):
    return (x + (1 << (n - 1))).astype(np.int32).astype(np.int64) >> n


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


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point YCbCr to RGB, clamped: (H, W, 3) int64."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r, cb_b = (91881 * x + half) >> 16, (116130 * x + half) >> 16
    cr_g, cb_g = -46802 * x, -22554 * x + half
    y = y.astype(np.int64)
    return np.clip(np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=2), 0, 255)


def decode_plain(data: bytes, header: Header, path: str = "<bytes>") -> np.ndarray:
    """The plain version of ``decode``: the entropy decode in Python, the
    IDCT, upsampling and colour conversion vectorised in numpy."""
    geometry = _geometry(header)
    hmax, vmax, _, _, geo = geometry
    nc = len(header.components)
    coefs = [[0] * (g.grid_rows * g.grid_cols * 64) for g in geo]
    coef_bits = np.full((nc, 64), -1)  # per component and zigzag position: the last scan's Al, -1 before any
    for index, scan in enumerate(header.scans):
        try:
            if header.progressive:
                if _bad_progression(scan):
                    raise _ScanError(_BAD_PROGRESSION)
                for fi, _, _ in scan.comps:
                    coef_bits[fi, scan.ss : scan.se + 1] = scan.al
            _scan_plain(data, header, scan, coefs, geometry)
        except _ScanError as e:
            _raise(e.code | index << 8, header, path)
    smooth = _needs_smoothing(header, coef_bits)
    planes = []
    for (_, _, q), g, flat, bits in zip(header.components, geo, coefs, coef_bits.tolist()):
        coef = np.array(flat, np.int64).astype(np.int16).reshape(g.grid_rows, g.grid_cols, 64)
        coef = _smooth_plain(coef.astype(np.int64), g, q, geometry[3], bits) if smooth else \
            coef[: g.block_rows, : g.block_cols]
        plane = _idct_plain(coef, q)[: g.height, : g.width]
        hexp, vexp = hmax // g.h, vmax // g.v
        planes.append((_upsample_plain(plane, hexp, vexp) if (hexp, vexp) != (1, 1) else plane)
                      [: header.height, : header.width])
    if header.colour == "grey":
        return np.repeat(planes[0][..., None], 3, axis=2)
    if header.colour == "raw":
        return np.stack(planes, axis=2)
    if header.colour == "rgb":
        return np.stack(planes, axis=2)
    if header.colour == "ycbcr":
        return _ycc_to_rgb(*planes).astype(np.uint8)
    cmy = 255 - _ycc_to_rgb(*planes[:3]) if header.colour == "ycck" else np.stack(planes[:3], axis=2)
    k = planes[3].astype(np.int64)[..., None]  # OpenCV's CMYK to BGR, on Adobe's inverted samples
    return (k - (((255 - cmy.astype(np.int64)) * k) >> 8)).astype(np.uint8)
