"""The port's lossy WebP (VP8) decode on the CPU against ``cv2.imread`` (the
JAX package's decoder), bit for bit, through the frame reader: lossy WebP as
cv2 writes it (qualities 1-100), as PIL writes it (methods 0-6 at two
qualities; RGBA with ``alpha_quality`` and ``exact``, whose ALPH chunk
libwebp decodes; EXIF orientations 1-8 in a VP8X file; lossy animations, and
one whose second frame is lossless), odd sizes down to 1x1, and each option
of ``chip_smoke.vp8_bytes`` (both loop filters, sharpness 0-7, levels 0 and
63, segments with absolute and delta values with and without a map, the
loop-filter deltas, 1-8 token partitions, no skip probability, B_PRED's
sub-modes at every edge, quantiser indices 0 and 127 with DCT_CAT6
magnitudes, the five quantiser deltas, versions 0-3). The compiled decode
(``csrc/vp8_decode.cpp``) equals its plain twin (``data/vp8.py``) on every
case. Then what cv2 refuses, each raising ValueError naming the file: files
cut at every byte of a range (the last partition runs to the file's end for
a still image, to its chunk's pad byte for an animation frame), each frame
header and ALPH refusal, and byte flips, where the compiled decode and the
twin both refuse or agree exactly and refuse exactly where cv2 does."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from superslomo_tpu_torch.data import image, vp8, webp
from tests.test_torch_package import one_torch_thread  # noqa: F401


def _texture(rng, h, w, kind):
    """(h, w, 3) uint8: uniform noise, or a smooth sum of sines."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 6.3, 3)
    return np.stack([128 + 120 * np.sin(xx / (3 + i) + yy / (5 + 2 * i) + phase[i]) for i in range(3)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + bytes(len(payload) & 1)


def _riff(*chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(flags, w, h) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def _anmf(w, h, frame) -> bytes:
    return _chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in (0, 0, w - 1, h - 1, 100)) + bytes(1) + frame)


def _payload(data: bytes) -> bytes:
    """The first chunk's payload of a simple WebP file."""
    (size,) = struct.unpack_from("<I", data, 16)
    return data[20:20 + size]


def _read(tmp_path, data: bytes, name: str):
    """(cv2's RGB or None, the frame reader's RGB or its ValueError, the
    plain twin's likewise) for ``data`` written as ``name``."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    out = []
    for decode in (lambda: image.imread(str(path)), lambda: webp.decode(data, str(path), plain=True)):
        try:
            out.append(decode())
        except ValueError as e:
            assert name in str(e), e
            out.append(e)
    return (None if want is None else want[..., ::-1]), out[0], out[1]


def _check(tmp_path, data: bytes, name: str):
    want, got, plain = _read(tmp_path, data, name)
    assert want is not None, f"cv2 does not read {name}"
    assert isinstance(got, np.ndarray), got
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(plain, got, err_msg=f"{name}: plain")


# --------------------------------------------------------------------------- #
# what cv2 reads


WRITER_OPTIONS = {
    "simple_filter": dict(filter="simple", level=30),
    **{f"sharpness_{k}": dict(level=35, sharpness=k) for k in range(8)},
    "level_0": dict(level=0),
    "level_63": dict(level=63),
    "simple_level_63_sharpness_7": dict(filter="simple", level=63, sharpness=7),
    "segments_absolute_map": dict(segments=dict(absolute=True, quant=[5, 40, 90, 127], strength=[0, 12, 40, 63],
                                                map=True)),
    "segments_delta_map": dict(segments=dict(absolute=False, quant=[-20, 0, 15, 60], strength=[-20, 0, 9, 30],
                                             map=True)),
    "segments_delta_no_map": dict(segments=dict(absolute=False, quant=[-5, 10, 0, 3], strength=[-3, 5, 0, 9],
                                                map=False)),
    "lf_deltas": dict(lf_delta=(9, -14)),
    "lf_deltas_to_zero": dict(level=10, lf_delta=(-10, 3)),
    **{f"partitions_{n}": dict(partitions=n) for n in (2, 4, 8)},
    "no_skip_probability": dict(skip=False),
    "bpred_every_sub_mode": dict(bpred=1.0),
    "modes_16x16_only": dict(bpred=0.0),
    "q_0_cat6": dict(q=0),
    "q_127": dict(q=127),
    "quant_deltas": dict(quant_deltas=(-15, 15, -8, 7, -3)),
    "quant_deltas_clamped": dict(q=125, quant_deltas=(7, 7, 7, -8, 7)),
    **{f"version_{v}": dict(version=v) for v in (1, 2, 3)},
}


def _case(name) -> bytes:
    rng = np.random.default_rng(7 + sum(map(ord, name)))
    img = _texture(rng, 37, 53, "noise" if rng.integers(2) else "smooth")
    if name.startswith("cv2_quality_"):
        return cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, int(name.rsplit("_", 1)[1])])[1].tobytes()
    if name.startswith("pil_method_"):
        method, quality = (int(v) for v in name.split("_")[2::2])
        return _pil(img, method=method, quality=quality)
    if name.startswith("pil_rgba_"):  # lossy colour with an ALPH chunk: raw or lossless alpha, filtered or not
        alpha = rng.integers(0, 256, img.shape[:2], dtype=np.uint8)
        alpha[::3] = 0
        _, _, aq, exact = name.split("_")
        return _pil(np.dstack([img, alpha]), quality=60, alpha_quality=int(aq[1:]), exact=exact == "exact")
    if name.startswith("pil_exif_orientation_"):
        exif = Image.Exif()
        exif[0x0112] = int(name.rsplit("_", 1)[1])
        return _pil(img[:8, :12], quality=70, exif=exif.tobytes())
    if name == "pil_animated_lossy":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", save_all=True, append_images=[Image.fromarray(255 - img)],
                                  duration=100, quality=70)
        return buf.getvalue()
    if name == "animated_lossy_then_lossless":
        return _riff(_vp8x(0x02, 53, 37), _chunk(b"ANIM", bytes(6)),
                     _anmf(53, 37, _chunk(b"VP8 ", _payload(cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY,
                                                                                         75])[1].tobytes()))),
                     _anmf(53, 37, _chunk(b"VP8L", _payload(_pil(255 - img, lossless=True)))))
    if name.startswith("size_"):
        h, w = (int(v) for v in name[5:].split("x"))
        return chip_smoke.vp8_bytes(_texture(rng, h, w, "noise"), bpred=0.5, seed=h * w)
    if name.startswith("cv2_size_"):
        h, w = (int(v) for v in name[9:].split("x"))
        return cv2.imencode(".webp", _texture(rng, h, w, "smooth"), [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()
    assert name.startswith("writer_"), name
    kw = WRITER_OPTIONS[name[len("writer_"):]]
    size = (64, 64) if "bpred" in name or name.endswith("_cat6") else (48, 64)
    return chip_smoke.vp8_bytes(_texture(rng, *size, "noise" if "cat6" in name else "smooth"), seed=len(name), **kw)


CASES = ([f"cv2_quality_{q}" for q in (1, 10, 50, 75, 90, 100)] +
         [f"pil_method_{m}_quality_{q}" for m in range(7) for q in (20, 90)] +
         [f"pil_rgba_q{aq}_{e}" for aq in (0, 50, 100) for e in ("exact", "plain")] +
         [f"pil_exif_orientation_{k}" for k in range(1, 9)] +
         ["pil_animated_lossy", "animated_lossy_then_lossless"] +
         [f"size_{h}x{w}" for h, w in ((1, 1), (1, 17), (17, 1), (17, 33), (63, 47))] +
         [f"cv2_size_{h}x{w}" for h, w in ((1, 1), (2, 3), (31, 1))] +
         [f"writer_{k}" for k in WRITER_OPTIONS])


@pytest.mark.parametrize("name", CASES)
def test_vp8_equals_cv2(tmp_path, name):
    """Each lossy WebP reads as cv2 reads it (its fancy-upsampled,
    fixed-point RGB; alpha dropped; the EXIF turn; an animation's first frame
    on a black canvas), and the plain VP8 twin equals the compiled decode."""
    _check(tmp_path, _case(name), f"{name}.webp")


def test_vp8_writer_files_keep_their_options():
    """The writer's options reach the bitstream: the frame tag's version,
    the filter type bit, the partition count and the segment header read
    back as written (a guard that the cases above test what they name)."""
    img = _texture(np.random.default_rng(1), 48, 64, "smooth")
    data = _payload(chip_smoke.vp8_bytes(img, version=2, filter="simple", partitions=4, segments=dict(
        absolute=True, quant=[1, 2, 3, 4], strength=[0, 0, 0, 0], map=True)))
    assert vp8.frame_header(data)[1] == 2
    br = vp8._Bits(data, 10, 10 + vp8.frame_header(data)[3])
    br.literal(2)
    assert br.bit(128) == 1 and br.bit(128) == 1  # segmentation, with a map


# --------------------------------------------------------------------------- #
# what cv2 refuses


def _refuses_as_cv2(tmp_path, data: bytes, name: str) -> bool:
    """Both decodes refuse (ValueError naming the file) exactly where cv2
    returns None, and otherwise equal cv2; returns whether cv2 read it."""
    want, got, plain = _read(tmp_path, data, name)
    if want is None:
        assert isinstance(got, ValueError) and isinstance(plain, ValueError), (name, got, plain)
        return False
    assert isinstance(got, np.ndarray) and isinstance(plain, np.ndarray), (name, got, plain)
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(plain, got, err_msg=name)
    return True


def _frame(payload: bytes, first=None, tag=None) -> bytes:
    """A simple file of the VP8 ``payload``, its frame tag's bits or first
    partition size replaced."""
    p = bytearray(payload)
    bits = p[0] | p[1] << 8 | p[2] << 16
    if tag is not None:
        bits = tag(bits)
    if first is not None:
        bits = (bits & 31) | first << 5
    p[0:3] = bytes([bits & 255, (bits >> 8) & 255, bits >> 16])
    return _riff(_chunk(b"VP8 ", bytes(p)))


@pytest.mark.parametrize("where", ["header", "first_partition_end", "tail", "tail_two_partitions"])
def test_vp8_cut_at_every_byte(tmp_path, where):
    """A VP8 chunk cut at every byte of a range (the container's sizes
    rewritten, a pad byte after an odd size): cv2 reads a cut file exactly
    where the port does, the decodes equal. libwebp fails at the first bit
    that needs a byte past its partition, not at the first bit used; the
    last partition runs to the end of the file, pad byte included."""
    img = _texture(np.random.default_rng(3), 32, 48, "noise")
    parts = 2 if where == "tail_two_partitions" else 1
    payload = _payload(chip_smoke.vp8_bytes(img, q=60, partitions=parts, seed=2))
    first = 10 + vp8.frame_header(payload)[3]
    cuts = {"header": range(0, 24), "first_partition_end": range(first - 6, first + 8),
            "tail": range(len(payload) - 40, len(payload) + 1),
            "tail_two_partitions": range(len(payload) - 24, len(payload) + 1)}[where]
    read = [_refuses_as_cv2(tmp_path, _riff(_chunk(b"VP8 ", payload[:k])), f"cut_{k}.webp") for k in cuts]
    assert not read[0] and (read[-1] or not where.startswith("tail")), read


def test_vp8_still_image_reads_into_the_bytes_after_its_chunk(tmp_path):
    """A still image's last partition runs past its chunk into the chunks
    after it and past the RIFF size (libwebp's decoder is given the file to
    its end), an animation frame's only to its chunk's pad byte: the same cut
    reads in the first and fails in the second, as in cv2."""
    img = _texture(np.random.default_rng(4), 32, 48, "noise")
    payload = _payload(chip_smoke.vp8_bytes(img, q=60, seed=3))
    reads = []
    for k in range(len(payload) - 10, len(payload) + 1):
        cut = payload[:k]
        reads.append([_refuses_as_cv2(tmp_path, data, f"{tag}_{k}.webp") for tag, data in (
            ("chunk_after", _riff(_vp8x(0x00, 48, 32), _chunk(b"VP8 ", cut), _chunk(b"XMP ", bytes(60)))),
            ("past_riff", _riff(_chunk(b"VP8 ", cut)) + bytes(40)),
            ("frame", _riff(_vp8x(0x02, 48, 32), _chunk(b"ANIM", bytes(6)), _anmf(48, 32, _chunk(b"VP8 ", cut)),
                            _anmf(48, 32, _chunk(b"VP8 ", payload)))))])
    assert any(r[0] and r[1] and not r[2] for r in reads), reads


def _alph(head: int, body: bytes) -> bytes:
    return _chunk(b"ALPH", bytes([head]) + body)


def _header_refusals():
    img = _texture(np.random.default_rng(5), 24, 40, "smooth")
    payload = _payload(cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 70])[1].tobytes())
    lossless_alpha = _payload(_pil(np.zeros((24, 40, 3), np.uint8), lossless=True))[5:]  # a VP8L image stream
    still = lambda *alph: _riff(_vp8x(0x10, 40, 24), *alph, _chunk(b"VP8 ", payload))  # noqa: E731
    return {
        "not_a_key_frame": _frame(payload, tag=lambda b: b | 1),
        **{f"version_{v}": _frame(payload, tag=lambda b, v=v: (b & ~0xE) | v << 1) for v in range(8)},
        "not_shown": _frame(payload, tag=lambda b: b & ~0x10),
        "first_partition_is_the_chunk": _frame(payload, first=len(payload)),
        "first_partition_one_under_the_chunk": _frame(payload, first=len(payload) - 1),
        "first_partition_past_the_data": _frame(payload, first=len(payload) - 9),
        "start_code": _riff(_chunk(b"VP8 ", payload[:3] + b"\x9d\x01\x2b" + payload[6:])),
        "zero_width": _riff(_chunk(b"VP8 ", payload[:6] + b"\0\0" + payload[8:])),
        "zero_height": _riff(_chunk(b"VP8 ", payload[:8] + b"\0\0" + payload[10:])),
        "scale_bits_ignored": _riff(_chunk(b"VP8 ", payload[:7] + bytes([payload[7] | 0xC0]) + payload[8:])),
        "under_10_bytes": _riff(_chunk(b"VP8 ", payload[:9]), _chunk(b"XMP ", bytes(12))),
        "alph_raw": still(_alph(0, bytes(40 * 24))),
        "alph_raw_one_short": still(_alph(0, bytes(40 * 24 - 1))),
        "alph_of_1_byte": still(_chunk(b"ALPH", b"\0")),
        "alph_empty": still(_chunk(b"ALPH", b"")),
        **{f"alph_head_{h:#04x}": still(_alph(h, bytes(40 * 24))) for h in (0x02, 0x03, 0x0C, 0x10, 0x20, 0x40, 0x80)},
        "alph_lossless": still(_alph(1, lossless_alpha)),
        "alph_lossless_garbage": still(_alph(1, bytes(range(7, 40)))),
        "alph_last_one_decoded": still(_alph(3, bytes(9)), _alph(0, bytes(40 * 24))),
        "alph_last_one_refused": still(_alph(0, bytes(40 * 24)), _alph(3, bytes(9))),
        "alph_after_the_bitstream": _riff(_vp8x(0x10, 40, 24), _chunk(b"VP8 ", payload), _alph(3, bytes(9))),
        "frame_alph_refused": _riff(_vp8x(0x12, 40, 24), _chunk(b"ANIM", bytes(6)),
                                    _anmf(40, 24, _alph(3, bytes(9)) + _chunk(b"VP8 ", payload))),
        "eight_partitions_past_the_data": _riff(_chunk(b"VP8 ",
                                                       _payload(chip_smoke.vp8_bytes(img, partitions=8))[:-30])),
    }


HEADER_REFUSALS = sorted(_header_refusals())


@pytest.mark.parametrize("name", HEADER_REFUSALS)
def test_vp8_header_refusals_as_cv2(tmp_path, name):
    """Each frame tag, header, partition and ALPH case refuses (ValueError
    naming the file) exactly where cv2 returns None, and otherwise reads as
    cv2 reads it: a key frame, version 0-3 (the filter from the header's bit,
    not the version), shown, a first partition inside its chunk, a size that
    is not 0; a lossy image's last ALPH chunk before its bitstream decoded
    (compression 0 or 1, pre-processing 0 or 1, reserved bits 0, raw alpha
    of the frame's size), one after it read past."""
    _refuses_as_cv2(tmp_path, _header_refusals()[name], f"{name}.webp")


def _rgba_file(seed, palette_alpha):
    """A lossy 40x24 RGBA file (PIL) whose ALPH chunk is lossless: alpha in
    4 levels (a colour-indexed stream) or noise; returns (file, the ALPH
    chunk's payload start and size)."""
    rng = np.random.default_rng(seed)
    img = _texture(rng, 24, 40, "smooth")
    alpha = ((rng.integers(0, 4, (24, 40)) * 85).astype(np.uint8) if palette_alpha else
             rng.integers(0, 256, (24, 40), dtype=np.uint8))
    data = _pil(np.dstack([img, alpha]), quality=60, alpha_quality=100)
    at = data.find(b"ALPH")
    return data, at + 8, struct.unpack_from("<I", data, at + 4)[0]


@pytest.mark.parametrize("alpha", ["palette", "noise"])
def test_vp8_lossless_alpha_cut_at_every_byte(tmp_path, alpha):
    """A lossless ALPH chunk cut at every byte of its tail reads exactly where
    cv2 reads it: libwebp decodes a colour-indexed alpha stream (no cache,
    one-symbol red, blue and alpha codes) through its 8-bit path, whose last
    symbol may read past the data's end (a cut of one byte reads), any other
    as a VP8L image, which may not."""
    data, at, size = _rgba_file(1, alpha == "palette")
    rest = data[at + size + (size & 1):]
    read = [_refuses_as_cv2(tmp_path, _riff(_vp8x(0x10, 40, 24), _chunk(b"ALPH", data[at:at + k]), rest),
                            f"alph_{alpha}_{k}.webp") for k in range(size - 10, size + 1)]
    assert read[-1] and not read[0], read


@pytest.mark.parametrize("seed", range(2))
def test_vp8_alpha_byte_flips(tmp_path, seed):
    """Random byte flips in a lossless ALPH chunk (colour-indexed or not):
    the compiled decode and the twin both refuse or agree exactly, and refuse
    exactly where cv2 does (a corrupt ALPH fails cv2's colour read)."""
    rng = np.random.default_rng(seed)
    data, at, size = _rgba_file(seed + 2, seed == 0)
    for k in range(40):
        flipped = bytearray(data)
        for i in rng.integers(at, at + size, int(rng.integers(1, 3))):
            flipped[i] ^= 1 << int(rng.integers(8))
        _refuses_as_cv2(tmp_path, bytes(flipped), f"alph_flip_{seed}_{k}.webp")


@pytest.mark.parametrize("seed", range(4))
def test_vp8_byte_flips(tmp_path, seed):
    """Random byte flips in a lossy file's bitstream (its frame header and
    partitions): the compiled decode and the twin both refuse or agree
    exactly, and refuse exactly where cv2 does."""
    rng = np.random.default_rng(seed)
    img = _texture(rng, 24, 40, "noise" if seed % 2 else "smooth")
    data = bytearray(chip_smoke.vp8_bytes(img, q=int(rng.integers(0, 128)), partitions=int(2 ** rng.integers(4)),
                                          bpred=0.5, seed=seed))
    for k in range(30):
        flipped = bytearray(data)
        for at in rng.integers(20, len(data), int(rng.integers(1, 4))):
            flipped[at] ^= 1 << int(rng.integers(8))
        want, got, plain = _read(tmp_path, bytes(flipped), f"flip_{seed}_{k}.webp")
        assert isinstance(got, ValueError) == isinstance(plain, ValueError) == (want is None), (k, got, plain)
        if want is not None:
            np.testing.assert_array_equal(plain, got)
        else:
            assert ("truncated" in str(got)) == ("truncated" in str(plain)), (got, plain)
