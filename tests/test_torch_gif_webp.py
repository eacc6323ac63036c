"""The port's GIF and lossless WebP readers on the CPU against ``cv2.imread``
(the JAX package's decoder), bit for bit, through the frame reader: GIF as
cv2, PIL and the byte writer of ``chip_smoke.py`` write it (palettes of 2 to
256 colours, so minimum code sizes 2-8; interlaced; GIF87a; local tables;
transparent indices over background indices 0 and not 0; sub-rectangles of
the screen; animated files; a deferred clear past 4096 codes; no colour
table at all), and lossless WebP as cv2, PIL (every method, several
qualities, palettes with and without bundling, RGBA with and without
``exact``, EXIF orientations 1-8, animated files) and the writer (its
transforms case and its colour-indexing case) write it, and the container's
chunks that cv2 reads past. Each compiled routine (``gif_lzw_decode``,
``vp8l_decode``) is held against its plain twin on every case. Every file
that cv2 fails to read raises ValueError naming the file; lossy WebP, which
these cases once refused, reads as cv2 reads it (``tests/test_torch_vp8.py``
holds the lossy decode itself). Then the readers over ADOBE and NFS clip
lists of GIF, of lossless and of lossy WebP frames against the JAX package's,
item for item, and the Loader's batches on four threads."""

import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from superslomo_tpu.data import readers as jax_readers
from superslomo_tpu_torch.data import get_dataset, gif, image, readers, webp
from tests.test_torch_data import _configs
from tests.test_torch_package import one_torch_thread  # noqa: F401


def _texture(rng, h, w, kind):
    """(h, w, 3) uint8: uniform noise, or a smooth sum of sines."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 6.3, 3)
    return np.stack([128 + 120 * np.sin(xx / (3 + i) + yy / (5 + 2 * i) + phase[i]) for i in range(3)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _pil(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    (Image.fromarray(img) if isinstance(img, np.ndarray) else img).save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_frames(frames, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    first, *rest = [Image.fromarray(f) for f in frames]
    first.save(buf, fmt, save_all=True, append_images=rest, duration=100, **kw)
    return buf.getvalue()


def _check(tmp_path, data: bytes, name: str, plain):
    """The frame reader's decode of ``data`` (written as ``name``) equals
    ``cv2.imread``'s bit for bit, and so does ``plain(data, path)``."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want is not None, f"cv2 does not read {name}"
    want = want[..., ::-1]
    got = image.imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(plain(data, str(path)), got, err_msg=f"{name}: plain")


# --------------------------------------------------------------------------- #
# GIF


def _indices(rng, colours, h=37, w=53):
    """(h, w) palette indices below ``colours``, a smooth field with noise."""
    smooth = _texture(rng, h, w, "smooth").astype(np.int64).sum(axis=2)
    return ((smooth * colours // 766 + rng.integers(0, 2, (h, w))) % colours).astype(np.uint8)


def _palette_gif(idx, colours, **kw) -> bytes:
    img = Image.fromarray(idx, "P")
    img.putpalette(np.random.default_rng(colours).integers(0, 256, 3 * colours).tolist())
    return _pil(img, "GIF", **kw)


def _gif_case(name) -> bytes:
    rng = np.random.default_rng(sorted(GIF_CASES).index(name))
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    if name == "cv2_imencode":
        return cv2.imencode(".gif", _texture(rng, 37, 53, "noise"))[1].tobytes()
    if name.startswith("pil_colours_"):
        colours = int(name.rsplit("_", 1)[1])
        return _palette_gif(_indices(rng, colours), colours)
    if name == "pil_rgb_interlaced":
        return _pil(_texture(rng, 64, 64, "smooth"), "GIF", interlace=True)
    if name == "pil_animated":
        return _pil_frames([_texture(rng, 37, 53, "smooth"), _texture(rng, 37, 53, "noise")], "GIF")
    idx = _indices(rng, 16)
    kw = {"interlaced": dict(interlace=True), "gif87a": dict(version=b"GIF87a"),
          "local_table": dict(local=pal[100:116]),
          "local_and_global_tables": dict(local=pal[:4], min_size=4),  # indices 4-15 from the global table
          "local_table_only": dict(local=pal[:16], palette=None),
          "transparent_background_0": dict(screen=(60, 45), at=(3, 5), transparent=int(idx[0, 0]), background=0),
          "transparent_background_9": dict(screen=(60, 45), at=(7, 8), transparent=int(idx[0, 0]), background=9,
                                           interlace=True),
          "sub_rectangle": dict(screen=(64, 64), at=(11, 27), background=5),
          "no_colour_table": dict(palette=None, min_size=4)}.get(name)
    if kw is not None:
        return chip_smoke.gif_bytes(idx, **{"palette": pal[:16], **kw})
    assert name == "deferred_clear", name
    idx = rng.integers(0, 256, (64, 64), dtype=np.uint8)  # noise: the table fills before the image ends
    data = chip_smoke.gif_bytes(idx, pal, defer_clear=True)
    assert data == chip_smoke.gif_bytes(idx, pal, lzw=chip_smoke.gif_lzw(idx.tobytes(), 8, defer_clear=True))
    return data


GIF_CASES = ["cv2_imencode", "pil_colours_2", "pil_colours_4", "pil_colours_16", "pil_colours_256",
             "pil_rgb_interlaced", "pil_animated", "interlaced", "gif87a", "local_table", "local_and_global_tables",
             "local_table_only", "transparent_background_0", "transparent_background_9", "sub_rectangle",
             "no_colour_table", "deferred_clear"]


@pytest.mark.parametrize("name", GIF_CASES)
def test_gif_equals_cv2(tmp_path, name):
    """Each GIF reads as cv2 reads it (the first frame on the screen's canvas,
    the background entry around the image and under its transparent pixels,
    the local table before the global one, cv2's default table without
    either), and the plain LZW twin equals the compiled routine."""
    _check(tmp_path, _gif_case(name), f"{name}.gif", lambda data, path: gif.decode(data, path, plain=True))


def test_gif_lzw_equals_plain_on_its_edges():
    """``gif_lzw_decode`` against ``lzw_plain`` on hand-made code streams
    of 5-bit codes: a clear mid-stream, an end code that resets and goes on,
    KwKwK codes, codes past the table, short and long streams, and codes
    after the image is full (cv2 stops at the first that is neither a clear
    nor an end code, which must end in the data's last byte)."""
    C, E = 16, 17
    full = [C] + list(range(1, 9))
    streams = [full + [E], full, [C, 1, 2, 3, E], [C, 1, 2, 3, E, 4, 5, 6, 7, 8], [C, 1, 2, C, 3, 4, 5, 6, 7, 8],
               [C, 1, 18, 3, 4, 5, 6, 7, E], [C, 1, 2, 3, 18, 19, 6, E], [C, 18, 1, 2, 3, 4, 5, 6, 7, E],
               [C, 1, 2, 20, 5, 6, 7, 8, E], [C, 1, 2, 3, 4, 5, 6, 7, 18, E], full + [9, 9], full + [9, 9, 9],
               full + [E, E, E, E], full + [E, 9, 9], full + [E, 18]]
    results = set()
    for codes in streams:
        data = chip_smoke.pack_lsb(codes, [5] * len(codes))
        want, n = gif.lzw_plain(data, 4, 8)
        got, m = gif._lzw(data, 4, 8)
        assert m == n, codes
        if n >= 0:
            np.testing.assert_array_equal(got, want, err_msg=str(codes))
        results.add(n)
    assert results == {8, -1, -2, -3}  # every outcome is met


# --------------------------------------------------------------------------- #
# WebP


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + bytes(len(payload) & 1)


def _riff(*chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(flags, w, h) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def _anmf(x, y, w, h, flags, frame) -> bytes:
    return _chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100)) +
                  bytes([flags]) + frame)


def _bitstream(data: bytes) -> bytes:
    """The first chunk (header and payload) of a simple WebP file."""
    (size,) = struct.unpack_from("<I", data, 16)
    return data[12:20 + size + (size & 1)]


def _webp_case(name) -> bytes:
    rng = np.random.default_rng(100 + sorted(WEBP_CASES).index(name))
    img = _texture(rng, 37, 53, "smooth" if rng.integers(2) else "noise")
    if name == "cv2_quality_101":
        return cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
    if name.startswith("pil_method_"):
        method, quality = (int(v) for v in name.split("_")[2::2])
        return _pil(img, "WEBP", lossless=True, method=method, quality=quality)
    if name.startswith("pil_colours_"):
        colours = int(name.rsplit("_", 1)[1])
        pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
        return _pil(pal[_indices(rng, colours)], "WEBP", lossless=True)
    if name.startswith("pil_rgba_exact_"):
        alpha = rng.integers(0, 256, img.shape[:2], dtype=np.uint8)
        alpha[::3] = 0
        return _pil(np.dstack([img, alpha]), "WEBP", lossless=True, exact=name.endswith("on"))
    if name.startswith("pil_exif_orientation_"):
        exif = Image.Exif()
        exif[0x0112] = int(name.rsplit("_", 1)[1])
        return _pil(img[:8, :12], "WEBP", lossless=True, exif=exif.tobytes())
    if name == "pil_animated":
        return _pil_frames([img, 255 - img], "WEBP", lossless=True)
    if name == "animated_frame_at_offset":  # an RGBA first frame inside a larger canvas, blend and dispose flags set
        rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], dtype=np.uint8)])
        frame = _bitstream(_pil(rgba, "WEBP", lossless=True, exact=True))
        return _riff(_vp8x(0x12, 64, 48), _chunk(b"ANIM", bytes(6)), _anmf(6, 4, 53, 37, 3, frame),
                     _anmf(0, 0, 53, 37, 0, _bitstream(_pil(img, "WEBP", lossless=True))))
    if name == "vp8x_chunks_read_past":  # ICCP (odd size, padded), ALPH, XMP and an unknown chunk
        return _riff(_vp8x(0x24, 53, 37), _chunk(b"ICCP", b"x" * 7), _chunk(b"ALPH", bytes(5)),
                     _bitstream(_pil(img, "WEBP", lossless=True)), _chunk(b"XMP ", b"abc"), _chunk(b"ABCD", b"1"))
    if name == "writer_transforms":
        return chip_smoke.vp8l_bytes(img, pred_bits=2, cache_bits=4)
    assert name == "writer_colour_indexing", name
    return chip_smoke.vp8l_bytes(chip_smoke.palette_16(img), "palette")


WEBP_CASES = (["cv2_quality_101"] + [f"pil_method_{m}_quality_{q}" for m in range(7) for q in (0, 100)] +
              ["pil_method_4_quality_50", "pil_colours_2", "pil_colours_3", "pil_colours_16", "pil_colours_200",
               "pil_rgba_exact_on", "pil_rgba_exact_off", "pil_animated", "animated_frame_at_offset",
               "vp8x_chunks_read_past", "writer_transforms", "writer_colour_indexing"] +
              [f"pil_exif_orientation_{k}" for k in range(1, 9)])


@pytest.mark.parametrize("name", WEBP_CASES)
def test_webp_equals_cv2(tmp_path, name):
    """Each lossless WebP reads as cv2 reads it (the colour channels as
    stored, alpha dropped; the EXIF turn; an animation's first frame on a
    black canvas), and the plain VP8L twin equals the compiled routine."""
    _check(tmp_path, _webp_case(name), f"{name}.webp", lambda data, path: webp.decode(data, path, plain=True))


# --------------------------------------------------------------------------- #
# what cv2 fails on, and lossy WebP


def _literal_stream(values, min_size=4) -> bytes:
    """GIF LZW data coding each of ``values`` as a literal after one clear
    code, at the widths a decoder reads them (the table grows a code each)."""
    first = (1 << min_size) + 2
    widths = [min_size + 1] + [max(min_size + 1, (first - 2 + j).bit_length()) for j in range(1, len(values) + 1)]
    return chip_smoke.pack_lsb([1 << min_size] + list(values), widths)


def _payload(data: bytes) -> bytes:
    """The first chunk's payload of a simple WebP file."""
    (size,) = struct.unpack_from("<I", data, 16)
    return data[20:20 + size]


_PAST_END = b"ABCD" + struct.pack("<I", 1000) + b"xyz"  # a chunk whose size runs past the data's end


def _refusal_files():
    rng = np.random.default_rng(5)
    img = _texture(rng, 9, 17, "noise")
    idx = _indices(rng, 16, 9, 17)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    lossless = _pil(img, "WEBP", lossless=True)
    lossy = _pil(img, "WEBP")
    version = bytearray(_payload(lossless))
    version[4] |= 0x20
    return {
        "gif_code_past_table": (chip_smoke.gif_bytes(idx, pal, lzw=_literal_stream([1] * 150 + [200])), ValueError,
                                "past the table"),
        "gif_cut_short": (chip_smoke.gif_bytes(idx, pal)[:-1], ValueError, "truncated"),
        "gif_stream_short_of_the_image": (chip_smoke.gif_bytes(idx, pal, lzw=_literal_stream([1, 2, 3, 17])),
                                          ValueError, "short of the image"),
        "gif_codes_past_the_image": (chip_smoke.gif_bytes(idx, pal, lzw=_literal_stream(list(idx.flat) + [3, 3, 3])),
                                     ValueError, "past the image"),
        "gif_image_past_the_screen": (chip_smoke.gif_bytes(idx, pal, screen=(17, 9), at=(1, 0)), ValueError,
                                      "past the 17x9"),
        "gif_background_past_the_table": (chip_smoke.gif_bytes(idx, pal[:4], background=7, min_size=4), ValueError,
                                          "background index"),
        "gif_index_past_the_tables": (chip_smoke.gif_bytes(idx, pal[:4], min_size=4), ValueError, "past the colour"),
        "webp_cut_short": (lossless[:-10], ValueError, "truncated"),
        "webp_bitstream_cut": (_riff(_chunk(b"VP8L", _payload(lossless)[:-12])), ValueError, "VP8L"),
        "webp_version_bits": (_riff(_chunk(b"VP8L", bytes(version))), ValueError, "refuses"),
        "webp_canvas_mismatch": (_riff(_vp8x(0x10, 18, 9), _bitstream(lossless)), ValueError, "canvas"),
        "webp_frame_past_canvas": (_riff(_vp8x(0x12, 17, 9), _chunk(b"ANIM", bytes(6)),
                                         _anmf(2, 0, 17, 9, 0, _bitstream(lossless))), ValueError, "past the"),
        "webp_under_32_bytes": (lossless[:12] + b"VP8L\x05\0\0\0\x2f\0\0\0\0", ValueError, "under the 32"),
        "webp_chunk_past_the_end_before_the_bitstream": (_riff(_vp8x(0, 17, 9), _PAST_END + _bitstream(lossless)),
                                                         ValueError, "past the data's end"),
        "webp_animation_chunk_past_the_end": (_riff(_vp8x(0x02, 17, 9), _chunk(b"ANIM", bytes(6)),
                                                    _anmf(0, 0, 17, 9, 0, _bitstream(lossless)), _PAST_END),
                                              ValueError, "past the data's end"),
        "webp_animation_second_frame_empty": (_riff(_vp8x(0x02, 17, 9), _chunk(b"ANIM", bytes(6)),
                                                    _anmf(0, 0, 17, 9, 0, _bitstream(lossless)), _anmf(0, 0, 17, 9, 0,
                                                                                                        b"")),
                                              ValueError, "frame cut short"),
        "webp_animation_frame_of_alpha_alone": (_riff(_vp8x(0x12, 17, 9), _chunk(b"ANIM", bytes(6)),
                                                      _anmf(0, 0, 17, 9, 0, _chunk(b"ALPH", bytes(154))),
                                                      _anmf(0, 0, 17, 9, 0, _bitstream(lossy))),
                                                ValueError, "no bitstream"),
        "webp_animation_alpha_before_vp8l": (_riff(_vp8x(0x12, 17, 9), _chunk(b"ANIM", bytes(6)),
                                                   _anmf(0, 0, 17, 9, 0, _chunk(b"ALPH", bytes(154))
                                                         + _bitstream(lossless))), ValueError, "before a VP8L"),
        "webp_animation_unknown_chunk_before_the_bitstream": (_riff(
            _vp8x(0x02, 17, 9), _chunk(b"ANIM", bytes(6)),
            _anmf(0, 0, 17, 9, 0, _chunk(b"ABCD", b"12") + _bitstream(lossless))), ValueError, "outside the frames"),
        "webp_animation_reserved_flag": (_riff(_vp8x(0x03, 17, 9), _chunk(b"ANIM", bytes(6)),
                                               _anmf(0, 0, 17, 9, 0, _bitstream(lossless))), ValueError,
                                         "reserved bit"),
    }


REFUSALS = sorted(_refusal_files())


@pytest.mark.parametrize("name", REFUSALS)
def test_gif_webp_refusals_name_the_file(tmp_path, name):
    """A file that cv2 fails to read raises ValueError naming the file and
    the fault (cv2 returns None for each)."""
    data, kind, words = _refusal_files()[name]
    path = tmp_path / f"{name}.img"
    path.write_bytes(data)
    with pytest.raises(kind, match=rf"{name}\.img.*{words}"):
        image.imread(str(path))
    assert cv2.imread(str(path)) is None


def _container_files():
    """The RIFF container's faults that cv2 reads past: a chunk past the
    data's end after a still image's bitstream (libwebp's decode stops at
    the bitstream); an animation whose first frames hold no bitstream (the
    demuxer passes over them and returns the next frame's image); and the
    EXIF orientation that cv2 applies only where the demuxer reads the whole
    file (not with a chunk past the end, nor with bytes too few for a chunk
    after the last one)."""
    rng = np.random.default_rng(8)
    img, img2 = _texture(rng, 9, 17, "noise"), _texture(rng, 9, 17, "smooth")
    square = _texture(rng, 9, 9, "noise")
    lossless, lossy = _bitstream(_pil(img, "WEBP", lossless=True)), _bitstream(_pil(img, "WEBP"))
    second = _bitstream(_pil(img2, "WEBP", lossless=True))
    exif = Image.Exif()
    exif[0x0112] = 6
    rotated = _pil(square, "WEBP", lossless=True, exif=exif.tobytes())
    at = rotated.find(b"EXIF")
    exif_chunk = rotated[at:at + 8 + struct.unpack_from("<I", rotated, at + 4)[0]]
    exif_chunk += bytes(len(exif_chunk) & 1)
    still = _bitstream(_pil(square, "WEBP", lossless=True))
    anim = (_vp8x(0x12, 17, 9), _chunk(b"ANIM", bytes(6)))
    return {
        "vp8l_then_chunk_past_the_end": _riff(lossless, _PAST_END),
        "vp8_then_chunk_past_the_end": _riff(lossy, _PAST_END),
        "vp8x_vp8l_then_chunk_past_the_end": _riff(_vp8x(0, 17, 9), lossless, _PAST_END),
        "vp8x_alph_vp8_then_chunk_past_the_end": _riff(_vp8x(0x10, 17, 9), _chunk(b"ALPH", bytes(154)), lossy,
                                                       _PAST_END),
        "exif_applied": _riff(_vp8x(0x08, 9, 9), still, exif_chunk),
        "exif_then_chunk_past_the_end": _riff(_vp8x(0x08, 9, 9), still, exif_chunk, _PAST_END),
        "exif_then_3_bytes": _riff(_vp8x(0x08, 9, 9), still, exif_chunk, b"\x00\x01\x02"),
        "exif_before_the_bitstream_then_chunk_past_the_end": _riff(_vp8x(0x08, 9, 9), exif_chunk, still, _PAST_END),
        "first_frame_unknown_chunk_only": _riff(*anim, _anmf(0, 0, 17, 9, 0, _chunk(b"ABCD", b"12")),
                                                _anmf(0, 0, 17, 9, 0, second)),
        "first_frame_empty": _riff(*anim, _anmf(0, 0, 17, 9, 0, b""), _anmf(0, 0, 17, 9, 0, second)),
        "first_two_frames_without_bitstream_off_the_canvas": _riff(
            *anim, _anmf(8, 2, 17, 9, 0, _chunk(b"ABCD", b"12")), _anmf(0, 0, 3, 3, 0, b""),
            _anmf(0, 0, 17, 9, 0, second)),
        "first_frame_without_bitstream_then_lossy": _riff(*anim, _anmf(0, 0, 17, 9, 0, _chunk(b"XYZW", b"1")),
                                                          _anmf(0, 0, 17, 9, 0, _chunk(b"ALPH", bytes(154)) + lossy)),
        "second_frame_unknown_chunk_only": _riff(*anim, _anmf(0, 0, 17, 9, 0, lossless),
                                                 _anmf(0, 0, 17, 9, 0, _chunk(b"ABCD", b"12"))),
    }


@pytest.mark.parametrize("name", sorted(_container_files()))
def test_webp_container_reads_past_what_cv2_reads_past(tmp_path, name):
    """Each container case reads as cv2 reads it, compiled and plain."""
    _check(tmp_path, _container_files()[name], f"{name}.webp", lambda data, path: webp.decode(data, path, plain=True))


def _lossy_files():
    """The lossy files that the refusal cases named until the port read them."""
    rng = np.random.default_rng(5)
    img = _texture(rng, 9, 17, "noise")
    lossy = _pil(img, "WEBP")
    return {
        "webp_lossy": lossy,
        "webp_lossy_cv2_quality_80": cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes(),
        "webp_lossy_first_frame": _riff(_vp8x(0x12, 17, 9), _chunk(b"ANIM", bytes(6)),
                                        _anmf(0, 0, 17, 9, 0, _bitstream(lossy)),
                                        _anmf(0, 0, 17, 9, 0, _bitstream(_pil(img, "WEBP", lossless=True)))),
    }


@pytest.mark.parametrize("name", sorted(_lossy_files()))
def test_lossy_webp_reads_as_cv2(tmp_path, name):
    """Lossy WebP (a simple file as PIL and cv2 write it, and an animation
    whose first frame is lossy) reads as cv2 reads it, and the plain VP8 twin
    equals the compiled decode."""
    _check(tmp_path, _lossy_files()[name], f"{name}.webp", lambda data, path: webp.decode(data, path, plain=True))


# --------------------------------------------------------------------------- #
# the readers and the Loader against the JAX package's, over clip lists


FRAME_H, FRAME_W = 20, 28


@pytest.fixture(scope="module", params=["gif", "webp", "webp_lossy"])
def clip_lists(request, tmp_path_factory):
    """ADOBE and NFS train lists of three 12-frame clips whose frames are GIF
    (cv2's and the writer's, interlaced with a transparent sub-rectangle),
    lossless WebP (cv2's, PIL's and the writer's) or lossy WebP (cv2's, PIL's
    and the writer's)."""
    kind = request.param
    root = tmp_path_factory.mktemp(f"{kind}_lists")
    rng = np.random.default_rng(31)
    clips = []
    for c in range(3):
        folder = root / f"clip_{c}"
        os.makedirs(folder)
        paths = []
        for i in range(12):
            img = _texture(rng, FRAME_H, FRAME_W, "smooth" if (i + c) % 2 else "noise")
            if kind == "gif":
                data = (cv2.imencode(".gif", img[..., ::-1])[1].tobytes() if i % 2 else
                        chip_smoke.gif_window(img)[0])
            elif kind == "webp":
                data = [lambda: cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes(),
                        lambda: _pil(img, "WEBP", lossless=True, method=i % 7),
                        lambda: chip_smoke.vp8l_bytes(img, pred_bits=2, cache_bits=3)][i % 3]()
            else:
                data = [lambda: cv2.imencode(".webp", img[..., ::-1], [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes(),
                        lambda: _pil(img, "WEBP", quality=80, method=i % 7),
                        lambda: chip_smoke.vp8_bytes(img, partitions=2, seed=i)][i % 3]()
            paths.append(str(folder / f"frame_{i:05d}.{kind.split('_')[0]}"))
            with open(paths[-1], "wb") as f:
                f.write(data)
        clips.append(paths)
    listing = "".join(f"{len(p)}\n" + "".join(q + "\n" for q in p) for p in clips)
    for name in ("adobe_train.txt", "nfs_train.txt"):
        (root / name).write_text(listing)
    return {"ADOBE_DATA": {"TRAINPATHS": root / "adobe_train.txt", "H_IN": FRAME_H, "W_IN": FRAME_W},
            "NFS_DATA": {"TRAINPATHS": root / "nfs_train.txt"}, "root": root}


@pytest.mark.parametrize("name", ["ADOBE", "NFS"])
def test_reader_over_gif_webp_lists_equals_jax(clip_lists, name):
    """The port's ADOBE and NFS readers over the GIF or WebP clip list equal
    the JAX package's ``build_reader`` item for item, and ``read_sample``
    float64 for float64."""
    cfg, jcfg = _configs(clip_lists, name, eval_mode=False)
    ours, theirs = readers.build_reader(cfg, "TRAIN"), jax_readers.build_reader(jcfg, "TRAIN")
    assert ours.clips == theirs.clips and len(ours) == len(theirs) == 3
    for idx in range(3):
        for a, b in zip(ours.__getitem__(idx, rng=np.random.default_rng([6, idx])),
                        theirs.__getitem__(idx, rng=np.random.default_rng([6, idx]))):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        got, want = ours.read_sample(ours.clips[idx], range(12)), theirs.read_sample(theirs.clips[idx], range(12))
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (12, FRAME_H, FRAME_W, 3)
        np.testing.assert_array_equal(got, want)


def test_loader_over_gif_webp_list_equals_jax_on_threads(clip_lists):
    """``get_dataset`` over the list, 4 loader threads decoding at once
    through the compiled routines, equals the JAX package's batches."""
    cfg, jcfg = _configs(clip_lists, "ADOBE", eval_mode=False, workers=4, batch=1)
    ours, theirs = get_dataset(cfg, "TRAIN"), jax_readers.get_dataset(jcfg, "TRAIN")
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
