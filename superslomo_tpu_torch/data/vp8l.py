"""The plain Python twin of ``csrc/webp_decode.cpp``'s ``vp8l_decode``: the
same lossless WebP (VP8L) decode, step by step, from the bitstream to ARGB
pixels, as libwebp computes it (the header, the transforms, the colour cache,
the meta prefix codes, the prefix codes and LZ77 copies; the C++ file's
comment lists each rule). It is for the tests and ``chip_smoke.py``'s checks,
and runs on no path when the compiled library is present. ``decode`` returns
the (height, width) uint32 ARGB pixels, or raises ValueError naming the fault.
"""

from __future__ import annotations

import numpy as np

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
DISTANCE_MAP = (  # (dx, dy) of the 120 short distance codes: distance dx + dy * xsize, at least 1
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0),
    (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1),
    (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3),
    (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5),
    (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1),
    (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7), (7, 3), (-7, 3),
    (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6),
    (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7),
    (8, 6), (8, 7))


class _Bits:
    """LSB-first bits of ``data``; reading past its end (or past 64 bits of a
    stream under 8 bytes, as libwebp) is noticed by ``check``."""

    def __init__(self, data: bytes):
        self.b = bytes(data) + bytes(8)
        self.pos, self.limit = 0, 8 * len(data) if len(data) >= 8 else 64

    def peek(self, k: int) -> int:
        at = self.pos >> 3
        return (int.from_bytes(self.b[at:at + 4], "little") >> (self.pos & 7)) & ((1 << k) - 1)

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        v = self.peek(k)
        self.pos += k
        return v

    def check(self):
        if self.pos > self.limit:
            raise ValueError("the VP8L data ends too soon (truncated)")


class _Code:
    """A canonical prefix code, decoded a bit at a time; one symbol reads no bits."""

    def __init__(self, lengths):
        count = [0] * 16
        for n in lengths:
            if not 0 <= n <= 15:
                raise ValueError("a code length past 15")
            count[n] += 1
        used = len(lengths) - count[0]
        if used == 0:
            raise ValueError("a prefix code of no symbols")
        self.single = next(s for s, n in enumerate(lengths) if n) if used == 1 else None
        if used > 1:
            left = 1
            for n in range(1, 16):
                left = 2 * left - count[n]
                if left < 0:
                    raise ValueError("an over-subscribed prefix code")
            if left:
                raise ValueError("an incomplete prefix code")
        self.first, self.count, self.offset = [0] * 16, count, [0] * 16  # first code, symbols, index of each length
        for n in range(2, 16):
            self.first[n] = (self.first[n - 1] + count[n - 1]) << 1
            self.offset[n] = self.offset[n - 1] + count[n - 1]
        self.symbols = [s for n in range(1, 16) for s, m in enumerate(lengths) if m == n]

    def read(self, br: _Bits) -> int:
        if self.single is not None:
            return self.single
        v, code = br.peek(15), 0
        for n in range(1, 16):
            code = (code << 1) | ((v >> (n - 1)) & 1)
            k = code - self.first[n]
            if 0 <= k < self.count[n]:
                br.pos += n
                return self.symbols[self.offset[n] + k]
        raise AssertionError("a complete code always decodes")


def _read_code(br: _Bits, alphabet: int) -> _Code:
    lengths = [0] * max(alphabet, 256)
    if br.read(1):  # simple: one or two symbols
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        cl_code = _Code(cl)
        max_symbol = alphabet
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise ValueError("max_symbol past the alphabet")
        symbol, prev = 0, 8
        while symbol < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            n = cl_code.read(br)
            if n < 16:
                lengths[symbol] = n
                symbol += 1
                prev = n or prev
            else:
                repeat = br.read((2, 3, 7)[n - 16]) + (3, 3, 11)[n - 16]
                if symbol + repeat > alphabet:
                    raise ValueError("a repeated code length past the alphabet")
                lengths[symbol:symbol + repeat] = [prev if n == 16 else 0] * repeat
                symbol += repeat
            br.check()
    br.check()
    return _Code(lengths[:alphabet])


def _div_round_up(v: int, bits: int) -> int:
    return (v + (1 << bits) - 1) >> bits


def _prefix_value(br: _Bits, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _image(br: _Bits, xsize: int, ysize: int, transforms, alpha: bool = False) -> list:
    """One entropy-coded image, as a flat list of ARGB ints; ``transforms``
    (a list) marks the main image, whose transforms it collects as (type,
    bits, xsize, ysize, data). With ``alpha`` the main image is a lossless
    ALPH chunk's: libwebp decodes one whose only transform is colour
    indexing, without a colour cache, whose red, blue and alpha codes are
    one symbol each, through its 8-bit path, where the last symbol may read
    past the data's end."""
    if transforms is not None:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError(f"transform {kind} twice")
            seen.add(kind)
            bits, data = 0, None
            if kind in (0, 1):
                bits = 2 + br.read(3)
                data = _image(br, _div_round_up(xsize, bits), _div_round_up(ysize, bits), None)
            elif kind == 3:
                colors = br.read(8) + 1
                bits = 0 if colors > 16 else 1 if colors > 4 else 2 if colors > 2 else 3
                pal = np.array(_image(br, colors, 1, None), np.uint32).view(np.uint8)
                data = np.zeros(4 << (8 >> bits), np.uint8)  # past the palette: 0
                data[:pal.size] = np.cumsum(pal.reshape(-1, 4), axis=0, dtype=np.uint8).reshape(-1)
                data = data.view(np.uint32).tolist()
            br.check()
            transforms.append((kind, bits, xsize, ysize, data))
            if kind == 3:
                xsize = _div_round_up(xsize, bits)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"a colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if transforms is not None and br.read(1):
        meta_bits = 2 + br.read(3)
        meta_w = _div_round_up(xsize, meta_bits)
        meta = [(m >> 8) & 0xFFFF for m in _image(br, meta_w, _div_round_up(ysize, meta_bits), None)]
    br.check()
    cache_size = 1 << cache_bits if cache_bits else 0
    alphabets = (256 + 24 + cache_size, 256, 256, 256, 40)
    groups = [[_read_code(br, a) for a in alphabets] for _ in range(max(meta) + 1 if meta else 1)]
    cache = [0] * max(cache_size, 1)
    px, cached, total = [], 0, xsize * ysize
    overrun = (alpha and [t[0] for t in transforms] == [3] and not cache_size and
               all(g[k].single is not None for g in groups for k in (1, 2, 3)))  # the last symbol may overrun
    while len(px) < total:
        i = len(px)
        y, x = divmod(i, xsize)
        g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)] if meta else 0]
        code = g[0].read(br)
        if code < 256:
            red, blue, a = g[1].read(br), g[2].read(br), g[3].read(br)
            if not (overrun and i + 1 == total):
                br.check()
            px.append((a << 24) | (red << 16) | (code << 8) | blue)
        elif code < 256 + 24:
            length = _prefix_value(br, code - 256)
            dist = _prefix_value(br, g[4].read(br))
            if dist > 120:
                dist -= 120
            else:
                dx, dy = DISTANCE_MAP[dist - 1]
                dist = max(dx + dy * xsize, 1)
            if not (overrun and i + length >= total):
                br.check()
            if i < dist or total - i < length:
                raise ValueError("a copy from before the image or past its end")
            for k in range(length):
                px.append(px[i + k - dist])
        elif code < 256 + 24 + cache_size:
            for v in px[cached:]:
                cache[((0x1E35A7BD * v) & 0xFFFFFFFF) >> (32 - cache_bits)] = v
            cached = len(px)
            px.append(cache[code - 256 - 24])
        else:
            raise ValueError("a green symbol past the alphabet")
    if not overrun:
        br.check()
    return px


def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v):
    return [(v >> s) & 0xFF for s in (0, 8, 16, 24)]


def _pack(ch):
    return ch[0] | ch[1] << 8 | ch[2] << 16 | ch[3] << 24


def _half(a, b):  # C's (a - b) / 2, rounding toward zero
    d = a - b
    return a + (-((-d) // 2) if d < 0 else d // 2)


def _predict(mode, L, T, TL, TR):
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _average2(_average2(L, TR), T)
    if mode == 6:
        return _average2(L, TL)
    if mode == 7:
        return _average2(L, T)
    if mode == 8:
        return _average2(TL, T)
    if mode == 9:
        return _average2(T, TR)
    if mode == 10:
        return _average2(_average2(L, TL), _average2(T, TR))
    if mode == 11:  # Select(T, L, TL)
        d = sum(abs(l - tl) - abs(t - tl) for t, l, tl in zip(_channels(T), _channels(L), _channels(TL)))
        return T if d <= 0 else L
    if mode == 12:
        return _pack([min(max(l + t - tl, 0), 255) for l, t, tl in zip(_channels(L), _channels(T), _channels(TL))])
    if mode == 13:
        return _pack([min(max(_half(a, b), 0), 255) for a, b in zip(_channels(_average2(L, T)), _channels(TL))])
    return 0xFF000000  # 0, 14, 15


def _add(a, b):
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _int8(v):
    v &= 0xFF
    return v - 256 if v > 127 else v


def _inverse(t, px):
    kind, bits, w, h, data = t
    if kind == 0:
        tiles = _div_round_up(w, bits)
        px[0] = _add(px[0], 0xFF000000)
        for x in range(1, w):
            px[x] = _add(px[x], px[x - 1])
        for y in range(1, h):
            r = y * w
            px[r] = _add(px[r], px[r - w])
            for x in range(1, w):
                mode = (data[(y >> bits) * tiles + (x >> bits)] >> 8) & 0xF
                i = r + x
                px[i] = _add(px[i], _predict(mode, px[i - 1], px[i - w], px[i - w - 1], px[i - w + 1]))
        return px
    if kind == 1:
        tiles = _div_round_up(w, bits)
        for i, v in enumerate(px):
            y, x = divmod(i, w)
            m = data[(y >> bits) * tiles + (x >> bits)]
            green = _int8(v >> 8)
            red = (((v >> 16) & 0xFF) + ((_int8(m) * green) >> 5)) & 0xFF
            blue = ((v & 0xFF) + ((_int8(m >> 8) * green) >> 5) + ((_int8(m >> 16) * _int8(red)) >> 5)) & 0xFF
            px[i] = (v & 0xFF00FF00) | red << 16 | blue
        return px
    if kind == 2:
        out = []
        for v in px:
            g = (v >> 8) & 0xFF
            out.append((v & 0xFF00FF00) | ((((v >> 16) + g) & 0xFF) << 16) | (((v & 0xFF) + g) & 0xFF))
        return out
    packed_w, bpp = _div_round_up(w, bits), 8 >> bits
    out = []
    for y in range(h):
        for x in range(w):
            index = ((px[y * packed_w + (x >> bits)] >> 8) & 0xFF) >> (bpp * (x & ((1 << bits) - 1)))
            out.append(data[index & ((1 << bpp) - 1)])
    return out


def decode(data: bytes, width: int, height: int, alpha: bool = False) -> np.ndarray:
    """The VP8L bitstream ``data`` (from its signature byte), whose header
    must give ``width`` x ``height``, as (height, width) uint32 ARGB; with
    ``alpha``, as libwebp decodes a lossless ALPH chunk's stream behind that
    header (``_image``)."""
    if len(data) < 5:
        raise ValueError("a VP8L bitstream under 5 bytes")
    br = _Bits(data)
    if br.read(8) != 0x2F:
        raise ValueError("no VP8L signature")
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha is used: a hint
    if br.read(3) != 0:
        raise ValueError("VP8L version bits that are not 0")
    if (w, h) != (width, height):
        raise ValueError(f"a {w}x{h} VP8L bitstream where {width}x{height} is expected")
    transforms = []
    px = _image(br, w, h, transforms, alpha)
    for t in reversed(transforms):
        px = _inverse(t, px)
    return np.array(px, np.uint32).reshape(height, width)
