"""The plain Python twin of ``csrc/vp8_decode.cpp``'s ``vp8_decode``: the
lossy WebP (VP8 key frame) decode, step by step, from the bitstream to RGB
pixels, as libwebp computes it (vp8_dec.c, tree_dec.c, quant_dec.c,
frame_dec.c, dsp/dec.c, dsp/upsampling.c and dsp/yuv.h; the C++ file's
comment lists each rule). It is for the tests and ``chip_smoke.py``'s
checks, and runs on no path when the compiled library is present.
``decode(data, width, height)`` takes the VP8 data from its frame tag to the
end of what libwebp is given (``data/webp.py`` says where that ends) and
returns the (height, width, 3) uint8 RGB that libwebp's fancy upsampling
and fixed-point colour conversion make, or raises ValueError naming the
fault.

``edges``, ``luma4_work``, ``predict_luma4``, ``predict_16``,
``inverse_dct`` and ``inverse_wht`` are also what ``chip_smoke.py``'s VP8
writer reconstructs its frame with.
"""

from __future__ import annotations

import numpy as np


def _table(*hex_rows: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex("".join(hex_rows)), np.uint8)


ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # the band of each coefficient index (16: a sentinel)
DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64,
    66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185,
    189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))  # DCT_CAT3-6's extra bits
# libwebp's intra modes: the 16x16 and chroma modes are the 4x4 modes of the same number
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
# the default token probabilities [type][band][context][node], their update probabilities, and the
# key-frame 4x4 mode probabilities [above][left][node] in libwebp's mode order
COEFF_PROBA = _table(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ffe3d5ffdb808080"
    "6a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff8080808080"
    "b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff808080"
    "01ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e"
    "832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff80"
    "0181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff808080"
    "2c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe0808080"
    "0101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff80"
    "4911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080"
    "c933dbffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080"
    "f080ff80808080808080800186fcffff808080808080d53efaffff808080808080375dff80808080808080808080808080808080808080"
    "80808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd880"
    "0170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc0808080"
    "7b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff808080"
    "0179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080"
    "ee01ff8080808080808080").reshape(4, 8, 3, 11)
COEFF_UPDATE = _table(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcffffffffffffffff"
    "f9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffffffff"
    "effdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffff"
    "e1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeffffffffffffff"
    "fff8fefffffffffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffff"
    "fffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feffffffffffffff"
    "fbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefefffffffffffffffefeffffffffffffffff"
    "fefefefffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdffffffffffffff"
    "fffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdffffffffffffffff"
    "fcfdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffff"
    "fffffdfffffffffffffffffafffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffff").reshape(4, 8, 3, 11)
BMODES_PROBA = _table(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850c31a3e2c405590"
    "470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b504266"
    "a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e"
    "6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd7"
    "6f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01"
    "331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d"
    "499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff"
    "1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58685575af525f"
    "543559806471652d4b4f7b2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d"
    "100a558065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f1452"
    "87391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c53815279b3c"
    "8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033"
    "291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418").reshape(10, 10, 9)

_BMODES = BMODES_PROBA.tolist()


class _Bits:
    """libwebp's boolean decoder (VP8BitReader) over data[start:end], a byte
    loaded at a time: ``range`` holds the range less 1, ``bits`` the count of
    ``value``'s bits below the 8-bit window. A bit that needs a byte past
    ``end`` raises: libwebp marks its reader at the end there, which fails
    the decode at the partition's next check. An empty partition is marked
    at once (``empty``) and fails where it is checked."""

    __slots__ = ("data", "pos", "end", "value", "bits", "range", "empty")

    def __init__(self, data, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.range = 0, -8, 254
        self.empty = start >= end
        if self.empty:
            self.bits = 0
        else:
            self._load()

    def _load(self):
        if self.pos >= self.end:
            raise ValueError("the VP8 data ends too soon (truncated)")
        self.value = (self.value << 8) | self.data[self.pos]
        self.pos += 1
        self.bits += 8

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        rng, pos = self.range, self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.range = (rng << shift) - 1
        self.bits -= shift
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def check(self):
        if self.empty:
            raise ValueError("an empty VP8 partition (truncated)")


def dequant(q: int, deltas) -> tuple:
    """VP8ParseQuant's (Y1, Y2, UV) x (DC, AC) factors of quantiser index q
    and the deltas (Y1 DC, Y2 DC, Y2 AC, UV DC, UV AC): Y2 DC x 2, Y2 AC x
    155 / 100 at least 8, UV DC at most 132 (index 117)."""
    def clip(v, m=127):
        return min(max(v, 0), m)

    return ((DC_TABLE[clip(q + deltas[0])], AC_TABLE[clip(q)]),
            (DC_TABLE[clip(q + deltas[1])] * 2, max(AC_TABLE[clip(q + deltas[2])] * 101581 >> 16, 8)),
            (DC_TABLE[clip(q + deltas[3], 117)], AC_TABLE[clip(q + deltas[4])]))


def _int16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _large(br: _Bits, p) -> int:
    """GetLargeValue: a token of 2 or more, with its extra bits."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in CAT_PROBAS[cat]:
        v = 2 * v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bits, bands, ctx: int, dq, n: int, out: list, at: int) -> int:
    """GetCoeffs: one block's tokens from index ``n``, dequantised into
    out[at:at + 16] in raster order (an int16 store); returns the index after
    the last token read (the band probabilities ``bands[n]`` per index)."""
    p = bands[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n  # end of block
        while not br.bit(p[1]):  # a zero: the next token cannot end the block
            n += 1
            p = bands[n][0]
            if n == 16:
                return 16
        nxt = bands[n + 1]
        if not br.bit(p[2]):
            v, p = 1, nxt[1]
        else:
            v, p = _large(br, p), nxt[2]
        if br.bit(128):
            v = -v
        out[at + ZIGZAG[n]] = _int16(v * dq[n > 0])
        n += 1
    return 16


class _Macroblock:
    __slots__ = ("segment", "skip", "i4x4", "modes", "uv_mode", "coeffs", "inner")


def _parse_modes(br: _Bits, mb: _Macroblock, top: list, left: list, at: int, update_map, seg_probs, skip_p):
    """ParseIntraMode: the segment, skip flag, luma modes (16 sub-modes, a
    16x16 mode standing for its sub-mode in the contexts) and chroma mode."""
    if update_map:
        mb.segment = (2 + br.bit(seg_probs[2])) if br.bit(seg_probs[0]) else br.bit(seg_probs[1])
    else:
        mb.segment = 0
    mb.skip = br.bit(skip_p) if skip_p is not None else 0
    mb.i4x4 = not br.bit(145)
    if not mb.i4x4:
        if br.bit(156):
            mode = TM_PRED if br.bit(128) else H_PRED
        else:
            mode = V_PRED if br.bit(163) else DC_PRED
        mb.modes = [mode]
        top[at:at + 4] = [mode] * 4
        left[:] = [mode] * 4
    else:
        modes = []
        for y in range(4):
            mode = left[y]
            for x in range(4):
                p = _BMODES[top[at + x]][mode]
                if not br.bit(p[0]):
                    mode = B_DC
                elif not br.bit(p[1]):
                    mode = B_TM
                elif not br.bit(p[2]):
                    mode = B_VE
                elif not br.bit(p[3]):
                    mode = B_HE if not br.bit(p[4]) else (B_RD if not br.bit(p[5]) else B_VR)
                elif not br.bit(p[6]):
                    mode = B_LD
                elif not br.bit(p[7]):
                    mode = B_VL
                else:
                    mode = B_HD if not br.bit(p[8]) else B_HU
                top[at + x] = mode
            modes += top[at:at + 4]
            left[y] = mode
        mb.modes = modes
    if not br.bit(142):
        mb.uv_mode = DC_PRED
    elif not br.bit(114):
        mb.uv_mode = V_PRED
    else:
        mb.uv_mode = TM_PRED if br.bit(183) else H_PRED


def _residuals(br: _Bits, mb: _Macroblock, nz: list, nz_dc: list, mb_x: int, bands, q) -> bool:
    """ParseResiduals: the 24 blocks' coefficients (the Y2 block's inverse WHT
    into the 16 luma DCs) and the non-zero contexts above (``nz[mb_x]``) and
    to the left (``nz[-1]``); returns whether any block has a coefficient."""
    y1, y2, uv = q
    coeffs = [0] * 384
    non_zero = 0
    if not mb.i4x4:
        dc = [0] * 16
        ctx = nz_dc[mb_x] + nz_dc[-1]
        n = _coeffs(br, bands[1], ctx, y2, 0, dc, 0)
        nz_dc[mb_x] = nz_dc[-1] = int(n > 0)
        coeffs[0:384:16] = list(inverse_wht(dc)) + [0] * 8
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    tnz, lnz = nz[mb_x] & 0x0F, nz[-1] & 0x0F
    for y in range(4):
        left = lnz & 1
        for x in range(4):
            at = 64 * y + 16 * x
            n = _coeffs(br, ac, left + (tnz & 1), y1, first, coeffs, at)
            left = int(n > first)
            tnz = (tnz >> 1) | (left << 7)
            non_zero |= n > 1 or coeffs[at] != 0
        tnz >>= 4
        lnz = (lnz >> 1) | (left << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz, lnz = nz[mb_x] >> (4 + ch), nz[-1] >> (4 + ch)
        for y in range(2):
            left = lnz & 1
            for x in range(2):
                at = 256 + 32 * ch + 32 * y + 16 * x
                n = _coeffs(br, bands[2], left + (tnz & 1), uv, 0, coeffs, at)
                left = int(n > 0)
                tnz = (tnz >> 1) | (left << 3)
                non_zero |= n > 1 or coeffs[at] != 0
            tnz >>= 2
            lnz = (lnz >> 1) | (left << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    nz[mb_x], nz[-1] = out_t, out_l
    mb.coeffs = coeffs
    return bool(non_zero)


# --------------------------------------------------------------------------- #
# the inverse transforms and the intra predictors


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def inverse_dct(coeffs) -> np.ndarray:
    """TransformOne: (..., 16) coefficients in raster order → (..., 4, 4)
    int64, what is added to the prediction before the clamp (libwebp's DC-only
    and three-coefficient shortcuts give the same)."""
    c = np.asarray(coeffs, np.int64)
    c = c.reshape(*c.shape[:-1], 4, 4)
    a, b = c[..., 0, :] + c[..., 2, :], c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    d = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    t = np.stack([a + d, b + cc, b - cc, a - d], -2)  # the vertical pass: [..., row, column]
    dc = t[..., :, 0] + 4
    a, b = dc + t[..., :, 2], dc - t[..., :, 2]
    cc = _mul2(t[..., :, 1]) - _mul1(t[..., :, 3])
    d = _mul1(t[..., :, 1]) + _mul2(t[..., :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3


def inverse_wht(dc) -> np.ndarray:
    """TransformWHT: the Y2 block's 16 coefficients (raster order) → the DC
    of each of the 16 luma blocks (raster order), as int16 stores them."""
    i = np.asarray(dc, np.int64).reshape(4, 4)
    a0, a1, a2, a3 = i[0] + i[3], i[1] + i[2], i[1] - i[2], i[0] - i[3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])
    dc0 = t[:, 0] + 3
    a0, a1, a2, a3 = dc0 + t[:, 3], t[:, 1] + t[:, 2], t[:, 1] - t[:, 2], dc0 - t[:, 3]
    out = (np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], -1) >> 3).reshape(16)
    return ((out + 32768) & 0xFFFF) - 32768


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def predict_luma4(mode: int, top, left, corner: int) -> np.ndarray:
    """A 4x4 luma prediction (libwebp's ``*4_C``): ``top`` the 8 pixels above
    (the last 4 above and to the right), ``left`` the 4 to the left, ``corner``
    the one above and to the left; returns (4, 4) int64 rows."""
    A, B, C, D, E, F, G, H = (int(v) for v in top)
    I, J, K, L = (int(v) for v in left)
    X = int(corner)
    if mode == B_DC:
        return np.full((4, 4), (A + B + C + D + I + J + K + L + 4) >> 3, np.int64)
    if mode == B_TM:
        return np.clip(np.array([A, B, C, D])[None, :] + np.array([I, J, K, L])[:, None] - X, 0, 255)
    if mode == B_VE:
        return np.tile([_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)], (4, 1))
    if mode == B_HE:
        return np.repeat(np.array([_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)])[:, None], 4, 1)
    if mode == B_RD:
        e = (L, K, J, I, X, A, B, C, D)
        return np.array([[_avg3(*e[3 + x - y:6 + x - y]) for x in range(4)] for y in range(4)])
    if mode == B_LD:
        t = (A, B, C, D, E, F, G, H, H)
        return np.array([[_avg3(*t[x + y:x + y + 3]) for x in range(4)] for y in range(4)])
    if mode == B_VR:
        return np.array([[_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)],
                         [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)],
                         [_avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C)],
                         [_avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]])
    if mode == B_VL:
        return np.array([[_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)],
                         [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)],
                         [_avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G)],
                         [_avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]])
    if mode == B_HD:
        return np.array([[_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)],
                         [_avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A)],
                         [_avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X)],
                         [_avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]])
    # B_HU
    return np.array([[_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)],
                     [_avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L)],
                     [_avg2(K, L), _avg3(K, L, L), L, L],
                     [L, L, L, L]])


def predict_16(mode: int, top, left, corner: int, mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction (its size is ``len(top)``): DC
    with or without the top and left edges (none at the frame's top row and
    left column: 128), V, H, or TM with its clamp."""
    n = len(top)
    top, left = np.asarray(top, np.int64), np.asarray(left, np.int64)
    if mode == DC_PRED:
        shift = n.bit_length() - 1  # 4 for 16, 3 for 8
        if mb_x and mb_y:
            v = (int(top.sum() + left.sum()) + n) >> (shift + 1)
        elif mb_y:  # the left column: the top edge alone
            v = (int(top.sum()) + n // 2) >> shift
        elif mb_x:  # the top row: the left edge alone
            v = (int(left.sum()) + n // 2) >> shift
        else:
            v = 128
        return np.full((n, n), v, np.int64)
    if mode == TM_PRED:
        return np.clip(top[None, :] + left[:, None] - int(corner), 0, 255)
    if mode == V_PRED:
        return np.tile(top, (n, 1))
    return np.repeat(left[:, None], n, 1)  # H_PRED


def edges(plane, y0: int, x0: int, n: int, mb_x: int, mb_y: int):
    """(top, left, corner) of the n x n block at (y0, x0) of an unfiltered
    plane, with libwebp's borders: 127 above the frame's top row (the corner
    too), 129 left of its left column (the corner too below the top row)."""
    top = plane[y0 - 1, x0:x0 + n] if mb_y else np.full(n, 127)
    left = plane[y0:y0 + n, x0 - 1] if mb_x else np.full(n, 129)
    corner = 127 if not mb_y else 129 if not mb_x else plane[y0 - 1, x0 - 1]
    return top, left, int(corner)


def luma4_work(Y, mb_x: int, mb_y: int, mb_w: int) -> np.ndarray:
    """A B_PRED macroblock's 17 x 21 work area: row 0 its corner, the 16
    pixels above and the 4 above and to the right (from the next
    macroblock's row above; its pixel 15 at the right edge; 127 on the top
    row), column 0 the 16 to the left, rows 4, 8 and 12 carrying the
    top-right on for sub-block rows 1-3; the macroblock at [1:, 1:17]."""
    y0, x0 = 16 * mb_y, 16 * mb_x
    top, left, corner = edges(Y, y0, x0, 16, mb_x, mb_y)
    work = np.zeros((17, 21), np.int64)
    work[0, 0], work[0, 1:17], work[1:, 0] = corner, top, left
    if not mb_y:
        work[0, 17:] = 127
    elif mb_x == mb_w - 1:
        work[0, 17:] = Y[y0 - 1, x0 + 15]
    else:
        work[0, 17:] = Y[y0 - 1, x0 + 16:x0 + 20]
    work[4, 17:] = work[8, 17:] = work[12, 17:] = work[0, 17:]
    return work


def _reconstruct(mb: _Macroblock, Y, U, V, mb_x: int, mb_y: int, mb_w: int):
    """Predict the macroblock from the unfiltered planes around it and add
    its residuals, in place."""
    y0, x0 = 16 * mb_y, 16 * mb_x
    coeffs = np.array(mb.coeffs, np.int64).reshape(24, 16)
    if mb.i4x4:
        work = luma4_work(Y, mb_x, mb_y, mb_w)
        for k in range(16):
            by, bx = 4 * (k // 4), 4 * (k % 4)
            pred = predict_luma4(mb.modes[k], work[by, bx + 1:bx + 9], work[by + 1:by + 5, bx], work[by, bx])
            work[by + 1:by + 5, bx + 1:bx + 5] = np.clip(pred + inverse_dct(coeffs[k]), 0, 255)
        Y[y0:y0 + 16, x0:x0 + 16] = work[1:, 1:17]
    else:
        pred = predict_16(mb.modes[0], *edges(Y, y0, x0, 16, mb_x, mb_y), mb_x, mb_y)
        res = inverse_dct(coeffs[:16]).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + res, 0, 255)
    for plane, at in ((U, 16), (V, 20)):
        pred = predict_16(mb.uv_mode, *edges(plane, y0 // 2, x0 // 2, 8, mb_x, mb_y), mb_x, mb_y)
        res = inverse_dct(coeffs[at:at + 4]).reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
        plane[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.clip(pred + res, 0, 255)


# --------------------------------------------------------------------------- #
# the loop filter


def _edge(plane, y: int, x: int, n: int, vertical: bool) -> np.ndarray:
    """A writable (n, 8) view of the 4 pixels each side of an edge: across
    the vertical edge left of column x (rows y..y+n), or the horizontal edge
    above row y (columns x..x+n); columns p3 p2 p1 p0 q0 q1 q2 q3."""
    return plane[y:y + n, x - 4:x + 4] if vertical else plane[y - 4:y + 4, x:x + n].T


def _filter2(s, mask):
    """DoFilter2: p0 and q0, with the outer taps."""
    p1, p0, q0, q1 = (s[:, k] for k in (2, 3, 4, 5))
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    s[mask, 3] = np.clip(p0 + a2, 0, 255)[mask]
    s[mask, 4] = np.clip(q0 - a1, 0, 255)[mask]


def _simple(plane, y, x, vertical, thresh):
    """SimpleH/VFilter16: luma only, where 4|p0 - q0| + |p1 - q1| <= 2 thresh + 1."""
    view = _edge(plane, y, x, 16, vertical)
    s = view.astype(np.int64)
    _filter2(s, 4 * np.abs(s[:, 3] - s[:, 4]) + np.abs(s[:, 2] - s[:, 5]) <= 2 * thresh + 1)
    view[:] = s


def _complex(plane, y, x, n, vertical, thresh, ithresh, hev_thresh, macroblock_edge):
    """FilterLoop26 (a macroblock edge: 6 pixels) or FilterLoop24 (an inner
    edge: 4 pixels); DoFilter2 where the edge has high variance."""
    view = _edge(plane, y, x, n, vertical)
    s = view.astype(np.int64)
    p3, p2, p1, p0, q0, q1, q2, q3 = (s[:, k].copy() for k in range(8))
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        mask &= np.abs(a - b) <= ithresh
    hev = (np.abs(p1 - p0) > hev_thresh) | (np.abs(q1 - q0) > hev_thresh)
    _filter2(s, mask & hev)
    rest = mask & ~hev
    if macroblock_edge:
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = (p2 + a3, p1 + a2, p0 + a1, q0 - a1, q1 - a2, q2 - a3)
        cols = (1, 2, 3, 4, 5, 6)
    else:
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new = (p1 + a3, p0 + a2, q0 - a1, q1 - a3)
        cols = (2, 3, 4, 5)
    for k, v in zip(cols, new):
        s[rest, k] = np.clip(v, 0, 255)[rest]
    view[:] = s


def _filter_levels(filt, seg) -> dict:
    """(segment, B_PRED) → (limit, interior limit, hev threshold) of libwebp's
    PrecomputeFilterStrengths; limit 0 means no filtering."""
    level0, sharpness, ref_delta, mode_delta = filt
    use_segment, absolute, strength = seg
    out = {}
    for s in range(4):
        base = (strength[s] if absolute else strength[s] + level0) if use_segment else level0
        for i4x4 in (0, 1):
            level = base
            if ref_delta is not None:
                level += ref_delta[0] + (mode_delta[0] if i4x4 else 0)
            level = min(max(level, 0), 63)
            if level == 0:
                out[s, i4x4] = (0, 0, 0)
                continue
            ilevel = level
            if sharpness > 0:
                ilevel >>= 2 if sharpness > 4 else 1
                ilevel = min(ilevel, 9 - sharpness)
            ilevel = max(ilevel, 1)
            out[s, i4x4] = (2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0)
    return out


def _loop_filter(Y, U, V, mbs, simple: bool, levels: dict):
    """DoFilter on every macroblock in raster order: its left edge (not on the
    frame's left column), its inner vertical edges (a macroblock with
    coefficients, or B_PRED), its top edge (not on the top row), its inner
    horizontal edges; the simple filter touches luma only."""
    for (mb_y, mb_x), mb in mbs.items():
        limit, ilevel, hev = levels[mb.segment, int(mb.i4x4)]
        if limit == 0:
            continue
        y0, x0 = 16 * mb_y, 16 * mb_x
        for vertical, first in ((True, mb_x), (False, mb_y)):
            if simple:
                if first:
                    _simple(Y, y0, x0, vertical, limit + 4)
                if mb.inner:
                    for k in (4, 8, 12):
                        _simple(Y, y0 + (0 if vertical else k), x0 + (k if vertical else 0), vertical, limit)
                continue
            if first:
                _complex(Y, y0, x0, 16, vertical, limit + 4, ilevel, hev, True)
                for plane in (U, V):
                    _complex(plane, y0 // 2, x0 // 2, 8, vertical, limit + 4, ilevel, hev, True)
            if mb.inner:
                for k in (4, 8, 12):
                    _complex(Y, y0 + (0 if vertical else k), x0 + (k if vertical else 0), 16, vertical, limit,
                             ilevel, hev, False)
                for plane in (U, V):
                    _complex(plane, y0 // 2 + (0 if vertical else 4), x0 // 2 + (4 if vertical else 0), 8, vertical,
                             limit, ilevel, hev, False)


# --------------------------------------------------------------------------- #
# the output: fancy upsampling and the colour conversion


def upsample(chroma: np.ndarray, H: int, W: int) -> np.ndarray:
    """libwebp's fancy upsampler: the (H+1)//2 x (W+1)//2 chroma plane to H x
    W. Row 0 weighs chroma row 0 alone; rows 2k-1 and 2k weigh rows k-1 and k
    (3:1 towards the nearer), the last row of an even height the last chroma
    row alone; along a row the two-step average (diagonals, then the nearer
    sample), the first and the even width's last pixel 3:1 between rows."""
    ch, cw = chroma.shape
    c = chroma.astype(np.int64)
    r = np.arange(H)
    k = (r + 1) // 2
    top_part = (r % 2 == 1) | (r == 0)
    a, b = np.maximum(k - 1, 0), np.minimum(k, ch - 1)
    near, far = np.where(top_part, a, b), np.where(top_part, b, a)
    N, F = c[near], c[far]
    out = np.empty((H, W), np.int64)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (W - 1) >> 1
    if pairs:
        n0, n1, f0, f1 = N[:, :pairs], N[:, 1:pairs + 1], F[:, :pairs], F[:, 1:pairs + 1]
        s = n0 + n1 + f0 + f1 + 8
        out[:, 1:2 * pairs:2] = (((s + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (((s + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if W % 2 == 0:
        out[:, W - 1] = (3 * N[:, cw - 1] + F[:, cw - 1] + 2) >> 2
    return out


def _mulhi(v, coeff):
    return (v * coeff) >> 8


def yuv_to_rgb(Y, U, V) -> np.ndarray:
    """VP8YUVToR/G/B: 14-bit constants, products shifted to 6 fractional bits
    and clamped (H, W) planes → (H, W, 3) uint8 RGB."""
    y, u, v = (np.asarray(p, np.int64) for p in (Y, U, V))
    yy = _mulhi(y, 19077)
    rgb = (yy + _mulhi(v, 26149) - 14234, yy - _mulhi(u, 6419) - _mulhi(v, 13320) + 8708,
           yy + _mulhi(u, 33050) - 17685)
    return np.stack([np.clip(c >> 6, 0, 255) for c in rgb], -1).astype(np.uint8)


# --------------------------------------------------------------------------- #
# the frame


def frame_header(data) -> tuple:
    """(key frame, version, shown, first partition size, width, height) of the
    frame tag and key-frame header at data[:10]."""
    bits = data[0] | data[1] << 8 | data[2] << 16
    w, h = data[6] | data[7] << 8, data[8] | data[9] << 8
    return not bits & 1, (bits >> 1) & 7, (bits >> 4) & 1, bits >> 5, w & 0x3FFF, h & 0x3FFF


def decode(data, width: int, height: int) -> np.ndarray:
    """The VP8 key frame ``data`` (from its frame tag to the end of what
    libwebp is given) as (height, width, 3) uint8 RGB; raises ValueError
    naming the fault."""
    n = len(data)
    if n < 10:
        raise ValueError("a VP8 frame header cut short (truncated)")
    key, version, shown, first, w, h = frame_header(data)
    if not key or version > 3 or not shown or data[3:6] != b"\x9d\x01\x2a" or (w, h) != (width, height) or not w * h:
        raise ValueError("a VP8 frame header that libwebp refuses")
    if 10 + first > n:
        raise ValueError("a VP8 first partition past the data (truncated)")
    br = _Bits(data, 10, 10 + first)
    br.literal(2)  # colour space and clamping type: ignored
    use_segment, update_map, absolute = br.bit(128), 0, 1
    quant, strength, seg_probs = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.bit(128)
        if br.bit(128):
            absolute = br.bit(128)
            quant = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            strength = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    br.check()
    simple, level, sharpness = br.bit(128), br.literal(6), br.literal(3)
    ref_delta = mode_delta = None
    if br.bit(128):  # loop-filter deltas
        ref_delta, mode_delta = [0] * 4, [0] * 4
        if br.bit(128):
            for deltas in (ref_delta, mode_delta):
                for i in range(4):
                    if br.bit(128):
                        deltas[i] = br.signed(6)
    # the token partitions: 3-byte sizes, each clamped to what is left; the last takes the rest and is not empty
    last = (1 << br.literal(2)) - 1
    start = 10 + first
    if n - start < 3 * last:
        raise ValueError("VP8 partition sizes past the data (truncated)")
    at, left, parts = start + 3 * last, n - start - 3 * last, []
    for p in range(last):
        size = min(int.from_bytes(data[start + 3 * p:start + 3 * p + 3], "little"), left)
        parts.append(_Bits(data, at, at + size))
        at, left = at + size, left - size
    if at >= n:
        raise ValueError("an empty last VP8 partition (truncated)")
    parts.append(_Bits(data, at, n))
    base = br.literal(7)
    deltas = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]  # Y1 DC, Y2 DC, Y2 AC, UV DC, UV AC
    dqm = [dequant((quant[s] if absolute else quant[s] + base) if use_segment else base, deltas) for s in range(4)]
    br.bit(128)  # refresh entropy probabilities: ignored
    proba = [[[[br.literal(8) if br.bit(int(COEFF_UPDATE[t, b, c, p])) else int(COEFF_PROBA[t, b, c, p])
                for p in range(11)] for c in range(3)] for b in range(8)] for t in range(4)]
    bands = [[proba[t][BANDS[i]] for i in range(17)] for t in range(4)]
    skip_p = br.literal(8) if br.bit(128) else None

    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    intra_t, nz, nz_dc = [B_DC] * (4 * mb_w), [0] * (mb_w + 1), [0] * (mb_w + 1)  # [-1]: the left context
    mbs = {}
    for mb_y in range(mb_h):
        intra_l = [B_DC] * 4
        row = []
        for mb_x in range(mb_w):
            mb = _Macroblock()
            _parse_modes(br, mb, intra_t, intra_l, 4 * mb_x, update_map, seg_probs, skip_p)
            row.append(mb)
        tokens = parts[mb_y & last]
        nz[-1] = nz_dc[-1] = 0
        for mb_x, mb in enumerate(row):
            if not mb.skip:
                coded = _residuals(tokens, mb, nz, nz_dc, mb_x, bands, dqm[mb.segment])
            else:
                nz[mb_x] = nz[-1] = 0
                if not mb.i4x4:
                    nz_dc[mb_x] = nz_dc[-1] = 0
                mb.coeffs, coded = [0] * 384, False
            tokens.check()
            mb.inner = mb.i4x4 or coded
            mbs[mb_y, mb_x] = mb
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.int64)
    U, V = (np.zeros((8 * mb_h, 8 * mb_w), np.int64) for _ in range(2))
    for (mb_y, mb_x), mb in mbs.items():
        _reconstruct(mb, Y, U, V, mb_x, mb_y, mb_w)
    if level:
        levels = _filter_levels((level, sharpness, ref_delta, mode_delta), (use_segment, absolute, strength))
        _loop_filter(Y, U, V, mbs, bool(simple), levels)
    ch, cw = (height + 1) // 2, (width + 1) // 2
    return yuv_to_rgb(Y[:height, :width], upsample(U[:ch, :cw], height, width), upsample(V[:ch, :cw], height, width))
