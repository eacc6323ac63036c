"""A msgpack codec for the JAX package's native checkpoints, with no
``msgpack`` package: the subset that flax's ``serialization.to_bytes`` and
``msgpack_restore`` use.

Types: nil, bool, int and uint of every width, float32 / float64, str, bin,
array and map (fix, 8, 16 and 32 forms), and flax's extension types 1
(ndarray) and 3 (numpy scalar), each a msgpack ``(shape, dtype name,
C-order bytes)``. Any other type code raises, naming it. ``unpackb`` also
joins flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape":
..., "chunks": ...}``, written for arrays over 2**30 bytes).

Arrays decode as numpy arrays over the input's buffer (read-only, no copy),
and ``bfloat16`` ones, which numpy lacks, as torch tensors of the same bits.
``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes with
flax's ndarray hook: each value in its shortest form, maps in their order,
numpy arrays as extension type 1, numpy scalars as 3.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# first byte → (payload length bytes, big-endian format) of the sized forms
_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_INT = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """Recursive-descent decoder over a memoryview; ``bin`` values come
    back as memoryview slices when ``views`` is set (an ndarray's bytes)."""

    def __init__(self, buf, views=False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.views = views

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated input ({n} bytes wanted at offset {self.pos})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _length(self, nbytes: int) -> int:
        return self._unpack(_LEN[nbytes])

    def value(self):
        code = self._take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self._array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return self._str(code & 0x1F)
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _UINT:
            return self._unpack(_UINT[code])
        if code in _INT:
            return self._unpack(_INT[code])
        if code == 0xCA:
            return self._unpack(">f")
        if code == 0xCB:
            return self._unpack(">d")
        if code in _STR:
            return self._str(self._length(_STR[code]))
        if code in _BIN:
            data = self._take(self._length(_BIN[code]))
            return data if self.views else bytes(data)
        if code in _ARRAY:
            return self._array(self._length(_ARRAY[code]))
        if code in _MAP:
            return self._map(self._length(_MAP[code]))
        if code in _FIXEXT:
            return self._ext(_FIXEXT[code])
        if code in _EXT:
            return self._ext(self._length(_EXT[code]))
        raise ValueError(f"msgpack: unsupported type code 0x{code:02x} at offset {self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, n: int):
        kind = self._unpack(">b")
        data = self._take(n)
        if kind == EXT_NDARRAY:
            return _ndarray(data)
        if kind == EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"msgpack: unsupported extension type {kind} (flax writes 1, ndarray, and 3, numpy scalar)")


def _ndarray(payload: memoryview):
    """flax's ndarray payload: a msgpack ``(shape, dtype name, bytes)``."""
    shape, name, data = _Reader(payload, views=True).value()
    if name == "bfloat16":  # numpy has no bfloat16: the same bits as a torch tensor
        bits = np.frombuffer(data, dtype="<u2").copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(node: dict):
    """flax's chunked array: its flattened chunks joined and reshaped."""
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)


def unpackb(data):
    """Decode one msgpack object from ``data`` (bytes, bytearray or a
    memoryview); trailing bytes raise."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return out


# --------------------------------------------------------------------------- #
def _sized(out: list, nbytes: int, fix_base: int, fix_max: int, codes: tuple) -> None:
    """The header of a str / array / map of ``nbytes`` items: the fix form
    when it fits, else the 8- (when ``codes`` has one), 16- or 32-bit form."""
    if nbytes <= fix_max:
        out.append(bytes([fix_base | nbytes]))
        return
    for code, width in codes:
        if nbytes < 1 << (8 * width):
            out.append(bytes([code]) + nbytes.to_bytes(width, "big"))
            return
    raise ValueError(f"msgpack: {nbytes} items or bytes do not fit a 32-bit length")


def _int(out: list, x: int) -> None:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x >= 0:
        for code, fmt in _UINT.items():
            if x < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"msgpack: {x} does not fit 64 bits")
    else:
        for code, fmt in _INT.items():
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"msgpack: {x} does not fit 64 bits")


def _bin(out: list, data) -> None:
    _sized(out, len(data), 0, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
    out.append(data)


def _ext(out: list, kind: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(bytes([fix[n], kind]))
    else:
        _sized(out, n, 0, -1, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
        out.append(bytes([kind]))
    out.append(payload)


def _array_payload(shape, name: str, data) -> bytes:
    """flax's ndarray payload: ``packb((shape, dtype name, bytes))``."""
    out: list = [b"\x93"]  # an array of 3
    _pack(out, list(shape))
    _pack(out, name)
    _bin(out, data)
    return b"".join(out)


def _pack(out: list, obj) -> None:
    if isinstance(obj, np.generic):  # before float: np.float64 is a float
        arr = np.asarray(obj)
        _ext(out, EXT_NPSCALAR, _array_payload(arr.shape, arr.dtype.name, arr.tobytes("C")))
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _bin(out, bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 15, ((0xDC, 2), (0xDD, 4)))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 15, ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _ext(out, EXT_NDARRAY, _array_payload(obj.shape, obj.dtype.name, obj.tobytes("C")))
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (None, bool, int, float, str, bytes, list / tuple,
    dict, numpy array or scalar); other types raise."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)
