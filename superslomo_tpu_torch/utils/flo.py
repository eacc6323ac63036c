"""Middlebury .flo files, flow end-point error and the flow colour coding: a
numpy copy of the JAX package's ``utils/flo.py``.

``read_flo`` / ``write_flo`` use the magic 202021.25; ``flow_epe`` and
``flow_error_percent`` (the >3 px share) skip pixels whose ground truth is
unknown (a component of 1e7 or more); ``flow_to_image`` is the 55-colour
Middlebury wheel, computed in float64 as the JAX module computes it.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25
UNKNOWN_FLOW_THRESH = 1e7


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file → (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(flow: np.ndarray, path: str) -> None:
    """Write (H, W, 2) float32 flow to .flo."""
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"a flow is (H, W, 2), got {flow.shape}")
    with open(path, "wb") as f:
        np.array([_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        np.ascontiguousarray(flow, dtype=np.float32).tofile(f)


def _valid_epe(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """The end-point error of each pixel whose ground truth is known."""
    valid = (np.abs(gt[..., 0]) < UNKNOWN_FLOW_THRESH) & (np.abs(gt[..., 1]) < UNKNOWN_FLOW_THRESH)
    d = gt - pred
    return np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)[valid]


def flow_epe(gt: np.ndarray, pred: np.ndarray) -> float:
    """Average end-point error over valid (non-unknown) pixels."""
    return float(_valid_epe(gt, pred).mean())


def flow_error_percent(gt: np.ndarray, pred: np.ndarray, thresh: float = 3.0) -> float:
    """Percentage of valid pixels with an end-point error above ``thresh``."""
    return float((_valid_epe(gt, pred) > thresh).mean() * 100.0)


def _make_color_wheel() -> np.ndarray:
    """The standard 55-colour Middlebury wheel (RY/YG/GC/CB/BM/MR segments)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, +1),  # red → yellow: G ramps up
        (YG, 1, 0, -1),  # yellow → green: R ramps down
        (GC, 1, 2, +1),  # green → cyan: B ramps up
        (CB, 2, 1, -1),  # cyan → blue: G ramps down
        (BM, 2, 0, +1),  # blue → magenta: R ramps up
        (MR, 0, 2, -1),  # magenta → red: B ramps down
    ]
    for n, base, ramp, sign in ramps:
        wheel[col : col + n, base] = 255
        r = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, ramp] = r if sign > 0 else 255 - r
        col += n
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 RGB Middlebury colour coding; the
    radius is scaled by ``max_flow``, or by the flow's largest radius."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    bad = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[bad] = 0
    v[bad] = 0

    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-9)
    u = u / maxrad
    v = v / maxrad
    rad = np.sqrt(u * u + v * v)

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # (-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)  # onto the wheel
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), dtype=np.uint8)
    inside = rad <= 1
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(inside, 1 - rad * (1 - col), col * 0.75)
        col[bad] = 0
        img[..., c] = np.floor(255 * col).astype(np.uint8)
    return img
