"""Image quality metrics: PSNR, SSIM, IE.

The reference scores with skimage's peak_signal_noise_ratio and
structural_similarity(multichannel=True, gaussian_weights=True)
(evaluate_interpolation_results.py:101-108). skimage is not in this image,
so SSIM is re-implemented to the same specification: per-channel SSIM with a
gaussian window (sigma=1.5, truncate=3.5 → 11x11), sample covariance
normalization N/(N-1), C1=(0.01·L)², C2=(0.03·L)², border crop of
(win_size-1)//2, averaged over channels. IE is the mean RMS pixel error.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def psnr(target: np.ndarray, pred: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio (uint8 images → data_range 255)."""
    t = target.astype(np.float64)
    p = pred.astype(np.float64)
    mse = np.mean((t - p) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _ssim_single(t: np.ndarray, p: np.ndarray, data_range: float) -> float:
    sigma, truncate = 1.5, 3.5
    win = 2 * int(truncate * sigma + 0.5) + 1  # 11
    np_pix = win * win
    cov_norm = np_pix / (np_pix - 1)  # sample covariance

    filt = lambda x: gaussian_filter(x, sigma=sigma, truncate=truncate)
    ux, uy = filt(t), filt(p)
    uxx, uyy, uxy = filt(t * t), filt(p * p), filt(t * p)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    a1 = 2 * ux * uy + C1
    a2 = 2 * vxy + C2
    b1 = ux * ux + uy * uy + C1
    b2 = vx + vy + C2
    s = (a1 * a2) / (b1 * b2)

    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def ssim(target: np.ndarray, pred: np.ndarray, data_range: float = 255.0) -> float:
    """Multichannel gaussian-weighted SSIM (skimage-compatible)."""
    t = target.astype(np.float64)
    p = pred.astype(np.float64)
    if t.ndim == 2:
        return _ssim_single(t, p, data_range)
    return float(np.mean([_ssim_single(t[..., c], p[..., c], data_range)
                          for c in range(t.shape[-1])]))


def interpolation_error(target: np.ndarray, pred: np.ndarray) -> float:
    """IE = mean over pixels of the RMS error across channels
    (evaluate_interpolation_results.py:106-108)."""
    d = target.astype(np.float64) - pred.astype(np.float64)
    return float(np.mean(np.sqrt(np.sum(d * d, axis=2))))


def score_image(target_u8: np.ndarray, pred_u8: np.ndarray):
    """(PSNR, SSIM, IE) for a pair of HWC uint8 images."""
    return (
        psnr(target_u8, pred_u8),
        ssim(target_u8, pred_u8),
        interpolation_error(target_u8, pred_u8),
    )
