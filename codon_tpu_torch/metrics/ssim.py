"""Gaussian-window SSIM on the host, with the reference's exact semantics.

scipy.ndimage.gaussian_filter, sigma 1.5, default truncate 4.0 (radius 6),
boundary mode 'reflect' (the edge sample duplicated), C1 = 0.01^2,
C2 = 0.03^2, mean over the whole SSIM map.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def ssim_exact(img1, img2, sd: float = 1.5, C1: float = _C1,
               C2: float = _C2) -> float:
    """img1/img2: 2D float arrays in [0, 1]."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mu1 = gaussian_filter(img1, sd)
    mu2 = gaussian_filter(img2, sd)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = gaussian_filter(img1 * img1, sd) - mu1_sq
    sigma2_sq = gaussian_filter(img2 * img2, sd) - mu2_sq
    sigma12 = gaussian_filter(img1 * img2, sd) - mu1_mu2
    num = (2 * mu1_mu2 + C1) * (2 * sigma12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    return float(np.mean(num / den))
