"""Gaussian-window SSIM with the reference's exact semantics.

scipy.ndimage.gaussian_filter, sigma 1.5, default truncate 4.0 (radius 6),
boundary mode 'reflect' (the edge sample duplicated), C1 = 0.01^2,
C2 = 0.03^2, mean over the whole SSIM map.

`ssim_exact` runs on the host with scipy, as does `ssim_block`, the
reference's other SSIM (4x4 blocks). `ssim_exact_torch` is `ssim_exact`'s
batched counterpart on tensors, on the device they lie on: a separable
13-tap blur whose border is scipy's 'reflect', which is numpy's
'symmetric' and not torch's 'reflect' (that one leaves the edge sample
out), so the padding is built from an index.
"""
from __future__ import annotations

import numpy as np
import torch
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


def ssim_block(img1, img2, C1: float = _C1, C2: float = _C2,
               block: int = 4) -> float:
    """The reference's 4x4 block SSIM (ssim_2.py:20-33), on the host in
    float64, the rows and columns past the last whole block left out.

    It keeps the reference's quirk of taking the block statistics as SUMS,
    not means: that is the shipped behavior."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    hb, wb = img1.shape[0] // block, img1.shape[1] // block
    b1 = img1[: hb * block, : wb * block].reshape(hb, block, wb, block)
    b1 = b1.transpose(0, 2, 1, 3)
    b2 = img2[: hb * block, : wb * block].reshape(hb, block, wb, block)
    b2 = b2.transpose(0, 2, 1, 3)
    s1 = b1.sum(axis=(-1, -2))
    s2 = b2.sum(axis=(-1, -2))
    ss = (b1 * b1).sum(axis=(-1, -2)) + (b2 * b2).sum(axis=(-1, -2))
    s12 = (b1 * b2).sum(axis=(-1, -2))
    vari = ss - s1 * s1 - s2 * s2
    covar = s12 - s1 * s2
    smap = (2 * s1 * s2 + C1) * (2 * covar + C2) / (
        (s1 * s1 + s2 * s2 + C1) * (vari + C2))
    return float(np.mean(smap))


def gaussian_kernel_1d(sd: float = 1.5, truncate: float = 4.0,
                       dtype=np.float64) -> np.ndarray:
    """scipy.ndimage's 1-D Gaussian: radius int(truncate * sd + 0.5),
    normalized to sum 1."""
    radius = int(truncate * sd + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sd) ** 2)
    return (k / k.sum()).astype(dtype)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of an axis of length n padded by r on each side, scipy
    'reflect' (numpy 'symmetric'): ... x1 x0 | x0 x1 ... x(n-1) | x(n-1) ...
    and again, for r > n, with period 2n."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable blur over the last two axes, scipy-'reflect' border; the
    taps are summed in order, in the image's dtype."""
    taps = kernel.shape[0]
    r = (taps - 1) // 2
    for axis in (-2, -1):
        n = img.shape[axis]
        x = img.index_select(axis, _symmetric_index(n, r, img.device))
        acc = kernel[0] * x.narrow(axis, 0, n)
        for t in range(1, taps):
            acc = acc + kernel[t] * x.narrow(axis, t, n)
        img = acc
    return img


def ssim_exact_torch(img1, img2, sd: float = 1.5, C1: float = _C1,
                     C2: float = _C2, mask=None) -> torch.Tensor:
    """Gaussian SSIM on tensors. img1/img2: (..., H, W) -> (...) means.

    Without `mask` it equals `ssim_exact` image by image (float64 inputs
    give its values to rounding; float32 is the card's working type). With
    `mask` (same shape, 1 = valid; for padded batches) the blurred
    statistics are normalized convolutions, blur(x * m) / blur(m) where
    blur(m) > 1e-6, in place of the reflect border a per-image run sees,
    and the mean is over valid pixels: as `codon_tpu`'s on-device SSIM.
    """
    img1 = torch.as_tensor(img1)
    img2 = torch.as_tensor(img2).to(device=img1.device, dtype=img1.dtype)
    kdt = np.float64 if img1.dtype == torch.float64 else np.float32
    kernel = torch.from_numpy(gaussian_kernel_1d(sd, dtype=kdt)).to(
        img1.device)
    if mask is None:
        def blur(t):
            return _blur(t, kernel)
    else:
        m = torch.as_tensor(mask).to(device=img1.device, dtype=img1.dtype)
        bm = _blur(m, kernel)
        inv_bm = torch.where(bm > 1e-6, 1.0 / bm, torch.zeros_like(bm))

        def blur(t):
            return _blur(t * m, kernel) * inv_bm

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu1_mu2
    num = (2 * mu1_mu2 + C1) * (2 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    smap = num / den
    if mask is None:
        return smap.mean(dim=(-2, -1))
    return (smap * m).sum(dim=(-2, -1)) / m.sum(dim=(-2, -1))
