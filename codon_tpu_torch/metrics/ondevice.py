"""On-device evaluation: forward, uint8 truncation, masked RMSE and SSIM on
the card, with the per-image scalars and the uint8 output the only copies
back to the host.

The counterpart of `codon_tpu.metrics.ondevice`. The uint8 round trip
mirrors the reference's save-then-score flow, so the RMSE equals the host
metric on the written PNGs. The SSIM equals the host one for images that
fill the padded shape; on padded images the 6-pixel ring at the image's
border uses normalized-convolution statistics in place of the reflect
border (within 0.03 of the host value at Middlebury sizes, as the JAX
package documents and tests).
"""
from __future__ import annotations

import torch

from codon_tpu_torch.metrics.rmse import masked_rmse_torch
from codon_tpu_torch.metrics.ssim import ssim_exact_torch


def make_batch_evaluator(forward):
    """-> fn(params, depth, color, mask, label) -> {"rmse": (N,), "ssim":
    (N,), "out_u8": (N, H, W) uint8}, all on the inputs' device.

    forward: fn(params, depth, color, mask) -> (N, H, W, 1), the finished
    forward of `cli eval` (TTA and `--scale-cond` already wrapped in), so
    the metrics score exactly what eval writes.
    label: (N, H, W, 1) float in [0, 255]. mask=None takes both metrics'
    unmasked paths (an all-ones mask would send SSIM through the
    normalized-convolution branch).
    """
    @torch.no_grad()
    def evaluate(params, depth, color, mask, label):
        out = forward(params, depth, color, mask)
        # the reference's (clip(out, 0, 1) * 255).astype(uint8): truncation
        u8 = (out[..., 0].clamp(0.0, 1.0) * 255).to(torch.uint8)
        dq = u8.float()                           # what the PNG will hold
        lab = label[..., 0].float()
        m = mask[..., 0] if mask is not None else None
        rmse = masked_rmse_torch(lab, dq, m)
        ssim = ssim_exact_torch(lab / 255.0, dq / 255.0, mask=m)
        return {"rmse": rmse, "ssim": ssim, "out_u8": u8}

    return evaluate
