"""Masked RMSE: the reference's EvaluationResults semantics.

Pixels where GT == 0 (invalid depth) are left out of both the error sum and
the pixel count. `masked_rmse` runs on the host in float64, with the ground
truth cropped to the output's shape; `masked_rmse_torch` is its batched
counterpart on tensors, on the device they lie on.
"""
from __future__ import annotations

import numpy as np
import torch


def masked_rmse(label: np.ndarray, output: np.ndarray) -> float:
    """label/output: 2D arrays, [0, 255] domain (uint8 ok)."""
    label = np.asarray(label, np.float64)
    output = np.asarray(output, np.float64)
    label = label[: output.shape[0], : output.shape[1]]
    valid = label != 0
    err = np.where(valid, label - output, 0.0)
    count = int(valid.sum())
    if count == 0:
        raise ValueError("masked_rmse: label has no valid (nonzero) "
                         "pixels; a silent nan would corrupt the mean")
    return float(np.sqrt((err ** 2).sum() / count))


def masked_rmse_torch(label, output, mask=None) -> torch.Tensor:
    """Batched, on tensors: label/output (N, H, W) or (N, H, W, 1), float.

    `mask` (optional, same shape): validity of the padded region, AND-ed
    with the label != 0 rule, so padded batches give per-image-exact values.
    -> (N,) RMSE in the label's dtype (float32 on the card; float64 inputs
    on the CPU give the host function's values).
    """
    label = torch.as_tensor(label)
    output = torch.as_tensor(output).to(device=label.device,
                                        dtype=label.dtype)
    if label.dim() == 4:
        label, output = label[..., 0], output[..., 0]
        if mask is not None and mask.dim() == 4:
            mask = mask[..., 0]
    valid = label != 0
    if mask is not None:
        valid = valid & mask.to(label.device).bool()
    err = torch.where(valid, label - output, torch.zeros_like(label))
    count = valid.sum(dim=(1, 2))
    return torch.sqrt((err * err).sum(dim=(1, 2)) / count)
