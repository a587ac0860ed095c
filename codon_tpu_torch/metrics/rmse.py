"""Masked RMSE, host side: the reference's EvaluationResults semantics.

float64; ground truth cropped to the output's shape; pixels where GT == 0
(invalid depth) are left out of both the error sum and the pixel count.
"""
from __future__ import annotations

import numpy as np


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
