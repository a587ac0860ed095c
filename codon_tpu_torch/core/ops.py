"""Masked-ops backend: the counterpart of `codon_tpu.core.ops.XlaOps`.

Layouts follow the JAX package: NHWC activations and HWIO kernels. A
contiguous NHWC tensor permuted to (N, C, H, W) is exactly a channels_last
NCHW tensor, so each conv hands cuDNN (through `F.conv2d`) a channels_last
input and an OIHW channels_last weight, and permutes the channels_last
result back to a contiguous NHWC tensor. Convs are stride 1, bias-free and
SAME-padded with odd kernels. A grouped conv (`groups` G, the merged-tower
forward's two towers in one tensor) takes an HWIO kernel (k, k, C/G, O)
with the output channels blocked by group, as `feature_group_count` in the
JAX package; it stays a cuDNN conv (`F.conv2d(groups=G)`).

With a validity mask (N, H, W, 1), every conv output is re-masked, so the
zero padding around each image of a padded mixed-size batch behaves like
SAME zero padding of the unpadded image: batched inference equals per-image
inference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO kernel -> OIHW kernel in channels_last memory (O, H, W, I)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                groups: int = 1) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC `x` with HWIO `w` (k, k, C/groups, O), in
    x.dtype -> NHWC."""
    k = w.shape[0]
    wt = hwio_to_oihw(w.to(x.dtype))
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, padding=k // 2, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


class TorchOps:
    """Convs and global pools with an optional (N, H, W, 1) validity mask.

    `name` identifies the conv site; float backends ignore it, as in the
    JAX package (a quantized backend keys per-site scales on it).
    """

    def conv2d(self, x, w, *, mask: Optional[torch.Tensor] = None,
               groups: int = 1, name=None):
        del name
        return self.apply_mask(conv2d_nhwc(x, w, groups), mask)

    @staticmethod
    def apply_mask(x, mask=None):
        return x if mask is None else x * mask.to(x.dtype)

    @staticmethod
    def global_avg(x, mask=None):
        """Mean over H, W -> (N, 1, 1, C); with a mask, over valid pixels."""
        if mask is None:
            return x.mean(dim=(1, 2), keepdim=True)
        m = mask.to(x.dtype)
        s = (x * m).sum(dim=(1, 2), keepdim=True)
        return s / m.sum(dim=(1, 2), keepdim=True)

    @staticmethod
    def global_max(x, mask=None):
        """Max over H, W -> (N, 1, 1, C); masked pixels count as -inf."""
        if mask is not None:
            x = x.masked_fill(mask == 0, float("-inf"))
        return x.amax(dim=(1, 2), keepdim=True)

    def precommit(self, x, name=None):
        """Stage-boundary handoff to conv site `name`: identity on floats."""
        del name
        return x

    def roundtrip(self, x, name=None):
        """Pass through site `name`'s storage grid: identity on floats."""
        del name
        return x


def check_nan(t: torch.Tensor, where: str) -> None:
    """Raise FloatingPointError if `t` holds a NaN (syncs the card)."""
    if bool(torch.isnan(t).any()):
        raise FloatingPointError(f"NaN in the output of {where}")


class NanCheckOps:
    """An Ops backend wrapped so that a NaN in any conv site's output
    raises FloatingPointError naming the site: the counterpart of JAX's
    `jax_debug_nans` for `cli eval --check-nans` (NaN only, as there).
    Everything else is the wrapped backend's (float, int8 static or
    dynamic). Each check copies one flag to the host, so it syncs the card
    at every conv."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        out = self.inner.conv2d(x, w, mask=mask, groups=groups, name=name)
        check_nan(out, f"conv site {name!r}")
        return out
