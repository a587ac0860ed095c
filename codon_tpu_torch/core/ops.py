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

from codon_tpu_torch.kernels import cac as _cac


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO kernel -> OIHW kernel in channels_last memory (O, H, W, I); a
    single-output kernel (O = 1, the head conv) in standard memory instead,
    because PyTorch's CPU conv backward at batch 1 refuses a channels_last
    weight of one output channel ("slow_conv2d: grad_weight must be
    contiguous"). cuDNN takes either: with a channels_last input it lays the
    weight out channels_last itself."""
    oihw = w.permute(3, 2, 0, 1)
    if w.shape[3] == 1:
        return oihw.contiguous()
    return oihw.contiguous(memory_format=torch.channels_last)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, groups: int = 1,
                halo: int = 0) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC `x` with HWIO `w` (k, k, C/groups, O), in
    x.dtype -> NHWC.

    halo: rows of x above and below that belong to the neighbouring shards
    of a spatially sharded image (0 <= halo <= k // 2): the conv pads H with
    k // 2 - halo zero rows instead of k // 2, so the output has H - 2 * halo
    rows; W stays SAME."""
    k = w.shape[0]
    wt = hwio_to_oihw(w.to(x.dtype))
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, padding=(k // 2 - halo, k // 2),
                 groups=groups)
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

    @staticmethod
    def global_sum(x, mask=None):
        """Sum over H, W -> (N, 1, 1, C); with a mask, over valid pixels."""
        if mask is not None:
            x = x * mask.to(x.dtype)
        return x.sum(dim=(1, 2), keepdim=True)

    def cac_stage(self, out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w,
                  mask=None, dst=None):
        """One CAC stage through the three CUDA kernels (their plain versions
        on CPU tensors), pooled over the whole image this process holds:
        `kernels.cac.cac_stage`, or under autograd `CacStageFunction` (no
        `dst` there). A spatially sharded backend pools over every shard
        instead (`parallel.ops.ShardedOps.cac_stage`: the same kernels,
        the statistics reduced over its sp group): the model routes its
        kernel stage through its Ops backend so that a sharded forward never
        reaches this one."""
        args = (out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w)
        if torch.is_grad_enabled():
            if dst is not None:
                raise ValueError("the training stage returns fresh towers; "
                                 "dst is an eval-only form")
            return _cac.CacStageFunction.apply(*args, mask)
        return _cac.cac_stage(*args, mask, dst)

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
