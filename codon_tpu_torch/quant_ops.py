"""Quantized Ops backends: real int8 convs with static per-channel or
dynamic per-sample activation scales, the calibration backend that records
the static scales, and the two fake-quant backends that train for them.

The counterpart of `codon_tpu.quant_ops` but its sharded twins (those
are `parallel.quant`'s), with the same arithmetic op for op, so that
the same inputs give the same int8 codes and, in float32, the same bits:

  Int8Ops         dynamic scales: each conv quantizes its input on a
                  per-image grid, absmax / 127 over the image's H, W, C
                  (computed in the activation dtype, then float32), and its
                  weights per output channel.
  Int8StaticOps   static per-input-channel scales from a calibrated
                  checkpoint (`act_scales/*`), folded exactly into the
                  weights: sum_c x_c w_co == sum_c (x_c / s_c)(s_c w_co).
                  Sites without a scale fall back to the dynamic grid. Its
                  handoffs `precommit` (a stage-boundary tensor stored as
                  int8 on the consuming site's grid) and `roundtrip` (the
                  stem, gate and conv7 outputs passed through their grid)
                  are active where the checkpoint calibrated the site.
  CalibrationOps  the float backend that records each site's per-channel
                  absmax; `calibrate_act_scales` turns them into scales.
  FakeQuantOps    QAT for Int8Ops: a float conv of int8-rounded weights
                  and activations on the dynamic grids, straight-through
                  gradients.
  FakeQuantStaticOps  QAT for Int8StaticOps: activations on the frozen
                  per-channel grid (the gradient zero where the grid
                  clips), weights on the folded grid sw_o / s_c, and the
                  handoff sites `roundtrip` through their grid.

Convs with at most 2 input or output channels (the stems' first layers,
the head, the CAC spatial gate) stay float in every backend. Every
quantized conv runs `kernels.quant.int8_conv`: the quantize-gather and the
dequant epilogue as CUDA kernels on the card, the int8 GEMM in cuBLASLt;
the handoffs quantize with the same quantize kernel. The folded int8
weights are made anew at every call, as in JAX. The fake-quant backends
run float convs (cuDNN through `F.conv2d`) and need no kernel. Grouped convs (`groups`,
the merged-tower forward's) quantize their whole input on the concatenated
scale of their compound site ("conv3+conv6") and run group by group.
"""
from __future__ import annotations

import numpy as np
import torch

from codon_tpu_torch.core.ops import TorchOps
from codon_tpu_torch.kernels.quant import int8_conv, quantize_plain

# Ops.roundtrip (elementwise-consumer handoff) site names
HANDOFF_SITES = ("gate_d", "gate_c", "stem_d", "stem_c", "fuse_r")

# Grouped convs of the merged-tower forward carry compound site names, one
# standard site per group ("conv3+conv6"); packed-cell checkpoints
# calibrate the merged sites packed_d/packed_c/packed_f, and the alias map
# routes a standard name to the packed site that saw the same input.
_SITE_ALIASES = {"conv1": "packed_d", "conv2": "packed_d",
                 "conv4": "packed_c", "conv5": "packed_c",
                 "conv8": "packed_f", "conv9": "packed_f"}


def _skip_quant(w) -> bool:
    return w.shape[2] <= 2 or w.shape[3] <= 2


def _w_scales(w):
    """Per-output-channel weight scale, (C_out,), in w's dtype."""
    return torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-8) / 127.0


def _x_scale(x):
    """Per-sample dynamic activation scale, (N, 1, 1, 1), in x's dtype."""
    return torch.clamp_min(x.abs().amax(dim=(1, 2, 3), keepdim=True),
                           1e-8) / 127.0


def _lookup_site(act_scales, name):
    sc = act_scales.get(name)
    if sc is not None:
        return sc
    alias = _SITE_ALIASES.get(name)
    return act_scales.get(alias) if alias else None


def _site_scale(act_scales, name, groups):
    """(C_in,) static scale for a conv site, or None (dynamic fallback).

    Direct keys win; otherwise a compound "a+b" name with one part per
    group resolves to the concat of the parts' scales.
    """
    if name is None:
        return None
    direct = act_scales.get(name)
    if direct is not None:
        return direct
    parts = name.split("+")
    if len(parts) == 1:
        return _lookup_site(act_scales, name) if groups == 1 else None
    if len(parts) != max(groups, 1):
        return None
    scs = [_lookup_site(act_scales, p) for p in parts]
    if any(s is None for s in scs):
        return None
    return torch.cat([torch.as_tensor(s, dtype=torch.float32) for s in scs])


def _scale_per_kernel_input(sc, groups, cg, co):
    """Map (C_in,) global act scales onto the (kh,kw,cg,co) kernel layout:
    in a grouped conv, output channel o belongs to group g = o // (co /
    groups), and its kernel input channel i reads global channel g*cg + i."""
    if groups == 1:
        return sc[None, None, :, None]
    scg = sc.reshape(groups, cg)                             # (G, cg)
    per_o = torch.repeat_interleave(scg, co // groups, dim=0)  # (co, cg)
    return per_o.t()[None, None]                             # (1,1,cg,co)


def _fold_weights(w, sc, groups=1):
    """Fold per-input-channel act scales into w -> (w8 int8 HWIO, sw
    (C_out,) float32)."""
    wf = w.float() * _scale_per_kernel_input(sc, groups, w.shape[2],
                                             w.shape[3])
    sw = _w_scales(wf)
    return quantize_plain(wf, sw), sw


def quantize_static(x, sc):
    """Per-channel int8 quantization of an NHWC x on the static grid sc
    (C,): `quant_im2col` at k = 1 through the custom op
    `codon::quant_im2col`, whose patches are x's codes pixel by pixel (the
    quantize kernel on the card, its plain version on the CPU)."""
    return torch.ops.codon.quant_im2col(x.contiguous(), 1, sc, None, 0,
                                        None).view(x.shape)


def _int8_conv(x, w, *, mask, sx, impl, groups=1, halo=0):
    """Dynamic-scale int8 conv: sx (N,1,1,1) float32; weights quantized per
    output channel; the output in x's dtype (float32 for a non-float x).
    halo: x's rows from the sp neighbours (`kernels.quant.int8_conv`)."""
    out_dt = x.dtype if x.is_floating_point() else torch.float32
    sw = _w_scales(w).float()
    w8 = quantize_plain(w, sw)
    return int8_conv(x, w8, sw, out_dt, sx=sx, mask=mask, impl=impl,
                     groups=groups, halo=halo)


def _check_impl(quant_impl):
    if quant_impl not in (None, "plain"):
        raise ValueError(f"quant_impl must be None or 'plain', got "
                         f"{quant_impl!r}")
    return quant_impl


class Int8Ops(TorchOps):
    """Int8 convs with dynamic per-sample scales.

    quant_impl: None runs the quant kernels on the card (their plain
    versions on CPU tensors); "plain" runs the plain versions on any
    device (the handoffs' quantize too, in `Int8StaticOps`), the card's
    reference.
    """

    def __init__(self, quant_impl=None):
        self.quant_impl = _check_impl(quant_impl)

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        return _int8_conv(x, w, mask=mask, sx=_x_scale(x).float(),
                          impl=self.quant_impl, groups=groups)


class _StaticHandoffMixin:
    """precommit / roundtrip of the static-scale backend."""

    def _scale(self, name, x, groups=1):
        sc = _site_scale(self.act_scales, name, groups)
        return None if sc is None else sc.to(x.device)

    def _quantize(self, x, sc):
        return (quantize_plain(x, sc) if self.quant_impl == "plain"
                else quantize_static(x, sc))

    def precommit(self, x, name=None):
        """Stage-boundary handoff: the tensor as int8 on the consuming
        site's grid (the conv would quantize with the same scale, so the
        result is the same bits). Idempotent on int8 input."""
        sc = self._scale(name, x)
        if sc is None or x.dtype == torch.int8:
            return x
        return self._quantize(x, sc)

    def roundtrip(self, x, name=None):
        """Elementwise-consumer handoff (CAC gate inputs, stem and conv7
        outputs): the tensor through its site's int8 grid, float in and
        float out. An identity where the site is not calibrated."""
        if x.dtype == torch.int8:
            raise ValueError(
                f"roundtrip({name!r}): int8 input — roundtrip sites are "
                f"float-in/float-out; an int8 tensor here means a "
                f"precommit was misrouted to an elementwise consumer")
        sc = self._scale(name, x)
        if sc is None:
            return x
        q = self._quantize(x, sc)
        return (q.float() * sc).to(x.dtype)


class Int8StaticOps(_StaticHandoffMixin, TorchOps):
    """Int8 convs with static per-channel scales.

    act_scales: {site: (C_in,) float32} (arrays or tensors) from
    `calibrate_act_scales` or a checkpoint's `act_scales/*`. Sites without
    a scale fall back to the dynamic grid. compute_dtype: the float dtype
    of a conv's output when its input arrives as int8 (precommitted).
    quant_impl as in `Int8Ops`.
    """

    def __init__(self, act_scales, compute_dtype=torch.float32,
                 quant_impl=None):
        self.act_scales = {k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in act_scales.items()}
        self.compute_dtype = compute_dtype
        self.quant_impl = _check_impl(quant_impl)

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        sc = self._scale(name, x, groups)
        if sc is None:
            if x.dtype == torch.int8:
                raise ValueError(
                    f"pre-quantized input at uncalibrated site {name!r}")
            return _int8_conv(x, w, mask=mask, sx=_x_scale(x).float(),
                              impl=self.quant_impl, groups=groups)
        if x.dtype == torch.int8:
            out_dt, xs = self.compute_dtype, None
        else:
            out_dt = (x.dtype if x.is_floating_point()
                      else self.compute_dtype)
            xs = sc
        w8, sw = _fold_weights(w, sc, groups)
        return int8_conv(x, w8, sw, out_dt, sc=xs, mask=mask,
                         impl=self.quant_impl, groups=groups)


class CalibrationOps(TorchOps):
    """Float backend that records per-input-channel absmax per site.

    `absmax`: {site: (C,) float32}, the max over every call. Padded
    batches are safe: zero padding never raises an absmax. A grouped site
    records under its compound name, over all C input channels.
    """

    def __init__(self):
        self.absmax = {}

    def _record(self, name, x):
        am = x.float().abs().amax(dim=(0, 1, 2))
        prev = self.absmax.get(name)
        self.absmax[name] = am if prev is None else torch.maximum(prev, am)

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if name is not None and not _skip_quant(w):
            self._record(name, x)
        return super().conv2d(x, w, mask=mask, groups=groups, name=name)

    def roundtrip(self, x, name=None):
        """Record the handoff site too, so calibrations ship its grid."""
        if name is not None:
            self._record(name, x)
        return x


def calibrate_act_scales(forward, params, batches):
    """Per-site per-channel static scales from full-frame forwards.

    forward(params, depth, color, ops=..., mask=...): a variant forward.
    batches: iterable of (depth, color, mask_or_None) tensors.
    Returns {site: (C_in,) float32 numpy} with scale = absmax / 127.
    """
    acc: dict = {}
    for depth, color, m in batches:
        ops = CalibrationOps()
        forward(params, depth, color, ops=ops, mask=m)
        for k, v in ops.absmax.items():
            v = v.cpu().numpy()
            acc[k] = v if k not in acc else np.maximum(acc[k], v)
    return {k: (np.maximum(v, 1e-8) / 127.0).astype(np.float32)
            for k, v in acc.items()}


# ---------------------------------------------------------------------------
# fake-quant backends for quantization-aware training
# ---------------------------------------------------------------------------

def _fq(t, s, clipped_ste=False):
    """Fake-quantize t on grid s (float32, broadcastable) with
    straight-through gradients: t + (q - t).detach(), which is q in value
    and the identity in gradient. The quotient is taken in float32 and
    rounded half to even, as the int8 convs do.

    clipped_ste: the gradient is zero where the grid clips (|t| > 127 s),
    and the value there q, as JAX's where(inside, ste, stop_gradient(q)).
    """
    q = (torch.clamp(torch.round(t.float() / s), -127, 127) * s).to(t.dtype)
    ste = t + (q - t).detach()
    if not clipped_ste:
        return ste
    inside = t.float().abs() <= 127.0 * s
    return torch.where(inside, ste, q.detach())


class FakeQuantOps(TorchOps):
    """QAT backend: a float conv of int8-rounded values, STE gradients.

    Activations on the per-sample dynamic grid (`_x_scale`), weights per
    output channel (`_w_scales`); the tiny convs stay float.
    """

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        xq = _fq(x, _x_scale(x).float())
        wq = _fq(w, _w_scales(w)[None, None, None, :].float())
        return super().conv2d(xq, wq, mask=mask, groups=groups, name=name)


class _StaticFakeQuantMixin:
    """Frozen-grid fake-quant: the roundtrip handoff and a conv site's
    (x, w) pair."""

    def _scale(self, name, x, groups=1):
        sc = _site_scale(self.act_scales, name, groups)
        return None if sc is None else sc.to(x.device)

    def roundtrip(self, x, name=None):
        """The QAT model of `Int8StaticOps.roundtrip`: fake-quant on the
        site's frozen grid, the identity where it is not calibrated. Plain
        STE here, as in JAX (whose clipped form gave NaN gradients there
        when the handoff fed the CAC max pools)."""
        sc = self._scale(name, x)
        if sc is None:
            return x
        return _fq(x, sc)

    def _fq_site(self, x, w, sc, groups=1, x_scale=None):
        """(xq, wq) of one conv site: on the frozen grid sc with clipped
        STE for the activations and the folded grid for the weights, or
        on the dynamic grids where the site has no scale. x_scale replaces
        the dynamic activation scale there (the sharded twin passes the
        scale gathered over the sp group, so tiled equals untiled)."""
        if sc is None:
            if x_scale is None:
                x_scale = _x_scale(x).float()
            return (_fq(x, x_scale),
                    _fq(w, _w_scales(w)[None, None, None, :]))
        sk = _scale_per_kernel_input(sc, groups, w.shape[2], w.shape[3])
        sw = _w_scales(w.float() * sk)
        return (_fq(x, sc, clipped_ste=True),
                _fq(w, sw[None, None, None, :] / sk))


class FakeQuantStaticOps(_StaticFakeQuantMixin, TorchOps):
    """QAT backend for the static grid: `Int8StaticOps` simulated in float.

    act_scales: {site: (C_in,) float32} (arrays or tensors), frozen.
    """

    def __init__(self, act_scales):
        self.act_scales = {k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in act_scales.items()}

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        xq, wq = self._fq_site(x, w, self._scale(name, x, groups), groups)
        return super().conv2d(xq, wq, mask=mask, groups=groups, name=name)
