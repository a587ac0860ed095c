"""The quantized backends on one rank's shard of a spatially sharded
image: the sharded twins of `quant_ops.Int8Ops`, `quant_ops.Int8StaticOps`
and the two fake-quant (QAT) backends, as `codon_tpu.quant_ops`'
(`_gathered_sample_scale`, `Int8ShardedOps`, `Int8StaticShardedOps`,
`FakeQuantShardedOps`, `FakeQuantStaticShardedOps`).

  Int8ShardedOps  Int8Ops on a shard: the per-image absmax is all-reduced
                  over the sp group, so every shard quantizes on the
                  untiled grid; halo rows arrive in float and are quantized
                  with that same scale
  Int8StaticShardedOps  Int8StaticOps on a shard: static grids need no
                  collective, and halo rows are exchanged after quantizing,
                  1 byte a value; uncalibrated sites as Int8ShardedOps
  FakeQuantShardedOps  FakeQuantOps on a shard: activations fake-quantized
                  on the gathered per-image scale, then the float conv of
                  `ShardedOps` (halo rows exchanged after fake-quant, the
                  values they have on their home shard)
  FakeQuantStaticShardedOps  FakeQuantStaticOps on a shard: the frozen
                  grids need no collective; an uncalibrated site takes the
                  gathered scale

Each quantized conv runs `kernels.quant.int8_conv` with `halo=r`: the
gather reads the r rows of each neighbour and writes the shard's rows only.
The fake-quant twins run float convs and train: the scale reaches the
straight-through `_fq` only inside its detached part, as in JAX, so its
all-reduce is taken on a detached tensor.
"""
from __future__ import annotations

import torch

from codon_tpu_torch.kernels.quant import int8_conv
from codon_tpu_torch.parallel.comm import all_max, halo_rows
from codon_tpu_torch.parallel.ops import ShardedOps, check_pooled
from codon_tpu_torch.quant_ops import (Int8StaticOps, _check_impl,
                                       _fold_weights, _fq, _int8_conv,
                                       _skip_quant, _StaticFakeQuantMixin,
                                       _StaticHandoffMixin, _w_scales)


def _gathered_sample_scale(x, group):
    """`_x_scale` of the whole image from one spatial shard: the per-image
    absmax all-reduced (max) over the sp group, in float32 (exact for a
    max), then clamped and divided in x's dtype as `_x_scale` does ->
    (N, 1, 1, 1) float32, the same bits as the untiled scale. No gradient
    flows through it (its QAT use is inside `_fq`'s detached part)."""
    local = x.detach().abs().amax(dim=(1, 2, 3), keepdim=True)
    return (torch.clamp_min(all_max(local, group), 1e-8) / 127.0).float()


def sample_scale_on_shard(mesh, x):
    """`_gathered_sample_scale` as `MeshPool.shard_map` calls it: this
    rank's shard of x -> the whole image's (N, 1, 1, 1) scale."""
    return _gathered_sample_scale(x, mesh.sp_group)


class Int8ShardedOps(ShardedOps):
    """Int8Ops on one rank's shard of a spatially sharded image.

    The per-image scale is all-reduced over the sp group
    (`_gathered_sample_scale`), so every shard quantizes on the untiled
    grid; the halo rows arrive in float and are quantized inside the conv
    with that same scale, the codes they have on their home shard. The
    convs of <= 2 channels and the CAC stage are `ShardedOps`'.
    mesh: this rank's `parallel.mesh.Mesh`; quant_impl as in `Int8Ops`.
    """

    def __init__(self, mesh, quant_impl=None):
        super().__init__(mesh)
        self.quant_impl = _check_impl(quant_impl)

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        r = (w.shape[0] - 1) // 2
        check_pooled(x, r)
        return _int8_conv(halo_rows(x, r, self.group), w, mask=mask,
                          sx=_gathered_sample_scale(x, self.group),
                          impl=self.quant_impl, groups=groups, halo=r)


class Int8StaticShardedOps(_StaticHandoffMixin, Int8ShardedOps):
    """Int8StaticOps on one rank's shard of a spatially sharded image.

    Static grids are position-independent, so quantizing needs no
    collective, and the handoffs are `Int8StaticOps`'. A calibrated site
    with a stencil quantizes its shard first and exchanges the halo rows as
    int8 codes (1 byte a value, the codes of their home shard), then
    gathers the patches: the same quantize and gather kernels as one
    unsharded `quant_im2col` call, in two calls; a 1x1 site needs no halo
    and quantizes inside the conv, as unsharded. An uncalibrated site runs
    as `Int8ShardedOps`. Sharded equals untiled up to a few activation
    LSBs: the float values fed to round() carry the reduction-order noise
    of the all-reduced CAC statistics and the convs, which a rounding
    boundary turns into a flipped code (JAX's docstring says the same of
    its twin).
    """

    def __init__(self, act_scales, mesh, compute_dtype=torch.float32,
                 quant_impl=None):
        super().__init__(mesh, quant_impl)
        self.act_scales = {k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in act_scales.items()}
        self.compute_dtype = compute_dtype

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        sc = None if _skip_quant(w) else self._scale(name, x, groups)
        if sc is None:
            # a float conv, or an uncalibrated site: Int8ShardedOps'
            if x.dtype == torch.int8:
                raise ValueError(
                    f"pre-quantized input at uncalibrated site {name!r}")
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        r = (w.shape[0] - 1) // 2
        w8, sw = _fold_weights(w, sc, groups)
        if x.dtype == torch.int8:
            out_dt, xs = self.compute_dtype, None
        else:
            out_dt = (x.dtype if x.is_floating_point()
                      else self.compute_dtype)
            xs = sc
            if r:
                # the halo rows travel as codes: quantize the shard first
                x, xs = self._quantize(x, sc), None
        return int8_conv(halo_rows(x, r, self.group), w8, sw, out_dt, sc=xs,
                         mask=mask, impl=self.quant_impl, groups=groups,
                         halo=r)


class FakeQuantShardedOps(ShardedOps):
    """FakeQuantOps on one rank's shard (QAT under a mesh): the per-image
    scale all-reduced over the sp group, the value `_x_scale` has untiled,
    so the halo rows, exchanged after fake-quant, carry their home shard's
    codes; weights per output channel; the float conv is `ShardedOps`'.
    mesh: this rank's `parallel.mesh.Mesh`."""

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        xq = _fq(x, _gathered_sample_scale(x, self.group))
        wq = _fq(w, _w_scales(w)[None, None, None, :].float())
        return super().conv2d(xq, wq, mask=mask, groups=groups, name=name)


class FakeQuantStaticShardedOps(_StaticFakeQuantMixin, ShardedOps):
    """FakeQuantStaticOps on one rank's shard: the frozen grids are
    position-independent, so a calibrated site needs no collective; an
    uncalibrated site fake-quantizes on the gathered per-image scale. The
    float conv is `ShardedOps`' on the fake-quantized pair, and
    `roundtrip` the mixin's. act_scales: {site: (C_in,) float32}, frozen;
    mesh: this rank's `parallel.mesh.Mesh`."""

    def __init__(self, act_scales, mesh):
        super().__init__(mesh)
        self.act_scales = {k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in act_scales.items()}

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        if _skip_quant(w):
            return super().conv2d(x, w, mask=mask, groups=groups, name=name)
        sc = self._scale(name, x, groups)
        xq, wq = self._fq_site(
            x, w, sc, groups,
            x_scale=(None if sc is not None
                     else _gathered_sample_scale(x, self.group)))
        return super().conv2d(xq, wq, mask=mask, groups=groups, name=name)


def static_int8_ops(act_scales, mesh=None, compute_dtype=torch.float32,
                    quant_impl=None):
    """The static-int8 backend of one mesh rank, from a member's scales at
    call time (`parallel.tiling`'s scales_factory): `Int8StaticShardedOps`
    on a spatial shard (mesh given), `Int8StaticOps` on whole images."""
    if mesh is None:
        return Int8StaticOps(act_scales, compute_dtype=compute_dtype,
                             quant_impl=quant_impl)
    return Int8StaticShardedOps(act_scales, mesh,
                                compute_dtype=compute_dtype,
                                quant_impl=quant_impl)
