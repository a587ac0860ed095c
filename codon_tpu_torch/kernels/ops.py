"""The eval path's kernels as `torch.library` custom ops, namespace `codon`.

`torch.export` traces a forward with fake tensors, which hold no memory: a
ctypes launch on `t.data_ptr()` cannot run there, and a Python loop over a
batch's image blocks would fix the batch size. So each launch the eval
forward makes is one custom op, opaque to the tracer: its fake
implementation gives the outputs' shapes, dtypes and strides (the batch
left symbolic), and an exported program calls the op itself. Live eval
reaches the same ops through the public wrappers of `kernels.cac` and
`kernels.quant`, so a forward and its artifact launch the same kernels.

  codon::cac_stats       (out, out_c, mask?) -> ch_sum, ch_max, cmax, cmean
  codon::spatial_logits  (cmax, cmean, sp_w) -> logits
  codon::cac_apply       (out, out_c, inputs, inputs_c, gate, logits)
                         -> new_out, new_out_c
  codon::cac_apply_into  the same, written into two destination views
                         (the merged-tower forward's halves of the next T);
                         it mutates them and returns nothing, since an op
                         may not return an alias of its input
  codon::quant_im2col    (x, k, sc?, sx?, c0, cg?, halo=0) -> int8 patches
                         (the static backend's handoffs: its quantize at
                         k = 1)
  codon::int8_conv       (x, w8, sw, dtype, sc?, sx?, mask?, groups,
                         halo=0) -> (N, H - 2 halo, W, C_out): the whole
                         composed conv, image blocks, GEMM padding and
                         groups inside; halo > 0 on a spatial shard whose
                         neighbours' rows were exchanged

Each op has two implementations and no other: on CPU tensors the plain
PyTorch version, on CUDA tensors the launch code of `kernels.cac` and
`kernels.quant`, which checks its inputs, launches or raises, and counts
its launch on the public wrapper (`cac.cac_stats.launches`, ...). Neither
falls back to the other. `codon::int8_conv` composes its steps from the
wrappers, which choose the same way, tensor by tensor.

Importing this module registers the ops, which a process must do before
`torch.export.load` of an artifact that calls them; the package's
`__init__` imports it. The kernel library itself is built at the first
CUDA launch (`_build.load`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from codon_tpu_torch.kernels import cac, quant

_CPU, _CUDA = "cpu", "cuda"


# ---------------------------------------------------------------------------
# the CAC stage
# ---------------------------------------------------------------------------

@torch.library.custom_op("codon::cac_stats", mutates_args=(),
                         device_types=_CPU)
def cac_stats(out: Tensor, out_c: Tensor,
              mask: Optional[Tensor]) -> tuple[Tensor, Tensor, Tensor,
                                               Tensor]:
    return cac.cac_stats_plain(out, out_c, mask)


cac_stats.register_kernel(_CUDA)(cac._cac_stats_cuda)


@cac_stats.register_fake
def _(out, out_c, mask):
    n, h, w, c = out.shape
    f32 = torch.float32
    return (out.new_empty((n, 1, 2 * c), dtype=f32),
            out.new_empty((n, 1, 2 * c), dtype=f32),
            out.new_empty((n, h, w)), out.new_empty((n, h, w)))


@torch.library.custom_op("codon::spatial_logits", mutates_args=(),
                         device_types=_CPU)
def spatial_logits(cmax: Tensor, cmean: Tensor, sp_w: Tensor) -> Tensor:
    return cac.spatial_logits_plain(cmax, cmean, sp_w)


spatial_logits.register_kernel(_CUDA)(cac._spatial_logits_cuda)


@spatial_logits.register_fake
def _(cmax, cmean, sp_w):
    return cmax.new_empty(cmax.shape)


@torch.library.custom_op("codon::cac_apply", mutates_args=(),
                         device_types=_CPU)
def cac_apply(out: Tensor, out_c: Tensor, inputs: Tensor, inputs_c: Tensor,
              gate: Tensor, sp_logits: Tensor) -> tuple[Tensor, Tensor]:
    new_out, new_out_c = cac.cac_apply_plain(out, out_c, inputs, inputs_c,
                                             gate, sp_logits)
    return new_out.contiguous(), new_out_c.contiguous()


@cac_apply.register_kernel(_CUDA)
def _(out, out_c, inputs, inputs_c, gate, sp_logits):
    return cac._cac_apply_cuda(out, out_c, inputs, inputs_c, gate, sp_logits)


@cac_apply.register_fake
def _(out, out_c, inputs, inputs_c, gate, sp_logits):
    return out.new_empty(out.shape), out.new_empty(out.shape)


@torch.library.custom_op("codon::cac_apply_into",
                         mutates_args=("dst", "dst_c"), device_types=_CPU)
def cac_apply_into(out: Tensor, out_c: Tensor, inputs: Tensor,
                   inputs_c: Tensor, gate: Tensor, sp_logits: Tensor,
                   dst: Tensor, dst_c: Tensor) -> None:
    cac.cac_apply_plain(out, out_c, inputs, inputs_c, gate, sp_logits,
                        dst=(dst, dst_c))


@cac_apply_into.register_kernel(_CUDA)
def _(out, out_c, inputs, inputs_c, gate, sp_logits, dst, dst_c):
    cac._cac_apply_cuda(out, out_c, inputs, inputs_c, gate, sp_logits,
                        dst=(dst, dst_c))


@cac_apply_into.register_fake
def _(out, out_c, inputs, inputs_c, gate, sp_logits, dst, dst_c):
    return None


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------

@torch.library.custom_op("codon::quant_im2col", mutates_args=(),
                         device_types=_CPU)
def quant_im2col(x: Tensor, k: int, sc: Optional[Tensor],
                 sx: Optional[Tensor], c0: int,
                 cg: Optional[int], halo: int = 0) -> Tensor:
    return quant.quant_im2col_plain(x, k, sc, sx, c0, cg, halo)


quant_im2col.register_kernel(_CUDA)(quant._quant_im2col_cuda)


@quant_im2col.register_fake
def _(x, k, sc, sx, c0, cg, halo=0):
    n, h, w, c = x.shape
    return x.new_empty((n * (h - 2 * halo) * w,
                        k * k * (c if cg is None else cg)), dtype=torch.int8)


@torch.library.custom_op("codon::int8_conv", mutates_args=(),
                         device_types=(_CPU, _CUDA))
def int8_conv(x: Tensor, w8: Tensor, sw: Tensor, dtype: torch.dtype,
              sc: Optional[Tensor], sx: Optional[Tensor],
              mask: Optional[Tensor], groups: int,
              halo: int = 0) -> Tensor:
    # its steps are the wrappers `quant_im2col`, `int8_gemm` and
    # `dequant_epilogue`, called directly: the plain versions on CPU
    # tensors, the kernels on CUDA ones
    return quant.composed_int8_conv(x, w8, sw, dtype, sc, sx, mask, groups,
                                    plain=False, halo=halo)


@int8_conv.register_fake
def _(x, w8, sw, dtype, sc, sx, mask, groups, halo=0):
    n, h, w, _ = x.shape
    return x.new_empty((n, h - 2 * halo, w, w8.shape[3]), dtype=dtype)
