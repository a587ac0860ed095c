"""The int8 conv of the quantized backends: two CUDA kernels for Hopper around
cuBLASLt's int8 GEMM, each kernel beside its plain PyTorch version.

No Pallas source: on the TPU, XLA fused the quantize into the int8 conv's
input and the dequant into its epilogue (`codon_tpu/quant_ops.py:103-131,
346-370`). PyTorch has no int8 conv, so `int8_conv` runs a stride-1 SAME
conv with an odd kernel as three steps over blocks of images:

  quant_im2col      NHWC activations (float32, bfloat16, float16, or int8
                    already on the site's grid) -> row-major int8 patches,
                    (pixels, kh*kw*C) with K ordered (dy, dx, c); each value
                    quantized on the way, round(x / s) clipped to +-127, s
                    per channel (static) or per image (dynamic); the SAME
                    padding written as code 0
  int8_gemm         torch._int_mm: patches x folded weights (K, C_out) ->
                    int32, cuBLASLt on the card
  dequant_epilogue  int32 -> the activation dtype, round_to(dt, acc) * s_w
                    (static) or * (s_x * s_w) (dynamic), times the mask

The CUDA sources are in `csrc/quant.cu`. Each wrapper takes the plain
version when its tensors lie on the CPU, and on a CUDA tensor launches the
kernel or raises; it never falls back. Each counts its launches in a plain
integer attribute, `<wrapper>.launches` (`int8_gemm` its GEMM calls on the
card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from codon_tpu_torch.kernels import _build

# the int8 patch buffer of one block of images stays at or under this
PATCH_BYTES_MAX = 2 ** 31
_VEC = 16                   # quant_im2col writes 16-byte vectors of codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3}
_MODE_NONE, _MODE_CHANNEL, _MODE_SAMPLE = 0, 1, 2


# ---------------------------------------------------------------------------
# plain versions: the specification, the CPU path, and the card's reference
# ---------------------------------------------------------------------------

def quantize_plain(x, s):
    """round(x.f32 / s) clipped to +-127 -> int8; round half to even, as
    jnp.round."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def quant_im2col_plain(x, k, sc=None, sx=None):
    """x (N,H,W,C) -> (N*H*W, k*k*C) int8 patches, K ordered (dy, dx, c).

    x int8: taken as codes (sc and sx None). Else exactly one of sc (C,)
    float32, a static per-channel scale, or sx (N,) float32, a dynamic
    per-image one.
    """
    n, h, w, c = x.shape
    if x.dtype == torch.int8:
        q = x
    else:
        q = quantize_plain(x, sc if sc is not None else sx.reshape(n, 1, 1, 1))
    r = k // 2
    qp = F.pad(q, (0, 0, r, r, r, r))
    taps = [qp[:, dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)]
    return torch.stack(taps, 3).reshape(n * h * w, k * k * c)


def dequant_epilogue_plain(acc, sw, dtype, shape, sx=None, mask=None,
                           out=None):
    """acc (N*H*W, C_out) int32 -> (N,H,W,C_out) in `dtype`.

    round_to(dtype, acc) * sw.to(dtype) (static), or * (sx * sw).to(dtype)
    with sx (N,) float32 (dynamic); then * mask.to(dtype), mask (N,H,W,1).
    `out`, when given, receives the result.
    """
    n, h, w = shape
    a = acc.reshape(n, h, w, acc.shape[1]).float().to(dtype)
    s = sw if sx is None else sx.reshape(n, 1, 1, 1) * sw
    y = a * s.to(dtype)
    if mask is not None:
        y = y * mask.to(dtype)
    if out is None:
        return y
    return out.copy_(y)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"quant kernels take CPU or CUDA tensors, got "
                         f"{t.device}")
    return False


def _need(cond: bool, what: str, *args) -> None:
    if not cond:
        raise ValueError(what.format(*args))


def _check_vector(t, shape, what):
    _need(t.shape == shape and t.dtype == torch.float32 and t.is_contiguous(),
          "{}: expected contiguous float32 {}, got {} {}", what,
          tuple(shape), t.dtype, tuple(t.shape))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def quant_im2col(x, k, sc=None, sx=None):
    """Kernel-backed `quant_im2col_plain`. On the card C is a multiple of
    16 and x starts on a 16-byte boundary. Float input at k > 1 takes two
    kernels (quantize, then gather), counted as one launch of the wrapper;
    at k = 1 the patches are the quantized x itself."""
    if _on_cpu(x):
        return quant_im2col_plain(x, k, sc, sx)
    _need(x.dim() == 4 and x.dtype in _DTYPE_CODES and x.is_contiguous(),
          "x: expected contiguous NHWC float32, bfloat16, float16 or int8, "
          "got {} {}", x.dtype, tuple(x.shape))
    n, h, w, c = x.shape
    _need(c % _VEC == 0 and x.data_ptr() % 16 == 0,
          "x: C={} must be a multiple of 16 and x 16-byte aligned", c)
    _need(k % 2 == 1, "k={}: the kernel takes odd kernels", k)
    if x.dtype == torch.int8:
        _need(sc is None and sx is None, "int8 input takes no scale")
        mode, scale = _MODE_NONE, None
    else:
        _need((sc is None) != (sx is None),
              "float input takes exactly one of sc, sx")
        if sc is not None:
            mode, scale = _MODE_CHANNEL, sc
            _check_vector(sc, (c,), "sc")
        else:
            mode, scale = _MODE_SAMPLE, sx.reshape(n)
            _check_vector(scale, (n,), "sx")
        _need(scale.device == x.device, "scale on {}, x on {}",
              scale.device, x.device)
    rows, kk = n * h * w, k * k * c
    _need(rows * kk // _VEC < 2 ** 32, "{} patch bytes: more than the "
          "kernel's 32-bit vector index", rows * kk)
    out = torch.empty((rows, kk), dtype=torch.int8, device=x.device)
    # float input at k > 1: the codes of x, quantized once, then gathered
    scratch = (torch.empty(x.shape, dtype=torch.int8, device=x.device)
               if scale is not None and k > 1 else None)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.codon_quant_im2col(
            _DTYPE_CODES[x.dtype], x.data_ptr(),
            None if scale is None else scale.data_ptr(), mode,
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), n, h, w, c, k, _stream(x))
    _build.check(rc, "quant_im2col")
    quant_im2col.launches += 1
    return out


def dequant_epilogue(acc, sw, dtype, shape, sx=None, mask=None, out=None):
    """Kernel-backed `dequant_epilogue_plain`. On the card C_out is a
    multiple of 8; mask, when given, is (N,H,W,1) in `dtype`; `out`, when
    given, a contiguous (N,H,W,C_out) tensor of `dtype`."""
    if _on_cpu(acc):
        return dequant_epilogue_plain(acc, sw, dtype, shape, sx, mask, out)
    n, h, w = shape
    _need(acc.dim() == 2 and acc.dtype == torch.int32 and acc.is_contiguous()
          and acc.shape[0] == n * h * w,
          "acc: expected contiguous int32 ({}, C_out), got {} {}",
          n * h * w, acc.dtype, tuple(acc.shape))
    co = acc.shape[1]
    _need(co % 8 == 0, "C_out={} must be a multiple of 8", co)
    _need(dtype in (torch.float32, torch.bfloat16, torch.float16),
          "unsupported output dtype {}", dtype)
    _check_vector(sw, (co,), "sw")
    if sx is not None:
        sx = sx.reshape(n)
        _check_vector(sx, (n,), "sx")
    if mask is not None:
        _need(mask.shape == (n, h, w, 1) and mask.dtype == dtype
              and mask.is_contiguous(),
              "mask: expected contiguous ({}, {}, {}, 1) {}", n, h, w, dtype)
    if out is None:
        out = torch.empty((n, h, w, co), dtype=dtype, device=acc.device)
    _need(out.shape == (n, h, w, co) and out.dtype == dtype
          and out.is_contiguous() and out.data_ptr() % 16 == 0,
          "out: expected contiguous 16-byte aligned ({}, {}, {}, {}) {}",
          n, h, w, co, dtype)
    for t in (sw, sx, mask, out):
        _need(t is None or t.device == acc.device,
              "every tensor must be on {}", acc.device)
    _need(n * h * w * co // 8 < 2 ** 32, "{} outputs: more than the "
          "kernel's 32-bit index", n * h * w * co)
    lib = _build.load()
    with torch.cuda.device(acc.device):
        rc = lib.codon_dequant_epilogue(
            _DTYPE_CODES[dtype], acc.data_ptr(), sw.data_ptr(),
            None if sx is None else sx.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            n, h, w, co, _stream(acc))
    _build.check(rc, "dequant_epilogue")
    dequant_epilogue.launches += 1
    return out


def int8_gemm(a, b):
    """torch._int_mm(a (M, K) int8, b (K, N) int8) -> (M, N) int32, with
    the shape rules of its CUDA path checked on every device: M > 16,
    K and N multiples of 8. b is handed over column-major: cuBLASLt's int8
    GEMM on the H100 refuses two row-major operands. Counts its calls on
    the card."""
    (m, k), (k2, nn) = a.shape, b.shape
    _need(a.dtype == b.dtype == torch.int8 and k == k2,
          "int8_gemm: expected int8 (M, K) x (K, N), got {} {} x {} {}",
          a.dtype, tuple(a.shape), b.dtype, tuple(b.shape))
    _need(m > 16 and k % 8 == 0 and nn % 8 == 0,
          "int8_gemm: torch._int_mm needs M > 16 and K, N multiples of 8; "
          "got M={}, K={}, N={}", m, k, nn)
    if b.stride(0) != 1:
        b = b.t().contiguous().t()
    out = torch._int_mm(a, b)
    if not _on_cpu(a):
        int8_gemm.launches += 1
    return out


KERNELS = (quant_im2col, dequant_epilogue)
COUNTED = KERNELS + (int8_gemm,)
for _k in COUNTED:
    _k.launches = 0


def reset_launches() -> None:
    for k in COUNTED:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in COUNTED}


# ---------------------------------------------------------------------------
# the composed conv
# ---------------------------------------------------------------------------

def image_blocks(n, h, w, kk):
    """[(start, stop)] of images a block: as few blocks as keep the int8
    patches of one at or under PATCH_BYTES_MAX, their sizes balanced (one
    image a block at least)."""
    per = max(1, PATCH_BYTES_MAX // (h * w * kk))
    blocks = -(-n // per)
    per = -(-n // blocks)
    return [(i, min(n, i + per)) for i in range(0, n, per)]


def int8_conv(x, w8, sw, dtype, *, sc=None, sx=None, mask=None, impl=None):
    """Stride-1 SAME int8 conv, dequantized and masked -> (N,H,W,C_out).

    x (N,H,W,C): int8 codes, or float with sc (C,) or sx (N,) float32 as in
    `quant_im2col_plain`. w8 (k,k,C,C_out) int8 HWIO, k odd; sw (C_out,)
    float32 its dequant scale; dtype the output's. mask (N,H,W,1) or None.
    impl: None takes the kernels (their plain versions on CPU tensors);
    "plain" takes the plain versions on any device, the card's reference.
    """
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    n, h, w, c = x.shape
    k = w8.shape[0]
    _need(w8.dim() == 4 and w8.shape[1] == k and k % 2 == 1
          and w8.shape[2] == c and w8.dtype == torch.int8,
          "w8: expected int8 (k, k, {}, C_out) with k odd, got {} {}", c,
          w8.dtype, tuple(w8.shape))
    co = w8.shape[3]
    kk = k * k * c
    # column-major, as int8_gemm hands it to cuBLASLt
    wmat = w8.reshape(kk, co).t().contiguous().t()
    plain = impl == "plain"
    im2col = quant_im2col_plain if plain else quant_im2col
    epilogue = dequant_epilogue_plain if plain else dequant_epilogue
    if mask is not None:
        mask = mask.to(dtype).contiguous()
    if sx is not None:
        sx = sx.reshape(n).contiguous()
    out = torch.empty((n, h, w, co), dtype=dtype, device=x.device)
    for i, j in image_blocks(n, h, w, kk):
        patches = im2col(x[i:j], k, sc, None if sx is None else sx[i:j])
        acc = int8_gemm(patches, wmat)
        del patches
        epilogue(acc, sw, dtype, (j - i, h, w),
                 None if sx is None else sx[i:j],
                 None if mask is None else mask[i:j], out=out[i:j])
    return out
