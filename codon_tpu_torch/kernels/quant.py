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

A grouped conv (`groups` G, the merged-tower forward's) quantizes its input
once over all channels, then runs each group as a gather of that group's
channel window, a GEMM against the group's weights, and an epilogue that
writes the group's output-channel window of the one output tensor.

A narrow site (the zoo's: RCAN's 64 -> 4 -> 64 gate on a pooled (N, 1, 1,
64) vector, CGNL's grouped 32 -> 64 with 4 channels a group) is padded
with zeros to the widths the kernels and the GEMM take, on every device
and route alike: each group's input channels to a multiple of 16 (zero
codes add nothing to a dot, and a zero never raises an absmax), its output
channels to a multiple of 8 (zero weights, sliced off after), and a GEMM
of at most 16 rows to 32 (zero rows, sliced off). The result is the same
bits as the unpadded conv, and the site still runs the three steps.

The CUDA sources are in `csrc/quant.cu`. Each wrapper takes the plain
version when its tensors lie on the CPU, and on a CUDA tensor launches the
kernel or raises; it never falls back. `int8_conv` dispatches through the
custom op `codon::int8_conv` (`kernels.ops`: the whole composed conv in
one op) and the static handoffs' quantize through `codon::quant_im2col`,
which `torch.export` records in an exported program with the batch left
symbolic. The launch code counts each launch in a plain integer attribute
of the wrapper, `<wrapper>.launches` (`int8_gemm` its GEMM calls on the
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
_CO_ALIGN = 8               # dequant_epilogue and _int_mm: C_out by 8
_GEMM_MIN_ROWS, _GEMM_PAD_ROWS = 17, 32   # _int_mm takes M > 16


# ---------------------------------------------------------------------------
# plain versions: the specification, the CPU path, and the card's reference
# ---------------------------------------------------------------------------

def quantize_plain(x, s):
    """round(x.f32 / s) clipped to +-127 -> int8; round half to even, as
    jnp.round."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def halo_rows_out(h, k, halo):
    """Output rows of a conv whose input carries `halo` rows of its
    neighbours above and below: h - 2 * halo. 0 <= halo <= k // 2; halo 0
    is SAME padding in H, halo k // 2 none (the haloed rows stand in for
    it); W is SAME-padded either way."""
    _need(0 <= halo <= k // 2 and h > 2 * halo,
          "halo={}: expected 0 <= halo <= k // 2 = {} and more than "
          "2 * halo input rows, got {}", halo, k // 2, h)
    return h - 2 * halo


def quant_im2col_plain(x, k, sc=None, sx=None, c0=0, cg=None, halo=0):
    """x (N,H,W,C) -> (N*Ho*W, k*k*cg) int8 patches of the channel window
    [c0, c0 + cg) (all of C by default), K ordered (dy, dx, c).

    x int8: taken as codes (sc and sx None). Else exactly one of sc (C,)
    float32, a static per-channel scale, or sx (N,) float32, a dynamic
    per-image one; all C channels are quantized.
    halo: rows of x that belong to the neighbouring shards above and
    below (a spatially sharded conv's exchanged rows): the patches are
    those of the Ho = H - 2 * halo middle rows, read through them, with
    k // 2 - halo zero rows of padding in H (`halo_rows_out`).
    """
    n, h, w, _ = x.shape
    ho = halo_rows_out(h, k, halo)
    if x.dtype == torch.int8:
        q = x
    else:
        q = quantize_plain(x, sc if sc is not None else sx.reshape(n, 1, 1, 1))
    c = q.shape[3] if cg is None else cg
    q = q[..., c0:c0 + c]
    r = k // 2
    pr = r - halo
    qp = F.pad(q, (0, 0, r, r, pr, pr))
    taps = [qp[:, dy:dy + ho, dx:dx + w] for dy in range(k)
            for dx in range(k)]
    return torch.stack(taps, 3).reshape(n * ho * w, k * k * c)


def dequant_epilogue_plain(acc, sw, dtype, shape, sx=None, mask=None,
                           out=None, o0=0):
    """acc (N*H*W, C_out) int32 -> (N,H,W,C_out) in `dtype`.

    round_to(dtype, acc) * sw.to(dtype) (static), or * (sx * sw).to(dtype)
    with sx (N,) float32 (dynamic); then * mask.to(dtype), mask (N,H,W,1).
    `out`, when given, receives the result in its channels [o0, o0 +
    C_out) (a group's window of a grouped conv's output).
    """
    n, h, w = shape
    a = acc.reshape(n, h, w, acc.shape[1]).float().to(dtype)
    s = sw if sx is None else sx.reshape(n, 1, 1, 1) * sw
    y = a * s.to(dtype)
    if mask is not None:
        y = y * mask.to(dtype)
    if out is None:
        return y
    out[..., o0:o0 + y.shape[3]] = y
    return out


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


def quant_im2col(x, k, sc=None, sx=None, c0=0, cg=None, halo=0):
    """Kernel-backed `quant_im2col_plain`. On the card C, c0 and cg are
    multiples of 16 and x starts on a 16-byte boundary. Float input takes
    two kernels (quantize, then gather), counted as one launch of the
    wrapper; at k = 1 over all of C the patches are the quantized x
    itself. Inside `codon::int8_conv` it is called directly; the int8
    handoffs reach it through the op `codon::quant_im2col`."""
    if _on_cpu(x):
        return quant_im2col_plain(x, k, sc, sx, c0, cg, halo)
    return _quant_im2col_cuda(x, k, sc, sx, c0, cg, halo)


def _quant_im2col_cuda(x, k, sc, sx, c0, cg, halo=0):
    """`quant_im2col` on the card, the CUDA implementation of
    `codon::quant_im2col`."""
    _need(x.dim() == 4 and x.dtype in _DTYPE_CODES and x.is_contiguous(),
          "x: expected contiguous NHWC float32, bfloat16, float16 or int8, "
          "got {} {}", x.dtype, tuple(x.shape))
    n, h, w, c = x.shape
    _need(c % _VEC == 0 and x.data_ptr() % 16 == 0,
          "x: C={} must be a multiple of 16 and x 16-byte aligned", c)
    cg = c if cg is None else cg
    _need(c0 % _VEC == 0 and cg % _VEC == 0 and 0 <= c0 and cg > 0
          and c0 + cg <= c,
          "channel window [{}, {}) of C={}: the gather reads whole 16-byte "
          "vectors inside C", c0, c0 + cg, c)
    _need(k % 2 == 1, "k={}: the kernel takes odd kernels", k)
    ho = halo_rows_out(h, k, halo)
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
    rows, kk = n * ho * w, k * k * cg
    _need(max(rows * kk, n * h * w * c) // _VEC < 2 ** 32, "{} patch "
          "bytes: more than the kernel's 32-bit vector index", rows * kk)
    out = torch.empty((rows, kk), dtype=torch.int8, device=x.device)
    # float input, unless at k = 1 over all of C: the codes of x, quantized
    # once, then gathered
    whole = k == 1 and cg == c
    scratch = (torch.empty(x.shape, dtype=torch.int8, device=x.device)
               if scale is not None and not whole else None)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.codon_quant_im2col(
            _DTYPE_CODES[x.dtype], x.data_ptr(),
            None if scale is None else scale.data_ptr(), mode,
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), n, h, w, c, k, halo, c0, cg, _stream(x))
    _build.check(rc, "quant_im2col")
    quant_im2col.launches += 1
    return out


def dequant_epilogue(acc, sw, dtype, shape, sx=None, mask=None, out=None,
                     o0=0):
    """Kernel-backed `dequant_epilogue_plain`. On the card C_out and o0 are
    multiples of 8; mask, when given, is (N,H,W,1) in `dtype`; `out`, when
    given, a contiguous (N,H,W,P) tensor of `dtype` whose channels [o0, o0
    + C_out) lie inside P."""
    if _on_cpu(acc):
        return dequant_epilogue_plain(acc, sw, dtype, shape, sx, mask, out,
                                      o0)
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
    pitch = out.shape[-1]
    _need(out.shape[:3] == (n, h, w) and out.dtype == dtype
          and out.is_contiguous() and out.data_ptr() % 16 == 0,
          "out: expected contiguous 16-byte aligned ({}, {}, {}, P) {}",
          n, h, w, dtype)
    _need(o0 % 8 == 0 and 0 <= o0 and o0 + co <= pitch,
          "output window [{}, {}) of P={}: 8-channel aligned, inside P",
          o0, o0 + co, pitch)
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
            n, h, w, co, pitch, o0, _stream(acc))
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


def int8_conv(x, w8, sw, dtype, *, sc=None, sx=None, mask=None, impl=None,
              groups=1, halo=0):
    """Stride-1 SAME int8 conv, dequantized and masked -> (N,Ho,W,C_out).

    x (N,H,W,C): int8 codes, or float with sc (C,) or sx (N,) float32 as in
    `quant_im2col_plain`. w8 (k,k,C/groups,C_out) int8 HWIO, k odd, the
    output channels blocked by group; sw (C_out,) float32 its dequant
    scale; dtype the output's. mask (N,H,W,1) or None. impl: None takes
    the kernels through the custom op `codon::int8_conv` (their plain
    versions on CPU tensors); "plain" takes the plain versions on any
    device, the card's reference. With groups > 1
    the input is quantized once (at k = 1, over all C), then each group is
    gathered, multiplied and dequantized into its output window; on the
    card every group's widths must meet the kernels' alignment (C/groups a
    multiple of 16, C_out/groups of 8).
    A site whose group widths the kernels do not take (C/groups not a
    multiple of 16, C_out/groups not of 8) runs zero-padded to them, as the
    module docstring says; so does a GEMM of at most 16 rows.
    halo: x's rows from the neighbouring shards above and below, as in
    `quant_im2col_plain`; the output has Ho = H - 2 * halo rows, SAME in W,
    and mask is (N, Ho, W, 1). Quantizing the haloed rows on the same
    scale gives each the codes it has on its home shard.
    """
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain":
        return composed_int8_conv(x, w8, sw, dtype, sc, sx, mask, groups,
                                  plain=True, halo=halo)
    _on_cpu(x)
    return torch.ops.codon.int8_conv(x, w8, sw, dtype, sc, sx, mask, groups,
                                     halo)


def composed_int8_conv(x, w8, sw, dtype, sc, sx, mask, groups, plain,
                       halo=0):
    """`int8_conv` as three steps over blocks of images: the plain
    versions (plain=True), or the wrappers (the implementation of
    `codon::int8_conv`: the kernels on the card, the plain versions on the
    CPU)."""
    n, h, w, c = x.shape
    k = w8.shape[0]
    cg = c // groups
    _need(w8.dim() == 4 and w8.shape[1] == k and k % 2 == 1
          and c % groups == 0 and w8.shape[2] == cg
          and w8.shape[3] % groups == 0 and w8.dtype == torch.int8,
          "w8: expected int8 (k, k, {}, C_out) with k odd and C_out a "
          "multiple of {}, got {} {}", cg, groups, w8.dtype, tuple(w8.shape))
    co = w8.shape[3]
    cog = co // groups
    if cg % _VEC or cog % _CO_ALIGN:
        return _padded_int8_conv(x, w8, sw, dtype, sc=sc, sx=sx, mask=mask,
                                 plain=plain, groups=groups, halo=halo)
    ho = halo_rows_out(h, k, halo)
    kk = k * k * cg
    # column-major, as int8_gemm hands it to cuBLASLt; one (K, C_out/G)
    # matrix a group
    wmats = [w8[..., g * cog:(g + 1) * cog].reshape(kk, cog).t()
             .contiguous().t() for g in range(groups)]
    im2col = quant_im2col_plain if plain else quant_im2col
    epilogue = dequant_epilogue_plain if plain else dequant_epilogue
    if mask is not None:
        mask = mask.to(dtype).contiguous()
    if sx is not None:
        sx = sx.reshape(n).contiguous()
    out = torch.empty((n, ho, w, co), dtype=dtype, device=x.device)
    for i, j in image_blocks(n, ho, w, kk):
        sxb = None if sx is None else sx[i:j]
        xb = x[i:j]
        if groups > 1 and xb.dtype != torch.int8:
            # quantize once over all C: the codes of x, pixel by pixel
            xb = im2col(xb, 1, sc, sxb).view(xb.shape)
        for g, wmat in enumerate(wmats):
            if groups > 1:
                patches = im2col(xb, k, c0=g * cg, cg=cg, halo=halo)
            else:
                patches = im2col(xb, k, sc, sxb, halo=halo)
            m = patches.shape[0]
            if m < _GEMM_MIN_ROWS:
                patches = F.pad(patches, (0, 0, 0, _GEMM_PAD_ROWS - m))
            acc = int8_gemm(patches, wmat)[:m]
            del patches
            epilogue(acc, sw[g * cog:(g + 1) * cog].contiguous(), dtype,
                     (j - i, ho, w), sxb,
                     None if mask is None else mask[i:j], out=out[i:j],
                     o0=g * cog)
    return out


def _pad_groups(t, groups, width, value=0):
    """(..., groups * g) -> (..., groups * width): each group's last-axis
    block padded with `value` to `width`."""
    g = t.shape[-1] // groups
    if g == width:
        return t
    blocks = t.reshape(*t.shape[:-1], groups, g)
    return F.pad(blocks, (0, width - g), value=value).reshape(
        *t.shape[:-1], groups * width).contiguous()


def _padded_int8_conv(x, w8, sw, dtype, *, sc, sx, mask, plain, groups,
                      halo=0):
    """`int8_conv` of a narrow site, on group widths padded to the kernels'
    (input channels to a multiple of 16, output channels to one of 8): zero
    input codes, unit scales on the padded channels, zero weights on the
    padded outputs, which are sliced off."""
    k, cg, co = w8.shape[0], w8.shape[2], w8.shape[3]
    cog = co // groups
    cgp = -(-cg // _VEC) * _VEC
    cogp = -(-cog // _CO_ALIGN) * _CO_ALIGN
    xp = _pad_groups(x, groups, cgp)
    scp = None if sc is None else _pad_groups(sc, groups, cgp, 1.0)
    wp = F.pad(w8.reshape(k, k, cg, groups, cog),
               (0, cogp - cog, 0, 0, 0, cgp - cg))
    wp = wp.reshape(k, k, cgp, groups * cogp)
    swp = _pad_groups(sw, groups, cogp, 1.0)
    out = composed_int8_conv(xp, wp, swp, dtype, scp, sx, mask, groups,
                             plain, halo)
    if cogp == cog:
        return out
    return out.reshape(*out.shape[:3], groups, cogp)[..., :cog].reshape(
        *out.shape[:3], co).contiguous()
