"""The CAC-stage kernels: CUDA for Hopper, each beside its plain PyTorch version.

Counterparts of the three Pallas TPU kernels of `codon_tpu.kernels.cac`:

  cac_stats       one pass over both towers -> per-image channel sums and
                  maxes of Fcat = [color | depth] (for the channel-gate MLP)
                  and the channel-pooled max / mean maps (for the spatial
                  gate), in one launch; `StatsPlan` mirrors its chunk map
  spatial_logits  the k x k (k = 5) SAME stencil, 2 -> 1, on the pooled maps
  cac_apply       ad = channel gate x sigmoid(logits); both towers gated and
                  the long skip added: 4 reads + 2 writes in one pass

The CUDA sources are in `csrc/cac.cu`. Each wrapper dispatches through its
custom op (`kernels.ops`: `codon::cac_stats`, `codon::spatial_logits`,
`codon::cac_apply`, `codon::cac_apply_into`), which `torch.export` records
in an exported program: the op takes the plain version when its tensors
lie on the CPU, and on a CUDA tensor runs the launch code below
(`_<wrapper>_cuda`), which launches the kernel or raises; it never falls
back. The launch code counts each kernel launch in a plain integer
attribute of the wrapper, `<wrapper>.launches`.

Layout: NHWC, C innermost; activations float32, bfloat16 or float16;
sums, maxes and the gate in float32. A tower may be a channel window of a
wider NHWC tensor (its "pitch", the elements from one pixel to the next,
above C): the merged-tower forward hands the kernels the two halves of its
(N, H, W, 2C) tensor as views, and `cac_apply(..., dst=...)` writes both
halves of the next one. The plain versions take the same views.

`CacStageFunction` puts the composed stage under autograd for training:
its forward runs the three kernels, its backward recomputes the stage in
plain PyTorch from the saved inputs and differentiates that. The JAX
package has no backward kernel either: it trains through XLA's autodiff
of the same plain stage.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from codon_tpu_torch.kernels import _build

NEG = -3.0e38               # the TPU kernel's "minus infinity" for maxes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# cac_stats' chunk map (csrc/cac.cu): about STATS_TARGET_CHUNKS chunks a
# call (one wave of the H100's 264 resident blocks; a constant, so the
# bits never depend on the card), at most STATS_MAX_CHUNKS an image, and
# at least STATS_MIN_PIXELS pixels a chunk where the image has them;
# STATS_THREADS threads a block, and one arrival counter an image,
# STATS_TICKET_SLOTS of them (images a call at most)
STATS_TARGET_CHUNKS = 256
STATS_MAX_CHUNKS = 64
STATS_MIN_PIXELS = 256
STATS_THREADS = 256
STATS_TICKET_SLOTS = 65536


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    """How `cac_stats`' kernel cuts a call, in the kernel's own arguments:
    `n` images of `h` x `w` pixels, each cut into chunks of `rows` whole
    rows, the last chunk of an image shorter. Chunk i is image i //
    per_image's chunk i % per_image, and its partials go to slot i of the
    scratch buffer whichever block of the persistent grid computes it: the
    grid (the card's SMs times the blocks each holds) moves no bit."""
    n: int
    h: int
    w: int
    rows: int

    @property
    def per_image(self) -> int:
        return -(-self.h // self.rows)

    @property
    def chunks(self) -> int:
        return self.n * self.per_image

    def chunk(self, i: int) -> tuple:
        """Chunk i -> (image, its first pixel in the image, pixels), as the
        kernel finds it."""
        n, k = divmod(i, self.per_image)
        row0 = k * self.rows
        return n, row0 * self.w, min(self.rows, self.h - row0) * self.w

    def reduce_groups(self, c: int) -> tuple:
        """The order in which the block that finishes an image adds its
        chunks' partials (4C floats, C float4s a chunk): G = STATS_THREADS
        // c groups, group g adding the image's chunks g, g + G, ... in
        turn, then the groups' sums added in order g = 0, 1, ..."""
        g = STATS_THREADS // c
        return tuple(tuple(range(q, self.per_image, g)) for q in range(g))


def stats_plan(n: int, h: int, w: int,
               target_chunks: int = STATS_TARGET_CHUNKS,
               max_chunks: int = STATS_MAX_CHUNKS,
               min_pixels: int = STATS_MIN_PIXELS) -> StatsPlan:
    """The chunk map of a `cac_stats` call on n images of h x w, from (n,
    h, w) alone: an image's sums take the same order, and the same bits,
    in every call of that shape, and in a batch of any size up to
    target_chunks // max_chunks (4) images. The wrapper takes the default
    limits; `perf_stats_probe` tries others."""
    per_image = min(max_chunks, -(-target_chunks // n))
    rows = max(-(-min_pixels // w), -(-h // per_image))
    return StatsPlan(n, h, w, rows)


# ---------------------------------------------------------------------------
# plain versions: the specification, the CPU path, and the card's reference
# ---------------------------------------------------------------------------

def cac_stats_plain(out, out_c, mask=None):
    """-> (ch_sum (N,1,2C) f32, ch_max (N,1,2C) f32, cmax (N,H,W), cmean).

    Fcat is color first. The sums rely on padding already being zero
    (masked convs upstream); the max leaves out mask == 0 pixels. The pooled
    maps are of the raw values, in the activation dtype.
    """
    c = out.shape[-1]
    x, y = out.float(), out_c.float()
    ch_sum = torch.cat([y.sum((1, 2)), x.sum((1, 2))], -1)[:, None]
    if mask is not None:
        invalid = mask <= 0
        x_m, y_m = x.masked_fill(invalid, NEG), y.masked_fill(invalid, NEG)
    else:
        x_m, y_m = x, y
    ch_max = torch.cat([y_m.amax((1, 2)), x_m.amax((1, 2))], -1)[:, None]
    cmax = torch.maximum(out.amax(-1), out_c.amax(-1))
    cmean = ((x.sum(-1) + y.sum(-1)) / (2 * c)).to(out.dtype)
    return ch_sum, ch_max, cmax, cmean


def spatial_logits_plain(cmax, cmean, sp_w):
    """sp_w: (k, k, 2, 1), channel 0 = max, 1 = mean. -> (N,H,W) logits in
    the maps' dtype; taps summed in float32 in the TPU kernel's order."""
    n, h, w = cmax.shape
    k = sp_w.shape[0]
    r = (k - 1) // 2
    a = F.pad(cmax.float(), (r, r, r, r))
    b = F.pad(cmean.float(), (r, r, r, r))
    wk = sp_w.float()
    acc = torch.zeros((n, h, w), dtype=torch.float32, device=cmax.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + (wk[dy, dx, 0, 0] * a[:, dy:dy + h, dx:dx + w] +
                         wk[dy, dx, 1, 0] * b[:, dy:dy + h, dx:dx + w])
    return acc.to(cmax.dtype)


def cac_apply_plain(out, out_c, inputs, inputs_c, gate, sp_logits,
                    dst=None):
    """gate (N,1,C) f32 post-sigmoid; sp_logits (N,H,W) pre-sigmoid.
    ad is built in float32 and rounded once to the activation dtype; the
    gating and the long skip run in the activation dtype. dst: None, or a
    pair of writable (N,H,W,C) views that receive (new_out, new_out_c)."""
    sp = torch.sigmoid(sp_logits.float())
    ad = (sp[..., None] * gate[:, None]).to(out.dtype)
    new = (out * ad + inputs, out_c * ad + inputs_c)
    if dst is None:
        return new
    for d, v in zip(dst, new):
        d.copy_(v)
    return tuple(dst)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_device(t: torch.Tensor) -> None:
    """Raise unless `t` lies on the CPU or a CUDA card, the two devices
    the ops have an implementation for."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CAC kernels take CPU or CUDA tensors, got "
                         f"{t.device}")


def _need(cond: bool, what: str, *args) -> None:
    """Raise ValueError(what.format(*args)) unless `cond`; the message is
    built only on failure (the wrappers run on every stage)."""
    if not cond:
        raise ValueError(what.format(*args))


def tower_pitch(t: torch.Tensor):
    """Elements from one pixel's first channel to the next's, if `t`
    (N,H,W,C) is a tower the kernels read: its channels contiguous and its
    pixels evenly spaced, as in a contiguous tensor (pitch C) or a channel
    window of a wider contiguous NHWC tensor. None otherwise."""
    n, h, w, c = t.shape
    p = t.stride(2)
    want = (h * w * p, w * p, p, 1)
    if p < c or any(size > 1 and st != want[i]
                    for i, (size, st) in enumerate(zip(t.shape, t.stride()))):
        return None
    return p


def _check_towers(*ts):
    """-> the towers' common pitch; raises unless the kernels take them."""
    ref = ts[0]
    _need(ref.dim() == 4, "expected NHWC activations, got {}",
          tuple(ref.shape))
    _need(ref.dtype in _DTYPE_CODES, "unsupported dtype {}", ref.dtype)
    pitch = tower_pitch(ref)
    for t in ts:
        _need(t.shape == ref.shape and t.dtype == ref.dtype
              and t.device == ref.device,
              "towers differ in shape, dtype or device")
        _need(pitch is not None and tower_pitch(t) == pitch,
              "towers must be NHWC with contiguous channels and one pitch")
        _need(t.data_ptr() % 16 == 0,
              "activations must start on a 16-byte boundary")
    row = ref.shape[-1] * ref.element_size()
    vpp = row // 16
    _need(row % 16 == 0 and 1 <= vpp <= 32 and vpp & (vpp - 1) == 0,
          "C={} of {}: a pixel's channels must be a power-of-two count of "
          "16-byte vectors, at most 32", ref.shape[-1], ref.dtype)
    _need(pitch * ref.element_size() % 16 == 0,
          "pitch {}: not a whole number of 16-byte vectors", pitch)
    return pitch


def _check_plane(t, shape, dtype, device, what):
    _need(t.shape == shape and t.dtype == dtype and t.device == device
          and t.is_contiguous(),
          "{}: expected contiguous {} {} on {}", what, tuple(shape), dtype,
          device)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def cac_stats(out, out_c, mask=None):
    """Kernel-backed `cac_stats_plain`. mask: optional (N,H,W,1), same dtype.
    The towers may be channel windows of one pitch (`tower_pitch`)."""
    _check_device(out)
    return torch.ops.codon.cac_stats(out, out_c, mask)


def _cac_stats_cuda(out, out_c, mask):
    """The CUDA implementation of `codon::cac_stats`."""
    pitch = _check_towers(out, out_c)
    n, h, w, c = out.shape
    if mask is not None:
        _check_plane(mask, (n, h, w, 1), out.dtype, out.device, "mask")
    _need(out.numel() > 0, "cac_stats: empty towers {}", tuple(out.shape))
    _need(n <= STATS_TICKET_SLOTS, "cac_stats: {} images, at most {} a call",
          n, STATS_TICKET_SLOTS)
    plan = stats_plan(n, h, w)
    lib = _build.load()
    dev = out.device
    f32 = torch.float32
    part = torch.empty((plan.chunks, 2, 2 * c), dtype=f32, device=dev)
    ch_sum = torch.empty((n, 1, 2 * c), dtype=f32, device=dev)
    ch_max = torch.empty((n, 1, 2 * c), dtype=f32, device=dev)
    cmax = torch.empty((n, h, w), dtype=out.dtype, device=dev)
    cmean = torch.empty((n, h, w), dtype=out.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.codon_cac_stats(
            _DTYPE_CODES[out.dtype], out.data_ptr(), out_c.data_ptr(),
            None if mask is None else mask.data_ptr(), part.data_ptr(),
            ch_sum.data_ptr(), ch_max.data_ptr(), cmax.data_ptr(),
            cmean.data_ptr(), n, h, w, c, pitch, plan.rows, _stream(out))
    _build.check(rc, "cac_stats")
    cac_stats.launches += 1
    return ch_sum, ch_max, cmax, cmean


def spatial_logits(cmax, cmean, sp_w):
    """Kernel-backed `spatial_logits_plain`. sp_w: (5, 5, 2, 1) on the card,
    the 5x5 spatial gate of every variant; any odd k on the CPU."""
    _check_device(cmax)
    return torch.ops.codon.spatial_logits(cmax, cmean, sp_w)


def _spatial_logits_cuda(cmax, cmean, sp_w):
    """The CUDA implementation of `codon::spatial_logits`."""
    _need(cmax.dim() == 3 and cmax.dtype in _DTYPE_CODES,
          "cmax: expected (N,H,W) activations, got {} {}",
          tuple(cmax.shape), cmax.dtype)
    _check_plane(cmax, cmax.shape, cmax.dtype, cmax.device, "cmax")
    _check_plane(cmean, cmax.shape, cmax.dtype, cmax.device, "cmean")
    k = sp_w.shape[0]
    _need(sp_w.shape == (5, 5, 2, 1),
          "sp_w: the kernel takes a 5x5 gate, (5, 5, 2, 1), got {}",
          tuple(sp_w.shape))
    wk = sp_w.to(device=cmax.device, dtype=torch.float32).contiguous()
    n, h, w = cmax.shape
    lib = _build.load()
    logits = torch.empty_like(cmax)
    with torch.cuda.device(cmax.device):
        rc = lib.codon_spatial_logits(
            _DTYPE_CODES[cmax.dtype], cmax.data_ptr(), cmean.data_ptr(),
            wk.data_ptr(), logits.data_ptr(), n, h, w, k, _stream(cmax))
    _build.check(rc, "spatial_logits")
    spatial_logits.launches += 1
    return logits


def cac_apply(out, out_c, inputs, inputs_c, gate, sp_logits, dst=None):
    """Kernel-backed `cac_apply_plain` -> (new_out, new_out_c). The four
    inputs may be channel windows of one pitch, and dst a pair of windows
    of another (both written in the one pass, `codon::cac_apply_into`)."""
    _check_device(out)
    if dst is None:
        return torch.ops.codon.cac_apply(out, out_c, inputs, inputs_c, gate,
                                         sp_logits)
    torch.ops.codon.cac_apply_into(out, out_c, inputs, inputs_c, gate,
                                   sp_logits, *dst)
    return tuple(dst)


def _cac_apply_cuda(out, out_c, inputs, inputs_c, gate, sp_logits,
                    dst=None):
    """The CUDA implementation of `codon::cac_apply` and, with dst,
    `codon::cac_apply_into`."""
    in_pitch = _check_towers(out, out_c, inputs, inputs_c)
    n, h, w, c = out.shape
    _check_plane(gate, (n, 1, c), torch.float32, out.device, "gate")
    _check_plane(sp_logits, out.shape[:3], out.dtype, out.device,
                 "sp_logits")
    if dst is None:
        new_out = torch.empty_like(out, memory_format=torch.contiguous_format)
        new_out_c = torch.empty_like(new_out)
    else:
        new_out, new_out_c = dst
    out_pitch = _check_towers(new_out, new_out_c)
    _need(new_out.shape == out.shape and new_out.dtype == out.dtype
          and new_out.device == out.device,
          "dst: expected towers of the inputs' shape, dtype and device")
    lib = _build.load()
    with torch.cuda.device(out.device):
        rc = lib.codon_cac_apply(
            _DTYPE_CODES[out.dtype], out.data_ptr(), out_c.data_ptr(),
            inputs.data_ptr(), inputs_c.data_ptr(), gate.data_ptr(),
            sp_logits.data_ptr(), new_out.data_ptr(), new_out_c.data_ptr(),
            n, h, w, c, in_pitch, out_pitch, _stream(out))
    _build.check(rc, "cac_apply")
    cac_apply.launches += 1
    return new_out, new_out_c


KERNELS = (cac_stats, spatial_logits, cac_apply)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# calls of the composed stage on whole images ("whole") and on a spatial
# shard with its statistics pooled over the group ("shard"), on any device
_STAGE_CALLS = {"whole": 0, "shard": 0}


def reset_stage_calls() -> None:
    for k in _STAGE_CALLS:
        _STAGE_CALLS[k] = 0


def stage_calls() -> dict:
    """{"whole", "shard"}: `cac_stage` calls since the last reset, without
    and with a group. A sharded forward must make no "whole" call: one
    shard's pools would be finite, plausible and wrong."""
    return dict(_STAGE_CALLS)


# ---------------------------------------------------------------------------
# the composed stage
# ---------------------------------------------------------------------------

def cac_stage(out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w, mask=None,
              dst=None, group=None):
    """One CAC stage through the three kernels -> (new_out, new_out_c),
    written into `dst` (a pair of tower views) when it is given.

    As `codon_tpu.kernels.cac.cac_stage_pallas`: stats; avg = sum / (valid
    pixel count, or H*W); the shared MLP 128 -> 8 -> 64 on avg and max,
    summed before the sigmoid (float32, in PyTorch); logits; apply. With a
    mask (N,H,W,1) the towers must already be zero on padding, as masked
    convs leave them.

    group: the sp process group when the towers are one spatial shard of
    the image (`parallel.ops.ShardedOps`), whose statistics pool over every
    shard: one all_sum of [channel sums | valid-pixel count], an all_max of
    the channel maxes, and 2 halo rows of the pooled maps from each
    neighbour (zero rows at the image's top and bottom, the stencil's own
    SAME padding) for `spatial_logits`, cropped to the shard's rows. None:
    the towers hold whole images.
    """
    n, h, w, c = out.shape
    _STAGE_CALLS["whole" if group is None else "shard"] += 1
    ch_sum, ch_max, cmax, cmean = cac_stats(out, out_c, mask)
    if mask is not None:
        denom = mask.float().sum((1, 2, 3))[:, None, None]
    elif group is not None:
        denom = ch_sum.new_full((n, 1, 1), float(h * w))
    else:
        denom = float(h * w)
    if group is not None:
        from codon_tpu_torch.parallel.comm import all_max, all_sum, halo_rows
        both = all_sum(torch.cat([ch_sum, denom], -1), group)
        ch_sum, denom = both[..., :-1], both[..., -1:]
        ch_max = all_max(ch_max, group)
    avg = ch_sum / denom

    def mlp(v):
        hid = torch.relu(v @ w1.float() + b1.float())
        return hid @ w2.float() + b2.float()

    gate = torch.sigmoid(mlp(avg) + mlp(ch_max)).contiguous()   # (N,1,C)
    if group is None:
        sp = spatial_logits(cmax, cmean, sp_w)
    else:
        r = (sp_w.shape[0] - 1) // 2
        planes = halo_rows(torch.stack([cmax, cmean], -1), r, group)
        sp = spatial_logits(planes[..., 0].contiguous(),
                            planes[..., 1].contiguous(),
                            sp_w)[:, r:r + h].contiguous()
    return cac_apply(out, out_c, inputs, inputs_c, gate, sp, dst)


class CacStageFunction(torch.autograd.Function):
    """`cac_stage` (no `dst`) with a gradient: the training forward's stage.

    forward: the three kernels, exactly as `cac_stage` (their plain
    versions on CPU tensors); the inputs are saved. backward: the stage
    recomputed from the saved inputs in the plain PyTorch form the JAX
    package differentiates (`models.codon_net.cac_stage_torch`, the
    activation dtype throughout), and `torch.autograd.grad` of it. Its
    `amax` / `maximum` share the gradient evenly among tied maxima, as
    `jnp.max` / `jnp.maximum` do. The mask gets no gradient. No kernel
    runs in the backward.

    group: None for whole images; the sp group when the towers are one
    spatial shard. The forward is then `cac_stage(..., group=group)`, its
    statistics all-reduced over the group, and the backward recomputes
    the stage under `parallel.ops.ShardedOps` over the same group, whose
    differentiable collectives (`parallel.comm`: the pools' all_sum, the
    channel maxes' global max, the pooled maps' 2-row halo) run forward
    again in the recompute and transposed in its gradient.

    apply(out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w, mask,
          group=None) -> (new_out, new_out_c)
    """

    @staticmethod
    def forward(ctx, out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w,
                mask, group=None):
        ctx.save_for_backward(out, out_c, inputs, inputs_c, w1, b1, w2, b2,
                              sp_w, mask)
        ctx.group = group
        return cac_stage(out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w,
                         mask, group=group)

    @staticmethod
    def backward(ctx, g_out, g_out_c):
        from codon_tpu_torch.models.codon_net import cac_stage_torch
        ops = None
        if ctx.group is not None:
            from codon_tpu_torch.parallel.ops import ShardedOps
            ops = ShardedOps(group=ctx.group)
        *xs, mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(xs)]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(xs, need)]
            new = cac_stage_torch(*xs, mask=mask, ops=ops)
            grads = iter(torch.autograd.grad(
                new, [x for x, n in zip(xs, need) if n], (g_out, g_out_c)))
        return (*(next(grads) if n else None for n in need), None, None)
