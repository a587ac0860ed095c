#!/usr/bin/env python3
"""Drive the PyTorch port (codon_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It
  1. prints the card's name and power limit as nvidia-smi gives them;
  2. builds the CUDA kernels from codon_tpu_torch/kernels/csrc with nvcc,
     and prints each kernel's registers, static shared memory and spills
     as ptxas reported them, on one line;
  3. holds each kernel against its plain PyTorch version on the card, in
     float32, bfloat16 and float16, at the main path's shape (batch 4,
     384 x 480 padded, a mask marking 370 x 463 valid, C = 64), at an odd
     shape (2 x 37 x 29, one image half masked) and at the TTA8 path's two
     shapes (16 x 384 x 480, and 16 x 480 x 384 transposed, the masks
     flipped to each corner as the 4 flips place them), spatial_logits
     bitwise; times the kernel, the plain version and, where one exists, a
     single PyTorch call computing the same function, with CUDA events after
     a warmup; and takes each kernel's device time a launch at the main and
     TTA8 shapes from a CUDA graph of back-to-back calls (spatial_logits'
     also at one output tile and at one image, and F.conv2d's too); then
     holds the int8 conv's two kernels, quant_im2col (float32, bfloat16 and
     int8 input; per-channel, per-image and no scale; k 1, 3 and 5) and
     dequant_epilogue (float32, bfloat16 and float16; static and dynamic;
     with and without the mask), bitwise against their plain versions at
     the same four shapes, and times each at the int8 forward's shapes at
     batch 4 (wrapper, plain version, device time a launch from a CUDA
     graph, byte bound), with torch._int_mm's GEMM between them;
  4. runs `python -m codon_tpu_torch.cli eval` in-process, in bfloat16 at
     batch 4, with checkpoints/x4_ship4.npz, on a synthetic Middlebury-shaped
     scale directory (6 images of 463 x 370, 2 of 450 x 375, written with the
     port's own PNG writer), with the kernels' launch counters set to 0 just
     before and read just after; then runs the same eval again in the same
     process, to time it without the first batch's set-up;
  5. runs one float32 forward of the first batch through the kernels and
     through the plain PyTorch stage, and one small float32 forward on the
     card against the same forward on the CPU;
  6. holds the three copy kernels of the HBM copy probe against the
     identity, bitwise, at both of the probe's tiles, at its shape
     (32, 370, 463, 64) bf16 and at (3, 37, 29, 64), each writing into the
     middle of a sentinel-filled buffer whose sentinel must stay intact;
  7. times each copy kernel at both of its tiles, its plain version and
     x.clone() at the probe's shape, with each kernel's design (a ring of
     bulk copies over a persistent grid), grid and chunk size;
  8. runs the probe's sweep (`perf_copy_probe.main`), its RESULT lines
     printed, with the copy kernels' launch counters set to 0 just before
     and read just after, and prints the measured copy ceiling as a share
     of the nominal 3.35 TB/s;
  9. runs `cli eval --tta8 --device-metrics` (bf16, batch 4) on the same
     scale dir with the CAC counters set to 0 just before and read just
     after, holds the card's RMSE and SSIM against the host metrics on the
     PNGs it wrote and against the same tensor metrics on the CPU, and
     runs it again warm, with device and with host metrics, for the rates;
 10. runs float32 TTA8 of the first batch through the kernels and through
     the plain stage;
 11. builds a 2-member `--tta` ensemble (x4_ship4 + x4_holdout2) through
     the cli's own forward and holds it in float32 against the mean of
     its members, then runs it as `cli eval` in bf16 with the CAC counters
     set to 0 just before and read just after;
 12. runs the float32 int8 forward of x4_ship4_qat_static.npz on the first
     batch through the quant kernels and through their plain versions (the
     CAC kernels in both, cuDNN deterministic): bitwise; and one small
     float32 int8 forward on the card against the CPU, in the flip class;
 13. runs `cli eval --dtype int8` (bf16, batch 4) with x4_ship4_qat_static
     with the CAC and quant counters set to 0 just before and read just
     after, then again warm;
 14. runs `cli eval --dtype int8 --tta8 --device-metrics` with the same
     counters and the bf16 TTA8 phase's metric checks;
 15. builds a static + dynamic int8 ensemble (x4_ship4_qat_static +
     x4_ship4_qat) with --tta through the cli's own forward and holds it
     against the mean of its members, then runs it as `cli eval` with the
     counters;
 16. writes x4_ship4.npz as the reference's .pth three ways (a state
     dict; {"epoch", "model"} with DataParallel's module. prefix; a pickled
     stand-in module) and runs `cli eval --ckpt` on each, the CAC counters
     set to 0 just before and read just after each: the same PNGs and
     metrics as the .npz eval, bit for bit (cuDNN deterministic);
 17. runs `cli convert` on each .pth: x4_ship4.npz's arrays again;
 18. runs `cli eval --variant codon_fused` (the merged-tower forward: the
     CAC kernels on the halves of one (N, H, W, 2C) tensor), then with
     --tta8 --device-metrics, with the CAC counters, and the fp32 fused
     forward of the first batch through the kernels against its plain
     stage and against the packed forward;
 19. runs the fp32 int8 fused forward, the quant kernels against their
     plain versions: bitwise;
 20. runs `cli eval --variant codon_fused --dtype int8` (its grouped int8
     convs: a quantize and a windowed gather, GEMM and epilogue a group)
     with the CAC and quant counters;
 21. runs `cli eval --variant rmcr_fuse_rmcr` in bf16 (no CAC launch) and
     int8, with the counters;
 22. runs `cli eval --resume` twice (the second writes the all-done stub),
     `--profile`, `--check-nans` on a checkpoint with one NaN weight (it
     must raise FloatingPointError naming the site), `golden` on the main
     eval's PNGs and `info`;
 23. prints the card's line again, the kernels' JSON line (eight kernels),
     then the contract line {"ok": true, "device": {...}} as the last line
     of its output.

Phase 3 also holds cac_stats and cac_apply against their plain versions
on the halves of a (N, H, W, 2C) tensor (a tower pitch of 2C) at the main
and TTA8 shapes, and quant_im2col and dequant_epilogue on each group's
channel and output window at every grouped shape of the b4 codon_fused
forward, bitwise, each timed beside the contiguous kernel.

Any failed check raises: the script then exits non-zero and prints no
result. It also exits non-zero, printing nothing on stdout, without a CUDA
device or outside a checkout.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "x4_ship4.npz")
# the ensemble's second member: a holdout-trained checkpoint of variant codon
CKPT2 = os.path.join(REPO, "checkpoints", "x4_holdout2.npz")
# the static-int8 deployment: QAT weights with 18 calibrated act_scales
# sites, and the same weights' dynamic-scale sibling (no act_scales)
CKPT_INT8 = os.path.join(REPO, "checkpoints", "x4_ship4_qat_static.npz")
CKPT_INT8_DYN = os.path.join(REPO, "checkpoints", "x4_ship4_qat.npz")

# H100 SXM peaks (NVIDIA's data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12        # outside the tensor cores
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core operations
# fp32 instructions a second: an FMA counts as 2 flops, a lone multiply or
# add is one instruction all the same
FP32_INSNS_PER_S = FP32_FLOPS_PER_S / 2
# spatial_logits rounds each of a tap's 2 multiplies and 2 adds on its own
LOGIT_INSNS_PER_TAP = 4
GRAPH_CALLS = 20            # back-to-back calls in a device-time graph

# kernel-against-plain tolerances, |kernel - plain| <= atol + rtol * |plain|:
# float32 as tests/test_kernels.py holds the Pallas kernels (only the order
# of float32 sums differs); bfloat16 and float16 two ulps of their 8- and
# 11-bit significands (a pooled mean or a gate value rounded once to the
# activation type may land one ulp apart when its float32 value differs in
# the last bits), with the same amount as atol for values near zero. The
# channel sums and maxes of cac_stats are float32 results over the same
# rounded inputs in every activation type, so they are held at the float32
# tolerance whatever that type is.
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -6, 2 ** -6),
        "float16": (2 ** -9, 2 ** -9)}
# float32 forward, kernels against the plain stage: TF32 off, only the
# order of float32 sums differs
FWD_TOL = 1e-4
# float32 forward on the card against the CPU: the model-parity tolerance
# of tests/test_model_parity.py (cuDNN and the CPU sum in other orders)
CPU_TOL = 5e-4

# TTA8 eval on the card with --device-metrics: RMSE against the host's
# on the written PNGs within 1e-3 (tests/test_metrics.py: float32 on the
# card); SSIM within 0.03, the JAX package's documented bound for the
# normalized-convolution border of padded images (tests/test_metrics.py);
# the same tensor metrics on the CPU on the same bytes within 1e-5 (float32
# on both sides, sums in another order)
RMSE_HOST_TOL = 1e-3
SSIM_HOST_TOL = 0.03
METRIC_CPU_TOL = 1e-5

DEVICE = "cuda"
MAIN_SHAPE = (4, 384, 480, 64)
MAIN_VALID = [(370, 463)] * 4
ODD_SHAPE = (2, 37, 29, 64)
ODD_VALID = [(37, 29), (19, 15)]


def tta_valid(sizes):
    """The valid region (h, w, flipped down, flipped right) of each image
    of a batched TTA forward over a batch of the given sizes: the flips id,
    V, H, HV of `models/tta.py`, each over the whole batch."""
    return [(h, w, fv, fh) for fv, fh in ((0, 0), (1, 0), (0, 1), (1, 1))
            for h, w in sizes]


# where the TTA8 eval of the main path gives the CAC kernels their inputs:
# a batch of 4 (the synthetic dir's second batch holds both scene sizes)
# as the 4 flips at 384 x 480, then transposed at 480 x 384
TTA_SIZES = [(370, 463)] * 2 + [(375, 450)] * 2
TTA_SHAPE = (16, 384, 480, 64)
TTA_VALID = tta_valid(TTA_SIZES)
TTA_T_SHAPE = (16, 480, 384, 64)
TTA_T_VALID = tta_valid([(w, h) for h, w in TTA_SIZES])
STAGE_CASES = ((MAIN_SHAPE, MAIN_VALID), (ODD_SHAPE, ODD_VALID),
               (TTA_SHAPE, TTA_VALID), (TTA_T_SHAPE, TTA_T_VALID))
# the copy probe's shape (scripts/perf_pallas_probe.py), bf16, and a small
# one whose last tile is ragged for every tile; (name, view, the two tiles
# of the probe's sweep) for each kernel
PROBE_SHAPE = (32, 370, 463, 64)
RAGGED_COPY_SHAPE = (3, 37, 29, 64)
COPY_KERNELS = (("copy4d", "4d", (64, 128)), ("copyflat", "flat", (64, 8)),
                ("copy3d", "3d", (512, 64)))
COPY_SENTINEL = -7.0        # the inputs lie in [0, 1)
COPY_ITERS = 50             # timed calls a copy line, ~25 ms of copying
COPY_GUARD = 4096           # sentinel elements before and after the output
# the synthetic scale dir: Middlebury's 463 x 370 and a second size that
# pads to the same 480 x 384
SCENES = [(370, 463)] * 6 + [(375, 450)] * 2
# a whole int8 forward, card against CPU at 37 x 29: the flip class of
# tests/test_torch_quant.py (one int8 code that flips at a rounding
# boundary cascades; JAX's static int8 forward moves by mean 0.0028 / max
# 0.036 when its input moves by 1e-6): mean |d| <= 0.01, max <= 0.1
INT8_CPU_BOUNDS = (0.01, 0.1)
# the quantized conv calls of one forward, (k, C_in, calls): conv_input(_c),
# packed_d/c x 5, conv3/conv6 x 5, confuse(_c) x 5, conv7, packed_f x 3,
# conv10 x 3, confuse_fuse x 3, conv11
INT8_CONVS = ((3, 64, 2), (5, 64, 10), (5, 128, 10), (1, 128, 10),
              (3, 128, 1), (5, 64, 3), (5, 128, 3), (1, 128, 3), (3, 64, 1))
# the static backend's handoffs of one forward, each a quant_im2col call
# at k = 1: 13 precommits (packed_d and packed_c before each of the 5
# stages, packed_f before each of the 3 fuse stages) and 13 roundtrips
# (the 2 stems, the 2 gates of each of the 5 stages, conv7's output)
INT8_HANDOFFS = 26
# the quantized conv calls of one codon_fused forward, (k, C_in, groups,
# C_out, calls): the grouped conv_input+conv_input_c, then conv1+conv5,
# conv2+conv4, conv3+conv6 and confuse+confuse_c in each of the 5 stages;
# conv7, conv8, conv9, conv10 and confuse_fuse x 3, conv11 ungrouped. The
# merged-tower forward has no handoffs.
FUSED_INT8_CONVS = ((3, 128, 2, 128, 1), (3, 128, 2, 128, 5),
                    (5, 128, 2, 128, 5), (5, 256, 2, 256, 5),
                    (1, 256, 2, 128, 5), (3, 128, 1, 64, 1),
                    (5, 64, 1, 64, 3), (3, 64, 1, 64, 3), (5, 128, 1, 128, 3),
                    (1, 128, 1, 64, 3), (3, 64, 1, 64, 1))
# fp32 merged-tower forward against the packed one on the card: the
# tolerance tests/test_model_parity.py holds the JAX package's two forms to
FUSED_TOL = (2e-4, 1e-3)
# the three forms of a reference .pth that phase 16 writes
PTH_KINDS = ("state_dict", "epoch_model_module_prefix", "full_module")
# file:line of each kernel's pallas_call
REPLACES = {"cac_stats": "codon_tpu/kernels/cac.py:143",
            "spatial_logits": "codon_tpu/kernels/cac.py:193",
            "cac_apply": "codon_tpu/kernels/cac.py:239",
            "copy4d": "scripts/perf_pallas_probe.py:65",
            "copyflat": "scripts/perf_pallas_probe.py:75",
            "copy3d": "scripts/perf_pallas_probe.py:85",
            "quant_im2col": "no Pallas source: XLA's fused int8 quantize / "
                            "conv epilogue, codon_tpu/quant_ops.py:103-131, "
                            "346-370",
            "dequant_epilogue": "no Pallas source: XLA's fused int8 quantize "
                                "/ conv epilogue, codon_tpu/quant_ops.py:"
                                "103-131, 346-370"}


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Failed(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_mask(shape, valid):
    """(N, H, W, 1) float32 validity mask. valid: per image (h, w) at the
    top left, or (h, w, flipped down, flipped right)."""
    import torch
    n, h, w = shape[:3]
    mask = torch.zeros((n, h, w, 1), device=DEVICE)
    for i, (vh, vw, *flip) in enumerate(valid):
        fv, fh = flip or (0, 0)
        rows = slice(h - vh, h) if fv else slice(0, vh)
        cols = slice(w - vw, w) if fh else slice(0, vw)
        mask[i, rows, cols] = 1.0
    return mask


def make_stage_inputs(shape, valid, dtype, seed):
    """Towers zero on padding, as masked convs leave them; valid as in
    `make_mask`."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mask = make_mask(shape, valid)
    towers = [torch.randn(shape, generator=g, device=DEVICE) * mask
              for _ in range(4)]
    gate = torch.rand((n, 1, c), generator=g, device=DEVICE)
    sp_w = torch.randn((5, 5, 2, 1), generator=g, device=DEVICE) * 0.2
    logits = torch.randn((n, h, w), generator=g, device=DEVICE)
    return ([t.to(dtype).contiguous() for t in towers], mask.to(dtype),
            gate, sp_w, logits.to(dtype))


def max_err(got, want, atol, rtol):
    """-> (max |got - want|, whether every element is within tolerance)."""
    import torch
    err, ok = 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        err = max(err, float(d.max()))
        ok = ok and bool(torch.all(d <= atol + rtol * w.abs()))
    return err, ok


def check_kernels(kc):
    """Every kernel and dtype at every shape a driven path gives it, masks
    placed as that path places them: -> {name: [check, ...]}."""
    import torch
    checks = {k: [] for k in ("cac_stats", "spatial_logits", "cac_apply")}
    seed = 0
    for dname, (atol, rtol) in TOLS.items():
        dtype = getattr(torch, dname)
        for shape, valid in STAGE_CASES:
            seed += 1
            (out, out_c, inp, inp_c), mask, gate, sp_w, logits = \
                make_stage_inputs(shape, valid, dtype, seed)
            npix = shape[1] * shape[2]
            for m in (mask, None):
                got = kc.cac_stats(out, out_c, m)
                want = kc.cac_stats_plain(out, out_c, m)
                # the sums compared as means: the stage divides them by the
                # pixel count, and a float32 sum over n pixels carries
                # rounding that grows with n
                err_f32, ok_f32 = max_err(
                    (got[0] / npix, got[1]), (want[0] / npix, want[1]),
                    *TOLS["float32"])
                err, ok = max_err(got[2:], want[2:], atol, rtol)
                checks["cac_stats"].append(
                    {"dtype": dname, "shape": list(shape),
                     "mask": m is not None, "max_abs_err": max(err, err_f32),
                     "ok": ok and ok_f32})
            _, _, cmax, cmean = kc.cac_stats_plain(out, out_c, mask)
            got = kc.spatial_logits(cmax, cmean, sp_w)
            want = kc.spatial_logits_plain(cmax, cmean, sp_w)
            # the kernel rounds every multiply and add as the plain version
            # does, in its order: the same bits
            err, _ = max_err([got], [want], atol, rtol)
            same = torch.equal(got, want)
            checks["spatial_logits"].append(
                {"dtype": dname, "shape": list(shape), "max_abs_err": err,
                 "bitwise": same, "ok": same})
            err, ok = max_err(
                kc.cac_apply(out, out_c, inp, inp_c, gate, logits),
                kc.cac_apply_plain(out, out_c, inp, inp_c, gate, logits),
                atol, rtol)
            checks["cac_apply"].append(
                {"dtype": dname, "shape": list(shape), "max_abs_err": err,
                 "ok": ok})
    return checks


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 10) -> float:
    """Device time of one call of `fn`: `calls` back-to-back calls captured
    in a CUDA graph after a warm call (so the library is loaded and the
    allocator has its blocks), the graph replayed after a warmup and timed
    with CUDA events. No host time of a launch is in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound(nbytes, flops):
    """-> (least ms, "bytes" or "operations"): bytes over the memory rate
    or fp32 operations over the fp32 rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_rows(kc, shape, valid, seed):
    """Each CAC kernel at the stage shape `shape`, bfloat16 (the eval
    default): -> {name: {kern, plain, library (a call or None), shape (of
    the kernel's first input), bound (ms, by), floor (fp32 instruction
    floor ms, or None)}}."""
    import torch
    import torch.nn.functional as F
    n, h, w, c = shape
    dtype = torch.bfloat16
    (out, out_c, inp, inp_c), mask, gate, sp_w, logits = \
        make_stage_inputs(shape, valid, dtype, seed=seed)
    _, _, cmax, cmean = kc.cac_stats_plain(out, out_c, mask)
    s = out.element_size()
    nhw, nhwc = n * h * w, n * h * w * c
    k = sp_w.shape[0]
    stack = torch.stack([cmax, cmean], 1)                      # (N,2,H,W)
    w_conv = sp_w.permute(3, 2, 0, 1).to(dtype).contiguous()   # (1,2,k,k)
    return {
        "cac_stats": dict(
            kern=lambda: kc.cac_stats(out, out_c, mask),
            plain=lambda: kc.cac_stats_plain(out, out_c, mask),
            library=None, shape=list(shape), floor=None,
            # read both towers and the mask; write two maps and 2 x (N,2C)
            bound=bound(2 * nhwc * s + nhw * s + 2 * nhw * s
                        + 2 * n * 2 * c * 4,
                        # per element: channel sum + max, pixel sum + max
                        2 * nhwc * 4)),
        "spatial_logits": dict(
            kern=lambda: kc.spatial_logits(cmax, cmean, sp_w),
            plain=lambda: kc.spatial_logits_plain(cmax, cmean, sp_w),
            library=lambda: F.conv2d(stack, w_conv, padding=k // 2),
            shape=[n, h, w],
            bound=bound(3 * nhw * s + 2 * k * k * 4, nhw * 4 * k * k),
            floor=nhw * k * k * LOGIT_INSNS_PER_TAP / FP32_INSNS_PER_S * 1e3),
        "cac_apply": dict(
            kern=lambda: kc.cac_apply(out, out_c, inp, inp_c, gate, logits),
            plain=lambda: kc.cac_apply_plain(out, out_c, inp, inp_c, gate,
                                             logits),
            library=None, shape=list(shape), floor=None,
            # 4 tower reads, 2 writes, the logits and the gate
            bound=bound(6 * nhwc * s + nhw * s + n * c * 4,
                        # per element: gate x sigmoid, 2 multiplies, 2 adds
                        5 * nhwc)),
    }


def time_kernels(kc):
    """bfloat16 (the eval default). At the main-path shape: the wrapper's
    time over back-to-back calls, the plain version's and the library
    call's. At the main and both TTA8 shapes: the device time a launch
    (`graph_ms`), the library call's too. -> {name: timings}."""
    import torch
    out_rows = {}
    for shape, valid in (STAGE_CASES[0],) + STAGE_CASES[2:]:
        rows = kernel_rows(kc, shape, valid, seed=99)
        for name, r in rows.items():
            bound_ms, bound_by = r["bound"]
            lib = r["library"]
            if shape == MAIN_SHAPE:
                out_rows[name] = {
                    "ms": time_ms(r["kern"]), "plain_ms": time_ms(r["plain"]),
                    "library_ms": time_ms(lib) if lib is not None else None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "by_shape": []}
            by = {"shape": r["shape"], "device_ms": graph_ms(r["kern"]),
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None, "library_device_ms": None}
            if r["floor"] is not None:
                by["insn_floor_ms"] = r["floor"]
            if lib is not None:
                by["library_ms"] = time_ms(lib)
                by["library_device_ms"] = graph_ms(lib)
            out_rows[name]["by_shape"].append(by)
        del rows
        torch.cuda.empty_cache()
    for row in out_rows.values():
        row["device_ms"] = row["by_shape"][0]["device_ms"]
    out_rows["spatial_logits"]["small"] = logits_small(kc)
    return out_rows


def logits_small(kc):
    """spatial_logits' device time a launch where there is almost nothing
    to compute: one 64 x 32 output tile (a launch, one block's staging and
    drain) and one 384 x 480 image (one block on each of 72 SMs). ->
    [{shape, device_ms}]."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for shape in ((1, 32, 64), (1, 384, 480)):
        cmax, cmean = (torch.randn(shape, generator=g, device=DEVICE)
                       .to(torch.bfloat16) for _ in range(2))
        sp_w = torch.randn((5, 5, 2, 1), generator=g, device=DEVICE)
        rows.append({"shape": list(shape), "device_ms": graph_ms(
            lambda: kc.spatial_logits(cmax, cmean, sp_w))})
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def write_scale_dir(root: str, seed: int = 0):
    """A Middlebury-shaped scale dir: smooth piecewise-planar ground truth,
    its x4 box-down / nearest-up degradation as the depth input, and a
    textured guidance image that shares the depth edges."""
    import numpy as np
    from codon_tpu_torch.data.io import imwrite_gray
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(SCENES):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        label = 60 + 120 * (xx / w) + 40 * (yy / h)
        for _ in range(6):
            y0, x0 = rng.randint(0, h * 7 // 8), rng.randint(0, w * 7 // 8)
            label[y0:y0 + rng.randint(h // 16, h // 3),
                  x0:x0 + rng.randint(w // 16, w // 3)] = rng.uniform(30, 250)
        label = np.clip(label, 1, 255).astype(np.uint8)
        hs, ws = h // 4 * 4, w // 4 * 4
        low = label[:hs, :ws].reshape(hs // 4, 4, ws // 4, 4).mean((1, 3))
        depth = label.copy()
        depth[:hs, :ws] = np.repeat(np.repeat(low, 4, 0), 4, 1)
        color = np.clip(label.astype(np.float64) * 0.6 +
                        rng.normal(0, 20, (h, w)) + 40, 0, 255)
        name = f"scene{i}.png"
        imwrite_gray(os.path.join(root, "input_depth", name), depth)
        imwrite_gray(os.path.join(root, "input_color", name),
                     color.astype(np.uint8))
        imwrite_gray(os.path.join(root, "input_label", name), label)
    return len(SCENES)


def eval_once(data: str, out: str, jpath: str, batch: int, extra=(),
              ckpt: str = CKPT, dtype: str = "bf16", variant: str = "codon"):
    """One in-process `cli eval`, bf16 (or `dtype`) -> (summary, wall
    seconds)."""
    from codon_tpu_torch import cli
    t0 = time.time()
    rc = cli.main(["eval", "--scale", "4", "--data-dir", data,
                   "--ckpt", ckpt, "--variant", variant, "--batch",
                   str(batch), "--dtype", dtype, "--out", out,
                   "--json", jpath, "--device", DEVICE, *extra])
    wall = time.time() - t0
    need(rc == 0, f"cli eval returned {rc}")
    with open(jpath) as f:
        return json.load(f), wall


def run_main_path(kc, tmp: str):
    data = os.path.join(tmp, "CODON_X4")
    n_images = write_scale_dir(data)
    batch = 4
    kc.reset_launches()
    summary, wall = eval_once(data, os.path.join(tmp, "out"),
                              os.path.join(tmp, "eval.json"), batch)
    counts = kc.launches()
    need(summary["images"] == n_images and
         len(summary["per_image"]) == n_images,
         f"eval scored {len(summary['per_image'])} of {n_images} images")
    for key in ("mean_rmse", "mean_ssim"):
        need(summary[key] is not None and math.isfinite(summary[key]),
             f"{key} is not finite: {summary[key]}")
    for row in summary["per_image"]:
        need(math.isfinite(row["rmse"]) and math.isfinite(row["ssim"]),
             f"non-finite metric for {row['name']}")
    outs = sorted(os.listdir(os.path.join(tmp, "out")))
    need(len(outs) == n_images, f"{len(outs)} output PNGs, {n_images} "
         f"images")
    batches = -(-n_images // batch)
    for name, count in counts.items():
        need(count == 5 * batches,
             f"{name} launched {count} times in {batches} forward batches; "
             f"expected {5 * batches} (5 CAC stages a forward)")
    # the same eval again in this process: cuDNN's and the kernels'
    # first-call set-up is paid, so its end-to-end rate is the forward plus
    # the host layers (PNG decode and writes, RMSE, SSIM)
    warm, _ = eval_once(data, os.path.join(tmp, "out_warm"),
                        os.path.join(tmp, "eval_warm.json"), batch)
    need(warm["images"] == n_images and
         all(math.isfinite(warm[k]) for k in ("mean_rmse", "mean_ssim")),
         "the warm eval did not score every image")
    return summary, warm, counts, wall, data


# ---------------------------------------------------------------------------
# phase 5: paths against each other
# ---------------------------------------------------------------------------

def compare_paths(data: str):
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.data.io import discover_pairs, load_sample
    from codon_tpu_torch.data.pipeline import make_batch
    from codon_tpu_torch.models.codon_net import CodonConfig, codon_forward

    tree = load_npz(CKPT)
    params = params_from_numpy(tree, DEVICE)
    names = discover_pairs(data)[:4]
    b = make_batch([load_sample(data, n) for n in names], 32, DEVICE,
                   fixed_hw=MAIN_SHAPE[1:3])
    cfg = CodonConfig(dead_heads=True)
    kern = codon_forward(params, b.depth, b.color, mask=b.mask,
                         cfg=dataclasses.replace(cfg, cac_impl="kernel"))
    plain = codon_forward(params, b.depth, b.color, mask=b.mask,
                          cfg=dataclasses.replace(cfg, cac_impl="torch"))
    need(bool(torch.isfinite(kern).all()), "non-finite fp32 forward")
    d_paths = float((kern - plain).abs().max())
    need(d_paths <= FWD_TOL, f"fp32 forward, kernels vs plain stage: max "
         f"abs diff {d_paths} > {FWD_TOL}")

    g = torch.Generator().manual_seed(1)
    d = torch.rand((1, 37, 29, 1), generator=g)
    c = torch.rand((1, 37, 29, 1), generator=g)
    on_card = codon_forward(params, d.to(DEVICE), c.to(DEVICE),
                            cfg=cfg).cpu()
    on_cpu = codon_forward(params_from_numpy(tree, "cpu"), d, c, cfg=cfg)
    d_cpu = float((on_card - on_cpu).abs().max())
    need(d_cpu <= CPU_TOL, f"fp32 forward, card vs CPU: max abs diff "
         f"{d_cpu} > {CPU_TOL}")
    return d_paths, d_cpu


# ---------------------------------------------------------------------------
# phases 6-8: the copy kernels of the HBM copy probe
# ---------------------------------------------------------------------------

def check_copies(kcopy, probe):
    """Every copy kernel at both of the probe's tiles, at the probe's shape
    and at a small ragged one: the output, written into the middle of a
    sentinel-filled buffer, equals the input bitwise, and the sentinel
    around it is untouched. -> [check, ...]."""
    import torch
    rows = []
    for shape in (PROBE_SHAPE, RAGGED_COPY_SHAPE):
        g = torch.Generator(device=DEVICE).manual_seed(7)
        x4 = torch.rand(shape, generator=g, device=DEVICE).to(torch.bfloat16)
        buf = torch.empty(x4.numel() + 2 * COPY_GUARD, dtype=x4.dtype,
                          device=DEVICE)
        for name, kind, tiles in COPY_KERNELS:
            x = probe.view(x4, kind)
            fn = getattr(kcopy, name)
            for tile in tiles:
                buf.fill_(COPY_SENTINEL)
                out = buf[COPY_GUARD:COPY_GUARD + x.numel()].view(x.shape)
                fn(x, tile, out=out)
                torch.cuda.synchronize()
                same = torch.equal(out.view(torch.int16), x.view(torch.int16))
                guard = bool((buf[:COPY_GUARD] == COPY_SENTINEL).all()) and \
                    bool((buf[COPY_GUARD + x.numel():] ==
                          COPY_SENTINEL).all())
                rows.append({"name": name, "shape": list(x.shape),
                             "tile": tile,
                             **copy_layout(kcopy, kind, x, tile),
                             "max_abs_err": float((out.float() - x.float())
                                                  .abs().max()),
                             "ok": same and guard, "bitwise": same,
                             "guard": guard})
        del x4, buf
    return rows


def copy_layout(kcopy, kind, x, tile):
    """How a copy kernel cuts its view x at `tile`: -> {design, grid,
    chunk_bytes, chunks}."""
    m = kcopy.chunk_map(kind, x.shape, tile, x.element_size())
    return {"design": "bulk_ring", "grid": kcopy.ring_grid(),
            "chunk_bytes": m.chunk_bytes, "chunks": m.chunks}


def time_copies(kcopy, probe):
    """Each copy kernel at both of its tiles of the sweep, at the probe's
    shape, beside its plain version and x.clone(): -> {name: timings}, the
    first tile's numbers at the top and every tile's under "by_tile"."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(8)
    x4 = torch.rand(PROBE_SHAPE, generator=g, device=DEVICE).to(
        torch.bfloat16)
    nbytes = 2 * x4.numel() * x4.element_size()          # read + write
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for name, kind, tiles in COPY_KERNELS:
        x = probe.view(x4, kind)
        fn = getattr(kcopy, name)
        dst = torch.empty_like(x)
        clone_ms = time_ms(lambda: x.clone(), iters=COPY_ITERS)
        by_tile = []
        for tile in tiles:
            ms = time_ms(lambda: fn(x, tile, out=dst), iters=COPY_ITERS)
            by_tile.append({"tile": tile, "ms": ms,
                            "gb_per_s": nbytes / ms / 1e6,
                            "of_clone": clone_ms / ms,
                            **copy_layout(kcopy, kind, x, tile)})
        out[name] = {
            **by_tile[0], "by_tile": by_tile,
            "plain_ms": time_ms(lambda: kcopy.copy_plain(x, dst),
                                iters=COPY_ITERS),
            "library_ms": clone_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}
    return out


def layout_text(r) -> str:
    return (f"{r['design']}, grid {r['grid']}, {r['chunks']} chunks of "
            f"{r['chunk_bytes']} B")


def ptxas_text(usage: dict, ring_bytes: int) -> str:
    """One line of ptxas' report: registers, static shared memory and
    spills of each kernel."""
    parts = []
    for name, u in sorted(usage.items()):
        extra = (f" + {ring_bytes} B dynamic ring"
                 if "ring_copy_kernel" in name else "")
        parts.append(f"{name} {u['registers']} regs {u['smem_bytes']} B "
                     f"smem{extra} {u['spill_bytes']} B spill")
    return "; ".join(parts)


def run_probe(kcopy, probe):
    """The probe's sweep through its entry point, with the copy kernels'
    counts set to 0 just before and read just after."""
    kcopy.reset_launches()
    rows = probe.main(["--device", DEVICE])
    counts = kcopy.launches()
    need(len(rows) == len(probe.SWEEP) and
         all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows),
         "the probe's sweep did not time every line")
    for name, count in counts.items():
        need(count > 0, f"{name} was not launched by the probe's sweep")
    return rows, counts


# ---------------------------------------------------------------------------
# phases 9-11: TTA, on-device metrics and ensembles
# ---------------------------------------------------------------------------

def padded(a, hw):
    """A 2-D uint8 image -> float32 (H, W) zero-padded to the batch shape
    hw, and its mask."""
    import numpy as np
    h, w = a.shape
    img = np.zeros(hw, np.float32)
    img[:h, :w] = a
    m = np.zeros(hw, np.float32)
    m[:h, :w] = 1.0
    return img, m


def check_device_metrics(summary, data: str, out: str):
    """The card's per-image RMSE and SSIM against (a) the host metrics on
    the PNGs the eval wrote and (b) the same tensor metrics run on the CPU
    on those bytes, padded and masked as the batch was. -> largest gaps."""
    import torch
    from codon_tpu_torch.data.io import imread_gray
    from codon_tpu_torch.metrics.rmse import masked_rmse, masked_rmse_torch
    from codon_tpu_torch.metrics.ssim import ssim_exact, ssim_exact_torch
    gaps = {"rmse_host": 0.0, "ssim_host": 0.0, "rmse_cpu": 0.0,
            "ssim_cpu": 0.0}
    for row in summary["per_image"]:
        img = imread_gray(os.path.join(out, row["name"] + ".png"))
        lab = imread_gray(os.path.join(data, "input_label",
                                       row["name"] + ".png"))
        gaps["rmse_host"] = max(gaps["rmse_host"],
                                abs(row["rmse"] - masked_rmse(lab, img)))
        gaps["ssim_host"] = max(gaps["ssim_host"], abs(
            row["ssim"] - ssim_exact(lab / 255, img / 255)))
        o, m = padded(img, MAIN_SHAPE[1:3])
        lb, _ = padded(lab, MAIN_SHAPE[1:3])
        o, m, lb = (torch.from_numpy(t)[None] for t in (o, m, lb))
        gaps["rmse_cpu"] = max(gaps["rmse_cpu"], abs(
            row["rmse"] - float(masked_rmse_torch(lb, o, m)[0])))
        gaps["ssim_cpu"] = max(gaps["ssim_cpu"], abs(
            row["ssim"] - float(ssim_exact_torch(lb / 255.0, o / 255.0,
                                                 mask=m)[0])))
    need(gaps["rmse_host"] < RMSE_HOST_TOL,
         f"card RMSE vs host RMSE on the PNGs: {gaps['rmse_host']}")
    need(gaps["ssim_host"] < SSIM_HOST_TOL,
         f"card SSIM vs host SSIM on the PNGs: {gaps['ssim_host']}")
    need(gaps["rmse_cpu"] <= METRIC_CPU_TOL and
         gaps["ssim_cpu"] <= METRIC_CPU_TOL,
         f"card metrics vs the same metrics on the CPU: {gaps}")
    return gaps


def run_tta_path(kc, data: str, tmp: str):
    """cli eval --tta8 --device-metrics, bf16, batch 4, with the CAC
    counts set to 0 just before and read just after; then the same eval
    warm, and warm with host metrics, for their rates."""
    batch = 4
    n_images = len(SCENES)
    out = os.path.join(tmp, "tta8_dm")
    kc.reset_launches()
    summary, wall = eval_once(data, out, os.path.join(tmp, "tta8_dm.json"),
                              batch, ["--tta8", "--device-metrics"])
    counts = kc.launches()
    need(summary["tta_transforms"] == 8, "the eval did not run TTA8")
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the TTA8 eval did not score every image")
    batches = -(-n_images // batch)
    for name, count in counts.items():
        need(count == 2 * 5 * batches,
             f"{name} launched {count} times in {batches} TTA8 batches; "
             f"expected {2 * 5 * batches} (2 forwards x 5 CAC stages)")
    gaps = check_device_metrics(summary, data, out)
    warm_dm, _ = eval_once(data, os.path.join(tmp, "tta8_dm2"),
                           os.path.join(tmp, "tta8_dm2.json"), batch,
                           ["--tta8", "--device-metrics"])
    warm_host, _ = eval_once(data, os.path.join(tmp, "tta8_host"),
                             os.path.join(tmp, "tta8_host.json"), batch,
                             ["--tta8"])
    need(all(r["rmse"] == w["rmse"] for r, w in
             zip(summary["per_image"], warm_dm["per_image"])),
         "the warm TTA8 eval scored differently")
    return summary, wall, counts, gaps, warm_dm, warm_host


def first_batch(data: str):
    from codon_tpu_torch.data.io import discover_pairs, load_sample
    from codon_tpu_torch.data.pipeline import make_batch
    names = discover_pairs(data)[:4]
    return make_batch([load_sample(data, n) for n in names], 32, DEVICE,
                      fixed_hw=MAIN_SHAPE[1:3])


def compare_tta_paths(data: str):
    """fp32 TTA8 on the first batch, through the kernels and through the
    plain stage -> max abs diff."""
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.codon_net import CodonConfig, codon_forward
    from codon_tpu_torch.models.tta import make_tta_forward
    params = params_from_numpy(load_npz(CKPT), DEVICE)
    b = first_batch(data)
    outs = []
    for impl in ("kernel", "torch"):
        cfg = CodonConfig(dead_heads=True, cac_impl=impl)
        tta = make_tta_forward(
            lambda p, d, c, m, cfg=cfg: codon_forward(p, d, c, mask=m,
                                                      cfg=cfg),
            transforms=8)
        outs.append(tta(params, b.depth, b.color, b.mask))
    need(bool(torch.isfinite(outs[0]).all()), "non-finite fp32 TTA8")
    diff = float((outs[0] - outs[1]).abs().max())
    need(diff <= FWD_TOL, f"fp32 TTA8, kernels vs plain stage: max abs diff "
         f"{diff} > {FWD_TOL}")
    return diff


def run_ensemble(kc, data: str, tmp: str):
    """A 2-member ensemble with --tta: (a) in fp32 on the first batch,
    through the cli's own forward, against the mean of the two members'
    TTA forwards; (b) `cli eval` in bf16, with the CAC counts set to 0 just
    before and read just after."""
    import torch
    from codon_tpu_torch import cli
    b = first_batch(data)

    def forward(ckpt):
        args = cli._build_argparser().parse_args(
            ["eval", "--ckpt", ckpt, "--tta", "--dtype", "fp32",
             "--device", DEVICE])
        ef = cli.make_eval_forward(args, torch.device(DEVICE))
        return ef, ef.fwd(ef.params, b.depth, b.color, b.mask)

    ef, ens = forward(f"{CKPT},{CKPT2}")
    need(ef.ensemble and ef.tta == 4, "the cli did not build a TTA ensemble")
    solo = [forward(c)[1] for c in (CKPT, CKPT2)]
    diff = float((ens - (solo[0] + solo[1]) / 2).abs().max())
    need(diff <= FWD_TOL, f"fp32 ensemble vs the mean of its members: max "
         f"abs diff {diff} > {FWD_TOL}")
    spread = float((solo[0] - solo[1]).abs().max())
    need(spread > 10 * FWD_TOL, f"the two members agree to {spread}: "
         f"the check could not tell them apart")

    kc.reset_launches()
    summary, wall = eval_once(data, os.path.join(tmp, "ens"),
                              os.path.join(tmp, "ens.json"), 4, ["--tta"],
                              ckpt=f"{CKPT},{CKPT2}")
    counts = kc.launches()
    batches = -(-len(SCENES) // 4)
    for name, count in counts.items():
        need(count == 2 * 5 * batches,
             f"{name} launched {count} times in the ensemble eval; expected "
             f"{2 * 5 * batches} (2 members x 5 CAC stages a batch)")
    need(all(math.isfinite(summary[k]) for k in ("mean_rmse", "mean_ssim")),
         "the ensemble eval's means are not finite")
    return diff, spread, summary, wall, counts


# ---------------------------------------------------------------------------
# phases 12-17: the static-int8 family
# ---------------------------------------------------------------------------

def quant_inputs(shape, valid, seed):
    """Activations (float32, x3 so the static grid clips some), their
    scales, a mask as the stage checks place it, and int32 products."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=DEVICE) * 3
    sc = torch.rand((c,), generator=g, device=DEVICE) * 0.05 + 0.005
    sx = torch.rand((n,), generator=g, device=DEVICE) * 0.05 + 0.005
    mask = make_mask(shape, valid)
    acc = torch.randint(-2 ** 20, 2 ** 20, (n * h * w, c), generator=g,
                        device=DEVICE, dtype=torch.int32)
    acc[::7] *= 2 ** 9          # sums past 2^24, where int32 -> f32 rounds
    sw = torch.rand((c,), generator=g, device=DEVICE) * 1e-3
    return x, sc, sx, mask, acc, sw


def check_quant_kernels(kq):
    """quant_im2col in float32, bfloat16 and int8 input, each scale mode,
    k 1, 3 and 5; dequant_epilogue in float32, bfloat16 and float16,
    static and dynamic, with and without the mask; at the main, odd and
    both TTA8 shapes; bitwise. -> {name: [check, ...]}."""
    import torch
    checks = {"quant_im2col": [], "dequant_epilogue": []}
    for i, (shape, valid) in enumerate(STAGE_CASES):
        x, sc, sx, mask, acc, sw = quant_inputs(shape, valid, 200 + i)
        for dname in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dname)
            xd = (kq.quantize_plain(x, sc) if dtype == torch.int8
                  else x.to(dtype).contiguous())
            modes = ([("none", None, None)] if dtype == torch.int8 else
                     [("channel", sc, None), ("sample", None, sx)])
            for mode, a, b in modes:
                for k in (1, 3, 5):
                    got = kq.quant_im2col(xd, k, a, b)
                    want = kq.quant_im2col_plain(xd, k, a, b)
                    same = torch.equal(got, want)
                    err = float((got.float() - want.float()).abs().max())
                    checks["quant_im2col"].append(
                        {"dtype": dname, "shape": list(shape), "k": k,
                         "mode": mode, "max_abs_err": err, "bitwise": same,
                         "ok": same})
                    del got, want
            del xd
        n, h, w, _ = shape
        for dname in ("float32", "bfloat16", "float16"):
            dtype = getattr(torch, dname)
            # float16 holds at most 65504: sums that stay below it
            a = (acc if dtype != torch.float16 else
                 torch.div(acc, 2 ** 14, rounding_mode="floor"))
            for mode, b in (("static", None), ("dynamic", sx)):
                for m in (mask.to(dtype), None):
                    got = kq.dequant_epilogue(a, sw, dtype, (n, h, w), b, m)
                    want = kq.dequant_epilogue_plain(a, sw, dtype,
                                                     (n, h, w), b, m)
                    same = torch.equal(got, want)
                    checks["dequant_epilogue"].append(
                        {"dtype": dname, "shape": list(shape), "mode": mode,
                         "mask": m is not None, "bitwise": same,
                         "max_abs_err": float((got.float() - want.float())
                                              .abs().max()),
                         "ok": same})
        del x, acc
        torch.cuda.empty_cache()
    return checks


def int8_launches(kq, n, h, w):
    """dequant_epilogue and GEMM launches of one int8 forward of n images
    at h x w: one a block of images at each quantized conv call. Each is
    also a quant_im2col launch; the static backend's handoffs add
    INT8_HANDOFFS more."""
    return sum(calls * len(kq.image_blocks(n, h, w, k * k * c))
               for k, c, calls in INT8_CONVS)


def time_quant(kq):
    """bf16 at the shapes of the int8 forward at batch 4, 384 x 480: each
    quant kernel's wrapper over back-to-back calls, its plain version, its
    device time a launch from a CUDA graph, and its byte bound, at each
    distinct shape of the main path; the int8 GEMM (torch._int_mm) over
    back-to-back calls at each. -> ({name: timings}, [gemm rows])."""
    import torch
    n, h, w = MAIN_SHAPE[:3]
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(300)
    mask = make_mask(MAIN_SHAPE, MAIN_VALID).to(bf)
    # (k, C_in, C_out, calls a forward, input): the quantized convs of one
    # forward grouped by shape; "int8" input is a precommitted packed site
    # the handoffs' quantize, k = 1 on 64 channels, has no GEMM (C_out 0)
    sites = ((3, 64, 64, 3, "bf16"), (5, 64, 128, 13, "int8"),
             (5, 128, 128, 13, "bf16"), (1, 128, 64, 13, "bf16"),
             (3, 128, 64, 1, "bf16"), (1, 64, 0, INT8_HANDOFFS, "bf16"))
    out = {"quant_im2col": {"by_shape": []},
           "dequant_epilogue": {"by_shape": []}}
    gemms = []
    for k, ci, co, calls, kind in sites:
        kk = k * k * ci
        blocks = kq.image_blocks(n, h, w, kk)
        nb = blocks[0][1] - blocks[0][0]
        x = torch.randn((nb, h, w, ci), generator=g, device=DEVICE) * 3
        sc = torch.rand((ci,), generator=g, device=DEVICE) * 0.05 + 0.005
        if kind == "int8":
            xin, a = kq.quantize_plain(x, sc), None
        else:
            xin, a = x.to(bf).contiguous(), sc
        rows = nb * h * w
        im_bytes = xin.numel() * xin.element_size() + rows * kk
        im_bound = bound(im_bytes, 0 if a is None else xin.numel())
        r = {"shape": [nb, h, w, ci], "k": k, "input": kind,
             "calls_a_forward": calls * len(blocks),
             "device_ms": graph_ms(lambda: kq.quant_im2col(xin, k, a)),
             "bound_ms": im_bound[0], "bound_by": im_bound[1]}
        out["quant_im2col"]["by_shape"].append(r)
        if not co:
            continue
        patches = kq.quant_im2col(xin, k, a)
        # column-major (K, N): cuBLASLt's int8 GEMM takes B so
        w8 = torch.randint(-127, 128, (co, kk), generator=g, device=DEVICE,
                           dtype=torch.int8).t()
        gemm_ms = time_ms(lambda: torch._int_mm(patches, w8))
        gb_bytes = rows * kk + kk * co + rows * co * 4
        gb = max(gb_bytes / HBM_BYTES_PER_S, 2 * rows * kk * co
                 / INT8_OPS_PER_S) * 1e3
        gemms.append({"m": rows, "k": kk, "n": co,
                      "calls_a_forward": calls * len(blocks),
                      "ms": gemm_ms, "bound_ms": gb,
                      "bound_by": ("bytes" if gb_bytes / HBM_BYTES_PER_S >=
                                   2 * rows * kk * co / INT8_OPS_PER_S
                                   else "operations")})
        acc = torch._int_mm(patches, w8)
        del patches
        sw = torch.rand((co,), generator=g, device=DEVICE) * 1e-3
        m = mask[:nb].contiguous()
        ep_bytes = rows * co * 4 + rows * 2 + rows * co * 2
        ep_bound = bound(ep_bytes, 3 * rows * co)
        e = {"shape": [nb, h, w, co], "calls_a_forward": calls * len(blocks),
             "device_ms": graph_ms(lambda: kq.dequant_epilogue(
                 acc, sw, bf, (nb, h, w), None, m)),
             "bound_ms": ep_bound[0], "bound_by": ep_bound[1]}
        out["dequant_epilogue"]["by_shape"].append(e)
        if (k, ci) == (5, 128):
            # the heaviest site (conv3, conv6, conv10): the row of record
            out["quant_im2col"].update(
                device_ms=r["device_ms"],
                ms=time_ms(lambda: kq.quant_im2col(xin, k, a)),
                plain_ms=time_ms(lambda: kq.quant_im2col_plain(xin, k, a),
                                 warmup=1, iters=5),
                bound_ms=im_bound[0], bound_by=im_bound[1],
                shape=[nb, h, w, ci], k=k)
            out["dequant_epilogue"].update(
                device_ms=e["device_ms"],
                ms=time_ms(lambda: kq.dequant_epilogue(acc, sw, bf,
                                                       (nb, h, w), None, m)),
                plain_ms=time_ms(lambda: kq.dequant_epilogue_plain(
                    acc, sw, bf, (nb, h, w), None, m)),
                bound_ms=ep_bound[0], bound_by=ep_bound[1],
                shape=[nb, h, w, co])
        del x, xin, acc
        torch.cuda.empty_cache()
    for name in out:
        rows = out[name]["by_shape"]
        # summed over the forward's calls: device ms a b4 forward
        out[name]["device_ms_a_forward"] = sum(
            r["device_ms"] * r["calls_a_forward"] for r in rows)
        out[name]["bound_ms_a_forward"] = sum(
            r["bound_ms"] * r["calls_a_forward"] for r in rows)
    return out, gemms


def static_int8_ops(dtype, impl=None):
    """Int8StaticOps on x4_ship4_qat_static's scales, on the card."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.quant_ops import Int8StaticOps
    scales = params_from_numpy(load_npz(CKPT_INT8)["act_scales"], DEVICE)
    return Int8StaticOps(scales, compute_dtype=dtype, quant_impl=impl)


def compare_int8_paths(data: str):
    """fp32 int8 forward of the first batch (x4_ship4_qat_static), the
    quant kernels against their plain versions, the CAC kernels in both,
    under cuDNN's deterministic mode: bitwise. Then card against CPU at 37
    x 29 in the flip class. -> (max |d| kernels vs plain, (mean, max) card
    vs CPU)."""
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.codon_net import CodonConfig, codon_forward
    tree = load_npz(CKPT_INT8)
    tree.pop("act_scales")
    params = params_from_numpy(tree, DEVICE)
    b = first_batch(data)
    cfg = CodonConfig(dead_heads=True, cac_impl="kernel")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = [codon_forward(params, b.depth, b.color, mask=b.mask, cfg=cfg,
                              ops=static_int8_ops(torch.float32, impl))
                for impl in (None, "plain")]
    finally:
        torch.backends.cudnn.deterministic = saved
    need(bool(torch.isfinite(outs[0]).all()), "non-finite fp32 int8 forward")
    d_paths = float((outs[0] - outs[1]).abs().max())
    need(torch.equal(outs[0], outs[1]), f"fp32 int8 forward, quant kernels "
         f"vs plain: max abs diff {d_paths}, not bitwise")

    from codon_tpu_torch.quant_ops import Int8StaticOps
    g = torch.Generator().manual_seed(2)
    d = torch.rand((1, 37, 29, 1), generator=g)
    c = torch.rand((1, 37, 29, 1), generator=g)
    cfg = CodonConfig(dead_heads=True)
    on_card = codon_forward(params, d.to(DEVICE), c.to(DEVICE), cfg=cfg,
                            ops=static_int8_ops(torch.float32)).cpu()
    cpu_scales = load_npz(CKPT_INT8)["act_scales"]
    on_cpu = codon_forward(params_from_numpy(tree, "cpu"), d, c, cfg=cfg,
                           ops=Int8StaticOps(cpu_scales))
    diff = (on_card - on_cpu).abs()
    d_cpu = (float(diff.mean()), float(diff.max()))
    need(d_cpu[0] <= INT8_CPU_BOUNDS[0] and d_cpu[1] <= INT8_CPU_BOUNDS[1],
         f"fp32 int8 forward, card vs CPU: mean {d_cpu[0]} max {d_cpu[1]}, "
         f"outside the flip class {INT8_CPU_BOUNDS}")
    return d_paths, d_cpu


def read_counts(kc, kq):
    return {**kc.launches(), **kq.launches()}


def reset_counts(kc, kq):
    kc.reset_launches()
    kq.reset_launches()


def need_int8_counts(counts, cac_want, conv_want, handoffs, what):
    """The CAC kernels cac_want launches each; the epilogue and the GEMM
    one a conv block, conv_want; quant_im2col those and the handoffs'."""
    want = {"cac_stats": cac_want, "spatial_logits": cac_want,
            "cac_apply": cac_want, "dequant_epilogue": conv_want,
            "int8_gemm": conv_want, "quant_im2col": conv_want + handoffs}
    for name, n in want.items():
        need(counts[name] == n, f"{what}: {name} launched {counts[name]} "
             f"times; expected {n}")


def run_int8_path(kc, kq, data: str, tmp: str):
    """cli eval --dtype int8 (x4_ship4_qat_static, bf16, batch 4), with
    the CAC and quant counts set to 0 just before and read just after;
    then the same eval warm."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    reset_counts(kc, kq)
    summary, wall = eval_once(data, os.path.join(tmp, "int8"),
                              os.path.join(tmp, "int8.json"), 4,
                              ckpt=CKPT_INT8, dtype="int8")
    counts = read_counts(kc, kq)
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the int8 eval did not score every image")
    need(len(os.listdir(os.path.join(tmp, "int8"))) == n_images,
         "the int8 eval did not write every PNG")
    need_int8_counts(counts, 5 * batches,
                     batches * int8_launches(kq, *MAIN_SHAPE[:3]),
                     batches * INT8_HANDOFFS, "int8 eval")
    warm, _ = eval_once(data, os.path.join(tmp, "int8_warm"),
                        os.path.join(tmp, "int8_warm.json"), 4,
                        ckpt=CKPT_INT8, dtype="int8")
    need(all(warm[k] == summary[k] for k in ("mean_rmse", "mean_ssim")),
         "the warm int8 eval scored differently")
    return summary, wall, counts, warm


def run_int8_tta_path(kc, kq, data: str, tmp: str):
    """cli eval --dtype int8 --tta8 --device-metrics, with the counts set
    to 0 just before and read just after; metrics held as the bf16 TTA8
    phase holds them."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    out = os.path.join(tmp, "int8_tta8")
    reset_counts(kc, kq)
    summary, wall = eval_once(data, out, os.path.join(tmp, "int8_tta8.json"),
                              4, ["--tta8", "--device-metrics"],
                              ckpt=CKPT_INT8, dtype="int8")
    counts = read_counts(kc, kq)
    need(summary["tta_transforms"] == 8, "the int8 eval did not run TTA8")
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the int8 TTA8 eval did not score every image")
    n, h, w = TTA_SHAPE[:3]
    need_int8_counts(counts, 2 * 5 * batches,
                     batches * (int8_launches(kq, n, h, w) +
                                int8_launches(kq, n, w, h)),
                     2 * batches * INT8_HANDOFFS, "int8 TTA8 eval")
    gaps = check_device_metrics(summary, data, out)
    return summary, wall, counts, gaps


def run_int8_ensemble(kc, kq, data: str, tmp: str):
    """A static + dynamic int8 ensemble with --tta: its forward through
    the cli against the mean of its members' (cuDNN deterministic), then
    `cli eval` with the counts set to 0 just before and read just after."""
    import torch
    from codon_tpu_torch import cli
    b = first_batch(data)

    def forward(ckpt):
        args = cli._build_argparser().parse_args(
            ["eval", "--ckpt", ckpt, "--tta", "--dtype", "int8",
             "--device", DEVICE])
        ef = cli.make_eval_forward(args, torch.device(DEVICE))
        return ef, ef.fwd(ef.params, b.depth, b.color, b.mask)

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ef, ens = forward(f"{CKPT_INT8},{CKPT_INT8_DYN}")
        solo = [forward(c)[1] for c in (CKPT_INT8, CKPT_INT8_DYN)]
    finally:
        torch.backends.cudnn.deterministic = saved
    need(ef.ensemble and ef.tta == 4, "the cli did not build a TTA ensemble")
    diff = float((ens - (solo[0] + solo[1]) / 2).abs().max())
    need(diff <= FWD_TOL, f"int8 ensemble vs the mean of its members: max "
         f"abs diff {diff} > {FWD_TOL}")
    spread = float((solo[0] - solo[1]).abs().max())
    need(spread > 10 * FWD_TOL, f"the static and dynamic members agree to "
         f"{spread}: the check could not tell them apart")

    reset_counts(kc, kq)
    summary, wall = eval_once(data, os.path.join(tmp, "int8_ens"),
                              os.path.join(tmp, "int8_ens.json"), 4,
                              ["--tta"], ckpt=f"{CKPT_INT8},{CKPT_INT8_DYN}",
                              dtype="int8")
    counts = read_counts(kc, kq)
    batches = -(-len(SCENES) // 4)
    # the static member hands off through quant_im2col, the dynamic one
    # has no handoffs
    need_int8_counts(counts, 2 * 5 * batches,
                     2 * batches * int8_launches(kq, *TTA_SHAPE[:3]),
                     batches * INT8_HANDOFFS, "int8 ensemble eval")
    need(all(math.isfinite(summary[k]) for k in ("mean_rmse", "mean_ssim")),
         "the int8 ensemble eval's means are not finite")
    return diff, spread, summary, wall, counts

# ---------------------------------------------------------------------------
# phases 16-17: the reference's .pth checkpoints
# ---------------------------------------------------------------------------

def refnet(state_dict):
    """A stand-in for the reference's pickled model: a module tree whose
    state dict carries `state_dict`'s names and values, and no forward.
    The class is made at first use (torch is imported lazily) and bound
    to this module's name, so that a pickle of it loads again here."""
    import torch
    cls = globals().get("RefNet")
    if cls is None:
        class RefNet(torch.nn.Module):
            def __init__(self, sd):
                super().__init__()
                for key, value in sd.items():
                    *path, leaf = key.split(".")
                    mod = self
                    for part in path:
                        if part not in mod._modules:
                            mod.add_module(part, torch.nn.Module())
                        mod = mod._modules[part]
                    mod.register_parameter(leaf, torch.nn.Parameter(
                        value, requires_grad=False))
        RefNet.__qualname__ = "RefNet"
        globals()["RefNet"] = cls = RefNet
    return cls(state_dict)


def write_pth_files(tmp: str):
    """x4_ship4.npz under the reference's names, three ways: a plain state
    dict, {"epoch", "model": <state dict with DataParallel's module.
    prefix>}, and a pickled stand-in module. -> {kind: path}."""
    import numpy as np
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz
    from codon_tpu_torch.checkpoint.torch_convert import (
        params_to_torch_state_dict)
    from codon_tpu_torch.models.codon_net import CodonConfig
    cfg = CodonConfig(dead_heads=True)
    tree = load_npz(CKPT)

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}

    sd = tensors(params_to_torch_state_dict(tree, cfg))
    paths = {k: os.path.join(tmp, f"x4_ship4_{k}.pth")
             for k in PTH_KINDS}
    torch.save(sd, paths["state_dict"])
    torch.save({"epoch": 40, "model": tensors(params_to_torch_state_dict(
        tree, cfg, module_prefix=True))}, paths["epoch_model_module_prefix"])
    torch.save(refnet(sd), paths["full_module"])
    return paths


def same_trees(a, b) -> bool:
    import numpy as np
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(same_trees(a[k], b[k]) for k in a))
    return a.dtype == b.dtype and np.array_equal(a, b)


def run_pth_path(kc, data: str, tmp: str):
    """`cli eval --ckpt` on each .pth (bf16, batch 4, the CAC counts set to
    0 just before and read just after each) against `--ckpt x4_ship4.npz`:
    the same PNGs and metrics, bit for bit (cuDNN deterministic in all
    four); then `cli convert` of each back to the checkpoint's arrays.
    -> {kind: (summary, wall, counts)}."""
    import numpy as np
    import torch
    from codon_tpu_torch import cli
    from codon_tpu_torch.checkpoint.native import load_npz
    from codon_tpu_torch.data.io import imread_gray
    paths = write_pth_files(tmp)
    batches = -(-len(SCENES) // 4)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        ref_out = os.path.join(tmp, "pth_ref")
        ref, _ = eval_once(data, ref_out, os.path.join(tmp, "pth_ref.json"),
                           4)
        for kind, path in paths.items():
            out = os.path.join(tmp, f"pth_{kind}")
            kc.reset_launches()
            summary, wall = eval_once(data, out, out + ".json", 4,
                                      ckpt=path)
            counts = kc.launches()
            need(summary["per_image"] == ref["per_image"],
                 f".pth eval ({kind}) scored differently from the .npz "
                 f"eval")
            for row in ref["per_image"]:
                a, b = (imread_gray(os.path.join(d, row["name"] + ".png"))
                        for d in (out, ref_out))
                need(np.array_equal(a, b), f".pth eval ({kind}) wrote "
                     f"another {row['name']}.png than the .npz eval")
            for name, count in counts.items():
                need(count == 5 * batches, f".pth eval ({kind}): {name} "
                     f"launched {count} times; expected {5 * batches}")
            npz = os.path.join(tmp, f"converted_{kind}.npz")
            need(cli.main(["convert", "--pth", path, "--npz", npz]) == 0,
                 f"cli convert of the {kind} .pth failed")
            need(same_trees(load_npz(npz), load_npz(CKPT)),
                 f"cli convert of the {kind} .pth gave other arrays than "
                 f"x4_ship4.npz")
            runs[kind] = (summary, wall, counts)
    finally:
        torch.backends.cudnn.deterministic = saved
    return runs


# ---------------------------------------------------------------------------
# phases 18-20: the merged-tower forward (codon_fused), float and int8
# ---------------------------------------------------------------------------

def make_merged_inputs(shape, valid, dtype, seed):
    """T and inputs2, (N, H, W, 2C) zero on padding, whose halves are the
    towers, as the merged-tower forward hands them to the CAC kernels; and
    the rest of a stage's inputs. valid as in `make_mask`."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mask = make_mask(shape, valid)
    T, inputs2 = [(torch.randn((n, h, w, 2 * c), generator=g, device=DEVICE)
                   * mask).to(dtype).contiguous() for _ in range(2)]
    gate = torch.rand((n, 1, c), generator=g, device=DEVICE)
    logits = torch.randn((n, h, w), generator=g, device=DEVICE).to(dtype)
    return T, inputs2, mask.to(dtype), gate, logits


def check_pitched_kernels(kc):
    """cac_stats and cac_apply on the halves of T (a tower pitch of 2C),
    cac_apply writing both halves of the next T, against their plain
    versions on the same views, at the fused eval's shape and both TTA8
    shapes, every dtype, the contiguous checks' tolerances. ->
    {name: [check, ...]}."""
    import torch
    checks = {"cac_stats": [], "cac_apply": []}
    seed = 500
    for dname, (atol, rtol) in TOLS.items():
        dtype = getattr(torch, dname)
        for shape, valid in (STAGE_CASES[0],) + STAGE_CASES[2:]:
            seed += 1
            c = shape[-1]
            T, inputs2, mask, gate, logits = make_merged_inputs(
                shape, valid, dtype, seed)
            halves = (T[..., :c], T[..., c:], inputs2[..., :c],
                      inputs2[..., c:])
            npix = shape[1] * shape[2]
            for m in (mask, None):
                got = kc.cac_stats(halves[0], halves[1], m)
                want = kc.cac_stats_plain(halves[0], halves[1], m)
                err_f32, ok_f32 = max_err(
                    (got[0] / npix, got[1]), (want[0] / npix, want[1]),
                    *TOLS["float32"])
                err, ok = max_err(got[2:], want[2:], atol, rtol)
                checks["cac_stats"].append(
                    {"dtype": dname, "shape": list(shape), "pitch": 2 * c,
                     "mask": m is not None, "max_abs_err": max(err, err_f32),
                     "ok": ok and ok_f32})
            nxt = torch.full_like(T, float("nan"))
            want_t = torch.full_like(T, float("nan"))
            kc.cac_apply(*halves, gate, logits,
                         dst=(nxt[..., :c], nxt[..., c:]))
            kc.cac_apply_plain(*halves, gate, logits,
                               dst=(want_t[..., :c], want_t[..., c:]))
            err, ok = max_err([nxt], [want_t], atol, rtol)
            checks["cac_apply"].append(
                {"dtype": dname, "shape": list(shape), "pitch": 2 * c,
                 "max_abs_err": err,
                 "ok": ok and not bool(torch.isnan(nxt).any())})
            del T, inputs2, nxt, want_t
        torch.cuda.empty_cache()
    return checks


def time_pitched_kernels(kc, timings):
    """bf16 device time a launch (a CUDA graph of back-to-back calls) of
    cac_stats and cac_apply on the halves of T, at the main and both TTA8
    shapes, beside the contiguous kernels' at the same shape and in the
    same run (`timings`, from `time_kernels`). The bound is the
    contiguous one: the same bytes move. -> {name: [row, ...]}."""
    import torch
    rows = {"cac_stats": [], "cac_apply": []}
    for i, (shape, valid) in enumerate((STAGE_CASES[0],) + STAGE_CASES[2:]):
        c = shape[-1]
        T, inputs2, mask, gate, logits = make_merged_inputs(
            shape, valid, torch.bfloat16, 600 + i)
        halves = (T[..., :c], T[..., c:], inputs2[..., :c], inputs2[..., c:])
        nxt = torch.empty_like(T)
        calls = {
            "cac_stats": lambda: kc.cac_stats(halves[0], halves[1], mask),
            "cac_apply": lambda: kc.cac_apply(
                *halves, gate, logits, dst=(nxt[..., :c], nxt[..., c:]))}
        for name, fn in calls.items():
            flat = timings[name]["by_shape"][i]
            need(flat["shape"] == list(shape), "shape order of time_kernels")
            rows[name].append({
                "shape": list(shape), "pitch": 2 * c,
                "device_ms": graph_ms(fn),
                "contiguous_device_ms": flat["device_ms"],
                "bound_ms": flat["bound_ms"], "bound_by": flat["bound_by"]})
        del T, inputs2, nxt
        torch.cuda.empty_cache()
    return rows


def run_fused_path(kc, data: str, tmp: str):
    """`cli eval --variant codon_fused` (bf16, batch 4), then with --tta8
    --device-metrics, each with the CAC counts set to 0 just before and
    read just after: 5 launches of each kernel a forward; the TTA8 eval's
    metrics held as the packed TTA8 eval's."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    kc.reset_launches()
    summary, wall = eval_once(data, os.path.join(tmp, "fused"),
                              os.path.join(tmp, "fused.json"), 4,
                              variant="codon_fused")
    counts = kc.launches()
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the codon_fused eval did not score every image")
    need(len(os.listdir(os.path.join(tmp, "fused"))) == n_images,
         "the codon_fused eval did not write every PNG")
    for name, count in counts.items():
        need(count == 5 * batches, f"codon_fused eval: {name} launched "
             f"{count} times; expected {5 * batches} (5 CAC stages a "
             f"forward)")
    out = os.path.join(tmp, "fused_tta8")
    kc.reset_launches()
    tta, tta_wall = eval_once(data, out, out + ".json", 4,
                              ["--tta8", "--device-metrics"],
                              variant="codon_fused")
    tta_counts = kc.launches()
    need(tta["tta_transforms"] == 8, "the codon_fused eval did not run TTA8")
    for name, count in tta_counts.items():
        need(count == 2 * 5 * batches, f"codon_fused TTA8 eval: {name} "
             f"launched {count} times; expected {2 * 5 * batches}")
    gaps = check_device_metrics(tta, data, out)
    return summary, wall, counts, tta, tta_wall, tta_counts, gaps


def compare_fused_paths(data: str):
    """fp32 on the first batch: the merged-tower forward with the CAC
    kernels on the halves of T against its plain stage (FWD_TOL), and
    against the packed `codon` forward (the JAX test's 2e-4 / 1e-3). ->
    (max |d| kernels vs plain, max |d| fused vs packed)."""
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.codon_net import (CodonConfig, codon_forward,
                                                  codon_forward_fused)
    params = params_from_numpy(load_npz(CKPT), DEVICE)
    b = first_batch(data)
    cfg = CodonConfig(dead_heads=True)
    kern = codon_forward_fused(params, b.depth, b.color, mask=b.mask,
                               cfg=dataclasses.replace(cfg,
                                                       cac_impl="kernel"))
    plain = codon_forward_fused(params, b.depth, b.color, mask=b.mask,
                                cfg=dataclasses.replace(cfg,
                                                        cac_impl="torch"))
    packed = codon_forward(params, b.depth, b.color, mask=b.mask, cfg=cfg)
    need(bool(torch.isfinite(kern).all()), "non-finite fp32 fused forward")
    d_paths = float((kern - plain).abs().max())
    need(d_paths <= FWD_TOL, f"fp32 fused forward, kernels vs plain stage: "
         f"max abs diff {d_paths} > {FWD_TOL}")
    d_packed = float((kern - packed).abs().max())
    need(bool(torch.allclose(kern, packed, atol=FUSED_TOL[0],
                             rtol=FUSED_TOL[1])),
         f"fp32 fused forward vs packed: max abs diff {d_packed}, outside "
         f"{FUSED_TOL}")
    return d_paths, d_packed


def fused_int8_launches(kq, n, h, w):
    """{quant_im2col, dequant_epilogue} launches of one codon_fused int8
    forward of n images at h x w: a grouped site quantizes a block of
    images once, then gathers, multiplies and dequantizes each group; an
    ungrouped one runs each once a block. The GEMMs are the epilogues."""
    im2col = conv = 0
    for k, c, groups, _, calls in FUSED_INT8_CONVS:
        blocks = len(kq.image_blocks(n, h, w, k * k * c // groups))
        im2col += calls * blocks * (groups + 1 if groups > 1 else 1)
        conv += calls * blocks * groups
    return {"quant_im2col": im2col, "dequant_epilogue": conv,
            "int8_gemm": conv}


def grouped_sites():
    """The distinct grouped int8 conv shapes of a codon_fused forward,
    (k, C_in, groups, C_out, calls a forward)."""
    sites = {}
    for k, c, groups, co, calls in FUSED_INT8_CONVS:
        if groups > 1:
            sites[(k, c, groups, co)] = sites.get((k, c, groups, co), 0) + \
                calls
    return [(*key, calls) for key, calls in sites.items()]


def check_windowed_quant_kernels(kq):
    """At every grouped int8 site of the b4 codon_fused forward (one block
    of images): quant_im2col on each group's channel window (float32 and
    bfloat16 input, static and dynamic scales; int8 input, the gather
    alone) and dequant_epilogue into each group's output window (float32
    and bfloat16, static and dynamic, masked), bitwise against their plain
    versions. -> {name: [check, ...]}."""
    import torch
    checks = {"quant_im2col": [], "dequant_epilogue": []}
    n, h, w = MAIN_SHAPE[:3]
    for i, (k, c, groups, co, _) in enumerate(grouped_sites()):
        cg, cog = c // groups, co // groups
        nb = kq.image_blocks(n, h, w, k * k * cg)[0][1]
        shape = (nb, h, w, c)
        x, sc, sx, mask, _, _ = quant_inputs(shape, MAIN_VALID[:nb], 700 + i)
        for dname in ("float32", "bfloat16", "int8"):
            dtype = getattr(torch, dname)
            xd = (kq.quantize_plain(x, sc) if dtype == torch.int8
                  else x.to(dtype).contiguous())
            modes = ([("none", None, None)] if dtype == torch.int8 else
                     [("channel", sc, None), ("sample", None, sx)])
            for mode, a, b in modes:
                for g in range(groups):
                    got = kq.quant_im2col(xd, k, a, b, c0=g * cg, cg=cg)
                    want = kq.quant_im2col_plain(xd, k, a, b, c0=g * cg,
                                                 cg=cg)
                    same = torch.equal(got, want)
                    checks["quant_im2col"].append(
                        {"dtype": dname, "shape": list(shape), "k": k,
                         "window": [g * cg, (g + 1) * cg], "mode": mode,
                         "bitwise": same, "ok": same, "max_abs_err": float(
                             (got.float() - want.float()).abs().max())})
                    del got, want
            del xd
        del x
        torch.cuda.empty_cache()
        gen = torch.Generator(device=DEVICE).manual_seed(750 + i)
        acc = torch.randint(-2 ** 20, 2 ** 20, (nb * h * w, cog),
                            generator=gen, device=DEVICE, dtype=torch.int32)
        sw = torch.rand((cog,), generator=gen, device=DEVICE) * 1e-3
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for mode, b in (("static", None), ("dynamic", sx)):
                for g in range(groups):
                    got = torch.zeros((nb, h, w, co), dtype=dtype,
                                      device=DEVICE)
                    want = torch.zeros_like(got)
                    kq.dequant_epilogue(acc, sw, dtype, (nb, h, w), b,
                                        mask.to(dtype), out=got, o0=g * cog)
                    kq.dequant_epilogue_plain(acc, sw, dtype, (nb, h, w), b,
                                              mask.to(dtype), out=want,
                                              o0=g * cog)
                    same = torch.equal(got, want)
                    checks["dequant_epilogue"].append(
                        {"dtype": dname, "shape": [nb, h, w, co],
                         "window": [g * cog, (g + 1) * cog], "mode": mode,
                         "mask": True, "bitwise": same, "ok": same,
                         "max_abs_err": float((got.float() - want.float())
                                              .abs().max())})
                    del got, want
        del acc
        torch.cuda.empty_cache()
    return checks


def time_windowed_quant(kq):
    """bf16, at each grouped int8 site of the b4 codon_fused forward (one
    block of images): the device time a launch of the gather of one
    group's channel window (int8 codes of all C channels in) beside the
    same gather of a contiguous cg-channel tensor, of the quantize pass
    over all C (quant_im2col at k = 1), and of dequant_epilogue into one
    group's output window beside a contiguous output; each with its byte
    bound and its launches a forward. -> [row, ...]."""
    import torch
    n, h, w = MAIN_SHAPE[:3]
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(800)
    mask = make_mask(MAIN_SHAPE, MAIN_VALID).to(bf)
    rows = []
    for k, c, groups, co, calls in grouped_sites():
        cg, cog = c // groups, co // groups
        blocks = kq.image_blocks(n, h, w, k * k * cg)
        nb = blocks[0][1]
        pix = nb * h * w
        x = (torch.randn((nb, h, w, c), generator=g, device=DEVICE) * 3
             ).to(bf)
        sc = torch.rand((c,), generator=g, device=DEVICE) * 0.05 + 0.005
        codes = kq.quantize_plain(x, sc)
        flat = codes[..., :cg].contiguous()
        acc = torch.randint(-2 ** 20, 2 ** 20, (pix, cog), generator=g,
                            device=DEVICE, dtype=torch.int32)
        sw = torch.rand((cog,), generator=g, device=DEVICE) * 1e-3
        m = mask[:nb].contiguous()
        out = torch.empty((nb, h, w, co), dtype=bf, device=DEVICE)
        launches = calls * len(blocks)
        gather_bytes = pix * cg + pix * k * k * cg
        quant_bytes = pix * c * 2 + pix * c
        ep_bytes = pix * cog * 4 + pix * 2 + pix * cog * 2
        rows.append({
            "k": k, "c_in": c, "groups": groups, "c_out": co,
            "shape": [nb, h, w, c], "launches_a_forward": {
                "gather": launches * groups, "quantize": launches,
                "epilogue": launches * groups},
            "gather_device_ms": graph_ms(
                lambda: kq.quant_im2col(codes, k, c0=cg, cg=cg)),
            "gather_contiguous_device_ms": graph_ms(
                lambda: kq.quant_im2col(flat, k)),
            "gather_bound_ms": bound(gather_bytes, 0)[0],
            "quantize_device_ms": graph_ms(
                lambda: kq.quant_im2col(x, 1, sc)),
            "quantize_bound_ms": bound(quant_bytes, x.numel())[0],
            "epilogue_device_ms": graph_ms(
                lambda: kq.dequant_epilogue(acc, sw, bf, (nb, h, w), None, m,
                                            out=out, o0=cog)),
            "epilogue_contiguous_device_ms": graph_ms(
                lambda: kq.dequant_epilogue(acc, sw, bf, (nb, h, w), None,
                                            m)),
            "epilogue_bound_ms": bound(ep_bytes, 3 * pix * cog)[0]})
        del x, codes, flat, acc, out
        torch.cuda.empty_cache()
    return rows


def run_fused_int8_path(kc, kq, data: str, tmp: str):
    """`cli eval --variant codon_fused --dtype int8` with
    x4_ship4_qat_static (its compound sites resolve through the aliases),
    the counts set to 0 just before and read just after."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    out = os.path.join(tmp, "fused_int8")
    reset_counts(kc, kq)
    summary, wall = eval_once(data, out, out + ".json", 4, ckpt=CKPT_INT8,
                              dtype="int8", variant="codon_fused")
    counts = read_counts(kc, kq)
    need(len(summary["per_image"]) == n_images and
         all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
             for r in summary["per_image"]),
         "the codon_fused int8 eval did not score every image")
    want = {k: batches * v for k, v in
            fused_int8_launches(kq, *MAIN_SHAPE[:3]).items()}
    want.update({k: 5 * batches for k in kc.launches()})
    for name, n in want.items():
        need(counts[name] == n, f"codon_fused int8 eval: {name} launched "
             f"{counts[name]} times; expected {n}")
    return summary, wall, counts


def compare_fused_int8_paths(data: str):
    """fp32 int8 codon_fused forward of the first batch (x4_ship4_qat_
    static), the quant kernels against their plain versions, the CAC
    kernels in both, under cuDNN's deterministic mode: bitwise. -> max
    |d|."""
    import dataclasses
    import torch
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.variants import get_variant
    tree = load_npz(CKPT_INT8)
    tree.pop("act_scales")
    params = params_from_numpy(tree, DEVICE)
    b = first_batch(data)
    v = get_variant("codon_fused")
    cfg = dataclasses.replace(v.cfg, cac_impl="kernel")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = [v.forward_fn(params, b.depth, b.color, mask=b.mask, cfg=cfg,
                             ops=static_int8_ops(torch.float32, impl))
                for impl in (None, "plain")]
    finally:
        torch.backends.cudnn.deterministic = saved
    need(bool(torch.isfinite(outs[0]).all()),
         "non-finite fp32 fused int8 forward")
    diff = float((outs[0] - outs[1]).abs().max())
    need(torch.equal(outs[0], outs[1]), f"fp32 fused int8 forward, quant "
         f"kernels vs plain: max abs diff {diff}, not bitwise")
    return diff


# ---------------------------------------------------------------------------
# phase 21: the sequential-tower forward (rmcr_fuse_rmcr)
# ---------------------------------------------------------------------------

def run_sequential_path(kc, kq, data: str, tmp: str):
    """`cli eval --variant rmcr_fuse_rmcr` in bf16 (no CAC kernel may
    launch) and in int8 with x4_ship4_qat_static (the quant kernels at
    each of its 43 convs a forward, no handoffs), each with the counts set
    to 0 just before and read just after."""
    n_images = len(SCENES)
    batches = -(-n_images // 4)
    runs = {}
    for dtype, ckpt in (("bf16", CKPT), ("int8", CKPT_INT8)):
        out = os.path.join(tmp, f"rmcr_{dtype}")
        reset_counts(kc, kq)
        summary, wall = eval_once(data, out, out + ".json", 4, ckpt=ckpt,
                                  dtype=dtype, variant="rmcr_fuse_rmcr")
        counts = read_counts(kc, kq)
        need(len(summary["per_image"]) == n_images and
             all(math.isfinite(r["rmse"]) and math.isfinite(r["ssim"])
                 for r in summary["per_image"]),
             f"the rmcr_fuse_rmcr {dtype} eval did not score every image")
        conv = (batches * int8_launches(kq, *MAIN_SHAPE[:3])
                if dtype == "int8" else 0)
        need_int8_counts(counts, 0, conv, 0, f"rmcr_fuse_rmcr {dtype} eval")
        runs[dtype] = (summary, wall, counts)
    return runs


# ---------------------------------------------------------------------------
# phase 22: the rest of the cli
# ---------------------------------------------------------------------------

def cli_said(argv):
    """-> (return code, what `cli.main(argv)` printed)."""
    import contextlib
    import io
    from codon_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def run_cli_tools(data: str, tmp: str, main_out: str, main_summary):
    """`eval --resume` twice (the second finds every PNG and writes the
    all-done stub), `eval --profile`, `eval --check-nans` on x4_ship4 with
    one NaN weight (it must fail through FloatingPointError naming the
    site), `golden` on the main eval's PNGs, and `info`. -> a dict of what
    each showed."""
    import shutil
    import numpy as np
    from codon_tpu_torch.checkpoint.native import load_npz, save_npz
    res = {}
    out = os.path.join(tmp, "resume")
    first, _ = eval_once(data, out, out + "1.json", 4, ["--resume"])
    need(first["images"] == len(SCENES) and "resumed_all" not in first,
         "the first --resume eval did not run every image")
    stub, _ = eval_once(data, out, out + "2.json", 4, ["--resume"])
    need(stub.get("resumed_all") is True and stub["images"] == 0
         and stub["mean_rmse"] is None
         and set(stub) == set(first) | {"resumed_all"},
         f"the second --resume eval wrote no all-done stub: {stub}")
    res["resume"] = {"first_images": first["images"], "stub": stub}

    prof = os.path.join(tmp, "profile")
    eval_once(data, os.path.join(tmp, "prof_out"), prof + ".json", 4,
              ["--profile", prof, "--no-save"])
    trace = os.path.join(prof, "trace.json")
    need(os.path.exists(trace), "--profile wrote no trace")
    with open(trace) as f:
        text = f.read()
    need("cac_apply_kernel" in text, "the --profile trace holds no CAC "
         "kernel launch")
    res["profile_trace_bytes"] = len(text)

    bad = os.path.join(tmp, "x4_ship4_nan.npz")
    tree = load_npz(CKPT)
    tree["conv3"] = tree["conv3"].copy()
    tree["conv3"][1, 2, 3, 4] = np.nan
    save_npz(bad, tree)
    try:
        eval_once(data, os.path.join(tmp, "nan_out"), bad + ".json", 4,
                  ["--check-nans"], ckpt=bad)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    need(raised is not None and "conv site 'conv3'" in raised,
         f"--check-nans on a NaN conv3 weight: {raised!r}")
    res["check_nans"] = raised

    gdir = os.path.join(tmp, "golden", "CODON_X4")
    shutil.copytree(os.path.join(data, "input_label"),
                    os.path.join(gdir, "input_label"))
    shutil.copytree(main_out, os.path.join(gdir, "output"))
    rc, said = cli_said(["golden", "--data-dir", gdir])
    lines = said.strip().splitlines()
    need(rc == 0 and lines[-2] == str(len(SCENES)),
         f"golden printed {lines[-2:]}")
    g_rmse, g_ssim = (float(v) for v in lines[-1].split())
    need(g_rmse == main_summary["mean_rmse"]
         and g_ssim == main_summary["mean_ssim"],
         f"golden on the main eval's PNGs: {g_rmse} {g_ssim}, the eval "
         f"scored {main_summary['mean_rmse']} {main_summary['mean_ssim']}")
    res["golden"] = lines[-1]

    rc, said = cli_said(["info"])
    need(rc == 0 and "variant 'codon': 1,866,136 params" in said
         and "codon_fused" in said and "rmcr_fuse_rmcr" in said,
         f"info printed {said!r}")
    res["info"] = said.strip().splitlines()
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "codon_tpu_torch")):
        print("chip_smoke: codon_tpu_torch/ not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from codon_tpu_torch import perf_copy_probe as probe
    from codon_tpu_torch.kernels import _build
    from codon_tpu_torch.kernels import cac as kc
    from codon_tpu_torch.kernels import copy as kcopy
    from codon_tpu_torch.kernels import quant as kq

    # 1. the card
    card = card_line()
    kind_name = torch.cuda.get_device_name(0)
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    # 2. build
    path, build_s = _build.build()
    _build.load()
    say(f"build: {os.path.basename(path)}: "
        + (f"nvcc {build_s:.1f} s" if build_s else "already built"))
    usage = _build.ptxas_usage(path)
    need(bool(usage), "the build left no ptxas report")
    say("ptxas: " + ptxas_text(usage, kcopy.RING_BYTES))

    # 3. kernels against their plain versions
    t0 = time.time()
    checks = check_kernels(kc)
    for name, rows in checks.items():
        for r in rows:
            say(f"check {name} {r['dtype']} {tuple(r['shape'])}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + (f" bitwise {r['bitwise']}" if "bitwise" in r else "")
                + f": max_abs_err {r['max_abs_err']:.3e} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in checks.items() for r in rows if not r["ok"]]
    need(not bad, f"{len(bad)} kernel checks out of tolerance: {bad}")
    timings = time_kernels(kc)
    for name, t in timings.items():
        say(f"time {name} {tuple(MAIN_SHAPE)}: wrapper {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms"
            + (f", library {t['library_ms']:.4f} ms"
               if t["library_ms"] is not None else ""))
        for r in t["by_shape"]:
            say(f"device {name} {tuple(r['shape'])}: "
                f"{r['device_ms'] * 1e3:.2f} us a launch ({GRAPH_CALLS} "
                f"calls in a CUDA graph); bound {r['bound_ms'] * 1e3:.2f} us "
                f"by {r['bound_by']}"
                + (f", fp32 instruction floor {r['insn_floor_ms'] * 1e3:.2f} "
                   f"us" if "insn_floor_ms" in r else "")
                + (f"; library {r['library_device_ms'] * 1e3:.2f} us a "
                   f"call in a graph, {r['library_ms'] * 1e3:.2f} us back to "
                   f"back" if r["library_ms"] is not None else ""))
    for r in timings["spatial_logits"]["small"]:
        say(f"device spatial_logits {tuple(r['shape'])}: "
            f"{r['device_ms'] * 1e3:.2f} us a launch")
    # 3, the merged-tower layout: cac_stats and cac_apply on the halves of
    # one (N, H, W, 2C) tensor
    pchecks = check_pitched_kernels(kc)
    for name, rows in pchecks.items():
        for r in rows:
            say(f"check {name} pitch {r['pitch']} {r['dtype']} "
                f"{tuple(r['shape'])}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + f": max_abs_err {r['max_abs_err']:.3e} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in pchecks.items() for r in rows
           if not r["ok"]]
    need(not bad, f"{len(bad)} pitched kernel checks out of tolerance: "
         f"{bad}")
    ptimes = time_pitched_kernels(kc, timings)
    for name, rows in ptimes.items():
        for r in rows:
            say(f"device {name} pitch {r['pitch']} {tuple(r['shape'])}: "
                f"{r['device_ms'] * 1e3:.2f} us a launch, contiguous "
                f"{r['contiguous_device_ms'] * 1e3:.2f} us; bound "
                f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}")
    say(f"kernel checks and timings: {time.time() - t0:.1f} s")

    # 3, the int8 conv's kernels: bitwise against their plain versions,
    # then timed at the int8 forward's shapes
    t0 = time.time()
    qchecks = check_quant_kernels(kq)
    for name, rows in qchecks.items():
        for r in rows:
            say(f"check {name} {r['dtype']} {tuple(r['shape'])} "
                + (f"k={r['k']} " if "k" in r else "")
                + f"{r['mode']}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + f" bitwise {r['bitwise']}: max_abs_err "
                  f"{r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in qchecks.items() for r in rows if not r["ok"]]
    need(not bad, f"{len(bad)} quant kernel checks not bitwise: {bad}")
    qtimes, gemms = time_quant(kq)
    for name, t in qtimes.items():
        say(f"time {name} {tuple(t['shape'])}: wrapper {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']}")
        for r in t["by_shape"]:
            say(f"device {name} {tuple(r['shape'])}"
                + (f" k={r['k']} {r['input']}" if "k" in r else "")
                + f": {r['device_ms'] * 1e3:.2f} us a launch ({GRAPH_CALLS} "
                  f"calls in a CUDA graph); bound {r['bound_ms'] * 1e3:.2f} "
                  f"us by {r['bound_by']}; {r['calls_a_forward']} launches a "
                  f"b4 forward")
        say(f"device {name}, a b4 int8 forward: {t['device_ms_a_forward']:.4f}"
            f" ms over its launches; bound {t['bound_ms_a_forward']:.4f} ms")
    for r in gemms:
        say(f"gemm torch._int_mm ({r['m']} x {r['k']}) x ({r['k']} x "
            f"{r['n']}): {r['ms']:.4f} ms back to back; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}; "
            f"{r['calls_a_forward']} calls a b4 forward")
    gemm_ms = sum(r["ms"] * r["calls_a_forward"] for r in gemms)
    gemm_bound = sum(r["bound_ms"] * r["calls_a_forward"] for r in gemms)
    say(f"gemm, a b4 int8 forward: {gemm_ms:.4f} ms over its calls; bound "
        f"{gemm_bound:.4f} ms")
    # 3, the grouped int8 convs of codon_fused: channel and output windows
    wchecks = check_windowed_quant_kernels(kq)
    for name, rows in wchecks.items():
        for r in rows:
            say(f"check {name} window {r['window']} {r['dtype']} "
                f"{tuple(r['shape'])} "
                + (f"k={r['k']} " if "k" in r else "")
                + f"{r['mode']} bitwise {r['bitwise']}: max_abs_err "
                  f"{r['max_abs_err']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in wchecks.items() for r in rows
           if not r["ok"]]
    need(not bad, f"{len(bad)} windowed quant checks not bitwise: {bad}")
    wtimes = time_windowed_quant(kq)
    for r in wtimes:
        say(f"device grouped site k={r['k']} C={r['c_in']}->{r['c_out']} "
            f"x{r['groups']} {tuple(r['shape'])}: gather of a window "
            f"{r['gather_device_ms'] * 1e3:.2f} us (contiguous "
            f"{r['gather_contiguous_device_ms'] * 1e3:.2f}, bound "
            f"{r['gather_bound_ms'] * 1e3:.2f}); quantize all C "
            f"{r['quantize_device_ms'] * 1e3:.2f} us (bound "
            f"{r['quantize_bound_ms'] * 1e3:.2f}); epilogue into a window "
            f"{r['epilogue_device_ms'] * 1e3:.2f} us (contiguous "
            f"{r['epilogue_contiguous_device_ms'] * 1e3:.2f}, bound "
            f"{r['epilogue_bound_ms'] * 1e3:.2f}); launches a b4 forward "
            f"{r['launches_a_forward']}")
    say(f"quant kernel checks and timings: {time.time() - t0:.1f} s")

    # 4. the main path
    with tempfile.TemporaryDirectory(prefix="codon_chip_smoke_") as tmp:
        summary, warm, counts, wall, data = run_main_path(kc, tmp)
        say(f"main path: cli eval bf16 b4, {summary['images']} images, "
            f"mean RMSE {summary['mean_rmse']}, mean SSIM "
            f"{summary['mean_ssim']}, {wall:.1f} s wall; img/s steady "
            f"{summary['img_per_sec_steady']}, end-to-end "
            f"{summary['img_per_sec_e2e']}; launches {counts}")
        same = all(warm[k] == summary[k] for k in ("mean_rmse", "mean_ssim"))
        say(f"main path again, warm: img/s steady "
            f"{warm['img_per_sec_steady']}, compute+D2H "
            f"{warm['img_per_sec_compute']}, end-to-end "
            f"{warm['img_per_sec_e2e']}; same scores as the first run: "
            f"{same}")

        # 5. paths against each other
        d_paths, d_cpu = compare_paths(data)
        say(f"fp32 forward b4 384x480: kernels vs plain stage max abs diff "
            f"{d_paths:.3e} (<= {FWD_TOL}); card vs CPU 37x29 {d_cpu:.3e} "
            f"(<= {CPU_TOL})")

        # 6. the copy kernels against their plain version, the identity
        t0 = time.time()
        copy_checks = check_copies(kcopy, probe)
        for r in copy_checks:
            say(f"check {r['name']} tile {r['tile']} {tuple(r['shape'])} "
                f"({layout_text(r)}): bitwise {r['bitwise']}, sentinel "
                f"intact {r['guard']} {'ok' if r['ok'] else 'FAIL'}")
        bad = [r for r in copy_checks if not r["ok"]]
        need(not bad, f"{len(bad)} copy checks failed: {bad}")

        # 7. the copy kernels' times at the probe's shape
        copy_times = time_copies(kcopy, probe)
        for name, t in copy_times.items():
            for r in t["by_tile"]:
                say(f"copy {name} tile {r['tile']} ({layout_text(r)}): "
                    f"{r['ms']:.4f} ms {r['gb_per_s']:.0f} GB/s, "
                    f"{r['of_clone']:.1%} of clone(); bound "
                    f"{t['bound_ms']:.4f} ms by bytes "
                    f"({t['bound_ms'] / r['ms']:.1%} of it)")
            say(f"copy {name}: plain {t['plain_ms']:.4f} ms; clone() "
                f"{t['library_ms']:.4f} ms")
        say(f"copy checks and timings: {time.time() - t0:.1f} s")

        # 8. the probe's sweep: the copy kernels' path
        sweep, copy_counts = run_probe(kcopy, probe)
        ceiling = max(r["gb_per_s"] for r in sweep)
        best = max(sweep, key=lambda r: r["gb_per_s"])
        say(f"copy probe: launches {copy_counts}; measured copy ceiling "
            f"{ceiling:.0f} GB/s ({best['tag'].strip()}), "
            f"{ceiling / (HBM_BYTES_PER_S / 1e9):.1%} of the nominal "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")

        # 9. TTA8 with on-device metrics: the CAC kernels' second path
        tta, tta_wall, tta_counts, gaps, warm_dm, warm_host = \
            run_tta_path(kc, data, tmp)
        say(f"tta8 path: cli eval --tta8 --device-metrics bf16 b4, mean "
            f"RMSE {tta['mean_rmse']}, mean SSIM {tta['mean_ssim']}, "
            f"{tta_wall:.1f} s wall; launches {tta_counts}")
        say(f"tta8 metrics: card vs host on the PNGs: RMSE max |d| "
            f"{gaps['rmse_host']:.3e} (< {RMSE_HOST_TOL}), SSIM max |d| "
            f"{gaps['ssim_host']:.3e} (< {SSIM_HOST_TOL}); card vs CPU, "
            f"same tensors: RMSE {gaps['rmse_cpu']:.3e}, SSIM "
            f"{gaps['ssim_cpu']:.3e} (<= {METRIC_CPU_TOL})")
        for label, r in (("device metrics", warm_dm),
                         ("host metrics", warm_host)):
            say(f"tta8 warm, {label}: img/s steady "
                f"{r['img_per_sec_steady']}, compute+D2H "
                f"{r['img_per_sec_compute']}, end-to-end "
                f"{r['img_per_sec_e2e']}")

        # 10. fp32 TTA8 through the kernels against the plain stage
        d_tta = compare_tta_paths(data)
        say(f"fp32 tta8 b4 384x480: kernels vs plain stage max abs diff "
            f"{d_tta:.3e} (<= {FWD_TOL})")

        # 11. a 2-member ensemble with --tta
        d_ens, spread, ens, ens_wall, ens_counts = run_ensemble(kc, data,
                                                                tmp)
        say(f"ensemble x4_ship4 + x4_holdout2 --tta: fp32 vs the mean of "
            f"its members max abs diff {d_ens:.3e} (<= {FWD_TOL}; the "
            f"members differ by up to {spread:.3e}); cli eval bf16 b4 mean "
            f"RMSE {ens['mean_rmse']}, mean SSIM {ens['mean_ssim']}, "
            f"{ens_wall:.1f} s wall; launches {ens_counts}")

        # 12. the int8 forward, fp32: quant kernels vs plain, card vs CPU
        d_int8, d_int8_cpu = compare_int8_paths(data)
        say(f"fp32 int8 forward b4 384x480 (x4_ship4_qat_static): quant "
            f"kernels vs plain max abs diff {d_int8:.3e} (bitwise); card vs "
            f"CPU 37x29 mean {d_int8_cpu[0]:.3e} max {d_int8_cpu[1]:.3e} "
            f"(<= {INT8_CPU_BOUNDS[0]}, {INT8_CPU_BOUNDS[1]})")

        # 13. the int8 eval: the quant kernels' main path
        i8, i8_wall, i8_counts, i8_warm = run_int8_path(kc, kq, data, tmp)
        say(f"int8 path: cli eval --dtype int8 b4 (x4_ship4_qat_static), "
            f"mean RMSE {i8['mean_rmse']}, mean SSIM {i8['mean_ssim']}, "
            f"{i8_wall:.1f} s wall; img/s steady "
            f"{i8['img_per_sec_steady']}, end-to-end "
            f"{i8['img_per_sec_e2e']}; launches {i8_counts}")
        say(f"int8 path again, warm: img/s steady "
            f"{i8_warm['img_per_sec_steady']}, compute+D2H "
            f"{i8_warm['img_per_sec_compute']}, end-to-end "
            f"{i8_warm['img_per_sec_e2e']}")

        # 14. int8 with TTA8 and on-device metrics
        i8t, i8t_wall, i8t_counts, i8_gaps = run_int8_tta_path(kc, kq, data,
                                                               tmp)
        say(f"int8 tta8 path: cli eval --dtype int8 --tta8 --device-metrics "
            f"b4, mean RMSE {i8t['mean_rmse']}, mean SSIM "
            f"{i8t['mean_ssim']}, {i8t_wall:.1f} s wall; img/s steady "
            f"{i8t['img_per_sec_steady']}; launches {i8t_counts}")
        say(f"int8 tta8 metrics: card vs host on the PNGs: RMSE max |d| "
            f"{i8_gaps['rmse_host']:.3e}, SSIM max |d| "
            f"{i8_gaps['ssim_host']:.3e}; card vs CPU, same tensors: RMSE "
            f"{i8_gaps['rmse_cpu']:.3e}, SSIM {i8_gaps['ssim_cpu']:.3e}")

        # 15. a static + dynamic int8 ensemble with --tta
        d_i8e, i8_spread, i8e, i8e_wall, i8e_counts = run_int8_ensemble(
            kc, kq, data, tmp)
        say(f"int8 ensemble x4_ship4_qat_static + x4_ship4_qat --tta: vs the "
            f"mean of its members max abs diff {d_i8e:.3e} (<= {FWD_TOL}; "
            f"the members differ by up to {i8_spread:.3e}); cli eval b4 "
            f"mean RMSE {i8e['mean_rmse']}, mean SSIM {i8e['mean_ssim']}, "
            f"{i8e_wall:.1f} s wall; launches {i8e_counts}")

        # 16-17. the reference's .pth checkpoints: eval and convert
        t0 = time.time()
        pth_runs = run_pth_path(kc, data, tmp)
        for kind, (r, r_wall, r_counts) in pth_runs.items():
            say(f"pth path ({kind}): cli eval bf16 b4 mean RMSE "
                f"{r['mean_rmse']}, mean SSIM {r['mean_ssim']}, "
                f"{r_wall:.1f} s wall, PNGs and metrics bitwise equal to "
                f"the .npz eval; cli convert gives x4_ship4.npz's arrays; "
                f"launches {r_counts}")
        say(f"pth phases: {time.time() - t0:.1f} s")

        # 18. the merged-tower forward: float evals, fp32 forwards
        fu, fu_wall, fu_counts, fut, fut_wall, fut_counts, fu_gaps = \
            run_fused_path(kc, data, tmp)
        say(f"fused path: cli eval --variant codon_fused bf16 b4, mean RMSE "
            f"{fu['mean_rmse']}, mean SSIM {fu['mean_ssim']}, "
            f"{fu_wall:.1f} s wall; img/s steady "
            f"{fu['img_per_sec_steady']}, end-to-end "
            f"{fu['img_per_sec_e2e']}; launches {fu_counts}")
        say(f"fused tta8 path: --tta8 --device-metrics, mean RMSE "
            f"{fut['mean_rmse']}, mean SSIM {fut['mean_ssim']}, "
            f"{fut_wall:.1f} s wall; img/s steady "
            f"{fut['img_per_sec_steady']}; launches {fut_counts}; card vs "
            f"host RMSE {fu_gaps['rmse_host']:.3e}, SSIM "
            f"{fu_gaps['ssim_host']:.3e}; card vs CPU RMSE "
            f"{fu_gaps['rmse_cpu']:.3e}, SSIM {fu_gaps['ssim_cpu']:.3e}")
        d_fu, d_fu_packed = compare_fused_paths(data)
        say(f"fp32 fused forward b4 384x480: kernels vs plain stage max abs "
            f"diff {d_fu:.3e} (<= {FWD_TOL}); fused vs packed max abs diff "
            f"{d_fu_packed:.3e} (within atol {FUSED_TOL[0]}, rtol "
            f"{FUSED_TOL[1]})")

        # 19-20. the merged-tower forward in int8
        d_fu8 = compare_fused_int8_paths(data)
        say(f"fp32 fused int8 forward b4 384x480 (x4_ship4_qat_static): "
            f"quant kernels vs plain max abs diff {d_fu8:.3e} (bitwise)")
        fu8, fu8_wall, fu8_counts = run_fused_int8_path(kc, kq, data, tmp)
        say(f"fused int8 path: cli eval --variant codon_fused --dtype int8 "
            f"b4, mean RMSE {fu8['mean_rmse']}, mean SSIM "
            f"{fu8['mean_ssim']}, {fu8_wall:.1f} s wall; img/s steady "
            f"{fu8['img_per_sec_steady']}; launches {fu8_counts}")

        # 21. the sequential-tower forward
        seq = run_sequential_path(kc, kq, data, tmp)
        for dt, (r, r_wall, r_counts) in seq.items():
            say(f"sequential path: cli eval --variant rmcr_fuse_rmcr {dt} "
                f"b4, mean RMSE {r['mean_rmse']}, mean SSIM "
                f"{r['mean_ssim']}, {r_wall:.1f} s wall; img/s steady "
                f"{r['img_per_sec_steady']}; launches {r_counts}")

        # 22. the rest of the cli
        t0 = time.time()
        tools = run_cli_tools(data, tmp, os.path.join(tmp, "out"), summary)
        say(f"cli resume: first run {tools['resume']['first_images']} "
            f"images, second run's stub {json.dumps(tools['resume']['stub'])}")
        say(f"cli profile: trace of {tools['profile_trace_bytes']} bytes "
            f"with the CAC kernels in it")
        say(f"cli check-nans: FloatingPointError as expected: "
            f"{tools['check_nans']}")
        say(f"cli golden on the main eval's PNGs: {tools['golden']} (the "
            f"eval's own means)")
        say(f"cli info: {' | '.join(tools['info'])}")
        say(f"cli phases: {time.time() - t0:.1f} s")

    # 23. results
    int8_paths = {"eval_int8": i8_counts,
                  "eval_int8_tta8_device_metrics": i8t_counts,
                  "eval_int8_ensemble2_tta": i8e_counts,
                  "eval_codon_fused_int8": fu8_counts,
                  "eval_rmcr_fuse_rmcr_int8": seq["int8"][2]}
    cac_paths = {"eval_codon_fused": fu_counts,
                 "eval_codon_fused_tta8_device_metrics": fut_counts,
                 "eval_rmcr_fuse_rmcr": seq["bf16"][2],
                 **{f"eval_pth_{k}": v[2] for k, v in pth_runs.items()}}
    kernels = []
    for name in ("cac_stats", "spatial_logits", "cac_apply"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/cac.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "launches_by_path": {"eval": counts[name],
                                 "eval_tta8_device_metrics": tta_counts[name],
                                 "eval_ensemble2_tta": ens_counts[name],
                                 **{p: c[name] for p, c in
                                    int8_paths.items()},
                                 **{p: c[name] for p, c in
                                    cac_paths.items()}},
            **({"pitched": {"by_shape": ptimes[name],
                            "max_abs_err": max(r["max_abs_err"]
                                               for r in pchecks[name])}}
               if name in ptimes else {}),
            "max_abs_err": max(r["max_abs_err"] for r in
                               checks[name] + pchecks.get(name, [])),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "by_shape": t["by_shape"], **({"small": t["small"]}
                                         if "small" in t else {}),
            "shape": list(MAIN_SHAPE), "dtype": "bfloat16"})
    for name, kind, tiles in COPY_KERNELS:
        t = copy_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/copy.cu",
            "replaces": REPLACES[name], "launches": copy_counts[name],
            "launches_by_path": {"perf_copy_probe": copy_counts[name]},
            "max_abs_err": max(r["max_abs_err"] for r in copy_checks
                               if r["name"] == name),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "tile": t["tile"],
            "design": t["design"], "grid": t["grid"],
            "chunk_bytes": t["chunk_bytes"], "by_tile": t["by_tile"],
            "shape": list(probe.view(torch.empty(PROBE_SHAPE, device="meta"),
                                     kind).shape),
            "dtype": "bfloat16"})
    for name in ("quant_im2col", "dequant_epilogue"):
        t = qtimes[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/quant.cu",
            "replaces": REPLACES[name], "launches": i8_counts[name],
            "launches_by_path": {p: c[name] for p, c in int8_paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in
                               qchecks[name] + wchecks[name]),
            "windowed": {"grouped_sites": wtimes, "max_abs_err": max(
                r["max_abs_err"] for r in wchecks[name])},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "device_ms": t["device_ms"],
            "device_ms_a_forward": t["device_ms_a_forward"],
            "bound_ms_a_forward": t["bound_ms_a_forward"],
            "by_shape": t["by_shape"], "shape": t["shape"],
            "dtype": "bfloat16",
            **({"int8_gemm": gemms} if name == "quant_im2col" else {})})
    for k in kernels:
        # the same numbers under the names the port's records use
        k["max_err"] = k["max_abs_err"]
        k["kernel_ms"] = k["ms"]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
