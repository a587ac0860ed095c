"""Where the time of one CODONNet forward goes on the card.

    python -m codon_tpu_torch.profile_forward [--batch 4] [--dtype bf16]
        [--ckpt checkpoints/x4_ship4.npz] [--trace out/trace.json]
    python -m codon_tpu_torch.profile_forward --dtype int8
        [--ckpt checkpoints/x4_ship4_qat_static.npz]
    python -m codon_tpu_torch.profile_forward --variant codon_fused
        [--dtype int8]

Runs the forward that `cli eval` runs (padded batch, validity mask) on
random Middlebury-shaped inputs (463 x 370 valid, padded to 480 x 384),
made from --seed. Prints one JSON object: the batch's wall time from CUDA
events, the device time by kernel group from `torch.profiler`, the device's
idle share of the wall time, the busiest kernels, and, for each CAC kernel,
its device time per launch beside the wall time of its wrapper called back
to back (which includes the host's cost of a launch).

With --dtype int8 the quantized convs run in `quant_ops.Int8StaticOps` (or
`Int8Ops` for a checkpoint without act_scales). The kernel groups then
include quant_im2col's quantize and gather passes, the int8 GEMM and the
dequant epilogue, and the JSON also gives the device time of a
`record_function` range around each Ops call (`device_ms_by_range`: the
int8 convs, the float convs, and the handoffs roundtrip and precommit; a
grouped conv of `codon_fused` has a range of its own, named by its site,
e.g. `int8_conv:conv3+conv6`). --variant takes any name of the registry:
`codon_fused` (merged towers, grouped convs) and `rmcr_fuse_rmcr`
(sequential towers, no CAC) too, and the ablation zoo's `zoo:<name>`,
which without --ckpt runs the zoo's own init from --seed (and, in int8,
the dynamic per-sample scales: the zoo's convs carry no site names).
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

CAC_KERNELS = {"cac_stats_kernel": "cac_stats",
               "spatial_logits_kernel": "spatial_logits",
               "cac_apply_kernel": "cac_apply"}
QUANT_KERNELS = {"quantize_kernel": "quant:im2col_quantize",
                 "im2col_gather_kernel": "quant:im2col_gather",
                 "dequant_epilogue_kernel": "quant:epilogue"}
RANGE = "codon:"            # the record_function ranges of `_labelled`


def _is_int8_gemm(low: str) -> bool:
    """cuBLASLt's int8 GEMM kernels name their types (s8 / i8 / imma)."""
    return (any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet"))
            and re.search(r"(^|[^a-z])(s8|i8|int8|imma)", low) is not None)


def _group(name: str) -> str:
    """Kernel name -> the layer of the forward it belongs to."""
    for k, v in CAC_KERNELS.items():
        if k in name:
            return "cac:" + v
    for k, v in QUANT_KERNELS.items():
        if k in name:
            return v
    low = name.lower()
    if _is_int8_gemm(low):
        return "quant:gemm"
    if any(s in low for s in ("conv", "xmma", "gemm", "cudnn", "cutlass",
                              "nvjet", "nchwtonhwc", "nhwctonchw")):
        return "conv"        # cuDNN, and cuBLAS for the 1x1 convs
    if "clamp" in low:
        return "relu"
    if "binaryfunctor" in low or "mulfunctor" in low:
        return "multiply"    # the re-mask after every conv, the plain gate
    if "add" in low:
        return "add"         # residuals and skips
    if "copy" in low or "cat" in low or "memset" in low:
        return "copy"        # casts, concatenations
    return "other"


def _events_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_times(prof) -> tuple:
    """-> ({kernel name: (device ms summed, launches)}, {range: (device
    ms, calls)}): the device's view of each `_labelled` range (first to
    last kernel launched in it) kept apart from the kernels."""
    kernels, ranges = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            into = ranges if e.key.startswith(RANGE) else kernels
            into[e.key] = (t / 1e3, e.count)
    return kernels, ranges


def _labelled(cls):
    """A subclass of the Ops class `cls` that runs each Ops call inside a
    `record_function` range named codon:<what>, so that the profiler can
    tell where a kernel was launched from."""
    from torch.profiler import record_function
    from codon_tpu_torch.quant_ops import _skip_quant

    class Labelled(cls):
        def conv2d(self, x, w, **kw):
            what = "float_conv" if _skip_quant(w) else "int8_conv"
            if kw.get("groups", 1) > 1:
                what += ":" + str(kw.get("name"))
            with record_function(RANGE + what):
                return super().conv2d(x, w, **kw)

        def roundtrip(self, x, name=None):
            with record_function(RANGE + "roundtrip"):
                return super().roundtrip(x, name=name)

        def precommit(self, x, name=None):
            with record_function(RANGE + "precommit"):
                return super().precommit(x, name=name)

    return Labelled


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_forward", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dtype", choices=("bf16", "fp32", "fp16", "int8"),
                   default="bf16")
    p.add_argument("--ckpt", default=None,
                   help="default checkpoints/x4_ship4.npz, "
                        "checkpoints/x4_ship4_qat_static.npz with int8; a "
                        "zoo: variant's own random init")
    p.add_argument("--variant", default="codon")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None,
                   help="write the profiler's chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward measures the card: no CUDA device")

    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.kernels import cac as kc
    from codon_tpu_torch.models.variants import get_variant

    dev = torch.device("cuda")
    variant = get_variant(args.variant, DTYPE_POLICIES[args.dtype])
    if args.ckpt is None and variant.name.startswith("zoo:"):
        # the zoo ships no checkpoint: its own init, from --seed
        ckpt, scales = None, None
        params = variant.init(torch.Generator().manual_seed(args.seed), dev)
    else:
        ckpt = args.ckpt or ("checkpoints/x4_ship4_qat_static.npz"
                             if args.dtype == "int8"
                             else "checkpoints/x4_ship4.npz")
        tree = load_npz(ckpt)
        scales = tree.pop("act_scales", None)
        params = params_from_numpy(tree, dev)
    ops = None
    if args.dtype == "int8":
        from codon_tpu_torch.quant_ops import Int8Ops, Int8StaticOps
        cdt = variant.cfg.dtypes.compute_dtype
        ops = (_labelled(Int8StaticOps)(params_from_numpy(scales, dev),
                                        compute_dtype=cdt)
               if scales is not None else _labelled(Int8Ops)())
    rng = np.random.RandomState(args.seed)
    b, hp, wp, h, w = args.batch, 384, 480, 370, 463
    mask = np.zeros((b, hp, wp, 1), np.float32)
    mask[:, :h, :w] = 1.0
    depth = torch.from_numpy(rng.rand(b, hp, wp, 1).astype(np.float32)
                             * mask).to(dev)
    color = torch.from_numpy(rng.rand(b, hp, wp, 1).astype(np.float32)
                             * mask).to(dev)
    mask = torch.from_numpy(mask).to(dev)

    def fwd():
        return variant.forward(params, depth, color, mask=mask, ops=ops)

    for _ in range(3):
        fwd()
    wall_ms = _events_ms(fwd, args.iters)

    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_prof):
            fwd()
        end.record()
        torch.cuda.synchronize()
    prof_wall_ms = start.elapsed_time(end) / n_prof
    if args.trace:
        prof.export_chrome_trace(args.trace)
    times, ranges = _device_times(prof)
    groups: dict = {}
    for name, (ms, _) in times.items():
        group = _group(name)
        groups[group] = groups.get(group, 0.0) + ms / n_prof
    busy = sum(groups.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:12]

    # each CAC kernel: device time a launch against its wrapper's wall time
    # a call, back to back, at the main-path shape
    per_kernel = {}
    for name, (ms, count) in times.items():
        for k, wrapper in CAC_KERNELS.items():
            if k in name:
                row = per_kernel.setdefault(wrapper, {"device_ms": 0.0})
                row["device_ms"] += ms / count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cdt = variant.cfg.dtypes.compute_dtype
    shape = (b, hp, wp, 64)
    towers = [(torch.randn(shape, generator=gen, device=dev) * mask).to(cdt)
              for _ in range(4)]
    m = mask.to(cdt)
    gate = torch.rand((b, 1, 64), generator=gen, device=dev)
    sp_w = torch.randn((5, 5, 2, 1), generator=gen, device=dev)
    _, _, cmax, cmean = kc.cac_stats(towers[0], towers[1], m)
    logits = kc.spatial_logits(cmax, cmean, sp_w)
    calls = {"cac_stats": lambda: kc.cac_stats(towers[0], towers[1], m),
             "spatial_logits": lambda: kc.spatial_logits(cmax, cmean, sp_w),
             "cac_apply": lambda: kc.cac_apply(*towers, gate, logits)}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        per_kernel.setdefault(name, {"device_ms": None})
        per_kernel[name]["wrapper_ms"] = _events_ms(fn, 50)

    extra = {}
    if ops is not None:
        extra = {"int8_scales": "static" if scales is not None
                 else "dynamic",
                 "device_ms_by_range": {
                     k[len(RANGE):]: ms / n_prof
                     for k, (ms, _) in ranges.items()},
                 "range_calls_per_batch": {
                     k[len(RANGE):]: c / n_prof
                     for k, (_, c) in ranges.items()}}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": b,
        "dtype": args.dtype, "ckpt": ckpt, "shape": [b, hp, wp],
        "valid": [h, w],
        "wall_ms_per_batch": wall_ms, "img_per_s": b / wall_ms * 1e3,
        "profiled_wall_ms_per_batch": prof_wall_ms,
        "device_ms_per_batch": busy,
        "device_idle_share": (max(0.0, 1.0 - busy / prof_wall_ms)
                              if prof_wall_ms else None),
        "device_ms_by_group": groups,
        "top_kernels": [{"name": n[:120], "ms_per_batch": ms / n_prof,
                         "launches_per_batch": c / n_prof}
                        for n, (ms, c) in top],
        "cac_kernels": per_kernel, **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
