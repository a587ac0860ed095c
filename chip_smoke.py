#!/usr/bin/env python3
"""Drive the PyTorch port (codon_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It
  1. prints the card's name and power limit as nvidia-smi gives them;
  2. builds the CUDA kernels from codon_tpu_torch/kernels/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version on the card, in
     float32, bfloat16 and float16, at the main path's shape (batch 4,
     384 x 480 padded, a mask marking 370 x 463 valid, C = 64) and at an odd
     shape (2 x 37 x 29, one image half masked), and times the kernel, the
     plain version and, where one exists, a single PyTorch call computing
     the same function, with CUDA events after a warmup;
  4. runs `python -m codon_tpu_torch.cli eval` in-process, in bfloat16 at
     batch 4, with checkpoints/x4_ship4.npz, on a synthetic Middlebury-shaped
     scale directory (6 images of 463 x 370, 2 of 450 x 375, written with the
     port's own PNG writer), with the kernels' launch counters set to 0 just
     before and read just after; then runs the same eval again in the same
     process, to time it without the first batch's set-up;
  5. runs one float32 forward of the first batch through the kernels and
     through the plain PyTorch stage, and one small float32 forward on the
     card against the same forward on the CPU;
  6. prints the card's line again, the kernels' JSON line, then the
     contract line {"ok": true, "device": {...}} as the last line of its
     output.

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

# H100 SXM peaks (NVIDIA's data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12        # outside the tensor cores

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

DEVICE = "cuda"
MAIN_SHAPE = (4, 384, 480, 64)
MAIN_VALID = [(370, 463)] * 4
ODD_SHAPE = (2, 37, 29, 64)
ODD_VALID = [(37, 29), (19, 15)]
# the synthetic scale dir: Middlebury's 463 x 370 and a second size that
# pads to the same 480 x 384
SCENES = [(370, 463)] * 6 + [(375, 450)] * 2


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

def make_stage_inputs(shape, valid, dtype, seed):
    """Towers zero on padding, as masked convs leave them."""
    import torch
    n, h, w, c = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mask = torch.zeros((n, h, w, 1), device=DEVICE)
    for i, (vh, vw) in enumerate(valid):
        mask[i, :vh, :vw] = 1.0
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
    """Every kernel, dtype and shape: -> {name: [check, ...]}."""
    import torch
    checks = {k: [] for k in ("cac_stats", "spatial_logits", "cac_apply")}
    seed = 0
    for dname, (atol, rtol) in TOLS.items():
        dtype = getattr(torch, dname)
        for shape, valid in ((MAIN_SHAPE, MAIN_VALID), (ODD_SHAPE, ODD_VALID)):
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
            err, ok = max_err([kc.spatial_logits(cmax, cmean, sp_w)],
                              [kc.spatial_logits_plain(cmax, cmean, sp_w)],
                              atol, rtol)
            checks["spatial_logits"].append(
                {"dtype": dname, "shape": list(shape), "max_abs_err": err,
                 "ok": ok})
            err, ok = max_err(
                kc.cac_apply(out, out_c, inp, inp_c, gate, logits),
                kc.cac_apply_plain(out, out_c, inp, inp_c, gate, logits),
                atol, rtol)
            checks["cac_apply"].append(
                {"dtype": dname, "shape": list(shape), "max_abs_err": err,
                 "ok": ok})
    return checks


def time_kernels(kc):
    """Main-path shape, bfloat16 (the eval default): -> {name: timings}."""
    import torch
    import torch.nn.functional as F
    n, h, w, c = MAIN_SHAPE
    dtype = torch.bfloat16
    (out, out_c, inp, inp_c), mask, gate, sp_w, logits = \
        make_stage_inputs(MAIN_SHAPE, MAIN_VALID, dtype, seed=99)
    _, _, cmax, cmean = kc.cac_stats_plain(out, out_c, mask)
    s = out.element_size()
    nhw, nhwc = n * h * w, n * h * w * c
    k = sp_w.shape[0]
    stack = torch.stack([cmax, cmean], 1)                      # (N,2,H,W)
    w_conv = sp_w.permute(3, 2, 0, 1).to(dtype).contiguous()   # (1,2,k,k)

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    rows = {
        "cac_stats": (
            lambda: kc.cac_stats(out, out_c, mask),
            lambda: kc.cac_stats_plain(out, out_c, mask),
            None,
            # read both towers and the mask; write two maps and 2 x (N,2C)
            bound(2 * nhwc * s + nhw * s + 2 * nhw * s + 2 * n * 2 * c * 4,
                  # per element: channel sum + max, pixel sum + max
                  2 * nhwc * 4)),
        "spatial_logits": (
            lambda: kc.spatial_logits(cmax, cmean, sp_w),
            lambda: kc.spatial_logits_plain(cmax, cmean, sp_w),
            lambda: F.conv2d(stack, w_conv, padding=k // 2),
            bound(3 * nhw * s + 2 * k * k * 4, nhw * 4 * k * k)),
        "cac_apply": (
            lambda: kc.cac_apply(out, out_c, inp, inp_c, gate, logits),
            lambda: kc.cac_apply_plain(out, out_c, inp, inp_c, gate, logits),
            None,
            # 4 tower reads, 2 writes, the logits and the gate
            bound(6 * nhwc * s + nhw * s + n * c * 4,
                  # per element: gate x sigmoid, 2 multiplies, 2 adds
                  5 * nhwc)),
    }
    out_rows = {}
    for name, (kern, plain, lib, (bound_ms, bound_by)) in rows.items():
        out_rows[name] = {
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib) if lib is not None else None,
            "bound_ms": bound_ms, "bound_by": bound_by}
    return out_rows


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


def eval_once(data: str, out: str, jpath: str, batch: int):
    """One in-process `cli eval`, bf16 -> (summary, wall seconds)."""
    from codon_tpu_torch import cli
    t0 = time.time()
    rc = cli.main(["eval", "--scale", "4", "--data-dir", data,
                   "--ckpt", CKPT, "--variant", "codon", "--batch",
                   str(batch), "--dtype", "bf16", "--out", out,
                   "--json", jpath, "--device", DEVICE])
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
    from codon_tpu_torch.kernels import _build
    from codon_tpu_torch.kernels import cac as kc

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")

    # 2. build
    path, build_s = _build.build()
    _build.load()
    say(f"build: {os.path.basename(path)}: "
        + (f"nvcc {build_s:.1f} s" if build_s else "already built"))

    # 3. kernels against their plain versions
    t0 = time.time()
    checks = check_kernels(kc)
    for name, rows in checks.items():
        for r in rows:
            say(f"check {name} {r['dtype']} {tuple(r['shape'])}"
                + (f" mask={r['mask']}" if "mask" in r else "")
                + f": max_abs_err {r['max_abs_err']:.3e} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
    bad = [(n, r) for n, rows in checks.items() for r in rows if not r["ok"]]
    need(not bad, f"{len(bad)} kernel checks out of tolerance: {bad}")
    timings = time_kernels(kc)
    say(f"kernel checks and timings: {time.time() - t0:.1f} s")

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

    # 6. results
    replaces = {"cac_stats": "codon_tpu/kernels/cac.py:143",
                "spatial_logits": "codon_tpu/kernels/cac.py:193",
                "cac_apply": "codon_tpu/kernels/cac.py:239"}
    kernels = []
    for name in ("cac_stats", "spatial_logits", "cac_apply"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "codon_tpu_torch/kernels/csrc/cac.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": list(MAIN_SHAPE), "dtype": "bfloat16"})
        # the same numbers under the names the port's records use
        kernels[-1]["max_err"] = kernels[-1]["max_abs_err"]
        kernels[-1]["kernel_ms"] = kernels[-1]["ms"]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
