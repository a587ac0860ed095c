"""codon_tpu_torch command-line driver.

  python -m codon_tpu_torch.cli eval --scale 4 --data-dir CODON_X4 \\
      --ckpt checkpoints/x4_ship4.npz --out results/ --json m.json

eval  run a model over a scale directory, write PNGs, report RMSE / SSIM

The model runs on the card (`--device cuda`, the default) unless the caller
asks for the CPU with `--device cpu`; without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="codon_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("eval", help="run the model over a dataset")
    e.add_argument("--scale", type=int, choices=(4, 8, 16), default=4)
    e.add_argument("--data-root", default=".",
                   help="directory containing CODON_X{scale}/")
    e.add_argument("--data-dir", default=None,
                   help="explicit scale dir (overrides --data-root)")
    e.add_argument("--ckpt", default=None,
                   help=".npz checkpoint; random init (seed 0) if omitted")
    e.add_argument("--variant", default="codon",
                   help="model variant name (models.variants registry)")
    e.add_argument("--batch", type=int, default=4)
    e.add_argument("--dtype", choices=("bf16", "fp32", "fp16"),
                   default="bf16")
    e.add_argument("--pad-multiple", type=int, default=32)
    e.add_argument("--out", default="CODON_result_save")
    e.add_argument("--no-save", action="store_true")
    e.add_argument("--log", default=None, help="tee stdout to this file")
    e.add_argument("--json", default=None,
                   help="write a structured metrics summary to this file")
    e.add_argument("--scale-cond", action="store_true",
                   help="append the constant scale/16 conditioning channel "
                        "to the depth input (codon_sc variants)")
    e.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def _scale_dir(args) -> str:
    if args.data_dir:
        return args.data_dir
    return os.path.join(args.data_root, f"CODON_X{args.scale}")


def _device(name: str) -> torch.device:
    from codon_tpu_torch.core.device import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def _load_params(args, variant, device):
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy

    dt = variant.cfg.dtypes.param_dtype
    if args.ckpt is None:
        print("WARNING: no --ckpt given; using random init "
              "(outputs will not match the reference).")
        return variant.init(torch.Generator().manual_seed(0), device=device)
    if not args.ckpt.endswith(".npz"):
        raise SystemExit(f"--ckpt {args.ckpt}: the port reads native .npz "
                         f"checkpoints only")
    params = params_from_numpy(load_npz(args.ckpt), device, dt)
    print(f"loaded native checkpoint {args.ckpt}")
    return params


def cmd_eval(args) -> int:
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.data.io import discover_pairs, imwrite_gray
    from codon_tpu_torch.data.pipeline import batched_loader
    from codon_tpu_torch.metrics.rmse import masked_rmse
    from codon_tpu_torch.metrics.ssim import ssim_exact
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.utils.logging import Logger

    device = _device(args.device)
    log_ctx = Logger(args.log) if args.log else None
    if log_ctx:
        log_ctx.__enter__()
    try:
        scale_dir = _scale_dir(args)
        variant = get_variant(args.variant, dtypes=DTYPE_POLICIES[args.dtype])
        params = _load_params(args, variant, device)
        names = discover_pairs(scale_dir)
        print(f"eval x{args.scale}: {len(names)} images from {scale_dir} "
              f"[{args.dtype}, batch={args.batch}, variant={args.variant}, "
              f"device={device}]")
        cond = args.scale / 16.0 if args.scale_cond else None
        if cond is not None:
            print(f"scale conditioning: constant channel {cond}")

        def fwd_u8(d, c, m):
            if cond is not None:
                d = torch.cat([d, torch.full_like(d[..., :1], cond)], -1)
            out = variant.forward(params, d, c, mask=m)
            # the reference's (clip(out,0,1)*255).astype(uint8): truncation
            u8 = (out[..., 0].clamp(0.0, 1.0) * 255).to(torch.uint8)
            return u8.cpu().numpy()

        rmse_sum = ssim_sum = 0.0
        per_image = []
        n = 0
        t_compute = 0.0
        batch_times = []
        t0_all = time.time()
        for batch in batched_loader(scale_dir, names, args.batch,
                                    args.pad_multiple, device=device):
            t0 = time.time()
            out = fwd_u8(batch.depth, batch.color, batch.mask)
            dt = time.time() - t0
            t_compute += dt
            batch_times.append((dt, len(batch.names)))
            for i, name in enumerate(batch.names):
                h, w = batch.sizes[i]
                img_u8 = out[i, :h, :w]
                if not args.no_save:
                    imwrite_gray(os.path.join(args.out, name + ".png"),
                                 img_u8)
                label = batch.labels[i]
                if label is not None:
                    r = masked_rmse(label, img_u8)
                    s = ssim_exact(label / 255, img_u8 / 255)
                    rmse_sum += r
                    ssim_sum += s
                    n += 1
                    per_image.append({"name": name, "rmse": r, "ssim": s})
                    print(f"{name}.png {r} {s}")
        t_total = time.time() - t0_all
        # steady state leaves out the first batch: it pays cuDNN's and the
        # kernels' first-call set-up
        steady = None
        if len(batch_times) > 1:
            dt = sum(t for t, _ in batch_times[1:])
            imgs = sum(k for _, k in batch_times[1:])
            steady = imgs / dt if dt > 0 else None
        summary = {
            "scale": args.scale, "images": len(names),
            "img_per_sec_steady": steady,
            "mean_rmse": rmse_sum / n if n else None,
            "mean_ssim": ssim_sum / n if n else None,
            "img_per_sec_e2e": len(names) / t_total if t_total else None,
            "img_per_sec_compute": (len(names) / t_compute
                                    if t_compute else None),
            "tta_transforms": 0,
            "per_image": per_image,
        }
        if n:
            print(n)
            print(rmse_sum / n, ssim_sum / n)
        print(f"images/sec (end-to-end): {summary['img_per_sec_e2e']:.3f}  "
              f"(compute+D2H only: {summary['img_per_sec_compute']:.3f})")
        if steady:
            print(f"images/sec (steady-state, first batch excluded): "
                  f"{steady:.3f}")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(summary, f, indent=2)
            print(f"metrics written to {args.json}")
        return 0
    finally:
        if log_ctx:
            log_ctx.__exit__(None, None, None)


def main(argv=None) -> int:
    args = _build_argparser().parse_args(argv)
    return {"eval": cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
