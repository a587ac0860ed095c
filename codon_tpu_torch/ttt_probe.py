"""Test-time training (ZSSR-style internal learning) probe.

    python -m codon_tpu_torch.ttt_probe --scale 4 \\
        --ckpt checkpoints/x4_holdout2.npz [--data-root DIR] \\
        [--images Art,Cones,Teddy] [--steps 300] [--lr 2e-5] \\
        [--warmup 20] [--patch 64] [--batch 16] \\
        [--augment full|flips|none] [--tta] [--cpu] [--json out.json]

The counterpart of `scripts/ttt_probe.py`. For each test pair (degraded
depth D, guidance C) it re-degrades D with the task's own operator
(`train.data.synthesize_lr`, bicubic down and up) into D2, fine-tunes a
fresh copy of the checkpoint's bf16 `codon` for `--steps` steps on
patches of (D2, C) -> D, no ground truth touched, and scores the model on
(D, C) before and after (with `--tta`, the 4-flip TTA forward). Round 3
measured it negative: every held-out scene regressed at every setting
tried (checkpoints/ttt_probe_x4_*.json).

Every scene is padded to one shape (the largest, rounded up to a
multiple of 32) with a mask, and scored as `cli eval` writes it: clipped
to [0, 1], times 255 and truncated to uint8, then the masked RMSE and
SSIM against input_label. It prints a line a scene and the mean RMSE;
`--json` writes {"scale", "ckpt", "steps", "lr", "tta", "augment",
"results": [{"name", "rmse_before", "ssim_before", "rmse_after",
"ssim_after", "ttt_s"}], "mean_before", "mean_after"}, the JAX script's
keys.

The scenes are read from `{data_root}/CODON_X{scale}` (`--data-root`
defaults to the working directory). It runs on the card; `--cpu` runs it
on the CPU, and without CUDA anything else raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.core.params import BF16
from codon_tpu_torch.data.io import load_sample
from codon_tpu_torch.data.pipeline import padded_hw, to_device
from codon_tpu_torch.metrics.rmse import masked_rmse
from codon_tpu_torch.metrics.ssim import ssim_exact
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.train.data import PatchSampler, synthesize_lr
from codon_tpu_torch.train.trainer import (TrainConfig, make_train_step,
                                           tree_items, tree_rebuild)


def pad_to(img: np.ndarray, H: int, W: int) -> np.ndarray:
    h, w = img.shape
    out = np.zeros((H, W), img.dtype)
    out[:h, :w] = img
    return out


def make_scorer(variant, tta: bool, hw, device):
    """-> score(params, sample) -> (masked RMSE, SSIM) of the scene's
    prediction at the padded shape `hw`, quantized as `cli eval` writes
    it."""
    def raw_fwd(p, d, c, m):
        return variant.forward(p, d, c, mask=m)

    fwd = make_tta_forward(raw_fwd) if tta else raw_fwd
    H, W = hw

    def score(params, s):
        h, w = s.depth.shape
        d = pad_to(s.depth, H, W)[None, ..., None].astype(np.float32) / 255
        c = pad_to(s.color, H, W)[None, ..., None].astype(np.float32) / 255
        m = np.zeros((1, H, W, 1), np.float32)
        m[0, :h, :w, 0] = 1.0
        out = fwd(params, *(to_device(a, device) for a in (d, c, m)))
        u8 = (torch.clamp(out[..., 0], 0.0, 1.0) * 255).to(torch.uint8)
        u8 = u8.cpu().numpy()[0, :h, :w]
        return (masked_rmse(s.label, u8),
                ssim_exact(s.label / 255, u8 / 255))
    return score


def fine_tune(variant, base_params, sample, degraded, cfg: TrainConfig,
              scale: int, patch: int, batch: int, augment: str, device):
    """`cfg.total_steps` training steps from a fresh copy of base_params on
    patches of (degraded, sample.color) -> sample.depth -> the adapted
    tree. The sampler's prefetch thread is closed on every path."""
    step_fn, opt = make_train_step(variant, cfg)
    sampler = PatchSampler(
        labels=[sample.depth], colors=[sample.color], scale=scale,
        patch=patch, batch=batch, seed=0, augment=augment,
        degraded=[degraded]).prefetch(2)
    try:
        # the optimizer updates its tree in place: each scene starts from
        # a copy of the checkpoint that shares no storage with it
        params = tree_rebuild(base_params, [
            t.detach().clone() for _, t in tree_items(base_params)])
        opt_state = opt.init(params)
        for _ in range(cfg.total_steps):
            b = {k: to_device(v, device) for k, v in sampler.sample().items()}
            params, opt_state, _ = step_fn(params, opt_state, b)
    finally:
        sampler.close()
    return params


def probe(variant, base_params, samples, cfg: TrainConfig, scale: int,
          patch: int, batch: int, augment: str, tta: bool, device) -> list:
    """-> one row a scene: its scores before and after fine-tuning on its
    own re-degraded pair, and the seconds of the fine-tuning and the
    second scoring."""
    score = make_scorer(variant, tta,
                        padded_hw([s.depth.shape for s in samples]), device)
    results = []
    for s in samples:
        r0, s0 = score(base_params, s)
        degraded = synthesize_lr(s.depth, scale)
        t0 = time.time()
        params = fine_tune(variant, base_params, s, degraded, cfg, scale,
                           patch, batch, augment, device)
        r1, s1 = score(params, s)
        dt = time.time() - t0
        results.append({"name": s.name, "rmse_before": r0,
                        "ssim_before": s0, "rmse_after": r1,
                        "ssim_after": s1, "ttt_s": dt})
        print(f"{s.name}: rmse {r0:.4f} -> {r1:.4f}  "
              f"ssim {s0:.5f} -> {s1:.5f}  ({dt:.1f}s TTT)", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, choices=(4, 8, 16), default=4)
    ap.add_argument("--data-root", default=".")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--images", default="Art,Cones,Teddy")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--augment", choices=("full", "flips", "none"),
                    default="flips")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the card otherwise)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    scale_dir = f"{args.data_root}/CODON_X{args.scale}"
    variant = get_variant("codon", dtypes=BF16)
    tree = load_npz(args.ckpt)
    tree.pop("act_scales", None)
    base_params = params_from_numpy(tree, device)
    samples = [load_sample(scale_dir, n) for n in args.images.split(",")
               if n]
    cfg = TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                      total_steps=args.steps)
    results = probe(variant, base_params, samples, cfg, args.scale,
                    args.patch, args.batch, args.augment, args.tta, device)
    mb = float(np.mean([r["rmse_before"] for r in results]))
    ma = float(np.mean([r["rmse_after"] for r in results]))
    print(f"mean rmse: {mb:.4f} -> {ma:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scale": args.scale, "ckpt": args.ckpt,
                       "steps": args.steps, "lr": args.lr,
                       "tta": args.tta, "augment": args.augment,
                       "results": results,
                       "mean_before": mb, "mean_after": ma}, f, indent=2)
        print(f"written {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
