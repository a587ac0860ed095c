"""Probe: does translation self-ensembling (shift-TTA) help at eval time?

    python -m codon_tpu_torch.tta_shift_probe --scale 4 \\
        --ckpt checkpoints/x4_holdout2.npz [--data-root DIR] \\
        [--variant codon] [--batch 4] [--json out.json] [--device cpu]

The counterpart of `scripts/tta_shift_probe.py`. It predicts with the
bf16 TTA4 forward (`models.tta`, the 4 flips in one forward of 4x the
batch) on edge-padded copies of every input pair shifted by one pixel
(SHIFTS), unshifts the predictions and averages them into the plain TTA4
output. The degradation in input_depth is phase-locked to the
subsampling grid, so a 1-px shift changes the input's phase against it:
the probe measures whether averaging over phases denoises, as the flips
do, or mismatches the learned degradation. Round 3 measured it negative
on the Middlebury holdout (checkpoints/shift_probe_x4_holdout2.json).

All shifts and batches share one padded shape (the largest scene rounded
up to a multiple of 32, as `cli eval` pads) and always pass a mask. Each
prediction is scored as `cli eval` writes it: clipped to [0, 1], times
255 and truncated to uint8 in float32, then the masked RMSE and SSIM
against input_label. It prints a line per
shift and per scene and the means; `--json` writes {"scale", "ckpt",
"mean_tta4", "mean_shift5", "per_image": [{"name", "tta4_rmse",
"tta4_ssim", "shift5_rmse", "shift5_ssim"}]}, the JAX script's keys.

The scenes are the reference-layout dir `{data_root}/CODON_X{scale}`
(`--data-root` defaults to the working directory). The forward runs on
the card; without CUDA it raises unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.core.params import BF16
from codon_tpu_torch.data.io import discover_pairs, load_sample
from codon_tpu_torch.data.pipeline import make_batch, padded_hw
from codon_tpu_torch.metrics.rmse import masked_rmse
from codon_tpu_torch.metrics.ssim import ssim_exact
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant

SHIFTS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


def shift2d(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Shift a (H, W) array by (dy, dx) with edge replication."""
    p = np.pad(a, ((1, 1), (1, 1)), mode="edge")
    h, w = a.shape
    return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def shifted_predictions(variant, params, samples, batch: int, device):
    """-> {name: {shift: (h, w) float64 TTA4 prediction, unshifted}}.

    One TTA4 forward a batch of `batch` scenes a shift, at one padded
    shape for all (a short last batch filled with its last scene)."""
    fwd = make_tta_forward(
        lambda p, d, c, m: variant.forward(p, d, c, mask=m))
    fixed_hw = padded_hw([s.depth.shape for s in samples])
    preds = {s.name: {} for s in samples}
    for dy, dx in SHIFTS:
        shifted = [dataclasses.replace(s, depth=shift2d(s.depth, dy, dx),
                                       color=shift2d(s.color, dy, dx))
                   for s in samples]
        for i in range(0, len(shifted), batch):
            b = make_batch(shifted[i:i + batch], device=device,
                           target_batch=batch, fixed_hw=fixed_hw)
            m = torch.ones_like(b.depth) if b.mask is None else b.mask
            out = fwd(params, b.depth, b.color, m).cpu().numpy()
            for j, name in enumerate(b.names):
                h, w = b.sizes[j]
                pred = out[j, :h, :w, 0].astype(np.float64)
                preds[name][(dy, dx)] = shift2d(pred, -dy, -dx)
        print(f"shift ({dy:+d},{dx:+d}) done", flush=True)
    return preds


def score(label: np.ndarray, pred: np.ndarray) -> tuple:
    """-> (masked RMSE, SSIM) of a float prediction, quantized as the
    deployment does: clip and times 255 in float32, then truncation."""
    f32 = np.clip(pred.astype(np.float32), np.float32(0.0),
                  np.float32(1.0)) * np.float32(255.0)
    u8 = f32.astype(np.uint8)
    return masked_rmse(label, u8), ssim_exact(label / 255, u8 / 255)


def probe_rows(samples, preds) -> list:
    """-> one row a scene: the plain TTA4 scores and those of the 5-shift
    average."""
    rows = []
    for s in samples:
        r0, s0 = score(s.label, preds[s.name][(0, 0)])
        avg5 = np.mean([preds[s.name][sh] for sh in SHIFTS], 0)
        r5, s5 = score(s.label, avg5)
        rows.append({"name": s.name, "tta4_rmse": r0, "tta4_ssim": s0,
                     "shift5_rmse": r5, "shift5_ssim": s5})
        print(f"{s.name}: tta4 {r0:.4f} -> shift5 {r5:.4f}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--data-root", default=".")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--variant", default="codon")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scale_dir = f"{args.data_root}/CODON_X{args.scale}"
    samples = [load_sample(scale_dir, n) for n in discover_pairs(scale_dir)]
    variant = get_variant(args.variant, dtypes=BF16)
    tree = load_npz(args.ckpt)
    tree.pop("act_scales", None)
    params = params_from_numpy(tree, device)
    preds = shifted_predictions(variant, params, samples, args.batch,
                                device)
    rows = probe_rows(samples, preds)
    m0 = float(np.mean([r["tta4_rmse"] for r in rows]))
    m5 = float(np.mean([r["shift5_rmse"] for r in rows]))
    print(f"mean tta4 {m0:.4f} -> +4-shift ensemble {m5:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"scale": args.scale, "ckpt": args.ckpt,
                       "mean_tta4": m0, "mean_shift5": m5,
                       "per_image": rows}, f, indent=1)
        print(f"written {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
