"""The serving deployment matrix: export each shipping artifact, and check it.

    python -m codon_tpu_torch.export_matrix [--load-check]
        [--out-dir artifacts/export_matrix] [--device cuda]

The counterpart of `scripts/export_matrix.py`. Exports the shipping
configuration of each scale (the static-int8 QAT checkpoint, its
calibrated scales baked in, `codon` in bf16 with `Int8StaticOps`) at the
reference eval resolution 463 x 370, plus the quality-flagship TTA-wrapped
int8 artifacts at x4 (the 4 flips, and the full dihedral group). Prints
one JSON line an artifact: its name, scale, TTA, platform, the card (name
and power limit as nvidia-smi prints them; null on the CPU), size in MB
and export seconds; with --load-check also loads each artifact
(`serve.load_exported`) and times the load, the first call (which builds
the kernel library if this process has not) and one steady call on a
batch of one random image, the result copied back to the host.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 370, 463     # reference eval size (Art.png)
# (scale, tta): 0 = plain, 4 = flip quartet, 8 = full dihedral
JOBS = [(4, 0), (8, 0), (16, 0), (4, 4), (4, 8)]
CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")


def best_ckpt(scale: int) -> str:
    for name in (f"x{scale}_qat_static2.npz", f"x{scale}_qat_static.npz"):
        p = os.path.join(CKPT_DIR, name)
        if os.path.exists(p):
            return p
    raise SystemExit(f"no static QAT checkpoint for x{scale}")


def card(device: torch.device):
    """The card's name and power limit as nvidia-smi prints them; None on
    the CPU."""
    if device.type != "cuda":
        return None
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(out_dir: str, load_check: bool = False, device="cuda") -> list:
    """Export (and with load_check, load and call) every job. -> one
    record a job, also printed as a JSON line."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.core.device import resolve_device
    from codon_tpu_torch.core.params import BF16
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8StaticOps
    from codon_tpu_torch.serve import export_forward, load_exported

    device = resolve_device(device)
    card_name = card(device)
    os.makedirs(out_dir, exist_ok=True)
    records = []
    for scale, tta in JOBS:
        variant = get_variant("codon", dtypes=BF16)
        tree = load_npz(best_ckpt(scale))
        scales = params_from_numpy(tree.pop("act_scales"), device)
        params = params_from_numpy(tree, device)
        ops = Int8StaticOps(scales,
                            compute_dtype=variant.cfg.dtypes.compute_dtype)
        name = (f"codon_x{scale}_{W}x{H}_int8"
                f"{f'_tta{tta}' if tta else ''}.pt2")
        path = os.path.join(out_dir, name)
        t0 = time.perf_counter()
        nbytes = export_forward(variant, params, (H, W), path, ops=ops,
                                tta=tta)
        rec = {"artifact": name, "scale": scale, "tta": tta,
               "platform": device.type, "card": card_name,
               "size_mb": nbytes / 1e6,
               "export_s": time.perf_counter() - t0}
        if load_check:
            t0 = time.perf_counter()
            fn = load_exported(path, device)
            rec["load_s"] = time.perf_counter() - t0
            rng = np.random.RandomState(0)
            d = rng.rand(1, H, W, 1).astype(np.float32)
            c = rng.rand(1, H, W, 1).astype(np.float32)
            t0 = time.perf_counter()
            out = fn(d, c).cpu().numpy()
            rec["first_call_s"] = time.perf_counter() - t0
            _sync(device)
            t0 = time.perf_counter()
            out = fn(d, c).cpu().numpy()
            rec["steady_call_s"] = time.perf_counter() - t0
            if out.shape != (1, H, W, 1) or not np.isfinite(out).all():
                raise RuntimeError(f"{name}: output {out.shape}, finite "
                                   f"{bool(np.isfinite(out).all())}")
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="export_matrix", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out-dir", default=os.path.join("artifacts",
                                                      "export_matrix"))
    ap.add_argument("--load-check", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the artifacts are traced for and run "
                         "on; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    run(args.out_dir, args.load_check, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
