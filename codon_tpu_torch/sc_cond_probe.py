"""Conditioning-sensitivity probe of the scale-conditioned `codon_sc` arm.

    python -m codon_tpu_torch.sc_cond_probe [--json out.json] \
        [--ckpt checkpoints/x4_holdout_sc.npz] [--scale 4] \
        [--scenes Books,Tsukuba,Art] [--data-dir DIR]

The counterpart of `scripts/sc_cond_probe.py`. It runs the same input
with the conditioning plane set to each scale's value (4/16, 8/16, 16/16)
and prints one JSON row a scene: the masked RMSE at each value
(`rmse_by_cond`) and the mean |output delta| between values
(`mean_abs_delta`). Large deltas with the right value winning: the model
is conditioned; deltas of ~0: the plane never reaches the output (the
dead-ReLU collapse of checkpoints/x4_holdout_sc_collapsed.npz). `--json`
writes {"ckpt", "scale", "rows"}.

The scenes are read from `--data-dir`, a reference-layout scale dir
(`data.io.load_sample`); by default `CODON_X{scale}` under the working
directory, as `cli eval`'s `--data-root .` finds it (the JAX script reads
a fixed reference location and has no such flag). The forward runs on the
card; without CUDA it raises. `probe_rows` takes the device, for a caller
that runs the rows elsewhere.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.data.io import load_sample
from codon_tpu_torch.metrics.rmse import masked_rmse
from codon_tpu_torch.models.variants import get_variant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONDS = (4 / 16.0, 8 / 16.0, 16 / 16.0)


def probe_rows(params, data_dir, scenes, device):
    """-> one row a scene: {"scene", "rmse_by_cond", "mean_abs_delta"}."""
    variant = get_variant("codon_sc")
    rows = []
    for name in scenes:
        s = load_sample(data_dir, name)
        d = torch.from_numpy(s.depth.astype(np.float32)[None, ..., None]
                             / 255.0).to(device)
        c = torch.from_numpy(s.color.astype(np.float32)[None, ..., None]
                             / 255.0).to(device)
        outs = {}
        for cv in CONDS:
            x = torch.cat([d, torch.full_like(d, cv)], -1)
            out = variant.forward(params, x, c)
            outs[cv] = (torch.clamp(out[..., 0], 0.0, 1.0) * 255.0
                        )[0].cpu().numpy()
        rows.append({
            "scene": name,
            "rmse_by_cond": {f"{cv:.4f}": masked_rmse(
                s.label, np.round(outs[cv]).astype(np.uint8))
                for cv in CONDS},
            "mean_abs_delta": {
                f"{a:.2f}-{b:.2f}": float(np.mean(np.abs(outs[a] - outs[b])))
                for a, b in [(CONDS[0], CONDS[1]), (CONDS[0], CONDS[2])]}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--ckpt", default="checkpoints/x4_holdout_sc.npz")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--scenes", default="Books,Tsukuba,Art")
    ap.add_argument("--data-dir", default=None,
                    help="the reference-layout scale dir of the scenes "
                         "(default CODON_X{scale})")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    tree = load_npz(os.path.join(REPO, args.ckpt))
    tree.pop("act_scales", None)
    params = params_from_numpy(tree, device)
    data_dir = args.data_dir or f"CODON_X{args.scale}"
    rows = probe_rows(params, data_dir, args.scenes.split(","), device)
    for row in rows:
        print(json.dumps(row))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"ckpt": args.ckpt, "scale": args.scale,
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
