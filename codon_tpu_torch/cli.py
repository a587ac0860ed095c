"""codon_tpu_torch command-line driver.

  python -m codon_tpu_torch.cli eval --scale 4 --data-dir CODON_X4 \\
      --ckpt checkpoints/x4_ship4.npz --out results/ --json m.json

eval  run a model over a scale directory, write PNGs, report RMSE / SSIM;
      --tta / --tta8 average over geometric transforms, --ckpt a,b averages
      a model ensemble, --device-metrics scores on the card, --dtype int8
      runs the quantized convs (static per-channel scales where the
      checkpoint carries act_scales/*, else dynamic per-sample ones)

The model runs on the card (`--device cuda`, the default) unless the caller
asks for the CPU with `--device cpu`; without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Callable

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
    e.add_argument("--ckpt", default=None, metavar="CKPT[,CKPT...]",
                   help=".npz checkpoint; random init (seed 0) if omitted. "
                        "A comma list is a model ensemble: the members' "
                        "outputs are averaged (composes with --tta)")
    e.add_argument("--variant", default="codon",
                   help="model variant name (models.variants registry); "
                        "with a --ckpt ensemble, a comma list of one name "
                        "a member, or one name for all")
    e.add_argument("--batch", type=int, default=4)
    e.add_argument("--dtype", choices=("bf16", "fp32", "fp16", "int8"),
                   default="bf16",
                   help="int8: int8 convs (codon_tpu_torch.quant_ops), the "
                        "rest in bf16")
    e.add_argument("--pad-multiple", type=int, default=32)
    e.add_argument("--out", default="CODON_result_save")
    e.add_argument("--no-save", action="store_true")
    e.add_argument("--log", default=None, help="tee stdout to this file")
    e.add_argument("--json", default=None,
                   help="write a structured metrics summary to this file")
    e.add_argument("--scale-cond", action="store_true",
                   help="append the constant scale/16 conditioning channel "
                        "to the depth input (codon_sc variants)")
    e.add_argument("--tta", action="store_true",
                   help="geometric self-ensemble: average the forward over "
                        "the 4 flips (id/V/H/HV), each mapped back; 4x "
                        "compute; masks flip with the content")
    e.add_argument("--tta8", action="store_true",
                   help="full dihedral self-ensemble (the 4 flips and their "
                        "transposes, 8x compute); implies --tta")
    e.add_argument("--device-metrics", action="store_true",
                   help="compute RMSE / SSIM on the card after the forward "
                        "(the per-image scalars and the uint8 output are "
                        "the only copies back; RMSE exact, SSIM on padded "
                        "images by normalized convolution at the border, "
                        "see metrics/ondevice.py)")
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


def _load_params(ckpt, variant, device):
    """-> (params, act_scales): the checkpoint's `act_scales/*` split off
    as {site: (C,) float32 tensor on the device}, or None without them."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy

    dt = variant.cfg.dtypes.param_dtype
    if ckpt is None:
        print("WARNING: no --ckpt given; using random init "
              "(outputs will not match the reference).")
        return (variant.init(torch.Generator().manual_seed(0),
                             device=device), None)
    if not ckpt.endswith(".npz"):
        raise SystemExit(f"--ckpt {ckpt}: the port reads native .npz "
                         f"checkpoints only")
    tree = load_npz(ckpt)
    scales = tree.pop("act_scales", None)
    params = params_from_numpy(tree, device, dt)
    if scales is not None:
        scales = params_from_numpy(scales, device, torch.float32)
    print(f"loaded native checkpoint {ckpt}")
    return params, scales


def _load_members(args, dtypes, device):
    """--ckpt and --variant -> ([(params, act_scales, variant)], ensemble?).

    A comma list of checkpoints is an ensemble, with one variant name for
    all members or one a member. Each member is a native .npz carried
    across to tensors by `checkpoint.native.params_from_numpy`, as a single
    checkpoint is: an ensemble needs no converter of its own.
    """
    from codon_tpu_torch.models.variants import get_variant

    vnames = args.variant.split(",")
    if args.ckpt and "," in args.ckpt:
        ckpts = args.ckpt.split(",")
        if len(vnames) not in (1, len(ckpts)):
            raise SystemExit(
                f"--variant lists {len(vnames)} names for {len(ckpts)} "
                f"--ckpt members (give 1 or {len(ckpts)})")
        variants = [get_variant(v, dtypes=dtypes) for v in
                    (vnames * len(ckpts) if len(vnames) == 1 else vnames)]
        members = [(*_load_params(ck, v, device), v)
                   for ck, v in zip(ckpts, variants)]
        print(f"ensemble: averaging {len(members)} models"
              + (f" [{', '.join(v.name for v in variants)}]"
                 if len(vnames) > 1 else ""))
        return members, True
    if len(vnames) > 1:
        raise SystemExit("--variant lists multiple names but --ckpt is not "
                         "an ensemble")
    variant = get_variant(vnames[0], dtypes=dtypes)
    return [(*_load_params(args.ckpt, variant, device), variant)], False


def _member_ops(dtype, members, ensemble):
    """One Ops backend a member: None (float) unless dtype is int8, then
    Int8StaticOps on the member's act_scales, or Int8Ops without them. The
    banners are the JAX package's, word for word."""
    if dtype != "int8":
        return [None] * len(members)
    from codon_tpu_torch.quant_ops import Int8Ops, Int8StaticOps
    if ensemble:
        modes = ["static" if sc is not None else "dynamic"
                 for _, sc, _ in members]
        print(f"int8: per-member scales [{', '.join(modes)}]")
    elif members[0][1] is not None:
        print(f"int8: static per-channel scales from checkpoint "
              f"({len(members[0][1])} conv sites)")
    else:
        print("int8: dynamic per-sample scales (checkpoint carries no "
              "act_scales; train --qat-static to add them)")
    return [Int8StaticOps(sc, compute_dtype=v.cfg.dtypes.compute_dtype)
            if sc is not None else Int8Ops() for _, sc, v in members]


@dataclasses.dataclass
class EvalForward:
    """What `eval` runs. fwd(params, depth, color, mask) -> float32
    (N, H, W, 1)."""
    fwd: Callable
    params: Any              # a parameter tree, or a list of them
    tta: int                 # 0, 4 or 8 transforms
    ensemble: bool


def make_eval_forward(args, device) -> EvalForward:
    """The forward of `eval`, from its arguments.

    The wrappers nest as in `codon_tpu.cli eval`: the scale-conditioning
    plane innermost (a constant is flip- and transpose-invariant, so the
    geometric transforms act on the 1-channel depth), the ensemble mean over
    each member's own forward (with its own int8 backend) around it, then
    TTA around it all.
    """
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.models.variants import with_scale_cond

    members, ensemble = _load_members(args, DTYPE_POLICIES[args.dtype],
                                      device)
    member_ops = _member_ops(args.dtype, members, ensemble)
    cond = args.scale / 16.0 if args.scale_cond else None

    def member_fwd(v, ops):
        def fwd(p, d, c, m):
            return v.forward(p, d, c, mask=m, ops=ops)
        return with_scale_cond(fwd, cond) if cond is not None else fwd

    fwds = [member_fwd(v, ops) for (_, _, v), ops in zip(members, member_ops)]
    if ensemble:
        params = [p for p, _, _ in members]

        def inner(plist, d, c, m):
            outs = [f(p, d, c, m) for p, f in zip(plist, fwds)]
            return sum(outs) / len(outs)
    else:
        params = members[0][0]
        inner = fwds[0]
    tta_n = 8 if args.tta8 else (4 if args.tta else 0)
    fwd = inner
    if tta_n:
        from codon_tpu_torch.models.tta import make_tta_forward
        fwd = make_tta_forward(inner, transforms=tta_n)
    return EvalForward(fwd, params, tta_n, ensemble)


def cmd_eval(args) -> int:
    from codon_tpu_torch.data.io import discover_pairs, imwrite_gray
    from codon_tpu_torch.data.pipeline import batched_loader
    from codon_tpu_torch.metrics.rmse import masked_rmse
    from codon_tpu_torch.metrics.ssim import ssim_exact
    from codon_tpu_torch.utils.logging import Logger

    device = _device(args.device)
    log_ctx = Logger(args.log) if args.log else None
    if log_ctx:
        log_ctx.__enter__()
    try:
        scale_dir = _scale_dir(args)
        ef = make_eval_forward(args, device)
        names = discover_pairs(scale_dir)
        print(f"eval x{args.scale}: {len(names)} images from {scale_dir} "
              f"[{args.dtype}, batch={args.batch}, variant={args.variant}, "
              f"device={device}]")
        if args.scale_cond:
            print(f"scale conditioning: constant channel {args.scale / 16.0}")
        if ef.tta:
            print(f"tta: {ef.tta}-transform geometric self-ensemble")
        evaluator = None
        if args.device_metrics:
            if ef.ensemble:
                raise SystemExit("--ckpt ensembles are not supported with "
                                 "--device-metrics")
            from codon_tpu_torch.metrics.ondevice import make_batch_evaluator
            evaluator = make_batch_evaluator(ef.fwd)

        def fwd_u8(d, c, m):
            out = ef.fwd(ef.params, d, c, m)
            # the reference's (clip(out,0,1)*255).astype(uint8): truncation
            u8 = (out[..., 0].clamp(0.0, 1.0) * 255).to(torch.uint8)
            return u8.cpu().numpy()

        rmse_sum = ssim_sum = 0.0
        per_image = []
        n = 0
        t_compute = 0.0
        batch_times = []

        def score(name, r, s):
            nonlocal rmse_sum, ssim_sum, n
            rmse_sum += r
            ssim_sum += s
            n += 1
            per_image.append({"name": name, "rmse": r, "ssim": s})
            print(f"{name}.png {r} {s}")

        t0_all = time.time()
        for batch in batched_loader(scale_dir, names, args.batch,
                                    args.pad_multiple, device=device):
            t0 = time.time()
            on_card = evaluator is not None and batch.label_dev is not None
            if on_card:
                # mask=None passes through: the metrics' exact unmasked
                # paths for a batch that fills the padded shape
                stats = evaluator(ef.params, batch.depth, batch.color,
                                  batch.mask, batch.label_dev)
                rmse_v = stats["rmse"].cpu().numpy()
                ssim_v = stats["ssim"].cpu().numpy()
                out = (stats["out_u8"].cpu().numpy()
                       if not args.no_save else None)
            else:
                out = fwd_u8(batch.depth, batch.color, batch.mask)
            dt = time.time() - t0
            t_compute += dt
            batch_times.append((dt, len(batch.names)))
            for i, name in enumerate(batch.names):
                h, w = batch.sizes[i]
                img_u8 = None if out is None else out[i, :h, :w]
                if not args.no_save:
                    imwrite_gray(os.path.join(args.out, name + ".png"),
                                 img_u8)
                label = batch.labels[i]
                if on_card:
                    score(name, float(rmse_v[i]), float(ssim_v[i]))
                elif label is not None:
                    score(name, masked_rmse(label, img_u8),
                          ssim_exact(label / 255, img_u8 / 255))
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
            "tta_transforms": ef.tta,
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
