"""codon_tpu_torch command-line driver.

  python -m codon_tpu_torch.cli eval --scale 4 --data-dir CODON_X4 \\
      --ckpt checkpoints/x4_ship4.npz --out results/ --json m.json

eval     run a model over a scale directory, write PNGs, report RMSE /
         SSIM; --tta / --tta8 average over geometric transforms, --ckpt
         a,b averages a model ensemble (.npz or the reference's .pth),
         --device-metrics scores on the card, --dtype int8 runs the
         quantized convs (static per-channel scales where the checkpoint
         carries act_scales/*, else dynamic per-sample ones); --resume,
         --profile DIR, --check-nans; --tile-devices / --dp-devices run
         the forward over a dp x sp mesh of ranks (--dist-backend)
train    train a model on patches of a scale dir (shipped input_depth/ or
         synthesized bicubic degradation): Adam(W) with warmup + cosine,
         clip-norm, l1 / l2 and --grad-loss, --qat / --qat-static,
         --ema, step checkpoints with resume (--orbax-dir)
golden   score a scale dir's archived output/ PNGs against input_label/
convert  the reference's torch .pth -> native .npz checkpoint
export   the forward (weights, int8 scales, TTA, mask input, scale plane
         baked in) as a torch.export serving artifact with a symbolic
         batch; run it with `serve.load_exported`
info     the device, a variant's parameter count, the variant registry

The model runs on the card (`--device cuda`, the default) unless the caller
asks for the CPU with `--device cpu`; without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
from typing import Any, Callable, Optional

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
    e.add_argument("--ckpt", default=None, metavar="CKPT[,CKPT...]",
                   help=".npz or .pth checkpoint; random init (seed 0) if "
                        "omitted. A comma list is a model ensemble: the "
                        "members' outputs are averaged (composes with "
                        "--tta)")
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
    e.add_argument("--resume", action="store_true",
                   help="skip images whose output PNG already exists "
                        "(not with --no-save)")
    e.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the eval loop with torch.profiler (CPU, and "
                        "CUDA on the card) and write a Chrome trace into "
                        "DIR")
    e.add_argument("--check-nans", action="store_true",
                   help="fail fast on NaN: check every conv site's output "
                        "and the forward's, raising FloatingPointError "
                        "that names the site (syncs the card at every "
                        "conv)")
    e.add_argument("--tile-devices", type=int, default=0,
                   help=">1: spatially tiled inference over N ranks (the "
                        "image's H axis sharded, halo-exchange convs, "
                        "all-reduced CAC statistics)")
    e.add_argument("--dp-devices", type=int, default=0,
                   help=">1: batch data-parallel inference over N ranks "
                        "(the DataParallel analog; composes with "
                        "--tile-devices into a dp x sp mesh)")
    e.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="the mesh's torch.distributed backend: nccl (the "
                        "default on CUDA, one card a rank) or gloo (the "
                        "CPU's; on CUDA ranks share cards, rank r on "
                        "cuda:(r %% cards))")
    e.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")

    t = sub.add_parser("train", help="train a model on patches")
    t.add_argument("--scale", type=int, choices=(4, 8, 16), default=4)
    t.add_argument("--data-root", default=".",
                   help="directory containing CODON_X{scale}/")
    t.add_argument("--data-dir", default=None,
                   help="explicit scale dir (overrides --data-root)")
    t.add_argument("--variant", default="codon")
    t.add_argument("--steps", type=int, default=2000)
    t.add_argument("--patch", type=int, default=64)
    t.add_argument("--batch", type=int, default=16)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--warmup", type=int, default=0,
                   help=">0: warmup+cosine schedule over --steps")
    t.add_argument("--loss", choices=("l1", "l2"), default="l1")
    t.add_argument("--grad-loss", type=float, default=0.0,
                   help=">0: add this weight of masked gradient-domain L1 "
                        "(edge supervision) to the pixel loss")
    t.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled weight decay (AdamW)")
    t.add_argument("--clip-norm", type=float, default=0.0,
                   help=">0: clip the global gradient norm before the "
                        "optimizer update (optax's clip_by_global_norm)")
    t.add_argument("--dtype", choices=("bf16", "fp32", "fp16"),
                   default="bf16")
    t.add_argument("--seed", type=int, default=0,
                   help="seeds the patch stream and a random init")
    t.add_argument("--ckpt-in", default=None, help="warm start from .npz")
    t.add_argument("--ckpt-out", default="codon_trained.npz")
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--check-nans", action="store_true",
                   help="fail fast on NaN: check every conv site's output, "
                        "and the loss and every gradient each step, "
                        "raising FloatingPointError (syncs the card)")
    t.add_argument("--exclude", default="",
                   help="comma-separated image names to hold out")
    t.add_argument("--mix-scales", action="store_true",
                   help="also train on the shipped degradations of the "
                        "same scenes from the other scale dirs under "
                        "--data-root")
    t.add_argument("--edge-bias", type=float, default=0.0,
                   help="probability in (0,1] that a patch is centred, "
                        "with jitter, on a depth-discontinuity pixel")
    t.add_argument("--scene-weight", default=None,
                   help="comma list Name=W of per-scene sampling weights "
                        "(unlisted scenes weigh 1.0)")
    t.add_argument("--collage", type=float, default=0.0,
                   help="probability in [0,1] that a patch gets a "
                        "depth-collage paste from another scene")
    t.add_argument("--scale-cond", action="store_true",
                   help="append a constant scale/16 channel to the depth "
                        "input (with --variant codon_sc)")
    t.add_argument("--augment", choices=("full", "flips", "none"),
                   default="full",
                   help="full = flips+rot90+photometric guidance jitter+"
                        "depth affine; flips = geometric only")
    t.add_argument("--orbax-dir", default=None,
                   help="step checkpoints of {params, opt_state, step} "
                        "every --save-every steps into this directory "
                        "(async, atomic, keep-last-3), resuming from its "
                        "latest step if it has one. The name is the JAX "
                        "package's; the format is this port's own "
                        "(step_<n>/tree.npz), and the two packages do not "
                        "read each other's step directories")
    t.add_argument("--save-every", type=int, default=500)
    t.add_argument("--no-handoff", action="store_true",
                   help="with --qat-static: drop the handoff grids "
                        "(roundtrip sites) from the calibration")
    t.add_argument("--qat-static", action="store_true",
                   help="QAT on frozen per-channel static activation "
                        "scales calibrated on full frames first; the "
                        "scales are saved with the weights (eval --dtype "
                        "int8 then runs the static path)")
    t.add_argument("--qat", action="store_true",
                   help="quantization-aware fine-tuning on dynamic scales")
    t.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="keep an EMA of the weights and save it beside "
                        "--ckpt-out as <out>_ema.npz")
    t.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")

    g = sub.add_parser("golden", help="score archived outputs")
    g.add_argument("--scale", type=int, choices=(4, 8, 16), default=4)
    g.add_argument("--data-root", default=".",
                   help="directory containing CODON_X{scale}/")
    g.add_argument("--data-dir", default=None,
                   help="explicit scale dir (overrides --data-root)")

    c = sub.add_parser("convert", help="torch .pth -> .npz")
    c.add_argument("--pth", required=True)
    c.add_argument("--npz", required=True)
    c.add_argument("--no-dead-heads", action="store_true",
                   help="X16-style checkpoints without attention_{c5,s5}")

    x = sub.add_parser("export",
                       help="export the forward (weights baked in) as a "
                            "torch.export serving artifact, batch-"
                            "symbolic; platform = --device")
    x.add_argument("--ckpt", required=True)
    x.add_argument("--out", required=True)
    x.add_argument("--variant", default="codon")
    x.add_argument("--height", type=int, default=370)
    x.add_argument("--width", type=int, default=463)
    x.add_argument("--dtype", choices=("bf16", "fp32", "int8"),
                   default="bf16")
    x.add_argument("--mask", action="store_true",
                   help="artifact takes a validity-mask input "
                        "(padded-batch serving)")
    x.add_argument("--tta", action="store_true",
                   help="bake the 4-flip self-ensemble into the artifact "
                        "(batched)")
    x.add_argument("--tta8", action="store_true",
                   help="bake the full 8-transform dihedral self-ensemble "
                        "(quality-flagship serving config when combined "
                        "with --dtype int8); implies --tta")
    x.add_argument("--scale", type=int, choices=(4, 8, 16), default=4,
                   help="upsampling factor baked into --scale-cond "
                        "artifacts")
    x.add_argument("--scale-cond", action="store_true",
                   help="bake the constant scale/16 conditioning plane "
                        "into the artifact (codon_sc variants; callers "
                        "still feed 1-channel depth)")
    x.add_argument("--device", default="cuda",
                   help="torch device the artifact is traced for and runs "
                        "on; 'cpu' for the CPU")

    i = sub.add_parser("info", help="model and device summary")
    i.add_argument("--variant", default="codon")
    i.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' for the CPU")
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
    if ckpt.endswith(".pth"):
        from codon_tpu_torch.checkpoint.torch_convert import load_pth
        tree, epoch = load_pth(ckpt, variant.cfg)
        print(f"loaded torch checkpoint {ckpt} (epoch {epoch})")
        return params_from_numpy(tree, device, dt), None
    if not ckpt.endswith(".npz"):
        raise SystemExit(f"--ckpt {ckpt}: expected a native .npz or a "
                         f"torch .pth checkpoint")
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
    all members or one a member. Each member (.npz or .pth) is carried
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
    (N, H, W, 1). close() stops the mesh's ranks, if it has any;
    mesh_report() gives the `--json` summary's "mesh" entry of a mesh
    eval (`_mesh_report`)."""
    fwd: Callable
    params: Any              # a parameter tree, or a list of them
    tta: int                 # 0, 4 or 8 transforms
    ensemble: bool
    close: Callable = lambda: None
    mesh_report: Optional[Callable] = None


def _mesh_forwards(args, members, device):
    """The members' forwards over a dp x sp mesh of `MeshPool` ranks, as
    `codon_tpu.cli eval --tile-devices/--dp-devices` builds them; int8
    stays int8 there (JAX's round-1 bug was a mesh branch that fell back to
    bf16): static members take their scales through scales_factory, in
    their parameter trees, dynamic ones `Int8ShardedOps` (`Int8Ops` on a
    pure dp mesh). -> (forwards, parameter trees, the pool)."""
    from codon_tpu_torch.parallel import MeshPool, make_tiled_forward
    from codon_tpu_torch.parallel.launch import reset_rank_counts
    from codon_tpu_torch.parallel.quant import (Int8ShardedOps,
                                                static_int8_ops)
    from codon_tpu_torch.quant_ops import Int8Ops

    dp, sp = max(1, args.dp_devices), max(1, args.tile_devices)
    pool = MeshPool(dp * sp, device=device, backend=args.dist_backend)
    fwds, trees = [], []
    try:
        # every rank's tallies from here on are this eval's
        pool.call(reset_rank_counts)
        for p, sc, v in members:
            kw = {}
            if args.dtype == "int8" and sc is not None:
                kw["scales_factory"] = functools.partial(
                    static_int8_ops,
                    compute_dtype=v.cfg.dtypes.compute_dtype)
                p = dict(p, act_scales=sc)
            elif args.dtype == "int8":
                kw = {"ops_factory": Int8ShardedOps, "local_ops": Int8Ops()}
            fwds.append(make_tiled_forward(v, sp, dp, pool=pool,
                                           check_nans=args.check_nans, **kw))
            trees.append(p)
    except BaseException:
        pool.close()
        raise
    cards = (torch.cuda.device_count() if pool.device.type == "cuda"
             else 1)
    print(f"mesh eval: dp={dp} x sp={sp} over {dp * sp} devices"
          + (f", {len(members)}-model ensemble" if len(members) > 1 else "")
          + f"; backend {pool.backend} ({dp * sp} ranks on {cards} "
            f"{pool.device.type} device(s)), transport {pool.transport}")
    return fwds, trees, pool


def _mesh_report(pool, dp, sp):
    """A mesh eval's entry in the `--json` summary: the mesh, its backend
    and transport, and each rank's tallies since the eval started
    (`parallel.launch.rank_counts`: CAC and quant kernel launches on the
    card, and each collective's calls, bytes and transports), rank 0
    first."""
    from codon_tpu_torch.parallel.launch import rank_counts
    return {"dp": dp, "sp": sp, "backend": pool.backend,
            "transport": pool.transport, "ranks": pool.call(rank_counts)}


def make_eval_forward(args, device) -> EvalForward:
    """The forward of `eval`, from its arguments.

    The wrappers nest as in `codon_tpu.cli eval`: the scale-conditioning
    plane innermost (a constant is flip- and transpose-invariant, so the
    geometric transforms act on the 1-channel depth), the ensemble mean over
    each member's own forward (with its own int8 backend) around it, then
    TTA around it all. With --check-nans each member's backend checks every
    conv site's output and each member's forward its output.
    """
    from codon_tpu_torch.core.ops import NanCheckOps, TorchOps, check_nan
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.models.variants import with_scale_cond

    members, ensemble = _load_members(args, DTYPE_POLICIES[args.dtype],
                                      device)
    member_ops = _member_ops(args.dtype, members, ensemble)
    if args.check_nans:
        member_ops = [NanCheckOps(TorchOps() if ops is None else ops)
                      for ops in member_ops]
    cond = args.scale / 16.0 if args.scale_cond else None

    def single(v, ops):
        return lambda p, d, c, m: v.forward(p, d, c, mask=m, ops=ops)

    extra = {}
    if max(1, args.dp_devices) * max(1, args.tile_devices) > 1:
        bodies, trees, pool = _mesh_forwards(args, members, device)
        extra["close"] = pool.close
        extra["mesh_report"] = functools.partial(
            _mesh_report, pool, max(1, args.dp_devices),
            max(1, args.tile_devices))
    else:
        bodies = [single(v, ops) for (_, _, v), ops in zip(members,
                                                           member_ops)]
        trees = [p for p, _, _ in members]

    def member_fwd(v, body):
        def fwd(p, d, c, m):
            out = body(p, d, c, m)
            if args.check_nans:
                check_nan(out, f"the {v.name} forward")
            return out
        return with_scale_cond(fwd, cond) if cond is not None else fwd

    fwds = [member_fwd(v, body) for (_, _, v), body in zip(members, bodies)]
    if ensemble:
        params = trees

        def inner(plist, d, c, m):
            outs = [f(p, d, c, m) for p, f in zip(plist, fwds)]
            return sum(outs) / len(outs)
    else:
        params = trees[0]
        inner = fwds[0]
    tta_n = 8 if args.tta8 else (4 if args.tta else 0)
    fwd = inner
    if tta_n:
        from codon_tpu_torch.models.tta import make_tta_forward
        fwd = make_tta_forward(inner, transforms=tta_n)
    return EvalForward(fwd, params, tta_n, ensemble, **extra)


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
    prof = None
    ef = None
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
        if args.resume and not args.no_save:
            done = {n for n in names
                    if os.path.exists(os.path.join(args.out, n + ".png"))}
            if done:
                print(f"resume: skipping {len(done)} already-written images")
            names = [n for n in names if n not in done]
            if not names:
                print("resume: nothing to do")
                if args.json:
                    # the normal summary's keys, metrics null, so that a
                    # scripted pipeline reads no stale or key-less file
                    with open(args.json, "w") as f:
                        json.dump({"scale": args.scale, "images": 0,
                                   "resumed_all": True,
                                   "img_per_sec_steady": None,
                                   "mean_rmse": None, "mean_ssim": None,
                                   "img_per_sec_e2e": None,
                                   "img_per_sec_compute": None,
                                   "tta_transforms": 0,
                                   "per_image": []}, f, indent=2)
                    print(f"metrics written to {args.json}")
                return 0
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

        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
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
        if prof is not None:
            prof.__exit__(None, None, None)
            prof_done, prof = prof, None
            os.makedirs(args.profile, exist_ok=True)
            prof_done.export_chrome_trace(os.path.join(args.profile,
                                                       "trace.json"))
            print(f"profiler trace written to {args.profile}")
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
        if ef.mesh_report is not None:
            summary["mesh"] = ef.mesh_report()
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
        if prof is not None:
            prof.__exit__(None, None, None)
        if ef is not None:
            ef.close()
        if log_ctx:
            log_ctx.__exit__(None, None, None)


def parse_scene_weights(spec, pair_names):
    """`--scene-weight "Name=W[,Name=W...]"` -> a weight a pair (1.0 where
    unnamed), or None for an empty spec; malformed entries, non-finite or
    negative weights and unknown names exit before training starts."""
    if not spec:
        return None
    wmap = {}
    for item in spec.split(","):
        k, sep, v = item.partition("=")
        if not sep or not k.strip():
            raise SystemExit(f"--scene-weight expects Name=W[,..], "
                             f"got {item!r}")
        try:
            w = float(v)
        except ValueError:
            raise SystemExit(f"--scene-weight: bad weight {v!r} "
                             f"for {k.strip()!r}") from None
        if not math.isfinite(w) or w < 0:
            raise SystemExit(f"--scene-weight: weight for {k.strip()!r} "
                             f"must be finite and >= 0, got {w}")
        if k.strip() in wmap:
            raise SystemExit(f"--scene-weight: {k.strip()!r} appears "
                             f"twice in the spec")
        wmap[k.strip()] = w
    unknown = set(wmap) - set(pair_names)
    if unknown:
        raise SystemExit(f"--scene-weight names not in the training "
                         f"set: {sorted(unknown)}")
    print(f"scene weights: {wmap} over {len(pair_names)} pairs")
    return [wmap.get(n, 1.0) for n in pair_names]


def _ema_path(ckpt_out: str) -> str:
    base, ext = os.path.splitext(ckpt_out)
    return base + "_ema" + (ext or ".npz")


def _training_pairs(args, scale_dir):
    """-> (labels, colors, degraded or None, pair names, pair scales,
    names): the uint8 images of the training set, as `codon_tpu.cli
    train` gathers them (--exclude, --mix-scales)."""
    from codon_tpu_torch.data.io import discover_pairs, imread_gray

    names = discover_pairs(scale_dir)
    excluded = {n.strip() for n in args.exclude.split(",") if n.strip()}
    if excluded:
        missing = excluded - set(names)
        if missing:
            raise SystemExit(f"--exclude names not in dataset: {missing}")
        names = [n for n in names if n not in excluded]
        print(f"holding out: {sorted(excluded)}")
    pair_names = list(names)
    pair_scales = [args.scale] * len(names)
    labels, colors, degraded = [], [], []
    for n in names:
        labels.append(imread_gray(os.path.join(scale_dir, "input_label",
                                               n + ".png")))
        colors.append(imread_gray(os.path.join(scale_dir, "input_color",
                                               n + ".png")))
        dpath = os.path.join(scale_dir, "input_depth", n + ".png")
        if os.path.exists(dpath):
            degraded.append(imread_gray(dpath))
    use_real = len(degraded) == len(labels)
    if args.mix_scales:
        if not use_real:
            raise SystemExit("--mix-scales needs shipped input_depth for "
                             "the primary scale")
        if args.data_dir:
            raise SystemExit("--mix-scales derives the other-scale dirs "
                             "from --data-root and cannot be combined "
                             "with a --data-dir override")
        added, skipped = 0, 0
        for s in (4, 8, 16):
            if s == args.scale:
                continue
            sdir = os.path.join(args.data_root, f"CODON_X{s}")
            for i, n in enumerate(names):
                dpath = os.path.join(sdir, "input_depth", n + ".png")
                if os.path.exists(dpath):
                    deg = imread_gray(dpath)
                    if deg.shape != labels[i].shape:
                        skipped += 1
                        continue
                    labels.append(labels[i])
                    colors.append(colors[i])
                    degraded.append(deg)
                    pair_names.append(n)
                    pair_scales.append(s)
                    added += 1
        print(f"mix-scales: +{added} shipped degradation pairs from the "
              f"other scale dirs"
              + (f" ({skipped} skipped: shape mismatch vs primary label)"
                 if skipped else ""))
    return (labels, colors, degraded if use_real else None, pair_names,
            pair_scales, names)


def _calibrate(args, variant, params, scale_dir, names, labels, colors,
               use_real, device):
    """--qat-static: per-site static scales from full-frame eval forwards
    (the packed, unrolled forward: calibration sees whole images, not
    patches), with the scale/16 plane under --scale-cond."""
    from codon_tpu_torch.data.pipeline import batched_loader, to_device
    from codon_tpu_torch.quant_ops import calibrate_act_scales
    from codon_tpu_torch.train.data import synthesize_lr

    if use_real:
        def cal_batches():
            for b in batched_loader(scale_dir, names, 2, 32, device=device):
                yield b.depth, b.color, b.mask
    else:
        def cal_batches():
            for lab, col in zip(labels, colors):
                d = synthesize_lr(lab, args.scale)
                yield (to_device(d.astype(np.float32)[None, ..., None]
                                 / 255.0, device),
                       to_device(col.astype(np.float32)[None, ..., None]
                                 / 255.0, device), None)

    batches = cal_batches()
    if args.scale_cond:
        # the conditioning plane the model sees in eval (with_scale_cond)
        # and in training (the sampler's cond): every frame is at --scale
        cond = args.scale / 16.0
        batches = ((torch.cat([d, torch.full_like(d[..., :1], cond)], -1),
                    c, m) for d, c, m in batches)
    act_scales = calibrate_act_scales(
        lambda p, d, c, ops, mask: variant.forward(p, d, c, ops=ops,
                                                   mask=mask),
        params, batches)
    if args.no_handoff:
        from codon_tpu_torch.quant_ops import HANDOFF_SITES
        act_scales = {k: v for k, v in act_scales.items()
                      if k not in HANDOFF_SITES}
        print("no-handoff: dropped the roundtrip grids "
              f"({len(act_scales)} conv sites kept)")
    print(f"QAT-static: calibrated {len(act_scales)} conv sites on "
          f"{len(names)} full frames; training on the frozen grid")
    return act_scales


def _resume(mgr, params, opt_state, orbax_dir):
    """Load the manager's latest step into `params` and `opt_state` (in
    place) -> the step, or 0 when the directory has none."""
    from codon_tpu_torch.train.trainer import tree_items

    latest = mgr.latest_step()
    if latest is None:
        return 0
    tree = mgr.restore(latest)
    live = {"params": params, "mu": opt_state["mu"], "nu": opt_state["nu"]}
    saved = {"params": tree.get("params", {}),
             "mu": tree.get("opt_state", {}).get("mu", {}),
             "nu": tree.get("opt_state", {}).get("nu", {})}
    for part, dst in live.items():
        want = [(k, tuple(v.shape)) for k, v in tree_items(dst)]
        got = [(k, tuple(v.shape)) for k, v in tree_items(saved[part])]
        if want != got:
            raise SystemExit(
                f"--orbax-dir: cannot restore step {latest} from "
                f"{orbax_dir}: its {part} tree differs from this run's "
                f"(variant, flags or optimizer). Resume with the flags "
                f"that wrote it, or start a fresh --orbax-dir (warm-start "
                f"weights via --ckpt-in instead).")
        with torch.no_grad():
            for (_, d), (_, s) in zip(tree_items(dst),
                                      tree_items(saved[part])):
                d.copy_(torch.from_numpy(np.asarray(s)))
    opt_state["count"] = int(tree["opt_state"]["count"])
    return int(tree["step"])


def cmd_train(args) -> int:
    from codon_tpu_torch.checkpoint.manager import CheckpointManager
    from codon_tpu_torch.checkpoint.native import (load_npz,
                                                   params_from_numpy,
                                                   save_npz)
    from codon_tpu_torch.core.ops import NanCheckOps, TorchOps
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.data.pipeline import to_device
    from codon_tpu_torch.models.codon_net import widen_stem_params
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.data import PatchSampler
    from codon_tpu_torch.train.trainer import (CollapseDetector, TrainConfig,
                                               ema_update, make_train_step,
                                               tree_items, tree_rebuild)

    device = _device(args.device)
    variant = get_variant(args.variant, dtypes=DTYPE_POLICIES[args.dtype])
    variant.check_trainable()
    if args.qat_static and args.qat:
        raise SystemExit("--qat-static and --qat are mutually exclusive "
                         "(frozen static grid vs dynamic scales); pick one")
    scale_dir = _scale_dir(args)
    (labels, colors, degraded, pair_names, pair_scales,
     names) = _training_pairs(args, scale_dir)
    use_real = degraded is not None
    print(f"train x{args.scale}: {len(labels)} source images, "
          f"patch={args.patch} batch={args.batch} steps={args.steps} "
          f"[{'shipped input_depth' if use_real else 'synthesized'} "
          f"degradation] on {device}")

    if args.ckpt_in:
        tree = load_npz(args.ckpt_in)
        if variant.cfg.in_channels == 2 and tree["input"].shape[2] == 1:
            tree = widen_stem_params(tree, variant.cfg.in_channels)
            print(f"warm start: widened 1-channel stem -> "
                  f"{tree['input'].shape} with a zero conditioning slice "
                  f"(function-preserving)")
        act_scales = tree.pop("act_scales", None)
        params = params_from_numpy(tree, device,
                                   variant.cfg.dtypes.param_dtype)
    else:
        params = variant.init(torch.Generator().manual_seed(args.seed),
                              device=device)
        act_scales = None
    if act_scales is not None and not args.qat_static:
        print("WARNING: the input checkpoint carries act_scales (static "
              "int8 grid) but --qat-static is not set; the output "
              "checkpoint will NOT carry them and loses the fast "
              "static-int8 path. Re-run with --qat-static to keep it.")
    ops = None
    if args.qat_static:
        from codon_tpu_torch.quant_ops import FakeQuantStaticOps
        if not args.ckpt_in:
            print("WARNING: --qat-static without --ckpt-in calibrates the "
                  "frozen activation grid from RANDOM-init statistics, "
                  "which caps int8 quality; warm-start from a trained "
                  "checkpoint instead.")
        act_scales = _calibrate(args, variant, params, scale_dir, names,
                                labels, colors, use_real, device)
        ops = FakeQuantStaticOps({k: torch.from_numpy(v).to(device)
                                  for k, v in act_scales.items()})
    elif args.qat:
        from codon_tpu_torch.quant_ops import FakeQuantOps
        ops = FakeQuantOps()
        print("QAT: fake-quantized convs (int8 grid, dynamic scales)")
    if args.check_nans:
        ops = NanCheckOps(TorchOps() if ops is None else ops)
    step, opt = make_train_step(
        variant, TrainConfig(learning_rate=args.lr, loss=args.loss,
                             warmup_steps=args.warmup,
                             weight_decay=args.weight_decay,
                             clip_norm=args.clip_norm or None,
                             grad_weight=args.grad_loss,
                             total_steps=args.steps),
        ops=ops, check_finite=args.check_nans)
    opt_state = opt.init(params)

    sampler_src = PatchSampler(
        labels, colors, scale=args.scale, patch=args.patch,
        batch=args.batch, seed=args.seed, augment=args.augment,
        degraded=degraded, edge_bias=args.edge_bias,
        scene_weights=parse_scene_weights(args.scene_weight, pair_names),
        collage=args.collage,
        cond=([s / 16.0 for s in pair_scales] if args.scale_cond
              else None))

    mgr = None
    start_step = 0
    if args.orbax_dir:
        mgr = CheckpointManager(args.orbax_dir, max_to_keep=3)
        start_step = _resume(mgr, params, opt_state, args.orbax_dir)
        if start_step:
            print(f"orbax-dir: resumed step {start_step} from "
                  f"{args.orbax_dir} (the patch stream resumes at the "
                  f"same step: batches match the uninterrupted run)")
        else:
            print(f"orbax-dir: async checkpoints -> {args.orbax_dir} "
                  f"every {args.save_every} steps (keep-last-3)")

    ema_params = None
    if args.ema:
        if not 0.0 < args.ema < 1.0:
            raise SystemExit(f"--ema must be in (0, 1), got {args.ema}")
        # starts at the current weights (warm start, init or the resumed
        # step); the average itself is not checkpointed
        ema_params = tree_rebuild(params, [t.clone() for _, t in
                                           tree_items(params)])
        print(f"ema: decay {args.ema} -> {_ema_path(args.ckpt_out)}")

    # the stream starts at the restored step: batch i is a pure function
    # of (seed, i), so a resumed run reproduces the uninterrupted one
    sampler = sampler_src.prefetch(2, start_step)
    collapse = CollapseDetector()
    try:
        t0 = time.time()
        for i in range(start_step + 1, args.steps + 1):
            batch = {k: to_device(v, device)
                     for k, v in sampler.sample().items()}
            params, opt_state, m = step(params, opt_state, batch)
            if ema_params is not None:
                ema_update(ema_params, params, args.ema)
            if i % args.log_every == 0 or i == 1:
                loss = float(m["loss"])      # syncs the card
                gnorm = float(m["grad_norm"])
                rate = (i - start_step) * args.batch / (time.time() - t0)
                print(f"step {i:6d}  loss {loss:.5f}  "
                      f"grad_norm {gnorm:.3f}  {rate:.0f} patches/s")
                if collapse.update(gnorm):
                    dead = args.ckpt_out + ".collapsed"
                    save_npz(dead, params)
                    raise SystemExit(
                        f"TRAIN COLLAPSE at step {i}: global grad norm "
                        f"has been exactly 0.0 for {collapse.patience} "
                        f"consecutive log intervals — the network is a "
                        f"dead-ReLU fixed point (output == residual "
                        f"passthrough) and cannot recover. State saved to "
                        f"{dead} for inspection. Retry with --clip-norm, a "
                        f"lower --lr, or a --ckpt-in warm start.")
            if mgr is not None and (i % args.save_every == 0
                                    or i == args.steps):
                mgr.save(i, {"params": params, "opt_state": opt_state,
                             "step": np.asarray(i, np.int64)})
    finally:
        sampler.close()
        if mgr is not None:
            mgr.close()
    if args.qat_static:
        # the frozen grid ships with the weights: eval --dtype int8 runs
        # Int8StaticOps on it
        params = dict(params, act_scales=act_scales)
        if ema_params is not None:
            ema_params = dict(ema_params, act_scales=act_scales)
    save_npz(args.ckpt_out, params)
    print(f"saved {args.ckpt_out}")
    if ema_params is not None:
        save_npz(_ema_path(args.ckpt_out), ema_params)
        print(f"saved {_ema_path(args.ckpt_out)}")
    return 0


def cmd_golden(args) -> int:
    """Score `<scale dir>/output/*.png` against `input_label/` on the host,
    as `codon_tpu.cli golden` does: a line an image, the count, the means."""
    from codon_tpu_torch.data.io import imread_gray
    from codon_tpu_torch.metrics.rmse import masked_rmse
    from codon_tpu_torch.metrics.ssim import ssim_exact

    scale_dir = _scale_dir(args)
    out_dir = os.path.join(scale_dir, "output")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(out_dir)
                   if f.endswith(".png"))
    if not names:
        raise SystemExit(f"golden: no archived PNGs under {out_dir}")
    rmse_sum = ssim_sum = 0.0
    for name in names:
        out = imread_gray(os.path.join(out_dir, name + ".png"))
        label = imread_gray(os.path.join(scale_dir, "input_label",
                                         name + ".png"))
        r = masked_rmse(label, out)
        s = ssim_exact(label / 255, out / 255)
        rmse_sum += r
        ssim_sum += s
        print(f"{name}.png {r} {s}")
    print(len(names))
    print(rmse_sum / len(names), ssim_sum / len(names))
    return 0


def cmd_convert(args) -> int:
    from codon_tpu_torch.checkpoint.native import save_npz
    from codon_tpu_torch.checkpoint.torch_convert import load_pth
    from codon_tpu_torch.models.codon_net import CodonConfig

    cfg = CodonConfig(dead_heads=not args.no_dead_heads)
    params, epoch = load_pth(args.pth, cfg)
    save_npz(args.npz, params)
    print(f"converted {args.pth} (epoch {epoch}) -> {args.npz}")
    return 0


def cmd_export(args) -> int:
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.serve import export_forward

    device = _device(args.device)
    variant = get_variant(args.variant, dtypes=DTYPE_POLICIES[args.dtype])
    params, act_scales = _load_params(args.ckpt, variant, device)
    ops = None
    if args.dtype == "int8":
        from codon_tpu_torch.quant_ops import Int8Ops, Int8StaticOps
        if act_scales is not None:
            ops = Int8StaticOps(
                act_scales, compute_dtype=variant.cfg.dtypes.compute_dtype)
            print(f"int8: static scales from checkpoint "
                  f"({len(act_scales)} sites) baked into the artifact")
        else:
            ops = Int8Ops()
            print("int8: dynamic per-sample scales")
    tta_n = 8 if args.tta8 else 4 if args.tta else 0
    n = export_forward(variant, params, (args.height, args.width), args.out,
                       ops=ops, mask=args.mask, tta=tta_n,
                       scale_cond=(args.scale / 16.0 if args.scale_cond
                                   else None))
    print(f"exported {args.variant} {args.width}x{args.height} "
          f"[{args.dtype}{f'+tta{tta_n}' if tta_n else ''}] "
          f"for platform '{device.type}' "
          f"-> {args.out} ({n / 1e6:.1f} MB)")
    return 0


def cmd_info(args) -> int:
    from codon_tpu_torch.core.params import param_count
    from codon_tpu_torch.models.variants import get_variant, list_variants

    device = _device(args.device)
    card = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    print(f"torch {torch.__version__}, device: {device}{card}")
    variant = get_variant(args.variant)
    params = variant.init(torch.Generator().manual_seed(0), device=device)
    print(f"variant '{args.variant}': {param_count(params):,} params")
    print("available variants:", ", ".join(list_variants()))
    return 0


def main(argv=None) -> int:
    args = _build_argparser().parse_args(argv)
    return {"eval": cmd_eval, "train": cmd_train, "golden": cmd_golden,
            "convert": cmd_convert, "export": cmd_export,
            "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
