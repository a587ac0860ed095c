"""The sharded eval forward and training step over a dp x sp mesh, each
form against single-device execution, on tiny shapes.

    python -m codon_tpu_torch.parallel.dryrun --devices N [--device cpu]
        [--dist-backend gloo|nccl]

The JAX package's `dryrun_multichip` (`__graft_entry__.py:120-291`): N
ranks as dp x sp (dp = 2 when N is even, sp = N / dp), `codon` from a
seeded init in float32, and

  float      the sharded forward against the single-device one
  int8       static scales calibrated on the batch, `Int8StaticShardedOps`
             against single-device `Int8StaticOps`
  TTA8       the 8-transform self-ensemble of a 2-member ensemble over the
             mesh against the same on one device (a square frame, so the
             transposed quartet's H divides sp too)
  train      one full training step over the mesh (forward, backward,
             optimizer), its loss finite
  QAT        the sharded step's loss on the frozen static grid
             (`FakeQuantStaticShardedOps`) against the single-device
             `FakeQuantStaticOps` step's

each within the bounds of TOLS. It prints one line and exits non-zero on
a failed check. On the card the ranks run the CUDA kernels; with one
card, pass --dist-backend gloo (the ranks share it).
"""
from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel.launch import MeshPool
from codon_tpu_torch.parallel.quant import static_int8_ops
from codon_tpu_torch.parallel.tiling import make_tiled_forward
from codon_tpu_torch.quant_ops import (FakeQuantStaticOps, Int8StaticOps,
                                       calibrate_act_scales)
from codon_tpu_torch.train.trainer import TrainConfig, make_train_step

# (atol, rtol) of each check, elementwise |sharded - single| <= atol +
# rtol |single|: tests/test_parallel.py's for float32 and TTA8 (float32
# convs at other shapes sum in another order, here as in JAX), and for
# static int8 JAX's dryrun bound, 2e-3 (a code flipped at a rounding
# boundary)
TOLS = {"float": (2e-4, 1e-3), "int8": (2e-3, 1e-3), "tta8": (2e-4, 1e-3)}
# QAT's sharded loss against the single-device loss, relative: JAX's
# dryrun bound (fake-quant turns the sharded convs' float32 noise into
# one-code flips at rounding boundaries)
QAT_LOSS_RTOL = 5e-3


def _scaled(tree, f):
    if isinstance(tree, dict):
        return {k: _scaled(v, f) for k, v in tree.items()}
    return tree * f


def _check(key, got, want) -> float:
    atol, rtol = TOLS[key]
    d = (got - want).abs()
    bad = int((d > atol + rtol * want.abs()).sum())
    if bad:
        raise AssertionError(f"{key}: sharded vs single, {bad} values out of "
                             f"atol {atol} / rtol {rtol}; max |d| "
                             f"{float(d.max())}")
    return float(d.max())


def dryrun(n_devices: int, device="cuda", backend=None) -> dict:
    """Run the checks -> {"dp", "sp", "float", "int8", "tta8"}: the max
    |sharded - single| of each; "train_loss", the mesh step's loss;
    "qat_dloss", |sharded - single| of the QAT loss. Raises AssertionError
    on a failed bound."""
    dev = resolve_device(device)
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    sp = n_devices // dp
    variant = get_variant("codon")
    params = variant.init(torch.Generator().manual_seed(0), dev)
    rng = np.random.RandomState(0)
    B, H, W = dp, 8 * sp, 24

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)

    d, c = rand(B, H, W, 1), rand(B, H, W, 1)
    m = torch.ones((B, H, W, 1), device=dev)
    res = {"dp": dp, "sp": sp}
    with MeshPool(n_devices, device=dev, backend=backend) as pool:
        mesh_fwd = make_tiled_forward(variant, sp, dp, pool=pool)
        out = mesh_fwd(params, d, c, m)
        ref = variant.forward(params, d, c, mask=m)
        res["float"] = _check("float", out, ref)

        scales = calibrate_act_scales(
            lambda p, dd, cc, ops, mask: variant.forward(p, dd, cc, ops=ops,
                                                         mask=mask),
            params, [(d, c, m)])
        scales = {k: torch.from_numpy(v).to(dev) for k, v in scales.items()}
        ref8 = variant.forward(params, d, c, mask=m,
                               ops=Int8StaticOps(scales))
        int8_fwd = make_tiled_forward(
            variant, sp, dp, scales_factory=functools.partial(
                static_int8_ops), pool=pool)
        out8 = int8_fwd(dict(params, act_scales=scales), d, c, m)
        res["int8"] = _check("int8", out8, ref8)

        sq = 8 * sp
        dt, ct = rand(B, sq, sq, 1), rand(B, sq, sq, 1)
        mt = torch.ones((B, sq, sq, 1), device=dev)
        # a multiplicative perturbation: an additive one compounds over the
        # 5 recurrent stages
        plist = [params, _scaled(params, 1.01)]

        def ens_mesh(ps, dd, cc, mm):
            return sum(mesh_fwd(p, dd, cc, mm) for p in ps) / len(ps)

        def ens_single(ps, dd, cc, mm):
            return sum(variant.forward(p, dd, cc, mask=mm)
                       for p in ps) / len(ps)

        outt = make_tta_forward(ens_mesh, transforms=8)(plist, dt, ct, mt)
        reft = make_tta_forward(ens_single, transforms=8)(plist, dt, ct, mt)
        res["tta8"] = _check("tta8", outt, reft)

        # one full training step over the mesh, then QAT on the frozen
        # static grid against the single-device step
        batch = {"depth": d, "color": c, "label": rand(B, H, W, 1),
                 "mask": m}
        mesh = pool.mesh(dp, sp)
        step, opt = make_train_step(variant, TrainConfig(), mesh=mesh)
        p = _scaled(params, 1.0)
        _, _, metrics = step(p, opt.init(p), batch)
        res["train_loss"] = float(metrics["loss"])
        if not np.isfinite(res["train_loss"]):
            raise AssertionError(f"non-finite loss: {res['train_loss']}")
        qat = FakeQuantStaticOps(scales)
        q1, _ = make_train_step(variant, TrainConfig(),
                                ops=qat)[0].value_and_grad(params, batch)
        qn, _ = make_train_step(variant, TrainConfig(), ops=qat,
                                mesh=mesh)[0].value_and_grad(params, batch)
        res["qat_dloss"] = abs(float(q1) - float(qn))
        qrel = res["qat_dloss"] / max(abs(float(q1)), 1e-9)
        if qrel >= QAT_LOSS_RTOL:
            raise AssertionError(f"QAT sharded loss != single (rel "
                                 f"{qrel:.2e})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="codon_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args(argv)
    r = dryrun(args.devices, args.device, args.dist_backend)
    print(f"dryrun({args.devices}): mesh dp={r['dp']} sp={r['sp']} on "
          f"{args.device}, eval sharded==single (max|diff| "
          f"{r['float']:.2e}), int8-static sharded==single (max|diff| "
          f"{r['int8']:.2e}), tta8+2-member-ensemble sharded==single "
          f"(max|diff| {r['tta8']:.2e}), train loss={r['train_loss']:.5f}, "
          f"QAT sharded==single (|dloss| {r['qat_dloss']:.2e}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
