"""Driver entry points of the port: the counterpart of `__graft_entry__.py`.

    python -m codon_tpu_torch.entry [--device cpu]

`entry()` returns the flagship forward and its example arguments, the
bf16 `codon` forward at the reference eval size (1 x 370 x 463); the
module's run calls it once and prints the output's shape and dtype.
`dryrun_multichip` is `parallel.dryrun.dryrun`, the sharded eval forward
and training step over a dp x sp mesh against single-device execution
(`python -m codon_tpu_torch.parallel.dryrun` runs it).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.core.params import BF16
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel.dryrun import dryrun as dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]

# the reference eval size, (N, H, W, C)
EXAMPLE_SHAPE = (1, 370, 463, 1)


def entry(device="cuda"):
    """-> (fn, (params, depth, color)): fn(params, depth, color) is the
    bf16 `codon` forward; params the port's seeded init
    (`torch.Generator().manual_seed(0)`); depth then color drawn from
    `np.random.RandomState(0)` as JAX's `entry()` draws them, float32 of
    EXAMPLE_SHAPE. All on `device` (the card by default)."""
    device = resolve_device(device)
    variant = get_variant("codon", dtypes=BF16)
    params = variant.init(torch.Generator().manual_seed(0), device=device)
    rng = np.random.RandomState(0)
    depth, color = (torch.from_numpy(rng.rand(*EXAMPLE_SHAPE).astype(
        np.float32)).to(device) for _ in range(2))

    def fn(params, depth, color):
        return variant.forward(params, depth, color)

    return fn, (params, depth, color)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
