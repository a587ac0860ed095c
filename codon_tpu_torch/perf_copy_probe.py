"""HBM copy probe: what a plain copy achieves at the flagship activation shape.

    python -m codon_tpu_torch.perf_copy_probe

The counterpart of `scripts/perf_pallas_probe.py`, on the card. It times the
three hand-written copy kernels (`kernels/copy.py`) over the same sweep of
tiles, in the same order, then two single PyTorch calls of the same size:

  copy 4D (1,64,W,C) [baseline], 4D th 128, flat th 64, flat th 8,
  3D tr 512, 3D tr 64, 4D th 64 again [baseline2] (the first line repeated,
  so a drift between the two shows contention on the card),
  x * 1.0001 in the input's dtype (the counterpart of the TPU probe's
  `xla copy` line) and x.clone().

Shape (32, 370, 463, 64) bfloat16 by default, 701.69 MB; GB/s counts the
bytes read plus the bytes written. Each line: two warmups, then 30 calls
between two CUDA events. One line a tile:

    RESULT <tag>: <ms> ms  <GB/s> GB/s

It runs on the card (`--device cuda`, the default; without CUDA it raises).
`--device cpu` runs the kernels' plain versions at the `--shape` given,
with the host clock: a check of the sweep, not a measurement of the card.
"""
from __future__ import annotations

import argparse
import time

import torch

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.kernels import copy as kcopy

SHAPE = (32, 370, 463, 64)
WARMUP, ITERS = 2, 30
# (kind, tile, tag): the TPU probe's run(...) lines, in order; kind None is
# a single PyTorch call
SWEEP = (
    ("4d", 64, "copy 4D (1,64,W,C)  [baseline]"),
    ("4d", 128, "copy 4D (1,128,W,C)"),
    ("flat", 64, "copy flat (1,64,W*C)"),
    ("flat", 8, "copy flat (1,8,W*C)"),
    ("3d", 512, "copy 3D (512,W,C) rows"),
    ("3d", 64, "copy 3D (64,W,C) rows"),
    ("4d", 64, "copy 4D (1,64,W,C)  [baseline2]"),
    ("scale", None, "torch x * 1.0001"),
    ("clone", None, "torch clone"),
)
_KERNELS = {"4d": kcopy.copy4d, "flat": kcopy.copyflat, "3d": kcopy.copy3d}


def view(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The (B, H, W, C) tensor as the view a sweep line copies."""
    b, h, w, c = x.shape
    if kind == "flat":
        return x.view(b, h, w * c)
    if kind == "3d":
        return x.view(b * h, w, c)
    return x


def call(kind: str, tile):
    """-> fn(x) for a sweep line; x is the line's view."""
    if kind == "scale":
        return lambda t: t * 1.0001
    if kind == "clone":
        return torch.clone
    k = _KERNELS[kind]
    return lambda t: k(t, tile)


def time_ms(fn, x) -> float:
    """Mean ms a call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(WARMUP):
        fn(x)
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        start.record()
        for _ in range(ITERS):
            fn(x)
        end.record()
        torch.cuda.synchronize(x.device)
        return start.elapsed_time(end) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn(x)
    return (time.perf_counter() - t0) / ITERS * 1e3


def sweep(device, shape=SHAPE) -> list:
    """Run the sweep on a seeded bfloat16 tensor, print a RESULT line each;
    -> [{tag, kind, tile, ms, gb_per_s}]."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(shape, generator=gen, device=device).to(torch.bfloat16)
    gb = 2 * x.numel() * x.element_size() / 1e9          # read + write
    rows = []
    for kind, tile, tag in SWEEP:
        ms = time_ms(call(kind, tile), view(x, kind))
        rate = gb / ms * 1e3
        print(f"RESULT {tag:36s}: {ms:7.3f} ms  {rate:5.0f} GB/s",
              flush=True)
        rows.append({"tag": tag, "kind": kind, "tile": tile, "ms": ms,
                     "gb_per_s": rate})
    return rows


def _shape(text: str) -> tuple:
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 4 or min(shape) < 1:
        raise argparse.ArgumentTypeError(f"--shape takes B,H,W,C, got "
                                          f"{text!r}")
    return shape


def main(argv=None) -> list:
    """Print the header and the RESULT lines; -> the sweep's rows."""
    p = argparse.ArgumentParser(prog="codon_tpu_torch.perf_copy_probe",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--shape", type=_shape, default=SHAPE,
                   help="B,H,W,C (default %(default)s)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions, host clock)")
    b, h, w, c = args.shape
    print(f"copy probe: ({b}, {h}, {w}, {c}) bfloat16, "
          f"{b * h * w * c * 2 / 1e6:.2f} MB, on {name}", flush=True)
    return sweep(device, args.shape)


if __name__ == "__main__":
    main()
