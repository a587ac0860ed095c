"""The copy kernels of the HBM copy probe: CUDA for Hopper, each beside its
plain PyTorch version.

Counterparts of the three Pallas copies of `scripts/perf_pallas_probe.py`,
each the identity on one view of a contiguous tensor, cut into the same
tiles as the TPU kernel; one thread block copies one tile:

  copy4d(x, th)    x (B, H, W, C): (1, th, W, C) tiles, grid (B, ceil(H/th))
  copyflat(x, th)  x (B, H, W*C):  (1, th, W*C) tiles, the same grid
  copy3d(x, tr)    x (R, W, C):    (tr, W, C) tiles over R = B*H rows,
                                   grid (ceil(R/tr),)

The CUDA source is `csrc/copy.cu`. Each wrapper takes the plain version
when its tensor lies on the CPU, and on a CUDA tensor launches the kernel or
raises; it never falls back. Each counts its kernel launches in a plain
integer attribute, `<wrapper>.launches`. `out`, when given, is where the
copy goes (a contiguous tensor of x's shape and dtype, for example a slice
of a larger buffer); else a new tensor is allocated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from codon_tpu_torch.kernels import _build

_VECTOR = 16                # bytes a thread moves at a time
_NDIM = {"4d": 4, "flat": 3, "3d": 3}


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """How one copy is cut into blocks: grid (x, y) as launched, the rows of
    a tile, and the rows of the last tile of an image (4d, flat) or of the
    whole row stack (3d)."""
    grid: tuple
    tile_rows: int
    last_rows: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def ragged(self) -> bool:
        return self.last_rows != self.tile_rows


def plan(kind: str, shape, tile: int) -> CopyPlan:
    """The grid of `kind` ("4d", "flat" or "3d") over `shape` with `tile`
    rows a tile, as the TPU kernel's `grid=` and `BlockSpec`."""
    if kind not in _NDIM:
        raise ValueError(f"kind must be one of {sorted(_NDIM)}, got {kind!r}")
    if len(shape) != _NDIM[kind]:
        raise ValueError(f"{kind}: expected a {_NDIM[kind]}-d shape, got "
                         f"{tuple(shape)}")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    if kind == "3d":
        rows, images = shape[0], 1
    else:
        images, rows = shape[0], shape[1]
    tiles = -(-rows // tile)
    return CopyPlan(grid=(tiles, images), tile_rows=tile,
                    last_rows=rows - (tiles - 1) * tile)


def copy_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None):
    """The function every copy kernel computes: the identity."""
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    return out.copy_(x)


def _check(kind: str, x: torch.Tensor, out: Optional[torch.Tensor]):
    if x.dim() != _NDIM[kind]:
        raise ValueError(f"copy {kind}: expected a {_NDIM[kind]}-d tensor, "
                         f"got {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"copy {kind}: out is {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}, x is "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"copy kernels take CPU or CUDA tensors, got "
                         f"{x.device}")


def _launch(kind, fn, x, out, tile):
    """Check, allocate, launch `fn`'s kernel; -> out."""
    _check(kind, x, out)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    for t, what in ((x, "x"), (out, "out")):
        if not t.is_contiguous():
            raise ValueError(f"copy {kind}: {what} must be contiguous")
        if t.data_ptr() % _VECTOR:
            raise ValueError(f"copy {kind}: {what} must start on a "
                             f"{_VECTOR}-byte boundary")
    # a row: W*C elements (the flat view's last axis is already W*C); the
    # 4d kernel walks a row pixel by pixel, so a pixel's C elements too
    # must fill whole vectors
    es = x.element_size()
    row_bytes = math.prod(x.shape[1 if kind == "3d" else 2:]) * es
    unit = x.shape[-1] * es if kind == "4d" else row_bytes
    if unit % _VECTOR:
        raise ValueError(f"copy {kind}: a {'pixel' if kind == '4d' else 'row'}"
                         f" of {unit} bytes is not a multiple of {_VECTOR}")
    if x.numel() == 0:
        return out
    tiles = plan(kind, x.shape, tile).grid[0]
    if kind == "4d":
        args = (*x.shape[:3], x.shape[3] * es, tile, tiles)
    elif kind == "flat":
        args = (*x.shape[:2], row_bytes, tile, tiles)
    else:
        args = (x.shape[0], row_bytes, tile, tiles)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"codon_copy{kind}")(
            x.data_ptr(), out.data_ptr(), *args,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"copy{kind}")
    fn.launches += 1
    return out


def copy4d(x: torch.Tensor, th: int = 64, out=None) -> torch.Tensor:
    """x (B, H, W, C) -> a copy, one block per (1, th, W, C) tile."""
    return _launch("4d", copy4d, x, out, th)


def copyflat(x: torch.Tensor, th: int = 64, out=None) -> torch.Tensor:
    """x (B, H, W*C) -> a copy, one block per (1, th, W*C) tile."""
    return _launch("flat", copyflat, x, out, th)


def copy3d(x: torch.Tensor, tr: int = 512, out=None) -> torch.Tensor:
    """x (R, W, C) -> a copy, one block per (tr, W, C) tile of rows."""
    return _launch("3d", copy3d, x, out, tr)


KERNELS = (copy4d, copyflat, copy3d)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
