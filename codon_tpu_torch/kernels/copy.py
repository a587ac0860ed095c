"""The copy kernels of the HBM copy probe: CUDA for Hopper, each beside its
plain PyTorch version.

Counterparts of the three Pallas copies of `scripts/perf_pallas_probe.py`,
each the identity on one view of a contiguous tensor, planned from the same
tiles as the TPU kernel (`plan`):

  copy4d(x, th)    x (B, H, W, C): (1, th, W, C) tiles, grid (B, ceil(H/th))
  copyflat(x, th)  x (B, H, W*C):  (1, th, W*C) tiles, the same grid
  copy3d(x, tr)    x (R, W, C):    (tr, W, C) tiles over R = B*H rows,
                                   grid (ceil(R/tr),)

One design for all three. Each cuts every tile into bulk chunks of
`CHUNK_BYTES` (the last chunk of a tile shorter; `chunk_map`) and launches
a persistent grid, as many blocks as the ring's shared memory lets an SM
hold on every SM (`ring_grid`), whatever the tile; each block moves its
chunks through a ring of `STAGES` shared-memory stages with Hopper's bulk
asynchronous copies. A copyflat tile is the byte range of the copy4d tile
of the same rows, so the two pass the same chunk map.

The CUDA source is `csrc/copy.cu`. Each wrapper takes the plain version
when its tensor lies on the CPU, and on a CUDA tensor launches the kernel or
raises; it never falls back. Each counts its kernel launches in a plain
integer attribute, `<wrapper>.launches`. `out`, when given, is where the
copy goes (a contiguous tensor of x's shape and dtype, for example a slice
of a larger buffer); else a new tensor is allocated.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from codon_tpu_torch.kernels import _build

_VECTOR = 16                # bulk copies move whole 16-byte vectors
_NDIM = {"4d": 4, "flat": 3, "3d": 3}
# the ring of the three copies, fixed in csrc/copy.cu (kChunk, kStages)
# and mirrored here: bytes a bulk chunk, shared-memory stages a block (at
# 4 x 32 KB an H100 SM holds one block)
CHUNK_BYTES = 32 * 1024
STAGES = 4
RING_BYTES = STAGES * CHUNK_BYTES + 8 * STAGES   # stages and their mbarriers


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """How the TPU kernel cuts one copy into tiles: its grid (x, y), the rows
    of a tile, and the rows of the last tile of an image (4d, flat) or of
    the whole row stack (3d). The kernels cut these tiles into chunks
    (`chunk_map`) and launch a grid of their own."""
    grid: tuple
    tile_rows: int
    last_rows: int


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


@dataclasses.dataclass(frozen=True)
class ChunkMap:
    """How the copies cut a copy into bulk chunks, in the kernel's own
    arguments: `runs` runs (the images of the 4d and flat views, one for
    the 3d view) of `tiles` TPU tiles, each `tile_bytes` long but the last of a
    run, `last_bytes` long; every tile cut into chunks of `chunk_bytes`
    (the kernel's, CHUNK_BYTES), the last chunk of a tile shorter. No grid:
    the kernel's grid depends on the card and the ring, not on the tile."""
    tile_bytes: int
    last_bytes: int
    tiles: int
    runs: int
    chunk_bytes: int = CHUNK_BYTES

    @property
    def per_tile(self) -> int:
        return -(-self.tile_bytes // self.chunk_bytes)

    @property
    def per_run(self) -> int:
        return ((self.tiles - 1) * self.per_tile
                + -(-self.last_bytes // self.chunk_bytes))

    @property
    def chunks(self) -> int:
        return self.runs * self.per_run

    @property
    def run_bytes(self) -> int:
        return (self.tiles - 1) * self.tile_bytes + self.last_bytes

    def chunk(self, i: int) -> tuple:
        """Chunk i -> (byte offset, bytes), as the kernel's `chunk_at`
        finds it."""
        run, r = divmod(i, self.per_run)
        t, c = divmod(r, self.per_tile)
        tb = self.last_bytes if t == self.tiles - 1 else self.tile_bytes
        start = c * self.chunk_bytes
        return (run * self.run_bytes + t * self.tile_bytes + start,
                min(self.chunk_bytes, tb - start))


def _row_elements(kind: str, shape) -> int:
    """Elements of one row of a tile: W*C in every view."""
    return math.prod(shape[1 if kind == "3d" else 2:])


def chunk_map(kind: str, shape, tile: int, element_size: int) -> ChunkMap:
    """The chunks of copy4d ("4d"), copyflat ("flat") or copy3d ("3d")
    over a contiguous `shape` of `element_size`-byte elements, cut from
    `plan`'s tiles."""
    p = plan(kind, shape, tile)
    row = _row_elements(kind, shape) * element_size
    return ChunkMap(tile_bytes=p.tile_rows * row, last_bytes=p.last_rows * row,
                    tiles=p.grid[0], runs=p.grid[1])


def ring_grid() -> int:
    """Blocks of the persistent grid the copies launch on the current CUDA
    device: the blocks of the ring an SM holds, times the SMs."""
    grid = ctypes.c_int(0)
    _build.check(_build.load().codon_copy_ring_grid(ctypes.byref(grid)),
                 "copy ring grid")
    return grid.value


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
    # a tile is whole rows, so whole 16-byte vectors too
    es = x.element_size()
    row_bytes = _row_elements(kind, x.shape) * es
    if row_bytes % _VECTOR:
        raise ValueError(f"copy {kind}: a row of {row_bytes} bytes is not a "
                         f"multiple of {_VECTOR}")
    if x.numel() == 0:
        return out
    m = chunk_map(kind, x.shape, tile, es)
    args = ((m.tile_bytes, m.last_bytes, m.tiles) if kind == "3d"
            else (m.tile_bytes, m.last_bytes, m.tiles, m.runs))
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"codon_copy{kind}")(
            x.data_ptr(), out.data_ptr(), *args,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, f"copy{kind}")
    fn.launches += 1
    return out


def copy4d(x: torch.Tensor, th: int = 64, out=None) -> torch.Tensor:
    """x (B, H, W, C) -> a copy, its (1, th, W, C) tiles cut into bulk
    chunks over the persistent grid."""
    return _launch("4d", copy4d, x, out, th)


def copyflat(x: torch.Tensor, th: int = 64, out=None) -> torch.Tensor:
    """x (B, H, W*C) -> a copy, its (1, th, W*C) tiles cut into bulk
    chunks over the persistent grid."""
    return _launch("flat", copyflat, x, out, th)


def copy3d(x: torch.Tensor, tr: int = 512, out=None) -> torch.Tensor:
    """x (R, W, C) -> a copy, its (tr, W, C) tiles of rows cut into bulk
    chunks over the persistent grid."""
    return _launch("3d", copy3d, x, out, tr)


KERNELS = (copy4d, copyflat, copy3d)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
