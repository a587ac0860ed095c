"""The copy kernels of the HBM copy probe and the port of the probe, on the CPU.

The JAX package's copies are closures inside `scripts/perf_pallas_probe.py`'s
`main()` and need a TPU; their function is the identity, which the plain
versions and the CPU wrappers are held to here, bitwise. The sweep is held
to the TPU probe's `run(...)` lines, read as text. The kernels themselves
run in tests/test_torch_kernels_cuda.py, on a card.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from codon_tpu_torch import perf_copy_probe as probe
from codon_tpu_torch.kernels import copy as kcopy

from torch_port_common import REPO, one_torch_thread  # noqa: F401

RAGGED = (3, 37, 29, 16)


def _views(shape, seed):
    """A seeded bfloat16 (B, H, W, C) tensor and its three views."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
        torch.bfloat16)
    return {k: probe.view(x, k) for k in ("4d", "flat", "3d")}


@pytest.mark.parametrize("kind,fn,tile", [
    ("4d", kcopy.copy4d, 64), ("4d", kcopy.copy4d, 8),
    ("flat", kcopy.copyflat, 64), ("flat", kcopy.copyflat, 8),
    ("3d", kcopy.copy3d, 512), ("3d", kcopy.copy3d, 16),
])
def test_cpu_wrappers_are_the_identity(kind, fn, tile):
    x = _views(RAGGED, seed=1)[kind]
    n0 = fn.launches
    got = fn(x, tile)
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))
    assert torch.equal(kcopy.copy_plain(x).view(torch.int16),
                       x.view(torch.int16))
    # into a slice of a larger buffer: the bytes around it stay as they were
    buf = torch.full((x.numel() + 64,), -7.0, dtype=x.dtype)
    out = buf[32:32 + x.numel()].view(x.shape)
    assert fn(x, tile, out=out) is out
    assert torch.equal(out, x)
    assert bool((buf[:32] == -7.0).all()) and bool((buf[-32:] == -7.0).all())
    # the CPU path launches nothing, so it counts nothing
    assert fn.launches == n0


@pytest.mark.parametrize("kind,shape,tile,grid,last", [
    # the probe's shape, (32, 370, 463, 64), in each view and tile
    ("4d", (32, 370, 463, 64), 64, (6, 32), 50),
    ("4d", (32, 370, 463, 64), 128, (3, 32), 114),
    ("flat", (32, 370, 29632), 64, (6, 32), 50),
    ("flat", (32, 370, 29632), 8, (47, 32), 2),
    ("3d", (11840, 463, 64), 512, (24, 1), 64),
    ("3d", (11840, 463, 64), 64, (185, 1), 64),
    # small and edge cases
    ("4d", (3, 37, 29, 16), 64, (1, 3), 37),
    ("3d", (5, 2, 8), 1, (5, 1), 1),
])
def test_plan_grid_and_last_tile(kind, shape, tile, grid, last):
    p = kcopy.plan(kind, shape, tile)
    assert p.grid == grid
    assert p.last_rows == last
    rows = shape[0] if kind == "3d" else shape[1]
    assert (p.grid[0] - 1) * tile + p.last_rows == rows
    assert 0 < p.last_rows <= tile


# the probe's shape in each view, bf16, at the sweep's tiles: (kind,
# shape, tile, chunks a full tile, chunks in the last tile, chunks)
PROBE_CHUNKS = [
    ("4d", (32, 370, 463, 64), 64, 116, 91, 21472),
    ("4d", (32, 370, 463, 64), 128, 232, 207, 32 * (2 * 232 + 207)),
    # th 64 is copy4d's th 64; th 8: tiles of 474,112 B, 14 full chunks
    # and one of 15,360 B, the last tile of 2 rows 4 chunks
    ("flat", (32, 370, 29632), 64, 116, 91, 21472),
    ("flat", (32, 370, 29632), 8, 15, 4, 32 * (46 * 15 + 4)),
    ("3d", (11840, 463, 64), 512, 926, 116, 21414),
    ("3d", (11840, 463, 64), 64, 116, 116, 185 * 116),
]


def _tile_ends(kind, shape, tile, es):
    """Byte offsets at which the TPU tiles end, from `plan` alone."""
    p = kcopy.plan(kind, shape, tile)
    row = int(np.prod(shape[1 if kind == "3d" else 2:])) * es
    rows = shape[0] if kind == "3d" else shape[1]
    ends = []
    for run in range(p.grid[1]):
        for t in range(p.grid[0]):
            ends.append((run * rows + min((t + 1) * tile, rows)) * row)
    return np.array(ends, np.int64)


def _check_cover(m, kind, shape, tile, es):
    """Every byte of every tile in exactly one chunk, no chunk across a
    tile's end, every chunk a multiple of 16 bytes and at most chunk_bytes;
    -> [(offset, bytes)] of the chunks."""
    chunks = np.array([m.chunk(i) for i in range(m.chunks)], np.int64)
    off, size = chunks[:, 0], chunks[:, 1]
    assert off[0] == 0
    assert np.array_equal(off[1:], off[:-1] + size[:-1])
    assert off[-1] + size[-1] == int(np.prod(shape)) * es
    assert np.all(size % 16 == 0) and np.all(size > 0)
    assert np.all(size <= m.chunk_bytes)
    ends = _tile_ends(kind, shape, tile, es)
    # the first tile end after a chunk's start is at or after its end
    nxt = ends[np.searchsorted(ends, off, side="right")]
    assert np.all(off + size <= nxt)
    return chunks


@pytest.mark.parametrize("kind,shape,tile,per_tile,per_last,total",
                         PROBE_CHUNKS)
def test_chunk_map_at_the_probes_tiles(kind, shape, tile, per_tile, per_last,
                                       total):
    m = kcopy.chunk_map(kind, shape, tile, 2)
    assert m.chunk_bytes == kcopy.CHUNK_BYTES
    assert m.per_tile == per_tile
    assert m.per_run - (m.tiles - 1) * m.per_tile == per_last
    assert m.chunks == total
    chunks = _check_cover(m, kind, shape, tile, 2)
    # one short chunk a tile at most: every chunk but a tile's last is full
    ends = set(_tile_ends(kind, shape, tile, 2).tolist())
    short = chunks[chunks[:, 1] < m.chunk_bytes]
    assert all(int(o + b) in ends for o, b in short)


def test_chunk_map_probe_counts_and_exact_tiles():
    # copy3d tr 512 at the probe's shape: exactly 926 chunks a full tile
    m = kcopy.chunk_map("3d", (11840, 463, 64), 512, 2)
    assert m.tile_bytes == 30_343_168 == 926 * kcopy.CHUNK_BYTES
    assert m.last_bytes == 64 * 463 * 64 * 2
    # the kernel's arguments do not depend on the tile but through the
    # tile's bytes: the chunk, and so the ring and its grid, stay the same
    maps = [kcopy.chunk_map(k, s, t, 2) for k, s, t, *_ in PROBE_CHUNKS]
    assert {m.chunk_bytes for m in maps} == {kcopy.CHUNK_BYTES}
    assert {m.runs * m.run_bytes for m in maps} == {32 * 370 * 463 * 64 * 2}


@pytest.mark.parametrize("kind,shape,tile,es,chunk", [
    ("4d", (5, 9, 7, 8), 64, 2, kcopy.CHUNK_BYTES),   # smaller than a chunk
    ("4d", (3, 37, 29, 16), 8, 2, 1024),              # ragged, many chunks
    ("4d", (2, 64, 16, 64), 16, 2, 1024),             # tile = 2 chunks
    ("4d", (2, 9, 1, 8), 4, 2, 48),                   # tile = 1 chunk + 16 B
    ("flat", (5, 9, 56), 64, 2, kcopy.CHUNK_BYTES),   # smaller than a chunk
    ("flat", (3, 37, 29 * 16), 8, 2, 1024),           # ragged, many chunks
    ("flat", (2, 9, 8), 4, 2, 48),                    # tile = 1 chunk + 16 B
    ("flat", (2, 64, 1024), 16, 2, 1024),             # tile = 32 chunks
    ("3d", (111, 29, 16), 7, 2, 512),
    ("3d", (128, 16, 64), 64, 2, 32768),              # tile = 4 chunks
    ("3d", (5, 2, 8), 1, 4, 16),                      # 64-byte tiles
    ("3d", (6145, 1, 8), 2049, 2, 32768),             # 1 chunk + 16 B
])
def test_chunk_map_covers_small_shapes(kind, shape, tile, es, chunk):
    # the map's arithmetic at chunks smaller than the kernel's, so that
    # small shapes still cut their tiles into many chunks
    m = dataclasses.replace(kcopy.chunk_map(kind, shape, tile, es),
                            chunk_bytes=chunk)
    _check_cover(m, kind, shape, tile, es)
    p = kcopy.plan(kind, shape, tile)
    assert (m.tiles, m.runs) == p.grid


@pytest.mark.parametrize("shape,tile", [
    ((32, 370, 463, 64), 64), ((32, 370, 463, 64), 8),
    ((32, 370, 463, 64), 128), ((3, 37, 29, 16), 8), ((3, 37, 29, 16), 64),
    ((2, 9, 1, 8), 4), ((5, 9, 7, 8), 3),
])
def test_flat_chunk_map_is_copy4ds(shape, tile):
    # a (1, th, W*C) tile of the flat view is the byte range of the
    # (1, th, W, C) tile of the 4d view: the kernel gets the same arguments
    b, h, w, c = shape
    flat = kcopy.chunk_map("flat", (b, h, w * c), tile, 2)
    assert flat == kcopy.chunk_map("4d", shape, tile, 2)
    assert (flat.tiles, flat.runs) == kcopy.plan("flat", (b, h, w * c),
                                                 tile).grid


def test_plan_refuses_bad_arguments():
    with pytest.raises(ValueError):
        kcopy.plan("2d", (4, 4), 2)
    with pytest.raises(ValueError):
        kcopy.plan("4d", (4, 4, 4), 2)
    with pytest.raises(ValueError):
        kcopy.plan("3d", (4, 4, 4), 0)


def test_wrappers_check_views():
    x = _views(RAGGED, seed=2)
    with pytest.raises(ValueError):
        kcopy.copy4d(x["flat"])
    with pytest.raises(ValueError):
        kcopy.copy3d(x["4d"])
    with pytest.raises(ValueError):
        kcopy.copyflat(x["flat"], out=torch.empty(x["flat"].shape))


def _tpu_sweep():
    """[(kind, tile, tag)] of the run(...) calls in the TPU probe's main()."""
    path = os.path.join(REPO, "scripts", "perf_pallas_probe.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    kinds = {"copy4d": "4d", "copyflat": "flat", "copy3d": "3d"}
    rows = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "run"):
            tag = node.args[0].value
            body = node.args[1].body
            if isinstance(body, ast.Call) and isinstance(body.func, ast.Call):
                inner = body.func
                rows.append((kinds[inner.func.id], inner.args[0].value, tag))
            else:
                rows.append((None, None, tag))
    return rows     # ast.walk meets the calls of main()'s body in order


def test_sweep_is_the_tpu_probes():
    tpu = _tpu_sweep()
    assert len(tpu) == 8
    port = probe.SWEEP
    # the seven copies, in order, with the TPU probe's tags
    assert list(port[:7]) == tpu[:7]
    # the library line: the TPU probe's `t * 1.0001` through XLA
    assert tpu[7] == (None, None, "xla copy")
    assert port[7][0] == "scale" and "1.0001" in port[7][2]
    assert port[8][0] == "clone"


def test_probe_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "codon_tpu_torch.perf_copy_probe", "--device",
         "cpu", "--shape", "2,9,7,16"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")]
    assert len(lines) == 9
    assert [ln.split(":")[0][len("RESULT "):].rstrip() for ln in lines] == \
        [tag for _, _, tag in probe.SWEEP]
    assert all(ln.rstrip().endswith("GB/s") for ln in lines)
    assert "cpu" in res.stdout.splitlines()[0]


def test_probe_main_returns_the_sweeps_rows(capsys):
    rows = probe.main(["--device", "cpu", "--shape", "2,9,7,16"])
    assert [r["tag"] for r in rows] == [tag for _, _, tag in probe.SWEEP]
    assert all(r["ms"] > 0 and r["gb_per_s"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert out.count("RESULT ") == len(rows)


def test_probe_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe.main([])
