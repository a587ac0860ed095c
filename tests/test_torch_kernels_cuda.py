"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked `cuda` and skips without a card. The file imports no
JAX, so it runs on the machine with the card, where the repo's conftest
(which imports JAX) cannot load:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: float32 atol 1e-5 / rtol 1e-4 (only the order of float32 sums
differs); bfloat16 two ulps of its 8-bit significand (a pooled mean or a
gate value rounded once to bf16 may land one ulp apart). spatial_logits
rounds every multiply and add as its plain version does, in the same order,
and is held to it bitwise in every dtype. The CAC kernels
are also held where TTA puts the valid region (flipped to the bottom
right, and at the transposed padded shape 480 x 384). The copy kernels
compute the identity and are held to it bitwise, with a sentinel around
the output that must stay untouched. The int8 conv's kernels, quant_im2col
and dequant_epilogue, round as their plain versions do and are held to
them bitwise, alone, composed over image blocks, at the zoo's narrow
sites (zero-padded to their widths), and in whole int8 forwards. The
custom ops the wrappers dispatch through pass `torch.library.opcheck` on
CUDA inputs, and a `torch.export` artifact traced on the card equals the
live forward bitwise (cuDNN deterministic) with the same launches.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from codon_tpu_torch.kernels import cac as tcac
from codon_tpu_torch.models import codon_net as tnet

from torch_port_common import (C, CKPT_DIR, H, N, OP_CASES, W,  # noqa: F401
                               cac_mask, cac_towers, cac_weights, needs_cuda,
                               one_torch_thread, op_case, to_np, to_torch)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


def _cuda_inputs(dtype, seed):
    out, out_c, inp, inp_c = cac_towers(seed, masked=True)
    dev = "cuda"
    cast = lambda a: to_torch(a, dev).to(dtype).contiguous()  # noqa: E731
    rng = np.random.RandomState(seed + 1)
    gate = to_torch(rng.rand(N, 1, C).astype(np.float32), dev)
    logits = cast(rng.randn(N, H, W).astype(np.float32))
    sp_w = to_torch(cac_weights(seed)[-1], dev)
    return ([cast(t) for t in (out, out_c, inp, inp_c)], cast(cac_mask()),
            gate, logits, sp_w)


CUDA_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -6, 2 ** -6)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@needs_cuda
def test_cuda_stats_matches_plain(dtype, masked):
    towers, m, *_ = _cuda_inputs(dtype, 20)
    m = m if masked else None
    n0 = tcac.cac_stats.launches
    got = tcac.cac_stats(towers[0], towers[1], m)
    assert tcac.cac_stats.launches == n0 + 1
    want = tcac.cac_stats_plain(towers[0], towers[1], m)
    atol, rtol = CUDA_TOLS[dtype]
    _close(got[0] / (H * W), want[0] / (H * W), atol, rtol)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, atol, rtol)
    # deterministic: no float atomics, a fixed reduction order
    again = tcac.cac_stats(towers[0], towers[1], m)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


DTYPES = [torch.float32, torch.bfloat16, torch.float16]
DTYPE_IDS = ["fp32", "bf16", "fp16"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@needs_cuda
def test_cuda_spatial_logits_matches_plain(dtype):
    towers, m, _, _, sp_w = _cuda_inputs(dtype, 30)
    _, _, cmax, cmean = tcac.cac_stats_plain(towers[0], towers[1], m)
    n0 = tcac.spatial_logits.launches
    got = tcac.spatial_logits(cmax, cmean, sp_w)
    assert tcac.spatial_logits.launches == n0 + 1
    assert torch.equal(got, tcac.spatial_logits_plain(cmax, cmean, sp_w))


def _maps(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cmax, cmean = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for _ in range(2))
    sp_w = torch.randn((5, 5, 2, 1), generator=g, device="cuda") * 0.2
    return cmax, cmean, sp_w


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", [
    (2, 37, 29), (2, 370, 463),          # rows not whole 16-byte vectors
    (1, 1, 1), (2, 3, 2), (2, 4, 70),    # below the 5x5 window's halo
    (2, 33, 65), (2, 64, 32),            # a 32 x 64 tile's edges, +-1
    (2, 5, 8), (16, 384, 480), (16, 480, 384),   # whole vectors; TTA8
], ids=lambda s: "x".join(map(str, s)))
@needs_cuda
def test_cuda_spatial_logits_is_bitwise_at_every_edge(shape, dtype):
    cmax, cmean, sp_w = _maps(shape, dtype, seed=sum(shape))
    got = tcac.spatial_logits(cmax, cmean, sp_w)
    assert got.shape == cmax.shape and got.dtype == dtype
    assert torch.equal(got, tcac.spatial_logits_plain(cmax, cmean, sp_w))


@needs_cuda
def test_cuda_spatial_logits_maps_off_a_vector_boundary():
    # rows of whole vectors, but the maps start 2 bytes past a 16-byte
    # boundary: the kernel stages them element by element
    cmax, cmean, sp_w = _maps((2, 40, 64), torch.bfloat16, seed=31)
    bufs = [torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
            for t in (cmax, cmean)]
    off = [b[1:].view(cmax.shape).copy_(t) for b, t in zip(bufs, (cmax,
                                                                 cmean))]
    assert off[0].data_ptr() % 16 != 0
    assert torch.equal(tcac.spatial_logits(*off, sp_w),
                       tcac.spatial_logits_plain(cmax, cmean, sp_w))


@needs_cuda
def test_cuda_spatial_logits_back_to_back_with_other_weights():
    cmax, cmean, w1 = _maps((4, 384, 480), torch.bfloat16, seed=32)
    w2 = torch.flip(w1, (0, 1)) * -1.5
    # no synchronisation between the calls, on one stream
    a = tcac.spatial_logits(cmax, cmean, w1)
    b = tcac.spatial_logits(cmax, cmean, w2)
    torch.cuda.synchronize()
    assert torch.equal(a, tcac.spatial_logits_plain(cmax, cmean, w1))
    assert torch.equal(b, tcac.spatial_logits_plain(cmax, cmean, w2))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@needs_cuda
def test_cuda_apply_matches_plain(dtype):
    towers, _, gate, logits, _ = _cuda_inputs(dtype, 40)
    got = tcac.cac_apply(*towers, gate, logits)
    want = tcac.cac_apply_plain(*towers, gate, logits)
    atol, rtol = CUDA_TOLS[dtype]
    for g, w in zip(got, want):
        _close(g, w, atol, rtol)


@needs_cuda
def test_cuda_wrappers_refuse_bad_inputs():
    towers, m, gate, logits, _ = _cuda_inputs(torch.float32, 50)
    with pytest.raises(ValueError):
        tcac.cac_stats(towers[0], towers[1].to(torch.bfloat16))
    with pytest.raises(ValueError):
        tcac.cac_stats(towers[0].transpose(1, 2), towers[1].transpose(1, 2))
    with pytest.raises(ValueError):
        tcac.cac_apply(*towers, gate.double(), logits)
    with pytest.raises(ValueError):
        tcac.cac_stats(towers[0], towers[1], m[..., 0])
    # the kernel is built for the 5x5 gate only
    with pytest.raises(ValueError):
        tcac.spatial_logits(logits, logits,
                            torch.zeros((3, 3, 2, 1), device="cuda"))


@needs_cuda
def test_cuda_forward_kernel_path_matches_torch_path():
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    params = params_from_numpy(
        load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")), "cuda")
    rng = np.random.RandomState(60)
    d = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    c = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    m = to_torch(cac_mask(), "cuda")
    cfg = tnet.CodonConfig(dead_heads=True)
    k = tnet.codon_forward(params, d, c, mask=m,
                           cfg=dataclasses.replace(cfg, cac_impl="kernel"))
    t = tnet.codon_forward(params, d, c, mask=m,
                           cfg=dataclasses.replace(cfg, cac_impl="torch"))
    assert float((k - t).abs().max()) <= 1e-4



# ---------------------------------------------------------------------------
# the CAC kernels where TTA puts the valid region: flipped to the bottom
# right, and at the transposed padded shape 480 x 384
# ---------------------------------------------------------------------------

def _placed_inputs(shape, valid, corner, dtype, seed):
    """Towers zero outside each image's valid region, which sits at the
    top left or (flipped) at the bottom right."""
    n, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.zeros((n, h, w, 1), device="cuda")
    for i, (vh, vw) in enumerate(valid):
        if corner == "bottom_right":
            mask[i, h - vh:, w - vw:] = 1.0
        else:
            mask[i, :vh, :vw] = 1.0
    towers = [(torch.randn(shape, generator=g, device="cuda") * mask)
              .to(dtype).contiguous() for _ in range(4)]
    gate = torch.rand((n, 1, c), generator=g, device="cuda")
    logits = torch.randn((n, h, w), generator=g, device="cuda").to(dtype)
    sp_w = torch.randn((5, 5, 2, 1), generator=g, device="cuda") * 0.2
    return towers, mask.to(dtype), gate, logits, sp_w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,valid,corner", [
    ((N, H, W, C), [(H, W), (19, 15)], "bottom_right"),
    ((2, 480, 384, C), [(463, 370), (450, 375)], "top_left"),
    ((2, 480, 384, C), [(463, 370), (450, 375)], "bottom_right"),
], ids=["odd-flipped", "transposed", "transposed-flipped"])
@needs_cuda
def test_cuda_cac_kernels_where_tta_puts_the_mask(dtype, shape, valid,
                                                  corner):
    towers, m, gate, logits, sp_w = _placed_inputs(shape, valid, corner,
                                                   dtype, seed=70)
    atol, rtol = CUDA_TOLS[dtype]
    npix = shape[1] * shape[2]
    got = tcac.cac_stats(towers[0], towers[1], m)
    want = tcac.cac_stats_plain(towers[0], towers[1], m)
    # sums as means, at the float32 tolerance in every dtype (both sides
    # add the same rounded inputs in float32), maxes likewise
    _close(got[0] / npix, want[0] / npix, *CUDA_TOLS[torch.float32])
    _close(got[1], want[1], *CUDA_TOLS[torch.float32])
    for g, w in zip(got[2:], want[2:]):
        _close(g, w, atol, rtol)
    _, _, cmax, cmean = want
    assert torch.equal(tcac.spatial_logits(cmax, cmean, sp_w),
                       tcac.spatial_logits_plain(cmax, cmean, sp_w))
    for g, w in zip(tcac.cac_apply(*towers, gate, logits),
                    tcac.cac_apply_plain(*towers, gate, logits)):
        _close(g, w, atol, rtol)


# ---------------------------------------------------------------------------
# the copy kernels: bitwise, and nothing written outside the output
# ---------------------------------------------------------------------------

SENTINEL = -7.0     # the inputs lie in [0, 1)
GUARD = 4096        # elements of sentinel before and after the output


def _copy_into_guarded(fn, x, tile):
    buf = torch.full((x.numel() + 2 * GUARD,), SENTINEL, dtype=x.dtype,
                     device=x.device)
    out = buf[GUARD:GUARD + x.numel()].view(x.shape)
    n0 = fn.launches
    assert fn(x, tile, out=out) is out
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    return buf, out


@pytest.mark.parametrize("shape", [(3, 37, 29, 64), (2, 64, 8, 64),
                                   (5, 9, 7, 8)],
                         ids=["ragged", "even", "narrow"])
@pytest.mark.parametrize("kind,tile", [
    ("4d", 64), ("4d", 128), ("4d", 8), ("flat", 64), ("flat", 8),
    ("3d", 512), ("3d", 64), ("3d", 7),
])
@needs_cuda
def test_cuda_copy_kernels_are_bitwise_and_stay_inside(kind, tile, shape):
    from codon_tpu_torch import perf_copy_probe as probe
    from codon_tpu_torch.kernels import copy as kcopy
    fn = {"4d": kcopy.copy4d, "flat": kcopy.copyflat,
          "3d": kcopy.copy3d}[kind]
    g = torch.Generator(device="cuda").manual_seed(80)
    x = probe.view(torch.rand(shape, generator=g, device="cuda")
                   .to(torch.bfloat16), kind)
    buf, out = _copy_into_guarded(fn, x, tile)
    assert torch.equal(out.view(torch.int16), x.view(torch.int16))
    assert torch.equal(out, kcopy.copy_plain(x))
    assert bool((buf[:GUARD] == SENTINEL).all())
    assert bool((buf[GUARD + x.numel():] == SENTINEL).all())


@needs_cuda
def test_cuda_copy_wrappers_refuse_bad_inputs():
    from codon_tpu_torch.kernels import copy as kcopy
    x = torch.zeros((2, 5, 3, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):          # not contiguous
        kcopy.copy4d(x.transpose(1, 2))
    with pytest.raises(ValueError):          # a pixel of 6 bytes
        kcopy.copy4d(torch.zeros((2, 5, 3, 3), dtype=torch.bfloat16,
                                 device="cuda"))
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")
    with pytest.raises(ValueError):          # out off a 16-byte boundary
        kcopy.copy4d(x, out=buf[1:].view(x.shape))


# ---------------------------------------------------------------------------
# the bulk ring of the three copies: tiles at and around a chunk's edges,
# more chunks than the grid's stages hold, and calls back to back on one
# stream
# ---------------------------------------------------------------------------

def _ring_case(kind, shape, tile, seed=81):
    from codon_tpu_torch import perf_copy_probe as probe
    from codon_tpu_torch.kernels import copy as kcopy
    fn = {"4d": kcopy.copy4d, "flat": kcopy.copyflat,
          "3d": kcopy.copy3d}[kind]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = probe.view(torch.rand(shape, generator=g, device="cuda")
                   .to(torch.bfloat16), kind)
    buf = torch.full((x.numel() + 2 * GUARD,), SENTINEL, dtype=x.dtype,
                     device=x.device)
    out = buf[GUARD:GUARD + x.numel()].view(x.shape)
    n0 = fn.launches
    assert fn(x, tile, out=out) is out
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert torch.equal(out.view(torch.int16), x.view(torch.int16))
    assert bool((buf[:GUARD] == SENTINEL).all())
    assert bool((buf[GUARD + x.numel():] == SENTINEL).all())
    return kcopy.chunk_map(kind, x.shape, tile, x.element_size())


@pytest.mark.parametrize("kind,shape,tile,per_tile,tile_bytes", [
    # a tile of exactly k chunks
    ("4d", (2, 64, 16, 64), 16, 1, 32768),
    ("3d", (2, 64, 16, 64), 64, 4, 4 * 32768),
    # k chunks and 16 bytes; the last tile 2 rows of 16 bytes
    ("4d", (3, 2049, 1, 8), 2049, 2, 32768 + 16),
    ("3d", (3, 2049, 1, 8), 6145, 4, 3 * 32768 + 16),
    # the whole copy smaller than one chunk
    ("4d", (5, 9, 7, 8), 4, 1, 4 * 112),
    ("3d", (5, 9, 7, 8), 3, 1, 3 * 112),
    # the flat view: the same tiles as 4d's
    ("flat", (2, 64, 16, 64), 16, 1, 32768),
    ("flat", (3, 2049, 1, 8), 2049, 2, 32768 + 16),
    ("flat", (5, 9, 7, 8), 4, 1, 4 * 112),
], ids=["4d-1chunk", "3d-4chunks", "4d-1chunk+16", "3d-3chunks+16",
        "4d-subchunk", "3d-subchunk", "flat-1chunk", "flat-1chunk+16",
        "flat-subchunk"])
@needs_cuda
def test_cuda_ring_tiles_at_chunk_edges(kind, shape, tile, per_tile,
                                        tile_bytes):
    m = _ring_case(kind, shape, tile)
    assert (m.per_tile, m.tile_bytes) == (per_tile, tile_bytes)


@pytest.mark.parametrize("kind,tile", [("4d", 64), ("3d", 512),
                                       ("flat", 64), ("flat", 8)])
@needs_cuda
def test_cuda_ring_more_chunks_than_grid_stages(kind, tile):
    from codon_tpu_torch.kernels import copy as kcopy
    m = _ring_case(kind, (4, 370, 463, 64), tile)
    assert m.chunks > kcopy.ring_grid() * kcopy.STAGES


@needs_cuda
def test_cuda_ring_calls_back_to_back_on_one_stream():
    from codon_tpu_torch.kernels import copy as kcopy
    g = torch.Generator(device="cuda").manual_seed(82)
    x, y = (torch.rand((4, 370, 463, 64), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    out = torch.empty_like(x)
    # two calls into the same out, no synchronisation between them
    kcopy.copy4d(x, 64, out=out)
    kcopy.copy3d(y.view(-1, 463, 64), 512, out=out.view(-1, 463, 64))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), y.view(torch.int16))
    # the second call reads what the first wrote
    mid, last = torch.empty_like(x), torch.empty_like(x)
    kcopy.copy3d(x.view(-1, 463, 64), 64, out=mid.view(-1, 463, 64))
    kcopy.copy4d(mid, 128, out=last)
    torch.cuda.synchronize()
    assert torch.equal(last.view(torch.int16), x.view(torch.int16))


@needs_cuda
def test_cuda_ring_grid_and_refusals():
    from codon_tpu_torch.kernels import _build
    from codon_tpu_torch.kernels import copy as kcopy
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = kcopy.ring_grid()
    assert grid >= sms and grid % sms == 0
    assert kcopy.ring_grid() == grid             # the same on every call
    x = torch.zeros((2, 9, 7, 8), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    # the C entry points refuse tiles off 16 bytes, a last tile longer than
    # a tile, and no tiles
    for tile_bytes, last_bytes, tiles in ((1000, 1000, 2), (448, 464, 2),
                                          (448, 448, 0)):
        assert lib.codon_copy4d(x.data_ptr(), out.data_ptr(), tile_bytes,
                                last_bytes, tiles, 2, stream) != 0
        assert lib.codon_copyflat(x.data_ptr(), out.data_ptr(), tile_bytes,
                                  last_bytes, tiles, 2, stream) != 0
        assert lib.codon_copy3d(x.data_ptr(), out.data_ptr(), tile_bytes,
                                last_bytes, tiles, stream) != 0
    # a refusal leaves no error behind for the next launch
    x.uniform_()
    assert torch.equal(kcopy.copy4d(x, 4), x)


# ---------------------------------------------------------------------------
# the int8 conv's kernels: quant_im2col and dequant_epilogue, bitwise
# ---------------------------------------------------------------------------

QUANT_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8]
QUANT_IDS = ["fp32", "bf16", "fp16", "int8"]


def _quant_input(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 3
    sc = torch.rand((shape[-1],), generator=g, device="cuda") * 0.05 + 0.005
    sx = torch.rand((shape[0],), generator=g, device="cuda") * 0.05 + 0.005
    if dtype == torch.int8:
        x = torch.randint(-127, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8)
    else:
        x = x.to(dtype).contiguous()
    return x, sc, sx


@pytest.mark.parametrize("dtype", QUANT_DTYPES, ids=QUANT_IDS)
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("shape", [(N, H, W, C), (3, 9, 7, 128),
                                   (1, 1, 1, 16)],
                         ids=["odd", "c128", "one-pixel"])
@needs_cuda
def test_cuda_quant_im2col_matches_plain(dtype, k, shape):
    from codon_tpu_torch.kernels import quant as kq
    x, sc, sx = _quant_input(shape, dtype, seed=80 + k)
    scales = ([(None, None)] if dtype == torch.int8
              else [(sc, None), (None, sx)])
    for a, b in scales:
        n0 = kq.quant_im2col.launches
        got = kq.quant_im2col(x, k, a, b)
        assert kq.quant_im2col.launches == n0 + 1
        want = kq.quant_im2col_plain(x, k, a, b)
        assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@needs_cuda
def test_cuda_quantize_is_the_plain_quantize(dtype):
    """quantize_static's kernel (quant_im2col at k = 1): the codes of the
    plain version, on values half-way between grid points too."""
    from codon_tpu_torch.kernels import quant as kq
    from codon_tpu_torch.quant_ops import quantize_static
    x, sc, _ = _quant_input((N, H, W, C), dtype, seed=85)
    x.view(-1, C)[:5] = (sc * torch.tensor([0.5, 1.5, -2.5, 300.0, -0.5],
                                           device="cuda")[:, None]).to(dtype)
    got = quantize_static(x, sc)
    assert got.shape == x.shape and got.dtype == torch.int8
    assert torch.equal(got, kq.quantize_plain(x, sc))
    # a view that is not contiguous is quantized as its contiguous copy
    xt = x.transpose(1, 2)
    assert torch.equal(quantize_static(xt, sc), kq.quantize_plain(xt, sc))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@needs_cuda
def test_cuda_dequant_epilogue_matches_plain(dtype, dynamic, masked):
    from codon_tpu_torch.kernels import quant as kq
    g = torch.Generator(device="cuda").manual_seed(90)
    co = 128
    # small sums and sums past 2^24, where int32 -> float32 rounds
    acc = torch.randint(-2 ** 20, 2 ** 20, (N * H * W, co), generator=g,
                        device="cuda", dtype=torch.int32)
    acc[::7] *= 2 ** 9
    if dtype == torch.float16:
        # float16 holds at most 65504: sums that stay below it
        acc = torch.div(acc, 2 ** 14, rounding_mode="floor")
    sw = torch.rand((co,), generator=g, device="cuda") * 1e-3
    sx = (torch.rand((N,), generator=g, device="cuda") * 0.05
          if dynamic else None)
    m = to_torch(cac_mask(), "cuda").to(dtype) if masked else None
    n0 = kq.dequant_epilogue.launches
    got = kq.dequant_epilogue(acc, sw, dtype, (N, H, W), sx, m)
    assert kq.dequant_epilogue.launches == n0 + 1
    want = kq.dequant_epilogue_plain(acc, sw, dtype, (N, H, W), sx, m)
    assert got.dtype == dtype and torch.equal(got, want)
    # into a slice of a larger output, as int8_conv's image blocks do
    out = torch.full((N + 1, H, W, co), -1.0, device="cuda").to(dtype)
    kq.dequant_epilogue(acc, sw, dtype, (N, H, W), sx, m, out=out[1:])
    assert torch.equal(out[1:], want) and bool((out[0] == -1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("k", [1, 3, 5])
@needs_cuda
def test_cuda_int8_conv_matches_plain_over_image_blocks(dtype, k,
                                                        monkeypatch):
    from codon_tpu_torch.kernels import quant as kq
    shape = (5, 37, 29, 64)
    x, sc, sx = _quant_input(shape, dtype, seed=100 + k)
    g = torch.Generator(device="cuda").manual_seed(101)
    w8 = torch.randint(-127, 128, (k, k, 64, 128), generator=g,
                       device="cuda", dtype=torch.int8)
    sw = torch.rand((128,), generator=g, device="cuda") * 1e-3
    m = torch.ones(shape[:3] + (1,), device="cuda")
    m[-1, 20:] = 0
    out_dt = torch.float32 if dtype == torch.int8 else dtype
    scales = ([(None, None)] if dtype == torch.int8
              else [(sc, None), (None, sx)])
    # two images a block: blocks of 2, 2 and 1
    monkeypatch.setattr(kq, "PATCH_BYTES_MAX", 2 * 37 * 29 * k * k * 64)
    for a, b in scales:
        counts = kq.launches()
        got = kq.int8_conv(x, w8, sw, out_dt, sc=a, sx=b, mask=m)
        after = kq.launches()
        assert all(after[n] == counts[n] + 3 for n in counts)
        want = kq.int8_conv(x, w8, sw, out_dt, sc=a, sx=b, mask=m,
                            impl="plain")
        assert kq.launches()["quant_im2col"] == after["quant_im2col"]
        assert torch.equal(got, want)


@needs_cuda
def test_cuda_quant_wrappers_refuse_bad_inputs():
    from codon_tpu_torch.kernels import quant as kq
    x, sc, sx = _quant_input((2, 9, 7, 64), torch.float32, 110)
    with pytest.raises(ValueError):          # C not a multiple of 16
        kq.quant_im2col(x[..., :40].contiguous(), 3, sc[:40])
    with pytest.raises(ValueError):          # not contiguous
        kq.quant_im2col(x.transpose(1, 2), 3, sc)
    with pytest.raises(ValueError):          # even kernel
        kq.quant_im2col(x, 4, sc)
    with pytest.raises(ValueError):          # both scales
        kq.quant_im2col(x, 3, sc, sx)
    with pytest.raises(ValueError):          # a scale of the wrong length
        kq.quant_im2col(x, 3, sc[:32])
    with pytest.raises(ValueError):          # int8 input with a scale
        kq.quant_im2col(x.to(torch.int8), 3, sc)
    acc = torch.zeros((2 * 9 * 7, 64), dtype=torch.int32, device="cuda")
    ones = torch.ones(64, device="cuda")
    with pytest.raises(ValueError):          # mask in another dtype
        kq.dequant_epilogue(acc, ones, torch.bfloat16, (2, 9, 7),
                            mask=torch.ones((2, 9, 7, 1), device="cuda"))
    with pytest.raises(ValueError):          # C_out not a multiple of 8
        kq.dequant_epilogue(acc[:, :60].contiguous(), ones[:60],
                            torch.float32, (2, 9, 7))
    with pytest.raises(ValueError):          # _int_mm's shape rules
        kq.int8_gemm(torch.zeros((16, 64), dtype=torch.int8, device="cuda"),
                     torch.zeros((64, 64), dtype=torch.int8, device="cuda"))


@pytest.mark.parametrize("ckpt", ["x4_ship4_qat_static.npz",
                                  "x4_ship4_qat.npz"])
@needs_cuda
def test_cuda_int8_forward_kernels_match_plain(ckpt):
    """fp32 int8 forward, the quant kernels against their plain versions
    on the card, the CAC kernels in both: bitwise (the float convs left,
    the stems' first layers and the head, take one cuDNN algorithm under
    deterministic mode)."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.kernels import quant as kq
    from codon_tpu_torch.quant_ops import Int8Ops, Int8StaticOps
    tree = load_npz(os.path.join(CKPT_DIR, ckpt))
    scales = tree.pop("act_scales", None)
    params = params_from_numpy(tree, "cuda")
    rng = np.random.RandomState(120)
    d = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    c = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    m = to_torch(cac_mask(), "cuda")
    cfg = tnet.CodonConfig(dead_heads=True, cac_impl="kernel")

    def ops(impl):
        return (Int8StaticOps(scales, quant_impl=impl) if scales is not None
                else Int8Ops(quant_impl=impl))

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kq.reset_launches()
        k = tnet.codon_forward(params, d, c, mask=m, cfg=cfg, ops=ops(None))
        counts = kq.launches()
        p = tnet.codon_forward(params, d, c, mask=m, cfg=cfg,
                               ops=ops("plain"))
    finally:
        torch.backends.cudnn.deterministic = saved
    # 43 quantized convs a forward, one block each at this size; the
    # static backend's 26 handoffs quantize through quant_im2col too
    handoffs = 26 if scales is not None else 0
    assert counts == {"quant_im2col": 43 + handoffs, "dequant_epilogue": 43,
                      "int8_gemm": 43}
    assert bool(torch.isfinite(k).all()) and torch.equal(k, p)


# ---------------------------------------------------------------------------
# the merged-tower forward's kernels: CAC kernels on the halves of one
# (N, H, W, 2C) tensor (a tower pitch of 2C), the quant kernels on channel
# and output windows (grouped int8 convs)
# ---------------------------------------------------------------------------

def _merged_inputs(dtype, seed, shape=(N, H, W, C), valid=None):
    """T and inputs2, (N,H,W,2C), zero on padding, and the rest of a
    stage's inputs."""
    n, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.zeros((n, h, w, 1), device="cuda")
    for i, (vh, vw) in enumerate(valid or [(h, w)] * n):
        mask[i, :vh, :vw] = 1.0
    T, inputs2 = [(torch.randn((n, h, w, 2 * c), generator=g, device="cuda")
                   * mask).to(dtype).contiguous() for _ in range(2)]
    gate = torch.rand((n, 1, c), generator=g, device="cuda")
    logits = torch.randn((n, h, w), generator=g, device="cuda").to(dtype)
    return T, inputs2, mask.to(dtype), gate, logits


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("shape,valid", [
    ((N, H, W, C), [(H, W), (19, 15)]),
    ((2, 384, 480, C), [(370, 463), (375, 450)]),
], ids=["odd", "main"])
@needs_cuda
def test_cuda_pitched_stats_matches_plain(dtype, masked, shape, valid):
    T, _, m, _, _ = _merged_inputs(dtype, 130, shape, valid)
    m = m if masked else None
    c = shape[-1]
    n0 = tcac.cac_stats.launches
    got = tcac.cac_stats(T[..., :c], T[..., c:], m)
    assert tcac.cac_stats.launches == n0 + 1
    want = tcac.cac_stats_plain(T[..., :c], T[..., c:], m)
    npix = shape[1] * shape[2]
    atol, rtol = {torch.float16: (2 ** -9, 2 ** -9)}.get(
        dtype, CUDA_TOLS.get(dtype))
    _close(got[0] / npix, want[0] / npix, *CUDA_TOLS[torch.float32])
    _close(got[1], want[1], *CUDA_TOLS[torch.float32])
    for g, w in zip(got[2:], want[2:]):
        _close(g, w, atol, rtol)
    # the same numbers as the contiguous towers give the kernel
    flat = tcac.cac_stats(T[..., :c].contiguous(), T[..., c:].contiguous(),
                          m)
    for a, b in zip(got, flat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("into", ["merged", "towers"])
@needs_cuda
def test_cuda_pitched_apply_matches_plain(dtype, into):
    """Inputs at pitch 2C; outputs into both halves of one new tensor, or
    into two contiguous towers: the kernel's bits equal the contiguous
    call's, and the plain version's within the stage tolerances."""
    T, inputs2, _, gate, logits = _merged_inputs(dtype, 131)
    halves = (T[..., :C], T[..., C:], inputs2[..., :C], inputs2[..., C:])
    if into == "merged":
        nxt = torch.full_like(T, float("nan"))
        dst = (nxt[..., :C], nxt[..., C:])
    else:
        dst = None
    n0 = tcac.cac_apply.launches
    got = tcac.cac_apply(*halves, gate, logits, dst=dst)
    assert tcac.cac_apply.launches == n0 + 1
    flat = tcac.cac_apply(*[t.contiguous() for t in halves], gate, logits)
    for a, b in zip(got, flat):
        assert torch.equal(a, b)
    want = tcac.cac_apply_plain(*halves, gate, logits)
    atol, rtol = {torch.float16: (2 ** -9, 2 ** -9)}.get(
        dtype, CUDA_TOLS.get(dtype))
    for g, w in zip(got, want):
        _close(g, w, atol, rtol)
    if into == "merged":
        assert not bool(torch.isnan(nxt).any())


@needs_cuda
def test_cuda_pitched_wrappers_refuse_mixed_pitches():
    T, inputs2, m, gate, logits = _merged_inputs(torch.float32, 132)
    with pytest.raises(ValueError, match="pitch"):
        tcac.cac_stats(T[..., :C], T[..., C:].contiguous(), m)
    with pytest.raises(ValueError, match="pitch"):
        tcac.cac_apply(T[..., :C], T[..., C:], inputs2[..., :C].contiguous(),
                       inputs2[..., C:], gate, logits)
    with pytest.raises(ValueError):                 # dst of another dtype
        nxt = torch.empty_like(T, dtype=torch.bfloat16)
        tcac.cac_apply(T[..., :C], T[..., C:], inputs2[..., :C],
                       inputs2[..., C:], gate, logits,
                       dst=(nxt[..., :C], nxt[..., C:]))


@pytest.mark.parametrize("dtype", QUANT_DTYPES, ids=QUANT_IDS)
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("c,cg", [(128, 64), (256, 128), (64, 16)],
                         ids=["128-64", "256-128", "64-16"])
@needs_cuda
def test_cuda_windowed_im2col_matches_plain(dtype, k, c, cg):
    from codon_tpu_torch.kernels import quant as kq
    x, sc, sx = _quant_input((N, H, W, c), dtype, seed=140 + k)
    scales = ([(None, None)] if dtype == torch.int8
              else [(sc, None), (None, sx)])
    for a, b in scales:
        for c0 in range(0, c, cg):
            got = kq.quant_im2col(x, k, a, b, c0=c0, cg=cg)
            want = kq.quant_im2col_plain(x, k, a, b, c0=c0, cg=cg)
            assert got.shape == (N * H * W, k * k * cg)
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@needs_cuda
def test_cuda_windowed_epilogue_matches_plain(dtype, masked):
    from codon_tpu_torch.kernels import quant as kq
    g = torch.Generator(device="cuda").manual_seed(150)
    acc = torch.randint(-2 ** 12, 2 ** 12, (N * H * W, 64), generator=g,
                        device="cuda", dtype=torch.int32)
    sw = torch.rand((64,), generator=g, device="cuda") * 1e-3
    m = to_torch(cac_mask(), "cuda").to(dtype) if masked else None
    for o0 in (0, 64, 192):
        got = torch.full((N, H, W, 256), -1.0, device="cuda").to(dtype)
        want = got.clone()
        kq.dequant_epilogue(acc, sw, dtype, (N, H, W), None, m, out=got,
                            o0=o0)
        kq.dequant_epilogue_plain(acc, sw, dtype, (N, H, W), None, m,
                                  out=want, o0=o0)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="window"):
        kq.dequant_epilogue(acc, sw, dtype, (N, H, W), None, m,
                            out=got, o0=200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("k,c,co", [(3, 128, 128), (5, 256, 256),
                                    (1, 256, 128)])
@needs_cuda
def test_cuda_grouped_int8_conv_matches_plain(dtype, k, c, co, monkeypatch):
    """groups=2 over image blocks: one quantize a block (float input),
    then a gather, a GEMM and an epilogue a group; bitwise."""
    from codon_tpu_torch.kernels import quant as kq
    shape = (3, 37, 29, c)
    x, sc, sx = _quant_input(shape, dtype, seed=160 + k)
    g = torch.Generator(device="cuda").manual_seed(161)
    w8 = torch.randint(-127, 128, (k, k, c // 2, co), generator=g,
                       device="cuda", dtype=torch.int8)
    sw = torch.rand((co,), generator=g, device="cuda") * 1e-3
    m = torch.ones(shape[:3] + (1,), device="cuda")
    m[-1, 20:] = 0
    out_dt = torch.float32 if dtype == torch.int8 else dtype
    scales = ([(None, None)] if dtype == torch.int8
              else [(sc, None), (None, sx)])
    # two images a block: blocks of 2 and 1
    monkeypatch.setattr(kq, "PATCH_BYTES_MAX", 2 * 37 * 29 * k * k * c // 2)
    for a, b in scales:
        before = kq.launches()
        got = kq.int8_conv(x, w8, sw, out_dt, sc=a, sx=b, mask=m, groups=2)
        after = kq.launches()
        quantize = 0 if dtype == torch.int8 else 2
        assert after["quant_im2col"] - before["quant_im2col"] == 4 + quantize
        assert after["int8_gemm"] - before["int8_gemm"] == 4
        assert after["dequant_epilogue"] - before["dequant_epilogue"] == 4
        want = kq.int8_conv(x, w8, sw, out_dt, sc=a, sx=b, mask=m, groups=2,
                            impl="plain")
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["codon_fused", "rmcr_fuse_rmcr"])
@needs_cuda
def test_cuda_other_forwards_kernel_path_matches_torch_path(variant):
    """fp32: the fused forward's CAC kernels on the halves of T against
    its plain stage (1e-4, as the packed forward), and both against the
    packed `codon` forward (2e-4 / 1e-3, the JAX test's); the sequential
    forward launches no CAC kernel."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.variants import get_variant
    params = params_from_numpy(
        load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")), "cuda")
    rng = np.random.RandomState(170)
    d = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    c = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    m = to_torch(cac_mask(), "cuda")
    v = get_variant(variant)
    tcac.reset_launches()
    k = v.forward_fn(params, d, c, mask=m,
                     cfg=dataclasses.replace(v.cfg, cac_impl="kernel"))
    counts = tcac.launches()
    t = v.forward_fn(params, d, c, mask=m,
                     cfg=dataclasses.replace(v.cfg, cac_impl="torch"))
    assert bool(torch.isfinite(k).all())
    assert float((k - t).abs().max()) <= 1e-4
    want = 5 if variant == "codon_fused" else 0
    assert counts == {"cac_stats": want, "spatial_logits": want,
                      "cac_apply": want}
    if variant == "codon_fused":
        packed = get_variant("codon").forward(params, d, c, mask=m)
        assert torch.allclose(k, packed, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("variant", ["codon_fused", "rmcr_fuse_rmcr"])
@pytest.mark.parametrize("ckpt", ["x4_ship4_qat_static.npz",
                                  "x4_ship4_qat.npz"])
@needs_cuda
def test_cuda_other_int8_forwards_kernels_match_plain(variant, ckpt):
    """fp32 int8 forwards of the two other variants, the quant kernels
    against their plain versions, the CAC kernels in both: bitwise."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.kernels import quant as kq
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8Ops, Int8StaticOps
    tree = load_npz(os.path.join(CKPT_DIR, ckpt))
    scales = tree.pop("act_scales", None)
    params = params_from_numpy(tree, "cuda")
    rng = np.random.RandomState(180)
    d = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    c = to_torch(rng.rand(N, H, W, 1).astype(np.float32), "cuda")
    m = to_torch(cac_mask(), "cuda")
    v = get_variant(variant)
    cfg = dataclasses.replace(v.cfg, cac_impl="kernel")

    def ops(impl):
        return (Int8StaticOps(scales, quant_impl=impl) if scales is not None
                else Int8Ops(quant_impl=impl))

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kq.reset_launches()
        k = v.forward_fn(params, d, c, mask=m, cfg=cfg, ops=ops(None))
        counts = kq.launches()
        p = v.forward_fn(params, d, c, mask=m, cfg=cfg, ops=ops("plain"))
    finally:
        torch.backends.cudnn.deterministic = saved
    if variant == "codon_fused":
        # 4 grouped sites a stage x 5 and conv_input+conv_input_c, each a
        # quantize and 2 gathers, 2 GEMMs and 2 epilogues; 14 ungrouped
        # convs: conv7, (conv8, conv9, conv10, confuse_fuse) x 3, conv11
        grouped, plain_convs = 21, 1 + 4 * 3 + 1
    else:
        # the stems' second convs, (packed, conv3/6, confuse) x 5 a tower,
        # conv7, (packed_f, conv10, confuse_fuse) x 3, conv11; no handoffs
        grouped, plain_convs = 0, 2 + 3 * 5 * 2 + 1 + 3 * 3 + 1
    assert counts == {"quant_im2col": 3 * grouped + plain_convs,
                      "dequant_epilogue": 2 * grouped + plain_convs,
                      "int8_gemm": 2 * grouped + plain_convs}
    assert bool(torch.isfinite(k).all()) and torch.equal(k, p)


# ---------------------------------------------------------------------------
# CacStageFunction: the kernels under autograd (the training forward)
# ---------------------------------------------------------------------------

# the stage's output, kernels against the plain stage: float32 as the
# kernels' own tolerance; bfloat16 a few ulps more than one kernel's, since
# the plain stage pools, runs the MLP and the gates in bfloat16 where the
# kernels keep float32 and round the gate product once
STAGE_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -4, 2 ** -5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,valid,corner", [
    ((N, H, W, C), [(H, W), (19, 15)], "top_left"),
    ((16, 384, 480, C), [(370, 463), (375, 450)] * 8, "bottom_right"),
], ids=["odd", "tta8"])
@needs_cuda
def test_cuda_cac_stage_function(dtype, shape, valid, corner, monkeypatch):
    """Forward: the three kernels, one launch each, against the plain
    stage. Backward: no launch, and with cuDNN deterministic the gradients
    of autograd of the plain stage at the same inputs, bitwise."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    towers, m, _, _, _ = _placed_inputs(shape, valid, corner, dtype, seed=80)
    ws = [to_torch(w, "cuda") for w in cac_weights(81)]
    leaves = [t.requires_grad_() for t in towers + ws]
    tcac.reset_launches()
    got = tcac.CacStageFunction.apply(*leaves, m)
    assert tcac.launches() == {"cac_stats": 1, "spatial_logits": 1,
                               "cac_apply": 1}
    want = tnet.cac_stage_torch(*leaves, mask=m)
    atol, rtol = STAGE_TOLS[dtype]
    for g, w in zip(got, want):
        _close(g, w, atol, rtol)
    g = torch.Generator(device="cuda").manual_seed(82)
    cot = [torch.randn(t.shape, generator=g, device="cuda").to(dtype)
           for t in got]
    ga = torch.autograd.grad(got, leaves, cot)
    assert sum(tcac.launches().values()) == 3
    gb = torch.autograd.grad(want, leaves, cot)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@needs_cuda
def test_cuda_cac_stage_function_on_pitched_halves(dtype, monkeypatch):
    """codon_fused's training stage: CacStageFunction on the two halves of
    one (N, H, W, 2C) tensor T and of the stem output (a tower pitch of
    2C). Forward: one launch of each kernel, against the plain stage on
    the same views; backward: no launch, and the gradients of T and the
    stem output (through the views) and of the weights bitwise those of
    autograd of the plain stage."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    T, inputs2, m, _, _ = _merged_inputs(dtype, 132, valid=[(H, W),
                                                           (19, 15)])
    ws = [to_torch(w, "cuda").requires_grad_() for w in cac_weights(83)]
    T.requires_grad_()
    inputs2.requires_grad_()

    def halves():
        return (T[..., :C], T[..., C:], inputs2[..., :C], inputs2[..., C:])

    tcac.reset_launches()
    got = tcac.CacStageFunction.apply(*halves(), *ws, m)
    assert tcac.launches() == {"cac_stats": 1, "spatial_logits": 1,
                               "cac_apply": 1}
    want = tnet.cac_stage_torch(*halves(), *ws, mask=m)
    atol, rtol = STAGE_TOLS[dtype]
    for g, w in zip(got, want):
        _close(g, w, atol, rtol)
    g = torch.Generator(device="cuda").manual_seed(84)
    cot = [torch.randn(t.shape, generator=g, device="cuda").to(dtype)
           for t in got]
    leaves = [T, inputs2, *ws]
    ga = torch.autograd.grad(torch.cat(got, -1), leaves, torch.cat(cot, -1))
    assert sum(tcac.launches().values()) == 3
    gb = torch.autograd.grad(torch.cat(want, -1), leaves, torch.cat(cot, -1))
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def _grad_distance(a, b):
    """(tree relative L2 of a - b, the worst leaf's max |a - b| over its
    max |b|) over the leaves with a gradient."""
    num = den = worst = 0.0
    for x, y in zip(a, b):
        scale = float(y.abs().max())
        if scale == 0:
            continue
        d = (x - y).float()
        num += float((d * d).sum())
        den += float((y.float() ** 2).sum())
        worst = max(worst, float(d.abs().max()) / scale)
    return (num / den) ** 0.5, worst


@needs_cuda
def test_cuda_train_step_launches_and_gradients():
    """One training step of full-width codon on the card: 5 launches of
    each CAC kernel in the forward and none in the backward; loss and
    gradients against the same step with the plain stage, at chip_smoke.py's
    TRAIN_TOLS: fp32 loss rtol 1e-5, tree 1e-3, leaf 1e-2; bf16 loss 1e-2,
    tree 0.1, leaf 0.25, and no more than 1.5x farther from the fp32
    gradient than the plain bf16 step."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.trainer import TrainConfig, make_train_step

    params = params_from_numpy(
        load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")), "cuda")
    rng = np.random.RandomState(90)
    batch = {k: to_torch(rng.rand(2, 32, 32, 1).astype(np.float32), "cuda")
             for k in ("depth", "color", "label")}
    batch["mask"] = torch.ones_like(batch["depth"])
    res = {}
    for dtype in ("fp32", "bf16"):
        for impl in ("kernel", "torch"):
            v = get_variant("codon", DTYPE_POLICIES[dtype])
            v = dataclasses.replace(v, cfg=dataclasses.replace(
                v.cfg, cac_impl=impl))
            step, _ = make_train_step(v, TrainConfig())
            tcac.reset_launches()
            res[dtype, impl] = step.value_and_grad(params, batch)
            want = 5 if impl == "kernel" else 0
            assert tcac.launches() == {"cac_stats": want,
                                       "spatial_logits": want,
                                       "cac_apply": want}
    for dtype, (loss_tol, leaf_tol, tree_tol) in (
            ("fp32", (1e-5, 1e-2, 1e-3)), ("bf16", (1e-2, 0.25, 0.1))):
        (lk, gk), (lt, gt) = res[dtype, "kernel"], res[dtype, "torch"]
        assert abs(float(lk) - float(lt)) <= loss_tol * abs(float(lt))
        tree, worst = _grad_distance(gk, gt)
        assert tree <= tree_tol and worst <= leaf_tol, (dtype, tree, worst)
    ref = res["fp32", "torch"][1]
    assert (_grad_distance(res["bf16", "kernel"][1], ref)[0]
            <= 1.5 * _grad_distance(res["bf16", "torch"][1], ref)[0])


@needs_cuda
def test_cuda_fused_train_step_launches_and_gradients():
    """One codon_fused training step on the card: 5 launches of each CAC
    kernel, all in the forward; loss and gradients against the same step
    with the plain stage and against codon's kernel step, at fp32's
    TRAIN_TOLS (loss rtol 1e-5, tree 1e-3, leaf 1e-2)."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.train.trainer import TrainConfig, make_train_step

    params = params_from_numpy(
        load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")), "cuda")
    rng = np.random.RandomState(91)
    batch = {k: to_torch(rng.rand(2, 32, 32, 1).astype(np.float32), "cuda")
             for k in ("depth", "color", "label")}
    batch["mask"] = torch.ones_like(batch["depth"])
    res = {}
    for name, impl in (("codon_fused", "kernel"), ("codon_fused", "torch"),
                       ("codon", "kernel")):
        v = get_variant(name)
        v = dataclasses.replace(v, cfg=dataclasses.replace(v.cfg,
                                                           cac_impl=impl))
        step, _ = make_train_step(v, TrainConfig())
        tcac.reset_launches()
        res[name, impl] = step.value_and_grad(params, batch)
        # the forward's 5 stages launch once each; the backward none
        want = 5 if impl == "kernel" else 0
        assert tcac.launches() == {"cac_stats": want, "spatial_logits": want,
                                   "cac_apply": want}
    lk, gk = res["codon_fused", "kernel"]
    for ref in (res["codon_fused", "torch"], res["codon", "kernel"]):
        assert abs(float(lk) - float(ref[0])) <= 1e-5 * abs(float(ref[0]))
        tree, worst = _grad_distance(gk, ref[1])
        assert tree <= 1e-3 and worst <= 1e-2, (tree, worst)


# the zoo's narrow int8 sites: (x shape, HWIO w shape, groups): RCAN's
# gate on a pooled vector (M = N rows, C_out 4, then C_in 4), CGNL's
# grouped z (4 input channels a group), and an odd 3x3 site
NARROW_SITES = {"pooled_64_to_4": ((3, 1, 1, 64), (1, 1, 64, 4), 1),
                "pooled_4_to_64": ((3, 1, 1, 4), (1, 1, 4, 64), 1),
                "grouped_z": ((2, 37, 29, 32), (1, 1, 4, 64), 8),
                "odd_3x3": ((2, 37, 29, 20), (3, 3, 20, 12), 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", list(NARROW_SITES))
@needs_cuda
def test_cuda_narrow_int8_conv_matches_plain(site, dtype):
    """A narrow site runs zero-padded to the kernels' widths, through the
    kernels (one launch of each a group, a quantize first when grouped),
    bitwise equal to the plain route on the same padding."""
    from codon_tpu_torch.kernels import quant as kq
    xs, ws, groups = NARROW_SITES[site]
    x, sc, sx = _quant_input(xs, dtype, seed=180 + len(site))
    g = torch.Generator(device="cuda").manual_seed(181)
    w8 = torch.randint(-127, 128, ws, generator=g, device="cuda",
                       dtype=torch.int8)
    sw = torch.rand((ws[3],), generator=g, device="cuda") * 1e-3
    m = None if xs[1] == 1 else torch.ones(xs[:3] + (1,), device="cuda")
    for a, b in ((sc, None), (None, sx)):
        before = kq.launches()
        got = kq.int8_conv(x, w8, sw, dtype, sc=a, sx=b, mask=m,
                           groups=groups)
        after = kq.launches()
        n = {k: after[k] - before[k] for k in after}
        assert n == {"quant_im2col": groups + (groups > 1),
                     "dequant_epilogue": groups, "int8_gemm": groups}
        want = kq.int8_conv(x, w8, sw, dtype, sc=a, sx=b, mask=m,
                            groups=groups, impl="plain")
        assert got.shape == xs[:3] + (ws[3],) and torch.equal(got, want)


@pytest.mark.parametrize("name", ["basenet_nlar", "rmcr_fuse_rmcr_rcan",
                                  "rmcr_fuse_rmcr_eccv"])
@needs_cuda
def test_cuda_zoo_forward_matches_cpu(name):
    """A zoo net's fp32 forward, masked, on the card (TF32 off) against
    the same forward on the CPU: the parity tolerance, atol 5e-4 + rtol
    1e-3 of the output's max |y| (random-init outputs are differences of
    large activations); no CAC kernel launches; its int8 forward through
    the quant kernels equals the plain route bitwise."""
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8Ops
    v = get_variant("zoo:" + name)
    params = v.init(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.RandomState(190)
    m = cac_mask()
    d = rng.rand(N, H, W, 1).astype(np.float32) * m
    c = rng.rand(N, H, W, 1).astype(np.float32) * m
    on_cpu = v.forward(params, to_torch(d), to_torch(c), mask=to_torch(m))
    cuda = {k: t.cuda() for k, t in params.items()}
    dc, cc, mc = (to_torch(a, "cuda") for a in (d, c, m))
    tcac.reset_launches()
    on_card = v.forward(cuda, dc, cc, mask=mc)
    assert sum(tcac.launches().values()) == 0
    err = float((on_card.cpu() - on_cpu).abs().max())
    assert err <= 5e-4 + 1e-3 * float(on_cpu.abs().max()), err
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        k, p = (v.forward(cuda, dc, cc, mask=mc, ops=Int8Ops(quant_impl=i))
                for i in (None, "plain"))
    finally:
        torch.backends.cudnn.deterministic = saved
    assert torch.equal(k, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", OP_CASES)
@needs_cuda
def test_cuda_custom_ops_pass_opcheck(case, dtype):
    """The CUDA implementation of each codon:: op against its fake one
    (shapes, dtypes, strides, a symbolic batch) and its schema."""
    op, args = op_case(case, device="cuda", dtype=dtype)
    result = torch.library.opcheck(getattr(torch.ops.codon, op), args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("config", ["bf16-mask", "int8-static-tta4"])
@needs_cuda
def test_cuda_exported_forward_equals_live(config, tmp_path):
    """codon on x4_ship4 (bf16, mask input) and on x4_ship4_qat_static
    (static int8, TTA4), exported on the card at batch 2 and run at 1 and
    3: bitwise equal to the live forward, with the same CAC and quant
    launches."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.core.params import BF16
    from codon_tpu_torch.kernels import quant as kq
    from codon_tpu_torch.models.tta import make_tta_forward
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8StaticOps
    from codon_tpu_torch.serve import export_forward, load_exported
    v = get_variant("codon", BF16)
    if config == "bf16-mask":
        tree, ops, tta = load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")), \
            None, 0
    else:
        tree = load_npz(os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz"))
        ops = Int8StaticOps(params_from_numpy(tree.pop("act_scales"),
                                              "cuda"),
                            compute_dtype=torch.bfloat16)
        tta = 4
    params = params_from_numpy(tree, "cuda")
    path = str(tmp_path / "m.pt2")
    export_forward(v, params, (H, W), path, ops=ops, mask=True, tta=tta)
    fn = load_exported(path)
    assert fn.meta["platform"] == "cuda"

    def live(d, c, m):
        fwd = lambda p, a, b, mk: v.forward(p, a, b, mask=mk, ops=ops)  # noqa: E731
        return (make_tta_forward(fwd) if tta else fwd)(params, d, c, m)

    rng = np.random.RandomState(200)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for b in (1, 3):
            m = np.ones((b, H, W, 1), np.float32)
            m[-1, 20:] = 0
            d, c = (to_torch(rng.rand(b, H, W, 1).astype(np.float32) * m,
                             "cuda") for _ in range(2))
            m = to_torch(m, "cuda")
            counts = []
            outs = []
            for run in (live, fn):
                tcac.reset_launches()
                kq.reset_launches()
                outs.append(run(d, c, m))
                counts.append({**tcac.launches(), **kq.launches()})
            assert counts[0] == counts[1]
            assert counts[0]["cac_stats"] == 5
            assert torch.equal(outs[0], outs[1])
    finally:
        torch.backends.cudnn.deterministic = saved


# ---------------------------------------------------------------------------
# the mesh: haloed int8 patches, the sharded CAC stage on one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "window"])
@pytest.mark.parametrize("k", [3, 5])
@needs_cuda
def test_cuda_haloed_quant_im2col_matches_plain(mode, k):
    """A spatial shard's patches, read through its neighbours' halo rows
    (0 <= halo <= k // 2), bitwise equal to the plain version's; so is
    the composed int8 conv on them."""
    from codon_tpu_torch.kernels import quant as kq
    g = torch.Generator().manual_seed(13)
    n, h, w, c = 2, 13, 11, 32
    x = torch.randn((n, h, w, c), generator=g) * 3
    sc = torch.rand(c, generator=g) * 0.05 + 0.01
    if mode in ("int8", "window"):
        x = kq.quantize_plain(x, sc)
    elif mode == "bf16":
        x = x.bfloat16()
    args = {"int8": (None, None, 0, None), "window": (None, None, 16, 16)
            }.get(mode, (sc, None, 0, None))
    xd = x.cuda()
    ad = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)
    for halo in range(k // 2 + 1):
        got = kq.quant_im2col(xd, k, *ad, halo=halo)
        want = kq.quant_im2col_plain(x, k, *args, halo=halo)
        assert got.shape == want.shape == (n * (h - 2 * halo) * w,
                                           k * k * (args[3] or c))
        assert torch.equal(got.cpu(), want)
    if mode != "window":
        w8 = torch.randint(-127, 128, (k, k, c, 16), generator=g,
                           dtype=torch.int8)
        sw = torch.rand(16, generator=g) * 1e-3
        r = k // 2
        kw = {"sc": sc.cuda()} if mode != "int8" else {}
        got = kq.int8_conv(xd, w8.cuda(), sw.cuda(), torch.float32, halo=r,
                           **kw)
        want = kq.int8_conv(xd, w8.cuda(), sw.cuda(), torch.float32,
                            halo=r, impl="plain", **kw)
        assert got.shape == (n, h - 2 * r, w, 16)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@needs_cuda
def test_cuda_sharded_stage_one_rank_matches_cac_stage(dtype):
    """The kernel stage over a one-rank sp group (gloo, its all-reduces
    on CUDA tensors; the halo rows of the pooled planes zeros, as the
    kernel's own SAME padding) equals the whole-image `cac_stage`
    bitwise, one launch of each kernel."""
    from codon_tpu_torch.parallel import MeshPool
    towers, mask, _, _, _ = _cuda_inputs(dtype, 21)
    ws = [to_torch(a, "cuda") for a in cac_weights(22)]
    want = tcac.cac_stage(*towers, *ws, mask)
    with MeshPool(1, device="cuda", backend="gloo", timeout_s=60) as pool:
        mesh = pool.mesh(1, 1)
        tcac.reset_launches()
        got = tcac.cac_stage(*towers, *ws, mask, group=mesh.sp_group)
        torch.cuda.synchronize()
        assert tcac.launches() == {"cac_stats": 1, "spatial_logits": 1,
                                   "cac_apply": 1}
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@needs_cuda
def test_cuda_sharded_stage_function_one_rank_matches_plain(dtype):
    """`CacStageFunction` over a one-rank sp group on the card against its
    plain sharded recompute (`cac_stage_torch` under `ShardedOps` over the
    same group): the outputs within the kernels' tolerance, the gradients
    bitwise (the backward is autograd of that recompute); one launch of
    each kernel, all in the forward."""
    from codon_tpu_torch.parallel import MeshPool, ShardedOps
    towers, mask, _, _, _ = _cuda_inputs(dtype, 23)
    ws = [to_torch(a, "cuda") for a in cac_weights(24)]
    gen = torch.Generator().manual_seed(25)
    cot = [torch.randn(towers[0].shape, generator=gen).to("cuda", dtype)
           for _ in range(2)]
    atol, rtol = CUDA_TOLS[dtype]
    with MeshPool(1, device="cuda", backend="gloo", timeout_s=60) as pool:
        group = pool.mesh(1, 1).sp_group
        xs = [t.clone().requires_grad_(True) for t in towers + ws]
        tcac.reset_launches()
        got = tcac.CacStageFunction.apply(*xs, mask, group)
        torch.cuda.synchronize()
        fwd = tcac.launches()
        grads = torch.autograd.grad(got, xs, cot)
        torch.cuda.synchronize()
        assert fwd == tcac.launches() == {"cac_stats": 1,
                                          "spatial_logits": 1,
                                          "cac_apply": 1}
        ys = [t.clone().requires_grad_(True) for t in towers + ws]
        want = tnet.cac_stage_torch(*ys, mask=mask,
                                    ops=ShardedOps(group=group))
        want_grads = torch.autograd.grad(want, ys, cot)
    for g_, w_ in zip(got, want):
        _close(g_, w_, atol, rtol)
    for g_, w_ in zip(grads, want_grads):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@needs_cuda
def test_cuda_sharded_step_one_rank_launches_in_the_forward(dtype):
    """A sharded training step's gradient on a one-rank mesh with the
    spatially sharded backend (`ShardedOps`, its kernel stage
    `CacStageFunction` over the sp group): 5 launches of each CAC kernel,
    all in the forward, none of the whole-image stage, and the loss and
    each gradient leaf within (loss rtol, of the leaf's max) of the
    single-device step: fp32 1e-5 / 1e-5; bf16 1e-2 / 0.25, chip_smoke.py's
    bf16 TRAIN_TOLS (the sharded recompute pools through float32
    all-reduces where the whole-image one sums in bf16, a bf16 ulp apart
    that cascades)."""
    from codon_tpu_torch.core.params import DTYPE_POLICIES
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.parallel import MeshPool, ShardedOps
    from codon_tpu_torch.parallel.train import ShardTrainStep
    from codon_tpu_torch.train.trainer import TrainConfig, make_train_step
    v = get_variant("codon", DTYPE_POLICIES[dtype])
    params = v.init(torch.Generator().manual_seed(3), "cuda")
    rng = np.random.RandomState(4)
    batch = {k: to_torch(rng.rand(2, 16, 16, 1).astype(np.float32), "cuda")
             for k in ("depth", "color", "label")}
    batch["mask"] = torch.ones(2, 16, 16, 1, device="cuda")
    cfg = TrainConfig(clip_norm=1.0)
    want_loss, want = make_train_step(v, cfg)[0].value_and_grad(params,
                                                                batch)
    with MeshPool(1, device="cuda", backend="gloo", timeout_s=60) as pool:
        mesh = pool.mesh(1, 1)
        step = ShardTrainStep(v, cfg, mesh, ops=ShardedOps(mesh))
        tcac.reset_launches()
        tcac.reset_stage_calls()
        loss, grads = step.value_and_grad(params, batch)
        torch.cuda.synchronize()
        assert tcac.launches() == {k: 5 for k in ("cac_stats",
                                                  "spatial_logits",
                                                  "cac_apply")}
        assert tcac.stage_calls() == {"whole": 0, "shard": 5}
    loss_tol, leaf_tol = (1e-5, 1e-5) if dtype == "fp32" else (1e-2, 0.25)
    assert abs(float(loss) - float(want_loss)) <= loss_tol * abs(
        float(want_loss))
    for g_, w_ in zip(grads, want):
        assert float((g_ - w_).abs().max()) <= leaf_tol * max(
            float(w_.abs().max()), 1e-30)
