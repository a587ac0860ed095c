"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked `cuda` and skips without a card. The file imports no
JAX, so it runs on the machine with the card, where the repo's conftest
(which imports JAX) cannot load:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: float32 atol 1e-5 / rtol 1e-4 (only the order of float32 sums
differs); bfloat16 two ulps of its 8-bit significand (a pooled mean or a
gate value rounded once to bf16 may land one ulp apart).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from codon_tpu_torch.kernels import cac as tcac
from codon_tpu_torch.models import codon_net as tnet

from torch_port_common import (C, CKPT_DIR, H, N, W, cac_mask,  # noqa: F401
                               cac_towers, cac_weights, needs_cuda,
                               one_torch_thread, to_np, to_torch)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@needs_cuda
def test_cuda_spatial_logits_matches_plain(dtype):
    towers, m, _, _, sp_w = _cuda_inputs(dtype, 30)
    _, _, cmax, cmean = tcac.cac_stats_plain(towers[0], towers[1], m)
    got = tcac.spatial_logits(cmax, cmean, sp_w)
    want = tcac.spatial_logits_plain(cmax, cmean, sp_w)
    atol, rtol = CUDA_TOLS[dtype]
    _close(got, want, atol, rtol)


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

