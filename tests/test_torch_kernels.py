"""The port's CAC kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions, which are held
against `codon_tpu.kernels.cac` in interpret mode, as tests/test_kernels.py
runs it: float32, atol 1e-5 / rtol 1e-4, compared everywhere including
padding, with and without a mask. The CUDA kernels themselves are held
against the plain versions in tests/test_torch_kernels_cuda.py, on a card.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codon_tpu.core.ops import XlaOps
from codon_tpu.kernels import cac as jcac
from codon_tpu.models.codon_net import cac_channel_gate, cac_spatial_gate

from codon_tpu_torch.core.ops import TorchOps
from codon_tpu_torch.kernels import _build
from codon_tpu_torch.kernels import cac as tcac
from codon_tpu_torch.models import codon_net as tnet

from torch_port_common import (C, H, N, W, cac_mask, cac_towers,  # noqa: F401
                               cac_weights, one_torch_thread, to_np,
                               to_torch)

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_stats_plain_matches_pallas(masked):
    out, out_c, _, _ = cac_towers(0, masked)
    m = cac_mask() if masked else None
    want = jcac.cac_stats(jnp.asarray(out), jnp.asarray(out_c),
                          None if m is None else jnp.asarray(m),
                          interpret=True)
    got = tcac.cac_stats_plain(to_torch(out), to_torch(out_c),
                               None if m is None else to_torch(m))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].dtype == got[1].dtype == torch.float32
    # sums over H*W pixels compared as means, as tests/test_kernels.py
    # compares them: the stage divides them by the pixel count, and a
    # float32 sum's rounding grows with the count
    _close(got[0] / (H * W), np.asarray(want[0]) / (H * W))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def test_stats_masked_max_leaves_out_padding():
    """Padding holding a value above every valid one must not reach the
    channel max (masked convs zero padding; the max must not rely on it)."""
    out, out_c, _, _ = cac_towers(3, masked=True)
    m = cac_mask()
    out[1, 30:, :] = 50.0           # image 1's padding rows
    got = tcac.cac_stats_plain(to_torch(out), to_torch(out_c), to_torch(m))
    want = jcac.cac_stats(jnp.asarray(out), jnp.asarray(out_c),
                          jnp.asarray(m), interpret=True)
    _close(got[1], want[1])
    assert float(got[1][1].max()) < 50.0


def test_spatial_logits_plain_matches_pallas():
    rng = np.random.RandomState(2)
    cmax = rng.randn(N, H, W).astype(np.float32)
    cmean = rng.randn(N, H, W).astype(np.float32)
    sp_w = cac_weights()[-1]
    want = jcac.spatial_logits(jnp.asarray(cmax), jnp.asarray(cmean),
                               jnp.asarray(sp_w), interpret=True)
    got = tcac.spatial_logits_plain(to_torch(cmax), to_torch(cmean),
                                    to_torch(sp_w))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 2), (37, 29), (4, 70)])
def test_spatial_logits_plain_pads_as_pallas_at_the_edges(h, w):
    """Maps smaller than the 5x5 window, and ragged ones: the plain
    version's SAME zero padding, which the card's kernel reproduces bitwise,
    is the TPU kernel's."""
    rng = np.random.RandomState(h * 100 + w)
    cmax = rng.randn(N, h, w).astype(np.float32)
    cmean = rng.randn(N, h, w).astype(np.float32)
    sp_w = cac_weights(h + w)[-1]
    want = jcac.spatial_logits(jnp.asarray(cmax), jnp.asarray(cmean),
                               jnp.asarray(sp_w), interpret=True)
    got = tcac.spatial_logits_plain(to_torch(cmax), to_torch(cmean),
                                    to_torch(sp_w))
    assert tuple(got.shape) == want.shape == (N, h, w)
    _close(got, want)


def test_apply_plain_matches_pallas():
    out, out_c, inp, inp_c = cac_towers(4, masked=False)
    rng = np.random.RandomState(5)
    gate = rng.rand(N, 1, C).astype(np.float32)
    logits = rng.randn(N, H, W).astype(np.float32)
    want = jcac.cac_apply(*map(jnp.asarray, (out, out_c, inp, inp_c, gate,
                                             logits)), interpret=True)
    got = tcac.cac_apply_plain(*map(to_torch, (out, out_c, inp, inp_c, gate,
                                               logits)))
    for g, w in zip(got, want):
        _close(g, w)


def test_apply_plain_rounds_as_pallas_in_bf16():
    """bf16: ad built in float32 and cast once, then out*ad + in in bf16 —
    the TPU kernel's rounding points."""
    out, out_c, inp, inp_c = cac_towers(6, masked=False)
    rng = np.random.RandomState(7)
    gate = rng.rand(N, 1, C).astype(np.float32)
    logits = rng.randn(N, H, W).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jcac.cac_apply(bf(out), bf(out_c), bf(inp), bf(inp_c),
                          jnp.asarray(gate), bf(logits), interpret=True)
    tb = lambda a: to_torch(a).to(torch.bfloat16)  # noqa: E731
    got = tcac.cac_apply_plain(tb(out), tb(out_c), tb(inp), tb(inp_c),
                               to_torch(gate), tb(logits))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        # one bf16 ulp where the two frameworks' sigmoids differ in the
        # last float32 bit and the cast of ad lands on the other side
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32),
                                   atol=2 ** -7, rtol=2 ** -7)


def _xla_stage(out, out_c, inp, inp_c, w1, b1, w2, b2, sp_w, mask=None):
    ops = XlaOps(precision="highest")
    ch = cac_channel_gate((out_c, out), w1, b1, w2, b2, ops, mask)
    sp = cac_spatial_gate((out_c, out), sp_w, ops, mask)
    ad = ch * sp
    return out * ad + inp, out_c * ad + inp_c


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_stage_matches_pallas_and_xla(masked):
    towers = cac_towers(8, masked)
    wts = cac_weights(9)
    m = cac_mask() if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else to_torch(m)
    j_args = [jnp.asarray(a) for a in towers + list(wts)]
    t_args = [to_torch(a) for a in towers + list(wts)]
    pallas = jcac.cac_stage_pallas(*j_args, jm, interpret=True)
    xla = _xla_stage(*j_args, mask=jm)
    kernel_stage = tcac.cac_stage(*t_args, tm)
    for g, p, x in zip(kernel_stage, pallas, xla):
        _close(g, p)
        _close(g, x)
    # the port's plain stage (cac_impl="torch") against the XLA stage
    out, out_c, inp, inp_c = t_args[:4]
    w1, b1, w2, b2, sp_w = t_args[4:]
    ops = TorchOps()
    ch = tnet.cac_channel_gate((out_c, out), w1, b1, w2, b2, ops, tm)
    sp = tnet.cac_spatial_gate((out_c, out), sp_w, ops, tm)
    ad = ch * sp
    for g, x in zip((out * ad + inp, out_c * ad + inp_c), xla):
        _close(g, x)


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    out, out_c, inp, inp_c = [to_torch(t) for t in cac_towers(10, True)]
    m = to_torch(cac_mask())
    gate = torch.rand((N, 1, C), generator=torch.Generator().manual_seed(0))
    sp_w = to_torch(cac_weights()[-1])
    before = tcac.launches()
    s = tcac.cac_stats(out, out_c, m)
    for a, b in zip(s, tcac.cac_stats_plain(out, out_c, m)):
        assert torch.equal(a, b)
    lg = tcac.spatial_logits(s[2], s[3], sp_w)
    assert torch.equal(lg, tcac.spatial_logits_plain(s[2], s[3], sp_w))
    ap = tcac.cac_apply(out, out_c, inp, inp_c, gate, lg)
    for a, b in zip(ap, tcac.cac_apply_plain(out, out_c, inp, inp_c, gate,
                                             lg)):
        assert torch.equal(a, b)
    # counts are launches of the CUDA kernels only
    assert tcac.launches() == before
    assert set(before) == {"cac_stats", "spatial_logits", "cac_apply"}


def test_wrappers_refuse_other_devices():
    t = torch.empty((1, 4, 4, C), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tcac.cac_stats(t, t)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tcac.spatial_logits(t[..., 0], t[..., 0], torch.zeros(5, 5, 2, 1))


def test_wrapper_checks_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA tensor meets before a launch, run on CPU tensors."""
    t = torch.zeros((N, H, W, C))
    tcac._check_towers(t, t.clone())                       # accepted
    misaligned = torch.zeros(N * H * W * C + 1)[1:].view(N, H, W, C)
    bad = [
        (t, t.to(torch.bfloat16)),                         # dtypes differ
        (t, t[:, :-1].contiguous()),                       # shapes differ
        (t.transpose(1, 2), t.transpose(1, 2)),            # not NHWC
        (t.double(), t.double()),                          # no float64
        (t[..., :48].contiguous(), t[..., :48].contiguous()),  # 12 vectors
        (misaligned, misaligned),                          # 4 bytes off
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tcac._check_towers(*args)
    with pytest.raises(ValueError, match="mask"):
        tcac._check_plane(t[..., :1], (N, H, W, 1), torch.bfloat16,
                          t.device, "mask")
    tcac._check_plane(t[..., :1].contiguous(), (N, H, W, 1), torch.float32,
                      t.device, "mask")


def test_reset_launches():
    tcac.cac_stats.launches = 3
    tcac.reset_launches()
    assert tcac.launches() == {"cac_stats": 0, "spatial_logits": 0,
                               "cac_apply": 0}


def test_library_path_follows_sources_and_flags(monkeypatch):
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert path == _build.library_path()
    assert any(p.endswith("cac.cu") for p in _build._sources())
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build.library_path() != path


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_ptxas_report_is_read(tmp_path, monkeypatch):
    assert ["-Xptxas", "-v"] == _build.NVCC_FLAGS[-2:]
    lib = str(tmp_path / "libk.so")
    assert _build.ptxas_usage(lib) == {}
    # the report as build() keeps it: kernel names through cu++filt -p
    logits = "void (anonymous namespace)::spatial_logits_kernel<__half, 5>"
    ring = "(anonymous namespace)::ring_copy_kernel"
    with open(lib + ".log", "w") as f:
        f.write(f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{logits}' for 'sm_90a'
ptxas info    : Function properties for {logits}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 6144 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '{ring}' for 'sm_90a'
ptxas info    : Function properties for {ring}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2ns9kernel_abEv' for 'sm_90a'
ptxas info    : Used 8 registers, 424 bytes cmem[0]
""")
    assert _build.ptxas_usage(lib) == {
        "spatial_logits_kernel<__half, 5>": {
            "registers": 72, "smem_bytes": 6144, "spill_bytes": 12},
        "ring_copy_kernel": {"registers": 30, "smem_bytes": 0,
                             "spill_bytes": 0},
        # a name cu++filt did not demangle stays whole
        "_ZN2ns9kernel_abEv": {"registers": 8, "smem_bytes": 0,
                               "spill_bytes": 0}}
    # without cu++filt beside nvcc the report is kept as ptxas wrote it
    monkeypatch.setattr(_build, "nvcc", lambda: str(tmp_path / "nvcc"))
    report = "Compiling entry function '_ZN2ns9kernel_abEv' for 'sm_90a'"
    assert _build.demangle(report) == report
