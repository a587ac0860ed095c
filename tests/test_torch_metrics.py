"""The port's metrics, batch evaluator and tee logger against the JAX
package's: the host functions exactly, the tensor functions and the
evaluator within the tolerances stated beside them."""
import os
import sys

import numpy as np
import pytest
import torch

from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.core.params import FP32 as JFP32
from codon_tpu.data.io import Sample
from codon_tpu.data.pipeline import make_batch as jax_make_batch
from codon_tpu.metrics import rmse as jrmse
from codon_tpu.metrics import ssim as jssim
from codon_tpu.metrics.ondevice import make_batch_evaluator as jax_evaluator
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.data.pipeline import make_batch
from codon_tpu_torch.metrics import rmse as trmse
from codon_tpu_torch.metrics import ssim as tssim
from codon_tpu_torch.metrics.ondevice import make_batch_evaluator
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.utils.logging import Logger

from torch_port_common import CKPT_DIR, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed,hw", [(0, (37, 29)), (1, (33, 45)),
                                     (2, (8, 8))])
def test_masked_rmse_matches_jax(seed, hw):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 256, hw).astype(np.uint8)
    label[rng.rand(*hw) < 0.1] = 0                  # invalid depth
    out = rng.randint(0, 256, hw).astype(np.uint8)
    assert trmse.masked_rmse(label, out) == jrmse.masked_rmse(label, out)


def test_masked_rmse_crops_label_to_output():
    rng = np.random.RandomState(3)
    label = rng.randint(1, 256, (40, 30)).astype(np.uint8)
    out = rng.randint(0, 256, (37, 29)).astype(np.uint8)
    assert trmse.masked_rmse(label, out) == jrmse.masked_rmse(label, out)
    assert trmse.masked_rmse(label[:37, :29], out) == \
        trmse.masked_rmse(label, out)


def test_masked_rmse_refuses_an_all_invalid_label():
    with pytest.raises(ValueError, match="no valid"):
        trmse.masked_rmse(np.zeros((4, 4), np.uint8), np.ones((4, 4)))


@pytest.mark.parametrize("seed,hw", [(0, (37, 29)), (1, (64, 48)),
                                     (2, (13, 13))])
def test_ssim_exact_matches_jax(seed, hw):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, hw).astype(np.uint8) / 255
    b = np.clip(a + rng.randn(*hw) * 0.05, 0, 1)
    got = tssim.ssim_exact(a, b)
    assert got == jssim.ssim_exact(a, b)
    assert tssim.ssim_exact(a, a) == pytest.approx(1.0)


@pytest.mark.parametrize("hw,block", [((32, 24), 4), ((37, 29), 4),
                                      ((33, 45), 5)])
def test_ssim_block_matches_jax(hw, block):
    """Bitwise, on shapes a multiple of the block and not (the rows and
    columns past the last whole block left out in both), and a block other
    than the default; C1 / C2 the defaults and given."""
    rng = np.random.RandomState(sum(hw) + block)
    a, b = rng.rand(*hw), rng.rand(*hw)
    assert tssim.ssim_block(a, b, block=block) == \
        jssim.ssim_block(a, b, block=block)
    assert tssim.ssim_block(a, b, 1e-3, 2e-3, block) == \
        jssim.ssim_block(a, b, 1e-3, 2e-3, block)


def test_logger_tees_and_restores_stdout(tmp_path, capsys):
    path = tmp_path / "logs" / "run.txt"
    saved = sys.stdout
    with Logger(str(path)):
        print("first line")
        sys.stdout.flush()
    assert sys.stdout is saved
    with Logger(str(path)):
        print("second line")
    assert path.read_text() == "first line\nsecond line\n"
    assert capsys.readouterr().out == "first line\nsecond line\n"


# ---------------------------------------------------------------------------
# on tensors: masked_rmse_torch, ssim_exact_torch and the batch evaluator
# against codon_tpu's jnp versions (JAX runs in float32 here, x64 off)
# ---------------------------------------------------------------------------

# float32 on both sides; the sums run in other orders: RMSE values of ~100
# agree to a few float32 ulps, SSIM (in [-1, 1]) to 1e-6
RMSE_TOL = 1e-4
SSIM_TOL = 1e-6


def _label_out(seed, n, h, w):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 256, (n, h, w)).astype(np.float32)
    label[rng.rand(n, h, w) < 0.1] = 0              # invalid depth
    out = np.clip(label + rng.randn(n, h, w) * 12, 0, 255).astype(np.uint8)
    return label, out.astype(np.float32)


def _pad_mask(n, h, w, valid):
    m = np.zeros((n, h, w), np.float32)
    for i, (vh, vw) in enumerate(valid):
        m[i, :vh, :vw] = 1.0
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("four_d", [False, True], ids=["nhw", "nhw1"])
def test_masked_rmse_torch_matches_jnp(masked, four_d):
    label, out = _label_out(4, 2, 32, 40)
    mask = _pad_mask(2, 32, 40, [(32, 40), (21, 27)]) if masked else None
    if four_d:
        label, out = label[..., None], out[..., None]
        mask = None if mask is None else mask[..., None]
    want = np.asarray(jrmse.masked_rmse_jnp(label, out, mask))
    got = trmse.masked_rmse_torch(
        torch.from_numpy(label), torch.from_numpy(out),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RMSE_TOL)


def test_masked_rmse_torch_float64_equals_host():
    label, out = _label_out(5, 3, 19, 23)
    got = trmse.masked_rmse_torch(torch.from_numpy(label).double(),
                                  torch.from_numpy(out).double())
    for i in range(3):
        assert float(got[i]) == pytest.approx(
            trmse.masked_rmse(label[i], out[i]), rel=1e-12)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("hw,valid", [((32, 48), [(32, 48), (20, 29)]),
                                      ((16, 16), [(16, 16), (9, 5)])])
def test_ssim_exact_torch_matches_jnp(masked, hw, valid):
    rng = np.random.RandomState(6)
    a = rng.rand(2, *hw).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(2, *hw), 0, 1).astype(np.float32)
    mask = _pad_mask(2, *hw, valid) if masked else None
    want = np.asarray(jssim.ssim_exact_jnp(a, b, mask=mask))
    got = tssim.ssim_exact_torch(
        torch.from_numpy(a), torch.from_numpy(b),
        mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SSIM_TOL)


@pytest.mark.parametrize("hw", [(37, 41), (7, 9), (5, 3)])
def test_ssim_exact_torch_unmasked_matches_scipy(hw):
    """scipy's 'reflect' border, also where the 13-tap window is wider than
    the image (7 x 9) and reflects more than once (5 x 3); float64 as the
    host function, to its rounding."""
    rng = np.random.RandomState(7)
    a = rng.rand(*hw)
    b = np.clip(a + 0.05 * rng.randn(*hw), 0, 1)
    got = float(tssim.ssim_exact_torch(torch.from_numpy(a)[None],
                                       torch.from_numpy(b)[None])[0])
    assert got == pytest.approx(tssim.ssim_exact(a, b), abs=1e-12)


def test_gaussian_kernel_matches_jax():
    np.testing.assert_array_equal(tssim.gaussian_kernel_1d(),
                                  jssim.gaussian_kernel_1d())
    np.testing.assert_array_equal(tssim.gaussian_kernel_1d(2.0, 3.0,
                                                           np.float32),
                                  jssim.gaussian_kernel_1d(2.0, 3.0,
                                                           np.float32))


# the evaluator: the JAX test's exact case (images fill the padded shape)
# and its padded case (96 x 85 and 80 x 70, padded to 16)
EVAL_CASES = {"full": ([(40, 32), (40, 32)], 8),
              "padded": ([(96, 85), (80, 70)], 16)}


def _eval_batch(case):
    sizes, pad = EVAL_CASES[case]
    rng = np.random.RandomState(8)
    samples = []
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        label = (40 + 150 * xx / w + 40 * yy / h).astype(np.uint8)
        label[rng.rand(h, w) < 0.05] = 0
        depth = np.repeat(np.repeat(label[::4, ::4], 4, 0), 4, 1)[:h, :w]
        color = (rng.rand(h, w) * 255).astype(np.uint8)
        samples.append(Sample(f"s{i}", depth, color, label))
    return (jax_make_batch(samples, pad_multiple=pad),
            make_batch(samples, pad_multiple=pad, device="cpu"))


@pytest.mark.parametrize("tta", [0, 4, 8])
@pytest.mark.parametrize("case", ["full", "padded"])
def test_batch_evaluator_matches_jax(case, tta):
    """Output bytes and metrics against JAX's evaluator, x4_ship4.npz,
    float32. The outputs agree to ~1e-5, so the uint8 truncation may move a
    pixel on an integer boundary by one level: at most 1 level on < 1% of
    pixels, RMSE within 0.01 and SSIM within 1e-4 (as
    tests/test_torch_cli.py). On the same bytes, the port's metrics equal
    the JAX ones to RMSE_TOL / SSIM_TOL."""
    tree = jax_load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    jb, tb = _eval_batch(case)
    assert (jb.mask is None) == (tb.mask is None) == (case == "full")
    np.testing.assert_array_equal(tb.label_dev.numpy(),
                                  np.asarray(jb.label_dev))
    want = jax_evaluator(jax_variant("codon", JFP32), tta=tta)(
        tree, jb.depth, jb.color, jb.mask, jb.label_dev)
    variant = get_variant("codon")

    def forward(p, d, c, m):
        return variant.forward(p, d, c, mask=m)
    if tta:
        forward = make_tta_forward(forward, transforms=tta)
    got = make_batch_evaluator(forward)(
        params_from_numpy(tree, "cpu"), tb.depth, tb.color, tb.mask,
        tb.label_dev)
    a = got["out_u8"].numpy().astype(int)
    b = np.asarray(want["out_u8"]).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1 and (a != b).mean() < 0.01
    np.testing.assert_allclose(got["rmse"].numpy(), np.asarray(want["rmse"]),
                               rtol=0, atol=0.01)
    np.testing.assert_allclose(got["ssim"].numpy(), np.asarray(want["ssim"]),
                               rtol=0, atol=1e-4)
    # the metrics alone, on JAX's bytes
    dq = torch.from_numpy(b.astype(np.float32))
    lab = tb.label_dev[..., 0]
    m = None if tb.mask is None else tb.mask[..., 0]
    np.testing.assert_allclose(
        trmse.masked_rmse_torch(lab, dq, m).numpy(),
        np.asarray(want["rmse"]), rtol=0, atol=RMSE_TOL)
    np.testing.assert_allclose(
        tssim.ssim_exact_torch(lab / 255.0, dq / 255.0, mask=m).numpy(),
        np.asarray(want["ssim"]), rtol=0, atol=SSIM_TOL)
