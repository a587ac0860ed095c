"""The port's host metrics and tee logger against the JAX package's."""
import sys

import numpy as np
import pytest

from codon_tpu.metrics import rmse as jrmse
from codon_tpu.metrics import ssim as jssim

from codon_tpu_torch.metrics import rmse as trmse
from codon_tpu_torch.metrics import ssim as tssim
from codon_tpu_torch.utils.logging import Logger


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
