"""`codon_tpu_torch.entry` against `__graft_entry__.py`, on the CPU.

`entry()`'s example inputs are JAX's bitwise (the same RandomState draws).
Its forward runs on JAX's own `entry()` parameters, carried across with
`params_from_numpy`, once at the full 1 x 370 x 463 in each package and
dtype. Tolerances, and why: at a random init the output reaches ~32 and
bf16 puts the two packages 0.56 apart there, beyond
tests/test_torch_model.py's bf16 bound (atol 0.05, met on trained
weights), so bf16 is held to shape, dtype and finiteness, and the same
parameters in float32 to the fp32 forward bound, atol 5e-4 / rtol 1e-3
(they read 1.1e-4 apart).
"""
import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch import entry as tentry
from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.core.params import BF16
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import dryrun
from codon_tpu_torch.serve import export_forward, load_exported

from torch_port_common import one_torch_thread  # noqa: F401

ATOL, RTOL = 5e-4, 1e-3


@pytest.fixture(scope="module")
def both():
    """JAX's entry() and the port's, on the CPU."""
    return graft.entry(), tentry.entry("cpu")


def test_example_inputs_are_jax_bitwise(both):
    (_, (jp, jd, jc)), (_, (params, d, c)) = both
    assert d.dtype == c.dtype == torch.float32
    assert tuple(d.shape) == tuple(c.shape) == tentry.EXAMPLE_SHAPE
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(c.numpy(), jc)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes


def test_forward_on_jax_params_tracks_jax(both):
    (jfn, (jp, jd, jc)), (fn, (_, d, c)) = both
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    out = fn(params, d, c)
    want = np.asarray(jfn(jp, jd, jc))
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert bool(torch.isfinite(out).all())
    got32 = get_variant("codon").forward(params, d, c)
    want32 = np.asarray(jax_variant("codon").forward(jp, jd, jc))
    np.testing.assert_allclose(got32.numpy(), want32, atol=ATOL, rtol=RTOL)


def test_forward_exports_and_the_artifact_equals_it(both, tmp_path):
    """The forward through `serve.export_forward`, as the eval forms go:
    the artifact (traced at a small size, batch symbolic) equals `fn`
    bitwise at batch 1 and 2."""
    _, (fn, (params, _, _)) = both
    hw = (21, 18)
    path = str(tmp_path / "entry.pt2")
    export_forward(get_variant("codon", BF16), params, hw, path)
    art = load_exported(path, "cpu")
    assert art.meta["dtype"] == "bfloat16"
    rng = np.random.RandomState(1)
    for b in (1, 2):
        d, c = (torch.from_numpy(rng.rand(b, *hw, 1).astype(np.float32))
                for _ in range(2))
        assert torch.equal(art(d, c), fn(params, d, c))


def test_dryrun_is_reexported():
    assert tentry.dryrun_multichip is dryrun.dryrun


def test_module_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.main([])


def test_module_prints_shape_and_dtype(capsys):
    """`python -m codon_tpu_torch.entry --device cpu` prints what
    `__graft_entry__`'s run prints of its forward's output."""
    assert tentry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == \
        "entry: (1, 370, 463, 1) torch.float32\n"
