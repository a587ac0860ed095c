"""The port's geometric self-ensemble against `codon_tpu.models.tta`, on the CPU.

float32, atol 5e-4 / rtol 1e-3: the forward's tolerance against the JAX
package (tests/test_torch_model.py), since TTA averages forwards. Weights are
the JAX package's random init scaled by 0.5 (as tests/test_tta.py) or the
committed x4_ship4.npz, carried across with `params_from_numpy`; inputs are
made with numpy from a seed. Equivariance and batched == sequential are
properties of the port alone, held to 1e-5 (only the order of float sums
differs between the two sides).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.models.tta import make_tta_forward as jax_tta
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant

from torch_port_common import CKPT_DIR, one_torch_thread, to_torch  # noqa: F401

ATOL, RTOL = 5e-4, 1e-3
EQ_TOL = 1e-5


def _numpy_params(src):
    if src == "ship4":
        return jax_load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    v = jax_variant("codon")
    return jax.tree.map(lambda w: np.asarray(w) * 0.5,
                        v.init(jax.random.PRNGKey(0)))


_PARAMS = {}


def _params(src):
    if src not in _PARAMS:
        tree = jax.tree.map(np.asarray, _numpy_params(src))
        _PARAMS[src] = (tree, params_from_numpy(tree, "cpu"))
    return _PARAMS[src]


def _forwards():
    jv, tv = jax_variant("codon"), get_variant("codon")
    return ((lambda p, d, c, m: jv.forward(p, d, c, mask=m)),
            (lambda p, d, c, m: tv.forward(p, d, c, mask=m)))


def _inputs(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 1).astype(np.float32),
            rng.rand(n, h, w, 1).astype(np.float32))


def _mixed_batch():
    """24 x 19 and 17 x 13 padded to 32 x 32 with a mask, zero on padding."""
    d, c = _inputs(2, 32, 32, seed=5)
    m = np.zeros((2, 32, 32, 1), np.float32)
    m[0, :24, :19] = 1.0
    m[1, :17, :13] = 1.0
    return d * m, c * m, m


def _run_both(src, d, c, m, transforms, mode):
    tree, tparams = _params(src)
    jf, tf = _forwards()
    want = np.asarray(jax_tta(jf, mode=mode, transforms=transforms)(
        tree, jnp.asarray(d), jnp.asarray(c),
        None if m is None else jnp.asarray(m)))
    got = make_tta_forward(tf, mode=mode, transforms=transforms)(
        tparams, to_torch(d), to_torch(c), None if m is None else to_torch(m))
    assert got.is_contiguous() and tuple(got.shape) == d.shape
    return got.numpy(), want


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("transforms", [4, 8])
@pytest.mark.parametrize("src", ["random", "ship4"])
def test_tta_matches_jax(src, transforms, mode):
    d, c = _inputs(1, 20, 17, seed=1)
    got, want = _run_both(src, d, c, None, transforms, mode)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("transforms", [4, 8])
def test_tta_masked_mixed_batch_matches_jax(transforms):
    d, c, m = _mixed_batch()
    got, want = _run_both("ship4", d, c, m, transforms, "batched")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("transforms", [4, 8])
def test_tta_flip_equivariant(transforms):
    _, tparams = _params("random")
    tta = make_tta_forward(_forwards()[1], transforms=transforms)
    d, c = _inputs(1, 20, 17, seed=2)
    out = tta(tparams, to_torch(d), to_torch(c), None).numpy()
    for ax in (1, 2):
        out_f = tta(tparams, to_torch(np.flip(d, ax).copy()),
                    to_torch(np.flip(c, ax).copy()), None).numpy()
        np.testing.assert_allclose(np.flip(out_f, ax), out, atol=EQ_TOL,
                                   rtol=EQ_TOL)
    if transforms == 8:
        # D4 holds the transpose too
        out_t = tta(tparams, to_torch(d.transpose(0, 2, 1, 3).copy()),
                    to_torch(c.transpose(0, 2, 1, 3).copy()), None).numpy()
        np.testing.assert_allclose(out_t.transpose(0, 2, 1, 3), out,
                                   atol=EQ_TOL, rtol=EQ_TOL)


@pytest.mark.parametrize("transforms", [4, 8])
def test_tta_batched_matches_sequential(transforms):
    _, tparams = _params("ship4")
    tf = _forwards()[1]
    d, c, m = _mixed_batch()
    args = (tparams, to_torch(d), to_torch(c), to_torch(m))
    batched = make_tta_forward(tf, "batched", transforms)(*args)
    seq = make_tta_forward(tf, "sequential", transforms)(*args)
    np.testing.assert_allclose(batched.numpy(), seq.numpy(), atol=EQ_TOL,
                               rtol=EQ_TOL)


def test_tta_feeds_the_forward_contiguous_inputs():
    seen = []

    def fwd(p, d, c, m):
        seen.append(all(t.is_contiguous() for t in (d, c, m)))
        return d[..., :1] * 1.0

    d, c, m = _mixed_batch()
    for mode in ("batched", "sequential"):
        out = make_tta_forward(fwd, mode, 8)(None, to_torch(d), to_torch(c),
                                             to_torch(m))
        # the identity forward's ensemble is the input itself
        np.testing.assert_allclose(out.numpy(), d, atol=1e-6)
    assert seen and all(seen)


def test_tta_refuses_bad_arguments():
    with pytest.raises(ValueError):
        make_tta_forward(_forwards()[1], transforms=2)
    with pytest.raises(ValueError):
        make_tta_forward(_forwards()[1], mode="parallel")
