"""The ablation zoo's MC-cell family (the `rmcr*` nets of
`codon_tpu_torch.models.zoo`) against `codon_tpu.models.zoo` on the CPU,
with the tolerances of test_torch_zoo_unrolled.py, and the zoo's CODONNet
entry against the port's `codon` forward on a trained checkpoint.

The CODONNet entry (`rmcr_fuse_rmcr_cross_only_corss_advise1`) runs plain
ops where `codon` runs packed cells and the CAC stage; on x4_ship4.npz,
carried across as the reference's state dict (`params_to_torch_state_dict`
then `generic_state_dict_to_flat`), the two forwards read 3.6e-7 apart in
JAX; the bound is the port's forward tolerance, atol 5e-4 / rtol 1e-3.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codon_tpu.models import zoo as jzoo

from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.checkpoint.torch_convert import (
    generic_state_dict_to_flat, params_to_torch_state_dict)
from codon_tpu_torch.models import zoo as tzoo
from codon_tpu_torch.models.variants import get_variant

from test_torch_zoo_unrolled import (ATOL, RTOL, check_forward,
                                     check_gradients, check_init,
                                     check_unread)
from torch_port_common import (CKPT_DIR, ZOO_CASES,  # noqa: F401
                               one_torch_thread, to_torch, zoo_case)

MC = [n for n in jzoo.list_zoo() if n.startswith("rmcr")]
CODON_ENTRY = "rmcr_fuse_rmcr_cross_only_corss_advise1"


@pytest.mark.parametrize("case", list(ZOO_CASES))
@pytest.mark.parametrize("name", MC)
def test_mc_forward_matches_jax(name, case):
    check_forward(name, case)


@pytest.mark.parametrize("name", MC)
def test_mc_init_matches_jax(name):
    check_init(name)


@pytest.mark.parametrize("name", MC)
def test_mc_unread_leaves(name):
    check_unread(name)


@pytest.mark.parametrize("name", [
    "rmcr_fuse_rmcr_rcan", "rmcr_fuse_rmcr_cross_only_corss_advise1_onlys",
    "rmcr_fuse_rmcr_eccv"])
def test_mc_gradients_match_jax(name):
    check_gradients(name)


def test_mc_family_size():
    assert len(MC) == 15


def _ship4_as_zoo():
    """x4_ship4.npz as the zoo's flat parameters, through the reference's
    state dict: the chain that carries a trained CODONNet into the zoo."""
    v = get_variant("codon")
    sd = params_to_torch_state_dict(load_npz(os.path.join(
        CKPT_DIR, "x4_ship4.npz")), v.cfg)
    return generic_state_dict_to_flat(sd)


def test_codon_entry_keys_are_the_converted_checkpoint():
    flat = _ship4_as_zoo()
    spec = tzoo.zoo_init(CODON_ENTRY, torch.Generator(), device="cpu")
    assert sorted(flat) == sorted(spec)
    for k, a in flat.items():
        assert a.shape == tuple(spec[k].shape), k


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_codon_entry_equals_codon_on_a_trained_checkpoint(case):
    """The zoo's plain CODONNet against the port's packed `codon` forward
    (its CAC stage's plain version on the CPU), and against JAX's zoo."""
    d, c, m = zoo_case(case, seed=5)
    flat = _ship4_as_zoo()
    tm = None if m is None else to_torch(m)
    got = tzoo.zoo_forward(CODON_ENTRY, params_from_numpy(flat, "cpu"),
                           to_torch(d), to_torch(c), mask=tm)
    codon = get_variant("codon").forward(
        params_from_numpy(load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")),
                          "cpu"), to_torch(d), to_torch(c), mask=tm)
    np.testing.assert_allclose(got.numpy(), codon.numpy(), atol=ATOL,
                               rtol=RTOL)
    want = np.asarray(jzoo.zoo_forward(
        CODON_ENTRY, flat, jnp.asarray(d), jnp.asarray(c),
        mask=None if m is None else jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
