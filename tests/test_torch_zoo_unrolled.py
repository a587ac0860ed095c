"""The ablation zoo's unrolled family (the `basenet*` nets of
`codon_tpu_torch.models.zoo`) against `codon_tpu.models.zoo` on the CPU,
and the checks every zoo net shares: init, the unread leaves, a cut graph.

The MC family is in test_torch_zoo_mc.py and the attention primitives and
the int8 sites in test_torch_zoo_ops.py, so that the three files spread over
the suite's workers.

Tolerances, and why:
- forwards, float32, from JAX's own `zoo_init` parameters: atol 5e-4,
  rtol 1e-3, the port's forward tolerance (tests/test_torch_model.py). The
  convs and reductions sum in other orders; the runs here read at most
  2.8e-5 on the unrolled nets (outputs up to ~10) and 2.2e-3 on the MC
  nets' largest outputs (~470, a 5e-6 relative error).
- gradients at random init, float32, 2 x 17 x 15 masked, the l1 loss: at
  random init the global max pools and ReLUs have near-ties that float32
  noise breaks one way in one package and the other way in the other.
  JAX's jitted gradient against itself with its parameters moved by 1e-6
  N(0, 1) relative (seeds 0-2) reads, over these five nets: the gradient
  tree's relative L2 distance up to 1.6e-3, and one leaf up to 0.094 of its
  max |g| (rmcr_fuse_rmcr_eccv's first CBAM gate). The bounds hold the port
  in that class: tree L2 2e-3, per leaf 0.1, the loss rtol 1e-5 (the port
  reads tree L2 <= 5e-4 and the same 0.094 leaf). The leaves without a
  gradient are checked exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu.models import zoo as jzoo
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.models import zoo as tzoo
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.train.trainer import (TrainConfig, make_train_step,
                                           top_name, tree_items)

from torch_port_common import (ZOO_CASES, one_torch_thread,  # noqa: F401
                               to_torch, zoo_case)

ATOL, RTOL = 5e-4, 1e-3
LOSS_RTOL, TREE_L2, LEAF_TOL = 1e-5, 2e-3, 0.1
UNROLLED = [n for n in jzoo.list_zoo() if n.startswith("basenet")]


def jax_params(name, seed=0):
    """JAX's zoo_init parameters of `name`, as numpy."""
    return jax.tree.map(np.asarray,
                        jzoo.zoo_init(name, jax.random.PRNGKey(seed)))


def check_forward(name, case):
    """The port's fp32 forward against JAX's, from JAX's parameters."""
    d, c, m = zoo_case(case, seed=3)
    p = jax_params(name)
    want = np.asarray(jzoo.zoo_forward(
        name, p, jnp.asarray(d), jnp.asarray(c),
        mask=None if m is None else jnp.asarray(m)))
    got = tzoo.zoo_forward(name, params_from_numpy(p, "cpu"), to_torch(d),
                           to_torch(c),
                           mask=None if m is None else to_torch(m))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def check_init(name):
    """zoo_init: JAX's key set, shapes and dtype; the registry's doc."""
    jp = jax_params(name)
    tp = tzoo.zoo_init(name, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32, k
    assert tzoo.ZOO[name]["doc"] == jzoo.ZOO[name]["doc"]
    v = get_variant("zoo:" + name)
    assert v.doc == jax_variant("zoo:" + name).doc
    assert sorted(v.init(torch.Generator().manual_seed(1), "cpu")) == \
        sorted(jp)


def check_unread(name):
    """The entry's unread names are exactly the leaves that autograd
    reaches no gradient to, and JAX's gradient is zero on them."""
    d, c, _ = zoo_case("unmasked")
    p = params_from_numpy(jax_params(name), "cpu")
    keys = sorted(p)
    leaves = [p[k].requires_grad_(True) for k in keys]
    out = tzoo.zoo_forward(name, dict(zip(keys, leaves)), to_torch(d),
                           to_torch(c))
    grads = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    cut = {top_name(k) for k, g in zip(keys, grads) if g is None}
    assert cut == set(tzoo.ZOO[name]["unread"])
    assert get_variant("zoo:" + name).unread == tzoo.ZOO[name]["unread"]
    jg = jax.grad(lambda q: jzoo.zoo_forward(name, q, d, c).sum())(
        jax_params(name))
    for k, g in jg.items():
        if top_name(k) in cut:
            assert not np.asarray(g).any(), k


def _batch():
    n, h, w, _ = ZOO_CASES["masked"]
    rng = np.random.RandomState(0)
    label = rng.rand(n, h, w, 1).astype(np.float32)
    d, c, m = zoo_case("masked", seed=1)
    return {"depth": np.clip(label + 0.1 * rng.randn(n, h, w, 1), 0, 1
                             ).astype(np.float32) * m,
            "color": c, "label": label, "mask": m}


def check_gradients(name):
    """One training step's loss and gradients (TrainStep) against JAX's
    value_and_grad of the masked l1 loss, from JAX's parameters."""
    batch = _batch()
    jv = jax_variant("zoo:" + name)
    p = jax_params(name)

    def loss_fn(q, b):
        out = jv.forward(q, b["depth"], b["color"], mask=b["mask"])
        return (jnp.sum(jnp.abs((out - b["label"]) * b["mask"]))
                / jnp.sum(b["mask"]))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(p, batch)
    step, _ = make_train_step(get_variant("zoo:" + name), TrainConfig())
    tp = params_from_numpy(p, "cpu")
    tl, tg = step.value_and_grad(tp, {k: to_torch(a)
                                      for k, a in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    got = {k: g.numpy() for (k, _), g in zip(tree_items(tp), tg)}
    want = {k: np.asarray(g) for k, g in jg.items()}
    assert got.keys() == want.keys()
    num = sum(float(np.sum((got[k] - g) ** 2)) for k, g in want.items())
    den = sum(float(np.sum(g ** 2)) for g in want.values())
    assert (num / den) ** 0.5 <= TREE_L2
    unread = set(get_variant("zoo:" + name).unread)
    for k, g in want.items():
        err = np.abs(got[k] - g).max()
        assert err <= LEAF_TOL * max(np.abs(g).max(), 1e-30), (k, err)
        if top_name(k) in unread:
            assert not got[k].any() and not g.any(), k


@pytest.mark.parametrize("case", list(ZOO_CASES))
@pytest.mark.parametrize("name", UNROLLED)
def test_unrolled_forward_matches_jax(name, case):
    check_forward(name, case)


@pytest.mark.parametrize("name", UNROLLED)
def test_unrolled_init_matches_jax(name):
    check_init(name)


@pytest.mark.parametrize("name", UNROLLED)
def test_unrolled_unread_leaves(name):
    check_unread(name)


@pytest.mark.parametrize("name", ["basenet_nlar", "basenet_non2"])
def test_unrolled_gradients_match_jax(name):
    check_gradients(name)


def test_zoo_names_match_jax():
    assert tzoo.list_zoo() == jzoo.list_zoo()
    assert len(tzoo.list_zoo()) == 27
    assert len(UNROLLED) == 12


def test_a_cut_graph_in_a_zoo_net_raises(monkeypatch):
    """basenet_cross reads attention_c5/s5: a forward that skips its fusion
    gate leaves them without a gradient, and the step raises instead of
    training around the cut."""
    monkeypatch.setattr(tzoo, "_fuse_gate_c5s5",
                        lambda p, fuse, ops, mask: fuse)
    batch = {k: to_torch(a) for k, a in _batch().items()}
    v = get_variant("zoo:basenet_cross")
    step, _ = make_train_step(v, TrainConfig())
    p = v.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no gradient reached parameter "
                                           "'attention_c5"):
        step.value_and_grad(p, batch)
