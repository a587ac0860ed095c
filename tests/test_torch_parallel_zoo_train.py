"""Sharded training of the ablation zoo (`make_train_step(zoo variant,
mesh=)`) against the JAX package's sharded step and the port's own
single-device step, over 8 gloo ranks of the CPU (this process rank 0,
one `MeshPool` for the module).

The nets are the three the card's zoo mesh phase trains:
`zoo:basenet_nlar` (CGNL's global sums), `zoo:rmcr_fuse_rmcr_rcan` (RCAN's
pooled gates) and `zoo:rmcr_fuse_rmcr_eccv` (CBAM towers), each from
JAX's own `zoo_init` (PRNGKey(0)), on tests/test_torch_parallel_zoo.py's
inputs (B 2, H 16, W 12, image 1 masked in its last rows and columns)
with a label from the same seed.

Tolerances, and why: tests/test_torch_parallel_train.py's. The loss
within 1e-5 relative of JAX's sharded step; every gradient leaf within
1e-5 of the leaf's max |g| of `jax.grad` of JAX's single-device loss
(the leaves no forward reads, zero on both sides); the parameters after
one Adam step within JAX's atol 2e-4 / rtol 1e-3. Against the port's own
single-device step, 2e-5 of each leaf's max: both are within 1e-5 of
JAX's (they read 1.06e-5 apart on rmcr_fuse_rmcr_rcan's RCAN gate bias,
each on its side of JAX's, 3.2e-6 and 9.0e-6 from it).

zoo:rmcr_fuse_rmcr_eccv is the exception on the JAX side: at this input
the port's single-device gradient already differs from JAX's by 1.8e-3
of conv2's max |g|, while each package's sharded gradient stays within
1.2e-5 of its own single-device one. The cause is one ReLU: of the 65
ReLUs of its forward, the two packages decide alike on every element but
one, element (1, 0, 0, 53) of the 46th, whose pre-activation is
+3.2e-9 in the port and -2.8e-9 in JAX, 7.8e-9 of that activation's max
(`test_eccv_gradient_gap_is_one_relu_tie`). With that one decision
taken JAX's way the port's gradient comes within 1.6e-5 of JAX's, on a
ChannelGate leaf (2e-5 held there): still above the 1e-5 the other two
nets meet. Both gaps are float32 rounding of the convs' sums: with every
op of both packages in float64 the gradients agree to ~1e-14 of each
leaf's max, here and at a second seed
(`test_eccv_gradient_in_float64_matches_jax`), and with only the port's
convs summed in float64 its float32 gradient comes within 3.4e-6 of
JAX's, no ReLU patched (`test_eccv_gradient_gap_is_conv_rounding`).
PyTorch's CPU convs and XLA's sum in other orders, so the 1e-5 bound
cannot hold for this net in float32: at a second and a third seed its
gradients read 1.0e-5 and 4.9e-3 apart (at the third it is JAX's
float32 gradient that lies 4.9e-3 from the float64 one, the port's
8.6e-6). Its sharded gradient is held
against JAX's in the zoo's gradient class of tests/test_torch_zoo_
unrolled.py (tree L2 2e-3, per leaf 0.1) and, with the parameters after
a step, against the port's own single step at the bounds above.

QAT (FakeQuantOps): JAX's flip class, loss relative 5e-3 and parameters
atol 5e-3 / rtol 1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu import quant_ops as jq
from codon_tpu.core.params import DTypePolicy as JaxPolicy
from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codon_tpu.train.trainer import TrainConfig as JaxConfig
from codon_tpu.train.trainer import make_train_step as jax_train_step

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.core import ops as core_ops
from codon_tpu_torch.core.params import DTypePolicy
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import MeshPool
from codon_tpu_torch.parallel.launch import rank_counts, reset_rank_counts
from codon_tpu_torch.parallel.train import replica_digest
from codon_tpu_torch.train.trainer import (TrainConfig, make_train_step,
                                           top_name, tree_items)

from test_torch_parallel_train import (GRAD_TOL, LOSS_RTOL, LR, QAT_ATOL,
                                       QAT_LOSS_RTOL, QAT_RTOL, _copy,
                                       _grads_close, _params_close,
                                       _port_params, _steps, _torch_batch,
                                       matches_jax_sharded)
from test_torch_parallel_zoo import jax_params, zoo_inputs
from torch_port_common import one_torch_thread, to_torch  # noqa: F401

NETS = ["basenet_nlar", "rmcr_fuse_rmcr_rcan", "rmcr_fuse_rmcr_eccv"]
# net -> the class its gradient is held in against JAX's (module doc)
GRAD_CLASS = {"rmcr_fuse_rmcr_eccv": (2e-3, 0.1)}
SINGLE_GRAD_TOL = 2e-5
# both packages in float64 (test_eccv_gradient_in_float64_matches_jax):
# they read ~1e-14 of a leaf's max apart
F64_GRAD_TOL = 1e-12


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    p = MeshPool(8, device="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def batch():
    d, c, m = zoo_inputs()
    label = np.random.RandomState(1).rand(*m.shape).astype(np.float32) * m
    return {"depth": d, "color": c, "label": label, "mask": m}


@pytest.mark.parametrize("name", NETS)
def test_zoo_sharded_step_matches_jax(pool, batch, name):
    """At 2 x 4 against JAX's sharded step, and against the port's single
    step; the unread leaves get zeros; no rank runs the CAC stage."""
    v = get_variant("zoo:" + name)
    jp = jax_params(name)
    pool.call(reset_rank_counts)
    loss, grads = matches_jax_sharded(pool, jax_variant("zoo:" + name), v,
                                      jp, batch,
                                      grad_class=GRAD_CLASS.get(name))
    for c in pool.call(rank_counts):
        assert c["stages"] == {"whole": 0, "shard": 0}
    cfg = TrainConfig(learning_rate=LR)
    params, tb = _port_params(jp), _torch_batch(batch)
    want_loss, want = make_train_step(v, cfg)[0].value_and_grad(params, tb)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    paths = [p for p, _ in tree_items(params)]
    _grads_close(grads, want, paths, SINGLE_GRAD_TOL)
    for path, g in zip(paths, grads):
        if top_name(path) in v.unread:
            assert not bool(g.any()), path
    if name in GRAD_CLASS:
        p, _, _ = _steps(v, cfg, params, tb, mesh=pool.mesh(2, 4))
        single, _, wgs = _steps(v, cfg, params, tb)
        _params_close(p, single, wgs)


def test_zoo_replicas_after_two_steps(pool, batch):
    """Two steps at 2 x 2: each rank's replica bitwise rank 0's."""
    v = get_variant("zoo:rmcr_fuse_rmcr_rcan")
    params = _port_params(jax_params("rmcr_fuse_rmcr_rcan"))
    mesh = pool.mesh(2, 2)
    step, opt = make_train_step(v, TrainConfig(learning_rate=LR), mesh=mesh)
    p = _copy(params)
    state = opt.init(p)
    for _ in range(2):
        p, state, m = step(p, state, _torch_batch(batch))
        assert np.isfinite(float(m["loss"]))
    digests = pool.call(replica_digest, step.slot)[:mesh.size]
    assert len(set(digests)) == 1


def test_zoo_fake_quant_step_matches_jax(pool, batch):
    """QAT of zoo:basenet_nlar (FakeQuantOps, its sharded twin on each
    rank) at 2 x 4 against JAX's sharded QAT step, in the flip class, and
    against the port's single-device QAT step."""
    name = "basenet_nlar"
    jv = jax_variant("zoo:" + name)
    jp = jax_params(name)
    jstep, jtx = jax_train_step(jv, JaxConfig(learning_rate=LR),
                                mesh=jax_make_mesh([2, 4]), donate=False,
                                ops=jq.FakeQuantOps())
    jpar, _, jm = jstep(jp, jtx.init(jp), batch)
    v = get_variant("zoo:" + name)
    cfg = TrainConfig(learning_rate=LR)
    params, tb = _port_params(jp), _torch_batch(batch)
    p, ms, _ = _steps(v, cfg, params, tb, ops=tq.FakeQuantOps(),
                      mesh=pool.mesh(2, 4))
    assert abs(ms[0]["loss"] - float(jm["loss"])) <= QAT_LOSS_RTOL * abs(
        float(jm["loss"]))
    want, wms, wgs = _steps(v, cfg, params, tb, ops=tq.FakeQuantOps())
    assert abs(ms[0]["loss"] - wms[0]["loss"]) <= QAT_LOSS_RTOL * abs(
        wms[0]["loss"])
    _params_close(p, _port_params(jpar), wgs, QAT_ATOL, QAT_RTOL)
    _params_close(p, want, wgs, QAT_ATOL, QAT_RTOL)


def _jax_grads(jv, jp, batch, dtype=torch.float32):
    """`jax.grad` of the trainer's masked L1 loss -> the leaves in the
    port's tree order, as tensors of `dtype`."""
    def jloss(p, b):
        out = jv.forward(p, b["depth"], b["color"], mask=b["mask"])
        return jnp.sum(jnp.abs((out - b["label"]) * b["mask"])) / jnp.sum(
            b["mask"])
    grads = jax.tree.map(np.asarray, jax.grad(jloss)(jp, batch))
    return [t for _, t in tree_items(params_from_numpy(grads, "cpu",
                                                       dtype=dtype))]


def _eccv_case(seed):
    """The module's input (seed 0) or another: JAX's init from
    PRNGKey(seed), zoo_inputs(seed), a label from seed + 1."""
    d, c, m = zoo_inputs(seed)
    label = np.random.RandomState(1 + seed).rand(*m.shape).astype(
        np.float32) * m
    return (jax_params("rmcr_fuse_rmcr_eccv", seed),
            {"depth": d, "color": c, "label": label, "mask": m})


def _port_grads(v, params, batch):
    """The port's gradient of the trainer's loss at `params` (any float
    dtype; the batch is cast to it)."""
    dt = next(iter(tree_items(params)))[1].dtype
    tb = {k: to_torch(x).to(dt) for k, x in batch.items()}
    leaves = [t.requires_grad_(True) for _, t in tree_items(params)]
    with torch.enable_grad():
        out = v.train_forward(params, tb["depth"], tb["color"],
                              mask=tb["mask"])
        loss = ((out - tb["label"]) * tb["mask"]).abs().sum() / \
            tb["mask"].sum()
        return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("seed", [0, 1])
def test_eccv_gradient_in_float64_matches_jax(seed):
    """With every op of both packages in float64 (JAX under
    `jax.enable_x64`, scoped to this test), rmcr_fuse_rmcr_eccv's
    gradient equals `jax.grad`'s within F64_GRAD_TOL of each leaf's max,
    at the module's input and at a second seed: the float32 gaps of the
    tests above are rounding, not another function."""
    name = "rmcr_fuse_rmcr_eccv"
    jp, batch = _eccv_case(seed)
    with jax.enable_x64(True):
        jpol = JaxPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                         acc_dtype=jnp.float64, precision="highest")
        want = _jax_grads(
            jax_variant("zoo:" + name, dtypes=jpol),
            jax.tree.map(lambda x: np.asarray(x, np.float64), jp),
            {k: x.astype(np.float64) for k, x in batch.items()},
            torch.float64)
    v = get_variant("zoo:" + name, dtypes=DTypePolicy(
        param_dtype=torch.float64, compute_dtype=torch.float64))
    params = params_from_numpy(jp, "cpu", dtype=torch.float64)
    got = _port_grads(v, params, batch)
    for (path, _), g, w in zip(tree_items(params), got, want):
        # in float64: _grads_close compares in float32
        assert float((g - w).abs().max()) <= F64_GRAD_TOL * float(
            w.abs().max()), path


def test_eccv_gradient_gap_is_conv_rounding(monkeypatch, batch):
    """The second cause, and the first's source. With the port's convs
    summed in float64 and rounded back to float32 (every other op of the
    port still in float32), its gradient at the module's input comes
    within GRAD_TOL (1e-5) of `jax.grad`'s float32 one, with no ReLU
    decision patched: the ReLU tie of the test below and the 1.6e-5
    ChannelGate residual both come from the convs' float32 accumulation
    order (PyTorch's CPU convs against XLA's), which neither package
    fixes. Without the change the gap is over 100 GRAD_TOL."""
    name = "rmcr_fuse_rmcr_eccv"
    jp = jax_params(name)
    v = get_variant("zoo:" + name)
    want = _jax_grads(jax_variant("zoo:" + name), jp, batch)
    paths = [p for p, _ in tree_items(_port_params(jp))]
    plain = _port_grads(v, _port_params(jp), batch)
    worst = max(float((g - w).abs().max()) / float(w.abs().max())
                for g, w in zip(plain, want) if bool(w.any()))
    assert worst > 100 * GRAD_TOL
    real = core_ops.conv2d_nhwc

    def conv_in_float64(x, w, groups=1, halo=0):
        return real(x.double(), w.double(), groups, halo).to(x.dtype)
    monkeypatch.setattr(core_ops, "conv2d_nhwc", conv_in_float64)
    _grads_close(_port_grads(v, _port_params(jp), batch), want, paths)


def test_eccv_gradient_gap_is_one_relu_tie(monkeypatch, batch):
    """rmcr_fuse_rmcr_eccv's single-device gradient against `jax.grad`
    at the module's input: the two forwards' ReLUs differ in one decision
    only, on a pre-activation within 1e-7 of its activation's max of zero
    on both sides; taking that decision JAX's way brings the port's
    gradient within SINGLE_GRAD_TOL of each leaf's max of JAX's."""
    name = "rmcr_fuse_rmcr_eccv"
    jp = jax_params(name)
    jv, v = jax_variant("zoo:" + name), get_variant("zoo:" + name)
    params, tb = _port_params(jp), _torch_batch(batch)
    seen = {"jax": [], "port": []}
    real_j, real_t = jax.nn.relu, torch.relu
    monkeypatch.setattr(jax.nn, "relu", lambda x: seen["jax"].append(
        np.asarray(x)) or real_j(x))
    jv.forward(jp, batch["depth"], batch["color"],
               mask=jnp.asarray(batch["mask"]))
    monkeypatch.setattr(torch, "relu", lambda x: seen["port"].append(
        x.detach().numpy().copy()) or real_t(x))
    with torch.enable_grad():
        v.train_forward(params, tb["depth"], tb["color"], mask=tb["mask"])
    monkeypatch.undo()
    assert len(seen["jax"]) == len(seen["port"]) == 65
    split = [(i, idx) for i, (a, b) in enumerate(zip(seen["jax"],
                                                     seen["port"]))
             for idx in zip(*np.nonzero((a > 0) != (b > 0)))]
    assert len(split) == 1
    call, idx = split[0]
    for x in (seen["jax"][call], seen["port"][call]):
        assert abs(float(x[idx])) <= 1e-7 * float(np.abs(x).max())
    assert seen["port"][call][idx] > 0 >= seen["jax"][call][idx]

    jgrads = _jax_grads(jv, jp, batch)
    n = [0]

    def relu_as_jax(x):
        # the split element's pre-activation is positive in the port: block
        # its gradient there, as JAX's non-positive one does
        y = real_t(x)
        if n[0] == call:
            keep = torch.ones_like(x)
            keep[idx] = 0.0
            y = y * keep + (y * (1 - keep)).detach()
        n[0] += 1
        return y
    step = make_train_step(v, TrainConfig(learning_rate=LR))[0]
    paths = [p for p, _ in tree_items(params)]
    _, grads = step.value_and_grad(params, tb)
    worst = max(float((g - w).abs().max()) / float(w.abs().max())
                for g, w in zip(grads, jgrads) if bool(w.any()))
    assert worst > 100 * GRAD_TOL
    monkeypatch.setattr(torch, "relu", relu_as_jax)
    _, grads = step.value_and_grad(params, tb)
    monkeypatch.undo()
    assert n[0] == 65
    _grads_close(grads, jgrads, paths, SINGLE_GRAD_TOL)
