"""The port's sharded training (`make_train_step(..., mesh=)`,
`codon_tpu_torch.parallel.train`) against the JAX package's sharded step
and the port's own single-device step; the cases of tests/test_train.py,
and the differentiable collectives under them.

The port's mesh is 8 gloo ranks on the CPU: this process is rank 0, one
`MeshPool` for the module. Weights are JAX's random init carried across
with `params_from_numpy`; inputs are numpy from a seed, JAX's
`_tiny_batch` shapes (B 2, H 16, W 16).

Tolerances, and why:
- the collectives' backward against autograd of the unsharded function
  (the halo rows, the all_sum, the masked global max with ties inside a
  shard and across shards): 1e-6 absolute in float32 (a halo row's
  gradient is two terms added in another order).
- one CAC stage on a shard (`CacStageFunction` over the sp group, the
  kernels' plain versions on the CPU) against the single-device
  `CacStageFunction`: each output and gradient within 1e-5 of its max
  (the pooled statistics summed shard by shard in float32).
- the step in float32: the loss within 1e-5 relative of JAX's sharded
  step and of the port's single step; every gradient leaf within 1e-5 of
  the leaf's max |g| (against `jax.grad` of JAX's single-device loss and
  the port's single step; the convs of a shard and the sums over ranks
  run in other orders); the parameters after one Adam step within JAX's
  atol 2e-4 / rtol 1e-3 (lr 1e-3 moves every element by about lr).
- QAT: JAX's bounds, loss relative 5e-3 and parameters atol 5e-3 / rtol
  1e-2 (a value within the sharded conv's float32 noise of a rounding
  boundary takes the neighbouring int8 code, tests/test_train.py); the
  gathered scale bitwise.
- replicas: bitwise equal on every rank of the mesh.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codon_tpu.quant_ops import _x_scale as jax_x_scale
from codon_tpu.train.trainer import TrainConfig as JaxConfig
from codon_tpu.train.trainer import make_train_step as jax_train_step

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.kernels import cac as kc
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import MeshPool
from codon_tpu_torch.parallel.launch import rank_counts, reset_rank_counts
from codon_tpu_torch.parallel.ops import (cac_stage_grads_on_shard,
                                          collective_grad_on_shard,
                                          shard_cotangent)
from codon_tpu_torch.parallel.quant import sample_scale_on_shard
from codon_tpu_torch.parallel.train import replica_digest
from codon_tpu_torch.train.trainer import (TrainConfig, make_train_step,
                                           tree_items)

from torch_port_common import (CKPT_DIR, cac_weights,  # noqa: F401
                               one_torch_thread, to_np, to_torch)

SHIP4 = os.path.join(CKPT_DIR, "x4_ship4.npz")
COLL_TOL = 1e-6
STAGE_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
P_ATOL, P_RTOL = 2e-4, 1e-3
QAT_LOSS_RTOL, QAT_ATOL, QAT_RTOL = 5e-3, 5e-3, 1e-2
LR = 1e-3


def _tiny_batch(rng, B=2, H=16, W=16):
    label = rng.rand(B, H, W, 1).astype(np.float32)
    return {
        "depth": np.clip(label + 0.1 * rng.randn(B, H, W, 1), 0, 1
                         ).astype(np.float32),
        "color": rng.rand(B, H, W, 1).astype(np.float32),
        "label": label,
        "mask": np.ones((B, H, W, 1), np.float32),
    }


def _torch_batch(b):
    return {k: to_torch(v) for k, v in b.items()}


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _grads_close(got, want, paths, tol=GRAD_TOL):
    for path, g, w in zip(paths, got, want):
        g, w = to_np(g), to_np(w)
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= bound, path


def _params_close(got, want, grads, atol=P_ATOL, rtol=P_RTOL):
    """got within atol / rtol of want, but where an element's reference
    gradient, at any of the steps (`grads`, one list of leaves a step),
    lies within GRAD_TOL of its leaf's max of zero: float32 does not fix
    its sign there, and Adam's first steps move it by about lr whatever
    its size, so it may land up to 2 lr a step apart."""
    steps = len(grads)
    for i, ((path, g), (_, w)) in enumerate(zip(tree_items(got),
                                                tree_items(want))):
        g, w = to_np(g), to_np(w)
        loose = np.zeros(w.shape, bool)
        for step_grads in grads:
            r = np.abs(to_np(step_grads[i]))
            loose |= r <= GRAD_TOL * r.max()
        bound = atol + rtol * np.abs(w)
        bound = np.where(loose, np.maximum(bound, atol + 2 * LR * steps),
                         bound)
        bad = int((np.abs(g - w) > bound).sum())
        assert bad == 0, (path, bad, float(np.abs(g - w).max()))


def _steps(v, cfg, params, batch, n=1, ops=None, mesh=None):
    """n steps from a copy of params -> (params, [metrics of each],
    [the gradient of each step, when on one device])."""
    step, opt = make_train_step(v, cfg, ops=ops, mesh=mesh)
    p = _copy(params)
    state = opt.init(p)
    ms, gs = [], []
    for _ in range(n):
        if mesh is None:
            gs.append(step.value_and_grad(p, batch)[1])
        p, state, m = step(p, state, batch)
        ms.append({k: float(x) for k, x in m.items()})
    return p, ms, gs


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    p = MeshPool(8, device="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def case():
    """tests/test_train.py's case: JAX's init from PRNGKey(1), the batch of
    RandomState(1), lr 1e-3; the port's single-device gradient."""
    jv = jax_variant("codon")
    jparams = jv.init(jax.random.PRNGKey(1))
    batch = _tiny_batch(np.random.RandomState(1))
    v = get_variant("codon")
    params = _port_params(jparams)
    tb = _torch_batch(batch)
    cfg = TrainConfig(learning_rate=LR)
    step, _ = make_train_step(v, cfg)
    loss, grads = step.value_and_grad(params, tb)
    return dict(jv=jv, jparams=jparams, batch=batch, v=v, params=params,
                tb=tb, cfg=cfg, loss=float(loss), grads=grads,
                paths=[p for p, _ in tree_items(params)])


# ---------------------------------------------------------------------------
# the collectives' backward
# ---------------------------------------------------------------------------

def _cotangents(shape, seed, dp, sp, block_b):
    """The cotangent of every shard's output, stacked by sp index: the
    images of dp row d at rows d * block_b."""
    return [torch.cat([shard_cotangent(shape, seed, d, s)
                       for d in range(dp)], 0) for s in range(sp)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("r", [1, 2])
def test_halo_rows_backward(pool, r, sp):
    """Each shard's halo rows differentiated for its own cotangent: the
    gradient equals autograd of the unsharded function (each shard's
    rows with r rows of the zero-padded image above and below)."""
    rng = np.random.RandomState(10 * r + sp)
    h = 3
    x = to_torch(rng.randn(2, sp * h, 5, 3).astype(np.float32))
    mask = torch.ones(2, sp * h, 5, 1)
    got = pool.shard_map(collective_grad_on_shard, pool.mesh(1, sp), x,
                         mask, consts=("halo_rows", r, 7))
    xr = x.clone().requires_grad_(True)
    padded = torch.nn.functional.pad(xr, (0, 0, 0, 0, r, r))
    gs = _cotangents((2, h + 2 * r, 5, 3), 7, 1, sp, 2)
    total = sum((padded[:, s * h:s * h + h + 2 * r] * gs[s]).sum()
                for s in range(sp))
    want, = torch.autograd.grad(total, xr)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=COLL_TOL,
                               rtol=0)


def test_all_sum_backward(pool):
    """all_sum over 4 shards: each shard's gradient is the sum of every
    shard's cotangent, as autograd of the unsharded sum gives it."""
    rng = np.random.RandomState(5)
    x = to_torch(rng.randn(2, 8, 3, 4).astype(np.float32))
    mask = torch.ones(2, 8, 3, 1)
    got = pool.shard_map(collective_grad_on_shard, pool.mesh(1, 4), x, mask,
                         consts=("all_sum", 0, 3))
    xr = x.clone().requires_grad_(True)
    parts = xr.split(2, 1)
    y = sum(parts)
    gs = _cotangents((2, 2, 3, 4), 3, 1, 4, 2)
    want, = torch.autograd.grad(sum((y * g).sum() for g in gs), xr)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=COLL_TOL,
                               rtol=0)


@pytest.mark.parametrize("ties", ["in_shard", "across_shards", "masked"])
def test_global_max_backward(pool, ties):
    """The masked global max over a 2 x 4 mesh: the gradient equals the
    unsharded `amax`'s, split evenly among the tied maxima whether they
    lie in one shard or in several (where JAX's all_gather + max splits
    per shard first), and nothing reaches a masked pixel."""
    rng = np.random.RandomState({"in_shard": 1, "across_shards": 2,
                                 "masked": 3}[ties])
    B, H, W, C = 2, 16, 5, 3
    x = rng.rand(B, H, W, C).astype(np.float32)
    mask = np.ones((B, H, W, 1), np.float32)
    top = np.float32(2.0)
    if ties == "in_shard":
        x[0, 1, 1, :] = x[0, 2, 3, :] = top           # both in shard 0
        x[1, 13, 0, 1] = x[1, 14, 4, 1] = top         # both in shard 3
    elif ties == "across_shards":
        x[0, 1, 1, :] = x[0, 6, 2, :] = x[0, 13, 4, :] = top
        x[1, 3, 0, 2] = x[1, 12, 0, 2] = top
    else:
        mask[0, 4:8] = 0.0                            # shard 1 all masked
        mask[1, :, 3:] = 0.0
        x[0, 5, 1, :] = 9.0                           # masked, larger
        x[1, 2, 4, :] = 9.0
        x[0, 1, 1, :] = x[0, 10, 2, :] = top
    xt, mt = to_torch(x), to_torch(mask)
    got = pool.shard_map(collective_grad_on_shard, pool.mesh(2, 4), xt, mt,
                         consts=("global_max", 0, 11))
    xr = xt.clone().requires_grad_(True)
    y = xr.masked_fill(mt == 0, float("-inf")).amax(dim=(1, 2),
                                                    keepdim=True)
    gs = _cotangents((1, 1, 1, C), 11, 2, 4, 1)
    want, = torch.autograd.grad(sum((y * g).sum() for g in gs), xr)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=COLL_TOL,
                               rtol=0)
    assert float(to_np(got)[to_np(mt)[..., 0] == 0].max(initial=0)) == 0


def test_collectives_without_gradient_refuse_a_graph(pool):
    """all_max and the point-to-point ops have no backward: handed a
    tensor that requires grad they raise before any rank is asked, never
    a silently wrong gradient (`_gathered_sample_scale` hands its all_max
    a detached tensor: the dynamic QAT step below runs it under
    autograd)."""
    from codon_tpu_torch.parallel import comm
    mesh = pool.mesh(1, 2)
    x = torch.ones(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="all_max has no gradient"):
        comm.all_max(x, mesh.sp_group)
    with pytest.raises(RuntimeError, match=r"p2p \(scatter\) has no"):
        comm.p2p("scatter", [(x, 1)], [])
    assert not pool.closed


# ---------------------------------------------------------------------------
# the CAC stage on a shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_stage_function_matches_single(pool, sp, masked):
    """`CacStageFunction` over the sp group (the kernels' plain versions
    on the CPU) against the single-device `CacStageFunction` on the whole
    tensors, the same cotangents: the outputs, the four towers' gradients
    and the weights' gradients summed over the shards."""
    rng = np.random.RandomState(20 + sp)
    N, H, W, C = 2, 16, 11, 64
    mask = np.ones((N, H, W, 1), np.float32)
    if masked:
        mask[1, 7:] = 0.0
        mask[1, :, 8:] = 0.0
    towers = [to_torch(rng.randn(N, H, W, C).astype(np.float32) * mask)
              for _ in range(4)]
    gs = [to_torch(rng.randn(N, H, W, C).astype(np.float32))
          for _ in range(2)]
    ws = [to_torch(w) for w in cac_weights(3)]
    m = to_torch(mask)
    got = pool.shard_map(cac_stage_grads_on_shard, pool.mesh(1, sp),
                         *towers, m, *gs, consts=tuple(ws))
    xs = [t.clone().requires_grad_(True) for t in towers + ws]
    new = kc.CacStageFunction.apply(*xs, m)
    grads = torch.autograd.grad(new, xs, gs)
    want = (*new, *grads[:4], torch.cat([g.reshape(-1) for g in grads[4:]]))
    got = (*got[:6], got[6][0, 0])
    for g, w in zip(got, want):
        g, w = to_np(g), to_np(w)
        assert np.abs(g - w).max() <= STAGE_TOL * np.abs(w).max()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def matches_jax_sharded(pool, jv, v, jparams, batch, form=(2, 4),
                        ops=None, jops=None, grad_class=None):
    """The port's sharded step over `form` against JAX's over the same
    mesh, from JAX's parameters `jparams` and the numpy `batch`: the loss
    against JAX's sharded step, the summed gradient against `jax.grad` of
    JAX's single-device loss, and the parameters after one step against
    JAX's sharded step's. grad_class (tree L2, per leaf): hold the
    gradient in that class instead, and leave the parameters to the
    caller, for a net whose single-device gradients already differ
    between the packages. -> the port's (loss, gradient leaves)."""
    jcfg = JaxConfig(learning_rate=LR)
    jstep, jtx = jax_train_step(jv, jcfg, mesh=jax_make_mesh(list(form)),
                                donate=False, ops=jops)
    jp, _, jm = jstep(jparams, jtx.init(jparams), batch)

    def jloss(p, b):
        out = jv.forward(p, b["depth"], b["color"], mask=b["mask"],
                         ops=jops)
        return jnp.sum(jnp.abs((out - b["label"]) * b["mask"])) / jnp.sum(
            b["mask"])

    jl, jg = jax.value_and_grad(jloss)(jparams, batch)
    params, tb = _port_params(jparams), _torch_batch(batch)
    cfg = TrainConfig(learning_rate=LR)
    mesh = pool.mesh(*form)
    step, _ = make_train_step(v, cfg, mesh=mesh, ops=ops)
    loss, grads = step.value_and_grad(params, tb)
    assert abs(float(loss) - float(jm["loss"])) <= LOSS_RTOL * abs(
        float(jm["loss"]))
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    jgrads = [t for _, t in tree_items(_port_params(jg))]
    paths = [p for p, _ in tree_items(params)]
    if grad_class is not None:
        _grads_in_class(grads, jgrads, paths, *grad_class)
        return loss, grads
    _grads_close(grads, jgrads, paths)
    p, ms, _ = _steps(v, cfg, params, tb, mesh=mesh, ops=ops)
    assert abs(ms[0]["loss"] - float(jm["loss"])) <= LOSS_RTOL * abs(
        float(jm["loss"]))
    _params_close(p, _port_params(jp), [jgrads])
    return loss, grads


def _grads_in_class(got, want, paths, tree_l2, leaf_tol):
    """The gradient tree within `tree_l2` relative L2 distance of want's,
    and each leaf within `leaf_tol` of its max |g|."""
    num = den = 0.0
    for path, g, w in zip(paths, got, want):
        g, w = to_np(g), to_np(w)
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
        assert np.abs(g - w).max() <= leaf_tol * max(np.abs(w).max(),
                                                     1e-30), path
    assert (num / den) ** 0.5 <= tree_l2


def test_sharded_step_matches_jax(pool, case):
    """tests/test_train.py::test_sharded_step_matches_single over the
    port's 2 x 4 mesh: the loss against JAX's sharded step, the summed
    gradient against `jax.grad` of JAX's single-device loss, and the
    parameters after the step against JAX's sharded step's."""
    c = case
    matches_jax_sharded(pool, c["jv"], c["v"], c["jparams"], c["batch"])


def test_sharded_fused_step_matches_jax(pool, case):
    """codon_fused over the 2 x 4 mesh (the kernel stage on the halves of
    T, `CacStageFunction` over the sp group, the kernels' plain versions
    here) against JAX's sharded codon_forward_fused step, and its loss
    and gradients against the port's single-device codon step."""
    c = case
    fused = get_variant("codon_fused")
    v = dataclasses.replace(fused, cfg=dataclasses.replace(
        fused.cfg, cac_impl="kernel"))
    reset_rank_counts()
    loss, grads = matches_jax_sharded(pool, jax_variant("codon_fused"), v,
                                      c["jparams"], c["batch"])
    assert kc.stage_calls()["shard"] > 0
    assert abs(float(loss) - c["loss"]) <= LOSS_RTOL * abs(c["loss"])
    _grads_close(grads, c["grads"], c["paths"])


@pytest.mark.parametrize("form", [(2, 1), (1, 4), (2, 2)],
                         ids=lambda f: f"{f[0]}x{f[1]}")
def test_sharded_step_matches_port_single(pool, case, form):
    c = case
    mesh = pool.mesh(*form)
    step, _ = make_train_step(c["v"], c["cfg"], mesh=mesh)
    loss, grads = step.value_and_grad(c["params"], c["tb"])
    assert abs(float(loss) - c["loss"]) <= LOSS_RTOL * abs(c["loss"])
    _grads_close(grads, c["grads"], c["paths"])
    p, _, _ = _steps(c["v"], c["cfg"], c["params"], c["tb"], mesh=mesh)
    want, _, wgs = _steps(c["v"], c["cfg"], c["params"], c["tb"])
    _params_close(p, want, wgs)


LOSS_CASES = {
    # pairs along H across the seams of a 2 x 2 mesh (rows 7 | 8) with
    # mask zeros on both sides of one, and a row of zeros right below it
    "grad_weight": dict(loss="l1", grad_weight=0.7),
    "l2": dict(loss="l2"),
    # a norm above the clip, so the clip acts (the gradient's norm here is
    # ~40)
    "clip_norm": dict(loss="l1", clip_norm=0.5),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_variants_match_port_single(pool, case, name):
    """The masked grad_weight case runs on x4_ship4's trained weights: at
    random init a masked batch moves the single-device gradient itself by
    up to 7.5e-4 of a leaf's max between one batch of 2 and two batches
    of 1 (ReLUs that flip on one side only, as tests/test_torch_train.py
    finds), far above the sharding's own float32 noise."""
    c = case
    tb, params = dict(c["tb"]), c["params"]
    if name == "grad_weight":
        m = tb["mask"].clone()
        m[0, 6:10, 3:9] = 0.0
        m[1, 8] = 0.0
        tb["mask"] = m
        params = params_from_numpy(load_npz(SHIP4), "cpu")
    cfg = TrainConfig(learning_rate=LR, **LOSS_CASES[name])
    single, _ = make_train_step(c["v"], cfg)
    want_loss, want_grads = single.value_and_grad(params, tb)
    step, _ = make_train_step(c["v"], cfg, mesh=pool.mesh(2, 2))
    loss, grads = step.value_and_grad(params, tb)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    _grads_close(grads, want_grads, c["paths"])
    p, ms, _ = _steps(c["v"], cfg, params, tb, mesh=pool.mesh(2, 2))
    want, wms, wgs = _steps(c["v"], cfg, params, tb)
    assert abs(ms[0]["grad_norm"] - wms[0]["grad_norm"]) <= 1e-5 * abs(
        wms[0]["grad_norm"])
    _params_close(p, want, wgs)


def test_two_steps_and_replicas(pool, case):
    """Two sharded steps in a row: each equals the single-device step from
    the same parameters and optimizer state (after the first step the two
    runs would differ where Adam's first update took an undetermined
    sign), and every rank's replica, parameters and optimizer state, is
    bitwise rank 0's, whose parameters are the caller's own tensors,
    updated in place."""
    c = case
    mesh = pool.mesh(2, 2)
    step, opt = make_train_step(c["v"], c["cfg"], mesh=mesh)
    single, _ = make_train_step(c["v"], c["cfg"])
    p = _copy(c["params"])
    leaf = p["conv1"]
    state = opt.init(p)
    for _ in range(2):
        ref = _copy(p)
        ref_state = dict(state, mu=_copy(state["mu"]), nu=_copy(state["nu"]))
        ref_grads = single.value_and_grad(ref, c["tb"])[1]
        ref, ref_state, ref_m = single(ref, ref_state, c["tb"])
        p2, state, m = step(p, state, c["tb"])
        assert p2 is p
        assert abs(float(m["loss"]) - float(ref_m["loss"])) <= (
            LOSS_RTOL * abs(float(ref_m["loss"])))
        _params_close(p, ref, [ref_grads])
    assert p["conv1"] is leaf and state["count"] == 2
    digests = pool.call(replica_digest, step.slot)[:mesh.size]
    assert len(set(digests)) == 1


def test_whole_image_stage_never_runs_on_a_shard(pool, case):
    """With the CAC stage through the kernels (their plain versions on the
    CPU), a 2 x 4 step calls the stage 5 times on every rank, each over
    its sp group, and never on whole images; the collectives a rank calls
    in one step, forward and backward."""
    c = case
    v = dataclasses.replace(c["v"], cfg=dataclasses.replace(
        c["v"].cfg, cac_impl="kernel"))
    mesh = pool.mesh(2, 4)
    step, _ = make_train_step(v, c["cfg"], mesh=mesh)
    pool.call(reset_rank_counts)
    loss, grads = step.value_and_grad(c["params"], c["tb"])
    counts = pool.call(rank_counts)
    for rank, cnt in enumerate(counts):
        calls = {k: x["calls"] for k, x in cnt["comm"].items()}
        assert cnt["stages"] == {"whole": 0, "shard": 5}, rank
        # 33 halo convs and the 5 kernel stages' pooled maps forward, the
        # 5 recomputed stages' maps in the backward; the backward skips
        # the 2 stems' first convs, whose input needs no gradient.
        # all_sum: the stages' statistics, their recomputes' 2 pools, the
        # loss's counts and the gradient buffer
        assert calls == {"halo_rows": 43, "halo_rows_grad": 36,
                         "all_sum": 17, "all_sum_grad": 10, "all_max": 15,
                         "all_max_grad": 10, "scatter": 1,
                         "gather": 0}, (rank, calls)
    assert abs(float(loss) - c["loss"]) <= LOSS_RTOL * abs(c["loss"])
    _grads_close(grads, c["grads"], c["paths"])


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

def test_sharded_qat_scale_collective_exact(pool):
    """tests/test_train.py's invariant: the per-sample scale gathered over
    4 shards equals the untiled `_x_scale` (the port's and JAX's)
    bitwise."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 16, 8, 32).astype(np.float32)
    got = pool.shard_map(sample_scale_on_shard, pool.mesh(1, 4),
                         to_torch(x))
    want = tq._x_scale(to_torch(x)).float()
    for s in range(4):
        assert torch.equal(got[:, s:s + 1], want)
    assert np.array_equal(to_np(want), np.asarray(jax_x_scale(jnp.asarray(
        x))))


@pytest.fixture(scope="module")
def qat_case():
    """tests/test_train.py's QAT case: JAX's init from PRNGKey(2), the
    batch of RandomState(2), static scales calibrated on it."""
    params = _port_params(jax_variant("codon").init(jax.random.PRNGKey(2)))
    tb = _torch_batch(_tiny_batch(np.random.RandomState(2)))
    v = get_variant("codon")
    scales = tq.calibrate_act_scales(
        lambda p, d, c, ops, mask: v.forward(p, d, c, ops=ops, mask=mask),
        params, [(tb["depth"], tb["color"], tb["mask"])])
    return v, params, tb, scales


@pytest.mark.parametrize("kind", ["fake_quant", "fake_quant_static"])
def test_sharded_qat_step_matches_single(pool, qat_case, kind):
    v, params, tb, scales = qat_case
    ops = (tq.FakeQuantOps() if kind == "fake_quant"
           else tq.FakeQuantStaticOps(scales))
    cfg = TrainConfig(learning_rate=LR)
    p1, m1, g1 = _steps(v, cfg, params, tb, ops=ops)
    pn, mn, _ = _steps(v, cfg, params, tb, ops=ops, mesh=pool.mesh(2, 4))
    l1, ln = m1[0]["loss"], mn[0]["loss"]
    assert abs(l1 - ln) / abs(l1) < QAT_LOSS_RTOL, (l1, ln)
    _params_close(pn, p1, g1, QAT_ATOL, QAT_RTOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_sharded_step_refuses_what_it_cannot_run(pool, case):
    """A backend without a sharded twin and shapes the mesh does not
    divide each raise before a rank is asked; the pool stays usable. The
    zoo trains: its sharded loss is the single-device loss."""
    c = case
    mesh = pool.mesh(2, 4)
    with pytest.raises(NotImplementedError,
                       match="no sharded twin for ops backend Int8Ops"):
        make_train_step(c["v"], c["cfg"], ops=tq.Int8Ops(), mesh=mesh)
    # the zoo trains under a mesh (tests/test_torch_parallel_zoo_train.py)
    zv = get_variant("zoo:basenet")
    zp = zv.init(torch.Generator().manual_seed(0), device="cpu")
    zloss = make_train_step(zv, c["cfg"])[0].value_and_grad(zp, c["tb"])[0]
    zmesh = make_train_step(zv, c["cfg"], mesh=mesh)[0]
    assert abs(float(zmesh.value_and_grad(zp, c["tb"])[0]) - float(zloss)) \
        <= LOSS_RTOL * abs(float(zloss))
    step, opt = make_train_step(c["v"], c["cfg"], mesh=mesh)
    odd = {k: t[:1] for k, t in c["tb"].items()}
    with pytest.raises(ValueError, match="must divide"):
        step.value_and_grad(c["params"], odd)
    short = {k: t[:, :14] for k, t in c["tb"].items()}
    with pytest.raises(ValueError, match="must divide"):
        step.value_and_grad(c["params"], short)
    thin = make_train_step(c["v"], c["cfg"], mesh=pool.mesh(1, 8))[0]
    with pytest.raises(ValueError, match="leaves 1 row"):
        thin.value_and_grad(c["params"],
                            {k: t[:, :8] for k, t in c["tb"].items()})
    assert not pool.closed
    loss, _ = step.value_and_grad(c["params"], c["tb"])
    assert abs(float(loss) - c["loss"]) <= LOSS_RTOL * abs(c["loss"])
