"""The port's trainer (`codon_tpu_torch.train.trainer`), its CAC autograd
function and its checkpoint manager, against `codon_tpu` on the CPU.

Tolerances, and why:
- loss and gradients, full-width `codon` in float32 on a 2 x 16 x 16 batch,
  the same parameters and batch on both sides: the loss within rtol 1e-5
  and every gradient leaf within 1e-4 of the leaf's max |g| (the convs and
  reductions sum in other orders; the runs here read <= 1e-6). The same
  bounds hold the trained-weight cases (x4_ship4.npz at 17 x 15, masked:
  `codon` at batch 1, `rmcr_fuse_rmcr`, `codon_sc`), which read <= 2.6e-6;
  at random init those variants differ by up to 9e-4 from ReLUs that flip
  on one side only.
- the fake-quant backends, site by site: each conv site and handoff of a
  recorded JAX forward, given JAX's input, weight and a cotangent: value
  and both gradients within 1e-5 of their max (the same int8 codes from
  the same input; float32 sums in other orders; they read <= 1e-6).
- the fake-quant backends, the whole model: a value within float32 noise
  of a rounding boundary takes the neighbouring int8 code on one side
  only, and the flip cascades through the stages. JAX against itself with
  its parameters moved by 1e-6 N(0, 1) relative (seeds 0-2) reads: loss
  0.05-0.8% apart; the gradient tree's relative L2 distance 0.13-0.20;
  per leaf up to 0.33-0.55 of the leaf's max |g|. The bounds hold the
  port in that class: loss rtol 0.02, tree L2 0.3, per leaf 0.6 (the port
  reads 0.4% / 0.11-0.18 / 0.23-0.43).
- the optimizer, fed the same gradient trees as optax's chain for 10
  steps: parameters within 1e-6 absolute (they read <= 6e-8: float32
  rounding of the schedule and of Adam's bias correction).
- codon_fused's training forward against JAX's codon_forward_fused and
  the port's codon: the float32 bounds above (it reads <= 1e-6).
- CacStageFunction's gradients are autograd of the plain stage at the same
  inputs: equal bitwise; its forward is the kernels' plain versions, within
  1e-5 of the plain stage in float32.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from codon_tpu import quant_ops as jq
from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.models.codon_net import widen_stem_params as jax_widen
from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.train.trainer import TrainConfig as JaxConfig
from codon_tpu.train.trainer import make_optimizer as jax_optimizer
from codon_tpu.train.trainer import make_train_step as jax_train_step

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.manager import CheckpointManager
from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.kernels import cac as kc
from codon_tpu_torch.models import codon_net
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.train import trainer
from codon_tpu_torch.train.trainer import (CollapseDetector, TrainConfig,
                                           make_optimizer, make_train_step,
                                           tree_items)

from torch_port_common import (CKPT_DIR, cac_mask, cac_towers, cac_weights,
                               one_torch_thread, to_np, to_torch)  # noqa: F401
from test_torch_imports import _card_files, _imported_roots

STATIC = os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
SITE_TOL = 1e-5
QAT_LOSS_RTOL, QAT_TREE_L2, QAT_GRAD_TOL = 0.02, 0.3, 0.6
OPT_ATOL = 1e-6
# float32 loss and gradient configurations, and the QAT ones
CONFIGS = {"l1": dict(loss="l1"), "l2": dict(loss="l2"),
           "grad_loss": dict(loss="l1", grad_weight=0.7)}
QAT = ("fake_quant", "fake_quant_static")


def _tiny_batch(rng, B=2, H=16, W=16):
    label = rng.rand(B, H, W, 1).astype(np.float32)
    return {
        "depth": np.clip(label + 0.1 * rng.randn(B, H, W, 1), 0, 1
                         ).astype(np.float32),
        "color": rng.rand(B, H, W, 1).astype(np.float32),
        "label": label,
        "mask": np.ones((B, H, W, 1), np.float32),
    }


def _jax_loss(variant, cfg, ops):
    """codon_tpu.train.trainer's loss_fn, written out (make_train_step
    keeps it inside); `test_jax_loss_is_the_trainers` ties the two."""
    def loss_fn(params, b):
        out = variant.forward(params, b["depth"], b["color"],
                              mask=b["mask"], ops=ops)
        m = b["mask"]
        err = (out - b["label"]) * m
        if cfg.loss == "l2":
            loss = jnp.sum(err * err) / jnp.sum(m)
        else:
            loss = jnp.sum(jnp.abs(err)) / jnp.sum(m)
        if cfg.grad_weight:
            lbl = b["label"]
            my = m[:, 1:] * m[:, :-1]
            mx = m[:, :, 1:] * m[:, :, :-1]
            ey = ((out[:, 1:] - out[:, :-1])
                  - (lbl[:, 1:] - lbl[:, :-1])) * my
            ex = ((out[:, :, 1:] - out[:, :, :-1])
                  - (lbl[:, :, 1:] - lbl[:, :, :-1])) * mx
            gdenom = jnp.maximum(jnp.sum(my) + jnp.sum(mx), 1.0)
            loss = loss + cfg.grad_weight * (
                jnp.sum(jnp.abs(ey)) + jnp.sum(jnp.abs(ex))) / gdenom
        return loss
    return loss_fn


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _case(name):
    """-> (numpy params, numpy batch, TrainConfig kwargs, JAX ops, port
    ops) of one configuration."""
    rng = np.random.RandomState(0)
    batch = _tiny_batch(rng)
    if name in CONFIGS:
        params = jax.tree.map(np.asarray,
                              jax_variant("codon").init(
                                  jax.random.PRNGKey(0)))
        return params, batch, CONFIGS[name], None, None
    tree = jax_load_npz(STATIC)
    scales = tree.pop("act_scales")
    if name == "fake_quant":
        return tree, batch, {}, jq.FakeQuantOps(), tq.FakeQuantOps()
    return (tree, batch, {}, jq.FakeQuantStaticOps(scales),
            tq.FakeQuantStaticOps(scales))


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's value_and_grad of each configuration, computed once."""
    out = {}
    v = jax_variant("codon")
    for name in (*CONFIGS, *QAT):
        params, batch, kw, jops, _ = _case(name)
        fn = jax.jit(jax.value_and_grad(_jax_loss(v, JaxConfig(**kw),
                                                  jops)))
        loss, grads = fn(params, batch)
        out[name] = (float(loss), _flat(grads))
    return out


def _port_grads(name, variant="codon", **cfg_over):
    params, batch, kw, _, tops = _case(name)
    v = get_variant(variant)
    if cfg_over:
        import dataclasses
        v = dataclasses.replace(v, cfg=dataclasses.replace(v.cfg,
                                                           **cfg_over))
    step, _ = make_train_step(v, TrainConfig(**kw), ops=tops)
    tp = params_from_numpy(params, "cpu")
    loss, grads = step.value_and_grad(
        tp, {k: to_torch(a) for k, a in batch.items()})
    return float(loss), {p: to_np(g) for (p, _), g in
                         zip(tree_items(tp), grads)}


@pytest.mark.parametrize("name", [*CONFIGS, *QAT])
def test_loss_and_gradients_match_jax(jax_grads, name):
    want_loss, want = jax_grads[name]
    loss, got = _port_grads(name)
    qat = name in QAT
    assert got.keys() == want.keys()
    np.testing.assert_allclose(loss, want_loss,
                               rtol=QAT_LOSS_RTOL if qat else LOSS_RTOL)
    tol = QAT_GRAD_TOL if qat else GRAD_TOL
    for path, g in want.items():
        scale = np.abs(g).max()
        err = np.abs(got[path] - g).max()
        assert err <= tol * max(scale, 1e-30), (path, err, scale)
    if qat:
        num = sum(float(np.sum((got[k] - g) ** 2)) for k, g in want.items())
        den = sum(float(np.sum(g ** 2)) for g in want.values())
        assert (num / den) ** 0.5 <= QAT_TREE_L2


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_codon_fused_gradients_match_jax(name):
    """codon_fused's training forward (the kernel stage on the halves of
    T, the kernels' plain versions here) against JAX's value_and_grad of
    codon_forward_fused, and against the port's codon step: the same net,
    so the same loss and gradients at these bounds."""
    params, batch, kw, _, _ = _case(name)
    fn = jax.jit(jax.value_and_grad(_jax_loss(jax_variant("codon_fused"),
                                              JaxConfig(**kw), None)))
    want_loss, want = fn(params, batch)
    want = _flat(want)
    loss, got = _port_grads(name, "codon_fused", cac_impl="kernel")
    codon_loss, codon = _port_grads(name)
    for ref_loss, ref in ((float(want_loss), want), (codon_loss, codon)):
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        assert got.keys() == ref.keys()
        for path, g in ref.items():
            err = np.abs(got[path] - g).max()
            assert err <= GRAD_TOL * max(np.abs(g).max(), 1e-30), path


# trained-parameter cases: x4_ship4.npz (its stem widened to 2 channels
# for codon_sc) at 17 x 15 with a mask, the step at batch 1 included
TRAINED = {"codon-b1": ("codon", 1), "rmcr_fuse_rmcr": ("rmcr_fuse_rmcr", 2),
           "codon_sc": ("codon_sc", 2)}


def _trained_case(variant, n):
    tree = jax.tree.map(np.asarray, jax_load_npz(os.path.join(
        CKPT_DIR, "x4_ship4.npz")))
    rng = np.random.RandomState(11)
    batch = _tiny_batch(rng, B=n, H=17, W=15)
    m = np.zeros_like(batch["mask"])
    m[0, :13, :11] = 1.0
    m[1:] = 1.0
    batch["mask"] = m
    if variant == "codon_sc":
        tree = jax.tree.map(np.asarray, jax_widen(tree, 2))
        plane = np.full_like(batch["depth"], 4 / 16.0)
        batch["depth"] = np.concatenate([batch["depth"], plane], -1)
    return tree, batch


@pytest.mark.parametrize("case", list(TRAINED))
def test_trained_gradients_match_jax(case):
    """The step on trained weights against JAX's value_and_grad: batch 1
    (its head conv's weight gradient at N = 1), the attention-free
    sequential towers (whose forward reads no `cac` and no dead head), and
    the scale-conditioned stem."""
    variant, n = TRAINED[case]
    tree, batch = _trained_case(variant, n)
    fn = jax.jit(jax.value_and_grad(_jax_loss(jax_variant(variant),
                                              JaxConfig(), None)))
    want_loss, want = fn(tree, batch)
    want = _flat(want)
    step, _ = make_train_step(get_variant(variant), TrainConfig())
    tp = params_from_numpy(tree, "cpu")
    loss, grads = step.value_and_grad(
        tp, {k: to_torch(a) for k, a in batch.items()})
    got = {p: to_np(g) for (p, _), g in zip(tree_items(tp), grads)}
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    unread = get_variant(variant).unread
    for path, g in want.items():
        err = np.abs(got[path] - g).max()
        assert err <= GRAD_TOL * max(np.abs(g).max(), 1e-30), (path, err)
        if trainer.top_name(path) in unread:
            assert not got[path].any() and not g.any(), path


@pytest.mark.parametrize("name", QAT)
def test_fake_quant_sites_match_jax(name):
    """Each conv site and handoff of one recorded JAX forward (its first
    call), teacher-forced: the port's value and gradients (x and w) on
    JAX's input."""
    params, batch, _, jops, tops = _case(name)
    sites, seen = [], set()

    class Record(type(jops)):
        def conv2d(self, x, w, **kw):
            if ("conv", kw.get("name")) not in seen:
                seen.add(("conv", kw.get("name")))
                sites.append(("conv", np.asarray(x), np.asarray(w),
                              kw.get("name")))
            return super().conv2d(x, w, **kw)

        def roundtrip(self, x, name=None):
            if ("roundtrip", name) not in seen:
                seen.add(("roundtrip", name))
                sites.append(("roundtrip", np.asarray(x), None, name))
            return super().roundtrip(x, name=name)

    rec = Record(jops.act_scales) if name != "fake_quant" else Record()
    jax_variant("codon").forward(params, batch["depth"], batch["color"],
                                 mask=batch["mask"], ops=rec)
    mask = batch["mask"]
    rng = np.random.RandomState(3)
    # 17 conv sites (the stems' first convs, the spatial gate and the
    # head stay float) and the 5 handoffs
    assert len(sites) == 22
    for kind, x, w, site in sites:
        if kind == "conv":
            jfn = lambda a, b: jops.conv2d(a, b, mask=mask, name=site)
            tfn = lambda a, b: tops.conv2d(a, b, mask=to_torch(mask),
                                           name=site)
            args = (x, w)
        else:
            jfn = lambda a: jops.roundtrip(a, name=site)
            tfn = lambda a: tops.roundtrip(a, name=site)
            args = (x,)
        out, vjp = jax.vjp(jfn, *args)
        cot = rng.randn(*out.shape).astype(np.float32)
        want = [out, *vjp(cot)]
        targs = [to_torch(a).requires_grad_() for a in args]
        tout = tfn(*targs)
        got = [tout, *torch.autograd.grad(tout, targs, to_torch(cot))]
        for g, wv, what in zip(got, want, ("value", "dx", "dw")):
            wv = np.asarray(wv)
            err = np.abs(to_np(g) - wv).max()
            assert err <= SITE_TOL * max(np.abs(wv).max(), 1e-30), (
                site, what, err)


def test_every_leaf_gets_a_gradient(jax_grads):
    """The trap a cut graph sets: every leaf the forward reads has a
    non-zero gradient; the dead heads it never reads have zero, as JAX's."""
    _, got = _port_grads("l1")
    unread = get_variant("codon").unread
    for path, g in got.items():
        if trainer.top_name(path) in unread:
            assert not g.any(), path
            assert not jax_grads["l1"][1][path].any(), path
        else:
            assert np.abs(g).max() > 0, path


def test_kernel_stage_trains_as_the_plain_stage():
    """cac_impl="kernel" on CPU tensors runs CacStageFunction over the
    kernels' plain versions: the same loss and gradients as the plain
    stage, within float32 noise."""
    loss_t, g_t = _port_grads("l1", cac_impl="torch")
    loss_k, g_k = _port_grads("l1", cac_impl="kernel")
    np.testing.assert_allclose(loss_k, loss_t, rtol=LOSS_RTOL)
    for path, g in g_t.items():
        assert np.abs(g_k[path] - g).max() <= GRAD_TOL * max(
            np.abs(g).max(), 1e-30), path


def test_a_cut_graph_raises(monkeypatch):
    """A stage run without autograd (the kernels' raw wrappers) leaves the
    stems and cells behind it with no gradient: the step raises rather
    than train only the trunk."""
    def no_grad_stage(*args):
        with torch.no_grad():
            return kc.cac_stage(*args)

    monkeypatch.setattr(kc.CacStageFunction, "apply", no_grad_stage)
    with pytest.raises(RuntimeError, match="no gradient reached"):
        _port_grads("l1", cac_impl="kernel")


@pytest.mark.parametrize("masked", [False, True])
def test_cac_stage_function(masked):
    out, out_c, inp, inp_c = [to_torch(t).requires_grad_() for t in
                              cac_towers(5, masked)]
    ws = [to_torch(w).requires_grad_() for w in cac_weights(6)]
    mask = to_torch(cac_mask()) if masked else None
    got = kc.CacStageFunction.apply(out, out_c, inp, inp_c, *ws, mask)
    want = codon_net.cac_stage_torch(out, out_c, inp, inp_c, *ws,
                                     mask=mask)
    plain = kc.cac_stage(*(t.detach() for t in (out, out_c, inp, inp_c)),
                         *(w.detach() for w in ws), mask)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(to_np(g), to_np(w), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(to_np(g), to_np(p))
    rng = np.random.RandomState(7)
    cot = [to_torch(rng.randn(*g.shape).astype(np.float32)) for g in got]
    leaves = [out, out_c, inp, inp_c, *ws]
    ga = torch.autograd.grad(got, leaves, cot)
    gb = torch.autograd.grad(want, leaves, cot)
    for a, b in zip(ga, gb):
        np.testing.assert_array_equal(to_np(a), to_np(b))


# ---------------------------------------------------------------------------
# the optimizer, on identical gradients
# ---------------------------------------------------------------------------

OPT_CONFIGS = {
    "constant": {},
    "clip": {"clip_norm": 1.0},
    "decay": {"weight_decay": 0.1},
    "warmup_cosine": {"warmup_steps": 3, "total_steps": 10},
    "warmup_only": {"warmup_steps": 4},
    "all": {"clip_norm": 0.5, "weight_decay": 0.05, "warmup_steps": 2,
            "total_steps": 10, "end_lr_ratio": 0.1},
}


@pytest.mark.parametrize("name", sorted(OPT_CONFIGS))
def test_optimizer_matches_optax(name):
    kw = dict(learning_rate=1e-2, **OPT_CONFIGS[name])
    rng = np.random.RandomState(1)
    shapes = {"a": (3, 3, 2, 4), "b": {"c": (7,), "d": (2, 5)}}

    def tree(scale=1.0):
        return jax.tree.map(lambda s: (scale * rng.randn(*s)).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))

    start = tree()
    tx = jax_optimizer(JaxConfig(**kw))
    jp = jax.tree.map(jnp.asarray, start)
    jstate = tx.init(jp)
    opt = make_optimizer(TrainConfig(**kw))
    tp = params_from_numpy(start, "cpu")
    state = opt.init(tp)
    for i in range(10):
        # a spike at step 4 (clip engages), a near-zero gradient at step 6
        g = tree(30.0 if i == 4 else (1e-9 if i == 6 else 1.0))
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = opt.update([to_torch(v) for _, v in tree_items(g)], state,
                           tp)
        for path, v in _flat(jp).items():
            got = dict((p, to_np(t)) for p, t in tree_items(tp))[path]
            np.testing.assert_allclose(got, v, atol=OPT_ATOL, rtol=0,
                                       err_msg=f"{path} step {i + 1}")
    assert state["count"] == 10


def test_schedule_matches_optax():
    cfg = dict(learning_rate=3e-3, warmup_steps=5, total_steps=40)
    ours = trainer.make_schedule(TrainConfig(**cfg))
    ref = optax.warmup_cosine_decay_schedule(
        init_value=3e-5, peak_value=3e-3, warmup_steps=5, decay_steps=40,
        end_value=3e-5)
    for count in range(0, 45):
        np.testing.assert_allclose(float(ours(count)), float(ref(count)),
                                   rtol=1e-6)


def test_weight_decay_shrinks_params():
    """Decoupled decay: with zero gradients the update is -lr * wd * p."""
    lr, wd = 1e-2, 0.1
    opt = make_optimizer(TrainConfig(learning_rate=lr, weight_decay=wd))
    p = {"w": torch.ones(4)}
    st = opt.init(p)
    opt.update([torch.zeros(4)], st, p)
    np.testing.assert_allclose(to_np(p["w"]), 1.0 - lr * wd, rtol=1e-6)


def test_clip_norm_damps_spike_aftermath():
    """A spike of 1e6 fills Adam's second moment and mutes the ordinary
    steps after it; with clip_norm the run moves at Adam's scale again."""
    def moved_after_spike(cfg, steps=300):
        opt = make_optimizer(cfg)
        p = {"w": torch.zeros(4)}
        st = opt.init(p)
        st = opt.update([torch.full((4,), 1e6)], st, p)
        p0 = p["w"].clone()
        for _ in range(steps):
            st = opt.update([torch.full((4,), 1e-2)], st, p)
        return float((p["w"] - p0).abs().max())

    lr = 1e-4
    unclipped = moved_after_spike(TrainConfig(learning_rate=lr))
    clipped = moved_after_spike(TrainConfig(learning_rate=lr, clip_norm=1.0))
    assert clipped > 5 * unclipped, (clipped, unclipped)
    assert clipped > 30 * lr, clipped


def test_collapse_detector_patience_and_reset():
    cd = CollapseDetector(patience=3)
    assert [cd.update(0.0) for _ in range(3)] == [False, False, True]
    cd = CollapseDetector(patience=3)
    seq = [0.0, 0.0, 1e-30, 0.0, 0.0, 0.0, 0.0]
    assert [cd.update(g) for g in seq] == [False] * 5 + [True, True]


def test_loss_decreases():
    v = get_variant("codon")
    params = v.init(torch.Generator().manual_seed(0), device="cpu")
    step, opt = make_train_step(v, TrainConfig(learning_rate=1e-3))
    state = opt.init(params)
    batch = {k: to_torch(a) for k, a in
             _tiny_batch(np.random.RandomState(0)).items()}
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_widen_stem_params_preserves_the_function():
    """widen_stem_params equals JAX's, and the widened codon_sc model
    computes the 1-channel model's function for every conditioning value."""
    tree = jax.tree.map(np.asarray, jax_variant("codon_x16").init(
        jax.random.PRNGKey(7)))
    wide = codon_net.widen_stem_params(tree, 2)
    ref = jax_widen(tree, 2)
    assert wide.keys() == ref.keys()
    for k in wide:
        if not isinstance(wide[k], dict):
            np.testing.assert_array_equal(wide[k], ref[k])
    assert tree["input"].shape == (3, 3, 1, 64)
    rng = np.random.RandomState(7)
    d = to_torch(rng.rand(1, 15, 13, 1).astype(np.float32))
    c = to_torch(rng.rand(1, 15, 13, 1).astype(np.float32))
    base = get_variant("codon_x16").forward(params_from_numpy(tree, "cpu"),
                                            d, c)
    sc = get_variant("codon_sc")
    wp = params_from_numpy(wide, "cpu")
    for cv in (0.0, 0.25, 1.0):
        out = sc.forward(wp, torch.cat([d, torch.full_like(d, cv)], -1), c)
        np.testing.assert_allclose(to_np(out), to_np(base), atol=2e-6,
                                   rtol=0)
    with pytest.raises(ValueError):
        codon_net.widen_stem_params(wide, 3)


def test_fused_and_mesh_training_refused():
    """codon_fused and the zoo build a mesh step (they train there:
    tests/test_torch_parallel_train.py, tests/test_torch_parallel_zoo_
    train.py); a backend without a sharded twin still raises before any
    rank is asked, as in JAX."""
    from codon_tpu_torch.parallel.train import MeshTrainStep
    get_variant("codon_fused").check_trainable()
    for name in ("codon_fused", "zoo:basenet"):
        step, _ = make_train_step(get_variant(name), mesh=object())
        assert isinstance(step, MeshTrainStep)
    with pytest.raises(NotImplementedError, match="no sharded twin"):
        make_train_step(get_variant("codon"), ops=tq.Int8Ops(),
                        mesh=object())


def test_jax_loss_is_the_trainers(jax_grads):
    """The loss written out above is codon_tpu's: JAX's own train step
    reports the same loss and gradient norm for it."""
    params, batch, kw, _, _ = _case("grad_loss")
    step, tx = jax_train_step(jax_variant("codon"), JaxConfig(**kw),
                              donate=False)
    _, _, m = step(params, tx.init(params), batch)
    loss, grads = jax_grads["grad_loss"]
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-6)
    norm = np.sqrt(sum(float(np.sum(g * g)) for g in grads.values()))
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-5)


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def _state(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"a": rng.randn(3, 4).astype(np.float32),
                       "b": {"c": rng.randn(5).astype(np.float32)}},
            "opt_state": {"count": np.asarray(seed, np.int64)},
            "step": np.asarray(seed, np.int64)}


def _same(a, b):
    fa, fb = dict(tree_items(a)), dict(tree_items(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]))


def test_manager_round_trip_keep_last_and_latest(tmp_path):
    with CheckpointManager(str(tmp_path / "run"), max_to_keep=3) as mgr:
        for step in (10, 20, 30, 40):
            tree = _state(step)
            tree["params"]["a"] = torch.from_numpy(tree["params"]["a"])
            mgr.save(step, tree)
            tree["params"]["a"].add_(1.0)   # the save copied it already
        mgr.wait()
        assert mgr.all_steps() == [20, 30, 40]
        assert mgr.latest_step() == 40
    again = CheckpointManager(str(tmp_path / "run"))
    _same(again.restore(), _state(40))
    _same(again.restore(20), _state(20))
    assert int(again.restore(30)["step"]) == 30


def test_manager_missing_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(1, _state(1))
    mgr.wait()
    with pytest.raises(FileNotFoundError, match="step 2"):
        mgr.restore(2)


def test_manager_failed_write_leaves_no_step(tmp_path, monkeypatch):
    """A write that fails half way leaves neither step_<n> nor its
    temporary directory, keeps the steps before it, and raises from the
    next wait."""
    from codon_tpu_torch.checkpoint import manager as mod
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, _state(1))
    mgr.wait()

    def half_write(path, tree):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 partial")
        raise OSError("disk full")

    monkeypatch.setattr(mod, "save_npz", half_write)
    mgr.save(2, _state(2))
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    assert sorted(os.listdir(tmp_path / "run")) == ["step_1"]
    assert mgr.all_steps() == [1]
    _same(mgr.restore(), _state(1))


def test_no_optax_or_orbax_on_the_card():
    """The card's machine has neither: the port writes out optax's chain
    and its own checkpoint manager."""
    for path in _card_files():
        assert not _imported_roots(path) & {"optax", "orbax"}, path
