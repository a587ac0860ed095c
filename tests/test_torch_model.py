"""The port's CODONNet forward against the JAX package's, on the CPU.

float32, atol 5e-4 / rtol 1e-3: the tolerance tests/test_model_parity.py
holds the JAX forward to against the PyTorch release. Weights are the JAX
package's own (its random init, or a committed checkpoint) carried across
with `params_from_numpy`; inputs are made with numpy from a seed.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.core.params import BF16 as JBF16
from codon_tpu.core.params import FP16 as JFP16
from codon_tpu.core.params import FP32 as JFP32
from codon_tpu.models import codon_net as jnet
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core import params as tparams
from codon_tpu_torch.models import codon_net as tnet
from codon_tpu_torch.models.variants import get_variant, list_variants

from torch_port_common import CKPT_DIR, one_torch_thread, to_torch  # noqa: F401

H, W = 33, 29
ATOL, RTOL = 5e-4, 1e-3


def _inputs(n=2, h=H, w=W, seed=0, in_channels=1):
    rng = np.random.RandomState(seed)
    d = rng.rand(n, h, w, in_channels).astype(np.float32)
    c = rng.rand(n, h, w, 1).astype(np.float32)
    return d, c


def _jax_forward(params, d, c, cfg, mask=None):
    out = jnet.codon_forward(params, jnp.asarray(d), jnp.asarray(c), cfg=cfg,
                             mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(out)


def _torch_forward(tree, d, c, cfg, mask=None):
    out = tnet.codon_forward(params_from_numpy(tree, "cpu"), to_torch(d),
                             to_torch(c), cfg=cfg,
                             mask=None if mask is None else to_torch(mask))
    assert out.dtype == torch.float32 and tuple(out.shape) == d.shape[:3] + (1,)
    return out.numpy()


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("cac_impl", ["torch", "kernel"])
def test_forward_random_init_matches_jax(cac_impl):
    jcfg = jnet.CodonConfig(dtypes=JFP32)
    params = jnet.init_codon_params(jax.random.PRNGKey(0), jcfg)
    d, c = _inputs()
    want = _jax_forward(params, d, c, jcfg)
    got = _torch_forward(_numpy_tree(params), d, c,
                         tnet.CodonConfig(cac_impl=cac_impl))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ckpt,variant,in_ch", [
    ("x4_ship4.npz", "codon", 1),
    ("x16_ship5.npz", "codon_x16", 1),
    ("x4_holdout_sc.npz", "codon_sc", 2),
])
def test_forward_checkpoint_matches_jax(ckpt, variant, in_ch):
    path = os.path.join(CKPT_DIR, ckpt)
    jv = jax_variant(variant, JFP32)
    tv = get_variant(variant)
    d, c = _inputs(seed=1)
    if in_ch == 2:
        # the scale-conditioning plane, as `eval --scale-cond` adds it
        d = np.concatenate([d, np.full_like(d, 4 / 16)], -1)
    want = np.asarray(jv.forward(jax_load_npz(path), jnp.asarray(d),
                                 jnp.asarray(c)))
    tree = load_npz(path)
    got = tv.forward(params_from_numpy(tree, "cpu"), to_torch(d), to_torch(c))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the kernels' composition of the stage (here their plain versions)
    cfg = dataclasses.replace(tv.cfg, cac_impl="kernel")
    got_k = tnet.codon_forward(params_from_numpy(tree, "cpu"), to_torch(d),
                               to_torch(c), cfg=cfg)
    np.testing.assert_allclose(got_k.numpy(), want, atol=ATOL, rtol=RTOL)


def test_swapped_color_cat_matches_jax():
    path = os.path.join(CKPT_DIR, "x16_ship5.npz")
    d, c = _inputs(1, seed=2)
    want = np.asarray(jax_variant("codonet_x16_model", JFP32).forward(
        jax_load_npz(path), jnp.asarray(d), jnp.asarray(c)))
    got = get_variant("codonet_x16_model").forward(
        params_from_numpy(load_npz(path), "cpu"), to_torch(d), to_torch(c))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    plain = get_variant("codon_x16").forward(
        params_from_numpy(load_npz(path), "cpu"), to_torch(d), to_torch(c))
    assert float((plain - got).abs().max()) > 1e-3, \
        "color_cat_swapped changed nothing"


@pytest.mark.parametrize("cac_impl", ["torch", "kernel"])
def test_masked_mixed_batch_equals_per_image(cac_impl):
    """Two sizes padded into one batch with a mask equal per-image runs,
    and the JAX package's masked batch."""
    tree = load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    params = params_from_numpy(tree, "cpu")
    cfg = dataclasses.replace(get_variant("codon").cfg, cac_impl=cac_impl)
    rng = np.random.RandomState(3)
    sizes = [(H, W), (21, 17)]
    depth = np.zeros((2, H, W, 1), np.float32)
    color = np.zeros((2, H, W, 1), np.float32)
    mask = np.zeros((2, H, W, 1), np.float32)
    singles = []
    for i, (h, w) in enumerate(sizes):
        d = rng.rand(1, h, w, 1).astype(np.float32)
        c = rng.rand(1, h, w, 1).astype(np.float32)
        depth[i, :h, :w], color[i, :h, :w], mask[i, :h, :w] = d[0], c[0], 1
        singles.append(tnet.codon_forward(params, to_torch(d), to_torch(c),
                                          cfg=cfg).numpy())
    out = tnet.codon_forward(params, to_torch(depth), to_torch(color),
                             cfg=cfg, mask=to_torch(mask)).numpy()
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_allclose(out[i, :h, :w], singles[i][0],
                                   atol=2e-4, rtol=1e-3)
    want = _jax_forward(jax_load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")),
                        depth, color, jax_variant("codon", JFP32).cfg, mask)
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_allclose(out[i, :h, :w], want[i, :h, :w],
                                   atol=ATOL, rtol=RTOL)


def test_packed_equals_split():
    tree = load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    params = params_from_numpy(tree, "cpu")
    d, c = _inputs(seed=4)
    cfg = get_variant("codon").cfg
    packed = tnet.codon_forward(params, to_torch(d), to_torch(c), cfg=cfg)
    split = tnet.codon_forward(params, to_torch(d), to_torch(c),
                               cfg=dataclasses.replace(cfg,
                                                       cell_impl="split"))
    np.testing.assert_allclose(packed.numpy(), split.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_pack_kernel_pair_matches_jax():
    rng = np.random.RandomState(5)
    ka = rng.randn(3, 3, 4, 6).astype(np.float32)
    kb = rng.randn(5, 5, 4, 2).astype(np.float32)
    want = np.asarray(jnet.pack_kernel_pair(jnp.asarray(ka), jnp.asarray(kb)))
    got = tnet.pack_kernel_pair(to_torch(ka), to_torch(kb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_forward_tracks_jax_bf16():
    """bf16 compute with float32 params. The two frameworks round bf16 at
    other places (conv accumulation, the XLA stage's fusion), so the
    comparison is loose: a few bf16 ulps of a [0, 1] depth map."""
    path = os.path.join(CKPT_DIR, "x4_ship4.npz")
    d, c = _inputs(1, seed=6)
    want = np.asarray(jax_variant("codon", JBF16).forward(
        jax_load_npz(path), jnp.asarray(d), jnp.asarray(c)))
    v = get_variant("codon", tparams.BF16)
    got = v.forward(params_from_numpy(load_npz(path), "cpu"), to_torch(d),
                    to_torch(c))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


def test_fp16_forward_tracks_jax_fp16():
    """fp16 compute with float32 params, as the reference release runs
    (`.half()`). At this input (x4_ship4.npz, 1x33x29, seed 6, one torch
    thread on the CPU) the port's fp16 forward reads 1.46e-3 max |d| from
    JAX's fp16 one, while an fp32 forward, the port's or JAX's, reads
    2.80e-3 from it. So the bound, 2.2e-3 of a [0, 1] depth map, lies
    between the two: a forward that quietly computed in fp32 fails it. And
    the port's fp16 must stand at least 1e-3 from its own fp32 forward (it
    reads 2.03e-3): fp16 rounding has to show."""
    path = os.path.join(CKPT_DIR, "x4_ship4.npz")
    d, c = _inputs(1, seed=6)
    want = np.asarray(jax_variant("codon", JFP16).forward(
        jax_load_npz(path), jnp.asarray(d), jnp.asarray(c)))
    params = params_from_numpy(load_npz(path), "cpu")
    got = get_variant("codon", tparams.FP16).forward(params, to_torch(d),
                                                     to_torch(c))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=2.2e-3, rtol=0)
    fp32 = get_variant("codon").forward(params, to_torch(d), to_torch(c))
    assert float((got - fp32).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["codon", "codon_x16", "codonet_x16_model",
                                  "codon_sc", "codon_f4", "codon_f5",
                                  "codon_f6", "codon_f7", "codon_fused",
                                  "rmcr_fuse_rmcr"])
def test_variant_configs_and_init_match_jax(name):
    jv, tv = jax_variant(name, JFP32), get_variant(name)
    for field in ("width", "num_mc", "num_fuse", "in_channels", "use_cac",
                  "cac_reduction", "spatial_kernel", "dead_heads",
                  "color_cat_swapped", "cell_impl"):
        assert getattr(tv.cfg, field) == getattr(jv.cfg, field), field
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jv.init(jax.random.PRNGKey(0)))
    tshapes = jax.tree.map(lambda a: tuple(a.shape),
                           tv.init(torch.Generator().manual_seed(0), "cpu"))
    assert tshapes == jshapes


def test_registry_holds_the_ported_variants():
    from codon_tpu.models.variants import list_variants as jax_list
    assert list_variants() == sorted(
        ["codon", "codon_sc", "codon_x16", "codonet_x16_model", "codon_f4",
         "codon_f5", "codon_f6", "codon_f7", "codon_fused",
         "rmcr_fuse_rmcr"])
    # the JAX registry less its ablation zoo
    assert list_variants() == [n for n in jax_list()
                               if not n.startswith("zoo:")]
    with pytest.raises(KeyError, match="unknown variant"):
        get_variant("zoo:" + next(n for n in jax_list()
                                  if n.startswith("zoo:"))[4:])


def test_f_variants_share_codon_checkpoints():
    tree = load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    d, c = _inputs(1, seed=7)
    path = os.path.join(CKPT_DIR, "x4_ship4.npz")
    want = np.asarray(jax_variant("codon_f5", JFP32).forward(
        jax_load_npz(path), jnp.asarray(d), jnp.asarray(c)))
    got = get_variant("codon_f5").forward(params_from_numpy(tree, "cpu"),
                                          to_torch(d), to_torch(c))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_init_is_seeded_and_he_scaled():
    cfg = tnet.CodonConfig()
    a = tnet.init_codon_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b = tnet.init_codon_params(torch.Generator().manual_seed(0), cfg, "cpu")
    c = tnet.init_codon_params(torch.Generator().manual_seed(1), cfg, "cpu")
    assert torch.equal(a["conv3"], b["conv3"])
    assert not torch.equal(a["conv3"], c["conv3"])
    # He init: std sqrt(2 / (k^2 * C_out)); conv3 is 5x5, 128 -> 128
    std = float(a["conv3"].std())
    assert abs(std / np.sqrt(2 / (25 * 128)) - 1) < 0.02
    w1 = a["cac"]["ch_w1"]
    assert w1.shape == (5, 128, 8)
    assert float(w1.abs().max()) <= 1 / np.sqrt(128)
    # the X4 flavour's parameter count, dead heads included
    n = sum(t.numel() for t in jax.tree.leaves(
        tnet.init_codon_params(torch.Generator().manual_seed(0),
                               get_variant("codon").cfg, "cpu")))
    assert n == 1_866_136


def test_forward_rejects_unknown_impls():
    params = tnet.init_codon_params(torch.Generator().manual_seed(0),
                                    device="cpu")
    d, c = _inputs(1, 9, 7)
    for cfg in (tnet.CodonConfig(cac_impl="pallas"),
                tnet.CodonConfig(cell_impl="grouped")):
        with pytest.raises(ValueError):
            tnet.codon_forward(params, to_torch(d), to_torch(c), cfg=cfg)


def test_full_fp32_turns_tf32_off_and_restores():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tparams.full_fp32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------------
# the merged-tower and sequential-tower forwards
# ---------------------------------------------------------------------------

def _mixed_mask(n=2, h=H, w=W):
    m = np.ones((n, h, w, 1), np.float32)
    m[-1, 21:] = 0.0
    m[-1, :, 17:] = 0.0
    return m


@pytest.mark.parametrize("cac_impl", ["torch", "kernel"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("variant", ["codon_fused", "rmcr_fuse_rmcr"])
def test_other_forwards_match_jax(variant, masked, cac_impl):
    """fp32, atol 5e-4 / rtol 1e-3. For codon_fused, cac_impl="kernel" on
    CPU tensors is the kernels' composition on the halves of T (their
    plain versions); rmcr_fuse_rmcr has no CAC stage."""
    path = os.path.join(CKPT_DIR, "x4_ship4.npz")
    d, c = _inputs(seed=11)
    m = _mixed_mask() if masked else None
    want = np.asarray(jax_variant(variant, JFP32).forward(
        jax_load_npz(path), jnp.asarray(d), jnp.asarray(c),
        mask=None if m is None else jnp.asarray(m)))
    tv = get_variant(variant)
    cfg = dataclasses.replace(tv.cfg, cac_impl=cac_impl)
    got = tv.forward_fn(params_from_numpy(load_npz(path), "cpu"),
                        to_torch(d), to_torch(c), cfg=cfg,
                        mask=None if m is None else to_torch(m))
    assert got.dtype == torch.float32 and tuple(got.shape) == d.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_fused_forward_equals_packed_forward():
    """The same function and checkpoint as `codon`: the JAX package holds
    its fused form to the packed one within 2e-4 / 1e-3."""
    params = params_from_numpy(
        load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz")), "cpu")
    d, c = _inputs(seed=12)
    m = to_torch(_mixed_mask())
    fused = get_variant("codon_fused").forward(params, to_torch(d),
                                               to_torch(c), mask=m)
    packed = get_variant("codon").forward(params, to_torch(d), to_torch(c),
                                          mask=m)
    np.testing.assert_allclose(fused.numpy(), packed.numpy(), atol=2e-4,
                               rtol=1e-3)


def test_fused_forward_refuses_swapped_color_cat():
    params = params_from_numpy(
        load_npz(os.path.join(CKPT_DIR, "x16_ship5.npz")), "cpu")
    d, c = _inputs(1, 9, 7)
    with pytest.raises(NotImplementedError, match="color_cat_swapped"):
        tnet.codon_forward_fused(params, to_torch(d), to_torch(c),
                                 cfg=get_variant("codonet_x16_model").cfg)


def test_sequential_forward_ignores_cac_and_dead_heads():
    """rmcr_fuse_rmcr reads only the convs: a `codon` checkpoint, CAC heads
    and all, gives what its conv weights alone give."""
    tree = load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    convs = {k: v for k, v in tree.items()
             if k not in ("cac", "attention_c5", "attention_s5")}
    d, c = _inputs(1, seed=13)
    v = get_variant("rmcr_fuse_rmcr")
    full = v.forward(params_from_numpy(tree, "cpu"), to_torch(d), to_torch(c))
    bare = v.forward(params_from_numpy(convs, "cpu"), to_torch(d),
                     to_torch(c))
    assert torch.equal(full, bare)
