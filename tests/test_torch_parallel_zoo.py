"""The ablation zoo over the port's dp x sp mesh (`codon_tpu_torch.parallel`)
against the JAX package's sharded zoo on its 8-device CPU mesh, and
against the port's own single-device forward: every one of the 27
`zoo:*` nets, dynamic int8, tile-and-stitch, and the whole-image
attention that no sharded zoo forward may reach.

The port's mesh is 8 gloo ranks on the CPU: this process is rank 0, one
`MeshPool` for the module. Each net starts from JAX's own `zoo_init`
(PRNGKey(0)) carried across with `params_from_numpy`. The inputs are
numpy from a seed: B 2, H 16, W 12, image 1 masked off in its last 5
rows and 3 columns, the padding zero as the loader leaves it.

Tolerances, and why:
- float32 forwards, sharded against JAX's sharded and against the port's
  single-device forward: atol 5e-4 / rtol 1e-3, the zoo's forward
  tolerance (tests/test_torch_zoo_unrolled.py; the convs of a shard and
  the all-reduced pools sum in other orders). JAX's sharded zoo against
  its whole-image forward reads 3.0e-8 to 2.6e-6 of the output's max.
- dynamic int8 (random init): the narrow sites (RCAN's pooled 64 -> 4 ->
  64 gate, CGNL's grouped 32 -> 64) bitwise with JAX's `_int8_conv` on
  the same haloed rows and gathered scale (tests/test_torch_zoo_ops.py:
  the same codes, the zero padding adds exact zeros); the whole net in
  the dynamic int8 class of tests/test_torch_zoo_ops.py, mean 5% / max
  30% of the output's mean |y| from JAX's sharded int8, and 4x closer to
  it than to the float forward.
- tile-and-stitch of zoo:basenet against JAX's stitch: max |d| within
  1e-4 of the output's largest magnitude, tests/test_torch_parallel.py's
  bound. Stitching is approximate for the zoo's global gates (each tile
  pools over itself), in both packages alike, so the two stitches are
  held against each other, not against the whole frame.
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu import quant_ops as jq
from codon_tpu.models import zoo as jzoo
from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codon_tpu.parallel.stitch import tile_stitch_infer as jax_stitch
from codon_tpu.parallel.tiling import make_sharded_forward as jax_sharded

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.core.ops import conv2d_nhwc
from codon_tpu_torch.models import attention
from codon_tpu_torch.models.variants import get_variant, list_variants
from codon_tpu_torch.parallel import (MeshPool, ShardedOps,
                                      make_sharded_forward,
                                      tile_stitch_infer)
from codon_tpu_torch.parallel import quant as pq
from codon_tpu_torch.parallel.launch import rank_counts, reset_rank_counts

from torch_port_common import one_torch_thread, to_np, to_torch  # noqa: F401

ATOL, RTOL = 5e-4, 1e-3
MEAN_B, MAX_B = 0.05, 0.3
STITCH_FRAC = 1e-4
# the mean of INT8_CPU_BOUNDS, the int8 flip class (chip_smoke.py)
INT8_FLIP_MEAN = 0.01
NETS = jzoo.list_zoo()
SUBSET = ["basenet_nlar", "rmcr_fuse_rmcr_rcan", "rmcr_fuse_rmcr_eccv",
          "basenet_cross"]


def zoo_inputs(seed=0, B=2, H=16, W=12):
    """-> depth, color, mask (B, H, W, 1) float32 numpy: image 1 valid on
    its top-left (H - 5) x (W - 3), zero on the padding."""
    rng = np.random.RandomState(seed)
    mask = np.ones((B, H, W, 1), np.float32)
    mask[1, H - 5:] = 0.0
    mask[1, :, W - 3:] = 0.0
    depth = rng.rand(B, H, W, 1).astype(np.float32) * mask
    color = rng.rand(B, H, W, 1).astype(np.float32) * mask
    return depth, color, mask


def jax_params(name, seed=0):
    return jax.tree.map(np.asarray,
                        jzoo.zoo_init(name, jax.random.PRNGKey(seed)))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    p = MeshPool(8, device="cpu", timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def inputs():
    d, c, m = zoo_inputs()
    return dict(d=d, c=c, m=m, td=to_torch(d), tc=to_torch(c),
                tm=to_torch(m))


@pytest.mark.parametrize("name", list_variants())
def test_variant_pickles(name):
    """Every registered variant travels to a mesh rank by value: the
    unpickled one equals it, still finds its training forward, and
    computes the same eval and training forwards."""
    v = get_variant(name)
    w = pickle.loads(pickle.dumps(v))
    assert w == v
    w.check_trainable()
    p = v.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    d = torch.rand(1, 9, 7, v.cfg.in_channels, generator=g)
    c = torch.rand(1, 9, 7, 1, generator=g)
    assert torch.equal(w.forward(p, d, c), v.forward(p, d, c))
    with torch.enable_grad():
        a, b = w.train_forward(p, d, c), v.train_forward(p, d, c)
    assert torch.equal(a, b) and a.requires_grad == b.requires_grad


@pytest.mark.parametrize("name", NETS)
def test_zoo_sharded_matches_jax_and_single(pool, inputs, name):
    """Each net at 1 x 4 against JAX's sharded forward at 1 x 4 and the
    port's whole-image forward; no rank runs the CAC stage."""
    s = inputs
    p = jax_params(name)
    jv = jax_variant("zoo:" + name)
    jout = np.asarray(jax_sharded(jv, jax_make_mesh([1, 4]))(
        p, s["d"], s["c"], jnp.asarray(s["m"])))
    v = get_variant("zoo:" + name)
    tp = params_from_numpy(p, "cpu")
    single = v.forward(tp, s["td"], s["tc"], mask=s["tm"])
    pool.call(reset_rank_counts)
    out = make_sharded_forward(v, pool.mesh(1, 4))(tp, s["td"], s["tc"],
                                                   s["tm"])
    assert out.dtype == torch.float32 and tuple(out.shape) == jout.shape
    _close(out, jout)
    _close(out, single)
    for c in pool.call(rank_counts)[:4]:
        assert c["stages"] == {"whole": 0, "shard": 0}


@pytest.mark.parametrize("form", [(2, 2), (2, 1)],
                         ids=lambda f: f"{f[0]}x{f[1]}")
@pytest.mark.parametrize("name", SUBSET)
def test_zoo_other_forms_match_single(pool, inputs, name, form):
    s = inputs
    v = get_variant("zoo:" + name)
    tp = params_from_numpy(jax_params(name), "cpu")
    single = v.forward(tp, s["td"], s["tc"], mask=s["tm"])
    out = make_sharded_forward(v, pool.mesh(*form))(tp, s["td"], s["tc"],
                                                    s["tm"])
    _close(out, single)


def test_pam_and_cam_never_run_and_refuse_a_shard(monkeypatch, inputs):
    """No zoo forward calls pam or cam (SEPNON's net declares them and
    never calls them); handed a sharded backend, each raises instead of
    attending within a shard."""
    calls = []
    for fn in ("pam", "cam"):
        real = getattr(attention, fn)
        monkeypatch.setattr(attention, fn, lambda *a, _r=real, _f=fn, **k:
                            calls.append(_f) or _r(*a, **k))
    s = inputs
    for name in NETS:
        v = get_variant("zoo:" + name)
        p = v.init(torch.Generator().manual_seed(0), device="cpu")
        v.forward(p, s["td"][:, :8], s["tc"][:, :8], mask=s["tm"][:, :8])
    assert calls == []
    monkeypatch.undo()
    x = torch.rand(1, 4, 3, 8)
    ops = ShardedOps(group=None)
    with pytest.raises(NotImplementedError, match="pam attends"):
        attention.pam({}, "sa", x, ops)
    with pytest.raises(NotImplementedError, match="cam attends"):
        attention.cam({}, "sc", x, ops)
    with pytest.raises(ValueError, match="pooled"):
        ops.conv2d(torch.rand(2, 1, 1, 8), torch.rand(3, 3, 8, 4))


def _is_narrow(w, groups):
    return bool(w.shape[2] % 16 or (w.shape[3] // groups) % 8)


@pytest.mark.parametrize("name", ["rmcr_fuse_rmcr_rcan", "basenet_nlar",
                                  "rmcr_fuse_rmcr_eccv"])
def test_zoo_dynamic_int8_sharded_matches_jax(pool, inputs, monkeypatch,
                                              name):
    """Dynamic int8 at 1 x 4: rank 0's narrow sites bitwise JAX's
    `_int8_conv` on the same haloed rows and gathered scale, the whole net
    in the int8 class of JAX's sharded `Int8ShardedOps`. CBAM (eccv) has
    no narrow int8 site: its gate MLPs are linear layers and its 2 -> 1
    spatial convs stay float, in both packages."""
    s = inputs
    p = jax_params(name)
    jv = jax_variant("zoo:" + name)
    jm = jnp.asarray(s["m"])
    jout = np.asarray(jax_sharded(jv, jax_make_mesh([1, 4]),
                                  ops_factory=jq.Int8ShardedOps)(
        p, s["d"], s["c"], jm))
    flt = np.asarray(jax_sharded(jv, jax_make_mesh([1, 4]))(
        p, s["d"], s["c"], jm))
    narrow = []
    real = pq._int8_conv

    def spy(x, w, **kw):
        out = real(x, w, **kw)
        if _is_narrow(w, kw.get("groups", 1)):
            narrow.append((x, w, kw, out))
        return out
    monkeypatch.setattr(pq, "_int8_conv", spy)
    v = get_variant("zoo:" + name)
    tp = params_from_numpy(p, "cpu")
    out = make_sharded_forward(v, pool.mesh(1, 4),
                               ops_factory=pq.Int8ShardedOps)(
        tp, s["td"], s["tc"], s["tm"])
    assert bool(narrow) == (name != "rmcr_fuse_rmcr_eccv")
    for x, w, kw, got in narrow:
        pw = (w.shape[1] - 1) // 2
        want = jq._int8_conv(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                             padding=((0, 0), (pw, pw)),
                             groups=kw.get("groups", 1),
                             sx=jnp.asarray(kw["sx"].numpy()))
        if kw.get("mask") is not None:
            want = want * jnp.asarray(kw["mask"].numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = to_np(out)
    scale = np.abs(jout).mean()
    d = np.abs(got - jout)
    assert d.mean() <= MEAN_B * scale and d.max() <= MAX_B * scale
    assert d.mean() < 0.25 * np.abs(jout - flt).mean()
    single = v.forward(tp, s["td"], s["tc"], mask=s["tm"], ops=tq.Int8Ops())
    d = np.abs(got - to_np(single))
    assert d.mean() <= MEAN_B * scale and d.max() <= MAX_B * scale


def test_zoo_sharded_int8_gap_is_the_batch_not_the_pools(pool):
    """What sets zoo:rmcr_fuse_rmcr_rcan's sharded dynamic int8 forward
    (fp32 float parts) apart from the unsharded one, on a 2 x 64 x 48
    frame where the two differ. Not the global pools' sum order: with the
    pools gathered and reduced in the single-device order
    (`chip_smoke.single_order_int8_ops`; the ranks are other processes,
    so the form travels as an ops_factory, not as a patch of
    `ShardedOps`) the 2 x 2 forward is the production one bitwise, and at
    1 x 2 both are bitwise the unsharded forward. It is the batch: the
    2 x 2 forward is bitwise the unsharded forward taken one dp block
    (one image) at a time, and the unsharded forward at batch 2 is not,
    because the float32 1 -> 64 stem conv rounds image 0 otherwise at
    batch 2 than at batch 1 (PyTorch's CPU conv); int8 codes then flip
    and cascade through the pooled gates."""
    import chip_smoke
    name = "rmcr_fuse_rmcr_rcan"
    d, c, m = (to_torch(a) for a in zoo_inputs(0, 2, 64, 48))
    v = get_variant("zoo:" + name)
    tp = params_from_numpy(jax_params(name), "cpu")
    whole = v.forward(tp, d, c, mask=m, ops=tq.Int8Ops())
    blocks = torch.cat([v.forward(tp, d[i:i + 1], c[i:i + 1],
                                  mask=m[i:i + 1], ops=tq.Int8Ops())
                        for i in range(2)])
    assert not torch.equal(whole, blocks)
    assert float((whole - blocks).abs().mean()) > INT8_FLIP_MEAN

    def sharded(form, factory):
        return make_sharded_forward(v, pool.mesh(*form),
                                    ops_factory=factory)(tp, d, c, m)
    for form in ((1, 2), (2, 2)):
        prod = sharded(form, pq.Int8ShardedOps)
        single_order = sharded(form, chip_smoke.single_order_int8_ops)
        assert torch.equal(prod, single_order), form
        assert torch.equal(prod, whole if form == (1, 2) else blocks), form
    stem = tp["input.weight"]
    assert stem.shape == (3, 3, 1, 64)
    x = d * m
    at2 = conv2d_nhwc(x, stem)
    at1 = torch.cat([conv2d_nhwc(x[i:i + 1], stem) for i in range(2)])
    assert not torch.equal(at2, at1)


def test_zoo_stitch_matches_jax():
    """Tile-and-stitch of zoo:basenet with CODONNet's 48-row halo against
    JAX's stitch of the same frame: approximate for the global gates in
    both, the same approximation."""
    rng = np.random.RandomState(3)
    d = rng.rand(1, 200, 23, 1).astype(np.float32)
    c = rng.rand(1, 200, 23, 1).astype(np.float32)
    p = jax_params("basenet")
    jout = np.asarray(jax_stitch(jax_variant("zoo:basenet"), p, d, c,
                                 tile_h=64, halo=48))
    out = tile_stitch_infer(get_variant("zoo:basenet"),
                            params_from_numpy(p, "cpu"), d, c, tile_h=64,
                            halo=48)
    assert out.shape == jout.shape
    assert np.abs(to_np(out) - jout).max() <= STITCH_FRAC * np.abs(
        jout).max()
