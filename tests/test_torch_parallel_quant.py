"""The port's sharded int8 backends (`Int8ShardedOps`,
`Int8StaticShardedOps`) against JAX's sharded int8 on its 8-device CPU
mesh and against the port's unsharded int8, on 4 gloo ranks of the CPU
(this process rank 0, one `MeshPool` for the module); and the haloed
int8 patches those backends run on.

Tolerances, and why:
- `_gathered_sample_scale` against the untiled `_x_scale`: bitwise (a max
  is exact in any order).
- haloed `quant_im2col_plain` and `int8_conv` against the SAME-padded ones
  on the whole tensor, cropped to the shard: bitwise (the same codes, the
  same integer sums).
- dynamic int8, random init x 0.5, against the port's unsharded int8:
  atol 2e-4 / rtol 1e-3, JAX's tests/test_quant_ops.py:59 (every shard
  quantizes on the untiled grid); against JAX's sharded int8 the dynamic
  flip class of tests/test_torch_quant.py, mean 0.03 / max 0.3 (the two
  frameworks' float parts differ in the last bits, which a rounding
  boundary turns into a code; the run here reads max 1.3e-3).
- static int8 from x4_ship4_qat_static.npz, and the dynamic fallback of
  its uncalibrated sites: the flip class of tests/test_torch_quant.py's
  whole-forward bounds, mean |d| 0.01 / max 0.1 (a code that flips at a
  rounding boundary cascades; JAX's docstring says the same of its
  twin). The fp32 runs here read mean 0 to 1e-6.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu import quant_ops as jq
from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.core.params import BF16 as JBF16
from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.parallel.tiling import make_tiled_forward as jax_tiled_fwd

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.params import BF16
from codon_tpu_torch.kernels import quant as kq
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import MeshPool, make_tiled_forward
from codon_tpu_torch.parallel import quant as pq

from torch_port_common import CKPT_DIR, one_torch_thread, to_np, to_torch  # noqa: F401

STATIC = os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz")
ATOL, RTOL = 2e-4, 1e-3
STATIC_FLIP, DYN_FLIP = (0.01, 0.1), (0.03, 0.3)


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    p = MeshPool(4, device="cpu", timeout_s=60)
    yield p
    p.close()


def _data(seed, b=2, h=48, w=17):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, h, w, 1).astype(np.float32),
            rng.rand(b, h, w, 1).astype(np.float32))


def _flip_class(got, want, bounds=STATIC_FLIP):
    d = np.abs(to_np(got) - to_np(want))
    assert d.mean() <= bounds[0] and d.max() <= bounds[1], (d.mean(),
                                                            d.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathered_sample_scale_is_bitwise(pool, dtype):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 20, 13, 64).astype(np.float32) * 3)
    x[1] *= 0.01                       # another range in the second image
    x = x.to(dtype)
    want = tq._x_scale(x).float()
    got = pool.shard_map(pq.sample_scale_on_shard, pool.mesh(1, 4), x)
    assert tuple(got.shape) == (2, 4, 1, 1)
    assert torch.equal(got, want.expand(2, 4, 1, 1))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("mode", ["static", "dynamic", "int8", "window"])
def test_haloed_im2col_equals_padded_crop(k, mode):
    """The patches of a shard's rows, read through its neighbours' halo
    rows (zeros past the image's edges), are the SAME-padded patches of
    the whole tensor at those rows; so is the composed int8 conv."""
    rng = np.random.RandomState(2)
    n, h, w, c = 2, 11, 9, 32
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32) * 3)
    sc = torch.from_numpy(rng.rand(c).astype(np.float32) * 0.05 + 0.01)
    sx = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.05 + 0.01)
    args = {"static": (sc, None, 0, None), "dynamic": (None, sx, 0, None),
            "int8": (None, None, 0, None), "window": (None, None, 16, 16)}
    if mode in ("int8", "window"):
        x = kq.quantize_plain(x, sc)
    r = k // 2
    whole = kq.quant_im2col_plain(x, k, *args[mode]).reshape(n, h, w, -1)
    for a, b in ((0, 4), (4, 8), (8, 11)):
        rows = torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))[:, a:b + 2 * r]
        got = kq.quant_im2col_plain(rows, k, *args[mode], halo=r)
        want = whole[:, a:b]
        assert torch.equal(got.reshape(want.shape), want)
    if mode == "static":
        w8 = torch.randint(-127, 128, (k, k, c, 16), dtype=torch.int8)
        sw = torch.rand(16) * 1e-3
        full = kq.int8_conv(x, w8, sw, torch.float32, sc=sc)
        rows = torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))[:, 4:8 + 2 * r]
        got = kq.int8_conv(rows, w8, sw, torch.float32, sc=sc, halo=r)
        assert torch.equal(got, full[:, 4:8])


def test_haloed_im2col_short_halo_pads_the_rest():
    """0 < halo < k // 2: the rest of the radius is zero padding. A frame
    carrying one zero row above and below, read at k = 5 with halo 1, has
    the SAME-padded patches of the frame."""
    x = kq.quantize_plain(torch.randn(1, 8, 7, 16,
                                      generator=torch.Generator()
                                      .manual_seed(3)), torch.tensor(0.02))
    whole = kq.quant_im2col_plain(x, 5)
    framed = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    assert torch.equal(kq.quant_im2col_plain(framed, 5, halo=1), whole)
    with pytest.raises(ValueError, match="halo=3"):
        kq.quant_im2col_plain(framed, 5, halo=3)


def _half(tree):
    return jax.tree.map(lambda a: a * 0.5, tree)


def test_int8_tiled_matches_untiled(pool):
    """JAX's tests/test_quant_ops.py:59: dynamic int8 over sp = 4 against
    JAX's sharded int8 and the port's unsharded `Int8Ops`."""
    jv = jax_variant("codon")
    jparams = _half(jv.init(jax.random.PRNGKey(4)))
    d, c = _data(5)
    mask = np.ones_like(d)
    jout = np.asarray(jax_tiled_fwd(jv, 4, 1, ops_factory=jq.Int8ShardedOps)(
        jparams, d, c, jnp.asarray(mask)))
    v = get_variant("codon")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    td, tc, tm = to_torch(d), to_torch(c), to_torch(mask)
    out = make_tiled_forward(v, 4, 1, ops_factory=pq.Int8ShardedOps,
                             pool=pool)(params, td, tc, tm)
    ref = v.forward(params, td, tc, mask=tm, ops=tq.Int8Ops())
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=ATOL, rtol=RTOL)
    _flip_class(out, jout, DYN_FLIP)
    # pure dp takes the single-device backend on whole images, one image a
    # rank here: each equals the image run alone (a batch of two sums the
    # float convs in another order on the CPU, which flips codes)
    out = make_tiled_forward(v, 1, 2, local_ops=tq.Int8Ops(), pool=pool)(
        params, td, tc, tm)
    for i in range(2):
        alone = v.forward(params, td[i:i + 1], tc[i:i + 1],
                          mask=tm[i:i + 1], ops=tq.Int8Ops())
        np.testing.assert_allclose(to_np(out[i:i + 1]), to_np(alone),
                                   atol=ATOL, rtol=RTOL)


def _static_setup(dtypes, drop=()):
    tree = load_npz(STATIC)
    scales = {k: v for k, v in tree.pop("act_scales").items()
              if k not in drop}
    return tree, scales


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_static_int8_tiled_matches_untiled(pool, policy, dp, sp):
    """Int8StaticShardedOps (through scales_factory, the scales riding the
    parameter tree) against the port's unsharded Int8StaticOps and JAX's
    sharded static int8, in the flip class."""
    tdt = BF16 if policy == "bf16" else None
    tree, scales = _static_setup(tdt)
    v = get_variant("codon", tdt) if tdt else get_variant("codon")
    cdt = v.cfg.dtypes.compute_dtype
    params = params_from_numpy(tree, "cpu")
    tscales = params_from_numpy(scales, "cpu")
    d, c = _data(6, h=40, w=23)
    mask = np.ones_like(d)
    mask[1, 29:] = 0.0
    d, c = d * mask, c * mask
    td, tc, tm = to_torch(d), to_torch(c), to_torch(mask)
    factory = functools.partial(pq.static_int8_ops, compute_dtype=cdt)
    out = make_tiled_forward(v, sp, dp, scales_factory=factory, pool=pool)(
        dict(params, act_scales=tscales), td, tc, tm)
    ref = v.forward(params, td, tc, mask=tm,
                    ops=tq.Int8StaticOps(tscales, compute_dtype=cdt))
    _flip_class(out, ref)
    jv = jax_variant("codon", JBF16) if tdt else jax_variant("codon")
    jcdt = jv.cfg.dtypes.compute_dtype

    def jfactory(sc, axis_name, **kw):
        if axis_name:
            return jq.Int8StaticShardedOps(sc, axis_name=axis_name,
                                           compute_dtype=jcdt, **kw)
        return jq.Int8StaticOps(sc, compute_dtype=jcdt)

    jtree = jax_load_npz(STATIC)
    jsc = jtree.pop("act_scales")
    jout = np.asarray(jax_tiled_fwd(jv, sp, dp, scales_factory=jfactory)(
        dict(jtree, act_scales=jsc), d, c, jnp.asarray(mask)))
    _flip_class(out, jout)


def test_static_int8_uncalibrated_sites_use_the_gathered_scale(pool):
    """Sites missing from the scales fall back to dynamic scales, all-
    reduced over the shards; the handoffs of missing sites are identities,
    as unsharded."""
    tree, scales = _static_setup(None, drop=("conv3", "conv10", "gate_d"))
    v = get_variant("codon")
    params = params_from_numpy(tree, "cpu")
    tscales = params_from_numpy(scales, "cpu")
    d, c = _data(7, h=32, w=19)
    td, tc = to_torch(d), to_torch(c)
    tm = torch.ones_like(td)
    out = make_tiled_forward(v, 4, 1, scales_factory=pq.static_int8_ops,
                             pool=pool)(dict(params, act_scales=tscales),
                                        td, tc, tm)
    ref = v.forward(params, td, tc, mask=tm, ops=tq.Int8StaticOps(tscales))
    _flip_class(out, ref)


def test_fused_int8_tiled_matches_untiled(pool):
    """codon_fused's grouped int8 convs on a shard: the input quantized
    once, each group's channel window gathered through the halo rows."""
    tree, scales = _static_setup(None)
    v = get_variant("codon_fused")
    params = params_from_numpy(tree, "cpu")
    tscales = params_from_numpy(scales, "cpu")
    d, c = _data(8, h=24, w=21)
    td, tc = to_torch(d), to_torch(c)
    tm = torch.ones_like(td)
    out = make_tiled_forward(v, 2, 1, scales_factory=pq.static_int8_ops,
                             pool=pool)(dict(params, act_scales=tscales),
                                        td, tc, tm)
    ref = v.forward(params, td, tc, mask=tm, ops=tq.Int8StaticOps(tscales))
    _flip_class(out, ref)
    out = make_tiled_forward(v, 2, 1, ops_factory=pq.Int8ShardedOps,
                             pool=pool)(params, td, tc, tm)
    ref = v.forward(params, td, tc, mask=tm, ops=tq.Int8Ops())
    _flip_class(out, ref)
