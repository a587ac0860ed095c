"""The port's int8 backends (`codon_tpu_torch.quant_ops`, `kernels/quant.py`)
against `codon_tpu.quant_ops`, on the CPU, on the same numpy inputs.

Tolerances, and why:
- op level, float32: bitwise (max |d| = 0, the same int8 codes). The port
  repeats JAX's arithmetic op for op; the int8 products are exact integer
  sums in both.
- op level, bfloat16: the same int8 codes, outputs within one bf16 ulp (the
  int32 -> bf16 rounding is the only place the two may differ).
- teacher-forced, float32: every quantized conv site and handoff of one
  JAX forward, given JAX's recorded input, reproduced bitwise.
- whole forward, 1 x 33 x 29: a single int8 code that flips at a rounding
  boundary cascades through the five stages. JAX's static int8 forward
  against itself with its depth input scaled by 1 + 1e-6 N(0,1) moves by
  mean 0.0026-0.0028, max 0.030-0.036 (seeds 0-2); the dynamic one by
  mean 0.009-0.013, max 0.09-0.13. The bounds, mean 0.01 / max 0.1
  (static) and 0.03 / 0.3 (dynamic), hold the port in that class; the
  static port must also sit 4x closer to JAX's int8 forward than JAX's int8
  forward sits to the float one (mean 0.079), so it is in the int8 class
  and not the float one.
- calibration: the float forward's per-site absmax, rtol 1e-5 (float convs
  sum in another order).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codon_tpu import quant_ops as jq
from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.core.params import DTYPE_POLICIES as JPOLICIES
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.params import DTYPE_POLICIES as TPOLICIES
from codon_tpu_torch.kernels import quant as kq
from codon_tpu_torch.models.variants import get_variant

from torch_port_common import CKPT_DIR, one_torch_thread, to_torch  # noqa: F401

STATIC = os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz")
DYNAMIC = os.path.join(CKPT_DIR, "x4_ship4_qat.npz")
# the 13 quantized conv sites and 5 handoffs of x4_ship4_qat_static.npz
CONV_SITES = ("conv_input", "conv_input_c", "packed_d", "packed_c", "conv3",
              "conv6", "confuse", "confuse_c", "conv7", "packed_f",
              "conv10", "confuse_fuse", "conv11")
STATIC_SITES = CONV_SITES + jq.HANDOFF_SITES
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
XSHAPE = (2, 13, 11, 64)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _same(got, want, dtype_name="fp32"):
    """bitwise in fp32; within one ulp of the bf16 value in bf16."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype_name == "fp32":
        assert np.array_equal(g, w), float(np.abs(g - w).max())
    else:
        ulp = np.maximum(np.abs(w), 1e-30) * 2.0 ** -7
        assert np.all(np.abs(g - w) <= ulp), float(np.abs(g - w).max())


def _x(seed=0, shape=XSHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(shape=XSHAPE):
    m = np.ones(shape[:3] + (1,), np.float32)
    m[-1, shape[1] // 2:] = 0.0
    m[-1, :, shape[2] // 2:] = 0.0
    return m


def _scales(c, seed=1):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.randn(c)) * 0.02 + 0.005).astype(np.float32)


def _weights(k, ci=64, co=64, seed=2):
    return (np.random.RandomState(seed).randn(k, k, ci, co) * 0.1
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# op level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
def test_quantize_static_matches_jax(dt):
    jdt, tdt = DTYPES[dt]
    x, sc = _x(), _scales(64)
    # values on the grid's half-way points round half to even in both
    x[0, 0, 0, :8] = sc[:8] * np.array([0.5, 1.5, 2.5, -0.5, -2.5, 200,
                                        -200, 0], np.float32)
    want = np.asarray(jq.quantize_static(jnp.asarray(x).astype(jdt),
                                         jnp.asarray(sc)))
    got = tq.quantize_static(to_torch(x).to(tdt), to_torch(sc))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_x_scale_matches_jax(dt):
    jdt, tdt = DTYPES[dt]
    x = _x(3) * np.array([1.0, 7.3], np.float32)[:, None, None, None]
    want = jq._x_scale(jnp.asarray(x).astype(jdt))
    got = tq._x_scale(to_torch(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, 1, 1, 1)
    _same(got.float(), jnp.asarray(want).astype(jnp.float32))


def test_w_scales_matches_jax():
    w = _weights(5, seed=4)
    _same(tq._w_scales(to_torch(w)), jq._w_scales(jnp.asarray(w)))


@pytest.mark.parametrize("groups", [1, 2])
def test_fold_weights_matches_jax(groups):
    w = _weights(3, ci=64 // groups, co=128, seed=5)
    sc = _scales(64, seed=6)
    w8j, swj = jq._fold_weights(jnp.asarray(w), jnp.asarray(sc), groups)
    w8t, swt = tq._fold_weights(to_torch(w), to_torch(sc), groups)
    assert w8t.dtype == torch.int8 and np.array_equal(w8t.numpy(),
                                                      np.asarray(w8j))
    _same(swt, swj)


_SCALES = {"conv3": _scales(128, 7), "packed_d": _scales(64, 8),
           "conv6": _scales(128, 9), "conv3+conv6": _scales(256, 10)}


@pytest.mark.parametrize("name,groups", [
    ("conv3", 1),              # direct
    ("conv1", 1),              # alias of packed_d
    ("conv3+conv6", 2),        # compound, direct key wins
    ("conv6+conv3", 2),        # compound, concat of the parts
    ("conv1+conv3", 2),        # compound through an alias
    ("conv3+conv6", 3),        # parts do not match the groups
    ("conv9", 1),              # uncalibrated
    ("conv1", 2),              # grouped single name
    (None, 1),
], ids=["direct", "alias", "compound-direct", "compound-concat",
        "compound-alias", "compound-groups", "missing", "grouped-single",
        "none"])
def test_site_scale_matches_jax(name, groups):
    want = jq._site_scale({k: jnp.asarray(v) for k, v in _SCALES.items()},
                          name, groups)
    got = tq._site_scale({k: to_torch(v) for k, v in _SCALES.items()},
                         name, groups)
    if want is None:
        assert got is None
    else:
        _same(got, want)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_handoffs_match_jax(dt):
    jdt, tdt = DTYPES[dt]
    x, sc = _x(11), _scales(64, 12)
    scales = {"gate_d": sc, "packed_d": sc}
    jops = jq.Int8StaticOps(scales, compute_dtype=jdt)
    tops = tq.Int8StaticOps(scales, compute_dtype=tdt)
    xj, xt = jnp.asarray(x).astype(jdt), to_torch(x).to(tdt)
    rt = tops.roundtrip(xt, name="gate_d")
    assert rt.dtype == tdt
    _same(rt.float(), jops.roundtrip(xj, name="gate_d"))
    # an uncalibrated handoff is the identity
    assert tops.roundtrip(xt, name="stem_d") is xt
    pc = tops.precommit(xt, name="packed_d")
    assert pc.dtype == torch.int8
    assert np.array_equal(pc.numpy(),
                          np.asarray(jops.precommit(xj, name="packed_d")))
    assert tops.precommit(pc, name="packed_d") is pc       # idempotent
    assert tops.precommit(xt, name="packed_f") is xt       # uncalibrated
    with pytest.raises(ValueError, match="misrouted"):
        tops.roundtrip(pc, name="gate_d")


def _conv_pair(backend, dt, k, int8_input, masked, seed):
    """One conv through JAX's backend and the port's on the same inputs."""
    jdt, tdt = DTYPES[dt]
    x, w, sc = _x(seed), _weights(k, seed=seed + 1), _scales(64, seed + 2)
    m = _mask() if masked else None
    if backend == "static":
        jops = jq.Int8StaticOps({"s": sc}, compute_dtype=jdt)
        tops = tq.Int8StaticOps({"s": sc}, compute_dtype=tdt)
    else:
        jops, tops = jq.Int8Ops(), tq.Int8Ops()
    xj, xt = jnp.asarray(x).astype(jdt), to_torch(x).to(tdt)
    if int8_input:
        xj, xt = jops.precommit(xj, name="s"), tops.precommit(xt, name="s")
        assert xt.dtype == torch.int8
    want = jops.conv2d(xj, jnp.asarray(w), name="s",
                       mask=None if m is None else jnp.asarray(m))
    got = tops.conv2d(xt, to_torch(w), name="s",
                      mask=None if m is None else to_torch(m))
    assert got.dtype == tdt and tuple(got.shape) == XSHAPE
    return got, want


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("int8_input,masked", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["float", "float-masked", "int8", "int8-masked"])
def test_static_conv_matches_jax(k, dt, int8_input, masked):
    got, want = _conv_pair("static", dt, k, int8_input, masked, seed=20 + k)
    _same(got, want, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("masked", [False, True],
                         ids=["unmasked", "masked"])
def test_dynamic_conv_matches_jax(k, dt, masked):
    got, want = _conv_pair("dynamic", dt, k, False, masked, seed=30 + k)
    _same(got, want, dt)


def test_uncalibrated_site_is_dynamic_and_small_convs_stay_float():
    x, w = to_torch(_x(40)), to_torch(_weights(3, seed=41))
    ops = tq.Int8StaticOps({"s": _scales(64)})
    assert torch.equal(ops.conv2d(x, w, name="other"),
                       tq.Int8Ops().conv2d(x, w))
    with pytest.raises(ValueError, match="uncalibrated"):
        ops.conv2d(ops.precommit(x, name="s"), w, name="other")
    # <= 2 input or output channels: the float conv, as in JAX
    w2 = to_torch(_weights(3, ci=64, co=1, seed=42))
    assert tq._skip_quant(w2)
    assert torch.equal(ops.conv2d(x, w2, name="s"),
                       tq.TorchOps().conv2d(x, w2))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_int8_conv_is_the_integer_conv(k):
    """The patches' K order (dy, dx, c) matches the HWIO weights reshaped
    to (K, C_out): the int32 products equal an exact float64 conv of the
    codes."""
    rng = np.random.RandomState(50 + k)
    x8 = torch.from_numpy(rng.randint(-127, 128, (2, 9, 7, 32)).astype(
        np.int8))
    w8 = torch.from_numpy(rng.randint(-127, 128, (k, k, 32, 16)).astype(
        np.int8))
    acc = kq.int8_gemm(kq.quant_im2col(x8, k), w8.reshape(-1, 16))
    ref = torch.nn.functional.conv2d(
        x8.double().permute(0, 3, 1, 2), w8.double().permute(3, 2, 0, 1),
        padding=k // 2).permute(0, 2, 3, 1).reshape(-1, 16)
    assert torch.equal(acc.double(), ref)
    ones = torch.ones(16)
    out = kq.int8_conv(x8, w8, ones, torch.float32)
    assert torch.equal(out.reshape(-1, 16).double(), ref)


def test_int8_conv_blocks_match_one_block(monkeypatch):
    x = to_torch(_x(60, (5, 9, 7, 64)))
    w8, sw = tq._fold_weights(to_torch(_weights(5, seed=61)),
                              to_torch(_scales(64, 62)))
    sc, m = to_torch(_scales(64, 62)), to_torch(_mask((5, 9, 7, 64)))
    one = kq.int8_conv(x, w8, sw, torch.float32, sc=sc, mask=m)
    sx = tq._x_scale(x).float()
    one_dyn = kq.int8_conv(x, w8, sw, torch.float32, sx=sx, mask=m)
    # two images a block: three blocks of 2, 2 and 1
    monkeypatch.setattr(kq, "PATCH_BYTES_MAX", 2 * 9 * 7 * 25 * 64)
    assert kq.image_blocks(5, 9, 7, 25 * 64) == [(0, 2), (2, 4), (4, 5)]
    assert torch.equal(kq.int8_conv(x, w8, sw, torch.float32, sc=sc,
                                    mask=m), one)
    assert torch.equal(kq.int8_conv(x, w8, sw, torch.float32, sx=sx,
                                    mask=m), one_dyn)


@pytest.mark.parametrize("n,hw,kk,want", [
    (4, 384 * 480, 3200, [(0, 2), (2, 4)]),           # conv3 at b4: 2.36 GB
    (4, 384 * 480, 1600, [(0, 4)]),                   # packed: 1.18 GB
    (16, 384 * 480, 3200, [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15),
                           (15, 16)]),                # TTA8's 16 images
    (1, 4096 * 4096, 3200, [(0, 1)]),                 # one image a block
])
def test_image_blocks_keep_patches_under_the_limit(n, hw, kk, want):
    blocks = kq.image_blocks(n, hw, 1, kk)
    assert blocks == want
    assert all((j - i) * hw * kk <= kq.PATCH_BYTES_MAX or j - i == 1
               for i, j in blocks)


def test_int8_gemm_checks_the_card_shape_rules():
    a = torch.zeros((17, 16), dtype=torch.int8)
    assert kq.int8_gemm(a, torch.zeros((16, 8), dtype=torch.int8)).dtype \
        == torch.int32
    for aa, bb in (((16, 16), (16, 8)), ((17, 12), (12, 8)),
                   ((17, 16), (16, 4))):
        with pytest.raises(ValueError, match="_int_mm needs"):
            kq.int8_gemm(torch.zeros(aa, dtype=torch.int8),
                         torch.zeros(bb, dtype=torch.int8))
    with pytest.raises(ValueError, match="impl"):
        kq.int8_conv(torch.zeros((1, 5, 5, 16)),
                     torch.zeros((1, 1, 16, 8), dtype=torch.int8),
                     torch.ones(8), torch.float32, sc=torch.ones(16),
                     impl="cuda")
    with pytest.raises(ValueError, match="quant_impl"):
        tq.Int8Ops(quant_impl="kernel")


def test_plain_epilogue_rounds_to_the_activation_dtype_first():
    """round_to(bf16, acc) * sw.bf16: the int32 is rounded to bf16 before
    the scale multiplies it, as JAX's conv hands back a bf16 accumulator."""
    acc = torch.tensor([[257, 1025, -3, 2 ** 24 + 1, 5, 6, 7, 8]] * 2,
                       dtype=torch.int32)
    sw = torch.full((8,), 0.1)
    got = kq.dequant_epilogue_plain(acc, sw, torch.bfloat16, (1, 1, 2))
    want = acc.float().to(torch.bfloat16) * sw.to(torch.bfloat16)
    assert torch.equal(got.reshape(2, 8), want)
    assert float(got[0, 0, 0, 0]) != float(
        (acc[0, 0].float() * 0.1).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# teacher-forced: every site of one JAX forward
# ---------------------------------------------------------------------------

def _recording(base):
    class Recording(base):
        """Records each quantized conv's and handoff's input, weight,
        mask and output during one (eager) JAX forward."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []

        def conv2d(self, x, w, *, padding="SAME", mask=None, groups=1,
                   name=None):
            out = super().conv2d(x, w, padding=padding, mask=mask,
                                 groups=groups, name=name)
            if not jq._skip_quant(w):
                self.calls.append(("conv", name, x, w, mask, out))
            return out

        def precommit(self, x, name=None):
            out = super().precommit(x, name=name)
            self.calls.append(("precommit", name, x, None, None, out))
            return out

        def roundtrip(self, x, name=None):
            out = super().roundtrip(x, name=name)
            self.calls.append(("roundtrip", name, x, None, None, out))
            return out
    return Recording


H, W = 33, 29


def _image(seed=0, n=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, H, W, 1).astype(np.float32),
            rng.rand(n, H, W, 1).astype(np.float32))


def _ckpt(path):
    """-> (JAX tree, act_scales or None, port tree): the same file read by
    each package's loader."""
    jt = jax_load_npz(path)
    sc = jt.pop("act_scales", None)
    tt = load_npz(path)
    tt.pop("act_scales", None)
    return jt, sc, tt


@pytest.fixture(scope="module")
def recorded():
    """{"static" | "dynamic": calls} of one fp32 JAX forward at 1 x 33 x
    29, masked to its top-left 30 x 26."""
    d, c = _image(0)
    m = np.zeros((1, H, W, 1), np.float32)
    m[:, :30, :26] = 1.0
    out = {}
    for kind, path in (("static", STATIC), ("dynamic", DYNAMIC)):
        jt, sc, _ = _ckpt(path)
        ops = (_recording(jq.Int8StaticOps)(sc) if kind == "static"
               else _recording(jq.Int8Ops)())
        jax_variant("codon").forward(jt, jnp.asarray(d), jnp.asarray(c),
                                     mask=jnp.asarray(m), ops=ops)
        out[kind] = (ops.calls, sc)
    return out


def _replay(kind, site, recorded):
    calls, sc = recorded[kind]
    tops = (tq.Int8StaticOps(sc) if kind == "static" else tq.Int8Ops())
    mine = [cl for cl in calls if cl[1] == site and
            (kind == "static" or cl[0] == "conv")]
    assert mine, f"site {site} was not called"
    for what, _, x, w, mask, want in mine:
        xt = to_torch(np.array(x))
        if what == "conv":
            got = tops.conv2d(xt, to_torch(np.array(w)), name=site,
                              mask=None if mask is None
                              else to_torch(np.array(mask)))
        else:
            got = getattr(tops, what)(xt, name=site)
        want = np.array(want)
        assert got.dtype == to_torch(want).dtype, (what, site)
        assert np.array_equal(got.numpy(), want), (
            what, site, float(np.abs(got.double().numpy() -
                                     want.astype(np.float64)).max()))
    return mine


def test_recorded_sites_are_the_checkpoint_sites(recorded):
    calls, sc = recorded["static"]
    assert sorted(sc) == sorted(STATIC_SITES)
    assert {cl[1] for cl in calls if cl[0] == "conv"} == set(CONV_SITES)
    assert {cl[1] for cl in calls if cl[0] == "roundtrip"} == \
        set(jq.HANDOFF_SITES)
    dyn, _ = recorded["dynamic"]
    assert {cl[1] for cl in dyn if cl[0] == "conv"} == set(CONV_SITES)


@pytest.mark.parametrize("site", STATIC_SITES)
def test_static_site_reproduces_jax(site, recorded):
    mine = _replay("static", site, recorded)
    if site.startswith("packed"):
        # the stage-boundary handoff hands these sites int8 input
        assert any(what == "conv" and np.asarray(x).dtype == np.int8
                   for what, _, x, *_ in mine)


@pytest.mark.parametrize("site", CONV_SITES)
def test_dynamic_site_reproduces_jax(site, recorded):
    _replay("dynamic", site, recorded)


# ---------------------------------------------------------------------------
# the whole int8 forward
# ---------------------------------------------------------------------------

BOUNDS = {"static": (0.01, 0.1), "dynamic": (0.03, 0.3)}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_int8_forward_tracks_jax(kind, dt):
    jt, sc, tt = _ckpt(STATIC if kind == "static" else DYNAMIC)
    d, c = _image(1)
    jv, tv = jax_variant("codon", JPOLICIES[dt]), get_variant(
        "codon", TPOLICIES[dt])
    jdt, tdt = DTYPES[dt]
    if kind == "static":
        jops = jq.Int8StaticOps(sc, compute_dtype=jdt)
        tops = tq.Int8StaticOps(sc, compute_dtype=tdt)
    else:
        jops, tops = jq.Int8Ops(), tq.Int8Ops()
    want = np.asarray(jv.forward(jt, jnp.asarray(d), jnp.asarray(c),
                                 ops=jops))
    got = tv.forward(params_from_numpy(tt, "cpu"), to_torch(d), to_torch(c),
                     ops=tops)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, H, W, 1)
    diff = np.abs(got.numpy() - want)
    mean_b, max_b = BOUNDS[kind]
    assert diff.mean() <= mean_b and diff.max() <= max_b, (diff.mean(),
                                                           diff.max())
    if kind == "static":
        flt = np.asarray(jv.forward(jt, jnp.asarray(d), jnp.asarray(c)))
        assert diff.mean() < 0.25 * np.abs(want - flt).mean()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibrate_act_scales_matches_jax():
    import jax
    jv, tv = jax_variant("codon"), get_variant("codon")
    params = jax.tree.map(np.asarray, jv.init(jax.random.PRNGKey(0)))
    batches = []
    for i in range(2):
        d, c = _image(10 + i)
        m = None
        if i:
            m = np.zeros((1, H, W, 1), np.float32)
            m[:, :30, :26] = 1.0
        batches.append((d, c, m))
    want = jq.calibrate_act_scales(
        jv.forward, params,
        [(jnp.asarray(d), jnp.asarray(c), None if m is None
          else jnp.asarray(m)) for d, c, m in batches])
    got = tq.calibrate_act_scales(
        tv.forward, params_from_numpy(params, "cpu"),
        [(to_torch(d), to_torch(c), None if m is None else to_torch(m))
         for d, c, m in batches])
    assert sorted(got) == sorted(want) == sorted(STATIC_SITES)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# grouped convs: the merged-tower forward's
# ---------------------------------------------------------------------------

# (k, C_in, C_out) of codon_fused's grouped quantized sites, at groups=2:
# conv_input+conv_input_c / conv1+conv5, conv2+conv4, conv3+conv6,
# confuse+confuse_c
GROUPED = [(3, 128, 128), (5, 128, 128), (5, 256, 256), (1, 256, 128)]


def _grouped_pair(backend, dt, k, ci, co, int8_input, masked, seed):
    jdt, tdt = DTYPES[dt]
    shape = XSHAPE[:3] + (ci,)
    x = _x(seed, shape)
    w = _weights(k, ci=ci // 2, co=co, seed=seed + 1)
    sc = _scales(ci, seed + 2)
    m = _mask(shape) if masked else None
    name = "a+b"
    if backend == "static":
        jops = jq.Int8StaticOps({name: sc}, compute_dtype=jdt)
        tops = tq.Int8StaticOps({name: sc}, compute_dtype=tdt)
    else:
        jops, tops = jq.Int8Ops(), tq.Int8Ops()
    xj, xt = jnp.asarray(x).astype(jdt), to_torch(x).to(tdt)
    if int8_input:
        xj = jq.quantize_static(xj, jnp.asarray(sc))
        xt = tq.quantize_static(xt, to_torch(sc))
    want = jops.conv2d(xj, jnp.asarray(w), groups=2, name=name,
                       mask=None if m is None else jnp.asarray(m))
    got = tops.conv2d(xt, to_torch(w), groups=2, name=name,
                      mask=None if m is None else to_torch(m))
    assert got.dtype == tdt and tuple(got.shape) == shape[:3] + (co,)
    return got, want


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("k,ci,co", GROUPED,
                         ids=["3x3-128", "5x5-128", "5x5-256", "1x1-256"])
@pytest.mark.parametrize("backend,int8_input,masked", [
    ("static", False, False), ("static", False, True),
    ("static", True, True), ("dynamic", False, False),
    ("dynamic", False, True)],
    ids=["static", "static-masked", "static-int8-masked", "dynamic",
         "dynamic-masked"])
def test_grouped_conv_matches_jax(backend, k, ci, co, dt, int8_input,
                                  masked):
    """groups=2: bitwise in fp32, one bf16 ulp in bf16, as the ungrouped
    convs (the same int8 codes, the int32 sums of each group exact)."""
    got, want = _grouped_pair(backend, dt, k, ci, co, int8_input, masked,
                              seed=70 + k + ci // 64)
    _same(got, want, dt)


def test_grouped_int8_conv_is_two_convs():
    """int8_conv(groups=2) equals each group's ungrouped int8_conv on its
    channel window, concatenated: the window arguments of the plain
    gather and epilogue select the right channels."""
    rng = np.random.RandomState(80)
    x = to_torch(_x(81, (2, 9, 7, 128)))
    w8 = torch.from_numpy(rng.randint(-127, 128, (3, 3, 64, 96)).astype(
        np.int8))
    sw = to_torch(_scales(96, 82))
    sc = to_torch(_scales(128, 83))
    m = to_torch(_mask((2, 9, 7, 128)))
    got = kq.int8_conv(x, w8, sw, torch.float32, sc=sc, mask=m, groups=2)
    parts = [kq.int8_conv(x[..., g * 64:(g + 1) * 64].contiguous(),
                          w8[..., g * 48:(g + 1) * 48].contiguous(),
                          sw[g * 48:(g + 1) * 48].contiguous(),
                          torch.float32, sc=sc[g * 64:(g + 1) * 64]
                          .contiguous(), mask=m) for g in range(2)]
    assert torch.equal(got, torch.cat(parts, -1))


def test_calibration_records_compound_sites():
    """CalibrationOps records a grouped site under its compound name, over
    all C input channels, as JAX's does: conv3+conv6 as (256,)."""
    import jax
    params = jax.tree.map(np.asarray, jax_variant("codon").init(
        jax.random.PRNGKey(1)))
    d, c = _image(20)
    want = jq.calibrate_act_scales(
        jax_variant("codon_fused").forward, params,
        [(jnp.asarray(d), jnp.asarray(c), None)])
    got = tq.calibrate_act_scales(
        get_variant("codon_fused").forward, params_from_numpy(params, "cpu"),
        [(to_torch(d), to_torch(c), None)])
    assert sorted(got) == sorted(want)
    assert got["conv3+conv6"].shape == (256,)
    assert got["conv_input+conv_input_c"].shape == (128,)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("variant", ["codon_fused", "rmcr_fuse_rmcr"])
def test_other_int8_forwards_track_jax(variant, kind, dt):
    """The merged-tower forward (its compound sites resolve through the
    packed sites' scales, no recalibration) and the sequential one, int8,
    in the flip class of test_int8_forward_tracks_jax."""
    jt, sc, tt = _ckpt(STATIC if kind == "static" else DYNAMIC)
    d, c = _image(2)
    jv, tv = jax_variant(variant, JPOLICIES[dt]), get_variant(
        variant, TPOLICIES[dt])
    jdt, tdt = DTYPES[dt]
    if kind == "static":
        jops = jq.Int8StaticOps(sc, compute_dtype=jdt)
        tops = tq.Int8StaticOps(sc, compute_dtype=tdt)
    else:
        jops, tops = jq.Int8Ops(), tq.Int8Ops()
    want = np.asarray(jv.forward(jt, jnp.asarray(d), jnp.asarray(c),
                                 ops=jops))
    got = tv.forward(params_from_numpy(tt, "cpu"), to_torch(d), to_torch(c),
                     ops=tops)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, H, W, 1)
    diff = np.abs(got.numpy() - want)
    mean_b, max_b = BOUNDS[kind]
    assert diff.mean() <= mean_b and diff.max() <= max_b, (diff.mean(),
                                                           diff.max())
    if kind == "static":
        flt = np.asarray(jv.forward(jt, jnp.asarray(d), jnp.asarray(c)))
        assert diff.mean() < 0.25 * np.abs(want - flt).mean()
