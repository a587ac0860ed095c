"""The zoo's attention primitives (`codon_tpu_torch.models.attention`),
`generic_state_dict_to_flat`, the zoo's narrow int8 sites and int8
forwards, and `cli eval / train / info` of `zoo:` names, against
`codon_tpu` on the CPU.

Tolerances, and why:
- primitives, float32: atol 1e-5, rtol 1e-4, the JAX package's own
  primitive tolerance (tests/test_attention_primitives.py); the runs here
  read <= 2e-6.
- the narrow int8 sites (RCAN's 64 -> 4 -> 64 gate on a pooled vector,
  CGNL's grouped 32 -> 64 with 4 channels a group): bitwise in float32 and
  within one bf16 ulp in bfloat16, as every int8 site of
  tests/test_torch_quant.py (the same int8 codes; the zero padding adds
  exact zeros to the int32 sums).
- the int8 forwards at random init, 1 x 33 x 29, float32: one int8 code
  that flips at a rounding boundary cascades, as in
  tests/test_torch_quant.py. JAX's dynamic int8 forward against itself
  with its depth input scaled by 1 + 1e-6 N(0, 1) (seeds 0-2) moves by a
  mean of up to 4.1% of the output's mean |y| (rmcr_fuse_rmcr_rcan; 3.6%
  basenet_nlar) and a max of up to 27%. The bounds, mean 5% and max 30%
  of the output's mean |y|, hold the port in that class (it reads < 1e-5
  relative), and it must sit 4x closer to JAX's int8 forward than that
  sits to the float one, so it is in the int8 class. In bfloat16 the
  float forwards of the two packages already differ as much as bf16 from
  fp32 (different summation orders), so the bf16 int8 forward is held to
  the class of JAX's: its distance from JAX's fp32 int8 forward at most
  1.5x that of JAX's bf16 int8 forward.
- cli: the tolerances of tests/test_torch_cli_tools.py (fp32 eval: RMSE
  0.01, SSIM 1e-4, PNGs within one level on < 1% of pixels; int8 eval:
  RMSE 9, SSIM 0.01) and of
  tests/test_torch_train_cli.py (the first step's loss, float32, rtol
  1e-5 here for losses up to ~20; with --qat-static, fake quantization's
  flip class of tests/test_torch_train.py, rtol 0.02).
- cli int8 eval PNGs at random init: `--dtype int8` computes its float
  parts in bf16, and JAX's cli runs the forward jitted, whose fusions
  round bf16 differently from its op-by-op forward; the flips that
  follow move pixels across the clip, since random-init outputs spread
  far beyond [0, 1]. On a padded 2 x 64 x 32 batch, JAX's jitted int8
  forward against its own op-by-op one reads PNG mean 4.5 levels and 3.9%
  of pixels beyond 26 levels (basenet_nlar; the port equals the op-by-op
  forward there bitwise). The bounds: mean 3% of 255 levels, at most 5% of
  pixels beyond 26 levels.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu import cli as jcli
from codon_tpu import quant_ops as jq
from codon_tpu.checkpoint.torch_convert import (
    generic_state_dict_to_flat as jax_generic)
from codon_tpu.core.ops import XlaOps
from codon_tpu.core.params import DTYPE_POLICIES as JPOLICIES
from codon_tpu.models import attention as JA
from codon_tpu.models import zoo as jzoo
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch import cli as tcli
from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import params_from_numpy, save_npz
from codon_tpu_torch.checkpoint.torch_convert import (
    generic_state_dict_to_flat)
from codon_tpu_torch.core.ops import TorchOps
from codon_tpu_torch.core.params import DTYPE_POLICIES as TPOLICIES
from codon_tpu_torch.data.io import imread_gray
from codon_tpu_torch.kernels import quant as kq
from codon_tpu_torch.models import attention as TA
from codon_tpu_torch.models.variants import get_variant

from test_torch_quant import DTYPES, _same
from torch_port_common import (one_torch_thread, to_torch,  # noqa: F401
                               write_scale_dir)

PRIM_ATOL, PRIM_RTOL = 1e-5, 1e-4
N, H, W = 2, 9, 7
C = 64


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

def _rand(rng, *shape, scale=0.2):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _conv(p, rng, name, k, ci, co, bias=False, groups=1):
    p[f"{name}.weight"] = _rand(rng, k, k, ci // groups, co)
    if bias:
        p[f"{name}.bias"] = _rand(rng, co)


def _mlp(p, rng, name, ci, hid, co):
    for i, (a, b) in (("1", (ci, hid)), ("3", (hid, co))):
        p[f"{name}.mlp.{i}.weight"] = _rand(rng, a, b)
        p[f"{name}.mlp.{i}.bias"] = _rand(rng, b)


def _pam_params(p, rng, name, c):
    for n, co in (("query_conv", c // 8), ("key_conv", c // 8),
                  ("value_conv", c)):
        _conv(p, rng, f"{name}.{n}", 1, c, co, bias=True)
    p[f"{name}.gamma"] = np.asarray([0.5], np.float32)


def _cgnl_params(p, rng, name, c=C, planes=32, groups=8):
    for n in ("t", "p", "g"):
        _conv(p, rng, f"{name}.{n}", 1, c, planes)
    _conv(p, rng, f"{name}.z", 1, planes, c, groups=groups)
    p[f"{name}.gn.weight"] = 1 + _rand(rng, c)
    p[f"{name}.gn.bias"] = _rand(rng, c)


def _nonlocal_params(p, rng, name, c=C, planes=32):
    for n in ("t", "p", "g"):
        _conv(p, rng, f"{name}.{n}", 1, c, planes)
    _conv(p, rng, f"{name}.z", 1, planes, c)
    for n in ("running_mean", "weight", "bias"):
        p[f"{name}.bn4.{n}"] = _rand(rng, c)
    p[f"{name}.bn4.running_var"] = np.abs(_rand(rng, c)) + 0.5


def _sepnon_params(p, rng, name, c=C, inter=16):
    _conv(p, rng, f"{name}.conv5a.0", 3, c, inter)
    _conv(p, rng, f"{name}.conv5c.0", 3, c, inter)
    _pam_params(p, rng, f"{name}.sa", inter)
    p[f"{name}.sc.gamma"] = np.asarray([0.7], np.float32)
    _conv(p, rng, f"{name}.conv51.0", 3, inter, inter)
    _conv(p, rng, f"{name}.conv52.0", 3, inter, inter)
    _conv(p, rng, f"{name}.conv8.1", 1, inter, c, bias=True)


def _gate_params(p, rng, name, reduction):
    _mlp(p, rng, f"{name}.ChannelGate", C, C // reduction, C)
    _conv(p, rng, f"{name}.SpatialGate.spatial.conv", 5, 2, 1)


# name -> (params builder(p, rng), call(module, p, x, ops, mask)); the
# tuple forms are the CAC-style gates over a pair of towers
PRIMITIVES = {
    "channel_gate_scale": (
        lambda p, r: _mlp(p, r, "m", C, C // 16, C),
        lambda A, p, x, o, m: A.channel_gate_scale(p, "m", x, o, m)),
    "channel_gate_scale_pair": (
        lambda p, r: _mlp(p, r, "m", 2 * C, 2 * C // 16, C),
        lambda A, p, x, o, m: A.channel_gate_scale(p, "m", (x, x * -0.5),
                                                   o, m)),
    "spatial_gate_scale": (
        lambda p, r: _conv(p, r, "m.spatial.conv", 5, 2, 1),
        lambda A, p, x, o, m: A.spatial_gate_scale(p, "m", x, o, m)),
    "spatial_gate_scale_pair": (
        lambda p, r: _conv(p, r, "m.spatial.conv", 5, 2, 1),
        lambda A, p, x, o, m: A.spatial_gate_scale(p, "m", (x, x * 0.5),
                                                   o, m)),
    "res_cbam": (lambda p, r: _gate_params(p, r, "m", 8),
                 lambda A, p, x, o, m: A.res_cbam(p, "m", x, o, m)),
    "res_cbam_max": (lambda p, r: _gate_params(p, r, "m", 8),
                     lambda A, p, x, o, m: A.res_cbam(p, "m", x, o, m,
                                                      ("max",))),
    "cbam": (lambda p, r: _gate_params(p, r, "m", 16),
             lambda A, p, x, o, m: A.cbam(p, "m", x, o, m)),
    "ca_layer": (
        lambda p, r: (_conv(p, r, "m.conv_du.0", 1, C, C // 16, bias=True),
                      _conv(p, r, "m.conv_du.2", 1, C // 16, C, bias=True)),
        lambda A, p, x, o, m: A.ca_layer(p, "m", x, o, m)),
    "pam": (lambda p, r: _pam_params(p, r, "m", C),
            lambda A, p, x, o, m: A.pam(p, "m", x, o, m)),
    "cam": (lambda p, r: p.update({"m.gamma": np.asarray([0.5],
                                                         np.float32)}),
            lambda A, p, x, o, m: A.cam(p, "m", x * 0.1, o, m)),
    "sepnon": (lambda p, r: _sepnon_params(p, r, "m"),
               lambda A, p, x, o, m: A.sepnon(p, "m", x, o, m)),
    "spatial_cgnl": (lambda p, r: _cgnl_params(p, r, "m"),
                     lambda A, p, x, o, m: A.spatial_cgnl(p, "m", x, o, m)),
    "spatial_cgnl_scaled": (
        lambda p, r: _cgnl_params(p, r, "m"),
        lambda A, p, x, o, m: A.spatial_cgnl(p, "m", x, o, m,
                                             use_scale=True)),
    "nonlocal_bn": (lambda p, r: _nonlocal_params(p, r, "m"),
                    lambda A, p, x, o, m: A.nonlocal_bn(p, "m", x, o, m)),
}


def _prim_mask():
    m = np.ones((N, H, W, 1), np.float32)
    m[1, 5:] = 0.0
    m[1, :, 4:] = 0.0
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_primitive_matches_jax(name, masked):
    build, call = PRIMITIVES[name]
    rng = np.random.RandomState(sorted(PRIMITIVES).index(name))
    p = {}
    build(p, rng)
    x = rng.randn(N, H, W, C).astype(np.float32)
    m = _prim_mask() if masked else None
    if m is not None:
        x = x * m
    want = np.asarray(call(JA, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), XlaOps(),
                           None if m is None else jnp.asarray(m)))
    got = call(TA, params_from_numpy(p, "cpu"), to_torch(x), TorchOps(),
               None if m is None else to_torch(m))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=PRIM_ATOL,
                               rtol=PRIM_RTOL)


def test_masked_cgnl_batch_equals_each_image():
    """SpatialCGNL's global dot and GroupNorm over valid pixels only: the
    padded, masked batch equals each image run alone."""
    rng = np.random.RandomState(9)
    p = {}
    _cgnl_params(p, rng, "m")
    tp = params_from_numpy(p, "cpu")
    x = rng.randn(N, H, W, C).astype(np.float32) * _prim_mask()
    m = to_torch(_prim_mask())
    got = TA.spatial_cgnl(tp, "m", to_torch(x), TorchOps(), m)
    alone = TA.spatial_cgnl(tp, "m", to_torch(x[1:, :5, :4]), TorchOps())
    np.testing.assert_allclose(got[1, :5, :4].numpy(), alone[0].numpy(),
                               atol=PRIM_ATOL, rtol=PRIM_RTOL)
    assert not got[1, 5:].any() and not got[1, :, 4:].any()


def test_generic_state_dict_to_flat_matches_jax():
    rng = np.random.RandomState(3)
    sd = {"module.conv1.weight": rng.randn(8, 4, 3, 3),
          "module.fc.weight": rng.randn(5, 8),
          "module.fc.bias": rng.randn(5),
          "module.bn.running_var": rng.rand(8),
          "module.bn.num_batches_tracked": np.asarray(7),
          "plain.gamma": rng.randn(1)}
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)
                              if not k.endswith("tracked") else v)
          for k, v in sd.items()}
    got = generic_state_dict_to_flat(sd)
    want = jax_generic({k: v.numpy() for k, v in sd.items()})
    assert sorted(got) == sorted(want) == sorted(
        ["conv1.weight", "fc.weight", "fc.bias", "bn.running_var",
         "plain.gamma"])
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["conv1.weight"].shape == (3, 3, 4, 8)
    assert got["fc.weight"].shape == (8, 5)


# ---------------------------------------------------------------------------
# the narrow int8 sites
# ---------------------------------------------------------------------------

# site -> (x shape, HWIO w shape, groups)
NARROW = {"rcan_conv_du0": ((3, 1, 1, 64), (1, 1, 64, 4), 1),
          "rcan_conv_du2": ((3, 1, 1, 4), (1, 1, 4, 64), 1),
          "cgnl_z": ((2, 9, 7, 32), (1, 1, 4, 64), 8),
          "odd_3x3": ((2, 5, 3, 20), (3, 3, 20, 12), 1)}


def _narrow(site, seed):
    xs, ws, groups = NARROW[site]
    rng = np.random.RandomState(seed)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) * 0.1).astype(np.float32)
    sc = (np.abs(rng.randn(xs[3])) * 0.02 + 0.005).astype(np.float32)
    m = None
    if xs[1] > 1:
        m = np.ones(xs[:3] + (1,), np.float32)
        m[-1, xs[1] // 2:] = 0.0
        x = x * m
    return x, w, sc, m, groups


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("backend", ["dynamic", "static"])
@pytest.mark.parametrize("site", list(NARROW))
def test_narrow_int8_site_matches_jax(site, backend, dt):
    """The sites torch._int_mm and the kernels' widths refuse unpadded run
    zero-padded, with JAX's bits."""
    jdt, tdt = DTYPES[dt]
    x, w, sc, m, groups = _narrow(site, sorted(NARROW).index(site))
    if backend == "static":
        jops = jq.Int8StaticOps({"s": sc}, compute_dtype=jdt)
        tops = tq.Int8StaticOps({"s": sc}, compute_dtype=tdt)
    else:
        jops, tops = jq.Int8Ops(), tq.Int8Ops()
    want = jops.conv2d(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                       groups=groups, name="s",
                       mask=None if m is None else jnp.asarray(m))
    got = tops.conv2d(to_torch(x).to(tdt), to_torch(w), groups=groups,
                      name="s", mask=None if m is None else to_torch(m))
    assert got.dtype == tdt
    _same(got, want, dt)


@pytest.mark.parametrize("site", list(NARROW))
def test_narrow_site_calibrates_as_jax(site):
    x, w, _, m, groups = _narrow(site, 40)
    jops, tops = jq.CalibrationOps(), tq.CalibrationOps()
    jops.conv2d(jnp.asarray(x), jnp.asarray(w), groups=groups, name="s",
                mask=None if m is None else jnp.asarray(m))
    tops.conv2d(to_torch(x), to_torch(w), groups=groups, name="s",
                mask=None if m is None else to_torch(m))
    np.testing.assert_array_equal(tops.absmax["s"].numpy(),
                                  np.asarray(jops.absmax["s"]))


def test_narrow_site_keeps_the_kernel_route(monkeypatch):
    """A narrow site still runs quant_im2col -> int8_gemm ->
    dequant_epilogue (the kernel-backed wrappers, here on CPU tensors),
    on the padded widths: no switch to the plain route or a float conv."""
    seen = []
    for fn in ("quant_im2col", "dequant_epilogue"):
        real = getattr(kq, fn)

        def spy(*a, _real=real, _fn=fn, **kw):
            seen.append((_fn, tuple(a[0].shape)))
            return _real(*a, **kw)
        monkeypatch.setattr(kq, fn, spy)
    x, w, _, _, groups = _narrow("rcan_conv_du2", 41)
    tq.Int8Ops().conv2d(to_torch(x), to_torch(w))
    assert seen == [("quant_im2col", (3, 1, 1, 16)),
                    ("dequant_epilogue", (3, 64))]


# ---------------------------------------------------------------------------
# the zoo's int8 forwards
# ---------------------------------------------------------------------------

QH, QW = 33, 29
MEAN_B, MAX_B = 0.05, 0.3


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["rmcr_fuse_rmcr_rcan", "basenet_nlar"])
def test_zoo_int8_forward_tracks_jax(name, dt):
    rng = np.random.RandomState(0)
    d = rng.rand(1, QH, QW, 1).astype(np.float32)
    c = rng.rand(1, QH, QW, 1).astype(np.float32)
    jv = jax_variant("zoo:" + name, JPOLICIES[dt])
    j32 = jax_variant("zoo:" + name)
    p = jax.tree.map(np.asarray, jv.init(jax.random.PRNGKey(0)))
    dj, cj = jnp.asarray(d), jnp.asarray(c)
    want = np.asarray(jv.forward(p, dj, cj, ops=jq.Int8Ops()))
    got = get_variant("zoo:" + name, TPOLICIES[dt]).forward(
        params_from_numpy(p, "cpu"), to_torch(d), to_torch(c),
        ops=tq.Int8Ops())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    scale = np.abs(want).mean()
    if dt == "fp32":
        diff = np.abs(got - want)
        assert diff.mean() <= MEAN_B * scale and diff.max() <= MAX_B * scale
        flt = np.asarray(jv.forward(p, dj, cj))
        assert diff.mean() < 0.25 * np.abs(want - flt).mean()
    else:
        ref = np.asarray(j32.forward(p, dj, cj, ops=jq.Int8Ops()))
        assert (np.abs(got - ref).mean()
                <= 1.5 * np.abs(want - ref).mean() + 1e-6 * scale)


# ---------------------------------------------------------------------------
# cli eval / train / info with zoo names
# ---------------------------------------------------------------------------

SIZES = [(34, 29), (21, 30), (26, 19)]
STEP1 = re.compile(r"step\s+1\s+loss ([0-9.]+)")
# fake quantization's flip class (tests/test_torch_train.py)
QAT_LOSS_RTOL = 0.02
# int8 evals at random init, the class of JAX's own jit against its
# op-by-op forward (module docstring)
PNG_INT8_MEAN, PNG_INT8_FAR = 255 * 0.03, 0.05


@pytest.fixture(scope="module")
def zoo_data(tmp_path_factory):
    """A scale dir and, per net, JAX's zoo_init parameters as an .npz."""
    root = tmp_path_factory.mktemp("zoo_cli")
    data = str(root / "CODON_X4")
    names = write_scale_dir(data, SIZES, seed=23)
    ckpts = {}
    for n in ("basenet_nlar", "rmcr_fuse_rmcr_rcan"):
        ckpts[n] = str(root / f"{n}.npz")
        save_npz(ckpts[n], jax.tree.map(np.asarray, jzoo.zoo_init(
            n, jax.random.PRNGKey(4))))
    return data, names, ckpts


def _eval(mod, data, out, jpath, extra, device_args=("--device", "cpu")):
    assert mod.main(["eval", "--scale", "4", "--data-dir", data, "--batch",
                     "2", "--dtype", "fp32", "--out", out, "--json", jpath,
                     *extra, *device_args]) == 0
    with open(jpath) as f:
        return json.load(f)


@pytest.mark.parametrize("net,extra", [
    ("basenet_nlar", []), ("rmcr_fuse_rmcr_rcan", []),
    ("basenet_nlar", ["--dtype", "int8"]),
    ("rmcr_fuse_rmcr_rcan", ["--dtype", "int8"])],
    ids=["basenet_nlar", "rcan", "basenet_nlar-int8", "rcan-int8"])
def test_zoo_eval_matches_jax(tmp_path, capsys, zoo_data, net, extra):
    data, names, ckpts = zoo_data
    flags = ["--variant", "zoo:" + net, "--ckpt", ckpts[net], *extra]
    got = _eval(tcli, data, str(tmp_path / "t"), str(tmp_path / "t.json"),
                flags)
    tout = capsys.readouterr().out
    want = _eval(jcli, data, str(tmp_path / "j"), str(tmp_path / "j.json"),
                 flags, device_args=())
    jout = capsys.readouterr().out
    int8 = "int8" in extra
    if int8:
        banner = "int8: dynamic per-sample scales"
        assert banner in tout and banner in jout
    rmse_tol = 255 * (0.01 * 0.1) ** 0.5 + 1 if int8 else 0.01
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g["name"] == w["name"]
        assert g["rmse"] == pytest.approx(w["rmse"], abs=rmse_tol)
        assert g["ssim"] == pytest.approx(w["ssim"],
                                          abs=0.01 if int8 else 1e-4)
    for n in names:
        a = imread_gray(os.path.join(str(tmp_path / "t"), n + ".png"))
        b = imread_gray(os.path.join(str(tmp_path / "j"), n + ".png"))
        d = np.abs(a.astype(int) - b.astype(int))
        if int8:
            assert d.mean() <= PNG_INT8_MEAN
            assert float((d > 255 * 0.1 + 1).mean()) <= PNG_INT8_FAR
        else:
            assert d.max() <= 1 and float((d > 0).mean()) < 0.01


def test_zoo_eval_without_ckpt_takes_the_zoo_init(tmp_path, capsys,
                                                  zoo_data):
    """No --ckpt: the variant's own init (the zoo's flat tree), with TTA8
    and the card-side metrics' CPU path."""
    data, _, _ = zoo_data
    s = _eval(tcli, data, str(tmp_path / "t"), str(tmp_path / "t.json"),
              ["--variant", "zoo:basenet_non3", "--tta8",
               "--device-metrics"])
    assert s["images"] == 3 and s["tta_transforms"] == 8
    assert np.isfinite(s["mean_rmse"]) and np.isfinite(s["mean_ssim"])
    assert "WARNING: no --ckpt given" in capsys.readouterr().out


@pytest.mark.parametrize("net,extra", [
    ("rmcr_fuse_rmcr_rcan", []), ("basenet_nlar", ["--qat-static"])],
    ids=["rcan", "basenet_nlar-qat-static"])
def test_zoo_train_matches_jax(tmp_path, capsys, zoo_data, net, extra):
    """The first step's loss from the same warm start, and --qat-static's
    banner: the zoo's convs carry no site names, so calibration finds
    none, in both packages."""
    data, _, ckpts = zoo_data
    argv = ["train", "--data-dir", data, "--steps", "1", "--patch", "16",
            "--batch", "2", "--log-every", "1", "--dtype", "fp32",
            "--variant", "zoo:" + net, "--ckpt-in", ckpts[net], *extra]
    assert tcli.main([*argv, "--ckpt-out", str(tmp_path / "t.npz"),
                      "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert jcli.main([*argv, "--ckpt-out", str(tmp_path / "j.npz")]) == 0
    jout = capsys.readouterr().out
    np.testing.assert_allclose(float(STEP1.search(tout).group(1)),
                               float(STEP1.search(jout).group(1)),
                               rtol=QAT_LOSS_RTOL if extra else 1e-5)
    if extra:
        line = [ln for ln in jout.splitlines() if ln.startswith("QAT-static")]
        assert line == [ln for ln in tout.splitlines()
                        if ln.startswith("QAT-static")]
        assert "calibrated 0 conv sites" in line[0]
    tree = np.load(str(tmp_path / "t.npz"))
    assert sorted(tree.files) == sorted(np.load(str(tmp_path / "j.npz"))
                                        .files)


@pytest.mark.parametrize("net", ["rmcr_fuse_rmcr_rcan", "basenet_non2"])
def test_zoo_train_qat_runs(tmp_path, capsys, zoo_data, net):
    """--qat on a zoo net: the fake-quant backend over every zoo conv,
    the narrow sites included, trains with finite losses."""
    data, _, _ = zoo_data
    assert tcli.main(["train", "--data-dir", data, "--steps", "2",
                      "--patch", "16", "--batch", "2", "--log-every", "1",
                      "--variant", "zoo:" + net, "--qat", "--ckpt-out",
                      str(tmp_path / "q.npz"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
