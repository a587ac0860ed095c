"""The port's ops backend, dtype policy and checkpoint I/O against the JAX
package's."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codon_tpu.checkpoint import native as jnative
from codon_tpu.core.ops import XlaOps

from codon_tpu_torch.checkpoint import native as tnative
from codon_tpu_torch.core import params as tparams
from codon_tpu_torch.core.ops import TorchOps, conv2d_nhwc, hwio_to_oihw

from torch_port_common import CKPT_DIR, one_torch_thread, to_np, to_torch  # noqa: F401


def _masked_input(seed=0, n=2, h=13, w=11, c=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    m = np.zeros((n, h, w, 1), np.float32)
    m[0] = 1
    m[1, :7, :5] = 1
    return x * m, m


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_conv_matches_xla(k, masked):
    x, m = _masked_input(k)
    w = np.random.RandomState(10 + k).randn(k, k, 3, 4).astype(np.float32)
    mask = m if masked else None
    want = XlaOps(precision="highest").conv2d(
        jnp.asarray(x), jnp.asarray(w),
        mask=None if mask is None else jnp.asarray(mask))
    got = TorchOps().conv2d(to_torch(x), to_torch(w),
                            mask=None if mask is None else to_torch(mask))
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if masked:
        assert float(got[1, 7:].abs().max()) == 0.0


def test_conv_runs_in_the_input_dtype():
    x = torch.rand(1, 5, 5, 2, dtype=torch.bfloat16)
    w = torch.rand(3, 3, 2, 4)
    assert conv2d_nhwc(x, w).dtype == torch.bfloat16
    oihw = hwio_to_oihw(w)
    assert oihw.shape == (4, 2, 3, 3)
    assert torch.equal(oihw, w.permute(3, 2, 0, 1))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_global_pools_match_xla(masked):
    x, m = _masked_input(4)
    ops, jops = TorchOps(), XlaOps()
    tm = to_torch(m) if masked else None
    jm = jnp.asarray(m) if masked else None
    np.testing.assert_allclose(
        ops.global_avg(to_torch(x), tm).numpy(),
        np.asarray(jops.global_avg(jnp.asarray(x), jm)), atol=1e-6,
        rtol=1e-6)
    np.testing.assert_array_equal(
        ops.global_max(to_torch(x), tm).numpy(),
        np.asarray(jops.global_max(jnp.asarray(x), jm)))


def test_handoff_hooks_are_identities():
    x = torch.rand(1, 3, 3, 2)
    ops = TorchOps()
    assert ops.precommit(x, name="packed_d") is x
    assert ops.roundtrip(x, name="gate_d") is x
    assert ops.apply_mask(x) is x


def test_dtype_policies():
    assert tparams.DTYPE_POLICIES["fp32"].compute_dtype == torch.float32
    assert tparams.DTYPE_POLICIES["bf16"].compute_dtype == torch.bfloat16
    assert tparams.DTYPE_POLICIES["fp16"].compute_dtype == torch.float16
    for p in tparams.DTYPE_POLICIES.values():
        assert p.param_dtype == torch.float32
    assert "int8" not in tparams.DTYPE_POLICIES


def test_linear_init_bounds_and_layout():
    g = torch.Generator().manual_seed(0)
    w, b = tparams.linear_init(g, 128, 8, device="cpu")
    assert w.shape == (128, 8) and b.shape == (8,)
    bound = 1 / np.sqrt(128)
    assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
    assert float(w.abs().max()) > 0.8 * bound


def test_npz_round_trip_is_bitwise(tmp_path):
    tree = tnative.load_npz(os.path.join(CKPT_DIR, "x4_ship4.npz"))
    params = tnative.params_from_numpy(tree, "cpu")
    path = str(tmp_path / "ckpt")          # no extension: kept as given
    tnative.save_npz(path, params)
    assert os.path.exists(path)
    back = tnative.load_npz(path)
    jax_back = jnative.load_npz(path)
    for key, a in tnative._flatten(tree).items():
        b = tnative._flatten(back)[key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key
        np.testing.assert_array_equal(np.asarray(jnative._flatten(
            jax_back)[key]), a)


def test_load_matches_jax_and_keeps_unused_keys():
    path = os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz")
    tree = tnative.load_npz(path)
    flat = tnative._flatten(tree)
    jflat = jnative._flatten(jnative.load_npz(path))
    assert sorted(flat) == sorted(jflat)
    assert len([k for k in flat if k.startswith("act_scales/")]) == 18
    assert "attention_c5/w1" in flat
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(jflat[k]))
    params = tnative.params_from_numpy(tree, "cpu", torch.float32)
    assert params["act_scales"]["gate_d"].shape == (64,)
    assert params["cac"]["sp_w"].shape == (5, 5, 5, 2, 1)


def test_params_from_numpy_copies_and_casts():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    a.setflags(write=False)
    t = tnative.params_from_numpy({"x": {"y": a}}, "cpu", torch.bfloat16)
    assert t["x"]["y"].dtype == torch.bfloat16
    assert t["x"]["y"].tolist() == a.tolist()
    b = np.ones(3, np.float32)
    tb = tnative.params_from_numpy(b, "cpu")
    b[0] = 5.0
    assert float(tb[0]) == 1.0
    np.testing.assert_array_equal(to_np(tb), np.ones(3))


def _entry_point_calls(tmp_path):
    """Each public entry point that places tensors, called with its default
    device."""
    from codon_tpu_torch.data import io as tio
    from codon_tpu_torch.data import pipeline as tpipe
    from codon_tpu_torch.models import codon_net as tnet
    from codon_tpu_torch.models.variants import get_variant

    def one_sample():
        d = np.zeros((9, 7), np.uint8)
        return tio.Sample("a", d, d, None)

    def first_batch():
        root = str(tmp_path)
        for sub in ("input_depth", "input_color"):
            tio.imwrite_gray(os.path.join(root, sub, "a.png"),
                             np.zeros((9, 7), np.uint8))
        return next(tpipe.batched_loader(root, ["a"], with_label=False))

    def gen():
        return torch.Generator().manual_seed(0)

    return {
        "params_from_numpy": lambda: tnative.params_from_numpy(
            {"w": np.ones(3, np.float32)}),
        "conv_kernel_init": lambda: tparams.conv_kernel_init(gen(), 3, 3,
                                                             1, 2),
        "linear_init": lambda: tparams.linear_init(gen(), 4, 2),
        "init_codon_params": lambda: tnet.init_codon_params(gen()),
        "Variant.init": lambda: get_variant("codon").init(gen()),
        "make_batch": lambda: tpipe.make_batch([one_sample()]),
        "batched_loader": first_batch,
    }


@pytest.mark.parametrize("name", ["params_from_numpy", "conv_kernel_init",
                                  "linear_init", "init_codon_params",
                                  "Variant.init", "make_batch",
                                  "batched_loader"])
def test_entry_points_default_to_the_card(tmp_path, name):
    call = _entry_point_calls(tmp_path)[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        return
    out = call()
    leaf = next(iter(out.values())) if isinstance(out, dict) else out
    leaf = getattr(leaf, "depth", leaf)
    leaf = leaf[0] if isinstance(leaf, tuple) else leaf
    assert leaf.device.type == "cuda"
