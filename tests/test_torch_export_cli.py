"""`cli export` of the port against `codon_tpu.cli export`, on the CPU.

Mirrors tests/test_cli.py's test_export_cli and test_export_scale_cond:
the same tiny checkpoint (JAX's init, halved) goes through both CLIs; the
two artifacts answer the same request within 5e-4 abs (float32, the
model-parity bound), and the summary lines agree but for the output path
and the size. The int8 branch (static scales from the checkpoint, or the
dynamic backend without them) is held to the port's live forward bitwise.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

from codon_tpu import cli as jcli
from codon_tpu.checkpoint.native import save_npz as jax_save_npz
from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.serve import load_exported as jax_load

from codon_tpu_torch import cli as tcli
from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.params import BF16
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.quant_ops import Int8Ops, Int8StaticOps
from codon_tpu_torch.serve import load_exported

from torch_port_common import CKPT_DIR, one_torch_thread  # noqa: F401

HW = ("--height", "24", "--width", "20")


def _said(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


def _summary(said):
    """The summary line up to the output path."""
    return said.strip().splitlines()[-1].split(" -> ")[0]


@pytest.mark.parametrize("variant,extra", [
    ("codon", ()), ("codon_sc", ("--scale", "4", "--scale-cond"))],
    ids=["codon", "codon_sc-scale-cond"])
def test_export_cli_matches_jax(variant, extra, tmp_path):
    """codon_sc with --scale-cond: callers feed 1-channel depth, the
    artifact appends the scale/16 plane."""
    ck = str(tmp_path / "t.npz")
    jax_save_npz(ck, jax.tree.map(
        lambda w: w * 0.5, jax_variant(variant).init(jax.random.PRNGKey(0))))
    args = ["export", "--ckpt", ck, *HW, "--dtype", "fp32", "--variant",
            variant, *extra]
    jart, tart = str(tmp_path / "m.codonx"), str(tmp_path / "m.pt2")
    jsaid = _said(jcli, [*args, "--out", jart])
    tsaid = _said(tcli, [*args, "--out", tart, "--device", "cpu"])
    assert _summary(tsaid) == _summary(jsaid) == (
        f"exported {variant} 20x24 [fp32] for platform 'cpu'")
    fn = load_exported(tart, "cpu")
    assert fn.meta["scale_cond"] == (0.25 if extra else None)
    rng = np.random.RandomState(0)
    d = rng.rand(2, 24, 20, 1).astype(np.float32)
    c = rng.rand(2, 24, 20, 1).astype(np.float32)
    got = fn(d, c)
    assert got.shape == (2, 24, 20, 1) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_load(jart)(d, c)),
                               atol=5e-4, rtol=0)


@pytest.mark.parametrize("ckpt,banner", [
    ("x4_ship4_qat_static.npz",
     "int8: static scales from checkpoint (18 sites) baked into the "
     "artifact"),
    ("x4_ship4_qat.npz", "int8: dynamic per-sample scales")],
    ids=["static", "dynamic"])
def test_export_cli_int8_equals_live(ckpt, banner, tmp_path):
    """--dtype int8 --mask --tta: the banner of `codon_tpu.cli export`, and
    the artifact equal to the live TTA4 int8 forward (bf16) bitwise."""
    path = os.path.join(CKPT_DIR, ckpt)
    art = str(tmp_path / "m8.pt2")
    said = _said(tcli, ["export", "--ckpt", path, "--out", art, *HW,
                        "--dtype", "int8", "--mask", "--tta", "--device",
                        "cpu"])
    assert banner in said
    assert _summary(said) == ("exported codon 20x24 [int8+tta4] for "
                              "platform 'cpu'")
    fn = load_exported(art, "cpu")
    assert fn.meta["tta"] == 4 and fn.meta["mask"]
    tree = load_npz(path)
    scales = tree.pop("act_scales", None)
    ops = (Int8StaticOps(scales, compute_dtype=torch.bfloat16)
           if scales is not None else Int8Ops())
    assert fn.meta["ops"] == type(ops).__name__
    v = get_variant("codon", BF16)
    params = params_from_numpy(tree, "cpu")
    live = make_tta_forward(
        lambda p, a, b, m: v.forward(p, a, b, mask=m, ops=ops))
    rng = np.random.RandomState(1)
    d = torch.from_numpy(rng.rand(2, 24, 20, 1).astype(np.float32))
    c = torch.from_numpy(rng.rand(2, 24, 20, 1).astype(np.float32))
    m = torch.ones_like(d)
    m[1, 17:] = 0
    assert torch.equal(fn(d * m, c * m, m), live(params, d * m, c * m, m))


def test_export_matrix_jobs_and_record(tmp_path, monkeypatch, capsys):
    """The matrix of scripts/export_matrix.py: the same five jobs and
    checkpoint order, and each job's JSON line with --load-check (run here
    for its first job at a small size, on the CPU)."""
    from codon_tpu_torch import export_matrix
    assert export_matrix.JOBS == [(4, 0), (8, 0), (16, 0), (4, 4), (4, 8)]
    assert (export_matrix.H, export_matrix.W) == (370, 463)
    for scale in (4, 8, 16):
        assert os.path.basename(export_matrix.best_ckpt(scale)) == (
            f"x{scale}_qat_static2.npz")
    monkeypatch.setattr(export_matrix, "JOBS", [(4, 0)])
    monkeypatch.setattr(export_matrix, "H", 20)
    monkeypatch.setattr(export_matrix, "W", 17)
    assert export_matrix.main(["--load-check", "--out-dir", str(tmp_path),
                               "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["artifact"] == "codon_x4_17x20_int8.pt2"
    assert (rec["scale"], rec["tta"], rec["platform"], rec["card"]) == (
        4, 0, "cpu", None)
    assert rec["size_mb"] > 0 and os.path.exists(tmp_path / rec["artifact"])
    assert all(rec[k] > 0 for k in ("export_s", "load_s", "first_call_s",
                                    "steady_call_s"))
