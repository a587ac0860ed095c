"""`python -m codon_tpu_torch.cli eval` against `codon_tpu.cli eval`, on the
CPU, on a synthetic scale dir, with the same committed checkpoint."""
import json
import os

import numpy as np
import pytest
import torch

from codon_tpu import cli as jcli

from codon_tpu_torch import cli as tcli
from codon_tpu_torch.data.io import imread_gray

from torch_port_common import CKPT_DIR, one_torch_thread, write_scale_dir  # noqa: F401

# two sizes, so batches are padded and masked; 5 images at batch 2 leave
# a short last batch that is filled up
SIZES = [(34, 29), (34, 29), (21, 30), (34, 29), (26, 19)]


def _eval(mod, data, out, jpath, extra, device_args):
    rc = mod.main(["eval", "--scale", "4", "--data-dir", data, "--batch",
                   "2", "--dtype", "fp32", "--out", out, "--json", jpath,
                   *extra, *device_args])
    assert rc == 0
    with open(jpath) as f:
        return json.load(f)


@pytest.mark.parametrize("ckpt,variant,extra", [
    ("x4_ship4.npz", "codon", []),
    ("x4_holdout_sc.npz", "codon_sc", ["--scale-cond"]),
])
def test_eval_matches_jax(tmp_path, ckpt, variant, extra):
    data = str(tmp_path / "CODON_X4")
    names = write_scale_dir(data, SIZES)
    extra = ["--ckpt", os.path.join(CKPT_DIR, ckpt), "--variant", variant,
             *extra]
    got = _eval(tcli, data, str(tmp_path / "t_out"), str(tmp_path / "t.json"),
                extra, ["--device", "cpu"])
    want = _eval(jcli, data, str(tmp_path / "j_out"),
                 str(tmp_path / "j.json"), extra, [])
    assert set(got) == set(want)
    assert got["images"] == want["images"] == len(names)
    assert [r["name"] for r in got["per_image"]] == \
        [r["name"] for r in want["per_image"]] == names
    for g, w in zip(got["per_image"], want["per_image"]):
        # uint8 truncation of outputs that agree to ~1e-5 flips a pixel
        # lying on an integer boundary by one level (one pixel of one image
        # here moves its RMSE by 1e-3): allow a few such pixels
        assert g["rmse"] == pytest.approx(w["rmse"], abs=0.01)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=1e-4)
    for n in names:
        a = imread_gray(os.path.join(tmp_path, "t_out", n + ".png"))
        b = imread_gray(os.path.join(tmp_path, "j_out", n + ".png"))
        assert a.shape == b.shape
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
        assert float((a != b).mean()) < 0.01


def test_eval_no_save_and_log(tmp_path, capsys):
    data = str(tmp_path / "d")
    write_scale_dir(data, SIZES[:3])
    out = str(tmp_path / "out")
    log = str(tmp_path / "logs" / "eval.txt")
    rc = tcli.main(["eval", "--data-dir", data, "--no-save", "--out", out,
                    "--log", log, "--device", "cpu", "--batch", "4",
                    "--dtype", "bf16"])
    assert rc == 0
    assert not os.path.exists(out)
    text = open(log).read()
    assert "random init" in text and "images/sec" in text
    assert text in capsys.readouterr().out


def test_eval_default_device_is_the_card():
    args = tcli._build_argparser().parse_args(["eval"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            tcli._device(args.device)


@pytest.mark.parametrize("flag", ["--tile-devices=2", "--dp-devices=2"])
def test_unported_flags_are_not_in_the_parser(flag, capsys):
    """The mesh flags belong to eval alone: sharded training is not ported
    (ROADMAP A13b), so train refuses them, as JAX's train does."""
    with pytest.raises(SystemExit):
        tcli._build_argparser().parse_args(["train", flag])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--tile-devices=2", "--dp-devices=2"])
def test_mesh_flags_parse_counts_and_refuse_malformed(flag, capsys):
    """eval's mesh flags (tests/test_torch_parallel_cli.py runs them): each
    parses to its count, and a malformed count is refused."""
    args = tcli._build_argparser().parse_args(["eval", flag])
    assert getattr(args, flag[2:].split("=")[0].replace("-", "_")) == 2
    with pytest.raises(SystemExit):
        tcli._build_argparser().parse_args(["eval", flag.replace("2", "x")])
    assert "invalid int value" in capsys.readouterr().err


# int8 eval against JAX's: the flip class of tests/test_torch_quant.py's
# whole-forward bounds on the [0, 1] output (static: mean |d| <= 0.01,
# max <= 0.1; dynamic 0.03 / 0.3; an ensemble of one of each averages them,
# 0.02 / 0.2), carried to what eval writes. On the PNGs, uint8 truncation
# adds at most one level a pixel: mean |d| <= 255 mean + 1, max <= 255 max
# + 1. Per image, |RMSE_a - RMSE_b| <= RMS(a - b) (triangle inequality on
# the same valid pixels) <= 255 sqrt(mean * max) + 1, since sum d^2 <= max
# |d| sum |d|. SSIM within 0.01 (not derived; the runs here read 3e-4).
INT8_BOUNDS = {"static": (0.01, 0.1), "ensemble": (0.02, 0.2),
               "dynamic": (0.03, 0.3)}
INT8_BANNERS = {
    "static": "int8: static per-channel scales from checkpoint (18 conv "
              "sites)",
    "ensemble": "int8: per-member scales [static, dynamic]",
    "dynamic": "int8: dynamic per-sample scales (checkpoint carries no "
               "act_scales; train --qat-static to add them)"}


@pytest.mark.parametrize("kind,extra", [
    ("static", ["--ckpt", "x4_ship4_qat_static.npz"]),
    ("ensemble", ["--ckpt", "x4_ship4_qat_static.npz,x4_ship4_qat.npz",
                  "--tta"]),
    ("dynamic", ["--ckpt", "x4_holdout_sc.npz", "--variant", "codon_sc",
                 "--scale-cond"]),
], ids=["static", "ensemble-static-dynamic-tta", "dynamic-scale-cond"])
def test_int8_eval_matches_jax(tmp_path, capsys, kind, extra):
    data = str(tmp_path / "CODON_X4")
    names = write_scale_dir(data, TTA_SIZES, seed=5)
    extra = [",".join(os.path.join(CKPT_DIR, c) for c in a.split(","))
             if a.endswith(".npz") else a for a in extra]
    # a later --dtype wins over _eval's --dtype fp32
    extra = ["--dtype", "int8", *extra]
    capsys.readouterr()
    got = _eval(tcli, data, str(tmp_path / "t_out"), str(tmp_path / "t.json"),
                extra, ["--device", "cpu"])
    t_said = capsys.readouterr().out
    want = _eval(jcli, data, str(tmp_path / "j_out"),
                 str(tmp_path / "j.json"), extra, [])
    j_said = capsys.readouterr().out
    assert INT8_BANNERS[kind] in t_said and INT8_BANNERS[kind] in j_said
    assert "[int8, batch=2" in t_said and "[int8, batch=2" in j_said
    assert set(got) == set(want)
    assert [r["name"] for r in got["per_image"]] == \
        [r["name"] for r in want["per_image"]] == names
    mean_b, max_b = INT8_BOUNDS[kind]
    rmse_tol = 255 * (mean_b * max_b) ** 0.5 + 1
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g["rmse"] == pytest.approx(w["rmse"], abs=rmse_tol)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=0.01)
    for n in names:
        a = imread_gray(os.path.join(tmp_path, "t_out", n + ".png"))
        b = imread_gray(os.path.join(tmp_path, "j_out", n + ".png"))
        d = np.abs(a.astype(int) - b.astype(int))
        assert a.shape == b.shape
        assert d.mean() <= 255 * mean_b + 1 and d.max() <= 255 * max_b + 1


def test_int8_eval_runs_the_ports_own_int8_forward(tmp_path, capsys):
    """What `cli eval --dtype int8` writes is, bit for bit, the uint8
    truncation of `codon_forward` with `Int8StaticOps` on the checkpoint's
    act_scales, in the bf16 policy, batch by batch."""
    from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
    from codon_tpu_torch.core.params import BF16
    from codon_tpu_torch.data.pipeline import batched_loader
    from codon_tpu_torch.models.codon_net import codon_forward
    from codon_tpu_torch.models.variants import get_variant
    from codon_tpu_torch.quant_ops import Int8StaticOps
    data = str(tmp_path / "d")
    names = write_scale_dir(data, TTA_SIZES, seed=6)
    ckpt = os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz")
    out = str(tmp_path / "out")
    _eval(tcli, data, out, str(tmp_path / "t.json"),
          ["--dtype", "int8", "--ckpt", ckpt], ["--device", "cpu"])
    tree = load_npz(ckpt)
    ops = Int8StaticOps(tree.pop("act_scales"), compute_dtype=torch.bfloat16)
    params = params_from_numpy(tree, "cpu")
    cfg = get_variant("codon", BF16).cfg
    seen = 0
    for b in batched_loader(data, names, 2, 32, device="cpu"):
        y = codon_forward(params, b.depth, b.color, mask=b.mask, cfg=cfg,
                          ops=ops)
        u8 = (y[..., 0].clamp(0.0, 1.0) * 255).to(torch.uint8).numpy()
        for i, name in enumerate(b.names):
            h, w = b.sizes[i]
            png = imread_gray(os.path.join(out, name + ".png"))
            assert np.array_equal(png, u8[i, :h, :w])
            seen += 1
    assert seen == len(names)


def test_int8_device_metrics_equal_host_metrics(tmp_path):
    """--dtype int8 --tta8 --device-metrics scores the int8 forward: on
    images that fill the padded shape its metrics equal the host metrics
    of the same eval without --device-metrics (tolerances as in
    test_device_metrics_with_scale_cond_equal_host_metrics)."""
    data = str(tmp_path / "d")
    write_scale_dir(data, [(32, 32), (32, 32)], seed=7)
    flags = ["--ckpt", os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz"),
             "--dtype", "int8", "--tta8"]
    dev = _eval(tcli, data, str(tmp_path / "a"), str(tmp_path / "a.json"),
                [*flags, "--device-metrics"], ["--device", "cpu"])
    host = _eval(tcli, data, str(tmp_path / "b"), str(tmp_path / "b.json"),
                 flags, ["--device", "cpu"])
    assert dev["tta_transforms"] == host["tta_transforms"] == 8
    for g, w in zip(dev["per_image"], host["per_image"]):
        assert g["rmse"] == pytest.approx(w["rmse"], abs=1e-3)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=1e-5)


def test_act_scales_are_split_off_for_every_dtype(tmp_path):
    from codon_tpu_torch.models.variants import get_variant
    v = get_variant("codon")
    params, scales = tcli._load_params(
        os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz"), v, "cpu")
    assert "act_scales" not in params and len(scales) == 18
    assert all(t.dtype == torch.float32 for t in scales.values())
    params, scales = tcli._load_params(
        os.path.join(CKPT_DIR, "x4_ship4_qat.npz"), v, "cpu")
    assert scales is None


def test_eval_refuses_torch_checkpoints(tmp_path):
    """Torch `.pth` checkpoints are read now
    (tests/test_torch_cli_tools.py::test_eval_pth_equals_npz); what
    `--ckpt` refuses is an extension that is neither .npz nor .pth."""
    data = str(tmp_path / "d")
    write_scale_dir(data, SIZES[:1])
    with pytest.raises(SystemExit, match=r"\.npz or a torch \.pth"):
        tcli.main(["eval", "--data-dir", data, "--ckpt", "model.ckpt",
                   "--device", "cpu"])


@pytest.mark.parametrize("flags,want", [
    (["--tta"], (True, False, False)),
    (["--tta8"], (False, True, False)),
    (["--device-metrics"], (False, False, True)),
])
def test_ported_flags_parse(flags, want):
    args = tcli._build_argparser().parse_args(["eval", *flags])
    assert (args.tta, args.tta8, args.device_metrics) == want


# three images at batch 2: one padded, masked batch and a short last one
TTA_SIZES = [(34, 29), (21, 30), (26, 19)]


@pytest.mark.parametrize("extra", [
    ["--ckpt", "x4_ship4.npz", "--tta8", "--device-metrics"],
    ["--ckpt", "x4_ship4.npz,x4_holdout2.npz", "--tta"],
], ids=["tta8-device-metrics", "ensemble2-tta"])
def test_eval_tta_matches_jax(tmp_path, extra):
    """Per image: RMSE within 0.01 and SSIM within 1e-4, the tolerances of
    test_eval_matches_jax (outputs agree to ~1e-5; the uint8 truncation
    may move a pixel on an integer boundary by one level)."""
    data = str(tmp_path / "CODON_X4")
    names = write_scale_dir(data, TTA_SIZES, seed=3)
    extra = [",".join(os.path.join(CKPT_DIR, c) for c in a.split(","))
             if a.endswith(".npz") else a for a in extra]
    got = _eval(tcli, data, str(tmp_path / "t_out"), str(tmp_path / "t.json"),
                extra, ["--device", "cpu"])
    want = _eval(jcli, data, str(tmp_path / "j_out"),
                 str(tmp_path / "j.json"), extra, [])
    assert set(got) == set(want)
    assert got["tta_transforms"] == want["tta_transforms"] == \
        (8 if "--tta8" in extra else 4)
    assert [r["name"] for r in got["per_image"]] == \
        [r["name"] for r in want["per_image"]] == names
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g["rmse"] == pytest.approx(w["rmse"], abs=0.01)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=1e-4)
    assert got["mean_rmse"] == pytest.approx(want["mean_rmse"], abs=0.01)
    assert got["mean_ssim"] == pytest.approx(want["mean_ssim"], abs=1e-4)
    for n in names:
        a = imread_gray(os.path.join(tmp_path, "t_out", n + ".png"))
        b = imread_gray(os.path.join(tmp_path, "j_out", n + ".png"))
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
        assert float((a != b).mean()) < 0.01


def test_device_metrics_with_scale_cond_equal_host_metrics(tmp_path):
    """Images that fill the padded shape: the metrics on tensors take their
    exact unmasked paths, so they equal the host metrics on the same
    forward (float32 against float64: RMSE 1e-3, SSIM 1e-5)."""
    data = str(tmp_path / "d")
    write_scale_dir(data, [(32, 32), (32, 32)], seed=4)
    flags = ["--ckpt", os.path.join(CKPT_DIR, "x4_holdout_sc.npz"),
             "--variant", "codon_sc", "--scale-cond", "--tta"]
    dev = _eval(tcli, data, str(tmp_path / "a"), str(tmp_path / "a.json"),
                [*flags, "--device-metrics"], ["--device", "cpu"])
    host = _eval(tcli, data, str(tmp_path / "b"), str(tmp_path / "b.json"),
                 flags, ["--device", "cpu"])
    for g, w in zip(dev["per_image"], host["per_image"]):
        assert g["rmse"] == pytest.approx(w["rmse"], abs=1e-3)
        assert g["ssim"] == pytest.approx(w["ssim"], abs=1e-5)


@pytest.mark.parametrize("flags,match", [
    (["--variant", "codon,codon"], "not an ensemble"),
    (["--ckpt", "a.npz,b.npz,c.npz", "--variant", "codon,codon"],
     "2 names for 3"),
    (["--ckpt", "x4_ship4.npz,x4_holdout2.npz", "--device-metrics"],
     "not supported with --device-metrics"),
], ids=["variants-without-ensemble", "variant-count", "ensemble-metrics"])
def test_eval_argument_errors(tmp_path, flags, match):
    data = str(tmp_path / "d")
    write_scale_dir(data, TTA_SIZES[:1])
    flags = [",".join(os.path.join(CKPT_DIR, c) for c in a.split(","))
             if a.startswith("x4_") else a for a in flags]
    with pytest.raises(SystemExit, match=match):
        tcli.main(["eval", "--data-dir", data, "--device", "cpu", "--out",
                   str(tmp_path / "o"), *flags])
