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


@pytest.mark.parametrize("flag", ["--tta", "--tta8", "--tile-devices=2",
                                  "--dp-devices=2", "--device-metrics",
                                  "--profile=x", "--resume"])
def test_unported_flags_are_not_in_the_parser(flag, capsys):
    with pytest.raises(SystemExit):
        tcli._build_argparser().parse_args(["eval", flag])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_int8_is_not_a_dtype_yet(capsys):
    with pytest.raises(SystemExit):
        tcli._build_argparser().parse_args(["eval", "--dtype", "int8"])


def test_eval_refuses_torch_checkpoints(tmp_path):
    data = str(tmp_path / "d")
    write_scale_dir(data, SIZES[:1])
    with pytest.raises(SystemExit, match="npz"):
        tcli.main(["eval", "--data-dir", data, "--ckpt", "model.pth",
                   "--device", "cpu"])
