"""`python -m codon_tpu_torch.cli train --device cpu` against `codon_tpu.cli
train`, on small scale dirs written with the port's PNG writer.

Tolerances, and why:
- the first step's loss, float32, the same checkpoint, dir and seed: the
  two logs' losses within 2e-5 (the patches are bitwise equal, the loss
  within float32 noise, the log prints 5 decimals). With --qat-static the
  fake-quant flip class of tests/test_torch_train.py: rtol 0.02.
- an interrupted and resumed run against the uninterrupted one: bitwise
  (the CPU computes the same sums in the same order; the patch stream is
  a pure function of (seed, step); the optimizer state is restored).
- the calibrated act_scales against JAX's: within 1e-5 of the site's
  largest scale (float convs sum in other orders; a scale is an absmax /
  127, and a channel whose absmax is 1e-5 of the largest carries that
  noise relative to itself). With --scale-cond, against JAX's
  calibrate_act_scales called on the plane-augmented frames: within 1e-6
  absolute (scales of at most ~0.1; they read <= 1e-8).
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from codon_tpu import cli as jax_cli
from codon_tpu.checkpoint import load_npz as jax_load_npz

from codon_tpu_torch import cli as tcli

from torch_port_common import (CKPT_DIR, REPO, one_torch_thread,  # noqa: F401
                               write_scale_dir)
from test_torch_imports import FORBIDDEN

SIZES = [(37, 41), (40, 36), (45, 38)]
STEP1 = re.compile(r"step\s+1\s+loss ([0-9.]+)")
SHIP4 = os.path.join(CKPT_DIR, "x4_ship4.npz")
STATIC = os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz")
SMALL = ["--patch", "16", "--batch", "2", "--log-every", "1"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    write_scale_dir(os.path.join(root, "CODON_X4"), SIZES, seed=0)
    return os.path.join(root, "CODON_X4")


def _port(argv, capsys=None):
    rc = tcli.main(["train", *argv, "--device", "cpu"])
    assert rc == 0
    return capsys.readouterr().out if capsys is not None else None


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_qat_static_ema_matches_jax_and_scores_as_int8(tmp_path, data,
                                                       capsys):
    """--qat-static from the shipping checkpoint with --ema: the port's
    output loads in codon_tpu's load_npz with the keys and shapes of the
    JAX-trained one (act_scales included), its first loss and its scales
    agree with JAX's, and the port's int8 eval runs the static path on
    it."""
    argv = ["--data-dir", data, "--steps", "2", *SMALL, "--dtype", "fp32",
            "--ckpt-in", STATIC, "--qat-static", "--ema", "0.9"]
    ours = str(tmp_path / "ours.npz")
    out = _port([*argv, "--ckpt-out", ours], capsys)
    assert "QAT-static: calibrated 18 conv sites" in out
    theirs = str(tmp_path / "theirs.npz")
    assert jax_cli.main(["train", *argv, "--ckpt-out", theirs]) == 0
    jout = capsys.readouterr().out
    np.testing.assert_allclose(float(STEP1.search(out).group(1)),
                               float(STEP1.search(jout).group(1)),
                               rtol=0.02)
    for ext in ("", "_ema"):
        a = _flat(jax_load_npz(ours.replace(".npz", ext + ".npz")))
        b = _flat(jax_load_npz(theirs.replace(".npz", ext + ".npz")))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k.startswith("act_scales/"):
                np.testing.assert_allclose(a[k], b[k], rtol=0,
                                           atol=1e-5 * b[k].max(),
                                           err_msg=k)
    assert sum(k.startswith("act_scales/") for k in a) == 18
    rc = tcli.main(["eval", "--data-dir", data, "--ckpt", ours, "--dtype",
                    "int8", "--no-save", "--device", "cpu"])
    assert rc == 0
    ev = capsys.readouterr().out
    assert "int8: static per-channel scales from checkpoint (18" in ev
    means = ev.strip().splitlines()[-3].split()
    assert all(np.isfinite(float(m)) for m in means)


def test_first_loss_matches_jax_fp32(tmp_path, data, capsys):
    argv = ["--data-dir", data, "--steps", "1", *SMALL, "--dtype", "fp32",
            "--ckpt-in", SHIP4, "--loss", "l2", "--grad-loss", "0.5",
            "--seed", "3", "--augment", "flips"]
    out = _port([*argv, "--ckpt-out", str(tmp_path / "a.npz")], capsys)
    assert jax_cli.main(["train", *argv, "--ckpt-out",
                         str(tmp_path / "b.npz")]) == 0
    jout = capsys.readouterr().out
    assert abs(float(STEP1.search(out).group(1))
               - float(STEP1.search(jout).group(1))) <= 2e-5


def test_resume_reproduces_the_uninterrupted_run(tmp_path, data):
    """Checkpointed at step 2 and resumed to 4 == a straight 4-step run,
    bitwise, with warmup + cosine, clip and decay in the state."""
    def run(steps, odir, ck):
        _port(["--data-dir", data, "--steps", str(steps), *SMALL,
               "--dtype", "fp32", "--ckpt-in", SHIP4, "--warmup", "2",
               "--clip-norm", "1", "--weight-decay", "0.01",
               "--orbax-dir", odir, "--save-every", "2", "--ckpt-out", ck])

    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    run(4, str(tmp_path / "run_a"), a)
    # the schedule depends on --steps, so the interrupted run is a --steps
    # 4 run stopped right after its step-2 checkpoint
    _interrupted(data, str(tmp_path / "run_b"), b, stop_at=2)
    run(4, str(tmp_path / "run_b"), b)
    fa, fb = _flat(jax_load_npz(a)), _flat(jax_load_npz(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _interrupted(data, odir, ck, stop_at):
    """A --steps 4 run killed right after its step-`stop_at` checkpoint."""
    from codon_tpu_torch.checkpoint import manager

    class Stop(Exception):
        pass

    real = manager.CheckpointManager.save

    def save_then_stop(self, step, tree):
        real(self, step, tree)
        if step == stop_at:
            raise Stop

    manager.CheckpointManager.save = save_then_stop
    try:
        with pytest.raises(Stop):
            _port(["--data-dir", data, "--steps", "4", *SMALL, "--dtype",
                   "fp32", "--ckpt-in", SHIP4, "--warmup", "2",
                   "--clip-norm", "1", "--weight-decay", "0.01",
                   "--orbax-dir", odir, "--save-every", "2",
                   "--ckpt-out", ck])
    finally:
        manager.CheckpointManager.save = real
    assert not os.path.exists(ck)


def test_synthesized_degradation(tmp_path, data, capsys):
    """No input_depth/: the degraded inputs are synthesized with the
    port's bicubic resize, and --qat-static calibrates on synthesized
    full frames."""
    dst = str(tmp_path / "CODON_X4")
    for sub in ("input_color", "input_label"):
        shutil.copytree(os.path.join(data, sub), os.path.join(dst, sub))
    out = _port(["--data-dir", dst, "--steps", "2", *SMALL, "--ckpt-in",
                 STATIC, "--qat-static", "--ckpt-out",
                 str(tmp_path / "s.npz")], capsys)
    assert "[synthesized degradation]" in out
    assert "QAT-static: calibrated 18 conv sites" in out
    assert os.path.exists(str(tmp_path / "s.npz"))


def test_mix_scales_scale_cond_exclude_and_scene_weight(tmp_path, capsys):
    """codon_sc warm-started from a 1-channel checkpoint (the stem is
    widened), trained on the shipped degradations of three scale dirs with
    the conditioning channel, one scene held out and one upweighted."""
    root = str(tmp_path)
    for s in (4, 8, 16):
        write_scale_dir(os.path.join(root, f"CODON_X{s}"), SIZES, seed=0)
    ck = str(tmp_path / "sc.npz")
    out = _port(["--data-root", root, "--scale", "4", "--steps", "2",
                 *SMALL, "--variant", "codon_sc", "--scale-cond",
                 "--mix-scales", "--ckpt-in", SHIP4, "--exclude", "img2",
                 "--scene-weight", "img0=3", "--edge-bias", "0.5",
                 "--collage", "0.5", "--ckpt-out", ck], capsys)
    assert "holding out: ['img2']" in out
    assert "mix-scales: +4 shipped degradation pairs" in out
    assert "widened 1-channel stem -> (3, 3, 2, 64)" in out
    assert "6 source images" in out
    tree = jax_load_npz(ck)
    assert tree["input"].shape == (3, 3, 2, 64)
    for loss in re.findall(r"loss ([0-9.]+)", out):
        assert np.isfinite(float(loss))


def test_collapse_exits_and_saves_the_state(tmp_path, data):
    """All-zero weights: the output is the residual, every gradient is
    exactly 0, and after 3 log steps the run stops and saves the state."""
    from codon_tpu_torch.checkpoint.native import load_npz, save_npz
    tree = load_npz(SHIP4)
    zero = {k: ({kk: np.zeros_like(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.zeros_like(v))
            for k, v in tree.items()}
    ck_in = str(tmp_path / "zero.npz")
    save_npz(ck_in, zero)
    out = str(tmp_path / "dead.npz")
    with pytest.raises(SystemExit, match="TRAIN COLLAPSE at step 3"):
        _port(["--data-dir", data, "--steps", "5", *SMALL, "--ckpt-in",
               ck_in, "--ckpt-out", out])
    assert os.path.exists(out + ".collapsed")
    assert not os.path.exists(out)


@pytest.mark.parametrize("flags,match", [
    (["--qat", "--qat-static"], "mutually exclusive"),
    (["--mix-scales"], "cannot be combined"),
    (["--scene-weight", "nope=2"], "not in the training set"),
    (["--exclude", "nope"], "not in dataset"),
    (["--ema", "1.5"], "--ema must be in"),
])
def test_argument_errors(data, flags, match):
    with pytest.raises(SystemExit, match=match):
        _port(["--data-dir", data, "--steps", "1", *SMALL, *flags])


def test_codon_fused_and_the_default_device(tmp_path, data, capsys):
    """`--variant codon_fused` trains: its first fp32 loss is JAX's."""
    argv = ["--data-dir", data, "--steps", "1", *SMALL, "--dtype", "fp32",
            "--ckpt-in", SHIP4, "--variant", "codon_fused"]
    out = _port([*argv, "--ckpt-out", str(tmp_path / "a.npz")], capsys)
    assert jax_cli.main(["train", *argv, "--ckpt-out",
                         str(tmp_path / "b.npz")]) == 0
    jout = capsys.readouterr().out
    assert abs(float(STEP1.search(out).group(1))
               - float(STEP1.search(jout).group(1))) <= 2e-5
    args = tcli._build_argparser().parse_args(["train"])
    assert args.device == "cuda"


def test_check_nans_names_the_site(tmp_path, data):
    from codon_tpu_torch.checkpoint.native import load_npz, save_npz
    tree = load_npz(SHIP4)
    tree["conv3"][0, 0, 0, 0] = np.nan
    ck = str(tmp_path / "nan.npz")
    save_npz(ck, tree)
    with pytest.raises(FloatingPointError, match="conv site 'conv3'"):
        _port(["--data-dir", data, "--steps", "1", *SMALL, "--ckpt-in", ck,
               "--check-nans"])


_BLOCKED_TRAIN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of these now raises
from codon_tpu_torch import cli
rc = cli.main(["train", "--data-dir", {data!r}, "--steps", "2", "--patch",
               "16", "--batch", "2", "--log-every", "1", "--device", "cpu",
               "--orbax-dir", {odir!r}, "--save-every", "1",
               "--ckpt-out", {ck!r}])
assert rc == 0
print("ok")
"""


def test_train_runs_without_forbidden_modules(tmp_path, data):
    """What the card's machine lacks: jax, codon_tpu, cv2, PIL, optax,
    orbax."""
    code = _BLOCKED_TRAIN.format(
        forbidden=(*FORBIDDEN, "optax", "orbax"), data=data,
        odir=str(tmp_path / "run"), ck=str(tmp_path / "o.npz"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_batch_1_trains_as_jax(tmp_path, data, capsys):
    """`--batch 1`: the head conv's weight gradient at N = 1 (a standard-
    layout weight on the CPU), the first loss as JAX's, and finite steps."""
    argv = ["--data-dir", data, "--steps", "2", "--patch", "16", "--batch",
            "1", "--log-every", "1", "--dtype", "fp32", "--ckpt-in", SHIP4]
    out = _port([*argv, "--ckpt-out", str(tmp_path / "a.npz")], capsys)
    assert jax_cli.main(["train", *argv, "--ckpt-out",
                         str(tmp_path / "b.npz")]) == 0
    jout = capsys.readouterr().out
    assert abs(float(STEP1.search(out).group(1))
               - float(STEP1.search(jout).group(1))) <= 2e-5
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_scale_cond_qat_static_calibrates_with_the_plane(tmp_path, data,
                                                         capsys):
    """--variant codon_sc --scale-cond --qat-static: calibration feeds the
    2-channel stem the scale/16 plane, as eval and training do. The scales
    equal JAX's calibrate_act_scales over the same frames with the plane
    appended here (JAX's cli itself feeds the 1-channel depth and
    raises)."""
    import jax.numpy as jnp
    from codon_tpu import quant_ops as jq
    from codon_tpu.data.io import discover_pairs
    from codon_tpu.data.pipeline import batched_loader
    from codon_tpu.models.codon_net import widen_stem_params
    from codon_tpu.models.variants import get_variant

    ck = str(tmp_path / "sc.npz")
    out = _port(["--data-dir", data, "--steps", "1", *SMALL, "--dtype",
                 "fp32", "--variant", "codon_sc", "--scale-cond",
                 "--qat-static", "--ckpt-in", SHIP4, "--ckpt-out", ck],
                capsys)
    assert "QAT-static: calibrated 18 conv sites on 3 full frames" in out
    params = widen_stem_params(jax_load_npz(SHIP4), 2)
    batches = [(jnp.concatenate([b.depth, jnp.full_like(b.depth[..., :1],
                                                        4 / 16.0)], -1),
                b.color, b.mask)
               for b in batched_loader(data, discover_pairs(data), 2, 32)]
    want = jq.calibrate_act_scales(get_variant("codon_sc").forward, params,
                                   batches)
    with np.load(ck) as f:
        got = {k[len("act_scales/"):]: f[k] for k in f.files
               if k.startswith("act_scales/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
