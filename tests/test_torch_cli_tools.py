"""The rest of `python -m codon_tpu_torch.cli` against `codon_tpu.cli`, on
the CPU: `.pth` checkpoints in `eval --ckpt`, `convert`, `golden`, `info`,
`eval --resume / --profile / --check-nans`, and `eval` of the merged-tower
(`codon_fused`) and sequential-tower (`rmcr_fuse_rmcr`) variants."""
import json
import os

import numpy as np
import pytest
import torch

import jax

from codon_tpu import cli as jcli

from codon_tpu_torch import cli as tcli
from codon_tpu_torch.checkpoint import torch_convert as ttc
from codon_tpu_torch.checkpoint.native import load_npz, save_npz
from codon_tpu_torch.data.io import imread_gray, imwrite_gray
from codon_tpu_torch.models.codon_net import CodonConfig

from torch_port_common import (CKPT_DIR, RefNet,  # noqa: F401
                               one_torch_thread, write_scale_dir)

SHIP = os.path.join(CKPT_DIR, "x4_ship4.npz")
# a padded, masked batch and a short last one at batch 2
SIZES = [(34, 29), (21, 30), (26, 19)]


def _eval(mod, data, out, jpath, extra, device_args=("--device", "cpu")):
    rc = mod.main(["eval", "--scale", "4", "--data-dir", data, "--batch",
                   "2", "--dtype", "fp32", "--out", out, "--json", jpath,
                   *extra, *device_args])
    assert rc == 0
    with open(jpath) as f:
        return json.load(f)


def _write_pth(path, npz=SHIP, **kw):
    """A reference-named `.pth` of `npz`: {"epoch", "model": <a pickled
    stand-in module>}, as the release saves them (DataParallel's
    `module.` prefix with module_prefix=True)."""
    cfg = CodonConfig(dead_heads=True)
    sd = ttc.params_to_torch_state_dict(load_npz(npz), cfg, **kw)
    torch.save({"epoch": 12, "model": RefNet(sd)}, path)


def _pngs(out, names):
    return [imread_gray(os.path.join(out, n + ".png")) for n in names]


# ---------------------------------------------------------------------------
# .pth checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ckpts", [["m.pth"], ["m.pth", "x4_holdout2.npz"]],
                         ids=["pth", "ensemble-pth-npz"])
def test_eval_pth_equals_npz(tmp_path, capsys, ckpts):
    """`--ckpt x.pth` writes the PNGs and metrics of `--ckpt x.npz`, bit for
    bit (the same float32 arrays reach the forward), alone and as an
    ensemble member, and prints the JAX package's banner."""
    data = str(tmp_path / "d")
    names = write_scale_dir(data, SIZES, seed=11)
    pth = str(tmp_path / "m.pth")
    _write_pth(pth, module_prefix=True)
    paths = [pth if c == "m.pth" else os.path.join(CKPT_DIR, c)
             for c in ckpts]
    capsys.readouterr()
    got = _eval(tcli, data, str(tmp_path / "a"), str(tmp_path / "a.json"),
                ["--ckpt", ",".join(paths), "--tta"])
    assert f"loaded torch checkpoint {pth} (epoch 12)" in \
        capsys.readouterr().out
    npz = [SHIP if c == "m.pth" else p for c, p in zip(ckpts, paths)]
    want = _eval(tcli, data, str(tmp_path / "b"), str(tmp_path / "b.json"),
                 ["--ckpt", ",".join(npz), "--tta"])
    assert got["per_image"] == want["per_image"]
    for a, b in zip(_pngs(str(tmp_path / "a"), names),
                    _pngs(str(tmp_path / "b"), names)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dead_heads", [True, False],
                         ids=["dead-heads", "no-dead-heads"])
def test_convert_matches_jax(tmp_path, capsys, dead_heads):
    pth = str(tmp_path / "m.pth")
    _write_pth(pth)
    flags = [] if dead_heads else ["--no-dead-heads"]
    capsys.readouterr()
    assert tcli.main(["convert", "--pth", pth, "--npz",
                      str(tmp_path / "t.npz"), *flags]) == 0
    t_said = capsys.readouterr().out
    assert jcli.main(["convert", "--pth", pth, "--npz",
                      str(tmp_path / "j.npz"), *flags]) == 0
    j_said = capsys.readouterr().out
    assert t_said.replace("t.npz", "j.npz") == j_said
    with np.load(str(tmp_path / "t.npz")) as t, \
            np.load(str(tmp_path / "j.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
        assert ("attention_c5/w1" in t.files) == dead_heads
    if dead_heads:
        # and back to the checkpoint the .pth was written from
        back = load_npz(str(tmp_path / "t.npz"))
        ref = load_npz(SHIP)
        for k in ref:
            for a, b in zip(jax.tree.leaves(back[k]),
                            jax.tree.leaves(ref[k])):
                assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# golden, info
# ---------------------------------------------------------------------------

def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def test_golden_matches_jax(tmp_path, capsys):
    """Per image "name.png rmse ssim", the count and the means, within
    1e-6 of JAX's golden on the same PNGs."""
    scale_dir = tmp_path / "CODON_X4"
    names = write_scale_dir(str(scale_dir), SIZES, seed=12)
    rng = np.random.RandomState(13)
    for n, (h, w) in zip(names, SIZES):
        imwrite_gray(str(scale_dir / "output" / (n + ".png")),
                     (rng.rand(h, w) * 255).astype(np.uint8))
    capsys.readouterr()
    assert tcli.main(["golden", "--data-root", str(tmp_path)]) == 0
    got = _lines(capsys.readouterr().out)
    assert jcli.main(["golden", "--data-root", str(tmp_path)]) == 0
    want = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == len(names) + 2
    for g, w in zip(got, want):
        gs, ws = g.split(), w.split()
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            if a.endswith(".png"):
                assert a == b
            else:
                assert float(a) == pytest.approx(float(b), abs=1e-6)
    assert got[-2] == str(len(names))
    # --data-dir names the scale dir itself
    assert tcli.main(["golden", "--data-dir", str(scale_dir)]) == 0
    assert _lines(capsys.readouterr().out) == got
    with pytest.raises(SystemExit, match="no archived PNGs"):
        os.makedirs(tmp_path / "empty" / "output")
        tcli.main(["golden", "--data-dir", str(tmp_path / "empty")])


@pytest.mark.parametrize("variant", ["codon", "codon_fused",
                                     "rmcr_fuse_rmcr", "codon_sc"])
def test_info_matches_jax(capsys, variant):
    capsys.readouterr()
    assert tcli.main(["info", "--variant", variant, "--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert jcli.main(["info", "--variant", variant]) == 0
    want = _lines(capsys.readouterr().out)
    count = f"variant '{variant}': "
    assert [ln for ln in got if ln.startswith(count)] == \
        [ln for ln in want if ln.startswith(count)]
    reg = "available variants: "
    (t_reg,) = [ln[len(reg):].split(", ") for ln in got
                if ln.startswith(reg)]
    (j_reg,) = [ln[len(reg):].split(", ") for ln in want
                if ln.startswith(reg)]
    assert t_reg == [n for n in j_reg if not n.startswith("zoo:")]
    assert got[0].startswith(f"torch {torch.__version__}, device: cpu")


def test_info_defaults_to_the_card():
    args = tcli._build_argparser().parse_args(["info"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            tcli.main(["info"])


# ---------------------------------------------------------------------------
# eval --resume, --profile, --check-nans
# ---------------------------------------------------------------------------

def test_resume_skips_written_images_and_stubs_when_all_done(tmp_path,
                                                             capsys):
    data = str(tmp_path / "d")
    names = write_scale_dir(data, SIZES, seed=14)
    out = str(tmp_path / "out")
    normal = _eval(tcli, data, out, str(tmp_path / "n.json"),
                   ["--ckpt", SHIP])
    os.remove(os.path.join(out, names[1] + ".png"))
    capsys.readouterr()
    part = _eval(tcli, data, out, str(tmp_path / "p.json"),
                 ["--ckpt", SHIP, "--resume"])
    assert "resume: skipping 2 already-written images" in \
        capsys.readouterr().out
    assert part["images"] == 1 and \
        [r["name"] for r in part["per_image"]] == [names[1]]
    stub = _eval(tcli, data, out, str(tmp_path / "s.json"),
                 ["--ckpt", SHIP, "--resume"])
    assert "resume: nothing to do" in capsys.readouterr().out
    # the normal summary's keys, and resumed_all
    assert set(stub) == set(normal) | {"resumed_all"}
    assert stub["resumed_all"] is True and stub["images"] == 0
    assert all(stub[k] is None for k in ("mean_rmse", "mean_ssim",
                                         "img_per_sec_steady",
                                         "img_per_sec_e2e",
                                         "img_per_sec_compute"))
    # JAX's stub, key for key and value for value
    want = _eval(jcli, data, out, str(tmp_path / "j.json"),
                 ["--ckpt", SHIP, "--resume"], device_args=())
    assert stub == want
    # with --no-save nothing is skipped
    again = _eval(tcli, data, out, str(tmp_path / "a.json"),
                  ["--ckpt", SHIP, "--resume", "--no-save"])
    assert again["images"] == len(names)


def test_profile_writes_a_trace(tmp_path, capsys):
    data = str(tmp_path / "d")
    write_scale_dir(data, SIZES[:2], seed=15)
    prof = str(tmp_path / "prof")
    _eval(tcli, data, str(tmp_path / "o"), str(tmp_path / "p.json"),
          ["--ckpt", SHIP, "--profile", prof])
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)


def _jax_forward_raises(tree, dtype, d, c):
    """Whether JAX's forward of `tree`, run op by op, raises
    FloatingPointError under jax_debug_nans, which checks every op's
    output (the int8 dtype through its static backend)."""
    import jax.numpy as jnp
    from codon_tpu.core.params import DTYPE_POLICIES
    from codon_tpu.models.variants import get_variant as jax_variant
    from codon_tpu.quant_ops import Int8StaticOps
    tree = dict(tree)
    scales = tree.pop("act_scales", None)
    v = jax_variant("codon", DTYPE_POLICIES[dtype])
    ops = (Int8StaticOps(scales, compute_dtype=v.cfg.dtypes.compute_dtype)
           if dtype == "int8" else None)
    jax.config.update("jax_debug_nans", True)
    try:
        v.forward(tree, jnp.asarray(d), jnp.asarray(c),
                  ops=ops).block_until_ready()
    except FloatingPointError:
        return True
    finally:
        # jax_debug_nans is process-wide: leave it as the suite found it
        jax.config.update("jax_debug_nans", False)
    return False


@pytest.mark.parametrize("dtype,ckpt,extra", [
    ("fp32", "x4_ship4.npz", []), ("bf16", "x4_ship4.npz", ["--tta8"]),
    ("int8", "x4_ship4_qat_static.npz", [])],
    ids=["fp32", "bf16-tta8", "int8-static"])
def test_check_nans_raises_where_jax_does(tmp_path, capsys, dtype, ckpt,
                                          extra):
    """A NaN in one conv weight. JAX's forward under jax_debug_nans raises
    FloatingPointError at the first op that makes a NaN, and the forward
    that `eval --check-nans` builds raises it at that conv site, naming
    it; on the clean checkpoint neither raises (in int8 the NaN would be
    quantized to code 0 at the next site, so only a check at every site
    sees it). `cli eval --check-nans` fails through it."""
    src = os.path.join(CKPT_DIR, ckpt)
    bad = str(tmp_path / "nan.npz")
    tree = load_npz(src)
    tree["conv3"] = tree["conv3"].copy()
    tree["conv3"][1, 2, 3, 4] = np.nan
    save_npz(bad, tree)
    rng = np.random.RandomState(16)
    d = rng.rand(1, 21, 19, 1).astype(np.float32)
    c = rng.rand(1, 21, 19, 1).astype(np.float32)
    flags = ["--dtype", dtype, "--check-nans", *extra]

    def port_forward(path):
        args = tcli._build_argparser().parse_args(
            ["eval", "--ckpt", path, *flags, "--device", "cpu"])
        ef = tcli.make_eval_forward(args, torch.device("cpu"))
        return ef.fwd(ef.params, torch.from_numpy(d), torch.from_numpy(c),
                      None)

    from codon_tpu.checkpoint.native import load_npz as jax_load_npz
    assert _jax_forward_raises(jax_load_npz(bad), dtype, d, c)
    with pytest.raises(FloatingPointError, match="conv site 'conv3'"):
        port_forward(bad)
    assert not _jax_forward_raises(jax_load_npz(src), dtype, d, c)
    assert bool(torch.isfinite(port_forward(src)).all())
    data = str(tmp_path / "d")
    write_scale_dir(data, SIZES[:2], seed=16)
    with pytest.raises(FloatingPointError, match="conv site 'conv3'"):
        _eval(tcli, data, str(tmp_path / "t"), str(tmp_path / "t.json"),
              ["--ckpt", bad, *flags])
    # without --check-nans the port runs through and scores what it made
    s = _eval(tcli, data, str(tmp_path / "n"), str(tmp_path / "n.json"),
              ["--ckpt", bad, "--dtype", dtype, *extra])
    assert s["images"] == 2


def test_new_eval_flags_parse():
    args = tcli._build_argparser().parse_args(
        ["eval", "--resume", "--profile", "p", "--check-nans"])
    assert (args.resume, args.profile, args.check_nans) == (True, "p", True)


# ---------------------------------------------------------------------------
# eval of the merged-tower and sequential-tower variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,extra", [
    ("codon_fused", []), ("rmcr_fuse_rmcr", []),
    ("codon_fused", ["--dtype", "int8", "--ckpt",
                     "x4_ship4_qat_static.npz"]),
], ids=["codon_fused", "rmcr_fuse_rmcr", "codon_fused-int8"])
def test_other_variants_eval_matches_jax(tmp_path, variant, extra):
    """fp32: the tolerances of test_torch_cli.py::test_eval_matches_jax
    (RMSE 0.01, SSIM 1e-4, PNGs within one level on < 1% of pixels);
    int8 static: its int8 bounds (the flip class carried to the PNGs)."""
    data = str(tmp_path / "CODON_X4")
    names = write_scale_dir(data, SIZES, seed=17)
    extra = [os.path.join(CKPT_DIR, a) if a.endswith(".npz") else a
             for a in extra]
    flags = ["--variant", variant, *(extra or ["--ckpt", SHIP])]
    got = _eval(tcli, data, str(tmp_path / "t"), str(tmp_path / "t.json"),
                flags)
    want = _eval(jcli, data, str(tmp_path / "j"), str(tmp_path / "j.json"),
                 flags, device_args=())
    assert set(got) == set(want)
    int8 = "int8" in extra
    rmse_tol = 255 * (0.01 * 0.1) ** 0.5 + 1 if int8 else 0.01
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g["name"] == w["name"]
        assert g["rmse"] == pytest.approx(w["rmse"], abs=rmse_tol)
        assert g["ssim"] == pytest.approx(w["ssim"],
                                          abs=0.01 if int8 else 1e-4)
    for a, b in zip(_pngs(str(tmp_path / "t"), names),
                    _pngs(str(tmp_path / "j"), names)):
        d = np.abs(a.astype(int) - b.astype(int))
        if int8:
            assert d.mean() <= 255 * 0.01 + 1 and d.max() <= 255 * 0.1 + 1
        else:
            assert d.max() <= 1 and float((d > 0).mean()) < 0.01
