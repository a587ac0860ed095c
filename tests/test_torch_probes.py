"""The port's last two model scripts against the JAX package's:
`codon_tpu_torch.tta_shift_probe` against `scripts/tta_shift_probe.py`
and `codon_tpu_torch.ttt_probe` against `scripts/ttt_probe.py`, on a
synthetic reference-layout scale dir (the Middlebury scenes the scripts
read are not in the repo) of three ~30 x 30 scenes, all padded to one
32 x 32 shape, from checkpoints/x4_holdout2.npz.

The JAX side is each script's own computation, rebuilt from its pieces
(its `shift2d`, `SHIFTS`, `pad_to`, its scoring and JAX's forwards,
`make_batch`, `PatchSampler` and `make_train_step`), in float32 where the
scripts run bf16, so that the two packages compare like with like.

Tolerances, and why:
- `shift2d`: bitwise (the same numpy).
- the shift rows' RMSE within RMSE_TOL, 0.05 of a level, as
  tests/test_torch_scripts.py holds the sc_cond_probe rows: both
  forwards agree to ~1e-5 of the output's 255 scale, and the uint8
  truncation may flip a pixel's code where they straddle a boundary;
  the SSIMs within SSIM_TOL, 1e-3, for the same flips.
- `ttt_probe`'s fine-tuning, 2 steps at b2 p16 at lr 1e-3, on the same
  `degraded` array and the same sampler batches (the sampler is
  bitwise): in float64, both packages, the parameters within atol 2e-4 /
  rtol 1e-3 of JAX's, the parallel training tests' bound for parameters
  after Adam steps; in float32, where one ReLU tie of the convs' sums
  sets them apart (the test's doc), `rmse_after` within RMSE_TOL. C3's
  bicubic bound (tests/test_torch_resize.py) would apply to
  `synthesize_lr`; both sides take the one array instead.
- a second scene's `rmse_before` bitwise that of the scene scored alone:
  each scene fine-tunes a fresh copy of the checkpoint (the optimizer
  updates its tree in place).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codon_tpu.core.params import DTypePolicy as JaxPolicy
from codon_tpu.data.io import load_sample as jax_load_sample
from codon_tpu.data.pipeline import make_batch as jax_make_batch
from codon_tpu.metrics import masked_rmse as jax_masked_rmse
from codon_tpu.metrics import ssim_exact as jax_ssim_exact
from codon_tpu.models.tta import make_tta_forward as jax_tta
from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.train.data import PatchSampler as JaxPatchSampler
from codon_tpu.train.trainer import TrainConfig as JaxConfig
from codon_tpu.train.trainer import make_train_step as jax_train_step

from codon_tpu_torch import tta_shift_probe, ttt_probe
from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.params import DTypePolicy
from codon_tpu_torch.data.io import load_sample
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.train.data import synthesize_lr
from codon_tpu_torch.train.trainer import TrainConfig, tree_items

from torch_port_common import (CKPT_DIR, REPO, one_torch_thread,  # noqa: F401
                               write_scale_dir)

CKPT = os.path.join(CKPT_DIR, "x4_holdout2.npz")
SIZES = [(32, 30), (28, 32), (32, 32)]
# the one padded shape of SIZES
HW = (32, 32)
RMSE_TOL, SSIM_TOL = 0.05, 1e-3
P_ATOL, P_RTOL = 2e-4, 1e-3
TTT = dict(scale=4, patch=16, batch=2, augment="flips")
TTT_STEPS, TTT_LR = 2, 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """-> (data root, scale dir, names, the JAX tree, the port's tree)."""
    root = str(tmp_path_factory.mktemp("probes"))
    scale_dir = os.path.join(root, "CODON_X4")
    names = write_scale_dir(scale_dir, SIZES, seed=5)
    tree = load_npz(CKPT)
    tree.pop("act_scales", None)
    return root, scale_dir, names, tree, params_from_numpy(tree, "cpu")


def _keys(path):
    with open(path) as f:
        d = json.load(f)
    rows = d.get("per_image") or d.get("results")
    return list(d), list(rows[0])


def test_shift2d_is_the_scripts():
    script = _script("tta_shift_probe")
    a = np.random.RandomState(0).rand(7, 5)
    assert tta_shift_probe.SHIFTS == script.SHIFTS
    for dy, dx in script.SHIFTS:
        np.testing.assert_array_equal(tta_shift_probe.shift2d(a, dy, dx),
                                      script.shift2d(a, dy, dx))


def _jax_shift_rows(scale_dir, names, tree, batch):
    """scripts/tta_shift_probe.py's rows, with JAX's float32 forward."""
    import dataclasses
    script = _script("tta_shift_probe")
    jv = jax_variant("codon")
    fwd = jax.jit(jax_tta(lambda p, d, c, m: jv.forward(p, d, c, mask=m)))
    samples = [jax_load_sample(scale_dir, n) for n in names]
    fixed_hw = HW
    preds = {n: {} for n in names}
    for dy, dx in script.SHIFTS:
        shifted = [dataclasses.replace(s, depth=script.shift2d(s.depth, dy,
                                                               dx),
                                       color=script.shift2d(s.color, dy, dx))
                   for s in samples]
        for i in range(0, len(shifted), batch):
            b = jax_make_batch(shifted[i:i + batch], 32, target_batch=batch,
                               fixed_hw=fixed_hw)
            m = jnp.ones_like(b.depth) if b.mask is None else b.mask
            out = np.asarray(fwd(tree, b.depth, b.color, m))
            for j, name in enumerate(b.names):
                h, w = b.sizes[j]
                pred = out[j, :h, :w, 0].astype(np.float64)
                preds[name][(dy, dx)] = script.shift2d(pred, -dy, -dx)

    def score(label, pred):
        f32 = np.clip(pred.astype(np.float32), np.float32(0.0),
                      np.float32(1.0)) * np.float32(255.0)
        u8 = f32.astype(np.uint8)
        return jax_masked_rmse(label, u8), jax_ssim_exact(label / 255,
                                                          u8 / 255)
    rows = []
    for s in samples:
        r0, s0 = score(s.label, preds[s.name][(0, 0)])
        r5, s5 = score(s.label, np.mean([preds[s.name][sh]
                                         for sh in script.SHIFTS], 0))
        rows.append({"name": s.name, "tta4_rmse": r0, "tta4_ssim": s0,
                     "shift5_rmse": r5, "shift5_ssim": s5})
    return rows


def test_shift_rows_match_the_jax_script(scenes):
    """Batch 2 over 3 scenes: a full batch and a short one filled with its
    last scene, 5 shifts each, one padded shape."""
    _, scale_dir, names, tree, params = scenes
    samples = [load_sample(scale_dir, n) for n in names]
    preds = tta_shift_probe.shifted_predictions(
        get_variant("codon"), params, samples, 2, torch.device("cpu"))
    got = tta_shift_probe.probe_rows(samples, preds)
    want = _jax_shift_rows(scale_dir, names, tree, 2)
    assert [r["name"] for r in got] == names
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("tta4_rmse", "shift5_rmse"):
            assert abs(g[k] - w[k]) <= RMSE_TOL, (g["name"], k)
        for k in ("tta4_ssim", "shift5_ssim"):
            assert abs(g[k] - w[k]) <= SSIM_TOL, (g["name"], k)
        assert g["tta4_rmse"] != g["shift5_rmse"]


def _jax_tune(scale_dir, name, tree, degraded, dtype):
    """scripts/ttt_probe.py's fine-tuning of one scene, in `dtype` -> (the
    tree after TTT_STEPS steps, its rmse_after)."""
    script = _script("ttt_probe")
    s = jax_load_sample(scale_dir, name)
    jv = jax_variant("codon", dtypes=JaxPolicy(
        param_dtype=dtype, compute_dtype=dtype, acc_dtype=dtype,
        precision="highest"))
    cfg = JaxConfig(learning_rate=TTT_LR, warmup_steps=1,
                    total_steps=TTT_STEPS)
    step_fn, tx = jax_train_step(jv, cfg, donate=False)
    sampler = JaxPatchSampler(
        labels=[s.depth], colors=[s.color], scale=TTT["scale"],
        patch=TTT["patch"], batch=TTT["batch"], seed=0,
        augment=TTT["augment"], degraded=[degraded]).prefetch(2)
    try:
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        opt_state = tx.init(params)
        for _ in range(TTT_STEPS):
            params, opt_state, _ = step_fn(params, opt_state,
                                           sampler.sample())
    finally:
        sampler.close()
    H, W = HW
    h, w = s.depth.shape
    d = script.pad_to(s.depth, H, W)[None, ..., None].astype(np.float32) / 255
    c = script.pad_to(s.color, H, W)[None, ..., None].astype(np.float32) / 255
    m = np.zeros((1, H, W, 1), np.float32)
    m[0, :h, :w, 0] = 1.0
    out = jv.forward(params, d, c, mask=m)
    u8 = np.asarray((jnp.clip(out[..., 0], 0.0, 1.0) * 255).astype(
        jnp.uint8))[0, :h, :w]
    return jax.tree.map(np.asarray, params), jax_masked_rmse(s.label, u8)


@pytest.fixture(scope="module")
def jax_tuned(scenes):
    """JAX's fine-tuning of the first scene, each of its train steps
    compiled once for the module -> (the degraded array both sides take,
    {dtype name: (JAX's tree after TTT_STEPS steps, its rmse_after)})."""
    _, scale_dir, names, tree, _ = scenes
    s = jax_load_sample(scale_dir, names[0])
    degraded = synthesize_lr(s.depth, TTT["scale"])
    tuned = {"float32": _jax_tune(scale_dir, names[0], tree, degraded,
                                  jnp.float32)}
    with jax.enable_x64(True):
        tuned["float64"] = _jax_tune(scale_dir, names[0], tree, degraded,
                                     jnp.float64)
    return degraded, tuned


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_ttt_fine_tune_matches_jax(scenes, jax_tuned, dtype):
    """The probe's fine-tuning against the JAX script's on the same
    scene, `degraded` array and sampler batches. In float64 (both
    packages) the parameters after TTT_STEPS steps at lr 1e-3 are within
    atol 2e-4 / rtol 1e-3 of JAX's (they read 6.5e-7 apart), and the base
    tree is untouched. In float32 one ReLU of the forward's 42 decides
    apart at the first batch (pre-activation -1.2e-8 in the port, +1.4e-9
    in float64, as in C4 of the zoo's eccv gradient: the convs' float32
    sums), which sends an element of conv10 ~lr the other way at the
    second Adam step; there `rmse_after` is held within RMSE_TOL."""
    _, scale_dir, names, tree, _ = scenes
    degraded, tuned = jax_tuned
    want, want_rmse = tuned[str(dtype).split(".")[1]]
    v = get_variant("codon", dtypes=DTypePolicy(param_dtype=dtype,
                                                compute_dtype=dtype))
    base = params_from_numpy(tree, "cpu", dtype=dtype)
    s = load_sample(scale_dir, names[0])
    cfg = TrainConfig(learning_rate=TTT_LR, warmup_steps=1,
                      total_steps=TTT_STEPS)
    cpu = torch.device("cpu")
    got = ttt_probe.fine_tune(v, base, s, degraded, cfg, device=cpu,
                              **TTT)
    if dtype == torch.float64:
        for (path, g), (_, w) in zip(tree_items(got), tree_items(
                params_from_numpy(want, "cpu", dtype=dtype))):
            assert g.dtype == dtype
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=P_ATOL,
                                       rtol=P_RTOL, err_msg=path)
        for (_, a), (_, b) in zip(tree_items(base), tree_items(
                params_from_numpy(tree, "cpu", dtype=dtype))):
            assert torch.equal(a, b)
    rmse_after, _ = ttt_probe.make_scorer(v, False, HW, cpu)(got, s)
    assert abs(rmse_after - want_rmse) <= RMSE_TOL


def test_ttt_scenes_start_from_the_checkpoint(scenes):
    """Two scenes in one run: the second one's `rmse_before` (and SSIM) is
    bitwise that of a run of it alone; its `rmse_after` too."""
    _, scale_dir, names, _, params = scenes
    v = get_variant("codon")
    samples = [load_sample(scale_dir, n) for n in names[:2]]
    cfg = TrainConfig(learning_rate=TTT_LR, warmup_steps=1,
                      total_steps=TTT_STEPS)
    cpu = torch.device("cpu")
    both = ttt_probe.probe(v, params, samples, cfg, tta=False, device=cpu,
                           **TTT)
    alone = ttt_probe.probe(v, params, samples[1:], cfg, tta=False,
                            device=cpu, **TTT)
    assert both[0]["rmse_after"] != both[0]["rmse_before"]
    for k in ("rmse_before", "ssim_before", "rmse_after", "ssim_after"):
        assert both[1][k] == alone[0][k], k


def test_shift_probe_main_writes_the_scripts_json(scenes, tmp_path,
                                                   capsys):
    root, _, names, _, _ = scenes
    out = str(tmp_path / "shift.json")
    assert tta_shift_probe.main(["--data-root", root, "--ckpt", CKPT,
                                 "--batch", "4", "--json", out,
                                 "--device", "cpu"]) == 0
    assert _keys(out) == _keys(os.path.join(
        CKPT_DIR, "shift_probe_x4_holdout2.json"))
    with open(out) as f:
        d = json.load(f)
    assert [r["name"] for r in d["per_image"]] == names
    assert all(np.isfinite(v) for r in d["per_image"] for k, v in r.items()
               if k != "name")
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "shift (+0,+0) done"
    assert printed[-2].startswith("mean tta4 ")


def test_ttt_probe_main_writes_the_scripts_json(scenes, tmp_path, capsys):
    root, _, names, _, _ = scenes
    out = str(tmp_path / "ttt.json")
    assert ttt_probe.main(["--data-root", root, "--ckpt", CKPT, "--images",
                           ",".join(names[:2]), "--steps", "2", "--warmup",
                           "1", "--patch", "16", "--batch", "2", "--tta",
                           "--cpu", "--json", out]) == 0
    assert _keys(out) == _keys(os.path.join(CKPT_DIR,
                                            "ttt_probe_x4_gentle.json"))
    with open(out) as f:
        d = json.load(f)
    assert d["tta"] is True and d["steps"] == 2
    assert [r["name"] for r in d["results"]] == names[:2]
    assert all(np.isfinite(v) for r in d["results"] for k, v in r.items()
               if k != "name")
    assert capsys.readouterr().out.splitlines()[-2].startswith("mean rmse:")


@pytest.mark.parametrize("module,args", [
    (tta_shift_probe, ["--ckpt", CKPT, "--data-root", "nowhere"]),
    (ttt_probe, ["--ckpt", CKPT, "--data-root", "nowhere"])],
    ids=["tta_shift_probe", "ttt_probe"])
def test_probes_need_the_card_unless_asked(module, args):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(args)
