"""The port's two model tools against the JAX package's scripts:
`python -m codon_tpu_torch.soup` against `scripts/soup.py`, and
`codon_tpu_torch.sc_cond_probe` against the formula of
`scripts/sc_cond_probe.py` computed with JAX's `codon_sc` forward.

Tolerances, and why:
- soup: bitwise. Both read the same npz leaves, weigh them in float64 in
  the same order and cast back; the refusals exit non-zero with the same
  message.
- the probe, on a synthetic reference-layout scale dir (the scenes JAX's
  script reads are not in the repo), from checkpoints/x4_holdout_sc.npz:
  the mean |delta| between conditioning values within 1e-3 of a level
  (both forwards in float32 agree to ~1e-5 of the output's 255 scale),
  and the RMSE at each value within 0.05 of a level (the uint8 rounding
  of the outputs may flip a pixel's code where the two forwards straddle
  a .5 boundary).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codon_tpu.checkpoint import load_npz as jax_load_npz
from codon_tpu.metrics import masked_rmse as jax_masked_rmse
from codon_tpu.models.variants import get_variant as jax_variant

from codon_tpu_torch import sc_cond_probe
from codon_tpu_torch.checkpoint.native import (load_npz, params_from_numpy,
                                              save_npz)
from codon_tpu_torch.data.io import load_sample

from torch_port_common import (CKPT_DIR, REPO, one_torch_thread,  # noqa: F401
                               write_scale_dir)

SC = os.path.join(CKPT_DIR, "x4_holdout_sc.npz")
DELTA_TOL, RMSE_TOL = 1e-3, 0.05


def _run(args):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=REPO)


def _both(tmp_path, members, *extra):
    """The JAX script and the port on the same members -> (JAX's run,
    the port's run, JAX's output path, the port's)."""
    jout, tout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j = _run([os.path.join(REPO, "scripts", "soup.py"), jout, *members,
              *extra])
    t = _run(["-m", "codon_tpu_torch.soup", tout, *members, *extra])
    return j, t, jout, tout


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _members(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        tree = {"w": rng.randn(3, 5).astype(np.float32),
                "b": {"k": rng.randn(4).astype(np.float32),
                      "n": np.array([3, 1], np.int32)},
                "act_scales": {"conv1": rng.rand(2).astype(np.float32)}}
        paths.append(str(tmp_path / f"m{i}.npz"))
        save_npz(paths[-1], tree)
    return paths


@pytest.mark.parametrize("extra", [(), ("--w", "3,1,0.5")],
                         ids=["uniform", "weighted"])
def test_soup_bitwise_with_the_jax_script(tmp_path, extra):
    j, t, jout, tout = _both(tmp_path, _members(tmp_path), *extra)
    assert j.returncode == 0, j.stderr
    assert t.returncode == 0, t.stderr
    assert t.stdout.strip().replace("port.npz", "") == \
        j.stdout.strip().replace("jax.npz", "")
    a, b = _flat(load_npz(tout)), _flat(load_npz(jout))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_soup_of_two_checkpoints(tmp_path):
    """The shipping pair the card's phase averages, bitwise."""
    members = [os.path.join(CKPT_DIR, n) for n in ("x4_ship4.npz",
                                                   "x4_holdout2.npz")]
    j, t, jout, tout = _both(tmp_path, members)
    assert j.returncode == 0 and t.returncode == 0, j.stderr + t.stderr
    a, b = _flat(load_npz(tout)), _flat(load_npz(jout))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _refusal(tmp_path, name, tree):
    base = {"w": np.ones((2,), np.float32), "n": np.array([3], np.int32)}
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / f"{name}.npz")
    save_npz(pa, base)
    save_npz(pb, tree)
    return [pa, pb]


REFUSALS = {
    "structure": ({"w": np.ones((2,), np.float32)}, (),
                  "member tree structures differ"),
    "shape": ({"w": np.ones((1, 2), np.float32),
               "n": np.array([3], np.int32)}, (), "leaf 1: shape/dtype"),
    "dtype": ({"w": np.ones((2,), np.float16),
               "n": np.array([3], np.int32)}, (), "leaf 1: shape/dtype"),
    "int_drift": ({"w": np.ones((2,), np.float32),
                   "n": np.array([4], np.int32)}, (),
                  "non-float leaf differs"),
    "w_count": (None, ("--w", "1,2,3"), "--w has 3 entries for 2"),
    "w_negative": (None, ("--w", "1,-1"), "--w weights must be >= 0"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_soup_refusals_as_the_jax_script(tmp_path, name):
    tree, extra, message = REFUSALS[name]
    if tree is None:
        tree = {"w": np.ones((2,), np.float32), "n": np.array([3], np.int32)}
    j, t, jout, tout = _both(tmp_path, _refusal(tmp_path, name, tree),
                             *extra)
    assert j.returncode != 0 and t.returncode == j.returncode
    assert message in j.stderr
    assert t.stderr.strip().splitlines()[-1] == \
        j.stderr.strip().splitlines()[-1]
    assert not os.path.exists(tout)


@pytest.fixture(scope="module")
def probe_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("probe"))
    names = write_scale_dir(root, [(34, 29), (21, 30)], seed=11)
    return root, names


def _jax_rows(data, names):
    """scripts/sc_cond_probe.py's rows, with JAX's codon_sc forward."""
    v = jax_variant("codon_sc")
    params = jax_load_npz(SC)
    params.pop("act_scales", None)
    conds = [4 / 16.0, 8 / 16.0, 16 / 16.0]
    rows = []
    for name in names:
        s = load_sample(data, name)
        d = s.depth.astype(np.float32)[None, ..., None] / 255.0
        c = s.color.astype(np.float32)[None, ..., None] / 255.0
        outs = {}
        for cv in conds:
            x = np.concatenate([d, np.full_like(d, cv)], -1)
            out = v.forward(params, jnp.asarray(x), jnp.asarray(c))
            outs[cv] = np.asarray(jnp.clip(out[..., 0], 0.0, 1.0)
                                  * 255.0)[0]
        rows.append({
            "scene": name,
            "rmse_by_cond": {f"{cv:.4f}": jax_masked_rmse(
                s.label, np.round(outs[cv]).astype(np.uint8))
                for cv in conds},
            "mean_abs_delta": {
                f"{a:.2f}-{b:.2f}": float(np.mean(np.abs(outs[a] - outs[b])))
                for a, b in [(conds[0], conds[1]), (conds[0], conds[2])]}})
    return rows


def test_sc_cond_probe_rows_match_jax(probe_dir):
    data, names = probe_dir
    tree = load_npz(SC)
    tree.pop("act_scales", None)
    printed = json.loads(json.dumps(sc_cond_probe.probe_rows(
        params_from_numpy(tree, "cpu"), data, names, torch.device("cpu"))))
    want = _jax_rows(data, names)
    assert [r["scene"] for r in printed] == names
    for got, ref in zip(printed, want):
        assert got["rmse_by_cond"].keys() == ref["rmse_by_cond"].keys()
        assert got["mean_abs_delta"].keys() == ref["mean_abs_delta"].keys()
        for k, x in ref["rmse_by_cond"].items():
            assert abs(got["rmse_by_cond"][k] - x) <= RMSE_TOL, k
        for k, x in ref["mean_abs_delta"].items():
            assert abs(got["mean_abs_delta"][k] - x) <= DELTA_TOL, k
            assert x > 0


def test_sc_cond_probe_needs_the_card_unless_asked():
    args = ["--data-dir", "nowhere"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sc_cond_probe.main(args)
