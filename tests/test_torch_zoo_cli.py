"""Every net of the ablation zoo through `python -m codon_tpu_torch.cli`
on the CPU: `eval` (its own init, a padded masked batch), one `train` step
and `info` (the parameter count JAX's `zoo_init` gives), and a zoo
ensemble with the eval flags that wrap a member's forward."""
import json
import os
import re

import jax
import numpy as np
import pytest

from codon_tpu.core.params import param_count
from codon_tpu.models import zoo as jzoo

from codon_tpu_torch import cli as tcli
from codon_tpu_torch.checkpoint.native import save_npz

from torch_port_common import one_torch_thread, write_scale_dir  # noqa: F401

SIZES = [(21, 19), (17, 23)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoo_cli_all") / "CODON_X4")
    write_scale_dir(root, SIZES, seed=31)
    return root


@pytest.mark.parametrize("name", jzoo.list_zoo())
def test_every_zoo_net_runs_through_the_cli(tmp_path, capsys, data, name):
    variant = "zoo:" + name
    jpath = str(tmp_path / "m.json")
    assert tcli.main(["eval", "--data-dir", data, "--variant", variant,
                      "--batch", "2", "--dtype", "fp32", "--no-save",
                      "--json", jpath, "--device", "cpu"]) == 0
    with open(jpath) as f:
        summary = json.load(f)
    assert summary["images"] == len(SIZES)
    assert all(np.isfinite(r["rmse"]) and np.isfinite(r["ssim"])
               for r in summary["per_image"])
    ck = str(tmp_path / "t.npz")
    assert tcli.main(["train", "--data-dir", data, "--variant", variant,
                      "--steps", "1", "--patch", "16", "--batch", "1",
                      "--log-every", "1", "--ckpt-out", ck,
                      "--device", "cpu"]) == 0
    assert np.isfinite(float(re.search(r"loss ([0-9.]+)",
                                       capsys.readouterr().out).group(1)))
    want = param_count(jzoo.zoo_init(name, jax.random.PRNGKey(0)))
    with np.load(ck) as f:
        assert sum(f[k].size for k in f.files) == want
    assert tcli.main(["info", "--variant", variant, "--device", "cpu"]) == 0
    assert f"variant '{variant}': {want:,} params" in capsys.readouterr().out


def test_zoo_ensemble_with_tta_check_nans_and_resume(tmp_path, capsys,
                                                     data):
    """Two zoo members (their own .npz, one net each) averaged under the 4
    flips, every conv site checked for NaN; a second run with --resume
    finds every PNG written."""
    ckpts = []
    for i, name in enumerate(("basenet_non3", "rmcr_fuse_rmcr_rcan")):
        ckpts.append(str(tmp_path / f"{name}.npz"))
        save_npz(ckpts[-1], jax.tree.map(np.asarray, jzoo.zoo_init(
            name, jax.random.PRNGKey(i))))
    argv = ["eval", "--data-dir", data, "--ckpt", ",".join(ckpts),
            "--variant", "zoo:basenet_non3,zoo:rmcr_fuse_rmcr_rcan",
            "--tta", "--check-nans", "--batch", "2", "--dtype", "fp32",
            "--out", str(tmp_path / "out"), "--device", "cpu"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "ensemble: averaging 2 models [zoo:basenet_non3, " \
        "zoo:rmcr_fuse_rmcr_rcan]" in out
    assert len(os.listdir(str(tmp_path / "out"))) == len(SIZES)
    assert tcli.main(argv + ["--resume"]) == 0
    assert "resume: nothing to do" in capsys.readouterr().out
