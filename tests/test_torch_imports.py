"""What runs on the card stands alone: no jax, codon_tpu, cv2 or PIL.

The machine with the card has none of them, so a port that imports one
dies there before it prints a line. What runs there: the port,
chip_smoke.py, and the CUDA kernel tests with their helpers.
"""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

from torch_port_common import REPO

FORBIDDEN = ("jax", "jaxlib", "codon_tpu", "cv2", "PIL")
# the subpackages that re-export their main names, as codon_tpu's do
SUBPACKAGES = ("checkpoint", "core", "data", "metrics", "models", "train",
               "utils")


def _card_files():
    files = sorted(glob.glob(os.path.join(REPO, "codon_tpu_torch", "**",
                                          "*.py"), recursive=True))
    return files + [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "tests/test_torch_kernels_cuda.py",
        "tests/torch_port_common.py")]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call):
            fn = node.func
            called = getattr(fn, "id", None) or getattr(fn, "attr", None)
            arg = node.args[0] if node.args else None
            if (called in ("__import__", "import_module")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                roots.add(arg.value.split(".")[0])
    return roots


def test_card_files_exist():
    names = {os.path.relpath(p, REPO) for p in _card_files()}
    for need in ("codon_tpu_torch/cli.py", "codon_tpu_torch/kernels/cac.py",
                 "codon_tpu_torch/models/codon_net.py", "chip_smoke.py",
                 "codon_tpu_torch/quant_ops.py",
                 "codon_tpu_torch/kernels/quant.py",
                 "codon_tpu_torch/checkpoint/torch_convert.py",
                 "codon_tpu_torch/models/attention.py",
                 "codon_tpu_torch/models/zoo.py",
                 "codon_tpu_torch/parallel/comm.py",
                 "codon_tpu_torch/parallel/mesh.py",
                 "codon_tpu_torch/parallel/ops.py",
                 "codon_tpu_torch/parallel/quant.py",
                 "codon_tpu_torch/parallel/launch.py",
                 "codon_tpu_torch/parallel/tiling.py",
                 "codon_tpu_torch/parallel/stitch.py",
                 "codon_tpu_torch/parallel/dryrun.py",
                 "codon_tpu_torch/parallel/train.py",
                 "codon_tpu_torch/data/resize.py",
                 "codon_tpu_torch/soup.py",
                 "codon_tpu_torch/sc_cond_probe.py",
                 "codon_tpu_torch/entry.py",
                 "codon_tpu_torch/tta_shift_probe.py",
                 "codon_tpu_torch/ttt_probe.py",
                 *(f"codon_tpu_torch/{pkg}/__init__.py"
                   for pkg in SUBPACKAGES)):
        assert need in names
    assert all(os.path.exists(p) for p in _card_files())


@pytest.mark.parametrize("path", _card_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


_BLOCKED_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of these now raises
import importlib, pkgutil, torch
import codon_tpu_torch
for m in pkgutil.walk_packages(codon_tpu_torch.__path__, "codon_tpu_torch."):
    importlib.import_module(m.name)
from codon_tpu_torch.models.variants import get_variant
v = get_variant("codon")
p = v.init(torch.Generator().manual_seed(0), "cpu")
out = v.forward(p, torch.rand(1, 9, 7, 1), torch.rand(1, 9, 7, 1))
assert out.shape == (1, 9, 7, 1)
# the .pth path: a reference-named state dict written, read back through
# the cli's loader, and run through the other two forwards
import contextlib, io, os, tempfile
from codon_tpu_torch import cli
from codon_tpu_torch.checkpoint.torch_convert import (
    params_to_torch_state_dict)
sd = params_to_torch_state_dict(p, v.cfg, module_prefix=True)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "m.pth")
    torch.save({{"epoch": 1, "model": {{k: torch.from_numpy(a.copy())
                                      for k, a in sd.items()}}}}, path)
    for name in ("codon_fused", "rmcr_fuse_rmcr"):
        fv = get_variant(name)
        with contextlib.redirect_stdout(io.StringIO()):
            q, scales = cli._load_params(path, fv, "cpu")
        assert scales is None
        out = fv.forward(q, torch.rand(1, 9, 7, 1), torch.rand(1, 9, 7, 1))
        assert out.shape == (1, 9, 7, 1)
# a zoo net: its own init, the eval forward and a training step
from codon_tpu_torch.train.trainer import TrainConfig, make_train_step
zv = get_variant("zoo:rmcr_fuse_rmcr_rcan")
zp = zv.init(torch.Generator().manual_seed(0), "cpu")
out = zv.forward(zp, torch.rand(1, 9, 7, 1), torch.rand(1, 9, 7, 1))
assert out.shape == (1, 9, 7, 1)
step, opt = make_train_step(zv, TrainConfig())
batch = {{"depth": torch.rand(1, 9, 7, 1), "color": torch.rand(1, 9, 7, 1),
          "label": torch.rand(1, 9, 7, 1), "mask": torch.ones(1, 9, 7, 1)}}
step(zp, opt.init(zp), batch)
# the subpackages' re-exports, JAX's names under the port's
from codon_tpu_torch.checkpoint import CheckpointManager, load_npz, load_pth
from codon_tpu_torch.core import TorchOps, DTypePolicy
from codon_tpu_torch.data import Batch, Sample, batched_loader
from codon_tpu_torch.metrics import masked_rmse_torch, ssim_block
from codon_tpu_torch.models import CodonConfig, codon_forward
from codon_tpu_torch.train import PatchSampler, make_train_step
from codon_tpu_torch.utils import Logger, mkdir_if_missing
from codon_tpu_torch.entry import dryrun_multichip, entry
from codon_tpu_torch import tta_shift_probe, ttt_probe
a = torch.rand(5, 6).numpy()
assert (tta_shift_probe.shift2d(a, 1, 0)[:-1] == a[1:]).all()
print("ok")
"""


def test_port_imports_and_runs_without_forbidden_modules():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(forbidden=FORBIDDEN)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_NO_BUILD_RUN = r"""
import ctypes, importlib, importlib.util, os, pkgutil, subprocess, sys


def refuse(*args, **kwargs):
    raise AssertionError("an import started a kernel build or load")


# the build module, loaded before its package and with every way to
# build or load the library made to raise; nvcc runs through subprocess,
# the library loads through ctypes
name = "codon_tpu_torch.kernels._build"
spec = importlib.util.spec_from_file_location(
    name, os.path.join("codon_tpu_torch", "kernels", "_build.py"))
_build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(_build)
_build.build = _build.load = _build.nvcc = refuse
sys.modules[name] = _build
import numpy, scipy.ndimage, torch, torch.distributed, torch.multiprocessing
subprocess.Popen = subprocess.run = ctypes.CDLL = refuse
import codon_tpu_torch
for pkg in {subpackages!r}:
    importlib.import_module("codon_tpu_torch." + pkg)
for m in pkgutil.walk_packages(codon_tpu_torch.__path__, "codon_tpu_torch."):
    importlib.import_module(m.name)
assert sys.modules[name] is _build
print("ok")
"""


def test_imports_start_no_kernel_build():
    """Importing the package, each subpackage (their re-exports) and every
    module starts no nvcc build and loads no library: with the build, the
    library load and subprocesses made to raise, every import passes."""
    res = subprocess.run(
        [sys.executable, "-c",
         _NO_BUILD_RUN.format(subpackages=SUBPACKAGES)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_WORKER_RUN = r"""
import sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of these now raises
import torch
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import MeshPool, make_tiled_forward
from codon_tpu_torch.parallel.launch import loaded_modules
if __name__ == "__main__":
    v = get_variant("codon")
    p = v.init(torch.Generator().manual_seed(0), "cpu")
    with MeshPool(2, device="cpu", timeout_s=60) as pool:
        out = make_tiled_forward(v, 2, 1, pool=pool)(
            p, torch.rand(1, 9, 7, 1), torch.rand(1, 9, 7, 1), None)
        assert out.shape == (1, 9, 7, 1)
        worker = pool.call(loaded_modules)[1]
    bad = sorted(m for m in worker if m.split(".")[0] in {forbidden!r})
    assert "codon_tpu_torch.parallel.launch" in worker
    print("ok" if not bad else bad)
"""


def test_spawned_worker_imports_no_forbidden_module(tmp_path):
    """A mesh's worker rank is a fresh spawned process: after a sharded
    forward it holds the port's modules and none of jax, codon_tpu, cv2
    or PIL."""
    script = tmp_path / "mesh_run.py"
    script.write_text(_WORKER_RUN.format(forbidden=FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert res.stdout == ""


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(str(tmp_path))
    assert res.returncode != 0
    assert res.stdout == ""
