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
                 "codon_tpu_torch/checkpoint/torch_convert.py"):
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
print("ok")
"""


def test_port_imports_and_runs_without_forbidden_modules():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(forbidden=FORBIDDEN)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
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
