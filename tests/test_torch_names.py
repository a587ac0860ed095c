"""Nothing of the JAX package is left to port: a diff of public names.

For every module of `codon_tpu/`, the top-level public names (functions,
classes, assignments; in an `__init__.py` also what it re-exports) must
be in the port's module of the same path, but those NOT_PORTED names,
each with its counterpart or the reason it has none (ROADMAP.md, "Not to
port"). Every script of `scripts/` that imports `jax` or `codon_tpu` must
have a port module, but the TPU timing probes. Both read the sources with
`ast`; nothing of the JAX package is imported.
"""
import ast
import glob
import os
import re

import pytest

from torch_port_common import REPO

# codon_tpu's modules and names the port does not carry under their own
# path and name -> the counterpart, or why there is none
NOT_PORTED = {
    "checkpoint/orbax_io.py": "no orbax on the card; checkpoint/manager.py "
                              "writes its own step directories",
    "utils/cache.py": "XLA's compile cache: eager PyTorch compiles nothing "
                      "per shape",
    "save_orbax": "orbax", "load_orbax": "orbax",
    "Ops": "core.ops.TorchOps", "XlaOps": "core.ops.TorchOps",
    "bucket_names_by_shape": "no per-shape compile to bucket for",
    "cac_stage_pallas": "kernels.cac.cac_stage",
    "masked_rmse_jnp": "metrics.rmse.masked_rmse_torch",
    "ssim_exact_jnp": "metrics.ssim.ssim_exact_torch",
    "Int8ShardedOps": "parallel/quant.py",
    "Int8StaticShardedOps": "parallel/quant.py",
    "FakeQuantShardedOps": "parallel/quant.py",
    "FakeQuantStaticShardedOps": "parallel/quant.py",
}
# scripts/ that run the JAX package and the port's module that stands for
# each; None: a TPU timing probe (chip_smoke.py, profile_forward and
# PERF.md's table measure the port)
SCRIPTS = {
    "export_matrix.py": "export_matrix.py", "soup.py": "soup.py",
    "sc_cond_probe.py": "sc_cond_probe.py",
    "tta_shift_probe.py": "tta_shift_probe.py",
    "ttt_probe.py": "ttt_probe.py",
    "perf_pallas_probe.py": "perf_copy_probe.py",
    **{name: None for name in (
        "perf_ablate.py", "perf_ablate_int8.py", "perf_batch_probe.py",
        "perf_bound_int8.py", "perf_cac.py", "perf_roofline_int8.py",
        "perf_sweep.py", "perf_tta.py")},
}


def public_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom)
              and os.path.basename(path) == "__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    root = os.path.join(REPO, "codon_tpu")
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_its_counterpart(module):
    if module in NOT_PORTED:
        return
    port = os.path.join(REPO, "codon_tpu_torch", module)
    assert os.path.exists(port), f"codon_tpu/{module} has no port"
    missing = (public_names(os.path.join(REPO, "codon_tpu", module))
               - public_names(port) - set(NOT_PORTED))
    assert not missing, f"codon_tpu_torch/{module} lacks {sorted(missing)}"


def test_every_model_script_has_its_counterpart():
    runs_jax = re.compile(r"^\s*(import|from) (jax|codon_tpu)\b", re.M)
    found = set()
    for path in sorted(glob.glob(os.path.join(REPO, "scripts", "*.py"))):
        with open(path) as f:
            if runs_jax.search(f.read()):
                found.add(os.path.basename(path))
    assert found == set(SCRIPTS)
    for script, port in SCRIPTS.items():
        if port is not None:
            assert os.path.exists(os.path.join(REPO, "codon_tpu_torch",
                                               port)), script
