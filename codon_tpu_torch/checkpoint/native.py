"""Native checkpoints: flat .npz files with '/'-joined parameter paths.

The same format as `codon_tpu.checkpoint.native` (HWIO convs, `(in, out)`
linears, the per-stage CAC parameters stacked under `cac/`), read and
written with numpy alone. `params_from_numpy` carries a numpy tree across
to tensors; keys a variant does not use (dead heads, `act_scales/*`) are
kept and ignored by the forward.
"""
from __future__ import annotations

import numpy as np
import torch

from codon_tpu_torch.core.device import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_npz(path: str, params) -> None:
    """Write a tree of arrays or tensors to exactly `path`."""
    # np.savez(str) appends ".npz" to an extensionless path; a file object
    # keeps the name the caller gave
    with open(path, "wb") as f:
        np.savez(f, **_flatten(params))


def load_npz(path: str) -> dict:
    """-> nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def params_from_numpy(tree, device="cuda", dtype=torch.float32) -> dict:
    """Numpy (or JAX-package) parameter tree -> the same tree of tensors."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        # a copy: the source may be read-only (an npz member, a JAX array)
        return torch.from_numpy(np.array(node)).to(device=device, dtype=dtype)

    return convert(tree)
