"""Ahead-of-time export for serving: `torch.export` artifacts.

The counterpart of `codon_tpu.serve.export`. The forward (weights baked
in, any Ops backend: float, or static int8 with its scales) is traced by
`torch.export` with a symbolic batch dimension and saved as an
`ExportedProgram` (a `.pt2` file), which a serving process runs with no
model code, no checkpoint loading and no retracing:

    # build side
    export_forward(variant, params, (370, 463), "model.pt2")
    # serving side
    fn = load_exported("model.pt2")
    out = fn(depth_b, color_b)         # any batch size

H and W are fixed per artifact, as in the JAX package: export one
artifact per supported (padded) resolution. The CUDA kernels of the eval
path are `torch.library` custom ops (`kernels.ops`), so the program calls
them by name: `load_exported` registers them before it loads, and the
kernel library is built at the first call on the card. The artifact is
run as the exported program (no Inductor, no AOTInductor).

Beside the program the file holds a JSON record (`META`): the platform it
was traced for ("cuda" or "cpu", the params' device), H and W, the
compute dtype and the Ops backend, TTA, mask, the scale-conditioning
value, the variant, the torch version, and that TF32 is off for its
convs and matmuls (`"tf32": false`, as every forward of the port runs).
`load_exported` refuses an artifact whose platform is not the requested
device, as `jax.export` refuses a cross-platform call, and runs it with
TF32 off (`core.params.full_fp32`): `torch.export` does not record the
backend flags, and cuDNN's float32 convs run TF32 by default.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

META = "codon_export.json"


def _leaves(tree, path=()):
    """-> [(path, tensor)] of a nested dict of tensors, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _leaves(v, path + (k,))]
    return [(path, tree)]


class _Served(torch.nn.Module):
    """fwd(params, depth, color, mask) as a module whose buffers are the
    parameter tree's tensors, so that `torch.export` bakes them into the
    artifact."""

    def __init__(self, fwd, params):
        super().__init__()
        self._fwd = fwd
        self._paths = []
        for i, (path, t) in enumerate(_leaves(params)):
            self.register_buffer(f"p{i}", t)
            self._paths.append(path)

    def params(self):
        tree: dict = {}
        for i, path in enumerate(self._paths):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, f"p{i}")
        return tree

    def forward(self, depth, color, mask=None):
        return self._fwd(self.params(), depth, color, mask)


def export_forward(variant, params, hw: Tuple[int, int], path: str,
                   ops=None, mask: bool = False, tta=False,
                   scale_cond: float = None) -> int:
    """Serialize the forward to `path`. Returns the artifact size in bytes.

    hw: (H, W) of the (padded) input resolution.
    ops: optional Ops backend baked into the artifact (e.g. Int8StaticOps
         with its scales: its convs are `codon::int8_conv` ops, its
         handoffs `codon::quant_im2col`).
    mask: also take a validity-mask input (padded-batch serving).
    tta: bake a geometric self-ensemble into the artifact (batched, as
         `models.tta`): True or 4 = the 4 flips, 8 = the full dihedral
         group (a second batched forward at (W, H)).
    scale_cond: bake the constant scale/16 conditioning plane into the
         artifact (codon_sc variants): callers feed 1-channel depth; the
         plane is appended beneath the TTA wrapper, as in eval.

    The artifact is traced on the params' device at batch 2, the batch
    dimension symbolic, so it runs at any batch size.
    """
    from torch.export import Dim

    from codon_tpu_torch.core.params import full_fp32
    from codon_tpu_torch.models.tta import make_tta_forward
    from codon_tpu_torch.models.variants import with_scale_cond

    h, w = hw
    device = _leaves(params)[0][1].device

    def base(p, d, c, m):
        return variant.forward(p, d, c, mask=m, ops=ops)

    if scale_cond is not None:
        base = with_scale_cond(base, scale_cond)
    n_tta = 0
    if tta:
        n_tta = 4 if tta is True else int(tta)
        base = make_tta_forward(base, transforms=n_tta)

    g = torch.Generator().manual_seed(0)
    args = tuple(torch.rand((2, h, w, 1), generator=g).to(device)
                 for _ in range(3 if mask else 2))
    b = Dim("b")
    with torch.no_grad(), full_fp32():
        program = torch.export.export(
            _Served(base, params), args,
            dynamic_shapes=tuple({0: b} for _ in args), strict=False)
    meta = {"platform": device.type, "height": h, "width": w,
            "dtype": str(variant.cfg.dtypes.compute_dtype).replace(
                "torch.", ""),
            "ops": None if ops is None else type(ops).__name__,
            "tta": n_tta, "mask": bool(mask), "scale_cond": scale_cond,
            "variant": variant.name, "torch": torch.__version__,
            "tf32": False}
    torch.export.save(program, path, extra_files={META: json.dumps(meta)})
    return os.path.getsize(path)


def load_exported(path: str, device=None):
    """Load an artifact; returns fn(depth, color[, mask]) -> (B,H,W,1)
    float32 on `device` (the card unless the caller asks for the CPU).

    Imports no model code: only the custom ops (`kernels.ops`), which
    must be registered before the program is read. Inputs may be numpy
    arrays or tensors; they are cast to float32 on the device. `fn.meta`
    is the artifact's record.
    """
    from codon_tpu_torch.core.device import resolve_device
    from codon_tpu_torch.core.params import full_fp32
    from codon_tpu_torch.kernels import ops  # noqa: F401

    dev = resolve_device("cuda" if device is None else device)
    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    if not extra[META]:
        raise ValueError(f"{path}: no {META} record; not an artifact of "
                         f"export_forward")
    meta = json.loads(extra[META])
    if meta["platform"] != dev.type:
        raise ValueError(f"{path} was exported for platform "
                         f"{meta['platform']!r} and cannot run on "
                         f"{dev.type!r}: export it on that device")
    module = program.module()

    def fn(*args):
        xs = [torch.as_tensor(a if isinstance(a, torch.Tensor)
                              else np.asarray(a, np.float32)).to(
                                  device=dev, dtype=torch.float32)
              for a in args]
        with torch.no_grad(), full_fp32():
            return module(*xs)

    fn.meta = meta
    return fn
