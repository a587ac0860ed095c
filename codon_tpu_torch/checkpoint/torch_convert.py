"""The reference's `.pth` checkpoints, read into the port's parameter tree.

The reference ships `.pth` files of the form {"epoch": int, "model": <the
pickled nn.Module>}, read with `checkpoint["model"].state_dict()`; its X16
release wraps the model in DataParallel, so every key carries a `module.`
prefix. The counterpart of `codon_tpu.checkpoint.torch_convert` (its own
copy: the port imports nothing of the JAX package), giving the same numpy
tree that `checkpoint.native.params_from_numpy` carries to tensors:

  * conv weights OIHW -> HWIO
  * Linear weights (out, in) -> (in, out)
  * per-stage attention_{c,s}{0..4} -> the stacked `cac` subtree
  * `module.` prefixes stripped; the dead attention_{c5,s5} heads mapped
    when cfg.dead_heads, else dropped.

`generic_state_dict_to_flat` converts any state dict by rank into the flat
parameters of the ablation zoo (`models.zoo`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CONV_NAMES = [
    "input", "conv_input", "conv1", "conv2", "conv3", "confuse",
    "input_c", "conv_input_c", "conv4", "conv5", "conv6", "confuse_c",
    "conv7", "conv8", "conv9", "conv10", "confuse_fuse", "conv11", "output",
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _strip_module(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def torch_state_dict_to_params(sd: Mapping, cfg) -> dict:
    """State dict with the reference's names (arrays or tensors) -> the
    port's numpy parameter tree. cfg: a `CodonConfig` (use_cac, num_mc,
    dead_heads are read)."""
    sd = _strip_module({k: _np(v) for k, v in sd.items()})
    params = {name: sd[f"{name}.weight"].transpose(2, 3, 1, 0)
              for name in _CONV_NAMES}
    if cfg.use_cac:
        stages = {"ch_w1": [], "ch_b1": [], "ch_w2": [], "ch_b2": [],
                  "sp_w": []}
        for i in range(cfg.num_mc):
            stages["ch_w1"].append(sd[f"attention_c{i}.mlp.1.weight"].T)
            stages["ch_b1"].append(sd[f"attention_c{i}.mlp.1.bias"])
            stages["ch_w2"].append(sd[f"attention_c{i}.mlp.3.weight"].T)
            stages["ch_b2"].append(sd[f"attention_c{i}.mlp.3.bias"])
            stages["sp_w"].append(sd[f"attention_s{i}.spatial.conv.weight"]
                                  .transpose(2, 3, 1, 0))
        params["cac"] = {k: np.stack(v) for k, v in stages.items()}
    if cfg.dead_heads and "attention_c5.mlp.1.weight" in sd:
        params["attention_c5"] = {
            "w1": sd["attention_c5.mlp.1.weight"].T,
            "b1": sd["attention_c5.mlp.1.bias"],
            "w2": sd["attention_c5.mlp.3.weight"].T,
            "b2": sd["attention_c5.mlp.3.bias"],
        }
        params["attention_s5"] = {
            "sp_w": sd["attention_s5.spatial.conv.weight"]
            .transpose(2, 3, 1, 0)}
    return params


def params_to_torch_state_dict(params, cfg,
                               module_prefix: bool = False) -> dict:
    """The port's tree (arrays or tensors) -> a numpy state dict with the
    reference's names; `module_prefix` adds DataParallel's `module.`."""
    sd: Dict[str, np.ndarray] = {}
    for name in _CONV_NAMES:
        sd[f"{name}.weight"] = _np(params[name]).transpose(3, 2, 0, 1)
    if cfg.use_cac:
        cac = {k: _np(v) for k, v in params["cac"].items()}
        for i in range(cfg.num_mc):
            sd[f"attention_c{i}.mlp.1.weight"] = cac["ch_w1"][i].T
            sd[f"attention_c{i}.mlp.1.bias"] = cac["ch_b1"][i]
            sd[f"attention_c{i}.mlp.3.weight"] = cac["ch_w2"][i].T
            sd[f"attention_c{i}.mlp.3.bias"] = cac["ch_b2"][i]
            sd[f"attention_s{i}.spatial.conv.weight"] = (
                cac["sp_w"][i].transpose(3, 2, 0, 1))
    if cfg.dead_heads and "attention_c5" in params:
        c5 = params["attention_c5"]
        sd["attention_c5.mlp.1.weight"] = _np(c5["w1"]).T
        sd["attention_c5.mlp.1.bias"] = _np(c5["b1"])
        sd["attention_c5.mlp.3.weight"] = _np(c5["w2"]).T
        sd["attention_c5.mlp.3.bias"] = _np(c5["b2"])
        sd["attention_s5.spatial.conv.weight"] = (
            _np(params["attention_s5"]["sp_w"]).transpose(3, 2, 0, 1))
    if module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd


def load_pth(path: str, cfg):
    """A reference `.pth` -> (numpy parameter tree, epoch or -1).

    Takes {"epoch", "model": <module or state dict>}, a bare pickled
    module, or a plain state dict. A pickled module is unpickled with
    `weights_only=False`, so its class must be importable; load only files
    you trust.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        obj = ckpt["model"]
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        epoch = int(ckpt.get("epoch", -1))
    elif hasattr(ckpt, "state_dict"):
        sd, epoch = ckpt.state_dict(), -1
    else:
        sd, epoch = ckpt, -1
    return torch_state_dict_to_params(sd, cfg), epoch


def generic_state_dict_to_flat(sd: Mapping) -> Dict[str, np.ndarray]:
    """A torch state dict -> the zoo's flat numpy parameters, by rank:
    4-D conv weights OIHW -> HWIO, 2-D Linear weights (out, in) -> (in,
    out), 1-D tensors (biases, norm affines and statistics) as they are;
    `module.` stripped, `num_batches_tracked` dropped. Works for every zoo
    net, whose parameters are keyed by the torch names themselves."""
    out: Dict[str, np.ndarray] = {}
    for k, v in _strip_module({k: _np(v) for k, v in sd.items()}).items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.ndim == 4:
            out[k] = v.transpose(2, 3, 1, 0)
        elif v.ndim == 2:
            out[k] = v.T
        else:
            out[k] = v
    return out
