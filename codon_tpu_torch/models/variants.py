"""Model-variant registry: each name pairs a CodonConfig with its forward.

The variants of `codon_tpu.models.variants` but its `zoo:*` names (the
ablation zoo is not ported yet): those that run `codon_forward`, the
merged-tower `codon_fused` (`codon_forward_fused`) and the attention-free
`rmcr_fuse_rmcr` (`sequential_tower_forward`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from codon_tpu_torch.core.params import DTypePolicy, FP32
from codon_tpu_torch.models.codon_net import (
    CodonConfig, codon_forward, codon_forward_fused, codon_forward_train,
    init_codon_params, sequential_tower_forward,
    sequential_tower_forward_train)

# each eval forward's grad-enabled sibling (models.codon_net)
_TRAIN_FORWARDS = {codon_forward: codon_forward_train,
                   sequential_tower_forward: sequential_tower_forward_train}


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    cfg: CodonConfig
    doc: str = ""
    forward_fn: Callable = codon_forward

    def init(self, gen, device="cuda"):
        return init_codon_params(gen, self.cfg, device=device)

    def forward(self, params, depth, color, mask=None, ops=None):
        return self.forward_fn(params, depth, color, cfg=self.cfg, mask=mask,
                               ops=ops)

    def check_trainable(self) -> None:
        """Raise NotImplementedError unless the variant has a training
        forward."""
        if self.forward_fn not in _TRAIN_FORWARDS:
            raise NotImplementedError(
                f"variant {self.name!r} does not train yet: its merged-tower "
                f"stage writes the next tensor through views, an eval-only "
                f"form (ROADMAP Queue A item 10, codon_fused training)")

    def train_forward(self, params, depth, color, mask=None, ops=None):
        """The forward with autograd on, for training."""
        self.check_trainable()
        return _TRAIN_FORWARDS[self.forward_fn](
            params, depth, color, cfg=self.cfg, mask=mask, ops=ops)


_REGISTRY: Dict[str, tuple] = {}


def _register(name: str, doc: str, forward_fn=codon_forward,
              **cfg_fields) -> None:
    _REGISTRY[name] = (cfg_fields, doc, forward_fn)


def get_variant(name: str, dtypes: DTypePolicy = FP32) -> Variant:
    if name not in _REGISTRY:
        raise KeyError(f"unknown variant '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    fields, doc, forward_fn = _REGISTRY[name]
    return Variant(name, CodonConfig(dtypes=dtypes, **fields), doc,
                   forward_fn)


def list_variants():
    return sorted(_REGISTRY)


def with_scale_cond(fwd, value: float):
    """Wrap fwd(params, depth, color, mask) so the depth input gains the
    constant conditioning plane `value` (scale / 16) as a second channel,
    as `cli eval --scale-cond` feeds the codon_sc variants."""
    def cond_fwd(p, d, c, m):
        return fwd(p, torch.cat([d, torch.full_like(d[..., :1], value)], -1),
                   c, m)
    return cond_fwd


_register("codon", "published CODONNet, X4/X8 flavor (incl. dead heads)",
          dead_heads=True)
_register("codon_fused", "CODONNet with merged-tower grouped convs: the same "
          "function and checkpoints as 'codon'; the int8 backends resolve "
          "its compound grouped site names to the packed sites' scales",
          codon_forward_fused, dead_heads=True)
_register("rmcr_fuse_rmcr", "attention-free CODON skeleton, sequential "
          "towers, no CAC", sequential_tower_forward, use_cac=False)
_register("codon_sc", "scale-conditioned CODONNet: the depth stem takes "
          "(depth, constant scale/16 plane); residual and head read "
          "channel 0; no dead heads", in_channels=2)
_register("codon_x16", "CODONNet without dead attention heads")
_register("codonet_x16_model", "CODON_X16/model/CODONet.py flavor: color "
          "cell concat swapped (3x3 first); weight-compatible with "
          "codon_x16", color_cat_swapped=True)
for _n in (4, 5, 6, 7):
    _register(f"codon_f{_n}", f"CODONNet with {_n} fusion MC iterations "
              "instead of 3 (one fusion weight set: checkpoints of 'codon' "
              "interchange)", dead_heads=True, num_fuse=_n)
