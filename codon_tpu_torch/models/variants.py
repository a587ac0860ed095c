"""Model-variant registry: each name pairs a config with its forward and its
init, as `codon_tpu.models.variants` does, and holds the same 37 names.

The CODONNet family runs `codon_forward`, the merged-tower `codon_fused`
(`codon_forward_fused`) and the attention-free `rmcr_fuse_rmcr`
(`sequential_tower_forward`) on `init_codon_params`' tree. Every net of the
ablation zoo is addressable as "zoo:<name>" (`models.zoo`), with the zoo's
own init and forward. Every `Variant` pickles (its functions are
module-level functions or instances of module-level classes), so a mesh
rank receives one by value.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from codon_tpu_torch.core.params import DTypePolicy, FP32
from codon_tpu_torch.models import zoo
from codon_tpu_torch.models.codon_net import (
    CodonConfig, codon_forward, codon_forward_fused,
    codon_forward_fused_train, codon_forward_train, init_codon_params,
    sequential_tower_forward, sequential_tower_forward_train)

# each eval forward's grad-enabled sibling; the zoo's are added below
_TRAIN_FORWARDS = {codon_forward: codon_forward_train,
                   codon_forward_fused: codon_forward_fused_train,
                   sequential_tower_forward: sequential_tower_forward_train}
# the X4/X8 checkpoint-compat heads: no CODONNet forward reads them, and a
# warm start from an X4 checkpoint carries them into every CODONNet variant
_DEAD_HEADS = ("attention_c5", "attention_s5")


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    cfg: CodonConfig
    doc: str = ""
    forward_fn: Callable = codon_forward
    # (gen, cfg, device=...) -> the variant's parameter tree
    init_fn: Callable = init_codon_params
    # top-level parameter names that the forward never reads: the trainer
    # gives them a zero gradient, and raises for any other leaf that gets
    # none
    unread: tuple = ()

    def init(self, gen, device="cuda"):
        return self.init_fn(gen, self.cfg, device=device)

    def forward(self, params, depth, color, mask=None, ops=None):
        return self.forward_fn(params, depth, color, cfg=self.cfg, mask=mask,
                               ops=ops)

    def check_trainable(self) -> None:
        """Raise NotImplementedError unless the variant has a training
        forward."""
        if self.forward_fn not in _TRAIN_FORWARDS:
            raise NotImplementedError(
                f"variant {self.name!r} has no training forward")

    def train_forward(self, params, depth, color, mask=None, ops=None):
        """The forward with autograd on, for training."""
        self.check_trainable()
        return _TRAIN_FORWARDS[self.forward_fn](
            params, depth, color, cfg=self.cfg, mask=mask, ops=ops)


# name -> (builder(dtypes) -> Variant, doc)
_REGISTRY: Dict[str, tuple] = {}


def register(name: str, doc: str = ""):
    """Decorator: add `builder(dtypes) -> Variant` to the registry under
    `name`, as `codon_tpu.models.variants.register` does; `get_variant`
    gives the variant `doc`. Returns the builder."""
    def deco(builder):
        _REGISTRY[name] = (builder, doc)
        return builder
    return deco


def _register(name: str, doc: str, forward_fn=codon_forward,
              **cfg_fields) -> None:
    unread = _DEAD_HEADS + (() if cfg_fields.get("use_cac", True)
                            else ("cac",))

    @register(name, doc)
    def builder(dtypes):
        return Variant(name, CodonConfig(dtypes=dtypes, **cfg_fields), doc,
                       forward_fn, unread=unread)


@dataclasses.dataclass(frozen=True)
class _ZooInit:
    """A zoo net's init, (gen, cfg, device=...) -> its flat tree. A
    module-level class, so a zoo `Variant` pickles by value to a mesh
    rank."""
    zname: str

    def __call__(self, gen, cfg, device="cuda"):
        return zoo.zoo_init(self.zname, gen, dtype=cfg.dtypes.param_dtype,
                            device=device)


@dataclasses.dataclass(frozen=True)
class _ZooForward:
    """A zoo net's forward: under `torch.no_grad()` for eval, with autograd
    as the caller has it for training (`grad`). Equal instances hash
    alike, so an unpickled eval forward still finds its training sibling
    in `_TRAIN_FORWARDS`."""
    zname: str
    grad: bool = False

    def __call__(self, params, depth, color, *, cfg, mask=None, ops=None):
        with torch.set_grad_enabled(self.grad and torch.is_grad_enabled()):
            return zoo.zoo_forward(self.zname, params, depth, color,
                                   dtypes=cfg.dtypes, ops=ops, mask=mask)


def _register_zoo(zname: str) -> None:
    entry = zoo.ZOO[zname]
    eval_fn = _ZooForward(zname)
    _TRAIN_FORWARDS[eval_fn] = _ZooForward(zname, grad=True)

    @register(f"zoo:{zname}", entry["doc"])
    def builder(dtypes):
        return Variant(f"zoo:{zname}", CodonConfig(dtypes=dtypes),
                       entry["doc"], eval_fn, _ZooInit(zname),
                       entry["unread"])


def get_variant(name: str, dtypes: DTypePolicy = FP32) -> Variant:
    if name not in _REGISTRY:
        raise KeyError(f"unknown variant '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    builder, doc = _REGISTRY[name]
    return dataclasses.replace(builder(dtypes), doc=doc)


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
for _z in zoo.list_zoo():
    _register_zoo(_z)
