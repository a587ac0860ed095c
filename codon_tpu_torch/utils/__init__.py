"""The tee logger; the counterpart of `codon_tpu.utils` (its compile
cache has no counterpart: eager PyTorch compiles nothing per shape)."""
from codon_tpu_torch.utils.logging import Logger, mkdir_if_missing

__all__ = ["Logger", "mkdir_if_missing"]
