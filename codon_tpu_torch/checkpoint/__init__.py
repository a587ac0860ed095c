"""Checkpoints: the reference's `.pth` files, native `.npz` trees and the
trainer's step directories; the counterpart of `codon_tpu.checkpoint`
(orbax's names aside: the port's `CheckpointManager` writes its own
`step_<n>/tree.npz`)."""
from codon_tpu_torch.checkpoint.manager import CheckpointManager
from codon_tpu_torch.checkpoint.native import load_npz, save_npz
from codon_tpu_torch.checkpoint.torch_convert import (
    load_pth, params_to_torch_state_dict, torch_state_dict_to_params)

__all__ = ["CheckpointManager", "load_npz", "load_pth",
           "params_to_torch_state_dict", "save_npz",
           "torch_state_dict_to_params"]
