"""The training step and the patch sampler; the counterpart of
`codon_tpu.train`."""
from codon_tpu_torch.train.data import PatchSampler, synthesize_lr
from codon_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                           make_train_step)

__all__ = ["PatchSampler", "TrainConfig", "TrainState", "make_train_step",
           "synthesize_lr"]
