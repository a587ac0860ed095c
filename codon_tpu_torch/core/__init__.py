"""The dtype policy, parameter init and the masked-ops backend
(`TorchOps`, JAX's `XlaOps`); the counterpart of `codon_tpu.core`."""
from codon_tpu_torch.core.ops import TorchOps
from codon_tpu_torch.core.params import (DTypePolicy, conv_kernel_init,
                                         linear_init)

__all__ = ["DTypePolicy", "TorchOps", "conv_kernel_init", "linear_init"]
