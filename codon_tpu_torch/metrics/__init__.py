"""Masked RMSE and the reference's SSIMs, on the host and on tensors; the
counterpart of `codon_tpu.metrics` (its `_jnp` forms are the `_torch`
ones)."""
from codon_tpu_torch.metrics.rmse import masked_rmse, masked_rmse_torch
from codon_tpu_torch.metrics.ssim import (ssim_block, ssim_exact,
                                          ssim_exact_torch)

__all__ = ["masked_rmse", "masked_rmse_torch", "ssim_block", "ssim_exact",
           "ssim_exact_torch"]
