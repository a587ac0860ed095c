"""The CUDA kernels, their plain PyTorch versions and the nvcc build;
the counterpart of `codon_tpu.kernels` (its `cac_stage_pallas` is
`cac_stage`)."""
# registers the custom ops (torch.ops.codon.*) that the kernel wrappers
# dispatch through and that exported programs call
from codon_tpu_torch.kernels import ops  # noqa: F401
from codon_tpu_torch.kernels.cac import cac_stage, cac_stats, spatial_logits

__all__ = ["cac_stage", "cac_stats", "spatial_logits"]
