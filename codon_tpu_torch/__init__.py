"""codon_tpu_torch — the CODON depth super-resolution stack in PyTorch, for CUDA.

The PyTorch counterpart of `codon_tpu`, module for module. Plain tensor code
is PyTorch; the three fused CAC-stage kernels that `codon_tpu` wrote in Pallas
are CUDA C++ for Hopper (`kernels/csrc/cac.cu`), built with `nvcc` at first
use and bound with `ctypes`. Public functions keep the JAX package's layouts
(NHWC activations, HWIO conv kernels, `(in, out)` linears), so the two
packages compare like with like on the same inputs and checkpoints.

Layout
------
core/        dtype policy, parameter init, the masked-ops backend
kernels/     CUDA CAC kernels, their plain PyTorch versions, the nvcc build
models/      CODONNet forward + the variant registry
data/        8-bit grayscale PNG codec, batched host->device pipeline
metrics/     masked RMSE and scipy Gaussian SSIM (host)
checkpoint/  native .npz load/save, numpy tree -> tensors
utils/       tee logger
cli.py       `python -m codon_tpu_torch.cli eval`
"""

__version__ = "0.1.0"
