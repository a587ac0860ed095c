"""Parameter initialization and dtype policy.

Same distributions as `codon_tpu.core.params`: He init N(0, sqrt(2/(k^2 C_out)))
for conv kernels and U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linears, drawn
from a `torch.Generator` (the numbers differ from `jax.random`'s; the
distributions do not). Layouts follow the JAX package: HWIO conv kernels,
`(in, out)` linear weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from codon_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Params stored in `param_dtype`; activations computed in `compute_dtype`.

    Every policy runs float32 convs and matmuls in full float32 (TF32 off,
    see `full_fp32`), the counterpart of `precision="highest"` in the JAX
    package's FP32 policy; bf16/fp16 convs accumulate in float32 on the
    tensor cores either way.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


FP32 = DTypePolicy()
BF16 = DTypePolicy(compute_dtype=torch.bfloat16)
FP16 = DTypePolicy(compute_dtype=torch.float16)

# "int8" computes its float parts (the convs that stay float, the CAC
# stage, the adds) under the bf16 policy; the quantized convs run in the
# backends of `codon_tpu_torch.quant_ops`, as in `codon_tpu.core.params`
DTYPE_POLICIES = {"fp32": FP32, "bf16": BF16, "fp16": FP16, "int8": BF16}


@contextlib.contextmanager
def full_fp32():
    """Turn TF32 off for cuDNN convs and cuBLAS matmuls inside the block.

    PyTorch runs float32 cuDNN convs in TF32 by default (about three
    decimal digits); parity with the JAX package's "highest" precision
    needs true float32. The previous settings are restored on exit.
    """
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def conv_kernel_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                     c_out: int, dtype=torch.float32,
                     device="cuda") -> torch.Tensor:
    """He-style init, std = sqrt(2 / (kh*kw*c_out)); HWIO (kh, kw, c_in, c_out)."""
    std = math.sqrt(2.0 / (kh * kw * c_out))
    w = torch.randn((kh, kw, c_in, c_out), generator=gen, dtype=torch.float32)
    return (std * w).to(device=resolve_device(device), dtype=dtype)


def linear_init(gen: torch.Generator, c_in: int, c_out: int,
                dtype=torch.float32, device="cuda"):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)); returns (w (c_in, c_out), b (c_out,))."""
    bound = 1.0 / math.sqrt(c_in)
    device = resolve_device(device)

    def uni(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return ((2.0 * u - 1.0) * bound).to(device=device, dtype=dtype)

    return uni((c_in, c_out)), uni((c_out,))

