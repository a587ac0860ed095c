"""codon_tpu_torch — the CODON depth super-resolution stack in PyTorch, for CUDA.

The PyTorch counterpart of `codon_tpu`, module for module. Plain tensor code
is PyTorch. The kernels are CUDA C++ for Hopper (`kernels/csrc/`), built
with `nvcc` at their first launch and bound with `ctypes`: the three fused
CAC-stage kernels that `codon_tpu` wrote in Pallas (`cac.cu`), the copies
of its HBM probe (`copy.cu`) and the int8 conv's quantize, gather and
dequant kernels (`quant.cu`). Each sits beside its plain PyTorch version,
which CPU tensors take. Public functions keep the JAX package's layouts
(NHWC activations, HWIO conv kernels, `(in, out)` linears), so the two
packages compare like with like on the same inputs and checkpoints.
Everything runs on the card unless the caller asks for the CPU.

Layout
------
core/        dtype policy, parameter init, the masked-ops backend
kernels/     the CUDA kernels, their plain versions, the custom ops that
             exported programs call, the nvcc build
models/      CODONNet's forwards, the variant registry, the ablation zoo,
             TTA
data/        8-bit grayscale PNG codec, batched host->device pipeline,
             OpenCV's bicubic and area resizes
metrics/     masked RMSE and the reference's SSIMs (host and tensors)
checkpoint/  .npz trees, the reference's .pth, training step directories
train/       the training step (optax's chain on tensors), patch sampler
parallel/    the dp x sp mesh of ranks: sharded eval and training
serve/       torch.export artifacts and their loader
utils/       tee logger
quant_ops.py the int8 families (static, dynamic, QAT)
cli.py       `python -m codon_tpu_torch.cli eval|train|golden|convert|
             export|info`
entry.py     the flagship forward and its example inputs, the dryrun
tools        profile_forward, perf_copy_probe, export_matrix, soup,
             sc_cond_probe, tta_shift_probe, ttt_probe (`python -m
             codon_tpu_torch.<tool>`)
"""

__version__ = "0.1.0"
