# registers the custom ops (torch.ops.codon.*) that the kernel wrappers
# dispatch through and that exported programs call
from codon_tpu_torch.kernels import ops  # noqa: F401
