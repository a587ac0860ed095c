"""PNG IO and the batched host -> device pipeline; the counterpart of
`codon_tpu.data`."""
from codon_tpu_torch.data.io import (Sample, discover_pairs, imread_gray,
                                     imwrite_gray)
from codon_tpu_torch.data.pipeline import Batch, batched_loader

__all__ = ["Batch", "Sample", "batched_loader", "discover_pairs",
           "imread_gray", "imwrite_gray"]
