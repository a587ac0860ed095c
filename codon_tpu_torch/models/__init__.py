"""CODONNet, its variants and the ablation zoo; the counterpart of
`codon_tpu.models`."""
from codon_tpu_torch.models.codon_net import (CodonConfig, cac_channel_gate,
                                              cac_spatial_gate,
                                              codon_forward,
                                              init_codon_params)

__all__ = ["CodonConfig", "cac_channel_gate", "cac_spatial_gate",
           "codon_forward", "init_codon_params"]
