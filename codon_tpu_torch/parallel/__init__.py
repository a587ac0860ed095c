"""Multi-device inference and training: the dp x sp mesh of
`torch.distributed` ranks, the halo-exchange Ops backend with
differentiable collectives, sharded forwards, the sharded training step
(`parallel.train`, reached through `make_train_step(..., mesh=)`) and
tile-and-stitch; the counterpart of `codon_tpu.parallel`."""
from codon_tpu_torch.parallel.launch import MeshPool
from codon_tpu_torch.parallel.mesh import make_mesh
from codon_tpu_torch.parallel.ops import ShardedOps
from codon_tpu_torch.parallel.stitch import tile_stitch_infer
from codon_tpu_torch.parallel.tiling import (make_sharded_forward,
                                             make_tiled_forward, tiled_infer)

__all__ = ["MeshPool", "ShardedOps", "make_mesh", "make_sharded_forward",
           "make_tiled_forward", "tile_stitch_infer", "tiled_infer"]
