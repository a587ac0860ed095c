"""The dp x sp mesh of ranks.

The counterpart of `codon_tpu.parallel.mesh`. JAX lays a `Mesh` over the
devices of one process; here each (dp, sp) coordinate is a rank of the
process group (`parallel.launch.MeshPool` starts them), and the mesh is
the pair of subgroups every rank needs:

  dp  batch data parallelism over images (the reference's DataParallel,
      CODON_X16/test.py:52)
  sp  the image's H axis sharded over ranks, halo-exchange convs and
      all-reduced CAC statistics over the rank's sp group

and the group of all dp * sp ranks, over which a sharded training step
sums its loss and its gradients.

Rank d * sp + s holds coordinate (d, s): the first dp * sp ranks of the
world form the mesh, the rest sit it out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    dp: int
    sp: int
    rank: int                      # this process's rank in the world
    dp_index: Optional[int]        # None outside the mesh
    sp_index: Optional[int]
    sp_group: Any = None           # the ranks of this rank's image row
    dp_group: Any = None           # the ranks of this rank's sp column
    group: Any = None              # every rank of the mesh
    pool: Any = None               # rank 0's MeshPool, which drives it

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def member(self) -> bool:
        return self.dp_index is not None


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "sp")) -> Mesh:
    """Build the (dp, sp) mesh over the process group's ranks.

    Every rank of the world calls it with the same sizes (creating a
    subgroup is collective). Default: all ranks on sp. Raises ValueError
    when the sizes need more ranks than the world has, as JAX's does for
    devices.
    """
    if tuple(axis_names) != ("dp", "sp"):
        raise ValueError(f"the mesh's axes are ('dp', 'sp'), got "
                         f"{tuple(axis_names)}")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (1, world)
    dp, sp = (int(a) for a in axis_sizes)
    need = dp * sp
    if dp < 1 or sp < 1 or need > world:
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} needs {need} "
                         f"ranks, only {world} available")
    rank = dist.get_rank()
    inside = rank < need
    mesh = Mesh(dp, sp, rank, rank // sp if inside else None,
                rank % sp if inside else None)
    # every rank enters every new_group, in the same order
    for d in range(dp):
        g = dist.new_group([d * sp + s for s in range(sp)])
        if mesh.dp_index == d:
            mesh.sp_group = g
    for s in range(sp):
        g = dist.new_group([d * sp + s for d in range(dp)])
        if mesh.sp_index == s:
            mesh.dp_group = g
    g = dist.new_group(list(range(need)))
    if inside:
        mesh.group = g
    return mesh
