"""Sharded Ops backend: exact spatially tiled execution over an sp group.

The counterpart of `codon_tpu.parallel.ops`. The H axis of every activation
is sharded over the ranks of the mesh's sp group, and two things make the
sharded forward equal the single-device one:

  conv stencils  each stride-1 SAME conv needs (k - 1) // 2 rows of each
                 neighbour: `comm.halo_rows` brings them, the image's top
                 and bottom shards get zeros (SAME padding there), and the
                 conv pads W only (`conv2d_nhwc(..., halo=r)`)
  CAC gates      pool over the whole image: the sums, valid-pixel counts
                 and maxes of each shard are all-reduced over the sp group,
                 in `global_avg` / `global_max` / `global_sum` (the plain
                 stage) and in `cac_stage` (the kernel stage,
                 `kernels.cac.cac_stage` over the sp group)

Convs are SAME-padded in every backend of the port, so there is no other
padding to refuse. Grouped convs (`groups`, the merged-tower forward's)
exchange halo rows of the whole grouped input.
"""
from __future__ import annotations

import torch

from codon_tpu_torch.core.ops import TorchOps, conv2d_nhwc
from codon_tpu_torch.kernels import cac as _cac
from codon_tpu_torch.parallel.comm import all_max, all_sum, halo_rows


class ShardedOps(TorchOps):
    """Ops for one rank's shard of a spatially sharded image.

    mesh: this rank's `parallel.mesh.Mesh`; its sp group holds the image's
    shards, top to bottom in group-rank order.
    """

    def __init__(self, mesh):
        self.group = mesh.sp_group

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        del name
        r = (w.shape[0] - 1) // 2
        out = conv2d_nhwc(halo_rows(x, r, self.group), w, groups, halo=r)
        return self.apply_mask(out, mask)

    def global_avg(self, x, mask=None):
        if mask is None:
            s = x.sum(dim=(1, 2), keepdim=True)
            cnt = torch.full_like(s[..., :1], x.shape[1] * x.shape[2])
        else:
            m = mask.to(x.dtype)
            s = (x * m).sum(dim=(1, 2), keepdim=True)
            cnt = m.sum(dim=(1, 2), keepdim=True)
        both = all_sum(torch.cat([s, cnt], -1), self.group)
        return both[..., :-1] / both[..., -1:]

    def global_max(self, x, mask=None):
        return all_max(TorchOps.global_max(x, mask), self.group)

    def global_sum(self, x, mask=None):
        return all_sum(TorchOps.global_sum(x, mask), self.group)

    def cac_stage(self, out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w,
                  mask=None, dst=None):
        """The kernel stage with statistics pooled over every shard (the
        sp group); never the whole-image `TorchOps.cac_stage`, whose pools
        would be this shard's alone (finite, plausible and wrong)."""
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "training under a mesh (the sharded CacStageFunction) is "
                "ROADMAP Queue A item A13b")
        return _cac.cac_stage(out, out_c, inputs, inputs_c, w1, b1, w2, b2,
                              sp_w, mask, dst, group=self.group)


def cac_stage_on_shard(mesh, out, out_c, inputs, inputs_c, mask, w1, b1, w2,
                       b2, sp_w, impl="kernel"):
    """One CAC stage on this rank's shard, as `MeshPool.shard_map` calls
    it -> (new_out, new_out_c): the kernel stage over the sp group (impl
    "kernel") or its plain twin, `cac_stage_torch` under `ShardedOps` (impl
    "torch")."""
    from codon_tpu_torch.models.codon_net import cac_stage_torch
    args = (out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w)
    if impl == "torch":
        return cac_stage_torch(*args, mask=mask, ops=ShardedOps(mesh))
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'torch', got {impl!r}")
    return _cac.cac_stage(*args, mask, group=mesh.sp_group)
