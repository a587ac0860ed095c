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

Under autograd the same backend trains: `halo_rows`, `all_sum` and
`global_max` are differentiable collectives (`parallel.comm`), and the
kernel stage is `kernels.cac.CacStageFunction` over the sp group, so the
sharded gradient equals the single-device one (JAX gets this from the
transpose rules of `ppermute`, `psum` and `all_gather`).

Convs are SAME-padded in every backend of the port, so there is no other
padding to refuse. Grouped convs (`groups`, the merged-tower forward's)
exchange halo rows of the whole grouped input. The zoo's gates run 1x1
convs on pooled (N, 1, 1, C) vectors, replicated on every shard: halo 0,
no exchange (`check_pooled`). Its whole-image attention (`pam`, `cam`)
raises on a sharded backend (`sharded`), where it would attend within a
shard; no zoo net calls it.
"""
from __future__ import annotations

import torch

from codon_tpu_torch.core.ops import TorchOps, conv2d_nhwc
from codon_tpu_torch.kernels import cac as _cac
from codon_tpu_torch.parallel.comm import all_sum, global_max, halo_rows


def check_pooled(x, r):
    """Raise unless a conv of halo r may run on x: a pooled (N, 1, 1, C)
    vector (RCAN's `ca_layer`, the zoo's channel gates) is the same on
    every shard, not a block of rows, so only a 1x1 conv (r = 0, no halo
    exchange) runs on it."""
    if r and x.shape[1] == 1 and x.shape[2] == 1:
        raise ValueError(f"a {2 * r + 1}x{2 * r + 1} conv on a pooled "
                         f"{tuple(x.shape)} vector: the vector is "
                         f"replicated on every shard, so it takes 1x1 "
                         f"convs only")


class ShardedOps(TorchOps):
    """Ops for one rank's shard of a spatially sharded image.

    mesh: this rank's `parallel.mesh.Mesh`; its sp group holds the image's
    shards, top to bottom in group-rank order. group: that group itself,
    in place of a mesh (`CacStageFunction`'s backward).
    """

    # whole-image attention (`models.attention.pam`, `cam`) refuses a
    # backend that holds one shard of the image
    sharded = True

    def __init__(self, mesh=None, group=None):
        self.group = mesh.sp_group if mesh is not None else group

    def conv2d(self, x, w, *, mask=None, groups=1, name=None):
        del name
        r = (w.shape[0] - 1) // 2
        check_pooled(x, r)
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
        if mask is not None:
            x = x.masked_fill(mask == 0, float("-inf"))
        return global_max(x, self.group)

    def global_sum(self, x, mask=None):
        return all_sum(TorchOps.global_sum(x, mask), self.group)

    def cac_stage(self, out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w,
                  mask=None, dst=None):
        """The kernel stage with statistics pooled over every shard (the
        sp group); never the whole-image `TorchOps.cac_stage`, whose pools
        would be this shard's alone (finite, plausible and wrong). Under
        autograd, `CacStageFunction` over the sp group (no `dst` there)."""
        args = (out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w)
        if torch.is_grad_enabled():
            if dst is not None:
                raise ValueError("the training stage returns fresh towers; "
                                 "dst is an eval-only form")
            return _cac.CacStageFunction.apply(*args, mask, self.group)
        return _cac.cac_stage(*args, mask, dst, group=self.group)


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


def shard_cotangent(shape, seed, dp_index, sp_index, device="cpu"):
    """The cotangent `collective_grad_on_shard` gives the output of mesh
    coordinate (d, s): float32 N(0, 1) from seed + 100 d + s."""
    g = torch.Generator().manual_seed(seed + 100 * dp_index + sp_index)
    return torch.randn(tuple(shape), generator=g).to(device)


def collective_grad_on_shard(mesh, x, mask, kind, r, seed):
    """The gradient of one differentiable collective over the sp group on
    this rank's shard x, as `MeshPool.shard_map` calls it -> x's gradient
    for the cotangent `shard_cotangent(output shape, seed, d, s)`. kind:
    "halo_rows" (r rows), "all_sum" or "global_max"
    (`ShardedOps.global_max` under `mask`). The probe that holds each
    backward against the unsharded function's."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        if kind == "halo_rows":
            y = halo_rows(x, r, mesh.sp_group)
        elif kind == "all_sum":
            y = all_sum(x, mesh.sp_group)
        elif kind == "global_max":
            y = ShardedOps(mesh).global_max(x, mask)
        else:
            raise ValueError(f"kind must be 'halo_rows', 'all_sum' or "
                             f"'global_max', got {kind!r}")
        g = shard_cotangent(y.shape, seed, mesh.dp_index, mesh.sp_index,
                            x.device).to(y.dtype)
        gx, = torch.autograd.grad(y, x, g)
    return gx


def cac_stage_grads_on_shard(mesh, out, out_c, inputs, inputs_c, mask, g,
                             g_c, w1, b1, w2, b2, sp_w):
    """`CacStageFunction` over the sp group on this rank's shard and its
    gradients for the cotangents (g, g_c), as `MeshPool.shard_map` calls
    it -> (new_out, new_out_c, the four towers' gradients, and the
    weights' [w1 | b1 | w2 | b2 | sp_w] gradients summed over the group,
    flat, repeated at every (image, row) of the shard)."""
    xs = [t.detach().requires_grad_(True) for t in
          (out, out_c, inputs, inputs_c, w1, b1, w2, b2, sp_w)]
    with torch.enable_grad():
        new = _cac.CacStageFunction.apply(*xs, mask, mesh.sp_group)
        grads = torch.autograd.grad(new, xs, (g, g_c))
    wg = all_sum(torch.cat([t.reshape(-1) for t in grads[4:]]),
                 mesh.sp_group)
    n, h = out.shape[:2]
    return (*(t.detach() for t in new), *grads[:4],
            wg.expand(n, h, -1).contiguous())
