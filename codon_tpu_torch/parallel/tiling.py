"""Sharded execution of a forward over a dp x sp mesh of ranks.

The counterpart of `codon_tpu.parallel.tiling`. `make_sharded_forward`
returns rank 0's forward over a mesh: the batch axis rides dp (the
reference's DataParallel, CODON_X16/test.py:52), the image's H axis rides
sp, and on each rank `ShardedOps` (or the caller's backend) gives the
halo-exchange convs and the all-reduced CAC statistics, so the result
equals the single-device forward (tests/test_torch_parallel.py). The ranks
are a `launch.MeshPool`'s: rank 0 is the caller's process.

A parameter tree is sent to the ranks the first time a forward sees it
(by identity), and taken as unchanged after that.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from codon_tpu_torch.parallel.launch import (ForwardSpec, MeshPool,
                                             member_backend)
from codon_tpu_torch.parallel.stitch import params_device

# the widest stencil of the nets that run sharded: CODONNet's 5x5 convs
# and CAC spatial gate, and the zoo's 5x5 spatial gates, read 2 rows
# across each shard seam
MAX_HALO = 2


def check_blocks(mesh, B, H) -> None:
    """Raise ValueError unless a batch of B images of H rows cuts into the
    mesh's (dp, sp) blocks, each shard at least MAX_HALO rows."""
    if B % mesh.dp or H % mesh.sp:
        raise ValueError(f"batch {B} and height {H} must divide by the "
                         f"mesh's dp={mesh.dp} and sp={mesh.sp}")
    if mesh.sp > 1 and H // mesh.sp < MAX_HALO:
        raise ValueError(
            f"H={H} over sp={mesh.sp} leaves {H // mesh.sp} row(s) a "
            f"shard; the 5x5 stencils need at least {MAX_HALO}")


def make_sharded_forward(variant, mesh, ops_factory=None, local_ops=None,
                         scales_factory=None, check_nans=False):
    """(params, depth, color, mask) -> out over `mesh` (rank 0's handle,
    `MeshPool.mesh`), as JAX's shard_map'd forward.

    depth (B, H, W, Cd), color and mask (B, H, W, 1) on rank 0's device,
    B a multiple of dp and H of sp, each shard at least MAX_HALO rows; mask
    is required (pass ones). ops_factory(mesh) builds each sharded rank's
    backend (default `ShardedOps`; e.g. `parallel.quant.Int8ShardedOps`);
    local_ops is every rank's backend when sp = 1 (pure dp runs whole
    images, so a single-device backend such as `quant_ops.Int8Ops` is
    right there); scales_factory(act_scales, mesh or None) builds a
    static-int8 backend from the tree's `act_scales` at call time, so the
    scales ride each member's parameter tree. check_nans: every rank's
    backend checks each conv site's output (`launch.ForwardSpec`).
    """
    spec = ForwardSpec(variant, ops_factory, local_ops, scales_factory,
                       check_nans)
    members = {}

    def fwd(params, depth, color, mask):
        check_blocks(mesh, *depth.shape[:2])
        if mask is None:
            raise ValueError("the sharded forward takes a mask (pass ones)")
        seen = members.get(id(params))
        if seen is None or seen[0] is not params:
            seen = members[id(params)] = (
                params, mesh.pool.add_member(spec, params))
        return mesh.pool.forward(seen[1], mesh, depth, color, mask)

    return fwd


def _local_forward(spec):
    """The 1 x 1 mesh: the forward on this process alone, with the backend
    a mesh rank would take."""
    def fwd(params, depth, color, mask):
        ops, params = member_backend(spec, params)
        return spec.variant.forward(params, depth, color, mask=mask, ops=ops)
    return fwd


def _pad_rows(t, h, value=0.0):
    return F.pad(t, (0, 0, 0, 0, 0, h - t.shape[1]), value=value)


def tiled_infer(variant, params, depth, color, mask=None, mesh=None,
                n_devices=None, *, backend=None):
    """One-call tiled inference, as JAX's: depth/color (B, H, W, 1) arrays
    -> numpy (B, H, W, 1). H is padded to a multiple of the mesh's sp (zero
    rows, a zero mask), sharded, run and cropped back.

    mesh: a `MeshPool.mesh`; without one, a pool of `n_devices` ranks on
    sp is started on the params' device with `backend` and closed after.
    """
    dev = params_device(params)
    own = None
    if mesh is None:
        own = MeshPool(n_devices, device=dev, backend=backend)
        mesh = own.mesh(1, n_devices)
    try:
        d = torch.as_tensor(np.asarray(depth)).to(dev)
        c = torch.as_tensor(np.asarray(color)).to(dev)
        B, H, W, _ = d.shape
        m = (torch.ones((B, H, W, 1), device=dev) if mask is None
             else torch.as_tensor(np.asarray(mask)).to(dev))
        hp = -(-H // mesh.sp) * mesh.sp
        fwd = make_sharded_forward(variant, mesh)
        out = fwd(params, _pad_rows(d, hp), _pad_rows(c, hp),
                  _pad_rows(m, hp))
        return out[:, :H].cpu().numpy()
    finally:
        if own is not None:
            own.close()


def make_tiled_forward(variant, n_devices: int, dp_devices: int = 1,
                       ops_factory=None, local_ops=None, scales_factory=None,
                       *, pool=None, device="cuda", backend=None,
                       check_nans=False):
    """The cli's hook: fwd(params, depth, color, mask) over a dp x sp mesh.

    n_devices shards the image's H axis (sp), dp_devices the batch (dp);
    either may be 1. Batches are padded to a multiple of dp with all-ones
    masks (an all-zero mask would divide 0 / 0 in the CAC average pool)
    and H to a multiple of sp with zero rows and a zero mask; both pads are
    cropped from the output. pool: a `MeshPool` of at least dp * sp ranks
    to run on (several members can share one); without one, the forward
    starts its own on `device` with `backend`, closed by `fwd.close()`.
    check_nans as in `make_sharded_forward`.
    """
    sp, dp = max(1, n_devices), max(1, dp_devices)
    own = None
    if sp * dp == 1:
        inner = _local_forward(ForwardSpec(variant, None, local_ops,
                                           scales_factory, check_nans))
    else:
        if pool is None:
            pool = own = MeshPool(sp * dp, device=device, backend=backend)
        inner = make_sharded_forward(variant, pool.mesh(dp, sp), ops_factory,
                                     local_ops, scales_factory, check_nans)

    def run(params, depth, color, mask):
        B, H, W, _ = depth.shape
        hp, bp = -(-H // sp) * sp, -(-B // dp) * dp
        if mask is None:
            mask = torch.ones((B, H, W, 1), device=depth.device)
        if hp != H:
            depth, color, mask = (_pad_rows(t, hp)
                                  for t in (depth, color, mask))
        if bp != B:
            pad = (0, 0, 0, 0, 0, 0, 0, bp - B)
            depth = F.pad(depth, pad)
            color = F.pad(color, pad)
            mask = F.pad(mask, pad, value=1.0)
        return inner(params, depth, color, mask)[:B, :H]

    run.close = own.close if own is not None else (lambda: None)
    return run
