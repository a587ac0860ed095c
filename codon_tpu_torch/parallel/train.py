"""Sharded training over a dp x sp mesh of ranks: the counterpart of
`codon_tpu.train.trainer.make_train_step(..., mesh=)`.

JAX differentiates through its shard_map'd forward, because `ppermute`,
`psum` and `all_gather` have transpose rules. Here every rank of the mesh
(`launch.MeshPool`) runs the forward and backward of its (dp, sp) block
of the batch, through an Ops backend whose collectives are
differentiable (`parallel.ops.ShardedOps`, `parallel.comm`), and then:

  loss       each rank differentiates its own part of the loss: its
             masked error sum over the mesh-wide valid-pixel count (and,
             with grad_weight, its differences along H and W over the
             mesh-wide pair count; the pairs across an sp seam take the
             first row of `out`, `label` and `mask` from the shard below,
             a 1-row exchange, differentiable for `out`). The counts are
             summed over the mesh first and carry no gradient. The parts
             add up to JAX's loss on the whole batch.
  gradients  after `torch.autograd.grad` on each rank, one all-reduce over
             the mesh group of one flat float32 buffer, [every leaf's
             gradient | the loss numerators]: one collective in one fixed
             order on every rank (no per-parameter hooks, whose order
             differs between ranks). `grad_norm`, clipping and
             `check_finite` then read the summed gradients, so every rank
             decides alike.
  update     every rank applies the same optimizer update to its own
             replica of the parameters and optimizer state; rank 0's are
             the caller's own tensors, updated in place as on one device.

A spatially sharded rank (sp > 1) runs the sharded twin of the step's
backend: `ShardedOps` for float training (its CAC kernel stage is
`CacStageFunction` over the sp group), `parallel.quant`'s fake-quant twins
for QAT. A rank of a pure-dp mesh (sp = 1) holds whole images and runs
the single-device backend. `MeshTrainStep` is rank 0's handle, with the
single-device step's signature.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import torch

from codon_tpu_torch.parallel import comm, launch
from codon_tpu_torch.parallel.ops import ShardedOps
from codon_tpu_torch.parallel.quant import (FakeQuantShardedOps,
                                            FakeQuantStaticShardedOps)
from codon_tpu_torch.parallel.tiling import check_blocks
from codon_tpu_torch.quant_ops import FakeQuantOps, FakeQuantStaticOps
from codon_tpu_torch.train.trainer import (TrainConfig, TrainStep,
                                           loss_of_sums, loss_sums,
                                           make_optimizer, tree_items)


def backend_spec(ops):
    """The single-device training backend -> (kind, act_scales), what each
    rank builds its own from (`rank_backend`): None (float), FakeQuantOps
    or FakeQuantStaticOps. Any other backend raises NotImplementedError, as
    JAX's make_train_step does under a mesh."""
    if ops is None:
        return ("float", None)
    if isinstance(ops, FakeQuantStaticOps):
        return ("fake_quant_static",
                {k: v.detach().cpu() for k, v in ops.act_scales.items()})
    if isinstance(ops, FakeQuantOps):
        return ("fake_quant", None)
    raise NotImplementedError(
        f"make_train_step: no sharded twin for ops backend "
        f"{type(ops).__name__} — train it single-device")


def rank_backend(spec, mesh, device):
    """A rank's backend from `backend_spec`'s spec: the sharded twin on a
    spatial shard (sp > 1), the single-device backend on whole images
    (sp = 1; None is the float default)."""
    kind, scales = spec
    if scales is not None:
        scales = {k: v.to(device) for k, v in scales.items()}
    if mesh.sp > 1:
        if kind == "float":
            return ShardedOps(mesh)
        if kind == "fake_quant":
            return FakeQuantShardedOps(mesh)
        return FakeQuantStaticShardedOps(scales, mesh)
    if kind == "float":
        return None
    if kind == "fake_quant":
        return FakeQuantOps()
    return FakeQuantStaticOps(scales)


def shard_loss(out, batch, cfg: TrainConfig, mesh):
    """This rank's part of `trainer.masked_loss` on the whole batch ->
    (the part, to differentiate; (its numerators [error sum, difference
    sum], the mesh-wide [valid pixels, valid pairs]), detached).

    The parts of every rank add up to the loss. The pairs along H across
    a seam belong to the upper shard, which takes the first row of the
    shard below (zeros below the image's last row, whose mask then drops
    the pair)."""
    below = None
    if cfg.grad_weight and mesh.sp > 1:
        below = comm.halo_rows(
            torch.cat([out, batch["label"], batch["mask"]], -1), 1,
            mesh.sp_group)[:, -1:]
    num, den, gnum, gden = loss_sums(out, batch, cfg, below)
    dens = comm.all_sum(torch.stack([den, gden]).detach(), mesh.group)
    part = loss_of_sums(cfg, num, dens[0], gnum, dens[1])
    return part, (torch.stack([num, gnum]).detach(), dens)


class ShardTrainStep(TrainStep):
    """One rank's training step on its block: `TrainStep` with the shard's
    part of the loss, and `value_and_grad` summing over the mesh group ->
    the loss of the whole batch and the gradient of every leaf, the same
    on every rank. `__call__` is `TrainStep`'s (finite check, norm,
    update)."""

    def __init__(self, variant, cfg, mesh, ops=None, check_finite=False):
        super().__init__(variant, cfg, ops=ops, check_finite=check_finite)
        self.mesh = mesh

    def _objective(self, params, batch):
        out = self.variant.train_forward(params, batch["depth"],
                                         batch["color"], mask=batch["mask"],
                                         ops=self.ops)
        return shard_loss(out, batch, self.cfg, self.mesh)

    def value_and_grad(self, params, batch):
        _, (nums, dens), grads = self._leaf_grads(params, batch)
        flat = comm.all_sum(torch.cat([g.float().reshape(-1) for g in grads]
                                      + [nums.float()]), self.mesh.group)
        summed = [t.view_as(g) for t, g in
                  zip(flat[:-2].split([g.numel() for g in grads]), grads)]
        return loss_of_sums(self.cfg, flat[-2], dens[0], flat[-1],
                            dens[1]), summed


@dataclasses.dataclass
class TrainSpec:
    """What every rank needs to build its step: pickled by value."""
    variant: Any
    cfg: TrainConfig
    backend: tuple                 # backend_spec(ops)
    check_finite: bool = False


def _unpack(block, c_depth):
    return {"depth": block[..., :c_depth],
            "color": block[..., c_depth:c_depth + 1],
            "label": block[..., c_depth + 1:c_depth + 2],
            "mask": block[..., c_depth + 2:]}


def shard_train_step(mesh, block, slot, c_depth, update):
    """A trainer's step on this rank's block (N, h, W, c_depth + 3) of
    packed [depth | color | label | mask], as `MeshPool.shard_map` calls
    it -> the step's metrics (update) or (loss, gradients) without the
    update. The rank's replica in `slot` is updated in place."""
    entry = launch._RANK.trainers[slot]
    key = (mesh.dp, mesh.sp)
    step = entry["steps"].get(key)
    if step is None:
        spec = entry["spec"]
        ops = rank_backend(spec.backend, mesh, launch._RANK.device)
        step = entry["steps"][key] = ShardTrainStep(
            spec.variant, spec.cfg, mesh, ops=ops,
            check_finite=spec.check_finite)
    batch = _unpack(block, c_depth)
    if not update:
        return step.value_and_grad(entry["params"], batch)
    _, entry["opt_state"], metrics = step(entry["params"],
                                          entry["opt_state"], batch)
    return metrics


def replica_digest(slot) -> str:
    """sha256 of this rank's replica in a trainer slot: every leaf of its
    parameters and optimizer state, bytes and shapes, and the step count;
    equal on every rank when the replicas are bitwise equal."""
    entry = launch._RANK.trainers[slot]
    h = hashlib.sha256()
    state = entry["opt_state"] or {}
    h.update(str(state.get("count")).encode())
    for tree in (entry["params"], state.get("mu", {}), state.get("nu", {})):
        for path, t in tree_items(tree):
            a = t.detach().cpu().contiguous()
            h.update(f"{path}{tuple(a.shape)}{a.dtype}".encode())
            h.update(a.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class MeshTrainStep:
    """step(params, opt_state, batch) -> (params, opt_state, metrics) over
    a dp x sp mesh: the single-device `TrainStep`'s signature, run by
    every rank of `mesh` (rank 0's handle, `MeshPool.mesh`) on its block.

    batch: {"depth", "color", "label", "mask"} (B, H, W, C) on rank 0's
    device, B a multiple of dp and H of sp, each shard at least
    `tiling.MAX_HALO` rows. metrics: {"loss", "grad_norm"} of the whole
    batch, 0-d float32 on rank 0's device. The parameter tree and
    optimizer state are sent to the ranks the first time the step sees
    them, and again when the caller passes a tree, or a state, other than
    the one it sent or returned last (by identity); in between each
    rank's replica is taken as unchanged. `value_and_grad(params,
    batch)` -> (loss, the summed gradients), without the update. ops:
    None, FakeQuantOps or FakeQuantStaticOps (`backend_spec`).
    """

    def __init__(self, variant, cfg: TrainConfig, mesh, ops=None,
                 check_finite: bool = False):
        variant.check_trainable()
        self.spec = TrainSpec(variant, cfg, backend_spec(ops),
                              check_finite)
        self.mesh = mesh
        self.opt = make_optimizer(cfg)
        self.slot = None
        self._params = self._state = None

    def _sync(self, params, opt_state):
        """Send the tree and state to every rank unless they are the ones
        the ranks hold."""
        if (self.slot is not None and params is self._params
                and (opt_state is None or opt_state is self._state)):
            return
        entry = {"spec": self.spec, "params": params,
                 "opt_state": opt_state, "steps": {}}
        self.slot = self.mesh.pool.set_trainer(self.slot, entry)
        self._params, self._state = params, opt_state

    def _run(self, params, opt_state, batch, update):
        check_blocks(self.mesh, *batch["depth"].shape[:2])
        self._sync(params, opt_state)
        packed = torch.cat([batch[k].float() for k in
                            ("depth", "color", "label", "mask")], -1)
        return self.mesh.pool.shard_map(
            shard_train_step, self.mesh, packed,
            consts=(self.slot, batch["depth"].shape[-1], update),
            gather=False)

    def value_and_grad(self, params, batch):
        return self._run(params, None, batch, update=False)

    def __call__(self, params, opt_state, batch):
        metrics = self._run(params, opt_state, batch, update=True)
        self._state = self.mesh.pool.trainer(self.slot)["opt_state"]
        return params, self._state, metrics
