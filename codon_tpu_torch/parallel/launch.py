"""The single-controller surface of a mesh: rank 0 in the caller's process,
the other ranks in worker processes it drives.

JAX drives every device of a `Mesh` from one process inside `shard_map`.
PyTorch's idiom is one process a rank under `torch.distributed`. A
`MeshPool` keeps JAX's single-call surface over it: the caller's process is
rank 0, keeps the host pipeline, and starts `world - 1` worker ranks with
`torch.multiprocessing` (spawn), which import `codon_tpu_torch` and
nothing else. Rank 0 drives them through one pipe each, not through the
process group: a worker waits for its next command outside any
collective, so an idle pool never meets the group's timeout. Commands:

  mesh     every rank builds the (dp, sp) subgroups (`parallel.mesh`)
  member   a forward's variant, backend factories and parameter tree (its
           `act_scales` included), sent once, pickled by value
  forward  a small header (member, mesh, block shape) to every rank; rank 0
           then scatters the (dp, sp) blocks of the padded batch (depth,
           colour and mask packed in one float32 tensor), every rank of the
           mesh runs its block, and rank 0 gathers the outputs
  trainer  a training step's variant, config and backend, and the
           parameter tree and optimizer state every rank keeps a replica
           of, sent once into a slot, pickled by value (`parallel.train`);
           a step is then a `shard_map` without the gather: rank 0
           scatters the blocks of [depth | color | label | mask], every
           rank of the mesh runs its block's step, and rank 0 keeps its
           own result
  call     a module-level function of the package run on every rank (the
           launch and collective counters)
  stop     a clean shutdown

A failure never hangs and is never swallowed. The process group has a
timeout, so a collective whose peer stopped answering raises after it (a
peer that exited fails it at once). A worker that raises sends its
traceback to rank 0 and exits; rank 0, whose own step then fails, or which
reads the traceback in the worker's reply, raises `MeshError` with it. A
failed call leaves the pool closed: the ranks' collectives are out of step,
so the workers are stopped and every later call raises.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.core.ops import NanCheckOps, TorchOps
from codon_tpu_torch.parallel import comm
from codon_tpu_torch.parallel.mesh import make_mesh
from codon_tpu_torch.parallel.ops import ShardedOps

DEFAULT_TIMEOUT_S = 120.0
# how long rank 0 waits for the tracebacks of the workers after a failure
ERROR_GRACE_S = 5.0


class MeshError(RuntimeError):
    """A rank of the mesh failed; the message holds its traceback."""


@dataclasses.dataclass
class ForwardSpec:
    """What each rank needs to run one forward of a member on its block.

    ops_factory(mesh) -> the backend of a spatially sharded rank (default
    `ShardedOps`); local_ops: the backend when sp = 1 (None: the float
    default); scales_factory(act_scales, mesh or None) -> a static-int8
    backend built from the tree's `act_scales` at call time (mesh None when
    sp = 1). Each is pickled by value, so it must be importable by the
    workers: a class or a module-level function of the package, or an
    instance or functools.partial of them. check_nans: each rank's backend
    raises FloatingPointError at a conv site that outputs a NaN
    (`core.ops.NanCheckOps`, `cli eval --check-nans`).
    """
    variant: Any
    ops_factory: Optional[Callable] = None
    local_ops: Any = None
    scales_factory: Optional[Callable] = None
    check_nans: bool = False


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class _Rank:
    """One rank's state: its device, meshes and members. A process holds
    one, in `_RANK`, while it belongs to a pool."""

    def __init__(self, device):
        self.device = device
        self.meshes = {}
        self.members = []
        self.trainers = []

    def add_mesh(self, dp, sp):
        self.meshes[(dp, sp)] = make_mesh((dp, sp))
        return self.meshes[(dp, sp)]

    def add_member(self, spec, params):
        self.members.append((spec, params))
        return len(self.members) - 1

    def set_trainer(self, slot, entry):
        """Keep a trainer's replica in `slot` (None: a new slot) -> the
        slot."""
        if slot is None:
            self.trainers.append(entry)
            return len(self.trainers) - 1
        self.trainers[slot] = entry
        return slot


_RANK: Optional[_Rank] = None


def member_backend(spec, params, mesh=None):
    """A member's backend on this rank -> (ops, the parameter tree its
    forward takes): spec.ops_factory(mesh) on a spatial shard (a mesh with
    sp > 1), spec.local_ops on whole images (no mesh, or sp = 1); the
    static-int8 backend of scales_factory when the tree carries
    `act_scales` (taken out of the tree); NanCheckOps around it with
    check_nans."""
    sharded = mesh is not None and mesh.sp > 1
    ops = (spec.ops_factory or ShardedOps)(mesh) if sharded else \
        spec.local_ops
    if spec.scales_factory is not None and "act_scales" in params:
        params = dict(params)
        ops = spec.scales_factory(params.pop("act_scales"),
                                  mesh if sharded else None)
    if spec.check_nans:
        ops = NanCheckOps(TorchOps() if ops is None else ops)
    return ops, params


def member_forward(mesh, block, member, c_depth):
    """A member's forward on this rank's block (N, h, W, c_depth + 2) of
    packed [depth | color | mask] -> float32 (N, h, W, 1): the function
    `MeshPool.forward` maps over the mesh."""
    spec, params = _RANK.members[member]
    depth = block[..., :c_depth]
    color = block[..., c_depth:c_depth + 1]
    mask = block[..., c_depth + 1:]
    ops, params = member_backend(spec, params, mesh)
    out = spec.variant.forward(params, depth, color, mask=mask, ops=ops)
    return out.float().contiguous()


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _map_on_rank(key, specs, fn, consts, gather=True):
    """A worker's part of `MeshPool.shard_map`: its blocks from rank 0, fn
    on them, the outputs back to rank 0 (with `gather`); nothing outside
    the mesh."""
    mesh = _RANK.meshes[key]
    if not mesh.member:
        return None
    blocks = comm.p2p("scatter", [], [(shape, dtype, _RANK.device, 0)
                                      for shape, dtype in specs])
    outs = fn(mesh, *blocks, *consts)
    if gather:
        comm.p2p("gather", [(o, 0) for o in _as_tuple(outs)], [])
    return None


def _worker(rank, world, init_method, backend, device_type, timeout_s,
            conn):
    """A worker rank's loop: commands from rank 0's pipe, one reply each."""
    global _RANK
    try:
        if device_type == "cpu":
            # several ranks share the host's cores
            torch.set_num_threads(1)
        _RANK = _Rank(comm.init(rank, world, init_method, backend,
                                device_type, timeout_s))
        conn.send_bytes(pickle.dumps(("ok", None)))
        while True:
            cmd, args = pickle.loads(conn.recv_bytes())
            if cmd == "stop":
                break
            if cmd == "mesh":
                _RANK.add_mesh(*args)
                result = None
            elif cmd == "member":
                spec, params = args
                result = _RANK.add_member(spec,
                                          _to_device(params, _RANK.device))
            elif cmd == "trainer":
                slot, entry = args
                result = _RANK.set_trainer(slot,
                                           _to_device(entry, _RANK.device))
            elif cmd == "map":
                result = _map_on_rank(*args)
            elif cmd == "call":
                fn, fargs = args
                result = fn(*fargs)
            else:
                raise ValueError(f"unknown command {cmd!r}")
            conn.send_bytes(pickle.dumps(("ok", result)))
    except EOFError:
        return                     # rank 0 went away
    except BaseException:
        try:
            conn.send_bytes(pickle.dumps(
                ("error", f"rank {rank}:\n{traceback.format_exc()}")))
        finally:
            # the others' collectives with this rank fail at once
            os._exit(1)
    comm.destroy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MeshPool:
    """`world` ranks for meshes of up to `world` ranks: this process is rank
    0, `world - 1` spawned workers the others.

    device: "cuda" (the default) or "cpu"; rank r's device follows
    `comm.rank_device`. backend: "nccl" or "gloo" (`comm.choose_backend`;
    None: NCCL on CUDA, gloo on the CPU). timeout_s: the process group's
    timeout, and how long rank 0 waits for a worker's reply. A CPU worker
    runs one torch thread. One pool a process (a process belongs to
    one default process group); close it, or use it as a context manager.
    """

    def __init__(self, world: int, *, device="cuda", backend=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        global _RANK
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        dev = resolve_device(device)
        self.backend = comm.choose_backend(backend, dev, world)
        if dist.is_initialized():
            raise RuntimeError("this process already belongs to a process "
                               "group: one MeshPool a process")
        if dev.type == "cuda":
            # built once here rather than by every rank at once
            from codon_tpu_torch.kernels import _build
            _build.load()
        self.world = world
        self.timeout_s = timeout_s
        self.closed = False
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        for rank in range(1, world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker, daemon=True,
                args=(rank, world, init_method, self.backend, dev.type,
                      timeout_s, child))
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        try:
            self.device = comm.init(0, world, init_method, self.backend,
                                    dev.type, timeout_s)
            self._state = _RANK = _Rank(self.device)
            for rank in range(1, world):
                self._reply(rank)
        except BaseException as e:
            self._fail(e)

    # -- plumbing -----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _reply(self, rank):
        conn = self._conns[rank - 1]
        if not conn.poll(self.timeout_s):
            raise TimeoutError(f"mesh rank {rank} sent no reply in "
                               f"{self.timeout_s} s")
        status, value = pickle.loads(conn.recv_bytes())
        if status == "error":
            raise MeshError(value)
        return value

    def _worker_errors(self):
        """The tracebacks the workers sent after a failure, waiting up to
        ERROR_GRACE_S for them."""
        errors = []
        deadline = time.time() + ERROR_GRACE_S
        for rank, (conn, proc) in enumerate(zip(self._conns, self._procs),
                                            start=1):
            while True:
                left = deadline - time.time()
                try:
                    if conn.poll(max(0.0, min(left, 0.05))):
                        status, value = pickle.loads(conn.recv_bytes())
                        if status == "error":
                            errors.append(value)
                        break
                except (EOFError, OSError):
                    break
                if left <= 0 or not proc.is_alive():
                    break
        return errors

    def _fail(self, e):
        """Close the pool after a failure and raise, with the workers'
        tracebacks when they sent any."""
        errors = [] if isinstance(e, MeshError) else self._worker_errors()
        self._shutdown(graceful=False)
        if errors:
            raise MeshError("\n".join(errors)) from e
        raise e

    def _command(self, cmd, args=(), local=None):
        """Send `cmd` to every worker, run `local()` here as rank 0, then
        read every worker's reply -> (local's value, [each worker's])."""
        if self.closed:
            raise RuntimeError("the MeshPool is closed (after close() or a "
                               "failed call)")
        msg = pickle.dumps((cmd, args))      # nothing sent if this raises
        try:
            for conn in self._conns:
                conn.send_bytes(msg)
            mine = local() if local is not None else None
            theirs = [self._reply(rank) for rank in range(1, self.world)]
        except BaseException as e:
            self._fail(e)
        return mine, theirs

    def _shutdown(self, graceful: bool) -> None:
        global _RANK
        self.closed = True
        _RANK = None
        if graceful:
            msg = pickle.dumps(("stop", ()))
            for conn in self._conns:
                try:
                    conn.send_bytes(msg)
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(timeout=ERROR_GRACE_S if graceful else 0.1)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=ERROR_GRACE_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        if graceful:
            comm.destroy()
        else:
            # a process group whose peers are gone cannot be torn down
            # collectively; abort it
            try:
                comm.destroy()
            except RuntimeError:
                pass

    def close(self) -> None:
        """Stop the workers and leave the process group."""
        if not self.closed:
            self._shutdown(graceful=True)

    # -- the surface --------------------------------------------------------

    @property
    def transport(self) -> str:
        """How this pool's collectives move a tensor of its device:
        'nccl', 'gloo' (CPU), or under gloo on CUDA 'gloo-cuda' for
        all_reduce and 'gloo-pinned' for the point-to-point rows."""
        if self.backend == "nccl":
            return "nccl"
        if self.device.type == "cpu":
            return "gloo"
        return ("all_reduce " + ("gloo-cuda" if "all_reduce" in
                                 comm.GLOO_CUDA_OPS else "gloo-pinned")
                + ", point-to-point gloo-pinned")

    def mesh(self, dp: int, sp: int):
        """Rank 0's handle of the (dp, sp) mesh over the first dp * sp
        ranks, built on every rank at first use."""
        key = (dp, sp)
        if key not in self._state.meshes:
            if dp * sp > self.world:
                raise ValueError(f"axis_sizes {key} needs {dp * sp} ranks, "
                                 f"only {self.world} available")
            self._command("mesh", key,
                          local=lambda: self._state.add_mesh(dp, sp))
            self._state.meshes[key].pool = self
        return self._state.meshes[key]

    def add_member(self, spec: ForwardSpec, params) -> int:
        """Send a forward's spec and parameter tree to every rank, once ->
        its member index. Rank 0 keeps the caller's own tensors."""
        payload = (spec, _to_cpu(params))
        mine, _ = self._command(
            "member", payload,
            local=lambda: self._state.add_member(spec, params))
        return mine

    def set_trainer(self, slot, entry) -> int:
        """Send a training step's state to every rank into `slot` (None: a
        new one) -> the slot: entry is a dict whose tensors (a parameter
        tree, an optimizer state) each worker keeps a copy of on its
        device; rank 0 keeps the caller's own (`parallel.train`)."""
        payload = (slot, _to_cpu(entry))
        mine, _ = self._command(
            "trainer", payload,
            local=lambda: self._state.set_trainer(slot, entry))
        return mine

    def trainer(self, slot):
        """Rank 0's entry in a trainer slot."""
        return self._state.trainers[slot]

    def shard_map(self, fn: Callable, mesh, *tensors, consts=(),
                  gather=True):
        """fn over `mesh`, as JAX's shard_map: each tensor (B, H, ...) on
        rank 0 is cut into (dp, sp) blocks along its first two axes, the
        rank at (d, s) runs fn(its mesh, *its blocks, *consts), and the
        outputs (a tensor or a tuple of them, (B/dp, H/sp, ...) each) are
        put back together on rank 0. fn is a module-level function of the
        package (pickled by reference), consts are pickled by value; B must
        divide by dp and H by sp. gather=False: nothing comes back but
        rank 0's own result of fn, whatever it is."""
        dp, sp = mesh.dp, mesh.sp
        B, H = tensors[0].shape[:2]
        bl, hl = B // dp, H // sp
        key = (dp, sp)

        def block(t, rank):
            d, s = divmod(rank, sp)
            return t[d * bl:(d + 1) * bl, s * hl:(s + 1) * hl]

        specs = [((bl, hl) + tuple(t.shape[2:]), t.dtype) for t in tensors]

        def local():
            others = range(1, mesh.size)
            comm.p2p("scatter", [(block(t, r), r) for r in others
                                 for t in tensors], [])
            mine = fn(mesh, *(block(t, 0).contiguous() for t in tensors),
                      *consts)
            if not gather:
                return mine
            mine = _as_tuple(mine)
            got = comm.p2p("gather", [], [(o.shape, o.dtype, o.device, r)
                                          for r in others for o in mine])
            outs = [[o] + got[i::len(mine)] for i, o in enumerate(mine)]
            whole = [torch.cat([torch.cat(per[d * sp:(d + 1) * sp], 1)
                                for d in range(dp)], 0) for per in outs]
            return whole[0] if len(whole) == 1 else tuple(whole)

        out, _ = self._command("map", (key, specs, fn, consts, gather),
                               local=local)
        return out

    def forward(self, member: int, mesh, depth, color, mask):
        """One forward of `member` over `mesh`: depth (B, H, W, Cd), color
        and mask (B, H, W, 1) on rank 0's device, B a multiple of dp and H
        of sp -> float32 (B, H, W, 1) on rank 0's device. The three inputs
        travel as one packed float32 tensor."""
        packed = torch.cat([depth.float(), color.float(), mask.float()], -1)
        return self.shard_map(member_forward, mesh, packed,
                              consts=(member, depth.shape[-1]))

    def call(self, fn: Callable, *args) -> list:
        """fn(*args) on every rank -> [rank 0's result, rank 1's, ...]. fn
        is a module-level function, pickled by reference."""
        mine, theirs = self._command("call", (fn, args),
                                     local=lambda: fn(*args))
        return [mine] + theirs


def rank_counts() -> dict:
    """This rank's tallies: CAC and quant kernel launches (on the card),
    the CAC stage's calls on whole images and on a shard, and the
    collectives' calls, bytes and transports."""
    from codon_tpu_torch.kernels import cac, quant
    return {"cac": cac.launches(), "quant": quant.launches(),
            "stages": cac.stage_calls(), "comm": comm.counts()}


def reset_rank_counts() -> None:
    from codon_tpu_torch.kernels import cac, quant
    cac.reset_launches()
    cac.reset_stage_calls()
    quant.reset_launches()
    comm.reset_counts()


def loaded_modules() -> list:
    """The names of the modules this rank has imported (a name that
    sys.modules maps to None is a blocked import, not a module)."""
    import sys
    return sorted(k for k, m in sys.modules.items() if m is not None)
