"""Process groups and the collectives of the sharded forward.

What `lax` gives JAX for free inside `shard_map`, over `torch.distributed`:

  halo_rows   `lax.ppermute` of the rows a stencil reads across a shard
              seam: `dist.batch_isend_irecv` between the sp neighbours;
              the shards at the image's top and bottom get zero rows, which
              is SAME padding there
  all_sum     `lax.psum` of sums and counts: `all_reduce(SUM)` in float32
              over the sp group
  all_max     the gathered max of maxes: `all_reduce(MAX)` in float32
  p2p         point to point: rank 0 scattering the (dp, sp) blocks of a
              batch and gathering the outputs

The backend is the caller's choice and nothing switches it:

  nccl   the default on CUDA; one card a rank (rank r on cuda:r), so it
         raises, naming `--dist-backend gloo`, when the host has fewer cards
         than ranks (NCCL refuses two ranks on one card)
  gloo   the CPU's backend, and on CUDA the one that lets ranks share cards:
         rank r on cuda:(r % cards). Gloo takes CUDA tensors in the
         collectives of GLOO_CUDA_OPS only, and stages them through host
         memory itself; its point-to-point ops read host memory, so the
         exchange copies CUDA rows through pinned host buffers here,
         explicitly (transport "gloo-pinned"). That is the collective's
         transport, not a device fallback: the convs and kernels stay on
         the card.

Each primitive counts its calls, the bytes this rank sent and the
transports it took (`counts`, `reset_counts`), as the kernel wrappers count
their launches: a process-wide tally that `chip_smoke.py` reads from
every rank.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# gloo collectives that take CUDA tensors (torch.distributed's backend
# table; all_reduce checked on the H100 with torch 2.11). Point-to-point
# ops are not among them.
GLOO_CUDA_OPS = frozenset({"all_reduce"})
PRIMITIVES = ("halo_rows", "all_sum", "all_max", "scatter", "gather")

_COUNTS = {}


def reset_counts() -> None:
    for p in PRIMITIVES:
        _COUNTS[p] = {"calls": 0, "bytes": 0, "transport": set()}


def counts() -> dict:
    """{primitive: {"calls", "bytes", "transport" (sorted list)}} since the
    last `reset_counts`; bytes: the payload this rank handed the primitive
    (the rows it sent, the float32 tensor it reduced)."""
    return {p: {"calls": c["calls"], "bytes": c["bytes"],
                "transport": sorted(c["transport"])}
            for p, c in _COUNTS.items()}


reset_counts()


def _count(name, nbytes, transport) -> None:
    c = _COUNTS[name]
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["transport"].add(transport)


# ---------------------------------------------------------------------------
# set-up and tear-down
# ---------------------------------------------------------------------------

def choose_backend(backend, device, world: int) -> str:
    """The process group's backend for `world` ranks on `device`'s type.

    None takes NCCL on CUDA and gloo on the CPU. NCCL with fewer cards than
    ranks raises: it never turns into gloo by itself."""
    kind = torch.device(device).type
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"--dist-backend {backend}: on the CPU the "
                             f"backend is gloo")
        return "gloo"
    if kind != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {kind}")
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    cards = torch.cuda.device_count()
    if backend == "nccl" and cards < world:
        raise RuntimeError(
            f"NCCL needs one card a rank: {world} ranks, {cards} card(s) "
            f"here; pass --dist-backend gloo (backend='gloo') to let the "
            f"ranks share cards")
    return backend


def rank_device(rank: int, device, backend: str) -> torch.device:
    """Rank r's device: the CPU, cuda:r under NCCL, cuda:(r % cards) under
    gloo."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def init(rank: int, world: int, init_method: str, backend: str, device,
         timeout_s: float) -> torch.device:
    """Join the process group as `rank`; every collective and point-to-point
    op then fails after `timeout_s` seconds instead of waiting for ever.
    -> this rank's device."""
    dev = rank_device(rank, device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def transport(op: str, t: torch.Tensor) -> str:
    """How `op` ("all_reduce" or "p2p") moves `t`: "nccl", "gloo" (host
    tensors), "gloo-cuda" (gloo takes the CUDA tensor) or "gloo-pinned"
    (copied through pinned host buffers here)."""
    if dist.get_backend() == "nccl":
        return "nccl"
    if t.device.type == "cpu":
        return "gloo"
    return "gloo-cuda" if op in GLOO_CUDA_OPS else "gloo-pinned"


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _all_reduce(name, t, op, group):
    v = t.to(torch.float32, copy=True).contiguous()
    how = transport("all_reduce", v)
    if how == "gloo-pinned":
        h = _pinned(v)
        dist.all_reduce(h, op, group=group)
        v.copy_(h)
    else:
        dist.all_reduce(v, op, group=group)
    _count(name, v.numel() * 4, how)
    return v.to(t.dtype)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group's ranks, reduced in float32, in t's
    dtype (`lax.psum`)."""
    return _all_reduce("all_sum", t, dist.ReduceOp.SUM, group)


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over the group's ranks, in t's dtype."""
    return _all_reduce("all_max", t, dist.ReduceOp.MAX, group)


def p2p(name, sends, recvs, group=None):
    """Post every send [(tensor, global peer)] and receive [(shape, dtype,
    device, global peer)] at once and wait for all -> the received tensors
    on their devices, counted under the primitive `name`. CUDA tensors go
    through pinned host buffers under gloo. Rank 0's scatter and gather of
    a mesh's blocks, and `halo_rows`' exchange."""
    ops, staged, out = [], [], []
    sent = 0
    how = None
    for t, peer in sends:
        t = t.contiguous()
        how = transport("p2p", t)
        buf = _pinned(t) if how == "gloo-pinned" else t
        ops.append(dist.P2POp(dist.isend, buf, peer, group=group))
        sent += t.numel() * t.element_size()
    for shape, dtype, device, peer in recvs:
        t = torch.empty(shape, dtype=dtype, device=device)
        how = transport("p2p", t)
        buf = (torch.empty(shape, dtype=dtype, pin_memory=True)
               if how == "gloo-pinned" else t)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=group))
        staged.append((t, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, buf in staged:
        if buf is not t:
            t.copy_(buf)
        out.append(t)
    if how is not None:
        _count(name, sent, how)
    return out


def halo_rows(x: torch.Tensor, r: int, group) -> torch.Tensor:
    """(N, h, W, C) shard of an image's rows -> (N, h + 2r, W, C) with r
    rows of each sp neighbour above and below (`lax.ppermute`); zeros at
    the image's top and bottom, SAME padding there. r = 0 returns x."""
    if r == 0:
        return x
    n, h = x.shape[0], x.shape[1]
    if h < r:
        raise ValueError(f"a shard of {h} rows cannot lend a halo of {r} "
                         f"rows: each shard needs at least {r}")
    i, size = dist.get_rank(group), dist.get_world_size(group)
    edge = (n, r) + tuple(x.shape[2:])
    sends, recvs, sides = [], [], []
    for j, rows in ((i - 1, x[:, :r]), (i + 1, x[:, h - r:])):
        if 0 <= j < size:
            peer = dist.get_global_rank(group, j)
            sends.append((rows, peer))
            recvs.append((edge, x.dtype, x.device, peer))
            sides.append(j < i)
    got = iter(p2p("halo_rows", sends, recvs, group))
    top = bot = None
    for above in sides:
        if above:
            top = next(got)
        else:
            bot = next(got)
    zeros = x.new_zeros(edge)
    return torch.cat([zeros if top is None else top, x,
                      zeros if bot is None else bot], 1)
