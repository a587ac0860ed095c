"""Process groups and the collectives of the sharded forward and its
backward.

What `lax` gives JAX for free inside `shard_map`, over `torch.distributed`:

  halo_rows   `lax.ppermute` of the rows a stencil reads across a shard
              seam: `dist.batch_isend_irecv` between the sp neighbours;
              the shards at the image's top and bottom get zero rows, which
              is SAME padding there
  all_sum     `lax.psum` of sums and counts: `all_reduce(SUM)` in float32
              over the group
  global_max  the masked max over the pixels of every shard: the local max,
              then `all_reduce(MAX)` in float32
  all_max     the elementwise max of a tensor over the group's ranks
  p2p         point to point: rank 0 scattering the (dp, sp) blocks of a
              batch and gathering the outputs

PyTorch has no transpose rules for these, so the three that a training
forward differentiates are `torch.autograd.Function`s whose backward is
the transposed collective:

  halo_rows   the gradient of the r rows received from above goes back to
              the upper neighbour, that of the rows from below to the lower
              one, and each is added there to the gradient of the shard's
              own first or last r rows (the zero rows at the image's edges
              send nothing)
  all_sum     all_sum of the incoming gradient over the same group (psum's
              transpose when every rank holds its own cotangent)
  global_max  the single-device `amax` gradient: the incoming gradient
              summed over the group, split evenly among every element equal
              to the max, counted over all shards (one all_sum of [gradient
              | each shard's tie count])

`all_max` and `p2p` are not differentiable: each raises when handed a
tensor that requires grad, and its callers hand it detached tensors.

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
every rank. A backward counts under its forward's name with "_grad"
added; the global max's forward counts as an "all_max".
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
PRIMITIVES = ("halo_rows", "halo_rows_grad", "all_sum", "all_sum_grad",
              "all_max", "all_max_grad", "scatter", "gather")

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

def _detached(t: torch.Tensor, what: str) -> None:
    """Raise unless `t` is out of the autograd graph: `what` has no
    backward, and a gradient through it would be silently wrong."""
    if t.requires_grad:
        raise RuntimeError(f"{what} has no gradient: hand it a detached "
                           f"tensor, or use a differentiable collective")


def _all_reduce(name, t, op, group):
    v = t.detach().to(torch.float32, copy=True).contiguous()
    how = transport("all_reduce", v)
    if how == "gloo-pinned":
        h = _pinned(v)
        dist.all_reduce(h, op, group=group)
        v.copy_(h)
    else:
        dist.all_reduce(v, op, group=group)
    _count(name, v.numel() * 4, how)
    return v.to(t.dtype)


class _AllSum(torch.autograd.Function):
    """all_sum with psum's transpose: the gradient summed over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce("all_sum", t, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce("all_sum_grad", g, dist.ReduceOp.SUM, ctx.group),
                None)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group's ranks, reduced in float32, in t's
    dtype (`lax.psum`). Differentiable: the backward sums the gradient over
    the same group."""
    return _AllSum.apply(t, group)


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over the group's ranks, in t's dtype. Not
    differentiable (`global_max` is)."""
    _detached(t, "all_max")
    return _all_reduce("all_max", t, dist.ReduceOp.MAX, group)


class _GlobalMax(torch.autograd.Function):
    """The max over H and W of every shard, with the single-device `amax`
    gradient: (incoming gradient / tie count) at each element equal to the
    max, 0 elsewhere. Each rank holds its own share of the incoming
    gradient and its own ties, so the backward sums both over the group in
    one all-reduce.

    JAX's sharded twin (`lax.all_gather` + `jnp.max`) splits the gradient
    first among the shards that hold the max, then among the ties inside
    each; the two agree unless the max is tied across shards, where this
    one gives what the unsharded forward gives."""

    @staticmethod
    def forward(ctx, x, group):
        m = _all_reduce("all_max", x.amax(dim=(1, 2), keepdim=True),
                        dist.ReduceOp.MAX, group)
        if ctx.needs_input_grad[0]:
            ctx.group = group
            ctx.save_for_backward(x == m)
        return m

    @staticmethod
    def backward(ctx, g):
        hit, = ctx.saved_tensors
        c = g.shape[-1]
        ties = hit.sum(dim=(1, 2), keepdim=True).float()
        both = _all_reduce("all_max_grad", torch.cat([g.float(), ties], -1),
                           dist.ReduceOp.SUM, ctx.group)
        return (both[..., :c] / both[..., c:]).to(g.dtype) * hit, None


def global_max(x: torch.Tensor, group) -> torch.Tensor:
    """(N, h, W, C) shard -> (N, 1, 1, C), the max over every shard's
    pixels (mask them out with -inf first); differentiable as the
    unsharded `amax` is."""
    return _GlobalMax.apply(x, group)


def p2p(name, sends, recvs, group=None):
    """Post every send [(tensor, global peer)] and receive [(shape, dtype,
    device, global peer)] at once and wait for all -> the received tensors
    on their devices, counted under the primitive `name`. CUDA tensors go
    through pinned host buffers under gloo. Rank 0's scatter and gather of
    a mesh's blocks, and the exchanges of `halo_rows` and its backward.
    Not differentiable: a tensor to send must not require grad."""
    ops, staged, out = [], [], []
    sent = 0
    how = None
    for t, peer in sends:
        _detached(t, f"p2p ({name})")
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


def _swap_edges(name, up, down, group):
    """Send `up` to the sp neighbour above and `down` to the one below, and
    take theirs -> (the tensor from above, the one from below), each None
    at the image's edge. `up` and `down` have one shape."""
    i, size = dist.get_rank(group), dist.get_world_size(group)
    sends, recvs, sides = [], [], []
    for j, rows in ((i - 1, up), (i + 1, down)):
        if 0 <= j < size:
            peer = dist.get_global_rank(group, j)
            sends.append((rows, peer))
            recvs.append((rows.shape, rows.dtype, rows.device, peer))
            sides.append(j < i)
    got = iter(p2p(name, sends, recvs, group))
    above = below = None
    for is_above in sides:
        if is_above:
            above = next(got)
        else:
            below = next(got)
    return above, below


class _HaloRows(torch.autograd.Function):
    """halo_rows with the transposed exchange as its backward: the gradient
    of the rows from above goes back up, that of the rows from below back
    down, each added to the gradient of the home shard's own edge rows."""

    @staticmethod
    def forward(ctx, x, r, group):
        ctx.r, ctx.group = r, group
        h = x.shape[1]
        top, bot = _swap_edges("halo_rows", x[:, :r].detach(),
                               x[:, h - r:].detach(), group)
        zeros = x.new_zeros((x.shape[0], r) + tuple(x.shape[2:]))
        return torch.cat([zeros if top is None else top, x,
                          zeros if bot is None else bot], 1)

    @staticmethod
    def backward(ctx, g):
        r = ctx.r
        h = g.shape[1] - 2 * r
        from_above, from_below = _swap_edges(
            "halo_rows_grad", g[:, :r], g[:, h + r:], ctx.group)
        gx = g[:, r:r + h].clone(memory_format=torch.contiguous_format)
        if from_above is not None:
            gx[:, :r] += from_above
        if from_below is not None:
            gx[:, h - r:] += from_below
        return gx, None, None


def halo_rows(x: torch.Tensor, r: int, group) -> torch.Tensor:
    """(N, h, W, C) shard of an image's rows -> (N, h + 2r, W, C) with r
    rows of each sp neighbour above and below (`lax.ppermute`); zeros at
    the image's top and bottom, SAME padding there. r = 0 returns x.
    Differentiable: the backward sends each halo's gradient home."""
    if r == 0:
        return x
    if x.shape[1] < r:
        raise ValueError(f"a shard of {x.shape[1]} rows cannot lend a halo "
                         f"of {r} rows: each shard needs at least {r}")
    return _HaloRows.apply(x, r, group)
