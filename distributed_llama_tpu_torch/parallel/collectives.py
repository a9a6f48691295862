"""The tensor-parallel collectives: the one module of the port that calls
``torch.distributed`` (the JAX package's ``_ici_gather``, ``_ici_psum``,
``_ici_scatter``, ``_ici_ppermute`` and ``_ici_ring_reduce`` in
parallel/tp.py).

Every call is counted by kind and by the bytes comm_stats charges it
(``CENSUS``): all_gather (S-1) x the rank's payload, all_reduce ('psum')
2 (S-1)/S x the payload, reduce_scatter (S-1)/S x the payload, a ring hop
('ppermute') its chunk. Over one forward call the census equals
comm_stats.tp_collective_budget; the tests hold it so, as the JAX
package's J001 contract holds its traced program.

Gathers put the bands in rank order along the last axis. ``ring_reduce``
sums the S terms of its chunk in ascending rank order; an all_reduce sums
in whatever order the backend picks (NCCL, gloo), so the overlap scheme
equals the fused one within f32 rounding, not bit for bit as in the JAX
package (tests/test_torch_tp.py holds them within the logit tolerance,
with equal greedy streams).

While a profiler runs, each collective's host work is a span named
``tp::<kind>`` (all_gather, all_reduce, reduce_scatter,
collective_permute) and each wait for an issued one a ``tp::wait`` span:
the I/T split's T under gloo, whose collectives run on the host
(utils/it_split.py). A trace holds one ``tp::<kind>`` span per CENSUS
entry.

Sequence parallelism adds two kinds over the group's sp sub-group,
``sp_pmax`` and ``sp_psum`` (parallel/ring.py's LSE combine: one pmax and
two psums a layer), each charged 2 (S-1)/S x its payload as
comm_stats.sp_lse_bytes charges them; they stay out of the tp budget.

Training (parallel/train.py, parallel/sp_train.py) differentiates through
``torch.autograd.Function`` collectives. Under tp (the ref scheme) each
banded product's input passes ``tp_enter`` (identity forward, all_reduce
of the gradient backward: a ``psum``) and its output bands ``tp_gather``
(all_gather forward, this rank's slice of the gradient backward). The
data-parallel sum of the gradients is ``data_psum`` (kind ``dp_psum``,
charged as an all_reduce). Ring attention's hop is ``ring_hop``: rank j
sends to rank j-1 (the JAX package's ``perm = [(j, (j-1) % S)]``) and its
backward hops the other way; each hop counts one ``ppermute`` of its
chunk. gloo refuses send/recv on CUDA tensors (chip_smoke.py's gloo ranks
sharing one card), so there a hop is staged through host memory: the
tensor is copied to the CPU, exchanged, and copied back — still one
``ppermute`` in the census.

A simulated rank (parallel/shard_sim.py: a group whose process group is
mesh.LOCAL_SIM) runs the tp forward's collectives as local stand-ins of
the same output shape, the JAX package's shard_sim tile gather, identity
psum, band-slice scatter and identity ppermute: a gather tiles the band
``size`` times, an all_reduce and a hop return their input, a
reduce_scatter keeps band 0. Each is counted in CENSUS and spanned as the
real one, so the census of a simulated forward equals the budget; values
are garbage by construction (every gathered band is this rank's).
"""

from __future__ import annotations

import torch

# a span over one collective's host work (``tp::<kind>``, or WAIT_SPAN
# where an issued one is waited for) while a profiler runs: gloo's
# collectives have no kernel, and utils/it_split reads these spans as T
from ..obs.profiler import span as _span
from ..utils.it_split import SPAN_PREFIX, WAIT_SPAN
from .mesh import LOCAL_SIM, TPGroup

KINDS = ("all_gather", "psum", "reduce_scatter", "ppermute", "sp_pmax",
         "sp_psum", "dp_psum")


class Census:
    """Collectives issued since the last reset: kind -> [count, bytes]."""

    def __init__(self):
        self.counts: dict[str, list[int]] = {}

    def add(self, kind: str, nbytes: int) -> None:
        entry = self.counts.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += int(nbytes)

    def reset(self) -> None:
        self.counts.clear()

    def kind_counts(self) -> dict[str, int]:
        return {k: c for k, (c, _) in self.counts.items()}


CENSUS = Census()


def _dist():
    import torch.distributed as dist

    return dist


def _simulated(g: TPGroup) -> bool:
    return g.group is LOCAL_SIM


def gather(x: torch.Tensor, g: TPGroup, dim: int = -1) -> torch.Tensor:
    """all_gather of each rank's band along ``dim`` (the last axis by
    default), in rank order."""
    with _span(SPAN_PREFIX + "all_gather"):
        x = x.contiguous()
        if _simulated(g):
            parts = [x] * g.size
        else:
            parts = [torch.empty_like(x) for _ in range(g.size)]
            _dist().all_gather(parts, x, group=g.group)
        CENSUS.add("all_gather", (g.size - 1) * x.numel() * x.element_size())
        return torch.cat(parts, dim=dim)


def gather_sp(x: torch.Tensor, g: TPGroup, dim: int) -> torch.Tensor:
    """all_gather over the sp ranks of the group's tp index, in sp order
    along ``dim`` (a checkpoint's position chunks)."""
    with _span(SPAN_PREFIX + "all_gather"):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(g.sp_size)]
        _dist().all_gather(parts, x, group=g.sp_group)
        CENSUS.add("all_gather",
                   (g.sp_size - 1) * x.numel() * x.element_size())
        return torch.cat(parts, dim=dim)


class Pending:
    """An all_gather issued asynchronously (the overlap scheme's deferred
    ffn gather): ``wait()`` returns the rank-ordered concatenation."""

    def __init__(self, x: torch.Tensor, g: TPGroup):
        with _span(SPAN_PREFIX + "all_gather"):
            x = x.contiguous()
            if _simulated(g):
                self.parts, self.work = [x] * g.size, None
            else:
                self.parts = [torch.empty_like(x) for _ in range(g.size)]
                self.work = _dist().all_gather(self.parts, x, group=g.group,
                                               async_op=True)
            CENSUS.add("all_gather",
                       (g.size - 1) * x.numel() * x.element_size())

    def wait(self) -> torch.Tensor:
        with _span(WAIT_SPAN):
            if self.work is not None:
                self.work.wait()
            return torch.cat(self.parts, dim=-1)


def psum(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """all_reduce (sum) of the ranks' full-width partials; ``x`` is summed
    in place and returned."""
    with _span(SPAN_PREFIX + "all_reduce"):
        x = x.contiguous()
        if not _simulated(g):
            _dist().all_reduce(x, group=g.group)
        nbytes = x.numel() * x.element_size()
        CENSUS.add("psum", 2 * (g.size - 1) * nbytes // g.size)
        return x


def scatter(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """reduce_scatter along the last axis: rank r gets the f32 sum of band
    r of every rank's ``x``."""
    with _span(SPAN_PREFIX + "reduce_scatter"):
        chunks = [c.contiguous() for c in x.chunk(g.size, dim=-1)]
        if _simulated(g):
            out = chunks[0]
        else:
            out = torch.empty_like(chunks[0])
            _dist().reduce_scatter(out, chunks, group=g.group)
        nbytes = x.numel() * x.element_size()
        CENSUS.add("reduce_scatter", (g.size - 1) * nbytes // g.size)
        return out


def _permute(x: torch.Tensor, shift: int, group, size: int, rank: int):
    """One hop around ``group``, issued: rank i sends ``x`` to rank
    (i + shift) mod size and receives rank (i - shift) mod size's.
    Returns (works, received)."""
    dist = _dist()
    x = x.contiguous()
    recv = torch.empty_like(x)

    def peer(i):  # a P2P op names its peer by global rank
        return dist.get_global_rank(group, i % size)

    ops = [dist.P2POp(dist.isend, x, peer(rank + shift), group=group),
           dist.P2POp(dist.irecv, recv, peer(rank - shift), group=group)]
    with _span(SPAN_PREFIX + "collective_permute"):
        works = dist.batch_isend_irecv(ops)
    CENSUS.add("ppermute", x.numel() * x.element_size())
    return works, recv


def ppermute_start(x: torch.Tensor, shift: int, g: TPGroup):
    """One ring hop over the tp ranks, issued (_permute)."""
    if _simulated(g):
        with _span(SPAN_PREFIX + "collective_permute"):
            x = x.contiguous()
            CENSUS.add("ppermute", x.numel() * x.element_size())
            return [], x
    return _permute(x, shift, g.group, g.size, g.rank)


def ring_reduce(part: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """The overlap scheme's combine reduce: the full-width partial (..., W)
    splits into S chunks, and hop k sends chunk (r + k) mod S straight to
    its owner (all S - 1 hops in flight at once). Rank r returns the sum
    of the S ranks' chunk r, added in ascending rank order."""
    s, r = g.size, g.rank
    if s == 1:
        return part
    chunks = part.chunk(s, dim=-1)
    stash: list = [None] * s
    stash[r] = chunks[r]
    hops = [(k, ppermute_start(chunks[(r + k) % s], k, g))
            for k in range(1, s)]
    for k, (works, recv) in hops:
        with _span(WAIT_SPAN):
            for w in works:
                w.wait()
        stash[(r - k) % s] = recv
    acc = stash[0]
    for j in range(1, s):  # rank-order left fold
        acc = acc + stash[j]
    return acc


def _sp_reduce(x: torch.Tensor, g: TPGroup, op, kind: str) -> torch.Tensor:
    with _span(SPAN_PREFIX + "all_reduce"):
        x = x.contiguous()
        _dist().all_reduce(x, op=op, group=g.sp_group)
        nbytes = x.numel() * x.element_size()
        CENSUS.add(kind, 2 * (g.sp_size - 1) * nbytes // g.sp_size)
        return x


def sp_pmax(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """all_reduce (max) over the sp ranks of the group's tp index; ``x``
    is reduced in place and returned."""
    return _sp_reduce(x, g, _dist().ReduceOp.MAX, "sp_pmax")


def sp_psum(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """all_reduce (sum) over the sp ranks of the group's tp index."""
    return _sp_reduce(x, g, _dist().ReduceOp.SUM, "sp_psum")


# ---------------------------------------------------------------------------
# training: differentiable collectives
# ---------------------------------------------------------------------------

class _TPEnter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the tp group
    backward (each rank's band contributes its part of dL/dx)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return psum(gy.clone(), ctx.g), None


class _TPGather(torch.autograd.Function):
    """all_gather of the output bands along the last axis forward; this
    rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.width = g, x.shape[-1]
        return gather(x, g)

    @staticmethod
    def backward(ctx, gy):
        lo = ctx.g.rank * ctx.width
        return gy[..., lo:lo + ctx.width].contiguous(), None


def tp_enter(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """A banded product's input: x forward, psum of its gradient backward."""
    return _TPEnter.apply(x, g)


def tp_gather(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """A banded product's output bands gathered in rank order; the
    gradient's own band backward."""
    return _TPGather.apply(x, g)


def data_psum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """all_reduce (sum) of a flat f32 buffer (a step's gradients and loss)
    over ``group``, the data-parallel ranks; summed in place and
    returned. Counted as ``dp_psum``."""
    with _span(SPAN_PREFIX + "all_reduce"):
        _dist().all_reduce(x, group=group)
        nbytes = x.numel() * x.element_size()
        CENSUS.add("dp_psum", 2 * (size - 1) * nbytes // size)
        return x


def _hop(x: torch.Tensor, shift: int, group, size: int,
         rank: int) -> torch.Tensor:
    """_permute, waited for. Under gloo a CUDA tensor goes through host
    memory (gloo has no CUDA send/recv)."""
    staged = x.is_cuda and _dist().get_backend(group) == "gloo"
    send = x.detach().cpu() if staged else x.detach()
    works, recv = _permute(send, shift, group, size, rank)
    with _span(WAIT_SPAN):
        for w in works:
            w.wait()
    return recv.to(x.device) if staged else recv


class _RingHop(torch.autograd.Function):
    """One ring hop over the sp ranks: rank j's chunk goes to rank j-1
    forward; the gradient of what a rank received goes back to its sender
    (rank j+1) backward."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _hop(x, -1, g.sp_group, g.sp_size, g.sp_rank)

    @staticmethod
    def backward(ctx, gy):
        g = ctx.g
        return _hop(gy, 1, g.sp_group, g.sp_size, g.sp_rank), None


def ring_hop(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """Rotate x one step around the group's sp ring (differentiable)."""
    return _RingHop.apply(x, g)
