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
"""

from __future__ import annotations

import torch

from .mesh import TPGroup

KINDS = ("all_gather", "psum", "reduce_scatter", "ppermute")


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


def gather(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """all_gather of each rank's band along the last axis, rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(g.size)]
    _dist().all_gather(parts, x, group=g.group)
    CENSUS.add("all_gather", (g.size - 1) * x.numel() * x.element_size())
    return torch.cat(parts, dim=-1)


class Pending:
    """An all_gather issued asynchronously (the overlap scheme's deferred
    ffn gather): ``wait()`` returns the rank-ordered concatenation."""

    def __init__(self, x: torch.Tensor, g: TPGroup):
        x = x.contiguous()
        self.parts = [torch.empty_like(x) for _ in range(g.size)]
        self.work = _dist().all_gather(self.parts, x, group=g.group,
                                       async_op=True)
        CENSUS.add("all_gather", (g.size - 1) * x.numel() * x.element_size())

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return torch.cat(self.parts, dim=-1)


def psum(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """all_reduce (sum) of the ranks' full-width partials; ``x`` is summed
    in place and returned."""
    x = x.contiguous()
    _dist().all_reduce(x, group=g.group)
    nbytes = x.numel() * x.element_size()
    CENSUS.add("psum", 2 * (g.size - 1) * nbytes // g.size)
    return x


def scatter(x: torch.Tensor, g: TPGroup) -> torch.Tensor:
    """reduce_scatter along the last axis: rank r gets the f32 sum of band
    r of every rank's ``x``."""
    chunks = [c.contiguous() for c in x.chunk(g.size, dim=-1)]
    out = torch.empty_like(chunks[0])
    _dist().reduce_scatter(out, chunks, group=g.group)
    nbytes = x.numel() * x.element_size()
    CENSUS.add("reduce_scatter", (g.size - 1) * nbytes // g.size)
    return out


def ppermute_start(x: torch.Tensor, shift: int, g: TPGroup):
    """One ring hop, issued: rank i sends ``x`` to rank (i + shift) mod S
    and receives rank (i - shift) mod S's. Returns (works, received)."""
    dist = _dist()
    x = x.contiguous()
    recv = torch.empty_like(x)
    r, s = g.rank, g.size

    def peer(i):  # a P2P op names its peer by global rank
        return dist.get_global_rank(g.group, i % s)

    ops = [dist.P2POp(dist.isend, x, peer(r + shift), group=g.group),
           dist.P2POp(dist.irecv, recv, peer(r - shift), group=g.group)]
    works = dist.batch_isend_irecv(ops)
    CENSUS.add("ppermute", x.numel() * x.element_size())
    return works, recv


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
        for w in works:
            w.wait()
        stash[(r - k) % s] = recv
    acc = stash[0]
    for j in range(1, s):  # rank-order left fold
        acc = acc + stash[j]
    return acc
