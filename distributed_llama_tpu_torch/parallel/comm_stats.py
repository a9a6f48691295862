"""Analytic per-token communication accounting, per tensor-parallel scheme
(the JAX package's parallel/comm_stats.py, the port's own copy).

The reference's benchmark metric includes sent/received kB per token
(socket counters). Here every collective goes through
parallel/collectives.py, which counts it by kind and by the bytes this
model charges it; the budget below is what those counts must equal for one
forward call (the J001 contract of the JAX package, held by the tests).

Three schemes (``DLLAMA_TP_SCHEME``, ``tp_scheme``; default ``fused``):

  ref      every one of the 7 per-layer matmuls sharded along its output
           dim: 4 all_gathers per layer + the logits gather.
  fused    Megatron pairing: wo/w2 sharded along their input dim, so each
           block ends in a row-parallel partial sum combined by ONE
           all_reduce (f32 buffers), or a reduce_scatter + Q80-packed
           all_gather pair (Q80 buffers).
  overlap  the fused layout with each combine's reduce half split into
           tp-1 ring hops (``ppermute``: one send/recv pair each) summed in
           rank order, and the ffn combine's gather issued at the bottom of
           a layer and consumed at the top of the next.

Ring accounting (S = tp, b = per-rank payload bytes): all_gather moves
(S-1)*b out of and into every rank; reduce_scatter (S-1)*p/S of a full
payload p; all_reduce 2*(S-1)*p/S, charged as ONE collective; a ppermute
hop moves its chunk. Under Q80 buffers the gather halves carry the packed
payload (int8 codes + f16 deltas, 34 bytes per 32 values); reduce halves
stay f32.

Left out: the DCN page budgets and the sequence-parallel LSE bytes (they
come with the slices that port those paths).
"""

from __future__ import annotations

import dataclasses
import os

from ..models.spec import TransformerSpec
from ..ops.quants import FloatType, batch_bytes

SCHEMES = ("ref", "fused", "overlap")


def collective_hops(kind: str, n_slices: int) -> int:
    """Ring hops one launch of ``kind`` serializes on: a ppermute is one
    neighbour hop, every ring collective walks the whole ring."""
    return 1 if kind == "ppermute" else max(n_slices - 1, 1)


def tp_scheme() -> str:
    """The active scheme: DLLAMA_TP_SCHEME=ref|fused|overlap (default
    fused). An unknown value raises."""
    s = os.environ.get("DLLAMA_TP_SCHEME", "fused")
    if s not in SCHEMES:
        raise ValueError(f"DLLAMA_TP_SCHEME={s!r}: expected one of "
                         f"{'|'.join(SCHEMES)}")
    return s


def _vb(ftype: FloatType, n: int) -> int:
    """Wire bytes of an n-value vector in the buffer float type."""
    return batch_bytes(ftype, n)


@dataclasses.dataclass(frozen=True)
class CommStats:
    sent_bytes: int
    recv_bytes: int

    @property
    def total_kib(self) -> float:
        return (self.sent_bytes + self.recv_bytes) / 1024.0


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """The per-token collective schedule, aggregated by kind: ``entries``
    holds (kind, count, moved_bytes) per kind, moved_bytes being the
    ring-accounted bytes each rank moves for ALL collectives of that kind
    (logits gather included)."""

    entries: tuple  # ((kind, count, moved_bytes), ...)

    @property
    def n_collectives(self) -> int:
        return sum(c for _, c, _ in self.entries)

    @property
    def moved_bytes(self) -> int:
        return sum(b for _, _, b in self.entries)

    def kind_counts(self) -> dict[str, int]:
        return {k: c for k, c, _ in self.entries}

    def bytes_by_kind(self) -> dict[str, int]:
        return {k: b for k, _, b in self.entries}


def tp_collective_budget(spec: TransformerSpec, n_slices: int,
                         scheme: str | None = None,
                         t_len: int = 1) -> CollectiveBudget:
    """Per-rank collective schedule of one forward call over ``t_len``
    query rows (a decode step of one sequence is 1; a chunk of T tokens or
    a batch of B rows widens every payload by T or B while the counts stay
    the one-step schedule)."""
    scheme = scheme or tp_scheme()
    if scheme not in SCHEMES:
        raise ValueError(f"unknown tp scheme {scheme!r}")
    if n_slices <= 1:
        return CollectiveBudget(())
    ft = spec.buffer_float_type
    s, L, t = n_slices, spec.n_layers, t_len
    logits_bytes = t * (s - 1) * _vb(FloatType.F32, spec.vocab_size // s)
    if scheme == "ref":
        per_layer = t * (s - 1) * (3 * _vb(ft, spec.dim // s)
                                   + _vb(ft, spec.hidden_dim // s))
        return CollectiveBudget(
            (("all_gather", 4 * L + 1, L * per_layer + logits_bytes),))
    if scheme == "overlap":
        # the reduce half of each of the 2 per-layer combines is S-1 hops of
        # one f32 dim/S chunk; the gather half is the fused Q80 path's
        # all_gather (packed Q80 band under Q80 buffers, f32 band under f32)
        pp_bytes = t * 2 * L * (s - 1) * (spec.dim // s) * 4
        band = (FloatType.Q80 if ft == FloatType.Q80 else FloatType.F32)
        ag_bytes = t * 2 * L * (s - 1) * _vb(band, spec.dim // s)
        return CollectiveBudget(
            (("ppermute", 2 * L * (s - 1), pp_bytes),
             ("all_gather", 2 * L + 1, ag_bytes + logits_bytes)))
    # fused: one combine per block, 2 blocks a layer, both of width dim
    if ft == FloatType.Q80:
        rs_bytes = t * 2 * L * (s - 1) * (spec.dim // s) * 4
        ag_bytes = t * 2 * L * (s - 1) * _vb(FloatType.Q80, spec.dim // s)
        return CollectiveBudget(
            (("reduce_scatter", 2 * L, rs_bytes),
             ("all_gather", 2 * L + 1, ag_bytes + logits_bytes)))
    psum_bytes = t * 2 * L * 2 * (s - 1) * (spec.dim // s) * 4
    return CollectiveBudget(
        (("psum", 2 * L, psum_bytes),
         ("all_gather", 1, logits_bytes)))


def collective_staging_bytes(spec: TransformerSpec, n_slices: int,
                             scheme: str | None = None,
                             t_len: int = 1) -> int:
    """Per-rank device memory held by the largest in-flight collective:
    its full output payload twice (source staging and assembled output).
    ref gathers dim- and hidden-wide vectors in the buffer type and the f32
    logits; fused and overlap move f32 dim-wide partials and the logits;
    overlap also holds its deferred ffn gather twice (the layer-N buffer
    and layer N+1's in flight). Zero when n_slices == 1."""
    scheme = scheme or tp_scheme()
    if scheme not in SCHEMES:
        raise ValueError(f"unknown tp scheme {scheme!r}")
    if n_slices <= 1:
        return 0
    ft = spec.buffer_float_type
    logits = t_len * _vb(FloatType.F32, spec.vocab_size)
    if scheme == "ref":
        payloads = (t_len * _vb(ft, spec.dim),
                    t_len * _vb(ft, spec.hidden_dim), logits)
    else:
        payloads = (t_len * _vb(FloatType.F32, spec.dim), logits)
    base = 2 * max(payloads)
    if scheme == "overlap":
        band = (FloatType.Q80 if ft == FloatType.Q80 else FloatType.F32)
        base += 2 * t_len * _vb(band, spec.dim)
    return base


def ici_all_gather_bytes(spec: TransformerSpec, n_slices: int,
                         scheme: str | None = None) -> CommStats:
    """Per-rank bytes a token of the scheme's collectives (the JAX
    package's name; under fused they include all_reduce traffic). Sent ==
    received: every collective here is ring-symmetric."""
    moved = tp_collective_budget(spec, n_slices, scheme).moved_bytes
    return CommStats(moved, moved)


def reference_star_bytes(spec: TransformerSpec, n_slices: int) -> CommStats:
    """Root-side S/R bytes a token of the reference's socket star: per
    layer 3 broadcasts of dim to each worker plus the star all-gather of
    hb sent, and each worker's q/k/v, wo out, hb and w2 out slices
    received."""
    if n_slices <= 1:
        return CommStats(0, 0)
    ft = spec.buffer_float_type
    s = n_slices
    w = s - 1  # workers
    send_layer = (3 * w * _vb(ft, spec.dim)
                  + w * (s - 1) * _vb(ft, spec.hidden_dim // s))
    recv_layer = w * (_vb(ft, spec.dim // s) + 2 * _vb(ft, spec.kv_dim // s)
                      + _vb(ft, spec.dim // s) + _vb(ft, spec.hidden_dim // s)
                      + _vb(ft, spec.dim // s))
    return CommStats(spec.n_layers * send_layer, spec.n_layers * recv_layer)
