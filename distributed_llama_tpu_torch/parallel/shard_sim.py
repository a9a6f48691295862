"""One tp rank's program on one device, and the model that projects the
whole tp group from it (the JAX package's parallel/shard_sim.py).

A tp 8 rank of Llama-2-70B holds about 4.8 GB of Q40 bands (wq 1024 x
8192, w13 2 x 3584 x 8192, ... over 80 layers; one kv head and eight
query heads), the 1.05 GB f32 embedding and its cache shard. Its forward
is exactly ``parallel/tp.TPLlama``'s, the program every rank of a real
group runs, with each collective swapped for a local stand-in of the same
output shape (parallel/collectives.py on a ``mesh.LOCAL_SIM`` group: tile
gather, identity all_reduce, band-slice reduce_scatter, identity hop).
Timing it on one card gives one rank's compute and memory cost; the link
side is added by the model below (comm_stats' bytes over the link rate
plus a latency a collective), and the sum is the projected ms a token of
the whole group. Compute and collectives are added as a straight sum
(no overlap) except where the overlap scheme's hidden share is modelled.

The values are garbage by construction (every gathered band repeats this
rank's), so the sim is for timing and shapes only; the tp forward's
values are held by the real collectives' tests, and the sim at tp 1 is
the single-device forward (tests/test_torch_shard_sim.py).

The link constants are the card's, each an argument of every function:

* ``NVLINK_GBPS_PER_DIRECTION`` = 450 GB/s: NVLink 4 on an H100 SXM5
  (the datasheet's 900 GB/s is both directions), a datasheet figure;
* ``COLLECTIVE_LATENCY_US`` = 2 us a hop: a planning constant, an
  assumption until NCCL is timed on two or more GPUs;
* ``HANDOFF_GIB_PER_S`` = 10 GiB/s and ``HANDOFF_LATENCY_US`` = 200 us:
  the host-to-host link a prefill->decode handoff crosses, planning
  constants (the JAX package takes its DCN pair from its memory model;
  the port keeps them here until that model is ported).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..io.loader import Q40Weight
from ..models.llama import KERNELS, KVCache, Route, params_to_device
from ..models.spec import TransformerSpec
from .comm_stats import (collective_hops, collective_staging_bytes,
                         dcn_handoff_budget, tp_collective_budget, tp_scheme)
from .mesh import sim_group
from .tp import TPLlama

GIB = 1024 ** 3
NVLINK_GBPS_PER_DIRECTION = 450.0  # datasheet: H100 SXM5 NVLink 4
COLLECTIVE_LATENCY_US = 2.0        # planning: a collective's launch, a hop
HANDOFF_GIB_PER_S = 10.0           # planning: host-to-host link
HANDOFF_LATENCY_US = 200.0         # planning: a handoff's fixed cost
CARD_MEMORY_BYTES = 80 * 10 ** 9   # datasheet: H100 80 GB
MEMORY_HEADROOM_FRACTION = 0.10    # allocator slack and fragmentation


def synth_rank_q40(spec: TransformerSpec, n_slices: int, seed: int = 0,
                   scheme: str | None = None, device="cuda",
                   embed_dtype=torch.float32) -> dict[str, Any]:
    """Random Q40 weights at ONE rank's band shapes, made on ``device``
    from a seeded ``torch.Generator`` in the port's device layout (codes
    uint8 (..., d, nb, 16), finite f16 scales), q/k/v and w1/w3 already
    fused into the rank's ``wqkv`` and ``w13``: the tree a rank's
    params_to_device gives, without the host pass that tens of GB of
    numpy codes would take at 70B. The embedding and norms come whole,
    as every rank holds them; wq/wk/wv/w1/w3/wcls are output bands, and
    wo/w2 output bands under ref or input bands under fused/overlap."""
    scheme = scheme or tp_scheme()
    s = n_slices
    if spec.n_heads % s or spec.n_kv_heads % s:
        raise ValueError(f"tp={s} does not divide heads "
                         f"{spec.n_heads}/{spec.n_kv_heads}")
    if scheme in ("fused", "overlap"):
        for name, n_in in (("wo", spec.dim), ("w2", spec.hidden_dim)):
            if (n_in // s) % 32:
                raise ValueError(
                    f"{scheme} tp scheme slices {name}'s Q40 input dim: "
                    f"{n_in}/{s} must be a 32-multiple")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def t(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.05).to(dtype)

    def mm(*shape):
        *lead, d, n = shape
        qs = torch.randint(0, 256, (*lead, d, n // 32, 16), generator=gen,
                           device=device, dtype=torch.uint8)
        d16 = (torch.rand((*lead, d, n // 32), generator=gen,
                          device=device) * 0.01 + 1e-4).to(torch.float16)
        return Q40Weight(qs, d16)

    L, dim, kv = spec.n_layers, spec.dim, spec.kv_dim
    input_band = scheme in ("fused", "overlap") and s > 1
    return {
        "tok_embedding": t(spec.vocab_size, dim, dtype=embed_dtype),
        "rms_final": t(dim), "rms_att": t(L, dim), "rms_ffn": t(L, dim),
        "wcls": mm(spec.vocab_size // s, dim),
        "wqkv": mm(L, (dim + 2 * kv) // s, dim),
        "w13": mm(L, 2 * spec.hidden_dim // s, dim),
        "wo": mm(L, dim, dim // s) if input_band else mm(L, dim // s, dim),
        "w2": (mm(L, dim, spec.hidden_dim // s) if input_band
               else mm(L, dim // s, spec.hidden_dim)),
    }


def rank_params_to_device(params: dict[str, Any], device) -> dict[str, Any]:
    """A rank's host tree of bands (parallel/tp.shard_params) in the port's
    device layout, its q/k/v and w1/w3 bands fused (models/llama.
    params_to_device): the tree make_rank_forward takes."""
    return params_to_device(params, device)


def make_rank_forward(spec: TransformerSpec, n_slices: int,
                      params: dict[str, Any], scheme: str | None = None,
                      route: Route = KERNELS):
    """One rank's forward on its device: ``parallel/tp.TPLlama`` over a
    simulated group of ``n_slices`` (rank 0; its collectives the local
    stand-ins), ``params`` the rank's device tree. Its methods are
    TPLlama's (``forward(cache, tokens, pos)``, the batch forwards); the
    cache is init_rank_cache's shard."""
    device = params["tok_embedding"].device
    return TPLlama(spec, params, sim_group(n_slices, device), scheme, route)


def init_rank_cache(spec: TransformerSpec, n_slices: int, device,
                    dtype=torch.float32) -> KVCache:
    """The rank's KV-cache shard: n_kv/S heads of the whole sequence,
    (L, seq_len, n_kv/S, hs)."""
    shape = (spec.n_layers, spec.seq_len, spec.n_kv_heads // n_slices,
             spec.head_size)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ---- the link model -------------------------------------------------------

def modeled_ici_ms(spec: TransformerSpec, n_slices: int,
                   scheme: str | None = None,
                   gbps: float = NVLINK_GBPS_PER_DIRECTION,
                   latency_us: float = COLLECTIVE_LATENCY_US,
                   ) -> tuple[float, float]:
    """(bandwidth_ms, latency_ms) a token of the scheme's collectives over
    the tp link (the JAX package's name; here NVLink): the budget's moved
    bytes over ``gbps`` GB/s, and ``latency_us`` a hop of each collective
    (comm_stats.collective_hops: a ring collective walks S-1 hops, a hop
    of the overlap ring one). The one formula behind
    project_full_system's link columns and obs/drift's time check; the
    overlap scheme's hidden share is modeled_overlap_hidden_ms."""
    budget = tp_collective_budget(spec, n_slices, scheme)
    bw_ms = budget.moved_bytes / (gbps * 1e9) * 1e3
    lat_ms = sum(count * collective_hops(kind, n_slices) * latency_us
                 for kind, count, _ in budget.entries) / 1e3
    return bw_ms, lat_ms


def modeled_dcn_handoff_ms(spec: TransformerSpec, n_slices: int,
                           n_prompt_positions: int, page_size: int,
                           kv_quant: str = "f32",
                           gbps: float | None = None,
                           latency_us: float | None = None) -> float:
    """Modelled wall ms to ship one request's full prompt pages from the
    prefill pool to the decode pool (runtime/disagg.py): the bytes of
    comm_stats.dcn_handoff_budget over ``gbps`` GiB/s plus a fixed
    ``latency_us``, by default the planning constants HANDOFF_GIB_PER_S
    and HANDOFF_LATENCY_US."""
    budget = dcn_handoff_budget(spec, n_slices, n_prompt_positions,
                                page_size, kv_quant)
    gbps = HANDOFF_GIB_PER_S if gbps is None else gbps
    latency_us = HANDOFF_LATENCY_US if latency_us is None else latency_us
    return budget["bytes"] / (gbps * GIB) * 1e3 + latency_us / 1e3


def _weight_frac(spec: TransformerSpec, names) -> float:
    """The share of one decode step's weight bytes owed to the named
    per-layer matmuls (batch-1 decode streams every weight once a token,
    so time shares follow byte shares)."""
    per_layer = {name: d * n for name, (d, n) in spec.layer_matmul_shapes()}
    total = (spec.n_layers * sum(per_layer.values())
             + spec.vocab_size * spec.dim)  # + wcls
    return spec.n_layers * sum(per_layer[n] for n in names) / total


def modeled_overlap_hidden_ms(spec: TransformerSpec, n_slices: int,
                              shard_ms: float,
                              gbps: float = NVLINK_GBPS_PER_DIRECTION,
                              latency_us: float = COLLECTIVE_LATENCY_US,
                              ) -> float:
    """Collective time the overlap scheme hides behind compute: the ring
    hops (2L(S-1) of them) behind the combines' wo/w2 work, at most that
    work's share of ``shard_ms`` times (S-1)/S, and the deferred ffn
    gathers (L of the 2L+1) behind the rest of the step. The attention
    gathers and the logits gather are consumed at once and stay exposed.
    0 at tp 1."""
    if n_slices <= 1:
        return 0.0
    budget = tp_collective_budget(spec, n_slices, "overlap")
    by_kind = {k: (c, b) for k, c, b in budget.entries}
    pp_count, pp_bytes = by_kind.get("ppermute", (0, 0))
    ag_count, ag_bytes = by_kind.get("all_gather", (0, 0))
    ring_ms = (pp_bytes / (gbps * 1e9) * 1e3
               + pp_count * latency_us / 1e3)
    L = spec.n_layers
    defer_frac = L / max(ag_count, 1)
    defer_ms = (ag_bytes / (gbps * 1e9) * 1e3 * defer_frac
                + L * (n_slices - 1) * latency_us / 1e3)
    combine_ms = shard_ms * _weight_frac(spec, ("wo", "w2"))
    other_ms = max(shard_ms - combine_ms, 0.0)
    s = n_slices
    return (min(ring_ms, combine_ms * (s - 1) / s)
            + min(defer_ms, other_ms))


def expected_accepted_span(alpha: float, k: int) -> float:
    """Expected tokens emitted a K-query verify dispatch at per-draft
    accept rate ``alpha``: sum_{j<k} alpha^j."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"accept rate alpha={alpha} outside [0, 1]")
    if k < 1:
        raise ValueError(f"verify window k={k} must be >= 1")
    return float(sum(alpha ** j for j in range(k)))


@dataclasses.dataclass(frozen=True)
class SpeculativeProjection:
    """Modelled ms an accepted token of a K-query verify dispatch: shard
    compute charged once (the K rows reuse the weight traffic), the
    bandwidth term K times, the latency term once."""
    k: int
    alpha: float
    expected_tokens: float
    dispatch_ms: float
    ms_per_accepted_token: float
    baseline_ms_per_token: float

    @property
    def speedup(self) -> float:
        return self.baseline_ms_per_token / self.ms_per_accepted_token


@dataclasses.dataclass(frozen=True)
class MixedProjection:
    """Modelled cost of one token-budget mixed dispatch: one decode token
    plus a ``budget - 1``-token prefill slice through one forward, against
    the same slice as a dispatch of its own."""
    budget: int
    slice_tokens: int
    dispatch_ms: float
    prefill_ms_per_token: float
    separate_prefill_ms_per_token: float
    baseline_ms_per_token: float

    @property
    def prefill_speedup(self) -> float:
        return (self.separate_prefill_ms_per_token
                / self.prefill_ms_per_token)


@dataclasses.dataclass(frozen=True)
class FullSystemProjection:
    """A rank's measured ms a token plus the modelled link time: the
    projected ms a token of the whole group, with the rank's device
    memory against the card's (a projection for a group that cannot fit
    advertises a number no machine serves)."""
    shard_ms: float          # measured: one rank's program on the card
    ici_bandwidth_ms: float  # modelled: bytes over the link rate
    ici_latency_ms: float    # modelled: a latency a hop of each collective
    n_slices: int
    gather_bytes_per_chip: int
    n_collectives: int
    hbm_per_device_gib: float = 0.0
    hbm_headroom_gib: float = 0.0
    hbm_fits: bool = True
    ici_hidden_ms: float = 0.0  # overlap scheme: modelled hidden share
    scheme: str = ""

    @property
    def total_ms(self) -> float:
        return (self.shard_ms + self.ici_bandwidth_ms + self.ici_latency_ms
                - self.ici_hidden_ms)

    def speculative(self, k: int, alpha: float) -> SpeculativeProjection:
        e = expected_accepted_span(alpha, k)
        dispatch_ms = (self.shard_ms + k * self.ici_bandwidth_ms
                       + self.ici_latency_ms - self.ici_hidden_ms)
        return SpeculativeProjection(
            k=k, alpha=alpha, expected_tokens=round(e, 3),
            dispatch_ms=round(dispatch_ms, 3),
            ms_per_accepted_token=round(dispatch_ms / e, 3),
            baseline_ms_per_token=round(self.total_ms, 3))

    def mixed(self, budget: int) -> MixedProjection:
        if budget < 2:
            raise ValueError(f"mixed budget={budget} must be >= 2 "
                             f"(1 decode token + a non-empty slice)")
        slice_tokens = budget - 1
        dispatch_ms = (self.shard_ms + budget * self.ici_bandwidth_ms
                       + self.ici_latency_ms - self.ici_hidden_ms)
        marginal_ms = (dispatch_ms - self.total_ms) / slice_tokens
        separate_ms = (self.shard_ms + slice_tokens * self.ici_bandwidth_ms
                       + self.ici_latency_ms
                       - self.ici_hidden_ms) / slice_tokens
        return MixedProjection(
            budget=budget, slice_tokens=slice_tokens,
            dispatch_ms=round(dispatch_ms, 3),
            prefill_ms_per_token=round(marginal_ms, 6),
            separate_prefill_ms_per_token=round(separate_ms, 6),
            baseline_ms_per_token=round(self.total_ms, 3))


def rank_memory_bytes(spec: TransformerSpec, n_slices: int,
                      scheme: str | None = None) -> int:
    """One rank's resident device bytes at decode: its Q40 bands in the
    port's layout (18 bytes a 32-value block), the f32 embedding and
    norms every rank holds, its f32 KV shard at seq_len, and the largest
    collective's staging (comm_stats.collective_staging_bytes)."""
    per_layer = sum(d * n for _, (d, n) in spec.layer_matmul_shapes())
    values = (spec.n_layers * per_layer
              + spec.vocab_size * spec.dim) // n_slices
    weights = values // 32 * 18
    replicated = (spec.vocab_size * spec.dim
                  + (2 * spec.n_layers + 1) * spec.dim) * 4
    cache = (2 * spec.n_layers * spec.seq_len
             * (spec.n_kv_heads // n_slices) * spec.head_size * 4)
    return (weights + replicated + cache
            + collective_staging_bytes(spec, n_slices, scheme))


def project_full_system(spec: TransformerSpec, n_slices: int,
                        shard_ms: float,
                        gbps: float = NVLINK_GBPS_PER_DIRECTION,
                        latency_us: float = COLLECTIVE_LATENCY_US,
                        scheme: str | None = None) -> FullSystemProjection:
    """A measured rank time plus the modelled collectives of its scheme
    (comm_stats.tp_collective_budget: the census the runtime counts), the
    overlap scheme less its modelled hidden share (capped at the link
    total), and the rank's memory against the card's usable memory."""
    scheme = scheme or tp_scheme()
    budget = tp_collective_budget(spec, n_slices, scheme)
    bw_ms, lat_ms = modeled_ici_ms(spec, n_slices, scheme, gbps, latency_us)
    hidden_ms = 0.0
    if scheme == "overlap":
        hidden_ms = min(
            modeled_overlap_hidden_ms(spec, n_slices, shard_ms, gbps,
                                      latency_us),
            bw_ms + lat_ms)
    mem = rank_memory_bytes(spec, n_slices, scheme)
    usable = int(CARD_MEMORY_BYTES * (1 - MEMORY_HEADROOM_FRACTION))
    return FullSystemProjection(shard_ms, bw_ms, lat_ms, n_slices,
                                budget.moved_bytes, budget.n_collectives,
                                hbm_per_device_gib=round(mem / GIB, 3),
                                hbm_headroom_gib=round(
                                    (usable - mem) / GIB, 3),
                                hbm_fits=mem <= usable,
                                ici_hidden_ms=round(hidden_ms, 6),
                                scheme=scheme)
