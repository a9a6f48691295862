"""Closed-form device-memory accounting of one rank on one H100 80 GB (the
JAX package's analysis/memory_model.py, pricing the port's device tree).

Every term is hand-checkable against the spec's dims, and each prices
what the port really allocates:

  weights      the matmul weights in the port's device layout
               (ops/linear.q40_to_device): the Q40 codec layout itself,
               16 bytes of codes + one f16 scale a 32-value block, 18 B
               (``q40_codec_bytes``); F16/F32 leaves at 2/4 B a value.
               models/llama.params_to_device fuses q/k/v into ``wqkv`` and
               w1/w3 into ``w13`` (ops/linear.FUSED_LOAD) in place of their
               parts, so the fusion moves no byte; no fusion mode
               (DLLAMA_LAYER_FUSION) and no route (--fast-prefill, a bf16
               cache) keeps a second copy of a weight. Every matmul
               weight is a 1/tp band in every scheme.
  replicated   the f32 embedding and rms norms every rank holds whole;
               beside them the model's f32 RoPE table (``rope_table_bytes``,
               the module's one buffer).
  kv_cache     contiguous 2 x L x B x S/sp x n_kv/tp x head_size in f32 or
               bf16, or the paged pool in f32/bf16 or Q8 (int8 codes + one
               f16 delta a 32-value block: 34 B a 32 values).
  activations  the closed-form vector bound at the dispatch width (t_len
               = spec_k or the mixed budget): residual, norms, q/k/v and
               SwiGLU bands, full and local logits, all f32.
  workspaces   what the hand kernels allocate beside their outputs: K1's
               and K1m's split-K partials (splits, T, d) and their
               tickets, K3's x split (2, T, n) or K3b's rounded x (T, n)
               and their split partials, the flash-decode split buffers
               and tickets of K2/K5/K6/K7 and of the window kernels
               K6w/K7w at B x t_len rows (one static buffer a shape and
               plan) and K4's split partials (``kernel_workspace_bytes``;
               the fused layer's few dim-wide vectors sit in the headroom;
               the plans are the kernels' own,
               ops/q40 and ops/attention, at the card's SM count).
  collectives  double-buffered staging of the largest in-flight collective
               (parallel/comm_stats.collective_staging_bytes).

The card's capacity is one constant (``CARD_MEMORY_BYTES``, the
H100 80GB HBM3's ``torch.cuda.get_device_properties(0).total_memory``);
chip_smoke.py checks it on the card. ``MEMORY_HEADROOM_FRACTION`` of it is
held back for what no formula here prices: the CUDA context (the memory
in use before the first allocation), the caching allocator's slack and
rounding, and cuBLAS's workspace. A config fits when its total stays
inside the rest. ``analysis/shardcheck.py`` gates the declared support
matrix on these verdicts; ``parallel/shard_sim.rank_memory_bytes`` is this
model's total.
"""

from __future__ import annotations

import dataclasses

from ..models.spec import TransformerSpec
from ..ops.quants import QK, FloatType

GIB = 1024 ** 3

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (read on the card by chip_smoke.py's analysis_full_width)
CARD_MEMORY_BYTES = 85_017_493_504
# the CUDA context, the caching allocator's slack and cuBLAS's workspace
MEMORY_HEADROOM_FRACTION = 0.10
H100_SMS = 132  # SMs of the H100 SXM5: the kernels' plans are sized by it
ALLOC_ROUND = 512  # the caching allocator rounds every block up to 512 B

Q40_CODEC_BLOCK_BYTES = 16 + 2    # u8 nibble codes + f16 scale: file = card


def usable_memory_bytes() -> int:
    return int(CARD_MEMORY_BYTES * (1 - MEMORY_HEADROOM_FRACTION))


def q40_codec_bytes(values: int) -> int:
    """Bytes of ``values`` Q40 scalars in the codec layout, which is also
    the port's device layout."""
    return (values // QK) * Q40_CODEC_BLOCK_BYTES


def weight_values_per_device(spec: TransformerSpec, n_slices: int) -> int:
    """Matmul-weight scalars a rank holds: the 7 per-layer matmuls and wcls,
    each a 1/tp band (parallel/tp.py, every scheme)."""
    per_layer = sum(d * n for _, (d, n) in spec.layer_matmul_shapes())
    total = spec.n_layers * per_layer + spec.vocab_size * spec.dim
    return total // n_slices


def weights_device_bytes(spec: TransformerSpec, n_slices: int) -> int:
    """A rank's matmul-weight bytes on the card (wqkv and w13 fused: the
    same bytes as their parts)."""
    values = weight_values_per_device(spec, n_slices)
    ft = spec.weights_float_type
    if ft == FloatType.Q40:
        return q40_codec_bytes(values)
    if ft == FloatType.F16:
        return 2 * values
    if ft == FloatType.F32:
        return 4 * values
    raise ValueError(f"no weight byte model for {ft!r}")


def replicated_device_bytes(spec: TransformerSpec) -> int:
    """Bytes every rank holds whole: the f32 embedding and the rms norms
    (2 a layer + the final one)."""
    embedding = spec.vocab_size * spec.dim * 4
    norms = (2 * spec.n_layers + 1) * spec.dim * 4
    return embedding + norms


def rope_table_bytes(spec: TransformerSpec, n_slices: int = 1) -> int:
    """The model's RoPE frequencies, one f32 a pair of a rank's q and k
    rows (models/llama.Llama's ``freq`` buffer over the rank's
    parallel/tp.local_spec, ops/layer.rope_freq)."""
    return ((spec.dim + spec.kv_dim) // n_slices) // 2 * 4


def kv_cache_device_bytes(spec: TransformerSpec, n_slices: int,
                          batch: int = 1, n_sp: int = 1,
                          cache_itemsize: int = 4) -> int:
    """Contiguous K+V planes at max sequence: kv heads shard over tp, the
    positions over sp (models/llama.init_cache / init_cache_batch; 2 B a
    value for a bf16 cache)."""
    return (2 * spec.n_layers * batch * (spec.seq_len // n_sp)
            * (spec.n_kv_heads // n_slices) * spec.head_size
            * cache_itemsize)


# the page size of the documented tables (positions a page)
DEFAULT_PAGE_SIZE = 16


def default_kv_pages(spec: TransformerSpec, batch: int,
                     page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """The pool that matches ``batch`` contiguous slots byte for byte."""
    return batch * (spec.seq_len // page_size)


def kv_position_bytes(spec: TransformerSpec, n_slices: int,
                      cache_itemsize: int = 4,
                      kv_quant: str = "f32") -> int:
    """K+V bytes of one position on one rank (all layers): f32/bf16 pages
    at ``cache_itemsize`` a value; q8 pages (models/llama.PagedKVQ8) one
    int8 code a value + one f16 delta a 32-value block of the flattened
    (n_kv/tp, hs) row."""
    kv_dim = (spec.n_kv_heads // n_slices) * spec.head_size
    if kv_quant == "q8":
        per = kv_dim + 2 * (kv_dim // QK)
    elif kv_quant == "f32":
        per = kv_dim * cache_itemsize
    else:
        raise ValueError(f"no KV byte model for kv_quant={kv_quant!r}")
    return 2 * spec.n_layers * per


def equal_hbm_kv_pages(spec: TransformerSpec, n_slices: int,
                       n_pages_f32: int,
                       page_size: int = DEFAULT_PAGE_SIZE,
                       cache_itemsize: int = 4) -> int:
    """How many q8 pages the memory of ``n_pages_f32`` f32 (or bf16) pages
    holds."""
    f32_bytes = n_pages_f32 * page_size * kv_position_bytes(
        spec, n_slices, cache_itemsize, "f32")
    page_q8 = page_size * kv_position_bytes(spec, n_slices, kv_quant="q8")
    return f32_bytes // page_q8


def kv_page_pool_bytes(spec: TransformerSpec, n_slices: int, n_pages: int,
                       page_size: int = DEFAULT_PAGE_SIZE,
                       cache_itemsize: int = 4,
                       include_scrap: bool = True,
                       kv_quant: str = "f32") -> int:
    """Paged-pool K+V bytes: (n_pages + the scrap page) x page_size
    positions. ``include_scrap`` charges the dead-write page 0 the engine
    allocates (runtime/continuous.py sizes its pool n_pages + 1)."""
    pages = n_pages + (1 if include_scrap else 0)
    return pages * page_size * kv_position_bytes(spec, n_slices,
                                                 cache_itemsize, kv_quant)


# -- KV tiers and disaggregation -------------------------------------------

# Planning constants of the tier and handoff paths: PCIe Gen5 x16 between
# the host and an H100 SXM5 (64 GB/s a direction, datasheet; the copy
# engines reach less), a modest NVMe read stream, and the host-to-host
# link a prefill->decode handoff crosses. None is measured; the ms they
# give are a model's.
HOST_DEVICE_GBPS = 64.0
DISK_READ_GBPS = 1.5
TIER_PROMOTE_LATENCY_US = 30.0
HANDOFF_GIB_PER_S = 10.0
HANDOFF_LATENCY_US = 200.0


def kv_page_bytes(spec: TransformerSpec, n_slices: int,
                  page_size: int = DEFAULT_PAGE_SIZE,
                  cache_itemsize: int = 4, kv_quant: str = "f32") -> int:
    """Bytes of one page's planes on one rank (all layers, K+V, codes +
    deltas for q8): the unit every tier transfer and handoff moves."""
    return page_size * kv_position_bytes(spec, n_slices, cache_itemsize,
                                         kv_quant)


def kv_tier_model(spec: TransformerSpec, n_slices: int,
                  hbm_pages: int, host_pages: int = 0,
                  disk_bytes: int = 0,
                  page_size: int = DEFAULT_PAGE_SIZE,
                  cache_itemsize: int = 4,
                  kv_quant: str = "f32") -> dict:
    """Per-tier capacity and modelled transfer cost of the KV hierarchy
    (runtime/paging.py's device pool, host slab and disk store): bytes and
    pages each tier's budget holds, and the per-page promotion/demotion
    ms at the planning rates above."""
    pb = kv_page_bytes(spec, n_slices, page_size, cache_itemsize, kv_quant)
    host_ms = pb / (HOST_DEVICE_GBPS * 1e9) * 1e3
    disk_ms = pb / (DISK_READ_GBPS * 1e9) * 1e3
    lat_ms = TIER_PROMOTE_LATENCY_US / 1e3
    return {
        "page_size": page_size,
        "kv_quant": kv_quant,
        "page_bytes": pb,
        "hbm": {"pages": hbm_pages, "bytes": hbm_pages * pb},
        "host": {"pages": host_pages, "bytes": host_pages * pb},
        "disk": {"bytes": disk_bytes,
                 "pages": (disk_bytes // pb) if disk_bytes else 0},
        "promote_host_ms_per_page": round(host_ms + lat_ms, 6),
        "promote_disk_ms_per_page": round(host_ms + disk_ms + lat_ms, 6),
        "demote_ms_per_page": round(host_ms + lat_ms, 6),
    }


def disagg_pool_model(spec: TransformerSpec, n_slices: int,
                      prefill_pages: int, decode_pages: int,
                      page_size: int = DEFAULT_PAGE_SIZE,
                      cache_itemsize: int = 4, kv_quant: str = "f32",
                      prompt_positions: int = 512) -> dict:
    """Per-pool page bytes of the two-pool topology (runtime/disagg.py)
    and the modelled cost of shipping one request's prompt pages
    (comm_stats.dcn_handoff_budget) over the handoff link."""
    from ..parallel.comm_stats import dcn_handoff_budget

    pb = kv_page_bytes(spec, n_slices, page_size, cache_itemsize, kv_quant)
    budget = dcn_handoff_budget(spec, n_slices, prompt_positions,
                                page_size, kv_quant, cache_itemsize)
    ship_ms = (budget["bytes"] / (HANDOFF_GIB_PER_S * GIB) * 1e3
               + HANDOFF_LATENCY_US / 1e3)
    return {
        "page_size": page_size,
        "kv_quant": kv_quant,
        "page_bytes": pb,
        "prefill": {"pages": prefill_pages, "bytes": prefill_pages * pb},
        "decode": {"pages": decode_pages, "bytes": decode_pages * pb},
        "handoff": {**budget,
                    "gib_per_s": HANDOFF_GIB_PER_S,
                    "ship_ms_per_page": round(
                        pb / (HANDOFF_GIB_PER_S * GIB) * 1e3, 6),
                    "ship_ms_per_request": round(ship_ms, 6)},
    }


# -- activations and the kernels' workspaces ---------------------------------


def activation_bytes_analytic(spec: TransformerSpec, n_slices: int,
                              t_len: int = 1) -> int:
    """The activation bound at t_len rows: residual + norm buffer +
    gathered block outputs, local SwiGLU bands, local q/k/v, the full and
    the local logits, all f32."""
    s = n_slices
    vecs = (4 * spec.dim
            + 2 * (spec.hidden_dim // s)
            + (spec.dim + 2 * spec.kv_dim) // s
            + spec.vocab_size + spec.vocab_size // s)
    return 4 * t_len * vecs


def _matmul_shapes(spec: TransformerSpec, n_slices: int):
    """(d, n) of every Q40 matmul a rank launches: the fused wqkv and w13,
    wo, w2 and wcls, as 1/tp bands (wo/w2 output bands: the larger d)."""
    s = n_slices
    return ((spec.dim + 2 * spec.kv_dim) // s, spec.dim), \
        (spec.dim // s, spec.dim), (2 * spec.hidden_dim // s, spec.dim), \
        (spec.dim // s, spec.hidden_dim), (spec.vocab_size // s, spec.dim)


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def matmul_workspace_bytes(spec: TransformerSpec, n_slices: int,
                           t_len: int = 1, sms: int = H100_SMS,
                           bf16: bool = False) -> int:
    """The largest transient a Q40 matmul of t_len rows allocates beside
    its output (one matmul runs at a time): K1/K1m's split-K partials
    (splits, T, d) f32 by ops/q40.matvec_plan; K3's TF32 halves of x
    (2, T, n) f32 or K3b's rounded x (T, n) bf16 and their split partials
    by gemm_tf32_plan / gemm_bf16_plan. Dense (F16/F32) weights go through
    torch's own matmul: none."""
    from ..ops import q40

    if spec.weights_float_type != FloatType.Q40:
        return 0
    t = t_len
    worst = 0
    for d, n in _matmul_shapes(spec, n_slices):
        nb = n // QK
        if t <= q40.MULTI_T_MAX:
            splits = q40.matvec_plan(t, d, nb, sms)[3]
            need = _rounded(splits * t * d * 4) if splits > 1 else 0
        else:
            plan = q40.gemm_bf16_plan if bf16 else q40.gemm_tf32_plan
            splits = plan(t, d, nb, sms)[0]
            xs = (_rounded(t * n * 2) if bf16 else _rounded(2 * t * n * 4))
            need = xs + (_rounded(splits * t * d * 4) if splits > 1 else 0)
        worst = max(worst, need)
    return worst


def matvec_ticket_bytes() -> int:
    """K1/K1m/K1d's split-K tickets: one static int32 buffer a device."""
    from ..ops import q40

    return _rounded(q40.MATVEC_TICKETS * 4)


def decode_scratch_bytes(spec: TransformerSpec, n_slices: int,
                         batch: int = 1, rows: int | None = None,
                         sms: int = H100_SMS) -> int:
    """The flash-decode split buffer and tickets of one decode shape
    (ops/attention._decode_scratch: K2 at B = 1, K5 at B rows, K6/K7 at
    B x t_len rows): batch x n_kv x most x kv_mul x (hs + 2) f32 and
    batch x n_kv int32, made once and kept; none for a one-split plan."""
    from ..ops import attention

    n_kv = spec.n_kv_heads // n_slices
    if n_kv < 1:  # tp above the kv heads: no such rank (J006 reports it)
        return 0
    rows = batch if rows is None else rows
    most = attention.decode_plan(n_kv, rows, sms)[0]
    if most == 1:
        return 0
    return (_rounded(rows * n_kv * most * spec.kv_mul
                     * (spec.head_size + 2) * 4)
            + _rounded(rows * n_kv * 4))


def window_scratch_bytes(spec: TransformerSpec, n_slices: int, batch: int,
                         t_len: int, sms: int = H100_SMS) -> int:
    """The window kernels' split buffer and tickets (K6w and K7w: a paged
    verify or mixed window of ``batch`` rows of ``t_len`` >= WINDOW_MIN_T
    queries,
    ops/paged_attention._launch): _decode_scratch at batch x t_len rows
    under the window plan's most splits, made once and kept; none below
    WINDOW_MIN_T or for a one-split plan."""
    from ..ops import paged_attention

    n_kv = spec.n_kv_heads // n_slices
    if t_len < paged_attention.WINDOW_MIN_T or n_kv < 1:
        return 0
    most = paged_attention.window_plan(n_kv, batch, t_len, spec.kv_mul,
                                       sms)[0]
    if most == 1:
        return 0
    rows = batch * t_len
    return (_rounded(rows * n_kv * most * spec.kv_mul
                     * (spec.head_size + 2) * 4)
            + _rounded(rows * n_kv * 4))


def prefill_split_bytes(spec: TransformerSpec, n_slices: int, t_len: int,
                        pos: int | None = None, sms: int = H100_SMS,
                        bf16: bool = False) -> int:
    """K4's (or K4b's) split partials for a t_len-token chunk ending at
    the cache's end (the widest plan): (splits, n_all, hs) and
    (2, splits, n_all) f32, n_all = T x n_q."""
    from ..ops import attention

    n_kv = spec.n_kv_heads // n_slices
    if t_len <= 1 or n_kv < 1:
        return 0
    pos = spec.seq_len - t_len if pos is None else pos
    if bf16:
        keys = attention.PREFILL_BF16_KEYS[attention.CACHE_DTYPES[0]]
        splits = attention.prefill_bf16_plan(pos, t_len, spec.kv_mul, n_kv,
                                             keys, sms)[0]
    else:
        splits = attention.prefill_plan(pos, t_len, spec.kv_mul, n_kv,
                                        sms)[0]
    if splits <= 1:
        return 0
    n_all = t_len * n_kv * spec.kv_mul
    return (_rounded(splits * n_all * spec.head_size * 4)
            + _rounded(2 * splits * n_all * 4))


def kernel_workspace_bytes(spec: TransformerSpec, n_slices: int,
                           t_len: int = 1, batch: int = 1,
                           sms: int = H100_SMS, bf16: bool = False) -> int:
    """What the hand kernels hold beside the activations at a dispatch of
    ``batch`` rows of ``t_len`` tokens: the largest matmul transient, the
    matvec tickets, the decode split buffer of this shape, K4's split
    partials (t_len > 1) and the window kernels' split buffer of a paged
    window of this shape (t_len >= WINDOW_MIN_T); ``bf16`` prices the
    --fast-prefill
    route (K3b, K4b)."""
    rows = batch * t_len
    return (matmul_workspace_bytes(spec, n_slices, rows, sms, bf16)
            + matvec_ticket_bytes()
            + decode_scratch_bytes(spec, n_slices, batch, sms=sms)
            + prefill_split_bytes(spec, n_slices, t_len, sms=sms,
                                  bf16=bf16)
            + window_scratch_bytes(spec, n_slices, batch, t_len, sms))


# -- the assembled report ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    """One rank's device memory for one (spec, tp, scheme) config."""

    model: str
    tp: int
    scheme: str
    weights_float_type: str
    weights_bytes: int
    replicated_bytes: int
    kv_cache_bytes: int
    activation_bytes: int
    workspace_bytes: int
    collective_bytes: int
    budget_bytes: int
    tier_staging_bytes: int = 0
    rope_bytes: int = 0

    @property
    def resident_bytes(self) -> int:
        """What a loaded engine holds before its first step: weights,
        replicated tensors, the RoPE table and the cache."""
        return (self.weights_bytes + self.replicated_bytes + self.rope_bytes
                + self.kv_cache_bytes)

    @property
    def total_bytes(self) -> int:
        return (self.resident_bytes + self.activation_bytes
                + self.workspace_bytes + self.collective_bytes
                + self.tier_staging_bytes)

    @property
    def headroom_bytes(self) -> int:
        return self.budget_bytes - self.total_bytes

    @property
    def fits(self) -> bool:
        return self.headroom_bytes >= 0

    def as_json(self) -> dict:
        keys = ["weights_bytes", "replicated_bytes", "rope_bytes",
                "kv_cache_bytes", "activation_bytes", "workspace_bytes",
                "collective_bytes"]
        if self.tier_staging_bytes:
            keys.append("tier_staging_bytes")
        return {
            "model": self.model, "tp": self.tp, "scheme": self.scheme,
            "weights_float_type": self.weights_float_type,
            "components_bytes": {k.replace("_bytes", ""): getattr(self, k)
                                 for k in keys},
            "components_gib": {k.replace("_bytes", ""):
                               round(getattr(self, k) / GIB, 3)
                               for k in keys},
            "total_bytes": self.total_bytes,
            "total_gib": round(self.total_bytes / GIB, 3),
            "budget_gib": round(self.budget_bytes / GIB, 3),
            "headroom_gib": round(self.headroom_bytes / GIB, 3),
            "fits": self.fits,
        }


def device_footprint(spec: TransformerSpec, n_slices: int, scheme: str,
                     model: str = "?", batch: int = 1,
                     activation_bytes: int | None = None,
                     kv_page_size: int = 0,
                     kv_pages: int | None = None,
                     spec_k: int = 0, kv_quant: str = "f32",
                     tier_staging_pages: int = 0,
                     mixed_budget: int = 0,
                     sms: int = H100_SMS) -> MemoryReport:
    """One rank's report. ``kv_page_size > 0`` prices the paged pool
    (default: byte parity with ``batch`` contiguous slots, plus the scrap
    page) instead of ``batch`` contiguous stripes; ``kv_quant='q8'``
    (paged only) at the Q8 byte rate. ``spec_k`` or ``mixed_budget`` widen
    the dispatch: the activations, the kernels' workspaces and the
    collective staging are priced at t_len = that width (the engine
    refuses both at once).
    ``tier_staging_pages`` prices a tiered engine's device-side promotion
    staging at the pool's page rate."""
    from ..parallel.comm_stats import collective_staging_bytes

    if spec_k and mixed_budget:
        raise ValueError("spec_k and mixed_budget are mutually exclusive "
                         "(the engine rejects --spec-k with "
                         "--dispatch-tokens; price one dispatch shape)")
    t_len = max(1, spec_k, mixed_budget)
    if kv_quant != "f32" and kv_page_size <= 0:
        raise ValueError(f"kv_quant={kv_quant!r} prices PAGE planes; "
                         f"pass kv_page_size > 0")
    if tier_staging_pages and kv_page_size <= 0:
        raise ValueError("tier_staging_pages prices PAGE planes; pass "
                         "kv_page_size > 0")
    if activation_bytes is None:
        activation_bytes = activation_bytes_analytic(spec, n_slices,
                                                     t_len=t_len)
    if kv_page_size > 0:
        pages = (kv_pages if kv_pages is not None
                 else default_kv_pages(spec, batch, kv_page_size))
        kv_bytes = kv_page_pool_bytes(spec, n_slices, pages, kv_page_size,
                                      kv_quant=kv_quant)
    else:
        kv_bytes = kv_cache_device_bytes(spec, n_slices, batch=batch)
    return MemoryReport(
        model=model, tp=n_slices, scheme=scheme,
        weights_float_type=FloatType(spec.weights_float_type).name,
        weights_bytes=weights_device_bytes(spec, n_slices),
        replicated_bytes=replicated_device_bytes(spec),
        kv_cache_bytes=kv_bytes,
        activation_bytes=int(activation_bytes),
        workspace_bytes=kernel_workspace_bytes(spec, n_slices, t_len,
                                               batch, sms),
        collective_bytes=collective_staging_bytes(spec, n_slices, scheme,
                                                  t_len=t_len),
        budget_bytes=usable_memory_bytes(),
        rope_bytes=rope_table_bytes(spec, n_slices),
        tier_staging_bytes=(tier_staging_pages * kv_page_bytes(
            spec, n_slices, kv_page_size, kv_quant=kv_quant)
            if tier_staging_pages else 0))


def tensor_leaves(tree) -> list:
    """The tensors of a device tree (a Q40 pair is two)."""
    out = []
    for v in tree.values():
        out += [v] if hasattr(v, "element_size") else list(v)
    return out


def tree_bytes(tree) -> int:
    """Summed bytes of a device tree (tensors and Q40 pairs), as it lies:
    what weights_device_bytes + replicated_device_bytes price."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree))
