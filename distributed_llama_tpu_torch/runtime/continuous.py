"""Continuous batching: per-slot position clocks, mid-flight admission and
the paged KV pool (the JAX package's runtime/continuous.py).

The lockstep batch (runtime/generate.generate_batch) shares one clock
across rows, so the batch finishes at the pace of its slowest row. This
engine keeps a fixed pool of B slots, each with its OWN position clock
(``Llama.forward_batch_ragged``: per-row RoPE, cache column and attention
length), and a host scheduler that retires a row the moment it stops (BOS
or its step budget) and admits the next queued request into the freed
slot while the other rows keep decoding. Prompt tokens are forced through
the decode step, or prefilled in chunks at admission (``prefill_chunk``);
each request samples from its own xorshift stream seeded ``seed + index``,
so scheduling is invisible in every request's tokens.

With ``page_size > 0`` the cache is a pool of pages shared by all slots
through per-slot page tables (runtime/paging.py), with radix-tree sharing
of full prompt pages, ``Llama.forward_batch_paged`` as the step and K6 as
its attention; ``kv_quant='q8'`` stores the pages as Q80 codes and deltas
(K7). A pool smaller than slots x seq_len pauses page-starved rows (they
ride the step masked inactive, their dead writes parked on the scrap page)
and requeues admissions it cannot serve.

On the card the step is captured in CUDA graphs (runtime/decode.GraphStep)
over static device buffers: the token, position and page-table rows, and
for the fused K-step chain (``block_steps`` K > 1, ``step_many``) the
active mask, budgets, forced tokens, coins and per-row temperature and
top-p; one graph per greedy/sampled chain, one for ``step_once``'s
forward, whose logits the host samples as the JAX engine does. Between
replays the host stages those rows and runs admission prefill eagerly:
prefill writes the captured cache IN PLACE (``scatter_pages``, the slot
insert), because a rebound cache tensor would leave every later replay
reading stale memory. The chain reads its (K, B) tokens and active flags
back once. There is no fallback: a kernel that fails raises.

With ``mesh`` (a parallel/mesh.TPGroup of size > 1; the JAX package's
argument name) the engine is one tensor-parallel rank: the step, the
admission prefill and every cache hold the rank's kv heads
(parallel/tp.TPLlama's forward_batch_ragged / forward_batch_paged), the
logits come back whole, and every rank schedules and samples the same
way. A CUDA graph over the group's collectives is not yet ported: pass
graph=False.

Over the paged pool two more dispatch kinds replace the step (the JAX
engine's step_many routing). ``spec_k`` K (speculative decoding,
runtime/speculative.py): each row feeds its current token plus its
pending forced prompt tokens and then up to K-1 n-gram drafts in ONE
K-query verify forward (``Llama.forward_batch_spec_paged``); the host
replays each row position by position and stops at the first outcome that
differs from the fed input, then rolls the page table back to the
accepted length (``_trim_pages``). ``dispatch_tokens`` T (token-budget
mixed dispatch): every active decode row takes one position and ONE row
with forced prompt tokens left (the lowest request index) takes up to the
rest of the budget, in one (slots, T) forward
(``Llama.forward_batch_mixed_paged``); admission prefill is then off, the
prompt rides the slices. Both need pages, they exclude each other, and on
the card each is one captured graph per (kind, greedy_only) over static
(slots, K) or (slots, T) token rows, the positions, the spans and the page
table; the greedy graph argmaxes on the card and copies (B, K|T) int32
back, the sampled one the logits.

The books are the JAX engine's: the census ring and the ledger book are
always on (obs/ledger.py); ``metrics`` (an obs/metrics.Registry) adds the
engine metrics and the span timeline, ``slo`` (an obs/slo.SLOPolicy) the
verdict tracker, ``journal`` (runtime/journal.RequestJournal) the
write-ahead journal with ``recover`` and ``suspend``, and ``watchdog``
(runtime/supervisor.StepWatchdog) is armed around each dispatch, the host
read of its tokens or logits included: CUDA work is asynchronous, so a
hung kernel shows only where the host waits for it.

The KV tiers (``kv_host_pages``, ``kv_disk_dir``, ``kv_disk_bytes``):
cold radix-tree pages demote to a pinned host pool and on to disk instead
of dropping (runtime/paging.py keeps the books, runtime/kv_io.py moves the
bytes), and a prefix hit on a spilled page promotes it back: the request
PAUSEs (rides the dispatches masked inactive, its admission prefill
deferred) until the page's copy lands, which ``_settle_promotions`` checks
at every step boundary. ``remote_pages`` makes the engine the decode pool
of a disaggregated pair (runtime/disagg.py): shipped pages adopt through
the same pending machinery (``ingest_remote``), and ``export_prefix_sync``
serves the prefill pool's side. ``slo_priority`` pops the best-ranked SLO
class first (and gives it the mixed slice); ``prefill_hold`` parks an
admission prefill at a page-aligned chunk boundary (f32 pools) so a
higher-ranked arrival prefills first. Tiering, adoption and preemption
never change a request's stream.

``chaos`` (a runtime/chaos.ChaosMonkey) arms the JAX engine's
deterministic fault injection: a sleep before every Nth dispatch (inside
the watchdog's armed window, before the replay or launch, so never inside
a graph capture), refused page allocations (before the page table is
staged), a page stolen from a cancelled release, a mixed slice cut past
the budget (the window stays (slots, T); the overrun shows in
``overrun_steps``), doubled ledger charges, ledgers left open, and tier
demotions whose payload is dropped. Every hook is host-side.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

from ..io.loader import Q40Weight
from ..io.tokenizer import BOS
from ..models.llama import (FAST, KERNELS, Llama, gather_pages,
                            gather_pages_q8, init_cache, init_cache_batch,
                            init_cache_paged, init_cache_paged_q8,
                            params_to_device, scatter_pages, scatter_pages_q8,
                            with_body)
from ..models.spec import TransformerSpec
from ..obs import tracectx
from ..obs.ledger import CensusRing, LedgerBook
from ..ops import attention, paged_attention, q40
from ..ops._build import build
from ..parallel.mesh import TPGroup, single
from ..parallel.tp import validate_kv_quant
from .decode import GraphStep, greedy_verify_tokens, sample_device_dynamic
from .generate import _no_capture, _tp_model, run_chunked_prefill
from .paging import SCRAP_PAGE, PagedAllocator
from .sampling import Sampler
from .speculative import accept_or_resample, draft_tokens


@dataclasses.dataclass
class Request:
    """One generation request flowing through the slot pool: ``tokens`` is
    the encoded prompt (BOS included, non-empty); the sampling fields
    override the engine's defaults. The engine fills ``out`` and sets
    ``done`` when the request retires (``error`` first if it failed)."""
    tokens: list
    steps: int
    temperature: float | None = None
    topp: float | None = None
    seed: int | None = None
    out: list = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    index: int = -1  # submission order, assigned by submit()
    error: str | None = None
    cancelled: bool = False  # consumer gone: retire at the next step
    # called with each token as it lands in ``out`` (prompt echoes too);
    # must be fast and must not raise
    on_token: Any = None
    # SLO priority class (obs/slo.py): None = the policy's default class
    slo_class: str | None = None
    # journal recovery: coins the sampler consumed in a previous life;
    # admission skips the stream past them
    coin_cursor: int = 0
    # journal id of the previous life this request replays: its admit
    # record carries it as ``recovers``, retiring the old life atomically
    recovered_from: int | None = None
    # prejournal() already assigned the index and journaled the admit
    prejournaled: bool = False
    # obs/tracectx.TraceContext, minted at ingress or by submit()
    trace: Any = None
    # time.monotonic stamps (0.0 = not reached); t_first_token marks the
    # first SAMPLED token
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    n_sampled: int = 0
    # the live obs/ledger.RequestLedger (opened by submit) and the bill a
    # previous life carried across a recovery (merged into this one's)
    ledger: Any = None
    carried_cost: dict | None = None


@dataclasses.dataclass
class _Slot:
    req: Request | None = None   # None = free
    pos: int = 0                 # this row's position clock
    token: int = 0               # next input token
    forced: list = dataclasses.field(default_factory=list)
    budget: int = 0              # max positions for this request
    sampler: Sampler | None = None
    # paged mode: physical page ids in logical order; the first ``shared``
    # came from the radix tree (refcounted, never written by this slot)
    pages: list = dataclasses.field(default_factory=list)
    shared: int = 0
    # True while the slot's shared-prefix pages await a promotion upload:
    # its admission prefill waits and it rides dispatches masked inactive
    # until the payload lands (_settle_promotions)
    await_promo: bool = False
    # admission prefill parked at a page-aligned chunk boundary (a
    # higher-ranked arrival preempted it): _resume_prefills continues it
    prefill_pending: bool = False
    t_promo: float = 0.0  # when the slot began waiting on a promotion

    @property
    def free(self) -> bool:
        return self.req is None


@dataclasses.dataclass
class ContinuousStats:
    tokens: int = 0          # emitted tokens (prompt echoes included)
    steps: int = 0           # device steps executed
    total_ms: float = 0.0
    max_active: int = 0
    sum_active: int = 0      # active slots summed over device steps
    pauses: int = 0          # page-starved slot pauses (one per dispatch)
    requeues: int = 0        # admissions the dry pool sent back
    prefill_chunks: int = 0  # admission-prefill forward passes
    spec_proposed: int = 0   # drafted tokens fed to verify dispatches
    spec_accepted: int = 0   # drafts the verify replay accepted
    # extra device-step equivalents of mixed dispatches packed past the
    # budget: ceil(sum(span) / budget) - 1 each, nonzero only under the
    # overrun_budget chaos mutation (the virtual clock charges them)
    overrun_steps: int = 0
    promo_waits: int = 0     # admissions that paused on a promotion
    promo_wait_s: float = 0.0  # their summed pause (admit to landing)

    @property
    def spec_accept_rate(self) -> float:
        """Accepted drafts over proposed ones."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.total_ms / 1000, 1e-9)

    @property
    def avg_active(self) -> float:
        """Mean active slots per device step."""
        return self.sum_active / max(self.steps, 1)


class _Chain:
    """The static buffers of one fused K-step chain and its graph."""

    def __init__(self, k: int, batch: int, device):
        def buf(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=device)

        self.k = k
        self.active = buf((batch,), torch.bool, False)
        self.budget = buf((batch,), torch.int32)
        self.forced = buf((k, batch), torch.int64, -1)
        self.coins = buf((k, batch), torch.float32)
        self.temps = buf((batch,), torch.float32)
        self.topps = buf((batch,), torch.float32)
        self.index = buf((), torch.int64)
        self.toks = buf((k, batch), torch.int64)
        self.acts = buf((k, batch), torch.bool, False)
        self.graph: GraphStep | None = None


class _Window:
    """The static buffers of one verify or mixed dispatch and its graph:
    the (B, W) input tokens and what comes back, (B, W) int32 ids
    (greedy) or (B, W, vocab) logits (sampled)."""

    def __init__(self, width: int, batch: int, vocab: int,
                 greedy_only: bool, device):
        self.tokens = torch.zeros((batch, width), dtype=torch.int64,
                                  device=device)
        shape = (batch, width) if greedy_only else (batch, width, vocab)
        self.out = torch.zeros(shape, dtype=torch.int32 if greedy_only
                               else torch.float32, device=device)
        self.greedy_only = greedy_only
        self.graph: GraphStep | None = None


def _load(dst: torch.Tensor, src: np.ndarray) -> None:
    # dlint: allow[D001] host staging, the stream idle
    dst.copy_(torch.from_numpy(np.ascontiguousarray(src)).to(dst.dtype))


def _on_device(params: dict[str, Any]) -> bool:
    w = params.get("tok_embedding")
    return isinstance(w, torch.Tensor) or (
        isinstance(w, Q40Weight) and isinstance(w.qs, torch.Tensor))


class ContinuousEngine:
    """Owns the slot cache (contiguous or paged) and the captured step;
    schedules requests. ``slots`` bounds concurrent sequences; any number
    of requests stream through the pool. ``params`` is a host tree (moved
    to ``device``) or a tree params_to_device already made on it.
    ``kv_quant`` None reads DLLAMA_KV_QUANT once (paged_attention.
    kv_quant_mode). ``graph=False`` runs the steps eagerly on the card
    (tests). ``mesh`` (a TPGroup) makes the engine one tensor-parallel
    rank under ``scheme`` (None: DLLAMA_TP_SCHEME); ``params`` is then the
    rank's host tree of bands."""

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 slots: int, temperature: float, topp: float, seed: int,
                 cache_dtype: torch.dtype = torch.float32,
                 prefill_chunk: int = 0, block_steps: int = 1,
                 fast_prefill: bool = False, page_size: int = 0,
                 kv_pages: int = 0, prefix_share: bool = True,
                 kv_quant: str | None = None, device="cuda",
                 graph: bool | None = None, mesh=None, spec_k: int = 0,
                 spec_ngram: int = 3,
                 dispatch_tokens: int = 0, metrics=None, slo=None,
                 chaos=None, journal=None, watchdog=None,
                 kv_host_pages: int = 0, kv_disk_dir: str | None = None,
                 remote_pages: bool = False, slo_priority: bool = False,
                 scheme: str | None = None, kv_disk_bytes: int = 0,
                 kv_tier_async: bool = True):
        if mesh is not None and not isinstance(mesh, TPGroup):
            raise ValueError(f"not yet ported: mesh of type "
                             f"{type(mesh).__name__} (the port's mesh is a "
                             f"parallel/mesh.TPGroup, the tp axis; the JAX "
                             f"package's dp axis is not ported)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        # the JAX engine's checks and messages
        if spec_k:
            if spec_k < 2:
                raise ValueError(f"spec_k={spec_k}: the verify window is "
                                 f"current token + K-1 drafts, so K >= 2 "
                                 f"(K=0 disables)")
            if page_size <= 0:
                raise ValueError(
                    "spec_k requires the paged KV cache (pass "
                    "--kv-page-size with --spec-k): acceptance rollback "
                    "truncates the page-table logical length")
        if dispatch_tokens == -1:  # auto: every slot's decode token plus a
            dispatch_tokens = slots - 1 + max(prefill_chunk, 2)  # slice
        if dispatch_tokens:
            if dispatch_tokens < 2:
                raise ValueError(
                    f"dispatch_tokens={dispatch_tokens}: the budget holds "
                    f"decode rows plus a prefill slice, so it must be "
                    f">= 2 (0 disables, -1 sizes from the chunk knob)")
            if page_size <= 0:
                raise ValueError(
                    "dispatch_tokens requires the paged KV cache (pass "
                    "--kv-page-size with --dispatch-tokens): the mixed "
                    "window writes through per-row page tables")
            if spec_k:
                raise ValueError(
                    "dispatch_tokens is incompatible with spec_k: the "
                    "verify window and the prefill slice both claim the "
                    "per-row span (unifying them is follow-up work)")
        if kv_quant is None:
            kv_quant = paged_attention.kv_quant_mode()
        if kv_pages and page_size <= 0:
            raise ValueError("kv_pages requires page_size > 0 (pass "
                             "--kv-page-size with --kv-pages)")
        if kv_quant not in paged_attention.KV_QUANTS:
            raise ValueError(f"kv_quant={kv_quant!r}: expected f32|q8")
        if kv_quant == "q8" and page_size <= 0:
            raise ValueError("kv_quant='q8' quantizes PAGE planes; pass "
                             "page_size > 0 (--kv-page-size with "
                             "--kv-quant q8)")
        if (kv_host_pages or kv_disk_dir) and page_size <= 0:
            raise ValueError("KV tiering spills PAGES: pass page_size > 0 "
                             "(--kv-page-size with --kv-host-pages/"
                             "--kv-disk-dir)")
        if remote_pages and page_size <= 0:
            raise ValueError("remote_pages ingests KV PAGES: pass "
                             "page_size > 0 (--kv-page-size with "
                             "--disagg-role decode)")
        if slo_priority and slo is None:
            raise ValueError("slo_priority orders admission by SLO class: "
                             "pass an SLO policy (slo=...)")
        if kv_disk_bytes and not kv_disk_dir:
            raise ValueError("kv_disk_bytes without kv_disk_dir: the disk "
                             "tier needs a directory (--kv-disk-dir)")
        self.spec = spec
        self.slots = slots
        # deterministic fault injection (runtime/chaos.ChaosMonkey); None =
        # every hook off
        self._chaos = chaos
        self.temperature = temperature
        self.topp = topp
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.block_steps = block_steps
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.dispatch_tokens = dispatch_tokens
        self._mixed_rr = 0  # the budget's rotating fairness cursor
        self.page_size = page_size
        self.kv_quant = kv_quant
        self.group = mesh or single(device)
        self.device = (self.group.device if mesh is not None
                       else torch.device(device))
        if page_size > 0 and self.group.sp_size > 1:
            raise ValueError(f"paged KV cache requires sp=1, got "
                             f"sp={self.group.sp_size} (page tables break "
                             f"contiguous sequence chunks)")
        _no_capture(self.group, self.device, graph)
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        if self.device.type == "cuda":
            build([*q40.KERNELS, *q40.HELPERS, *attention.KERNELS,
                   *attention.HELPERS, *paged_attention.KERNELS])
        # the small-T body is read once, as generate_batch reads it
        body = q40.multi_t_body()
        if self.group.sharded:
            validate_kv_quant(spec, self.group.size, kv_quant)
            self.model = _tp_model(spec, params, self.group, scheme,
                                   with_body(KERNELS, body))
            self.params = self.model.params
        else:
            self.params = (params if _on_device(params)
                           else params_to_device(params, self.device))
            self.model = Llama(spec, self.params, with_body(KERNELS, body))
        kv_spec = self.model.spec  # the rank's kv heads under a mesh
        # admission prefill: every chunk (tail included) on one route
        self._prefill_route = (with_body(FAST, body) if fast_prefill
                               else self.model.route)
        self._cache_dtype = cache_dtype
        self._alloc: PagedAllocator | None = None
        self._io = None
        if page_size > 0:
            self._max_pages = spec.seq_len // page_size
            n_pages = kv_pages or slots * self._max_pages
            # +1 physical page: the reserved scrap page 0; both pools
            # raise unless page_size divides seq_len
            self.cache = (
                init_cache_paged_q8(kv_spec, n_pages + 1, page_size,
                                    self.device)
                if kv_quant == "q8" else
                init_cache_paged(kv_spec, n_pages + 1, page_size,
                                 self.device, cache_dtype))
            if kv_disk_dir and self.group.size > 1:
                # one disk tier a rank: each holds its own band's pages
                import os

                kv_disk_dir = os.path.join(kv_disk_dir,
                                           f"rank{self.group.rank}")
            if kv_host_pages or kv_disk_dir or remote_pages:
                from .kv_io import PageIO

                self._io = PageIO(self.cache, self.device,
                                  host_pages=kv_host_pages,
                                  lockstep=self.group.size > 1)
            self._alloc = PagedAllocator(
                n_pages, page_size, prefix_share=prefix_share,
                host_pages=kv_host_pages, disk_dir=kv_disk_dir,
                disk_bytes=kv_disk_bytes, remote=remote_pages,
                host_slab=self._io.slab if self._io is not None else None,
                host_layout=self._io.layout if self._io is not None
                else None)
            self._stage_tbl = np.zeros((slots, self._max_pages), np.int32)
            self._table = torch.zeros((slots, self._max_pages),
                                      dtype=torch.int32, device=self.device)
        else:
            self.cache = init_cache_batch(kv_spec, slots, self.device,
                                          cache_dtype)
        # the step's static device rows, staged by the host between replays
        self._tokens = torch.zeros(slots, dtype=torch.int64,
                                   device=self.device)
        self._pos = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._logits = torch.zeros((slots, spec.vocab_size),
                                   dtype=torch.float32, device=self.device)
        self._once: GraphStep | None = None
        self._chains: dict = {}  # (k, greedy_only) -> _Chain
        self._windows: dict = {}  # (kind, greedy_only) -> _Window
        self._span_rows = torch.zeros(slots, dtype=torch.int32,
                                      device=self.device)
        width = spec_k or dispatch_tokens
        self._stage_win = np.zeros((slots, max(width, 1)), np.int64)
        self._stage_i32 = np.zeros((3, slots), np.int32)
        self._stage_f32 = np.zeros((2, slots), np.float32)
        self._stage_active = np.zeros((slots,), np.bool_)
        self._pool = [_Slot() for _ in range(slots)]
        self._queue: list[Request] = []
        self._lock = threading.Lock()
        # serving over tp ranks (runtime/tp_plan.py): rank 0's PlanLeader,
        # and the intake its handlers fill between dispatches
        self._leader = None
        self._intake: list[Request] = []
        self._cancels: list[Request] = []
        self.stats = ContinuousStats()
        self._bind_tiers(kv_tier_async)
        # SLO-aware admission: with slo_priority the best-ranked class pops
        # first (FIFO within a class) and takes the mixed slice
        self._prio = slo.rank if slo_priority else None
        # chunk-boundary prefill preemption: called at page-aligned chunk
        # boundaries of admission prefill (f32 pools); True parks the slot
        self.prefill_hold = None
        # handoff intake and page export: handler threads queue work here
        # and the scheduler thread does it at its next iteration (the radix
        # tree is the scheduler's alone)
        self._remote_inbox: list = []
        self._export_inbox: list = []
        # the global bytes of the page planes (scrap page included; every
        # rank's band under tp), for /health and the pool metrics
        self.pool_bytes = (sum(int(a.nbytes) for a in self.cache)
                           * self.group.size if page_size > 0 else 0)
        self._init_books(metrics, slo, journal, watchdog, scheme)

    def _bind_tiers(self, kv_tier_async: bool) -> None:
        """Bind the allocator's device I/O (runtime/kv_io.PageIO): the
        demotion reads, the inline promotion stage, and with
        ``kv_tier_async`` a PageUploader that stages disk payloads off the
        scheduler thread (not under tp: when a promotion lands must be the
        same on every rank). Remote-only (a decode pool): no demotion
        reads."""
        self._uploader = None
        self._tier_seen = {"prom": 0, "dem": 0, "hbm": 0, "host": 0,
                           "disk": 0}
        alloc, io = self._alloc, self._io
        if alloc is None or io is None:
            return
        from .paging import PageUploader

        alloc.on_pending_drop = io.on_pending_drop
        if alloc.tiered:
            if kv_tier_async and not io.lockstep:
                self._uploader = PageUploader(stage=io.stage_host,
                                              on_cancel=io.release)
            alloc.bind_device_io(io.fetch, stage=io.stage_inline,
                                 uploader=self._uploader,
                                 fetch_into=io.fetch_into)
            if self._chaos is not None:
                # consulted per demotion; the monkey's drop_on_demote
                # decides
                alloc.corrupt_demote = self._chaos.demote_drop
        else:
            alloc.bind_device_io(None, stage=io.stage_inline)

    @property
    def page_io(self):
        """The runtime/kv_io.PageIO of a tiered or remote engine, or
        None."""
        return self._io

    def close(self) -> None:
        """Release the engine's background resources: the KV tiers'
        uploader thread. Idempotent; the engine must not step after it."""
        if self._uploader is not None:
            self._uploader.close()
            self._uploader = None
        if self.page_io is not None:
            self.page_io.close()

    def _init_books(self, metrics, slo, journal, watchdog, scheme) -> None:
        """The JAX engine's books: the journal (new ids start past its
        highest), the always-on ledger book and census ring, and with a
        registry the engine metrics and span tracer (under tp the
        collective budget's series), with a policy the SLO tracker."""
        self._journal = journal
        self._suspending = False  # drain: retire without journaling
        self._watchdog = watchdog
        self._submitted = 0 if journal is None else journal.next_id
        self._book = LedgerBook()
        self._census = CensusRing(self.slots)
        self._ici_row_bytes = 0.0  # per-row collective bytes a step
        self._obs = self._spans = None
        if metrics is not None:
            from ..obs.spans import SpanTracer
            from ..obs.trace import EngineMetrics

            self._obs = EngineMetrics(metrics)
            if self._alloc is not None:
                self._obs.kv_pages_free.set(self._alloc.n_free)
                self._obs.bind_kv_pool(self.kv_quant, self.pool_bytes,
                                       self._alloc.n_pages + 1)
            self._spans = SpanTracer(on_drop=self._obs.spans_dropped.inc)
            if self.group.size > 1:
                from ..parallel.comm_stats import (tp_collective_budget,
                                                   tp_scheme)

                scheme = scheme or tp_scheme()
                self._obs.bind_collectives(
                    tp_collective_budget(self.spec, self.group.size, scheme),
                    scheme, rows=self.slots)
                self._ici_row_bytes = (self._obs.ici_bytes_per_step
                                       / max(self.slots, 1))
        if journal is not None and self._obs is not None:
            journal.bind_metrics(self._obs.journal_records)
        self._slo = None
        if slo is not None:
            from ..obs.slo import SLOTracker

            self._slo = SLOTracker(slo, metrics)

    # -- the device step ----------------------------------------------------

    def _forward(self) -> torch.Tensor:
        """The batch forward over the static rows: (slots, vocab) logits."""
        if self._alloc is not None:
            return self.model.forward_batch_paged(self.cache, self._tokens,
                                                  self._pos, self._table)
        return self.model.forward_batch_ragged(self.cache, self._tokens,
                                               self._pos)

    def _forward_into_logits(self) -> None:
        self._logits.copy_(self._forward())

    def _chain_step(self, c: _Chain, greedy_only: bool) -> None:
        """One step of the fused chain, in place on the static buffers:
        forward, sample (per-row parameters), force, record, then freeze
        rows that hit BOS or their budget (a frozen row rewrites the same
        k/v at its frozen position: identical values)."""
        logits = self._forward()
        col = c.index.expand(1, self.slots)
        forced = c.forced.gather(0, col)[0]
        if greedy_only:
            sampled = torch.argmax(logits, dim=-1)
        else:
            sampled = sample_device_dynamic(logits, c.coins.gather(0, col)[0],
                                            c.temps, c.topps)
        nxt = torch.where(forced >= 0, forced, sampled)
        c.toks.scatter_(0, col, nxt[None])
        c.acts.scatter_(0, col, c.active[None])
        pos = self._pos
        new_active = c.active & (nxt != BOS) & (pos + 1 < c.budget)
        pos.copy_(torch.where(new_active, pos + 1, pos))
        self._tokens.copy_(torch.where(new_active, nxt, self._tokens))
        c.active.copy_(new_active)
        c.index.add_(1)

    def _chain(self, k: int, greedy_only: bool) -> _Chain:
        key = (k, greedy_only)
        if key not in self._chains:
            c = _Chain(k, self.slots, self.device)
            if self.graph:
                c.graph = GraphStep(lambda: self._chain_step(c, greedy_only),
                                    self.device)
            self._chains[key] = c
        return self._chains[key]

    def _run_forward(self) -> np.ndarray:
        """step_once's forward: one replay (eager on the CPU or with
        graph=False); the host reads the logits."""
        if self.graph:
            if self._once is None:
                self._once = GraphStep(self._forward_into_logits, self.device)
            self._once.run(1)
        else:
            self._forward_into_logits()
        # dlint: allow[D001] host sampling: one read a dispatch
        return self._logits.cpu().numpy()

    def _window_step(self, kind: str, w: _Window) -> None:
        """One verify or mixed forward over the static rows, its ids
        (argmaxed on the device) or logits written into ``w.out``."""
        if kind == "verify":
            logits = self.model.forward_batch_spec_paged(
                self.cache, w.tokens, self._pos, self._table)
        else:
            logits = self.model.forward_batch_mixed_paged(
                self.cache, w.tokens, self._pos, self._span_rows,
                self._table)
        w.out.copy_(greedy_verify_tokens(logits) if w.greedy_only
                    else logits)

    def _run_window(self, kind: str, tokens: np.ndarray,
                    greedy_only: bool) -> np.ndarray:
        """Stage ``tokens`` (B, W) and run one window dispatch: one replay
        of its graph (eager on the CPU or with graph=False); the host
        reads (B, W) ids or (B, W, vocab) logits back once."""
        key = (kind, greedy_only)
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = _Window(
                tokens.shape[1], self.slots, self.spec.vocab_size,
                greedy_only, self.device)
            if self.graph:
                w.graph = GraphStep(lambda: self._window_step(kind, w),
                                    self.device)
        _load(w.tokens, tokens)
        with torch.inference_mode():
            if w.graph is not None:
                w.graph.run(1)
            else:
                self._window_step(kind, w)
        # dlint: allow[D001] the window's one read a dispatch
        return w.out.cpu().numpy()

    def capture_graphs(self) -> int:
        """Capture now every CUDA graph step_many replays under this
        engine's options (the forward of step_once, or the K-step chain,
        the verify window or the mixed window, each greedy and sampled),
        instead of lazily at the first dispatch of each shape. The server
        calls it on its scheduler thread before the listener opens, so no
        capture runs beside another thread's CUDA call. Every slot must be
        free: the warm-up steps run over parked rows (position 0, pages on
        the scrap page, the chain's rows inactive), whose writes are dead.
        Returns the number of graphs captured (0 without graphs)."""
        if not self.graph:
            return 0
        if any(not s.free for s in self._pool):
            raise RuntimeError("capture_graphs needs every slot free")
        n = 0
        self._tokens.zero_()
        self._pos.zero_()
        if self._alloc is not None:
            self._stage_tables()
        for greedy_only in (True, False):
            if self.dispatch_tokens or self.spec_k:
                kind = "mixed" if self.dispatch_tokens else "verify"
                if kind == "mixed":
                    self._span_rows.zero_()
                if (kind, greedy_only) not in self._windows:
                    self._run_window(kind, np.zeros(
                        (self.slots, self.dispatch_tokens or self.spec_k),
                        np.int64), greedy_only)
                    n += 1
            elif self.block_steps > 1:
                c = self._chain(self.block_steps, greedy_only)
                if c.graph._graph is None:
                    c.active.zero_()
                    c.index.zero_()
                    with torch.inference_mode():
                        c.graph.run(1)  # warm-up + capture, no replay
                    n += 1
            elif greedy_only and self._once is None:
                self._once = GraphStep(self._forward_into_logits, self.device)
                with torch.inference_mode():
                    self._once.run(1)
                n += 1
        return n

    # -- properties ---------------------------------------------------------

    def audit_pages(self) -> list[str]:
        """paging.PagedAllocator.audit over the live slot tables; [] on
        contiguous engines and clean pools."""
        if self._alloc is None:
            return []
        return self._alloc.audit([s.pages for s in self._pool])

    @property
    def allocator(self) -> PagedAllocator | None:
        """The paging.PagedAllocator when page_size > 0, else None."""
        return self._alloc

    @property
    def graph_replays(self) -> int:
        """Replays of every captured graph of this engine."""
        graphs = [c.graph for c in (*self._chains.values(),
                                    *self._windows.values())] + [self._once]
        return sum(g.replays for g in graphs if g is not None)

    @property
    def slo_tracker(self):
        """The obs/slo.SLOTracker when a policy was given, else None."""
        return self._slo

    @property
    def ledger_book(self) -> LedgerBook:
        """The obs/ledger.LedgerBook (always on)."""
        return self._book

    @property
    def sched_census(self) -> CensusRing:
        """The obs/ledger.CensusRing of per-dispatch records (always on)."""
        return self._census

    # -- the books ------------------------------------------------------------

    def _span(self, name: str, cat: str, **meta):
        """A timeline span when tracing is on, else a free nullcontext."""
        if self._spans is None:
            return contextlib.nullcontext()
        return self._spans.span(name, cat, **meta)

    def _watch(self):
        """The step watchdog armed around a dispatch, or a nullcontext."""
        if self._watchdog is None:
            return contextlib.nullcontext()
        return self._watchdog

    def _chaos_dispatch(self) -> None:
        """The chaos dispatch hook, inside the armed window and before the
        replay or launch: an injected stall is the hang the watchdog must
        detect, and it never falls between a capture's begin and end."""
        if self._chaos is not None:
            self._chaos.on_dispatch()

    def _dispatched(self, t0: float, n_active: int, steps: int = 1) -> None:
        """Inside a dispatch's armed window, after its host read: the
        step metrics (DLLAMA_METRICS_SYNC first synchronizes the device,
        so the time is the device's; obs/trace.sync_device_timing)."""
        if self._obs is None:
            return
        if self._obs.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._obs.record_step(time.monotonic() - t0, n_active, steps=steps)
        if self._alloc is not None:
            self._obs.kv_pages_free.set(self._alloc.n_free)

    def _journal_sync(self) -> None:
        """The step-boundary durability point: one fsync for the
        iteration's records (batch policy) and the compaction check."""
        if self._journal is None:
            return
        self._journal.sync()
        self._journal.maybe_compact()

    def _census_dispatch(self, kind: str, k: int, paused, active: int,
                         dt_s: float, deferred=()) -> None:
        """Charge both accounting halves from one pool walk after a
        dispatch (the JAX engine's): per-slot ledger charges (row steps,
        page steps, stalls by cause, pro-rated collective bytes) and the
        dispatch's census record. A paused row waits on a dry pool
        (``pool_dry``), a promotion (``promo_pending``) or its parked
        prefill (``prefill_hold``); a deferred row of a mixed dispatch on
        the budget (``budget_wait``); queued requests on the queue. The
        chaos ``double_count_dispatch`` mutation multiplies the ledger side
        only (``reps``), so the ledger-against-census sums must break."""
        reps = 2 if (self._chaos is not None
                     and self._chaos.dispatch_double()) else 1
        alloc = self._alloc
        dt_share = dt_s / max(active, 1)
        pages_held = 0
        parked: dict = {}
        class_page_s: dict = {}
        for b, s in enumerate(self._pool):
            if s.free:
                continue
            led = s.req.ledger
            npages = len(s.pages)
            if npages:
                pages_held += npages
                if led is not None:
                    led.charge_pages(npages, k, dt_s, reps)
                cls = self._bill_class(s.req.slo_class)
                class_page_s[cls] = class_page_s.get(cls, 0.0) + npages * dt_s
            if b in paused or b in deferred:
                # re-distinguish what _grow_pages lumped into one set:
                # promotion and prefill parks resolve by themselves,
                # pool_dry waits on a retirement
                if b not in paused:
                    cause = "budget_wait"
                elif s.await_promo or (
                        alloc is not None and alloc.pending_capable
                        and alloc.slot_pending(s.pages)):
                    cause = "promo_pending"
                elif s.prefill_pending:
                    cause = "prefill_hold"
                else:
                    cause = "pool_dry"
                parked[cause] = parked.get(cause, 0) + 1
                if led is not None:
                    led.charge_stall(cause, k, dt_s, reps)
            elif led is not None:
                led.charge_rows(k, dt_share, reps)
                if self._ici_row_bytes:
                    led.charge_ici(self._ici_row_bytes * k, reps)
        with self._lock:
            queued = list(self._queue)
        for req in queued:
            if req.ledger is not None:
                req.ledger.charge_stall("queue_wait", k, dt_s, reps)
        tier = (alloc.tier_page_counts()
                if alloc is not None and alloc.tiered else None)
        self._census.record(kind, k, active, parked, len(queued), pages_held,
                            tier_pages=tier)
        if self._obs is not None:
            for cause, n in parked.items():
                self._obs.add_stall_seconds(cause, n * dt_s)
            if queued:
                self._obs.add_stall_seconds("queue_wait", len(queued) * dt_s)
            for cls, page_s in class_page_s.items():
                self._obs.add_page_seconds(cls, page_s)
            self._obs.set_class_queue_depth(collections.Counter(
                self._bill_class(r.slo_class) for r in queued))

    def _close_ledger(self, rid: int, status: str) -> None:
        """Close a request's ledger at its terminal event and export the
        per-class cost histograms. The chaos ``leak_ledger`` mutation skips
        the close (the zero-open-ledgers-after-drain check must flag it)."""
        if self._chaos is not None and self._chaos.ledger_leak():
            return
        snap = self._book.close_request(rid, status)
        if snap is not None and self._obs is not None:
            self._obs.observe_request_cost(snap)

    def _bill_class(self, name: str | None) -> str:
        """The accounting class: None resolves through the SLO policy's
        default class; "default" only exists without a policy."""
        if self._slo is not None:
            return name or self._slo.policy.default_class
        return name or "default"

    def _trace_admit(self, req: Request) -> None:
        """Mint a root trace for a request that arrived without one, and
        record a zero-length link span where this life crossed a seam (a
        journal recovery)."""
        if req.trace is None:
            req.trace = tracectx.mint()
        if self._spans is not None and req.trace.link:
            self._spans.add(req.trace.link, "link", time.perf_counter(),
                            0.0, index=req.index,
                            **tracectx.span_fields(req.trace))

    def _journal_admit(self, req: Request) -> None:
        """The one admit-record append, with the RESOLVED sampler config
        (a restarted process would derive the default seed anew)."""
        self._journal.admit(
            req.index, req.tokens, steps=req.steps,
            temperature=(req.temperature if req.temperature is not None
                         else self.temperature),
            topp=req.topp if req.topp is not None else self.topp,
            seed=(req.seed if req.seed is not None
                  else self.seed + req.index),
            slo=req.slo_class, cursor=req.coin_cursor,
            recovers=req.recovered_from,
            trace=(req.trace.to_header() if req.trace is not None
                   else None),
            ledger=req.carried_cost)

    def prejournal(self, req: Request) -> Request:
        """Assign a request's index and journal its admit record now,
        durably, without queueing it; a later submit() only queues it. A
        caller that will never submit it retires the journaled life with
        abandon_prejournaled()."""
        if not req.tokens:
            raise ValueError("request has no prompt tokens")
        if self._journal is None:
            raise ValueError("prejournal() without a journal has no "
                             "durability to offer; call submit()")
        req.t_enqueue = time.monotonic()
        with self._lock:
            req.index = self._submitted
            self._submitted += 1
        if req.trace is None:
            req.trace = tracectx.mint()
        self._journal_admit(req)
        self._journal.sync(force=True)
        req.prejournaled = True
        return req

    def abandon_prejournaled(self, req: Request) -> None:
        """Retire a prejournaled life that will never be submitted."""
        if self._journal is not None and req.prejournaled:
            self._journal.retire(req.index, "cancelled")
            self._journal.sync(force=True)

    def recover(self, quiet: bool = True) -> int:
        """Re-admit every incomplete journaled request (the JAX engine's
        recover): each enters through submit() as a fresh request whose
        prompt is the original prompt plus the tokens its previous life
        sampled (they ride the forced window, or admission prefill, which
        re-derives their k/v), with the sampler skipped to the journaled
        coin cursor, so the continued stream is the uninterrupted one.
        Its admit record carries ``recovers=<old id>``: one append opens
        the new life and retires the old. A journal with live entries
        must match this engine's config (JournalConfigMismatch); one with
        none adopts it. Returns the number re-admitted."""
        journal = self._journal
        if journal is None:
            raise ValueError("recover() needs a journal (construct the "
                             "engine with journal=...): the atomic "
                             "old-life handoff must land in the journal "
                             "new records are written to")
        entries = journal.incomplete()
        if entries:
            journal.check_config()
        else:
            journal.adopt_config()
        for e in entries:
            trace = None
            if e.trace:
                try:
                    trace = tracectx.from_header(
                        e.trace, link=tracectx.LINK_RECOVERS)
                except ValueError:
                    trace = None  # a damaged header never blocks recovery
            req = Request(tokens=e.replay_tokens, steps=e.steps,
                          temperature=e.temperature, topp=e.topp,
                          seed=e.seed, slo_class=e.slo,
                          coin_cursor=e.cursor, recovered_from=e.rid,
                          trace=trace, carried_cost=e.ledger)
            self.submit(req)
            if self._obs is not None:
                self._obs.recoveries.inc()
            if not quiet:
                print(f"[recover] request {e.rid} -> {req.index}: "
                      f"{len(e.tokens)} prompt + {len(e.sampled)} sampled "
                      f"tokens, coin cursor {e.cursor}")
        journal.sync(force=True)
        return len(entries)

    def suspend(self, message: str = "draining: request journaled for "
                                     "recovery") -> int:
        """The drain's wrap-up: give up every outstanding request WITHOUT
        retiring it in the journal (its records stay live for the next
        process's recover()); waiters wake with ``error`` set. Returns the
        number left journaled."""
        if self._journal is None:
            raise ValueError("suspend() without a journal would drop "
                             "in-flight work on the floor; use fail_all")
        n = self._n_outstanding()
        self._suspending = True
        try:
            self.fail_all(message)
        finally:
            self._suspending = False
        self._journal.sync(force=True)
        return n

    # -- paged-KV bookkeeping -----------------------------------------------

    def _settle_promotions(self, quiet: bool = True) -> None:
        """Step-boundary promotion apply: launch every staged upload into
        its pool page (runtime/kv_io.PageIO.settle, in place), mark the
        ones whose copy landed, and release the slots that waited on them:
        their deferred admission prefill runs now (suffix-only, as for an
        HBM-resident prefix) and they dispatch on the next step. Scheduler
        thread only."""
        alloc = self._alloc
        if alloc is None or not alloc.pending_capable:
            return
        applied = self._io.settle(alloc)
        now = time.monotonic()
        for b, s in enumerate(self._pool):
            if s.free or not s.await_promo:
                continue
            if alloc.slot_pending(s.pages):
                continue  # still uploading: stays paused
            s.await_promo = False
            self.stats.promo_wait_s += now - s.t_promo
            self._maybe_prefill_slot(b, s)
            if s.req.cancelled:
                self._retire(s, quiet)
        if applied:
            self._update_tier_obs()

    def _update_tier_obs(self) -> None:
        """Push the allocator's tier ledger into the metrics (delta-tracked:
        counters only move forward; a reset_counters re-bases)."""
        if self._obs is None or self._alloc is None \
                or not self._alloc.tiered:
            return
        a = self._alloc
        for tier, gauge in self._obs.tier_pages.items():
            gauge.set(a.tier_pages.get(tier, 0))
        seen = self._tier_seen

        def push(key, got, counter):
            if got > seen[key]:
                counter.inc(got - seen[key])
            seen[key] = got

        push("prom", sum(a.promotions.values()), self._obs.tier_promotions)
        push("dem", sum(a.demotions.values()), self._obs.tier_demotions)
        for tier, counter in self._obs.tier_saved.items():
            push(tier, a.tokens_saved_by_tier.get(tier, 0), counter)

    def _ensure_pages(self, s: _Slot, n_positions: int) -> bool:
        """Grow a slot's page list to cover ``n_positions`` positions,
        evicting idle radix leaves when the free list is dry. False = the
        pool cannot cover it even after eviction."""
        need = self._alloc.pages_for(min(n_positions, self.spec.seq_len))
        while len(s.pages) < need:
            if self._chaos is not None and self._chaos.deny_page():
                return False  # injected transient starvation
            pid = self._alloc.alloc_page()
            if pid is None:
                return False
            s.pages.append(pid)
        return True

    def _grow_pages(self, pool, k: int, quiet: bool,
                    spans: dict | None = None) -> set:
        """Pre-chain page coverage: every active slot gets pages for its
        next ``k`` positions (``spans``, the mixed path's, gives each slot
        its own; a deferred row's 0 needs none), so no mid-chain write
        crosses into an unmapped page. A slot the pool cannot serve yet is
        PAUSED for this
        dispatch (returned in the set): it rides the step masked inactive,
        its dead rewrite lands on its own page or the scrap page, and its
        sampler draws nothing, so its stream is untouched. Only when EVERY
        active slot is starved (no retirement can ever free a page) does
        the youngest request fail. A slot waiting on a promotion or parked
        mid-prefill pauses too, without counting toward the deadlock."""
        while True:
            paused = set()
            promo = set()
            active = 0
            for b, s in enumerate(pool):
                if s.free:
                    continue
                active += 1
                if s.await_promo or s.prefill_pending or (
                        self._alloc.pending_capable
                        and self._alloc.slot_pending(s.pages)):
                    # waiting on a promotion upload, or a parked admission
                    # prefill (kept at its page-aligned park point): the
                    # slot pauses, but resolves by itself, so the deadlock
                    # breaker never sees it
                    promo.add(b)
                    continue
                need = k if spans is None else spans.get(b, 0)
                if not self._ensure_pages(s, min(s.pos + need, s.budget)):
                    paused.add(b)
            if promo or not paused or len(paused) < active:
                if paused or promo:
                    self.stats.pauses += len(paused) + len(promo)
                    if self._obs is not None:
                        self._obs.pauses.inc(len(paused) + len(promo))
                return paused | promo
            victim = max(paused, key=lambda b: pool[b].req.index)
            s = pool[victim]
            if self._obs is not None:
                self._obs.reject("deadlock")
            s.req.error = (
                f"kv page pool exhausted: {self._alloc.n_pages} pages of "
                f"{self.page_size} positions, all pinned by concurrent "
                f"requests (deadlock broken by failing the youngest)")
            self._retire(s, quiet)  # frees its pages; survivors retry

    def _stage_tables(self) -> None:
        """Rewrite the page-table staging block from the pool and copy it
        into the static device table (between replays, never inside a
        graph). Free slots and unmapped tail entries park on the scrap
        page."""
        tbl = self._stage_tbl
        for b, s in enumerate(self._pool):
            n = len(s.pages)
            tbl[b, :n] = s.pages
            tbl[b, n:] = SCRAP_PAGE
        _load(self._table, tbl)

    # -- scheduling ---------------------------------------------------------

    def step_many(self, k: int, quiet: bool = True) -> int:
        """Like ``k`` step_once calls in ONE fused chain: the captured chain
        step replayed k times, its (k, B) tokens and active flags read once,
        then applied with step_once's bookkeeping. Streams equal the
        per-step path's (greedy exactly; sampled while the device and host
        samplers agree at every CDF boundary); a slot freed mid-chain
        re-admits at the chain boundary. Returns active slots + queued
        requests. With ``dispatch_tokens`` every iteration is a mixed
        dispatch (step_mixed), with ``spec_k`` a verify dispatch
        (step_spec): both supersede chaining (chained verifies would
        stack drafts on unverified drafts)."""
        if self._leader is not None:  # rank 0 under tp: plan, then launch
            self._leader.dispatch_point(self, k)
        if self.dispatch_tokens:
            return self.step_mixed(quiet=quiet)
        if self.spec_k:
            return self.step_spec(quiet=quiet)
        if k <= 1:
            return self.step_once(quiet=quiet)
        self._drain_remote_inbox()
        self._sweep_cancelled()
        self._admit()
        self._settle_promotions(quiet)
        self._resume_prefills()
        pool = self._pool
        paused = (self._grow_pages(pool, k, quiet)
                  if self._alloc is not None else ())
        if all(s.free for s in pool):
            self._journal_sync()  # cover the sweep's and admission's records
            return self._n_outstanding()
        B = self.slots
        st_i32, st_f32 = self._stage_i32, self._stage_f32
        active0 = self._stage_active
        forced = np.full((k, B), -1, dtype=np.int64)
        coins = np.zeros((k, B), dtype=np.float32)
        for b, s in enumerate(pool):
            active0[b] = not s.free and b not in paused
            st_i32[0, b] = s.token
            st_i32[1, b] = s.pos
            st_i32[2, b] = 0 if s.free else s.budget
            st_f32[0, b] = 0.0 if s.free else s.sampler.temperature
            st_f32[1, b] = 0.9 if s.free else s.sampler.topp
            if s.free:
                continue
            for i, t in enumerate(s.forced[:k]):
                forced[i, b] = t
            if s.sampler.temperature != 0.0:
                # pre-draw on a throwaway copy; the real stream advances
                # in the replay below by exactly the coins the per-step
                # loop would draw (forced steps draw none)
                n_forced = min(len(s.forced), k)
                if n_forced < k:
                    coins[n_forced:, b] = s.sampler.rng.clone().f32_array(
                        k - n_forced)
        n_active0 = int(active0.sum())
        if self._alloc is not None:
            self._stage_tables()
        greedy_only = not st_f32[0].any()
        c = self._chain(k, greedy_only)
        _load(self._tokens, st_i32[0])
        _load(self._pos, st_i32[1])
        _load(c.budget, st_i32[2])
        _load(c.active, active0)
        _load(c.forced, forced)
        _load(c.coins, coins)
        _load(c.temps, st_f32[0])
        _load(c.topps, st_f32[1])
        c.index.zero_()
        t0 = time.monotonic()
        with self._span("chain", "decode", steps=k, active=n_active0), \
                self._watch():
            self._chaos_dispatch()
            with torch.inference_mode():
                if c.graph is not None:
                    c.graph.run(k)
                else:
                    for _ in range(k):
                        self._chain_step(c, greedy_only)
            # dlint: allow[D001] the chain's one read a dispatch
            toks = c.toks.cpu().numpy()
            # dlint: allow[D001] the same finished chain: no new wait
            acts = c.acts.cpu().numpy()
            self._dispatched(t0, n_active0, k)
        self.stats.steps += k
        self.stats.sum_active += n_active0 * k
        self.stats.max_active = max(self.stats.max_active, n_active0)
        self._census_dispatch("decode", k, paused, n_active0,
                              time.monotonic() - t0)
        for b, s in enumerate(pool):
            if s.free:
                continue
            if s.req.cancelled:
                self._retire(s, quiet)
                continue
            if not active0[b]:
                continue
            for i in range(k):
                if not acts[i, b]:
                    break
                sampled = not s.forced
                if s.forced:
                    s.forced.pop(0)
                elif s.sampler.temperature != 0.0:
                    s.sampler.rng.f32()  # the coin the chain consumed
                if self._advance(s, int(toks[i, b]), quiet, sampled=sampled):
                    break
        self._admit()
        self._journal_sync()
        return self._n_outstanding()

    def step_once(self, quiet: bool = True) -> int:
        """Admit queued requests, run ONE device step over the pool (the
        captured forward), sample on the host and retire finished rows.
        Returns active slots + queued requests (0 = idle)."""
        self._drain_remote_inbox()
        self._sweep_cancelled()
        self._admit()
        self._settle_promotions(quiet)
        self._resume_prefills()
        pool = self._pool
        paused = (self._grow_pages(pool, 1, quiet)
                  if self._alloc is not None else ())
        if all(s.free for s in pool):
            self._journal_sync()
            return self._n_outstanding()
        active0 = sum(not s.free and b not in paused
                      for b, s in enumerate(pool))
        st = self._stage_i32
        for b, s in enumerate(pool):
            st[0, b] = s.token
            st[1, b] = s.pos
        _load(self._tokens, st[0])
        _load(self._pos, st[1])
        if self._alloc is not None:
            self._stage_tables()
        t0 = time.monotonic()
        with self._span("step", "decode", active=active0), self._watch():
            self._chaos_dispatch()
            with torch.inference_mode():
                logits = self._run_forward()
            self._dispatched(t0, active0)
        self._count_dispatch(active0)
        self._census_dispatch("decode", 1, paused, active0,
                              time.monotonic() - t0)
        for i, s in enumerate(pool):
            if s.free:
                continue
            if s.req.cancelled:
                self._retire(s, quiet)
                continue
            if i in paused:  # starved of pages: frozen, retries next step
                continue
            if s.forced:
                self._advance(s, s.forced.pop(0), quiet)
            else:
                nxt = int(s.sampler.sample(logits[i]))
                self._advance(s, nxt, quiet, sampled=True)
        self._admit()
        self._journal_sync()
        return self._n_outstanding()

    def _count_dispatch(self, n_active: int) -> None:
        self.stats.steps += 1
        self.stats.sum_active += n_active
        self.stats.max_active = max(self.stats.max_active, n_active)

    def step_spec(self, quiet: bool = True) -> int:
        """One draft -> verify -> accept iteration over the pool (the JAX
        engine's step_spec). Each active row feeds [current token |
        window]: its pending forced prompt tokens first (they always
        match, so the dispatch doubles as K-wide prompt chunking), then up
        to K-1 n-gram drafts (speculative.draft_tokens) once the prompt is
        through. One verify dispatch scores every position; the host
        replays each row position by position with step_once's
        bookkeeping (forced pops, then argmax or the sampler, then
        _advance) and stops at the first position whose outcome differs
        from the fed input (later logits saw a wrong token). Greedy rows
        accept a draft that equals the argmax; sampled rows run
        speculative.accept_or_resample (an accept coin for each reached
        draft, a residual coin on rejection). Rows that did not retire
        roll their page table back to the accepted length (_trim_pages).
        Returns active slots + queued requests."""
        K = self.spec_k
        self._drain_remote_inbox()
        self._sweep_cancelled()
        self._admit()
        self._settle_promotions(quiet)
        self._resume_prefills()
        pool = self._pool
        paused = self._grow_pages(pool, K, quiet)
        if all(s.free for s in pool):
            self._journal_sync()
            return self._n_outstanding()
        st = self._stage_win
        st_pos = self._stage_i32[1]
        active0 = self._stage_active
        kinds: list = [()] * self.slots  # window entry i (input i + 1):
        #                                   'f' forced or 'd' drafted
        greedy_only = True
        for b, s in enumerate(pool):
            active0[b] = not s.free and b not in paused
            st[b, 0] = s.token
            st[b, 1:] = 0
            st_pos[b] = s.pos
            if not active0[b]:
                continue
            if s.sampler.temperature != 0.0:
                greedy_only = False
            window = list(s.forced[:K - 1])
            row_kinds = ["f"] * len(window)
            room = K - 1 - len(window)
            if room > 0 and not s.forced[K - 1:]:
                # the lookup history: the emitted stream plus the forced
                # tokens fed ahead of the drafts in this window
                history = [s.req.tokens[0]] + s.req.out + window
                drafts = draft_tokens(history, room, max_n=self.spec_ngram)
                self.stats.spec_proposed += len(drafts)
                if drafts:
                    self._census.count_tokens("spec", len(drafts))
                    if s.req.ledger is not None:
                        s.req.ledger.charge_spec(len(drafts), 0)
                if self._obs is not None:
                    self._obs.spec_proposed.inc(len(drafts))
                    if drafts:
                        self._obs.count_dispatch_tokens("spec", len(drafts))
                window += [int(t) for t in drafts]
                row_kinds += ["d"] * len(drafts)
            st[b, 1:1 + len(window)] = window
            kinds[b] = tuple(row_kinds)
        _load(self._pos, st_pos)
        self._stage_tables()
        n_active0 = int(active0.sum())
        t0 = time.monotonic()
        with self._span("verify", "decode", k=K, active=n_active0), \
                self._watch():
            self._chaos_dispatch()
            out = self._run_window("verify", st, greedy_only)
            self._dispatched(t0, n_active0)
        self._count_dispatch(n_active0)
        self._census_dispatch("spec", 1, paused, n_active0,
                              time.monotonic() - t0)
        vocab = self.spec.vocab_size
        for b, s in enumerate(pool):
            if s.free:
                continue
            if s.req.cancelled:
                self._retire(s, quiet)
                continue
            if not active0[b]:
                continue
            row_kinds = kinds[b]
            retired = False
            for i in range(K):
                accepted = False
                drafted = i < len(row_kinds) and row_kinds[i] == "d"
                if s.forced:
                    nxt, sampled = s.forced.pop(0), False
                elif s.sampler.temperature == 0.0:
                    nxt = (int(out[b, i]) if greedy_only
                           else int(np.argmax(out[b, i][:vocab])))
                    sampled = True
                    accepted = drafted and nxt == int(st[b, i + 1])
                elif drafted:
                    nxt, accepted = accept_or_resample(
                        out[b, i], int(st[b, i + 1]), s.sampler)
                    sampled = True
                else:  # no draft fed here: the plain sampler
                    nxt, sampled = int(s.sampler.sample(out[b, i])), True
                if accepted:
                    self.stats.spec_accepted += 1
                    if s.req.ledger is not None:
                        s.req.ledger.charge_spec(0, 1)
                    if self._obs is not None:
                        self._obs.spec_accepted.inc()
                if self._advance(s, nxt, quiet, sampled=sampled):
                    retired = True
                    break
                if (i + 1 >= K or i >= len(row_kinds)
                        or nxt != int(st[b, i + 1])):
                    break  # window spent, or the fed input was wrong
            if not retired:
                self._trim_pages(s)
        self._admit()
        self._journal_sync()
        return self._n_outstanding()

    def _trim_pages(self, s: _Slot) -> None:
        """Speculative rollback: positions >= s.pos may hold rejected
        drafts' k/v and position s.pos is rewritten by the next dispatch
        before anything reads it, so pages covering only positions >=
        s.pos go back to the pool (a page the radix tree also holds just
        loses this slot's reference). The shared prefix always stays:
        s.pos never falls below the share boundary."""
        keep = max(self._alloc.pages_for(s.pos), s.shared)
        if len(s.pages) > keep:
            self._alloc.release_pages(s.pages[keep:])
            del s.pages[keep:]
            if self._obs is not None:
                self._obs.kv_pages_free.set(self._alloc.n_free)

    def step_mixed(self, quiet: bool = True) -> int:
        """One token-budget mixed dispatch (the JAX engine's step_mixed):
        every active row takes its one pending token, and ONE row with
        forced prompt tokens left (the best SLO rank under
        ``slo_priority``, then the lowest request index) takes up to the
        rest of the budget, all in one (slots, T) forward. With more active
        rows than T, the overflow rides deferred (span 0) under a rotating
        cursor. The host replay is step_once's per position (forced pops,
        then argmax or the sampler at the last position, then _advance),
        so the streams are the separate-dispatch engine's. Returns active
        slots + queued requests."""
        T = self.dispatch_tokens
        self._drain_remote_inbox()
        self._sweep_cancelled()
        self._admit()
        self._settle_promotions(quiet)
        pool = self._pool
        candidates = [b for b, s in enumerate(pool) if not s.free]
        spans: dict[int, int] = {}
        deferred: set = set()
        if len(candidates) > T:
            order = sorted(candidates,
                           key=lambda b: (b - self._mixed_rr) % self.slots)
            deferred = set(order[T:])
            self._mixed_rr = (self._mixed_rr + T) % self.slots
            spans = dict.fromkeys(order[:T], 1)
        else:
            spans = dict.fromkeys(candidates, 1)
            room = T - len(candidates)
            slice_rows = [b for b in candidates if pool[b].forced]
            if room > 0 and slice_rows:
                # the best SLO rank wins the slice (FIFO within a class)
                rank = self._prio or (lambda cls: 0)
                win = min(slice_rows,
                          key=lambda b: (rank(pool[b].req.slo_class),
                                         pool[b].req.index))
                extra = min(len(pool[win].forced), room)
                if self._chaos is not None and self._chaos.budget_overrun():
                    # mutation arm: the slice ignores the remaining budget
                    # and takes the whole staging width
                    extra = min(len(pool[win].forced), T - 1)
                spans[win] = 1 + extra
        paused = self._grow_pages(pool, 1, quiet, spans=spans)
        if all(s.free for s in pool):
            self._journal_sync()
            return self._n_outstanding()
        blk = self._stage_win
        st_i32 = self._stage_i32
        greedy_only = True
        for b, s in enumerate(pool):
            span = 0 if (s.free or b in paused or b in deferred) \
                else spans.get(b, 0)
            spans[b] = span
            st_i32[0, b] = span
            st_i32[1, b] = s.pos
            blk[b] = 0
            if span <= 0:
                continue
            if s.sampler.temperature != 0.0:
                greedy_only = False
            blk[b, 0] = s.token
            blk[b, 1:span] = s.forced[:span - 1]
        total_span = sum(spans.values())
        self.stats.overrun_steps += max(0, -(-total_span // T) - 1)
        _load(self._span_rows, st_i32[0])
        _load(self._pos, st_i32[1])
        self._stage_tables()
        n_active0 = sum(1 for v in spans.values() if v > 0)
        t0 = time.monotonic()
        with self._span("mixed", "decode", budget=T, tokens=total_span,
                        active=n_active0), self._watch():
            self._chaos_dispatch()
            out = self._run_window("mixed", blk, greedy_only)
            self._dispatched(t0, n_active0)
        self._count_dispatch(n_active0)
        self._census_dispatch("mixed", 1, paused, n_active0,
                              time.monotonic() - t0, deferred=deferred)
        for b, s in enumerate(pool):
            if s.free:
                continue
            if s.req.cancelled:
                self._retire(s, quiet)
                continue
            for i in range(spans.get(b, 0)):
                if s.forced:
                    nxt, sampled = s.forced.pop(0), False
                elif greedy_only:
                    nxt, sampled = int(out[b, i]), True
                else:
                    nxt, sampled = int(s.sampler.sample(out[b, i])), True
                if self._advance(s, nxt, quiet, sampled=sampled):
                    break
        self._admit()
        self._journal_sync()
        return self._n_outstanding()

    def _advance(self, s: _Slot, nxt: int, quiet: bool,
                 sampled: bool = False) -> bool:
        """Apply one decode outcome to a slot (clock, BOS stop, output,
        budget stop), shared by step_once and step_many's replay. Returns
        True when the slot retired."""
        s.pos += 1
        if sampled:
            s.req.n_sampled += 1
            if not s.req.t_first_token:
                s.req.t_first_token = time.monotonic()
        if nxt == BOS:  # reference stop: BOS before decoding it
            self._retire(s, quiet)
            return True
        s.req.out.append(nxt)
        if sampled and self._journal is not None:
            # sampled tokens only (forced echoes re-derive from the admit
            # record), with the cumulative coin cursor: the sampler drew
            # this token's coins before _advance ran
            self._journal.token(s.req.index, nxt, s.sampler.rng.draws)
        self._notify(s.req, nxt)
        self.stats.tokens += 1
        self._census.count_tokens("decode")
        if s.req.ledger is not None:
            s.req.ledger.charge_tokens()
        if self._obs is not None:
            self._obs.generated.inc()
            self._obs.count_dispatch_tokens("decode")
        s.token = nxt
        if s.pos >= s.budget:
            self._retire(s, quiet)
            return True
        return False

    def _sweep_cancelled(self) -> None:
        """Retire every cancelled in-flight request before the dispatch."""
        for s in self._pool:
            if not s.free and s.req.cancelled:
                self._retire(s, quiet=True)

    def _n_outstanding(self) -> int:
        """Active slots + queued requests (a handoff still in the inbox
        counts: its request is not queued yet)."""
        with self._lock:
            queued = (len(self._queue) + len(self._remote_inbox)
                      + len(self._intake))
        return sum(not s.free for s in self._pool) + queued

    # -- serving over tp ranks (runtime/tp_plan.py) --------------------------

    def bind_plan(self, leader) -> None:
        """Make this engine rank 0 of a served tp group: handler-thread
        submissions and cancellations wait in the intake, and every
        step_many first sends them to the other ranks as a plan
        (tp_plan.PlanLeader.dispatch_point), then applies them."""
        if self.group.size <= 1:
            raise ValueError("bind_plan needs a tp group (mesh of size > 1)")
        self._leader = leader

    def has_work(self) -> bool:
        """True when a dispatch has something to do: active slots, queued
        or intake requests, cancellations, handoffs or exports."""
        with self._lock:
            waiting = (self._queue or self._intake or self._cancels
                       or self._remote_inbox or self._export_inbox)
        return bool(waiting) or any(not s.free for s in self._pool)

    def apply_plan(self, intake: list, cancels: list, remote: list,
                   exports: list) -> None:
        """One plan's inputs, applied in the same order on every rank:
        admissions queued (a follower registers its mirrored requests
        first; rank 0 registered them before its plan went out), shipped
        pages adopted and their requests queued, cancellations, then page exports
        gathered across the tp ranks (rank 0 answers the waiting
        handler)."""
        follower = self._leader is None
        for req in intake:
            if follower:
                self._register(req)
            self._enqueue(req)
        for tokens, planes, req in remote:
            self.adopt_remote(tokens, planes)
            if follower:
                self._register(req)
            self._enqueue(req)
        for req in cancels:
            self._cancel_now(req)
        if exports:
            from .disagg import export_prefix_pages
            from ..parallel.tp import gather_page_planes

            q8 = self.kv_quant == "q8"
            for tokens, box in exports:
                try:
                    planes = [gather_page_planes(p, self.group, q8)
                              for p in export_prefix_pages(self, tokens)]
                    if box is not None:
                        box["planes"] = planes
                finally:
                    if box is not None:
                        box["ev"].set()

    def ingest_remote(self, tokens, planes, req: Request) -> None:
        """Thread-safe handoff intake (decode pool): queue shipped page
        payloads and the re-admission request for the scheduler thread to
        adopt at its next iteration. ``planes`` are the CRC-verified plane
        tuples in full-prompt-page window order (a None entry marks a page
        that never arrived: adoption stops at the gap)."""
        if self._alloc is None or not self._alloc.remote:
            raise ValueError("ingest_remote needs a remote_pages=True "
                             "paged engine (the decode pool role)")
        with self._lock:
            self._remote_inbox.append((tokens, planes, req))

    def export_prefix_sync(self, tokens, timeout: float = 30.0) -> list:
        """Thread-safe page export (prefill pool): ask the scheduler thread
        for the wire payloads of the tree-held full prompt pages of
        ``tokens`` and wait for them ([] when nothing is held, or the
        scheduler did not answer within ``timeout``: the handoff then
        ships nothing and the decode pool prefills)."""
        box = {"ev": threading.Event(), "planes": None}
        with self._lock:
            self._export_inbox.append((list(tokens), box))
        box["ev"].wait(timeout)
        return box["planes"] or []

    def _drain_remote_inbox(self) -> None:
        """Scheduler-thread half of ingest_remote/export_prefix_sync: adopt
        shipped pages into the radix tree (promotion-pending) and submit
        their requests, so admission finds the prefix published; answer
        pending page exports from the tree. Under a PlanLeader only the
        plan point drains them (the followers adopt and gather with rank
        0), so this returns at once."""
        if self._leader is not None:
            return
        with self._lock:
            if not (self._remote_inbox or self._export_inbox):
                return
            items, self._remote_inbox = self._remote_inbox, []
            exports, self._export_inbox = self._export_inbox, []
        for tokens, planes, req in items:
            self.adopt_remote(tokens, planes)
            self.submit(req)
        if exports:
            from .disagg import export_prefix_pages

            for tokens, box in exports:
                try:
                    box["planes"] = export_prefix_pages(self, tokens)
                finally:
                    box["ev"].set()

    def adopt_remote(self, tokens, planes) -> list:
        """Adopt shipped pages (scheduler thread): under tp each rank keeps
        its band of a full-width payload (parallel/tp.stage_page_planes).
        Returns the adopted nodes."""
        if self.group.size > 1:
            from ..parallel.tp import stage_page_planes

            q8 = self.kv_quant == "q8"
            planes = [None if p is None else
                      stage_page_planes(p, self.group, self.spec, q8)
                      for p in planes]
        return self._alloc.adopt_remote_pages(tokens, planes)

    def _pop_request(self) -> Request | None:
        """Next live queued request (FIFO, or with ``slo_priority`` the
        best-ranked class first, FIFO within a class; requests cancelled
        before admission are completed and skipped), or None."""
        while True:
            with self._lock:
                if not self._queue:
                    return None
                at = 0
                if self._prio is not None and len(self._queue) > 1:
                    rank = self._prio
                    at = min(range(len(self._queue)),
                             key=lambda i: (rank(self._queue[i].slo_class),
                                            i))
                req = self._queue.pop(at)
                if self._obs is not None:
                    self._obs.set_queue_depth(len(self._queue))
            if not req.cancelled:
                return req
            if self._journal is not None:
                self._journal.retire(req.index, "cancelled")
            self._close_ledger(req.index, "cancelled")
            req.done.set()

    def _requeue_front(self, s: _Slot) -> None:
        """Undo an admission the page pool could not serve: release the
        slot's pages, free it, and put the request back at the HEAD of the
        queue (later, smaller requests do not jump a starved one)."""
        req = s.req
        self._alloc.release_pages(s.pages)
        s.pages, s.shared, s.await_promo = [], 0, False
        s.prefill_pending = False
        s.req, s.pos, s.token, s.forced, s.sampler = None, 0, 0, [], None
        req.t_admit = 0.0
        self.stats.requeues += 1
        if self._obs is not None:
            self._obs.reject("pool_dry")
        with self._lock:
            self._queue.insert(0, req)
            if self._obs is not None:
                self._obs.set_queue_depth(len(self._queue))

    def _admit_paged(self, s: _Slot) -> str:
        """Paged admission: map the longest shared page-aligned prompt
        prefix from the radix tree (the SAME physical pages, refcounted),
        then allocate fresh pages for the rest of the prompt. A shared
        prefix of m positions parks the row at pos m with the prefill
        path's echo bookkeeping. Returns 'ok' or 'dry' (requeue)."""
        req = s.req
        tokens = req.tokens
        # the pool bounds a request's positions as seq_len does
        s.budget = min(s.budget, self._alloc.n_pages * self.page_size)
        n_pre = len(tokens) - 1
        attempted = (self._alloc.prefix_share and n_pre >= 2
                     and n_pre < s.budget and BOS not in tokens[1:])
        if attempted:
            s.pages = self._alloc.match_prefix(tokens[:n_pre])
            s.shared = len(s.pages)
        if not self._ensure_pages(s, min(len(tokens), s.budget)):
            return "dry"
        if attempted:
            # counted only once the admission sticks
            self._alloc.record_admission(s.shared)
        m = s.shared * self.page_size
        if m:
            s.pos = m
            s.token = tokens[m]
            s.forced = list(tokens[m + 1:])
            req.out.extend(tokens[1:m + 1])
            for t in tokens[1:m + 1]:
                self._notify(req, t)
            self.stats.tokens += m
            # the shared-prefix echo is prefill-kind work the radix tree
            # covered instead of a forward pass
            self._census.count_tokens("prefill", m)
            if req.ledger is not None:
                req.ledger.charge_tokens(m)
                req.ledger.charge_prefill(0, m, 0.0)
            if self._obs is not None:
                self._obs.generated.inc(m)
                self._obs.prefix_hits.inc()
                self._obs.prefill_saved.inc(m)
                self._obs.count_dispatch_tokens("prefill", m)
        return "ok"

    def _admit(self) -> None:
        spec = self.spec
        for slot_index, s in enumerate(self._pool):
            while s.free:
                req = self._pop_request()
                if req is None:
                    return
                req.t_admit = time.monotonic()
                s.req, s.pos = req, 0
                s.token = req.tokens[0]
                s.forced = list(req.tokens[1:])
                s.budget = min(req.steps, spec.seq_len)
                temp = (req.temperature if req.temperature is not None
                        else self.temperature)
                topp = req.topp if req.topp is not None else self.topp
                seed = (req.seed if req.seed is not None
                        else self.seed + req.index)
                s.sampler = Sampler(spec.vocab_size, temp, topp, seed)
                if req.coin_cursor:
                    # journal recovery: skip the coins the first life drew
                    # (its sampled tokens ride the forced window, drawing
                    # none), so the next sample takes the coin the
                    # uninterrupted run would have
                    s.sampler.rng.skip(req.coin_cursor)
                if self._alloc is not None:
                    if self._admit_paged(s) == "dry":
                        self._requeue_front(s)
                        return
                    if self._alloc.pending_capable \
                            and self._alloc.slot_pending(s.pages):
                        # the shared prefix is being promoted (or is a
                        # shipped page still uploading): admission prefill
                        # waits until it lands (_settle_promotions)
                        s.await_promo = True
                        s.t_promo = time.monotonic()
                        self.stats.promo_waits += 1
                        break
                self._maybe_prefill_slot(slot_index, s)
                if s.req.cancelled:
                    self._retire(s, quiet=True)
                    continue
                break  # slot filled

    def _maybe_prefill_slot(self, slot_index: int, s: _Slot) -> None:
        """Admission prefill: fill the slot's cache rows for the prompt
        prefix in T=chunk single-sequence passes (Engine.prefill's
        schedule) and park the slot at the last prompt token. Paged: the
        slot's pages are gathered into a scratch sequence cache (a suffix
        attends over the shared prefix), prefilled from the share boundary,
        and scattered back in place; Q8 pools park shared entries of the
        scatter on the scrap page. Contiguous: a fresh scratch cache is
        prefilled and copied into the slot's row in place. Same gates as
        generate._prefill_prefix: off for short prompts, prompts past the
        budget, or a BOS inside the prompt; off under ``dispatch_tokens``,
        where the prompt rides the mixed dispatches as their slice.

        With ``prefill_hold`` (paged f32 pools) the chunks run one at a
        time and the prefill PARKS at a page-aligned chunk boundary where
        the hold fires (``s.prefill_pending``); _resume_prefills continues
        it later. A Q8 pool never parks: a resumed prompt would attend over
        dequantized earlier positions where the single pass attends f32."""
        chunk = self.prefill_chunk
        tokens = s.req.tokens
        n_pre = len(tokens) - 1
        start = s.pos  # 0, the prefix-share boundary or a park point
        if (self.dispatch_tokens or chunk <= 1 or n_pre - start < 2
                or n_pre >= s.budget or BOS in tokens[1:]):
            s.prefill_pending = False
            return
        paged = self._alloc is not None
        q8 = self.kv_quant == "q8"
        hold = self.prefill_hold if paged and not q8 else None
        end = n_pre
        t0 = time.monotonic()
        chunks0 = self.stats.prefill_chunks
        with self._span("prefill", "prefill", slot=slot_index,
                        tokens=n_pre - start,
                        **tracectx.span_fields(s.req.trace)), \
                torch.inference_mode():
            if paged:
                tbl = np.full((self._max_pages,), SCRAP_PAGE, np.int32)
                tbl[:len(s.pages)] = s.pages
                # dlint: allow[D001] the slot's pages: one upload an admit
                tbl_dev = torch.from_numpy(tbl).to(self.device)
                scratch = (gather_pages_q8 if q8 else gather_pages)(
                    self.cache, tbl_dev, self.page_size)
            else:
                scratch = init_cache(self.model.spec, self.device,
                                     self._cache_dtype)

            def fwd(part, start_pos):
                self.stats.prefill_chunks += 1
                self.model(scratch, part, start_pos, logits=False,
                           route=self._prefill_route)

            # the fixed window schedule a chunk at a time, yielding at
            # page-aligned chunk boundaries where the hold fires
            lo = start
            while lo < n_pre:
                hi = min(lo + chunk, n_pre)
                run_chunked_prefill(fwd, tokens[lo:hi], lo, chunk,
                                    self.spec.seq_len)
                lo = hi
                if (hold is not None and lo < n_pre
                        and lo % self.page_size == 0 and hold(s)):
                    end = lo
                    break
            if paged:
                if q8:
                    # re-quantizing moves bytes: a shared page keeps its
                    # first publisher's encoding, and a resumed prefill the
                    # pages its earlier rounds wrote
                    tbl_sc = tbl.copy()
                    tbl_sc[:max(s.shared, start // self.page_size)] = \
                        SCRAP_PAGE
                    scatter_pages_q8(self.cache, scratch,
                                     torch.from_numpy(tbl_sc).to(self.device),
                                     self.page_size)
                else:
                    scatter_pages(self.cache, scratch, tbl_dev,
                                  self.page_size)
                # publish the prefilled full prompt pages now: a request
                # admitted into the next slot this round already shares them
                self._alloc.insert_prefix(tokens[:end], s.pages)
            else:
                self.cache.k[:, slot_index].copy_(scratch.k)
                self.cache.v[:, slot_index].copy_(scratch.v)
        # echo the prefilled prompt tokens into the output and the count
        s.req.out.extend(tokens[start + 1:end + 1])
        for t in tokens[start + 1:end + 1]:
            self._notify(s.req, t)
        self.stats.tokens += end - start
        dt_prefill = time.monotonic() - t0
        # steps=0: the census documents the dispatch's token composition
        # and leaves the step, stall and page-step totals alone
        self._census.count_tokens("prefill", end - start)
        self._census.record("prefill", 0, 0, {}, 0, 0,
                            prefill_tokens=end - start)
        if s.req.ledger is not None:
            s.req.ledger.charge_tokens(end - start)
            s.req.ledger.charge_prefill(
                self.stats.prefill_chunks - chunks0, end - start,
                dt_prefill)
        if self._obs is not None:
            self._obs.generated.inc(end - start)
            self._obs.prefill.observe(dt_prefill)
            self._obs.count_dispatch_tokens("prefill", end - start)
        s.pos = end
        s.token = tokens[end]
        s.forced = list(tokens[end + 1:]) if end < n_pre else []
        s.prefill_pending = end < n_pre

    def _resume_prefills(self) -> None:
        """Continue chunk-preempted admission prefills: every slot parked
        at a page-aligned boundary re-enters _maybe_prefill_slot, which may
        park it again while the hold still fires."""
        for b, s in enumerate(self._pool):
            if s.free or not s.prefill_pending or s.await_promo \
                    or s.req.cancelled:
                continue
            self._maybe_prefill_slot(b, s)

    @staticmethod
    def _notify(req: Request, token: int) -> None:
        """Streaming hook dispatch; a consumer that raises is dropped."""
        if req.on_token is not None:
            try:
                req.on_token(token)
            except Exception:
                req.on_token = None

    def _retire(self, s: _Slot, quiet: bool) -> None:
        if not quiet:
            print(f"[{s.req.index}] done: {len(s.req.out)} tokens "
                  f"(pos {s.pos}/{s.budget})")
        if self._alloc is not None and s.pages:
            # publish the FULL prompt pages (positions 0..pos-1 hold prompt
            # k/v up to min(pos, prompt)); failed or cancelled requests
            # publish nothing. Then drop this slot's refs.
            if s.req.error is None and not s.req.cancelled:
                n_ins = min(s.pos, len(s.req.tokens))
                self._alloc.insert_prefix(s.req.tokens[:n_ins], s.pages)
            elif self._chaos is not None and s.req.cancelled:
                # mutation arm (leak_on_cancel): drop a page from the
                # release so the drill's audit must flag it
                s.pages = self._chaos.filter_release(s.pages)
            self._alloc.release_pages(s.pages)
            s.pages, s.shared, s.await_promo = [], 0, False
            if self._obs is not None:
                self._obs.kv_pages_free.set(self._alloc.n_free)
                self._update_tier_obs()
        s.prefill_pending = False
        req = s.req
        req.t_finish = time.monotonic()
        status = ("cancelled" if req.cancelled
                  else "failed" if req.error is not None else "done")
        if self._journal is not None and not self._suspending:
            # a drain-suspended request writes no retirement: its records
            # stay live for the next process's recover()
            self._journal.retire(req.index, status)
        if self._obs is not None:
            self._obs.record_retire(req, req.t_finish)
        if self._slo is not None:
            self._slo.observe_request(req, req.t_finish)
        if self._spans is not None and req.t_admit:
            # lifecycle stamps are time.monotonic: re-anchor the
            # admit->finish window on the tracer's perf_counter timeline
            dur = req.t_finish - req.t_admit
            start = time.perf_counter() - (time.monotonic() - req.t_admit)
            self._spans.add("request", "request", start, dur,
                            index=req.index, tokens=len(req.out),
                            sampled=req.n_sampled, cancelled=req.cancelled,
                            **tracectx.span_fields(req.trace))
        self._close_ledger(req.index, status)
        req.done.set()
        s.req = None
        # park the freed slot at pos 0 (its table row on the scrap page):
        # its dead writes land there until it is re-admitted
        s.pos, s.token = 0, 0

    # -- entry points -------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Queue a request (thread-safe: handler threads call it while the
        scheduler steps). Opens its ledger, mints its trace if it has
        none, and with a journal appends its admit record BEFORE the
        queue insert (write-ahead: the scheduler never samples for an id
        the journal has not admitted). ``req.done`` fires when it
        retires."""
        self._register(req)
        with self._lock:
            if self._leader is not None:
                self._intake.append(req)  # the next plan carries it
                return req
        self._enqueue(req)
        return req

    def _register(self, req: Request) -> None:
        """submit's books: the id, the ledger, the trace and the journal's
        admit record."""
        if not req.tokens:
            raise ValueError("request has no prompt tokens")
        if not req.prejournaled:
            req.t_enqueue = time.monotonic()
            with self._lock:
                req.index = self._submitted
                self._submitted += 1
        if req.ledger is None or not req.prejournaled:
            req.ledger = self._book.open_request(
                req.index, self._bill_class(req.slo_class),
                carried=req.carried_cost)
        self._trace_admit(req)
        if self._journal is not None and not req.prejournaled:
            self._journal_admit(req)

    def _enqueue(self, req: Request) -> None:
        with self._lock:
            self._queue.append(req)
            if self._obs is not None:
                self._obs.set_queue_depth(len(self._queue))

    def cancel(self, req: Request) -> None:
        """Cancel a request from any thread: a queued one completes now,
        an in-flight one retires (freeing its slot and pages) before the
        next dispatch. Under a PlanLeader the cancellation waits for the
        next plan, which every rank applies at the same point."""
        req.on_token = None
        if self._leader is not None:
            with self._lock:
                self._cancels.append(req)
            return
        self._cancel_now(req)

    def _cancel_now(self, req: Request) -> None:
        req.on_token = None
        req.cancelled = True
        with self._lock:
            if req not in self._queue:
                return  # in flight (or done): the sweep owns it
            self._queue.remove(req)
            if self._obs is not None:
                self._obs.set_queue_depth(len(self._queue))
        if self._journal is not None:
            self._journal.retire(req.index, "cancelled")
        if self._obs is not None:
            self._obs.cancelled.inc()
        self._close_ledger(req.index, "cancelled")
        req.done.set()

    def fail_all(self, message: str) -> None:
        """Fail every queued and in-flight request: ``error`` then
        ``done``; the radix tree is torn down with them."""
        with self._lock:
            pending, self._queue = self._queue + self._intake, []
            self._intake, self._cancels = [], []
            if self._obs is not None:
                self._obs.set_queue_depth(0)
        for req in pending:
            req.error = message
            if self._journal is not None and not self._suspending:
                self._journal.retire(req.index, "failed")
            if self._obs is not None:
                self._obs.failed.inc()
            if self._slo is not None:
                # never admitted, but attempted: a failed attempt
                self._slo.observe(req.slo_class, None, None, 0,
                                  failed=True)
            self._close_ledger(req.index, "failed")
            req.done.set()
        for s in self._pool:
            if not s.free:
                s.req.error = message
                self._retire(s, quiet=True)
        if self._alloc is not None:
            self._alloc.tree.clear()
            if self._obs is not None:
                self._obs.kv_pages_free.set(self._alloc.n_free)

    def run(self, requests: list[list[int]], steps: int,
            quiet: bool = True) -> tuple[list[list[int]], ContinuousStats]:
        """Offline entry: decode every request (a non-empty prompt token
        list, BOS included) to BOS or ``steps`` positions; returns the
        outputs in request order. Request i samples from seed + i on every
        run, so a re-used engine repeats its streams."""
        for i, r in enumerate(requests):
            if not r:
                raise ValueError(f"request {i} has no prompt tokens")
        self.stats = ContinuousStats()
        with self._lock:
            # request i samples from seed + i on every run; with a journal
            # the ids keep counting, as new records must not alias old ones
            if self._journal is None:
                self._submitted = 0
        reqs = [self.submit(Request(tokens=list(r), steps=steps))
                for r in requests]
        t0 = time.perf_counter()
        while self.step_many(self.block_steps, quiet=quiet):
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.total_ms = (time.perf_counter() - t0) * 1000
        assert all(r.done.is_set() for r in reqs)
        return [r.out for r in reqs], self.stats


def decode_stream(tokenizer, first_token: int, tokens: list[int]) -> str:
    """A generated token stream as text, chaining decode_piece's
    previous-token context from the prompt's first token."""
    prev, text = first_token, b""
    for t in tokens:
        text += tokenizer.decode_piece(prev, t)
        prev = t
    return text.decode("utf-8", errors="replace")


def generate_continuous(spec: TransformerSpec, params: dict[str, Any],
                        tokenizer, prompts: list[str], steps: int,
                        temperature: float, topp: float, seed: int,
                        slots: int = 0,
                        cache_dtype: torch.dtype = torch.float32,
                        prefill_chunk: int = 0, block_steps: int = 1,
                        quiet: bool = False, fast_prefill: bool = False,
                        page_size: int = 0, kv_pages: int = 0,
                        kv_quant: str | None = None, device="cuda",
                        graph: bool | None = None, mesh=None,
                        scheme: str | None = None, spec_k: int = 0,
                        spec_ngram: int = 3, dispatch_tokens: int = 0,
                        metrics=None, kv_host_pages: int = 0,
                        kv_disk_dir: str | None = None,
                        kv_disk_bytes: int = 0):
    """CLI entry (``--prompts-file --continuous``): encode the prompts,
    stream them through a pool of ``slots`` (0 = min(#prompts, 8)) and
    print the rows ("[i] 'text'") and the JAX CLI's stats lines (the KV
    tiers' line too, with ``kv_host_pages`` or ``kv_disk_dir``)."""
    reqs = [tokenizer.encode(p or "", bos=True, eos=False) for p in prompts]
    slots = slots or min(len(reqs), 8)
    eng = ContinuousEngine(spec, params, slots, temperature, topp, seed,
                           cache_dtype=cache_dtype,
                           prefill_chunk=prefill_chunk,
                           block_steps=block_steps,
                           fast_prefill=fast_prefill, page_size=page_size,
                           kv_pages=kv_pages, kv_quant=kv_quant,
                           device=device, graph=graph, mesh=mesh,
                           scheme=scheme, spec_k=spec_k,
                           spec_ngram=spec_ngram,
                           dispatch_tokens=dispatch_tokens, metrics=metrics,
                           kv_host_pages=kv_host_pages,
                           kv_disk_dir=kv_disk_dir,
                           kv_disk_bytes=kv_disk_bytes)
    try:
        outs, stats = eng.run(reqs, steps, quiet=quiet)
    finally:
        eng.close()
    if not quiet:
        for b, (req, row) in enumerate(zip(reqs, outs)):
            print(f"[{b}] {decode_stream(tokenizer, req[0], row)!r}")
        print(f"Generated tokens:    {stats.tokens} across {len(reqs)} "
              f"requests ({slots} slots, {stats.steps} steps)")
        print(f"Avg generation time: "
              f"{stats.total_ms / max(1, stats.tokens):.2f} ms/token "
              f"({stats.tokens_per_s:.1f} tok/s)")
        if eng.allocator is not None:
            a = eng.allocator
            print(f"Paged KV:            {a.n_pages} pages x "
                  f"{a.page_size} positions ({eng.kv_quant}), "
                  f"{a.n_free} free; prefix hit "
                  f"rate {a.hit_rate:.0%}, {a.tokens_saved} prefill "
                  f"tokens saved, {a.evictions} evictions")
            if a.tiered:
                counts = a.tier_page_counts()
                saved = a.tokens_saved_by_tier
                print(f"KV tiers:            hbm {counts['hbm']} / host "
                      f"{counts['host']} / disk {counts['disk']} pages; "
                      f"{sum(a.demotions.values())} demotions, "
                      f"{sum(a.promotions.values())} promotions; "
                      f"{saved['host'] + saved['disk']} prefill tokens "
                      f"rescued from spilled tiers")
        if eng.dispatch_tokens:
            print(f"Token budget:        {eng.dispatch_tokens} "
                  f"tokens/dispatch over {stats.steps} mixed dispatches")
        if eng.spec_k:
            print(f"Speculative:         K={eng.spec_k}, "
                  f"{stats.spec_accepted}/{stats.spec_proposed} drafts "
                  f"accepted ({stats.spec_accept_rate:.0%}); "
                  f"{stats.total_ms / max(1, stats.tokens):.2f} "
                  f"ms/accepted token over {stats.steps} verify dispatches")
    return outs, stats
