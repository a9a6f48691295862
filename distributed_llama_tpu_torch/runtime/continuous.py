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

Left out (later slices): speculative decoding and mixed dispatch (and
their tensor-parallel twins), the KV tiers and remote page adoption,
chunk-boundary prefill preemption (``prefill_hold``), the journal,
recovery, suspend, the server, metrics, SLO, ledger and census books,
chaos and the watchdog. Their engine arguments raise "not yet ported"
when not at their defaults.
"""

from __future__ import annotations

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
from ..ops import attention, paged_attention, q40
from ..ops._build import build
from ..parallel.mesh import TPGroup, single
from ..parallel.tp import validate_kv_quant
from .decode import GraphStep, sample_device_dynamic
from .generate import _no_capture, _tp_model, run_chunked_prefill
from .paging import SCRAP_PAGE, PagedAllocator
from .sampling import Sampler


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
    # time.monotonic stamps (0.0 = not reached); t_first_token marks the
    # first SAMPLED token
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    n_sampled: int = 0


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


def _load(dst: torch.Tensor, src: np.ndarray) -> None:
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
                 dispatch_tokens: int = 0, metrics=None, slo=None,
                 chaos=None, journal=None, watchdog=None,
                 kv_host_pages: int = 0, kv_disk_dir: str | None = None,
                 remote_pages: bool = False, slo_priority: bool = False,
                 scheme: str | None = None):
        given = {name: value for name, value in (
            ("spec_k", spec_k),
            ("dispatch_tokens", dispatch_tokens), ("metrics", metrics),
            ("slo", slo), ("chaos", chaos), ("journal", journal),
            ("watchdog", watchdog), ("kv_host_pages", kv_host_pages),
            ("kv_disk_dir", kv_disk_dir), ("remote_pages", remote_pages),
            ("slo_priority", slo_priority)) if value}
        if given:
            raise ValueError(f"not yet ported: {', '.join(given)} (the "
                             f"port's continuous engine runs one device, "
                             f"contiguous or paged, f32/bf16 or q8 pages)")
        if mesh is not None and not isinstance(mesh, TPGroup):
            raise ValueError(f"not yet ported: mesh of type "
                             f"{type(mesh).__name__} (the port's mesh is a "
                             f"parallel/mesh.TPGroup, the tp axis; the JAX "
                             f"package's dp and sp axes are not ported)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
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
        self.spec = spec
        self.slots = slots
        self.temperature = temperature
        self.topp = topp
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.block_steps = block_steps
        self.page_size = page_size
        self.kv_quant = kv_quant
        self.group = mesh or single(device)
        self.device = (self.group.device if mesh is not None
                       else torch.device(device))
        _no_capture(self.group, self.device, graph)
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        if self.device.type == "cuda":
            build([*q40.KERNELS, *q40.HELPERS, *attention.KERNELS,
                   *attention.HELPERS, *paged_attention.KERNELS])
        # the small-T body is read once, as generate_batch reads it
        body = q40.multi_t_body()
        if self.group.size > 1:
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
            self._alloc = PagedAllocator(n_pages, page_size,
                                         prefix_share=prefix_share)
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
        self._stage_i32 = np.zeros((3, slots), np.int32)
        self._stage_f32 = np.zeros((2, slots), np.float32)
        self._stage_active = np.zeros((slots,), np.bool_)
        self._pool = [_Slot() for _ in range(slots)]
        self._queue: list[Request] = []
        self._lock = threading.Lock()
        self._submitted = 0
        self.stats = ContinuousStats()

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
        return self._logits.cpu().numpy()

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
        graphs = [c.graph for c in self._chains.values()] + [self._once]
        return sum(g.replays for g in graphs if g is not None)

    # -- paged-KV bookkeeping -----------------------------------------------

    def _ensure_pages(self, s: _Slot, n_positions: int) -> bool:
        """Grow a slot's page list to cover ``n_positions`` positions,
        evicting idle radix leaves when the free list is dry. False = the
        pool cannot cover it even after eviction."""
        need = self._alloc.pages_for(min(n_positions, self.spec.seq_len))
        while len(s.pages) < need:
            pid = self._alloc.alloc_page()
            if pid is None:
                return False
            s.pages.append(pid)
        return True

    def _grow_pages(self, pool, k: int, quiet: bool) -> set:
        """Pre-chain page coverage: every active slot gets pages for its
        next ``k`` positions, so no mid-chain write crosses into an
        unmapped page. A slot the pool cannot serve yet is PAUSED for this
        dispatch (returned in the set): it rides the step masked inactive,
        its dead rewrite lands on its own page or the scrap page, and its
        sampler draws nothing, so its stream is untouched. Only when EVERY
        active slot is starved (no retirement can ever free a page) does
        the youngest request fail."""
        while True:
            paused = set()
            active = 0
            for b, s in enumerate(pool):
                if s.free:
                    continue
                active += 1
                if not self._ensure_pages(s, min(s.pos + k, s.budget)):
                    paused.add(b)
            if not paused or len(paused) < active:
                self.stats.pauses += len(paused)
                return paused
            victim = max(paused, key=lambda b: pool[b].req.index)
            s = pool[victim]
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
        requests."""
        if k <= 1:
            return self.step_once(quiet=quiet)
        self._sweep_cancelled()
        self._admit()
        pool = self._pool
        paused = (self._grow_pages(pool, k, quiet)
                  if self._alloc is not None else ())
        if all(s.free for s in pool):
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
        with torch.inference_mode():
            if c.graph is not None:
                c.graph.run(k)
            else:
                for _ in range(k):
                    self._chain_step(c, greedy_only)
        toks = c.toks.cpu().numpy()  # the chain's one read back
        acts = c.acts.cpu().numpy()
        self.stats.steps += k
        self.stats.sum_active += n_active0 * k
        self.stats.max_active = max(self.stats.max_active, n_active0)
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
        return self._n_outstanding()

    def step_once(self, quiet: bool = True) -> int:
        """Admit queued requests, run ONE device step over the pool (the
        captured forward), sample on the host and retire finished rows.
        Returns active slots + queued requests (0 = idle)."""
        self._sweep_cancelled()
        self._admit()
        pool = self._pool
        paused = (self._grow_pages(pool, 1, quiet)
                  if self._alloc is not None else ())
        if all(s.free for s in pool):
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
        with torch.inference_mode():
            logits = self._run_forward()
        self.stats.steps += 1
        self.stats.sum_active += active0
        self.stats.max_active = max(self.stats.max_active, active0)
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
        self._notify(s.req, nxt)
        self.stats.tokens += 1
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
        with self._lock:
            queued = len(self._queue)
        return sum(not s.free for s in self._pool) + queued

    def _pop_request(self) -> Request | None:
        """Next live queued request (FIFO; requests cancelled before
        admission are completed and skipped), or None."""
        while True:
            with self._lock:
                if not self._queue:
                    return None
                req = self._queue.pop(0)
            if not req.cancelled:
                return req
            req.done.set()

    def _requeue_front(self, s: _Slot) -> None:
        """Undo an admission the page pool could not serve: release the
        slot's pages, free it, and put the request back at the HEAD of the
        queue (later, smaller requests do not jump a starved one)."""
        req = s.req
        self._alloc.release_pages(s.pages)
        s.pages, s.shared = [], 0
        s.req, s.pos, s.token, s.forced, s.sampler = None, 0, 0, [], None
        req.t_admit = 0.0
        self.stats.requeues += 1
        with self._lock:
            self._queue.insert(0, req)

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
                if self._alloc is not None \
                        and self._admit_paged(s) == "dry":
                    self._requeue_front(s)
                    return
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
        budget, or a BOS inside the prompt."""
        chunk = self.prefill_chunk
        tokens = s.req.tokens
        n_pre = len(tokens) - 1
        start = s.pos  # 0 or the page-aligned prefix-share boundary
        if (chunk <= 1 or n_pre - start < 2 or n_pre >= s.budget
                or BOS in tokens[1:]):
            return
        paged = self._alloc is not None
        q8 = self.kv_quant == "q8"
        with torch.inference_mode():
            if paged:
                tbl = np.full((self._max_pages,), SCRAP_PAGE, np.int32)
                tbl[:len(s.pages)] = s.pages
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

            run_chunked_prefill(fwd, tokens[start:n_pre], start, chunk,
                                self.spec.seq_len)
            if paged:
                if q8:
                    # re-quantizing moves bytes: a shared page keeps its
                    # first publisher's encoding
                    tbl_sc = tbl.copy()
                    tbl_sc[:s.shared] = SCRAP_PAGE
                    scatter_pages_q8(self.cache, scratch,
                                     torch.from_numpy(tbl_sc).to(self.device),
                                     self.page_size)
                else:
                    scatter_pages(self.cache, scratch, tbl_dev,
                                  self.page_size)
                # publish the prefilled full prompt pages now: a request
                # admitted into the next slot this round already shares them
                self._alloc.insert_prefix(tokens[:n_pre], s.pages)
            else:
                self.cache.k[:, slot_index].copy_(scratch.k)
                self.cache.v[:, slot_index].copy_(scratch.v)
        # echo the prefilled prompt tokens into the output and the count
        s.req.out.extend(tokens[start + 1:n_pre + 1])
        for t in tokens[start + 1:n_pre + 1]:
            self._notify(s.req, t)
        self.stats.tokens += n_pre - start
        s.pos = n_pre
        s.token = tokens[n_pre]
        s.forced = []

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
            self._alloc.release_pages(s.pages)
            s.pages, s.shared = [], 0
        s.req.t_finish = time.monotonic()
        s.req.done.set()
        s.req = None
        # park the freed slot at pos 0 (its table row on the scrap page):
        # its dead writes land there until it is re-admitted
        s.pos, s.token = 0, 0

    # -- entry points -------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Queue a request (thread-safe). ``req.done`` fires when it
        retires."""
        if not req.tokens:
            raise ValueError("request has no prompt tokens")
        req.t_enqueue = time.monotonic()
        with self._lock:
            req.index = self._submitted
            self._submitted += 1
            self._queue.append(req)
        return req

    def cancel(self, req: Request) -> None:
        """Cancel a request from any thread: a queued one completes now,
        an in-flight one retires (freeing its slot and pages) before the
        next dispatch."""
        req.on_token = None
        req.cancelled = True
        with self._lock:
            if req not in self._queue:
                return  # in flight (or done): the sweep owns it
            self._queue.remove(req)
        req.done.set()

    def fail_all(self, message: str) -> None:
        """Fail every queued and in-flight request: ``error`` then
        ``done``; the radix tree is torn down with them."""
        with self._lock:
            pending, self._queue = self._queue, []
        for req in pending:
            req.error = message
            req.done.set()
        for s in self._pool:
            if not s.free:
                s.req.error = message
                self._retire(s, quiet=True)
        if self._alloc is not None:
            self._alloc.tree.clear()

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
                        scheme: str | None = None):
    """CLI entry (``--prompts-file --continuous``): encode the prompts,
    stream them through a pool of ``slots`` (0 = min(#prompts, 8)) and
    print the rows ("[i] 'text'") and the JAX CLI's stats lines."""
    reqs = [tokenizer.encode(p or "", bos=True, eos=False) for p in prompts]
    slots = slots or min(len(reqs), 8)
    eng = ContinuousEngine(spec, params, slots, temperature, topp, seed,
                           cache_dtype=cache_dtype,
                           prefill_chunk=prefill_chunk,
                           block_steps=block_steps,
                           fast_prefill=fast_prefill, page_size=page_size,
                           kv_pages=kv_pages, kv_quant=kv_quant,
                           device=device, graph=graph, mesh=mesh,
                           scheme=scheme)
    outs, stats = eng.run(reqs, steps, quiet=quiet)
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
    return outs, stats
