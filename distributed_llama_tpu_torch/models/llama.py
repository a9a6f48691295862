"""The Llama-2 forward (7B/13B/70B incl. GQA) in PyTorch, T tokens per call.

Numerics follow the JAX package's models/llama.py (the parity contract):

* RoPE: interleaved (2p, 2p+1) pairs, freq = 10000^-((2p mod hs)/hs), q
  rotated over the full dim and k over kvDim — not the half-split rotation.
* Attention: score = q.k/sqrt(hs); GQA maps query head h to kv head
  h // kv_mul; keys 0..pos of the stacked (L, S, n_kv, hs) cache, f32 or
  (``--kv-cache-dtype bf16``) bf16: the cache write rounds to the cache
  dtype (nearest even, as ``astype``) and every read widens it exactly.
* SwiGLU: silu(w1 x) * (w3 x); rmsnorm with eps=1e-5 added after the mean.
* Under ``buffer_float_type == Q80`` the four matmul inputs of a layer pass
  through the Q80 round trip (ops/linear.fake_quant_q80), at the JAX
  package's ``_maybe_q80`` cut points.

T = 1 is a decode step (attention through K2); T > 1 is a chunk of chunked
prefill at positions pos..pos+T-1 (attention through K4 for every T > 1,
where the JAX package sends T <= 8 to a dense XLA einsum — the same values,
as no Pallas kernel is involved there).

``Llama.forward_batch`` (the JAX package's ``forward_batch`` and
``forward_batch_ragged``) decodes one token for each of B sequences over
the (L, B, S, n_kv, hs) batch cache (``init_cache_batch``), every input a
device tensor: tokens (B,) and positions (B,), one shared clock or
per-row clocks. Each row rotates at its own position, writes its k/v at
(layer, row, pos[b]) and attends through K5, which reads the positions on
the device; the matmuls take the T = B path. Nothing in it reads a device
value on the host, so runtime/decode.py captures it in a CUDA graph. At
B = 1 over a single-sequence cache viewed as (L, 1, S, n_kv, hs) it is the
T = 1 step with device inputs: K1 and K5, which at B = 1 computes K2's
sums in K2's order, so its logits equal ``forward``'s bit for bit.

``Llama.forward_batch_paged`` is that step over the paged pool (K6, or K7
over Q8 pages); ``forward_batch_spec_paged`` (a speculative verify window
of K tokens a row) and ``forward_batch_mixed_paged`` (a token-budget
window of T positions a row, each row live for its span) are its
(B, T)-window twins: the B*T rows go through every product as one flat
batch (K3 above 8 rows), each window is written through the page table
and then attends as a whole through K6/K7, query i of row b seeing
positions 0..pos[b] + i.

``Llama.forward_fused`` (the JAX package's ``_forward_fused``, behind
``DLLAMA_LAYER_FUSION=headtail|on``) is the T = 1 step through the fused
decode-layer kernels of ops/layer.py: K8, the k/v write, the decode
attention and K9 per layer, or one K10. ``forward`` takes it at T = 1 when
the module was built with a fused mode that ops/layer.supports; prefill
chunks of T > 1, ``forward_batch`` and the paged forward stay unfused.

``forward_seq`` (the JAX package's, the training path) runs a (B, T)
batch of full windows without a cache, differentiably, over the dense
f32 training tree: plain products and ``attention_core`` under the
causal mask, with hooks for the window's positions and its attention
(parallel/sp_train's ring).

The precision is an explicit ``Route`` per call, where the JAX package
traces a second program under a context variable (ops/linear.py
``matmul_precision("bf16")``): ``FAST`` is the ``--fast-prefill`` route for
T > 8 chunks, with the bf16 Q40 GEMM (K3b), bf16 dense products and bf16
prefill attention (K4b); ``FAST_PLAIN`` is its plain twin. ``with_body``
gives a route the small-T body the engine read from
``DLLAMA_MULTI_T_BODY`` (K1d for 'dequant'). One module and one parameter
tree serve every route.

Departures, none of which changes a value: the KV write is in place at
(layer, pos..pos+T-1) instead of a functional update; the RoPE frequencies
are computed once per model and the angles once per call, shared by every
layer; the layer loop is a Python loop over zero-copy per-layer views of
the stacked weights; a prefill call may skip the final norm and ``wcls``,
whose logits the JAX prefill discards.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..io.loader import Q40Weight
from ..obs.profiler import span as phase
from ..obs.spans import SCOPE_ATTN, SCOPE_EMBED, SCOPE_FFN, SCOPE_LOGITS
from ..ops.attention import (attention_core, decode_attention,
                             decode_attention_batch,
                             decode_attention_batch_plain,
                             decode_attention_plain, prefill_attention,
                             prefill_attention_bf16_plain,
                             prefill_attention_plain)
from ..ops.layer import (fused, mega_supported, q40_head_fused,
                         q40_head_fused_plain, q40_layer_mega,
                         q40_layer_mega_plain, q40_tail_fused,
                         q40_tail_fused_plain, rope_freq, rope_rows)
from ..ops.layer import rotate as _rotate
from ..ops.layer import supports as fusion_supports
from ..ops.linear import (FUSED_LOAD, dense_matmul, dense_matmul_bf16,
                          fake_quant_q80, fusible, matmul,
                          q40_concat_to_device, q40_to_device, rmsnorm, silu)
from ..ops.paged_attention import paged_decode_attention as paged_flash
from ..ops.paged_attention import \
    paged_decode_attention_plain as paged_flash_plain
from ..ops.paged_attention import paged_decode_attention_q8 as paged_flash_q8
from ..ops.paged_attention import \
    paged_decode_attention_q8_plain as paged_flash_q8_plain
from ..ops.q40 import q40_matmul, q40_matmul_plain
from ..ops.quants import QK, FloatType, dequantize_q80_planes, \
    quantize_q80_torch
from ..runtime.paging import SCRAP_PAGE
from .spec import TransformerSpec

__all__ = ["KVCache", "init_cache", "init_cache_batch", "init_cache_paged",
           "PagedKVQ8", "init_cache_paged_q8", "paged_cache_planes",
           "paged_decode_attention", "paged_attention_q8", "gather_pages",
           "scatter_pages", "gather_pages_q8", "scatter_pages_q8",
           "attention_core", "Route", "KERNELS", "PLAIN", "FAST",
           "FAST_PLAIN", "with_body", "LOGIT_RTOL", "FAST_RTOL", "Llama",
           "forward_seq", "params_to_device", "params_from_reference"]


class KVCache(NamedTuple):
    k: torch.Tensor  # (n_layers, seq_len, n_kv_heads, head_size) f32 / bf16
    v: torch.Tensor


def init_cache(spec: TransformerSpec, device,
               dtype: torch.dtype = torch.float32) -> KVCache:
    shape = (spec.n_layers, spec.seq_len, spec.n_kv_heads, spec.head_size)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_cache_batch(spec: TransformerSpec, batch: int, device,
                     dtype: torch.dtype = torch.float32) -> KVCache:
    """The batch cache (L, B, S, n_kv, hs): each (layer, row) has the
    single-sequence (S, n_kv, hs) layout, and forward_batch reads it as the
    rank-4 (L*B, S, n_kv, hs) view the JAX package carries."""
    shape = (spec.n_layers, batch, spec.seq_len, spec.n_kv_heads,
             spec.head_size)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _check_page_size(spec: TransformerSpec, page_size: int) -> None:
    if page_size < 1 or spec.seq_len % page_size:
        raise ValueError(f"page_size={page_size} must divide "
                         f"seq_len={spec.seq_len}")


def init_cache_paged(spec: TransformerSpec, n_pages: int, page_size: int,
                     device, dtype: torch.dtype = torch.float32) -> KVCache:
    """The paged pool (L, P, page_size, n_kv, hs): physical page p of layer
    l is the (page_size, n_kv, hs) plane at [l, p]. ``n_pages`` counts the
    reserved scrap page 0 (runtime/paging.SCRAP_PAGE); slots map logical
    pages onto physical ones through int32 page-table rows."""
    _check_page_size(spec, page_size)
    shape = (spec.n_layers, n_pages, page_size, spec.n_kv_heads,
             spec.head_size)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class PagedKVQ8(NamedTuple):
    """The Q8 page pool (``--kv-quant q8``): ``kq``/``vq`` int8 Q80 codes
    with the f32 pool's (L, P, page_size, n_kv, hs) geometry, ``kd``/``vd``
    f16 block deltas, one per 32 values of a position's flattened (n_kv*hs)
    row: (L, P, page_size, n_kv*hs/32). kv_dim + 2*kv_dim/32 bytes per
    position and plane against the f32 pool's 4*kv_dim."""

    kq: torch.Tensor
    kd: torch.Tensor
    vq: torch.Tensor
    vd: torch.Tensor


def init_cache_paged_q8(spec: TransformerSpec, n_pages: int, page_size: int,
                        device) -> PagedKVQ8:
    """init_cache_paged's Q8 twin; kv_dim must divide into 32-value
    blocks."""
    _check_page_size(spec, page_size)
    if spec.kv_dim % QK:
        raise ValueError(f"q8 KV pages quantize the flattened (n_kv, hs) "
                         f"position row in {QK}-value Q80 blocks: "
                         f"kv_dim={spec.kv_dim} must divide by {QK}")
    codes = (spec.n_layers, n_pages, page_size, spec.n_kv_heads,
             spec.head_size)
    deltas = (spec.n_layers, n_pages, page_size, spec.kv_dim // QK)
    return PagedKVQ8(torch.zeros(codes, dtype=torch.int8, device=device),
                     torch.zeros(deltas, dtype=torch.float16, device=device),
                     torch.zeros(codes, dtype=torch.int8, device=device),
                     torch.zeros(deltas, dtype=torch.float16, device=device))


def paged_cache_planes(cache) -> tuple[tuple, int]:
    """The rank-4 (L*P, page_size, ...) views of a paged pool, KVCache or
    PagedKVQ8, the kernels read, and P."""
    if isinstance(cache, PagedKVQ8):
        L, P = cache.kq.shape[:2]
        return tuple(plane.view(L * P, *plane.shape[2:])
                     for plane in cache), P
    L, P = cache.k.shape[:2]
    return (cache.k.view(L * P, *cache.k.shape[2:]),
            cache.v.view(L * P, *cache.v.shape[2:])), P


def _page_plane(plane: torch.Tensor) -> torch.Tensor:
    # the wire carries a bf16 plane as its raw 16-bit words
    return plane.view(torch.int16) if plane.dtype == torch.bfloat16 \
        else plane


def fetch_page_planes(cache, pid: int) -> tuple:
    """Host numpy copy of ONE physical page's planes, in the page wire
    layout: ``(k, v)`` (L, page_size, n_kv, hs) for an f32 or bf16 pool
    (bf16 as int16 words), ``(kq, kd, vq, vd)`` for Q8, i.e. ``pool[:,
    pid]`` with no transpose, so a demote->promote round trip is
    byte-identical (f32 bitwise, Q8 code-exact: nothing re-quantizes).
    Blocks until the copy landed (the JAX package's np.asarray)."""
    return tuple(_page_plane(p)[:, pid].cpu().numpy().copy()
                 for p in cache)


def write_page_planes(cache, pid: int, planes) -> None:
    """Write one page's planes (fetch_page_planes' tuple) back into the
    pool at physical page ``pid``, IN PLACE in the pool tensors (a captured
    graph keeps reading the same memory)."""
    with torch.no_grad():
        for plane, p in zip(cache, planes):
            src = torch.from_numpy(np.array(p, copy=True))
            _page_plane(plane)[:, pid].copy_(src)


def _window_coords(table: torch.Tensor, pos: torch.Tensor, t_len: int,
                   idx: int, n_pages: int, page_size: int,
                   span: torch.Tensor | None = None):
    """(page row, offset) (B, t_len) int64 of each row's window positions
    pos[b] + i: page table[b, p // ps] of layer idx, computed on the
    device. A position at or past the virtual plane (p >= max_pages * ps,
    a window running past the budget edge) and, with ``span``, an offset
    i >= span[b] (a mixed window's padding) go to the scrap page, never
    clamped onto a live page (the JAX package's spec_verify_attention /
    mixed_attention location math)."""
    max_pages = table.shape[1]
    i = torch.arange(t_len, device=pos.device)[None]
    p = pos.long()[:, None] + i
    live = p < max_pages * page_size
    if span is not None:
        live = live & (i < span.long()[:, None])
    logical = torch.clamp(p // page_size, max=max_pages - 1)
    page = torch.where(live, table.gather(1, logical).long(), SCRAP_PAGE)
    return idx * n_pages + page, p % page_size


def paged_decode_attention(head_size: int, kv_mul: int, n_pages: int,
                           q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k4: torch.Tensor, v4: torch.Tensor, idx: int,
                           pos: torch.Tensor, table: torch.Tensor,
                           route: Route,
                           span: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of a window of t_len queries per row over the paged pool
    (the JAX package's paged_decode_attention at t_len 1,
    spec_verify_attention at K and mixed_attention with ``span``): q
    (B, t_len, n_q*hs), k/v (B, t_len, n_kv*hs). Row b's k/v at offset i
    are written in place at the (page, offset) of position pos[b] + i
    (_window_coords: past the virtual plane or the span, the scrap page),
    then the whole window attends through ``route.paged`` (K6), query i
    seeing positions 0..pos[b] + i. Nothing is read on the host. Returns
    (B, t_len, n_q*hs)."""
    B, t_len, n_kv = q.shape[0], q.shape[1], k4.shape[2]
    rows, off = _window_coords(table, pos, t_len, idx, n_pages, k4.shape[1],
                               span)
    k4.index_put_((rows, off),
                  k.reshape(B, t_len, n_kv, head_size).to(k4.dtype))
    v4.index_put_((rows, off),
                  v.reshape(B, t_len, n_kv, head_size).to(v4.dtype))
    return route.paged(q.contiguous(), k4, v4, idx, pos, table, n_pages,
                       kv_mul)


def paged_attention_q8(head_size: int, kv_mul: int, n_pages: int,
                       q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kq4: torch.Tensor, kd4: torch.Tensor,
                       vq4: torch.Tensor, vd4: torch.Tensor, idx: int,
                       pos: torch.Tensor, table: torch.Tensor,
                       route: Route,
                       span: torch.Tensor | None = None) -> torch.Tensor:
    """paged_decode_attention over Q8 pages (the JAX package's
    paged_attention_q8, ``span`` its mixed-window write gate): each
    (row, offset)'s flattened k/v is quantized on write
    (quantize_q80_torch, the JAX package's quantize_q80_jax), codes and
    deltas written at the same (page, offset), then ``route.paged_q8``
    (K7) attends. Returns (B, t_len, n_q*hs)."""
    B, t_len, n_kv = q.shape[0], q.shape[1], kq4.shape[2]
    rows, off = _window_coords(table, pos, t_len, idx, n_pages,
                               kq4.shape[1], span)
    for x, codes, deltas in ((k, kq4, kd4), (v, vq4, vd4)):
        qs, d = quantize_q80_torch(x.reshape(B, t_len, -1))
        codes.index_put_((rows, off), qs.reshape(B, t_len, n_kv, head_size))
        deltas.index_put_((rows, off), d)
    return route.paged_q8(q.contiguous(), kq4, kd4, vq4, vd4, idx, pos,
                          table, n_pages, kv_mul)


def gather_pages(cache: KVCache, table: torch.Tensor,
                 page_size: int) -> KVCache:
    """One slot's virtual (L, S, n_kv, hs) sequence cache copied out of its
    pool pages, ``table`` its (max_pages,) logical -> physical row: the
    admission-prefill seed (a suffix chunk attends over the shared prefix).
    Entries past the live prefix gather scrap-page junk that prefill
    overwrites before any chunk reads it."""
    idx = table.long()

    def g(plane):
        got = plane[:, idx]              # (L, max_pages, ps, n_kv, hs)
        return got.reshape(plane.shape[0], -1, *plane.shape[3:])

    return KVCache(g(cache.k), g(cache.v))


def scatter_pages(cache: KVCache, seq_cache: KVCache, table: torch.Tensor,
                  page_size: int) -> KVCache:
    """gather_pages' inverse, IN PLACE on the pool's own storage (a CUDA
    graph captured over the pool keeps reading it): the prefilled sequence
    cache goes back to the slot's physical pages. Shared prefix pages get
    their own bytes back; entries parked on the scrap page take the junk.
    Returns ``cache``."""
    idx = table.long()
    for plane, seq in ((cache.k, seq_cache.k), (cache.v, seq_cache.v)):
        plane.index_copy_(1, idx, seq.reshape(plane.shape[0], -1,
                                              *plane.shape[2:]))
    return cache


def gather_pages_q8(cache: PagedKVQ8, table: torch.Tensor,
                    page_size: int) -> KVCache:
    """gather_pages' Q8 twin: the slot's sequence cache dequantized to f32
    (dequantize_q80_planes), the values decode reads."""
    idx = table.long()
    L, _, ps, n_kv, hs = cache.kq.shape

    def g(codes, d):
        c = codes[:, idx].reshape(L, -1, n_kv, hs)
        return dequantize_q80_planes(c, d[:, idx].reshape(L, c.shape[1], -1))

    return KVCache(g(cache.kq, cache.kd), g(cache.vq, cache.vd))


def scatter_pages_q8(cache: PagedKVQ8, seq_cache: KVCache,
                     table: torch.Tensor, page_size: int) -> PagedKVQ8:
    """scatter_pages' Q8 twin, in place: each position of the prefilled
    plane Q80-quantized, codes and deltas written to the slot's pages.
    Re-quantizing is not byte-idempotent, so the engine parks a shared
    page's entry on the scrap page: it keeps its first publisher's bytes.
    Returns ``cache``."""
    idx = table.long()
    L, _, ps, n_kv, hs = cache.kq.shape
    for codes, deltas, seq in ((cache.kq, cache.kd, seq_cache.k),
                               (cache.vq, cache.vd, seq_cache.v)):
        qs, d = quantize_q80_torch(seq.reshape(L, -1, n_kv * hs))
        codes.index_copy_(1, idx, qs.reshape(L, -1, ps, n_kv, hs))
        deltas.index_copy_(1, idx, d.reshape(L, -1, ps, d.shape[-1]))
    return cache


class Route(NamedTuple):
    """Which Q40 matmul, dense matmul, decode attention (T = 1), prefill
    attention (T > 1), batched decode attention (forward_batch), paged
    decode attention over f32/bf16 and Q8 pages (forward_batch_paged) and
    fused decode-layer head, tail and whole layer (forward_fused) the
    forward calls."""

    q40: Callable
    dense: Callable
    attention: Callable
    prefill: Callable
    batch: Callable
    paged: Callable
    paged_q8: Callable
    head: Callable
    tail: Callable
    mega: Callable


# the kernel wrappers (the plain versions on CPU tensors) — the main path
KERNELS = Route(q40_matmul, dense_matmul, decode_attention,
                prefill_attention, decode_attention_batch, paged_flash,
                paged_flash_q8, q40_head_fused, q40_tail_fused,
                q40_layer_mega)
# the plain versions on any device — to hold the kernels against on the card
PLAIN = Route(q40_matmul_plain, dense_matmul, decode_attention_plain,
              prefill_attention_plain, decode_attention_batch_plain,
              paged_flash_plain, paged_flash_q8_plain, q40_head_fused_plain,
              q40_tail_fused_plain, q40_layer_mega_plain)
# --fast-prefill's T > 8 chunks: bf16 products, f32 accumulation (K3b, K4b)
FAST = KERNELS._replace(q40=partial(q40_matmul, bf16=True),
                        dense=dense_matmul_bf16,
                        prefill=partial(prefill_attention, bf16=True))
FAST_PLAIN = PLAIN._replace(q40=partial(q40_matmul_plain, bf16=True),
                            dense=dense_matmul_bf16,
                            prefill=prefill_attention_bf16_plain)


def with_body(route: Route, multi_body: str) -> Route:
    """``route`` with its Q40 matmul taking ``multi_body`` ('vpu' or
    'dequant', ops/q40.multi_t_body) for 2 <= T <= 8."""
    if multi_body == "vpu":
        return route
    return route._replace(q40=partial(route.q40, multi_body=multi_body))


# |kernel logits - plain logits| <= LOGIT_RTOL * max|plain logits|: the two
# routes sum in different orders through every layer (f32 throughout)
LOGIT_RTOL = 1e-3
# the same for FAST against FAST_PLAIN (logits after a fast prefill, and the
# prefilled cache rows): the sums' order differs as above, and wherever it
# moves a value across a bf16 rounding boundary the next product sees it
# one bf16 step (2^-8 relative) apart
FAST_RTOL = 1e-2


def rope_tables(freq: torch.Tensor, pos: int,
                t_len: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """rope_rows at positions pos..pos+T-1, made on the frequencies'
    device (no host-to-device copy)."""
    return rope_rows(freq, torch.arange(pos, pos + t_len,
                                        device=freq.device))


def _mm(w, x: torch.Tensor, route: Route) -> torch.Tensor:
    return matmul(w, x, route.q40, route.dense)


def _maybe_q80(spec: TransformerSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.buffer_float_type == FloatType.Q80:
        return fake_quant_q80(x)
    return x


def _qkv_proj(spec: TransformerSpec, lw: dict[str, Any], x: torch.Tensor,
              rope: tuple[torch.Tensor, torch.Tensor], route: Route):
    """norm -> (q80) -> q/k/v matmuls (fused wqkv when present) -> RoPE on
    q and k. x is (T, dim) or batched (B, T, dim), the RoPE tables (T, n/2).
    Returns q (..., T, dim), k (..., T, kv_dim), v (..., T, kv_dim)."""
    xb = _maybe_q80(spec, rmsnorm(x, lw["rms_att"]))
    qk_dim = spec.dim + spec.kv_dim
    if "wqkv" in lw:
        qkv = _mm(lw["wqkv"], xb, route)
        qk, v = qkv[..., :qk_dim], qkv[..., qk_dim:]
    else:
        qk = torch.cat([_mm(lw["wq"], xb, route),
                        _mm(lw["wk"], xb, route)], dim=-1)
        v = _mm(lw["wv"], xb, route)
    # q and k rotate together: head_dim = (2p) mod hs runs on across the
    # q/k boundary because dim is a multiple of hs
    qk = _rotate(qk, *rope)
    return qk[..., :spec.dim], qk[..., spec.dim:], v


def _post_attention(spec: TransformerSpec, lw: dict[str, Any],
                    x: torch.Tensor, ao: torch.Tensor,
                    route: Route) -> torch.Tensor:
    """wo + residual, then the SwiGLU ffn sub-block + residual (each matmul
    input through the q80 cut point)."""
    with phase(SCOPE_ATTN):
        x = x + _mm(lw["wo"], _maybe_q80(spec, ao), route)
    with phase(SCOPE_FFN):
        xb = _maybe_q80(spec, rmsnorm(x, lw["rms_ffn"]))
        if "w13" in lw:
            h13 = _mm(lw["w13"], xb, route)
            hid = h13.shape[-1] // 2
            hb = silu(h13[..., :hid]) * h13[..., hid:]
        else:
            hb = silu(_mm(lw["w1"], xb, route)) * _mm(lw["w3"], xb, route)
        return x + _mm(lw["w2"], _maybe_q80(spec, hb), route)


def _layer(spec: TransformerSpec, x: torch.Tensor, lw: dict[str, Any],
           cache: KVCache, idx: int, pos: int,
           rope: tuple[torch.Tensor, torch.Tensor],
           route: Route = KERNELS, tail: Callable | None = None,
           attend: Callable | None = None) -> torch.Tensor:
    """One transformer layer over T tokens: writes their k/v into the
    stacked cache in place at (idx, pos..pos+T-1), attends causally over
    0..pos+T-1, returns the new residual (T, dim). ``tail(lw, x, ao,
    route)`` replaces _post_attention (the tensor-parallel layer tail),
    ``attend(cache, q, k, v, idx, pos)`` the cache write and attention
    (the sp-sharded cache's)."""
    with phase(SCOPE_ATTN):
        q, k, v = _qkv_proj(spec, lw, x, rope, route)
        if attend is not None:
            ao = attend(cache, q, k, v, idx, pos)
        else:
            ao = _cache_attention(spec, cache, q, k, v, idx, pos, route)
    if tail is not None:
        return tail(lw, x, ao, route)
    return _post_attention(spec, lw, x, ao, route)


def _cache_attention(spec: TransformerSpec, cache: KVCache, q, k, v,
                     idx: int, pos: int, route: Route) -> torch.Tensor:
    """The stacked cache's write of T tokens' k/v at (idx, pos..) and
    causal attention over 0..pos+T-1 (K2 at T = 1, else K4)."""
    t_len = q.shape[0]
    hs, n_kv = spec.head_size, spec.n_kv_heads
    cache.k[idx, pos:pos + t_len].copy_(k.reshape(t_len, n_kv, hs))
    cache.v[idx, pos:pos + t_len].copy_(v.reshape(t_len, n_kv, hs))
    if t_len == 1:
        ao = route.attention(q.reshape(spec.n_heads, hs), cache.k, cache.v,
                             idx, pos, spec.kv_mul)
    else:  # q is a strided slice of the rotated q|k: the kernel wants rows
        ao = route.prefill(q.reshape(t_len, spec.n_heads, hs).contiguous(),
                           cache.k, cache.v, idx, pos, spec.kv_mul)
    return ao


LAYER_KEYS = ("rms_att", "rms_ffn", "wq", "wk", "wv", "wo", "w1", "w2", "w3",
              "wqkv", "w13")


def _layer_view(params: dict[str, Any], i: int) -> dict[str, Any]:
    """Layer i of every stacked weight, as zero-copy views."""
    lw = {}
    for k in LAYER_KEYS:
        if k in params:
            w = params[k]
            lw[k] = (Q40Weight(w.qs[i], w.d16[i]) if isinstance(w, Q40Weight)
                     else w[i])
    return lw


def forward_seq(spec: TransformerSpec, params: dict[str, Any],
                tokens: torch.Tensor, positions: torch.Tensor | None = None,
                attention_fn: Callable | None = None,
                route: Route = PLAIN) -> torch.Tensor:
    """Batched full-sequence forward without a KV cache (the JAX package's
    models/llama.forward_seq): tokens (B, T) int64 on the weights' device
    -> logits (B, T, vocab) f32, causal attention inside the window.

    The training and evaluation path, differentiable end to end (no in-place
    write, no host read). Its weights are the dense f32 training tree
    (io/loader.densify_params): every product is ``route.dense``
    (F.linear; the JAX package computes these outside any Pallas kernel,
    so there is no hand kernel to port) and attention is
    ``attention_core``. ``positions`` (T,) are the window's absolute
    positions (default 0..T-1), each row rotated at them, and
    ``attention_fn(q, k, v) -> (B, T, n_q*hs)`` replaces the causal
    attention (parallel/sp_train's ring attention). ``route`` may wrap the
    dense product: parallel/train's tensor-parallel route adds the ref
    scheme's collectives around each banded product."""
    batch, t_len = tokens.shape
    emb = params["tok_embedding"]
    device = emb.device
    x = emb[tokens].to(torch.float32)
    if positions is None:
        positions = torch.arange(t_len, device=device)
    rope = rope_rows(rope_freq(spec.dim + spec.kv_dim, spec.head_size,
                               device), positions)
    hs = spec.head_size
    mask = torch.ones(t_len, t_len, dtype=torch.bool, device=device).tril()
    for idx in range(spec.n_layers):
        lw = _layer_view(params, idx)
        q, k, v = _qkv_proj(spec, lw, x, rope, route)
        if attention_fn is not None:
            ao = attention_fn(q, k, v)
        else:
            ao = attention_core(
                hs, spec.kv_mul, q.reshape(batch, t_len, spec.n_heads, hs),
                k.reshape(batch, t_len, spec.n_kv_heads, hs),
                v.reshape(batch, t_len, spec.n_kv_heads, hs), mask)
        x = _post_attention(spec, lw, x, ao, route)
    x = rmsnorm(x, params["rms_final"])
    return _mm(params["wcls"], x, route)


class Llama(nn.Module):
    """The forward over device-resident weights, T >= 1 tokens per call.

    ``params`` is the tree params_to_device built; the module keeps it as it
    is (Q40 pairs are not tensors, so nothing is registered as a buffer) and
    precomputes the per-layer views and the RoPE frequencies once.
    ``route`` picks the kernels (default) or their plain versions; a call
    may name another route (``FAST`` for a --fast-prefill chunk).
    ``fusion`` is the ``DLLAMA_LAYER_FUSION`` mode the engine read
    (ops/layer.fusion_mode): 'headtail' or 'on' send every T = 1 call of
    ``forward`` through ``forward_fused`` where ops/layer.supports holds
    (``self.fusion`` says which mode applies, None for the unfused path).
    """

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 route: Route = KERNELS, fusion: str = "off"):
        super().__init__()
        self.spec = spec
        self.params = params
        self.route = route
        self.fusion = (fusion if fused(fusion)
                       and fusion_supports(spec, params) else None)
        self.layers = [_layer_view(params, i) for i in range(spec.n_layers)]
        self._rows: dict = {}
        # positions the forward takes (the sp-sharded TPLlama's spec holds
        # its cache chunk, the model's positions stay); the attention
        # hooks replace the cache writes and attention where set
        self.max_pos = spec.seq_len
        self._attend: Callable | None = None
        self._batch_attend: Callable | None = None
        device = params["tok_embedding"].device
        self.register_buffer("freq", rope_freq(spec.dim + spec.kv_dim,
                                               spec.head_size, device))
        if self.fusion is not None:
            # forward's host token and position, for forward_fused's kernels
            self._token = torch.zeros(1, dtype=torch.int64, device=device)
            self._pos = torch.zeros(1, dtype=torch.int32, device=device)

    def forward(self, cache: KVCache, tokens: int | Sequence[int], pos: int,
                logits: bool = True,
                route: Route | None = None) -> torch.Tensor | None:
        """T tokens (one int, or a sequence) at positions pos..pos+T-1:
        writes their k/v into ``cache`` and returns logits (T, vocab) f32,
        or None with ``logits=False`` (prefill: the final norm and wcls are
        skipped, as the JAX prefill discards those logits). ``route``
        overrides the module's route for this call."""
        spec, p = self.spec, self.params
        route = self.route if route is None else route
        tokens = ([int(tokens)] if isinstance(tokens, (int, np.integer))
                  else [int(t) for t in tokens])
        t_len = len(tokens)
        if t_len < 1 or pos < 0 or pos + t_len > self.max_pos:
            raise ValueError(f"positions {pos}..{pos + t_len - 1} outside "
                             f"the cache (seq_len {self.max_pos})")
        if t_len == 1 and self.fusion is not None:
            self._token.fill_(tokens[0])
            self._pos.fill_(pos)
            return self.forward_fused(cache, self._token, self._pos,
                                      self.fusion, route, logits, at=pos)
        emb = p["tok_embedding"]
        with phase(SCOPE_EMBED):
            x = (emb[tokens[0]].reshape(1, -1) if t_len == 1
                 else emb[torch.tensor(tokens, device=emb.device)])
            x = x.to(torch.float32)
        rope = rope_tables(self.freq, pos, t_len)
        for idx, lw in enumerate(self.layers):
            x = _layer(spec, self._enter(x, idx), lw, cache, idx, pos, rope,
                       route, self._post, self._attend)
        x = self._enter(x, spec.n_layers)
        if not logits:
            return None
        with phase(SCOPE_LOGITS):
            return self._logits(x, route)

    # the layer loop's hooks: the single-device program here, the
    # tensor-parallel one in parallel/tp.TPLlama (its combines and gathers)

    def _enter(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        """x at the top of layer ``idx`` (idx = n_layers: after the last)."""
        return x

    def _post(self, lw: dict[str, Any], x: torch.Tensor, ao: torch.Tensor,
              route: Route) -> torch.Tensor:
        """The layer's tail after attention: x (T, dim) out."""
        return _post_attention(self.spec, lw, x, ao, route)

    def _logits(self, x: torch.Tensor, route: Route) -> torch.Tensor:
        """Final norm and wcls: logits (T, vocab)."""
        x = rmsnorm(x, self.params["rms_final"])
        return _mm(self.params["wcls"], x, route)

    def forward_fused(self, cache: KVCache, token: torch.Tensor,
                      pos: torch.Tensor, mode: str,
                      route: Route | None = None, logits: bool = True,
                      at: int | None = None) -> torch.Tensor | None:
        """One decode step through the fused layer (the JAX package's
        ``_forward_fused``): token (1,) int64 and pos (1,) int32 on the
        device, cache (L, S, n_kv, hs). Under ``mode`` 'on', where
        ops/layer.mega_supported holds, each layer is one K10 (route.mega);
        otherwise ('headtail') K8, the k/v written at (layer, pos), the
        decode attention and K9. ``at`` is the position on the host when
        the caller has it: the attention is then K2 (route.attention),
        else K5 at B = 1 (route.batch), which reads pos on the device and
        gives K2's bits. Embedding, final norm and wcls stay outside the
        fused kernels. Returns logits (1, vocab) f32, or None with
        ``logits=False``; with ``at`` None reads nothing on the host, so a
        CUDA graph can capture it."""
        spec, p = self.spec, self.params
        route = self.route if route is None else route
        if not fused(mode):
            raise ValueError(f"forward_fused: mode {mode!r}, expected on or "
                             f"headtail")
        mega = mode == "on" and mega_supported(spec)
        dim, kv_dim, hs = spec.dim, spec.kv_dim, spec.head_size
        kv_mul = spec.kv_mul
        with phase(SCOPE_EMBED):
            x = p["tok_embedding"][token].to(torch.float32)  # (1, dim)
        rows = pos.long() if at is None else None
        for idx, lw in enumerate(self.layers):
            if mega:
                x = route.mega(x, lw["wqkv"], lw["wo"], lw["w13"], lw["w2"],
                               lw["rms_att"], lw["rms_ffn"], self.freq,
                               cache.k, cache.v, idx, pos, kv_mul)
                continue
            qkv = route.head(x, lw["wqkv"], lw["rms_att"], self.freq, pos)
            q = qkv[0, :dim].reshape(spec.n_heads, hs)
            k = qkv[:, dim:dim + kv_dim].reshape(1, -1, hs)
            v = qkv[:, dim + kv_dim:].reshape(1, -1, hs)
            if at is not None:
                cache.k[idx, at].copy_(k[0])
                cache.v[idx, at].copy_(v[0])
                ao = route.attention(q, cache.k, cache.v, idx, at, kv_mul)
            else:
                cache.k[idx].index_copy_(0, rows, k.to(cache.k.dtype))
                cache.v[idx].index_copy_(0, rows, v.to(cache.v.dtype))
                ao = route.batch(q.reshape(1, spec.n_heads, hs), cache.k,
                                 cache.v, idx, pos, kv_mul)
            x = route.tail(ao, x, lw["wo"], lw["w13"], lw["w2"],
                           lw["rms_ffn"])
        if not logits:
            return None
        with phase(SCOPE_LOGITS):
            x = rmsnorm(x, p["rms_final"])
            return _mm(p["wcls"], x, route)

    def forward_batch(self, cache: KVCache, tokens: torch.Tensor,
                      pos: int | torch.Tensor,
                      route: Route | None = None) -> torch.Tensor:
        """One token for each of B sequences: tokens (B,) on the device, pos
        an int (one shared clock) or a (B,) int32 tensor (per-row clocks);
        cache (L, B, S, n_kv, hs) from init_cache_batch. Writes row b's k/v
        at (layer, b, pos[b]) and returns logits (B, vocab) f32. Reads no
        device value on the host (so a CUDA graph can capture it); the
        caller keeps every pos[b] inside the cache."""
        spec, p = self.spec, self.params
        route = self.route if route is None else route
        batch = tokens.shape[0]
        device = tokens.device
        if isinstance(pos, (int, np.integer)):
            if not 0 <= pos < self.max_pos:
                raise ValueError(f"position {pos} outside the cache "
                                 f"(seq_len {self.max_pos})")
            pos = torch.full((batch,), int(pos), dtype=torch.int32,
                             device=device)
        if pos.dtype != torch.int32 or tuple(pos.shape) != (batch,):
            raise ValueError(f"forward_batch: pos must be an int or an "
                             f"int32 ({batch},) tensor, got {pos.dtype} "
                             f"{tuple(pos.shape)}")
        n_layers, seq_len = spec.n_layers, spec.seq_len
        hs, n_kv = spec.head_size, spec.n_kv_heads
        if tuple(cache.k.shape) != (n_layers, batch, seq_len, n_kv, hs):
            raise ValueError(f"forward_batch: cache {tuple(cache.k.shape)} "
                             f"does not hold {batch} rows of this model")
        k4 = cache.k.view(n_layers * batch, seq_len, n_kv, hs)
        v4 = cache.v.view(n_layers * batch, seq_len, n_kv, hs)
        rows = self._batch_rows(batch, device)
        cols = pos.long()
        with phase(SCOPE_EMBED):
            x = p["tok_embedding"][tokens].to(torch.float32)
        rope = rope_rows(self.freq, pos)
        for idx, lw in enumerate(self.layers):
            x = self._enter(x, idx)
            with phase(SCOPE_ATTN):
                q, k, v = _qkv_proj(spec, lw, x, rope, route)
                if self._batch_attend is not None:
                    ao = self._batch_attend(k4, v4, q, k, v, rows[idx],
                                            cols, pos)
                else:
                    k4.index_put_((rows[idx], cols),
                                  k.reshape(batch, n_kv, hs).to(k4.dtype))
                    v4.index_put_((rows[idx], cols),
                                  v.reshape(batch, n_kv, hs).to(v4.dtype))
                    ao = route.batch(
                        q.reshape(batch, spec.n_heads, hs).contiguous(),
                        k4, v4, idx, pos, spec.kv_mul)
            x = self._post(lw, x, ao, route)
        x = self._enter(x, n_layers)
        with phase(SCOPE_LOGITS):
            return self._logits(x, route)

    def forward_batch_ragged(self, cache: KVCache, tokens: torch.Tensor,
                             pos: torch.Tensor,
                             route: Route | None = None) -> torch.Tensor:
        """forward_batch at per-row clocks pos (B,): each row attends only
        its own 0..pos[b], so whatever lies past a row's clock is
        invisible."""
        return self.forward_batch(cache, tokens, pos, route)

    def forward_batch_paged(self, cache, tokens: torch.Tensor,
                            pos: torch.Tensor, table: torch.Tensor,
                            route: Route | None = None) -> torch.Tensor:
        """One token for each of B rows over the paged pool: cache from
        init_cache_paged (KVCache, f32 or bf16) or init_cache_paged_q8
        (PagedKVQ8), tokens (B,) and pos (B,) int32 and the page table
        (B, seq_len // page_size) int32, all on the device. Row b's k/v
        land at its page table's (page, offset) of pos[b]; attention runs
        through K6 (K7 over Q8 pages). The rest is forward_batch's math,
        so over the same history the logits equal forward_batch_ragged's.
        Reads no device value on the host; the caller keeps each row's
        positions inside its mapped pages (or parks the row on the scrap
        page)."""
        return self._paged_window(cache, tokens[:, None], pos, table, None,
                                  route, "forward_batch_paged")[:, 0]

    def forward_batch_spec_paged(self, cache, tokens: torch.Tensor,
                                 pos: torch.Tensor, table: torch.Tensor,
                                 route: Route | None = None
                                 ) -> torch.Tensor:
        """The K-query speculative verify step over the paged pool (the
        JAX package's forward_batch_spec_paged): row b feeds tokens[b]
        (its current token and K-1 drafts, (B, K) on the device) at
        positions pos[b]..pos[b]+K-1 and gets all K next-token logit rows,
        (B, K, vocab). Every step but attention takes the B*K query rows
        as one flat batch (so the Q40 products run at T = B*K: K3 above
        8 rows); attention runs the whole window through K6/K7, query i
        seeing positions 0..pos[b]+i, after every write of the window. A
        window position past the virtual plane writes to the scrap page.
        Rejected drafts' k/v lie past the accepted position, where the
        next dispatch overwrites them before anything reads them."""
        return self._paged_window(cache, tokens, pos, table, None, route,
                                  "forward_batch_spec_paged")

    def forward_batch_mixed_paged(self, cache, tokens: torch.Tensor,
                                  pos: torch.Tensor, span: torch.Tensor,
                                  table: torch.Tensor,
                                  route: Route | None = None
                                  ) -> torch.Tensor:
        """The token-budget mixed dispatch over the paged pool (the JAX
        package's forward_batch_mixed_paged): tokens (B, T) with row b
        live in columns 0..span[b]-1 (span (B,) int32: 1 for a decode
        row, up to the budget for the prefill slice, 0 for an idle row),
        positions pos[b]..pos[b]+T-1. Offsets at or past a row's span
        write to the scrap page and give junk logit rows the caller
        discards; live rows see exactly what sequential decode would.
        Returns logits (B, T, vocab)."""
        return self._paged_window(cache, tokens, pos, table, span, route,
                                  "forward_batch_mixed_paged")

    def _paged_window(self, cache, tokens: torch.Tensor, pos: torch.Tensor,
                      table: torch.Tensor, span: torch.Tensor | None,
                      route: Route | None, name: str) -> torch.Tensor:
        """The paged forward over a (B, T) token window: logits
        (B, T, vocab)."""
        spec = self.spec
        route = self.route if route is None else route
        batch, t_len = tokens.shape
        planes, n_pages = paged_cache_planes(cache)
        ps = planes[0].shape[1]
        if pos.dtype != torch.int32 or tuple(pos.shape) != (batch,):
            raise ValueError(f"{name}: pos must be an int32 ({batch},) "
                             f"tensor, got {pos.dtype} {tuple(pos.shape)}")
        if span is not None and (span.dtype != torch.int32
                                 or tuple(span.shape) != (batch,)):
            raise ValueError(f"{name}: span must be an int32 ({batch},) "
                             f"tensor, got {span.dtype} "
                             f"{tuple(span.shape)}")
        if (table.dtype != torch.int32
                or tuple(table.shape) != (batch, spec.seq_len // ps)):
            raise ValueError(f"{name}: table must be int32 ({batch}, "
                             f"{spec.seq_len // ps}), got {table.dtype} "
                             f"{tuple(table.shape)}")
        if planes[0].shape[0] != spec.n_layers * n_pages:
            raise ValueError(f"{name}: the pool does not hold this model's "
                             f"layers")
        attend = (paged_attention_q8 if isinstance(cache, PagedKVQ8)
                  else paged_decode_attention)
        hs, kv_mul = spec.head_size, spec.kv_mul
        with phase(SCOPE_EMBED):
            x = self.params["tok_embedding"][tokens.reshape(-1)].to(
                torch.float32)
        positions = (pos[:, None] + torch.arange(
            t_len, dtype=torch.int32, device=pos.device)[None]).reshape(-1)
        rope = rope_rows(self.freq, positions)
        for idx, lw in enumerate(self.layers):
            x = self._enter(x, idx)
            with phase(SCOPE_ATTN):
                q, k, v = _qkv_proj(spec, lw, x, rope, route)
                ao = attend(hs, kv_mul, n_pages, q.reshape(batch, t_len, -1),
                            k.reshape(batch, t_len, -1),
                            v.reshape(batch, t_len, -1), *planes, idx, pos,
                            table, route, span)
            x = self._post(lw, x, ao.reshape(batch * t_len, -1), route)
        x = self._enter(x, spec.n_layers)
        with phase(SCOPE_LOGITS):
            logits = self._logits(x, route)
        return logits.reshape(batch, t_len, -1)

    def _batch_rows(self, batch: int, device) -> torch.Tensor:
        """(L, B) int64 rows layer*B + b of the (L*B, S, n_kv, hs) view,
        made once per batch size and device."""
        key = (batch, str(device))
        if key not in self._rows:
            layers = torch.arange(self.spec.n_layers, device=device)
            self._rows[key] = (layers[:, None] * batch
                               + torch.arange(batch, device=device)[None, :])
        return self._rows[key]


def params_to_device(params: dict[str, Any], device) -> dict[str, Any]:
    """Move a host numpy param tree onto ``device``: Q40 q/k/v and w1/w3 are
    fused at load into ``wqkv`` / ``w13`` (ops/linear.FUSED_LOAD, made on
    the device by q40_concat_to_device), Q40 weights take the port's
    device layout (ops/linear.q40_to_device), dense leaves keep their
    f32/f16 dtype."""
    device = torch.device(device)
    out, fused = {}, set()
    for dst, keys in FUSED_LOAD.items():
        ws = fusible(params, keys)
        if ws:
            out[dst] = q40_concat_to_device(ws, device)
            fused.update(keys)
    for k, v in params.items():
        if k in fused:
            continue
        if isinstance(v, Q40Weight):
            out[k] = q40_to_device(v, device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def params_from_reference(tree: dict[str, Any], device) -> dict[str, Any]:
    """The JAX package's numpy parameter tree -> this port's device tree.

    Q40 leaves are recognised by their ``.qs`` / ``.d16`` attributes (the
    reference's Q40Weight), so no import of the reference package is
    needed; every leaf is read through numpy."""
    host = {}
    for k, v in tree.items():
        if hasattr(v, "qs") and hasattr(v, "d16"):
            host[k] = Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
        else:
            host[k] = np.asarray(v)
    return params_to_device(host, device)
