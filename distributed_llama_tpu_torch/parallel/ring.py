"""Sequence parallelism: the sp-sharded KV cache (the JAX package's
parallel/ring.py up to ``update_sp_cache``), and ``ring_attention``, its
training half.

The KV cache is sharded over the sp ranks in contiguous position chunks:
rank s holds positions [s*C, (s+1)*C) of every layer, C = seq_len / sp. x
is replicated over sp, so every sp rank computes the same q, k and v; each
writes only the rows of its own chunk (``update_sp_cache``) and scores q
against its chunk with flash-style running statistics (``_partial_attention``,
or ``blockwise_chunk_partials`` over the live blocks of a T > 8 prefill
chunk). The partials combine across sp with a log-sum-exp reduction
(``_lse_combine_partials``: a pmax of the maxes, then a psum each of the
rescaled sums and values), so per layer the wire carries (m, l, o) per
head and query, never k/v: three collectives a layer
(parallel/comm_stats.sp_lse_bytes).

The JAX package computes these in XLA (jnp partials, never Pallas); here
they are plain torch on the rank's device, in f32 (the JAX package's
HIGHEST precision). The collectives are the caller's ``pmax``/``psum``
(parallel/collectives.sp_pmax / sp_psum over the group's sp sub-group), so
the tests can run the combine over stacked shards.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _lse_combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                          pmax: Callable, psum: Callable) -> torch.Tensor:
    """Combine flash partials across the sp ranks: m (..., 1) the running
    max of the scores, l (..., 1) the sum of exp(score - m), o (..., hs)
    the sum of exp(score - m) * v. Returns the exact softmax-weighted value
    sum over the union of every rank's keys."""
    g_m = pmax(m.clone())
    corr = torch.exp(m - g_m)  # each rank rescaled to the global max
    g_l = psum(l * corr)
    g_o = psum(o * corr)
    return g_o / torch.clamp(g_l, min=1e-38)


def _lse_merge(m, l, o, pm, pl, po):
    """Merge one flash partial into the running (m, l, o), -inf-safe on
    both sides (a row that has seen no visible key stays zero)."""
    m_new = torch.maximum(m, pm)
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    c_old = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    c_new = torch.where(torch.isfinite(pm), torch.exp(pm - m_safe),
                        torch.zeros_like(pm))
    return m_new, l * c_old + pl * c_new, o * c_old + po * c_new


def _partial_attention(head_size: int, kv_mul: int, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor):
    """Flash partials of q (..., T, n_q, hs) against one key chunk k/v
    (..., C, n_kv, hs) with the same leading dims (a training batch);
    valid (T, C) is True where the key is visible. Returns m (..., T, n_q,
    1), l (..., T, n_q, 1), o (..., T, n_q, hs), f32. Differentiable: a
    row that sees no key gets m = -inf, l = 0, o = 0 and zero
    gradients."""
    *lead, t_len, n_q, _ = q.shape
    n_kv = k.shape[-2]
    qg = q.float().reshape(*lead, t_len, n_kv, kv_mul, head_size)
    scale = 1.0 / math.sqrt(head_size)
    s = torch.einsum("...tgmd,...cgd->...gmtc", qg, k.float()) * scale
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)                     # (..., g, m, T, 1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    p = torch.where(finite, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...gmtc,...cgd->...gmtd", p, v.float())

    def rows(a):  # (..., g, m, T, x) -> (..., T, n_q, x)
        a = a.movedim(-2, -4)
        return a.reshape(*lead, t_len, n_q, a.shape[-1])

    return rows(m), rows(l), rows(o)


def blockwise_chunk_partials(head_size: int, kv_mul: int, q: torch.Tensor,
                             k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                             chunk_start: int, q_pos: torch.Tensor,
                             last_q: int, block: int = 512):
    """_partial_attention over the blocks of one chunk that the causal
    mask can reach: blocks starting past ``last_q`` (the deepest query's
    position, on the host) are never read; the rest are merged by
    _lse_merge. A chunk wholly past the queries gives m = -inf, l = 0,
    o = 0, as the dense partial does."""
    t_len, n_q, _ = q.shape
    c = k_chunk.shape[0]
    blk = block
    while c % blk:  # the JAX package's divisor fallback
        blk //= 2
        if blk < 8:
            blk = c
            break
    n_live = min(max((last_q + 1 - chunk_start + blk - 1) // blk, 0),
                 c // blk)
    dev = q.device
    m = torch.full((t_len, n_q, 1), float("-inf"), device=dev)
    l = torch.zeros((t_len, n_q, 1), device=dev)
    o = torch.zeros((t_len, n_q, head_size), device=dev)
    for b in range(n_live):
        key_pos = chunk_start + b * blk + torch.arange(blk, device=dev)
        valid = key_pos[None, :] <= q_pos[:, None]
        pm, pl, po = _partial_attention(
            head_size, kv_mul, q, k_chunk[b * blk:(b + 1) * blk],
            v_chunk[b * blk:(b + 1) * blk], valid)
        m, l, o = _lse_merge(m, l, o, pm, pl, po)
    return m, l, o


def sp_cache_attention(head_size: int, kv_mul: int, seq_chunk: int,
                       sp_index: int, q: torch.Tensor, k_chunk: torch.Tensor,
                       v_chunk: torch.Tensor, pos: int, pmax: Callable,
                       psum: Callable) -> torch.Tensor:
    """Attention over the sp-sharded cache: q (T, n_q, hs) replicated over
    sp, k/v_chunk (C, n_kv, hs) this rank's positions [sp_index*C,
    (sp_index+1)*C), ``pos`` the first query's absolute position (host).
    Returns (T, n_q*hs): the exact softmax over the global prefix
    0..pos+T-1. A window of more than 8 queries walks the live blocks
    (blockwise_chunk_partials), a shorter one scores the whole chunk
    under the mask."""
    t_len = q.shape[0]
    q_pos = pos + torch.arange(t_len, device=q.device)
    start = sp_index * seq_chunk
    if t_len > 8:
        m, l, o = blockwise_chunk_partials(head_size, kv_mul, q, k_chunk,
                                           v_chunk, start, q_pos,
                                           pos + t_len - 1)
    else:
        key_pos = start + torch.arange(seq_chunk, device=q.device)
        valid = key_pos[None, :] <= q_pos[:, None]
        m, l, o = _partial_attention(head_size, kv_mul, q, k_chunk, v_chunk,
                                     valid)
    out = _lse_combine_partials(m, l, o, pmax, psum)
    return out.reshape(t_len, -1)


def sp_batch_attention(head_size: int, kv_mul: int, seq_chunk: int,
                       sp_index: int, q: torch.Tensor, k_rows: torch.Tensor,
                       v_rows: torch.Tensor, pos: torch.Tensor,
                       pmax: Callable, psum: Callable) -> torch.Tensor:
    """One query a row over the sp-sharded batch cache (the JAX package's
    _batch_sp_attention, its per-row sp_cache_attention under vmap): q
    (B, n_q, hs), k/v_rows (B, C, n_kv, hs) each row's local chunk, pos
    (B,) int32 each row's clock on the device. Reads nothing on the host.
    Returns (B, n_q*hs)."""
    batch, n_q, _ = q.shape
    n_kv = k_rows.shape[2]
    key_pos = sp_index * seq_chunk + torch.arange(seq_chunk,
                                                  device=q.device)
    valid = key_pos[None, :] <= pos.long()[:, None]         # (B, C)
    qg = q.float().reshape(batch, n_kv, kv_mul, head_size)
    s = torch.einsum("bgmd,bcgd->bgmc", qg, k_rows.float())
    s = s * (1.0 / math.sqrt(head_size))
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    p = torch.where(finite, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgmc,bcgd->bgmd", p, v_rows.float())
    out = _lse_combine_partials(m.reshape(batch, n_q, 1),
                                l.reshape(batch, n_q, 1),
                                o.reshape(batch, n_q, head_size), pmax, psum)
    return out.reshape(batch, -1)


def update_sp_cache(cache_chunk: torch.Tensor, new_vals: torch.Tensor,
                    pos: int, sp_index: int, seq_chunk: int) -> torch.Tensor:
    """Write T new rows (T, n_kv, hs) at absolute positions pos.. into the
    local chunk (C, n_kv, hs) IN PLACE: rows outside this rank's range
    are dropped, so a window straddling a chunk boundary lands on both
    ranks in its two parts. Returns the chunk."""
    t_len = new_vals.shape[0]
    first = pos - sp_index * seq_chunk  # local row of new_vals[0]
    lo, hi = max(first, 0), min(first + t_len, seq_chunk)
    if lo < hi:
        cache_chunk[lo:hi].copy_(new_vals[lo - first:hi - first])
    return cache_chunk


def update_sp_rows(rows: torch.Tensor, cols: torch.Tensor,
                   plane: torch.Tensor, new_vals: torch.Tensor,
                   sp_index: int, seq_chunk: int) -> None:
    """The batch form of update_sp_cache, reading nothing on the host: row
    b's value (B, n_kv, hs) lands at local position cols[b] - sp_index*C
    of plane row rows[b] (plane (R, C, n_kv, hs)) when that lies in this
    rank's chunk; elsewhere the row's old value is written back."""
    local = cols - sp_index * seq_chunk
    belongs = (local >= 0) & (local < seq_chunk)
    at = local.clamp(0, seq_chunk - 1)
    old = plane[rows, at]
    plane.index_put_((rows, at), torch.where(
        belongs[:, None, None], new_vals.to(plane.dtype), old))


def ring_attention(head_size: int, kv_mul: int, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, q_start: int,
                   chunk: int, group) -> torch.Tensor:
    """Causal ring attention for full sequences (the JAX package's
    parallel/ring.ring_attention): q (..., T_loc, n_q, hs) and k/v
    (..., T_loc, n_kv, hs) are this rank's chunk, starting at absolute
    position ``q_start``; ``group`` a parallel/mesh.TPGroup whose sp ring
    the K/V chunks rotate around (the chunk held at step i came from sp
    rank (sp_index + i) mod S). Returns (..., T_loc, n_q * hs), the exact
    causal softmax over every rank's keys; differentiable."""
    from .collectives import ring_hop

    n = group.sp_size
    *lead, t_len, n_q, _ = q.shape
    dev = q.device
    q_pos = q_start + torch.arange(t_len, device=dev)
    m = torch.full((*lead, t_len, n_q, 1), float("-inf"), device=dev)
    l = torch.zeros((*lead, t_len, n_q, 1), device=dev)
    o = torch.zeros((*lead, t_len, n_q, head_size), device=dev)
    kv = torch.stack([k.float(), v.float()])
    for i in range(n):
        src = (group.sp_rank + i) % n
        key_pos = src * chunk + torch.arange(chunk, device=dev)
        valid = key_pos[None, :] <= q_pos[:, None]
        pm, pl, po = _partial_attention(head_size, kv_mul, q, kv[0], kv[1],
                                        valid)
        m, l, o = _lse_merge(m, l, o, pm, pl, po)
        if i + 1 < n:
            kv = ring_hop(kv, group)
    out = o / torch.clamp(l, min=1e-38)
    return out.reshape(*lead, t_len, n_q * head_size)
