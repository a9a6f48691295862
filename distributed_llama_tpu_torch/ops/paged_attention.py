"""Paged attention: the hand-written CUDA kernels ``csrc/paged_attention.cu``
(K6 over f32 or bf16 pages, K7 over Q8 pages: the decode step and windows
of 2) and ``csrc/paged_window.cu`` (K6w and K7w: verify and mixed windows
of WINDOW_MIN_T = 3 queries and more), their plain PyTorch versions, and
the ``--kv-quant`` setting.

They replace the JAX package's ops/pallas_paged_attention.py
``paged_decode_attention_kernel`` and its ``_q8`` twin, and the XLA gather
the JAX package sends windows of more than 8 queries to. All take the JAX
interface: q (B, t_len, n_q*hs) f32; the rank-4 pool planes (L*P, ps,
n_kv, hs) (plus the (L*P, ps, n_kv*hs/32) f16 delta planes of Q8 pages);
``layer``; ``pos`` (B,) int32 and ``table`` (B, max_pages) int32, both on
the device. Query i of row b sees keys 0..min(pos[b]+i, max_pages*ps-1)
(the budget-edge clamp), key t living at page row layer*P + table[b, t //
ps], offset t % ps. They return (B, t_len, n_q*hs) f32. The decode step
launches t_len 1, a speculative verify window t_len K and a token-budget
mixed window t_len T (the dispatch budget, 39 at 8 slots and chunk 32),
with B*t_len <= MAX_ROWS.

Below WINDOW_MIN_T, K6 and K7 run K5's walk
(``attention.decode_attention_batch``) with the paged key address: each
(row, query)'s keys are cut into splits across the grid by the plan
(``attention.decode_plan`` over B*t_len rows unless ``plan`` says
otherwise), computed on the card from the device position, and merged in
split order behind a ticket in the static scratch K5 uses
(``attention._decode_scratch``). ``paged_attention_split_model`` models the
arithmetic. Over a pool that holds a contiguous cache's values K6 gives
K5's bits under the same plan, and K7 gives K6's over the dequantized pool.

At t_len >= WINDOW_MIN_T, K6w and K7w run K4's tile design over the page
table: a block owns up to WINDOW_WARPS * 16 (query, head) items of one
(row, kv head) as the tensor cores' M, so each live key's K and V are
read once for all of the row's queries; 3xTF32 dots; each row's key tiles
cut into splits on the card (``window_plan``, ``window_splits``) and merged
in split order behind a ticket in the same static scratch at B*t_len rows.
``paged_window_model`` models the arithmetic; K7w gives K6w's bits over the
dequantized pool.

The plain versions are the JAX package's XLA gather route
(models/llama.py paged_decode_attention): row b's pages gathered in logical
order, keys masked past pos+i, then ``attention_core``; Q8 pages are
dequantized after the gather with ``dequantize_q80_planes``. They gather a
row's live keys only, so at t_len 1 they compute
``decode_attention_batch_plain``'s function with its very calls: over a
pool that holds a contiguous cache's values the two give the same bits.
They read the positions on the host (a sync on the card), which only the
kernels avoid.

The wrappers take the plain versions only for tensors on the CPU. On a
CUDA tensor they launch the kernel or raise: there is no fallback, not for
a shape the kernels do not take either.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ._build import CudaKernel
from .attention import (_KV_MULS, _MAX_HEAD, CACHE_DTYPES,
                        DECODE_MAX_SPLITS, _decode_scratch, _dot_3xtf32,
                        _plan_for, attention_core, attention_scale,
                        decode_attention_split_model, decode_plan,
                        decode_splits, decode_want)
from .q40 import sm_count
from .quants import QK, dequantize_q80_planes

KV_QUANTS = ("f32", "q8")  # the --kv-quant vocabulary (f32 = cache dtype)
MAX_ROWS = 65535  # B*t_len: K6's grid y (one (row, query) a block)

# K6w's and K7w's tiling (csrc/paged_window.cu): windows of WINDOW_MIN_T
# queries and more take them; keys a staged tile; consumer warps a block,
# each 16 (query, head) items of one key group (the warps of a group split
# the block's items, the groups its tiles); the plan aims at
# WINDOW_BLOCKS_PER_SM blocks on every SM, each split at least
# WINDOW_SPLIT_KEYS keys. The cut: at t_len 2 K6's split walk, which
# reads a row's keys twice, beat K6w over f32 pages at 7B's and 8 GQA kv
# heads' widths, 8 rows at pos 63 and 2047 (0.0171 against 0.0260 ms a
# layer at 7B, pos 63; 0.2056 against 0.2498 at pos 2047), and K6w won at
# t_len 4 at pos 2047 at every width and page kind
# (tools/window_variants.py on the H100; PERF.md)
WINDOW_MIN_T = 3
WINDOW_KEYS = 32
WINDOW_WARPS = 4
WINDOW_BLOCKS_PER_SM = 2
WINDOW_SPLIT_KEYS = 128

# (q, k4, v4, out, part, tickets, layer, pos, table, batch, t_len, n_pages,
# max_pages, ps, n_kv, kv_mul, hs, most, least, scale, stream); Q8: kq4,
# kd4, vq4, vd4 in place of k4, v4
_PAGED_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
               + [ctypes.c_float, ctypes.c_void_p])
_Q8_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p])
PAGED_KERNEL = CudaKernel("paged_attention.cu", "paged_attention",
                          _PAGED_ARGS)
PAGED_KERNEL_KVBF16 = CudaKernel("paged_attention.cu",
                                 "paged_attention_kvbf16", _PAGED_ARGS)
PAGED_KERNEL_Q8 = CudaKernel("paged_attention.cu", "paged_attention_q8",
                             _Q8_ARGS)
# the window kernels take the same arguments
WINDOW_KERNEL = CudaKernel("paged_window.cu", "paged_window", _PAGED_ARGS)
WINDOW_KERNEL_KVBF16 = CudaKernel("paged_window.cu", "paged_window_kvbf16",
                                  _PAGED_ARGS)
WINDOW_KERNEL_Q8 = CudaKernel("paged_window.cu", "paged_window_q8",
                              _Q8_ARGS)
WINDOW_KERNELS = (WINDOW_KERNEL, WINDOW_KERNEL_KVBF16, WINDOW_KERNEL_Q8)
KERNELS = (PAGED_KERNEL, PAGED_KERNEL_KVBF16, PAGED_KERNEL_Q8,
           *WINDOW_KERNELS)


def kv_quant_mode() -> str:
    """The KV page quantization in effect: DLLAMA_KV_QUANT=f32|q8 (unset or
    empty = f32). Unknown values raise: a typo would otherwise silently
    serve f32 pages. The CLI and the engine read it once and pass it down."""
    env = os.environ.get("DLLAMA_KV_QUANT") or "f32"
    if env not in KV_QUANTS:
        raise ValueError(f"DLLAMA_KV_QUANT={env!r}: expected "
                         f"{'|'.join(KV_QUANTS)}")
    return env


def supports_paged(page_size: int, n_kv: int, head_size: int, t_len: int,
                   kv_mul: int = 1, q8: bool = False) -> bool:
    """The shapes the kernels take: t_len >= 1 queries a row (the caller
    checks B*t_len <= MAX_ROWS), kv_mul in {1, 2, 4, 8}, a head size up to
    128 and any page size; below WINDOW_MIN_T (K6, K7) a head size that is
    a multiple of 4, and Q8 pages also need the flattened (n_kv, hs) row to
    divide into 32-value blocks; at t_len >= WINDOW_MIN_T (K6w, K7w) a
    multiple of 8 (the MMA's k8 steps), and over Q8 pages of 64 (a head's
    deltas are whole 4-byte words). (The JAX gate's VMEM budget, which
    sends t_len > 8 to its XLA gather, has no counterpart.) A CUDA call
    outside them raises."""
    if q8 and (n_kv * head_size) % QK:
        return False
    step = 4 if t_len < WINDOW_MIN_T else 64 if q8 else 8
    return (t_len >= 1 and kv_mul in _KV_MULS
            and head_size % step == 0 and 0 < head_size <= _MAX_HEAD
            and page_size >= 1)


def _paged_plain(q: torch.Tensor, read, layer: int, pos: torch.Tensor,
                 table: torch.Tensor, n_pages: int, page_size: int,
                 kv_mul: int) -> torch.Tensor:
    """The gather route over ``read(rows) -> (k, v)``, each (n, ps, n_kv,
    hs) for the n page rows ``rows``: row b's live pages in logical order,
    keys 0..min(pos[b]+i, S-1) for query i, attention_core per row."""
    batch, t_len, _ = q.shape
    s_virt = table.shape[1] * page_size
    outs = []
    # dlint: allow[D001] plain version: host positions
    for b, p in enumerate(pos.tolist()):
        last = min(p + t_len - 1, s_virt - 1)
        n_live = last // page_size + 1
        rows = layer * n_pages + table[b, :n_live].long()
        k, v = read(rows)
        hs = k.shape[-1]
        k = k.reshape(n_live * page_size, *k.shape[2:])[:last + 1]
        v = v.reshape(n_live * page_size, *v.shape[2:])[:last + 1]
        mask = None
        if t_len > 1:
            sees = torch.clamp(torch.arange(p, p + t_len, device=q.device),
                               max=s_virt - 1)
            mask = (torch.arange(last + 1, device=q.device)[None, :]
                    <= sees[:, None])
        outs.append(attention_core(hs, kv_mul, q[b].reshape(t_len, -1, hs),
                                   k, v, mask))
    return torch.stack(outs)


def paged_decode_attention_plain(q: torch.Tensor, k4: torch.Tensor,
                                 v4: torch.Tensor, layer: int,
                                 pos: torch.Tensor, table: torch.Tensor,
                                 n_pages: int, kv_mul: int) -> torch.Tensor:
    """K6's function: q (B, t_len, n_q*hs) over f32/bf16 pages ->
    (B, t_len, n_q*hs) f32."""
    return _paged_plain(q, lambda rows: (k4[rows], v4[rows]), layer, pos,
                        table, n_pages, k4.shape[1], kv_mul)


def paged_decode_attention_q8_plain(q: torch.Tensor, kq4: torch.Tensor,
                                    kd4: torch.Tensor, vq4: torch.Tensor,
                                    vd4: torch.Tensor, layer: int,
                                    pos: torch.Tensor, table: torch.Tensor,
                                    n_pages: int,
                                    kv_mul: int) -> torch.Tensor:
    """K7's function: the gather route after ``dequantize_q80_planes`` of
    the gathered code and delta rows."""
    def read(rows):
        return (dequantize_q80_planes(kq4[rows], kd4[rows]),
                dequantize_q80_planes(vq4[rows], vd4[rows]))

    return _paged_plain(q, read, layer, pos, table, n_pages, kq4.shape[1],
                        kv_mul)


def paged_plan(n_kv: int, batch: int, t_len: int,
               sms: int) -> tuple[int, int]:
    """K6's and K7's default plan: decode_plan over the launch's B*t_len
    (row, query) items, so at t_len 1 K5's plan for the same rows."""
    return decode_plan(n_kv, batch * t_len, sms)


def window_tiles(t_len: int, kv_mul: int,
                 bf16: bool = False) -> tuple[int, int, int]:
    """(item warps, key groups, item tiles a (row, kv head)) of K6w and
    K7w: the t_len * kv_mul (query, head) items of a row's kv head in
    tiles of up to WINDOW_WARPS warps of 16 items; each key group's warps
    take every group-th key tile of the split: two groups at one or two
    item warps (three at one over bf16 pages), one above
    (csrc/paged_window.cu window_groups)."""
    items = t_len * kv_mul
    warps = min(WINDOW_WARPS, -(-items // 16))
    groups = (3 if bf16 else 2) if warps == 1 else 2 if warps == 2 else 1
    return warps, groups, -(-items // (16 * warps))


def window_plan(n_kv: int, batch: int, t_len: int, kv_mul: int,
                sms: int) -> tuple[int, int]:
    """K6w's and K7w's default plan (most, least): at most ``most`` splits
    a row, as many as put WINDOW_BLOCKS_PER_SM blocks on every SM over the
    (item tile x kv head x row) grid (at most DECODE_MAX_SPLITS), each of
    at least ``least`` = WINDOW_SPLIT_KEYS keys."""
    blocks = n_kv * batch * window_tiles(t_len, kv_mul)[2]
    most = WINDOW_BLOCKS_PER_SM * sms // blocks
    return max(1, min(DECODE_MAX_SPLITS, most)), WINDOW_SPLIT_KEYS


def _window_tile_plan(plan: tuple[int, int]) -> tuple[int, int]:
    """A plan's (most, least) with least in whole WINDOW_KEYS tiles."""
    most, least = plan
    return most, -(-least // WINDOW_KEYS)


def window_want(keys: int, plan: tuple[int, int]) -> int:
    """The most splits a row of ``keys`` live keys may take under
    ``plan``: decode_want over its tiles; it grows with ``keys``, so the
    grid, sized by the clamped virtual plane's keys, covers every row's
    plan (csrc/paged_window.cu launch)."""
    return decode_want(-(-keys // WINDOW_KEYS), _window_tile_plan(plan))


def window_splits(keys: int, plan: tuple[int, int]) -> tuple[int, int]:
    """(splits, tiles a split) of a row whose deepest query sees ``keys``
    keys: decode_splits over its WINDOW_KEYS tiles, ``least`` rounded up
    to whole tiles; the kernels compute the same on the card."""
    return decode_splits(-(-keys // WINDOW_KEYS), _window_tile_plan(plan))


def _reader(planes):
    """``read(rows) -> (k, v)`` of page rows ``rows`` as stored (f32 or
    bf16), Q8 pages dequantized after the gather."""
    if len(planes) == 4:
        kq4, kd4, vq4, vd4 = planes

        def read(rows):
            return (dequantize_q80_planes(kq4[rows], kd4[rows]),
                    dequantize_q80_planes(vq4[rows], vd4[rows]))
    else:
        def read(rows):
            return planes[0][rows], planes[1][rows]
    return read


def paged_window_model(q: torch.Tensor, planes, layer: int, pos,
                       table: torch.Tensor, n_pages: int, kv_mul: int,
                       plan: tuple[int, int] | None = None) -> torch.Tensor:
    """K6w's and K7w's arithmetic in plain torch, in the kernels' order (a
    model for the tests; no route calls it). For row b, its live keys
    0..min(pos[b]+t_len-1, max_pages*ps-1) gathered in logical order (Q8
    pages dequantized after the gather), its tiles of WINDOW_KEYS keys cut
    as window_splits says under ``plan`` (default window_plan on this
    device's SMs); per kv head, the (query, head) items i*kv_mul+m walk
    each split's tiles in window_tiles' key groups (group k takes tiles
    k, k + G, ... of the split), each with its online softmax
    (_window_walk), the groups merged in group order (_merge_groups), then
    the splits in split order (m = max m_j, w_j = e^(m_j - m), l = sum
    l_j w_j, o = sum o_j w_j), out = o / l. ``planes`` is (k4, v4) or
    (kq4, kd4, vq4, vd4); q (B, t_len, n_q*hs) -> (B, t_len, n_q*hs)
    f32."""
    batch, t_len, _ = q.shape
    ps, n_kv, hs = planes[0].shape[1:]
    if plan is None:
        plan = window_plan(n_kv, batch, t_len, kv_mul, sm_count(q.device))
    else:
        plan = _plan_for(plan, n_kv, batch * t_len, q.device)
    s_virt = table.shape[1] * ps
    read = _reader(planes)
    scale = attention_scale(hs)
    items = t_len * kv_mul
    groups = window_tiles(t_len, kv_mul,
                          planes[0].dtype == torch.bfloat16)[1]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b, p in enumerate(int(x) for x in pos):
        keys = min(p + t_len - 1, s_virt - 1) + 1
        splits, per = window_splits(keys, plan)
        tiles = -(-keys // WINDOW_KEYS)
        n_live = (keys - 1) // ps + 1
        k, v = read(layer * n_pages + table[b, :n_live].long())
        # (n_kv, keys, hs) in logical order
        k = k.to(torch.float32).reshape(-1, n_kv, hs)[:keys].transpose(0, 1)
        v = v.to(torch.float32).reshape(-1, n_kv, hs)[:keys].transpose(0, 1)
        qg = q[b].to(torch.float32).reshape(t_len, n_kv, kv_mul, hs) \
            .permute(1, 0, 2, 3).reshape(n_kv, items, hs)
        lim = torch.clamp(torch.arange(p, p + t_len, device=q.device),
                          max=s_virt - 1).repeat_interleave(kv_mul)
        parts = []
        for j in range(splits):
            run = range(j * per, min(tiles, (j + 1) * per))
            parts.append(_merge_groups([
                _window_walk(qg, k, v, lim, keys, run[kg::groups], scale)
                for kg in range(groups)]))
        if splits == 1:
            _, l, o = parts[0]
        else:
            mx = torch.stack([mj for mj, _, _ in parts]).amax(dim=0)
            l = torch.zeros_like(mx)
            o = torch.zeros((n_kv, items, hs), device=q.device)
            for mj, lj, oj in parts:
                w = torch.exp(mj - mx)
                l = l + lj * w
                o = o + oj * w[..., None]
        res = o / l[..., None]
        out[b] = res.reshape(n_kv, t_len, kv_mul, hs).permute(1, 0, 2, 3) \
            .reshape(t_len, -1)
    return out


def _window_walk(qg, k, v, lim, keys, tiles, scale):
    """One key group's online softmax over ``tiles`` (K6w's consumer
    loop): (m, l, unnormalised o) of the (n_kv, items, hs) items qg, item
    r seeing keys up to lim[r]."""
    n_kv, items, hs = qg.shape
    m = torch.full((n_kv, items), float("-inf"), device=qg.device)
    l = torch.zeros((n_kv, items), device=qg.device)
    o = torch.zeros((n_kv, items, hs), device=qg.device)
    for tile in tiles:
        lo, hi = tile * WINDOW_KEYS, min(keys, (tile + 1) * WINDOW_KEYS)
        s = _dot_3xtf32(qg, k[:, lo:hi], "gid,gkd->gik") * scale
        seen = (torch.arange(lo, hi, device=qg.device)[None, :]
                <= lim[:, None])
        s = s.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - base[..., None])
        corr = torch.exp(m - base)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + _dot_3xtf32(p, v[:, lo:hi], "gik,gkd->gid")
        m = m_new
    return m, l, o


def _merge_groups(states):
    """The key groups' (m, l, o) merged in group order as K6w's group 0
    merges them: M = max m_k, base 0 while M is -inf (a split none of
    whose keys an item sees), w_k = e^(m_k - base), l = sum l_k w_k, o =
    sum o_k w_k."""
    if len(states) == 1:
        return states[0]
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    base = torch.where(mx == float("-inf"), 0.0, mx)
    l = o = None
    for m, lk, ok in states:
        w = torch.exp(m - base)
        l = lk * w if l is None else l + lk * w
        o = ok * w[..., None] if o is None else o + ok * w[..., None]
    return mx, l, o


def paged_attention_split_model(q: torch.Tensor, planes, layer: int,
                                pos, table: torch.Tensor, n_pages: int,
                                kv_mul: int,
                                plan: tuple[int, int]) -> torch.Tensor:
    """K6's and K7's split arithmetic in plain torch (a model for the
    tests; no route calls it): for each (row b, query i), row b's live
    pages gathered in logical order up to the clamp min(pos[b]+i,
    max_pages*ps-1) (Q8 pages dequantized after the gather), then
    ``attention.decode_attention_split_model`` under ``plan`` over them as
    a one-row contiguous cache. ``planes`` is (k4, v4) or (kq4, kd4, vq4,
    vd4); q (B, t_len, n_q*hs) -> (B, t_len, n_q*hs)."""
    batch, t_len, _ = q.shape
    ps, n_kv, hs = planes[0].shape[1:]
    plan = _plan_for(plan, n_kv, batch * t_len, q.device)
    s_virt = table.shape[1] * ps
    read = _reader(planes)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b, p in enumerate(int(x) for x in pos):
        for i in range(t_len):
            last = min(p + i, s_virt - 1)
            n_live = last // ps + 1
            k, v = read(layer * n_pages + table[b, :n_live].long())
            k = k.reshape(1, n_live * ps, n_kv, hs)
            v = v.reshape(1, n_live * ps, n_kv, hs)
            out[b, i] = decode_attention_split_model(
                q[b, i].reshape(n_kv * kv_mul, hs), k, v, 0, last, kv_mul,
                plan)[0]
    return out


def _check(name, q, planes, layer, pos, table, n_pages, kv_mul,
           q8: bool) -> None:
    if q.dim() != 3 or q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be a contiguous float32 (B, t_len, "
                         f"n_q*hs), got {q.dtype} {tuple(q.shape)}")
    batch, t_len = q.shape[0], q.shape[1]
    k4 = planes[0]
    if k4.dim() != 4:
        raise ValueError(f"{name}: pages must be (L*P, ps, n_kv, hs), got "
                         f"{tuple(k4.shape)}")
    rows, ps, n_kv, hs = k4.shape
    if q8:
        kq4, kd4, vq4, vd4 = planes
        nb = n_kv * hs // QK
        if (kq4.dtype != torch.int8 or vq4.dtype != torch.int8
                or vq4.shape != kq4.shape
                or kd4.dtype != torch.float16 or vd4.dtype != torch.float16
                or tuple(kd4.shape) != (rows, ps, nb)
                or vd4.shape != kd4.shape):
            raise ValueError(f"{name}: Q8 pages must be int8 codes (L*P, ps, "
                             f"n_kv, hs) and f16 deltas (L*P, ps, {nb})")
    else:
        v4 = planes[1]
        if k4.dtype not in CACHE_DTYPES or v4.dtype != k4.dtype \
                or v4.shape != k4.shape:
            raise ValueError(f"{name}: pages must be equal float32 or "
                             f"bfloat16 planes, got {k4.dtype} "
                             f"{tuple(k4.shape)} and {v4.dtype} "
                             f"{tuple(v4.shape)}")
    for t in (q, *planes):
        if t.device != q.device:
            raise ValueError(f"{name}: every tensor must lie on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             f"16-byte aligned")
    if not supports_paged(ps, n_kv, hs, t_len, kv_mul, q8) \
            or batch * t_len > MAX_ROWS:
        raise ValueError(f"{name}: the kernels take B*t_len <= {MAX_ROWS}, "
                         f"kv_mul in {_KV_MULS} and a head size up to "
                         f"{_MAX_HEAD} that is a multiple of 4 below t_len "
                         f"{WINDOW_MIN_T} and of 8 from it on (Q8: n_kv*hs "
                         f"a multiple of {QK}, and hs of 64 from t_len "
                         f"{WINDOW_MIN_T} on), got B={batch} "
                         f"t_len={t_len} kv_mul={kv_mul} n_kv={n_kv} "
                         f"hs={hs}")
    if q.shape[2] != n_kv * kv_mul * hs:
        raise ValueError(f"{name}: q rows must hold {n_kv * kv_mul * hs} "
                         f"values, got {q.shape[2]}")
    if n_pages < 1 or rows % n_pages or not 0 <= layer < rows // n_pages:
        raise ValueError(f"{name}: layer {layer} of {n_pages} pages out of "
                         f"range for {rows} page rows")
    if (pos.dtype != torch.int32 or tuple(pos.shape) != (batch,)
            or pos.device != q.device or not pos.is_contiguous()):
        raise ValueError(f"{name}: pos must be a contiguous int32 ({batch},) "
                         f"on {q.device}")
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[0] != batch or table.device != q.device
            or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be a contiguous int32 "
                         f"({batch}, max_pages) on {q.device}")


def _launch(kernels, q, planes, layer, pos, table, n_pages, kv_mul, plan):
    """One launch over the B*t_len (row, query) pairs, with K5's scratch
    for as many rows: below WINDOW_MIN_T ``kernels[0]`` (K6 or K7), its keys
    split
    as ``plan`` (default paged_plan) says; at t_len >= WINDOW_MIN_T
    ``kernels[1]`` (K6w or K7w), each row's key tiles split as ``plan``
    (default window_plan) says."""
    batch, t_len, _ = q.shape
    _, ps, n_kv, hs = planes[0].shape
    rows = batch * t_len
    window = t_len >= WINDOW_MIN_T
    sms = sm_count(q.device)
    most, least = plan or (
        window_plan(n_kv, batch, t_len, kv_mul, sms) if window
        else paged_plan(n_kv, batch, t_len, sms))
    out = torch.empty_like(q)
    kernels[window].launch(
        q.data_ptr(), *(p.data_ptr() for p in planes), out.data_ptr(),
        *_decode_scratch(q.device, rows, n_kv, kv_mul, hs, most), layer,
        pos.data_ptr(), table.data_ptr(), batch, t_len, n_pages,
        table.shape[1], ps, n_kv, kv_mul, hs, most, least,
        attention_scale(hs), torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_decode_attention(q: torch.Tensor, k4: torch.Tensor,
                           v4: torch.Tensor, layer: int, pos: torch.Tensor,
                           table: torch.Tensor, n_pages: int, kv_mul: int,
                           plan: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """Attention of t_len queries per row over f32/bf16 pages (see the
    module docstring). CPU tensors take the plain version; CUDA tensors
    launch K6 below WINDOW_MIN_T and K6w from it on, built for the
    page dtype, which read pos and the table on the device and split each
    row's keys as ``plan`` (default paged_plan below WINDOW_MIN_T,
    window_plan from it on) says. A bad plan raises on either."""
    if plan is not None:
        plan = _plan_for(plan, k4.shape[2], q.shape[0] * q.shape[1],
                         q.device)
    if q.device.type == "cpu" and k4.device.type == "cpu":
        return paged_decode_attention_plain(q, k4, v4, layer, pos, table,
                                            n_pages, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check("paged_decode_attention", q, (k4, v4), layer, pos, table,
           n_pages, kv_mul, q8=False)
    kernels = ((PAGED_KERNEL, WINDOW_KERNEL) if k4.dtype == torch.float32
               else (PAGED_KERNEL_KVBF16, WINDOW_KERNEL_KVBF16))
    return _launch(kernels, q, (k4, v4), layer, pos, table, n_pages, kv_mul,
                   plan)


def paged_decode_attention_q8(q: torch.Tensor, kq4: torch.Tensor,
                              kd4: torch.Tensor, vq4: torch.Tensor,
                              vd4: torch.Tensor, layer: int,
                              pos: torch.Tensor, table: torch.Tensor,
                              n_pages: int, kv_mul: int,
                              plan: tuple[int, int] | None = None
                              ) -> torch.Tensor:
    """paged_decode_attention over Q8 pages: CPU tensors take the plain
    version; CUDA tensors launch K7 (t_len below WINDOW_MIN_T) or K7w
    (from it on), which widen the codes exactly and then run K6's or
    K6w's f32 arithmetic, their keys split as ``plan`` says."""
    if plan is not None:
        plan = _plan_for(plan, kq4.shape[2], q.shape[0] * q.shape[1],
                         q.device)
    if q.device.type == "cpu" and kq4.device.type == "cpu":
        return paged_decode_attention_q8_plain(q, kq4, kd4, vq4, vd4, layer,
                                               pos, table, n_pages, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_q8: no kernel for device "
                         f"{q.device}")
    planes = (kq4, kd4, vq4, vd4)
    _check("paged_decode_attention_q8", q, planes, layer, pos, table,
           n_pages, kv_mul, q8=True)
    return _launch((PAGED_KERNEL_Q8, WINDOW_KERNEL_Q8), q, planes, layer, pos,
                   table, n_pages, kv_mul, plan)
