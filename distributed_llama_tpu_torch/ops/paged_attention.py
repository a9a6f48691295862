"""Paged decode attention: the hand-written CUDA kernels
``csrc/paged_attention.cu`` (K6 over f32 or bf16 pages, K7 over Q8 pages),
their plain PyTorch versions, and the ``--kv-quant`` setting.

K6 replaces the JAX package's ops/pallas_paged_attention.py
``paged_decode_attention_kernel`` and K7 its ``_q8`` twin. Both take the
JAX interface: q (B, t_len, n_q*hs) f32; the rank-4 pool planes (L*P, ps,
n_kv, hs) (plus the (L*P, ps, n_kv*hs/32) f16 delta planes of Q8 pages);
``layer``; ``pos`` (B,) int32 and ``table`` (B, max_pages) int32, both on
the device. Query i of row b sees keys 0..min(pos[b]+i, max_pages*ps-1)
(the budget-edge clamp), key t living at page row layer*P + table[b, t //
ps], offset t % ps. They return (B, t_len, n_q*hs) f32. The decode step
launches t_len 1, a speculative verify window t_len K and a token-budget
mixed window t_len T (the dispatch budget, 39 at 8 slots and chunk 32):
the kernels take any t_len with B*t_len <= MAX_ROWS (the launch's grid y
holds one (row, query) a block, and the plan and scratch are sized by
B*t_len; nothing in a block depends on t_len).

The kernels run K5's walk (``attention.decode_attention_batch``) with the
paged key address: each (row, query)'s keys are cut into splits across the
grid by the plan (``attention.decode_plan`` over B*t_len rows unless
``plan`` says otherwise), computed on the card from the device position,
and merged in split order behind a ticket in the static scratch K5 uses
(``attention._decode_scratch``). ``paged_attention_split_model`` models the
arithmetic. At t_len 1, over a pool that holds a contiguous cache's values,
K6 gives K5's bits under the same plan, and K7 gives K6's over the
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
from .attention import (_KV_MULS, _MAX_HEAD, CACHE_DTYPES, _decode_scratch,
                        _plan_for, attention_core, attention_scale,
                        decode_attention_split_model, decode_plan)
from .q40 import sm_count
from .quants import QK, dequantize_q80_planes

KV_QUANTS = ("f32", "q8")  # the --kv-quant vocabulary (f32 = cache dtype)
MAX_ROWS = 65535  # B*t_len, the launch's grid y (one (row, query) a block)

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
KERNELS = (PAGED_KERNEL, PAGED_KERNEL_KVBF16, PAGED_KERNEL_Q8)


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
    """The shapes K6 and K7 take: t_len >= 1 queries a row (the caller
    checks B*t_len <= MAX_ROWS), kv_mul in {1, 2, 4, 8}, a head size that
    is a multiple of 4 up to 128, any page size; Q8 pages also need the
    flattened (n_kv, hs) row to divide into 32-value blocks. (The JAX
    gate's VMEM budget, which sends t_len > 8 to its XLA gather, has no
    counterpart: a block holds one query and no page.) A CUDA call
    outside them raises."""
    if q8 and (n_kv * head_size) % QK:
        return False
    return (t_len >= 1 and kv_mul in _KV_MULS
            and head_size % 4 == 0 and head_size <= _MAX_HEAD
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
    if len(planes) == 4:
        kq4, kd4, vq4, vd4 = planes

        def read(rows):
            return (dequantize_q80_planes(kq4[rows], kd4[rows]),
                    dequantize_q80_planes(vq4[rows], vd4[rows]))
    else:
        def read(rows):
            return planes[0][rows], planes[1][rows]
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
        raise ValueError(f"{name}: the kernel takes B*t_len <= {MAX_ROWS}, "
                         f"kv_mul in {_KV_MULS} and a head size that is a "
                         f"multiple of 4 up to {_MAX_HEAD} (Q8: n_kv*hs a "
                         f"multiple of {QK}), got B={batch} t_len={t_len} "
                         f"kv_mul={kv_mul} n_kv={n_kv} hs={hs}")
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


def _launch(kernel, q, planes, layer, pos, table, n_pages, kv_mul, plan):
    """One launch over B*t_len rows of queries, split as ``plan`` (default
    paged_plan) says, with K5's scratch for as many rows."""
    batch, t_len, _ = q.shape
    _, ps, n_kv, hs = planes[0].shape
    rows = batch * t_len
    most, least = plan or paged_plan(n_kv, batch, t_len, sm_count(q.device))
    out = torch.empty_like(q)
    kernel.launch(q.data_ptr(), *(p.data_ptr() for p in planes),
                  out.data_ptr(),
                  *_decode_scratch(q.device, rows, n_kv, kv_mul, hs, most),
                  layer, pos.data_ptr(), table.data_ptr(), batch, t_len,
                  n_pages, table.shape[1], ps, n_kv, kv_mul, hs, most, least,
                  attention_scale(hs),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_decode_attention(q: torch.Tensor, k4: torch.Tensor,
                           v4: torch.Tensor, layer: int, pos: torch.Tensor,
                           table: torch.Tensor, n_pages: int, kv_mul: int,
                           plan: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """Attention of t_len queries per row over f32/bf16 pages (see the
    module docstring). CPU tensors take the plain version; CUDA tensors
    launch K6, built for the page dtype, which reads pos and the table on
    the device and splits each (row, query)'s keys as ``plan`` (default
    decode_plan over B*t_len rows) says. A bad plan raises on either."""
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
    kernel = (PAGED_KERNEL if k4.dtype == torch.float32
              else PAGED_KERNEL_KVBF16)
    return _launch(kernel, q, (k4, v4), layer, pos, table, n_pages, kv_mul,
                   plan)


def paged_decode_attention_q8(q: torch.Tensor, kq4: torch.Tensor,
                              kd4: torch.Tensor, vq4: torch.Tensor,
                              vd4: torch.Tensor, layer: int,
                              pos: torch.Tensor, table: torch.Tensor,
                              n_pages: int, kv_mul: int,
                              plan: tuple[int, int] | None = None
                              ) -> torch.Tensor:
    """paged_decode_attention over Q8 pages: CPU tensors take the plain
    version; CUDA tensors launch K7, which widens the codes in its page
    loop, its keys split as ``plan`` says."""
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
    return _launch(PAGED_KERNEL_Q8, q, planes, layer, pos, table, n_pages,
                   kv_mul, plan)
