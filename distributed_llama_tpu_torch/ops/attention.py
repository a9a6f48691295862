"""Attention: the hand-written CUDA kernels ``csrc/decode_attention.cu`` (K2,
K5), ``csrc/prefill_attention.cu`` (K4) and ``csrc/prefill_attention_bf16.cu``
(K4b), their plain PyTorch versions, and the attention math they share.

K2 replaces the JAX package's ops/pallas_attention.py ``decode_attention``:
one query token at position ``pos`` against keys and values 0..pos of layer
``layer`` of the stacked (L, S, n_kv, hs) cache, scale 1/sqrt(hs), query
head h on kv head h // kv_mul. It is bound by the K and V bytes of the live
prefix.

K5 replaces ``decode_attention_batch`` there: B such tokens over the rank-4
(L*B, S, n_kv, hs) batch cache, row b of layer ``layer`` at cache row
layer*B + b, each at its own position read from a device (B,) int32 vector
(one shared clock or per-row clocks alike), so a step captured in a CUDA
graph takes each replay's positions. K2 and K5 are one kernel: each (kv
head, row)'s keys are cut into splits across the grid (``decode_plan``,
``decode_splits``), each split's online-softmax state is kept in f32 in a
static per-device scratch, and the last split to finish merges them in
split order behind a ticket, all in one launch
(``decode_attention_split_model`` models the arithmetic). At B = 1 K5
computes K2's sums in K2's order.

K4 replaces ``prefill_attention`` (``_prefill_kernel``) there in f32: T
queries at pos..pos+T-1, row i seeing keys 0..pos+i, with the chunk's own
keys already in the cache. Its dots are f32-accurate on the tensor cores
by the 3xTF32 split, as the JAX kernel's Precision.HIGHEST takes several
passes on the matrix unit (``prefill_attention_tf32_splits`` models the
arithmetic). It is bound by bytes for an early chunk and by operations
once the prefix is a few hundred keys long. K4b is the same
function with ``bf16=True`` (``--fast-prefill``): both products take
bf16-rounded operands on the tensor cores with f32 accumulation, the scale
applies after the q.k dot, the softmax statistics stay f32 (l sums the
unrounded p) and p is rounded to bf16 for the p.v product. Both split the
key range across blocks where the (kv head x item tile) grid would leave
SMs idle (``prefill_plan``, ``prefill_bf16_plan``); one helper kernel,
``prefill_attention_bf16_combine`` (an f32 merge), merges either's splits
in fixed order.

The cache is f32 or bf16 (``--kv-cache-dtype bf16``, where the JAX kernels
keep their scratch in the cache dtype); each kernel has a build for either,
and a bf16 cache is widened to f32 exactly where the f32 math reads it.

Both read only the live prefix, so whatever a longer earlier run left past
it is invisible; the sources say how their designs meet their bounds. The
wrappers take the plain versions only for tensors on the CPU. On a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ._build import CudaKernel
from .q40 import sm_count, tf32_split

# (q, k_all, v_all, out, part, tickets, layer, pos, S, n_kv, kv_mul, hs,
# most, least, scale, stream)
_DECODE_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_void_p])
KERNEL = CudaKernel("decode_attention.cu", "decode_attention", _DECODE_ARGS)
KERNEL_KVBF16 = CudaKernel("decode_attention.cu", "decode_attention_kvbf16",
                           _DECODE_ARGS)
# (q, k_all, v_all, out, o_part, ml_part, layer, pos, T, S, n_kv, kv_mul,
# hs, splits, per, scale, stream)
_PREFILL_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                 + [ctypes.c_float, ctypes.c_void_p])
_COMBINE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
PREFILL_KERNEL = CudaKernel("prefill_attention.cu", "prefill_attention",
                            _PREFILL_ARGS)
PREFILL_KERNEL_KVBF16 = CudaKernel("prefill_attention.cu",
                                   "prefill_attention_kvbf16", _PREFILL_ARGS)
PREFILL_BF16_KERNEL = CudaKernel("prefill_attention_bf16.cu",
                                 "prefill_attention_bf16", _PREFILL_ARGS)
PREFILL_BF16_KERNEL_KVBF16 = CudaKernel("prefill_attention_bf16.cu",
                                        "prefill_attention_bf16_kvbf16",
                                        _PREFILL_ARGS)
# K4b's part, K4's too: the merge of their key splits
PREFILL_BF16_COMBINE = CudaKernel("prefill_attention_bf16.cu",
                                  "prefill_attention_bf16_combine",
                                  _COMBINE_ARGS)
# (q, k_all, v_all, out, part, tickets, layer, pos, batch, S, n_kv, kv_mul,
# hs, most, least, scale, stream)
_BATCH_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
               + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
BATCH_KERNEL = CudaKernel("decode_attention.cu", "decode_attention_batch",
                          _BATCH_ARGS)
BATCH_KERNEL_KVBF16 = CudaKernel("decode_attention.cu",
                                 "decode_attention_batch_kvbf16", _BATCH_ARGS)
KERNELS = (KERNEL, KERNEL_KVBF16, PREFILL_KERNEL, PREFILL_KERNEL_KVBF16,
           PREFILL_BF16_KERNEL, PREFILL_BF16_KERNEL_KVBF16, BATCH_KERNEL,
           BATCH_KERNEL_KVBF16)
HELPERS = (PREFILL_BF16_COMBINE,)
# by (bf16 dots, cache dtype)
_PREFILL = {(False, torch.float32): PREFILL_KERNEL,
            (False, torch.bfloat16): PREFILL_KERNEL_KVBF16,
            (True, torch.float32): PREFILL_BF16_KERNEL,
            (True, torch.bfloat16): PREFILL_BF16_KERNEL_KVBF16}

_KV_MULS = (1, 2, 4, 8)  # the kernel's instantiations
_MAX_HEAD = 128
CACHE_DTYPES = (torch.float32, torch.bfloat16)

# |kernel - plain| <= KERNEL_ATOL on N(0, 1) queries, keys and values: the
# outputs are convex mixes of the values, summed in a different order, and
# K4's 3xTF32 dots drop ~2^-22 relative per product
# (prefill_attention_tf32_splits)
KERNEL_ATOL = 1e-5
# the same for K4b against prefill_attention_bf16_plain: the kernel rounds
# p to bf16 against the running max of the keys its split has walked so far
# (prefill_attention_bf16_splits models it) and the plain version against
# the row's final max, so a p may land one bf16 step (2^-8 relative) apart;
# the outputs mix such p over many keys
KERNEL_ATOL_BF16 = 2e-3

# K2's and K5's key splits (csrc/decode_attention.cu): at most
# DECODE_MAX_SPLITS a kv head, each of at least DECODE_SPLIT_KEYS keys, as
# many as put DECODE_BLOCKS_PER_SM blocks on every SM over the (kv head x
# row) grid. tools/plan_sweep.py on the H100 (7B and 8 GQA kv heads, B = 1
# and 8, pos 63..2047): one block an SM beat two (a KV_MUL >= 2 block holds
# more than half an SM's registers, so a second one waits for a second
# wave), and 64 keys kept pos 63 in one split
DECODE_MAX_SPLITS = 32
DECODE_SPLIT_KEYS = 64
DECODE_BLOCKS_PER_SM = 1
# a plan of one split: the first design's sums in its order
ONE_SPLIT = (1, 1)

# K4b's tiling (csrc/prefill_attention_bf16.cu): keys per staged tile by
# cache dtype, (row, head) items per block, and the split limits: a split
# walks at least PREFILL_BF16_MIN_TILES tiles, and the plan aims at
# PREFILL_BF16_BLOCKS_PER_SM blocks on every SM (on the H100 at 7B and T =
# 128, one a SM beat two, three and four: more splits cost more in the
# combine's traffic than they gained in overlap)
PREFILL_BF16_KEYS = {torch.float32: 32, torch.bfloat16: 64}
PREFILL_BF16_ITEMS = 64
PREFILL_BF16_MIN_TILES = 2
PREFILL_BF16_MAX_SPLITS = 16
PREFILL_BF16_BLOCKS_PER_SM = 1
# K4's tiling (csrc/prefill_attention.cu): K4b's 64-item blocks over tiles
# of 32 keys, either cache, at most PREFILL_BF16_MAX_SPLITS splits
PREFILL_KEYS = 32


def attention_scale(head_size: int) -> float:
    """1/sqrt(hs) rounded to f32 as the reference computes it (f32 sqrt,
    then f32 division)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_size)))


def attention_core(head_size: int, kv_mul: int, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """Grouped (GQA) attention — the math every port path shares.

    q: (..., T, n_q, hs); k/v: (..., S, n_kv, hs) with the same leading
    dims (a training batch); mask: (T, S) True where a key is visible, or
    None when every key is. Query head h = g*kv_mul + m attends kv head g,
    via einsum against the unexpanded cache. f32 throughout, and
    differentiable (no in-place write). Returns (..., T, n_q * hs).
    """
    *lead, t_len, n_q, _ = q.shape
    n_kv = k.shape[-2]
    qg = q.reshape(*lead, t_len, n_kv, kv_mul, head_size).to(torch.float32)
    scores = torch.einsum("...tgmd,...sgd->...gmts", qg, k.to(torch.float32))
    scores = scores * attention_scale(head_size)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("...gmts,...sgd->...tgmd", att, v.to(torch.float32))
    return out.reshape(*lead, t_len, n_q * head_size)


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, layer: int, pos: int,
                           kv_mul: int) -> torch.Tensor:
    """attention_core over the live prefix 0..pos. q (n_q, hs) -> (1, n_q*hs)."""
    hs = k_all.shape[-1]
    return attention_core(hs, kv_mul, q.reshape(1, -1, hs),
                          k_all[layer, :pos + 1], v_all[layer, :pos + 1],
                          None)


def _check(q, k_all, v_all, layer, pos, kv_mul) -> None:
    if k_all.dim() != 4 or k_all.shape != v_all.shape:
        raise ValueError(f"decode_attention: caches must be equal (L, S, "
                         f"n_kv, hs), got {tuple(k_all.shape)} and "
                         f"{tuple(v_all.shape)}")
    n_layers, seq_len, n_kv, hs = k_all.shape
    if tuple(q.shape) != (n_kv * kv_mul, hs):
        raise ValueError(f"decode_attention: q must be ({n_kv * kv_mul}, "
                         f"{hs}), got {tuple(q.shape)}")
    if q.dtype != torch.float32:
        raise ValueError(f"decode_attention: q must be float32, got "
                         f"{q.dtype}")
    if k_all.dtype not in CACHE_DTYPES or v_all.dtype != k_all.dtype:
        raise ValueError(f"decode_attention: the caches must both be "
                         f"float32 or both bfloat16, got {k_all.dtype} and "
                         f"{v_all.dtype}")
    for name, t in (("q", q), ("k_all", k_all), ("v_all", v_all)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if kv_mul not in _KV_MULS or hs % 4 or hs > _MAX_HEAD:
        raise ValueError(f"decode_attention: the kernel takes kv_mul in "
                         f"{_KV_MULS} and head size a multiple of 4 up to "
                         f"{_MAX_HEAD}, got kv_mul={kv_mul} hs={hs}")
    if not (0 <= layer < n_layers and 0 <= pos < seq_len):
        raise ValueError(f"decode_attention: layer {layer} / pos {pos} out "
                         f"of range for cache {tuple(k_all.shape)}")


@functools.lru_cache(maxsize=None)
def decode_plan(n_kv: int, batch: int, sms: int) -> tuple[int, int]:
    """(most, least) of K2's and K5's key splits for B = ``batch`` rows of
    n_kv kv heads on ``sms`` SMs: at most ``most`` splits a kv head, as many
    as put DECODE_BLOCKS_PER_SM blocks on every SM (at most
    DECODE_MAX_SPLITS; one where the (kv head x row) grid fills the card
    already), each of at least ``least`` = DECODE_SPLIT_KEYS keys. K2 takes
    B = 1's plan, so K5 at B = 1 gives K2's bits."""
    most = DECODE_BLOCKS_PER_SM * sms // (n_kv * batch)
    return max(1, min(DECODE_MAX_SPLITS, most)), DECODE_SPLIT_KEYS


def decode_want(keys: int, plan: tuple[int, int]) -> int:
    """The most splits ``keys`` keys may take under ``plan`` = (most,
    least); it grows with ``keys``, so the grid of K5 (S keys) and of K6
    and K7 (the clamped virtual plane's keys), sized by it, covers every
    row's plan (csrc/flash_decode.cuh decode_want)."""
    most, least = plan
    return max(1, min(most, -(-keys // least)))


def decode_splits(keys: int, plan: tuple[int, int]) -> tuple[int, int]:
    """(splits, keys a split) of ``keys`` live keys under ``plan`` = (most,
    least): at most ``most`` splits of at least ``least`` keys (one for a
    short prefix), all of ``per`` keys but the last, none empty. The
    kernels compute the same on the card from each row's position
    (csrc/flash_decode.cuh decode_splits)."""
    want = decode_want(keys, plan)
    per = -(-keys // want)
    return -(-keys // per), per


def decode_attention_split_model(q: torch.Tensor, k_all: torch.Tensor,
                                 v_all: torch.Tensor, layer: int, pos,
                                 kv_mul: int,
                                 plan: tuple[int, int]) -> torch.Tensor:
    """K2's and K5's split arithmetic in plain torch (a model for the
    tests; no route calls it): the keys 0..pos of each kv head cut as
    decode_splits says, each split's online-softmax state (m, l,
    unnormalised o) in f32, then the splits merged in split order, m = max
    m_j, l = sum l_j e^(m_j - m), o = sum o_j e^(m_j - m), out = o / l.
    q (n_q, hs) at int ``pos`` -> (1, n_q * hs) over cache row ``layer``;
    or q (B, n_q, hs) at B positions -> (B, n_q * hs), row b over cache
    row layer * B + b, as K5 reads them."""
    if q.dim() == 3:
        batch = q.shape[0]
        return torch.cat([
            decode_attention_split_model(q[b], k_all, v_all,
                                         layer * batch + b, int(p), kv_mul,
                                         plan)
            for b, p in enumerate(pos)])
    n_kv, hs = k_all.shape[2], k_all.shape[3]
    keys = pos + 1
    splits, per = decode_splits(keys, plan)
    k = k_all[layer, :keys].to(torch.float32)  # (keys, n_kv, hs)
    v = v_all[layer, :keys].to(torch.float32)
    qg = q.to(torch.float32).reshape(n_kv, kv_mul, hs)
    scores = torch.einsum("gmd,tgd->gmt", qg, k) * attention_scale(hs)
    parts = []
    for j in range(splits):
        sj = scores[..., j * per:(j + 1) * per]
        mj = sj.amax(-1)
        pj = torch.exp(sj - mj[..., None])
        parts.append((mj, pj.sum(-1), torch.einsum(
            "gmt,tgd->gmd", pj, v[j * per:(j + 1) * per])))
    m = torch.stack([mj for mj, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qg)
    for mj, lj, oj in parts:
        f = torch.exp(mj - m)
        l = l + lj * f
        o = o + oj * f[..., None]
    return (o / l[..., None]).reshape(1, -1)


class _DecodeScratch(NamedTuple):
    """K2's, K5's, K6's and K7's split partials, (rows x n_kv x most) x
    kv_mul x (hs + 2) f32, and their per-(row, kv head) tickets, int32
    zeros that every launch leaves zero; the window kernels K6w and K7w
    take the same buffers at B * t_len rows (ops/paged_attention.py)."""

    part: torch.Tensor
    tickets: torch.Tensor


_DECODE_SCRATCH: dict = {}


def _decode_scratch(device: torch.device, batch: int, n_kv: int,
                    kv_mul: int, hs: int, most: int) -> tuple[int, int]:
    """(part, tickets) pointers for a launch: static buffers made once per
    (device, shape, plan width) on the first call there — an eager one:
    every captured path runs its first step eagerly, so a captured step
    keeps their addresses — and shared by every launch of that shape (K5
    and K6 of as many rows alike), as the launches on a device run one
    after another on its stream. A one-split plan touches neither (null
    pointers)."""
    if most == 1:
        return 0, 0
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (index, batch, n_kv, kv_mul, hs, most)
    scratch = _DECODE_SCRATCH.get(key)
    if scratch is None:
        scratch = _DECODE_SCRATCH[key] = _DecodeScratch(
            torch.empty(batch * n_kv * most * kv_mul * (hs + 2),
                        dtype=torch.float32, device=device),
            torch.zeros(batch * n_kv, dtype=torch.int32, device=device))
    return scratch.part.data_ptr(), scratch.tickets.data_ptr()


def _plan_for(plan, n_kv: int, batch: int, device) -> tuple[int, int]:
    """The wrapper's plan (K2, K5, K6, K7): ``plan`` when given (tests and
    tools/plan_sweep.py; ONE_SPLIT for the first design's sums), else
    decode_plan on this card."""
    if plan is None:
        return decode_plan(n_kv, batch, sm_count(device))
    most, least = plan
    if not (1 <= most <= DECODE_MAX_SPLITS and least >= 1):
        raise ValueError(f"decode_attention: a plan is (most, least) with "
                         f"1 <= most <= {DECODE_MAX_SPLITS} and least >= 1, "
                         f"got {plan}")
    return int(most), int(least)


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, layer: int, pos: int,
                     kv_mul: int,
                     plan: tuple[int, int] | None = None) -> torch.Tensor:
    """Attention of one token's queries q (n_q, hs) at position ``pos``
    against keys/values 0..pos of cache layer ``layer``. Returns
    (1, n_q * hs) f32. CPU tensors take the plain version; CUDA tensors
    launch K2, built for the cache's dtype (f32 or bf16), its keys split
    as ``plan`` (default decode_plan at B = 1) says."""
    if q.device.type == "cpu" and k_all.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, layer, pos, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check(q, k_all, v_all, layer, pos, kv_mul)
    _, seq_len, n_kv, hs = k_all.shape
    most, least = _plan_for(plan, n_kv, 1, q.device)
    out = torch.empty((1, q.numel()), dtype=torch.float32, device=q.device)
    kernel = KERNEL if k_all.dtype == torch.float32 else KERNEL_KVBF16
    kernel.launch(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                  out.data_ptr(),
                  *_decode_scratch(q.device, 1, n_kv, kv_mul, hs, most),
                  layer, pos, seq_len, n_kv, kv_mul, hs, most, least,
                  attention_scale(hs),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


# --------------------------------------------------------------------------
# batched decode attention (K5)
# --------------------------------------------------------------------------

def decode_attention_batch_plain(q: torch.Tensor, k4: torch.Tensor,
                                 v4: torch.Tensor, layer: int,
                                 pos: torch.Tensor,
                                 kv_mul: int) -> torch.Tensor:
    """decode_attention_plain for each row: row b's queries q[b] (n_q, hs)
    against keys 0..pos[b] of cache row layer*B + b. q (B, n_q, hs) ->
    (B, n_q*hs). Reads the positions on the host (a sync on the card),
    which only the kernel avoids."""
    batch = q.shape[0]
    return torch.cat([
        decode_attention_plain(q[b], k4, v4, layer * batch + b, p, kv_mul)
        # dlint: allow[D001] plain version: host positions
        for b, p in enumerate(pos.tolist())])


def _check_batch(q, k4, v4, layer, pos, kv_mul) -> None:
    if q.dim() != 3:
        raise ValueError(f"decode_attention_batch: q must be (B, n_q, hs), "
                         f"got {tuple(q.shape)}")
    batch = q.shape[0]
    if k4.dim() != 4 or k4.shape[0] % batch:
        raise ValueError(f"decode_attention_batch: the cache must be (L*B, "
                         f"S, n_kv, hs) with B = {batch}, got "
                         f"{tuple(k4.shape)}")
    if not 0 <= layer < k4.shape[0] // batch:
        raise ValueError(f"decode_attention_batch: layer {layer} out of "
                         f"range for cache {tuple(k4.shape)} at B = {batch}")
    if (pos.dtype != torch.int32 or tuple(pos.shape) != (batch,)
            or pos.device != q.device or not pos.is_contiguous()):
        raise ValueError(f"decode_attention_batch: pos must be a contiguous "
                         f"int32 ({batch},) on {q.device}, got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    # the per-row checks of K2; pos 0 stands for the device positions,
    # which the caller keeps in 0..S-1 (reading them would sync)
    _check(q[0], k4, v4, 0, 0, kv_mul)
    if not q.is_contiguous():
        raise ValueError("decode_attention_batch: q must be contiguous")


def decode_attention_batch(q: torch.Tensor, k4: torch.Tensor,
                           v4: torch.Tensor, layer: int, pos: torch.Tensor,
                           kv_mul: int,
                           plan: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """Attention of B tokens' queries q (B, n_q, hs), row b at position
    pos[b] (a (B,) int32 tensor on q's device), against keys and values
    0..pos[b] of cache row layer*B + b of the (L*B, S, n_kv, hs) cache.
    Returns (B, n_q * hs) f32. CPU tensors take the plain version; CUDA
    tensors launch K5, built for the cache's dtype, which reads pos on the
    device and splits each row's keys as ``plan`` (default decode_plan at
    this B) says."""
    if q.device.type == "cpu" and k4.device.type == "cpu":
        return decode_attention_batch_plain(q, k4, v4, layer, pos, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_batch: no kernel for device "
                         f"{q.device}")
    _check_batch(q, k4, v4, layer, pos, kv_mul)
    batch = q.shape[0]
    _, seq_len, n_kv, hs = k4.shape
    most, least = _plan_for(plan, n_kv, batch, q.device)
    out = torch.empty((batch, q[0].numel()), dtype=torch.float32,
                      device=q.device)
    kernel = (BATCH_KERNEL if k4.dtype == torch.float32
              else BATCH_KERNEL_KVBF16)
    kernel.launch(q.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                  *_decode_scratch(q.device, batch, n_kv, kv_mul, hs, most),
                  layer, pos.data_ptr(), batch, seq_len, n_kv, kv_mul, hs,
                  most, least, attention_scale(hs),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


# --------------------------------------------------------------------------
# causal prefill attention (K4, K4b)
# --------------------------------------------------------------------------

def _causal_mask(pos: int, t_len: int, device) -> torch.Tensor:
    """(T, pos+T): row i sees keys 0..pos+i (the JAX package's
    causal_cache_mask restricted to the live keys)."""
    live = pos + t_len
    keys = torch.arange(live, device=device)
    rows = torch.arange(pos, live, device=device)
    return keys[None, :] <= rows[:, None]


def prefill_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                            v_all: torch.Tensor, layer: int, pos: int,
                            kv_mul: int) -> torch.Tensor:
    """attention_core of T queries at pos..pos+T-1 over the live prefix
    0..pos+T-1, query row i seeing keys 0..pos+i. q (T, n_q, hs) ->
    (T, n_q*hs)."""
    t_len, hs = q.shape[0], k_all.shape[-1]
    live = pos + t_len
    return attention_core(hs, kv_mul, q, k_all[layer, :live],
                          v_all[layer, :live],
                          _causal_mask(pos, t_len, q.device))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), held in f32."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def prefill_attention_bf16_plain(q: torch.Tensor, k_all: torch.Tensor,
                                 v_all: torch.Tensor, layer: int, pos: int,
                                 kv_mul: int) -> torch.Tensor:
    """K4b's function over the live prefix (the JAX package's bf16 prefill
    partials): q, k and v rounded to bf16; s = (q.k in f32) * scale; p =
    exp(s - rowmax) in f32; l sums the f32 p; the p.v product takes p
    rounded to bf16; out = o / l. q (T, n_q, hs) -> (T, n_q*hs).

    The JAX package's CPU path (one block when the live prefix fits its
    512-key block) and its Pallas body in interpret mode (one block of the
    largest divisor of seq_len up to 512) take the row max over the same
    keys at the shapes its tests run; over longer prefixes they round p
    against the running max of each walked block instead."""
    t_len, n_q, hs = q.shape
    n_kv = k_all.shape[-2]
    live = pos + t_len
    qg = _bf16(q).reshape(t_len, n_kv, kv_mul, hs)
    s = torch.einsum("tgmd,sgd->gmts", qg, _bf16(k_all[layer, :live]))
    s = s * attention_scale(hs)
    s = s.masked_fill(~_causal_mask(pos, t_len, q.device), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("gmts,sgd->gmtd", _bf16(p), _bf16(v_all[layer, :live]))
    return (o / l).permute(2, 0, 1, 3).reshape(t_len, n_q * hs)


@functools.lru_cache(maxsize=None)
def prefill_bf16_plan(pos: int, t_len: int, kv_mul: int, n_kv: int,
                      keys: int, sms: int) -> tuple[int, int]:
    """(splits, tiles per split) of K4b: the live prefix 0..pos+T-1 in
    tiles of ``keys`` keys, cut into ``splits`` contiguous runs of ``per``
    tiles (the last possibly shorter, none empty). One split where the
    (n_kv x item tiles) grid already puts PREFILL_BF16_BLOCKS_PER_SM blocks
    on each of the ``sms`` SMs; else enough splits for that, as long as each
    walks PREFILL_BF16_MIN_TILES tiles."""
    tiles = -(-(pos + t_len) // keys)
    blocks = n_kv * -(-(t_len * kv_mul) // PREFILL_BF16_ITEMS)
    want = PREFILL_BF16_BLOCKS_PER_SM * sms
    if blocks >= want or tiles < 2 * PREFILL_BF16_MIN_TILES:
        return 1, tiles
    splits = min(-(-want // blocks), PREFILL_BF16_MAX_SPLITS)
    # runs rounded down, so rounding never leaves fewer splits than wanted
    per = max(PREFILL_BF16_MIN_TILES, tiles // splits,
              -(-tiles // PREFILL_BF16_MAX_SPLITS))
    return -(-tiles // per), per


def prefill_plan(pos: int, t_len: int, kv_mul: int, n_kv: int,
                 sms: int) -> tuple[int, int]:
    """(splits, tiles per split) of K4: the live prefix 0..pos+T-1 in tiles
    of PREFILL_KEYS keys, cut into as many balanced runs as keep the (n_kv x
    item tiles x splits) grid within one wave of one block an SM (a K4
    block's shared memory fills an SM), at most one a tile. On the H100 at
    7B and the GQA shape this count was the fastest of a sweep of 1..8
    splits, or within 3% of it, at every (T, pos) tried; K4b's rule
    (prefill_bf16_plan) gave a second, uneven wave."""
    tiles = -(-(pos + t_len) // PREFILL_KEYS)
    blocks = n_kv * -(-(t_len * kv_mul) // PREFILL_BF16_ITEMS)
    splits = max(1, min(sms // blocks, tiles, PREFILL_BF16_MAX_SPLITS))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def _dot_bf16(a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    """einsum of a and b rounded to bf16 (their products exact in f32)."""
    return torch.einsum(spec, _bf16(a), _bf16(b))


def _dot_3xtf32(a: torch.Tensor, b: torch.Tensor,
                spec: str) -> torch.Tensor:
    """einsum of a and b in 3xTF32: a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (over
    a bf16 cache b_lo is 0: b is exact in TF32)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (torch.einsum(spec, a_hi, b_hi) + torch.einsum(spec, a_hi, b_lo)
            + torch.einsum(spec, a_lo, b_hi))


def _split_walk(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                layer: int, pos: int, kv_mul: int, keys: int, splits: int,
                dot) -> torch.Tensor:
    """A split kernel's arithmetic, step by step in plain torch: the live
    prefix in tiles of ``keys`` keys, cut into ``splits`` runs as the
    kernel cuts it, each run walked with an online softmax (s = dot(q, k)
    * scale, p against the running max of the tiles that run has seen, o +=
    dot(p, v)), then the runs merged in f32 in split order. q (T, n_q, hs)
    -> (T, n_q*hs)."""
    t_len, n_q, hs = q.shape
    n_kv = k_all.shape[-2]
    live = pos + t_len
    tiles = -(-live // keys)
    per = -(-tiles // splits)
    qg = q.to(torch.float32).reshape(t_len, n_kv, kv_mul, hs)
    kb = k_all[layer, :live].to(torch.float32)
    vb = v_all[layer, :live].to(torch.float32)
    mask = _causal_mask(pos, t_len, q.device)
    shape = (n_kv, kv_mul, t_len)
    parts = []
    for z in range(splits):
        m = torch.full(shape, float("-inf"), device=q.device)
        l = torch.zeros(shape, device=q.device)
        o = torch.zeros((*shape, hs), device=q.device)
        for tile in range(z * per, min(tiles, (z + 1) * per)):
            lo, hi = tile * keys, min(live, (tile + 1) * keys)
            s = dot(qg, kb[lo:hi], "tgmd,sgd->gmts")
            s = (s * attention_scale(hs)).masked_fill(~mask[:, lo:hi],
                                                      float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            base = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp(s - base[..., None])
            corr = torch.exp(m - base)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + dot(p, vb[lo:hi], "gmts,sgd->gmtd")
            m = m_new
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros(shape, device=q.device)
    o_all = torch.zeros((*shape, hs), device=q.device)
    for m, l, o in parts:
        w = torch.exp(m - mx)
        l_all = l_all + w * l
        o_all = o_all + w[..., None] * o
    return (o_all / l_all[..., None]).permute(2, 0, 1, 3).reshape(
        t_len, n_q * hs)


def prefill_attention_bf16_splits(q: torch.Tensor, k_all: torch.Tensor,
                                  v_all: torch.Tensor, layer: int, pos: int,
                                  kv_mul: int, keys: int,
                                  splits: int) -> torch.Tensor:
    """K4b's split arithmetic (a model for the tests; no route calls it):
    _split_walk with q, k, p and v rounded to bf16, so p is rounded against
    the running max of the tiles its split has seen."""
    return _split_walk(q, k_all, v_all, layer, pos, kv_mul, keys, splits,
                       _dot_bf16)


def prefill_attention_tf32_splits(q: torch.Tensor, k_all: torch.Tensor,
                                  v_all: torch.Tensor, layer: int, pos: int,
                                  kv_mul: int,
                                  splits: int) -> torch.Tensor:
    """K4's split arithmetic (a model for the tests; no route calls it):
    _split_walk over tiles of PREFILL_KEYS keys with both dots in 3xTF32,
    q and p split into TF32 hi and lo as the kernel splits them, k and v
    too over an f32 cache (a bf16 cache's values are exact in TF32)."""
    return _split_walk(q, k_all, v_all, layer, pos, kv_mul, PREFILL_KEYS,
                       splits, _dot_3xtf32)


def _check_prefill(q, k_all, v_all, layer, pos, kv_mul) -> None:
    if q.dim() != 3:
        raise ValueError(f"prefill_attention: q must be (T, n_q, hs), got "
                         f"{tuple(q.shape)}")
    t_len = q.shape[0]
    if t_len < 1 or pos + t_len > k_all.shape[1]:
        raise ValueError(f"prefill_attention: positions {pos}.."
                         f"{pos + t_len - 1} outside the cache (seq_len "
                         f"{k_all.shape[1]})")
    _check(q[0], k_all, v_all, layer, pos, kv_mul)
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("prefill_attention: q must be contiguous and "
                         "16-byte aligned")
    if k_all.shape[-1] % 8:
        raise ValueError(f"prefill_attention: the kernels take a head size "
                         f"that is a multiple of 8, got {k_all.shape[-1]}")


def prefill_attention(q: torch.Tensor, k_all: torch.Tensor,
                      v_all: torch.Tensor, layer: int, pos: int,
                      kv_mul: int, bf16: bool = False) -> torch.Tensor:
    """Causal attention of T queries q (T, n_q, hs) at positions
    pos..pos+T-1 against keys/values 0..pos+T-1 of cache layer ``layer``
    (the chunk's own keys already written), with f32 dots or, with
    ``bf16``, bf16 ones. Returns (T, n_q * hs) f32. CPU tensors take the
    plain versions; CUDA tensors launch K4 or K4b, built for the cache's
    dtype."""
    if q.device.type == "cpu" and k_all.device.type == "cpu":
        plain = prefill_attention_bf16_plain if bf16 else \
            prefill_attention_plain
        return plain(q, k_all, v_all, layer, pos, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: no kernel for device "
                         f"{q.device}")
    _check_prefill(q, k_all, v_all, layer, pos, kv_mul)
    t_len = q.shape[0]
    _, seq_len, n_kv, hs = k_all.shape
    if bf16 and hs % 16:
        raise ValueError(f"prefill_attention: the bf16 kernel takes a head "
                         f"size that is a multiple of 16, got {hs}")
    out = torch.empty((t_len, q[0].numel()), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr())
    sms = sm_count(q.device)
    splits, per = (prefill_bf16_plan(pos, t_len, kv_mul, n_kv,
                                     PREFILL_BF16_KEYS[k_all.dtype], sms)
                   if bf16 else prefill_plan(pos, t_len, kv_mul, n_kv, sms))
    o_part = ml_part = None
    if splits > 1:
        n_all = t_len * n_kv * kv_mul
        o_part = torch.empty((splits, n_all, hs), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((2, splits, n_all), dtype=torch.float32,
                              device=q.device)
    _PREFILL[bf16, k_all.dtype].launch(
        *ptrs, 0 if o_part is None else o_part.data_ptr(),
        0 if ml_part is None else ml_part.data_ptr(), layer, pos, t_len,
        seq_len, n_kv, kv_mul, hs, splits, per, attention_scale(hs), stream)
    if splits > 1:
        PREFILL_BF16_COMBINE.launch(o_part.data_ptr(), ml_part.data_ptr(),
                                    out.data_ptr(), n_all, hs, splits,
                                    stream)
    return out
