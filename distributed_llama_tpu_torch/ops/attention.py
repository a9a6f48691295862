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
graph takes each replay's positions. It is K2's body on a (kv head, row)
grid: at B = 1 it computes K2's sums in K2's order.

K4 replaces ``prefill_attention`` (``_prefill_kernel``) there in f32: T
queries at pos..pos+T-1, row i seeing keys 0..pos+i, with the chunk's own
keys already in the cache. It is bound by bytes for an early chunk and by
operations once the prefix is a few hundred keys long. K4b is the same
function with ``bf16=True`` (``--fast-prefill``): both products take
bf16-rounded operands on the tensor cores with f32 accumulation, the scale
applies after the q.k dot, the softmax statistics stay f32 (l sums the
unrounded p) and p is rounded to bf16 for the p.v product.

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

import numpy as np
import torch

from ._build import CudaKernel

_DECODE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
_PREFILL_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p])
KERNEL = CudaKernel("decode_attention.cu", "decode_attention", _DECODE_ARGS)
KERNEL_KVBF16 = CudaKernel("decode_attention.cu", "decode_attention_kvbf16",
                           _DECODE_ARGS)
PREFILL_KERNEL = CudaKernel("prefill_attention.cu", "prefill_attention",
                            _PREFILL_ARGS)
PREFILL_KERNEL_KVBF16 = CudaKernel("prefill_attention.cu",
                                   "prefill_attention_kvbf16", _PREFILL_ARGS)
PREFILL_BF16_KERNEL = CudaKernel("prefill_attention_bf16.cu",
                                 "prefill_attention_bf16", _PREFILL_ARGS)
PREFILL_BF16_KERNEL_KVBF16 = CudaKernel("prefill_attention_bf16.cu",
                                        "prefill_attention_bf16_kvbf16",
                                        _PREFILL_ARGS)
_BATCH_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
               + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
BATCH_KERNEL = CudaKernel("decode_attention.cu", "decode_attention_batch",
                          _BATCH_ARGS)
BATCH_KERNEL_KVBF16 = CudaKernel("decode_attention.cu",
                                 "decode_attention_batch_kvbf16", _BATCH_ARGS)
KERNELS = (KERNEL, KERNEL_KVBF16, PREFILL_KERNEL, PREFILL_KERNEL_KVBF16,
           PREFILL_BF16_KERNEL, PREFILL_BF16_KERNEL_KVBF16, BATCH_KERNEL,
           BATCH_KERNEL_KVBF16)
# by (bf16 dots, cache dtype)
_PREFILL = {(False, torch.float32): PREFILL_KERNEL,
            (False, torch.bfloat16): PREFILL_KERNEL_KVBF16,
            (True, torch.float32): PREFILL_BF16_KERNEL,
            (True, torch.bfloat16): PREFILL_BF16_KERNEL_KVBF16}

_KV_MULS = (1, 2, 4, 8)  # the kernel's instantiations
_MAX_HEAD = 128
CACHE_DTYPES = (torch.float32, torch.bfloat16)

# |kernel - plain| <= KERNEL_ATOL on N(0, 1) queries, keys and values: the
# outputs are convex mixes of the values, summed in a different order (f32
# math on either cache dtype)
KERNEL_ATOL = 1e-5
# the same for K4b against prefill_attention_bf16_plain: the kernel rounds
# p to bf16 against the running max of the keys walked so far (tiles of 64)
# and the plain version against the row's final max, so a p may land one
# bf16 step (2^-8 relative) apart; the outputs mix such p over many keys
KERNEL_ATOL_BF16 = 2e-3


def attention_scale(head_size: int) -> float:
    """1/sqrt(hs) rounded to f32 as the reference computes it (f32 sqrt,
    then f32 division)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_size)))


def attention_core(head_size: int, kv_mul: int, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """Grouped (GQA) attention — the math every port path shares.

    q: (T, n_q, hs); k/v: (S, n_kv, hs); mask: (T, S) True where a key is
    visible, or None when every key is. Query head h = g*kv_mul + m attends
    kv head g, via einsum against the unexpanded cache. f32 throughout.
    Returns (T, n_q * hs).
    """
    t_len, n_q, _ = q.shape
    n_kv = k.shape[-2]
    qg = q.reshape(t_len, n_kv, kv_mul, head_size).to(torch.float32)
    scores = torch.einsum("tgmd,sgd->gmts", qg, k.to(torch.float32))
    scores = scores * attention_scale(head_size)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("gmts,sgd->tgmd", att, v.to(torch.float32))
    return out.reshape(t_len, n_q * head_size)


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


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, layer: int, pos: int,
                     kv_mul: int) -> torch.Tensor:
    """Attention of one token's queries q (n_q, hs) at position ``pos``
    against keys/values 0..pos of cache layer ``layer``. Returns
    (1, n_q * hs) f32. CPU tensors take the plain version; CUDA tensors
    launch K2, built for the cache's dtype (f32 or bf16)."""
    if q.device.type == "cpu" and k_all.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, layer, pos, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check(q, k_all, v_all, layer, pos, kv_mul)
    _, seq_len, n_kv, hs = k_all.shape
    out = torch.empty((1, q.numel()), dtype=torch.float32, device=q.device)
    kernel = KERNEL if k_all.dtype == torch.float32 else KERNEL_KVBF16
    kernel.launch(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                  out.data_ptr(), layer, pos, seq_len, n_kv, kv_mul, hs,
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
                           kv_mul: int) -> torch.Tensor:
    """Attention of B tokens' queries q (B, n_q, hs), row b at position
    pos[b] (a (B,) int32 tensor on q's device), against keys and values
    0..pos[b] of cache row layer*B + b of the (L*B, S, n_kv, hs) cache.
    Returns (B, n_q * hs) f32. CPU tensors take the plain version; CUDA
    tensors launch K5, built for the cache's dtype, which reads pos on the
    device."""
    if q.device.type == "cpu" and k4.device.type == "cpu":
        return decode_attention_batch_plain(q, k4, v4, layer, pos, kv_mul)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_batch: no kernel for device "
                         f"{q.device}")
    _check_batch(q, k4, v4, layer, pos, kv_mul)
    batch = q.shape[0]
    _, seq_len, n_kv, hs = k4.shape
    out = torch.empty((batch, q[0].numel()), dtype=torch.float32,
                      device=q.device)
    kernel = (BATCH_KERNEL if k4.dtype == torch.float32
              else BATCH_KERNEL_KVBF16)
    kernel.launch(q.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                  layer, pos.data_ptr(), batch, seq_len, n_kv, kv_mul, hs,
                  attention_scale(hs),
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
    _PREFILL[bf16, k_all.dtype].launch(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(),
        layer, pos, t_len, seq_len, n_kv, kv_mul, hs, attention_scale(hs),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
