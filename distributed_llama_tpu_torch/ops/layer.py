"""The fused T=1 decode layer: three hand-written CUDA kernels
(``csrc/fused_layer.cu``), their plain PyTorch versions, the RoPE helpers,
and the switch that turns them on.

The JAX package's ops/pallas_layer.py fuses a decode layer's chain of
matvecs and glue into Pallas kernels, opt in through
``DLLAMA_LAYER_FUSION``:

* K8 ``q40_head_fused`` (``_head_call``): rmsnorm(x, rms_att) -> the wqkv
  Q40 matvec -> RoPE on the q and k rows. x (1, dim) -> qkv (1, dim +
  2*kv_dim).
* K9 ``q40_tail_fused`` (``_tail_call``): x + wo . ao -> rmsnorm(rms_ffn)
  -> the w13 matvec -> silu(a) * b -> x + wo . ao + w2 . that. ao, x (1,
  dim) -> (1, dim).
* K10 ``q40_layer_mega`` (``_mega_call``): K8, the k/v write at (layer,
  pos) in the cache dtype, flash attention over keys 0..pos, then K9: the
  whole layer. x (1, dim) -> (1, dim), the cache written in place.

``DLLAMA_LAYER_FUSION=headtail`` runs each layer as K8, the two cache
writes, the decode attention (K2 at a host position, K5 at B = 1 at a
device one) and K9; ``on`` runs K10 where ``mega_supported`` holds and
head/tail elsewhere; ``off``, ``auto`` or unset run the unfused layer
(``auto`` resolves to off, as in the JAX package). ``fusion_mode`` reads
the environment; the engine calls it once and no op reads it.

Weights are the port's codec-layout Q40 layer views (io/loader.Q40Weight),
the same tree the unfused path reads: the JAX megakernel's block-permuted
``wo_mega`` and its ``DLLAMA_MEGA_R`` row tiles exist for Mosaic's layouts
and have no counterpart here. Positions are device int32 tensors (1,), so
a step captured in a CUDA graph reads each replay's position.

The wrappers take the plain versions only for tensors on the CPU; on a
CUDA tensor they launch their kernel or raise. The kernel source says how
each design meets its bound. K8 and K9 stream their weights through
per-warp shared-memory rings whose plan (chunk size, each block's band of
jobs, the 16-byte copies) ``ring_chunk``, ``ring_phases``, ``ring_jobs``
and ``ring_scale_copies`` model on the host for the tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..io.loader import Q40Weight
from ._build import CudaKernel
from .attention import (CACHE_DTYPES, attention_scale,
                        decode_attention_plain)
from .linear import rmsnorm, silu
from .q40 import q40_matmul_plain
from .quants import QK, FloatType

FUSION_MODES = ("auto", "on", "headtail", "off")

HEAD_KERNEL = CudaKernel("fused_layer.cu", "q40_head_fused",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
TAIL_KERNEL = CudaKernel("fused_layer.cu", "q40_tail_fused",
                         [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])
MEGA_KERNEL = CudaKernel("fused_layer.cu", "q40_layer_mega",
                         [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
KERNELS = (HEAD_KERNEL, TAIL_KERNEL, MEGA_KERNEL)

_KV_MULS = (1, 2, 4, 8)  # K10's instantiations
_MAX_HEAD = 128
_MEGA_MAX_DIM = 8192  # K10 keeps a thread's share of x in registers
# K10's attention splits the keys of each kv head across the grid
# (csrc/fused_layer.cu key_splits): at most MEGA_MAX_SPLITS a head, each of
# at least MEGA_SPLIT_KEYS keys
MEGA_MAX_SPLITS = 32
MEGA_SPLIT_KEYS = 128
# K8's and K9's rings (csrc/fused_layer.cu): a ring of RING_SLOTS chunks on
# each of a block's RING_WARPS warps, a chunk RING_CHUNKS[0] Q40 blocks of
# a job's two rows where that fits in shared memory beside the staged
# vector, else RING_CHUNKS[1]
RING_WARPS = 16
RING_SLOTS = 2
RING_CHUNKS = (64, 32)
_BLOCK_PAD = 36  # floats a staged 32-value block takes (q40_row.cuh)


def fusion_mode() -> str:
    """'auto', 'on', 'headtail' or 'off': ``DLLAMA_LAYER_FUSION``, unset or
    empty meaning 'auto'. An unknown value raises, as a typo would
    otherwise run the unfused path."""
    mode = os.environ.get("DLLAMA_LAYER_FUSION") or "auto"
    if mode not in FUSION_MODES:
        raise ValueError(f"DLLAMA_LAYER_FUSION={mode!r}: "
                         f"expected auto|on|headtail|off")
    return mode


def fused(mode: str) -> bool:
    """Whether ``mode`` runs the fused layer ('auto' resolves to off)."""
    return mode in ("on", "headtail")


def supports(spec, params: dict) -> bool:
    """Whether the fused layer serves this model: f32 buffers (q80 keeps
    the unfused path), dim and hidden_dim in whole 32-value blocks, an even
    head size, and Q40 weights with the load-time fusions ``wqkv`` and
    ``w13`` present. The JAX package also asks for its d-major Q40 kernel
    stacks, a Mosaic tiling choice with no counterpart here."""
    if spec.buffer_float_type == FloatType.Q80:
        return False
    if spec.dim % QK or spec.hidden_dim % QK or spec.head_size % 2:
        return False
    return all(isinstance(params.get(k), Q40Weight)
               for k in ("wqkv", "wo", "w13", "w2"))


def att_chunk(seq_len: int, n_kv: int, head_size: int,
              itemsize: int) -> int | None:
    """The JAX megakernel's cache chunk (``_att_chunk``): the largest of
    256..8 dividing seq_len whose two K and V slots fit 8 MB, or None. The
    port's kernel walks keys one by one and needs no chunk; the condition
    decides where ``on`` takes the megakernel, as it does there."""
    for c in (256, 128, 64, 32, 16, 8):
        if seq_len % c == 0 and 4 * c * n_kv * head_size * itemsize <= 8 << 20:
            return min(c, seq_len)
    return None


def mega_supported(spec) -> bool:
    """Where ``on`` takes the megakernel (else head/tail), on top of
    ``supports``: head size 128 and an attention chunk, the JAX package's
    conditions (checked at an f32 cache's itemsize, as there), and a width
    the kernel takes (up to 8192, Llama-2 70B's)."""
    return (spec.head_size == 128 and spec.dim <= _MEGA_MAX_DIM
            and att_chunk(spec.seq_len, spec.n_kv_heads, spec.head_size,
                          4) is not None)


# --------------------------------------------------------------------------
# RoPE (the forward's, shared with models/llama.py)
# --------------------------------------------------------------------------

def rope_freq(n: int, head_size: int, device) -> torch.Tensor:
    """Per-pair frequencies (n/2,) f32: pair p uses head_dim = (2p) mod hs."""
    i = torch.arange(0, n, 2, dtype=torch.float32, device=device)
    head_dim = torch.remainder(i, head_size)
    base = torch.tensor(10000.0, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, head_dim / head_size)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of x (..., n) by angles (..., n/2)."""
    pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    v0, v1 = pairs[..., 0], pairs[..., 1]
    return torch.stack([v0 * cos - v1 * sin, v0 * sin + v1 * cos],
                       dim=-1).reshape(x.shape)


def rope_rows(freq: torch.Tensor,
              positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (T, n/2) of the angles at device positions (T,), one row
    each: the f32 position times the frequencies (the reference's
    rope_rotate)."""
    val = positions.to(torch.float32)[:, None] * freq[None, :]
    return torch.cos(val), torch.sin(val)


def random_layer(dim: int, hidden_dim: int, n_heads: int, n_kv_heads: int,
                 device, generator: torch.Generator) -> dict:
    """One layer's fused-path weights with random codes (ops/q40.random_q40)
    and norm weights near 1, plus its RoPE frequencies, made on ``device``
    from ``generator``: the input on which the fused kernels are held
    against their plain versions."""
    from .q40 import random_q40

    hs = dim // n_heads
    kv_dim = n_kv_heads * hs

    def norm():
        return 1.0 + 0.1 * torch.randn(dim, device=device,
                                       generator=generator)

    return {"wqkv": random_q40(dim + 2 * kv_dim, dim, device, generator),
            "wo": random_q40(dim, dim, device, generator),
            "w13": random_q40(2 * hidden_dim, dim, device, generator),
            "w2": random_q40(dim, hidden_dim, device, generator),
            "rms_att": norm(), "rms_ffn": norm(),
            "freq": rope_freq(dim + kv_dim, hs, device)}


def readback_q40(d: int, n: int, device) -> Q40Weight:
    """A (d, n) Q40 weight whose row i < n reads x[i] back exactly: code 9
    (+1) at column i, 8 (0) elsewhere, every scale 1. Through a row body
    with P0's arithmetic (K8's and K9's) each product and sum but one is an
    exact zero, so such a row returns the staged vector's value bit for
    bit: the tests read a kernel's staged vector back this way."""
    qs = torch.full((d, n // QK, 16), 0x88, dtype=torch.uint8, device=device)
    i = torch.arange(min(d, n), device=device)
    j = i % QK
    qs[i, i // QK, j % 16] = torch.where(
        j < 16, 0x89, 0x98).to(device=device, dtype=torch.uint8)
    return Q40Weight(qs, torch.ones((d, n // QK), dtype=torch.float16,
                                    device=device))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def q40_head_fused_plain(x: torch.Tensor, wqkv: Q40Weight,
                         rms_att: torch.Tensor, freq: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """K8's function: the rows of wqkv . rmsnorm(x, rms_att), the first
    2 * freq.numel() (q and k) rotated at position pos (1,). x (1, dim) ->
    (1, dim + 2*kv_dim)."""
    qkv = q40_matmul_plain(wqkv, rmsnorm(x, rms_att))
    n_rot = 2 * freq.numel()
    qk = rotate(qkv[:, :n_rot], *rope_rows(freq, pos))
    return torch.cat([qk, qkv[:, n_rot:]], dim=1)


def q40_tail_fused_plain(ao: torch.Tensor, x: torch.Tensor, wo: Q40Weight,
                         w13: Q40Weight, w2: Q40Weight,
                         rms_ffn: torch.Tensor) -> torch.Tensor:
    """K9's function: xn = x + wo . ao, then xn + w2 . (silu(w1 . h) *
    (w3 . h)) with h = rmsnorm(xn, rms_ffn) and w13 = [w1; w3]. ao, x
    (1, dim) -> (1, dim)."""
    xn = x + q40_matmul_plain(wo, ao)
    h13 = q40_matmul_plain(w13, rmsnorm(xn, rms_ffn))
    hid = h13.shape[-1] // 2
    return xn + q40_matmul_plain(w2, silu(h13[:, :hid]) * h13[:, hid:])


def mega_attention_splits(keys: int, n_kv: int,
                          grid: int) -> tuple[int, int]:
    """(splits, keys a split) of K10's attention over ``keys`` keys of each
    of n_kv heads on a co-resident grid of ``grid`` blocks: at most
    MEGA_MAX_SPLITS and grid // n_kv splits, each of at least
    MEGA_SPLIT_KEYS keys (one split for a short prefix), all of ``per``
    keys but the last, none empty."""
    most = max(1, min(grid // n_kv, MEGA_MAX_SPLITS,
                      -(-keys // MEGA_SPLIT_KEYS)))
    per = -(-keys // most)
    return -(-keys // per), per


def ring_slot_bytes(ch: int) -> int:
    """Bytes of one ring slot: a chunk of ``ch`` Q40 blocks of two rows,
    their codes and each row's scales with up to 16 bytes before them."""
    return 2 * (18 * ch + 16)


def ring_stage_bytes(dim: int, hid: int = 0) -> int:
    """Shared-memory bytes before the rings: the staged vector of the widest
    input (each 32-value block padded to 36 floats) and the reduction
    slots."""
    return 4 * (max(dim, hid) // QK * _BLOCK_PAD + RING_WARPS)


def ring_chunk(stage_bytes: int, smem_optin: int) -> tuple[int, int] | None:
    """(Q40 blocks a chunk, the block's shared-memory bytes) of K8's and
    K9's rings beside ``stage_bytes`` of staged vector on a card that lets a
    block opt in to ``smem_optin`` bytes: the first of RING_CHUNKS whose
    RING_WARPS x RING_SLOTS slots fit, None where none does (the launch
    then fails)."""
    for ch in RING_CHUNKS:
        smem = stage_bytes + RING_WARPS * RING_SLOTS * ring_slot_bytes(ch)
        if smem <= smem_optin:
            return ch, smem
    return None


def ring_phases(dim: int, hid: int | None = None, rows: int | None = None
                ) -> list[tuple[int, int, int, int, int]]:
    """The matvec phases of K8 (``rows`` of wqkv over dim, hid None) or K9
    (wo, w13, w2 of a layer of width dim and hidden width hid), each
    (rows, nb, jobs, step, off): job j takes rows step * j and step * j +
    off."""
    nb = dim // QK
    if hid is None:
        return [(rows, nb, rows // 2, 2, 1)]
    return [(dim, nb, dim // 2, 2, 1), (2 * hid, nb, hid, 1, hid),
            (dim, hid // QK, dim // 2, 2, 1)]


def ring_jobs(jobs: int, grid: int, block: int, warp: int) -> range:
    """The jobs warp ``warp`` of block ``block`` takes in a phase of
    ``jobs`` on a grid of ``grid`` blocks: the block's band [jobs * block
    // grid, jobs * (block + 1) // grid), its warps in turn."""
    lo, hi = jobs * block // grid, jobs * (block + 1) // grid
    return range(lo + warp, hi, RING_WARPS)


def ring_scale_copies(d16_addr: int, row: int, nb: int, c0: int, n: int,
                      total: int) -> list[tuple[int, int]]:
    """The 16-byte copies (address, bytes read) that bring scales c0 ..
    c0 + n - 1 of ``row`` of a (rows, nb) f16 scale tensor at byte address
    ``d16_addr`` holding ``total`` scales into a slot: from the first's
    address rounded down to 16 bytes, the last copy cut at the tensor's
    end (its rest zero-filled)."""
    lo = d16_addr + 2 * (row * nb + c0)
    end = d16_addr + 2 * total
    out = []
    at = lo & ~15
    while at < lo + 2 * n:
        out.append((at, min(16, end - at)))
        at += 16
    return out


def mega_attention_split_model(q: torch.Tensor, k_all: torch.Tensor,
                               v_all: torch.Tensor, layer: int, pos: int,
                               kv_mul: int, grid: int) -> torch.Tensor:
    """K10's split attention in plain torch (a model for the tests; no
    route calls it): the keys 0..pos of each kv head cut as
    mega_attention_splits says, each split's online-softmax state (m, l,
    unnormalised o) in f32, then the splits merged in split order, m =
    max m_j, l = sum l_j e^(m_j - m), o = sum o_j e^(m_j - m), out = o /
    l. q (n_heads, hs) -> (1, n_heads * hs)."""
    n_kv, hs = k_all.shape[2], k_all.shape[3]
    keys = pos + 1
    splits, per = mega_attention_splits(keys, n_kv, grid)
    k = k_all[layer, :keys].to(torch.float32)  # (keys, n_kv, hs)
    v = v_all[layer, :keys].to(torch.float32)
    qg = q.to(torch.float32).reshape(n_kv, kv_mul, hs)
    scores = torch.einsum("gmd,tgd->gmt", qg, k) * attention_scale(hs)
    m = l = o = None
    for j in range(splits):
        sj = scores[..., j * per:(j + 1) * per]
        mj = sj.max(-1).values
        pj = torch.exp(sj - mj[..., None])
        lj = pj.sum(-1)
        oj = torch.einsum("gmt,tgd->gmd", pj, v[j * per:(j + 1) * per])
        if m is None:
            m, l, o = mj, lj, oj
            continue
        mx = torch.maximum(m, mj)
        a, b = torch.exp(m - mx), torch.exp(mj - mx)
        m, l, o = mx, l * a + lj * b, o * a[..., None] + oj * b[..., None]
    return (o / l[..., None]).reshape(1, -1)


def q40_layer_mega_plain(x: torch.Tensor, wqkv: Q40Weight, wo: Q40Weight,
                         w13: Q40Weight, w2: Q40Weight,
                         rms_att: torch.Tensor, rms_ffn: torch.Tensor,
                         freq: torch.Tensor, k_all: torch.Tensor,
                         v_all: torch.Tensor, layer: int, pos: torch.Tensor,
                         kv_mul: int) -> torch.Tensor:
    """K10's function: the head, k and v written at (layer, pos) of the
    (L, S, n_kv, hs) caches in their dtype, attention over keys 0..pos,
    then the tail. Reads pos on the host (a sync on the card), which only
    the kernel avoids. x (1, dim) -> (1, dim)."""
    _, _, n_kv, hs = k_all.shape
    dim, kv_dim = x.shape[-1], n_kv * hs
    qkv = q40_head_fused_plain(x, wqkv, rms_att, freq, pos)
    at = int(pos.reshape(-1)[0])
    k_all[layer, at] = qkv[0, dim:dim + kv_dim].reshape(n_kv, hs)
    v_all[layer, at] = qkv[0, dim + kv_dim:].reshape(n_kv, hs)
    ao = decode_attention_plain(qkv[0, :dim].reshape(-1, hs), k_all, v_all,
                                layer, at, kv_mul)
    return q40_tail_fused_plain(ao, x, wo, w13, w2, rms_ffn)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

class _Scratch(NamedTuple):
    """Static per-device buffers of K9 and K10: q and ao (dim), xnew
    (dim), hb (hid), the grid barrier's two counters, K10's attention
    partials (MEGA_MAX_SPLITS x (dim + 2 n_heads) f32, n_heads <= dim / 4)
    and its per-kv-head tickets (dim / 4 int32), the counters and tickets
    zero between launches. Made once per (device, widths), eagerly before
    any capture,
    and shared by every layer and model of those widths in the process:
    a captured step keeps their addresses, and the launches on one device
    run one after another on its stream, each leaving the counters at
    zero."""

    q: torch.Tensor
    ao: torch.Tensor
    xnew: torch.Tensor
    hb: torch.Tensor
    bar: torch.Tensor
    att: torch.Tensor
    tickets: torch.Tensor


_SCRATCH: dict = {}


def _scratch(device: torch.device, dim: int, hid: int) -> _Scratch:
    key = (device.index, dim, hid)
    if key not in _SCRATCH:
        def f32(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        def i32(n):
            return torch.zeros(n, dtype=torch.int32, device=device)

        _SCRATCH[key] = _Scratch(f32(dim), f32(dim), f32(dim), f32(hid),
                                 i32(2), f32(MEGA_MAX_SPLITS
                                             * (dim + dim // 2)),
                                 i32(max(1, dim // 4)))
    return _SCRATCH[key]


def _check(name: str, x: torch.Tensor, weights: dict, vectors: dict,
           pos: torch.Tensor | None = None) -> None:
    """Device, dtype and contiguity of every operand of a CUDA launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    for key, w in weights.items():
        qs, d16 = w.qs, w.d16
        if (qs.dim() != 3 or qs.shape[-1] != 16 or qs.dtype != torch.uint8
                or d16.dtype != torch.float16
                or tuple(d16.shape) != tuple(qs.shape[:2])):
            raise ValueError(f"{name}: {key} must be a Q40 layer view, qs "
                             f"uint8 (d, nb, 16) and d16 float16 (d, nb)")
        for t in (qs, d16):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous on "
                                 f"{x.device}")
        if qs.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    for key, t in vectors.items():
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be contiguous float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if pos is not None and (pos.dtype != torch.int32 or pos.numel() != 1
                            or pos.device != x.device):
        raise ValueError(f"{name}: pos must be one int32 on {x.device}, got "
                         f"{pos.dtype} {tuple(pos.shape)} on {pos.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def q40_head_fused(x: torch.Tensor, wqkv: Q40Weight, rms_att: torch.Tensor,
                   freq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The layer head, K8: x (1, dim) -> the rotated q|k and v rows (1,
    dim + 2*kv_dim), at device position pos (1,) int32. CPU tensors take
    the plain version."""
    if x.device.type == "cpu" and wqkv.qs.device.type == "cpu":
        return q40_head_fused_plain(x, wqkv, rms_att, freq, pos)
    _check("q40_head_fused", x, {"wqkv": wqkv},
           {"x": x, "rms_att": rms_att, "freq": freq}, pos)
    d, nb = wqkv.qs.shape[:2]
    n_rot = 2 * freq.numel()
    if x.numel() != nb * QK or rms_att.numel() != nb * QK or d % 2 \
            or n_rot > d:
        raise ValueError(f"q40_head_fused: x {tuple(x.shape)}, rms_att "
                         f"{tuple(rms_att.shape)}, freq {freq.numel()} do "
                         f"not fit wqkv ({d} x {nb * QK})")
    if any(t.data_ptr() % 16 for t in (x, rms_att)):
        raise ValueError("q40_head_fused: x and rms_att must be 16-byte "
                         "aligned")
    out = torch.empty((1, d), dtype=torch.float32, device=x.device)
    HEAD_KERNEL.launch(wqkv.qs.data_ptr(), wqkv.d16.data_ptr(), x.data_ptr(),
                       rms_att.data_ptr(), freq.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), d, nb, n_rot, _stream(x))
    return out


def _tail_shapes(name, x, wo, w13, w2, vectors) -> tuple[int, int]:
    dim = x.numel()
    hid = w13.qs.shape[0] // 2
    if (tuple(wo.qs.shape[:2]) != (dim, dim // QK)
            or tuple(w13.qs.shape[:2]) != (2 * hid, dim // QK)
            or tuple(w2.qs.shape[:2]) != (dim, hid // QK)
            or dim % QK or hid % QK
            or any(v.numel() != dim for v in vectors)):
        raise ValueError(f"{name}: wo {tuple(wo.qs.shape)}, w13 "
                         f"{tuple(w13.qs.shape)}, w2 {tuple(w2.qs.shape)} "
                         f"do not fit a layer of width {dim}")
    return dim, hid


def q40_tail_fused(ao: torch.Tensor, x: torch.Tensor, wo: Q40Weight,
                   w13: Q40Weight, w2: Q40Weight,
                   rms_ffn: torch.Tensor) -> torch.Tensor:
    """The layer tail, K9: the attention output ao and the layer input x
    (1, dim) -> the layer output (1, dim). CPU tensors take the plain
    version."""
    if x.device.type == "cpu" and wo.qs.device.type == "cpu":
        return q40_tail_fused_plain(ao, x, wo, w13, w2, rms_ffn)
    _check("q40_tail_fused", x, {"wo": wo, "w13": w13, "w2": w2},
           {"ao": ao, "x": x, "rms_ffn": rms_ffn})
    dim, hid = _tail_shapes("q40_tail_fused", x, wo, w13, w2,
                            (ao, rms_ffn))
    if any(t.data_ptr() % 16 for t in (ao, rms_ffn)):
        raise ValueError("q40_tail_fused: ao and rms_ffn must be 16-byte "
                         "aligned")
    s = _scratch(x.device, dim, hid)
    out = torch.empty((1, dim), dtype=torch.float32, device=x.device)
    TAIL_KERNEL.launch(wo.qs.data_ptr(), wo.d16.data_ptr(),
                       w13.qs.data_ptr(), w13.d16.data_ptr(),
                       w2.qs.data_ptr(), w2.d16.data_ptr(), ao.data_ptr(),
                       x.data_ptr(), rms_ffn.data_ptr(), out.data_ptr(),
                       s.xnew.data_ptr(), s.hb.data_ptr(), s.bar.data_ptr(),
                       dim, hid, _stream(x))
    return out


def q40_layer_mega(x: torch.Tensor, wqkv: Q40Weight, wo: Q40Weight,
                   w13: Q40Weight, w2: Q40Weight, rms_att: torch.Tensor,
                   rms_ffn: torch.Tensor, freq: torch.Tensor,
                   k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
                   pos: torch.Tensor, kv_mul: int) -> torch.Tensor:
    """The whole layer, K10: x (1, dim) -> (1, dim), its k and v written in
    place at (layer, pos) of the (L, S, n_kv, hs) caches (f32 or bf16), pos
    a device (1,) int32. CPU tensors take the plain version."""
    if x.device.type == "cpu" and wqkv.qs.device.type == "cpu":
        return q40_layer_mega_plain(x, wqkv, wo, w13, w2, rms_att, rms_ffn,
                                    freq, k_all, v_all, layer, pos, kv_mul)
    _check("q40_layer_mega", x,
           {"wqkv": wqkv, "wo": wo, "w13": w13, "w2": w2},
           {"x": x, "rms_att": rms_att, "rms_ffn": rms_ffn, "freq": freq},
           pos)
    dim, hid = _tail_shapes("q40_layer_mega", x, wo, w13, w2,
                            (rms_att, rms_ffn))
    if (k_all.dim() != 4 or k_all.shape != v_all.shape
            or k_all.dtype not in CACHE_DTYPES or v_all.dtype != k_all.dtype
            or k_all.device != x.device or v_all.device != x.device
            or not (k_all.is_contiguous() and v_all.is_contiguous())):
        raise ValueError(f"q40_layer_mega: the caches must be equal "
                         f"contiguous (L, S, n_kv, hs) float32 or bfloat16 "
                         f"on {x.device}, got {k_all.dtype} "
                         f"{tuple(k_all.shape)} and {v_all.dtype} "
                         f"{tuple(v_all.shape)}")
    n_layers, seq_len, n_kv, hs = k_all.shape
    kv_dim = n_kv * hs
    if (kv_mul not in _KV_MULS or hs % 4 or hs > _MAX_HEAD
            or dim > _MEGA_MAX_DIM
            or n_kv * kv_mul * hs != dim or not 0 <= layer < n_layers
            or tuple(wqkv.qs.shape[:2]) != (dim + 2 * kv_dim, dim // QK)
            or 2 * freq.numel() != dim + kv_dim):
        raise ValueError(f"q40_layer_mega: kv_mul {kv_mul}, cache "
                         f"{tuple(k_all.shape)}, layer {layer}, wqkv "
                         f"{tuple(wqkv.qs.shape)} and freq {freq.numel()} do "
                         f"not fit a layer of width {dim} (the kernel takes "
                         f"kv_mul in {_KV_MULS}, head size a multiple of "
                         f"4 up to {_MAX_HEAD} and width up to "
                         f"{_MEGA_MAX_DIM})")
    if any(t.data_ptr() % 16 for t in (x, rms_att, rms_ffn)):
        raise ValueError("q40_layer_mega: x, rms_att and rms_ffn must be "
                         "16-byte aligned")
    s = _scratch(x.device, dim, hid)
    out = torch.empty((1, dim), dtype=torch.float32, device=x.device)
    MEGA_KERNEL.launch(
        wqkv.qs.data_ptr(), wqkv.d16.data_ptr(), wo.qs.data_ptr(),
        wo.d16.data_ptr(), w13.qs.data_ptr(), w13.d16.data_ptr(),
        w2.qs.data_ptr(), w2.d16.data_ptr(), x.data_ptr(),
        rms_att.data_ptr(), rms_ffn.data_ptr(), freq.data_ptr(),
        pos.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), out.data_ptr(),
        s.q.data_ptr(), s.ao.data_ptr(), s.xnew.data_ptr(), s.hb.data_ptr(),
        s.bar.data_ptr(), s.att.data_ptr(), s.tickets.data_ptr(), layer,
        dim, hid, seq_len, n_kv, kv_mul, hs,
        attention_scale(hs), int(k_all.dtype == torch.bfloat16), _stream(x))
    return out
