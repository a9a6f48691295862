"""Matmul dispatch over weight dtypes, the norm/activation glue, and the
load-time Q40 weight preparation.

Semantics (the JAX package's ops/linear.py, the logit-parity contract):
* matmul: weight w of shape (d, n), out[i] = sum_j w[i,j] * x[..., j], f32
  accumulation. Q40 weights go to the Q40 matvec (ops/q40.py); dense F32/F16
  weights go to one f32 ``F.linear`` (``dense_matmul``), as the JAX package
  leaves its dense weights to an XLA einsum. Under ``--fast-prefill`` the
  dense product takes bf16-rounded operands with f32 output
  (``dense_matmul_bf16``, the JAX package's bf16 einsum branch), still
  plain torch: no Pallas kernel computes it there either.
* rms: 1/sqrt(sum(x^2)/size + 1e-5) — eps added AFTER the mean.
* rmsnorm(x, w) = x * rms(x) * w.
* silu(x) = x / (1 + e^-x).
* fake_quant_q80: the Q80 round trip of ``--buffer-float-type q80``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..io.loader import Q40Weight
from .q40 import q40_matmul
from .quants import dequantize_q80_torch, quantize_q80_torch

RMS_EPS = 1e-5


def rms_inv(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``rms()``: inverse RMS with eps added after the mean."""
    ss = torch.sum(x.to(torch.float32) ** 2, dim=-1, keepdim=True)
    ss = ss / x.shape[-1] + RMS_EPS
    return torch.rsqrt(ss)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return (x * rms_inv(x)) * weight


def silu(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.exp(-x))


def dense_matmul(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[..., d] = w(d, n) @ x[..., n], f32 operands and output."""
    return F.linear(x.to(torch.float32), w.to(torch.float32))


def dense_matmul_bf16(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The same over operands rounded to bf16 (nearest even), f32 output.
    The products of two bf16 values are exact in f32, so this is the JAX
    package's ``einsum(bf16(W), bf16(x), preferred_element_type=f32)`` up
    to the order of the sum. (``F.linear`` on two bf16 tensors would return
    bf16 and round the sums.)"""
    def bf16(t):
        return t.to(torch.float32).to(torch.bfloat16).to(torch.float32)

    return F.linear(bf16(x), bf16(w))


def matmul(w, x: torch.Tensor,
           q40: Callable[[Q40Weight, torch.Tensor], torch.Tensor] = q40_matmul,
           dense: Callable[[torch.Tensor, torch.Tensor],
                           torch.Tensor] = dense_matmul) -> torch.Tensor:
    """out[..., d] = w(d, n) @ x[..., n] with f32 accumulation.

    ``w`` is a dense f32/f16 tensor, which goes to ``dense``, or a
    ``Q40Weight``, which goes to ``q40`` (the kernel wrapper by default; a
    caller that compares the kernel with its plain version passes
    ``q40_matmul_plain``)."""
    if isinstance(w, Q40Weight):
        return q40(w, x)
    return dense(w, x)


def fake_quant_q80(x: torch.Tensor) -> torch.Tensor:
    """Quantize -> dequantize through Q80 (``--buffer-float-type q80``): the
    value rounding the reference applies to every activation it quantizes
    before a matmul. Plain tensor code on any device (no kernel)."""
    return dequantize_q80_torch(*quantize_q80_torch(x))


# the load-time fusions (fused key -> its parts, in row order): the three
# qkv matmuls and the two SwiGLU input matmuls share one input vector, so
# one wide kernel launch replaces three (two) narrow ones; row-wise the
# math is unchanged, and models/llama splits the outputs back
FUSED_LOAD = {"wqkv": ("wq", "wk", "wv"), "w13": ("w1", "w3")}


def fusible(params: dict, keys) -> list[Q40Weight] | None:
    """The weights ``keys`` names when all are stacked host Q40 weights
    (L, d, nb, 16), which fuse; else None."""
    ws = [params.get(k) for k in keys]
    if all(isinstance(w, Q40Weight) and isinstance(w.qs, np.ndarray)
           and w.qs.ndim == 4 for w in ws):
        return ws
    return None


def q40_concat_to_device(ws: list[Q40Weight],
                         device: torch.device) -> Q40Weight:
    """Stacked host Q40 weights (L, d_i, nb, 16) concatenated along their
    rows (a FUSED_LOAD fusion), made on the device: one tensor is
    allocated there and each weight's layers are copied into their rows,
    so neither the host nor the device holds a second copy of the parts
    (a host concatenation took ~2.6 s at 7B, a third of a load)."""
    n_layers, nb = ws[0].qs.shape[0], ws[0].qs.shape[2]
    rows = sum(w.qs.shape[1] for w in ws)
    qs = torch.empty((n_layers, rows, nb, 16), dtype=torch.uint8,
                     device=device)
    d16 = torch.empty((n_layers, rows, nb), dtype=torch.float16,
                      device=device)
    lo = 0
    for w in ws:
        hi = lo + w.qs.shape[1]
        for i in range(n_layers):
            qs[i, lo:hi].copy_(torch.from_numpy(np.ascontiguousarray(
                w.qs[i])))
            d16[i, lo:hi].copy_(torch.from_numpy(np.ascontiguousarray(
                w.d16[i])))
        lo = hi
    return Q40Weight(qs, d16)


def q40_to_device(w: Q40Weight, device: torch.device) -> Q40Weight:
    """Place a host Q40 weight in the port's device layout: the codec layout
    itself, qs uint8 (..., d, nb, 16) and d16 float16 (..., d, nb), both
    contiguous. The TPU package re-tiled here for Mosaic ((16, d, nb),
    nb-major, int4 planes, f32 scales); on the GPU the codec layout already
    gives one aligned 16-byte load per block, and the f16 scales are widened
    in registers."""
    qs = torch.from_numpy(np.ascontiguousarray(w.qs)).to(device)
    d16 = torch.from_numpy(np.ascontiguousarray(w.d16)).to(device)
    if qs.data_ptr() % 16:
        raise ValueError("Q40 codes must start 16-byte aligned on the device")
    return Q40Weight(qs, d16)
