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


def fuse_q40_layer_matmuls(params: dict) -> dict:
    """Concatenate the stacked Q40 q/k/v (and w1/w3) weights along the output
    dim into single tensors ``wqkv`` / ``w13``, host-side, at load.

    The three qkv matmuls (and the two SwiGLU input matmuls) share one input
    vector; one wide kernel launch replaces three (two) narrow ones. Row-wise
    the math is unchanged — models/llama splits the outputs back. Fires on
    stacked (L, d, nb, 16) numpy Q40 weights only; dense trees pass through.
    """
    out = dict(params)

    def fuse(dst, keys):
        ws = [out.get(k) for k in keys]
        if not all(isinstance(w, Q40Weight) and isinstance(w.qs, np.ndarray)
                   and w.qs.ndim == 4 for w in ws):
            return
        out[dst] = Q40Weight(np.concatenate([w.qs for w in ws], axis=1),
                             np.concatenate([w.d16 for w in ws], axis=1))
        for k in keys:
            del out[k]

    fuse("wqkv", ("wq", "wk", "wv"))
    fuse("w13", ("w1", "w3"))
    return out


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
