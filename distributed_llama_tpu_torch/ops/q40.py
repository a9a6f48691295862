"""Q40 matmul: five hand-written CUDA kernels and their plain PyTorch
versions.

``q40_matmul(w, x)`` computes ``out[t, r] = sum_b d16[r,b] * sum_j
(code[r,b,j] - 8) * x[t, 32b+j]`` in f32 on the codec layout (see
io/loader.Q40Weight), for T = x.numel() // n tokens. On a CUDA tensor it
dispatches on T as the JAX package's ops/pallas_q40.py ``q40_matmul`` does
on ``MULTI_T_MAX``:

* T = 1: K1, ``csrc/q40_matvec.cu`` ``q40_matvec`` (the T=1 matvec
  bodies, every TPU tiling), bound by the packed weight bytes;
* 2 <= T <= 8: K1m, ``csrc/q40_matvec.cu`` ``q40_matvec_multi``
  (``_kernel_multi`` -> ``_matvec_body_multi``), one unpack of each weight
  block for all T rows;
* T > 8: K3, ``csrc/q40_gemm.cu`` (``_kernel`` -> ``_matmul_body`` in f32
  parity mode, and its scratch / nb-major tilings), a tiled SIMT GEMM bound
  by its f32 operations;
* T > 8 with ``bf16=True`` (``--fast-prefill``, the JAX package's
  ``q40_matmul`` under ``matmul_precision("bf16")``): K3b,
  ``csrc/q40_gemm_bf16.cu``, the same sum over bf16-rounded x and
  bf16-rounded dequantized weights with f32 accumulation, on the tensor
  cores. At T <= 8 the flag changes nothing, as the JAX package's T=1 and
  small-T bodies ignore it;
* 2 <= T <= 8 with ``multi_body="dequant"`` (the JAX package's
  ``DLLAMA_MULTI_T_BODY=dequant``, ``_kernel_multi_dequant``): K1d,
  ``csrc/q40_matvec_bf16.cu``, K3b's function at small T on the tensor
  cores, bound by the packed weight bytes as K1 is.

The body is an argument: the caller reads ``DLLAMA_MULTI_T_BODY`` once
(``multi_t_body``) and passes it down; the op never reads the environment.

The sources say how each design meets its bound. ``q40_matmul`` takes the
plain versions only for tensors on the CPU; on a CUDA tensor it launches
one of the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..io.loader import Q40Weight
from ._build import CudaKernel
from .quants import QK, dequantize_q40_torch

KERNEL = CudaKernel("q40_matvec.cu", "q40_matvec",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
KERNEL_MULTI = CudaKernel("q40_matvec.cu", "q40_matvec_multi",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
KERNEL_GEMM = CudaKernel("q40_gemm.cu", "q40_gemm",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
KERNEL_GEMM_BF16 = CudaKernel("q40_gemm_bf16.cu", "q40_gemm_bf16",
                              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])
KERNEL_MULTI_BF16 = CudaKernel("q40_matvec_bf16.cu", "q40_matvec_bf16",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
KERNELS = (KERNEL, KERNEL_MULTI, KERNEL_GEMM, KERNEL_GEMM_BF16,
           KERNEL_MULTI_BF16)
MULTI_T_BODIES = ("vpu", "dequant")

MULTI_T_MAX = 8  # T above this takes the GEMM (the JAX package's threshold)

_SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
_SMEM_PER_BLOCK = 144  # K1's staged bytes per 32-value block of x (36 floats)

# |kernel - plain| <= KERNEL_RTOL * max|plain|: they differ in summation
# order only (both f32)
KERNEL_RTOL = 1e-4
# the same for K3b and K1d against q40_matmul_bf16_plain: both sum the same
# exact products of bf16 values in f32, but the tensor cores add in another
# order and in wider steps than cuBLAS's f32 GEMM
KERNEL_RTOL_BF16 = 1e-3


def multi_t_body() -> str:
    """The 2 <= T <= 8 body the JAX package picks: ``DLLAMA_MULTI_T_BODY``,
    'vpu' (the default: the exact f32 K1m) or 'dequant' (bf16 products with
    f32 accumulation: K1d). An unknown value raises, as a typo would
    otherwise run the default. Read once by the engines, never by
    ``q40_matmul``."""
    import os

    mode = os.environ.get("DLLAMA_MULTI_T_BODY") or "vpu"  # '' = unset
    if mode not in MULTI_T_BODIES:
        raise ValueError(f"DLLAMA_MULTI_T_BODY={mode!r}: expected "
                         f"vpu|dequant")
    return mode


def random_q40(d: int, n: int, device, generator: torch.Generator
               ) -> Q40Weight:
    """A (d, n) Q40 weight with uniform random codes and scales in
    [1e-4, 0.0101), made on ``device`` from ``generator`` — the input on
    which the kernels are held against their plain version."""
    nb = n // QK
    qs = torch.randint(0, 256, (d, nb, 16), dtype=torch.uint8, device=device,
                       generator=generator)
    d16 = (torch.rand((d, nb), device=device, generator=generator) * 0.01
           + 1e-4).to(torch.float16)
    return Q40Weight(qs, d16)


def _tokens(w: Q40Weight, x: torch.Tensor) -> int:
    return x.numel() // (w.qs.shape[-2] * QK)


def q40_matmul_bf16_plain(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """K3b's function: x and the dequantized weight rounded to bf16 (nearest
    even; the weight after its exact f32 product with the scale), then one
    f32 product. A product of two bf16 values is exact in f32, so this is
    the JAX package's bf16 einsum up to the order of the sum."""
    xb = x.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    wb = dequantize_q40_torch(w.qs, w.d16).to(torch.bfloat16)
    return F.linear(xb, wb.to(torch.float32))


def _bf16_body(t: int, bf16: bool, multi_body: str) -> bool:
    """Whether T tokens take bf16 products: T > 8 under ``bf16`` (K3b),
    2 <= T <= 8 under the 'dequant' body (K1d)."""
    if multi_body not in MULTI_T_BODIES:
        raise ValueError(f"q40_matmul: multi_body {multi_body!r}, expected "
                         f"one of {MULTI_T_BODIES}")
    if t > MULTI_T_MAX:
        return bf16
    return t >= 2 and multi_body == "dequant"


def q40_matmul_plain(w: Q40Weight, x: torch.Tensor, bf16: bool = False,
                     multi_body: str = "vpu") -> torch.Tensor:
    """Dequantize, then one f32 product: out[..., d] = W(d, n) @ x[..., n].
    The plain version of K1, K1m and K3 alike; with ``bf16`` and T > 8, or
    with ``multi_body="dequant"`` and 2 <= T <= 8, that of K3b and K1d
    (q40_matmul_bf16_plain)."""
    if _bf16_body(_tokens(w, x), bf16, multi_body):
        return q40_matmul_bf16_plain(w, x)
    return F.linear(x.to(torch.float32), dequantize_q40_torch(w.qs, w.d16))


def _check(w: Q40Weight, x: torch.Tensor) -> tuple[int, int]:
    qs, d16 = w.qs, w.d16
    if qs.dim() != 3 or qs.shape[-1] != 16 or qs.dtype != torch.uint8:
        raise ValueError(f"q40_matmul: qs must be uint8 (d, nb, 16), got "
                         f"{qs.dtype} {tuple(qs.shape)}")
    d, nb = qs.shape[0], qs.shape[1]
    if d16.dtype != torch.float16 or tuple(d16.shape) != (d, nb):
        raise ValueError(f"q40_matmul: d16 must be float16 ({d}, {nb}), got "
                         f"{d16.dtype} {tuple(d16.shape)}")
    if x.dtype != torch.float32 or x.shape[-1] != nb * QK:
        raise ValueError(f"q40_matmul: x must be float32 (..., {nb * QK}), "
                         f"got {x.dtype} {tuple(x.shape)}")
    for name, t in (("qs", qs), ("d16", d16), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"q40_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"q40_matmul: {name} must be contiguous")
    for name, t in (("qs", qs), ("x", x)):
        if t.data_ptr() % 16:
            raise ValueError(f"q40_matmul: {name} must be 16-byte aligned")
    return d, nb


def q40_matmul(w: Q40Weight, x: torch.Tensor, bf16: bool = False,
               multi_body: str = "vpu") -> torch.Tensor:
    """out[..., d] = dequant(w)(d, n) @ x[..., n], f32.

    CPU tensors take the plain version; CUDA tensors launch K1 (T = 1), for
    2 <= T <= 8 K1m (``multi_body="vpu"``) or K1d ("dequant"), and for
    T > 8 K3 (f32) or K3b (``bf16``).
    """
    if x.device.type == "cpu" and w.qs.device.type == "cpu":
        return q40_matmul_plain(w, x, bf16, multi_body)
    if x.device.type != "cuda":
        raise ValueError(f"q40_matmul: no kernel for device {x.device}")
    d, nb = _check(w, x)
    t = _tokens(w, x)
    out = torch.empty((*x.shape[:-1], d), dtype=torch.float32,
                      device=x.device)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (w.qs.data_ptr(), w.d16.data_ptr(), x.data_ptr(), out.data_ptr())
    if t == 1:
        if nb * _SMEM_PER_BLOCK > _SMEM_LIMIT:
            raise ValueError(f"q40_matmul: input width {nb * QK} exceeds "
                             f"the T=1 kernel's shared-memory staging of x")
        KERNEL.launch(*ptrs, d, nb, stream)
    elif t <= MULTI_T_MAX:
        kernel = (KERNEL_MULTI_BF16 if _bf16_body(t, bf16, multi_body)
                  else KERNEL_MULTI)
        kernel.launch(*ptrs, t, d, nb, stream)
    else:
        (KERNEL_GEMM_BF16 if bf16 else KERNEL_GEMM).launch(*ptrs, t, d, nb,
                                                           stream)
    return out
