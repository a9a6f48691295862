"""Q40 block codec: numpy (file/wire parity) and torch (device decode).

Format parity with the reference (same file bytes, same decoded values):
blocks of 32 values -> one float16 delta + 16 bytes of packed 4-bit codes.
Byte ``j`` holds value ``j`` in its LOW nibble and value ``j+16`` in its HIGH
nibble. Decode is ``(code - 8) * delta``. Encode picks
``delta = signed-max-magnitude / -8``, scales by ``1/delta`` (computed in f32
before the f16 rounding of delta), offsets by +8.5, clamps to 15 and
truncates.

Planar layout: ``(qs uint8 [..., nb, 16], d16 float16 [..., nb])`` — the
codec layout, which is also the port's device layout (one block is one
aligned 16-byte load).

Q80 (the ``--buffer-float-type q80`` activation codec): blocks of 32 values
-> one float16 delta ``amax / 127`` + 32 int8 codes ``rint(x / delta)``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

QK = 32  # values per Q40 block


class FloatType(enum.IntEnum):
    """Weight/buffer dtypes, with the reference's codes."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3


_BLOCK_BYTES = {
    FloatType.F32: (1, 4),     # (values per batch, bytes per batch)
    FloatType.F16: (1, 2),
    FloatType.Q40: (QK, 18),   # f16 delta + 16 nibble bytes
    FloatType.Q80: (QK, 34),   # f16 delta + 32 int8
}


def batch_bytes(ftype: FloatType, n: int, d: int = 1) -> int:
    """Bytes of an (d, n) tensor in ``ftype``; quant blocks never span rows."""
    per, nbytes = _BLOCK_BYTES[FloatType(ftype)]
    if n % per != 0:
        raise ValueError(f"row length {n} not divisible by block size {per}")
    return (n // per) * d * nbytes


def quantize_q40(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode f32 -> (qs uint8 [..., n/32, 16], delta float16 [..., n/32])."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[-1]
    if n % QK != 0:
        raise ValueError(f"last dim {n} not divisible by {QK}")
    g = x.reshape(*x.shape[:-1], n // QK, QK)
    gmax = g.max(axis=-1)
    gmin = g.min(axis=-1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / np.float32(-8.0)
    deltas16 = deltas.astype(np.float16)
    with np.errstate(divide="ignore"):  # zero blocks take the where-branch
        ids = np.where(deltas != 0, np.float32(1.0) / deltas, np.float32(0.0))
    q = g * ids[..., None] + np.float32(8.5)
    # np.where (not minimum): NaN clamps to 15, like the reference converter
    q = np.where(q < np.float32(15.0), q, np.float32(15.0))
    q = q.astype(np.int32)  # truncation toward zero
    lo = q[..., :QK // 2] & 0xF
    hi = q[..., QK // 2:] & 0xF
    qs = (lo | (hi << 4)).astype(np.uint8)
    return qs, deltas16


def dequantize_q40(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Decode (qs uint8 [..., nb, 16], d f16 [..., nb]) -> f32 [..., nb*32]."""
    lo = (qs & 0xF).astype(np.int8) - np.int8(8)
    hi = (qs >> 4).astype(np.int8) - np.int8(8)
    codes = np.concatenate([lo, hi], axis=-1).astype(np.float32)  # [..., nb, 32]
    y = codes * d.astype(np.float32)[..., None]
    return y.reshape(*qs.shape[:-2], qs.shape[-2] * QK)


def dequantize_q40_torch(qs: torch.Tensor, d16: torch.Tensor) -> torch.Tensor:
    """Torch decode of planar Q40 -> f32 [..., nb*32]; the numpy value map,
    on whatever device the tensors live. Exact: (code - 8) * f16 delta is
    representable in f32."""
    lo = (qs & 0xF).to(torch.float32) - 8.0
    hi = (qs >> 4).to(torch.float32) - 8.0
    codes = torch.cat([lo, hi], dim=-1)                       # [..., nb, 32]
    y = codes * d16.to(torch.float32).unsqueeze(-1)
    return y.reshape(*qs.shape[:-2], qs.shape[-2] * QK)


def quantize_q80(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode f32 -> (qs int8 [..., nb, 32], delta float16 [..., nb]):
    ``d = amax / 127`` in f32, codes ``rint(x / d)`` (ties to even, computed
    as ``x * (1/d)`` with ``1/d = 0`` for an all-zero block)."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[-1]
    if n % QK != 0:
        raise ValueError(f"last dim {n} not divisible by {QK}")
    g = x.reshape(*x.shape[:-1], n // QK, QK)
    d = np.abs(g).max(axis=-1) / np.float32(127.0)
    with np.errstate(divide="ignore"):  # zero blocks take the where-branch
        id_ = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    qs = np.rint(g * id_[..., None]).astype(np.int8)
    return qs, d.astype(np.float16)


def dequantize_q80(qs: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Decode (qs int8 [..., nb, 32], d f16 [..., nb]) -> f32 [..., nb*32]."""
    y = qs.astype(np.float32) * d.astype(np.float32)[..., None]
    return y.reshape(*qs.shape[:-2], qs.shape[-2] * QK)


def quantize_q80_torch(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Torch twin of quantize_q80 on any device: the same f32 arithmetic,
    ``torch.round`` rounding ties to even as ``np.rint`` does."""
    n = x.shape[-1]
    if n % QK != 0:
        raise ValueError(f"last dim {n} not divisible by {QK}")
    g = x.to(torch.float32).reshape(*x.shape[:-1], n // QK, QK)
    d = g.abs().amax(dim=-1) / 127.0
    id_ = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
    qs = torch.round(g * id_.unsqueeze(-1)).to(torch.int8)
    return qs, d.to(torch.float16)


def dequantize_q80_torch(qs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Torch twin of dequantize_q80: codes times the f16 delta widened to
    f32 (exact)."""
    y = qs.to(torch.float32) * d.to(torch.float32).unsqueeze(-1)
    return y.reshape(*qs.shape[:-2], qs.shape[-2] * QK)


def pack_q40_bytes(qs: np.ndarray, d: np.ndarray) -> bytes:
    """Planar -> reference wire bytes (f16 delta || 16 qs bytes per block)."""
    nb = int(np.prod(qs.shape[:-1]))
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, :2] = d.reshape(nb, 1).view(np.uint8)
    out[:, 2:] = qs.reshape(nb, 16)
    return out.tobytes()


def unpack_q40_bytes(buf: np.ndarray | bytes,
                     shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Reference wire bytes -> planar (qs [..., nb, 16], d [..., nb]).

    ``shape`` is the logical f32 shape, last dim divisible by 32.
    """
    n = shape[-1]
    nb = n // QK
    lead = tuple(shape[:-1])
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(*lead, nb, 18)
    # always materialize fresh writable arrays (never alias the input buffer)
    d = raw[..., :2].copy().view(np.float16)[..., 0]
    qs = raw[..., 2:].copy()
    return qs, d
