""".bin model file reader/writer (reference format parity).

The reader walks the exact tensor order of the format (see models/spec.py)
and returns a numpy parameter tree with per-layer weights stacked along a
leading layer axis. Q40 matmul weights come back as ``Q40Weight(qs, d16)``
planar pairs; F16 as float16 arrays; F32 as float32. Moving the tree onto a
device is models/llama.params_to_device.

The writer emits the same byte layout; the legacy freq_cis gap is written as
zeros.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np

from ..models.spec import HEADER_BYTES, TransformerSpec
from ..ops.quants import FloatType, pack_q40_bytes, quantize_q40


class Q40Weight(NamedTuple):
    """Planar Q40 tensor: qs uint8 (..., d, n/32, 16), d16 float16
    (..., d, n/32) — numpy arrays on the host, torch tensors on a device.

    This codec layout is also the port's device layout: a block's 16 code
    bytes are one aligned 16-byte load, its f16 scale is widened in
    registers, and layer ``i`` of a stacked weight is the zero-copy view
    ``Q40Weight(qs[i], d16[i])``.
    """

    qs: Any
    d16: Any


def read_spec(path: str, weights_float_type=FloatType.F32,
              buffer_float_type=FloatType.F32) -> TransformerSpec:
    with open(path, "rb") as f:
        raw = f.read(HEADER_BYTES)
    return TransformerSpec.from_header(raw, weights_float_type, buffer_float_type)


class _Walker:
    def __init__(self, mm: np.ndarray, offset: int):
        self.mm = mm
        self.off = offset

    def take(self, nbytes: int) -> np.ndarray:
        chunk = self.mm[self.off:self.off + nbytes]
        if chunk.nbytes != nbytes:
            raise ValueError(
                f"file truncated: wanted {nbytes} bytes at {self.off}, "
                f"got {chunk.nbytes}")
        self.off += nbytes
        return chunk

    def f32(self, shape: tuple[int, ...]) -> np.ndarray:
        n = int(np.prod(shape))
        return self.take(n * 4).view(np.float32).reshape(shape).copy()

    def matmul(self, spec: TransformerSpec, shape: tuple[int, int]):
        ft = spec.weights_float_type
        if ft == FloatType.Q40:
            d, n = shape
            w = Q40Weight(np.empty((d, n // 32, 16), np.uint8),
                          np.empty((d, n // 32), np.float16))
            self.q40_into(spec, shape, w)
            return w
        raw = self.take(spec.matmul_bytes(shape))
        if ft == FloatType.F32:
            return raw.view(np.float32).reshape(shape).copy()
        if ft == FloatType.F16:
            return raw.view(np.float16).reshape(shape).copy()
        raise ValueError(f"unsupported weights float type {ft}")

    def q40_into(self, spec: TransformerSpec, shape: tuple[int, int],
                 out: Q40Weight) -> None:
        """Decode one Q40 matmul weight of the wire layout (blocks of a
        2-byte f16 scale and 16 code bytes) into ``out``'s planes in place
        (q40_blocks_into)."""
        raw = self.take(spec.matmul_bytes(shape))
        q40_blocks_into(raw.view(Q40_BLOCK).reshape(out.d16.shape), out)


# one Q40 block of the wire layout: the f16 scale, then 16 code bytes
Q40_BLOCK = np.dtype([("d", "<u2"), ("qs", "V16")])


def q40_blocks_into(blocks: np.ndarray, out: Q40Weight) -> None:
    """Copy Q40_BLOCK records (..., nb) into ``out``'s planes: the scales'
    bits, and each block's 16 code bytes as one 16-byte element (2.4x the
    speed of the copy as eight 16-bit words)."""
    np.copyto(out.d16.view(np.uint16), blocks["d"])
    np.copyto(out.qs.view("V16").reshape(blocks.shape), blocks["qs"])


def load_model(path: str, spec: TransformerSpec | None = None,
               weights_float_type=FloatType.F32,
               buffer_float_type=FloatType.F32) -> tuple[TransformerSpec, dict]:
    """Load a .bin file into a stacked-layer numpy param tree.

    The file is memory-mapped and its size checked byte-exactly against the
    spec before anything is read.
    """
    if spec is None:
        spec = read_spec(path, weights_float_type, buffer_float_type)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    expected = spec.file_size()
    if mm.nbytes != expected:
        raise ValueError(
            f"file size mismatch: {path} has {mm.nbytes} bytes, "
            f"spec requires {expected}")
    w = _Walker(mm, HEADER_BYTES)

    params: dict = {}
    params["tok_embedding"] = w.f32((spec.vocab_size, spec.dim))

    # preallocate the stacked arrays and stream each layer straight into its
    # slot (no list-of-layers + np.stack copies of multi-GB tensors)
    shapes = spec.layer_matmul_shapes()
    L = spec.n_layers
    ft = spec.weights_float_type
    params["rms_att"] = np.empty((L, spec.dim), np.float32)
    params["rms_ffn"] = np.empty((L, spec.dim), np.float32)
    for name, (dd, nn) in shapes:
        if ft == FloatType.Q40:
            params[name] = Q40Weight(np.empty((L, dd, nn // 32, 16), np.uint8),
                                     np.empty((L, dd, nn // 32), np.float16))
        else:
            dtype = np.float32 if ft == FloatType.F32 else np.float16
            params[name] = np.empty((L, dd, nn), dtype)
    for layer in range(L):
        params["rms_att"][layer] = w.f32((spec.dim,))
        params["rms_ffn"][layer] = w.f32((spec.dim,))
        for name, shape in shapes:
            dst = params[name]
            if isinstance(dst, Q40Weight):
                w.q40_into(spec, shape, Q40Weight(dst.qs[layer],
                                                  dst.d16[layer]))
            else:
                dst[layer] = w.matmul(spec, shape)

    params["rms_final"] = w.f32((spec.dim,))
    w.take(spec.rope_gap_bytes)  # legacy freq_cis region, skipped
    params["wcls"] = w.matmul(spec, (spec.vocab_size, spec.dim))

    if w.off != expected:
        raise ValueError(f"missed {expected - w.off} bytes")
    return spec, params


class TensorRange(NamedTuple):
    """One tensor's byte placement in the .bin: ``rows`` is the output dim
    of a matmul tensor (whose row ``i`` is the contiguous bytes
    [offset + i*(nbytes/rows), offset + (i+1)*(nbytes/rows))), None for the
    replicated tensors (embedding, norms) and the RoPE gap."""

    name: str
    layer: int | None
    offset: int
    nbytes: int
    rows: int | None


def tensor_byte_ranges(spec: TransformerSpec) -> list[TensorRange]:
    """The byte placement of every tensor in a .bin of ``spec``, in
    load_model's order (the offset table io/stream fetches against)."""
    out: list[TensorRange] = []
    off = HEADER_BYTES

    def add(name, layer, nbytes, rows=None):
        nonlocal off
        out.append(TensorRange(name, layer, off, nbytes, rows))
        off += nbytes

    add("tok_embedding", None, spec.vocab_size * spec.dim * 4)
    shapes = spec.layer_matmul_shapes()
    for layer in range(spec.n_layers):
        add("rms_att", layer, spec.dim * 4)
        add("rms_ffn", layer, spec.dim * 4)
        for name, shape in shapes:
            add(name, layer, spec.matmul_bytes(shape), rows=shape[0])
    add("rms_final", None, spec.dim * 4)
    add("_rope_gap", None, spec.rope_gap_bytes)
    add("wcls", None, spec.matmul_bytes((spec.vocab_size, spec.dim)),
        rows=spec.vocab_size)
    if off != spec.file_size():
        raise AssertionError(f"tensor table ends at {off}, the file at "
                             f"{spec.file_size()}")
    return out


def _write_matmul(f, spec: TransformerSpec, x) -> None:
    """Write one matmul weight: an f32 array (encoded to the spec's type), or
    a planar ``Q40Weight`` whose codes are written as they are (synthetic
    Q40 trees skip the float pass)."""
    ft = spec.weights_float_type
    if isinstance(x, Q40Weight):
        if ft != FloatType.Q40:
            raise ValueError(f"Q40Weight leaf in a {ft.name} model")
        f.write(pack_q40_bytes(np.ascontiguousarray(x.qs),
                               np.ascontiguousarray(x.d16)))
    elif ft == FloatType.F32:
        f.write(np.ascontiguousarray(x, dtype=np.float32).tobytes())
    elif ft == FloatType.F16:
        f.write(np.ascontiguousarray(x, dtype=np.float32)
                .astype(np.float16).tobytes())
    elif ft == FloatType.Q40:
        qs, d16 = quantize_q40(np.ascontiguousarray(x, dtype=np.float32))
        f.write(pack_q40_bytes(qs, d16))
    else:
        raise ValueError(f"unsupported weights float type {ft}")


def _layer_of(x, layer: int):
    if isinstance(x, Q40Weight):
        return Q40Weight(x.qs[layer], x.d16[layer])
    return x[layer]


def write_model(path: str, spec: TransformerSpec, tensors: dict) -> None:
    """Write a reference-format .bin.

    ``tensors`` keys match load_model's output (stacked layer axis); values
    are f32 arrays, or ``Q40Weight`` pairs for matmul weights of a Q40 spec.
    """
    with open(path, "wb") as f:
        f.write(spec.header())
        f.write(np.ascontiguousarray(
            tensors["tok_embedding"], dtype=np.float32).tobytes())
        for layer in range(spec.n_layers):
            f.write(np.ascontiguousarray(
                tensors["rms_att"][layer], dtype=np.float32).tobytes())
            f.write(np.ascontiguousarray(
                tensors["rms_ffn"][layer], dtype=np.float32).tobytes())
            for name, _ in spec.layer_matmul_shapes():
                _write_matmul(f, spec, _layer_of(tensors[name], layer))
        f.write(np.ascontiguousarray(
            tensors["rms_final"], dtype=np.float32).tobytes())
        f.write(b"\x00" * spec.rope_gap_bytes)
        _write_matmul(f, spec, tensors["wcls"])
    size = os.path.getsize(path)
    if size != spec.file_size():
        raise ValueError(f"wrote {size} bytes to {path}, spec requires "
                         f"{spec.file_size()}")


def densify_params(params: dict) -> dict:
    """Decode/upcast a loaded parameter tree to dense float32 numpy (the
    JAX package's io/loader.densify_params): the training tree, with the
    loaded tree's keys (separate wq ... w3, never a fused wqkv/w13). Q40
    weights decode through the exact codec value map (ops/quants.
    dequantize_q40_torch on the CPU's threads: (code - 8) * f16 scale is
    exact in f32, so any order gives dequantize_q40's bits); F16 upcasts
    exactly."""
    import torch

    from ..ops.quants import dequantize_q40_torch

    out = {}
    for name, val in params.items():
        if isinstance(val, Q40Weight):
            out[name] = dequantize_q40_torch(
                torch.from_numpy(np.ascontiguousarray(val.qs)),
                torch.from_numpy(np.ascontiguousarray(val.d16))).numpy()
        else:
            out[name] = np.asarray(val, dtype=np.float32)
    return out
