"""Seeded synthetic parameter trees for tests and on-card runs.

Mirrors the shape/layout contract of io.loader.load_model: per-layer matmul
weights stacked along a leading layer axis, Q40 weights as codec-layout
``Q40Weight`` pairs.
"""

from __future__ import annotations

import numpy as np

from ..io.loader import Q40Weight
from ..ops.quants import FloatType, quantize_q40
from .spec import TransformerSpec


def _build_tree(spec: TransformerSpec, t, mm) -> dict:
    """Assemble the param tree from a dense builder ``t`` and a matmul-weight
    builder ``mm`` — the one place that knows the tree's key set."""
    p = {"tok_embedding": t(spec.vocab_size, spec.dim),
         "rms_final": 1 + t(spec.dim),
         "rms_att": 1 + t(spec.n_layers, spec.dim),
         "rms_ffn": 1 + t(spec.n_layers, spec.dim),
         "wcls": mm(spec.vocab_size, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        p[name] = mm(spec.n_layers, *shape)
    return p


def synth_q40_fast(spec: TransformerSpec, seed: int = 0) -> dict:
    """Random Q40 params built directly as packed codes — for full-size runs.

    Skips the float-generate + quantize pass (minutes for 7B in numpy):
    random nibble codes + small positive f16 deltas give the exact memory
    layout and dataflow of real weights at little synthesis cost. The
    values are random, so a model built from them produces arbitrary (but
    deterministic) tokens.
    """
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def mm(*shape):
        *lead, d, n = shape
        qs = rng.integers(0, 256, (*lead, d, n // 32, 16), dtype=np.uint8)
        d16 = (rng.random((*lead, d, n // 32), dtype=np.float32)
               * 0.01 + 1e-4).astype(np.float16)
        return Q40Weight(qs, d16)

    return _build_tree(spec, t, mm)


def synth_params(spec: TransformerSpec, q40: bool, seed: int = 0,
                 scale: float = 0.05) -> dict:
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def mm(*shape):
        x = t(*shape)
        if not q40:
            return x
        qs, d16 = quantize_q40(x)
        return Q40Weight(qs, d16)

    return _build_tree(spec, t, mm)


def llama2_7b_spec(**overrides) -> TransformerSpec:
    """The Llama-2-7B shape (converter header values) at Q40."""
    kw = dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
              n_kv_heads=32, vocab_size=32000, seq_len=2048,
              weights_float_type=FloatType.Q40)
    kw.update(overrides)
    return TransformerSpec(**kw)
