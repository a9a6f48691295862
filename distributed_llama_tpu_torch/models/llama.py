"""The Llama-2 forward (7B/13B/70B incl. GQA) in PyTorch, T tokens per call.

Numerics follow the JAX package's models/llama.py (the parity contract):

* RoPE: interleaved (2p, 2p+1) pairs, freq = 10000^-((2p mod hs)/hs), q
  rotated over the full dim and k over kvDim — not the half-split rotation.
* Attention: score = q.k/sqrt(hs); GQA maps query head h to kv head
  h // kv_mul; keys 0..pos of the stacked (L, S, n_kv, hs) cache, f32 or
  (``--kv-cache-dtype bf16``) bf16: the cache write rounds to the cache
  dtype (nearest even, as ``astype``) and every read widens it exactly.
* SwiGLU: silu(w1 x) * (w3 x); rmsnorm with eps=1e-5 added after the mean.
* Under ``buffer_float_type == Q80`` the four matmul inputs of a layer pass
  through the Q80 round trip (ops/linear.fake_quant_q80), at the JAX
  package's ``_maybe_q80`` cut points.

T = 1 is a decode step (attention through K2); T > 1 is a chunk of chunked
prefill at positions pos..pos+T-1 (attention through K4 for every T > 1,
where the JAX package sends T <= 8 to a dense XLA einsum — the same values,
as no Pallas kernel is involved there).

``Llama.forward_batch`` (the JAX package's ``forward_batch`` and
``forward_batch_ragged``) decodes one token for each of B sequences over
the (L, B, S, n_kv, hs) batch cache (``init_cache_batch``), every input a
device tensor: tokens (B,) and positions (B,), one shared clock or
per-row clocks. Each row rotates at its own position, writes its k/v at
(layer, row, pos[b]) and attends through K5, which reads the positions on
the device; the matmuls take the T = B path. Nothing in it reads a device
value on the host, so runtime/decode.py captures it in a CUDA graph. At
B = 1 over a single-sequence cache viewed as (L, 1, S, n_kv, hs) it is the
T = 1 step with device inputs: K1 and K5, which at B = 1 computes K2's
sums in K2's order, so its logits equal ``forward``'s bit for bit.

The precision is an explicit ``Route`` per call, where the JAX package
traces a second program under a context variable (ops/linear.py
``matmul_precision("bf16")``): ``FAST`` is the ``--fast-prefill`` route for
T > 8 chunks, with the bf16 Q40 GEMM (K3b), bf16 dense products and bf16
prefill attention (K4b); ``FAST_PLAIN`` is its plain twin. ``with_body``
gives a route the small-T body the engine read from
``DLLAMA_MULTI_T_BODY`` (K1d for 'dequant'). One module and one parameter
tree serve every route.

Departures, none of which changes a value: the KV write is in place at
(layer, pos..pos+T-1) instead of a functional update; the RoPE frequencies
are computed once per model and the angles once per call, shared by every
layer; the layer loop is a Python loop over zero-copy per-layer views of
the stacked weights; a prefill call may skip the final norm and ``wcls``,
whose logits the JAX prefill discards.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..io.loader import Q40Weight
from ..ops.attention import (attention_core, decode_attention,
                             decode_attention_batch,
                             decode_attention_batch_plain,
                             decode_attention_plain, prefill_attention,
                             prefill_attention_bf16_plain,
                             prefill_attention_plain)
from ..ops.linear import (dense_matmul, dense_matmul_bf16, fake_quant_q80,
                          fuse_q40_layer_matmuls, matmul, q40_to_device,
                          rmsnorm, silu)
from ..ops.q40 import q40_matmul, q40_matmul_plain
from ..ops.quants import FloatType
from .spec import TransformerSpec

__all__ = ["KVCache", "init_cache", "init_cache_batch", "attention_core",
           "Route", "KERNELS", "PLAIN", "FAST", "FAST_PLAIN", "with_body",
           "LOGIT_RTOL", "FAST_RTOL", "Llama", "params_to_device",
           "params_from_reference"]


class KVCache(NamedTuple):
    k: torch.Tensor  # (n_layers, seq_len, n_kv_heads, head_size) f32 / bf16
    v: torch.Tensor


def init_cache(spec: TransformerSpec, device,
               dtype: torch.dtype = torch.float32) -> KVCache:
    shape = (spec.n_layers, spec.seq_len, spec.n_kv_heads, spec.head_size)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_cache_batch(spec: TransformerSpec, batch: int, device,
                     dtype: torch.dtype = torch.float32) -> KVCache:
    """The batch cache (L, B, S, n_kv, hs): each (layer, row) has the
    single-sequence (S, n_kv, hs) layout, and forward_batch reads it as the
    rank-4 (L*B, S, n_kv, hs) view the JAX package carries."""
    shape = (spec.n_layers, batch, spec.seq_len, spec.n_kv_heads,
             spec.head_size)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class Route(NamedTuple):
    """Which Q40 matmul, dense matmul, decode attention (T = 1), prefill
    attention (T > 1) and batched decode attention (forward_batch) the
    forward calls."""

    q40: Callable
    dense: Callable
    attention: Callable
    prefill: Callable
    batch: Callable


# the kernel wrappers (the plain versions on CPU tensors) — the main path
KERNELS = Route(q40_matmul, dense_matmul, decode_attention,
                prefill_attention, decode_attention_batch)
# the plain versions on any device — to hold the kernels against on the card
PLAIN = Route(q40_matmul_plain, dense_matmul, decode_attention_plain,
              prefill_attention_plain, decode_attention_batch_plain)
# --fast-prefill's T > 8 chunks: bf16 products, f32 accumulation (K3b, K4b)
FAST = Route(partial(q40_matmul, bf16=True), dense_matmul_bf16,
             decode_attention, partial(prefill_attention, bf16=True),
             decode_attention_batch)
FAST_PLAIN = Route(partial(q40_matmul_plain, bf16=True), dense_matmul_bf16,
                   decode_attention_plain, prefill_attention_bf16_plain,
                   decode_attention_batch_plain)


def with_body(route: Route, multi_body: str) -> Route:
    """``route`` with its Q40 matmul taking ``multi_body`` ('vpu' or
    'dequant', ops/q40.multi_t_body) for 2 <= T <= 8."""
    if multi_body == "vpu":
        return route
    return route._replace(q40=partial(route.q40, multi_body=multi_body))


# |kernel logits - plain logits| <= LOGIT_RTOL * max|plain logits|: the two
# routes sum in different orders through every layer (f32 throughout)
LOGIT_RTOL = 1e-3
# the same for FAST against FAST_PLAIN (logits after a fast prefill, and the
# prefilled cache rows): the sums' order differs as above, and wherever it
# moves a value across a bf16 rounding boundary the next product sees it
# one bf16 step (2^-8 relative) apart
FAST_RTOL = 1e-2


def rope_freq(n: int, head_size: int, device) -> torch.Tensor:
    """Per-pair frequencies (n/2,) f32: pair p uses head_dim = (2p) mod hs."""
    i = torch.arange(0, n, 2, dtype=torch.float32, device=device)
    head_dim = torch.remainder(i, head_size)
    base = torch.tensor(10000.0, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, head_dim / head_size)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
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
    rope_rotate), computed once per call and shared by every layer."""
    val = positions.to(torch.float32)[:, None] * freq[None, :]
    return torch.cos(val), torch.sin(val)


def rope_tables(freq: torch.Tensor, pos: int,
                t_len: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """rope_rows at positions pos..pos+T-1, made on the frequencies'
    device (no host-to-device copy)."""
    return rope_rows(freq, torch.arange(pos, pos + t_len,
                                        device=freq.device))


def _mm(w, x: torch.Tensor, route: Route) -> torch.Tensor:
    return matmul(w, x, route.q40, route.dense)


def _maybe_q80(spec: TransformerSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.buffer_float_type == FloatType.Q80:
        return fake_quant_q80(x)
    return x


def _qkv_proj(spec: TransformerSpec, lw: dict[str, Any], x: torch.Tensor,
              rope: tuple[torch.Tensor, torch.Tensor], route: Route):
    """norm -> (q80) -> q/k/v matmuls (fused wqkv when present) -> RoPE on
    q and k. Returns q (T, dim), k (T, kv_dim), v (T, kv_dim)."""
    xb = _maybe_q80(spec, rmsnorm(x, lw["rms_att"]))
    qk_dim = spec.dim + spec.kv_dim
    if "wqkv" in lw:
        qkv = _mm(lw["wqkv"], xb, route)
        qk, v = qkv[:, :qk_dim], qkv[:, qk_dim:]
    else:
        qk = torch.cat([_mm(lw["wq"], xb, route),
                        _mm(lw["wk"], xb, route)], dim=-1)
        v = _mm(lw["wv"], xb, route)
    # q and k rotate together: head_dim = (2p) mod hs runs on across the
    # q/k boundary because dim is a multiple of hs
    qk = _rotate(qk, *rope)
    return qk[:, :spec.dim], qk[:, spec.dim:], v


def _post_attention(spec: TransformerSpec, lw: dict[str, Any],
                    x: torch.Tensor, ao: torch.Tensor,
                    route: Route) -> torch.Tensor:
    """wo + residual, then the SwiGLU ffn sub-block + residual (each matmul
    input through the q80 cut point)."""
    x = x + _mm(lw["wo"], _maybe_q80(spec, ao), route)
    xb = _maybe_q80(spec, rmsnorm(x, lw["rms_ffn"]))
    if "w13" in lw:
        h13 = _mm(lw["w13"], xb, route)
        hid = h13.shape[-1] // 2
        hb = silu(h13[:, :hid]) * h13[:, hid:]
    else:
        hb = silu(_mm(lw["w1"], xb, route)) * _mm(lw["w3"], xb, route)
    return x + _mm(lw["w2"], _maybe_q80(spec, hb), route)


def _layer(spec: TransformerSpec, x: torch.Tensor, lw: dict[str, Any],
           cache: KVCache, idx: int, pos: int,
           rope: tuple[torch.Tensor, torch.Tensor],
           route: Route = KERNELS) -> torch.Tensor:
    """One transformer layer over T tokens: writes their k/v into the
    stacked cache in place at (idx, pos..pos+T-1), attends causally over
    0..pos+T-1, returns the new residual (T, dim)."""
    t_len = x.shape[0]
    hs, n_kv = spec.head_size, spec.n_kv_heads
    q, k, v = _qkv_proj(spec, lw, x, rope, route)
    cache.k[idx, pos:pos + t_len].copy_(k.reshape(t_len, n_kv, hs))
    cache.v[idx, pos:pos + t_len].copy_(v.reshape(t_len, n_kv, hs))
    if t_len == 1:
        ao = route.attention(q.reshape(spec.n_heads, hs), cache.k, cache.v,
                             idx, pos, spec.kv_mul)
    else:  # q is a strided slice of the rotated q|k: the kernel wants rows
        ao = route.prefill(q.reshape(t_len, spec.n_heads, hs).contiguous(),
                           cache.k, cache.v, idx, pos, spec.kv_mul)
    return _post_attention(spec, lw, x, ao, route)


LAYER_KEYS = ("rms_att", "rms_ffn", "wq", "wk", "wv", "wo", "w1", "w2", "w3",
              "wqkv", "w13")


def _layer_view(params: dict[str, Any], i: int) -> dict[str, Any]:
    """Layer i of every stacked weight, as zero-copy views."""
    lw = {}
    for k in LAYER_KEYS:
        if k in params:
            w = params[k]
            lw[k] = (Q40Weight(w.qs[i], w.d16[i]) if isinstance(w, Q40Weight)
                     else w[i])
    return lw


class Llama(nn.Module):
    """The forward over device-resident weights, T >= 1 tokens per call.

    ``params`` is the tree params_to_device built; the module keeps it as it
    is (Q40 pairs are not tensors, so nothing is registered as a buffer) and
    precomputes the per-layer views and the RoPE frequencies once.
    ``route`` picks the kernels (default) or their plain versions; a call
    may name another route (``FAST`` for a --fast-prefill chunk).
    """

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 route: Route = KERNELS):
        super().__init__()
        self.spec = spec
        self.params = params
        self.route = route
        self.layers = [_layer_view(params, i) for i in range(spec.n_layers)]
        self._rows: dict = {}
        device = params["tok_embedding"].device
        self.register_buffer("freq", rope_freq(spec.dim + spec.kv_dim,
                                               spec.head_size, device))

    def forward(self, cache: KVCache, tokens: int | Sequence[int], pos: int,
                logits: bool = True,
                route: Route | None = None) -> torch.Tensor | None:
        """T tokens (one int, or a sequence) at positions pos..pos+T-1:
        writes their k/v into ``cache`` and returns logits (T, vocab) f32,
        or None with ``logits=False`` (prefill: the final norm and wcls are
        skipped, as the JAX prefill discards those logits). ``route``
        overrides the module's route for this call."""
        spec, p = self.spec, self.params
        route = self.route if route is None else route
        tokens = ([int(tokens)] if isinstance(tokens, (int, np.integer))
                  else [int(t) for t in tokens])
        t_len = len(tokens)
        if t_len < 1 or pos < 0 or pos + t_len > spec.seq_len:
            raise ValueError(f"positions {pos}..{pos + t_len - 1} outside "
                             f"the cache (seq_len {spec.seq_len})")
        emb = p["tok_embedding"]
        x = (emb[tokens[0]].reshape(1, spec.dim) if t_len == 1
             else emb[torch.tensor(tokens, device=emb.device)])
        x = x.to(torch.float32)
        rope = rope_tables(self.freq, pos, t_len)
        for idx, lw in enumerate(self.layers):
            x = _layer(spec, x, lw, cache, idx, pos, rope, route)
        if not logits:
            return None
        x = rmsnorm(x, p["rms_final"])
        return _mm(p["wcls"], x, route)

    def forward_batch(self, cache: KVCache, tokens: torch.Tensor,
                      pos: int | torch.Tensor,
                      route: Route | None = None) -> torch.Tensor:
        """One token for each of B sequences: tokens (B,) on the device, pos
        an int (one shared clock) or a (B,) int32 tensor (per-row clocks);
        cache (L, B, S, n_kv, hs) from init_cache_batch. Writes row b's k/v
        at (layer, b, pos[b]) and returns logits (B, vocab) f32. Reads no
        device value on the host (so a CUDA graph can capture it); the
        caller keeps every pos[b] inside the cache."""
        spec, p = self.spec, self.params
        route = self.route if route is None else route
        batch = tokens.shape[0]
        device = tokens.device
        if isinstance(pos, (int, np.integer)):
            if not 0 <= pos < spec.seq_len:
                raise ValueError(f"position {pos} outside the cache "
                                 f"(seq_len {spec.seq_len})")
            pos = torch.full((batch,), int(pos), dtype=torch.int32,
                             device=device)
        if pos.dtype != torch.int32 or tuple(pos.shape) != (batch,):
            raise ValueError(f"forward_batch: pos must be an int or an "
                             f"int32 ({batch},) tensor, got {pos.dtype} "
                             f"{tuple(pos.shape)}")
        n_layers, seq_len = spec.n_layers, spec.seq_len
        hs, n_kv = spec.head_size, spec.n_kv_heads
        if tuple(cache.k.shape) != (n_layers, batch, seq_len, n_kv, hs):
            raise ValueError(f"forward_batch: cache {tuple(cache.k.shape)} "
                             f"does not hold {batch} rows of this model")
        k4 = cache.k.view(n_layers * batch, seq_len, n_kv, hs)
        v4 = cache.v.view(n_layers * batch, seq_len, n_kv, hs)
        rows = self._batch_rows(batch, device)
        cols = pos.long()
        x = p["tok_embedding"][tokens].to(torch.float32)
        rope = rope_rows(self.freq, pos)
        for idx, lw in enumerate(self.layers):
            q, k, v = _qkv_proj(spec, lw, x, rope, route)
            k4.index_put_((rows[idx], cols),
                          k.reshape(batch, n_kv, hs).to(k4.dtype))
            v4.index_put_((rows[idx], cols),
                          v.reshape(batch, n_kv, hs).to(v4.dtype))
            ao = route.batch(q.reshape(batch, spec.n_heads, hs).contiguous(),
                             k4, v4, idx, pos, spec.kv_mul)
            x = _post_attention(spec, lw, x, ao, route)
        x = rmsnorm(x, p["rms_final"])
        return _mm(p["wcls"], x, route)

    def forward_batch_ragged(self, cache: KVCache, tokens: torch.Tensor,
                             pos: torch.Tensor,
                             route: Route | None = None) -> torch.Tensor:
        """forward_batch at per-row clocks pos (B,): each row attends only
        its own 0..pos[b], so whatever lies past a row's clock is
        invisible."""
        return self.forward_batch(cache, tokens, pos, route)

    def _batch_rows(self, batch: int, device) -> torch.Tensor:
        """(L, B) int64 rows layer*B + b of the (L*B, S, n_kv, hs) view,
        made once per batch size and device."""
        key = (batch, str(device))
        if key not in self._rows:
            layers = torch.arange(self.spec.n_layers, device=device)
            self._rows[key] = (layers[:, None] * batch
                               + torch.arange(batch, device=device)[None, :])
        return self._rows[key]


def params_to_device(params: dict[str, Any], device) -> dict[str, Any]:
    """Move a host numpy param tree onto ``device``: Q40 q/k/v and w1/w3 are
    fused at load (ops/linear.fuse_q40_layer_matmuls), Q40 weights take the
    port's device layout (ops/linear.q40_to_device), dense leaves keep their
    f32/f16 dtype."""
    device = torch.device(device)
    out = {}
    for k, v in fuse_q40_layer_matmuls(params).items():
        if isinstance(v, Q40Weight):
            out[k] = q40_to_device(v, device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def params_from_reference(tree: dict[str, Any], device) -> dict[str, Any]:
    """The JAX package's numpy parameter tree -> this port's device tree.

    Q40 leaves are recognised by their ``.qs`` / ``.d16`` attributes (the
    reference's Q40Weight), so no import of the reference package is
    needed; every leaf is read through numpy."""
    host = {}
    for k, v in tree.items():
        if hasattr(v, "qs") and hasattr(v, "d16"):
            host[k] = Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
        else:
            host[k] = np.asarray(v)
    return params_to_device(host, device)
