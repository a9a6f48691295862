"""Generation loop + engine (the reference's generate()).

``Engine`` owns the device params, the KV cache (f32, or bf16 with
``cache_dtype``) and the forward behind the reference's ``infer(token, pos)
-> logits`` shape, plus ``prefill`` (the prompt in T=chunk forward passes;
with ``fast_prefill``, its T > 8 windows take the bf16 route). ``generate``
reproduces the reference's observable behaviour: prompt tokens forced one
at a time (or prefilled in chunks with ``prefill_chunk > 1``, the same
token stream), sampling after the prompt, stop on BOS, the per-token 🔶
stats line and the final averages.

Stats: I = device step time (the forward up to the host copy of the
logits, which waits for the device), T = host time (sampling + loop). A
single device exchanges nothing, so the S/R (sent/received) fields of the
🔶 line are 0.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from ..io.tokenizer import BOS, Tokenizer
from ..models.llama import FAST, Llama, init_cache, params_to_device
from ..models.spec import TransformerSpec
from ..ops import attention, q40
from ..ops._build import build
from .sampling import Sampler


class Engine:
    """Owns params + cache + the forward on one device; exposes
    infer(token, pos) and prefill(tokens, pos0, chunk).

    ``cache_dtype`` is torch.float32 (the parity default) or torch.bfloat16
    (``--kv-cache-dtype bf16``: half the cache memory and attention bytes).
    ``fast_prefill`` sends prefill windows of more than 8 tokens through
    the bf16 route (models/llama.FAST); the T = 1 tail and every decode
    step keep the parity route, as the JAX Engine keeps its parity program
    for them."""

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 device="cuda", cache_dtype: torch.dtype = torch.float32,
                 fast_prefill: bool = False):
        self.spec = spec
        self.device = torch.device(device)
        self.fast_prefill = fast_prefill
        if self.device.type == "cuda":
            # build (or find) the kernels now, not inside the first token
            build([*q40.KERNELS, *attention.KERNELS])
        self.params = params_to_device(params, self.device)
        self.model = Llama(spec, self.params)
        self.cache = init_cache(spec, self.device, cache_dtype)

    @torch.inference_mode()
    def infer(self, token: int, pos: int) -> np.ndarray:
        """One decode step; returns host f32 logits (vocab,)."""
        logits = self.model(self.cache, token, pos)
        return logits[0].cpu().numpy()

    @torch.inference_mode()
    def prefill(self, tokens: list[int], pos0: int = 0,
                chunk: int = 128) -> None:
        """Fill the KV cache for ``tokens`` at positions pos0.. in T=chunk
        forward passes (run_chunked_prefill's schedule); their logits are
        never computed. Raises before any cache write when the tokens do
        not fit in the cache.

        A zero-padded last window writes junk k/v at positions past the
        prompt. Nothing reads it: the causal mask hides it from the real rows
        of its own chunk, and decode writes slot p before it attends 0..p,
        so every padded slot is overwritten first. The JAX package runs two
        or more full windows as one device loop; here they are the same
        forward calls in a Python loop, with the same values.
        """
        seq_len = self.spec.seq_len
        if pos0 + len(tokens) > seq_len:
            raise ValueError(f"prefill overflow: pos0={pos0} + {len(tokens)} "
                             f"tokens > seq_len={seq_len}")

        def fwd(part: list[int], start: int) -> None:
            # the bf16 route takes the T > 8 windows only (the JAX Engine's
            # rule); the T = 1 tail shares the decode route
            if self.fast_prefill and len(part) > q40.MULTI_T_MAX:
                self.model(self.cache, part, start, logits=False, route=FAST)
            else:
                self.model(self.cache, part, start, logits=False)

        run_chunked_prefill(fwd, tokens, pos0, chunk, seq_len)

    def reset(self) -> None:
        self.cache.k.zero_()
        self.cache.v.zero_()


def run_chunked_prefill(fwd: Callable[[list[int], int], None],
                        tokens: list[int], pos0: int, chunk: int,
                        seq_len: int) -> None:
    """The fixed-chunk prefill schedule: full T=chunk windows, a zero-padded
    partial window while it stays inside seq_len, and a per-token tail when
    the padded window would cross seq_len (it must never be clamped back
    over real positions). ``fwd(part, start)`` runs one forward pass."""
    chunk = min(chunk, seq_len)
    for lo in range(0, len(tokens), chunk):
        part = tokens[lo:lo + chunk]
        start = pos0 + lo
        if len(part) == chunk:
            fwd(part, start)
        elif start + chunk <= seq_len:
            fwd(part + [0] * (chunk - len(part)), start)
        else:  # padded window would cross seq_len: per-token tail
            for i, t in enumerate(part):
                fwd([t], start + i)


@dataclasses.dataclass
class GenStats:
    tokens: int = 0
    total_ms: float = 0.0
    infer_ms: float = 0.0
    host_ms: float = 0.0
    token_ms: list = dataclasses.field(default_factory=list)
    # ^ per-token wall ms — feeds the final-line latency summary

    @property
    def avg(self) -> tuple[float, float, float]:
        n = max(self.tokens, 1)
        return self.total_ms / n, self.infer_ms / n, self.host_ms / n


def summarize_values(values) -> dict:
    """Exact {'count','mean','p50','p95','p99'} of a list of samples
    (linear interpolation between ranks, numpy's 'linear' method)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}

    def pct(q: float) -> float:
        idx = q * (len(vals) - 1)
        lo = int(math.floor(idx))
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (idx - lo)

    return {"count": len(vals), "mean": sum(vals) / len(vals),
            "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}


def _prefill_prefix(engine: Engine, prompt_tokens: list[int], steps: int,
                    chunk: int, out_tokens: list[int]) -> int | None:
    """Prefill the cache for the prompt prefix in T=chunk passes and echo
    the prefilled prompt tokens into ``out_tokens`` (the loop appends forced
    prompt tokens to the output, so the prefilled ones must appear too).

    Returns the decode loop's start position (len(prompt) - 1), or None
    when prefill does not apply: chunk <= 1, fewer than 2 tokens to
    prefill, a prompt that does not fit in ``steps`` (the per-token path
    keeps the forced-token output exactly), or a BOS inside the prompt
    (only the per-token loop reproduces the stop it causes).
    """
    n_pre = len(prompt_tokens) - 1
    if chunk <= 1 or n_pre < 2 or n_pre >= steps:
        return None
    if BOS in prompt_tokens[1:]:
        return None
    engine.prefill(prompt_tokens[:n_pre], 0, chunk)
    out_tokens.extend(prompt_tokens[1:n_pre + 1])
    return n_pre


def generate(engine: Engine, tokenizer: Tokenizer, sampler: Sampler,
             prompt: str, steps: int, quiet: bool = False,
             prefill_chunk: int = 0) -> tuple[list[int], GenStats]:
    """The reference generation loop.

    Encodes the prompt with BOS (no EOS), forces prompt tokens, samples after,
    stops early on BOS, prints the per-token stats line and final averages.
    ``prefill_chunk > 1`` fills the cache for the prompt prefix in chunked
    T>1 passes (Engine.prefill) instead of forcing it through the T=1 path:
    the same token stream, minus the prompt positions' stats lines.
    """
    steps = min(steps, engine.spec.seq_len)
    prompt_tokens = tokenizer.encode(prompt or "", bos=True, eos=False)
    if not prompt_tokens:
        raise ValueError("something is wrong, expected at least 1 prompt token")
    token = prompt_tokens[0]
    out_tokens: list[int] = []
    stats = GenStats()
    pos = 0
    pre = _prefill_prefix(engine, prompt_tokens, steps, prefill_chunk,
                          out_tokens)
    if pre is not None:
        pos, token = pre, prompt_tokens[pre]
    while pos < steps:
        t0 = time.perf_counter()
        logits = engine.infer(token, pos)
        t1 = time.perf_counter()

        if pos + 1 < len(prompt_tokens):
            next_token = prompt_tokens[pos + 1]
        else:
            next_token = sampler.sample(logits)
        t2 = time.perf_counter()

        gen_ms = (t2 - t0) * 1000
        stats.tokens += 1
        stats.total_ms += gen_ms
        stats.infer_ms += (t1 - t0) * 1000
        stats.host_ms += (t2 - t1) * 1000
        stats.token_ms.append(gen_ms)

        pos += 1
        if next_token == BOS:
            break  # the reference stops on BOS before decoding it
        out_tokens.append(next_token)
        piece = tokenizer.decode_piece(token, next_token)
        text = piece.decode("utf-8", errors="replace")
        if not quiet:
            print(f"🔶 G {gen_ms:7.2f} ms I {(t1 - t0) * 1000:7.2f} ms "
                  f"T {(t2 - t1) * 1000:7.2f} ms S {0:7.0f} kB "
                  f"R {0:7.0f} kB {text!r}")
        token = next_token

    if stats.tokens and not quiet:
        lat = summarize_values(stats.token_ms)
        g, i, t = stats.avg
        print(f"Generated tokens:    {stats.tokens}")
        print(f"Avg generation time: {g:.2f} ms")
        print(f"Avg inference time:  {i:.2f} ms")
        print(f"Avg transfer time:   {t:.2f} ms")
        print(f"Latency ms/token:    p50 {lat['p50']:.2f}  "
              f"p95 {lat['p95']:.2f}  p99 {lat['p99']:.2f}")
    return out_tokens, stats
