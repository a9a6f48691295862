"""Generation loops + engine (the reference's generate(), and the JAX
package's generate_fast and generate_batch).

``Engine`` owns the device params, the KV cache (f32, or bf16 with
``cache_dtype``) and the forward behind the reference's ``infer(token, pos)
-> logits`` shape, plus ``prefill`` (the prompt in T=chunk forward passes;
with ``fast_prefill``, its T > 8 windows take the bf16 route) and
``decode_loop`` (the on-device loop over its cache, runtime/decode.py).
``generate`` reproduces the reference's observable behaviour: prompt tokens
forced one at a time (or prefilled in chunks with ``prefill_chunk > 1``,
the same token stream), sampling after the prompt, stop on BOS, the
per-token 🔶 stats line and the final averages. ``generate_fast``
(``--fast``) produces the same stream from the on-device loop, one CUDA
graph replay per step on the card; ``generate_batch`` (``--prompts-file``)
decodes B prompts in lockstep through the same loop. ``generate`` and
``generate_fast`` also continue a run saved by runtime/checkpoint.py
(``resume=(pos, token)``, ``resume_prompt``), leaving the next step's
inputs in GenStats.final_pos / final_token / prompt_rest.

The engines read ``DLLAMA_MULTI_T_BODY`` once (ops/q40.multi_t_body) and
route every 2 <= T <= 8 product through the body it names (K1d for
'dequant'), as the JAX package's T <= 8 dispatch does. ``Engine`` also
reads ``DLLAMA_LAYER_FUSION`` once (ops/layer.fusion_mode): under
'headtail' or 'on' every T = 1 step it runs, host loop, T = 1 prefill tail
and --fast chain alike, goes through the fused decode layer
(Llama.forward_fused), as the JAX package's forward does at T = 1.

With ``group`` (parallel/mesh.TPGroup, size > 1) the engines run one
tensor-parallel rank (parallel/tp.TPLlama over the rank's bands and kv
heads, the JAX package's Engine(mesh=...) and generate_batch(mesh=...)):
every rank runs the same loop, gathers the logits and samples the same
coins, so every rank's stream is the same and nothing but the forward's
collectives crosses. A CUDA graph over the group's collectives is not
yet ported (gloo cannot be captured; a capture over NCCL hung in a 4-card
run): the engines raise unless the caller passes graph=False. The fused
decode layer is single-device only (the JAX package's sharded forward
never takes it).

Stats: I = device step time (the forward up to the host copy of the
logits, which waits for the device), T = host time (sampling + loop).
S/R (sent/received) in the 🔶 line are the per-token collective bytes of
parallel/comm_stats (0 on one device); a tensor-parallel run also prints
the collectives it counted per token beside that budget.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from ..io.tokenizer import BOS, Tokenizer
from ..models.llama import (FAST, KERNELS, KVCache, Llama, init_cache,
                            init_cache_batch, params_to_device, with_body)
from ..models.spec import TransformerSpec
from ..ops import attention, layer, q40
from ..ops._build import build
from ..parallel import collectives
from ..parallel.comm_stats import (CommStats, ici_all_gather_bytes,
                                   tp_collective_budget)
from ..parallel.mesh import TPGroup, single
from ..utils.rng import Xorshift64
from .decode import DecodeLoop
from .sampling import Sampler


def _no_capture(group: TPGroup, device: torch.device,
                graph: bool | None) -> None:
    """Raise where a CUDA graph would have to capture a tp group's
    collectives: gloo's run on host threads, and a capture over NCCL hung
    in a 4-card run, so the caller asks for graph=False (nothing drops to
    eager on its own)."""
    if device.type == "cuda" and graph is not False and group.size > 1:
        raise ValueError(
            f"not yet ported: a CUDA graph over the tp group's collectives "
            f"({group.backend}, tp={group.size}); pass graph=False")


def _tp_model(spec: TransformerSpec, params: dict[str, Any],
              group: TPGroup, scheme: str | None, route):
    from ..parallel.tp import make_sharded_forward

    return make_sharded_forward(spec, params, group, scheme, route)


class Engine:
    """Owns params + cache + the forward on one device; exposes
    infer(token, pos) and prefill(tokens, pos0, chunk).

    ``cache_dtype`` is torch.float32 (the parity default) or torch.bfloat16
    (``--kv-cache-dtype bf16``: half the cache memory and attention bytes).
    ``fast_prefill`` sends prefill windows of more than 8 tokens through
    the bf16 route (models/llama.FAST); the T = 1 tail and every decode
    step keep the parity route, as the JAX Engine keeps its parity program
    for them. Every 2 <= T <= 8 product takes the small-T body that
    ``DLLAMA_MULTI_T_BODY`` names, read here once, and every T = 1 step
    the fused layer that ``DLLAMA_LAYER_FUSION`` names (``self.model.fusion``
    says which applies: None where the mode is off or ops/layer.supports
    fails)."""

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 device="cuda", cache_dtype: torch.dtype = torch.float32,
                 fast_prefill: bool = False, group: TPGroup | None = None,
                 scheme: str | None = None):
        self.spec = spec
        self.group = group or single(device)
        self.device = self.group.device if group else torch.device(device)
        self.fast_prefill = fast_prefill
        body = q40.multi_t_body()
        fusion = layer.fusion_mode()
        if self.device.type == "cuda":
            # build (or find) the kernels now, not inside the first token
            build([*q40.KERNELS, *q40.HELPERS, *attention.KERNELS,
                   *attention.HELPERS, *layer.KERNELS])
        if self.group.size > 1:
            # ``params`` is the rank's host tree of bands
            self.model = _tp_model(spec, params, self.group, scheme,
                                   with_body(KERNELS, body))
            self.params = self.model.params
        else:
            self.params = params_to_device(params, self.device)
            self.model = Llama(spec, self.params, with_body(KERNELS, body),
                               fusion)
        self.tp_scheme = getattr(self.model, "scheme", None)
        self.cache = init_cache(self.model.spec, self.device, cache_dtype)
        self._loops: dict = {}

    def comm_stats(self) -> CommStats:
        """The per-token collective bytes of this engine's scheme (0 on one
        device)."""
        return ici_all_gather_bytes(self.spec, self.group.size,
                                    self.tp_scheme)

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

    def decode_loop(self, temperature: float, topp: float,
                    graph: bool | None = None) -> DecodeLoop:
        """The on-device loop over this engine's cache (B = 1, seq_len-long
        buffers, so every --steps value shares one captured step), made
        once per sampling config. The step is Llama.forward_batch over the
        cache viewed as (L, 1, S, n_kv, hs): K1 and K5; under a fused mode,
        Llama.forward_fused over the cache itself: K10, or K8, K5 and K9,
        with K1 for wcls."""
        _no_capture(self.group, self.device, graph)
        key = (float(temperature), float(topp), graph)
        if key not in self._loops:
            model = self.model
            if model.fusion is not None:
                def step(tokens, pos):
                    return model.forward_fused(self.cache, tokens, pos,
                                               model.fusion)
            else:
                cache = KVCache(self.cache.k.unsqueeze(1),
                                self.cache.v.unsqueeze(1))

                def step(tokens, pos):
                    return model.forward_batch(cache, tokens, pos)

            self._loops[key] = DecodeLoop(step, 1, self.spec.seq_len,
                                          temperature, topp, self.device,
                                          graph)
        return self._loops[key]

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
    final_pos: int = 0    # next step's pos — checkpoint/resume anchor
    final_token: int = 0  # next step's input token
    token_ms: list = dataclasses.field(default_factory=list)
    # ^ per-token wall ms — feeds the final-line latency summary
    prompt_rest: list = dataclasses.field(default_factory=list)
    # ^ prompt tokens NOT yet consumed when the run ended (the forced tail
    #   of a resumed continuation; empty once the prompt is exhausted)

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
                    chunk: int, out_tokens: list[int],
                    emit: Callable[[str], None] | None = None,
                    tokenizer: Tokenizer | None = None) -> int | None:
    """Prefill the cache for the prompt prefix in T=chunk passes and echo
    the prefilled prompt tokens into ``out_tokens`` (the loop appends forced
    prompt tokens to the output, so the prefilled ones must appear too).

    ``emit`` receives each prefilled token's piece (generate_fast prints
    them, as the JAX package does). Returns the decode loop's start
    position (len(prompt) - 1), or None when prefill does not apply: chunk <= 1, fewer than 2 tokens to
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
    prev = prompt_tokens[0]
    for t in prompt_tokens[1:n_pre + 1]:
        out_tokens.append(t)
        if emit is not None:  # generate_fast echoes the prefilled pieces
            emit(tokenizer.decode_piece(prev, t).decode("utf-8",
                                                        errors="replace"))
        prev = t
    return n_pre


def generate(engine: Engine, tokenizer: Tokenizer, sampler: Sampler,
             prompt: str, steps: int, quiet: bool = False,
             prefill_chunk: int = 0, resume: tuple[int, int] | None = None,
             resume_prompt: list[int] | None = None
             ) -> tuple[list[int], GenStats]:
    """The reference generation loop.

    Encodes the prompt with BOS (no EOS), forces prompt tokens, samples after,
    stops early on BOS, prints the per-token stats line and final averages.
    ``prefill_chunk > 1`` fills the cache for the prompt prefix in chunked
    T>1 passes (Engine.prefill) instead of forcing it through the T=1 path:
    the same token stream, minus the prompt positions' stats lines.

    ``resume=(pos, token)`` continues an interrupted generation instead of
    starting one: the engine's cache and the sampler's RNG must have been
    restored first (runtime/checkpoint.py), the prompt argument is ignored
    (``resume_prompt`` carries any prompt tail the interrupted run had not
    yet consumed — GenStats.prompt_rest), and up to ``steps`` more positions
    run.
    """
    out_tokens: list[int] = []
    if resume is not None:
        pos, token = resume
        # re-anchor the unconsumed prompt tail at absolute positions: the
        # loop forces prompt_tokens[pos + 1], so pad the consumed prefix
        prompt_tokens = [-1] * (pos + 1) + list(resume_prompt or [])
        steps = min(pos + steps, engine.spec.seq_len)
    else:
        steps = min(steps, engine.spec.seq_len)
        prompt_tokens = tokenizer.encode(prompt or "", bos=True, eos=False)
        if not prompt_tokens:
            raise ValueError(
                "something is wrong, expected at least 1 prompt token")
        pos, token = 0, prompt_tokens[0]
        pre = _prefill_prefix(engine, prompt_tokens, steps, prefill_chunk,
                              out_tokens)
        if pre is not None:
            pos, token = pre, prompt_tokens[pre]
    comm = engine.comm_stats()
    census = collectives.CENSUS.kind_counts()
    stats = GenStats(final_pos=pos, final_token=token)
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
        stats.final_pos, stats.final_token = pos, int(next_token)
        stats.prompt_rest = [t for t in prompt_tokens[pos + 1:] if t >= 0]
        if next_token == BOS:
            break  # the reference stops on BOS before decoding it
        out_tokens.append(next_token)
        piece = tokenizer.decode_piece(token, next_token)
        text = piece.decode("utf-8", errors="replace")
        if not quiet:
            print(f"🔶 G {gen_ms:7.2f} ms I {(t1 - t0) * 1000:7.2f} ms "
                  f"T {(t2 - t1) * 1000:7.2f} ms "
                  f"S {comm.sent_bytes / 1024:7.0f} kB "
                  f"R {comm.recv_bytes / 1024:7.0f} kB {text!r}")
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
        if engine.group.size > 1:
            _print_census(engine, census, stats.tokens)
    return out_tokens, stats


def _print_census(engine: Engine, before: dict, tokens: int) -> None:
    """The collectives a token of the loop issued, by kind, beside the
    scheme's budget (comm_stats.tp_collective_budget)."""
    now = collectives.CENSUS.kind_counts()
    got = {k: (now.get(k, 0) - before.get(k, 0)) / tokens
           for k in collectives.KINDS if now.get(k, 0) - before.get(k, 0)}
    budget = tp_collective_budget(engine.spec, engine.group.size,
                                  engine.tp_scheme)
    print(f"Collectives/token:   {sum(got.values()):g} "
          f"({', '.join(f'{k} {v:g}' for k, v in got.items())}), budget "
          f"{budget.n_collectives} ({engine.tp_scheme}, tp "
          f"{engine.group.size}, {engine.group.backend})")


def _truncate(tokens) -> list[int]:
    """A row of the loop's output up to its first BOS."""
    row = []
    for t in map(int, tokens):
        if t == BOS:
            break
        row.append(t)
    return row


def generate_fast(engine: Engine, tokenizer: Tokenizer, sampler: Sampler,
                  prompt: str, steps: int, quiet: bool = False,
                  prefill_chunk: int = 0, graph: bool | None = None,
                  resume: tuple[int, int] | None = None,
                  resume_prompt: list[int] | None = None
                  ) -> tuple[list[int], GenStats]:
    """The fused-loop generation path (``--fast``): the stream generate()
    produces (forced prompt, the reference sampler, stop on BOS), from the
    on-device loop (Engine.decode_loop: one CUDA graph replay per step on
    the card). The pieces and one averaged stats line print after the loop
    returns; there are no per-token 🔶 lines.

    ``prefill_chunk > 1``: the prompt prefix fills the cache in chunked
    T > 1 passes (Engine.prefill) and the chain starts at the last prompt
    token. The coins for every possibly sampled step are drawn on a clone
    of the sampler's stream, and the stream then advances by only the
    coins the per-step loop would have drawn: after an early BOS, fewer.
    ``graph=False`` runs the step eagerly on the card (tests).

    ``resume=(pos, token)`` continues an interrupted generation (generate's
    contract: cache and sampler RNG restored first, ``resume_prompt`` the
    unconsumed prompt tail, up to ``steps`` more positions): the chain
    starts its position clock at ``pos``. A run that ends without an early
    BOS leaves its next step's inputs in GenStats.final_pos/final_token."""
    spec = engine.spec
    emit = None if quiet else (lambda s: print(s, end="", flush=True))
    pre_out: list[int] = []
    if resume is not None:
        start_pos, first = resume
        # the loop's forced stream is relative to the chain: [first] + tail
        prompt_tokens = [first] + list(resume_prompt or [])
        steps = min(steps, spec.seq_len - start_pos)
    else:
        start_pos = 0
        steps = min(steps, spec.seq_len)
        prompt_tokens = tokenizer.encode(prompt or "", bos=True, eos=False)
        if not prompt_tokens:
            raise ValueError(
                "something is wrong, expected at least 1 prompt token")
        pre = _prefill_prefix(engine, prompt_tokens, steps, prefill_chunk,
                              pre_out, emit, tokenizer)
        if pre is not None:
            # the chain takes over at the last prompt token, with no forced
            # tokens left, at position pre
            start_pos = pre
            prompt_tokens = prompt_tokens[pre:]
            steps -= pre
    prompt_tail = prompt_tokens[steps + 1:]  # beyond this chain: resume tail
    prompt_tokens = prompt_tokens[:steps + 1]

    loop = engine.decode_loop(sampler.temperature, sampler.topp, graph)
    max_steps = spec.seq_len
    padded = np.full((1, max_steps + 1), -1, dtype=np.int64)
    padded[0, :len(prompt_tokens)] = prompt_tokens
    coins = np.zeros((1, max_steps), dtype=np.float32)
    n_sampled = steps - (len(prompt_tokens) - 1)
    if n_sampled > 0 and sampler.temperature != 0.0:
        coins[0, len(prompt_tokens) - 1:steps] = \
            sampler.rng.clone().f32_array(n_sampled)

    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, _ = loop.run(padded, [prompt_tokens[0]], coins, [start_pos],
                           steps)
    total_ms = (time.perf_counter() - t0) * 1000

    chain = _truncate(toks[0][:steps])
    if emit is not None:
        prev = prompt_tokens[0]
        for t in chain:
            emit(tokenizer.decode_piece(prev, t).decode("utf-8",
                                                        errors="replace"))
            prev = t
    out_tokens = pre_out + chain
    # advance the real stream by the coins the per-step loop would have
    # drawn: one per sampled step, the one that produced a stopping BOS too
    early_bos = len(chain) < steps
    if n_sampled > 0 and sampler.temperature != 0.0:
        last_iter = len(chain) if early_bos else steps - 1
        consumed = max(0, last_iter - (len(prompt_tokens) - 1) + 1)
        if consumed:
            sampler.rng.f32_array(min(consumed, n_sampled))
    stats = GenStats(tokens=len(chain), total_ms=total_ms,
                     infer_ms=total_ms)
    if steps > 0 and not early_bos:  # no early BOS: resumable
        stats.final_pos = start_pos + steps
        stats.final_token = int(toks[0][steps - 1])
        stats.prompt_rest = prompt_tail
    # the JAX while_loop stops on a produced BOS: the steps it ran are the
    # generated tokens and the stopping step
    executed = len(chain) + 1 if early_bos else steps
    if not quiet:
        print(f"\nGenerated tokens:    {stats.tokens}")
        print(f"Avg generation time: {total_ms / max(1, len(chain)):.2f} ms "
              f"(fused loop, {executed} device steps)")
    return out_tokens, stats


def generate_batch(spec: TransformerSpec, params: dict[str, Any],
                   tokenizer: Tokenizer, prompts: list[str], steps: int,
                   temperature: float, topp: float, seed: int,
                   cache_dtype: torch.dtype = torch.float32, device="cuda",
                   quiet: bool = False, graph: bool | None = None,
                   group: TPGroup | None = None, scheme: str | None = None
                   ) -> tuple[list[list[int]], GenStats]:
    """Generate for B prompts in one lockstep batch (``--prompts-file``).

    All rows decode on one clock through Llama.forward_batch (the T = B
    matmuls, K5 attention over the (L, B, S, n_kv, hs) cache) in the
    on-device loop; ragged prompts right-pad and start sampling when their
    own prompt runs out. Row b samples from its own xorshift stream seeded
    ``seed + b``. Rows stop at BOS. The small-T body is read once here
    (``DLLAMA_MULTI_T_BODY``): for 2 <= B <= 8 'dequant' takes K1d.
    ``graph=False`` runs the step eagerly on the card (tests). With
    ``group`` the step is the rank's tensor-parallel forward_batch (K5 over
    its kv heads), ``params`` the rank's host tree of bands."""
    group = group or single(device)
    device = group.device if group.size > 1 else torch.device(device)
    _no_capture(group, device, graph)
    batch = len(prompts)
    steps = min(steps, spec.seq_len)
    body = q40.multi_t_body()
    toks_per_row = [tokenizer.encode(p or "", bos=True, eos=False)
                    for p in prompts]
    padded = np.full((batch, steps + 1), -1, dtype=np.int64)
    coins = np.zeros((batch, steps), dtype=np.float32)
    for b, pt in enumerate(toks_per_row):
        pt = pt[:steps + 1]
        padded[b, :len(pt)] = pt
        n_sampled = steps - (len(pt) - 1)
        if n_sampled > 0 and temperature != 0.0:
            coins[b, len(pt) - 1:] = Xorshift64(seed + b).f32_array(n_sampled)

    if device.type == "cuda":
        build([*q40.KERNELS, *attention.KERNELS])
    if group.size > 1:
        model = _tp_model(spec, params, group, scheme,
                          with_body(KERNELS, body))
    else:
        model = Llama(spec, params_to_device(params, device),
                      with_body(KERNELS, body))
    cache = init_cache_batch(model.spec, batch, device, cache_dtype)

    def step(tokens, pos):
        return model.forward_batch(cache, tokens, pos)

    loop = DecodeLoop(step, batch, steps, temperature, topp, device, graph)
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, _ = loop.run(padded, [p[0] for p in toks_per_row], coins,
                           np.zeros(batch, np.int32), steps)
    total_ms = (time.perf_counter() - t0) * 1000

    outs = [_truncate(row) for row in toks]
    if not quiet:
        for b, row in enumerate(outs):
            prev, text = toks_per_row[b][0], b""
            for t in row:
                text += tokenizer.decode_piece(prev, t)
                prev = t
            print(f"[{b}] {text.decode('utf-8', errors='replace')!r}")
    n_tokens = sum(len(r) for r in outs)
    stats = GenStats(tokens=n_tokens, total_ms=total_ms, infer_ms=total_ms)
    if not quiet:
        print(f"Generated tokens:    {n_tokens} across {batch} rows")
        print(f"Avg generation time: {total_ms / max(1, batch * steps):.2f} "
              f"ms/token ({batch} rows x {steps} lockstep steps)")
    return outs, stats
