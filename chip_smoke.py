#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (distributed_llama_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. Card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   build of every kernel from ``distributed_llama_tpu_torch/csrc`` (one
   nvcc per source, all started together), with the build seconds.
2. Kernels against their plain versions on the card at the Llama-2-7B
   shapes: the Q40 matvec (K1) on wqkv/wo/w13/w2/wcls, the decode
   attention (K2) at kv_mul 1 (7B) and 8 (70B-style GQA) over positions
   0..2047 on an f32 and a bf16 cache, the small-T Q40 matvec (K1m) at
   T = 2, 4, 8, the Q40 GEMM (K3) at T = 16, 100, 128 on wqkv/wo/w13/w2
   (and wcls at T = 16), its bf16 tensor-core twin (K3b) at T = 16, 128,
   the prefill attention at T = 128 and pos 0, 384, 1920 for 7B and the
   GQA shape, with f32 dots (K4) and bf16 dots (K4b), each over an f32
   and a bf16 cache, with a poisoned cache suffix past pos+T that must not
   change its output; the small-T bf16-product Q40 body (K1d) at T = 2, 4,
   8 on the four layer matrices, and the batched decode attention (K5) at
   7B and GQA shapes for B = 1 and 8 at a shared pos 63 and 2047 and at
   ragged positions, over an f32 and a bf16 cache (at B = 1 bit for bit
   K2). Max error against the stated tolerance; kernel, plain and library
   times (CUDA events, median of 25 launches, L2 flushed before each); the
   bound (bf16 rate for K3b, K4b and K1d) and what bounds it.
3. End to end: a 7B-shaped Q40 model with random codes (seeded) and a
   32000-piece tokenizer are written to build/smoke/, then the port's CLI
   runs ``inference`` in-process ten times, every kernel's launch count
   reset just before and read just after each run:
   a. 64 steps token by token, greedy: K1 4*L+1 = 129 and K2 L = 32
      launches per step;
   b. a 512-token prompt (BOS + 511 " hi") with ``--prefill-chunk 128
      --steps 576``: 4 chunks of T = 128 (K3 4*L*4 = 512, K4 L*4 = 128,
      K1m 0), then 65 decode steps from pos 511 (K1 129*65, K2 32*65);
   c. ``--buffer-float-type q80 --prefill-chunk 8``, 64 steps over the
      20-token prompt: 3 chunks of T = 8 (K1m 4*L*3 = 384, K4 L*3 = 96),
      then 45 decode steps; every step's logits must be finite;
   d. run b with ``--fast-prefill --kv-cache-dtype bf16``: K3b 512 and K4b
      (bf16-cache build) 128 in the prefill, K3 and K4 0, then K1 and the
      bf16-cache K2 per decode step; its peak device memory must lie ~1.07
      GB (the halved cache) below run b's;
   e. and f. run b with ``--fast-prefill`` alone (K3b, K4b over an f32
      cache) and with ``--kv-cache-dtype bf16`` alone (K3, the bf16-cache
      K4 and K2), 9 decode steps each;
   g. ``--prompts-file`` with 8 prompts of 4 to 40 tokens, 64 greedy
      lockstep steps, each a CUDA graph replay: K1m 129 and K5 32 launches
      per step, K1, K2 and K3 0; 8 rows of 64 tokens;
   h. run g under ``DLLAMA_MULTI_T_BODY=dequant --kv-cache-dtype bf16``:
      K1d 129 and the bf16-cache K5 32 per step, K1m 0; its peak device
      memory ~8.6 GB (the halved 8-row cache) below run g's;
   i. ``--fast`` with run a's prompt and steps: its stream equals run a's
      token for token, through K1 and K5 at B = 1 (K2 0);
   j. ``--fast --prefill-chunk 128`` on the 512-token prompt: K3 and K4
      for the prompt, then 65 chained steps (K1, K5) whose text ends with
      run b's.
4. Kernels against plain at full width: the first 4 positions of the same
   model through the forward with the kernels and with the plain versions;
   then 8 more kernel steps timed, and 8 under torch.profiler for the
   device time by kernel and the device's busy share. Then Engine.prefill
   of the 512-token prompt at chunk 128, timed (host clock, synchronised,
   median of 3), beside its matmul and attention bounds, and once more
   under torch.profiler for the in-situ device time of K3, K4 and the
   torch glue against that wall time; its cache rows and next-step logits
   held against the same tokens forced one by one through the captured
   T = 1 loop and against prefill through the plain versions on the card.
   The same 512-token Engine.prefill with ``fast_prefill``, timed back to
   back with the parity prefill and profiled once, its cache rows and next
   logits held against the plain fast route on the card
   (llama.FAST_RTOL). Then --fast against the host loop: 64 greedy steps
   of each on one engine, in turns, and the captured step under
   torch.profiler (ms/token, device busy share); and the captured 8-row
   batch step's logits held against the plain route of forward_batch
   (K1m over an f32 cache within LOGIT_RTOL; K1d over a bf16 cache within
   FAST_RTOL), and its time with nothing but replays. The random codes
   make that model's logits nearly position-independent, so a small model
   with quantized-Gaussian weights also runs through the kernels on the
   card (8 decode steps; prefill at chunk 4 through K1m, chunk 16 through
   K3 and chunk 16 on the fast route over both caches; generate_batch of 3
   prompts and generate_fast, both captured) and is held against the
   plain path on the CPU.
5. The ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import contextlib
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"

# peak rates (bytes/s, f32 FLOP/s outside the tensor cores, dense bf16
# tensor-core FLOP/s) for the bound: the H100 SXM data-sheet numbers; a
# PCIe part reads ~2.0 TB/s, 51 TFLOP/s f32, 756 TFLOP/s bf16
PEAKS = {"sxm": (3.35e12, 67e12, 989e12), "pcie": (2.0e12, 51e12, 756e12)}

# the tolerances are the port's own (ops/q40.KERNEL_RTOL,
# ops/attention.KERNEL_ATOL, models/llama.LOGIT_RTOL), shared with the tests
REPS = 25
STEPS = 64
PROMPT = " ".join(["hi"] * 19)  # BOS + 19 merged " hi" pieces = 20 tokens
PROMPT_512 = " ".join(["hi"] * 511)  # BOS + 511 " hi" = 512 tokens
CHUNK = 128          # the prefill chunk of phases 3b and 4
STEPS_512 = 576      # 511 prefilled positions + 65 decode steps
STEPS_SHORT = 520    # runs e and f: 9 decode steps after the prefill
Q80_CHUNK = 8        # phase 3c: q80 buffers, prefill through K1m
BATCH = 8            # runs g and h: 8 prompts in one lockstep batch
# runs g and h: prompts of 4, 9, ..., 40 tokens (BOS + that many - 1 " hi")
BATCH_PROMPTS = [" ".join(["hi"] * (n - 1)) for n in
                 (4, 9, 14, 19, 24, 29, 34, 40)]


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` over REPS launches, each timed with CUDA
    events after a 128 MB read that evicts the 50 MB L2 (the main path
    finds every weight matrix cold; a read leaves no dirty lines to write
    back inside the timed launch). A spin of ~0.5 ms on the card follows
    the read, so the host has queued the start event, ``fn``'s kernels and
    the end event before the card reaches them: a kernel of a few
    microseconds is timed without the host's launch time inside it."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(REPS):
            self.flush.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, flops: float, peaks,
          bf16: bool = False) -> tuple[float, str]:
    """(least ms, 'bytes' | 'operations') on this card; ``bf16`` counts the
    flops at the bf16 tensor-core rate instead of the f32 one."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[2 if bf16 else 1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 1: card + build
# --------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie"] if "PCIe" in name else PEAKS["sxm"]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; bound uses "
        f"{peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s f32, "
        f"{peaks[2] / 1e12:.0f} TFLOP/s bf16")

    from distributed_llama_tpu_torch.ops import attention, q40
    from distributed_llama_tpu_torch.ops._build import build

    kernels = [*q40.KERNELS, *attention.KERNELS]
    secs = build(kernels)
    log(f"built {sorted({k.source for k in kernels})} "
        f"({[k.symbol for k in kernels]}) in {secs:.1f} s")
    return smi, name, peaks, secs


# --------------------------------------------------------------------------
# phase 2: kernels against plain at the 7B shapes
# --------------------------------------------------------------------------

# (name, d, n, launches per token at 7B)
K1_SHAPES = [("wqkv", 12288, 4096, 32), ("wo", 4096, 4096, 32),
             ("w13", 22016, 4096, 32), ("w2", 4096, 11008, 32),
             ("wcls", 32000, 4096, 1)]
K2_CASES = [  # (label, L, n_kv, kv_mul)
    ("7b", 32, 32, 1), ("gqa8", 80, 8, 8)]
K2_POS = (0, 1, 63, 1000, 2047)
K2_SEQ, K2_HS = 2048, 128


def phase_k1(torch, timer, peaks):
    """K1 against plain; the library yardstick is cuBLAS's f32 GEMV
    (torch.matmul, TF32 off) on the weight dequantized beforehand (the
    dequant is not timed)."""
    from distributed_llama_tpu_torch.ops.q40 import (KERNEL_RTOL, q40_matmul,
                                                     q40_matmul_plain,
                                                     random_q40)
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, d, n, per_token in K1_SHAPES:
        nb = n // 32
        w = random_q40(d, n, "cuda", g)
        x = torch.randn((1, n), device="cuda", generator=g)
        got = q40_matmul(w, x)
        want = q40_matmul_plain(w, x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = KERNEL_RTOL * want.abs().max().item()
        ms = timer(lambda: q40_matmul(w, x))
        plain_ms = timer(lambda: q40_matmul_plain(w, x))
        wf = dequantize_q40_torch(w.qs, w.d16)
        library_ms = timer(lambda: torch.matmul(x, wf.T))
        nbytes = d * nb * 18 + n * 4 + d * 4
        b_ms, b_by = bound(nbytes, 2.0 * d * n, peaks)
        log(f"K1 {name:5s} ({d}x{n}): max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms gemv "
            f"{library_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
            f"{nbytes / ms / 1e6:.0f} GB/s)")
        if not err <= tol:
            raise AssertionError(f"K1 {name}: error {err} above {tol}")
        rows.append(dict(shape=name, d=d, n=n, per_token=per_token,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms))
        del w, x, got, want, wf
    return rows


def phase_k2(torch, timer, peaks, cache=None):
    """K2 against plain over an f32 cache, or over a bf16 one (``cache`` =
    torch.bfloat16, the kvbf16 build); SDPA (in the cache dtype) is the
    library yardstick."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops.attention import (
        KERNEL, KERNEL_ATOL, KERNEL_KVBF16, attention_scale,
        decode_attention, decode_attention_plain)

    cache = cache or torch.float32
    kernel = KERNEL if cache == torch.float32 else KERNEL_KVBF16
    size = torch.tensor([], dtype=cache).element_size()
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, L, n_kv, kv_mul in K2_CASES:
        shape = (L, K2_SEQ, n_kv, K2_HS)
        k_all = torch.randn(shape, device="cuda", generator=g).to(cache)
        v_all = torch.randn(shape, device="cuda", generator=g).to(cache)
        n_q = n_kv * kv_mul
        q = torch.randn((n_q, K2_HS), device="cuda", generator=g)
        layer = L - 1
        scale = attention_scale(K2_HS)
        for pos in K2_POS:
            before = kernel.launches
            got = decode_attention(q, k_all, v_all, layer, pos, kv_mul)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"not launched")
            want = decode_attention_plain(q, k_all, v_all, layer, pos, kv_mul)
            err = (got - want).abs().max().item()
            ms = timer(lambda: decode_attention(q, k_all, v_all, layer, pos,
                                                kv_mul))
            plain_ms = timer(lambda: decode_attention_plain(
                q, k_all, v_all, layer, pos, kv_mul))
            # yardstick only: the port never calls SDPA
            qs = q.reshape(1, n_q, 1, K2_HS).to(cache)
            ks = k_all[layer, :pos + 1].permute(1, 0, 2).unsqueeze(0)
            vs = v_all[layer, :pos + 1].permute(1, 0, 2).unsqueeze(0)
            def lib():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, scale=scale, enable_gqa=kv_mul > 1)

            lib_err = (lib().reshape(1, -1) - want).abs().max().item()
            library_ms = timer(lib)
            nbytes = (2 * (pos + 1) * n_kv * K2_HS * size
                      + 2 * n_q * K2_HS * 4)
            b_ms, b_by = bound(nbytes, 4.0 * (pos + 1) * n_q * K2_HS, peaks)
            log(f"{kernel.symbol} {label} pos {pos:4d}: max_abs_err "
                f"{err:.3e} (tol {KERNEL_ATOL:.0e}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms (err "
                f"{lib_err:.1e}) bound {b_ms:.5f} ms ({b_by})")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"error {err}")
            rows.append(dict(case=label, n_kv=n_kv, kv_mul=kv_mul, pos=pos,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms))
        del k_all, v_all
    return rows


def _library_gemm(torch, x, wf, bf16):
    """The one-call yardstick of a Q40 GEMM on the weight dequantized
    beforehand: cuBLAS SGEMM (TF32 off), or for bf16 cuBLAS's bf16 GEMM
    with f32 output (``torch.mm(..., out_dtype=)``; where this torch lacks
    it, the bf16-output ``torch.matmul``). Returns (fn, label); the
    operands' conversion is not timed."""
    if not bf16:
        return (lambda: torch.matmul(x, wf.T)), "sgemm"
    xb, wt = x.to(torch.bfloat16), wf.to(torch.bfloat16).T
    try:
        torch.mm(xb, wt, out_dtype=torch.float32)
        return (lambda: torch.mm(xb, wt, out_dtype=torch.float32)), \
            "bf16 gemm f32-out"
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.matmul(xb, wt)), "bf16 gemm bf16-out"


def _q40_rows(torch, timer, peaks, kernel, cases, seed, bf16=False,
              body="vpu"):
    """K1m, K3, (``bf16``) K3b or (``body="dequant"``) K1d against the plain
    version on the 7B shapes; the library yardstick is _library_gemm's (the
    bf16 one for K3b and K1d)."""
    from distributed_llama_tpu_torch.ops.q40 import (KERNEL_RTOL,
                                                     KERNEL_RTOL_BF16,
                                                     q40_matmul,
                                                     q40_matmul_plain,
                                                     random_q40)
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    tensor_cores = bf16 or body == "dequant"
    rtol = KERNEL_RTOL_BF16 if tensor_cores else KERNEL_RTOL
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, d, n, t, per_unit in cases:
        nb = n // 32
        w = random_q40(d, n, "cuda", g)
        x = torch.randn((t, n), device="cuda", generator=g)
        before = kernel.launches
        got = q40_matmul(w, x, bf16=bf16, multi_body=body)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{kernel.symbol} {name} T={t}: not launched")
        want = q40_matmul_plain(w, x, bf16=bf16, multi_body=body)
        err = (got - want).abs().max().item()
        tol = rtol * want.abs().max().item()
        wf = dequantize_q40_torch(w.qs, w.d16)
        lib, lib_name = _library_gemm(torch, x, wf, tensor_cores)
        lib_err = (lib().float() - want).abs().max().item()
        ms = timer(lambda: q40_matmul(w, x, bf16=bf16, multi_body=body))
        plain_ms = timer(lambda: q40_matmul_plain(w, x, bf16=bf16,
                                                  multi_body=body))
        library_ms = timer(lib)
        nbytes = d * nb * 18 + t * n * 4 + t * d * 4
        b_ms, b_by = bound(nbytes, 2.0 * t * d * n, peaks, tensor_cores)
        log(f"{kernel.symbol} {name:5s} T={t:3d} ({d}x{n}): max_abs_err "
            f"{err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms {lib_name} {library_ms:.4f} ms (err "
            f"{lib_err:.1e}) bound {b_ms:.4f} ms ({b_by})")
        if not err <= tol:
            raise AssertionError(f"{kernel.symbol} {name} T={t}: error {err}"
                                 f" above {tol}")
        rows.append(dict(shape=name, d=d, n=n, t=t, per_token=per_unit,
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                         library=lib_name))
        del w, x, got, want, wf, lib
    return rows


# (name, d, n) of the four layer matrices at 7B
LAYER_SHAPES = [(name, d, n) for name, d, n, _ in K1_SHAPES[:4]]


def phase_k1m(torch, timer, peaks):
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_MULTI

    cases = [(name, d, n, t, 32 if t == Q80_CHUNK else 0)
             for t in (2, 4, 8) for name, d, n in LAYER_SHAPES]
    return _q40_rows(torch, timer, peaks, KERNEL_MULTI, cases, seed=2)


def phase_k3(torch, timer, peaks):
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_GEMM

    cases = [(name, d, n, t, 32 if t == CHUNK else 0)
             for t in (16, 100, CHUNK) for name, d, n in LAYER_SHAPES]
    cases.append(("wcls", 32000, 4096, 16, 0))
    return _q40_rows(torch, timer, peaks, KERNEL_GEMM, cases, seed=3)


def phase_k3b(torch, timer, peaks):
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_GEMM_BF16

    cases = [(name, d, n, t, 32 if t == CHUNK else 0)
             for t in (16, CHUNK) for name, d, n in LAYER_SHAPES]
    return _q40_rows(torch, timer, peaks, KERNEL_GEMM_BF16, cases, seed=5,
                     bf16=True)


def phase_k1d(torch, timer, peaks):
    """K1d on the 7B layer shapes at T = 2, 4, 8 (the batched decode step of
    2..8 rows under DLLAMA_MULTI_T_BODY=dequant); K1m's rows at the same
    shapes come from phase_k1m in the same call."""
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_MULTI_BF16

    cases = [(name, d, n, t, 32 if t == BATCH else 0)
             for t in (2, 4, 8) for name, d, n in LAYER_SHAPES]
    return _q40_rows(torch, timer, peaks, KERNEL_MULTI_BF16, cases, seed=6,
                     body="dequant")


K5_CASES = [  # (label, n_kv, kv_mul): two layers of the cache, layer 1 read
    ("7b", 32, 1), ("gqa8", 8, 8)]
K5_BATCHES = (1, 8)


def _k5_positions(batch):
    """(label, positions): a shared clock at 63 and at 2047, and ragged
    clocks spread over the cache."""
    lo, hi = 5, K2_SEQ - 1
    ragged = ([lo + (hi - lo) * i // (batch - 1) for i in range(batch)]
              if batch > 1 else [900])
    return [("shared 63", [63] * batch), ("shared 2047", [2047] * batch),
            ("ragged", ragged)]


def phase_k5(torch, timer, peaks, cache=None):
    """K5 against plain over an f32 cache, or a bf16 one (``cache`` =
    torch.bfloat16), at 7B and GQA shapes for B = 1, 4, 8, shared and
    ragged clocks; at B = 1 it must equal K2 bit for bit. SDPA over the
    padded prefix with a per-row mask (in the cache dtype) is the library
    yardstick."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops.attention import (
        BATCH_KERNEL, BATCH_KERNEL_KVBF16, KERNEL_ATOL, attention_scale,
        decode_attention, decode_attention_batch,
        decode_attention_batch_plain)

    cache = cache or torch.float32
    kernel = BATCH_KERNEL if cache == torch.float32 else BATCH_KERNEL_KVBF16
    size = torch.tensor([], dtype=cache).element_size()
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    hs, layer = K2_HS, 1
    for label, n_kv, kv_mul in K5_CASES:
        n_q = n_kv * kv_mul
        for batch in K5_BATCHES:
            shape = (2 * batch, K2_SEQ, n_kv, hs)
            k4 = torch.randn(shape, device="cuda", generator=g).to(cache)
            v4 = torch.randn(shape, device="cuda", generator=g).to(cache)
            q = torch.randn((batch, n_q, hs), device="cuda", generator=g)
            for pos_label, pos in _k5_positions(batch):
                pv = torch.tensor(pos, dtype=torch.int32, device="cuda")

                def run():
                    return decode_attention_batch(q, k4, v4, layer, pv,
                                                  kv_mul)

                before = kernel.launches
                got = run()
                torch.cuda.synchronize()
                if kernel.launches != before + 1:
                    raise AssertionError(f"{kernel.symbol}: not launched")
                want = decode_attention_batch_plain(q, k4, v4, layer, pv,
                                                    kv_mul)
                err = (got - want).abs().max().item()
                if batch == 1:
                    k2 = decode_attention(q[0], k4, v4, layer, pos[0],
                                          kv_mul)
                    if not torch.equal(k2, got):
                        raise AssertionError(f"{kernel.symbol} {label} B=1 "
                                             f"{pos_label}: not K2's bits")
                live = max(pos) + 1
                qs = q.reshape(batch, n_q, 1, hs).to(cache)
                ks = k4[layer * batch:(layer + 1) * batch, :live] \
                    .permute(0, 2, 1, 3)
                vs = v4[layer * batch:(layer + 1) * batch, :live] \
                    .permute(0, 2, 1, 3)
                mask = (torch.arange(live, device="cuda")[None, :]
                        <= pv[:, None].long())[:, None, None, :]

                def lib():
                    return F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask,
                        scale=attention_scale(hs), enable_gqa=kv_mul > 1)

                lib_err = (lib().reshape(batch, -1).float() - want).abs() \
                    .max().item()
                ms = timer(run)
                plain_ms = timer(lambda: decode_attention_batch_plain(
                    q, k4, v4, layer, pv, kv_mul))
                library_ms = timer(lib)
                keys = sum(p + 1 for p in pos)
                nbytes = 2 * keys * n_kv * hs * size + 2 * batch * n_q * hs * 4
                b_ms, b_by = bound(nbytes, 4.0 * keys * n_q * hs, peaks)
                log(f"{kernel.symbol} {label} B={batch} {pos_label}: "
                    f"max_abs_err {err:.3e} (tol {KERNEL_ATOL:.0e}) kernel "
                    f"{ms:.4f} ms plain {plain_ms:.4f} ms sdpa "
                    f"{library_ms:.4f} ms (err {lib_err:.1e}) bound "
                    f"{b_ms:.5f} ms ({b_by})")
                if not err <= KERNEL_ATOL:
                    raise AssertionError(f"{kernel.symbol} {label} B={batch}"
                                         f" {pos_label}: error {err}")
                rows.append(dict(case=label, n_kv=n_kv, kv_mul=kv_mul,
                                 batch=batch, pos=pos_label,
                                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=library_ms))
            del k4, v4, q
    return rows


K4_CASES = [  # (label, L, n_kv, kv_mul)
    ("7b", 32, 32, 1), ("gqa8", 4, 8, 8)]
K4_POS = (0, 384, 1920)


def phase_k4(torch, timer, peaks, bf16=False, cache=None):
    """K4 (f32 dots) or K4b (``bf16`` dots) over an f32 cache or (``cache``
    = torch.bfloat16) a bf16 one, against the matching plain version at
    T = CHUNK; SDPA is the library yardstick (in bf16 where the kernel
    takes bf16 operands or a bf16 cache)."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import attention

    cache = cache or torch.float32
    kernel = attention._PREFILL[bf16, cache]
    plain = (attention.prefill_attention_bf16_plain if bf16
             else attention.prefill_attention_plain)
    atol = attention.KERNEL_ATOL_BF16 if bf16 else attention.KERNEL_ATOL
    lib_dtype = torch.bfloat16 if bf16 else cache
    size = torch.tensor([], dtype=cache).element_size()
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    t_len, hs = CHUNK, K2_HS
    for label, L, n_kv, kv_mul in K4_CASES:
        shape = (L, K2_SEQ, n_kv, hs)
        n_q = n_kv * kv_mul
        layer = L - 1
        for pos in K4_POS:
            k_all = torch.randn(shape, device="cuda", generator=g).to(cache)
            v_all = torch.randn(shape, device="cuda", generator=g).to(cache)
            q = torch.randn((t_len, n_q, hs), device="cuda", generator=g)

            def run():
                return attention.prefill_attention(q, k_all, v_all, layer,
                                                   pos, kv_mul, bf16=bf16)

            before = kernel.launches
            got = run()
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"not launched")
            want = plain(q, k_all, v_all, layer, pos, kv_mul)
            err = (got - want).abs().max().item()
            live = pos + t_len
            # yardstick only: the port never calls SDPA
            qs = q.permute(1, 0, 2).unsqueeze(0).to(lib_dtype)
            ks = k_all[layer, :live].permute(1, 0, 2).unsqueeze(0) \
                .to(lib_dtype)
            vs = v_all[layer, :live].permute(1, 0, 2).unsqueeze(0) \
                .to(lib_dtype)
            mask = (torch.arange(live, device="cuda")[None, :]
                    <= torch.arange(pos, live, device="cuda")[:, None])

            def lib():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, scale=attention.
                    attention_scale(hs), enable_gqa=kv_mul > 1)

            lib_err = (lib()[0].permute(1, 0, 2).reshape(t_len, -1).float()
                       - want).abs().max().item()
            ms = timer(run)
            plain_ms = timer(lambda: plain(q, k_all, v_all, layer, pos,
                                           kv_mul))
            library_ms = timer(lib)
            # a poisoned suffix past pos+T-1 must stay unread
            k_all[layer, live:] = 1e9
            v_all[layer, live:] = float("nan")
            again = run()
            torch.cuda.synchronize()
            poisoned = not torch.equal(again, got)
            nbytes = 2 * live * n_kv * hs * size + 2 * t_len * n_q * hs * 4
            row_keys = t_len * pos + t_len * (t_len + 1) // 2
            b_ms, b_by = bound(nbytes, 4.0 * n_q * hs * row_keys, peaks,
                               bf16)
            log(f"{kernel.symbol} {label} T={t_len} pos {pos:4d}: "
                f"max_abs_err {err:.3e} (tol {atol:.0e}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms (err "
                f"{lib_err:.1e}) bound {b_ms:.5f} ms ({b_by}); poisoned "
                f"suffix {'CHANGED the output' if poisoned else 'invisible'}")
            if not err <= atol:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"error {err}")
            if poisoned:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"keys past pos+T changed the output")
            rows.append(dict(case=label, n_kv=n_kv, kv_mul=kv_mul, t=t_len,
                             pos=pos, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms))
            del k_all, v_all, q, got, want, again, qs, ks, vs
    return rows


# --------------------------------------------------------------------------
# phase 3: the main path, end to end through the CLI
# --------------------------------------------------------------------------

def smoke_files():
    """A 7B-shaped Q40 .bin with random codes (seed 0) and a 32000-piece
    tokenizer in build/smoke/, written once and reused while they fit."""
    import numpy as np

    from distributed_llama_tpu_torch.io.loader import write_model
    from distributed_llama_tpu_torch.io.tokenizer import write_tokenizer
    from distributed_llama_tpu_torch.models.synth import (llama2_7b_spec,
                                                          synth_q40_fast)

    spec = llama2_7b_spec()
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    model = SMOKE_DIR / "llama2_7b_q40_seed0.bin"
    tok = SMOKE_DIR / "tokenizer_32000.bin"
    t0 = time.perf_counter()
    if not model.exists() or model.stat().st_size != spec.file_size():
        tmp = model.with_suffix(".tmp")
        write_model(str(tmp), spec, synth_q40_fast(spec, seed=0))
        tmp.replace(model)
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces += [b" ", b"h", b"i", b"hi", b" hi"]
    pieces += [f"tok{i}".encode() for i in range(len(pieces), 32000)]
    scores = np.zeros(len(pieces), np.float32)
    scores[pieces.index(b"hi")] = -0.5
    scores[pieces.index(b" hi")] = -0.4
    write_tokenizer(str(tok), pieces, scores.tolist())
    log(f"smoke model + tokenizer ready in {time.perf_counter() - t0:.1f} s "
        f"({model.stat().st_size} bytes)")
    return spec, model, tok


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _all_kernels():
    from distributed_llama_tpu_torch.ops import attention, q40

    return [*q40.KERNELS, *attention.KERNELS]


@contextlib.contextmanager
def _finite_logits(seen: list):
    """Record, for every decode step the engine runs, whether its logits
    are all finite."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime import generate

    infer = generate.Engine.infer

    def checked(self, token, pos):
        logits = infer(self, token, pos)
        seen.append(bool(np.isfinite(logits).all()))
        return logits

    generate.Engine.infer = checked
    try:
        yield
    finally:
        generate.Engine.infer = infer


def _run_cli(torch, model, tok, args: list[str], env=None):
    """The CLI in-process, with ``env`` set in the environment, and with
    every kernel's count set to 0 just before and read just after. Returns
    (stdout, launches by kernel symbol, wall s, per-step logits-finite
    flags)."""
    from distributed_llama_tpu_torch.frontend import cli

    buf = io.StringIO()
    finite = []
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)), \
                _finite_logits(finite):
            rc = cli.main(["inference", "--model", str(model), "--tokenizer",
                           str(tok), *args])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in _all_kernels()}
    if rc != 0:
        raise RuntimeError(f"CLI {args} exited {rc}")
    return buf.getvalue(), launches, wall, finite


def phase_e2e(torch, model, tok):
    torch.cuda.reset_peak_memory_stats()
    out, counts, wall, _ = _run_cli(torch, model, tok, [
        "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
        "--seed", "1"])
    launches = {"q40_matvec": counts["q40_matvec"],
                "decode_attention": counts["decode_attention"]}
    if any(n for sym, n in counts.items()
           if sym not in ("q40_matvec", "decode_attention")):
        raise AssertionError(f"token-by-token run launched {counts}")
    steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    p50 = float(re.search(r"p50 ([\d.]+)", out).group(1))
    avg = float(re.search(r"Avg generation time: ([\d.]+) ms", out).group(1))
    load_s = float(re.search(r"Loaded model in ([\d.]+)s", out).group(1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"q40_matvec": 129 * steps,
                    "decode_attention": 32 * steps}:
        raise AssertionError(f"launches {launches} over {steps} steps: "
                             f"want 129 and 32 per step")
    if out.count("🔶") < steps - 1:
        raise AssertionError("missing per-token 🔶 lines")
    e2e = dict(steps=steps, ms_per_token_p50=p50, ms_per_token_avg=avg,
               tokens_per_s=1000.0 / avg, load_s=load_s,
               peak_device_gb=peak_gb, wall_s=wall, launches=launches)
    log(f"e2e: {json.dumps(e2e)}")
    return e2e, out


def _expect(label, counts, want):
    """Every kernel's launches equal ``want``'s, 0 for a kernel it omits."""
    full = dict.fromkeys(counts, 0)
    full.update(want)
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}, want {full}")


def phase_e2e_prefill(torch, model, tok, n_layers, label="prefill",
                      flags=(), steps=STEPS_512):
    """The 512-token prompt through --prefill-chunk 128 and ``flags``: 4
    chunks of T = 128, then decode from pos 511 to ``steps``. The launch
    counts are exact, with the Q40 GEMM, prefill attention and decode
    attention builds that the flags select (--fast-prefill: K3b and K4b;
    --kv-cache-dtype bf16: the bf16-cache builds), every other kernel 0."""
    fast = "--fast-prefill" in flags
    kvbf16 = "bf16" in flags
    gemm = "q40_gemm_bf16" if fast else "q40_gemm"
    prefill = ("prefill_attention_bf16" if fast else "prefill_attention") \
        + ("_kvbf16" if kvbf16 else "")
    decode = "decode_attention" + ("_kvbf16" if kvbf16 else "")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, counts, wall, finite = _run_cli(torch, model, tok, [
        "--prompt", PROMPT_512, "--steps", str(steps), "--temperature",
        "0", "--seed", "1", "--prefill-chunk", str(CHUNK), *flags])
    decode_steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    n_chunks = (511 + CHUNK - 1) // CHUNK
    _expect(f"{label} run", counts, {
        "q40_matvec": (4 * n_layers + 1) * decode_steps,
        gemm: 4 * n_layers * n_chunks,
        decode: n_layers * decode_steps,
        prefill: n_layers * n_chunks})
    if (decode_steps != steps - 511 or not all(finite)
            or len(finite) != decode_steps):
        raise AssertionError(f"{label} run: {decode_steps} decode steps, "
                             f"finite logits {sum(finite)}/{len(finite)}")
    if out.count("🔶") < decode_steps - 1:
        raise AssertionError("missing per-token 🔶 lines")
    res = dict(prompt_tokens=512, chunk=CHUNK, flags=list(flags),
               decode_steps=decode_steps, wall_s=wall, launches=counts,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               ms_per_token_avg=float(re.search(
                   r"Avg generation time: ([\d.]+) ms", out).group(1)))
    log(f"e2e {label}: {json.dumps(res)}")
    if label == "prefill":
        res["pieces"] = _pieces(out)  # run j's reference stream
    return res


def phase_e2e_bf16(torch, model, tok, n_layers, f32_run):
    """Runs d-f: the 512-token prompt with --fast-prefill and a bf16 cache
    (d, the slice's main path; its peak device memory must lie about the
    1.07 GB of the halved 7B cache below run b's), --fast-prefill alone
    (e) and the bf16 cache alone (f), each with exact launch counts."""
    both = phase_e2e_prefill(torch, model, tok, n_layers, "fast bf16-cache",
                             ("--fast-prefill", "--kv-cache-dtype", "bf16"))
    saved = f32_run["peak_device_gb"] - both["peak_device_gb"]
    log(f"peak device memory: {both['peak_device_gb']:.3f} GB with a bf16 "
        f"cache, {f32_run['peak_device_gb']:.3f} GB with f32: "
        f"{saved:.3f} GB less")
    if not 0.9 <= saved <= 1.25:
        raise AssertionError(f"the bf16 cache saved {saved:.3f} GB of peak "
                             f"device memory, not ~1.07")
    fast = phase_e2e_prefill(torch, model, tok, n_layers, "fast",
                             ("--fast-prefill",), steps=STEPS_SHORT)
    kvbf16 = phase_e2e_prefill(torch, model, tok, n_layers, "bf16-cache",
                               ("--kv-cache-dtype", "bf16"),
                               steps=STEPS_SHORT)
    return dict(fast_bf16_cache=both, fast=fast, bf16_cache=kvbf16,
                peak_saved_gb=saved)


def _pieces(out):
    """The decoded text of the 🔶 lines, in order."""
    return "".join(ast.literal_eval(ln.rsplit(" kB ", 1)[1])
                   for ln in out.splitlines() if ln.startswith("🔶"))


def _fast_text(out):
    """The text --fast prints before its stats line."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines)
             if ln.startswith("Generated tokens:"))
    return lines[i - 1]


def phase_e2e_batch(torch, model, tok, n_layers, label, env=None,
                    flags=()):
    """Runs g and h: the 8 ragged prompts through --prompts-file, STEPS
    greedy lockstep steps, every step one graph replay of K5 and the
    8-token Q40 body: K1m, or K1d under DLLAMA_MULTI_T_BODY=dequant; the
    bf16-cache K5 with --kv-cache-dtype bf16. Exact launch counts, 8 rows
    of STEPS tokens each (no row meets BOS on the random-code model)."""
    dequant = (env or {}).get("DLLAMA_MULTI_T_BODY") == "dequant"
    kvbf16 = "bf16" in flags
    small = "q40_matvec_bf16" if dequant else "q40_matvec_multi"
    attn = "decode_attention_batch" + ("_kvbf16" if kvbf16 else "")
    path = SMOKE_DIR / "prompts.txt"
    path.write_text("\n".join(BATCH_PROMPTS) + "\n")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, counts, wall, _ = _run_cli(torch, model, tok, [
        "--prompts-file", str(path), "--steps", str(STEPS),
        "--temperature", "0", "--seed", "1", *flags], env)
    _expect(f"{label} run", counts, {small: (4 * n_layers + 1) * STEPS,
                                     attn: n_layers * STEPS})
    rows = re.findall(r"^\[(\d)\] (.*)$", out, re.M)
    m = re.search(r"Generated tokens:\s+(\d+) across (\d+) rows", out)
    tokens = int(m.group(1))
    avg = float(re.search(r"Avg generation time: ([\d.]+) ms/token",
                          out).group(1))
    if len(rows) != BATCH or int(m.group(2)) != BATCH \
            or tokens != BATCH * STEPS:
        raise AssertionError(f"{label} run: {len(rows)} rows, {tokens} "
                             f"tokens, want {BATCH} rows of {STEPS}")
    res = dict(batch=BATCH, steps=STEPS, env=env or {}, flags=list(flags),
               prompt_tokens=[len(p.split()) + 1 for p in BATCH_PROMPTS],
               tokens=tokens, ms_per_row_token=avg,
               # the CLI's one run captures the graph inside its timing
               tokens_per_s_with_capture=1000.0 / avg, wall_s=wall,
               launches=counts,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"e2e {label}: {json.dumps(res)}")
    res["rows"] = [text for _, text in rows]
    return res


def phase_e2e_fast(torch, model, tok, n_layers, ref_a, ref_b):
    """Runs i and j: --fast with run a's prompt and steps (its stream must
    equal run a's token for token, through K1 and K5 at B = 1, K2 never
    launched), and --fast --prefill-chunk 128 on the 512-token prompt (K3
    and K4 for the 4 chunks, then the chain from pos 511; its text must
    end with run b's decode pieces)."""
    res = {}
    for label, args, ref, chain, chunks in (
            ("fast", ["--prompt", PROMPT, "--steps", str(STEPS)],
             ref_a, STEPS, 0),
            ("fast prefill", ["--prompt", PROMPT_512, "--steps",
                              str(STEPS_512), "--prefill-chunk",
                              str(CHUNK)], ref_b, STEPS_512 - 511, 4)):
        out, counts, wall, _ = _run_cli(torch, model, tok, [
            *args, "--temperature", "0", "--seed", "1", "--fast"])
        want = {"q40_matvec": (4 * n_layers + 1) * chain,
                "decode_attention_batch": n_layers * chain}
        if chunks:
            want.update(q40_gemm=4 * n_layers * chunks,
                        prefill_attention=n_layers * chunks)
        _expect(f"{label} run", counts, want)
        text = _fast_text(out)
        same = text == ref if not chunks else text.endswith(ref)
        steps = int(re.search(r"fused loop, (\d+) device steps",
                              out).group(1))
        avg = float(re.search(r"Avg generation time: ([\d.]+) ms",
                              out).group(1))
        log(f"e2e {label}: {steps} device steps, {avg:.3f} ms/token (the "
            f"first run includes the capture); stream "
            f"{'equals' if same else 'DIFFERS from'} the host loop's")
        if not same or steps != chain:
            raise AssertionError(f"{label} run: stream differs from the "
                                 f"host loop's or {steps} != {chain} steps")
        res[label] = dict(device_steps=steps, ms_per_token_avg=avg,
                          wall_s=wall, launches=counts)
    return res


def phase_e2e_q80(torch, model, tok, n_layers):
    """Run c: q80 buffers, the 20-token prompt through --prefill-chunk 8."""
    out, counts, wall, finite = _run_cli(torch, model, tok, [
        "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
        "--seed", "1", "--buffer-float-type", "q80", "--prefill-chunk",
        str(Q80_CHUNK)])
    steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    n_chunks = (19 + Q80_CHUNK - 1) // Q80_CHUNK
    _expect("q80 run", counts, {
        "q40_matvec": (4 * n_layers + 1) * steps,
        "q40_matvec_multi": 4 * n_layers * n_chunks,
        "q40_gemm": 0,
        "decode_attention": n_layers * steps,
        "prefill_attention": n_layers * n_chunks})
    if steps != STEPS - 19 or not all(finite) or len(finite) != steps:
        raise AssertionError(f"q80 run: {steps} decode steps, finite "
                             f"logits {sum(finite)}/{len(finite)}")
    res = dict(buffer="q80", chunk=Q80_CHUNK, decode_steps=steps,
               wall_s=wall, launches=counts, finite_steps=sum(finite))
    log(f"e2e q80: {json.dumps(res)}")
    return res


# --------------------------------------------------------------------------
# phase 4: kernels against plain at full width, end to end
# --------------------------------------------------------------------------

def phase_full_width(torch, model, tok, peaks):
    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.runtime.generate import Engine

    spec, host = load_model(str(model), weights_float_type=FloatType.Q40)
    engine = Engine(spec, host, "cuda")
    del host
    tokenizer = Tokenizer(str(tok), spec.vocab_size)
    tokens = tokenizer.encode(PROMPT)[:4]
    kern = engine.model
    plain = llama.Llama(spec, engine.params, llama.PLAIN)
    ck = llama.init_cache(spec, "cuda")
    cp = llama.init_cache(spec, "cuda")
    worst = 0.0
    with torch.inference_mode():
        for pos, t in enumerate(tokens):
            a = kern(ck, t, pos)
            b = plain(cp, t, pos)
            if not (torch.isfinite(a).all() and a.shape == (1, spec.vocab_size)):
                raise AssertionError(f"pos {pos}: bad logits {a.shape}")
            err = (a - b).abs().max().item()
            tol = llama.LOGIT_RTOL * b.abs().max().item()
            log(f"full width pos {pos}: max|logit| {b.abs().max().item():.3f} "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) argmax "
                f"{a.argmax().item()} / {b.argmax().item()}")
            if not err <= tol:
                raise AssertionError(f"pos {pos}: kernel vs plain logits "
                                     f"differ by {err}")
            worst = max(worst, err)
        busy = profile_steps(torch, kern, ck, tokens[-1], len(tokens))
    del ck, cp
    prefill = prefill_full_width(torch, engine, plain,
                                 tokenizer.encode(PROMPT_512), peaks)
    prefill["fast"] = prefill_fast_full_width(
        torch, engine, tokenizer.encode(PROMPT_512), peaks)
    fast = fast_full_width(torch, engine, tokenizer)
    batch = batch_full_width(torch, engine)
    return worst, busy, prefill, fast, batch


def fast_full_width(torch, engine, tokenizer):
    """--fast against the host loop at full width: generate and
    generate_fast of run a's prompt and STEPS greedy steps on the same
    engine, timed in turns after one warm-up run of each (which captures
    the graph): host, fast, fast, host, host, fast (medians of the mean
    ms/token). Then one generate_fast under torch.profiler for the device
    time per step, read against the unprofiled ms/token: the busy share."""
    from distributed_llama_tpu_torch.runtime.generate import (generate,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    def run(fast):
        engine.reset()
        fn = generate_fast if fast else generate
        out, stats = fn(engine, tokenizer, Sampler(32000, 0.0, 0.9, 1),
                        PROMPT, STEPS, quiet=True)
        torch.cuda.synchronize()
        return out, stats.total_ms / stats.tokens

    ms = {False: [], True: []}
    streams = {fast: run(fast)[0] for fast in (False, True)}
    if streams[True] != streams[False]:
        raise AssertionError("full width: --fast stream differs from the "
                             "host loop's")
    for fast in (False, True, True, False, False, True):
        ms[fast].append(run(fast)[1])
    loop = engine.decode_loop(0.0, 0.9)
    replays = loop.replays
    dev, prof_ms = _profiled(torch, lambda: run(True), STEPS)
    if loop.replays - replays != STEPS:
        raise AssertionError(f"the fused loop replayed its graph "
                             f"{loop.replays - replays} times, not {STEPS}")
    dev_ms = sum(m for _, m, _ in dev)
    host_ms, fast_ms = statistics.median(ms[False]), statistics.median(
        ms[True])
    log(f"--fast vs host loop, {STEPS} greedy 7B steps in turns: fused "
        f"{fast_ms:.3f} ms/token (runs "
        f"{', '.join(f'{t:.3f}' for t in ms[True])}), host {host_ms:.3f} "
        f"ms/token (runs "
        f"{', '.join(f'{t:.3f}' for t in ms[False])}); fused step device "
        f"time {dev_ms:.4f} ms over {sum(c for *_, c in dev):.0f} kernels "
        f"(busy {dev_ms / fast_ms:.1%} of the unprofiled step)")
    for key, m, count in dev[:8]:
        log(f"  {m:8.4f} ms/step  x{count:5.0f}  {key[:90]}")
    return dict(steps=STEPS, fast_ms_per_token=fast_ms,
                fast_runs_ms=ms[True], host_ms_per_token=host_ms,
                host_runs_ms=ms[False], device_ms_per_step=dev_ms,
                kernels_per_step=sum(c for *_, c in dev),
                busy=dev_ms / fast_ms if dev_ms else None,
                profiled_ms_per_token=prof_ms, replays=loop.replays)


def batch_full_width(torch, engine):
    """The captured batch step's logits against the plain route of
    forward_batch at full width, 8 rows (a cache of seq_len 128: the
    kernels do not depend on it): the loop runs n steps, its cache and
    inputs are copied, the same loop runs n + 1 steps (bitwise the same
    first n), and the last replayed step's logits are held against the
    PLAIN forward_batch from the copy. For the 'vpu' body over an f32 cache
    (K1m, K5) within LOGIT_RTOL, and for 'dequant' over a bf16 cache (K1d,
    bf16-cache K5) against the plain bf16-product route within FAST_RTOL.
    Then the step's time with nothing but replays: three timed runs of
    n + 1 steps (median ms/step, tokens/s across the rows) and one under
    torch.profiler (device time per step, busy share)."""
    import dataclasses

    import numpy as np

    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.runtime.decode import DecodeLoop

    spec = dataclasses.replace(engine.spec, seq_len=128)
    rng = np.random.default_rng(12)
    steps = 24
    prompts = np.full((BATCH, steps + 2), -1)
    for b in range(BATCH):
        n = 1 + 2 * b
        prompts[b, :n] = rng.integers(3, spec.vocab_size, n)
    res = {}
    for body, dtype, rtol in (("vpu", torch.float32, llama.LOGIT_RTOL),
                              ("dequant", torch.bfloat16, llama.FAST_RTOL)):
        model = llama.Llama(spec, engine.params,
                            llama.with_body(llama.KERNELS, body))
        cache = llama.init_cache_batch(spec, BATCH, "cuda", dtype)
        loop = DecodeLoop(lambda t, p: model.forward_batch(cache, t, p),
                          BATCH, steps + 1, 0.0, 0.9, "cuda")
        coins = np.zeros((BATCH, steps + 1), np.float32)
        start = np.zeros(BATCH, np.int32)
        with torch.inference_mode():
            loop.run(prompts, prompts[:, 0], coins, start, steps)
            snap = llama.KVCache(cache.k.clone(), cache.v.clone())
            tokens, pos = loop.tokens.clone(), loop.pos.clone()
            loop.run(prompts, prompts[:, 0], coins, start, steps + 1)
            got = loop.logits.clone()
            want = model.forward_batch(snap, tokens, pos,
                                       route=llama.with_body(llama.PLAIN,
                                                             body))
        err = (got - want).abs().max().item()
        tol = rtol * want.abs().max().item()
        log(f"captured batch step ({body}, {dtype}) vs plain forward_batch "
            f"at full width, B={BATCH}, pos {steps}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}); {loop.replays} replays")
        if not (err <= tol and torch.isfinite(got).all()
                and loop.replays == 2 * steps):
            raise AssertionError(f"captured batch step ({body}): error {err}"
                                 f" or {loop.replays} replays")

        def steps_run():
            with torch.inference_mode():
                loop.run(prompts, prompts[:, 0], coins, start, steps + 1)
            torch.cuda.synchronize()

        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            steps_run()
            times.append((time.perf_counter() - t0) * 1e3 / (steps + 1))
        ms = statistics.median(times)
        dev, _ = _profiled(torch, steps_run, steps + 1)
        dev_ms = sum(m for _, m, _ in dev)
        log(f"captured batch step ({body}): {ms:.3f} ms/step (runs "
            f"{', '.join(f'{t:.3f}' for t in times)}), "
            f"{BATCH * 1e3 / ms:.0f} tokens/s across {BATCH} rows; device "
            f"{dev_ms:.3f} ms/step (busy {dev_ms / ms:.1%})")
        for key, m, count in dev[:5]:
            log(f"  {m:8.4f} ms/step  x{count:5.0f}  {key[:90]}")
        res[body] = dict(logit_err=err, logit_tol=tol, ms_per_step=ms,
                         runs_ms=times, tokens_per_s=BATCH * 1e3 / ms,
                         device_ms_per_step=dev_ms,
                         busy=dev_ms / ms if dev_ms else None,
                         replays=loop.replays)
        del snap, cache, loop
    return res


def _prefill_bounds(spec, n_tokens, peaks, bf16=False):
    """(matmul bound ms, attention bound ms) of prefilling n_tokens at
    CHUNK: the 4 layer matrices of every layer at T = CHUNK per chunk, and
    K4's bound per layer and chunk (as phase_k4 counts it); ``bf16`` counts
    the operations at the bf16 rate (K3b, K4b)."""
    hs, n_q, n_kv = spec.head_size, spec.n_heads, spec.n_kv_heads
    mm = att = 0.0
    for pos in range(0, n_tokens, CHUNK):
        for _, d, n in LAYER_SHAPES:
            nbytes = d * (n // 32) * 18 + CHUNK * (n + d) * 4
            mm += bound(nbytes, 2.0 * CHUNK * d * n, peaks,
                        bf16)[0] * spec.n_layers
        live = pos + CHUNK
        nbytes = 2 * live * n_kv * hs * 4 + 2 * CHUNK * n_q * hs * 4
        row_keys = CHUNK * pos + CHUNK * (CHUNK + 1) // 2
        att += bound(nbytes, 4.0 * n_q * hs * row_keys, peaks,
                     bf16)[0] * spec.n_layers
    return mm, att


def prefill_full_width(torch, engine, plain, tokens, peaks):
    """Engine.prefill of the 512-token prompt at CHUNK: timed, then held
    against the same tokens stepped at T = 1 (forced through the captured
    loop: K1 and K5, whose B = 1 sums are K2's) and against prefill
    through the plain versions, on the cache rows and the next-step
    logits. Tolerance: LOGIT_RTOL of the reference's largest magnitude
    (f32 throughout; the routes sum in different orders through 32
    layers)."""
    import numpy as np

    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.runtime.decode import DecodeLoop
    from distributed_llama_tpu_torch.runtime.generate import \
        run_chunked_prefill

    spec, kern = engine.spec, engine.model
    n = len(tokens)
    if n != 512:
        raise AssertionError(f"the 512-token prompt encodes to {n} tokens")
    with torch.inference_mode():
        engine.prefill(tokens, 0, CHUNK)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.prefill(tokens, 0, CHUNK)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        mm_bound, att_bound = _prefill_bounds(spec, n, peaks)
        log(f"prefill {n} tokens at chunk {CHUNK}: {ms:.2f} ms (runs "
            f"{', '.join(f'{t:.2f}' for t in times)}), {n / ms * 1e3:.0f} "
            f"tokens/s; bound {mm_bound:.2f} ms of matmuls (operations) + "
            f"{att_bound:.3f} ms of attention")
        in_situ = profile_prefill(torch, engine, tokens, ms)
        nxt = tokens[-1]
        got = kern(engine.cache, nxt, n)

        # the same tokens stepped at T = 1, forced one by one through the
        # captured loop (K1 and K5, whose B = 1 sums are K2's)
        stepped = llama.init_cache(spec, "cuda")
        view = llama.KVCache(stepped.k.unsqueeze(1), stepped.v.unsqueeze(1))
        DecodeLoop(lambda t, p: kern.forward_batch(view, t, p), 1, n, 0.0,
                   0.9, "cuda").run(np.array([tokens + [-1]]), tokens[:1],
                                    np.zeros((1, n), np.float32), [0], n)
        want = kern(stepped, nxt, n)
        checks = {"stepwise": (stepped, want)}
        del stepped

        viaplain = llama.init_cache(spec, "cuda")
        run_chunked_prefill(
            lambda part, start: plain(viaplain, part, start, logits=False),
            tokens, 0, CHUNK, spec.seq_len)
        checks["plain"] = (viaplain, plain(viaplain, nxt, n))
        del viaplain

        res = dict(tokens=n, chunk=CHUNK, ms=ms, runs_ms=times,
                   tokens_per_s=n / ms * 1e3, matmul_bound_ms=mm_bound,
                   attention_bound_ms=att_bound, in_situ=in_situ)
        if not torch.isfinite(got).all():
            raise AssertionError("prefilled next-step logits not finite")
        for label, (cache, ref) in checks.items():
            cache_err = max((engine.cache.k[:, :n] - cache.k[:, :n]).abs()
                            .max().item(),
                            (engine.cache.v[:, :n] - cache.v[:, :n]).abs()
                            .max().item())
            cache_tol = llama.LOGIT_RTOL * max(
                cache.k[:, :n].abs().max().item(),
                cache.v[:, :n].abs().max().item())
            err = (got - ref).abs().max().item()
            tol = llama.LOGIT_RTOL * ref.abs().max().item()
            log(f"prefill vs {label}: cache rows 0..{n - 1} max_abs_err "
                f"{cache_err:.3e} (tol {cache_tol:.3e}); next logits "
                f"max_abs_err {err:.3e} (tol {tol:.3e})")
            if not (cache_err <= cache_tol and err <= tol):
                raise AssertionError(f"prefill vs {label}: cache {cache_err}"
                                     f" / logits {err} above tolerance")
            res[f"vs_{label}"] = dict(cache_err=cache_err,
                                      cache_tol=cache_tol, logit_err=err,
                                      logit_tol=tol)
            del cache
        checks.clear()
    return res


def prefill_fast_full_width(torch, engine, tokens, peaks):
    """The same 512-token Engine.prefill with ``fast_prefill`` (every
    window of CHUNK tokens through K3b and K4b, the engine's f32 cache):
    timed back to back with the parity prefill in turns (parity, fast,
    fast, parity, parity, fast; medians), profiled once in situ, then its
    cache rows and next-step logits held against the same windows through
    the plain fast route on the card (FAST_PLAIN) within llama.FAST_RTOL.
    The drift against the parity prefill's cache is recorded."""
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.runtime.generate import \
        run_chunked_prefill

    spec, kern = engine.spec, engine.model
    n, nxt = len(tokens), tokens[-1]
    times = {False: [], True: []}
    with torch.inference_mode():
        for fast in (False, True, True, False, False, True):
            engine.fast_prefill = fast
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.prefill(tokens, 0, CHUNK)
            torch.cuda.synchronize()
            times[fast].append((time.perf_counter() - t0) * 1e3)
        parity_ms = statistics.median(times[False])
        ms = statistics.median(times[True])
        mm_bound, att_bound = _prefill_bounds(spec, n, peaks, bf16=True)
        log(f"fast prefill {n} tokens at chunk {CHUNK}: {ms:.2f} ms (runs "
            f"{', '.join(f'{t:.2f}' for t in times[True])}) against parity "
            f"{parity_ms:.2f} ms (runs "
            f"{', '.join(f'{t:.2f}' for t in times[False])}) in the same "
            f"call; {n / ms * 1e3:.0f} tokens/s; bound {mm_bound:.3f} ms of "
            f"matmuls + {att_bound:.3f} ms of attention (bf16 rate)")
        in_situ = profile_prefill(torch, engine, tokens, ms)
        engine.prefill(tokens, 0, CHUNK)  # fast, into engine.cache
        engine.fast_prefill = False
        got = kern(engine.cache, nxt, n)
        viaplain = llama.init_cache(spec, "cuda")
        run_chunked_prefill(
            lambda part, start: kern(viaplain, part, start, logits=False,
                                     route=llama.FAST_PLAIN),
            tokens, 0, CHUNK, spec.seq_len)
        want = kern(viaplain, nxt, n, route=llama.PLAIN)
        parity = llama.init_cache(spec, "cuda")
        run_chunked_prefill(
            lambda part, start: kern(parity, part, start, logits=False),
            tokens, 0, CHUNK, spec.seq_len)
        par_logits = kern(parity, nxt, n)
        if not torch.isfinite(got).all():
            raise AssertionError("fast-prefilled next logits not finite")
        cache_err = max((engine.cache.k[:, :n] - viaplain.k[:, :n]).abs()
                        .max().item(),
                        (engine.cache.v[:, :n] - viaplain.v[:, :n]).abs()
                        .max().item())
        scale = max(viaplain.k[:, :n].abs().max().item(),
                    viaplain.v[:, :n].abs().max().item())
        cache_tol = llama.FAST_RTOL * scale
        err = (got - want).abs().max().item()
        tol = llama.FAST_RTOL * want.abs().max().item()
        drift = (engine.cache.k[:, :n] - parity.k[:, :n]).abs().max().item() \
            / parity.k[:, :n].abs().max().item()
        logit_drift = ((got - par_logits).abs().max()
                       / par_logits.abs().max()).item()
        log(f"fast prefill vs plain fast route: cache rows 0..{n - 1} "
            f"max_abs_err {cache_err:.3e} (tol {cache_tol:.3e}); next "
            f"logits max_abs_err {err:.3e} (tol {tol:.3e}); drift against "
            f"the parity prefill: cache {drift:.3e}, logits "
            f"{logit_drift:.3e} of their scale")
        del viaplain, parity
        if not (cache_err <= cache_tol and err <= tol):
            raise AssertionError(f"fast prefill vs plain: cache {cache_err} "
                                 f"/ logits {err} above tolerance")
    return dict(tokens=n, chunk=CHUNK, ms=ms, runs_ms=times[True],
                parity_ms=parity_ms, parity_runs_ms=times[False],
                tokens_per_s=n / ms * 1e3, matmul_bound_ms=mm_bound,
                attention_bound_ms=att_bound, in_situ=in_situ,
                cache_err=cache_err, cache_tol=cache_tol, logit_err=err,
                logit_tol=tol, cache_drift=drift, logit_drift=logit_drift)


def profile_steps(torch, model, cache, token, pos0, n=8):
    """Where a decode step's time goes: the wall time of n forward steps
    (host clock, ending in a synchronize), then the same steps under
    torch.profiler for the device time by kernel. Returns the device busy
    share (device kernel time / wall), or None when the trace holds no
    device time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        model(cache, token, pos0 + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    def steps():
        for i in range(n):
            model(cache, token, pos0 + n + i)

    dev, prof_ms = _profiled(torch, steps, n)
    dev_ms = sum(ms for _, ms, _ in dev)
    log(f"decode step (no profiler): {wall_ms:.4f} ms wall ({prof_ms:.4f} "
        f"under the profiler); device kernel time {dev_ms:.4f} ms/step over "
        f"{sum(c for *_, c in dev):.0f} kernels/step")
    for key, ms, count in dev[:10]:
        log(f"  {ms:8.4f} ms/step  x{count:5.0f}  {key[:90]}")
    if dev_ms == 0:
        log("  the profiler traced no device time: busy share not measured")
        return None
    return dict(wall_ms=wall_ms, profiled_wall_ms=prof_ms, device_ms=dev_ms,
                busy=dev_ms / wall_ms,
                kernels_per_step=sum(c for *_, c in dev),
                top=[dict(kernel=k[:80], ms=ms, count=c)
                     for k, ms, c in dev[:6]])


def _profiled(torch, fn, n):
    """Run ``fn`` (n units of work) once under torch.profiler. Returns
    ([(kernel, device ms per unit, launches per unit)], slowest first, and
    the profiled wall ms per unit). Kernel entries only: an aten op's entry
    repeats its kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                  for e in events if e.self_device_time_total > 0),
                 key=lambda r: -r[1])
    return dev, prof_ms


def profile_prefill(torch, engine, tokens, wall_ms):
    """Where a prefill's time goes in situ: one Engine.prefill of ``tokens``
    at CHUNK under torch.profiler, its device time split into the Q40 GEMM
    (K3 or K3b), the prefill attention (K4 or K4b) and the rest (the torch
    glue), each read against ``wall_ms``, the unprofiled wall time of the
    same call. Returns None when the trace holds no device time."""
    dev, prof_ms = _profiled(torch, lambda: engine.prefill(tokens, 0, CHUNK),
                             1)
    dev_ms = sum(ms for _, ms, _ in dev)
    if dev_ms == 0:
        log("prefill profile: the profiler traced no device time")
        return None
    split = {"q40_gemm": [0.0, 0.0], "prefill_attention": [0.0, 0.0],
             "other": [0.0, 0.0]}
    for key, ms, count in dev:
        part = next((p for p in ("q40_gemm", "prefill_attention")
                     if f"{p}_kernel" in key or f"{p}_bf16_kernel" in key),
                    "other")
        split[part][0] += ms
        split[part][1] += count
    log(f"prefill in situ: {wall_ms:.2f} ms wall ({prof_ms:.2f} under the "
        f"profiler); device kernel time {dev_ms:.2f} ms (busy "
        f"{dev_ms / wall_ms:.1%}): " + ", ".join(
            f"{p} {ms:.2f} ms x{c:.0f} ({ms / wall_ms:.1%} of the wall)"
            for p, (ms, c) in split.items()))
    for key, ms, count in dev[:6]:
        log(f"  {ms:8.3f} ms  x{count:5.0f}  {key[:90]}")
    return dict(wall_ms=wall_ms, profiled_wall_ms=prof_ms, device_ms=dev_ms,
                busy=dev_ms / wall_ms,
                **{f"{p}_ms": ms for p, (ms, _) in split.items()},
                **{f"{p}_launches": c for p, (_, c) in split.items()})


def phase_small_reference(torch):
    """A small model with quantized-Gaussian weights (GQA, head size 128,
    so both kernels run): the forward through the kernels on the card
    against the plain path on the CPU, 8 positions. The logits move with
    the position here, unlike the random-code smoke model's."""
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.ops.quants import FloatType

    spec = TransformerSpec(dim=512, hidden_dim=1376, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=1000, seq_len=64,
                           weights_float_type=FloatType.Q40)
    host = synth_params(spec, q40=True, seed=7)
    gpu = llama.Llama(spec, llama.params_to_device(host, "cuda"))
    cpu = llama.Llama(spec, llama.params_to_device(host, "cpu"))
    cg, cc = llama.init_cache(spec, "cuda"), llama.init_cache(spec, "cpu")
    worst, argmaxes = 0.0, set()
    with torch.inference_mode():
        for pos, t in enumerate([1, 17, 400, 3, 3, 999, 42, 7]):
            a = gpu(cg, t, pos).cpu()
            b = cpu(cc, t, pos)
            err = (a - b).abs().max().item()
            tol = llama.LOGIT_RTOL * b.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"small model pos {pos}: card vs CPU "
                                     f"logits differ by {err} > {tol}")
            worst = max(worst, err)
            argmaxes.add(int(b.argmax()))
    log(f"small model, kernels on the card vs plain on the CPU: 8 positions, "
        f"max_abs_err {worst:.3e}, {len(argmaxes)} distinct argmaxes")
    small_loops(torch, spec, host)
    return max(worst, small_prefill(torch, spec, gpu, cpu))


def small_loops(torch, spec, host):
    """The on-device loops on the small model: generate_batch of 3 ragged
    prompts (captured K1m / K5 on the card) and generate_fast (captured K1
    / K5) against the same calls on the CPU's plain versions: greedy token
    streams equal."""
    from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                              generate_batch,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    class Tok:  # ids as pieces: "a b c" -> [1, a, b, c]
        def encode(self, text, bos=True, eos=False):
            return [1, *map(int, text.split())]

        def decode_piece(self, prev, tok):
            return b"."

    prompts = ["17", "400 3 3 999", "42 7"]
    rows = {dev: generate_batch(spec, host, Tok(), prompts, 20, 0.0, 0.9, 1,
                                device=dev, quiet=True)[0]
            for dev in ("cuda", "cpu")}
    fast = {dev: generate_fast(Engine(spec, host, dev), Tok(),
                               Sampler(spec.vocab_size, 0.0, 0.9, 1),
                               "5 6 7", 20, quiet=True)[0]
            for dev in ("cuda", "cpu")}
    log(f"small model loops, card vs CPU: batch rows "
        f"{'equal' if rows['cuda'] == rows['cpu'] else 'DIFFER'}, fused "
        f"stream {'equal' if fast['cuda'] == fast['cpu'] else 'DIFFERS'}")
    if rows["cuda"] != rows["cpu"] or fast["cuda"] != fast["cpu"]:
        raise AssertionError("small model: a loop's card stream differs "
                             "from the CPU's")


def small_prefill(torch, spec, gpu, cpu):
    """Prefill of 40 tokens at chunk 4 (through K1m) and 16 (through K3),
    and at chunk 16 on the fast route (K3b and K4b, f32 and bf16 caches),
    on the card against the plain path on the CPU: cache rows and next-step
    logits, with the exact launch counts."""
    import numpy as np

    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.runtime.generate import \
        run_chunked_prefill

    tokens = [int(t) for t in np.random.default_rng(8).integers(
        2, spec.vocab_size, 40)]
    L = spec.n_layers
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, chunk, route, cache dtype, launches, rtol)
        ("chunk 4", 4, None, f32, {"q40_matvec_multi": 4 * L * 10,
                                   "prefill_attention": L * 10},
         llama.LOGIT_RTOL),
        ("chunk 16", 16, None, f32, {"q40_gemm": 4 * L * 3,
                                     "prefill_attention": L * 3},
         llama.LOGIT_RTOL),
        ("fast chunk 16", 16, llama.FAST, f32,
         {"q40_gemm_bf16": 4 * L * 3, "prefill_attention_bf16": L * 3},
         llama.FAST_RTOL),
        ("fast chunk 16 bf16 cache", 16, llama.FAST, bf16,
         {"q40_gemm_bf16": 4 * L * 3,
          "prefill_attention_bf16_kvbf16": L * 3}, llama.FAST_RTOL)]
    worst = 0.0
    with torch.inference_mode():
        for label, chunk, route, dtype, want, rtol in cases:
            cg = llama.init_cache(spec, "cuda", dtype)
            cc = llama.init_cache(spec, "cpu", dtype)
            for k in _all_kernels():
                k.launches = 0
            run_chunked_prefill(
                lambda part, start: gpu(cg, part, start, logits=False,
                                        route=route),
                tokens, 0, chunk, spec.seq_len)
            counts = {k.symbol: k.launches for k in _all_kernels()
                      if k.launches}
            _expect(f"small prefill {label}", counts, want)
            run_chunked_prefill(
                lambda part, start: cpu(cc, part, start, logits=False,
                                        route=route),
                tokens, 0, chunk, spec.seq_len)
            a = gpu(cg, 7, 40).cpu()
            b = cpu(cc, 7, 40)
            ref_k = cc.k[:, :40].float()
            cache_err = (cg.k[:, :40].cpu().float() - ref_k).abs().max() \
                .item()
            cache_tol = rtol * ref_k.abs().max().item()
            err = (a - b).abs().max().item()
            tol = rtol * b.abs().max().item()
            log(f"small model prefill {label}, card vs CPU: cache "
                f"max_abs_err {cache_err:.3e} (tol {cache_tol:.3e}), next "
                f"logits {err:.3e} (tol {tol:.3e})")
            if not (cache_err <= cache_tol and err <= tol):
                raise AssertionError(f"small prefill {label}: cache "
                                     f"{cache_err} / logits {err}")
            worst = max(worst, err)
    return worst


# --------------------------------------------------------------------------

def _bound_by(rows) -> str:
    """The kind of bound that holds most of the rows' per-token bound."""
    weight = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        weight[r["bound_by"]] += r["bound_ms"] * r["per_token"]
    return max(weight, key=weight.get)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (ROOT / "distributed_llama_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no distributed_llama_tpu_torch "
              f"checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    smi, name, peaks, build_s = phase_card(torch)
    timer = Timer(torch)
    k1 = phase_k1(torch, timer, peaks)
    k2 = phase_k2(torch, timer, peaks)
    k2_kvbf16 = phase_k2(torch, timer, peaks, cache=torch.bfloat16)
    k1m = phase_k1m(torch, timer, peaks)
    k3 = phase_k3(torch, timer, peaks)
    k3b = phase_k3b(torch, timer, peaks)
    k4 = phase_k4(torch, timer, peaks)
    k4_kvbf16 = phase_k4(torch, timer, peaks, cache=torch.bfloat16)
    k4b = phase_k4(torch, timer, peaks, bf16=True)
    k4b_kvbf16 = phase_k4(torch, timer, peaks, bf16=True,
                          cache=torch.bfloat16)
    k1d = phase_k1d(torch, timer, peaks)
    k5 = phase_k5(torch, timer, peaks)
    k5_kvbf16 = phase_k5(torch, timer, peaks, cache=torch.bfloat16)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    spec, model, tok = smoke_files()
    e2e, out_a = phase_e2e(torch, model, tok)
    e2e_prefill = phase_e2e_prefill(torch, model, tok, spec.n_layers)
    e2e_q80 = phase_e2e_q80(torch, model, tok, spec.n_layers)
    e2e_bf16 = phase_e2e_bf16(torch, model, tok, spec.n_layers, e2e_prefill)
    e2e_batch = phase_e2e_batch(torch, model, tok, spec.n_layers, "batch")
    e2e_batch_dq = phase_e2e_batch(
        torch, model, tok, spec.n_layers, "batch dequant bf16-cache",
        {"DLLAMA_MULTI_T_BODY": "dequant"}, ("--kv-cache-dtype", "bf16"))
    saved = e2e_batch["peak_device_gb"] - e2e_batch_dq["peak_device_gb"]
    same_rows = sum(a == b for a, b in zip(e2e_batch.pop("rows"),
                                           e2e_batch_dq.pop("rows")))
    log(f"batch peak device memory: {e2e_batch['peak_device_gb']:.3f} GB "
        f"(f32 cache), {e2e_batch_dq['peak_device_gb']:.3f} GB (bf16): "
        f"{saved:.3f} GB less; {same_rows} of {BATCH} rows equal under the "
        f"dequant body")
    if not 8.0 <= saved <= 9.2:
        raise AssertionError(f"the bf16 batch cache saved {saved:.3f} GB, "
                             f"not ~8.6")
    e2e_fast = phase_e2e_fast(torch, model, tok, spec.n_layers,
                              _pieces(out_a), e2e_prefill.pop("pieces"))
    gc.collect()
    torch.cuda.empty_cache()
    logit_err, busy, prefill, fast, batch = phase_full_width(torch, model,
                                                             tok, peaks)
    small_err = phase_small_reference(torch)

    def per_token(rows):
        return {key: sum(r[key] * r["per_token"] for r in rows)
                for key in ("ms", "plain_ms", "bound_ms")}

    k1_tok = per_token(k1)
    # K2 per token: 32 layers at the deepest position of the smoke run
    k2_63 = [dict(r, per_token=32) for r in k2
             if r["case"] == "7b" and r["pos"] == 63]
    k2_tok = per_token(k2_63)
    kernels = [
        dict(name="q40_matvec", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matvec.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:696",
             launches=e2e["launches"]["q40_matvec"],
             max_abs_err=max(r["max_abs_err"] for r in k1), **k1_tok,
             bound_by=_bound_by(k1),
             library_ms=sum(r["library_ms"] * r["per_token"] for r in k1),
             unit="one 7B token: 32 x (wqkv, wo, w13, w2) + wcls; library "
                  "= cuBLAS f32 GEMV on the weight dequantized beforehand "
                  "(dequant not timed)",
             shapes=k1),
        dict(name="decode_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/decode_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:304",
             launches=e2e["launches"]["decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k2), **k2_tok,
             bound_by=_bound_by(k2_63),
             library_ms=sum(r["library_ms"] * 32 for r in k2_63),
             unit="one 7B token at pos 63: 32 layers", shapes=k2),
    ]

    def unit_row(rows):
        unit = [r for r in rows if r["per_token"]]
        return dict(per_token(unit), bound_by=_bound_by(unit),
                    library_ms=sum(r["library_ms"] * r["per_token"]
                                   for r in unit))

    k4_unit = [dict(r, per_token=32) for r in k4
               if r["case"] == "7b" and r["pos"] == 384]
    kernels += [
        dict(name="q40_matvec_multi", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matvec.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:730",
             launches=e2e_q80["launches"]["q40_matvec_multi"],
             max_abs_err=max(r["max_abs_err"] for r in k1m), **unit_row(k1m),
             unit=f"one 7B {Q80_CHUNK}-token chunk: 32 x (wqkv, wo, w13, "
                  f"w2) at T = {Q80_CHUNK}; library = cuBLAS SGEMM on the "
                  f"weight dequantized beforehand (dequant not timed)",
             shapes=k1m),
        dict(name="q40_gemm", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_gemm.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:749",
             launches=e2e_prefill["launches"]["q40_gemm"],
             max_abs_err=max(r["max_abs_err"] for r in k3), **unit_row(k3),
             unit=f"one 7B {CHUNK}-token chunk: 32 x (wqkv, wo, w13, w2) "
                  f"at T = {CHUNK}; library = cuBLAS SGEMM on the weight "
                  f"dequantized beforehand (dequant not timed)",
             shapes=k3),
        dict(name="prefill_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/prefill_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:492",
             launches=e2e_prefill["launches"]["prefill_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k4),
             **unit_row(k4_unit),
             unit=f"one 7B {CHUNK}-token chunk at pos 384: 32 layers; "
                  f"library = scaled_dot_product_attention with the causal "
                  f"offset mask over the live prefix", shapes=k4),
    ]
    runs = {"d": e2e_bf16["fast_bf16_cache"]["launches"],
            "e": e2e_bf16["fast"]["launches"],
            "f": e2e_bf16["bf16_cache"]["launches"]}

    def at_pos(rows, pos):
        return [dict(r, per_token=32) for r in rows
                if r["case"] == "7b" and r["pos"] == pos]

    def attention_row(name, source, replaces, run, rows, pos, unit):
        unit_rows = at_pos(rows, pos)
        return dict(name=name, route="cuda",
                    source=f"distributed_llama_tpu_torch/csrc/{source}",
                    replaces=f"distributed_llama_tpu/ops/{replaces}",
                    launches=runs[run][name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **unit_row(unit_rows), unit=unit, shapes=rows)

    sdpa = ("library = scaled_dot_product_attention in bf16 with the "
            "causal offset mask over the live prefix")
    kernels += [
        attention_row("decode_attention_kvbf16", "decode_attention.cu",
                      "pallas_attention.py:304", "d", k2_kvbf16, 63,
                      "one 7B token at pos 63 over a bf16 cache: 32 layers;"
                      " library = scaled_dot_product_attention in bf16"),
        dict(name="q40_gemm_bf16", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_gemm_bf16.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:749",
             launches=runs["d"]["q40_gemm_bf16"],
             max_abs_err=max(r["max_abs_err"] for r in k3b),
             **unit_row(k3b),
             unit=f"one 7B {CHUNK}-token chunk: 32 x (wqkv, wo, w13, w2) "
                  f"at T = {CHUNK}; library = "
                  f"{k3b[0]['library']} (cuBLAS) on the weight dequantized "
                  f"to bf16 beforehand (dequant not timed)", shapes=k3b),
        attention_row("prefill_attention_kvbf16", "prefill_attention.cu",
                      "pallas_attention.py:492", "f", k4_kvbf16, 384,
                      f"one 7B {CHUNK}-token chunk at pos 384 over a bf16 "
                      f"cache, f32 dots: 32 layers; {sdpa}"),
        attention_row("prefill_attention_bf16", "prefill_attention_bf16.cu",
                      "pallas_attention.py:492", "e", k4b, 384,
                      f"one 7B {CHUNK}-token chunk at pos 384, bf16 dots, "
                      f"f32 cache: 32 layers; {sdpa}"),
        attention_row("prefill_attention_bf16_kvbf16",
                      "prefill_attention_bf16.cu", "pallas_attention.py:492",
                      "d", k4b_kvbf16, 384,
                      f"one 7B {CHUNK}-token chunk at pos 384, bf16 dots, "
                      f"bf16 cache: 32 layers; {sdpa}"),
    ]
    k5_unit = [dict(r, per_token=32) for r in k5
               if r["case"] == "7b" and r["batch"] == BATCH
               and r["pos"] == "shared 63"]
    k5b_unit = [dict(r, per_token=32) for r in k5_kvbf16
                if r["case"] == "7b" and r["batch"] == BATCH
                and r["pos"] == "shared 63"]
    batch_sdpa = ("library = scaled_dot_product_attention over the padded "
                  "prefix with a per-row mask")
    kernels += [
        dict(name="decode_attention_batch", route="cuda",
             source="distributed_llama_tpu_torch/csrc/decode_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:175",
             launches=e2e_batch["launches"]["decode_attention_batch"],
             max_abs_err=max(r["max_abs_err"] for r in k5),
             **unit_row(k5_unit),
             unit=f"one 7B step of {BATCH} rows at shared pos 63: 32 "
                  f"layers; {batch_sdpa}", shapes=k5),
        dict(name="decode_attention_batch_kvbf16", route="cuda",
             source="distributed_llama_tpu_torch/csrc/decode_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:175",
             launches=e2e_batch_dq["launches"][
                 "decode_attention_batch_kvbf16"],
             max_abs_err=max(r["max_abs_err"] for r in k5_kvbf16),
             **unit_row(k5b_unit),
             unit=f"one 7B step of {BATCH} rows at shared pos 63 over a "
                  f"bf16 cache: 32 layers; {batch_sdpa} (bf16)",
             shapes=k5_kvbf16),
        dict(name="q40_matvec_bf16", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matvec_bf16.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:713",
             launches=e2e_batch_dq["launches"]["q40_matvec_bf16"],
             max_abs_err=max(r["max_abs_err"] for r in k1d),
             **unit_row(k1d),
             unit=f"one 7B {BATCH}-row step: 32 x (wqkv, wo, w13, w2) at "
                  f"T = {BATCH}; library = {k1d[0]['library']} (cuBLAS) on "
                  f"the weight dequantized to bf16 beforehand (dequant not "
                  f"timed)", shapes=k1d),
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    log(f"full-width logits max_abs_err {logit_err:.3e}; small-model "
        f"max_abs_err {small_err:.3e}; build {build_s:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels, "e2e": e2e, "step_profile": busy,
                      "e2e_prefill": e2e_prefill, "e2e_q80": e2e_q80,
                      "e2e_bf16": e2e_bf16, "e2e_batch": e2e_batch,
                      "e2e_batch_dequant": e2e_batch_dq,
                      "e2e_fast": e2e_fast, "prefill": prefill,
                      "fast": fast, "batch_step": batch,
                      "batch_cache_saved_gb": saved, "build_s": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
