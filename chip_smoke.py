#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (distributed_llama_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. Card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   build of every kernel from ``distributed_llama_tpu_torch/csrc`` (one
   nvcc per source, all started together), with the build seconds; then
   ``cuobjdump -sass`` of the built K1/K1m, K3, K3b, K4 and K4b libraries
   (the toolkit's or Triton's; none found fails the phase): every K1 and
   K1m function (one per T) must hold a bf16 tensor-core MMA (HMMA or
   HGMMA), every K3 GEMM function a tf32 HGMMA (wgmma) and UTMALDG (TMA),
   every K3b GEMM function HGMMA and UTMALDG or UBLKCP (bulk copy), every
   K4 function a tf32 HMMA (mma.sync) and UTMALDG, every K4b function the
   async copy, K8 and K9 their rings' per-thread async copy (LDGSTS),
   the probe's P2 and P4 (K1's skeleton) a bf16 MMA and the async copy,
   P2 no 16-byte shared store or load of x but 16-byte global loads, and
   the unpack's and x's instructions of K1, P2 and P4 counted;
   ``cuobjdump -res-usage``: no K1, K1m, K3, K4, K9, P2 or P4 function
   spills (stack or local memory), registers logged.
2. Kernels against their plain versions on the card at the Llama-2-7B
   shapes: the Q40 matvec (K1, tensor-core products) on
   wqkv/wo/w13/w2/wcls and 13B's and 70B's w2, the decode
   attention (K2, its keys split across the grid) at kv_mul 1 (7B) and 8
   (70B-style GQA) over positions 0..2047 on an f32 and a bf16 cache, with
   the same bits from two launches and an empty kernel's time beside it,
   the small-T Q40 matvec (K1m, K1's
   skeleton) at T = 2..8 on the same shapes and at 13B's and 70B's w2 at
   T = 2 and 8 (K1 and K1m each with its plan, the same bits from two
   launches, the bytes bound and the tensor-core and SIMT bounds beside
   it), the 3xTF32 Q40 GEMM (K3, with its x split pass and
   K3b's split-K sum) at T = 9, 16, 32, 100, 128 on wqkv/wo/w13/w2 (and
   wcls at T = 16, 13B's and 70B's w2 at T = 512), its bf16 tensor-core
   twin (K3b, with its x rounding pass and split-K sum) at T = 9, 16,
   100, 128, 512, each with its plan and the
   same bits from two launches, the prefill attention at T = 128 and pos
   0, 384, 1920 and at T = 37, pos 1920 for 7B and the GQA shape, with
   3xTF32 dots (K4) and bf16 dots (K4b), each over an f32 and a bf16
   cache, with its split plan, its split combine, the same bits from two
   launches and a poisoned cache suffix past pos+T that must not change
   its output; the small-T bf16-product Q40 body
   (K1d) at T = 2..8 on the four layer matrices and at T = 2, 8 on 13B's
   and 70B's w2, with its plan and the same bits from two launches, and its
   bf16-rounded weights read back bit for bit through one-hot x over every
   finite f16 scale (q40.sweep_q40), and the batched decode attention (K5) at
   7B and GQA shapes for B = 1 and 8 at a shared pos 63 and 2047 and at
   ragged positions, over an f32 and a bf16 cache (at B = 1 bit for bit
   K2; the same bits from two launches; graph replays at clocks that cross
   its key splits give the eager bits and leave every ticket at 0); the
   paged decode attention over f32 and bf16 pages (K6 at t_len 1, K6w at
   windows) and Q8 pages (K7, K7w) at the same shapes with pages of 16 in
   a permuted pool, t_len 1, 4, 8, 16 and 39 (the decode step, verify
   windows and mixed windows; at t_len 1 K6 gives the bits of K5 under the
   same plan over the same values, and K7 and K7w give K6's and K6w's bits
   over the dequantized pool; each window timed beside its bound, SDPA,
   the gather and the split walk windows took before; graph replays
   across split counts at t_len 1 and 39); the fused decode layer's
   head (K8), tail (K9) and whole layer (K10, over an f32 and a bf16 cache,
   part by part) at the 7B and GQA shapes at pos 0, 63 and 2047, timed
   beside the unfused port path for the same work, K8's and K9's rows with
   P0's bits (K8's on the vector it staged, read back through one-hot
   rows), K8's q, k and v with K10's bits, both the same bits twice; the Q40 layout probe's
   kernels (B10: P1 probe_stream, P2 probe_xglobal, P3 probe_nomask, P4
   probe_signed, and P0 probe_classic, the classic T = 1 row body that
   the fused tail gives the bits of) and K1 at the 13B w13 and wqkv
   shapes, P2 and P4 (K1's skeleton: x pre-laid, signed codes) with K1's
   bits, then the probe's own traced chain at w13 (tools/nb_probe.py,
   every variant, K1 its own row, 4 layers x 4
   reps, exactly 16 trace events of each variant's kernel, the trace time
   beside the chain's CUDA-event time). Max error against the
   stated tolerance; kernel, plain and library
   times (CUDA events, median of 25 launches, L2 flushed before each); the
   bound (bf16 rate for K3b, K4b and K1d; TF32 rate times the passes for
   K3 and K4, the f32 SIMT bound beside it) and what bounds it. The library
   call computes the kernel's own function: SDPA in f32 for K2 and K4
   over a bf16 cache (on the prefix cast to f32 beforehand), with SDPA in
   bf16 beside it as ``library_bf16_ms``. Then K1 (T = 1), K1m (T = 8)
   and K3 (T = 128) at a 7B rank's band shapes for tp 2 and 4 (the fused
   scheme's wqkv, w13 and wcls row bands and wo and w2 block bands, the
   ref scheme's wo and w2 row bands for K1), the same checks and times.
3. End to end: a 7B-shaped Q40 model with random codes (seeded) and a
   32000-piece tokenizer are written to build/smoke/ (by a process started
   with phase 1, while the card runs phases 1 and 2), then the port's CLI
   runs ``inference`` in-process twenty times (runs e and f call the
   CLI's ``generate`` in phase 4), every kernel's launch count reset just
   before and read just after each run:
   a. 64 steps token by token, greedy: K1 4*L+1 = 129 and K2 L = 32
      launches per step;
   b. a 512-token prompt (BOS + 511 " hi") with ``--prefill-chunk 128
      --steps 576``: 4 chunks of T = 128 (K3 4*L*4 = 512, K4 L*4 = 128,
      K1m 0, with their parts: 512 x split passes, a split-K sum per
      layer matrix gemm_tf32_plan splits, a combine per chunk and layer
      prefill_plan splits), then 65 decode steps from pos 511 (K1 129*65,
      K2 32*65);
   c. ``--buffer-float-type q80 --prefill-chunk 8``, 64 steps over the
      20-token prompt: 3 chunks of T = 8 (K1m 4*L*3 = 384, K4 L*3 = 96,
      with its combines by plan), then 45 decode steps; every step's
      logits must be finite;
   d. run b with ``--fast-prefill --kv-cache-dtype bf16``: K3b 512 and K4b
      (bf16-cache build) 128 in the prefill, with their parts (512 x
      rounding passes, a split-K sum per layer matrix its plan splits, a
      combine per split chunk and layer), K3 and K4 0, then K1 and the
      bf16-cache K2 per decode step; its peak device memory must lie ~1.07
      GB (the halved cache) below run b's;
   e. and f. run b's prompt and chunk with --fast-prefill's setting alone
      (K3b, K4b over an f32 cache) and with a bf16 cache alone (K3, the
      bf16-cache K4 and K2), 9 decode steps each: ``generate`` on phase
      4's weights, with no model load of their own;
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
      run b's;
   k. ``--prompts-file --continuous --slots 8 --kv-page-size 16
      --prefill-chunk 32 --steps 128`` with 12 prompts sharing a 64-token
      prefix: every device step a graph replay of K6 32 and K1m 129
      launches, K3 and K4 per admission chunk, K5 0; prefix hits > 0 and a
      clean page audit;
   l. run k without the page flags (contiguous, K5): its 12 streams equal
      run k's;
   m. run k with ``--kv-cache-dtype bf16 --block-steps 16``: the bf16-page
      K6 through 16-step chains;
   n. run k with ``--kv-quant q8 --block-steps 16 --temperature 0.8 --seed
      7 --kv-pages 32``: K7, an oversubscribed pool that pauses or requeues
      rows and fails none, ~3.76x fewer bytes per page than run k;
   o. run a under ``DLLAMA_LAYER_FUSION=headtail``: per step 32 K8, 32 K2,
      32 K9 and one K1 (wcls), nothing else;
   p. run i (``--fast``) under ``DLLAMA_LAYER_FUSION=on``: per device step
      32 K10 and one K1, no K2 or K5. The greedy streams of o and p equal
      run a's, or part from it only at a step where run a's two largest
      logits lie within the logit tolerance of each other;
   q. run i with ``--profile DIR``: its stream equals run a's, the 🔶 I/T
      line is printed, and its torch.profiler trace holds exactly the run's
      K1 and K5 launches as kernel events (the kernels the CUDA graph
      replays);
   r. run a's prompt for 32 steps with ``--save-state``, then 32 more with
      ``--resume-state``: K1 and K2 per step in each, and the joined stream
      equals run a's;
   s. run k with ``--spec-k 4``: every device step a captured verify
      dispatch of 8 x 4 flat rows (K3 4L+1 with its parts, K6w L at t_len
      4), admission prefill as run k's; drafts accepted; its streams equal
      run k's, or part only where run k's top-2 logits lie within the
      logit tolerance (K3 against K1m);
   t. run k with ``--dispatch-tokens 39`` (the auto budget at 8 slots and
      chunk 32): every device step one (8, 39) mixed window (K3 on 312
      rows, K6w L at t_len 39), no admission prefill; streams as run s's;
   u. run n with ``--spec-k 4`` instead of its chains and ``--topp
      0.05``: K7w over verify windows, seeded rejection sampling, the
      32-page pool pausing or requeueing, drafts accepted; every window's
      logits finite;
   v. run m with ``--spec-k 4`` instead of its chains: K6w over bf16
      pages, drafts accepted.
   serve_full_width, after run u: ``python -m distributed_llama_tpu_torch
   serve`` on the 7B file at full width and depth as a child process, run
   k's engine flags (8 slots, pages of 16, chunk 32, 128 positions,
   greedy) and --port 0 --journal --flightrec --watchdog-ms 60000: its
   engine's graphs captured on its scheduler thread before the listener
   opens; run k's 12 prompts from concurrent clients, every other one
   streamed (NDJSON), each response equal to run k's stream for that
   prompt or parting only at a near-tie of run k's top-2 logits; /health
   serving, schema 3, with its paged_kv, slo, watch and sched blocks;
   /metrics with the request-lifecycle families and a TTFT count of 12;
   /debug/timeline a valid Chrome trace; then POST /profile over a burst
   of 8 requests, whose torch.profiler trace (utils/it_split) must hold K6,
   K1m and K3 events (each kernel's events go into its ``kernels`` row as
   the ``serve`` part); then 6 long streamed requests and SIGTERM while
   they are in flight: exit 0, every one of them live in the journal, the
   drain's flight-recorder bundle valid; restarted on that journal the
   server says "recovered 6" and finishes them, their replayed tokens
   through K3/K4 admission prefill, and each journaled stream equals an
   uninterrupted in-process run of the same requests or parts only at a
   near-tie of its top-2 logits. Served decode tokens/s against run k's,
   TTFT p50 and p95, ms a dispatch on the scheduler's clock, SIGTERM to
   exit, restart to the first recovered token and device memory in use
   are logged with the card's name and power limit.
   tier_full_width, after serve_full_width: run k's flags and two waves of
   its 12 prompts (24 requests) over a 40-page pool, so the first wave's
   cold prompt pages demote and the second wave re-hits them; with
   ``--kv-host-pages 24`` and with ``--kv-host-pages 2 --kv-disk-dir D``
   (pages reach disk), each over f32 and Q8 pages: the f32 streams equal
   run k's (a near-tie parting allowed), both waves of each Q8 run those
   of one untiered greedy Q8 run with run k's flags; demotions and promotions by tier above 0, the three-tier audit
   clean, the prefill tokens saved by tier; ms a promoted page on the copy
   stream's events, the admission pause, pinned bytes and device memory
   logged. disagg_full_width: two ``serve`` children share the card, one
   ``--disagg-role prefill`` (its page channel on localhost), one
   ``--disagg-role decode --disagg-peer`` it; run k's 12 prompts to the
   decode server give run k's streams, 12 handoffs shipped, pages and
   bytes equal to comm_stats.dcn_handoff_budget; the page channel's GB/s
   over localhost and the client TTFT p50/p95 beside serve_full_width's
   logged; then the prefill child is killed and the same prompts are
   served locally with the same streams. chaos_full_width: ``serve --chaos
   step_delay_every=8,step_delay_ms=50,deny_pages=4`` as a child with run
   k's flags (the CHAOS ARMED banner on stderr, run k's streams or a
   near-tie parting, /health serving, /metrics parsing, TTFT and ms a
   dispatch beside serve_full_width's); the twelve drills of
   runtime/chaos.py through run_drills, every one green, the factory's
   engines at 7B width cut to 4 layers and 128 positions (run k's slots,
   pages and chunk), the process drills at their fixed small specs, all
   on the card, their kernel launches counted; the four mutation arms
   (leak-on-cancel, drop-on-demote, drop-page-in-flight,
   corrupt-journal), each turning its drill red; and the port's
   ``loadcheck --sweep-only --json`` on the card beside the CPU's row.
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
   (llama.FAST_RTOL). Then --fast against the host loop under each
   DLLAMA_LAYER_FUSION mode (off, headtail, on): 64 greedy steps of each
   on one set of weights, in turns, and each captured step under
   torch.profiler (ms/token, device busy share, launches per replay);
   and the captured 8-row batch step's logits held against the plain
   route of forward_batch (K1m over an f32 cache within LOGIT_RTOL; K1d
   over a bf16 cache within FAST_RTOL), and its time with nothing but
   replays; then a 1 s obs/profiler.start_capture, on its own thread,
   while the main thread runs 4 --fast steps: the kernel events its trace
   holds (a reading, not an assertion). The random codes
   make that model's logits nearly position-independent, so a small model
   with quantized-Gaussian weights also runs through the kernels on the
   card (8 decode steps; prefill at chunk 4 through K1m, chunk 16 through
   K3 and chunk 16 on the fast route over both caches; generate_batch of 3
   prompts and generate_fast, both captured; generate and generate_fast
   under both fusion modes) and is held against the plain path on the
   CPU. Then continuous batching at full width: 16 requests through 8
   slots on a contiguous cache and on f32, bf16 and Q8 pages, in turns
   (tokens/s, ms per device step, avg_active, device busy share, cache
   bytes), the f32-page streams equal to the contiguous ones. A small
   F16-weight model (``--weights-float-type f16``, the dense f32 product)
   on the card against the CPU: logits within LOGIT_RTOL x max at 8
   positions, and the CLI's greedy stream, card and CPU, equal.
5. tp_full_width, after runs k-n: the smoke model at full width, all 32
   layers, through the CLI's inference entry with the ranks of a gloo
   group this script builds sharing the card (NCCL refuses two ranks on
   one device): 36 steps over run a's prompt (19 positions prefilled at
   chunk 16: K3 and K4 over the bands; then K1 and K2) under fused at tp 2
   and 4 and under ref at tp 2, and with q80 buffers at tp 2 (chunk 8:
   K1m); each stream equals run a's (run c's for q80), or parts only at a
   near-tie of its top-2 logits; each run's ms per token and its counted
   collectives a token against the budget are logged beside the card's
   name and power limit. Before the ranks start, weight_stream serves the
   smoke file over localhost (io/stream.WeightServer) and fetches rank 1
   of tp 2's byte ranges under fused into a sparse file
   (fetch_model_slices: bytes, ranges, seconds and GB/s logged), from
   which rank 1 of "t2 fused" loads; fetch_model's whole-file path is
   held byte for byte on a small model. "t2 fused" saves its generation
   (the ranks' kv heads gathered to rank 0), resumed at tp 1 through the
   CLI to run a's stream. At tp 2 the lockstep batch (4 rows, K1m and K5)
   and the continuous engine over f32 pages (K6, admission prefill
   through K3 and K4) run eagerly at 2 layers of 7B width and equal one
   device's; so do, through the CLI against tp 1 at the same flags, a
   bf16 cache, --fast-prefill (K3b and K4b over the bands),
   DLLAMA_MULTI_T_BODY=dequant over a bf16 cache (K1d, K5), bf16 pages
   with --fast-prefill and Q8 pages (K6, K7), and --spec-k 4 and
   --dispatch-tokens 39 over f32 pages under fused and ref, each verify
   and mixed window's collectives equal to the budget at t_len = its rows
   (TP_FLAG_RUNS), and a
   --profile run whose every rank's trace holds
   its collectives (T > 0) one event each, as many as the census. What
   waits for a machine with more than one card is logged
   (TP_WAITS); where two GPUs are visible, ``inference --tp 2`` runs over
   NCCL, token by token under fused and overlap (with four GPUs also tp 4
   under fused, overlap and ref with q80 buffers), and the lockstep batch
   at tp 2 against tp 1 (tp_nccl).
6. obs_full_width, after train_full_width: (a) parallel/shard_sim at
   full width, one Llama-2-70B tp 8 rank under the ref scheme (80 layers
   of Q40 bands, ~4.8 GB, made on the card from a seed; the f32
   embedding; a seq-4096 cache shard) takes 64 decode steps through the
   host loop with the counts set to 0 just before and read just after
   (K1 321 and K2 80 a token) and the census equal to
   tp_collective_budget(70b, 8) a token; K1 and K2 against plain at the
   rank's shapes; its ms a token, and project_full_system's sum printed
   as a projection beside its constants; (b) tools/tracecheck on the tp 2
   --profile trace of tp_full_width (counts exact, coverage >=
   COVERAGE_MIN, the time check SKIPped on gloo) and bench_drift_fields
   on run q's trace (OK: no collective time on one card); (c) the
   device-layout sidecar (io/kernel_cache.py) of the 7B file, a cold
   load writing it and a warm one hitting it, each timed, and run a from
   the warm load giving run a's stream; the sidecar is removed; (d)
   costcheck, watchcheck and racecheck with --device cuda, their rows
   equal to the CPU's and each inject arm exiting 1.
7. The phase times, the ``kernels`` JSON line (each kernel's launches
   summed over every CLI run, a-v, and its POST /profile trace events in
   serve_full_width as ``serve``; the probe's kernels over its chain;
   K6w's and K7w's rows at t_len 16 and 39 beside K6's and K7's decode
   rows, each with a layer at pos 2047; K1's
   and K2's the simulated 70B rank's launches and times as ``sim``),
   then the result line ``{"ok": true, "device": {...}}`` as the last
   line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import collections
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

# peak rates (bytes/s, f32 FLOP/s outside the tensor cores, dense bf16 and
# TF32 tensor-core FLOP/s) for the bound: the H100 SXM data-sheet numbers;
# a PCIe part reads ~2.0 TB/s, 51 TFLOP/s f32, 756 TFLOP/s bf16, 378
# TFLOP/s TF32
PEAKS = {"sxm": (3.35e12, 67e12, 989e12, 494.7e12),
         "pcie": (2.0e12, 51e12, 756e12, 378e12)}

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
PAGE = 16            # runs k-n: the KV page size
CONT_SLOTS = 8       # runs k-n: continuous-batching slots
CONT_CHUNK = 32      # runs k-n: the admission-prefill chunk
CONT_STEPS = 128     # runs k-n: positions per request
# runs k-n: 12 prompts sharing a 64-token prefix (BOS + 63 " hi" pieces),
# then " " and 3..39 copies of one letter (byte pieces), 4..40 tokens of
# their own; the throughput phase cycles them to 16 requests
_LETTERS = "abcdefgjklmnopqrstuvwxyz"
CONT_PROMPTS = [" ".join(["hi"] * 63) + " " + _LETTERS[j] * (n - 1)
                for j, n in enumerate((4, 7, 10, 14, 17, 20, 24, 27, 30,
                                       34, 37, 40))]


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


def bound(nbytes: float, flops: float, peaks, bf16: bool = False,
          tf32: bool = False) -> tuple[float, str]:
    """(least ms, 'bytes' | 'operations') on this card; ``bf16`` or
    ``tf32`` counts the flops at that tensor-core rate instead of the f32
    one (the 3xTF32 kernels pass the flops of all their passes)."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[3 if tf32 else 2 if bf16 else 1] * 1e3
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
        f"{peaks[2] / 1e12:.0f} TFLOP/s bf16, {peaks[3] / 1e12:.1f} TFLOP/s "
        f"TF32")

    from distributed_llama_tpu_torch.ops._build import build

    kernels = _all_kernels()
    secs = build(kernels)
    log(f"built {sorted({k.source for k in kernels})} "
        f"({[k.symbol for k in kernels]}) in {secs:.1f} s")
    return smi, name, peaks, secs


def _disassembler() -> str:
    """cuobjdump from the CUDA toolkit ($CUDA_HOME/bin, PATH,
    /usr/local/cuda/bin) or from Triton's package; raises if none is
    found."""
    import importlib.util
    import shutil

    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                  "cuobjdump"))
    cands += [shutil.which("cuobjdump") or "", "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(f"no cuobjdump found (looked at {cands}): the SASS "
                       f"check of K1, K1m, K3, K3b, K4 and K4b cannot run")


# SASS instructions by the name the check reports: the warpgroup MMA, its
# tf32 form, the warp-level tf32 MMA, the TMA and bulk copies
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "HGMMA.TF32": r"\bHGMMA\.[\w.]*TF32\b",
            "HMMA.TF32": r"\bHMMA\.[\w.]*TF32\b",
            "HMMA.BF16": r"\bHMMA\.[\w.]*BF16\b",
            "HGMMA.BF16": r"\bHGMMA\.[\w.]*BF16\b", "UTMALDG": r"\bUTMALDG\b",
            "UBLKCP": r"\bUBLKCP\b", "LDGSTS": r"\bLDGSTS\b"}
# (kernel, function name part, instruction groups: each group needs one of
# its instructions in every function of that name)
SASS_CHECKS = [
    ("q40_matvec", "q40_matvec_kernel", [("HMMA.BF16", "HGMMA.BF16")]),
    ("q40_matvec_multi", "q40_matvec_multi_kernel",
     [("HMMA.BF16", "HGMMA.BF16")]),
    ("q40_gemm", "q40_gemm_kernel", [("HGMMA.TF32",), ("UTMALDG",)]),
    ("q40_gemm_bf16", "q40_gemm_bf16_kernel",
     [("HGMMA",), ("UTMALDG", "UBLKCP")]),
    ("prefill_attention", "prefill_attention_kernel",
     [("HMMA.TF32",), ("UTMALDG",)]),
    ("prefill_attention_bf16", "prefill_attention_bf16_kernel",
     [("UTMALDG", "UBLKCP")]),
    ("q40_head_fused", "q40_head_kernel", [("LDGSTS",)]),
    ("q40_tail_fused", "q40_tail_kernel", [("LDGSTS",)]),
    ("probe_xglobal", "probe_xglobal_kernel",
     [("HMMA.BF16", "HGMMA.BF16"), ("LDGSTS", "UBLKCP", "UTMALDG")]),
    ("probe_signed", "probe_signed_kernel",
     [("HMMA.BF16", "HGMMA.BF16"), ("LDGSTS", "UBLKCP", "UTMALDG")]),
]
# K1, K1m, K3, K4, K9 and the probe's P2 and P4 (K8's stack is RoPE's
# precise sinf / cosf, whose slow path keeps its reduction in local memory)
SPILL_FREE = ("q40_matvec", "q40_matvec_multi", "q40_gemm",
              "prefill_attention", "q40_tail_fused", "probe_xglobal",
              "probe_signed")
# What K1 and the probe's P2 and P4, built on its skeleton, differ in: the
# instructions of the code unpack (mask and XOR, shift, byte permute, the
# bf16x2 subtraction) and of x's 16-byte shared-memory staging and reads
# against P2's 16-byte global loads, counted in each function's SASS
SASS_CENSUS = {"LOP3": r"\bLOP3\b", "SHF": r"\bSHF\b", "PRMT": r"\bPRMT\b",
               "HFMA2.BF16": r"\bHFMA2\.BF16", "STS.128": r"\bSTS\.128\b",
               "LDS.128": r"\bLDS(\.U)?\.128\b",
               "LDG.128": r"\bLDG\.E[\w.]*\.128\b"}
SASS_CENSUS_OF = ("q40_matvec", "probe_xglobal", "probe_signed")


def phase_sass():
    """What the redesigned kernels compile to: ``cuobjdump -sass`` of the
    built K1/K1m, K3, K3b, K4, K4b and K8-K9 libraries. Every K1 and K1m
    function (one per T) must hold a bf16 tensor-core MMA (HMMA or HGMMA),
    every K3 GEMM function (one per
    token tile and warpgroup count) must hold a tf32 warpgroup MMA
    (HGMMA...TF32) and a TMA copy (UTMALDG), every K3b GEMM function a
    warpgroup MMA and a TMA or bulk copy (UBLKCP), every K4 function (one
    per cache type and kv_mul) a tf32 warp MMA (HMMA...TF32) and a TMA
    copy, every K4b function the async copy, K8 and K9 the per-thread
    async copy of their rings (LDGSTS), the probe's P2 and P4 (K1's
    skeleton) a bf16 MMA and the async copy. ``cuobjdump -res-usage`` gives
    each function's registers (at launch) and its stack and local memory:
    K1's, K1m's, K3's, K4's, K9's, P2's and P4's functions must spill
    nothing. K1's, P2's and P4's instructions of SASS_CENSUS are counted
    ("census"); P2's must hold no 16-byte shared store or load (it stages
    no x) and a 16-byte global load. Returns {kernel: {instruction: count,
    "max_regs": n, "spill_bytes": n}}."""
    from distributed_llama_tpu_torch.ops import _build

    tool = _disassembler()
    by_symbol = {k.symbol: k for k in _build.ALL}
    found = {}
    for symbol, fn, groups in SASS_CHECKS:
        sass = subprocess.run(
            [tool, "-sass", str(by_symbol[symbol].library_path())],
            capture_output=True, text=True, timeout=120, check=True).stdout
        funcs = [sec for sec in sass.split("Function : ")[1:]
                 if fn in sec.split("\n", 1)[0]]
        if not funcs:
            raise AssertionError(f"SASS of {symbol}: no function {fn}")
        counts = {}
        for sec in funcs:
            name = sec.split("\n", 1)[0].strip()
            for group in groups:
                hits = {m: len(re.findall(SASS_OPS[m], sec)) for m in group}
                if not any(hits.values()):
                    raise AssertionError(f"SASS of {name}: none of {group}")
                for m, n in hits.items():
                    counts[m] = counts.get(m, 0) + n
        usage = subprocess.run(
            [tool, "-res-usage", str(by_symbol[symbol].library_path())],
            capture_output=True, text=True, timeout=120, check=True).stdout
        res = [tuple(map(int, m.groups()[1:])) for m in re.finditer(
            r"Function (\S+):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ "
            r"LOCAL:(\d+)", usage) if fn in m.group(1)]
        if len(res) != len(funcs):
            raise AssertionError(f"-res-usage of {symbol}: {len(res)} of "
                                 f"{len(funcs)} functions {fn}")
        counts["max_regs"] = max(r for r, _, _ in res)
        counts["spill_bytes"] = sum(st + lo for _, st, lo in res)
        log(f"SASS of {symbol} ({len(funcs)} functions {fn}*, {tool}): "
            + ", ".join(f"{m} x{n}" for m, n in counts.items()))
        if symbol in SPILL_FREE and counts["spill_bytes"]:
            raise AssertionError(f"{symbol}: {counts['spill_bytes']} bytes "
                                 f"of stack or local memory (a spill)")
        if symbol in SASS_CENSUS_OF:
            counts["census"] = {m: sum(len(re.findall(rx, sec))
                                       for sec in funcs)
                                for m, rx in SASS_CENSUS.items()}
            log(f"SASS census of {fn}: " + ", ".join(
                f"{m} x{n}" for m, n in counts["census"].items()))
        found[symbol] = counts
    # P2 stages no x: no 16-byte shared stores or loads (K1's staging and
    # B reads), its B fragments come as 16-byte global loads
    p2 = found["probe_xglobal"]["census"]
    if p2["STS.128"] or p2["LDS.128"] or not p2["LDG.128"]:
        raise AssertionError(f"SASS of probe_xglobal_kernel: x through "
                             f"shared memory or no 16-byte global load: "
                             f"{p2}")
    return found


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


# 13B's and 70B's w2 (432 and 896 Q40 blocks in one sum): K1 at T = 1,
# K1m at T = 2 and 8
DEEP_W2 = [("w2-13b", 5120, 13824), ("w2-70b", 8192, 28672)]


def _matvec_rows(torch, timer, peaks, cases, seed):
    """K1 (T = 1) or K1m against the plain version, each case (name, d, n,
    t, per_unit): its plan (ops/q40.matvec_plan), its error, the same bits
    from a second launch, kernel, plain and library times, and its bounds:
    the packed weight bytes, the tensor-core work it issues (2 x 8 columns
    a column set x d x n at the bf16 rate; bound_ms is the larger), and
    the f32 SIMT bound of the same product beside them. The library
    yardstick is cuBLAS's f32 GEMV / SGEMM (torch.matmul, TF32 off) on the
    weight dequantized beforehand (the dequant is not timed)."""
    from distributed_llama_tpu_torch.ops.q40 import (KERNEL, KERNEL_MULTI,
                                                     KERNEL_RTOL,
                                                     matvec_plan, q40_matmul,
                                                     q40_matmul_plain,
                                                     random_q40, sm_count)
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    sms = sm_count(torch.device("cuda", 0))
    rows = []
    weights = {}
    for name, d, n, t, per_unit in cases:
        nb = n // 32
        if (name, d, n) not in weights:
            weights.clear()
            w = random_q40(d, n, "cuda", g)
            weights[name, d, n] = (w, dequantize_q40_torch(w.qs, w.d16))
        w, wf = weights[name, d, n]
        kernel = KERNEL if t == 1 else KERNEL_MULTI
        x = torch.randn((t, n), device="cuda", generator=g)
        before = kernel.launches
        got = q40_matmul(w, x)
        again = q40_matmul(w, x)
        torch.cuda.synchronize()
        if kernel.launches != before + 2:
            raise AssertionError(f"{kernel.symbol} {name} T={t}: not "
                                 f"launched once a call")
        if not torch.equal(got, again):
            raise AssertionError(f"{kernel.symbol} {name} T={t}: two "
                                 f"launches differ")
        want = q40_matmul_plain(w, x)
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        tol = KERNEL_RTOL * peak
        lib_err = (torch.matmul(x, wf.T) - want).abs().max().item()
        ms = timer(lambda: q40_matmul(w, x))
        plain_ms = timer(lambda: q40_matmul_plain(w, x))
        library_ms = timer(lambda: torch.matmul(x, wf.T))
        nbytes = d * nb * 18 + t * n * 4 + t * d * 4
        cols = 8 * -(-3 * t // 8)  # the (token, piece) columns issued
        bytes_ms = nbytes / peaks[0] * 1e3
        tc_ms = 2.0 * d * n * cols / peaks[2] * 1e3
        simt_ms = 2.0 * t * d * n / peaks[1] * 1e3
        b_ms, b_by = max((bytes_ms, "bytes"), (tc_ms, "operations"))
        plan = matvec_plan(t, d, nb, sms)
        log(f"{kernel.symbol} {name:6s} T={t} ({d}x{n}) plan {plan}: "
            f"max_abs_err {err:.3e} ({err / peak:.2e} of max, tol "
            f"{tol:.3e}, cuBLAS {lib_err:.1e}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms cuBLAS {library_ms:.4f} ms bound {b_ms:.4f}"
            f" ms ({b_by}; tensor cores {tc_ms:.4f}, SIMT {simt_ms:.4f}; "
            f"{b_ms / ms:.1%} of it)")
        if not err <= tol:
            raise AssertionError(f"{kernel.symbol} {name} T={t}: error "
                                 f"{err} above {tol}")
        rows.append(dict(shape=name, d=d, n=n, t=t, per_token=per_unit,
                         plan=list(plan), max_abs_err=err,
                         rel_err=err / peak, tol=tol, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes_bound_ms=bytes_ms,
                         tc_bound_ms=tc_ms, simt_bound_ms=simt_ms,
                         library_ms=library_ms))
        del x, got, again, want
    weights.clear()
    return rows


def phase_k1(torch, timer, peaks):
    """K1 at 7B's shapes (a token: 32 x each layer matrix and wcls) and at
    13B's and 70B's w2."""
    cases = [(name, d, n, 1, per_token) for name, d, n, per_token in K1_SHAPES]
    cases += [(name, d, n, 1, 0) for name, d, n in DEEP_W2]
    return _matvec_rows(torch, timer, peaks, cases, seed=0)


def phase_k2(torch, timer, peaks, cache=None, cases=K2_CASES,
             positions=K2_POS, seq=K2_SEQ):
    """K2 against plain over an f32 cache, or over a bf16 one (``cache`` =
    torch.bfloat16, the kvbf16 build), at positions up to 2047 where its
    plan splits the keys (``cases``, ``positions`` and ``seq`` name other
    shapes: obs_full_width's 70B tp 8 rank), with the same bits from a
    second launch; an empty kernel's time beside the rows. The library yardstick is SDPA in
    f32, K2's function (f32 q and dots): over a bf16 cache on q and the
    live prefix cast to f32 beforehand (the cast not timed); SDPA in bf16,
    which rounds q and so computes another function, is printed beside it
    as ``library_bf16_ms``."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops.attention import (
        KERNEL, KERNEL_ATOL, KERNEL_KVBF16, attention_scale,
        decode_attention, decode_attention_plain)

    cache = cache or torch.float32
    kernel = KERNEL if cache == torch.float32 else KERNEL_KVBF16
    size = torch.tensor([], dtype=cache).element_size()
    g = torch.Generator(device="cuda").manual_seed(1)
    # the timer's floor: one empty kernel (a spin of 0 cycles)
    empty_ms = timer(lambda: torch.cuda._sleep(0))
    log(f"an empty kernel (torch.cuda._sleep(0)): {empty_ms:.4f} ms")
    rows = []
    for label, L, n_kv, kv_mul in cases:
        shape = (L, seq, n_kv, K2_HS)
        k_all = torch.randn(shape, device="cuda", generator=g).to(cache)
        v_all = torch.randn(shape, device="cuda", generator=g).to(cache)
        n_q = n_kv * kv_mul
        q = torch.randn((n_q, K2_HS), device="cuda", generator=g)
        layer = L - 1
        scale = attention_scale(K2_HS)
        for pos in positions:
            before = kernel.launches
            got = decode_attention(q, k_all, v_all, layer, pos, kv_mul)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"not launched")
            want = decode_attention_plain(q, k_all, v_all, layer, pos, kv_mul)
            err = (got - want).abs().max().item()
            if not torch.equal(got, decode_attention(q, k_all, v_all, layer,
                                                     pos, kv_mul)):
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"other bits on a second launch")
            ms = timer(lambda: decode_attention(q, k_all, v_all, layer, pos,
                                                kv_mul))
            plain_ms = timer(lambda: decode_attention_plain(
                q, k_all, v_all, layer, pos, kv_mul))
            # yardsticks only: the port never calls SDPA
            def sdpa(dtype):
                qs = q.reshape(1, n_q, 1, K2_HS).to(dtype)
                ks = k_all[layer, :pos + 1].permute(1, 0, 2).unsqueeze(0) \
                    .to(dtype)
                vs = v_all[layer, :pos + 1].permute(1, 0, 2).unsqueeze(0) \
                    .to(dtype)
                return lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, scale=scale, enable_gqa=kv_mul > 1)

            lib = sdpa(torch.float32)
            lib_err = (lib().reshape(1, -1) - want).abs().max().item()
            library_ms = timer(lib)
            library_bf16_ms = (timer(sdpa(torch.bfloat16))
                               if cache == torch.bfloat16 else None)
            nbytes = (2 * (pos + 1) * n_kv * K2_HS * size
                      + 2 * n_q * K2_HS * 4)
            b_ms, b_by = bound(nbytes, 4.0 * (pos + 1) * n_q * K2_HS, peaks)
            log(f"{kernel.symbol} {label} pos {pos:4d}: max_abs_err "
                f"{err:.3e} (tol {KERNEL_ATOL:.0e}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms sdpa f32 {library_ms:.4f} ms (err "
                f"{lib_err:.1e}) sdpa bf16 {_f(library_bf16_ms)} bound "
                f"{b_ms:.5f} ms ({b_by})")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"error {err}")
            rows.append(dict(case=label, n_kv=n_kv, kv_mul=kv_mul, pos=pos,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms,
                             library_bf16_ms=library_bf16_ms,
                             empty_kernel_ms=empty_ms))
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
    """K3, (``bf16``) K3b or (``body="dequant"``) K1d against the plain
    version on the 7B shapes; the library yardstick is _library_gemm's (the
    bf16 one for K3b and K1d). Each prints its plan (gemm_tf32_plan,
    gemm_bf16_plan: splits, blocks or stages a split, warpgroups; K1d
    matvec_plan with one piece: wr, wk, grid_x, splits, kb) and must give
    the same bits on a second launch. K3's bound counts its three
    TF32 passes, with the f32 SIMT bound of the same product beside it
    (``simt_bound_ms``)."""
    from distributed_llama_tpu_torch.ops.q40 import (KERNEL_GEMM,
                                                     KERNEL_RTOL,
                                                     KERNEL_RTOL_BF16,
                                                     gemm_bf16_plan,
                                                     gemm_tf32_plan,
                                                     matvec_plan,
                                                     q40_matmul,
                                                     q40_matmul_plain,
                                                     random_q40)
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    tensor_cores = bf16 or body == "dequant"
    rtol = KERNEL_RTOL_BF16 if tensor_cores else KERNEL_RTOL
    tf32 = kernel is KERNEL_GEMM
    dequant = body == "dequant"
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def plan_of(t, d, nb):
        if dequant:
            return matvec_plan(t, d, nb, sms, 1)
        return (gemm_bf16_plan if bf16 else gemm_tf32_plan)(t, d, nb, sms)
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
        plan = plan_of(t, d, nb)
        if not torch.equal(q40_matmul(w, x, bf16=bf16, multi_body=body),
                           got):
            raise AssertionError(f"{kernel.symbol} {name} T={t}: two "
                                 f"launches differ")
        want = q40_matmul_plain(w, x, bf16=bf16, multi_body=body)
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        tol = rtol * peak
        wf = dequantize_q40_torch(w.qs, w.d16)
        lib, lib_name = _library_gemm(torch, x, wf, tensor_cores)
        lib_err = (lib().float() - want).abs().max().item()
        ms = timer(lambda: q40_matmul(w, x, bf16=bf16, multi_body=body))
        plain_ms = timer(lambda: q40_matmul_plain(w, x, bf16=bf16,
                                                  multi_body=body))
        library_ms = timer(lib)
        nbytes = d * nb * 18 + t * n * 4 + t * d * 4
        flops = 2.0 * t * d * n
        b_ms, b_by = bound(nbytes, 3 * flops if tf32 else flops, peaks,
                           tensor_cores, tf32)
        simt_ms = bound(nbytes, flops, peaks)[0] if tf32 else None
        plan_note = (f" plan {plan}" if dequant else
                     f" plan {plan[0]} splits x {plan[1]}, {plan[2]} WG")
        simt_note = "" if simt_ms is None else f", SIMT {simt_ms:.4f} ms"
        log(f"{kernel.symbol} {name:5s} T={t:3d} ({d}x{n}){plan_note}: "
            f"max_abs_err {err:.3e} ({err / peak:.2e} of max, tol "
            f"{tol:.3e}) kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms {lib_name} {library_ms:.4f} ms (err "
            f"{lib_err:.1e}) bound {b_ms:.4f} ms ({b_by}{simt_note})")
        if not err <= tol:
            raise AssertionError(f"{kernel.symbol} {name} T={t}: error {err}"
                                 f" above {tol}")
        rows.append(dict(shape=name, d=d, n=n, t=t, per_token=per_unit,
                         plan=list(plan),
                         splits=plan[3] if dequant else plan[0],
                         warpgroups=None if dequant else plan[2],
                         max_abs_err=err, rel_err=err / peak, tol=tol, ms=ms,
                         plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, simt_bound_ms=simt_ms,
                         bytes_bound_ms=nbytes / peaks[0] * 1e3,
                         library_ms=library_ms, library=lib_name))
        del w, x, got, want, wf, lib
    return rows


# (name, d, n) of the four layer matrices at 7B
LAYER_SHAPES = [(name, d, n) for name, d, n, _ in K1_SHAPES[:4]]


def phase_k1m(torch, timer, peaks):
    """K1m at T = 2..8 on 7B's shapes (its unit: an 8-token step, 32 x the
    four layer matrices at T = 8) and at 13B's and 70B's w2 at T = 2, 8."""
    cases = [(name, d, n, t, 32 if t == Q80_CHUNK and name != "wcls" else 0)
             for name, d, n, _ in K1_SHAPES for t in range(2, 9)]
    cases += [(name, d, n, t, 0) for name, d, n in DEEP_W2 for t in (2, 8)]
    return _matvec_rows(torch, timer, peaks, cases, seed=2)


def phase_k3(torch, timer, peaks):
    """K3 at T = 9 (a chunk's ragged tail), 16, 32 (continuous admission,
    CONT_CHUNK), 100 and 128 on the four 7B layer matrices, wcls at T = 16,
    and the deep sums of larger models: 13B's and 70B's w2 (432 and 896
    Q40 blocks) at T = 512, the latter in one split by its plan."""
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_GEMM

    cases = [(name, d, n, t, 32 if t == CHUNK else 0)
             for t in (9, 16, CONT_CHUNK, 100, CHUNK)
             for name, d, n in LAYER_SHAPES]
    cases += [("wcls", 32000, 4096, 16, 0), ("w2-13b", 5120, 13824, 512, 0),
              ("w2-70b", 8192, 28672, 512, 0)]
    return _q40_rows(torch, timer, peaks, KERNEL_GEMM, cases, seed=3)


def phase_k3b(torch, timer, peaks):
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_GEMM_BF16

    cases = [(name, d, n, t, 32 if t == CHUNK else 0)
             for t in (9, 16, 100, CHUNK, 512) for name, d, n in LAYER_SHAPES]
    return _q40_rows(torch, timer, peaks, KERNEL_GEMM_BF16, cases, seed=5,
                     bf16=True)


def phase_k1d(torch, timer, peaks):
    """K1d on the 7B layer shapes at T = 2..8 (the batched decode step of
    2..8 rows under DLLAMA_MULTI_T_BODY=dequant) and on 13B's and 70B's w2
    at T = 2 and 8 (432 and 896 Q40 blocks in one sum, split K); K1m's rows
    at the same shapes come from phase_k1m in the same call. First its
    rounding, bit for bit: one-hot x (8 tokens, each an e_j) over
    q40.sweep_q40, whose blocks hold every code and whose scales every
    finite f16 pattern, must read back dequantize_q40_torch's weights
    rounded to bf16."""
    from distributed_llama_tpu_torch.ops import q40
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    w = q40.sweep_q40("cuda")
    d, nb = w.d16.shape
    want = dequantize_q40_torch(w.qs, w.d16).to(torch.bfloat16).float()
    eye = torch.eye(nb * 32, device="cuda")
    got = torch.cat([q40.q40_matmul(w, eye[j:j + 8], multi_body="dequant")
                     for j in range(0, nb * 32, 8)]).T
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"K1d one-hot: {bad} of {want.numel()} "
                             f"weights differ from their bf16 rounding")
    log(f"K1d one-hot: {want.numel()} bf16 weights over "
        f"{d * nb} scales read back bit for bit")
    del w, want, eye, got
    cases = [(name, d, n, t, 32 if t == BATCH else 0)
             for t in range(2, 9) for name, d, n in LAYER_SHAPES]
    cases += [(name, d, n, t, 0) for name, d, n in DEEP_W2 for t in (2, 8)]
    return _q40_rows(torch, timer, peaks, q40.KERNEL_MULTI_BF16, cases,
                     seed=6, body="dequant")


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


# the replayed clocks of _k5_replays: one split, several, a shared long
# clock, then others (a B = 1 row takes the first of each)
K5_REPLAYS = ([0, 127, 2047, 5, 300, 1000, 129, 64],
              [128, 2047, 2047, 1000, 2047, 2047, 2047, 2047],
              [1000, 0, 129, 2047, 63, 900, 1500, 7],
              [2047, 256, 5, 129, 1000, 2047, 0, 300])


def _k5_replays(torch, k4, v4, q, layer, kv_mul, symbol, label):
    """K5 captured in a CUDA graph over device positions, replayed at
    clocks that cross its plan's split boundaries, and at B = 1 through
    K2 at pos 1000 and 2047 too: every replay gives the eager bits (B = 1:
    K2's), and every split ticket is back at 0 after it."""
    from distributed_llama_tpu_torch.ops import attention as att

    batch = q.shape[0]
    pv = torch.tensor(K5_REPLAYS[0][:batch], dtype=torch.int32,
                      device="cuda")
    att.decode_attention_batch(q, k4, v4, layer, pv, kv_mul)  # eager first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = att.decode_attention_batch(q, k4, v4, layer, pv, kv_mul)
    plan = att.decode_plan(k4.shape[2], batch, torch.cuda.get_device_properties(
        0).multi_processor_count)
    splits = set()
    for pos in [*K5_REPLAYS, *([[1000], [2047]] if batch == 1 else [])]:
        pv.copy_(torch.tensor(pos[:batch], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        if any(s.tickets.any() for s in att._DECODE_SCRATCH.values()):
            raise AssertionError(f"{symbol} {label}: a ticket left set "
                                 f"after a replay at {pos[:batch]}")
        eager = (att.decode_attention(q[0], k4, v4, layer, pos[0], kv_mul)
                 if batch == 1 else
                 att.decode_attention_batch(q, k4, v4, layer, pv, kv_mul))
        if not torch.equal(out, eager):
            raise AssertionError(f"{symbol} {label}: replay at "
                                 f"{pos[:batch]} not the eager bits")
        splits |= {att.decode_splits(p + 1, plan)[0] for p in pos[:batch]}
    del graph
    log(f"{symbol} {label}: {len(K5_REPLAYS) + 2 * (batch == 1)} graph "
        f"replays give the eager bits{' (K2s)' if batch == 1 else ''}, "
        f"tickets back at 0; split counts {sorted(splits)} under plan "
        f"{plan}")


def phase_k5(torch, timer, peaks, cache=None):
    """K5 against plain over an f32 cache, or a bf16 one (``cache`` =
    torch.bfloat16), at 7B and GQA shapes for B = 1 and 8, shared and
    ragged clocks, the same bits from a second launch; at B = 1 it must
    equal K2 bit for bit; then its graph replays (_k5_replays). SDPA over the
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
                if not torch.equal(got, run()):
                    raise AssertionError(f"{kernel.symbol} {label} B={batch}"
                                         f" {pos_label}: other bits on a "
                                         f"second launch")
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
            _k5_replays(torch, k4, v4, q, layer, kv_mul, kernel.symbol,
                        f"{label} B={batch}")
            del k4, v4, q
    return rows


K6_CASES = [  # (label, n_kv, kv_mul): two layers of the pool, layer 1 read
    ("7b", 32, 1), ("gqa8", 8, 8)]
# t_len 1 (decode), 4 and 8 (verify windows) and 16 and 39 (mixed windows:
# 39 = the auto budget at CONT_SLOTS slots and CONT_CHUNK, run t's)
K6_T_LENS = (1, 4, 8, 16, 39)
MIXED_BUDGET = CONT_SLOTS - 1 + CONT_CHUNK
SPEC_K = 4  # runs s and u: the verify window
# run u's nucleus: the random-code model's sampled law at temperature 0.8
# is nearly flat over the vocabulary (logits of std ~2), so at top-p 0.9
# no drafted token would be accepted; top-p 0.05 keeps its few largest
SPEC_TOPP = 0.05
K6_PAGES = ("f32", "bf16", "q8")


# K6's and K7's plans held to K5's and K6's bits: the default (decode_plan
# over B * t_len rows), one split, and the most splits at K5's least keys
K6_PLANS = (None, (1, 1), (32, 64))


def _k6_replays(torch, run_k, planes, table, P, layer, n_q, hs, kv_mul,
                batch, symbol, label, t_len=1):
    """K6 or K7 at t_len 1, or K6w or K7w at a window of ``t_len``,
    captured in a CUDA graph over device positions and replayed at
    K5_REPLAYS' clocks, which cross its plan's split counts: every replay
    gives an eager launch's bits, and every split ticket is back at 0
    after it."""
    from distributed_llama_tpu_torch.ops import attention as att
    from distributed_llama_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((batch, t_len, n_q * hs), device="cuda", generator=g)
    pv = torch.tensor(K5_REPLAYS[0][:batch], dtype=torch.int32,
                      device="cuda")
    run_k(q, *planes, layer, pv, table, P, kv_mul)  # eager first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run_k(q, *planes, layer, pv, table, P, kv_mul)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_kv, s_virt = planes[0].shape[2], table.shape[1] * planes[0].shape[1]
    if t_len == 1:
        plan = att.decode_plan(n_kv, batch, sms)
    else:
        plan = pa.window_plan(n_kv, batch, t_len, kv_mul, sms)
    splits = set()
    for pos in K5_REPLAYS:
        pv.copy_(torch.tensor(pos[:batch], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        if any(s.tickets.any() for s in att._DECODE_SCRATCH.values()):
            raise AssertionError(f"{symbol} {label}: a ticket left set "
                                 f"after a replay at {pos[:batch]}")
        if not torch.equal(out, run_k(q, *planes, layer, pv, table, P,
                                      kv_mul)):
            raise AssertionError(f"{symbol} {label}: replay at "
                                 f"{pos[:batch]} not the eager bits")
        splits |= {att.decode_splits(p + 1, plan)[0] if t_len == 1 else
                   pa.window_splits(min(p + t_len - 1, s_virt - 1) + 1,
                                    plan)[0] for p in pos[:batch]}
    del graph
    log(f"{symbol} {label} t={t_len}: {len(K5_REPLAYS)} graph replays give "
        f"the eager bits, tickets back at 0; split counts {sorted(splits)} "
        f"under plan {plan}")


def phase_k6(torch, timer, peaks):
    """K6 (f32 and bf16 pages) and K7 (Q8 pages) at t_len 1, and K6w and
    K7w at the windows of t_len 4, 8, 16 and 39 (up to the budget-edge
    clamp), against their plain versions at 7B and GQA shapes, page size
    PAGE, B = 1 and 8, shared clocks 63 and 2047 and ragged ones, the same
    bits on a second launch. The pool holds a contiguous (2B, 2048, n_kv,
    hs) batch cache's values in permuted physical pages; at t_len 1 K6
    must give the bits of K5 under the same plan (each of K6_PLANS) over
    the same values, with the identity table and with the permuted one;
    K7 and K7w must give K6's and K6w's bits over the dequantized pool (at
    the default plan and at (32, 64)); then the graph replays
    (_k6_replays) at t_len 1 and MIXED_BUDGET. Times at every shape: the
    kernel, its bound (bytes: each live key's K and V once a (row, kv
    head), q and out; operations: 4 hs a (query head, visible key), in
    TF32 passes for the windows, 3 over f32 and Q8 pages and 2 over bf16
    ones), K5 at t_len 1 on the contiguous cache (f32 for Q8 pages), at a
    window the split walk K6 and K7 took there before the window kernels
    (``walk_ms``: one block a (row, query)), the plain version (t_len 1
    and the unit windows), and the library yardstick, SDPA over the row's
    live pages gathered beforehand (the gather, with the Q8 dequantize,
    timed apart)."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import attention as att
    from distributed_llama_tpu_torch.ops import paged_attention as pa
    from distributed_llama_tpu_torch.ops.quants import (QK,
                                                        dequantize_q80_planes,
                                                        quantize_q80_torch)

    g = torch.Generator(device="cuda").manual_seed(11)
    S, hs, layer, ps = K2_SEQ, K2_HS, 1, PAGE
    mp = S // ps
    kernels = {"f32": (pa.PAGED_KERNEL, pa.WINDOW_KERNEL),
               "bf16": (pa.PAGED_KERNEL_KVBF16, pa.WINDOW_KERNEL_KVBF16),
               "q8": (pa.PAGED_KERNEL_Q8, pa.WINDOW_KERNEL_Q8)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, n_kv, kv_mul in K6_CASES:
        n_q = n_kv * kv_mul
        for batch in K5_BATCHES:
            P = batch * mp
            shape = (2 * batch, S, n_kv, hs)
            base_k = torch.randn(shape, device="cuda", generator=g)
            base_v = torch.randn(shape, device="cuda", generator=g)
            perm = torch.randperm(P, device="cuda", generator=g)
            ident = torch.arange(P, dtype=torch.int32,
                                 device="cuda").reshape(batch, mp)
            table = perm.to(torch.int32)[ident.long()].contiguous()

            def permuted(x):
                x5 = x.reshape(2, P, ps, *x.shape[2:])
                out = torch.empty_like(x5)
                out[:, perm] = x5
                return out.reshape(2 * P, ps, *x.shape[2:])

            for pages in K6_PAGES:
                dtype = torch.bfloat16 if pages == "bf16" else torch.float32
                ck, cv = base_k.to(dtype), base_v.to(dtype)
                if pages == "q8":
                    planes = []
                    for x in (ck, cv):
                        qs, d = quantize_q80_torch(
                            x.reshape(2 * batch, S, n_kv * hs))
                        planes += [permuted(qs.reshape(shape)),
                                   permuted(d)]
                    kq4, kd4, vq4, vd4 = planes
                    deq = (dequantize_q80_planes(kq4, kd4).contiguous(),
                           dequantize_q80_planes(vq4, vd4).contiguous())
                    run_k = pa.paged_decode_attention_q8
                    plain_k = pa.paged_decode_attention_q8_plain
                    bpv = 1 + 2 / QK
                else:
                    planes = [permuted(ck), permuted(cv)]
                    run_k = pa.paged_decode_attention
                    plain_k = pa.paged_decode_attention_plain
                    bpv = ck.element_size()
                for pos_label, pos in _k5_positions(batch):
                    pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    for t_len in K6_T_LENS:
                        window = t_len >= pa.WINDOW_MIN_T
                        kernel = kernels[pages][window]
                        q = torch.randn((batch, t_len, n_q * hs),
                                        device="cuda", generator=g)

                        def run():
                            return run_k(q, *planes, layer, pv, table, P,
                                         kv_mul)

                        before = kernel.launches
                        got = run()
                        torch.cuda.synchronize()
                        if kernel.launches != before + 1:
                            raise AssertionError(f"{kernel.symbol}: not "
                                                 f"launched")
                        want = plain_k(q, *planes, layer, pv, table, P,
                                       kv_mul)
                        err = (got - want).abs().max().item()
                        if not err <= att.KERNEL_ATOL:
                            raise AssertionError(
                                f"{kernel.symbol} {label} B={batch} "
                                f"{pos_label} t={t_len}: error {err}")
                        if not torch.equal(got, run()):
                            raise AssertionError(
                                f"{kernel.symbol} {label} B={batch} "
                                f"{pos_label} t={t_len}: other bits on a "
                                f"second launch")
                        k5_ms = plain_ms = walk_ms = None
                        if pages == "q8":
                            for plan in (None, (32, 64)):
                                k6 = pa.paged_decode_attention(
                                    q, *deq, layer, pv, table, P, kv_mul,
                                    plan=plan)
                                k7 = got if plan is None else run_k(
                                    q, *planes, layer, pv, table, P, kv_mul,
                                    plan=plan)
                                if not torch.equal(k6, k7):
                                    raise AssertionError(
                                        f"{kernel.symbol} {label} B={batch} "
                                        f"{pos_label} t={t_len} plan {plan}:"
                                        f" not K6's bits over the "
                                        f"dequantized pool")
                        if t_len == 1:
                            qk5 = q.reshape(batch, n_q, hs)
                            src = (base_k, base_v) if pages == "q8" \
                                else (ck, cv)
                            if pages != "q8":
                                # K6 at t_len 1 is K5's walk through the
                                # table: K5's bits under each plan, over
                                # the identity pool and the permuted one
                                flat = [x.reshape(-1, ps, n_kv, hs)
                                        for x in (ck, cv)]
                                for plan in K6_PLANS:
                                    k5 = att.decode_attention_batch(
                                        qk5, *src, layer, pv, kv_mul,
                                        plan=plan)
                                    same = run_k(q, *flat, layer, pv, ident,
                                                 P, kv_mul, plan=plan)
                                    moved = got if plan is None else run_k(
                                        q, *planes, layer, pv, table, P,
                                        kv_mul, plan=plan)
                                    if not (torch.equal(
                                            same.reshape(batch, -1), k5)
                                            and torch.equal(moved, same)):
                                        raise AssertionError(
                                            f"{kernel.symbol} {label} "
                                            f"B={batch} {pos_label} plan "
                                            f"{plan}: not the bits of K5 "
                                            f"(identity or permuted pool)")
                            k5_ms = timer(lambda: att.decode_attention_batch(
                                qk5, *src, layer, pv, kv_mul))
                        # the kernels line's rows: every t_len 1 shape,
                        # and the wide windows' unit (7B, 8 rows, pos 63)
                        unit = t_len == 1 or (
                            t_len in (16, MIXED_BUDGET) and label == "7b"
                            and batch == CONT_SLOTS
                            and pos_label == "shared 63")
                        if unit:
                            plain_ms = timer(lambda: plain_k(
                                q, *planes, layer, pv, table, P, kv_mul))
                        if window:
                            # the route windows took before K6w and K7w:
                            # K6's or K7's split walk, a block a (row,
                            # query), under its default plan
                            walk = (kernels[pages][0], kernels[pages][0])
                            walk_plan = pa.paged_plan(n_kv, batch, t_len,
                                                      sms)
                            walk_ms = timer(lambda: pa._launch(
                                walk, q, planes, layer, pv, table, P, kv_mul,
                                walk_plan))
                        last = [min(p + t_len - 1, S - 1) for p in pos]
                        n_live = max(last) // ps + 1
                        idx = (layer * P + table[:, :n_live]).reshape(-1)

                        def gather():
                            if pages == "q8":
                                kk = dequantize_q80_planes(kq4[idx],
                                                           kd4[idx])
                                vv = dequantize_q80_planes(vq4[idx],
                                                           vd4[idx])
                            else:
                                kk, vv = planes[0][idx], planes[1][idx]
                            return [x.reshape(batch, n_live * ps, n_kv, hs)
                                    .permute(0, 2, 1, 3) for x in (kk, vv)]

                        ms = timer(run)
                        ks, vs = gather()
                        sees = torch.clamp(
                            pv[:, None].long() + torch.arange(
                                t_len, device="cuda")[None, :], max=S - 1)
                        mask = (torch.arange(n_live * ps, device="cuda")
                                [None, None, :] <= sees[:, :, None])[:, None]
                        qs = q.reshape(batch, t_len, n_q, hs) \
                            .permute(0, 2, 1, 3).to(ks.dtype)

                        def lib():
                            return F.scaled_dot_product_attention(
                                qs, ks, vs, attn_mask=mask,
                                scale=att.attention_scale(hs),
                                enable_gqa=kv_mul > 1)

                        lib_err = (lib().permute(0, 2, 1, 3)
                                   .reshape(batch, t_len, -1).float()
                                   - want).abs().max().item()
                        gather_ms = timer(gather)
                        library_ms = timer(lib)
                        keys = [sum(min(p + i, S - 1) + 1
                                    for i in range(t_len)) for p in pos]
                        nbytes = (2 * sum(x + 1 for x in last) * n_kv * hs
                                  * bpv + 2 * batch * t_len * n_q * hs * 4)
                        # the windows' dots are TF32 passes on the
                        # tensor cores: 3 over f32 and Q8 pages, 2 over bf16
                        passes = 1 if not window else \
                            2 if pages == "bf16" else 3
                        b_ms, b_by = bound(nbytes,
                                           4.0 * passes * sum(keys) * n_q
                                           * hs, peaks, tf32=window)
                        log(f"{kernel.symbol} {label} B={batch} {pos_label}"
                            f" t={t_len}: max_abs_err {err:.3e} (tol "
                            f"{att.KERNEL_ATOL:.0e}) kernel {ms:.4f} ms "
                            f"bound {b_ms:.5f} ms ({b_by}) K5 "
                            f"{_f(k5_ms)} walk {_f(walk_ms)} plain "
                            f"{_f(plain_ms)} sdpa {library_ms:.4f} ms (err "
                            f"{lib_err:.1e}) + gather {gather_ms:.4f} ms")
                        rows.append(dict(
                            case=label, n_kv=n_kv, kv_mul=kv_mul,
                            batch=batch, pos=pos_label, t_len=t_len,
                            max_abs_err=err, ms=ms, k5_ms=k5_ms,
                            walk_ms=walk_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms, gather_ms=gather_ms,
                            pages=pages))
                for t_len in (1, MIXED_BUDGET):
                    _k6_replays(torch, run_k, planes, table, P, layer, n_q,
                                hs, kv_mul, batch,
                                kernels[pages][t_len > 1].symbol,
                                f"{label} B={batch}", t_len)
                del planes
                if pages == "q8":
                    del kq4, kd4, vq4, vd4, deq
            del base_k, base_v
    return rows


def _f(ms):
    return "-" if ms is None else f"{ms:.4f} ms"


K4_CASES = [  # (label, L, n_kv, kv_mul)
    ("7b", 32, 32, 1), ("gqa8", 4, 8, 8)]
K4_POS = (0, 384, 1920)
K4_RAGGED = (37, 1920)  # the extra case: (T, pos), a ragged chunk


def phase_k4(torch, timer, peaks, bf16=False, cache=None):
    """K4 (f32 dots) or K4b (``bf16`` dots) over an f32 cache or (``cache``
    = torch.bfloat16) a bf16 one, against the matching plain version at
    T = CHUNK and at T = 37 at pos 1920. The library yardstick
    is SDPA computing the kernel's function: in bf16 for K4b (bf16 dots,
    f32 accumulation), in f32 for K4 (over a bf16 cache on q and the live
    prefix cast to f32 beforehand, the cast not timed); over a bf16 cache
    SDPA in bf16, another function for K4, is printed beside it as
    ``library_bf16_ms``. Both print their plan (prefill_plan,
    prefill_bf16_plan: splits, key tiles a split) and must give the same
    bits on a second launch. K4's bound counts its TF32 passes (3 over an
    f32 cache, 2 over a bf16 one, whose values are exact in TF32), with the
    f32 SIMT bound of the same dots beside it (``simt_bound_ms``)."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import attention

    cache = cache or torch.float32
    kernel = attention._PREFILL[bf16, cache]
    plain = (attention.prefill_attention_bf16_plain if bf16
             else attention.prefill_attention_plain)
    atol = attention.KERNEL_ATOL_BF16 if bf16 else attention.KERNEL_ATOL
    lib_dtype = torch.bfloat16 if bf16 else torch.float32
    size = torch.tensor([], dtype=cache).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    hs = K2_HS
    cases = [(CHUNK, pos) for pos in K4_POS] + [K4_RAGGED]
    for label, L, n_kv, kv_mul in K4_CASES:
        shape = (L, K2_SEQ, n_kv, hs)
        n_q = n_kv * kv_mul
        layer = L - 1
        for t_len, pos in cases:
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
            plan = (attention.prefill_bf16_plan(
                pos, t_len, kv_mul, n_kv, attention.PREFILL_BF16_KEYS[cache],
                sms) if bf16 else attention.prefill_plan(pos, t_len, kv_mul,
                                                         n_kv, sms))
            if not torch.equal(run(), got):
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"two launches differ")
            want = plain(q, k_all, v_all, layer, pos, kv_mul)
            err = (got - want).abs().max().item()
            live = pos + t_len
            mask = (torch.arange(live, device="cuda")[None, :]
                    <= torch.arange(pos, live, device="cuda")[:, None])

            # yardsticks only: the port never calls SDPA
            def sdpa(dtype):
                qs = q.permute(1, 0, 2).unsqueeze(0).to(dtype)
                ks = k_all[layer, :live].permute(1, 0, 2).unsqueeze(0) \
                    .to(dtype)
                vs = v_all[layer, :live].permute(1, 0, 2).unsqueeze(0) \
                    .to(dtype)
                return lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, scale=attention.
                    attention_scale(hs), enable_gqa=kv_mul > 1)

            lib = sdpa(lib_dtype)
            lib_err = (lib()[0].permute(1, 0, 2).reshape(t_len, -1).float()
                       - want).abs().max().item()
            ms = timer(run)
            plain_ms = timer(lambda: plain(q, k_all, v_all, layer, pos,
                                           kv_mul))
            library_ms = timer(lib)
            library_bf16_ms = (timer(sdpa(torch.bfloat16))
                               if cache == torch.bfloat16 and not bf16
                               else None)
            # a poisoned suffix past pos+T-1 must stay unread
            k_all[layer, live:] = 1e9
            v_all[layer, live:] = float("nan")
            again = run()
            torch.cuda.synchronize()
            poisoned = not torch.equal(again, got)
            nbytes = 2 * live * n_kv * hs * size + 2 * t_len * n_q * hs * 4
            row_keys = t_len * pos + t_len * (t_len + 1) // 2
            flops = 4.0 * n_q * hs * row_keys
            passes = 1 if bf16 else 3 if cache == torch.float32 else 2
            b_ms, b_by = bound(nbytes, passes * flops, peaks, bf16,
                               tf32=not bf16)
            simt_ms = None if bf16 else bound(nbytes, flops, peaks)[0]
            bf16_note = ("" if library_bf16_ms is None
                         else f" sdpa bf16 {library_bf16_ms:.4f} ms")
            simt_note = ("" if simt_ms is None else
                         f", {passes} TF32 passes; SIMT {simt_ms:.5f} ms")
            log(f"{kernel.symbol} {label} T={t_len} pos {pos:4d} plan "
                f"{plan[0]} splits x {plan[1]}: "
                f"max_abs_err {err:.3e} (tol {atol:.0e}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms (its err "
                f"{lib_err:.1e}){bf16_note}"
                f" bound {b_ms:.5f} ms ({b_by}{simt_note}); poisoned "
                f"suffix {'CHANGED the output' if poisoned else 'invisible'}")
            if not err <= atol:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"error {err}")
            if poisoned:
                raise AssertionError(f"{kernel.symbol} {label} pos {pos}: "
                                     f"keys past pos+T changed the output")
            rows.append(dict(case=label, n_kv=n_kv, kv_mul=kv_mul, t=t_len,
                             pos=pos, splits=plan[0], max_abs_err=err,
                             library_err=lib_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             simt_bound_ms=simt_ms, library_ms=library_ms,
                             library_bf16_ms=library_bf16_ms))
            del k_all, v_all, q, got, want, again
    return rows


# (label, dim, hidden_dim, n_heads, n_kv_heads): Llama-2-7B, and the GQA
# shape of the attention phases (n_kv 8, kv_mul 8) at 70B's widths
FUSED_CASES = [("7b", 4096, 11008, 32, 32), ("gqa8", 8192, 28672, 64, 8)]
FUSED_POS = (0, 63, 2047)


def _spec_of(dim, hid, n_heads, n_kv, seq_len=K2_SEQ, n_layers=2):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.ops.quants import FloatType

    return TransformerSpec(dim=dim, hidden_dim=hid, n_layers=n_layers,
                           n_heads=n_heads, n_kv_heads=n_kv,
                           vocab_size=32000, seq_len=seq_len,
                           weights_float_type=FloatType.Q40)


def phase_fused(torch, timer, peaks):
    """K8, K9 and K10 against their plain versions at FUSED_CASES, layer 1
    of a 2-layer cache of seq_len 2048: K8 at every FUSED_POS, K9 once,
    K10 at every FUSED_POS over an f32 and a bf16 cache, part by part (the
    head's q and cache rows; the attention over the cache it wrote, split
    across the grid, against the plain attention of its own q, 1e-5 abs,
    its barrier count and split tickets back at 0; the tail from its own
    attention output; the layer output, a bf16 cache within 1e-3 x
    max|plain|, where a k/v value the two round across a bf16 boundary
    moves the scores). Times (pos 63, f32 cache; K10 at 2047 too): kernel,
    plain, and in place of a library time the unfused port path for the
    same work (llama._qkv_proj, _post_attention and _layer through the
    kernel route: K1, K2 and torch glue); no single PyTorch call computes
    these functions. K8's and K9's rows hold P0's bits (nb_probe's
    probe_classic, the classic row body): K8's v rows at every pos, all its
    rows at pos 0, on the vector it staged (read back bit for bit through
    one-hot rows, layer.readback_q40); K9's xnew = x + P0(wo, ao) and out =
    xnew + P0(w2, hb); K8's q, k and v equal K10's q scratch and f32 cache
    row at every pos; K8 and K9 give the same bits on a second launch."""
    from distributed_llama_tpu_torch.io.loader import Q40Weight
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops import attention, layer, q40
    from distributed_llama_tpu_torch.tools import nb_probe

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {"head": [], "tail": [], "mega": []}
    rtol = q40.KERNEL_RTOL

    def err_of(got, want, scale=rtol):
        err = (got - want).abs().max().item()
        return err, scale * want.abs().max().item()

    for label, dim, hid, n_heads, n_kv in FUSED_CASES:
        spec = _spec_of(dim, hid, n_heads, n_kv)
        lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", g)
        hs, kv_mul, kv_dim = spec.head_size, spec.kv_mul, spec.kv_dim
        x = torch.randn((1, dim), device="cuda", generator=g)
        ao = torch.randn((1, dim), device="cuda", generator=g)
        wb = {k: lw[k].qs.numel() + 2 * lw[k].d16.numel()
              for k in ("wqkv", "wo", "w13", "w2")}
        mv_flops = {k: 2.0 * lw[k].qs.shape[0] * lw[k].qs.shape[1] * 32
                    for k in wb}
        n_rot = dim + kv_dim
        head_args = (lw["wqkv"], lw["rms_att"], lw["freq"])
        tail_args = (lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"])
        s = layer._scratch(x.device, dim, hid)
        readback = layer.readback_q40(lw["wqkv"].qs.shape[0], dim, "cuda")
        zero = torch.zeros(1, dtype=torch.int32, device="cuda")
        xs = layer.q40_head_fused(x, readback, lw["rms_att"], lw["freq"],
                                  zero)[0, :dim]  # K8's staged vector
        wv = Q40Weight(lw["wqkv"].qs[n_rot:], lw["wqkv"].d16[n_rot:])
        for pos in FUSED_POS:
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            got = layer.q40_head_fused(x, *head_args, p)
            if not (torch.equal(got, layer.q40_head_fused(x, *head_args, p))
                    and torch.equal(got[0, n_rot:],
                                    nb_probe.probe_classic(wv, xs))
                    and (pos or torch.equal(got[0], nb_probe.probe_classic(
                        lw["wqkv"], xs)))):
                raise AssertionError(f"K8 {label} pos {pos}: not the same "
                                     f"bits twice, or rows without P0's "
                                     f"bits on its staged vector")
            err, tol = err_of(got, layer.q40_head_fused_plain(x, *head_args,
                                                              p))
            row = dict(case=label, pos=pos, max_abs_err=err, tol=tol,
                       per_token=0)
            if pos == 63:
                rope = llama.rope_tables(lw["freq"], pos)
                nbytes = wb["wqkv"] + 4 * (2 * dim + n_rot // 2
                                           + dim + 2 * kv_dim + 1)
                b_ms, b_by = bound(nbytes, mv_flops["wqkv"], peaks)
                row.update(
                    per_token=32 if label == "7b" else 0,
                    ms=timer(lambda: layer.q40_head_fused(x, *head_args, p)),
                    plain_ms=timer(lambda: layer.q40_head_fused_plain(
                        x, *head_args, p)),
                    unfused_ms=timer(lambda: llama._qkv_proj(
                        spec, lw, x, rope, llama.KERNELS)),
                    bound_ms=b_ms, bound_by=b_by)
            rows["head"].append(row)
        got = layer.q40_tail_fused(ao, x, *tail_args)
        if not (torch.equal(s.xnew[None], x + nb_probe.probe_classic(
                    lw["wo"], ao[0])[None])
                and torch.equal(got, s.xnew[None] + nb_probe.probe_classic(
                    lw["w2"], s.hb.clone())[None])
                and torch.equal(got, layer.q40_tail_fused(ao, x, *tail_args))
                and s.bar[0].item() == 0):
            raise AssertionError(f"K9 {label}: rows without P0's bits, not "
                                 f"the same bits twice, or the barrier's "
                                 f"count left set")
        err, tol = err_of(got, layer.q40_tail_fused_plain(ao, x, *tail_args))
        nbytes = wb["wo"] + wb["w13"] + wb["w2"] + 4 * 4 * dim
        b_ms, b_by = bound(nbytes, mv_flops["wo"] + mv_flops["w13"]
                           + mv_flops["w2"], peaks)
        rows["tail"].append(dict(
            case=label, max_abs_err=err, tol=tol,
            per_token=32 if label == "7b" else 0,
            ms=timer(lambda: layer.q40_tail_fused(ao, x, *tail_args)),
            plain_ms=timer(lambda: layer.q40_tail_fused_plain(ao, x,
                                                              *tail_args)),
            unfused_ms=timer(lambda: llama._post_attention(
                spec, lw, x, ao, llama.KERNELS)),
            bound_ms=b_ms, bound_by=b_by))
        for dtype in (torch.float32, torch.bfloat16):
            shape = (2, K2_SEQ, n_kv, hs)
            k = torch.randn(shape, device="cuda", generator=g).to(dtype)
            v = torch.randn(shape, device="cuda", generator=g).to(dtype)
            isz = k.element_size()
            for pos in FUSED_POS:
                p = torch.tensor([pos], dtype=torch.int32, device="cuda")
                kp, vp = k.clone(), v.clone()
                args = (lw["wqkv"], *tail_args[:3], lw["rms_att"],
                        lw["rms_ffn"], lw["freq"])
                got = layer.q40_layer_mega(x, *args, k, v, 1, p, kv_mul)
                want = layer.q40_layer_mega_plain(x, *args, kp, vp, 1, p,
                                                  kv_mul)
                head = layer.q40_head_fused_plain(x, *head_args, p)[0]
                step = 2.0 ** -7 if dtype == torch.bfloat16 else rtol
                parts = {
                    "q": err_of(s.q, head[:dim]),
                    "k": err_of(k[1, pos].float().reshape(-1),
                                head[dim:n_rot], step),
                    "v": err_of(v[1, pos].float().reshape(-1),
                                head[n_rot:], step),
                    "attention": ((s.ao[None] - attention.decode_attention_plain(
                        s.q.reshape(-1, hs), k, v, 1, pos, kv_mul)).abs()
                        .max().item(), attention.KERNEL_ATOL),
                    "tail": err_of(got, layer.q40_tail_fused_plain(
                        s.ao[None].clone(), x, *tail_args)),
                    "layer": err_of(got, want, 1e-3 if dtype ==
                                    torch.bfloat16 else rtol)}
                bad = {n: e for n, e in parts.items() if not e[0] <= e[1]}
                keep = torch.ones(k.shape[:2], dtype=torch.bool,
                                  device="cuda")
                keep[1, pos] = False
                if bad or not (torch.equal(k[keep], kp[keep])
                               and torch.equal(v[keep], vp[keep])):
                    raise AssertionError(f"K10 {label} {dtype} pos {pos}: "
                                         f"{bad or 'cache rows moved'}")
                if s.bar[0].item() or s.tickets.any():
                    raise AssertionError(f"K10 {label} {dtype} pos {pos}: "
                                         f"barrier count {s.bar[0].item()}"
                                         f" or split tickets left set")
                if dtype == torch.float32:
                    k8 = layer.q40_head_fused(x, *head_args, p)[0]
                    if not (torch.equal(k8[:dim], s.q) and torch.equal(
                            k8[dim:n_rot], k[1, pos].reshape(-1))
                            and torch.equal(k8[n_rot:],
                                            v[1, pos].reshape(-1))):
                        raise AssertionError(f"K8 {label} pos {pos}: q, k "
                                             f"and v not K10's bits")
                row = dict(case=label, pos=pos, cache=str(dtype)[6:],
                           max_abs_err=parts["layer"][0],
                           tol=parts["layer"][1],
                           parts={n: e[0] for n, e in parts.items()},
                           per_token=0)
                if dtype == torch.float32 and pos in (63, 2047):
                    rope = llama.rope_tables(lw["freq"], pos)
                    cache = llama.KVCache(k, v)
                    nbytes = (sum(wb.values()) + 4 * (4 * dim + n_rot // 2 + 1)
                              + 2 * (pos + 1) * kv_dim * isz)
                    flops = (sum(mv_flops.values())
                             + 4.0 * (pos + 1) * n_heads * hs)
                    b_ms, b_by = bound(nbytes, flops, peaks)
                    row.update(
                        per_token=32 if (label, pos) == ("7b", 63) else 0,
                        ms=timer(lambda: layer.q40_layer_mega(
                            x, *args, k, v, 1, p, kv_mul)),
                        plain_ms=timer(lambda: layer.q40_layer_mega_plain(
                            x, *args, kp, vp, 1, p, kv_mul)),
                        unfused_ms=timer(lambda: llama._layer(
                            spec, x, lw, cache, 1, pos, rope,
                            llama.KERNELS)),
                        bound_ms=b_ms, bound_by=b_by)
                rows["mega"].append(row)
            del k, v, kp, vp
        for name, kernel_rows in rows.items():
            for r in kernel_rows:
                if r["case"] != label:
                    continue
                timing = (f" kernel {r['ms']:.4f} ms plain "
                          f"{r['plain_ms']:.4f} unfused {r['unfused_ms']:.4f}"
                          f" bound {r['bound_ms']:.4f} ({r['bound_by']})"
                          if "ms" in r else "")
                log(f"fused {name} {label} pos {r.get('pos', '-')} "
                    f"{r.get('cache', '')}: max_abs_err "
                    f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}){timing}")
                if not r["max_abs_err"] <= r["tol"]:
                    raise AssertionError(f"fused {name} {label}: error "
                                         f"{r['max_abs_err']} above "
                                         f"{r['tol']}")
        del lw, x, ao
    return rows


# --------------------------------------------------------------------------
# phase 2c: the Q40 layout probe's kernels (B10) and its traced chain
# --------------------------------------------------------------------------

PROBE_SHAPES = [("w13", 27648, 5120), ("wqkv", 15360, 5120)]  # 13B leaves
PROBE_LAYERS, PROBE_REPS = 4, 4
# variant -> the kernels line's name for its kernel (k1 is K1)
PROBE_KERNELS = {"v0": "probe_classic", "dma": "probe_stream",
                 "v0r": "probe_xglobal", "v1": "probe_nomask",
                 "i4": "probe_signed"}


def phase_probe(torch, timer, peaks):
    """P0-P4 and K1 against their plain versions at the 13B w13 and wqkv
    shapes, timed (the Timer's medians) beside the bound, the plain time
    and cuBLAS's f32 GEMV on the weight dequantized beforehand (none for
    P1: no library call computes its XOR fold); P2 and P3 are timed on x
    prepared beforehand, as their wrappers prepare it once per call. P2
    and P4, K1's skeleton at K1's plan, must return K1's bits (P4 over
    the same codes made signed); P2's plan beside the one a block staging
    no x would take. Then
    the probe's own run at w13 (tools/nb_probe.run_variant, every variant,
    PROBE_LAYERS x PROBE_REPS chained calls each, traced): every count set
    to 0 just before and read just after; its trace must hold exactly
    PROBE_LAYERS x PROBE_REPS events of each variant's kernel."""
    from distributed_llama_tpu_torch.io.loader import Q40Weight
    from distributed_llama_tpu_torch.ops import q40
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch
    from distributed_llama_tpu_torch.tools import nb_probe as nbp

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for shape, d, n in PROBE_SHAPES:
        nb = n // 32
        w = q40.random_q40(d, n, "cuda", g)
        ws = Q40Weight(nbp.to_signed(w.qs), w.d16)
        x = torch.randn((n,), device="cuda", generator=g)
        xlaid, xprep = nbp.lay_x(x), nbp.prep_nomask(x)
        wf = dequantize_q40_torch(w.qs, w.d16)
        sms = q40.sm_count(x.device)
        log(f"B10 P2/P4 {shape}: K1's plan (wr, wk, grid_x, splits, kb) "
            f"{q40.matvec_plan(1, d, nb, sms)}; a block staging no x would "
            f"take {q40.matvec_plan(1, d, nb, sms, 3, False)}")
        library_ms = timer(lambda: torch.matmul(x[None], wf.T))
        # (variant, kernel, run, plain, rtol, x bytes read, library ms)
        cases = [
            ("dma", "probe_stream", lambda: nbp.probe_stream(w),
             lambda: nbp.probe_stream_plain(w), nbp.KERNEL_RTOL, 0, None),
            ("v0", "probe_classic", lambda: nbp.probe_classic(w, x),
             lambda: q40.q40_matmul_plain(w, x[None])[0], q40.KERNEL_RTOL,
             n * 4, library_ms),
            ("k1", "q40_matvec", lambda: q40.q40_matmul(w, x[None])[0],
             lambda: q40.q40_matmul_plain(w, x[None])[0], q40.KERNEL_RTOL,
             n * 4, library_ms),
            ("v0r", "probe_xglobal", lambda: nbp.probe_xglobal_laid(w, xlaid),
             lambda: nbp.probe_xglobal_plain(w, x), nbp.KERNEL_RTOL,
             xlaid.numel() * 2, library_ms),
            ("v1", "probe_nomask",
             lambda: nbp._launch(nbp.NOMASK, w, [xprep], d, nb),
             lambda: nbp.probe_nomask_plain(w, xprep),
             nbp.KERNEL_RTOL_NOMASK, nb * nbp.BLOCK_PAD * 4, library_ms),
            ("i4", "probe_signed", lambda: nbp.probe_signed(ws, x),
             lambda: nbp.probe_signed_plain(ws, x), nbp.KERNEL_RTOL, n * 4,
             library_ms)]
        for variant, kname, run, plain, rtol, x_bytes, lib_ms in cases:
            got = run()
            want = plain()
            torch.cuda.synchronize()
            if variant == "k1":
                k1_bits = got
            elif variant in nbp.K1_SKELETON and not torch.equal(got, k1_bits):
                raise AssertionError(
                    f"B10 {variant} {shape}: not K1's bits (max diff "
                    f"{(got - k1_bits).abs().max().item():.3e})")
            err = (got - want).abs().max().item()
            tol = rtol * want.abs().max().item()
            ms = timer(run)
            plain_ms = timer(plain)
            nbytes = 18 * d * nb + x_bytes + 4 * d
            # P1: a XOR fold (15 ops) and a multiply-add per block; the
            # others: a multiply-add per weight
            ops = 17.0 * d * nb if variant == "dma" else 2.0 * d * n
            b_ms, b_by = bound(nbytes, ops, peaks)
            log(f"B10 {variant:3s} {kname:13s} {shape:4s} ({d}x{n}): "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms "
                f"({nbytes / ms / 1e6:.0f} GB/s, {b_ms / ms:.1%} of the "
                f"bound) plain {plain_ms:.4f} ms gemv "
                + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
                + f" bound {b_ms:.4f} ms ({b_by})"
                + ("; K1's bits" if variant in nbp.K1_SKELETON else ""))
            if not err <= tol:
                raise AssertionError(f"B10 {variant} {shape}: error {err} "
                                     f"above {tol}")
            rows.append(dict(variant=variant, kernel=kname, shape=shape,
                             d=d, n=n, max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, share=b_ms / ms))
        del w, ws, x, xlaid, xprep, wf, k1_bits
    return rows, probe_chain(torch)


def probe_chain(torch):
    """The probe's own measurement at w13 (PROBE_LAYERS x PROBE_REPS
    dependent calls per variant, traced), in process, every kernel's count
    set to 0 just before and read just after: per variant one parity call
    and three chains (warm-up, traced, CUDA-event timed); each trace must
    hold exactly the chain's events of its kernel."""
    from distributed_llama_tpu_torch.tools import nb_probe as nbp

    d, n = nbp.SHAPES["w13"]
    w = nbp.synth(PROBE_LAYERS, d, n, "cuda")
    x = torch.randn((n,), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1))
    calls = PROBE_LAYERS * PROBE_REPS
    for k in _all_kernels():
        k.launches = 0
    results = [nbp.run_variant(v, "w13", w, x, PROBE_REPS,
                               SMOKE_DIR / "nb_probe")
               for v in nbp.VARIANTS]
    launches = {k.symbol: k.launches for k in _all_kernels()}
    want = collections.Counter()
    for r in results:  # a parity call, a warm-up chain, traced chains, and
        # the timed chain (v0 and v0_128 both launch probe_classic)
        want[nbp.RUNS[r["variant"]].symbol] += 1 + 3 * calls
    _expect("probe run", launches, want)
    k1 = next(r for r in results if r["variant"] == "k1")
    for r in results:
        log(f"probe: {nbp.describe(r, k1)}")
        if r["events"] != calls:
            raise AssertionError(f"probe {r['variant']}: {r['events']} "
                                 f"trace events, want {calls}")
    del w
    return dict(shape="w13", layers=PROBE_LAYERS, reps=PROBE_REPS,
                launches=launches, results=results)


# --------------------------------------------------------------------------
# tensor parallelism: the kernels at band shapes
# --------------------------------------------------------------------------

TP_SIZES = (2, 4)


def tp_band_shapes(tp: int) -> list[tuple[str, int, int]]:
    """A 7B rank's Q40 matrices at ``tp`` (parallel/tp.py): the fused
    scheme's column-parallel bands (wqkv, w13, wcls: rows / tp) and its
    row-parallel wo and w2 (Q40 blocks / tp), then the ref scheme's wo and
    w2 row bands."""
    return [("wqkv", 12288 // tp, 4096), ("wo", 4096, 4096 // tp),
            ("w13", 22016 // tp, 4096), ("w2", 4096, 11008 // tp),
            ("wcls", 32000 // tp, 4096), ("wo-ref", 4096 // tp, 4096),
            ("w2-ref", 4096 // tp, 11008)]


def phase_tp_bands(torch, timer, peaks):
    """K1 (T = 1), K1m (T = 8) and K3 (T = 128) against plain at a 7B rank's
    band shapes for tp 2 and 4, each beside its bytes bound. The units are
    the kernels line's for one rank of the fused scheme: K1 a token (32 x
    wqkv, wo, w13, w2 and wcls), K1m an 8-token step and K3 a 128-token
    chunk (32 x the four layer bands); the ref scheme's wo and w2 bands
    are timed for K1 beside the unit."""
    from distributed_llama_tpu_torch.ops.q40 import KERNEL_GEMM

    out = {}
    for tp in TP_SIZES:
        shapes = tp_band_shapes(tp)
        layer = [s for s in shapes if s[0] in ("wqkv", "wo", "w13", "w2")]
        unit = {"wcls": 1, "wo-ref": 0, "w2-ref": 0}
        out[tp] = {
            "q40_matvec": _matvec_rows(
                torch, timer, peaks, [(n, d, k, 1, unit.get(n, 32))
                                      for n, d, k in shapes], 20 + tp),
            "q40_matvec_multi": _matvec_rows(
                torch, timer, peaks, [(n, d, k, Q80_CHUNK, 32)
                                      for n, d, k in layer], 30 + tp),
            "q40_gemm": _q40_rows(
                torch, timer, peaks, KERNEL_GEMM,
                [(n, d, k, CHUNK, 32) for n, d, k in layer], 40 + tp)}
    return out


# --------------------------------------------------------------------------
# phase 3: the main path, end to end through the CLI
# --------------------------------------------------------------------------

def start_smoke_writer() -> subprocess.Popen:
    """smoke_files in a process of its own, started before the kernel
    phases so that the 4.2 GB model is written while the card works (a
    process, not a thread: the kernel timings keep the interpreter lock).
    Stopped at exit if still running."""
    import atexit

    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.smoke_files()"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def smoke_files(writer: subprocess.Popen | None = None):
    """A 7B-shaped Q40 .bin with random codes (seed 0) and a 32000-piece
    tokenizer in build/smoke/, written once and reused while they fit;
    ``writer`` (start_smoke_writer) is waited for first."""
    if writer is not None:
        out, _ = writer.communicate()
        for line in out.splitlines():
            log(f"smoke writer: {line}")
        if writer.returncode != 0:
            raise RuntimeError(f"the smoke model writer exited "
                               f"{writer.returncode}")
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
    from distributed_llama_tpu_torch.ops import (attention, layer,
                                                 paged_attention, q40)
    from distributed_llama_tpu_torch.tools import nb_probe

    return [*q40.KERNELS, *q40.HELPERS, *attention.KERNELS,
            *attention.HELPERS, *paged_attention.KERNELS, *layer.KERNELS,
            *nb_probe.KERNELS]


@contextlib.contextmanager
def _finite_logits(seen: list, gaps: list | None = None,
                   streams: list | None = None):
    """Record, for every decode step the engine runs, whether its logits
    are all finite (and in ``gaps`` the gap between its two largest logits
    and its largest |logit|); in ``streams`` the tokens every generate and
    generate_fast call returns."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime import generate

    infer = generate.Engine.infer
    loops = {name: getattr(generate, name)
             for name in ("generate", "generate_fast")}

    def checked(self, token, pos):
        logits = infer(self, token, pos)
        seen.append(bool(np.isfinite(logits).all()))
        if gaps is not None:
            top = np.sort(logits)[-2:]
            gaps.append((float(top[1] - top[0]),
                         float(np.abs(logits).max())))
        return logits

    def recorded(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            streams.append(list(out[0]))
            return out
        return run

    generate.Engine.infer = checked
    if streams is not None:
        for name, fn in loops.items():
            setattr(generate, name, recorded(fn))
    try:
        yield
    finally:
        generate.Engine.infer = infer
        for name, fn in loops.items():
            setattr(generate, name, fn)


# every kernel's launches summed over all CLI runs (a-r, runs e and f in
# process): the counts of the kernels line
CLI_LAUNCHES: dict[str, int] = {}


def _add_cli_launches(counts: dict[str, int]) -> None:
    for symbol, n in counts.items():
        CLI_LAUNCHES[symbol] = CLI_LAUNCHES.get(symbol, 0) + n


# K6's and K7's launches at a window wider than a decode step, by (kernel,
# t_len): the verify (runs s, u) and mixed (run t) dispatches
WINDOW_LAUNCHES: dict[tuple[str, int], int] = {}


def _run_cli(torch, model, tok, args: list[str], env=None, gaps=None,
             streams=None):
    """The CLI in-process, with ``env`` set in the environment, and with
    every kernel's count set to 0 just before and read just after. Returns
    (stdout, launches by kernel symbol, wall s, per-step logits-finite
    flags); ``gaps`` and ``streams`` as _finite_logits fills them."""
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
                _finite_logits(finite, gaps, streams):
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
    _add_cli_launches(launches)
    return buf.getvalue(), launches, wall, finite


def _reuse_loads(path):
    """From now on, io/loader.load_model of ``path`` (the 7B smoke file,
    read in this process) returns the host tree it read the first time,
    a fresh dict over the same arrays, with its spec read anew (runs
    differ in the buffer type): every in-process CLI run and phase after
    run a skips the ~3.5 s read of the same 4.2 GB; run a reads the file,
    and child processes read it themselves. Returns the undo."""
    from distributed_llama_tpu_torch.io import loader

    real = loader.load_model
    cache = {}

    def load(p, spec=None, weights_float_type=loader.FloatType.F32,
             buffer_float_type=loader.FloatType.F32):
        if str(p) != str(path):
            return real(p, spec, weights_float_type, buffer_float_type)
        if spec is None:
            spec = loader.read_spec(p, weights_float_type, buffer_float_type)
        if spec.weights_float_type not in cache:
            cache[spec.weights_float_type] = real(p, spec=spec)[1]
        return spec, dict(cache[spec.weights_float_type])

    load.real = real  # an honest read of the file (obs_full_width's)
    loader.load_model = load

    def undo():
        loader.load_model = real

    return undo

def phase_e2e(torch, model, tok):
    """Run a; also returns its token stream and its per-step top-2 logit
    gaps (the reference of the fused runs o and p)."""
    torch.cuda.reset_peak_memory_stats()
    gaps, streams = [], []
    out, counts, wall, _ = _run_cli(torch, model, tok, [
        "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
        "--seed", "1"], gaps=gaps, streams=streams)
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
    return e2e, out, (streams[0], gaps)


def _expect(label, counts, want):
    """Every kernel's launches equal ``want``'s, 0 for a kernel it omits."""
    full = dict.fromkeys(counts, 0)
    full.update(want)
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}, want {full}")


def _prefill_parts(spec, chunk, starts, fast, kvbf16):
    """The launches of the prefill kernels' parts over windows of T =
    ``chunk`` at positions ``starts``, by the plans the wrappers follow on
    this card: for T > 8 one x pass per GEMM launch (K3's TF32 split, or
    under ``fast`` K3b's bf16 rounding) and one split-K sum per layer matrix
    that gemm_tf32_plan (gemm_bf16_plan) splits; one combine per layer of a
    window that prefill_plan (prefill_bf16_plan) splits. Kernels with no
    launch are left out."""
    import torch

    from distributed_llama_tpu_torch.ops import attention, q40

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    L, kv_mul, n_kv = spec.n_layers, spec.kv_mul, spec.n_kv_heads
    shapes = [(spec.dim + 2 * spec.kv_dim, spec.dim), (spec.dim, spec.dim),
              (2 * spec.hidden_dim, spec.dim), (spec.dim, spec.hidden_dim)]
    if fast:
        keys = attention.PREFILL_BF16_KEYS[torch.bfloat16 if kvbf16
                                           else torch.float32]
        x_pass, gemm_plan = "q40_round_bf16", q40.gemm_bf16_plan
        splits = [attention.prefill_bf16_plan(p, chunk, kv_mul, n_kv, keys,
                                              sms)[0] for p in starts]
    else:
        x_pass, gemm_plan = "q40_split_tf32", q40.gemm_tf32_plan
        splits = [attention.prefill_plan(p, chunk, kv_mul, n_kv, sms)[0]
                  for p in starts]
    # both routes merge their splits with K3b's sum and K4b's combine
    parts = {"prefill_attention_bf16_combine": L * sum(z > 1
                                                       for z in splits)}
    if chunk > q40.MULTI_T_MAX:
        parts[x_pass] = 4 * L * len(starts)
        parts["q40_gemm_bf16_reduce"] = L * len(starts) * sum(
            gemm_plan(chunk, d, n // 32, sms)[0] > 1 for d, n in shapes)
    return {k: v for k, v in parts.items() if v}


def _prefill_launches(spec, decode_steps, fast, kvbf16):
    """The launches of the 512-token prompt at CHUNK, then decode_steps
    token-by-token steps: the Q40 GEMM, prefill attention and decode
    attention builds that --fast-prefill (K3b and K4b rather than K3 and K4)
    and a bf16 cache select, with their parts, 4 chunks of T = 128."""
    n_layers = spec.n_layers
    gemm = "q40_gemm_bf16" if fast else "q40_gemm"
    prefill = ("prefill_attention_bf16" if fast else "prefill_attention") \
        + ("_kvbf16" if kvbf16 else "")
    decode = "decode_attention" + ("_kvbf16" if kvbf16 else "")
    n_chunks = (511 + CHUNK - 1) // CHUNK
    want = {"q40_matvec": (4 * n_layers + 1) * decode_steps,
            gemm: 4 * n_layers * n_chunks,
            decode: n_layers * decode_steps,
            prefill: n_layers * n_chunks}
    want.update(_prefill_parts(spec, CHUNK,
                               [CHUNK * i for i in range(n_chunks)], fast,
                               kvbf16))
    return want


def phase_e2e_prefill(torch, model, tok, spec, label="prefill",
                      flags=(), steps=STEPS_512):
    """The 512-token prompt through --prefill-chunk 128 and ``flags``: 4
    chunks of T = 128, then decode from pos 511 to ``steps``. The launch
    counts are exact (_prefill_launches), every other kernel 0."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, counts, wall, finite = _run_cli(torch, model, tok, [
        "--prompt", PROMPT_512, "--steps", str(steps), "--temperature",
        "0", "--seed", "1", "--prefill-chunk", str(CHUNK), *flags])
    decode_steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    _expect(f"{label} run", counts, _prefill_launches(
        spec, decode_steps, "--fast-prefill" in flags, "bf16" in flags))
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


def phase_e2e_bf16(torch, model, tok, spec, f32_run):
    """Run d: the 512-token prompt with --fast-prefill and a bf16 cache
    (its peak device memory must lie about the 1.07 GB of the halved 7B
    cache below run b's), with exact launch counts. Runs e and f, each flag
    alone, run in process on phase 4's weights (flag_runs)."""
    both = phase_e2e_prefill(torch, model, tok, spec, "fast bf16-cache",
                             ("--fast-prefill", "--kv-cache-dtype", "bf16"))
    saved = f32_run["peak_device_gb"] - both["peak_device_gb"]
    log(f"peak device memory: {both['peak_device_gb']:.3f} GB with a bf16 "
        f"cache, {f32_run['peak_device_gb']:.3f} GB with f32: "
        f"{saved:.3f} GB less")
    if not 0.9 <= saved <= 1.25:
        raise AssertionError(f"the bf16 cache saved {saved:.3f} GB of peak "
                             f"device memory, not ~1.07")
    return dict(fast_bf16_cache=both, peak_saved_gb=saved)


def flag_runs(torch, engine, tokenizer):
    """Runs e and f in process, on phase 4's weights: run b's prompt and
    chunk through ``generate`` (what the CLI calls) with STEPS_SHORT (9
    decode steps), with --fast-prefill alone (e: K3b and K4b over an f32
    cache) and with a bf16 cache alone (f: K3, the bf16-cache K4 and K2).
    Every kernel's count is set to 0 just before each and read just after:
    exact launch counts, finite logits at every decode step."""
    import copy

    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.runtime.generate import generate
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    res = {}
    for label, fast, dtype in (("e fast", True, torch.float32),
                               ("f bf16-cache", False, torch.bfloat16)):
        run = copy.copy(engine)
        run.fast_prefill = fast
        run.cache = llama.init_cache(engine.spec, "cuda", dtype)
        run._loops = {}
        finite = []
        for k in _all_kernels():
            k.launches = 0
        t0 = time.perf_counter()
        with _finite_logits(finite):
            _, stats = generate(run, tokenizer, Sampler(32000, 0.0, 0.9, 1),
                                PROMPT_512, STEPS_SHORT, quiet=True,
                                prefill_chunk=CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.symbol: k.launches for k in _all_kernels()}
        _add_cli_launches(counts)
        steps = stats.tokens
        _expect(f"{label} run", counts, _prefill_launches(
            engine.spec, steps, fast, dtype == torch.bfloat16))
        if steps != STEPS_SHORT - 511 or not all(finite) \
                or len(finite) != steps:
            raise AssertionError(f"{label} run: {steps} decode steps, "
                                 f"finite logits {sum(finite)}/{len(finite)}")
        res[label] = dict(prompt_tokens=512, chunk=CHUNK, decode_steps=steps,
                          wall_s=wall, launches=counts,
                          ms_per_token_avg=stats.total_ms / steps)
        log(f"e2e {label} (in process): {json.dumps(res[label])}")
        del run
    return res


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


def phase_e2e_fast(torch, model, tok, spec, ref_a, ref_b):
    """Runs i and j: --fast with run a's prompt and steps (its stream must
    equal run a's token for token, through K1 and K5 at B = 1, K2 never
    launched), and --fast --prefill-chunk 128 on the 512-token prompt (K3
    and K4 for the 4 chunks, then the chain from pos 511; its text must
    end with run b's decode pieces)."""
    n_layers = spec.n_layers
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
                        prefill_attention=n_layers * chunks,
                        **_prefill_parts(spec, CHUNK,
                                         [CHUNK * i for i in range(chunks)],
                                         False, False))
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


def _same_stream(label, got, want, gaps):
    """Hold a fused run's greedy tokens against the unfused host loop's
    (``want``, with its per-step top-2 logit gaps): equal, or parting at a
    step where the unfused logits' two largest lie within LOGIT_RTOL x
    max|logit| of each other (a tie the two routes' sums may break either
    way). Returns (equal, the step they part at or None, its gap)."""
    from distributed_llama_tpu_torch.models.llama import LOGIT_RTOL

    if got == want:
        return True, None, None
    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    gap, top = gaps[i] if i < len(gaps) else (float("inf"), 0.0)
    log(f"{label}: stream parts from the unfused one at step {i}, where "
        f"the unfused top-2 logit gap is {gap:.3e} (tolerance "
        f"{LOGIT_RTOL * top:.3e})")
    if not gap <= LOGIT_RTOL * top:
        raise AssertionError(f"{label}: stream differs from the unfused one "
                             f"at step {i}, top-2 gap {gap} above the logit "
                             f"tolerance")
    return False, i, gap


def phase_e2e_fused(torch, model, tok, n_layers, ref):
    """Runs o and p: run a's prompt and steps under DLLAMA_LAYER_FUSION,
    through the CLI. o: the host loop under 'headtail', per step n_layers
    K8, K2 and K9 and one K1 (wcls), nothing else; p: ``--fast`` under
    'on', per device step n_layers K10 and one K1, no K2 or K5. Their
    greedy streams against run a's (``ref``: its tokens and top-2 gaps;
    run i's equals it)."""
    want, gaps = ref
    res = {}
    for label, mode, extra in (("o headtail", "headtail", []),
                               ("p --fast on", "on", ["--fast"])):
        streams = []
        out, counts, wall, finite = _run_cli(torch, model, tok, [
            "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
            "--seed", "1", *extra], {"DLLAMA_LAYER_FUSION": mode},
            streams=streams)
        if extra:
            steps = int(re.search(r"fused loop, (\d+) device steps",
                                  out).group(1))
            per_step = {"q40_layer_mega": n_layers}
        else:
            steps = int(re.search(r"Generated tokens:\s+(\d+)",
                                  out).group(1))
            per_step = {"q40_head_fused": n_layers,
                        "decode_attention": n_layers,
                        "q40_tail_fused": n_layers}
            if not all(finite) or len(finite) != steps:
                raise AssertionError(f"{label}: finite logits "
                                     f"{sum(finite)}/{len(finite)}")
        _expect(f"{label} run", counts, {
            "q40_matvec": steps, **{k: n * steps for k, n in per_step.items()}})
        same, part, gap = _same_stream(label, streams[0], want, gaps)
        avg = float(re.search(r"Avg generation time: ([\d.]+) ms",
                              out).group(1))
        res[label] = dict(mode=mode, steps=steps, ms_per_token_avg=avg,
                          wall_s=wall, launches=counts,
                          launches_per_step=sum(counts.values()) / steps,
                          stream_equal=same, parts_at=part, gap=gap)
        log(f"e2e {label}: {json.dumps(res[label])}")
    return res


def phase_e2e_profile(torch, model, tok, n_layers, ref):
    """Run q: run i (``--fast``, run a's prompt and steps) with ``--profile
    DIR`` through the CLI. Its stream equals run a's (``ref``: the pieces);
    the 🔶 I/T line is printed; its trace holds exactly the run's K1 and K5
    launches, under their kernels' base names (q40_matvec_kernel, and
    decode_attention_kernel, the template K5 shares with K2, which this run
    never launches): the trace sees the kernels the CUDA graph replays."""
    import shutil

    from distributed_llama_tpu_torch.utils import it_split

    where = SMOKE_DIR / "profile_q"
    shutil.rmtree(where, ignore_errors=True)
    out, counts, wall, _ = _run_cli(torch, model, tok, [
        "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
        "--seed", "1", "--fast", "--profile", str(where)])
    _expect("q run", counts, {"q40_matvec": (4 * n_layers + 1) * STEPS,
                              "decode_attention_batch": n_layers * STEPS})
    if _fast_text(out) != ref:
        raise AssertionError("q run: the profiled --fast stream differs "
                             "from run a's")
    split_line = [ln for ln in out.splitlines() if ln.startswith("🔶 I ")]
    if len(split_line) != 1 or f"Profiler trace written to {where}" \
            not in out:
        raise AssertionError("q run: no trace line or I/T line")
    splits = it_split.parse_trace(str(where))
    dev = {k: v for k, v in splits.items() if k.startswith("/device:")}
    traced = {"q40_matvec": sum(v.counts["q40_matvec_kernel"]
                                for v in dev.values()),
              "decode_attention_batch": sum(
                  v.counts["decode_attention_kernel"] for v in dev.values())}
    want = {k: counts[k] for k in traced}
    log(f"e2e q --fast --profile: {split_line[0]}; traced kernel events "
        f"{traced} vs launches {want}; buckets per step "
        f"{it_split.bucket_ops_from_splits(dev, STEPS)}")
    if traced != want:
        raise AssertionError(f"q run: the trace holds {traced} kernel "
                             f"events, the run launched {want}")
    return dict(wall_s=wall, launches=counts, traced=traced,
                split_line=split_line[0],
                trace_kernels=sum(sum(v.counts.values())
                                  for v in dev.values()))


def phase_e2e_resume(torch, model, tok, n_layers, ref):
    """Run r: run a's prompt through the CLI for 32 steps with
    ``--save-state``, then 32 more with ``--resume-state`` (``--steps``
    counts the positions a resumed run adds, as in the JAX CLI): each run
    launches K1 129 and K2 32 per step, and the joined pieces equal run
    a's 64 (``ref``)."""
    path = SMOKE_DIR / "state_r.npz"
    path.unlink(missing_ok=True)
    half = STEPS // 2
    base = ["--prompt", PROMPT, "--steps", str(half), "--temperature", "0",
            "--seed", "1"]
    outs, res = [], {}
    for label, flag in (("save", "--save-state"),
                        ("resume", "--resume-state")):
        out, counts, wall, finite = _run_cli(torch, model, tok,
                                             [*base, flag, str(path)])
        _expect(f"r {label} run", counts, {
            "q40_matvec": (4 * n_layers + 1) * half,
            "decode_attention": n_layers * half})
        if not all(finite) or len(finite) != half:
            raise AssertionError(f"r {label} run: finite logits "
                                 f"{sum(finite)}/{len(finite)}")
        outs.append(out)
        res[label] = dict(wall_s=wall, launches=counts)
    if f"⏩ Saved generation state to {path}" not in outs[0] or \
            f"⏩ Resumed at pos {half} (" not in outs[1]:
        raise AssertionError("r run: no save or resume line")
    joined = _pieces(outs[0]) + _pieces(outs[1])
    same = joined == ref
    log(f"e2e r --save-state / --resume-state at {half}: checkpoint "
        f"{path.stat().st_size} bytes; joined stream "
        f"{'equals' if same else 'DIFFERS from'} run a's")
    if not same:
        raise AssertionError("r run: the joined stream differs from run a's")
    return dict(split_at=half, checkpoint_bytes=path.stat().st_size, **res)


def capture_reading(torch, engine, tokenizer):
    """What a timed capture (obs/profiler.start_capture, started on its own
    thread) sees of work on the main thread: a 1 s capture while 4 --fast
    steps run, then the kernel events its trace holds. A reading for
    PERF.md, not an assertion."""
    import shutil

    from distributed_llama_tpu_torch.obs import profiler
    from distributed_llama_tpu_torch.runtime.generate import generate_fast
    from distributed_llama_tpu_torch.runtime.sampling import Sampler
    from distributed_llama_tpu_torch.utils import it_split

    where = SMOKE_DIR / "capture"
    shutil.rmtree(where, ignore_errors=True)
    engine.reset()
    for k in _all_kernels():
        k.launches = 0
    profiler.start_capture(str(where), 1.0)
    generate_fast(engine, tokenizer, Sampler(32000, 0.0, 0.9, 1), PROMPT, 4,
                  quiet=True)
    torch.cuda.synchronize()
    launched = {k.symbol: k.launches for k in _all_kernels() if k.launches}
    if not profiler.wait_capture(60):
        raise AssertionError("the timed capture did not end")
    try:
        splits = it_split.parse_trace(str(where))
    except (FileNotFoundError, ValueError) as e:
        splits, err = {}, f"{type(e).__name__}: {e}"
    else:
        err = None
    dev = [v for k, v in splits.items() if k.startswith("/device:")]
    res = dict(kernel_events=sum(sum(v.counts.values()) for v in dev),
               q40_matvec_events=sum(v.counts["q40_matvec_kernel"]
                                     for v in dev),
               host_op_events=sum(sum(v.counts.values()) for k, v in
                                  splits.items() if k.startswith("/host")),
               launched=launched, parse_error=err)
    log(f"capture reading (start_capture 1 s on its thread, 4 --fast steps "
        f"on the main thread): {json.dumps(res)}")
    return res


def phase_e2e_q80(torch, model, tok, spec):
    """Run c: q80 buffers, the 20-token prompt through --prefill-chunk 8.
    Also returns its tokens and, aligned with them, its decode steps'
    top-2 logit gaps (the prefilled positions have none): the reference of
    the tp q80 run."""
    n_layers = spec.n_layers
    gaps, streams = [], []
    out, counts, wall, finite = _run_cli(torch, model, tok, [
        "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
        "--seed", "1", "--buffer-float-type", "q80", "--prefill-chunk",
        str(Q80_CHUNK)], gaps=gaps, streams=streams)
    steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    n_chunks = (19 + Q80_CHUNK - 1) // Q80_CHUNK
    _expect("q80 run", counts, {
        "q40_matvec": (4 * n_layers + 1) * steps,
        "q40_matvec_multi": 4 * n_layers * n_chunks,
        "q40_gemm": 0,
        "decode_attention": n_layers * steps,
        "prefill_attention": n_layers * n_chunks,
        **_prefill_parts(spec, Q80_CHUNK,
                         [Q80_CHUNK * i for i in range(n_chunks)], False,
                         False)})
    if steps != STEPS - 19 or not all(finite) or len(finite) != steps:
        raise AssertionError(f"q80 run: {steps} decode steps, finite "
                             f"logits {sum(finite)}/{len(finite)}")
    res = dict(buffer="q80", chunk=Q80_CHUNK, decode_steps=steps,
               wall_s=wall, launches=counts, finite_steps=sum(finite))
    log(f"e2e q80: {json.dumps(res)}")
    return res, (streams[0], [(float("inf"), 0.0)] * 19 + gaps)


@contextlib.contextmanager
def _engine_spy(seen: list):
    """Record (engine, request) for every request a ContinuousEngine
    takes while the CLI runs."""
    from distributed_llama_tpu_torch.runtime import continuous

    submit = continuous.ContinuousEngine.submit

    def spy(self, req):
        seen.append((self, req))
        return submit(self, req)

    continuous.ContinuousEngine.submit = spy
    try:
        yield
    finally:
        continuous.ContinuousEngine.submit = submit


@contextlib.contextmanager
def _window_spy(windows: list):
    """Record (T, start) of every admission-prefill window a
    ContinuousEngine runs (its run_chunked_prefill schedule) while the CLI
    runs."""
    from distributed_llama_tpu_torch.runtime import continuous

    schedule = continuous.run_chunked_prefill

    def spy(fwd, tokens, pos0, chunk, seq_len):
        def record(part, start):
            windows.append((len(part), start))
            return fwd(part, start)

        return schedule(record, tokens, pos0, chunk, seq_len)

    continuous.run_chunked_prefill = spy
    try:
        yield
    finally:
        continuous.run_chunked_prefill = schedule


def _cont_rows(out):
    """The [i] 'text' rows generate_continuous prints (not the done lines)."""
    return re.findall(r"^\[(\d+)\] (?!done:)(.*)$", out, re.M)


@contextlib.contextmanager
def _recorded_gaps(gaps: dict):
    """Record, for every host sample a ContinuousEngine's Sampler takes,
    the gap between the logits' two largest values and their largest
    |value|, in ``gaps[seed]`` (a request's sampler is seeded seed + its
    index)."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime import continuous

    base = continuous.Sampler

    class Recording(base):
        def __init__(self, vocab_size, temperature, topp, seed):
            super().__init__(vocab_size, temperature, topp, seed)
            self.gaps = gaps.setdefault(seed, [])

        def sample(self, logits):
            top = np.sort(np.asarray(logits, np.float32))[-2:]
            self.gaps.append((float(top[1] - top[0]),
                              float(np.abs(logits).max())))
            return super().sample(logits)

    continuous.Sampler = Recording
    try:
        yield
    finally:
        continuous.Sampler = base


@contextlib.contextmanager
def _checked_windows(seen: list):
    """Record, for every verify or mixed dispatch a ContinuousEngine runs,
    whether what came back is sound: ids inside the vocabulary (greedy) or
    finite logits (sampled)."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime import continuous

    run = continuous.ContinuousEngine._run_window

    def checked(self, kind, tokens, greedy_only):
        out = run(self, kind, tokens, greedy_only)
        seen.append(bool(((out >= 0) & (out < self.spec.vocab_size)).all()
                         if greedy_only else np.isfinite(out).all()))
        return out

    continuous.ContinuousEngine._run_window = checked
    try:
        yield
    finally:
        continuous.ContinuousEngine._run_window = run


def _gemm_launches(spec, t, calls):
    """K3's launches, with its parts, for ``calls`` forwards of T = t > 8
    flat rows (a verify or mixed window): 4L + 1 products a forward (the
    four layer matrices and wcls), one x split pass each and one split-K
    sum for each product gemm_tf32_plan splits."""
    import torch

    from distributed_llama_tpu_torch.ops import q40

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(spec.dim + 2 * spec.kv_dim, spec.dim), (spec.dim, spec.dim),
              (2 * spec.hidden_dim, spec.dim), (spec.dim, spec.hidden_dim)]
    split = [q40.gemm_tf32_plan(t, d, n // 32, sms)[0] > 1
             for d, n in shapes]
    wcls = q40.gemm_tf32_plan(t, spec.vocab_size, spec.dim // 32,
                              sms)[0] > 1
    n = 4 * spec.n_layers + 1
    return {"q40_gemm": n * calls, "q40_split_tf32": n * calls,
            "q40_gemm_bf16_reduce": (spec.n_layers * sum(split) + wcls)
            * calls}


def _flag(flags, name):
    return int(flags[flags.index(name) + 1]) if name in flags else 0


def phase_e2e_continuous(torch, model, tok, n_layers, label, flags,
                         gaps=None, prompts=CONT_PROMPTS):
    """Runs k-n and s-u: the 12 shared-prefix prompts through
    ``--prompts-file --continuous --slots 8 --prefill-chunk 32 --steps
    128`` and ``flags``. Exact launch counts from the engine's own step and
    chunk counts: the attention build the flags select (K5 contiguous, K6
    f32 or bf16 pages, K7 Q8 pages) L per device step; the products of a
    step's 8 rows (K1m 4L+1), or of a verify window's 8K rows or a mixed
    window's 8T rows (K3 4L+1 with its parts), per step; K3 4L and K4 (its
    bf16-cache build over bf16 pages) L per admission chunk with their
    parts by the plans of each chunk's (T, start) (none under
    --dispatch-tokens), every other kernel 0. Every request completes
    without error, every window's output is sound (ids in the vocabulary,
    or finite logits), the page audit is clean, and the steps are the
    graphs' warm-ups and replays. ``gaps`` records run k's host samples'
    top-2 logit gaps (_recorded_gaps). ``prompts`` (run k's by default)
    go into the prompts file; with the KV tier flags the tier books, the
    copy stream's ms a promoted page, the admission pause and the pinned
    bytes come back too."""
    paged = "--kv-page-size" in flags
    q8 = "q8" in flags
    bf16 = "bf16" in flags
    spec_k = _flag(flags, "--spec-k")
    budget = _flag(flags, "--dispatch-tokens")
    attn = ("decode_attention_batch" if not paged else "paged_attention_q8"
            if q8 else "paged_attention_kvbf16" if bf16
            else "paged_attention")
    if spec_k or budget:  # every device step a window: K6w or K7w
        attn = attn.replace("paged_attention", "paged_window")
    prefill = "prefill_attention" + ("_kvbf16" if bf16 else "")
    path = SMOKE_DIR / "continuous.txt"
    path.write_text("\n".join(prompts) + "\n")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seen, windows, sound = [], [], []
    with _engine_spy(seen), _window_spy(windows), _checked_windows(sound), \
            (_recorded_gaps(gaps) if gaps is not None
             else contextlib.nullcontext()):
        out, counts, wall, _ = _run_cli(torch, model, tok, [
            "--prompts-file", str(path), "--continuous", "--slots",
            str(CONT_SLOTS), "--prefill-chunk", str(CONT_CHUNK), "--steps",
            str(CONT_STEPS), "--temperature", "0", "--seed", "1", *flags])
    eng = seen[0][0]
    reqs = [r for _, r in seen]
    st = eng.stats
    width = spec_k or budget
    if width:
        want = _gemm_launches(eng.spec, CONT_SLOTS * width, st.steps)
        WINDOW_LAUNCHES[(attn, width)] = (
            WINDOW_LAUNCHES.get((attn, width), 0) + counts[attn])
    else:
        want = {"q40_matvec_multi": (4 * n_layers + 1) * st.steps}
    want[attn] = n_layers * st.steps
    if st.prefill_chunks:
        if len(windows) != st.prefill_chunks or any(
                t != CONT_CHUNK for t, _ in windows):
            raise AssertionError(f"{label} run: admission windows {windows}"
                                 f" for {st.prefill_chunks} chunks")
        for k, v in {"q40_gemm": 4 * n_layers * st.prefill_chunks,
                     prefill: n_layers * st.prefill_chunks,
                     **_prefill_parts(eng.spec, CONT_CHUNK,
                                      [p for _, p in windows], False,
                                      bf16)}.items():
            want[k] = want.get(k, 0) + v
    _expect(f"{label} run", counts, want)
    rows = _cont_rows(out)
    m = re.search(r"Generated tokens:\s+(\d+) across (\d+) requests "
                  r"\((\d+) slots, (\d+) steps\)", out)
    errors = [r.error for r in reqs if r.error or not r.done.is_set()]
    audit = eng.audit_pages()
    n_graphs = (len(eng._windows) if width else
                len(eng._chains) if eng.block_steps > 1 else 1)
    if (len(rows) != len(prompts) or int(m.group(2)) != len(reqs)
            or int(m.group(4)) != st.steps or errors or audit
            or eng.graph_replays + n_graphs != st.steps
            or not all(sound) or len(sound) != (st.steps if width else 0)):
        raise AssertionError(
            f"{label} run: {len(rows)} rows, {m.groups()}, errors {errors}, "
            f"audit {audit}, {eng.graph_replays} replays of {n_graphs} "
            f"graphs for {st.steps} steps, {sum(sound)} of {len(sound)} "
            f"windows sound")
    res = dict(flags=list(flags), requests=len(reqs), steps=st.steps,
               tokens=st.tokens, prefill_chunks=st.prefill_chunks,
               pauses=st.pauses, requeues=st.requeues,
               avg_active=st.avg_active, replays=eng.graph_replays,
               graphs=n_graphs, wall_s=wall, launches=counts,
               tokens_per_s=st.tokens_per_s,
               ms_per_token=st.total_ms / max(st.tokens, 1),
               ms_per_dispatch=st.total_ms / max(st.steps, 1),
               sampled_tokens=sum(r.n_sampled for r in reqs),
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               cache_bytes=sum(t.nbytes for t in eng.cache))
    if spec_k:
        sp = re.search(r"Speculative:\s+K=(\d+), (\d+)/(\d+) drafts "
                       r"accepted \((\d+)%\); ([\d.]+) ms/accepted token "
                       r"over (\d+) verify dispatches", out)
        if (not sp or int(sp.group(1)) != spec_k
                or int(sp.group(2)) != st.spec_accepted
                or int(sp.group(6)) != st.steps):
            raise AssertionError(f"{label} run: speculative line "
                                 f"{sp.groups() if sp else None}")
        res.update(spec_k=spec_k, spec_proposed=st.spec_proposed,
                   spec_accepted=st.spec_accepted,
                   accept_rate=st.spec_accept_rate,
                   ms_per_accepted_token=float(sp.group(5)))
    if budget:
        tb = re.search(r"Token budget:\s+(\d+) tokens/dispatch over (\d+) "
                       r"mixed dispatches", out)
        if (not tb or int(tb.group(1)) != budget
                or eng.dispatch_tokens != budget
                or int(tb.group(2)) != st.steps or st.prefill_chunks
                or set(eng._windows) != {("mixed", True)}
                or tuple(eng._windows[("mixed", True)].tokens.shape)
                != (CONT_SLOTS, budget)):
            raise AssertionError(f"{label} run: token budget line "
                                 f"{tb.groups() if tb else None}, "
                                 f"{st.prefill_chunks} admission chunks, "
                                 f"windows {list(eng._windows)}")
        res.update(dispatch_tokens=budget, overrun_steps=st.overrun_steps)
    a = eng.allocator
    if a is not None:
        res.update(n_pages=a.n_pages, page_bytes=res["cache_bytes"]
                   / (a.n_pages + 1), prefix_hits=a.prefix_hits,
                   hit_rate=a.hit_rate, tokens_saved=a.tokens_saved,
                   evictions=a.evictions)
        if a.tiered:
            io_ = eng.page_io
            tiers = re.search(r"KV tiers:\s+hbm (\d+) / host (\d+) / disk "
                              r"(\d+) pages; (\d+) demotions, (\d+) "
                              r"promotions", out)
            if (not tiers or int(tiers.group(4)) != sum(
                    a.demotions.values()) or int(tiers.group(5))
                    != sum(a.promotions.values())):
                raise AssertionError(f"{label} run: KV tiers line "
                                     f"{tiers.groups() if tiers else None}")
            res.update(
                demotions=dict(a.demotions), promotions=dict(a.promotions),
                tokens_saved_by_tier=dict(a.tokens_saved_by_tier),
                tier_pages=a.tier_page_counts(), crc_drops=a.crc_drops,
                promoted_pages=len(io_.upload_ms),
                promote_ms_per_page=(statistics.median(io_.upload_ms)
                                     if io_.upload_ms else None),
                promote_ms_max=max(io_.upload_ms, default=None),
                promote_ms_all=list(io_.upload_ms),
                demote_reads=io_.demotions,
                demote_ms_per_page=io_.demote_s * 1e3
                / max(io_.demotions, 1),
                promo_waits=st.promo_waits,
                promo_wait_ms=st.promo_wait_s * 1e3
                / max(st.promo_waits, 1),
                pinned_bytes=io_.pinned_bytes,
                device_used_gb=_device_used_gb(),
                allocated_gb=torch.cuda.memory_allocated() / 1e9)
    log(f"e2e {label}: {json.dumps(res)}")
    res["rows"] = [text for _, text in rows]
    res["outs"] = [list(r.out) for r in reqs]
    res["prompts"] = [list(r.tokens) for r in reqs]
    del eng, seen, reqs
    return res


def _near_tie_rows(label, got, want, gaps, ref="run k"):
    """Hold a greedy continuous run's token streams against run k's: each
    equal, or parting at a sampled position where run k's two largest
    logits lie within LOGIT_RTOL x max|logit| (the verify and mixed
    windows' products take K3 at 8K or 8T rows where run k's take K1m at
    8: their sums differ in the last bits). Returns the parting rows."""
    from distributed_llama_tpu_torch.models.llama import LOGIT_RTOL

    parted = []
    for i, (a, b, prompt) in enumerate(zip(got["outs"], want["outs"],
                                           want["prompts"])):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        m = j - (len(prompt) - 1)  # its index among the sampled tokens
        seed_gaps = gaps.get(1 + i, [])
        gap, top = seed_gaps[m] if 0 <= m < len(seed_gaps) else (
            float("inf"), 0.0)
        log(f"run {label}: request {i} parts from {ref}'s at token {j}, "
            f"where {ref}'s top-2 logit gap is {gap:.3e} (tolerance "
            f"{LOGIT_RTOL * top:.3e})")
        if not gap <= LOGIT_RTOL * top:
            raise AssertionError(f"run {label}: request {i} differs from "
                                 f"{ref}'s at token {j}, top-2 gap {gap} "
                                 f"above the logit tolerance")
        parted.append((i, j, gap))
    return parted


def phase_e2e_continuous_runs(torch, model, tok, n_layers):
    """Runs k-n and s-u. k: f32 pages of PAGE (K6), prefix hits > 0; l:
    run k without the page flags (contiguous, K5), its 12 streams equal to
    run k's; m: bf16 pages with 16-step chains (the bf16-page K6); n: Q8
    pages (K7) with 16-step chains, seeded sampling and a 32-page pool that
    pauses or requeues rows, with ~3.76x fewer bytes per page than run
    k's; s: run k with --spec-k SPEC_K (verify windows through K6w at
    t_len SPEC_K and K3 at 8 x SPEC_K rows), drafts accepted; t: run k with
    --dispatch-tokens MIXED_BUDGET (every dispatch one (8, MIXED_BUDGET)
    window through K6w and K3, no admission prefill); s's and t's streams
    equal run k's, or part at a near-tie of run k's top-2 logits; u: run n
    with --spec-k SPEC_K instead of the chains and --topp SPEC_TOPP (K7w
    over verify windows, seeded rejection sampling, the 32-page pool
    pausing or requeueing), drafts accepted; v: run m with --spec-k SPEC_K
    instead of its chains (K6w over bf16 pages), drafts accepted."""
    page = ("--kv-page-size", str(PAGE))
    gaps: dict = {}
    res = {
        "k": phase_e2e_continuous(torch, model, tok, n_layers, "k paged",
                                  page, gaps=gaps),
        "l": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "l contiguous", ()),
        "m": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "m bf16 pages", (*page, "--kv-cache-dtype",
                                                   "bf16", "--block-steps",
                                                   "16")),
        "n": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "n q8 pages", (*page, "--kv-quant", "q8",
                                                 "--block-steps", "16",
                                                 "--temperature", "0.8",
                                                 "--seed", "7", "--kv-pages",
                                                 "32")),
        "s": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "s speculative",
                                  (*page, "--spec-k", str(SPEC_K))),
        "t": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "t token budget",
                                  (*page, "--dispatch-tokens",
                                   str(MIXED_BUDGET))),
        "u": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "u speculative q8",
                                  (*page, "--kv-quant", "q8", "--spec-k",
                                   str(SPEC_K), "--temperature", "0.8",
                                   "--topp", str(SPEC_TOPP), "--seed", "7",
                                   "--kv-pages", "32")),
        "v": phase_e2e_continuous(torch, model, tok, n_layers,
                                  "v speculative bf16 pages",
                                  (*page, "--kv-cache-dtype", "bf16",
                                   "--spec-k", str(SPEC_K))),
    }
    k, n, s_, t, u, v = (res[x] for x in "knstuv")
    same = sum(a == b for a, b in zip(k["rows"], res["l"]["rows"]))
    ratio = k["page_bytes"] / n["page_bytes"]
    log(f"continuous: run k's streams equal run l's in {same} of "
        f"{len(CONT_PROMPTS)} rows; prefix hits {k['prefix_hits']} "
        f"({k['tokens_saved']} prefill tokens saved); run n: "
        f"{n['pauses']} pauses, {n['requeues']} requeues, "
        f"{ratio:.3f}x fewer bytes per page than run k")
    if same != len(CONT_PROMPTS) or k["prefix_hits"] <= 0:
        raise AssertionError("run k: streams differ from run l's, or no "
                             "prefix hit")
    if n["pauses"] + n["requeues"] <= 0 or not 3.7 <= ratio <= 3.8:
        raise AssertionError(f"run n: no pause or requeue, or page bytes "
                             f"{ratio:.3f}x below run k's, not ~3.76x")
    s_["parted"] = _near_tie_rows("s", s_, k, gaps)
    t["parted"] = _near_tie_rows("t", t, k, gaps)
    log(f"speculative (run s, K={SPEC_K}): {s_['spec_accepted']}/"
        f"{s_['spec_proposed']} drafts accepted "
        f"({s_['accept_rate']:.1%}), {s_['steps']} verify dispatches "
        f"against run k's {k['steps']} steps; "
        f"{s_['ms_per_accepted_token']:.3f} ms/accepted token against run "
        f"k's {k['ms_per_token']:.3f} ms/token; {s_['ms_per_dispatch']:.3f}"
        f" ms a verify dispatch against run k's {k['ms_per_dispatch']:.3f} "
        f"ms a step; {len(s_['parted'])} rows part at a near-tie")
    log(f"token budget (run t, T={MIXED_BUDGET}): {t['steps']} mixed "
        f"dispatches of {t['ms_per_dispatch']:.3f} ms against run k's "
        f"{k['steps']} steps of {k['ms_per_dispatch']:.3f} ms and "
        f"{k['prefill_chunks']} admission chunks; {t['ms_per_token']:.3f} "
        f"ms/token against {k['ms_per_token']:.3f}; {len(t['parted'])} rows"
        f" part at a near-tie")
    log(f"speculative q8 (run u): {u['spec_accepted']}/{u['spec_proposed']}"
        f" drafts accepted ({u['accept_rate']:.1%}), {u['pauses']} pauses, "
        f"{u['requeues']} requeues, {u['steps']} verify dispatches")
    log(f"speculative bf16 pages (run v): {v['spec_accepted']}/"
        f"{v['spec_proposed']} drafts accepted ({v['accept_rate']:.1%}), "
        f"{v['steps']} verify dispatches of {v['ms_per_dispatch']:.3f} ms")
    if min(s_["spec_accepted"], u["spec_accepted"], v["spec_accepted"]) <= 0:
        raise AssertionError("runs s, u and v: no draft accepted")
    if u["pauses"] + u["requeues"] <= 0:
        raise AssertionError("run u: no pause or requeue")
    ref_k = {"outs": k["outs"], "prompts": k["prompts"]}
    for r in res.values():
        for key in ("rows", "outs", "prompts"):
            r.pop(key)
    ref_k["run"] = k
    return res, ref_k, gaps


# --------------------------------------------------------------------------
# serve_full_width: the HTTP server over the continuous engine
# --------------------------------------------------------------------------

SERVE_LONG = 6            # drain: long requests in flight at the SIGTERM
SERVE_LONG_STEPS = 256    # their positions (~180 sampled tokens each)
SERVE_BURST = 8           # requests inside the POST /profile window
SERVE_PROFILE_S = 3.0     # that capture's seconds
SERVE_WATCHDOG_MS = 60000  # generous: no dispatch near it, the loop armed
SERVE_DEVICE_ARGS: tuple = ()  # the serve child's extra flags (none here)
# the kernels line's names by their trace events' base names
SERVE_KERNELS = {"paged_attention": "paged_attention_kernel",
                 "q40_matvec_multi": "q40_matvec_multi_kernel",
                 "q40_gemm": "q40_gemm_kernel",
                 "prefill_attention": "prefill_attention_kernel",
                 "q40_matvec": "q40_matvec_kernel"}
SERVE_EVENTS: dict[str, int] = {}  # kernel name -> events in the trace


class _Served:
    """``python -m distributed_llama_tpu_torch serve`` as a child process
    with run k's engine flags on --port 0 (and ``extra`` flags after
    them): its output read on a thread, the bound port from its 🌐 line,
    JSON and NDJSON calls over HTTP, and SIGTERM. Killed at exit if still
    running."""

    def __init__(self, model, tok, where: Path, extra=()):
        import atexit
        import threading

        argv = [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
                "--model", str(model), "--tokenizer", str(tok),
                "--slots", str(CONT_SLOTS), "--kv-page-size", str(PAGE),
                "--prefill-chunk", str(CONT_CHUNK), "--steps",
                str(CONT_STEPS), "--temperature", "0", "--seed", "1",
                "--port", "0", "--journal", str(where / "journal.wal"),
                "--flightrec", str(where / "flightrec"), "--watchdog-ms",
                str(SERVE_WATCHDOG_MS), "--drain-s", "0.5",
                *SERVE_DEVICE_ARGS, *extra]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self.port = None
        self.ready = threading.Event()

        def read():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip("\n"))
                m = re.search(r"🌐 serving on http://[^:]+:(\d+) ", line)
                if m:
                    self.port = int(m.group(1))
                    self.ready.set()
            self.ready.set()

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        atexit.register(self.kill)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def wait_ready(self, timeout: float) -> float:
        """Seconds from the start to the 🌐 serving line."""
        if not self.ready.wait(timeout) or self.port is None:
            self.kill()
            raise AssertionError("serve never printed its 🌐 line: "
                                 + "\n".join(self.lines[-30:]))
        return time.perf_counter() - self.t0

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def get(self, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self.url(path), timeout=120) as r:
            return r.read()

    def post(self, path: str, obj: dict, stream_to: list | None = None):
        """POST a JSON body: the decoded reply, or with ``stream_to`` the
        NDJSON lines appended there as they arrive (the last one
        returned)."""
        import urllib.request

        rq = urllib.request.Request(self.url(path),
                                    data=json.dumps(obj).encode(),
                                    headers={"Content-Type":
                                             "application/json"})
        with urllib.request.urlopen(rq, timeout=600) as r:
            if stream_to is None:
                return json.loads(r.read())
            last = None
            for line in r:
                last = json.loads(line)
                stream_to.append(last)
            return last

    def generate(self, prompt: str, steps: int, stream: bool,
                 lines: list | None = None) -> list[int]:
        """One greedy request's tokens (the prompt's echo included)."""
        body = {"prompt": prompt, "steps": steps, "temperature": 0.0,
                "stream": stream}
        if not stream:
            out = self.post("/generate", body)
            return out["tokens"]
        lines = [] if lines is None else lines
        last = self.post("/generate", body, stream_to=lines)
        if not last.get("done") or "error" in last:
            raise AssertionError(f"stream ended with {last}")
        return [ln["token"] for ln in lines if "token" in ln]

    def stop(self, timeout: float = 120.0) -> tuple[int, float]:
        """SIGTERM; (exit code, seconds to exit)."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError("serve did not exit after SIGTERM")
        dt = time.perf_counter() - t0
        self.reader.join(10)
        return rc, dt


def _concurrently(fns) -> list:
    """Run each callable on a thread of its own; their results in order
    (the first exception raised here)."""
    import threading

    out: list = [None] * len(fns)
    errs: list = []

    def one(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # re-raised below, on this thread
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _prom_value(text: str, name: str) -> float:
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    if not m:
        raise AssertionError(f"/metrics has no {name}")
    return float(m.group(1))


def _device_used_gb() -> float:
    """Device memory in use on the card (every process), nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except OSError:
        return float("nan")
    return float(out.stdout.split()[0]) / 1024 if out.returncode == 0 \
        else float("nan")


def phase_serve(torch, model, tok, ref_k, gaps, smi):
    """serve_full_width: the port's ``serve`` on the 7B file at full width
    and depth, as a child process with run k's engine flags, --port 0, a
    journal, a flight recorder and a generous watchdog. Run k's 12 prompts
    from concurrent clients, every other one streamed, greedy: each
    response equals run k's stream for that prompt or parts from it only
    at a near-tie of run k's top-2 logits; /health reads serving, schema
    3, with its paged_kv, slo and watch blocks; /metrics has the request
    lifecycle families and a TTFT count of 12; /debug/timeline validates
    as a Chrome trace. Then POST /profile over a burst of SERVE_BURST
    requests: its trace holds K6, K1m and K3 events (kernels the server
    ran on the card), logged per kernel. Then SERVE_LONG streamed long
    requests, SIGTERM while they are in flight: exit 0, every one of them
    live in the journal, and the drain's flight-recorder bundle valid;
    the server restarted on the same journal says "recovered N", finishes
    them (the replayed tokens through K3/K4 admission prefill), and their
    journaled streams equal an uninterrupted in-process run of the same
    requests, or part only at a near-tie of its top-2 logits."""
    import shutil

    where = SMOKE_DIR / "serve"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    served: list[_Served] = []
    try:
        return _serve_run(torch, model, tok, ref_k, gaps, smi, where,
                          served)
    except BaseException:
        for i, srv in enumerate(served):  # what each server said
            for line in srv.lines[-40:]:
                log(f"serve child {i}: {line}")
        raise


def _serve_run(torch, model, tok, ref_k, gaps, smi, where, served):
    """phase_serve's body; ``served`` collects the children it starts."""
    import threading

    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.obs.flightrec import load_bundle
    from distributed_llama_tpu_torch.obs.spans import validate_chrome_trace
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine
    from distributed_llama_tpu_torch.runtime.journal import load_journal
    from distributed_llama_tpu_torch.utils import it_split

    res: dict = {}
    used = []
    srv = _Served(model, tok, where)
    served.append(srv)
    res["start_s"] = srv.wait_ready(600)
    # 1. run k's 12 prompts, concurrent, every other one streamed
    t0 = time.perf_counter()
    outs = _concurrently([
        (lambda i=i: srv.generate(CONT_PROMPTS[i], CONT_STEPS,
                                  stream=i % 2 == 1))
        for i in range(len(CONT_PROMPTS))])
    wall = time.perf_counter() - t0
    used.append(_device_used_gb())
    parted = _near_tie_rows("serve", {"outs": outs}, ref_k, gaps)
    n_sampled = sum(len(o) - (len(p) - 1)
                    for o, p in zip(outs, ref_k["prompts"]))
    health = json.loads(srv.get("/health"))
    metrics = srv.get("/metrics").decode()
    timeline = json.loads(srv.get("/debug/timeline"))
    validate_chrome_trace(timeline)
    missing = [b for b in ("paged_kv", "slo", "watch", "sched")
               if b not in health]
    if (health.get("state") != "serving" or health.get("schema") != 3
            or missing):
        raise AssertionError(f"serve /health: state {health.get('state')},"
                             f" schema {health.get('schema')}, missing "
                             f"{missing}")
    families = [f for f in ("dllama_request_ttft_seconds",
                            "dllama_request_queue_wait_seconds",
                            "dllama_request_decode_token_seconds",
                            "dllama_requests_total",
                            "dllama_engine_step_duration_seconds")
                if f"# TYPE {f} " not in metrics]
    ttft_n = _prom_value(metrics, "dllama_request_ttft_seconds_count")
    if families or ttft_n != len(CONT_PROMPTS):
        raise AssertionError(f"serve /metrics: missing {families}, TTFT "
                             f"count {ttft_n}")
    steps_n = _prom_value(metrics, "dllama_engine_step_duration_seconds_count")
    step_ms = _prom_value(metrics, "dllama_engine_step_duration_seconds_sum"
                          ) / max(steps_n, 1) * 1e3
    k = ref_k["run"]
    k_decode_tps = k["sampled_tokens"] / (k["tokens"] * k["ms_per_token"]
                                          / 1e3)
    res.update(requests=len(outs), wall_s=wall, sampled_tokens=n_sampled,
               decode_tokens_per_s=n_sampled / wall,
               run_k_decode_tokens_per_s=k_decode_tps,
               ttft_s=health["ttft_s"], ms_per_dispatch=step_ms,
               dispatches=steps_n, parted=parted,
               timeline_events=len(timeline["traceEvents"]))
    log(f"serve ({smi}): {len(outs)} requests from concurrent clients in "
        f"{wall:.3f} s, {n_sampled / wall:.1f} decode tokens/s served "
        f"against run k's {k_decode_tps:.1f}; {len(parted)} rows part at a "
        f"near-tie")
    log(f"serve ({smi}): TTFT p50 {health['ttft_s']['p50']:.4f} s, p95 "
        f"{health['ttft_s']['p95']:.4f} s")
    cost = health["sched"]["cost_totals"]
    res["cost_totals"] = cost
    log(f"serve ({smi}): {step_ms:.3f} ms a dispatch on the scheduler's "
        f"clock over {steps_n:.0f} dispatches (run k: "
        f"{k['ms_per_dispatch']:.3f} ms a step on the host's clock); the "
        f"ledgers' dispatch seconds {cost['dispatch_s']:.3f}, admission "
        f"prefill seconds {cost['prefill_s']:.3f} of the {wall:.3f} s wall")
    # 2. POST /profile over a burst
    prof_dir = where / "profile"
    reply = srv.post("/profile", {"seconds": SERVE_PROFILE_S,
                                  "dir": str(prof_dir)})
    t_prof = time.perf_counter()
    _concurrently([(lambda i=i: srv.generate(CONT_PROMPTS[i], CONT_STEPS,
                                             stream=i % 2 == 0))
                   for i in range(SERVE_BURST)])
    burst_s = time.perf_counter() - t_prof
    trace = None
    while time.perf_counter() - t_prof < SERVE_PROFILE_S + 120:
        files = sorted(prof_dir.glob("*.pt.trace.json"))
        if files:
            try:
                trace = it_split.parse_trace(str(prof_dir))
                break
            except (ValueError, OSError):
                pass  # still being written
        time.sleep(0.5)
    if trace is None:
        raise AssertionError(f"POST /profile {reply}: no trace in "
                             f"{prof_dir}")
    dev = [v for key, v in trace.items() if key.startswith("/device:")]
    events = {name: sum(v.counts.get(base, 0) for v in dev)
              for name, base in SERVE_KERNELS.items()}
    SERVE_EVENTS.update(events)
    log(f"serve POST /profile ({SERVE_PROFILE_S} s over {SERVE_BURST} "
        f"requests in {burst_s:.3f} s): kernel events {events}")
    idle = [n for n in ("paged_attention", "q40_matvec_multi", "q40_gemm")
            if not events[n]]
    if idle:
        raise AssertionError(f"serve: no {idle} events in the POST /profile"
                             f" trace")
    res.update(profile=dict(seconds=SERVE_PROFILE_S, burst_s=burst_s,
                            events=events))
    # 3. SIGTERM with long requests in flight
    tokenizer = Tokenizer(str(tok), 32000)
    prompts = [tokenizer.encode(CONT_PROMPTS[i]) for i in range(SERVE_LONG)]
    streams = [[] for _ in range(SERVE_LONG)]

    def long(i):
        try:
            srv.post("/generate", {"prompt": CONT_PROMPTS[i], "steps":
                                   SERVE_LONG_STEPS, "temperature": 0.0,
                                   "stream": True}, stream_to=streams[i])
        except OSError:
            pass  # the server went away: the journal carries the rest

    clients = [threading.Thread(target=long, args=(i,))
               for i in range(SERVE_LONG)]
    for t in clients:
        t.start()
    t_wait = time.perf_counter()
    while not all(len(st) >= len(p) - 1 + 8
                  for st, p in zip(streams, prompts)):
        if time.perf_counter() - t_wait > 120:
            raise AssertionError("serve: the long requests never streamed")
        time.sleep(0.02)
    used.append(_device_used_gb())
    rc, term_s = srv.stop()
    for t in clients:
        t.join(30)
    entries = load_journal(str(where / "journal.wal"))
    live = [e for e in entries if e.status is None]
    if rc != 0 or len(live) < 4 or any(not e.sampled for e in live):
        raise AssertionError(f"serve SIGTERM: exit {rc}, {len(live)} live "
                             f"journal entries")
    bundles = sorted((where / "flightrec").glob("*sigterm_drain*.json"))
    if not bundles:
        raise AssertionError("serve: the drain wrote no flight-recorder "
                             "bundle")
    bundle = load_bundle(str(bundles[0]))  # validate_bundle inside
    log(f"serve ({smi}): SIGTERM to exit {term_s:.3f} s, exit {rc}; "
        f"{len(live)} requests live in the journal; bundle "
        f"{bundles[0].name} valid ({len(bundle.get('spans', []))} spans)")
    # 4. restart on the journal
    srv2 = _Served(model, tok, where)
    served.append(srv2)
    srv2.wait_ready(600)
    t_first = None
    while True:
        h = json.loads(srv2.get("/health"))
        if t_first is None and h["steps"] >= 1:
            t_first = time.perf_counter() - srv2.t0
        if t_first is not None and h["active"] == 0 and h["queued"] == 0:
            break
        if time.perf_counter() - srv2.t0 > 600:
            raise AssertionError("serve restart: the recovered requests "
                                 "never finished")
        time.sleep(0.05)
    used.append(_device_used_gb())
    said = [ln for ln in srv2.lines if "🌐 recovered" in ln]
    rc2, _ = srv2.stop()
    if rc2 != 0 or not said or f"recovered {len(live)} journaled" \
            not in said[0]:
        raise AssertionError(f"serve restart: exit {rc2}, lines {said}")
    after = load_journal(str(where / "journal.wal"))
    recovered = []
    for e in live:
        new = [n for n in after if n.status == "done"
               and n.tokens == e.replay_tokens]
        if len(new) != 1:
            raise AssertionError(f"serve restart: request {e.rid} has "
                                 f"{len(new)} finished lives")
        recovered.append(new[0].tokens[1:] + new[0].sampled)
    # 5. the uninterrupted run of the same requests, in this process
    spec, host = load_model(str(model), weights_float_type=FloatType.Q40)
    eng = ContinuousEngine(spec, host, CONT_SLOTS, 0.0, 0.9, 1,
                           page_size=PAGE, prefill_chunk=CONT_CHUNK,
                           device="cuda")
    del host
    ref_gaps: dict = {}
    live_prompts = [e.tokens for e in live]
    with _recorded_gaps(ref_gaps):
        ref_outs, _ = eng.run(live_prompts, SERVE_LONG_STEPS)
    del eng
    rparted = _near_tie_rows("serve recovery", {"outs": recovered},
                             {"outs": ref_outs, "prompts": live_prompts},
                             ref_gaps, ref="the uninterrupted run")
    res.update(sigterm_to_exit_s=term_s, journaled=len(live),
               restart_to_first_token_s=t_first,
               recovered=len(recovered), recovery_parted=rparted,
               bundle=bundles[0].name, device_used_gb=used,
               peak_device_used_gb=max(used))
    log(f"serve ({smi}): restart to the first recovered token "
        f"{t_first:.3f} s; {len(recovered)} recovered streams, "
        f"{len(rparted)} part from the uninterrupted run at a near-tie")
    log(f"serve ({smi}): device memory in use (nvidia-smi, every process) "
        f"{', '.join(f'{u:.2f}' for u in used)} GB, peak "
        f"{max(used):.2f} GB")
    log(f"e2e serve: {json.dumps(res)}")
    return res


# --------------------------------------------------------------------------
# tier_full_width and disagg_full_width: the KV tiers and prefill/decode
# disaggregation at full width and depth
# --------------------------------------------------------------------------

TIER_PAGES = 40        # the pool: 8 slots x 4 own pages + the shared 4
TIER_HOST = 24         # --kv-host-pages of the host-only runs
TIER_SMALL_HOST = 2    # and of the runs that spill on to disk
DISAGG_PAGES = 256     # each disaggregated child's pool
CHANNEL_PAGES = 16     # 7B f32 pages of 16 through the localhost channel


def phase_tier(torch, model, tok, n_layers, ref_k, gaps, smi):
    """tier_full_width: run k's flags with two waves of run k's 12 prompts
    (24 requests) and ``--kv-pages TIER_PAGES``: the first wave's cold
    prompt pages demote when later admissions need pages, and the second
    wave re-hits them (promotions). Four runs: ``--kv-host-pages
    TIER_HOST`` alone, and ``--kv-host-pages TIER_SMALL_HOST --kv-disk-dir
    D`` (pages reach disk), each over f32 pages and over Q8 pages. The f32
    runs' streams equal run k's for both waves (a near-tie parting
    allowed: a deeper share moves the suffix prefill's windows); both
    waves of each Q8 run equal one untiered greedy Q8 run with run k's
    flags (near-tie by that run's gaps);
    demotions and promotions above 0 (disk ones in the disk runs), the
    three-tier audit clean (phase_e2e_continuous holds it), prefill tokens
    saved by tier; logged: ms a promoted page on the copy stream's
    events, the admission pause, pinned bytes, device memory in use."""
    import shutil

    page = ("--kv-page-size", str(PAGE), "--kv-pages", str(TIER_PAGES))
    prompts = CONT_PROMPTS + CONT_PROMPTS
    n = len(CONT_PROMPTS)
    # the Q8 runs' reference: run k's flags over Q8 pages, untiered
    q8_gaps: dict = {}
    ref_q8 = phase_e2e_continuous(
        torch, model, tok, n_layers, "tier ref q8",
        ("--kv-page-size", str(PAGE), "--kv-quant", "q8"), gaps=q8_gaps)
    res = {"ref_q8": {k: v for k, v in ref_q8.items()
                      if k not in ("outs", "prompts", "rows")}}
    for kind in ("host", "disk"):
        for quant in ("f32", "q8"):
            label = f"tier {kind} {quant}"
            disk = SMOKE_DIR / "kvdisk" / f"{kind}-{quant}"
            shutil.rmtree(disk, ignore_errors=True)
            tier = (("--kv-host-pages", str(TIER_HOST)) if kind == "host"
                    else ("--kv-host-pages", str(TIER_SMALL_HOST),
                          "--kv-disk-dir", str(disk)))
            r = phase_e2e_continuous(
                torch, model, tok, n_layers, label,
                (*page, *tier, *(("--kv-quant", "q8") if quant == "q8"
                                 else ())), prompts=prompts)
            outs = r.pop("outs")
            r.pop("prompts"), r.pop("rows")
            want, want_gaps, ref = ((ref_k, gaps, "run k") if quant == "f32"
                                    else (ref_q8, q8_gaps, "the untiered "
                                          "Q8 run"))
            r["parted"] = [
                row for wave in (outs[:n], outs[n:])
                for row in _near_tie_rows(label, {"outs": wave}, want,
                                          want_gaps, ref=ref)]
            dem, prom = r["demotions"], r["promotions"]
            saved = r["tokens_saved_by_tier"]
            if (sum(dem.values()) <= 0 or sum(prom.values()) <= 0
                    or saved["host"] + saved["disk"] <= 0
                    or (kind == "disk" and (dem["disk"] <= 0
                                            or prom["disk"] <= 0))
                    or (kind == "host" and dem["host"] <= 0)):
                raise AssertionError(f"{label}: demotions {dem}, "
                                     f"promotions {prom}, saved {saved}")
            log(f"{label} ({smi}): demotions {dem}, promotions {prom}, "
                f"prefill tokens saved by tier {saved}; "
                f"{r['promote_ms_per_page']:.4f} ms a promoted page on the "
                f"copy stream (median of {r['promoted_pages']}, max "
                f"{r['promote_ms_max']:.4f}; in order "
                f"{[round(x, 4) for x in r['promote_ms_all']]}), "
                f"{r['demote_ms_per_page']:.4f} ms a demotion read (host "
                f"clock, mean of {r['demote_reads']}), admission pause "
                f"{r['promo_wait_ms']:.3f} ms over {r['promo_waits']} "
                f"waits; {r['pinned_bytes'] / 1e6:.1f} MB pinned; device "
                f"memory in use {r['device_used_gb']:.2f} GB (nvidia-smi), "
                f"{r['allocated_gb']:.2f} GB allocated; "
                f"{len(r['parted'])} rows part at a near-tie")
            res[f"{kind}_{quant}"] = r
    return res


def _channel_rate(torch, spec):
    """The page channel over localhost: CHANNEL_PAGES 7B f32 pages of PAGE
    positions published and fetched (CRC-checked, acked) through
    runtime/page_channel; GB/s of payload. Loopback, not a network."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime.page_channel import (
        PageChannelClient, PageChannelServer)
    from distributed_llama_tpu_torch.runtime.pagewire import encode_record

    rng = np.random.default_rng(0)
    shape = (spec.n_layers, PAGE, spec.n_kv_heads, spec.head_size)
    plane = rng.standard_normal(shape, dtype=np.float32)
    records = [encode_record((plane, plane)) for _ in range(CHANNEL_PAGES)]
    nbytes = CHANNEL_PAGES * 2 * plane.nbytes
    server = PageChannelServer()
    try:
        client = PageChannelClient(f"127.0.0.1:{server.port}")
        secs = []
        for i in range(3):
            server.publish(f"bench{i}", records)
            t0 = time.perf_counter()
            got = client.fetch(f"bench{i}", len(records))
            secs.append(time.perf_counter() - t0)
            if len(got) != CHANNEL_PAGES or any(g is None for g in got):
                raise AssertionError("page channel bench: pages lost")
    finally:
        server.close()
    return dict(pages=CHANNEL_PAGES, bytes=nbytes,
                seconds=statistics.median(secs),
                gb_per_s=nbytes / statistics.median(secs) / 1e9,
                link="localhost loopback (not a network)")


def phase_disagg(torch, model, tok, spec, ref_k, gaps, smi, serve_res):
    """disagg_full_width: two ``serve`` children share the card, run k's
    engine flags with pools of DISAGG_PAGES: one ``--disagg-role
    prefill`` (its page channel on localhost), one ``--disagg-role decode
    --disagg-peer`` it. Run k's 12 prompts go to the decode server, every
    one streamed: each stream equals run k's (a near-tie parting allowed);
    the decode server's handoffs are 12 shipped and none local or failed;
    the pages and payload bytes the prefill server shipped equal the sum
    of comm_stats.dcn_handoff_budget over the prompts. Logged: the page
    channel's GB/s over localhost (labelled so), the client-side TTFT p50
    and p95 (POST to the first sampled token's line) and the decode
    server's /health TTFT beside serve_full_width's. Then the prefill
    child is killed: the same 12 prompts again, served locally (verdict
    failed), with the same streams."""
    import shutil

    where = SMOKE_DIR / "disagg"
    shutil.rmtree(where, ignore_errors=True)
    (where / "prefill").mkdir(parents=True)
    (where / "decode").mkdir(parents=True)
    served: list[_Served] = []
    try:
        return _disagg_run(torch, model, tok, spec, ref_k, gaps, smi,
                           serve_res, where, served)
    except BaseException:
        for i, srv in enumerate(served):
            for line in srv.lines[-40:]:
                log(f"disagg child {i}: {line}")
        raise
    finally:
        for srv in served:
            srv.kill()


def _disagg_run(torch, model, tok, spec, ref_k, gaps, smi, serve_res,
                where, served):
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        dcn_handoff_budget
    from distributed_llama_tpu_torch.parallel.mesh import free_port

    pool = ("--kv-pages", str(DISAGG_PAGES))
    pre_port = free_port()
    pre = _Served(model, tok, where / "prefill",
                  extra=(*pool, "--port", str(pre_port), "--disagg-role",
                         "prefill", "--page-channel-port", "0"))
    served.append(pre)
    dec = _Served(model, tok, where / "decode",
                  extra=(*pool, "--disagg-role", "decode", "--disagg-peer",
                         f"127.0.0.1:{pre_port}"))
    served.append(dec)
    res: dict = {"start_s": [pre.wait_ready(600), dec.wait_ready(600)]}
    if pre.port != pre_port:
        raise AssertionError(f"prefill child bound {pre.port}, not "
                             f"{pre_port}")
    deadline = time.perf_counter() + 60
    while True:  # each banner follows its child's 🌐 serving line
        banner = [ln for ln in pre.lines + dec.lines if "disagg role" in ln]
        if len(banner) == 2 or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    if len(banner) != 2:
        raise AssertionError(f"disagg: role banners {banner}")

    def timed(i):
        """One streamed request: its tokens and the client's seconds from
        the POST to the first sampled token's line."""
        lines: list = []
        n_pre = len(ref_k["prompts"][i]) - 1
        t0 = time.perf_counter()
        box = {}

        def watch():
            while "first" not in box and "done" not in box:
                if len([ln for ln in lines if "token" in ln]) > n_pre:
                    box["first"] = time.perf_counter() - t0
                time.sleep(0.001)

        import threading

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        try:
            toks = dec.generate(CONT_PROMPTS[i], CONT_STEPS, stream=True,
                                lines=lines)
        finally:
            box["done"] = True
            w.join(5)
        return toks, box.get("first", time.perf_counter() - t0)

    t0 = time.perf_counter()
    got = _concurrently([(lambda i=i: timed(i))
                         for i in range(len(CONT_PROMPTS))])
    wall = time.perf_counter() - t0
    outs = [g[0] for g in got]
    ttft = sorted(g[1] for g in got)
    parted = _near_tie_rows("disagg", {"outs": outs}, ref_k, gaps)
    dec_metrics = dec.get("/metrics").decode()
    pre_metrics = pre.get("/metrics").decode()
    verdicts = {v: _prom_value(dec_metrics, f'dllama_handoff_requests_total'
                               f'{{verdict="{v}"}}')
                for v in ("shipped", "local", "failed")}
    pages = _prom_value(pre_metrics, "dllama_dcn_pages_shipped_total")
    nbytes = _prom_value(pre_metrics, "dllama_dcn_bytes_total")
    budgets = [dcn_handoff_budget(spec, 1, len(p) - 1, PAGE)
               for p in ref_k["prompts"]]
    want_pages = sum(b["pages"] for b in budgets)
    want_bytes = sum(b["bytes"] for b in budgets)
    dec_health = json.loads(dec.get("/health"))
    pre_health = json.loads(pre.get("/health"))
    n = len(CONT_PROMPTS)
    if (verdicts != {"shipped": n, "local": 0, "failed": 0}
            or pages != want_pages or nbytes != want_bytes
            or dec_health["disagg"]["pages_adopted"] <= 0
            or pre_health["disagg"]["handoff_queue_depth"] != 0):
        raise AssertionError(
            f"disagg: verdicts {verdicts}, pages {pages} (budget "
            f"{want_pages}), bytes {nbytes} (budget {want_bytes}), "
            f"health {dec_health['disagg']} {pre_health['disagg']}")
    hs = _prom_value(dec_metrics, "dllama_handoff_seconds_sum")
    channel = _channel_rate(torch, spec)
    used = _device_used_gb()

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    res.update(requests=n, wall_s=wall, verdicts=verdicts,
               pages_shipped=pages, bytes_shipped=nbytes,
               budget_pages=want_pages, budget_bytes=want_bytes,
               pages_adopted=dec_health["disagg"]["pages_adopted"],
               handoff_s_mean=hs / n, parted=parted,
               client_ttft_s={"p50": pct(ttft, 0.5), "p95": pct(ttft, 0.95)},
               decode_health_ttft_s=dec_health["ttft_s"],
               serve_health_ttft_s=serve_res["ttft_s"], channel=channel,
               device_used_gb=used)
    log(f"disagg ({smi}): {n} requests through the decode server in "
        f"{wall:.3f} s, handoffs {verdicts}, {pages:.0f} pages and "
        f"{nbytes:.0f} B shipped (the budget's {want_pages} and "
        f"{want_bytes}), {hs / n:.3f} s a handoff (decode server: POST "
        f"/prefill to the pages fetched); {len(parted)} rows part at a "
        f"near-tie")
    log(f"disagg ({smi}): client TTFT p50 {pct(ttft, 0.5):.4f} s, p95 "
        f"{pct(ttft, 0.95):.4f} s (POST to the first sampled token's "
        f"line); decode /health TTFT p50 {dec_health['ttft_s']['p50']:.4f} "
        f"s (from its re-admission); serve_full_width's /health TTFT p50 "
        f"{serve_res['ttft_s']['p50']:.4f} s, p95 "
        f"{serve_res['ttft_s']['p95']:.4f} s")
    log(f"disagg: page channel {channel['gb_per_s']:.3f} GB/s over "
        f"{channel['link']}: {channel['pages']} 7B f32 pages "
        f"({channel['bytes']} B) in {channel['seconds']:.3f} s; device "
        f"memory in use {used:.2f} GB (nvidia-smi, both children)")
    # the prefill pool dies: the decode server serves locally
    pre.kill()
    again = _concurrently([
        (lambda i=i: dec.generate(CONT_PROMPTS[i], CONT_STEPS,
                                  stream=i % 2 == 1))
        for i in range(n)])
    dec_metrics = dec.get("/metrics").decode()
    failed = _prom_value(dec_metrics,
                         'dllama_handoff_requests_total{verdict="failed"}')
    local_parted = _near_tie_rows("disagg peer down", {"outs": again},
                                  ref_k, gaps)
    rc, _ = dec.stop()
    if failed != n or rc != 0:
        raise AssertionError(f"disagg peer down: {failed} failed "
                             f"handoffs, decode exit {rc}")
    res.update(peer_down=dict(failed=failed, parted=local_parted))
    log(f"disagg ({smi}): prefill child killed; {n} requests served "
        f"locally (verdict failed {failed:.0f}), {len(local_parted)} rows "
        f"part at a near-tie; decode exit {rc}")
    log(f"e2e disagg: {json.dumps(res)}")
    return res


# --------------------------------------------------------------------------
# chaos_full_width: fault injection in the served engine, the drill suite
# at 7B width, its mutation arms, and the load gate's sweep on the card
# --------------------------------------------------------------------------

CHAOS_EVERY, CHAOS_DELAY_MS, CHAOS_DENIALS = 8, 50, 4
CHAOS_SPEC = (f"step_delay_every={CHAOS_EVERY},step_delay_ms="
              f"{CHAOS_DELAY_MS},deny_pages={CHAOS_DENIALS}")
CHAOS_DEPTH = 4     # the drills' 7B-wide engines: the first 4 layers
CHAOS_PAGES = 40    # their pool: 8 slots x 8 pages of 16, oversubscribed
# the mutation arms, each on its drill, with the violation it must raise
CHAOS_ARMS = {"leak-on-cancel": ("disconnect", "leaked"),
              "drop-on-demote": ("tier_spill_storm", "dropped its bytes"),
              "drop-page-in-flight": ("kill_mid_handoff", "diverged"),
              "corrupt-journal": ("kill_mid_decode", "JournalCorruption")}


def _loadcheck_child(device: str) -> subprocess.Popen:
    """``python -m distributed_llama_tpu_torch.tools.loadcheck --sweep-only
    --json`` on ``device``, its output collected by the caller."""
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_llama_tpu_torch.tools.loadcheck",
         "--sweep-only", "--json", "--device", device], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _loadcheck_row(child: subprocess.Popen, label: str) -> tuple[int, dict]:
    try:
        out, err = child.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise AssertionError(f"loadcheck {label} did not finish in 300 s")
    lines = out.strip().splitlines()
    if child.returncode not in (0, 1) or not lines:
        raise AssertionError(f"loadcheck {label} exited "
                             f"{child.returncode}: {err[-2000:]}")
    return child.returncode, json.loads(lines[-1])


def _chaos_factory(spec, params, arm=None):
    """The drills' fresh-engine factory at 7B width: run k's 8 slots,
    pages of 16, chunk 32, greedy, CHAOS_PAGES pages, on the card; with
    ``arm`` leak-on-cancel or drop-on-demote armed on whatever monkey the
    drill brings (loadcheck's injection)."""
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.runtime.chaos import arm_mutations
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    def make(chaos=None, **overrides):
        chaos = arm_mutations(chaos, arm == "leak-on-cancel",
                              arm == "drop-on-demote")
        kw = dict(slots=CONT_SLOTS, temperature=0.0, topp=0.9, seed=1,
                  metrics=Registry(), prefill_chunk=CONT_CHUNK,
                  page_size=PAGE, kv_pages=CHAOS_PAGES, device="cuda")
        kw.update(overrides)
        return ContinuousEngine(spec, params, chaos=chaos, **kw)

    return make


def phase_chaos(torch, model, tok, spec, ref_k, gaps, smi, serve_res):
    """chaos_full_width. (a) ``serve --chaos CHAOS_SPEC`` as a child on the
    7B file at full width and depth with run k's engine flags, a journal
    and a 60 s watchdog: the 🔶 CHAOS ARMED banner on stderr, run k's 12
    prompts from concurrent clients each equal to run k's stream or
    parting only at a near-tie, /health serving, /metrics parsing (every
    sample line); the faults must have reached the engine: /health's
    requeues plus pauses at least CHAOS_DENIALS (the serve phase's pool
    never runs dry, so only a denial requeues or pauses), and ms a
    dispatch at least serve_full_width's plus half the injected mean
    (CHAOS_DELAY_MS / CHAOS_EVERY); TTFT p50/p95 and ms a dispatch logged
    beside serve_full_width's. (b) The whole
    drill suite through runtime/chaos.run_drills, every drill green: the
    factory's engines at 7B width from the Q40 file cut to CHAOS_DEPTH
    layers and 128 positions (run k's 8 slots, pages of 16, chunk 32,
    greedy), the process drills at their fixed small specs, all on the
    card; every kernel's count set to 0 just before and read just after.
    (c) The four mutation arms, each on its drill: red, with its
    violation. (d) loadcheck --sweep-only --json on the card and on the
    CPU, started in the background once (a)'s server has stopped, so (a)
    is timed alone and the sweeps run beside (b) and (c): the card's row
    logged beside the CPU row; a point outside the baseline band is
    reported (a near-tie may move a greedy stream), a crash or a usage
    error fails."""
    import dataclasses
    import shutil

    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.models.llama import params_to_device
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.runtime.chaos import (
        render_drill_table, run_drills, scrape_problems)

    t_phase = time.perf_counter()
    where = SMOKE_DIR / "chaos"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    res: dict = {}
    # (a) the chaos-armed server
    srv = _Served(model, tok, where, extra=("--chaos", CHAOS_SPEC))
    try:
        res["start_s"] = srv.wait_ready(600)
        banner = [ln for ln in srv.lines if "🔶 CHAOS ARMED" in ln]
        if not banner or CHAOS_SPEC not in banner[0]:
            raise AssertionError(f"serve --chaos: no banner in "
                                 f"{srv.lines[:20]}")
        t0 = time.perf_counter()
        outs = _concurrently([
            (lambda i=i: srv.generate(CONT_PROMPTS[i], CONT_STEPS,
                                      stream=i % 2 == 1))
            for i in range(len(CONT_PROMPTS))])
        wall = time.perf_counter() - t0
        parted = _near_tie_rows("serve --chaos", {"outs": outs}, ref_k,
                                gaps)
        health = json.loads(srv.get("/health"))
        text = srv.get("/metrics").decode()

        class _Text:
            def expose(self):
                return text

        problems = scrape_problems(_Text())
        steps_n = _prom_value(text, "dllama_engine_step_duration_seconds_"
                              "count")
        step_ms = _prom_value(text, "dllama_engine_step_duration_seconds_"
                              "sum") / max(steps_n, 1) * 1e3
        if health.get("state") != "serving" or problems:
            raise AssertionError(f"serve --chaos: state "
                                 f"{health.get('state')}, /metrics "
                                 f"{problems[:3]}")
        denied = health.get("requeues", 0) + health.get("pauses", 0)
        floor_ms = (serve_res["ms_per_dispatch"]
                    + 0.5 * CHAOS_DELAY_MS / CHAOS_EVERY)
        if denied < CHAOS_DENIALS or step_ms < floor_ms:
            raise AssertionError(
                f"serve --chaos: the faults did not reach the engine: "
                f"requeues {health.get('requeues')} + pauses "
                f"{health.get('pauses')} < {CHAOS_DENIALS} denials, or "
                f"{step_ms:.3f} ms a dispatch < {floor_ms:.3f}")
        rc, _ = srv.stop()
        if rc != 0:
            raise AssertionError(f"serve --chaos exited {rc}")
    except BaseException:
        for line in srv.lines[-40:]:
            log(f"chaos serve child: {line}")
        raise
    finally:
        srv.kill()
    sweeps = {d: _loadcheck_child(d) for d in ("cuda", "cpu")}
    res["serve"] = dict(requests=len(outs), wall_s=wall, parted=parted,
                        ttft_s=health["ttft_s"], ms_per_dispatch=step_ms,
                        dispatches=steps_n, pauses=health.get("pauses"),
                        requeues=health.get("requeues"),
                        serve_ttft_s=serve_res["ttft_s"],
                        serve_ms_per_dispatch=serve_res["ms_per_dispatch"])
    log(f"chaos serve ({smi}): --chaos {CHAOS_SPEC}: {len(outs)} requests "
        f"in {wall:.3f} s, {len(parted)} rows part from run k at a "
        f"near-tie; TTFT p50 {health['ttft_s']['p50']:.4f} s, p95 "
        f"{health['ttft_s']['p95']:.4f} s (serve_full_width: "
        f"{serve_res['ttft_s']['p50']:.4f}, "
        f"{serve_res['ttft_s']['p95']:.4f}); {step_ms:.3f} ms a dispatch "
        f"over {steps_n:.0f} (serve_full_width: "
        f"{serve_res['ms_per_dispatch']:.3f}); requeues "
        f"{health.get('requeues')}, pauses {health.get('pauses')} "
        f"({CHAOS_DENIALS} denials injected); timed with no other process "
        f"on the card")
    # (b) the drill suite at 7B width, CHAOS_DEPTH layers
    cut = _tp_depth_model(spec, model, CHAOS_DEPTH)
    dspec, host = load_model(str(cut), weights_float_type=FloatType.Q40)
    dspec = dataclasses.replace(dspec, seq_len=CONT_STEPS)
    params = params_to_device(host, "cuda")
    del host
    log(f"chaos drills: engines at 7B width (dim {dspec.dim}, hidden "
        f"{dspec.hidden_dim}, {dspec.n_heads} heads), depth cut to "
        f"{dspec.n_layers} layers and {dspec.seq_len} positions; the "
        f"process drills at their fixed small specs; all on the card")
    free0 = torch.cuda.mem_get_info()[0]
    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    results = run_drills(_chaos_factory(dspec, params),
                         device="cuda")
    drills_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in _all_kernels()}
    _add_cli_launches(launches)
    torch.cuda.synchronize()
    free1 = torch.cuda.mem_get_info()[0]
    log("chaos drills:\n" + render_drill_table(results))
    red = [(r.name, r.violations) for r in results if not r.passed]
    if red or len(results) != 12:
        raise AssertionError(f"chaos drills red on the card: {red}")
    handoff = next(r for r in results if r.name == "kill_mid_handoff")
    log(f"chaos drills ({smi}): 12 green in {drills_s:.1f} s, beside the "
        f"two loadcheck sweeps; launches "
        f"{ {k: v for k, v in launches.items() if v} }; kill_mid_handoff "
        f"memory (bytes; memory_allocated is the whole process's) "
        f"{handoff.details.get('memory', 'not measured')}; the card's "
        f"free memory "
        f"{free0 / 1e9:.2f} GB before the suite, {free1 / 1e9:.2f} GB after "
        f"(1e9 bytes; the SIGKILLed recovery child's gone)")
    # (c) the mutation arms
    arms = {}
    for arm, (drill, want) in CHAOS_ARMS.items():
        inject = ({arm} if arm in ("corrupt-journal", "drop-page-in-flight")
                  else None)
        got = run_drills(_chaos_factory(dspec, params, arm),
                         which={drill}, inject=inject, device="cuda")[0]
        text = " ".join(got.violations)
        if got.passed or want not in text:
            raise AssertionError(f"chaos arm {arm}: drill {drill} "
                                 f"{'green' if got.passed else 'red'}, "
                                 f"violations {got.violations}")
        arms[arm] = dict(drill=drill, violations=got.violations)
        log(f"chaos arm {arm}: {drill} red ({text[:160]})")
    del params
    # (d) the load gate's sweep, card beside CPU
    rows = {d: _loadcheck_row(child, d) for d, child in sweeps.items()}
    (rc_gpu, gpu), (rc_cpu, cpu) = rows["cuda"], rows["cpu"]
    if rc_cpu != 0:
        raise AssertionError(f"loadcheck on the CPU: {cpu['gate']}")
    if rc_gpu != 0 and not all("baseline band" in f
                               for f in gpu["gate"]["failures"]):
        raise AssertionError(f"loadcheck on the card: {gpu['gate']}")
    sweep = [(g["rate"], g["goodput_tps"], c["goodput_tps"])
             for g, c in zip(gpu["sweep"], cpu["sweep"])]
    differ = [s for s in sweep if s[1] != s[2]]
    log(f"chaos loadcheck ({smi}): goodput by rate (card, CPU) {sweep}; "
        f"card gate {gpu['gate']['verdict']} {gpu['gate']['failures']}; "
        f"{len(differ)} points differ")
    res.update(drills={r.name: r.details for r in results},
               drills_s=drills_s, launches=launches, arms=arms,
               free_gb=[free0 / 1e9, free1 / 1e9],
               loadcheck=dict(card=gpu["sweep"], cpu=cpu["sweep"],
                              card_gate=gpu["gate"], differ=differ),
               seconds=time.perf_counter() - t_phase)
    log(f"chaos_full_width: {res['seconds']:.1f} s")
    log(f"e2e chaos: {json.dumps(res, default=str)}")
    return res


# --------------------------------------------------------------------------
# phase 4: kernels against plain at full width, end to end
# --------------------------------------------------------------------------

def phase_full_width(torch, model, tok, peaks, ref, card0, sim_mem):
    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.runtime.generate import Engine

    spec, host = load_model(str(model), weights_float_type=FloatType.Q40)
    torch.cuda.synchronize()
    blocks0 = active_blocks(torch)
    engine = Engine(spec, host, "cuda")
    torch.cuda.synchronize()
    load = blocks_since(torch, blocks0)  # analysis_full_width (a)
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
    host_now = host_reading(torch)
    prefill = prefill_full_width(torch, engine, plain,
                                 tokenizer.encode(PROMPT_512), peaks)
    prefill["host"] = host_now
    prefill["flag_runs"] = flag_runs(torch, engine, tokenizer)
    prefill["fast"] = prefill_fast_full_width(
        torch, engine, tokenizer.encode(PROMPT_512), peaks)
    fast = fast_full_width(torch, engine, tokenizer, ref)
    fast["capture_reading"] = capture_reading(torch, engine, tokenizer)
    batch = batch_full_width(torch, engine)
    continuous = continuous_full_width(torch, engine, tokenizer, batch)
    gc.collect()
    torch.cuda.empty_cache()
    analysis = phase_analysis(torch, engine, tokenizer, load, card0,
                              sim_mem)
    return worst, busy, prefill, fast, batch, continuous, analysis


def host_reading(torch):
    """What the host-bound walls depend on, read just before the prefill
    timings: the cores this process may use, the load average, and the
    host's side of a launch: the median over 5 rounds of 2000 back-to-back
    launches of a one-element add, in µs a launch (the card runs them far
    faster than they are issued)."""
    x = torch.zeros(1, device="cuda")
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            x.add_(1.0)
        rounds.append((time.perf_counter() - t0) / 2000 * 1e6)
    torch.cuda.synchronize()
    res = dict(cores=len(os.sched_getaffinity(0)),
               load_avg=os.getloadavg(), launch_us=statistics.median(rounds))
    log(f"host: {json.dumps(res)}")
    return res


def _with_fusion(engine, mode):
    """``engine`` as an Engine built under DLLAMA_LAYER_FUSION=``mode``
    holds it: its model rebuilt with that mode over the same weights, the
    same cache, its own decode loops ('off' is ``engine`` itself)."""
    import copy

    from distributed_llama_tpu_torch.models import llama

    if mode == "off":
        return engine
    fused = copy.copy(engine)
    fused.model = llama.Llama(engine.spec, engine.params, engine.model.route,
                              mode)
    fused._loops = {}
    return fused


TIMED_MODES = ("off", "headtail", "on")


def fast_full_width(torch, engine, tokenizer, ref):
    """--fast and the host loop at full width under each fusion mode:
    generate and generate_fast of run a's prompt and STEPS greedy steps on
    the same weights and cache, one first run of each pair (which captures
    the graph; its stream held against run a's, ``ref``; a host loop's
    first run is timed too), then timed in turns: --fast off / headtail /
    on and back, the host loop off / headtail and back (medians of the
    mean ms/token). Then one
    generate_fast per mode under torch.profiler: device time and kernels
    per step, read against the unprofiled ms/token (the busy share), and
    the kernel launches each replay makes."""
    from distributed_llama_tpu_torch.runtime.generate import (generate,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    engines = {mode: _with_fusion(engine, mode) for mode in TIMED_MODES}

    def run(mode, fast):
        e = engines[mode]
        e.reset()
        fn = generate_fast if fast else generate
        out, stats = fn(e, tokenizer, Sampler(32000, 0.0, 0.9, 1), PROMPT,
                        STEPS, quiet=True)
        torch.cuda.synchronize()
        return out, stats.total_ms / stats.tokens

    pairs = [("off", False), ("off", True), ("headtail", False),
             ("headtail", True), ("on", True)]
    equal = {}
    ms = {pair: [] for pair in pairs}
    for mode, fast in pairs:
        got, t = run(mode, fast)
        equal[f"{mode} {'fast' if fast else 'host'}"] = _same_stream(
            f"full width {mode} {'--fast' if fast else 'host loop'}", got,
            *ref)[0]
        if not fast:  # nothing to capture: the first host run is timed too
            ms[mode, fast].append(t)
    for pair in [("off", True), ("headtail", True), ("headtail", False),
                 ("on", True), ("on", True), ("headtail", True),
                 ("off", True), ("off", False)]:
        ms[pair].append(run(*pair)[1])
    med = {pair: statistics.median(t) for pair, t in ms.items()}
    res = {"steps": STEPS, "streams_equal": equal}
    for mode in TIMED_MODES:
        loop = engines[mode].decode_loop(0.0, 0.9)
        replays = loop.replays
        dev, prof_ms = _profiled(torch, lambda: run(mode, True), STEPS)
        if loop.replays - replays != STEPS:
            raise AssertionError(f"{mode}: the fused loop replayed its graph "
                                 f"{loop.replays - replays} times, not "
                                 f"{STEPS}")
        dev_ms = sum(m for _, m, _ in dev)
        per_replay = {k.symbol: n for k, n in
                      loop._graphed._per_replay.items()}
        fast_ms = med[mode, True]
        res[mode] = dict(
            fast_ms_per_token=fast_ms, fast_runs_ms=ms[mode, True],
            device_ms_per_step=dev_ms,
            kernels_per_step=sum(c for *_, c in dev),
            busy=dev_ms / fast_ms if dev_ms else None,
            profiled_ms_per_token=prof_ms, launches_per_replay=per_replay,
            top=[dict(kernel=k[:80], ms=m, count=c) for k, m, c in dev[:6]])
        if (mode, False) in med:
            res[mode].update(host_ms_per_token=med[mode, False],
                             host_runs_ms=ms[mode, False])
        log(f"--fast {mode}, {STEPS} greedy 7B steps in turns: "
            f"{fast_ms:.3f} ms/token (runs "
            f"{', '.join(f'{t:.3f}' for t in ms[mode, True])})"
            + (f"; host loop {med[mode, False]:.3f} ms/token (runs "
               f"{', '.join(f'{t:.3f}' for t in ms[mode, False])})"
               if (mode, False) in med else "")
            + f"; captured step device time {dev_ms:.4f} ms over "
            f"{sum(c for *_, c in dev):.0f} kernels (busy "
            f"{dev_ms / fast_ms:.1%} of the unprofiled step); launches per "
            f"replay {per_replay}")
        for key, m, count in dev[:6]:
            log(f"  {m:8.4f} ms/step  x{count:5.0f}  {key[:90]}")
    # the keys PR 4's readers know: the unfused pair
    res.update(fast_ms_per_token=med["off", True],
               host_ms_per_token=med["off", False])
    return res


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


CONT_CASES = {  # label -> engine options over the full-width weights
    "contiguous": {},
    "f32 pages": {"page_size": PAGE},
    "bf16 pages": {"page_size": PAGE, "cache_dtype": "bf16"},
    "q8 pages": {"page_size": PAGE, "kv_quant": "q8"},
}
# verify and mixed dispatches over f32 pages; their pools hold what 8 slots
# of CONT_STEPS positions use (1.07 GB, not the default 17.2): every engine
# lives through the turns
WINDOW_CASES = {
    "spec-k 4": {"page_size": PAGE, "spec_k": SPEC_K,
                 "kv_pages": CONT_SLOTS * CONT_STEPS // PAGE},
    "dispatch-tokens 39": {"page_size": PAGE,
                           "dispatch_tokens": MIXED_BUDGET,
                           "kv_pages": CONT_SLOTS * CONT_STEPS // PAGE},
}
CONT_CASES.update(WINDOW_CASES)


def continuous_full_width(torch, engine, tokenizer, batch):
    """Continuous throughput at full width: 16 requests (the shared-prefix
    prompts, cycled) through 8 slots, CONT_STEPS positions each, admission
    prefill at CONT_CHUNK, fused chains of 16 captured steps, greedy, for
    the contiguous cache and f32, bf16 and Q8 pages, and over f32 pages
    verify dispatches (spec_k SPEC_K) and mixed ones (dispatch_tokens
    MIXED_BUDGET; one engine each over the same device weights). Each
    engine captures its graphs first (ContinuousEngine.capture_graphs,
    in place of a warm-up run), then one timed run of each, the window
    cases last, whose streams give the f32-page against contiguous
    equality; then one run of each under torch.profiler for the device
    time, read against its unprofiled wall: the busy share, and the
    share of K3 with its parts. The lockstep batch of the same call
    stands beside it."""
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    reqs = [tokenizer.encode(CONT_PROMPTS[i % len(CONT_PROMPTS)])
            for i in range(16)]
    n_prompt = sum(len(r) - 1 for r in reqs)
    engines = {}
    for label, opts in CONT_CASES.items():
        opts = dict(opts)
        if opts.get("cache_dtype"):
            opts["cache_dtype"] = torch.bfloat16
        engines[label] = ContinuousEngine(
            engine.spec, engine.params, CONT_SLOTS, 0.0, 0.9, 1,
            prefill_chunk=CONT_CHUNK, block_steps=16, **opts)

    def run(label):
        outs, st = engines[label].run(reqs, CONT_STEPS)
        return outs, dict(ms=st.total_ms, steps=st.steps, tokens=st.tokens,
                          decode_tokens=sum(len(o) for o in outs) - n_prompt,
                          avg_active=st.avg_active, pauses=st.pauses,
                          requeues=st.requeues)

    for eng in engines.values():
        eng.capture_graphs()
    runs, streams = {}, {}
    for label in engines:  # the window cases last (CONT_CASES' order)
        streams[label], row = run(label)
        runs[label] = [row]
    if streams["f32 pages"] != streams["contiguous"]:
        raise AssertionError("continuous full width: the f32-page streams "
                             "differ from the contiguous engine's")
    res = {}
    for label, eng in engines.items():
        mid = sorted(runs[label], key=lambda r: r["ms"])[0]
        ms = statistics.median(r["ms"] for r in runs[label])
        dev, prof_ms = _profiled(torch, lambda: run(label), mid["steps"],
                                 host=False)
        dev_ms = sum(m for _, m, _ in dev)
        paged = sum(m for k, m, _ in dev if "paged_attention" in k
                    or "paged_window" in k or "decode_attention" in k)
        gemm = sum(m for k, m, _ in dev if "q40_gemm" in k
                   or "q40_split_tf32" in k)
        row = dict(ms=ms, runs_ms=[r["ms"] for r in runs[label]],
                   steps=mid["steps"], ms_per_step=ms / mid["steps"],
                   tokens=mid["tokens"], decode_tokens=mid["decode_tokens"],
                   tokens_per_s=mid["tokens"] / ms * 1e3,
                   decode_tokens_per_s=mid["decode_tokens"] / ms * 1e3,
                   avg_active=mid["avg_active"],
                   device_ms_per_step=dev_ms,
                   attention_ms_per_step=paged, k3_ms_per_step=gemm,
                   busy=dev_ms * mid["steps"] / ms if dev_ms else None,
                   cache_bytes=sum(t.nbytes for t in eng.cache),
                   replays=eng.graph_replays)
        log(f"continuous {label}: 16 requests through {CONT_SLOTS} slots in "
            f"{ms:.1f} ms (runs {', '.join(f'{r:.1f}' for r in row['runs_ms'])}"
            f"), {row['steps']} device steps, {row['ms_per_step']:.3f} "
            f"ms/step, {row['decode_tokens_per_s']:.0f} decode tokens/s "
            f"({row['tokens_per_s']:.0f} with the prompt echoes), "
            f"avg_active {row['avg_active']:.2f}; device "
            f"{dev_ms:.3f} ms/step (attention {paged:.3f}, K3 with its "
            f"parts {gemm:.3f}), busy "
            f"{row['busy'] or 0:.1%} ({prof_ms:.3f} ms/step under the "
            f"profiler); cache {row['cache_bytes'] / 1e9:.3f} GB")
        for key, m, count in dev[:8]:
            log(f"  {m:8.4f} ms/step  x{count:5.0f}  {key[:90]}")
        res[label] = row
    res["lockstep_tokens_per_s"] = {body: r["tokens_per_s"]
                                    for body, r in batch.items()}
    engines.clear()
    return res


def _prefill_bounds(spec, n_tokens, peaks, bf16=False):
    """(matmul bound ms, attention bound ms) of prefilling n_tokens at
    CHUNK: the 4 layer matrices of every layer at T = CHUNK per chunk, and
    the prefill attention's bound per layer and chunk (as phase_k4 counts
    it); the operations at the bf16 rate under ``bf16`` (K3b, K4b), else as
    3 TF32 passes (K3, K4 over an f32 cache)."""
    hs, n_q, n_kv = spec.head_size, spec.n_heads, spec.n_kv_heads
    passes = 1 if bf16 else 3
    mm = att = 0.0
    for pos in range(0, n_tokens, CHUNK):
        for _, d, n in LAYER_SHAPES:
            nbytes = d * (n // 32) * 18 + CHUNK * (n + d) * 4
            mm += bound(nbytes, passes * 2.0 * CHUNK * d * n, peaks, bf16,
                        not bf16)[0] * spec.n_layers
        live = pos + CHUNK
        nbytes = 2 * live * n_kv * hs * 4 + 2 * CHUNK * n_q * hs * 4
        row_keys = CHUNK * pos + CHUNK * (CHUNK + 1) // 2
        att += bound(nbytes, passes * 4.0 * n_q * hs * row_keys, peaks,
                     bf16, not bf16)[0] * spec.n_layers
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
            f"tokens/s; bound {mm_bound:.2f} ms of matmuls (3 TF32 passes) "
            f"+ {att_bound:.3f} ms of attention")
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


def _profiled(torch, fn, n, host=True):
    """Run ``fn`` (n units of work) once under torch.profiler, tracing the
    host's ops too unless ``host`` is False. Returns ([(kernel, device ms
    per unit, launches per unit)], slowest first, and the profiled wall ms
    per unit). Device entries only (kernels, copies, fills), summed by name
    straight from the trace's raw events: key_averages() first builds a
    Python object per event, seconds for every 100k events, and a
    continuous run traces ~150k kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3 / n
    totals = {}  # name -> [device ns, launches]
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.duration_ns() > 0):
            t = totals.setdefault(e.name(), [0, 0])
            t[0] += e.duration_ns()
            t[1] += 1
    dev = sorted(((key, ns / 1e6 / n, count / n)
                  for key, (ns, count) in totals.items()),
                 key=lambda r: -r[1])
    return dev, prof_ms


def profile_prefill(torch, engine, tokens, wall_ms):
    """Where a prefill's time goes in situ: one Engine.prefill of ``tokens``
    at CHUNK under torch.profiler, its device time split into the Q40 GEMM
    (K3 with its x split and split-K sum, or K3b with its x rounding and
    split-K sum), the prefill attention (K4 or K4b with its split combine)
    and the rest (the torch glue), each read against ``wall_ms``, the
    unprofiled wall time of the same call. Returns None when the trace
    holds no device time."""
    dev, prof_ms = _profiled(torch, lambda: engine.prefill(tokens, 0, CHUNK),
                             1)
    dev_ms = sum(ms for _, ms, _ in dev)
    if dev_ms == 0:
        log("prefill profile: the profiler traced no device time")
        return None
    split = {"q40_gemm": [0.0, 0.0], "prefill_attention": [0.0, 0.0],
             "other": [0.0, 0.0]}
    for key, ms, count in dev:
        # K3's and K3b's kernels and their parts (the x pass, the split-K
        # sum) all carry q40_gemm in their names; K4's and K4b's (and their
        # combines) prefill_attention
        part = next((p for p in ("q40_gemm", "prefill_attention")
                     if p in key), "other")
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


# --------------------------------------------------------------------------
# tensor parallelism end to end: tp_full_width
# --------------------------------------------------------------------------

TP_PREFILL = 16  # the tp runs' prefill chunk: K3 and K4 over the bands
TP_STEPS = 28    # run a's prompt: 19 prefilled positions, 9 decode steps
TP_RUNS = {  # label -> (tp, scheme, extra flags); TP_DEPTH layers at 7B
    "t2 fused": (2, "fused", ["--prefill-chunk", str(TP_PREFILL)]),
    "t2 ref": (2, "ref", ["--prefill-chunk", str(TP_PREFILL)]),
    "t2 q80": (2, "fused", ["--buffer-float-type", "q80", "--prefill-chunk",
                            str(Q80_CHUNK)]),
    "t4 fused": (4, "fused", ["--prefill-chunk", str(TP_PREFILL)]),
}
TP_DEPTH = 4   # layers of the 7B-wide model of every tp, serve --tp, sp run
TP_ROWS = 4    # its lockstep rows, and the continuous engine's slots
TP_REQS = 6    # the continuous engine's requests (CONT_PROMPTS[:6])
# the tp configurations run at TP_DEPTH layers through the CLI, at tp 2
# (fused, gloo ranks sharing the card) and at tp 1, their streams equal:
# label -> (flags after the model's, env, the kernel of its own it must
# launch at tp 2); {batch} and {cont} are the prompts files. With the tp
# runs above they launch every kernel of the unfused path at tp 2: K2 and
# K4 over a bf16 cache; K3b and K4b; K1d and K5 over a bf16 cache; K3b,
# K4b and K6 over bf16 pages; K7
TP_FLAG_RUNS = {
    "kv bf16": (["--prompt", PROMPT, "--steps", str(TP_STEPS),
                 "--prefill-chunk", str(TP_PREFILL), "--kv-cache-dtype",
                 "bf16"], {}, "decode_attention_kvbf16"),
    "fast-prefill": (["--prompt", PROMPT, "--steps", str(TP_STEPS),
                      "--prefill-chunk", str(TP_PREFILL), "--fast-prefill"],
                     {}, "q40_gemm_bf16"),
    "dequant bf16-cache": (["--prompts-file", "{batch}", "--steps", "24",
                            "--kv-cache-dtype", "bf16"],
                           {"DLLAMA_MULTI_T_BODY": "dequant"},
                           "q40_matvec_bf16"),
    "bf16 pages fast-prefill": (["--prompts-file", "{cont}", "--continuous",
                                 "--slots", str(TP_ROWS), "--prefill-chunk",
                                 str(CONT_CHUNK), "--fast-prefill",
                                 "--steps", "96", "--kv-page-size",
                                 str(PAGE), "--kv-cache-dtype", "bf16"], {},
                                "paged_attention_kvbf16"),
    "q8 pages": (["--prompts-file", "{cont}", "--continuous", "--slots",
                  str(TP_ROWS), "--prefill-chunk", str(CONT_CHUNK),
                  "--steps", "96", "--kv-page-size", str(PAGE),
                  "--kv-quant", "q8"], {}, "paged_attention_q8"),
}
# the verify and mixed windows at tp 2 under fused and ref (a flag run's
# own --tp-scheme comes after the loop's), their census per dispatch held
# to the budget (_window_census)
for _scheme in ("fused", "ref"):
    for _label, _flags in (("spec-k", ["--spec-k", str(SPEC_K)]),
                           ("dispatch-tokens",
                            ["--dispatch-tokens", str(MIXED_BUDGET)])):
        TP_FLAG_RUNS[f"{_label} {_scheme}"] = (
            ["--prompts-file", "{cont}", "--continuous", "--slots",
             str(TP_ROWS), "--prefill-chunk", str(CONT_CHUNK), "--steps",
             "96", "--kv-page-size", str(PAGE), *_flags, "--tp-scheme",
             _scheme], {}, "paged_window")
WINDOW_FLAG_RUNS = [label for label in TP_FLAG_RUNS
                    if label.startswith(("spec-k", "dispatch-tokens"))]
# what the single card cannot run: gloo refuses send/recv of CUDA tensors
# (the overlap scheme's ring hops), and a CUDA graph cannot capture gloo's
# host-side collectives (over NCCL one hung: not yet ported)
TP_WAITS = ("--tp-scheme overlap (its ring hops are send/recv pairs, which "
            "gloo refuses for CUDA tensors)",
            "NCCL, one GPU a rank",
            "--fast and the captured batch and continuous steps under tp "
            "(a CUDA graph cannot capture gloo, and a capture over NCCL "
            "hung in a 4-card run: not yet ported)")


def _tp_depth_model(spec, model, depth=TP_DEPTH):
    """The smoke model's first ``depth`` layers as a .bin of their own: its
    header with the depth, its embedding and layers 0..depth-1, then
    its tail (final norm, the legacy RoPE gap, wcls), copied byte for
    byte."""
    import dataclasses

    from distributed_llama_tpu_torch.models.spec import HEADER_BYTES

    cut = dataclasses.replace(spec, n_layers=depth)
    path = SMOKE_DIR / f"{Path(model).stem}_L{depth}.bin"
    head = spec.vocab_size * spec.dim * 4 + depth * spec.block_bytes()
    tail = spec.file_size() - (HEADER_BYTES + spec.vocab_size * spec.dim * 4
                               + spec.n_layers * spec.block_bytes())
    tmp = path.with_suffix(".tmp")
    with open(model, "rb") as src, open(tmp, "wb") as dst:
        dst.write(cut.header())
        src.seek(HEADER_BYTES)
        dst.write(src.read(head))
        src.seek(spec.file_size() - tail)
        dst.write(src.read(tail))
    if tmp.stat().st_size != cut.file_size():
        raise AssertionError(f"{tmp}: {tmp.stat().st_size} bytes, want "
                             f"{cut.file_size()}")
    tmp.replace(path)
    return path


def _tp_steps(torch, group, path, tok):
    """The lockstep batch (generate_batch: K1m and K5 over the rank's kv
    heads) and the continuous engine over f32 pages (K6; admission
    prefill through K3 and K4) at TP_DEPTH layers of 7B width, eager
    (graph=False: gloo cannot be captured); ``group`` None: one device.
    Returns the rows, the requests' outputs and each part's launches."""
    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.parallel.tp import load_model_bands
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine
    from distributed_llama_tpu_torch.runtime.generate import generate_batch

    if group is None:
        spec, params = load_model(str(path),
                                  weights_float_type=FloatType.Q40)
        batch_kw, cont_kw = {}, {}
    else:
        spec, params = load_model_bands(str(path), group.rank, group.size,
                                        "fused", FloatType.Q40)
        batch_kw = dict(group=group, scheme="fused")
        cont_kw = dict(mesh=group, scheme="fused")
    tokenizer = Tokenizer(str(tok), spec.vocab_size)
    res = {}
    for k in _all_kernels():
        k.launches = 0
    res["rows"], _ = generate_batch(
        spec, params, tokenizer, BATCH_PROMPTS[:TP_ROWS], 48, 0.0, 0.9, 1,
        device="cuda", quiet=True, graph=False, **batch_kw)
    res["batch_launches"] = {k.symbol: k.launches for k in _all_kernels()
                             if k.launches}
    for k in _all_kernels():
        k.launches = 0
    eng = ContinuousEngine(spec, params, TP_ROWS, 0.0, 0.9, 1,
                           prefill_chunk=CONT_CHUNK, page_size=PAGE,
                           device="cuda", graph=False, **cont_kw)
    reqs = [tokenizer.encode(p, bos=True, eos=False)
            for p in CONT_PROMPTS[:TP_REQS]]
    res["outs"], stats = eng.run(reqs, 96)
    res["cont_steps"] = stats.steps
    res["cont_launches"] = {k.symbol: k.launches for k in _all_kernels()
                            if k.launches}
    return res


def _tp_flag_argv(label, depth_model, tok, paths):
    """The CLI flags of TP_FLAG_RUNS[label] over the depth model."""
    flags, env, _ = TP_FLAG_RUNS[label]
    return ["--model", str(depth_model), "--tokenizer", str(tok),
            "--temperature", "0", "--seed", "1",
            *[f.format(**paths) for f in flags]], env


def _tp_text(out):
    """What a run printed of its tokens: the 🔶 pieces and the [i] rows."""
    return _pieces(out), _cont_rows(out)


def _tp_cli(cli, argv, group, env, streams):
    """cmd_inference(argv) with ``group`` and ``env``, every kernel's count
    set to 0 just before and read just after: (rc, stdout, launches,
    wall s, the generated tokens of a single-prompt run)."""
    import torch

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    streams.clear()
    for k in _all_kernels():
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.cmd_inference(argv, group=group)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc and group.world_rank:  # rank 0 reports its own; another stops all
        raise RuntimeError(f"rank {group.rank}: {argv} exited {rc}")
    return dict(rc=rc, out=buf.getvalue(), wall_s=time.perf_counter() - t0,
                stream=streams[0] if streams else None,
                launches={k.symbol: k.launches for k in _all_kernels()
                          if k.launches})


@contextlib.contextmanager
def _window_census(records: list):
    """Record, for every verify or mixed dispatch a tensor-parallel
    ContinuousEngine runs, its collectives (parallel/collectives.CENSUS,
    reset just before) beside comm_stats.tp_collective_budget at t_len =
    the window's rows: {kind: (count, bytes)} each."""
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        tp_collective_budget
    from distributed_llama_tpu_torch.runtime import continuous

    step = continuous.ContinuousEngine._window_step

    def counted(self, kind, w):
        C.CENSUS.reset()
        step(self, kind, w)
        want = tp_collective_budget(self.spec, self.group.size,
                                    self.model.scheme,
                                    t_len=w.tokens.numel())
        records.append(({k: tuple(v) for k, v in C.CENSUS.counts.items()},
                        {k: (c, b) for k, c, b in want.entries}))

    continuous.ContinuousEngine._window_step = counted
    try:
        yield
    finally:
        continuous.ContinuousEngine._window_step = step


def _tp_rank(rank, world, port, out, model, tok, depth_model, sparse, state,
             paths):
    """One rank of a gloo group whose ranks share cuda:0 (NCCL refuses two
    ranks on one device), with a subgroup of the first tp ranks for each
    smaller tp of TP_SIZES: each of TP_RUNS at its tp, on the ranks that
    hold it, through the CLI's inference entry with that group
    (``cmd_inference(argv, group=...)``), every kernel's count set to 0
    just before and read just after, the generated tokens recorded
    (``model`` is the TP_DEPTH-layer file, as ``depth_model``). In
    "t2 fused" rank 1 loads from ``sparse`` (its bands fetched by
    weight_stream) and the ranks save the generation to ``state``. After
    the tp 2 runs: _tp_steps over that group, TP_FLAG_RUNS and a
    ``--profile`` run at TP_DEPTH layers into ``paths["profile"]``. Rank 0
    pickles what it saw to ``out``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.frontend import cli
    from distributed_llama_tpu_torch.parallel.mesh import TPGroup
    from distributed_llama_tpu_torch.runtime import generate

    torch.set_num_threads(1)  # the ranks share the host's cores
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    groups = {tp: dist.group.WORLD if tp == world
              else dist.new_group(list(range(tp))) for tp in TP_SIZES}
    res = {"backend": dist.get_backend()}
    loop = generate.generate
    streams = []

    def recorded(*args, **kwargs):
        got = loop(*args, **kwargs)
        streams.append(list(got[0]))
        return got

    generate.generate = recorded
    waited = False
    try:
        for label, (tp, scheme, extra) in TP_RUNS.items():
            if tp == world and not waited:
                # the ranks outside the smaller groups wait here, before
                # they touch the card, until those groups' runs are done
                dist.barrier()
                waited = True
            if rank >= tp:
                continue
            group = TPGroup(rank, tp, groups[tp], torch.device("cuda", 0))
            first = label == "t2 fused"
            res[label] = _tp_cli(cli, [
                "--model", sparse if first and rank == 1 else model,
                "--tokenizer", tok, "--prompt", PROMPT, "--steps",
                str(TP_STEPS), "--temperature", "0", "--seed", "1", "--tp",
                str(tp), "--tp-scheme", scheme, *extra,
                *(["--save-state", state] if first else [])], group, {},
                streams)
            if tp == 2 and label == "t2 q80":  # the last tp 2 run
                generate.generate = loop
                res["steps"] = _tp_steps(torch, group, depth_model, tok)
                generate.generate = recorded
                tp2 = ["--tp", "2", "--tp-scheme", "fused"]
                for flag_label in TP_FLAG_RUNS:
                    argv, env = _tp_flag_argv(flag_label, depth_model, tok,
                                              paths)
                    census: list = []
                    with _window_census(census):
                        res[flag_label] = _tp_cli(cli, [*tp2, *argv], group,
                                                  env, streams)
                    res[flag_label]["census"] = census
                res["profile"] = _tp_cli(cli, [
                    "--model", depth_model, "--tokenizer", tok, "--prompt",
                    PROMPT, "--steps", str(TP_STEPS), "--prefill-chunk",
                    str(TP_PREFILL), "--temperature", "0", "--seed", "1",
                    *tp2, "--profile", paths["profile"]], group, {}, streams)
    finally:
        generate.generate = loop
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)


def _tp_check(label, got, tp, n_layers, want, gaps, smi):
    """One tp run against the single-device stream and the counts: K1 4L+1
    and K2 L per decode step, the prefill's K3 (or K1m) 4L and K4 L per
    chunk over the bands, and the counted collectives a token equal to the
    budget. Logs ms per token beside the card."""
    out = got["out"]
    if got["rc"] != 0:
        raise AssertionError(f"{label}: the CLI exited {got['rc']}")
    steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    avg = float(re.search(r"Avg generation time: ([\d.]+) ms",
                          out).group(1))
    p50 = float(re.search(r"p50 ([\d.]+)", out).group(1))
    m = re.search(r"Collectives/token: +([\d.]+) \((.*)\), budget (\d+) "
                  r"\((\w+), tp (\d+), (\w+)\)", out)
    if not m or float(m.group(1)) != int(m.group(3)) or int(m.group(5)) != tp:
        raise AssertionError(f"{label}: collectives a token "
                             f"{m.groups() if m else None} against the "
                             f"budget")
    from distributed_llama_tpu_torch.ops import attention, q40

    q80 = "q80" in label
    chunk = Q80_CHUNK if q80 else TP_PREFILL
    chunks = -(-19 // chunk)
    parts = {k.symbol for k in (*q40.HELPERS, *attention.HELPERS)}
    _expect(f"{label} run", {k: v for k, v in got["launches"].items()
                             if k not in parts}, {
        "q40_matvec": (4 * n_layers + 1) * steps,
        "decode_attention": n_layers * steps,
        "q40_matvec_multi" if q80 else "q40_gemm": 4 * n_layers * chunks,
        "prefill_attention": n_layers * chunks})
    same, part, gap = _same_stream(label, got["stream"],
                                   want[:len(got["stream"])], gaps)
    res = dict(tp=tp, scheme=m.group(4), backend=m.group(6),
               decode_steps=steps, ms_per_token_avg=avg,
               ms_per_token_p50=p50, collectives_per_token=float(m.group(1)),
               collectives_by_kind=m.group(2), budget=int(m.group(3)),
               wall_s=got["wall_s"], launches=got["launches"],
               stream_equal=same, parts_at=part, gap=gap)
    log(f"tp {label}: {avg:.2f} ms/token (p50 {p50:.2f}) over {steps} "
        f"decode steps, {m.group(1)} collectives/token ({m.group(2)}) = "
        f"budget {m.group(3)}, {tp} gloo ranks sharing one card: {smi}; "
        f"stream {'equals' if same else 'parts at a near-tie from'} the "
        f"one-device stream")
    return res


def weight_stream(torch, spec, model):
    """Root -> worker weight streaming (io/stream.py) over localhost on the
    card's host: a WeightServer over ``model`` (the 7B smoke .bin cut to
    TP_DEPTH layers, ``spec`` its spec), and rank 1 of tp 2
    under the fused scheme fetching only the byte ranges its bands need
    (wo and w2 whole: fused bands them on their input dim) into a sparse
    file, which "t2 fused" then loads (tp_full_width). fetch_model's
    whole-file path is held byte for byte on a small model, so no second
    4.2 GB file is written. Returns the fetch's numbers and the sparse
    file's path."""
    import shutil

    from distributed_llama_tpu_torch.io import stream
    from distributed_llama_tpu_torch.io.loader import write_model
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.ops.quants import FloatType

    where = SMOKE_DIR / "stream"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    small_spec = TransformerSpec(dim=512, hidden_dim=1376, n_layers=2,
                                 n_heads=4, n_kv_heads=2, vocab_size=1000,
                                 seq_len=64, weights_float_type=FloatType.Q40)
    small = where / "small.bin"
    write_model(str(small), small_spec,
                synth_params(small_spec, q40=True, seed=7))
    server = stream.WeightServer(str(small), host="127.0.0.1")
    try:
        got = stream.fetch_model(f"127.0.0.1:{server.port}",
                                 str(where / "small_fetched.bin"), quiet=True)
    finally:
        server.close()
    if Path(got).read_bytes() != small.read_bytes():
        raise AssertionError("fetch_model: the fetched small model differs "
                             "from the served one")
    sparse = where / "model.bin"
    server = stream.WeightServer(str(model), host="127.0.0.1")
    try:
        t0 = time.perf_counter()
        stream.fetch_model_slices(f"127.0.0.1:{server.port}", str(sparse),
                                  FloatType.Q40, 2, {1}, "fused", quiet=True)
        secs = time.perf_counter() - t0
    finally:
        server.close()
    need = stream.needed_byte_ranges(spec, 2, {1}, "fused")
    nbytes = sum(n for _, n in need)
    resident = stream.verified_ranges(str(sparse))
    if resident != need or sparse.stat().st_size != spec.file_size():
        raise AssertionError(f"weight_stream: the sparse file holds "
                             f"{len(resident or [])} ranges of the "
                             f"{len(need)} needed")
    res = dict(tp=2, rank=1, scheme="fused", bytes=nbytes, ranges=len(need),
               file_bytes=spec.file_size(), seconds=secs,
               gb_per_s=nbytes / secs / 1e9,
               small_model_bytes=small.stat().st_size,
               transport="localhost TCP, the model read from a warm page "
                         "cache")
    log(f"weight_stream: rank 1 of tp 2 (fused) fetched {nbytes} of "
        f"{spec.file_size()} bytes ({100 * nbytes / spec.file_size():.1f}%) "
        f"in {len(need)} ranges in {secs:.2f} s ({nbytes / secs / 1e9:.3f} "
        f"GB/s over localhost); fetch_model gave the small model's "
        f"{small.stat().st_size} bytes back exactly")
    return res, sparse


def _tp_flag_check(label, got, one, gaps):
    """A TP_FLAG_RUNS run at tp 2 against the same flags at tp 1: rc 0,
    the run's own kernel launched, the rows equal and the pieces equal
    (or parting at a near-tie of tp 1's logits)."""
    kernel = TP_FLAG_RUNS[label][2]
    if got["rc"] != 0 or not got["launches"].get(kernel):
        raise AssertionError(f"tp 2 {label}: exit {got['rc']}, {kernel} "
                             f"launched {got['launches'].get(kernel)} times")
    census = got["census"]
    if (label in WINDOW_FLAG_RUNS) != bool(census) or any(
            have != want for have, want in census):
        raise AssertionError(f"tp 2 {label}: window census against the "
                             f"budget {census[:2]} ({len(census)} "
                             f"dispatches)")
    (pieces, rows), (want_pieces, want_rows) = (_tp_text(got["out"]),
                                                _tp_text(one["out"]))
    part = gap = None
    if want_rows:  # the batch engines: every row equal
        if rows != want_rows:
            raise AssertionError(f"tp 2 {label}: its rows differ from tp "
                                 f"1's")
    elif not want_pieces:
        raise AssertionError(f"tp 1 {label}: no tokens printed")
    else:  # raises unless equal or parting at a near-tie
        _, part, gap = _same_stream(f"tp 2 {label}", got["stream"],
                                    one["stream"], gaps)
    avg = re.search(r"Avg generation time: ([\d.]+) ms", got["out"])
    log(f"tp 2 {label} ({TP_DEPTH} layers): {kernel} x "
        f"{got['launches'].get(kernel)}, "
        f"{'rows' if rows else 'stream'} equal to tp 1's"
        + (f" (parting at a near-tie at step {part})" if part is not None
           else "")
        + (f", {avg.group(1)} ms/token" if avg else "")
        + f", {got['wall_s']:.1f} s")
    if census:
        log(f"tp 2 {label}: {len(census)} window dispatches, each issuing "
            f"the budget's collectives {census[0][1]} (first window)")
    return dict(launches=got["launches"], wall_s=got["wall_s"],
                ms_per_token_avg=float(avg.group(1)) if avg else None,
                parts_at=part, gap=gap, rows=len(rows),
                window_dispatches=len(census))


def _tp_profile_check(got):
    """The ``--profile`` run at tp 2: exit 0 (every rank found its trace's
    collective events equal to the census and T > 0), and rank 0's lines
    say so."""
    out = got["out"]
    m = re.search(r"Collectives in the trace: (\d+) \(([\d.]+) ms\), "
                  r"census (\d+)", out)
    it = re.search(r"🔶 I +([\d.]+) ms/token  T +([\d.]+) ms/token", out)
    if got["rc"] != 0 or not m or not it or m.group(1) != m.group(3) \
            or not float(m.group(2)) > 0:
        raise AssertionError(f"tp 2 --profile: exit {got['rc']}, "
                             f"{m.groups() if m else None}")
    log(f"tp 2 --profile ({TP_DEPTH} layers, gloo): I {it.group(1)} T "
        f"{it.group(2)} ms/token; {m.group(1)} collective events in rank "
        f"0's trace ({m.group(2)} ms) = census {m.group(3)}; every rank's "
        f"trace checked")
    return dict(i_ms_per_token=float(it.group(1)),
                t_ms_per_token=float(it.group(2)),
                collective_events=int(m.group(1)), census=int(m.group(3)),
                t_ms=float(m.group(2)), launches=got["launches"],
                wall_s=got["wall_s"])


def _depth_refs(torch, depth, tok):
    """Runs a and c at TP_DEPTH layers of 7B width (the tp runs' anchors):
    each one's tokens and its decode steps' top-2 logit gaps (run c's
    prefilled positions have none)."""
    gaps, streams = [], []
    _run_cli(torch, depth, tok, ["--prompt", PROMPT, "--steps", str(STEPS),
                                 "--temperature", "0", "--seed", "1"],
             gaps=gaps, streams=streams)
    ref_a = (streams[0], gaps)
    gaps, streams = [], []
    _run_cli(torch, depth, tok, [
        "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
        "--seed", "1", "--buffer-float-type", "q80", "--prefill-chunk",
        str(Q80_CHUNK)], gaps=gaps, streams=streams)
    return ref_a, (streams[0], [(float("inf"), 0.0)] * 19 + gaps)


def tp_full_width(torch, spec, model, tok, ref_a, ref_c, smi):
    """Llama-2-7B Q40 at full width, cut to TP_DEPTH layers, through the
    CLI's inference entry at tp 2 and 4, the ranks sharing the card over a
    gloo group this phase builds (one spawn a size): TP_RUNS, each stream
    held against the one-device run's at that depth (run a, or run c for
    q80 buffers, _depth_refs), "t2 fused" with rank 1's weights streamed
    (weight_stream) and its generation saved, then resumed at tp 1 to run
    a's stream; at tp 2 the lockstep and continuous steps, TP_FLAG_RUNS and
    a --profile run against the same on one device. ``ref_a``/``ref_c``
    (the 32-layer runs) anchor only tp_nccl. Returns the runs and each
    kernel's launches at each tp (rank 0)."""
    import dataclasses
    import pickle
    import shutil

    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.parallel.mesh import free_port

    depth = _tp_depth_model(spec, model)
    dspec = dataclasses.replace(spec, n_layers=TP_DEPTH)
    ref_ad, ref_cd = _depth_refs(torch, depth, tok)
    paths = {"batch": str(SMOKE_DIR / "tp_batch.txt"),
             "cont": str(SMOKE_DIR / "tp_cont.txt"),
             "profile": str(SMOKE_DIR / "tp_profile")}
    Path(paths["batch"]).write_text("\n".join(BATCH_PROMPTS[:TP_ROWS])
                                    + "\n")
    Path(paths["cont"]).write_text("\n".join(CONT_PROMPTS[:TP_REQS]) + "\n")
    shutil.rmtree(paths["profile"], ignore_errors=True)
    state = SMOKE_DIR / "state_t2.npz"
    state.unlink(missing_ok=True)
    with torch.inference_mode():
        one = _tp_steps(torch, None, depth, tok)
    ones = {}
    for label in TP_FLAG_RUNS:
        argv, env = _tp_flag_argv(label, depth, tok, paths)
        gaps, streams = [], []
        out, counts, wall, _ = _run_cli(torch, depth, tok, argv[4:], env,
                                        gaps=gaps, streams=streams)
        ones[label] = (dict(out=out, stream=streams[0] if streams else None),
                       gaps)
    streamed, sparse = weight_stream(torch, dspec, depth)
    world = max(TP_SIZES)
    out = SMOKE_DIR / "tp.pkl"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(_tp_rank, args=(
        world, free_port(), str(out), str(depth), str(tok), str(depth),
        str(sparse), str(state), paths), nprocs=world, start_method="spawn")
    with open(out, "rb") as fh:
        got = pickle.load(fh)
    log(f"tp: {world} ranks over {got['backend']} sharing cuda:0 (a group "
        f"this script built, the first 2 ranks a subgroup for tp 2), "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    res, launches = {"weight_stream": streamed}, {}
    for world in TP_SIZES:
        runs = [label for label, (tp, _, _) in TP_RUNS.items()
                if tp == world]
        counts = collections.Counter()
        for label in runs:
            want, gaps = ref_cd if "q80" in label else ref_ad
            res[label] = _tp_check(label, got[label], world, TP_DEPTH,
                                   want, gaps, smi)
            counts.update(got[label]["launches"])
        if world == 2:
            res["t2 fused"]["rank1_weights"] = "streamed (weight_stream)"
            res["t2 save, t1 resume"] = _tp_resume(torch, depth, tok, state,
                                                   got["t2 fused"], ref_ad,
                                                   TP_DEPTH)
            steps = got["steps"]
            same = (steps["rows"] == one["rows"],
                    steps["outs"] == one["outs"])
            log(f"tp {world} steps at {TP_DEPTH} layers of 7B width "
                f"(graph=False): lockstep {TP_ROWS} rows "
                f"{'equal' if same[0] else 'DIFFER from'} one device's, "
                f"continuous ({TP_REQS} requests, {TP_ROWS} slots, pages of "
                f"{PAGE}, {steps['cont_steps']} steps) "
                f"{'equal' if same[1] else 'DIFFER from'} one device's; "
                f"launches {steps['batch_launches']}, "
                f"{steps['cont_launches']}")
            if not all(same):
                raise AssertionError(f"tp {world} steps differ from one "
                                     f"device's")
            b, c = steps["batch_launches"], steps["cont_launches"]
            n = b.get("decode_attention_batch", 0) // TP_DEPTH
            if not n or b.get("q40_matvec_multi") != (4 * TP_DEPTH + 1) * n \
                    or not all(c.get(k) for k in ("paged_attention",
                                                  "q40_gemm",
                                                  "prefill_attention")):
                raise AssertionError(f"tp {world} steps' launches: {b}, {c}")
            counts.update(b)
            counts.update(c)
            res[f"t{world} steps"] = dict(
                depth=TP_DEPTH, rows=TP_ROWS, requests=TP_REQS,
                cont_steps=steps["cont_steps"], batch_launches=b,
                cont_launches=c)
            for label in TP_FLAG_RUNS:
                res[f"t2 {label}"] = _tp_flag_check(label, got[label],
                                                    *ones[label])
                counts.update(got[label]["launches"])
            res["t2 profile"] = _tp_profile_check(got["profile"])
            counts.update(got["profile"]["launches"])
        launches[world] = dict(counts)
    shutil.rmtree(SMOKE_DIR / "stream", ignore_errors=True)
    state.unlink(missing_ok=True)
    if torch.cuda.device_count() < 2:
        log(f"tp over NCCL: not run ({torch.cuda.device_count()} GPU "
            f"visible); waiting for a machine with more than one card: "
            f"{'; '.join(TP_WAITS)}")
    else:
        res["nccl"] = tp_nccl(torch, model, tok, ref_a, ref_c)
    return res, launches


def _tp_resume(torch, model, tok, state, saved, ref_a, n_layers):
    """The "t2 fused" run's checkpoint (kv heads gathered to rank 0)
    resumed at tp 1 through the CLI for the rest of run a's steps: K1 4L+1
    and K2 L per step, and the joined tokens run a's (or parting at a
    near-tie of run a's logits, as "t2 fused" may)."""
    streams = []
    out, counts, wall, finite = _run_cli(torch, model, tok, [
        "--resume-state", str(state), "--steps", str(STEPS - TP_STEPS),
        "--temperature", "0", "--seed", "1"], streams=streams)
    steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    _expect("t2 save, t1 resume run", counts, {
        "q40_matvec": (4 * n_layers + 1) * steps,
        "decode_attention": n_layers * steps})
    if f"⏩ Resumed at pos {TP_STEPS} (" not in out or not all(finite):
        raise AssertionError("t2 save, t1 resume: no resume line, or "
                             "non-finite logits")
    want, gaps = ref_a
    joined = saved["stream"] + streams[0]
    same, part, gap = _same_stream("t2 save, t1 resume", joined,
                                   want[:len(joined)], gaps)
    log(f"tp 2 --save-state ({state.stat().st_size} bytes) resumed at tp 1 "
        f"for {steps} steps: the joined stream "
        f"{'equals' if same else 'parts at a near-tie from'} run a's; "
        f"{wall:.1f} s")
    return dict(checkpoint_bytes=state.stat().st_size, resumed_steps=steps,
                launches=counts, wall_s=wall, stream_equal=same,
                parts_at=part, gap=gap)


def tp_nccl(torch, model, tok, ref_a, ref_c):
    """Where two GPUs are visible: ``inference --tp N`` as a user runs it
    (the CLI spawns N NCCL ranks, one GPU each), token by token: tp 2
    under fused and overlap, and with four GPUs tp 4 under fused, overlap
    and ref with q80 buffers, each stream's text against run a's (run c's
    for q80 buffers); then the lockstep batch (TP_ROWS prompts, its steps
    eager under tp) at tp 2 against tp 1. Every CLI call has a timeout."""
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer

    tokenizer = Tokenizer(str(tok), 32000)

    def text(tokens):
        prev, pieces = 1, []
        for t in tokens[:TP_STEPS]:
            pieces.append(tokenizer.decode_piece(prev, t).decode(
                "utf-8", errors="replace"))
            prev = t
        return "".join(pieces)

    def cli(label, *args):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "distributed_llama_tpu_torch", "inference",
             "--model", str(model), "--tokenizer", str(tok), "--temperature",
             "0", "--seed", "1", *args], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        if run.returncode != 0:
            raise AssertionError(f"{label}: exit {run.returncode}: "
                                 f"{run.stderr[-3000:]}")
        return run.stdout, time.perf_counter() - t0

    runs = [("nccl t2 fused", 2, ["--tp-scheme", "fused"]),
            ("nccl t2 overlap", 2, ["--tp-scheme", "overlap"])]
    if torch.cuda.device_count() >= 4:
        runs += [("nccl t4 fused", 4, ["--tp-scheme", "fused"]),
                 ("nccl t4 overlap", 4, ["--tp-scheme", "overlap"]),
                 ("nccl t4 ref q80", 4, ["--tp-scheme", "ref",
                                         "--buffer-float-type", "q80",
                                         "--prefill-chunk",
                                         str(Q80_CHUNK)])]
    res = {}
    for label, tp, extra in runs:
        want = text((ref_c if "q80" in label else ref_a)[0])
        out, wall = cli(label, "--prompt", PROMPT, "--steps", str(TP_STEPS),
                        "--tp", str(tp), *extra)
        avg = float(re.search(r"Avg generation time: ([\d.]+) ms",
                              out).group(1))
        same = _pieces(out) == want
        log(f"tp {label}: {avg:.2f} ms/token, stream "
            f"{'equals' if same else 'DIFFERS from'} the one-device "
            f"stream, {wall:.1f} s with the spawn")
        if not same:
            raise AssertionError(f"{label}: stream differs from one "
                                 f"device's")
        res[label] = dict(tp=tp, ms_per_token_avg=avg, stream_equal=same)
    prompts = SMOKE_DIR / "tp_prompts.txt"
    prompts.write_text("\n".join(BATCH_PROMPTS[:TP_ROWS]) + "\n")
    rows = {}
    for tp in (1, 2):
        out, _ = cli(f"nccl lockstep tp {tp}", "--prompts-file", str(prompts),
                     "--steps", "48", "--tp", str(tp))
        rows[tp] = re.findall(r"^\[(\d+)\] (.*)$", out, re.M)
    same = bool(rows[1]) and rows[1] == rows[2]
    log(f"tp nccl lockstep batch, {TP_ROWS} rows at tp 2 (eager steps): "
        f"rows {'equal' if same else 'DIFFER from'} tp 1's")
    if not same:
        raise AssertionError("nccl lockstep batch: tp 2 rows differ from "
                             "tp 1's")
    res["nccl lockstep t2"] = dict(rows=TP_ROWS, rows_equal=same)
    return res


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
    return max(worst, small_prefill(torch, spec, gpu, cpu), small_f16(torch))


def small_f16(torch):
    """F16 weights (``--weights-float-type f16``, the dense product of
    ops/linear.dense_matmul): a small GQA model written as an F16 .bin,
    the forward on the card against the CPU at 8 positions and a 4-token
    prefill chunk (logits within LOGIT_RTOL x max), and the CLI's greedy
    stream, card and CPU, equal."""
    import numpy as np

    from distributed_llama_tpu_torch.frontend import cli
    from distributed_llama_tpu_torch.io.loader import load_model, write_model
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.ops.quants import FloatType

    spec = TransformerSpec(dim=512, hidden_dim=1376, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=32000, seq_len=64,
                           weights_float_type=FloatType.F16)
    path = SMOKE_DIR / "small_f16.bin"
    write_model(str(path), spec, synth_params(spec, q40=False, seed=9))
    _, host = load_model(str(path), weights_float_type=FloatType.F16)
    if host["wq"].dtype != np.float16:
        raise AssertionError(f"F16 load gave {host['wq'].dtype}")
    gpu = llama.Llama(spec, llama.params_to_device(host, "cuda"))
    cpu = llama.Llama(spec, llama.params_to_device(host, "cpu"))
    cg, cc = llama.init_cache(spec, "cuda"), llama.init_cache(spec, "cpu")
    worst = 0.0
    with torch.inference_mode():
        steps = [(pos, t) for pos, t in enumerate([1, 17, 400, 3])]
        steps.append((4, [3, 999, 42, 7]))
        for pos, t in steps:
            a, b = gpu(cg, t, pos).cpu(), cpu(cc, t, pos)
            err = (a - b).abs().max().item()
            tol = llama.LOGIT_RTOL * b.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"F16 pos {pos}: card vs CPU logits "
                                     f"differ by {err} > {tol}")
            worst = max(worst, err)
    tok = SMOKE_DIR / "tokenizer_32000.bin"  # smoke_files wrote it
    outs = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["inference", "--model", str(path), "--tokenizer",
                           str(tok), "--weights-float-type", "f16",
                           "--prompt", "hi hi", "--steps", "16",
                           "--temperature", "0", "--seed", "1", "--device",
                           dev])
        if rc != 0:
            raise RuntimeError(f"F16 CLI on {dev} exited {rc}")
        outs[dev] = _pieces(buf.getvalue())
    log(f"small F16 model, card vs CPU: 5 calls (8 positions), max_abs_err "
        f"{worst:.3e} (tol LOGIT_RTOL {llama.LOGIT_RTOL} x max); CLI "
        f"--weights-float-type f16 greedy stream "
        f"{'equal' if outs['cuda'] == outs['cpu'] else 'DIFFERS'} "
        f"({len(outs['cuda'])} pieces)")
    if outs["cuda"] != outs["cpu"] or len(outs["cuda"]) < 12:
        raise AssertionError("F16 CLI: the card's stream differs from the "
                             "CPU's")
    return worst


def small_loops(torch, spec, host):
    """The on-device loops on the small model: generate_batch of 3 ragged
    prompts (captured K1m / K5 on the card) and generate_fast (captured K1
    / K5) against the same calls on the CPU's plain versions: greedy token
    streams equal; then generate and generate_fast under
    DLLAMA_LAYER_FUSION=headtail (K8, K2 / K5, K9) and on (K10), card and
    CPU, each equal to the unfused stream."""
    from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                              generate,
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
    # the fused decode layer (head size 128: 'on' takes K10), host loop and
    # captured loop, against the same on the CPU and the unfused stream
    fused = {}
    saved = os.environ.get("DLLAMA_LAYER_FUSION")
    try:
        for mode in ("headtail", "on"):
            os.environ["DLLAMA_LAYER_FUSION"] = mode
            for dev in ("cuda", "cpu"):
                engine = Engine(spec, host, dev)
                for fn in (generate, generate_fast):
                    engine.reset()
                    fused[mode, dev, fn.__name__] = fn(
                        engine, Tok(), Sampler(spec.vocab_size, 0.0, 0.9, 1),
                        "5 6 7", 20, quiet=True)[0]
    finally:
        if saved is None:
            os.environ.pop("DLLAMA_LAYER_FUSION", None)
        else:
            os.environ["DLLAMA_LAYER_FUSION"] = saved
    same = sorted(k for k, v in fused.items() if v == fast["cpu"])
    log(f"small model fused layer (headtail, on), card vs CPU, host loop and "
        f"--fast: {len(same)} of {len(fused)} streams equal the unfused one")
    if len(same) != len(fused):
        raise AssertionError(f"small model: fused streams differ: "
                             f"{sorted(set(fused) - set(same))}")


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
                                   "prefill_attention": L * 10,
                                   **_prefill_parts(spec, 4, range(0, 40, 4),
                                                    False, False)},
         llama.LOGIT_RTOL),
        ("chunk 16", 16, None, f32, {"q40_gemm": 4 * L * 3,
                                     "prefill_attention": L * 3,
                                     **_prefill_parts(spec, 16, [0, 16, 32],
                                                      False, False)},
         llama.LOGIT_RTOL),
        ("fast chunk 16", 16, llama.FAST, f32,
         {"q40_gemm_bf16": 4 * L * 3, "prefill_attention_bf16": L * 3,
          **_prefill_parts(spec, 16, [0, 16, 32], True, False)},
         llama.FAST_RTOL),
        ("fast chunk 16 bf16 cache", 16, llama.FAST, bf16,
         {"q40_gemm_bf16": 4 * L * 3,
          "prefill_attention_bf16_kvbf16": L * 3,
          **_prefill_parts(spec, 16, [0, 16, 32], True, True)},
         llama.FAST_RTOL)]
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


# --------------------------------------------------------------------------
# serve_tp_full_width: serve --tp 2, rank 0 sending each dispatch's plan
# --------------------------------------------------------------------------

SERVE_TP_GREEDY = 8   # concurrent greedy requests (CONT_PROMPTS[:8])
SERVE_TP_SEEDED = 4   # and seeded ones (CONT_PROMPTS[8:12])
SERVE_TP_TIMEOUT = 60.0  # the plan channel's (tp_plan.DEFAULT_TIMEOUT_S)
SERVE_TP_ARGS = ("--tp", "2")  # more ranks than cards: gloo, sharing it


def _serve_tp_payloads():
    out = [{"prompt": CONT_PROMPTS[i], "steps": CONT_STEPS,
            "temperature": 0.0, "stream": i % 2 == 1}
           for i in range(SERVE_TP_GREEDY)]
    out += [{"prompt": CONT_PROMPTS[SERVE_TP_GREEDY + i],
             "steps": CONT_STEPS, "temperature": 0.8, "topp": 0.9,
             "seed": 100 + i, "stream": i % 2 == 0}
            for i in range(SERVE_TP_SEEDED)]
    return out


def _served_tokens(srv, body):
    """One request's tokens (the prompt's echo included)."""
    if not body.get("stream"):
        return srv.post("/generate", body)["tokens"]
    lines: list = []
    last = srv.post("/generate", body, stream_to=lines)
    if not last.get("done") or "error" in last:
        raise AssertionError(f"stream ended with {last}")
    return [ln["token"] for ln in lines if "token" in ln]


def _served_burst(srv, payloads):
    """Every payload at once: (tokens per request, wall s, ms a dispatch
    on the scheduler's clock, /health)."""
    t0 = time.perf_counter()
    outs = _concurrently([(lambda b=b: _served_tokens(srv, b))
                          for b in payloads])
    wall = time.perf_counter() - t0
    metrics = srv.get("/metrics").decode()
    n = _prom_value(metrics, "dllama_engine_step_duration_seconds_count")
    ms = _prom_value(metrics, "dllama_engine_step_duration_seconds_sum") \
        / max(n, 1) * 1e3
    return outs, wall, ms, json.loads(srv.get("/health"))


def _parting_gaps(torch, depth, tok, payloads, got, want):
    """Rows where ``got`` parts from ``want``: each must be a greedy row
    parting where the one-device forward at TP_DEPTH layers (the row's
    tokens fed through Engine.infer) has its two largest logits within
    LOGIT_RTOL x max|logit|. Returns [(row, token index, gap)]."""
    import numpy as np

    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import BOS
    from distributed_llama_tpu_torch.models.llama import LOGIT_RTOL
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.runtime.generate import Engine

    rows = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not rows:
        return []
    spec, params = load_model(str(depth), weights_float_type=FloatType.Q40)
    engine = Engine(spec, params, "cuda")
    parted = []
    for i in rows:
        a, b = got[i], want[i]
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if payloads[i]["temperature"] != 0.0 or j >= min(len(a), len(b)):
            raise AssertionError(f"serve --tp 2: request {i} differs from "
                                 f"tp 1's at token {j}")
        engine.reset()
        seq = [BOS] + list(b)
        for pos in range(j + 1):
            logits = engine.infer(seq[pos], pos)
        top = np.sort(logits)[-2:]
        gap, scale = float(top[1] - top[0]), float(np.abs(logits).max())
        log(f"serve --tp 2: request {i} parts from tp 1's at token {j}, "
            f"top-2 gap {gap:.3e} (tolerance {LOGIT_RTOL * scale:.3e})")
        if not gap <= LOGIT_RTOL * scale:
            raise AssertionError(f"serve --tp 2: request {i} parts at token "
                                 f"{j} with top-2 gap {gap} above the logit "
                                 f"tolerance")
        parted.append((i, j, gap))
    del engine
    return parted


def _tp_lines(srv):
    """The plans rank 0 sent and each follower followed, from the child's
    exit lines."""
    text = "\n".join(srv.lines)
    sent = re.search(r"🌐 tp: sent (\d+) dispatch plans", text)
    followed = re.findall(r"🌐 tp rank \d+: followed (\d+) plans, every "
                          r"digest equal", text)
    return (int(sent.group(1)) if sent else None), [int(n) for n in
                                                    followed]


def _pairs(d: dict) -> str:
    """'k v, ...' of a dict of floats (3 decimals)."""
    return ", ".join(f"{k} {v:.3f}" for k, v in d.items())


def phase_serve_tp(torch, depth, dspec, tok, smi, serve_res):
    """serve_tp_full_width: ``serve --tp 2`` (rank 0 in the serve child,
    one follower it spawns, gloo ranks sharing the card) on the 7B smoke
    file cut to TP_DEPTH layers, against ``serve`` at tp 1 on the same
    file (the tp 1 prefill role of the disaggregated pair, which serves
    /generate as a plain server does): SERVE_TP_GREEDY concurrent greedy
    requests and SERVE_TP_SEEDED seeded ones give tp 1's tokens (a greedy
    row may part at a near-tie of the one-device logits); rank 0's
    collectives equal the budget a forward (tp_collective_budget, the
    logits gather only where a forward gathered logits); the plans sent
    equal the dispatches the follower ran, and no digest differed (the
    follower exits 0 and says so); a tp 2 decode role fed by that tp 1
    prefill role gives tp 1's tokens; and the kill_tp_follower drill
    (runtime/chaos.py, unsupervised: the respawn is a CPU test's): a
    follower SIGKILLed mid-burst makes rank 0 fail the burst and exit
    non-zero within the channel's timeout. Logs ms a dispatch beside
    serve_full_width's (32 layers) and the plan point's share of it
    (digest, pickle, send). Returns the phase's numbers and rank 0's
    kernel launches under --tp 2."""
    import shutil

    from distributed_llama_tpu_torch.parallel.comm_stats import \
        tp_collective_budget
    from distributed_llama_tpu_torch.parallel.mesh import free_port
    from distributed_llama_tpu_torch.runtime.chaos import \
        drill_kill_tp_follower

    where = SMOKE_DIR / "serve_tp"
    shutil.rmtree(where, ignore_errors=True)
    payloads = _serve_tp_payloads()
    res: dict = {}
    secs, t0 = {}, time.perf_counter()

    def lap(label):  # the phase's seconds, part by part
        nonlocal t0
        secs[label] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # the three children start together (their loads overlap): tp 2, and
    # the pair of a tp 1 prefill role (tp 1's anchor) and a tp 2 decode
    # role
    pre_port = free_port()
    flags = {"t2": SERVE_TP_ARGS,
             "pre": ("--disagg-role", "prefill", "--port", str(pre_port)),
             "dec": ("--disagg-role", "decode", "--disagg-peer",
                     f"127.0.0.1:{pre_port}", *SERVE_TP_ARGS)}
    srvs = {}
    for label, extra in flags.items():
        (where / label).mkdir(parents=True)
        srvs[label] = _Served(depth, tok, where / label, extra)
    try:
        for label, srv in srvs.items():
            res[f"{label}_start_s"] = srv.wait_ready(600)
        lap("start")
        runs = {label: _served_burst(srvs[label], payloads)
                for label in ("pre", "t2")}
        lap("bursts")
        long = payloads[:SERVE_TP_GREEDY]
        got = _concurrently([(lambda b=b: _served_tokens(srvs["dec"], b))
                             for b in long])
        shipped = _prom_value(srvs["dec"].get("/metrics").decode(),
                              'dllama_handoff_requests_total'
                              '{verdict="shipped"}')
        lap("disagg")
    finally:
        rcs = {label: srv.stop()[0] for label, srv in srvs.items()}
        lap("stop")
    if any(rcs.values()):
        raise AssertionError(f"serve children's exits {rcs}: "
                             + "\n".join(srvs["t2"].lines[-30:]))
    sent, followed = _tp_lines(srvs["t2"])
    (o1, w1, ms1, _), (o2, w2, ms2, h2) = runs["pre"], runs["t2"]
    parted = _parting_gaps(torch, depth, tok, payloads, o2, o1)
    tp = h2["tp"]
    budget = tp_collective_budget(dspec, 2, tp["scheme"]).kind_counts()
    want = {"psum": budget["psum"] * tp["forwards"],
            "all_gather": budget["all_gather"] * tp["logit_forwards"]}
    if tp["collectives"] != want or tp["error"] is not None:
        raise AssertionError(f"serve --tp 2: collectives {tp['collectives']}"
                             f" over {tp['forwards']} forwards "
                             f"({tp['logit_forwards']} with logits), want "
                             f"{want}; error {tp['error']}")
    if not tp["plans_sent"] or sent != tp["plans_sent"] \
            or followed != [sent]:
        raise AssertionError(f"serve --tp 2: /health plans {tp['plans_sent']}"
                             f", rank 0 sent {sent}, followers followed "
                             f"{followed}")
    launches = tp["launches"]
    starts = {k[:-len("_start_s")]: v for k, v in res.items()
              if k.endswith("_start_s")}
    log(f"serve --tp 2 ({TP_DEPTH} layers, 2 gloo ranks sharing the card: "
        f"{smi}): {len(payloads)} requests ({SERVE_TP_GREEDY} greedy, "
        f"{SERVE_TP_SEEDED} seeded) equal tp 1's ({len(parted)} part at a "
        f"near-tie); {sent} plans sent = {followed[0]} followed, no digest "
        f"differed; collectives {tp['collectives']} = budget over "
        f"{tp['forwards']} forwards; {ms2:.3f} ms a dispatch against tp 1's "
        f"{ms1:.3f} at {TP_DEPTH} layers and serve_full_width's "
        f"{serve_res['ms_per_dispatch']:.3f} at 32 layers (of it the plan "
        f"point: {_pairs(tp['plan_ms'])} ms); burst {w2:.2f} s against "
        f"{w1:.2f} s; children ready in {_pairs(starts)} s")
    res.update(requests=len(payloads), parted=parted, plans_sent=sent,
               plans_followed=followed, forwards=tp["forwards"],
               logit_forwards=tp["logit_forwards"],
               collectives=tp["collectives"], ms_per_dispatch_t2=ms2,
               ms_per_dispatch_t1=ms1, plan_ms=tp["plan_ms"],
               serve_full_width_ms_per_dispatch=serve_res["ms_per_dispatch"],
               burst_s_t2=w2, burst_s_t1=w1, launches_rank0=launches)
    pd = _parting_gaps(torch, depth, tok, long, got, o1[:len(long)])
    lap("partings")
    if not shipped:
        raise AssertionError("disagg under tp 2: nothing handed off")
    log(f"serve --tp 2 decode role fed by a tp 1 prefill role: {len(long)} "
        f"requests, {shipped:.0f} handed off, tokens equal tp 1's "
        f"({len(pd)} part at a near-tie)")
    res["disagg_decode_tp2"] = dict(requests=len(long), shipped=shipped,
                                    parted=pd)
    # the kill_tp_follower drill, unsupervised (one group start)
    cmd = [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
           "--model", str(depth),
           "--tokenizer", str(tok), "--slots", str(CONT_SLOTS),
           "--kv-page-size", str(PAGE), "--prefill-chunk", str(CONT_CHUNK),
           "--seed", "1", "--port", "0", *SERVE_DEVICE_ARGS,
           *SERVE_TP_ARGS, "--chaos", "step_delay_every=1,step_delay_ms=20"]
    drill = drill_kill_tp_follower(
        cmd, SERVE_TP_TIMEOUT,
        payloads=[{"prompt": CONT_PROMPTS[i], "steps": CONT_STEPS,
                   "temperature": 0, "stream": i % 2 == 0}
                  for i in range(4)])
    lap("drill")
    if not drill.passed:
        raise AssertionError(f"kill_tp_follower: {drill.violations}")
    log(f"kill_tp_follower drill: rank 0 exited "
        f"{drill.details['rank0_exit_s']:.2f} s after the kill (timeout "
        f"{SERVE_TP_TIMEOUT:.0f} s) with exit {drill.details['rc']}, "
        f"{drill.details['failed_requests']} of the burst failed and "
        f"answered")
    res["kill_tp_follower"] = drill.details
    shutil.rmtree(where, ignore_errors=True)
    res["seconds"] = secs
    log(f"serve_tp_full_width seconds: {_pairs(secs)}")
    return res, launches


# --------------------------------------------------------------------------
# sp_full_width: inference --sp N, the sp-sharded KV cache
# --------------------------------------------------------------------------

SP_PROMPT = " ".join(["hi"] * 1040)  # BOS + 1040 " hi" pieces: 1041 tokens
SP_DECODE = 16     # decode steps after the prompt
SP_CHUNK = 128     # its prefill chunk: position 1024 (sp 2's chunk
#                    boundary) and 512 (sp 4's) fall inside the prefill
SP_MESHES = ((2, 1), (2, 2), (4, 1))  # (sp, tp), all on 4 gloo ranks
SP_BATCH_ROWS = 4  # the lockstep batch at sp 2


def _sp_rank(rank, world, ports, out, depth, tok, batch):
    """One of 4 processes sharing cuda:0. For each (sp, tp) of SP_MESHES
    the first sp x tp of them join that mesh through the port's
    parallel/mesh.init_mesh on its own port (gloo: the ranks outnumber
    the card; global rank = sp index * tp + tp index), run ``inference``
    through the CLI's entry (``cmd_inference(argv, group=...)``), the
    lockstep batch too at sp 2 x tp 1, and leave it; rank 0 pickles what
    it saw (its launches counted from 0 just before each run)."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.frontend import cli
    from distributed_llama_tpu_torch.parallel.mesh import close, init_mesh
    from distributed_llama_tpu_torch.runtime import generate

    torch.set_num_threads(1)
    loop = generate.generate
    streams: list = []

    def recorded(*args, **kwargs):
        got = loop(*args, **kwargs)
        streams.append(list(got[0]))
        return got

    generate.generate = recorded
    res = {}
    steps = str(len(SP_PROMPT.split()) + SP_DECODE)
    try:
        for port, (sp, tp) in zip(ports, SP_MESHES):
            if rank >= sp * tp:
                continue
            g = init_mesh(rank, sp, tp, f"tcp://localhost:{port}", "cuda",
                          timeout_s=300, backend="gloo")
            try:
                res[(sp, tp)] = _tp_cli(cli, [
                    "--model", depth, "--tokenizer", tok, "--prompt",
                    SP_PROMPT, "--steps", steps, "--prefill-chunk",
                    str(SP_CHUNK), "--temperature", "0", "--seed", "1",
                    "--tp", str(tp)], g, {}, streams)
                if (sp, tp) == (2, 1):
                    res["batch"] = _tp_cli(cli, [
                        "--model", depth, "--tokenizer", tok,
                        "--prompts-file", batch, "--steps", "64",
                        "--temperature", "0", "--seed", "1", "--tp", "1"],
                        g, {}, streams)
            finally:
                close(g)
    finally:
        generate.generate = loop
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)


def phase_sp(torch, depth, dspec, tok, smi):
    """sp_full_width: ``inference`` over the sp-sharded KV cache at 7B
    width cut to TP_DEPTH layers, gloo ranks sharing the card: at sp 2 x
    tp 1, sp 2 x tp 2 and sp 4 x tp 1, a SP_PROMPT of 1041 tokens
    prefilled at --prefill-chunk SP_CHUNK (across position 1024, sp 2's
    chunk boundary, and 512, sp 4's), then SP_DECODE decode steps; the
    streams equal the one-device run's (or part at its near-tie), the
    sp collectives a decode step are 3 x n_layers (one pmax, two psums a
    layer), and every Q40 product runs on K1 and K3; the lockstep batch
    at sp 2 gives the one-device rows. Returns the runs and rank 0's
    launches."""
    import pickle

    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.parallel.mesh import free_port

    t0 = time.perf_counter()
    batch = SMOKE_DIR / "sp_batch.txt"
    batch.write_text("\n".join(BATCH_PROMPTS[:SP_BATCH_ROWS]) + "\n")
    steps = str(len(SP_PROMPT.split()) + SP_DECODE)
    gaps, streams = [], []
    _run_cli(torch, depth, tok, [
        "--prompt", SP_PROMPT, "--steps", steps, "--prefill-chunk",
        str(SP_CHUNK), "--temperature", "0", "--seed", "1"], gaps=gaps,
        streams=streams)
    one_batch, _, _, _ = _run_cli(torch, depth, tok, [
        "--prompts-file", str(batch), "--steps", "64", "--temperature", "0",
        "--seed", "1"])
    n_echo = len(SP_PROMPT.split())  # prefilled: no logits, no gaps
    gaps = [(float("inf"), 0.0)] * n_echo + gaps
    out = SMOKE_DIR / "sp.pkl"
    out.unlink(missing_ok=True)
    ports = [free_port() for _ in SP_MESHES]
    mp.start_processes(_sp_rank, args=(4, ports, str(out), str(depth),
                                       str(tok), str(batch)),
                       nprocs=4, start_method="spawn")
    with open(out, "rb") as fh:
        got = pickle.load(fh)
    res, launches = {}, collections.Counter()
    n_pre = -(-(len(SP_PROMPT.split())) // SP_CHUNK)
    for (sp, tp) in SP_MESHES:
        run = got[(sp, tp)]
        text = run["out"]
        if run["rc"] != 0:
            raise AssertionError(f"sp {sp} x tp {tp}: exit {run['rc']}")
        m = re.search(r"SP collectives/token: +([\d.]+) \((.*)\), budget "
                      r"(\d+) \(sp (\d+), (\d+) bytes\)", text)
        n_steps = int(re.search(r"Generated tokens:\s+(\d+)",
                                text).group(1))
        if not m or float(m.group(1)) != 3 * TP_DEPTH \
                or int(m.group(3)) != 3 * TP_DEPTH or int(m.group(4)) != sp:
            raise AssertionError(f"sp {sp} x tp {tp}: sp collectives a step "
                                 f"{m.groups() if m else None}, want "
                                 f"{3 * TP_DEPTH}")
        same, part, gap = _same_stream(f"sp {sp} x tp {tp}", run["stream"],
                                       streams[0][:len(run["stream"])],
                                       gaps)
        lc = run["launches"]
        if lc.get("q40_matvec") != (4 * TP_DEPTH + 1) * n_steps \
                or lc.get("q40_gemm") != 4 * TP_DEPTH * n_pre \
                or lc.get("decode_attention") or lc.get("prefill_attention"):
            raise AssertionError(f"sp {sp} x tp {tp}: launches {lc} over "
                                 f"{n_steps} steps and {n_pre} chunks")
        launches.update(lc)
        res[f"sp{sp} tp{tp}"] = dict(
            decode_steps=n_steps, sp_collectives_per_step=float(m.group(1)),
            sp_bytes_per_step=int(m.group(5)), stream_equal=same,
            parts_at=part, gap=gap, launches=lc, wall_s=run["wall_s"])
        log(f"sp {sp} x tp {tp} ({TP_DEPTH} layers, {sp * tp} gloo ranks "
            f"sharing the card: {smi}): {len(SP_PROMPT.split()) + 1}-token "
            f"prompt at chunk {SP_CHUNK}, {n_steps} decode steps, stream "
            f"{'equals' if same else 'parts at a near-tie from'} one "
            f"device's; {m.group(1)} sp collectives a step ({m.group(2)}), "
            f"{m.group(5)} bytes; {run['wall_s']:.1f} s")
    rows = [ln for ln in got["batch"]["out"].splitlines()
            if re.match(r"^\[\d+\] ", ln)]
    want_rows = [ln for ln in one_batch.splitlines()
                 if re.match(r"^\[\d+\] ", ln)]
    if got["batch"]["rc"] != 0 or rows != want_rows \
            or len(rows) != SP_BATCH_ROWS:
        raise AssertionError(f"sp 2 lockstep batch: rows {rows} against "
                             f"{want_rows}")
    launches.update(got["batch"]["launches"])
    res["sp2 batch"] = dict(rows=len(rows), equal=True,
                            launches=got["batch"]["launches"])
    res["seconds"] = time.perf_counter() - t0
    log(f"sp 2 lockstep batch: {len(rows)} rows equal one device's; "
        f"sp_full_width {res['seconds']:.1f} s")
    return res, dict(launches)


TRAIN_BATCH, TRAIN_SEQ = 4, 128   # the train runs' windows (tp 1's --batch,
TRAIN_STEPS = 3                   # --seq), the CLI run's steps, and each
TRAIN_GROUP_STEPS = 2             # gloo group's steps
TRAIN_LR = 1e-4                   # the CLI's default
TRAIN_CUT_DEPTH = 1     # (c)'s and (d)'s layers, at 7B width: the gloo
#                         groups' gradient sums and (d)'s 5.6 GB checkpoint
#                         move the embedding, wcls and one layer
TRAIN_SEED = 1
TRAIN_GROUPS = ((2, 1, 1), (1, 1, 2), (2, 1, 2), (1, 2, 1))  # (dp, sp, tp)
TRAIN_LOSS_RTOL = 1e-5  # a group's losses against tp 1's (the sp gate)
TRAIN_NARROW = dict(dim=256, hidden_dim=688, n_layers=2, n_heads=8,
                    n_kv_heads=4, vocab_size=512, seq_len=64)


def _train_corpus() -> str:
    """A seeded corpus of short letter words: the windows of every train
    run come from its tokens."""
    import numpy as np

    rng = np.random.default_rng(TRAIN_SEED)
    letters = list(_LETTERS)
    return " ".join("".join(rng.choice(letters, size=rng.integers(1, 6)))
                    for _ in range(4000))


def _train_windows(corpus, step: int, batch=TRAIN_BATCH):
    """The train CLI's schedule: (batch, seq+1) windows, a pure function
    of (seed, step)."""
    import numpy as np

    rng = np.random.default_rng((TRAIN_SEED, step))
    starts = rng.integers(0, len(corpus) - TRAIN_SEQ, batch)
    return np.stack([corpus[s:s + TRAIN_SEQ + 1] for s in starts])


def _train_rank(rank, world, ports, out, depth, corpus):
    """One of 4 processes sharing cuda:0. For each (dp, sp, tp) of
    TRAIN_GROUPS the first dp x sp x tp of them join that mesh through
    parallel/mesh.init_mesh on its own port (gloo: the ranks outnumber the
    card), take TRAIN_GROUP_STEPS steps of parallel/train.make_train_step
    (parallel/sp_train.make_sp_train_step at sp > 1) from the densified
    ``depth`` model (TRAIN_CUT_DEPTH layers) over tp 1's windows, their
    census read a step, and leave it, freeing the card; each rank pickles
    its losses, census and ms a step."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.io.loader import (densify_params,
                                                       load_model)
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel.mesh import close, init_mesh
    from distributed_llama_tpu_torch.parallel.sp_train import \
        make_sp_train_step
    from distributed_llama_tpu_torch.parallel.train import make_train_step

    spec, host = load_model(depth, weights_float_type=FloatType.Q40)
    dense = densify_params(host)
    del host
    torch.set_num_threads(1)  # the ranks share the host's cores
    res = {}
    for port, (dp, sp, tp) in zip(ports, TRAIN_GROUPS):
        if rank >= dp * sp * tp:
            continue
        g = init_mesh(rank, sp, tp, f"tcp://localhost:{port}", "cuda",
                      timeout_s=300, backend="gloo", dp=dp)
        try:
            make = make_sp_train_step if sp > 1 else make_train_step
            init_fn, step_fn = make(spec, g, learning_rate=TRAIN_LR)
            p, o = init_fn(dense)
            run = dict(losses=[], census=[], ms=[])
            for step in range(TRAIN_GROUP_STEPS):
                C.CENSUS.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, loss = step_fn(p, o, _train_windows(corpus, step))
                run["losses"].append(float(loss))
                run["ms"].append((time.perf_counter() - t0) * 1e3)
                run["census"].append({k: c for k, (c, _) in
                                      C.CENSUS.counts.items()})
            res[(dp, sp, tp)] = run
            del p, o, init_fn, step_fn
            torch.cuda.empty_cache()
        finally:
            close(g)
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(res, fh)


def _train_narrow(torch):
    """(b)'s second half: step 0's loss and gradients of a narrow model
    (TRAIN_NARROW, seeded) on the card against the same step on the CPU.
    Returns (loss rel err, worst gradient err over the leaf's max)."""
    import numpy as np

    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.parallel.train import (loss_and_grads,
                                                            make_train_step)

    spec = TransformerSpec(**TRAIN_NARROW)
    rng = np.random.default_rng(TRAIN_SEED)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    tree = {"tok_embedding": t(spec.vocab_size, spec.dim),
            "rms_final": 1 + t(spec.dim),
            "wcls": t(spec.vocab_size, spec.dim),
            "rms_att": 1 + t(spec.n_layers, spec.dim),
            "rms_ffn": 1 + t(spec.n_layers, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        tree[name] = t(spec.n_layers, *shape)
    tok = torch.from_numpy(rng.integers(0, spec.vocab_size, (4, 33)))
    got = {}
    for dev in ("cpu", "cuda"):
        init_fn, _ = make_train_step(spec, learning_rate=TRAIN_LR,
                                     device=dev)
        p, _ = init_fn(tree)
        x = tok.to(dev)
        loss, grads = loss_and_grads(spec, p, x[:, :-1], x[:, 1:],
                                     x[:, 1:].numel())
        got[dev] = float(loss), {k: v.cpu() for k, v in grads.items()}
    (l_cpu, g_cpu), (l_gpu, g_gpu) = got["cpu"], got["cuda"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = max(float((g_gpu[k] - g).abs().max() / g.abs().max())
                   for k, g in g_cpu.items())
    return loss_err, grad_err


def phase_train(torch, depth, dspec, tok, smi):
    """train_full_width: training at 7B width, the weights a cut of the
    Q40 smoke model densified to f32. At TP_DEPTH layers (1.07 B params):
    (a) forward_seq's logits at the last position of one TRAIN_SEQ-token
    window against the port's inference logits after a K3/K4 prefill of
    the same tokens from the Q40 file (llama.LOGIT_RTOL of max|logit|;
    K3 and K4 must launch); (b) the ``train`` CLI at tp 1, TRAIN_STEPS
    steps at --batch TRAIN_BATCH --seq TRAIN_SEQ, losses finite and equal
    to the library's (printed to 4 decimals), and a narrow model's step 0
    on the card against the CPU (loss rtol 1e-5, gradients 1e-5 of each
    leaf's max); (e) ms a step and tokens/s of the CLI's steps after the
    first, its peak device memory. At TRAIN_CUT_DEPTH layers: (d) a 2 + 2
    save/resume run in the library (its checkpoint of params and moments
    written and read in full) gives the 4-step run's losses (rtol 1e-6,
    the JAX gate); (c) gloo ranks sharing the card (_train_rank): dp 2,
    tp 2, dp 2 x tp 2 and sp 2 give the tp 1 steps' losses within
    TRAIN_LOSS_RTOL, their census train_collective_budget's every step,
    and each group's ms a step. Returns the phase's numbers."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.frontend import cli
    from distributed_llama_tpu_torch.io.loader import (densify_params,
                                                       load_model)
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops.quants import FloatType
    from distributed_llama_tpu_torch.parallel.mesh import free_port
    from distributed_llama_tpu_torch.parallel.train import (
        load_train_state, make_train_step, save_train_state,
        template_params, train_collective_budget)

    t0 = time.perf_counter()
    data = SMOKE_DIR / "train_corpus.txt"
    data.write_text(_train_corpus())
    spec, host = load_model(str(depth), weights_float_type=FloatType.Q40)
    corpus = np.asarray(Tokenizer(str(tok), spec.vocab_size).encode(
        data.read_text(), bos=True, eos=False), dtype=np.int32)
    dense = densify_params(host)
    res = {"card": smi, "params": int(sum(v.size for v in dense.values()))}

    # (a) the forward against the kernels
    window = torch.from_numpy(_train_windows(corpus, 0)[:1, :TRAIN_SEQ])
    for k in _all_kernels():
        k.launches = 0
    with torch.inference_mode():
        model = llama.Llama(spec, llama.params_to_device(host, "cuda"))
        want = model(llama.init_cache(spec, "cuda"), window[0].tolist(),
                     0)[-1]
        del model
        dev = {k: torch.from_numpy(v).cuda() for k, v in dense.items()}
        got = llama.forward_seq(spec, dev, window.cuda())[0, -1]
        del dev
    launches = {k.symbol: k.launches for k in _all_kernels() if k.launches}
    err = (got - want).abs().max().item()
    tol = llama.LOGIT_RTOL * want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol
            and launches.get("q40_gemm") and launches.get(
                "prefill_attention")):
        raise AssertionError(f"train (a): forward_seq vs the K3/K4 prefill "
                             f"{err:.3e} (tol {tol:.3e}), launches "
                             f"{launches}")
    res["forward_vs_kernels"] = dict(max_abs_err=err, tol=tol,
                                     launches=launches)
    log(f"train (a): forward_seq's last-position logits against the K3/K4 "
        f"prefill of the same {TRAIN_SEQ} tokens: max_abs_err {err:.3e} "
        f"(tol {tol:.3e} = LOGIT_RTOL x max|logit|), launches {launches}")
    del got, want, host
    gc.collect()
    torch.cuda.empty_cache()

    # (b) + (e) the CLI at tp 1, against the library's steps
    init_fn, step_fn = make_train_step(spec, learning_rate=TRAIN_LR,
                                       device="cuda")
    p, o = init_fn(dense)
    ref = []
    for step in range(TRAIN_STEPS):
        p, o, loss = step_fn(p, o, _train_windows(corpus, step))
        ref.append(float(loss))
    del p, o, init_fn, step_fn, dense
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t_cli = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = cli.main(["train", "--model", str(depth), "--tokenizer",
                       str(tok), "--data", str(data), "--weights-float-type",
                       "q40", "--steps", str(TRAIN_STEPS), "--batch",
                       str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed",
                       str(TRAIN_SEED), "--learning-rate", str(TRAIN_LR)])
    cli_s = time.perf_counter() - t_cli
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lines = re.findall(r"step +(\d+) +loss +([\d.]+) +([\d.]+) ms",
                       buf.getvalue())
    losses = [float(x) for _, x, _ in lines]
    ms = [float(m) for _, _, m in lines]
    if rc != 0 or len(losses) != TRAIN_STEPS or not np.isfinite(
            losses).all() or not np.allclose(losses, ref, rtol=0,
                                             atol=1e-4):
        raise AssertionError(f"train (b): the CLI exited {rc}, losses "
                             f"{losses} against the library's {ref}")
    loss_err, grad_err = _train_narrow(torch)
    if not (loss_err <= 1e-5 and grad_err <= 1e-5):
        raise AssertionError(f"train (b): the narrow model's step on the "
                             f"card against the CPU: loss {loss_err:.2e}, "
                             f"gradients {grad_err:.2e}")
    step_ms = statistics.median(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res["tp1"] = dict(layers=spec.n_layers, losses=losses, ms=ms,
                      ms_per_step=step_ms,
                      tokens_per_s=tokens / step_ms * 1e3,
                      peak_device_gb=peak_gb, cli_s=cli_s,
                      narrow_loss_rel_err=loss_err,
                      narrow_grad_err=grad_err)
    log(f"train (b, e) tp 1, {spec.n_layers} layers ({smi}): losses "
        f"{losses}, {step_ms:.1f} ms a step after the first ({ms}), "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak {peak_gb:.2f} GB, "
        f"CLI {cli_s:.1f} s; narrow model card vs CPU: loss "
        f"{loss_err:.2e}, gradients {grad_err:.2e}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) exact resume in the library, at TRAIN_CUT_DEPTH layers; its
    # unsplit steps are (c)'s reference
    cut = _tp_depth_model(spec, depth, TRAIN_CUT_DEPTH)
    cspec, chost = load_model(str(cut), weights_float_type=FloatType.Q40)
    cdense = densify_params(chost)
    del chost
    init_fn, step_fn = make_train_step(cspec, learning_rate=TRAIN_LR,
                                       device="cuda")
    unsplit, split = [], []
    for losses, n in ((unsplit, 4), (split, 2)):
        p, o = init_fn(cdense)
        for step in range(n):
            p, o, loss = step_fn(p, o, _train_windows(corpus, step))
            losses.append(float(loss))
    del cdense
    ck = SMOKE_DIR / "train_state.npz"
    t_io = time.perf_counter()
    save_train_state(str(ck), cspec, p, o, step=2, data_seed=TRAIN_SEED)
    save_s = time.perf_counter() - t_io
    del p, o
    torch.cuda.empty_cache()
    t_io = time.perf_counter()
    p, o = init_fn(template_params(cspec))
    p, o, at = load_train_state(str(ck), cspec, p, o, return_step=True)
    load_s = time.perf_counter() - t_io
    for step in range(at, at + 2):
        p, o, loss = step_fn(p, o, _train_windows(corpus, step))
        split.append(float(loss))
    ck_bytes = ck.stat().st_size
    ck.unlink()
    del p, o, init_fn, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    if not (np.isfinite(unsplit).all() and np.allclose(
            split, unsplit, rtol=1e-6, atol=0)):
        raise AssertionError(f"train (d): split {split} against unsplit "
                             f"{unsplit}")
    res["resume"] = dict(layers=TRAIN_CUT_DEPTH, losses=unsplit,
                         split=split, ckpt_bytes=ck_bytes, save_s=save_s,
                         load_s=load_s)
    log(f"train (d): {TRAIN_CUT_DEPTH} layer(s) at 7B width, 2 + 2 "
        f"through a {ck_bytes / 1e9:.2f} GB checkpoint (save {save_s:.1f} "
        f"s, load {load_s:.1f} s) gives the 4-step losses {unsplit} (rtol "
        f"1e-6)")

    # (c) the collectives, over gloo ranks sharing the card
    out = SMOKE_DIR / "train.pkl"
    ports = [free_port() for _ in TRAIN_GROUPS]
    t_c = time.perf_counter()
    mp.start_processes(_train_rank, args=(4, ports, str(out), str(cut),
                                          corpus),
                       nprocs=4, start_method="spawn")
    ranks = []
    for r in range(4):
        with open(f"{out}.{r}", "rb") as fh:
            ranks.append(pickle.load(fh))
    res["groups_s"] = time.perf_counter() - t_c
    for dp, sp, tp in TRAIN_GROUPS:
        budget = train_collective_budget(cspec, tp=tp, dp=dp, sp=sp)
        runs = [r[(dp, sp, tp)] for r in ranks if (dp, sp, tp) in r]
        label = f"dp {dp} x sp {sp} x tp {tp}"
        for run in runs:
            if not np.allclose(run["losses"], unsplit[:TRAIN_GROUP_STEPS],
                               rtol=TRAIN_LOSS_RTOL, atol=0) \
                    or any(c != budget for c in run["census"]):
                raise AssertionError(f"train (c) {label}: losses "
                                     f"{run['losses']} against {unsplit}, "
                                     f"census {run['census']}, budget "
                                     f"{budget}")
        worst = max(abs(a / b - 1) for run in runs
                    for a, b in zip(run["losses"], unsplit))
        res[label] = dict(layers=TRAIN_CUT_DEPTH, losses=runs[0]["losses"],
                          ms=runs[0]["ms"], census=budget,
                          loss_rel_err=worst)
        log(f"train (c) {label}, {TRAIN_CUT_DEPTH} layer(s) ({len(runs)} "
            f"gloo ranks sharing the card: {smi}): losses "
            f"{runs[0]['losses']} (worst rel err {worst:.2e}), "
            f"{runs[0]['ms'][-1]:.1f} ms a step ({runs[0]['ms']}), census "
            f"{budget} a step")
    res["seconds"] = time.perf_counter() - t0
    log(f"train_full_width {res['seconds']:.1f} s (groups "
        f"{res['groups_s']:.1f} s)")
    return res

# --------------------------------------------------------------------------
# obs_full_width: profiling and attribution
# --------------------------------------------------------------------------

OBS_TP = 8             # the simulated rank: one of Llama-2-70B's tp 8 ranks
OBS_SEQ = 4096         # its cache's positions (Llama-2-70B's context)
OBS_STEPS = 64         # its decode steps through the host loop
OBS_K2_POS = (63, 4095)


def _obs_rank(torch, timer, peaks):
    """(a) parallel/shard_sim at full width: one 70B tp 8 rank under the
    ref scheme (80 layers of Q40 bands made on the card, the f32
    embedding, a seq-OBS_SEQ cache shard) runs OBS_STEPS decode steps of
    the host loop (TPLlama over the simulated group, each collective a
    local stand-in): every kernel's count set to 0 just before and read
    just after (K1 4L+1 and K2 L a token, nothing else), the census equal
    to tp_collective_budget(70b, 8) a token, the logits finite; then K1
    and K2 against plain at the rank's shapes, the rank's ms a token, and
    project_full_system's sum, printed as a projection beside its
    constants."""
    import dataclasses

    from distributed_llama_tpu_torch.models import synth
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel import shard_sim
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        tp_collective_budget

    from distributed_llama_tpu_torch.analysis.memory_model import \
        device_footprint

    spec = synth.llama2_70b_spec(seq_len=OBS_SEQ)
    L = spec.n_layers
    torch.cuda.synchronize()
    blocks0 = active_blocks(torch)
    t0 = time.perf_counter()
    params = shard_sim.synth_rank_q40(spec, OBS_TP, seed=7, scheme="ref",
                                      device="cuda")
    cache = shard_sim.init_rank_cache(spec, OBS_TP, "cuda")
    fwd = shard_sim.make_rank_forward(spec, OBS_TP, params, "ref")
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    # analysis_full_width (a): the rank's resident bytes against its price
    sim_mem = dict(blocks_since(torch, blocks0),
                   priced=device_footprint(spec, OBS_TP,
                                           "ref").resident_bytes)
    band_gb = sum(t.numel() * t.element_size() for v in params.values()
                  if not isinstance(v, torch.Tensor) for t in v) / 1e9
    embed_gb = params["tok_embedding"].numel() * 4 / 1e9
    cache_gb = 2 * cache.k.numel() * 4 / 1e9
    budget = tp_collective_budget(spec, OBS_TP, "ref")
    for k in _all_kernels():
        k.launches = 0
    C.CENSUS.reset()
    token, finite = 1, True
    with torch.inference_mode():
        for pos in range(OBS_STEPS):
            if pos == 1:  # the first step makes the kernels' plans
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            logits = fwd.forward(cache, token, pos)
            finite = finite and bool(torch.isfinite(logits).all())
            token = int(logits[0].argmax())
        torch.cuda.synchronize()
    ms_token = (time.perf_counter() - t1) * 1e3 / (OBS_STEPS - 1)
    launches = {k.symbol: k.launches for k in _all_kernels() if k.launches}
    census = {k: tuple(v) for k, v in C.CENSUS.counts.items()}
    want_census = {k: (c * OBS_STEPS, b * OBS_STEPS)
                   for k, c, b in budget.entries}
    want = {"q40_matvec": (4 * L + 1) * OBS_STEPS,
            "decode_attention": L * OBS_STEPS}
    log(f"obs (a) shard_sim 70B tp {OBS_TP} rank (ref, {L} layers, seq "
        f"{OBS_SEQ}): {band_gb:.2f} GB of Q40 bands + {embed_gb:.2f} GB "
        f"embedding + {cache_gb:.2f} GB cache made in {made_s:.1f} s; "
        f"{OBS_STEPS} steps: {ms_token:.3f} ms/token (host loop); launches "
        f"{launches}; census {census} (budget x {OBS_STEPS} "
        f"{want_census})")
    if launches != want:
        raise AssertionError(f"obs (a): launches {launches}, want {want}")
    if census != want_census:
        raise AssertionError(f"obs (a): census {census}, want the budget "
                             f"{want_census}")
    if not finite or tuple(logits.shape) != (1, spec.vocab_size):
        raise AssertionError(f"obs (a): logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    del fwd, params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    s, d, hid = OBS_TP, spec.dim, spec.hidden_dim
    k1 = _matvec_rows(torch, timer, peaks, [
        ("wqkv", (d + 2 * spec.kv_dim) // s, d, 1, L),
        ("wo", d // s, d, 1, L), ("w13", 2 * hid // s, d, 1, L),
        ("w2", d // s, hid, 1, L), ("wcls", spec.vocab_size // s, d, 1, 1)],
        seed=70)
    k2 = phase_k2(torch, timer, peaks,
                  cases=[("70b-tp8", 2, spec.n_kv_heads // s, spec.kv_mul)],
                  positions=OBS_K2_POS, seq=OBS_SEQ)
    proj = shard_sim.project_full_system(spec, OBS_TP, ms_token,
                                         scheme="ref")
    log(f"obs (a) projection, not a measurement: {ms_token:.3f} ms/token "
        f"(this rank, measured) + {proj.ici_bandwidth_ms:.4f} ms link "
        f"bandwidth + {proj.ici_latency_ms:.4f} ms latency (modelled: "
        f"{proj.n_collectives} collectives, {proj.gather_bytes_per_chip} B "
        f"a rank a token over {shard_sim.NVLINK_GBPS_PER_DIRECTION} GB/s "
        f"NVLink 4 a direction, datasheet, and "
        f"{shard_sim.COLLECTIVE_LATENCY_US} us a hop, a planning "
        f"assumption) = {proj.total_ms:.3f} ms/token for 70B at tp "
        f"{OBS_TP}; a rank holds {proj.hbm_per_device_gib:.2f} GiB")
    return dict(steps=OBS_STEPS, ms_per_token=ms_token, launches=launches,
                census={k: list(v) for k, v in census.items()},
                band_gb=band_gb, made_s=made_s, k1=k1, k2=k2,
                memory=sim_mem,
                projection=dict(dataclasses.asdict(proj),
                                total_ms=proj.total_ms,
                                gbps=shard_sim.NVLINK_GBPS_PER_DIRECTION,
                                latency_us=shard_sim.COLLECTIVE_LATENCY_US,
                                note="a projection, not a measurement"))


def _tool_run(main, argv):
    """One tool's main(argv) in process: (exit code, its last stdout line
    as JSON or None); its stderr is kept out of the log."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    try:
        return rc, json.loads(lines[-1]) if lines else None
    except ValueError:
        return rc, None


def _obs_traces(torch, spec, model):
    """(b) tools/tracecheck on traces the script already wrote: the tp 2
    --profile run of tp_full_width (gloo ranks sharing the card, the
    fused scheme, TP_DEPTH layers) must give every count row OK and
    exact, coverage at or above COVERAGE_MIN and the time check SKIPped
    (gloo); run q's --fast trace (one card) gives bench_drift_fields'
    OK (no collective time) and its coverage, reported: the kernels the
    CUDA graph replays were launched by cudaGraphLaunch, which no phase
    span encloses, so they land in unattributed."""
    from distributed_llama_tpu_torch.obs.drift import (COVERAGE_MIN,
                                                       bench_drift_fields,
                                                       reconcile_capture)
    from distributed_llama_tpu_torch.tools import tracecheck
    from distributed_llama_tpu_torch.utils.it_split import parse_trace

    depth = SMOKE_DIR / f"{Path(model).stem}_L{TP_DEPTH}.bin"
    prof = SMOKE_DIR / "tp_profile" / "rank0"
    t0 = time.perf_counter()
    rc, row = _tool_run(tracecheck.main, [
        str(prof), "--model", str(depth), "--tp", "2", "--scheme", "fused",
        "--chrome-out", str(SMOKE_DIR / "tracecheck_tp2.json"), "--json"])
    rows = row["rows"] if row else []
    counts = [r for r in rows if r["check"] == "count"]
    time_row = next((r for r in rows if r["check"] == "time"), None)
    log(f"obs (b) tracecheck tp 2 fused ({TP_DEPTH} layers, gloo): exit "
        f"{rc}, {row and row['tokens']} forwards, coverage "
        f"{row and row['coverage']}, rows "
        f"{[(r['check'], r['kind'], r['measured'], r['modeled'], r['verdict']) for r in rows]}; "
        f"phase ms/token {row and row['phase_ms_per_token']} "
        f"({time.perf_counter() - t0:.1f} s)")
    if rc != 0 or not counts or any(r["verdict"] != "OK"
                                    or r["threshold"] != "exact"
                                    for r in counts):
        raise AssertionError(f"obs (b): tracecheck of the tp 2 trace "
                             f"exited {rc}: {rows}")
    if row["coverage"] < COVERAGE_MIN or time_row is None \
            or time_row["verdict"] != "SKIP":
        raise AssertionError(f"obs (b): coverage {row['coverage']}, time "
                             f"{time_row}")
    splits = parse_trace(str(SMOKE_DIR / "profile_q"))
    fields = bench_drift_fields(splits, spec, 1, STEPS, scheme="fused")
    att, rep = reconcile_capture(str(SMOKE_DIR / "profile_q"),
                                 model=str(model), tp=1, scheme="fused",
                                 tokens=STEPS)
    log(f"obs (b) run q (--fast, one card): bench_drift_fields verdict "
        f"{fields['verdict']}, measured collective "
        f"{fields['collectives']['measured_ms_per_token']} ms/token; "
        f"phase coverage {att.coverage:.4f} (the graph's replays "
        f"unattributed), phase ms/token {att.phase_ms_per_token()}")
    if fields["verdict"] != "OK" or att.collectives:
        raise AssertionError(f"obs (b): run q {fields}")
    return dict(tp2=row, run_q=dict(fields, coverage=att.coverage,
                                    phase_ms_per_token=
                                    att.phase_ms_per_token()))


def _obs_sidecar(torch, model, tok, ref_a):
    """(c) io/kernel_cache on the 7B file: a cold load (the file read and
    split, the sidecar written) and a warm one (the sidecar memory-mapped)
    each to the card, timed; run a from the warm load gives run a's
    stream. The sidecar is removed at the end."""
    from distributed_llama_tpu_torch.io import kernel_cache, loader
    from distributed_llama_tpu_torch.models.llama import params_to_device
    from distributed_llama_tpu_torch.ops.quants import FloatType

    side = Path(kernel_cache.sidecar_path(str(model)))
    side.unlink(missing_ok=True)
    patched = loader.load_model
    saved = os.environ.get("DLLAMA_TILED_CACHE")
    os.environ["DLLAMA_TILED_CACHE"] = "1"
    times = {}
    try:
        loader.load_model = getattr(patched, "real", patched)
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            spec, tree = kernel_cache.load_model_packed(
                str(model), FloatType.Q40, FloatType.F32, "cuda")
            t1 = time.perf_counter()
            dev = params_to_device(tree, "cuda")
            torch.cuda.synchronize()
            times[label] = (t1 - t0, time.perf_counter() - t1)
            log(f"obs (c) {label} load of the 7B file: "
                f"{times[label][0]:.2f} s to the host tree"
                + (f" (read, split, {side.stat().st_size / 1e9:.2f} GB "
                   f"sidecar written)" if label == "cold" else
                   " (sidecar memory-mapped)")
                + f", {times[label][1]:.2f} s to the card")
            fused = "wqkv" in tree  # the sidecar's tree is fused
            if fused != (label == "warm"):
                raise AssertionError(f"obs (c) {label}: tree keys "
                                     f"{sorted(tree)}")
            del tree, dev
            gc.collect()
            torch.cuda.empty_cache()
        loader.load_model = patched
        out, counts, wall, _ = _run_cli(torch, model, tok, [
            "--prompt", PROMPT, "--steps", str(STEPS), "--temperature", "0",
            "--seed", "1"])
    finally:
        loader.load_model = patched
        if saved is None:
            os.environ.pop("DLLAMA_TILED_CACHE", None)
        else:
            os.environ["DLLAMA_TILED_CACHE"] = saved
        side.unlink(missing_ok=True)
    same = _pieces(out) == ref_a
    log(f"obs (c) run a from the warm sidecar: stream "
        f"{'equal to' if same else 'DIFFERENT from'} run a's, {wall:.1f} s;"
        f" sidecar removed")
    if not same:
        raise AssertionError("obs (c): run a from the sidecar differs")
    return dict(cold_host_s=times["cold"][0], cold_device_s=times["cold"][1],
                warm_host_s=times["warm"][0], warm_device_s=times["warm"][1],
                run_a_wall_s=wall, launches=counts)


def _int_view(obj):
    """A tool row without its wall-clock floats and fingerprint: what the
    card's run and the CPU's must share."""
    if isinstance(obj, dict):
        return {k: _int_view(v) for k, v in obj.items()
                if k != "env_fingerprint" and not isinstance(v, float)}
    if isinstance(obj, list):
        return [_int_view(v) for v in obj if not isinstance(v, float)]
    return obj


OBS_TOOLS = {  # tool -> its inject arms, each (argv) that must exit 1
    "costcheck": (["--legs", "healthy", "--inject", "double-count-dispatch"],
                  ["--legs", "healthy", "--inject", "leak-ledger"]),
    "watchcheck": (["--inject", "mute-detector"],
                   ["--inject", "jitter-thresholds"]),
    "racecheck": (["--seam", "pool_adopt", "--inject", "drop-a-lock"],
                  ["--seam", "ingest_sweep", "--inject", "reorder-inbox"]),
}


def _obs_tools(torch):
    """(d) costcheck, watchcheck and racecheck with --device cuda: exit 0,
    their rows equal the same tools' rows on the CPU (wall-clock floats
    and fingerprint aside), and each inject arm on the card exits
    exactly 1."""
    import importlib

    out = {}
    threads = torch.get_num_threads()
    for name, arms in OBS_TOOLS.items():
        main = importlib.import_module(
            f"distributed_llama_tpu_torch.tools.{name}").main
        t0 = time.perf_counter()
        rc, row = _tool_run(main, ["--device", "cuda"])
        t1 = time.perf_counter()
        torch.set_num_threads(1)
        try:
            rc_cpu, row_cpu = _tool_run(main, ["--device", "cpu"])
        finally:
            torch.set_num_threads(threads)
        t2 = time.perf_counter()
        arm_rcs = [_tool_run(main, [*argv, "--device", "cuda"])[0]
                   for argv in arms]
        same = row is not None and _int_view(row) == _int_view(row_cpu)
        log(f"obs (d) {name}: card exit {rc} ({t1 - t0:.1f} s), cpu exit "
            f"{rc_cpu} ({t2 - t1:.1f} s), rows "
            f"{'equal' if same else 'DIFFERENT'}; inject arms on the card "
            f"exit {arm_rcs} ({time.perf_counter() - t2:.1f} s)")
        if rc != 0 or rc_cpu != 0 or not same or arm_rcs != [1] * len(arms):
            raise AssertionError(f"obs (d) {name}: exits {rc}/{rc_cpu}, "
                                 f"rows equal {same}, arms {arm_rcs}")
        out[name] = dict(card_s=t1 - t0, cpu_s=t2 - t1, arms=arm_rcs,
                         gate=row.get("gate") if "gate" in row
                         else {"ok": row.get("ok")})
    return out


def phase_obs(torch, peaks, spec, model, tok, ref_a):
    """obs_full_width: (a) _obs_rank, (b) _obs_traces, (c) _obs_sidecar,
    (d) _obs_tools."""
    t0 = time.perf_counter()
    timer = Timer(torch)
    rank = _obs_rank(torch, timer, peaks)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    traces = _obs_traces(torch, spec, model)
    t2 = time.perf_counter()
    sidecar = _obs_sidecar(torch, model, tok, ref_a)
    t3 = time.perf_counter()
    tools = _obs_tools(torch)
    t4 = time.perf_counter()
    log(f"obs_full_width: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {t4 - t3:.1f} s")
    return dict(rank=rank, traces=traces, sidecar=sidecar, tools=tools,
                seconds=dict(a=t1 - t0, b=t2 - t1, c=t3 - t2, d=t4 - t3))


# --------------------------------------------------------------------------
# analysis_full_width: the memory model and the sync census on the card
# --------------------------------------------------------------------------

ANALYSIS_STEPS = 8       # (b): host-loop steps and --fast replays
ANALYSIS_DISPATCHES = 4  # (b): continuous dispatches (16-step chains)
ANALYSIS_PAGES = CONT_SLOTS * CONT_STEPS // PAGE  # (a): each pool's pages


def card_in_use(torch) -> int:
    """Bytes in use on the card (mem_get_info), read before this process
    allocates anything: the CUDA context and whatever else holds the
    card."""
    free, total = torch.cuda.mem_get_info(0)
    return total - free


def active_blocks(torch) -> dict:
    """The caching allocator's live blocks: address -> (block bytes, the
    bytes the tensor asked for)."""
    return {b["address"]: (b["size"], b.get("requested_size", b["size"]))
            for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
            if b["state"] == "active_allocated"}


def blocks_since(torch, before: dict) -> dict:
    """What the allocator handed out since ``before`` (active_blocks) and
    still holds: blocks, their bytes, the bytes the tensors asked for,
    and memory_allocated()'s count of them."""
    new = [v for a, v in active_blocks(torch).items() if a not in before]
    return dict(blocks=len(new), allocated=sum(s for s, _ in new),
                requested=sum(r for _, r in new))


def _check_resident(label: str, got: dict, priced: int) -> None:
    """The tensors asked for exactly the priced bytes; memory_allocated()
    holds them plus the allocator's rounding of each block (512 B, and a
    large block's unsplit tail under 1 MiB)."""
    log(f"analysis (a) {label}: {got['blocks']} blocks asked for "
        f"{got['requested']} B, priced {priced} B; memory_allocated "
        f"+{got['allocated']} B (allocator rounding "
        f"{got['allocated'] - got['requested']} B)")
    if got["requested"] != priced:
        raise AssertionError(f"analysis (a): {label} asked for "
                             f"{got['requested']} B, priced {priced} B")
    if not 0 <= got["allocated"] - got["requested"] < (1 << 20) * \
            got["blocks"]:
        raise AssertionError(f"analysis (a): {label}: rounding "
                             f"{got['allocated'] - got['requested']} B")


class SyncCensus:
    """torch.cuda.set_sync_debug_mode("warn") around a block: every sync
    the card reports is kept as the file:line of its innermost frame in
    the port's package, and judged against the D001 pragmas there (a sync
    is allowed only on a line a ``# dlint: allow[D001]`` pragma covers)."""

    def __init__(self, torch):
        self.torch = torch
        self.sites: collections.Counter = collections.Counter()

    def __enter__(self):
        import traceback
        import warnings

        pkg = str(ROOT / "distributed_llama_tpu_torch") + os.sep

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if "synchronizing CUDA operation" not in str(message):
                return
            for fr in reversed(traceback.extract_stack()[:-1]):
                if fr.filename.startswith(pkg):
                    rel = Path(fr.filename).relative_to(ROOT).as_posix()
                    self.sites[(rel, fr.lineno)] += 1
                    return
            self.sites[(f"{filename} (outside the package)", lineno)] += 1

        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = hook
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._warn.__exit__(*exc)
        return False

    def disallowed(self) -> list:
        from distributed_llama_tpu_torch.analysis.lint import parse_pragmas

        bad = []
        for rel, line in self.sites:
            path = ROOT / rel
            if not path.is_file():
                bad.append((rel, line))
                continue
            same, below = parse_pragmas(path.read_text().splitlines())
            if "D001" not in same.get(line, set()) | below.get(line, set()):
                bad.append((rel, line))
        return sorted(bad)


def _peak_over(torch, fn) -> tuple[int, int]:
    """(max_memory_allocated() during ``fn`` less what was allocated just
    before it, the bytes still held after it less that)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base,
            torch.cuda.memory_allocated() - base)


def phase_analysis(torch, engine, tokenizer, load, card0, sim_mem):
    """analysis_full_width on the 7B engine phase_full_width loaded (and
    obs_full_width's 70B tp 8 rank, measured there):
    (a) the card's capacity against memory_model.CARD_MEMORY_BYTES; the
    memory in use before the first allocation inside the headroom; the
    load's new allocator blocks (memory_snapshot) against the priced
    weights + replicated + RoPE table + cache: the bytes the tensors asked
    for equal the price exactly, and memory_allocated() holds them plus
    the allocator's rounding of each block; max_memory_allocated() over
    a host-loop step, a --fast replay and a 128-token prefill chunk, less
    what was allocated before, against the priced activations +
    workspaces of that width; the continuous f32 and Q8 pools against
    their price; the 70B rank's resident bytes against its price.
    (b) the sync census (SyncCensus) over ANALYSIS_STEPS host-loop steps,
    as many --fast replays and ANALYSIS_DISPATCHES continuous dispatches:
    the syncs a step, each site's file:line; red on a site no D001 pragma
    allows. (c) python -m distributed_llama_tpu_torch.analysis --all
    --device cuda exits 0 (its main, in this process)."""
    import numpy as np

    from distributed_llama_tpu_torch.analysis import memory_model as M
    from distributed_llama_tpu_torch.runtime.continuous import (
        ContinuousEngine, Request)

    spec = engine.spec
    res = {}
    t0 = time.perf_counter()
    # (a) capacity and the context
    total = torch.cuda.get_device_properties(0).total_memory
    headroom = int(M.CARD_MEMORY_BYTES * M.MEMORY_HEADROOM_FRACTION)
    log(f"analysis (a) card: total_memory {total} B (model "
        f"{M.CARD_MEMORY_BYTES}); in use before the first allocation "
        f"{card0} B, headroom {headroom} B")
    if total != M.CARD_MEMORY_BYTES:
        raise AssertionError(f"analysis (a): total_memory {total} != "
                             f"CARD_MEMORY_BYTES {M.CARD_MEMORY_BYTES}")
    if not 0 < card0 <= headroom:
        raise AssertionError(f"analysis (a): {card0} B in use before the "
                             f"first allocation, headroom {headroom}")
    rep = M.device_footprint(spec, 1, "fused", model="7b")
    want = rep.resident_bytes
    log(f"analysis (a) the 7B load's price: {want} B (weights "
        f"{rep.weights_bytes} + replicated {rep.replicated_bytes} + RoPE "
        f"{rep.rope_bytes} + cache {rep.kv_cache_bytes})")
    _check_resident("load", load, want)
    res["load"] = dict(load, priced=want)
    # peaks over one step of each width
    tokens = tokenizer.encode(PROMPT_512)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    loop = engine.decode_loop(0.0, 0.9)
    first, coins = np.array([tokens[0]]), np.zeros((1, loop.max_steps),
                                                  np.float32)
    prompts = np.full((1, loop.max_steps + 1), -1, np.int64)
    with torch.inference_mode():
        loop.run(prompts, first, coins, np.array([0], np.int32), 2)
    peaks = {}
    for label, t_len, fn in (
            ("host-loop step", 1, lambda: engine.infer(tokens[1], 1)),
            ("--fast replay", 1, lambda: loop.run(
                prompts, first, coins, np.array([2], np.int32), 1)),
            (f"prefill chunk of {CHUNK}", CHUNK,
             lambda: engine.prefill(tokens[:CHUNK], 0, chunk=CHUNK))):
        with torch.inference_mode():
            peak, kept = _peak_over(torch, fn)
        price = (M.activation_bytes_analytic(spec, 1, t_len)
                 + M.kernel_workspace_bytes(spec, 1, t_len, sms=sms))
        log(f"analysis (a) {label}: peak {peak} B over the resident "
            f"({kept} B kept), priced activations + workspaces {price} B")
        if peak > price:
            raise AssertionError(f"analysis (a): {label} peaked {peak} B "
                                 f"over the resident, priced {price} B")
        peaks[label] = dict(peak=peak, kept=kept, priced=price)
    res["peaks"] = peaks
    pools, engines = {}, {}
    for kv_quant in ("f32", "q8"):
        eng = ContinuousEngine(
            spec, engine.params, CONT_SLOTS, 0.0, 0.9, 1,
            prefill_chunk=CONT_CHUNK, block_steps=16, page_size=PAGE,
            kv_pages=ANALYSIS_PAGES,
            kv_quant=None if kv_quant == "f32" else kv_quant)
        got = sum(t.nbytes for t in eng.cache)
        priced = M.kv_page_pool_bytes(spec, 1, ANALYSIS_PAGES, PAGE,
                                      kv_quant=kv_quant)
        log(f"analysis (a) continuous {kv_quant} pool: {got} B, priced "
            f"{priced} B ({ANALYSIS_PAGES} pages of {PAGE} + the scrap "
            f"page)")
        if got != priced:
            raise AssertionError(f"analysis (a): the {kv_quant} pool holds "
                                 f"{got} B, priced {priced} B")
        pools[kv_quant] = dict(bytes=got, priced=priced)
        engines[kv_quant] = eng
    res["pools"] = pools
    _check_resident(f"70B tp {OBS_TP} rank", sim_mem, sim_mem["priced"])
    res["rank_70b"] = sim_mem
    t1 = time.perf_counter()
    # (b) the sync census
    eng = engines["f32"]
    eng.capture_graphs()
    census = {}
    segments = (
        ("host-loop steps", ANALYSIS_STEPS, lambda: [
            engine.infer(t, 8 + i)
            for i, t in enumerate(tokens[:ANALYSIS_STEPS])]),
        ("--fast replays", ANALYSIS_STEPS, lambda: loop.run(
            prompts, first, coins, np.array([16], np.int32),
            ANALYSIS_STEPS)),
        ("continuous dispatches", ANALYSIS_DISPATCHES, lambda: [
            eng.step_many(16) for _ in range(ANALYSIS_DISPATCHES)]))
    for r in (tokenizer.encode(CONT_PROMPTS[0]),
              tokenizer.encode(CONT_PROMPTS[1])):
        eng.submit(Request(tokens=list(r), steps=CONT_STEPS))
    bad = []
    for label, n, fn in segments:
        with torch.inference_mode(), SyncCensus(torch) as c:
            fn()
        torch.cuda.synchronize()
        sites = {f"{rel}:{line}": k for (rel, line), k in
                 sorted(c.sites.items())}
        syncs = sum(c.sites.values())
        log(f"analysis (b) {label}: {syncs} syncs over {n} "
            f"({syncs / n:.2f} a step) at {sites}")
        census[label] = dict(n=n, syncs=syncs, per_step=syncs / n,
                             sites=sites)
        bad += [f"{rel}:{line} ({label})" for rel, line in c.disallowed()]
    if bad:
        raise AssertionError(f"analysis (b): syncs at sites no D001 pragma "
                             f"allows: {bad}")
    res["sync_census"] = census
    engines.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    # (c) the analysis gate on the card host: the CLI's main in process
    # (a child would spend its start-up reaching the card again)
    from distributed_llama_tpu_torch.analysis.__main__ import main as gate

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = gate(["--all", "--device", "cuda"])
    tail = out.getvalue().strip().splitlines()
    contracts = [ln for ln in tail if " contract " in ln]
    summary = [ln for ln in tail if ln not in contracts and ln.startswith(
        ("dlint:", "threadcheck:", "wirecheck:", "shardcheck: 8"))]
    log(f"analysis (c) --all --device cuda: exit {rc}; {summary}; "
        f"{len(contracts)} contracts")
    for ln in contracts:
        log(f"  {ln}")
    if rc != 0:
        raise AssertionError(f"analysis (c): exit {rc}: {tail[-20:]}")
    res["cli"] = dict(rc=rc, summary=summary, contracts=contracts)
    t3 = time.perf_counter()
    res["seconds"] = dict(a=t1 - t0, b=t2 - t1, c=t3 - t2)
    log(f"analysis_full_width: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
        f"(c) {t3 - t2:.1f} s")
    return res


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
    # every load but obs_full_width's (c) reads the .bin: no phase before
    # it writes the 4.2 GB device-layout sidecar (io/kernel_cache.py)
    os.environ["DLLAMA_TILED_CACHE"] = "0"
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(label):
        marks.append((label, time.perf_counter()))

    writer = start_smoke_writer()
    card0 = card_in_use(torch)  # analysis_full_width (a): before any tensor
    smi, name, peaks, build_s = phase_card(torch)
    sass = phase_sass()
    mark("card and build")
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
    k6 = phase_k6(torch, timer, peaks)
    mark("kernels K1-K7 against plain")
    tp_bands = phase_tp_bands(torch, timer, peaks)
    mark("K1, K1m and K3 at tp band shapes")
    fused_rows = phase_fused(torch, timer, peaks)
    mark("fused kernels K8-K10 against plain")
    probe_rows, probe = phase_probe(torch, timer, peaks)
    mark("probe kernels P1-P4 and the probe's chain")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    spec, model, tok = smoke_files(writer)
    mark("smoke model")
    e2e, out_a, ref_a = phase_e2e(torch, model, tok)
    reuse_done = _reuse_loads(model)  # run a read the file; the rest reuse it
    e2e_prefill = phase_e2e_prefill(torch, model, tok, spec)
    e2e_q80, ref_c = phase_e2e_q80(torch, model, tok, spec)
    e2e_bf16 = phase_e2e_bf16(torch, model, tok, spec, e2e_prefill)
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
    e2e_fast = phase_e2e_fast(torch, model, tok, spec, _pieces(out_a),
                              e2e_prefill.pop("pieces"))
    e2e_fused = phase_e2e_fused(torch, model, tok, spec.n_layers, ref_a)
    e2e_profile = phase_e2e_profile(torch, model, tok, spec.n_layers,
                                    _pieces(out_a))
    e2e_resume = phase_e2e_resume(torch, model, tok, spec.n_layers,
                                  _pieces(out_a))
    mark("CLI runs a-j, o-r")
    e2e_cont, ref_k, gaps_k = phase_e2e_continuous_runs(torch, model, tok,
                                                        spec.n_layers)
    mark("CLI runs k-n, s-u")
    gc.collect()
    torch.cuda.empty_cache()
    e2e_serve = phase_serve(torch, model, tok, ref_k, gaps_k, smi)
    mark("serve_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    e2e_tier = phase_tier(torch, model, tok, spec.n_layers, ref_k, gaps_k,
                          smi)
    mark("tier_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    e2e_disagg = phase_disagg(torch, model, tok, spec, ref_k, gaps_k, smi,
                              e2e_serve)
    mark("disagg_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    e2e_chaos = phase_chaos(torch, model, tok, spec, ref_k, gaps_k, smi,
                            e2e_serve)
    mark("chaos_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    tp, tp_launches = tp_full_width(torch, spec, model, tok, ref_a, ref_c,
                                    smi)
    mark("tp_full_width")
    import dataclasses

    depth = _tp_depth_model(spec, model)
    dspec = dataclasses.replace(spec, n_layers=TP_DEPTH)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp, serve_tp_launches = phase_serve_tp(torch, depth, dspec, tok,
                                                 smi, e2e_serve)
    mark("serve_tp_full_width")
    sp, sp_launches = phase_sp(torch, depth, dspec, tok, smi)
    mark("sp_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(torch, depth, dspec, tok, smi)
    mark("train_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    obs = phase_obs(torch, peaks, spec, model, tok, _pieces(out_a))
    mark("obs_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    (logit_err, busy, prefill, fast, batch, continuous,
     analysis) = phase_full_width(torch, model, tok, peaks, ref_a, card0,
                                  obs["rank"]["memory"])
    mark("full width and analysis_full_width")
    small_err = phase_small_reference(torch)
    mark("small model")

    def per_token(rows):
        return {key: sum(r[key] * r["per_token"] for r in rows)
                for key in ("ms", "plain_ms", "bound_ms")}

    def matvec_row(name, rows, replaces, unit):
        """K1's or K1m's row: the unit's sums, with the tensor-core and f32
        SIMT bounds of the same work beside the bound."""
        unit_rows = [r for r in rows if r["per_token"]]
        return dict(name=name, route="cuda",
                    source="distributed_llama_tpu_torch/csrc/q40_matvec.cu",
                    replaces=f"distributed_llama_tpu/ops/{replaces}",
                    launches=CLI_LAUNCHES[name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **per_token(unit_rows), bound_by=_bound_by(unit_rows),
                    library_ms=sum(r["library_ms"] * r["per_token"]
                                   for r in unit_rows),
                    **{key: sum(r[key] * r["per_token"] for r in unit_rows)
                       for key in ("tc_bound_ms", "simt_bound_ms")},
                    unit=unit, shapes=rows)

    # K2 per token: 32 layers at the deepest position of the smoke run
    k2_63 = [dict(r, per_token=32) for r in k2
             if r["case"] == "7b" and r["pos"] == 63]
    k2_tok = per_token(k2_63)
    kernels = [
        matvec_row("q40_matvec", k1, "pallas_q40.py:696",
                   "one 7B token: 32 x (wqkv, wo, w13, w2) + wcls at T = 1; "
                   "tc_bound_ms = the tensor-core work issued (8 columns a "
                   "column set, bf16 rate), simt_bound_ms = the same "
                   "product on the f32 cores; library = cuBLAS f32 GEMV on "
                   "the weight dequantized beforehand (dequant not timed)"),
        dict(name="decode_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/decode_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:304",
             launches=CLI_LAUNCHES["decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k2), **k2_tok,
             bound_by=_bound_by(k2_63),
             library_ms=sum(r["library_ms"] * 32 for r in k2_63),
             unit="one 7B token at pos 63: 32 layers", shapes=k2),
    ]

    def unit_row(rows):
        unit = [r for r in rows if r["per_token"]]
        row = dict(per_token(unit), bound_by=_bound_by(unit),
                   library_ms=sum(r["library_ms"] * r["per_token"]
                                  for r in unit))
        if unit and unit[0].get("simt_bound_ms") is not None:
            # the 3xTF32 kernels: the f32 SIMT bound of the same product
            row["simt_bound_ms"] = sum(r["simt_bound_ms"] * r["per_token"]
                                       for r in unit)
        return row

    k4_unit = [dict(r, per_token=32) for r in k4
               if r["case"] == "7b" and r["pos"] == 384]
    kernels += [
        matvec_row("q40_matvec_multi", k1m, "pallas_q40.py:730",
                   f"one 7B {Q80_CHUNK}-token step: 32 x (wqkv, wo, w13, "
                   f"w2) at T = {Q80_CHUNK}; tc_bound_ms and simt_bound_ms "
                   f"as K1's; library = cuBLAS SGEMM on the weight "
                   f"dequantized beforehand (dequant not timed)"),
        dict(name="q40_gemm", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_gemm.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:749",
             launches=CLI_LAUNCHES["q40_gemm"],
             max_abs_err=max(r["max_abs_err"] for r in k3), **unit_row(k3),
             parts=[dict(name=p, launches=CLI_LAUNCHES[p])
                    for p in ("q40_split_tf32", "q40_gemm_bf16_reduce")],
             unit=f"one 7B {CHUNK}-token chunk: 32 x (wqkv, wo, w13, w2) "
                  f"at T = {CHUNK}, with the x split pass and the split-K "
                  f"sum (parts); bound = 3 TF32 passes, simt_bound_ms = "
                  f"the same product on the f32 cores; library = cuBLAS "
                  f"SGEMM (TF32 off) on the weight dequantized beforehand "
                  f"(dequant not timed)",
             shapes=k3),
        dict(name="prefill_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/prefill_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:492",
             launches=CLI_LAUNCHES["prefill_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k4),
             **unit_row(k4_unit),
             parts=[dict(name="prefill_attention_bf16_combine",
                         launches=CLI_LAUNCHES[
                             "prefill_attention_bf16_combine"])],
             unit=f"one 7B {CHUNK}-token chunk at pos 384, with the split "
                  f"combine (parts): 32 layers; bound = 3 TF32 passes, "
                  f"simt_bound_ms = the same dots on the f32 cores; library "
                  f"= scaled_dot_product_attention in f32 with the causal "
                  f"offset mask over the live prefix", shapes=k4),
    ]
    def at_pos(rows, pos):
        return [dict(r, per_token=32) for r in rows
                if r["case"] == "7b" and r["pos"] == pos]

    def attention_row(name, source, replaces, rows, pos, unit, parts=()):
        unit_rows = at_pos(rows, pos)
        row = dict(name=name, route="cuda",
                   source=f"distributed_llama_tpu_torch/csrc/{source}",
                   replaces=f"distributed_llama_tpu/ops/{replaces}",
                   launches=CLI_LAUNCHES[name],
                   max_abs_err=max(r["max_abs_err"] for r in rows),
                   **unit_row(unit_rows), unit=unit, shapes=rows)
        if any(r["library_bf16_ms"] is not None for r in unit_rows):
            row["library_bf16_ms"] = sum(r["library_bf16_ms"] * 32
                                         for r in unit_rows)
        if parts:  # helper kernels launched inside the wrapper's time
            row["parts"] = [dict(name=p, launches=CLI_LAUNCHES[p])
                            for p in parts]
        return row

    sdpa = ("library = scaled_dot_product_attention in bf16 with the "
            "causal offset mask over the live prefix")
    sdpa_f32 = ("library = scaled_dot_product_attention in f32 (K4's "
                "function) with the causal offset mask over the live "
                "prefix cast to f32 beforehand (cast not timed); "
                "library_bf16_ms = the same SDPA in bf16, another function")
    kernels += [
        attention_row("decode_attention_kvbf16", "decode_attention.cu",
                      "pallas_attention.py:304", k2_kvbf16, 63,
                      "one 7B token at pos 63 over a bf16 cache: 32 layers;"
                      " library = scaled_dot_product_attention in f32 (K2's"
                      " function) over the live prefix cast to f32 "
                      "beforehand (cast not timed); library_bf16_ms = the "
                      "same SDPA in bf16, another function"),
        dict(name="q40_gemm_bf16", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_gemm_bf16.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:749",
             launches=CLI_LAUNCHES["q40_gemm_bf16"],
             max_abs_err=max(r["max_abs_err"] for r in k3b),
             **unit_row(k3b),
             parts=[dict(name=p, launches=CLI_LAUNCHES[p])
                    for p in ("q40_round_bf16", "q40_gemm_bf16_reduce")],
             unit=f"one 7B {CHUNK}-token chunk: 32 x (wqkv, wo, w13, w2) "
                  f"at T = {CHUNK}, with the x rounding pass and the "
                  f"split-K sum (parts); library = "
                  f"{k3b[0]['library']} (cuBLAS) on the weight dequantized "
                  f"to bf16 beforehand (dequant not timed)", shapes=k3b),
        attention_row("prefill_attention_kvbf16", "prefill_attention.cu",
                      "pallas_attention.py:492", k4_kvbf16, 384,
                      f"one 7B {CHUNK}-token chunk at pos 384 over a bf16 "
                      f"cache, f32-accurate dots (2 TF32 passes), with the "
                      f"split combine (parts): 32 layers; {sdpa_f32}",
                      parts=("prefill_attention_bf16_combine",)),
        attention_row("prefill_attention_bf16", "prefill_attention_bf16.cu",
                      "pallas_attention.py:492", k4b, 384,
                      f"one 7B {CHUNK}-token chunk at pos 384, bf16 dots, "
                      f"f32 cache, with the split combine (parts): 32 "
                      f"layers; {sdpa}",
                      parts=("prefill_attention_bf16_combine",)),
        attention_row("prefill_attention_bf16_kvbf16",
                      "prefill_attention_bf16.cu", "pallas_attention.py:492",
                      k4b_kvbf16, 384,
                      f"one 7B {CHUNK}-token chunk at pos 384, bf16 dots, "
                      f"bf16 cache, with the split combine (parts): 32 "
                      f"layers; {sdpa}",
                      parts=("prefill_attention_bf16_combine",)),
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
             launches=CLI_LAUNCHES["decode_attention_batch"],
             max_abs_err=max(r["max_abs_err"] for r in k5),
             **unit_row(k5_unit),
             unit=f"one 7B step of {BATCH} rows at shared pos 63: 32 "
                  f"layers; {batch_sdpa}", shapes=k5),
        dict(name="decode_attention_batch_kvbf16", route="cuda",
             source="distributed_llama_tpu_torch/csrc/decode_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:175",
             launches=CLI_LAUNCHES["decode_attention_batch_kvbf16"],
             max_abs_err=max(r["max_abs_err"] for r in k5_kvbf16),
             **unit_row(k5b_unit),
             unit=f"one 7B step of {BATCH} rows at shared pos 63 over a "
                  f"bf16 cache: 32 layers; {batch_sdpa} (bf16)",
             shapes=k5_kvbf16),
        dict(name="q40_matvec_bf16", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matvec_bf16.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:713",
             launches=CLI_LAUNCHES["q40_matvec_bf16"],
             max_abs_err=max(r["max_abs_err"] for r in k1d),
             **unit_row(k1d),
             unit=f"one 7B {BATCH}-row step: 32 x (wqkv, wo, w13, w2) at "
                  f"T = {BATCH}; library = {k1d[0]['library']} (cuBLAS) on "
                  f"the weight dequantized to bf16 beforehand (dequant not "
                  f"timed)", shapes=k1d),
    ]

    def paged_row(name, pages, what):
        rows = [r for r in k6 if r["pages"] == pages and r["t_len"] == 1]
        unit_rows = [dict(r, per_token=32) for r in rows
                     if r["case"] == "7b" and r["batch"] == CONT_SLOTS
                     and r["pos"] == "shared 63" and r["t_len"] == 1]
        return dict(name=name, route="cuda",
                    source="distributed_llama_tpu_torch/csrc/"
                           "paged_attention.cu",
                    replaces="distributed_llama_tpu/ops/"
                             "pallas_paged_attention.py:"
                             + ("332" if pages == "q8" else "285"),
                    launches=CLI_LAUNCHES[name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **unit_row(unit_rows),
                    gather_ms=sum(r["gather_ms"] * 32 for r in unit_rows),
                    k5_ms=sum(r["k5_ms"] * 32 for r in unit_rows),
                    per_shape=[{k: r[k] for k in (
                        "case", "batch", "pos", "ms", "bound_ms", "k5_ms",
                        "library_ms", "gather_ms")}
                        for r in rows if r["t_len"] == 1],
                    unit=f"one 7B step of {CONT_SLOTS} rows at shared pos "
                         f"63, t_len 1, over {what} pages of {PAGE}: 32 "
                         f"layers; library = scaled_dot_product_attention "
                         f"over the live pages gathered beforehand (the "
                         f"gather{', with the dequantize,' if pages == 'q8' else ''}"
                         f" timed apart as gather_ms); k5_ms = K5 on the "
                         f"same values in a contiguous cache; per_shape = "
                         f"each t_len 1 shape a layer",
                    shapes=rows)

    def window_row(name, pages, what, t_len):
        """K6w's or K7w's row at a verify or mixed window of t_len
        queries: one 7B dispatch of CONT_SLOTS rows at shared pos 63, and
        one layer at shared pos 2047 beside it."""
        rows = [r for r in k6 if r["pages"] == pages and r["t_len"] > 1]
        at_t = [r for r in rows if r["t_len"] == t_len
                and r["case"] == "7b" and r["batch"] == CONT_SLOTS]
        unit_rows = [dict(r, per_token=32) for r in at_t
                     if r["pos"] == "shared 63"]
        far = next(r for r in at_t if r["pos"] == "shared 2047")
        return dict(name=name, route="cuda", t_len=t_len,
                    source="distributed_llama_tpu_torch/csrc/"
                           "paged_window.cu",
                    replaces="distributed_llama_tpu/ops/"
                             "pallas_paged_attention.py:"
                             + ("332" if pages == "q8" else "285"),
                    launches=CLI_LAUNCHES[name],
                    window_launches=WINDOW_LAUNCHES.get((name, t_len), 0),
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **unit_row(unit_rows),
                    gather_ms=sum(r["gather_ms"] * 32 for r in unit_rows),
                    walk_ms=sum(r["walk_ms"] * 32 for r in unit_rows),
                    pos_2047={k: far[k] for k in (
                        "ms", "bound_ms", "bound_by", "library_ms",
                        "gather_ms", "walk_ms")},
                    unit=f"one 7B dispatch of {CONT_SLOTS} rows at shared "
                         f"pos 63, t_len {t_len} queries a row, over {what} "
                         f"pages of {PAGE}: 32 layers; launches = the "
                         f"kernel's over every run, window_launches = "
                         f"those at this t_len (runs s-u); library = "
                         f"scaled_dot_product_attention with the window's "
                         f"causal mask over the live pages gathered "
                         f"beforehand (gather timed apart as gather_ms); "
                         f"walk_ms = the split walk K6/K7 ran windows with "
                         f"before (one block a (row, query)); pos_2047 = "
                         f"one layer at shared pos 2047; shapes = every "
                         f"window shape a layer",
                    shapes=rows)

    kernels += [
        paged_row("paged_attention", "f32", "f32"),
        paged_row("paged_attention_kvbf16", "bf16", "bf16"),
        paged_row("paged_attention_q8", "q8", "Q8"),
        *(window_row(name, pages, what, t)
          for name, pages, what in (
              ("paged_window", "f32", "f32"),
              ("paged_window_kvbf16", "bf16", "bf16"),
              ("paged_window_q8", "q8", "Q8"))
          for t in (16, MIXED_BUDGET)),
    ]
    def fused_row(name, kind, rows, unit):
        unit_rows = [r for r in rows if r["per_token"]]
        site = {"head": 451, "tail": 349, "mega": 782}[kind]
        return dict(name=name, route="cuda",
                    source="distributed_llama_tpu_torch/csrc/fused_layer.cu",
                    replaces=f"distributed_llama_tpu/ops/pallas_layer.py:"
                             f"{site}",
                    launches=CLI_LAUNCHES[name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **per_token(unit_rows), bound_by=_bound_by(unit_rows),
                    library_ms=None,
                    unfused_ms=sum(r["unfused_ms"] * r["per_token"]
                                   for r in unit_rows),
                    unit=unit, shapes=rows)

    unfused_note = ("library_ms null: no single PyTorch call computes it; "
                    "unfused_ms = the unfused port path for the same work "
                    "(K1, K2 and torch glue)")
    kernels += [
        fused_row("q40_head_fused", "head", fused_rows["head"],
                  f"one 7B token at pos 63: 32 layers; {unfused_note}"),
        fused_row("q40_tail_fused", "tail", fused_rows["tail"],
                  f"one 7B token: 32 layers; {unfused_note}"),
        fused_row("q40_layer_mega", "mega", fused_rows["mega"],
                  f"one 7B token at pos 63 over an f32 cache: 32 layers; "
                  f"{unfused_note}"),
    ]
    def probe_row(variant, name):
        rows = [r for r in probe_rows if r["variant"] == variant]
        w13 = next(r for r in rows if r["shape"] == "w13")
        traced = next(r for r in probe["results"] if r["variant"] == variant)
        return dict(name=name, route="cuda",
                    source="distributed_llama_tpu_torch/csrc/nb_probe.cu",
                    replaces="tools/nb_probe.py:"
                             + ("181" if variant == "i4" else "162"),
                    launches=probe["launches"][name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **{k: w13[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
                    trace_ms=traced["ms"], chain_event_ms=traced["event_ms"],
                    unit="one call at the 13B w13 shape (27648 x 5120); "
                         "library = cuBLAS f32 GEMV on the weight "
                         "dequantized beforehand (dequant not timed; none "
                         "for the XOR fold); trace_ms = the probe's traced "
                         "chain per call", shapes=rows)

    kernels += [probe_row(v, name) for v, name in PROBE_KERNELS.items()]

    band_units = {
        "q40_matvec": "one 7B token on one rank of the fused scheme: 32 x "
                      "(wqkv, wo, w13, w2 bands) + the wcls band at T = 1 "
                      "(the ref scheme's wo and w2 row bands in shapes)",
        "q40_matvec_multi": f"one 7B {Q80_CHUNK}-token step on one rank: "
                            f"32 x the four layer bands at T = {Q80_CHUNK}",
        "q40_gemm": f"one 7B {CHUNK}-token chunk on one rank: 32 x the four "
                    f"layer bands at T = {CHUNK}, with its parts"}
    for k in kernels:
        # each kernel's launches on rank 0 over tp_full_width's runs
        k["tp_launches"] = {str(w): tp_launches[w].get(k["name"], 0)
                            for w in TP_SIZES}
        # rank 0 of serve --tp 2 (the serve child's own counts) and of
        # the sp runs
        k["tp_launches"]["serve_tp2"] = serve_tp_launches.get(k["name"], 0)
        k["tp_launches"]["sp"] = sp_launches.get(k["name"], 0)
        if k["name"] in band_units:
            k["tp_bands"] = {
                str(w): dict(unit_row(tp_bands[w][k["name"]]),
                             bytes_bound_ms=sum(
                                 r["bytes_bound_ms"] * r["per_token"]
                                 for r in tp_bands[w][k["name"]]),
                             max_abs_err=max(r["max_abs_err"] for r in
                                             tp_bands[w][k["name"]]),
                             launches=tp_launches[w].get(k["name"], 0),
                             unit=band_units[k["name"]],
                             shapes=tp_bands[w][k["name"]])
                for w in TP_SIZES}
    sim = obs["rank"]
    for k in kernels:
        if k["name"] in ("q40_matvec", "decode_attention"):
            # the 70B tp 8 rank of obs_full_width: its launches over its
            # OBS_STEPS host-loop steps, and the kernel at its shapes
            k1 = k["name"] == "q40_matvec"
            rows = (sim["k1"] if k1 else
                    [dict(r, per_token=80) for r in sim["k2"]
                     if r["pos"] == OBS_K2_POS[-1]])
            k["sim_launches"] = sim["launches"].get(k["name"], 0)
            k["sim"] = dict(
                unit_row(rows), launches=k["sim_launches"],
                max_abs_err=max(r["max_abs_err"] for r in
                                (sim["k1"] if k1 else sim["k2"])),
                unit=(f"one token of a 70B tp {OBS_TP} rank (ref): 80 x "
                      f"(wqkv, wo, w13, w2 bands) + the wcls band at T = 1"
                      if k1 else f"one token of a 70B tp {OBS_TP} rank at "
                      f"pos {OBS_K2_POS[-1]}: 80 layers, 1 kv head and "
                      f"8 query heads"),
                shapes=sim["k1"] if k1 else sim["k2"])
    tp_idle = [f"{name} at tp {w}" for w in TP_SIZES for name in
               ("q40_matvec", "q40_gemm", "decode_attention",
                "prefill_attention") if not tp_launches[w].get(name)]
    tp_idle += [name for name in ("q40_matvec_multi",
                                  "decode_attention_batch",
                                  "paged_attention")
                if not tp_launches[2].get(name)]
    tp_idle += [f"{name} under serve --tp 2" for name in
                ("q40_matvec_multi", "q40_gemm", "prefill_attention",
                 "paged_attention")
                if not serve_tp_launches.get(name)]
    tp_idle += [f"{name} under sp" for name in ("q40_matvec", "q40_gemm")
                if not sp_launches.get(name)]
    if tp_idle:
        raise AssertionError(f"kernels never launched on the tp path: "
                             f"{tp_idle}")
    for k in kernels:
        if k["name"] in SERVE_KERNELS:
            # the serve part: this kernel's events in serve_full_width's
            # POST /profile trace (the server is a process of its own)
            k["serve"] = {"trace_events": SERVE_EVENTS.get(k["name"], 0),
                          "base_name": SERVE_KERNELS[k["name"]]}
    idle = [k["name"] for k in kernels if not k["launches"]] + [
        p["name"] for k in kernels for p in k.get("parts", ())
        if not p["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    reuse_done()
    log("phase seconds: " + ", ".join(
        f"{label} {t - t0:.1f}" for (_, t0), (label, t) in zip(marks,
                                                               marks[1:])))
    log(f"full-width logits max_abs_err {logit_err:.3e}; small-model "
        f"max_abs_err {small_err:.3e}; build {build_s:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels, "e2e": e2e, "step_profile": busy,
                      "e2e_prefill": e2e_prefill, "e2e_q80": e2e_q80,
                      "e2e_bf16": e2e_bf16, "e2e_batch": e2e_batch,
                      "e2e_batch_dequant": e2e_batch_dq,
                      "e2e_fast": e2e_fast, "e2e_fused": e2e_fused,
                      "e2e_continuous": e2e_cont, "e2e_serve": e2e_serve,
                      "e2e_tier": e2e_tier, "e2e_disagg": e2e_disagg,
                      "e2e_chaos": e2e_chaos,
                      "e2e_profile": e2e_profile,
                      "e2e_resume": e2e_resume,
                      "probe": probe, "probe_kernels": probe_rows,
                      "prefill": prefill, "fast": fast, "batch_step": batch,
                      "continuous": continuous, "tp": tp,
                      "serve_tp": serve_tp, "sp": sp, "train": train,
                      "analysis": analysis,
                      "obs": {k: v for k, v in obs.items() if k != "rank"}
                      | {"rank": {k: v for k, v in sim.items()
                                  if k not in ("k1", "k2")}},
                      "tp_waits": TP_WAITS,
                      "batch_cache_saved_gb": saved, "build_s": build_s,
                      "sass": sass}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
