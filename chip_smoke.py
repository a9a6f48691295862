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
   async copy, K8 and K9 their rings' per-thread async copy (LDGSTS);
   ``cuobjdump -res-usage``: no K1, K1m, K3, K4 or K9 function spills
   (stack or local memory), registers logged.
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
   paged decode attention over f32 and bf16 pages (K6) and Q8
   pages (K7) at the same shapes with pages of 16 in a permuted pool, t_len
   1, 4 and 8 (at t_len 1 K6 gives the bits of K5 under the same plan
   over the same values, and K7 gives K6's bits over the dequantized
   pool; graph replays across split counts); the fused decode layer's
   head (K8), tail (K9) and whole layer (K10, over an f32 and a bf16 cache,
   part by part) at the 7B and GQA shapes at pos 0, 63 and 2047, timed
   beside the unfused port path for the same work, K8's and K9's rows with
   P0's bits (K8's on the vector it staged, read back through one-hot
   rows), K8's q, k and v with K10's bits, both the same bits twice; the Q40 layout probe's
   kernels (B10: P1 probe_stream, P2 probe_xglobal, P3 probe_nomask, P4
   probe_signed, and P0 probe_classic, the classic T = 1 row body that
   the fused tail gives the bits of) and K1 at the 13B w13 and wqkv
   shapes, then the probe's own traced chain at w13 (tools/nb_probe.py,
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
   runs ``inference`` in-process seventeen times (runs e and f call the
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
      equals run a's.
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
   name and power limit. At tp 2 the lockstep batch (4 rows, K1m and K5)
   and the continuous engine over f32 pages (K6, admission prefill
   through K3 and K4) run eagerly at 2 layers of 7B width and equal one
   device's. What waits for a machine with more than one card is logged
   (TP_WAITS); where two GPUs are visible, ``inference --tp 2`` runs over
   NCCL, token by token under fused and overlap (with four GPUs also tp 4
   under fused, overlap and ref with q80 buffers), and the lockstep batch
   at tp 2 against tp 1 (tp_nccl).
6. The phase times, the ``kernels`` JSON line (each kernel's launches
   summed over every CLI run, a-r; the probe's kernels over its chain),
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
]
# K1, K1m, K3, K4 and K9 (K8's stack is RoPE's precise sinf / cosf, whose
# slow path keeps its reduction in local memory)
SPILL_FREE = ("q40_matvec", "q40_matvec_multi", "q40_gemm",
              "prefill_attention", "q40_tail_fused")


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
    async copy of their rings (LDGSTS). ``cuobjdump -res-usage`` gives
    each function's registers (at launch) and its stack and local memory:
    K1's, K1m's, K3's, K4's and K9's functions must spill nothing. Returns
    {kernel: {instruction: count, "max_regs": n, "spill_bytes": n}}."""
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
        found[symbol] = counts
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


def phase_k2(torch, timer, peaks, cache=None):
    """K2 against plain over an f32 cache, or over a bf16 one (``cache`` =
    torch.bfloat16, the kvbf16 build), at positions up to 2047 where its
    plan splits the keys, with the same bits from a second launch; an
    empty kernel's time beside the rows. The library yardstick is SDPA in
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
K6_T_LENS = (1, 4, 8)
K6_PAGES = ("f32", "bf16", "q8")


# K6's and K7's plans held to K5's and K6's bits: the default (decode_plan
# over B * t_len rows), one split, and the most splits at K5's least keys
K6_PLANS = (None, (1, 1), (32, 64))


def _k6_replays(torch, run_k, planes, table, P, layer, n_q, hs, kv_mul,
                batch, symbol, label):
    """K6 or K7 at t_len 1 captured in a CUDA graph over device positions
    and replayed at K5_REPLAYS' clocks, which cross its plan's split
    counts: every replay gives an eager launch's bits, and every split
    ticket is back at 0 after it."""
    from distributed_llama_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((batch, 1, n_q * hs), device="cuda", generator=g)
    pv = torch.tensor(K5_REPLAYS[0][:batch], dtype=torch.int32,
                      device="cuda")
    run_k(q, *planes, layer, pv, table, P, kv_mul)  # eager first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run_k(q, *planes, layer, pv, table, P, kv_mul)
    plan = att.decode_plan(planes[0].shape[2], batch,
                           torch.cuda.get_device_properties(
                               0).multi_processor_count)
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
        splits |= {att.decode_splits(p + 1, plan)[0] for p in pos[:batch]}
    del graph
    log(f"{symbol} {label}: {len(K5_REPLAYS)} graph replays give the eager "
        f"bits, tickets back at 0; split counts {sorted(splits)} under "
        f"plan {plan}")


def phase_k6(torch, timer, peaks):
    """K6 (f32 and bf16 pages) and K7 (Q8 pages) against their plain
    versions at 7B and GQA shapes, page size PAGE, B = 1 and 8, shared
    clocks 63 and 2047 and ragged ones, t_len 1, 4 and 8 (up to the
    budget-edge clamp), the same bits on a second launch. The pool holds a
    contiguous (2B, 2048, n_kv, hs) batch cache's values in permuted
    physical pages; at t_len 1 K6 must give the bits of K5 under the same
    plan (each of K6_PLANS) over the same values, with the identity table
    and with the permuted one, and K7 must give K6's bits over the
    dequantized pool (at the default plan and at (32, 64)); then K6's and
    K7's graph replays (_k6_replays). Times: the kernel, K5 at t_len 1 on
    the contiguous cache (f32 for Q8 pages), the plain version (t_len 1),
    and the library yardstick, SDPA over the row's live pages gathered
    beforehand (the gather, with the Q8 dequantize, timed apart)."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import attention as att
    from distributed_llama_tpu_torch.ops import paged_attention as pa
    from distributed_llama_tpu_torch.ops.quants import (QK,
                                                        dequantize_q80_planes,
                                                        quantize_q80_torch)

    g = torch.Generator(device="cuda").manual_seed(11)
    S, hs, layer, ps = K2_SEQ, K2_HS, 1, PAGE
    mp = S // ps
    kernels = {"f32": pa.PAGED_KERNEL, "bf16": pa.PAGED_KERNEL_KVBF16,
               "q8": pa.PAGED_KERNEL_Q8}
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
                kernel = kernels[pages]
                for pos_label, pos in _k5_positions(batch):
                    pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    for t_len in K6_T_LENS:
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
                        k5_ms = plain_ms = None
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
                                        f"K7 {label} B={batch} {pos_label} "
                                        f"t={t_len} plan {plan}: not K6's "
                                        f"bits over the dequantized pool")
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
                            plain_ms = timer(lambda: plain_k(
                                q, *planes, layer, pv, table, P, kv_mul))
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
                        ms = timer(run)
                        gather_ms = timer(gather)
                        library_ms = timer(lib)
                        keys = [sum(min(p + i, S - 1) + 1
                                    for i in range(t_len)) for p in pos]
                        nbytes = (2 * sum(x + 1 for x in last) * n_kv * hs
                                  * bpv + 2 * batch * t_len * n_q * hs * 4)
                        b_ms, b_by = bound(nbytes,
                                           4.0 * sum(keys) * n_q * hs, peaks)
                        log(f"{kernel.symbol} {label} B={batch} {pos_label}"
                            f" t={t_len}: max_abs_err {err:.3e} (tol "
                            f"{att.KERNEL_ATOL:.0e}) kernel {ms:.4f} ms "
                            f"bound {b_ms:.5f} ms ({b_by}) K5 "
                            f"{_f(k5_ms)} plain {_f(plain_ms)} sdpa "
                            f"{library_ms:.4f} ms (err {lib_err:.1e}) + "
                            f"gather {gather_ms:.4f} ms")
                        rows.append(dict(
                            case=label, n_kv=n_kv, kv_mul=kv_mul,
                            batch=batch, pos=pos_label, t_len=t_len,
                            max_abs_err=err, ms=ms, k5_ms=k5_ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms, gather_ms=gather_ms,
                            pages=pages))
                _k6_replays(torch, run_k, planes, table, P, layer, n_q, hs,
                            kv_mul, batch, kernel.symbol,
                            f"{label} B={batch}")
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
    prepared beforehand, as their wrappers prepare it once per call. Then
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
        xpad, xprep = nbp.pad_x(x), nbp.prep_nomask(x)
        wf = dequantize_q40_torch(w.qs, w.d16)
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
            ("v0r", "probe_xglobal",
             lambda: nbp._launch(nbp.XGLOBAL, w, [xpad], d, nb),
             lambda: nbp.probe_xglobal_plain(w, x), nbp.KERNEL_RTOL,
             nb * nbp.BLOCK_PAD * 4, library_ms),
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
                + f" bound {b_ms:.4f} ms ({b_by})")
            if not err <= tol:
                raise AssertionError(f"B10 {variant} {shape}: error {err} "
                                     f"above {tol}")
            rows.append(dict(variant=variant, kernel=kname, shape=shape,
                             d=d, n=n, max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, share=b_ms / ms))
        del w, ws, x, xpad, xprep, wf
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
    for r in results:
        log(f"probe: {nbp.describe(r)}")
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


def phase_e2e_continuous(torch, model, tok, n_layers, label, flags):
    """Runs k-n: the 12 shared-prefix prompts through ``--prompts-file
    --continuous --slots 8 --prefill-chunk 32 --steps 128`` and ``flags``.
    Exact launch counts from the engine's own step and chunk counts: the
    attention build the flags select (K5 contiguous, K6 f32 or bf16 pages,
    K7 Q8 pages) L per device step, K1m 4L+1 per step (8 rows), K3 4L and
    K4 (its bf16-cache build over bf16 pages) L per admission chunk with
    their parts by the plans of each chunk's (T, start), every other
    kernel 0. Every request completes without error, the page audit
    is clean, and the steps are the graphs' warm-ups and replays."""
    paged = "--kv-page-size" in flags
    q8 = "q8" in flags
    bf16 = "bf16" in flags
    attn = ("decode_attention_batch" if not paged else "paged_attention_q8"
            if q8 else "paged_attention_kvbf16" if bf16
            else "paged_attention")
    prefill = "prefill_attention" + ("_kvbf16" if bf16 else "")
    path = SMOKE_DIR / "continuous.txt"
    path.write_text("\n".join(CONT_PROMPTS) + "\n")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seen, windows = [], []
    with _engine_spy(seen), _window_spy(windows):
        out, counts, wall, _ = _run_cli(torch, model, tok, [
            "--prompts-file", str(path), "--continuous", "--slots",
            str(CONT_SLOTS), "--prefill-chunk", str(CONT_CHUNK), "--steps",
            str(CONT_STEPS), "--temperature", "0", "--seed", "1", *flags])
    eng = seen[0][0]
    reqs = [r for _, r in seen]
    st = eng.stats
    want = {"q40_matvec_multi": (4 * n_layers + 1) * st.steps,
            attn: n_layers * st.steps}
    if st.prefill_chunks:
        if len(windows) != st.prefill_chunks or any(
                t != CONT_CHUNK for t, _ in windows):
            raise AssertionError(f"{label} run: admission windows {windows}"
                                 f" for {st.prefill_chunks} chunks")
        want.update(q40_gemm=4 * n_layers * st.prefill_chunks,
                    **{prefill: n_layers * st.prefill_chunks},
                    **_prefill_parts(eng.spec, CONT_CHUNK,
                                     [p for _, p in windows], False, bf16))
    _expect(f"{label} run", counts, want)
    rows = _cont_rows(out)
    m = re.search(r"Generated tokens:\s+(\d+) across (\d+) requests "
                  r"\((\d+) slots, (\d+) steps\)", out)
    errors = [r.error for r in reqs if r.error or not r.done.is_set()]
    audit = eng.audit_pages()
    n_graphs = len(eng._chains) if eng.block_steps > 1 else 1
    if (len(rows) != len(CONT_PROMPTS) or int(m.group(2)) != len(reqs)
            or int(m.group(4)) != st.steps or errors or audit
            or eng.graph_replays + n_graphs != st.steps):
        raise AssertionError(
            f"{label} run: {len(rows)} rows, {m.groups()}, errors {errors}, "
            f"audit {audit}, {eng.graph_replays} replays of {n_graphs} "
            f"graphs for {st.steps} steps")
    res = dict(flags=list(flags), requests=len(reqs), steps=st.steps,
               tokens=st.tokens, prefill_chunks=st.prefill_chunks,
               pauses=st.pauses, requeues=st.requeues,
               avg_active=st.avg_active, replays=eng.graph_replays,
               graphs=n_graphs, wall_s=wall, launches=counts,
               tokens_per_s=st.tokens_per_s,
               sampled_tokens=sum(r.n_sampled for r in reqs),
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               cache_bytes=sum(t.nbytes for t in eng.cache))
    a = eng.allocator
    if a is not None:
        res.update(n_pages=a.n_pages, page_bytes=res["cache_bytes"]
                   / (a.n_pages + 1), prefix_hits=a.prefix_hits,
                   hit_rate=a.hit_rate, tokens_saved=a.tokens_saved,
                   evictions=a.evictions)
    log(f"e2e {label}: {json.dumps(res)}")
    res["rows"] = [text for _, text in rows]
    del eng, seen, reqs
    return res


def phase_e2e_continuous_runs(torch, model, tok, n_layers):
    """Runs k-n. k: f32 pages of PAGE (K6), prefix hits > 0; l: run k
    without the page flags (contiguous, K5), its 12 streams equal to run
    k's; m: bf16 pages with 16-step chains (the bf16-page K6); n: Q8 pages
    (K7) with 16-step chains, seeded sampling and a 32-page pool that
    pauses or requeues rows, with ~3.76x fewer bytes per page than run
    k's."""
    page = ("--kv-page-size", str(PAGE))
    res = {
        "k": phase_e2e_continuous(torch, model, tok, n_layers, "k paged",
                                  page),
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
    }
    k, n = res["k"], res["n"]
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
    for r in res.values():
        r.pop("rows")
    return res


# --------------------------------------------------------------------------
# phase 4: kernels against plain at full width, end to end
# --------------------------------------------------------------------------

def phase_full_width(torch, model, tok, peaks, ref):
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
    return worst, busy, prefill, fast, batch, continuous


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


def continuous_full_width(torch, engine, tokenizer, batch):
    """Continuous throughput at full width: 16 requests (the shared-prefix
    prompts, cycled) through 8 slots, CONT_STEPS positions each, admission
    prefill at CONT_CHUNK, fused chains of 16 captured steps, greedy, for
    the contiguous cache and f32, bf16 and Q8 pages (one engine each over
    the same device weights). After a warm-up run of each (the captures),
    runs in turns (contiguous, f32, bf16, q8, q8, bf16, f32, contiguous;
    medians); then one run of each under torch.profiler for the device
    time, read against its unprofiled wall: the busy share. The lockstep
    batch of the same call stands beside it."""
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

    streams = {label: run(label)[0] for label in engines}  # captures
    if streams["f32 pages"] != streams["contiguous"]:
        raise AssertionError("continuous full width: the f32-page streams "
                             "differ from the contiguous engine's")
    runs = {label: [] for label in engines}
    order = list(engines)
    for label in order + order[::-1]:
        runs[label].append(run(label)[1])
    res = {}
    for label, eng in engines.items():
        mid = sorted(runs[label], key=lambda r: r["ms"])[0]
        ms = statistics.median(r["ms"] for r in runs[label])
        dev, prof_ms = _profiled(torch, lambda: run(label), mid["steps"],
                                 host=False)
        dev_ms = sum(m for _, m, _ in dev)
        paged = sum(m for k, m, _ in dev if "paged_attention" in k
                    or "decode_attention" in k)
        row = dict(ms=ms, runs_ms=[r["ms"] for r in runs[label]],
                   steps=mid["steps"], ms_per_step=ms / mid["steps"],
                   tokens=mid["tokens"], decode_tokens=mid["decode_tokens"],
                   tokens_per_s=mid["tokens"] / ms * 1e3,
                   decode_tokens_per_s=mid["decode_tokens"] / ms * 1e3,
                   avg_active=mid["avg_active"],
                   device_ms_per_step=dev_ms,
                   attention_ms_per_step=paged,
                   busy=dev_ms * mid["steps"] / ms if dev_ms else None,
                   cache_bytes=sum(t.nbytes for t in eng.cache),
                   replays=eng.graph_replays)
        log(f"continuous {label}: 16 requests through {CONT_SLOTS} slots in "
            f"{ms:.1f} ms (runs {', '.join(f'{r:.1f}' for r in row['runs_ms'])}"
            f"), {row['steps']} device steps, {row['ms_per_step']:.3f} "
            f"ms/step, {row['decode_tokens_per_s']:.0f} decode tokens/s "
            f"({row['tokens_per_s']:.0f} with the prompt echoes), "
            f"avg_active {row['avg_active']:.2f}; device "
            f"{dev_ms:.3f} ms/step (attention {paged:.3f}), busy "
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
TP_STEPS = 36    # run a's prompt: 19 prefilled positions, 17 decode steps
TP_RUNS = {  # label -> (tp, scheme, extra flags); all 32 layers at 7B
    "t2 fused": (2, "fused", ["--prefill-chunk", str(TP_PREFILL)]),
    "t2 ref": (2, "ref", ["--prefill-chunk", str(TP_PREFILL)]),
    "t2 q80": (2, "fused", ["--buffer-float-type", "q80", "--prefill-chunk",
                            str(Q80_CHUNK)]),
    "t4 fused": (4, "fused", ["--prefill-chunk", str(TP_PREFILL)]),
}
TP_DEPTH = 2   # layers of the 7B-wide model of the tp batch/continuous steps
TP_ROWS = 4    # its lockstep rows, and the continuous engine's slots
TP_REQS = 6    # the continuous engine's requests (CONT_PROMPTS[:6])
# what the single card cannot run: gloo refuses send/recv of CUDA tensors
# (the overlap scheme's ring hops), and a CUDA graph cannot capture gloo's
# host-side collectives (over NCCL one hung: not yet ported)
TP_WAITS = ("--tp-scheme overlap (its ring hops are send/recv pairs, which "
            "gloo refuses for CUDA tensors)",
            "NCCL, one GPU a rank",
            "--fast and the captured batch and continuous steps under tp "
            "(a CUDA graph cannot capture gloo, and a capture over NCCL "
            "hung in a 4-card run: not yet ported)")


def _tp_depth_model(spec, model):
    """The smoke model's first TP_DEPTH layers as a .bin of their own: its
    header with the depth, its embedding and layers 0..TP_DEPTH-1, then
    its tail (final norm, the legacy RoPE gap, wcls), copied byte for
    byte."""
    import dataclasses

    from distributed_llama_tpu_torch.models.spec import HEADER_BYTES

    cut = dataclasses.replace(spec, n_layers=TP_DEPTH)
    path = SMOKE_DIR / f"{Path(model).stem}_L{TP_DEPTH}.bin"
    head = spec.vocab_size * spec.dim * 4 + TP_DEPTH * spec.block_bytes()
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


def _tp_rank(rank, world, port, out, model, tok, depth_model):
    """One rank of a gloo group whose ranks share cuda:0 (NCCL refuses two
    ranks on one device), with a subgroup of the first tp ranks for each
    smaller tp of TP_SIZES: each of TP_RUNS at its tp, on the ranks that
    hold it, through the CLI's inference entry with that group
    (``cmd_inference(argv, group=...)``), every kernel's count set to 0
    just before and read just after, the generated tokens recorded; after
    the tp 2 runs, _tp_steps over that group. Rank 0 pickles what it saw
    to ``out``."""
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
            streams.clear()
            for k in _all_kernels():
                k.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.cmd_inference([
                    "--model", model, "--tokenizer", tok, "--prompt",
                    PROMPT, "--steps", str(TP_STEPS), "--temperature", "0",
                    "--seed", "1", "--tp", str(tp), "--tp-scheme",
                    scheme, *extra], group=group)
            torch.cuda.synchronize()
            res[label] = dict(
                rc=rc, out=buf.getvalue(), wall_s=time.perf_counter() - t0,
                stream=streams[0] if streams else None,
                launches={k.symbol: k.launches for k in _all_kernels()
                          if k.launches})
            if tp == 2 and label == "t2 q80":  # the last tp 2 run
                generate.generate = loop
                res["steps"] = _tp_steps(torch, group, depth_model, tok)
                generate.generate = recorded
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


def tp_full_width(torch, spec, model, tok, ref_a, ref_c, smi):
    """Llama-2-7B Q40 at full width (the smoke file, all 32 layers) through
    the CLI's inference entry at tp 2 and 4, the ranks sharing the card
    over a gloo group this phase builds (one spawn a size): TP_RUNS, each
    stream held against the one-device run's (run a, or run c for q80
    buffers), then at tp 2 the lockstep and continuous steps at TP_DEPTH
    layers against the same on one device. Returns the runs and each
    kernel's launches at each tp (rank 0)."""
    import pickle

    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.parallel.mesh import free_port

    depth = _tp_depth_model(spec, model)
    with torch.inference_mode():
        one = _tp_steps(torch, None, depth, tok)
    world = max(TP_SIZES)
    out = SMOKE_DIR / "tp.pkl"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(_tp_rank, args=(
        world, free_port(), str(out), str(model), str(tok), str(depth)),
        nprocs=world, start_method="spawn")
    with open(out, "rb") as fh:
        got = pickle.load(fh)
    log(f"tp: {world} ranks over {got['backend']} sharing cuda:0 (a group "
        f"this script built, the first 2 ranks a subgroup for tp 2), "
        f"{time.perf_counter() - t0:.1f} s with the spawn")
    res, launches = {}, {}
    for world in TP_SIZES:
        runs = [label for label, (tp, _, _) in TP_RUNS.items()
                if tp == world]
        counts = collections.Counter()
        for label in runs:
            want, gaps = ref_c if "q80" in label else ref_a
            res[label] = _tp_check(label, got[label], world, spec.n_layers,
                                   want, gaps, smi)
            counts.update(got[label]["launches"])
        if world == 2:
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
        launches[world] = dict(counts)
    if torch.cuda.device_count() < 2:
        log(f"tp over NCCL: not run ({torch.cuda.device_count()} GPU "
            f"visible); waiting for a machine with more than one card: "
            f"{'; '.join(TP_WAITS)}")
    else:
        res["nccl"] = tp_nccl(torch, model, tok, ref_a, ref_c)
    return res, launches


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
    marks = [("start", t_start)]

    def mark(label):
        marks.append((label, time.perf_counter()))

    writer = start_smoke_writer()
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
    e2e_cont = phase_e2e_continuous_runs(torch, model, tok, spec.n_layers)
    mark("CLI runs k-n")
    gc.collect()
    torch.cuda.empty_cache()
    tp, tp_launches = tp_full_width(torch, spec, model, tok, ref_a, ref_c,
                                    smi)
    mark("tp_full_width")
    gc.collect()
    torch.cuda.empty_cache()
    logit_err, busy, prefill, fast, batch, continuous = phase_full_width(
        torch, model, tok, peaks, ref_a)
    mark("full width")
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
        rows = [r for r in k6 if r["pages"] == pages]
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

    kernels += [
        paged_row("paged_attention", "f32", "f32"),
        paged_row("paged_attention_kvbf16", "bf16", "bf16"),
        paged_row("paged_attention_q8", "q8", "Q8"),
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
    tp_idle = [f"{name} at tp {w}" for w in TP_SIZES for name in
               ("q40_matvec", "q40_gemm", "decode_attention",
                "prefill_attention") if not tp_launches[w].get(name)]
    tp_idle += [name for name in ("q40_matvec_multi",
                                  "decode_attention_batch",
                                  "paged_attention")
                if not tp_launches[2].get(name)]
    if tp_idle:
        raise AssertionError(f"kernels never launched on the tp path: "
                             f"{tp_idle}")
    idle = [k["name"] for k in kernels if not k["launches"]] + [
        p["name"] for k in kernels for p in k.get("parts", ())
        if not p["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
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
                      "e2e_continuous": e2e_cont,
                      "e2e_profile": e2e_profile,
                      "e2e_resume": e2e_resume,
                      "probe": probe, "probe_kernels": probe_rows,
                      "prefill": prefill, "fast": fast, "batch_step": batch,
                      "continuous": continuous, "tp": tp,
                      "tp_waits": TP_WAITS,
                      "batch_cache_saved_gb": saved, "build_s": build_s,
                      "sass": sass}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
