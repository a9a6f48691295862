"""Per-phase times of the fused decode layer's kernels
(csrc/fused_layer.cu): K10 ``q40_mega_kernel`` (the whole layer, the
default), K8 ``q40_head_kernel`` (``--kernel head``) or K9
``q40_tail_kernel`` (``--kernel tail``), from %globaltimer stamps.

The tool writes a stamped copy of a fused_layer.cu under
``build/k10_phases/`` (never the source itself): after each phase of the
kernel, every block's thread 0 records the global timer into two device
arrays, the earliest (atomicMin) and the latest (atomicMax) over the grid.
It builds the copy with the port's nvcc flags, binds its entry point in
place of the package's for the run, and launches it through
``ops/layer`` at Llama-2-7B's layer and the GQA case at 70B's widths
(n_kv 8): K10 over a seq_len 2048 f32 cache at pos 63 and 2047, K8 at pos
63, K9 once; 12 launches each with the L2 flushed before each, the first
2 not kept. It prints, for every stamp, the medians of the first and the
last block's time since the first block started, and the step from the
previous stamp's last: what each phase (staging, rows, barrier,
attention) adds to the layer. The stamps cost a __syncthreads and two
atomics a block each, so the sum runs a little above the kernel's own
time; rank designs by chip_smoke.py's timer, not by the stamps.

On a machine with an NVIDIA GPU, from the repository root:

    python3 -m distributed_llama_tpu_torch.tools.k10_phases
        [--kernel mega|head|tail] [--source PATH --anchors first]

``--anchors current`` (the default) stamps this tree's kernel;
``--anchors first`` stamps the first design's source (the kernel before
its redesign, e.g. an older commit's fused_layer.cu unpacked with ``git
archive``: K10's, K8's and K9's before their redesigns),
whose phases sit at other lines. ``--json PATH`` writes the table.
Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, layer

OUT = _build.BUILD_DIR.parent / "k10_phases"

_STAMPS = r'''
__device__ unsigned long long g_first[32];
__device__ unsigned long long g_last[32];
static __device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { __syncthreads(); if (threadIdx.x == 0) { \
  const unsigned long long _t = gtimer(); atomicMin(&g_first[i], _t); \
  atomicMax(&g_last[i], _t); } } while (0)
extern "C" int stamps_reset() {
  unsigned long long a[32], b[32];
  for (int i = 0; i < 32; ++i) { a[i] = ~0ull; b[i] = 0; }
  cudaMemcpyToSymbol(g_first, a, sizeof(a));
  return cudaMemcpyToSymbol(g_last, b, sizeof(b));
}
extern "C" int stamps_read(void* a, void* b) {
  cudaMemcpyFromSymbol(a, g_first, sizeof(g_first));
  return cudaMemcpyFromSymbol(b, g_last, sizeof(g_last));
}
'''

PHASES = ["start", "qkv staged", "qkv rows", "barrier 1", "attention",
          "barrier 2", "ao staged", "wo rows", "barrier 3", "hn staged",
          "w13 rows", "barrier 4", "hb staged", "w2 rows"]
HEAD_PHASES = ["start", "x staged", "qkv rows"]
TAIL_PHASES = ["start", "ao staged", "wo rows", "barrier 1", "hn staged",
               "w13 rows", "barrier 2", "hb staged", "w2 rows"]

_HEAD = "namespace {\n\n// 16 warps"

# (text, the text with the stamp) per phase end, each text found once
ANCHORS = {
    "current": [
        (_HEAD, _STAMPS + _HEAD),
        ("  float* red = sm + stage_floats(dim, hid) - kWarps;\n\n"
         "  // phase 1",
         "  float* red = sm + stage_floats(dim, hid) - kWarps;\n"
         "  STAMP(0);\n\n  // phase 1"),
        ("  stage4_rmsnorm<false>(sm, red, a.x, m.w_att, dim);\n",
         "  stage4_rmsnorm<false>(sm, red, a.x, m.w_att, dim);\n"
         "  STAMP(1);\n"),
        ("  grid_barrier(a.bar);\n\n  // phase 2",
         "  STAMP(2);\n  grid_barrier(a.bar);\n  STAMP(3);\n\n  // phase 2"),
        ("      __syncthreads();\n    }\n  }\n  if (first < dim) prefetch",
         "      __syncthreads();\n    }\n  }\n  STAMP(4);\n"
         "  if (first < dim) prefetch"),
        ("  grid_barrier(a.bar);\n\n  // phase 3",
         "  grid_barrier(a.bar);\n  STAMP(5);\n\n  // phase 3"),
        ("  stage4<true>(sm, m.ao, dim);\n",
         "  stage4<true>(sm, m.ao, dim);\n  STAMP(6);\n"),
        ("    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;\n  }\n"
         "  if (first < hid) {",
         "    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;\n  }\n"
         "  STAMP(7);\n  if (first < hid) {"),
        ("  grid_barrier(a.bar);\n\n  // phase 4",
         "  grid_barrier(a.bar);\n  STAMP(8);\n\n  // phase 4"),
        ("  stage4_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, dim);\n",
         "  stage4_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, dim);\n"
         "  STAMP(9);\n"),
        ("    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;\n  }\n"
         "  if (first < dim) prefetch_row",
         "    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;\n  }\n"
         "  STAMP(10);\n  if (first < dim) prefetch_row"),
        ("  grid_barrier(a.bar);\n\n  // phase 5",
         "  grid_barrier(a.bar);\n  STAMP(11);\n\n  // phase 5"),
        ("  stage4<true>(sm, a.hb, hid);\n",
         "  stage4<true>(sm, a.hb, hid);\n  STAMP(12);\n"),
        ("    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;\n  }\n}\n\n"
         "template <typename KV, int KV_MUL>\nint launch_mega",
         "    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;\n  }\n"
         "  STAMP(13);\n}\n\ntemplate <typename KV, int KV_MUL>\n"
         "int launch_mega"),
    ],
    "first": [
        (_HEAD, _STAMPS + _HEAD),
        ("  const size_t at = (static_cast<size_t>(m.layer) * m.seq_len + "
         "pos) * kv_dim;\n",
         "  const size_t at = (static_cast<size_t>(m.layer) * m.seq_len + "
         "pos) * kv_dim;\n  STAMP(0);\n"),
        ("                       m.w_att, dim);\n  head_pairs(",
         "                       m.w_att, dim);\n  STAMP(1);\n  head_pairs("),
        ("             });\n  grid_barrier(a.bar);\n\n  // phase 2",
         "             });\n  STAMP(2);\n  grid_barrier(a.bar);\n"
         "  STAMP(3);\n\n  // phase 2"),
        ("    __syncthreads();\n  }\n  grid_barrier(a.bar);\n\n"
         "  // phases 3-5",
         "    __syncthreads();\n  }\n  STAMP(4);\n  grid_barrier(a.bar);\n"
         "  STAMP(5);\n\n  // phases 3-5"),
        ("  stage<kAoCoherent>(sm, ao, a.dim);\n",
         "  stage<kAoCoherent>(sm, ao, a.dim);\n  STAMP(6);\n"),
        ("    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;\n  }\n"
         "  grid_barrier(a.bar);\n",
         "    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;\n  }\n"
         "  STAMP(7);\n  grid_barrier(a.bar);\n  STAMP(8);\n"),
        ("  stage_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, a.dim);\n",
         "  stage_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, a.dim);\n"
         "  STAMP(9);\n"),
        ("    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;\n  }\n"
         "  grid_barrier(a.bar);\n",
         "    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;\n  }\n"
         "  STAMP(10);\n  grid_barrier(a.bar);\n  STAMP(11);\n"),
        ("  stage<true>(sm, a.hb, a.hid);\n",
         "  stage<true>(sm, a.hb, a.hid);\n  STAMP(12);\n"),
        ("    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;\n  }\n}",
         "    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;\n  }\n"
         "  STAMP(13);\n}"),
    ],
    # K8 and K9 of this tree: per-warp rings
    "head": [
        (_HEAD, _STAMPS + _HEAD),
        ("  Ring g = ring_init<CH>(r, sm);\n  stage_rmsnorm_first<false>",
         "  STAMP(0);\n  Ring g = ring_init<CH>(r, sm);\n"
         "  stage_rmsnorm_first<false>"),
        ("                             [&] { ring_fill<CH>(g, r); });\n",
         "                             [&] { ring_fill<CH>(g, r); });\n"
         "  STAMP(1);\n"),
        ("    out[ra + 1] = v1;\n  });\n}\n",
         "    out[ra + 1] = v1;\n  });\n  STAMP(2);\n}\n"),
    ],
    "tail": [
        (_HEAD, _STAMPS + _HEAD),
        ("  Ring g = ring_init<CH>(r, sm);\n"
         "  stage4_first<false>(sm, v.ao, v.dim, "
         "[&] { ring_fill<CH>(g, r); });\n",
         "  STAMP(0);\n  Ring g = ring_init<CH>(r, sm);\n  stage4_first<false>("
         "sm, v.ao, v.dim, [&] { ring_fill<CH>(g, r); });\n  STAMP(1);\n"),
        ("    v.xnew[ra + 1] = __ldg(v.x + ra + 1) + b;\n  });\n"
         "  ring_barrier(v.bar, gen);\n",
         "    v.xnew[ra + 1] = __ldg(v.x + ra + 1) + b;\n  });\n"
         "  STAMP(2);\n  ring_barrier(v.bar, gen);\n  STAMP(3);\n"),
        ("  stage_rmsnorm_first<true>(sm, red, v.xnew, v.w_ffn, v.dim, "
         "[] {});\n",
         "  stage_rmsnorm_first<true>(sm, red, v.xnew, v.w_ffn, v.dim, [] {});"
         "\n  STAMP(4);\n"),
        ("    v.hb[j] = gate / (1.f + expf(-gate)) * up;\n  });\n"
         "  ring_barrier(v.bar, gen);\n",
         "    v.hb[j] = gate / (1.f + expf(-gate)) * up;\n  });\n"
         "  STAMP(5);\n  ring_barrier(v.bar, gen);\n  STAMP(6);\n"),
        ("  stage4_first<true>(sm, v.hb, v.hid, [] {});\n",
         "  stage4_first<true>(sm, v.hb, v.hid, [] {});\n  STAMP(7);\n"),
        ("    v.out[ra + 1] = __ldcg(v.xnew + ra + 1) + b;\n  });\n}\n",
         "    v.out[ra + 1] = __ldcg(v.xnew + ra + 1) + b;\n  });\n"
         "  STAMP(8);\n}\n"),
    ],
    # their first design: a block per 16 row pairs, the
    # tail's scalar staging
    "head-first": [
        (_HEAD, _STAMPS + _HEAD),
        ("  extern __shared__ float sm[];\n  stage_rmsnorm<false>(sm, sm + nb",
         "  extern __shared__ float sm[];\n  STAMP(0);\n"
         "  stage_rmsnorm<false>(sm, sm + nb"),
        ("  head_pairs(qs, d16, sm, freq, __ldg(pos), d, nb, n_rot,\n",
         "  STAMP(1);\n"
         "  head_pairs(qs, d16, sm, freq, __ldg(pos), d, nb, n_rot,\n"),
        ("               out[r + 1] = v1;\n             });\n}\n",
         "               out[r + 1] = v1;\n             });\n  STAMP(2);\n}\n"),
    ],
    "tail-first": [
        (_HEAD, _STAMPS + _HEAD),
        ("  stage<kAoCoherent>(sm, ao, a.dim);\n",
         "  STAMP(0);\n  stage<kAoCoherent>(sm, ao, a.dim);\n  STAMP(1);\n"),
        ("    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;\n  }\n"
         "  grid_barrier(a.bar);\n",
         "    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;\n  }\n"
         "  STAMP(2);\n  grid_barrier(a.bar);\n  STAMP(3);\n"),
        ("  stage_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, a.dim);\n",
         "  stage_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, a.dim);\n"
         "  STAMP(4);\n"),
        ("    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;\n  }\n"
         "  grid_barrier(a.bar);\n",
         "    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;\n  }\n"
         "  STAMP(5);\n  grid_barrier(a.bar);\n  STAMP(6);\n"),
        ("  stage<true>(sm, a.hb, a.hid);\n",
         "  stage<true>(sm, a.hb, a.hid);\n  STAMP(7);\n"),
        ("    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;\n  }\n}\n\n"
         "// Shared-memory floats",
         "    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;\n  }\n"
         "  STAMP(8);\n}\n\n// Shared-memory floats"),
    ],
}
# kernel -> (its phases, its entry point, its anchors by --anchors)
KERNELS = {
    "mega": (PHASES, "q40_layer_mega", {"current": "current",
                                        "first": "first"}),
    "head": (HEAD_PHASES, "q40_head_fused", {"current": "head",
                                             "first": "head-first"}),
    "tail": (TAIL_PHASES, "q40_tail_fused", {"current": "tail",
                                             "first": "tail-first"}),
}

CASES = [("7b", 4096, 11008, 32, 32), ("gqa8", 8192, 28672, 64, 8)]
POSITIONS = (63, 2047)
REPS, SKIP = 12, 2


def stamped(source: str, anchors: str) -> str:
    """``source`` with a stamp after each phase; raises if an anchor is
    not found exactly once (the kernel moved: update ANCHORS)."""
    for old, new in ANCHORS[anchors]:
        if source.count(old) != 1:
            raise ValueError(f"anchor found {source.count(old)} times: "
                             f"{old[:60]!r}")
        source = source.replace(old, new)
    return source


def _bind(source: Path, anchors: str, symbol: str, argtypes: list):
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"fused_layer_{anchors}.cu"
    cu.write_text(stamped(source.read_text(), anchors))
    so = cu.with_suffix(".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(source.parent), "-I", str(_build.CSRC), "-o",
                    str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, fn


def _table(lib, launch, phases: list[str]) -> dict:
    """Medians over REPS - SKIP stamped launches (L2 flushed before each)
    of each stamp's first and last block, us since the first block
    started."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    runs = []
    for rep in range(REPS):
        flush.zero_()
        torch.cuda.synchronize()
        lib.stamps_reset()
        launch()
        torch.cuda.synchronize()
        a = (ctypes.c_ulonglong * 32)()
        b = (ctypes.c_ulonglong * 32)()
        lib.stamps_read(a, b)
        if rep >= SKIP:
            runs.append((list(a), list(b)))
    return {name: (statistics.median(r[0][i] - r[0][0] for r in runs) / 1e3,
                   statistics.median(r[1][i] - r[0][0] for r in runs) / 1e3)
            for i, name in enumerate(phases)}


def run(source: Path, anchors: str, kernel: str = "mega") -> dict:
    phases, symbol, keys = KERNELS[kernel]
    key = keys[anchors]
    wrapper = {"mega": layer.MEGA_KERNEL, "head": layer.HEAD_KERNEL,
               "tail": layer.TAIL_KERNEL}[kernel]
    first_mega = key == "first"
    # K10's first design took no split scratch: bind its own argument list
    lib, fn = _bind(source, key, symbol,
                    [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                    if first_mega else wrapper.argtypes)
    if first_mega:  # drop the two split-scratch pointers
        def call(*a):
            return fn(*a[:21], *a[23:])
    else:
        call = fn
    saved = wrapper._lib, wrapper._fn
    wrapper._lib, wrapper._fn = lib, call
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    try:
        for label, dim, hid, n_heads, n_kv in CASES:
            lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", g)
            hs = dim // n_heads
            x = torch.randn((1, dim), device="cuda", generator=g)
            if kernel == "tail":
                ao = torch.randn((1, dim), device="cuda", generator=g)
                res[label] = _table(lib, lambda: layer.q40_tail_fused(
                    ao, x, lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"]),
                    phases)
                continue
            k = torch.randn((2, 2048, n_kv, hs), device="cuda", generator=g)
            v = torch.randn((2, 2048, n_kv, hs), device="cuda", generator=g)
            args = (lw["wqkv"], lw["wo"], lw["w13"], lw["w2"],
                    lw["rms_att"], lw["rms_ffn"], lw["freq"])
            for pos in (POSITIONS if kernel == "mega" else (63,)):
                p = torch.tensor([pos], dtype=torch.int32, device="cuda")
                if kernel == "head":
                    def launch():
                        layer.q40_head_fused(x, lw["wqkv"], lw["rms_att"],
                                             lw["freq"], p)
                else:
                    def launch():
                        layer.q40_layer_mega(x, *args, k, v, 1, p,
                                             n_heads // n_kv)
                res[f"{label} pos {pos}"] = _table(lib, launch, phases)
            del lw, x, k, v
    finally:
        wrapper._lib, wrapper._fn = saved
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(_build.CSRC / "fused_layer.cu"))
    ap.add_argument("--kernel", default="mega", choices=sorted(KERNELS))
    ap.add_argument("--anchors", default="current",
                    choices=("current", "first"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k10_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    res = run(Path(args.source), args.anchors, args.kernel)
    print(f"{args.kernel} phases ({args.anchors}, {name}, {limit}): us "
          f"since the first block started, median of {REPS - SKIP}")
    for key, table in res.items():
        print(f"{key}:")
        prev = 0.0
        for phase, (first, last) in table.items():
            print(f"   {phase:12s} first {first:8.2f} last {last:8.2f} "
                  f"(+{last - prev:7.2f})")
            prev = last
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"device": name, "power_limit": limit, "kernel": args.kernel,
             "anchors": args.anchors, "phases": res}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
