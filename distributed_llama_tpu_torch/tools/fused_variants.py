"""K8 and K9 (csrc/fused_layer.cu ``q40_head_fused``, ``q40_tail_fused``)
timed three ways in turns on one card: this tree's kernels (per-warp
shared-memory rings), the same functions in K10's frame (one staging of
each vector a block with stage4 / stage4_rmsnorm, rows by q40_row_dot in a
grid stride, each warp's first rows of the next phase asked of L2 before
each barrier; written here and appended to a copy of this tree's
source), and another tree's kernels
(``--other DIR``, e.g. the parent commit unpacked with ``git archive``),
and any edited copies of this tree's fused_layer.cu (``--extra
NAME=PATH``, built with this tree's headers: a variant of the rings).

Each variant is built under ``build/fused_variants/`` with the port's nvcc
flags, bound in place of the package's entry point for its turns, checked
against the plain version (q40.KERNEL_RTOL x max|plain|) and timed with
chip_smoke.py's Timer (CUDA events, median of 25 launches, the L2 flushed
before each) at Llama-2-7B's layer and the GQA case at 70B's widths, K8 at
pos 63: in the order other, ring, frame, the extras, then back again, so a
drift of the card's clock shows as a difference between a variant's two
turns. The
frame stages and sums as the rings do (K10's staging, P0's rows), so its
outputs must equal the ring's bit for bit; the check raises otherwise.
Prints a line per time and a JSON object with every time, their means a
variant, the card's name and power limit.

On a machine with an NVIDIA GPU, from the repository root:

    python3 -m distributed_llama_tpu_torch.tools.fused_variants
        [--other DIR] [--extra NAME=PATH ...] [--json PATH]

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

from ..ops import _build, layer, q40

OUT = _build.BUILD_DIR.parent / "fused_variants"
ROOT = Path(__file__).resolve().parents[2]

# K8 and K9 in K10's frame, appended to this tree's fused_layer.cu (its
# helpers: stage4, stage4_rmsnorm, prefetch_row, grid_barrier,
# coresident_grid, launch_cooperative; widths up to 8192)
FRAME = r'''
namespace {

__global__ void __launch_bounds__(kThreads)
q40_head_frame_kernel(const uint4* __restrict__ qs,
                      const __half* __restrict__ d16,
                      const float* __restrict__ x,
                      const float* __restrict__ w_att,
                      const float* __restrict__ freq,
                      const int* __restrict__ pos, float* __restrict__ out,
                      int d, int nb, int n_rot) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  stage4_rmsnorm<false>(sm, sm + nb * kBlockPad, x, w_att, nb * 32);
  const int at = __ldg(pos);
  for (int p = first; 2 * p < d; p += gridDim.x * kWarps) {
    const size_t r = 2 * static_cast<size_t>(p);
    float v0 = q40_row_dot(qs + r * nb, d16 + r * nb, sm, nb, lane);
    float v1 = q40_row_dot(qs + (r + 1) * nb, d16 + (r + 1) * nb, sm, nb,
                           lane);
    if (lane == 0) {
      if (static_cast<int>(r) < n_rot) rope_pair(v0, v1, at, __ldg(freq + p));
      out[r] = v0;
      out[r + 1] = v1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
q40_tail_frame_kernel(TailArgs a, const float* __restrict__ ao) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  const int dim = a.dim;
  const int hid = a.hid;
  const int nb_d = dim / 32;
  const int nb_h = hid / 32;
  float* red = sm + stage_floats(dim, hid) - kWarps;
  stage4<false>(sm, ao, dim);
  for (int r = first; r < dim; r += stride) {
    const size_t o = static_cast<size_t>(r) * nb_d;
    const float s = q40_row_dot(a.wo_qs + o, a.wo_d + o, sm, nb_d, lane);
    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;
  }
  if (first < hid) {
    prefetch_row(a.w13_qs, a.w13_d, first, nb_d);
    prefetch_row(a.w13_qs, a.w13_d, hid + first, nb_d);
  }
  grid_barrier(a.bar);
  stage4_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, dim);
  for (int r = first; r < hid; r += stride) {
    const size_t o1 = static_cast<size_t>(r) * nb_d;
    const size_t o3 = static_cast<size_t>(hid + r) * nb_d;
    const float g = q40_row_dot(a.w13_qs + o1, a.w13_d + o1, sm, nb_d, lane);
    const float u = q40_row_dot(a.w13_qs + o3, a.w13_d + o3, sm, nb_d, lane);
    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;
  }
  if (first < dim) prefetch_row(a.w2_qs, a.w2_d, first, nb_h);
  grid_barrier(a.bar);
  stage4<true>(sm, a.hb, hid);
  for (int r = first; r < dim; r += stride) {
    const size_t o = static_cast<size_t>(r) * nb_h;
    const float s = q40_row_dot(a.w2_qs + o, a.w2_d + o, sm, nb_h, lane);
    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;
  }
}

}  // namespace

extern "C" int q40_head_frame(const void* qs, const void* d16, const void* x,
                              const void* w_att, const void* freq,
                              const void* pos, void* out, int d, int nb,
                              int n_rot, void* stream) {
  const size_t smem = stage_floats(nb * 32, 0) * sizeof(float);
  static size_t granted[kMaxDevices];
  cudaError_t e = opt_in_smem(q40_head_frame_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  static GridCache grids;
  int grid = 0;
  e = coresident_grid(q40_head_frame_kernel, smem, grids, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  q40_head_frame_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<const float*>(w_att),
      static_cast<const float*>(freq), static_cast<const int*>(pos),
      static_cast<float*>(out), d, nb, n_rot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int q40_tail_frame(const void* wo_qs, const void* wo_d,
                              const void* w13_qs, const void* w13_d,
                              const void* w2_qs, const void* w2_d,
                              const void* ao, const void* x,
                              const void* w_ffn, void* out, void* xnew,
                              void* hb, void* bar, int dim, int hid,
                              void* stream) {
  const TailArgs a{static_cast<const uint4*>(wo_qs),
                   static_cast<const __half*>(wo_d),
                   static_cast<const uint4*>(w13_qs),
                   static_cast<const __half*>(w13_d),
                   static_cast<const uint4*>(w2_qs),
                   static_cast<const __half*>(w2_d),
                   static_cast<const float*>(x),
                   static_cast<const float*>(w_ffn),
                   static_cast<float*>(out),
                   static_cast<float*>(xnew),
                   static_cast<float*>(hb),
                   static_cast<unsigned int*>(bar),
                   dim,
                   hid};
  const size_t smem = stage_floats(dim, hid) * sizeof(float);
  static size_t granted[kMaxDevices];
  cudaError_t e = opt_in_smem(q40_tail_frame_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  static GridCache grids;
  int grid = 0;
  e = coresident_grid(q40_tail_frame_kernel, smem, grids, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_cooperative(q40_tail_frame_kernel, grid, smem,
                         static_cast<cudaStream_t>(stream), a,
                         static_cast<const float*>(ao));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
'''

CASES = [("7b", 4096, 11008, 32, 32), ("gqa8", 8192, 28672, 64, 8)]


def _build_lib(name: str, source: str, include: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(source)
    so = cu.with_suffix(".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(include),
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _fn(lib, symbol: str, argtypes: list):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def variants(other: Path | None, extra: dict[str, Path]) -> dict:
    """{variant: {"head": (lib, fn), "tail": (lib, fn)}}: this tree's
    kernels, the frame, with ``other`` that tree's, and each extra
    source's."""
    heads, tails = layer.HEAD_KERNEL, layer.TAIL_KERNEL
    _build.build([heads, tails])
    out = {"ring": {"head": (heads._lib, heads._fn),
                    "tail": (tails._lib, tails._fn)}}
    src = (_build.CSRC / "fused_layer.cu").read_text()
    lib = _build_lib("frame", src + FRAME, _build.CSRC)
    out["frame"] = {"head": (lib, _fn(lib, "q40_head_frame", heads.argtypes)),
                    "tail": (lib, _fn(lib, "q40_tail_frame", tails.argtypes))}
    if other is not None:
        csrc = other / "distributed_llama_tpu_torch" / "csrc"
        lib = _build_lib("other", (csrc / "fused_layer.cu").read_text(), csrc)
        out["other"] = {
            "head": (lib, _fn(lib, "q40_head_fused", heads.argtypes)),
            "tail": (lib, _fn(lib, "q40_tail_fused", tails.argtypes))}
    for name, path in extra.items():
        lib = _build_lib(name, path.read_text(), _build.CSRC)
        out[name] = {
            "head": (lib, _fn(lib, "q40_head_fused", heads.argtypes)),
            "tail": (lib, _fn(lib, "q40_tail_fused", tails.argtypes))}
    return out


def run(other: Path | None, extra: dict[str, Path]) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    timer = chip_smoke.Timer(torch)
    libs = variants(other, extra)
    names = [n for n in ("other", "ring", "frame", *extra) if n in libs]
    order = names + names[::-1]
    wrappers = {"head": layer.HEAD_KERNEL, "tail": layer.TAIL_KERNEL}
    saved = {k: (w._lib, w._fn) for k, w in wrappers.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    times: dict = {}
    try:
        for label, dim, hid, n_heads, n_kv in CASES:
            lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", g)
            x = torch.randn((1, dim), device="cuda", generator=g)
            ao = torch.randn((1, dim), device="cuda", generator=g)
            p = torch.tensor([63], dtype=torch.int32, device="cuda")
            calls = {
                "head": (lambda: layer.q40_head_fused(
                    x, lw["wqkv"], lw["rms_att"], lw["freq"], p),
                    lambda: layer.q40_head_fused_plain(
                        x, lw["wqkv"], lw["rms_att"], lw["freq"], p)),
                "tail": (lambda: layer.q40_tail_fused(
                    ao, x, lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"]),
                    lambda: layer.q40_tail_fused_plain(
                        ao, x, lw["wo"], lw["w13"], lw["w2"],
                        lw["rms_ffn"]))}
            for kernel, (call, plain) in calls.items():
                want = plain()
                tol = q40.KERNEL_RTOL * want.abs().max().item()
                bits = {}
                for name in order:
                    w = wrappers[kernel]
                    w._lib, w._fn = libs[name][kernel]
                    got = bits.setdefault(name, call())
                    err = (got - want).abs().max().item()
                    if not err <= tol:
                        raise AssertionError(f"{name} {kernel} {label}: "
                                             f"error {err} above {tol}")
                    if name == "frame" and not torch.equal(got,
                                                           bits["ring"]):
                        raise AssertionError(f"frame {kernel} {label}: not "
                                             f"the ring's bits")
                    ms = timer(call)
                    times.setdefault(f"{kernel} {label}", {}).setdefault(
                        name, []).append(ms)
                    print(f"{kernel} {label} {name}: {ms:.4f} ms "
                          f"(max_abs_err {err:.3e})", flush=True)
            del lw, x, ao
    finally:
        for k, w in wrappers.items():
            w._lib, w._fn = saved[k]
    return {key: {name: {"ms": ms, "mean_ms": statistics.fmean(ms)}
                  for name, ms in by.items()} for key, by in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="the root of another checkout whose K8 and K9 to "
                         "time beside this tree's")
    ap.add_argument("--extra", action="append", default=[],
                    help="NAME=PATH: an edited copy of this tree's "
                         "fused_layer.cu to time beside it")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    extra = dict(e.split("=", 1) for e in args.extra)
    res = {"card": smi, "times": run(
        Path(args.other).resolve() if args.other else None,
        {k: Path(v).resolve() for k, v in extra.items()})}
    print(json.dumps(res))
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
