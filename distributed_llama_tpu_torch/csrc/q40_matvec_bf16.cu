// Q40 small-T product with bf16 operands on the tensor cores for Hopper
// (sm_90a), T = 2..8 tokens (K1d):
//
//   out[t, r] = sum_k f32(bf16(x[t, k]) * bf16((code[r, k] - 8) * s[r, k]))
//
// (s[r, k] = d16[r, k / 32] widened to f32): each weight rounded to bf16
// once, after its exact f32 product with the scale, x rounded to bf16,
// exact products, f32 accumulation — the function K3b and
// ops/q40.q40_matmul_bf16_plain compute, at small T.
//
// Replaces the JAX package's ops/pallas_q40.py small-T bf16-product body
// (_q40_matmul_2d / _q40_matmul_stacked with multi_body="dequant":
// _kernel_multi_dequant[_stacked] -> _multi_body_dequant), which
// DLLAMA_MULTI_T_BODY=dequant selects for 2 <= T <= 8 (the batched decode
// step's body).
//
// Layout as K1 and K1m: qs uint8 (d, nb, 16), byte j of a block holding
// value j in its low nibble and value j+16 in its high nibble; d16 f16
// (d, nb) at any 2-byte offset; x f32 (T, nb*32); out f32 (T, d).
//
// Bound: the packed weight bytes (18 per 32 values) read once, as K1's
// (1.108 ms for a 7B 8-token step at 3.35 TB/s; the 2T flops per weight
// value ride the tensor cores). The first design (one 16-byte load per
// lane, block and row straight to registers, two blocks in flight a warp,
// x restaged per 128-block slice, d / 32 blocks of 8 warps and no split K,
// one block an SM at T = 8) left each load's latency exposed and ran at
// 23% of the bound on an H100. This one is K1m's skeleton (q40_matvec.cuh: a
// cp.async ring all threads fill, x staged once a block, split K summed in
// split order by the last block of a tile behind a ticket, plans from
// ops/q40.matvec_plan) with P = 1:
//   * x is one bf16 piece, 64 bytes per Q40 block and token (a third of
//     K1m's), so the N = 8 columns of one n8 set are the T <= 8 tokens;
//   * the A operand is the rounded weight: code - 8 is an exact bf16 pair
//     (codes_bf16), the f16 scale splits exactly into bf16 hi + lo, and
//     two bf16x2 FMAs give bf16_rn((c - 8) s) with one rounding
//     (scaled_bf16) — two instructions a pair of weights where the first
//     design spent about seven (code to f32, the scale, a conversion);
//   * the scale is inside A, so an accumulator may run across Q40 blocks;
//     it runs for one ring stage (4 blocks) and is added into f32
//     registers, as K3 does against the tensor cores' drift over long sums;
//   * built for 128 registers a thread at every T, so two 8-warp blocks
//     share an SM where their shared memory fits.
// Shared memory: kb * T * 64 bytes of x, the ring (smem_bytes) and each
// warp's 32 x T f32 sums.
#include <cuda_runtime.h>
#include <stdint.h>

#include "q40_matvec.cuh"

namespace {

constexpr int kMaxT = 8;

template <int T>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
q40_matvec_bf16_kernel(const uint8_t* __restrict__ qs,
                       const uint8_t* __restrict__ d16,
                       const float* __restrict__ x, float* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ tickets,
                       int d, int nb, int wr, int wk, int kb) {
  matvec_body<T, 1>(qs, d16, x, out, part, tickets, d, nb, wr, wk, kb);
}

template <int T>
int launch(const void* qs, const void* d16, const void* x, void* out,
           void* part, void* tickets, int d, int nb, int wr, int wk,
           int grid_x, int splits, int kb, cudaStream_t stream) {
  static size_t granted[kMaxDevices];
  return launch_matvec<T, 1>(q40_matvec_bf16_kernel<T>, qs, d16, x, out,
                             part, tickets, d, nb, wr, wk, grid_x, splits,
                             kb, stream, granted);
}

}  // namespace

// x (t, nb*32) f32 -> out (t, d) f32 for t in 2..8, under a plan (wr, wk,
// grid_x, splits, kb) from ops/q40.matvec_plan with one piece; part is (splits, t, d) f32 scratch when splits > 1, tickets a
// zeroed int32 array of at least ceil(d / (32 wr)) entries, left zeroed.
// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_matvec_bf16(const void* qs, const void* d16,
                               const void* x, void* out, void* part,
                               void* tickets, int t, int d, int nb, int wr,
                               int wk, int grid_x, int splits, int kb,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q40_BF16_CASE(T)                                                   \
  case T:                                                                  \
    return launch<T>(qs, d16, x, out, part, tickets, d, nb, wr, wk, grid_x, \
                     splits, kb, s);
  switch (t) {
    Q40_BF16_CASE(2)
    Q40_BF16_CASE(3)
    Q40_BF16_CASE(4)
    Q40_BF16_CASE(5)
    Q40_BF16_CASE(6)
    Q40_BF16_CASE(7)
    Q40_BF16_CASE(kMaxT)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef Q40_BF16_CASE
}
