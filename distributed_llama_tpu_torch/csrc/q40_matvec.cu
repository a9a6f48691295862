// Q40 matrix-vector products for Hopper (sm_90a), one skeleton for T = 1
// (K1, q40_matvec) and T = 2..8 tokens (K1m, q40_matvec_multi):
//
//   out[t, r] = sum_b d16[r,b] * sum_{j<32} (code[r,b,j] - 8) * x[t, 32b+j]
//
// in f32. Replaces the JAX package's ops/pallas_q40.py T = 1 matvec
// (q40_matmul -> _q40_matmul_2d / _q40_matmul_stacked with _kernel_matvec ->
// _matvec_body, and the nb-major and int4-plane tilings of the same
// computation) and its 2 <= T <= 8 f32 body (_kernel_multi ->
// _matvec_body_multi, and _q40_multi_nb_*). Like those bodies it takes each
// Q40 block's sum of code products with x first and applies the f16 scale
// once per block and row.
//
// Layout (the codec layout, chosen at load time): qs uint8 (d, nb, 16),
// byte j of a block holds value j in its low nibble and value j+16 in its
// high nibble; d16 f16 (d, nb), at any 2-byte offset; x f32 (T, nb*32);
// out f32 (T, d). A layer of a stacked weight is a pointer offset.
//
// Bound: the packed weight bytes (18 per 32 values) read once from device
// memory, at every T <= 8 (1.108 ms for a 7B token or 8-token step at 3.35
// TB/s). The products run on the tensor cores, exactly (q40_tc.cuh): x is
// split into three bf16 pieces and each code - 8 is an exact bf16, so
// code x piece is exact and only the f32 adds round. The earlier bodies
// spent ~3 f32 SIMT instructions a weight value and T FMAs more (bound by
// operations from T = 6), restaged x in every 8- or 32-row block, and let
// no weight load start before x had arrived. Design:
//   * mma.sync m16n8k16: 16 weight rows are the MMA's M; its N = 8 columns
//     are (token, piece) pairs, column 3t + p for piece p of token t, so
//     T = 1 and 2 need one n8 column set and T = 8 three. Each MMA's k16
//     stays inside one Q40 block: lane (g, c) of a quad feeds word c of the
//     block's 16 code bytes of rows g and g + 8 (low nibbles in k-step 0,
//     high ones in k-step 1), and x is staged in the same order. A fresh
//     accumulator per block (two k-steps) is scaled by the row's d16 into
//     f32 registers, so no tensor-core sum runs longer than 32 products;
//     the pieces' sums meet at the end, p0 + (p1 + p2 / 2^8) / 2^8. The
//     A operand is code - 8 (rather than the raw code and - 8 x the block
//     sum of x): one instruction more per pair of values, but no x sum to
//     stage and no cancellation against 136 * sum(x);
//   * x is staged once per thread block, already split and permuted to the
//     B fragment: for block b, column (t, p) and lane c, the 16 bytes of
//     values 4c..4c+3 and 16+4c..16+4c+3 of piece p, so a lane reads both
//     k-steps of a column set with one 16-byte load, and the 8 lanes of a
//     quarter warp read 128 contiguous bytes;
//   * a thread block of wr x wk warps walks row tiles of 32 wr rows (the
//     tiles blockIdx.x, + gridDim.x, ... of split blockIdx.y), so x is
//     staged once per block for all its tiles. Its threads fill a ring of
//     kStages stages by cp.async together: a stage holds 4 wk blocks of the
//     tile's rows, a warp-instruction reading 64 wk contiguous bytes of a
//     row (the access that streams the layout best), stored at block ^
//     (row % 8) so that ldmatrix.x4 reads each lane's code words of four
//     8-row sets without bank conflicts; then each warp takes 32 rows (two
//     m16 row groups, which share each B load) x 4 blocks of the stage.
//     The ring's first stages are issued before x is staged, so weights
//     are in flight while x arrives; one barrier a stage. The f16 scales
//     may start at any 2-byte offset: each row's stage copies the aligned
//     words holding its scales, and an aligned word that holds a scale
//     lies inside their allocation; rows past d are not copied and their
//     sums not stored. A tile's warps add their sums through shared memory
//     in warp order;
//   * split K (gridDim.y = splits): each split writes its f32 sums of a
//     tile to part[split]; the last block to finish a tile (an atomic
//     ticket after a fence) adds the splits in split order and resets the
//     ticket to 0, so two launches give the same bits, a captured graph
//     replays correctly, and no launch is added. ops/q40.py matvec_plan
//     picks wr, wk, the grid and the split from (T, d, nb, SMs).
// What holds it back on the H100 (PERF.md): at T = 1 the fixed latency of
// each launch and the code unpack's issue cost (as the classic SIMT body
// it replaces, ~57% of the stream in a chain of calls), at T = 8 the
// unpack and the scaling of three column sets.
// Shared memory: kb * 3T * 64 bytes of x (kb blocks a split), the ring
// (smem_bytes) and each warp's 32 x 3T f32 sums. The skeleton is
// q40_matvec.cuh's, shared with K1d (q40_matvec_bf16.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "q40_matvec.cuh"

namespace {

// K1 and K1m: one kernel name each (the profiler's trace tells them apart);
// two blocks an SM up to T = 2 (128 registers a thread), one above
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
q40_matvec_kernel(const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ d16,
                  const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ tickets, int d,
                  int nb, int wr, int wk, int kb) {
  matvec_body<1, 3>(qs, d16, x, out, part, tickets, d, nb, wr, wk, kb);
}

template <int T>
__global__ void __launch_bounds__(kMaxWarps * 32, T <= 2 ? 2 : 1)
q40_matvec_multi_kernel(const uint8_t* __restrict__ qs,
                        const uint8_t* __restrict__ d16,
                        const float* __restrict__ x, float* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets,
                        int d, int nb, int wr, int wk, int kb) {
  matvec_body<T, 3>(qs, d16, x, out, part, tickets, d, nb, wr, wk, kb);
}

template <int T>
int launch(const void* qs, const void* d16, const void* x, void* out,
           void* part, void* tickets, int d, int nb, int wr, int wk,
           int grid_x, int splits, int kb, cudaStream_t stream) {
  auto kernel = q40_matvec_kernel;
  if constexpr (T > 1) kernel = q40_matvec_multi_kernel<T>;
  static size_t granted[kMaxDevices];
  return launch_matvec<T, 3>(kernel, qs, d16, x, out, part, tickets, d, nb,
                             wr, wk, grid_x, splits, kb, stream, granted);
}

}  // namespace

// K1: x (nb*32) f32 -> out (d) f32. The plan (wr row warps x wk split warps
// a block, grid_x blocks per split, `splits` splits of kb blocks) comes from
// ops/q40.py matvec_plan; part is (splits, 1, d) f32 scratch when splits >
// 1, tickets a zeroed int32 array of at least ceil(d / (32 wr)) entries,
// left zeroed. Launch on `stream`; returns the cudaGetLastError() code
// (0 = launched).
extern "C" int q40_matvec(const void* qs, const void* d16, const void* x,
                          void* out, void* part, void* tickets, int d,
                          int nb, int wr, int wk, int grid_x, int splits,
                          int kb, void* stream) {
  return launch<1>(qs, d16, x, out, part, tickets, d, nb, wr, wk, grid_x,
                   splits, kb, static_cast<cudaStream_t>(stream));
}

// K1m: x (t, nb*32) f32 -> out (t, d) f32 for t in 2..8, as K1 (part is
// (splits, t, d)).
extern "C" int q40_matvec_multi(const void* qs, const void* d16,
                                const void* x, void* out, void* part,
                                void* tickets, int t, int d, int nb, int wr,
                                int wk, int grid_x, int splits, int kb,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q40_MULTI_CASE(T)                                                  \
  case T:                                                                  \
    return launch<T>(qs, d16, x, out, part, tickets, d, nb, wr, wk, grid_x, \
                     splits, kb, s);
  switch (t) {
    Q40_MULTI_CASE(2)
    Q40_MULTI_CASE(3)
    Q40_MULTI_CASE(4)
    Q40_MULTI_CASE(5)
    Q40_MULTI_CASE(6)
    Q40_MULTI_CASE(7)
    Q40_MULTI_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef Q40_MULTI_CASE
}
