// Q40 dequant-fused f32 matrix product for Hopper (sm_90a), T > 8 (K3):
//
//   out[t, r] = sum_k x[t, k] * (code[r, k] - 8) * d16[r, k / 32]   (f32)
//
// i.e. out (T, d) = x (T, n) . dequant(W)(d, n)^T to f32 accuracy, on the
// tensor cores by the 3xTF32 split. The JAX package's f32 body runs its
// dots at Precision.HIGHEST, several low-precision passes on the matrix
// unit that add up to f32 accuracy; the Hopper counterpart is 3xTF32:
//   x = x_hi + x_lo, x_hi = tf32(x), x_lo = tf32(x - x_hi) (nearest, ties
//   away); w = w_hi + w_lo likewise, and
//   out = W_hi . x_hi + W_hi . x_lo + W_lo . x_hi   (f32 accumulation),
// dropping only W_lo . x_lo. A Q40 weight value (code - 8) * d16 has at
// most 14 significant bits (4 of the code, 11 of the f16 scale), so
// w_hi + w_lo is the weight exactly: only x carries rounding, ~2^-22
// relative. The tensor cores' own f32 accumulation drops low bits at
// each add, an error that grows with the length of the chain: each
// stage's product therefore starts a fresh wgmma accumulator and is added
// into a register sum with rounded f32 adds (see the consumers below), so
// the error stays well inside KERNEL_RTOL (1e-4 x max|out|) at any depth.
//
// Replaces the T > 8 branch of the JAX package's ops/pallas_q40.py
// (_q40_matmul_2d / _q40_matmul_stacked with _kernel -> _matmul_body in
// parity mode), and its scratch, nb-major and legacy tilings
// (_q40_matmul_*_scratch, _q40_mxu_nb_*), which compute the same function.
//
// Layout: qs uint8 (d, nb, 16) (byte j of a block holds value j in its low
// nibble and value j+16 in its high nibble); d16 f16 (d, nb), at any 2-byte
// offset; out f32 (T, d). A layer of a stacked weight is a pointer offset.
// x arrives split: the wrapper runs q40_split_tf32 (below) once per call
// into x_hi and x_lo, two f32 (T, n) buffers in which each 32-value block
// is permuted so that a thread's A fragment comes from one 32-bit word of
// codes (see dequant_step).
//
// Bound: 3 passes of 2*T*d*n flops at 494.7 TFLOP/s dense TF32 against
// 0.5625 bytes per weight value and 4 per x and out value at 3.35 TB/s:
// operations from T of about 64 on at 7B's widths, bytes below. The first
// design, a tiled SIMT GEMM on the f32 cores, could at best reach their 67
// TFLOP/s (24.7 ms per 7B chunk against 10.0 for the three passes). The
// design is K3b's (q40_gemm_bf16.cu):
//   * operands swapped: a block computes a (64 WG weight rows x N tokens)
//     tile of out^T = W . x^T with wgmma m64nNk8 tf32 (N = 16, 32, 64 or
//     128, the token tile; T > 128 takes more token tiles), one warpgroup
//     per 64 rows. A comes from registers: each thread dequantizes its
//     fragment of a Q40 block straight into two sets, w_hi = tf32(w) and
//     w_lo = w - w_hi (exact). B is the x tile, K-major in shared memory
//     with the 128-byte swizzle of 32-float rows, as TMA writes it;
//   * a ring of stages of one Q40 block (32 values: the code tile, 16
//     bytes a row, and two N x 128-byte x tiles, hi and lo) with full and
//     empty mbarriers, ~200 KB deep: one producer warp issues TMA for the
//     three tiles (the other warps of its warpgroup leave at once), and
//     for the f16 scales, which may start at any 2-byte
//     offset, a 4-byte cp.async of the aligned word holding each row's
//     scale (completing on the same mbarrier). An aligned word that holds
//     a scale lies inside the scales' allocation;
//   * each consumer warpgroup dequantizes a stage's four k8 steps into its
//     A registers (32 a thread: hi and lo) and issues the stage's 12
//     wgmmas (W_hi.x_hi, W_hi.x_lo, W_lo.x_hi per step) as one group,
//     the first overwriting the accumulator; once the group completes,
//     the accumulator is added into the thread's f32 sum. The sum takes
//     N/2 more registers: with the accumulator and the A sets 160 at
//     N = 128 (180 in all), more than an even share of the register file
//     (168 a thread at 2 consumer warpgroups and a producer: it spilled).
//     So the producer is a warpgroup of its own that gives its registers
//     to the consumers (setmaxnreg: 40 a producer thread, 232 a consumer
//     one at 2 consumer warpgroups, 152 at 3, too few for N = 128, which
//     takes 2); one of its warps works, the rest leave. ptxas serializes
//     wgmmas whose A registers are written while any group is pending
//     (C7513), so a warpgroup waits for its own group before writing the
//     next set, and the warpgroups' dequant and wgmmas interleave
//     instead;
//   * the grid fills the card in one wave where it can: ops/q40.py
//     gemm_tf32_plan picks WG = 2 or 3 consumer warpgroups (128 or 192
//     rows a block) and a split of K (blockIdx.z walks its own run of
//     blocks and writes f32 partials, which K3b's q40_gemm_bf16_reduce (an
//     f32 sum) adds in split order: no atomics, so two launches give the
//     same bits);
//   * the sums (weight row, token) are stored straight from registers.
// Shared memory: N * 256 + WG * 1280 bytes a stage, 5 to 16 stages (at
// most ~200 KB), one block an SM.
#include <cuda.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// The block of WG consumer warpgroups (64 weight rows each) and a
// producer warpgroup, with a ring of one-Q40-block stages filling ~200 KB.
template <int N, int WG>
struct Layout {
  static constexpr int kRows = 64 * WG;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 128;
  // registers a thread: an even share of the 64K at launch (what
  // __launch_bounds__ gives ptxas), then the producer's moved to the
  // consumers; per SM sub-partition one producer and WG consumer warps
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      ((WG + 1) * kLaunchRegs - kProducerRegs) / WG / 8 * 8;
  static constexpr int kAtomBytes = N * 128;  // N tokens x 32 f32
  static constexpr int kCodeBytes = kRows * 16;
  static constexpr int kScaleBytes = kRows * 4;  // a word a row
  static constexpr int kStageBytes = 2 * kAtomBytes + kCodeBytes +
                                     kScaleBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes > 16
                                     ? 16
                                     : 200 * 1024 / kStageBytes;
  static constexpr int kXHi = 0;
  static constexpr int kXLo = kXHi + kStages * kAtomBytes;
  static constexpr int kCodes = kXLo + kStages * kAtomBytes;
  static constexpr int kScales = kCodes + kStages * kCodeBytes;
  static constexpr int kBars = kScales + kStages * kScaleBytes;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static constexpr size_t kSmem = kBytes + 1024;  // room to align to 1024
};

// The A fragments (hi and lo) of k8 step kk of a Q40 block for rows g
// (code word ca, scale sa) and g+8 (cb, sb). x_hi and x_lo hold the block
// permuted (q40_split_tf32): k slot c of step kk is value
// 4c + 2 (kk & 1) + 16 (kk >> 1), slot c + 4 the value after it, so this
// thread's two values of a row in step kk are bytes 2 (kk & 1) and
// 2 (kk & 1) + 1 of its code word 4c..4c+3, low nibbles for kk < 2, high
// ones above.
static __device__ __forceinline__ void dequant_step(uint32_t (&hi)[4],
                                                    uint32_t (&lo)[4],
                                                    uint32_t ca, uint32_t cb,
                                                    float sa, float sb,
                                                    int kk) {
  const uint32_t sh = kk >= 2 ? 4u : 0u;
  const uint32_t pa = (ca >> sh) & 0x0F0F0F0Fu;
  const uint32_t pb = (cb >> sh) & 0x0F0F0F0Fu;
  const uint32_t sel = 0x7440u + 2u * (kk & 1);
  // a0 = (g, c), a1 = (g+8, c), a2 = (g, c+4), a3 = (g+8, c+4)
  const float w[4] = {code_minus8(pa, sel) * sa, code_minus8(pb, sel) * sb,
                      code_minus8(pa, sel + 1) * sa,
                      code_minus8(pb, sel + 1) * sb};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_rna(w[e]);
    lo[e] = __float_as_uint(w[e] - __uint_as_float(hi[e]));  // exact
  }
}

// The f16 scale in half `odd` of an aligned word.
static __device__ __forceinline__ float word_scale(uint32_t w, bool odd) {
  return __half2float(__ushort_as_half(
      static_cast<uint16_t>(odd ? w >> 16 : w & 0xFFFFu)));
}

template <int N>
static __device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc,
                                                  int scale_d) {
  if constexpr (N == 16) {
    wgmma_rs_tf32_n16(d, a, desc, scale_d);
  } else if constexpr (N == 32) {
    wgmma_rs_tf32_n32(d, a, desc, scale_d);
  } else if constexpr (N == 64) {
    wgmma_rs_tf32_n64(d, a, desc, scale_d);
  } else {
    wgmma_rs_tf32_n128(d, a, desc, scale_d);
  }
}

template <int N, int WG>
__global__ void __launch_bounds__(Layout<N, WG>::kThreads, 1)
q40_gemm_kernel(const __grid_constant__ CUtensorMap xh_map,
                const __grid_constant__ CUtensorMap xl_map,
                const __grid_constant__ CUtensorMap q_map,
                const __half* __restrict__ d16, float* __restrict__ out,
                int t_len, int d, int nb, int per_split) {
  using L = Layout<N, WG>;
  constexpr int kStages = L::kStages;
  constexpr int kRows = L::kRows;
  constexpr int kConsumers = L::kConsumers;
  constexpr int kAtomBytes = L::kAtomBytes;
  constexpr int kCodeBytes = L::kCodeBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (cta_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* xh = sm + L::kXHi;
  uint8_t* xl = sm + L::kXLo;
  uint8_t* cs = sm + L::kCodes;
  uint32_t* ss = reinterpret_cast<uint32_t*>(sm + L::kScales);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;

  const int t0 = blockIdx.x * N;
  const int r0 = blockIdx.y * kRows;
  const int kb0 = blockIdx.z * per_split;
  const int n_my = min(nb, kb0 + per_split) - kb0;  // >= 1
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1 + 32);  // expect_tx + the 32 scale copiers
      mbar_init(&empty[i], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const uintptr_t d16_at = reinterpret_cast<uintptr_t>(d16);
  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<L::kProducerRegs>();
    if (warp > kConsumers / 32) return;
    // producer: TMA for x_hi, x_lo and the codes of block kb; the aligned
    // word holding each row's scale of the block by cp.async
    for (int i = 0; i < n_my; ++i) {
      const int slot = i % kStages;
      const uint32_t round = (i / kStages) & 1;
      const int kb = kb0 + i;
      mbar_wait(&empty[slot], round ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[slot], 2 * kAtomBytes + kCodeBytes);
        tma_load_2d(xh + slot * kAtomBytes, &xh_map, 32 * kb, t0,
                    &full[slot]);
        tma_load_2d(xl + slot * kAtomBytes, &xl_map, 32 * kb, t0,
                    &full[slot]);
        tma_load_2d(cs + slot * kCodeBytes, &q_map, 16 * kb, r0,
                    &full[slot]);
      }
      uint32_t* st = ss + slot * kRows;
#pragma unroll
      for (int j = 0; j < kRows / 32; ++j) {
        const int rl = lane + 32 * j;
        const int row = r0 + rl;
        if (row < d) {
          const uintptr_t half =
              d16_at + 2 * (static_cast<size_t>(row) * nb + kb);
          cp_async4(st + rl, reinterpret_cast<const void*>(
                                 half & ~static_cast<uintptr_t>(3)));
        }
      }
      cp_async_arrive(&full[slot]);
    }
    return;
  }

  setmaxnreg_inc<L::kConsumerRegs>();
  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block;
  // this thread's A rows are rl and rl + 8, its accumulator columns the
  // tokens 8 j + 2 c (+1)
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int rl = wg * 64 + (warp & 3) * 16 + g;
  // the half of block kb's scale word of rows rl and rl + 8 is this parity
  // xor kb's
  const uint32_t h0 = static_cast<uint32_t>(d16_at >> 1);
  const uint32_t odd_a = (h0 + static_cast<uint32_t>(r0 + rl) * nb) & 1;
  const uint32_t odd_b = (h0 + static_cast<uint32_t>(r0 + rl + 8) * nb) & 1;
  const bool live_a = r0 + rl < d, live_b = r0 + rl + 8 < d;

  // acc holds one stage's product (its first wgmma overwrites it), sum
  // the stages before: the tensor cores' f32 adds drop low bits, so a
  // chain of them stays one Q40 block long and the rounded f32 adds in
  // registers carry the rest
  float acc[N / 2], sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = sum[i] = 0.f;
  fence_operands(acc);

  uint32_t hi[4][4], lo[4][4];
  for (int i = 0; i < n_my; ++i) {
    const int slot = i % kStages;
    const int kb = kb0 + i;
    mbar_wait(&full[slot], (i / kStages) & 1);
    // the warpgroup's previous group has completed: its A sets and its
    // slot are free
    wgmma_wait<0>();
    fence_operands(acc);  // the previous stage's product is complete
    if (i >= 1) {
      mbar_arrive(&empty[(i - 1) % kStages]);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) sum[j] += acc[j];
    }
    // The shared loads come after the wait (its memory clobber holds them
    // there) and the A sets are computed from them: A registers written
    // while any group still runs make ptxas serialize every wgmma (C7513).
    const uint8_t* ct = cs + slot * kCodeBytes;
    const uint32_t ca = *reinterpret_cast<const uint32_t*>(ct + rl * 16 + 4 * c);
    const uint32_t cb =
        *reinterpret_cast<const uint32_t*>(ct + (rl + 8) * 16 + 4 * c);
    const uint32_t* st = ss + slot * kRows;
    const float sa = live_a ? word_scale(st[rl], odd_a ^ (kb & 1)) : 0.f;
    const float sb = live_b ? word_scale(st[rl + 8], odd_b ^ (kb & 1)) : 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dequant_step(hi[kk], lo[kk], ca, cb, sa, sb, kk);
    }
    const uint64_t dh = desc_sw128(xh + slot * kAtomBytes);
    const uint64_t dl = desc_sw128(xl + slot * kAtomBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 32 bytes of a B row a step
      wgmma_tf32<N>(acc, hi[kk], dh + 2 * kk, kk > 0);
      wgmma_tf32<N>(acc, hi[kk], dl + 2 * kk, 1);
      wgmma_tf32<N>(acc, lo[kk], dh + 2 * kk, 1);
    }
    wgmma_commit();
    fence_operands(acc);
  }
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) sum[j] += acc[j];

  float* dst = out + static_cast<size_t>(blockIdx.z) * t_len * d;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + rl + 8 * ((i >> 1) & 1);
    const int t = t0 + 8 * (i >> 2) + 2 * c + (i & 1);
    if (row < d && t < t_len) {
      dst[static_cast<size_t>(t) * d + row] = sum[i];
    }
  }
}

template <int N, int WG>
int launch(const void* qs, const void* d16, const void* xh, const void* xl,
           void* out, int t_len, int d, int nb, int splits,
           cudaStream_t stream) {
  using L = Layout<N, WG>;
  const int per = (nb + splits - 1) / splits;
  if ((splits - 1) * per >= nb) {  // a split with nothing to walk
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xh_map, xl_map, q_map;
  const uint64_t n = static_cast<uint64_t>(nb) * 32;
  if (!encode_map_2d(&xh_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xh, t_len, n,
                     n * 4, N, 32, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&xl_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xl, t_len, n,
                     n * 4, N, 32, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, qs, d,
                     static_cast<uint64_t>(nb) * 16,
                     static_cast<uint64_t>(nb) * 16, L::kRows, 16,
                     CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(q40_gemm_kernel<N, WG>, L::kSmem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the consumers' setmaxnreg.inc waits until the block's registers allow
  // it: launch only a build whose registers at launch cover the moves (one
  // producer and WG consumer warps a sub-partition, 8 registers a step)
  static const bool regs_cover = [] {
    cudaFuncAttributes fa;
    return cudaFuncGetAttributes(&fa, q40_gemm_kernel<N, WG>) == cudaSuccess &&
           (WG + 1) * ((fa.numRegs + 7) / 8 * 8) >=
               WG * L::kConsumerRegs + L::kProducerRegs;
  }();
  if (!regs_cover) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const dim3 grid((t_len + N - 1) / N, (d + L::kRows - 1) / L::kRows, splits);
  q40_gemm_kernel<N, WG><<<grid, L::kThreads, L::kSmem, stream>>>(
      xh_map, xl_map, q_map, static_cast<const __half*>(d16),
      static_cast<float*>(out), t_len, d, nb, per);
  return static_cast<int>(cudaGetLastError());
}

// x (t, n) -> x_hi, x_lo (t, n), each 32-value block permuted: position
// 8 kk + c holds value 4c + 2 (kk & 1) + 16 (kk >> 1), position 8 kk + c + 4
// the value after it (dequant_step). A thread writes one step's 8 positions
// of both buffers.
__global__ void q40_gemm_split_kernel(const float* __restrict__ x,
                                      float4* __restrict__ xh,
                                      float4* __restrict__ xl, int n8) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += gridDim.x * blockDim.x) {
    const int kk = i & 3;
    const float* src = x + 32 * static_cast<size_t>(i >> 2) + 2 * (kk & 1) +
                       16 * (kk >> 1);
    float v[8];  // positions 8 kk .. 8 kk + 7 of the block
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 p = *reinterpret_cast<const float2*>(src + 4 * c);
      v[c] = p.x;
      v[c + 4] = p.y;
    }
    float h[8], l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      h[e] = __uint_as_float(tf32_rna(v[e]));
      l[e] = __uint_as_float(tf32_rna(v[e] - h[e]));
    }
    xh[2 * i] = make_float4(h[0], h[1], h[2], h[3]);
    xh[2 * i + 1] = make_float4(h[4], h[5], h[6], h[7]);
    xl[2 * i] = make_float4(l[0], l[1], l[2], l[3]);
    xl[2 * i + 1] = make_float4(l[4], l[5], l[6], l[7]);
  }
}

// The token tile of T tokens (ops/q40.py gemm_bf16_tile says the same).
int token_tile(int t) {
  return t <= 16 ? 16 : t <= 32 ? 32 : t <= 64 ? 64 : 128;
}

template <int WG>
int dispatch(const void* qs, const void* d16, const void* xh, const void* xl,
             void* out, int t, int d, int nb, int splits, cudaStream_t s) {
  switch (token_tile(t)) {
    case 16:
      return launch<16, WG>(qs, d16, xh, xl, out, t, d, nb, splits, s);
    case 32:
      return launch<32, WG>(qs, d16, xh, xl, out, t, d, nb, splits, s);
    case 64:
      return launch<64, WG>(qs, d16, xh, xl, out, t, d, nb, splits, s);
    default:  // a 128-token tile: 2 warpgroups (see the header)
      if constexpr (WG == 2) {
        return launch<128, WG>(qs, d16, xh, xl, out, t, d, nb, splits, s);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
  }
}

}  // namespace

// x_hi, x_lo f32 (t, nb*32) from q40_split_tf32 -> out f32 (splits, t, d):
// with splits = 1 the product itself, else the partial sums of each
// split's run of Q40 blocks, which q40_gemm_bf16_reduce adds up; blocks
// of `warpgroups` (2 or 3; 2 for T > 64) x 64 weight rows. Launch on
// `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_gemm(const void* qs, const void* d16, const void* xh,
                        const void* xl, void* out, int t, int d, int nb,
                        int splits, int warpgroups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 0 || d <= 0 || nb <= 0 || splits < 1 || splits > 65535 ||
      (d + 127) / 128 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (warpgroups) {
    case 2:
      return dispatch<2>(qs, d16, xh, xl, out, t, d, nb, splits, s);
    case 3:
      return dispatch<3>(qs, d16, xh, xl, out, t, d, nb, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x_hi, x_lo = the 3xTF32 split of x, permuted within each 32-value block
// as K3 reads it, for n f32 values (n a multiple of 32; all three 16-byte
// aligned): K3's x, split once per call.
extern "C" int q40_split_tf32(const void* x, void* xh, void* xl, int n,
                              void* stream) {
  if (n <= 0 || n % 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n8 = n / 8;
  const int blocks = (n8 + 255) / 256 < 132 * 16 ? (n8 + 255) / 256 : 132 * 16;
  q40_gemm_split_kernel<<<blocks, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float4*>(xh),
      static_cast<float4*>(xl), n8);
  return static_cast<int>(cudaGetLastError());
}

