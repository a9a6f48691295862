// Q40 dequant-fused bf16 tensor-core matrix product for Hopper (sm_90a),
// T > 8 under --fast-prefill (K3b):
//
//   out[t, r] = sum_k f32(bf16(x[t, k]) * bf16((code[r, k] - 8) * s[r, k]))
//
// (s[r, k] = d16[r, k / 32] widened to f32), i.e. out (T, d) =
// x (T, n) . dequant(W)(d, n)^T with each operand rounded
// to bf16 (nearest even) and f32 accumulation. The weight value is rounded
// after its exact f32 product with the scale, as the JAX package does.
//
// Replaces the bf16 bodies of the JAX package's ops/pallas_q40.py T > 8
// matmul (_kernel -> _matmul_body with bf16=True, the scratch and nb-major
// twins _matmul_body_scratch / _q40_mxu_nb_*, and the dequantize-then-dot
// arm _dequant_matmul -> _precision_dot that DLLAMA_PREFILL_MATMUL=auto
// picks under bf16), which all compute this function.
//
// Layout as K3: qs uint8 (d, nb, 16) (byte j of a block holds value j in
// its low nibble and value j+16 in its high nibble); d16 f16 (d, nb), at
// any 2-byte offset; out f32 (T, d). x arrives already rounded: the
// wrapper runs q40_round_bf16 (below) once per call into a bf16 (T, n)
// buffer, so no block converts x again and TMA moves 2 bytes a value.
//
// Bound: 2*T*d*n flops at 989 TFLOP/s against 0.5625 bytes per weight
// value and 4 per x and out value at 3.35 TB/s: operations from T = 128 on
// at 7B's layer widths, bytes below. What held the first version back was
// neither: one stage in flight through registers, 128 blocks of 4 warps
// for d = 4096, and x re-read in f32 by every block. Design:
//   * operands swapped: a block computes a (64 WG weight rows x N tokens)
//     tile of out^T = W . x^T with wgmma m64nNk16 (N = 16, 32, 64 or 128,
//     the token tile; T > 128 takes more token tiles), one warpgroup per 64
//     rows. A comes from registers: a thread's fragment of rows g, g+8 in a
//     k16 step is values 2c, 2c+1, 2c+8, 2c+9 of the Q40 block, and the two
//     k16 steps of one block are the low and the high nibbles of the same
//     four code bytes, so each thread dequantizes straight into its A
//     registers (no dequantized tile, no ldmatrix). B is the x tile, K-major
//     in shared memory with the 128-byte swizzle, as TMA writes it;
//   * a ring of stages of 128 values (four Q40 blocks; 64 for token tiles
//     up to 32, which measured faster so) with full and empty mbarriers,
//     ~200 KB deep: one producer warp issues TMA for the x tile and for
//     the code tile (qs viewed as a 2-D uint8 (d, nb*16) tensor; rows and
//     blocks past the edge arrive as zeros). The f16 scales may start at
//     any 2-byte offset, so no bulk copy may read them: each lane copies
//     the aligned words that hold a row's scales of the stage with 4-byte
//     cp.async (completing on the same mbarrier), and the consumers pick
//     them out by the row's parity. The last word is copied only where
//     the scales straddle it: one word past the last scale faulted where
//     the scales end at the end of their allocation (7B's stacked wqkv
//     scales, 96 MiB); as in K3, scales that start 2 bytes past a 4-byte
//     boundary read the 2 bytes before them and the 2 after, which lie
//     inside the allocation (its size is a multiple of 4);
//   * each consumer warpgroup dequantizes a whole stage (eight k16 steps)
//     into its A registers and issues the stage's wgmmas as one group;
//     ptxas serializes wgmmas whose A registers are written while any
//     group is pending (C7513), so a warpgroup waits for its own group
//     before writing the next set, and the warpgroups' dequant and wgmmas
//     interleave instead;
//   * the grid fills the card in one wave where it can: ops/q40.py
//     gemm_bf16_plan picks WG = 2 or 3 consumer warpgroups (128 or 192
//     rows a block) and a split of K (blockIdx.z walks its own run of
//     stages and writes f32 partials, which q40_gemm_bf16_reduce sums in
//     split order: no atomics, so two launches give the same bits); at
//     T = 128 on the H100: wqkv 3 x 2, wo and w2 2 x 4, w13 3 x 1. Four
//     warpgroups spilled at 544 threads, and 256-row blocks measured
//     slower than 128-row ones;
//   * the accumulators (weight row, token) are stored straight from
//     registers: each store instruction writes 4 tokens x 8 consecutive
//     rows, whole 32-byte sectors, against 3.6 bytes of weight read per
//     byte of out at T = 128.
// Shared memory: 4 stages of N*256 + WG * 7040 bytes at N = 128 (166 / 185
// KB for WG = 2 / 3), one block an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// The block of WG consumer warpgroups (64 weight rows each) and one
// producer warp, with a ring of N-token stages filling ~200 KB. A stage is
// 4 Q40 blocks (128 values) deep; 2 for token tiles of 16 and 32, which
// measured faster with the shorter stage (ops/q40.py gemm_bf16_stage_blocks
// says the same).
template <int N, int WG>
struct Layout {
  static constexpr int kQB = N <= 32 ? 2 : 4;  // Q40 blocks a stage
  static constexpr int kBK = 32 * kQB;         // values a stage
  static constexpr int kAtoms = kBK / 64;  // 128-byte swizzle atoms of x
  static constexpr int kSteps = 2 * kQB;   // k16 steps a stage
  static constexpr int kWin = kQB / 2 + 1;  // words of a row's scale window
  static constexpr int kRows = 64 * WG;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kCodeBytes = kRows * 16 * kQB;  // a stage's codes
  static constexpr int kScaleBytes = kRows * 4 * kWin;  // its scale windows
  static constexpr int kAtomBytes = N * 128;  // N tokens x 64 bf16
  static constexpr int kXBytes = kAtoms * kAtomBytes;
  static constexpr int kStageBytes = kXBytes + kCodeBytes + kScaleBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes > 8
                                     ? 8
                                     : 200 * 1024 / kStageBytes;
  static constexpr int kX = 0;
  static constexpr int kCodes = kX + kStages * kXBytes;
  static constexpr int kScales = kCodes + kStages * kCodeBytes;
  static constexpr int kBars = kScales + kStages * kScaleBytes;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static constexpr size_t kSmem = kBytes + 1024;  // room to align to 1024
};

static __device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The A fragment of one k16 step: rows g (codes `ca`, scale sa) and g+8
// (cb, sb); bytes 0..3 of ca / cb are the nibbles of values 2c, 2c+1,
// 2c+8, 2c+9 of the step.
static __device__ __forceinline__ void dequant_a(uint32_t (&a)[4],
                                                 uint32_t ca, uint32_t cb,
                                                 float sa, float sb) {
  a[0] = pack_bf16(code_minus8(ca, 0x7440u) * sa,
                   code_minus8(ca, 0x7441u) * sa);
  a[1] = pack_bf16(code_minus8(cb, 0x7440u) * sb,
                   code_minus8(cb, 0x7441u) * sb);
  a[2] = pack_bf16(code_minus8(ca, 0x7442u) * sa,
                   code_minus8(ca, 0x7443u) * sa);
  a[3] = pack_bf16(code_minus8(cb, 0x7442u) * sb,
                   code_minus8(cb, 0x7443u) * sb);
}

// Scale b (0 .. 3) of a row's stage from its window of words `w`: the
// stage's f16 scales start at byte 0 of the window, or at byte 2 (`odd`).
static __device__ __forceinline__ float window_scale(const uint32_t* w,
                                                     bool odd, int b) {
  const int h = b + (odd ? 1 : 0);  // the scale's half in the window
  const uint32_t v = w[h >> 1] >> (16 * (h & 1));
  return __half2float(__ushort_as_half(static_cast<uint16_t>(v & 0xFFFFu)));
}

template <int N>
static __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, desc);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc);
  } else {
    wgmma_rs_n128(d, a, desc);
  }
}

template <int N, int WG>
__global__ void __launch_bounds__(Layout<N, WG>::kThreads, 1)
q40_gemm_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __half* __restrict__ d16, float* __restrict__ out,
                     int t_len, int d, int nb, int per_split) {
  using L = Layout<N, WG>;
  constexpr int kQB = L::kQB, kBK = L::kBK, kAtoms = L::kAtoms;
  constexpr int kSteps = L::kSteps, kWin = L::kWin;
  constexpr int kStages = L::kStages;
  constexpr int kRows = L::kRows;
  constexpr int kConsumers = L::kConsumers;
  constexpr int kCodeBytes = L::kCodeBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (cta_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* xs = sm + L::kX;
  uint8_t* cs = sm + L::kCodes;
  uint32_t* ss = reinterpret_cast<uint32_t*>(sm + L::kScales);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;

  const int t0 = blockIdx.x * N;
  const int r0 = blockIdx.y * kRows;
  const int n_stages = (nb + kQB - 1) / kQB;
  const int s0 = blockIdx.z * per_split;
  const int n_my = min(n_stages, s0 + per_split) - s0;  // >= 1
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

  if (warp == kConsumers / 32) {
    // producer: TMA for x and the codes; for the scales of row r, the
    // aligned window of words holding its kQB f16 scales of the stage (from
    // byte 0 or 2 of the window, by the row's parity), by cp.async
    const uintptr_t d16_at = reinterpret_cast<uintptr_t>(d16);
    for (int i = 0; i < n_my; ++i) {
      const int slot = i % kStages;
      const uint32_t round = (i / kStages) & 1;
      const int s = s0 + i;
      mbar_wait(&empty[slot], round ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[slot], L::kXBytes + kCodeBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_2d(xs + slot * L::kXBytes + a * L::kAtomBytes, &x_map,
                      s * kBK + 64 * a, t0, &full[slot]);
        }
        tma_load_2d(cs + slot * kCodeBytes, &q_map, s * 16 * kQB, r0,
                    &full[slot]);
      }
      uint32_t* st = ss + slot * kRows * kWin;
#pragma unroll
      for (int j = 0; j < kRows / 32; ++j) {
        const int rl = lane + 32 * j;
        const int row = r0 + rl;
        if (row < d) {
          const uintptr_t half =
              d16_at + 2 * (static_cast<size_t>(row) * nb + kQB * s);
          const uintptr_t at = half & ~static_cast<uintptr_t>(3);
#pragma unroll
          for (int k = 0; k < kWin - 1; ++k) {
            cp_async4(st + kWin * rl + k,
                      reinterpret_cast<const void*>(at + 4 * k));
          }
          if (half & 2) {  // the scales straddle one more word
            cp_async4(st + kWin * rl + kWin - 1,
                      reinterpret_cast<const void*>(at + 4 * (kWin - 1)));
          }
        }
      }
      cp_async_arrive(&full[slot]);
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block;
  // this thread's A rows are rl and rl + 8, its accumulator columns the
  // tokens 8 j + 2 c (+1)
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int rl = wg * 64 + (warp & 3) * 16 + g;
  // the parity of rows rl and rl + 8 in their scale windows
  const uintptr_t d16_at = reinterpret_cast<uintptr_t>(d16);
  const bool odd_a = (d16_at + 2 * static_cast<size_t>(r0 + rl) * nb) & 2;
  const bool odd_b =
      (d16_at + 2 * static_cast<size_t>(r0 + rl + 8) * nb) & 2;
  const bool live_a = r0 + rl < d, live_b = r0 + rl + 8 < d;

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_operands(acc);  // the zeros are set before the first wgmma

  // One stage: once the warpgroup's previous group has completed (which
  // frees the A set and that stage's slot of the ring), its codes and
  // scales into registers, all kSteps k16 steps dequantized at once
  // (independent chains the scheduler interleaves), then kSteps wgmmas
  // committed as one group.
  auto stage = [&](uint32_t (&as)[kSteps][4], int i) {
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    const uint8_t* ct = cs + slot * kCodeBytes;
    const uint32_t* st = ss + slot * kRows * kWin;
    const int s = s0 + i;
    wgmma_wait<0>();
    if (i >= 1) mbar_arrive(&empty[(i - 1) % kStages]);
    // The shared loads come after the wait (its memory clobber holds them
    // there) and the A set is computed from them: A registers written while
    // any group still runs make ptxas serialize every wgmma (C7513), so
    // each warpgroup's dequant overlaps the other warpgroup's wgmmas, not
    // its own.
    uint32_t ca[kQB], cb[kQB];
    float sa[kQB], sb[kQB];
#pragma unroll
    for (int b = 0; b < kQB; ++b) {  // the stage's Q40 blocks
      const uint8_t* pa = ct + rl * 16 * kQB + b * 16 + 2 * c;
      const uint8_t* pb = pa + 8 * 16 * kQB;
      ca[b] = ld_u16(pa) | (ld_u16(pa + 8) << 16);
      cb[b] = ld_u16(pb) | (ld_u16(pb + 8) << 16);
      const bool blk_live = kQB * s + b < nb;
      sa[b] = live_a && blk_live ? window_scale(st + kWin * rl, odd_a, b)
                                 : 0.f;
      sb[b] = live_b && blk_live
                  ? window_scale(st + kWin * (rl + 8), odd_b, b)
                  : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {  // block kk / 2, nibble kk % 2
      const int b = kk >> 1;
      const uint32_t sh = (kk & 1) ? 4u : 0u;
      dequant_a(as[kk], (ca[b] >> sh) & 0x0F0F0F0Fu,
                (cb[b] >> sh) & 0x0F0F0F0Fu, sa[b], sb[b]);
    }
    const uint64_t desc = desc_sw128(xs + slot * L::kXBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {  // atom kk / 4, step kk % 4
      wgmma_rs<N>(acc, as[kk],
                  desc + (kk >> 2) * (L::kAtomBytes >> 4) + 2 * (kk & 3));
    }
    wgmma_commit();
    fence_operands(acc);
  };
  uint32_t a[kSteps][4];
  for (int i = 0; i < n_my; ++i) stage(a, i);
  wgmma_wait<0>();
  fence_operands(acc);

  float* dst = out + static_cast<size_t>(blockIdx.z) * t_len * d;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + rl + 8 * ((i >> 1) & 1);
    const int t = t0 + 8 * (i >> 2) + 2 * c + (i & 1);
    if (row < d && t < t_len) {
      dst[static_cast<size_t>(t) * d + row] = acc[i];
    }
  }
}

template <int N, int WG>
int launch(const void* qs, const void* d16, const void* xb, void* out,
           int t_len, int d, int nb, int splits, cudaStream_t stream) {
  using L = Layout<N, WG>;
  constexpr int kRows = L::kRows, kQB = L::kQB;
  const int n_stages = (nb + kQB - 1) / kQB;
  const int per = (n_stages + splits - 1) / splits;
  if ((splits - 1) * per >= n_stages) {  // a split with nothing to walk
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap x_map, q_map;
  const uint64_t n = static_cast<uint64_t>(nb) * 32;
  if (!encode_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xb, t_len, n,
                     n * 2, N, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, qs, d,
                     static_cast<uint64_t>(nb) * 16,
                     static_cast<uint64_t>(nb) * 16, kRows, 16 * kQB,
                     CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(q40_gemm_bf16_kernel<N, WG>, L::kSmem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t_len + N - 1) / N, (d + kRows - 1) / kRows, splits);
  q40_gemm_bf16_kernel<N, WG><<<grid, L::kThreads, L::kSmem, stream>>>(
      x_map, q_map, static_cast<const __half*>(d16),
      static_cast<float*>(out), t_len, d, nb, per);
  return static_cast<int>(cudaGetLastError());
}

__global__ void q40_gemm_bf16_round_kernel(const float4* __restrict__ x,
                                           uint2* __restrict__ y, int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    const float4 v = __ldg(x + i);
    y[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

__global__ void q40_gemm_bf16_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ out, int n,
                                            int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = part[i];
    for (int j = 1; j < splits; ++j) s += part[static_cast<size_t>(j) * n + i];
    out[i] = s;
  }
}

int grid_for(int n) {
  const int blocks = (n + 255) / 256;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

// The token tile of T tokens (ops/q40.py gemm_bf16_tile says the same).
int token_tile(int t) {
  return t <= 16 ? 16 : t <= 32 ? 32 : t <= 64 ? 64 : 128;
}

template <int WG>
int dispatch(const void* qs, const void* d16, const void* xb, void* out,
             int t, int d, int nb, int splits, cudaStream_t s) {
  switch (token_tile(t)) {
    case 16:
      return launch<16, WG>(qs, d16, xb, out, t, d, nb, splits, s);
    case 32:
      return launch<32, WG>(qs, d16, xb, out, t, d, nb, splits, s);
    case 64:
      return launch<64, WG>(qs, d16, xb, out, t, d, nb, splits, s);
    default:
      return launch<128, WG>(qs, d16, xb, out, t, d, nb, splits, s);
  }
}

}  // namespace

// xb bf16 (t, nb*32) -> out f32 (splits, t, d): with splits = 1 the product
// itself, else the partial sums of each split's run of k stages, which
// q40_gemm_bf16_reduce adds up; blocks of `warpgroups` (2 or 3) x 64 weight
// rows. Launch on `stream`; returns the cudaGetLastError() code (0 =
// launched).
extern "C" int q40_gemm_bf16(const void* qs, const void* d16, const void* xb,
                             void* out, int t, int d, int nb, int splits,
                             int warpgroups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 0 || d <= 0 || nb <= 0 || splits < 1 || splits > 65535 ||
      (d + 127) / 128 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (warpgroups) {
    case 2:
      return dispatch<2>(qs, d16, xb, out, t, d, nb, splits, s);
    case 3:
      return dispatch<3>(qs, d16, xb, out, t, d, nb, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y = bf16(x) (nearest even) for n f32 values, n a multiple of 4, both
// 16-byte aligned: K3b's x, rounded once per call.
extern "C" int q40_round_bf16(const void* x, void* y, int n, void* stream) {
  if (n <= 0 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n / 4;
  q40_gemm_bf16_round_kernel<<<grid_for(n4), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint2*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = part[0][i] + part[1][i] + ... (in split order) for the n values
// of each of `splits` partial products.
extern "C" int q40_gemm_bf16_reduce(const void* part, void* out, int n,
                                    int splits, void* stream) {
  if (n <= 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  q40_gemm_bf16_reduce_kernel<<<grid_for(n), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
  return static_cast<int>(cudaGetLastError());
}
