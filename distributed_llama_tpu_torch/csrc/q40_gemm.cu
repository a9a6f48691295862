// Q40 dequant-fused matrix product for Hopper (sm_90a), T > 8 (K3):
//
//   out[t, r] = sum_k x[t, k] * (code[r, k] - 8) * d16[r, k / 32]   (f32)
//
// i.e. out (T, d) = x (T, n) . dequant(W)(d, n)^T with f32 products and f32
// accumulation — no TF32, since the parity contract is f32.
//
// Replaces the T > 8 branch of the JAX package's ops/pallas_q40.py
// (_q40_matmul_2d / _q40_matmul_stacked with _kernel -> _matmul_body in
// parity mode), and its scratch, nb-major and legacy tilings
// (_q40_matmul_*_scratch, _q40_mxu_nb_*), which compute the same function.
//
// Layout: qs uint8 (d, nb, 16) (byte j of a block holds value j in its low
// nibble and value j+16 in its high nibble); d16 f16 (d, nb); x f32
// (T, nb*32); out f32 (T, d). A layer of a stacked weight is a pointer
// offset.
//
// Bound: operations. 2*T*d*n flops on the f32 SIMT cores (67 TFLOP/s)
// against 0.5625 bytes per weight value (3.35 TB/s): from T of about 6 on,
// the flops take longer. Design, a tiled SIMT GEMM:
//   * a block owns a (8*MI x 64) tile of out — MI = 2, 4 or 8 by T, so a
//     16-token chunk does not pay for 64 — and walks n in stages of two Q40
//     blocks (64 values);
//   * the x tile, the 64 weight rows' code bytes and their f16 scales of a
//     stage are copied asynchronously (cp.async) into a ring of three
//     stages: stage s + 2 is issued as stage s is computed;
//   * the codes of stage s + 1 are dequantized to (code - 8) * d16 (exact
//     in f32) into one of two weight tiles while stage s is computed from
//     the other, so one barrier per stage suffices; rows are k-contiguous
//     and padded to 68 floats, so the compute loop's float4 reads fall on
//     distinct banks;
//   * 256 threads in four groups of 64; each group takes a quarter of the
//     stage's 64 values (a split of k inside the block), and each thread
//     accumulates an MI x 8 register micro-tile (rows ty + 8i, columns
//     tx + 8j): MI + 8 float4 reads for 32*MI FMAs. The four groups'
//     partial tiles are summed through shared memory at the end, in a
//     fixed order ((g0 + g2) + (g1 + g3)), so the result does not depend
//     on scheduling;
//   * ragged T, d and an odd block count are zero-filled by the copies and
//     not stored, where the JAX package pads T to a multiple of 8.
// Shared memory: 95 KB at MI = 8 (the opt-in above 48 KB is made on every
// launch).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;        // k-split groups of 64 threads
constexpr int kBD = 64;           // weight rows (out columns) per block
constexpr int kStageBlocks = 2;   // Q40 blocks per k-stage
constexpr int kK = 32 * kStageBlocks;
constexpr int kKG = kK / kGroups; // values of a stage per group
constexpr int kKP = kK + 4;       // padded row stride of the staged tiles
constexpr int kDepth = 3;         // stages of the copy ring
constexpr int kCodeWords = kBD * 8;   // a stage's code bytes / 4
constexpr int kScaleWords = kBD * 2;  // the 4 f16 slots around a row's pair
constexpr int kWTile = kBD * kKP;     // floats of one weight tile

// 32-bit words of shared memory: the x, code and scale rings and the two
// weight tiles
template <int MI>
constexpr int smem_words() {
  return kDepth * (8 * MI * kKP + kCodeWords + kScaleWords) + 2 * kWTile;
}

// Asynchronous copies global -> shared (sm_80+): `bytes` of the copy are
// read and the rest of the destination is zero-filled (0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of one stage (blocks kb0, kb0 + 1) into ring slots: one
// 16-byte code block per (row, block), the two aligned 32-bit words of f16
// slots around each row's scale pair (whose offset may be odd; h0 = 1 when
// d16w's first slot precedes the array), and the x tile in float4s. Rows
// past d, blocks past nb and x past (T, n) are zero-filled.
template <int MI>
__device__ __forceinline__ void issue_stage(
    float* xr, uint32_t* cr, uint32_t* sr, const uint4* __restrict__ qs,
    const uint32_t* __restrict__ d16w, const float* __restrict__ x,
    int t_len, int d, int nb, int h0, int t0, int d0, int kb0) {
  const int tid = threadIdx.x;
  if (tid < 2 * kBD) {
    const int row = d0 + (tid >> 1);
    const int blk = kb0 + (tid & 1);
    const bool ok = row < d && blk < nb;
    cp_async16(cr + 4 * tid,
               ok ? qs + static_cast<size_t>(row) * nb + blk : qs,
               ok ? 16 : 0);
  } else {
    const int i = tid - 2 * kBD;
    const int row = d0 + (i >> 1);
    const size_t slots = static_cast<size_t>(d) * nb + h0;
    const size_t word =
        ((static_cast<size_t>(row) * nb + kb0 + h0) >> 1) + (i & 1);
    const int bytes = row >= d                ? 0
                      : 2 * word + 1 < slots ? 4
                      : 2 * word < slots     ? 2
                                             : 0;
    cp_async4(sr + i, bytes ? d16w + word : d16w, bytes);
  }
  const size_t n = static_cast<size_t>(nb) * 32;
#pragma unroll
  for (int i = 0; i < MI / 2; ++i) {
    const int idx = tid + kThreads * i;  // 16 float4s per row of the x tile
    const int t = t0 + (idx >> 4);
    const size_t k = static_cast<size_t>(kb0) * 32 + 4 * (idx & 15);
    const bool ok = t < t_len && k < n;
    cp_async16(xr + (idx >> 4) * kKP + 4 * (idx & 15),
               ok ? x + t * n + k : x, ok ? 16 : 0);
  }
}

// Dequantize one landed stage's codes into a weight tile: thread tid takes
// code word tid & 7 of rows tid >> 3 and (tid >> 3) + 32.
__device__ __forceinline__ void dequant_stage(const uint32_t* cr,
                                              const uint32_t* sr, float* ws,
                                              int d0, int nb, int h0) {
  const int tid = threadIdx.x;
  const int lw = tid & 7;
  const int k = 32 * (lw >> 2) + 4 * (lw & 3);  // values k.., k+16..
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int lr = (tid >> 3) + 32 * p;
    const uint32_t word = cr[lr * 8 + lw];
    // the row's pair starts at an odd f16 slot iff row * nb + h0 is odd
    // (kb0 is even)
    const int odd = ((d0 + lr) & nb & 1) ^ h0;
    const float s = __half2float(
        reinterpret_cast<const __half*>(sr + 2 * lr)[odd + (lw >> 2)]);
    const uint32_t lo = word & 0x0F0F0F0Fu;
    const uint32_t hi = (word >> 4) & 0x0F0F0F0Fu;
    float* w = ws + lr * kKP + k;
    *reinterpret_cast<float4*>(w) = make_float4(
        code_minus8(lo, 0x7440u) * s, code_minus8(lo, 0x7441u) * s,
        code_minus8(lo, 0x7442u) * s, code_minus8(lo, 0x7443u) * s);
    *reinterpret_cast<float4*>(w + 16) = make_float4(
        code_minus8(hi, 0x7440u) * s, code_minus8(hi, 0x7441u) * s,
        code_minus8(hi, 0x7442u) * s, code_minus8(hi, 0x7443u) * s);
  }
}

// A group's partial micro-tiles to / from a (8*MI x kBD) slot.
template <int MI>
__device__ __forceinline__ void put_partial(const float (&acc)[MI][8],
                                            float* slot, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      slot[(ty + 8 * i) * kBD + tx + 8 * j] = acc[i][j];
    }
  }
}

template <int MI>
__device__ __forceinline__ void add_partial(float (&acc)[MI][8],
                                            const float* slot, int ty,
                                            int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] += slot[(ty + 8 * i) * kBD + tx + 8 * j];
    }
  }
}

template <int MI>
__global__ void __launch_bounds__(kThreads)
q40_gemm_kernel(const uint4* __restrict__ qs,
                const uint32_t* __restrict__ d16w,
                const float* __restrict__ x, float* __restrict__ out,
                int t_len, int d, int nb, int h0) {
  constexpr int kBT = 8 * MI;
  constexpr int kXTile = kBT * kKP;
  extern __shared__ float4 sm4[];
  float* const sm = reinterpret_cast<float*>(sm4);
  float* const xring = sm;
  float* const wtiles = xring + kDepth * kXTile;
  uint32_t* const cring = reinterpret_cast<uint32_t*>(wtiles + 2 * kWTile);
  uint32_t* const sring = cring + kDepth * kCodeWords;
  // a group's two warps each cover 4 x 8 (ty, tx) threads: the 8 lanes of a
  // quarter-warp share ty (one broadcast x read) and read 8 weight rows
  // 68 floats apart (distinct banks)
  const int grp = threadIdx.x >> 6;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 7;
  const int ty = ((threadIdx.x >> 5) & 1) * 4 + (lane >> 3);
  const int d0 = blockIdx.x * kBD;
  const int t0 = blockIdx.y * kBT;

  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int n_stages = (nb + kStageBlocks - 1) / kStageBlocks;
  for (int s = 0; s < kDepth - 1; ++s) {
    if (s < n_stages) {
      issue_stage<MI>(xring + s * kXTile, cring + s * kCodeWords,
                      sring + s * kScaleWords, qs, d16w, x, t_len, d, nb,
                      h0, t0, d0, s * kStageBlocks);
    }
    cp_async_commit();  // empty groups past the end keep the count
  }
  cp_async_wait<kDepth - 2>();  // this thread's copies of stage 0 landed
  __syncthreads();
  dequant_stage(cring, sring, wtiles, d0, nb, h0);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kDepth - 3>();  // ... and those of stage s + 1
    // weight tile s is complete, stage s + 1 has landed for every thread,
    // and every reader of stage s - 1 is done
    __syncthreads();
    const int nxt = s + kDepth - 1;  // into the ring slot of stage s - 1
    if (nxt < n_stages) {
      const int slot = nxt % kDepth;
      issue_stage<MI>(xring + slot * kXTile, cring + slot * kCodeWords,
                      sring + slot * kScaleWords, qs, d16w, x, t_len, d, nb,
                      h0, t0, d0, nxt * kStageBlocks);
    }
    cp_async_commit();
    if (s + 1 < n_stages) {  // the next tile, overlapping the FMAs below
      const int slot = (s + 1) % kDepth;
      dequant_stage(cring + slot * kCodeWords, sring + slot * kScaleWords,
                    wtiles + ((s + 1) & 1) * kWTile, d0, nb, h0);
    }
    const float* ws = wtiles + (s & 1) * kWTile;
    const float* xs = xring + (s % kDepth) * kXTile;
#pragma unroll
    for (int kq = 0; kq < kKG; kq += 4) {
      const int kk = grp * kKG + kq;
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = *reinterpret_cast<const float4*>(ws + (tx + 8 * j) * kKP + kk);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(xs + (ty + 8 * i) * kKP + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float c = acc[i][j];
          c = fmaf(a.x, b[j].x, c);
          c = fmaf(a.y, b[j].y, c);
          c = fmaf(a.z, b[j].z, c);
          c = fmaf(a.w, b[j].w, c);
          acc[i][j] = c;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every reader of the tiles is done

  // sum the groups' partial tiles, (g0 + g2) + (g1 + g3), through two
  // (kBT x kBD) slots in the rings' space
  if (grp >= 2) put_partial<MI>(acc, sm + (grp & 1) * kBT * kBD, ty, tx);
  __syncthreads();
  if (grp < 2) add_partial<MI>(acc, sm + grp * kBT * kBD, ty, tx);
  __syncthreads();
  if (grp == 1) put_partial<MI>(acc, sm, ty, tx);
  __syncthreads();
  if (grp != 0) return;
  add_partial<MI>(acc, sm, ty, tx);

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int t = t0 + ty + 8 * i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = d0 + tx + 8 * j;
      if (col < d) out[static_cast<size_t>(t) * d + col] = acc[i][j];
    }
  }
}

template <int MI>
int launch(const void* qs, const void* d16, const void* x, void* out,
           int t_len, int d, int nb, cudaStream_t stream) {
  // the scales are copied as aligned 32-bit words: h0 = 1 when d16 starts
  // in the second half of one
  const uintptr_t p = reinterpret_cast<uintptr_t>(d16);
  const int h0 = static_cast<int>((p >> 1) & 1);
  const size_t smem = smem_words<MI>() * sizeof(float);
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(q40_gemm_kernel<MI>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d + kBD - 1) / kBD, (t_len + 8 * MI - 1) / (8 * MI));
  q40_gemm_kernel<MI><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(qs),
      reinterpret_cast<const uint32_t*>(p - 2 * h0),
      static_cast<const float*>(x), static_cast<float*>(out), t_len, d, nb,
      h0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (t, nb*32) f32 -> out (t, d) f32, any t >= 1 (the port sends t > 8).
// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_gemm(const void* qs, const void* d16, const void* x,
                        void* out, int t, int d, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 0 || t > 65535 * 16) return static_cast<int>(cudaErrorInvalidValue);
  if (t <= 16) return launch<2>(qs, d16, x, out, t, d, nb, s);
  if (t <= 32) return launch<4>(qs, d16, x, out, t, d, nb, s);
  return launch<8>(qs, d16, x, out, t, d, nb, s);
}
