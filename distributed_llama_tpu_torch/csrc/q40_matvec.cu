// Q40 matrix-vector products for Hopper (sm_90a): K1 for T = 1 (below) and
// K1m for T = 2..8 (further down, with its own note).
//
//   out[r] = sum_b d16[r,b] * sum_{j<32} (code[r,b,j] - 8) * x[32b + j]   (f32)
//
// Replaces the T=1 matvec of the JAX package's ops/pallas_q40.py
// (q40_matmul -> _q40_matmul_2d / _q40_matmul_stacked with _kernel_matvec,
// and the nb-major and int4-plane tilings of the same computation).
//
// Layout (the codec layout, chosen at load time): qs uint8 (d, nb, 16),
// byte j of a block holds value j in its low nibble and value j+16 in its
// high nibble; d16 f16 (d, nb); x f32 (nb*32); out f32 (d). A layer of a
// stacked weight is a pointer offset, so no per-layer copy exists.
//
// Bound: the packed weight bytes (18 per 32 values) read once from device
// memory. Design, simple first:
//   * one warp per output row, kWarps rows per block;
//   * lanes stride over the row's blocks, each block one 16-byte code load
//     and one f16 scale, kUnroll blocks in flight per lane;
//   * x staged once per block in shared memory, each 32-value block padded
//     to 36 floats so that the lanes' float4 reads of 8 different blocks
//     fall on distinct banks;
//   * codes become floats with a byte permute into 2^23 + code (exact), so
//     no integer-to-float conversion is issued;
//   * f32 accumulation throughout, warp-shuffle reduction.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;      // output rows per thread block
constexpr int kBlockPad = 36;  // floats per staged 32-value block of x
constexpr int kUnroll = 4;     // code blocks in flight per lane

// sum_j (code_j - 8) * x_j over one block; xb = the staged block (36 floats).
__device__ __forceinline__ float block_dot(uint4 q, const float* xb) {
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t lo = words[w] & 0x0F0F0F0Fu;         // values 4w..4w+3
    const uint32_t hi = (words[w] >> 4) & 0x0F0F0F0Fu;  // values 16+4w..
    const float4 xl = x4[w];
    const float4 xh = x4[4 + w];
    s = fmaf(code_minus8(lo, 0x7440u), xl.x, s);
    s = fmaf(code_minus8(lo, 0x7441u), xl.y, s);
    s = fmaf(code_minus8(lo, 0x7442u), xl.z, s);
    s = fmaf(code_minus8(lo, 0x7443u), xl.w, s);
    s = fmaf(code_minus8(hi, 0x7440u), xh.x, s);
    s = fmaf(code_minus8(hi, 0x7441u), xh.y, s);
    s = fmaf(code_minus8(hi, 0x7442u), xh.z, s);
    s = fmaf(code_minus8(hi, 0x7443u), xh.w, s);
  }
  return s;
}

__global__ void __launch_bounds__(kWarps * 32)
q40_matvec_kernel(const uint4* __restrict__ qs, const __half* __restrict__ d16,
                  const float* __restrict__ x, float* __restrict__ out,
                  int d, int nb) {
  extern __shared__ float xs[];  // nb * kBlockPad floats
  const int n = nb * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[(i >> 5) * kBlockPad + (i & 31)] = x[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= d) return;
  const uint4* qrow = qs + static_cast<size_t>(row) * nb;
  const __half* drow = d16 + static_cast<size_t>(row) * nb;

  float acc = 0.f;
  int b = lane;
  for (; b + 32 * (kUnroll - 1) < nb; b += 32 * kUnroll) {
    uint4 q[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      q[u] = __ldg(qrow + b + 32 * u);
      s[u] = __half2float(drow[b + 32 * u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = fmaf(s[u], block_dot(q[u], xs + (b + 32 * u) * kBlockPad), acc);
    }
  }
  for (; b < nb; b += 32) {
    acc = fmaf(__half2float(drow[b]), block_dot(__ldg(qrow + b),
                                                xs + b * kBlockPad), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[row] = acc;
}

// ---------------------------------------------------------------------------
// K1m: the same product for T = 2..8 tokens (small-T matvec).
//
//   out[t, r] = sum_b d16[r,b] * sum_j (code[r,b,j] - 8) * x[t, 32b + j]
//
// Replaces the 2 <= T <= 8 branch of the JAX package's ops/pallas_q40.py
// (_q40_matmul_2d / _q40_matmul_stacked with _kernel_multi ->
// _matvec_body_multi, and the nb-major _q40_multi_nb_* tiling): each weight
// block is unpacked once and used for all T rows.
//
// Bound: the packed weight bytes at T = 2; from about T = 6 the 2*T flops
// per weight value on the f32 SIMT cores (67 TFLOP/s) take longer than the
// 0.5625 bytes per value (3.35 TB/s). Design, simple first:
//   * one warp per kRowsM = 4 output rows, kWarps rows-groups per block, so
//     a staged x slice serves 32 rows;
//   * x (T, n) is staged in slices of kChunk blocks (all T rows of a slice
//     in shared memory, each 32-value block padded to 36 floats as in K1):
//     8 x 344 blocks of 7B's w2 at T = 8 would be 396 KB, over the 227 KB a
//     block may hold;
//   * each lane takes one Q40 block of its 4 rows at a time: 4 16-byte code
//     loads, the nibbles widened once to (code - 8) * d16 (exact in f32),
//     then 8 values x T rows of FMAs per 32-bit word, with the x float4s
//     read once from shared memory for all 4 rows;
//   * T accumulators per row and lane in registers, warp-shuffle reduction.
constexpr int kRowsM = 4;   // output rows per warp
constexpr int kChunk = 64;  // 32-value blocks of x staged per slice

__device__ __forceinline__ uint32_t word_of(uint4 q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

template <int T>
__global__ void __launch_bounds__(kWarps * 32)
q40_matvec_multi_kernel(const uint4* __restrict__ qs,
                        const __half* __restrict__ d16,
                        const float* __restrict__ x, float* __restrict__ out,
                        int d, int nb) {
  extern __shared__ float xs[];  // T * kChunk * kBlockPad floats
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + warp) * kRowsM;
  const size_t n = static_cast<size_t>(nb) * 32;
  // rows past d read row d-1 (in bounds) and store nothing
  size_t rbase[kRowsM];
#pragma unroll
  for (int r = 0; r < kRowsM; ++r) {
    rbase[r] = static_cast<size_t>(min(row0 + r, d - 1)) * nb;
  }

  float acc[kRowsM][T];
#pragma unroll
  for (int r = 0; r < kRowsM; ++r) {
#pragma unroll
    for (int t = 0; t < T; ++t) acc[r][t] = 0.f;
  }

  for (int c0 = 0; c0 < nb; c0 += kChunk) {
    const int cb = min(kChunk, nb - c0);
    __syncthreads();  // the previous slice's readers are done
    const int per_t = cb * 8;  // float4s of one row of the slice
    for (int i = threadIdx.x; i < T * per_t; i += blockDim.x) {
      const int t = i / per_t;
      const int rem = i - t * per_t;
      const int b = rem >> 3;
      const int j4 = rem & 7;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          x + t * n + static_cast<size_t>(c0 + b) * 32) + j4);
      *reinterpret_cast<float4*>(xs + (t * kChunk + b) * kBlockPad +
                                 4 * j4) = v;
    }
    __syncthreads();

    for (int b = lane; b < cb; b += 32) {
      uint4 q[kRowsM];
      float s[kRowsM];
#pragma unroll
      for (int r = 0; r < kRowsM; ++r) {
        q[r] = __ldg(qs + rbase[r] + c0 + b);
        s[r] = __half2float(d16[rbase[r] + c0 + b]);
      }
      const float* xb = xs + b * kBlockPad;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float wl[kRowsM][4], wh[kRowsM][4];  // values 4w.., 16+4w..
#pragma unroll
        for (int r = 0; r < kRowsM; ++r) {
          const uint32_t word = word_of(q[r], w);
          const uint32_t lo = word & 0x0F0F0F0Fu;
          const uint32_t hi = (word >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            wl[r][k] = code_minus8(lo, 0x7440u + k) * s[r];
            wh[r][k] = code_minus8(hi, 0x7440u + k) * s[r];
          }
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float4* x4 =
              reinterpret_cast<const float4*>(xb + t * kChunk * kBlockPad);
          const float4 xl = x4[w];
          const float4 xh = x4[4 + w];
#pragma unroll
          for (int r = 0; r < kRowsM; ++r) {
            float a = acc[r][t];
            a = fmaf(wl[r][0], xl.x, a);
            a = fmaf(wl[r][1], xl.y, a);
            a = fmaf(wl[r][2], xl.z, a);
            a = fmaf(wl[r][3], xl.w, a);
            a = fmaf(wh[r][0], xh.x, a);
            a = fmaf(wh[r][1], xh.y, a);
            a = fmaf(wh[r][2], xh.z, a);
            a = fmaf(wh[r][3], xh.w, a);
            acc[r][t] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsM; ++r) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float v = acc[r][t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0 && row0 + r < d) {
        out[static_cast<size_t>(t) * d + row0 + r] = v;
      }
    }
  }
}

template <int T>
int launch_multi(const void* qs, const void* d16, const void* x, void* out,
                 int d, int nb, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(T) * kChunk * kBlockPad * sizeof(float);
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(q40_matvec_multi_kernel<T>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows_per_block = kWarps * kRowsM;
  const dim3 grid((d + rows_per_block - 1) / rows_per_block);
  q40_matvec_multi_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1m: x (t, nb*32) f32 -> out (t, d) f32 for t in 2..8. Launch on
// `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_matvec_multi(const void* qs, const void* d16,
                                const void* x, void* out, int t, int d,
                                int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 2: return launch_multi<2>(qs, d16, x, out, d, nb, s);
    case 3: return launch_multi<3>(qs, d16, x, out, d, nb, s);
    case 4: return launch_multi<4>(qs, d16, x, out, d, nb, s);
    case 5: return launch_multi<5>(qs, d16, x, out, d, nb, s);
    case 6: return launch_multi<6>(qs, d16, x, out, d, nb, s);
    case 7: return launch_multi<7>(qs, d16, x, out, d, nb, s);
    case 8: return launch_multi<8>(qs, d16, x, out, d, nb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1, T = 1. Launch on `stream`; returns the cudaGetLastError() code
// (0 = launched).
extern "C" int q40_matvec(const void* qs, const void* d16, const void* x,
                          void* out, int d, int nb, void* stream) {
  const size_t smem = static_cast<size_t>(nb) * kBlockPad * sizeof(float);
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(q40_matvec_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d + kWarps - 1) / kWarps);
  q40_matvec_kernel<<<grid, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}
