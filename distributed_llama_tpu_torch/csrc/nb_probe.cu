// B10, the Q40 layout probe's bodies for Hopper (sm_90a): T = 1 matvec
// variants over K1's weight layout, each asking what bounds the classic
// row body (q40_row.cuh), which the fused decode-layer kernels share.
//
// Replaces the bodies of the JAX package's tools/nb_probe.py:
// _call_classic with _k_v0 (P0), _k_dma (P1), _k_v0r (P2) and _k_v1 (P3),
// and _call_i4 with _k_i4 (P4). Its v0_128 names a 128-lane row tile, a
// constraint of the TPU's compiler with no meaning on this card, and runs
// P0 too. The production K1 (q40_matvec.cu, tensor cores) is timed beside
// them by tools/nb_probe.py.
//
// Layout: K1's, qs uint8 (d, nb, 16) (byte j of a block: value j in the
// low nibble, value j + 16 in the high one), d16 f16 (d, nb). A layer of a
// stacked weight is a pointer offset.
//
// Bound: the packed weight bytes, 18 * d * nb, read once from device memory
// (the x inputs are at most 144 bytes per block row and stay in L2). Every
// body keeps P0's access pattern, so each differs from P0 in one thing only:
// one warp per output row, kWarps rows per block, lanes striding over the
// row's blocks with one 16-byte code load and one f16 scale per block,
// kUnroll blocks in flight per lane, f32 accumulation, a butterfly shuffle
// reduction.
//
//   P0 probe_classic: the classic T = 1 body (K1 before its tensor-core
//      redesign), x staged once per 8-row block in shared memory, padded
//      to kBlockPad floats a block, and q40_row_dot; the fused tail (K9)
//      gives its bits on the same wo and w2 rows.
//   P1 probe_stream: out[r] = sum_b f32(d16[r,b]) * f32(XOR_{j<16}
//      qs[r,b,j]). It reads no x and unpacks nothing: the rate at which
//      P0's pattern streams the layout, the ceiling for any body over it.
//   P2 probe_xglobal: P0's row body with x read from a global copy padded
//      to kBlockPad floats per block (made once per call by the wrapper):
//      no staging of x in shared memory and no __syncthreads, so P2 - P0 is
//      what P0's per-block restaging of x costs.
//   P3 probe_nomask: lo = q - 16 * hi, so (lo - 8) * xlo + (hi - 8) * xhi =
//      q * xlo + hi * (xhi - 16 * xlo) - 8 * (xlo + xhi): the whole byte is
//      widened (P0's byte permute without the - 8) with no low-nibble mask;
//      xhi16 = xhi - 16 * xlo and xsum = the block's sum of x come staged
//      with xlo in the 36 floats of each block (wrapper, once per call).
//   P4 probe_signed: the codes stored as signed nibbles, code - 8 in 4-bit
//      two's complement, which is byte ^ 0x88 (the same bytes), widened by
//      sign extension (shift left, arithmetic shift right, one convert):
//      no - 8 term and no xsum.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "q40_row.cuh"

namespace {

constexpr int kWarps = 8;  // output rows per thread block

// sum_b d16[b] * dot(q_b, b) over the row's blocks, P0's loop
// (q40_row.cuh) with the block body as a functor; every lane gets the sum.
template <typename Dot>
__device__ __forceinline__ float row_sum(const uint4* __restrict__ qrow,
                                         const __half* __restrict__ drow,
                                         int nb, int lane, const Dot& dot) {
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
      acc = fmaf(s[u], dot(q[u], b + 32 * u), acc);
    }
  }
  for (; b < nb; b += 32) {
    acc = fmaf(__half2float(drow[b]), dot(__ldg(qrow + b), b), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// A byte of `bytes` (sel as in code_minus8) as a float, 0..255, exact.
__device__ __forceinline__ float byte_value(uint32_t bytes, uint32_t sel) {
  return __int_as_float(__byte_perm(bytes, 0x4B000000u, sel)) - 8388608.0f;
}

// Bits [lo_bit, lo_bit + 4) of w as a signed 4-bit value.
template <int kLoBit>
__device__ __forceinline__ float nibble_signed(uint32_t w) {
  return __int2float_rn(static_cast<int32_t>(w << (28 - kLoBit)) >> 28);
}

struct XorDot {  // P1: the block's 16 code bytes folded by XOR
  __device__ float operator()(uint4 q, int) const {
    uint32_t w = q.x ^ q.y ^ q.z ^ q.w;
    w ^= w >> 16;
    w ^= w >> 8;
    return __uint2float_rn(w & 0xFFu);
  }
};

struct NoMaskDot {  // P3; xs: per block xlo[16], xhi16[16], xsum, 3 pad
  const float* xs;
  __device__ float operator()(uint4 q, int b) const {
    const float* xb = xs + b * kBlockPad;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t hi = (words[w] >> 4) & 0x0F0F0F0Fu;
      const float4 xl = x4[w];
      const float4 xh = x4[4 + w];
      s = fmaf(byte_value(words[w], 0x7440u), xl.x, s);
      s = fmaf(byte_value(words[w], 0x7441u), xl.y, s);
      s = fmaf(byte_value(words[w], 0x7442u), xl.z, s);
      s = fmaf(byte_value(words[w], 0x7443u), xl.w, s);
      s = fmaf(byte_value(hi, 0x7440u), xh.x, s);
      s = fmaf(byte_value(hi, 0x7441u), xh.y, s);
      s = fmaf(byte_value(hi, 0x7442u), xh.z, s);
      s = fmaf(byte_value(hi, 0x7443u), xh.w, s);
    }
    return fmaf(-8.f, xb[32], s);
  }
};

struct SignedDot {  // P4; xs: P0's staged x (36 floats per block)
  const float* xs;
  __device__ float operator()(uint4 q, int b) const {
    const float4* x4 = reinterpret_cast<const float4*>(xs + b * kBlockPad);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t v = words[w];
      const float4 xl = x4[w];
      const float4 xh = x4[4 + w];
      s = fmaf(nibble_signed<0>(v), xl.x, s);
      s = fmaf(nibble_signed<8>(v), xl.y, s);
      s = fmaf(nibble_signed<16>(v), xl.z, s);
      s = fmaf(nibble_signed<24>(v), xl.w, s);
      s = fmaf(nibble_signed<4>(v), xh.x, s);
      s = fmaf(nibble_signed<12>(v), xh.y, s);
      s = fmaf(nibble_signed<20>(v), xh.z, s);
      s = fmaf(nibble_signed<28>(v), xh.w, s);
    }
    return s;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
probe_classic_kernel(const uint4* __restrict__ qs,
                     const __half* __restrict__ d16,
                     const float* __restrict__ x, float* __restrict__ out,
                     int d, int nb) {
  extern __shared__ float xs[];  // nb * kBlockPad floats
  for (int i = threadIdx.x; i < nb * 32; i += blockDim.x) {
    xs[(i >> 5) * kBlockPad + (i & 31)] = x[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= d) return;
  const float acc = q40_row_dot(qs + static_cast<size_t>(row) * nb,
                                d16 + static_cast<size_t>(row) * nb, xs, nb,
                                lane);
  if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kWarps * 32)
probe_stream_kernel(const uint4* __restrict__ qs,
                    const __half* __restrict__ d16, float* __restrict__ out,
                    int d, int nb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= d) return;
  const float acc = row_sum(qs + static_cast<size_t>(row) * nb,
                            d16 + static_cast<size_t>(row) * nb, nb, lane,
                            XorDot{});
  if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kWarps * 32)
probe_xglobal_kernel(const uint4* __restrict__ qs,
                     const __half* __restrict__ d16,
                     const float* __restrict__ xpad, float* __restrict__ out,
                     int d, int nb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= d) return;
  const float acc = q40_row_dot(qs + static_cast<size_t>(row) * nb,
                                d16 + static_cast<size_t>(row) * nb, xpad,
                                nb, lane);
  if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kWarps * 32)
probe_nomask_kernel(const uint4* __restrict__ qs,
                    const __half* __restrict__ d16,
                    const float4* __restrict__ xprep,
                    float* __restrict__ out, int d, int nb) {
  extern __shared__ float4 xs4[];  // nb * kBlockPad floats, as given
  for (int i = threadIdx.x; i < nb * (kBlockPad / 4); i += blockDim.x) {
    xs4[i] = __ldg(xprep + i);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= d) return;
  const float acc = row_sum(qs + static_cast<size_t>(row) * nb,
                            d16 + static_cast<size_t>(row) * nb, nb, lane,
                            NoMaskDot{reinterpret_cast<const float*>(xs4)});
  if (lane == 0) out[row] = acc;
}

__global__ void __launch_bounds__(kWarps * 32)
probe_signed_kernel(const uint4* __restrict__ qs,
                    const __half* __restrict__ d16,
                    const float* __restrict__ x, float* __restrict__ out,
                    int d, int nb) {
  extern __shared__ float xs[];  // nb * kBlockPad floats, P0's staging
  for (int i = threadIdx.x; i < nb * 32; i += blockDim.x) {
    xs[(i >> 5) * kBlockPad + (i & 31)] = x[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= d) return;
  const float acc = row_sum(qs + static_cast<size_t>(row) * nb,
                            d16 + static_cast<size_t>(row) * nb, nb, lane,
                            SignedDot{xs});
  if (lane == 0) out[row] = acc;
}

dim3 grid_of(int d) { return dim3((d + kWarps - 1) / kWarps); }

size_t staged_bytes(int nb) {
  return static_cast<size_t>(nb) * kBlockPad * sizeof(float);
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaGetLastError()
// code (0 = launched).

// P0: x (nb * 32) f32 -> out (d) f32.
extern "C" int probe_classic(const void* qs, const void* d16, const void* x,
                             void* out, int d, int nb, void* stream) {
  static size_t granted[kMaxDevices];
  const size_t smem = staged_bytes(nb);
  const cudaError_t e = opt_in_smem(probe_classic_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_classic_kernel<<<grid_of(d), kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}

// P1: qs, d16 -> out (d) f32.
extern "C" int probe_stream(const void* qs, const void* d16, void* out,
                            int d, int nb, void* stream) {
  probe_stream_kernel<<<grid_of(d), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}

// P2: xpad (nb, kBlockPad) f32, x padded per block -> out (d) f32.
extern "C" int probe_xglobal(const void* qs, const void* d16,
                             const void* xpad, void* out, int d, int nb,
                             void* stream) {
  probe_xglobal_kernel<<<grid_of(d), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(xpad), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}

// P3: xprep (nb, kBlockPad) f32 = per block xlo, xhi16, xsum, 0, 0, 0.
extern "C" int probe_nomask(const void* qs, const void* d16,
                            const void* xprep, void* out, int d, int nb,
                            void* stream) {
  static size_t granted[kMaxDevices];
  const size_t smem = staged_bytes(nb);
  const cudaError_t e = opt_in_smem(probe_nomask_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_nomask_kernel<<<grid_of(d), kWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float4*>(xprep), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}

// P4: qs holds the signed codes (byte ^ 0x88); x (nb * 32) f32.
extern "C" int probe_signed(const void* qs, const void* d16, const void* x,
                            void* out, int d, int nb, void* stream) {
  static size_t granted[kMaxDevices];
  const size_t smem = staged_bytes(nb);
  const cudaError_t e = opt_in_smem(probe_signed_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_signed_kernel<<<grid_of(d), kWarps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), d, nb);
  return static_cast<int>(cudaGetLastError());
}
