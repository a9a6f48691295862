// B10, the Q40 layout probe's bodies for Hopper (sm_90a): T = 1 matvec
// variants over K1's weight layout. P0, P1 and P3 ask what bounds the
// classic row body (q40_row.cuh), which the fused decode-layer kernels
// share; P2 and P4 are K1 itself (q40_matvec.cuh matvec_body, the tensor-
// core skeleton) with one thing changed, so each prices that thing in K1.
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
// (x is at most 192 bytes per block and stays in L2).
//
// P0, P1 and P3 keep P0's access pattern, so each differs from P0 in one
// thing only: one warp per output row, kWarps rows per block, lanes
// striding over the row's blocks with one 16-byte code load and one f16
// scale per block, kUnroll blocks in flight per lane, f32 accumulation, a
// butterfly shuffle reduction.
//
//   P0 probe_classic: the classic T = 1 body (K1 before its tensor-core
//      redesign), x staged once per 8-row block in shared memory, padded
//      to kBlockPad floats a block, and q40_row_dot; the fused tail (K9)
//      gives its bits on the same wo and w2 rows.
//   P1 probe_stream: out[r] = sum_b f32(d16[r,b]) * f32(XOR_{j<16}
//      qs[r,b,j]). It reads no x and unpacks nothing: the rate at which
//      P0's pattern streams the layout, the ceiling for any body over it.
//   P3 probe_nomask: lo = q - 16 * hi, so (lo - 8) * xlo + (hi - 8) * xhi =
//      q * xlo + hi * (xhi - 16 * xlo) - 8 * (xlo + xhi): the whole byte is
//      widened (P0's byte permute without the - 8) with no low-nibble mask;
//      xhi16 = xhi - 16 * xlo and xsum = the block's sum of x come staged
//      with xlo in the 36 floats of each block (wrapper, once per call).
//
// P2 and P4 run K1's skeleton at K1's plan (ops/q40.matvec_plan): the
// cp.async ring all threads fill, ldmatrix of the codes, bf16 mma.sync on
// exact operands (code - 8 times x's three bf16 pieces), the per-block f32
// scale and the split-K ticket. They form the same products in the same
// MMA order, so both return K1's bits.
//
//   P2 probe_xglobal (the JAX _k_v0r: x pre-replicated, no broadcast in
//      the kernel): x arrives already split into its three bf16 pieces and
//      permuted into the B-fragment order K1 stages (nb * 192 bytes, made
//      once per call by the wrapper, nb_probe.lay_x), and each warp reads
//      its fragments from there (ld.global.nc, 16 bytes a lane; L1 and L2
//      hold them across a block's tiles). The block stages no x: shared
//      memory holds the ring, the sums and the flag, and no split3 runs.
//      P2 - K1 is what K1's staging and split of x cost. On the H100
//      (PERF.md) P2 is ~2% faster than K1 at 13B's w13 (128-row tiles)
//      and ~4% slower at wqkv (64-row tiles, twice the x reads a weight
//      byte, from L1 in place of shared memory).
//   P4 probe_signed (the JAX _k_i4: signed int4 planes, no - 8 term): the
//      codes stored as signed nibbles, code - 8 in 4-bit two's complement,
//      which is byte ^ 0x88 (the same bytes), through K1's ring unchanged
//      and widened to the same bf16 operands by SignedCodes below. x is
//      staged as K1 stages it. P4 - K1 is what the code unpack's form
//      costs: within 2% of K1 on the H100 (PERF.md).
//
// The widening of a signed nibble s (code - 8) to bf16. K1 puts an
// unsigned code c in the mantissa of bf16 128 (a byte permute: 0x4300 | c
// = 128 + c) and takes 136 away with one bf16x2 FMA a pair, so its - 8 is
// no instruction of its own: it rides in the - 136. The signed nibble
// needs the same offset binary before that trick, c = s ^ 8, and the XOR
// folds into the mask: (w & 0x0F0F0F0F) ^ 0x08080808 is one 3-input LOP3,
// as K1's w & 0x0F0F0F0F is one (and_xor: written in C++ the two became
// two LOP3s). So P4 counts K1's instructions a word: 2 LOP3, 1 shift, 4
// PRMT, 4 HFMA2.BF16 (chip_smoke.phase_sass counts them in both functions:
// 227 LOP3, 148 PRMT, 128 HFMA2.BF16 each). No exact form without the FMA
// was found:
// bf16(s) for s in -8..7 has a sign bit and an exponent that depends on
// |s|, which no byte permute of the nibble produces; the fp8 -> f16x2
// convert gives f16, which the bf16 MMA against x's bf16 pieces cannot
// take; a convert a value (I2F) costs 8 a word where the FMAs cost 4.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "q40_matvec.cuh"
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

// (a & b) ^ c as one 3-input LOP3 (truth table (0xF0 & 0xCC) ^ 0xAA). In
// C++ the compiler emits an AND and an XOR for it (291 LOP3 in P4's
// function against K1's 227): it keeps no register for the second mask.
static __device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                                   uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// P4's codes: signed nibbles s = code - 8 (byte ^ 0x88), widened to the
// bf16 pairs K1's unsigned codes give (the header says why this form):
// c = (s & 0xF) ^ 8 of each byte, then K1's permute and subtraction.
struct SignedCodes {
  static __device__ __forceinline__ void widen(uint32_t w, uint32_t (&lo)[2],
                                               uint32_t (&hi)[2]) {
    nibbles_bf16(and_xor(w, 0x0F0F0F0Fu, 0x08080808u), lo);
    nibbles_bf16(and_xor(w >> 4, 0x0F0F0F0Fu, 0x08080808u), hi);
  }
};

// P2 and P4: K1's kernel (q40_matvec.cu q40_matvec_kernel) with x laid out
// by the caller, and with signed codes.
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
probe_xglobal_kernel(const uint8_t* __restrict__ qs,
                     const uint8_t* __restrict__ d16,
                     const float* __restrict__ x, float* __restrict__ out,
                     float* __restrict__ part, int* __restrict__ tickets,
                     int d, int nb, int wr, int wk, int kb) {
  matvec_body<1, 3, true>(qs, d16, x, out, part, tickets, d, nb, wr, wk, kb);
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
probe_signed_kernel(const uint8_t* __restrict__ qs,
                    const uint8_t* __restrict__ d16,
                    const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int d, int nb, int wr, int wk, int kb) {
  matvec_body<1, 3, false, SignedCodes>(qs, d16, x, out, part, tickets, d,
                                        nb, wr, wk, kb);
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

// P2: xlaid = x (nb * 32) f32 as nb_probe.lay_x lays it out: (nb, 3, 4,
// 8) bf16, chunk ((b * 3 + p) * 4 + c) = piece p of values 4c..4c+3 and
// 16+4c..16+4c+3 of block b -> out (d) f32. The plan, part and tickets are
// K1's (q40_matvec.cu q40_matvec).
extern "C" int probe_xglobal(const void* qs, const void* d16,
                             const void* xlaid, void* out, void* part,
                             void* tickets, int d, int nb, int wr, int wk,
                             int grid_x, int splits, int kb, void* stream) {
  static size_t granted[kMaxDevices];
  return launch_matvec<1, 3, true>(probe_xglobal_kernel, qs, d16, xlaid, out,
                                   part, tickets, d, nb, wr, wk, grid_x,
                                   splits, kb,
                                   static_cast<cudaStream_t>(stream), granted);
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

// P4: qs holds the signed codes (byte ^ 0x88); x (nb * 32) f32 -> out
// (d) f32, at K1's plan, part and tickets.
extern "C" int probe_signed(const void* qs, const void* d16, const void* x,
                            void* out, void* part, void* tickets, int d,
                            int nb, int wr, int wk, int grid_x, int splits,
                            int kb, void* stream) {
  static size_t granted[kMaxDevices];
  return launch_matvec<1, 3>(probe_signed_kernel, qs, d16, x, out, part,
                             tickets, d, nb, wr, wk, grid_x, splits, kb,
                             static_cast<cudaStream_t>(stream), granted);
}
