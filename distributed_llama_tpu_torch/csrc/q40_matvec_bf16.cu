// Q40 small-T product with bf16 operands on the tensor cores for Hopper
// (sm_90a), T = 2..8 tokens (K1d):
//
//   out[t, r] = sum_k f32(bf16(x[t, k]) * bf16((code[r, k] - 8) * s[r, k]))
//
// (s[r, k] = d16[r, k / 32] widened to f32): each weight rounded to bf16
// after its exact f32 product with the scale, x rounded to bf16, exact
// products, f32 accumulation — the function K3b and
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
// (d, nb); x f32 (T, nb*32); out f32 (T, d).
//
// Bound: the packed weight bytes (18 per 32 values) read once, as K1's
// (the 2*T flops per weight value ride the tensor cores). Design, simple
// first (warp-level mma.sync, no wgmma / TMA):
//   * mma.m16n8k16 with 16 weight rows as M and the T <= 8 tokens as N
//     (columns T..7 of B are zero), so M needs no padding;
//   * the sum over k may be taken in any order, so the k of each MMA is
//     permuted to fit the Q40 block: lane (g, c) of a quad owns Q40 block
//     4q + c of rows g and g + 8 and feeds, in eight k16 steps, its four
//     low-nibble values of word w (w = 0..3) and then its four high-nibble
//     values, as A-fragment k 2c, 2c+1, 2c+8, 2c+9. Weights go from
//     device memory straight to registers (one 16-byte load per block and
//     row), with no shared-memory tile;
//   * x is staged once per thread block as bf16 in shared memory (in
//     slices of up to 128 Q40 blocks), permuted so that lane (g, c) reads
//     the B fragment of token g for the same k in one 16-byte load per two
//     steps, with the four lanes of a quad on 64 contiguous bytes and the
//     token rows padded by 64 bytes, so a quarter-warp's loads fall on
//     distinct banks;
//   * 8 warps: 2 groups of 16 rows x 4 k-splits over the blocks of a
//     slice; the k-splits' partial sums are added in a fixed order through
//     shared memory at the end;
//   * ragged d and block counts are read clamped or as zero and not stored.
// Shared memory: T * (32 * min(nb, 128) + 32) bf16 for x (66 KB at T = 8
// and a 4096-wide input) and 4 KB for the k-split sums.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kRowGroups = 2;                 // 16-row MMA groups per block
constexpr int kSplits = 4;                    // k-splits per row group
constexpr int kWarps = kRowGroups * kSplits;  // 8 warps
constexpr int kRows = 16 * kRowGroups;        // weight rows per block
constexpr int kSliceBlocks = 128;             // Q40 blocks of x per slice
constexpr int kPad = 32;                      // bf16 pad per token row
constexpr int kMaxT = 8;

// The four weights of nibble set `nib` (4 nibbles, one per byte) times the
// scale, rounded to bf16: (a0, a2) of one row's A fragment.
__device__ __forceinline__ void dequant4(uint32_t nib, float s, uint32_t& lo,
                                         uint32_t& hi) {
  lo = pack_bf16(code_minus8(nib, 0x7440u) * s,
                 code_minus8(nib, 0x7441u) * s);
  hi = pack_bf16(code_minus8(nib, 0x7442u) * s,
                 code_minus8(nib, 0x7443u) * s);
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

// The eight k16 steps of one Q40 block per lane: rows g (codes0, s0) and
// g + 8 (codes1, s1) against token g's staged x of the same block (xb: the
// lane's first 16-byte chunk; chunk j lies 32 bf16 further per j).
__device__ __forceinline__ void block_mma(float (&acc)[4], uint4 codes0,
                                          float s0, uint4 codes1, float s1,
                                          const uint16_t* xb, bool has_x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // x values 8j..8j+7 of the block
    const uint4 xc = has_x ? *reinterpret_cast<const uint4*>(xb + 32 * j)
                           : make_uint4(0u, 0u, 0u, 0u);
    const int shift = 4 * (j >> 1);  // low nibbles for j < 2, then high
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = 2 * (j & 1) + half;  // values 16*(j>>1) + 4w .. +3
      uint32_t a[4];
      dequant4((word_of(codes0, w) >> shift) & 0x0F0F0F0Fu, s0, a[0], a[2]);
      dequant4((word_of(codes1, w) >> shift) & 0x0F0F0F0Fu, s1, a[1], a[3]);
      mma_bf16(acc, a, half ? xc.z : xc.x, half ? xc.w : xc.y);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
q40_matvec_bf16_kernel(const uint4* __restrict__ qs,
                       const __half* __restrict__ d16,
                       const float* __restrict__ x, float* __restrict__ out,
                       int t_len, int d, int nb, int slice_blocks) {
  // x: t_len * stride bf16, then the k-split sums (kWarps, 32, 4) f32
  extern __shared__ __align__(16) uint16_t xs[];
  const int stride = slice_blocks * 32 + kPad;
  float(*red)[32][4] =
      reinterpret_cast<float(*)[32][4]>(xs + t_len * stride);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp % kRowGroups;
  const int ks = warp / kRowGroups;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = blockIdx.x * kRows + rg * 16 + g;
  const int r1 = r0 + 8;
  const size_t base0 = static_cast<size_t>(min(r0, d - 1)) * nb;
  const size_t base1 = static_cast<size_t>(min(r1, d - 1)) * nb;
  const size_t n = static_cast<size_t>(nb) * 32;
  const bool has_x = g < t_len;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < nb; b0 += slice_blocks) {
    const int cb = min(slice_blocks, nb - b0);
    const int groups = (cb + 3) / 4;
    __syncthreads();  // the previous slice's readers are done
    // stage x[:, b0 .. b0+4*groups) as bf16: chunk j of block b of token
    // t at t*stride + (b/4)*128 + j*32 + (b%4)*8
    const int chunks = groups * 16;  // 16-byte chunks per token row
    for (int i = threadIdx.x; i < t_len * chunks; i += blockDim.x) {
      const int t = i / chunks;
      const int rem = i - t * chunks;
      const int blk = rem >> 2;
      const int j = rem & 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (blk < cb) {
        const float4* src = reinterpret_cast<const float4*>(
            x + t * n + static_cast<size_t>(b0 + blk) * 32 + 8 * j);
        const float4 a = __ldg(src);
        const float4 b = __ldg(src + 1);
        v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                       pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(xs + t * stride + (blk >> 2) * 128 +
                                j * 32 + (blk & 3) * 8) = v;
    }
    __syncthreads();

    const uint16_t* xrow = xs + g * stride + c * 8;
    // two groups per iteration, both loads issued before either product
    for (int q = ks; q < groups; q += 2 * kSplits) {
      const int qn = q + kSplits;
      const int blk_a = b0 + 4 * q + c;
      const int blk_b = b0 + 4 * qn + c;
      const bool va = 4 * q + c < cb;
      const bool vb = qn < groups && 4 * qn + c < cb;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 a0 = va ? __ldg(qs + base0 + blk_a) : zero;
      const uint4 a1 = va ? __ldg(qs + base1 + blk_a) : zero;
      const float sa0 = va ? __half2float(d16[base0 + blk_a]) : 0.f;
      const float sa1 = va ? __half2float(d16[base1 + blk_a]) : 0.f;
      const uint4 b0c = vb ? __ldg(qs + base0 + blk_b) : zero;
      const uint4 b1c = vb ? __ldg(qs + base1 + blk_b) : zero;
      const float sb0 = vb ? __half2float(d16[base0 + blk_b]) : 0.f;
      const float sb1 = vb ? __half2float(d16[base1 + blk_b]) : 0.f;
      block_mma(acc, a0, sa0, a1, sa1, xrow + q * 128, has_x);
      if (qn < groups) {
        block_mma(acc, b0c, sb0, b1c, sb1, xrow + qn * 128, has_x);
      }
    }
  }

  // add the k-splits in a fixed order: split 0 sums 1, 2, 3 into its own
  if (ks > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
  }
  __syncthreads();
  if (ks > 0) return;
#pragma unroll
  for (int k = 1; k < kSplits; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += red[k * kRowGroups + rg][lane][e];
  }
  // C fragment: (row g, tokens 2c, 2c+1) and (row g + 8, the same)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 2 * c + (e & 1);
    const int r = (e < 2) ? r0 : r1;
    if (t < t_len && r < d) out[static_cast<size_t>(t) * d + r] = acc[e];
  }
}

}  // namespace

// x (t, nb*32) f32 -> out (t, d) f32 for t in 1..8 (the port sends 2..8).
// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_matvec_bf16(const void* qs, const void* d16,
                               const void* x, void* out, int t, int d,
                               int nb, void* stream) {
  if (t < 1 || t > kMaxT || d < 1 || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slice_blocks = min(kSliceBlocks, (nb + 3) / 4 * 4);
  const size_t smem =
      static_cast<size_t>(t) * (slice_blocks * 32 + kPad) *
          sizeof(uint16_t) +
      kWarps * 32 * 4 * sizeof(float);
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(q40_matvec_bf16_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d + kRows - 1) / kRows);
  q40_matvec_bf16_kernel<<<grid, kWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), t, d, nb,
      slice_blocks);
  return static_cast<int>(cudaGetLastError());
}
