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
// its low nibble and value j+16 in its high nibble); d16 f16 (d, nb); x f32
// (T, nb*32); out f32 (T, d).
//
// Bound: 2*T*d*n flops at 989 TFLOP/s against 0.5625 bytes per weight
// value and 4 per x and out value at 3.35 TB/s. At T = 128 and 7B's
// 4096-wide layers the two are within 10% (operations a little above), and
// operations bound every larger chunk. Design, simple first
// (warp-level mma.sync, no wgmma / TMA):
//   * a block owns a (32*MI x 64) tile of out (MI = 1 for T <= 32, else 2)
//     and walks n in stages of two Q40 blocks (64 values = four k16 MMA
//     steps);
//   * each thread loads its share of the next stage (one 16-byte code
//     block and its f16 scale; MI*8 float4s of x) into registers while the
//     current stage is multiplied, then rounds it to bf16 into the other of
//     two shared tiles: one barrier per stage;
//   * 4 warps, 2 (tokens) x 2 (weight rows), each with a (16*MI x 32) tile
//     of f32 accumulators; fragments come from the shared tiles with
//     ldmatrix (rows padded to 72 bf16, so the eight 16-byte row reads of
//     an 8x8 matrix fall on distinct banks);
//   * ragged T, d and an odd block count are zero-filled in the tiles and
//     not stored.
// Shared memory: 36 KB at MI = 2, static.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps: 2 along T x 2 along d
constexpr int kBN = 64;         // weight rows (out columns) per block
constexpr int kBK = 64;         // values per stage: two Q40 blocks
constexpr int kLd = kBK + 8;    // padded row stride of the bf16 tiles

template <int MI>
struct Stage {
  static constexpr int kBM = 32 * MI;                      // tokens
  static constexpr int kXVec = kBM * kBK / 4 / kThreads;   // float4s
  uint4 codes;
  float scale;
  float4 x[kXVec];
};

// Thread tid loads the codes and scale of row tid / 2, block tid % 2 of
// the stage at Q40 block kb0, and its float4s of the x tile (16 per token
// row). Out-of-range parts load as zero codes with scale 0 and zero x.
template <int MI>
__device__ __forceinline__ void load_stage(
    Stage<MI>& st, const uint4* __restrict__ qs,
    const __half* __restrict__ d16, const float* __restrict__ x, int t_len,
    int d, int nb, int t0, int d0, int kb0) {
  const int tid = threadIdx.x;
  const int row = d0 + (tid >> 1);
  const int blk = kb0 + (tid & 1);
  if (row < d && blk < nb) {
    const size_t i = static_cast<size_t>(row) * nb + blk;
    st.codes = __ldg(qs + i);
    st.scale = __half2float(d16[i]);
  } else {
    st.codes = make_uint4(0u, 0u, 0u, 0u);
    st.scale = 0.f;
  }
  const size_t n = static_cast<size_t>(nb) * 32;
#pragma unroll
  for (int i = 0; i < Stage<MI>::kXVec; ++i) {
    const int idx = tid + kThreads * i;
    const int t = t0 + (idx >> 4);
    const size_t k = static_cast<size_t>(kb0) * 32 + 4 * (idx & 15);
    st.x[i] = t < t_len && k < n
                  ? __ldg(reinterpret_cast<const float4*>(x + t * n + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Round a loaded stage to bf16 into the shared tiles: the 32 weight values
// of the thread's block (value j and j+16 from byte j) and its x float4s.
template <int MI>
__device__ __forceinline__ void store_stage(const Stage<MI>& st,
                                            uint16_t* xs, uint16_t* ws) {
  const int tid = threadIdx.x;
  const uint32_t words[4] = {st.codes.x, st.codes.y, st.codes.z,
                             st.codes.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t l4 = words[w] & 0x0F0F0F0Fu;
    const uint32_t h4 = (words[w] >> 4) & 0x0F0F0F0Fu;
    const float s = st.scale;
    lo[2 * w] = pack_bf16(code_minus8(l4, 0x7440u) * s,
                          code_minus8(l4, 0x7441u) * s);
    lo[2 * w + 1] = pack_bf16(code_minus8(l4, 0x7442u) * s,
                              code_minus8(l4, 0x7443u) * s);
    hi[2 * w] = pack_bf16(code_minus8(h4, 0x7440u) * s,
                          code_minus8(h4, 0x7441u) * s);
    hi[2 * w + 1] = pack_bf16(code_minus8(h4, 0x7442u) * s,
                              code_minus8(h4, 0x7443u) * s);
  }
  uint4* dst =
      reinterpret_cast<uint4*>(ws + (tid >> 1) * kLd + 32 * (tid & 1));
  dst[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  dst[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  dst[2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  dst[3] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
#pragma unroll
  for (int i = 0; i < Stage<MI>::kXVec; ++i) {
    const int idx = tid + kThreads * i;
    const float4 v = st.x[i];
    *reinterpret_cast<uint2*>(xs + (idx >> 4) * kLd + 4 * (idx & 15)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

template <int MI>
__global__ void __launch_bounds__(kThreads)
q40_gemm_bf16_kernel(const uint4* __restrict__ qs,
                     const __half* __restrict__ d16,
                     const float* __restrict__ x, float* __restrict__ out,
                     int t_len, int d, int nb) {
  constexpr int kBM = Stage<MI>::kBM;
  // bf16 tiles, as raw 16-bit words (ldmatrix reads them)
  __shared__ __align__(16) uint16_t xs[2][kBM * kLd];
  __shared__ __align__(16) uint16_t ws[2][kBN * kLd];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 1;  // the warp's 16*MI token rows
  const int wn = warp & 1;   // its 32 weight rows
  const int d0 = blockIdx.x * kBN;
  const int t0 = blockIdx.y * kBM;

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const int n_stages = (nb + 1) / 2;
  Stage<MI> st;
  load_stage<MI>(st, qs, d16, x, t_len, d, nb, t0, d0, 0);
  store_stage<MI>(st, xs[0], ws[0]);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const bool more = s + 1 < n_stages;
    if (more) {  // in flight while the MMAs below run
      load_stage<MI>(st, qs, d16, x, t_len, d, nb, t0, d0, 2 * (s + 1));
    }
    const uint16_t* xt = xs[s & 1];
    const uint16_t* wt = ws[s & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ldmatrix_x4(a[i], xt + (wm * 16 * MI + i * 16 + (lane & 15)) * kLd +
                              kk * 16 + (lane >> 4) * 8);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, wt + (wn * 32 + p * 16 + (lane >> 4) * 8 +
                             (lane & 7)) * kLd +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
        }
      }
    }
    // the other tiles were last read before the previous barrier
    if (more) store_stage<MI>(st, xs[(s + 1) & 1], ws[(s + 1) & 1]);
    __syncthreads();
  }

  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int t = t0 + wm * 16 * MI + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = d0 + wn * 32 + j * 8 + 2 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t + (e >> 1) * 8;
        const int cc = col + (e & 1);
        if (tt < t_len && cc < d) {
          out[static_cast<size_t>(tt) * d + cc] = acc[i][j][e];
        }
      }
    }
  }
}

template <int MI>
int launch(const void* qs, const void* d16, const void* x, void* out,
           int t_len, int d, int nb, cudaStream_t stream) {
  const dim3 grid((d + kBN - 1) / kBN,
                  (t_len + Stage<MI>::kBM - 1) / Stage<MI>::kBM);
  q40_gemm_bf16_kernel<MI><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out), t_len, d, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (t, nb*32) f32 -> out (t, d) f32, any t >= 1 (the port sends t > 8).
// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
extern "C" int q40_gemm_bf16(const void* qs, const void* d16, const void* x,
                             void* out, int t, int d, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 0 || t > 65535 * 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t <= 32) return launch<1>(qs, d16, x, out, t, d, nb, s);
  return launch<2>(qs, d16, x, out, t, d, nb, s);
}
