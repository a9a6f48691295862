// Flash-decode attention for Hopper (sm_90a): one query token against the
// live prefix 0..pos of one layer of the stacked KV cache, f32 or bf16 —
// K2 for one sequence, K5 for B sequences at once.
//
//   K2: q (n_kv * kv_mul, hs) f32; k_all, v_all (L, S, n_kv, hs) f32 or
//   bf16; out (n_kv * kv_mul * hs) f32; `layer` and `pos` are ints.
//   K5: q (B, n_kv * kv_mul, hs); k_all, v_all (L * B, S, n_kv, hs), row
//   layer * B + b holding sequence b's keys of layer `layer`; `pos` a
//   device (B,) int32, row b attending keys 0..pos[b]; out (B, n_q * hs).
//   Query head h = g * kv_mul + m attends kv head g; scores are scaled by
//   1/sqrt(hs); softmax over the live keys.
//
// Replaces the JAX package's ops/pallas_attention.py decode_attention (K2:
// _kernel / _flash_over_row) and decode_attention_batch (K5: _kernel_batch,
// the same flash walk per row with per-row clocks): the same online softmax
// with running (m, l, o), reading only the live prefix. K5 reads its
// positions from device memory, so a step captured in a CUDA graph sees
// each replay's clocks (an int argument would be frozen at capture). A bf16
// cache (the JAX kernels' scratch in the cache dtype, --kv-cache-dtype
// bf16) is widened to f32 exactly as it is loaded, and all math stays f32.
//
// Bound: the K and V bytes of each row's live prefix, 2 * (pos+1) * n_kv *
// hs * 4 (2 per value for a bf16 cache), read once. Design, simple first:
// one thread block per (kv head, row), covering its kv_mul query heads, so
// K and V are read once: n_kv blocks for K2 (32 at 7B on 132 SMs), n_kv * B
// for K5 (256 at 7B and B = 8); each block runs the flash-decode body of
// flash_decode.cuh (warps striding over keys, float4 lanes, a fixed-order
// combine), which K6 and K7 (paged_attention.cu) share. K2 and K5 are one
// template: at B = 1 on an (L, S, n_kv, hs) cache K5 computes exactly K2's
// sums in K2's order, so a step through either gives the same bits.
// Splitting the keys across blocks (flash-decoding) is left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_decode.cuh"

namespace {

// Keys of one (cache row, kv head): key t at k + t * row.
template <typename KV>
struct ContigKeys {
  const KV* k;
  const KV* v;
  size_t row;  // n_kv * hs: the stride between keys
  __device__ __forceinline__ size_t at(int t) const {
    return static_cast<size_t>(t) * row;
  }
  __device__ __forceinline__ float4 k4(size_t at, int lane) const {
    return load_f4(k + at + 4 * lane);
  }
  __device__ __forceinline__ float4 v4(size_t at, int lane) const {
    return load_f4(v + at + 4 * lane);
  }
};

template <typename KV, int KV_MUL, bool BATCH>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const float* __restrict__ q,
                        const KV* __restrict__ k_all,
                        const KV* __restrict__ v_all,
                        float* __restrict__ out, int layer, int pos_arg,
                        const int* __restrict__ pos_vec, int batch, int S,
                        int n_kv, int hs, float scale) {
  const int g = blockIdx.x;
  // K5: block row b reads cache row layer * batch + b at its own clock
  const int b = BATCH ? blockIdx.y : 0;
  const int pos = BATCH ? pos_vec[b] : pos_arg;
  const int cache_row = BATCH ? layer * batch + b : layer;
  const size_t row = static_cast<size_t>(n_kv) * hs;
  const size_t base =
      (static_cast<size_t>(cache_row) * S * n_kv + g) * hs;
  const ContigKeys<KV> keys{k_all + base, v_all + base, row};
  const size_t qo = (static_cast<size_t>(b) * n_kv + g) * KV_MUL * hs;
  flash_decode_block<KV_MUL>(q + qo, out + qo, pos, hs, scale, keys);
}

template <typename KV, int KV_MUL, bool BATCH>
int launch(const float* q, const KV* k, const KV* v, float* out, int layer,
           int pos, const int* pos_vec, int batch, int S, int n_kv, int hs,
           float scale, cudaStream_t stream) {
  const size_t smem = flash_decode_smem<KV_MUL>(hs);
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(
      decode_attention_kernel<KV, KV_MUL, BATCH>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_attention_kernel<KV, KV_MUL, BATCH>
      <<<dim3(n_kv, batch), kWarps * 32, smem, stream>>>(
          q, k, v, out, layer, pos, pos_vec, batch, S, n_kv, hs, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, bool BATCH>
int dispatch(const void* q, const void* k_all, const void* v_all, void* out,
             int layer, int pos, const void* pos_vec, int batch, int S,
             int n_kv, int kv_mul, int hs, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const KV* kc = static_cast<const KV*>(k_all);
  const KV* vc = static_cast<const KV*>(v_all);
  const int* pv = static_cast<const int*>(pos_vec);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs % 4 != 0 || hs > 128 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kv_mul) {
    case 1:
      return launch<KV, 1, BATCH>(qf, kc, vc, of, layer, pos, pv, batch, S,
                                  n_kv, hs, scale, s);
    case 2:
      return launch<KV, 2, BATCH>(qf, kc, vc, of, layer, pos, pv, batch, S,
                                  n_kv, hs, scale, s);
    case 4:
      return launch<KV, 4, BATCH>(qf, kc, vc, of, layer, pos, pv, batch, S,
                                  n_kv, hs, scale, s);
    case 8:
      return launch<KV, 8, BATCH>(qf, kc, vc, of, layer, pos, pv, batch, S,
                                  n_kv, hs, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// Takes kv_mul in {1, 2, 4, 8} and hs a multiple of 4 up to 128.
// K2 over an f32 cache:
extern "C" int decode_attention(const void* q, const void* k_all,
                                const void* v_all, void* out, int layer,
                                int pos, int S, int n_kv, int kv_mul, int hs,
                                float scale, void* stream) {
  return dispatch<float, false>(q, k_all, v_all, out, layer, pos, nullptr, 1,
                                S, n_kv, kv_mul, hs, scale, stream);
}

// K2 over a bf16 cache:
extern "C" int decode_attention_kvbf16(const void* q, const void* k_all,
                                       const void* v_all, void* out,
                                       int layer, int pos, int S, int n_kv,
                                       int kv_mul, int hs, float scale,
                                       void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k_all, v_all, out, layer, pos,
                                        nullptr, 1, S, n_kv, kv_mul, hs,
                                        scale, stream);
}

// K5 over an f32 cache: `pos` is a device (batch,) int32 vector.
extern "C" int decode_attention_batch(const void* q, const void* k_all,
                                      const void* v_all, void* out,
                                      int layer, const void* pos, int batch,
                                      int S, int n_kv, int kv_mul, int hs,
                                      float scale, void* stream) {
  return dispatch<float, true>(q, k_all, v_all, out, layer, 0, pos, batch,
                               S, n_kv, kv_mul, hs, scale, stream);
}

// K5 over a bf16 cache:
extern "C" int decode_attention_batch_kvbf16(const void* q,
                                             const void* k_all,
                                             const void* v_all, void* out,
                                             int layer, const void* pos,
                                             int batch, int S, int n_kv,
                                             int kv_mul, int hs, float scale,
                                             void* stream) {
  return dispatch<__nv_bfloat16, true>(q, k_all, v_all, out, layer, 0, pos,
                                       batch, S, n_kv, kv_mul, hs, scale,
                                       stream);
}
