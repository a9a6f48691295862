// Causal flash-prefill attention with bf16 tensor-core dots for Hopper
// (sm_90a), K4b: T query tokens at positions pos..pos+T-1 against the live
// prefix of one layer of the stacked KV cache (f32 or bf16; the chunk's own
// keys are already written there).
//
//   q (T, n_kv * kv_mul, hs) f32; k_all, v_all (L, S, n_kv, hs);
//   out (T, n_kv * kv_mul * hs) f32. Query row i sees keys 0..pos+i;
//   query head h attends kv head h / kv_mul.
//
// Numerics of the JAX package's ops/pallas_attention.py prefill_attention
// with bf16=True (_prefill_kernel, which it replaces there):
//   s = f32dot(bf16(q), bf16(k)) * scale   (the scale after the dot)
//   p = exp(s - m_new) in f32; l sums the unrounded p;
//   o = o * corr + f32dot(bf16(p), bf16(v)).
// The running max m is taken over tiles of 64 keys, so p is rounded to
// bf16 against the max of the keys walked so far, as the JAX kernel rounds
// it against the max of its walked KV blocks.
//
// Bound: at 7B and T = 128 the bytes of the live K/V prefix (read once)
// against 4 * n_heads * hs * sum(live keys) flops at 989 TFLOP/s: bytes
// at every position. Design, FlashAttention-2 style with warp-level
// mma.sync (simple first: no wgmma, no cp.async pipeline):
//   * a block owns one kv head and 64 (row, head) items of its group
//     (item = row * kv_mul + head): the items are the MMA's M dimension, so
//     each staged K/V tile serves every query head of the group, and the
//     prefix is read ceil(T * kv_mul / 64) times per kv head;
//   * 4 warps, 16 items each; a warp keeps its q fragments (bf16) in
//     registers for the whole walk, and its o accumulators (16 x hs f32)
//     and its rows' m and partial l in registers;
//   * per tile of 64 keys, staged in shared memory as bf16 (an f32 cache
//     rounded on the way in): S = q k^T as m16n8k16 MMAs, the causal mask
//     and scale in registers, the online softmax with quad shuffles, and
//     the S accumulators repacked as bf16 A fragments for o += p v, whose
//     B fragments come from the V tile through ldmatrix.trans;
//   * the block walks keys only up to its deepest row's position: keys
//     past pos+T-1 are never read.
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 16 up to 128, any T >= 1.
// Shared memory: 51 KB at hs 128 (opt-in above 48 KB made on every launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kItems = 16 * kWarps;  // (row, head) items per block
constexpr int kKeys = 64;            // keys per staged tile
constexpr int kMaxHs = 128;

__host__ __device__ __forceinline__ int tile_ld(int hs) {
  return hs + 8;  // bf16 row stride: 8 rows of an 8x8 read hit 8 bank quads
}

template <typename KV, int KV_MUL>
__global__ void __launch_bounds__(kWarps * 32)
prefill_attention_bf16_kernel(const float* __restrict__ q,
                              const KV* __restrict__ k_all,
                              const KV* __restrict__ v_all,
                              float* __restrict__ out, int layer, int pos,
                              int t_len, int S, int n_kv, int hs,
                              float scale) {
  extern __shared__ uint4 sm16[];
  const int ld = tile_ld(hs);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(sm16);
  __nv_bfloat16* k_s = q_s + kItems * ld;
  __nv_bfloat16* v_s = k_s + kKeys * ld;

  const int g = blockIdx.x;
  const int item0 = blockIdx.y * kItems;
  const int n_items = t_len * KV_MUL;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hs8 = hs / 8;
  const int hs16 = hs / 16;
  const int n_q = n_kv * KV_MUL;

  // q rows of the block's items, rounded to bf16; items past T*kv_mul
  // are zeros (computed, never stored)
  for (int i = threadIdx.x; i < kItems * hs8; i += blockDim.x) {
    const int it = i / hs8;
    const int c8 = i - it * hs8;
    const int item = item0 + it;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (item < n_items) {
      const int r = item / KV_MUL;
      const int h = item - r * KV_MUL;
      v = load_bf16x8(q + (static_cast<size_t>(r) * n_q + g * KV_MUL + h) *
                              hs + 8 * c8);
    }
    *reinterpret_cast<uint4*>(q_s + it * ld + 8 * c8) = v;
  }
  __syncthreads();
  uint32_t qf[kMaxHs / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxHs / 16; ++ks) {
    if (ks < hs16) {
      ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * ld + ks * 16 +
                              (lane >> 4) * 8);
    }
  }

  // this thread's two accumulator rows: items a (row g) and b (row g + 8)
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int item_a = item0 + warp * 16 + gq;
  const int item_b = item_a + 8;
  const int lim_a = pos + min(item_a / KV_MUL, t_len - 1);
  const int lim_b = pos + min(item_b / KV_MUL, t_len - 1);
  const int kmax = pos + min((item0 + kItems - 1) / KV_MUL, t_len - 1);

  float o[kMaxHs / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxHs / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  const size_t key_row = static_cast<size_t>(n_kv) * hs;
  const size_t base = (static_cast<size_t>(layer) * S * n_kv + g) * hs;
  for (int k0 = 0; k0 <= kmax; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kKeys * hs8; i += blockDim.x) {
      const int j = i / hs8;
      const int c8 = i - j * hs8;
      const int key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key <= kmax) {
        const size_t off = base + key * key_row + 8 * c8;
        kv = load_bf16x8(k_all + off);
        vv = load_bf16x8(v_all + off);
      }
      *reinterpret_cast<uint4*>(k_s + j * ld + 8 * c8) = kv;
      *reinterpret_cast<uint4*>(v_s + j * ld + 8 * c8) = vv;
    }
    __syncthreads();

    // s = q k^T over the tile: 8 n8 tiles of keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kMaxHs / 16; ++ks) {
      if (ks < hs16) {
#pragma unroll
        for (int p = 0; p < kKeys / 16; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, k_s + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * ld +
                             ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * p], qf[ks], r[0], r[1]);
          mma_bf16(s[2 * p + 1], qf[ks], r[2], r[3]);
        }
      }
    }

    // scale after the dot, causal mask, online softmax (rows a and b; the
    // four lanes of a quad hold a row's 64 keys of the tile between them)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int key = k0 + j * 8 + 2 * cq;
      s[j][0] = key <= lim_a ? s[j][0] * scale : -INFINITY;
      s[j][1] = key + 1 <= lim_a ? s[j][1] * scale : -INFINITY;
      s[j][2] = key <= lim_b ? s[j][2] * scale : -INFINITY;
      s[j][3] = key + 1 <= lim_b ? s[j][3] * scale : -INFINITY;
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // key 0 is visible to every row, so m is finite from the first tile on
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a);  // 0 on the first tile
    const float corr_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn_a);  // 0 for a masked key
      s[j][1] = expf(s[j][1] - mn_a);
      s[j][2] = expf(s[j][2] - mn_b);
      s[j][3] = expf(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * corr_a + sum_a;  // the unrounded p
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int j = 0; j < kMaxHs / 8; ++j) {
      o[j][0] *= corr_a;
      o[j][1] *= corr_a;
      o[j][2] *= corr_b;
      o[j][3] *= corr_b;
    }

    // o += bf16(p) v: the s accumulators of keys 16kt..16kt+15 are the A
    // fragment of k-step kt
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                              pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dj = 0; dj < kMaxHs / 16; ++dj) {
        if (dj < hs16) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, v_s + (kt * 16 + ((lane >> 3) & 1) * 8 +
                                      (lane & 7)) * ld +
                                   dj * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dj], pa, r[0], r[1]);
          mma_bf16(o[2 * dj + 1], pa, r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const size_t tok = static_cast<size_t>(n_q) * hs;  // q / out row
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {  // rows g and g + 8
    const int item = hb ? item_b : item_a;
    if (item >= n_items) continue;
    const float inv_l = 1.f / (hb ? l_b : l_a);
    const int r = item / KV_MUL;
    const int h = item - r * KV_MUL;
    float* dst = out + r * tok + static_cast<size_t>(g * KV_MUL + h) * hs +
                 2 * cq;
#pragma unroll
    for (int j = 0; j < kMaxHs / 8; ++j) {
      if (j < hs8) {
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(o[j][2 * hb] * inv_l, o[j][2 * hb + 1] * inv_l);
      }
    }
  }
}

template <typename KV, int KV_MUL>
int launch(const float* q, const KV* k, const KV* v, float* out, int layer,
           int pos, int t_len, int S, int n_kv, int hs, float scale,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kItems + 2 * kKeys) *
                      tile_ld(hs) * sizeof(__nv_bfloat16);
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(prefill_attention_bf16_kernel<KV, KV_MUL>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_kv, (t_len * KV_MUL + kItems - 1) / kItems);
  prefill_attention_bf16_kernel<KV, KV_MUL>
      <<<grid, kWarps * 32, smem, stream>>>(q, k, v, out, layer, pos, t_len,
                                            S, n_kv, hs, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch(const void* q, const void* k_all, const void* v_all, void* out,
             int layer, int pos, int t_len, int S, int n_kv, int kv_mul,
             int hs, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const KV* kc = static_cast<const KV*>(k_all);
  const KV* vc = static_cast<const KV*>(v_all);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs % 16 != 0 || hs <= 0 || hs > kMaxHs || t_len < 1 || pos < 0 ||
      pos + t_len > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kv_mul) {
    case 1:
      return launch<KV, 1>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                           scale, s);
    case 2:
      return launch<KV, 2>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                           scale, s);
    case 4:
      return launch<KV, 4>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                           scale, s);
    case 8:
      return launch<KV, 8>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                           scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// An f32 cache:
extern "C" int prefill_attention_bf16(const void* q, const void* k_all,
                                      const void* v_all, void* out,
                                      int layer, int pos, int t_len, int S,
                                      int n_kv, int kv_mul, int hs,
                                      float scale, void* stream) {
  return dispatch<float>(q, k_all, v_all, out, layer, pos, t_len, S, n_kv,
                         kv_mul, hs, scale, stream);
}

// A bf16 cache:
extern "C" int prefill_attention_bf16_kvbf16(const void* q, const void* k_all,
                                             const void* v_all, void* out,
                                             int layer, int pos, int t_len,
                                             int S, int n_kv, int kv_mul,
                                             int hs, float scale,
                                             void* stream) {
  return dispatch<__nv_bfloat16>(q, k_all, v_all, out, layer, pos, t_len, S,
                                 n_kv, kv_mul, hs, scale, stream);
}
