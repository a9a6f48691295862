// Causal flash-prefill attention for Hopper (sm_90a), K4: T query tokens at
// positions pos..pos+T-1 against the live prefix of one layer of the stacked
// KV cache, f32 or bf16 (the chunk's own keys are already written there).
//
//   q (T, n_kv * kv_mul, hs) f32; k_all, v_all (L, S, n_kv, hs) f32 or bf16;
//   out (T, n_kv * kv_mul * hs) f32. Query row i (position pos + i) sees
//   keys 0..pos+i; query head h attends kv head h / kv_mul; scores scaled by
//   1/sqrt(hs); softmax online in f32 (running m, l, o).
//
// Replaces the JAX package's ops/pallas_attention.py prefill_attention
// (_prefill_kernel), in its f32 parity mode. Keys past pos+T-1 are never
// read, as the JAX kernel clamps its walk with n_blk. `pos` and `layer` are
// kernel arguments, so a call needs no device-to-host sync. A bf16 cache
// (--kv-cache-dtype bf16) is widened to f32 exactly as a tile is staged
// (an 8-byte load of 4 values where an f32 cache takes a 16-byte one);
// all math stays f32.
//
// Bound: at 7B and T = 128 the bytes (K and V of the live prefix, read once)
// set it for an early chunk; from a few hundred keys on, the
// 4 * n_heads * hs * sum(live keys) flops do. Design, simple first:
//   * a block owns one kv head g and a tile of query rows, with all kv_mul
//     query heads of the group, so each K and V tile is read from device
//     memory once per block and serves every (row, head) item of it; each
//     block walks the live prefix itself, so the prefix is read
//     ceil(T / rows) times per kv head (16 rows at kv_mul 1, 4 at 8:
//     more rows per block leave SMs idle and measured slower);
//   * 8 warps, each owning IPW items; their queries are staged in shared
//     memory, their (o, m, l) live in registers (lane i holds dims
//     4i..4i+3 of o, as in the decode kernel);
//   * the block walks tiles of 32 keys staged in shared memory up to the
//     deepest key its last row sees. Scores: lane j takes key j of the tile
//     for all of the warp's items at once (one K read, IPW broadcast q
//     reads, the key rows padded to an odd float4 stride so the lanes' reads
//     fall on distinct banks); keys past a row's position are masked to
//     -inf; one warp max per item and tile; each lane keeps its own partial
//     of l, summed across the warp once at the end;
//   * o += sum_j p_j v_j with lanes back over the head dims, p_j broadcast
//     by a warp shuffle.
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 4 up to 128, any T >= 1.
// Shared memory: 49 KB at hs 128 and 32 items per block (opt-in above 48 KB
// made on every launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kKeys = 32;  // keys per staged tile: one per lane

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 o) {
  return make_float4(fmaf(p, v.x, o.x), fmaf(p, v.y, o.y), fmaf(p, v.z, o.z),
                     fmaf(p, v.w, o.w));
}

__host__ __device__ __forceinline__ int key_stride4(int hs4) {
  return hs4 + 1 + (hs4 & 1);  // odd, so 8 lanes' float4 reads hit 8 slots
}

template <typename KV, int KV_MUL, int IPW>
__global__ void __launch_bounds__(kWarps * 32)
prefill_attention_kernel(const float* __restrict__ q,
                         const KV* __restrict__ k_all,
                         const KV* __restrict__ v_all,
                         float* __restrict__ out, int layer, int pos,
                         int t_len, int S, int n_kv, int hs, float scale) {
  constexpr int kItems = kWarps * IPW;    // (row, head) pairs of the block
  constexpr int kRows = kItems / KV_MUL;  // query rows of the block
  extern __shared__ float4 sm4[];
  const int hs4 = hs / 4;
  const int ks4 = key_stride4(hs4);
  float4* q_s = sm4;                  // kItems x hs4
  float4* k_s = q_s + kItems * hs4;   // kKeys x ks4
  float4* v_s = k_s + kKeys * ks4;    // kKeys x hs4

  const int g = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t tok = static_cast<size_t>(n_kv) * KV_MUL * hs;  // q/out row

  // item it = local row * KV_MUL + head of the group
  for (int i = threadIdx.x; i < kItems * hs4; i += blockDim.x) {
    const int it = i / hs4;
    const int c = i - it * hs4;
    const int r = r0 + it / KV_MUL;
    q_s[i] = r < t_len
                 ? __ldg(reinterpret_cast<const float4*>(
                       q + r * tok + static_cast<size_t>(g * KV_MUL +
                                                         it % KV_MUL) * hs) +
                         c)
                 : zero;
  }

  float4 o[IPW];
  float m[IPW], l[IPW];
  int lim[IPW];  // the last key an item sees; -1 for rows past T
#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    const int r = r0 + (warp + kWarps * i) / KV_MUL;
    lim[i] = r < t_len ? pos + r : -1;
    o[i] = zero;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  const int kmax = pos + min(r0 + kRows, t_len) - 1;  // deepest key read
  const size_t key_row = static_cast<size_t>(n_kv) * hs;
  const size_t base = (static_cast<size_t>(layer) * S * n_kv + g) * hs;
  const bool live = lane < hs4;

  for (int k0 = 0; k0 <= kmax; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kKeys * hs4; i += blockDim.x) {
      const int j = i / hs4;
      const int c = i - j * hs4;
      const int key = k0 + j;
      float4 kv = zero, vv = zero;
      if (key <= kmax) {
        const size_t off = base + key * key_row + 4 * c;
        kv = load_f4(k_all + off);
        vv = load_f4(v_all + off);
      }
      k_s[j * ks4 + c] = kv;
      v_s[j * hs4 + c] = vv;
    }
    __syncthreads();

    // scores of key k0 + lane for the warp's items
    float s[IPW];
#pragma unroll
    for (int i = 0; i < IPW; ++i) s[i] = 0.f;
    const float4* krow = k_s + lane * ks4;
    for (int c = 0; c < hs4; ++c) {
      const float4 kv = krow[c];
#pragma unroll
      for (int i = 0; i < IPW; ++i) {
        const float4 qv = q_s[(warp + kWarps * i) * hs4 + c];
        float a = s[i];
        a = fmaf(qv.x, kv.x, a);
        a = fmaf(qv.y, kv.y, a);
        a = fmaf(qv.z, kv.z, a);
        a = fmaf(qv.w, kv.w, a);
        s[i] = a;
      }
    }
    const int key = k0 + lane;
    float p[IPW];
#pragma unroll
    for (int i = 0; i < IPW; ++i) {
      const float si = key <= lim[i] ? s[i] * scale : -INFINITY;
      float mt = si;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_new = fmaxf(m[i], mt);
      if (m_new == -INFINITY) {  // nothing visible yet (warp-uniform)
        p[i] = 0.f;
        continue;
      }
      const float corr = expf(m[i] - m_new);  // 0 on an item's first keys
      p[i] = expf(si - m_new);                 // 0 for a masked key
      l[i] = fmaf(l[i], corr, p[i]);
      o[i] = make_float4(o[i].x * corr, o[i].y * corr, o[i].z * corr,
                         o[i].w * corr);
      m[i] = m_new;
    }
    for (int j = 0; j < kKeys; ++j) {
      const float4 vv = live ? v_s[j * hs4 + lane] : zero;
#pragma unroll
      for (int i = 0; i < IPW; ++i) {
        o[i] = fma4(__shfl_sync(0xffffffffu, p[i], j), vv, o[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < IPW; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    }
    const int it = warp + kWarps * i;
    const int r = r0 + it / KV_MUL;
    if (r < t_len && live) {
      float* dst = out + r * tok +
                   static_cast<size_t>(g * KV_MUL + it % KV_MUL) * hs;
      reinterpret_cast<float4*>(dst)[lane] =
          make_float4(o[i].x / lsum, o[i].y / lsum, o[i].z / lsum,
                      o[i].w / lsum);
    }
  }
}

template <typename KV, int KV_MUL, int IPW>
int launch(const float* q, const KV* k, const KV* v, float* out,
           int layer, int pos, int t_len, int S, int n_kv, int hs,
           float scale, cudaStream_t stream) {
  constexpr int kItems = kWarps * IPW;
  constexpr int kRows = kItems / KV_MUL;
  const int hs4 = hs / 4;
  const size_t smem = static_cast<size_t>(kItems * hs4 +
                                          kKeys * key_stride4(hs4) +
                                          kKeys * hs4) * sizeof(float4);
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(prefill_attention_kernel<KV, KV_MUL, IPW>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_kv, (t_len + kRows - 1) / kRows);
  prefill_attention_kernel<KV, KV_MUL, IPW>
      <<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, out, layer, pos, t_len, S, n_kv, hs, scale);
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
  if (hs % 4 != 0 || hs > 128 || t_len < 1 || pos < 0 || pos + t_len > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kv_mul) {
    case 1:
      return launch<KV, 1, 2>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                              scale, s);
    case 2:
      return launch<KV, 2, 4>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                              scale, s);
    case 4:
      return launch<KV, 4, 4>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                              scale, s);
    case 8:
      return launch<KV, 8, 4>(qf, kc, vc, of, layer, pos, t_len, S, n_kv, hs,
                              scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// An f32 cache:
extern "C" int prefill_attention(const void* q, const void* k_all,
                                 const void* v_all, void* out, int layer,
                                 int pos, int t_len, int S, int n_kv,
                                 int kv_mul, int hs, float scale,
                                 void* stream) {
  return dispatch<float>(q, k_all, v_all, out, layer, pos, t_len, S, n_kv,
                         kv_mul, hs, scale, stream);
}

// A bf16 cache:
extern "C" int prefill_attention_kvbf16(const void* q, const void* k_all,
                                        const void* v_all, void* out,
                                        int layer, int pos, int t_len, int S,
                                        int n_kv, int kv_mul, int hs,
                                        float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_all, v_all, out, layer, pos, t_len, S,
                                 n_kv, kv_mul, hs, scale, stream);
}
