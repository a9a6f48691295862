// The flash-decode body shared by K2 and K5 (decode_attention.cu) and by K6
// and K7 (paged_attention.cu): one thread block computes the KV_MUL query
// heads of one kv head for one query, over keys 0..last, with a running
// (m, l, o) online softmax.
//
// The block's kWarps warps take keys t = warp, warp + kWarps, ...; lane i
// holds dims 4i..4i+3 of q, k, v and o as float4 (head size up to 128);
// each warp keeps a running (m, l, o) per query head and the warps combine
// through shared memory at the end, in a fixed order. Where key t lives is
// the `Keys` policy's business: `keys.at(t)` names its row once, and
// `keys.k4(at, lane)` / `keys.v4(at, lane)` return this lane's four values
// of it as f32. Every build sums the keys in logical order with the same
// arithmetic, so two policies that deliver the same values give the same
// bits: K5 at B = 1 gives K2's, K6 over a pool holding a contiguous cache's
// values gives K5's, and K7 gives K6's over the dequantized pool.
//
// Dynamic shared memory: kWarps * KV_MUL * (hs + 2) floats.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

constexpr int kWarps = 16;

static __device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int KV_MUL>
static size_t flash_decode_smem(int hs) {
  return static_cast<size_t>(kWarps) * KV_MUL * (hs + 2) * sizeof(float);
}

// q: this block's KV_MUL query heads, (KV_MUL, hs) contiguous; out: the
// same layout.
template <int KV_MUL, typename Keys>
static __device__ __forceinline__ void flash_decode_block(
    const float* __restrict__ q, float* __restrict__ out, int last, int hs,
    float scale, const Keys& keys) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool live = 4 * lane < hs;  // lanes past the head size hold zeros
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[KV_MUL], o[KV_MUL];
  float m[KV_MUL], l[KV_MUL];
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) {
    const float* qh = q + static_cast<size_t>(h) * hs;
    qv[h] = live ? *reinterpret_cast<const float4*>(qh + 4 * lane) : zero;
    o[h] = zero;
    m[h] = -INFINITY;
    l[h] = 0.f;
  }

  for (int t = warp; t <= last; t += kWarps) {
    const size_t at = keys.at(t);
    const float4 kv = live ? keys.k4(at, lane) : zero;
    const float4 vv = live ? keys.v4(at, lane) : zero;
#pragma unroll
    for (int h = 0; h < KV_MUL; ++h) {
      float s = dot4(qv[h], kv);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      s *= scale;
      const float m_new = fmaxf(m[h], s);
      const float corr = expf(m[h] - m_new);
      const float p = expf(s - m_new);
      l[h] = l[h] * corr + p;
      o[h].x = o[h].x * corr + p * vv.x;
      o[h].y = o[h].y * corr + p * vv.y;
      o[h].z = o[h].z * corr + p * vv.z;
      o[h].w = o[h].w * corr + p * vv.w;
      m[h] = m_new;
    }
  }

  // combine the warps: sm_m, sm_l (kWarps, KV_MUL), sm_o (kWarps, KV_MUL, hs)
  extern __shared__ float sm[];
  float* sm_m = sm;
  float* sm_l = sm_m + kWarps * KV_MUL;
  float* sm_o = sm_l + kWarps * KV_MUL;
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) {
    if (lane == 0) {
      sm_m[warp * KV_MUL + h] = m[h];
      sm_l[warp * KV_MUL + h] = l[h];
    }
    float* oh = sm_o + static_cast<size_t>(warp * KV_MUL + h) * hs;
    if (live) *reinterpret_cast<float4*>(oh + 4 * lane) = o[h];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KV_MUL * hs; i += blockDim.x) {
    const int h = i / hs;
    const int dd = i - h * hs;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * KV_MUL + h]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no key holds m = -inf, l = 0, o = 0: weight 0
      const float f = expf(sm_m[w * KV_MUL + h] - mx);
      lsum += sm_l[w * KV_MUL + h] * f;
      osum += sm_o[static_cast<size_t>(w * KV_MUL + h) * hs + dd] * f;
    }
    out[static_cast<size_t>(h) * hs + dd] = osum / lsum;
  }
}
