// The flash-decode arithmetic shared by K2 and K5 (decode_attention.cu) and
// by K6 and K7 (paged_attention.cu): the KV_MUL query heads of one kv head
// for one query, with a running (m, l, o) online softmax.
//
// The block's kWarps warps take keys t = first + warp, + kWarps, ...; lane
// i holds dims 4i..4i+3 of q, k, v and o as float4 (head size up to 128);
// each warp keeps a running (m, l, o) per query head and the warps combine
// through shared memory at the end, in a fixed order. Where key t lives is
// the `Keys` policy's business: `keys.at(t)` names its row once, and
// `keys.k4(at, lane)` / `keys.v4(at, lane)` return this lane's four values
// of it as f32.
//
// `flash_decode_block` is K6's and K7's whole block over keys 0..last, one
// key a warp at a time. K2 and K5 walk a split of the keys with several in
// flight a warp through `FlashState`, `flash_step`, `flash_stage`,
// `flash_weights` and `flash_combine`, which compute flash_decode_block's
// values with fewer instructions (each head's softmax scalars in one lane
// group, each warp's weight once), so in one split over keys 0..last they
// give its bits (a card test and chip_smoke.py hold K6 to K5 at a
// one-split plan). Every build sums
// the keys in logical order with the same arithmetic, so two policies that
// deliver the same values give the same bits: K5 at B = 1 gives K2's, K6
// over a pool holding a contiguous cache's values gives K5's in one split,
// and K7 gives K6's over the dequantized pool.
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

// K2's and K5's step. The lanes of a warp fall into KV_MUL groups of
// kGroup = 32 / KV_MUL; group h keeps head h's (m, l) and computes its
// softmax scalars once, where flash_decode_block has every lane compute
// every head's. The values are the same: the KV_MUL partial dots are
// summed over the warp by flash_decode_block's xor butterfly, offsets 16,
// 8, ..., 1, each lane adding its partner's value to its own, but while a
// lane holds more than one sum it keeps half of them (the half its offset
// bit selects) and sends the other half, so the KV_MUL sums take KV_MUL - 1
// + log2(kGroup) shuffles where flash_decode_block takes 5 KV_MUL, and each
// lane ends with its group's head; the softmax scalars then reach every
// lane from its group's first lane (2 KV_MUL shuffles; none at KV_MUL 1).
template <int KV_MUL>
struct FlashState {
  static constexpr int kGroup = 32 / KV_MUL;
  float4 qv[KV_MUL], o[KV_MUL];
  float m, l;  // of head lane / kGroup

  // q: the block's KV_MUL query heads, (KV_MUL, hs) contiguous
  __device__ __forceinline__ void begin(const float* __restrict__ q, int hs,
                                        int lane, bool live) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int h = 0; h < KV_MUL; ++h) {
      const float* qh = q + static_cast<size_t>(h) * hs;
      qv[h] = live ? *reinterpret_cast<const float4*>(qh + 4 * lane) : zero;
      o[h] = zero;
    }
    m = -INFINITY;
    l = 0.f;
  }
};

// o * corr + p * v with the one rounding flash_decode_block's build takes
// (its PTX): nvcc fuses p * v into the add at KV_MUL = 1 and corr * o at
// larger KV_MUL, where corr and p feed more products. The intrinsics pin
// that choice here, where the operands come from shuffles and the compiler
// chose otherwise; K6 against K5 at a one-split plan checks it on the card.
template <int KV_MUL>
static __device__ __forceinline__ float flash_update(float o, float corr,
                                                     float p, float v) {
  return KV_MUL == 1 ? __fmaf_rn(o, corr, __fmul_rn(p, v))
                     : __fmaf_rn(p, v, __fmul_rn(corr, o));
}

// One key (this lane's four values of k and v) into every head's state:
// flash_decode_block's arithmetic, value for value.
template <int KV_MUL>
static __device__ __forceinline__ void flash_step(FlashState<KV_MUL>& st,
                                                  float4 kv, float4 vv,
                                                  float scale) {
  constexpr int kGroup = FlashState<KV_MUL>::kGroup;
  const int lane = threadIdx.x & 31;
  float s[KV_MUL];
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) s[h] = dot4(st.qv[h], kv);
  // the butterfly's offsets 16, 8, ... while a lane holds c > 1 sums: the
  // lanes with the offset's bit set keep the second half, the others the
  // first, so lane i ends with head i / kGroup
#pragma unroll
  for (int c = KV_MUL; c > 1; c >>= 1) {
    const int off = 16 * c / KV_MUL;
    const bool upper = lane & off;
#pragma unroll
    for (int j = 0; j < c / 2; ++j) {
      const float keep = upper ? s[j + c / 2] : s[j];
      const float send = upper ? s[j] : s[j + c / 2];
      s[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float t = s[0];
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  t *= scale;
  const float m_new = fmaxf(st.m, t);
  const float corr = expf(st.m - m_new);
  const float p = expf(t - m_new);
  st.l = __fmaf_rn(corr, st.l, p);
  st.m = m_new;
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) {
    const float ch =
        KV_MUL == 1 ? corr : __shfl_sync(0xffffffffu, corr, h * kGroup);
    const float ph = KV_MUL == 1 ? p : __shfl_sync(0xffffffffu, p, h * kGroup);
    st.o[h].x = flash_update<KV_MUL>(st.o[h].x, ch, ph, vv.x);
    st.o[h].y = flash_update<KV_MUL>(st.o[h].y, ch, ph, vv.y);
    st.o[h].z = flash_update<KV_MUL>(st.o[h].z, ch, ph, vv.z);
    st.o[h].w = flash_update<KV_MUL>(st.o[h].w, ch, ph, vv.w);
  }
}

// The warps' states into shared memory: sm_m, sm_l (kWarps, KV_MUL), sm_o
// (kWarps, KV_MUL, hs). The caller syncs the block before flash_weights.
template <int KV_MUL>
static __device__ __forceinline__ void flash_stage(
    float* sm, const FlashState<KV_MUL>& st, int hs, bool live) {
  constexpr int kGroup = FlashState<KV_MUL>::kGroup;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sm_m = sm;
  float* sm_l = sm_m + kWarps * KV_MUL;
  float* sm_o = sm_l + kWarps * KV_MUL;
  if (lane % kGroup == 0) {
    sm_m[warp * KV_MUL + lane / kGroup] = st.m;
    sm_l[warp * KV_MUL + lane / kGroup] = st.l;
  }
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) {
    float* oh = sm_o + static_cast<size_t>(warp * KV_MUL + h) * hs;
    if (live) *reinterpret_cast<float4*>(oh + 4 * lane) = st.o[h];
  }
}

// Each warp's weight e^(m_w - m) for each head, m the head's max over the
// warps, once: (kWarps, KV_MUL) floats at `wts` (flash_decode_block
// computes the same values for every output value). Syncs the block.
template <int KV_MUL>
static __device__ __forceinline__ void flash_weights(const float* sm,
                                                     float* wts) {
  for (int i = threadIdx.x; i < kWarps * KV_MUL; i += blockDim.x) {
    const int h = i % KV_MUL;  // i = w * KV_MUL + h
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * KV_MUL + h]);
    // a warp that saw no key holds m = -inf, l = 0, o = 0: weight 0
    wts[i] = expf(sm[i] - mx);
  }
  __syncthreads();
}

// Value dd of head h over the block's warps, in warp order, by the
// weights of flash_weights: its l (lsum) and its unnormalised o
// (returned), flash_decode_block's sums.
template <int KV_MUL>
static __device__ __forceinline__ float flash_combine(const float* sm,
                                                      const float* wts,
                                                      int hs, int h, int dd,
                                                      float& lsum) {
  const float* sm_l = sm + kWarps * KV_MUL;
  const float* sm_o = sm_l + kWarps * KV_MUL;
  lsum = 0.f;
  float osum = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    const float f = wts[w * KV_MUL + h];
    lsum += sm_l[w * KV_MUL + h] * f;
    osum += sm_o[static_cast<size_t>(w * KV_MUL + h) * hs + dd] * f;
  }
  return osum;
}
