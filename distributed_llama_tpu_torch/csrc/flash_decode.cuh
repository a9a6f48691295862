// The split flash-decode walk shared by K2 and K5 (decode_attention.cu)
// and by K6 and K7 (paged_attention.cu): the KV_MUL query heads of one kv
// head for one query over one split t0..t1-1 of its keys, with a running
// (m, l, o) online softmax, then the split's merge.
//
// A block's kWarps warps take keys t = t0 + warp, + kWarps, ... in order;
// lane i holds dims 4i..4i+3 of q, k, v and o as float4 (head size up to
// 128). Where key t lives is the `Keys` policy's business: `keys.at(t)`
// names its position once, `keys.load_k(at)` / `keys.load_v(at)` load
// this lane's four values of it as they are stored, and `Keys::widen`
// makes them f32. `flash_walk` keeps kAhead keys in flight a warp: for
// each batch it first asks the policy for the keys' positions (a
// page-table entry for K6 and K7), then issues their K and V loads, and
// only then widens and takes them in order through `flash_step`. The warps
// combine in warp order (`flash_stage`, `flash_weights`, `flash_combine`),
// and `flash_finish` writes the output of a one-split plan, or the split's
// (m, l, unnormalised o) and the merge of all splits in split order by the
// last split to arrive behind a ticket.
//
// Every kernel sums the keys of a split in the same order with the same
// arithmetic, so two policies that deliver the same values under the same
// plan give the same bits: K5 at B = 1 gives K2's, K6 at t_len 1 over a
// pool holding a contiguous cache's values gives K5's, and K7 gives K6's
// over the dequantized pool. kAhead only orders the loads, not the sums.
//
// Dynamic shared memory: flash_decode_smem (the warps' states, then their
// weights); the merge reuses the states' room.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

constexpr int kWarps = 16;
// the most splits a kv head (ops/attention.DECODE_MAX_SPLITS)
constexpr int kMaxSplits = 32;

static __device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The warps' states (kWarps * KV_MUL * (hs + 2) floats: flash_stage), then
// their weights (kWarps * KV_MUL: flash_weights).
template <int KV_MUL>
__host__ __device__ constexpr size_t flash_decode_smem(int hs) {
  return static_cast<size_t>(kWarps) * KV_MUL * (hs + 3) * sizeof(float);
}

// The most splits `keys` keys may take: `most`, or fewer so that each has
// at least `least` keys, and at least one. It grows with `keys`, so a grid
// sized by it for the most keys a row can have covers every row's plan.
// (Twin of ops/attention.decode_splits.)
__host__ __device__ __forceinline__ int decode_want(int keys, int most,
                                                    int least) {
  const int need = (keys + least - 1) / least;
  const int want = need < most ? need : most;
  return want > 1 ? want : 1;
}

// The splits of `keys` keys: decode_want's count of runs, all of `per`
// keys but the last, none empty.
__host__ __device__ __forceinline__ void decode_splits(int keys, int most,
                                                       int least,
                                                       int& splits,
                                                       int& per) {
  const int want = decode_want(keys, most, least);
  per = (keys + want - 1) / want;
  splits = (keys + per - 1) / per;
}

// K2's and K5's step. The lanes of a warp fall into KV_MUL groups of
// kGroup = 32 / KV_MUL; group h keeps head h's (m, l) and computes its
// softmax scalars once, where the first design had every lane compute
// every head's. The values are the same: the KV_MUL partial dots are
// summed over the warp by the first design's xor butterfly, offsets 16,
// 8, ..., 1, each lane adding its partner's value to its own, but while a
// lane holds more than one sum it keeps half of them (the half its offset
// bit selects) and sends the other half, so the KV_MUL sums take KV_MUL - 1
// + log2(kGroup) shuffles where the first design took 5 KV_MUL, and each
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

// o * corr + p * v with the one rounding the first design's build took
// (its PTX): nvcc fused p * v into the add at KV_MUL = 1 and corr * o at
// larger KV_MUL, where corr and p feed more products. The intrinsics pin
// that choice here, where the operands come from shuffles and the compiler
// chose otherwise, so every kernel of this walk keeps those bits.
template <int KV_MUL>
static __device__ __forceinline__ float flash_update(float o, float corr,
                                                     float p, float v) {
  return KV_MUL == 1 ? __fmaf_rn(o, corr, __fmul_rn(p, v))
                     : __fmaf_rn(p, v, __fmul_rn(corr, o));
}

// One key (this lane's four values of k and v) into every head's state:
// the first design's arithmetic, value for value.
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
// warps, once: (kWarps, KV_MUL) floats at `wts` (the first design
// computed the same values for every output value). Syncs the block.
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
// (returned), the first design's sums.
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

// kAskAhead's batches (flash_walk): batches of kAhead keys while a whole
// one is left, each batch's loads issued, then the next batch's positions
// asked, then its keys taken; then the rest in batches of kAhead / 2, ...,
// 1, so a warp with fewer than kAhead keys (a short prefix) still has
// several in flight. `t` is the warp's next key.
template <int KV_MUL, int kAhead, typename Keys>
static __device__ __forceinline__ void flash_batches(FlashState<KV_MUL>& st,
                                                     Keys& keys, int& t,
                                                     int t1, float scale,
                                                     bool live) {
  using Raw = typename Keys::Raw;
  using At = decltype(keys.at(0));
  At at[kAhead];
  bool full = t + (kAhead - 1) * kWarps < t1;
  if (full) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) at[u] = keys.at(t + u * kWarps);
  }
  while (full) {
    Raw kr[kAhead], vr[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      kr[u] = live ? keys.load_k(at[u]) : Raw{};
      vr[u] = live ? keys.load_v(at[u]) : Raw{};
    }
    t += kAhead * kWarps;
    full = t + (kAhead - 1) * kWarps < t1;
    if (full) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) at[u] = keys.at(t + u * kWarps);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      flash_step(st, Keys::widen(kr[u]), Keys::widen(vr[u]), scale);
    }
  }
  if constexpr (kAhead > 1) {
    flash_batches<KV_MUL, kAhead / 2>(st, keys, t, t1, scale, live);
  }
}

// One split's keys t0..t1-1 into `st`: whole batches of kAhead keys, each
// batch's positions asked first and its K and V loads issued before any
// of its keys is taken, then the rest a key at a time; every warp takes
// its keys t0 + warp, + kWarps, ... in order. The policy (a copy: it may
// keep a cursor) is started at the warp's first key and then asked for
// the position of each key in that order (`at`); its loads return the
// lane's values as they lie in memory (`Raw`), widened to f32 only where
// the step takes them, so a batch in flight holds the narrow values. With
// kAskAhead (for positions read from memory: K6's and K7's page table,
// where the registers allow) the walk is flash_batches': each batch's
// positions are asked as soon as the batch before it has issued its loads,
// so the table's round trip overlaps that batch's, and the last keys go
// in smaller batches. K2 and K5 keep the plain batches: their times on
// either walk stand beside their switch (decode_attention.cu).
template <int KV_MUL, int kAhead, bool kAskAhead, typename Keys>
static __device__ __forceinline__ void flash_walk(FlashState<KV_MUL>& st,
                                                  Keys keys, int t0, int t1,
                                                  float scale, bool live) {
  using Raw = typename Keys::Raw;
  using At = decltype(keys.at(0));
  int t = t0 + (threadIdx.x >> 5);
  keys.start(t);
  if constexpr (kAskAhead) {
    flash_batches<KV_MUL, kAhead>(st, keys, t, t1, scale, live);
    return;
  } else {
    for (; t + (kAhead - 1) * kWarps < t1; t += kAhead * kWarps) {
      At at[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) at[u] = keys.at(t + u * kWarps);
      Raw kr[kAhead], vr[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        kr[u] = live ? keys.load_k(at[u]) : Raw{};
        vr[u] = live ? keys.load_v(at[u]) : Raw{};
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        flash_step(st, Keys::widen(kr[u]), Keys::widen(vr[u]), scale);
      }
    }
    for (; t < t1; t += kWarps) {
      const At at = keys.at(t);
      const Raw kr = live ? keys.load_k(at) : Raw{};
      const Raw vr = live ? keys.load_v(at) : Raw{};
      flash_step(st, Keys::widen(kr), Keys::widen(vr), scale);
    }
  }
}

// Where a split's result goes: `out` + item * KV_MUL * hs for the output
// ((KV_MUL, hs) of the item's query heads); with several splits, `part`
// holds o (items * most, KV_MUL * hs), then (m, l) (items * most, KV_MUL,
// 2), split s of item at item * most + s, and `tickets` (items) int32
// zeros between launches.
struct SplitOut {
  float* out;
  float* part;
  int* tickets;
  size_t items;  // (row, kv head) pairs of the launch
  int most;      // the plan's most splits a kv head
};

// The end of split j of `splits` of `item`: the block's warps combined in
// warp order; with one split the normalised output, else the split's
// partials, a fence and a ticket, and the last split to arrive merges the
// splits in split order (m = max m_j, l = sum l_j e^(m_j - m), o = sum o_j
// e^(m_j - m), out = o / l), every split's partials loaded at once, and
// resets the ticket to 0 for the next launch. The bits do not depend on
// which block finishes last. `sm`: flash_decode_smem's room.
template <int KV_MUL>
static __device__ __forceinline__ void flash_finish(
    const FlashState<KV_MUL>& st, float* sm, const SplitOut& so,
    size_t item, int j, int splits, int hs, bool live) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wts = sm + kWarps * KV_MUL * (hs + 2);  // past flash_stage's
  flash_stage(sm, st, hs, live);
  __syncthreads();
  flash_weights<KV_MUL>(sm, wts);

  const int n = KV_MUL * hs;
  float* out = so.out + item * n;
  if (splits == 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int h = i / hs;
      float lsum;
      const float osum = flash_combine<KV_MUL>(sm, wts, hs, h, i - h * hs,
                                               lsum);
      out[i] = osum / lsum;
    }
    return;
  }
  float* part_o = so.part + item * so.most * n;
  float* part_ml = so.part + so.items * so.most * n +
                   item * so.most * 2 * KV_MUL;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / hs;
    float lsum;
    const float osum = flash_combine<KV_MUL>(sm, wts, hs, h, i - h * hs,
                                             lsum);
    part_o[static_cast<size_t>(j) * n + i] = osum;
    if (i == h * hs) {
      float mx = -INFINITY;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * KV_MUL + h]);
      part_ml[(j * KV_MUL + h) * 2] = mx;
      part_ml[(j * KV_MUL + h) * 2 + 1] = lsum;
    }
  }
  __shared__ int last;
  __threadfence();  // this split's partials, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(so.tickets + item, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the merge: every split's (m, l) into shared memory at once, then each
  // head's max (warp h, lane s) and the weights e^(m_s - m), then each
  // value's sums over the splits in split order, its loads all in flight
  float* sm_m = sm;                          // (splits, KV_MUL)
  float* sm_l = sm_m + kMaxSplits * KV_MUL;  // (splits, KV_MUL)
  float* w = sm_l + kMaxSplits * KV_MUL;     // (splits, KV_MUL)
  for (int i = threadIdx.x; i < splits * KV_MUL; i += blockDim.x) {
    sm_m[i] = __ldcg(part_ml + 2 * i);
    sm_l[i] = __ldcg(part_ml + 2 * i + 1);
  }
  __syncthreads();
  if (warp < KV_MUL) {
    const float ms = lane < splits ? sm_m[lane * KV_MUL + warp] : -INFINITY;
    float mx = ms;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane < splits) w[lane * KV_MUL + warp] = expf(ms - mx);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / hs;
    float o[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      o[s] = s < splits ? __ldcg(part_o + static_cast<size_t>(s) * n + i)
                        : 0.f;
    }
    float osum = 0.f, lsum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float f = w[s * KV_MUL + h];
        lsum += sm_l[s * KV_MUL + h] * f;
        osum += o[s] * f;
      }
    }
    out[i] = osum / lsum;
  }
  if (threadIdx.x == 0) so.tickets[item] = 0;  // ready for the next launch
}
