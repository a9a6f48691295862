// Causal flash-prefill attention with f32-accurate dots for Hopper
// (sm_90a), K4: T query tokens at positions pos..pos+T-1 against the live
// prefix of one layer of the stacked KV cache, f32 or bf16 (the chunk's own
// keys are already written there).
//
//   q (T, n_kv * kv_mul, hs) f32; k_all, v_all (L, S, n_kv, hs) f32 or bf16;
//   out (T, n_kv * kv_mul * hs) f32. Query row i (position pos + i) sees
//   keys 0..pos+i; query head h attends kv head h / kv_mul; scores scaled by
//   1/sqrt(hs) after the q.k dot; softmax online in f32 (running m, l, o).
//
// Replaces the JAX package's ops/pallas_attention.py prefill_attention
// (_prefill_kernel) in its f32 parity mode, whose two dots run at
// Precision.HIGHEST: several low-precision passes on the matrix unit that
// add up to f32 accuracy. The Hopper counterpart is 3xTF32 on the tensor
// cores: a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi)
// (nearest, ties away), and a . b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi in
// f32, dropping only a_lo.b_lo (~2^-22 relative). A bf16 cache value is
// exact in TF32, so over a bf16 cache k and v need no split and each dot
// takes two passes (q_hi.k + q_lo.k, p_hi.v + p_lo.v) to the same accuracy.
// ops/attention.py prefill_attention_tf32_splits models the arithmetic,
// which holds within KERNEL_ATOL (1e-5) of the JAX package's f32 kernel.
// Keys past pos+T-1 are never read, as the JAX kernel clamps its walk with
// n_blk. `pos` and `layer` are kernel arguments, so a call needs no
// device-to-host sync.
//
// Bound: at 7B and T = 128 the bytes of the live K/V prefix (read once)
// against 4 * n_heads * hs * sum(live keys) flops in 3 TF32 passes (2 over
// a bf16 cache) at 494.7 TFLOP/s: bytes up to a few hundred keys,
// operations beyond. The first design (one item per warp, a block walking
// the whole prefix with f32 FMA dots) reached 14% of the f32 cores' peak.
// The design is K4b's (prefill_attention_bf16.cu):
//   * the key range is split across blocks (flash-decoding style): the
//     grid is (n_kv, item tiles, splits), split z walks its own run of key
//     tiles (ops/attention.py prefill_plan picks the count) and writes its
//     unnormalised o and its m and l to a scratch that K4b's f32 merge,
//     prefill_attention_bf16_combine, merges in split order; with one
//     split the block writes out itself;
//   * a block owns one kv head and 64 (row, head) items of its group
//     (item = row * kv_mul + head), the MMA's M dimension, so each staged
//     K/V tile serves every query head of the group;
//   * one producer thread fills a ring of K/V stages of 32 keys with TMA,
//     one copy per K or V tile through a 3-D tensor map over the layer's
//     (keys, n_kv, hs) cache whose key extent ends at pos+T-1 (keys past
//     it arrive as zeros, never read) and whose boxes reach 16 bytes past
//     128 dims, so each staged row comes padded with zeros: 132 floats (or
//     136 bf16) a row, which keeps both fragment reads below off shared
//     bank conflicts;
//   * the block always computes 128 dims (a smaller hs reads zeros past
//     it and stores only its own dims), so every loop has a fixed trip
//     count and the compiler interleaves the MMAs of all k8 steps (loops
//     cut short at a run-time hs measured slower on the H100);
//   * 4 consumer warps of 16 items keep o, m and l in registers; their q
//     fragments are split into hi and lo once and staged in shared memory
//     in fragment order (two 16-byte reads a k8 step); a K or V fragment is
//     split in registers as it is read (f32 cache). The dots are
//     mma.sync m16n8k8 tf32; the small passes (a_hi.b_lo + a_lo.b_hi)
//     accumulate apart from a_hi.b_hi, which doubles the independent MMA
//     chains of q.k. The score accumulators become the P operand of
//     o += p v without moving: key slot c of a k8 step is key 2c of the
//     tile's n8 block, slot c + 4 key 2c + 1, and the V fragment reads the
//     same rows.
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 8 up to 128, any T >= 1.
// Shared memory: 64 KB of q fragments and 3 stages of 33 KB (f32 cache) or
// 4 of 17 KB (bf16), one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;             // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kItems = 16 * kWarps;   // (row, head) items per block
constexpr int kThreads = kConsumers + 32;
constexpr int kKeys = 32;             // keys per staged tile
constexpr int kHs = 128;              // dims a block computes (hs <= kHs)
constexpr int kHs8 = kHs / 8;         // k8 steps of q.k, n8 tiles of p.v

template <typename KV>
struct Tile {
  static constexpr bool kF32 = std::is_same<KV, float>::value;
  // the padded row length (elements) of a staged tile
  static constexpr int kLd = kHs + 16 / sizeof(KV);
  static constexpr int kStages = kF32 ? 3 : 4;
  // bytes of one stage: the K and the V tile
  static constexpr int kStageBytes = 2 * kKeys * kLd * sizeof(KV);
  // the q fragments (hi and lo of kItems x kHs), the ring, its barriers,
  // and room to align to 128
  static constexpr int kQBytes = kItems * kHs * 8;
  static constexpr size_t kSmem =
      kQBytes + kStages * kStageBytes + 2 * kStages * 8 + 128;
};

static __device__ __forceinline__ float as_f32(float v) { return v; }

static __device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The TF32 split of a B fragment (b0, b1): f32 values take hi and lo,
// bf16 values are exact in TF32 (lo stays unused).
template <typename KV>
static __device__ __forceinline__ void split_b(float b0, float b1,
                                               uint32_t (&hi)[2],
                                               uint32_t (&lo)[2]) {
  if constexpr (Tile<KV>::kF32) {
    hi[0] = tf32_rna(b0);
    hi[1] = tf32_rna(b1);
    lo[0] = tf32_rna(b0 - __uint_as_float(hi[0]));
    lo[1] = tf32_rna(b1 - __uint_as_float(hi[1]));
  } else {
    hi[0] = __float_as_uint(b0);
    hi[1] = __float_as_uint(b1);
  }
}

// The 3xTF32 product of an A and a B fragment into `big` (a_hi.b_hi) and
// `small` (a_hi.b_lo + a_lo.b_hi, 2^-11 of it, summed apart so its own
// rounding stays small); over a bf16 cache b is exact: big += a_hi.b,
// small += a_lo.b.
template <typename KV>
static __device__ __forceinline__ void mma_3x(float (&big)[4],
                                              float (&small)[4],
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              const uint32_t (&bh)[2],
                                              const uint32_t (&bl)[2]) {
  mma_tf32(big, ah, bh[0], bh[1]);
  if constexpr (Tile<KV>::kF32) mma_tf32(small, ah, bl[0], bl[1]);
  mma_tf32(small, al, bh[0], bh[1]);
}

template <typename KV, int KV_MUL>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_kernel(const float* __restrict__ q,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         float* __restrict__ out, float* __restrict__ o_part,
                         float* __restrict__ ml_part, int pos, int t_len,
                         int n_kv, int hs, int per_split, float scale) {
  using Tl = Tile<KV>;
  constexpr int kStages = Tl::kStages;
  constexpr int kLd = Tl::kLd;
  constexpr int kStageBytes = Tl::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((128u - (cta_addr(smem_raw) & 127u)) & 127u);
  float4* q_s = reinterpret_cast<float4*>(sm);
  uint8_t* ring = sm + Tl::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int g = blockIdx.x;
  const int item0 = blockIdx.y * kItems;
  const int n_items = t_len * KV_MUL;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_q = n_kv * KV_MUL;
  const int kmax = pos + min((item0 + kItems - 1) / KV_MUL, t_len - 1);
  // this block's run of key tiles: split z of tiles 0..kmax / kKeys
  const int tile0 = blockIdx.z * per_split;
  const int tile1 = min(kmax / kKeys + 1, tile0 + per_split);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);  // expect_tx
      mbar_init(&empty[i], kConsumers);
    }
    mbar_fence_init();
  }
  // q fragments of the block's items, split into TF32 hi and lo, in
  // fragment order: float4 (warp * kHs8 + k8 step) * 64 + lane holds a0..a3
  // of the step's hi, 32 float4s further its lo, so a warp's read of either
  // is 512 contiguous bytes. Each consumer thread gathers 16 such lanes,
  // all its loads issued before any is used (items past T*kv_mul and dims
  // past hs are zeros, computed and never stored).
  if (warp < kWarps) {
    constexpr int kUnits = kWarps * kHs8 * 32 / kConsumers;
    float v[kUnits][4];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = threadIdx.x + kConsumers * u;
      const int it = (i / (kHs8 * 32)) * 16 + ((i & 31) >> 2);
      const int dim = 8 * ((i >> 5) % kHs8) + (i & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (it, dim), (it+8, dim), (it, dim+4)..
        const int item = item0 + it + 8 * (e & 1);
        const int d = dim + 4 * (e >> 1);
        v[u][e] = 0.f;
        if (item < n_items && d < hs) {
          const int r = item / KV_MUL;
          const int h = item - r * KV_MUL;
          v[u][e] = __ldg(
              q + (static_cast<size_t>(r) * n_q + g * KV_MUL + h) * hs + d);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = threadIdx.x + kConsumers * u;
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __uint_as_float(tf32_rna(v[u][e]));
        lo[e] = __uint_as_float(tf32_rna(v[u][e] - hi[e]));
      }
      q_s[(i >> 5) * 64 + (i & 31)] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      q_s[(i >> 5) * 64 + 32 + (i & 31)] =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: one TMA copy per K tile and per V tile
    if (lane == 0) {
      for (int i = 0; tile0 + i < tile1; ++i) {
        const int slot = i % kStages;
        mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
        const int k0 = (tile0 + i) * kKeys;
        KV* ks = reinterpret_cast<KV*>(ring + slot * kStageBytes);
        mbar_expect_tx(&full[slot], kStageBytes);
        tma_load_3d(ks, &k_map, 0, g, k0, &full[slot]);
        tma_load_3d(ks + kKeys * kLd, &v_map, 0, g, k0, &full[slot]);
      }
    }
    return;
  }

  // consumers: this thread's two accumulator rows, items a (row gq) and b
  // (row gq + 8)
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int item_a = item0 + warp * 16 + gq;
  const int item_b = item_a + 8;
  const int lim_a = pos + min(item_a / KV_MUL, t_len - 1);
  const int lim_b = pos + min(item_b / KV_MUL, t_len - 1);
  const float4* qf = q_s + warp * kHs8 * 64 + lane;

  float o[kHs8][4];
#pragma unroll
  for (int j = 0; j < kHs8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int i = 0; tile0 + i < tile1; ++i) {
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    const KV* ks = reinterpret_cast<const KV*>(ring + slot * kStageBytes);
    const KV* vs = ks + kKeys * kLd;
    const int k0 = (tile0 + i) * kKeys;

    // s = q k^T over the tile: 4 n8 tiles of keys; B fragment of key
    // 8j + gq, dims 8kq + cq and + 4
    float s[kKeys / 8][4], sc[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sc[j][e] = 0.f;
    }
#pragma unroll
    for (int kq = 0; kq < kHs8; ++kq) {
      const float4 h4 = qf[64 * kq];
      const float4 l4 = qf[64 * kq + 32];
      const uint32_t ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y),
                              __float_as_uint(h4.z), __float_as_uint(h4.w)};
      const uint32_t al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y),
                              __float_as_uint(l4.z), __float_as_uint(l4.w)};
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const KV* p = ks + (8 * j + gq) * kLd + 8 * kq + cq;
        uint32_t bh[2], bl[2];
        split_b<KV>(as_f32(p[0]), as_f32(p[4]), bh, bl);
        mma_3x<KV>(s[j], sc[j], ah, al, bh, bl);
      }
    }

    // scale after the dot, causal mask, online softmax (rows a and b; the
    // four lanes of a quad hold a row's keys of the tile between them)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int key = k0 + j * 8 + 2 * cq;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sc[j][e];
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
    // a split may hold no key a row can see yet: its max stays -inf and
    // exp takes 0 as the base, so p = 0 and nothing is corrected
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = expf(m_a - base_a);  // 0 while m_a is -inf
    const float corr_b = expf(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[j][0] = expf(s[j][0] - base_a);  // 0 for a masked key
      s[j][1] = expf(s[j][1] - base_a);
      s[j][2] = expf(s[j][2] - base_b);
      s[j][3] = expf(s[j][3] - base_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int j = 0; j < kHs8; ++j) {
      o[j][0] *= corr_a;
      o[j][1] *= corr_a;
      o[j][2] *= corr_b;
      o[j][3] *= corr_b;
    }

    // o += p v, k8 step j over keys 8j..8j+7: slot cq holds key 8j + 2cq,
    // slot cq + 4 key 8j + 2cq + 1, so the score accumulators are the A
    // fragment as they stand (a0 = s0, a1 = s2, a2 = s1, a3 = s3); the
    // small passes of a step go to `oc` and join o once the step is done
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float pv[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[e] = tf32_rna(pv[e]);
        pl[e] = tf32_rna(pv[e] - __uint_as_float(ph[e]));
      }
      const KV* p = vs + (8 * j + 2 * cq) * kLd + gq;
#pragma unroll
      for (int dj = 0; dj < kHs8; ++dj) {
        float oc[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t bh[2], bl[2];
        split_b<KV>(as_f32(p[8 * dj]), as_f32(p[8 * dj + kLd]), bh, bl);
        mma_3x<KV>(o[dj], oc, ph, pl, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dj][e] += oc[e];
      }
    }
    mbar_arrive(&empty[slot]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const bool split = gridDim.z > 1;
  const size_t n_all = static_cast<size_t>(t_len) * n_q;  // (row, head)s
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {  // rows gq and gq + 8
    const int item = hb ? item_b : item_a;
    if (item >= n_items) continue;
    const int r = item / KV_MUL;
    const int h = item - r * KV_MUL;
    const size_t rh = static_cast<size_t>(r) * n_q + g * KV_MUL + h;
    const float l = hb ? l_b : l_a;
    const float inv_l = split ? 1.f : 1.f / l;
    float* dst = split ? o_part + (blockIdx.z * n_all + rh) * hs + 2 * cq
                       : out + rh * hs + 2 * cq;
#pragma unroll
    for (int j = 0; j < kHs8; ++j) {
      if (8 * j < hs) {
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(o[j][2 * hb] * inv_l, o[j][2 * hb + 1] * inv_l);
      }
    }
    if (split && cq == 0) {
      ml_part[blockIdx.z * n_all + rh] = hb ? m_b : m_a;
      ml_part[(gridDim.z + blockIdx.z) * n_all + rh] = l;
    }
  }
}

// The TMA map of one layer's K or V: (live keys, n_kv, hs) with boxes of
// (kKeys, 1, kLd), so each row arrives padded with zeros past hs and keys
// from pos+T on are never read.
template <typename KV>
bool cache_map(CUtensorMap* map, const KV* layer_base, int live, int n_kv,
               int hs) {
  const uint64_t size = sizeof(KV);
  const uint64_t dims[3] = {static_cast<uint64_t>(hs),
                            static_cast<uint64_t>(n_kv),
                            static_cast<uint64_t>(live)};
  const uint64_t strides[2] = {hs * size, static_cast<uint64_t>(n_kv) * hs *
                                              size};
  const uint32_t box[3] = {static_cast<uint32_t>(Tile<KV>::kLd), 1,
                           static_cast<uint32_t>(kKeys)};
  return encode_map(map,
                    Tile<KV>::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    layer_base, 3, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename KV, int KV_MUL>
int launch(const float* q, const KV* k, const KV* v, float* out,
           float* o_part, float* ml_part, int layer, int pos, int t_len,
           int S, int n_kv, int hs, int splits, int per, float scale,
           cudaStream_t stream) {
  const size_t layer_off = static_cast<size_t>(layer) * S * n_kv * hs;
  CUtensorMap k_map, v_map;
  if (!cache_map(&k_map, k + layer_off, pos + t_len, n_kv, hs) ||
      !cache_map(&v_map, v + layer_off, pos + t_len, n_kv, hs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = Tile<KV>::kSmem;
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(prefill_attention_kernel<KV, KV_MUL>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_kv, (t_len * KV_MUL + kItems - 1) / kItems, splits);
  prefill_attention_kernel<KV, KV_MUL><<<grid, kThreads, smem, stream>>>(
      q, k_map, v_map, out, o_part, ml_part, pos, t_len, n_kv, hs, per,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch(const void* q, const void* k_all, const void* v_all, void* out,
             void* o_part, void* ml_part, int layer, int pos, int t_len,
             int S, int n_kv, int kv_mul, int hs, int splits, int per,
             float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const KV* kc = static_cast<const KV*>(k_all);
  const KV* vc = static_cast<const KV*>(v_all);
  float* of = static_cast<float*>(out);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(ml_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int live_tiles = (pos + t_len + kKeys - 1) / kKeys;
  if (hs % 8 != 0 || hs <= 0 || hs > kHs || t_len < 1 || pos < 0 ||
      pos + t_len > S || splits < 1 || per < 1 ||
      (splits - 1) * per >= live_tiles ||
      (splits > 1 && (op == nullptr || mp == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kv_mul) {
    case 1:
      return launch<KV, 1>(qf, kc, vc, of, op, mp, layer, pos, t_len, S,
                           n_kv, hs, splits, per, scale, s);
    case 2:
      return launch<KV, 2>(qf, kc, vc, of, op, mp, layer, pos, t_len, S,
                           n_kv, hs, splits, per, scale, s);
    case 4:
      return launch<KV, 4>(qf, kc, vc, of, op, mp, layer, pos, t_len, S,
                           n_kv, hs, splits, per, scale, s);
    case 8:
      return launch<KV, 8>(qf, kc, vc, of, op, mp, layer, pos, t_len, S,
                           n_kv, hs, splits, per, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// `splits` blocks along the key range, each over `per` tiles of 32 keys;
// with splits > 1 they write o_part (splits, T * n_q, hs) and ml_part
// (2, splits, T * n_q) for prefill_attention_bf16_combine, else `out`
// itself. An f32 cache:
extern "C" int prefill_attention(const void* q, const void* k_all,
                                 const void* v_all, void* out, void* o_part,
                                 void* ml_part, int layer, int pos,
                                 int t_len, int S, int n_kv, int kv_mul,
                                 int hs, int splits, int per, float scale,
                                 void* stream) {
  return dispatch<float>(q, k_all, v_all, out, o_part, ml_part, layer, pos,
                         t_len, S, n_kv, kv_mul, hs, splits, per, scale,
                         stream);
}

// A bf16 cache:
extern "C" int prefill_attention_kvbf16(const void* q, const void* k_all,
                                        const void* v_all, void* out,
                                        void* o_part, void* ml_part,
                                        int layer, int pos, int t_len, int S,
                                        int n_kv, int kv_mul, int hs,
                                        int splits, int per, float scale,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k_all, v_all, out, o_part, ml_part,
                                 layer, pos, t_len, S, n_kv, kv_mul, hs,
                                 splits, per, scale, stream);
}
