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
// The running max m is taken over the key tiles a block has walked, so p
// is rounded to bf16 against the max of the keys its split has seen, as
// the JAX kernel rounds it against the max of its walked KV blocks; the
// combine rescales each split's o and l in f32.
//
// Bound: at 7B and T = 128 the bytes of the live K/V prefix (read once)
// against 4 * n_heads * hs * sum(live keys) flops at 989 TFLOP/s: bytes
// at every position (16.8 MB of f32 prefix at pos 384, 6.3 us, against
// ~1 us of dots). So the dots stay warp-level mma.sync m16n8k16 (the MMA
// rate is not the limit); what the design does is fill the SMs and keep
// bytes in flight:
//   * the key range is split across blocks (flash-decoding style): the
//     grid is (n_kv, item tiles, splits), split z walks its own run of key
//     tiles (ops/attention.py prefill_bf16_plan picks the count from the
//     live prefix, T * kv_mul, n_kv and the SM count) and writes its
//     unnormalised o and its m and l to a scratch that
//     prefill_attention_bf16_combine merges in split order; with one split
//     the block writes out itself;
//   * a block owns one kv head and 64 (row, head) items of its group
//     (item = row * kv_mul + head), the MMA's M dimension, so each staged
//     K/V tile serves every query head of the group;
//   * one producer thread fills a ring of kStages K/V stages with TMA, one
//     copy per K or V tile, completing on the stage's full mbarrier: a 3-D
//     tensor map over the layer's (keys, n_kv, hs) cache whose key extent
//     ends at pos+T-1, so keys past it are never read (they arrive as
//     zeros), and whose boxes reach 16 bytes past hs, so each staged row
//     comes padded with zeros (a copy per key row, the first design,
//     spent ~80 cycles of the SM's copy engine per 256- or 512-byte row
//     and bound the kernel);
//   * 4 consumer warps, 16 items each, keep their q fragments (bf16), o
//     accumulators and m and l in registers and multiply the tile that has
//     arrived while the next ones stream in; an f32 tile (32 keys) is
//     staged as f32 and rounded to bf16 where the fragments are built, a
//     bf16 tile (64 keys) is copied as it is and read through ldmatrix;
//     padded rows (16 bytes) keep the fragment reads off shared bank
//     conflicts.
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 16 up to 128, any T >= 1.
// Shared memory: 3 stages of 33 / 34 KB (f32 / bf16 cache) at hs 128, so two
// blocks fit on an SM.
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
constexpr int kItems = 16 * kWarps;   // (row, head) items per block
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kStages = 3;
constexpr int kMaxHs = 128;

// keys per tile and the padded row length (elements) of a staged tile
template <typename KV>
struct Tile {
  static constexpr int kKeys = std::is_same<KV, float>::value ? 32 : 64;
  static constexpr int kPad = 16 / sizeof(KV);
  __host__ __device__ static int ld(int hs) { return hs + kPad; }
  // bytes of one stage: the K and the V tile
  __host__ __device__ static int stage_bytes(int hs) {
    return 2 * kKeys * ld(hs) * static_cast<int>(sizeof(KV));
  }
  // the ring (stage tiles 128-byte aligned: 128 * (hs + kPad) bytes per
  // tile), its barriers, and room to align
  __host__ __device__ static size_t smem(int hs) {
    return static_cast<size_t>(kStages) * stage_bytes(hs) + 2 * kStages * 8 +
           128;
  }
};

// B fragments of s = q k^T for two n8 tiles of keys (key0..key0+15) over
// dims d0..d0+15: f32 rows rounded here, bf16 rows through ldmatrix
static __device__ __forceinline__ void k_frag2(uint32_t (&r)[4],
                                               const float* ks, int ld,
                                               int key0, int d0, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // keys key0 + 8 h + g
    const float* p = ks + (key0 + 8 * h + g) * ld + d0 + 2 * c;
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 8);
    r[2 * h] = pack_bf16(lo.x, lo.y);
    r[2 * h + 1] = pack_bf16(hi.x, hi.y);
  }
}

static __device__ __forceinline__ void k_frag2(uint32_t (&r)[4],
                                               const __nv_bfloat16* ks,
                                               int ld, int key0, int d0,
                                               int lane) {
  ldmatrix_x4(r, ks + (key0 + (lane >> 4) * 8 + (lane & 7)) * ld + d0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of o += p v for keys k0 + 2c (+1), +8 (+9) and dims d0 + g,
// two n8 tiles (dims d0..d0+15)
static __device__ __forceinline__ void v_frag2(uint32_t (&r)[4],
                                               const float* vs, int ld,
                                               int k0, int d0, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // dims d0 + 8 h + g
    const float* p = vs + (k0 + 2 * c) * ld + d0 + 8 * h + g;
    r[2 * h] = pack_bf16(p[0], p[ld]);
    r[2 * h + 1] = pack_bf16(p[8 * ld], p[9 * ld]);
  }
}

static __device__ __forceinline__ void v_frag2(uint32_t (&r)[4],
                                               const __nv_bfloat16* vs,
                                               int ld, int k0, int d0,
                                               int lane) {
  ldmatrix_x4_trans(r, vs + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                           d0 + (lane >> 4) * 8);
}

template <typename KV, int KV_MUL>
__global__ void __launch_bounds__(kThreads, 2)
prefill_attention_bf16_kernel(const float* __restrict__ q,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              float* __restrict__ out,
                              float* __restrict__ o_part,
                              float* __restrict__ ml_part, int pos,
                              int t_len, int n_kv, int hs, int per_split,
                              float scale) {
  using Tl = Tile<KV>;
  constexpr int kKeys = Tl::kKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((128u - (cta_addr(smem_raw) & 127u)) & 127u);
  const int ld = Tl::ld(hs);
  const int stage_bytes = Tl::stage_bytes(hs);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * stage_bytes);
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
      mbar_init(&empty[i], kWarps * 32);
    }
    mbar_fence_init();
  }
  // q rows of the block's items, rounded to bf16, staged in stage 0's room
  // (the ring starts after the fragments are read); items past T*kv_mul are
  // zeros (computed, never stored)
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(sm);
  const int qld = hs + 8;
  const int hs8 = hs / 8;
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
    *reinterpret_cast<uint4*>(q_s + it * qld + 8 * c8) = v;
  }
  __syncthreads();
  const int hs16 = hs / 16;
  uint32_t qf[kMaxHs / 16][4];
  if (warp < kWarps) {
#pragma unroll
    for (int ks = 0; ks < kMaxHs / 16; ++ks) {
      if (ks < hs16) {
        ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * qld + ks * 16 +
                                (lane >> 4) * 8);
      }
    }
  }
  fence_proxy_async();  // the q staging is done before TMA reuses it
  __syncthreads();      // stage 0's room is free for the ring

  if (warp == kWarps) {
    // producer: one TMA copy per K tile and per V tile
    if (lane == 0) {
      for (int i = 0; tile0 + i < tile1; ++i) {
        const int slot = i % kStages;
        mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
        const int k0 = (tile0 + i) * kKeys;
        KV* ks = reinterpret_cast<KV*>(sm + slot * stage_bytes);
        mbar_expect_tx(&full[slot], stage_bytes);
        tma_load_3d(ks, &k_map, 0, g, k0, &full[slot]);
        tma_load_3d(ks + kKeys * ld, &v_map, 0, g, k0, &full[slot]);
      }
    }
    return;
  }

  // consumers: this thread's two accumulator rows, items a (row g) and b
  // (row g + 8)
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int item_a = item0 + warp * 16 + gq;
  const int item_b = item_a + 8;
  const int lim_a = pos + min(item_a / KV_MUL, t_len - 1);
  const int lim_b = pos + min(item_b / KV_MUL, t_len - 1);

  float o[kMaxHs / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxHs / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int i = 0; tile0 + i < tile1; ++i) {
    const int slot = i % kStages;
    mbar_wait(&full[slot], (i / kStages) & 1);
    const KV* ks = reinterpret_cast<const KV*>(sm + slot * stage_bytes);
    const KV* vs = ks + kKeys * ld;
    const int k0 = (tile0 + i) * kKeys;

    // s = q k^T over the tile: kKeys / 8 n8 tiles of keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kq = 0; kq < kMaxHs / 16; ++kq) {
      if (kq < hs16) {
#pragma unroll
        for (int p = 0; p < kKeys / 16; ++p) {
          uint32_t r[4];
          k_frag2(r, ks, ld, p * 16, kq * 16, lane);
          mma_bf16(s[2 * p], qf[kq], r[0], r[1]);
          mma_bf16(s[2 * p + 1], qf[kq], r[2], r[3]);
        }
      }
    }

    // scale after the dot, causal mask, online softmax (rows a and b; the
    // four lanes of a quad hold a row's keys of the tile between them)
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
          v_frag2(r, vs, ld, kt * 16, dj * 16, lane);
          mma_bf16(o[2 * dj], pa, r[0], r[1]);
          mma_bf16(o[2 * dj + 1], pa, r[2], r[3]);
        }
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
  for (int hb = 0; hb < 2; ++hb) {  // rows g and g + 8
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
    for (int j = 0; j < kMaxHs / 8; ++j) {
      if (j < hs8) {
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

// out[rh, :] = sum_z w_z o_z[rh, :] / sum_z w_z l_z[rh], w_z = exp(m_z - M)
// with M the largest m_z, over the splits in order; one thread per four
// values of a (row, head).
__global__ void prefill_attention_bf16_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    float* __restrict__ out, int n_all, int hs, int splits) {
  const int hs4 = hs / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_all * hs4) return;
  const int rh = idx / hs4;
  const int c4 = idx - rh * hs4;
  const float* m = ml_part;
  const float* l = ml_part + static_cast<size_t>(splits) * n_all;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) {
    mx = fmaxf(mx, m[static_cast<size_t>(z) * n_all + rh]);
  }
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const size_t zi = static_cast<size_t>(z) * n_all + rh;
    const float w = expf(m[zi] - mx);  // 0 for a split that saw no key
    lsum += w * l[zi];
    const float4 v =
        reinterpret_cast<const float4*>(o_part + zi * hs)[c4];
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  const float inv = 1.f / lsum;
  reinterpret_cast<float4*>(out + static_cast<size_t>(rh) * hs)[c4] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// The TMA map of one layer's K or V: (live keys, n_kv, hs) with boxes of
// (kKeys, 1, hs + kPad), so each row arrives padded with zeros and keys
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
  const uint32_t box[3] = {static_cast<uint32_t>(Tile<KV>::ld(hs)), 1,
                           static_cast<uint32_t>(Tile<KV>::kKeys)};
  return encode_map(map,
                    std::is_same<KV, float>::value
                        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
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
  const size_t smem = Tile<KV>::smem(hs);
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(prefill_attention_bf16_kernel<KV, KV_MUL>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_kv, (t_len * KV_MUL + kItems - 1) / kItems, splits);
  prefill_attention_bf16_kernel<KV, KV_MUL>
      <<<grid, kThreads, smem, stream>>>(q, k_map, v_map, out, o_part,
                                         ml_part, pos, t_len, n_kv, hs, per,
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
  constexpr int kKeys = Tile<KV>::kKeys;
  const int live_tiles = (pos + t_len + kKeys - 1) / kKeys;
  if (hs % 16 != 0 || hs <= 0 || hs > kMaxHs || t_len < 1 || pos < 0 ||
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
// `splits` blocks along the key range, each over `per` tiles of keys (32
// keys of an f32 cache, 64 of a bf16 one); with splits > 1 they write
// o_part (splits, T * n_q, hs) and ml_part (2, splits, T * n_q) for
// prefill_attention_bf16_combine, else `out` itself. An f32 cache:
extern "C" int prefill_attention_bf16(const void* q, const void* k_all,
                                      const void* v_all, void* out,
                                      void* o_part, void* ml_part, int layer,
                                      int pos, int t_len, int S, int n_kv,
                                      int kv_mul, int hs, int splits,
                                      int per, float scale, void* stream) {
  return dispatch<float>(q, k_all, v_all, out, o_part, ml_part, layer, pos,
                         t_len, S, n_kv, kv_mul, hs, splits, per, scale,
                         stream);
}

// A bf16 cache:
extern "C" int prefill_attention_bf16_kvbf16(
    const void* q, const void* k_all, const void* v_all, void* out,
    void* o_part, void* ml_part, int layer, int pos, int t_len, int S,
    int n_kv, int kv_mul, int hs, int splits, int per, float scale,
    void* stream) {
  return dispatch<__nv_bfloat16>(q, k_all, v_all, out, o_part, ml_part,
                                 layer, pos, t_len, S, n_kv, kv_mul, hs,
                                 splits, per, scale, stream);
}

// The splits' merge: out (n_all, hs) from o_part and ml_part as above
// (n_all = T * n_q).
extern "C" int prefill_attention_bf16_combine(const void* o_part,
                                              const void* ml_part, void* out,
                                              int n_all, int hs, int splits,
                                              void* stream) {
  if (n_all <= 0 || hs <= 0 || hs % 4 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = n_all * (hs / 4);
  prefill_attention_bf16_combine_kernel<<<(n + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<float*>(out), n_all, hs, splits);
  return static_cast<int>(cudaGetLastError());
}
