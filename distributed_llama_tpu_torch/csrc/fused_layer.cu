// The fused T=1 decode layer for Hopper (sm_90a): K8 (the layer's head),
// K9 (its tail) and K10 (the whole layer in one kernel).
//
//   K8  head:  qkv = RoPE(wqkv . rmsnorm(x, rms_att)) on the q and k rows
//   K9  tail:  xn = x + wo . ao;  h = rmsnorm(xn, rms_ffn);
//              out = xn + w2 . (silu(w1 . h) * (w3 . h))
//   K10 mega:  K8, the k/v write at (layer, pos) in the cache dtype, flash
//              attention of q over keys 0..pos (GQA groups), then K9
//
// Replace the JAX package's ops/pallas_layer.py _head_call (_head_kernel),
// _tail_call (_tail_kernel) and _mega_call (_mega_kernel). The Pallas
// kernels walk one sequential grid and carry their vectors in VMEM scratch
// from step to step; Mosaic's layout limits shaped the rest (the
// column-form vectors, the roll-and-mask RoPE, the block-permuted wo of
// the megakernel). None of that carries over: here the blocks run in
// parallel, every vector is a plain f32 array, and wo is read in the codec
// layout.
//
// Layouts: Q40 weights in the codec layout of one layer, qs uint8 (d, nb,
// 16) and d16 f16 (d, nb) (q40_matvec.cu); wqkv's rows are q (dim), k
// (kv_dim), v (kv_dim); w13's rows are w1 (hid) then w3 (hid). freq holds
// the (dim + kv_dim) / 2 RoPE pair frequencies of the q and k rows; pos is
// a device int32, so a step captured in a CUDA graph reads each replay's
// position. The caches are (L, S, n_kv, hs), f32 or bf16.
//
// Bound: the weight bytes, read once: 28.31 MB of wqkv for K8, 85.52 MB of
// wo, w13 and w2 for K9, both and the live cache prefix for K10 (Llama-2-
// 7B). Every matvec row is the classic row body's arithmetic (q40_row.cuh,
// the Q40 layout probe's P0): a warp a row, lane l taking the row's blocks
// l, l + 32, ... in order into one f32 sum, then the xor butterfly, so a
// fused row gives P0's bits on the same staged vector. The first design of
// all three, right and simple first: every block staged its vector with one
// dependent 4-byte load a thread at a time, K8 as 384 blocks that each
// restaged rmsnorm(x), K9 and K10 as one grid of co-resident blocks (a
// cooperative launch, sized from the occupancy calculator) with a
// generation-counter barrier in global memory between phases (K9 two:
// after x + wo.ao, after silu(w1.h) * w3.h; K10 four: after qkv and the
// cache write, after attention, after wo, after w13); vectors a phase
// produces live in global scratch and are read after the barrier with
// __ldcg (L2), never through the non-coherent caches. K8 rotates each row
// pair (2p, 2p+1) below dim + kv_dim by float(pos) * freq[p] with precise
// cosf / sinf (the angle reaches ~2047 rad, where the fast intrinsics lose
// accuracy) and products rounded apart (no FMA contraction), as the plain
// version computes it.
//
// K10, redesigned from per-phase %globaltimer stamps of its first design
// at Llama-2-7B on an H100: of 88.8 us a layer at pos 63, 17 went to
// staging vectors with one dependent 4-byte load a thread at a time, 8 to
// the four barriers, the first weight loads of each phase waited behind
// both; at pos 2047 the attention took 101 us on its n_kv blocks while the
// rest of the grid waited:
//   - stage4 / stage4_rmsnorm stage a vector with float4 loads, several in
//     flight a thread, the rmsnorm's x kept in registers between its sum
//     of squares and the write;
//   - before each barrier a warp asks L2 for the rows it takes first after
//     it (prefetch_row), so they stream while the grid meets and stages;
//     rows are q40_row_dot's (P0's bits);
//   - the attention splits keys 0..pos of each kv head across the whole
//     grid (key_splits): a block takes split j of head g with K2's online
//     softmax over its keys, writes its (m, l, o), and the last block of
//     the head to finish (a ticket after a fence) merges the splits in
//     split order and resets the ticket, so the bits do not depend on which
//     block finishes last; within 1e-5 of the plain attention, no longer
//     K2's bits.
//
// K8 and K9, redesigned from %globaltimer stamps of their first design
// (Llama-2-7B, K8 at pos 63, H100): K8 ran 384 blocks in waves, each
// restaging rmsnorm(x) with dependent scalar loads (6.4 us) before its 16
// row pairs; K9 spent 12.4 of its 63.9 stamped us staging and 4.2 at its
// two barriers with no weight byte in flight, and its rows streamed near
// 60% of the bound (the classic body's arithmetic: a byte permute, a
// subtract and an FMA a value, x read from shared memory for every row).
// Now:
//   - one grid of co-resident blocks (K9's a cooperative launch, K8's a
//     plain one), each staging each vector once with float4 loads and
//     K10's arithmetic (K8's q, k and v are K10's bits), its loads issued
//     before the ring's first copies so they do not queue behind them;
//   - each block takes a contiguous band of each phase's jobs (bands differ
//     by one job at most), a job being two rows on one warp: K8's RoPE
//     pair, K9's wo and w2 rows 2j and 2j + 1, its w1 row j with its w3
//     row j; block_dot2 reads each staged x value once for both rows;
//   - every weight byte reaches shared memory by cp.async into a per-warp
//     ring of kRingSlots chunks (CH = 64 Q40 blocks of both rows' codes
//     and scales), issued a chunk ahead of the rows and across the phase
//     ends, so bytes are in flight while the block stages and meets; a
//     warp waits for its own copies (cp.async.wait_group, __syncwarp), so
//     neither a producer warp nor a named barrier is needed; two slots
//     measured faster than three or four (more copies queued at the start
//     delay the staging and the first rows);
//   - a row's sum reads its codes and scales from the ring with P0's
//     arithmetic, each row's FMAs and butterfly in P0's order;
//   - K9 meets at its own barrier (ring_barrier: the generation read once
//     a launch, acquire / release atomics).
// What bounds them now is the row body's issue rate: K9's w13 phase
// streams ~2 TB/s of the card's 3.35.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_decode.cuh"
#include "hopper.cuh"
#include "q40_row.cuh"

namespace {

// 16 warps a block: flash_decode.cuh's kWarps, for K10's attention phase
constexpr int kThreads = kWarps * 32;
constexpr float kRmsEps = 1e-5f;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// All blocks of the grid meet here; bar[0] counts the arrivals of the
// current round (back to 0 when it completes), bar[1] is the generation.
// The grid is co-resident (cooperative launch), so no block waits on one
// that has not started.
static __device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// RoPE of one row pair (2p, 2p+1) at pos: precise cosf / sinf of
// float(pos) * freq, products rounded apart (the plain version's).
static __device__ __forceinline__ void rope_pair(float& v0, float& v1,
                                                 int pos, float freq) {
  const float ang = static_cast<float>(pos) * freq;
  const float c = cosf(ang);
  const float s = sinf(ang);
  const float a = __fsub_rn(__fmul_rn(v0, c), __fmul_rn(v1, s));
  const float b = __fadd_rn(__fmul_rn(v0, s), __fmul_rn(v1, c));
  v0 = a;
  v1 = b;
}

struct TailArgs {
  const uint4* wo_qs;
  const __half* wo_d;
  const uint4* w13_qs;
  const __half* w13_d;
  const uint4* w2_qs;
  const __half* w2_d;
  const float* x;      // (dim) the layer's input residual
  const float* w_ffn;  // (dim)
  float* out;          // (dim)
  float* xnew;         // (dim) scratch: x + wo . ao
  float* hb;           // (hid) scratch: silu(w1 . h) * (w3 . h)
  unsigned int* bar;
  int dim;
  int hid;
};

// Shared-memory floats of the matvec phases: the staged vector of the
// widest input plus the reduction slots.
__host__ __device__ static size_t stage_floats(int dim, int hid) {
  return static_cast<size_t>((dim > hid ? dim : hid) / 32) * kBlockPad +
         kWarps;
}

// Blocks of `kernel` with `smem` bytes of shared memory that fit on the
// card at once, cached per device and size (the first launch of a model's
// shapes on a device, made eagerly before any capture, fills it).
struct GridCache {
  int grid[kMaxDevices];
  size_t smem[kMaxDevices];
};

template <typename Kernel>
static cudaError_t coresident_grid(Kernel kernel, size_t smem,
                                   GridCache& cache, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cache.grid[dev] > 0 && cache.smem[dev] == smem) {
    *grid = cache.grid[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  if (dev < kMaxDevices) {
    cache.grid[dev] = *grid;
    cache.smem[dev] = smem;
  }
  return cudaSuccess;
}

// A cooperative launch: the runtime refuses it (rather than hang at a
// barrier) if the grid cannot be resident at once.
template <typename... Params, typename... Args>
static cudaError_t launch_cooperative(void (*kernel)(Params...), int grid,
                                      size_t smem, cudaStream_t stream,
                                      Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// K10: the whole layer
// ---------------------------------------------------------------------------

template <typename KV>
static __device__ __forceinline__ KV from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Keys of one (layer, kv head) of a cache written in this launch: K2's
// ContigKeys, loading through L2.
static __device__ __forceinline__ float4 load_f4_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
static __device__ __forceinline__ float4 load_f4_l2(const __nv_bfloat16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

template <typename KV>
struct FreshKeys {
  const KV* k;
  const KV* v;
  size_t row;  // n_kv * hs
  __device__ __forceinline__ size_t at(int t) const {
    return static_cast<size_t>(t) * row;
  }
  __device__ __forceinline__ float4 k4(size_t at, int lane) const {
    return load_f4_l2(k + at + 4 * lane);
  }
  __device__ __forceinline__ float4 v4(size_t at, int lane) const {
    return load_f4_l2(v + at + 4 * lane);
  }
};

// K10's staging: the vector a phase multiplies, into shared memory padded
// to kBlockPad floats a 32-value block, with float4 loads, kStageVecs of
// them in flight a thread (the first design loaded one float at a time and
// waited on each). n is a multiple of 4, at most
// 4 kStageVecs x blockDim.x values for the rmsnorm, which keeps its loads
// in registers between the sum of squares and the write.
constexpr int kStageVecs = 4;

template <bool kCoherent>
static __device__ __forceinline__ float4 load_vec4(const float* p) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  return kCoherent ? __ldcg(p4) : __ldg(p4);
}

static __device__ __forceinline__ void put4(float* xs, int i, float4 v) {
  *reinterpret_cast<float4*>(xs + (i >> 3) * kBlockPad + (i & 7) * 4) = v;
}

template <bool kCoherent>
static __device__ void stage4(float* xs, const float* x, int n) {
  const int n4 = n / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kStageVecs * blockDim.x) {
    float4 v[kStageVecs];
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = load_vec4<kCoherent>(x + 4 * i);
    }
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) put4(xs, i, v[u]);
    }
  }
  __syncthreads();
}

// rmsnorm(x, w) = (x * rsqrt(sum(x^2) / n + eps)) * w, staged as stage4
// stages; `red` holds kWarps floats for the block's reduction.
template <bool kCoherent>
static __device__ void stage4_rmsnorm(float* xs, float* red, const float* x,
                                      const float* w, int n) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n4 = n / 4;
  float4 v[kStageVecs];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kStageVecs; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < n4) {
      v[u] = load_vec4<kCoherent>(x + 4 * i);
      ss = fmaf(v[u].x, v[u].x, ss);
      ss = fmaf(v[u].y, v[u].y, ss);
      ss = fmaf(v[u].z, v[u].z, ss);
      ss = fmaf(v[u].w, v[u].w, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kWarps; ++i) total += red[i];
  const float inv = rsqrtf(total / static_cast<float>(n) + kRmsEps);
#pragma unroll
  for (int u = 0; u < kStageVecs; ++u) {
    const int i = threadIdx.x + u * blockDim.x;
    if (i < n4) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(w) + i);
      put4(xs, i, make_float4((v[u].x * inv) * g.x, (v[u].y * inv) * g.y,
                              (v[u].z * inv) * g.z, (v[u].w * inv) * g.w));
    }
  }
  __syncthreads();
}

// K10's rows are q40_row_dot's (P0's bits on the same vector). Before a
// barrier, each warp asks L2 for the rows it takes first after it
// (prefetch.global.L2, a line a lane: no registers held across the
// barrier), so those rows stream from L2 while the grid meets and stages.
static __device__ __forceinline__ void prefetch_l2(const void* p,
                                                   size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = 128 * static_cast<size_t>(threadIdx.x & 31); off < bytes;
       off += 32 * 128) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
  }
}

// Row r of a Q40 weight of nb blocks a row: its codes and its scales.
static __device__ __forceinline__ void prefetch_row(const uint4* qs,
                                                    const __half* d16,
                                                    size_t r, int nb) {
  prefetch_l2(qs + r * nb, static_cast<size_t>(nb) * 16);
  prefetch_l2(d16 + r * nb, static_cast<size_t>(nb) * 2);
}

// The attention's key splits, as ops/layer.mega_attention_splits computes
// them: at most kMaxSplits a kv head and as many as the grid has blocks for
// its n_kv heads, each of at least kSplitKeys keys (so a short prefix takes
// one), all of `per` keys but the last, none empty.
constexpr int kMaxSplits = 32;
constexpr int kSplitKeys = 128;

static __device__ __forceinline__ void key_splits(int keys, int n_kv,
                                                  int& splits, int& per) {
  const int most = max(1, min(min(static_cast<int>(gridDim.x) / n_kv,
                                  kMaxSplits),
                              (keys + kSplitKeys - 1) / kSplitKeys));
  per = (keys + most - 1) / most;
  splits = (keys + per - 1) / per;
}

struct MegaArgs {
  const uint4* qkv_qs;
  const __half* qkv_d;
  const float* w_att;
  const float* freq;
  const int* pos;
  float* q;        // (dim) scratch: the rotated queries
  float* ao;       // (dim) scratch: the attention output
  float* att;      // scratch: the key splits' partial o, then their (m, l)
  int* tickets;    // (n_kv) zeros: the key splits of a kv head done
  int layer;
  int seq_len;
  int n_kv;
  int hs;
  float scale;
};

// One key split of kv head g (its KV_MUL query heads, staged in q) over
// keys t0 .. t1 - 1: the first design's online softmax of K2, the block's
// warps over keys t0 + warp, + kWarps, ..., then combined in warp order.
// With one split the normalised output goes to ao; else the split's
// unnormalised o and its (m, l) go to the scratch, and the last block of
// the head to finish (a ticket after a fence) merges the splits in split
// order into ao and resets the ticket.
template <int KV_MUL, typename Keys>
static __device__ void attention_split(const MegaArgs& m, const float* q,
                                       float* sm, int g, int j, int splits,
                                       int t0, int t1, const Keys& keys) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hs = m.hs;
  const bool live = 4 * lane < hs;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[KV_MUL], o[KV_MUL];
  float mm[KV_MUL], l[KV_MUL];
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) {
    qv[h] = live ? *reinterpret_cast<const float4*>(q + h * hs + 4 * lane)
                 : zero;
    o[h] = zero;
    mm[h] = -INFINITY;
    l[h] = 0.f;
  }
  // up to KV_MUL = 4 each warp loads its next key while it takes the
  // current one; at 8 the registers of 8 heads' (q, o) leave no room
  constexpr bool kAhead = KV_MUL <= 4;
  float4 kn = zero, vn = zero;
  if (kAhead && live && t0 + warp < t1) {
    const size_t at = keys.at(t0 + warp);
    kn = keys.k4(at, lane);
    vn = keys.v4(at, lane);
  }
  for (int t = t0 + warp; t < t1; t += kWarps) {
    float4 kv = kn, vv = vn;
    if (kAhead) {
      if (live && t + kWarps < t1) {
        const size_t at = keys.at(t + kWarps);
        kn = keys.k4(at, lane);
        vn = keys.v4(at, lane);
      }
    } else if (live) {
      const size_t at = keys.at(t);
      kv = keys.k4(at, lane);
      vv = keys.v4(at, lane);
    }
#pragma unroll
    for (int h = 0; h < KV_MUL; ++h) {
      float s = dot4(qv[h], kv);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      s *= m.scale;
      const float m_new = fmaxf(mm[h], s);
      const float corr = expf(mm[h] - m_new);
      const float p = expf(s - m_new);
      l[h] = l[h] * corr + p;
      o[h].x = o[h].x * corr + p * vv.x;
      o[h].y = o[h].y * corr + p * vv.y;
      o[h].z = o[h].z * corr + p * vv.z;
      o[h].w = o[h].w * corr + p * vv.w;
      mm[h] = m_new;
    }
  }
  // the warps: sm_m, sm_l (kWarps, KV_MUL), sm_o (kWarps, KV_MUL, hs)
  float* sm_m = sm;
  float* sm_l = sm_m + kWarps * KV_MUL;
  float* sm_o = sm_l + kWarps * KV_MUL;
#pragma unroll
  for (int h = 0; h < KV_MUL; ++h) {
    if (lane == 0) {
      sm_m[warp * KV_MUL + h] = mm[h];
      sm_l[warp * KV_MUL + h] = l[h];
    }
    if (live) {
      *reinterpret_cast<float4*>(sm_o + (warp * KV_MUL + h) * hs + 4 * lane) =
          o[h];
    }
  }
  __syncthreads();
  const int n = KV_MUL * hs;
  const size_t head = static_cast<size_t>(g) * n;
  const size_t part = static_cast<size_t>(g) * splits + j;  // this split
  float* part_o = m.att;
  float* part_ml = m.att + static_cast<size_t>(kMaxSplits) * m.n_kv * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / hs;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * KV_MUL + h]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no key holds m = -inf, l = 0, o = 0: weight 0
      const float f = expf(sm_m[w * KV_MUL + h] - mx);
      lsum += sm_l[w * KV_MUL + h] * f;
      osum += sm_o[(w * KV_MUL + h) * hs + (i - h * hs)] * f;
    }
    if (splits == 1) {
      m.ao[head + i] = osum / lsum;
    } else {
      part_o[part * n + i] = osum;
      if (i - h * hs == 0) {
        part_ml[(part * KV_MUL + h) * 2] = mx;
        part_ml[(part * KV_MUL + h) * 2 + 1] = lsum;
      }
    }
  }
  if (splits == 1) return;
  int* last = reinterpret_cast<int*>(sm_o + kWarps * n);
  __threadfence();  // this split's partials, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(m.tickets + g, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const size_t first = static_cast<size_t>(g) * splits;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / hs;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) {
      mx = fmaxf(mx, __ldcg(part_ml + ((first + s) * KV_MUL + h) * 2));
    }
    float lsum = 0.f, osum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ml = part_ml + ((first + s) * KV_MUL + h) * 2;
      const float f = expf(__ldcg(ml) - mx);
      lsum += __ldcg(ml + 1) * f;
      osum += __ldcg(part_o + (first + s) * n + i) * f;
    }
    m.ao[head + i] = osum / lsum;
  }
  if (threadIdx.x == 0) m.tickets[g] = 0;  // ready for the next launch
}

// Built without a cap below 128 registers a thread: one block an SM. Held
// to 64 registers for two blocks an SM, the kernel spilled and ran slower
// at Llama-2-7B's widths; so did prefetching rows into registers.
template <typename KV, int KV_MUL>
__global__ void __launch_bounds__(kThreads)
q40_mega_kernel(MegaArgs m, TailArgs a, KV* __restrict__ k_all,
                KV* __restrict__ v_all) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  const int dim = a.dim;
  const int hid = a.hid;
  const int kv_dim = m.n_kv * m.hs;
  const int nb_d = dim / 32;
  const int nb_h = hid / 32;
  const int n_rot = dim + kv_dim;
  const int n_qkv = dim + 2 * kv_dim;
  const int pos = __ldg(m.pos);
  const size_t at = (static_cast<size_t>(m.layer) * m.seq_len + pos) * kv_dim;
  float* red = sm + stage_floats(dim, hid) - kWarps;

  // phase 1: rmsnorm -> wqkv -> RoPE; q to scratch, k and v into the cache.
  // A warp takes row pairs (2p, 2p + 1)
  stage4_rmsnorm<false>(sm, red, a.x, m.w_att, dim);
  for (int p = first; 2 * p < n_qkv; p += stride) {
    const size_t r = 2 * static_cast<size_t>(p);
    const uint4* q0 = m.qkv_qs + r * nb_d;
    const __half* d0 = m.qkv_d + r * nb_d;
    float v0 = q40_row_dot(q0, d0, sm, nb_d, lane);
    float v1 = q40_row_dot(q0 + nb_d, d0 + nb_d, sm, nb_d, lane);
    if (lane == 0) {
      const int ri = static_cast<int>(r);
      if (ri < n_rot) rope_pair(v0, v1, pos, __ldg(m.freq + p));
      if (ri < dim) {
        m.q[ri] = v0;
        m.q[ri + 1] = v1;
      } else if (ri < n_rot) {
        k_all[at + ri - dim] = from_float<KV>(v0);
        k_all[at + ri - dim + 1] = from_float<KV>(v1);
      } else {
        v_all[at + ri - n_rot] = from_float<KV>(v0);
        v_all[at + ri - n_rot + 1] = from_float<KV>(v1);
      }
    }
  }
  grid_barrier(a.bar);

  // phase 2: attention over keys 0..pos, split across the whole grid:
  // item (g, j) is split j of kv head g
  {
    int splits, per;
    key_splits(pos + 1, m.n_kv, splits, per);
    const int n = KV_MUL * m.hs;
    float* qs = sm + static_cast<size_t>(kWarps) * KV_MUL * (m.hs + 2) + 4;
    for (int item = blockIdx.x; item < m.n_kv * splits; item += gridDim.x) {
      const int g = item / splits;
      const int j = item - g * splits;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        qs[i] = __ldcg(m.q + static_cast<size_t>(g) * n + i);
      }
      __syncthreads();
      const size_t base =
          (static_cast<size_t>(m.layer) * m.seq_len * m.n_kv + g) * m.hs;
      const FreshKeys<KV> keys{k_all + base, v_all + base,
                               static_cast<size_t>(kv_dim)};
      attention_split<KV_MUL>(m, qs, sm, g, j, splits, j * per,
                              min((j + 1) * per, pos + 1), keys);
      __syncthreads();
    }
  }
  if (first < dim) prefetch_row(a.wo_qs, a.wo_d, first, nb_d);
  grid_barrier(a.bar);

  // phase 3: xnew = x + wo . ao
  stage4<true>(sm, m.ao, dim);
  for (int r = first; r < dim; r += stride) {
    const size_t o = static_cast<size_t>(r) * nb_d;
    const float s = q40_row_dot(a.wo_qs + o, a.wo_d + o, sm, nb_d, lane);
    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;
  }
  if (first < hid) {
    prefetch_row(a.w13_qs, a.w13_d, first, nb_d);
    prefetch_row(a.w13_qs, a.w13_d, hid + first, nb_d);
  }
  grid_barrier(a.bar);

  // phase 4: hb = silu(w1 . h) * (w3 . h), h = rmsnorm(xnew)
  stage4_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, dim);
  for (int r = first; r < hid; r += stride) {
    const size_t o1 = static_cast<size_t>(r) * nb_d;
    const size_t o3 = static_cast<size_t>(hid + r) * nb_d;
    const float g = q40_row_dot(a.w13_qs + o1, a.w13_d + o1, sm, nb_d, lane);
    const float u = q40_row_dot(a.w13_qs + o3, a.w13_d + o3, sm, nb_d, lane);
    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;
  }
  if (first < dim) prefetch_row(a.w2_qs, a.w2_d, first, nb_h);
  grid_barrier(a.bar);

  // phase 5: out = xnew + w2 . hb
  stage4<true>(sm, a.hb, hid);
  for (int r = first; r < dim; r += stride) {
    const size_t o = static_cast<size_t>(r) * nb_h;
    const float s = q40_row_dot(a.w2_qs + o, a.w2_d + o, sm, nb_h, lane);
    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;
  }
}

template <typename KV, int KV_MUL>
int launch_mega(const MegaArgs& m, const TailArgs& a, void* k_all,
                void* v_all, cudaStream_t stream) {
  auto kernel = q40_mega_kernel<KV, KV_MUL>;
  // attention: the warps' (m, l, o), a flag, and the staged queries
  const size_t att = static_cast<size_t>(kWarps) * KV_MUL * (m.hs + 2) + 4 +
                     static_cast<size_t>(KV_MUL) * m.hs;
  const size_t stage = stage_floats(a.dim, a.hid);
  const size_t smem = (stage > att ? stage : att) * sizeof(float);
  static size_t granted[kMaxDevices];
  cudaError_t e = opt_in_smem(kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  static GridCache grids;
  int grid = 0;
  e = coresident_grid(kernel, smem, grids, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_cooperative(kernel, grid, smem, stream, m, a,
                         static_cast<KV*>(k_all), static_cast<KV*>(v_all));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch_mega(int kv_mul, const MegaArgs& m, const TailArgs& a,
                  void* k_all, void* v_all, cudaStream_t stream) {
  switch (kv_mul) {
    case 1: return launch_mega<KV, 1>(m, a, k_all, v_all, stream);
    case 2: return launch_mega<KV, 2>(m, a, k_all, v_all, stream);
    case 4: return launch_mega<KV, 4>(m, a, k_all, v_all, stream);
    case 8: return launch_mega<KV, 8>(m, a, k_all, v_all, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K8 and K9: the weights through per-warp shared-memory rings
// ---------------------------------------------------------------------------

// A matvec phase of K8 or K9: the rows of one Q40 weight, two to a job: job
// j multiplies rows step * j and step * j + off by the vector the block
// staged for the phase (K8's RoPE pair 2j, 2j + 1; K9's wo and w2 rows 2j,
// 2j + 1; its w1 row j with its w3 row hid + j).
struct RingPhase {
  const uint4* qs;    // (rows, nb, 16) codes
  const __half* d16;  // (rows, nb) scales
  int rows;
  int nb;
  int jobs;
  int step;
  int off;
};

struct RingArgs {
  RingPhase ph[3];
  int phases;
  int stage;  // floats before the rings: the staged vector, kWarps slots
};

constexpr int kRingSlots = 2;  // a warp's chunks: 1 in flight, 1 taken

// Bytes of a slot: both rows' codes of a chunk, then each row's scales and
// the up to 16 bytes before them that its 16-byte copies start with.
__host__ __device__ constexpr int slot_bytes(int ch) {
  return 2 * (18 * ch + 16);
}

// The jobs of phase ph this warp takes: its block's band [jobs * b / grid,
// jobs * (b + 1) / grid), the block's warps in turn: first, first + kWarps,
// ..., count of them.
static __device__ __forceinline__ void warp_jobs(const RingPhase& ph,
                                                 int& first, int& count) {
  const long long jobs = ph.jobs;
  const int lo = static_cast<int>(jobs * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(jobs * (blockIdx.x + 1) / gridDim.x);
  first = lo + static_cast<int>(threadIdx.x >> 5);
  count = first < hi ? (hi - first + kWarps - 1) / kWarps : 0;
}

// A warp's ring of CH-block chunks: the slots it copies chunks into, how
// many it has taken and issued, and the next chunk to issue: chunk c of
// the warp's job t of phase p (first, count: the warp's jobs there; nb: a
// row's blocks; end: the end of the weight's scales), whose rows' codes
// and scales start at qa, qb, da, db.
struct Ring {
  char* slots;
  int taken;
  int issued;
  int p, t, c;
  int first, count, nb;
  const char* end;
  const uint4* qa;
  const uint4* qb;
  const __half* da;
  const __half* db;
};

// Point the issue cursor at the rows of job t of phase p.
static __device__ __forceinline__ void ring_job(Ring& g, const RingArgs& r) {
  const RingPhase& ph = r.ph[g.p];
  const size_t ra =
      static_cast<size_t>(ph.step) * (g.first + kWarps * g.t) * ph.nb;
  const size_t rb = ra + static_cast<size_t>(ph.off) * ph.nb;
  g.qa = ph.qs + ra;
  g.qb = ph.qs + rb;
  g.da = ph.d16 + ra;
  g.db = ph.d16 + rb;
}

// Move the issue cursor to job 0 of the first phase from g.p on where this
// warp has a job.
static __device__ __forceinline__ void ring_seek(Ring& g, const RingArgs& r) {
  for (; g.p < r.phases; ++g.p) {
    const RingPhase& ph = r.ph[g.p];
    warp_jobs(ph, g.first, g.count);
    if (g.count > 0) {
      g.nb = ph.nb;
      g.end = reinterpret_cast<const char*>(
          ph.d16 + static_cast<size_t>(ph.rows) * ph.nb);
      ring_job(g, r);
      return;
    }
  }
}

// Chunk c0 .. c0 + n - 1 (n <= CH) of the cursor's two rows into slot s:
// each row's codes as 16-byte pieces, a block each; its scales as the
// 16-byte pieces that hold them (lanes 0-15 row a, 16-31 row b), the last
// piece of the weight cut at its end (the rest zero-filled): no copy reads
// past the weight.
template <int CH>
static __device__ __forceinline__ void copy_chunk(char* s, const Ring& g,
                                                  int c0, int n, int lane) {
#pragma unroll
  for (int k = 0; k < CH / 32; ++k) {
    const int i = lane + 32 * k;
    if (i < n) {
      cp_async16(s + 16 * i, g.qa + c0 + i);
      cp_async16(s + 16 * (CH + i), g.qb + c0 + i);
    }
  }
  const int k = lane & 15;
  const char* lo = reinterpret_cast<const char*>((lane < 16 ? g.da : g.db) +
                                                 c0);
  const char* at = reinterpret_cast<const char*>(
                       reinterpret_cast<uintptr_t>(lo) & ~uintptr_t{15}) +
                   16 * k;
  if (at < lo + 2 * n) {
    const long long left = g.end - at;
    cp_async16_zfill(s + 32 * CH + (lane < 16 ? 0 : 2 * CH + 16) + 16 * k,
                     at, left < 16 ? static_cast<int>(left) : 16);
  }
}

// Issue the next chunk (none past the last phase) and close this lane's
// group of copies: one group a chunk, empty or not, so a wait for all but
// the newest kRingSlots - 1 groups is a wait for the chunk taken next.
template <int CH>
static __device__ __forceinline__ void ring_issue(Ring& g, const RingArgs& r,
                                                  int lane) {
  if (g.p < r.phases) {
    const int c0 = g.c * CH;
    copy_chunk<CH>(g.slots + (static_cast<unsigned>(g.issued) % kRingSlots) *
                                 slot_bytes(CH),
                   g, c0, min(CH, g.nb - c0), lane);
    ++g.issued;
    if (c0 + CH < g.nb) {
      ++g.c;
    } else {
      g.c = 0;
      if (++g.t == g.count) {
        g.t = 0;
        ++g.p;
        ring_seek(g, r);
      } else {
        ring_job(g, r);
      }
    }
  }
  cp_async_commit();
}

// This warp's ring, its cursor at its first chunk; nothing issued yet.
template <int CH>
static __device__ __forceinline__ Ring ring_init(const RingArgs& r,
                                                 float* sm) {
  Ring g;
  g.slots = reinterpret_cast<char*>(sm + r.stage) +
            (threadIdx.x >> 5) * kRingSlots * slot_bytes(CH);
  g.taken = g.issued = 0;
  g.p = g.t = g.c = 0;
  ring_seek(g, r);
  return g;
}

// Issue the ring's first kRingSlots - 1 chunks.
template <int CH>
static __device__ __forceinline__ void ring_fill(Ring& g, const RingArgs& r) {
  for (int i = 0; i < kRingSlots - 1; ++i) {
    ring_issue<CH>(g, r, threadIdx.x & 31);
  }
}

// The next chunk's slot, once every lane's copies of it have landed; the
// chunk kRingSlots - 1 ahead goes into the slot the warp freed last.
template <int CH>
static __device__ __forceinline__ const char* ring_take(Ring& g,
                                                        const RingArgs& r,
                                                        int lane) {
  ring_issue<CH>(g, r, lane);
  cp_async_wait<kRingSlots - 1>();
  __syncwarp();
  return g.slots +
         (static_cast<unsigned>(g.taken++) % kRingSlots) * slot_bytes(CH);
}

// block_dot of two rows' blocks over the same staged x block, each row's
// FMAs in block_dot's order (the x loads shared).
static __device__ __forceinline__ void block_dot2(uint4 qa, uint4 qb,
                                                  const float* xb, float& sa,
                                                  float& sb) {
  const float4* x4 = reinterpret_cast<const float4*>(xb);
  const uint32_t wa[4] = {qa.x, qa.y, qa.z, qa.w};
  const uint32_t wb[4] = {qb.x, qb.y, qb.z, qb.w};
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float4 xl = x4[w];
    const float4 xh = x4[4 + w];
    const uint32_t la = wa[w] & 0x0F0F0F0Fu;
    const uint32_t ha = (wa[w] >> 4) & 0x0F0F0F0Fu;
    const uint32_t lb = wb[w] & 0x0F0F0F0Fu;
    const uint32_t hb = (wb[w] >> 4) & 0x0F0F0F0Fu;
    a = fmaf(code_minus8(la, 0x7440u), xl.x, a);
    b = fmaf(code_minus8(lb, 0x7440u), xl.x, b);
    a = fmaf(code_minus8(la, 0x7441u), xl.y, a);
    b = fmaf(code_minus8(lb, 0x7441u), xl.y, b);
    a = fmaf(code_minus8(la, 0x7442u), xl.z, a);
    b = fmaf(code_minus8(lb, 0x7442u), xl.z, b);
    a = fmaf(code_minus8(la, 0x7443u), xl.w, a);
    b = fmaf(code_minus8(lb, 0x7443u), xl.w, b);
    a = fmaf(code_minus8(ha, 0x7440u), xh.x, a);
    b = fmaf(code_minus8(hb, 0x7440u), xh.x, b);
    a = fmaf(code_minus8(ha, 0x7441u), xh.y, a);
    b = fmaf(code_minus8(hb, 0x7441u), xh.y, b);
    a = fmaf(code_minus8(ha, 0x7442u), xh.z, a);
    b = fmaf(code_minus8(hb, 0x7442u), xh.z, b);
    a = fmaf(code_minus8(ha, 0x7443u), xh.w, a);
    b = fmaf(code_minus8(hb, 0x7443u), xh.w, b);
  }
  sa = a;
  sb = b;
}

// Both rows' sums over blocks c0 .. c0 + n - 1 (n <= CH) from slot s, lane
// l taking blocks c0 + l, c0 + l + 32, ...: q40_row_dot's FMAs for each row
// (sa, sb: the row's first scale in the slot, past the bytes its copy
// started with). The CH / 32 steps are unrolled and read the slot whole (a
// ragged last chunk's extra steps read stale bytes and add nothing), so
// one step's shared-memory loads can issue while the other computes.
template <int CH>
static __device__ __forceinline__ void pair_chunk(const char* s, int sa,
                                                  int sb, const float* xs,
                                                  int c0, int n, int lane,
                                                  float& acc_a,
                                                  float& acc_b) {
  const uint4* qa = reinterpret_cast<const uint4*>(s);
  const uint4* qb = qa + CH;
  const __half* da = reinterpret_cast<const __half*>(s + 32 * CH) + sa;
  const __half* db = reinterpret_cast<const __half*>(s + 34 * CH + 16) + sb;
#pragma unroll
  for (int k = 0; k < CH / 32; ++k) {
    const int i = lane + 32 * k;
    float ya, yb;
    block_dot2(qa[i], qb[i], xs + (c0 + i) * kBlockPad, ya, yb);
    if (i < n) {
      acc_a = fmaf(__half2float(da[i]), ya, acc_a);
      acc_b = fmaf(__half2float(db[i]), yb, acc_b);
    }
  }
}

// Phase p of this warp: each of its jobs' two rows by xs, chunk after chunk
// from the ring, then `emit(j, ra, sum_a, sum_b)` on lane 0 (ra = row a).
template <int CH, typename Emit>
static __device__ __forceinline__ void ring_phase(Ring& g, const RingArgs& r,
                                                  int p, const float* xs,
                                                  Emit emit) {
  const int lane = threadIdx.x & 31;
  const RingPhase& ph = r.ph[p];
  int first, count;
  warp_jobs(ph, first, count);
  for (int t = 0; t < count; ++t) {
    const int j = first + kWarps * t;
    const int ra = ph.step * j;
    const int rb = ra + ph.off;
    // a chunk starts 64 or more bytes of scales into its row: each row's
    // first scale sits as far into its copy in every chunk
    const int sa = static_cast<int>(reinterpret_cast<uintptr_t>(
                       ph.d16 + static_cast<size_t>(ra) * ph.nb) & 15) >> 1;
    const int sb = static_cast<int>(reinterpret_cast<uintptr_t>(
                       ph.d16 + static_cast<size_t>(rb) * ph.nb) & 15) >> 1;
    float acc_a = 0.f, acc_b = 0.f;
    for (int c0 = 0; c0 < ph.nb; c0 += CH) {
      pair_chunk<CH>(ring_take<CH>(g, r, lane), sa, sb, xs, c0,
                     min(CH, ph.nb - c0), lane, acc_a, acc_b);
      __syncwarp();  // every lane is done with the slot
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_a += __shfl_xor_sync(0xffffffffu, acc_a, off);
      acc_b += __shfl_xor_sync(0xffffffffu, acc_b, off);
    }
    if (lane == 0) emit(j, ra, acc_a, acc_b);
  }
}

// rmsnorm(x, w) staged as stage4_rmsnorm stages it (its arithmetic, its
// bits), x's and w's loads issued before `first()` (the ring's first
// copies), so they queue ahead of the weight stream. Wider than a thread's
// registers hold (n above 4 kStageVecs blockDim.x), first() runs at once
// and x is read twice.
template <bool kCoherent, typename First>
static __device__ void stage_rmsnorm_first(float* xs, float* red,
                                           const float* x, const float* w,
                                           int n, First first) {
  const int n4 = n / 4;
  const bool wide = n4 > kStageVecs * static_cast<int>(blockDim.x);
  if (wide) first();
  float4 v[kStageVecs], g[kStageVecs];
  float ss = 0.f;
  // one pass (k = 0 only) unless wide; every thread takes the first
  for (int i0 = threadIdx.x, k = 0; k == 0 || i0 < n4;
       i0 += kStageVecs * blockDim.x, ++k) {
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) {
        v[u] = load_vec4<kCoherent>(x + 4 * i);
        if (!wide) g[u] = __ldg(reinterpret_cast<const float4*>(w) + i);
      }
    }
    if (!wide) first();
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      if (i0 + u * static_cast<int>(blockDim.x) < n4) {
        ss = fmaf(v[u].x, v[u].x, ss);
        ss = fmaf(v[u].y, v[u].y, ss);
        ss = fmaf(v[u].z, v[u].z, ss);
        ss = fmaf(v[u].w, v[u].w, ss);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kWarps; ++i) total += red[i];
  const float inv = rsqrtf(total / static_cast<float>(n) + kRmsEps);
  for (int i0 = threadIdx.x; i0 < n4; i0 += kStageVecs * blockDim.x) {
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) {
        if (wide) {
          v[u] = load_vec4<kCoherent>(x + 4 * i);
          g[u] = __ldg(reinterpret_cast<const float4*>(w) + i);
        }
        put4(xs, i, make_float4((v[u].x * inv) * g[u].x,
                                (v[u].y * inv) * g[u].y,
                                (v[u].z * inv) * g[u].z,
                                (v[u].w * inv) * g[u].w));
      }
    }
  }
  __syncthreads();
}

// x staged as stage4 stages it, the first kStageVecs float4 loads of each
// thread issued before `first()`.
template <bool kCoherent, typename First>
static __device__ void stage4_first(float* xs, const float* x, int n,
                                    First first) {
  const int n4 = n / 4;
  for (int i0 = threadIdx.x, k = 0; k == 0 || i0 < n4;
       i0 += kStageVecs * blockDim.x, ++k) {
    float4 v[kStageVecs];
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = load_vec4<kCoherent>(x + 4 * i);
    }
    if (k == 0) first();
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) put4(xs, i, v[u]);
    }
  }
  __syncthreads();
}

// K8: the head, one phase of d / 2 jobs (the RoPE pairs) over
// rmsnorm(x, w_att), staged while the ring's first chunks stream in; CH
// (Q40 blocks a chunk) from the host's ring_chunk.
template <int CH>
__global__ void __launch_bounds__(kThreads)
q40_head_kernel(const __grid_constant__ RingArgs r,
                const float* __restrict__ x, const float* __restrict__ w_att,
                const float* __restrict__ freq, const int* __restrict__ pos,
                float* __restrict__ out, int n_rot) {
  extern __shared__ float sm[];
  Ring g = ring_init<CH>(r, sm);
  stage_rmsnorm_first<false>(sm, sm + r.stage - kWarps, x, w_att,
                             r.ph[0].nb * 32,
                             [&] { ring_fill<CH>(g, r); });
  const int at = __ldg(pos);
  ring_phase<CH>(g, r, 0, sm, [&](int j, int ra, float v0, float v1) {
    if (ra < n_rot) rope_pair(v0, v1, at, __ldg(freq + j));
    out[ra] = v0;
    out[ra + 1] = v1;
  });
}

// K9's grid barrier: grid_barrier's counters (bar[0] the round's
// arrivals, back to 0 when it completes; bar[1] the generation, counting
// on), with each block's thread 0 holding the generation it waits for in
// `gen` (read once at the start of the launch): an arrival is one atomic,
// a wait polls the generation, and the last block's release of the new
// generation carries every block's writes to the blocks that acquire it.
static __device__ __forceinline__ unsigned int load_acquire(
    const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

static __device__ __forceinline__ void ring_barrier(unsigned int* bar,
                                                    unsigned int& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(bar)
                 : "memory");
    ++gen;
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(bar),
                   "r"(0u)
                   : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar + 1)
                   : "memory");
    } else {
      while (load_acquire(bar + 1) != gen) {
      }
    }
  }
  __syncthreads();
}

struct TailVecs {
  const float* ao;     // (dim) the attention output
  const float* x;      // (dim) the layer's input residual
  const float* w_ffn;  // (dim)
  float* out;          // (dim)
  float* xnew;         // (dim) scratch: x + wo . ao
  float* hb;           // (hid) scratch: silu(w1 . h) * (w3 . h)
  unsigned int* bar;
  int dim;
  int hid;
};

// K9: the tail, phases wo (dim / 2 jobs), w13 (hid) and w2 (dim / 2)
// between two grid barriers; the rings run on across both; CH as K8's.
template <int CH>
__global__ void __launch_bounds__(kThreads)
q40_tail_kernel(const __grid_constant__ RingArgs r, TailVecs v) {
  extern __shared__ float sm[];
  float* red = sm + r.stage - kWarps;
  unsigned int gen = threadIdx.x == 0 ? load_acquire(v.bar + 1) : 0u;
  Ring g = ring_init<CH>(r, sm);
  stage4_first<false>(sm, v.ao, v.dim, [&] { ring_fill<CH>(g, r); });
  ring_phase<CH>(g, r, 0, sm, [&](int, int ra, float a, float b) {
    v.xnew[ra] = __ldg(v.x + ra) + a;
    v.xnew[ra + 1] = __ldg(v.x + ra + 1) + b;
  });
  ring_barrier(v.bar, gen);
  stage_rmsnorm_first<true>(sm, red, v.xnew, v.w_ffn, v.dim, [] {});
  ring_phase<CH>(g, r, 1, sm, [&](int j, int, float gate, float up) {
    v.hb[j] = gate / (1.f + expf(-gate)) * up;
  });
  ring_barrier(v.bar, gen);
  stage4_first<true>(sm, v.hb, v.hid, [] {});
  ring_phase<CH>(g, r, 2, sm, [&](int, int ra, float a, float b) {
    v.out[ra] = __ldcg(v.xnew + ra) + a;
    v.out[ra + 1] = __ldcg(v.xnew + ra + 1) + b;
  });
}

// The rings' chunk (ops/layer.ring_chunk): 64 Q40 blocks where the 16
// warps' kRingSlots slots of two rows fit in the card's shared memory
// beside `stage` bytes of staged vector, else 32; the block's bytes in
// *smem.
static cudaError_t ring_chunk(size_t stage, int* ch, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  for (int c = 64; c >= 32; c -= 32) {
    const size_t bytes =
        stage + static_cast<size_t>(kWarps) * kRingSlots * slot_bytes(c);
    if (bytes <= static_cast<size_t>(optin)) {
      *ch = c;
      *smem = bytes;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <int CH>
static cudaError_t launch_head(const RingArgs& r, size_t smem,
                              cudaStream_t stream, const float* x,
                              const float* w_att, const float* freq,
                              const int* pos, float* out, int n_rot) {
  auto kernel = q40_head_kernel<CH>;
  static size_t granted[kMaxDevices];
  cudaError_t e = opt_in_smem(kernel, smem, granted);
  if (e != cudaSuccess) return e;
  static GridCache grids;
  int grid = 0;
  e = coresident_grid(kernel, smem, grids, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(r, x, w_att, freq, pos, out,
                                           n_rot);
  return cudaGetLastError();
}

template <int CH>
static cudaError_t launch_tail(const RingArgs& r, const TailVecs& v,
                              size_t smem, cudaStream_t stream) {
  auto kernel = q40_tail_kernel<CH>;
  static size_t granted[kMaxDevices];
  cudaError_t e = opt_in_smem(kernel, smem, granted);
  if (e != cudaSuccess) return e;
  static GridCache grids;
  int grid = 0;
  e = coresident_grid(kernel, smem, grids, &grid);
  if (e != cudaSuccess) return e;
  e = launch_cooperative(kernel, grid, smem, stream, r, v);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaGetLastError()
// code (0 = launched).

// K8: out (d) = the head of one layer, d = dim + 2 * kv_dim rows of wqkv
// (nb blocks each), the first n_rot = dim + kv_dim of them rotated; x and
// w_att 16-byte aligned.
extern "C" int q40_head_fused(const void* qs, const void* d16, const void* x,
                              const void* w_att, const void* freq,
                              const void* pos, void* out, int d, int nb,
                              int n_rot, void* stream) {
  if (d % 2 || n_rot % 2 || n_rot > d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs r = {};
  r.ph[0] = RingPhase{static_cast<const uint4*>(qs),
                      static_cast<const __half*>(d16), d, nb, d / 2, 2, 1};
  r.phases = 1;
  r.stage = static_cast<int>(stage_floats(nb * 32, 0));
  int ch = 0;
  size_t smem = 0;
  cudaError_t e = ring_chunk(r.stage * sizeof(float), &ch, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w_att);
  const float* ff = static_cast<const float*>(freq);
  const int* pi = static_cast<const int*>(pos);
  float* of = static_cast<float*>(out);
  e = ch == 64
          ? launch_head<64>(r, smem, s, xf, wf, ff, pi, of, n_rot)
          : launch_head<32>(r, smem, s, xf, wf, ff, pi, of, n_rot);
  return static_cast<int>(e);
}

// K9: out (dim) = the tail of one layer from the attention output ao (dim)
// and the layer input x (dim); xnew (dim), hb (hid) and bar (2 zeroed
// uint32, left zeroed) are the caller's static scratch; ao and w_ffn
// 16-byte aligned.
extern "C" int q40_tail_fused(const void* wo_qs, const void* wo_d,
                              const void* w13_qs, const void* w13_d,
                              const void* w2_qs, const void* w2_d,
                              const void* ao, const void* x,
                              const void* w_ffn, void* out, void* xnew,
                              void* hb, void* bar, int dim, int hid,
                              void* stream) {
  if (dim % 32 || hid % 32) return static_cast<int>(cudaErrorInvalidValue);
  const int nb_d = dim / 32;
  RingArgs r = {};
  r.ph[0] = RingPhase{static_cast<const uint4*>(wo_qs),
                      static_cast<const __half*>(wo_d), dim, nb_d, dim / 2,
                      2, 1};
  r.ph[1] = RingPhase{static_cast<const uint4*>(w13_qs),
                      static_cast<const __half*>(w13_d), 2 * hid, nb_d, hid,
                      1, hid};
  r.ph[2] = RingPhase{static_cast<const uint4*>(w2_qs),
                      static_cast<const __half*>(w2_d), dim, hid / 32,
                      dim / 2, 2, 1};
  r.phases = 3;
  r.stage = static_cast<int>(stage_floats(dim, hid));
  const TailVecs v{static_cast<const float*>(ao),
                   static_cast<const float*>(x),
                   static_cast<const float*>(w_ffn),
                   static_cast<float*>(out),
                   static_cast<float*>(xnew),
                   static_cast<float*>(hb),
                   static_cast<unsigned int*>(bar),
                   dim,
                   hid};
  int ch = 0;
  size_t smem = 0;
  cudaError_t e = ring_chunk(r.stage * sizeof(float), &ch, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = ch == 64 ? launch_tail<64>(r, v, smem, s)
                 : launch_tail<32>(r, v, smem, s);
  return static_cast<int>(e);
}

// K10: out (dim) = the whole layer `layer` at position *pos, writing its k
// and v at (layer, *pos) of the (L, seq_len, n_kv, hs) caches, f32
// (kv_bf16 = 0) or bf16 (1). q and ao (dim), xnew (dim), hb (hid), bar, att
// (kMaxSplits * (dim + 2 * n_kv * kv_mul) f32: the key splits' partials)
// and tickets (n_kv zeroed int32, left zeroed) are the caller's static
// scratch. Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 4 up to 128, dim
// up to 4 kStageVecs kThreads (8192) and x, w_att and w_ffn 16-byte
// aligned.
extern "C" int q40_layer_mega(const void* qkv_qs, const void* qkv_d,
                              const void* wo_qs, const void* wo_d,
                              const void* w13_qs, const void* w13_d,
                              const void* w2_qs, const void* w2_d,
                              const void* x, const void* w_att,
                              const void* w_ffn, const void* freq,
                              const void* pos, void* k_all, void* v_all,
                              void* out, void* q, void* ao, void* xnew,
                              void* hb, void* bar, void* att,
                              void* tickets, int layer, int dim, int hid,
                              int seq_len, int n_kv, int kv_mul, int hs,
                              float scale, int kv_bf16, void* stream) {
  if (dim % 32 || hid % 32 || hs % 4 || hs > 128 ||
      n_kv * kv_mul * hs != dim || dim > 4 * kStageVecs * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MegaArgs m{static_cast<const uint4*>(qkv_qs),
                   static_cast<const __half*>(qkv_d),
                   static_cast<const float*>(w_att),
                   static_cast<const float*>(freq),
                   static_cast<const int*>(pos),
                   static_cast<float*>(q),
                   static_cast<float*>(ao),
                   static_cast<float*>(att),
                   static_cast<int*>(tickets),
                   layer,
                   seq_len,
                   n_kv,
                   hs,
                   scale};
  const TailArgs a{static_cast<const uint4*>(wo_qs),
                   static_cast<const __half*>(wo_d),
                   static_cast<const uint4*>(w13_qs),
                   static_cast<const __half*>(w13_d),
                   static_cast<const uint4*>(w2_qs),
                   static_cast<const __half*>(w2_d),
                   static_cast<const float*>(x),
                   static_cast<const float*>(w_ffn),
                   static_cast<float*>(out),
                   static_cast<float*>(xnew),
                   static_cast<float*>(hb),
                   static_cast<unsigned int*>(bar),
                   dim,
                   hid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_bf16 ? dispatch_mega<__nv_bfloat16>(kv_mul, m, a, k_all, v_all, s)
                 : dispatch_mega<float>(kv_mul, m, a, k_all, v_all, s);
}
