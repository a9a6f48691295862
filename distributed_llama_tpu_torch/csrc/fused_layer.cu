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
// 7B). Design, right and simple first:
//   * every matvec row is the classic row body (q40_row.cuh, the Q40
//     layout probe's P0), one warp per row, so a fused row gives P0's bits
//     on the same staged vector;
//   * every block stages the vector it multiplies by itself (rmsnorm
//     included: each block reduces the 4096 floats of x, 16 KB from L2),
//     so K8 needs no grid-wide dependency;
//   * K8 gives a warp a pair of rows (2p, 2p+1): it rotates the pair below
//     dim + kv_dim by float(pos) * freq[p] with precise cosf / sinf (the
//     angle reaches ~2047 rad, where the fast intrinsics lose accuracy)
//     and products rounded apart (no FMA contraction), as the plain version
//     computes it;
//   * K9 and K10 run as one grid of co-resident blocks (a cooperative
//     launch, sized from the occupancy calculator) with a generation-counter
//     barrier in global memory between phases: K9 has two (after x + wo.ao,
//     after silu(w1.h) * w3.h), K10 four (after qkv and the cache write,
//     after attention, after wo, after w13). Vectors a phase produces live
//     in global scratch and are read after the barrier with __ldcg (L2),
//     never through the non-coherent caches;
//   * K10, redesigned from per-phase %globaltimer stamps of its first
//     design at Llama-2-7B on an H100: of 88.8 us a layer at pos 63, 17 went to
//     staging vectors with one dependent 4-byte load a thread at a time,
//     8 to the four barriers, the first weight loads of each phase waited
//     behind both; at pos 2047 the attention took 101 us on its n_kv
//     blocks while the rest of the grid waited:
//       - stage4 / stage4_rmsnorm stage a vector with float4 loads, several
//         in flight a thread, the rmsnorm's x kept in registers between its
//         sum of squares and the write;
//       - before each barrier a warp asks L2 for the rows it takes first
//         after it (prefetch_row), so they stream while the grid meets
//         and stages; rows are q40_row_dot's (P0's bits);
//       - the attention splits keys 0..pos of each kv head across the
//         whole grid (key_splits): a block takes split j of head g with
//         K2's online softmax over its keys, writes its (m, l, o), and the
//         last block of the head to finish (a ticket after a fence) merges
//         the splits in split order and resets the ticket, so the bits do
//         not depend on which block finishes last; within 1e-5 of the
//         plain attention, no longer K2's bits.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_decode.cuh"
#include "q40_row.cuh"

namespace {

// 16 warps a block: flash_decode_block's kWarps, for K10's attention phase
constexpr int kThreads = kWarps * 32;
constexpr float kRmsEps = 1e-5f;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// x[i] as f32: inputs of the launch through the read-only path, vectors
// written earlier in the same launch through L2.
template <bool kCoherent>
static __device__ __forceinline__ float load_vec(const float* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

// Stage x (n values) into xs, each 32-value block padded to kBlockPad.
template <bool kCoherent>
static __device__ void stage(float* xs, const float* x, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[(i >> 5) * kBlockPad + (i & 31)] = load_vec<kCoherent>(x + i);
  }
  __syncthreads();
}

// Stage rmsnorm(x, w) = (x * rsqrt(sum(x^2) / n + eps)) * w; `red` holds
// kWarps floats of shared memory for the block's reduction.
template <bool kCoherent>
static __device__ void stage_rmsnorm(float* xs, float* red, const float* x,
                                     const float* w, int n) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = load_vec<kCoherent>(x + i);
    ss = fmaf(v, v, ss);
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
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[(i >> 5) * kBlockPad + (i & 31)] =
        (load_vec<kCoherent>(x + i) * inv) * __ldg(w + i);
  }
  __syncthreads();
}

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

// The head's matvec over row pairs: pair p = rows 2p, 2p+1 of wqkv (d
// rows) on one warp, rotated when 2p < n_rot; `emit(row, v0, v1)` stores
// the pair. Grid-stride over pairs.
template <typename Emit>
static __device__ __forceinline__ void head_pairs(
    const uint4* __restrict__ qs, const __half* __restrict__ d16,
    const float* xs, const float* __restrict__ freq, int pos, int d, int nb,
    int n_rot, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (int p = first; 2 * p < d; p += gridDim.x * kWarps) {
    const size_t r = 2 * static_cast<size_t>(p);
    float v0 = q40_row_dot(qs + r * nb, d16 + r * nb, xs, nb, lane);
    float v1 = q40_row_dot(qs + (r + 1) * nb, d16 + (r + 1) * nb, xs, nb,
                           lane);
    if (lane == 0) {
      if (static_cast<int>(r) < n_rot) rope_pair(v0, v1, pos, __ldg(freq + p));
      emit(static_cast<int>(r), v0, v1);
    }
  }
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

// The tail from the attention output `ao` (staged by the caller, read
// coherently when kAoCoherent) to `out`: wo + residual, barrier, rmsnorm,
// w13 + silu * mul, barrier, w2 + residual. Every block calls it.
template <bool kAoCoherent>
static __device__ void tail(const TailArgs& a, const float* ao, float* sm) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  const int nb_d = a.dim / 32;
  const int nb_h = a.hid / 32;
  float* red = sm + max(nb_d, nb_h) * kBlockPad;

  stage<kAoCoherent>(sm, ao, a.dim);
  for (int r = first; r < a.dim; r += stride) {
    const size_t o = static_cast<size_t>(r) * nb_d;
    const float s = q40_row_dot(a.wo_qs + o, a.wo_d + o, sm, nb_d, lane);
    if (lane == 0) a.xnew[r] = __ldg(a.x + r) + s;
  }
  grid_barrier(a.bar);

  stage_rmsnorm<true>(sm, red, a.xnew, a.w_ffn, a.dim);
  for (int r = first; r < a.hid; r += stride) {
    const size_t o1 = static_cast<size_t>(r) * nb_d;
    const size_t o3 = static_cast<size_t>(a.hid + r) * nb_d;
    const float g = q40_row_dot(a.w13_qs + o1, a.w13_d + o1, sm, nb_d, lane);
    const float u = q40_row_dot(a.w13_qs + o3, a.w13_d + o3, sm, nb_d, lane);
    if (lane == 0) a.hb[r] = g / (1.f + expf(-g)) * u;
  }
  grid_barrier(a.bar);

  stage<true>(sm, a.hb, a.hid);
  for (int r = first; r < a.dim; r += stride) {
    const size_t o = static_cast<size_t>(r) * nb_h;
    const float s = q40_row_dot(a.w2_qs + o, a.w2_d + o, sm, nb_h, lane);
    if (lane == 0) a.out[r] = __ldcg(a.xnew + r) + s;
  }
}

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
// K8: the head
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
q40_head_kernel(const uint4* __restrict__ qs, const __half* __restrict__ d16,
                const float* __restrict__ x, const float* __restrict__ w_att,
                const float* __restrict__ freq, const int* __restrict__ pos,
                float* __restrict__ out, int d, int nb, int n_rot) {
  extern __shared__ float sm[];
  stage_rmsnorm<false>(sm, sm + nb * kBlockPad, x, w_att, nb * 32);
  head_pairs(qs, d16, sm, freq, __ldg(pos), d, nb, n_rot,
             [&](int r, float v0, float v1) {
               out[r] = v0;
               out[r + 1] = v1;
             });
}

// ---------------------------------------------------------------------------
// K9: the tail
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
q40_tail_kernel(TailArgs a, const float* __restrict__ ao) {
  extern __shared__ float sm[];
  tail<false>(a, ao, sm);
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
// them in flight a thread (stage and stage_rmsnorm, K8's and K9's, load one
// float at a time and wait on each). n is a multiple of 4, at most
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
// keys t0 .. t1 - 1: K2's online softmax (flash_decode_block), the block's
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

}  // namespace

// Each entry point launches on `stream` and returns the cudaGetLastError()
// code (0 = launched).

// K8: out (d) = the head of one layer, d = dim + 2 * kv_dim rows of wqkv
// (nb blocks each), the first n_rot = dim + kv_dim of them rotated.
extern "C" int q40_head_fused(const void* qs, const void* d16, const void* x,
                              const void* w_att, const void* freq,
                              const void* pos, void* out, int d, int nb,
                              int n_rot, void* stream) {
  if (d % 2 || n_rot % 2 || n_rot > d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = stage_floats(nb * 32, 0) * sizeof(float);
  static size_t granted[kMaxDevices];
  const cudaError_t e = opt_in_smem(q40_head_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = d / 2;
  q40_head_kernel<<<(pairs + kWarps - 1) / kWarps, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(qs), static_cast<const __half*>(d16),
      static_cast<const float*>(x), static_cast<const float*>(w_att),
      static_cast<const float*>(freq), static_cast<const int*>(pos),
      static_cast<float*>(out), d, nb, n_rot);
  return static_cast<int>(cudaGetLastError());
}

// K9: out (dim) = the tail of one layer from the attention output ao (dim)
// and the layer input x (dim); xnew (dim), hb (hid) and bar (2 zeroed
// uint32, left zeroed) are the caller's static scratch.
extern "C" int q40_tail_fused(const void* wo_qs, const void* wo_d,
                              const void* w13_qs, const void* w13_d,
                              const void* w2_qs, const void* w2_d,
                              const void* ao, const void* x,
                              const void* w_ffn, void* out, void* xnew,
                              void* hb, void* bar, int dim, int hid,
                              void* stream) {
  if (dim % 32 || hid % 32) return static_cast<int>(cudaErrorInvalidValue);
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
  const size_t smem = stage_floats(dim, hid) * sizeof(float);
  static size_t granted[kMaxDevices];
  cudaError_t e = opt_in_smem(q40_tail_kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  static GridCache grids;
  int grid = 0;
  e = coresident_grid(q40_tail_kernel, smem, grids, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_cooperative(q40_tail_kernel, grid, smem,
                         static_cast<cudaStream_t>(stream), a,
                         static_cast<const float*>(ao));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
