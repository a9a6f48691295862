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
//   * K10's attention is flash_decode_block (flash_decode.cuh), the body of
//     K2: block g < n_kv takes kv head g and its kv_mul query heads, and
//     reads keys 0..pos, the row it just wrote included, so it gives K2's
//     bits on the same q and cache. The other blocks wait at the barrier;
//     splitting the keys across them is later work.
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
      if (static_cast<int>(r) < n_rot) {
        const float ang = static_cast<float>(pos) * __ldg(freq + p);
        const float c = cosf(ang);
        const float s = sinf(ang);
        const float a = __fsub_rn(__fmul_rn(v0, c), __fmul_rn(v1, s));
        const float b = __fadd_rn(__fmul_rn(v0, s), __fmul_rn(v1, c));
        v0 = a;
        v1 = b;
      }
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

struct MegaArgs {
  const uint4* qkv_qs;
  const __half* qkv_d;
  const float* w_att;
  const float* freq;
  const int* pos;
  float* q;   // (dim) scratch: the rotated queries
  float* ao;  // (dim) scratch: the attention output
  int layer;
  int seq_len;
  int n_kv;
  int hs;
  float scale;
};

template <typename KV, int KV_MUL>
__global__ void __launch_bounds__(kThreads)
q40_mega_kernel(MegaArgs m, TailArgs a, KV* __restrict__ k_all,
                KV* __restrict__ v_all) {
  extern __shared__ float sm[];
  const int dim = a.dim;
  const int kv_dim = m.n_kv * m.hs;
  const int nb_d = dim / 32;
  const int pos = __ldg(m.pos);
  const size_t at = (static_cast<size_t>(m.layer) * m.seq_len + pos) * kv_dim;

  // phase 1: rmsnorm -> wqkv -> RoPE; q to scratch, k and v into the cache
  stage_rmsnorm<false>(sm, sm + stage_floats(dim, a.hid) - kWarps, a.x,
                       m.w_att, dim);
  head_pairs(m.qkv_qs, m.qkv_d, sm, m.freq, pos, dim + 2 * kv_dim, nb_d,
             dim + kv_dim, [&](int r, float v0, float v1) {
               if (r < dim) {
                 m.q[r] = v0;
                 m.q[r + 1] = v1;
               } else if (r < dim + kv_dim) {
                 k_all[at + r - dim] = from_float<KV>(v0);
                 k_all[at + r - dim + 1] = from_float<KV>(v1);
               } else {
                 v_all[at + r - dim - kv_dim] = from_float<KV>(v0);
                 v_all[at + r - dim - kv_dim + 1] = from_float<KV>(v1);
               }
             });
  grid_barrier(a.bar);

  // phase 2: block g attends kv head g over keys 0..pos
  const size_t q_off = static_cast<size_t>(kWarps) * KV_MUL * (m.hs + 2);
  for (int g = blockIdx.x; g < m.n_kv; g += gridDim.x) {
    const size_t head = static_cast<size_t>(g) * KV_MUL * m.hs;
    for (int i = threadIdx.x; i < KV_MUL * m.hs; i += blockDim.x) {
      sm[q_off + i] = __ldcg(m.q + head + i);
    }
    __syncthreads();
    const size_t base =
        (static_cast<size_t>(m.layer) * m.seq_len * m.n_kv + g) * m.hs;
    const FreshKeys<KV> keys{k_all + base, v_all + base,
                             static_cast<size_t>(kv_dim)};
    flash_decode_block<KV_MUL>(sm + q_off, m.ao + head, pos, m.hs, m.scale,
                               keys);
    __syncthreads();
  }
  grid_barrier(a.bar);

  // phases 3-5: the tail over the attention output
  tail<true>(a, m.ao, sm);
}

template <typename KV, int KV_MUL>
int launch_mega(const MegaArgs& m, const TailArgs& a, void* k_all,
                void* v_all, cudaStream_t stream) {
  auto kernel = q40_mega_kernel<KV, KV_MUL>;
  const size_t att = static_cast<size_t>(kWarps) * KV_MUL * (m.hs + 2) +
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
// (kv_bf16 = 0) or bf16 (1). q and ao (dim), xnew (dim), hb (hid) and bar
// are the caller's static scratch. Takes kv_mul in {1, 2, 4, 8} and hs a
// multiple of 4 up to 128.
extern "C" int q40_layer_mega(const void* qkv_qs, const void* qkv_d,
                              const void* wo_qs, const void* wo_d,
                              const void* w13_qs, const void* w13_d,
                              const void* w2_qs, const void* w2_d,
                              const void* x, const void* w_att,
                              const void* w_ffn, const void* freq,
                              const void* pos, void* k_all, void* v_all,
                              void* out, void* q, void* ao, void* xnew,
                              void* hb, void* bar, int layer, int dim,
                              int hid, int seq_len, int n_kv, int kv_mul,
                              int hs, float scale, int kv_bf16,
                              void* stream) {
  if (dim % 32 || hid % 32 || hs % 4 || hs > 128 ||
      n_kv * kv_mul * hs != dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MegaArgs m{static_cast<const uint4*>(qkv_qs),
                   static_cast<const __half*>(qkv_d),
                   static_cast<const float*>(w_att),
                   static_cast<const float*>(freq),
                   static_cast<const int*>(pos),
                   static_cast<float*>(q),
                   static_cast<float*>(ao),
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
