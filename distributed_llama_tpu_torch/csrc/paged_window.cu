// Paged attention of a window of t_len queries a row for Hopper (sm_90a):
// the speculative verify window (t_len K) and the token-budget mixed
// window (t_len T) over the page pool — K6w over f32 or bf16 pages, K7w
// over Q8 pages. The wrappers (ops/paged_attention.py) send windows of
// WINDOW_MIN_T = 3 queries and more here, and the decode step and windows
// of 2 to paged_attention.cu's split walk, which was faster there.
//
//   q (B, t_len, n_kv * kv_mul * hs) f32; pos a device (B,) int32; table a
//   device (B, max_pages) int32 of physical page ids in logical order.
//   K6w: k4, v4 (L * P, ps, n_kv, hs) f32 or bf16, layer l's physical page
//   p at row l * P + p. K7w: kq4, vq4 the same geometry in int8 Q80 codes,
//   kd4, vd4 (L * P, ps, n_kv * hs / 32) f16 block deltas, one per 32
//   values of a position's flattened head-major (n_kv, hs) row.
//   Query i of row b sits at position pos[b] + i and sees keys
//   0..min(pos[b] + i, max_pages * ps - 1) (the budget-edge clamp); key t
//   of row b lives at page row layer * P + table[b, t / ps], offset t % ps;
//   query head h reads kv head h / kv_mul, scores scaled by 1/sqrt(hs)
//   after the q.k dot, online softmax in f32.
//   out (B, t_len, n_q * hs) f32.
//
// Replaces the JAX package's ops/pallas_paged_attention.py
// paged_decode_attention_kernel (:285, _kernel_paged -> _flash_pages) and
// paged_decode_attention_kernel_q8 (:332) at those windows, and the XLA
// gather those send windows of more than 8 queries to (models/llama.py
// spec_verify_attention and mixed_attention). The Pallas kernel takes one
// row a program and moves each page into VMEM once for all t_len queries
// and kv_mul heads.
//
// Bound: the live page bytes of each (row, kv head), each key's K and V
// read once for all of its queries: 2 * (min(pos + t_len - 1, max_pages *
// ps - 1) + 1) * hs * 4 bytes a (row, kv head) for f32 pages (2 a value for
// bf16, 1 + 2 / 32 for Q8), against 4 * hs operations a (query head,
// visible key) in 3 TF32 passes (2 over bf16 pages). At 7B, 8 rows and
// pos 63 that is bytes; at pos 2047 bytes still, the products a few
// times below them. The split walk it replaces (K5's, through the table,
// one block a (row, query)) read a row's keys once for each of its t_len
// queries, 39 times over in a mixed window, and ran 4-6x slower than SDPA
// over pre-gathered pages. This is K4's design (prefill_attention.cu)
// over the page table:
//
// - block (item tile, kv head g, row b, split j) owns the (query, head)
//   items item = i * kv_mul + m of row b's window on kv head g, 16 to a
//   consumer warp (the MMA's M), up to kMaxWarps warps (64 items); the
//   item tiles of a (row, kv head) are neighbouring blocks. 7B's 32 kv
//   heads at t_len <= 64 take one tile, so each live key's K and V cross
//   device memory once a (row, kv head); a wider group's further tiles
//   read the same pages together, from L2;
// - each row's key run is cut into splits of whole 32-key tiles on the
//   card from its own position (decode_splits over tiles: at most `most`
//   splits of at least `least` keys); the grid covers the widest plan,
//   that of the clamped virtual plane, and a block past its row's plan
//   exits at once, so a captured graph follows each replay's clocks;
// - one producer warp gathers each tile through the page table into a
//   shared-memory ring with cp.async, tiles ahead of the products: lane l
//   reads the table entry of the tile's key l (the next tile's entries are
//   asked for while this tile's copies are issued), then a warp copies a
//   key's head row, 16 bytes a lane (f32 and bf16 pages, completing on the
//   stage's mbarrier); Q8 pages copy their codes and deltas into a raw
//   ring a tile ahead and the producer widens them into the f32 stage
//   as float(code) * float(delta), exactly (Q8Planes::widen's map), so
//   K7w's products are K6w's over the dequantized pool, bit for bit.
//   Keys past the row's live count copy key 0's row (finite values, p = 0);
//   dims past hs stay zero;
// - the consumer warps run K4's body: q staged in fragment order and
//   split into TF32 hi and lo as it is read; s = q k^T by mma.sync
//   m16n8k8 tf32 in 3 passes (2 over bf16 pages, exact in TF32), the
//   causal mask and the clamp per item, the online softmax, o += p v in 3
//   passes with p the A fragment as it stands. A window has few items
//   (one warp's at 7B and t_len 16), so the block's other warps are key
//   groups (window_groups): group k takes tiles k, k + G, ... of the
//   split with its own online softmax, and group 0 merges the groups in
//   group order through shared memory;
// - with several splits each writes its (unnormalised o, m, l) to the
//   static scratch, and the last split of an (item tile, kv head, row) to
//   arrive (its ticket) merges them in split order (m = max m_j, w_j =
//   e^(m_j - m), l = sum l_j w_j, o = sum o_j w_j, out = o / l) and resets
//   the ticket; the bits do not depend on which block ends last.
//
// ops/paged_attention.paged_window_model models the arithmetic.
// Shared memory: 8 KB of q fragments an item warp, a ring of 2 to 6
// stages of 32 keys (33 KB f32 or widened Q8, 17 KB bf16) and Q8's raw
// ring; two blocks an SM where two fit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "flash_decode.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

enum PageKind { kF32Pages = 0, kBf16Pages = 1, kQ8Pages = 2 };

constexpr int kMaxWarps = 4;   // consumer warps a block (up to 64 items)
constexpr int kKeys = 32;      // keys a staged tile
constexpr int kHs = 128;       // dims a block computes (hs <= kHs)
constexpr int kHs8 = kHs / 8;  // k8 steps of q.k, n8 tiles of p.v
constexpr int kQWarpBytes = 16 * kHs * 4;  // a warp's q fragments
constexpr int kRawStages = 2;              // Q8: raw tiles in flight
// a block's most dynamic shared memory: 227 KB less room for the
// kernel's static `last` flag
constexpr size_t kSmemCap = 232448 - 1024;
constexpr size_t kHalfSm = 113 * 1024;     // two blocks an SM

// A staged tile by page kind: f32 rows for f32 pages and widened Q8
// pages, bf16 rows for bf16 pages, each padded 16 bytes past kHs (the
// fragment reads stay off shared bank conflicts, as K4's).
template <int KIND>
struct Stage {
  using KV = std::conditional_t<KIND == kBf16Pages, __nv_bfloat16, float>;
  static constexpr bool kF32 = KIND != kBf16Pages;
  static constexpr int kLd = kHs + 16 / static_cast<int>(sizeof(KV));
  static constexpr int kBytes = 2 * kKeys * kLd * sizeof(KV);  // K, V
  // Q8's raw tile: K codes, V codes (kKeys x kHs bytes), then K deltas,
  // V deltas (kKeys x kHs / 32 f16)
  static constexpr int kCodeBytes = kKeys * kHs;
  static constexpr int kDeltaBytes = kKeys * kHs / 16;
  static constexpr int kRawBytes =
      KIND == kQ8Pages ? 2 * (kCodeBytes + kDeltaBytes) : 0;
};

template <int KIND>
__host__ __device__ constexpr size_t window_smem(int warps, int stages) {
  return static_cast<size_t>(warps) * kQWarpBytes +
         static_cast<size_t>(stages) * Stage<KIND>::kBytes +
         static_cast<size_t>(kRawStages) * Stage<KIND>::kRawBytes +
         2 * stages * 8 + 128;
}

// Key groups by item warps: two at one or two item warps, one above;
// three at one over bf16 pages, whose stages are half as wide. Over Q8
// pages a third group leaves room for one block an SM, not two (the raw
// ring), and f32 pages must sum as Q8 pages do (K7w gives K6w's bits over
// the dequantized pool), so both take two. tools/window_variants.py times
// the others (PERF.md); WINDOW_GROUPS and WINDOW_STAGES override
// the rule and the ring's stages (the tool builds such variants).
template <int KIND>
__host__ __device__ constexpr int window_groups(int warps) {
  return warps == 1 ? (KIND == kBf16Pages ? 3 : 2) : warps == 2 ? 2 : 1;
}

// The ring's stages for `groups` key groups: a multiple of the groups, so
// that stage s only ever holds the tiles of group s % groups (a group
// waiting on a stage is then never a phase ahead of it: an mbarrier's
// parity names a phase only while its waiter is at most one behind); as
// many (up to 6) as leave room for two blocks an SM where that many
// stages do, else as many as one block holds, and at least `groups` (two
// for one group, so a tile lands while the one before it is used).
template <int KIND>
int window_stages(int warps, int groups) {
  const size_t cap =
      window_smem<KIND>(warps, groups > 1 ? groups : 2) <= kHalfSm
          ? kHalfSm
          : kSmemCap;
  const int least = groups > 1 ? groups : 2;
  int stages = 6 / least * least;
  while (stages > least && window_smem<KIND>(warps, stages) > cap) {
    stages -= least;
  }
#ifdef WINDOW_STAGES
  stages = WINDOW_STAGES;
#endif
  return stages;
}

static __device__ __forceinline__ float as_f32(float v) { return v; }

static __device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The TF32 split of a B fragment (b0, b1): f32 values take hi and lo,
// bf16 values are exact in TF32 (lo stays unused). K4's.
template <bool kF32>
static __device__ __forceinline__ void split_b(float b0, float b1,
                                               uint32_t (&hi)[2],
                                               uint32_t (&lo)[2]) {
  if constexpr (kF32) {
    hi[0] = tf32_rna(b0);
    hi[1] = tf32_rna(b1);
    lo[0] = tf32_rna(b0 - __uint_as_float(hi[0]));
    lo[1] = tf32_rna(b1 - __uint_as_float(hi[1]));
  } else {
    hi[0] = __float_as_uint(b0);
    hi[1] = __float_as_uint(b1);
  }
}

// The 3xTF32 product into `big` (a_hi.b_hi) and `small` (a_hi.b_lo +
// a_lo.b_hi); over bf16 values two passes. K4's.
template <bool kF32>
static __device__ __forceinline__ void mma_3x(float (&big)[4],
                                              float (&small)[4],
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              const uint32_t (&bh)[2],
                                              const uint32_t (&bl)[2]) {
  mma_tf32(big, ah, bh[0], bh[1]);
  if constexpr (kF32) mma_tf32(small, ah, bl[0], bl[1]);
  mma_tf32(small, al, bh[0], bh[1]);
}

// The consumer warps' own barrier (the producer warp has left by then).
static __device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Q8 widening of four codes and their delta: float(code) * float(delta),
// each signed byte biased by 128 and permuted under 2^23's exponent
// (paged_attention.cu Q8Planes::widen).
static __device__ __forceinline__ float4 widen_q8(uint32_t codes,
                                                  __half delta) {
  const uint32_t b = codes ^ 0x80808080u;
  const float d = __half2float(delta);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = (__int_as_float(__byte_perm(b, 0x4B000000u, 0x7440u + k)) -
            8388736.0f) *
           d;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

struct WindowArgs {
  const float* q;
  float* out;
  float* part;     // the splits' o, then their (m, l)
  int* tickets;    // (batch, n_kv, n_it) zeros between launches
  const int* pos;  // (batch,) device positions
  const int* table;
  const void* k;   // K6w: k4, v4; K7w: kq4, vq4 and kd4, vd4
  const void* v;
  const __half* kd;
  const __half* vd;
  int layer_base;  // layer * n_pages
  int batch;
  int t_len;
  int max_pages;
  int ps;
  int n_kv;
  int kv_mul;
  int hs;
  int most;
  int least_tiles;  // the plan's least keys a split, in whole tiles
  int warps;        // item warps a block (16 items each)
  int n_it;         // item tiles a (row, kv head)
  int stages;
  float scale;
};

// The producer warp: tile i of the block's run into stage i % stages.
// Lane l holds the pool position of key l of the tile (key 0's past the
// row's live keys).
template <int KIND>
static __device__ __forceinline__ void produce(const WindowArgs& a,
                                               uint8_t* ring, uint8_t* raw,
                                               uint64_t* full,
                                               uint64_t* empty, int g,
                                               int b, int keys, int tile0,
                                               int tile1, int lane) {
  using St = Stage<KIND>;
  using KV = typename St::KV;
  constexpr int kLd = St::kLd;
  const int S = a.stages;
  const int hs = a.hs;
  const int* row_table = a.table + static_cast<size_t>(b) * a.max_pages;
  const size_t row = static_cast<size_t>(a.n_kv) * hs;  // values a position
  auto position = [&](int tile) -> int {
    const int t = tile * kKeys + lane;
    const int key = t < keys ? t : 0;
    const int e = key / a.ps;
    return (a.layer_base + __ldg(row_table + e)) * a.ps + (key - e * a.ps);
  };
  int p = position(tile0);
  if constexpr (KIND != kQ8Pages) {
    const KV* kb = static_cast<const KV*>(a.k) + static_cast<size_t>(g) * hs;
    const KV* vb = static_cast<const KV*>(a.v) + static_cast<size_t>(g) * hs;
    // 16-byte chunks: f32 rows a warp a key, bf16 rows half a warp a key
    constexpr int kPer = 16 / sizeof(KV);  // values a chunk
    constexpr int kRows = sizeof(KV) == 4 ? 1 : 2;  // keys an instruction
    const int chunks = hs / kPer;
    const int sub = kRows == 1 ? 0 : lane >> 4;
    const int c = kRows == 1 ? lane : lane & 15;
    for (int i = 0; tile0 + i < tile1; ++i) {
      const int slot = i % S;
      const int p_next = tile0 + i + 1 < tile1 ? position(tile0 + i + 1) : 0;
      mbar_wait(&empty[slot], ((i / S) & 1) ^ 1);
      KV* ks = reinterpret_cast<KV*>(ring + slot * St::kBytes);
      KV* vs = ks + kKeys * kLd;
#pragma unroll 8
      for (int kk = 0; kk < kKeys; kk += kRows) {
        const int key = kk + sub;
        const size_t src =
            static_cast<size_t>(__shfl_sync(0xffffffffu, p, key)) * row +
            kPer * c;
        if (c < chunks) {
          cp_async16(ks + key * kLd + kPer * c, kb + src);
          cp_async16(vs + key * kLd + kPer * c, vb + src);
        }
      }
      cp_async_arrive(&full[slot]);
      p = p_next;
    }
  } else {
    const int8_t* kq = static_cast<const int8_t*>(a.k) +
                       static_cast<size_t>(g) * hs;
    const int8_t* vq = static_cast<const int8_t*>(a.v) +
                       static_cast<size_t>(g) * hs;
    const int nb = a.n_kv * hs / 32;  // deltas a position
    const int dw = hs / 64;           // 4-byte delta words a head row
    const int chunks = hs / 16;       // 16-byte code chunks a head row
    const int sub = lane >> 3;        // four keys an instruction
    const int c = lane & 7;
    // tile `tile`'s codes and deltas into raw stage rs, one commit group
    auto issue = [&](int rs) {
      uint8_t* r = raw + rs * St::kRawBytes;
#pragma unroll
      for (int kk = 0; kk < kKeys; kk += 4) {
        const int key = kk + sub;
        const size_t src =
            static_cast<size_t>(__shfl_sync(0xffffffffu, p, key)) * row +
            16 * c;
        if (c < chunks) {
          cp_async16(r + key * kHs + 16 * c, kq + src);
          cp_async16(r + St::kCodeBytes + key * kHs + 16 * c, vq + src);
        }
      }
      const size_t d0 = static_cast<size_t>(p) * nb + g * hs / 32;
      uint8_t* rd = r + 2 * St::kCodeBytes + lane * (kHs / 16);
      for (int w = 0; w < dw; ++w) {
        cp_async4(rd + 4 * w, a.kd + d0 + 2 * w);
        cp_async4(rd + St::kDeltaBytes + 4 * w, a.vd + d0 + 2 * w);
      }
    };
    int next = tile0;  // the next tile to issue
    for (int r = 0; r < kRawStages - 1; ++r) {
      if (next < tile1) {
        issue((next - tile0) % kRawStages);
        ++next;
        p = next < tile1 ? position(next) : 0;
      }
      cp_async_commit();
    }
    for (int i = 0; tile0 + i < tile1; ++i) {
      if (next < tile1) {
        issue((next - tile0) % kRawStages);
        ++next;
        p = next < tile1 ? position(next) : 0;
      }
      cp_async_commit();
      cp_async_wait<kRawStages - 1>();  // tile i's copies have landed
      __syncwarp();
      const int slot = i % S;
      mbar_wait(&empty[slot], ((i / S) & 1) ^ 1);
      const uint8_t* r = raw + (i % kRawStages) * St::kRawBytes;
      float* ks = reinterpret_cast<float*>(ring + slot * St::kBytes);
      if (4 * lane < hs) {
#pragma unroll 4
        for (int key = 0; key < kKeys; ++key) {
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const uint32_t codes = *reinterpret_cast<const uint32_t*>(
                r + kv * St::kCodeBytes + key * kHs + 4 * lane);
            const __half delta = *reinterpret_cast<const __half*>(
                r + 2 * St::kCodeBytes + kv * St::kDeltaBytes +
                key * (kHs / 16) + 2 * (lane >> 3));
            *reinterpret_cast<float4*>(ks + (kv * kKeys + key) * kLd +
                                       4 * lane) = widen_q8(codes, delta);
          }
        }
      }
      mbar_arrive(&full[slot]);
      __syncwarp();  // every lane done with the raw stage before refills
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 2)
paged_window_kernel(WindowArgs a) {
  using St = Stage<KIND>;
  using KV = typename St::KV;
  constexpr int kLd = St::kLd;
  const int W = a.warps;  // item warps: 16 items each
  const int G = (blockDim.x / 32 - 1) / W;  // key groups
  const int n_cons = 32 * W * G;            // consumer threads
  const int S = a.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((128u - (cta_addr(smem_raw) & 127u)) & 127u);
  float4* q_s = reinterpret_cast<float4*>(sm);
  uint8_t* ring = sm + W * kQWarpBytes;
  uint8_t* raw = ring + S * St::kBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(raw + kRawStages * St::kRawBytes);
  uint64_t* empty = full + S;

  const int it = blockIdx.x % a.n_it;
  const int g = blockIdx.x / a.n_it;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int hs = a.hs;
  const int kv_mul = a.kv_mul;
  const int n_q = a.n_kv * kv_mul;
  const int n_items = a.t_len * kv_mul;
  const int item0 = it * 16 * W;
  const int s_virt = a.max_pages * a.ps;
  const int pos = __ldg(a.pos + b);
  // the row's live keys: those of its deepest query, clamped
  const int keys = min(pos + a.t_len - 1, s_virt - 1) + 1;
  const int tiles = (keys + kKeys - 1) / kKeys;
  int splits, per;
  decode_splits(tiles, a.most, a.least_tiles, splits, per);
  if (j >= splits) return;
  const int tile0 = j * per;
  const int tile1 = min(tiles, tile0 + per);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 32);  // the producer's lanes
      mbar_init(&empty[i], 32 * W);  // one key group's warps
    }
    mbar_fence_init();
  }
  if (hs < kHs) {  // dims past hs read zeros (never copied)
    uint4* r = reinterpret_cast<uint4*>(ring);
    for (int i = threadIdx.x; i < S * St::kBytes / 16; i += blockDim.x) {
      r[i] = make_uint4(0, 0, 0, 0);
    }
  }
  // the q fragments of item warp mt in fragment order: float4 (mt * kHs8
  // + k8 step) * 32 + lane holds a0..a3 of the step, so a warp's read is
  // 512 contiguous bytes; the consumers split them into TF32 hi and lo as
  // they read them (staging both took two blocks an SM off wider
  // windows). Every thread loads whole 16-byte pieces of the items' q rows
  // (a row's hs values are contiguous) and stores each value at its
  // fragment place: an item's row read as scattered single values cost
  // more than a tile of keys. Items past the window and dims past hs are
  // zeros, computed and never stored.
  {
    float* qv = reinterpret_cast<float*>(q_s);
    for (int x = threadIdx.x; x < 16 * W * (kHs / 4); x += blockDim.x) {
      const int r = x / (kHs / 4);  // the block's item row
      const int c4 = x - r * (kHs / 4);
      const int item = item0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (item < n_items && 4 * c4 < hs) {
        const int qi = item / kv_mul;
        const int m = item - qi * kv_mul;
        v = __ldg(reinterpret_cast<const float4*>(
                      a.q + ((static_cast<size_t>(b) * a.t_len + qi) * n_q +
                             g * kv_mul + m) * hs) + c4);
      }
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const int rr = r & 15;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = 4 * c4 + k;
        const int lane_of = (rr & 7) * 4 + (d & 3);
        const int e = (rr >> 3) + 2 * ((d >> 2) & 1);
        qv[(((r >> 4) * kHs8 + (d >> 3)) * 32 + lane_of) * 4 + e] = vv[k];
      }
    }
  }
  __syncthreads();

  if (warp == W * G) {
    produce<KIND>(a, ring, raw, full, empty, g, b, keys, tile0, tile1, lane);
    return;
  }

  // consumer warp (item warp mt, key group kg) takes the tiles kg, kg + G,
  // ... of the split; this thread's two accumulator rows are items a (row
  // gq) and b (row gq + 8), each seeing keys up to its query's clamped
  // position
  const int mt = warp % W;
  const int kg = warp / W;
  const int gq = lane >> 2;
  const int cq = lane & 3;
  const int item_a = item0 + mt * 16 + gq;
  const int item_b = item_a + 8;
  const int lim_a = min(pos + min(item_a / kv_mul, a.t_len - 1), s_virt - 1);
  const int lim_b = min(pos + min(item_b / kv_mul, a.t_len - 1), s_virt - 1);
  const float4* qf = q_s + mt * kHs8 * 32 + lane;
  const float scale = a.scale;

  float o[kHs8][4];
#pragma unroll
  for (int jj = 0; jj < kHs8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jj][e] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int i = kg; tile0 + i < tile1; i += G) {
    const int slot = i % S;
    mbar_wait(&full[slot], (i / S) & 1);
    const KV* ks = reinterpret_cast<const KV*>(ring + slot * St::kBytes);
    const KV* vs = ks + kKeys * kLd;
    const int k0 = (tile0 + i) * kKeys;

    // s = q k^T over the tile: 4 n8 tiles of keys; B fragment of key
    // 8jj + gq, dims 8kq + cq and + 4
    float s[kKeys / 8][4], sc[kKeys / 8][4];
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = sc[jj][e] = 0.f;
    }
#pragma unroll
    for (int kq = 0; kq < kHs8; ++kq) {
      const float4 q4 = qf[32 * kq];
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = tf32_rna(qv[e]);
        al[e] = tf32_rna(qv[e] - __uint_as_float(ah[e]));
      }
#pragma unroll
      for (int jj = 0; jj < kKeys / 8; ++jj) {
        const KV* p = ks + (8 * jj + gq) * kLd + 8 * kq + cq;
        uint32_t bh[2], bl[2];
        split_b<St::kF32>(as_f32(p[0]), as_f32(p[4]), bh, bl);
        mma_3x<St::kF32>(s[jj], sc[jj], ah, al, bh, bl);
      }
    }

    // scale after the dot, the causal mask and the clamp per item, the
    // online softmax (a quad's four lanes hold a row's keys of the tile)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
      const int key = k0 + jj * 8 + 2 * cq;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] += sc[jj][e];
      s[jj][0] = key <= lim_a ? s[jj][0] * scale : -INFINITY;
      s[jj][1] = key + 1 <= lim_a ? s[jj][1] * scale : -INFINITY;
      s[jj][2] = key <= lim_b ? s[jj][2] * scale : -INFINITY;
      s[jj][3] = key + 1 <= lim_b ? s[jj][3] * scale : -INFINITY;
      mx_a = fmaxf(mx_a, fmaxf(s[jj][0], s[jj][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[jj][2], s[jj][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // a split may hold no key an item can see: its max stays -inf and exp
    // takes 0 as the base, so p = 0 and nothing is corrected
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = expf(m_a - base_a);
    const float corr_b = expf(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
      s[jj][0] = expf(s[jj][0] - base_a);
      s[jj][1] = expf(s[jj][1] - base_a);
      s[jj][2] = expf(s[jj][2] - base_b);
      s[jj][3] = expf(s[jj][3] - base_b);
      sum_a += s[jj][0] + s[jj][1];
      sum_b += s[jj][2] + s[jj][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int jj = 0; jj < kHs8; ++jj) {
      o[jj][0] *= corr_a;
      o[jj][1] *= corr_a;
      o[jj][2] *= corr_b;
      o[jj][3] *= corr_b;
    }

    // o += p v, k8 step jj over keys 8jj..8jj+7: slot cq holds key
    // 8jj + 2cq, slot cq + 4 key 8jj + 2cq + 1, so the score accumulators
    // are the A fragment as they stand
#pragma unroll
    for (int jj = 0; jj < kKeys / 8; ++jj) {
      const float pv[4] = {s[jj][0], s[jj][2], s[jj][1], s[jj][3]};
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[e] = tf32_rna(pv[e]);
        pl[e] = tf32_rna(pv[e] - __uint_as_float(ph[e]));
      }
      const KV* p = vs + (8 * jj + 2 * cq) * kLd + gq;
#pragma unroll
      for (int dj = 0; dj < kHs8; ++dj) {
        float oc[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t bh[2], bl[2];
        split_b<St::kF32>(as_f32(p[8 * dj]), as_f32(p[8 * dj + kLd]), bh,
                          bl);
        mma_3x<St::kF32>(o[dj], oc, ph, pl, bh, bl);
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
  if (G > 1) {
    // the key groups merged in group order through shared memory (the
    // ring's room, every tile consumed): group k's (m, l) and, past group
    // 0, its o in fragment order; group 0 takes M = max m_k, w_k =
    // e^(m_k - M) (base 0 while M is -inf: a split no key of which an
    // item sees), l = sum l_k w_k, o = sum o_k w_k
    float* xo = reinterpret_cast<float*>(ring);  // (G - 1, W, kHs8, 32, 4)
    float* xm = xo + (G - 1) * W * kHs8 * 128;   // (G, W * 16)
    float* xl = xm + G * W * 16;                 // (G, W * 16)
    consumers_sync(n_cons);
    if (kg > 0) {
      float4* dst = reinterpret_cast<float4*>(xo) +
                    ((kg - 1) * W + mt) * kHs8 * 32 + lane;
#pragma unroll
      for (int jj = 0; jj < kHs8; ++jj) {
        dst[jj * 32] = make_float4(o[jj][0], o[jj][1], o[jj][2], o[jj][3]);
      }
    }
    if (cq == 0) {
      xm[kg * W * 16 + mt * 16 + gq] = m_a;
      xm[kg * W * 16 + mt * 16 + gq + 8] = m_b;
      xl[kg * W * 16 + mt * 16 + gq] = l_a;
      xl[kg * W * 16 + mt * 16 + gq + 8] = l_b;
    }
    consumers_sync(n_cons);
    if (kg == 0) {
      const int ra = mt * 16 + gq;
      const int rb = ra + 8;
      float ma = -INFINITY, mb = -INFINITY;
      for (int k = 0; k < G; ++k) {
        ma = fmaxf(ma, xm[k * W * 16 + ra]);
        mb = fmaxf(mb, xm[k * W * 16 + rb]);
      }
      const float base_a = ma == -INFINITY ? 0.f : ma;
      const float base_b = mb == -INFINITY ? 0.f : mb;
      const float w0a = expf(m_a - base_a);
      const float w0b = expf(m_b - base_b);
      l_a *= w0a;
      l_b *= w0b;
#pragma unroll
      for (int jj = 0; jj < kHs8; ++jj) {
        o[jj][0] *= w0a;
        o[jj][1] *= w0a;
        o[jj][2] *= w0b;
        o[jj][3] *= w0b;
      }
      for (int k = 1; k < G; ++k) {
        const float wa = expf(xm[k * W * 16 + ra] - base_a);
        const float wb = expf(xm[k * W * 16 + rb] - base_b);
        l_a += xl[k * W * 16 + ra] * wa;
        l_b += xl[k * W * 16 + rb] * wb;
        const float4* src = reinterpret_cast<const float4*>(xo) +
                            ((k - 1) * W + mt) * kHs8 * 32 + lane;
#pragma unroll
        for (int jj = 0; jj < kHs8; ++jj) {
          const float4 x = src[jj * 32];
          o[jj][0] += x.x * wa;
          o[jj][1] += x.y * wa;
          o[jj][2] += x.z * wb;
          o[jj][3] += x.w * wb;
        }
      }
      m_a = ma;
      m_b = mb;
    }
  }
  const size_t bg = static_cast<size_t>(b) * a.n_kv + g;
  if (splits == 1) {
    if (kg > 0) return;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int item = hb ? item_b : item_a;
      if (item >= n_items) continue;
      const int qi = item / kv_mul;
      const int m = item - qi * kv_mul;
      const float l = hb ? l_b : l_a;
      float* dst = a.out +
                   ((static_cast<size_t>(b) * a.t_len + qi) * n_q +
                    g * kv_mul + m) * hs + 2 * cq;
#pragma unroll
      for (int jj = 0; jj < kHs8; ++jj) {
        if (8 * jj < hs) {
          *reinterpret_cast<float2*>(dst + 8 * jj) =
              make_float2(o[jj][2 * hb] / l, o[jj][2 * hb + 1] / l);
        }
      }
    }
    return;
  }

  // split j's partials: o (batch, n_kv, items, most, hs), then (m, l)
  const size_t o_all =
      static_cast<size_t>(a.batch) * a.n_kv * n_items * a.most * hs;
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int item = hb ? item_b : item_a;
    if (kg > 0 || item >= n_items) continue;
    const size_t at = (bg * n_items + item) * a.most + j;
    float* dst = a.part + at * hs + 2 * cq;
#pragma unroll
    for (int jj = 0; jj < kHs8; ++jj) {
      if (8 * jj < hs) {
        *reinterpret_cast<float2*>(dst + 8 * jj) =
            make_float2(o[jj][2 * hb], o[jj][2 * hb + 1]);
      }
    }
    if (cq == 0) {
      a.part[o_all + 2 * at] = hb ? m_b : m_a;
      a.part[o_all + 2 * at + 1] = hb ? l_b : l_a;
    }
  }
  __shared__ int last;
  int* ticket = a.tickets + bg * a.n_it + it;
  __threadfence();  // this split's partials, before its ticket
  consumers_sync(n_cons);
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == splits - 1;
  consumers_sync(n_cons);
  if (!last) return;
  __threadfence();
  // the merge, in split order: every split's (m_j, l_j) of the block's
  // items into shared memory at once (the ring's room: every tile is
  // consumed), each item's weights e^(m_j - m) and l, then 4 values of an
  // item a thread, their splits' partials asked 4 splits at a time (one
  // L2 round trip a value a split cost more than the splits' own walks)
  const int n_valid = min(16 * W, n_items - item0);
  float* sm_w = reinterpret_cast<float*>(ring);  // (n_valid, kMaxSplits)
  float* sm_lj = sm_w + 16 * W * kMaxSplits;     // (n_valid, kMaxSplits)
  float* sm_l = sm_lj + 16 * W * kMaxSplits;     // (n_valid)
  const size_t at0 = (bg * n_items + item0) * a.most;
  for (int x = threadIdx.x; x < n_valid * splits; x += n_cons) {
    const int r = x / splits;
    const int s = x - r * splits;
    const float* ml = a.part + o_all + 2 * (at0 + r * a.most + s);
    sm_w[r * kMaxSplits + s] = __ldcg(ml);
    sm_lj[r * kMaxSplits + s] = __ldcg(ml + 1);
  }
  consumers_sync(n_cons);
  for (int r = threadIdx.x; r < n_valid; r += n_cons) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, sm_w[r * kMaxSplits + s]);
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(sm_w[r * kMaxSplits + s] - mx);
      sm_w[r * kMaxSplits + s] = w;
      lsum += sm_lj[r * kMaxSplits + s] * w;
    }
    sm_l[r] = lsum;
  }
  consumers_sync(n_cons);
  const int hs4 = hs / 4;
  for (int x = threadIdx.x; x < n_valid * hs4; x += n_cons) {
    const int r = x / hs4;
    const int d4 = x - r * hs4;
    const float4* po =
        reinterpret_cast<const float4*>(a.part + (at0 + r * a.most) * hs) +
        d4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float4 v = __ldcg(po + static_cast<size_t>(s) * hs4);
      const float w = sm_w[r * kMaxSplits + s];
      acc.x += v.x * w;
      acc.y += v.y * w;
      acc.z += v.z * w;
      acc.w += v.w * w;
    }
    const float l = sm_l[r];
    const int item = item0 + r;
    const int qi = item / kv_mul;
    const int m = item - qi * kv_mul;
    reinterpret_cast<float4*>(
        a.out + ((static_cast<size_t>(b) * a.t_len + qi) * n_q + g * kv_mul +
                 m) * hs)[d4] =
        make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

template <int KIND>
int launch(WindowArgs a, cudaStream_t stream) {
  const int n_items = a.t_len * a.kv_mul;
  const int warps =
      n_items >= 16 * kMaxWarps ? kMaxWarps : (n_items + 15) / 16;
#ifdef WINDOW_GROUPS
  const int groups = WINDOW_GROUPS;
#else
  const int groups = window_groups<KIND>(warps);
#endif
  a.warps = warps;
  a.n_it = (n_items + 16 * warps - 1) / (16 * warps);
  a.stages = window_stages<KIND>(warps, groups);
  // the opt-in at a block's most, once a device, so no later size (other
  // warps, other stages) makes a call, none during a graph capture
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(paged_window_kernel<KIND>, kSmemCap, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the widest plan: that of the clamped virtual plane's tiles
  const int tiles = (a.max_pages * a.ps + kKeys - 1) / kKeys;
  const int splits = decode_want(tiles, a.most, a.least_tiles);
  paged_window_kernel<KIND>
      <<<dim3(a.n_kv * a.n_it, a.batch, splits), 32 * (warps * groups + 1),
         window_smem<KIND>(warps, a.stages), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int dispatch(const void* q, const void* k, const void* v, const void* kd,
             const void* vd, void* out, void* part, void* tickets, int layer,
             const void* pos, const void* table, int batch, int t_len,
             int n_pages, int max_pages, int ps, int n_kv, int kv_mul,
             int hs, int most, int least, float scale, void* stream) {
  // the layer's pool positions, which the walk holds as ints
  const long long positions =
      (static_cast<long long>(layer) * n_pages + n_pages) * ps;
  if (hs % 8 != 0 || hs < 8 || hs > kHs ||
      (KIND == kQ8Pages && hs % 64 != 0) || batch < 1 || batch > 65535 ||
      t_len < 1 || static_cast<long long>(batch) * t_len > 65535 ||
      ps < 1 || max_pages < 1 || n_pages < 1 || n_kv < 1 ||
      (kv_mul != 1 && kv_mul != 2 && kv_mul != 4 && kv_mul != 8) ||
      most < 1 || most > kMaxSplits || least < 1 ||
      positions > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WindowArgs a{static_cast<const float*>(q),
               static_cast<float*>(out),
               static_cast<float*>(part),
               static_cast<int*>(tickets),
               static_cast<const int*>(pos),
               static_cast<const int*>(table),
               k,
               v,
               static_cast<const __half*>(kd),
               static_cast<const __half*>(vd),
               layer * n_pages,
               batch,
               t_len,
               max_pages,
               ps,
               n_kv,
               kv_mul,
               hs,
               most,
               (least + kKeys - 1) / kKeys,
               1,
               1,
               2,
               scale};
  return launch<KIND>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 8 up to 128, t_len >= 1
// with batch * t_len <= 65535, and the plan (most, least) with 1 <= most <=
// 32 splits of at least `least` keys (whole tiles of 32); `part` holds
// batch * t_len * n_kv * most * kv_mul * (hs + 2) floats and `tickets`
// batch * t_len * n_kv zeroed int32 (both untouched under a one-split
// plan): the scratch of paged_attention.cu at batch * t_len rows. K6w
// over f32 pages:
extern "C" int paged_window(const void* q, const void* k4, const void* v4,
                            void* out, void* part, void* tickets, int layer,
                            const void* pos, const void* table, int batch,
                            int t_len, int n_pages, int max_pages, int ps,
                            int n_kv, int kv_mul, int hs, int most,
                            int least, float scale, void* stream) {
  return dispatch<kF32Pages>(q, k4, v4, nullptr, nullptr, out, part,
                             tickets, layer, pos, table, batch, t_len,
                             n_pages, max_pages, ps, n_kv, kv_mul, hs, most,
                             least, scale, stream);
}

// K6w over bf16 pages:
extern "C" int paged_window_kvbf16(const void* q, const void* k4,
                                   const void* v4, void* out, void* part,
                                   void* tickets, int layer, const void* pos,
                                   const void* table, int batch, int t_len,
                                   int n_pages, int max_pages, int ps,
                                   int n_kv, int kv_mul, int hs, int most,
                                   int least, float scale, void* stream) {
  return dispatch<kBf16Pages>(q, k4, v4, nullptr, nullptr, out, part,
                              tickets, layer, pos, table, batch, t_len,
                              n_pages, max_pages, ps, n_kv, kv_mul, hs, most,
                              least, scale, stream);
}

// K7w over Q8 pages; hs a multiple of 64 (a head's deltas are whole
// 4-byte words).
extern "C" int paged_window_q8(const void* q, const void* kq4,
                               const void* kd4, const void* vq4,
                               const void* vd4, void* out, void* part,
                               void* tickets, int layer, const void* pos,
                               const void* table, int batch, int t_len,
                               int n_pages, int max_pages, int ps, int n_kv,
                               int kv_mul, int hs, int most, int least,
                               float scale, void* stream) {
  return dispatch<kQ8Pages>(q, kq4, vq4, kd4, vd4, out, part, tickets, layer,
                            pos, table, batch, t_len, n_pages, max_pages, ps,
                            n_kv, kv_mul, hs, most, least, scale, stream);
}
