// Paged flash-decode attention for Hopper (sm_90a): t_len queries per row
// against the row's live keys in the page pool, reached through its page
// table — K6 over f32 or bf16 pages, K7 over Q8 pages.
//
//   q (B, t_len, n_kv * kv_mul * hs) f32; pos a device (B,) int32; table a
//   device (B, max_pages) int32 of physical page ids in logical order.
//   K6: k4, v4 (L * P, ps, n_kv, hs) f32 or bf16, layer l's physical page p
//   at row l * P + p. K7: kq4, vq4 the same geometry in int8 Q80 codes,
//   kd4, vd4 (L * P, ps, n_kv * hs / 32) f16 block deltas, one per 32
//   values of a position's flattened head-major (n_kv, hs) row.
//   Query i of row b sits at position pos[b] + i and sees keys
//   0..min(pos[b] + i, max_pages * ps - 1): the budget-edge clamp of a
//   verify window whose tail runs past the row's virtual plane. t_len is
//   1 for a decode step, K for a speculative verify window and the
//   dispatch budget T for a token-budget mixed window; each (row, query)
//   is its own grid row, so any t_len with batch * t_len <= 65535 runs.
//   Key t of row b lives at page row layer * P + table[b, t / ps],
//   offset t % ps.
//   out (B, t_len, n_q * hs) f32.
//
// Replaces the JAX package's ops/pallas_paged_attention.py
// paged_decode_attention_kernel (K6: _kernel_paged -> _flash_pages) and
// paged_decode_attention_kernel_q8 (K7: _kernel_paged_q8), which walk the
// table with double-buffered page DMAs.
//
// Bound: the live page bytes, each key's K and V read once: 2 * (pos + i +
// 1) * n_kv * hs * 4 per row, query and layer for f32 pages (2 bytes per
// value for bf16; n_kv * hs + 2 * n_kv * hs / 32 per position for Q8). The
// first design ran one block per (kv head, row, query) over all of its
// keys, one key in flight a warp behind a dependent page-table read, every
// lane computing every head's softmax: 8 blocks at B = 1 over 8 GQA kv
// heads, 4-5x its bound at pos 2047. So this is K5's walk
// (flash_decode.cuh) with the paged key address as the only change:
//
// - block (g, b * t_len + i, j) takes split j of kv head g for query i of
//   row b. Each block computes its (row, query)'s plan on the card from
//   its key count (decode_splits: at most `most` splits, each of at least
//   `least` keys); the grid covers the widest plan, that of the clamped
//   virtual plane (max_pages * ps keys), and a block past its plan exits
//   at once, so rows and queries with other clocks get their own plans
//   and a captured graph follows each replay's clocks;
// - a warp asks the page table for a batch of kAhead keys' pages (__ldg),
//   then issues their K and V loads, and only then widens the keys and
//   takes them through flash_step (above KV_MUL 1 the next batch's pages
//   are asked while this batch's loads fly); a cursor (page entry,
//   offset) follows the warp's keys, kWarps apart, without a division a
//   key (over 8 GQA kv heads the walk is held by instructions a key, not
//   bytes: a division a key cost 10-17% there on the H100);
// - the splits merge in split order behind a ticket of their (row * t_len
//   + query, kv head) in the same launch (flash_finish).
//
// The keys of a split are summed in logical order exactly as K5 sums them
// under the same plan, so at t_len 1, over a pool that holds a contiguous
// cache's values, K6 gives K5's bits under every plan, and any permutation
// of the physical pages gives the same bits. K7's loader reads each lane's
// four codes and its block's one f16 delta and widens them as
// float(code) * float(delta), the JAX package's value map (exact in f32;
// Q8Planes); the f32 math then runs unchanged, so K7 equals K6 bit for bit
// over a pool that holds the dequantized values.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_decode.cuh"

namespace {

enum PageKind { kF32Pages = 0, kBf16Pages = 1, kQ8Pages = 2 };

// Keys in flight a warp by page kind (rows: f32, bf16, Q8) and KV_MUL
// (columns: 1, 2, 4, 8), from tools/plan_sweep.py on the H100: the
// fastest of 1, 2, 4 and 8 at 7B's and 2, 4 and 8 GQA kv heads' widths,
// B = 1 and 8, pos 63 and 2047, short of a spill (-Xptxas -v; f32 spilled
// at 4 under KV_MUL 1's 64 registers); PAGED_KEYS_AHEAD overrides the
// table (the sweep builds such variants).
template <int KIND, int KV_MUL>
__host__ __device__ constexpr int paged_keys_ahead() {
#ifdef PAGED_KEYS_AHEAD
  return PAGED_KEYS_AHEAD;
#else
  constexpr int kPagedAhead[3][4] = {{2, 4, 4, 4}, {4, 8, 4, 4},
                                     {4, 4, 4, 4}};
  return kPagedAhead[KIND][KV_MUL == 1 ? 0 : KV_MUL == 2 ? 1
                                          : KV_MUL == 4 ? 2 : 3];
#endif
}

// f32 page planes: position p's values at p * row of this lane's pointers
// (for_lane), loaded as f32.
struct F32Planes {
  static constexpr int kKind = kF32Pages;
  using Raw = float4;
  const float* k;
  const float* v;
  size_t row;  // n_kv * hs values per position
  // these planes at value `off` of each position (g * hs + 4 * lane)
  __device__ __forceinline__ F32Planes for_lane(int off) const {
    return F32Planes{k + off, v + off, row};
  }
  __device__ __forceinline__ float4 load_k(int p) const {
    return __ldg(reinterpret_cast<const float4*>(k + p * row));
  }
  __device__ __forceinline__ float4 load_v(int p) const {
    return __ldg(reinterpret_cast<const float4*>(v + p * row));
  }
  static __device__ __forceinline__ float4 widen(float4 r) { return r; }
};

// bf16 page planes: the same geometry, four bf16 a lane (8 bytes) held as
// loaded until the step widens them (exactly).
struct Bf16Planes {
  static constexpr int kKind = kBf16Pages;
  using Raw = uint2;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  size_t row;
  __device__ __forceinline__ Bf16Planes for_lane(int off) const {
    return Bf16Planes{k + off, v + off, row};
  }
  __device__ __forceinline__ uint2 load_k(int p) const {
    return __ldg(reinterpret_cast<const uint2*>(k + p * row));
  }
  __device__ __forceinline__ uint2 load_v(int p) const {
    return __ldg(reinterpret_cast<const uint2*>(v + p * row));
  }
  static __device__ __forceinline__ float4 widen(uint2 r) {
    return make_float4(bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y),
                       bf16_hi(r.y));
  }
};

// A lane's four Q80 codes of one position and their block's f16 delta.
struct Q8Raw {
  uint32_t codes;
  __half delta;
};

// Q8 page planes: int8 codes with the f32 planes' geometry, one f16 delta
// per 32 values of the position's flattened row ((g * hs + 4 * lane) / 32:
// 4 | 32 keeps a lane's four values in one block). widen gives
// float(code) * float(delta), the JAX package's value map, exactly: each
// signed byte, biased by 128 (xor 0x80), is permuted under 2^23's exponent
// and 2^23 + 128 taken off (float(code) exact, on the integer and FMA
// units rather than the conversion unit), then multiplied by the delta.
struct Q8Planes {
  static constexpr int kKind = kQ8Pages;
  using Raw = Q8Raw;
  const int8_t* kq;
  const __half* kd;
  const int8_t* vq;
  const __half* vd;
  size_t row;  // n_kv * hs codes per position
  int nb;      // n_kv * hs / 32 deltas per position
  __device__ __forceinline__ Q8Planes for_lane(int off) const {
    return Q8Planes{kq + off, kd + (off >> 5), vq + off, vd + (off >> 5),
                    row, nb};
  }
  static __device__ __forceinline__ Q8Raw load(const int8_t* codes,
                                               const __half* deltas) {
    return Q8Raw{__ldg(reinterpret_cast<const unsigned int*>(codes)),
                 __ldg(deltas)};
  }
  __device__ __forceinline__ Q8Raw load_k(int p) const {
    return load(kq + p * row, kd + static_cast<size_t>(p) * nb);
  }
  __device__ __forceinline__ Q8Raw load_v(int p) const {
    return load(vq + p * row, vd + static_cast<size_t>(p) * nb);
  }
  static __device__ __forceinline__ float code(uint32_t biased, uint32_t k) {
    return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u + k)) -
           8388736.0f;
  }
  static __device__ __forceinline__ float4 widen(Q8Raw r) {
    const uint32_t b = r.codes ^ 0x80808080u;
    const float d = __half2float(r.delta);
    return make_float4(code(b, 0) * d, code(b, 1) * d, code(b, 2) * d,
                       code(b, 3) * d);
  }
};

// Keys of one (row, kv head) through the page table: key t at pool
// position (layer * P + table[t / ps]) * ps + t % ps, the row's entry
// read with __ldg (on the H100 as fast as a split's entries staged in
// shared memory, within 1.4% where those led and up to 5% ahead at pos 63:
// PERF.md). The walk asks for a warp's keys in order, kWarps apart, so a
// cursor (entry e, offset o) follows them without a division a key.
template <typename P>
struct PagedKeys {
  using Raw = typename P::Raw;
  P planes;
  const int* table;
  int layer_base;  // layer * P
  int ps;
  int e, o;  // the entry and offset of the next key asked for
  __device__ __forceinline__ void start(int t) {
    e = t / ps;
    o = t - e * ps;
  }
  __device__ __forceinline__ int at(int) {
    const int p = (layer_base + __ldg(table + e)) * ps + o;
    for (o += kWarps; o >= ps; o -= ps) ++e;
    return p;
  }
  __device__ __forceinline__ Raw load_k(int p) const {
    return planes.load_k(p);
  }
  __device__ __forceinline__ Raw load_v(int p) const {
    return planes.load_v(p);
  }
  static __device__ __forceinline__ float4 widen(Raw r) {
    return P::widen(r);
  }
};

struct PagedArgs {
  const float* q;
  float* out;
  float* part;     // the splits' o, then their (m, l) (SplitOut)
  int* tickets;    // (batch * t_len, n_kv) zeros between launches
  const int* pos;  // (batch,) device positions
  const int* table;
  int layer_base;  // layer * n_pages
  int batch;
  int t_len;
  int max_pages;
  int ps;
  int n_kv;
  int hs;
  int most;
  int least;
  float scale;
};

// KV_MUL 1 is held to 64 registers, two blocks an SM: 7B's 32 kv heads
// over 8 rows make 256 one-split blocks, one wave at two an SM (at 80
// registers, two waves: 0.0163 ms a layer at pos 63 against 0.0132 on
// the H100)
template <int KV_MUL, typename P>
__global__ void __launch_bounds__(kWarps * 32, KV_MUL == 1 ? 2 : 1)
paged_attention_kernel(PagedArgs a, P planes) {
  const int g = blockIdx.x;
  const int y = blockIdx.y;  // row b * t_len + query i
  const int j = blockIdx.z;
  const int b = y / a.t_len;
  const int i = y - b * a.t_len;
  const int keys = min(__ldg(a.pos + b) + i, a.max_pages * a.ps - 1) + 1;
  int splits, per;
  decode_splits(keys, a.most, a.least, splits, per);
  if (j >= splits) return;
  const int t0 = j * per;
  const int t1 = min(keys, t0 + per);

  const int hs = a.hs;
  const int lane = threadIdx.x & 31;
  const bool live = 4 * lane < hs;  // lanes past the head size hold zeros
  const int* row_table = a.table + static_cast<size_t>(b) * a.max_pages;
  const size_t item = static_cast<size_t>(y) * a.n_kv + g;  // (query, head)
  FlashState<KV_MUL> st;  // its q loads in flight beside the table's
  st.begin(a.q + item * KV_MUL * hs, hs, lane, live);
  extern __shared__ float sm[];
  const PagedKeys<P> pages{planes.for_lane(g * hs + 4 * lane), row_table,
                           a.layer_base, a.ps, 0, 0};
  // the next batch's table entries asked early above KV_MUL 1: at 1 the
  // 64-register bound leaves no room for them beside 4 keys in flight
  flash_walk<KV_MUL, paged_keys_ahead<P::kKind, KV_MUL>(), (KV_MUL > 1)>(
      st, pages, t0, t1, a.scale, live);
  flash_finish(st, sm, SplitOut{a.out, a.part, a.tickets,
                                static_cast<size_t>(a.batch) * a.t_len *
                                    a.n_kv,
                                a.most},
               item, j, splits, hs, live);
}

template <int KV_MUL, typename P>
int launch(const PagedArgs& a, const P& planes, cudaStream_t stream) {
  const size_t smem = flash_decode_smem<KV_MUL>(a.hs);
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(paged_attention_kernel<KV_MUL, P>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the widest plan: that of the clamped virtual plane's keys
  const int splits = decode_want(a.max_pages * a.ps, a.most, a.least);
  paged_attention_kernel<KV_MUL, P>
      <<<dim3(a.n_kv, a.batch * a.t_len, splits), kWarps * 32, smem,
         stream>>>(a, planes);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int dispatch(const PagedArgs& a, const P& planes, int kv_mul, int n_pages,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the layer's pool positions, which the walk holds as ints
  const long long positions =
      (static_cast<long long>(a.layer_base) + n_pages) * a.ps;
  // any window: a block takes one (row, query), so B * t_len is bound only
  // by grid y (a verify window is K queries, a mixed one the budget)
  if (a.hs % 4 != 0 || a.hs > 128 || a.batch < 1 || a.t_len < 1 ||
      a.batch * a.t_len > 65535 || a.ps < 1 ||
      a.max_pages < 1 || n_pages < 1 || a.most < 1 || a.most > kMaxSplits ||
      a.least < 1 || positions > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kv_mul) {
    case 1:
      return launch<1>(a, planes, s);
    case 2:
      return launch<2>(a, planes, s);
    case 4:
      return launch<4>(a, planes, s);
    case 8:
      return launch<8>(a, planes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PagedArgs args(const void* q, void* out, void* part, void* tickets,
               int layer, const void* pos, const void* table, int batch,
               int t_len, int n_pages, int max_pages, int ps, int n_kv,
               int hs, int most, int least, float scale) {
  return PagedArgs{static_cast<const float*>(q), static_cast<float*>(out),
                   static_cast<float*>(part), static_cast<int*>(tickets),
                   static_cast<const int*>(pos),
                   static_cast<const int*>(table), layer * n_pages, batch,
                   t_len, max_pages, ps, n_kv, hs, most, least, scale};
}

template <typename P, typename KV>
int dispatch_pages(const void* q, const void* k4, const void* v4, void* out,
                   void* part, void* tickets, int layer, const void* pos,
                   const void* table, int batch, int t_len, int n_pages,
                   int max_pages, int ps, int n_kv, int kv_mul, int hs,
                   int most, int least, float scale, void* stream) {
  const P planes{static_cast<const KV*>(k4), static_cast<const KV*>(v4),
                 static_cast<size_t>(n_kv) * hs};
  return dispatch(args(q, out, part, tickets, layer, pos, table, batch,
                       t_len, n_pages, max_pages, ps, n_kv, hs, most, least,
                       scale),
                  planes, kv_mul, n_pages, stream);
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 4 up to 128, t_len >= 1
// with batch * t_len <= 65535, and the plan (most, least) with 1 <= most <=
// 32; `part` holds batch * t_len * n_kv * most * kv_mul * (hs + 2) floats
// and `tickets` batch * t_len * n_kv zeroed int32 (both untouched under a
// one-split plan). K6
// over f32 pages:
extern "C" int paged_attention(const void* q, const void* k4, const void* v4,
                               void* out, void* part, void* tickets,
                               int layer, const void* pos, const void* table,
                               int batch, int t_len, int n_pages,
                               int max_pages, int ps, int n_kv, int kv_mul,
                               int hs, int most, int least, float scale,
                               void* stream) {
  return dispatch_pages<F32Planes, float>(
      q, k4, v4, out, part, tickets, layer, pos, table, batch, t_len,
      n_pages, max_pages, ps, n_kv, kv_mul, hs, most, least, scale, stream);
}

// K6 over bf16 pages:
extern "C" int paged_attention_kvbf16(
    const void* q, const void* k4, const void* v4, void* out, void* part,
    void* tickets, int layer, const void* pos, const void* table, int batch,
    int t_len, int n_pages, int max_pages, int ps, int n_kv, int kv_mul,
    int hs, int most, int least, float scale, void* stream) {
  return dispatch_pages<Bf16Planes, __nv_bfloat16>(
      q, k4, v4, out, part, tickets, layer, pos, table, batch, t_len,
      n_pages, max_pages, ps, n_kv, kv_mul, hs, most, least, scale, stream);
}

// K7 over Q8 pages; (n_kv * hs) % 32 == 0.
extern "C" int paged_attention_q8(
    const void* q, const void* kq4, const void* kd4, const void* vq4,
    const void* vd4, void* out, void* part, void* tickets, int layer,
    const void* pos, const void* table, int batch, int t_len, int n_pages,
    int max_pages, int ps, int n_kv, int kv_mul, int hs, int most, int least,
    float scale, void* stream) {
  if ((n_kv * hs) % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Q8Planes planes{static_cast<const int8_t*>(kq4),
                        static_cast<const __half*>(kd4),
                        static_cast<const int8_t*>(vq4),
                        static_cast<const __half*>(vd4),
                        static_cast<size_t>(n_kv) * hs, n_kv * hs / 32};
  return dispatch(args(q, out, part, tickets, layer, pos, table, batch,
                       t_len, n_pages, max_pages, ps, n_kv, hs, most, least,
                       scale),
                  planes, kv_mul, n_pages, stream);
}
