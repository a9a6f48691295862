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
//   verify window whose tail runs past the row's virtual plane. Key t of
//   row b lives at page row layer * P + table[b, t / ps], offset t % ps.
//   out (B, t_len, n_q * hs) f32.
//
// Replaces the JAX package's ops/pallas_paged_attention.py
// paged_decode_attention_kernel (K6: _kernel_paged -> _flash_pages) and
// paged_decode_attention_kernel_q8 (K7: _kernel_paged_q8), which walk the
// table with double-buffered page DMAs. Here a block loads its own table
// entries: the grid is one block per (kv head, row, query), each running
// K5's flash-decode body (flash_decode.cuh) with the paged key address as
// the only change. The keys are summed in logical order exactly as K5 sums
// them, so at t_len 1, over a pool that holds a contiguous cache's values,
// K6 gives K5's bits, and any permutation of the physical pages gives the
// same bits. K7's loader reads each lane's char4 of codes and its block's
// one f16 delta ((g * hs + 4 * lane) / 32: 4 | 32 keeps the lane's four
// values in one block) and widens them as float(code) * float(delta), the
// JAX package's value map (exact in f32); the f32 math then runs
// unchanged, so K7 equals K6 bit for bit over a pool that holds the
// dequantized values.
//
// Bound: the live page bytes, each key's K and V read once: 2 * (pos + i +
// 1) * n_kv * hs * 4 per row, query and layer for f32 pages (2 bytes per
// value for bf16; n_kv * hs + 2 * n_kv * hs / 32 per position for Q8).
// Simple first: a query of a t_len window re-reads the keys its
// neighbours read (the decode step launches t_len 1 only); split-KV and
// cp.async page prefetch are left for later.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_decode.cuh"

namespace {

// f32 / bf16 page planes: position p's row of kv head g at p * row + goff.
template <typename KV>
struct Planes {
  const KV* k;
  const KV* v;
  size_t row;  // n_kv * hs values per position
  int goff;    // g * hs
  __device__ __forceinline__ float4 k4(size_t p, int lane) const {
    return load_f4(k + p * row + goff + 4 * lane);
  }
  __device__ __forceinline__ float4 v4(size_t p, int lane) const {
    return load_f4(v + p * row + goff + 4 * lane);
  }
};

// Q8 page planes: int8 codes with the f32 planes' geometry, one f16 delta
// per 32 values of the position's flattened row.
struct Q8Planes {
  const int8_t* kq;
  const __half* kd;
  const int8_t* vq;
  const __half* vd;
  size_t row;  // n_kv * hs codes per position
  int nb;      // n_kv * hs / 32 deltas per position
  int goff;    // g * hs
  static __device__ __forceinline__ float4 widen(const int8_t* codes,
                                                 const __half* deltas,
                                                 size_t p, size_t row,
                                                 int nb, int off) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(codes + p * row +
                                                         off));
    const float d = __half2float(__ldg(deltas + p * nb + (off >> 5)));
    return make_float4(static_cast<float>(c.x) * d,
                       static_cast<float>(c.y) * d,
                       static_cast<float>(c.z) * d,
                       static_cast<float>(c.w) * d);
  }
  __device__ __forceinline__ float4 k4(size_t p, int lane) const {
    return widen(kq, kd, p, row, nb, goff + 4 * lane);
  }
  __device__ __forceinline__ float4 v4(size_t p, int lane) const {
    return widen(vq, vd, p, row, nb, goff + 4 * lane);
  }
};

// Keys of one (row, kv head) through the page table: key t at pool
// position (layer * P + table[t / ps]) * ps + t % ps.
template <typename P>
struct PagedKeys {
  P planes;
  const int* table;  // this row's (max_pages,) entries
  int layer_base;    // layer * P
  int ps;
  __device__ __forceinline__ size_t at(int t) const {
    const int page = __ldg(table + t / ps);
    return static_cast<size_t>(layer_base + page) * ps + t % ps;
  }
  __device__ __forceinline__ float4 k4(size_t at, int lane) const {
    return planes.k4(at, lane);
  }
  __device__ __forceinline__ float4 v4(size_t at, int lane) const {
    return planes.v4(at, lane);
  }
};

template <int KV_MUL, typename P>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const float* __restrict__ q, float* __restrict__ out,
                       P planes, int layer_base,
                       const int* __restrict__ pos_vec,
                       const int* __restrict__ table, int max_pages, int ps,
                       int n_kv, int hs, int t_len, float scale) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int i = blockIdx.z;
  const int last = min(pos_vec[b] + i, max_pages * ps - 1);
  planes.goff = g * hs;
  const PagedKeys<P> keys{planes, table + static_cast<size_t>(b) * max_pages,
                          layer_base, ps};
  const size_t qo =
      ((static_cast<size_t>(b) * t_len + i) * n_kv + g) * KV_MUL * hs;
  flash_decode_block<KV_MUL>(q + qo, out + qo, last, hs, scale, keys);
}

template <int KV_MUL, typename P>
int launch(const float* q, float* out, const P& planes, int layer_base,
           const int* pos, const int* table, int batch, int t_len,
           int max_pages, int ps, int n_kv, int hs, float scale,
           cudaStream_t stream) {
  const size_t smem = flash_decode_smem<KV_MUL>(hs);
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(paged_attention_kernel<KV_MUL, P>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_attention_kernel<KV_MUL, P>
      <<<dim3(n_kv, batch, t_len), kWarps * 32, smem, stream>>>(
          q, out, planes, layer_base, pos, table, max_pages, ps, n_kv, hs,
          t_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int dispatch(const void* q, void* out, const P& planes, int layer,
             const void* pos, const void* table, int batch, int t_len,
             int n_pages, int max_pages, int ps, int n_kv, int kv_mul,
             int hs, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  const int* pv = static_cast<const int*>(pos);
  const int* tb = static_cast<const int*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs % 4 != 0 || hs > 128 || batch < 1 || batch > 65535 || t_len < 1 ||
      t_len > 8 || ps < 1 || max_pages < 1 || n_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int base = layer * n_pages;
  switch (kv_mul) {
    case 1:
      return launch<1>(qf, of, planes, base, pv, tb, batch, t_len,
                       max_pages, ps, n_kv, hs, scale, s);
    case 2:
      return launch<2>(qf, of, planes, base, pv, tb, batch, t_len,
                       max_pages, ps, n_kv, hs, scale, s);
    case 4:
      return launch<4>(qf, of, planes, base, pv, tb, batch, t_len,
                       max_pages, ps, n_kv, hs, scale, s);
    case 8:
      return launch<8>(qf, of, planes, base, pv, tb, batch, t_len,
                       max_pages, ps, n_kv, hs, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename KV>
int dispatch_pages(const void* q, const void* k4, const void* v4, void* out,
                   int layer, const void* pos, const void* table, int batch,
                   int t_len, int n_pages, int max_pages, int ps, int n_kv,
                   int kv_mul, int hs, float scale, void* stream) {
  const Planes<KV> planes{static_cast<const KV*>(k4),
                          static_cast<const KV*>(v4),
                          static_cast<size_t>(n_kv) * hs, 0};
  return dispatch(q, out, planes, layer, pos, table, batch, t_len, n_pages,
                  max_pages, ps, n_kv, kv_mul, hs, scale, stream);
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 4 up to 128 and t_len
// 1..8. K6 over f32 pages:
extern "C" int paged_attention(const void* q, const void* k4, const void* v4,
                               void* out, int layer, const void* pos,
                               const void* table, int batch, int t_len,
                               int n_pages, int max_pages, int ps, int n_kv,
                               int kv_mul, int hs, float scale,
                               void* stream) {
  return dispatch_pages<float>(q, k4, v4, out, layer, pos, table, batch,
                               t_len, n_pages, max_pages, ps, n_kv, kv_mul,
                               hs, scale, stream);
}

// K6 over bf16 pages:
extern "C" int paged_attention_kvbf16(const void* q, const void* k4,
                                      const void* v4, void* out, int layer,
                                      const void* pos, const void* table,
                                      int batch, int t_len, int n_pages,
                                      int max_pages, int ps, int n_kv,
                                      int kv_mul, int hs, float scale,
                                      void* stream) {
  return dispatch_pages<__nv_bfloat16>(q, k4, v4, out, layer, pos, table,
                                       batch, t_len, n_pages, max_pages, ps,
                                       n_kv, kv_mul, hs, scale, stream);
}

// K7 over Q8 pages; (n_kv * hs) % 32 == 0.
extern "C" int paged_attention_q8(const void* q, const void* kq4,
                                  const void* kd4, const void* vq4,
                                  const void* vd4, void* out, int layer,
                                  const void* pos, const void* table,
                                  int batch, int t_len, int n_pages,
                                  int max_pages, int ps, int n_kv, int kv_mul,
                                  int hs, float scale, void* stream) {
  if ((n_kv * hs) % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Q8Planes planes{static_cast<const int8_t*>(kq4),
                        static_cast<const __half*>(kd4),
                        static_cast<const int8_t*>(vq4),
                        static_cast<const __half*>(vd4),
                        static_cast<size_t>(n_kv) * hs, n_kv * hs / 32, 0};
  return dispatch(q, out, planes, layer, pos, table, batch, t_len, n_pages,
                  max_pages, ps, n_kv, kv_mul, hs, scale, stream);
}
