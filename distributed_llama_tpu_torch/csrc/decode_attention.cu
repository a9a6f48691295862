// Flash-decode attention for Hopper (sm_90a): one query token against the
// live prefix 0..pos of one layer of the stacked KV cache, f32 or bf16 —
// K2 for one sequence, K5 for B sequences at once.
//
//   K2: q (n_kv * kv_mul, hs) f32; k_all, v_all (L, S, n_kv, hs) f32 or
//   bf16; out (n_kv * kv_mul * hs) f32; `layer` and `pos` are ints.
//   K5: q (B, n_kv * kv_mul, hs); k_all, v_all (L * B, S, n_kv, hs), row
//   layer * B + b holding sequence b's keys of layer `layer`; `pos` a
//   device (B,) int32, row b attending keys 0..pos[b]; out (B, n_q * hs).
//   Query head h = g * kv_mul + m attends kv head g; scores are scaled by
//   1/sqrt(hs); softmax over the live keys.
//
// Replaces the JAX package's ops/pallas_attention.py decode_attention (K2:
// _kernel / _flash_over_row) and decode_attention_batch (K5: _kernel_batch,
// the same flash walk per row with per-row clocks): the same online softmax
// with running (m, l, o), reading only the live prefix. K5 reads its
// positions from device memory, so a step captured in a CUDA graph sees
// each replay's clocks (an int argument would be frozen at capture). A bf16
// cache (the JAX kernels' scratch in the cache dtype, --kv-cache-dtype
// bf16) is widened to f32 exactly as it is loaded, and all math stays f32.
//
// Bound: the K and V bytes of each row's live prefix, 2 * (pos+1) * n_kv *
// hs * 4 (2 per value for a bf16 cache), read once. One block of one
// (kv head, row) walking all of a long prefix (the first design: 32 blocks
// at 7B on 132 SMs, one key of K and V in flight a warp) kept ~0.5 MB in
// flight and reached a fifth of the card's rate at 2048 keys. So:
//
// - the keys of each (kv head, row) are cut into splits (decode_splits,
//   twin of ops/attention.decode_splits): at most `most` a head, each of
//   at least `least` keys, so a short prefix takes one; the wrapper picks
//   `most` to put about DECODE_BLOCKS_PER_SM blocks on every SM. Block
//   (g, b, j) takes split j of kv head g for row b; the grid covers the
//   largest plan the row could need (K5: S keys; K2 knows pos), and a block
//   past its row's plan exits at once, so ragged rows each get their own;
// - each warp loads the K and V rows of a batch of kAhead keys (t, t +
//   kWarps, ...) before it takes them in order through flash_step, so
//   kAhead keys a warp are in flight;
// - over 8 GQA heads a kv head the online softmax, not the bytes, held
//   the walk (every lane computed every head's 5-shuffle sum and two
//   expf): flash_step (flash_decode.cuh) sums the KV_MUL dots in one
//   butterfly that halves the heads a lane holds at each step, and each
//   lane group computes one head's softmax scalars, the same values with
//   about half the instructions a key;
// - a split's warps combine in warp order (flash_decode.cuh, each warp's
//   weight computed once); with one split that is the output, else the
//   split writes its (m, l, unnormalised o) to `part`, fences and takes a
//   ticket of its (row, kv head); the last to arrive merges the splits in
//   split order and resets the ticket to 0 for the next launch. One launch
//   a call; the bits do not depend on which block finishes last.
//
// The walk, the step and the merge live in flash_decode.cuh, shared with K6
// and K7 (paged_attention.cu), which reach key t through a page table. K2
// and K5 are one kernel: at B = 1 on an (L, S, n_kv, hs) cache they compute
// the same sums in the same order under the same plan, so a step through
// either gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_decode.cuh"

namespace {

// Keys in flight a warp, from tools/plan_sweep.py on the H100: 4 up to
// KV_MUL = 2, else 2 (KV_MUL = 8 keeps 8 heads' q and o in registers; at 2
// keys it reaches 128 registers, and at 1 it ran up to 9% slower).
// DECODE_KEYS_AHEAD overrides the table (the sweep builds such variants).
template <int KV_MUL>
__host__ __device__ constexpr int keys_ahead() {
#ifdef DECODE_KEYS_AHEAD
  return DECODE_KEYS_AHEAD;
#else
  return KV_MUL >= 4 ? 2 : 4;
#endif
}

struct DecodeArgs {
  const float* q;
  float* out;
  float* part;        // the splits' o, then their (m, l) (SplitOut)
  int* tickets;       // (batch, n_kv) zeros between launches
  const int* pos_vec; // K5's device positions, or null for K2's `pos`
  int pos;
  int layer;
  int batch;
  int S;
  int n_kv;
  int hs;
  int most;
  int least;
  float scale;
};

// Keys of one (row, kv head) in a contiguous cache: key t at row t of the
// (S, n_kv, hs) plane, `row` values apart; k and v point at this lane's
// values of key 0. Loads widen at once (a bf16 cache too).
template <typename KV>
struct CacheKeys {
  using Raw = float4;
  const KV* k;
  const KV* v;
  size_t row;  // n_kv * hs values between keys
  __device__ __forceinline__ void start(int) {}
  __device__ __forceinline__ size_t at(int t) const {
    return static_cast<size_t>(t) * row;
  }
  __device__ __forceinline__ float4 load_k(size_t at) const {
    return load_f4(k + at);
  }
  __device__ __forceinline__ float4 load_v(size_t at) const {
    return load_f4(v + at);
  }
  static __device__ __forceinline__ float4 widen(float4 r) { return r; }
};

template <typename KV, int KV_MUL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(DecodeArgs a, const KV* __restrict__ k_all,
                        const KV* __restrict__ v_all) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int keys = (a.pos_vec ? __ldg(a.pos_vec + b) : a.pos) + 1;
  int splits, per;
  decode_splits(keys, a.most, a.least, splits, per);
  if (j >= splits) return;
  const int t0 = j * per;
  const int t1 = min(keys, t0 + per);

  const int hs = a.hs;
  const int lane = threadIdx.x & 31;
  const bool live = 4 * lane < hs;  // lanes past the head size hold zeros
  // K5: block row b reads cache row layer * batch + b (K2: batch 1)
  const size_t base =
      ((static_cast<size_t>(a.layer) * a.batch + b) * a.S * a.n_kv + g) * hs +
      4 * lane;
  const CacheKeys<KV> cache{k_all + base, v_all + base,
                            static_cast<size_t>(a.n_kv) * hs};
  const size_t item = static_cast<size_t>(b) * a.n_kv + g;  // (row, head)

  FlashState<KV_MUL> st;
  st.begin(a.q + item * KV_MUL * hs, hs, lane, live);
  // the plain batches: on the H100 (tools/decode_bits.py against this file
  // with the switch true, at chip_smoke.py's K5 shapes) K6's walk, the
  // early ask with halving batches, took as long over 8 GQA kv heads
  // (median 1.000x) and up to 1.79x as long at 7B's KV_MUL 1 (K5's median
  // 1.13x); the halving batches alone spilled (K5 over bf16 at KV_MUL 2,
  // K6 over bf16 and Q8 pages at 1) and took K5 up to 1.56x as long at 7B
  flash_walk<KV_MUL, keys_ahead<KV_MUL>(), false>(st, cache, t0, t1, a.scale,
                                                  live);
  extern __shared__ float sm[];
  flash_finish(st, sm, SplitOut{a.out, a.part, a.tickets,
                                static_cast<size_t>(a.batch) * a.n_kv,
                                a.most},
               item, j, splits, hs, live);
}

template <typename KV, int KV_MUL>
int launch(const DecodeArgs& a, const KV* k, const KV* v, int grid_splits,
           cudaStream_t stream) {
  const size_t smem = flash_decode_smem<KV_MUL>(a.hs);
  static size_t granted[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(decode_attention_kernel<KV, KV_MUL>, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_attention_kernel<KV, KV_MUL>
      <<<dim3(a.n_kv, a.batch, grid_splits), kWarps * 32, smem, stream>>>(
          a, k, v);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch(DecodeArgs a, const void* k_all, const void* v_all, int kv_mul,
             void* stream) {
  const KV* kc = static_cast<const KV*>(k_all);
  const KV* vc = static_cast<const KV*>(v_all);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.hs % 4 != 0 || a.hs > 128 || a.batch < 1 || a.batch > 65535 ||
      a.most < 1 || a.most > kMaxSplits || a.least < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the grid: K2 its position's plan, K5 the widest plan of a full cache
  int splits = decode_want(a.S, a.most, a.least);
  if (!a.pos_vec) {
    int per;
    decode_splits(a.pos + 1, a.most, a.least, splits, per);
  }
  switch (kv_mul) {
    case 1:
      return launch<KV, 1>(a, kc, vc, splits, s);
    case 2:
      return launch<KV, 2>(a, kc, vc, splits, s);
    case 4:
      return launch<KV, 4>(a, kc, vc, splits, s);
    case 8:
      return launch<KV, 8>(a, kc, vc, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

DecodeArgs args(const void* q, void* out, void* part, void* tickets,
                const void* pos_vec, int pos, int layer, int batch, int S,
                int n_kv, int hs, int most, int least, float scale) {
  return DecodeArgs{static_cast<const float*>(q), static_cast<float*>(out),
                    static_cast<float*>(part), static_cast<int*>(tickets),
                    static_cast<const int*>(pos_vec), pos, layer, batch, S,
                    n_kv, hs, most, least, scale};
}

}  // namespace

// Launch on `stream`; returns the cudaGetLastError() code (0 = launched).
// Takes kv_mul in {1, 2, 4, 8}, hs a multiple of 4 up to 128 and the plan
// (most, least) with 1 <= most <= 32; `part` holds batch * n_kv * most *
// kv_mul * (hs + 2) floats and `tickets` batch * n_kv zeroed int32 (both
// untouched under a one-split plan). K2 over an f32 cache:
extern "C" int decode_attention(const void* q, const void* k_all,
                                const void* v_all, void* out, void* part,
                                void* tickets, int layer, int pos, int S,
                                int n_kv, int kv_mul, int hs, int most,
                                int least, float scale, void* stream) {
  return dispatch<float>(args(q, out, part, tickets, nullptr, pos, layer, 1,
                              S, n_kv, hs, most, least, scale),
                         k_all, v_all, kv_mul, stream);
}

// K2 over a bf16 cache:
extern "C" int decode_attention_kvbf16(const void* q, const void* k_all,
                                       const void* v_all, void* out,
                                       void* part, void* tickets, int layer,
                                       int pos, int S, int n_kv, int kv_mul,
                                       int hs, int most, int least,
                                       float scale, void* stream) {
  return dispatch<__nv_bfloat16>(args(q, out, part, tickets, nullptr, pos,
                                      layer, 1, S, n_kv, hs, most, least,
                                      scale),
                                 k_all, v_all, kv_mul, stream);
}

// K5 over an f32 cache: `pos` is a device (batch,) int32 vector.
extern "C" int decode_attention_batch(const void* q, const void* k_all,
                                      const void* v_all, void* out,
                                      void* part, void* tickets, int layer,
                                      const void* pos, int batch, int S,
                                      int n_kv, int kv_mul, int hs, int most,
                                      int least, float scale, void* stream) {
  return dispatch<float>(args(q, out, part, tickets, pos, 0, layer, batch, S,
                              n_kv, hs, most, least, scale),
                         k_all, v_all, kv_mul, stream);
}

// K5 over a bf16 cache:
extern "C" int decode_attention_batch_kvbf16(
    const void* q, const void* k_all, const void* v_all, void* out,
    void* part, void* tickets, int layer, const void* pos, int batch, int S,
    int n_kv, int kv_mul, int hs, int most, int least, float scale,
    void* stream) {
  return dispatch<__nv_bfloat16>(args(q, out, part, tickets, pos, 0, layer,
                                      batch, S, n_kv, hs, most, least, scale),
                                 k_all, v_all, kv_mul, stream);
}
