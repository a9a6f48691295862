// The skeleton of the Q40 small-T products on the tensor cores, shared by
// K1 and K1m (q40_matvec.cu, P = 3: x in three exact bf16 pieces, a
// per-block sum scaled in f32) and K1d (q40_matvec_bf16.cu, P = 1: x
// rounded to bf16 once, each weight rounded to bf16 after its exact f32
// product with its scale). q40_matvec.cu's header says how the skeleton
// streams the weights: a cp.async ring all threads fill, x staged once a
// block, rows in tiles of 32 wr over wr x wk warps, split K summed in
// split order by the last block of a tile behind a ticket.
//
// Columns: (token, piece) pairs, column P t + p, so an n8 column set holds
// 8 / P tokens: P = 3 takes one set for T <= 2 and three for T = 8, P = 1
// one set for every T <= 8.
//
// Two policies, for the Q40 layout probe's bodies (nb_probe.cu): kXLaid,
// x already split and laid out in global memory in the staging order
// below (P2), read from there with 16-byte non-coherent loads, so the
// block stages no x; and Codes, how a code word becomes its bf16 operands
// (UnsignedCodes, q40_tc.cuh: K1's; P4's signed nibbles).
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "q40_tc.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kStages = 4;  // ring stages a block

// Shared memory of a block of wr x wk warps: x's kb blocks in P bf16
// pieces, the ring (a stage: 32 wr rows x 4 wk blocks of codes, 2048
// bytes a warp, and each row's window of scale words, 8 wk + 8 bytes),
// the warps' 32 x P T f32 sums and a flag.
__host__ __device__ constexpr size_t smem_bytes(int t, int kb, int wr, int wk,
                                                int p) {
  return static_cast<size_t>(kb) * p * t * 64 +
         static_cast<size_t>(kStages) *
             (2048 * wr * wk + 32 * wr * (8 * wk + 8)) +
         static_cast<size_t>(wr) * wk * 32 * p * t * 4 + 16;
}

// A scale s (an f16 value in f32) as two bf16 pairs (hi, hi) and (lo, lo)
// with s = hi + lo exactly: hi = bf16_rn(s); s - hi is exact in f32 and
// has at most 4 significant bits (s has 11, hi keeps 8), so clearing its
// low 16 bits keeps it whole.
static __device__ __forceinline__ void split_scale(float s, uint32_t& hi,
                                                   uint32_t& lo) {
  hi = pack_bf16(s, s);
  const uint32_t r = __float_as_uint(__fsub_rn(s, bf16_lo(hi)));
  lo = __byte_perm(r, r, 0x7632);
}

// bf16_rn((c - 8) * s) for a pair of codes, from v = (c0 - 8, c1 - 8) in
// bf16 (codes_bf16) and s = hi + lo (split_scale): t = v lo is exact (at
// most 4 x 4 significant bits), so v hi + t rounds once, to the bf16 of
// the exact product. The -0 addend keeps t's sign when v lo is zero.
static __device__ __forceinline__ uint32_t scaled_bf16(uint32_t v,
                                                       uint32_t hi,
                                                       uint32_t lo) {
  uint32_t t, w;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(t)
      : "r"(v), "r"(lo), "r"(0x80008000u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(w) : "r"(v), "r"(hi), "r"(t));
  return w;
}

template <int T, int P, bool kXLaid = false, typename Codes = UnsignedCodes>
__device__ __forceinline__ void matvec_body(
    const uint8_t* __restrict__ qs, const uint8_t* __restrict__ d16,
    const float* __restrict__ x, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int d, int nb,
    int wr, int wk, int kb) {
  constexpr int C = P * T;          // (token, piece) columns
  constexpr int M = (C + 7) / 8;    // n8 column sets
  extern __shared__ __align__(16) uint8_t smem[];
  const int warps = wr * wk;
  const int threads = 32 * warps;
  const int sbc = 4 * wk;           // blocks a stage, 4 a warp
  const int rows = 32 * wr;         // rows a tile
  const int sw = 8 * wk + 8;        // scale bytes a row in a stage
  const int code_bytes = rows * sbc * 16;
  const int slot_bytes = code_bytes + rows * sw;
  uint8_t* xs = smem;
  uint8_t* ring = kXLaid ? smem : smem + static_cast<size_t>(kb) * C * 64;
  float* red = reinterpret_cast<float*>(ring + kStages * slot_bytes);
  int* last = reinterpret_cast<int*>(red + warps * 32 * C);

  const int splits = gridDim.y;
  const int split = blockIdx.y;
  const int k0 = split * kb;
  const int kn = min(kb, nb - k0);  // this split's blocks
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wri = warp % wr;
  const int wki = warp / wr;
  const int stages = (kn + sbc - 1) / sbc;  // a tile's stages
  const int tiles = (d + rows - 1) / rows;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < tiles
          ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;
  const int total = my_tiles * stages;
  const uintptr_t d16_addr = reinterpret_cast<uintptr_t>(d16);
  // 16-byte chunk `chunk` of this split's x in the staging order below:
  // from shared memory, or (kXLaid) from the laid-out copy in global memory
  const uint4* x_laid =
      reinterpret_cast<const uint4*>(x) + static_cast<size_t>(k0) * C * 4;
  auto x_chunk = [&](int chunk) -> uint4 {
    if constexpr (kXLaid) {
      return __ldg(x_laid + chunk);
    } else {
      return reinterpret_cast<const uint4*>(xs)[chunk];
    }
  };

  // The copier, all threads together, a stage a call. Codes: chunk i =
  // tid + threads k (k < 4) is block i % sbc of row i / sbc, so a warp
  // reads sbc * 16 contiguous bytes of each row it touches; its block is
  // the same for every k (threads is a multiple of sbc) and its rows are
  // 8 wr apart, stored at block ^ (row % 8) of the row, so ldmatrix's 8
  // rows of one block fall on distinct bank groups. Rows past d are not
  // copied (their sums are not stored). Scales: word u % sw4 of row u /
  // sw4 (u = tid + threads k, k < 3, sw4 = 2 wk + 1), the aligned words
  // holding the row's scales of the stage.
  const int sw4 = 2 * wk + 1;
  const int c_blk = tid % sbc;
  const int c_row = tid / sbc;  // + 8 wr k
  const int c_dst = (c_row * sbc + (c_blk ^ (c_row & 7))) * 16;  // + 512 warps k
  int s_row[3], s_word[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int u = tid + threads * k;
    s_row[k] = u < rows * sw4 ? u / sw4 : -1;
    s_word[k] = u % sw4;
  }
  int i_row0 = 0, i_st = 0, i_ti = 0, issued = 0;
  if (total > 0) i_row0 = static_cast<int>(blockIdx.x) * rows;
  auto issue = [&]() {  // the next stage into slot issued % kStages
    if (issued < total) {
      uint8_t* slot = ring + (issued % kStages) * slot_bytes;
      const int nv = min(sbc, kn - sbc * i_st);
      const size_t b0 = static_cast<size_t>(k0) + sbc * i_st;
      if (c_blk < nv) {
        const uint8_t* src =
            qs + ((static_cast<size_t>(i_row0 + c_row)) * nb + b0 + c_blk) * 16;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (i_row0 + c_row + 8 * wr * k < d) {
            cp_async16(slot + c_dst + 512 * warps * k,
                       src + static_cast<size_t>(8 * wr * k) * nb * 16);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int row = i_row0 + s_row[k];
        if (s_row[k] >= 0 && row < d) {
          const uintptr_t a = d16_addr + 2 * (static_cast<size_t>(row) * nb + b0);
          if (s_word[k] < ((static_cast<int>(a & 2) + 2 * nv + 3) >> 2)) {
            cp_async4(slot + code_bytes + s_row[k] * sw + 4 * s_word[k],
                      reinterpret_cast<const void*>((a & ~uintptr_t(3)) +
                                                    4 * s_word[k]));
          }
        }
      }
      if (++i_st == stages) {
        i_st = 0;
        i_row0 = (static_cast<int>(blockIdx.x) + ++i_ti * gridDim.x) * rows;
      }
    }
    cp_async_commit();
    ++issued;
  };

#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue();

  // x[:, k0 .. k0 + kn) in P bf16 pieces, permuted to the B fragment:
  // 16-byte chunk ((b * C + P t + p) * 4 + c) holds piece p of values
  // 4c..4c+3 and 16+4c..16+4c+3 of block b of token t (read after the
  // first stage's barrier). P = 1: x rounded to nearest even. With kXLaid
  // the caller's copy holds this order for all nb blocks; nothing is staged.
  for (int i = tid; !kXLaid && i < kn * T * 4; i += threads) {
    const int cc = i & 3;
    const int bt = i >> 2;
    const int t = bt % T;
    const int b = bt / T;
    const float* src = x + static_cast<size_t>(t) * nb * 32 +
                       static_cast<size_t>(k0 + b) * 32 + 4 * cc;
    const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 16));
    if constexpr (P == 1) {
      *reinterpret_cast<uint4*>(xs + ((b * C + t) * 4 + cc) * 16) =
          make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                     pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    } else {
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t p[8][3];
#pragma unroll
      for (int e = 0; e < 8; ++e) split3(v[e], p[e]);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        *reinterpret_cast<uint4*>(xs + ((b * C + 3 * t + q) * 4 + cc) * 16) =
            make_uint4(pack_hi16(p[0][q], p[1][q]),
                       pack_hi16(p[2][q], p[3][q]),
                       pack_hi16(p[4][q], p[5][q]),
                       pack_hi16(p[6][q], p[7][q]));
      }
    }
  }

  const int my_row = 32 * wri + lane;  // this lane's ldmatrix row
  int n = 0;
  for (int ti = 0; ti < my_tiles; ++ti) {
    const int tile = static_cast<int>(blockIdx.x) + ti * gridDim.x;
    // the byte selector of each of rows 32 wri + 8i + g's scale pairs: its
    // window's bytes 0..7 or 2..9 (from the warp's first) hold its blocks
    uint32_t sel[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t row = min(tile * rows + 32 * wri + 8 * i + g, d - 1);
      sel[i] = 0x3210u + 0x1111u * static_cast<uint32_t>(
                                       (d16_addr + 2 * (row * nb + k0)) & 2);
    }
    float acc[2][M][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][m][e] = 0.f;
      }
    }
    for (int st = 0; st < stages; ++st, ++n) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage n has landed; stage n - 1 is read
      issue();          // into stage n - 1's slot
      const uint8_t* slot = ring + (n % kStages) * slot_bytes;
      const int live = min(4, kn - sbc * st - 4 * wki);  // my blocks
      if (live <= 0) continue;  // warp-uniform
      // my blocks' code words (word c of rows g, 8 + g, 16 + g, 24 + g of
      // the warp's 32) and scales (rows 8i + g) first
      uint32_t q4[4][4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        ldmatrix_x4(q4[jb], slot + (my_row * sbc +
                                    ((4 * wki + jb) ^ (my_row & 7))) * 16);
      }
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* w = slot + code_bytes + (32 * wri + 8 * i + g) * sw +
                           8 * wki;
        const uint2 w01 = *reinterpret_cast<const uint2*>(w);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(w + 8);
        const uint32_t s01 = __byte_perm(w01.x, w01.y, sel[i]);
        const uint32_t s23 = __byte_perm(w01.y, w2, sel[i]);
        const float2 f01 =
            __half22float2(*reinterpret_cast<const __half2*>(&s01));
        const float2 f23 =
            __half22float2(*reinterpret_cast<const __half2*>(&s23));
        sc[0][i] = f01.x;
        sc[1][i] = f01.y;
        sc[2][i] = f23.x;
        sc[3][i] = f23.y;
      }
      const int xb = (sbc * st + 4 * wki) * C * 4 + c;  // my blocks' chunks
      if constexpr (P == 1) {
        // the scales inside A: a fresh accumulator a stage (4 blocks, 8
        // k-steps) added into the f32 registers, as a tensor-core sum
        // over hundreds of k-steps drifts
        float f[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        auto block = [&](int jb) {
          // columns >= T: unused
          const uint4 bx = x_chunk(xb + (jb * C + min(g, C - 1)) * 4);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t la[2], ha[2], lb[2], hb[2], h0, l0, h1, l1;
            Codes::widen(q4[jb][2 * q], la, ha);
            Codes::widen(q4[jb][2 * q + 1], lb, hb);
            split_scale(sc[jb][2 * q], h0, l0);
            split_scale(sc[jb][2 * q + 1], h1, l1);
            const uint32_t a0[4] = {
                scaled_bf16(la[0], h0, l0), scaled_bf16(lb[0], h1, l1),
                scaled_bf16(la[1], h0, l0), scaled_bf16(lb[1], h1, l1)};
            const uint32_t a1[4] = {
                scaled_bf16(ha[0], h0, l0), scaled_bf16(hb[0], h1, l1),
                scaled_bf16(ha[1], h0, l0), scaled_bf16(hb[1], h1, l1)};
            mma_bf16_add(f[q], a0, bx.x, bx.y);
            mma_bf16_add(f[q], a1, bx.z, bx.w);
          }
        };
        if (live == 4) {  // warp-uniform: full stages run without branches
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) block(jb);
        } else {
          for (int jb = 0; jb < live; ++jb) block(jb);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][0][e] += f[q][e];
        }
      } else {
        auto block = [&](int jb) {
          uint4 bx[M];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int col = min(8 * m + g, C - 1);  // columns >= C: unused
            bx[m] = x_chunk(xb + (jb * C + col) * 4);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t la[2], ha[2], lb[2], hb[2];
            Codes::widen(q4[jb][2 * q], la, ha);
            Codes::widen(q4[jb][2 * q + 1], lb, hb);
            const uint32_t a0[4] = {la[0], lb[0], la[1], lb[1]};
            const uint32_t a1[4] = {ha[0], hb[0], ha[1], hb[1]};
            const float s0 = sc[jb][2 * q];
            const float s1 = sc[jb][2 * q + 1];
#pragma unroll
            for (int m = 0; m < M; ++m) {
              float f[4];
              mma_bf16_zero(f, a0, bx[m].x, bx[m].y);
              mma_bf16_add(f, a1, bx[m].z, bx[m].w);
              acc[q][m][0] = fmaf(s0, f[0], acc[q][m][0]);
              acc[q][m][1] = fmaf(s0, f[1], acc[q][m][1]);
              acc[q][m][2] = fmaf(s1, f[2], acc[q][m][2]);
              acc[q][m][3] = fmaf(s1, f[3], acc[q][m][3]);
            }
          }
        };
        if (live == 4) {  // warp-uniform: full stages run without branches
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) block(jb);
        } else {
          for (int jb = 0; jb < live; ++jb) block(jb);
        }
      }
    }

    // the tile: each warp's sums (C fragment: rows g, g + 8 of each group,
    // columns 8m + 2c, + 1) to shared memory, then warp by warp per row
    float* rw = red + warp * 32 * C;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * m + 2 * c + (e & 1);
          if (col < C) rw[(16 * q + g + 8 * (e >> 1)) * C + col] = acc[q][m][e];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * T; i += threads) {
      const int t = i / rows;
      const int r = i - t * rows;
      const int row = tile * rows + r;
      float y;
      if constexpr (P == 1) {
        y = 0.f;
        for (int k = 0; k < wk; ++k) {
          y += red[((k * wr + (r >> 5)) * 32 + (r & 31)) * C + t];
        }
      } else {
        float v0 = 0.f, v1 = 0.f, v2 = 0.f;
        for (int k = 0; k < wk; ++k) {
          const float* src = red + ((k * wr + (r >> 5)) * 32 + (r & 31)) * C +
                             3 * t;
          v0 += src[0];
          v1 += src[1];
          v2 += src[2];
        }
        y = v0 + (v1 + v2 * (1.f / 256.f)) * (1.f / 256.f);
      }
      if (row < d) {
        if (splits == 1) {
          out[static_cast<size_t>(t) * d + row] = y;
        } else {
          part[(static_cast<size_t>(split) * T + t) * d + row] = y;
        }
      }
    }
    if (splits > 1) {
      __threadfence();  // this split's sums, before its ticket
      __syncthreads();
      if (tid == 0) *last = atomicAdd(tickets + tile, 1) == splits - 1;
      __syncthreads();
      if (*last) {
        __threadfence();
        for (int i = tid; i < rows * T; i += threads) {
          const int t = i / rows;
          const int row = tile * rows + (i - t * rows);
          if (row >= d) continue;
          float y = 0.f;
          for (int s = 0; s < splits; ++s) {
            y += __ldcg(part + (static_cast<size_t>(s) * T + t) * d + row);
          }
          out[static_cast<size_t>(t) * d + row] = y;
        }
        if (tid == 0) tickets[tile] = 0;  // ready for the next launch
      }
    }
    __syncthreads();  // the sums and the flag are reused by the next tile
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// One launch of `kernel` (a matvec_body<T, P, kXLaid> entry point) under a
// plan from ops/q40.matvec_plan: wr x wk warps a block, grid_x blocks a
// split, `splits` splits of kb Q40 blocks. With kXLaid, x is the laid-out
// copy and no shared memory is asked for it.
template <int T, int P, bool kXLaid = false, typename Kernel>
int launch_matvec(Kernel kernel, const void* qs, const void* d16,
                  const void* x, void* out, void* part, void* tickets, int d,
                  int nb, int wr, int wk, int grid_x, int splits, int kb,
                  cudaStream_t stream, size_t (&granted)[kMaxDevices]) {
  if (d < 1 || nb < 1 || wr < 1 || wk < 2 || wr * wk > kMaxWarps ||
      grid_x < 1 || splits < 1 || kb < 1 || (splits - 1) * kb >= nb ||
      splits * kb < nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(T, kXLaid ? 0 : kb, wr, wk, P);
  const cudaError_t e = opt_in_smem(kernel, smem, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(grid_x, splits), wr * wk * 32, smem, stream>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(d16),
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), d, nb, wr, wk,
      kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
