"""Q40 matmul: five hand-written CUDA kernels and their plain PyTorch
versions.

``q40_matmul(w, x)`` computes ``out[t, r] = sum_b d16[r,b] * sum_j
(code[r,b,j] - 8) * x[t, 32b+j]`` in f32 on the codec layout (see
io/loader.Q40Weight), for T = x.numel() // n tokens. On a CUDA tensor it
dispatches on T as the JAX package's ops/pallas_q40.py ``q40_matmul`` does
on ``MULTI_T_MAX``:

* T = 1: K1, ``csrc/q40_matvec.cu`` ``q40_matvec`` (the T=1 matvec
  bodies, every TPU tiling), bound by the packed weight bytes;
* 2 <= T <= 8: K1m, ``csrc/q40_matvec.cu`` ``q40_matvec_multi``
  (``_kernel_multi`` -> ``_matvec_body_multi``), the same skeleton, one
  unpack of each weight block for all T rows. Both run their products on
  the tensor cores, exactly: x in three bf16 pieces (``bf16_split3``),
  code - 8 in bf16, a per-Q40-block sum scaled in f32
  (``q40_matmul_split_model`` is their arithmetic in plain torch), with
  the rows, blocks and K splits of ``matvec_plan``;
* T > 8: K3, ``csrc/q40_gemm.cu`` (``_kernel`` -> ``_matmul_body`` in f32
  parity mode, and its scratch / nb-major tilings), products on the tensor
  cores by the 3xTF32 split (wgmma fed by a TMA ring), as the JAX body's
  Precision.HIGHEST takes several passes on the matrix unit, each stage's
  product added into f32 registers (on an H100 within 7.0e-6 x max|out|
  up to 70B's w2, 896 Q40 blocks in one sum). A helper kernel of the
  same source belongs to it: ``q40_split_tf32`` splits x into its TF32
  hi and lo parts once per call; K3b's
  ``q40_gemm_bf16_reduce`` (an f32 sum) adds the split-K partials where
  ``gemm_tf32_plan`` splits K to fill the card;
* T > 8 with ``bf16=True`` (``--fast-prefill``, the JAX package's
  ``q40_matmul`` under ``matmul_precision("bf16")``): K3b,
  ``csrc/q40_gemm_bf16.cu``, the same sum over bf16-rounded x and
  bf16-rounded dequantized weights with f32 accumulation, on the tensor
  cores (wgmma fed by a TMA ring). Two helper kernels of the same source
  belong to it: ``q40_round_bf16`` rounds x once per call, and
  ``q40_gemm_bf16_reduce`` sums the split-K partials where
  ``gemm_bf16_plan`` splits K to fill the card. At T <= 8 the flag changes
  nothing, as the JAX package's T=1 and small-T bodies ignore it;
* 2 <= T <= 8 with ``multi_body="dequant"`` (the JAX package's
  ``DLLAMA_MULTI_T_BODY=dequant``, ``_kernel_multi_dequant``): K1d,
  ``csrc/q40_matvec_bf16.cu``, K3b's function at small T on the tensor
  cores, bound by the packed weight bytes as K1 is: K1m's skeleton
  (``csrc/q40_matvec.cuh``) with x in one bf16 piece and the rounded
  weight bf16((code - 8) * scale) as the MMA's A operand, with the rows,
  blocks and K splits of ``matvec_plan(..., pieces=1)``.

The body is an argument: the caller reads ``DLLAMA_MULTI_T_BODY`` once
(``multi_t_body``) and passes it down; the op never reads the environment.

The sources say how each design meets its bound. ``q40_matmul`` takes the
plain versions only for tensors on the CPU; on a CUDA tensor it launches
one of the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..io.loader import Q40Weight
from ._build import CudaKernel
from .quants import QK, dequantize_q40_torch

KERNEL = CudaKernel("q40_matvec.cu", "q40_matvec",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
KERNEL_MULTI = CudaKernel("q40_matvec.cu", "q40_matvec_multi",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p])
KERNEL_GEMM = CudaKernel("q40_gemm.cu", "q40_gemm",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
# K3's part: x split into its TF32 hi and lo once per call (its split-K
# sum is K3b's, KERNEL_GEMM_BF16_REDUCE, an f32 sum)
KERNEL_SPLIT_TF32 = CudaKernel("q40_gemm.cu", "q40_split_tf32",
                               [ctypes.c_void_p] * 3 + [ctypes.c_int]
                               + [ctypes.c_void_p])
KERNEL_GEMM_BF16 = CudaKernel("q40_gemm_bf16.cu", "q40_gemm_bf16",
                              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
# K3b's parts: x rounded to bf16 once per call, and the split-K sum (K3's
# too)
KERNEL_ROUND_BF16 = CudaKernel("q40_gemm_bf16.cu", "q40_round_bf16",
                               [ctypes.c_void_p] * 2 + [ctypes.c_int]
                               + [ctypes.c_void_p])
KERNEL_GEMM_BF16_REDUCE = CudaKernel("q40_gemm_bf16.cu",
                                     "q40_gemm_bf16_reduce",
                                     [ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 2
                                     + [ctypes.c_void_p])
KERNEL_MULTI_BF16 = CudaKernel("q40_matvec_bf16.cu", "q40_matvec_bf16",
                               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                               + [ctypes.c_void_p])
KERNELS = (KERNEL, KERNEL_MULTI, KERNEL_GEMM, KERNEL_GEMM_BF16,
           KERNEL_MULTI_BF16)
HELPERS = (KERNEL_ROUND_BF16, KERNEL_GEMM_BF16_REDUCE, KERNEL_SPLIT_TF32)
MULTI_T_BODIES = ("vpu", "dequant")

MULTI_T_MAX = 8  # T above this takes the GEMM (the JAX package's threshold)

_SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
_SMEM_PER_SM = 233472  # bytes of shared memory an SM holds for its blocks

# |kernel - plain| <= KERNEL_RTOL * max|plain|: they differ in summation
# order (and K3 by its 3xTF32 products, q40_matmul_tf32_model: ~2^-22
# relative per product)
KERNEL_RTOL = 1e-4
# the same for K3b and K1d against q40_matmul_bf16_plain: both sum the same
# exact products of bf16 values in f32, but the tensor cores add in another
# order and in wider steps than cuBLAS's f32 GEMM
KERNEL_RTOL_BF16 = 1e-3


# K3b's tiling (csrc/q40_gemm_bf16.cu): weight rows per consumer warpgroup
# and the warpgroup counts a block may have, and the split-K limits: a split
# walks at least GEMM_BF16_MIN_BLOCKS Q40 blocks, and at most
# GEMM_BF16_MAX_SPLITS partials are written
GEMM_BF16_WG_ROWS = 64
GEMM_BF16_WARPGROUPS = (2, 3)
GEMM_BF16_MIN_BLOCKS = 16
GEMM_BF16_MAX_SPLITS = 8
# a wave's fixed cost in Q40 blocks of its blocks' walk (the ring filling,
# the epilogue, the partials' sum), fitted to the H100's times at 7B's
# widths
GEMM_BF16_WAVE_BLOCKS = 32


# K3's tiling (csrc/q40_gemm.cu): K3b's blocks and split limits, over
# stages of one Q40 block. Its plan's cost, fitted to a sweep of every
# (splits, warpgroups) on the H100 at 7B's widths and T = 9..512: a wave's
# fixed cost of 2 stages, and a stage of a 3-warpgroup block 2.9 times one
# warpgroup's (its x tile serves 1.5x the rows of a 2-warpgroup block's).
# A 128-token tile takes 2 warpgroups only (gemm_tf32_warpgroups), and its
# grid splits even where it fills the card: 2-warpgroup blocks fill waves
# unevenly (w13 at T = 128 ran 1.30x faster in 3 splits than unsplit,
# tools/plan_sweep.py).
GEMM_TF32_STAGE_BLOCKS = 1
GEMM_TF32_WAVE_STAGES = 2
GEMM_TF32_WG_COST = {2: 2.0, 3: 2.9}
GEMM_TF32_SPLIT_FULL_TILE = 128


# K1's, K1m's and K1d's tiling (csrc/q40_matvec.cuh): a block of wr x wk
# warps (4 or 8; wk >= 2) walks row tiles of 32 wr rows over one K split,
# through a ring of MATVEC_STAGES stages of 4 wk Q40 blocks that all its
# threads copy (each row's codes, and the aligned words holding its scales)
# and each warp takes 4 blocks of; x staged in ``pieces`` bf16 pieces (64
# bytes each a Q40 block and token: three for K1 and K1m, one for K1d), a
# warp's sums pieces x T f32 a row. K1 and K1m up to T = 2, and K1d at
# every T, are built for 128 registers a thread (16 warps an SM); K1m
# above T = 2 for 255 (8). A split gives every warp a block of its first
# stage, and a split-K tile needs a ticket (MATVEC_TICKETS a device).
MATVEC_WARPS = (4, 8)
MATVEC_STAGES = 4
MATVEC_MAX_SPLITS = 64
MATVEC_TICKETS = 1 << 16
# the plan's cost, in bytes of weights streamed by the busiest SM: a block's
# fixed cost (its start, x staged once), a tile's (its warps' sums met in
# shared memory) and a split tile's (partials written, a ticket, the last
# block's sum)
MATVEC_BLOCK_BYTES = 16384
MATVEC_TILE_BYTES = 4096
MATVEC_SPLIT_BYTES = 16384


def matvec_smem(t: int, kb: int, wr: int, wk: int, pieces: int = 3,
                x_staged: bool = True) -> int:
    """Shared memory of a K1/K1m (``pieces`` 3) or K1d (1) block
    (csrc/q40_matvec.cuh smem_bytes): kb Q40 blocks of x in ``pieces``
    bf16 pieces for t tokens (none when x is read laid out from global
    memory, the probe's P2: ``x_staged`` False), the ring (a stage: 32 wr
    rows x 4 wk blocks of codes and each row's 8 wk + 8 bytes of scale
    words), each warp's 32 x pieces x t f32 sums, and a flag."""
    return ((kb if x_staged else 0) * pieces * t * 64
            + MATVEC_STAGES * (2048 * wr * wk + 32 * wr * (8 * wk + 8))
            + wr * wk * 32 * pieces * t * 4 + 16)


def matvec_blocks_per_sm(t: int, warps: int, smem: int,
                         pieces: int = 3) -> int:
    """K1/K1m/K1d blocks an SM holds: by its shared memory and by its
    registers (K1d, and K1/K1m up to T = 2, built for 128 a thread, 16
    warps an SM; K1m above, for 255, 8 warps)."""
    regs_warps = 16 if t <= 2 or pieces == 1 else 8
    return min(_SMEM_PER_SM // (smem + 1024), regs_warps // warps)


def _matvec_cost(t: int, d: int, kb: int, wr: int, grid_x: int,
                 splits: int, sms: int, x_staged: bool = True) -> float:
    """The modelled time of a K1/K1m plan, in bytes of the busiest SM: its
    blocks (as many as the grid puts on one SM) each walk their row tiles
    (32 wr rows x kb Q40 blocks of 18 bytes, plus a tile's fixed cost)
    after their own fixed cost and x's staging (t * kb * 128 bytes from
    L2, at half the weight's cost; none when x is not staged)."""
    rows = 32 * wr
    tiles = -(-d // rows)
    tile_bytes = (rows * kb * 18 + MATVEC_TILE_BYTES
                  + (MATVEC_SPLIT_BYTES if splits > 1 else 0))
    block = (-(-tiles // grid_x) * tile_bytes + MATVEC_BLOCK_BYTES
             + (t * kb * 64 if x_staged else 0))
    return -(-grid_x * splits // sms) * block


def matvec_plans(t: int, d: int, nb: int, sms: int, pieces: int = 3,
                 x_staged: bool = True):
    """Every K1/K1m (``pieces`` 3) or K1d (1) plan (wr, wk, grid_x, splits,
    kb) for T = t, d rows and nb Q40 blocks on ``sms`` SMs, with its
    modelled cost: blocks of wr x wk
    warps (MATVEC_WARPS, wk >= 2), ``splits`` K splits of kb blocks (the
    last possibly shorter, none empty) whose x and ring fit a block's
    shared memory, each split giving every warp a block of its first stage
    (4 wk blocks, or all nb), and grid_x blocks a split: one wave, as many
    as the SMs hold (matvec_blocks_per_sm), at most one a tile. Yields
    (cost, plan). ``x_staged`` False prices blocks that stage no x (the
    probe's P2)."""
    for splits in range(1, min(MATVEC_MAX_SPLITS, nb) + 1):
        kb = -(-nb // splits)
        if -(-nb // kb) != splits:
            continue
        last = nb - (splits - 1) * kb  # the shortest split
        for wr in (4, 2, 1):
            for wk in (2, 4, 8):
                warps = wr * wk
                if warps not in MATVEC_WARPS or last < min(nb, 4 * wk):
                    continue
                smem = matvec_smem(t, kb, wr, wk, pieces, x_staged)
                if smem > _SMEM_LIMIT:
                    continue
                per_sm = matvec_blocks_per_sm(t, warps, smem, pieces)
                tiles = -(-d // (32 * wr))
                grid_x = max(1, min(tiles, sms * per_sm // splits))
                yield (_matvec_cost(t, d, kb, wr, grid_x, splits, sms,
                                    x_staged),
                       (wr, wk, grid_x, splits, kb))


@functools.lru_cache(maxsize=None)
def matvec_plan(t: int, d: int, nb: int, sms: int, pieces: int = 3,
                x_staged: bool = True) -> tuple[int, int, int, int, int]:
    """(wr, wk, grid_x, splits, kb) of K1 (t = 1), K1m (t = 2..8) or, with
    one piece, K1d (t = 2..8): of the plans of matvec_plans whose blocks
    keep at least 96% of the SMs
    busy (all plans where none does), the one with the least modelled
    cost; on a tie the fewest splits, then the most rows a tile, then the
    most warps (the model does not see a block's warps: on the H100 8
    warps beat 4 at equal rows, by up to 1.35x at T = 3..5,
    tools/plan_sweep.py). ``x_staged`` False: the plan that blocks staging
    no x would take (printed beside the probe's P2, which runs K1's)."""
    plans = list(matvec_plans(t, d, nb, sms, pieces, x_staged))
    fill = [cp for cp in plans if cp[1][2] * cp[1][3] >= 0.96 * sms]
    best = min(((cost, plan[3], -plan[0], -plan[0] * plan[1]), plan)
               for cost, plan in fill or plans)
    return best[1]


def gemm_bf16_tile(t: int) -> int:
    """K3b's token tile (the wgmma N) for T tokens: 16, 32, 64 or 128;
    T > 128 takes ceil(T / 128) tiles."""
    return 16 if t <= 16 else 32 if t <= 32 else 64 if t <= 64 else 128


def gemm_bf16_stage_blocks(t: int) -> int:
    """Q40 blocks in one of K3b's k stages: 2 for token tiles up to 32, 4
    above (each measured the faster on the H100 at 7B's widths)."""
    return 2 if gemm_bf16_tile(t) <= 32 else 4


def gemm_tf32_warpgroups(t: int) -> tuple[int, ...]:
    """K3's warpgroup counts for T tokens: K3b's, but only 2 for a
    128-token tile (its accumulator and register sum need more registers
    than a thread of a 3-warpgroup block has)."""
    return (2,) if gemm_bf16_tile(t) == 128 else GEMM_BF16_WARPGROUPS


def gemm_bf16_blocks(t: int, d: int, warpgroups: int) -> int:
    """K3b's (and K3's) (token tiles x row tiles) grid with
    ``warpgroups`` x 64 rows a block."""
    return -(-t // gemm_bf16_tile(t)) * -(-d // (GEMM_BF16_WG_ROWS
                                                 * warpgroups))


def _gemm_bf16_cost(blocks: int, stages: int, splits: int,
                    warpgroups: float, sms: int, wave_stages: int) -> float:
    """K3b's (and K3's) modelled time under a plan, in one warpgroup's
    stages: waves of one block per SM (its ring takes most of the shared
    memory) times one block's walk (its longest split's stages plus the
    wave's fixed cost, each ``warpgroups`` wgmma groups deep on the SM's
    tensor cores)."""
    return (-(-blocks * splits // sms)
            * (-(-stages // splits) + wave_stages) * warpgroups)


def _gemm_plan(t: int, d: int, nb: int, sms: int, qb: int,
               wave_stages: int, wg_cost=None, split_full: bool = False,
               warpgroups=GEMM_BF16_WARPGROUPS) -> tuple[int, int, int]:
    """(splits, stages per split, warpgroups) of a split-K Q40 GEMM with
    K3b's blocks over k stages of ``qb`` Q40 blocks, minimising
    _gemm_bf16_cost over ``warpgroups`` (a count weighed by ``wg_cost``,
    itself where None); a grid that fills the card stays unsplit unless
    ``split_full`` (gemm_bf16_plan)."""
    stages = -(-nb // qb)
    fills = not split_full and any(
        gemm_bf16_blocks(t, d, wg) >= sms for wg in warpgroups)
    most = 1 if fills else max(1, min(GEMM_BF16_MAX_SPLITS,
                                      nb // GEMM_BF16_MIN_BLOCKS))

    def cost(plan):
        splits, wg = plan
        return (_gemm_bf16_cost(gemm_bf16_blocks(t, d, wg), stages, splits,
                                wg if wg_cost is None else wg_cost[wg], sms,
                                wave_stages),
                splits, wg)

    splits, wg = min(((s, wg) for s in range(1, most + 1)
                      for wg in warpgroups), key=cost)
    per = -(-stages // splits)
    return -(-stages // per), per, wg


@functools.lru_cache(maxsize=None)
def gemm_bf16_plan(t: int, d: int, nb: int,
                   sms: int) -> tuple[int, int, int]:
    """(splits, stages per split, warpgroups) of K3b for T tokens, d rows
    and nb Q40 blocks on a card of ``sms`` SMs. The k stages
    (gemm_bf16_stage_blocks blocks each) are cut into ``splits``
    contiguous runs of ``per`` stages, the
    last possibly shorter, none empty. One split where a (token tiles x
    row tiles) grid already fills the card; else up to
    GEMM_BF16_MAX_SPLITS splits of at least GEMM_BF16_MIN_BLOCKS blocks.
    The plan minimises _gemm_bf16_cost over GEMM_BF16_WARPGROUPS and those
    splits; on a tie the fewest splits (each adds its partials' traffic),
    then the fewest warpgroups. Measured on the H100 at 7B's widths, the
    time follows one block's walk once the blocks fit in one wave, which
    the cost says."""
    qb = gemm_bf16_stage_blocks(t)
    return _gemm_plan(t, d, nb, sms, qb, GEMM_BF16_WAVE_BLOCKS // qb)


@functools.lru_cache(maxsize=None)
def gemm_tf32_plan(t: int, d: int, nb: int,
                   sms: int) -> tuple[int, int, int]:
    """(splits, Q40 blocks per split, warpgroups) of K3: K3b's rule
    (gemm_bf16_plan) over stages of GEMM_TF32_STAGE_BLOCKS block, with
    K3b's token tiles (gemm_bf16_tile) and 64-row warpgroups, and K3's own
    wave cost, warpgroup weights, rule for full grids
    (GEMM_TF32_SPLIT_FULL_TILE) and warpgroup counts
    (gemm_tf32_warpgroups)."""
    return _gemm_plan(t, d, nb, sms, GEMM_TF32_STAGE_BLOCKS,
                      GEMM_TF32_WAVE_STAGES, GEMM_TF32_WG_COST,
                      gemm_bf16_tile(t) == GEMM_TF32_SPLIT_FULL_TILE,
                      gemm_tf32_warpgroups(t))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the split plans' card width); cached, as
    the plans are: both sit on every prefill matmul's host path."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def multi_t_body() -> str:
    """The 2 <= T <= 8 body the JAX package picks: ``DLLAMA_MULTI_T_BODY``,
    'vpu' (the default: the exact f32 K1m) or 'dequant' (bf16 products with
    f32 accumulation: K1d). An unknown value raises, as a typo would
    otherwise run the default. Read once by the engines, never by
    ``q40_matmul``."""
    import os

    mode = os.environ.get("DLLAMA_MULTI_T_BODY") or "vpu"  # '' = unset
    if mode not in MULTI_T_BODIES:
        raise ValueError(f"DLLAMA_MULTI_T_BODY={mode!r}: expected "
                         f"vpu|dequant")
    return mode


def random_q40(d: int, n: int, device, generator: torch.Generator
               ) -> Q40Weight:
    """A (d, n) Q40 weight with uniform random codes and scales in
    [1e-4, 0.0101), made on ``device`` from ``generator`` — the input on
    which the kernels are held against their plain version."""
    nb = n // QK
    qs = torch.randint(0, 256, (d, nb, 16), dtype=torch.uint8, device=device,
                       generator=generator)
    d16 = (torch.rand((d, nb), device=device, generator=generator) * 0.01
           + 1e-4).to(torch.float16)
    return Q40Weight(qs, d16)


def sweep_q40(device, d: int = 16384, nb: int = 4) -> Q40Weight:
    """A (d, 32 nb) Q40 weight whose scales take every finite f16 bit
    pattern (63488, subnormals, zeros and the largest included; the rest of
    the d x nb blocks repeat the largest magnitudes) and whose blocks hold
    every code 0..15, rotated block by block: the input on which K1d must
    read back its bf16-rounded weights bit for bit."""
    import numpy as np

    bits = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    s = torch.from_numpy(bits[np.isfinite(bits)].copy())
    order = torch.argsort(s.to(torch.float32).abs(), descending=True)
    scales = torch.cat([s, s[order][:max(0, d * nb - s.numel())]])
    codes = (torch.arange(QK)[None, :]
             + torch.arange(d * nb)[:, None]) % 16
    qs = (codes[:, :16] | (codes[:, 16:] << 4)).to(torch.uint8)
    return Q40Weight(qs.reshape(d, nb, 16).to(device),
                     scales[:d * nb].reshape(d, nb).to(device))


def _tokens(w: Q40Weight, x: torch.Tensor) -> int:
    return x.numel() // (w.qs.shape[-2] * QK)


def q40_matmul_bf16_plain(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """K3b's function: x and the dequantized weight rounded to bf16 (nearest
    even; the weight after its exact f32 product with the scale), then one
    f32 product. A product of two bf16 values is exact in f32, so this is
    the JAX package's bf16 einsum up to the order of the sum."""
    xb = x.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    wb = dequantize_q40_torch(w.qs, w.d16).to(torch.bfloat16)
    return F.linear(xb, wb.to(torch.float32))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    value with the low 13 mantissa bits zero, ties away from zero (adding
    half a unit to the magnitude's bits, then clearing them)."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of f32 x: hi = tf32(x), lo = tf32(x - hi) (x - hi
    is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def bf16_split3(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The three bf16 pieces of f32 x that K1 and K1m stage (csrc/q40_tc.cuh
    split3), as f32 tensors of bf16 values: p0 = x with its low 16 bits
    cleared, p1 = the same cut of r1 = (x - p0) * 2^8, p2 = (r1 - p1) * 2^8,
    so x = p0 + p1 * 2^-8 + p2 * 2^-16 exactly for every finite x."""
    x = x.to(torch.float32).contiguous()
    p0 = (x.view(torch.int32) & -0x10000).view(torch.float32)
    r1 = (x - p0) * 256.0
    p1 = (r1.view(torch.int32) & -0x10000).view(torch.float32)
    return p0, p1, (r1 - p1) * 256.0


def split_sums(codes: torch.Tensor, d16: torch.Tensor,
               pieces: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The arithmetic of q40_matmul_split_model from its operands: codes
    (d, nb, 32) f32, code - 8 in the order of the block's values; d16 (d,
    nb) the f16 scales; pieces the three (T, nb, 32) f32 bf16 pieces of x.
    Each piece's exact products with the codes summed per Q40 block in
    f32, scaled by the block's scale and summed over the blocks in f32,
    then the pieces joined as p0 + (p1 + p2 / 2^8) / 2^8: (T, d)."""
    scale = d16.to(torch.float32)
    sums = [(torch.einsum("tbj,rbj->trb", p, codes) * scale).sum(-1)
            for p in pieces]
    return sums[0] + (sums[1] + sums[2] / 256.0) / 256.0


def q40_matmul_split_model(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """K1's and K1m's arithmetic in plain torch (a model for the tests; no
    route calls it): x in its three bf16 pieces (bf16_split3), each piece's
    exact products with code - 8 summed per Q40 block in f32, scaled by the
    block's f16 scale and summed over the blocks in f32, then the pieces
    joined as p0 + (p1 + p2 / 2^8) / 2^8 (split_sums)."""
    d, nb = w.qs.shape[-3], w.qs.shape[-2]
    codes = torch.cat([w.qs & 0xF, w.qs >> 4], -1).to(torch.float32) - 8.0
    xt = x.to(torch.float32).reshape(-1, nb, QK)
    out = split_sums(codes, w.d16, bf16_split3(xt))
    return out.reshape(*x.shape[:-1], d)


def q40_matmul_tf32_model(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """K3's rounding in plain torch (a model for the tests; no route calls
    it): the dequantized weight split exactly into w_hi + w_lo, x into
    x_hi + x_lo, and the three products W_hi.x_hi + W_hi.x_lo + W_lo.x_hi
    in f32 (each product of two TF32 values is exact in f32)."""
    w_hi, w_lo = tf32_split(dequantize_q40_torch(w.qs, w.d16))
    x_hi, x_lo = tf32_split(x)
    return (F.linear(x_hi, w_hi) + F.linear(x_lo, w_hi)
            + F.linear(x_hi, w_lo))


def _bf16_body(t: int, bf16: bool, multi_body: str) -> bool:
    """Whether T tokens take bf16 products: T > 8 under ``bf16`` (K3b),
    2 <= T <= 8 under the 'dequant' body (K1d)."""
    if multi_body not in MULTI_T_BODIES:
        raise ValueError(f"q40_matmul: multi_body {multi_body!r}, expected "
                         f"one of {MULTI_T_BODIES}")
    if t > MULTI_T_MAX:
        return bf16
    return t >= 2 and multi_body == "dequant"


def q40_matmul_plain(w: Q40Weight, x: torch.Tensor, bf16: bool = False,
                     multi_body: str = "vpu") -> torch.Tensor:
    """Dequantize, then one f32 product: out[..., d] = W(d, n) @ x[..., n].
    The plain version of K1, K1m and K3 alike; with ``bf16`` and T > 8, or
    with ``multi_body="dequant"`` and 2 <= T <= 8, that of K3b and K1d
    (q40_matmul_bf16_plain)."""
    if _bf16_body(_tokens(w, x), bf16, multi_body):
        return q40_matmul_bf16_plain(w, x)
    return F.linear(x.to(torch.float32), dequantize_q40_torch(w.qs, w.d16))


def _check(w: Q40Weight, x: torch.Tensor) -> tuple[int, int]:
    qs, d16 = w.qs, w.d16
    if qs.dim() != 3 or qs.shape[-1] != 16 or qs.dtype != torch.uint8:
        raise ValueError(f"q40_matmul: qs must be uint8 (d, nb, 16), got "
                         f"{qs.dtype} {tuple(qs.shape)}")
    d, nb = qs.shape[0], qs.shape[1]
    if d16.dtype != torch.float16 or tuple(d16.shape) != (d, nb):
        raise ValueError(f"q40_matmul: d16 must be float16 ({d}, {nb}), got "
                         f"{d16.dtype} {tuple(d16.shape)}")
    if x.dtype != torch.float32 or x.shape[-1] != nb * QK:
        raise ValueError(f"q40_matmul: x must be float32 (..., {nb * QK}), "
                         f"got {x.dtype} {tuple(x.shape)}")
    for name, t in (("qs", qs), ("d16", d16), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"q40_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"q40_matmul: {name} must be contiguous")
    for name, t in (("qs", qs), ("x", x)):
        if t.data_ptr() % 16:
            raise ValueError(f"q40_matmul: {name} must be 16-byte aligned")
    return d, nb


_TICKETS: dict[int, torch.Tensor] = {}


def _tickets(device: torch.device) -> torch.Tensor:
    """K1's, K1m's and K1d's split-K tickets on ``device``: MATVEC_TICKETS int32
    zeros, made on the first call there (an eager one: every captured path
    runs its first step eagerly) and left zeroed by every launch. Every
    launch on the device shares them, so the port launches K1, K1m and K1d
    on one stream at a time."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    tickets = _TICKETS.get(index)
    if tickets is None:
        tickets = _TICKETS[index] = torch.zeros(
            MATVEC_TICKETS, dtype=torch.int32, device=device)
    return tickets


def q40_matmul(w: Q40Weight, x: torch.Tensor, bf16: bool = False,
               multi_body: str = "vpu") -> torch.Tensor:
    """out[..., d] = dequant(w)(d, n) @ x[..., n], f32.

    CPU tensors take the plain version; CUDA tensors launch K1 (T = 1), for
    2 <= T <= 8 K1m (``multi_body="vpu"``) or K1d ("dequant"), and for
    T > 8 K3 (f32) or K3b (``bf16``). K1, K1m and K1d are one launch each
    at any width, their split-K sums included.
    """
    if x.device.type == "cpu" and w.qs.device.type == "cpu":
        return q40_matmul_plain(w, x, bf16, multi_body)
    if x.device.type != "cuda":
        raise ValueError(f"q40_matmul: no kernel for device {x.device}")
    d, nb = _check(w, x)
    t = _tokens(w, x)
    out = torch.empty((*x.shape[:-1], d), dtype=torch.float32,
                      device=x.device)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if t > MULTI_T_MAX:
        _gemm(w, x, out, t, d, nb, stream, bf16)
    else:
        _matvec(w, x, out, t, d, nb, stream,
                1 if _bf16_body(t, bf16, multi_body) else 3)
    return out


def _matvec(w: Q40Weight, x: torch.Tensor, out: torch.Tensor, t: int,
            d: int, nb: int, stream: int, pieces: int,
            kernel: CudaKernel | None = None) -> None:
    """K1 (t = 1), K1m (``pieces`` 3) or K1d (1) over matvec_plan's blocks
    and K splits; with more than one split the kernel's last block per
    tile adds the partials (scratch (splits, t, d)) behind a ticket. At
    t = 1 ``kernel`` may name another kernel of K1's arguments and plan
    (the Q40 layout probe's P2 and P4, tools/nb_probe.py)."""
    plan = matvec_plan(t, d, nb, sm_count(x.device), pieces)
    wr, splits = plan[0], plan[3]
    if splits > 1 and -(-d // (32 * wr)) > MATVEC_TICKETS:
        raise ValueError(f"q40_matmul: {d} rows need more split-K tickets "
                         f"than the {MATVEC_TICKETS} kept")
    part = out if splits == 1 else torch.empty(
        (splits, t, d), dtype=torch.float32, device=x.device)
    ptrs = (w.qs.data_ptr(), w.d16.data_ptr(), x.data_ptr(), out.data_ptr(),
            part.data_ptr(), _tickets(x.device).data_ptr())
    if t == 1:
        (kernel or KERNEL).launch(*ptrs, d, nb, *plan, stream)
    else:
        kernel = KERNEL_MULTI if pieces == 3 else KERNEL_MULTI_BF16
        kernel.launch(*ptrs, t, d, nb, *plan, stream)


def _gemm(w: Q40Weight, x: torch.Tensor, out: torch.Tensor, t: int,
          d: int, nb: int, stream: int, bf16: bool) -> None:
    """K3, or with ``bf16`` K3b: x prepared once (K3: split into TF32 hi
    and lo by q40_split_tf32; K3b: rounded to bf16 by q40_round_bf16), the
    GEMM over its plan's splits (gemm_tf32_plan, gemm_bf16_plan), and with
    more than one split the sum of the partials in split order
    (q40_gemm_bf16_reduce for both)."""
    n = nb * QK
    if bf16:
        xs = [torch.empty((t, n), dtype=torch.bfloat16, device=x.device)]
        x_pass, gemm, plan = (KERNEL_ROUND_BF16, KERNEL_GEMM_BF16,
                              gemm_bf16_plan)
    else:
        xs = list(torch.empty((2, t, n), dtype=torch.float32,
                              device=x.device))
        x_pass, gemm, plan = (KERNEL_SPLIT_TF32, KERNEL_GEMM,
                              gemm_tf32_plan)
    ptrs = [p.data_ptr() for p in xs]
    x_pass.launch(x.data_ptr(), *ptrs, x.numel(), stream)
    splits, _, wg = plan(t, d, nb, sm_count(x.device))
    part = out if splits == 1 else torch.empty(
        (splits, t, d), dtype=torch.float32, device=x.device)
    gemm.launch(w.qs.data_ptr(), w.d16.data_ptr(), *ptrs, part.data_ptr(),
                t, d, nb, splits, wg, stream)
    if splits > 1:
        KERNEL_GEMM_BF16_REDUCE.launch(part.data_ptr(), out.data_ptr(),
                                       t * d, splits, stream)
