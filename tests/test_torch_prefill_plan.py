"""The split plans of the redesigned ``--fast-prefill`` kernels, and K4b's
split arithmetic against the JAX package, on the CPU.

* ``ops/q40.gemm_bf16_plan`` (K3b's split K) and
  ``ops/attention.prefill_bf16_plan`` (K4b's split of the key range): every
  Q40 block, and every live key tile, falls in exactly one split, no split
  is empty, there are never more splits than blocks or tiles, a grid that
  already fills the card takes one split, and K3b's splits are never
  modelled slower than none.
* ``ops/attention.prefill_attention_bf16_splits``, a plain model of K4b's
  arithmetic (p rounded to bf16 against the running max of the tiles its
  own split has walked, the splits merged in f32 in order), against the
  JAX ``prefill_attention(bf16=True)`` in interpret mode, for 1, 2 and 4
  splits over f32 and bf16 caches, within the kernel's tolerance
  ``KERNEL_ATOL_BF16``: the rounding the split kernel does is admissible
  before it runs on a card.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention, q40

SMS = 132  # an H100 SXM's SMs


def _runs(n, splits, per):
    """The [lo, hi) runs of `splits` splits of `per` units over n units."""
    return [(z * per, min(n, (z + 1) * per)) for z in range(splits)]


def _covers_once(runs, n):
    units = [u for lo, hi in runs for u in range(lo, hi)]
    return all(hi > lo for lo, hi in runs) and units == list(range(n))


GEMM_SHAPES = [(t, d, n) for t in (9, 16, 17, 100, 128, 300, 512)
               for d, n in ((1, 32), (33, 32 * 129), (130, 11008),
                            (4096, 4096), (12288, 4096), (22016, 4096),
                            (4096, 11008))]


@pytest.mark.parametrize("t,d,n", GEMM_SHAPES)
@pytest.mark.parametrize("sms", [16, SMS])
def test_gemm_bf16_plan_puts_every_block_in_one_split(t, d, n, sms):
    nb = n // 32
    splits, per, wg = q40.gemm_bf16_plan(t, d, nb, sms)
    assert wg in q40.GEMM_BF16_WARPGROUPS
    q = q40.gemm_bf16_stage_blocks(t)
    stages = -(-nb // q)
    runs = _runs(stages, splits, per)
    assert _covers_once(runs, stages)
    # in Q40 blocks: stage s holds blocks q s .. q s + q - 1
    blocks = [(q * lo, min(nb, q * hi)) for lo, hi in runs]
    assert _covers_once(blocks, nb)
    assert 1 <= splits <= min(nb, q40.GEMM_BF16_MAX_SPLITS)
    grid = q40.gemm_bf16_blocks(t, d, wg)
    wave = q40.GEMM_BF16_WAVE_BLOCKS // q
    cost = q40._gemm_bf16_cost(grid, stages, splits, wg, sms, wave)
    for other in q40.GEMM_BF16_WARPGROUPS:  # never modelled slower unsplit
        assert cost <= q40._gemm_bf16_cost(q40.gemm_bf16_blocks(t, d, other),
                                           stages, 1, other, sms, wave)
    if any(q40.gemm_bf16_blocks(t, d, other) >= sms
           for other in q40.GEMM_BF16_WARPGROUPS):
        assert splits == 1  # a grid already fills the card
    if splits > 1:
        assert min(hi - lo for lo, hi in blocks[:-1]) >= \
            q40.GEMM_BF16_MIN_BLOCKS


def test_gemm_bf16_plan_at_7b_widths():
    """The plans measured fastest on the H100 at T = 128 (132 SMs): wqkv
    in 3-warpgroup blocks split in 2 (128 blocks), wo and w2 in 2-warpgroup
    blocks split in 4 (128), w13 in 3-warpgroup blocks unsplit (115); at
    T = 512 (four token tiles) 2-warpgroup blocks, w13's 3-warpgroup blocks
    split in 2 least."""
    shapes = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008)]
    for t, want in ((128, [(2, 3), (4, 2), (1, 3), (4, 2)]),
                    (512, [(1, 2), (1, 2), (1, 2), (1, 2)])):
        got = [q40.gemm_bf16_plan(t, d, n // 32, SMS) for d, n in shapes]
        assert [(splits, wg) for splits, _, wg in got] == want


@pytest.mark.parametrize("t", [9, 16, 17, 32, 33, 64, 65, 128, 129, 512])
def test_gemm_bf16_tile_holds_t(t):
    tile = q40.gemm_bf16_tile(t)
    assert tile in (16, 32, 64, 128)
    assert tile >= t or tile == 128
    assert q40.gemm_bf16_stage_blocks(t) == (2 if tile <= 32 else 4)


ATT_CASES = [(pos, t, kv_mul, n_kv)
             for pos in (0, 5, 384, 1920)
             for t, kv_mul, n_kv in ((2, 1, 2), (37, 1, 32), (128, 1, 32),
                                     (128, 8, 8), (70, 4, 2))]


@pytest.mark.parametrize("pos,t,kv_mul,n_kv", ATT_CASES)
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_prefill_bf16_plan_puts_every_tile_in_one_split(pos, t, kv_mul,
                                                        n_kv, cache):
    keys = attention.PREFILL_BF16_KEYS[cache]
    splits, per = attention.prefill_bf16_plan(pos, t, kv_mul, n_kv, keys,
                                              SMS)
    tiles = -(-(pos + t) // keys)
    runs = _runs(tiles, splits, per)
    assert _covers_once(runs, tiles)
    assert 1 <= splits <= min(tiles, attention.PREFILL_BF16_MAX_SPLITS)
    grid = n_kv * -(-(t * kv_mul) // attention.PREFILL_BF16_ITEMS)
    if grid >= attention.PREFILL_BF16_BLOCKS_PER_SM * SMS:
        assert splits == 1
    if splits > 1:
        assert min(hi - lo for lo, hi in runs[:-1]) >= \
            attention.PREFILL_BF16_MIN_TILES


def test_prefill_bf16_plan_fills_the_card_at_7b():
    """7B, T = 128, an f32 cache: 64 blocks unsplit; from pos 384 on the
    splits give every SM a block (4 splits, as measured fastest on the
    H100)."""
    for pos in (384, 1920):
        splits, _ = attention.prefill_bf16_plan(pos, 128, 1, 32, 32, SMS)
        assert 32 * 2 * splits >= SMS
        assert splits == 4
    assert attention.prefill_bf16_plan(0, 2, 1, 2, 32, SMS) == (1, 1)


# K4b's split arithmetic against the JAX kernel: the live prefix (256 keys)
# is 8 tiles of an f32 cache's 32 keys and 4 of a bf16 cache's 64; the JAX
# kernel walks it in one 512-key block
S, N_KV, HS, T_LEN, POS = 512, 2, 128, 16, 240


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("kv_mul", [1, 8])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_split_arithmetic_matches_pallas(splits, kv_mul, cache):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        prefill_attention as ref

    rng = np.random.default_rng(10 * kv_mul + splits)
    k_all, v_all = (rng.normal(size=(2, S, N_KV, HS)).astype(np.float32)
                    for _ in range(2))
    q = rng.normal(size=(T_LEN, N_KV * kv_mul, HS)).astype(np.float32)
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    layer = 1
    want = np.asarray(ref(jnp.asarray(q),
                          jnp.asarray(k_all[layer]).astype(jdt),
                          jnp.asarray(v_all[layer]).astype(jdt), POS,
                          kv_mul=kv_mul, bf16=True, interpret=True))
    keys = attention.PREFILL_BF16_KEYS[dt]
    got = attention.prefill_attention_bf16_splits(
        torch.from_numpy(q), torch.from_numpy(k_all).to(dt),
        torch.from_numpy(v_all).to(dt), layer, POS, kv_mul, keys, splits)
    assert got.shape == (T_LEN, N_KV * kv_mul * HS)
    err = np.abs(got.numpy() - want.reshape(T_LEN, -1)).max()
    assert err <= attention.KERNEL_ATOL_BF16, err
