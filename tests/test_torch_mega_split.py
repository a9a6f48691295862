"""K10's attention split across the grid (csrc/fused_layer.cu
key_splits / attention_split) on the CPU: the split rule
(``ops/layer.mega_attention_splits``) and a plain-torch model of the
split-and-merge order (``ops/layer.mega_attention_split_model``: each key
split's online-softmax state in f32, merged in split order) against the
plain decode attention (``attention.decode_attention_plain``, which K10's
attention part is held to on the card) within its 1e-5 abs tolerance, at
pos 0, 1 and either side of the split boundaries, MHA and GQA, over f32
and bf16 caches, on grids of one and two blocks an SM of an H100."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention, layer

GRIDS = (132, 264)  # co-resident blocks: one or two an SM of an H100
SEQ = 2048


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("n_kv", [1, 8, 32])
def test_splits_cover_the_keys_once(grid, n_kv):
    for keys in [*range(1, 80), 1023, 1024, 1025, 2047, 2048]:
        splits, per = layer.mega_attention_splits(keys, n_kv, grid)
        assert 1 <= splits <= layer.MEGA_MAX_SPLITS
        assert splits == 1 or splits * n_kv <= grid
        assert (splits - 1) * per < keys <= splits * per  # none empty
        assert splits == 1 or per >= layer.MEGA_SPLIT_KEYS // 2
        if keys <= layer.MEGA_SPLIT_KEYS:
            assert splits == 1


def _boundaries(n_kv, grid):
    """pos 0, 1 and either side of every change of the split count."""
    out = {0, 1, SEQ - 1}
    last = layer.mega_attention_splits(1, n_kv, grid)
    for keys in range(2, SEQ + 1):
        now = layer.mega_attention_splits(keys, n_kv, grid)
        if now[0] != last[0]:
            out |= {keys - 2, keys - 1, keys}
        last = now
    return sorted(p for p in out if 0 <= p < SEQ)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("n_kv,kv_mul,hs", [(8, 1, 16), (2, 4, 32),
                                            (32, 1, 8)])
def test_split_model_matches_plain_attention(cache, grid, n_kv, kv_mul, hs):
    rng = np.random.default_rng(n_kv * 100 + kv_mul)
    shape = (2, SEQ, n_kv, hs)
    k = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cache)
    v = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cache)
    q = torch.from_numpy(rng.standard_normal((n_kv * kv_mul, hs),
                                             np.float32))
    positions = _boundaries(n_kv, grid)
    assert len(positions) > 4
    for pos in positions:
        want = attention.decode_attention_plain(q, k, v, 1, pos, kv_mul)
        got = layer.mega_attention_split_model(q, k, v, 1, pos, kv_mul, grid)
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= attention.KERNEL_ATOL, (pos, err)


def test_phase_stamps_fit_the_kernel():
    """tools/k10_phases.py stamps each phase of this tree's K10 at exactly
    one place."""
    from distributed_llama_tpu_torch.ops import _build
    from distributed_llama_tpu_torch.tools import k10_phases

    text = k10_phases.stamped((_build.CSRC / "fused_layer.cu").read_text(),
                              "current")
    assert text.count("STAMP(") == len(k10_phases.PHASES) + 1  # + #define
