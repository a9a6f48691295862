"""K2's and K5's keys split across the grid (csrc/flash_decode.cuh
decode_splits, merged in split order behind a ticket) on the CPU: the split
rule (``ops/attention.decode_plan`` / ``decode_splits``) and a plain-torch
model of the kernels' split-and-merge arithmetic
(``attention.decode_attention_split_model``: each split's online-softmax
state in f32, merged in split order) against the JAX package's Pallas
``decode_attention`` and ``decode_attention_batch`` in interpret mode at
rtol/atol 1e-5 (the tolerance tests/test_pallas_attention.py holds the
Pallas kernel to: f32 softmax in another summation order), and against the
plain versions within KERNEL_ATOL, which the kernels are held to on the
card. Positions: 0, 1, either side of every change of the split count and
S - 1; MHA and GQA (kv_mul 1 and 8), f32 and bf16 caches, B = 1 and 3 with
ragged clocks."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention

SMS = 132  # an H100's SMs
S = 256
TOL = 1e-5
# (n_kv, kv_mul, hs): MHA and GQA
SHAPES = {"mha": (4, 1, 128), "gqa": (2, 8, 64)}
# the production rule on an H100 at B = 1 and 3, and a narrow one whose
# split count changes every 16 keys up to 4 splits
PLANS = {"h100": None, "narrow": (4, 16)}


def _plan(name, n_kv, batch):
    return PLANS[name] or attention.decode_plan(n_kv, batch, SMS)


def _boundaries(plan):
    """pos 0, 1, S - 1 and either side of every change of the split
    count."""
    out = {0, 1, S - 1}
    last = attention.decode_splits(1, plan)[0]
    for keys in range(2, S + 1):
        now = attention.decode_splits(keys, plan)[0]
        if now != last:
            out |= {keys - 2, keys - 1}
        last = now
    return sorted(out)


@pytest.mark.parametrize("plan", [(1, 1), (8, 128), (32, 128), (4, 16),
                                  (32, 1), (3, 50)])
def test_splits_cover_the_keys_once(plan):
    most, least = plan
    for keys in [*range(1, 300), 1000, 1001, 2047, 2048]:
        splits, per = attention.decode_splits(keys, plan)
        assert 1 <= splits <= most
        assert (splits - 1) * per < keys <= splits * per  # none empty
        if keys <= least:
            assert splits == 1
        # K5's grid covers a full cache's plan: no position needs more
        assert splits <= max(1, min(most, -(-2048 // least)))


@pytest.mark.parametrize("n_kv", [1, 2, 4, 8, 32, 64])
@pytest.mark.parametrize("batch", [1, 3, 8, 64])
def test_plan_fills_the_card(n_kv, batch):
    most, least = attention.decode_plan(n_kv, batch, SMS)
    assert least == attention.DECODE_SPLIT_KEYS
    assert 1 <= most <= attention.DECODE_MAX_SPLITS
    budget = attention.DECODE_BLOCKS_PER_SM * SMS
    assert most == 1 or most * n_kv * batch <= budget
    assert (most == attention.DECODE_MAX_SPLITS
            or (most + 1) * n_kv * batch > budget)


@pytest.mark.parametrize("n_kv", [8, 32])
def test_k2_and_k5_at_b1_take_one_plan(n_kv):
    """K2 (int pos) and K5 at B = 1 (device pos) split alike at every
    position, so the --fast step's attention gives the host loop's bits."""
    k2 = attention.decode_plan(n_kv, 1, SMS)
    k5 = attention.decode_plan(n_kv, 1, SMS)
    assert k2 == k5 and k2[0] > 1
    assert [attention.decode_splits(p + 1, k2) for p in range(2048)] == \
        [attention.decode_splits(p + 1, k5) for p in range(2048)]


def test_the_kernel_source_holds_the_rule_constants():
    """The kernels' twin of the rule: its split cap and formula, in the
    walk that decode_attention.cu and paged_attention.cu share."""
    src = (Path(attention.__file__).resolve().parent.parent / "csrc"
           / "flash_decode.cuh").read_text()
    cap = re.search(r"constexpr int kMaxSplits = (\d+);", src)
    assert cap and int(cap.group(1)) == attention.DECODE_MAX_SPLITS
    want = src[src.index("int decode_want("):]
    want = want[:want.index("}")]
    assert "need = (keys + least - 1) / least" in want
    assert "want = need < most ? need : most" in want
    assert "return want > 1 ? want : 1" in want
    body = src[src.index("void decode_splits("):]
    body = body[:body.index("}")]
    assert "want = decode_want(keys, most, least)" in body
    assert "per = (keys + want - 1) / want" in body
    assert "splits = (keys + per - 1) / per" in body


def _inputs(shape, batch, seed):
    n_kv, kv_mul, hs = shape
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2 * batch, S, n_kv, hs)).astype(np.float32)
    v = rng.standard_normal((2 * batch, S, n_kv, hs)).astype(np.float32)
    q = rng.standard_normal((batch, n_kv * kv_mul, hs)).astype(np.float32)
    return q, k, v


def _caches(k, v, cache):
    import jax.numpy as jnp

    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if cache == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    return tk, tv, jk, jv


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_model_matches_pallas_decode(shape, cache, plan):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        decode_attention as ref

    n_kv, kv_mul, hs = SHAPES[shape]
    q, k, v = _inputs(SHAPES[shape], 1, seed=len(shape) * 10 + len(cache))
    tk, tv, jk, jv = _caches(k, v, cache)
    p = _plan(plan, n_kv, 1)
    layer = 1
    positions = _boundaries(p)
    assert len({attention.decode_splits(x + 1, p)[0]
                for x in positions}) > 1
    for pos in positions:
        want = np.asarray(ref(jnp.asarray(q[0]), jk, jv, layer, pos,
                              kv_mul=kv_mul, interpret=True))
        got = attention.decode_attention_split_model(
            torch.from_numpy(q[0]), tk, tv, layer, pos, kv_mul, p)
        assert tuple(got.shape) == want.shape == (1, n_kv * kv_mul * hs)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=f"pos {pos}")


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_model_matches_pallas_decode_batch(shape, cache, plan):
    """B = 3 with ragged clocks: each row splits by its own position under
    the plan of the batch."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        decode_attention_batch as ref

    n_kv, kv_mul, hs = SHAPES[shape]
    batch = 3
    q, k, v = _inputs(SHAPES[shape], batch, seed=7 + len(shape) + len(cache))
    tk, tv, jk, jv = _caches(k, v, cache)
    p = _plan(plan, n_kv, batch)
    edges = _boundaries(p)
    for pos in ([0, edges[len(edges) // 2], S - 1],
                [edges[-2], 1, edges[2]]):
        pv = np.asarray(pos, np.int32)
        for layer in range(2):
            want = np.asarray(ref(jnp.asarray(q), jk, jv, layer,
                                  jnp.asarray(pv), kv_mul=kv_mul,
                                  interpret=True))
            got = attention.decode_attention_split_model(
                torch.from_numpy(q), tk, tv, layer, pos, kv_mul, p)
            assert tuple(got.shape) == want.shape == (batch,
                                                      n_kv * kv_mul * hs)
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                       atol=TOL, err_msg=f"{pos} {layer}")


@pytest.mark.parametrize("plan", [(8, 128), (32, 128), (4, 16), (32, 1),
                                  (3, 50)])
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_model_matches_plain(shape, cache, plan):
    """The model within KERNEL_ATOL of the plain versions, which the
    kernels are held to on the card, for K2 and for K5 at B = 3."""
    n_kv, kv_mul, hs = SHAPES[shape]
    g = torch.Generator().manual_seed(plan[0] * 1000 + plan[1])
    k = torch.randn((6, S, n_kv, hs), generator=g).to(cache)
    v = torch.randn((6, S, n_kv, hs), generator=g).to(cache)
    q = torch.randn((3, n_kv * kv_mul, hs), generator=g)
    edges = _boundaries(plan)
    for pos in edges[::max(1, len(edges) // 12)] + [S - 1]:
        got = attention.decode_attention_split_model(q[0], k, v, 1, pos,
                                                     kv_mul, plan)
        want = attention.decode_attention_plain(q[0], k, v, 1, pos, kv_mul)
        assert (got - want).abs().max().item() <= attention.KERNEL_ATOL, pos
    pv = [S - 1, 0, _boundaries(plan)[3]]
    got = attention.decode_attention_split_model(q, k, v, 1, pv, kv_mul,
                                                 plan)
    want = attention.decode_attention_batch_plain(
        q, k, v, 1, torch.tensor(pv, dtype=torch.int32), kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


def test_one_split_is_the_plain_walk_order():
    """Under ONE_SPLIT the model is one online-softmax state over keys
    0..pos: the plain attention within rounding."""
    g = torch.Generator().manual_seed(3)
    k = torch.randn((2, S, 2, 64), generator=g)
    v = torch.randn((2, S, 2, 64), generator=g)
    q = torch.randn((4, 64), generator=g)
    for pos in (0, 100, S - 1):
        assert attention.decode_splits(pos + 1, attention.ONE_SPLIT) == \
            (1, pos + 1)
        got = attention.decode_attention_split_model(
            q, k, v, 0, pos, 2, attention.ONE_SPLIT)
        want = attention.decode_attention_plain(q, k, v, 0, pos, 2)
        assert (got - want).abs().max().item() <= attention.KERNEL_ATOL
