"""Port decode attention (K2 wrapper, CPU tensors -> plain version) vs the
JAX package's Pallas ``decode_attention`` in interpret mode.

Tolerance rtol/atol 1e-5, the one tests/test_pallas_attention.py holds the
Pallas kernel to: f32 softmax in another summation order.
"""

import numpy as np
import pytest
import torch

L, S, N_KV, HS = 3, 32, 4, 128


def _inputs(kv_mul, seed):
    rng = np.random.default_rng(seed)
    k_all = rng.normal(size=(L, S, N_KV, HS)).astype(np.float32)
    v_all = rng.normal(size=(L, S, N_KV, HS)).astype(np.float32)
    q = rng.normal(size=(N_KV * kv_mul, HS)).astype(np.float32)
    return q, k_all, v_all


@pytest.mark.parametrize("kv_mul", [1, 2])
@pytest.mark.parametrize("pos", [0, 15, S - 1])
def test_plain_matches_pallas_interpret(kv_mul, pos):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        decode_attention as ref
    from distributed_llama_tpu_torch.ops import attention

    q, k_all, v_all = _inputs(kv_mul, seed=pos * 7 + kv_mul)
    layer = 1
    want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k_all),
                          jnp.asarray(v_all), layer, pos, kv_mul=kv_mul,
                          interpret=True))
    before = attention.KERNEL.launches
    got = attention.decode_attention(torch.from_numpy(q),
                                     torch.from_numpy(k_all),
                                     torch.from_numpy(v_all), layer, pos,
                                     kv_mul)
    assert attention.KERNEL.launches == before
    assert tuple(got.shape) == want.shape == (1, N_KV * kv_mul * HS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_mul", [1, 2])
def test_stale_suffix_is_invisible(kv_mul):
    """Cache entries past pos (left by an earlier, longer run) must not
    change the result: poison them and compare bitwise."""
    from distributed_llama_tpu_torch.ops.attention import decode_attention

    q, k_all, v_all = _inputs(kv_mul, seed=11)
    pos = 7
    a = decode_attention(torch.from_numpy(q), torch.from_numpy(k_all),
                         torch.from_numpy(v_all), 0, pos, kv_mul)
    k_all[:, pos + 1:] = 1e6
    v_all[:, pos + 1:] = -1e6
    b = decode_attention(torch.from_numpy(q), torch.from_numpy(k_all),
                         torch.from_numpy(v_all), 0, pos, kv_mul)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kv_mul", [1, 4])
def test_attention_core_matches_reference(kv_mul):
    """The shared attention math against the JAX attention_core with a
    causal mask over T=3 queries (rtol/atol 1e-5)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import attention_core as ref
    from distributed_llama_tpu.models.llama import causal_cache_mask
    from distributed_llama_tpu_torch.models.llama import attention_core

    rng = np.random.default_rng(kv_mul)
    hs, n_kv, t_len, pos = 16, 2, 3, 5
    q = rng.normal(size=(t_len, n_kv * kv_mul, hs)).astype(np.float32)
    k = rng.normal(size=(S, n_kv, hs)).astype(np.float32)
    v = rng.normal(size=(S, n_kv, hs)).astype(np.float32)
    mask = causal_cache_mask(S, jnp.int32(pos), t_len)
    want = np.asarray(ref(hs, kv_mul, jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v), mask))
    got = attention_core(hs, kv_mul, torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v),
                         torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_checks_before_launch():
    from distributed_llama_tpu_torch.ops.attention import (_check,
                                                           decode_attention)

    q, k_all, v_all = (torch.from_numpy(a) for a in _inputs(1, seed=0))
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q.to("meta"), k_all.to("meta"), v_all.to("meta"),
                         0, 0, 1)
    with pytest.raises(ValueError, match="out of range"):
        _check(q, k_all, v_all, 0, S, 1)
    with pytest.raises(ValueError, match="kv_mul"):
        _check(torch.zeros(N_KV * 3, HS), k_all, v_all, 0, 0, 3)
    with pytest.raises(ValueError, match="q must be"):
        _check(q[:2], k_all, v_all, 0, 0, 1)
    _check(q, k_all, v_all, L - 1, S - 1, 1)


PREFILL_CASES = [(kv_mul, pos, t_len) for kv_mul in (1, 2)
                 for pos in (0, 12) for t_len in (16, 32)]


@pytest.mark.parametrize("kv_mul,pos,t_len", PREFILL_CASES)
def test_prefill_plain_matches_pallas_interpret(kv_mul, pos, t_len):
    """K4's plain version (the prefill_attention wrapper on CPU tensors)
    against the JAX package's Pallas ``prefill_attention`` in interpret
    mode (hs 128, as tests/test_pallas_attention.py runs it), first and
    mid-cache chunks. rtol/atol 1e-5, that test's tolerance."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        prefill_attention as ref
    from distributed_llama_tpu_torch.ops import attention

    rng = np.random.default_rng(pos * 11 + kv_mul + t_len)
    k_all, v_all = (rng.normal(size=(L, S + 16, N_KV, HS)).astype(np.float32)
                    for _ in range(2))
    q = rng.normal(size=(t_len, N_KV * kv_mul, HS)).astype(np.float32)
    layer = 2
    want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k_all[layer]),
                          jnp.asarray(v_all[layer]), pos, kv_mul=kv_mul,
                          interpret=True))
    before = attention.PREFILL_KERNEL.launches
    got = attention.prefill_attention(torch.from_numpy(q),
                                      torch.from_numpy(k_all),
                                      torch.from_numpy(v_all), layer, pos,
                                      kv_mul)
    assert attention.PREFILL_KERNEL.launches == before
    assert tuple(got.shape) == (t_len, N_KV * kv_mul * HS)
    np.testing.assert_allclose(got.numpy(), want.reshape(t_len, -1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_mul", [1, 2])
def test_prefill_poisoned_suffix_is_invisible(kv_mul):
    """Keys past pos+T-1 (junk of an earlier, longer run) must not change
    the result: poison them and compare bitwise."""
    from distributed_llama_tpu_torch.ops.attention import prefill_attention

    rng = np.random.default_rng(kv_mul)
    k_all, v_all = (rng.normal(size=(L, S, N_KV, HS)).astype(np.float32)
                    for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(8, N_KV * kv_mul, HS))
                         .astype(np.float32))
    pos = 5
    a = prefill_attention(q, torch.from_numpy(k_all),
                          torch.from_numpy(v_all), 1, pos, kv_mul)
    k_all[:, pos + 8:] = 1e9
    v_all[:, pos + 8:] = -1e9
    b = prefill_attention(q, torch.from_numpy(k_all),
                          torch.from_numpy(v_all), 1, pos, kv_mul)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefill_row_zero_equals_decode():
    """Row i of a prefill chunk is the decode attention at position pos+i:
    the causal mask of one row is the decode walk over 0..pos+i."""
    from distributed_llama_tpu_torch.ops.attention import (decode_attention,
                                                           prefill_attention)

    q, k_all, v_all = (torch.from_numpy(a) for a in _inputs(2, seed=4))
    qs = torch.stack([q, q * 0.5, -q])  # three rows at positions 9, 10, 11
    got = prefill_attention(qs, k_all, v_all, 1, 9, 2)
    for i in range(3):
        want = decode_attention(qs[i], k_all, v_all, 1, 9 + i, 2)
        torch.testing.assert_close(got[i:i + 1], want, rtol=1e-6, atol=1e-6)


def test_prefill_wrapper_checks_before_launch():
    from distributed_llama_tpu_torch.ops.attention import (_check_prefill,
                                                           prefill_attention)

    q, k_all, v_all = (torch.from_numpy(a) for a in _inputs(1, seed=0))
    q3 = q.reshape(1, N_KV, HS).repeat(4, 1, 1)
    with pytest.raises(ValueError, match="no kernel"):
        prefill_attention(q3.to("meta"), k_all.to("meta"), v_all.to("meta"),
                          0, 0, 1)
    with pytest.raises(ValueError, match="outside the cache"):
        _check_prefill(q3, k_all, v_all, 0, S - 3, 1)
    with pytest.raises(ValueError, match=r"\(T, n_q, hs\)"):
        _check_prefill(q, k_all, v_all, 0, 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        _check_prefill(q3.transpose(0, 1).contiguous().transpose(0, 1),
                       k_all, v_all, 0, 0, 1)
    _check_prefill(q3, k_all, v_all, L - 1, S - 4, 1)
