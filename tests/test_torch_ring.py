"""The port's sequence-parallel primitives (parallel/ring.py) against the
JAX package's parallel/ring.py on the same seeded numpy inputs:
``update_sp_cache`` over a window that straddles a chunk boundary, the
dense and blockwise flash partials (rows that see nothing of a chunk
give m = -inf on both), the -inf-safe ``_lse_merge``, and the LSE combine
over S shards (JAX inside shard_map over an sp mesh of host devices, the
port over the stacked shards with numpy's max and sum in rank order)."""

import numpy as np
import pytest
import torch

ATOL = 1e-5


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=name)
    np.testing.assert_allclose(np.nan_to_num(got, neginf=0),
                               np.nan_to_num(want, neginf=0), rtol=ATOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize("pos,t_len", [(6, 4), (0, 3), (13, 5), (2, 12)])
def test_update_sp_cache_matches_jax(pos, t_len):
    from distributed_llama_tpu.parallel import ring as jring
    from distributed_llama_tpu_torch.parallel import ring

    chunk, n_kv, hs = 8, 2, 4
    rng = np.random.default_rng(pos * 7 + t_len)
    new = rng.standard_normal((t_len, n_kv, hs)).astype(np.float32)
    base = rng.standard_normal((chunk, n_kv, hs)).astype(np.float32)
    for sp_index in range(3):
        want = jring.update_sp_cache(_jnp(base), _jnp(new), pos, sp_index,
                                     chunk)
        got = ring.update_sp_cache(torch.from_numpy(base.copy()),
                                   torch.from_numpy(new), pos, sp_index,
                                   chunk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_sp_rows_matches_update_sp_cache():
    """The batch write (device clocks) equals the single-row write of each
    row at its own clock, straddling rows dropped on the other chunk."""
    from distributed_llama_tpu_torch.parallel import ring

    chunk, n_kv, hs, batch = 8, 2, 4, 5
    rng = np.random.default_rng(3)
    plane = torch.from_numpy(rng.standard_normal(
        (batch, chunk, n_kv, hs)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal(
        (batch, n_kv, hs)).astype(np.float32))
    cols = torch.tensor([0, 7, 8, 15, 3])
    for sp_index in (0, 1):
        got = plane.clone()
        ring.update_sp_rows(torch.arange(batch), cols, got, new, sp_index,
                            chunk)
        want = plane.clone()
        for b in range(batch):
            ring.update_sp_cache(want[b], new[b:b + 1], int(cols[b]),
                                 sp_index, chunk)
        assert torch.equal(got, want)


@pytest.mark.parametrize("chunk_start,pos,t_len",
                         [(0, 5, 1), (64, 5, 4), (64, 70, 8), (0, 100, 12),
                          (64, 5, 12), (64, 70, 12)])
def test_partials_match_jax(chunk_start, pos, t_len):
    """The dense partial, and the blockwise walk at T > 8 (block 16), each
    against the JAX function on the same inputs."""
    from distributed_llama_tpu.parallel import ring as jring
    from distributed_llama_tpu_torch.parallel import ring

    rng = np.random.default_rng(17 + pos)
    hs, kv_mul, n_kv, c = 16, 2, 2, 64
    n_q = n_kv * kv_mul
    q = rng.standard_normal((t_len, n_q, hs)).astype(np.float32)
    k = rng.standard_normal((c, n_kv, hs)).astype(np.float32)
    v = rng.standard_normal((c, n_kv, hs)).astype(np.float32)
    q_pos = pos + np.arange(t_len)
    valid = (chunk_start + np.arange(c))[None, :] <= q_pos[:, None]
    want = jring._partial_attention(hs, kv_mul, _jnp(q), _jnp(k), _jnp(v),
                                    _jnp(valid))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ring._partial_attention(hs, kv_mul, tq, tk, tv,
                                  torch.from_numpy(valid))
    for w, g, name in zip(want, got, "mlo"):
        _close(g, w, f"dense {name}")
    if t_len > 8:
        want_b = jring.blockwise_chunk_partials(
            hs, kv_mul, _jnp(q), _jnp(k), _jnp(v), chunk_start,
            _jnp(q_pos), block=16)
        got_b = ring.blockwise_chunk_partials(
            hs, kv_mul, tq, tk, tv, chunk_start, torch.from_numpy(q_pos),
            int(q_pos[-1]), block=16)
        for w, g, name in zip(want_b, got_b, "mlo"):
            _close(g, w, f"blockwise {name}")


def test_lse_merge_with_minus_inf_sides():
    from distributed_llama_tpu.parallel import ring as jring
    from distributed_llama_tpu_torch.parallel import ring

    rng = np.random.default_rng(5)
    n, hs = 6, 4
    m = rng.standard_normal((n, 1)).astype(np.float32)
    pm = rng.standard_normal((n, 1)).astype(np.float32)
    m[[0, 2]] = -np.inf   # the running side has seen nothing
    pm[[1, 2]] = -np.inf  # the partial saw nothing (row 2: neither)
    l = np.where(np.isfinite(m), 1.5, 0).astype(np.float32)
    pl = np.where(np.isfinite(pm), 0.5, 0).astype(np.float32)
    o = rng.standard_normal((n, hs)).astype(np.float32) * l
    po = rng.standard_normal((n, hs)).astype(np.float32) * pl
    want = jring._lse_merge(*map(_jnp, (m, l, o, pm, pl, po)))
    got = ring._lse_merge(*map(torch.from_numpy, (m, l, o, pm, pl, po)))
    for w, g, name in zip(want, got, "mlo"):
        _close(g, w, name)
    assert not np.isnan(got[1].numpy()).any()


@pytest.mark.parametrize("sp", [2, 4])
def test_lse_combine_matches_jax(sp):
    """S shards' partials of one query window over a 32-position cache:
    the JAX combine inside shard_map over an sp mesh, the port's over the
    stacked shards; both equal the dense softmax attention."""
    import jax
    from jax.sharding import PartitionSpec as P

    from distributed_llama_tpu.parallel import ring as jring
    from distributed_llama_tpu.parallel.mesh import make_mesh
    from distributed_llama_tpu_torch.parallel import ring

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    hs, kv_mul, n_kv, seq, t_len, pos = 8, 2, 2, 32, 3, 9
    n_q = n_kv * kv_mul
    chunk = seq // sp
    rng = np.random.default_rng(sp)
    q = rng.standard_normal((t_len, n_q, hs)).astype(np.float32)
    k = rng.standard_normal((seq, n_kv, hs)).astype(np.float32)
    v = rng.standard_normal((seq, n_kv, hs)).astype(np.float32)

    mesh = make_mesh(sp=sp, tp=1)

    def local(qq, kc, vc):
        i = jax.lax.axis_index("sp")
        return jring.sp_cache_attention(hs, kv_mul, chunk, i, qq, kc, vc,
                                        pos)

    want = np.asarray(jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P("sp"), P("sp")),
        out_specs=P()))(_jnp(q), _jnp(k), _jnp(v)))

    parts = [ring._partial_attention(
        hs, kv_mul, torch.from_numpy(q),
        torch.from_numpy(k[s * chunk:(s + 1) * chunk]),
        torch.from_numpy(v[s * chunk:(s + 1) * chunk]),
        torch.from_numpy((s * chunk + np.arange(chunk))[None, :]
                         <= (pos + np.arange(t_len))[:, None]))
        for s in range(sp)]
    g_m = torch.stack([p[0] for p in parts]).amax(dim=0)
    corr = [torch.exp(p[0] - g_m) for p in parts]
    outs = []
    for s in range(sp):  # each rank's view: pmax, then the psums of l, o
        which = iter((1, 2))

        def psum(t):
            i = next(which)
            acc = parts[0][i] * corr[0]
            for r in range(1, sp):  # rank order
                acc = acc + parts[r][i] * corr[r]
            return acc

        m, l, o = parts[s]
        outs.append(ring._lse_combine_partials(m, l, o, lambda t: g_m,
                                               psum))
    for got in outs:
        np.testing.assert_allclose(got.reshape(t_len, -1).numpy(), want,
                                   rtol=0, atol=ATOL)
    # the dense softmax over positions 0..pos+i
    s_ = np.einsum("tgmd,cgd->tgmc", q.reshape(t_len, n_kv, kv_mul, hs),
                   k) / np.sqrt(hs)
    mask = np.arange(seq)[None, :] <= (pos + np.arange(t_len))[:, None]
    s_ = np.where(mask[:, None, None], s_, -np.inf)
    p_ = np.exp(s_ - s_.max(-1, keepdims=True))
    p_ /= p_.sum(-1, keepdims=True)
    dense = np.einsum("tgmc,cgd->tgmd", p_, v).reshape(t_len, -1)
    np.testing.assert_allclose(want, dense, rtol=0, atol=ATOL)
