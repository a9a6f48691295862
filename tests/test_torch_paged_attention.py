"""The port's paged decode attention and paged forward against the JAX
package, on the CPU:

* ``paged_decode_attention_plain`` (K6's plain version) and
  ``paged_decode_attention_q8_plain`` (K7's) against the JAX Pallas
  ``paged_decode_attention_kernel[_q8]`` in interpret mode at 1e-5 abs (the
  same f32 math in another order), at t_len 1..8 over scrambled pages with
  the budget edge, the tests/test_pallas_paged_attention.py cases;
* their own invariants, bit for bit: physical page placement, poisoned
  scrap and dead pages, the plain contiguous ``decode_attention_batch_plain``
  at t_len 1 over a pool holding the contiguous cache, and the Q8 route over
  the dequantized pool;
* the Q80 codec the Q8 pool writes and reads (``quantize_q80_torch`` on the
  (B, n_kv*hs) rows quantize-on-write uses, ``dequantize_q80_planes``)
  against the JAX package's, exactly;
* ``Llama.forward_batch_paged`` logits and pool pages against the JAX
  ``forward_batch_paged``: f32 pages at 1e-3 x max|JAX|, Q8 pages with codes
  within 1 and deltas within 1 f16 ulp (the quantized k/v differ by float
  noise between the frameworks); bitwise against the port's own
  ``forward_batch_ragged``; gather / scatter of pages in place;
* ``kv_quant_mode`` and ``supports_paged``.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType
from distributed_llama_tpu_torch.ops import paged_attention as pa

ATT_TOL = 1e-5
LOGIT_RTOL = 1e-3


def _pool(L=2, P=13, ps=8, n_kv=2, hs=128, seed=0):
    rng = np.random.default_rng(seed)
    k4 = rng.normal(size=(L * P, ps, n_kv, hs)).astype(np.float32)
    v4 = rng.normal(size=(L * P, ps, n_kv, hs)).astype(np.float32)
    return k4, v4


def _scrambled_table(B, max_pages, P, seed=1):
    rng = np.random.default_rng(seed)
    ids = 1 + rng.permutation(P - 1)[:B * max_pages]
    return ids.reshape(B, max_pages).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kv_mul,pos", [(1, [0, 5, 31]), (2, [7, 30, 16]),
                                        (4, [3, 3, 12])])
def test_paged_plain_matches_pallas_decode(kv_mul, pos):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_paged_attention import \
        paged_decode_attention_kernel as ref

    L, P, ps, n_kv, hs = 2, 13, 8, 2, 128
    k4, v4 = _pool(L, P, ps, n_kv, hs, seed=kv_mul)
    table = _scrambled_table(3, 4, P)
    q = np.random.default_rng(11 + kv_mul).normal(
        size=(3, 1, n_kv * kv_mul * hs)).astype(np.float32)
    pv = np.asarray(pos, np.int32)
    want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k4), jnp.asarray(v4),
                          1, pv, jnp.asarray(table), page_size=ps,
                          n_pages=P, kv_mul=kv_mul, t_len=1, interpret=True))
    before = [k.launches for k in pa.KERNELS]
    got = pa.paged_decode_attention(_t(q), _t(k4), _t(v4), 1, _t(pv),
                                    _t(table), P, kv_mul)
    assert [k.launches for k in pa.KERNELS] == before
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0)


@pytest.mark.parametrize("kv_mul,t_len", [(1, 2), (1, 3), (2, 4), (4, 5),
                                          (1, 6), (2, 7), (1, 8)])
def test_paged_plain_matches_pallas_window_incl_budget_edge(kv_mul, t_len):
    """The t_len-query window: stacked causal masks, one row at the budget
    edge (its window runs past the virtual plane)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_paged_attention import \
        paged_decode_attention_kernel as ref

    L, P, ps, n_kv, hs = 2, 13, 8, 2, 128
    s_virt = 4 * ps
    k4, v4 = _pool(L, P, ps, n_kv, hs, seed=t_len)
    table = _scrambled_table(3, 4, P)
    q = np.random.default_rng(7 + t_len).normal(
        size=(3, t_len, n_kv * kv_mul * hs)).astype(np.float32)
    pv = np.asarray([0, 9, s_virt - 2], np.int32)
    want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k4), jnp.asarray(v4),
                          0, pv, jnp.asarray(table), page_size=ps,
                          n_pages=P, kv_mul=kv_mul, t_len=t_len,
                          interpret=True))
    got = pa.paged_decode_attention(_t(q), _t(k4), _t(v4), 0, _t(pv),
                                    _t(table), P, kv_mul)
    np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0)


def _q8(k4, v4):
    from distributed_llama_tpu_torch.ops.quants import quantize_q80_torch

    rows, ps, n_kv, hs = k4.shape
    out = []
    for x in (k4, v4):
        qs, d = quantize_q80_torch(_t(x).reshape(rows, ps, n_kv * hs))
        out += [qs.reshape(rows, ps, n_kv, hs).contiguous(), d.contiguous()]
    return out


@pytest.mark.parametrize("kv_mul,t_len", [(2, 1), (1, 4), (4, 8)])
def test_paged_q8_plain_matches_pallas(kv_mul, t_len):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_paged_attention import \
        paged_decode_attention_kernel_q8 as ref

    L, P, ps, n_kv, hs = 2, 13, 8, 2, 128
    k4, v4 = _pool(L, P, ps, n_kv, hs, seed=9)
    planes = _q8(k4, v4)
    table = _scrambled_table(3, 4, P, seed=9)
    q = np.random.default_rng(9).normal(
        size=(3, t_len, n_kv * kv_mul * hs)).astype(np.float32)
    pv = np.asarray([0, 17, 31 - t_len + 2], np.int32)
    want = np.asarray(ref(jnp.asarray(q), *(jnp.asarray(p.numpy())
                                            for p in planes), 1, pv,
                          jnp.asarray(table), page_size=ps, n_pages=P,
                          kv_mul=kv_mul, t_len=t_len, interpret=True))
    got = pa.paged_decode_attention_q8(_t(q), *planes, 1, _t(pv), _t(table),
                                       P, kv_mul)
    np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0)


def test_paged_plain_is_invariant_to_page_placement():
    L, P, ps, n_kv, hs = 2, 11, 8, 2, 128
    k4, v4 = _pool(L, P, ps, n_kv, hs, seed=5)
    table = _scrambled_table(2, 4, P, seed=5)
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(2, 3, n_kv * hs)).astype(np.float32))
    pv = _t(np.asarray([13, 29], np.int32))
    base = pa.paged_decode_attention(q, _t(k4), _t(v4), 1, pv, _t(table), P,
                                     1)
    perm = np.concatenate([[0], 1 + rng.permutation(P - 1)])
    moved = []
    for x in (k4, v4):
        x5 = x.reshape(L, P, ps, n_kv, hs)
        m = np.empty_like(x5)
        m[:, perm] = x5
        moved.append(_t(m.reshape(L * P, ps, n_kv, hs)))
    again = pa.paged_decode_attention(
        q, *moved, 1, pv, _t(perm[table].astype(np.int32)), P, 1)
    assert torch.equal(base, again)


def test_paged_plain_ignores_scrap_and_dead_pages():
    L, P, ps, n_kv, hs = 1, 9, 8, 2, 128
    k4, v4 = _pool(L, P, ps, n_kv, hs, seed=3)
    table = _t(np.asarray([[2, 5, 7], [4, 1, 3]], np.int32))
    q = _t(np.random.default_rng(3).normal(
        size=(2, 1, n_kv * hs)).astype(np.float32))
    pv = _t(np.asarray([11, 4], np.int32))
    clean = pa.paged_decode_attention(q, _t(k4), _t(v4), 0, pv, table, P, 1)
    k4p, v4p = k4.copy(), v4.copy()
    k4p[0], v4p[0] = 1e9, -1e9              # the scrap page
    k4p[6], v4p[6] = 1e9, -1e9              # a page no table maps
    k4p[5, 4:], v4p[5, 4:] = 1e9, -1e9      # past row 0's clock
    k4p[1, 5:], v4p[1, 5:] = 1e9, -1e9      # past row 1's clock
    poisoned = pa.paged_decode_attention(q, _t(k4p), _t(v4p), 0, pv, table,
                                         P, 1)
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize("kv_mul", [1, 4])
def test_paged_plain_at_t1_is_the_contiguous_plain_bit_for_bit(kv_mul):
    """A (L*B, S, n_kv, hs) batch cache is also a pool of L*B*S/ps pages:
    with the identity table the paged route computes
    decode_attention_batch_plain's very calls."""
    from distributed_llama_tpu_torch.ops.attention import \
        decode_attention_batch_plain

    L, B, S, n_kv, hs, ps = 2, 3, 32, 2, 16, 4
    g = torch.Generator().manual_seed(kv_mul)
    k4 = torch.randn((L * B, S, n_kv, hs), generator=g)
    v4 = torch.randn((L * B, S, n_kv, hs), generator=g)
    q = torch.randn((B, n_kv * kv_mul, hs), generator=g)
    pv = torch.tensor([0, 17, 31], dtype=torch.int32)
    mp = S // ps
    table = torch.arange(B * mp, dtype=torch.int32).reshape(B, mp)
    for layer in range(L):
        want = decode_attention_batch_plain(q, k4, v4, layer, pv, kv_mul)
        got = pa.paged_decode_attention(
            q.reshape(B, 1, -1), k4.reshape(-1, ps, n_kv, hs),
            v4.reshape(-1, ps, n_kv, hs), layer, pv, table, B * mp, kv_mul)
        assert torch.equal(got.reshape(B, -1), want)


def test_paged_q8_plain_is_the_f32_route_over_the_dequantized_pool():
    from distributed_llama_tpu_torch.ops.quants import dequantize_q80_planes

    L, P, ps, n_kv, hs = 2, 9, 4, 4, 32
    k4, v4 = _pool(L, P, ps, n_kv, hs, seed=2)
    kq4, kd4, vq4, vd4 = _q8(k4, v4)
    table = _t(_scrambled_table(2, 4, P, seed=2))
    q = _t(np.random.default_rng(2).normal(
        size=(2, 3, n_kv * 2 * hs)).astype(np.float32))
    pv = _t(np.asarray([6, 15], np.int32))
    a = pa.paged_decode_attention_q8(q, kq4, kd4, vq4, vd4, 1, pv, table, P,
                                     2)
    b = pa.paged_decode_attention(q, dequantize_q80_planes(kq4, kd4),
                                  dequantize_q80_planes(vq4, vd4), 1, pv,
                                  table, P, 2)
    assert torch.equal(a, b)


def test_q80_codec_matches_reference_on_page_rows():
    """quantize_q80_torch on the (B, n_kv*hs) rows quantize-on-write sees,
    and dequantize_q80_planes on (..., n_kv, hs) planes, equal the JAX
    package's functions exactly."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.quants import \
        dequantize_q80_planes as ref_deq
    from distributed_llama_tpu.ops.quants import quantize_q80_jax
    from distributed_llama_tpu_torch.ops.quants import (dequantize_q80_planes,
                                                        quantize_q80_torch)

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(5, 4 * 64)) * rng.uniform(0.01, 30, (5, 1))) \
        .astype(np.float32)
    x[2, :32] = 0.0  # an all-zero block
    qs, d = quantize_q80_torch(_t(x))
    rqs, rd = quantize_q80_jax(jnp.asarray(x))
    assert np.array_equal(qs.numpy(), np.asarray(rqs))
    assert np.array_equal(d.numpy(), np.asarray(rd))
    codes = qs.reshape(5, 4, 64)
    got = dequantize_q80_planes(codes, d)
    want = np.asarray(ref_deq(jnp.asarray(codes.numpy()), jnp.asarray(rd)))
    assert got.shape == (5, 4, 64) and np.array_equal(got.numpy(), want)


def test_kv_quant_mode_reads_the_environment(monkeypatch):
    from distributed_llama_tpu.ops.pallas_paged_attention import \
        kv_quant_mode as ref

    for value, want in ((None, "f32"), ("", "f32"), ("f32", "f32"),
                        ("q8", "q8")):
        if value is None:
            monkeypatch.delenv("DLLAMA_KV_QUANT", raising=False)
        else:
            monkeypatch.setenv("DLLAMA_KV_QUANT", value)
        assert pa.kv_quant_mode() == ref() == want
    monkeypatch.setenv("DLLAMA_KV_QUANT", "q4")
    with pytest.raises(ValueError, match="DLLAMA_KV_QUANT"):
        pa.kv_quant_mode()


def test_supports_paged():
    assert pa.supports_paged(16, 32, 128, 1)
    assert pa.supports_paged(16, 8, 128, 8, kv_mul=8, q8=True)
    # any window: a mixed window is t_len = the dispatch budget
    assert pa.supports_paged(16, 32, 128, 39)
    assert not pa.supports_paged(16, 32, 128, 0)
    assert not pa.supports_paged(16, 32, 130, 1)
    assert not pa.supports_paged(16, 32, 128, 1, kv_mul=3)
    assert not pa.supports_paged(16, 1, 12, 1, q8=True)  # 12 % 32


# ---------------------------------------------------------------------------
# forward_batch_paged
# ---------------------------------------------------------------------------

SPECS = {
    "f32": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=16),
    "q40": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=16,
                           weights_float_type=FloatType.Q40),
    "gqa_q40": TransformerSpec(dim=128, hidden_dim=256, n_layers=2,
                               n_heads=8, n_kv_heads=2, vocab_size=64,
                               seq_len=16, weights_float_type=FloatType.Q40),
}
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len", "weights_float_type")
STEPS = [([1, 1, 1], [0, 0, 0]), ([7, 30, 2], [1, 1, 1]),
         ([33, 5, 9], [2, 5, 9]), ([12, 40, 3], [3, 6, 15]),
         ([9, 8, 7], [4, 7, 15])]


def _port_spec(spec):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS
    from distributed_llama_tpu_torch.ops.quants import FloatType as PFT

    kw = {f: getattr(spec, f) for f in _FIELDS}
    kw["weights_float_type"] = PFT(int(spec.weights_float_type))
    return PS(**kw)


def _host(params):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else np.asarray(v))
            for k, v in params.items()}


@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_batch_paged_matches_reference(name, kv_quant):
    import jax.numpy as jnp

    from distributed_llama_tpu.models import llama as ref
    from distributed_llama_tpu_torch.models import llama

    spec = SPECS[name]
    params = synth_params(spec, q40=spec.weights_float_type == FloatType.Q40,
                          seed=3)
    B, ps = 3, 4
    P = 1 + B * spec.seq_len // ps + 2
    table = _scrambled_table(B, spec.seq_len // ps, P, seed=7)
    q8 = kv_quant == "q8"
    dev = ref.params_to_device(params)
    jcache = (ref.init_cache_paged_q8(spec, P, ps) if q8
              else ref.init_cache_paged(spec, P, ps))
    pspec = _port_spec(spec)
    model = llama.Llama(pspec, llama.params_to_device(_host(params), "cpu"))
    cache = (llama.init_cache_paged_q8(pspec, P, ps, "cpu") if q8
             else llama.init_cache_paged(pspec, P, ps, "cpu"))
    with torch.inference_mode():
        for i, (tokens, pos) in enumerate(STEPS):
            want, jcache = ref.forward_batch_paged(
                spec, ps, dev, jcache, jnp.asarray(tokens, jnp.int32),
                jnp.asarray(pos, jnp.int32), jnp.asarray(table),
                kv_quant=kv_quant)
            got = model.forward_batch_paged(
                cache, torch.tensor(tokens),
                torch.tensor(pos, dtype=torch.int32), _t(table))
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape == (B, spec.vocab_size)
            err = np.abs(got.numpy() - want).max()
            assert err <= LOGIT_RTOL * np.abs(want).max(), (i, err)
    if not q8:
        for g, w in zip(cache, jcache):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            assert np.abs(g.numpy() - w).max() <= \
                LOGIT_RTOL * np.abs(w).max()
        return
    for plane in ("kq", "vq"):
        g = getattr(cache, plane).numpy().astype(np.int32)
        w = np.asarray(getattr(jcache, plane)).astype(np.int32)
        assert np.abs(g - w).max() <= 1
    for plane in ("kd", "vd"):
        g = getattr(cache, plane).numpy()
        w = np.asarray(getattr(jcache, plane))
        ulp = np.spacing(np.abs(w).astype(np.float16)).astype(np.float32)
        assert (np.abs(g.astype(np.float32) - w.astype(np.float32))
                <= ulp).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_batch_paged_is_forward_batch_ragged_bit_for_bit(dtype):
    """The same history through the paged pool (scrambled pages) and the
    contiguous batch cache: equal logits, step by ragged step."""
    from distributed_llama_tpu_torch.models import llama

    spec = _port_spec(SPECS["gqa_q40"])
    model = llama.Llama(spec, llama.params_to_device(
        _host(synth_params(SPECS["gqa_q40"], q40=True, seed=4)), "cpu"))
    B, ps = 3, 4
    P = 1 + B * spec.seq_len // ps
    table = _t(_scrambled_table(B, spec.seq_len // ps, P, seed=2))
    pool = llama.init_cache_paged(spec, P, ps, "cpu", dtype)
    cache = llama.init_cache_batch(spec, B, "cpu", dtype)
    with torch.inference_mode():
        for tokens, pos in STEPS:
            tt = torch.tensor(tokens)
            pv = torch.tensor(pos, dtype=torch.int32)
            a = model.forward_batch_paged(pool, tt, pv, table)
            b = model.forward_batch_ragged(cache, tt, pv)
            assert torch.equal(a, b)


@pytest.mark.parametrize("q8", [False, True])
def test_gather_scatter_pages_match_reference_in_place(q8):
    """gather_pages[_q8] copies a slot's pages out as the JAX package's do;
    scatter_pages[_q8] writes a sequence cache back IN PLACE (the same
    storage) with the JAX package's bytes, shared entries parked on the
    scrap page."""
    import jax.numpy as jnp

    from distributed_llama_tpu.models import llama as ref
    from distributed_llama_tpu_torch.models import llama

    spec = SPECS["gqa_q40"]
    pspec = _port_spec(spec)
    ps, P = 4, 9
    rng = np.random.default_rng(6)
    table = np.asarray([3, 7, 1, 0], np.int32)  # the last on the scrap page
    seq = [rng.normal(size=(spec.n_layers, spec.seq_len, spec.n_kv_heads,
                            spec.head_size)).astype(np.float32)
           for _ in range(2)]
    if q8:
        pool = llama.init_cache_paged_q8(pspec, P, ps, "cpu")
        jpool = ref.init_cache_paged_q8(spec, P, ps)
        scatter, gather = llama.scatter_pages_q8, llama.gather_pages_q8
        rscatter, rgather = ref.scatter_pages_q8, ref.gather_pages_q8
    else:
        pool = llama.init_cache_paged(pspec, P, ps, "cpu")
        jpool = ref.init_cache_paged(spec, P, ps)
        scatter, gather = llama.scatter_pages, llama.gather_pages
        rscatter, rgather = ref.scatter_pages, ref.gather_pages
    ptrs = [p.data_ptr() for p in pool]
    out = scatter(pool, llama.KVCache(_t(seq[0]), _t(seq[1])), _t(table),
                  ps)
    jpool = rscatter(jpool, ref.KVCache(jnp.asarray(seq[0]),
                                        jnp.asarray(seq[1])),
                     jnp.asarray(table), ps)
    assert [p.data_ptr() for p in out] == ptrs  # in place
    for g, w in zip(pool, jpool):
        g, w = g.numpy(), np.asarray(w)
        live = [1, 3, 7]  # the scrap page takes the junk in either order
        assert np.array_equal(g[:, live], w[:, live])
    got = gather(pool, _t(table), ps)
    want = rgather(jpool, jnp.asarray(table), ps)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy()[:, :3 * ps], np.asarray(w)[:, :3 * ps])
