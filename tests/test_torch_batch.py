"""The port's lockstep batch (``--prompts-file``) against the JAX package, on
the CPU (the kernels' plain versions):

* ``decode_attention_batch_plain`` (K5's plain version) against the JAX
  Pallas ``decode_attention_batch`` in interpret mode, with a shared and a
  ragged position vector, over f32 and bf16 caches, at 1e-5 abs (both are
  f32 math over the same values, in another order);
* the small-T bf16-product body (K1d's plain version,
  ``q40_matmul(..., multi_body="dequant")``) against the JAX ``q40_matmul``
  under ``DLLAMA_MULTI_T_BODY=dequant`` in interpret mode
  (``_kernel_multi_dequant``), at T = 2, 5, 8 and on a layer of a stacked
  weight, at 1e-4 x max|JAX|: both sum exact products of the same bf16
  values in f32;
* ``Llama.forward_batch`` logits and cache rows against the JAX
  ``forward_batch``, lockstep and ragged, F32, Q40 and GQA, at 1e-3 x
  max|JAX|;
* ``generate_batch`` streams equal to the JAX ``generate_batch``: ragged
  prompts, B = 1, 3 and 9 (9 takes the T > 8 products), greedy and seeded
  (temperature 0.8, top-p 0.9), and greedy under the 'dequant' body (the
  JAX side then runs its Pallas bodies in interpret mode);
* the body's selection: ``multi_t_body`` reads the environment as the JAX
  package does, and the engines pass it down as a route.
"""

import tempfile

import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.loader import Q40Weight as RefQ40
from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType, quantize_q40

ATT_TOL = 1e-5
Q40_RTOL = 1e-4
LOGIT_RTOL = 1e-3

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


def _q40(d, n, seed):
    rng = np.random.default_rng(seed)
    return RefQ40(*quantize_q40((rng.standard_normal((d, n)) * 0.3)
                                .astype(np.float32)))


def _port_q40(qs, d16):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return Q40Weight(torch.from_numpy(np.asarray(qs)),
                     torch.from_numpy(np.asarray(d16)))


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [[5, 5, 5], [0, 7, 15]],
                         ids=["shared", "ragged"])
@pytest.mark.parametrize("kv_mul,hs", [(1, 32), (4, 16)])
def test_batch_attention_plain_matches_pallas(kv_mul, hs, pos, cache):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        decode_attention_batch as ref
    from distributed_llama_tpu_torch.ops import attention

    L, B, S, n_kv = 2, 3, 16, 2
    rng = np.random.default_rng(kv_mul * 100 + pos[1])
    k4 = rng.standard_normal((L * B, S, n_kv, hs)).astype(np.float32)
    v4 = rng.standard_normal((L * B, S, n_kv, hs)).astype(np.float32)
    q = rng.standard_normal((B, n_kv * kv_mul, hs)).astype(np.float32)
    tk, tv = torch.from_numpy(k4), torch.from_numpy(v4)
    jk, jv = jnp.asarray(k4), jnp.asarray(v4)
    if cache == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    pv = np.asarray(pos, np.int32)
    for layer in range(L):
        want = np.asarray(ref(jnp.asarray(q), jk, jv, layer,
                              jnp.asarray(pv), kv_mul=kv_mul,
                              interpret=True))
        before = [k.launches for k in attention.KERNELS]
        got = attention.decode_attention_batch(
            torch.from_numpy(q), tk, tv, layer, torch.from_numpy(pv), kv_mul)
        assert [k.launches for k in attention.KERNELS] == before
        assert tuple(got.shape) == want.shape == (B, n_kv * kv_mul * hs)
        np.testing.assert_allclose(got.numpy(), want, atol=ATT_TOL, rtol=0)


def test_batch_attention_plain_is_the_single_row_kernel_per_row():
    """Row b of the batch is decode_attention on cache row layer*B + b at
    pos[b]: at B = 1 the plain versions of K5 and K2 agree bit for bit."""
    from distributed_llama_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(0)
    k_all = torch.randn((3, 12, 2, 16), generator=g)
    v_all = torch.randn((3, 12, 2, 16), generator=g)
    q = torch.randn((1, 4, 16), generator=g)
    for layer, pos in ((0, 0), (2, 11)):
        got = attention.decode_attention_batch(
            q, k_all, v_all, layer, torch.tensor([pos], dtype=torch.int32), 2)
        want = attention.decode_attention(q[0], k_all, v_all, layer, pos, 2)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K1d's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [2, 5, 8])
def test_dequant_body_plain_matches_pallas(t, monkeypatch):
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as ref
    from distributed_llama_tpu_torch.ops import q40

    monkeypatch.setenv("DLLAMA_MULTI_T_BODY", "dequant")
    w = _q40(256, 512, seed=t)
    x = np.random.default_rng(t).standard_normal((t, 512)).astype(np.float32)
    want = np.asarray(ref(w, jnp.asarray(x), interpret=True))
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(_port_q40(w.qs, w.d16), torch.from_numpy(x),
                         multi_body="dequant")
    assert [k.launches for k in q40.KERNELS] == counts
    assert tuple(got.shape) == want.shape == (t, 256)
    err = np.abs(got.numpy() - want).max()
    assert err <= Q40_RTOL * np.abs(want).max(), err
    # the f32 body is another function: the dequant body is not it
    exact = q40.q40_matmul(_port_q40(w.qs, w.d16), torch.from_numpy(x))
    assert not torch.equal(exact, got)


def test_dequant_body_plain_matches_pallas_on_a_stacked_layer(monkeypatch):
    """A layer view of a stacked (L, d, nb, 16) weight, as the forward
    passes it, against the JAX layer-indexed dispatch
    (_kernel_multi_dequant_stacked)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.io.loader import to_kernel_layout
    from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as ref
    from distributed_llama_tpu_torch.ops import q40

    monkeypatch.setenv("DLLAMA_MULTI_T_BODY", "dequant")
    L, d, n, t = 3, 256, 512, 8
    ws = [_q40(d, n, seed=10 + i) for i in range(L)]
    stacked = RefQ40(np.stack([np.asarray(w.qs) for w in ws]),
                     np.stack([np.asarray(w.d16) for w in ws]))
    kern = to_kernel_layout(stacked)
    port = _port_q40(stacked.qs, stacked.d16)
    x = np.random.default_rng(4).standard_normal((t, n)).astype(np.float32)
    for layer in range(L):
        want = np.asarray(ref(kern, jnp.asarray(x), layer=layer,
                              interpret=True))
        view = type(port)(port.qs[layer], port.d16[layer])
        got = q40.q40_matmul(view, torch.from_numpy(x), multi_body="dequant")
        err = np.abs(got.numpy() - want).max()
        assert err <= Q40_RTOL * np.abs(want).max(), (layer, err)


def test_multi_t_body_reads_the_environment(monkeypatch):
    from distributed_llama_tpu.ops.pallas_q40 import _multi_t_body as ref
    from distributed_llama_tpu_torch.ops.q40 import multi_t_body

    for value, want in ((None, "vpu"), ("", "vpu"), ("vpu", "vpu"),
                        ("dequant", "dequant")):
        if value is None:
            monkeypatch.delenv("DLLAMA_MULTI_T_BODY", raising=False)
        else:
            monkeypatch.setenv("DLLAMA_MULTI_T_BODY", value)
        assert multi_t_body() == ref() == want
    monkeypatch.setenv("DLLAMA_MULTI_T_BODY", "mxu")
    with pytest.raises(ValueError, match="DLLAMA_MULTI_T_BODY"):
        multi_t_body()


@pytest.mark.parametrize("t", [1, 4, 9])
def test_dequant_route_changes_only_small_t(t):
    """with_body(KERNELS, 'dequant') sends 2 <= T <= 8 to the bf16-product
    body and leaves T = 1 and T > 8 on the f32 functions; --fast-prefill's
    bf16 flag alone does not select it at T <= 8."""
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops import q40

    w = _q40(64, 128, seed=t)
    pw = _port_q40(w.qs, w.d16)
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, 128)).astype(np.float32))
    route = llama.with_body(llama.KERNELS, "dequant")
    assert llama.with_body(llama.KERNELS, "vpu") is llama.KERNELS
    got = route.q40(pw, x)
    want = (q40.q40_matmul_bf16_plain(pw, x) if 2 <= t <= 8
            else q40.q40_matmul_plain(pw, x))
    assert torch.equal(got, want)
    if t <= 8:
        assert torch.equal(q40.q40_matmul(pw, x, bf16=True),
                           q40.q40_matmul_plain(pw, x))
    with pytest.raises(ValueError, match="multi_body"):
        q40.q40_matmul(pw, x, multi_body="mxu")


# ---------------------------------------------------------------------------
# forward_batch
# ---------------------------------------------------------------------------

STEPS = [  # (tokens per row, position: one int or per-row)
    ([1, 1, 1], 0), ([7, 30, 2], 1), ([33, 5, 9], 2),
    ([12, 40, 3], np.array([3, 5, 9], np.int32)),
    ([9, 8, 7], np.array([4, 6, 15], np.int32))]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_batch_matches_reference(name):
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import forward_batch as ref
    from distributed_llama_tpu.models.llama import init_cache_batch as ref_cache
    from distributed_llama_tpu.models.llama import params_to_device
    from distributed_llama_tpu_torch.models import llama

    spec = SPECS[name]
    params = synth_params(spec, q40=spec.weights_float_type == FloatType.Q40,
                          seed=3)
    B = 3
    dev = params_to_device(params)
    jcache = ref_cache(spec, B)
    pspec = _port_spec(spec)
    model = llama.Llama(pspec, llama.params_to_device(_host(params), "cpu"))
    cache = llama.init_cache_batch(pspec, B, "cpu")
    with torch.inference_mode():
        for i, (tokens, pos) in enumerate(STEPS):
            jpos = (jnp.int32(pos) if isinstance(pos, int)
                    else jnp.asarray(pos))
            want, jcache = ref(spec, dev, jcache,
                               jnp.asarray(tokens, jnp.int32), jpos)
            tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
            tt = torch.tensor(tokens)
            got = (model.forward_batch(cache, tt, tpos)
                   if isinstance(pos, int)
                   else model.forward_batch_ragged(cache, tt, tpos))
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape == (B, spec.vocab_size)
            err = np.abs(got.numpy() - want).max()
            assert err <= LOGIT_RTOL * np.abs(want).max(), (i, err)
    for g, w in ((cache.k, jcache.k), (cache.v, jcache.v)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= LOGIT_RTOL * np.abs(w).max(), err


def test_forward_batch_at_b1_is_the_single_sequence_step():
    """Over a single-sequence cache viewed as (L, 1, S, n_kv, hs), the
    device-input step equals Llama.forward token by token, bit for bit
    (the --fast loop's step against the host loop's)."""
    from distributed_llama_tpu_torch.models import llama

    spec = _port_spec(SPECS["gqa_q40"])
    params = synth_params(SPECS["gqa_q40"], q40=True, seed=4)
    model = llama.Llama(spec, llama.params_to_device(_host(params), "cpu"))
    c1, c2 = llama.init_cache(spec, "cpu"), llama.init_cache(spec, "cpu")
    view = llama.KVCache(c2.k.unsqueeze(1), c2.v.unsqueeze(1))
    with torch.inference_mode():
        for pos, tok in enumerate([1, 9, 40, 3]):
            a = model(c1, tok, pos)
            b = model.forward_batch(view, torch.tensor([tok]),
                                    torch.tensor([pos], dtype=torch.int32))
            assert torch.equal(a, b)
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)


def test_forward_batch_rejects_bad_positions_and_caches():
    from distributed_llama_tpu_torch.models import llama

    spec = _port_spec(SPECS["f32"])
    model = llama.Llama(spec, llama.params_to_device(
        _host(synth_params(SPECS["f32"], q40=False)), "cpu"))
    cache = llama.init_cache_batch(spec, 2, "cpu")
    tokens = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="outside the cache"):
        model.forward_batch(cache, tokens, spec.seq_len)
    with pytest.raises(ValueError, match="int32"):
        model.forward_batch(cache, tokens, torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="does not hold"):
        model.forward_batch(llama.init_cache_batch(spec, 3, "cpu"), tokens, 0)


# ---------------------------------------------------------------------------
# generate_batch
# ---------------------------------------------------------------------------

PROMPTS = ["hi", "hi hi hi hi", "", "hi hi", "hi hi hi hi hi hi hi", "hi",
           "hi hi hi", "hi hi hi hi hi", "hi hi hi hi hi hi"]


def _tokenizer_file(vocab):
    from distributed_llama_tpu.io.tokenizer import write_tokenizer

    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces = pieces[:vocab - 5] + [b" ", b"h", b"i", b"hi", b" hi"]
    f = tempfile.NamedTemporaryFile(suffix=".bin", delete=False)
    f.close()
    write_tokenizer(f.name, pieces, [0.0] * (len(pieces) - 2) + [0.4, 0.5])
    return f.name


@pytest.fixture(scope="module")
def batch_model():
    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=96, seq_len=24,
                           weights_float_type=FloatType.Q40)
    return spec, synth_params(spec, q40=True, seed=5, scale=0.3), \
        _tokenizer_file(96)


def _batch_streams(batch_model, prompts, temperature, topp, steps=14):
    from distributed_llama_tpu.io.tokenizer import Tokenizer as RefTok
    from distributed_llama_tpu.runtime.generate import \
        generate_batch as ref_batch
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.runtime.generate import generate_batch

    spec, params, tok = batch_model
    want, _ = ref_batch(spec, params, RefTok(tok, spec.vocab_size), prompts,
                        steps, temperature, topp, 11, quiet=True)
    got, stats = generate_batch(_port_spec(spec), _host(params),
                                Tokenizer(tok, spec.vocab_size), prompts,
                                steps, temperature, topp, 11, device="cpu",
                                quiet=True)
    assert stats.tokens == sum(len(r) for r in got)
    return want, got


@pytest.mark.parametrize("mode", ["greedy", "seeded"])
@pytest.mark.parametrize("batch", [1, 3, 9])
def test_generate_batch_matches_reference(batch_model, batch, mode):
    temperature, topp = (0.0, 0.9) if mode == "greedy" else (0.8, 0.9)
    want, got = _batch_streams(batch_model, PROMPTS[:batch], temperature,
                               topp)
    assert len(got) == batch
    assert sum(len(r) for r in want) > 4 * batch
    assert got == want


def test_generate_batch_under_the_dequant_body_matches_reference(
        batch_model, monkeypatch):
    """DLLAMA_MULTI_T_BODY=dequant with 3 rows: every product of the step
    takes the bf16-product body on both sides (the JAX side through its
    Pallas kernels in interpret mode); greedy streams equal."""
    monkeypatch.setenv("DLLAMA_MULTI_T_BODY", "dequant")
    monkeypatch.setenv("DLLAMA_Q40_KERNEL", "pallas")
    want, got = _batch_streams(batch_model, PROMPTS[:3], 0.0, 0.9, steps=10)
    assert sum(len(r) for r in want) > 12
    assert got == want


def test_generate_batch_prints_the_reference_lines(batch_model, capsys):
    from distributed_llama_tpu.io.tokenizer import Tokenizer as RefTok
    from distributed_llama_tpu.runtime.generate import \
        generate_batch as ref_batch
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.runtime.generate import generate_batch

    spec, params, tok = batch_model
    ref_batch(spec, params, RefTok(tok, spec.vocab_size), PROMPTS[:3], 8,
              0.0, 0.9, 1)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[") or ln.startswith("Generated")]
    generate_batch(_port_spec(spec), _host(params),
                   Tokenizer(tok, spec.vocab_size), PROMPTS[:3], 8, 0.0, 0.9,
                   1, device="cpu")
    out = capsys.readouterr().out
    got = [ln for ln in out.splitlines()
           if ln.startswith("[") or ln.startswith("Generated")]
    assert got == want and len(got) == 4
    assert "ms/token (3 rows x 8 lockstep steps)" in out
