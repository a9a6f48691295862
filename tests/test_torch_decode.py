"""The port's on-device token loop (runtime/decode.py, generate_fast) against
the JAX package's, on the CPU:

* ``sample_device`` against the JAX ``sample_device`` and the port's host
  ``Sampler`` on the tests/test_decode_loop.py cases (nucleus, multinomial
  and out-of-range topp; argmax; the degenerate nucleus), one row at a time
  and as one batch: the token ids must be equal;
* the xorshift ``clone`` / ``f32_array`` against the JAX package's;
* ``generate_fast`` streams equal to the JAX ``generate_fast`` and to the
  port's own ``generate``, greedy and seeded, F32 and Q40 (GQA), with and
  without ``prefill_chunk``, and the sampler stream rewound after an early
  BOS as the per-step loop leaves it (the tests/test_decode_loop.py:132
  analogue);
* ``DecodeLoop``: a step after every row stopped leaves the output and the
  cache rows the chain wrote as they were, and ``num_steps`` bounds the
  steps run.

Token streams are compared exactly: both sides sample the same logits
(within f32 summation order) with the same coins.
"""

import tempfile

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType

SPECS = {
    "f32": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=256, seq_len=32,
                           weights_float_type=FloatType.F32),
    "q40": TransformerSpec(dim=128, hidden_dim=256, n_layers=2, n_heads=8,
                           n_kv_heads=2, vocab_size=256, seq_len=32,
                           weights_float_type=FloatType.Q40),
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
    """The JAX package's numpy tree as the port's host tree."""
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else np.asarray(v))
            for k, v in params.items()}


def _tokenizer_file(vocab):
    """A byte-level tokenizer of ``vocab`` pieces whose last two are ' '
    and 'hi' (tests/test_decode_loop.py's)."""
    from distributed_llama_tpu.io.tokenizer import write_tokenizer

    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces = pieces[:vocab - 2] + [b" ", b"hi"]
    f = tempfile.NamedTemporaryFile(suffix=".bin", delete=False)
    f.close()
    write_tokenizer(f.name, pieces, [0.0] * len(pieces))
    return f.name


@pytest.fixture(scope="module")
def tok_path():
    return _tokenizer_file(256)


# ---------------------------------------------------------------------------
# sample_device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,topp", [(0.8, 0.9), (1.0, 0.0),
                                              (0.5, 1.5)])
def test_sample_device_matches_reference_and_host(temperature, topp):
    import jax.numpy as jnp

    from distributed_llama_tpu.runtime.decode import \
        sample_device as jax_sample
    from distributed_llama_tpu_torch.runtime.decode import sample_device
    from distributed_llama_tpu_torch.runtime.sampling import (Sampler,
                                                              sample_mult,
                                                              sample_topp,
                                                              softmax_f32)

    rng = np.random.default_rng(17)
    host = Sampler(128, temperature, topp, seed=42)
    rows, coins, wants = [], [], []
    for i in range(20):
        logits = (rng.standard_normal(128) * 3).astype(np.float32)
        coin = host.rng.f32()
        probs = softmax_f32(logits / np.float32(temperature))
        want = (sample_mult(probs, coin) if topp <= 0 or topp >= 1
                else sample_topp(probs, topp, coin))
        ref = int(jax_sample(jnp.asarray(logits), jnp.float32(coin),
                             temperature, topp))
        got = int(sample_device(torch.from_numpy(logits),
                                torch.tensor(coin, dtype=torch.float32),
                                temperature, topp))
        assert got == ref == want, f"iter {i}: {got} / {ref} / {want}"
        rows.append(logits)
        coins.append(coin)
        wants.append(want)
    # the batched form: one call over all rows
    batched = sample_device(torch.from_numpy(np.stack(rows)),
                            torch.tensor(coins, dtype=torch.float32),
                            temperature, topp)
    assert batched.tolist() == wants


def test_sample_device_argmax():
    from distributed_llama_tpu_torch.runtime.decode import sample_device

    logits = torch.tensor([[0.1, 2.0, -1.0, 1.9], [3.0, 3.0, 0.0, 1.0]])
    got = sample_device(logits, torch.tensor([0.3, 0.3]), 0.0, 0.9)
    assert got.tolist() == [1, 0]  # ties go to the lowest index


def test_sample_device_degenerate_nucleus_matches_host():
    """topp < 1/v keeps nothing: the device sampler, the JAX one and the
    host fall back to the argmax."""
    import jax.numpy as jnp

    from distributed_llama_tpu.runtime.decode import \
        sample_device as jax_sample
    from distributed_llama_tpu_torch.runtime.decode import sample_device
    from distributed_llama_tpu_torch.runtime.sampling import (sample_topp,
                                                              softmax_f32)

    logits = np.zeros(64, np.float32)
    logits[17] = 1e-4
    want = sample_topp(softmax_f32(logits), 1e-6, 0.7)
    assert want == 17
    assert int(jax_sample(jnp.asarray(logits), jnp.float32(0.7), 1.0,
                          1e-6)) == want
    assert int(sample_device(torch.from_numpy(logits), torch.tensor(0.7),
                             1.0, 1e-6)) == want


def test_rng_clone_and_array_match_reference():
    from distributed_llama_tpu.utils.rng import Xorshift64 as Ref
    from distributed_llama_tpu_torch.utils.rng import Xorshift64

    ref, got = Ref(1234), Xorshift64(1234)
    ref.f32(), got.f32()
    np.testing.assert_array_equal(got.clone().f32_array(50),
                                  ref.clone().f32_array(50))
    assert got.state == ref.state  # a clone leaves the stream where it was
    np.testing.assert_array_equal(got.f32_array(7), ref.f32_array(7))
    assert got.state == ref.state
    assert got.f32() == ref.f32()


# ---------------------------------------------------------------------------
# generate_fast
# ---------------------------------------------------------------------------

def _streams(name, temperature, topp, prompt, steps, chunk, tok_path,
             params=None, seed=7):
    """(JAX generate_fast, port generate_fast, port generate) streams and
    the three samplers' final states."""
    from distributed_llama_tpu.io.tokenizer import Tokenizer as RefTok
    from distributed_llama_tpu.runtime.generate import Engine as RefEngine
    from distributed_llama_tpu.runtime.generate import \
        generate_fast as ref_fast
    from distributed_llama_tpu.runtime.sampling import Sampler as RefSampler
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                              generate,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    spec = SPECS[name]
    if params is None:
        params = synth_params(spec, q40=name == "q40", seed=3, scale=0.3)
    s_ref = RefSampler(spec.vocab_size, temperature, topp, seed=seed,
                       use_native=False)
    want, _ = ref_fast(RefEngine(spec, params), RefTok(tok_path,
                                                       spec.vocab_size),
                       s_ref, prompt, steps, quiet=True, prefill_chunk=chunk)
    pspec = _port_spec(spec)
    tok = Tokenizer(tok_path, spec.vocab_size)
    s_fast = Sampler(spec.vocab_size, temperature, topp, seed=seed)
    fast, _ = generate_fast(Engine(pspec, _host(params), "cpu"), tok, s_fast,
                            prompt, steps, quiet=True, prefill_chunk=chunk)
    s_step = Sampler(spec.vocab_size, temperature, topp, seed=seed)
    step, _ = generate(Engine(pspec, _host(params), "cpu"), tok, s_step,
                       prompt, steps, quiet=True, prefill_chunk=chunk)
    return (want, fast, step), (s_ref.rng.state, s_fast.rng.state,
                                s_step.rng.state)


SAMPLING = {"greedy": (0.0, 0.9), "seeded": (0.8, 0.9),
            "multinomial": (0.9, 0.0)}


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_fast_matches_reference_and_generate(name, mode, chunk,
                                                      tok_path):
    """The fused loop's stream equals the JAX fused loop's and the port's
    per-step loop's, token by token, and leaves the sampler where they do;
    with ``chunk`` the 12-token prompt prefix is prefilled first."""
    prompt = " ".join(["hi"] * 12) if chunk else "hi"
    (want, fast, step), states = _streams(name, *SAMPLING[mode], prompt, 20,
                                          chunk, tok_path)
    assert len(want) > 4
    assert fast == want
    assert step == want
    assert states[0] == states[1] == states[2]


def test_generate_fast_rewinds_the_sampler_after_an_early_bos(tok_path):
    """A chain that samples BOS mid-stream leaves the sampler's xorshift
    stream exactly where the per-step loop leaves it (and where the JAX
    fused loop leaves it), so a reused Sampler stays equivalent."""
    from distributed_llama_tpu_torch.utils.rng import Xorshift64

    spec = SPECS["f32"]
    # an all-zero model: uniform probabilities, so the multinomial pick is
    # floor(coin * vocab) and BOS fires when a coin lands in bucket 1
    params = synth_params(spec, q40=False, seed=3, scale=0.0)
    params["wcls"] = np.zeros_like(params["wcls"])
    params["tok_embedding"] = np.zeros_like(params["tok_embedding"])
    steps = 12
    n_sampled = steps - 1  # "hi" is BOS + one piece
    seed = next(s for s in range(1, 2000)
                if any(int(c * spec.vocab_size) == 1
                       for c in Xorshift64(s).f32_array(n_sampled - 1)))
    (want, fast, step), states = _streams("f32", 0.7, 0.0, "hi", steps, 0,
                                          tok_path, params, seed)
    assert fast == want == step
    assert len(fast) < steps  # the chain really stopped early on BOS
    assert states[0] == states[1] == states[2]


def test_generate_fast_prints_pieces_and_the_fused_stats(tok_path, capsys):
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.models.synth import \
        synth_params as port_synth
    from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    pspec = _port_spec(SPECS["f32"])
    engine = Engine(pspec, port_synth(pspec, q40=False, seed=3, scale=0.3),
                    "cpu")
    out, stats = generate_fast(engine, Tokenizer(tok_path, 256),
                               Sampler(256, 0.0, 0.9, 1), "hi", 10)
    text = capsys.readouterr().out
    # the forced "hi" and 9 sampled tokens, no BOS in 10 steps
    assert stats.tokens == len(out) == 10
    assert "Generated tokens:    10" in text
    assert "(fused loop, 10 device steps)" in text


# ---------------------------------------------------------------------------
# DecodeLoop
# ---------------------------------------------------------------------------

def test_decode_loop_steps_after_the_stop_change_nothing():
    """Replayed past the stop (a block of 8 where row 0 produces BOS at
    step 2), the loop leaves the recorded tokens and the cache rows the
    chain wrote as they were after the stop; num_steps bounds the run."""
    from distributed_llama_tpu_torch.io.tokenizer import BOS
    from distributed_llama_tpu_torch.runtime.decode import DecodeLoop

    vocab, seq = 16, 12
    cache = torch.zeros(seq)
    script = [5, 6, BOS, 9, 9, 9, 9, 9, 9, 9]  # greedy picks, in order

    def step(tokens, pos):
        cache[pos.long()] = tokens.float() * 10 + pos.float()
        logits = torch.full((1, vocab), -1.0)
        logits[0, script[int(pos[0])]] = 1.0
        return logits

    loop = DecodeLoop(step, 1, seq, 0.0, 0.9, "cpu", block=8)
    prompts = np.full((1, seq + 1), -1)
    prompts[0, 0] = 3
    out, ran = loop.run(prompts, [3], np.zeros((1, seq)), [0], seq)
    assert ran == 8  # one block, then the done flag stopped the run
    assert out[0].tolist()[:4] == [5, 6, BOS, BOS]
    assert (out[0, 3:] == BOS).all()
    # rows 0..2 were written by the chain; later steps wrote past them
    assert cache[:3].tolist() == [30.0, 51.0, 62.0]
    out, ran = loop.run(prompts, [3], np.zeros((1, seq)), [0], 2)
    assert ran == 2 and out[0].tolist()[:3] == [5, 6, BOS]
