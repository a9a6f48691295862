"""The port's generation checkpoints (runtime/checkpoint.py) and resume
(``generate`` / ``generate_fast`` with ``resume=``): a split run equals the
unsplit one, token for token, in both loops, over f32 and bf16 caches,
greedy and seeded, with the split after the prompt and inside it; a
checkpoint written by either package resumes in the other to that
package's unsplit stream; format mismatches raise the JAX package's
messages."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.runtime import checkpoint as ref_ckpt
from distributed_llama_tpu.runtime.sampling import Sampler as RefSampler
from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.models.spec import TransformerSpec as PSpec
from distributed_llama_tpu_torch.runtime import checkpoint as ckpt
from distributed_llama_tpu_torch.runtime import generate as gen
from distributed_llama_tpu_torch.runtime.sampling import Sampler

# the JAX runtime package exports a function named generate: take the module
ref_gen = importlib.import_module("distributed_llama_tpu.runtime.generate")
SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=300, seq_len=32)
PORT_SPEC = PSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                  n_kv_heads=2, vocab_size=300, seq_len=32)
SAMPLING = {"greedy": (0.0, 0.9), "seeded": (0.9, 0.9)}
# (prompt, steps of the first part): after the prompt, and inside it
SPLITS = {"after-prompt": ("ab", 5), "mid-prompt": ("abcdefg", 4)}
TOTAL = 12


class _IdTokenizer:
    """encode -> [BOS, ...bytes]; the pieces are not compared."""

    def encode(self, text, bos=True, eos=False):
        return [1] + [3 + b for b in text.encode()]

    def decode_piece(self, prev, tok):
        return b"?"


@pytest.fixture(scope="module")
def params():
    return synth_params(SPEC, q40=False, seed=9, scale=0.3)


@pytest.fixture(scope="module")
def host(params):
    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else np.asarray(v))
            for k, v in params.items()}


def _engine(host, cache=torch.float32):
    return gen.Engine(PORT_SPEC, host, "cpu", cache_dtype=cache)


def _sampler(mode, seed=77):
    temperature, topp = SAMPLING[mode]
    return Sampler(PORT_SPEC.vocab_size, temperature, topp, seed)


def _ref_sampler(mode, seed=77):
    temperature, topp = SAMPLING[mode]
    return RefSampler(SPEC.vocab_size, temperature, topp, seed,
                      use_native=False)


LOOPS = {"generate": "generate", "fast": "generate_fast"}


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_split_generation_is_bit_identical(tmp_path, host, loop, cache, mode,
                                           split):
    run = getattr(gen, LOOPS[loop])
    dtype = torch.bfloat16 if cache == "bf16" else torch.float32
    prompt, first = SPLITS[split]
    tok = _IdTokenizer()
    full, _ = run(_engine(host, dtype), tok, _sampler(mode), prompt, TOTAL,
                  quiet=True)

    eng1, s1 = _engine(host, dtype), _sampler(mode)
    part1, stats1 = run(eng1, tok, s1, prompt, first, quiet=True)
    assert stats1.final_pos == first
    assert bool(stats1.prompt_rest) == (split == "mid-prompt")
    path = str(tmp_path / "gen.npz")
    ckpt.save_generation_state(path, eng1, s1, stats1.final_pos,
                               stats1.final_token, part1, stats1.prompt_rest)

    eng2 = _engine(host, dtype)
    s2 = _sampler(mode, seed=123)  # overwritten by the load
    cache_k = eng2.cache.k
    pos, token, prev, rest = ckpt.load_generation_state(path, eng2, s2)
    assert eng2.cache.k is cache_k  # restored in place, never rebound
    assert torch.equal(eng2.cache.k[:, :pos], eng1.cache.k[:, :pos])
    assert not eng2.cache.k[:, pos:].any()
    assert prev == part1 and pos == first and rest == stats1.prompt_rest
    part2, _ = run(eng2, tok, s2, "IGNORED", TOTAL - pos, quiet=True,
                   resume=(pos, token), resume_prompt=rest)
    assert part1 + part2 == full


def test_the_file_is_the_jax_format(tmp_path, host):
    eng, s = _engine(host, torch.bfloat16), _sampler("seeded")
    out, stats = gen.generate(eng, _IdTokenizer(), s, "abcdefg", 4,
                              quiet=True)
    path = str(tmp_path / "gen.npz")
    ckpt.save_generation_state(path, eng, s, stats.final_pos,
                               stats.final_token, out, stats.prompt_rest)
    z = np.load(path)
    assert sorted(z.files) == sorted(
        ["version", "header", "k", "v", "cache_dtype", "pos", "token",
         "rng_state", "tokens_out", "prompt_rest"])
    assert int(z["version"]) == 1 and str(z["cache_dtype"]) == "bfloat16"
    assert z["header"].tobytes() == SPEC.header()
    assert z["k"].dtype == np.float32 and z["k"].shape == (2, 4, 2, 16)
    assert z["rng_state"].dtype == np.uint64
    assert z["tokens_out"].dtype == z["prompt_rest"].dtype == np.int32


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_the_packages(tmp_path, params, host,
                                                writer, loop):
    """A checkpoint one package writes mid-prompt resumes in the other to
    the reader's own unsplit stream (seeded sampling)."""
    tok = _IdTokenizer()
    prompt, first = SPLITS["mid-prompt"]
    name = LOOPS[loop]
    path = str(tmp_path / "gen.npz")
    if writer == "port":
        eng1, s1 = _engine(host), _sampler("seeded")
        part1, st = getattr(gen, name)(eng1, tok, s1, prompt, first,
                                       quiet=True)
        ckpt.save_generation_state(path, eng1, s1, st.final_pos,
                                   st.final_token, part1, st.prompt_rest)
        full, _ = getattr(ref_gen, name)(ref_gen.Engine(SPEC, params), tok,
                                         _ref_sampler("seeded"), prompt,
                                         TOTAL, quiet=True)
        eng2, s2 = ref_gen.Engine(SPEC, params), _ref_sampler("seeded", 5)
        pos, token, prev, rest = ref_ckpt.load_generation_state(path, eng2,
                                                                s2)
        part2, _ = getattr(ref_gen, name)(eng2, tok, s2, "IGNORED",
                                          TOTAL - pos, quiet=True,
                                          resume=(pos, token),
                                          resume_prompt=rest)
    else:
        eng1, s1 = ref_gen.Engine(SPEC, params), _ref_sampler("seeded")
        part1, st = getattr(ref_gen, name)(eng1, tok, s1, prompt, first,
                                           quiet=True)
        ref_ckpt.save_generation_state(path, eng1, s1, st.final_pos,
                                       st.final_token, part1,
                                       st.prompt_rest)
        full, _ = getattr(gen, name)(_engine(host), tok, _sampler("seeded"),
                                     prompt, TOTAL, quiet=True)
        eng2, s2 = _engine(host), _sampler("seeded", 5)
        pos, token, prev, rest = ckpt.load_generation_state(path, eng2, s2)
        part2, _ = getattr(gen, name)(eng2, tok, s2, "IGNORED", TOTAL - pos,
                                      quiet=True, resume=(pos, token),
                                      resume_prompt=rest)
    assert prev == part1 and rest
    assert part1 + part2 == full


def _bad_files(tmp_path, params, host):
    """(label, path, dtype of the engine that loads it)."""
    eng, s = _engine(host), _sampler("greedy")
    out, st = gen.generate(eng, _IdTokenizer(), s, "ab", 4, quiet=True)
    good = str(tmp_path / "good.npz")
    ckpt.save_generation_state(good, eng, s, st.final_pos, st.final_token,
                               out)
    z = dict(np.load(good))
    files = []
    for label, key, value in (
            ("version", "version", np.int32(2)),
            ("header", "header", np.frombuffer(
                dataclasses.replace(SPEC, seq_len=64).header(),
                dtype=np.uint8))):
        path = str(tmp_path / f"{label}.npz")
        with open(path, "wb") as f:
            np.savez(f, **{**z, key: value})
        files.append((label, path, torch.float32))
    files.append(("dtype", good, torch.bfloat16))
    return files


def test_mismatches_raise_the_jax_messages(tmp_path, params, host):
    import jax.numpy as jnp

    for label, path, dtype in _bad_files(tmp_path, params, host):
        with pytest.raises(ValueError) as want:
            ref_ckpt.load_generation_state(
                path, ref_gen.Engine(SPEC, params,
                                     cache_dtype=(jnp.bfloat16
                                                  if dtype == torch.bfloat16
                                                  else jnp.float32)),
                _ref_sampler("greedy"))
        eng = _engine(host, dtype)
        with pytest.raises(ValueError) as got:
            ckpt.load_generation_state(path, eng, _sampler("greedy"))
        assert str(got.value) == str(want.value), label
        assert not eng.cache.k.any()  # nothing written before the check
