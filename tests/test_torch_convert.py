"""The port's converter (distributed_llama_tpu_torch/convert.py) writes the
JAX converter's .bin byte for byte: from synthetic Meta shards (the
tensor-parallel halves re-concatenated, the -1 vocab sentinel derived)
and from a tiny HF LlamaForCausalLM written with the installed
transformers (twins of tests/test_convert.py), at every target type; the
``convert`` mode of the port's CLI runs it, and --export-tokenizer without
sentencepiece fails on its import as the JAX converter does. Nothing is
downloaded."""

import json

import numpy as np
import pytest
import torch

TARGETS = ("float32", "float16", "q40")


@pytest.fixture(scope="module")
def meta_dir(tmp_path_factory):
    """A Meta checkpoint: dim 64, 2 layers, 4 heads, two TP shards."""
    dim, hidden, n_layers, n_heads, vocab = 64, 96, 2, 4, 128
    rng = np.random.default_rng(0)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    full = {"tok_embeddings.weight": t(vocab, dim), "norm.weight": 1 + t(dim),
            "output.weight": t(vocab, dim)}
    for i in range(n_layers):
        full[f"layers.{i}.attention_norm.weight"] = 1 + t(dim)
        full[f"layers.{i}.ffn_norm.weight"] = 1 + t(dim)
        for k in ("wq", "wk", "wv", "wo"):
            full[f"layers.{i}.attention.{k}.weight"] = t(dim, dim)
        full[f"layers.{i}.feed_forward.w1.weight"] = t(hidden, dim)
        full[f"layers.{i}.feed_forward.w2.weight"] = t(dim, hidden)
        full[f"layers.{i}.feed_forward.w3.weight"] = t(hidden, dim)
    axis1 = ("tok_embeddings", "attention.wo", "feed_forward.w2")
    shards = [{}, {}]
    for key, arr in full.items():
        ax = 1 if any(a in key for a in axis1) else 0
        parts = ([arr, arr] if arr.ndim == 1
                 else np.array_split(arr, 2, axis=ax))
        for s, part in zip(shards, parts):
            s[key] = torch.from_numpy(np.ascontiguousarray(part))
    d = tmp_path_factory.mktemp("meta")
    for i, s in enumerate(shards):
        torch.save(s, str(d / f"consolidated.{i:02d}.pth"))
    (d / "params.json").write_text(json.dumps(
        {"dim": dim, "n_layers": n_layers, "n_heads": n_heads,
         "vocab_size": -1, "norm_eps": 1e-5}))
    return str(d)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, vocab_size=128,
                      max_position_embeddings=64, rms_norm_eps=1e-5,
                      tie_word_embeddings=False)
    torch.manual_seed(0)
    d = str(tmp_path_factory.mktemp("hf") / "hf")
    LlamaForCausalLM(cfg).eval().save_pretrained(d)
    return d


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("target", TARGETS)
def test_meta_bin_is_the_jax_converters(meta_dir, tmp_path, target):
    from distributed_llama_tpu.convert import convert_meta as jax_convert
    from distributed_llama_tpu_torch.convert import convert_meta
    from distributed_llama_tpu_torch.io.loader import read_spec

    mine = convert_meta(meta_dir, target, out=str(tmp_path / "p.bin"),
                        seq_len=32)
    theirs = jax_convert(meta_dir, target, out=str(tmp_path / "j.bin"),
                         seq_len=32)
    assert _bytes(mine) == _bytes(theirs)
    spec = read_spec(mine)
    assert (spec.vocab_size, spec.hidden_dim) == (128, 96)


@pytest.mark.parametrize("target", TARGETS)
def test_hf_bin_is_the_jax_converters(hf_dir, tmp_path, target):
    from distributed_llama_tpu.convert import convert_hf as jax_convert
    from distributed_llama_tpu_torch.convert import convert_hf
    from distributed_llama_tpu_torch.io.loader import read_spec

    mine = convert_hf(hf_dir, target, out=str(tmp_path / "p.bin"),
                      seq_len=32)
    theirs = jax_convert(hf_dir, target, out=str(tmp_path / "j.bin"),
                         seq_len=32)
    assert _bytes(mine) == _bytes(theirs)
    assert read_spec(mine).n_kv_heads == 2  # GQA carried through


def test_cli_convert_mode(meta_dir, tmp_path, capsys):
    """``convert`` through the port's CLI; argparse's usage error returns
    its code; --export-tokenizer without sentencepiece raises its
    ImportError after the .bin is written, as the JAX converter's does."""
    from distributed_llama_tpu_torch.frontend.cli import main

    out = tmp_path / "cli.bin"
    assert main(["convert", meta_dir, "q40", "--out", str(out),
                 "--seq-len", "32"]) == 0
    assert out.stat().st_size > 0
    assert "✅" in capsys.readouterr().out
    assert main(["convert"]) == 2
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            main(["convert", meta_dir, "q40", "--out", str(out),
                  "--seq-len", "32", "--export-tokenizer", "t.model"])
