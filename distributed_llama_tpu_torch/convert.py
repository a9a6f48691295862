"""Weight converter: Meta/HF Llama checkpoints -> reference-format .bin (the
JAX package's convert.py, the port's own copy: the same bytes).

Capability parity with the reference converter (converter/converter.py): reads
Meta ``consolidated.*.pth`` shards + ``params.json``, re-concatenates Meta's
tensor-parallel shards (dim=1 for tok_embeddings/wo/w2, dim=0 otherwise,
converter.py:131-148), and writes the header + tensors in the fixed reference
order with norms/embeddings always F32 and the legacy rope.freqs gap
(converter.py:85-151). Target float types: q40 | float16 | float32.

Extensions beyond the reference:
* ``--source hf``: convert a HuggingFace LlamaForCausalLM checkpoint
  (safetensors/pytorch), mapping q/k heads back from HF's permuted layout to
  Meta's interleaved RoPE layout.
* tokenizer export: ``--export-tokenizer`` writes the llama2.c tokenizer.bin
  from a sentencepiece tokenizer.model.

Usage: python -m distributed_llama_tpu_torch.convert <modelPath>
       <q40|float16|float32> [--out FILE] [--seq-len N] [--source meta|hf]
       (or ``dllama-torch convert ...``: frontend/cli.py)
"""

from __future__ import annotations

import argparse
import gc
import json
import os
from pathlib import Path

import numpy as np
import torch

from .io.loader import _write_matmul  # the port's own Q40/F16 packers
from .models.spec import TransformerSpec
from .ops.quants import FloatType

_FT = {"float32": FloatType.F32, "float16": FloatType.F16,
       "q40": FloatType.Q40}

# file-order tensor names per layer, and their Meta checkpoint keys
_LAYER_TENSORS = [
    ("rms_att", "layers.{i}.attention_norm.weight"),
    ("rms_ffn", "layers.{i}.ffn_norm.weight"),
    ("wq", "layers.{i}.attention.wq.weight"),
    ("wk", "layers.{i}.attention.wk.weight"),
    ("wv", "layers.{i}.attention.wv.weight"),
    ("wo", "layers.{i}.attention.wo.weight"),
    ("w1", "layers.{i}.feed_forward.w1.weight"),
    ("w2", "layers.{i}.feed_forward.w2.weight"),
    ("w3", "layers.{i}.feed_forward.w3.weight"),
]
# Meta shards concatenate along dim=1 for these (converter.py:131-136)
_AXIS1 = {"tok_embedding", "wo", "w2"}
_ALWAYS_F32 = {"tok_embedding", "rms_att", "rms_ffn", "rms_final"}


def _is_f32(name: str) -> bool:
    return name in _ALWAYS_F32


class MetaCheckpoint:
    """Streams tensors from Meta consolidated.*.pth shards, one key at a time."""

    def __init__(self, model_path: str):
        self.torch = torch
        self.paths = sorted(Path(model_path).glob("consolidated.*.pth"))
        if not self.paths:
            raise FileNotFoundError(
                f"no consolidated.*.pth under {model_path}")
        with open(os.path.join(model_path, "params.json")) as f:
            self.params = json.load(f)
        # mmap'd lazy loads: tensors materialize per-key, not per-file
        self.shards = [torch.load(p, map_location="cpu", mmap=True,
                                  weights_only=True) for p in self.paths]

    def tensor(self, key: str, axis1: bool) -> np.ndarray:
        parts = [s[key] for s in self.shards]
        t = (parts[0] if len(parts) == 1 or parts[0].dim() == 1
             else self.torch.cat(parts, dim=1 if axis1 else 0))
        return t.to(self.torch.float32).numpy()

    def spec(self, target: FloatType, seq_len: int) -> TransformerSpec:
        p = self.params
        vocab = p["vocab_size"]
        if vocab < 1:
            # Meta ships vocab_size=-1 as a sentinel; derive the real count
            # from the embedding table (the reference refuses outright,
            # converter.py:76-77 'Invalid vocab size')
            # tok_embeddings shards along dim=1, so shape[0] is the full vocab
            vocab = self.shards[0]["tok_embeddings.weight"].shape[0]
            if vocab < 1:
                raise ValueError("Invalid vocab size")
        w1 = self.shards[0]["layers.0.feed_forward.w1.weight"]
        hidden = w1.shape[0] * len(self.shards)
        return TransformerSpec(
            dim=p["dim"], hidden_dim=hidden, n_layers=p["n_layers"],
            n_heads=p["n_heads"],
            n_kv_heads=p.get("n_kv_heads") or p["n_heads"],
            vocab_size=vocab, seq_len=seq_len,
            weights_float_type=target)

    def keys(self):
        return {"tok_embedding": "tok_embeddings.weight",
                "rms_final": "norm.weight", "wcls": "output.weight"}


class HFCheckpoint:
    """HuggingFace LlamaForCausalLM -> reference tensor layout.

    HF stores wq/wk with rotary halves separated
    (permute: [h, 2, hs/2] view); Meta/reference RoPE expects interleaved
    pairs, so we invert the permutation.
    """

    def __init__(self, model_path: str):
        self.torch = torch
        from transformers import AutoConfig

        self.config = AutoConfig.from_pretrained(model_path)
        self.path = model_path
        self._state = None

    @property
    def state(self):
        if self._state is None:
            from transformers import AutoModelForCausalLM

            model = AutoModelForCausalLM.from_pretrained(
                self.path, torch_dtype=self.torch.float32,
                low_cpu_mem_usage=True)
            self._state = model.state_dict()
        return self._state

    def _unpermute(self, w: "np.ndarray", n_heads: int) -> np.ndarray:
        d, n = w.shape
        hs = d // n_heads
        return (w.reshape(n_heads, 2, hs // 2, n)
                .transpose(0, 2, 1, 3).reshape(d, n))

    def spec(self, target: FloatType, seq_len: int) -> TransformerSpec:
        c = self.config
        return TransformerSpec(
            dim=c.hidden_size, hidden_dim=c.intermediate_size,
            n_layers=c.num_hidden_layers, n_heads=c.num_attention_heads,
            n_kv_heads=getattr(c, "num_key_value_heads",
                               c.num_attention_heads),
            vocab_size=c.vocab_size, seq_len=seq_len,
            weights_float_type=target)

    def tensor_by_name(self, name: str, layer: int | None,
                       spec: TransformerSpec) -> np.ndarray:
        hf = {
            "tok_embedding": "model.embed_tokens.weight",
            "rms_final": "model.norm.weight",
            "wcls": "lm_head.weight",
            "rms_att": f"model.layers.{layer}.input_layernorm.weight",
            "rms_ffn": f"model.layers.{layer}.post_attention_layernorm.weight",
            "wq": f"model.layers.{layer}.self_attn.q_proj.weight",
            "wk": f"model.layers.{layer}.self_attn.k_proj.weight",
            "wv": f"model.layers.{layer}.self_attn.v_proj.weight",
            "wo": f"model.layers.{layer}.self_attn.o_proj.weight",
            "w1": f"model.layers.{layer}.mlp.gate_proj.weight",
            "w2": f"model.layers.{layer}.mlp.down_proj.weight",
            "w3": f"model.layers.{layer}.mlp.up_proj.weight",
        }[name]
        w = self.state[hf].to(self.torch.float32).numpy()
        if name == "wq":
            w = self._unpermute(w, spec.n_heads)
        elif name == "wk":
            w = self._unpermute(w, spec.n_kv_heads)
        return w


def convert_meta(model_path: str, target: str, out: str | None = None,
                 seq_len: int = 2048) -> str:
    ckpt = MetaCheckpoint(model_path)
    spec = ckpt.spec(_FT[target], seq_len)
    name = os.path.basename(os.path.normpath(model_path))
    out = out or f"dllama_{name}_{target}.bin"
    top = ckpt.keys()

    with open(out, "wb") as f:
        f.write(spec.header())
        _write_tensor(f, spec, "tok_embedding",
                      ckpt.tensor(top["tok_embedding"], True))
        for i in range(spec.n_layers):
            for name_, key in _LAYER_TENSORS:
                arr = ckpt.tensor(key.format(i=i), name_ in _AXIS1)
                _write_tensor(f, spec, name_, arr)
                del arr
            gc.collect()
            print(f"🔶 wrote layer {i + 1}/{spec.n_layers}")
        _write_tensor(f, spec, "rms_final", ckpt.tensor(top["rms_final"], False))
        f.write(b"\x00" * spec.rope_gap_bytes)
        _write_tensor(f, spec, "wcls", ckpt.tensor(top["wcls"], False))
    assert os.path.getsize(out) == spec.file_size()
    print(f"✅ {out}: {spec.file_size()} bytes")
    return out


def convert_hf(model_path: str, target: str, out: str | None = None,
               seq_len: int = 2048) -> str:
    ckpt = HFCheckpoint(model_path)
    spec = ckpt.spec(_FT[target], seq_len)
    name = os.path.basename(os.path.normpath(model_path))
    out = out or f"dllama_{name}_{target}.bin"
    with open(out, "wb") as f:
        f.write(spec.header())
        _write_tensor(f, spec, "tok_embedding",
                      ckpt.tensor_by_name("tok_embedding", None, spec))
        for i in range(spec.n_layers):
            for name_, _ in _LAYER_TENSORS:
                _write_tensor(f, spec, name_,
                              ckpt.tensor_by_name(name_, i, spec))
            print(f"🔶 wrote layer {i + 1}/{spec.n_layers}")
        _write_tensor(f, spec, "rms_final",
                      ckpt.tensor_by_name("rms_final", None, spec))
        f.write(b"\x00" * spec.rope_gap_bytes)
        _write_tensor(f, spec, "wcls", ckpt.tensor_by_name("wcls", None, spec))
    assert os.path.getsize(out) == spec.file_size()
    print(f"✅ {out}: {spec.file_size()} bytes")
    return out


def _write_tensor(f, spec: TransformerSpec, name: str, arr: np.ndarray) -> None:
    if _is_f32(name):
        f.write(np.ascontiguousarray(arr, dtype=np.float32).tobytes())
    else:
        _write_matmul(f, spec, arr)


def export_tokenizer(model_file: str, out: str = "tokenizer.bin") -> str:
    """sentencepiece tokenizer.model -> llama2.c tokenizer.bin."""
    from sentencepiece import SentencePieceProcessor  # optional dep

    from .io.tokenizer import write_tokenizer

    sp = SentencePieceProcessor(model_file=model_file)
    pieces, scores = [], []
    for i in range(sp.vocab_size()):
        piece = sp.id_to_piece(i).replace("▁", " ").encode("utf-8")
        pieces.append(piece)
        scores.append(float(sp.get_score(i)))
    write_tokenizer(out, pieces, scores)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_path")
    ap.add_argument("target", choices=sorted(_FT))
    ap.add_argument("--out")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--source", choices=["meta", "hf"], default="meta")
    ap.add_argument("--export-tokenizer", metavar="SP_MODEL",
                    help="also write tokenizer.bin from a sentencepiece model")
    args = ap.parse_args(argv)
    if args.source == "hf":
        convert_hf(args.model_path, args.target, args.out, args.seq_len)
    else:
        convert_meta(args.model_path, args.target, args.out, args.seq_len)
    if args.export_tokenizer:
        export_tokenizer(args.export_tokenizer)


if __name__ == "__main__":
    main()
