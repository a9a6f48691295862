"""Model spec + .bin file layout accounting.

File format parity with the reference: a 28-byte header of 7 little-endian
int32 {dim, hiddenDim, nLayers, nHeads, nKvHeads, vocabSize, seqLen}, then
tensors in this fixed order:

  tok_embeddings (F32, vocab x dim)
  per layer: attention_norm (F32 dim), ffn_norm (F32 dim),
             wq (dim x dim), wk (kvDim x dim), wv (kvDim x dim), wo (dim x dim),
             w1 (hidden x dim), w2 (dim x hidden), w3 (hidden x dim)
             [all in weightsFloatType]
  norm (F32 dim)
  <gap: 2 * seqLen * headSize/2 f32 — the legacy freq_cis region, skipped>
  output/wcls (vocab x dim, weightsFloatType)

Matmul weights are stored row-major (d, n): out[i] = sum_j w[i, j] * x[j].
"""

from __future__ import annotations

import dataclasses
import struct

from ..ops.quants import FloatType, batch_bytes

HEADER_STRUCT = struct.Struct("<7i")
HEADER_BYTES = HEADER_STRUCT.size  # 28


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    weights_float_type: FloatType = FloatType.F32
    buffer_float_type: FloatType = FloatType.F32

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    @property
    def kv_mul(self) -> int:
        """GQA group size: query heads per kv head."""
        return self.n_heads // self.n_kv_heads

    # -- header ------------------------------------------------------------

    @classmethod
    def from_header(cls, raw: bytes, weights_float_type=FloatType.F32,
                    buffer_float_type=FloatType.F32) -> "TransformerSpec":
        dim, hidden, n_layers, n_heads, n_kv, vocab, seq = HEADER_STRUCT.unpack(
            raw[:HEADER_BYTES])
        # llama2.c-style exports flag a shared classifier with a negative
        # vocab size; the reference takes abs()
        return cls(dim, hidden, n_layers, n_heads, n_kv, abs(vocab), seq,
                   FloatType(weights_float_type), FloatType(buffer_float_type))

    def header(self) -> bytes:
        return HEADER_STRUCT.pack(self.dim, self.hidden_dim, self.n_layers,
                                  self.n_heads, self.n_kv_heads,
                                  self.vocab_size, self.seq_len)

    # -- per-tensor shapes (d, n) in file order ----------------------------

    def layer_matmul_shapes(self) -> list[tuple[str, tuple[int, int]]]:
        d, h, kv = self.dim, self.hidden_dim, self.kv_dim
        return [("wq", (d, d)), ("wk", (kv, d)), ("wv", (kv, d)),
                ("wo", (d, d)), ("w1", (h, d)), ("w2", (d, h)), ("w3", (h, d))]

    def matmul_bytes(self, shape: tuple[int, int]) -> int:
        dd, nn = shape
        return batch_bytes(self.weights_float_type, nn, dd)

    @property
    def rope_gap_bytes(self) -> int:
        """The legacy freq_cis_real+imag region."""
        return 2 * (self.seq_len * self.head_size // 2) * 4

    def block_bytes(self) -> int:
        b = 2 * self.dim * 4  # rmsAtt + rmsFfn, always F32
        for _, shape in self.layer_matmul_shapes():
            b += self.matmul_bytes(shape)
        return b

    def file_size(self) -> int:
        """Byte-exact total of a .bin of this spec."""
        b = HEADER_BYTES
        b += self.vocab_size * self.dim * 4          # tok_embeddings, F32
        b += self.n_layers * self.block_bytes()
        b += self.dim * 4                            # rmsFinal, F32
        b += self.rope_gap_bytes
        b += self.matmul_bytes((self.vocab_size, self.dim))  # wcls
        return b
