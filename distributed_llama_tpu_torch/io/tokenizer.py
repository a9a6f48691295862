"""llama2.c-format BPE tokenizer (tokenizer.bin), pure Python.

File format: header int32 max_token_length, then per token {f32 score,
int32 len, bytes}. encode = optional BOS(1) + dummy-prefix space token +
UTF-8 codepoint split with byte-fallback (token = byte + 3) + greedy
best-score pair merging. decode = piece lookup, strip one leading space right
after BOS, map '<0xNN>' byte tokens to raw bytes.
"""

from __future__ import annotations

import re
import struct

BOS = 1
EOS = 2

_BYTE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


class Tokenizer:
    def __init__(self, path: str, vocab_size: int):
        self.vocab_size = vocab_size
        self.vocab: list[bytes] = []
        self.scores: list[float] = []
        with open(path, "rb") as f:
            (self.max_token_length,) = struct.unpack("<i", f.read(4))
            for _ in range(vocab_size):
                score, ln = struct.unpack("<fi", f.read(8))
                self.vocab.append(f.read(ln))
                self.scores.append(score)
        self._lookup = {}
        for i, piece in enumerate(self.vocab):
            # first occurrence wins, like bsearch over a stable-sorted table
            self._lookup.setdefault(piece, i)

    def encode(self, text: str | bytes, bos: bool = True,
               eos: bool = False) -> list[int]:
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if bos:
            tokens.append(BOS)
        dummy = self._lookup.get(b" ") if text else None
        if dummy is not None:
            tokens.append(dummy)

        # split into UTF-8 codepoints (max 4 bytes), byte-fallback (+3) on miss
        i = 0
        n = len(text)
        while i < n:
            j = i + 1
            while j < n and (text[j] & 0xC0) == 0x80 and j - i < 4:
                j += 1
            chunk = text[i:j]
            tid = self._lookup.get(chunk)
            if tid is not None:
                tokens.append(tid)
            else:
                tokens.extend(b + 3 for b in chunk)
            i = j

        # greedy highest-score merges
        while True:
            best_score = -1e10
            best_id = best_idx = -1
            for k in range(len(tokens) - 1):
                merged = self.vocab[tokens[k]] + self.vocab[tokens[k + 1]]
                tid = self._lookup.get(merged)
                if tid is not None and self.scores[tid] > best_score:
                    best_score, best_id, best_idx = self.scores[tid], tid, k
            if best_idx == -1:
                break
            tokens[best_idx:best_idx + 2] = [best_id]

        if eos:
            tokens.append(EOS)
        return tokens

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        piece = self.vocab[token]
        if prev_token == BOS and piece.startswith(b" "):
            piece = piece[1:]
        m = _BYTE_RE.match(piece.decode("latin-1"))
        if m:
            return bytes([int(m.group(1), 16)])
        return piece


def write_tokenizer(path: str, pieces: list[bytes],
                    scores: list[float]) -> None:
    """Write a tokenizer.bin (test fixtures / synthetic runs)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", max((len(p) for p in pieces), default=0)))
        for piece, score in zip(pieces, scores):
            f.write(struct.pack("<fi", score, len(piece)))
            f.write(piece)
