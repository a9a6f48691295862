"""Token sampler with reference semantics, on host numpy.

temperature == 0 -> argmax; else logits/temp -> max-subtracted softmax -> coin
from xorshift64* -> nucleus (top-p) with the (1-p)/(n-1) cutoff pre-filter and
stable descending sort, or plain multinomial CDF walk when topp is outside
(0, 1). All float math in float32, like the reference.
"""

from __future__ import annotations

import numpy as np

from ..utils.rng import Xorshift64


def softmax_f32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    e = np.exp(x - x.max(), dtype=np.float32)
    return e / np.float32(e.sum(dtype=np.float32))


def sample_argmax(probs: np.ndarray) -> int:
    return int(np.argmax(probs))


def sample_mult(probs: np.ndarray, coin: float) -> int:
    cdf = np.cumsum(probs.astype(np.float32))
    idx = int(np.searchsorted(cdf, coin, side="right"))
    return min(idx, len(probs) - 1)


def sample_topp(probs: np.ndarray, topp: float, coin: float) -> int:
    n = len(probs)
    if n == 1:
        return 0
    cutoff = np.float32(1.0 - topp) / np.float32(n - 1)
    idx = np.nonzero(probs >= cutoff)[0]
    if len(idx) == 0:
        # degenerate nucleus (topp < 1/n with near-uniform probs): keep the
        # single most-probable token
        return int(np.argmax(probs))
    # descending by prob; stable so equal probs keep index order
    order = idx[np.argsort(-probs[idx], kind="stable")]
    p_sorted = probs[order].astype(np.float32)
    cum = np.float32(0.0)
    last = len(order) - 1
    for i, p in enumerate(p_sorted):
        cum += p
        if cum > topp:
            last = i
            break
    r = np.float32(coin) * cum
    cdf = np.float32(0.0)
    for i in range(last + 1):
        cdf += p_sorted[i]
        if r < cdf:
            return int(order[i])
    return int(order[last])


class Sampler:
    """The reference sampler over host f32 logits."""

    def __init__(self, vocab_size: int, temperature: float, topp: float,
                 seed: int):
        self.vocab_size = vocab_size
        self.temperature = float(temperature)
        self.topp = float(topp)
        self.rng = Xorshift64(seed)

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32)[:self.vocab_size]
        if self.temperature == 0.0:
            return sample_argmax(logits)
        coin = self.rng.f32()
        probs = softmax_f32(logits / np.float32(self.temperature))
        if self.topp <= 0 or self.topp >= 1:
            return sample_mult(probs, coin)
        return sample_topp(probs, self.topp, coin)
