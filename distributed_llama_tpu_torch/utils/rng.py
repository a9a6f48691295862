"""xorshift64* RNG with bit-exact parity to the reference.

The reference draws its sampling coins from a xorshift64* generator
(randomU32/randomF32); seeded sampling parity needs its exact integer
sequence.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
_MULT = 0x2545F4914F6CDD1D


def random_u32(state: int) -> tuple[int, int]:
    """One xorshift64* step. Returns (new_state, u32 sample)."""
    s = state & _MASK64
    s ^= s >> 12
    s ^= (s << 25) & _MASK64
    s ^= s >> 27
    return s, ((s * _MULT) & _MASK64) >> 32


def random_f32(state: int) -> tuple[int, float]:
    """float32 in [0, 1): (randomU32 >> 8) / 2^24."""
    s, u = random_u32(state)
    return s, np.float32(u >> 8) / np.float32(16777216.0)


class Xorshift64:
    """Stateful generator of the sampler's coins. ``draws`` counts the
    coins produced since construction: the request journal's coin cursor
    (runtime/journal.py), which a recovered request's sampler skips to so
    its stream continues with the coins the first life would have drawn
    next (forced prompt steps and unreached draft slots draw none)."""

    def __init__(self, seed: int):
        self.state = seed & _MASK64
        self.draws = 0

    def clone(self) -> "Xorshift64":
        """A copy at the current stream position: generate_fast pre-draws
        its coins on a clone, then advances this stream by only the coins
        the per-step loop would have consumed."""
        c = Xorshift64(0)
        c.state = self.state
        c.draws = self.draws
        return c

    def f32(self) -> float:
        self.state, f = random_f32(self.state)
        self.draws += 1
        return f

    def skip(self, n: int) -> None:
        """Advance ``n`` draws without producing coins (journal recovery:
        every draw moves the state by one xorshift step)."""
        if n < 0:
            raise ValueError(f"cannot skip {n} draws")
        s = self.state
        for _ in range(n):
            s, _u = random_u32(s)
        self.state = s
        self.draws += n

    def f32_array(self, n: int) -> np.ndarray:
        """The next n coins (the same sequence as n f32() calls): the state
        recurrence in Python ints, the float conversion vectorised."""
        out = np.empty(n, dtype=np.uint32)
        s = self.state
        for i in range(n):
            s, out[i] = random_u32(s)
        self.state = s
        self.draws += n
        return (out >> np.uint32(8)).astype(np.float32) / np.float32(16777216.0)
