"""Self-speculative decoding on the host: the n-gram drafter and the
lossless acceptance rules (the JAX package's runtime/speculative.py; this
is the port's own copy, over runtime/sampling).

A verify dispatch (``Llama.forward_batch_spec_paged``) scores a row's
current token plus up to K-1 drafted tokens in ONE K-query forward, so the
dispatch pays the per-layer launch and collective schedule once for up to
K emitted tokens. The drafter is prompt lookup (n-gram self-drafting): the
proposal for what comes next is whatever followed the most recent earlier
occurrence of the stream's final n-gram. No second model, no extra
weights.

Losslessness contract:

* greedy rows (temperature 0): a draft is accepted iff it equals the
  verified argmax, so the emitted stream is the spec-off stream whenever
  the verify forward's logits rank the tokens as K decode steps would
  (on the CPU and in the JAX package bit for bit; on the card the B*K
  flat rows may take the T > 8 Q40 GEMM where decode takes the small-T
  matvec, so a stream may part from the spec-off one at a near-tie of the
  top-2 logits);
* sampled rows (temperature > 0): Leviathan-style rejection sampling
  against the sampler's EFFECTIVE distribution (temperature softmax and
  the reference's nucleus filter, ``effective_probs``). The drafter is a
  point mass q = one-hot(draft), so the draft is accepted with
  probability p(draft); on rejection the token is resampled from the
  residual norm(max(0, p - q)), p with the draft zeroed and renormalized.
  Combined law: P(x = draft) = p(draft), P(x = y) = (1 - p(draft)) *
  p(y) / (1 - p(draft)) = p(y): the output distribution is the baseline
  sampler's (the coin stream's realization differs from spec-off).

Coin discipline: a draft position the replay reaches draws one accept
coin from the row's xorshift stream, plus one residual coin on rejection;
positions never reached draw nothing, so a seeded engine replays
deterministically.

Speculative decoding and token-budget mixed dispatch
(``--dispatch-tokens``) are mutually exclusive, refused by the CLI (exit
2) and by ContinuousEngine.__init__: both spend the per-row span of the
fused dispatch window, speculation on draft guesses, mixed batching on
one prefill slice. Pick --spec-k when decode latency dominates and
--dispatch-tokens when prefill stalls decode.
"""

from __future__ import annotations

import numpy as np

from .sampling import Sampler, sample_mult, softmax_f32


def draft_tokens(history, k: int, max_n: int = 3, min_n: int = 1) -> list:
    """Prompt-lookup proposal: up to ``k`` tokens copied from after an
    earlier occurrence of the stream's final n-gram.

    The longest n-gram is tried first (``max_n`` down to ``min_n``).
    Among matches of one length, the nearest whose continuation fills the
    whole window wins, else the longest continuation found (a match near
    the stream's end truncates, so a short-period repetition would never
    fill the window otherwise). Returns [] when no earlier occurrence
    exists."""
    if k <= 0:
        return []
    h = list(history)
    for n in range(max_n, min_n - 1, -1):
        if len(h) <= n:
            continue
        tail = h[-n:]
        best: list = []
        # windows equal to the tail that end before the stream's end, so a
        # match's continuation is never empty
        for j in range(len(h) - n - 1, -1, -1):
            if h[j:j + n] == tail:
                cont = h[j + n:j + n + k]
                if len(cont) == k:
                    return cont
                if len(cont) > len(best):
                    best = cont
        if best:
            return best
    return []


def effective_probs(logits: np.ndarray, temperature: float,
                    topp: float) -> np.ndarray:
    """The distribution Sampler.sample realizes with one coin, as a (V,)
    f32 vector: softmax(logits / temperature) in f32; topp outside (0, 1)
    keeps it whole; otherwise the reference nucleus ((1-p)/(n-1) cutoff,
    stable descending sort, cut where the f32 running sum passes topp),
    renormalized by the kept mass. A cutoff that keeps nothing collapses
    to the argmax point mass, as the sampler does."""
    probs = softmax_f32(np.asarray(logits, np.float32)
                        / np.float32(temperature))
    n = len(probs)
    if topp <= 0 or topp >= 1 or n == 1:
        return probs
    cutoff = np.float32(1.0 - topp) / np.float32(n - 1)
    idx = np.nonzero(probs >= cutoff)[0]
    out = np.zeros_like(probs)
    if len(idx) == 0:
        out[int(np.argmax(probs))] = 1.0
        return out
    order = idx[np.argsort(-probs[idx], kind="stable")]
    p_sorted = probs[order].astype(np.float32)
    cum = np.float32(0.0)
    last = len(order) - 1
    for i, p in enumerate(p_sorted):
        cum += p
        if cum > topp:
            last = i
            break
    kept = order[:last + 1]
    out[kept] = probs[kept] / cum
    return out


def accept_or_resample(logits: np.ndarray, draft: int,
                       sampler: Sampler) -> tuple[int, bool]:
    """One rejection-sampling step for a point-mass drafter: (next token,
    accepted). The draft is accepted with probability p_eff(draft) (one
    coin); on rejection one more coin walks the CDF of p_eff with the
    draft zeroed, renormalized."""
    p = effective_probs(np.asarray(logits, np.float32)[:sampler.vocab_size],
                        sampler.temperature, sampler.topp)
    coin = sampler.rng.f32()
    if coin < p[draft]:
        return int(draft), True
    residual = p.copy()
    residual[draft] = 0.0
    total = np.float32(residual.sum(dtype=np.float32))
    if total <= 0.0:
        # p_eff was a point mass on the draft and the coin fell outside
        # it: unreachable for f32 coins in [0, 1), but deterministic
        return int(np.argmax(p)), False
    return int(sample_mult(residual / total, sampler.rng.f32())), False
