"""The on-device token loop (the JAX package's runtime/decode.py).

The reference calls the forward once per token from the host and samples
on the host. Here the whole step runs on the device: the forward, the
reference sampler (``sample_device``), the forced prompt tokens, the stop
on BOS and the advance of the clock. ``DecodeLoop`` holds that step over
static device buffers, captures it once in a ``torch.cuda.CUDAGraph`` and
replays it, so a step costs one graph launch instead of ~1100 kernel
launches from Python. It is the one builder behind both JAX loops:

* ``make_decode_loop`` / ``generate_fast`` (``--fast``): one sequence, B = 1,
  from ``start_pos`` with the prompt forced relative to the chain;
* ``make_batch_decode_loop`` / ``generate_batch`` (``--prompts-file``): B
  rows in lockstep on one clock, ragged prompts right-padded with -1.

Both are the same step: every row forces ``prompts[b, i+1]`` when it is
>= 0, else samples with its coin ``coins[b, i]``; a row that produced BOS
is frozen (its input token stays, it records BOS) and ``done`` is set
once no row is active. The JAX single-sequence loop is a while_loop that
ends on a produced BOS; here the host replays in blocks of ``block`` steps
and reads ``done`` once per block, so up to block - 1 steps may run after
the stop. Such a step records BOS over the BOS-filled tail, keeps the
token, and writes its k/v at the next position, past every row the chain
wrote, so the output and the cache rows 0..stop stay as they were. The
host never runs more than ``num_steps`` steps, which keeps every position
inside the cache. On the CPU the same step runs in a Python loop.

The coins are the one thing drawn on the host: the reference's xorshift
stream is data-independent, so generate_fast pre-draws one per possibly
sampled step on a clone of the sampler's stream and rewinds afterwards.

A kernel wrapper counts a launch when Python calls it, so a call made
during capture counts though nothing ran, and a replay counts nothing.
``DecodeLoop`` moves the captured calls' counts onto the replays: after a
run every kernel's count is exactly the number of times it ran.

There is no fallback: if capture or a launch fails, the run raises; it
never drops to eager mode or to the plain versions. ``graph=False`` runs
the step eagerly on the card, as the tests do to hold the graph against it.

Left out: ``sample_device_dynamic`` and ``greedy_verify_tokens`` (the
continuous-batching slice), and ``make_decode_loop_aot`` with its
executable cache and upload touch, which are TPU-runtime machinery with no
torch twin.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..io.tokenizer import BOS
from ..ops._build import ALL as ALL_KERNELS

# step(tokens (B,) int64, pos (B,) int32) -> logits (B, vocab) f32, writing
# the k/v of every row at its position
StepFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _mult_walk(probs: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """Multinomial CDF walk (tokenizer.cpp:226-238) over the last dim."""
    vocab = probs.shape[-1]
    cdf = torch.cumsum(probs, dim=-1)
    idx = torch.searchsorted(cdf, coin[..., None], right=True)[..., 0]
    return torch.clamp(idx, max=vocab - 1)


def _nucleus_walk(probs: torch.Tensor, coin: torch.Tensor,
                  topp: float) -> torch.Tensor:
    """Nucleus pick (tokenizer.cpp:240-281) over the last dim: the cutoff
    pre-filter, a stable descending sort (ties keep index order), the cut
    at cum > topp, and the CDF walk over the kept prefix scaled by
    coin * cum. When the cutoff keeps nothing (possible for topp < 1/v) it
    falls back to the argmax, as the host Sampler does."""
    vocab = probs.shape[-1]
    cutoff = (1.0 - topp) / (vocab - 1)
    kept = torch.where(probs >= cutoff, probs, torch.zeros_like(probs))
    p_sorted, order = torch.sort(kept, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(p_sorted, dim=-1)
    total = cum[..., -1]
    # the first index where the cumulative probability exceeds topp
    last = torch.argmax((cum > topp).to(torch.uint8), dim=-1)
    last = torch.where(total > topp, last, torch.full_like(last, vocab - 1))
    r = coin * torch.gather(cum, -1, last[..., None])[..., 0]
    idx = torch.searchsorted(cum, r[..., None], right=True)[..., 0]
    idx = torch.minimum(idx, last)
    nuc = torch.gather(order, -1, idx[..., None])[..., 0]
    return torch.where(total > 0.0, nuc, torch.argmax(probs, dim=-1))


def sample_device(logits: torch.Tensor, coin: torch.Tensor,
                  temperature: float, topp: float) -> torch.Tensor:
    """The reference Sampler::sample on device tensors: logits (..., V)
    f32, coin (...) f32 -> token ids (...) int64. ``temperature`` and
    ``topp`` are fixed for a run, so the strategy is chosen here: argmax at
    temperature 0, else softmax(logits / temperature) and the multinomial
    walk (topp outside (0, 1)) or the nucleus walk. No value is read on
    the host."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    if topp <= 0 or topp >= 1:
        return _mult_walk(probs, coin)
    return _nucleus_walk(probs, coin, topp)


class DecodeLoop:
    """One decode step of B rows over static device buffers, run ``run``'s
    ``num_steps`` times: captured once in a CUDA graph on the card (unless
    ``graph=False``) and replayed, a Python loop on the CPU.

    Buffers: the input tokens (B,), positions (B,) int32, the step index,
    ``active`` (B,) and ``done``, the padded prompts (B, max_steps + 1),
    the coins (B, max_steps) and the output tokens (B, max_steps), which
    start as BOS. ``logits`` is the last step's (B, vocab) output. The
    graph is captured on the first run, whose first step runs eagerly on a
    side stream as the capture's warm-up; later runs only replay it.
    """

    def __init__(self, step: StepFn, batch: int, max_steps: int,
                 temperature: float, topp: float, device,
                 graph: bool | None = None, block: int = 16):
        self.step = step
        self.batch = batch
        self.max_steps = max_steps
        self.temperature = float(temperature)
        self.topp = float(topp)
        self.device = torch.device(device)
        self.graph = self.device.type == "cuda" if graph is None else graph
        if self.graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.block = block

        def buf(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=self.device)

        self.tokens = buf((batch,), torch.int64)
        self.pos = buf((batch,), torch.int32)
        self.index = buf((), torch.int64)
        self.active = buf((batch,), torch.bool, True)
        self.done = buf((), torch.bool, False)
        self.prompts = buf((batch, max_steps + 1), torch.int64, -1)
        self.coins = buf((batch, max_steps), torch.float32)
        self.out = buf((batch, max_steps), torch.int64, BOS)
        self.logits: torch.Tensor | None = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._captured: dict = {}  # kernel -> launches per replay
        self.replays = 0

    def _step(self) -> None:
        """Forward, sample, force the prompt, record, freeze finished rows,
        advance: in place on the buffers, nothing read on the host."""
        logits = self.step(self.tokens, self.pos)
        col = self.index.expand(self.batch)[:, None]
        coin = self.coins.gather(1, col)[:, 0]
        sampled = sample_device(logits, coin, self.temperature, self.topp)
        forced = self.prompts.gather(1, col + 1)[:, 0]
        nxt = torch.where(forced >= 0, forced, sampled)
        # a finished row records BOS and keeps its input token, as the JAX
        # batch loop's frozen rows do
        self.out.scatter_(1, col, torch.where(self.active, nxt,
                                              torch.full_like(nxt, BOS))
                          [:, None])
        self.active.logical_and_(nxt != BOS)
        self.tokens.copy_(torch.where(self.active, nxt, self.tokens))
        self.pos.add_(1)
        self.index.add_(1)
        self.done.copy_(~self.active.any())
        self.logits = logits

    def _capture(self) -> None:
        """The first step eagerly on a side stream (the capture's warm-up,
        which also makes each kernel's one-time shared-memory opt-in), then
        the capture of the next one, whose calls' counts are taken off the
        kernels and kept as the launches of one replay."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = {k: k.launches for k in ALL_KERNELS}
        with torch.cuda.graph(graph):
            self._step()
        self._captured = {k: k.launches - n for k, n in before.items()
                          if k.launches != n}
        for k, n in before.items():
            k.launches = n
        self._graph = graph

    def _replay(self, n: int) -> None:
        for _ in range(n):
            self._graph.replay()
        self.replays += n
        for k, per_step in self._captured.items():
            k.launches += per_step * n

    def run(self, prompts: np.ndarray, first: np.ndarray, coins: np.ndarray,
            start_pos: np.ndarray, num_steps: int) -> tuple[np.ndarray, int]:
        """Decode up to ``num_steps`` steps: prompts (B, max_steps + 1)
        right-padded with -1 (row b forces prompts[b, i+1] at step i when it
        is >= 0), first (B,) input tokens, coins (B, max_steps), start_pos
        (B,) positions of step 0. Stops after the block in which every row
        produced BOS. Returns (the output tokens (B, max_steps), BOS past
        each row's stop and past the last step, the steps run)."""
        if not 0 <= num_steps <= self.max_steps:
            raise ValueError(f"num_steps {num_steps} outside 0.."
                             f"{self.max_steps}")

        def load(dst: torch.Tensor, src) -> None:
            dst.copy_(torch.as_tensor(np.asarray(src)).to(dst.dtype)
                      .reshape(dst.shape))

        load(self.prompts, prompts)
        load(self.tokens, first)
        load(self.coins, coins)
        load(self.pos, start_pos)
        self.index.zero_()
        self.active.fill_(True)
        self.done.fill_(False)
        self.out.fill_(BOS)
        ran = 0
        while ran < num_steps:
            n = min(self.block, num_steps - ran)
            if not self.graph:
                for _ in range(n):
                    self._step()
            else:
                if self._graph is None:
                    self._capture()  # its warm-up is this run's first step
                    ran, n = ran + 1, n - 1
                self._replay(n)
            ran += n
            if bool(self.done):  # one read of the device per block
                break
        return self.out.cpu().numpy(), ran
