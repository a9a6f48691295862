"""Program-structure contracts of the port (the counterpart of the JAX
package's analysis/jaxpr_contracts.py: the port has no jaxpr, so each
contract runs the real entry point on a small model, on the CPU or on the
card, and watches what it does).

  J001  one decode forward of ``parallel/tp.TPLlama`` over a simulated
        group (``mesh.LOCAL_SIM``, parallel/shard_sim.py) issues exactly
        the collectives of ``comm_stats.tp_collective_budget``, by kind,
        count and bytes (``collectives.CENSUS``), per scheme at tp 2 and 4;
        a kind the budget has no term for fails;
  J002  a decode step writes both KV planes in place: their storage
        pointers are unchanged across steps and no tensor of a plane's
        size is made by a step (a TorchDispatchMode watches every op's
        fresh outputs), for the contiguous cache (``Llama.forward``, the
        host loop) and the paged pool (``forward_batch_paged``, the
        continuous engine's step);
  J003  the captured decode step (``runtime/decode.DecodeLoop``) is
        shape-stable: its static inputs and outputs keep their shapes,
        dtypes and storage pointers across positions, which is what a
        CUDA graph replay needs (on the card the step is captured; on
        the CPU it runs eagerly over the same buffers).
"""

from __future__ import annotations

import dataclasses

SCHEMES_TP = ((2, "ref"), (2, "fused"), (2, "overlap"),
              (4, "ref"), (4, "fused"), (4, "overlap"))


@dataclasses.dataclass(frozen=True)
class ContractResult:
    contract: str  # J00x
    name: str
    ok: bool
    detail: str
    hint: str = ""


def contract_spec():
    """The small Q40 shape the contracts run: every band of tp 2 and 4 on
    32-value block boundaries (hidden 768 / 4 = 192), two layers."""
    from ..models.synth import small_bench_spec

    return small_bench_spec(dim=256, hidden_dim=768, n_layers=2, n_heads=8,
                            n_kv_heads=4, vocab_size=512, seq_len=64)


def _device(device):
    import torch

    return torch.device(device)


# -- J001 --------------------------------------------------------------------


def census_of_forward(spec, tp: int, scheme: str, device="cpu",
                      seed: int = 0) -> dict:
    """kind -> (count, bytes) of one T = 1 decode forward of a simulated
    tp rank (shard_sim.make_rank_forward over synth_rank_q40's bands)."""
    import torch

    from ..parallel import collectives as C
    from ..parallel import shard_sim

    params = shard_sim.synth_rank_q40(spec, tp, seed=seed, scheme=scheme,
                                      device=device)
    cache = shard_sim.init_rank_cache(spec, tp, device)
    fwd = shard_sim.make_rank_forward(spec, tp, params, scheme)
    C.CENSUS.reset()
    with torch.inference_mode():
        logits = fwd.forward(cache, 1, 0)
    if tuple(logits.shape) != (1, spec.vocab_size):
        raise AssertionError(f"logits {tuple(logits.shape)}")
    census = {k: (c, b) for k, (c, b) in C.CENSUS.counts.items()}
    C.CENSUS.reset()
    return census


def contract_tp_collectives(spec=None, tp: int = 4, scheme: str = "fused",
                            device="cpu", census=None) -> ContractResult:
    """J001 for one (tp, scheme): the census of one decode forward equals
    the budget's entries. ``census`` overrides the measured census
    (mutation self-tests)."""
    from ..parallel.comm_stats import tp_collective_budget

    spec = spec or contract_spec()
    name = f"tp_collectives[tp{tp},{scheme}]"
    hint = ("a collective added, removed or widened must land together "
            "with its parallel/comm_stats.py term (tp_collective_budget)")
    got = census if census is not None else census_of_forward(
        spec, tp, scheme, device)
    budget = tp_collective_budget(spec, tp, scheme)
    want = {k: (c, b) for k, c, b in budget.entries}
    unmodeled = sorted(set(got) - set(want))
    if unmodeled:
        return ContractResult(
            "J001", name, False,
            f"collective kind(s) {unmodeled} in the tp forward have no "
            f"comm_stats term for scheme {scheme!r}", hint)
    if got != want:
        return ContractResult(
            "J001", name, False,
            f"census {got} != budget {want}", hint)
    n = sum(c for c, _ in got.values())
    return ContractResult(
        "J001", name, True,
        f"{n} collectives {dict((k, c) for k, (c, _) in got.items())}, "
        f"{budget.moved_bytes} B a rank a token: the budget", hint)


# -- J002 --------------------------------------------------------------------


def _plane_allocs(planes):
    """A TorchDispatchMode that records every fresh op output (not a
    view, sharing no input's storage) with as many elements as one of
    ``planes``: a copy or rebuild of a cache plane."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    sizes = {p.numel() for p in planes}

    class Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hits: list[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {a.untyped_storage().data_ptr()
                   for a in (*args, *(kwargs or {}).values())
                   if isinstance(a, torch.Tensor)}
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(o, torch.Tensor) and not o._is_view()
                        and o.numel() in sizes
                        and o.untyped_storage().data_ptr() not in ins):
                    self.hits.append(f"{func} -> {tuple(o.shape)} "
                                     f"{o.dtype}")
            return out

    return Mode()


def _ptrs(cache) -> tuple:
    return tuple(p.untyped_storage().data_ptr() for p in cache)


def default_contiguous_step(model, cache, token: int, pos: int):
    return model.forward(cache, token, pos)


def contract_decode_in_place(spec=None, device="cpu", steps: int = 3,
                             step=None) -> ContractResult:
    """J002 over the contiguous cache: ``steps`` host-loop forwards
    (``Llama.forward`` at T = 1) keep both planes' storage and allocate
    no plane-sized tensor. ``step(model, cache, token, pos)`` overrides
    the step (mutation self-tests)."""
    import torch

    from ..models.llama import Llama, init_cache
    from ..parallel import shard_sim

    spec = spec or contract_spec()
    step = step or default_contiguous_step
    name = "decode_kv_in_place"
    hint = ("write the new k/v into the cache planes in place (index_copy_/"
            "copy_); a step that rebuilds a plane costs a cache copy a "
            "token and leaves a captured graph reading the old planes")
    params = shard_sim.synth_rank_q40(spec, 1, seed=1, device=device)
    model = Llama(spec, params)
    cache = init_cache(spec, _device(device))
    before = _ptrs(cache)
    mode = _plane_allocs(tuple(cache))
    with torch.inference_mode(), mode:
        for pos in range(steps):
            step(model, cache, 1 + pos, pos)
    if _ptrs(cache) != before:
        return ContractResult("J002", name, False,
                              "a KV plane's storage moved across steps",
                              hint)
    if mode.hits:
        return ContractResult(
            "J002", name, False,
            f"{len(mode.hits)} cache-plane-sized allocation(s) in "
            f"{steps} steps: {mode.hits[:3]}", hint)
    return ContractResult(
        "J002", name, True,
        f"{steps} steps wrote both planes in place, no plane-sized "
        f"allocation", hint)


def contract_decode_in_place_paged(spec=None, device="cpu",
                                   steps: int = 3, slots: int = 2,
                                   page_size: int = 16) -> ContractResult:
    """J002 over the paged pool: ``forward_batch_paged`` (the continuous
    engine's decode step) writes the pool planes in place."""
    import torch

    from ..models.llama import Llama, init_cache_paged
    from ..parallel import shard_sim

    spec = spec or contract_spec()
    name = "decode_kv_in_place_paged"
    hint = ("scatter the new k/v into the page pool in place; a rebuilt "
            "pool costs a pool copy a step")
    dev = _device(device)
    params = shard_sim.synth_rank_q40(spec, 1, seed=1, device=device)
    model = Llama(spec, params)
    max_pages = spec.seq_len // page_size
    pool = init_cache_paged(spec, slots * max_pages + 1, page_size, dev)
    table = (torch.arange(slots * max_pages, dtype=torch.int32,
                          device=dev).reshape(slots, max_pages) + 1)
    before = _ptrs(pool)
    mode = _plane_allocs(tuple(pool))
    with torch.inference_mode(), mode:
        for pos in range(steps):
            tokens = torch.full((slots,), 1 + pos, dtype=torch.int64,
                                device=dev)
            p = torch.full((slots,), pos, dtype=torch.int32, device=dev)
            model.forward_batch_paged(pool, tokens, p, table)
    if _ptrs(pool) != before or mode.hits:
        return ContractResult(
            "J002", name, False,
            f"pool storage moved or {len(mode.hits)} pool-sized "
            f"allocation(s): {mode.hits[:3]}", hint)
    return ContractResult(
        "J002", name, True,
        f"{steps} paged steps ({slots} rows) wrote the pool in place", hint)


# -- J003 --------------------------------------------------------------------

_STATIC = ("tokens", "pos", "index", "active", "done", "prompts", "coins",
           "out")


def _static_state(loop) -> dict:
    return {k: (tuple(getattr(loop, k).shape), getattr(loop, k).dtype,
                getattr(loop, k).untyped_storage().data_ptr())
            for k in _STATIC}


def contract_decode_shape_stability(spec=None, device="cpu",
                                    steps: int = 6, loop_cls=None,
                                    batch: int = 2) -> ContractResult:
    """J003: a DecodeLoop over ``forward_batch`` (the --fast and
    --prompts-file step), run twice from different positions, keeps every
    static buffer's shape, dtype and storage, and its logits keep their
    shape; on the card its step is captured (graph replays), on the CPU
    it runs eagerly. ``loop_cls`` overrides DecodeLoop (mutation
    self-tests)."""
    import numpy as np
    import torch

    from ..models.llama import Llama, init_cache_batch
    from ..parallel import shard_sim
    from ..runtime.decode import DecodeLoop

    spec = spec or contract_spec()
    name = "decode_shape_stability"
    hint = ("the captured step must write its static buffers in place "
            "(copy_/fill_/scatter_) and keep their shapes: a rebound or "
            "reshaped buffer leaves the graph replaying over old storage")
    dev = _device(device)
    params = shard_sim.synth_rank_q40(spec, 1, seed=2, device=device)
    model = Llama(spec, params)
    cache = init_cache_batch(spec, batch, dev)

    def step(tokens, pos):
        return model.forward_batch(cache, tokens, pos)

    cls = loop_cls or DecodeLoop
    loop = cls(step, batch, steps, 0.0, 0.9, dev)
    before = _static_state(loop)
    prompts = np.full((batch, steps + 1), -1, np.int64)
    coins = np.zeros((batch, steps), np.float32)
    shapes = []
    with torch.inference_mode():
        for start in (0, 17):
            loop.run(prompts, np.ones(batch, np.int64), coins,
                     np.full(batch, start, np.int32), steps)
            shapes.append(None if loop.logits is None
                          else tuple(loop.logits.shape))
    after = _static_state(loop)
    moved = sorted(k for k in _STATIC if before[k] != after[k])
    if moved:
        return ContractResult(
            "J003", name, False,
            f"static buffer(s) {moved} changed shape, dtype or storage "
            f"across runs", hint)
    if shapes != [(batch, spec.vocab_size)] * 2:
        return ContractResult("J003", name, False,
                              f"logits shapes {shapes}", hint)
    return ContractResult(
        "J003", name, True,
        f"{len(_STATIC)} static buffers kept shape and storage over "
        f"2 x {steps} steps from positions 0 and 17 "
        f"({'captured' if loop.graph else 'eager'})", hint)


def run_contracts(device="cpu", spec=None) -> list[ContractResult]:
    """Every contract on ``device``; a contract that raises is a failed
    result under its id, not a crash."""
    jobs = [("J001", f"tp_collectives[tp{tp},{s}]",
             lambda tp=tp, s=s: contract_tp_collectives(spec, tp, s, device))
            for tp, s in SCHEMES_TP]
    jobs += [("J002", "decode_kv_in_place",
              lambda: contract_decode_in_place(spec, device)),
             ("J002", "decode_kv_in_place_paged",
              lambda: contract_decode_in_place_paged(spec, device)),
             ("J003", "decode_shape_stability",
              lambda: contract_decode_shape_stability(spec, device))]
    results = []
    for cid, name, fn in jobs:
        try:
            results.append(fn())
        except Exception as e:  # noqa: BLE001 - report, don't crash the CLI
            results.append(ContractResult(
                cid, name, False, f"raised {type(e).__name__}: {e}",
                "the contract could not run: fix the error first"))
    return results
