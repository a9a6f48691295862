"""Speculative and token-budget mixed dispatch under tensor parallelism and
through the CLI, on the CPU:

* ``ContinuousEngine(mesh=..., spec_k=4)`` and ``(dispatch_tokens=6)`` at
  tp 2 under the ref, fused and overlap schemes and at tp 4 under fused
  (gloo ranks, ``parallel/tp.TPLlama`` inheriting the window forwards) give
  the tp 1 engine's streams, greedy, over f32 pages; each rank writes only
  its kv heads' window and the logits come back whole;
* every verify and mixed dispatch issues exactly
  ``comm_stats.tp_collective_budget(t_len=B*K)`` (or ``B*T``) collectives
  and bytes;
* ``inference --continuous --kv-page-size 4 --spec-k 4`` and
  ``--dispatch-tokens 8`` (and -1) print the JAX CLI's ``[i] '...'`` rows
  and its summary line, and the exit-2 checks give the JAX CLI's
  messages."""

import pickle
import re

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType
from test_torch_cli import model_files  # noqa: F401  (the fixture model)
from test_torch_tp import _tree, spawn_ranks

SPEC = TransformerSpec(dim=128, hidden_dim=256, n_layers=2, n_heads=8,
                       n_kv_heads=4, vocab_size=96, seq_len=32,
                       weights_float_type=FloatType.Q40)
SLOTS, STEPS, PS = 3, 24, 4
KINDS = {"verify": {"spec_k": 4}, "mixed": {"dispatch_tokens": 6}}
RUNS = {2: ("ref", "fused", "overlap"), 4: ("fused",)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small CPU forwards: under
    xdist, workers whose thread pools oversubscribe the cores ran them
    ~10x slower than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests():
    rng = np.random.default_rng(9)
    phrase = list(rng.integers(3, 90, 3))
    return [[1] + phrase * r + list(rng.integers(3, 90, k))
            for r, k in ((2, 3), (1, 9), (3, 1), (0, 12), (2, 5))]


def _port_tree():
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return _tree(SPEC, Q40Weight)


def _run(kind, group=None, scheme="fused"):
    """The engine's streams and stats, and under a group each window
    dispatch's census and width."""
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel.tp import shard_params
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    params, kw = _port_tree(), {}
    if group is not None:
        params = shard_params(params, group.rank, group.size, scheme)
        kw = dict(mesh=group, scheme=scheme)
    eng = ContinuousEngine(SPEC, params, SLOTS, 0.0, 0.9, 1,
                           prefill_chunk=4, page_size=PS, kv_pages=20,
                           device="cpu", **KINDS[kind], **kw)
    census = []
    step = eng._window_step

    def counted(k, w):
        C.CENSUS.reset()
        step(k, w)
        census.append((w.tokens.numel(), {
            kind: tuple(v) for kind, v in C.CENSUS.counts.items()}))

    eng._window_step = counted
    outs, st = eng.run(_requests(), STEPS)
    return outs, (st.steps, st.spec_accepted), census


def _rank_main(rank, world, port, out):
    from distributed_llama_tpu_torch.parallel.mesh import close, init_rank

    g = init_rank(rank, world, f"tcp://localhost:{port}", "cpu")
    res = {}
    with torch.inference_mode():
        for scheme in RUNS[world]:
            for kind in KINDS:
                res[(scheme, kind)] = _run(kind, g, scheme)
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)
    close(g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_tp")
    return {w: spawn_ranks(_rank_main, w, d / f"tp{w}.pkl") for w in RUNS}


@pytest.fixture(scope="module")
def tp1():
    with torch.inference_mode():
        return {kind: _run(kind) for kind in KINDS}


CASES = [(w, s, k) for w, schemes in RUNS.items() for s in schemes
         for k in KINDS]


@pytest.mark.parametrize("world,scheme,kind", CASES,
                         ids=[f"tp{w}-{s}-{k}" for w, s, k in CASES])
def test_streams_equal_tp1(ranks, tp1, world, scheme, kind):
    outs, stats, census = ranks[world][(scheme, kind)]
    want, want_stats, _ = tp1[kind]
    assert outs == want and stats == want_stats
    assert any(len(r) > 12 for r in outs)
    if kind == "verify":
        assert stats[1] > 0  # drafts accepted


@pytest.mark.parametrize("world,scheme,kind", CASES,
                         ids=[f"tp{w}-{s}-{k}" for w, s, k in CASES])
def test_census_per_dispatch_equals_budget(ranks, world, scheme, kind):
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        tp_collective_budget

    _, (steps, _), census = ranks[world][(scheme, kind)]
    assert len(census) == steps
    for rows, got in census:
        want = tp_collective_budget(SPEC, world, scheme, t_len=rows)
        assert got == {k: (c, b) for k, c, b in want.entries}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def prompts(tmp_path):
    path = tmp_path / "p.txt"
    path.write_text("hi hi hi hi hi hi hi hi hi\nhi\nhi hi hi hi hi hi\n"
                    "hi hi hi\n\nhi hi hi hi hi hi hi hi hi hi hi\n")
    return str(path)


CLI_FLAGS = {"spec-k": ["--spec-k", "4"],
             "spec-k-ngram": ["--spec-k", "3", "--spec-ngram", "2"],
             "dispatch-tokens": ["--dispatch-tokens", "8"],
             "dispatch-auto": ["--dispatch-tokens", "-1", "--prefill-chunk",
                               "4"]}
SUMMARY = {"spec-k": "Speculative:", "spec-k-ngram": "Speculative:",
           "dispatch-tokens": "Token budget:",
           "dispatch-auto": "Token budget:"}


@pytest.mark.parametrize("flags", sorted(CLI_FLAGS))
@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_cli_rows_equal_jax(model_files, prompts, capsys,  # noqa: F811
                            monkeypatch, flags, temperature):
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    monkeypatch.setenv("DLLAMA_KV_QUANT", "")
    model, tokp = model_files
    base = ["inference", "--model", model, "--tokenizer", tokp,
            "--prompts-file", prompts, "--steps", "28", "--temperature",
            temperature, "--seed", "3", "--continuous", "--slots", "2",
            "--kv-page-size", "4", *CLI_FLAGS[flags]]

    def lines(out):
        rows = re.findall(r"^\[\d+\] (?!done:).*$", out, re.M)
        summary = [re.sub(r"[\d.]+ ms/accepted", "ms/accepted", ln)
                   for ln in out.splitlines()
                   if ln.startswith(SUMMARY[flags])]
        return rows, summary

    assert ref_main(base + ["--tp", "1"]) == 0
    want = lines(capsys.readouterr().out)
    assert main(base + ["--device", "cpu"]) == 0
    got = lines(capsys.readouterr().out)
    assert got == want
    assert len(want[0]) == 5 and len(want[1]) == 1


@pytest.mark.parametrize("flags,message", [
    (["--spec-k", "4"], "--spec-k needs the paged KV cache: add "
     "--kv-page-size P (with --continuous)"),
    (["--spec-k", "4", "--kv-page-size", "4", "--dispatch-tokens", "8"],
     "--spec-k is incompatible with --dispatch-tokens: the verify window "
     "and the prefill slice both claim the per-row span (drop one)"),
    (["--dispatch-tokens", "8"], "--dispatch-tokens needs the paged KV "
     "cache: add --kv-page-size P (with --continuous)"),
    (["--dispatch-tokens", "-1", "--kv-quant", "q8"], "--dispatch-tokens "
     "needs the paged KV cache: add --kv-page-size P (with --continuous)")],
    ids=["spec-no-pages", "spec-and-budget", "budget-no-pages",
         "auto-budget-no-pages"])
def test_cli_exit_2_checks_match_jax(flags, message, capsys, tmp_path,
                                     monkeypatch):
    """Before any load (the model path does not exist): the JAX CLI's exit
    code and message, and the port's."""
    from distributed_llama_tpu.frontend.cli import main as ref_main
    from distributed_llama_tpu_torch.frontend.cli import main

    # the JAX CLI writes --kv-quant into DLLAMA_KV_QUANT: restore it after
    monkeypatch.setenv("DLLAMA_KV_QUANT", "")
    p = tmp_path / "p.txt"
    p.write_text("hi\n")
    argv = ["inference", "--model", str(tmp_path / "absent.bin"),
            "--tokenizer", str(tmp_path / "absent.tok"), "--prompts-file",
            str(p), "--continuous", *flags]
    assert ref_main(argv) == 2
    want = capsys.readouterr().err.strip()
    assert main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip() == want == message
