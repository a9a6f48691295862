"""The port's tools/racecheck.py against the top-level tool: for a seed
the schedule set of every seam (its op counts, mode, interleavings and
digest) equals the JAX tool's, and the oracles hold over those schedules
on the port's own seams (PagedAllocator adoption, the PageUploader
thread against the settle loop, ContinuousEngine.ingest_remote against
its scheduler, LedgerBook against its readers); each mutation arm exits
exactly 1."""

import io
import json
import pathlib
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedules(row):
    return {name: {k: r[k] for k in ("ops", "interleavings", "mode",
                                     "digest")}
            for name, r in row["seams"].items()}


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_schedule_sets_equal_the_jax_tool(seed):
    import racecheck as jax_racecheck

    from distributed_llama_tpu_torch.tools import racecheck

    got = racecheck.run(seed=seed, target=40, cap=40, device="cpu")
    want = jax_racecheck.run(seed=seed, target=40, cap=40)
    assert _schedules(got) == _schedules(want)
    assert got["ok"] and want["ok"], got
    assert sorted(got["seams"]) == sorted(racecheck.SEAM_NAMES)
    for name, r in got["seams"].items():
        assert r["failures"] == 0 and r["explored"] == min(
            40, r["interleavings"]), name
    for counts in ((3, 2), (3, 3, 3)):
        assert racecheck.sampled_schedules(counts, 30, seed) == \
            jax_racecheck.sampled_schedules(counts, 30, seed)
        assert list(racecheck.exhaustive_schedules(counts)) == \
            list(jax_racecheck.exhaustive_schedules(counts))


def test_the_default_gate_is_green_and_its_row_is_the_jax_row(capsys):
    import racecheck as jax_racecheck

    from distributed_llama_tpu_torch.tools import racecheck

    with redirect_stderr(io.StringIO()):
        assert racecheck.main(["--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert jax_racecheck.main([]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want


@pytest.mark.parametrize("arm,seam,problem", [
    ("drop-a-lock", "pool_adopt", "page"),
    ("reorder-inbox", "ingest_sweep", "FIFO")])
def test_mutation_arms_exit_exactly_1(arm, seam, problem):
    """Each arm turns its seam red on the same schedules, with the same
    problems, as the JAX tool's."""
    import racecheck as jax_racecheck

    from distributed_llama_tpu_torch.tools import racecheck

    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = racecheck.main(["--inject", arm, "--seam", seam, "--device",
                             "cpu"])
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 1 and not row["ok"]
    blob = " ".join(p for f in row["seams"][seam]["first_failures"]
                    for p in f["problems"])
    assert problem in blob, blob
    want = jax_racecheck.run(seed=0, seams=[seam], inject=arm)
    assert row["seams"][seam] == want["seams"][seam]


def test_usage_and_listing(capsys):
    from distributed_llama_tpu_torch.tools import racecheck

    assert racecheck.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(racecheck.SEAM_NAMES)
    assert racecheck.main(["--cap", "-1", "--device", "cpu"]) == 2
