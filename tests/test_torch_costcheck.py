"""The port's tools/costcheck.py against the top-level tool on the same
seeds: each leg's books and the grand totals equal the JAX tool's row
(the wall-clock float columns and the fingerprint aside: the integer
step units are what the gate conserves), both inject arms exit exactly
1, and every engine-building gate of the port exits 1 when asked for the
card without one (never carrying on on the CPU)."""

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


def _row(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def int_view(obj):
    """A row without its wall-clock floats and its fingerprint."""
    if isinstance(obj, dict):
        return {k: int_view(v) for k, v in obj.items()
                if k != "env_fingerprint" and not isinstance(v, float)}
    if isinstance(obj, list):
        return [int_view(v) for v in obj if not isinstance(v, float)]
    return obj


@pytest.mark.parametrize("argv", [[], ["--seed", "3", "--requests", "16",
                                       "--slots", "3", "--block-steps", "1"]],
                         ids=["default", "seed3"])
def test_every_leg_equals_the_jax_tool(argv):
    import costcheck as jax_costcheck

    from distributed_llama_tpu_torch.tools import costcheck

    rc, got, _ = _row(costcheck.main, [*argv, "--json", "--device", "cpu"])
    rc_j, want, _ = _row(jax_costcheck.main, [*argv, "--json"])
    assert rc == rc_j == 0
    assert got["gate"] == {"verdict": "OK", "failures": []}
    assert set(got["legs"]) == set(costcheck.LEGS)
    assert int_view(got) == int_view(want)
    assert got["totals"]["requests"] == got["config"]["requests"]


@pytest.mark.parametrize("arm", ["double-count-dispatch", "leak-ledger"])
def test_inject_arms_exit_exactly_1(arm):
    from distributed_llama_tpu_torch.tools import costcheck

    rc, row, err = _row(costcheck.main, ["--legs", "healthy", "--inject",
                                         arm, "--device", "cpu"])
    assert rc == 1 and row["gate"]["verdict"] == "RED"
    assert row["legs"]["healthy"]["failures"]
    assert "costcheck:" in err


def test_usage_errors_exit_2():
    from distributed_llama_tpu_torch.tools import costcheck

    assert _row(costcheck.main, ["--legs", "nope", "--device", "cpu"])[0] == 2
    assert _row(costcheck.main, ["--legs", "spec", "--inject",
                                 "leak-ledger", "--device", "cpu"])[0] == 2


TOOLS = {"costcheck": [], "watchcheck": [], "racecheck": [],
         "fleetcheck": ["--sim", "2"], "tracejoin": ["--drill"],
         "loadcheck": ["--sweep-only"]}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_asked_for_the_card_without_one_exits_1(tool, monkeypatch):
    import importlib

    main = importlib.import_module(
        f"distributed_llama_tpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, row, err = _row(main, [*TOOLS[tool], "--device", "cuda"])
    assert rc == 1 and row is None
    assert "no GPU" in err and "--device cpu" in err
