"""The port's tools/watchcheck.py and tools/fleetcheck.py against the
top-level tools on the same seeds: watchcheck's detection matrix and
fleetcheck --sim's rows and rollup equal the JAX tools' rows (the
fingerprint aside), the inject arms exit exactly 1, and a live scrape of
nothing fails the gate."""

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


def _no_fingerprint(row):
    return {k: v for k, v in row.items() if k != "env_fingerprint"}


@pytest.mark.parametrize("seed", [7, 3])
def test_watchcheck_matrix_equals_the_jax_tool(seed):
    import watchcheck as jax_watchcheck

    from distributed_llama_tpu_torch.tools import watchcheck

    rc, got, err = _row(watchcheck.main, ["--seed", str(seed), "--device",
                                          "cpu"])
    rc_j, want, _ = _row(jax_watchcheck.main, ["--seed", str(seed)])
    assert rc == rc_j == 0 and got["gate"]["ok"]
    assert _no_fingerprint(got) == _no_fingerprint(want)
    assert [s["expect"] for s in got["scenarios"]] == [
        None, "page_leak", "stall_shift", "recovery_storm", "handoff_spike"]
    assert "[watchcheck] ok  healthy" in err


@pytest.mark.parametrize("arm", ["mute-detector", "jitter-thresholds"])
def test_watchcheck_inject_arms_exit_exactly_1(arm):
    from distributed_llama_tpu_torch.tools import watchcheck

    rc, row, _ = _row(watchcheck.main, ["--inject", arm, "--device", "cpu"])
    assert rc == 1 and row["gate"]["failures"]


@pytest.mark.parametrize("argv", [["--sim", "4"],
                                  ["--sim", "2", "--seed", "5", "--rate",
                                   "0.8", "--requests", "20"]],
                         ids=["sim4", "sim2-seed5"])
def test_fleetcheck_sim_row_equals_the_jax_tool(argv):
    import fleetcheck as jax_fleetcheck

    from distributed_llama_tpu_torch.tools import fleetcheck

    rc, got, _ = _row(fleetcheck.main, [*argv, "--json", "--device", "cpu"])
    rc_j, want, _ = _row(jax_fleetcheck.main, [*argv, "--json"])
    assert rc == rc_j == 0 and got["gate"]["verdict"] == "OK"
    assert _no_fingerprint(got) == _no_fingerprint(want)
    assert got["rollup"]["replicas"] == int(argv[1])


def test_fleetcheck_scrape_and_usage():
    from distributed_llama_tpu_torch.tools import fleetcheck

    rc, row, _ = _row(fleetcheck.main, ["--replicas", "http://127.0.0.1:9",
                                        "--timeout", "0.5", "--json"])
    assert rc == 1 and row["rows"][0]["healthy"] is False
    assert _row(fleetcheck.main, [])[0] == 2
    assert _row(fleetcheck.main, ["--sim", "2", "--replicas", "x"])[0] == 2
