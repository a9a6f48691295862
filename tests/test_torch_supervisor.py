"""The port's supervisor (runtime/supervisor.py) against the JAX
package's, the same calls on both: the health state machine's
transitions and gauge, the step watchdog's trips, the crash-loop
backoff's delays, ``supervise`` over a real tiny child process (restarts
until a clean exit, the restart budget, a flight-recorder bundle per
respawn) and ``serve_child_cmd`` re-executing the port's own package."""

import importlib
import json
import sys
import time

import pytest


def _both(module="runtime.supervisor"):
    return (importlib.import_module(f"distributed_llama_tpu.{module}"),
            importlib.import_module(f"distributed_llama_tpu_torch.{module}"))


def _health_walk(sup, metrics):
    reg = metrics.Registry()
    h = sup.HealthMonitor(reg)
    seen = [h.state]
    for state in ("serving", "serving", "degraded", "serving", "draining",
                  "stopped"):
        seen.append((state, h.to(state), h.state))
    for bad in ("serving", "bogus"):
        try:
            h.to(bad)
            seen.append(("no raise", bad))
        except ValueError as e:
            seen.append(("raise", bad, str(e)))
    seen.append(reg.expose())
    return seen


def test_health_monitor_walks_as_jax():
    (js, ps), (jm, pm) = _both(), _both("obs.metrics")
    assert _health_walk(ps, pm) == _health_walk(js, jm)


def _watchdog_walk(sup):
    hangs = []
    wd = sup.StepWatchdog(0.05, on_hang=hangs.append)
    with wd:
        time.sleep(0.25)  # one overrun: one trip, however long
        overdue = wd.overdue
    with wd:
        pass  # a dispatch on time: no trip
    wd.close()
    try:
        sup.StepWatchdog(0)
        bad = None
    except ValueError as e:
        bad = str(e)
    return wd.trips, len(hangs), overdue, wd.overdue, bad


def test_step_watchdog_trips_as_jax():
    js, ps = _both()
    got = _watchdog_walk(ps)
    assert got == _watchdog_walk(js)
    assert got[:3] == (1, 1, True)


def test_crash_loop_backoff_as_jax():
    js, ps = _both()
    delays = []
    for sup in (js, ps):
        b = sup.CrashLoopBackoff(initial_s=0.5, max_s=3.0, healthy_s=10.0)
        delays.append([b.next_delay(u) for u in (1, 1, 1, 1, 1, 30, 2)])
    assert delays[1] == delays[0] == [0.5, 1.0, 2.0, 3.0, 3.0, 0.5, 1.0]


def _child(tmp_path, fails):
    """A tiny child that exits 3 its first ``fails`` runs, then 0."""
    count = tmp_path / "runs"
    script = tmp_path / "child.py"
    script.write_text(
        "import pathlib, sys\n"
        f"p = pathlib.Path({str(count)!r})\n"
        "n = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(n + 1))\n"
        f"sys.exit(3 if n < {fails} else 0)\n")
    return [sys.executable, str(script)], count


@pytest.mark.parametrize("fails,budget,rc,runs",
                         [(2, None, 0, 3), (5, 1, 3, 2)],
                         ids=["until-clean", "budget"])
def test_supervise_a_child_as_jax(tmp_path, fails, budget, rc, runs):
    js, ps = _both()
    got = []
    for name, sup in (("jax", js), ("port", ps)):
        d = tmp_path / name
        d.mkdir()
        cmd, count = _child(d, fails)
        code = sup.supervise(cmd, max_restarts=budget,
                             backoff=sup.CrashLoopBackoff(initial_s=0.01),
                             install_signals=False,
                             flightrec_dir=str(d / "rec"))
        bundles = sorted((d / "rec").glob("*.json")) \
            if (d / "rec").exists() else []
        got.append((code, int(count.read_text()), len(bundles)))
        for b in bundles:  # each respawn's bundle validates in JAX
            from distributed_llama_tpu.obs.flightrec import validate_bundle

            validate_bundle(json.loads(b.read_text()))
    assert got[1] == got[0]
    crashes = runs - (rc == 0)  # a bundle for each crash
    assert got[1] == (rc, runs, crashes)


def test_serve_child_cmd_re_executes_the_port():
    js, ps = _both()
    argv = ["--model", "m.bin", "--supervise", "--max-restarts", "3",
            "--journal", "j.wal", "--max-restarts=5", "--port", "0"]
    got, want = ps.serve_child_cmd(argv), js.serve_child_cmd(argv)
    assert got[:4] == [sys.executable, "-m", "distributed_llama_tpu_torch",
                       "serve"]
    assert got[4:] == want[4:] == ["--model", "m.bin", "--journal",
                                   "j.wal", "--port", "0"]
