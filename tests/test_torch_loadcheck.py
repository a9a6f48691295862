"""The port's load tools (tools/loadgen.py, tools/loadcheck.py) against the
repository's top-level ones, on the CPU:

* ``generate_trace`` / ``save_trace`` write the JAX tool's bytes at
  several seeds and both arrival processes, and ``load_trace`` reads them
  back;
* ``drive_engine`` on the port's engine gives the JAX records request by
  request (first-token step, finish step, verdict) and engine counters at
  the sweep's saturating rate;
* a two-rate sweep row equals the JAX tool's and lies in the baseline
  band, whose copy beside the port's tool is byte-equal to
  tools/loadcheck_baseline.json;
* the two-pool sweep is deterministic and disaggregated interactive
  attainment beats colocated (tests/test_disagg.py's cases), with the
  JAX tool's row;
* the budget comparison exits 1 under ``overrun-budget``, the drills
  exit 1 under ``leak-on-cancel``, usage errors exit 2, and ``--device
  cuda`` without a card exits 1 (never a CPU run).
"""

import argparse
import json
import os
import pathlib
import sys

import pytest
import torch

from test_torch_chaos import SPEC, model  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    """The loadcheck defaults (its argparse's), as a namespace."""
    base = dict(sweep=[0.05, 0.1, 0.2, 0.4, 0.8, 1.6], requests=24,
                arrivals="bursty", seed=7, slots=4, page_size=4,
                kv_pages=20, spec_k=0, block_steps=1, step_cost=1.0,
                two_pool_rate=0.25, budget=None, inject=None,
                trace_out=None, json=True, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


# ----------------------------------------------------------------- traces


TRACE_SPECS = [dict(), dict(arrivals="bursty", rate=0.8, n_requests=40),
               dict(shared_prefix_rate=0.5, shared_prefix_len=8,
                    n_shared_prefixes=2, classes=("interactive", "batch"),
                    class_weights=(3, 1), seq_len=32),
               dict(prompt_lens=(4, 6), out_lens=(12, 16),
                    classes=("interactive", "batch"), class_weights=(4, 1),
                    class_prompt_lens=((4, 6), (28,)), arrivals="bursty")]


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("kw", TRACE_SPECS,
                         ids=["default", "bursty", "prefix", "classes"])
def test_traces_are_the_jax_tools_bytes(kw, seed, tmp_path):
    import loadgen as jax_loadgen

    from distributed_llama_tpu_torch.tools import loadgen

    paths = []
    for mod, name in ((jax_loadgen, "jax"), (loadgen, "port")):
        trace = mod.generate_trace(mod.LoadSpec(**kw), seed)
        path = tmp_path / f"{name}.json"
        mod.save_trace(trace, str(path))
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    back = loadgen.load_trace(str(paths[1]))
    assert back.events == loadgen.generate_trace(loadgen.LoadSpec(**kw),
                                                 seed).events


def test_bad_specs_and_files_raise_as_jax(tmp_path):
    import loadgen as jax_loadgen

    from distributed_llama_tpu_torch.tools import loadgen

    for kw in (dict(arrivals="uniform"), dict(rate=0), dict(n_requests=0),
               dict(shared_prefix_rate=0.5),
               dict(classes=("a", "b"), class_prompt_lens=((4,),))):
        with pytest.raises(ValueError) as want:
            jax_loadgen.LoadSpec(**kw)
        with pytest.raises(ValueError) as got:
            loadgen.LoadSpec(**kw)
        assert str(got.value) == str(want.value)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "other"}))
    with pytest.raises(ValueError, match="not a dllama-load-trace"):
        loadgen.load_trace(str(bad))


# ---------------------------------------------------------- drive_engine


def test_drive_engine_gives_the_jax_records(model):
    import loadcheck as jax_loadcheck
    import loadgen as jax_loadgen

    from distributed_llama_tpu_torch.tools import loadcheck, loadgen

    args = _args()
    seen = []
    for lc, lg, make in (
            (jax_loadcheck, jax_loadgen,
             jax_loadcheck.build_engine_factory(args)),
            (loadcheck, loadgen, loadcheck.build_engine_factory(args))):
        trace = lg.generate_trace(lc._load_spec(1.6, args), args.seed)
        res = lg.drive_engine(make(), trace, lc._policy())
        seen.append(([(r.index, r.slo_class, r.v_first, r.v_finish,
                       r.n_sampled, r.tokens_out, r.verdict)
                      for r in res.records], res.to_json()))
    assert seen[1] == seen[0]
    assert any(rec[-1] == "met" for rec in seen[1][0])
    assert len(seen[1][0]) == args.requests


# ------------------------------------------------------------------ sweep


def test_two_rate_sweep_row_is_the_jax_row_and_in_band():
    import loadcheck as jax_loadcheck

    from distributed_llama_tpu_torch.tools import loadcheck

    args = _args(sweep=[0.05, 1.6])
    want = jax_loadcheck.run_sweep(args,
                                   jax_loadcheck.build_engine_factory(args))
    got = loadcheck.run_sweep(args, loadcheck.build_engine_factory(args))
    assert got == want
    failures, doc = loadcheck.check_baseline(got, loadcheck.DEFAULT_BASELINE)
    assert failures == [] and doc is not None
    band = {p["rate"]: p["band"] for p in doc["points"]}
    for row in got:
        lo, hi = band[row["rate"]]
        assert lo <= row["goodput_tps"] <= hi
        assert row["watch"]["verdict"] == "quiet"


def test_baseline_copy_is_byte_equal():
    from distributed_llama_tpu_torch.tools import loadcheck

    assert pathlib.Path(loadcheck.DEFAULT_BASELINE).read_bytes() == \
        (ROOT / "tools" / "loadcheck_baseline.json").read_bytes()


def test_write_baseline_writes_the_band(tmp_path, capsys):
    """The reference tool's --write-baseline writes the band; the port
    has no such knob (its file is a copy) and holds rows to that band,
    pointing at the reference tool when a point is missing or above."""
    import loadcheck as jax_loadcheck

    from distributed_llama_tpu_torch.tools import loadcheck

    rows = [{"rate": 0.5, "goodput_tps": 2.0, "watch": {"verdict": "quiet"}}]
    path = tmp_path / "b.json"
    jax_loadcheck.check_baseline(rows, str(path), write=True)
    assert json.loads(path.read_text())["points"] == [
        {"rate": 0.5, "goodput_tps": 2.0, "band": [1.8, 2.2],
         "watch": "quiet"}]
    failures, doc = loadcheck.check_baseline(rows, str(path))
    assert failures == [] and doc == json.loads(path.read_text())
    rows[0]["goodput_tps"] = 1.0
    failures, _ = loadcheck.check_baseline(rows, str(path))
    assert failures and "below the baseline band" in failures[0]
    rows[0]["goodput_tps"] = 3.0
    assert loadcheck.check_baseline(rows, str(path))[0] == []
    assert "ABOVE band" in capsys.readouterr().err
    failures, _ = loadcheck.check_baseline([dict(rows[0], rate=0.7)],
                                           str(path))
    assert failures and "python tools/loadcheck.py --write-baseline" \
        in failures[0]
    with pytest.raises(SystemExit) as exc:
        loadcheck.main(["--sweep-only", "--write-baseline", "--device",
                        "cpu"])
    assert exc.value.code == 2


# --------------------------------------------------------------- two pools


def test_two_pool_sweep_deterministic_and_disagg_beats_colocated():
    import loadcheck as jax_loadcheck

    from distributed_llama_tpu_torch.tools import loadcheck

    args = _args()
    rows = []
    for _ in range(2):
        row, failures = loadcheck.run_two_pool(
            args, loadcheck.build_engine_factory(args))
        assert failures == []
        rows.append(row)
    assert rows[0] == rows[1]
    att = rows[0]["interactive_attainment"]
    assert att["disagg"] > att["colocated"]
    disagg = rows[0]["disagg"]["engine"]
    assert disagg["pages_adopted"] > 0
    assert disagg["pools"][1]["steps"] > disagg["pools"][0]["steps"]
    want, _ = jax_loadcheck.run_two_pool(
        args, jax_loadcheck.build_engine_factory(args))
    assert rows[0] == want


# ------------------------------------------------------------- exit codes


def _main(argv, capsys):
    from distributed_llama_tpu_torch.tools.loadcheck import main

    rc = main([*argv, "--json"])
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1] if out.out.strip() else None
    return rc, (json.loads(last) if last else None), out.err


def test_budget_gate_exits_1_under_overrun(capsys):
    rc, row, _ = _main(["--budget", "8", "--inject", "overrun-budget",
                        "--sweep-only", "--device", "cpu"], capsys)
    assert rc == 1 and row["gate"]["verdict"] == "RED"
    assert row["budget"]["points"][0]["overrun_steps"] > 0
    assert any("overrun step" in f for f in row["gate"]["failures"])


def test_budget_gate_healthy_exits_0(capsys):
    rc, row, _ = _main(["--budget", "8,12", "--sweep-only", "--device",
                        "cpu"], capsys)
    assert rc == 0 and row["gate"]["verdict"] == "OK"
    assert row["budget"]["best"]["interactive_attainment"] >= 0.90


def test_leak_on_cancel_turns_the_gate_red(capsys):
    rc, row, _ = _main(["--drills-only", "--drills", "disconnect",
                        "--inject", "leak-on-cancel", "--device", "cpu"],
                       capsys)
    assert rc == 1 and row["gate"]["verdict"] == "RED"
    assert row["drills"][0]["name"] == "disconnect"
    assert not row["drills"][0]["passed"]


@pytest.mark.parametrize("argv,msg", [
    (["--sweep", "0.1,x"], "bad --sweep"),
    (["--sweep", "0.1,0.2"], "needs >= 4 load points"),
    (["--sweep-only", "--drills-only"], "exclusive"),
    (["--budget", "1"], "integers >= 2"),
    (["--budget", "a"], "bad --budget"),
    (["--budget", "8", "--spec-k", "4"], "incompatible with --spec-k"),
    (["--drills-only", "--drills", "nope", "--device", "cpu"],
     "unknown drill(s) nope")])
def test_usage_errors_exit_2_as_jax(argv, msg, capsys):
    import loadcheck as jax_loadcheck

    rc, row, err = _main(argv, capsys)
    assert rc == 2 and row is None and msg in err
    assert jax_loadcheck.main([a for a in argv if a not in ("--device",
                                                             "cpu")]) == 2
    assert capsys.readouterr().err == err


def test_no_card_exits_1_without_a_cpu_run(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, row, err = _main(["--drills-only", "--drills", "disconnect"],
                         capsys)
    assert rc == 1 and row is None and "no GPU" in err


def test_the_module_runs_as_a_program(tmp_path):
    import subprocess

    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch.tools.loadcheck",
         "--drills-only", "--drills", "oversized_prompt", "--json",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["kind"] == "loadcheck" and row["gate"]["verdict"] == "OK"
    assert row["env_fingerprint"]["backend"] == "cpu"
