"""The port's tools/tracejoin.py (the top-level tool's stitching, orphan
refusal and drill): the --drill over the port's DisaggPair on the TCP
page channel joins both pools' spans with no orphan and writes a valid
flight-recorder bundle through StepWatchdog; --inject drop-traceparent
exits exactly 1; two exports stitch as the JAX tool stitches them."""

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


def _run(argv):
    from distributed_llama_tpu_torch.tools import tracejoin

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = tracejoin.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_drill_joins_clean_and_writes_a_bundle(tmp_path):
    from distributed_llama_tpu_torch.obs.flightrec import load_bundle
    from distributed_llama_tpu_torch.obs.spans import validate_chrome_trace

    chrome, bundle = tmp_path / "joined.json", tmp_path / "bundle.json"
    rc, out, err = _run(["--drill", "--device", "cpu", "--chrome-out",
                         str(chrome), "--flightrec-out", str(bundle),
                         "--json"])
    verdict = json.loads(out.strip().splitlines()[-1])
    assert rc == 0, err
    assert verdict == {"verdict": "OK", "failures": [],
                       "dropped_traceparents": 0}
    doc = json.loads(chrome.read_text())
    validate_chrome_trace(doc)
    assert {e["pid"] for e in doc["traceEvents"]} == {1, 2}
    b = load_bundle(str(bundle))
    assert b["reason"] == "watchdog" and b["spans"] and b["journal_tail"]


def test_drop_traceparent_exits_exactly_1():
    rc, out, err = _run(["--drill", "--device", "cpu", "--inject",
                         "drop-traceparent"])
    assert rc == 1
    assert "orphan" in err and "RED" in out


def _spans(tracer):
    return [json.loads(ln) for ln in tracer.export_ndjson().splitlines()
            if ln.strip()]


def test_stitching_equals_the_jax_tool(tmp_path):
    """Two hand-made exports with a send/recv pair on other clocks: the
    port's report and Chrome trace are the JAX tool's; without the recv's
    parent the pair is an orphan and the join exits 1."""
    import tracejoin as jax_tracejoin

    from distributed_llama_tpu_torch.tools import tracejoin

    send = {"span": "handoff", "cat": "handoff", "t_start_s": 10.0,
            "dur_ms": 40.0, "trace_id": "t1", "span_id": "s1", "tid": 1}
    recv = {"span": "prefill_handoff", "cat": "handoff", "t_start_s": 500.0,
            "dur_ms": 20.0, "trace_id": "t1", "span_id": "r1",
            "parent_span_id": "s1", "tid": 2}
    step = {"span": "step", "cat": "decode", "t_start_s": 10.1,
            "dur_ms": 5.0, "trace_id": "t1", "span_id": "d1", "tid": 1}
    a, b = [send, step], [recv]
    assert tracejoin.join_pools(a, b, "decode", "prefill") == \
        jax_tracejoin.join_pools(a, b, "decode", "prefill")
    pa, pb = tmp_path / "a.ndjson", tmp_path / "b.ndjson"
    pa.write_text("\n".join(json.dumps(s) for s in a) + "\n")
    pb.write_text(json.dumps(recv) + "\n" + json.dumps(
        {"span": "_meta", "dropped": 2}) + "\n")
    rc, out, err = _run([str(pa), str(pb), "--json"])
    report = json.loads(out)
    assert rc == 0 and report["ok"] and report["pairs"] == 1
    assert report["ring_dropped"] == {"pool-a": 0, "pool-b": 2}
    assert report["offset_s"] == pytest.approx(-489.99)
    pb.write_text(json.dumps(dict(recv, parent_span_id="gone")) + "\n")
    rc, out, err = _run([str(pa), str(pb)])
    assert rc == 1 and "ORPHAN" in err


def test_usage_errors_exit_2(tmp_path):
    assert _run([])[0] == 2
    assert _run(["--inject", "drop-traceparent"])[0] == 2
    assert _run(["--drill", str(tmp_path / "x.ndjson")])[0] == 2
    bad = tmp_path / "bad.ndjson"
    bad.write_text("not json\n")
    assert _run([str(bad), str(bad)])[0] == 2
