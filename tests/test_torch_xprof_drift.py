"""obs/xprof.py, obs/drift.py and tools/tracecheck.py of the port against
the JAX package's on the same captures:

* the Attribution of each of the ten dllama-trace/1 fixtures in
  tests/fixtures/traces/ equals the JAX one, field for field;
* ``reconcile`` gives the JAX verdict table on each, with the JAX link
  constants passed in;
* the port's make_trace_fixture rebuilds every fixture at those
  constants;
* the port's own Chrome traces: a kernel is attributed through its
  launch's correlation id (a CUDA graph's replays land in unattributed),
  CPU ops by time on their thread, the tp:: spans are the collectives
  (gloo: the time check SKIPs), the forwards are counted from the embed
  spans, and a prefill that skipped the logits takes one all_gather off
  the exact count;
* a one-device ``inference --profile`` run on the CPU reconciles OK with
  coverage >= COVERAGE_MIN; flight-recorder bundles validate.
"""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch
from test_torch_tp_cli import ROOT, model_files  # noqa: F401

from distributed_llama_tpu_torch.obs import drift as pdrift
from distributed_llama_tpu_torch.obs import xprof as pxprof
from distributed_llama_tpu_torch.tools import tracecheck

FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                         "traces", "*.json")))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_constants():
    from distributed_llama_tpu.parallel import shard_sim

    return dict(gbps=shard_sim.V5E_ICI_GBPS_PER_DIRECTION,
                latency_us=shard_sim.ICI_COLLECTIVE_LATENCY_US)


def _view(att):
    return (att.tokens, att.total_ms, att.phase_ms, att.config, att.source,
            att.counts_exact, att.coverage, att.phase_ms_per_token(),
            {k: (m.kind, m.count, m.ms, m.bytes, m.overlap_ms,
                 m.overlap_fraction) for k, m in att.collectives.items()})


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_fixture_attribution_equals_jax(path):
    from distributed_llama_tpu.obs import xprof

    assert len(FIXTURES) == 10
    assert _view(pxprof.load_capture(path)) == _view(xprof.load_capture(path))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_reconcile_gives_the_jax_verdicts(path):
    from distributed_llama_tpu.obs import drift, xprof

    att_j = xprof.load_capture(path)
    cfg = att_j.config
    spec_j, _ = drift.spec_for(cfg["model"], cfg.get("buffer", "f32"))
    spec_p, label = pdrift.spec_for(cfg["model"], cfg.get("buffer", "f32"))
    want = drift.reconcile(att_j, spec_j, cfg["tp"], cfg["scheme"])
    got = pdrift.reconcile(pxprof.load_capture(path), spec_p, cfg["tp"],
                           cfg["scheme"], **_jax_constants())
    assert got.to_json() == want.to_json()
    assert got.render() == want.render()
    assert label == f"{cfg['model']}/{cfg.get('buffer', 'f32')}"


def test_make_trace_fixture_rebuilds_the_checked_in_set(tmp_path):
    """At the JAX link constants the port's build_fixture gives every fixture
    (its note aside); --write-all DIR writes the set into DIR."""
    from distributed_llama_tpu_torch.tools import make_trace_fixture as mk

    for name, kw in mk.CHECKED_IN:
        with open(os.path.join(ROOT, "tests", "fixtures", "traces",
                               name)) as fh:
            want = json.load(fh)
        got = mk.build_fixture(**kw, **_jax_constants())
        want.pop("note")
        got.pop("note")
        assert got == want, name
    assert mk.main(["--write-all", str(tmp_path)]) == 0
    assert sorted(os.listdir(tmp_path)) == sorted(n for n, _ in
                                                  mk.CHECKED_IN)


def test_tracecheck_exit_codes_on_fixtures(capsys):
    """The gate at the card's constants: the healthy fixtures pass, each
    mutated one is DRIFT (exit 1), a usage error exits 2."""
    for path in FIXTURES:
        mutated = any(m in path for m in ("extra_collective", "inflate",
                                          "unattributed", "serialized"))
        assert tracecheck.main([path, "--json"]) == (1 if mutated else 0)
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["ok"] is not mutated
    assert tracecheck.main([os.path.join(ROOT, "README.md")]) == 2


def _ev(name, ts, dur, cat, tid=1, pid=7, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
          "ts": ts, "dur": dur}
    if args:
        ev["args"] = args
    return ev


def _write(tmp_path, events):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_chrome_kernels_attributed_through_their_launches(tmp_path):
    """Each kernel's phase is the span around the runtime call with its
    correlation id; a graph replay (cudaGraphLaunch outside every span)
    stays unattributed; an NCCL kernel is a collective."""
    host = [_ev("embed", 0, 10, "user_annotation"),
            _ev("attn", 10, 30, "user_annotation"),
            _ev("ffn", 40, 30, "user_annotation"),
            _ev("logits", 70, 10, "user_annotation"),
            _ev("cudaLaunchKernel", 2, 1, "cuda_runtime", correlation=1),
            _ev("cudaLaunchKernel", 12, 1, "cuda_runtime", correlation=2),
            _ev("cudaLaunchKernel", 15, 1, "cuda_runtime", correlation=3),
            _ev("cudaLaunchKernel", 45, 1, "cuda_runtime", correlation=4),
            _ev("cudaLaunchKernel", 72, 1, "cuda_runtime", correlation=5),
            _ev("cudaGraphLaunch", 90, 2, "cuda_runtime", correlation=6)]
    dev = [_ev("void embedding_kernel<float>(float*)", 100, 4, "kernel",
               tid=8, correlation=1),
           _ev("q40_matvec_kernel(uint4 const*)", 110, 20, "kernel", tid=8,
               correlation=2),
           _ev("void decode_attention_kernel<float, 1>(...)", 130, 6,
               "kernel", tid=8, correlation=3),
           _ev("ncclDevKernel_AllGather_RING_LL(ncclDevComm*)", 140, 5,
               "kernel", tid=9, correlation=4),
           _ev("q40_matvec_kernel(uint4 const*)", 150, 10, "kernel", tid=8,
               correlation=5),
           _ev("q40_matvec_kernel(uint4 const*)", 200, 5, "kernel", tid=8,
               correlation=6)]
    att = pxprof.load_capture(_write(tmp_path, host + dev))
    assert att.tokens == 1 and att.counts_exact and att.backend == "nccl"
    assert att.phase_ms == pytest.approx({"embed": 0.004, "attn": 0.026,
                                          "ffn": 0.005, "logits": 0.010})
    assert att.total_ms == pytest.approx(0.050)
    assert att.phase_ms_per_token()["unattributed"] == pytest.approx(0.005)
    (kind, m), = att.collectives.items()
    assert (kind, m.count, m.bytes) == ("all_gather", 1, None)
    assert m.ms == pytest.approx(0.005)


def test_chrome_cpu_ops_gloo_spans_and_counts(tmp_path, model_files):  # noqa: F811
    """CPU ops by time on their thread (top level only); the tp:: spans
    are the collectives and tp::wait none; two forwards, one of which
    skipped its logits: the exact count takes its gather off."""
    evs = []
    for fwd, logits in ((0, False), (1000, True)):
        evs += [_ev("embed", fwd, 10, "user_annotation"),
                _ev("aten::embedding", fwd + 1, 8, "cpu_op"),
                _ev("attn", fwd + 10, 100, "user_annotation"),
                _ev("aten::mm", fwd + 12, 40, "cpu_op"),
                _ev("aten::t", fwd + 13, 2, "cpu_op"),  # nested: dropped
                _ev("tp::all_gather", fwd + 60, 30, "user_annotation"),
                _ev("aten::cat", fwd + 61, 3, "cpu_op"),  # inside the span
                _ev("tp::wait", fwd + 95, 5, "user_annotation"),
                _ev("ffn", fwd + 110, 50, "user_annotation"),
                _ev("tp::all_gather", fwd + 115, 20, "user_annotation"),
                _ev("aten::mm", fwd + 140, 15, "cpu_op")]
        if logits:
            evs += [_ev("logits", fwd + 160, 20, "user_annotation"),
                    _ev("tp::all_gather", fwd + 165, 10, "user_annotation")]
    evs += [_ev("aten::argmax", 1190, 5, "cpu_op"),
            _ev("gloo:all_gather", 60, 20, "cpu_op", tid=5)]  # gloo's own
    att = pxprof.load_capture(_write(tmp_path, evs))
    assert (att.tokens, att.logits_skipped, att.backend) == (2, 1, "gloo")
    assert att.collectives["all_gather"].count == 5
    assert att.phase_ms == pytest.approx(
        {"embed": 0.016, "attn": 0.150, "ffn": 0.070, "logits": 0.010})
    assert att.coverage == pytest.approx(0.246 / 0.251)
    model, _, _ = model_files
    spec, _ = pdrift.spec_for(model)  # a .bin names its spec
    report = pdrift.reconcile(att, spec, 2, "fused")
    rows = {(r.check, r.kind): r for r in report.rows}
    # fused at f32 buffers: 2L psums and the logits gather a forward; the
    # trace holds only gathers, so psum drifts and all_gather's exact
    # count is 2 x 1 - 1 = 1, not the 5 measured
    assert rows["count", "all_gather"].modeled == pytest.approx(0.5)
    assert rows["count", "all_gather"].verdict == "DRIFT"
    assert rows["time", "step"].verdict == "SKIP"
    assert "gloo" in rows["time", "step"].detail


def test_one_device_profile_reconciles(model_files, tmp_path):  # noqa: F811
    """`inference --profile` on one CPU device: the phase spans cover the
    trace (coverage >= COVERAGE_MIN), no collective, tracecheck exits 0;
    bench_drift_fields gives OK; without a profiler the forward makes no
    span."""
    from distributed_llama_tpu_torch.utils.it_split import parse_trace

    model, tok, _ = model_files
    prof = tmp_path / "prof"
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch", "inference",
         "--model", model, "--tokenizer", tok, "--prompt", "hi hi hi hi",
         "--steps", "10", "--prefill-chunk", "4", "--temperature", "0",
         "--seed", "1", "--device", "cpu", "--profile", str(prof)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    att, report = pdrift.reconcile_capture(str(prof), model=model, tp=1,
                                           scheme="fused")
    assert report.ok and att.coverage >= pdrift.COVERAGE_MIN
    assert att.logits_skipped == 1 and not att.collectives
    assert tracecheck.main([str(prof), "--model", model, "--tp", "1",
                            "--scheme", "fused",
                            "--chrome-out", str(tmp_path / "c.json")]) == 0
    assert json.loads((tmp_path / "c.json").read_text())["traceEvents"]
    fields = pdrift.bench_drift_fields(parse_trace(str(prof)),
                                       pdrift.spec_for(model)[0], 1,
                                       att.tokens, scheme="fused")
    assert fields["verdict"] == "OK"
    assert fields["collectives"]["modeled_count_per_token"] == 0


def test_flight_recorder_bundles_validate(tmp_path, capsys):
    from distributed_llama_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.obs.spans import SpanTracer

    reg = Registry()
    reg.counter("dllama_test_total", "a counter").inc()
    spans = SpanTracer()
    with spans.span("step", cat="decode"):
        pass
    rec = FlightRecorder(registry=reg, spans=spans, config={"x": 1})
    rec.note("watchdog", elapsed_s=0.1)
    path = rec.dump(str(tmp_path / "bundle.json"), "watchdog")
    assert tracecheck.main([path, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["reason"] == "watchdog" and summary["spans"] == 1
    doc = json.loads(open(path).read())
    doc.pop("metrics")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert tracecheck.main([str(bad)]) == 1
