"""``--profile`` above tp 1: each rank traces its own work into
``<dir>/rank<r>``, rank 0 prints the I/T split, and in every rank's trace
the collectives (T) are positive and one event each, as many as CENSUS
counted. gloo's collectives are host work with no kernel: the spans
parallel/collectives.py makes while a profiler runs carry them
(utils/it_split.py); on the card NCCL's kernels do."""

import json
import os
import re
import subprocess
import sys

import pytest

from test_torch_tp_cli import ROOT, model_files  # noqa: F401


@pytest.mark.parametrize("scheme", ["fused", "overlap"])
def test_tp2_profile_gives_each_rank_a_split_with_the_census(
        model_files, tmp_path, scheme):
    from distributed_llama_tpu_torch.utils.it_split import parse_trace

    model, tok, _ = model_files
    prof = tmp_path / "prof"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch", "inference",
         "--model", model, "--tokenizer", tok, "--prompt", "hi hi hi hi",
         "--steps", "10", "--prefill-chunk", "4", "--temperature", "0",
         "--seed", "1", "--tp", "2", "--tp-scheme", scheme, "--device",
         "cpu", "--profile", str(prof)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout
    assert f"⏩ Profiler trace written to {prof / 'rank0'}" in out
    m = re.search(r"🔶 I +([\d.]+) ms/token  T +([\d.]+) ms/token", out)
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0
    m = re.search(r"Collectives in the trace: (\d+) \(([\d.]+) ms\), "
                  r"census (\d+)", out)
    assert m and m.group(1) == m.group(3) and float(m.group(2)) > 0
    issued = int(m.group(3))
    per_token = re.search(r"Collectives/token: +(\d+)", out).group(1)
    assert issued > int(per_token)  # the prefill's and every step's
    for rank in (0, 1):
        splits = parse_trace(str(prof / f"rank{rank}"))
        assert len(splits) == 1  # the rank's main thread; gloo's left out
        (split,) = splits.values()
        assert split.transfer_events == issued, rank
        assert split.transfer_ns > 0 and split.inference_ns > 0


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 7,
            "tid": tid, "ts": ts, "dur": dur}


def _op(name, ts, dur, tid=1, cat="cpu_op", pid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def _write(tmp_path, events):
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_host_spans_are_t_and_gloo_threads_are_left_out(tmp_path):
    from distributed_llama_tpu_torch.utils.it_split import parse_trace

    events = [_op("aten::mm", 0.0, 10.0),
              _span("tp::all_reduce", 10.0, 5.0),
              _op("c10d::allreduce_", 10.5, 1.0),     # inside the span
              _span("tp::all_gather", 20.0, 4.0),
              _span("tp::wait", 30.0, 2.0),           # T, not an event
              _span("step", 0.0, 40.0),               # other spans: none
              _span("gloo:all_reduce", 11.0, 3.0, tid=2),
              _op("aten::view", 11.5, 1.0, tid=2)]
    (split,) = parse_trace(_write(tmp_path, events)).values()
    assert split.inference_ns == 10_000.0
    assert split.transfer_ns == 11_000.0
    assert split.transfer_events == 2
    assert dict(split.counts) == {"mm": 1, "all_reduce": 1,
                                  "all_gather": 1, "wait": 1}


def test_kernel_traces_take_host_spans_only_without_collective_kernels(
        tmp_path):
    """gloo ranks on the card: kernels for I, the host spans for T. NCCL:
    the collective kernels are T and the spans are left out."""
    from distributed_llama_tpu_torch.utils.it_split import parse_trace

    k = [_op("void q40_matvec_kernel(uint4 const*)", 0.0, 6.0, tid=9,
             cat="kernel", pid=0),
         _span("tp::all_reduce", 6.0, 3.0)]
    (split,) = parse_trace(_write(tmp_path, k)).values()
    assert (split.inference_ns, split.transfer_ns,
            split.transfer_events) == (6000.0, 3000.0, 1)
    nccl = k + [_op("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 6.5, 2.0,
                    tid=9, cat="kernel", pid=0)]
    (split,) = parse_trace(_write(tmp_path, nccl)).values()
    assert (split.inference_ns, split.transfer_ns,
            split.transfer_events) == (6000.0, 2000.0, 1)


def test_a_tp_trace_without_collectives_fails_the_run(tmp_path, capsys):
    """T of 0, or events other than the census, under a tp group: exit 1
    (on one device the split is only printed)."""
    import argparse

    from distributed_llama_tpu_torch.frontend.cli import _print_split

    class Stats:
        tokens = 4

    d = tmp_path / "t"
    d.mkdir()
    _write(d, [_op("aten::mm", 0.0, 10.0)])
    args = argparse.Namespace(prompt="")

    class Tok:
        def encode(self, text, bos, eos):
            return [1]

    assert _print_split(args, str(d), Tok(), Stats(), None, None, True) == 0
    assert _print_split(args, str(d), Tok(), Stats(), None, 3, True) == 1
    assert "holds 0 collective events" in capsys.readouterr().err
    _write(d, [_op("aten::mm", 0.0, 10.0), _span("tp::all_gather", 10, 1)])
    assert _print_split(args, str(d), Tok(), Stats(), None, 1, True) == 0
