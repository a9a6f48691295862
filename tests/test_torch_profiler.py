"""The port's profiler captures (obs/profiler.py): the twins of the JAX
package's error-path tests (tests/test_obs.py), the duration checks, one
capture at a time, and DLLAMA_PROFILE_DIR."""

import json
import math
import os

import pytest
import torch

from distributed_llama_tpu_torch.obs import profiler


@pytest.fixture(autouse=True)
def _no_capture_left():
    yield
    assert profiler.wait_capture(30)


def test_profiler_unwritable_dir_fails_clean(tmp_path):
    """An uncreatable trace dir raises BEFORE the capture starts: nothing
    stays active and a later capture into a good dir works."""
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    bad = str(blocker / "sub")  # a path THROUGH a file: mkdir must fail
    with pytest.raises(OSError):
        profiler.start_capture(bad, 1.0)
    assert profiler.capture_active() is None
    with pytest.raises(OSError):
        with profiler.trace(bad, cuda=False):
            pass
    assert profiler.capture_active() is None
    good = str(tmp_path / "ok")
    profiler.start_capture(good, 0.2)
    assert profiler.capture_active() == good
    assert profiler.wait_capture(30)
    assert os.path.isfile(profiler.trace_file(good))


@pytest.mark.parametrize("seconds", [0, -1, math.nan, math.inf, -math.inf])
def test_start_capture_rejects_bad_durations(tmp_path, seconds):
    with pytest.raises(ValueError, match="positive and finite"):
        profiler.start_capture(str(tmp_path / "t"), seconds)
    assert profiler.capture_active() is None
    assert not (tmp_path / "t").exists()


def test_a_second_capture_is_refused(tmp_path):
    first = str(tmp_path / "a")
    profiler.start_capture(first, 0.5)
    with pytest.raises(RuntimeError, match="already running"):
        profiler.start_capture(str(tmp_path / "b"), 0.1)
    with pytest.raises(RuntimeError, match="already running"):
        with profiler.trace(str(tmp_path / "c"), cuda=False):
            pass
    assert profiler.capture_active() == first
    assert profiler.wait_capture(30)
    assert profiler.capture_active() is None
    assert not (tmp_path / "b").exists()


def test_wait_capture_times_out_while_a_capture_runs(tmp_path):
    profiler.start_capture(str(tmp_path / "t"), 1.5)
    assert profiler.wait_capture(0.05) is False
    assert profiler.wait_capture(30) is True


def test_trace_writes_the_host_ops_of_its_block(tmp_path):
    """trace() records the block's host ops into <host>.<pid>.pt.trace.json
    and frees the capture, also when the block raises."""
    d = str(tmp_path / "t")
    with profiler.trace(d, cuda=False):
        assert profiler.capture_active() == d
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    assert profiler.capture_active() is None
    path = profiler.trace_file(d)
    assert path.endswith(f".{os.getpid()}.pt.trace.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::matmul" in names
    with pytest.raises(KeyError):
        with profiler.trace(d, cuda=False):
            raise KeyError("boom")
    assert profiler.capture_active() is None


@pytest.mark.parametrize("value,want", [(None, None), ("", None),
                                        ("/tmp/p", "/tmp/p")])
def test_env_profile_dir(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("DLLAMA_PROFILE_DIR", raising=False)
    else:
        monkeypatch.setenv("DLLAMA_PROFILE_DIR", value)
    assert profiler.env_profile_dir() == want


def test_trace_sessions_in_one_process_each_hold_their_own_ops(tmp_path):
    """Three trace() sessions in one process, each around a known number of
    host ops (aten::mm calls, varied per session): each trace holds its
    session's count, counted as the probe counts kernels
    (utils/it_split.parse_trace, DeviceSplit.counts by base name)."""
    from distributed_llama_tpu_torch.utils import it_split

    a = torch.ones(8, 8)
    for i, n in enumerate((5, 1, 12)):
        where = str(tmp_path / f"s{i}")
        with profiler.trace(where, cuda=False):
            for _ in range(n):
                torch.mm(a, a)
        splits = it_split.parse_trace(where)
        assert sum(s.counts["mm"] for s in splits.values()) == n, i
