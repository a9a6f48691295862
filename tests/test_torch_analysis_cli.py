"""The port's analysis CLI (``python -m distributed_llama_tpu_torch.analysis``
and its tools/ aliases): every head exits 0 on the repo and 1 on a seeded
violation, the partial-scan baseline rewrites exit 2, and ``--device
cuda`` on a host without CUDA exits 2 instead of falling back to the
CPU."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from distributed_llama_tpu_torch.analysis import __main__ as cli

ROOT = Path(cli.__file__).resolve().parents[2]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed(tmp_path, rel, source) -> Path:
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    return path


def test_all_heads_exit_zero_on_the_repo(capsys):
    assert cli.main(["--all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("dlint: 0 new finding(s)", "threadcheck: 0 new finding(s)",
                 "wirecheck: 0 new finding(s)",
                 "shardcheck: 84 config(s), 0 violating"):
        assert line in out, out[-2000:]
    assert out.count(" contract ") == 9 and " FAIL " not in out


@pytest.mark.parametrize("head", ["--threadcheck", "--wirecheck"])
def test_static_heads_exit_zero_on_the_repo(capsys, head):
    assert cli.main([head]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


SEEDS = {
    "--lint": ("runtime/hot.py", """
        def step(t):
            return t.item()
    """, "D001"),
    "--threadcheck": ("runtime/eng.py", """
        class ContinuousEngine:
            def poke(self, req):
                self._queue.append(req)
    """, "T001"),
    "--wirecheck": ("obs/met.py", """
        NAME = "dllama_bogus_total"
    """, "W004"),
}


@pytest.mark.parametrize("head", sorted(SEEDS))
def test_static_heads_exit_one_on_a_seeded_violation(tmp_path, capsys,
                                                     head):
    rel, source, rule = SEEDS[head]
    path = _seed(tmp_path, rel, source)
    assert cli.main([head, str(path)]) == 1
    assert rule in capsys.readouterr().out


def test_shardcheck_exits_one_on_a_stale_matrix(tmp_path, capsys):
    matrix = tmp_path / "m.json"
    matrix.write_text(json.dumps([{"model": "7b", "tp": 1,
                                   "scheme": "fused", "wtype": "q40",
                                   "expect_fits": False}]))
    assert cli.main(["--shardcheck-matrix", str(matrix)]) == 1
    assert "HBM-BUDGET" in capsys.readouterr().out


def test_contracts_exit_one_on_a_drifted_budget(monkeypatch, capsys):
    from distributed_llama_tpu_torch.parallel import comm_stats

    real = comm_stats.tp_collective_budget

    def drifted(spec, n, scheme=None, t_len=1):
        b = real(spec, n, scheme, t_len)
        return comm_stats.CollectiveBudget(
            tuple((k, c + 1, m) for k, c, m in b.entries))

    monkeypatch.setattr(comm_stats, "tp_collective_budget", drifted)
    assert cli.main(["--contracts", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("contract J001 FAIL") == 6


@pytest.mark.parametrize("flag", ["--write-baseline",
                                  "--write-threadcheck-baseline",
                                  "--write-wirecheck-baseline"])
def test_partial_scan_baseline_rewrites_exit_two(tmp_path, capsys, flag):
    path = _seed(tmp_path, "runtime/x.py", "x = 1\n")
    assert cli.main([flag, "--baseline", str(tmp_path / "b.txt"),
                     "--threadcheck-baseline", str(tmp_path / "t.txt"),
                     "--wirecheck-baseline", str(tmp_path / "w.txt"),
                     str(path)]) == 2
    assert "full-package scan" in capsys.readouterr().err
    assert not any((tmp_path / n).exists()
                   for n in ("b.txt", "t.txt", "w.txt"))


def test_device_cuda_without_cuda_exits_two(monkeypatch, capsys):
    monkeypatch.setattr(cli, "_cuda_available", lambda: False)
    assert cli.main(["--contracts", "--device", "cuda"]) == 2
    assert "--device cuda" in capsys.readouterr().err
    assert cli.main(["--all"]) == 2  # cuda is the default


def test_missing_path_is_a_usage_error(tmp_path, capsys):
    assert cli.main(["--lint", str(tmp_path / "nope.py")]) == 2


def test_module_entry_and_tool_aliases(capsys):
    res = subprocess.run([sys.executable, "-m",
                          "distributed_llama_tpu_torch.analysis",
                          "--threadcheck"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "threadcheck: 0 new finding(s)" in res.stdout
    from distributed_llama_tpu_torch.tools import shardcheck, threadcheck

    assert threadcheck.__doc__ and shardcheck.main(["--config", "nope"]) == 2
    assert shardcheck.main(["--config", "70b-tp8-fused-q40"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_configs"] == 1 and rep["configs"][0]["report"]["fits"]
