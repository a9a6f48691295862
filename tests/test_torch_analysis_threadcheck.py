"""The port's threadcheck (distributed_llama_tpu_torch/analysis/
threadcheck.py + threadmodel.py): the registry validates; every
``threading.Thread`` target anywhere in the port is registered; each
T-rule has firing, non-firing and pragma fixtures, and where both
registries declare the same class and family the JAX package's rule
fixtures fire the same rules under both checkers; the port's runtime/ and
obs/ hold no finding, with an empty baseline; the port's registry rows
(the plan channel, PageIO, the capture and client threads) hold.

Fixture modules are written under a fake package layout (tmp/runtime/...)
and name registered classes. The checker is pure AST."""

from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

from distributed_llama_tpu_torch.analysis import threadmodel as tm
from distributed_llama_tpu_torch.analysis.lint import (apply_baseline,
                                                       iter_module_contexts,
                                                       load_baseline,
                                                       package_files,
                                                       write_baseline)
from distributed_llama_tpu_torch.analysis.threadcheck import (
    THREAD_RULES, _Index, _rule_t004, run_threadcheck, thread_scope)

PKG = Path(tm.__file__).resolve().parents[1]
ROOT = PKG.parent


def write(tmp_path: Path, rel: str, source: str) -> Path:
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    return path


def fired(findings):
    return sorted({f.rule for f in findings})


# -- the registry -------------------------------------------------------------


def test_registry_validates():
    assert tm.validate() == []


def test_registry_covers_the_port_surfaces():
    classes = {f.owner_class for f in tm.FAMILIES}
    for cls in ("ContinuousEngine", "PagedAllocator", "RequestJournal",
                "LedgerBook", "InferenceServer", "FlightRecorder"):
        assert cls in classes
    for key in ("InferenceServer._scheduler", "serve_forever",
                "PageUploader._run", "StepWatchdog._monitor",
                "InferenceServer._watch_loop", "run", "post", "one",
                "_FlakyProxy._accept_loop", "_FlakyProxy._relay",
                "pump_requests"):
        assert key in tm.ENTRYPOINTS, key
        assert tm.ENTRYPOINTS[key].joined_by.strip()
    for cls in ("PlanLeader", "PlanChannel", "PageIO"):
        assert cls in tm.CLASS_OWNER
    fam = tm.family_for("ContinuousEngine", "_intake")
    assert fam.lock == "_lock" and fam.domain == tm.SCHEDULER


def test_validate_reports_a_malformed_row(monkeypatch):
    bad = tm.Entrypoint("x", "nowhere", "here", "")
    monkeypatch.setitem(tm.ENTRYPOINTS, "x", bad)
    problems = tm.validate()
    assert any("unknown domain" in p for p in problems)
    assert any("no join/stop path" in p for p in problems)


def test_every_thread_target_in_the_port_is_registered():
    """T004's resolution over the whole package, not only runtime/ and
    obs/: io/stream's weight server and tools/loadgen's clients too."""
    contexts = [c for c in iter_module_contexts(package_files(PKG), ROOT)
                if not isinstance(c, tuple)]
    index = _Index(contexts)
    starts = [c.relpath for c in contexts if "Thread(" in c.source]
    assert len(starts) >= 9, starts
    findings = [f for c in contexts for f in _rule_t004(index, c)]
    assert findings == [], [f.render() for f in findings]


def test_scope_is_runtime_and_obs():
    assert thread_scope("distributed_llama_tpu_torch/runtime/continuous.py")
    assert thread_scope("distributed_llama_tpu_torch/obs/ledger.py")
    assert not thread_scope("distributed_llama_tpu_torch/models/llama.py")


# -- fixtures, fired the same under both checkers -----------------------------

# (name, path, source, rules the port fires); the JAX checker must fire
# the same rules on the same snippet (both registries declare these
# classes and families)
FIXTURES = [
    ("t001-fires", "runtime/eng.py", """
        class ContinuousEngine:
            def poke(self, req):
                self._queue.append(req)
    """, ["T001"]),
    ("t001-locked", "runtime/eng.py", """
        class ContinuousEngine:
            def __init__(self):
                self._queue = []

            def poke(self, req):
                with self._lock:
                    self._queue.append(req)
    """, []),
    ("t001-pragma", "runtime/eng.py", """
        class ContinuousEngine:
            def poke(self, req):
                self._queue.append(req)  # threadcheck: allow[T001] quiesced
    """, []),
    ("t001-out-of-scope", "models/eng.py", """
        class ContinuousEngine:
            def poke(self, req):
                self._queue.append(req)
    """, []),
    ("t002-fires", "runtime/eng.py", """
        class ContinuousEngine:
            def fwd(self):
                with self._lock:
                    with self._book._lock:
                        pass

            def rev(self):
                with self._book._lock:
                    with self._lock:
                        pass
    """, ["T002"]),
    ("t002-consistent", "runtime/eng.py", """
        class ContinuousEngine:
            def fwd(self):
                with self._lock:
                    with self._book._lock:
                        pass

            def also_fwd(self):
                with self._lock:
                    with self._book._lock:
                        pass
    """, []),
    ("t002-pragma", "runtime/eng.py", """
        class ContinuousEngine:
            def fwd(self):
                with self._lock:
                    with self._book._lock:
                        pass

            def rev(self):
                with self._book._lock:
                    # threadcheck: allow[T002] teardown-only path
                    with self._lock:
                        pass
    """, []),
    ("t003-fires", "runtime/j.py", """
        import os

        class RequestJournal:
            def flush(self):
                with self._lock:
                    os.fsync(self._fh.fileno())
    """, ["T003"]),
    ("t003-quiet", "runtime/j.py", """
        import os

        class RequestJournal:
            def flush(self):
                with self._lock:
                    names = ", ".join(self._names)
                    path = os.path.join("a", "b")
                os.fsync(self._fh.fileno())
                return names, path
    """, []),
    ("t003-pragma", "runtime/j.py", """
        import os

        class RequestJournal:
            def flush(self):
                with self._lock:
                    os.fsync(self._fh.fileno())  # threadcheck: allow[T003] WAL
    """, []),
    ("t004-fires", "runtime/spawn.py", """
        import threading

        def kick(worker):
            t = threading.Thread(target=worker_loop, daemon=True)
            t.start()
            return t
    """, ["T004"]),
    ("t004-loop-bound", "runtime/spawn.py", """
        import threading

        class InferenceServer:
            def start(self):
                for target in (self._scheduler, self.httpd.serve_forever):
                    t = threading.Thread(target=target, daemon=True)
                    t.start()
    """, []),
    ("t004-pragma", "runtime/spawn.py", """
        import threading

        def kick():
            t = threading.Thread(target=worker_loop)  # threadcheck: allow[T004] local
            t.start()
    """, []),
    ("t005-fires", "runtime/eng.py", """
        class ContinuousEngine:
            def submit(self, req):
                return self._queue
    """, ["T005"]),
    ("t005-snapshot", "runtime/eng.py", """
        class ContinuousEngine:
            def submit(self, req):
                with self._lock:
                    return list(self._queue)
    """, []),
    ("t005-pragma", "runtime/eng.py", """
        class ContinuousEngine:
            def submit(self, req):
                return self._queue  # threadcheck: allow[T005] caller holds it
    """, []),
]


@pytest.mark.parametrize("name,rel,source,want", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixture_fires_the_same_rules_as_the_jax_checker(tmp_path, name,
                                                        rel, source, want):
    from distributed_llama_tpu.analysis.threadcheck import \
        run_threadcheck as jax_run

    path = write(tmp_path, rel, source)
    got = run_threadcheck([path], tmp_path)
    assert fired(got) == want, [f.render() for f in got]
    assert fired(jax_run([path], tmp_path)) == want


def test_the_port_rows_fire_where_the_jax_registry_has_none(tmp_path):
    """The port's own families: the plan intake under the engine lock, and
    a follower's PlanChannel.recv reached from the main thread only."""
    path = write(tmp_path, "runtime/plan.py", """
        class PlanLeader:
            def dispatch_point(self, engine, steps):
                intake, engine._intake = engine._intake, []
                return intake
    """)
    assert fired(run_threadcheck([path], tmp_path)) == ["T001"]
    path = write(tmp_path, "runtime/plan.py", """
        class PlanLeader:
            def dispatch_point(self, engine, steps):
                with engine._lock:
                    intake, engine._intake = engine._intake, []
                return intake
    """)
    assert run_threadcheck([path], tmp_path) == []


def test_unreadable_in_scope_file_is_a_finding(tmp_path):
    bad = write(tmp_path, "runtime/broken.py", "def broken(:\n")
    assert [f.rule for f in run_threadcheck([bad], tmp_path)] == ["T000"]


def test_every_rule_has_a_title_and_hint():
    assert sorted(THREAD_RULES) == ["T000", "T001", "T002", "T003", "T004",
                                    "T005"]
    assert all(t and h for t, h in THREAD_RULES.values())


def test_baseline_round_trip_on_threadcheck_findings(tmp_path):
    path = write(tmp_path, "runtime/eng.py", FIXTURES[0][2])
    findings = run_threadcheck([path], tmp_path)
    write_baseline(tmp_path / "tb.txt", findings)
    baseline = load_baseline(tmp_path / "tb.txt")
    assert apply_baseline(findings, baseline) == ([], len(findings), [])


# -- the repo gate ------------------------------------------------------------


def test_the_port_has_no_threadcheck_findings():
    assert run_threadcheck(package_files(PKG), ROOT) == []


def test_the_baseline_is_empty():
    assert sum(load_baseline(PKG / "analysis"
                             / "threadcheck_baseline.txt").values()) == 0
