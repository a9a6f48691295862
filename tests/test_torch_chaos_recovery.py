"""The port's two process drills on the CPU (runtime/chaos.py):

* ``kill_mid_decode`` SIGKILLs a journaling child (the port's
  ``recovery_child`` on the CPU) mid-decode and recovers its journal into
  a fresh engine: green, and the recovered streams equal the JAX
  package's uninterrupted in-process run of the same requests on its own
  recovery engine; ``corrupt-journal`` turns it red with
  JournalCorruption;
* ``kill_mid_handoff`` kills the decode pool mid-page-transfer and
  restarts it on its journal: green, and red under
  ``drop-page-in-flight`` (the twin of tests/test_disagg.py's drill
  case).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _child_threads(monkeypatch):
    """The recovery child inherits the environment: one thread there
    too."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's uninterrupted run of the recovery workload on its
    recovery engine, in process."""
    from distributed_llama_tpu.runtime import chaos as jax_chaos

    eng = jax_chaos._recovery_engine()
    reqs = jax_chaos._submit_recovery_requests(eng)
    jax_chaos._drain(eng)
    return [r.out for r in reqs]


def _recording_drain(monkeypatch):
    """Wrap the port's chaos._drain: every drained engine's requests (the
    queued ones before the drain) with their outputs after it."""
    from distributed_llama_tpu_torch.runtime import chaos

    drained = []
    inner = chaos._drain

    def drain(eng, max_iters=10_000):
        with eng._lock:
            reqs = list(eng._queue)
        reqs += [s.req for s in eng._pool if not s.free]
        n = inner(eng, max_iters)
        drained.append(reqs)
        return n

    monkeypatch.setattr(chaos, "_drain", drain)
    return drained


def test_kill_mid_decode_recovers_the_jax_streams(monkeypatch, jax_streams):
    from distributed_llama_tpu_torch.runtime.chaos import \
        drill_kill_mid_decode

    drained = _recording_drain(monkeypatch)
    res = drill_kill_mid_decode(None, device="cpu")
    assert res.passed, res.violations
    assert res.details["recovered"] == 2
    assert res.details["replayed_tokens"] >= 4
    # the last drain is the recovered engine's: its streams continue the
    # killed child's, and equal the JAX engine's uninterrupted run
    recovered = sorted(drained[-1], key=lambda r: r.index)
    assert [r.out for r in recovered] == jax_streams
    assert all(r.coin_cursor or r.temperature == 0.0 for r in recovered)


def test_corrupt_journal_turns_kill_mid_decode_red():
    from distributed_llama_tpu_torch.runtime.chaos import run_drills

    results = run_drills(None, which={"kill_mid_decode"},
                         inject={"corrupt-journal"}, device="cpu")
    assert len(results) == 1 and not results[0].passed
    assert any("JournalCorruption" in v for v in results[0].violations)


def test_kill_mid_handoff_green_and_red_under_a_dropped_page():
    from distributed_llama_tpu_torch.runtime.chaos import \
        drill_kill_mid_handoff

    res = drill_kill_mid_handoff(None, device="cpu")
    assert res.passed, res.violations
    assert res.details["handoffs_cut"] == 2
    assert res.details["recovered"] == 2
    assert res.details["pages_adopted"] > 0
    assert "memory" not in res.details  # the card's numbers only
    mutated = drill_kill_mid_handoff(None, inject={"drop-page-in-flight"},
                                     device="cpu")
    assert not mutated.passed
    assert mutated.details["dropped_pages"] > 0
    assert any("diverged" in v for v in mutated.violations)
