"""The port's chaos module (runtime/chaos.py) and the engine's fault hooks
against the JAX package's, on the CPU, at the JAX tests' spec (dim 64,
hidden 160, 2 layers, 4 heads, 2 kv heads):

* ``ChaosMonkey.parse`` gives equal monkeys and equal error messages, and
  the hooks fire on the same counters;
* the page audit, ``scrape_problems`` and ``check_invariants`` flag the
  same violations (the twins of tests/test_chaos.py's audit cases);
* cancelling a queued and an in-flight request frees their pages;
* the healthy drill suite, the two process drills aside (their own file,
  tests/test_torch_chaos_recovery.py), runs on both packages' engines:
  every drill's verdict and every integer of its details are equal.
  The tier storm stages promotions inline on both (``kv_tier_async=
  False``): with the uploader thread, when a promotion lands moves the
  schedule, and so the dispatch count (never the streams).
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=32)
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len")
# every drill but the two that spawn a process or drive two pools
PROCESS_DRILLS = {"kill_mid_decode", "kill_mid_handoff"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as P

    params = synth_params(SPEC, q40=False, seed=4, scale=0.3)
    return (P(**{f: getattr(SPEC, f) for f in _FIELDS}),
            {k: np.asarray(v) for k, v in params.items()}, params)


def factories(model, **base):
    """The JAX tests' drill factory for each package over the same
    weights: (jax_make, port_make)."""
    from distributed_llama_tpu.obs.metrics import Registry as JaxRegistry
    from distributed_llama_tpu.runtime.continuous import \
        ContinuousEngine as JaxEngine
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    kw = dict(slots=4, temperature=0.0, topp=0.9, seed=7, prefill_chunk=4,
              page_size=4, kv_pages=20, kv_tier_async=False)
    kw.update(base)

    def jax_make(chaos=None, **overrides):
        return JaxEngine(SPEC, model[2], chaos=chaos, metrics=JaxRegistry(),
                         use_native_sampler=False, **{**kw, **overrides})

    def port_make(chaos=None, **overrides):
        return ContinuousEngine(model[0], model[1], chaos=chaos,
                                metrics=Registry(), device="cpu",
                                **{**kw, **overrides})

    return jax_make, port_make


def integers(details: dict) -> dict:
    """A drill's deterministic details: its integers and dicts of them
    (wall-clock values and paths left out)."""
    return {k: v for k, v in details.items()
            if isinstance(v, (int, dict)) and not isinstance(v, bool)}


# ---------------------------------------------------------- the monkey


SPECS = ["step_delay_every=3,step_delay_ms=1,deny_pages=2,leak_on_cancel=1",
         "leak_on_cancel=0", "drop_on_demote=true, drop_page_in_flight=1",
         "drop_traceparent=1,double_count_dispatch=1,leak_ledger=yes",
         "overrun_budget=1", "overrun_budget=0", "", " , deny_pages=4 ,"]
BAD = ["nope=1", "step_delay_every", "deny_pages=x", "step_delay_ms=fast",
       "leak_on_cancel"]


@pytest.mark.parametrize("text", SPECS)
def test_parse_gives_the_jax_monkey(text):
    from distributed_llama_tpu.runtime.chaos import ChaosMonkey as Jax
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey

    assert dataclasses.asdict(ChaosMonkey.parse(text)) == \
        dataclasses.asdict(Jax.parse(text))


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_are_the_jax_messages(text):
    from distributed_llama_tpu.runtime.chaos import ChaosMonkey as Jax
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey

    with pytest.raises(ValueError) as want:
        Jax.parse(text)
    with pytest.raises(ValueError) as got:
        ChaosMonkey.parse(text)
    assert str(got.value) == str(want.value)


def test_hooks_fire_on_the_jax_counters():
    from distributed_llama_tpu.runtime.chaos import ChaosMonkey as Jax
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey

    text = ("step_delay_every=2,step_delay_ms=0.1,deny_pages=2,"
            "leak_on_cancel=1,drop_on_demote=1,drop_page_in_flight=1,"
            "drop_traceparent=1,double_count_dispatch=1,leak_ledger=1,"
            "overrun_budget=1")
    seen = []
    for monkey in (Jax.parse(text), ChaosMonkey.parse(text)):
        fired = [monkey.deny_page() for _ in range(4)]
        for _ in range(5):
            monkey.on_dispatch()
        kept = monkey.filter_release([3, 4, 5])
        fired += [monkey.demote_drop(), monkey.page_drop(),
                  monkey.trace_drop(), monkey.dispatch_double(),
                  monkey.ledger_leak(), monkey.budget_overrun()]
        seen.append((fired, kept, monkey.leaked_pages,
                     monkey.injection_summary()))
    assert seen[0] == seen[1]
    assert seen[1][0][:4] == [True, True, False, False]
    assert seen[1][3]["injected_delays"] == 2
    # every knob off: no hook fires
    quiet = ChaosMonkey()
    assert not any((quiet.deny_page(), quiet.demote_drop(),
                    quiet.page_drop(), quiet.trace_drop(),
                    quiet.dispatch_double(), quiet.ledger_leak(),
                    quiet.budget_overrun()))
    assert quiet.filter_release([1, 2]) == [1, 2]


# ------------------------------------------------------------ the audit


def _audit_walk(PagedAllocator) -> list:
    """tests/test_chaos.py's audit cases on one package's allocator."""
    out = []
    alloc = PagedAllocator(n_pages=6, page_size=4)
    out.append(alloc.audit([]))
    a, b = alloc.alloc_page(), alloc.alloc_page()
    out.append(alloc.audit([[a], [b]]))
    out.append(alloc.audit([[a]]))        # leak
    alloc.release_pages([b])
    out.append(alloc.audit([[a], [b]]))   # use after free
    out.append(alloc.audit([[a], [a]]))   # refcount mismatch
    out.append(alloc.audit([[0]]))        # the scrap page
    tree = PagedAllocator(n_pages=6, page_size=2)
    pages = [tree.alloc_page(), tree.alloc_page()]
    tree.insert_prefix([9, 8, 7, 6], pages)
    out.append(tree.audit([pages]))
    tree.release_pages(pages)
    out.append(tree.audit([]))
    out.append(tree.pool.refcount(pages[0]))
    return out


def test_audit_flags_the_jax_violations():
    from distributed_llama_tpu.runtime.paging import PagedAllocator as Jax
    from distributed_llama_tpu_torch.runtime.paging import PagedAllocator

    got, want = _audit_walk(PagedAllocator), _audit_walk(Jax)
    assert got == want
    assert got[0] == got[1] == [] and got[2] and got[3] and got[4]
    assert any("scrap" in p for p in got[5])


def test_scrape_problems_as_jax():
    from distributed_llama_tpu.obs.metrics import Registry as JaxRegistry
    from distributed_llama_tpu.runtime.chaos import \
        scrape_problems as jax_scrape
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.runtime.chaos import scrape_problems

    class _Bad:
        def expose(self):
            raise RuntimeError("boom")

    class _Garbled:
        def expose(self):
            return "# HELP x\nok_total 3\nbad_total three\n 4\n"

    assert scrape_problems(None) == jax_scrape(None) == []
    assert scrape_problems(Registry()) == jax_scrape(JaxRegistry()) == []
    for reg in (_Bad(), _Garbled()):
        assert scrape_problems(reg) == jax_scrape(reg)
    assert any("boom" in p for p in scrape_problems(_Bad()))
    assert len(scrape_problems(_Garbled())) == 2


def test_check_invariants_passes_fresh_and_flags_leak_as_jax(model):
    from distributed_llama_tpu.runtime.chaos import \
        check_invariants as jax_check
    from distributed_llama_tpu_torch.runtime.chaos import check_invariants

    jax_make, port_make = factories(model)
    seen = []
    for make, check in ((jax_make, jax_check), (port_make, check_invariants)):
        eng = make()
        clean = check(eng)
        eng.allocator.alloc_page()  # a page no slot will ever explain
        seen.append((clean, check(eng)))
    assert seen[0] == seen[1]
    assert seen[1][0] == [] and any("leaked" in p for p in seen[1][1])


def test_drained_check_flags_a_queued_request(model):
    from distributed_llama_tpu_torch.runtime.chaos import check_invariants
    from distributed_llama_tpu_torch.runtime.continuous import Request

    eng = factories(model)[1]()
    eng.submit(Request(tokens=[1, 5, 9], steps=8))
    problems = check_invariants(eng)
    assert any("not drained" in p and "1 queued" in p for p in problems)


# ----------------------------------------------------------- cancelling


def test_cancel_queued_request_completes_immediately(model):
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.runtime.continuous import (
        ContinuousEngine, Request)

    eng = ContinuousEngine(model[0], model[1], slots=1, temperature=0.0,
                           topp=0.9, seed=5, metrics=Registry(),
                           device="cpu")
    first = Request(tokens=[1, 5, 9], steps=SPEC.seq_len)
    queued = Request(tokens=[1, 7], steps=SPEC.seq_len)
    eng.submit(first)
    eng.step_once()
    eng.submit(queued)
    eng.cancel(queued)  # still queued: completes now, no scheduler needed
    assert queued.done.is_set() and queued.cancelled
    reg = eng._obs.registry
    assert reg.get("dllama_requests_cancelled_total").value == 1
    assert reg.get("dllama_queue_depth").value == 0
    first.cancelled = True
    while eng.step_once():
        pass
    assert first.done.is_set()


def test_cancel_in_flight_frees_pages_at_next_sweep(model):
    from distributed_llama_tpu_torch.obs.metrics import Registry
    from distributed_llama_tpu_torch.runtime.continuous import (
        ContinuousEngine, Request)

    eng = ContinuousEngine(model[0], model[1], slots=2, temperature=0.0,
                           topp=0.9, seed=5, metrics=Registry(),
                           page_size=4, block_steps=8, device="cpu")
    free0 = eng.allocator.n_free
    req = Request(tokens=[1, 5, 9, 11, 13], steps=SPEC.seq_len)
    eng.submit(req)
    eng.step_many(2)
    held = next(len(s.pages) for s in eng._pool if not s.free)
    assert held > 0
    tokens_at_cancel = len(req.out)
    eng.cancel(req)
    eng.step_many(eng.block_steps)  # the sweep runs before the dispatch
    assert req.done.is_set() and len(req.out) == tokens_at_cancel
    assert eng.allocator.n_free == free0  # a cancel publishes nothing
    assert eng.audit_pages() == []
    assert eng._obs.registry.get("dllama_kv_pages_free").value == free0


# --------------------------------------------------------------- drills


@pytest.fixture(scope="module")
def healthy(model):
    """The healthy suite (process drills aside) on both packages' engines,
    each run once for the module: (jax results, port results)."""
    from distributed_llama_tpu.runtime import chaos as jax_chaos
    from distributed_llama_tpu_torch.runtime import chaos

    which = {name for name, _ in chaos.DRILLS} - PROCESS_DRILLS
    jax_make, port_make = factories(model)
    return (jax_chaos.run_drills(jax_make, which=which),
            chaos.run_drills(port_make, which=which, device="cpu"))


def test_drill_registry_is_the_jax_one():
    from distributed_llama_tpu.runtime import chaos as jax_chaos
    from distributed_llama_tpu_torch.runtime import chaos

    assert [n for n, _ in chaos.DRILLS] == [n for n, _ in jax_chaos.DRILLS]
    for name in ("RECOVERY_DRILLS", "TIERING_DRILLS", "DISAGG_DRILLS",
                 "_RECOVERY_SPEC_KW", "_RECOVERY_REQS", "_HANDOFF_REQS"):
        assert getattr(chaos, name) == getattr(jax_chaos, name), name


def test_healthy_suite_passes_with_the_jax_counters(healthy):
    want, got = healthy
    assert [r.name for r in got] == [r.name for r in want]
    assert len(got) == 10
    assert all(r.passed for r in got), [(r.name, r.violations)
                                        for r in got if not r.passed]
    for a, b in zip(want, got):
        assert b.passed == a.passed, a.name
        assert integers(b.details) == integers(a.details), a.name
    by = {r.name: r.details for r in got}
    assert by["pool_exhaustion"]["pauses"] > 0
    assert by["transient_starvation"]["denied_allocs"] == 6
    assert by["latency_spike"]["injected_delays"] > 0
    assert by["disconnect"]["pages_at_risk"] > 0
    assert by["hung_dispatch"]["trips"] > 0
    assert by["weight_stream_disconnect"]["drops"] > 0
    storm = by["tier_spill_storm"]
    assert storm["prefill_saved_spilled"] > 0
    assert sum(storm["demotions"].values()) > 0
    assert sum(storm["promotions"].values()) > 0


def test_drill_table_and_rows_as_jax(healthy):
    from distributed_llama_tpu.runtime.chaos import \
        render_drill_table as jax_table
    from distributed_llama_tpu_torch.runtime.chaos import render_drill_table

    want, got = healthy
    keep = [r for r in got if r.name != "profiler_under_load"]
    jkeep = [r for r in want if r.name != "profiler_under_load"]
    assert render_drill_table(keep) == jax_table(jkeep)
    assert [r.to_json() for r in keep] == [r.to_json() for r in jkeep]


def test_a_raising_drill_is_a_failed_result():
    from distributed_llama_tpu_torch.runtime.chaos import run_drills

    def broken(chaos=None, **overrides):
        raise RuntimeError("no engine today")

    results = run_drills(broken, which={"pool_exhaustion", "disconnect"},
                         device="cpu")
    assert [r.name for r in results] == ["pool_exhaustion", "disconnect"]
    assert all(not r.passed and "RuntimeError: no engine today"
               in r.violations[0] for r in results)
