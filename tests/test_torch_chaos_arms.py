"""The chaos mutation arms on both packages' engines, on the CPU: each arm
has the effect the JAX engine's has, with equal counters.

* ``leak_on_cancel`` turns the disconnect drill red, ``drop_on_demote``
  the tier spill storm (the loadcheck gate's self-test arms);
* ``overrun_budget`` packs mixed prefill slices past the token budget:
  greedy streams stay the separate-dispatch run's, ``overrun_steps`` > 0
  and equal to the JAX engine's (tests/test_mixed_batch.py's case);
* ``double_count_dispatch`` breaks the ledger-against-census sums that
  tools/costcheck.py checks, computed here from the port's books;
* ``leak_ledger`` leaves ledgers open after the drain;
* ``drop_traceparent`` sends a handoff without its traceparent, through
  the two-pool harness and the prefill server's POST /prefill seam.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_chaos import SPEC, factories, integers, model  # noqa: F401

REQS = [[1, 9, 17, 25, 31, 7, 3, 44, 11], [1, 5, 6, 7, 8, 9, 10],
        [1, 40, 41], [1, 9, 17, 25, 31, 7, 3, 44, 5, 6, 12, 13]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _monkeys(text):
    from distributed_llama_tpu.runtime.chaos import ChaosMonkey as Jax
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey

    return Jax.parse(text), ChaosMonkey.parse(text)


def _armed(make, knob):
    """``make`` with ``knob`` set on whatever monkey the drill brings (the
    loadcheck factory's injection)."""
    def armed(chaos=None, **overrides):
        chaos = chaos if chaos is not None else armed.monkey_type()
        setattr(chaos, knob, True)
        return make(chaos=chaos, **overrides)
    return armed


@pytest.mark.parametrize("knob,drill,expect", [
    ("leak_on_cancel", "disconnect", ("leaked", "round-trip")),
    ("drop_on_demote", "tier_spill_storm", ("dropped its bytes",))])
def test_mutation_arm_turns_its_drill_red(model, knob, drill, expect):
    from distributed_llama_tpu.runtime import chaos as jax_chaos
    from distributed_llama_tpu_torch.runtime import chaos

    jax_make, port_make = factories(model)
    results = []
    for pkg, make in ((jax_chaos, jax_make), (chaos, port_make)):
        armed = _armed(make, knob)
        armed.monkey_type = pkg.ChaosMonkey
        kw = {"device": "cpu"} if pkg is chaos else {}
        results.append(pkg.run_drills(armed, which={drill}, **kw)[0])
    want, got = results
    assert not got.passed and not want.passed
    text = " ".join(got.violations)
    assert all(word in text for word in expect), got.violations
    assert got.violations == want.violations
    assert integers(got.details) == integers(want.details)
    if knob == "leak_on_cancel":
        assert got.details["leaked_pages"] > 0


def test_overrun_budget_keeps_streams_and_counts_the_jax_overruns(model):
    jax_make, port_make = factories(model)
    ref, _ = port_make().run(REQS, 24)
    seen = []
    for make, monkey in zip((jax_make, port_make),
                            _monkeys("overrun_budget=1")):
        eng = make(chaos=monkey, dispatch_tokens=4, prefill_chunk=0,
                   slots=2)
        outs, st = eng.run(REQS, 24)
        seen.append((outs, st.overrun_steps, st.steps,
                     monkey.injection_summary()))
    (jax_outs, jax_over, jax_steps, jax_sum), got = seen[0], seen[1]
    assert got[0] == jax_outs == ref
    assert got[1] > 0 and got[1] == jax_over
    assert got[2] == jax_steps and got[3] == jax_sum
    assert got[3]["overran_budgets"] > 0


def _conservation(eng) -> dict:
    """tools/costcheck.py's ledger-side against engine-side sums, from one
    engine's books: name -> (ledger side, engine side)."""
    t = eng.ledger_book.grand_totals()
    c = eng.sched_census.totals()
    st = eng.stats
    return {"row_steps_vs_census": (t["decode_row_steps"], c["row_steps"]),
            "row_steps_vs_stats": (t["decode_row_steps"], st.sum_active),
            "page_steps": (t["page_steps"], c["page_steps"]),
            "stall_steps": (t["stall_steps_total"], c["stall_steps"]),
            "tokens": (t["tokens"], st.tokens)}


def test_double_count_dispatch_breaks_the_ledger_sums(model):
    jax_make, port_make = factories(model, kv_pages=12)
    healthy = port_make()
    healthy.run(REQS, 20)
    assert all(a == b for a, b in _conservation(healthy).values())
    books = []
    for make, monkey in zip((jax_make, port_make),
                            _monkeys("double_count_dispatch=1")):
        eng = make(chaos=monkey)
        eng.run(REQS, 20)
        books.append((_conservation(eng), monkey.double_counted))
    (want, jax_n), (got, n) = books
    assert got == want and n == jax_n > 0
    # the ledger side doubles, the census and stats stay the truth
    for name in ("row_steps_vs_census", "row_steps_vs_stats",
                 "page_steps"):
        ledger, engine = got[name]
        assert ledger == 2 * engine and engine > 0, name
    assert got["tokens"][0] == got["tokens"][1]  # tokens are not doubled
    assert got["row_steps_vs_census"][1] == \
        _conservation(healthy)["row_steps_vs_census"][1]


def test_leak_ledger_leaves_ledgers_open_after_the_drain(model):
    jax_make, port_make = factories(model)
    open_after = []
    for make, monkey in zip((jax_make, port_make),
                            _monkeys("leak_ledger=1")):
        eng = make(chaos=monkey)
        outs, _ = eng.run(REQS, 16)
        assert all(outs)
        open_after.append((eng.ledger_book.n_open, monkey.leaked_ledgers))
    assert open_after[1] == open_after[0]
    assert open_after[1][0] == len(REQS) == open_after[1][1]
    clean = port_make()
    clean.run(REQS, 16)
    assert clean.ledger_book.n_open == 0


def test_drop_traceparent_hands_off_without_the_header(model, tmp_path):
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey
    from distributed_llama_tpu_torch.runtime.disagg import (DisaggPair,
                                                            prefill_stub)
    from distributed_llama_tpu_torch.runtime.journal import RequestJournal

    headers = []
    for monkey in (None, ChaosMonkey(drop_traceparent=True)):
        _, make = factories(model, slots=2, kv_pages=24)
        journal = RequestJournal(str(tmp_path / f"p{len(headers)}.wal"))
        pair = DisaggPair(make(journal=journal), make(remote_pages=True),
                          channel_host="127.0.0.1", chaos=monkey)
        stub, _ = prefill_stub(REQS[0], 20)
        pair.prefill.submit(stub)
        while pair.prefill.step_many(1):
            pass
        with pytest.raises(OSError):  # cut: the pages stay published
            pair.handoff(stub, 20, cut_after=0)
        headers.append(pair._client.trace(f"h{stub.index}"))
        pair.close()
        journal.close()
    assert headers[0] is not None and headers[1] is None
    assert monkey.dropped_traceparents == 1


def test_drop_traceparent_at_the_prefill_servers_seam(model):
    """POST /prefill with a traceparent: the healthy prefill server
    continues the decode pool's trace, the armed one mints a new one."""
    from distributed_llama_tpu_torch.obs import tracectx
    from distributed_llama_tpu_torch.runtime.chaos import ChaosMonkey
    from distributed_llama_tpu_torch.runtime.journal import entry_from_wire
    from distributed_llama_tpu_torch.runtime.server import InferenceServer

    class _Ids:
        def encode(self, text, bos=True, eos=False):
            return [1] + [3 + b for b in text.encode()]

        def decode_piece(self, prev, tok):
            return b"<%d>" % tok

    parent = tracectx.mint()
    traces = []
    for monkey in (None, ChaosMonkey(drop_traceparent=True)):
        srv = InferenceServer(model[0], model[1], _Ids(), "127.0.0.1", 0,
                              slots=2, steps=20, temperature=0.0, topp=0.9,
                              seed=5, quiet=True, page_size=4,
                              kv_pages=24, disagg_role="prefill",
                              device="cpu", chaos=monkey)
        srv.start()
        try:
            body = json.dumps({"tokens": REQS[0], "steps": 20,
                               "trace": parent.to_header()}).encode()
            rq = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/prefill", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(rq, timeout=60) as r:
                reply = json.loads(r.read())
        finally:
            srv.stop()
        entry = entry_from_wire(reply["record"])
        traces.append(tracectx.parse_header(entry.trace).trace_id)
    assert traces[0] == parent.trace_id
    assert traces[1] != parent.trace_id
    assert monkey.dropped_traceparents == 1


def test_chaos_stats_field_counts_only_overruns(model):
    """A healthy mixed engine counts no overrun step (the virtual clock's
    charge is the mutation's alone)."""
    _, make = factories(model)
    eng = make(dispatch_tokens=4, prefill_chunk=0, slots=2)
    outs, st = eng.run(REQS, 24)
    assert all(outs) and st.overrun_steps == 0
    assert np.isfinite(st.avg_active)
