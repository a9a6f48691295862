"""watchcheck: the detection-matrix gate for the watchtower (the port's
copy of the top-level tools/watchcheck.py, over the port's engines and
obs/watch.py).

Replays chaos faults and a clean loadgen sweep against in-process
synthetic-weight engines on loadgen's VIRTUAL clock, with every tick fed
through ``obs/watch.Watchtower`` — and asserts the detection matrix:

* healthy sweep (chaos off)      -> ZERO incidents (false-positive gate)
* leak-on-cancel waves           -> ``page_leak``
* deny-pages storm               -> ``stall_shift`` (queue_wait -> pool_dry)
* kill-mid-decode crash loop     -> ``recovery_storm``
* drop-page-in-flight handoffs   -> ``handoff_spike``

Each fault must raise EXACTLY its matching incident kind within the
pinned tick budget (``detect_by``), and nothing else. Deterministic on
any box: greedy decode, fixed seeds, integer ring columns — two runs of
the same seed produce byte-identical JSON rows, on the card as on the
CPU (``--device``, default the card; without a GPU ``--device cuda``
exits 1).

Mutation arms (each exits exactly 1):

* ``--inject mute-detector``     — every fault scenario's tower is muted
  on its expected kind; faults go undetected, the matrix turns red.
* ``--inject jitter-thresholds`` — hair-trigger threshold overrides make
  the HEALTHY sweep raise incidents; the false-positive gate turns red.

The final stdout line is one JSON row (fingerprint-stamped, loadcheck's
convention). Exit 0 = matrix green; 1 = a gate failure; 2 = usage error.

Usage:
  python3 -m distributed_llama_tpu_torch.tools.watchcheck [--seed N]
      [--json] [--inject mute-detector|jitter-thresholds]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .loadcheck import require_device


_SPEC_KW = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                n_kv_heads=2, vocab_size=128, seq_len=32)

_PARAMS = {}


def _params(device):
    """Synthetic weights on ``device``, cached per process (every scenario
    reuses the same tensors; determinism comes from the fixed seed)."""
    if device not in _PARAMS:
        from ..models.llama import params_to_device
        from ..models.spec import TransformerSpec
        from ..models.synth import synth_params

        spec = TransformerSpec(**_SPEC_KW)
        _PARAMS[device] = spec, params_to_device(
            synth_params(spec, q40=False, seed=4, scale=0.3), device)
    return _PARAMS[device]


def _engine(device, chaos=None, journal=None, **overrides):
    from ..obs.metrics import Registry
    from ..runtime.continuous import ContinuousEngine

    spec, params = _params(device)
    kw = dict(slots=2, temperature=0.0, topp=0.9, seed=11,
              metrics=Registry(), prefill_chunk=4, page_size=4,
              kv_pages=24, device=device)
    kw.update(overrides)
    return ContinuousEngine(spec, params, chaos=chaos, journal=journal,
                            **kw)


def _tower(args, expect=None):
    """A fresh Watchtower for one scenario, with the mutation arms
    applied: mute-detector silences the scenario's expected kind,
    jitter-thresholds installs hair-trigger overrides. ``spans=None``
    on purpose — trace ids are random hex, and this row is
    byte-compared across runs."""
    from ..obs.watch import Watchtower

    mute = ()
    thresholds = None
    if args.inject == "mute-detector" and expect is not None:
        mute = (expect,)
    elif args.inject == "jitter-thresholds":
        thresholds = {"recovery_storm_min": 0,
                      "page_leak_pages_min": 0,
                      "page_leak_idle_min": 1}
    return Watchtower(spans=None, mute=mute, thresholds=thresholds)


class _Feed:
    """Scenario-side observation state: cumulative verdict/goodput/
    handoff/recovery counters (the ring diffs them back to deltas) plus
    the tick pump that snapshots the engine into the tower."""

    def __init__(self, tower, replica="sim-0"):
        from ..obs import watch

        self._watch = watch
        self.tower = tower
        self.replica = replica
        self.verdicts = {"met": 0, "violated": 0, "failed": 0}
        self.goodput = 0
        self.handoff_failed = 0
        self.handoff_total = 0
        self.recoveries = 0

    def tick(self, eng, steps: int = 0):
        if steps:
            eng.step_many(steps, quiet=True)
        sample = self._watch.sample_from_engine(
            eng, verdicts=self.verdicts, goodput_tokens=self.goodput,
            handoff_failed=self.handoff_failed,
            handoff_total=self.handoff_total,
            recoveries=self.recoveries)
        self.tower.observe(self.replica, sample)

    def settle(self, rec, policy):
        """Incremental verdict accounting for a finished loadgen record
        — the same formulas ``loadgen._finalize`` applies at the end,
        evaluated at finish time so the tower sees verdict deltas."""
        ttft = (rec.v_first - rec.arrival
                if rec.v_first is not None else None)
        per_token = None
        if (rec.n_sampled > 0 and rec.v_first is not None
                and rec.v_finish is not None):
            per_token = (rec.v_finish - rec.v_first) / rec.n_sampled
        c = policy.resolve(rec.slo_class)
        verdict = c.evaluate(ttft, per_token,
                             failed=rec.error is not None)
        self.verdicts[verdict] += 1
        if verdict == "met":
            self.goodput += rec.n_sampled


def _drain(eng, max_iters: int = 4000):
    for _ in range(max_iters):
        if not eng.step_many(eng.block_steps, quiet=True):
            with eng._lock:
                if not eng._queue:
                    return
    raise RuntimeError("watchcheck: engine failed to drain")


def _result(name, expect, detect_by, tower, ticks):
    incs = [{"kind": i.kind, "tick": i.tick, "note": i.note}
            for i in tower.incidents()]
    matched = [i for i in incs if i["kind"] == expect]
    unexpected = [i for i in incs if i["kind"] != expect]
    if expect is None:
        ok = not incs
    else:
        ok = (not unexpected and bool(matched)
              and matched[0]["tick"] <= detect_by)
    return {"name": name, "expect": expect, "detect_by": detect_by,
            "fired_tick": matched[0]["tick"] if matched else None,
            "ticks": ticks, "incidents": incs,
            "unexpected": unexpected, "ok": ok,
            "watch": tower.snapshot()}


# ------------------------------------------------------------- scenarios


def scenario_healthy(args):
    """The false-positive gate: a clean poisson sweep, a normal (chaos-
    free) cancel wave, then an idle cooldown — the full detector suite
    must stay quiet throughout."""
    from ..obs.slo import SLOClass, SLOPolicy
    from ..runtime.continuous import Request
    from .loadgen import LoadSpec, drive_engine, generate_trace

    eng = _engine(args.device, slots=4, kv_pages=40)
    tower = _tower(args, expect=None)
    feed = _Feed(tower)
    # generous virtual budgets: this arm gates detector false positives,
    # not SLO attainment (loadcheck owns that gate)
    policy = SLOPolicy((SLOClass("interactive", 1e6, 1e6),))
    spec = LoadSpec(rate=0.3, n_requests=16, arrivals="poisson",
                    prompt_lens=(4, 8), out_lens=(4, 8, 12),
                    vocab=128, seq_len=32)
    trace = generate_trace(spec, seed=args.seed)

    def on_tick(v, finished):
        for rec in finished:
            feed.settle(rec, policy)
        feed.tick(eng)

    drive_engine(eng, trace, policy, on_tick=on_tick)
    # a normal cancel wave: released pages come back, so no leak alarm
    reqs = [Request(tokens=[1, 9, 17, 25], steps=20),
            Request(tokens=[1, 9, 17, 42], steps=20)]
    for r in reqs:
        eng.submit(r)
    feed.tick(eng, steps=2)
    for r in reqs:
        eng.cancel(r)
    _drain(eng)
    for _ in range(14):
        feed.tick(eng)
    return _result("healthy", None, 0, tower, tower.ring.ticks("sim-0"))


def scenario_page_leak(args):
    """leak-on-cancel waves: every cancelled request's release loses one
    page, so idle-pool pages_free steps monotonically down wave after
    wave with zero demotions — only a leak explains that."""
    from ..runtime.chaos import ChaosMonkey
    from ..runtime.continuous import Request

    chaos = ChaosMonkey(leak_on_cancel=True)
    eng = _engine(args.device, chaos=chaos)
    tower = _tower(args, expect="page_leak")
    feed = _Feed(tower)
    for wave in range(5):
        reqs = [Request(tokens=[1, 9, 17, 25, 31 + wave, 7], steps=16),
                Request(tokens=[1, 9, 17, 42, 31 + wave, 5], steps=16)]
        for r in reqs:
            eng.submit(r)
        feed.tick(eng, steps=2)
        feed.tick(eng, steps=2)
        for r in reqs:
            eng.cancel(r)
        _drain(eng)
        for _ in range(3):
            feed.tick(eng)
    return _result("leak-on-cancel", "page_leak", 30, tower,
                   tower.ring.ticks("sim-0"))


def scenario_stall_shift(args):
    """deny-pages storm: phase A builds a queue_wait-dominant base
    (backlog draining through 2 slots), then phase B parks decoders on
    denied page growth — the dominant stall cause flips to pool_dry.

    The storm is PULSED by an adaptive controller: denial is armed only
    while at least one active row still has page slack, because the
    engine's deadlock breaker fails the youngest request the moment
    EVERY active row is page-starved (and a fully-denied pool admits
    nothing new). Greedy decode makes the controller deterministic."""
    from ..runtime.chaos import ChaosMonkey
    from ..runtime.continuous import Request

    chaos = ChaosMonkey()
    eng = _engine(args.device, chaos=chaos, slots=3, kv_pages=32)
    tower = _tower(args, expect="stall_shift")
    feed = _Feed(tower)
    # phase A: a 12-deep backlog through 3 slots keeps queue_wait mass
    # flowing across the whole base window
    for i in range(12):
        eng.submit(Request(tokens=[1, 9, 17, 25 + i], steps=8))
    for _ in range(14):
        feed.tick(eng, steps=2)
    _drain(eng)
    feed.tick(eng)
    # phase B: three decoders (the recovery drill's proven streams
    # don't hit BOS inside a 24-position budget on these synth
    # weights; staggered prompt lengths stagger their page phases)
    # under a RATIONED denial storm: exactly one allocation is denied
    # per tick, so the first slot to request a page parks pool_dry
    # while every other row keeps allocating — sustained stall mass
    # without ever starving ALL active rows, which would trip the
    # engine's deadlock breaker (it fails the youngest) instead of
    # charging pool_dry.
    eng.submit(Request(tokens=[1, 9, 17, 25], steps=24,
                       temperature=0.0, topp=0.9, seed=501))
    eng.submit(Request(tokens=[1, 9, 17, 42, 31, 7], steps=24,
                       temperature=0.9, topp=0.9, seed=502))
    eng.submit(Request(tokens=[1, 9, 17, 42, 25], steps=24,
                       temperature=0.9, topp=0.9, seed=503))
    feed.tick(eng, steps=2)  # clean tick: admissions land pre-storm
    for _ in range(14):
        chaos.deny_pages = chaos.denied_allocs + 1
        feed.tick(eng, steps=2)
    chaos.deny_pages = chaos.denied_allocs
    _drain(eng)
    return _result("deny-pages-storm", "stall_shift", 40, tower,
                   tower.ring.ticks("sim-0"))


def scenario_recovery_storm(args, workdir):
    """kill-mid-decode crash loop: three lives of a journaling engine,
    each killed mid-decode and recovered by the next — the cumulative
    recovery slope is a crash loop no single snapshot shows."""
    from ..runtime.continuous import Request
    from ..runtime.journal import RequestJournal

    path = os.path.join(workdir, "watch_recovery.journal")
    tower = _tower(args, expect="recovery_storm")
    feed = _Feed(tower)
    for life in range(3):
        journal = RequestJournal(path)
        eng = _engine(args.device, journal=journal)
        if life == 0:
            for tokens in ([1, 9, 17, 25], [1, 9, 17, 42]):
                eng.submit(Request(tokens=list(tokens), steps=24))
        else:
            eng.recover()
            feed.recoveries += int(eng._obs.recoveries.value)
        for _ in range(4):
            feed.tick(eng, steps=2)
        # the "kill": durable journal, engine torn down mid-decode
        journal.sync(force=True)
        eng.close()
        journal._fh.close()
        del eng
    return _result("kill-mid-decode-loop", "recovery_storm", 16, tower,
                   tower.ring.ticks("sim-0"))


def scenario_handoff_spike(args):
    """drop-page-in-flight: the handoff codec ships zeroed page payloads
    under a VALID frame CRC, so only a bitwise payload compare (the
    receiving pool's gate) catches it — each corrupted record is one
    failed handoff verdict."""
    from ..runtime import disagg
    from ..runtime.chaos import ChaosMonkey
    from ..runtime.continuous import Request

    chaos = ChaosMonkey()
    eng = _engine(args.device, chaos=chaos)
    tower = _tower(args, expect="handoff_spike")
    feed = _Feed(tower)
    tokens = [1, 9, 17, 25, 31, 7, 3, 44, 11]
    eng.submit(Request(tokens=list(tokens), steps=12))
    _drain(eng)
    payloads = disagg.export_prefix_pages(eng, tokens)
    if not payloads:
        raise RuntimeError("watchcheck: no committed prefix pages to "
                           "hand off — radix tree empty after drain")
    reference = disagg.encode_handoff_pages(payloads)
    for tick in range(14):
        if tick == 4:
            chaos.drop_page_in_flight = True
        payloads = disagg.export_prefix_pages(eng, tokens)
        records = disagg.encode_handoff_pages(
            payloads, corrupt=chaos.page_drop)
        feed.handoff_total += len(records)
        feed.handoff_failed += sum(
            1 for rec, ref in zip(records, reference) if rec != ref)
        feed.tick(eng)
    return _result("drop-page-in-flight", "handoff_spike", 14, tower,
                   tower.ring.ticks("sim-0"))


# ------------------------------------------------------------------ main


def run(args) -> dict:
    import tempfile

    scenarios = []
    scenarios.append(scenario_healthy(args))
    scenarios.append(scenario_page_leak(args))
    scenarios.append(scenario_stall_shift(args))
    with tempfile.TemporaryDirectory() as workdir:
        scenarios.append(scenario_recovery_storm(args, workdir))
    scenarios.append(scenario_handoff_spike(args))

    failures = []
    for s in scenarios:
        if s["ok"]:
            continue
        if s["expect"] is None:
            failures.append(
                f"{s['name']}: false positives "
                f"{[i['kind'] for i in s['incidents']]}")
        elif s["fired_tick"] is None:
            failures.append(
                f"{s['name']}: {s['expect']} never fired "
                f"in {s['ticks']} ticks")
        elif s["unexpected"]:
            failures.append(
                f"{s['name']}: unexpected incidents "
                f"{[i['kind'] for i in s['unexpected']]}")
        else:
            failures.append(
                f"{s['name']}: {s['expect']} fired at tick "
                f"{s['fired_tick']} > detect_by {s['detect_by']}")

    from ..obs.watch import THRESHOLDS
    from ..utils.fingerprint import run_stamp

    return {
        "kind": "watchcheck", **run_stamp(),
        "config": {"seed": args.seed, "inject": args.inject},
        # the pinned detector thresholds ride the archived row, so a
        # threshold drift is visible in the row diff, not only as a
        # changed detection outcome
        "thresholds": dict(THRESHOLDS),
        "scenarios": scenarios,
        "gate": {"failures": failures, "ok": not failures},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="watchcheck",
        description="deterministic incident-detection matrix gate")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--json", action="store_true",
                    help="emit only the final JSON row")
    ap.add_argument("--inject", default=None,
                    choices=("mute-detector", "jitter-thresholds"),
                    help="mutation arm: the gate must turn RED under it")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run (default the card)")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2
    if not require_device("watchcheck", args.device):
        return 1

    row = run(args)
    if not args.json:
        for s in row["scenarios"]:
            mark = "ok " if s["ok"] else "RED"
            want = s["expect"] or "no incidents"
            got = (f"fired tick {s['fired_tick']}"
                   if s["fired_tick"] is not None else
                   f"{len(s['incidents'])} incidents")
            print(f"[watchcheck] {mark} {s['name']:<22} "
                  f"expect {want:<14} {got} ({s['ticks']} ticks)",
                  file=sys.stderr)
        for f in row["gate"]["failures"]:
            print(f"[watchcheck] FAIL {f}", file=sys.stderr)
    print(json.dumps(row, sort_keys=True))
    return 0 if row["gate"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
