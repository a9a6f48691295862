"""racecheck: deterministic cooperative-interleaving race gate (the
port's copy of the top-level tools/racecheck.py, over the port's
PagedAllocator, PageUploader, ContinuousEngine.ingest_remote and
LedgerBook).

racecheck drives the REAL cross-thread seam code through seeded
interleavings of its atomic operations and asserts the runtime's own
safety oracles after every schedule — the PagedAllocator full-accounting
audit and the LedgerBook conservation equalities, the same checks the
chaos drills gate on.

Each SEAM declares 2-3 domains (thread roles) as ordered lists of atomic
ops over shared state. A schedule is one interleaving of those lists (per-domain order
preserved — exactly the schedules a sequentially-consistent machine
could produce at the granularity the locks make atomic). Small seams
enumerate EVERY interleaving (multinomial <= --max-exhaustive);
larger ones draw seeded distinct samples until --target schedules.
Same seed => same schedule set (the top-level tool's set: the schedules
are drawn by the same code from the same ops).

Seams:
  pool_adopt    PagePool alloc/release (a local slot's pages) racing
                adopt_remote_pages/drop_adopted (the DCN ingest side)
                on one PagedAllocator. Oracle: allocator audit.
  upload_settle PageUploader staging (REAL uploader thread, one job
                per op) racing the scheduler's take_staged_promotions/
                promotion_applied settle loop. Oracle: the admission
                PAUSE gate (slot_pending) holds until the payload
                lands, every job applies exactly once, audit clean.
  ingest_sweep  ingest_remote + cancel (handler domain) racing
                step_once (scheduler: drain inbox -> sweep cancelled
                -> admit -> step) on a REAL remote_pages engine.
                Oracle: drained-to-idle ledger conservation
                (opened == closed, none open), FIFO admission order,
                allocator audit.
  ledger_drain  LedgerBook open/charge racing close racing the
                drain-side readers (grand_totals/to_json/rollup).
                Oracle: opened == closed + open at every read, totals
                count exactly the closed set.

Mutations (the gate's self-test — each makes this tool exit EXACTLY 1):
  --inject drop-a-lock   pool_adopt's allocs run as the two
                         schedulable half-ops (read free head / claim
                         it) that dropping the pool lock admits — some
                         interleaving double-claims a page and the
                         audit must flag it
  --inject reorder-inbox _drain_remote_inbox drains the ingest inbox
                         in REVERSED order — some interleaving queues
                         two requests and FIFO admission must flag it

The final stdout line is one JSON row (seed, per-seam schedule counts,
schedule-set digest, failures). Exit 0 = every schedule of every seam
clean; 1 = any oracle violation (that includes the armed mutations);
2 = usage.

The engine seam runs on ``--device`` (default the card; without a GPU
``--device cuda`` exits 1); the other seams are host code.

Usage:
  python3 -m distributed_llama_tpu_torch.tools.racecheck [--seed N]
      [--seam NAME ...] [--inject drop-a-lock|reorder-inbox] [--target N]
      [--max-exhaustive N] [--cap N] [--list] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import random
import sys
import time

from .loadcheck import require_device


INJECTIONS = ("drop-a-lock", "reorder-inbox")


# -- schedule generation ---------------------------------------------------


def n_interleavings(counts) -> int:
    """Multinomial: distinct interleavings of len(counts) ordered op
    lists of the given lengths."""
    n = math.factorial(sum(counts))
    for c in counts:
        n //= math.factorial(c)
    return n


def exhaustive_schedules(counts):
    """Every interleaving, lexicographic in domain index."""
    total = sum(counts)
    remaining = list(counts)
    prefix: list[int] = []

    def rec():
        if len(prefix) == total:
            yield tuple(prefix)
            return
        for d in range(len(remaining)):
            if remaining[d]:
                remaining[d] -= 1
                prefix.append(d)
                yield from rec()
                prefix.pop()
                remaining[d] += 1

    yield from rec()


def sampled_schedules(counts, target: int, seed: int):
    """``target`` DISTINCT schedules, seeded — same seed, same set (and
    same order). Draws are uniform over next-op choices weighted by
    remaining ops, retried until distinct."""
    rng = random.Random(seed)
    seen: set = set()
    out: list[tuple] = []
    limit = min(target, n_interleavings(counts))
    tries = 0
    while len(out) < limit and tries < 100_000:
        tries += 1
        remaining = list(counts)
        sched: list[int] = []
        for _ in range(sum(counts)):
            # weight by remaining ops: uniform over completions
            pick = rng.randrange(sum(remaining))
            for d, c in enumerate(remaining):
                if pick < c:
                    sched.append(d)
                    remaining[d] -= 1
                    break
                pick -= c
        t = tuple(sched)
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def schedule_digest(schedules) -> str:
    h = hashlib.sha1()
    for s in sorted(schedules):
        h.update(bytes(s))
        h.update(b"|")
    return h.hexdigest()[:12]


# -- seam: pool alloc/release vs adopt_remote_pages ------------------------


class PoolAdoptSeam:
    """A local slot allocating and releasing pages while the DCN ingest
    side adopts shipped payloads into the same PagedAllocator."""

    name = "pool_adopt"
    domains = ("scheduler", "handler")

    def __init__(self, inject: str | None):
        self.split_alloc = inject == "drop-a-lock"

    def make_state(self):
        from ..runtime.paging import PagedAllocator

        alloc = PagedAllocator(n_pages=8, page_size=2)
        alloc.remote = True  # widen the pending gates (decode-pool role)
        return {"alloc": alloc, "pages": {"L": [], "R": []},
                "peek": {}, "adopted": [], "violations": []}

    def _alloc_ops(self, state, who):
        """One page allocation as schedulable ops. Normal mode: one
        atomic op (the real locked alloc_page). drop-a-lock: the two
        half-ops a dropped pool lock admits — read the free head, then
        claim it — so a racing domain can double-claim."""
        alloc = state["alloc"]
        if not self.split_alloc:
            def one():
                pid = alloc.alloc_page()
                if pid is not None:
                    state["pages"][who].append(pid)
            return [one]

        def peek():
            ids = alloc.pool.free_ids()
            state["peek"][who] = ids[-1] if ids else None

        def claim():
            pid = state["peek"].get(who)
            if pid is None:
                return
            pool = alloc.pool
            if pid in pool._free:
                pool._free.remove(pid)
            pool._ref[pid] = 1  # clobbers any concurrent holder's count
            state["pages"][who].append(pid)
        return [peek, claim]

    def ops(self, state):
        alloc = state["alloc"]

        def release(who):
            def op():
                if state["pages"][who]:
                    alloc.release_pages([state["pages"][who].pop(0)])
            return op

        sched = (self._alloc_ops(state, "L")
                 + [release("L")]
                 + self._alloc_ops(state, "L")
                 + [release("L")])

        def adopt(tokens):
            def op():
                payloads = [("plane", t) for t in
                            range(0, len(tokens), 2)]
                state["adopted"].extend(
                    alloc.adopt_remote_pages(tokens, payloads))
            return op

        def drop():
            alloc.drop_adopted(state["adopted"])
            state["adopted"].clear()

        handler = (self._alloc_ops(state, "R")
                   + [adopt([1, 2, 3, 4]), adopt([9, 8, 7, 6]),
                      release("R"), drop])
        return [sched, handler]

    def oracle(self, state):
        alloc = state["alloc"]
        for who in ("L", "R"):
            alloc.release_pages(state["pages"][who])
        problems = list(state["violations"])
        problems += alloc.audit([])
        return problems

    def cleanup(self, state):
        pass


# -- seam: uploader staging vs scheduler settle ----------------------------


class UploadSettleSeam:
    """The PageUploader thread landing staged payloads while the
    scheduler settles promotions at step boundaries. Ops on the
    uploader domain submit ONE job to the REAL uploader thread and wait
    for its stage to land — the harness stays deterministic while the
    seam code (PageUploader._run, take_staged_promotions,
    promotion_applied, slot_pending) is the production code."""

    name = "upload_settle"
    domains = ("uploader", "scheduler")

    def __init__(self, inject: str | None):
        pass

    def make_state(self):
        from ..runtime.paging import (PagedAllocator,
                                                          PageUploader)

        alloc = PagedAllocator(n_pages=8, page_size=1)
        alloc.remote = True
        # stage -> None: adoption queues the job promotion-PENDING with
        # no staged payload, exactly the async-uploader shape — the
        # uploader domain below supplies the staged planes
        alloc.bind_device_io(fetch=None, stage=lambda payload: None)
        adopted = alloc.adopt_remote_pages(
            [1, 2, 3, 4], [("plane", i) for i in range(4)])
        up = PageUploader(stage=None)
        return {"alloc": alloc, "up": up, "jobs": list(alloc._jobs),
                "adopted": adopted, "applied": set(), "violations": []}

    def ops(self, state):
        alloc, up = state["alloc"], state["up"]

        def stage(i):
            def op():
                job = state["jobs"][i]
                job.staged = None  # clear the inline-stage None marker
                up.submit(job)
                deadline = time.monotonic() + 5.0
                while job.staged is None:
                    if time.monotonic() > deadline:
                        state["violations"].append(
                            f"uploader never staged job {i}")
                        return
                    time.sleep(0.0005)
            return op

        def settle():
            for job in alloc.take_staged_promotions():
                if not alloc.slot_pending([job.page]):
                    state["violations"].append(
                        f"page {job.page} not PENDING before its "
                        f"payload applied — the admission pause gate "
                        f"dropped early")
                alloc.promotion_applied(job)
                if alloc.slot_pending([job.page]):
                    state["violations"].append(
                        f"page {job.page} still pending after apply")
                if job.page in state["applied"]:
                    state["violations"].append(
                        f"page {job.page} applied twice")
                state["applied"].add(job.page)

        uploader = [stage(i) for i in range(len(state["jobs"]))]
        scheduler = [settle] * 5
        return [uploader, scheduler]

    def oracle(self, state):
        alloc = state["alloc"]
        # final settle: everything staged must land
        for job in alloc.take_staged_promotions():
            alloc.promotion_applied(job)
            state["applied"].add(job.page)
        problems = list(state["violations"])
        if len(state["applied"]) != len(state["jobs"]):
            problems.append(
                f"{len(state['applied'])}/{len(state['jobs'])} "
                f"promotions applied after drain")
        if alloc._pending:
            problems.append(f"pending pages leak: {alloc._pending}")
        problems += alloc.audit([])
        return problems

    def cleanup(self, state):
        state["up"].close()


# -- seam: ingest_remote + cancel vs the scheduler loop --------------------


class IngestSweepSeam:
    """Handler-domain ingest_remote/cancel racing the REAL engine's
    step_once (drain inbox -> sweep cancelled -> admit -> dispatch) on
    a remote_pages decode-pool engine on ``device``. The engine is shared
    across schedules; every schedule gets fresh requests and drains to
    idle before the oracle runs."""

    name = "ingest_sweep"
    domains = ("handler", "scheduler")

    def __init__(self, inject: str | None, device: str = "cuda"):
        self.reorder = inject == "reorder-inbox"
        self.device = device
        self._engine = None

    def _build_engine(self):
        from ..models.spec import TransformerSpec
        from ..models.synth import synth_params
        from ..runtime.continuous import \
            ContinuousEngine

        spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2,
                               n_heads=4, n_kv_heads=2, vocab_size=128,
                               seq_len=32)
        params = synth_params(spec, q40=False, seed=4, scale=0.3)
        eng = ContinuousEngine(spec, params, slots=2, temperature=0.0,
                               topp=0.9, seed=5, page_size=4,
                               kv_pages=16, prefill_chunk=4,
                               remote_pages=True, device=self.device)
        if self.reorder:
            orig = eng._drain_remote_inbox

            def mutated():
                with eng._lock:
                    eng._remote_inbox.reverse()
                orig()
            eng._drain_remote_inbox = mutated
        return eng

    def make_state(self):
        from ..runtime.continuous import Request

        if self._engine is None:
            self._engine = self._build_engine()
        eng = self._engine

        def req(k):
            return Request(tokens=[1 + k, 2, 3, 4], steps=2)

        rs = [req(k) for k in range(4)]
        return {"eng": eng, "rs": rs, "ingested": [], "violations": []}

    def ops(self, state):
        eng, rs = state["eng"], state["rs"]

        def ingest(i):
            def op():
                # planes [None]: the payload never arrived — adoption
                # stops at the gap, prefill re-derives (pool_adopt
                # covers the adoption side); the INBOX machinery and
                # the request's admission path are what race here
                eng.ingest_remote(list(rs[i].tokens), [None], rs[i])
                state["ingested"].append(rs[i])
            return op

        def cancel(i):
            def op():
                eng.cancel(rs[i])
            return op

        def submit_local():
            eng.submit(rs[3])

        def step():
            eng.step_once()

        handler = [ingest(0), ingest(1), submit_local, cancel(0),
                   ingest(2), cancel(3), cancel(1)]
        scheduler = [step] * 3
        return [handler, scheduler]

    def oracle(self, state):
        eng = state["eng"]
        problems = list(state["violations"])
        for _ in range(200):
            if eng.step_once() == 0:
                break
        else:
            problems.append("engine never drained to idle")
        book = eng._book
        if book.n_open != 0:
            problems.append(f"{book.n_open} ledgers still open at idle")
        if book.opened_n != book.closed_n:
            problems.append(f"ledger conservation broke: "
                            f"opened={book.opened_n} "
                            f"closed={book.closed_n}")
        idx = [r.index for r in state["ingested"] if r.index >= 0]
        if idx != sorted(idx):
            problems.append(f"FIFO admission order broke: ingest order "
                            f"got engine indices {idx}")
        problems += eng._alloc.audit([s.pages for s in eng._pool])
        return problems

    def cleanup(self, state):
        pass

    def close(self):
        if self._engine is not None:
            self._engine.close()
            self._engine = None


# -- seam: ledger open/charge vs close vs drain readers --------------------


class LedgerDrainSeam:
    """Three domains on one LedgerBook: the submit side opening and
    charging, the retire side closing, the drain/scrape side reading
    the rollups. The conservation equality must hold at EVERY read."""

    name = "ledger_drain"
    domains = ("opener", "closer", "reader")

    def __init__(self, inject: str | None):
        pass

    def make_state(self):
        from ..obs.ledger import LedgerBook

        return {"book": LedgerBook(keep=4), "violations": []}

    def ops(self, state):
        book = state["book"]

        def open_charge(rid):
            def op():
                led = book.open_request(rid, "interactive")
                led.charge_tokens(2)
                led.charge_rows(1, 0.25)
            return op

        def close(rid):
            def op():
                book.close_request(rid, "done")
            return op

        def read():
            book.grand_totals(include_open=True)  # open-merge path too
            tot = book.grand_totals(include_open=False)
            if book.opened_n != book.closed_n + book.n_open:
                state["violations"].append(
                    f"conservation broke mid-drain: "
                    f"opened={book.opened_n} closed={book.closed_n} "
                    f"open={book.n_open}")
            if tot["requests"] != book.closed_n:
                state["violations"].append(
                    f"closed totals count {tot['requests']} requests, "
                    f"book closed {book.closed_n}")
            book.to_json()
            book.class_rollup()

        opener = [open_charge(r) for r in (1, 2, 3)]
        closer = [close(r) for r in (1, 2, 3)]
        reader = [read] * 3
        return [opener, closer, reader]

    def oracle(self, state):
        book = state["book"]
        # a close scheduled before its open is an idempotent no-op —
        # the request is still open at the end; close the stragglers
        for rid in (1, 2, 3):
            book.close_request(rid, "done")
        problems = list(state["violations"])
        if book.n_open != 0:
            problems.append(f"{book.n_open} ledgers open after drain")
        if book.opened_n != book.closed_n or book.closed_n != 3:
            problems.append(f"ledger conservation broke: "
                            f"opened={book.opened_n} "
                            f"closed={book.closed_n} (want 3)")
        tot = book.grand_totals(include_open=False)
        if tot["tokens"] != 6:
            problems.append(f"charged 2 tokens x3 requests, totals say "
                            f"{tot['tokens']}")
        return problems

    def cleanup(self, state):
        pass


SEAMS = (PoolAdoptSeam, UploadSettleSeam, IngestSweepSeam,
         LedgerDrainSeam)
SEAM_NAMES = tuple(s.name for s in SEAMS)


# -- running the seams ---------------------------------------------------


def run_seam(seam, seed: int, target: int, max_exhaustive: int,
             cap: int) -> dict:
    probe = seam.make_state()
    counts = tuple(len(d) for d in seam.ops(probe))
    seam.cleanup(probe)
    total = n_interleavings(counts)
    if total <= max_exhaustive:
        schedules = list(exhaustive_schedules(counts))
        mode = "exhaustive"
    else:
        schedules = sampled_schedules(counts, target, seed)
        mode = "sampled"
    digest = schedule_digest(schedules)
    if cap:
        schedules = schedules[:cap]
    failures = []
    for sched in schedules:
        state = seam.make_state()
        try:
            domains = seam.ops(state)
            cursors = [0] * len(domains)
            for d in sched:
                domains[d][cursors[d]]()
                cursors[d] += 1
            problems = seam.oracle(state)
        except Exception as e:  # noqa: BLE001 - a crash IS a finding
            problems = [f"schedule raised {type(e).__name__}: {e}"]
        finally:
            seam.cleanup(state)
        if problems:
            failures.append({"schedule": list(sched),
                             "problems": problems})
            if len(failures) >= 5:
                break
    return {"ops": list(counts), "interleavings": total, "mode": mode,
            "explored": len(schedules), "digest": digest,
            "failures": len(failures),
            "first_failures": failures[:2]}


def run(seed: int = 0, seams=None, inject: str | None = None,
        target: int = 120, max_exhaustive: int = 512,
        cap: int = 0, device: str = "cuda") -> dict:
    """The whole gate as a callable (tests import this). Returns the
    JSON row; row["ok"] is the exit-0 condition."""
    rows = {}
    for cls in SEAMS:
        if seams and cls.name not in seams:
            continue
        seam = (cls(inject, device) if cls is IngestSweepSeam
                else cls(inject))
        try:
            rows[cls.name] = run_seam(seam, seed, target,
                                      max_exhaustive, cap)
        finally:
            if hasattr(seam, "close"):
                seam.close()
    return {"kind": "racecheck", "seed": seed, "inject": inject,
            "target": target, "seams": rows,
            "ok": all(r["failures"] == 0 for r in rows.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="racecheck", description="deterministic interleaving race "
        "gate over the host-runtime seams")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seam", action="append", choices=SEAM_NAMES,
                    help="run only these seams (repeatable)")
    ap.add_argument("--inject", choices=INJECTIONS, default=None,
                    help="arm a seeded mutation (the gate must exit 1)")
    ap.add_argument("--target", type=int, default=120,
                    help="distinct schedules for sampled seams")
    ap.add_argument("--max-exhaustive", type=int, default=512,
                    help="enumerate every schedule up to this many")
    ap.add_argument("--cap", type=int, default=0,
                    help="execute at most N schedules per seam "
                         "(0 = all; tests use this to stay fast)")
    ap.add_argument("--list", action="store_true",
                    help="print the seam names and exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ingest_sweep seam's engine runs "
                         "(default the card)")
    args = ap.parse_args(argv)
    if args.list:
        for n in SEAM_NAMES:
            print(n)
        return 0
    if args.target < 1 or args.max_exhaustive < 1 or args.cap < 0:
        print("racecheck: --target/--max-exhaustive must be >= 1, "
              "--cap >= 0", file=sys.stderr)
        return 2
    if not require_device("racecheck", args.device):
        return 1
    row = run(seed=args.seed, seams=args.seam, inject=args.inject,
              target=args.target, max_exhaustive=args.max_exhaustive,
              cap=args.cap, device=args.device)
    for name, r in row["seams"].items():
        verdict = ("ok" if r["failures"] == 0
                   else f"{r['failures']} FAILING schedule(s)")
        print(f"racecheck: {name} {r['mode']} {r['explored']}/"
              f"{r['interleavings']} schedule(s) [{r['digest']}] "
              f"{verdict}", file=sys.stderr)
        for f in r["first_failures"]:
            for p in f["problems"][:3]:
                print(f"racecheck:   {name} schedule "
                      f"{f['schedule']}: {p}", file=sys.stderr)
    print(json.dumps(row, sort_keys=True))
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
