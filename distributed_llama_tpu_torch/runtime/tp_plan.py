"""Serving over tensor-parallel ranks: rank 0 decides, the other ranks
follow (the port's own module; the JAX server is one controller over a
mesh and needs none).

The port's tp ranks are processes. Under ``serve --tp N`` rank 0 runs the
listener, the handlers, the journal, the SLO books, the watchdog, the
chaos monkey and every scheduling decision; ranks 1..N-1 run
``follow_loop``, with no listener. Before each dispatch rank 0 sends a
``DispatchPlan`` and only then launches; a follower receives it, applies
it to its engine and runs the same dispatch, so the dispatch's
collectives meet.

What a plan carries is everything rank 0's engine took in from outside
since the previous dispatch: the admissions (request id, prompt tokens,
steps, temperature and top-p, the per-request seed, the SLO class, the
journal's coin cursor), the cancellations, the shipped pages to adopt
(the decode role of a disaggregated pair), the page exports to gather
(the prefill role), and the shutdown. Handler threads on rank 0 never
touch the engine's queue directly under tp: ``submit`` and ``cancel``
land in an intake that only the plan point drains, so rank 0's engine
sees each input at the same point of its schedule as every follower.
Everything else a dispatch decides (which slot admits, the drafts, the
mixed slice's cut, preemptions, tier demotions and promotions, the chaos
hooks' faults) is a function of those inputs and of the host books, and
every rank computes it from the same books. A follower reads no clock,
no random source and no queue of its own to decide anything: its queue
holds only what plans put there, and its chaos monkey is a copy of rank
0's with the sleeps off.

Each plan also carries ``digest``: a hash of rank 0's host books after
the previous dispatch (the slot table, the page tables, the free list,
the prefix tree with each node's tier, the queue, the chaos counters).
A follower compares it with its own before applying the plan and raises
on a difference, so a silent parting becomes an error at the next
dispatch.

The plans travel on a gloo side group (``PlanChannel``, made with
``new_group(backend="gloo")`` even when the model's group is NCCL), so a
plan never queues behind a collective; rank 0's send waits at most the
channel's timeout, and a follower waits for the next plan as long as the
server stays up. Rank 0 sends a plan only when it dispatches (an idle
server sends none). A follower that dies makes rank 0's next send or
collective fail; the server then fails every pending request and exits
non-zero.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import pickle
import time
from typing import Any

import numpy as np
import torch

from .paging import TIER_DISK, TIER_HBM, TIER_HOST

DEFAULT_TIMEOUT_S = 60.0
# how long a follower waits for the next plan: an idle server sends none
FOLLOWER_WAIT_S = 7 * 24 * 3600.0


@dataclasses.dataclass
class DispatchPlan:
    seq: int
    op: str = "step"  # "step" | "shutdown"
    steps: int = 1  # the step_many chain length
    admissions: list = dataclasses.field(default_factory=list)
    cancels: list = dataclasses.field(default_factory=list)
    # (tokens, planes, admission) of each shipped handoff
    remote: list = dataclasses.field(default_factory=list)
    exports: list = dataclasses.field(default_factory=list)  # token lists
    digest: str = ""


ADMISSION_FIELDS = ("index", "tokens", "steps", "temperature", "topp",
                    "seed", "slo_class", "coin_cursor")


def admission(req) -> dict:
    """The fields of a request a follower's engine schedules by."""
    return {f: getattr(req, f) for f in ADMISSION_FIELDS}


def mirror_request(fields: dict):
    """A follower's copy of rank 0's request: the same id (its seed
    offset), prompt and sampling; ``prejournaled`` keeps the id."""
    from .continuous import Request

    req = Request(tokens=list(fields["tokens"]), steps=fields["steps"],
                  temperature=fields["temperature"], topp=fields["topp"],
                  seed=fields["seed"], slo_class=fields["slo_class"],
                  coin_cursor=fields["coin_cursor"], prejournaled=True)
    req.index = fields["index"]
    return req


_TIER_CODE = {TIER_HBM: 0, TIER_HOST: 1, TIER_DISK: 2}


def books_digest(engine) -> str:
    """A hash of the engine's host books: every slot's request id,
    clock, next token, forced tokens left, budget and pages; the queue;
    the allocator's free list, refcounts and prefix tree (each node's
    page, tier, recency and pending flag); the chaos counters."""
    h = hashlib.blake2b(digest_size=16)
    rows = []
    for s in engine._pool:
        rows.append((-1,) if s.free else (
            s.req.index, s.pos, s.token, len(s.forced), s.budget,
            tuple(s.pages), s.shared, s.await_promo, s.prefill_pending))
    with engine._lock:
        queued = tuple(r.index for r in engine._queue)
    books = [rows, queued, engine.stats.steps, engine.stats.tokens]
    chaos = engine._chaos
    if chaos is not None:
        books.append((chaos.denied_allocs, len(chaos.leaked_pages),
                      chaos.dropped_demotions, chaos.overran_budgets,
                      chaos._dispatches))
    h.update(repr(books).encode())
    alloc = engine.allocator
    if alloc is not None:  # O(pool) ints, hashed as bytes
        flat: list[int] = []
        for n in alloc.tree.nodes():  # the walk's order is the books' too
            flat += (n.page, _TIER_CODE[n.tier], n.last_used, n.pending,
                     n.host_id, len(n.key))
        refs = alloc.pool.refcounts()
        for part in (flat, alloc.pool.free_ids(), sorted(refs),
                     [refs[p] for p in sorted(refs)]):
            h.update(np.asarray(part, np.int64).tobytes())
            h.update(b"|")
    return h.hexdigest()


class PlanDigestError(RuntimeError):
    """A follower's books parted from rank 0's."""


class PlanChannel:
    """Rank 0's plans to every other rank of ``group`` (a TPGroup of size
    > 1), on a gloo side group: two broadcasts a plan, its length and its
    pickled bytes. Every rank of the group constructs it, in the same
    order (``new_group`` is collective)."""

    def __init__(self, group, timeout_s: float = DEFAULT_TIMEOUT_S):
        import torch.distributed as dist

        self._dist = dist
        self.rank = group.rank
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.timeout_s = timeout_s
        self._pg = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=max(timeout_s,
                                                   FOLLOWER_WAIT_S)))
        self.sent = 0
        self.last_digest = ""
        self.closed = False
        # rank 0's plan point, summed over the dispatch plans: the books'
        # digest, the pickling, and the two broadcasts (which wait for
        # the followers to reach their receive)
        self.plan_s = {"digest": 0.0, "pickle": 0.0, "send": 0.0}

    def _bcast(self, t: torch.Tensor, wait: datetime.timedelta | None):
        # dlint: allow[D006] the plan's side group, not a forward
        work = self._dist.broadcast(t, 0, group=self._pg, async_op=True)
        if wait is None:
            work.wait()
        else:
            work.wait(timeout=wait)

    def send(self, plan: DispatchPlan) -> None:
        """Rank 0: one plan to every follower, within the timeout."""
        t0 = time.perf_counter()
        raw = np.frombuffer(pickle.dumps(plan, protocol=5), np.uint8)
        t1 = time.perf_counter()
        self._bcast(torch.tensor([raw.size], dtype=torch.int64),
                    self.timeout)
        self._bcast(torch.from_numpy(raw.copy()), self.timeout)
        if plan.op == "step":  # the dispatch plans (not the shutdown)
            self.sent += 1
            self.last_digest = plan.digest
            # dlint: allow[D008] host tensors: no device work
            self.plan_s["pickle"] += t1 - t0
            # dlint: allow[D008] host tensors: no device work
            self.plan_s["send"] += time.perf_counter() - t1

    def plan_ms(self) -> dict:
        """Rank 0's plan point a dispatch plan, ms: digest, pickle, send."""
        return {k: v / max(self.sent, 1) * 1e3
                for k, v in self.plan_s.items()}

    def send_shutdown(self) -> None:
        """Rank 0: the shutdown plan, once."""
        if not self.closed:
            self.closed = True
            self.send(DispatchPlan(self.sent, op="shutdown"))

    def recv(self) -> DispatchPlan:
        """A follower: the next plan (it waits as long as rank 0 idles)."""
        n = torch.zeros(1, dtype=torch.int64)
        self._bcast(n, None)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._bcast(buf, self.timeout)
        return pickle.loads(buf.numpy().tobytes())


class PlanLeader:
    """Rank 0's side, bound to its engine (ContinuousEngine.bind_plan):
    at each dispatch the engine's intake becomes a plan, which is sent
    and then applied locally."""

    def __init__(self, channel: PlanChannel):
        self.channel = channel
        self.seq = 0

    def dispatch_point(self, engine, steps: int) -> None:
        t0 = time.perf_counter()
        plan = DispatchPlan(self.seq, steps=steps,
                            digest=books_digest(engine))
        self.channel.plan_s["digest"] += time.perf_counter() - t0
        with engine._lock:
            intake, engine._intake = engine._intake, []
            cancels, engine._cancels = engine._cancels, []
            remote, engine._remote_inbox = engine._remote_inbox, []
            exports, engine._export_inbox = engine._export_inbox, []
        for _, _, r in remote:  # ids first: the plan carries them
            engine._register(r)
        plan.admissions = [admission(r) for r in intake]
        plan.cancels = [r.index for r in cancels]
        plan.remote = [(list(t), planes, admission(r))
                       for t, planes, r in remote]
        plan.exports = [list(t) for t, _ in exports]
        self.channel.send(plan)
        self.seq += 1
        engine.apply_plan(intake, cancels, remote, exports)

def follow_loop(engine, channel: PlanChannel, quiet: bool = True) -> int:
    """A follower rank's serving loop: receive a plan, check the digest,
    apply it, run the dispatch; until the shutdown plan. Returns the
    plans followed."""
    known: dict[int, Any] = {}  # id -> the mirrored Request (in flight)
    n = 0
    while True:
        plan = channel.recv()
        if plan.op == "shutdown":
            return n
        mine = books_digest(engine)
        if plan.digest != mine:
            raise PlanDigestError(
                f"rank {channel.rank}: books parted from rank 0's before "
                f"plan {plan.seq} (rank 0 {plan.digest}, here {mine})")
        intake = [mirror_request(f) for f in plan.admissions]
        remote = [(t, planes, mirror_request(f))
                  for t, planes, f in plan.remote]
        for r in intake + [r for _, _, r in remote]:
            known[r.index] = r
        cancels = [known[i] for i in plan.cancels if i in known]
        engine.apply_plan(intake, cancels, remote,
                          [(t, None) for t in plan.exports])
        engine.step_many(plan.steps, quiet=quiet)
        for i in [i for i, r in known.items() if r.done.is_set()]:
            del known[i]
        n += 1
