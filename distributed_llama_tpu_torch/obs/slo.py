"""Declarative SLO specs + per-request verdict tracking (the SLO observatory).

Serving systems are judged on GOODPUT under an SLO at offered load — the
Orca/vLLM evaluation frame — not on per-token microbenchmarks. This module
is the declarative half of that evaluation layer: a policy names
priority classes, each with a TTFT budget and a per-token latency budget,
and every retired request gets exactly one verdict:

* ``met``      — TTFT and per-token latency both within the class budgets;
* ``violated`` — finished, but over at least one budget;
* ``failed``   — the engine errored it (scheduler fault, pool deadlock).

Cancelled requests (the consumer vanished) are EXCLUDED from SLO
accounting: a client hanging up is not a serving-side SLO event, and
their truncated windows would poison attainment the same way
obs/trace.record_retire keeps them out of the latency histograms.

Goodput counts only the sampled tokens of ``met`` requests — throughput
that arrived too late to matter is not throughput. Attainment is
met/attempted per class.

The per-token budget is checked against a request's MEAN sampled-token
latency (finish - first_token over n_sampled); the "p99" in the budget's
name lives at the fleet level: tools/loadcheck.py reports the class p99 of
this per-request statistic next to the budget in every sweep row.

Two evaluation clocks share these exact semantics:

* the engine evaluates WALL time at retire (runtime/continuous.py threads
  a tracker through its lifecycle; verdicts surface as
  ``dllama_slo_requests_total{class,verdict}`` /
  ``dllama_goodput_tokens_total{class}`` and the /health "slo" block);
* tools/loadgen.py's virtual-clock loop calls ``SLOClass.evaluate``
  with step-derived timestamps, so CI's loadcheck gate is deterministic
  on any box.
"""

from __future__ import annotations

import dataclasses
import threading

VERDICTS = ("met", "violated", "failed")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One priority class: a name and its two latency budgets (seconds).

    ``ttft_budget_s`` bounds enqueue -> first SAMPLED token (prompt echo is
    input replay, not generation — the same anchor as the TTFT histogram);
    ``token_budget_s`` bounds the request-mean per-sampled-token latency.
    Non-positive budgets are rejected: an unbounded class should say so
    with an explicitly huge number, not a zero that marks everything
    violated.
    """

    name: str
    ttft_budget_s: float
    token_budget_s: float

    def __post_init__(self):
        if not self.name or any(c in self.name for c in ':,"{}'):
            raise ValueError(f"SLO class name {self.name!r} must be "
                             f"non-empty and label-safe")
        for field in ("ttft_budget_s", "token_budget_s"):
            v = getattr(self, field)
            if not v > 0:
                raise ValueError(f"SLO class {self.name}: {field} must be "
                                 f"> 0, got {v}")

    def evaluate(self, ttft_s: float | None, per_token_s: float | None,
                 failed: bool = False) -> str:
        """The ONE verdict function both clocks share. ``None`` means the
        request never reached that phase (e.g. a budget fully consumed by
        forced prompt echo samples nothing) — an unreached phase cannot
        violate its budget."""
        if failed:
            return "failed"
        if ttft_s is not None and ttft_s > self.ttft_budget_s:
            return "violated"
        if per_token_s is not None and per_token_s > self.token_budget_s:
            return "violated"
        return "met"


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """An ordered set of SLO classes; the FIRST is the default class a
    request lands in when it names none."""

    classes: tuple[SLOClass, ...]

    def __post_init__(self):
        if not self.classes:
            raise ValueError("an SLO policy needs >= 1 class")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")

    @property
    def default_class(self) -> str:
        return self.classes[0].name

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    def rank(self, name: str | None) -> int:
        """Priority rank of a class: its position in the policy's class
        order (0 = highest — the default/interactive class leads by
        convention). The disaggregated router and the engine's
        slo_priority admission order by this, so "routes by class" is
        defined in exactly one place. Unknown names raise via resolve."""
        return self.classes.index(self.resolve(name))

    def resolve(self, name: str | None) -> SLOClass:
        """The class for ``name`` (None -> the default class). Unknown
        names raise — misattributing a verdict to the wrong class
        silently is exactly the kind of drift an observatory exists to
        prevent; the server surfaces this as a 400."""
        if name is None:
            return self.classes[0]
        for c in self.classes:
            if c.name == name:
                return c
        raise ValueError(f"unknown SLO class {name!r} "
                         f"(policy has {list(self.names)})")

    @classmethod
    def parse(cls, text: str) -> "SLOPolicy":
        """``name:ttft_ms:token_ms[,name:ttft_ms:token_ms...]`` — the
        --slo CLI format. Budgets are MILLISECONDS on the wire (the unit
        people quote SLOs in); storage is seconds. First entry = default
        class."""
        out = []
        for part in text.split(","):
            fields = part.strip().split(":")
            if len(fields) != 3:
                raise ValueError(
                    f"bad SLO class spec {part!r}: want "
                    f"name:ttft_ms:token_ms (e.g. interactive:1000:100)")
            name, ttft_ms, tok_ms = fields
            out.append(SLOClass(name, float(ttft_ms) / 1e3,
                                float(tok_ms) / 1e3))
        return cls(tuple(out))

    @classmethod
    def serving_default(cls) -> "SLOPolicy":
        """The server's out-of-the-box policy: one interactive class with
        chat-shaped budgets (TTFT 2 s, 250 ms/token) and a batch class
        that only cares about eventual completion. Override with --slo."""
        return cls((SLOClass("interactive", 2.0, 0.250),
                    SLOClass("batch", 60.0, 5.0)))


def request_lifetimes(req, now: float) -> tuple[float | None, float | None]:
    """(ttft_s, per_token_s) from a Request's monotonic lifecycle stamps
    (runtime/continuous.py sets them) — shared by the tracker below and
    anything else that wants the same decomposition. ``now`` is the
    finish timestamp (t_finish may not be stamped yet mid-retire)."""
    ttft = (req.t_first_token - req.t_enqueue
            if req.t_first_token and req.t_enqueue else None)
    per_token = None
    if req.n_sampled > 0 and req.t_first_token:
        per_token = (now - req.t_first_token) / req.n_sampled
    return ttft, per_token


class SLOTracker:
    """Per-class verdict tallies + goodput, optionally mirrored into a
    metrics Registry as labeled series. One tracker per engine; writes
    come from the scheduler thread, reads from /health handler threads —
    a single lock keeps the snapshot consistent.

    Registry series (pre-registered at creation so a fresh scrape already
    shows the full matrix at zero):

    * ``dllama_slo_requests_total{class,verdict}`` — one series per
      (class, verdict) cell;
    * ``dllama_goodput_tokens_total{class}`` — sampled tokens of met
      requests only.
    """

    def __init__(self, policy: SLOPolicy, registry=None):
        self.policy = policy
        self._lock = threading.Lock()
        self._counts = {c.name: dict.fromkeys(VERDICTS, 0)
                        for c in policy.classes}
        self._goodput = dict.fromkeys(policy.names, 0)
        self._series: dict = {}
        self._goodput_series: dict = {}
        if registry is not None:
            for c in policy.classes:
                for verdict in VERDICTS:
                    self._series[(c.name, verdict)] = \
                        registry.labeled_counter(
                            "dllama_slo_requests_total",
                            {"class": c.name, "verdict": verdict},
                            "Retired requests by SLO class and verdict "
                            "(met/violated/failed; cancelled excluded)")
                self._goodput_series[c.name] = registry.labeled_counter(
                    "dllama_goodput_tokens_total", {"class": c.name},
                    "Sampled tokens of SLO-met requests (goodput — "
                    "late throughput is not throughput)")

    def observe(self, cls_name: str | None, ttft_s: float | None,
                per_token_s: float | None, tokens: int,
                failed: bool = False) -> str:
        """Record one retired request; returns its verdict. ``tokens`` is
        the request's sampled-token count (goodput contribution when
        met)."""
        c = self.policy.resolve(cls_name)
        verdict = c.evaluate(ttft_s, per_token_s, failed=failed)
        with self._lock:
            self._counts[c.name][verdict] += 1
            if verdict == "met":
                self._goodput[c.name] += tokens
        series = self._series.get((c.name, verdict))
        if series is not None:
            series.inc()
        if verdict == "met" and tokens:
            goodput = self._goodput_series.get(c.name)
            if goodput is not None:
                goodput.inc(tokens)
        return verdict

    def observe_request(self, req, now: float) -> str | None:
        """The engine's retire hook: derive the lifecycle split from the
        Request stamps and record. Cancelled requests record nothing
        (module docstring)."""
        if req.cancelled:
            return None
        ttft, per_token = request_lifetimes(req, now)
        return self.observe(req.slo_class, ttft, per_token,
                            req.n_sampled, failed=req.error is not None)

    def snapshot(self) -> dict:
        """The /health "slo" block (and loadcheck's attainment source):
        per-class attempted/met/violated/failed + attainment + goodput
        tokens, plus the policy budgets so a scrape is self-describing."""
        with self._lock:
            counts = {k: dict(v) for k, v in self._counts.items()}
            goodput = dict(self._goodput)
        classes = {}
        for c in self.policy.classes:
            n = counts[c.name]
            attempted = sum(n.values())
            classes[c.name] = {
                "attempted": attempted,
                **n,
                "attainment": round(n["met"] / attempted, 4)
                if attempted else 1.0,
                "goodput_tokens": goodput[c.name],
                "ttft_budget_s": c.ttft_budget_s,
                "token_budget_s": c.token_budget_s,
            }
        return {"classes": classes,
                "goodput_tokens_total": sum(goodput.values())}
