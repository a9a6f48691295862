"""Thread-safe in-process metrics: counters, gauges, fixed-bucket histograms.

The reference's only observability is the end-of-run benchmark line
(tokenizer.cpp:381); a serving system needs live instruments. This registry
is stdlib-only (no prometheus_client dependency) and exposes the Prometheus
text format (version 0.0.4) so any scraper can consume `GET /metrics`
(runtime/server.py) or a one-shot dump (`--metrics` CLI runs).

Design constraints:
* every mutation is O(1) under one registry-wide lock — the instruments are
  written from the scheduler thread, HTTP handler threads, and the stream.py
  fetch loop concurrently (tests/test_obs.py pins exactness under racing
  writers);
* histograms use FIXED bucket bounds chosen at creation: observation is a
  bisect, exposition is a cumulative walk, and percentiles come from linear
  interpolation inside the winning bucket — good enough for p50/p95/p99
  health summaries without storing samples;
* collection is opt-in at the call site: the hot paths hold a reference that
  is None when metrics are disabled, so a disabled run makes ZERO registry
  calls (the acceptance gate in tests/test_obs.py).
"""

from __future__ import annotations

import bisect
import math
import threading

# Default bounds for latency-shaped histograms (seconds). Spans 1 ms (a
# fused CPU step) to 60 s (a cold-compile first step) in roughly 2.5x hops.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Throughput-shaped bounds (tokens/s): 0.1 .. 10k in decade-ish hops.
RATE_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                250.0, 500.0, 1000.0, 2500.0, 10000.0)

# Small-integer bounds (batch occupancy, queue depth).
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _render_labels(labels) -> str:
    """``{k="v",...}`` suffix for a (key, value) pair tuple; "" when
    unlabeled. Pairs render SORTED by key — the label set is the series
    identity, so two call sites passing the same labels in different
    order must land on one series (and one exposition line), not two
    that Prometheus rejects as duplicate samples. Values are escaped per
    the exposition format."""
    if not labels:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r'\"'))
        for k, v in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotonic float counter. ``labels`` (a (key, value) pair tuple)
    makes this one SERIES of the metric family ``name`` — exposition
    renders ``name{k="v"} value`` and the Registry emits the family's
    HELP/TYPE header once."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(self, name: str, help: str = "", lock=None, labels=()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> list[str]:
        return [f"{self.name}{_render_labels(self.labels)} "
                f"{_fmt(self.value)}"]


class Gauge:
    """Instantaneous value (set/inc/dec); labeled like Counter."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(self, name: str, help: str = "", lock=None, labels=()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self._value -= v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> list[str]:
        return [f"{self.name}{_render_labels(self.labels)} "
                f"{_fmt(self.value)}"]


class Histogram:
    """Fixed-bucket histogram with sum/count and interpolated percentiles.

    ``buckets`` are the finite upper bounds (sorted, strictly increasing);
    an implicit +Inf bucket catches the rest. Per-bucket counts are stored
    NON-cumulative and accumulated at exposition time (one add per observe,
    not one per bucket).
    """

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "_lock", "_counts",
                 "_sum", "_count")

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = LATENCY_BUCKETS, lock=None, labels=()):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram {name}: buckets must be sorted "
                             f"unique upper bounds, got {buckets!r}")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = lock or threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) by linear interpolation
        inside the winning bucket. The +Inf bucket clamps to the last
        finite bound (there is no upper edge to interpolate toward); an
        empty histogram reports 0.0."""
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(self.buckets):   # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.buckets[-1]

    def summary(self) -> dict:
        """{'count', 'mean', 'p50', 'p95', 'p99'} — the health-line shape
        shared by /health, generate()'s final line, and bench rows."""
        counts, s, total = self.snapshot()
        return {"count": total,
                "mean": (s / total) if total else 0.0,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}

    def expose(self) -> list[str]:
        counts, s, total = self.snapshot()
        suffix = _render_labels(self.labels)
        out, cum = [], 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f'{self.name}_bucket'
                       f'{_render_labels(self.labels + (("le", _fmt(b)),))}'
                       f' {cum}')
        cum += counts[-1]
        out.append(f'{self.name}_bucket'
                   f'{_render_labels(self.labels + (("le", "+Inf"),))}'
                   f' {cum}')
        out.append(f"{self.name}_sum{suffix} {_fmt(s)}")
        out.append(f"{self.name}_count{suffix} {total}")
        return out


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without a trailing .0."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Registry:
    """Named metric store with get-or-create accessors and text exposition.

    One lock guards the name table; each instrument carries its own lock
    for value mutation (a scrape never blocks writers for long). Accessors
    are idempotent — asking for an existing name returns the existing
    instrument; a kind or bucket mismatch raises (two call sites silently
    disagreeing about a metric is a bug, not a fallback).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}  # series key -> instrument, insertion-ordered
        self._family_kind: dict = {}  # family name -> kind string

    def _get_or_create(self, cls, name: str, help: str, labels=(), **kw):
        key = name + _render_labels(labels)
        with self._lock:
            # kind consistency is a FAMILY property, labels or not: a
            # counter series and a gauge series under one name would
            # expose the second under the first's TYPE header
            have = self._family_kind.setdefault(name, cls.kind)
            if have != cls.kind:
                raise ValueError(f"metric family {name} already registered "
                                 f"as {have}, requested {cls.kind}")
            m = self._metrics.get(key)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(f"metric {key} already registered as "
                                     f"{m.kind}, requested {cls.kind}")
                want = kw.get("buckets")
                if want is not None and tuple(
                        float(b) for b in want) != m.buckets:
                    raise ValueError(f"histogram {key} already registered "
                                     f"with different buckets")
                return m
            if labels:
                m = cls(name, help, labels=labels, **kw)
            else:
                m = cls(name, help, **kw)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def labeled_counter(self, name: str, labels: dict,
                        help: str = "") -> Counter:
        """One labeled series of the counter family ``name`` (e.g.
        dllama_ici_collectives_total{kind="psum",scheme="fused"})."""
        return self._get_or_create(Counter, name, help,
                                   labels=tuple(labels.items()))

    def labeled_gauge(self, name: str, labels: dict,
                      help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help,
                                   labels=tuple(labels.items()))

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def labeled_histogram(self, name: str, labels: dict, help: str = "",
                          buckets: tuple = LATENCY_BUCKETS) -> Histogram:
        """One labeled series of the histogram family ``name`` (e.g.
        dllama_request_queue_wait_by_class_seconds{class="batch"});
        the ``le`` bucket label merges into the series label set at
        exposition."""
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   labels=tuple(labels.items()))

    def get(self, name: str):
        """Look up a series by its key: the bare name, or
        ``name{k="v",...}`` for labeled series."""
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition (format version 0.0.4). All series
        of a metric FAMILY are emitted as one group under a single
        HELP/TYPE header (the exposition grouping rule — parsers split
        interleaved families into duplicate, untyped ones), families in
        first-registration order."""
        with self._lock:
            metrics = list(self._metrics.values())
        families: dict = {}  # name -> [instruments], first-seen order
        for m in metrics:
            families.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name, members in families.items():
            first = members[0]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            lines.append(f"# TYPE {name} {first.kind}")
            for m in members:
                lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")


def summarize_values(values, unit_scale: float = 1.0) -> dict:
    """Exact {'count','mean','p50','p95','p99'} from a raw value list —
    the SAME summary shape Histogram.summary() reports, for call sites
    that already hold every sample (generate()'s per-token ms list,
    bench.py's trial times). ``unit_scale`` multiplies values on the way
    in (e.g. 1e-3 to report a ms list in seconds)."""
    vals = sorted(float(v) * unit_scale for v in values)
    if not vals:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}

    def pct(q: float) -> float:
        # nearest-rank with linear interpolation (numpy 'linear' method)
        idx = q * (len(vals) - 1)
        lo = int(math.floor(idx))
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (idx - lo)

    return {"count": len(vals), "mean": sum(vals) / len(vals),
            "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}
