"""Crash-forensics flight recorder: an always-on bounded ring dumped as a
postmortem bundle at the moments that need one.

The observability stack built so far answers questions about a LIVE
process — /metrics, /health, /debug/timeline all vanish with the server.
This module is the black box that survives it: a cheap in-memory ring of
operational events (watchdog trips, health transitions, drain progress,
handoff failures) plus, at dump time, a snapshot of everything a
postmortem wants on one page:

* the recent span timeline (obs/spans.SpanTracer — the last N step/
  chain/request/prefill windows, trace ids included, ring-overflow count
  honest);
* the metrics registry's full Prometheus exposition text;
* the journal TAIL (the last records the WAL made durable — exactly
  what the next process will recover from);
* the serving-config fingerprint (runtime/journal.config_fingerprint
  when a journal carries one) + the utils/fingerprint run stamp.

Dump triggers (runtime/server.py / runtime/supervisor.py wire them):
the step watchdog firing, the SIGTERM graceful drain, and a crash-loop
restart in ``supervise()``. Bundles are one JSON file each, validated
by ``validate_bundle`` and loadable by ``tools/tracecheck.py`` — a
malformed bundle must fail CI, not be discovered dead mid-incident.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

BUNDLE_KIND = "dllama-flightrec"
BUNDLE_VERSION = 1
# dump reasons the server/supervisor use; free-form reasons are legal
# (the bundle is a diagnostic, not a schema prison) but these four are
# the wired triggers
REASON_WATCHDOG = "watchdog"
REASON_SIGTERM = "sigterm_drain"
REASON_CRASH_LOOP = "crash_loop"
REASON_INCIDENT = "incident"  # watchtower detector fired


class FlightRecorder:
    """The always-on ring + bundle dumper (module docstring).

    ``note()`` is cheap enough to call from fault paths (one deque
    append under a lock, no I/O); everything expensive happens at
    ``dump()`` time — which runs at most a handful of times per process
    life, on paths that are already catastrophic."""

    def __init__(self, capacity: int = 512, registry=None, spans=None,
                 journal_path: str | None = None,
                 config: dict | None = None, tail_lines: int = 64,
                 max_spans: int = 1024):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(capacity, 1))
        self._registry = registry
        self._spans = spans
        self._census = None
        self._ledgers = None
        self.journal_path = journal_path
        self.config = dict(config) if config else {}
        self.tail_lines = tail_lines
        self.max_spans = max_spans
        self.dumps = 0  # bundles written by this recorder

    def bind(self, registry=None, spans=None,
             journal_path: str | None = None,
             config: dict | None = None, census=None,
             ledgers=None) -> None:
        """Late attachment: the server builds the recorder before the
        engine exists (notes from construction must not be lost) and
        binds the span tracer / journal path once they do. ``census``
        (obs/ledger.CensusRing) and ``ledgers`` (obs/ledger.LedgerBook)
        put the scheduler's dispatch tail and the mid-flight requests'
        bills into the postmortem."""
        if registry is not None:
            self._registry = registry
        if spans is not None:
            self._spans = spans
        if journal_path is not None:
            self.journal_path = journal_path
        if config:
            self.config.update(config)
        if census is not None:
            self._census = census
        if ledgers is not None:
            self._ledgers = ledgers

    def note(self, event: str, **fields) -> None:
        """Record one operational event into the ring (wall-clock
        stamped — postmortems correlate with external logs, so unlike
        span timelines this wants absolute time)."""
        rec = {"ts": round(time.time(), 6), "event": str(event)}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)

    def _journal_tail(self) -> list:
        """The last ``tail_lines`` journal records, raw (the WAL's own
        NDJSON lines — what recovery will actually read). Best-effort:
        a missing/unreadable journal yields [] rather than killing the
        dump path that exists to survive exactly such states."""
        if not self.journal_path:
            return []
        try:
            with open(self.journal_path, "rb") as fh:
                # journals compact, so reading the whole file is bounded;
                # still cap the read defensively at 4 MiB from the end
                try:
                    fh.seek(-4 << 20, os.SEEK_END)
                except OSError:
                    pass  # shorter than the cap: read from the start
                data = fh.read()
        except OSError:
            return []
        lines = data.split(b"\n")
        tail = [ln.decode("utf-8", "replace")
                for ln in lines if ln.strip()][-self.tail_lines:]
        return tail

    def snapshot_bundle(self, reason: str,
                        incident_kind: str | None = None) -> dict:
        """Assemble the postmortem bundle object (dump() writes it).
        ``incident_kind`` stamps the watchtower detector that triggered
        an incident dump into the header (absent on every
        other trigger — old bundles stay valid)."""
        from ..utils.fingerprint import run_stamp

        with self._lock:
            events = list(self._events)
        spans = []
        spans_dropped = 0
        if self._spans is not None:
            for s in self._spans.snapshot()[-self.max_spans:]:
                rec = {"span": s.name, "cat": s.cat,
                       "t_start_s": round(s.t_start - self._spans.epoch, 6),
                       "dur_ms": round(s.dur_s * 1e3, 3),
                       "tid": s.tid, "depth": s.depth}
                rec.update(s.meta)
                spans.append(rec)
            spans_dropped = self._spans.dropped
        metrics = ""
        if self._registry is not None:
            try:
                metrics = self._registry.expose()
            except Exception as e:  # noqa: BLE001 - a broken registry is
                metrics = f"# EXPOSITION FAILED: {e}"  # itself a finding
        try:
            stamp = run_stamp()
        except Exception:  # noqa: BLE001 - the stamp must never kill a dump
            stamp = {}
        bundle = {
            "kind": BUNDLE_KIND, "version": BUNDLE_VERSION,
            "reason": str(reason), "ts": round(time.time(), 6),
            "pid": os.getpid(),
            **({"incident_kind": str(incident_kind)}
               if incident_kind is not None else {}),
            "config": dict(self.config),
            "stamp": stamp,
            "events": events,
            "spans": spans,
            "spans_dropped": spans_dropped,
            "metrics": metrics,
            "journal_tail": self._journal_tail(),
        }
        # scheduler forensics: the census ring tail (what was
        # the engine dispatching when it died) and the OPEN ledgers (who
        # was mid-flight, holding what). Best-effort like the journal
        # tail — the dump path must survive a broken engine.
        if self._census is not None:
            try:
                bundle["census_tail"] = self._census.tail(self.tail_lines)
            except Exception:  # noqa: BLE001 - never kill a dump
                bundle["census_tail"] = []
        if self._ledgers is not None:
            try:
                bundle["open_ledgers"] = self._ledgers.open_snapshots()
            except Exception:  # noqa: BLE001 - never kill a dump
                bundle["open_ledgers"] = []
        return bundle

    def dump(self, target: str, reason: str,
             incident_kind: str | None = None) -> str:
        """Write one bundle file and return its path. ``target`` is a
        directory (bundles get a reason/pid/sequence name so repeated
        dumps never clobber each other) or an explicit .json path.
        Write-then-rename so a crash mid-dump never leaves a torn
        bundle wearing a valid name."""
        # claim the sequence number under the lock: concurrent dumps
        # (watchdog trip racing an operator SIGUSR2) must not collide on
        # a filename or lose a count (threadcheck T001)
        with self._lock:
            self.dumps += 1
            seq = self.dumps
        if target.endswith(".json"):
            path = target
            parent = os.path.dirname(os.path.abspath(path))
        else:
            parent = target
            path = os.path.join(
                target,
                f"flightrec-{reason}-{os.getpid()}-{seq}.json")
        os.makedirs(parent, exist_ok=True)
        bundle = self.snapshot_bundle(reason, incident_kind=incident_kind)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh)
            fh.write("\n")
        os.replace(tmp, path)
        return path


def validate_bundle(obj) -> None:
    """Schema-check a bundle object: raises ValueError naming the first
    problem (the tracecheck/CI gate — a postmortem artifact discovered
    malformed DURING an incident is worse than none)."""
    if not isinstance(obj, dict):
        raise ValueError("flight-recorder bundle must be a JSON object")
    if obj.get("kind") != BUNDLE_KIND:
        raise ValueError(f"not a {BUNDLE_KIND} bundle "
                         f"(kind={obj.get('kind')!r})")
    if obj.get("version") != BUNDLE_VERSION:
        raise ValueError(f"bundle version {obj.get('version')!r}, this "
                         f"build reads {BUNDLE_VERSION}")
    if not isinstance(obj.get("reason"), str) or not obj["reason"]:
        raise ValueError("bundle missing a 'reason' string")
    if not isinstance(obj.get("ts"), (int, float)):
        raise ValueError("bundle missing a numeric 'ts'")
    for key in ("events", "spans", "journal_tail"):
        if not isinstance(obj.get(key), list):
            raise ValueError(f"bundle '{key}' must be an array")
    for i, ev in enumerate(obj["events"]):
        if not isinstance(ev, dict) or not isinstance(ev.get("event"), str):
            raise ValueError(f"events[{i}]: not an event object")
    for i, sp in enumerate(obj["spans"]):
        if not isinstance(sp, dict) or not isinstance(sp.get("span"), str):
            raise ValueError(f"spans[{i}]: not a span record")
        if not isinstance(sp.get("dur_ms"), (int, float)):
            raise ValueError(f"spans[{i}]: missing numeric dur_ms")
    if not isinstance(obj.get("metrics"), str):
        raise ValueError("bundle 'metrics' must be the exposition text")
    if not isinstance(obj.get("config"), dict):
        raise ValueError("bundle 'config' must be an object")
    if not isinstance(obj.get("spans_dropped"), int):
        raise ValueError("bundle missing integer 'spans_dropped'")
    # the incident header stamp: validate-if-present so
    # bundles from pre-watchtower builds stay loadable (same version)
    kind = obj.get("incident_kind")
    if "incident_kind" in obj and (not isinstance(kind, str) or not kind):
        raise ValueError("bundle 'incident_kind' must be a non-empty "
                         "string when present")
    # scheduler-forensics sections: validate-if-present so
    # bundles from builds without them stay loadable (same version)
    for key in ("census_tail", "open_ledgers"):
        if key in obj:
            if not isinstance(obj[key], list):
                raise ValueError(f"bundle '{key}' must be an array")
            for i, rec in enumerate(obj[key]):
                if not isinstance(rec, dict):
                    raise ValueError(f"{key}[{i}]: not an object")


def load_bundle(path: str) -> dict:
    """Read + validate one bundle file. OSError/ValueError propagate —
    callers decide between usage error and gate failure."""
    with open(path, encoding="utf-8") as fh:
        obj = json.load(fh)
    validate_bundle(obj)
    return obj


def is_bundle_file(path: str) -> bool:
    """Cheap sniff (tools/tracecheck.py routes on it): a .json file whose
    object says it is a flight-recorder bundle."""
    if not (os.path.isfile(path) and path.endswith(".json")):
        return False
    try:
        with open(path, encoding="utf-8") as fh:
            head = json.load(fh)
    except (OSError, ValueError):
        return False
    return isinstance(head, dict) and head.get("kind") == BUNDLE_KIND
