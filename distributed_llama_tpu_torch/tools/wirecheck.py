"""wirecheck skew matrix: the port speaks the wire formats byte for byte
and reads every N-1 sample of the golden corpus (tests/fixtures/wire/)
(the port's copy of the top-level tools/wirecheck.py, over the port's
producers and readers).

Three claims, per format:

  round-trip   the port's producers give the current-era (v2) samples
               byte for byte (tools/make_wire_corpus.py's functions), and
               decode then encode is identity on framed records;
  skew         the port's readers (journal load, entry_from_wire,
               pagewire decode, the fleet /health and /metrics parsers,
               flightrec validate) extract the pinned values from the
               legacy-era (v1) samples;
  damage       corrupted pagewire frames decode to None.

Output: one fingerprint-stamped JSON row (--json) or human lines.
Exit 0 = matrix clean; 1 = a check failed; 2 = usage error.

Mutation arms (each exits exactly 1):
  --inject skew-reader          rename two legacy fields in memory
                                (handoff 'cursor', health 'pages_free')
                                before the readers run;
  --inject drop-registry-field  run the static wirecheck head with
                                journal.admit's 'cursor' deleted from the
                                port's registry: its producers become
                                unregistered-key writers.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
from pathlib import Path

from ..obs.flightrec import validate_bundle
from ..obs.fleet import (ReplicaSignals, apply_metrics, parse_metrics,
                         signals_from_health)
from ..obs.tracectx import parse_header
from ..runtime.journal import (_load_file, config_fingerprint,
                               entry_from_wire, entry_to_wire, load_journal)
from ..runtime.pagewire import decode_record, encode_record
from ..utils.fingerprint import run_stamp
from . import make_wire_corpus as corpus

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent
DEFAULT_CORPUS = os.path.join(REPO_ROOT, "tests", "fixtures", "wire")


class Matrix:
    """Collects check rows; a check body that raises is itself a FAIL
    (a reader that crashes on a legacy sample is exactly the skew this
    gate exists to catch)."""

    def __init__(self):
        self.rows = []

    def check(self, fmt: str, era: str, name: str, fn) -> None:
        try:
            detail = fn()
            self.rows.append({"format": fmt, "era": era, "check": name,
                              "ok": True,
                              "detail": detail or "ok"})
        except Exception as exc:  # noqa: BLE001 — every failure is data
            self.rows.append({"format": fmt, "era": era, "check": name,
                              "ok": False,
                              "detail": f"{type(exc).__name__}: {exc}"})

    @property
    def failed(self) -> int:
        return sum(1 for r in self.rows if not r["ok"])


def _expect(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _pin(actual, want, what: str) -> None:
    if actual != want:
        raise AssertionError(f"{what}: got {actual!r}, want {want!r}")


def _read(path: str, binary: bool = False):
    mode = "rb" if binary else "r"
    kw = {} if binary else {"encoding": "utf-8"}
    with open(path, mode, **kw) as fh:
        return fh.read()


# ----------------------------------------------------------- the matrix
def _check_journal(m: Matrix, cdir: str, era: str) -> None:
    d = os.path.join(cdir, "journal", era)
    wal = os.path.join(d, "journal.wal")
    exp = _expect(os.path.join(d, "expect.json"))

    def replay():
        entries = load_journal(wal)
        by_rid = {e.rid: e for e in entries}
        live = sorted(e.rid for e in entries if e.status is None)
        _pin(live, exp["live_rids"], "live rids")
        for rid, status in exp["retired"].items():
            _pin(by_rid[int(rid)].status, status, f"rid {rid} status")
        for rid, sampled in exp.get("sampled", {}).items():
            _pin(by_rid[int(rid)].sampled, sampled,
                 f"rid {rid} sampled")
        for rid, cur in exp.get("cursor", {}).items():
            _pin(by_rid[int(rid)].cursor, cur, f"rid {rid} cursor")
        for rid, tr in exp.get("trace", {}).items():
            _pin(by_rid[int(rid)].trace, tr, f"rid {rid} trace")
        for rid in exp.get("has_trace", ()):
            if not isinstance(by_rid[int(rid)].trace, str):
                raise AssertionError(f"rid {rid} lost its trace")
        for rid in exp.get("ledger_rids", ()):
            if not isinstance(by_rid[int(rid)].ledger, dict):
                raise AssertionError(f"rid {rid} lost its ledger")
        return f"{len(entries)} entr(ies), {len(live)} live"

    m.check("journal", era, "replay-pins", replay)

    def header():
        _entries, _valid, header_cfg = _load_file(wal)
        if era == "v1":
            _pin(header_cfg, None, "legacy header config")
            return "headerless legacy config"
        want = corpus.build_fingerprint_v2()
        _pin(header_cfg, want, "journaled fingerprint vs current")
        return "fingerprint matches current build"

    m.check("journal", era, "header-config", header)

    if era == "v2":
        def regen():
            tmp = os.path.join(d, ".regen.wal")
            try:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                corpus.build_journal_v2(tmp)
                if _read(tmp, binary=True) != _read(wal, binary=True):
                    raise AssertionError(
                        "current RequestJournal bytes drifted from "
                        "the checked-in corpus")
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            return "byte-identical regeneration"

        m.check("journal", era, "regenerate", regen)


def _check_handoff(m: Matrix, cdir: str, era: str,
                   inject_skew: bool) -> None:
    d = os.path.join(cdir, "handoff", era)
    raw = _read(os.path.join(d, "record.json"), binary=True)
    exp = _expect(os.path.join(d, "expect.json"))
    rec = json.loads(raw)
    if inject_skew and era == "v2":
        rec["cur"] = rec.pop("cursor")  # simulated field rename
        raw = json.dumps(rec, separators=(",", ":")).encode()

    def decode():
        e = entry_from_wire(rec)
        _pin(e.rid, exp["rid"], "rid")
        _pin(e.replay_tokens, exp["replay_tokens"], "replay_tokens")
        _pin(e.cursor, exp["cursor"], "cursor")
        if "trace" in exp:
            _pin(e.trace, exp["trace"], "trace")
        if exp.get("has_trace"):
            if not isinstance(e.trace, str):
                raise AssertionError("handoff lost its trace")
        if "ledger" in exp:
            _pin(e.ledger, exp["ledger"], "ledger")
        if "ledger_tokens" in exp:
            _pin((e.ledger or {}).get("tokens"), exp["ledger_tokens"],
                 "ledger tokens")
        return "decoded + pinned"

    m.check("handoff", era, "decode-pins", decode)

    if era == "v2":
        def roundtrip():
            again = json.dumps(entry_to_wire(entry_from_wire(rec)),
                               separators=(",", ":")).encode()
            if again != raw:
                raise AssertionError(
                    "entry_to_wire∘entry_from_wire is not identity "
                    "on the corpus record")
            return "codec round-trip byte-identical"

        m.check("handoff", era, "codec-roundtrip", roundtrip)

        def regen():
            if corpus.build_handoff_v2() != raw:
                raise AssertionError("entry_to_wire bytes drifted")
            return "byte-identical regeneration"

        m.check("handoff", era, "regenerate", regen)


def _check_pagewire(m: Matrix, cdir: str) -> None:
    d = os.path.join(cdir, "pagewire", "v1")
    exp = _expect(os.path.join(d, "expect.json"))
    for kind in ("f32", "q8"):
        frame = _read(os.path.join(d, f"{kind}.bin"), binary=True)
        want = exp[kind]

        def decode(frame=frame, want=want):
            planes = decode_record(frame)
            if planes is None:
                raise AssertionError("frame decoded to None")
            _pin(len(planes), want["n_planes"], "plane count")
            _pin([list(p.shape) for p in planes], want["shapes"],
                 "shapes")
            _pin([p.dtype.str for p in planes], want["dtypes"],
                 "dtypes")
            _pin(sum(p.nbytes for p in planes),
                 want["payload_bytes"], "payload bytes")
            if encode_record(planes) != frame:
                raise AssertionError(
                    "encode_record∘decode_record is not identity")
            return "decode + re-encode byte-identical"

        m.check("pagewire", f"v1/{kind}", "codec-roundtrip", decode)

        def damage(frame=frame):
            bad = bytearray(frame)
            bad[-1] ^= 0xFF  # flip a payload byte: CRC must catch it
            if decode_record(bytes(bad)) is not None:
                raise AssertionError("damaged frame decoded non-None")
            if decode_record(frame[:len(frame) // 2]) is not None:
                raise AssertionError("truncated frame decoded non-None")
            return "damage -> None"

        m.check("pagewire", f"v1/{kind}", "damage-rejected", damage)


def _check_health(m: Matrix, cdir: str, era: str,
                  inject_skew: bool) -> None:
    d = os.path.join(cdir, "health", era)
    payload = _expect(os.path.join(d, "health.json"))
    exp = _expect(os.path.join(d, "expect.json"))
    if inject_skew and era == "v1" and "paged_kv" in payload:
        payload["paged_kv"]["free_pages"] = (
            payload["paged_kv"].pop("pages_free"))

    def parse():
        row = signals_from_health("corpus", payload)
        _pin(row.schema, exp["schema"], "schema")
        _pin(sorted(row.present or ()), exp["present"], "present")
        _pin(row.healthy, exp["healthy"], "healthy")
        _pin(row.kv_pages, exp["kv_pages"], "kv_pages")
        _pin(row.kv_pages_free, exp["kv_pages_free"], "kv_pages_free")
        _pin(row.prefix_hits, exp["prefix_hits"], "prefix_hits")
        _pin(row.prefix_misses, exp["prefix_misses"], "prefix_misses")
        _pin(row.prefill_tokens_saved, exp["prefill_tokens_saved"],
             "prefill_tokens_saved")
        _pin(row.goodput_tokens, exp["goodput_tokens"],
             "goodput_tokens")
        _pin(row.page_seconds, exp["page_seconds"], "page_seconds")
        _pin(row.stall_seconds, exp["stall_seconds"], "stall_seconds")
        _pin(row.queue_depth, exp["queue_depth"], "queue_depth")
        _pin(row.occupancy, exp["occupancy"], "occupancy")
        if "cost_interactive_tokens" in exp:
            _pin(row.cost_classes["interactive"]["tokens"],
                 exp["cost_interactive_tokens"], "cost tokens")
        return f"schema {row.schema}, {len(row.present)} block(s)"

    m.check("health", era, "signals-pins", parse)


def _check_metrics(m: Matrix, cdir: str, era: str) -> None:
    d = os.path.join(cdir, "metrics", era)
    text = _read(os.path.join(d, "metrics.prom"))
    exp = _expect(os.path.join(d, "expect.json"))

    def scrape():
        row = ReplicaSignals(name="corpus")
        row.present = set()
        apply_metrics(row, parse_metrics(text))
        _pin(row.prefix_hits, exp["prefix_hits"], "prefix_hits")
        _pin(row.kv_pages_free, exp["kv_pages_free"], "kv_pages_free")
        _pin(row.queue_depth, exp["queue_depth"], "queue_depth")
        _pin(row.goodput_tokens, exp["goodput_tokens"],
             "goodput_tokens")
        _pin(row.page_seconds, exp["page_seconds"], "page_seconds")
        _pin(row.stall_seconds, exp["stall_seconds"], "stall_seconds")
        return "scrape cross-fill pinned"

    m.check("metrics", era, "scrape-pins", scrape)

    if era == "v2":
        def regen():
            if corpus.build_metrics_v2() != text:
                raise AssertionError("Registry exposition drifted")
            return "byte-identical regeneration"

        m.check("metrics", era, "regenerate", regen)


def _check_bundle(m: Matrix, cdir: str, era: str) -> None:
    d = os.path.join(cdir, "bundle", era)
    obj = _expect(os.path.join(d, "bundle.json"))

    def validate():
        validate_bundle(obj)  # raises ValueError on any problem
        return "validate_bundle accepted"

    m.check("bundle", era, "validate", validate)


def _check_traceparent(m: Matrix, cdir: str) -> None:
    header = _read(os.path.join(cdir, "traceparent", "v1",
                                "header.txt"))

    def roundtrip():
        ctx = parse_header(header)
        if ctx.to_header() != header:
            raise AssertionError("to_header∘parse_header not identity")
        if corpus.build_traceparent() != header:
            raise AssertionError("seeded mint drifted")
        return "header round-trip byte-identical"

    m.check("traceparent", "v1", "codec-roundtrip", roundtrip)


def _check_fingerprint(m: Matrix, cdir: str, era: str) -> None:
    path = os.path.join(cdir, "fingerprint", era, "fingerprint.json")
    stored = _expect(path)

    def compare():
        want = (corpus.build_fingerprint_v1() if era == "v1"
                else corpus.build_fingerprint_v2())
        _pin(stored, want, "config_fingerprint vs stored")
        if era == "v1":
            # the rolling-upgrade claim: a DEFAULT current config still
            # fingerprints identically to the legacy era, so old
            # journals adopt cleanly
            _pin(stored, config_fingerprint(corpus.SPEC, "ring",
                                            "per_request"),
                 "legacy fingerprint vs current defaults")
        return "fingerprint stable"

    m.check("fingerprint", era, "compare", compare)


def run_matrix(cdir: str, inject_skew: bool = False) -> Matrix:
    m = Matrix()
    for era in ("v1", "v2"):
        _check_journal(m, cdir, era)
        _check_handoff(m, cdir, era, inject_skew)
        _check_health(m, cdir, era, inject_skew)
        _check_metrics(m, cdir, era)
        _check_bundle(m, cdir, era)
        _check_fingerprint(m, cdir, era)
    _check_pagewire(m, cdir)
    _check_traceparent(m, cdir)
    return m


# ------------------------------------------------ registry mutation gate
def run_drop_registry_field() -> int:
    """The lint's mutation arm: delete journal.admit's 'cursor' from an
    in-memory copy of the port's registry and run the static head over
    the port's tree; the producers now write an unregistered key, so the
    lint must find something. Exit 1 = the gate can fire."""
    from ..analysis import wiremodel
    from ..analysis.wirecheck import run_wirecheck, wire_files
    formats = []
    for fmt in wiremodel.FORMATS:
        if fmt.name == "journal.admit":
            fmt = dataclasses.replace(
                fmt, fields=tuple(f for f in fmt.fields
                                  if f.name != "cursor"))
        formats.append(fmt)
    findings = run_wirecheck(
        wire_files(PACKAGE_DIR, REPO_ROOT), REPO_ROOT,
        formats=tuple(formats),
        families=copy.deepcopy(wiremodel.METRIC_FAMILIES))
    n = len(findings)
    print(f"drop-registry-field: {n} finding(s) with "
          f"journal.admit.cursor deleted")
    for f in findings[:5]:
        print(f"  {f.rule} {f.path}:{f.line} {f.message}")
    return 1 if n else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="wire corpus round-trip + version-skew matrix")
    ap.add_argument("--corpus", default=DEFAULT_CORPUS,
                    help="corpus dir (default tests/fixtures/wire)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON row")
    ap.add_argument("--inject",
                    choices=("skew-reader", "drop-registry-field"),
                    help="mutation gates: corrupt legacy samples "
                         "in memory / delete a registry field — the "
                         "run must exit 1")
    args = ap.parse_args(argv)

    if args.inject == "drop-registry-field":
        return run_drop_registry_field()

    if not os.path.isdir(args.corpus):
        print(f"error: corpus directory not found: {args.corpus}",
              file=sys.stderr)
        return 2

    m = run_matrix(args.corpus, inject_skew=args.inject == "skew-reader")
    ok = m.failed == 0
    if args.json:
        print(json.dumps({"tool": "wirecheck",
                          "corpus": os.path.relpath(args.corpus,
                                                    str(REPO_ROOT)),
                          "inject": args.inject,
                          "checks": len(m.rows),
                          "failed": m.failed,
                          "ok": ok,
                          "matrix": m.rows,
                          "stamp": run_stamp()},
                         indent=2, sort_keys=True))
    else:
        for r in m.rows:
            mark = "ok " if r["ok"] else "FAIL"
            print(f"  {mark} {r['format']:<12} {r['era']:<7} "
                  f"{r['check']:<18} {r['detail']}")
        print(f"wirecheck skew matrix: {len(m.rows)} check(s), "
              f"{m.failed} failed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
