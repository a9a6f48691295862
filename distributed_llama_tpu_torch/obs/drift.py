"""Model-vs-measured drift reconciler, the observatory's verdict table
(the JAX package's obs/drift.py, with its thresholds and verdicts).

Two models predict where a step's time goes:
``parallel/comm_stats.tp_collective_budget`` (collective count/bytes) and
``parallel/shard_sim.modeled_ici_ms`` (collective time over the card's
link). This module joins an ``obs.xprof`` Attribution (measured) against
the budget for the (model, tp, scheme) config and emits one verdict row
per check: OK, DRIFT (with the measured/modeled ratio and the threshold
it broke) or SKIP (with its reason).

Checks and thresholds (module constants, printed in every table):

* **count** — measured collective launches/token per kind vs the budget.
  Exact equality when the capture's counts are exact (fixtures, and a
  port Chrome trace whose forwards carry their phase spans: there the
  forwards that skipped the logits each take one all_gather off the
  budget's total); within ``COUNT_RTOL`` otherwise. A kind with no budget
  term at all is always DRIFT: a collective added without its model
  term, caught from measurement.
* **bytes** — measured bytes/chip/token vs the budget term, within
  ``BYTES_RTOL``. Skipped when the capture carries no byte counts
  (Chrome traces don't; fixtures do).
* **time** — total measured collective ms/token vs the modeled
  bandwidth+latency sum, within a ``TIME_BAND``x band either way. SKIPs
  where the collectives ran over gloo (ranks sharing one card, or the
  CPU): each is a host round trip, a correctness path and not the
  modelled link.
* **coverage** — ≥ ``COVERAGE_MIN`` of device op time attributed to named
  phases; below that, per-phase conclusions are built on a minority of
  the step.
* **overlap** — overlap scheme only: the ring hops' latency-hiding must
  be REAL, not modeled — ≥ ``OVERLAP_MIN`` of measured ppermute time
  covered by concurrent compute (CollectiveMeasure.overlap_ms; fixtures
  carry it as per-event ``overlap_ns``, capture formats without
  per-event timestamps SKIP honestly). A serialized schedule — every
  hop exposed — is exactly the regression the overlap scheme's
  projection advertises away, caught here from measurement (the
  mutated ``serialized-overlap`` fixture pins the gate).

Surfaced by the port's ``tools/tracecheck.py`` and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses

from .xprof import Attribution, load_capture

COUNT_RTOL = 0.10    # real-capture count tolerance (fixtures: exact)
BYTES_RTOL = 0.01    # byte accounting is closed-form; 1% is generous
TIME_BAND = 4.0      # measured/modeled collective time band (x either way)
COVERAGE_MIN = 0.95  # phase-attribution floor
OVERLAP_MIN = 0.60   # overlap scheme: ppermute time covered by compute


@dataclasses.dataclass(frozen=True)
class DriftRow:
    check: str       # "count" | "bytes" | "time" | "coverage"
    kind: str        # collective kind, or "step" for coverage/time rows
    measured: float
    modeled: float
    threshold: str   # human-readable bound the verdict applied
    verdict: str     # "OK" | "DRIFT" | "SKIP"
    detail: str = ""

    @property
    def ratio(self) -> float:
        if self.modeled == 0:
            return float("inf") if self.measured else 1.0
        return self.measured / self.modeled


@dataclasses.dataclass
class DriftReport:
    label: str
    scheme: str
    n_slices: int
    tokens: int
    coverage: float
    rows: list

    @property
    def ok(self) -> bool:
        return not any(r.verdict == "DRIFT" for r in self.rows)

    @property
    def drift_rows(self) -> list:
        return [r for r in self.rows if r.verdict == "DRIFT"]

    def render(self) -> str:
        head = (f"tracecheck [{self.label}] scheme={self.scheme} "
                f"tp={self.n_slices} tokens={self.tokens} "
                f"coverage={self.coverage:.1%}")
        lines = [head, f"{'check':<9} {'kind':<19} {'measured':>14} "
                       f"{'modeled':>14} {'ratio':>8}  verdict"]
        for r in self.rows:
            ratio = r.ratio
            ratio_s = f"{ratio:8.3f}" if ratio != float("inf") else "     inf"
            lines.append(
                f"{r.check:<9} {r.kind:<19} {r.measured:>14.4f} "
                f"{r.modeled:>14.4f} {ratio_s}  {r.verdict}"
                + (f"  ({r.detail})" if r.detail else ""))
        lines.append("verdict: " + ("OK" if self.ok else "DRIFT — "
                     + "; ".join(f"{r.check}:{r.kind}"
                                 for r in self.drift_rows)))
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "label": self.label, "scheme": self.scheme,
            "tp": self.n_slices, "tokens": self.tokens,
            "coverage": round(self.coverage, 4), "ok": self.ok,
            "rows": [{"check": r.check, "kind": r.kind,
                      "measured": r.measured, "modeled": r.modeled,
                      "threshold": r.threshold, "verdict": r.verdict,
                      "detail": r.detail} for r in self.rows],
        }


def _close(measured: float, modeled: float, rtol: float) -> bool:
    if modeled == 0:
        return measured == 0
    return abs(measured / modeled - 1.0) <= rtol


def reconcile(att: Attribution, spec, n_slices: int, scheme: str,
              label: str = "", gbps: float | None = None,
              latency_us: float | None = None) -> DriftReport:
    """Join an attribution against the analytic model for one config."""
    from ..parallel.comm_stats import tp_collective_budget
    from ..parallel.shard_sim import modeled_ici_ms

    budget = tp_collective_budget(spec, n_slices, scheme)
    n = max(att.tokens, 1)
    counts, by_kind = budget.kind_counts(), budget.bytes_by_kind()
    modeled = {k: (counts[k], by_kind[k]) for k in counts}
    rows: list[DriftRow] = []

    for kind in sorted(set(modeled) | set(att.collectives)):
        m = att.collectives.get(kind)
        m_count = (m.count / n) if m else 0.0
        c_model, b_model = modeled.get(kind, (0, 0))
        if kind not in modeled:
            rows.append(DriftRow(
                "count", kind, m_count, 0.0, "no budget term",
                "DRIFT", "collective kind with NO budget term — the "
                         "forward issues a collective the model never "
                         "heard of"))
            continue
        if att.counts_exact:
            # integer totals: a skipped logits gather is one all_gather
            # less for its forward
            want = c_model * n - (att.logits_skipped
                                  if kind == "all_gather" else 0)
            count_ok = (m.count if m else 0) == want
            bound = "exact"
        else:
            count_ok = _close(m_count, float(c_model), COUNT_RTOL)
            bound = f"±{COUNT_RTOL:.0%}"
        modeled_count = float(c_model) - (
            att.logits_skipped / n if kind == "all_gather" else 0.0)
        rows.append(DriftRow(
            "count", kind, m_count, modeled_count, bound,
            "OK" if count_ok else "DRIFT",
            "" if count_ok else "collective launch census drifted from "
                                "tp_collective_budget"))
        if m is not None and m.bytes is not None:
            m_bytes = m.bytes / n
            bytes_ok = _close(m_bytes, float(b_model), BYTES_RTOL)
            rows.append(DriftRow(
                "bytes", kind, m_bytes, float(b_model),
                f"±{BYTES_RTOL:.0%}", "OK" if bytes_ok else "DRIFT",
                "" if bytes_ok else "moved-bytes accounting drifted from "
                                    "tp_collective_budget"))
        else:
            rows.append(DriftRow(
                "bytes", kind, 0.0, float(b_model), f"±{BYTES_RTOL:.0%}",
                "SKIP", "capture carries no byte counts"))

    kw = {}
    if gbps is not None:
        kw["gbps"] = gbps
    if latency_us is not None:
        kw["latency_us"] = latency_us
    bw_ms, lat_ms = modeled_ici_ms(spec, n_slices, scheme, **kw)
    model_ms = bw_ms + lat_ms
    meas_ms = sum(m.ms for m in att.collectives.values()) / n
    if att.backend == "gloo":
        rows.append(DriftRow(
            "time", "step", round(meas_ms, 6), round(model_ms, 6),
            f"{TIME_BAND}x band", "SKIP",
            "collectives ran over gloo (host round trips): a correctness "
            "path, not the modelled link"))
    elif model_ms == 0 and meas_ms == 0:
        rows.append(DriftRow("time", "step", 0.0, 0.0,
                             f"{TIME_BAND}x band", "OK",
                             "no collectives modeled, none measured"))
    else:
        ratio = meas_ms / model_ms if model_ms else float("inf")
        time_ok = (1.0 / TIME_BAND) <= ratio <= TIME_BAND
        rows.append(DriftRow(
            "time", "step", round(meas_ms, 6), round(model_ms, 6),
            f"{TIME_BAND}x band", "OK" if time_ok else "DRIFT",
            "" if time_ok else "collective time escaped the modeled "
                               "bandwidth+latency band"))

    if scheme == "overlap" and "ppermute" in modeled:
        m = att.collectives.get("ppermute")
        frac = m.overlap_fraction if m is not None else None
        if frac is None:
            rows.append(DriftRow(
                "overlap", "ppermute", 0.0, OVERLAP_MIN,
                f">={OVERLAP_MIN:.0%}", "SKIP",
                "capture carries no per-event overlap timing — cannot "
                "judge latency hiding from durations alone"))
        else:
            ov_ok = frac >= OVERLAP_MIN
            rows.append(DriftRow(
                "overlap", "ppermute", round(frac, 4), OVERLAP_MIN,
                f">={OVERLAP_MIN:.0%}", "OK" if ov_ok else "DRIFT",
                "" if ov_ok else "ring hops ran SERIALIZED against "
                                 "compute — the overlap scheme's "
                                 "latency-hiding claim does not hold on "
                                 "this capture"))

    cov_ok = att.coverage >= COVERAGE_MIN
    rows.append(DriftRow(
        "coverage", "step", round(att.coverage, 4), COVERAGE_MIN,
        f">={COVERAGE_MIN:.0%}", "OK" if cov_ok else "DRIFT",
        "" if cov_ok else "too much step time outside named phases to "
                          "trust the attribution"))
    return DriftReport(label=label or att.source, scheme=scheme,
                       n_slices=n_slices, tokens=att.tokens,
                       coverage=att.coverage, rows=rows)


# -- config resolution ------------------------------------------------------

_SPEC_BUILDERS = {"7b": "llama2_7b_spec", "13b": "llama2_13b_spec",
                  "70b": "llama2_70b_spec", "small": "small_bench_spec"}


def spec_for(model: str, buffer: str = "f32"):
    """(spec, label) for a model name + buffer float type — the shared
    config vocabulary of fixtures and tracecheck flags. ``model`` may also
    name a ``.bin`` file, whose header gives the spec (a trace of a model
    cut in depth, or of any other shape)."""
    import dataclasses as _dc
    import os

    from ..io.loader import read_spec
    from ..models import synth
    from ..ops.quants import FloatType

    if buffer not in ("f32", "q80"):
        raise ValueError(f"unknown buffer type {buffer!r}: expected "
                         f"f32|q80")
    if model in _SPEC_BUILDERS:
        spec = getattr(synth, _SPEC_BUILDERS[model])()
        label = model
    elif os.path.isfile(model):
        spec = read_spec(model)
        label = os.path.basename(model)
    else:
        raise ValueError(f"unknown model {model!r}: expected one of "
                         f"{'|'.join(sorted(_SPEC_BUILDERS))} or a .bin "
                         f"file")
    if buffer == "q80":
        spec = _dc.replace(spec, buffer_float_type=FloatType.Q80)
    return spec, f"{label}/{buffer}"


def reconcile_capture(path: str, model: str | None = None,
                      tp: int | None = None, scheme: str | None = None,
                      buffer: str | None = None,
                      tokens: int = 0) -> tuple[Attribution, DriftReport]:
    """Load a capture and reconcile it against its config's model.

    Fixture captures carry (model, tp, scheme, buffer) in their header;
    explicit arguments override (and are REQUIRED for a Chrome trace,
    which carries none of it).
    """
    att = load_capture(path, tokens=tokens)
    cfg = att.config
    model = model or cfg.get("model")
    tp = tp if tp is not None else cfg.get("tp")
    scheme = scheme or cfg.get("scheme")
    buffer = buffer or cfg.get("buffer", "f32")
    missing = [k for k, v in (("model", model), ("tp", tp),
                              ("scheme", scheme)) if not v]
    if missing:
        raise ValueError(
            f"capture {path!r} carries no config header — pass "
            f"{'/'.join('--' + m for m in missing)} explicitly")
    spec, label = spec_for(str(model), str(buffer))
    report = reconcile(att, spec, int(tp), str(scheme),
                       label=f"{label} tp{tp}")
    return att, report


# -- bench row columns ------------------------------------------------------


def bench_drift_fields(splits, spec, rank_tp: int, tokens: int,
                       scheme: str | None = None) -> dict:
    """Drift columns of a profiled run, from its utils/it_split.
    parse_trace splits (parsed once by the caller). A one-card run gets a
    real verdict (the budget says zero collectives; any measured
    collective time is drift). A simulated rank (``rank_tp`` > 1) runs
    its collectives as local stand-ins (parallel/shard_sim.py), so
    measured-vs-modelled is N/A there: the row carries the modelled
    budget and says so instead of a vacuous OK.
    """
    from ..parallel.comm_stats import tp_collective_budget, tp_scheme
    from ..parallel.shard_sim import modeled_ici_ms

    scheme = scheme or tp_scheme()
    n = max(tokens, 1)
    att = Attribution(tokens=n, counts_exact=False)
    for split in splits.values():
        for name, ns in split.ops.items():
            att._bucket(name, "", ns / 1e6 / max(len(splits), 1),
                        1, None, None)
    meas_ms = sum(m.ms for m in att.collectives.values()) / n
    budget = tp_collective_budget(spec, rank_tp or 1, scheme)
    bw_ms, lat_ms = modeled_ici_ms(spec, rank_tp or 1, scheme)
    out = {
        "tp_scheme": scheme,
        "phase_ms_per_token": att.phase_ms_per_token(),
        "phase_coverage": round(att.coverage, 4),
        "collectives": {
            "measured_ms_per_token": round(meas_ms, 6),
            "modeled_ms_per_token": round(bw_ms + lat_ms, 6),
            "modeled_count_per_token": budget.n_collectives,
            "modeled_bytes_per_token": budget.moved_bytes,
        },
    }
    if rank_tp > 1:
        out["verdict"] = "N/A"
        out["note"] = ("rank-sim row: collectives run as local stand-ins "
                       "(shard_sim), so measured-vs-modeled needs a "
                       "group of GPUs; modeled budget carried above")
    else:
        # single chip: the budget is empty and the trace must agree
        out["verdict"] = "OK" if meas_ms <= 0.01 else "DRIFT"
        if out["verdict"] == "DRIFT":
            out["note"] = (f"measured {meas_ms:.3f} ms/token of collective "
                           f"ops on a single-chip row whose budget is zero")
    return out
