"""I/T attribution from a ``--profile`` trace: the port's copy of the JAX
package's utils/it_split.py, reading torch.profiler's Chrome trace.

The reference's published benchmark metric is the per-task-type wall-time
split: every task is tagged INFERENCE or TRANSFER and the TaskLoop
accumulates time per tag across the barrier (src/utils.cpp:101-109), printed
per token as "I ... ms T ... ms" (src/tokenizer.cpp:381). This module parses
the trace that ``inference --profile DIR`` writes (obs/profiler.trace: a
``*.pt.trace.json`` Chrome trace) and buckets every op event into

  I = compute ns (the port's kernels, cuBLAS, torch's elementwise kernels)
  T = collective ns (all-gather / all-reduce / reduce-scatter / send / recv
      and NCCL's kernels)

then prints the reference-shaped per-token line.

Which events count:

* a trace with device kernels (``cat == "kernel"``, a run on the card)
  gives one split per device (the event's ``pid``), summed over its
  streams; host events are ignored, except the tensor-parallel
  collectives' spans (below) where no kernel is a collective (gloo ranks
  on the card: their collectives are host work); NCCL's collectives are
  kernels;
* a trace with none (a CPU run) gives one split per host thread, from its
  TOP-LEVEL ``cpu_op`` events and collective spans only (those no other
  such event of the same ``tid`` contains by ``ts``/``dur``): aten ops
  nest (``aten::linear`` -> ``aten::matmul`` -> ``aten::mm``), and
  counting every level would count the same time several times. gloo's
  own worker threads (those holding a ``gloo:`` event and no collective
  span) are left out: their work is inside the collectives' spans.

The collectives' spans are the ``user_annotation`` events that
parallel/collectives.py makes while a profiler runs: ``tp::<kind>`` over
one collective's host work (one per CENSUS entry) and ``tp::wait`` over
the wait for an issued one; both are T. ``DeviceSplit.transfer_events``
counts the collectives (the spans other than the waits, or the collective
kernels).

Names go to a base name: the identifier after the last ``::``, without the
return type, template arguments or parameter list, so the demangled
signature ``void (anonymous namespace)::q40_matvec_kernel(uint4 const*,
...)`` and ``void flash_decode_kernel<float, 128>(...)`` become
``q40_matvec_kernel`` and ``flash_decode_kernel``, and ``aten::mm`` becomes
``mm``. The families of ``bucket_ops`` are the JAX package's, matched on
these names: torch's elementwise and reduction kernels
(``vectorized_elementwise_kernel``, ``reduce_kernel``) land in ``other``,
as the JAX classifier puts ops it does not know.

Usage:
  python3 -m distributed_llama_tpu_torch.utils.it_split DIR [--tokens N]
      [--top K]

DIR is the --profile directory (the newest *.pt.trace.json under it is
parsed; a direct .json path also works). --tokens divides totals into
per-token ms for the 🔶-line comparison.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import re
import sys

# the JAX package's collective names, plus NCCL's kernels
_COLLECTIVE_RE = re.compile(
    r"all[_-]gather|all[_-]reduce|reduce[_-]scatter|collective[_-]permute"
    r"|all[_-]to[_-]all|collective[_-]broadcast|\bsend\b|\brecv\b"
    r"|^send|^recv|ragged[_-]all[_-]to[_-]all"
    r"|(?i:ncclDevKernel_|ncclKernel_|allreduce|allgather|reducescatter"
    r"|sendrecv)")
# the host spans of parallel/collectives.py (module docstring)
SPAN_PREFIX = "tp::"
WAIT_SPAN = SPAN_PREFIX + "wait"
_TEMPLATE_RE = re.compile(r"<[^<>]*>")
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
# containment slack in microseconds: the trace rounds ts and dur to ns
_EPS_US = 1e-3


@dataclasses.dataclass
class DeviceSplit:
    """Per-device (or per-thread) op-time totals, in nanoseconds."""
    inference_ns: float = 0.0
    transfer_ns: float = 0.0
    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)  # name -> ns
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)  # name -> events
    transfer_events: int = 0  # collectives (waits not counted)

    @property
    def total_ns(self) -> float:
        return self.inference_ns + self.transfer_ns


def find_trace(path: str) -> str:
    """Resolve a --profile dir (or direct file) to the newest
    .pt.trace.json."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*.pt.trace.json"),
                     recursive=True)
    if not hits:
        raise FileNotFoundError(f"no *.pt.trace.json under {path!r} — was "
                                f"the run started with --profile?")
    return max(hits, key=os.path.getmtime)


def base_name(name: str) -> str:
    """The identifier a kernel or op event is known by: after the last
    ``::``, with no return type, template arguments or parameter list
    ('' when the name holds no identifier)."""
    prev = None
    while prev != name:  # innermost template brackets first
        prev, name = name, _TEMPLATE_RE.sub("", name)
    name = name.replace("(anonymous namespace)", "")
    name = name.split("(", 1)[0].rsplit("::", 1)[-1]
    idents = _IDENT_RE.findall(name)
    return idents[-1] if idents else ""


def _top_level(events: list[dict]) -> list[dict]:
    """The events of one thread that no other event contains."""
    out: list[dict] = []
    end = float("-inf")
    for ev in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if ev["ts"] + ev["dur"] <= end + _EPS_US:
            continue  # inside the last top-level event
        out.append(ev)
        end = ev["ts"] + ev["dur"]
    return out


def parse_trace(path: str) -> dict[str, DeviceSplit]:
    """Parse a Chrome trace into per-device I/T splits.

    Keys are '/device:cuda:PID' — one entry per device — for a trace with
    kernel events, else '/host:CPU/PID/TID', one per thread.
    """
    with open(find_trace(path)) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if isinstance(e, dict) and "dur" in e and "ts" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    groups: dict[str, list[dict]] = collections.defaultdict(list)
    if kernels:
        host = [] if any(_COLLECTIVE_RE.search(base_name(str(k["name"])))
                         for k in kernels if "name" in k) else spans
        for ev in kernels:
            groups[f"/device:cuda:{ev.get('pid')}"].append(ev)
        for evs in groups.values():
            evs.extend(host)
    else:
        gloo = ({(e.get("pid"), e.get("tid")) for e in events
                 if str(e.get("name", "")).startswith("gloo:")}
                - {(e.get("pid"), e.get("tid")) for e in spans})
        for ev in [e for e in events if e.get("cat") == "cpu_op"] + spans:
            if (ev.get("pid"), ev.get("tid")) not in gloo:
                groups[f"/host:CPU/{ev.get('pid')}/{ev.get('tid')}"].append(
                    ev)
        groups = {k: _top_level(v) for k, v in groups.items()}
    out: dict[str, DeviceSplit] = {}
    for key, evs in groups.items():
        split = DeviceSplit()
        for ev in evs:
            wait = ev.get("name") == WAIT_SPAN
            name = base_name(str(ev.get("name", "")))
            if not name:
                continue
            ns = float(ev["dur"]) * 1e3
            split.ops[name] += ns
            split.counts[name] += 1
            if wait or _COLLECTIVE_RE.search(name):
                split.transfer_ns += ns
                split.transfer_events += not wait
            else:
                split.inference_ns += ns
        if split.ops:
            out[key] = split
    if not out:
        raise ValueError(f"no op events found in {path!r} (empty trace?)")
    return out


def bucket_ops(trace_dir: str, denom: int = 1) -> dict[str, float]:
    """Op time from a trace grouped by kernel family, in ms (divided by
    ``denom``, e.g. steps or tokens): the JAX package's families, matched
    on the base names (``q40_kernels``: the port's Q40 kernels, whose names
    hold 'q40', and any name with 'matmul', 'matvec' or 'mxu';
    ``attention``: names with 'attention' or 'flash')."""
    return bucket_ops_from_splits(parse_trace(trace_dir), denom)


def bucket_ops_from_splits(splits: dict[str, DeviceSplit],
                           denom: int = 1) -> dict[str, float]:
    """`bucket_ops` over an already-parsed trace (callers that also need
    the I/T split parse the trace ONCE and feed both consumers)."""
    buckets: dict[str, float] = {}
    for split in splits.values():
        for name, ns in split.ops.items():
            n = name.lower()
            if "q40" in n or "matmul" in n or "matvec" in n or "mxu" in n:
                b = "q40_kernels"
            elif "attention" in n or "flash" in n:
                b = "attention"
            elif n.startswith(("fusion", "transpose", "copy", "bitcast",
                               "reshape", "convert", "dynamic")):
                b = "fusion_layout"
            else:
                b = "other"
            buckets[b] = buckets.get(b, 0.0) + ns
    return {k: round(v / 1e6 / max(denom, 1), 3)
            for k, v in sorted(buckets.items())}


def summarize(splits: dict[str, DeviceSplit], tokens: int = 0,
              top: int = 8, out=None, note: str = "") -> tuple[float, float]:
    """Print the reference-shaped split; returns (I_ms, T_ms) averaged
    across devices (per token when ``tokens`` > 0). ``note`` extends the
    caveat parenthetical (e.g. the CLI flags that the traced region also
    contains prefill work)."""
    out = out or sys.stdout
    n_dev = len(splits)
    i_ms = sum(s.inference_ns for s in splits.values()) / n_dev / 1e6
    t_ms = sum(s.transfer_ns for s in splits.values()) / n_dev / 1e6
    denom = max(tokens, 1)
    unit = "ms/token" if tokens else "ms"
    print(f"🔶 I {i_ms / denom:10.3f} {unit}  T {t_ms / denom:10.3f} {unit}"
          f"  ({n_dev} device{'s' if n_dev != 1 else ''}, op-time avg;"
          f" I=compute T=collectives{note})", file=out)
    agg: collections.Counter = collections.Counter()
    for s in splits.values():
        agg.update(s.ops)
    width = max((len(k) for k, _ in agg.most_common(top)), default=4)
    for name, ns in agg.most_common(top):
        tag = ("T" if _COLLECTIVE_RE.search(name)
               or name == base_name(WAIT_SPAN) else "I")
        print(f"   {tag} {name:<{width}} {ns / n_dev / denom / 1e6:10.3f} "
              f"{unit}", file=out)
    return i_ms / denom, t_ms / denom


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="it_split", description="per-token I/T split from a --profile "
                                     "trace (reference utils.cpp:101-109 "
                                     "semantics, profiler-derived)")
    ap.add_argument("trace", help="--profile directory or .pt.trace.json "
                                  "file")
    ap.add_argument("--tokens", type=int, default=0,
                    help="tokens generated under the trace (divides totals "
                         "into per-token ms)")
    ap.add_argument("--top", type=int, default=8,
                    help="show the K most expensive ops")
    args = ap.parse_args(argv)
    summarize(parse_trace(args.trace), tokens=args.tokens, top=args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
