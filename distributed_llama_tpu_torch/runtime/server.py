"""HTTP inference server on the continuous-batching engine (the JAX
package's runtime/server.py).

A stdlib (http.server) API over runtime/continuous.py. Requests from
concurrent clients stream through the slot pool: admission happens between
dispatches, so a short request never waits for a long one to finish.

Endpoints (the JAX server's, with its keys and messages):
  POST /generate  {"prompt": str, "steps"?: int, "temperature"?: float,
                   "topp"?: float, "seed"?: int, "stream"?: bool,
                   "class"?: str  (SLO priority class, --slo policy)}
               -> {"text": str, "tokens": [int], "steps": int}
               or, with "stream": true, chunked newline-delimited JSON:
               one {"token": int, "piece": str} line per token as it
               decodes, then a final {"done": true, "text": ..., "steps": N}
  GET  /health -> the schema-3 health payload (state, occupancy, paged_kv,
               journal, watchdog, slo, sched, speculative, watch and the
               latency summaries)
  GET  /metrics -> Prometheus text exposition of the obs registry
  GET  /debug/timeline -> Chrome-trace JSON of the engine's recent spans;
               ``?format=ndjson`` one span object per line
  GET  /debug/sched -> the dispatch census ring and the cost ledgers
  GET  /debug/incidents -> the watchtower's detector states and incidents
  POST /profile  {"seconds"?: float, "dir"?: str} -> a torch.profiler
               capture (obs/profiler.start_capture) into dir for N seconds
               while serving (409 if one is already running); its Chrome
               trace reads with utils/it_split.parse_trace

  POST /prefill  (``disagg_role="prefill"`` only) the decode pool's
               internal handoff RPC: {"tokens": [ids], "steps": N, ...}
               -> {"record": <journal wire record>, "hid", "n_pages",
               "channel_port"} (the prompt's full pages published on the
               page channel), or {"final": true, "out": [...]} when the
               stream ended inside the prefill cut. /health gains a
               "disagg" block (role, peer, page channel, handoff queue
               depth) on both roles, and a "kv_tiers" block with the KV
               tiers on

Prefill/decode disaggregation (runtime/disagg.py): the prefill role binds
the page channel (runtime/page_channel.py) on the listener's interface,
admits by SLO rank and parks batch prefills for interactive arrivals
(disagg.make_priority_hold); the decode role forwards every prompt of at
least ``handoff_min_pages`` full pages to ``disagg_peer``, fetches the
shipped pages and re-admits the request from its journal record. A peer
failure of any kind serves the request locally.

Over a tp group (``mesh`` of size > 1, with ``tp_channel`` a
runtime/tp_plan.PlanChannel) this server is rank 0: its engine sends each
dispatch's plan to the other ranks (tp_plan.follow_loop) before it
launches, every rank runs eager steps (a CUDA graph over the group's
collectives is not yet ported), /health gains a ``tp`` block, drain and
stop send the shutdown plan, and a dispatch that fails (a follower gone,
a digest parted) fails every pending request and ends the server: the
caller exits non-zero (``tp_error``).

Threading model: ThreadingHTTPServer handles each connection on its own
thread; handlers only encode, submit (thread-safe) and wait on the
request's done event, and read host counters for /health and /metrics —
no handler touches the device. ONE scheduler thread owns the device loop:
it sets its device, captures every CUDA graph the engine's dispatches
replay (ContinuousEngine.capture_graphs), and only then does the listener
open, so no graph capture ever runs beside a handler thread or a profiler
start (a capture in the default global mode fails on another thread's
CUDA call).

Crash safety: with a write-ahead journal (``journal=``, runtime/journal.py)
the server recovers journaled in-flight requests at construction, a step
watchdog (``watchdog_s``, runtime/supervisor.py) detects hung dispatches
and degrades health, SIGTERM triggers a graceful drain — stop admission
(503), finish in-flight work within ``drain_s``, journal the remainder,
exit 0 — and the health state machine (starting/serving/degraded/
draining/stopped) is surfaced in ``/health`` and the
``dllama_health_state`` gauge.

Chaos (``chaos=``, a runtime/chaos.ChaosMonkey; ``serve --chaos``) arms
the engine's deterministic fault injection for operator drills, and on a
prefill pool strips the handoff RPC's traceparent under the
drop-traceparent mutation.
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from ..io.tokenizer import Tokenizer
from ..models.spec import TransformerSpec
from ..obs import tracectx
from ..obs.log import log_event
from ..utils.fingerprint import run_stamp
from .continuous import ContinuousEngine, Request
from .supervisor import HealthMonitor, StepWatchdog

_IDLE_SLEEP_S = 0.002

# /health schema version, emitted as the payload's "schema" key so a
# fleet rollup can see version skew across replicas (absent on pre-
# schema replicas — obs/fleet treats that as 0); the JAX server's.
HEALTH_SCHEMA = 3


class OversizedRequest(ValueError):
    """A request the model literally cannot serve (prompt or steps beyond
    seq_len) — its own 400 + ``admission_rejected{reason="oversized"}``
    series, distinct from malformed-payload bad_request."""


class InferenceServer:
    """Owns the engine, the HTTP listener, and the scheduler thread."""

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 tokenizer: Tokenizer, host: str, port: int, slots: int,
                 steps: int, temperature: float, topp: float, seed: int,
                 cache_dtype=torch.float32, mesh=None,
                 prefill_chunk: int = 0, block_steps: int = 1,
                 quiet: bool = False, fast_prefill: bool = False,
                 metrics: bool = True, registry=None, page_size: int = 0,
                 kv_pages: int = 0, spec_k: int = 0, spec_ngram: int = 3,
                 dispatch_tokens: int = 0, slo=None, journal=None,
                 watchdog_s: float = 0.0, drain_s: float = 10.0,
                 kv_quant: str | None = None, flightrec_dir: str | None = None,
                 watch_interval_s: float = 0.0, device="cuda",
                 graph: bool | None = None, kv_host_pages: int = 0,
                 kv_disk_dir: str | None = None, kv_disk_bytes: int = 0,
                 disagg_role: str | None = None,
                 disagg_peer: str | None = None,
                 page_channel_port: int = 0, handoff_min_pages: int = 2,
                 chaos=None, tp_channel=None, tp_alive=None):
        self._tp = None
        # under tp: () -> None while every follower lives, else its error
        self._tp_alive = tp_alive
        if mesh is not None and mesh.size > 1:
            if tp_channel is None:
                raise ValueError("serving over a tp group needs its plan "
                                 "channel (runtime/tp_plan.PlanChannel)")
            if mesh.sp_size > 1:
                raise ValueError("serve runs the paged pool: sp must be 1")
            self._tp = tp_channel
            graph = False  # eager steps: no graph over the collectives
        # a failed dispatch under tp (a follower gone, books parted)
        self.tp_error: str | None = None
        self.spec = spec
        self.tokenizer = tokenizer
        self.default_steps = steps
        self.quiet = quiet
        self.drain_s = drain_s
        # prefill/decode disaggregation: "prefill" serves POST /prefill and
        # the page channel; "decode" fronts clients and forwards long
        # prompts to ``disagg_peer`` (host:port of the prefill server).
        # None = single-pool serving.
        if disagg_role not in (None, "prefill", "decode"):
            raise ValueError(f"disagg_role {disagg_role!r}: expected "
                             f"prefill|decode|None")
        if disagg_role is not None and page_size <= 0:
            raise ValueError("disaggregation ships KV PAGES: pass "
                             "page_size > 0 (--kv-page-size)")
        if disagg_role == "decode" and not disagg_peer:
            raise ValueError("--disagg-role decode needs --disagg-peer "
                             "HOST:PORT (the prefill server)")
        self.disagg_role = disagg_role
        self.disagg_peer = disagg_peer
        self.handoff_min_pages = max(1, handoff_min_pages)
        self._page_channel = None
        self._disagg_obs = None
        # SLO policy (obs/slo.SLOPolicy) — verdicts per priority class in
        # /health + /metrics
        self.slo_policy = slo
        # metrics default ON for the server (it IS the observability
        # surface); --no-metrics turns collection off, and /metrics then
        # 404s. Each server gets its OWN registry unless one is injected —
        # two servers in one process must not sum their counters.
        if metrics:
            from ..obs.metrics import Registry

            self.registry = registry if registry is not None else Registry()
        else:
            self.registry = None
        self._t_start = time.monotonic()
        # crash-safety surface: the health state machine is
        # always on (a journal-less server still reports starting/serving/
        # draining/stopped); the watchdog and journal are opt-in knobs
        self.health = HealthMonitor(self.registry)
        self.journal = journal
        # crash-forensics flight recorder: the ring is ALWAYS
        # recording (cheap); bundle files land in flightrec_dir when the
        # watchdog fires or the SIGTERM drain runs (None = ring only)
        from ..obs.flightrec import FlightRecorder

        self.flightrec_dir = flightrec_dir
        self.flightrec = FlightRecorder(
            registry=self.registry,
            journal_path=journal.path if journal is not None else None,
            config=(dict(journal.config)
                    if journal is not None and journal.config else {}))
        self._watchdog = (StepWatchdog(watchdog_s, on_hang=self._on_hang)
                          if watchdog_s > 0 else None)
        self._drain_hist = (self.registry.histogram(
            "dllama_drain_seconds",
            "Graceful-drain duration: SIGTERM to in-flight work finished "
            "or journaled") if self.registry is not None else None)
        self.engine = ContinuousEngine(spec, params, slots, temperature,
                                       topp, seed, cache_dtype=cache_dtype,
                                       prefill_chunk=prefill_chunk,
                                       block_steps=block_steps,
                                       fast_prefill=fast_prefill,
                                       metrics=self.registry,
                                       page_size=page_size,
                                       kv_pages=kv_pages, spec_k=spec_k,
                                       spec_ngram=spec_ngram,
                                       dispatch_tokens=dispatch_tokens,
                                       slo=slo, chaos=chaos,
                                       journal=journal,
                                       watchdog=self._watchdog,
                                       kv_quant=kv_quant, device=device,
                                       graph=graph, mesh=(
                                           mesh if self._tp is not None
                                           else None),
                                       kv_host_pages=kv_host_pages,
                                       kv_disk_dir=kv_disk_dir,
                                       kv_disk_bytes=kv_disk_bytes,
                                       remote_pages=(
                                           disagg_role == "decode"),
                                       slo_priority=(
                                           disagg_role == "prefill"
                                           and slo is not None))
        if self._tp is not None:
            from .tp_plan import PlanLeader

            self.engine.bind_plan(PlanLeader(tp_channel))
        if disagg_role == "prefill":
            from .disagg import make_priority_hold
            from .page_channel import PageChannelServer

            # the channel binds the listener's interface: a 0.0.0.0 serve
            # host means remote decode pools connect, and the page channel
            # must be reachable from exactly as far
            self._page_channel = PageChannelServer(
                host=host if host else "0.0.0.0", port=page_channel_port)
            if slo is not None:
                # interactive prefills jump the queue AND preempt batch
                # prefills at page-aligned chunk boundaries
                self.engine.prefill_hold = make_priority_hold(
                    self.engine, slo)
        if disagg_role is not None and self.registry is not None:
            from .disagg import DisaggMetrics

            self._disagg_obs = DisaggMetrics(self.registry)
        # the scheduler thread's device: the current device is per thread,
        # so the index is read here, on the constructing thread
        dev = self.engine.device
        self._device_index = (None if dev.type != "cuda" else
                              dev.index if dev.index is not None
                              else torch.cuda.current_device())
        # run-config stamp computed once here, off the handler threads
        run_stamp()
        # the engine's span tracer feeds the flight recorder's bundle
        # (None when metrics are off — the ring of notes still records);
        # the census ring + ledger book (always on) ride along so a
        # crash bundle shows WHAT the scheduler was dispatching and
        # WHOSE requests were mid-flight
        self.flightrec.bind(spans=self.engine._spans,
                            census=self.engine.sched_census,
                            ledgers=self.engine.ledger_book)
        self.flightrec.note("server.start", role=disagg_role or "single",
                            slots=slots, page_size=page_size)
        # incident-detection plane: always constructed — the
        # detectors run on every watch_tick() whether the periodic
        # supervisor loop is on (watch_interval_s > 0) or a test/sim
        # drives ticks by hand. A firing detector dumps a flight-
        # recorder bundle with reason="incident" + the detector kind.
        from ..obs.watch import Watchtower

        self.watch_interval_s = watch_interval_s
        self._watch = Watchtower(registry=self.registry,
                                 spans=self.engine._spans,
                                 on_incident=self._on_incident)
        self._watch_stop = threading.Event()
        # replay the previous life's unfinished requests BEFORE the
        # listener opens: recovered work re-queues first, so a restarted
        # server continues exactly where the crash cut it off
        self.recovered = (self.engine.recover(quiet=quiet)
                          if journal is not None else 0)
        if self.recovered:
            self.flightrec.note("server.recovered", n=self.recovered)
        self._shutdown = threading.Event()
        self._stop_requested = threading.Event()  # SIGTERM, a tp failure
        self._stopped = threading.Event()  # stop() ran to completion
        self._ready = threading.Event()  # the scheduler's device set-up
        self._ready_error: BaseException | None = None
        # live streaming-handler threads (the _stream loop): stop() joins
        # these AFTER waking their requests — a blocked q.get/done.wait
        # must not outlive the server (the thread-leak satellite).
        # ``_handlers`` holds every one whose request reached the engine,
        # ``_streams`` those whose stream has begun (a token taken off
        # the queue: the engine has run the request). Under the lock,
        # drain() and stop() close admission (``_closed``): a request
        # reaches the engine before their count of outstanding work, and
        # is woken by it, or is refused
        self._handlers: set = set()
        self._streams: set = set()
        self._streams_lock = threading.Lock()
        self._closed = False
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 is required for Transfer-Encoding: chunked — on a
            # /1.0 status line RFC-compliant clients (curl) do not de-chunk
            # and would see raw chunk framing; the non-streaming path is
            # fine either way (it always sends Content-Length)
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet the per-request noise
                if not server.quiet:
                    log_event("http.request",
                              f"🌐 {self.address_string()} {fmt % args}",
                              client=self.address_string(),
                              line=fmt % args)

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?")[0] == "/debug/timeline":
                    return self._timeline()
                if self.path.split("?")[0] == "/debug/sched":
                    return self._sched()
                if self.path.split("?")[0] == "/debug/incidents":
                    return self._incidents()
                if self.path == "/metrics":
                    if server.registry is None:
                        return self._json(404, {"error": "metrics disabled "
                                                "(--no-metrics)"})
                    body = server.registry.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4; "
                                     "charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path != "/health":
                    return self._json(404, {"error": "unknown path"})
                self._json(200, server._health_payload())

            def _timeline(self):
                """GET /debug/timeline: the engine's recent span timeline
                (request → prefill/decode windows, obs/spans.py).
                Default: Chrome-trace JSON — save it and load it straight
                into Perfetto / chrome://tracing; ?format=ndjson streams
                one span object per line for log shippers;
                ?trace=<trace_id> filters to ONE distributed trace's
                spans (the cross-pool join view)."""
                from urllib.parse import parse_qs, urlparse

                spans = server.engine._spans
                if spans is None:
                    return self._json(404, {"error": "timeline disabled "
                                            "(--no-metrics)"})
                q = parse_qs(urlparse(self.path).query)
                trace_id = (q.get("trace") or [None])[0]
                if (q.get("format") or [None])[0] == "ndjson":
                    body = spans.export_ndjson(trace_id).encode()
                    ctype = "application/x-ndjson"
                else:
                    body = json.dumps(spans.export_chrome(trace_id)).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sched(self):
                """GET /debug/sched: the per-dispatch scheduler census
                ring + the cost-ledger state. Default: one
                JSON document (census totals + ring tail, open-ledger
                snapshots, closed tail, grand/per-class cost columns);
                ?format=ndjson streams one census record per line for
                log shippers; ?n=<k> bounds both tails (default 64)."""
                from urllib.parse import parse_qs, urlparse

                eng = server.engine
                q = parse_qs(urlparse(self.path).query)
                try:
                    n = int((q.get("n") or ["64"])[0])
                except ValueError:
                    return self._json(400, {"error": "n must be an "
                                            "integer"})
                census, book = eng.sched_census, eng.ledger_book
                if (q.get("format") or [None])[0] == "ndjson":
                    body = "".join(
                        json.dumps(r, sort_keys=True) + "\n"
                        for r in census.tail(n)).encode()
                    ctype = "application/x-ndjson"
                else:
                    doc = census.to_json(tail=n)
                    doc["open_ledgers"] = book.open_snapshots()
                    doc["closed_tail"] = book.closed_tail(n)
                    doc["cost_totals"] = book.grand_totals()
                    doc["cost_by_class"] = book.class_rollup()
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _incidents(self):
                """GET /debug/incidents: the watchtower's incident log
                + detector states + the signal-ring tail.
                Default: one JSON document (Watchtower.to_json);
                ``?format=ndjson`` streams one incident per line for
                log shippers; ``?n=<k>`` bounds the incident tail and
                the ring tail (default 64); ``?kind=<detector>``
                filters the ndjson stream to one detector kind."""
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    n = int((q.get("n") or ["64"])[0])
                except ValueError:
                    return self._json(400, {"error": "n must be an "
                                            "integer"})
                kind = (q.get("kind") or [None])[0]
                watch = server._watch
                if (q.get("format") or [None])[0] == "ndjson":
                    body = "".join(
                        json.dumps(inc.to_json(), sort_keys=True) + "\n"
                        for inc in watch.incidents(n, kind)).encode()
                    ctype = "application/x-ndjson"
                else:
                    doc = watch.to_json(tail=n)
                    doc["incident_log"] = [
                        inc.to_json() for inc in watch.incidents(n, kind)]
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path == "/profile":
                    return self._profile()
                if self.path == "/prefill":
                    return self._prefill_handoff()
                if self.path != "/generate":
                    return self._json(404, {"error": "unknown path"})
                if server.health.state in ("draining", "stopped"):
                    # drain contract: admission stops FIRST; clients get a
                    # clean retryable refusal, never a dropped request
                    server.count_reject("draining")
                    return self._json(503, {"error": "server is draining; "
                                            "retry after restart"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("body must be a JSON object")
                    stream = bool(payload.get("stream", False))
                    req = server.make_request(payload)
                except OversizedRequest as e:
                    server.count_reject("oversized")
                    return self._json(400, {"error": str(e)})
                except (ValueError, KeyError, TypeError) as e:
                    server.count_reject("bad_request")
                    return self._json(400, {"error": str(e)})
                if server.disagg_role == "decode":
                    req, submit = server.remote_prefill(req)
                else:
                    def submit(r=req):
                        server.engine.submit(r)
                if stream:
                    return self._stream(req, submit)
                if submit is not None and not server._submit_open(submit):
                    server.count_reject("draining")
                    return self._json(503, {"error": "server is draining; "
                                            "retry after restart"})
                req.done.wait()
                if req.error is not None:
                    return self._json(500, {"error": req.error})
                text = server.decode(req)
                self._json(200, {"text": text, "tokens": req.out,
                                 "steps": len(req.out)})

            def _prefill_handoff(self):
                """POST /prefill (prefill role): the decode pool's RPC.
                Body: {"tokens": [ids], "steps": N, "temperature"?,
                "topp"?, "seed"?, "class"?, "trace"?}. Runs the prompt's
                prefill and samples the FIRST token, publishes the full
                prompt pages on the page channel, and returns the
                request's journal record for the decode pool to re-admit,
                or {"final": true, ...} when the stream ended inside the
                prefill cut."""
                from .disagg import (HANDOFF_CAT, SPAN_HANDOFF_RECV,
                                     encode_handoff_pages, entry_for_stub,
                                     prefill_stub, stub_needs_handoff)
                from .journal import entry_to_wire
                from .pagewire import record_payload_bytes

                if server.disagg_role != "prefill":
                    return self._json(404, {"error": "not a prefill pool"})
                if server.health.state in ("draining", "stopped"):
                    server.count_reject("draining")
                    return self._json(503, {"error": "draining"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    tokens = [int(t) for t in payload["tokens"]]
                    steps = int(payload["steps"])
                    if not tokens or steps < 1 \
                            or len(tokens) > server.spec.seq_len:
                        raise ValueError(
                            f"bad handoff prompt/steps ({len(tokens)} "
                            f"tokens, {steps} steps)")
                    temp = payload.get("temperature")
                    topp = payload.get("topp")
                    seed = payload.get("seed")
                    slo_class = payload.get("class")
                except (ValueError, KeyError, TypeError) as e:
                    server.count_reject("bad_request")
                    return self._json(400, {"error": str(e)})
                # continue the decode pool's trace from the RPC's
                # traceparent: the recv half of the cross-pool anchor pair.
                # The drop-traceparent mutation severs it here.
                trace_hdr = payload.get("trace")
                chaos = server.engine._chaos
                if trace_hdr is not None and chaos is not None \
                        and chaos.trace_drop():
                    trace_hdr = None
                recv_parent = None
                if trace_hdr:
                    try:
                        recv_parent = tracectx.parse_header(str(trace_hdr))
                    except ValueError:
                        recv_parent = None
                recv = (recv_parent.child() if recv_parent is not None
                        else tracectx.mint())
                t_recv0 = time.perf_counter()
                stub, _ = prefill_stub(
                    tokens, steps,
                    temperature=None if temp is None else float(temp),
                    topp=None if topp is None else float(topp),
                    seed=None if seed is None else int(seed),
                    slo_class=slo_class)
                stub.trace = recv.child()
                server.engine.submit(stub)
                stub.done.wait()

                def recv_span(pages: int) -> None:
                    if server.engine._spans is not None:
                        server.engine._spans.add(
                            SPAN_HANDOFF_RECV, HANDOFF_CAT, t_recv0,
                            time.perf_counter() - t_recv0, pages=pages,
                            **tracectx.span_fields(recv))

                if stub.error is not None:
                    return self._json(500, {"error": stub.error})
                if not stub_needs_handoff(stub):
                    if server._disagg_obs is not None:
                        # wirecheck: allow[W002] a counter's label child
                        server._disagg_obs.handoffs["local"].inc()
                    recv_span(0)
                    return self._json(200, {"final": True,
                                            "out": stub.out})
                try:
                    entry = entry_for_stub(server.engine, stub)
                except ValueError as e:  # sampled stream, no journal
                    return self._json(500, {"error": str(e)})
                payloads = server.engine.export_prefix_sync(tokens)
                records = encode_handoff_pages(payloads)
                hid = f"h{stub.index}"
                server._page_channel.publish(hid, records,
                                             trace=entry.trace)
                recv_span(len(records))
                if server._disagg_obs is not None:
                    obs = server._disagg_obs
                    # wirecheck: allow[W002] a counter's label child
                    obs.handoffs["shipped"].inc()
                    if records:
                        # PAYLOAD bytes (the budget's unit, framing left
                        # out), reconcilable against dcn_handoff_budget
                        obs.pages_shipped.inc(len(records))
                        obs.bytes_shipped.inc(sum(
                            record_payload_bytes(r) for r in records))
                    obs.queue_depth.set(server._page_channel.queue_depth)
                self._json(200, {
                    "record": entry_to_wire(entry),
                    "hid": hid, "n_pages": len(records),
                    "channel_port": server._page_channel.port})

            def _profile(self):
                """POST /profile: capture a torch.profiler trace for N
                seconds while the server keeps serving. One capture per
                process -> 409 on overlap. Every graph was captured
                before the listener opened, so a profiler start never
                meets an open graph capture."""
                import tempfile

                from ..obs import profiler

                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("body must be a JSON object")
                    seconds = float(payload.get("seconds", 5.0))
                    trace_dir = payload.get("dir") \
                        or profiler.env_profile_dir() \
                        or tempfile.mkdtemp(prefix="dllama-profile-")
                    profiler.start_capture(trace_dir, seconds)
                except RuntimeError as e:  # capture already in flight
                    return self._json(409, {"error": str(e)})
                except OSError as e:
                    # unwritable/uncreatable trace dir (bad
                    # DLLAMA_PROFILE_DIR): a server-side env problem, and
                    # the capture never started — the next request may
                    # name a good dir
                    return self._json(500, {"error": f"trace dir: {e}"})
                except (ValueError, KeyError, TypeError) as e:
                    return self._json(400, {"error": str(e)})
                self._json(200, {"dir": trace_dir, "seconds": seconds})

            def _stream(self, req, submit=None):
                """Chunked newline-delimited JSON, one line per token.

                The scheduler thread only enqueues (on_token must never
                block the decode loop on a slow client socket); THIS
                handler thread drains the queue and does the blocking
                writes. ``submit`` hands the request to the engine AFTER
                the hook is registered (the decode role passes its ingest
                closure); None with ``done`` already set means the
                request completed on the prefill peer: its tokens are
                replayed."""
                import queue

                q: queue.Queue = queue.Queue()
                req.on_token = q.put
                me = threading.current_thread()

                def headers():
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                def chunk(obj):
                    body = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(body):x}\r\n".encode() + body
                                     + b"\r\n")
                    self.wfile.flush()

                if submit is None and req.done.is_set():
                    # completed inside the peer's prefill cut: replay the
                    # finished stream as one burst
                    try:
                        headers()
                        prev = req.tokens[0]
                        for tok in req.out:
                            piece = server.tokenizer.decode_piece(prev, tok)
                            prev = tok
                            chunk({"token": tok,
                                   "piece": piece.decode(
                                       "utf-8", errors="replace")})
                        chunk({"done": True, "text": server.decode(req),
                               "steps": len(req.out)})
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except OSError:
                        pass
                    return

                # register with the server so stop() can join this thread
                # once the request is woken — without the registry a
                # handler blocked in q.get outlives the server silently
                if not server._submit_open(
                        submit or (lambda: server.engine.submit(req)), me):
                    server.count_reject("draining")
                    return self._json(503, {"error": "server is draining; "
                                            "retry after restart"})
                prev = req.tokens[0]
                sent = 0
                try:
                    headers()
                    while True:
                        try:
                            tok = q.get(timeout=0.1)
                        except queue.Empty:
                            if req.done.is_set() and sent == len(req.out):
                                break
                            continue
                        if not sent:  # the stream has begun
                            with server._streams_lock:
                                server._streams.add(me)
                        piece = server.tokenizer.decode_piece(prev, tok)
                        prev = tok
                        sent += 1
                        chunk({"token": tok,
                               "piece": piece.decode("utf-8",
                                                     errors="replace")})
                    if req.error is not None:
                        chunk({"done": True, "error": req.error})
                    else:
                        chunk({"done": True, "text": server.decode(req),
                               "steps": len(req.out)})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    # client went away mid-stream: cancel in the ENGINE —
                    # a queued request completes now, an in-flight one is
                    # swept before the next dispatch, freeing its slot and
                    # KV pages immediately instead of decoding the rest of
                    # the budget (or another whole fused chain) for nobody
                    server.engine.cancel(req)
                finally:
                    with server._streams_lock:
                        server._handlers.discard(me)
                        server._streams.discard(me)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._threads: list[threading.Thread] = []

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def count_reject(self, reason: str) -> None:
        """Feed the admission_rejected{reason} series (no-op dark)."""
        if self.engine._obs is not None:
            self.engine._obs.reject(reason)

    def make_request(self, payload: dict) -> Request:
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        prompt = payload.get("prompt", "")
        if not isinstance(prompt, str):
            raise ValueError("prompt must be a string")
        steps = int(payload.get("steps", self.default_steps))
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if steps > self.spec.seq_len:
            raise OversizedRequest(
                f"steps must be in 1..{self.spec.seq_len}, got {steps}")
        temp = payload.get("temperature")
        topp = payload.get("topp")
        seed = payload.get("seed")
        slo_class = payload.get("class")
        if slo_class is not None:
            if self.slo_policy is None:
                raise ValueError(
                    "request names an SLO class but the server has no "
                    "--slo policy")
            self.slo_policy.resolve(str(slo_class))  # unknown -> 400
            slo_class = str(slo_class)
        tokens = self.tokenizer.encode(prompt, bos=True, eos=False)
        if len(tokens) > self.spec.seq_len:
            # the model literally cannot hold this prompt; truncating
            # silently would return an answer to a question never asked
            raise OversizedRequest(
                f"prompt encodes to {len(tokens)} positions, over the "
                f"model's seq_len {self.spec.seq_len}")
        return Request(tokens=tokens, steps=steps,
                       temperature=None if temp is None else float(temp),
                       topp=None if topp is None else float(topp),
                       seed=None if seed is None else int(seed),
                       slo_class=slo_class,
                       # trace minted at INGRESS: the id every span and
                       # journal record of this request's life carries
                       trace=tracectx.mint())

    def decode(self, req: Request) -> str:
        from .continuous import decode_stream

        return decode_stream(self.tokenizer, req.tokens[0], req.out)

    def remote_prefill(self, req: Request):
        """Decode-role routing: a prompt of at least ``handoff_min_pages``
        full pages goes to the prefill peer (POST /prefill), whose reply is
        the finished stream (it ended inside the prefill cut) or a journal
        record and page-channel coordinates; the shipped pages are fetched,
        CRC-verified, and handed to the scheduler with the re-admission
        request. Shorter prompts, and ANY peer failure, run locally.

        Returns ``(request, submit_fn)``: the request to track (the
        original, or the re-admission) and a thunk that hands it to the
        engine, None when it is already complete. Callers register their
        streaming hooks BEFORE calling the thunk."""
        import urllib.request

        from .disagg import HANDOFF_CAT, SPAN_HANDOFF_SEND, decode_request
        from .journal import entry_from_wire
        from .page_channel import PageChannelClient

        local = (req, lambda: self.engine.submit(req))
        n_full = (len(req.tokens) - 1) // max(self.engine.page_size, 1)
        if n_full < self.handoff_min_pages:
            if self._disagg_obs is not None:
                # wirecheck: allow[W002] a counter's label child
                self._disagg_obs.handoffs["local"].inc()
            return local
        t0 = time.monotonic()
        # the RPC span, the send half of the cross-pool anchor pair: its
        # traceparent rides the POST body
        rpc = (req.trace.child() if req.trace is not None
               else tracectx.mint())
        t_send0 = time.perf_counter()

        def send_span(pages: int) -> None:
            if self.engine._spans is not None:
                self.engine._spans.add(
                    SPAN_HANDOFF_SEND, HANDOFF_CAT, t_send0,
                    time.perf_counter() - t_send0, pages=pages,
                    **tracectx.span_fields(rpc))

        dreq = None
        resp = None
        try:
            body = json.dumps({
                "tokens": req.tokens, "steps": req.steps,
                "temperature": req.temperature, "topp": req.topp,
                "seed": req.seed, "class": req.slo_class,
                "trace": rpc.to_header()}).encode()
            rq = urllib.request.Request(
                f"http://{self.disagg_peer}/prefill", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(rq, timeout=120) as r:
                resp = json.loads(r.read())
            if resp.get("final"):
                req.out.extend(int(t) for t in resp["out"])
                req.done.set()
                send_span(0)
                return req, None
            entry = entry_from_wire(resp["record"])
            dreq = decode_request(entry, req.steps)
            if self.engine._journal is not None:
                # the durability point: the admit record lands BEFORE any
                # page moves, so a crash mid-transfer recovers the request
                self.engine.prejournal(dreq)
            host = self.disagg_peer.rsplit(":", 1)[0]
            client = PageChannelClient(f"{host}:{resp['channel_port']}")
            planes = client.fetch(resp["hid"], int(resp["n_pages"]))
            prompt = list(req.tokens)
            if self._disagg_obs is not None:
                obs = self._disagg_obs
                # wirecheck: allow[W002] a counter's label child
                obs.handoffs["shipped"].inc()
                obs.handoff_latency.observe(time.monotonic() - t0)
            send_span(int(resp["n_pages"]))
            log_event("disagg.handoff_shipped", None, trace=rpc,
                      peer=self.disagg_peer, pages=int(resp["n_pages"]))
            return dreq, (lambda: self.engine.ingest_remote(
                prompt, planes, dreq))
        except (OSError, ValueError, KeyError, TypeError) as e:
            log_event("disagg.handoff_failed",
                      f"🔶 handoff to {self.disagg_peer} failed "
                      f"({type(e).__name__}: {e}); serving locally",
                      file=sys.stderr, trace=rpc,
                      error=f"{type(e).__name__}: {e}")
            if dreq is not None:
                # the fallback serves the ORIGINAL request: retire the
                # prejournaled life, or a recovery would replay it too
                self.engine.abandon_prejournaled(dreq)
            if resp is not None and resp.get("hid"):
                # best effort: the prefill pool drops the published pages
                try:
                    host = self.disagg_peer.rsplit(":", 1)[0]
                    PageChannelClient(
                        f"{host}:{resp['channel_port']}",
                        connect_window=2.0).ack(resp["hid"])
                except (OSError, ValueError, KeyError):
                    pass  # the channel's retention cap bounds the leak
            if self._disagg_obs is not None:
                # wirecheck: allow[W002] a counter's label child
                self._disagg_obs.handoffs["failed"].inc()
            return local

    def _health_payload(self) -> dict:
        """Assemble the GET /health JSON (the fleet plane's primary
        scrape surface — the registered producer of wiremodel's
        "health" format). Shared by the HTTP handler and the watch
        plane's self-scrape (watch_tick), so the detectors see exactly
        the payload a remote scraper would."""
        eng = self.engine
        with eng._lock:
            queued = len(eng._queue)
        active = sum(not s.free for s in eng._pool)
        payload = {
            "schema": HEALTH_SCHEMA,
            "state": self.health.state,
            "active": active,
            "queued": queued,
            "queue_depth": queued,
            "slots": eng.slots,
            "steps": eng.stats.steps,
            "generated_tokens": eng.stats.tokens,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "occupancy": round(active / eng.slots, 4),
            # admission-pressure counters: page-starved
            # slot pauses and dry-pool head-of-queue requeues
            "pauses": eng.stats.pauses,
            "requeues": eng.stats.requeues,
        }
        if eng.allocator is not None:
            # paged-KV capacity surface: pool shape,
            # occupancy, the KV quantization in play, and the
            # pool planes' GLOBAL logical bytes (whole pool
            # across tp shards; per-device is /tp) — the
            # /metrics dllama_kv_quant_info / page-pool gauges'
            # JSON twin
            a = eng.allocator
            payload["paged_kv"] = {
                "page_size": a.page_size,
                "pages": a.n_pages,
                "pages_free": a.n_free,
                "kv_quant": eng.kv_quant,
                "pool_bytes": eng.pool_bytes,
                "prefix_hit_rate": round(a.hit_rate, 4),
                # raw hit/miss COUNTS: the fleet
                # plane recomputes aggregate hit rates from
                # summed counts, never from averaged ratios
                "prefix_hits": a.prefix_hits,
                "prefix_misses": a.prefix_misses,
                "prefill_tokens_saved": a.tokens_saved,
                "evictions": a.evictions,
            }
            if a.tiered:
                # the KV tiers: per-tier page population, promotion and
                # demotion flow, the prefill tokens the spilled tiers
                # rescued (the dllama_kv_tier_pages series' JSON twin)
                payload["kv_tiers"] = {
                    "pages": a.tier_page_counts(),
                    "host_capacity": (a.host.n_pages
                                      if a.host else 0),
                    "disk_live_bytes": (a.disk.live_bytes
                                        if a.disk else 0),
                    "disk_budget_bytes": (a.disk.budget_bytes
                                          if a.disk else 0),
                    "demotions": dict(a.demotions),
                    "promotions": dict(a.promotions),
                    "prefill_tokens_saved_by_tier":
                        dict(a.tokens_saved_by_tier),
                    "crc_drops": a.crc_drops,
                }
        if self.disagg_role is not None:
            # the disaggregated topology: this pool's role, its peer and
            # the handoff backlog (the dllama_handoff_* series' twin)
            payload["disagg"] = {
                "role": self.disagg_role,
                "peer": self.disagg_peer,
                "page_channel_port": (
                    self._page_channel.port
                    if self._page_channel is not None else None),
                "handoff_queue_depth": (
                    self._page_channel.queue_depth
                    if self._page_channel is not None else 0),
            }
            if eng.allocator is not None:
                payload["disagg"]["pages_adopted"] = \
                    eng.allocator.remote_adopted
        if self.journal is not None:
            # recovery bookkeeping: requests replayed from the
            # journal at startup + append volume since
            payload["journal"] = {
                "path": self.journal.path,
                "fsync": self.journal.fsync,
                "recovered": self.recovered,
                "records": self.journal.records_total,
            }
        if self._watchdog is not None:
            payload["watchdog"] = {
                "timeout_s": self._watchdog.timeout_s,
                "trips": self._watchdog.trips,
            }
        if eng.slo_tracker is not None:
            # per-class attempted/met/violated/failed + attainment
            # + goodput (obs/slo.SLOTracker.snapshot)
            payload["slo"] = eng.slo_tracker.snapshot()
        if eng._obs is not None:
            payload["admission_rejected"] = \
                eng._obs.rejected_total()
        # cost-accounting surface: census dispatch
        # totals + ledger book counts and per-class cost columns
        # — GET /debug/sched's summary twin, the block the fleet
        # plane (obs/fleet.signals_from_health) sums across
        # replicas
        book = eng.ledger_book
        payload["sched"] = {
            "census": eng.sched_census.totals(),
            "ledgers": {"opened": book.opened_n,
                        "closed": book.closed_n,
                        "open": book.n_open},
            "cost_totals": book.grand_totals(),
            "cost_by_class": book.class_rollup(),
        }
        if eng.spec_k:
            # speculative decoding health: proposal
            # volume + accept rate of the n-gram self-drafter
            payload["speculative"] = {
                "k": eng.spec_k,
                "proposed": eng.stats.spec_proposed,
                "accepted": eng.stats.spec_accepted,
                "accept_rate": round(eng.stats.spec_accept_rate, 4),
            }
        # incident-detection heartbeat: detection-plane
        # tick count + per-kind incident totals and hysteresis states
        # (evidence stays on /debug/incidents — health is a heartbeat,
        # not a forensics dump)
        payload["watch"] = self._watch.snapshot()
        if self._tp is not None:
            from ..ops._build import ALL
            from ..parallel import collectives

            g = eng.group
            payload["tp"] = {"ranks": g.size, "scheme": eng.model.scheme,
                             "backend": g.backend,
                             "plans_sent": self._tp.sent,
                             "last_digest": self._tp.last_digest,
                             "plan_ms": self._tp.plan_ms(),
                             "timeout_s": self._tp.timeout_s,
                             "error": self.tp_error,
                             "forwards": eng.model.forwards,
                             "logit_forwards": eng.model.logit_forwards,
                             "collectives": collectives.CENSUS.kind_counts(),
                             # rank 0's kernel launches since it started
                             "launches": {k.symbol: k.launches
                                          for k in ALL if k.launches}}
        if self.registry is not None:
            for key, name in (
                    ("ttft_s", "dllama_request_ttft_seconds"),
                    ("token_latency_s",
                     "dllama_request_decode_token_seconds"),
                    ("queue_wait_s",
                     "dllama_request_queue_wait_seconds")):
                h = self.registry.get(name)
                s = h.summary()
                payload[key] = {k: round(v, 6) if k != "count"
                                else v for k, v in s.items()}
        return payload

    def watch_tick(self) -> list:
        """One detection-plane scrape of THIS process: assemble the
        /health payload, fold it (plus the parsed /metrics exposition)
        into a fleet row, and feed the watchtower — exactly what a
        remote scraper's tick would see. Returns the NEW incidents
        (transitions into firing). Called by the ``_watch_loop``
        supervisor thread when ``watch_interval_s > 0``; tests and sim
        simulations call it directly on their own clock."""
        from ..obs.fleet import parse_metrics, signals_from_health
        from ..obs.watch import sample_from_signals

        row = signals_from_health("self", self._health_payload())
        samples = (parse_metrics(self.registry.expose())
                   if self.registry is not None else None)
        return self._watch.observe("self", sample_from_signals(row,
                                                               samples))

    def _watch_loop(self):
        """Supervisor thread (threadmodel ENTRYPOINTS): periodic
        watch_tick every ``watch_interval_s`` seconds until stop() sets
        the event. Detector exceptions are logged, never fatal — a
        broken detector must not take the watch plane down."""
        while not self._watch_stop.wait(self.watch_interval_s):
            try:
                self.watch_tick()
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                log_event("watch.error",
                          f"🔶 watch tick failed: {e!r}",
                          file=sys.stderr,
                          error=f"{type(e).__name__}: {e}")

    def _on_incident(self, inc) -> None:
        """Watchtower firing hook (obs/watch.Incident): auto-forensics.
        Note the incident into the flight-recorder ring and dump a
        bundle with reason="incident" + the detector kind — the
        postmortem snapshot taken AT detection time, not at the
        operator's later convenience."""
        from ..obs.flightrec import REASON_INCIDENT

        log_event("watch.incident",
                  f"🔶 incident #{inc.seq} {inc.kind} on {inc.replica} "
                  f"tick {inc.tick}: {inc.note}",
                  file=sys.stderr, kind=inc.kind, replica=inc.replica,
                  tick=inc.tick, note=inc.note)
        self._flightrec_dump(REASON_INCIDENT, incident_kind=inc.kind)

    def _flightrec_dump(self, reason: str,
                        incident_kind: str | None = None) -> None:
        """One postmortem bundle (obs/flightrec): note the trigger into
        the ring, then write a bundle file when a directory is
        configured. Never raises — this runs on fault paths."""
        self.flightrec.note(reason, state=self.health.state,
                            outstanding=self._outstanding(),
                            **({"incident_kind": incident_kind}
                               if incident_kind else {}))
        if not self.flightrec_dir:
            return
        try:
            path = self.flightrec.dump(self.flightrec_dir, reason,
                                       incident_kind=incident_kind)
            log_event("flightrec.dump",
                      f"🔶 flight recorder: {reason} bundle -> {path}",
                      file=sys.stderr, path=path, reason=reason)
        except OSError as e:
            log_event("flightrec.failed",
                      f"🔶 flight recorder dump failed: {e}",
                      file=sys.stderr, error=f"{type(e).__name__}: {e}")

    def _on_hang(self, elapsed_s: float):
        """Watchdog trip (monitor thread): a dispatch overran its deadline.
        Detection only — mark the server degraded (and drop a flight-
        recorder bundle: the hung state IS the postmortem moment); the
        scheduler flips it back to serving once dispatches complete on
        time again."""
        try:
            self.health.to("degraded")
        except ValueError:
            pass  # already draining/stopped: the drain verdict wins
        self._flightrec_dump("watchdog")

    def _scheduler(self):
        """The device loop (one thread). Its first act is the device
        set-up start() waits for: the current device is per thread, and
        every graph the dispatches replay is captured here, before the
        listener opens."""
        try:
            if self._device_index is not None:
                torch.cuda.set_device(self._device_index)
            self.engine.capture_graphs()
        except BaseException as e:  # start() re-raises it on its thread
            self._ready_error = e
            return
        finally:
            self._ready.set()
        while not self._shutdown.is_set():
            if self._tp is not None and not self.engine.has_work():
                # idle: no plan, no dispatch; a follower that died while
                # the server idled ends it all the same
                gone = self._tp_alive() if self._tp_alive else None
                if gone is not None:
                    self._tp_failed(RuntimeError(gone))
                    return
                time.sleep(_IDLE_SLEEP_S)
                continue
            try:
                active = self.engine.step_many(self.engine.block_steps,
                                               quiet=self.quiet)
            except Exception as e:
                if self._tp is not None:
                    self._tp_failed(e)
                    return
                # a dead scheduler must not leave clients blocked forever:
                # fail everything queued/in flight (handlers answer 500) and
                # keep the loop alive — a persistent device fault just fails
                # each subsequent request the same way
                import traceback

                traceback.print_exc()
                log_event("scheduler.error",
                          f"🌐 scheduler step failed: {e!r}; failing "
                          f"pending requests",
                          error=f"{type(e).__name__}: {e}")
                self.engine.fail_all(f"{type(e).__name__}: {e}")
                time.sleep(0.1)
                continue
            if (self.health.state == "degraded"
                    and self._watchdog is not None
                    and not self._watchdog.overdue):
                # the hang resolved: dispatches are landing again (never
                # flip back while an armed dispatch is still overrunning)
                try:
                    self.health.to("serving")
                except ValueError:
                    pass  # drain/stop raced us: their state wins
            if active == 0:
                time.sleep(_IDLE_SLEEP_S)

    def _tp_failed(self, e: BaseException) -> None:
        """A dispatch over the tp group failed: the group cannot go on in
        step. Fail everything pending (handlers answer as after fail_all)
        and end serve_forever; the caller exits non-zero."""
        import traceback

        traceback.print_exc()
        self.tp_error = f"{type(e).__name__}: {e}"
        log_event("scheduler.tp_failed",
                  f"🔶 tp dispatch failed: {e!r}; failing pending requests "
                  f"and stopping", error=self.tp_error)
        self.engine.fail_all(f"tp group failed: {self.tp_error}")
        self._shutdown.set()
        self._stop_requested.set()

    def _send_shutdown(self) -> None:
        """Under tp: the shutdown plan, once, after the scheduler stopped
        (never after a failed dispatch: the group is gone)."""
        if self._tp is None or self.tp_error is not None:
            return
        try:
            self._tp.send_shutdown()
        except Exception as e:  # a follower already gone
            self.tp_error = f"{type(e).__name__}: {e}"

    def _submit_open(self, submit, handler=None) -> bool:
        """Run ``submit`` (hand a request to the engine) unless drain() or
        stop() has closed admission, and register ``handler`` (a
        streaming handler's thread) for stop() to join. The check, the
        submit and the registration hold ``_streams_lock``, which the
        closing takes too, so no request reaches the engine after the
        shutdown paths counted the outstanding work (it would never be
        woken). False when refused."""
        with self._streams_lock:
            if self._closed:
                return False
            submit()
            if handler is not None:
                self._handlers.add(handler)
            return True

    def _close_admission(self) -> None:
        with self._streams_lock:
            self._closed = True

    def _outstanding(self) -> int:
        with self.engine._lock:
            queued = len(self.engine._queue) + len(self.engine._intake)
        return queued + sum(not s.free for s in self.engine._pool)

    def _scheduler_stopped(self, timeout: float) -> bool:
        """Join the scheduler thread (started first); True once it is no
        longer running. suspend()/fail_all() walk the slot pool, so the
        shutdown paths must never run them concurrently with a live
        scheduler step — when this times out (a wedged dispatch, the
        watchdog's scenario) the caller SKIPS them: journaled work stays
        live for the next process, which is the safe outcome."""
        for t in self._threads[:1]:
            t.join(timeout=timeout)
            if t.is_alive():
                log_event("server.scheduler_wedged",
                          f"🔶 scheduler did not stop within {timeout:.0f}s "
                          f"(wedged dispatch?) — leaving in-flight work "
                          f"journaled instead of racing a live step",
                          file=sys.stderr, timeout_s=timeout)
                return False
        return True

    def start(self):
        """Start the scheduler thread, wait until it has set its device
        and captured the engine's graphs, then start the HTTP thread (and
        with ``watch_interval_s > 0`` the watch-plane thread) and return
        (non-blocking)."""
        for target in (self._scheduler, self.httpd.serve_forever,
                       self._watch_loop):
            if target == self._watch_loop and self.watch_interval_s <= 0:
                continue  # detectors still run on manual watch_tick()
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
            if target == self._scheduler:
                self._ready.wait()
                if self._ready_error is not None:
                    self._threads[0].join()
                    raise self._ready_error
        self.health.to("serving")

    def serve_forever(self):
        """Blocking entry (cmd_serve): serve until SIGTERM or Ctrl-C, then
        drain gracefully — stop admission, finish in-flight work within the
        drain budget, journal whatever remains — and return (exit 0)."""
        self.start()
        stop_requested = self._stop_requested
        prev_handler = None
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: stop_requested.set())
        except ValueError:
            pass  # not the main thread (tests): rely on stop()/drain()
        try:
            # a wait on the event, not a sleep loop: the signal interrupts
            # the lock wait, so the drain starts as the handler runs
            while not stop_requested.wait(1.0):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            self.drain()

    def drain(self, budget_s: float | None = None) -> int:
        """Graceful shutdown: stop admission (handlers 503), let the
        scheduler finish in-flight work for up to ``budget_s`` seconds,
        then journal whatever is still outstanding (suspend) — or fail it
        loudly when there is no journal — and stop. Returns the number of
        requests left journaled for the next process."""
        budget = self.drain_s if budget_s is None else budget_s
        t0 = time.monotonic()
        try:
            self.health.to("draining")
        except ValueError:
            return 0  # already stopped
        self._close_admission()
        # the SIGTERM postmortem bundle: state AS THE DRAIN BEGINS —
        # in-flight work, queue depth, journal tail, recent spans
        self._flightrec_dump("sigterm_drain")
        log_event("server.drain",
                  f"🌐 draining: admission stopped, "
                  f"{self._outstanding()} requests in flight, "
                  f"budget {budget:.1f}s",
                  outstanding=self._outstanding(), budget_s=budget)
        deadline = t0 + budget
        while self._outstanding() and time.monotonic() < deadline:
            time.sleep(0.01)
        # scheduler off BEFORE suspending: a step racing a retire-less
        # suspend could double-process a request's slot
        self._shutdown.set()
        sched_ok = self._scheduler_stopped(30)
        self._send_shutdown()
        remainder = self._outstanding()
        if remainder and sched_ok:
            if self.journal is not None:
                self.engine.suspend()
            else:
                self.engine.fail_all("server draining: request dropped "
                                     "(no --journal to recover from)")
        drain_s = time.monotonic() - t0
        if self._drain_hist is not None:
            self._drain_hist.observe(drain_s)
        journaled = remainder if self.journal is not None else 0
        if not remainder:
            msg = (f"🌐 drained in {drain_s:.2f}s: all in-flight work "
                   f"completed")
        elif self.journal is not None:
            msg = (f"🌐 drained in {drain_s:.2f}s: {remainder} requests "
                   f"journaled for recovery")
        else:
            msg = (f"🔶 drained in {drain_s:.2f}s: {remainder} requests "
                   f"DROPPED (no --journal to carry them over)")
        log_event("server.drained", msg, seconds=round(drain_s, 3),
                  journaled=journaled, dropped=remainder - journaled)
        self.stop()
        return remainder

    def stop(self):
        """Tear down every thread the server owns. Idempotent; safe from
        any thread. Requests still outstanding are failed (use drain() for
        the graceful path) so no handler stays blocked on done.wait or the
        stream queue — then the streaming handler threads are JOINED, not
        abandoned."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._close_admission()
        self._shutdown.set()
        # park the watch loop FIRST: a watch tick mid-teardown would
        # scrape a half-closed engine (the event also bounds the
        # _watch_loop thread's lifetime — threadmodel's joined_by)
        self._watch_stop.set()
        self.httpd.shutdown()
        sched_ok = self._scheduler_stopped(30)
        self._send_shutdown()
        for t in self._threads[1:]:
            t.join(timeout=5)
        if self._outstanding() and sched_ok:
            # stop() without drain(): wake every waiter NOW — handlers
            # answer 500/stream-error and their threads exit. With a
            # journal the interrupted work is suspended (recoverable),
            # without one it is failed loudly. Skipped when the
            # scheduler would not stop (_scheduler_stopped): walking the
            # pool under a live step risks double-frees — the journal
            # carries the work instead.
            if self.journal is not None:
                self.engine.suspend()
            else:
                self.engine.fail_all("server stopped")
        # join streaming handlers until the registry drains. A single
        # snapshot has a TOCTOU hole: a handler that registers AFTER the
        # snapshot (its request raced the shutdown) would never be
        # joined. Re-snapshot under the lock each pass — joins happen
        # OUTSIDE the lock so a handler's deregister (finally block)
        # can't deadlock against us.
        deadline = time.monotonic() + 5.0
        while True:
            with self._streams_lock:
                pending = [t for t in self._handlers if t.is_alive()]
            if not pending:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            for t in pending:
                t.join(timeout=max(0.05, remaining))
        self.httpd.server_close()
        if self._page_channel is not None:
            self._page_channel.close()
        self.engine.close()  # the KV tiers' uploader thread
        if self._watchdog is not None:
            self._watchdog.close()
        if self.journal is not None:
            self.journal.close()
        try:
            self.health.to("stopped")
        except ValueError:
            pass
