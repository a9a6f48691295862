"""The port's declared thread-ownership model (the JAX package's
analysis/threadmodel.py, for the port's runtime/ and obs/).

The host runtime runs several thread domains that touch shared state:
the scheduler loop, the HTTP streaming handlers, the KV PageUploader, the
page-channel and weight-stream servers, the watchdog/supervisor plane,
the profiler's capture thread and the chaos drills' relay threads; under
``serve --tp N`` rank 0's scheduler also sends each dispatch's plan
(runtime/tp_plan.PlanLeader) and the other ranks follow it
(``follow_loop``, their main thread). This module writes the contract down
as data, so ``analysis/threadcheck.py`` can enforce it statically:

* **domains**: every thread entrypoint is registered with the domain it
  runs and the join/stop path that bounds its lifetime (T004 rejects an
  unregistered ``threading.Thread`` target);
* **attribute families**: each mutable attribute family on the shared
  runtime objects has an owning domain and the lock (if any) that
  sanctions access from the others (T001 rejects a cross-domain write
  outside it; T005 a raw mutable object returned across domains);
* **crossing points**: METHOD_DOMAINS declares which methods are callable
  from which domains.

Quiesced setup and teardown (``drain``/``stop``/``suspend``/``recover``/
``close``: they run before the threads start or after the scheduler
parked) are the MAIN domain, exempt from the cross-domain write checks.
The CUDA side has one rule of its own, kept by the code rather than this
registry: every CUDA call of the engine (its captures, PageIO's copy
stream and events) runs on the scheduler thread.
"""

from __future__ import annotations

import dataclasses

# -- domains ---------------------------------------------------------------

SCHEDULER = "scheduler"    # the engine step loop (InferenceServer._scheduler)
HANDLER = "handler"        # ThreadingHTTPServer per-connection threads
UPLOADER = "uploader"      # PageUploader._run (dllama-kv-uploader)
CHANNEL = "channel"        # PageChannelServer serve_forever + its handlers
SUPERVISOR = "supervisor"  # StepWatchdog._monitor, supervise(), health plane
MAIN = "main"              # construction + quiesced teardown (trusted)
DRILL = "drill"            # chaos-drill helper threads (FlakyRelay)
CLIENT = "client"          # a tool's own client threads (tools/loadgen)

DOMAINS = (SCHEDULER, HANDLER, UPLOADER, CHANNEL, SUPERVISOR, MAIN, DRILL,
           CLIENT)

# domains exempt from the cross-domain write rules: ``main`` runs before
# the threads start or after they joined (quiesced teardown); ``drill``
# and ``client`` threads only touch their own sockets and records, never
# runtime families
EXEMPT_DOMAINS = frozenset({MAIN, DRILL, CLIENT})


# -- thread entrypoints (rule T004) ---------------------------------------


@dataclasses.dataclass(frozen=True)
class Entrypoint:
    """One registered ``threading.Thread`` target: the domain its thread
    executes and the join/stop path that bounds its lifetime (T004's
    registry test asserts ``joined_by`` is never empty — a thread with
    no documented stop path is the finding)."""

    key: str        # "Class.method" for self-targets, bare name otherwise
    domain: str
    spawned_by: str  # where the Thread() call lives (documentation)
    joined_by: str   # the stop path that joins/bounds the thread


ENTRYPOINTS: dict[str, Entrypoint] = {e.key: e for e in (
    Entrypoint("InferenceServer._scheduler", SCHEDULER,
               "InferenceServer.start",
               "InferenceServer._scheduler_stopped (join, 30s, wedge-"
               "detected)"),
    # ThreadingHTTPServer's accept loop; its per-connection handler
    # threads are registered via HANDLER_CLASSES below (the stdlib
    # spawns them, not our code)
    Entrypoint("serve_forever", CHANNEL,
               "InferenceServer.start / PageChannelServer.__init__ / "
               "io/stream.WeightServer.__init__",
               "httpd.shutdown() + thread join in stop()/close()"),
    Entrypoint("PageUploader._run", UPLOADER, "PageUploader.__init__",
               "PageUploader.close() sentinel (daemon backstop)"),
    Entrypoint("StepWatchdog._monitor", SUPERVISOR,
               "StepWatchdog.__init__",
               "StepWatchdog.close() (_closed flag + join)"),
    # chaos-drill relay threads: drill-local sockets only
    Entrypoint("_FlakyProxy._accept_loop", DRILL,
               "_FlakyProxy.__init__",
               "_FlakyProxy.close() closes the listener (daemon)"),
    Entrypoint("_FlakyProxy._relay", DRILL, "_FlakyProxy._accept_loop",
               "socket close unblocks; daemon backstop"),
    Entrypoint("pump_requests", DRILL, "_FlakyProxy._relay",
               "upstream close unblocks; daemon backstop"),
    # runtime/chaos.kill_tp_follower: the drill's client burst
    Entrypoint("post", DRILL, "runtime/chaos.kill_tp_follower",
               "each request's own timeout; joined by the drill"),
    # obs/profiler.start_capture: starts, sleeps and stops the profiler
    # on one thread (a profiler is stopped on the thread that started it)
    Entrypoint("run", SUPERVISOR, "obs/profiler.start_capture",
               "self-terminating after its seconds; wait_capture() "
               "waits for it (daemon)"),
    # tools/loadgen.replay_live: one client thread a request
    Entrypoint("one", CLIENT, "tools/loadgen.replay_live",
               "joined with the run's timeout"),
    # the watch plane's periodic self-scrape: one tick every
    # watch_interval_s, detectors + incident forensics ride on it
    Entrypoint("InferenceServer._watch_loop", SUPERVISOR,
               "InferenceServer.start (watch_interval_s > 0)",
               "InferenceServer.stop (_watch_stop event + thread join)"),
)}


# -- attribute families (rules T001/T005) ----------------------------------


@dataclasses.dataclass(frozen=True)
class AttrFamily:
    """A family of mutable attributes with one owner domain and (when
    cross-domain access is sanctioned at all) the lock that guards it.
    ``lock=None`` means the family is domain-private: ANY write reachable
    from a foreign domain is a finding — there is no lock to take."""

    owner_class: str
    attrs: tuple
    domain: str
    lock: str | None  # attribute name of the guarding lock, or None


FAMILIES: tuple[AttrFamily, ...] = (
    # the engine's cross-thread intake surface: handlers submit/cancel
    # and the DCN ingest path posts, the scheduler drains — everything
    # under the one engine lock
    AttrFamily("ContinuousEngine",
               ("_queue", "_remote_inbox", "_export_inbox", "_submitted",
                "_intake", "_cancels"),
               SCHEDULER, "_lock"),
    # scheduler-private engine state: no lock exists, so no foreign
    # domain may ever write it (the radix tree and KV accounting are
    # scheduler-owned by construction)
    AttrFamily("ContinuousEngine", ("cache", "_pool"), SCHEDULER, None),
    AttrFamily("PagePool", ("_free", "_ref"), SCHEDULER, None),
    AttrFamily("PrefixTree", ("_roots", "_n_nodes"), SCHEDULER, None),
    AttrFamily("PagedAllocator", ("_pending", "_jobs", "tier_pages"),
               SCHEDULER, None),
    # the promotion job's staged planes: uploader-owned; the scheduler's
    # inline-stage path writes it only at job construction (pragma'd as
    # a documented crossing — the job is not yet visible to the uploader)
    AttrFamily("_PromotionJob", ("staged",), UPLOADER, None),
    AttrFamily("PageUploader", ("staged_jobs",), UPLOADER, None),
    # the WAL: handler admits and scheduler tokens/retires serialize on
    # the journal's RLock
    AttrFamily("RequestJournal", ("_entries",), SCHEDULER, "_lock"),
    # request cost plane: handlers open (submit) and read (/health),
    # the scheduler charges and closes — all under the book's lock
    AttrFamily("LedgerBook", ("_open", "_closed", "_totals",
                              "opened_n", "closed_n"),
               SCHEDULER, "_lock"),
    AttrFamily("CensusRing", ("_ring", "dispatches", "total_steps",
                              "total_row_steps", "total_stall_steps",
                              "total_page_steps"),
               SCHEDULER, "_lock"),
    # the flight recorder: every domain notes, the supervisor plane dumps
    AttrFamily("FlightRecorder", ("_events", "dumps"), SUPERVISOR,
               "_lock"),
    # the incident-detection plane: the watch loop observes
    # (supervisor), handlers read snapshots/tails — all under each
    # object's own lock
    AttrFamily("Watchtower", ("_states", "_incidents", "incidents_total",
                              "_by_kind"),
               SUPERVISOR, "_lock"),
    AttrFamily("SignalRing", ("_rows", "_last", "_ticks", "rows_total"),
               SUPERVISOR, "_lock"),
    # streaming-handler registry on the server: handlers register/
    # deregister themselves, stop() joins — the TOCTOU fix
    # put it under its own lock
    AttrFamily("InferenceServer", ("_streams",), HANDLER,
               "_streams_lock"),
    AttrFamily("StepWatchdog",
               ("trips", "_deadline", "_armed_at", "_fired", "_closed"),
               SUPERVISOR, "_cond"),
    AttrFamily("PageChannelServer",
               ("_store", "_traces", "published_pages", "served_pages",
                "evicted_handoffs"),
               CHANNEL, "_lock"),
    # Prometheus instruments: every domain increments, under each
    # instrument's own lock
    AttrFamily("Counter", ("_value",), SCHEDULER, "_lock"),
    AttrFamily("Gauge", ("_value",), SCHEDULER, "_lock"),
    AttrFamily("Histogram", ("_counts", "_sum", "_count"), SCHEDULER,
               "_lock"),
)

# attr -> family (fallback lookup for bases whose class can't be
# resolved). Attr names MAY collide across classes (LedgerBook._closed
# vs StepWatchdog._closed) — the class-aware map below disambiguates
# whenever the writer's class is known.
FAMILY_BY_ATTR: dict[str, AttrFamily] = {}
FAMILY_BY_CLASS_ATTR: dict[tuple[str, str], AttrFamily] = {}
for _fam in FAMILIES:
    for _a in _fam.attrs:
        FAMILY_BY_ATTR.setdefault(_a, _fam)
        FAMILY_BY_CLASS_ATTR[(_fam.owner_class, _a)] = _fam


def family_for(cls, attr: str):
    """Class-aware family lookup. When the base's class is known it
    disambiguates colliding attr names; a registered class's same-named
    attr that is NOT in its own family is that class's private state,
    not a foreign family. Unknown class falls back to the attr map."""
    if cls is not None:
        fam = FAMILY_BY_CLASS_ATTR.get((cls, attr))
        if fam is not None:
            return fam
        if cls in CLASS_OWNER:
            return None
    return FAMILY_BY_ATTR.get(attr)


# -- per-class default owners and cross-domain method table ---------------

# a registered class's methods default to its owner domain unless listed
# in METHOD_DOMAINS or reached (via self-calls) from a listed method
CLASS_OWNER: dict[str, str] = {
    "ContinuousEngine": SCHEDULER,
    "PagePool": SCHEDULER,
    "HostPagePool": SCHEDULER,
    "DiskPageStore": SCHEDULER,
    "PrefixTree": SCHEDULER,
    "PagedAllocator": SCHEDULER,
    "_PromotionJob": UPLOADER,
    "PageUploader": UPLOADER,
    "RequestJournal": SCHEDULER,
    "LedgerBook": SCHEDULER,
    "CensusRing": SCHEDULER,
    "RequestLedger": SCHEDULER,   # single-writer by module contract
    "FlightRecorder": SUPERVISOR,
    "Watchtower": SUPERVISOR,
    "SignalRing": SUPERVISOR,
    "InferenceServer": MAIN,
    "Handler": HANDLER,           # nested HTTP handler class (server.py)
    "StepWatchdog": SUPERVISOR,
    "HealthMonitor": SUPERVISOR,
    "PageChannelServer": CHANNEL,
    "Counter": SCHEDULER,
    "Gauge": SCHEDULER,
    "Histogram": SCHEDULER,
    "Registry": SCHEDULER,
    "EngineMetrics": SCHEDULER,
    # serving over tp ranks: rank 0's plan point runs on its scheduler;
    # a follower's follow_loop runs on its main thread, the one engine
    # thread that rank has
    "PlanLeader": SCHEDULER,
    "PlanChannel": SCHEDULER,
    # the tier copies: pinned slab, copy stream and events, all driven
    # from the scheduler thread (stage_host also from the uploader)
    "PageIO": SCHEDULER,
}

# the sanctioned crossing points: methods callable from domains beyond
# their class's owner. This IS the registry of legal seams — a new
# cross-thread caller means a new row here, and threadcheck then holds
# the method to the strictest listed domain.
METHOD_DOMAINS: dict[str, frozenset] = {k: frozenset(v) for k, v in {
    # engine intake (HTTP handler threads + the scheduler's own
    # recovery/drain-remote re-submission path)
    "ContinuousEngine.submit": (HANDLER, SCHEDULER),
    "ContinuousEngine.cancel": (HANDLER,),
    "ContinuousEngine.prejournal": (HANDLER,),
    "ContinuousEngine.abandon_prejournaled": (HANDLER,),
    "ContinuousEngine.ingest_remote": (HANDLER,),
    "ContinuousEngine.export_prefix_sync": (HANDLER,),
    "ContinuousEngine._n_outstanding": (HANDLER, SCHEDULER),
    # quiesced teardown/recovery (scheduler parked first — see
    # InferenceServer._scheduler_stopped)
    "ContinuousEngine.suspend": (MAIN,),
    "ContinuousEngine.recover": (MAIN,),
    "ContinuousEngine.fail_all": (MAIN, SCHEDULER),
    "ContinuousEngine.close": (MAIN,),
    # construction helper: called only from __init__, before any thread
    # can alias the engine
    "ContinuousEngine._init_books": (MAIN,),
    # uploader intake rides a SimpleQueue (its own crossing point);
    # close() posts the sentinel from teardown
    "PageUploader.submit": (SCHEDULER,),
    # the uploader stages a promotion's planes into the pinned slab under
    # PageIO's stage condition; the scheduler releases and closes
    "PageIO.stage_host": (UPLOADER,),
    "PageIO.release": (SCHEDULER, UPLOADER),
    "PageIO.close": (MAIN,),
    # the plan channel: rank 0's scheduler sends, a follower's main
    # thread receives (follow_loop)
    "PlanChannel.send": (SCHEDULER, MAIN),
    "PlanChannel.send_shutdown": (SCHEDULER, MAIN),
    "PlanChannel.recv": (MAIN,),
    "PageUploader.close": (MAIN,),
    # WAL: admit lands on handler threads (write-AHEAD of the queue
    # insert), tokens/retire on the scheduler
    "RequestJournal.admit": (HANDLER, SCHEDULER),
    "RequestJournal.sync": (SCHEDULER, MAIN),
    "RequestJournal.close": (MAIN,),
    # cost plane: handler opens at submit, /health snapshots; the
    # scheduler closes at retire
    "LedgerBook.open_request": (HANDLER, SCHEDULER),
    "LedgerBook.close_request": (SCHEDULER,),
    "LedgerBook.grand_totals": (HANDLER, SCHEDULER),
    "LedgerBook.class_rollup": (HANDLER, SCHEDULER),
    "LedgerBook.open_snapshots": (HANDLER, SUPERVISOR),
    "CensusRing.record": (SCHEDULER,),
    "CensusRing.count_tokens": (SCHEDULER,),
    "CensusRing.tail": (HANDLER, SUPERVISOR),
    "CensusRing.totals": (HANDLER, SCHEDULER),
    # flight recorder: notes arrive from every plane; dumps fire from
    # the watchdog (supervisor) and the SIGTERM drain (main)
    "FlightRecorder.note": (HANDLER, SCHEDULER, SUPERVISOR, CHANNEL),
    "FlightRecorder.dump": (SUPERVISOR, MAIN),
    "FlightRecorder.snapshot_bundle": (SUPERVISOR, MAIN),
    "FlightRecorder.bind": (MAIN,),
    # server: handler threads register/deregister their streams; stop/
    # drain are quiesced teardown except the join loop, which must hold
    # the registry lock only to SNAPSHOT (T003 keeps joins outside it)
    "InferenceServer.stop": (MAIN, SUPERVISOR),
    "InferenceServer.drain": (MAIN, SUPERVISOR),
    "InferenceServer._outstanding": (HANDLER, MAIN, SUPERVISOR),
    "InferenceServer.count_reject": (HANDLER,),
    # the watch plane: /health handlers and the supervisor
    # watch loop both assemble the payload; ticks run on the supervisor
    # thread (tests and simulations tick from main)
    "InferenceServer._health_payload": (HANDLER, SUPERVISOR, MAIN),
    "InferenceServer.watch_tick": (SUPERVISOR, MAIN),
    "InferenceServer._on_incident": (SUPERVISOR, MAIN),
    "Watchtower.observe": (SUPERVISOR, MAIN),
    "Watchtower.snapshot": (HANDLER, SUPERVISOR, MAIN),
    "Watchtower.states": (HANDLER, SUPERVISOR, MAIN),
    "Watchtower.incidents": (HANDLER, SUPERVISOR, MAIN),
    "Watchtower.by_kind": (HANDLER, SUPERVISOR, MAIN),
    "Watchtower.to_json": (HANDLER, SUPERVISOR, MAIN),
    "SignalRing.observe": (SUPERVISOR, MAIN),
    "SignalRing.window": (HANDLER, SUPERVISOR, MAIN),
    "SignalRing.ticks": (HANDLER, SUPERVISOR, MAIN),
    "SignalRing.replicas": (HANDLER, SUPERVISOR, MAIN),
    "SignalRing.to_json": (HANDLER, SUPERVISOR, MAIN),
    # watchdog: the scheduler arms/disarms around each dispatch, the
    # monitor thread fires, /health reads
    "StepWatchdog.arm": (SCHEDULER,),
    "StepWatchdog.disarm": (SCHEDULER,),
    "StepWatchdog.__enter__": (SCHEDULER,),
    "StepWatchdog.__exit__": (SCHEDULER,),
    "StepWatchdog.overdue": (HANDLER, SCHEDULER, SUPERVISOR),
    "StepWatchdog.close": (MAIN,),
    "HealthMonitor.to": (HANDLER, SCHEDULER, SUPERVISOR, MAIN),
    # page channel: its own handler threads serve; the prefill server's
    # HTTP handlers publish
    "PageChannelServer.publish": (HANDLER,),
    "PageChannelServer.close": (MAIN,),
    # metrics: instruments are incremented from everywhere
    "Counter.inc": (HANDLER, SCHEDULER, SUPERVISOR, CHANNEL, UPLOADER),
    "Gauge.set": (HANDLER, SCHEDULER, SUPERVISOR, CHANNEL, UPLOADER),
    "Histogram.observe": (HANDLER, SCHEDULER, SUPERVISOR, CHANNEL,
                          UPLOADER),
    "Registry.expose": (HANDLER, SUPERVISOR, MAIN),
}.items()}

# methods exempt from domain propagation/checks entirely: object
# construction runs before any thread can alias the instance
CONSTRUCTION_METHODS = frozenset({"__init__", "__new__",
                                  "__post_init__"})


# -- lock identity hints (rule T002/T003) ----------------------------------

# attribute names that denote locks when seen as ``with self.<name>:`` /
# ``with obj.<name>:`` — the declared set plus anything lock-shaped
LOCK_ATTRS = frozenset({"_lock", "_cond", "_streams_lock", "_stage_cv"})

# second-to-last component of a dotted lock expression -> owning class,
# so ``self.engine._lock`` keys the SAME graph node as the engine's own
# ``self._lock`` (lock identity must survive the attribute path used to
# reach it, or the order graph falls apart into aliases)
INSTANCE_HINTS: dict[str, str] = {
    "engine": "ContinuousEngine",
    "eng": "ContinuousEngine",
    "_book": "LedgerBook",
    "_census": "CensusRing",
    "_journal": "RequestJournal",
    "journal": "RequestJournal",
    "flightrec": "FlightRecorder",
    "_watchdog": "StepWatchdog",
    "health": "HealthMonitor",
    "_page_channel": "PageChannelServer",
    "_obs": "EngineMetrics",
    "server": "InferenceServer",
    "_watch": "Watchtower",
    "watch": "Watchtower",
    "ring": "SignalRing",
    "channel": "PlanChannel",
    "_plan": "PlanLeader",
    "io": "PageIO",
    "_io": "PageIO",
}


def validate() -> list[str]:
    """Registry self-consistency (tests/test_torch_analysis_threadcheck.py
    gates on []: a malformed model must fail loudly, not silently weaken
    the rules). Checks: every domain reference is a declared domain, every
    entrypoint documents a join path, family attrs are unique, and
    every METHOD_DOMAINS class has a declared owner."""
    problems: list[str] = []
    for e in ENTRYPOINTS.values():
        if e.domain not in DOMAINS:
            problems.append(f"entrypoint {e.key}: unknown domain "
                            f"{e.domain!r}")
        if not e.joined_by.strip():
            problems.append(f"entrypoint {e.key}: no join/stop path "
                            f"declared")
    seen_attrs: set[tuple[str, str]] = set()
    for fam in FAMILIES:
        if fam.domain not in DOMAINS:
            problems.append(f"family {fam.owner_class}.{fam.attrs}: "
                            f"unknown domain {fam.domain!r}")
        if fam.owner_class not in CLASS_OWNER:
            problems.append(f"family class {fam.owner_class}: no "
                            f"CLASS_OWNER entry")
        for a in fam.attrs:
            key = (fam.owner_class, a)
            if key in seen_attrs:
                problems.append(f"attr {a!r} declared twice on "
                                f"{fam.owner_class}")
            seen_attrs.add(key)
    for qual, domains in METHOD_DOMAINS.items():
        cls = qual.split(".")[0]
        if cls not in CLASS_OWNER:
            problems.append(f"METHOD_DOMAINS {qual}: class {cls} has no "
                            f"CLASS_OWNER entry")
        for d in domains:
            if d not in DOMAINS:
                problems.append(f"METHOD_DOMAINS {qual}: unknown domain "
                                f"{d!r}")
    for cls, d in CLASS_OWNER.items():
        if d not in DOMAINS:
            problems.append(f"CLASS_OWNER {cls}: unknown domain {d!r}")
    return problems
