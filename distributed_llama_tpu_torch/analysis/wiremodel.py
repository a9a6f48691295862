"""The port's declared wire and persistence schema registry (the JAX
package's analysis/wiremodel.py, with the port's producer and consumer
sites and the port's own formats).

Every hand-rolled cross-process format is declared once here: journal WAL
records, the handoff wire entry, pagewire CRC frames, the page-channel
command protocol, the ``POST /prefill`` RPC, traceparent headers, the
``config_fingerprint`` keys, flight-recorder bundles, the ``/health`` and
``/metrics`` surfaces; and the port's own: ``serve --tp N``'s dispatch
plans (runtime/tp_plan.py), the ``.tkcache`` device-layout sidecar
(io/kernel_cache.py) and weight streaming's ``.slices`` CRC sidecar
(io/stream.py). A pure-data registry: ``analysis/wirecheck.py`` lints
against it without running anything. Per format:

* the **fields**: name, type, required/optional, the default a reader
  substitutes on absence, and the ``since`` schema version it appeared in
  (an optional field with a default is the legacy-read path);
* the **producer and consumer sites**: ``"repo/relative/path.py:
  Qualified.name"`` (qualnames match by suffix);
* **persistent vs ephemeral**: persistent formats outlive the process
  that wrote them, so every field carries a ``since`` and absent-tolerant
  reads (W005);
* the **codec pairs** W003 holds symmetric.

``METRIC_FAMILIES`` registers every ``dllama_*`` Prometheus family the
port may emit or its fleet plane may parse. ``validate()`` is the
registry's self-check (empty when consistent). The golden corpus under
``tests/fixtures/wire/`` is this registry's dynamic twin; the port's
``tools/make_wire_corpus.py`` writes it through the port's producers and
``tools/wirecheck.py`` replays it through the port's readers.

Debug-only surfaces (``/debug/sched``, ``/debug/timeline``) are
deliberately unregistered: they have no machine consumer.
"""

from __future__ import annotations

import dataclasses

#: bump when the /health payload gains or renames a key; the server
#: emits it as the "schema" key and ReplicaSignals carries it so a
#: rollup can see version skew across a fleet (runtime/server.py is the
#: producer — it defines its own HEALTH_SCHEMA constant equal to this;
#: validate() cannot import runtime code, tests pin the two equal).
HEALTH_SCHEMA_VERSION = 3


@dataclasses.dataclass(frozen=True)
class WireField:
    """One field of a wire format. ``required`` means a conforming
    reader may assume presence (branch-guarded unions included — e.g.
    the /prefill reply's ``record`` is required WITHIN its non-final
    branch); optional fields carry the ``default`` a reader must
    substitute on absence. ``since`` is the schema version the field
    first appeared in — mandatory for persistent formats (W005)."""

    name: str
    type: str  # "int" | "float" | "str" | "bool" | "list" | "dict" | ...
    required: bool = True
    default: object = None
    since: int | None = None
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One cross-process format: its schema, sites, and codec pairs."""

    name: str
    version: int
    persistent: bool
    fields: tuple[WireField, ...]
    producers: tuple[str, ...]
    consumers: tuple[str, ...]
    codec_pairs: tuple[tuple[str, str], ...] = ()
    doc: str = ""

    def field(self, name: str) -> WireField | None:
        for f in self.fields:
            if f.name == name:
                return f
        return None


@dataclasses.dataclass(frozen=True)
class MetricFamily:
    """One registered Prometheus family. ``fleet`` marks families the
    fleet plane (obs/fleet.py) parses back out of /metrics — renaming
    one breaks every router reading the rollup."""

    name: str
    labels: tuple[str, ...] = ()
    fleet: bool = False


def _f(name, type="int", required=True, default=None, since=1, doc=""):
    return WireField(name=name, type=type, required=required,
                     default=default, since=since, doc=doc)


_PKG = "distributed_llama_tpu_torch"

# --------------------------------------------------------------- journal

_JOURNAL = (
    WireFormat(
        name="journal.header",
        version=2,
        persistent=True,
        fields=(
            _f("t", "str", doc='always "journal"'),
            _f("v", "int", doc="on-disk format version (1)"),
            _f("config", "dict", required=False, default=None, since=2,
               doc="config_fingerprint of the writing process; absent "
                   "on legacy (pre-fingerprint) journals, which recover "
                   "without the replay-config guard"),
        ),
        producers=(
            f"{_PKG}/runtime/journal.py:RequestJournal._header_record",
            f"{_PKG}/runtime/journal.py:RequestJournal.compact",
        ),
        consumers=(f"{_PKG}/runtime/journal.py:_load_file",),
        doc="line 1 of every WAL file",
    ),
    WireFormat(
        name="journal.admit",
        version=3,
        persistent=True,
        fields=(
            _f("t", "str"),
            _f("id", "int"),
            _f("tokens", "list"),
            _f("steps", "int"),
            _f("temperature", "float"),
            _f("topp", "float"),
            _f("seed", "int", doc="the RESOLVED per-request seed"),
            _f("slo", "str", required=False, default=None),
            _f("cursor", "int", required=False, default=0,
               doc="coin draws already consumed (recovery re-admits)"),
            _f("recovers", "int", required=False, default=None,
               doc="previous life's id — one record opens the new life "
                   "and retires the old atomically"),
            _f("trace", "str", required=False, default=None, since=2,
               doc="traceparent header at admit"),
            _f("ledger", "dict", required=False, default=None, since=3,
               doc="carried cost-ledger snapshot"),
        ),
        producers=(
            f"{_PKG}/runtime/journal.py:RequestJournal.admit",
            f"{_PKG}/runtime/journal.py:RequestJournal.compact",
        ),
        consumers=(f"{_PKG}/runtime/journal.py:_parse_record",),
        doc="write-ahead of the scheduler ever seeing the request",
    ),
    WireFormat(
        name="journal.tok",
        version=1,
        persistent=True,
        fields=(
            _f("t", "str"),
            _f("id", "int"),
            _f("tok", "int"),
            _f("cursor", "int",
               doc="cumulative coin cursor AFTER sampling"),
        ),
        producers=(f"{_PKG}/runtime/journal.py:RequestJournal.token",),
        consumers=(f"{_PKG}/runtime/journal.py:_parse_record",),
        doc="one per SAMPLED token",
    ),
    WireFormat(
        name="journal.retire",
        version=1,
        persistent=True,
        fields=(
            _f("t", "str"),
            _f("id", "int"),
            _f("status", "str",
               doc="done | cancelled | failed | recovered"),
        ),
        producers=(f"{_PKG}/runtime/journal.py:RequestJournal.retire",),
        consumers=(f"{_PKG}/runtime/journal.py:_parse_record",),
    ),
    WireFormat(
        name="journal.handoff",
        version=3,
        persistent=False,
        fields=(
            _f("id", "int"),
            _f("tokens", "list", doc="prompt ids (what was asked)"),
            _f("sampled", "list", required=False, default=(),
               doc="generated so far (what was answered)"),
            _f("cursor", "int", required=False, default=0),
            _f("steps", "int"),
            _f("temperature", "float"),
            _f("topp", "float"),
            _f("seed", "int"),
            _f("slo", "str", required=False, default=None),
            _f("trace", "str", required=False, default=None, since=2),
            _f("ledger", "dict", required=False, default=None, since=3),
        ),
        producers=(f"{_PKG}/runtime/journal.py:entry_to_wire",),
        consumers=(f"{_PKG}/runtime/journal.py:entry_from_wire",),
        codec_pairs=(
            (f"{_PKG}/runtime/journal.py:entry_to_wire",
             f"{_PKG}/runtime/journal.py:entry_from_wire"),
        ),
        doc="the prefill->decode (and any->any migration) wire entry — "
            "exactly the fields ContinuousEngine.recover replays from",
    ),
    WireFormat(
        name="config.fingerprint",
        version=3,
        persistent=True,
        fields=(
            _f("dim", "int"),
            _f("hidden_dim", "int"),
            _f("n_layers", "int"),
            _f("n_heads", "int"),
            _f("n_kv_heads", "int"),
            _f("vocab_size", "int"),
            _f("seq_len", "int"),
            _f("weights_ftype", "int"),
            _f("buffer_ftype", "int"),
            _f("tp_scheme", "str"),
            _f("seed_policy", "str"),
            _f("weights_digest", "str"),
            _f("kv_quant", "str", required=False, default="f32", since=2,
               doc="omitted when f32 so journals from before Q8 pages keep "
                   "recovering under f32 serving"),
            _f("kv_cache_dtype", "str", required=False, default="f32",
               since=2),
            _f("kv_host_pages", "int", required=False, default=0,
               since=3, doc="omitted when tiering is off"),
            _f("kv_disk", "bool", required=False, default=False,
               since=3),
        ),
        producers=(f"{_PKG}/runtime/journal.py:config_fingerprint",),
        consumers=(
            f"{_PKG}/runtime/journal.py:RequestJournal.check_config",),
        doc="rides the journal header; == is the whole comparison, so "
            "new keys MUST be omitted-when-default or every existing "
            "journal mismatches on upgrade",
    ),
)

# -------------------------------------------------------- page transport

_PAGES = (
    WireFormat(
        name="pagewire.frame",
        version=1,
        persistent=True,
        fields=(
            _f("meta_len", "u32-le"),
            _f("meta", "json",
               doc="[[shape, dtype-str], ...] per plane"),
            _f("crc32", "u32-le", doc="zlib.crc32 over the blob"),
            _f("blob_len", "u64-le"),
            _f("blob", "bytes",
               doc="pack_planes output VERBATIM — byte-identical to "
                   "the disk tier's record for the same page"),
        ),
        producers=(f"{_PKG}/runtime/pagewire.py:encode_record",),
        consumers=(f"{_PKG}/runtime/pagewire.py:decode_record",),
        codec_pairs=(
            (f"{_PKG}/runtime/pagewire.py:encode_record",
             f"{_PKG}/runtime/pagewire.py:decode_record"),
            (f"{_PKG}/runtime/pagewire.py:pack_planes",
             f"{_PKG}/runtime/pagewire.py:unpack_planes"),
        ),
        doc="the ONE KV-page byte layout (DCN frames + disk blobs)",
    ),
    WireFormat(
        name="page_channel.protocol",
        version=1,
        persistent=False,
        fields=(
            _f("SPEC", "command", doc="-> DLPCH1 magic + <q version"),
            _f("COUNT", "command", doc="<hid> -> <q page count | -1"),
            _f("PAGE", "command",
               doc="<hid> <idx> -> <q len + pagewire frame | -1"),
            _f("TRACE", "command",
               doc="<hid> -> <q len + traceparent bytes | -1"),
            _f("ACK", "command", doc="<hid> -> <q 0; drops the records"),
            _f("DONE", "command", doc="close"),
        ),
        producers=(
            f"{_PKG}/runtime/page_channel.py:PageChannelClient._connect",
            f"{_PKG}/runtime/page_channel.py:PageChannelClient._req_page",
            f"{_PKG}/runtime/page_channel.py:PageChannelClient.trace",
            f"{_PKG}/runtime/page_channel.py:PageChannelClient.ack",
            f"{_PKG}/runtime/page_channel.py:PageChannelClient.fetch",
        ),
        consumers=(
            f"{_PKG}/runtime/page_channel.py:Handler.handle",),
        doc="line-framed requests, binary responses; bump _MAGIC "
            "(DLPCH1) on any framing change",
    ),
)

# ----------------------------------------------------------- HTTP bodies

_HTTP = (
    WireFormat(
        name="prefill.request",
        version=1,
        persistent=False,
        fields=(
            _f("tokens", "list"),
            _f("steps", "int"),
            _f("temperature", "float", required=False, default=None),
            _f("topp", "float", required=False, default=None),
            _f("seed", "int", required=False, default=None),
            _f("class", "str", required=False, default=None),
            _f("trace", "str", required=False, default=None,
               doc="the decode pool's traceparent — the send half of "
                   "the clock-skew anchor pair"),
        ),
        producers=(
            f"{_PKG}/runtime/server.py:InferenceServer.remote_prefill",),
        consumers=(
            f"{_PKG}/runtime/server.py:Handler._prefill_handoff",),
        doc="POST /prefill body (decode -> prefill pool)",
    ),
    WireFormat(
        name="prefill.response",
        version=1,
        persistent=False,
        fields=(
            _f("final", "bool", required=False, default=None,
               doc="truthy: the stream ended inside the prefill cut"),
            _f("out", "list",
               doc="required within the final branch"),
            _f("record", "dict",
               doc="journal.handoff entry (non-final branch)"),
            _f("hid", "str"),
            _f("n_pages", "int"),
            _f("channel_port", "int"),
            _f("error", "str", required=False, default=None),
        ),
        producers=(
            f"{_PKG}/runtime/server.py:Handler._prefill_handoff",),
        consumers=(
            f"{_PKG}/runtime/server.py:InferenceServer.remote_prefill",),
        doc="POST /prefill reply: {final, out} | {record, hid, n_pages, "
            "channel_port} | {error}",
    ),
    WireFormat(
        name="generate.request",
        version=1,
        persistent=False,
        fields=(
            _f("prompt", "str", required=False, default=""),
            _f("steps", "int", required=False, default=None,
               doc="server default when absent"),
            _f("temperature", "float", required=False, default=None),
            _f("topp", "float", required=False, default=None),
            _f("seed", "int", required=False, default=None),
            _f("class", "str", required=False, default=None),
            _f("stream", "bool", required=False, default=False),
        ),
        producers=(),  # external clients + tools/loadgen drive this
        consumers=(
            f"{_PKG}/runtime/server.py:InferenceServer.make_request",
            f"{_PKG}/runtime/server.py:Handler.do_POST",
        ),
        doc="POST /generate body",
    ),
    WireFormat(
        name="generate.response",
        version=1,
        persistent=False,
        fields=(
            _f("text", "str"),
            _f("tokens", "list"),
            _f("steps", "int"),
            _f("token", "int", required=False, default=None,
               doc="streaming line form (one JSON object per token)"),
            _f("piece", "str", required=False, default=None,
               doc="decoded text of the streamed token"),
            _f("done", "bool", required=False, default=False),
            _f("error", "str", required=False, default=None),
        ),
        producers=(
            f"{_PKG}/runtime/server.py:Handler.do_POST",
            f"{_PKG}/runtime/server.py:Handler._stream",
        ),
        consumers=(),  # external clients + tools/loadgen
        doc="POST /generate reply (one-shot and streaming line forms)",
    ),
    WireFormat(
        name="traceparent",
        version=1,
        persistent=False,
        fields=(
            _f("version", "hex-str", doc='"00"'),
            _f("trace_id", "hex-str", doc="32 hex chars, never all-0"),
            _f("span_id", "hex-str", doc="16 hex chars, never all-0"),
            _f("flags", "hex-str", doc='"01" — everything is sampled'),
        ),
        producers=(
            f"{_PKG}/obs/tracectx.py:TraceContext.to_header",),
        consumers=(f"{_PKG}/obs/tracectx.py:parse_header",),
        codec_pairs=(
            (f"{_PKG}/obs/tracectx.py:TraceContext.to_header",
             f"{_PKG}/obs/tracectx.py:parse_header"),
        ),
        doc="00-<trace_id>-<span_id>-01; rides /prefill bodies, journal "
            "admits, and the page channel's TRACE command",
    ),
    WireFormat(
        name="http.headers",
        version=1,
        persistent=False,
        fields=(
            _f("Content-Type", "str", required=False, default=None),
            _f("Content-Length", "str", required=False, default="0"),
        ),
        producers=(
            f"{_PKG}/runtime/server.py:InferenceServer.remote_prefill",),
        consumers=(
            f"{_PKG}/runtime/server.py:Handler.do_POST",
            f"{_PKG}/runtime/server.py:Handler._prefill_handoff",
            f"{_PKG}/runtime/server.py:Handler._profile",
        ),
        doc="the HTTP headers this repo's handlers actually read",
    ),
    WireFormat(
        name="profile.request",
        version=1,
        persistent=False,
        fields=(
            _f("seconds", "float", required=False, default=5.0),
            _f("dir", "str", required=False, default=None),
        ),
        producers=(),  # operator tooling
        consumers=(f"{_PKG}/runtime/server.py:Handler._profile",),
        doc="POST /profile body",
    ),
)

# --------------------------------------------------------- observability

_OBS = (
    WireFormat(
        name="health",
        version=HEALTH_SCHEMA_VERSION,
        persistent=False,
        fields=(
            # always-written top level
            _f("schema", "int", required=False, default=0, since=2,
               doc="THIS registry's health version; 0 = pre-schema "
                   "replica (ReplicaSignals carries it for skew "
                   "visibility across a fleet)"),
            _f("state", "str"),
            _f("active", "int"),
            _f("queued", "int"),
            _f("queue_depth", "int"),
            _f("slots", "int"),
            _f("steps", "int"),
            _f("generated_tokens", "int"),
            _f("uptime_s", "float"),
            _f("occupancy", "float"),
            _f("pauses", "int"),
            _f("requeues", "int"),
            # conditional blocks (feature-gated; absence != zero — the
            # fleet plane records per-block presence)
            _f("sched", "dict", required=False, default=None),
            _f("paged_kv", "dict", required=False, default=None),
            _f("kv_tiers", "dict", required=False, default=None),
            _f("disagg", "dict", required=False, default=None),
            _f("journal", "dict", required=False, default=None),
            _f("watchdog", "dict", required=False, default=None),
            _f("slo", "dict", required=False, default=None),
            _f("admission_rejected", "int", required=False, default=0),
            _f("speculative", "dict", required=False, default=None),
            _f("watch", "dict", required=False, default=None, since=3,
               doc="incident-detection heartbeat: watch-"
                   "plane tick count, per-kind incident totals and "
                   "hysteresis states, last incident identity"),
            _f("ttft_s", "dict", required=False, default=None),
            _f("token_latency_s", "dict", required=False, default=None),
            _f("queue_wait_s", "dict", required=False, default=None),
            _f("error", "str", required=False, default=None,
               doc="404/metrics-disabled envelope"),
            # paged_kv block
            _f("page_size", "int"), _f("pages", "int"),
            _f("pages_free", "int"), _f("kv_quant", "str"),
            _f("pool_bytes", "int"), _f("prefix_hit_rate", "float"),
            _f("prefix_hits", "int"), _f("prefix_misses", "int"),
            _f("prefill_tokens_saved", "int"), _f("evictions", "int"),
            # kv_tiers block
            _f("host_capacity", "int"), _f("disk_live_bytes", "int"),
            _f("disk_budget_bytes", "int"), _f("demotions", "dict"),
            _f("promotions", "dict"),
            _f("prefill_tokens_saved_by_tier", "dict"),
            _f("crc_drops", "int"),
            # disagg block
            _f("role", "str"), _f("peer", "str"),
            _f("page_channel_port", "int"),
            _f("handoff_queue_depth", "int"),
            _f("pages_adopted", "int", required=False, default=0),
            # journal block
            _f("path", "str"), _f("fsync", "str"),
            _f("recovered", "int"), _f("records", "int"),
            # watchdog block
            _f("timeout_s", "float"), _f("trips", "int"),
            # slo block (obs/slo.SLOTracker.snapshot)
            _f("classes", "dict", required=False, default=None),
            _f("attempted", "int"), _f("met", "int"),
            _f("violated", "int"), _f("failed", "int"),
            _f("goodput_tokens", "int"),
            # sched block (census/ledger accounting)
            _f("census", "dict"), _f("ledgers", "dict"),
            _f("cost_totals", "dict"), _f("cost_by_class", "dict"),
            _f("opened", "int"), _f("closed", "int"), _f("open", "int"),
            _f("page_s", "float", required=False, default=0.0),
            _f("stall_s", "dict", required=False, default=None),
            _f("tokens", "int"), _f("requests", "int"),
            _f("compute_s", "float"), _f("stall_s_total", "float"),
            _f("page_steps", "int"),
            # speculative block
            _f("k", "int"), _f("proposed", "int"), _f("accepted", "int"),
            _f("accept_rate", "float"),
            # tp block (serve --tp N: rank 0's plan channel and books)
            _f("tp", "dict", required=False, default=None,
               doc="serve --tp N only: ranks, scheme, backend, plans "
                   "sent, the last digest, the plan point's ms, rank 0's "
                   "forwards, collectives and kernel launches"),
            _f("ranks", "int"), _f("scheme", "str"), _f("backend", "str"),
            _f("plans_sent", "int"), _f("last_digest", "str"),
            _f("plan_ms", "dict"), _f("forwards", "int"),
            _f("logit_forwards", "int"), _f("collectives", "dict"),
            _f("launches", "dict"),
        ),
        producers=(
            f"{_PKG}/runtime/server.py:InferenceServer._health_payload",),
        consumers=(f"{_PKG}/obs/fleet.py:signals_from_health",),
        doc="GET /health — the fleet plane's primary scrape surface "
            "(block subkeys are registered flat; 'pages' and 'records' "
            "etc. are scoped by their parent block)",
    ),
    WireFormat(
        name="flightrec.bundle",
        version=3,
        persistent=True,
        fields=(
            _f("kind", "str", doc='"dllama-flightrec"'),
            _f("version", "int"),
            _f("reason", "str"),
            _f("ts", "float"),
            _f("pid", "int"),
            _f("incident_kind", "str", required=False, default=None,
               since=3,
               doc="watchtower detector kind on reason=incident dumps; "
                   "validate-if-present: pre-watchtower bundles stay "
                   "loadable"),
            _f("config", "dict"),
            _f("stamp", "dict"),
            _f("events", "list"),
            _f("spans", "list"),
            _f("spans_dropped", "int"),
            _f("metrics", "str", doc="the exposition text, verbatim"),
            _f("journal_tail", "list"),
            _f("census_tail", "list", required=False, default=None,
               since=2, doc="validate-if-present"),
            _f("open_ledgers", "list", required=False, default=None,
               since=2),
        ),
        producers=(
            f"{_PKG}/obs/flightrec.py:FlightRecorder.snapshot_bundle",),
        consumers=(f"{_PKG}/obs/flightrec.py:validate_bundle",),
        doc="the crash-forensics artifact (watchdog trips, drains, "
            "crash loops); same BUNDLE_VERSION, new sections are "
            "validate-if-present",
    ),
    WireFormat(
        name="flightrec.span",
        version=1,
        persistent=True,
        fields=(
            _f("span", "str"), _f("cat", "str"),
            _f("t_start_s", "float"), _f("dur_ms", "float"),
            _f("tid", "int"), _f("depth", "int"),
        ),
        producers=(
            f"{_PKG}/obs/flightrec.py:FlightRecorder.snapshot_bundle",),
        consumers=(f"{_PKG}/obs/flightrec.py:validate_bundle",),
        doc="one element of bundle['spans'] (span meta rides beside)",
    ),
    WireFormat(
        name="flightrec.event",
        version=1,
        persistent=True,
        fields=(
            _f("ts", "float"), _f("event", "str"),
        ),
        producers=(f"{_PKG}/obs/flightrec.py:FlightRecorder.note",),
        consumers=(f"{_PKG}/obs/flightrec.py:validate_bundle",),
        doc="one element of bundle['events'] (free-form fields ride "
            "beside the required pair)",
    ),
)

# ------------------------------------------------------- the port's own

_PORT = (
    WireFormat(
        name="tp_plan.admission",
        version=1,
        persistent=False,
        fields=(
            _f("index", "int", doc="rank 0's request id (its seed offset)"),
            _f("tokens", "list"),
            _f("steps", "int"),
            _f("temperature", "float"),
            _f("topp", "float"),
            _f("seed", "int"),
            _f("slo_class", "str"),
            _f("coin_cursor", "int"),
        ),
        producers=(f"{_PKG}/runtime/tp_plan.py:admission",),
        consumers=(f"{_PKG}/runtime/tp_plan.py:mirror_request",),
        doc="one admission of a dispatch plan (tp_plan.ADMISSION_FIELDS), "
            "pickled inside DispatchPlan between the ranks of one build",
    ),
    WireFormat(
        name="tp_plan.plan",
        version=1,
        persistent=False,
        fields=(
            _f("seq", "int"),
            _f("op", "str", doc='"step" | "shutdown"'),
            _f("steps", "int"),
            _f("admissions", "list"),
            _f("cancels", "list"),
            _f("remote", "list"),
            _f("exports", "list"),
            _f("digest", "str", doc="rank 0's books before the plan"),
        ),
        producers=(f"{_PKG}/runtime/tp_plan.py:PlanLeader.dispatch_point",),
        consumers=(f"{_PKG}/runtime/tp_plan.py:follow_loop",
                   f"{_PKG}/runtime/tp_plan.py:PlanChannel.recv"),
        doc="DispatchPlan, pickled (protocol 5) and broadcast on the gloo "
            "side group as a length then the bytes",
    ),
    WireFormat(
        name="kernel_cache.header",
        version=1,
        persistent=True,
        fields=(
            _f("key", "str", doc="layout_key: format, float types, the "
                                 "model file's size and mtime"),
            _f("entries", "list"),
            _f("name", "str"),
            _f("kind", "str", doc='"dense" | "q40w"'),
            _f("arrays", "list"),
            _f("shape", "list"),
            _f("dtype", "str"),
            _f("offset", "int"),
            _f("nbytes", "int"),
        ),
        producers=(f"{_PKG}/io/kernel_cache.py:save_packed",
                   f"{_PKG}/io/kernel_cache.py:_meta"),
        consumers=(f"{_PKG}/io/kernel_cache.py:load_packed",),
        doc="the .tkcache sidecar's JSON header (MAGIC DLTK0001); a key "
            "mismatch rebuilds the file, so a new field bumps MAGIC",
    ),
    WireFormat(
        name="stream.slices",
        version=1,
        persistent=True,
        fields=(
            _f("size", "int", doc="the model file's size"),
            _f("ranges", "list", doc="[offset, length, crc32] records"),
        ),
        producers=(f"{_PKG}/io/stream.py:_write_sidecar",
                   f"{_PKG}/io/stream.py:write_record_sidecar",
                   f"{_PKG}/io/stream.py:append_record_verified"),
        consumers=(f"{_PKG}/io/stream.py:_read_sidecar",
                   f"{_PKG}/io/stream.py:verified_ranges"),
        doc="the weight cache's CRC sidecar (<cache>.slices), byte for "
            "byte the JAX twin's",
    ),
)

FORMATS: tuple[WireFormat, ...] = _JOURNAL + _PAGES + _HTTP + _OBS + _PORT

FORMATS_BY_NAME: dict[str, WireFormat] = {f.name: f for f in FORMATS}


# ------------------------------------------------------------ /metrics

def _m(name, labels=(), fleet=False):
    return MetricFamily(name=name, labels=tuple(labels), fleet=fleet)


#: every Prometheus family this process may emit (obs/metrics Registry
#: names) or the fleet plane may parse. W004 fires on any dllama_*
#: family literal in runtime/, obs/, or tools/ that is absent here.
METRIC_FAMILIES: dict[str, MetricFamily] = {m.name: m for m in (
    # engine core
    _m("dllama_engine_steps_total"),
    _m("dllama_engine_step_duration_seconds"),
    _m("dllama_engine_queued_requests"),
    _m("dllama_engine_active_slots"),
    _m("dllama_engine_batch_occupancy"),
    _m("dllama_engine_compile_events_total"),
    _m("dllama_dispatch_tokens_total", labels=("kind",)),
    _m("dllama_generated_tokens_total"),
    _m("dllama_requests_total"),
    _m("dllama_requests_failed_total"),
    _m("dllama_requests_cancelled_total"),
    _m("dllama_slot_pauses_total"),
    _m("dllama_queue_depth", fleet=True),
    _m("dllama_queue_depth_by_class", labels=("class",)),
    _m("dllama_admission_rejected_total", labels=("reason",)),
    _m("dllama_matmul_mode"),
    # request latency
    _m("dllama_request_ttft_seconds"),
    _m("dllama_request_decode_token_seconds"),
    _m("dllama_request_queue_wait_seconds"),
    _m("dllama_request_queue_wait_by_class_seconds", labels=("class",)),
    _m("dllama_request_prefill_seconds"),
    _m("dllama_request_tokens_per_second"),
    # cost accounting
    _m("dllama_request_cost_dispatch_seconds", labels=("class",)),
    _m("dllama_request_cost_page_seconds", labels=("class",)),
    _m("dllama_request_cost_stall_seconds", labels=("class", "cause")),
    _m("dllama_page_seconds_total", labels=("class",), fleet=True),
    _m("dllama_stall_seconds_total", labels=("cause",), fleet=True),
    # paged KV + tiers
    _m("dllama_kv_pages_free", fleet=True),
    _m("dllama_kv_page_bytes"),
    _m("dllama_kv_page_pool_bytes"),
    _m("dllama_kv_quant_info", labels=("kv_quant", "kv_cache_dtype")),
    _m("dllama_kv_tier_pages", labels=("tier",)),
    _m("dllama_tier_promotions_total", labels=("tier",)),
    _m("dllama_tier_demotions_total", labels=("tier",)),
    _m("dllama_prefix_hits_total", fleet=True),
    _m("dllama_prefill_tokens_saved_total"),
    _m("dllama_prefill_tokens_saved_by_tier_total", labels=("tier",)),
    # SLO + goodput
    _m("dllama_slo_requests_total", labels=("class", "outcome")),
    _m("dllama_goodput_tokens_total", labels=("class",), fleet=True),
    # speculation
    _m("dllama_spec_proposed_total"),
    _m("dllama_spec_accepted_total"),
    # journal / recovery / lifecycle
    _m("dllama_journal_records_total"),
    _m("dllama_recoveries_total"),
    _m("dllama_health_state"),
    _m("dllama_drain_seconds"),
    # disaggregation + DCN
    _m("dllama_handoff_requests_total", labels=("verdict",)),
    _m("dllama_handoff_seconds"),
    _m("dllama_handoff_queue_depth"),
    _m("dllama_dcn_pages_shipped_total"),
    _m("dllama_dcn_bytes_total"),
    # collectives
    _m("dllama_ici_collectives_total", labels=("kind",)),
    _m("dllama_ici_bytes_total", labels=("kind",)),
    # tracing
    _m("dllama_spans_dropped_total", fleet=True),
    # incident detection
    _m("dllama_incidents_total", labels=("kind",)),
    _m("dllama_detector_state", labels=("kind",)),
)}


# ------------------------------------------------------------- validate

def validate(formats: tuple[WireFormat, ...] = FORMATS,
             families: dict[str, MetricFamily] = METRIC_FAMILIES,
             ) -> list[str]:
    """The registry's self-check: a list of problem strings, empty when
    consistent. Pure data validation — no file IO, no runtime imports
    (wirecheck resolves the SITES against real source separately and
    reports unresolvable ones as W000)."""
    problems: list[str] = []
    seen: set[str] = set()
    for fmt in formats:
        if fmt.name in seen:
            problems.append(f"duplicate format name {fmt.name!r}")
        seen.add(fmt.name)
        if fmt.version < 1:
            problems.append(f"{fmt.name}: version must be >= 1")
        if not fmt.fields:
            problems.append(f"{fmt.name}: no fields declared")
        if not fmt.producers and not fmt.consumers:
            problems.append(f"{fmt.name}: neither producer nor consumer "
                            f"sites declared")
        fseen: set[str] = set()
        for fld in fmt.fields:
            if fld.name in fseen:
                problems.append(f"{fmt.name}.{fld.name}: duplicate field")
            fseen.add(fld.name)
            if fld.required and fld.default is not None:
                problems.append(f"{fmt.name}.{fld.name}: required "
                                f"fields cannot carry a default")
            if fld.since is not None and not (1 <= fld.since
                                              <= fmt.version):
                problems.append(f"{fmt.name}.{fld.name}: since="
                                f"{fld.since} outside 1..{fmt.version}")
            if fmt.persistent and fld.since is None:
                problems.append(f"{fmt.name}.{fld.name}: persistent "
                                f"format field without a since version")
        sites = fmt.producers + fmt.consumers + tuple(
            s for pair in fmt.codec_pairs for s in pair)
        for site in sites:
            path, sep, qual = site.partition(":")
            if not sep or not path.endswith(".py") or not qual:
                problems.append(f"{fmt.name}: malformed site {site!r} "
                                f"(want 'path.py:Qual.name')")
        for pack, unpack in fmt.codec_pairs:
            if pack == unpack:
                problems.append(f"{fmt.name}: codec pair maps a "
                                f"function to itself ({pack})")
    if FORMATS_BY_NAME.get("health") is not None and \
            formats is FORMATS and \
            FORMATS_BY_NAME["health"].version != HEALTH_SCHEMA_VERSION:
        problems.append("health format version drifted from "
                        "HEALTH_SCHEMA_VERSION")
    for name, fam in families.items():
        if name != fam.name:
            problems.append(f"metric family keyed {name!r} but named "
                            f"{fam.name!r}")
        if not name.startswith("dllama_"):
            problems.append(f"metric family {name!r} outside the "
                            f"dllama_ namespace")
        for lab in fam.labels:
            if not lab.replace("_", "a").isalnum() or lab != lab.lower():
                problems.append(f"metric family {name}: label {lab!r} "
                                f"is not a lowercase identifier")
    return problems
