"""Write-ahead request journal: crash-safe serving state.

The reference is a single-shot process — a crash loses everything. The
continuous engine already has the two properties that make real
crash-safety CHEAP here: seeded coin-replay determinism (a request's
token stream is a pure function of its prompt, sampler config, and coin
cursor — rejected speculative positions and forced steps consume no
coins), and radix prefix sharing (re-prefilling a recovered request
mostly hits the tree once its siblings re-admit). This module adds the
missing piece: a durable, append-only record of every request's inputs
and progress, from which ``ContinuousEngine.recover`` re-derives the
exact in-flight state.

Format: NDJSON, one record per line, four record types —

* ``{"t": "journal", "v": 1[, "config": {...}]}`` — the header, always
  line 1. ``config`` is the model-config FINGERPRINT of the
  process that created the journal (``config_fingerprint``: model dims,
  quant types, tp scheme, the sampler seed policy, a weight-file digest
  prefix). Replay determinism is only as good as the config it replays
  under — the same coin cursor against different weights, a different
  buffer float type, or a different pinned seed produces confidently
  WRONG bytes — so ``ContinuousEngine.recover`` refuses (raising
  ``JournalConfigMismatch``) when the serving config's fingerprint
  differs from the journaled one AND the journal holds live work; with
  nothing incomplete the journal adopts the new config instead
  (``adopt_config`` — a config upgrade over a fully-retired journal has
  nothing to corrupt). Legacy headers (pre-fingerprint journals) carry
  no config and recover without the check — the operator kept them on
  purpose;
* ``{"t": "admit", "id", "tokens", "steps", "temperature", "topp",
  "seed", "slo", "cursor"[, "recovers"]}`` — written at ``submit()``
  time (write-AHEAD of the scheduler ever seeing the request). ``seed``
  is the RESOLVED per-request seed (the engine's ``seed + index``
  default is process-local and would not survive a restart) and
  ``cursor`` the coin draws already consumed (non-zero only for
  re-journaled recovered requests). ``recovers`` names the previous
  life's id on a recovery re-admission: the ONE record opens the new
  life and retires the old atomically;
* ``{"t": "tok", "id", "tok", "cursor"}`` — one per SAMPLED token, with
  the cumulative coin cursor AFTER sampling it (forced prompt echoes are
  derivable from the admit record and are not journaled);
* ``{"t": "retire", "id", "status"}`` — ``done`` / ``cancelled`` /
  ``failed`` / ``recovered``; a request with a retire record (or whose
  id a later admit ``recovers``) needs no recovery.

Durability policy (``fsync=``): ``always`` fsyncs every record (survives
power loss, slowest), ``batch`` fsyncs once per scheduler step — the
engine calls ``sync()`` at each step boundary, so at most one dispatch's
tokens are at risk (the default), ``off`` leaves flushing to the OS
(process-crash-safe only). Every append is a single ``write()`` of one
complete line either way, so a torn record can only be the file's tail.

Corruption contract: a torn TAIL record (a crash mid-append) is expected
damage — loading truncates the file at the last valid line and reports
it. Anything else — garbage mid-file, an unknown record type, a record
referencing an unadmitted id, a missing header — raises
``JournalCorruption``: silently "recovering" from a journal whose
history cannot be trusted would serve wrong bytes with a straight face.

Compaction: retired requests' records are dead weight. ``compact()``
atomically rewrites the journal as one MERGED admit record per live
request (prompt + sampled-so-far as the token list, cursor carried
forward — exactly the reconstruction ``recover`` performs), dropping
everything retired. ``maybe_compact()`` applies the rotation policy
(``compact_every`` retirements); the engine calls it at step boundaries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

_HEADER = {"t": "journal", "v": 1}
FSYNC_POLICIES = ("always", "batch", "off")


class JournalCorruption(RuntimeError):
    """The journal's history cannot be trusted (non-tail damage) — fail
    loudly instead of recovering wrong state."""


class JournalConfigMismatch(RuntimeError):
    """The journal was written under a different serving config (model
    dims / quant types / tp scheme / seed policy / weight file) — a
    bitwise replay against it would be silently wrong, so recovery
    refuses. Move the journal aside to drop the in-flight work, or
    restart with the original config to recover it."""


def config_fingerprint(spec, scheme: str, seed_policy: str,
                       weights_digest: str | None = None,
                       kv_quant: str = "f32",
                       kv_cache_dtype: str = "f32",
                       kv_host_pages: int = 0,
                       kv_disk: bool = False) -> dict:
    """The serving-config fingerprint the WAL header records: everything a
    bitwise replay depends on — model dims, weight/buffer quant types,
    the tp collective scheme (schemes are bitwise-distinct only across
    the ref boundary, but the scheme also gates which program replays),
    the sampler SEED POLICY, and a weight-file digest prefix
    (``weight_file_digest``). Plain JSON-able dict so == is the whole
    comparison.

    ``seed_policy`` is ``"explicit:<seed>"`` when the operator pinned
    --seed (a restart under a different pinned seed changes every NEW
    request's stream — refuse) or ``"time"`` for the time-derived
    default (restarts under the default always pass: REPLAY never reads
    the base seed — admit records carry each request's RESOLVED seed —
    and new-request streams were already restart-variant by
    construction).

    ``kv_quant`` / ``kv_cache_dtype``: Q8 KV pages — and a
    bf16 cache dtype — change every logit past the first position
    (quantized/narrowed K/V feed attention), so a replay across either
    KV-dtype change would be deterministic-but-wrong — the fingerprint
    refuses it. Both keys are recorded only when != 'f32' so older
    journals (no key) keep recovering under f32 serving, while any
    f32↔q8 or f32↔bf16 flip mismatches in BOTH directions."""
    fp = {
        "dim": spec.dim, "hidden_dim": spec.hidden_dim,
        "n_layers": spec.n_layers, "n_heads": spec.n_heads,
        "n_kv_heads": spec.n_kv_heads, "vocab_size": spec.vocab_size,
        "seq_len": spec.seq_len,
        "weights_ftype": int(spec.weights_float_type),
        "buffer_ftype": int(spec.buffer_float_type),
        "tp_scheme": scheme, "seed_policy": str(seed_policy),
        "weights_digest": weights_digest,
    }
    if kv_quant != "f32":
        fp["kv_quant"] = kv_quant
    if kv_cache_dtype != "f32":
        fp["kv_cache_dtype"] = kv_cache_dtype
    # KV tiering: tiering never changes a stream (demote→
    # promote round-trips are byte-exact), but the spill budgets shape
    # which pauses/requeues a replayed schedule hits, and a restart that
    # silently drops the disk tier orphans its segments — record the
    # knobs so drift is explicit. Omitted when OFF, so every pre-tiering
    # journal keeps recovering under untiered serving.
    if kv_host_pages:
        fp["kv_host_pages"] = int(kv_host_pages)
    if kv_disk:
        fp["kv_disk"] = True
    return fp


def weight_file_digest(path: str, head_bytes: int = 1 << 20) -> str:
    """A cheap weight-file identity: sha256 over (file size || first MiB),
    16 hex chars. Full-file hashing of a multi-GB model would stall every
    serve start; the header + first tensors + the size catch every
    practical swap (different model, different quantization, truncation).
    """
    import hashlib

    h = hashlib.sha256()
    size = os.path.getsize(path)
    h.update(str(size).encode())
    with open(path, "rb") as fh:
        h.update(fh.read(head_bytes))
    return h.hexdigest()[:16]


@dataclasses.dataclass
class JournalEntry:
    """One request's journaled state: the admit record plus every sampled
    token appended since. ``replay_tokens`` is what recovery re-admits:
    the prompt with the already-sampled suffix riding the forced-token
    window, and ``cursor`` the coin draws the recovered sampler must
    fast-forward past."""

    rid: int
    tokens: list
    steps: int
    temperature: float
    topp: float
    seed: int
    slo: str | None = None
    cursor: int = 0
    sampled: list = dataclasses.field(default_factory=list)
    status: str | None = None  # None = incomplete (needs recovery)
    # distributed-trace identity: the request's traceparent
    # header (obs/tracectx) at admit time. Recovery and the disagg
    # handoff continue the SAME trace from it — the continuation opens a
    # new span parented on this one with a recovers/handoff link, so a
    # request's whole multi-process life joins on one trace_id. None on
    # legacy records (pre-trace journals recover fine, just unjoined).
    trace: str | None = None
    # carried cost-ledger snapshot: the resource bill this
    # request accumulated in a PREVIOUS life (prefill pool / pre-crash
    # process), attached at admit so a migrated request's ledger is
    # whole. None on legacy records and on first lives.
    ledger: dict | None = None

    @property
    def replay_tokens(self) -> list:
        return list(self.tokens) + list(self.sampled)


class RequestJournal:
    """Append-side handle over one journal file (engine-owned).

    Opening an existing journal loads its state (so compaction knows the
    live set), REPAIRS a torn tail by physically truncating it, and
    raises ``JournalCorruption`` on any deeper damage. Appends are
    thread-safe (submit runs on handler threads, tokens on the
    scheduler thread).
    """

    def __init__(self, path: str, fsync: str = "batch",
                 compact_every: int = 256, config: dict | None = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy {fsync!r} not in "
                             f"{FSYNC_POLICIES}")
        self.path = path
        self.fsync = fsync
        self.compact_every = compact_every
        # the SERVING config's fingerprint (config_fingerprint); written
        # into fresh headers and compared against header_config (the
        # journaled one) by check_config / ContinuousEngine.recover
        self.config = config
        self.header_config: dict | None = None
        # RLock: admit/token/retire mutate ``_entries`` AND append under
        # one critical section (submit runs on handler threads while
        # compact() rebuilds the dict on the scheduler thread — an
        # unlocked dict-set could vanish into the pre-compaction dict and
        # leave a journaled request the in-memory state no longer knows)
        self._lock = threading.RLock()
        self._metric = None  # obs counter (.inc) — bind_metrics
        self.records_total = 0  # appended by THIS handle
        self._dirty = False     # unsynced appends (batch policy)
        self._entries: dict[int, JournalEntry] = {}
        self._n_retired = 0
        existing = os.path.exists(path) and os.path.getsize(path) > 0
        self._fresh = not existing
        if existing:
            state, valid_bytes, header_cfg = _load_file(path)
            if valid_bytes < os.path.getsize(path):
                # torn tail: a crash mid-append left a partial last line —
                # truncate to the last valid record before appending, or
                # the next load would see garbage MID-file and refuse
                with open(path, "r+b") as fh:
                    fh.truncate(valid_bytes)
            existing = valid_bytes > 0  # fully-torn file: start fresh
            self._fresh = not existing
            self._entries = state
            self.header_config = header_cfg
            self._n_retired = sum(1 for e in state.values()
                                  if e.status is not None)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "ab")
        if not existing:
            self._append(self._header_record())
            self.header_config = config
            self.sync(force=True)

    def _header_record(self) -> dict:
        rec = dict(_HEADER)
        if self.config is not None:
            rec["config"] = self.config
        return rec

    def set_config(self, config: dict) -> None:
        """Attach the serving-config fingerprint AFTER construction — the
        CLI opens the journal before the model load (corruption must
        fail fast, in milliseconds, not after minutes of weight
        streaming) and only then knows the spec the fingerprint needs. A
        freshly created journal rewrites its header to carry the config
        (the header was written config-less at open); existing journals
        keep their recorded header for check_config to compare."""
        with self._lock:
            self.config = config
            if self._fresh and self.header_config is None:
                # the just-written header lacks the config: rewrite in
                # place (compact() emits self.config into the header and
                # preserves any entries admitted in between)
                self.compact()
                self.header_config = config

    def adopt_config(self) -> None:
        """Re-stamp the journal with the CURRENT serving config — only
        legal when nothing is live (ContinuousEngine.recover calls this
        when ``incomplete()`` is empty): with no in-flight work there is
        nothing a config change could replay wrongly, and refusing would
        strand every journaling deployment on a scheme/config upgrade.
        The compaction rewrite drops retired records and writes the new
        fingerprint, so the NEXT crash compares against the config its
        requests actually ran under."""
        with self._lock:
            if self.config is None or self.header_config == self.config:
                return
            assert not any(e.status is None for e in
                           self._entries.values()), \
                "adopt_config with live entries — recover() gates this"
            self.compact()
            self.header_config = self.config

    def check_config(self) -> None:
        """Refuse a journal whose recorded config fingerprint differs from
        the serving one (JournalConfigMismatch, listing the drifted keys).
        Legacy journals (no recorded config) and config-less handles pass
        — there is nothing trustworthy to compare."""
        old, new = self.header_config, self.config
        if old is None or new is None or old == new:
            return
        drifted = sorted(k for k in set(old) | set(new)
                         if old.get(k) != new.get(k))
        detail = ", ".join(
            f"{k}: journaled {old.get(k)!r} != serving {new.get(k)!r}"
            for k in drifted)
        raise JournalConfigMismatch(
            f"journal {self.path} was written under a different serving "
            f"config ({detail}) — a bitwise replay against it would be "
            f"silently wrong. Move the journal aside to drop its "
            f"in-flight work, or restart with the original config.")

    # ------------------------------------------------------------ state

    def bind_metrics(self, counter) -> None:
        """Attach an obs counter (``dllama_journal_records_total``)."""
        self._metric = counter

    def incomplete(self) -> list[JournalEntry]:
        """Entries with no retire record, in admission (rid) order — the
        recovery set."""
        with self._lock:
            return sorted((e for e in self._entries.values()
                           if e.status is None), key=lambda e: e.rid)

    def entry(self, rid: int) -> JournalEntry | None:
        """One request's journaled state by id, retired or live — the
        DCN handoff reads the retired prefill stub's entry here (prompt
        ids, sampled tokens, coin cursor: the exact resumable state the
        decode pool re-admits; runtime/disagg.py). A deep copy, so the
        caller can rewrite ``steps`` for the handoff without touching
        the journal's in-memory state."""
        with self._lock:
            e = self._entries.get(rid)
            if e is None:
                return None
            return JournalEntry(rid=e.rid, tokens=list(e.tokens),
                                steps=e.steps, temperature=e.temperature,
                                topp=e.topp, seed=e.seed, slo=e.slo,
                                cursor=e.cursor, sampled=list(e.sampled),
                                status=e.status, trace=e.trace,
                                ledger=dict(e.ledger)
                                if e.ledger is not None else None)

    @property
    def next_id(self) -> int:
        """One past the highest journaled request id — a fresh engine
        appending to this journal must start numbering here, or new
        records would alias old requests."""
        with self._lock:
            return max(self._entries, default=-1) + 1

    # ----------------------------------------------------------- append

    def _append(self, obj: dict) -> None:
        line = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
        with self._lock:
            self._fh.write(line)
            self.records_total += 1
            if self.fsync == "always":
                self._fh.flush()
                # WAL durability point: the fsync must serialize with
                # appends or a concurrent write could land after the
                # sync yet claim its durability
                os.fsync(self._fh.fileno())  # threadcheck: allow[T003]
            else:
                self._dirty = True
        if self._metric is not None:
            self._metric.inc()

    def admit(self, rid: int, tokens, steps: int, temperature: float,
              topp: float, seed: int, slo: str | None = None,
              cursor: int = 0, recovers: int | None = None,
              trace: str | None = None,
              ledger: dict | None = None) -> None:
        """Journal a request's admission. ``recovers`` names the PREVIOUS
        life's rid when this admit is a recovery re-admission: the one
        appended record atomically opens the new life AND retires the old
        (status ``recovered``) — a crash on either side of a two-record
        handoff would otherwise leave zero or two live entries for the
        same request. ``trace`` is the request's traceparent header —
        the id a later life continues the trace from.
        ``ledger`` is the carried cost-ledger snapshot: the
        bill a handed-off/recovered request brought from its previous
        life."""
        entry = JournalEntry(rid=rid, tokens=list(tokens), steps=steps,
                             temperature=temperature, topp=topp, seed=seed,
                             slo=slo, cursor=cursor, trace=trace,
                             ledger=dict(ledger)
                             if ledger is not None else None)
        rec = {"t": "admit", "id": rid, "tokens": entry.tokens,
               "steps": steps, "temperature": temperature,
               "topp": topp, "seed": seed, "slo": slo, "cursor": cursor}
        if trace is not None:
            rec["trace"] = str(trace)
        if entry.ledger is not None:
            rec["ledger"] = entry.ledger
        if recovers is not None:
            rec["recovers"] = int(recovers)
        with self._lock:
            self._entries[rid] = entry
            if recovers is not None:
                old = self._entries.get(recovers)
                if old is not None and old.status is None:
                    old.status = "recovered"
                    self._n_retired += 1
            self._append(rec)

    def token(self, rid: int, tok: int, cursor: int) -> None:
        with self._lock:
            e = self._entries[rid]
            e.sampled.append(int(tok))
            e.cursor = int(cursor)
            self._append({"t": "tok", "id": rid, "tok": int(tok),
                          "cursor": int(cursor)})

    def retire(self, rid: int, status: str = "done") -> None:
        with self._lock:
            e = self._entries.get(rid)
            if e is None or e.status is not None:
                return  # already retired (or never journaled): idempotent
            e.status = status
            self._n_retired += 1
            self._append({"t": "retire", "id": rid, "status": status})

    def sync(self, force: bool = False) -> None:
        """Step-boundary durability point (batch policy): one flush+fsync
        covering every record since the last sync. No-op when nothing is
        dirty or the policy already synced per record."""
        with self._lock:
            if not (self._dirty or force):
                return
            self._fh.flush()
            if self.fsync != "off" or force:
                # batch durability point: same WAL contract as _append —
                # the fsync covers exactly the records under this lock
                os.fsync(self._fh.fileno())  # threadcheck: allow[T003]
            self._dirty = False

    def close(self) -> None:
        self.sync(force=True)
        with self._lock:
            self._fh.close()

    # ------------------------------------------------------- compaction

    def compact(self) -> int:
        """Atomically rewrite the journal as merged admit records of the
        LIVE requests only (module docstring), dropping retired ones.
        Crash-safe: the new content lands in a sibling temp file, is
        fsynced, and replaces the journal in one ``os.replace`` — at any
        kill point exactly one complete journal exists. Returns the
        number of retired requests dropped."""
        with self._lock:
            live = sorted((e for e in self._entries.values()
                           if e.status is None), key=lambda e: e.rid)
            dropped = self._n_retired
            tmp = self.path + ".compact"
            # preserve the journal's recorded config across rotation (a
            # handle opened without one must not strip the fingerprint)
            head = dict(_HEADER)
            cfg = self.config if self.config is not None \
                else self.header_config
            if cfg is not None:
                head["config"] = cfg
            with open(tmp, "wb") as fh:
                fh.write((json.dumps(head, separators=(",", ":"))
                          + "\n").encode())
                for e in live:
                    rec = {"t": "admit", "id": e.rid,
                           "tokens": e.replay_tokens, "steps": e.steps,
                           "temperature": e.temperature, "topp": e.topp,
                           "seed": e.seed, "slo": e.slo,
                           "cursor": e.cursor}
                    if e.trace is not None:
                        rec["trace"] = e.trace
                    if e.ledger is not None:
                        rec["ledger"] = e.ledger
                    fh.write((json.dumps(rec, separators=(",", ":"))
                              + "\n").encode())
                fh.flush()
                # compaction writes the replacement file atomically;
                # appends must stall until the rename lands or they'd
                # hit the about-to-be-replaced fd
                os.fsync(fh.fileno())  # threadcheck: allow[T003]
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            self._entries = {
                e.rid: JournalEntry(
                    rid=e.rid, tokens=e.replay_tokens, steps=e.steps,
                    temperature=e.temperature, topp=e.topp, seed=e.seed,
                    slo=e.slo, cursor=e.cursor, trace=e.trace,
                    ledger=e.ledger)
                for e in live}
            self._n_retired = 0
            self._dirty = False
        return dropped

    def maybe_compact(self) -> int:
        """The rotation policy: compact once ``compact_every`` retired
        requests have accumulated. Called at step boundaries."""
        if self._n_retired >= self.compact_every:
            return self.compact()
        return 0


def _parse_record(obj, entries: dict[int, JournalEntry],
                  lineno: int) -> None:
    """Apply one parsed record to the state; JournalCorruption on any
    schema violation."""
    if not isinstance(obj, dict) or not isinstance(obj.get("t"), str):
        raise JournalCorruption(f"line {lineno}: not a journal record")
    t = obj["t"]
    try:
        if t == "admit":
            rid = int(obj["id"])
            if rid in entries:
                raise JournalCorruption(
                    f"line {lineno}: duplicate admit for request {rid}")
            tokens = obj["tokens"]
            if not isinstance(tokens, list) or not tokens:
                raise JournalCorruption(
                    f"line {lineno}: admit {rid} has no prompt tokens")
            trace = obj.get("trace")
            if trace is not None and not isinstance(trace, str):
                raise JournalCorruption(
                    f"line {lineno}: admit {rid} trace is not a string")
            ledger = obj.get("ledger")
            if ledger is not None and not isinstance(ledger, dict):
                raise JournalCorruption(
                    f"line {lineno}: admit {rid} ledger is not an object")
            entries[rid] = JournalEntry(
                rid=rid, tokens=[int(x) for x in tokens],
                steps=int(obj["steps"]),
                temperature=float(obj["temperature"]),
                topp=float(obj["topp"]), seed=int(obj["seed"]),
                slo=obj.get("slo"), cursor=int(obj.get("cursor", 0)),
                trace=trace, ledger=ledger)
            recovers = obj.get("recovers")
            if recovers is not None:
                # recovery re-admission: this one record also closes the
                # previous life (see RequestJournal.admit)
                old = entries.get(int(recovers))
                if old is not None and old.status is None:
                    old.status = "recovered"
        elif t == "tok":
            rid = int(obj["id"])
            e = entries.get(rid)
            if e is None:
                raise JournalCorruption(
                    f"line {lineno}: token for unadmitted request {rid}")
            if e.status is not None:
                raise JournalCorruption(
                    f"line {lineno}: token for retired request {rid}")
            e.sampled.append(int(obj["tok"]))
            e.cursor = int(obj["cursor"])
        elif t == "retire":
            rid = int(obj["id"])
            e = entries.get(rid)
            if e is None:
                raise JournalCorruption(
                    f"line {lineno}: retire for unadmitted request {rid}")
            status = obj.get("status")
            if status not in ("done", "cancelled", "failed", "recovered"):
                raise JournalCorruption(
                    f"line {lineno}: retire status {status!r}")
            e.status = status
        else:
            raise JournalCorruption(
                f"line {lineno}: unknown record type {t!r}")
    except (KeyError, TypeError, ValueError) as exc:
        raise JournalCorruption(
            f"line {lineno}: malformed {t!r} record: {exc}") from exc


def _load_file(path: str) -> tuple[dict[int, JournalEntry], int,
                                   dict | None]:
    """Parse a journal file. Returns (entries, valid_bytes, header_config)
    where valid_bytes is the offset just past the last VALID record —
    shorter than the file only for a torn tail — and header_config the
    config fingerprint the header recorded (None on legacy headers).
    Raises JournalCorruption for any non-tail damage (module docstring)."""
    entries: dict[int, JournalEntry] = {}
    header_cfg: dict | None = None
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.split(b"\n")
    # data ending in \n splits to a trailing b"" — complete final record;
    # anything else in the last slot is a torn (unterminated) tail
    torn = lines.pop() if lines else b""
    offset = 0
    for i, raw in enumerate(lines):
        try:
            obj = json.loads(raw)
        except ValueError as exc:
            if i == len(lines) - 1 and not torn:
                # newline-terminated but unparsable LAST line: a torn
                # record whose tail bytes happened to include the \n —
                # same truncate-and-report treatment
                return entries, offset, header_cfg
            raise JournalCorruption(
                f"line {i + 1}: unparseable record "
                f"{raw[:64]!r}") from exc
        if i == 0:
            if (not isinstance(obj, dict) or obj.get("t") != "journal"
                    or obj.get("v") != 1):
                raise JournalCorruption(
                    "missing or wrong journal header (line 1)")
            cfg = obj.get("config")
            if cfg is not None and not isinstance(cfg, dict):
                raise JournalCorruption(
                    "header config fingerprint is not an object")
            header_cfg = cfg
        else:
            try:
                _parse_record(obj, entries, i + 1)
            except JournalCorruption:
                if i == len(lines) - 1 and not torn:
                    # schema-torn tail (e.g. a short but valid-JSON
                    # fragment): truncate like any other torn tail
                    return entries, offset, header_cfg
                raise
        offset += len(raw) + 1
    # no complete line at all (killed mid-header-write): fully torn —
    # truncate to zero and start fresh rather than refusing a journal
    # that never recorded anything
    return entries, offset, header_cfg


def entry_to_wire(entry: JournalEntry) -> dict:
    """The handoff wire form of a journal entry: the plain
    JSON-able dict a prefill pool ships to a decode pool — exactly the
    fields ``ContinuousEngine.recover`` replays from, so a handed-off
    request and a crash-recovered one re-admit through ONE code path.
    ``sampled`` stays separate from ``tokens`` (the receiver composes
    ``replay_tokens`` itself) so the record is honest about what was
    prompt and what was generated. ``trace`` carries the traceparent
    header: the decode pool continues the SAME trace the
    prefill pool opened."""
    rec = {"id": entry.rid, "tokens": list(entry.tokens),
           "sampled": list(entry.sampled), "cursor": entry.cursor,
           "steps": entry.steps, "temperature": entry.temperature,
           "topp": entry.topp, "seed": entry.seed, "slo": entry.slo,
           "trace": entry.trace}
    if entry.ledger is not None:
        rec["ledger"] = dict(entry.ledger)
    return rec


def entry_from_wire(rec: dict) -> JournalEntry:
    """entry_to_wire's inverse, with the same strictness as journal
    loading: a malformed handoff record raises ValueError (the decode
    pool refuses it — admitting a half-parsed request would serve wrong
    bytes with a straight face)."""
    try:
        tokens = [int(t) for t in rec["tokens"]]
        if not tokens:
            raise ValueError("handoff record has no prompt tokens")
        trace = rec.get("trace")
        if trace is not None and not isinstance(trace, str):
            raise ValueError("handoff record trace is not a string")
        ledger = rec.get("ledger")
        if ledger is not None and not isinstance(ledger, dict):
            raise ValueError("handoff record ledger is not an object")
        return JournalEntry(
            rid=int(rec["id"]), tokens=tokens,
            steps=int(rec["steps"]),
            temperature=float(rec["temperature"]),
            topp=float(rec["topp"]), seed=int(rec["seed"]),
            slo=rec.get("slo"), cursor=int(rec.get("cursor", 0)),
            sampled=[int(t) for t in rec.get("sampled", ())],
            trace=trace, ledger=ledger)
    except (KeyError, TypeError, ValueError) as exc:
        raise ValueError(f"malformed handoff record: {exc}") from exc


def load_journal(path: str) -> list[JournalEntry]:
    """Read-only load: every entry (retired included), rid-sorted. The
    torn-tail rule applies; the file is not modified."""
    entries, _, _ = _load_file(path)
    return sorted(entries.values(), key=lambda e: e.rid)
