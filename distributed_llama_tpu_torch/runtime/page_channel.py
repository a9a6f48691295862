"""The page channel: CRC-verified, resumable KV-page shipping between the
two pools of a disaggregated pair (the JAX package's
runtime/page_channel.py, its own copy here; the two speak the same
protocol, so either side may be either package's).

The prefill pool fills KV pages and the decode pool attends over them;
the bytes cross the network in between. This module is that wire: a
line-framed TCP protocol in the weight stream's mold (io/stream.py: the
SPEC/GET/DONE shape, ``connect_with_retry``'s transient-only backoff,
``recv_exact``'s short-read discipline), shipping pages in the one wire
layout everything else uses: ``runtime/pagewire.encode_record`` frames,
the exact plane bytes the disk tier stores plus self-describing metadata
and a per-page CRC32 verified on arrival.

Pull model: the PREFILL side publishes a handoff's page records under its
handoff id and serves them; the DECODE side fetches page by page, so a
dropped connection reconnects and continues from the first page it does
not hold (``max_resumes`` bounds the patience), and a page whose frame
fails its CRC is fetched again once before it is given up as None (the
decode pool then stops adoption at the gap and prefill re-derives the
suffix).

Protocol (line-framed requests, binary responses):

* ``SPEC`` -> magic + ``<q`` protocol check (a wrong server fails loudly);
* ``COUNT <hid>`` -> ``<q`` page count (-1 = unknown handoff);
* ``PAGE <hid> <idx>`` -> ``<q`` record length + the framed record bytes
  (-1 = unknown handoff/index);
* ``TRACE <hid>`` -> ``<q`` length + the handoff's traceparent header
  (-1 = unknown handoff or none published);
* ``ACK <hid>`` -> ``<q`` 0; the server drops the handoff's records (the
  publish buffer is a relay, not a cache);
* ``DONE`` -> close.

Trust model: an unauthenticated byte service on a trusted cluster
network, as the weight stream.
"""

from __future__ import annotations

import socketserver
import struct
import threading

from ..io.stream import _connect_with_retry as connect_with_retry
from ..io.stream import _is_transient as is_transient
from ..io.stream import _recv_exact as recv_exact

_MAGIC = b"DLPCH1"  # page-channel protocol tag; bump on framing changes
_I64 = struct.Struct("<q")


class PageChannelServer:
    """Prefill-side record service: ``publish`` a handoff's framed page
    records, serve them until the decode pool ``ACK``s (or ``retire`` is
    called — a cancelled handoff must not strand its bytes). ``port=0``
    picks a free port (exposed as ``.port``). The store is a RELAY with
    a retention cap, not a cache: beyond ``retain_max`` unacked handoffs
    the oldest is dropped (its decode pool re-derives via prefill) — a
    flaky peer that never acks must not grow host memory without bound."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 retain_max: int = 256):
        self._lock = threading.Lock()
        self._store: dict[str, list[bytes]] = {}  # insertion-ordered
        self._traces: dict[str, str] = {}  # hid -> traceparent header
        self.retain_max = max(1, retain_max)
        self.published_pages = 0
        self.served_pages = 0
        self.evicted_handoffs = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                f = self.request.makefile("rb")
                while True:
                    line = f.readline()
                    if not line or line.strip() == b"DONE":
                        return
                    parts = line.split()
                    if not parts:
                        return
                    if parts[0] == b"SPEC":
                        self.request.sendall(_MAGIC + _I64.pack(1))
                    elif parts[0] == b"COUNT" and len(parts) == 2:
                        hid = parts[1].decode("ascii", "replace")
                        with outer._lock:
                            recs = outer._store.get(hid)
                        n = -1 if recs is None else len(recs)
                        self.request.sendall(_I64.pack(n))
                    elif parts[0] == b"PAGE" and len(parts) == 3:
                        hid = parts[1].decode("ascii", "replace")
                        idx = int(parts[2])
                        with outer._lock:
                            recs = outer._store.get(hid)
                            rec = (recs[idx] if recs is not None
                                   and 0 <= idx < len(recs) else None)
                        if rec is None:
                            self.request.sendall(_I64.pack(-1))
                        else:
                            self.request.sendall(_I64.pack(len(rec)) + rec)
                            with outer._lock:
                                outer.served_pages += 1
                    elif parts[0] == b"TRACE" and len(parts) == 2:
                        hid = parts[1].decode("ascii", "replace")
                        with outer._lock:
                            hdr = outer._traces.get(hid)
                        if hdr is None:
                            self.request.sendall(_I64.pack(-1))
                        else:
                            raw = hdr.encode("ascii", "replace")
                            self.request.sendall(_I64.pack(len(raw)) + raw)
                    elif parts[0] == b"ACK" and len(parts) == 2:
                        outer.retire(parts[1].decode("ascii", "replace"))
                        self.request.sendall(_I64.pack(0))
                    else:
                        return  # malformed: drop the connection

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, hid: str, records: list[bytes],
                trace: str | None = None) -> None:
        """Stage a handoff's framed records (+ optionally its traceparent
        header — served by the TRACE command so the fetching
        pool joins the shipped pages to the sending pool's trace)."""
        with self._lock:
            self._store[hid] = list(records)
            if trace is not None:
                self._traces[hid] = str(trace)
            self.published_pages += len(records)
            while len(self._store) > self.retain_max:
                # dicts iterate in insertion order: drop the OLDEST
                # unacked handoff (its fetch, if it ever comes, returns
                # nothing and the decode pool prefills instead)
                gone = next(iter(self._store))
                self._store.pop(gone)
                self._traces.pop(gone, None)
                self.evicted_handoffs += 1

    def retire(self, hid: str) -> None:
        with self._lock:
            self._store.pop(hid, None)
            self._traces.pop(hid, None)

    @property
    def queue_depth(self) -> int:
        """Handoffs published and not yet acked — the /health "disagg"
        block's backlog figure."""
        with self._lock:
            return len(self._store)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class PageChannelClient:
    """Decode-side fetcher. One ``fetch`` per handoff: page-by-page pull
    with mid-transfer resume (reconnect + continue from the first
    missing page) and per-page CRC verification through
    ``pagewire.decode_record``."""

    def __init__(self, addr: str, timeout: float = 60.0,
                 connect_window: float = 20.0, max_resumes: int = 4):
        host, port_s = addr.rsplit(":", 1)
        self.host, self.port = host, int(port_s)
        self.timeout = timeout
        self.connect_window = connect_window
        self.max_resumes = max_resumes
        self.resumes = 0
        self.crc_refetches = 0

    def _connect(self):
        s = connect_with_retry(self.host, self.port, self.timeout,
                               self.connect_window)
        try:
            s.sendall(b"SPEC\n")
            head = recv_exact(s, len(_MAGIC) + _I64.size)
        except BaseException:
            s.close()
            raise
        if head[:len(_MAGIC)] != _MAGIC:
            s.close()
            raise ValueError(f"page channel protocol mismatch "
                             f"(got {head[:len(_MAGIC)]!r})")
        return s

    @staticmethod
    def _req_page(s, hid: str, idx: int) -> bytes | None:
        s.sendall(f"PAGE {hid} {idx}\n".encode())
        (n,) = _I64.unpack(recv_exact(s, _I64.size))
        if n < 0:
            return None
        return recv_exact(s, n)

    def trace(self, hid: str) -> str | None:
        """The traceparent header published with handoff ``hid``, or None
        when the server holds none (a trace-less handoff still fetches;
        its spans just do not join)."""
        s = self._connect()
        try:
            s.sendall(f"TRACE {hid}\n".encode())
            (n,) = _I64.unpack(recv_exact(s, _I64.size))
            hdr = (recv_exact(s, n).decode("ascii", "replace")
                   if n >= 0 else None)
            s.sendall(b"DONE\n")
            return hdr
        finally:
            try:
                s.close()
            except OSError:
                pass

    def ack(self, hid: str) -> None:
        """Explicitly retire a handoff server-side (the decode pool's
        give-up path: nothing will fetch these pages now — don't leave
        them to the retention cap)."""
        s = self._connect()
        try:
            s.sendall(f"ACK {hid}\n".encode())
            recv_exact(s, _I64.size)
            s.sendall(b"DONE\n")
        finally:
            try:
                s.close()
            except OSError:
                pass

    def fetch(self, hid: str, n_pages: int | None = None,
              ack: bool = True, cut_after: int | None = None) -> list:
        """Every page payload of handoff ``hid`` as decoded plane tuples
        (wire layout, CRC-verified). A page that cannot be produced —
        unknown on the server, or CRC-dead after one re-fetch — comes
        back as None in its slot; the adoption side stops at the first
        gap and prefill re-derives the rest. ``cut_after`` (drills)
        hard-aborts the transfer after that many pages — the
        kill-mid-handoff injection point. ``ack=True`` retires the
        handoff server-side once every page decoded."""
        from .pagewire import decode_record

        s = self._connect()
        planes: list = []
        try:
            if n_pages is None:
                s.sendall(f"COUNT {hid}\n".encode())
                (n_pages,) = _I64.unpack(recv_exact(s, _I64.size))
                if n_pages < 0:
                    return []
            resumes = 0
            idx = 0
            retried: set = set()  # pages already given their CRC retry
            while idx < n_pages:
                if cut_after is not None and idx >= cut_after:
                    raise ConnectionError(
                        "page channel cut mid-transfer (injected)")
                try:
                    rec = self._req_page(s, hid, idx)
                except OSError as e:
                    if not is_transient(e) or resumes >= self.max_resumes:
                        raise
                    resumes += 1
                    self.resumes += 1
                    try:
                        s.close()
                    except OSError:
                        pass
                    # resume: reconnect and continue from the first page
                    # we do not hold — pages already decoded stay
                    s = self._connect()
                    continue
                got = decode_record(rec) if rec is not None else None
                if got is None and rec is not None and idx not in retried:
                    # in-flight damage: ONE re-fetch, routed back through
                    # this same loop so a transient disconnect during the
                    # retry rides the resume machinery like any other
                    retried.add(idx)
                    self.crc_refetches += 1
                    continue
                planes.append(got)  # None = page given up: re-derive
                idx += 1
            if ack and all(p is not None for p in planes):
                s.sendall(f"ACK {hid}\n".encode())
                recv_exact(s, _I64.size)
            s.sendall(b"DONE\n")
        finally:
            try:
                s.close()
            except OSError:
                pass
        return planes
