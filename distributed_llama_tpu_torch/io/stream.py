"""Root -> worker weight streaming: a host with no model file fetches it, or
only its tensor-parallel bands of it, from the root (the JAX package's
io/stream.py, the same protocol and sidecar byte for byte).

The reference scatters weight slices from the root's mmap to each worker
over its TCP star at startup (transformer.cpp:250-273 root side, :354-380
worker side, with the kB/s progress log). Here:

* ``WeightServer`` (root): serves byte ranges of the .bin over TCP. Three
  line-framed requests: ``SPEC`` (answered with the ``DLTPU1`` magic and
  the file size), ``GET <offset> <length>`` (the raw bytes, sent in 4 MiB
  chunks) and ``DONE``. Either package's client talks to either package's
  server.
* ``fetch_model`` (worker): the whole file into ``<path>``, through a
  ``.part`` file renamed into place, with the ⏩ kB/s progress line.
* ``fetch_model_slices`` (worker): only the byte ranges the host's tp ranks
  read (``needed_byte_ranges``), written into a full-size sparse file with
  a ``.slices`` sidecar that records the resident ranges, each with the
  CRC32 of its bytes as read back from disk. The next fetch verifies every
  range before it trusts it, tops up what is missing, and a connection
  dropped mid-transfer resumes from the ranges that landed.

Where the port differs from the JAX package: the ranges follow the bands
that ``parallel/tp.load_model_bands`` reads under the tp scheme. The JAX
function always takes each matmul's output-row band, but the fused and
overlap schemes band ``wo`` and ``w2`` on their INPUT dim, a column stripe
of every row in the file's row-major layout; a host fetching row bands
there would load zeros into most of its stripe. An input-banded tensor is
fetched whole: its exact stripes are one short range per row (about
262 000 at 7B tp 2), and one request line, one server-side seek and send
and one sidecar entry with its CRC per range cost more than the tensor's
other bands (about 0.56 GB at 7B tp 2, wo and w2 being a third of the
layer bytes). Under ``ref`` the ranges are the JAX function's.

Trust model: the byte service is unauthenticated, as the reference's
worker sockets are: anyone who can reach the port can read the model
file. Bind it to a cluster-internal address (``--serve-weights-bind``).
"""

from __future__ import annotations

import errno
import json
import os
import socket
import socketserver
import struct
import sys
import tempfile
import threading
import time
import zlib

_MAGIC = b"DLTPU1"  # protocol version tag; bump on any framing change
_CHUNK = 4 << 20


class WeightServer:
    """Serve a .bin's bytes to fetching hosts (root side): a daemon thread
    per connection; ``port=0`` picks a free port (``.port``). It serves
    until ``close()``: workers may connect at any point of the root's own
    load."""

    def __init__(self, path: str, host: str = "0.0.0.0", port: int = 0):
        self.path = os.path.abspath(path)
        self.size = os.path.getsize(self.path)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with open(outer.path, "rb") as fh:
                    f = self.request.makefile("rb")
                    while True:
                        line = f.readline()
                        if not line or line.strip() == b"DONE":
                            return
                        parts = line.split()
                        if not parts:
                            return  # blank line: malformed, drop
                        if parts[0] == b"SPEC":
                            self.request.sendall(
                                _MAGIC + struct.pack("<q", outer.size))
                        elif parts[0] == b"GET" and len(parts) == 3:
                            off, ln = int(parts[1]), int(parts[2])
                            if off < 0 or ln < 0 or off + ln > outer.size:
                                return  # malformed: drop the connection
                            fh.seek(off)
                            remaining = ln
                            while remaining:
                                chunk = fh.read(min(remaining, _CHUNK))
                                if not chunk:
                                    return
                                self.request.sendall(chunk)
                                remaining -= len(chunk)
                        else:
                            return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        # close() waits for the serving loop's next poll: 50 ms at most
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _say(text: str, err: bool = False) -> None:
    print(text, file=sys.stderr if err else sys.stdout, flush=True)


def _recv_exact(sock: socket.socket, n: int, into=None) -> bytes | None:
    buf = into if into is not None else bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("weight stream closed mid-transfer "
                                  "(short read)")
        got += r
    return None if into is not None else bytes(buf)


# errno values worth retrying: the server has not bound yet, the network
# hiccuped, or a half-open connection died; anything else (bad address,
# DNS failure, permission) is a configuration error retrying cannot fix
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name) for name in (
        "ECONNREFUSED", "ECONNRESET", "ECONNABORTED", "ETIMEDOUT",
        "EHOSTUNREACH", "ENETUNREACH", "EHOSTDOWN", "ENETDOWN", "EPIPE",
        "EAGAIN", "EINTR") if hasattr(errno, name))


def _is_transient(exc: BaseException) -> bool:
    if isinstance(exc, (ConnectionError, TimeoutError, socket.timeout)):
        return True
    if isinstance(exc, socket.gaierror):
        # EAI_AGAIN is the resolver saying "not yet"; any other resolution
        # failure is a typo
        return exc.errno == socket.EAI_AGAIN
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def _connect_with_retry(host: str, port: int, timeout: float,
                        connect_window: float) -> socket.socket:
    """Retry transient connect failures for up to ``connect_window``
    seconds, backing off from 50 ms, doubling to a 2 s cap (a worker may
    start before the root's server binds); a non-transient failure raises
    at once."""
    deadline = time.monotonic() + connect_window
    delay = 0.05
    while True:
        try:
            return socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            if not _is_transient(e) or time.monotonic() >= deadline:
                raise
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2.0, 2.0)


def _connect_spec(host: str, port: int, timeout: float,
                  connect_window: float) -> tuple[socket.socket, int]:
    """Connect and run the SPEC handshake: (socket, served file size). A
    magic mismatch raises at once: the endpoint is the wrong server."""
    s = _connect_with_retry(host, port, timeout, connect_window)
    try:
        s.sendall(b"SPEC\n")
        head = _recv_exact(s, len(_MAGIC) + 8)
    except BaseException:
        s.close()
        raise
    if head[:len(_MAGIC)] != _MAGIC:
        s.close()
        raise ValueError("weight server protocol mismatch "
                         f"(got {head[:len(_MAGIC)]!r})")
    return s, struct.unpack("<q", head[len(_MAGIC):])[0]


def merge_ranges(ranges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sort and coalesce (offset, length) ranges (adjacent or overlapping)."""
    out: list[list[int]] = []
    for off, ln in sorted(r for r in ranges if r[1] > 0):
        if out and off <= out[-1][0] + out[-1][1]:
            out[-1][1] = max(out[-1][1], off + ln - out[-1][0])
        else:
            out.append([off, ln])
    return [(o, l) for o, l in out]


def subtract_ranges(need: list[tuple[int, int]],
                    have: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Ranges of ``need`` not covered by ``have``."""
    out: list[tuple[int, int]] = []
    have = merge_ranges(have)
    for off, ln in merge_ranges(need):
        end = off + ln
        cur = off
        for ho, hl in have:
            he = ho + hl
            if he <= cur or ho >= end:
                continue
            if ho > cur:
                out.append((cur, ho - cur))
            cur = max(cur, he)
            if cur >= end:
                break
        if cur < end:
            out.append((cur, end - cur))
    return out


def needed_byte_ranges(spec, tp: int, ranks: set[int],
                       scheme: str | None = None) -> list[tuple[int, int]]:
    """The byte ranges of the .bin that ``load_model_bands(path, r, tp,
    scheme)`` reads for every ``r`` in ``ranks``: the header, every
    replicated tensor whole, each output-banded matmul's row band per
    rank, and each input-banded matmul (wo and w2 under fused/overlap)
    whole (module docstring). The RoPE gap is skipped (the loader skips
    it). Under ``ref`` these are the JAX package's ranges."""
    from ..models.spec import HEADER_BYTES
    from ..parallel.tp import _effective_scheme, param_specs
    from .loader import tensor_byte_ranges

    if tp < 1 or any(r < 0 or r >= tp for r in ranks):
        raise ValueError(f"ranks {sorted(ranks)} invalid for tp={tp}")
    scheme = _effective_scheme(scheme, tp)
    bands = param_specs({**dict(spec.layer_matmul_shapes()), "wcls": None},
                        scheme)
    ranges: list[tuple[int, int]] = [(0, HEADER_BYTES)]
    for tr in tensor_byte_ranges(spec):
        if tr.name == "_rope_gap":
            continue
        if tr.rows is None or tp == 1 or bands[tr.name] != "out":
            ranges.append((tr.offset, tr.nbytes))
            continue
        if tr.rows % tp:
            raise ValueError(f"{tr.name}: rows {tr.rows} not divisible by "
                             f"tp={tp}")
        band = (tr.rows // tp) * (tr.nbytes // tr.rows)
        for r in sorted(set(ranks)):
            ranges.append((tr.offset + r * band, band))
    return merge_ranges(ranges)


def _sidecar_path(cache_path: str) -> str:
    return cache_path + ".slices"


def write_record_sidecar(path: str, size: int, entries) -> None:
    """Write a record-granular ``.slices`` sidecar: the weight-cache format
    with its ranges left unmerged, so each record keeps its own CRC.
    Atomic (a temporary file, then ``os.replace``)."""
    tmp = _sidecar_path(path) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"size": size,
                   "ranges": [list(e) for e in entries]}, fh)
    os.replace(tmp, _sidecar_path(path))


def append_record_verified(path: str, blob: bytes,
                           entries=None) -> tuple[int, int, int]:
    """Append ``blob`` to ``path``, CRC it as read back from disk, and add
    the record to the sidecar unmerged; returns (offset, length, crc).
    With ``entries`` (a caller-kept list of [off, len, crc]) the entry is
    appended there and the sidecar write is left to the caller."""
    with open(path, "ab") as fh:
        off = fh.tell()
        fh.write(blob)
    with open(path, "rb") as fh:
        crc = _crc_file_range(fh, off, len(blob))
    if crc is None:
        raise OSError(f"{path}: appended record [{off}, "
                      f"{off + len(blob)}) did not land on disk")
    if entries is not None:
        entries.append([off, len(blob), crc])
        return off, len(blob), crc
    try:
        with open(_sidecar_path(path)) as fh:
            meta = json.load(fh)
    except (FileNotFoundError, ValueError):
        meta = {"ranges": []}
    write_record_sidecar(path, off + len(blob),
                         list(meta.get("ranges", []))
                         + [[off, len(blob), crc]])
    return off, len(blob), crc


def read_record_verified(path: str, off: int, length: int,
                         crc: int) -> bytes | None:
    """One record of an append-only file, or None when it is short,
    unreadable or fails its CRC."""
    try:
        with open(path, "rb") as fh:
            fh.seek(off)
            data = fh.read(length)
    except OSError:
        return None
    if len(data) != length or zlib.crc32(data) != crc:
        return None
    return data


def verified_ranges(path: str) -> list[tuple[int, int]] | None:
    """The sidecar's ranges of ``path`` that still pass their CRCs; None
    when there is no sidecar."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return []
    return _read_sidecar(path, size)


def _crc_file_range(fh, off: int, ln: int) -> int | None:
    """CRC32 of ``ln`` bytes at ``off`` of an open binary file; None when
    the file is too short to hold them."""
    fh.seek(off)
    crc = 0
    remaining = ln
    while remaining:
        chunk = fh.read(min(_CHUNK, remaining))
        if not chunk:
            return None
        crc = zlib.crc32(chunk, crc)
        remaining -= len(chunk)
    return crc


def _write_sidecar(cache_path: str, size: int, ranges,
                   crc: bool = True) -> None:
    """Record the sparse file's resident ranges (merged), each with the
    CRC32 of its bytes as read back from the file; ``crc=False`` writes
    the two-field entries of the resume checkpoint, which a dropped
    connection writes without re-reading its progress. Atomic."""
    entries = []
    merged = merge_ranges(list(ranges))
    if merged and not crc:
        entries = [[off, ln] for off, ln in merged]
    elif merged:
        with open(cache_path, "rb") as fh:
            for off, ln in merged:
                rc = _crc_file_range(fh, off, ln)
                if rc is None:
                    raise ValueError(
                        f"{cache_path} shorter than its recorded range "
                        f"[{off}, {off + ln})")
                entries.append([off, ln, rc])
    tmp = _sidecar_path(cache_path) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"size": size, "ranges": entries}, fh)
    os.replace(tmp, _sidecar_path(cache_path))


def _read_sidecar(cache_path: str, size: int) -> list[tuple[int, int]] | None:
    """The resident ranges of a sparse file; None when it has no sidecar
    (not a sparse file). A range with a CRC that no longer matches is
    dropped (and re-fetched by the caller); two-field ranges pass; a
    sidecar that does not parse, or records another size, gives []."""
    try:
        with open(_sidecar_path(cache_path)) as fh:
            meta = json.load(fh)
    except FileNotFoundError:
        return None
    except ValueError:
        return []
    try:
        if meta.get("size") != size:
            return []  # another model: nothing usable
        out: list[tuple[int, int]] = []
        with open(cache_path, "rb") as data:
            for entry in meta.get("ranges", []):
                off, ln = int(entry[0]), int(entry[1])
                if len(entry) > 2:
                    crc = _crc_file_range(data, off, ln)
                    if crc != int(entry[2]):
                        # stderr, quiet or not: damage never passes
                        # silently
                        _say(f"🔶 weight cache range [{off}, {off + ln}) "
                             f"of {cache_path} failed its CRC — "
                             f"re-fetching it", err=True)
                        continue
                out.append((off, ln))
        return out
    except (ValueError, KeyError, IndexError, TypeError, OSError):
        return []


def fetch_model_slices(addr: str, cache_path: str, weights_float_type,
                       tp: int, ranks: set[int], scheme: str | None = None,
                       quiet: bool = False, timeout: float = 600.0,
                       connect_window: float = 60.0, max_resumes: int = 8,
                       chunk_bytes: int = _CHUNK) -> str:
    """Fetch only the ranges a host whose processes hold tp ranks ``ranks``
    reads under ``scheme`` (needed_byte_ranges) into ``cache_path``, a
    full-size sparse file with a ``.slices`` sidecar; returns the path.

    The header is fetched first and parsed into the spec (the layout
    depends on ``weights_float_type``, which the caller knows from its
    flags). Re-runs with the same or fewer ranks fetch nothing, a wider
    set tops up only the missing ranges, and a full-size file without a
    sidecar whose header matches the served one is a hit. The empty
    sidecar is written before the first data byte, so a killed fetch is
    re-fetched, never trusted. A connection dropped mid-transfer resumes
    up to ``max_resumes`` times from the ranges that landed (persisted to
    the sidecar); ``chunk_bytes`` is the resume granularity. One fetcher
    per ``cache_path`` at a time."""
    from ..models.spec import HEADER_BYTES, TransformerSpec
    from ..parallel.tp import _effective_scheme

    scheme = _effective_scheme(scheme, tp)
    host, port_s = addr.rsplit(":", 1)
    port = int(port_s)
    s, size = _connect_spec(host, port, timeout, connect_window)
    try:
        s.sendall(f"GET 0 {HEADER_BYTES}\n".encode())
        raw = _recv_exact(s, HEADER_BYTES)
        spec = TransformerSpec.from_header(raw, weights_float_type,
                                           weights_float_type)
        if spec.file_size() != size:
            raise ValueError(
                f"served file is {size} bytes but its header implies "
                f"{spec.file_size()} for {weights_float_type} weights — "
                f"wrong --weights-float-type?")
        need = needed_byte_ranges(spec, tp, ranks, scheme)

        have = None
        existing = (os.path.exists(cache_path)
                    and os.path.getsize(cache_path) == size)
        if existing:
            have = _read_sidecar(cache_path, size)
            if have is None:
                # right size and no sidecar: a claimed full file, trusted
                # only if its header is the served one (a killed fetch's
                # holes read as zeros here)
                with open(cache_path, "rb") as fh:
                    if fh.read(HEADER_BYTES) == raw:
                        s.sendall(b"DONE\n")
                        if not quiet:
                            _say(f"⏩ weight cache hit: {cache_path} "
                                 f"({size} bytes)")
                        return cache_path
                _say(f"🔶 {cache_path} is full-size but its header does "
                     f"not match the served file — treating as crash "
                     f"residue and re-fetching", err=True)
                have = []
        missing = subtract_ranges(need, have or [])
        if not missing:
            s.sendall(b"DONE\n")
            if not quiet:
                _say(f"⏩ weight slice cache hit: {cache_path} "
                     f"({sum(l for _, l in have or [])} bytes resident)")
            return cache_path

        t0 = time.time()
        total = sum(ln for _, ln in missing)
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)),
                    exist_ok=True)
        done = 0
        if not have:
            # claim sparseness before the file can reach full size
            _write_sidecar(cache_path, size, [], crc=False)
        # ``got`` grows a chunk at a time: on a dropped connection it is
        # the resume state
        got: list[tuple[int, int]] = list(have or [])
        resumes = 0
        with open(cache_path, "r+b" if existing else "wb") as out:
            out.truncate(size)
            buf = bytearray(chunk_bytes)
            while True:
                todo = subtract_ranges(need, got)
                if not todo:
                    break
                try:
                    for off, ln in todo:
                        out.seek(off)
                        cur = 0
                        while cur < ln:
                            step = min(chunk_bytes, ln - cur)
                            s.sendall(f"GET {off + cur} {step}\n".encode())
                            _recv_exact(s, step,
                                        into=memoryview(buf)[:step])
                            out.write(memoryview(buf)[:step])
                            got.append((off + cur, step))
                            cur += step
                            done += step
                            if not quiet and (done >> 28) != (
                                    (done - step) >> 28):  # every 256 MB
                                kbs = (done / 1024
                                       / max(time.time() - t0, 1e-9))
                                _say(f"⏩ fetched {done >> 20}/"
                                     f"{total >> 20} MB of slices "
                                     f"({kbs:.0f} kB/s)")
                except OSError as e:
                    if not _is_transient(e):
                        raise  # a local fault (disk full, I/O error)
                    resumes += 1
                    if resumes > max_resumes:
                        raise
                    # persist the progress (the data on disk first, so the
                    # checksum-less checkpoint vouches only for landed
                    # bytes), reconnect, and fetch what is still missing
                    out.flush()
                    os.fsync(out.fileno())
                    _write_sidecar(cache_path, size, got, crc=False)
                    try:
                        s.close()
                    except OSError:
                        pass
                    _say(f"🔶 weight stream dropped mid-transfer "
                         f"({type(e).__name__}: {e}); resuming "
                         f"({resumes}/{max_resumes}) from {done >> 20} MB",
                         err=True)
                    s, size2 = _connect_spec(host, port, timeout,
                                             connect_window)
                    if size2 != size:
                        raise ValueError(
                            f"served file changed size mid-fetch "
                            f"({size} -> {size2} bytes)")
        _write_sidecar(cache_path, size, got)
        s.sendall(b"DONE\n")
        if not quiet:
            secs = time.time() - t0
            _say(f"⏩ fetched {total} slice bytes of {size} "
                 f"({100.0 * total / size:.0f}%, {len(missing)} ranges, tp "
                 f"ranks {sorted(ranks)} of {tp}, scheme {scheme}) in "
                 f"{secs:.1f}s ({total / 1024 / max(secs, 1e-9):.0f} kB/s)")
    finally:
        try:
            s.close()
        except OSError:
            pass
    return cache_path


def fetch_model(addr: str, cache_path: str, quiet: bool = False,
                timeout: float = 600.0,
                connect_window: float = 60.0) -> str:
    """Download the model from ``host:port`` into ``cache_path`` (returned).

    A file already there with the served size and no ``.slices`` sidecar
    is used as it is; a wrong-size or sparse one is fetched again. This is
    the one place that decides staleness, so callers call it
    unconditionally. The bytes go to a ``.part`` file in the same
    directory, renamed into place once complete (deleted on failure)."""
    host, port = addr.rsplit(":", 1)
    s, size = _connect_spec(host, int(port), timeout, connect_window)
    with s:
        if (os.path.exists(cache_path)
                and os.path.getsize(cache_path) == size
                and not os.path.exists(_sidecar_path(cache_path))):
            s.sendall(b"DONE\n")
            if not quiet:
                _say(f"⏩ weight cache hit: {cache_path} ({size} bytes)")
            return cache_path

        t0 = time.time()
        dst_dir = os.path.dirname(os.path.abspath(cache_path))
        os.makedirs(dst_dir, exist_ok=True)
        # a temporary file per fetcher: two racing on one path each write
        # their own and os.replace installs either (same bytes)
        fd, tmp = tempfile.mkstemp(dir=dst_dir, suffix=".part")
        try:
            with os.fdopen(fd, "wb") as out:
                off = 0
                buf = bytearray(_CHUNK)
                while off < size:
                    ln = min(_CHUNK, size - off)
                    s.sendall(f"GET {off} {ln}\n".encode())
                    _recv_exact(s, ln, into=memoryview(buf)[:ln])
                    out.write(memoryview(buf)[:ln])
                    off += ln
                    if not quiet and off % (256 << 20) < _CHUNK:
                        kbs = off / 1024 / max(time.time() - t0, 1e-9)
                        _say(f"⏩ fetched {off >> 20}/{size >> 20} MB "
                             f"({kbs:.0f} kB/s)")
            if os.path.getsize(tmp) != size:
                raise ValueError(f"fetched {os.path.getsize(tmp)} bytes, "
                                 f"expected {size}")
            os.replace(tmp, cache_path)
            try:  # complete now: drop a stale sparse marker
                os.unlink(_sidecar_path(cache_path))
            except FileNotFoundError:
                pass
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        s.sendall(b"DONE\n")
        if not quiet:
            secs = time.time() - t0
            _say(f"⏩ fetched model: {size} bytes in {secs:.1f}s "
                 f"({size / 1024 / max(secs, 1e-9):.0f} kB/s)")
    return cache_path
