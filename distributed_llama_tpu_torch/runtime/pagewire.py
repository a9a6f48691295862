"""The page wire codec: pack/unpack and CRC framing of KV page payloads
(the JAX package's runtime/pagewire.py, its own copy here).

A KV page leaves the device pool in one byte layout, the plane tuple
``models/llama.fetch_page_planes`` reads back: ``(k, v)`` f32/bf16 planes
or ``(kq, kd, vq, vd)`` Q8 codes and deltas, serialized contiguously in
tuple order. The disk tier stores that blob and the page channel ships
it between pools; both import this one codec, so the two layouts cannot
drift.

Two granularities:

* ``pack_planes`` / ``unpack_planes``: the bare payload blob plus the
  shape/dtype metadata needed to rebuild it. The disk tier stores the
  blob and keeps the metadata in its record ref; the CRC travels in the
  segment's ``.slices`` sidecar (io/stream.append_record_verified).
* ``encode_record`` / ``decode_record``: a self-describing framed record
  (metadata + CRC32 + blob in one byte string) for transports with no
  sidecar: the page channel ships these, and ``decode_record`` returns
  None on ANY damage (short frame, garbled metadata, CRC mismatch), so a
  dropped or corrupted page degrades to a re-fetch or a prefill, never to
  wrong attention bytes.

Frame layout (little-endian):

    u32 meta_len | meta json (shapes + dtype strs) | u32 crc32(blob)
    | u64 blob_len | blob

The blob inside a frame is ``pack_planes``' output verbatim: the disk
record and the in-flight payload are the same bytes for the same page.
Planes are numpy arrays; a bf16 pool's planes travel as their raw 16-bit
words (int16).
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

_HEAD = struct.Struct("<I")   # meta_len / crc32
_LEN = struct.Struct("<Q")    # blob_len


def pack_planes(planes) -> tuple[bytes, tuple]:
    """Serialize a page payload (a tuple of numpy planes in the page wire
    layout) into one blob plus the shape/dtype metadata to rebuild it."""
    metas = tuple((tuple(a.shape), a.dtype.str) for a in planes)
    blob = b"".join(np.ascontiguousarray(a).tobytes() for a in planes)
    return blob, metas


def unpack_planes(blob: bytes, metas) -> tuple:
    """pack_planes' inverse: read-only views over ``blob`` (every consumer
    copies anyway)."""
    out, off = [], 0
    for shape, dt in metas:
        dtype = np.dtype(dt)
        n = 1
        for d in shape:
            n *= int(d)
        out.append(np.frombuffer(blob, dtype, count=n,
                                 offset=off).reshape(shape))
        off += n * dtype.itemsize
    return tuple(out)


def plane_views(buf: np.ndarray, metas) -> tuple:
    """The planes of ``metas`` as writable views over a flat uint8 buffer
    laid out as pack_planes lays a blob out (a host-tier slab row)."""
    out, off = [], 0
    for shape, dt in metas:
        dtype = np.dtype(dt)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += n
    return tuple(out)


def encode_record(planes) -> bytes:
    """One self-describing framed page record (module docstring layout):
    the page channel's wire unit. Its blob is byte-identical to the disk
    tier's record for the same planes."""
    blob, metas = pack_planes(planes)
    meta = json.dumps([[list(s), d] for s, d in metas],
                      separators=(",", ":")).encode()
    return (_HEAD.pack(len(meta)) + meta
            + _HEAD.pack(zlib.crc32(blob)) + _LEN.pack(len(blob)) + blob)


def decode_record(data: bytes):
    """The planes of one framed record, CRC-verified; None on ANY damage
    (truncation, garbled metadata, checksum mismatch). The caller treats
    None as "this page never arrived": re-fetch it, or let prefill
    re-derive the positions it covered."""
    try:
        if len(data) < _HEAD.size:
            return None
        (meta_len,) = _HEAD.unpack_from(data, 0)
        off = _HEAD.size
        meta_raw = data[off:off + meta_len]
        if len(meta_raw) != meta_len:
            return None
        off += meta_len
        (crc,) = _HEAD.unpack_from(data, off)
        off += _HEAD.size
        (blob_len,) = _LEN.unpack_from(data, off)
        off += _LEN.size
        blob = data[off:off + blob_len]
        if len(blob) != blob_len or off + blob_len != len(data):
            return None
        if zlib.crc32(blob) != crc:
            return None
        metas = tuple((tuple(int(d) for d in s), dt)
                      for s, dt in json.loads(meta_raw))
        return unpack_planes(blob, metas)
    except (ValueError, KeyError, TypeError, struct.error):
        return None


def record_payload_bytes(planes_or_record) -> int:
    """Payload (blob) bytes of a page: the number the handoff budget
    (parallel/comm_stats.dcn_handoff_budget) prices; the framing is a
    small constant on top."""
    if isinstance(planes_or_record, (bytes, bytearray)):
        (meta_len,) = _HEAD.unpack_from(planes_or_record, 0)
        off = _HEAD.size + meta_len + _HEAD.size
        (blob_len,) = _LEN.unpack_from(planes_or_record, off)
        return int(blob_len)
    return sum(int(np.asarray(a).nbytes) for a in planes_or_record)
