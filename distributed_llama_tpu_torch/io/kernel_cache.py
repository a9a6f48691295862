"""The device-ready host tree's sidecar (the JAX package's
io/kernel_cache.py, for the port's layout).

A load of a Q40 ``.bin`` splits every 18-byte record into its codes and
f16 scale (io/loader.load_model) and fuses each layer's q/k/v and w1/w3
into ``wqkv`` / ``w13`` (models/llama.params_to_device): host passes over
the whole file that repeat on every load. This module writes the tree as
it stands after both — codes and scales split, wqkv and w13 fused, every
leaf in the port's device layout (the codec layout, ops/linear.
q40_to_device) — into one mmap-able file beside the model,
``<model>.tkcache``; a later load memory-maps its leaves, and what is left
is the host-to-device copy. The name is the port's own: the JAX package
writes ``<model>.kcache`` in its own layout, and neither package reads or
overwrites the other's.

File format (little-endian):
    MAGIC(8) | u32 header_len | header JSON | 4096-aligned raw arrays
header = {"key": layout-key, "entries": [{"name", "kind",
          "arrays": [{"shape", "dtype", "offset", "nbytes"}]}]}
kinds: dense (1 array), q40w (qs, d16).

The key holds the format version, the float types and the model file's
size and mtime; any mismatch (or a damaged file) rebuilds, never serves
stale weights. ``DLLAMA_TILED_CACHE=0`` turns the sidecar off;
``DLLAMA_TILED_CACHE=1`` turns it on for any device. Unset, it is on
where the kernels run (a CUDA device), as the JAX package keeps its
sidecar for its TPU kernel layout. Only Q40 weights have a split and a
fusion to skip; other types load as before. A build lock (``.lock``, an
O_EXCL file) keeps two concurrent loads from both writing; a lock older
than an hour is taken as orphaned and broken.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ..ops.linear import FUSED_LOAD, fusible
from ..ops.quants import FloatType
from . import loader
from .loader import Q40Weight

MAGIC = b"DLTK0001"
_ALIGN = 4096
SUFFIX = ".tkcache"


def layout_key(model_path: str | None = None,
               weights_float_type=None, buffer_float_type=None) -> str:
    """Everything that decides the tree's contents: the format, the float
    types it was decoded under, the fusions, and the model file's identity
    (size + mtime: a new checkpoint written to the same path invalidates
    the sidecar)."""
    src = ""
    if model_path is not None:
        st = os.stat(model_path)
        src = f"|src={st.st_size}:{st.st_mtime_ns}"
    wf = getattr(weights_float_type, "name", weights_float_type) or "Q40"
    bf = getattr(buffer_float_type, "name", buffer_float_type) or "F32"
    fused = ",".join(f"{k}={'+'.join(v)}" for k, v in FUSED_LOAD.items())
    return f"torch-v1|codec|{fused}|wf={wf}|bf={bf}{src}"


def sidecar_path(model_path: str) -> str:
    return model_path + SUFFIX


_LOCK_STALE_S = 3600.0


def _lock_path(side: str) -> str:
    return side + ".lock"


def try_build_lock(side: str):
    """O_EXCL lock file guarding the sidecar build: two concurrent loads of
    one model must not both write a GB-scale ``.tmp<pid>``. Returns a
    token for release_build_lock, or None while another live process
    holds the lock (the caller then skips the write; its load keeps its
    in-memory tree). A lock older than _LOCK_STALE_S is broken by an
    atomic rename, so one breaker wins."""
    lock = _lock_path(side)
    for _ in range(2):
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, f"{os.getpid()}\n".encode())
            os.close(fd)
            return lock
        except FileExistsError:
            try:
                age = time.time() - os.stat(lock).st_mtime
            except OSError:
                continue  # released between open and stat: retry
            if age < _LOCK_STALE_S:
                return None
            try:
                claimed = lock + f".stale{os.getpid()}"
                os.rename(lock, claimed)
                # the rename may have taken a FRESH lock another breaker
                # just made: give it back (link fails if a newer exists)
                if time.time() - os.stat(claimed).st_mtime < _LOCK_STALE_S:
                    try:
                        os.link(claimed, lock)
                    except OSError:
                        pass
                    os.unlink(claimed)
                    return None
                os.unlink(claimed)
            except OSError:
                return None  # another breaker won the rename
        except OSError:
            return None  # an unwritable directory: save_packed says so
    return None


def release_build_lock(token) -> None:
    try:
        os.unlink(token)
    except OSError:
        pass


def _fields(v) -> list:
    """A leaf's arrays: [dense], [qs, d16], or for a fusion (a list of
    stacked Q40 weights, concatenated on their row axis) the parts of
    each field."""
    if isinstance(v, list):
        return [[w.qs for w in v], [w.d16 for w in v]]
    if isinstance(v, Q40Weight):
        return [v.qs, v.d16]
    return [np.asarray(v)]


def _meta(field) -> dict:
    if isinstance(field, list):  # row-axis concatenation of (L, r_i, ...)
        shape = list(field[0].shape)
        shape[1] = sum(a.shape[1] for a in field)
        dtype = field[0].dtype
    else:
        shape, dtype = list(field.shape), field.dtype
    return {"shape": shape, "dtype": np.dtype(dtype).str,
            "nbytes": int(np.prod(shape)) * np.dtype(dtype).itemsize}


def _write_field(fh, field) -> None:
    if not isinstance(field, list):
        fh.write(memoryview(np.ascontiguousarray(field)).cast("B"))
        return
    for layer in range(field[0].shape[0]):  # layer-major, parts in order
        for part in field:
            fh.write(memoryview(np.ascontiguousarray(part[layer])).cast("B"))


def save_packed(path: str, key: str, tree: dict) -> None:
    """Write the tree atomically (tmp + rename). A leaf is a dense array,
    a Q40Weight, or a list of stacked Q40Weights written as their
    concatenation along the row axis (a fusion, streamed layer by layer
    without building it in memory)."""
    entries, fields, off = [], [], 0
    for name, v in tree.items():
        kind = "dense" if not isinstance(v, (Q40Weight, list)) else "q40w"
        metas = []
        for f in _fields(v):
            m = _meta(f)
            off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
            m["offset"] = off
            off += m["nbytes"]
            metas.append(m)
            fields.append((m, f))
        entries.append({"name": name, "kind": kind, "arrays": metas})
    header = json.dumps({"key": key, "entries": entries}).encode()
    base = len(MAGIC) + 4 + len(header)
    base_pad = (base + _ALIGN - 1) // _ALIGN * _ALIGN
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(MAGIC)
            fh.write(np.uint32(len(header)).tobytes())
            fh.write(header)
            pos = base
            for m, f in fields:
                want = base_pad + m["offset"]
                fh.write(b"\x00" * (want - pos))
                _write_field(fh, f)
                pos = want + m["nbytes"]
        os.replace(tmp, path)
    except BaseException:
        try:  # a half-written tmp must not outlive a failed write
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_packed(path: str, key: str) -> dict | None:
    """Memory-map a sidecar written by save_packed (copy-on-write pages:
    writable views that never write the file); None on any mismatch or
    damage — the caller rebuilds."""
    try:
        with open(path, "rb") as fh:
            if fh.read(len(MAGIC)) != MAGIC:
                return None
            hlen = int(np.frombuffer(fh.read(4), np.uint32)[0])
            header = json.loads(fh.read(hlen).decode())
        if header.get("key") != key:
            print(f"device-layout cache key mismatch ({path}): cached for "
                  f"{header.get('key')!r}, want {key!r}; rebuilding",
                  file=sys.stderr)
            return None
        base = len(MAGIC) + 4 + hlen
        base_pad = (base + _ALIGN - 1) // _ALIGN * _ALIGN
        buf = np.memmap(path, dtype=np.uint8, mode="c")
        tree: dict = {}
        for e in header["entries"]:
            fields = []
            for m in e["arrays"]:
                start = base_pad + m["offset"]
                if start + m["nbytes"] > buf.size:
                    raise ValueError("truncated sidecar")
                raw = buf[start:start + m["nbytes"]]
                fields.append(raw.view(np.dtype(m["dtype"]))
                              .reshape(m["shape"]))
            want = {"dense": 1, "q40w": 2}[e["kind"]]
            if len(fields) != want:
                return None
            tree[e["name"]] = (fields[0] if e["kind"] == "dense"
                               else Q40Weight(*fields))
        return tree
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError) as e:
        print(f"device-layout cache unreadable ({type(e).__name__}: {e}); "
              f"rebuilding", file=sys.stderr)
        return None


def cache_enabled(device="cuda") -> bool:
    """DLLAMA_TILED_CACHE: '0' off, '1' on; unset, on for a CUDA device."""
    flag = os.environ.get("DLLAMA_TILED_CACHE", "")
    if flag in ("0", "1"):
        return flag == "1"
    return str(device).startswith("cuda")


def _fusion_tree(params: dict) -> dict:
    """The tree save_packed writes: each fusion of the device tree
    (ops/linear.FUSED_LOAD) as the list of its stacked Q40 parts, the
    other leaves as they are."""
    out, fused = {}, set()
    for dst, keys in FUSED_LOAD.items():
        ws = fusible(params, keys)
        if ws:
            out[dst] = ws
            fused.update(keys)
    out.update({k: v for k, v in params.items() if k not in fused})
    return out


def load_model_packed(path: str, weights_float_type=FloatType.F32,
                      buffer_float_type=FloatType.F32, device="cuda"):
    """io/loader.load_model with the sidecar shortcut (module docstring):
    a valid ``<model>.tkcache`` gives the tree with wqkv and w13 fused and
    every leaf a view of the file; otherwise the .bin is read, and the
    sidecar written for the next load. Either tree goes to the device
    through models/llama.params_to_device. Single-device loads only:
    a tp rank reads its bands (parallel/tp.load_model_bands)."""
    use_cache = (weights_float_type == FloatType.Q40
                 and cache_enabled(device))
    side = sidecar_path(path)
    if use_cache and os.path.exists(side):
        t0 = time.perf_counter()
        key = layout_key(path, weights_float_type, buffer_float_type)
        tree = load_packed(side, key)
        if tree is not None:
            spec = loader.read_spec(path, weights_float_type,
                                    buffer_float_type)
            print(f"⏩ device-layout cache hit ({side}): "
                  f"{time.perf_counter() - t0:.2f}s host prep (mmap, no "
                  f"Q40 split or fusion)", file=sys.stderr)
            return spec, tree
    t0 = time.perf_counter()
    spec, params = loader.load_model(path,
                                     weights_float_type=weights_float_type,
                                     buffer_float_type=buffer_float_type)
    if not use_cache:
        return spec, params
    print(f"Q40 split: {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    lock = try_build_lock(side)
    if lock is None:
        print(f"⏩ another process is writing {side}; skipping the "
              f"sidecar write (this load keeps its in-memory tree)",
              file=sys.stderr)
        return spec, params
    try:
        t0 = time.perf_counter()
        key = layout_key(path, weights_float_type, buffer_float_type)
        save_packed(side, key, _fusion_tree(params))
        print(f"⏩ device-layout cache written ({side}, "
              f"{os.path.getsize(side) / 1e9:.2f} GB, "
              f"{time.perf_counter() - t0:.2f}s); the next load skips the "
              f"Q40 split and the fusion", file=sys.stderr)
    except OSError as e:
        print(f"device-layout cache not written ({e}); loads keep "
              f"splitting", file=sys.stderr)
    finally:
        release_build_lock(lock)
    return spec, params
