"""Tensor-parallel forward over torch.distributed: one process a rank, three
collective schemes (the JAX package's parallel/tp.py, where one shard_map
program runs on every chip of a mesh).

``DLLAMA_TP_SCHEME`` (comm_stats.tp_scheme; default ``fused``) picks the
per-layer collectives:

**ref** — the reference's MatmulSlice: all 7 per-layer matmuls are cut
along their OUTPUT dim into contiguous row bands, one a rank, and 4
all_gathers a layer stitch the bands back (attention out, wo out, ffn hb,
w2 out), plus the logits gather.

**fused** — the Megatron pairing: q/k/v and w1/w3 stay output bands, but wo
and w2 are cut along their INPUT dim (on the Q40 block axis), so each block
ends in a row-parallel partial sum of full width, combined by ONE
all_reduce (f32 buffers) or a reduce_scatter in f32 followed by the packed
Q80 gather (Q80 buffers: partial sums never ride the wire quantized).

**overlap** — the fused layout, with each combine's reduce half split into
tp-1 ring hops (send/recv pairs, all in flight at once) summed in rank
order, and the ffn combine's gather issued asynchronously at the bottom of
a layer and waited for at the top of the next, so it overlaps the next
layer's qkv matmuls. An all_reduce sums in the backend's order, so overlap
equals fused within f32 rounding here, where the JAX package pins them bit
for bit (tests/test_torch_tp.py holds the logits within the f32 tolerance
and the greedy streams equal).

With Q80 buffers every gather moves the packed payload: int8 codes and f16
deltas, 34 bytes for 32 values, in one uint8 buffer, dequantized after the
gather (``_wire_gather``). x stays replicated: every rank computes the
norms itself. Attention is head-parallel over the rank's kv heads, the KV
cache holding only those (``local_spec``).

A rank's weights are its bands, cut on the host from the reference-layout
tree (``shard_params``) or read straight from the .bin (``load_model_bands``,
a memory-mapped slice: four 70B ranks never each hold the whole file), and
only then laid out for the device (models/llama.params_to_device). The
fused ``wqkv``/``w13`` of a rank are built from ITS bands, so its chunk is
[q|k|v] of its own heads; a fused tree must never be banded whole (rank 0
would get only q rows).

The forward is ``TPLlama``, models/llama.Llama over the local spec with the
layer tail, the deferred gather and the logits gather replaced: the JAX
make_local_step / make_sharded_forward (``forward``, T >= 1, so chunked
prefill runs K3 and K4 over bands), make_sharded_forward_batch
(``forward_batch``, K5 over local heads) and
make_sharded_forward_batch_paged (``forward_batch_paged``, K6/K7). Every
rank gathers the logits and samples the same coins; nothing else crosses.
The fused decode layer (K8-K10) is single-device only: the JAX package's
sharded forward never takes it, and neither does this one.

Requirements (``validate_sharding``): tp divides n_heads, n_kv_heads,
hidden_dim and vocab_size; overlap needs dim/tp whole; Q80 buffers need
dim/tp and hidden_dim/tp in 32-value blocks; Q40 wo/w2 under fused/overlap
need their block count to divide over tp.

Under sequence parallelism (a group with ``sp_size`` S > 1, parallel/mesh.
init_mesh) the rank's cache holds positions [s*C, (s+1)*C) of its kv heads,
C = seq_len / S, and attention is parallel/ring.py's: the new rows written
where they fall in the chunk, partials over the chunk, the LSE combine over
the sp sub-group (the JAX package's _local_layer and _batch_sp_attention).
Every Q40 product stays on the kernels. The paged, verify and mixed
programs refuse sp > 1 with the JAX package's messages (page tables break
contiguous sequence chunks), and so does the overlap scheme.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..io.loader import Q40_BLOCK, Q40Weight, q40_blocks_into, read_spec
from ..models.llama import (KERNELS, KVCache, Llama, PagedKVQ8, Route, _mm,
                            _maybe_q80, params_to_device)
from ..obs.profiler import span as phase
from ..models.spec import HEADER_BYTES, TransformerSpec
from ..ops.linear import rmsnorm, silu
from ..obs.spans import SCOPE_ATTN, SCOPE_FFN
from ..ops.quants import (QK, FloatType, dequantize_q80_torch,
                          quantize_q80_torch)
from . import collectives as C
from .comm_stats import tp_scheme
from .mesh import TPGroup
from .ring import (sp_batch_attention, sp_cache_attention, update_sp_cache,
                   update_sp_rows)

# the band each matmul weight takes: 'out' rows of its (d, n) matrix, or
# 'in' columns (the Q40 block axis); the rest is replicated
_MATMUL_SPECS = {"wq": "out", "wk": "out", "wv": "out", "wo": "out",
                 "w1": "out", "w2": "out", "w3": "out", "wcls": "out"}
_REPL_SPECS = {"tok_embedding": None, "rms_att": None, "rms_ffn": None,
               "rms_final": None}
# fused/overlap: wo and w2 row-parallel, cut along their input dim
_FUSED_OVERRIDES = {"wo": "in", "w2": "in"}
FUSED_INPUT_SHARDED = frozenset(_FUSED_OVERRIDES)
_INPUT_SHARDED_SCHEMES = ("fused", "overlap")


def param_specs(params: dict[str, Any],
                scheme: str | None = None) -> dict[str, str | None]:
    """name -> 'out' | 'in' | None (replicated) for the scheme. A fused
    ``wqkv``/``w13`` tree raises: banding it whole is wrong."""
    scheme = scheme or tp_scheme()
    specs = {}
    for name in params:
        if name not in _MATMUL_SPECS and name not in _REPL_SPECS:
            raise KeyError(f"unknown param {name} (fused wqkv/w13 trees are "
                           f"built per rank from its bands, never banded "
                           f"whole)")
        spec = _MATMUL_SPECS.get(name)
        if scheme in _INPUT_SHARDED_SCHEMES:
            spec = _FUSED_OVERRIDES.get(name, spec)
        specs[name] = spec
    return specs


def expected_shard_names(params: dict[str, Any], scheme: str | None = None):
    """The sharding contract as flat rows ``(leaf, {axis: ('tp',)})``, one
    a leaf of the stacked tree (a Q40 weight's ``.qs`` and ``.d16``) and of
    the (L, S, n_kv, hs) cache, the kv-head axis of which is banded."""
    rows = []
    for name, band in param_specs(params, scheme).items():
        val = params[name]
        leaves = ((f"{name}.qs", val.qs, 3), (f"{name}.d16", val.d16, 2)) \
            if isinstance(val, Q40Weight) else ((name, val, 2),)
        for leaf, arr, tail in leaves:
            ndim = len(np.shape(arr))
            axis = {"out": ndim - tail,
                    "in": ndim - tail + 1}.get(band)
            rows.append((leaf, {} if axis is None else {axis: ("tp",)}))
    rows += [("cache.k", {2: ("tp",)}), ("cache.v", {2: ("tp",)})]
    return rows


def validate_sharding(spec: TransformerSpec, n_slices: int,
                      scheme: str | None = None, n_sp: int = 1) -> None:
    """Check the spec divides over tp ranks (and its positions over sp)
    before any weight is read, with the JAX package's messages."""
    scheme = scheme or tp_scheme()
    for req, name in ((spec.n_heads, "n_heads"),
                      (spec.n_kv_heads, "n_kv_heads"),
                      (spec.hidden_dim, "hidden_dim"),
                      (spec.vocab_size, "vocab_size")):
        if req % n_slices != 0:
            raise ValueError(f"{name}={req} not divisible by tp={n_slices}")
    if spec.seq_len % n_sp != 0:
        raise ValueError(f"seq_len={spec.seq_len} not divisible by sp={n_sp}")
    if scheme == "overlap" and n_slices > 1:
        if n_sp > 1:
            raise ValueError(
                f"overlap tp scheme requires sp=1, got sp={n_sp} (the "
                f"ring-decomposed combines and the deferred ffn gather "
                f"assume un-chunked sequences; use --tp-scheme fused "
                f"with sp>1)")
        if spec.dim % n_slices:
            raise ValueError(
                f"overlap tp scheme ring-chunks the residual width: "
                f"dim={spec.dim} must divide by tp={n_slices}")
    if spec.buffer_float_type == FloatType.Q80:
        for req, name in ((spec.dim, "dim"), (spec.hidden_dim, "hidden_dim")):
            if (req // n_slices) % 32 != 0:
                raise ValueError(
                    f"Q80 buffer needs {name}/tp divisible by 32, got "
                    f"{req}/{n_slices}")
    if (scheme in _INPUT_SHARDED_SCHEMES and n_slices > 1
            and spec.weights_float_type == FloatType.Q40):
        for name, n_in in (("wo", spec.dim), ("w2", spec.hidden_dim)):
            _check_blocks(name, n_in // QK, n_slices, scheme)


def _check_blocks(name: str, nb: int, n_slices: int, scheme: str) -> None:
    if nb % n_slices:
        raise ValueError(
            f"{name}: {scheme} tp scheme shards the input dim, but {nb} Q40 "
            f"blocks do not divide over tp={n_slices} (need input_dim/tp "
            f"to be a 32-multiple)")


def validate_kv_quant(spec: TransformerSpec, n_slices: int,
                      kv_quant: str) -> None:
    """Q8 pages quantize each position's rank-local (n_kv/tp, hs) row in
    32-value blocks, which must not straddle a band edge."""
    if kv_quant not in ("f32", "q8"):
        raise ValueError(f"kv_quant={kv_quant!r}: expected f32|q8")
    if kv_quant == "q8":
        kv_loc = (spec.n_kv_heads // n_slices) * spec.head_size
        if kv_loc % QK:
            raise ValueError(
                f"q8 KV pages need the shard-local kv width to divide "
                f"into {QK}-value Q80 blocks: n_kv_heads/tp * head_size "
                f"= {spec.n_kv_heads}/{n_slices} * {spec.head_size} = "
                f"{kv_loc} is not a {QK}-multiple")


def _effective_scheme(scheme: str | None, n_slices: int) -> str:
    """The scheme a forward is built with: at tp=1 overlap has nothing to
    hide and builds the fused program."""
    scheme = scheme or tp_scheme()
    if scheme == "overlap" and n_slices == 1:
        return "fused"
    return scheme


def local_spec(spec: TransformerSpec, n_slices: int,
               n_sp: int = 1) -> TransformerSpec:
    """The rank's share of the model: dim/tp (its q width), n_heads/tp,
    n_kv_heads/tp, hidden_dim/tp, vocab/tp, and seq_len/sp (its cache
    chunk). Head size and kv_mul stay; the rank's KV cache and the layer's
    q/k/v split read it."""
    if n_slices == 1 and n_sp == 1:
        return spec
    return dataclasses.replace(
        spec, dim=spec.dim // n_slices, hidden_dim=spec.hidden_dim // n_slices,
        n_heads=spec.n_heads // n_slices,
        n_kv_heads=spec.n_kv_heads // n_slices,
        vocab_size=spec.vocab_size // n_slices,
        seq_len=spec.seq_len // n_sp)


# ---------------------------------------------------------------------------
# bands
# ---------------------------------------------------------------------------

def _slice(a, axis: int, rank: int, n_slices: int):
    w = a.shape[axis] // n_slices
    index = [slice(None)] * a.ndim
    index[axis] = slice(rank * w, (rank + 1) * w)
    return a[tuple(index)]


def _band(val, band: str | None, rank: int, n_slices: int):
    """The rank's band of one leaf (a fresh contiguous host array): rows
    ('out') or columns ('in', the block axis of a Q40 weight) of its
    trailing (d, n) matrix."""
    if isinstance(val, Q40Weight):
        if band is None:
            return Q40Weight(np.ascontiguousarray(val.qs),
                             np.ascontiguousarray(val.d16))
        axis = val.d16.ndim - (2 if band == "out" else 1)
        return Q40Weight(
            np.ascontiguousarray(_slice(val.qs, axis, rank, n_slices)),
            np.ascontiguousarray(_slice(val.d16, axis, rank, n_slices)))
    val = np.asarray(val)
    if band is None:
        return np.ascontiguousarray(val)
    axis = val.ndim - (2 if band == "out" else 1)
    return np.ascontiguousarray(_slice(val, axis, rank, n_slices))


def shard_params(params: dict[str, Any], rank: int, n_slices: int,
                 scheme: str | None = None) -> dict[str, Any]:
    """Rank ``rank``'s bands of a host (numpy) parameter tree under the
    scheme: output-row bands of wq/wk/wv/w1/w3/wcls (and wo/w2 under ref),
    input-block bands of wo/w2 under fused/overlap; the embedding and the
    norms whole. The JAX package's addressable shards of its shard_params,
    bit for bit."""
    scheme = _effective_scheme(scheme, n_slices)
    if scheme in _INPUT_SHARDED_SCHEMES and n_slices > 1:
        for name in FUSED_INPUT_SHARDED:
            v = params.get(name)
            if isinstance(v, Q40Weight):
                _check_blocks(name, v.qs.shape[-2], n_slices, scheme)
    specs = param_specs(params, scheme)
    return {name: _band(val, specs[name] if n_slices > 1 else None, rank,
                        n_slices)
            for name, val in params.items()}


def load_model_bands(path: str, rank: int, n_slices: int,
                     scheme: str | None = None,
                     weights_float_type=FloatType.F32,
                     buffer_float_type=FloatType.F32
                     ) -> tuple[TransformerSpec, dict[str, Any]]:
    """io/loader.load_model for one rank: the same stacked tree, each
    matmul weight cut to the rank's band while it is read from the
    memory-mapped file, so a rank copies only its bands (plus the
    replicated embedding and norms) into its own memory."""
    spec = read_spec(path, weights_float_type, buffer_float_type)
    scheme = _effective_scheme(scheme, n_slices)
    validate_sharding(spec, n_slices, scheme)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    if mm.nbytes != spec.file_size():
        raise ValueError(f"file size mismatch: {path} has {mm.nbytes} "
                         f"bytes, spec requires {spec.file_size()}")
    ft = spec.weights_float_type
    bands = param_specs({**dict(spec.layer_matmul_shapes()), "wcls": None},
                        scheme) if n_slices > 1 else {}
    off = HEADER_BYTES

    def take(nbytes: int) -> np.ndarray:
        nonlocal off
        chunk = mm[off:off + nbytes]
        off += nbytes
        return chunk

    def f32(shape) -> np.ndarray:
        return take(int(np.prod(shape)) * 4).view(np.float32).reshape(shape)

    def matrix(name: str, shape: tuple[int, int]):
        """The band of one (d, n) matrix, as a view of the file."""
        d, n = shape
        raw = take(spec.matmul_bytes(shape))
        if ft == FloatType.Q40:
            view = raw.view(Q40_BLOCK).reshape(d, n // QK)
        elif ft in (FloatType.F32, FloatType.F16):
            view = raw.view(np.float32 if ft == FloatType.F32
                            else np.float16).reshape(d, n)
        else:
            raise ValueError(f"unsupported weights float type {ft}")
        band = bands.get(name)
        if band is not None:
            view = _slice(view, 0 if band == "out" else 1, rank, n_slices)
        return view

    def alloc(view, lead=()):
        if ft == FloatType.Q40:
            d, nb = view.shape
            return Q40Weight(np.empty((*lead, d, nb, 16), np.uint8),
                             np.empty((*lead, d, nb), np.float16))
        return np.empty((*lead, *view.shape), view.dtype)

    def store(dst, view) -> None:
        if ft == FloatType.Q40:
            q40_blocks_into(view, dst)
        else:
            np.copyto(dst, view)

    def layer_of(w, layer: int):
        if isinstance(w, Q40Weight):
            return Q40Weight(w.qs[layer], w.d16[layer])
        return w[layer]

    L = spec.n_layers
    params: dict[str, Any] = {"tok_embedding": f32((spec.vocab_size,
                                                    spec.dim)).copy(),
                              "rms_att": np.empty((L, spec.dim), np.float32),
                              "rms_ffn": np.empty((L, spec.dim), np.float32)}
    for layer in range(L):
        params["rms_att"][layer] = f32((spec.dim,))
        params["rms_ffn"][layer] = f32((spec.dim,))
        for name, shape in spec.layer_matmul_shapes():
            view = matrix(name, shape)
            if layer == 0:
                params[name] = alloc(view, (L,))
            store(layer_of(params[name], layer), view)
    params["rms_final"] = f32((spec.dim,)).copy()
    take(spec.rope_gap_bytes)
    view = matrix("wcls", (spec.vocab_size, spec.dim))
    params["wcls"] = alloc(view)
    store(params["wcls"], view)
    if off != mm.nbytes:
        raise ValueError(f"missed {mm.nbytes - off} bytes")
    return spec, params


def shard_cache(cache: KVCache, rank: int, n_slices: int, sp_rank: int = 0,
                n_sp: int = 1) -> KVCache:
    """The rank's kv-head band of a full (..., n_kv, hs) cache (contiguous,
    batch and paged pools alike), and under sp its position chunk of a
    contiguous (..., S, n_kv, hs) one."""
    out = []
    for t in cache:
        t = _slice(t, t.dim() - 2, rank, n_slices)
        if n_sp > 1:
            t = _slice(t, t.dim() - 3, sp_rank, n_sp)
        out.append(t.contiguous())
    return KVCache(*out)


def shard_cache_paged(cache, rank: int, n_slices: int):
    """shard_cache for a paged pool; a Q8 pool's delta planes (..., nb)
    take their block band, the blocks of the rank's heads."""
    if isinstance(cache, PagedKVQ8):
        return PagedKVQ8(*(_slice(t, t.dim() - (2 if i % 2 == 0 else 1),
                                  rank, n_slices).contiguous()
                           for i, t in enumerate(cache)))
    return shard_cache(cache, rank, n_slices)


def stage_page_planes(planes, group, spec: TransformerSpec,
                      q8: bool = False) -> tuple:
    """The rank's band of one page payload (the JAX package's
    stage_page_planes, which device_puts a host payload under the pool's
    kv-head sharding): planes in the page wire layout of the FULL model
    ``spec``, (L, ps, n_kv, hs) k/v planes and (L, ps, kv_dim/32) Q8 delta
    planes on the aligned block bands, cut to this rank's kv heads. A
    payload already of the band's width (the rank's own demoted page)
    passes through: under a TPGroup each rank moves the pages of its own
    band, and every rank's allocator makes the same decisions in
    lockstep."""
    if group is None or group.size <= 1:
        return tuple(planes)
    out = []
    for i, p in enumerate(planes):
        delta = q8 and i % 2 == 1
        axis = p.ndim - (1 if delta else 2)
        full = spec.kv_dim // QK if delta else spec.n_kv_heads
        out.append(np.ascontiguousarray(
            _slice(p, axis, group.rank, group.size))
            if p.shape[axis] == full else p)
    return tuple(out)


def gather_page_planes(planes, group, q8: bool = False) -> tuple:
    """stage_page_planes' inverse: every rank's band of one page payload
    gathered across the tp ranks into the full model's wire layout (kv
    heads, or a Q8 pool's delta blocks, in rank order). Every rank calls
    it (a collective) and gets the whole payload; at tp 1 the planes pass
    through."""
    if group is None or group.size <= 1:
        return tuple(planes)
    out = []
    for i, p in enumerate(planes):
        dim = -1 if q8 and i % 2 == 1 else -2
        band = torch.from_numpy(np.ascontiguousarray(p)).to(group.device)
        out.append(C.gather(band, group, dim=dim).cpu().numpy())
    return tuple(out)


# ---------------------------------------------------------------------------
# the wire (a rank-local tensor at a Q80 cut point with no collective takes
# models/llama._maybe_q80, the JAX package's _wire)
# ---------------------------------------------------------------------------

def _wire_pack(spec: TransformerSpec, x: torch.Tensor) -> torch.Tensor:
    """Q80 buffers: x (..., n) packed into contiguous 34-byte blocks (32
    int8 codes, then the f16 delta), uint8 (..., n/32*34); f32: x."""
    if spec.buffer_float_type != FloatType.Q80:
        return x
    qs, d = quantize_q80_torch(x)
    blocks = torch.cat([qs.view(torch.uint8),
                        d.unsqueeze(-1).view(torch.uint8)], dim=-1)
    return blocks.reshape(*blocks.shape[:-2], blocks.shape[-2] * 34)


def _wire_unpack(spec: TransformerSpec, wire: torch.Tensor) -> torch.Tensor:
    """_wire_pack's inverse after any concatenation of packed bands."""
    if spec.buffer_float_type != FloatType.Q80:
        return wire
    nb = wire.shape[-1] // 34
    blocks = wire.reshape(*wire.shape[:-1], nb, 34)
    qs = blocks[..., :32].contiguous().view(torch.int8)
    d = blocks[..., 32:].contiguous().view(torch.float16)[..., 0]
    return dequantize_q80_torch(qs, d)


def _wire_gather(spec: TransformerSpec, x: torch.Tensor,
                 g: TPGroup) -> torch.Tensor:
    """A rank's band across the wire into the full vector: the packed Q80
    payload under Q80 buffers (one gather a cut), f32 otherwise."""
    return _wire_unpack(spec, C.gather(_wire_pack(spec, x), g))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _swiglu_local(lw: dict[str, Any], xb: torch.Tensor,
                  route: Route) -> torch.Tensor:
    """The rank's SwiGLU bands (w1/w3, or its fused w13): (T, hidden/tp)."""
    if "w13" in lw:
        h13 = _mm(lw["w13"], xb, route)
        hid = h13.shape[-1] // 2
        return silu(h13[..., :hid]) * h13[..., hid:]
    return silu(_mm(lw["w1"], xb, route)) * _mm(lw["w3"], xb, route)


class TPLlama(Llama):
    """One rank's forward: Llama over ``local_spec`` (its q/k/v bands, its
    kv heads, its cache) with the scheme's layer tail, the overlap
    scheme's deferred gather and the logits gather. ``params`` is the
    rank's device tree (make_sharded_forward builds it). Methods and
    caches are Llama's: forward (T >= 1), forward_batch(_ragged),
    forward_batch_paged; logits come back whole (T, vocab) on every
    rank."""

    def __init__(self, spec: TransformerSpec, params: dict[str, Any],
                 group: TPGroup, scheme: str | None = None,
                 route: Route = KERNELS):
        self.full_spec = spec
        self.group = group
        self.scheme = _effective_scheme(scheme, group.size)
        validate_sharding(spec, group.size, self.scheme, group.sp_size)
        super().__init__(local_spec(spec, group.size, group.sp_size), params,
                         route, "off")
        self._pending: C.Pending | None = None
        # forwards run and those that gathered logits: a forward's
        # collectives are its budget's, less the logits gather when a
        # prefill skips the logits (serve's /health reads these)
        self.forwards = self.logit_forwards = 0
        self.max_pos = spec.seq_len
        if group.sp_size > 1:
            self._attend = self._sp_attend
            self._batch_attend = self._sp_batch_attend

    # -- the sp-sharded cache (parallel/ring.py) -----------------------------

    def _sp_ops(self):
        g = self.group
        return (lambda t: C.sp_pmax(t, g)), (lambda t: C.sp_psum(t, g))

    def _sp_attend(self, cache: KVCache, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, idx: int, pos: int) -> torch.Tensor:
        """T tokens at host position pos: the rows that fall in this rank's
        chunk written in place, then the combined attention (T, n_q*hs)."""
        spec, g = self.spec, self.group
        t_len, hs = q.shape[0], spec.head_size
        chunk = spec.seq_len
        for plane, new in ((cache.k, k), (cache.v, v)):
            update_sp_cache(plane[idx], new.reshape(t_len, -1, hs).to(
                plane.dtype), pos, g.sp_rank, chunk)
        return sp_cache_attention(
            hs, spec.kv_mul, chunk, g.sp_rank,
            q.reshape(t_len, spec.n_heads, hs), cache.k[idx], cache.v[idx],
            pos, *self._sp_ops())

    def _sp_batch_attend(self, k4: torch.Tensor, v4: torch.Tensor,
                         q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rows: torch.Tensor, cols: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
        """One token a row at device clocks pos (B,): each row's k/v
        written where it falls in this rank's chunk, then the combined
        attention (B, n_q*hs). Reads nothing on the host."""
        spec, g = self.spec, self.group
        batch, hs = q.shape[0], spec.head_size
        chunk = spec.seq_len
        for plane, new in ((k4, k), (v4, v)):
            update_sp_rows(rows, cols, plane, new.reshape(batch, -1, hs),
                           g.sp_rank, chunk)
        return sp_batch_attention(
            hs, spec.kv_mul, chunk, g.sp_rank,
            q.reshape(batch, spec.n_heads, hs), k4[rows], v4[rows], pos,
            *self._sp_ops())

    def _refuse_sp(self, what: str) -> None:
        if self.group.sp_size > 1:
            raise ValueError(f"{what} requires sp=1, got "
                             f"sp={self.group.sp_size} (page tables break "
                             f"contiguous sequence chunks)")

    def forward_batch_paged(self, *args, **kw):
        self._refuse_sp("paged KV cache")
        return super().forward_batch_paged(*args, **kw)

    def forward_batch_spec_paged(self, *args, **kw):
        self._refuse_sp("speculative verify")
        return super().forward_batch_spec_paged(*args, **kw)

    def forward_batch_mixed_paged(self, *args, **kw):
        self._refuse_sp("mixed dispatch")
        return super().forward_batch_mixed_paged(*args, **kw)

    def _enter(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        """Overlap: the previous layer's ffn combine lands here (its gather
        waited for, the residual added); layer 0 takes x as it is."""
        if idx == 0:
            self.forwards += 1
        if self._pending is None:
            return x
        pending, self._pending = self._pending, None
        with phase(SCOPE_FFN):  # the previous layer's ffn combine
            return x + _wire_unpack(self.full_spec, pending.wait())

    def _combine(self, part: torch.Tensor) -> torch.Tensor:
        """fused: the block's row-parallel partials summed across ranks
        (f32: one all_reduce; Q80: reduce_scatter, then the packed
        gather)."""
        spec, g = self.full_spec, self.group
        if spec.buffer_float_type == FloatType.Q80:
            return _wire_gather(spec, C.scatter(part, g), g)
        return C.psum(part, g)

    def _post(self, lw: dict[str, Any], x: torch.Tensor, ao: torch.Tensor,
              route: Route) -> torch.Tensor:
        spec, g = self.full_spec, self.group
        if g.size == 1:
            return super()._post(lw, x, ao, route)
        if self.scheme == "ref":
            with phase(SCOPE_ATTN):
                xb = _wire_gather(spec, ao, g)             # (T, dim)
                x = x + _wire_gather(spec, _mm(lw["wo"], xb, route), g)
            with phase(SCOPE_FFN):
                xb = _maybe_q80(spec, rmsnorm(x, lw["rms_ffn"]))
                hb = _wire_gather(spec, _swiglu_local(lw, xb, route), g)
                return x + _wire_gather(spec, _mm(lw["w2"], hb, route), g)
        with phase(SCOPE_ATTN):
            part = _mm(lw["wo"], _maybe_q80(spec, ao), route)  # partials
            if self.scheme == "fused":
                x = x + self._combine(part)
            else:  # overlap: ring reduce, gather consumed in-layer
                x = x + _wire_gather(spec, C.ring_reduce(part, g), g)
        with phase(SCOPE_FFN):
            xb = _maybe_q80(spec, rmsnorm(x, lw["rms_ffn"]))
            hb = _maybe_q80(spec, _swiglu_local(lw, xb, route))
            part = _mm(lw["w2"], hb, route)
            if self.scheme == "fused":
                return x + self._combine(part)
            # overlap: the gather is issued here and consumed by the next
            # layer's _enter (or the logits)
            band = C.ring_reduce(part, g)
            self._pending = C.Pending(_wire_pack(spec, band), g)
            return x

    def _logits(self, x: torch.Tensor, route: Route) -> torch.Tensor:
        """The rank's vocab band, gathered: (T, vocab) on every rank."""
        self.logit_forwards += 1
        band = super()._logits(x, route)
        if self.group.size == 1:
            return band
        return C.gather(band, self.group)


def make_sharded_forward(spec: TransformerSpec, params: dict[str, Any],
                         group: TPGroup, scheme: str | None = None,
                         route: Route = KERNELS) -> TPLlama:
    """The rank's forward module: ``params`` is the rank's host tree of
    bands (shard_params or load_model_bands cut it), moved onto
    ``group.device``."""
    scheme = _effective_scheme(scheme, group.size)
    validate_sharding(spec, group.size, scheme, group.sp_size)
    wq = params["wq"]
    rows = wq.qs.shape[-3] if isinstance(wq, Q40Weight) else wq.shape[-2]
    if group.size > 1 and rows != spec.dim // group.size:
        raise ValueError(f"wq has {rows} rows, a band of tp {group.size} "
                         f"has {spec.dim // group.size}: pass the rank's "
                         f"bands (shard_params), not the whole tree")
    return TPLlama(spec, params_to_device(params, group.device), group,
                   scheme, route)
