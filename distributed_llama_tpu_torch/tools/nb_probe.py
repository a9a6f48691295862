"""B10, the Q40 layout probe: how fast the T = 1 matvec bodies stream K1's
weight layout on this card, each variant timed from a profiler trace of a
chain of dependent calls.

The port's twin of the JAX package's tools/nb_probe.py. Its variants, in
K1's layout (qs uint8 (L, d, nb, 16), d16 f16 (L, d, nb): 18 bytes per 32
values), with the kernels of csrc/nb_probe.cu:

  dma    — P1 probe_stream: every code and scale byte read once, XOR-folded,
           nothing unpacked, x unread: the stream ceiling of P0's pattern.
  v0     — P0 probe_classic: the classic T = 1 body (K1's before its
           tensor-core redesign; the row body the fused decode-layer
           kernels share), the JAX probe's production body.
  v1     — P3 probe_nomask: the whole byte widened, no low-nibble mask;
           xhi16 = xhi - 16 * xlo and the block sums of x made by torch once
           per call.
  v0_128 — P0 again: the JAX probe's 128-row tile is a constraint of the
           TPU's compiler with no counterpart here (its line says so).
  v0r    — P2 probe_xglobal: K1's tensor-core skeleton at K1's plan with
           x pre-laid: split into its three bf16 pieces and permuted into
           K1's B-fragment order by torch once per call (lay_x), read by
           the kernel from global memory; no staging of x in shared memory.
  i4     — P4 probe_signed: K1's skeleton at K1's plan over codes stored
           as signed nibbles (byte ^ 0x88, made once per chain outside the
           timed window), widened to K1's bf16 operands.
  k1     — K1 itself (ops/q40.KERNEL), the port's production T = 1 body
           (tensor-core products, split K), read beside the others; the
           v0r and i4 lines give their time against K1's of the same run
           (P2 and P4 return K1's bits).

Method, as the JAX probe's: weights are made on the device from a seeded
torch.Generator; layer 0 of each variant is held against a float64 numpy
reference (``|got - want| / (|want| + 1)`` under 5e-3, 2e-2 for v1; dma
against its exact integer reference) before any timing; then ``--layers x
--reps`` dependent calls run with ``x += 1e-30 * out.sum()`` between them,
once to warm up and once under obs.profiler.trace. The per-call time is
the traced device time of the variant's kernel, found by base name through
utils.it_split.parse_trace, over its event count, which must equal the
call count, or the variant fails (obs/profiler.trace opens its window
ahead of the chain, so a session whose kernel timestamps the profiler
shifts still holds every kernel). Printed beside it: GB/s, the bound
(18 * d * nb bytes at the published 3.35 TB/s of the H100 SXM) and the
share of it reached, and the chain's CUDA-event time per call (kernel and
torch glue). A header gives the card's name and power limit.

On the card (from the repository root):

    python3 -m distributed_llama_tpu_torch.tools.nb_probe [--shape
        w13|wqkv|wo|tiny] [--layers 8] [--reps 4]
        [--variants dma,v0,v1,v0_128,v0r,i4,k1] [--device cuda|cpu]

``--device cpu`` runs the plain versions through the parity gate and the
chain and prints no time, rate or share ("not measured (cpu)"). Without a
card and without ``--device cpu`` it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..io.loader import Q40Weight
from ..obs import profiler
from ..ops import q40
from ..ops._build import BUILD_DIR, CudaKernel, build
from ..ops.quants import QK
from ..utils import it_split

# 13B leaf shapes (d = output rows, n = input width)
SHAPES = {"w13": (27648, 5120), "wqkv": (15360, 5120), "wo": (5120, 5120),
          "tiny": (256, 256)}  # CPU smoke
VARIANTS = ("dma", "v0", "v1", "v0_128", "v0r", "i4", "k1")
NJ = 16           # code bytes per 32-value block
BLOCK_PAD = 36    # floats per staged block of x (csrc/q40_row.cuh kBlockPad)
BYTES_PER_S = 3.35e12  # published HBM rate of the H100 SXM
TRACE_DIR = BUILD_DIR.parent / "nb_probe"

_P, _I = ctypes.c_void_p, ctypes.c_int
CLASSIC = CudaKernel("nb_probe.cu", "probe_classic",
                     [_P] * 4 + [_I] * 2 + [_P])
STREAM = CudaKernel("nb_probe.cu", "probe_stream", [_P] * 3 + [_I] * 2 + [_P])
# P2 and P4 take K1's arguments (ops/q40.KERNEL) and run at its plan
XGLOBAL = CudaKernel("nb_probe.cu", "probe_xglobal",
                     [_P] * 6 + [_I] * 7 + [_P])
NOMASK = CudaKernel("nb_probe.cu", "probe_nomask", [_P] * 4 + [_I] * 2 + [_P])
SIGNED = CudaKernel("nb_probe.cu", "probe_signed", [_P] * 6 + [_I] * 7 + [_P])
KERNELS = (CLASSIC, STREAM, XGLOBAL, NOMASK, SIGNED)
# the kernel each variant launches, and the name its trace events carry
RUNS = {"dma": STREAM, "v0": CLASSIC, "v1": NOMASK, "v0_128": CLASSIC,
        "v0r": XGLOBAL, "i4": SIGNED, "k1": q40.KERNEL}
TRACE_NAMES = {CLASSIC: "probe_classic_kernel",
               STREAM: "probe_stream_kernel", XGLOBAL: "probe_xglobal_kernel",
               NOMASK: "probe_nomask_kernel", SIGNED: "probe_signed_kernel",
               q40.KERNEL: "q40_matvec_kernel"}

# |kernel - plain| <= RTOL * max|plain|: both f32, summed in another order;
# P3 multiplies raw codes up to 255 (not 15), so its sums cancel more
KERNEL_RTOL = 1e-4
KERNEL_RTOL_NOMASK = 1e-3
# the JAX probe's parity gate against float64 (rel-ish norm)
PARITY_TOL = {"v1": 2e-2}
PARITY_TOL_DEFAULT = 5e-3


# ------------------------------------------------------------- layouts

def from_nb_major(qs_t, scale) -> Q40Weight:
    """The JAX probe's nb-major tree — codes (L, NJ, nb, d) uint8, scales
    (L, nb, d) f32 — in K1's layout: qs (L, d, nb, 16) uint8, d16 (L, d,
    nb) f16, as CPU tensors. Raises ValueError if a scale is not exactly an
    f16 value (K1 stores f16 scales)."""
    qs_t = np.asarray(qs_t, dtype=np.uint8)
    scale = np.asarray(scale, dtype=np.float32)
    d16 = scale.astype(np.float16)
    if not np.array_equal(d16.astype(np.float32), scale):
        raise ValueError("from_nb_major: scales must be exact f16 values")
    qs = np.ascontiguousarray(np.transpose(qs_t, (0, 3, 2, 1)))
    return Q40Weight(torch.from_numpy(qs),
                     torch.from_numpy(np.ascontiguousarray(
                         np.transpose(d16, (0, 2, 1)))))


def to_signed(qs):
    """Codes as signed nibbles, code - 8 in 4-bit two's complement: the
    same bytes XOR 0x88 (P4's layout). Works on numpy and torch."""
    return qs ^ 0x88


def layer(w: Q40Weight, i: int) -> Q40Weight:
    return Q40Weight(w.qs[i], w.d16[i])


# ------------------------------------------------------ plain versions

def probe_stream_plain(w: Q40Weight) -> torch.Tensor:
    """P1's function: out[r] = sum_b f32(d16[r,b]) * f32(XOR_j qs[r,b,j])."""
    acc = w.qs[..., 0]
    for j in range(1, NJ):
        acc = acc ^ w.qs[..., j]
    return (acc.to(torch.float32) * w.d16.to(torch.float32)).sum(-1)


def probe_xglobal_plain(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """P2's function: K1's (and P0's)."""
    return q40.q40_matmul_plain(w, x.reshape(1, -1)).reshape(-1)


def lay_x(x: torch.Tensor) -> torch.Tensor:
    """x (n,) f32 -> P2's x, (nb, 3, 4, 8) bf16 (nb * 192 bytes): x's three
    exact bf16 pieces (ops/q40.bf16_split3) in the B-fragment order K1
    stages in shared memory (csrc/q40_matvec.cuh, T = 1): 16-byte chunk
    (b * 3 + p) * 4 + c holds piece p of values 4c..4c+3, then
    16+4c..16+4c+3, of block b."""
    pieces = torch.stack(q40.bf16_split3(x.reshape(-1, 2, 4, 4)))
    # (p, b, half, c, e) -> (b, p, c, half, e); each piece is a bf16 value
    laid = pieces.permute(1, 0, 3, 2, 4).to(torch.bfloat16).contiguous()
    return laid.reshape(-1, 3, 4, 8)


def unlay_x(xlaid: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """lay_x's inverse: the three pieces, each (nb, 32) f32."""
    nb = xlaid.shape[0]
    pieces = xlaid.to(torch.float32).reshape(nb, 3, 4, 2, 4).permute(
        1, 0, 3, 2, 4)
    return tuple(p.reshape(nb, QK).contiguous() for p in pieces)


def probe_xglobal_split_model(w: Q40Weight,
                              xlaid: torch.Tensor) -> torch.Tensor:
    """P2's arithmetic in plain torch: ops/q40.q40_matmul_split_model's
    sums over the pieces read back from lay_x's buffer: (d,) f32."""
    codes = torch.cat([w.qs & 0xF, w.qs >> 4], -1).to(torch.float32) - 8.0
    pieces = tuple(p[None] for p in unlay_x(xlaid))
    return q40.split_sums(codes, w.d16, pieces).reshape(-1)


def prep_nomask(x: torch.Tensor) -> torch.Tensor:
    """x (n,) -> (nb, BLOCK_PAD): per block xlo (16), xhi16 = xhi - 16 *
    xlo (16), xsum = the block's sum, then 3 zeros (P3's x)."""
    x3 = x.reshape(-1, QK)
    xlo, xhi = x3[:, :NJ], x3[:, NJ:]
    return torch.cat([xlo, xhi - 16.0 * xlo, x3.sum(1, keepdim=True),
                      x3.new_zeros((x3.shape[0], BLOCK_PAD - QK - 1))],
                     1).contiguous()


def probe_nomask_plain(w: Q40Weight, xprep: torch.Tensor) -> torch.Tensor:
    """P3's function over prep_nomask's x: per block sum_j q_j * xlo_j +
    (q_j >> 4) * xhi16_j - 8 * xsum, q the whole byte."""
    q = w.qs.to(torch.float32)
    hi = (w.qs >> 4).to(torch.float32)
    s = ((q * xprep[:, :NJ]).sum(-1) + (hi * xprep[:, NJ:QK]).sum(-1)
         - 8.0 * xprep[:, QK])
    return (s * w.d16.to(torch.float32)).sum(-1)


def _signed_nibbles(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int16)
    return v - 16 * (v >= 8).to(torch.int16)


def widen_signed(qs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P4's widening of signed codes (to_signed) as csrc/nb_probe.cu
    SignedCodes does it, bit for bit: each nibble s masked and XORed with
    8 (c = s ^ 8, one LOP3), put in the mantissa of bf16 128 (0x4300 | c =
    128 + c), 136 taken away: (lo, hi) f32, code - 8 of the low and the
    high nibbles."""
    def widen(nib):
        c = ((nib & 0xF) ^ 0x8).to(torch.int16) | 0x4300
        return c.view(torch.bfloat16).to(torch.float32) - 136.0
    return widen(qs), widen(qs >> 4)


def probe_signed_split_model(ws: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """P4's arithmetic in plain torch over signed codes: the codes widened
    by widen_signed, x in its three bf16 pieces, ops/q40.split_sums: (d,)
    f32."""
    codes = torch.cat(widen_signed(ws.qs), -1)
    xt = x.to(torch.float32).reshape(1, -1, QK)
    return q40.split_sums(codes, ws.d16, q40.bf16_split3(xt)).reshape(-1)


def probe_signed_plain(ws: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """P4's function over signed codes (to_signed): sum of the
    sign-extended nibbles times x, times the block scale."""
    codes = torch.cat([_signed_nibbles(ws.qs & 0xF),
                       _signed_nibbles(ws.qs >> 4)], -1).to(torch.float32)
    wf = codes * ws.d16.to(torch.float32).unsqueeze(-1)
    return F.linear(x.reshape(1, -1), wf.reshape(wf.shape[0], -1)).reshape(-1)


# ------------------------------------------------------------ wrappers

def _check(name: str, w: Q40Weight, *vecs: tuple[torch.Tensor, int],
           staged: bool = False) -> tuple[int, int]:
    """The checks of ops/q40._check for one 2-D weight, plus each (vector,
    expected numel): f32, contiguous, on the weight's device, 16-byte
    aligned."""
    qs, d16 = w.qs, w.d16
    if qs.dim() != 3 or qs.shape[-1] != NJ or qs.dtype != torch.uint8:
        raise ValueError(f"{name}: qs must be uint8 (d, nb, 16), got "
                         f"{qs.dtype} {tuple(qs.shape)}")
    d, nb = qs.shape[0], qs.shape[1]
    if d16.dtype != torch.float16 or tuple(d16.shape) != (d, nb):
        raise ValueError(f"{name}: d16 must be float16 ({d}, {nb})")
    if staged and nb * BLOCK_PAD * 4 > q40._SMEM_LIMIT:
        raise ValueError(f"{name}: input width {nb * QK} exceeds the "
                         f"shared-memory staging of x")
    for t in (qs, d16, *(v for v, _ in vecs)):
        if t.device != qs.device or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous on "
                             f"{qs.device}")
    if qs.data_ptr() % 16:
        raise ValueError(f"{name}: qs must be 16-byte aligned")
    for t, numel in vecs:
        if t.dtype != torch.float32 or t.numel() != numel \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: x must be 16-byte aligned float32 "
                             f"of {numel} values, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return d, nb


def _on_cpu(w: Q40Weight) -> bool:
    if w.qs.device.type == "cpu":
        return True
    if w.qs.device.type != "cuda":
        raise ValueError(f"nb_probe: no kernel for device {w.qs.device}")
    return False


def _launch(kernel: CudaKernel, w: Q40Weight, xs: list[torch.Tensor],
            d: int, nb: int) -> torch.Tensor:
    out = torch.empty(d, dtype=torch.float32, device=w.qs.device)
    stream = torch.cuda.current_stream(w.qs.device).cuda_stream
    kernel.launch(w.qs.data_ptr(), w.d16.data_ptr(),
                  *(x.data_ptr() for x in xs), out.data_ptr(), d, nb, stream)
    return out


def probe_classic(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """P0 on a CUDA weight (K1's function, the plain version on a CPU
    one): x (n,) -> (d,) f32; the fused tail (K9) gives its bits on the
    same rows."""
    if _on_cpu(w):
        return probe_xglobal_plain(w, x)
    nb = w.qs.shape[-2]
    d, nb = _check("probe_classic", w, (x, nb * QK), staged=True)
    return _launch(CLASSIC, w, [x], d, nb)


def probe_stream(w: Q40Weight) -> torch.Tensor:
    """P1 on a CUDA weight (the plain version on a CPU one): (d,) f32."""
    if _on_cpu(w):
        return probe_stream_plain(w)
    d, nb = _check("probe_stream", w)
    return _launch(STREAM, w, [], d, nb)


def _launch_k1_plan(kernel: CudaKernel, w: Q40Weight, x: torch.Tensor,
                    d: int, nb: int) -> torch.Tensor:
    """P2 or P4: one launch at K1's plan, split-K scratch and tickets
    (ops/q40._matvec)."""
    out = torch.empty(d, dtype=torch.float32, device=w.qs.device)
    stream = torch.cuda.current_stream(w.qs.device).cuda_stream
    q40._matvec(w, x, out, 1, d, nb, stream, 3, kernel)
    return out


def probe_xglobal(w: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """P2: K1's function and bits, x laid out here once per call (lay_x)
    and read by the kernel from global memory."""
    if _on_cpu(w):
        return probe_xglobal_plain(w, x)
    _check("probe_xglobal", w, (x, w.qs.shape[-2] * QK))
    return probe_xglobal_laid(w, lay_x(x))


def probe_xglobal_laid(w: Q40Weight, xlaid: torch.Tensor) -> torch.Tensor:
    """P2 on x already laid out (lay_x): the kernel alone, as the probe's
    phase times it (on the CPU, its split model)."""
    if _on_cpu(w):
        return probe_xglobal_split_model(w, xlaid)
    d, nb = _check("probe_xglobal", w)
    if (xlaid.dtype != torch.bfloat16 or tuple(xlaid.shape) != (nb, 3, 4, 8)
            or not xlaid.is_contiguous() or xlaid.device != w.qs.device
            or xlaid.data_ptr() % 16):
        raise ValueError(f"probe_xglobal: x must be lay_x's contiguous, "
                         f"16-byte aligned bf16 ({nb}, 3, 4, 8) on "
                         f"{w.qs.device}")
    return _launch_k1_plan(XGLOBAL, w, xlaid, d, nb)


def probe_nomask(w: Q40Weight, xprep: torch.Tensor) -> torch.Tensor:
    """P3 over prep_nomask(x)."""
    if _on_cpu(w):
        return probe_nomask_plain(w, xprep)
    nb = w.qs.shape[-2]
    d, nb = _check("probe_nomask", w, (xprep, nb * BLOCK_PAD), staged=True)
    return _launch(NOMASK, w, [xprep], d, nb)


def probe_signed(ws: Q40Weight, x: torch.Tensor) -> torch.Tensor:
    """P4 over signed codes (to_signed): K1's function, and its bits on the
    codes before to_signed."""
    if _on_cpu(ws):
        return probe_signed_plain(ws, x)
    d, nb = _check("probe_signed", ws, (x, ws.qs.shape[-2] * QK))
    return _launch_k1_plan(SIGNED, ws, x, d, nb)


# ------------------------------------------------------------- harness

def synth(layers: int, d: int, n: int, device, seed: int = 0) -> Q40Weight:
    """Stacked random weights in K1's layout, made on ``device``: uniform
    codes, f16 scales in the JAX probe's [0.005, 0.02)."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb = n // QK
    qs = torch.randint(0, 256, (layers, d, nb, NJ), dtype=torch.uint8,
                       device=device, generator=g)
    d16 = (torch.rand((layers, d, nb), device=device, generator=g) * 0.015
           + 0.005).to(torch.float16)
    return Q40Weight(qs, d16)


def ref_matvec(qs: np.ndarray, d16: np.ndarray, x: np.ndarray) -> np.ndarray:
    """float64 reference of one layer in K1's layout (the JAX probe's
    _ref_matvec)."""
    lo = (qs & 0xF).astype(np.float64) - 8          # (d, nb, 16)
    hi = (qs >> 4).astype(np.float64) - 8
    x3 = x.astype(np.float64).reshape(-1, QK)       # (nb, 32)
    acc = (lo * x3[:, :NJ]).sum(-1) + (hi * x3[:, NJ:]).sum(-1)
    return (acc * d16.astype(np.float64)).sum(-1)


def ref_stream(qs: np.ndarray, d16: np.ndarray) -> np.ndarray:
    """P1's exact reference: the XOR fold as an integer, times the scale,
    summed in float64."""
    fold = np.bitwise_xor.reduce(qs, axis=-1).astype(np.float64)
    return (fold * d16.astype(np.float64)).sum(-1)


def _caller(name: str, w: Q40Weight):
    """call(i, x) -> the (d,) output of variant ``name`` on layer i."""
    if name == "dma":
        return lambda i, x: probe_stream(layer(w, i))
    if name in ("v0", "v0_128"):
        return lambda i, x: probe_classic(layer(w, i), x)
    if name == "k1":
        return lambda i, x: q40.q40_matmul(layer(w, i),
                                           x.reshape(1, -1)).reshape(-1)
    if name == "v0r":
        return lambda i, x: probe_xglobal(layer(w, i), x)
    if name == "v1":
        return lambda i, x: probe_nomask(layer(w, i), prep_nomask(x))
    if name == "i4":
        ws = Q40Weight(to_signed(w.qs), w.d16)  # hoisted out of the chain
        return lambda i, x: probe_signed(layer(ws, i), x)
    raise ValueError(f"unknown variant {name!r}; expected one of {VARIANTS}")


def parity(name: str, w: Q40Weight, x: torch.Tensor, call) -> float:
    """Layer 0 of ``name`` against its float64 reference; raises
    AssertionError above the JAX probe's tolerance, else returns the
    error."""
    got = call(0, x).double().cpu().numpy()
    qs, d16 = w.qs[0].cpu().numpy(), w.d16[0].cpu().numpy()
    want = (ref_stream(qs, d16) if name == "dma"
            else ref_matvec(qs, d16, x.cpu().numpy()))
    err = float(np.max(np.abs(got - want) / (np.abs(want) + 1.0)))
    tol = PARITY_TOL.get(name, PARITY_TOL_DEFAULT)
    if not err < tol:
        raise AssertionError(f"{name} parity {err:.3e} above {tol}")
    return err


def chain(call, x: torch.Tensor, layers: int, reps: int) -> torch.Tensor:
    """layers x reps dependent calls: each output feeds 1e-30 x its sum
    back into x, so no call can be skipped or reordered."""
    x = x.clone()
    for i in range(layers * reps):
        x.add_(call(i % layers, x).sum() * 1e-30)
    return x


def run_variant(name: str, shape: str, w: Q40Weight, x: torch.Tensor,
                reps: int, trace_dir: Path = TRACE_DIR) -> dict:
    """Gate, warm and (on the card) trace one variant over the stacked
    weights ``w``; returns its measurements (None where not measured)."""
    layers, d, nb = w.qs.shape[:3]
    call = _caller(name, w)
    err = parity(name, w, x, call)
    calls = layers * reps
    chain(call, x, layers, reps)  # warm-up
    res = dict(variant=name, shape=shape, d=d, n=nb * QK, calls=calls,
               parity_err=err, kernel=RUNS[name].symbol,
               bytes_per_call=18 * d * nb,
               bound_ms=18 * d * nb / BYTES_PER_S * 1e3,
               events=None, ms=None, gbps=None, share=None,
               event_ms=None)
    if w.qs.device.type != "cuda":
        return res
    base = TRACE_NAMES[RUNS[name]]
    where = trace_dir / name
    shutil.rmtree(where, ignore_errors=True)
    torch.cuda.synchronize()  # the warm-up ends before the trace starts
    with profiler.trace(str(where), cuda=True):
        chain(call, x, layers, reps)
    splits = it_split.parse_trace(str(where))
    events = sum(s.counts[base] for s in splits.values())
    ns = sum(s.ops[base] for s in splits.values())
    if events != calls:
        raise AssertionError(f"{name}: the trace holds {events} "
                             f"{base} events, want {calls}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chain(call, x, layers, reps)
    end.record()
    end.synchronize()
    ms = ns / 1e6 / events
    res.update(events=events, ms=ms,
               gbps=res["bytes_per_call"] / (ms * 1e6),
               share=res["bound_ms"] / ms,
               event_ms=start.elapsed_time(end) / calls)
    return res


# the variants built on K1's skeleton, and what each changes in it
K1_SKELETON = {"v0r": "x pre-laid", "i4": "signed codes"}


def describe(r: dict, k1: dict | None = None) -> str:
    """One variant's line; a variant on K1's skeleton is read against
    ``k1``, K1's result from the same run, where it was timed."""
    head = (f"{r['shape']:5s} {r['variant']:6s} {r['kernel']:14s} parity "
            f"{r['parity_err']:.2e}, {r['calls']} chained calls")
    note = {"v0_128": " (P0: the 128-row tile has no GPU meaning)",
            "k1": " (K1, the production body)"}.get(r["variant"], "")
    if r["variant"] in K1_SKELETON:
        vs_k1 = ""
        if r["ms"] is not None and k1 is not None and k1["ms"] is not None:
            vs_k1 = (f"; K1 {k1['ms']:.4f} ms/call in this run, "
                     f"{r['ms'] / k1['ms']:.3f}x it")
        note = f" (K1 skeleton: {K1_SKELETON[r['variant']]}{vs_k1})"
    if r["ms"] is None:
        return f"{head}: time, rate and share not measured (cpu){note}"
    return (f"{head}: {r['ms']:.4f} ms/call (trace, {r['events']} events) "
            f"{r['gbps']:.1f} GB/s, bound {r['bound_ms']:.4f} ms, "
            f"{r['share']:.1%} of it; CUDA events {r['event_ms']:.4f} "
            f"ms/call (kernel and torch glue){note}")


def card_header() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="nb_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="w13", choices=sorted(SHAPES))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    bad = [v for v in names if v not in VARIANTS]
    if bad:
        ap.error(f"unknown variants {bad}; expected some of {VARIANTS}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("nb_probe: no GPU (torch.cuda.is_available() is False) — "
                  "pass --device cpu to run the plain versions",
                  file=sys.stderr)
            return 1
        build([*KERNELS, q40.KERNEL])
        print(f"card: {card_header()}; bound at {BYTES_PER_S / 1e12:.2f} "
              f"TB/s (published, H100 SXM)")
    d, n = SHAPES[args.shape]
    w = synth(args.layers, d, n, args.device)
    x = torch.randn((n,), device=args.device,
                    generator=torch.Generator(args.device).manual_seed(1))
    results = {}
    for name in sorted(names, key=lambda v: v != "k1"):  # K1 first
        try:
            results[name] = run_variant(name, args.shape, w, x, args.reps)
        except Exception as e:  # noqa: BLE001 - variants fail independently
            results[name] = e
    k1 = results.get("k1")
    k1 = None if isinstance(k1, Exception) else k1
    failed = 0
    for name in names:
        r = results[name]
        if isinstance(r, Exception):
            failed += 1
            print(f"{args.shape} {name}: FAILED ({type(r).__name__}: {r})",
                  flush=True)
        else:
            print(describe(r, k1), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
