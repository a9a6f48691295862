#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (distributed_llama_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. Card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   build of every kernel from ``distributed_llama_tpu_torch/csrc``.
2. Kernels against their plain versions on the card at the Llama-2-7B
   shapes: the Q40 matvec on wqkv/wo/w13/w2/wcls, the decode attention at
   kv_mul 1 (7B) and 8 (70B-style GQA) over positions 0..2047. Max error
   against the stated tolerance; kernel, plain and library times (CUDA
   events, median of 25 launches, L2 flushed before each); the bound.
3. End to end: a 7B-shaped Q40 model with random codes (seeded) and a
   32000-piece tokenizer are written to build/smoke/, then the port's CLI
   runs ``inference`` in-process for 64 steps, greedy. Every kernel's
   launch count is reset just before and read just after: the Q40 matvec
   must run 4*L+1 = 129 times and the attention L = 32 times per step.
4. Kernels against plain at full width: the first 4 positions of the same
   model through the forward with the kernels and with the plain versions;
   then 8 more kernel steps timed, and 8 under torch.profiler for the
   device time by kernel and the device's busy share. The random codes make
   that model's logits nearly position-independent, so a small model with
   quantized-Gaussian weights also runs through the kernels on the card
   and is held against the plain path on the CPU.
5. The ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"

# peak rates (bytes/s, f32 FLOP/s outside the tensor cores) for the bound:
# the H100 SXM data-sheet numbers; a PCIe part reads ~2.0 TB/s, 51 TFLOP/s
PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}

# the tolerances are the port's own (ops/q40.KERNEL_RTOL,
# ops/attention.KERNEL_ATOL, models/llama.LOGIT_RTOL), shared with the tests
REPS = 25
STEPS = 64
PROMPT = " ".join(["hi"] * 19)  # BOS + 19 merged " hi" pieces = 20 tokens


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` over REPS launches, each timed with CUDA
    events after a 128 MB read that evicts the 50 MB L2 (the main path
    finds every weight matrix cold; a read leaves no dirty lines to write
    back inside the timed launch)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(REPS):
            self.flush.sum()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, flops: float, peaks) -> tuple[float, str]:
    """(least ms, 'bytes' | 'operations') on this card."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 1: card + build
# --------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie"] if "PCIe" in name else PEAKS["sxm"]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; bound uses "
        f"{peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s f32")

    from distributed_llama_tpu_torch.ops import attention, q40
    from distributed_llama_tpu_torch.ops._build import build

    kernels = [q40.KERNEL, attention.KERNEL]
    secs = build(kernels)
    log(f"built {[k.source for k in kernels]} in {secs:.1f} s")
    return smi, name, peaks


# --------------------------------------------------------------------------
# phase 2: kernels against plain at the 7B shapes
# --------------------------------------------------------------------------

# (name, d, n, launches per token at 7B)
K1_SHAPES = [("wqkv", 12288, 4096, 32), ("wo", 4096, 4096, 32),
             ("w13", 22016, 4096, 32), ("w2", 4096, 11008, 32),
             ("wcls", 32000, 4096, 1)]
K2_CASES = [  # (label, L, n_kv, kv_mul)
    ("7b", 32, 32, 1), ("gqa8", 80, 8, 8)]
K2_POS = (0, 1, 63, 1000, 2047)
K2_SEQ, K2_HS = 2048, 128


def phase_k1(torch, timer, peaks):
    from distributed_llama_tpu_torch.ops.q40 import (KERNEL_RTOL, q40_matmul,
                                                     q40_matmul_plain,
                                                     random_q40)

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, d, n, per_token in K1_SHAPES:
        nb = n // 32
        w = random_q40(d, n, "cuda", g)
        x = torch.randn((1, n), device="cuda", generator=g)
        got = q40_matmul(w, x)
        want = q40_matmul_plain(w, x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = KERNEL_RTOL * want.abs().max().item()
        ms = timer(lambda: q40_matmul(w, x))
        plain_ms = timer(lambda: q40_matmul_plain(w, x))
        nbytes = d * nb * 18 + n * 4 + d * 4
        b_ms, b_by = bound(nbytes, 2.0 * d * n, peaks)
        log(f"K1 {name:5s} ({d}x{n}): max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / ms / 1e6:.0f} GB/s)")
        if not err <= tol:
            raise AssertionError(f"K1 {name}: error {err} above {tol}")
        rows.append(dict(shape=name, d=d, n=n, per_token=per_token,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del w, x, got, want
    return rows


def phase_k2(torch, timer, peaks):
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops.attention import (
        KERNEL_ATOL, attention_scale, decode_attention,
        decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, L, n_kv, kv_mul in K2_CASES:
        shape = (L, K2_SEQ, n_kv, K2_HS)
        k_all = torch.randn(shape, device="cuda", generator=g)
        v_all = torch.randn(shape, device="cuda", generator=g)
        n_q = n_kv * kv_mul
        q = torch.randn((n_q, K2_HS), device="cuda", generator=g)
        layer = L - 1
        scale = attention_scale(K2_HS)
        for pos in K2_POS:
            got = decode_attention(q, k_all, v_all, layer, pos, kv_mul)
            want = decode_attention_plain(q, k_all, v_all, layer, pos, kv_mul)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ms = timer(lambda: decode_attention(q, k_all, v_all, layer, pos,
                                                kv_mul))
            plain_ms = timer(lambda: decode_attention_plain(
                q, k_all, v_all, layer, pos, kv_mul))
            # yardstick only: the port never calls SDPA
            qs = q.reshape(1, n_q, 1, K2_HS)
            ks = k_all[layer, :pos + 1].permute(1, 0, 2).unsqueeze(0)
            vs = v_all[layer, :pos + 1].permute(1, 0, 2).unsqueeze(0)
            def lib():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, scale=scale, enable_gqa=kv_mul > 1)

            lib_err = (lib().reshape(1, -1) - want).abs().max().item()
            library_ms = timer(lib)
            nbytes = 2 * (pos + 1) * n_kv * K2_HS * 4 + 2 * n_q * K2_HS * 4
            b_ms, b_by = bound(nbytes, 4.0 * (pos + 1) * n_q * K2_HS, peaks)
            log(f"K2 {label} pos {pos:4d}: max_abs_err {err:.3e} (tol "
                f"{KERNEL_ATOL:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"sdpa {library_ms:.4f} ms (err {lib_err:.1e}) bound "
                f"{b_ms:.5f} ms ({b_by})")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"K2 {label} pos {pos}: error {err}")
            rows.append(dict(case=label, n_kv=n_kv, kv_mul=kv_mul, pos=pos,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms))
        del k_all, v_all
    return rows


# --------------------------------------------------------------------------
# phase 3: the main path, end to end through the CLI
# --------------------------------------------------------------------------

def smoke_files():
    """A 7B-shaped Q40 .bin with random codes (seed 0) and a 32000-piece
    tokenizer in build/smoke/, written once and reused while they fit."""
    import numpy as np

    from distributed_llama_tpu_torch.io.loader import write_model
    from distributed_llama_tpu_torch.io.tokenizer import write_tokenizer
    from distributed_llama_tpu_torch.models.synth import (llama2_7b_spec,
                                                          synth_q40_fast)

    spec = llama2_7b_spec()
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    model = SMOKE_DIR / "llama2_7b_q40_seed0.bin"
    tok = SMOKE_DIR / "tokenizer_32000.bin"
    t0 = time.perf_counter()
    if not model.exists() or model.stat().st_size != spec.file_size():
        tmp = model.with_suffix(".tmp")
        write_model(str(tmp), spec, synth_q40_fast(spec, seed=0))
        tmp.replace(model)
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces += [b" ", b"h", b"i", b"hi", b" hi"]
    pieces += [f"tok{i}".encode() for i in range(len(pieces), 32000)]
    scores = np.zeros(len(pieces), np.float32)
    scores[pieces.index(b"hi")] = -0.5
    scores[pieces.index(b" hi")] = -0.4
    write_tokenizer(str(tok), pieces, scores.tolist())
    log(f"smoke model + tokenizer ready in {time.perf_counter() - t0:.1f} s "
        f"({model.stat().st_size} bytes)")
    return spec, model, tok


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def phase_e2e(torch, model, tok):
    from distributed_llama_tpu_torch.frontend import cli
    from distributed_llama_tpu_torch.ops import attention, q40

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    q40.KERNEL.launches = 0
    attention.KERNEL.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = cli.main(["inference", "--model", str(model), "--tokenizer",
                       str(tok), "--prompt", PROMPT, "--steps", str(STEPS),
                       "--temperature", "0", "--seed", "1"])
    wall = time.perf_counter() - t0
    launches = {"q40_matvec": q40.KERNEL.launches,
                "decode_attention": attention.KERNEL.launches}
    if rc != 0:
        raise RuntimeError(f"CLI exited {rc}")
    out = buf.getvalue()
    steps = int(re.search(r"Generated tokens:\s+(\d+)", out).group(1))
    p50 = float(re.search(r"p50 ([\d.]+)", out).group(1))
    avg = float(re.search(r"Avg generation time: ([\d.]+) ms", out).group(1))
    load_s = float(re.search(r"Loaded model in ([\d.]+)s", out).group(1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"q40_matvec": 129 * steps,
                    "decode_attention": 32 * steps}:
        raise AssertionError(f"launches {launches} over {steps} steps: "
                             f"want 129 and 32 per step")
    if out.count("🔶") < steps - 1:
        raise AssertionError("missing per-token 🔶 lines")
    e2e = dict(steps=steps, ms_per_token_p50=p50, ms_per_token_avg=avg,
               tokens_per_s=1000.0 / avg, load_s=load_s,
               peak_device_gb=peak_gb, wall_s=wall, launches=launches)
    log(f"e2e: {json.dumps(e2e)}")
    return e2e


# --------------------------------------------------------------------------
# phase 4: kernels against plain at full width, end to end
# --------------------------------------------------------------------------

def phase_full_width(torch, model, tok):
    from distributed_llama_tpu_torch.io.loader import load_model
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops.quants import FloatType

    spec, host = load_model(str(model), weights_float_type=FloatType.Q40)
    params = llama.params_to_device(host, "cuda")
    del host
    tokens = Tokenizer(str(tok), spec.vocab_size).encode(PROMPT)[:4]
    kern = llama.Llama(spec, params)
    plain = llama.Llama(spec, params, llama.PLAIN)
    ck = llama.init_cache(spec, "cuda")
    cp = llama.init_cache(spec, "cuda")
    worst = 0.0
    with torch.inference_mode():
        for pos, t in enumerate(tokens):
            a = kern(ck, t, pos)
            b = plain(cp, t, pos)
            if not (torch.isfinite(a).all() and a.shape == (1, spec.vocab_size)):
                raise AssertionError(f"pos {pos}: bad logits {a.shape}")
            err = (a - b).abs().max().item()
            tol = llama.LOGIT_RTOL * b.abs().max().item()
            log(f"full width pos {pos}: max|logit| {b.abs().max().item():.3f} "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) argmax "
                f"{a.argmax().item()} / {b.argmax().item()}")
            if not err <= tol:
                raise AssertionError(f"pos {pos}: kernel vs plain logits "
                                     f"differ by {err}")
            worst = max(worst, err)
        busy = profile_steps(torch, kern, ck, tokens[-1], len(tokens))
    return worst, busy


def profile_steps(torch, model, cache, token, pos0, n=8):
    """Where a decode step's time goes: the wall time of n forward steps
    (host clock, ending in a synchronize), then the same steps under
    torch.profiler for the device time by kernel. Returns the device busy
    share (device kernel time / wall), or None when the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        model(cache, token, pos0 + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            model(cache, token, pos0 + n + i)
        torch.cuda.synchronize()
    # kernel entries only: an aten op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                  for e in events if e.self_device_time_total > 0),
                 key=lambda r: -r[1])
    dev_ms = sum(ms for _, ms, _ in dev)
    log(f"decode step (no profiler): {wall_ms:.4f} ms wall; device kernel "
        f"time {dev_ms:.4f} ms/step over {sum(c for *_, c in dev):.0f} "
        f"kernels/step")
    for key, ms, count in dev[:10]:
        log(f"  {ms:8.4f} ms/step  x{count:5.0f}  {key[:90]}")
    if dev_ms == 0:
        log("  the profiler traced no device time: busy share not measured")
        return None
    return dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
                kernels_per_step=sum(c for *_, c in dev),
                top=[dict(kernel=k[:80], ms=ms, count=c)
                     for k, ms, c in dev[:6]])


def phase_small_reference(torch):
    """A small model with quantized-Gaussian weights (GQA, head size 128,
    so both kernels run): the forward through the kernels on the card
    against the plain path on the CPU, 8 positions. The logits move with
    the position here, unlike the random-code smoke model's."""
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.models.synth import synth_params
    from distributed_llama_tpu_torch.ops.quants import FloatType

    spec = TransformerSpec(dim=512, hidden_dim=1376, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=1000, seq_len=64,
                           weights_float_type=FloatType.Q40)
    host = synth_params(spec, q40=True, seed=7)
    gpu = llama.Llama(spec, llama.params_to_device(host, "cuda"))
    cpu = llama.Llama(spec, llama.params_to_device(host, "cpu"))
    cg, cc = llama.init_cache(spec, "cuda"), llama.init_cache(spec, "cpu")
    worst, argmaxes = 0.0, set()
    with torch.inference_mode():
        for pos, t in enumerate([1, 17, 400, 3, 3, 999, 42, 7]):
            a = gpu(cg, t, pos).cpu()
            b = cpu(cc, t, pos)
            err = (a - b).abs().max().item()
            tol = llama.LOGIT_RTOL * b.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"small model pos {pos}: card vs CPU "
                                     f"logits differ by {err} > {tol}")
            worst = max(worst, err)
            argmaxes.add(int(b.argmax()))
    log(f"small model, kernels on the card vs plain on the CPU: 8 positions, "
        f"max_abs_err {worst:.3e}, {len(argmaxes)} distinct argmaxes")
    return worst


# --------------------------------------------------------------------------

def _bound_by(rows) -> str:
    """The kind of bound that holds most of the rows' per-token bound."""
    weight = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        weight[r["bound_by"]] += r["bound_ms"] * r["per_token"]
    return max(weight, key=weight.get)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (ROOT / "distributed_llama_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no distributed_llama_tpu_torch "
              f"checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    smi, name, peaks = phase_card(torch)
    timer = Timer(torch)
    k1 = phase_k1(torch, timer, peaks)
    k2 = phase_k2(torch, timer, peaks)
    del timer
    spec, model, tok = smoke_files()
    e2e = phase_e2e(torch, model, tok)
    gc.collect()
    torch.cuda.empty_cache()
    logit_err, busy = phase_full_width(torch, model, tok)
    small_err = phase_small_reference(torch)

    def per_token(rows):
        return {key: sum(r[key] * r["per_token"] for r in rows)
                for key in ("ms", "plain_ms", "bound_ms")}

    k1_tok = per_token(k1)
    # K2 per token: 32 layers at the deepest position of the smoke run
    k2_63 = [dict(r, per_token=32) for r in k2
             if r["case"] == "7b" and r["pos"] == 63]
    k2_tok = per_token(k2_63)
    kernels = [
        dict(name="q40_matvec", route="cuda",
             source="distributed_llama_tpu_torch/csrc/q40_matvec.cu",
             replaces="distributed_llama_tpu/ops/pallas_q40.py:696",
             launches=e2e["launches"]["q40_matvec"],
             max_abs_err=max(r["max_abs_err"] for r in k1), **k1_tok,
             bound_by=_bound_by(k1), library_ms=None,
             unit="one 7B token: 32 x (wqkv, wo, w13, w2) + wcls",
             shapes=k1),
        dict(name="decode_attention", route="cuda",
             source="distributed_llama_tpu_torch/csrc/decode_attention.cu",
             replaces="distributed_llama_tpu/ops/pallas_attention.py:304",
             launches=e2e["launches"]["decode_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k2), **k2_tok,
             bound_by=_bound_by(k2_63),
             library_ms=sum(r["library_ms"] * 32 for r in k2_63),
             unit="one 7B token at pos 63: 32 layers", shapes=k2),
    ]
    log(f"full-width logits max_abs_err {logit_err:.3e}; small-model "
        f"max_abs_err {small_err:.3e}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels, "e2e": e2e, "step_profile": busy}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
