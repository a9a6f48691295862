"""The window kernels K6w and K7w (csrc/paged_window.cu) under other key
group and stage counts, timed in turns on one card beside the package's
build and the split walk windows took before them.

Each variant is paged_window.cu built with ``-DWINDOW_GROUPS=g
-DWINDOW_STAGES=s`` under ``build/window_variants/`` with the port's nvcc
flags and called through its C entry point with the wrapper's arguments
(the default plan, ``paged_attention.window_plan``). At each shape (a
Llama-2-7B layer, 32 kv heads, and 8 GQA kv heads of 8 query heads each;
1 and 8 rows over pages of 16 in a permuted pool; a shared pos of 63 and
2047; t_len 2, 4, 16 and 39) every variant is checked against the plain
version
(KERNEL_ATOL) and timed with chip_smoke.py's Timer recipe (CUDA events,
median of 25 launches, the L2 flushed and the card held busy before each
start event), in the order built, variants, walk, then back again, so a
drift of the card's clock shows as a difference between a variant's two
turns. A variant whose block would pass the kernel's launch bounds (more
than 4 consumer warps) is skipped at that shape. ``least<n>`` is the
package's build under the default plan's split count with at least n
keys a split (``--least``). ``walk`` is K6's or K7's
split walk at the window (one block a (row, query)), launched as the
wrapper launched windows before the window kernels.

On a machine with an NVIDIA GPU, from the repository root:

    python3 -m distributed_llama_tpu_torch.tools.window_variants
        [--configs 3x3,2x2,1x2,4x4] [--least 32,64] [--pages f32,bf16,q8]
        [--batches 1,8] [--json PATH]

Prints a line a shape and a JSON object with every time and the card's
name and power limit. Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ..ops import _build, attention, paged_attention as pa
from ..ops.quants import quantize_q80_torch

OUT = _build.BUILD_DIR.parent / "window_variants"
REPS = 25
CASES = [("7b", 32, 1), ("gqa8", 8, 8)]  # (label, n_kv, kv_mul)
T_LENS = (2, 4, 16, 39)
POSITIONS = (63, 2047)
S, HS, PAGE, LAYER = 2048, 128, 16, 1
SYMBOLS = {"f32": "paged_window", "bf16": "paged_window_kvbf16",
           "q8": "paged_window_q8"}


def build_variants(configs) -> dict:
    """{(groups, stages): library}: every variant's nvcc started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for g, s in configs:
        so = OUT / f"paged_window-g{g}s{s}.so"
        procs[g, s] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, f"-DWINDOW_GROUPS={g}",
             f"-DWINDOW_STAGES={s}", "-I", str(_build.CSRC), "-o", str(so),
             str(_build.CSRC / "paged_window.cu")]))
    libs = {}
    for key, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"window_variants: the g{key[0]}s{key[1]} "
                               f"build failed")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def call(lib, pages, q, planes, pos, table, P, kv_mul):
    """One launch of a variant's entry point with the wrapper's
    arguments."""
    batch, t_len, _ = q.shape
    _, ps, n_kv, hs = planes[0].shape
    most, least = pa.window_plan(n_kv, batch, t_len, kv_mul,
                                 pa.sm_count(q.device))
    out = torch.empty_like(q)
    fn = getattr(lib, SYMBOLS[pages])
    fn.argtypes = pa._Q8_ARGS if pages == "q8" else pa._PAGED_ARGS
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), *(p.data_ptr() for p in planes), out.data_ptr(),
            *attention._decode_scratch(q.device, batch * t_len, n_kv,
                                       kv_mul, hs, most),
            LAYER, pos.data_ptr(), table.data_ptr(), batch, t_len, P,
            table.shape[1], ps, n_kv, kv_mul, hs, most, least,
            attention.attention_scale(hs),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"window_variants: launch failed ({rc})")
    return out


def make_timer():
    """chip_smoke.py's Timer: the median of REPS CUDA-event times, each
    after a 128 MB read that evicts the L2 and a ~0.5 ms spin."""
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def time(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(REPS):
            flush.sum()
            torch.cuda._sleep(1_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return time


def pool(g, n_kv, pages, batch):
    """A permuted pool of ``batch`` rows' S positions (two layers) and its
    table: (planes, table, P)."""
    P = batch * S // PAGE
    shape = (2 * P, PAGE, n_kv, HS)
    perm = torch.randperm(P, device="cuda", generator=g)
    table = perm.to(torch.int32)[torch.arange(
        P, device="cuda").reshape(batch, S // PAGE)].contiguous()
    k = torch.randn(shape, device="cuda", generator=g)
    v = torch.randn(shape, device="cuda", generator=g)
    if pages == "q8":
        planes = []
        for x in (k, v):
            qs, d = quantize_q80_torch(x.reshape(2 * P, PAGE, n_kv * HS))
            planes += [qs.reshape(shape).contiguous(), d.contiguous()]
        return planes, table, P
    dtype = torch.bfloat16 if pages == "bf16" else torch.float32
    return [k.to(dtype), v.to(dtype)], table, P


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="3x3,2x2,1x2,4x4",
                    help="groups x stages of each variant")
    ap.add_argument("--least", default="",
                    help="least keys a split of extra plans of the build")
    ap.add_argument("--pages", default="f32,bf16,q8")
    ap.add_argument("--batches", default="8")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_variants: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    configs = [tuple(int(x) for x in c.split("x"))
               for c in args.configs.split(",") if c]
    libs = build_variants(configs)
    _build.build(list(pa.KERNELS))
    time = make_timer()
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for pages in args.pages.split(","):
        q8 = pages == "q8"
        run = pa.paged_decode_attention_q8 if q8 else pa.paged_decode_attention
        plain = (pa.paged_decode_attention_q8_plain if q8
                 else pa.paged_decode_attention_plain)
        walk_kernel = {"f32": pa.PAGED_KERNEL, "bf16": pa.PAGED_KERNEL_KVBF16,
                       "q8": pa.PAGED_KERNEL_Q8}[pages]
        for (label, n_kv, kv_mul), batch in (
                (c, int(b)) for c in CASES for b in args.batches.split(",")):
            planes, table, P = pool(g, n_kv, pages, batch)
            for p in POSITIONS:
                pv = torch.full((batch,), p, dtype=torch.int32,
                                device="cuda")
                for t_len in T_LENS:
                    q = torch.randn((batch, t_len, n_kv * kv_mul * HS),
                                    device="cuda", generator=g)
                    warps = pa.window_tiles(t_len, kv_mul)[0]
                    fns = {"built": lambda: run(q, *planes, LAYER, pv, table,
                                                P, kv_mul)}
                    most = pa.window_plan(n_kv, batch, t_len, kv_mul,
                                          pa.sm_count(q.device))[0]
                    for least in (int(x) for x in args.least.split(",")
                                  if x):
                        fns[f"least{least}"] = (
                            lambda plan=(most, least): run(
                                q, *planes, LAYER, pv, table, P, kv_mul,
                                plan=plan))
                    for (gr, st), lib in libs.items():
                        if warps * gr <= pa.WINDOW_WARPS:
                            fns[f"g{gr}s{st}"] = (
                                lambda lib=lib: call(lib, pages, q, planes,
                                                     pv, table, P, kv_mul))
                    walk_plan = pa.paged_plan(n_kv, batch, t_len,
                                              pa.sm_count(q.device))
                    walk = (walk_kernel, walk_kernel)
                    fns["walk"] = lambda: pa._launch(
                        walk, q, planes, LAYER, pv, table, P, kv_mul,
                        walk_plan)
                    want = plain(q, *planes, LAYER, pv, table, P, kv_mul)
                    errs = {}
                    for name, fn in fns.items():
                        errs[name] = (fn() - want).abs().max().item()
                        if not errs[name] <= attention.KERNEL_ATOL:
                            raise AssertionError(
                                f"window_variants: {name} {pages} {label} "
                                f"pos {p} t={t_len}: error {errs[name]}")
                    times = {name: [] for name in fns}
                    for name in [*fns, *reversed(fns)]:
                        times[name].append(time(fns[name]))
                    row = dict(pages=pages, case=label, batch=batch, pos=p,
                               t_len=t_len, warps=warps, times=times,
                               max_abs_err=errs)
                    rows.append(row)
                    print(f"{pages} {label} B={batch} pos {p} t={t_len}: "
                          + "; ".join(f"{n} {statistics.mean(v):.4f}"
                                      for n, v in times.items()), flush=True)
            del planes
    out = dict(card=smi, device=torch.cuda.get_device_name(0),
               configs=[f"g{a}s{b}" for a, b in configs], rows=rows)
    text = json.dumps(out)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
