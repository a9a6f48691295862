"""Time every plan of K1, K1m and K1d (``q40_matvec``,
``q40_matvec_multi``, ``q40_matvec_bf16``: row and split warps a block,
blocks a split, K splits), K3 (``q40_gemm``:
splits x warpgroups), K4 (``prefill_attention``: splits of the key
range), K2 and K5 (``decode_attention``, ``decode_attention_batch``:
blocks an SM, least keys a split, keys in flight a warp) and K6 and K7
(``paged_attention``, ``_kvbf16``, ``_q8``: the same) at Llama-2-7B's
shapes (and GQA shapes for K2/K5/K6/K7) on the card,
beside the plan the wrappers pick (``ops/q40.matvec_plan``,
``gemm_tf32_plan``, ``ops/attention.prefill_plan``, ``decode_plan``,
``ops/paged_attention.paged_plan``). Run on a machine with an NVIDIA GPU:

    python3 -m distributed_llama_tpu_torch.tools.plan_sweep [--k1-t 1,2,8]
        [--k1d-t 2,8] [--t 16,32,128] [--pos 384,1920]
        [--decode-pos 63,512,1000,2047] [--decode-cache f32,bf16]
        [--paged-pos 63,2047] [--paged-pages f32,bf16,q8]

(an empty list skips that kernel). The keys in flight a warp are a
compile-time constant: the sweep builds decode_attention.cu once more for
each (``-DDECODE_KEYS_AHEAD=n``), and paged_attention.cu for each
(``-DPAGED_KEYS_AHEAD=n``), and swaps the build the wrappers launch;
"built" is the source's own table.

Each line gives the shape, the picked plan and its time, and the fastest
plans of the sweep. A time covers the plan's whole call with its parts (K3's
x split and split-K sum, K4's combine): the median of 25 CUDA-event timed
launches, each after a 128 MB read that evicts the L2 and a ~0.5 ms spin
of the card, as chip_smoke.py times the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import torch

from ..ops import attention, paged_attention, q40
from ..ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, build, nvcc
from ..ops.quants import quantize_q80_torch

REPS = 25
LAYER_SHAPES = [("wqkv", 12288, 4096), ("wo", 4096, 4096),
                ("w13", 22016, 4096), ("w2", 4096, 11008)]
WCLS = ("wcls", 32000, 4096)
HS, N_KV = 128, 32  # 7B's attention: 32 kv heads of 128


def make_timer():
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


def sweep_k1(time, t: int, sms: int, pieces: int = 3) -> None:
    """K1 (t = 1), K1m or, with one piece, K1d over every plan of
    ops/q40.matvec_plans at 7B's layer shapes (and the classifier, which
    K1d never multiplies)."""
    g = torch.Generator(device="cuda").manual_seed(100 + t)
    stream = torch.cuda.current_stream().cuda_stream
    tickets = q40._tickets(torch.device("cuda", torch.cuda.current_device()))
    kernel = (q40.KERNEL if t == 1 else q40.KERNEL_MULTI if pieces == 3
              else q40.KERNEL_MULTI_BF16)
    label = "K1d" if pieces == 1 else f"K1{'m' if t > 1 else ''}"
    for name, d, n in LAYER_SHAPES + ([WCLS] if pieces == 3 else []):
        nb = n // 32
        w = q40.random_q40(d, n, "cuda", g)
        x = torch.randn((t, n), device="cuda", generator=g)
        out = torch.empty((t, d), device="cuda")
        ms = {}
        for _, plan in q40.matvec_plans(t, d, nb, sms, pieces):
            part = torch.empty((plan[3], t, d), device="cuda")
            head = (w.qs.data_ptr(), w.d16.data_ptr(), x.data_ptr(),
                    out.data_ptr(), part.data_ptr(), tickets.data_ptr())
            dims = (d, nb) if t == 1 else (t, d, nb)

            def run(plan=plan, head=head, dims=dims):
                kernel.launch(*head, *dims, *plan, stream)

            ms[plan] = time(run)
        pick = q40.matvec_plan(t, d, nb, sms, pieces)
        _report(f"{label} {name} T={t}", pick, ms,
                "(wr, wk, grid_x, splits, kb)")


def sweep_k3(time, t: int, sms: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(t)
    stream = torch.cuda.current_stream().cuda_stream
    for name, d, n in LAYER_SHAPES:
        nb = n // 32
        w = q40.random_q40(d, n, "cuda", g)
        x = torch.randn((t, n), device="cuda", generator=g)
        xs = torch.empty((2, t, n), device="cuda")
        out = torch.empty((t, d), device="cuda")
        ms = {}
        for wg in q40.gemm_tf32_warpgroups(t):
            for splits in range(1, q40.GEMM_BF16_MAX_SPLITS + 1):
                if (splits - 1) * -(-nb // splits) >= nb:
                    continue
                part = torch.empty((splits, t, d), device="cuda")

                def run(splits=splits, wg=wg, part=part):
                    q40.KERNEL_SPLIT_TF32.launch(
                        x.data_ptr(), xs[0].data_ptr(), xs[1].data_ptr(),
                        x.numel(), stream)
                    q40.KERNEL_GEMM.launch(
                        w.qs.data_ptr(), w.d16.data_ptr(), xs[0].data_ptr(),
                        xs[1].data_ptr(),
                        (out if splits == 1 else part).data_ptr(), t, d, nb,
                        splits, wg, stream)
                    if splits > 1:
                        q40.KERNEL_GEMM_BF16_REDUCE.launch(
                            part.data_ptr(), out.data_ptr(), t * d, splits,
                            stream)

                ms[splits, wg] = time(run)
        pick = q40.gemm_tf32_plan(t, d, nb, sms)
        _report(f"K3 {name} T={t}", (pick[0], pick[2]), ms,
                "(splits, warpgroups)")


def sweep_k4(time, pos: int, t_len: int, cache: torch.dtype,
             sms: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(pos)
    k_all = torch.randn((1, pos + t_len, N_KV, HS), device="cuda",
                        generator=g).to(cache)
    v_all = torch.randn(k_all.shape, device="cuda", generator=g).to(cache)
    q = torch.randn((t_len, N_KV, HS), device="cuda", generator=g)
    out = torch.empty((t_len, N_KV * HS), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tiles = -(-(pos + t_len) // attention.PREFILL_KEYS)
    n_all = t_len * N_KV
    kernel = attention._PREFILL[False, cache]
    ms = {}
    for splits in range(1, 9):
        per = -(-tiles // splits)
        if -(-tiles // per) != splits:
            continue
        o_part = torch.empty((splits, n_all, HS), device="cuda")
        ml_part = torch.empty((2, splits, n_all), device="cuda")

        def run(splits=splits, per=per, o_part=o_part, ml_part=ml_part):
            kernel.launch(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                          out.data_ptr(), o_part.data_ptr(),
                          ml_part.data_ptr(), 0, pos, t_len, pos + t_len,
                          N_KV, 1, HS, splits, per,
                          attention.attention_scale(HS), stream)
            if splits > 1:
                attention.PREFILL_BF16_COMBINE.launch(
                    o_part.data_ptr(), ml_part.data_ptr(), out.data_ptr(),
                    n_all, HS, splits, stream)

        ms[splits] = time(run)
    pick = attention.prefill_plan(pos, t_len, 1, N_KV, sms)[0]
    _report(f"K4 {str(cache).split('.')[-1]} cache T={t_len} pos {pos}",
            pick, ms, "splits")


DECODE_CASES = [("7b", 32, 1), ("gqa8", 8, 8)]  # (label, n_kv, kv_mul)
DECODE_BATCHES = (1, 8)
DECODE_AHEAD = (1, 2, 4, 8)
DECODE_PER_SM = (1, 2, 3, 4)
DECODE_LEAST = (32, 64, 128, 256)


def _variants(source: str, kernels, flags: dict) -> dict:
    """{label: (lib, {symbol: fn})}: ``source`` built once more for each
    label with its -D flags, all nvcc's started together, the kernels'
    symbols bound as the wrappers bind them."""
    out, procs = {}, {}
    (BUILD_DIR / "plan_sweep").mkdir(parents=True, exist_ok=True)
    stem = source.split(".")[0]
    for label, defines in flags.items():
        name = "-".join(str(x) for x in (label if isinstance(label, tuple)
                                         else (label,)))
        so = BUILD_DIR / "plan_sweep" / f"{stem}-{name}.so"
        procs[label] = (so, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(so),
             str(CSRC / source)]))
    for label, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"plan_sweep: the {stem} {label} build "
                               f"failed")
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        fns = {}
        for k in kernels:
            fn = getattr(lib, k.symbol)
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
            fns[k.symbol] = fn
        out[label] = (lib, fns)
    return out


def _decode_variants() -> dict:
    """{keys in flight: (lib, {symbol: fn})}: decode_attention.cu built
    with -DDECODE_KEYS_AHEAD=n for each n."""
    return _variants("decode_attention.cu",
                     (attention.KERNEL, attention.KERNEL_KVBF16,
                      attention.BATCH_KERNEL, attention.BATCH_KERNEL_KVBF16),
                     {n: [f"-DDECODE_KEYS_AHEAD={n}"] for n in DECODE_AHEAD})


def sweep_decode(time, variants, pos: int, cache: torch.dtype,
                 sms: int) -> None:
    """K2 (B = 1) and K5 (B = 8, one shared clock) over every (blocks an
    SM, least keys a split, keys in flight a warp) at ``pos``; a plan's
    blocks an SM give its ``most`` as decode_plan does."""
    g = torch.Generator(device="cuda").manual_seed(pos)
    for label, n_kv, kv_mul in DECODE_CASES:
        for batch in DECODE_BATCHES:
            k4 = torch.randn((batch, 2048, n_kv, HS), device="cuda",
                             generator=g).to(cache)
            v4 = torch.randn(k4.shape, device="cuda", generator=g).to(cache)
            q = torch.randn((batch, n_kv * kv_mul, HS), device="cuda",
                            generator=g)
            pv = torch.full((batch,), pos, dtype=torch.int32, device="cuda")
            if batch == 1:
                kernel = (attention.KERNEL if cache == torch.float32
                          else attention.KERNEL_KVBF16)

                def call(plan):
                    attention.decode_attention(q[0], k4, v4, 0, pos, kv_mul,
                                               plan=plan)
            else:
                kernel = (attention.BATCH_KERNEL if cache == torch.float32
                          else attention.BATCH_KERNEL_KVBF16)

                def call(plan):
                    attention.decode_attention_batch(q, k4, v4, 0, pv,
                                                     kv_mul, plan=plan)
            built = kernel._lib, kernel._fn
            ms = {}
            for ahead in ("built", *DECODE_AHEAD):
                if ahead != "built":
                    lib, fns = variants[ahead]
                    kernel._lib, kernel._fn = lib, fns[kernel.symbol]
                for per_sm in DECODE_PER_SM:
                    most = max(1, min(attention.DECODE_MAX_SPLITS,
                                      per_sm * sms // (n_kv * batch)))
                    for least in DECODE_LEAST:
                        ms[per_sm, least, ahead] = time(
                            lambda: call((most, least)))
                kernel._lib, kernel._fn = built
            pick = (attention.DECODE_BLOCKS_PER_SM,
                    attention.DECODE_SPLIT_KEYS, "built")
            _report(f"{'K2' if batch == 1 else 'K5'} "
                    f"{str(cache).split('.')[-1]} cache {label} B={batch} "
                    f"pos {pos}", pick, ms,
                    "(blocks an SM, least keys, keys in flight)")
            del k4, v4


PAGED_CASES = [("7b", 32, 1), ("gqa2", 16, 2), ("gqa4", 8, 4),
               ("gqa8", 8, 8)]
PAGED_PER_SM = (1, 2, 4)
PAGED_LEAST = (32, 64, 128, 256)
PAGE = 16


def _paged_variants() -> dict:
    """{keys in flight: (lib, {symbol: fn})}: paged_attention.cu built
    with -DPAGED_KEYS_AHEAD=n for each n."""
    return _variants("paged_attention.cu",
                     [k for k in paged_attention.KERNELS
                      if k.source == "paged_attention.cu"],
                     {n: [f"-DPAGED_KEYS_AHEAD={n}"] for n in DECODE_AHEAD})


def sweep_paged(time, variants, pos: int, pages: str, sms: int) -> None:
    """K6 (f32, bf16 pages) or K7 (Q8 pages) at t_len 1 over a permuted
    pool of PAGE-position pages, every (blocks an SM, least keys a split,
    keys in flight) at ``pos``, B = 1 and 8; the picked plan is
    paged_plan, the picked keys in flight the source's."""
    g = torch.Generator(device="cuda").manual_seed(pos + len(pages))
    dtype = torch.bfloat16 if pages == "bf16" else torch.float32
    kernel = {"f32": paged_attention.PAGED_KERNEL,
              "bf16": paged_attention.PAGED_KERNEL_KVBF16,
              "q8": paged_attention.PAGED_KERNEL_Q8}[pages]
    run = (paged_attention.paged_decode_attention_q8 if pages == "q8"
           else paged_attention.paged_decode_attention)
    for label, n_kv, kv_mul in PAGED_CASES:
        for batch in DECODE_BATCHES:
            P = batch * 2048 // PAGE
            shape = (P, PAGE, n_kv, HS)
            k4 = torch.randn(shape, device="cuda", generator=g).to(dtype)
            v4 = torch.randn(shape, device="cuda", generator=g).to(dtype)
            if pages == "q8":
                planes = []
                for x in (k4, v4):
                    qs, d = quantize_q80_torch(x.reshape(P, PAGE,
                                                         n_kv * HS))
                    planes += [qs.reshape(shape).contiguous(),
                               d.contiguous()]
            else:
                planes = [k4, v4]
            table = torch.randperm(P, device="cuda", generator=g).to(
                torch.int32).reshape(batch, 2048 // PAGE).contiguous()
            q = torch.randn((batch, 1, n_kv * kv_mul * HS), device="cuda",
                            generator=g)
            pv = torch.full((batch,), pos, dtype=torch.int32, device="cuda")
            built = kernel._lib, kernel._fn
            ms = {}
            for ahead in ("built", *DECODE_AHEAD):
                if ahead != "built":
                    lib, fns = variants[ahead]
                    kernel._lib, kernel._fn = lib, fns[kernel.symbol]
                for per_sm in PAGED_PER_SM:
                    most = max(1, min(attention.DECODE_MAX_SPLITS,
                                      per_sm * sms // (n_kv * batch)))
                    for least in PAGED_LEAST:
                        ms[per_sm, least, ahead] = time(
                            lambda: run(q, *planes, 0, pv, table, P, kv_mul,
                                        plan=(most, least)))
                kernel._lib, kernel._fn = built
            pick = (attention.DECODE_BLOCKS_PER_SM,
                    attention.DECODE_SPLIT_KEYS, "built")
            _report(f"{'K7' if pages == 'q8' else 'K6'} {pages} pages "
                    f"{label} B={batch} pos {pos}", pick, ms,
                    "(blocks an SM, least keys, keys in flight)")
            del k4, v4, planes


def _report(label, pick, ms, what) -> None:
    best = sorted(ms, key=ms.get)
    print(f"{label}: picked {what} {pick} {ms[pick]:.4f} ms; fastest "
          + ", ".join(f"{p} {ms[p]:.4f}" for p in best[:3])
          + f" ({ms[pick] / ms[best[0]]:.3f}x the fastest)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1-t", default="1,2,3,4,5,6,7,8",
                    help="K1's and K1m's token counts (comma-separated)")
    ap.add_argument("--k1d-t", default="2,4,8",
                    help="K1d's token counts (comma-separated)")
    ap.add_argument("--t", default="16,32,128",
                    help="K3's token counts (comma-separated)")
    ap.add_argument("--pos", default="384,1920",
                    help="K4's chunk positions at T = 128 (comma-separated)")
    ap.add_argument("--decode-pos", default="63,512,1000,2047",
                    help="K2's and K5's positions (comma-separated)")
    ap.add_argument("--decode-cache", default="f32",
                    help="K2's and K5's cache dtypes, f32 and/or bf16 "
                         "(comma-separated)")
    ap.add_argument("--paged-pos", default="63,2047",
                    help="K6's and K7's positions (comma-separated)")
    ap.add_argument("--paged-pages", default="f32,bf16,q8",
                    help="K6's and K7's page kinds, f32, bf16 and/or q8 "
                         "(comma-separated)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plan_sweep: no CUDA device")
        return 1
    build([q40.KERNEL, q40.KERNEL_MULTI, q40.KERNEL_MULTI_BF16,
           q40.KERNEL_GEMM,
           q40.KERNEL_SPLIT_TF32, q40.KERNEL_GEMM_BF16_REDUCE,
           attention.PREFILL_KERNEL, attention.PREFILL_KERNEL_KVBF16,
           attention.PREFILL_BF16_COMBINE, attention.KERNEL,
           attention.KERNEL_KVBF16, attention.BATCH_KERNEL,
           attention.BATCH_KERNEL_KVBF16, *paged_attention.KERNELS])
    time = make_timer()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def ints(text):
        return [int(v) for v in text.split(",") if v]

    for t in ints(args.k1_t):
        sweep_k1(time, t, sms)
    for t in ints(args.k1d_t):
        sweep_k1(time, t, sms, pieces=1)
    for t in ints(args.t):
        sweep_k3(time, t, sms)
    for cache in (torch.float32, torch.bfloat16):
        for pos in ints(args.pos):
            sweep_k4(time, pos, 128, cache, sms)
    decode_pos = ints(args.decode_pos)
    if decode_pos:
        variants = _decode_variants()
        dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
        for name in [c for c in args.decode_cache.split(",") if c]:
            for pos in decode_pos:
                sweep_decode(time, variants, pos, dtypes[name], sms)
    paged_pos = ints(args.paged_pos)
    if paged_pos:
        variants = _paged_variants()
        for pages in [c for c in args.paged_pages.split(",") if c]:
            for pos in paged_pos:
                sweep_paged(time, variants, pos, pages, sms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
