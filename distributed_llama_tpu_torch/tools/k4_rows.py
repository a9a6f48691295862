"""K4 (csrc/prefill_attention.cu) at other query-row tiles per block.

A K4 block owns one kv head and kWarps * IPW (row, head) items, so K and V
of the live prefix are read ceil(T / rows) times per kv head, rows =
kWarps * IPW / kv_mul. This builds copies of the source whose kv_mul 1 and
kv_mul 8 launches take other IPW values, and times each against the
shipped one and the plain version at the 7B shapes of chip_smoke.py's K4
phase (T = 128; pos 0, 384, 1920; kv_mul 1 with 32 kv heads, kv_mul 8 with
8). Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m distributed_llama_tpu_torch.tools.k4_rows

Prints the card's name and power limit, then one line per case: the plain
version's ms and each variant's ms and max error against plain (CUDA
events, median of 25 launches, L2 flushed before each).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

# name -> (IPW at kv_mul 1, IPW at kv_mul 8); rows per block = 8 * IPW / kv_mul
VARIANTS = {"shipped (16 / 4 rows)": (2, 4), "8 / 1 rows": (1, 1),
            "32 / 8 rows": (4, 8), "64 / 2 rows": (8, 2)}
CASES = (("7b", 32, 32, 1), ("gqa8", 4, 8, 8))  # (label, L, n_kv, kv_mul)
POSITIONS = (0, 384, 1920)
T, HS, SEQ, REPS = 128, 128, 2048, 25


def build_variants() -> dict:
    """nvcc every variant (all started together) into build/k4_rows/ and
    bind its entry point."""
    from ..ops import attention
    from ..ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

    out = BUILD_DIR.parent / "k4_rows"
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "prefill_attention.cu").read_text()
    for site in ("launch<KV, 1, 2>", "launch<KV, 8, 4>"):
        if site not in src:
            raise RuntimeError(f"prefill_attention.cu has no {site!r} "
                               f"launch to vary")
    jobs = {}
    for i, (name, (ipw1, ipw8)) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(
            src.replace("launch<KV, 1, 2>", f"launch<KV, 1, {ipw1}>")
            .replace("launch<KV, 8, 4>", f"launch<KV, 8, {ipw8}>"))
        jobs[name] = (out / f"v{i}.so", subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(so)).prefill_attention
        fn.argtypes = attention.PREFILL_KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    from ..ops.attention import attention_scale, prefill_attention_plain

    if not torch.cuda.is_available():
        print("k4_rows: no CUDA device")
        return 1
    fns = build_variants()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    flush = torch.ones(32 << 20, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(fn) -> float:
        fn()
        times = []
        for _ in range(REPS):
            flush.sum()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    g = torch.Generator(device="cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    for label, L, n_kv, kv_mul in CASES:
        for pos in POSITIONS:
            k = torch.randn((L, SEQ, n_kv, HS), device="cuda", generator=g)
            v = torch.randn((L, SEQ, n_kv, HS), device="cuda", generator=g)
            q = torch.randn((T, n_kv * kv_mul, HS), device="cuda", generator=g)
            want = prefill_attention_plain(q, k, v, L - 1, pos, kv_mul)
            out = torch.empty_like(want)
            plain_ms = timed(lambda: prefill_attention_plain(
                q, k, v, L - 1, pos, kv_mul))
            row = [f"{label} T={T} pos {pos:4d}: plain {plain_ms:.4f} ms"]
            for name, fn in fns.items():
                def run(fn=fn):
                    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), L - 1, pos, T, SEQ, n_kv, kv_mul,
                            HS, attention_scale(HS), stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch error {rc}")

                run()
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                row.append(f"{name} {timed(run):.4f} ms (err {err:.1e})")
            print("; ".join(row), flush=True)
            del k, v, q, want, out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
