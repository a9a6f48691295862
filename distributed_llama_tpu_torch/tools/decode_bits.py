"""K2 and K5 (csrc/decode_attention.cu ``decode_attention[_kvbf16]``,
``decode_attention_batch[_kvbf16]``) of this tree against another tree's,
bit for bit and in time, on one card: the other tree's
decode_attention.cu (``--other DIR``, e.g. the parent commit unpacked with
``git archive``) is built with its own headers under
``build/decode_bits/`` with the port's nvcc flags and bound with this
tree's argument types (the C interface must be the same), then both run
on the same inputs at chip_smoke.py's K5 shapes (Llama-2-7B's 32 kv
heads, 8 GQA kv heads at kv_mul 8) and at 16 kv heads at kv_mul 2, head
size 128, a two-layer (2B, 2048, n_kv, hs) cache, B = 1 and 8, shared clocks 63 and 2047 and
ragged ones, f32 and bf16 caches, each under the default plan, one split
and (32, 64); K2 at each B = 1 clock. Prints a line per shape with both
times (plan_sweep's timer: the median of 25 CUDA-event timed launches,
each after an L2 flush, as chip_smoke.py times the kernels), then the
ratio of this tree's time to the other's by kernel and kv_mul, and exits
1 if any output differs in a bit.

On a machine with an NVIDIA GPU, from the repository root:

    python3 -m distributed_llama_tpu_torch.tools.decode_bits --other DIR

Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, attention
from .plan_sweep import make_timer

OUT = _build.BUILD_DIR.parent / "decode_bits"
# (label, n_kv, kv_mul)
CASES = [("7b", 32, 1), ("gqa2", 16, 2), ("gqa8", 8, 8)]
BATCHES = (1, 8)
PLANS = (None, attention.ONE_SPLIT, (32, 64))
S, HS, LAYER = 2048, 128, 1
# by (kernel, cache dtype)
KERNELS = {("K2", torch.float32): attention.KERNEL,
           ("K2", torch.bfloat16): attention.KERNEL_KVBF16,
           ("K5", torch.float32): attention.BATCH_KERNEL,
           ("K5", torch.bfloat16): attention.BATCH_KERNEL_KVBF16}


def positions(batch: int) -> list[tuple[str, list[int]]]:
    """chip_smoke.py's K5 clocks: shared 63 and 2047, ragged ones."""
    ragged = ([5 + (S - 6) * i // (batch - 1) for i in range(batch)]
              if batch > 1 else [900])
    return [("shared 63", [63] * batch), ("shared 2047", [2047] * batch),
            ("ragged", ragged)]


def build_other(tree: Path) -> ctypes.CDLL:
    """The other tree's decode_attention.cu, built with its own headers."""
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = tree / "distributed_llama_tpu_torch" / "csrc"
    so = OUT / "other.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(so), str(csrc / "decode_attention.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def run(tree: Path) -> int:
    _build.build(list(KERNELS.values()))
    lib = build_other(tree)
    theirs = {}
    for k in KERNELS.values():
        fn = getattr(lib, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        theirs[k.symbol] = fn
    time = make_timer()
    g = torch.Generator(device="cuda").manual_seed(9)
    checked = differ = 0
    ratios = {}  # (kernel, kv_mul) -> this tree's time over the other's
    for cache in (torch.float32, torch.bfloat16):
        for label, n_kv, kv_mul in CASES:
            for batch in BATCHES:
                shape = (2 * batch, S, n_kv, HS)
                k4 = torch.randn(shape, device="cuda", generator=g).to(cache)
                v4 = torch.randn(shape, device="cuda", generator=g).to(cache)
                q = torch.randn((batch, n_kv * kv_mul, HS), device="cuda",
                                generator=g)
                for pos_label, pos in positions(batch):
                    pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    calls = [("K5", lambda plan: attention
                              .decode_attention_batch(q, k4, v4, LAYER, pv,
                                                      kv_mul, plan=plan))]
                    if batch == 1:
                        calls.append(("K2", lambda plan: attention
                                      .decode_attention(q[0], k4, v4, LAYER,
                                                        pos[0], kv_mul,
                                                        plan=plan)))
                    for name, call in calls:
                        for plan in PLANS:
                            ours = call(plan)
                            ms = time(lambda: call(plan))
                            kernel = KERNELS[name, cache]
                            mine = kernel._fn
                            kernel._fn = theirs[kernel.symbol]
                            try:
                                other = call(plan)
                                other_ms = time(lambda: call(plan))
                            finally:
                                kernel._fn = mine
                            torch.cuda.synchronize()
                            ratios.setdefault((name, kv_mul), []).append(
                                ms / other_ms)
                            same = torch.equal(ours, other)
                            checked += 1
                            differ += not same
                            verdict = "same bits" if same else (
                                f"DIFFER (max |diff| "
                                f"{(ours - other).abs().max().item():.3e})")
                            print(f"{name} {str(cache).split('.')[-1]} "
                                  f"{label} B={batch} {pos_label} plan "
                                  f"{plan}: {verdict}; {ms:.4f} ms, the "
                                  f"other's {other_ms:.4f}", flush=True)
                del k4, v4
    for (name, kv_mul), rs in sorted(ratios.items()):
        print(f"{name} kv_mul {kv_mul}: this tree's time over the other's "
              f"{min(rs):.3f}..{max(rs):.3f}, median "
              f"{statistics.median(rs):.3f} ({len(rs)} outputs)", flush=True)
    print(f"decode_bits: {checked - differ} of {checked} outputs the other "
          f"tree's bits", flush=True)
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="the root of another checkout of the repository")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_bits: no CUDA device", file=sys.stderr)
        return 1
    return run(args.other.resolve())


if __name__ == "__main__":
    raise SystemExit(main())
