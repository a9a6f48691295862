"""CLI entry point: the ``inference`` mode of the reference CLI, on one
device.

Flags ported so far: --model, --tokenizer, --prompt, --steps,
--temperature, --topp, --seed, --weights-float-type, --buffer-float-type
(f32 or q80: q80 passes every matmul input of a layer through the Q80 round
trip), --prefill-chunk N (N > 1: the prompt fills the cache in T=N forward
passes; 0/1: token by token), --fast-prefill (the prompt's chunks of more
than 8 tokens take bf16 products with f32 accumulation; needs
--prefill-chunk N > 1), --kv-cache-dtype {f32,bf16}, --fast (the
on-device token loop: one CUDA graph replay per step, composing with the
flags above), --prompts-file PATH (one prompt per line, decoded in one
lockstep batch; it ignores --prompt and --fast, and --prefill-chunk N > 1
needs --continuous, which is not ported, so it exits 2), and --device
{cuda,cpu} (default cuda; without a GPU the default fails instead of
running on the CPU). DLLAMA_MULTI_T_BODY=dequant selects the bf16-product
body for 2..8-token products (a batch of up to 8 prompts, or a prefill
chunk of up to 8 tokens), as in the JAX package.

On the lockstep path --metrics, --spec-k K and --kv-page-size P print the
JAX package's note that they only apply to the continuous engine, and the
run goes on, as there. Elsewhere they, and every other flag of the JAX
package's ``inference``, exit 2 with "not yet ported" before the model
loads — no flag is accepted and then ignored; that includes the f16/q40
buffer types. --tp 1, --sp 1, --spec-k 0 and --kv-page-size 0 name what
the port runs and are accepted.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.quants import FloatType

_FT = {"f32": FloatType.F32, "f16": FloatType.F16, "q40": FloatType.Q40,
       "q80": FloatType.Q80}

# the JAX package's inference flags the port does not run yet
_UNPORTED_SWITCHES = ("--continuous", "--log-json", "--stream-slices")
_UNPORTED_VALUED = ("--tp-scheme", "--workers", "--save-state",
                    "--resume-state", "--slots",
                    "--block-steps", "--kv-pages",
                    "--spec-ngram", "--dispatch-tokens",
                    "--kv-quant", "--kv-host-pages", "--kv-disk-dir",
                    "--kv-disk-gb", "--profile", "--nthreads",
                    "--coordinator", "--num-hosts", "--host-id",
                    "--serve-weights", "--serve-weights-bind",
                    "--model-from-root")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dllama-torch inference")
    ap.add_argument("--model", required=True,
                    help="path to the reference-format .bin model")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--weights-float-type", default="q40", choices=sorted(_FT))
    ap.add_argument("--buffer-float-type", default="f32", choices=sorted(_FT),
                    help="f32 or q80 (f16/q40 are not ported)")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--topp", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default cuda; the CPU runs "
                         "the kernels' plain versions)")
    ap.add_argument("--tp", type=int, default=1, help="only 1 is ported")
    ap.add_argument("--sp", type=int, default=1, help="only 1 is ported")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="N > 1: prefill the prompt in T=N chunks; 0/1: "
                         "token by token")
    ap.add_argument("--kv-cache-dtype", default="f32", choices=("f32", "bf16"),
                    help="bf16 halves the KV cache and its attention bytes")
    ap.add_argument("--fast-prefill", action="store_true",
                    help="bf16 products (f32 accumulation) for the prompt's "
                         "chunks of more than 8 tokens; needs "
                         "--prefill-chunk N > 1")
    ap.add_argument("--fast", action="store_true",
                    help="the on-device token loop: one CUDA graph replay "
                         "per step, no per-token stats lines")
    ap.add_argument("--prompts-file", default=None, metavar="PATH",
                    help="batch mode: one prompt per line, decoded in one "
                         "lockstep batch; ignores --prompt and --fast")
    # only notes on the lockstep path; not ported elsewhere
    ap.add_argument("--metrics", action="store_true",
                    help="with --prompts-file: a note (nothing to collect)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="with --prompts-file: a note (continuous only)")
    ap.add_argument("--kv-page-size", type=int, default=0, metavar="P",
                    help="with --prompts-file: a note (continuous only)")
    for flag in _UNPORTED_SWITCHES:
        ap.add_argument(flag, action="store_true", default=argparse.SUPPRESS,
                        help="not yet ported")
    for flag in _UNPORTED_VALUED:
        ap.add_argument(flag, nargs="*", default=argparse.SUPPRESS,
                        help="not yet ported")
    return ap


def _unported(args) -> list[str]:
    given = [f for f in _UNPORTED_SWITCHES + _UNPORTED_VALUED
             if f[2:].replace("-", "_") in vars(args)]
    if args.tp != 1:
        given.append(f"--tp {args.tp}")
    if args.sp != 1:
        given.append(f"--sp {args.sp}")
    if args.buffer_float_type not in ("f32", "q80"):
        given.append(f"--buffer-float-type {args.buffer_float_type}")
    if not args.prompts_file:  # the lockstep path's notes, ported there
        if args.metrics:
            given.append("--metrics")
        if args.spec_k:
            given.append(f"--spec-k {args.spec_k}")
        if args.kv_page_size:
            given.append(f"--kv-page-size {args.kv_page_size}")
    return given


def _lockstep_notes(args) -> None:
    """The JAX package's notes for flags that do nothing on the lockstep
    batch path (they belong to the continuous engine)."""
    if args.metrics:
        print("--metrics has nothing to collect on the lockstep batch "
              "path; use --continuous for request-lifecycle metrics",
              file=sys.stderr)
    if args.spec_k:
        print("--spec-k only applies to the continuous engine; use "
              "--continuous (with --kv-page-size) for speculative "
              "decoding", file=sys.stderr)
    if args.kv_page_size:
        print("--kv-page-size/--kv-quant only apply to the "
              "continuous engine; add --continuous for the paged "
              "(and quantized) KV pool", file=sys.stderr)


def cmd_inference(argv: list[str]) -> int:
    args = _parser().parse_args(argv)
    unported = _unported(args)
    if unported:
        print(f"not yet ported: {', '.join(unported)} (this port runs "
              f"single-device inference, token by token, with "
              f"--prefill-chunk N [--fast-prefill] or --fast, or a lockstep "
              f"batch with --prompts-file, with f32 or q80 buffers and an "
              f"f32 or bf16 KV cache)", file=sys.stderr)
        return 2
    if args.spec_k and args.kv_page_size <= 0:
        print("--spec-k needs the paged KV cache: add --kv-page-size P "
              "(with --continuous)", file=sys.stderr)
        return 2
    if args.fast_prefill and args.prefill_chunk <= 1:
        print("--fast-prefill only affects chunked prefill; pass "
              "--prefill-chunk N (N > 1)", file=sys.stderr)
        return 2
    prompts = None
    if args.prompts_file:  # validate before the multi-GB model load
        if args.prefill_chunk > 1:
            # lockstep rows share one position clock: per-row prompt
            # prefill would desync them — only --continuous prefills
            print("--prefill-chunk with --prompts-file needs --continuous "
                  "(lockstep rows share the position clock)",
                  file=sys.stderr)
            return 2
        with open(args.prompts_file) as fh:
            prompts = [ln.rstrip("\n") for ln in fh if ln.strip()]
        if not prompts:
            print("prompts file is empty", file=sys.stderr)
            return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False — pass --device "
              "cpu to run on the CPU", file=sys.stderr)
        return 1

    from ..io.loader import load_model
    from ..io.tokenizer import Tokenizer
    from ..runtime.generate import (Engine, generate, generate_batch,
                                    generate_fast)
    from ..runtime.sampling import Sampler

    t0 = time.perf_counter()
    spec, params = load_model(args.model,
                              weights_float_type=_FT[args.weights_float_type],
                              buffer_float_type=_FT[args.buffer_float_type])
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"💡 dim: {spec.dim}\n💡 hiddenDim: {spec.hidden_dim}\n"
          f"💡 nLayers: {spec.n_layers}\n💡 nHeads: {spec.n_heads}\n"
          f"💡 nKvHeads: {spec.n_kv_heads}\n"
          f"💡 vocabSize: {spec.vocab_size}\n💡 seqLen: {spec.seq_len}\n"
          f"💡 nSlices: 1 (device {args.device}: {where})")
    cache_dtype = (torch.bfloat16 if args.kv_cache_dtype == "bf16"
                   else torch.float32)
    if prompts is not None:  # batch mode: no Engine (its own device path)
        tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
        seed = args.seed if args.seed is not None else int(time.time())
        _lockstep_notes(args)
        generate_batch(spec, params, tokenizer, prompts, args.steps,
                       args.temperature, args.topp, seed,
                       cache_dtype=cache_dtype, device=device)
        return 0
    engine = Engine(spec, params, device, cache_dtype=cache_dtype,
                    fast_prefill=args.fast_prefill)
    del params  # the host copy; the engine holds the device tree
    print(f"⏩ Loaded model in {time.perf_counter() - t0:.1f}s")

    tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
    seed = args.seed if args.seed is not None else int(time.time())
    sampler = Sampler(spec.vocab_size, args.temperature, args.topp, seed)
    run = generate_fast if args.fast else generate
    run(engine, tokenizer, sampler, args.prompt or "", args.steps,
        prefill_chunk=args.prefill_chunk)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: dllama-torch inference [options]\n{__doc__}")
        return 0 if argv else 1
    mode, rest = argv[0], argv[1:]
    if mode == "inference":
        return cmd_inference(rest)
    if mode in ("worker", "serve", "train", "convert"):
        print(f"mode {mode!r} is not yet ported (this port runs 'inference')",
              file=sys.stderr)
        return 2
    print(f"unknown mode {mode!r} (expected inference)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
