"""CLI entry point: the ``inference`` mode of the reference CLI, on one
device.

Flags ported so far: --model, --tokenizer, --prompt, --steps,
--temperature, --topp, --seed, --weights-float-type, --buffer-float-type
(f32 or q80: q80 passes every matmul input of a layer through the Q80 round
trip), --prefill-chunk N (N > 1: the prompt fills the cache in T=N forward
passes; 0/1: token by token), --fast-prefill (the prompt's chunks of more
than 8 tokens take bf16 products with f32 accumulation; needs
--prefill-chunk N > 1), --kv-cache-dtype {f32,bf16}, and --device
{cuda,cpu} (default cuda; without a GPU the default fails instead of
running on the CPU). Every other flag of the JAX package's ``inference``
exits 2 with "not yet ported" before the model loads — no flag is accepted
and then ignored; that includes the f16/q40 buffer types. --tp 1 and
--sp 1 name what the port runs and are accepted.
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
_UNPORTED_SWITCHES = ("--fast", "--continuous", "--metrics", "--log-json",
                      "--stream-slices")
_UNPORTED_VALUED = ("--tp-scheme", "--workers", "--save-state",
                    "--resume-state", "--prompts-file", "--slots",
                    "--block-steps", "--kv-page-size", "--kv-pages",
                    "--spec-k", "--spec-ngram", "--dispatch-tokens",
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
    return given


def cmd_inference(argv: list[str]) -> int:
    args = _parser().parse_args(argv)
    unported = _unported(args)
    if unported:
        print(f"not yet ported: {', '.join(unported)} (this port runs "
              f"single-device inference, token by token or with "
              f"--prefill-chunk N [--fast-prefill], with f32 or q80 buffers "
              f"and an f32 or bf16 KV cache)", file=sys.stderr)
        return 2
    if args.fast_prefill and args.prefill_chunk <= 1:
        print("--fast-prefill only affects chunked prefill; pass "
              "--prefill-chunk N (N > 1)", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False — pass --device "
              "cpu to run on the CPU", file=sys.stderr)
        return 1

    from ..io.loader import load_model
    from ..io.tokenizer import Tokenizer
    from ..runtime.generate import Engine, generate
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
    engine = Engine(spec, params, device, cache_dtype=cache_dtype,
                    fast_prefill=args.fast_prefill)
    del params  # the host copy; the engine holds the device tree
    print(f"⏩ Loaded model in {time.perf_counter() - t0:.1f}s")

    tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
    seed = args.seed if args.seed is not None else int(time.time())
    sampler = Sampler(spec.vocab_size, args.temperature, args.topp, seed)
    generate(engine, tokenizer, sampler, args.prompt or "", args.steps,
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
