"""CLI entry point: the ``inference`` and ``worker`` modes of the reference
CLI, on one device or tensor-parallel over ranks, and ``convert``.

Flags ported so far: --model, --tokenizer, --prompt, --steps,
--temperature, --topp, --seed, --weights-float-type, --buffer-float-type
(q80 passes every matmul input of a layer through the Q80 round trip; f32,
f16 and q40 run the f32 program, as the JAX package acts on the buffer
type only at Q80), --prefill-chunk N (N > 1: the prompt fills the cache in T=N forward
passes; 0/1: token by token), --fast-prefill (the prompt's chunks of more
than 8 tokens take bf16 products with f32 accumulation; needs
--prefill-chunk N > 1), --kv-cache-dtype {f32,bf16}, --fast (the
on-device token loop: one CUDA graph replay per step, composing with the
flags above), --prompts-file PATH (one prompt per line, decoded in one
lockstep batch; it ignores --prompt and --fast), and --device {cuda,cpu}
(default cuda; without a GPU the default fails instead of running on the
CPU). DLLAMA_MULTI_T_BODY=dequant selects the bf16-product body for 2..8-
token products (a batch of up to 8 prompts, or a prefill chunk of up to 8
tokens), as in the JAX package.

With --prompts-file, --continuous runs the continuous-batching engine:
--slots N (0 = min(#prompts, 8)), --block-steps K (K fused steps per
dispatch), --prefill-chunk N [--fast-prefill] (admission prefill),
--kv-cache-dtype, and with --kv-page-size P the paged KV pool with radix
prefix sharing, sized by --kv-pages N and stored as --kv-quant f32|q8
(DLLAMA_KV_QUANT when the flag is absent, read once here). The JAX CLI's
checks and messages come with them: q8 without a page size, --continuous or
--slots without a prompts file and negative slots exit 2, and
--prefill-chunk with --prompts-file needs --continuous.

On the lockstep path --metrics, --spec-k K and --kv-page-size P print the
JAX package's note that they only apply to the continuous engine, and the
run goes on, as there; --slots, --block-steps and --kv-pages are ignored
there, as in the JAX CLI. --continuous --kv-pages N without --kv-page-size
reaches the engine, which raises ValueError after the load, as the JAX
package's ContinuousEngine does. --nthreads is accepted and ignored, as in
the JAX CLI. With --continuous, --spec-k and --metrics exit 2 "not yet
ported"; without --prompts-file every flag of the continuous engine does.
Tensor parallelism: --tp N runs N ranks, one process each (spawned here):
rank r on cuda:r over NCCL, or with --device cpu N gloo ranks on the CPU.
--tp-scheme ref|fused|overlap (= DLLAMA_TP_SCHEME) picks the collectives
(parallel/tp.py). --tp defaults to 1 on one host: the JAX CLI's default
(every local device for a single prompt) waits until the tp path is as
fast as one card and captures its steps, so a larger tp is only taken
when asked for. With --coordinator the default is every visible device on
every host, as in the JAX CLI. --tp above the visible GPUs exits 2 naming
both counts. Each rank reads only its weight bands from the file; every
rank runs the loop and samples the same coins (without --seed the
spawning process picks the seed once and hands it to every rank), and
rank 0 prints. Several hosts: --coordinator host:port --num-hosts H
--host-id i on each (host i runs ranks i*tp/H .. (i+1)*tp/H - 1 over the
coordinator's TCP store; an explicit --seed is required); ``worker`` is
the same program with its output silenced, and --workers is accepted and
ignored, as in the JAX CLI. A caller may pass its own group to
``cmd_inference(argv, group=...)`` (chip_smoke.py's gloo ranks sharing one
card); its ranks then need an explicit --seed. A CUDA graph over the
group's collectives is not yet ported: under tp on the card the lockstep
batch and the continuous engine run their steps eagerly and say so, and
--fast exits 2 (it runs eagerly on the CPU, as without tp). --profile,
--save-state and --resume-state are not yet ported above tp 1, nor --sp
above 1.

Every other flag of the JAX package's ``inference`` exits 2 with "not yet
ported" before the model loads; that includes --dispatch-tokens, the KV
tier flags, --stream-slices and the weight-serving flags. --sp 1,
--spec-k 0, --kv-page-size 0, --dispatch-tokens 0, --kv-host-pages 0 and
--spec-ngram N without --spec-k name what the port runs and are accepted,
as the JAX CLI runs its plain path at those values.

``convert`` is the port's converter (convert.py): Meta or HF checkpoints
to a reference-format .bin.

DLLAMA_LAYER_FUSION=headtail|on (read once by the Engine, as the JAX
package reads it) runs each T=1 step of the token-by-token loop and of
--fast through the fused decode-layer kernels (ops/layer.py).

On the single-prompt path (token by token or --fast), --profile DIR
(DLLAMA_PROFILE_DIR when the flag is absent, read once here) traces the
whole generation with torch.profiler into DIR (obs/profiler.trace), then
prints the reference-shaped I/T split of that trace (utils/it_split.py);
--save-state PATH writes a resumable checkpoint after the run
(runtime/checkpoint.py) and --resume-state PATH continues one (--prompt
is then ignored; --steps more positions run). With --prompts-file the
three are ignored, as the JAX CLI's batch branches return before them.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from ..ops.quants import FloatType
from ..parallel.comm_stats import SCHEMES

_FT = {"f32": FloatType.F32, "f16": FloatType.F16, "q40": FloatType.Q40,
       "q80": FloatType.Q80}

# the JAX package's inference flags the port does not run yet
_UNPORTED_SWITCHES = ("--log-json", "--stream-slices")
_UNPORTED_VALUED = ("--kv-disk-dir", "--kv-disk-gb", "--serve-weights",
                    "--serve-weights-bind", "--model-from-root")
# unported flags that take the JAX CLI's type, and the value at which the
# JAX CLI runs the path the port has (None: any value, while --spec-k is
# off, as the n-gram drafter runs only under --spec-k); other values are
# not yet ported
_NEUTRAL_VALUED = {"--dispatch-tokens": (int, 0),
                   "--kv-host-pages": (int, 0), "--spec-ngram": (int, None)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dllama-torch inference")
    ap.add_argument("--model", required=True,
                    help="path to the reference-format .bin model")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--weights-float-type", default="q40", choices=sorted(_FT))
    ap.add_argument("--buffer-float-type", default="f32", choices=sorted(_FT),
                    help="q80 passes every matmul input of a layer through "
                         "the Q80 round trip; f32, f16 and q40 run the f32 "
                         "program, as in the JAX CLI")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--topp", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default cuda; the CPU runs "
                         "the kernels' plain versions)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ranks (default 1; with "
                         "--coordinator every visible device on every "
                         "host)")
    ap.add_argument("--tp-scheme", default=None, choices=SCHEMES,
                    help="tp collective schedule (= DLLAMA_TP_SCHEME): "
                         "'fused' (default) pairs column/row-parallel "
                         "matmuls, 2 collectives a layer; 'overlap' splits "
                         "the fused combines into ring hops and defers the "
                         "ffn gather (needs --sp 1); 'ref' keeps the "
                         "reference's 4-gather MatmulSlice schedule")
    ap.add_argument("--sp", type=int, default=1, help="only 1 is ported")
    ap.add_argument("--workers", nargs="*", default=None,
                    help="accepted for reference-CLI compatibility; the "
                         "workers are the ranks (--tp)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the TCP store of a multi-host group (host 0's "
                         "first rank serves it)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--nthreads", type=int, default=4,
                    help="accepted for reference-CLI compatibility; the "
                         "device manages its own threads")
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
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write a resumable generation checkpoint (cache + "
                         "position + RNG) after the run")
    ap.add_argument("--resume-state", default=None, metavar="PATH",
                    help="resume a checkpointed generation (--prompt is "
                         "ignored; --steps more positions run)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the generation with torch.profiler into DIR "
                         "and print its I/T split (DLLAMA_PROFILE_DIR sets "
                         "the same thing without the flag)")
    ap.add_argument("--prompts-file", default=None, metavar="PATH",
                    help="batch mode: one prompt per line, decoded in one "
                         "lockstep batch; ignores --prompt and --fast")
    ap.add_argument("--continuous", action="store_true",
                    help="with --prompts-file: continuous batching — a pool "
                         "of --slots cache slots with per-slot position "
                         "clocks; finished rows are replaced mid-flight by "
                         "queued prompts")
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous-batching slot count (default: "
                         "min(#prompts, 8))")
    ap.add_argument("--block-steps", type=int, default=1, metavar="K",
                    help="with --continuous: fuse K decode steps into one "
                         "device dispatch (admission/retirement at chain "
                         "boundaries)")
    ap.add_argument("--kv-page-size", type=int, default=0, metavar="P",
                    help="with --continuous: paged KV cache — slots map "
                         "P-position pages from a shared pool through page "
                         "tables, with radix-tree prefix sharing (0 = "
                         "contiguous per-slot cache); with the lockstep "
                         "batch, a note")
    ap.add_argument("--kv-pages", type=int, default=0, metavar="N",
                    help="paged-KV pool size in pages (default: slots * "
                         "seq_len / page-size; fewer pages serve more "
                         "slots at equal memory)")
    ap.add_argument("--kv-quant", default=None, choices=("f32", "q8"),
                    help="KV PAGE quantization (= DLLAMA_KV_QUANT; needs "
                         "--kv-page-size): q8 stores pool pages as Q80 "
                         "int8 codes and f16 deltas, ~1/3.8 of f32 page "
                         "bytes")
    # notes on the lockstep path; not ported elsewhere
    ap.add_argument("--metrics", action="store_true",
                    help="with --prompts-file: a note (nothing to collect)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="with --prompts-file: a note (continuous only)")
    for flag in _UNPORTED_SWITCHES:
        ap.add_argument(flag, action="store_true", default=argparse.SUPPRESS,
                        help="not yet ported")
    for flag in _UNPORTED_VALUED:
        ap.add_argument(flag, nargs="*", default=argparse.SUPPRESS,
                        help="not yet ported")
    for flag, (kind, neutral) in _NEUTRAL_VALUED.items():
        ap.add_argument(flag, type=kind, default=argparse.SUPPRESS,
                        help="not yet ported; the JAX CLI's plain path" + (
                            f" at {neutral}" if neutral is not None else
                            " without --spec-k") + " runs")
    return ap


def _unported(args) -> list[str]:
    given = [f for f in _UNPORTED_SWITCHES + _UNPORTED_VALUED
             if f[2:].replace("-", "_") in vars(args)]
    for flag, (_, neutral) in _NEUTRAL_VALUED.items():
        value = vars(args).get(flag[2:].replace("-", "_"))
        if value is None:
            continue
        if value != neutral and (neutral is not None or args.spec_k):
            given.append(f"{flag} {value}")
    if args.sp != 1:
        given.append(f"--sp {args.sp}")
    if args.continuous:  # the continuous engine's unported options
        if args.metrics:
            given.append("--metrics")
        if args.spec_k:
            given.append(f"--spec-k {args.spec_k}")
    elif not args.prompts_file:  # flags of the batch paths, ported there
        for flag, value, neutral in (
                ("--metrics", args.metrics, False),
                ("--spec-k", args.spec_k, 0),
                ("--kv-page-size", args.kv_page_size, 0),
                ("--kv-pages", args.kv_pages, 0),
                ("--block-steps", args.block_steps, 1),
                ("--kv-quant", args.kv_quant, None)):
            if value != neutral:
                given.append(flag if value is True else f"{flag} {value}")
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
    if args.kv_page_size or args.kv_quant != "f32":
        print("--kv-page-size/--kv-quant only apply to the "
              "continuous engine; add --continuous for the paged "
              "(and quantized) KV pool", file=sys.stderr)


def cmd_inference(argv: list[str], quiet: bool = False,
                  group=None) -> int:
    """``inference``: validate the flags, then run in this process (one
    device, or ``group``, a parallel/mesh.TPGroup the caller built), or
    spawn this host's tensor-parallel ranks, each running this function
    with its own group."""
    args = _parser().parse_args(argv)
    from ..parallel.comm_stats import tp_scheme

    try:  # validate the scheme (flag or env) before anything else
        scheme = args.tp_scheme or tp_scheme()
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    if scheme == "overlap" and args.sp > 1:
        print("--tp-scheme overlap needs --sp 1: the ring-decomposed "
              "combines assume un-chunked sequences (use --tp-scheme "
              "fused with sp>1)", file=sys.stderr)
        return 2
    unported = _unported(args)
    if unported:
        print(f"not yet ported: {', '.join(unported)} (this port runs "
              f"inference on one device or tensor-parallel ranks (--tp), "
              f"token by token, with "
              f"--prefill-chunk N [--fast-prefill] or --fast, a lockstep "
              f"batch with --prompts-file, or continuous batching with "
              f"--prompts-file --continuous [--kv-page-size P], with f32 or "
              f"q80 buffers (f16 and q40 run f32) and an f32 or bf16 KV "
              f"cache or q8 pages)",
              file=sys.stderr)
        return 2
    # DLLAMA_KV_QUANT is read once, here, when the flag is absent
    from ..ops.paged_attention import kv_quant_mode

    args.kv_quant = args.kv_quant or kv_quant_mode()
    if args.spec_k and args.kv_page_size <= 0:
        print("--spec-k needs the paged KV cache: add --kv-page-size P "
              "(with --continuous)", file=sys.stderr)
        return 2
    if args.kv_quant == "q8" and args.kv_page_size <= 0:
        print("--kv-quant q8 quantizes paged KV pages: add "
              "--kv-page-size P (with --continuous)", file=sys.stderr)
        return 2
    if (args.continuous or args.slots) and not args.prompts_file:
        print("--continuous/--slots need --prompts-file (the request "
              "queue)", file=sys.stderr)
        return 2
    if args.slots < 0:
        print(f"--slots must be non-negative (0 = auto: min(#prompts, 8)), "
              f"got {args.slots}", file=sys.stderr)
        return 2
    if args.fast_prefill and args.prefill_chunk <= 1:
        print("--fast-prefill only affects chunked prefill; pass "
              "--prefill-chunk N (N > 1)", file=sys.stderr)
        return 2
    if args.coordinator and args.seed is None:
        # every rank samples the same chain, or ranks stop at different
        # steps and the collectives hang
        print("multi-host runs need an explicit --seed so every host "
              "samples the same chain", file=sys.stderr)
        return 2
    if args.num_hosts != 1 and not args.coordinator:
        print(f"--num-hosts {args.num_hosts} needs --coordinator "
              f"host:port", file=sys.stderr)
        return 2
    if args.host_id:  # non-root hosts run silently in lockstep
        quiet = True
    if args.profile is None:  # one-shot env hook (obs/profiler.py)
        from ..obs.profiler import env_profile_dir

        args.profile = env_profile_dir()
    prompts = None
    if args.prompts_file:  # validate before the multi-GB model load
        if args.prefill_chunk > 1 and not args.continuous:
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
    tp = _resolve_tp(args, prompts, group)
    if isinstance(tp, str):
        print(tp, file=sys.stderr)
        return 2
    if tp > 1:
        above = [flag for flag, on in (("--profile", args.profile),
                                       ("--save-state", args.save_state),
                                       ("--resume-state", args.resume_state),
                                       ("--fast", args.fast
                                        and args.device == "cuda"))
                 if on]
        if above:
            print(f"not yet ported: {', '.join(above)} with --tp {tp} (one "
                  f"device only)", file=sys.stderr)
            return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False — pass --device "
              "cpu to run on the CPU", file=sys.stderr)
        return 1
    if group is not None and group.size > 1 and args.seed is None:
        print("a caller's tp group needs an explicit --seed so every rank "
              "samples the same chain", file=sys.stderr)
        return 2
    if group is None and (tp > 1 or args.coordinator):
        if args.seed is None:  # one seed for every rank, picked here
            argv = [*argv, "--seed", str(_default_seed())]
        return _spawn_ranks(argv, args, tp, quiet)
    return _run(args, prompts, quiet, group, scheme, tp)


def _default_seed() -> int:
    """The seed of a run without --seed."""
    return int(time.time())


def _resolve_tp(args, prompts, group) -> int | str:
    """The rank count, or the error that exits 2: a caller's group fixes
    it; otherwise --tp, defaulting to 1 on one host and under
    --coordinator (as the JAX CLI) to every local device on every host for
    a single prompt and to 1 under --prompts-file, and checked against the
    visible devices."""
    from ..parallel.mesh import check_tp, visible_devices

    if group is not None:
        if args.tp not in (None, group.size):
            return f"--tp {args.tp} but the caller's group has {group.size} " \
                   f"ranks"
        return group.size
    tp = args.tp
    if tp is None:
        local = visible_devices(args.device) or 1
        tp = (local * args.num_hosts if args.coordinator
              and prompts is None else 1)
    return check_tp(tp, args.device, args.num_hosts) or tp


def _spawn_ranks(argv: list[str], args, tp: int, quiet: bool) -> int:
    """This host's ranks, one spawned process each, over a TCP store on
    localhost (one host) or at --coordinator; the exit code is the first
    failing rank's."""
    import torch.multiprocessing as mp

    from ..parallel.mesh import free_port, local_ranks

    ranks = local_ranks(tp, args.num_hosts, args.host_id or 0)
    init = (f"tcp://{args.coordinator}" if args.coordinator
            else f"tcp://localhost:{free_port()}")
    try:
        mp.start_processes(_rank_main, args=(argv, init, tp, ranks.start,
                                             args.device, quiet),
                           nprocs=len(ranks), start_method="spawn")
    except mp.ProcessExitedException as e:
        return e.exit_code if e.exit_code and e.exit_code > 0 else 1
    except mp.ProcessRaisedException as e:
        print(f"a tp rank failed: {e}", file=sys.stderr)
        return 1
    return 0


def _rank_main(local: int, argv: list[str], init: str, tp: int, first: int,
               device_type: str, quiet: bool) -> None:
    """A spawned rank: join the group, run inference, leave."""
    from ..parallel.mesh import close, init_rank

    rank = first + local
    group = init_rank(rank, tp, init, device_type, local=local)
    try:
        rc = cmd_inference(argv, quiet=quiet or rank != 0, group=group)
    finally:
        sys.stdout.flush()
        close(group)
    if rc:
        raise SystemExit(rc)


def _run(args, prompts, quiet: bool, group, scheme: str, tp: int) -> int:
    """Load (the rank's bands under tp > 1), then generate."""
    from ..io.loader import load_model
    from ..io.tokenizer import Tokenizer
    from ..parallel.mesh import single
    from ..parallel.tp import load_model_bands
    from ..runtime.generate import (Engine, generate, generate_batch,
                                    generate_fast)
    from ..runtime.sampling import Sampler

    say = (lambda *a, **k: None) if quiet else print
    t0 = time.perf_counter()
    wft, bft = _FT[args.weights_float_type], _FT[args.buffer_float_type]
    group = group or single(args.device)
    sharded = group.size > 1
    if sharded:
        spec, params = load_model_bands(args.model, group.rank, group.size,
                                        scheme, wft, bft)
    else:
        spec, params = load_model(args.model, weights_float_type=wft,
                                  buffer_float_type=bft)
    device = group.device
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    ranks = (f"{tp} {device.type} ranks over {group.backend}: {where}"
             if sharded else f"device {args.device}: {where}")
    say(f"💡 dim: {spec.dim}\n💡 hiddenDim: {spec.hidden_dim}\n"
        f"💡 nLayers: {spec.n_layers}\n💡 nHeads: {spec.n_heads}\n"
        f"💡 nKvHeads: {spec.n_kv_heads}\n"
        f"💡 vocabSize: {spec.vocab_size}\n💡 seqLen: {spec.seq_len}\n"
        f"💡 nSlices: {tp} sp: 1 scheme: {scheme if sharded else '-'} "
        f"({ranks})")
    # under tp the batch engines' steps run eagerly: a CUDA graph over the
    # group's collectives is not yet ported (--fast is refused above)
    tp_args = dict(group=group, scheme=scheme,
                   graph=False) if sharded else {}
    cache_dtype = (torch.bfloat16 if args.kv_cache_dtype == "bf16"
                   else torch.float32)
    if prompts is not None:  # batch mode: no Engine (its own device path)
        tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
        seed = args.seed if args.seed is not None else _default_seed()
        if sharded and device.type == "cuda":
            say(f"💡 the steps run eagerly under --tp {tp}: a CUDA graph "
                f"over the group's collectives is not yet ported")
        if args.continuous:
            from ..runtime.continuous import generate_continuous

            if sharded:
                tp_args["mesh"] = tp_args.pop("group")
            generate_continuous(spec, params, tokenizer, prompts, args.steps,
                                args.temperature, args.topp, seed,
                                slots=args.slots, cache_dtype=cache_dtype,
                                prefill_chunk=args.prefill_chunk,
                                block_steps=args.block_steps,
                                fast_prefill=args.fast_prefill,
                                page_size=args.kv_page_size,
                                kv_pages=args.kv_pages,
                                kv_quant=args.kv_quant, device=device,
                                quiet=quiet, **tp_args)
            return 0
        if not quiet:
            _lockstep_notes(args)
        generate_batch(spec, params, tokenizer, prompts, args.steps,
                       args.temperature, args.topp, seed,
                       cache_dtype=cache_dtype, device=device, quiet=quiet,
                       **tp_args)
        return 0
    engine = Engine(spec, params, device, cache_dtype=cache_dtype,
                    fast_prefill=args.fast_prefill,
                    **{k: v for k, v in tp_args.items() if k != "graph"})
    del params  # the host copy; the engine holds the device tree
    say(f"⏩ Loaded model in {time.perf_counter() - t0:.1f}s")

    tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
    seed = args.seed if args.seed is not None else _default_seed()
    sampler = Sampler(spec.vocab_size, args.temperature, args.topp, seed)
    resume, prev, rest = None, [], None
    if args.resume_state:
        from ..runtime.checkpoint import load_generation_state

        pos0, tok0, prev, rest = load_generation_state(args.resume_state,
                                                       engine, sampler)
        resume = (pos0, tok0)
        say(f"⏩ Resumed at pos {pos0} ({len(prev)} tokens so far)")
    prof = contextlib.nullcontext()
    if args.profile:
        from ..obs.profiler import trace

        prof = trace(args.profile, cuda=device.type == "cuda")
    run = generate_fast if args.fast else generate
    with prof:
        out, stats = run(engine, tokenizer, sampler, args.prompt or "",
                         args.steps, quiet=quiet,
                         prefill_chunk=args.prefill_chunk,
                         resume=resume, resume_prompt=rest)
    if args.profile:
        _print_split(args, tokenizer, stats, rest if resume else None)
    if args.save_state:
        from ..io.tokenizer import BOS
        from ..runtime.checkpoint import save_generation_state

        if stats.final_pos > 0 and stats.final_token != BOS:
            save_generation_state(args.save_state, engine, sampler,
                                  stats.final_pos, stats.final_token,
                                  prev + out, stats.prompt_rest)
            say(f"⏩ Saved generation state to {args.save_state}")
        else:
            say("💡 Generation ended (BOS or zero steps); nothing "
                "resumable to save")
    return 0


def cmd_worker(argv: list[str]) -> int:
    """A host of a multi-host group: the same program as ``inference``,
    silenced (only host 0's rank 0 prints)."""
    if "--port" in argv:  # accepted for reference-CLI compatibility
        i = argv.index("--port")
        argv = argv[:i] + argv[i + 2:]
    if "--coordinator" not in argv:
        print("💡 On one host the workers are the ranks of the group — run "
              "'inference --tp N' instead. For several hosts, pass the same "
              "flags as inference plus --coordinator host:port "
              "--num-hosts H --host-id I (I >= 1).", file=sys.stderr)
        return 2
    return cmd_inference(argv, quiet=True)


def _print_split(args, tokenizer, stats, rest: list[int] | None) -> None:
    """After a --profile run: where the trace went and its I/T split per
    generated token. The trace wraps the whole generate call, so a
    prefilled prompt's chunks are inside it and the line says so (a resumed
    run prefills only its unconsumed prompt tail, ``rest``). A trace that
    does not parse prints a note and the run still succeeds."""
    print(f"⏩ Profiler trace written to {args.profile}")
    try:
        from ..utils.it_split import parse_trace, summarize

        n_prompt = (len(rest) if rest is not None
                    else len(tokenizer.encode(args.prompt or "", bos=True,
                                              eos=False)))
        note = (f"; trace includes ~{n_prompt}-token prompt prefill"
                if n_prompt > 1 else "")
        summarize(parse_trace(args.profile), tokens=max(stats.tokens, 1),
                  note=note)
    except Exception as e:  # a malformed trace must not fail the run
        print(f"💡 I/T split unavailable ({type(e).__name__}: {e}); run "
              f"python3 -m distributed_llama_tpu_torch.utils.it_split on "
              f"the trace dir", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: dllama-torch {{inference|worker|convert}} "
              f"[options]\n{__doc__}")
        return 0 if argv else 1
    mode, rest = argv[0], argv[1:]
    if mode == "inference":
        return cmd_inference(rest)
    if mode == "worker":
        return cmd_worker(rest)
    if mode == "convert":
        from ..convert import main as convert_main

        try:
            convert_main(rest)
        except SystemExit as e:  # argparse's usage errors
            return e.code if isinstance(e.code, int) else 1
        return 0
    if mode in ("serve", "train"):
        print(f"mode {mode!r} is not yet ported (this port runs "
              f"'inference', 'worker' and 'convert')", file=sys.stderr)
        return 2
    print(f"unknown mode {mode!r} (expected inference|worker|convert)",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
