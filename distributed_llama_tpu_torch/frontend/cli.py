"""CLI entry point: the ``inference`` and ``worker`` modes of the reference
CLI, on one device or tensor-parallel over ranks, ``serve`` (the HTTP
server over the continuous engine, runtime/server.py), ``train`` and
``convert``.

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
(DLLAMA_KV_QUANT when the flag is absent, read once here), and over the
pages --spec-k K [--spec-ngram N] (speculative decoding: K-query verify
dispatches of n-gram drafts, runtime/speculative.py) or --dispatch-tokens
T|-1 (token-budget mixed dispatches), which print the JAX CLI's
"Speculative:" and "Token budget:" lines. The JAX CLI's checks and
messages come with them: q8, --spec-k or --dispatch-tokens without a page
size, --spec-k with --dispatch-tokens, --continuous or --slots without a
prompts file and negative slots exit 2, and --prefill-chunk with
--prompts-file needs --continuous.

--metrics prints the run's Prometheus exposition on stderr (with
--continuous the engine's metrics and the request lifecycle, on one prompt
the per-token latency), and --log-json (= DLLAMA_LOG_JSON=1) turns the 🔶
lines into NDJSON events, as in the JAX CLI. On the lockstep path
--metrics, --spec-k K and --kv-page-size P print the JAX package's note
that they only apply to the continuous engine, and the run goes on, as
there; --slots, --block-steps, --kv-pages and
--dispatch-tokens are ignored there, as in the JAX CLI. --continuous
--kv-pages N without --kv-page-size reaches the engine, which raises
ValueError after the load, as the JAX package's ContinuousEngine does.
--nthreads is accepted and ignored, as in the JAX CLI. Without
--prompts-file the continuous engine's flags go through the JAX CLI's
checks (q8, --spec-k or --dispatch-tokens without a page size exit 2 with
its message) and are then ignored by the single-prompt path, as there.
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
--fast exits 2 (it runs eagerly on the CPU, as without tp). Under tp,
--profile DIR traces each rank into DIR/rank<r> and fails the run (1)
where a rank's trace holds no collective time or other collective events
than the census; --save-state gathers the kv heads to rank 0, which
writes the file, and --resume-state gives every rank its band, so a
checkpoint moves between tp sizes. Sequence parallelism: --sp S runs S x
tp ranks (global rank = sp index x tp + tp index, parallel/mesh.init_mesh)
whose KV cache holds seq_len / S positions each (parallel/ring.py), for
the single prompt, the lockstep batch and the contiguous continuous
engine; the paged pool raises the JAX package's ValueError, and the
overlap scheme exits 2 with its message. --save-state gathers the
position chunks too.

Weight streaming, as in the JAX CLI: --serve-weights PORT
[--serve-weights-bind ADDR] serves the --model file's bytes (io/stream.py)
while the run lasts; --model-from-root HOST:PORT fetches the file into
the --model path first (fetch_model keeps a complete local copy), and with
--stream-slices (an explicit --tp > 1, equal ranks per host) only the byte
ranges this host's ranks read under the tp scheme. Both run once a host,
before its ranks join the group (which then waits up to 3600 s for a
peer that is still fetching); each rank then checks that its bands were
the ones fetched and exits 2 before loading if not.

The KV tier flags (--kv-host-pages N, --kv-disk-dir DIR, --kv-disk-gb G)
run with --prompts-file --continuous --kv-page-size P, on one device or
under --tp (each rank tiers its own kv-head band; its disk tier lives in
DIR/rank<r>), with the JAX CLI's checks and messages; the lockstep batch
ignores them, as the JAX CLI does.

Every flag of the JAX package's ``inference`` is ported.

``serve`` takes the JAX CLI's flags on one device (--device cuda by
default): --host, --port (0 picks a free one; the 🌐 line names it),
--slots, --steps, the sampling flags, the continuous engine's (pages,
chunk, chains, --spec-k, --dispatch-tokens, --kv-quant, --fast-prefill),
--metrics/--no-metrics, --slo SPEC|off (default the serving policy),
--journal PATH [--journal-fsync] (opened before the load; exit 1 on a
corrupt journal or a config mismatch), --watchdog-ms, --drain-s,
--flightrec DIR, --watch-interval, --log-json, --supervise
[--max-restarts N], the KV tier flags, and prefill/decode disaggregation:
--disagg-role prefill|decode, --disagg-peer HOST:PORT,
--page-channel-port PORT and --handoff-min-pages N (a 🌐 line names the
role), and --chaos SPEC (runtime/chaos.ChaosMonkey.parse; a 🔶 CHAOS ARMED
banner on stderr), and --tp N (this process rank 0, the other ranks
spawned followers of its plans, runtime/tp_plan.py; NCCL with a GPU a
rank, gloo on the CPU or where ranks outnumber the visible GPUs, which
they then share: the 🌐 tp line says which). The JAX CLI's exit-2
checks and messages come in its order.

``train`` is the JAX CLI's training mode (parallel/train.py) with its
flags (--model --tokenizer --data --weights-float-type --steps --batch
--seq --learning-rate --seed --dp --tp --save-state --resume-state and
the common --nthreads --coordinator --num-hosts --host-id
--serve-weights --serve-weights-bind --model-from-root --stream-slices)
and --device: the weights densified to f32, --dp x --tp ranks spawned
as for inference (gloo on the CPU; NCCL with a GPU a rank, refused when
the host has too few), the windows of a step a pure function of (--seed,
step), the JAX CLI's checks, exit codes, messages and 🔶/⏩ lines, and
checkpoints either CLI resumes.

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
import os
import sys
import time

import torch

from ..ops.quants import FloatType
from ..parallel import collectives
from ..parallel.comm_stats import SCHEMES

_FT = {"f32": FloatType.F32, "f16": FloatType.F16, "q40": FloatType.Q40,
       "q80": FloatType.Q80}

def _add_kv_tier_flags(ap: argparse.ArgumentParser) -> None:
    """The KV tiers' flags, shared by inference --continuous and serve
    (the JAX CLI's). All need --kv-page-size: tiering spills PAGES."""
    ap.add_argument("--kv-host-pages", type=int, default=0, metavar="N",
                    help="KV tiering (needs --kv-page-size): a pinned "
                         "host-RAM pool of N pages; cold radix-tree prefix "
                         "pages demote here (write-behind) instead of "
                         "dropping, and promote back on a prefix hit by "
                         "an upload on a copy stream (0 = no host tier)")
    ap.add_argument("--kv-disk-dir", default=None, metavar="DIR",
                    help="KV tiering: spill directory of the disk tier; "
                         "host-pressure-cold pages land in append-only "
                         "segment files with per-page read-back CRC32 "
                         "sidecars (a damaged page re-derives via "
                         "prefill, never serves wrong bytes)")
    ap.add_argument("--kv-disk-gb", type=float, default=0.0, metavar="G",
                    help="live-byte budget of the disk tier in GiB (needs "
                         "--kv-disk-dir; 0 = uncapped)")


def _check_kv_tier_args(args, where: str) -> str | None:
    """The JAX CLI's checks of the tier flags, before any load: an error
    string or None."""
    if (args.kv_host_pages or args.kv_disk_dir) and args.kv_page_size <= 0:
        return (f"--kv-host-pages/--kv-disk-dir spill paged KV: add "
                f"--kv-page-size P{where}")
    if args.kv_disk_gb and not args.kv_disk_dir:
        return "--kv-disk-gb needs --kv-disk-dir (where else would it go?)"
    if args.kv_host_pages < 0 or args.kv_disk_gb < 0:
        return "--kv-host-pages/--kv-disk-gb must be >= 0"
    return None


def _obs_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--log-json", action="store_true",
                    help="emit runtime narration (🌐/⏩/🔶 lines) as "
                         "newline-delimited JSON events instead of emoji "
                         "text (same as DLLAMA_LOG_JSON=1)")


def _apply_log_json(args) -> None:
    if getattr(args, "log_json", False):
        os.environ["DLLAMA_LOG_JSON"] = "1"


def _add_common(ap: argparse.ArgumentParser) -> None:
    """The JAX CLI's ``_add_common`` flags: --nthreads, the multi-host
    group and weight streaming."""
    ap.add_argument("--nthreads", type=int, default=4,
                    help="accepted for reference-CLI compatibility; the "
                         "device manages its own threads")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the TCP store of a multi-host group (host 0's "
                         "first rank serves it)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--serve-weights", type=int, default=None, metavar="PORT",
                    help="(root) serve the model file's bytes on PORT so "
                         "hosts without a local copy can fetch it — the "
                         "reference's root->worker weight streaming "
                         "(transformer.cpp:250-273). UNAUTHENTICATED, like "
                         "the reference's socket protocol: run it on a "
                         "trusted LAN only, and restrict the interface with "
                         "--serve-weights-bind")
    ap.add_argument("--serve-weights-bind", default="0.0.0.0", metavar="ADDR",
                    help="interface the weight server listens on (default "
                         "all; bind a cluster-internal address to keep the "
                         "unauthenticated byte service off public networks)")
    ap.add_argument("--model-from-root", default=None, metavar="HOST:PORT",
                    help="(worker) fetch the model from the root's "
                         "--serve-weights endpoint into the --model path "
                         "when that file is absent (zero local model files, "
                         "like reference workers, transformer.cpp:354-380)")
    ap.add_argument("--stream-slices", action="store_true",
                    help="with --model-from-root: fetch ONLY this host's "
                         "tp weight bands (~1/tp of the matmul bytes, like "
                         "the reference's per-worker slice scatter, "
                         "transformer.cpp:250-273) instead of the whole "
                         "file. Needs an explicit --tp and equal devices "
                         "per host; the run cross-checks the assumed ranks "
                         "against the actual group and aborts on mismatch")


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
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ways: the KV cache sharded over "
                         "sp ranks in position chunks, attention combined "
                         "by an LSE reduction (sp x tp ranks in all)")
    ap.add_argument("--workers", nargs="*", default=None,
                    help="accepted for reference-CLI compatibility; the "
                         "workers are the ranks (--tp)")
    _add_common(ap)
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
    ap.add_argument("--metrics", action="store_true",
                    help="print the run's Prometheus exposition on stderr "
                         "(request lifecycle and engine metrics with "
                         "--continuous, per-token latency on one prompt; "
                         "a note on the lockstep batch)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="with --continuous and --kv-page-size: "
                         "self-speculative decoding — draft up to K-1 "
                         "tokens per row (n-gram prompt lookup, no second "
                         "model) and verify them with the current token "
                         "in ONE K-query dispatch; lossless (greedy "
                         "streams equal, sampled rows keep the sampler's "
                         "distribution via rejection sampling). Supersedes "
                         "--block-steps (0 = off); on the lockstep batch a "
                         "note")
    ap.add_argument("--spec-ngram", type=int, default=None, metavar="N",
                    help="longest n-gram the speculative drafter matches "
                         "against the emitted stream (falls back to "
                         "shorter n-grams down to 1; default 3)")
    ap.add_argument("--dispatch-tokens", type=int, default=0, metavar="T",
                    help="with --continuous and --kv-page-size: "
                         "token-budget mixed dispatches — every device "
                         "step carries all active decode rows (1 token "
                         "each) plus ONE prefill slice cut to the "
                         "remaining budget of T tokens, in a single "
                         "fused forward (prefill no longer stalls "
                         "in-flight decodes behind a separate chunk "
                         "dispatch). -1 sizes from --prefill-chunk; "
                         "0 = off. Incompatible with --spec-k")
    _add_kv_tier_flags(ap)
    _obs_flags(ap)
    return ap


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
                  group=None, streamed: bool = False) -> int:
    """``inference``: validate the flags, then run in this process (one
    device, or ``group``, a parallel/mesh.TPGroup the caller built), or
    spawn this host's tensor-parallel ranks, each running this function
    with its own group. The weight server and fetch run once, in the
    process that spawns or runs (``streamed``: the spawning process ran
    them)."""
    args = _parser().parse_args(argv)
    from ..parallel.comm_stats import tp_scheme

    try:  # validate the scheme (flag or env) before anything else
        scheme = args.tp_scheme or tp_scheme()
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    _apply_log_json(args)
    # DLLAMA_KV_QUANT is read once, here, when the flag is absent
    from ..ops.paged_attention import kv_quant_mode

    args.kv_quant = args.kv_quant or kv_quant_mode()
    if args.spec_k and args.kv_page_size <= 0:
        print("--spec-k needs the paged KV cache: add --kv-page-size P "
              "(with --continuous)", file=sys.stderr)
        return 2
    if args.spec_k and args.dispatch_tokens:
        print("--spec-k is incompatible with --dispatch-tokens: the "
              "verify window and the prefill slice both claim the "
              "per-row span (drop one)", file=sys.stderr)
        return 2
    if args.dispatch_tokens and args.kv_page_size <= 0:
        print("--dispatch-tokens needs the paged KV cache: add "
              "--kv-page-size P (with --continuous)", file=sys.stderr)
        return 2
    if args.kv_quant == "q8" and args.kv_page_size <= 0:
        print("--kv-quant q8 quantizes paged KV pages: add "
              "--kv-page-size P (with --continuous)", file=sys.stderr)
        return 2
    tier_err = _check_kv_tier_args(args, " (with --continuous)")
    if tier_err:
        print(tier_err, file=sys.stderr)
        return 2
    if scheme == "overlap" and args.sp > 1:
        print("--tp-scheme overlap needs --sp 1: the ring-decomposed "
              "combines assume un-chunked sequences (use --tp-scheme "
              "fused with sp>1)", file=sys.stderr)
        return 2
    if args.coordinator and args.seed is None:
        # every rank samples the same chain, or ranks stop at different
        # steps and the collectives hang
        print("multi-host runs need an explicit --seed so every host "
              "samples the same chain", file=sys.stderr)
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
    if args.num_hosts != 1 and not args.coordinator:
        print(f"--num-hosts {args.num_hosts} needs --coordinator "
              f"host:port", file=sys.stderr)
        return 2
    assumed = None  # the tp ranks whose bands --stream-slices fetches
    if args.stream_slices:
        if not args.model_from_root:
            print("--stream-slices only applies with --model-from-root",
                  file=sys.stderr)
            return 2
        assumed = _assumed_tp_ranks(args)
        if isinstance(assumed, str):
            print(assumed, file=sys.stderr)
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
    from ..io.loader import read_spec
    from ..parallel.mesh import check_mesh

    tp = _resolve_tp(args, prompts, group)
    if isinstance(tp, str):
        print(tp, file=sys.stderr)
        return 2
    sp = group.sp_size if group is not None else args.sp
    sp_err = check_mesh(sp, tp)
    if sp_err:
        print(sp_err, file=sys.stderr)
        return 2
    if (tp > 1 or sp > 1) and args.fast and args.device == "cuda":
        print(f"not yet ported: --fast with --tp {tp} --sp {sp} on the card "
              f"(a CUDA graph over the group's collectives)",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False — pass --device "
              "cpu to run on the CPU", file=sys.stderr)
        return 1
    if group is not None and group.sharded and args.seed is None:
        print("a caller's tp group needs an explicit --seed so every rank "
              "samples the same chain", file=sys.stderr)
        return 2
    if group is None and (tp > 1 or sp > 1 or args.coordinator):
        if not args.model_from_root:
            # the header, read before any rank starts: a missing or
            # foreign file fails here, as the JAX CLI's load does
            spec = read_spec(args.model, _FT[args.weights_float_type],
                             _FT[args.buffer_float_type])
            if sp > 1 and args.continuous and args.kv_page_size > 0:
                raise ValueError(f"paged KV cache requires sp=1, got "
                                 f"sp={sp} (page tables break contiguous "
                                 f"sequence chunks)")
            sp_err = check_mesh(sp, tp, spec.seq_len)
            if sp_err:
                raise ValueError(sp_err)
        if args.seed is None:  # one seed for every rank, picked here
            argv = [*argv, "--seed", str(_default_seed())]
        with _weight_streaming(args, quiet, scheme, assumed):
            return _spawn_ranks(argv, args, tp, quiet, sp)
    with (contextlib.nullcontext() if streamed
          else _weight_streaming(args, quiet, scheme, assumed)):
        if assumed is not None and group is not None \
                and group.rank not in assumed:
            # the fetched bands are not this rank's: refuse before any
            # forward reads the zeros in their place
            print(f"--stream-slices fetched tp ranks {sorted(assumed)} but "
                  f"this host's devices hold ranks [{group.rank}] — the "
                  f"host->rank assumption does not match this topology; "
                  f"re-run without --stream-slices", file=sys.stderr)
            return 2
        return _run(args, prompts, quiet, group, scheme, tp)


def _assumed_tp_ranks(args) -> set[int] | str:
    """The tp ranks this host's processes will hold, from the flags alone
    (the fetch runs before the group exists): host i of H holds
    parallel/mesh.local_ranks(tp, H, i). Each rank checks its own rank
    against the set once its group exists. A string is the error that
    exits 2 (the JAX CLI's messages)."""
    from ..parallel.mesh import local_ranks

    if not args.tp or args.tp <= 1:
        return ("--stream-slices needs an explicit --tp > 1 (the slice "
                "layout is the tp weight sharding)")
    need = args.sp * args.tp  # global rank g holds tp index g % tp
    if need % args.num_hosts:
        return (f"--stream-slices assumes equal devices/host; mesh of "
                f"{need} devices does not divide over {args.num_hosts} "
                f"hosts")
    return {g % args.tp
            for g in local_ranks(need, args.num_hosts, args.host_id or 0)}


@contextlib.contextmanager
def _weight_streaming(args, quiet: bool, scheme: str,
                      assumed: set[int] | None):
    """The root's weight server, serving for the whole block, and the
    worker's fetch, done before the block: once a host, before its ranks
    join the group, so a dead transfer fails fast. With --stream-slices
    the fetch takes only the bands of the ``assumed`` ranks under the
    scheme (io/stream.fetch_model_slices); otherwise fetch_model decides
    whether the local file is complete."""
    server = None
    if args.serve_weights is not None:
        from ..io.stream import WeightServer

        server = WeightServer(args.model, host=args.serve_weights_bind,
                              port=args.serve_weights)
        if not quiet:
            print(f"⏩ serving weights on port {server.port}")
    try:
        if args.model_from_root:
            from ..io.stream import fetch_model, fetch_model_slices

            if assumed is not None:
                fetch_model_slices(args.model_from_root, args.model,
                                   _FT[args.weights_float_type], args.tp,
                                   assumed, scheme, quiet=quiet)
            else:
                fetch_model(args.model_from_root, args.model, quiet=quiet)
        yield
    finally:
        if server is not None:
            server.close()


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


def _spawn_ranks(argv: list[str], args, tp: int, quiet: bool,
                 sp: int = 1, dp: int = 1, mode: str = "inference") -> int:
    """This host's ranks (of dp x sp x tp), one spawned process each,
    running ``mode`` (inference or train) over a TCP store on localhost
    (one host) or at --coordinator; the exit code is the first failing
    rank's."""
    import torch.multiprocessing as mp

    from ..parallel.mesh import free_port, local_ranks

    ranks = local_ranks(dp * sp * tp, args.num_hosts, args.host_id or 0)
    init = (f"tcp://{args.coordinator}" if args.coordinator
            else f"tcp://localhost:{free_port()}")
    # another host may still be fetching its weights when this one joins
    join_s = 3600.0 if args.coordinator else 600.0
    try:
        mp.start_processes(_rank_main, args=(argv, init, tp, ranks.start,
                                             args.device, quiet, join_s, sp,
                                             dp, mode),
                           nprocs=len(ranks), start_method="spawn")
    except mp.ProcessExitedException as e:
        return e.exit_code if e.exit_code and e.exit_code > 0 else 1
    except mp.ProcessRaisedException as e:
        print(f"a tp rank failed: {e}", file=sys.stderr)
        return 1
    return 0


def _rank_main(local: int, argv: list[str], init: str, tp: int, first: int,
               device_type: str, quiet: bool, join_s: float,
               sp: int = 1, dp: int = 1, mode: str = "inference") -> None:
    """A spawned rank: join the dp x sp x tp group, run ``mode``, leave."""
    from ..parallel.mesh import close, init_mesh

    rank = first + local
    group = init_mesh(rank, sp, tp, init, device_type, local=local,
                      timeout_s=join_s, dp=dp)
    try:
        if mode == "train":
            rc = cmd_train(argv, quiet=quiet or rank != 0, group=group)
        else:
            rc = cmd_inference(argv, quiet=quiet or rank != 0, group=group,
                               streamed=True)
    finally:
        sys.stdout.flush()
        close(group)
    if rc:
        raise SystemExit(rc)


def _run(args, prompts, quiet: bool, group, scheme: str, tp: int) -> int:
    """Load (the rank's bands under tp > 1), then generate."""
    from ..io.kernel_cache import load_model_packed
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
    sharded = group.sharded
    if sharded:
        spec, params = load_model_bands(args.model, group.rank, group.size,
                                        scheme, wft, bft)
    else:  # through the device-layout sidecar (io/kernel_cache.py)
        spec, params = load_model_packed(args.model, wft, bft, args.device)
    device = group.device
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    ranks = (f"{group.world_size} {device.type} ranks over "
             f"{group.backend}: {where}"
             if sharded else f"device {args.device}: {where}")
    say(f"💡 dim: {spec.dim}\n💡 hiddenDim: {spec.hidden_dim}\n"
        f"💡 nLayers: {spec.n_layers}\n💡 nHeads: {spec.n_heads}\n"
        f"💡 nKvHeads: {spec.n_kv_heads}\n"
        f"💡 vocabSize: {spec.vocab_size}\n💡 seqLen: {spec.seq_len}\n"
        f"💡 nSlices: {tp} sp: {group.sp_size} scheme: "
        f"{scheme if tp > 1 else '-'} ({ranks})")
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
            reg = None
            if args.metrics:
                from ..obs.metrics import Registry

                reg = Registry()
            generate_continuous(spec, params, tokenizer, prompts, args.steps,
                                args.temperature, args.topp, seed,
                                slots=args.slots, cache_dtype=cache_dtype,
                                prefill_chunk=args.prefill_chunk,
                                block_steps=args.block_steps,
                                fast_prefill=args.fast_prefill,
                                page_size=args.kv_page_size,
                                kv_pages=args.kv_pages,
                                kv_quant=args.kv_quant, device=device,
                                quiet=quiet, spec_k=args.spec_k,
                                spec_ngram=(3 if args.spec_ngram is None
                                            else args.spec_ngram),
                                dispatch_tokens=args.dispatch_tokens,
                                metrics=reg,
                                kv_host_pages=args.kv_host_pages,
                                kv_disk_dir=args.kv_disk_dir,
                                kv_disk_bytes=int(args.kv_disk_gb
                                                  * (1 << 30)),
                                **tp_args)
            if reg is not None and not quiet:
                print(reg.expose(), file=sys.stderr, end="")
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
    prof, trace_dir = contextlib.nullcontext(), args.profile
    if args.profile:
        from ..obs.profiler import trace

        if sharded:  # each rank traces its own work
            trace_dir = os.path.join(args.profile, f"rank{group.world_rank}")
        prof = trace(trace_dir, cuda=device.type == "cuda")
    issued = sum(collectives.CENSUS.kind_counts().values())
    run = generate_fast if args.fast else generate
    with prof:
        out, stats = run(engine, tokenizer, sampler, args.prompt or "",
                         args.steps, quiet=quiet,
                         prefill_chunk=args.prefill_chunk,
                         resume=resume, resume_prompt=rest)
    rc = 0
    if args.profile:
        issued = (sum(collectives.CENSUS.kind_counts().values()) - issued
                  if sharded else None)
        rc = _print_split(args, trace_dir, tokenizer, stats,
                          rest if resume else None, issued, quiet)
    if args.metrics and not quiet:
        # a one-shot run has no /metrics endpoint: its telemetry as a
        # Prometheus text dump on stderr (the server's metric names)
        from ..obs.metrics import Registry
        from ..obs.trace import STEP_BUCKETS

        reg = Registry()
        h = reg.histogram("dllama_request_decode_token_seconds",
                          "Per-token decode latency", buckets=STEP_BUCKETS)
        for ms in stats.token_ms:
            h.observe(ms / 1000.0)
        reg.counter("dllama_generated_tokens_total",
                    "Tokens generated this run").inc(stats.tokens)
        print(reg.expose(), file=sys.stderr, end="")
    if args.save_state:  # after a failed split too: its gather is collective
        from ..io.tokenizer import BOS
        from ..runtime.checkpoint import save_generation_state

        if stats.final_pos > 0 and stats.final_token != BOS:
            # under tp every rank gathers; rank 0 writes
            save_generation_state(args.save_state, engine, sampler,
                                  stats.final_pos, stats.final_token,
                                  prev + out, stats.prompt_rest)
            say(f"⏩ Saved generation state to {args.save_state}")
        else:
            say("💡 Generation ended (BOS or zero steps); nothing "
                "resumable to save")
    return rc

def _train_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dllama-torch train")
    ap.add_argument("--model", required=True)
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--data", required=True,
                    help="UTF-8 text corpus; tokenized once, windows "
                         "sampled per step")
    ap.add_argument("--weights-float-type", default="f32", choices=sorted(_FT))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128,
                    help="training window length (tokens per row)")
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--save-state", default=None, metavar="PATH")
    ap.add_argument("--resume-state", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks run (default cuda: one GPU a "
                         "rank over NCCL; cpu: gloo ranks)")
    _add_common(ap)
    return ap


def cmd_train(argv: list[str], quiet: bool = False, group=None) -> int:
    """``train``: next-token training on a text corpus (the JAX CLI's
    mode, parallel/train.py). Weights densify to f32, the batch splits
    over --dp ranks and the weights band over --tp ranks (the ref
    scheme), and --save-state / --resume-state give exact-resume
    checkpoints in the JAX package's format: a split run reproduces the
    unsplit run's losses step for step (the data schedule is a pure
    function of --seed and the step). The JAX CLI's checks come in its
    order, in the process that spawns the dp x tp ranks (or runs alone);
    ``group`` is a rank's parallel/mesh.TPGroup (a spawned rank, or a
    caller's own). Only global rank 0 on host 0 prints and saves."""
    args = _train_parser().parse_args(argv)
    if args.host_id:  # multi-host training: only host 0 prints
        quiet = True
    if args.stream_slices:
        # slice streaming is inference-only: training densifies and
        # re-bands, so a host needs the whole tensors
        print("--stream-slices is an inference/worker feature (training "
              "re-shards densified weights); fetch the whole file instead"
              if args.model_from_root else
              "--stream-slices only applies with --model-from-root",
              file=sys.stderr)
        return 1
    import numpy as np

    from ..io.loader import read_spec
    from ..io.tokenizer import Tokenizer
    from ..parallel.mesh import check_tp

    with (_weight_streaming(args, quiet, "ref", None) if group is None
          else contextlib.nullcontext()):
        # header-only read: validate flags before the multi-GB weights
        spec = read_spec(args.model,
                         weights_float_type=_FT[args.weights_float_type])
        if args.seq + 1 > spec.seq_len:
            print(f"--seq must be < seq_len ({spec.seq_len}), got "
                  f"{args.seq}", file=sys.stderr)
            return 2
        tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
        with open(args.data, "rb") as fh:
            text = fh.read().decode("utf-8", errors="replace")
        corpus = np.asarray(tokenizer.encode(text, bos=True, eos=False),
                            dtype=np.int32)
        if len(corpus) < args.seq + 1:  # one (seq+1)-token window minimum
            print(f"corpus has {len(corpus)} tokens; need >= "
                  f"{args.seq + 1}", file=sys.stderr)
            return 2
        if group is None:
            err = check_tp(args.tp, args.device, args.num_hosts, args.dp)
            if err:
                print(err, file=sys.stderr)
                return 2
        if args.device == "cuda" and not torch.cuda.is_available():
            print("no GPU: torch.cuda.is_available() is False — pass "
                  "--device cpu to run on the CPU", file=sys.stderr)
            return 1
        if args.resume_state:
            from ..parallel.train import read_train_meta

            meta = read_train_meta(args.resume_state)
            if meta.get("data_seed", args.seed) != args.seed:
                # the data schedule is a pure function of (seed, step): a
                # different seed silently breaks split == unsplit
                print(f"--resume-state was trained with --seed "
                      f"{meta['data_seed']}; pass the same seed (got "
                      f"{args.seed})", file=sys.stderr)
                return 2
        if group is None and (args.dp * args.tp > 1 or args.coordinator):
            return _spawn_ranks(argv, args, args.tp, quiet, dp=args.dp,
                                mode="train")
        return _train_run(args, spec, corpus, quiet, group)


def _train_run(args, spec, corpus, quiet: bool, group) -> int:
    """Build the rank's state (a fresh densified model, or a checkpoint),
    then step through the (seed, step) data schedule."""
    import numpy as np

    from ..io.loader import densify_params, load_model
    from ..parallel.mesh import single
    from ..parallel.train import (load_train_state, make_train_step,
                                  save_train_state, template_params)

    group = group or single(args.device)
    init_fn, step_fn = make_train_step(spec, group,
                                       learning_rate=args.learning_rate)
    start = 0
    if args.resume_state:
        # the checkpoint overwrites every value: a zero template gives the
        # structure and bands without reading the model's weights
        p, o = init_fn(template_params(spec))
        p, o, start = load_train_state(args.resume_state, spec, p, o,
                                       group=group, return_step=True)
        if not quiet:
            print(f"⏩ Resumed training at step {start}")
    else:
        _, params = load_model(args.model, spec=spec)
        p, o = init_fn(densify_params(params))
        del params

    def windows(step: int) -> np.ndarray:
        """(batch, seq+1) token windows — a pure function of (seed, step),
        so a resumed run continues the identical schedule. The exclusive
        high bound len - seq keeps the LAST corpus token reachable as a
        target."""
        rng = np.random.default_rng((args.seed, step))
        starts = rng.integers(0, len(corpus) - args.seq, args.batch)
        return np.stack([corpus[s:s + args.seq + 1] for s in starts])

    for step in range(start, start + args.steps):
        t0 = time.perf_counter()
        p, o, loss = step_fn(p, o, windows(step))
        loss = float(loss)
        if not quiet:
            print(f"🔶 step {step:5d}  loss {loss:8.4f}  "
                  f"{(time.perf_counter() - t0) * 1000:7.1f} ms")
    if args.save_state and not args.host_id:  # one writer: the root host
        # every rank of the group gathers its bands; global rank 0 writes
        save_train_state(args.save_state, spec, p, o,
                         step=start + args.steps, data_seed=args.seed,
                         group=group)
        if not quiet:
            print(f"⏩ Saved training state to {args.save_state} "
                  f"(step {start + args.steps})")
    return 0


def _serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dllama-torch serve")
    ap.add_argument("--model", required=True,
                    help="path to the reference-format .bin model")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--weights-float-type", default="q40", choices=sorted(_FT))
    ap.add_argument("--buffer-float-type", default="f32", choices=sorted(_FT))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9990,
                    help="listen port (0 = pick a free one; the 🌐 line "
                         "names the bound port)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default cuda; the CPU runs "
                         "the kernels' plain versions)")
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent sequences (cache slots)")
    ap.add_argument("--steps", type=int, default=64,
                    help="default max new positions per request")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--topp", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ranks (default 1): rank 0 serves "
                         "and sends each dispatch's plan to the others")
    ap.add_argument("--tp-scheme", default=None, choices=SCHEMES,
                    help="tp collective schedule (= DLLAMA_TP_SCHEME)")
    ap.add_argument("--kv-cache-dtype", default="f32",
                    choices=("f32", "bf16"))
    ap.add_argument("--prefill-chunk", type=int, default=128, metavar="N",
                    help="admission prefill: fill a new request's prompt "
                         "in T=N chunked passes (0/1 disables)")
    ap.add_argument("--block-steps", type=int, default=1, metavar="K",
                    help="fuse K decode steps into one device dispatch "
                         "(admission + per-token streaming at chain "
                         "boundaries)")
    ap.add_argument("--kv-page-size", type=int, default=0, metavar="P",
                    help="paged KV cache with radix prefix sharing (0 = "
                         "contiguous per-slot cache)")
    ap.add_argument("--kv-pages", type=int, default=0, metavar="N",
                    help="paged-KV pool size in pages (default: "
                         "slots * seq_len / page-size)")
    ap.add_argument("--kv-quant", default=None, choices=("f32", "q8"),
                    help="KV page quantization (= DLLAMA_KV_QUANT; needs "
                         "--kv-page-size)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="self-speculative decoding (needs "
                         "--kv-page-size; 0 = off)")
    _add_kv_tier_flags(ap)
    ap.add_argument("--spec-ngram", type=int, default=3, metavar="N",
                    help="longest drafter n-gram (falls back to 1)")
    ap.add_argument("--dispatch-tokens", type=int, default=0, metavar="T",
                    help="token-budget mixed dispatches (needs "
                         "--kv-page-size; -1 sizes from --prefill-chunk; "
                         "0 = off; incompatible with --spec-k)")
    ap.add_argument("--fast-prefill", action="store_true",
                    help="bf16 products for admission prefill")
    ap.add_argument("--metrics", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve GET /metrics and collect request-lifecycle "
                         "and engine metrics; --no-metrics turns "
                         "collection off")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="SLO policy: name:ttft_ms:token_ms[,...], first "
                         "class is the default; default the built-in "
                         "interactive/batch policy; --slo off disables "
                         "tracking")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="ARM DETERMINISTIC FAULT INJECTION (drills only — "
                         "never in front of real traffic): "
                         "key=value[,...] with step_delay_every, "
                         "step_delay_ms, deny_pages, leak_on_cancel "
                         "(runtime/chaos.ChaosMonkey)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal (runtime/journal.py): "
                         "on restart the server re-admits incomplete "
                         "requests and continues their streams")
    ap.add_argument("--journal-fsync", default="batch",
                    choices=("always", "batch", "off"),
                    help="journal durability: fsync every record, once a "
                         "scheduler step (default), or never")
    ap.add_argument("--watchdog-ms", type=float, default=0.0, metavar="MS",
                    help="step watchdog: a dispatch over this deadline "
                         "marks /health degraded (0 = off)")
    ap.add_argument("--drain-s", type=float, default=10.0, metavar="S",
                    help="graceful-drain budget on SIGTERM: stop admission "
                         "(503), finish in-flight requests for up to S "
                         "seconds, journal the remainder, exit 0")
    ap.add_argument("--supervise", action="store_true",
                    help="run serve under the crash-loop supervisor: "
                         "respawn on non-zero exits with backoff, forward "
                         "SIGTERM for one graceful drain")
    ap.add_argument("--max-restarts", type=int, default=None, metavar="N",
                    help="(--supervise) give up after N respawns")
    ap.add_argument("--disagg-role", default=None,
                    choices=("prefill", "decode"),
                    help="prefill/decode disaggregation: 'prefill' serves "
                         "POST /prefill and the page channel (fills KV "
                         "pages, samples the first token, ships the full "
                         "prompt pages); 'decode' fronts clients and "
                         "forwards long prompts to --disagg-peer, resuming "
                         "the stream from the returned journal record. "
                         "Needs --kv-page-size (pages are the transfer "
                         "unit)")
    ap.add_argument("--disagg-peer", default=None, metavar="HOST:PORT",
                    help="(--disagg-role decode) the prefill server")
    ap.add_argument("--page-channel-port", type=int, default=0,
                    metavar="PORT",
                    help="(--disagg-role prefill) page-channel listen port "
                         "(0 = pick a free one; /health's disagg block "
                         "names it)")
    ap.add_argument("--handoff-min-pages", type=int, default=2, metavar="N",
                    help="(--disagg-role decode) forward only prompts "
                         "spanning >= N full KV pages; shorter prompts "
                         "prefill locally")
    ap.add_argument("--watch-interval", type=float, default=0.0,
                    metavar="S",
                    help="watchtower incident detection every S seconds "
                         "(0 = off; /debug/incidents either way)")
    ap.add_argument("--flightrec", default=None, metavar="DIR",
                    help="flight recorder: drop a postmortem bundle into "
                         "DIR on a watchdog trip, the SIGTERM drain and "
                         "each --supervise respawn")
    _obs_flags(ap)
    return ap


def cmd_serve(argv: list[str]) -> int:
    """``serve``: the HTTP server over the continuous engine
    (runtime/server.py), with the KV tiers, either role of a
    disaggregated pair and chaos, on one device or over ``--tp N`` ranks
    (this process is rank 0, the others are spawned followers,
    runtime/tp_plan.py). The JAX CLI's checks and messages in its order,
    all before any load."""
    ap = _serve_parser()
    args = ap.parse_args(argv)
    if args.supervise:
        # re-exec this serve command (supervision flags stripped) under the
        # crash-loop wrapper, before any load: the supervisor stays small
        # and device-free
        from ..runtime.supervisor import serve_child_cmd, supervise

        return supervise(serve_child_cmd(argv),
                         max_restarts=args.max_restarts,
                         flightrec_dir=args.flightrec)
    _apply_log_json(args)
    from ..ops.paged_attention import kv_quant_mode

    if args.kv_quant:
        os.environ["DLLAMA_KV_QUANT"] = args.kv_quant
    try:
        args.kv_quant = kv_quant_mode()
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    if args.slots < 1:
        print(f"--slots must be positive, got {args.slots}", file=sys.stderr)
        return 2
    if args.fast_prefill and args.prefill_chunk <= 1:
        print("--fast-prefill only affects admission prefill; pass "
              "--prefill-chunk N (N > 1)", file=sys.stderr)
        return 2
    if args.spec_k and args.kv_page_size <= 0:
        print("--spec-k needs the paged KV cache: add --kv-page-size P",
              file=sys.stderr)
        return 2
    if args.spec_k and args.dispatch_tokens:
        print("--spec-k is incompatible with --dispatch-tokens: the "
              "verify window and the prefill slice both claim the "
              "per-row span (drop one)", file=sys.stderr)
        return 2
    if args.dispatch_tokens and args.kv_page_size <= 0:
        print("--dispatch-tokens needs the paged KV cache: add "
              "--kv-page-size P", file=sys.stderr)
        return 2
    if args.kv_quant == "q8" and args.kv_page_size <= 0:
        print("--kv-quant q8 quantizes paged KV pages: add "
              "--kv-page-size P", file=sys.stderr)
        return 2
    tier_err = _check_kv_tier_args(args, "")
    if tier_err:
        print(tier_err, file=sys.stderr)
        return 2
    if args.disagg_role and args.kv_page_size <= 0:
        print("--disagg-role ships KV PAGES between pools: add "
              "--kv-page-size P", file=sys.stderr)
        return 2
    if args.disagg_role == "decode" and not args.disagg_peer:
        print("--disagg-role decode needs --disagg-peer HOST:PORT (the "
              "prefill server)", file=sys.stderr)
        return 2
    if args.disagg_peer and args.disagg_role != "decode":
        print("--disagg-peer only means something with --disagg-role "
              "decode", file=sys.stderr)
        return 2
    if args.handoff_min_pages < 1:
        print(f"--handoff-min-pages must be >= 1, got "
              f"{args.handoff_min_pages}", file=sys.stderr)
        return 2
    from ..obs.slo import SLOPolicy
    from ..runtime.chaos import ChaosMonkey

    try:
        slo = (None if args.slo == "off"
               else SLOPolicy.parse(args.slo) if args.slo
               else SLOPolicy.serving_default())
        chaos = ChaosMonkey.parse(args.chaos) if args.chaos else None
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    if chaos is not None:
        print("🔶 CHAOS ARMED: deterministic fault injection is live "
              f"({args.chaos}) — drill traffic only", file=sys.stderr)
    from ..parallel.comm_stats import tp_scheme

    if args.tp_scheme:
        os.environ["DLLAMA_TP_SCHEME"] = args.tp_scheme
    try:
        tp_scheme()  # validated before the load
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is False — pass --device "
              "cpu to run on the CPU", file=sys.stderr)
        return 1
    seed = args.seed if args.seed is not None else _default_seed()
    if (args.tp or 1) > 1:
        return _serve_group(argv, args, slo, chaos, seed)
    return _serve_run(args, slo, chaos, seed)


def _serve_engine_kwargs(args, slo, chaos, seed) -> dict:
    """The continuous engine's options under serve, the same on every
    rank of a served tp group (runtime/server.InferenceServer passes
    these on rank 0; a follower builds its engine from them)."""
    return dict(slots=args.slots, temperature=args.temperature,
                topp=args.topp, seed=seed,
                cache_dtype=(torch.bfloat16 if args.kv_cache_dtype == "bf16"
                             else torch.float32),
                prefill_chunk=args.prefill_chunk,
                block_steps=args.block_steps,
                fast_prefill=args.fast_prefill, page_size=args.kv_page_size,
                kv_pages=args.kv_pages, spec_k=args.spec_k,
                spec_ngram=args.spec_ngram,
                dispatch_tokens=args.dispatch_tokens, slo=slo, chaos=chaos,
                kv_quant=args.kv_quant, kv_host_pages=args.kv_host_pages,
                kv_disk_dir=args.kv_disk_dir,
                kv_disk_bytes=int(args.kv_disk_gb * (1 << 30)))


def _serve_group(argv: list[str], args, slo, chaos, seed: int) -> int:
    """``serve --tp N``: spawn ranks 1..N-1 as followers, join the group
    as rank 0 in this process and serve; then close the group and wait
    for the followers. Exit 1 when a dispatch over the group failed or a
    follower did not end cleanly."""
    import multiprocessing

    from ..io.loader import read_spec
    from ..parallel.mesh import (check_tp, close, free_port, group_backend,
                                 init_rank)
    from ..parallel.tp import validate_sharding
    from ..runtime.tp_plan import PlanChannel

    # the header, read before any rank starts: a missing or foreign file
    # fails here, as the JAX CLI's load does
    spec = read_spec(args.model, _FT[args.weights_float_type],
                     _FT[args.buffer_float_type])
    backend = group_backend(args.tp, args.device)
    err = (check_tp(args.tp, args.device) if backend == "nccl"
           else None)
    if err:
        print(err, file=sys.stderr)
        return 2
    from ..parallel.comm_stats import tp_scheme

    validate_sharding(spec, args.tp, tp_scheme())
    init = f"tcp://localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    followers = [ctx.Process(target=_serve_follower,
                             args=(r, argv, init, seed, backend),
                             daemon=True)
                 for r in range(1, args.tp)]
    for f in followers:
        f.start()
    group = init_rank(0, args.tp, init, args.device, local=0,
                      backend=backend)
    channel = PlanChannel(group)
    rc = 1
    try:
        rc = _serve_run(args, slo, chaos, seed, group, channel, followers)
    finally:
        try:
            channel.send_shutdown()
        except Exception:  # noqa: BLE001 - the group is already gone
            rc = rc or 1
        close(group)
        for f in followers:
            f.join(channel.timeout_s)
            if f.is_alive():
                f.kill()
                f.join()
            if f.exitcode != 0:
                print(f"serve: tp rank {followers.index(f) + 1} exited "
                      f"{f.exitcode}", file=sys.stderr)
                rc = rc or 1
    return rc


def _serve_follower(rank: int, argv: list[str], init: str, seed: int,
                    backend: str) -> None:
    """A spawned follower of ``serve --tp N``: join the group, load its
    bands, build the engine rank 0 has, and follow rank 0's plans until
    the shutdown plan (runtime/tp_plan.follow_loop)."""
    import dataclasses

    from ..obs.slo import SLOPolicy
    from ..parallel.comm_stats import tp_scheme
    from ..parallel.mesh import close, init_rank
    from ..parallel.tp import load_model_bands
    from ..runtime.chaos import ChaosMonkey
    from ..runtime.continuous import ContinuousEngine
    from ..runtime.tp_plan import PlanChannel, follow_loop

    args = _serve_parser().parse_args(argv)
    _apply_log_json(args)
    if args.kv_quant:
        os.environ["DLLAMA_KV_QUANT"] = args.kv_quant
    if args.tp_scheme:
        os.environ["DLLAMA_TP_SCHEME"] = args.tp_scheme
    from ..ops.paged_attention import kv_quant_mode

    args.kv_quant = kv_quant_mode()
    slo = (None if args.slo == "off"
           else SLOPolicy.parse(args.slo) if args.slo
           else SLOPolicy.serving_default())
    # rank 0's monkey decides; this copy replays its schedule, sleepless
    chaos = (dataclasses.replace(ChaosMonkey.parse(args.chaos),
                                 step_delay_s=0.0) if args.chaos else None)
    group = init_rank(rank, args.tp, init, args.device, local=rank,
                      backend=backend)
    channel = PlanChannel(group)
    scheme = tp_scheme()
    try:
        spec, params = load_model_bands(
            args.model, rank, args.tp, scheme, _FT[args.weights_float_type],
            _FT[args.buffer_float_type])
        engine = ContinuousEngine(
            spec, params, **_serve_engine_kwargs(args, slo, chaos, seed),
            device=group.device, graph=False, mesh=group, scheme=scheme,
            remote_pages=args.disagg_role == "decode",
            slo_priority=args.disagg_role == "prefill" and slo is not None)
        del params
        if args.disagg_role == "prefill" and slo is not None:
            from ..runtime.disagg import make_priority_hold

            engine.prefill_hold = make_priority_hold(engine, slo)
        try:
            n = follow_loop(engine, channel)
        finally:
            engine.close()
        print(f"🌐 tp rank {rank}: followed {n} plans, every digest equal "
              f"to rank 0's", file=sys.stderr, flush=True)
    finally:
        close(group)


def _serve_run(args, slo, chaos, seed: int, group=None,
               channel=None, followers=()) -> int:
    """The serving process (rank 0 under --tp): the journal, the load (the
    rank's bands under a group), the server, until it drains."""
    journal = None
    if args.journal:
        from ..runtime.journal import JournalCorruption, RequestJournal

        try:
            # opened before the load: damage refuses in milliseconds; the
            # config fingerprint (it needs the spec) attaches after it
            journal = RequestJournal(args.journal, fsync=args.journal_fsync)
        except JournalCorruption as e:
            print(f"serve: journal {args.journal} is corrupt: {e}\n"
                  f"       (move it aside to start fresh, or restore a "
                  f"good copy to recover)", file=sys.stderr)
            return 1
    from ..io.kernel_cache import load_model_packed
    from ..io.tokenizer import Tokenizer
    from ..runtime.journal import (JournalConfigMismatch, config_fingerprint,
                                   weight_file_digest)
    from ..runtime.server import InferenceServer

    from ..parallel.comm_stats import tp_scheme

    wft, bft = _FT[args.weights_float_type], _FT[args.buffer_float_type]
    if group is not None:
        from ..parallel.tp import load_model_bands

        spec, params = load_model_bands(args.model, 0, group.size,
                                        tp_scheme(), wft, bft)
    else:  # through the device-layout sidecar (io/kernel_cache.py)
        spec, params = load_model_packed(args.model, wft, bft, args.device)
    tokenizer = Tokenizer(args.tokenizer, spec.vocab_size)
    if journal is not None:
        # what a replay depends on (the JAX CLI's record): the model, its
        # types, the tp scheme ('single' for one device), the seed
        # policy, the weights
        seed_policy = (f"explicit:{args.seed}" if args.seed is not None
                       else "time")
        journal.set_config(config_fingerprint(
            spec, tp_scheme() if group is not None else "single",
            seed_policy,
            weights_digest=weight_file_digest(args.model),
            kv_quant=args.kv_quant, kv_cache_dtype=args.kv_cache_dtype,
            kv_host_pages=args.kv_host_pages,
            kv_disk=bool(args.kv_disk_dir)))
    opts = _serve_engine_kwargs(args, slo, chaos, seed)

    def tp_alive():
        dead = [i + 1 for i, f in enumerate(followers) if not f.is_alive()]
        return f"tp ranks {dead} exited" if dead else None

    try:
        server = InferenceServer(spec, params, tokenizer, args.host,
                                 args.port, opts.pop("slots"), args.steps,
                                 opts.pop("temperature"), opts.pop("topp"),
                                 opts.pop("seed"), **opts,
                                 metrics=args.metrics, journal=journal,
                                 watchdog_s=args.watchdog_ms / 1e3,
                                 drain_s=args.drain_s,
                                 flightrec_dir=args.flightrec,
                                 watch_interval_s=args.watch_interval,
                                 device=(group.device if group is not None
                                         else args.device),
                                 mesh=group, tp_channel=channel,
                                 tp_alive=tp_alive if followers else None,
                                 disagg_role=args.disagg_role,
                                 disagg_peer=args.disagg_peer,
                                 page_channel_port=args.page_channel_port,
                                 handoff_min_pages=args.handoff_min_pages)
    except JournalConfigMismatch as e:
        # the journal was written under another config: a replay would be
        # deterministic and wrong, so refuse; the operator restores the
        # config or moves the journal aside
        print(f"serve: {e}", file=sys.stderr)
        return 1
    del params  # the host copy; the engine holds the device tree
    endpoints = "POST /generate, GET /health" + (
        ", GET /metrics, GET /debug/timeline, POST /profile"
        if args.metrics else "")
    print(f"🌐 serving on http://{args.host}:{server.port} "
          f"({args.slots} slots, {endpoints})", flush=True)
    if args.disagg_role == "prefill":
        print(f"🌐 disagg role: prefill (POST /prefill; page channel on "
              f"port {server._page_channel.port})", flush=True)
    elif args.disagg_role == "decode":
        print(f"🌐 disagg role: decode (peer {args.disagg_peer}, handoff "
              f"at >= {args.handoff_min_pages} full pages)", flush=True)
    if server.recovered:
        print(f"🌐 recovered {server.recovered} journaled requests "
              f"from {args.journal}", flush=True)
    if group is not None:
        shared = (f" sharing {torch.cuda.device_count()} GPU(s)"
                  if group.device.type == "cuda"
                  and group.backend == "gloo" else "")
        print(f"🌐 tp: {group.size} ranks over {group.backend}{shared} "
              f"({tp_scheme()}; rank 0 sends each dispatch's plan; "
              f"follower pids {' '.join(str(f.pid) for f in followers)})",
              flush=True)
    server.serve_forever()
    if group is not None:
        print(f"🌐 tp: sent {channel.sent} dispatch plans", file=sys.stderr,
              flush=True)
    if server.tp_error is not None:
        print(f"serve: the tp group failed: {server.tp_error}",
              file=sys.stderr)
        return 1
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


def _print_split(args, trace_dir: str, tokenizer, stats,
                 rest: list[int] | None, issued: int | None,
                 quiet: bool) -> int:
    """After a --profile run: where the trace went and its I/T split per
    generated token. The trace wraps the whole generate call, so a
    prefilled prompt's chunks are inside it and the line says so (a resumed
    run prefills only its unconsumed prompt tail, ``rest``). On one device
    a trace that does not parse prints a note and the run still succeeds
    (0). Under tp (``issued``: the collectives the traced call issued, from
    CENSUS) every rank checks its own trace: its T must be positive and
    its collective events must equal ``issued``, else 1; rank 0 prints."""
    from ..utils.it_split import parse_trace, summarize

    if not quiet:
        print(f"⏩ Profiler trace written to {trace_dir}")
    try:
        splits = parse_trace(trace_dir)
        if not quiet:
            n_prompt = (len(rest) if rest is not None
                        else len(tokenizer.encode(args.prompt or "",
                                                  bos=True, eos=False)))
            note = (f"; trace includes ~{n_prompt}-token prompt prefill"
                    if n_prompt > 1 else "")
            summarize(splits, tokens=max(stats.tokens, 1), note=note)
    except Exception as e:  # a malformed trace must not fail the run
        print(f"💡 I/T split unavailable ({type(e).__name__}: {e}); run "
              f"python3 -m distributed_llama_tpu_torch.utils.it_split on "
              f"the trace dir", file=sys.stderr)
        return 0 if issued is None else 1
    if issued is None:
        return 0
    events = sum(s.transfer_events for s in splits.values())
    t_ns = sum(s.transfer_ns for s in splits.values())
    if not quiet:
        print(f"💡 Collectives in the trace: {events} ({t_ns / 1e6:.3f} ms),"
              f" census {issued}")
    if events != issued or t_ns <= 0:
        print(f"the trace in {trace_dir} holds {events} collective events "
              f"({t_ns / 1e6:.3f} ms of T) where the run issued {issued}",
              file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: dllama-torch {{inference|worker|serve|train|"
              f"convert}} [options]\n{__doc__}")
        return 0 if argv else 1
    mode, rest = argv[0], argv[1:]
    if mode == "inference":
        return cmd_inference(rest)
    if mode == "worker":
        return cmd_worker(rest)
    if mode == "serve":
        try:
            return cmd_serve(rest)
        except SystemExit as e:  # argparse's usage errors
            return e.code if isinstance(e.code, int) else 1
    if mode == "convert":
        from ..convert import main as convert_main

        try:
            convert_main(rest)
        except SystemExit as e:  # argparse's usage errors
            return e.code if isinstance(e.code, int) else 1
        return 0
    if mode == "train":
        try:
            return cmd_train(rest)
        except SystemExit as e:  # argparse's usage errors
            return e.code if isinstance(e.code, int) else 1
    print(f"unknown mode {mode!r} (expected inference|worker|serve|train|"
          f"convert)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
