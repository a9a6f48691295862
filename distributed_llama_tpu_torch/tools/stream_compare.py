"""Run chip_smoke.py's CLI runs a, b, g, h, i, o, p and k-n from two
checkouts on one model and compare their token streams. Run from the root of a
checkout, on a machine with an NVIDIA GPU, after chip_smoke.py has written
its model (``python3 -c "import chip_smoke; chip_smoke.smoke_files()"``):

    python3 -m distributed_llama_tpu_torch.tools.stream_compare --other DIR
        [--runs a,b,g,h,i,o,p,p-headtail,k,l,m,n]

DIR holds the reference: another commit of the repository (``git
archive``). Each run is the ``inference`` CLI in a process of its own, with
the checkout it belongs to first on ``PYTHONPATH``, so each builds and runs
its own kernels. Runs a (64 greedy steps token by token) and b (the
512-token prompt at chunk 128) are compared piece by piece, and the
reference records, for every sampled token, the gap between its two
largest logits and its largest |logit| (its host sampler's input); run i
(``--fast``, run a's prompt) and run p (run i under
DLLAMA_LAYER_FUSION=on, a K10 per layer) are compared as text, against
the reference's run a pieces and gaps; run o (run a under
DLLAMA_LAYER_FUSION=headtail: K8, K2 and K9 a layer) piece by piece and
run p-headtail (run i under headtail: K8, K5 and K9) as text, both
exactly: K8's and K9's rows keep P0's bits from design to design, so
their streams may not part even at a near-tie; runs g (8 prompts in one batch),
h (run g under DLLAMA_MULTI_T_BODY=dequant over a bf16 cache: K1d) and
k-n (12
prompts through ``--continuous``: f32 pages, contiguous, bf16 pages, Q8
pages sampled at 0.8 in an oversubscribed pool) row by row. ``--runs
n-f32`` adds run n over f32 pages (the same pool, no Q8), and ``--other``
naming this checkout holds a tree to its own streams. A line per run says which streams are
equal and, where one parts, the first piece that differs, what each side
printed there and, for a, b and i, the reference's top-2 gap there against
the logit tolerance (models/llama.LOGIT_RTOL x max|logit|): a parting at a
gap within it is a near-tie the two sums may break either way. Where a
--continuous run parts, both trees run it once more eagerly (no CUDA
graph: the same kernels the replays run) and record each fused-chain
step's logits and tokens; the line then gives the first step and slot at
which a sampled token differs, and the largest difference of the two
trees' logits there against the same tolerance: within it, the two sums
agree and the sampler (greedy or at a temperature) broke a near-tie. Such
a check covers one parted row a run. Exit code 0 when every stream is
equal or parts only at such a near-tie, else 1.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


# the reference's per-sampled-token (top-2 gap, max |logit|), written as
# JSON to argv[1]; the CLI gets argv[2:]
_GAPS_SCRIPT = """
import json, sys
import numpy as np
from distributed_llama_tpu_torch.frontend import cli
from distributed_llama_tpu_torch.runtime import sampling
gaps = []
sample = sampling.Sampler.sample
def spy(self, logits):
    top = np.sort(np.asarray(logits, dtype=np.float32))[-2:]
    gaps.append([float(top[1] - top[0]), float(np.abs(logits).max())])
    return sample(self, logits)
sampling.Sampler.sample = spy
rc = cli.main(sys.argv[2:])
json.dump(gaps, open(sys.argv[1], "w"))
sys.exit(rc)
"""


# a --continuous run with its fused chain run eagerly (graph=False), which
# writes to argv[1] (.npz), per chain step: the slots whose token was
# sampled ("used": active and not forced), the tokens the step chose, and
# the logits it chose them from; the CLI gets argv[2:]
_CHAIN_SCRIPT = """
import sys
import numpy as np
from distributed_llama_tpu_torch.frontend import cli
from distributed_llama_tpu_torch.runtime.continuous import ContinuousEngine
E = ContinuousEngine
steps, last = [], {}
init, forward, chain_step = E.__init__, E._forward, E._chain_step
def eager(self, *args, **kwargs):
    init(self, *args, **{**kwargs, "graph": False})
def spy_forward(self):
    out = forward(self)
    last["logits"] = out.float().cpu().numpy()
    return out
def spy_step(self, c, greedy_only):
    i = int(c.index.item())
    used = ((c.forced[i] < 0) & c.active).cpu().numpy()
    chain_step(self, c, greedy_only)
    steps.append((used, c.toks[i].cpu().numpy(), last.pop("logits")))
E.__init__, E._forward, E._chain_step = eager, spy_forward, spy_step
rc = cli.main(sys.argv[2:])
used, toks, logits = (np.stack(v) for v in zip(*steps))
np.savez(sys.argv[1], used=used, toks=toks, logits=logits)
sys.exit(rc)
"""


# the environment a run adds to the CLI's, as chip_smoke.py sets it
RUN_ENV = {"h": {"DLLAMA_MULTI_T_BODY": "dequant"},
           "o": {"DLLAMA_LAYER_FUSION": "headtail"},
           "p": {"DLLAMA_LAYER_FUSION": "on"},
           "p-headtail": {"DLLAMA_LAYER_FUSION": "headtail"}}
# runs compared exactly: a parting is a fault even at a near-tie
EXACT = ("o", "p-headtail")


def _runs(smoke) -> dict[str, list[str]]:
    """The CLI flags of runs a, b, g, h, i, o, p, p-headtail and k-n, as
    chip_smoke.py
    gives them (the prompts file is added where a run takes one; RUN_ENV
    holds a run's environment)."""
    cont = ["--continuous", "--slots", str(smoke.CONT_SLOTS),
            "--prefill-chunk", str(smoke.CONT_CHUNK), "--steps",
            str(smoke.CONT_STEPS), "--temperature", "0", "--seed", "1"]
    page = ["--kv-page-size", str(smoke.PAGE)]
    a = ["--prompt", smoke.PROMPT, "--steps", str(smoke.STEPS),
         "--temperature", "0", "--seed", "1"]
    g = ["--steps", str(smoke.STEPS), "--temperature", "0", "--seed", "1"]
    return {
        "a": a,
        "g": g,
        "h": [*g, "--kv-cache-dtype", "bf16"],
        "i": [*a, "--fast"],
        "o": a,
        "p": [*a, "--fast"],
        "p-headtail": [*a, "--fast"],
        "b": ["--prompt", smoke.PROMPT_512, "--steps", str(smoke.STEPS_512),
              "--temperature", "0", "--seed", "1", "--prefill-chunk",
              str(smoke.CHUNK)],
        "k": [*cont, *page],
        "l": cont,
        "m": [*cont, *page, "--kv-cache-dtype", "bf16", "--block-steps",
              "16"],
        "n": [*cont, *page, "--kv-quant", "q8", "--block-steps", "16",
              "--temperature", "0.8", "--seed", "7", "--kv-pages", "32"],
        # run n over f32 pages: the same oversubscribed pool without Q8
        "n-f32": [*cont, *page, "--block-steps", "16", "--temperature",
                  "0.8", "--seed", "7", "--kv-pages", "32"],
    }


def _cli(tree: Path, model: Path, tok: Path, flags: list[str],
         gaps: Path | None = None, chain: Path | None = None,
         env: dict | None = None) -> str:
    """The CLI's stdout from ``tree`` under ``env`` added to this
    process's; with ``gaps``, through the script that writes each sampled
    token's top-2 gap there; with ``chain``, through the one that writes a
    --continuous run's chain steps there."""
    env = dict(os.environ, **(env or {}), PYTHONPATH=str(tree))
    if gaps is not None:
        head = ["-c", _GAPS_SCRIPT, str(gaps)]
    elif chain is not None:
        head = ["-c", _CHAIN_SCRIPT, str(chain)]
    else:
        head = ["-m", "distributed_llama_tpu_torch.frontend.cli"]
    proc = subprocess.run(
        [sys.executable, *head, "inference", "--model", str(model),
         "--tokenizer", str(tok), *flags], cwd=tree, env=env,
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: CLI {flags[:4]} exited "
                           f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    return proc.stdout


def streams(out: str, continuous: bool) -> list[list[str]]:
    """The printed streams of a run: one list of pieces for a single prompt
    (the 🔶 lines' text), one string a row for --continuous (its [i] line,
    compared whole)."""
    if continuous:
        return [[text] for _, text in
                re.findall(r"^\[(\d+)\] (?!done:)(.*)$", out, re.M)]
    return [[ast.literal_eval(ln.rsplit(" kB ", 1)[1])
             for ln in out.splitlines() if ln.startswith("🔶")]]


def fast_text(out: str) -> str:
    """The text ``--fast`` prints on the line before its stats line."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines)
             if ln.startswith("Generated tokens:"))
    return lines[i - 1]


def piece_at(pieces: list[str], char: int) -> int:
    """The index of the piece holding character ``char`` of their join (the
    piece count past the end)."""
    end = 0
    for i, piece in enumerate(pieces):
        end += len(piece)
        if char < end:
            return i
    return len(pieces)


def near_tie(at: int, gaps: list, rtol: float) -> tuple[bool, float, float]:
    """(whether the reference's two largest logits at sampled token ``at``
    lie within rtol x its max |logit|, the gap, the tolerance); a token
    past the recorded ones is no near-tie."""
    if at >= len(gaps):
        return False, float("inf"), 0.0
    gap, top = gaps[at]
    return gap <= rtol * top, gap, rtol * top


def chain_parting(ours, theirs, rtol: float) -> dict | None:
    """Where two recordings of a --continuous run's chain steps (``used``,
    ``toks``, ``logits`` as _CHAIN_SCRIPT writes them) first choose
    different tokens for a slot sampled on both, or first differ in which
    slots they sample: the step, the slot, the largest difference of the
    logits there, the tolerance (rtol x the reference's max |logit|) and
    whether the difference lies within it. None when no step parts."""
    for step in range(min(len(ours["used"]), len(theirs["used"]))):
        used = ours["used"][step]
        if not np.array_equal(used, theirs["used"][step]):
            return dict(step=step, slot=None, err=float("inf"), tol=0.0,
                        tie=False)
        differ = np.flatnonzero(used & (ours["toks"][step]
                                        != theirs["toks"][step]))
        if len(differ):
            slot = int(differ[0])
            mine = ours["logits"][step, slot]
            ref = theirs["logits"][step, slot]
            err = float(np.abs(mine - ref).max())
            tol = rtol * float(np.abs(ref).max())
            return dict(step=step, slot=slot, err=err, tol=tol,
                        tie=err <= tol)
    return None


def _chain_check(label: str, flags: list[str], ours: list, theirs: list,
                 other: Path, model: Path, tok: Path, tmp: Path,
                 rtol: float) -> tuple[str, bool]:
    """A --continuous run that parted, once more from each tree with its
    chain steps recorded: the line's note and whether the first parting is
    a near-tie. The eager runs must print the captured runs' streams."""
    rec = {}
    for side, tree, want in (("ours", ROOT, ours), ("theirs", other, theirs)):
        path = tmp / f"chain_{label}_{side}.npz"
        out = _cli(tree, model, tok, flags, chain=path)
        if streams(out, True) != want:
            return f" (the {side} eager run printed other streams)", False
        with np.load(path) as f:
            rec[side] = {k: f[k] for k in f.files}
    at = chain_parting(rec["ours"], rec["theirs"], rtol)
    if at is None:
        return " (the eager runs' chain steps do not part)", False
    if at["slot"] is None:
        return (f" (the chains first part at step {at['step']} in which "
                f"slots they sample)", False)
    return (f"; chain step {at['step']} slot {at['slot']}: logits differ "
            f"by {at['err']:.3e} at most, tolerance {at['tol']:.3e}: "
            f"{'a near-tie' if at['tie'] else 'above it'}", at["tie"])


def first_difference(a: list[str], b: list[str]) -> int | None:
    """The index of the first piece where a and b differ (the shorter one's
    length when one is a prefix of the other), or None when equal. A
    --continuous row is one string: the index is then the character."""
    if len(a) == len(b) == 1 and a != b:
        a, b = list(a[0]), list(b[0])
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the root of the other checkout (the reference)")
    ap.add_argument("--runs", default="a,b,g,h,i,o,p,p-headtail,k,l,m,n")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from distributed_llama_tpu_torch.models.llama import LOGIT_RTOL

    model = smoke.SMOKE_DIR / "llama2_7b_q40_seed0.bin"
    tok = smoke.SMOKE_DIR / "tokenizer_32000.bin"
    if not model.exists():
        print(f"stream_compare: no model at {model}: run chip_smoke's "
              f"smoke_files first")
        return 2
    other = Path(args.other).resolve()
    runs = _runs(smoke)
    ok = True
    ref = {}  # run -> (the reference's pieces, its gaps)
    with tempfile.TemporaryDirectory() as tmp:
        files = {"g": Path(tmp) / "batch.txt",
                 "cont": Path(tmp) / "continuous.txt"}
        files["g"].write_text("\n".join(smoke.BATCH_PROMPTS) + "\n")
        files["cont"].write_text("\n".join(smoke.CONT_PROMPTS) + "\n")
        for label in args.runs.split(","):
            flags = runs[label]
            cont = "--continuous" in flags
            batch = label in ("g", "h")
            if cont or batch:
                flags = ["--prompts-file",
                         str(files["cont" if cont else "g"]), *flags]
            gaps_file = Path(tmp) / f"gaps_{label}.json"
            hosted = label in ("a", "b")
            env = RUN_ENV.get(label)
            ours_out = _cli(ROOT, model, tok, flags, env=env)
            theirs_out = _cli(other, model, tok, flags,
                              gaps_file if hosted else None, env=env)
            fast = label in ("i", "p", "p-headtail")
            if fast:
                ours, theirs = [[fast_text(ours_out)]], [[fast_text(theirs_out)]]
            else:
                rows = cont or batch
                ours = streams(ours_out, rows)
                theirs = streams(theirs_out, rows)
            if hosted:
                ref[label] = (theirs[0], json.loads(gaps_file.read_text()))
            if len(ours) != len(theirs):
                raise RuntimeError(f"run {label}: {len(ours)} rows against "
                                   f"{len(theirs)}")
            parts = []
            for row, (a, b) in enumerate(zip(ours, theirs)):
                at = first_difference(a, b)
                if at is None:
                    continue
                if len(a) == len(b) == 1:
                    a, b = a[0], b[0]
                    where = f"row {row} from character {at}"
                else:
                    where = f"piece {at} of {len(b)}"
                note, tie = "", False
                if label in ("a", "b") or (fast and "a" in ref):
                    pieces, gaps = ref["a" if fast else label]
                    step = piece_at(pieces, at) if fast else at
                    tie, gap, tol = near_tie(step, gaps, LOGIT_RTOL)
                    note = (f" (reference top-2 gap {gap:.3e} at token "
                            f"{step}, tolerance {tol:.3e}: "
                            f"{'a near-tie' if tie else 'above it'})")
                if label in EXACT:
                    tie = False
                    note += " (compared exactly)"
                if not cont:
                    ok &= tie
                parts.append(f"{where}: {a[at:at + 24]!r} here, "
                             f"{b[at:at + 24]!r} there{note}")
            note = ""
            if cont and parts:
                note, tie = _chain_check(label, flags, ours, theirs, other,
                                         model, tok, Path(tmp), LOGIT_RTOL)
                ok &= tie and len(parts) == 1
            print(f"run {label}: {len(ours) - len(parts)} of {len(ours)} "
                  f"streams equal" + "".join(f"; {p}" for p in parts)
                  + note, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
