"""Run chip_smoke.py's CLI runs b and k-n from two checkouts on one model
and compare their token streams. Run from the root of a checkout, on a
machine with an NVIDIA GPU, after chip_smoke.py has written its model
(``python3 -c "import chip_smoke; chip_smoke.smoke_files()"``):

    python3 -m distributed_llama_tpu_torch.tools.stream_compare --other DIR

DIR holds another commit of the repository (``git archive``); each run is
the ``inference`` CLI in a process of its own, with the checkout it belongs
to first on ``PYTHONPATH``, so each builds and runs its own kernels. Run b
(the 512-token prompt at chunk 128, greedy) is compared piece by piece; runs
k-n (12 prompts through ``--continuous``: f32 pages, contiguous, bf16 pages,
Q8 pages sampled at 0.8) row by row. A line per run says which rows are
equal and, for each row that parts, the first piece that differs and what
each side printed there. Exit code 0 when every stream is equal, else 1.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _runs(smoke) -> dict[str, list[str]]:
    """The CLI flags of runs b and k-n, as chip_smoke.py gives them (the
    prompts file is added where a run takes one)."""
    cont = ["--continuous", "--slots", str(smoke.CONT_SLOTS),
            "--prefill-chunk", str(smoke.CONT_CHUNK), "--steps",
            str(smoke.CONT_STEPS), "--temperature", "0", "--seed", "1"]
    page = ["--kv-page-size", str(smoke.PAGE)]
    return {
        "b": ["--prompt", smoke.PROMPT_512, "--steps", str(smoke.STEPS_512),
              "--temperature", "0", "--seed", "1", "--prefill-chunk",
              str(smoke.CHUNK)],
        "k": [*cont, *page],
        "l": cont,
        "m": [*cont, *page, "--kv-cache-dtype", "bf16", "--block-steps",
              "16"],
        "n": [*cont, *page, "--kv-quant", "q8", "--block-steps", "16",
              "--temperature", "0.8", "--seed", "7", "--kv-pages", "32"],
    }


def _cli(tree: Path, model: Path, tok: Path, flags: list[str]) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_llama_tpu_torch.frontend.cli",
         "inference", "--model", str(model), "--tokenizer", str(tok),
         *flags], cwd=tree, env=env, capture_output=True, text=True)
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
                    help="the root of the other checkout")
    ap.add_argument("--runs", default="b,k,l,m,n")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    model = smoke.SMOKE_DIR / "llama2_7b_q40_seed0.bin"
    tok = smoke.SMOKE_DIR / "tokenizer_32000.bin"
    if not model.exists():
        print(f"stream_compare: no model at {model}: run chip_smoke's "
              f"smoke_files first")
        return 2
    other = Path(args.other).resolve()
    runs = _runs(smoke)
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        prompts = Path(tmp) / "continuous.txt"
        prompts.write_text("\n".join(smoke.CONT_PROMPTS) + "\n")
        for label in args.runs.split(","):
            flags = runs[label]
            cont = "--continuous" in flags
            if cont:
                flags = ["--prompts-file", str(prompts), *flags]
            ours = streams(_cli(ROOT, model, tok, flags), cont)
            theirs = streams(_cli(other, model, tok, flags), cont)
            if len(ours) != len(theirs):
                raise RuntimeError(f"run {label}: {len(ours)} rows against "
                                   f"{len(theirs)}")
            parts = []
            for row, (a, b) in enumerate(zip(ours, theirs)):
                at = first_difference(a, b)
                if at is None:
                    continue
                if cont:
                    a, b = a[0], b[0]
                    where = f"row {row} from character {at}"
                else:
                    where = f"piece {at} of {len(a)}"
                parts.append(f"{where}: {a[at:at + 24]!r} here, "
                             f"{b[at:at + 24]!r} there")
            same &= not parts
            print(f"run {label}: {len(ours) - len(parts)} of {len(ours)} "
                  f"streams equal" + "".join(f"; {p}" for p in parts),
                  flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
