"""Compare the SASS of one kernel's functions between this tree (or
``--base DIR``) and another checkout: ``cuobjdump -sass`` of each tree's
build of a csrc source (the port's nvcc flags, each tree's own headers,
both built from one directory, build/sass_compare/src/, so the file's path
and the hash nvcc gives its anonymous namespace are the same), the
functions whose name holds ``--function``, each with its ``Function :``
line dropped. A kernel whose
source did not change but shares a library with one that did (K10 beside
K8 and K9 in fused_layer.cu) must compile to the same instructions.

On a machine with the CUDA toolkit, from the repository root:

    python3 -m distributed_llama_tpu_torch.tools.sass_compare --other DIR
        [--base DIR] [--source fused_layer.cu] [--function q40_mega_kernel]

DIR is the other checkout's root (e.g. the parent commit unpacked with
``git archive``). Prints, per function, whether its SASS is identical and,
if not, how many lines differ; exits 1 if any differs or a function is
found in one tree only.
"""

from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ..ops import _build

OUT = _build.BUILD_DIR.parent / "sass_compare"
ROOT = Path(__file__).resolve().parents[2]


def functions(so: Path, part: str, tool: str) -> dict[str, str]:
    """{function name: its SASS, the ``Function :`` line dropped} of every
    function of ``so`` whose name holds ``part``; the name without the hash
    nvcc gives a source's anonymous namespace (it follows the file)."""
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for sec in sass.split("Function : ")[1:]:
        name, body = sec.split("\n", 1)
        if part in name:
            out[re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                       name.strip())] = body
    return out


def build(csrc: Path, source: str, label: str) -> Path:
    """``source`` with its tree's headers, copied into build/sass_compare/
    src/ and built there."""
    src = OUT / "src"
    if src.exists():
        shutil.rmtree(src)
    src.mkdir(parents=True)
    for f in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        shutil.copy(f, src / f.name)
    so = OUT / f"{label}-{Path(source).stem}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
                    "-o", str(so), str(src / source)], check=True)
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--base", default=None,
                    help="the checkout to hold against --other (default: "
                         "this one)")
    ap.add_argument("--source", default="fused_layer.cu")
    ap.add_argument("--function", default="q40_mega_kernel")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    tool = chip_smoke._disassembler()
    other = Path(args.other).resolve() / "distributed_llama_tpu_torch" / "csrc"
    base = (Path(args.base).resolve() / "distributed_llama_tpu_torch" / "csrc"
            if args.base else _build.CSRC)
    ours = functions(build(base, args.source, "this"), args.function, tool)
    theirs = functions(build(other, args.source, "other"), args.function,
                       tool)
    ok = bool(ours) and set(ours) == set(theirs)
    for name in sorted(set(ours) | set(theirs)):
        if name not in ours or name not in theirs:
            where = "this tree" if name in ours else "the other"
            print(f"{name}: only in {where}")
            continue
        a, b = ours[name].splitlines(), theirs[name].splitlines()
        diff = [ln for ln in difflib.unified_diff(a, b, lineterm="", n=0)
                if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
        ok &= not diff
        print(f"{name}: {len(a)} lines, "
              + ("identical" if not diff else f"{len(diff)} lines differ"))
    print(f"sass_compare {args.source} {args.function}: "
          + ("identical" if ok else "DIFFERENT"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
