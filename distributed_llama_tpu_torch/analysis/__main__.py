"""dlint CLI of the port: ``python -m distributed_llama_tpu_torch.analysis``
(alias ``python -m distributed_llama_tpu_torch.tools.dlint``).

    --lint            AST hazard rules over the package source (default)
    --contracts       program-structure contracts J001-J003, run on
                      --device (a small model)
    --shardcheck      sharding and device-memory verifier over the support
                      matrix (J004/J005/J006 + the H100 budget; the port's
                      tools/shardcheck.py emits the same run as JSON)
    --shardcheck-matrix PATH  JSON support-matrix override for --shardcheck
    --threadcheck     thread-ownership lint over runtime/ + obs/ (T-rules
                      against the analysis/threadmodel.py registry)
    --wirecheck       wire/persistence schema drift lint over runtime/ +
                      obs/ + tools/ (W-rules against analysis/wiremodel.py;
                      the port's tools/wirecheck.py is the dynamic twin)
    --all             all five heads
    --device cuda|cpu where the contracts run (default cuda; on a host
                      with no CUDA, cuda is a usage error, never a CPU
                      fallback)
    --baseline PATH   grandfathered lint findings
                      (default analysis/dlint_baseline.txt)
    --write-baseline  rewrite the baseline from current findings and exit 0
    --threadcheck-baseline PATH  (default analysis/threadcheck_baseline.txt)
    --write-threadcheck-baseline rewrite it from current findings, exit 0
    --wirecheck-baseline PATH  (default analysis/wirecheck_baseline.txt)
    --write-wirecheck-baseline rewrite it from current findings, exit 0
    --no-baseline     report every finding, baselines ignored

Exit status: 0 = no new findings and every contract and config holds;
1 = findings; 2 = usage error. The lint, threadcheck and wirecheck heads
never import the checked code; shardcheck imports it but makes no weight
byte (meta tensors); the contracts run a two-layer model on --device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
PACKAGE_DIR = Path(__file__).resolve().parents[1]
ANALYSIS_DIR = Path(__file__).resolve().parent
DEFAULT_BASELINE = ANALYSIS_DIR / "dlint_baseline.txt"
DEFAULT_THREAD_BASELINE = ANALYSIS_DIR / "threadcheck_baseline.txt"
DEFAULT_WIRE_BASELINE = ANALYSIS_DIR / "wirecheck_baseline.txt"


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dlint", description="the port's static analysis: AST hazard "
        "lint, contracts, shardcheck, threadcheck, wirecheck")
    ap.add_argument("--lint", action="store_true",
                    help="run the AST hazard rules (default)")
    ap.add_argument("--contracts", action="store_true",
                    help="run the contracts J001-J003 on --device")
    ap.add_argument("--shardcheck", action="store_true",
                    help="verify sharding + the H100 memory budget over "
                         "the support matrix")
    ap.add_argument("--shardcheck-matrix", type=Path, default=None,
                    help="JSON support-matrix override for --shardcheck")
    ap.add_argument("--threadcheck", action="store_true",
                    help="run the thread-ownership lint over runtime/ + "
                         "obs/ (pure AST, imports nothing)")
    ap.add_argument("--wirecheck", action="store_true",
                    help="run the wire-schema drift lint over runtime/ + "
                         "obs/ + tools/ (pure AST, imports nothing)")
    ap.add_argument("--all", action="store_true", help="all five heads")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the contracts run (default cuda)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help=f"baseline file (default {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current lint findings")
    ap.add_argument("--threadcheck-baseline", type=Path,
                    default=DEFAULT_THREAD_BASELINE,
                    help=f"threadcheck baseline file "
                         f"(default {DEFAULT_THREAD_BASELINE})")
    ap.add_argument("--write-threadcheck-baseline", action="store_true",
                    help="rewrite the threadcheck baseline from current "
                         "findings")
    ap.add_argument("--wirecheck-baseline", type=Path,
                    default=DEFAULT_WIRE_BASELINE,
                    help=f"wirecheck baseline file "
                         f"(default {DEFAULT_WIRE_BASELINE})")
    ap.add_argument("--write-wirecheck-baseline", action="store_true",
                    help="rewrite the wirecheck baseline from current "
                         "findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baselines (report everything)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files to lint (default: the whole package)")
    args = ap.parse_args(argv)

    # --write-baseline is a lint-head operation: it implies --lint, so
    # `--contracts --write-baseline` can't silently skip the rewrite
    do_lint = (args.lint or args.all or args.write_baseline
               or not (args.contracts or args.shardcheck
                       or args.shardcheck_matrix is not None
                       or args.threadcheck
                       or args.write_threadcheck_baseline
                       or args.wirecheck
                       or args.write_wirecheck_baseline))
    do_contracts = args.contracts or args.all
    # a matrix override implies the head that consumes it (same rule as
    # --write-baseline implying --lint): a forgotten --shardcheck must not
    # silently skip the drift gate the matrix encodes
    do_shardcheck = (args.shardcheck or args.all
                     or args.shardcheck_matrix is not None)
    # same implication rule: rewriting threadcheck's baseline IS running
    # the threadcheck head
    do_threadcheck = (args.threadcheck or args.all
                      or args.write_threadcheck_baseline)
    do_wirecheck = (args.wirecheck or args.all
                    or args.write_wirecheck_baseline)
    if args.write_baseline and args.paths:
        # the baseline is global: rewriting it from a partial scan would
        # silently drop every grandfathered entry for unscanned files
        print("dlint: --write-baseline requires a full-package scan "
              "(no explicit paths)", file=sys.stderr)
        return 2
    if do_contracts and args.device == "cuda" and not _cuda_available():
        print("dlint: --device cuda but torch.cuda.is_available() is "
              "False (pass --device cpu to run the contracts here)",
              file=sys.stderr)
        return 2
    status = 0

    if do_lint:
        from .lint import (apply_baseline, lint_paths, load_baseline,
                           package_files, write_baseline)

        if args.paths:
            missing = [p for p in args.paths if not p.exists()]
            if missing:
                print(f"dlint: no such file: {missing[0]}",
                      file=sys.stderr)
                return 2
            # a directory argument means "everything under it"
            files = [f for p in args.paths
                     for f in (package_files(p) if p.is_dir() else [p])]
        else:
            files = package_files(PACKAGE_DIR)
        findings = lint_paths(files, REPO_ROOT)
        if args.write_baseline:
            write_baseline(args.baseline, findings,
                           "--lint --write-baseline")
            print(f"dlint: baseline rewritten with {len(findings)} "
                  f"finding(s) -> {args.baseline}")
            return 0
        baseline = (load_baseline(args.baseline) if not args.no_baseline
                    else None)
        if baseline is not None:
            new, suppressed, stale = apply_baseline(findings, baseline)
            if args.paths:
                # partial scan: a baseline entry for an unscanned file is
                # not stale, it just wasn't looked at this run
                stale = []
        else:
            new, suppressed, stale = findings, 0, []
        for f in new:
            print(f.render())
        for key in stale:
            print(f"dlint: stale baseline entry (finding fixed — prune "
                  f"with --write-baseline): {key}", file=sys.stderr)
        print(f"dlint: {len(new)} new finding(s), {suppressed} "
              f"baseline-suppressed, {len(files)} file(s)")
        if new:
            status = 1

    if do_threadcheck:
        from .lint import (apply_baseline, load_baseline, package_files,
                           write_baseline)
        from .threadcheck import run_threadcheck, thread_scope

        if args.paths:
            missing = [p for p in args.paths if not p.exists()]
            if missing:
                print(f"threadcheck: no such file: {missing[0]}",
                      file=sys.stderr)
                return 2
            tfiles = [f for p in args.paths
                      for f in (package_files(p) if p.is_dir() else [p])]
        else:
            tfiles = package_files(PACKAGE_DIR)
        if args.write_threadcheck_baseline and args.paths:
            print("threadcheck: --write-threadcheck-baseline requires a "
                  "full-package scan (no explicit paths)",
                  file=sys.stderr)
            return 2
        tfindings = run_threadcheck(tfiles, REPO_ROOT)
        if args.write_threadcheck_baseline:
            write_baseline(args.threadcheck_baseline, tfindings,
                           "--write-threadcheck-baseline")
            print(f"threadcheck: baseline rewritten with "
                  f"{len(tfindings)} finding(s) -> "
                  f"{args.threadcheck_baseline}")
            return 0
        tbaseline = (load_baseline(args.threadcheck_baseline)
                     if not args.no_baseline else None)
        if tbaseline is not None:
            tnew, tsupp, tstale = apply_baseline(tfindings, tbaseline)
            if args.paths:
                tstale = []  # partial scan: unscanned files aren't stale
        else:
            tnew, tsupp, tstale = tfindings, 0, []
        for f in tnew:
            print(f.render())
        for key in tstale:
            print(f"threadcheck: stale baseline entry (finding fixed — "
                  f"prune with --write-threadcheck-baseline): {key}",
                  file=sys.stderr)
        n_scoped = sum(1 for f in tfiles
                       if thread_scope(f.as_posix()))
        print(f"threadcheck: {len(tnew)} new finding(s), {tsupp} "
              f"baseline-suppressed, {n_scoped} file(s) in scope")
        if tnew:
            status = 1

    if do_wirecheck:
        from .lint import (apply_baseline, load_baseline, package_files,
                           write_baseline)
        from .wirecheck import run_wirecheck, wire_files, wire_scope

        if args.paths:
            missing = [p for p in args.paths if not p.exists()]
            if missing:
                print(f"wirecheck: no such file: {missing[0]}",
                      file=sys.stderr)
                return 2
            wfiles = [f for p in args.paths
                      for f in (package_files(p) if p.is_dir() else [p])]
        else:
            # unlike the other heads, the scan set includes tools/*.py:
            # the fleet scraper and the corpus CLIs consume these
            # formats from outside the package
            wfiles = wire_files(PACKAGE_DIR, REPO_ROOT)
        if args.write_wirecheck_baseline and args.paths:
            print("wirecheck: --write-wirecheck-baseline requires a "
                  "full-package scan (no explicit paths)",
                  file=sys.stderr)
            return 2
        # registry-consistency and site-resolution checks only make
        # sense against the whole tree — a partial scan would report
        # every unscanned site as unresolved
        wfindings = run_wirecheck(wfiles, REPO_ROOT,
                                  full_scan=not args.paths)
        if args.write_wirecheck_baseline:
            write_baseline(args.wirecheck_baseline, wfindings,
                           "--write-wirecheck-baseline")
            print(f"wirecheck: baseline rewritten with "
                  f"{len(wfindings)} finding(s) -> "
                  f"{args.wirecheck_baseline}")
            return 0
        wbaseline = (load_baseline(args.wirecheck_baseline)
                     if not args.no_baseline else None)
        if wbaseline is not None:
            wnew, wsupp, wstale = apply_baseline(wfindings, wbaseline)
            if args.paths:
                wstale = []  # partial scan: unscanned files aren't stale
        else:
            wnew, wsupp, wstale = wfindings, 0, []
        for f in wnew:
            print(f.render())
        for key in wstale:
            print(f"wirecheck: stale baseline entry (finding fixed — "
                  f"prune with --write-wirecheck-baseline): {key}",
                  file=sys.stderr)
        n_wscoped = sum(1 for f in wfiles
                        if wire_scope(f.as_posix()))
        print(f"wirecheck: {len(wnew)} new finding(s), {wsupp} "
              f"baseline-suppressed, {n_wscoped} file(s) in scope")
        if wnew:
            status = 1

    if do_contracts:
        from .contracts import run_contracts

        results = run_contracts(args.device)
        for r in results:
            mark = "ok " if r.ok else "FAIL"
            print(f"dlint: contract {r.contract} {mark} {r.name}: "
                  f"{r.detail}")
            if not r.ok:
                status = 1

    if do_shardcheck:
        from .memory_model import GIB
        from .shardcheck import load_matrix, run_shardcheck

        matrix = (load_matrix(args.shardcheck_matrix)
                  if args.shardcheck_matrix else None)
        results = run_shardcheck(matrix)
        n_bad = 0
        for r in results:
            if r.ok:
                rep = r.report
                print(f"shardcheck: {r.config} ok "
                      f"{'fits' if rep.fits else 'no-fit (as declared)'}, "
                      f"{rep.total_bytes / GIB:.2f} GiB/rank, headroom "
                      f"{rep.headroom_bytes / GIB:+.2f} GiB")
            else:
                n_bad += 1
                for f in r.findings:
                    print(f.render())
        print(f"shardcheck: {len(results)} config(s), {n_bad} violating")
        if n_bad:
            status = 1

    return status


if __name__ == "__main__":
    sys.exit(main())
