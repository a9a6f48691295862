"""shardcheck's JSON report: every config's sharding findings and its
device-memory components on one H100 80 GB (the port's copy of the
top-level tools/shardcheck.py; the same run as ``python -m
distributed_llama_tpu_torch.analysis --shardcheck``).

    python -m distributed_llama_tpu_torch.tools.shardcheck [--json out.json]
        [--matrix m.json] [--config 70b-tp8-fused-q40]

PERF.md's footprint table is generated from this report. Exit status: 0 =
every config clean; 1 = violations (listed in the JSON); 2 = usage error.
"""

import argparse
import json
import sys

from ..analysis.shardcheck import (SUPPORT_MATRIX, load_matrix, report_json,
                                   run_shardcheck)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="shardcheck",
        description="sharding & device-memory verifier (JSON)")
    ap.add_argument("--json", type=str, default=None,
                    help="write the report here (default: stdout)")
    ap.add_argument("--matrix", type=str, default=None,
                    help="JSON support-matrix override")
    ap.add_argument("--config", type=str, default=None,
                    help="run one config label, e.g. 70b-tp8-fused-q40")
    args = ap.parse_args(argv)
    matrix = load_matrix(args.matrix) if args.matrix else SUPPORT_MATRIX
    if args.config:
        matrix = tuple(e for e in matrix if e.label == args.config)
        if not matrix:
            print(f"shardcheck: no such config {args.config!r} in the "
                  f"matrix", file=sys.stderr)
            return 2
    report = report_json(run_shardcheck(matrix))
    text = json.dumps(report, indent=2)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
        print(f"shardcheck: report -> {args.json} "
              f"({report['n_configs']} configs, "
              f"{report['n_violations']} violating)", file=sys.stderr)
    else:
        print(text)
    return 1 if report["n_violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
