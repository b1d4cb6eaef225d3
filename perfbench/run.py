#!/usr/bin/env python3
"""Run one cell of the benchmark of ``socialways_torch`` once, on the CUDA
device of this machine, and print its result as the last line of
standard output (one JSON object), with each number the correctness check
compared beside its limit as the last lines of standard error.

    python3 perfbench/run.py --workload loo-train --seed 7 --seconds 20 \
        --trace 0

Run it from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` its per-layer metrics, from a short
block traced by torch.profiler after the window, and the trace's
breakdown.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"error: no workload {args.workload!r}", file=sys.stderr)
        return 2
    try:
        import socialways_torch  # noqa: F401
    except ImportError:
        print("error: socialways_torch is not in this checkout",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; the benchmark measures on the card "
              "only", file=sys.stderr)
        return 1
    chips = cells[args.workload]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA devices, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    from perfbench.harness import forbidden_modules, run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 1
    for c in result["checks"].values():
        if c["value"] != c["value"] or abs(c["value"]) == float("inf"):
            c["value"] = repr(c["value"])       # JSON has no NaN
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
