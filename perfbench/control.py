#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the CUDA device of
this machine: for each seed, the numbers the check compares for the
program (the lower reading) and for the control, the plain reference put
in the program's place in the next precision below the configuration's
(TF32 for float32 with TF32 off, float8 e4m3 for bfloat16), which the
limits have to refuse (the upper reading); for a training cell also the
fault of half of each batch left out, planted in the reference.  One JSON
line a seed.

    python3 perfbench/control.py --workload loo-train --seeds 1,2,3

Training needs no window: set-up already ran the program's first steps.
The crowd cells run a short window (``--seconds``) at the cell's own load
and compare as many answers as a run does.  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the control's precision for each configuration's compute dtype
CONTROL = {"float32": "tf32", "bfloat16": "float8"}


def readings(name: str, seed: int, seconds: float, device: str = "cuda",
             overrides=None) -> dict:
    import torch
    from perfbench.drivers import train
    from perfbench.harness import driver_class, load_cell
    from perfbench.reference.precision import Precision
    cell = load_cell(name, overrides=overrides)
    dev = torch.device(device)
    drv = driver_class(cell.mix)(cell.config, cell.mix, seed, dev)
    drv.setup()
    dtype = cell.config["train_config"].get("compute_dtype", "float32")
    ctl = Precision(CONTROL[dtype])
    out = {"workload": name, "seed": seed, "control": ctl.name}
    if cell.mix["driver"] == "train":
        drv.release()
        ref = drv.reference()
        got = train.compare(drv.prog, ref)
        prog = {k: v for k, v, _ in got}
        out["notes"] = {k: n for k, _, n in got if n}
        control = {k: v for k, v, _ in train.compare(
            drv.reference(ctl.name), ref)}
        out["fault_half_batch"] = {k: v for k, v, _ in train.compare(
            drv.reference(half=True), ref)}
    else:
        drv.window(seconds)
        drv.release()
        prog = {c.name: c.value for c in drv.check(cell.limits)}
        gaps = drv.gaps(ctl, against=Precision(dtype))
        control = {"traj_widest": gaps[0], "traj_rms": gaps[1]}
    out.update(program=prog, control_readings=control)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for s in args.seeds.split(","):
        tic = time.perf_counter()
        r = readings(args.workload, int(s), args.seconds)
        r["seconds"] = time.perf_counter() - tic
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
