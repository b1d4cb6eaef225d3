#!/usr/bin/env python3
"""How often torch.profiler's trace of a graphed loo epoch loses the records
of social-attention launches that the credited counters count, on one GPU.

    python3 trace_loss.py [--epochs 15]

Runs ``chip_smoke.py``'s phase 18g / 17a epoch (``chip_smoke.loo_cfg`` on
its ETH/UCY-like npz, every step a CUDA graph replay) solo and on a mesh of
one NCCL rank, each traced ``--epochs`` times with CPU and CUDA activities
and as many with CUDA alone.  Prints, for every traced epoch, its device
records and the forward / dq / dkv kernels the trace names against the
credited counters, then a summary line for each of the four settings.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def traced_epochs(torch, dev, npz, mesh, epochs, tag):
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer
    from socialways_torch.kernels import social_attention as sa
    tr = Trainer(cs.loo_cfg(), load_npz_dataset(npz), dev, mesh)
    state = tr.init_state(1)
    rng = torch.Generator(device=dev).manual_seed(3)
    state, _ = tr.train_epoch(state, rng)        # the captures
    rows = []
    for acts in (("cpu", "cuda"), ("cuda",)):
        activities = [getattr(ProfilerActivity, a.upper()) for a in acts]
        for r in range(epochs):
            cs.reset_launches(sa)
            with profile(activities=activities) as prof:
                state, _ = tr.train_epoch(state, rng)
                torch.cuda.synchronize()
            credited = cs.read_launches(sa)
            names = [e.name for e in prof.events()
                     if e.device_type.name == "CUDA"]
            seen = {"fwd": sum("social_attention_fwd_kernel" in n
                               for n in names),
                    "dq": sum("bwd_dq_kernel" in n for n in names),
                    "dkv": sum("bwd_dkv_kernel" in n for n in names)}
            setting = f"{tag} {'+'.join(acts)}"
            rows.append((setting, len(names), seen != credited))
            print(f"{setting} epoch {r}: {len(names)} device records, "
                  f"trace {seen}, credited {credited}"
                  + (" LOST" if seen != credited else ""), flush=True)
    return rows


def mesh_epochs(mesh, npz, epochs):
    import torch
    return traced_epochs(torch, mesh.device, npz, mesh, epochs, "mesh1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=15)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from socialways_torch.kernels import _build
    from socialways_torch.parallel.mesh import run
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    _build.build(["social_attention_fwd", "social_attention_bwd"])
    with tempfile.TemporaryDirectory(prefix="trace_loss_") as work:
        npz = os.path.join(work, "ethucy_like-8-12.npz")
        cs.make_ethucy_like_npz(npz)
        rows = traced_epochs(torch, torch.device("cuda"), npz, None,
                             args.epochs, "solo")
        rows += run(mesh_epochs, 1, "cuda", args=(npz, args.epochs))
    for setting in dict.fromkeys(r[0] for r in rows):
        sel = [r for r in rows if r[0] == setting]
        print(f"{setting}: {sum(r[2] for r in sel)} of {len(sel)} traced "
              f"epochs lost a kernel's record; device records "
              f"{min(r[1] for r in sel)}-{max(r[1] for r in sel)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
