#!/usr/bin/env python3
"""Times of the three social-attention kernels for one model, on one GPU.

    python3 kernel_times.py [--repo DIR] [--out FILE]

Imports ``socialways_torch`` from DIR (default: this checkout), so two
trees are compared under one harness: run it alternately with ``--repo``
of each, one process a run.  Calls the launch wrappers on single-model
operands (``h`` [N, H]): the forward without and with stats, dq, and dkv
with its finalize (no dx_j), in float32 and bf16, at N = 256 (ETH/UCY-
like sorted scenes of 2-16, ``chip_smoke.attention_inputs``) and at N =
10,000 in sorted scenes of 16 scanned at window w = 16
(``chip_smoke.crowd_inputs``); H = F = 64, random weights from a numpy
seed.  Each time is ``chip_smoke.median_ms`` (CUDA events, the device
kept busy).  Prints one JSON object: per case the median time in ms and
a SHA-256 of the outputs' bytes, so two trees that launch the same
arithmetic show the same digest.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HIDDEN = 64


def operands(torch, dev, x4, h, ids, op, seed):
    """Device operands of the wrappers: x4, ids, h and wh = h W + b in
    ``op`` (wh from float32), the six feature-MLP tensors in ``op``, and a
    cotangent g."""
    rng = np.random.RandomState(seed)
    shapes = [(3, 32), (32,), (32, 64), (64,), (64, HIDDEN), (HIDDEN,)]
    w = [rng.randn(*s) / np.sqrt(s[0] if len(s) == 2 else 32) for s in shapes]
    attn = rng.randn(HIDDEN, HIDDEN) / np.sqrt(HIDDEN)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    hf = t(h).to(op).float()
    wh = (hf @ t(attn) + t(rng.randn(HIDDEN) * 0.1)).to(op)
    g = t(rng.randn(*h.shape))
    return (t(x4), torch.from_numpy(ids).to(dev), hf.to(op), wh,
            [t(a).to(op) for a in w], g)


def case(torch, sa, cs, x4, ids, h, wh, w, g, max_scene):
    """{kernel: {"ms", "sha256"}} of each launch on these operands."""
    with torch.no_grad():
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, True, max_scene)
        r = (g * out).sum(-1)
        args = (x4, ids, h, wh, g, stats, r, w, u, c)
        calls = {
            "fwd": lambda: sa._launch_fwd(x4, ids, h, wh, w, False,
                                          max_scene),
            "fwd_stats": lambda: sa._launch_fwd(x4, ids, h, wh, w, True,
                                                max_scene),
            "dq": lambda: sa.social_attention_bwd_dq(*args,
                                                     max_scene=max_scene),
            "dkv": lambda: sa.social_attention_bwd_dkv(
                *args, need_dx=False, max_scene=max_scene)}
        res = {}
        for key, fn in calls.items():
            outs = fn()
            outs = ([outs] if isinstance(outs, torch.Tensor)
                    else [o for o in outs if o is not None])
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for o in outs:
                digest.update(o.contiguous().cpu().numpy().tobytes())
            res[key] = {"ms": cs.median_ms(torch, fn),
                        "sha256": digest.hexdigest()[:16]}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose socialways_torch is measured")
    ap.add_argument("--out", default=None,
                    help="also append the JSON line to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs              # numpy only at import
    sys.path.insert(0, os.path.abspath(args.repo))
    import socialways_torch
    from socialways_torch.kernels import social_attention as sa
    dev = torch.device("cuda")
    inputs = {
        "N=256": (*cs.attention_inputs(np.random.RandomState(5), 256,
                                       HIDDEN), 0),
        f"N={cs.CROWD_N} w={cs.CROWD_SCENE}": (
            *cs.crowd_inputs(np.random.RandomState(23), cs.CROWD_N, HIDDEN),
            cs.CROWD_SCENE)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"repo": os.path.dirname(os.path.abspath(
        socialways_torch.__file__)), "card": card}
    for tag, (x4, h, ids, w) in inputs.items():
        for op in (torch.float32, torch.bfloat16):
            x, i, hh, wh, ws, g = operands(torch, dev, x4, h, ids, op, 7)
            result[f"{tag} {str(op).split('.')[-1]}"] = case(
                torch, sa, cs, x, i, hh, wh, ws, g, w)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
