#!/usr/bin/env python3
"""The bf16 social-attention kernels at every width, and ``simulate --bf16``'s
rate, for one tree on one GPU.

    python3 bf16_times.py [--repo DIR] [--repeats 3] [--out FILE]

Imports ``socialways_torch`` from DIR (default: this checkout), so two
trees are compared under one harness: run it alternately with ``--repo``
of each, one process a run.  Two parts:
- the bf16 forward with stats, dq and dkv (no dx_j) through the launch
  wrappers at H = F = 64 and at each width of ``chip_smoke.py``'s phase 14
  (``chip_smoke.WIDTHS``), on N = 256 ETH/UCY-like sorted scenes of 2-16
  (``chip_smoke.attention_inputs``), random weights from a numpy seed; each
  time ``chip_smoke.median_ms`` (CUDA events), each output's bytes a
  SHA-256 digest (``kernel_times.case``);
- ``cli simulate --bf16`` at ``chip_smoke.CROWD_BF16`` (32,768) and
  ``chip_smoke.CROWD_1M`` agents in scenes of 16 (phase 12d's command) on
  the loo model at full width with random weights from seed 1, ``--repeats``
  times each, alternating the two sizes; each run's agent-steps/s as the
  CLI prints it (its second, timed call).
Prints one JSON object, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def operands(torch, dev, x4, h, ids, width, seed):
    """bf16 operands at H = F = ``width``: x4, ids, h, wh = h W + b, the
    six feature-MLP tensors, and a float32 cotangent g."""
    rng = np.random.RandomState(seed)
    shapes = [(3, 32), (32,), (32, 64), (64,), (64, width), (width,)]
    w = [rng.randn(*s) / np.sqrt(s[0] if len(s) == 2 else 32) for s in shapes]
    attn = rng.randn(width, width) / np.sqrt(width)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    bf = torch.bfloat16
    hf = t(h).to(bf).float()
    wh = (hf @ t(attn) + t(rng.randn(width) * 0.1)).to(bf)
    return (t(x4), torch.from_numpy(ids).to(dev), hf.to(bf), wh,
            [t(a).to(bf) for a in w], t(rng.randn(*h.shape)))


def simulate_rate(cli_main, ckpt, agents) -> float:
    """Agent-steps/s of one ``cli simulate --bf16`` run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["simulate", "--model-file", ckpt, "--agents",
                       str(agents), "--bf16"])
    out = buf.getvalue()
    m = re.search(r"x (\d+) steps .* in ([\d.]+) ms = ", out)
    if rc != 0 or not m or "route=cuda kernel" not in out:
        raise RuntimeError(f"simulate --bf16 {agents}: rc {rc}, {out!r}")
    return agents * int(m.group(1)) / (float(m.group(2)) * 1e-3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose socialways_torch is measured")
    ap.add_argument("--repeats", type=int, default=3,
                    help="simulate runs at each size")
    ap.add_argument("--out", default=None,
                    help="also append the JSON line to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs              # numpy only at import
    import kernel_times as kt
    sys.path.insert(0, os.path.abspath(args.repo))
    import socialways_torch
    from socialways_torch.cli.main import main as cli_main
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.io.checkpoint import save_generator_checkpoint
    from socialways_torch.kernels import social_attention as sa
    from socialways_torch.models.generator import init_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"repo": os.path.dirname(os.path.abspath(
        socialways_torch.__file__)), "card": card, "widths": {}}
    for width in (cs.HIDDEN,) + tuple(cs.WIDTHS):
        x4, h, ids = cs.attention_inputs(np.random.RandomState(5), 256,
                                         width)
        x, i, hh, wh, ws, g = operands(torch, dev, x4, h, ids, width, 7)
        result["widths"][f"H=F={width}"] = kt.case(torch, sa, cs, x, i, hh,
                                                   wh, ws, g, 0)
    work = tempfile.mkdtemp(prefix="bf16_times_")
    try:
        npz = os.path.join(work, "ethucy_like-8-12.npz")
        cs.make_ethucy_like_npz(npz)
        cfg = TrainConfig(agent_frame=True, use_social=True,
                          g_ema_decay=0.999, hidden_size=cs.HIDDEN,
                          social_feature_size=cs.HIDDEN,
                          noise_len=cs.HIDDEN // 2, batch_size=cs.BATCH,
                          n_past=cs.N_PAST, n_next=cs.N_NEXT,
                          n_gen_samples=cs.K)
        ckpt = os.path.join(work, "loo-init.npz")
        save_generator_checkpoint(
            ckpt, init_generator(cfg, torch.Generator().manual_seed(1),
                                 "cpu"), 0, load_npz_dataset(npz).scale, cfg)
        rates = {cs.CROWD_BF16: [], cs.CROWD_1M: []}
        for _ in range(args.repeats):
            for agents in rates:
                rates[agents].append(simulate_rate(cli_main, ckpt, agents))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["simulate_bf16_agent_steps_s"] = {str(k): v
                                             for k, v in rates.items()}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
