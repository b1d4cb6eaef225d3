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
seed.  Also dq's member launch at M = 4 (four weight draws and h, shared
x4 and ids) on both inputs, in float32 and bf16, with its bound
(``chip_smoke.attention_bwd_bound``).  And, in a tree that has it
(``socialways_torch.kernels.decode_rollout``), the fused bf16 decode of
12 steps at 1,048,576 rows (a crowd-sim window) and 16,384 agents x 20
draws (a large forecast request) at the crowd widths, beside the plain
bf16 loop on the same operands and the decode's bound (its products at
989 TFLOP/s against its bytes at 3.35 TB/s); and the bf16 observation
encoder (the embedding and 8 LSTM steps; in a tree that has it,
``kernels.encode_observation``, one kernel) at 1,048,576 rows (a
crowd-sim window) and 16,384 (a large forecast request) at hidden 64,
beside the plain bf16 encode and its bound likewise.  Each time is
``chip_smoke.median_ms`` (CUDA events, the device kept busy).  Prints one
JSON object: per case the median time in ms and a SHA-256 of the outputs'
bytes, so two trees that launch the same arithmetic show the same digest.
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


def member_dq(torch, sa, cs, dev, x4, h, ids, op, max_scene, members=4):
    """{"dq": {"ms", "sha256", "bound_ms"}} of dq's member launch: the
    members' operands (``operands`` with seeds 7, 8, ...) stacked, x4 and
    ids shared, after the member forward gave stats, u and c."""
    per = [operands(torch, dev, x4, h, ids, op, 7 + k) for k in range(members)]
    x, i = per[0][0], per[0][1]
    stack = lambda ts: torch.stack(ts).contiguous()
    hh, wh, g = (stack([p[k] for p in per]) for k in (2, 3, 5))
    w = [stack([p[4][k] for p in per]) for k in range(6)]
    with torch.no_grad():
        out, stats, u, c = sa._launch_fwd(x, i, hh, wh, w, True, max_scene)
        args = (x, i, hh, wh, g, stats, (g * out).sum(-1), w, u, c)
        fn = lambda: sa.social_attention_bwd_dq(*args, max_scene=max_scene)
        dx = fn()
        torch.cuda.synchronize()
        bound = cs.attention_bwd_bound(
            ids, h.shape[0], HIDDEN, HIDDEN, sum(t[0].numel() for t in w),
            "dq", op_bytes=2 if op == torch.bfloat16 else 4, members=members)
        return {"dq": {"ms": cs.median_ms(torch, fn),
                       "sha256": hashlib.sha256(
                           dx.cpu().numpy().tobytes()).hexdigest()[:16],
                       "bound_ms": bound["bound_ms"]}}


def decode_case(torch, cs, dev, n, r):
    """The fused decode of ``r`` draws of ``n`` prepared rows, the plain
    loop on the same operands (grad on, nothing requiring it) and the
    bound, in ms."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.models.generator import (decode_rollout,
                                                   init_generator)
    from socialways_torch.ops.nn import cast_params
    H, Z = HIDDEN, HIDDEN // 2
    cfg = TrainConfig(hidden_size=H, social_feature_size=H, noise_len=Z)
    g = init_generator(cfg, torch.Generator().manual_seed(3), dev)
    params = cast_params(g.requires_grad_(False), torch.bfloat16)
    rng = np.random.RandomState(11)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        dev, torch.bfloat16)
    prep = (t(np.tanh(rng.randn(n, H))), t(rng.randn(n, H) * 0.7),
            t(rng.randn(n, H) * 0.5), t(rng.rand(n, 2) * 4 - 2))
    noise = t(rng.rand(r * n, Z))

    def fused():
        with torch.no_grad():
            return decode_rollout(params, prep, noise, 12)

    def plain():
        with torch.enable_grad():
            return decode_rollout(params, prep, noise, 12)
    out = fused()
    torch.cuda.synchronize()
    d = H + H + Z
    macs = (d * d + d * (d // 2) + (d // 2) * (d // 4) + (d // 4) * 2
            + 4 * H + 2 * H * 4 * H)         # a row-step; the weights
    flops = 2 * r * n * 12 * macs
    nbytes = 2 * (n * (3 * H + 2) + r * n * (Z + 12 * 4) + macs)
    return {"ms": cs.median_ms(torch, fused),
            "plain_ms": cs.median_ms(torch, plain),
            "bound_ms": 1e3 * max(flops / 989e12, nbytes / 3.35e12),
            "sha256": hashlib.sha256(
                out.view(torch.int16).cpu().numpy().tobytes()
            ).hexdigest()[:16]}


def encode_case(torch, cs, dev, n):
    """The bf16 encode of ``n`` rows of ``cs.N_PAST`` observed steps at
    hidden 64 (``cs.encode_operands``) as the tree runs it without a
    gradient (one kernel where it has one), the plain path on the same
    operands (grad on, nothing requiring it) and ``cs.encode_bound``, in
    ms."""
    from socialways_torch.models.generator import encode_observation
    params, x = cs.encode_operands(torch, dev, n, 13)

    def fused():
        with torch.no_grad():
            return encode_observation(params, x)

    def plain():
        with torch.enable_grad():
            return encode_observation(params, x)
    h, c = fused()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in (h, c):
        digest.update(t.view(torch.int16).cpu().numpy().tobytes())
    return {"ms": cs.median_ms(torch, fused),
            "plain_ms": cs.median_ms(torch, plain),
            "bound_ms": cs.encode_bound(n)["bound_ms"],
            "sha256": digest.hexdigest()[:16]}


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
            result[f"{tag} M=4 {str(op).split('.')[-1]}"] = member_dq(
                torch, sa, cs, dev, x4, h, ids, op, w)
    if os.path.isfile(os.path.join(os.path.dirname(sa.__file__),
                                   "decode_rollout.py")):
        for n, r in ((1_048_576, 1), (16_384, 20)):
            result[f"decode N={n} R={r}"] = decode_case(torch, cs, dev, n, r)
    for n in (1_048_576, 16_384):
        result[f"encode N={n} T=8"] = encode_case(torch, cs, dev, n)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
