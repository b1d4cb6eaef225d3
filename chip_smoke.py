#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (socialways_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of socialways_tpu, and fails (non-zero exit,
no result line) without a CUDA device or outside a checkout of the repo.
Float32 matmuls and convolutions run in full precision: TF32 is switched
off for both, so the CUDA and CPU paths are held to f32 tolerances.

Phases (any failure raises):
1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. build every kernel from csrc/ (one nvcc per source, in parallel),
   print ptxas's registers and spills for each kernel's float and bf16
   entry, narrow (H and F up to 128) and wide, and fail if any spills or
   a narrow float32 kernel's registers move more than 2 from
   ``PTXAS_KERNELS``;
3. the forward kernel against its plain PyTorch version on the card, f32,
   at rtol 2e-4 / atol 2e-5, timed with CUDA events (median of repeats):
   its two launches alone (``_launch_fwd`` with wh = h W + b computed
   beforehand) and, on a line of its own, the wrapper with wh; against the
   launch floor (a one-element op) and the u-form bound;
4. the backward kernels (dq, dkv) and the autograd Function against their
   plain versions and autograd through the plain forward, at three
   synthetic shapes, shuffled scene ids, one dense 256-row scene, a ragged
   N and the training path's first chunk, timed, with the forward's, dq's
   and dkv's time split by launch (torch.profiler), and dq and dkv each
   run twice for equal bits;
5. the serving slice end to end through the CLI entry points at the loo
   model's full width (hidden 64, batch 256, K 20, 8+12 steps) on a seeded
   synthetic ETH/UCY-scale windowed npz: ``evaluate`` and ``predict``, the
   forward's launch count over them, a CPU rerun of the first chunks under
   the same weights and noise, and the K=20 rollout rate;
6. the training slice at the same width: a CUDA-vs-CPU first GAN step from
   one state under the same draws, one epoch with the kernels' launch
   counts, train steps/s, a profiled step, ``reinit_discriminator``;
7. ``cli train --recipe loo`` for 2 epochs, a resumed 3rd, ``evaluate`` of
   the final checkpoint;
8. the real-data pipeline at the same width: five synthetic obsmat scenes
   in the public layouts (a space-separated zara file among them, plus an
   umbrella-directory file and a decoy that are not scenes), ``cli
   eth-ucy`` on them (discovery, npz build, 5 folds of 3 epochs with an
   eval each) with the kernels' launches against its steps and eval
   chunks, the folds' train steps/s and the projected 30k-epoch fold;
   ``cli predict`` on a raw obsmat file; ``cli evaluate --linear kalman``
   and ``predict_kalman`` on the card against the CPU;
9. the toy protocol at the same width on the JAX protocol's big toy set
   (``create-toy``, scenes of 8 agents, 2+2 steps): ``cli train --recipe
   toy-flagship`` for 12 epochs with dumps, metrics log, a profiler trace
   of epoch 2 (it must name the forward and dkv kernels), coverage
   tracking and the rescues; ``cli stats`` over the dumps; ``cli sweep``
   over unroll 0/1/5 x info 0/1; forward launches held equal to train
   steps + rollouts (eval chunks, coverage, dumps) and dkv to the steps in
   both runs; one toy-flagship step profiled; an unroll-5 categorical step
   with a decayed D lr on the card against the CPU;
10. every other ``gan_step`` variant through ``cli train`` at the same
   width: (a) on the loo data, the LSTM decoder with gaussian noise, the
   l2 and variety losses, the gradient clip and the info ramp, then
   ``evaluate`` and ``predict`` of its checkpoint; (b) on the big toy set,
   pac 2, minibatch stddev, spectral norm, R1, mode seeking, the diversity
   hinge at ds_k 4 and the D/G-ratio schedule; (c) accumulation over 4
   micro-chunks with pac, mb_std and remat, and a serial-rollout run.
   Each run's first step on the card against the CPU; forward, dkv and dq
   launches held to the per-step counts PERF.md predicts plus one forward
   a rollout; train steps/s over each run's last epoch;
11. crowd scale, at the loo model's width: (a) the kernels at N = 10,000
   in sorted scenes of 16 with a padded tail: forward with and without
   stats, dq and dkv at scene window w = 16 equal their w = 0 launch bit
   for bit and match the plain windowed form, each timed alone at both w
   beside its bound; the w = 16 forward at N = 1,048,576, timed and held
   against the plain windowed form; (b) ``cli simulate`` at its defaults
   (10,000 agents in scenes of 16, 4 windows) and at 1,048,576 agents from
   phase 7's loo checkpoint, agent-steps/s, exactly 8 forward launches a
   run and no backward, the trajectories at 10,000 agents and 1 window
   against the CPU under the same checkpoint and noise, and one window
   profiled at each size; (c) ``cli
   train --recipe loo --max-scene-size 16`` on a synthetic crowd npz at
   batch 4,608 (the CPU takes the windowed form; first step card vs CPU)
   and 16,384 (train steps/s), launches one forward and one dkv a step
   plus one forward an eval chunk;
12. bf16 (``--bf16``, the kernels' bf16 entry points): (a) each bf16
   kernel against its plain bf16 version at the loo training chunk (N =
   256), at N = 10,000 in sorted scenes of 16 (w = 16 equal to w = 0 bit
   for bit) and, the forward only, at N = 32,768, each timed alone beside
   the float32 kernel on the same values and its bound; (b) ``cli train
   --recipe loo --bf16`` (first step card vs CPU, a profiled step,
   launches equal to the float32 run's counts, float32 state); (c)
   ``evaluate --bf16`` and ``predict --bf16`` of phase 7's checkpoint, ADE/
   FDE against its float32 evaluate, the K = 20 rollout card vs CPU and
   its rate; (d) ``cli simulate --bf16`` at 32,768 and 1,048,576 agents,
   trajectories card vs CPU at 10,000, a profiled 1M window; (e) ``cli
   train --recipe loo --bf16 --grad-accum 4 --remat-steps
   --max-scene-size 16`` at batch 16,384 on a crowd npz of scenes of 16.
   Every bf16 run launches no float32 kernel;
13. the ensemble (``engine/ensemble.py``, the kernels' member axis): (a)
   each kernel's member launch at M = 4 on the loo training chunk's ids,
   float32 and bf16 (forward with and without stats, dq, dkv with and
   without dx_j), each member bit for bit equal to a launch of its
   operands alone (M = 1), held against the member plain versions at
   phase 4's and phase 12's bounds and timed beside 4 solo launches and
   the member launch's bound; the float32 forward at N = 10,000, w = 16 likewise; (b)
   ``EnsembleTrainer`` on the loo recipe at full width, 4 seeds: the
   first member-batched step against 4 solo steps (losses rel 1e-4,
   state 1e-3 of its scale), one epoch and ``evaluate`` against solo runs
   (rel 2e-4), launches forward = steps + eval chunks and dkv = steps, as
   a solo run's, every one a member launch, dq 0; (c) member-steps/s at M
   = 1, 4, 8 against solo train steps/s, alternated, and one profiled
   step at M = 4; (d) the robust1 base on the big toy set, 3 seeds x 2
   epochs: each member's coverage equals its solo run's;
14. every width JAX runs (the kernels took H and F in multiples of 16 up
   to 128): (a) at H = F = 64, 24, 100, 256 and 512 on the first loo
   training chunk (generators of that width, their encoder states), the
   forward with stats, dq and dkv in float32 (phase 4's checks, dx held
   by the f64 witness) and bf16 (phase 12's), and at M = 4 for 24 and 256
   (phase 13's), each timed, the kernel launch counters going up in each;
   (b) ``cli train --recipe loo --hidden-size`` 256 and 24 for an epoch:
   the first step on the card against the CPU, launches exact;
15. JAX's loop flags: ``cli train --recipe loo --fused-epochs --block-size
   2 --epochs 4 --test-interval 2 --save-interval 2 --pallas --host-loop
   --latent-dim 10`` on phase 7's npz (launches exact, one print and one
   metrics row a block, a checkpoint and an eval at each block's end) and
   ``cli simulate --pallas`` at 10,000 agents (8 launches exactly);
16. a ``kernels`` JSON line, then the device JSON as the last line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 2e-4, 2e-5             # kernel vs plain (sums in another order)
H100_F32_FLOPS = 67e12              # FP32 (non-tensor) peak, H100 SXM
H100_BF16_TC_FLOPS = 989e12         # bf16 dense tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12          # HBM3
K, N_PAST, N_NEXT, BATCH, HIDDEN = 20, 8, 12, 256, 64
KERNELS = ["social_attention_fwd", "social_attention_bwd",
           "social_attention_fwd_bf16", "social_attention_bwd_bf16",
           "social_attention_fwd_wide", "social_attention_bwd_wide",
           "social_attention_fwd_wide_bf16", "social_attention_bwd_wide_bf16"]
SHAPES = [("eth-like N=256 H=F=64", 256, 64, 0),
          ("eth-like N=256 H=F=32", 256, 32, 0),
          ("scenes of 64 N=2048 H=F=64", 2048, 64, 64)]
# more kernel checks: unsorted ids, the pair-batching stress (one scene of
# 256: 65,280 pairs) and N not a multiple of the 2 rows a block takes
EXTRA_SHAPES = [("eth-like shuffled ids N=256 H=F=64", 256, 64, "shuffled"),
                ("one dense scene N=256 H=F=64", 256, 64, 256),
                ("eth-like ragged N=301 H=F=64", 301, 64, 0)]


def make_ethucy_like_npz(path: str, n_windows: int = 8000, seed: int = 0,
                         scene: int = 0) -> None:
    """Windowed npz ({obsvs, preds, times, batches}, meters) shaped like the
    ETH/UCY sets: scenes of 2-16 pedestrians (``scene`` > 0: all of that
    size) in a 15 m square walking 0.8-1.6 m/s at 0.4 s a step with slight
    turns; 5 % stand still (zero displacement, the agent-frame identity
    fallback)."""
    rng = np.random.RandomState(seed)
    obsvs, preds, times, batches = [], [], [], []
    n = 0
    while n < n_windows:
        s = scene or int(rng.randint(2, 17))
        start = rng.uniform(0.0, 15.0, (s, 1, 2))
        heading = rng.uniform(0.0, 2 * np.pi, (s, 1))
        ang = heading + np.cumsum(rng.normal(0.0, 0.05, (s, 20)), axis=1)
        speed = rng.uniform(0.8, 1.6, (s, 1, 1)) * 0.4
        speed[rng.rand(s) < 0.05] = 0.0
        steps = speed * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        traj = (start + np.cumsum(steps, axis=1)).astype(np.float32)
        obsvs.append(traj[:, :N_PAST])
        preds.append(traj[:, N_PAST:])
        times.append(np.full(s, len(batches) * 10, np.int64))
        batches.append([n, n + s])
        n += s
    np.savez(path, obsvs=np.concatenate(obsvs), preds=np.concatenate(preds),
             times=np.concatenate(times), batches=np.asarray(batches))


def median_ms(torch, fn, budget_s: float = 0.25, repeats: int = 5) -> float:
    """Device time of one ``fn()`` call: CUDA events around a run of calls
    queued behind a device sleep (so host overhead is hidden where the
    device is the bottleneck), median of ``repeats``.  The run length fits
    ``budget_s`` (3 to 50 calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = int(min(50, max(3, budget_s / max(time.perf_counter() - tic,
                                             1e-6))))
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _pairs(ids: np.ndarray) -> int:
    _, sizes = np.unique(ids[ids >= 0], return_counts=True)
    return int(np.sum(sizes * (sizes - 1)))


def _bound(flop: float, nbytes: float, tc_flop: float = 0.0) -> dict:
    """``flop`` at the FP32 peak plus ``tc_flop`` (products of bf16
    operands) at the bf16 tensor-core peak, against ``nbytes`` at the HBM
    rate."""
    ops_ms = (flop / H100_F32_FLOPS + tc_flop / H100_BF16_TC_FLOPS) * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"flop": flop, "tc_flop": tc_flop, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                    n_mlp: int, with_wh: bool = False,
                    op_bytes: int = 4, members: int = 1) -> dict:
    """Least time of the social-attention forward on this input, in the
    u-form the kernel computes: same-scene ordered pairs x (3->32 and
    32->64 layers and a2 . u_j: 96 + 2048 + 64 MAC), u = W3 wh (N 64 F)
    and, where the timed call includes it, wh = h W + b (N H F), at the f32
    peak; against the bytes of x4, ids, h, wh (or, with ``with_wh``, the
    attention weights W, b), the ``n_mlp`` feature-MLP weights, out, u and
    c at the HBM rate.  ``old_*``: the count of the f_ij . wh_j form
    (64 F + 2 F MAC a pair instead of 64), for comparison.  ``op_bytes``:
    the bytes of an element of h, wh and the weights (4, or 2 for bf16
    operands).  With bf16 operands the same operations are counted, but
    every product of two bf16 operands with float32 sums (the 3->32 and
    32->64 layers, u = W3 wh and wh = h W) is costed at the bf16
    tensor-core peak; a2 . u_j (u float32) stays at the FP32 peak.
    ``members``: M stacked models in one launch on one shared x4 and ids,
    which are read once; every other byte and every operation counts M
    times."""
    pairs = _pairs(ids)
    wh_mac = n * hdim * feat if with_wh else 0
    bf16_able = members * (pairs * (96 + 2048) + n * 64 * feat + wh_mac)
    tc_mac = bf16_able if op_bytes == 2 else 0
    f32_mac = members * pairs * 64 + bf16_able - tc_mac
    old_f32_mac = (members * pairs * (64 * feat + 2 * feat) + bf16_able
                   - tc_mac)
    own = op_bytes * (n_mlp + (hdim * feat + feat if with_wh else n * feat))
    nbytes = (4 * (4 * n + n)
              + members * (4 * (n * hdim + 65 * n) + op_bytes * n * hdim
                           + own))
    out = _bound(2 * f32_mac, nbytes, 2 * tc_mac)
    out.update(pairs_needed=pairs, pairs_id_tested=n * n,
               old_bound_ms=_bound(2 * old_f32_mac, nbytes,
                                   2 * tc_mac)["bound_ms"])
    return out


def attention_bwd_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                        n_mlp: int, kernel: str, op_bytes: int = 4,
                        members: int = 1) -> dict:
    """Least time of a backward kernel on this input.  Per same-scene pair
    both recompute the score (features, 3->32 and 32->64 layers, and
    a2 . u_j with the forward's u_j = W3 wh_j: 96 + 2048 + 64 MAC), take
    g_i . h_j (H) and pull ds back to the features (the z2 cotangent 64,
    64->32: 2048).  dq adds the 32->3 feature cotangent (96); dkv adds
    dh_j (H), the dW2 outer product (2048), db2/A_j (128) and dW1/db1
    (128), and per column dwh_j (N 64 F) and dW3, db3 (N 64 F + N F).
    Neither computes u or c: both read the forward's.  Bytes: x4, ids, h,
    wh, g, stats, r, u, c and the MLP weights read once, the outputs
    written once; h, wh and the weights ``op_bytes`` an element.  With
    bf16 operands the recomputed 3->32 and 32->64 layers (2144 MAC a
    pair, bf16 x bf16) are costed at the bf16 tensor-core peak; every
    product with a float32 cotangent or u at the FP32 peak.  ``members``
    as in ``attention_bound``: x4 and ids once, the rest M times."""
    pairs = _pairs(ids)
    layers = 96 + 2048
    tc_mac = members * pairs * layers if op_bytes == 2 else 0
    common = (0 if tc_mac else layers) + 64 + hdim + 64 + 2048
    in_bytes = 4 * (4 * n + n) + members * (
        4 * (n * hdim + 3 * n + 65 * n)
        + op_bytes * (n * hdim + n * feat + n_mlp))
    if kernel == "dq":
        mac = members * pairs * (common + 96)
        out_bytes = members * 4 * 4 * n
    else:
        mac = members * (pairs * (common + hdim + 2048 + 128 + 128)
                         + 2 * n * 64 * feat + n * feat)
        out_bytes = members * 4 * (n * hdim + n * feat + n_mlp)
    out = _bound(2 * mac, in_bytes + out_bytes, 2 * tc_mac)
    out["pairs_needed"] = pairs
    return out


def attention_inputs(rng, n: int, hdim: int, scene=0):
    """Last-frame states in normalized units and tanh-range hidden states.
    Scene ids: ``scene`` > 0 gives equal scenes of that size; 0 gives sorted
    ETH/UCY-like scenes of 2-16 agents with one singleton scene and a padded
    tail (-1) of about 10 %; "shuffled" gives those ids in random order."""
    if isinstance(scene, int) and scene:
        ids = (np.arange(n) // scene).astype(np.int32)
    else:
        ids = np.full(n, -1, np.int32)
        row, sid, n_real = 0, 0, int(n * 0.9)
        while row < n_real:
            s = 1 if sid == 3 else int(rng.randint(2, 17))
            ids[row:row + s] = sid
            row, sid = row + s, sid + 1
        ids[n_real:] = -1
        if scene == "shuffled":
            ids = ids[rng.permutation(n)]
    x4 = np.concatenate([rng.rand(n, 2), rng.randn(n, 2) * 0.02], axis=1)
    h = np.tanh(rng.randn(n, hdim))
    return x4.astype(np.float32), h.astype(np.float32), ids


def by_launch(torch, fn, calls: int = 20) -> dict:
    """Device time per call of each kernel ``fn()`` launches, by kernel
    name, from torch.profiler over ``calls`` calls after a warm-up.  A
    trace with no device events (the profiler has returned one now and
    then) is taken again, up to three times; {} if none has any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type.name == "CUDA":
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("::")[-1]
                out[name] = out.get(name, 0.0) + e.device_time / calls
        if out:
            break
    return out


def check_close(got, want, name: str, kind: str = "value") -> float:
    """Kernel output against its plain version; returns max abs error.
    value: elementwise rtol 2e-4 / atol 2e-5.  weight: sums over every
    pair in another order, max|err| <= 1e-4 max|ref| + 1e-6.  dx: pair
    terms carry 1/dist, 1/|dv|^2 and 1/(dist |v| + 1e-6) factors that grow
    f32 rounding differences, so each row is held at max|err| <= 1e-3
    max|ref row| + 2e-5."""
    got, want = got.detach().float(), want.detach().float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    if kind == "weight":
        bad = float(err.max()) > 1e-4 * float(want.abs().max()) + 1e-6
    elif kind == "dx":
        bad = bool((err.amax(dim=1)
                    > 1e-3 * want.abs().amax(dim=1) + 2e-5).any())
    else:
        bad = bool((err > ATOL + RTOL * want.abs()).any())
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with plain, max abs "
                             f"{float(err.max()):.3e} (max ref "
                             f"{float(want.abs().max()):.3e}, {kind})")
    return float(err.max())


def dx_witness(torch, sa, name, g, x4, h, ids, gout, pairs,
               inputs=None) -> None:
    """Why dx has a per-row bound: the f64 plain version of the same
    function on the same f32 inputs.  Prints, for the kernel and for the
    f32 plain version, the worst row's error against f64 in units of the
    row bound (1e-3 max|ref row| + 2e-5) and the elements outside the
    forward's elementwise rtol 2e-4 / atol 2e-5.  Correct f32 arithmetic
    reaches past the row bound on some draws (the plain version too), so
    the kernel is held relative to the plain version: its worst row within
    2x the plain version's + 0.1 of the bound.  The f64 version rebuilds
    wh, the stats and r from the generator ``g`` in f64, unless
    ``inputs`` (the backward kernels' own x4, ids, h, wh, g, stats, r and
    weights) are given: then it takes exactly those, widened, so that a
    rounding of r or the stats (inputs of dq and dkv) is no kernel's
    error."""
    import copy
    from socialways_torch.ops.nn import linear_apply
    if inputs is not None:
        args = tuple(t if t.dtype == torch.int32 else t.double()
                     for t in inputs[:7]) + ([t.double()
                                              for t in inputs[7]],)
    else:
        fm = copy.deepcopy(g.feat_mlp).double()
        aw = copy.deepcopy(g.attn_w).double()
        x64, h64, g64 = x4.double(), h.double(), gout.double()
        w64 = [t.detach() for layer in fm for t in (layer.w, layer.b)]
        with torch.no_grad():
            wh64 = linear_apply(aw, h64)
            out64, m64, l64 = sa.social_attention_stats_plain(fm, aw, x64,
                                                              h64, ids)
        args = (x64, ids, h64, wh64, g64, torch.stack([m64, l64], 1),
                (g64 * out64).sum(-1), w64)
    refs = {"dq dx_i": sa.social_attention_bwd_dq_plain(*args),
            "dkv dx_j": sa.social_attention_bwd_dkv_plain(*args)[0]}
    parts, over = [], []
    for key, (kern, plain) in pairs.items():
        used, part = dx_rows_used(kern, plain, refs[key])
        parts.append(f"{key} {part}")
        if used["kernel"] > 2.0 * used["plain"] + 0.1:
            over.append(f"{key} kernel {used['kernel']:.2f} against plain "
                        f"f32 {used['plain']:.2f}")
    print(f"dx vs f64 plain{' (same inputs)' if inputs else ''} [{name}]: "
          + "; ".join(parts))
    if over:
        raise AssertionError(f"{name}: dx further from f64 than 2x the f32 "
                             f"plain version + 0.1: {', '.join(over)}")


def dx_same_inputs(torch, sa, tag, inputs, pairs) -> float:
    """dx held as ``dx_witness`` holds it, on the kernels' own inputs:
    ``inputs`` (x4, ids, h, wh, g, stats, r, weights; solo or member-
    stacked, float32 or bf16 operands) widened to f64 give the reference,
    the f64 plain version of the same function (for bf16 operands the
    float function of the bf16 values, whose distance from the bf16
    contract the kernel and its plain version share).  ``pairs``: {name:
    (kernel dx, plain dx)}; each member's kernel within 2x its plain
    version's error + 0.1 of the row bound.  Returns the kernels' max abs
    difference from their plain versions."""
    a64 = tuple(t if t.dtype == torch.int32 else t.double()
                for t in inputs[:7]) + ([t.double() for t in inputs[7]],)
    members = inputs[2].dim() == 3
    refs = {"dq dx_i": (sa.social_attention_bwd_dq_members_plain if members
                        else sa.social_attention_bwd_dq_plain)(*a64),
            "dkv dx_j": (sa.social_attention_bwd_dkv_members_plain
                         if members else sa.social_attention_bwd_dkv_plain)(
                             *a64)[0]}
    worst = 0.0
    for key, (kern, plain) in pairs.items():
        for i in range(kern.shape[0] if members else 1):
            k, p_, ref = ((kern[i], plain[i], refs[key][i]) if members
                          else (kern, plain, refs[key]))
            if not bool(k.isfinite().all()):
                raise AssertionError(f"{tag} {key}: non-finite values")
            used, part = dx_rows_used(k, p_, ref)
            print(f"  {key}{f' member {i}' if members else ''} vs f64 "
                  f"plain (same inputs) [{tag}]: {part}")
            if used["kernel"] > 2.0 * used["plain"] + 0.1:
                raise AssertionError(f"{tag} {key}: dx further from f64 "
                                     f"than 2x the plain version + 0.1: "
                                     f"{part}")
            worst = max(worst, float((k - p_).abs().max()))
    return worst


def dx_rows_used(kern, plain, ref):
    """({"kernel", "plain"}: worst row's error against the f64 ``ref``
    in units of the row bound, 1e-3 max|ref row| + 2e-5), and a printable
    summary with the elements outside rtol 2e-4 / atol 2e-5."""
    used, parts = {}, []
    for who, got in (("kernel", kern), ("plain", plain)):
        err = (got.double() - ref).abs()
        used[who] = float((err.amax(dim=-1)
                           / (1e-3 * ref.abs().amax(dim=-1) + 2e-5)).max())
        n_out = int((err > ATOL + RTOL * ref.abs()).sum())
        parts.append(f"{who} {used[who]:.3f} of the row bound, "
                     f"{n_out}/{err.numel()} outside rtol/atol")
    return used, "; ".join(parts)


def backward_case(torch, sa, name, g, x4, h, ids, seed, dx_rows=True):
    """Phase 4 on one input: the Function and each backward kernel against
    the plain versions, and their times and bounds.  ``dx_rows`` False
    holds dx (the Function's, dq's and dkv's) by ``dx_witness`` on the
    kernels' own inputs alone, not by ``check_close``'s per-row bound."""
    from socialways_torch.ops.nn import linear_apply
    dev = torch.device("cuda")

    def dx_close(a, b, what):
        if dx_rows:
            return check_close(a, b, what, "dx")
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{what}: non-finite values")
        return float((a - b).abs().max())

    x4, h, ids = (torch.from_numpy(a).to(dev) for a in (x4, h, ids))
    gout = torch.from_numpy(np.random.RandomState(seed).randn(
        *h.shape).astype(np.float32)).to(dev)
    weights = [t for layer in g.feat_mlp for t in (layer.w, layer.b)]
    leaves = lambda xx, hh: [xx, hh] + weights + [g.attn_w.w, g.attn_w.b]
    names = ["dx", "dh", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dWw",
             "dbw"]
    # the autograd Function against autograd through the plain forward
    xk, hk = x4.clone().requires_grad_(), h.clone().requires_grad_()
    out = sa.social_attention_fwd(g.feat_mlp, g.attn_w, xk, hk, ids)
    got = torch.autograd.grad((out * gout).sum(), leaves(xk, hk))
    xp, hp = x4.clone().requires_grad_(), h.clone().requires_grad_()
    ref_out = sa.social_attention_plain(g.feat_mlp, g.attn_w, xp, hp, ids)
    want = torch.autograd.grad((ref_out * gout).sum(), leaves(xp, hp))
    torch.cuda.synchronize()
    check_close(out, ref_out, f"{name} out")
    for i, (nm, a, b) in enumerate(zip(names, got, want)):
        if nm == "dx":
            dx_close(a, b, f"{name} autograd dx")
        else:
            check_close(a, b, f"{name} autograd {nm}",
                        "weight" if i >= 2 else "value")

    # each kernel against its plain version on the same inputs
    w = [t.detach() for t in weights]
    with torch.no_grad():
        wh = linear_apply(g.attn_w, h)
        k_out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w,
                                            with_stats=True)
        p_out, m, l = sa.social_attention_stats_plain(g.feat_mlp, g.attn_w,
                                                      x4, h, ids)
    check_close(stats[:, 0], m, f"{name} m")
    check_close(stats[:, 1], l, f"{name} l")
    check_close(u, wh @ w[4].T, f"{name} u")
    check_close(c, wh @ w[5], f"{name} c")
    r = (gout * k_out).sum(-1)
    args = (x4, ids, h, wh, gout, stats, r, w)
    uc = (u, c)
    dq = sa.social_attention_bwd_dq(*args, *uc)
    dq_ref = sa.social_attention_bwd_dq_plain(*args)
    err_q = dx_close(dq, dq_ref, f"{name} dq dx_i")
    if not torch.equal(dq, sa.social_attention_bwd_dq(*args, *uc)):
        raise AssertionError(f"{name} dq: two runs differ in their bits")
    dkv = sa.social_attention_bwd_dkv(*args, *uc, need_dx=False)
    dkv_ref = sa.social_attention_bwd_dkv_plain(*args, need_dx=False)
    kv_names = ["dh_j", "dwh_j", "dw1", "db1", "dw2", "db2", "dw3", "db3"]
    err_kv = max(check_close(a, b, f"{name} dkv {nm}",
                             "weight" if i >= 2 else "value")
                 for i, (nm, a, b) in enumerate(zip(kv_names, dkv[1:],
                                                    dkv_ref[1:])))
    dkv_x = sa.social_attention_bwd_dkv(*args, *uc)
    dkv_x_ref = sa.social_attention_bwd_dkv_plain(*args)
    err_kv = max(err_kv, dx_close(dkv_x[0], dkv_x_ref[0],
                                  f"{name} dkv dx_j"))
    for a, b in zip(dkv[1:], dkv_x[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} dkv: two runs differ in their bits")
    dx_witness(torch, sa, name, g, x4, h, ids, gout,
               {"dq dx_i": (dq, dq_ref), "dkv dx_j": (dkv_x[0], dkv_x_ref[0])},
               inputs=None if dx_rows else args)

    with torch.no_grad():
        fwd_ms = median_ms(torch, lambda: sa._launch_fwd(
            x4, ids, h, wh, w, with_stats=False))
        stats_ms = median_ms(torch, lambda: sa._launch_fwd(
            x4, ids, h, wh, w, with_stats=True))
        stats_plain_ms = median_ms(
            torch, lambda: sa.social_attention_stats_plain(
                g.feat_mlp, g.attn_w, x4, h, ids))
        fwd_split = by_launch(torch, lambda: sa._launch_fwd(
            x4, ids, h, wh, w, with_stats=True))
    t = {"dq": (median_ms(torch,
                          lambda: sa.social_attention_bwd_dq(*args, *uc)),
                median_ms(torch,
                          lambda: sa.social_attention_bwd_dq_plain(*args))),
         "dkv": (median_ms(torch, lambda: sa.social_attention_bwd_dkv(
                     *args, *uc, need_dx=False)),
                 median_ms(torch, lambda: sa.social_attention_bwd_dkv_plain(
                     *args, need_dx=False)))}
    dkv_split = by_launch(torch, lambda: sa.social_attention_bwd_dkv(
        *args, *uc, need_dx=False))
    dq_split = by_launch(torch, lambda: sa.social_attention_bwd_dq(*args, *uc))
    n, hdim = h.shape
    feat = wh.shape[1]
    n_mlp = sum(t_.numel() for t_ in w)
    ids_np = ids.cpu().numpy()
    bounds = {k: attention_bwd_bound(ids_np, n, hdim, feat, n_mlp, k)
              for k in ("dq", "dkv")}
    bounds["fwd"] = attention_bound(ids_np, n, hdim, feat, n_mlp)
    print(f"backward [{name}]: Function vs autograd of plain ok; m, l, u, c "
          f"ok; dq max abs {err_q:.3e}, dkv max abs {err_kv:.3e}, dq and dkv "
          f"equal bits on two runs | forward alone {fwd_ms * 1e3:.2f} us, with "
          f"stats {stats_ms * 1e3:.2f} us (plain {stats_plain_ms * 1e3:.2f} "
          f"us, bound {bounds['fwd']['bound_ms'] * 1e3:.3f}) | dq "
          f"{t['dq'][0] * 1e3:.2f} us (plain {t['dq'][1] * 1e3:.2f}, bound "
          f"{bounds['dq']['bound_ms'] * 1e3:.3f} {bounds['dq']['bound_by']}, "
          f"{t['dq'][0] / bounds['dq']['bound_ms']:.0f}x)"
          f" | dkv {t['dkv'][0] * 1e3:.2f} us (plain "
          f"{t['dkv'][1] * 1e3:.2f}, bound "
          f"{bounds['dkv']['bound_ms'] * 1e3:.3f} "
          f"{bounds['dkv']['bound_by']}) | "
          f"{bounds['dq']['pairs_needed']} same-scene pairs")
    fmt = lambda split: ", ".join(f"{k} {v:.2f} us" for k, v in split.items())
    print(f"  by launch [{name}]: forward with stats: {fmt(fwd_split)}; "
          f"dq: {fmt(dq_split)}; dkv: {fmt(dkv_split)}")
    return {"err": {"dq": err_q, "dkv": err_kv}, "ms": t, "bounds": bounds,
            "stats_ms": stats_ms, "stats_plain_ms": stats_plain_ms,
            "fwd_ms": fwd_ms,
            "split": {"fwd": fwd_split, "dq": dq_split, "dkv": dkv_split}}


#: the kernels of csrc/, each compiled for float and for bf16 operands, and
#: their ptxas registers in the float-only build that preceded the bf16
#: entries and the member axis (the float ones held to +-2 of these)
PTXAS_KERNELS = {"u_prep_kernel": 74, "social_attention_fwd_kernel": 50,
                 "bwd_dq_kernel": 79, "bwd_dkv_kernel": 96,
                 "bwd_finalize_kernel": 30}


def ptxas_entries(log: str, wide: bool = False) -> dict:
    """{"kernel[float|bf16]": (registers, spill store bytes, spill load
    bytes)} from nvcc's ``-Xptxas -v`` output; the mangled template names
    shortened to the kernel and its operand type (``wide``: a wide
    library's, "kernel[float|bf16,wide]")."""
    out, entry, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in PTXAS_KERNELS if k in m.group(1)), None)
            if name is None:
                raise AssertionError(f"ptxas: unknown entry {m.group(1)}")
            typ = ("bf16" if f"{name}I13__nv_bfloat16" in m.group(1)
                   else "float")
            entry = f"{name}[{typ}{',wide' if wide else ''}]"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), *spills)
            entry, spills = None, (0, 0)
    return out


def build_kernels(_build) -> None:
    """Phase 2: build every kernel (one nvcc a source, in parallel), print
    ptxas's lines, and fail if a kernel spills or a narrow float32
    kernel's registers move more than 2 from ``PTXAS_KERNELS`` (the wide
    kernels, H or F above 128, have no earlier build to hold them to)."""
    tic = time.perf_counter()
    _build.build(KERNELS)
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - tic:.2f} s"
          f" (parallel nvcc)")
    for name in KERNELS:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  ptxas {name}: {line.strip()[:150]}")
    ptxas = {}
    for name in KERNELS:
        ptxas.update(ptxas_entries(_build.build_logs.get(name, ""),
                                   wide="_wide" in name))
    if len(ptxas) != 4 * len(PTXAS_KERNELS) or any(
            sum(v[1:]) for v in ptxas.values()):
        raise AssertionError(f"ptxas: want every kernel for float and bf16, "
                             f"narrow and wide, without spills, got {ptxas}")
    for entry, (regs, st, ld) in sorted(ptxas.items()):
        was = PTXAS_KERNELS[entry.split("[")[0]]
        print(f"ptxas: {entry} {regs} registers, spill stores/loads {st}/"
              f"{ld} bytes" + (f" (float-only build: {was})"
                               if entry.endswith("[float]") else ""))
        if entry.endswith("[float]") and abs(regs - was) > 2:
            raise AssertionError(f"ptxas: {entry} takes {regs} registers, "
                                 f"the float-only build {was} (bound +-2)")


def profile_step(torch, what: str, fn) -> None:
    """Device kernels/copies and device time of one ``fn()`` under
    torch.profiler, against the median untraced wall of 5 calls (the
    profiler inflates the wall it traces); the top device ops by time.
    Returns the device ops, device time, wall and idle share."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tic) * 1e6)
    wall_us = float(np.median(walls[1:]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time for e in dev_events)
    print(f"profile of {what}: {len(dev_events)} device kernels/copies, "
          f"{busy_us:.1f} us device time; untraced wall {wall_us:.1f} us "
          f"(median of 5) -> device idle {1 - busy_us / wall_us:.1%}")
    out = {"ops": len(dev_events), "device_us": busy_us, "wall_us": wall_us,
           "idle": 1 - busy_us / wall_us}
    by_name = {}
    for e in dev_events:
        n_t = by_name.setdefault(e.name, [0, 0.0])
        n_t[0] += 1
        n_t[1] += e.device_time
    for nm, (cnt, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us:9.1f} us {cnt:4d}x {nm[:90]}")
    return out


def reset_launches(sa) -> None:
    """Every kernel's count to 0, the float32 and the bf16 entries'."""
    for fn in (sa.social_attention_fwd, sa.social_attention_bwd_dq,
               sa.social_attention_bwd_dkv):
        fn.launches = fn.launches_bf16 = 0


def read_launches(sa, bf16: bool = False) -> dict:
    """The float32 kernels' counts, or the bf16 kernels' when ``bf16``."""
    attr = "launches_bf16" if bf16 else "launches"
    return {"fwd": getattr(sa.social_attention_fwd, attr),
            "dq": getattr(sa.social_attention_bwd_dq, attr),
            "dkv": getattr(sa.social_attention_bwd_dkv, attr)}


def bf16_launches(sa, what: str) -> dict:
    """The bf16 kernels' counts after a bf16 run, which must have launched
    no float32 kernel (no fallback)."""
    f32 = read_launches(sa)
    if any(f32.values()):
        raise AssertionError(f"{what}: a bf16 run launched float32 kernels "
                             f"{f32}")
    return read_launches(sa, bf16=True)


def first_step_cuda_vs_cpu(torch, trainer, state, dev, what: str) -> None:
    """One ``gan_step`` of ``trainer``'s first training chunk on the card
    and on the CPU, from copies of ``state`` under the same draws: losses
    and ADE/FDE sums within rel 1e-4, gradients (Adam's first moments)
    within 1e-3 of their scale, new parameters within 1e-2 lr plus, for G,
    what that gradient bound allows Adam's first update (``state`` is a
    fresh one).  Under ``compute_dtype="bfloat16"`` the two devices round
    to bf16 after sums taken in other orders, and a flipped rounding
    travels through the rollout: losses and sums within rel 1e-2,
    gradients within 5e-2 of their scale, every state tensor float32 on
    both; the new parameters are not compared (where |g| is under that
    noise, the sign of Adam's first update, +-lr, may differ)."""
    from socialways_torch.engine.train_step import (StepDraws, draw_step,
                                                    gan_step)
    from socialways_torch.engine.trainer import chunk_of
    from socialways_torch.io.checkpoint import flatten_state, state_from_flat

    tcfg, packed = trainer.cfg, trainer.train_packed
    s_dev = state_from_flat(flatten_state(state), tcfg, dev)
    s_cpu = state_from_flat(flatten_state(state), tcfg, "cpu")
    draws = draw_step(packed.width, tcfg, torch.Generator().manual_seed(7))
    draws_dev = StepDraws(*(None if t is None else t.to(dev) for t in draws))
    c_cpu = {k: torch.from_numpy(getattr(packed, k)[0])
             for k in ("obsvs", "preds", "scene_ids", "valid")}
    nv0 = int(packed.n_valid[0])
    s_dev, m_dev = gan_step(s_dev, chunk_of(trainer.train_dev, 0), draws_dev,
                            tcfg, nv0)
    s_cpu, m_cpu = gan_step(s_cpu, c_cpu, draws, tcfg, nv0)
    bf16 = tcfg.compute_dtype == "bfloat16"
    rel, g_rel = (1e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    for nm in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
        a, b = float(getattr(m_dev, nm)), float(getattr(m_cpu, nm))
        if not np.isfinite(a) or abs(a - b) > rel * abs(b):
            raise AssertionError(f"{what} {nm}: cuda {a} vs cpu {b}")
    # gradients: Adam's first moment after one G update is 0.1 g_G, after
    # the D updates a weighted sum of D's gradients -- compared leaf by leaf
    # at max|err| <= 1e-3 max|ref| + 1e-9 (sums over the rows through the
    # rollout and the attention, in another order)
    f_dev, f_cpu = flatten_state(s_dev), flatten_state(s_cpu)
    if sorted(f_dev) != sorted(f_cpu):
        raise AssertionError(f"{what}: the two states' leaves differ")
    not_f32 = [k for f in (f_dev, f_cpu) for k, v in f.items()
               if not k.endswith(".count") and v.dtype != np.float32]
    if not_f32:
        raise AssertionError(f"{what}: state leaves not float32: {not_f32}")
    worst_g, worst_p, loose = (0.0, ""), {"G": 0.0, "D": 0.0}, [0, 0]
    for key, ref in f_cpu.items():
        got = f_dev[key]
        if key.endswith(".count"):
            if int(got) != int(ref):
                raise AssertionError(f"{what} {key}: {got} vs {ref}")
        elif "/.mu/" in key:
            err = float(np.abs(got - ref).max())
            scale = float(np.abs(ref).max())
            if err > g_rel * scale + 1e-9:
                raise AssertionError(f"{what} gradient {key}: max abs "
                                     f"{err:.3e} vs max ref {scale:.3e}")
            worst_g = max(worst_g, (err / (g_rel * scale + 1e-9), key))
        elif bf16:
            continue
        elif key.startswith(".d_params/"):
            worst_p["D"] = max(worst_p["D"], float(np.abs(got - ref).max()))
        elif key.startswith(".g_params/"):
            # G's first Adam update is lr g / (|g| + eps): an element whose
            # |g| nears the gradient bound d moves by up to
            # lr eps d / (|g| - d + eps)^2 (at most 2 lr) across devices
            (mu_key,) = [k for k in f_cpu if k.startswith(".g_opt/")
                         and k.endswith("/.mu/" + key[len(".g_params/"):])]
            mu = f_cpu[mu_key].astype(np.float64)
            b1, eps, lr = tcfg.adam_b1, 1e-8, tcfg.lr_g
            g = np.abs(mu) / (1.0 - b1)
            d = (1e-3 * np.abs(mu).max() + 1e-9) / (1.0 - b1)
            bound = lr * (1e-2 + np.minimum(
                2.0, eps * d / (np.maximum(g - d, 0.0) + eps) ** 2))
            ratio = np.abs(got - ref) / bound
            if ratio.max() > 1.0:
                i = int(np.argmax(ratio))
                raise AssertionError(
                    f"{what}: new G param {key} differs by "
                    f"{np.abs(got - ref).flat[i]:.3e} at |g| {g.flat[i]:.3e}"
                    f" > its bound {bound.flat[i]:.3e}")
            worst_p["G"] = max(worst_p["G"], float(ratio.max()))
            loose[0] += int((bound > 1.01e-2 * lr).sum())
            loose[1] += bound.size
    # both devices start from one state, so the new D parameters differ by
    # the difference of their updates, each about +-lr: held at 1e-2 lr
    if worst_p["D"] > 1e-2 * tcfg.lr_d:
        raise AssertionError(f"{what}: new D params differ by "
                             f"{worst_p['D']:.3e} > 1e-2 lr ({tcfg.lr_d:g})")
    if bf16:
        print(f"{what} cuda vs cpu (bf16): losses and ADE/FDE sums within "
              f"rel {rel:g} (d_loss {float(m_dev.d_loss):.6f}/"
              f"{float(m_cpu.d_loss):.6f}, g_loss {float(m_dev.g_loss):.6f}/"
              f"{float(m_cpu.g_loss):.6f}, ade_sum {float(m_dev.ade_sum):.4f}"
              f"/{float(m_cpu.ade_sum):.4f}); gradients (Adam first "
              f"moments) at most {worst_g[0]:.3f} of their bound {g_rel:g} "
              f"max|ref| (at {worst_g[1]}); every state tensor float32 on "
              f"both devices; counts equal")
        return
    print(f"{what} cuda vs cpu: losses and ADE/FDE sums within rel 1e-4 "
          f"(d_loss {float(m_dev.d_loss):.6f}/{float(m_cpu.d_loss):.6f}, "
          f"g_loss {float(m_dev.g_loss):.6f}/{float(m_cpu.g_loss):.6f}); "
          f"gradients (Adam first moments) at most {worst_g[0]:.3f} of "
          f"their bound 1e-3 max|ref| + 1e-9 (at {worst_g[1]}); new "
          f"params: G at most {worst_p['G']:.3f} of its bound (1e-2 lr = "
          f"{1e-2 * tcfg.lr_g:g}, up to 2 lr on the {loose[0]} of "
          f"{loose[1]} elements whose |g| is within 100 sqrt(eps d) of "
          f"the gradient bound d), D max abs diff "
          f"{worst_p['D']:.3e} (bound {1e-2 * tcfg.lr_d:g}); counts equal")


def training_phase(torch, sa, dev, npz, cfg):
    """Phase 6: the training slice at full loo width on the card."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.rescue import reinit_discriminator
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import Trainer, chunk_of

    ds = load_npz_dataset(npz)
    trainer = Trainer(cfg, ds, dev)
    tcfg = trainer.cfg
    state = trainer.init_state(seed=1)
    width, n_steps = trainer.train_packed.width, trainer.n_steps_per_epoch
    packed = trainer.train_packed
    nv0 = int(packed.n_valid[0])

    first_step_cuda_vs_cpu(torch, trainer, state, dev, "train step")

    # one epoch: the kernels' launch counts on the main path
    rng = torch.Generator(device=dev).manual_seed(3)
    reset_launches(sa)
    state, m1 = trainer.train_epoch(state, rng)
    launches = read_launches(sa)
    if launches["fwd"] < n_steps or launches["dkv"] < n_steps:
        raise AssertionError(f"epoch of {n_steps} steps launched {launches}")
    if launches["dq"] != 0:
        raise AssertionError(f"dq launched {launches['dq']} times on the "
                             f"training path, where x4 is data")
    state, m2 = trainer.train_epoch(state, rng)
    for m in (m1, m2):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite epoch metrics {m}")
    print(f"train epoch 1: {n_steps} steps, launches fwd {launches['fwd']} "
          f"dkv {launches['dkv']} dq {launches['dq']}; "
          f"{n_steps / m1['epoch_time_s']:.2f} steps/s (first epoch), "
          f"epoch 2: {n_steps / m2['epoch_time_s']:.2f} train steps/s "
          f"({m2['epoch_time_s']:.3f} s); train ADE/FDE "
          f"{m2['train_ade']:.4f}/{m2['train_fde']:.4f} m, d_loss "
          f"{m2['d_loss']:.4f}, g_loss {m2['g_loss']:.4f}")

    # one profiled step, and the untraced wall of a step
    c1 = chunk_of(trainer.train_dev, 1)
    nv1 = int(packed.n_valid[1])
    profile_step(torch, "one train step", lambda: gan_step(
        state, c1, draw_step(width, tcfg, rng, dev), tcfg, nv1))

    # the stall rescue's fresh discriminator, then one more step
    state = reinit_discriminator(state, tcfg,
                                 torch.Generator().manual_seed(11))
    state, m = gan_step(state, chunk_of(trainer.train_dev, 0),
                        draw_step(width, tcfg, rng, dev), tcfg, nv0)
    vals = [float(v) for v in m]
    if not all(np.isfinite(vals)):
        raise AssertionError(f"step after reinit_discriminator: {vals}")
    print(f"reinit_discriminator + 1 step: d_loss {vals[0]:.4f} g_loss "
          f"{vals[1]:.4f} (finite)")
    return launches, n_steps / m2["epoch_time_s"]


def cli_phase(torch, cli_main, npz, work):
    """Phase 7: cli train --recipe loo, a resumed epoch, evaluate.  Returns
    the final checkpoint."""
    mdir = os.path.join(work, "models")
    base = ["train", "--recipe", "loo", "--data", npz, "--test-interval",
            "1", "--save-interval", "1", "--model-dir", mdir]
    outs = []
    for epochs in ("2", "3"):
        buf = io.StringIO()
        tic = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(base + ["--epochs", epochs])
        outs.append(buf.getvalue())
        print(f"cli train --recipe loo --epochs {epochs}: rc {rc}, "
              f"{time.perf_counter() - tic:.2f} s wall")
        for line in outs[-1].splitlines():
            print(f"  | {line}")
        if rc != 0:
            raise AssertionError(f"cli train returned {rc}")
    final = os.path.join(mdir, "socialWays-hotel.npz")
    best = os.path.join(mdir, "socialWays-hotel-best.npz")
    if not (os.path.isfile(final) and os.path.isfile(best)):
        raise AssertionError(f"cli train wrote {os.listdir(mdir)}")
    if f"resumed from {final} at epoch 2" not in outs[1]:
        raise AssertionError("the third epoch did not resume")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["evaluate", "--data", npz, "--model-file", final])
    print(f"cli evaluate of the final checkpoint: rc {rc}: "
          f"{buf.getvalue().strip()}")
    if rc != 0:
        raise AssertionError(f"cli evaluate returned {rc}")
    return final


#: the public layouts of the ETH/UCY obsmat files; zara01 space-separated
#: (the BIWI 'zara' rule asks for tabs), zara02 tab-separated
SCENE_LAYOUT = {
    "eth": ("ewap_dataset/seq_eth/obsmat.txt", " "),
    "hotel": ("ewap_dataset/seq_hotel/obsmat.txt", " "),
    "univ": ("crowds/students003/obsmat.txt", " "),
    "zara1": ("crowds/zara01/obsmat.txt", " "),
    "zara2": ("obsmat_zara2.txt", "\t"),
}


def write_obsmat_scenes(root: str, n_agents: int = 110, seed: int = 0
                        ) -> dict:
    """Five synthetic ETH/UCY scenes as obsmat files (rows ``ts id px pz py
    vx vz vy``, frame interval 10, 0.4 s a step) in SCENE_LAYOUT, plus an
    obsmat under the 'ethucy' umbrella directory and a decoy that fails
    validation, neither of which is a scene.  Per scene: ``n_agents``
    pedestrians entering every other frame or so, walking 0.8-1.6 m/s for
    22-30 steps with slight turns in a 15 m square.  Returns {scene: path}."""
    paths = {}
    files = dict(SCENE_LAYOUT, umbrella=("ethucy/obsmat.txt", " "))
    for i, (name, (rel, sep)) in enumerate(files.items()):
        rng = np.random.RandomState(seed + i)
        rows, t0 = [], 0
        for aid in range(1, n_agents + 1):
            t0 += int(rng.poisson(1.2))
            n = int(rng.randint(22, 31))
            heading = rng.uniform(0, 2 * np.pi) + np.cumsum(
                rng.normal(0, 0.05, n))
            vel = rng.uniform(0.8, 1.6) * np.stack(
                [np.cos(heading), np.sin(heading)], axis=1)
            pos = rng.uniform(0, 15, 2) + np.cumsum(vel * 0.4, axis=0)
            rows += [((t0 + k) * 10, aid, pos[k, 0], 0.0, pos[k, 1],
                      vel[k, 0], 0.0, vel[k, 1]) for k in range(n)]
        rows.sort(key=lambda r: (r[0], r[1]))
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.writelines(sep.join(f"{v:.6f}" for v in r) + "\n"
                          for r in rows)
        paths[name] = path
    with open(os.path.join(root, "notes_obsmat.txt"), "w") as fh:
        fh.write("1 2 3\n4 5 6\n")
    del paths["umbrella"]
    return paths


def realdata_phase(torch, sa, cli_main, dev, ckpt, work):
    """Phase 8: the real-data pipeline on the card at the loo width: cli
    eth-ucy on five discovered obsmat scenes (3 epochs, an eval each),
    cli predict on a raw obsmat file, cli evaluate --linear kalman and
    predict_kalman on the card against the CPU."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset
    from socialways_torch.data.forecast import forecast_windows
    from socialways_torch.data.parsers import BIWIParser
    from socialways_torch.engine.ethucy import merge_scenes
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.ops.kalman import predict_kalman

    tic_phase = time.perf_counter()
    data = os.path.join(work, "ethucy_raw")
    obsmat = write_obsmat_scenes(data)
    epochs = 3
    out_json = os.path.join(work, "loo.json")
    reset_launches(sa)
    buf, tic = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["eth-ucy", "--data-dir", data, "--epochs",
                       str(epochs), "--eval-every", "1", "--out-json",
                       out_json])
    torch.cuda.synchronize()
    loo_s = time.perf_counter() - tic
    launches = read_launches(sa)
    for line in buf.getvalue().splitlines():
        print(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"cli eth-ucy returned {rc}")
    with open(out_json) as fh:
        res = json.load(fh)
    found = {s: m["obsmat"] for s, m in res["scenes"].items()}
    if found != obsmat:
        raise AssertionError(f"eth-ucy discovered {found}, not {obsmat}")

    # the steps and eval chunks the run had to launch the kernels for
    scenes = list(obsmat)
    files = {s: os.path.join(data, f"{s}-8-12.npz") for s in scenes}
    steps = evals = 0
    folds = {}
    for held in scenes:
        r = res["folds"][held]
        for key in ("ade_min", "best_ade_min", "train_time_s"):
            if not np.isfinite(r[key]):
                raise AssertionError(f"fold {held}: {key} = {r[key]}")
        ds = merge_scenes([files[s] for s in scenes if s != held],
                          files[held])
        n_steps = len(greedy_chunks(ds.train_batches, BATCH))
        n_eval = len(greedy_chunks(ds.test_batches, BATCH))
        steps += n_steps * epochs
        evals += n_eval * epochs
        folds[held] = (n_steps, ds.n_train_samples, r)
        print(f"eth-ucy fold {held}: {ds.n_train_samples} training windows "
              f"in {n_steps} chunks, {epochs} epochs in "
              f"{r['train_time_s']:.3f} s train ({r['total_wall_s']:.3f} s "
              f"fold wall) = {n_steps * epochs / r['train_time_s']:.2f} "
              f"train steps/s; min-ADE/FDE {r['ade_min']:.3f}/"
              f"{r['fde_min']:.3f} m, best {r['best_ade_min']:.3f}")
    # one forward a step and an eval chunk (the final eval reuses the last
    # in-loop one), the key-side backward a step
    if launches["fwd"] != steps + evals or launches["dkv"] != steps \
            or launches["dq"] != 0:
        raise AssertionError(f"eth-ucy launched {launches} for {steps} "
                             f"train steps and {evals} eval chunks")
    rate = steps / sum(f[2]["train_time_s"] for f in folds.values())
    per_epoch = np.mean([f[0] for f in folds.values()])
    print(f"eth-ucy: 5 scenes discovered (decoy and umbrella left out), "
          f"{steps} train steps + {evals} eval chunks, launches fwd "
          f"{launches['fwd']} dkv {launches['dkv']} dq {launches['dq']}; "
          f"{loo_s:.2f} s wall (CLI, incl. discovery and npz build); "
          f"{rate:.2f} train steps/s over the folds -> a 30k-epoch fold "
          f"({per_epoch:.1f} steps an epoch) projects to "
          f"{30000 * per_epoch / rate / 3600:.2f} h")

    # raw-file serving: everyone in the zara1 scene at its busiest frame
    raw = obsmat["zara1"]
    p = BIWIParser().load(raw)

    def n_ready(t):
        try:
            return len(forecast_windows(p.p_data, p.t_data, N_PAST, 10,
                                        t)[1])
        except ValueError:
            return 0
    busiest = int(max(np.unique(np.concatenate(p.t_data)), key=n_ready))
    want_idx = forecast_windows(p.p_data, p.t_data, N_PAST, 10, busiest)[1]
    out = os.path.join(work, "raw_predictions.npz")
    sa.social_attention_fwd.launches = 0
    buf, tic = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["predict", "--data", raw, "--model-file", ckpt,
                       "--at-time", str(busiest), "--out", out])
    raw_s = time.perf_counter() - tic
    raw_launches = sa.social_attention_fwd.launches
    if rc != 0:
        raise AssertionError(f"cli predict on {raw} returned {rc}")
    with np.load(out) as d:
        n = len(want_idx)
        if (d["preds_our"].shape != (K, n, N_NEXT, 2)
                or d["obsvs"].shape != (n, N_PAST, 2)
                or not np.isfinite(d["preds_our"]).all()
                or not np.array_equal(d["agent_idx"], want_idx)
                or int(d["timestamp"]) != busiest or raw_launches != 1):
            raise AssertionError(
                f"raw predict: preds_our {d['preds_our'].shape}, agent_idx "
                f"{d['agent_idx']} (want {want_idx}), timestamp "
                f"{d['timestamp']} (want {busiest}), {raw_launches} "
                f"launches")
    print(f"predict on raw {os.path.relpath(raw, data)}: {n} agents at "
          f"t={busiest}, preds_our {(K, n, N_NEXT, 2)}, {raw_launches} "
          f"forward launch, {raw_s:.3f} s wall (CLI, incl. parse and load)")

    # the Kalman baseline: the CLI on the card, and the card against the CPU
    npz = files["eth"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["evaluate", "--data", npz, "--linear", "kalman"])
    if rc != 0:
        raise AssertionError(f"cli evaluate --linear kalman returned {rc}")
    print(f"cli evaluate --linear kalman: {buf.getvalue().strip()}")
    tr = Trainer(TrainConfig(), load_npz_dataset(npz), dev)
    obsv = chunk_of(tr.test_dev, 0)["obsvs"]
    k_dev = predict_kalman(obsv, N_NEXT)
    k_cpu = predict_kalman(obsv.cpu(), N_NEXT)
    diff = float((k_dev.cpu() - k_cpu).abs().max())
    if not bool(k_dev.isfinite().all()) or diff > 1e-5:
        raise AssertionError(f"predict_kalman cuda vs cpu: max abs {diff}")
    print(f"predict_kalman cuda vs cpu on test chunk 0 ({obsv.shape[0]} "
          f"rows): max abs {diff:.3e} (atol 1e-5, normalized units)")
    print(f"real-data phase: {time.perf_counter() - tic_phase:.2f} s wall")
    return launches, raw_launches


#: phase 9's toy set: the JAX toy protocol's "big" set
#: (benchmarks/coverage_robustness.py:330-334): scenes of 8 agents, 2
#: observed and 2 predicted steps
TOY_SET = ["--n_conditions", "8", "--n_samples", "768", "--n_per_batch", "8"]
#: the toy-flagship model, as sweep takes it (sweep has no --recipe: the
#: bundle's --auto-recover is train's)
TOY_MODEL = ["--agent-frame", "--use-social", "--g-ema-decay", "0.999",
             "--latent-code", "categorical", "--n-latent-codes", "3",
             "--d-lr", "5e-4", "--d-lr-decay-rate", "0.7",
             "--d-lr-decay-steps", "10000", "--d-input-noise", "0.05",
             "--d-input-noise-steps", "-1"]
TOY_EPOCHS, TOY_TEST_INTERVAL, SWEEP_EPOCHS = 12, 2, 4


def run_cli(cli_main, argv, tag: str, card: str = "") -> str:
    """One CLI command with its stdout captured and echoed; fails on a
    non-zero return.  ``card`` (name, power limit) tags the wall time."""
    buf, tic = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue()
    print(f"cli {tag}: rc {rc}, {time.perf_counter() - tic:.2f} s wall"
          + (f" [{card}]" if card else ""))
    for line in out.splitlines():
        print(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"cli {tag} returned {rc}")
    return out


def check_launches(what: str, launches: dict, steps: int, rollouts: int,
                   fwd_per_step: int = 1, dkv_per_step: int = 1) -> None:
    """``fwd_per_step`` forwards a train step and one a rollout,
    ``dkv_per_step`` dkv a step, no dq."""
    fwd, dkv = fwd_per_step * steps + rollouts, dkv_per_step * steps
    if (launches["fwd"] != fwd or launches["dkv"] != dkv
            or launches["dq"] != 0):
        raise AssertionError(f"{what} launched {launches} for {steps} train "
                             f"steps x ({fwd_per_step} fwd, {dkv_per_step} "
                             f"dkv) and {rollouts} rollouts")
    print(f"{what} launches: fwd {launches['fwd']} = {fwd_per_step} x "
          f"{steps} train steps + {rollouts} rollouts, dkv "
          f"{launches['dkv']} = {dkv_per_step} x {steps}, dq "
          f"{launches['dq']}")


def toy_phase(torch, sa, cli_main, dev, work):
    """Phase 9: the toy protocol at its full width (hidden 64, batch 256,
    K 20) on the JAX protocol's big toy set: cli train --recipe
    toy-flagship with dumps, metrics log, profiler trace, coverage and the
    rescues; cli stats over the dumps; cli sweep; one unroll-5 categorical
    step with a decayed D lr on the card against the CPU."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import Trainer, chunk_of

    tic_phase = time.perf_counter()
    toy = os.path.join(work, "toy.npz")
    run_cli(cli_main, ["create-toy", "--npz", toy] + TOY_SET, "create-toy")
    ds = load_npz_dataset(toy)
    steps_epoch = len(greedy_chunks(ds.train_batches, BATCH))
    eval_chunks = len(greedy_chunks(ds.test_batches, BATCH))
    n_evals = TOY_EPOCHS // TOY_TEST_INTERVAL

    # ---- cli train --recipe toy-flagship with every output of the loop
    mdir, dump, log, prof = (os.path.join(work, "toy_" + n)
                             for n in ("models", "dumps", "log", "prof"))
    reset_launches(sa)
    out = run_cli(cli_main, [
        "train", "--recipe", "toy-flagship", "--data", toy, "--epochs",
        str(TOY_EPOCHS), "--test-interval", str(TOY_TEST_INTERVAL),
        "--model-dir", mdir, "--dump-dir", dump, "--lnr-model", "kalman",
        "--metrics-log", log, "--profile-dir", prof, "--track-coverage",
        "--stall-recover", "2", "--stall-reset-d", "--rescue-keep-clock"],
        "train --recipe toy-flagship")
    torch.cuda.synchronize()
    launches_train = read_launches(sa)
    steps = TOY_EPOCHS * steps_epoch
    # an eval, a coverage rollout and a dump rollout every test interval
    check_launches("toy train", launches_train, steps,
                   n_evals * (eval_chunks + 2))
    eval_epochs = list(range(TOY_TEST_INTERVAL, TOY_EPOCHS + 1,
                             TOY_TEST_INTERVAL))
    root = os.path.join(dump, "hotel", "socialWays")
    if sorted(os.listdir(root), key=int) != [str(e) for e in eval_epochs]:
        raise AssertionError(f"dump epochs {os.listdir(root)}")
    for e in eval_epochs:
        files = os.listdir(os.path.join(root, str(e)))
        if len(files) != 1:
            raise AssertionError(f"epoch {e} dumps: {files}")
        with np.load(os.path.join(root, str(e), files[0])) as d:
            n = d["obsvs"].shape[0]
            want = {"timestamp": (), "obsvs": (n, 2, 2),
                    "preds_our": (K, n, 2, 2), "preds_gtt": (n, 2, 2),
                    "preds_lnr": (n, 2, 2)}
            got = {k: d[k].shape for k in d.files}
            if got != want or not all(np.isfinite(d[k]).all()
                                      for k in d.files):
                raise AssertionError(f"epoch {e} dump {got} (want {want})")
    with open(log) as fh:
        recs = [json.loads(line) for line in fh]
    kinds = [(r["kind"], r["epoch"]) for r in recs
             if r["kind"] in ("train", "eval", "coverage")]
    want_kinds = []
    for e in range(1, TOY_EPOCHS + 1):
        want_kinds.append(("train", e))
        if e in eval_epochs:
            want_kinds += [("eval", e), ("coverage", e)]
    if kinds != want_kinds:
        raise AssertionError(f"metrics log {kinds}")
    for suffix in ("-best", "-bestcov"):
        if not os.path.isfile(os.path.join(mdir,
                                           f"socialWays-hotel{suffix}.npz")):
            raise AssertionError(f"no {suffix} checkpoint: "
                                 f"{os.listdir(mdir)}")
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    for name in ("social_attention_fwd_kernel", "bwd_dkv_kernel"):
        if not any(name in k for k in kernels):
            raise AssertionError(f"profiled epoch has no {name} among "
                                 f"{len(kernels)} kernels")
    covs = [r["coverage"] for r in recs if r["kind"] == "coverage"]
    train = {r["epoch"]: r for r in recs if r["kind"] == "train"}
    timed = [train[e]["epoch_time_s"] for e in range(3, TOY_EPOCHS + 1)]
    toy_rate = steps_epoch * len(timed) / sum(timed)
    print(f"toy train: {steps} steps ({steps_epoch} an epoch), {n_evals} "
          f"evals of {eval_chunks} chunks + coverage + dump; dumps of "
          f"epochs {eval_epochs} in JAX's schema; log kinds ok; -best and "
          f"-bestcov written; profiled epoch 2 names both CUDA kernels "
          f"({len(kernels)} kernel names, {len(events)} events); coverage "
          f"{covs}; rescues: {out.count('STALLED') + out.count('DIVERGED')}")
    print(f"toy train steps/s (epochs 3-{TOY_EPOCHS}, toy-flagship, batch "
          f"{BATCH}): {toy_rate:.2f}")

    # ---- cli stats over the dump tree (host only)
    out = run_cli(cli_main, ["stats", "--preds-dir", root, "--real-npz", toy,
                             "--group", "8"], "stats")
    rows = re.findall(r"epoch = (\d+), EMD = (\S+), 1nn = (\S+)", out)
    if ([int(r[0]) for r in rows] != eval_epochs
            or not all(np.isfinite(float(v)) for r in rows for v in r[1:])
            or not os.path.isfile(os.path.join(root, "stats20.npz"))):
        raise AssertionError(f"stats printed {rows}")

    # ---- cli sweep over unroll x info weight at the toy-flagship model
    out_json = os.path.join(work, "sweep.json")
    unrolls, infos = (0, 1, 5), (0.0, 1.0)
    reset_launches(sa)
    tic = time.perf_counter()
    run_cli(cli_main, ["sweep", "--data", toy, "--unrolls",
                       ",".join(map(str, unrolls)), "--info-weights",
                       ",".join(map(str, infos)), "--sweep-epochs",
                       str(SWEEP_EPOCHS), "--out-json", out_json]
            + TOY_MODEL, "sweep")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - tic
    launches_sweep = read_launches(sa)
    n_var = len(unrolls) * len(infos)
    check_launches("sweep", launches_sweep, n_var * SWEEP_EPOCHS * steps_epoch,
                   n_var * (eval_chunks + 1))
    with open(out_json) as fh:
        res = json.load(fh)
    if list(res) != [f"unroll{u}-info{w}" for u in unrolls for w in infos]:
        raise AssertionError(f"sweep keys {list(res)}")
    for key, r in res.items():
        if (set(r) != {"ade_avg", "fde_avg", "ade_min", "fde_min",
                       "mode_coverage", "final_train_ade"}
                or not all(np.isfinite(v) for v in r.values())
                or not 0.0 <= r["mode_coverage"] <= 1.0):
            raise AssertionError(f"sweep {key}: {r}")
    print(f"sweep: {n_var} variants x {SWEEP_EPOCHS} epochs, wall "
          f"{sweep_s:.2f} s (CLI, incl. 6 Trainer builds)")

    # ---- one unroll-5 categorical step with D-lr decay, card vs CPU
    cfg = TrainConfig(
        agent_frame=True, use_social=True, g_ema_decay=0.999,
        latent_code_type="categorical", n_latent_codes=3, loss_info_w=1.0,
        lr_d=5e-4, d_lr_decay_rate=0.7, d_lr_decay_steps=1,
        d_input_noise=0.05, d_input_noise_steps=-1, n_unrolling_steps=5,
        hidden_size=HIDDEN, social_feature_size=HIDDEN,
        noise_len=HIDDEN // 2, batch_size=BATCH, n_gen_samples=K,
        n_epochs=TOY_EPOCHS)
    # one profiled toy-flagship step (unroll 1, the recipe's)
    trainer = Trainer(cfg.replace(n_unrolling_steps=1), ds, dev)
    state, rng = trainer.init_state(seed=2), torch.Generator(device=dev)
    chunk, nv = chunk_of(trainer.train_dev, 1), int(
        trainer.train_packed.n_valid[1])
    profile_step(torch, "one toy train step", lambda: gan_step(
        state, chunk, draw_step(trainer.train_packed.width, trainer.cfg,
                                rng, dev), trainer.cfg, nv))
    trainer = Trainer(cfg, ds, dev)
    first_step_cuda_vs_cpu(torch, trainer, trainer.init_state(seed=2), dev,
                           "toy unroll-5 categorical D-lr-decay step")
    print(f"toy phase: {time.perf_counter() - tic_phase:.2f} s wall")
    return launches_train, launches_sweep, toy_rate, sweep_s


#: phase 10's runs: the command line after ``train --data X``, epochs, test
#: interval, and the forward and dkv launches a train step as PERF.md
#: predicts them (a no-grad rollout for the D phase and one under grad for
#: G when a loss decodes extra draws -- variety, mode seeking, diversity
#: hinge -- or under --serial-rollout; both once a micro-chunk under
#: --grad-accum 4).  The G-side variants run on the loo data, the D-side
#: and diversity variants, accumulation with the memory knobs and the
#: serial rollout on the big toy set.
GAN_RUNS = {
    "lstm_variety": (["--recipe", "loo", "--decoder", "lstm", "--noise-dist",
                      "gaussian", "--use-l2-loss", "--use-variety-loss",
                      "--grad-clip", "1.0", "--info-weight-end", "1.0",
                      "--info-weight-steps", "52"], 2, 1, (2, 1)),
    "d_side": (["--recipe", "toy-flagship", "--pac", "2", "--mb-std",
                "--spectral-norm", "--r1-gamma", "1.0", "--ms-weight", "0.1",
                "--ds-weight", "0.1", "--ds-k", "4", "--d-update-every", "2",
                "--d-update-every-end", "1", "--d-update-every-switch", "6"],
               6, 2, (2, 1)),
    "accum": (["--recipe", "toy-flagship", "--grad-accum", "4", "--pac", "2",
               "--mb-std", "--remat-steps"], 4, 2, (8, 4)),
    "serial": (["--recipe", "toy-flagship", "--serial-rollout"], 2, 2,
               (2, 1)),
}


def gan_run(torch, sa, cli_main, dev, data, work, tag, run=None,
            cpu_check=True, card=""):
    """One phase-10 run (``GAN_RUNS[tag]``, or ``run`` in its layout): its
    config's first step on the card against the CPU (unless not
    ``cpu_check``) and one profiled step, then ``cli train`` with the
    launches held to the predicted counts and train steps/s over the last
    epoch; ``card`` tags its times.  A ``--bf16`` run is held to the bf16
    kernels' counts, and launches no float32 kernel.  Returns (launches,
    rate, model dir)."""
    from socialways_torch.cli.main import _train_cfg, parse_args
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import Trainer, chunk_of

    flags, epochs, interval, per_step = run or GAN_RUNS[tag]
    ds = load_npz_dataset(data)
    argv = ["train", "--data", data] + flags + [
        "--epochs", str(epochs), "--test-interval", str(interval),
        "--save-interval", str(interval)]
    trainer = Trainer(_train_cfg(parse_args(argv)), ds, dev)
    batch = trainer.cfg.batch_size
    steps_epoch = len(greedy_chunks(ds.train_batches, batch))
    eval_chunks = len(greedy_chunks(ds.test_batches, batch))
    if cpu_check:
        first_step_cuda_vs_cpu(torch, trainer, trainer.init_state(seed=4),
                               dev, f"{tag} first step")
    # one profiled step of the run's config (device ops, idle share)
    state, rng = trainer.init_state(seed=4), torch.Generator(device=dev)
    chunk, nv = chunk_of(trainer.train_dev, 0), int(
        trainer.train_packed.n_valid[0])
    profile_step(torch, f"one {tag} train step" + (f" [{card}]" if card
                                                   else ""),
                 lambda: gan_step(state, chunk, draw_step(
                     trainer.train_packed.width, trainer.cfg, rng, dev),
                     trainer.cfg, nv))
    del trainer, state
    mdir, log = (os.path.join(work, f"gan_{tag}_{n}") for n in ("m", "log"))
    reset_launches(sa)
    run_cli(cli_main, argv + ["--model-dir", mdir, "--metrics-log", log],
            f"train {tag}", card)
    torch.cuda.synchronize()
    launches = (bf16_launches(sa, tag) if "--bf16" in flags
                else read_launches(sa))
    check_launches(tag, launches, epochs * steps_epoch,
                   (epochs // interval) * eval_chunks, *per_step)
    with open(log) as fh:
        recs = [json.loads(line) for line in fh]
    train = [r for r in recs if r["kind"] == "train"]
    evals = [r for r in recs if r["kind"] == "eval"]
    if ([r["epoch"] for r in train] != list(range(1, epochs + 1))
            or len(evals) != epochs // interval
            or not all(np.isfinite(r[k]) for r in train + evals
                       for k in r if k not in ("kind", "epoch"))):
        raise AssertionError(f"{tag}: metrics log {recs}")
    rate = steps_epoch / train[-1]["epoch_time_s"]
    print(f"{tag}: {epochs} epochs of {steps_epoch} steps, train steps/s "
          f"over the last epoch {rate:.2f}; last eval min ADE/FDE "
          f"{evals[-1]['ade_min']:.4f}/{evals[-1]['fde_min']:.4f}"
          + (f" [{card}]" if card else ""))
    return launches, rate, mdir


def gan_variants_phase(torch, sa, cli_main, dev, npz, work):
    """Phase 10: every gan_step variant at full width on the card: (a) the
    LSTM decoder, gaussian noise, l2 and variety losses, the clip and the
    info ramp on the loo data, then evaluate and predict of its checkpoint;
    (b) pac, minibatch stddev, spectral norm, R1, mode seeking, the
    diversity hinge and the D/G-ratio schedule on the big toy set; (c)
    accumulation over 4 micro-chunks with pac, mb_std and remat, and a
    serial-rollout run."""
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset

    tic_phase = time.perf_counter()
    toy = os.path.join(work, "toy.npz")
    launches, rates = {}, {}
    launches["lstm_variety"], rates["lstm_variety"], mdir = gan_run(
        torch, sa, cli_main, dev, npz, work, "lstm_variety")
    # serve the LSTM decoder: one forward a chunk
    ckpt = os.path.join(mdir, "socialWays-hotel.npz")
    with np.load(npz) as d:
        all_chunks = len(greedy_chunks(d["batches"], BATCH))
    test_chunks = len(greedy_chunks(load_npz_dataset(npz).test_batches,
                                    BATCH))
    out = os.path.join(work, "lstm_predictions.npz")
    for cmd, want in ((["evaluate", "--data", npz, "--model-file", ckpt],
                       test_chunks),
                      (["predict", "--data", npz, "--model-file", ckpt,
                        "--out", out], all_chunks)):
        reset_launches(sa)
        run_cli(cli_main, cmd, f"{cmd[0]} of the LSTM-decoder checkpoint")
        torch.cuda.synchronize()
        got = read_launches(sa)
        if got != {"fwd": want, "dq": 0, "dkv": 0}:
            raise AssertionError(f"{cmd[0]}: launched {got} for {want} "
                                 f"chunks")
        launches[f"lstm_{cmd[0]}"] = got
    with np.load(out) as d:
        if (d["preds_our"].shape[1:] != (d["obsvs"].shape[0], N_NEXT, 2)
                or not np.isfinite(d["preds_our"]).all()):
            raise AssertionError(f"predict wrote {d['preds_our'].shape}")
    for tag in ("d_side", "accum", "serial"):
        launches[tag], rates[tag], _ = gan_run(torch, sa, cli_main, dev, toy,
                                               work, tag)
    print(f"gan variants phase: {time.perf_counter() - tic_phase:.2f} s "
          f"wall")
    return launches, rates


#: phase 11: sorted scenes of 16 (simulate's and the packing's layout) at
#: simulate's default crowd and at a million agents
CROWD_N, CROWD_1M, CROWD_SCENE = 10_000, 1_048_576, 16
#: phase 11's crowd training runs, in GAN_RUNS's layout: just over the CPU's
#: dense cutoff (4,096 rows, so the CPU runs the windowed form) for the
#: card-vs-CPU step, and a 16k batch for train steps/s
CROWD_RUNS = {
    "crowd_train_4608": (["--recipe", "loo", "--max-scene-size", "16",
                          "--batch-size", "4608"], 1, 1, (1, 1)),
    "crowd_train_16384": (["--recipe", "loo", "--max-scene-size", "16",
                           "--batch-size", "16384"], 2, 2, (1, 1)),
}


def crowd_inputs(rng, n: int, hdim: int, scene: int = CROWD_SCENE):
    """Sorted scenes of ``scene`` agents and a padded tail (-1) of about
    4 %, with attention_inputs' states: the windowed contract at w =
    ``scene``."""
    ids = (np.arange(n) // scene).astype(np.int32)
    ids[(n - n // 25) // scene * scene:] = -1
    x4 = np.concatenate([rng.rand(n, 2), rng.randn(n, 2) * 0.02], axis=1)
    h = np.tanh(rng.randn(n, hdim))
    return x4.astype(np.float32), h.astype(np.float32), ids


def windowed_plain(torch, sa, g, x4, ids, h, wh, gout, w, block=512,
                   backward=True):
    """The plain versions taken window by window, as the windowed form
    takes its row blocks: each block of rows against the ``block + 2 w``
    rows around it, which hold every partner when scenes are sorted,
    contiguous and at most w rows.  Returns (out [N, H] float32, stats
    [N, 2], dq [N, 4], dkv list as social_attention_bwd_dkv's; the last two
    None unless ``backward``).  The backward zeroes the cotangent of the
    window's rows outside the block, so every pair enters the column sums
    and the weight gradients exactly once.  ``h``, ``wh`` and ``g``'s
    weights in one operand dtype (float32 or bf16)."""
    n = h.shape[0]
    win = min(block + 2 * w, n)
    weights = [t.detach() for layer in g.feat_mlp for t in (layer.w, layer.b)]
    out = torch.zeros((n, h.shape[1]), device=h.device)
    stats = torch.zeros((n, 2), device=h.device)
    dq = torch.zeros((n, 4), device=h.device) if backward else None
    dkv = None
    for i0 in range(0, n, block):
        j0 = min(max(i0 - w, 0), n - win)
        sl, rows = slice(j0, j0 + win), slice(i0 - j0, min(i0 + block, n) - j0)
        with torch.no_grad():
            o, m, l = sa.social_attention_stats_plain(
                g.feat_mlp, g.attn_w, x4[sl], h[sl], ids[sl])
        st = torch.stack([m, l], 1)
        out[i0:i0 + block] = o[rows]
        stats[i0:i0 + block] = st[rows]
        if not backward:
            continue
        keep = torch.zeros(win, dtype=torch.bool, device=h.device)
        keep[rows] = True
        gk = torch.where(keep[:, None], gout[sl], 0.0)
        rk = (gk * o).sum(-1)
        args = (x4[sl], ids[sl], h[sl], wh[sl], gk, st, rk, weights)
        dq[i0:i0 + block] = sa.social_attention_bwd_dq_plain(*args)[rows]
        part = sa.social_attention_bwd_dkv_plain(*args)
        if dkv is None:
            dkv = ([torch.zeros((n,) + t.shape[1:], device=h.device)
                    for t in part[:3]] + [torch.zeros_like(t)
                                          for t in part[3:]])
        for k, t in enumerate(part):
            if k < 3:
                dkv[k][sl] += t
            else:
                dkv[k] += t
    return out, stats, dq, dkv


def crowd_kernels(torch, sa, dev, cfg, card):
    """Phase 11a: each kernel at N = 10,000 at w = 16 and w = 0 (equal
    bits), against the plain windowed forms, timed alone at both; the w =
    16 forward at N = 1,048,576.  Returns (launches of the checks, the
    JSON entries by kernel)."""
    from socialways_torch.models.generator import init_generator
    from socialways_torch.ops.nn import linear_apply
    from socialways_torch.ops.social import social_context_windowed

    w = CROWD_SCENE
    g = init_generator(cfg, torch.Generator().manual_seed(17), dev)
    weights = [t.detach() for layer in g.feat_mlp for t in (layer.w, layer.b)]
    n_mlp = sum(t.numel() for t in weights)
    rng = np.random.RandomState(23)
    x4_np, h_np, ids_np = crowd_inputs(rng, CROWD_N, HIDDEN)
    x4, h, ids = (torch.from_numpy(a).to(dev) for a in (x4_np, h_np, ids_np))
    gout = torch.from_numpy(rng.randn(CROWD_N, HIDDEN).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        wh = linear_apply(g.attn_w, h)

    def run_all(ww):
        out, _, _, _ = sa._launch_fwd(x4, ids, h, wh, weights, False, ww)
        out_s, stats, u, c = sa._launch_fwd(x4, ids, h, wh, weights, True, ww)
        r = (gout * out_s).sum(-1)
        args = (x4, ids, h, wh, gout, stats, r, weights, u, c)
        dq = sa.social_attention_bwd_dq(*args, max_scene=ww)
        dkv = sa.social_attention_bwd_dkv(*args, max_scene=ww)
        return [out, out_s, stats, u, c, dq, *dkv], args

    reset_launches(sa)
    full, _ = run_all(0)
    win, args_w = run_all(w)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(full, win)):
        if not torch.equal(a, b):
            raise AssertionError(f"crowd N={CROWD_N}: output {k} of the w = "
                                 f"{w} launch differs from w = 0 in its bits")
    with torch.no_grad():
        p_out = social_context_windowed(g.feat_mlp, g.attn_w, x4, h, ids, w)
    _, p_stats, p_dq, p_dkv = windowed_plain(torch, sa, g, x4, ids, h, wh,
                                             gout, w)
    err = {"fwd": check_close(win[0], p_out, "crowd forward"),
           "fwd_stats": max(check_close(win[1], p_out, "crowd forward stats"),
                            check_close(win[2][:, 0], p_stats[:, 0],
                                        "crowd m"),
                            check_close(win[2][:, 1], p_stats[:, 1],
                                        "crowd l")),
           "dq": check_close(win[5], p_dq, "crowd dq dx_i", "dx")}
    kv = ["dx_j", "dh_j", "dwh_j", "dw1", "db1", "dw2", "db2", "dw3", "db3"]
    err["dkv"] = max(check_close(a, b, f"crowd dkv {nm}",
                                 "dx" if i == 0 else
                                 "weight" if i >= 3 else "value")
                     for i, (nm, a, b) in enumerate(zip(kv, win[6:], p_dkv)))
    launches = read_launches(sa)

    # each launch alone at both windows (dkv as training calls it, without
    # dx_j), the plain windowed forms beside
    calls = {"fwd": lambda ww: lambda: sa._launch_fwd(
                 x4, ids, h, wh, weights, False, ww),
             "fwd_stats": lambda ww: lambda: sa._launch_fwd(
                 x4, ids, h, wh, weights, True, ww),
             "dq": lambda ww: lambda: sa.social_attention_bwd_dq(
                 *args_w, max_scene=ww),
             "dkv": lambda ww: lambda: sa.social_attention_bwd_dkv(
                 *args_w, need_dx=False, max_scene=ww)}
    with torch.no_grad():
        plain_ms = {"fwd": median_ms(torch, lambda: social_context_windowed(
            g.feat_mlp, g.attn_w, x4, h, ids, w))}
    plain_ms["fwd_stats"] = plain_ms["fwd"]
    bwd_plain_ms = median_ms(torch, lambda: windowed_plain(
        torch, sa, g, x4, ids, h, wh, gout, w), repeats=3)
    plain_ms["dq"] = plain_ms["dkv"] = bwd_plain_ms
    bounds = {"fwd": attention_bound(ids_np, CROWD_N, HIDDEN, HIDDEN,
                                     n_mlp),
              "dq": attention_bwd_bound(ids_np, CROWD_N, HIDDEN, HIDDEN,
                                        n_mlp, "dq"),
              "dkv": attention_bwd_bound(ids_np, CROWD_N, HIDDEN, HIDDEN,
                                         n_mlp, "dkv")}
    bounds["fwd_stats"] = bounds["fwd"]
    entries = {}
    with torch.no_grad():
        for key, mk in calls.items():
            t_w, t_0 = median_ms(torch, mk(w)), median_ms(torch, mk(0))
            b = bounds[key]
            entries[key] = {
                "n": CROWD_N, "scene": w, "pairs": b["pairs_needed"],
                "window_ms": t_w, "full_scan_ms": t_0,
                "plain_windowed_ms": plain_ms[key],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "max_abs_err": err[key]}
            print(f"crowd kernel {key} N={CROWD_N} scenes of {w}: window w="
                  f"{w} {t_w * 1e3:.2f} us, full scan w=0 {t_0 * 1e3:.2f} us "
                  f"({t_0 / t_w:.1f}x), plain windowed "
                  f"{plain_ms[key] * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}, "
                  f"{b['pairs_needed']} pairs), max abs err {err[key]:.3e}; "
                  f"w={w} bits == w=0 bits [{card}]")

    # the window at a million agents: the forward only (a full scan there
    # is ~5.5e11 id tests)
    del x4, h, ids, wh, gout, full, win, args_w, p_dq, p_dkv
    x4_np, h_np, ids_np = crowd_inputs(rng, CROWD_1M, HIDDEN)
    x4, h, ids = (torch.from_numpy(a).to(dev) for a in (x4_np, h_np, ids_np))
    with torch.no_grad():
        wh = linear_apply(g.attn_w, h)
        reset_launches(sa)
        out = sa._launch_fwd(x4, ids, h, wh, weights, False, w)[0]
        launches["fwd"] += read_launches(sa)["fwd"]
        p_out = social_context_windowed(g.feat_mlp, g.attn_w, x4, h, ids, w)
        torch.cuda.synchronize()
        err_1m = check_close(out, p_out, f"crowd forward N={CROWD_1M}")
        t_1m = median_ms(torch, lambda: sa._launch_fwd(
            x4, ids, h, wh, weights, False, w))
        p_1m = median_ms(torch, lambda: social_context_windowed(
            g.feat_mlp, g.attn_w, x4, h, ids, w), repeats=3)
    b = attention_bound(ids_np, CROWD_1M, HIDDEN, HIDDEN, n_mlp)
    entries["fwd_1m"] = {"n": CROWD_1M, "scene": w,
                         "pairs": b["pairs_needed"], "window_ms": t_1m,
                         "full_scan_ms": None, "plain_windowed_ms": p_1m,
                         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                         "max_abs_err": err_1m}
    print(f"crowd kernel fwd N={CROWD_1M} scenes of {w}: window w={w} "
          f"{t_1m * 1e3:.1f} us, plain windowed {p_1m * 1e3:.1f} us, bound "
          f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}, "
          f"{b['pairs_needed']} pairs), max abs err {err_1m:.3e} [{card}]")
    return launches, entries


def crowd_simulate_runs(torch, sa, cli_main, dev, ckpt, card):
    """Phase 11b: ``cli simulate`` at its defaults and at a million agents
    from the loo checkpoint, with exact launches, then the trajectories at
    10,000 agents and 1 window against the CPU under the same noise."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.engine.losses import sample_noise
    from socialways_torch.engine.simulate import crowd_simulate, initial_crowd
    from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                                restore_generator)

    rates, launches = {}, {"fwd": 0, "dq": 0, "dkv": 0}
    for agents in (CROWD_N, CROWD_1M):
        reset_launches(sa)
        out = run_cli(cli_main, ["simulate", "--model-file", ckpt, "--agents",
                                 str(agents)], f"simulate {agents} agents",
                      card)
        torch.cuda.synchronize()
        got = read_launches(sa)
        if got != {"fwd": 8, "dq": 0, "dkv": 0}:
            raise AssertionError(f"simulate {agents}: launched {got}, not 2 "
                                 f"calls x 4 windows forwards")
        for k in launches:
            launches[k] += got[k]
        m = re.search(r"x (\d+) steps .* in ([\d.]+) ms = ", out)
        if not m or "route=cuda kernel" not in out:
            raise AssertionError(f"simulate {agents}: printed {out!r}")
        steps, ms = int(m.group(1)), float(m.group(2))
        rates[agents] = agents * steps / (ms * 1e-3)
        print(f"simulate {agents} agents x {steps} steps: {ms} ms, "
              f"{rates[agents]} agent-steps/s, launches {got} [{card}]")

    cfg = adopt_checkpoint_config(TrainConfig(), ckpt).replace(
        max_scene_size=CROWD_SCENE)
    obsv0, ids = initial_crowd(CROWD_N, CROWD_SCENE, cfg.n_past, 0)
    noise = sample_noise((1, CROWD_N), cfg, torch.Generator().manual_seed(9))
    traj = []      # on the card, then on the CPU
    for where in (dev, torch.device("cpu")):
        gen = restore_generator(ckpt, cfg, where)[0]
        traj.append(crowd_simulate(
            gen, torch.from_numpy(obsv0).to(where),
            torch.from_numpy(ids).to(where), 1, cfg,
            noise=noise.to(where)).cpu())
    diff = float((traj[0] - traj[1]).abs().max())
    if not bool(traj[0].isfinite().all()) or diff > 1e-4:
        raise AssertionError(f"simulate cuda vs cpu: max abs diff {diff:.3e}"
                             f" > 1e-4")
    print(f"simulate cuda vs cpu: {CROWD_N} agents x 1 window, max abs diff "
          f"{diff:.3e} (atol 1e-4, the checkpoint's normalized units; CPU "
          f"windowed form)")
    # where a window's time goes, at both crowd sizes
    gen = restore_generator(ckpt, cfg, dev)[0]
    for agents in (CROWD_N, CROWD_1M):
        obsv0, ids = (torch.from_numpy(a).to(dev) for a in initial_crowd(
            agents, CROWD_SCENE, cfg.n_past, 0))
        noise = sample_noise((1, agents), cfg, torch.Generator(
            device=dev).manual_seed(3), dev)
        profile_step(torch, f"one simulate window of {agents} agents "
                            f"[{card}]",
                     lambda: crowd_simulate(gen, obsv0, ids, 1, cfg,
                                            noise=noise))
    return launches, rates


def crowd_phase(torch, sa, cli_main, dev, ckpt, work, card):
    """Phase 11: crowd scale (the kernels' scene window, ``simulate``,
    crowd training with ``--max-scene-size``)."""
    from socialways_torch.config import TrainConfig
    tic_phase = time.perf_counter()
    cfg = TrainConfig(hidden_size=HIDDEN, social_feature_size=HIDDEN,
                      noise_len=HIDDEN // 2)
    launches = {}
    launches["crowd_kernels"], kernels = crowd_kernels(torch, sa, dev, cfg,
                                                       card)
    launches["simulate"], sim_rates = crowd_simulate_runs(
        torch, sa, cli_main, dev, ckpt, card)
    # a synthetic crowd: ETH/UCY-like scenes of 2-16, 82k windows
    npz = os.path.join(work, "crowd-8-12.npz")
    make_ethucy_like_npz(npz, n_windows=82_000, seed=1)
    train_rates = {}
    for tag, run in CROWD_RUNS.items():
        launches[tag], train_rates[tag], _ = gan_run(
            torch, sa, cli_main, dev, npz, work, tag, run,
            cpu_check=tag == "crowd_train_4608", card=card)
    launches["crowd_train"] = {k: sum(launches[t][k] for t in CROWD_RUNS)
                               for k in ("fwd", "dq", "dkv")}
    for tag in CROWD_RUNS:
        del launches[tag]
    print(f"crowd phase: {time.perf_counter() - tic_phase:.2f} s wall "
          f"[{card}]")
    return {"launches": launches, "kernels": kernels,
            "simulate_rates": {k: float(f"{v:.6g}") for k, v in
                               sim_rates.items()},
            "train_rates": {k: float(f"{v:.6g}") for k, v in
                            train_rates.items()}}


#: phase 12, bf16: the bounds of the bf16 kernels against their plain bf16
#: versions (PERF.md §6): sums in another order flip a bf16 rounding of
#: a1 or a2 now and then, and the forward rounds p against its batch's
#: running max: out within two bf16 ulps of |h| <= 1, m within 1e-3 (1 +
#: |m|), l within 1e-2 l; dx row by row within 3e-2 of the row's largest,
#: every other gradient within 1e-2 of its largest.  The float32 kernels
#: on the same bf16 values must miss a bound: their forward stays inside
#: the max bounds (out max about 1e-3), so out, m and l also hold their
#: median error within BF16_MEDIAN_REL of the largest |out| (of 1 + |m|,
#: of l), which the float32 kernel's medians exceed 40-fold or more
#: (PERF.md §6).  The backward's float32 kernels miss the dx and
#: gradient max bounds.
BF16_OUT_ATOL, BF16_DX_ROW, BF16_GRAD_REL = 8e-3, 3e-2, 1e-2
BF16_MEDIAN_REL = 1e-6
CROWD_BF16 = 32_768                 # BASELINE.md:51's bf16 crowd
#: phase 12's training runs, in GAN_RUNS's layout: the loo recipe at batch
#: 256 on phase 7's npz, and JAX's crowd memory recipe (--grad-accum,
#: --remat-steps; BASELINE.md:114-121) at batch 16,384 on a crowd npz of
#: scenes of 16, which tile its 4,096-row micro-chunks
BF16_RUNS = {
    "bf16_loo": (["--recipe", "loo", "--bf16"], 2, 1, (1, 1)),
    "bf16_crowd_train": (["--recipe", "loo", "--bf16", "--grad-accum", "4",
                          "--remat-steps", "--max-scene-size", "16",
                          "--batch-size", "16384"], 2, 2, (8, 4)),
}


def bf16_misses(got, want, kind="value"):
    """(max abs error, median abs error, the ``BF16_*`` bounds that ``got``
    misses against ``want``).  The forward's outputs also have a median
    bound, relative to each element's scale for m (1 + |m|) and l (l) and
    to the largest |out| for out."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    misses = [] if bool(got.isfinite().all()) else ["finite"]
    if kind == "m":
        rel = err / (1 + want.abs())
        misses += ["m"] if bool((rel > 1e-3).any()) else []
    elif kind == "l":
        rel = err / want.clamp(min=1e-30)
        misses += ["l"] if bool((rel > 1e-2).any()) else []
    else:
        top = float(want.abs().max())
        rel = err / max(top, 1e-30)
        if kind == "out":
            bad = float(err.max()) > BF16_OUT_ATOL
        elif kind == "dx":
            bad = bool((err.amax(dim=1) > BF16_DX_ROW * want.abs().amax(
                dim=1) + 1e-6).any())
        else:
            bad = float(err.max()) > BF16_GRAD_REL * top + 1e-6
        misses += [kind] if bad else []
    if kind in ("out", "m", "l") and float(rel.median()) > BF16_MEDIAN_REL:
        misses.append(f"median {float(rel.median()):.2e}")
    return float(err.max()), float(err.median()), misses


def check_bf16(name, got, want, kind="value", control=None):
    """A bf16 kernel against its plain bf16 version (``BF16_*`` bounds);
    returns (max, median) abs error.  ``control``: the float32 kernel's
    output on the same values, which must miss a bound (a kernel that
    never rounded would pass unseen otherwise); returns its misses."""
    mx, med, misses = bf16_misses(got, want, kind)
    if misses:
        raise AssertionError(f"{name}: bf16 kernel disagrees with its plain "
                             f"bf16 version ({', '.join(misses)}), max abs "
                             f"{mx:.3e}, median {med:.3e} (max ref "
                             f"{float(want.abs().max()):.3e}, {kind})")
    if control is None:
        return mx, med
    cmx, cmed, cmiss = bf16_misses(control, want, kind)
    print(f"  {name}: bf16 kernel max/median {mx:.3e}/{med:.3e}; float32 "
          f"kernel on the same values {cmx:.3e}/{cmed:.3e}, misses "
          f"{cmiss or 'none'}")
    return mx, med, cmiss


def bf16_kernel_case(torch, sa, g, x4, ids, h, w, tag, card, backward=True,
                     timed=True, dx_rows=True):
    """The bf16 kernels on one input (``g`` float32 masters; ``h`` holds
    bf16 values) against their plain bf16 versions (``dx_rows`` False: dx
    by ``dx_same_inputs`` instead of the per-row bound), from the same stats,
    u and c; a w > 0 launch against the w = 0 launch's bits; the float32
    kernels on the same values as a control that must miss a bound; each
    launch alone timed beside the float32 kernel on the same values, with
    its bound (bf16 bytes for h, wh and the weights, bf16 x bf16 products
    at the tensor-core peak)."""
    from socialways_torch.ops.nn import cast_params, linear_apply
    bf = torch.bfloat16
    g16 = cast_params(g, bf)
    n, hdim = h.shape
    h16 = h.to(bf)
    w16 = [t.detach() for layer in g16.feat_mlp for t in (layer.w, layer.b)]
    w32 = [t.float() for t in w16]
    with torch.no_grad():
        wh16 = linear_apply(g16.attn_w, h16.float()).to(bf)
    h32, wh32 = h16.float(), wh16.float()
    gout = torch.from_numpy(np.random.RandomState(n).randn(n, hdim).astype(
        np.float32)).to(h.device)
    ids_np = ids.cpu().numpy()
    windows = sorted({0, w})
    res, f32_before = {}, read_launches(sa)
    for ww in windows:
        with torch.no_grad():
            out, stats, u, c = sa._launch_fwd(x4, ids, h16, wh16, w16, True,
                                              ww)
            r = (gout * out).sum(-1)
            args = (x4, ids, h16, wh16, gout, stats, r, w16, u, c)
            res[ww] = [out, stats, u, c]
            if backward:
                res[ww] += [sa.social_attention_bwd_dq(*args, max_scene=ww),
                            *sa.social_attention_bwd_dkv(*args,
                                                         max_scene=ww)]
    torch.cuda.synchronize()
    if read_launches(sa) != f32_before:
        raise AssertionError(f"bf16 {tag}: bf16 calls launched float32 "
                             f"kernels")
    for k, (a, b) in enumerate(zip(res[windows[0]], res[windows[-1]])):
        if not torch.equal(a, b):
            raise AssertionError(f"bf16 {tag}: output {k} of the w = {w} "
                                 f"launch differs from w = 0 in its bits")
    out, stats, u, c = res[windows[-1]][:4]
    if n <= 4096:
        with torch.no_grad():
            p_out, p_m, p_l = sa.social_attention_stats_plain(
                g16.feat_mlp, g16.attn_w, x4, h16, ids)
        p_dq = sa.social_attention_bwd_dq_plain(
            x4, ids, h16, wh16, gout, stats, r, w16) if backward else None
        p_dkv = sa.social_attention_bwd_dkv_plain(
            x4, ids, h16, wh16, gout, stats, r, w16) if backward else None
    else:
        p_out, p_st, p_dq, p_dkv = windowed_plain(
            torch, sa, g16, x4, ids, h16, wh16, gout, w, backward=backward)
        p_m, p_l = p_st[:, 0], p_st[:, 1]
    # the control: the float32 kernels, forward and backward, on the same
    # bf16 values (h, wh and the weights widened), with their own stats
    with torch.no_grad():
        o32, st32, u32, c32 = sa._launch_fwd(x4, ids, h32, wh32, w32, True,
                                             w)
        ctrl = [o32, st32]
        if backward:
            a32 = (x4, ids, h32, wh32, gout, st32, (gout * o32).sum(-1),
                   w32, u32, c32)
            ctrl += [sa.social_attention_bwd_dq(*a32, max_scene=w),
                     *sa.social_attention_bwd_dkv(*a32, max_scene=w)]
    if backward and not dx_rows:     # dx by dx_same_inputs, not per row
        dx_same_inputs(torch, sa, f"bf16 {tag}",
                       (x4, ids, h16, wh16, gout, stats, r, w16),
                       {"dq dx_i": (res[windows[-1]][4], p_dq),
                        "dkv dx_j": (res[windows[-1]][5], p_dkv[0])})

    def check_dx(name, got, want, control):
        if dx_rows:
            return check_bf16(name, got, want, "dx", control)
        mx, med, _ = bf16_misses(got, want, "dx")
        return mx, med, bf16_misses(control, want, "dx")[2]

    err = {"fwd": [check_bf16(f"bf16 {tag} out", out, p_out, "out",
                              ctrl[0]),
                   check_bf16(f"bf16 {tag} m", stats[:, 0], p_m, "m",
                              ctrl[1][:, 0]),
                   check_bf16(f"bf16 {tag} l", stats[:, 1], p_l, "l",
                              ctrl[1][:, 1])]}
    if backward:
        dq, *dkv = res[windows[-1]][4:]
        err["dq"] = [check_dx(f"bf16 {tag} dq dx_i", dq, p_dq, ctrl[2])]
        names = ["dx_j", "dh_j", "dwh_j", "dw1", "db1", "dw2", "db2", "dw3",
                 "db3"]
        err["dkv"] = [check_dx(f"bf16 {tag} dkv {nm}", a, b, cf)
                      if nm == "dx_j" else
                      check_bf16(f"bf16 {tag} dkv {nm}", a, b, "grad", cf)
                      for nm, a, b, cf in zip(names, dkv, p_dkv, ctrl[3:])]
    blind = [k for k, v in err.items() if not any(e[2] for e in v)]
    if blind:
        raise AssertionError(f"bf16 {tag}: the float32 kernels on the same "
                             f"values pass every bf16 bound of {blind}")
    summary = {k: (max(e[0] for e in v), max(e[1] for e in v))
               for k, v in err.items()}
    entries = {}
    n_mlp = sum(t.numel() for t in w16)
    if timed:
        r = (gout * out).sum(-1)
        a16 = (x4, ids, h16, wh16, gout, stats, r, w16, u, c)
        a32 = (x4, ids, h32, wh32, gout, stats, r, w32, u, c)
        calls = {"fwd": lambda a: lambda: sa._launch_fwd(
                     a[0], a[1], a[2], a[3], a[7], True, w)}
        if backward:
            calls["dq"] = lambda a: lambda: sa.social_attention_bwd_dq(
                *a, max_scene=w)
            calls["dkv"] = lambda a: lambda: sa.social_attention_bwd_dkv(
                *a, need_dx=False, max_scene=w)
        plain = {"fwd": lambda: sa.social_attention_stats_plain(
            g16.feat_mlp, g16.attn_w, x4, h16, ids)}
        if n <= 4096 and backward:
            plain["dq"] = lambda: sa.social_attention_bwd_dq_plain(
                *a16[:8])
            plain["dkv"] = lambda: sa.social_attention_bwd_dkv_plain(
                *a16[:8], need_dx=False)
        elif n > 4096:
            plain = {k: (lambda: windowed_plain(
                torch, sa, g16, x4, ids, h16, wh16, gout, w,
                backward=backward)) for k in calls}
        with torch.no_grad():
            for key, mk in calls.items():
                t16 = median_ms(torch, mk(a16))
                t32 = median_ms(torch, mk(a32))
                p_ms = median_ms(torch, plain[key], repeats=3)
                if key == "fwd":
                    b = attention_bound(ids_np, n, hdim, hdim, n_mlp,
                                        op_bytes=2)
                else:
                    b = attention_bwd_bound(ids_np, n, hdim, hdim, n_mlp,
                                            key, op_bytes=2)
                entries[key] = {"n": n, "window": w, "ms": t16,
                                "f32_ms": t32, "plain_ms": p_ms,
                                "bound_ms": b["bound_ms"],
                                "bound_by": b["bound_by"],
                                "pairs": b["pairs_needed"],
                                "max_abs_err": summary[key][0],
                                "median_abs_err": summary[key][1]}
                print(f"bf16 kernel {key} [{tag}] N={n} w={w}: "
                      f"{t16 * 1e3:.2f} us (float32 kernel on the same "
                      f"values {t32 * 1e3:.2f} us), plain bf16 "
                      f"{p_ms * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.3f}"
                      f" us ({b['bound_by']}, {b['pairs_needed']} pairs), max"
                      f" / median abs err {summary[key][0]:.3e} / "
                      f"{summary[key][1]:.3e} [{card}]")
    print(f"bf16 kernels [{tag}] N={n}: " + ", ".join(
        f"{k} max/median abs err {v[0]:.3e}/{v[1]:.3e}"
        for k, v in summary.items())
        + (f"; w={w} bits == w=0 bits" if w else ""))
    return entries, summary


def bf16_serving(torch, sa, cli_main, dev, npz, ckpt, card):
    """Phase 12c: ``evaluate --bf16`` and ``predict --bf16`` of phase 7's
    float32 checkpoint (launches exact, bf16 only), its ADE/FDE against
    the float32 ``evaluate`` of the same checkpoint, the K = 20 rollout on
    the card against the CPU under bf16, and the bf16 rollout rate."""
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.eval.metrics import (draw_noise, eval_chunk,
                                               k_sample_rollout)
    from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                                restore_generator)

    ds = load_npz_dataset(npz)
    test_chunks = len(greedy_chunks(ds.test_batches, BATCH))
    with np.load(npz) as d:
        all_chunks = len(greedy_chunks(d["batches"], BATCH))
    ade, launches = {}, {}
    for tag, extra in (("float32", []), ("bf16", ["--bf16"])):
        reset_launches(sa)
        out = run_cli(cli_main, ["evaluate", "--data", npz, "--model-file",
                                 ckpt] + extra, f"evaluate ({tag})", card)
        got = (bf16_launches(sa, "evaluate --bf16") if extra
               else read_launches(sa))
        if got != {"fwd": test_chunks, "dq": 0, "dkv": 0}:
            raise AssertionError(f"evaluate {tag}: launched {got}")
        if extra:
            launches["evaluate"] = got
        m = re.search(r"Avg ADE,FDE.*?= \(([\d.]+), ([\d.]+)\).*?= "
                      r"\(([\d.]+), ([\d.]+)\)", out)
        ade[tag] = [float(v) for v in m.groups()]
    rel = max(abs(a - b) / b for a, b in zip(ade["bf16"], ade["float32"]))
    if rel > 0.05:
        raise AssertionError(f"evaluate: bf16 ADE/FDE {ade['bf16']} vs "
                             f"float32 {ade['float32']}: rel {rel:.3e}")
    print(f"evaluate bf16 vs float32 of one checkpoint: avg ADE/FDE, min "
          f"ADE/FDE {ade['bf16']} vs {ade['float32']}, largest rel "
          f"difference {rel:.3e} (bound 5e-2)")
    pred = os.path.join(os.path.dirname(ckpt), "bf16_predictions.npz")
    reset_launches(sa)
    run_cli(cli_main, ["predict", "--data", npz, "--model-file", ckpt,
                       "--out", pred, "--bf16"], "predict (bf16)", card)
    got = bf16_launches(sa, "predict --bf16")
    if got != {"fwd": all_chunks, "dq": 0, "dkv": 0}:
        raise AssertionError(f"predict --bf16: launched {got}")
    launches["predict"] = got
    with np.load(pred) as d:
        if (d["preds_our"].shape[1:] != (d["obsvs"].shape[0], N_NEXT, 2)
                or not np.isfinite(d["preds_our"]).all()):
            raise AssertionError(f"predict wrote {d['preds_our'].shape}")

    from socialways_torch.config import TrainConfig
    cfg = adopt_checkpoint_config(TrainConfig(n_gen_samples=K), ckpt).replace(
        compute_dtype="bfloat16")
    t_dev, t_cpu = Trainer(cfg, ds, dev), Trainer(cfg, ds, "cpu")
    gen, gen_cpu = (restore_generator(ckpt, cfg, d)[0] for d in (dev, "cpu"))
    noise_rng = torch.Generator().manual_seed(5)
    worst, worst_mean, worst_sum = 0.0, 0.0, 0.0
    for i in range(min(2, t_dev.test_packed.n_chunks)):
        noise = draw_noise(K, t_dev.test_packed.width, cfg, noise_rng)
        c_dev, c_cpu = chunk_of(t_dev.test_dev, i), chunk_of(t_cpu.test_dev, i)
        r_dev = k_sample_rollout(gen, c_dev["obsvs"], c_dev["scene_ids"], K,
                                 cfg, noise=noise.to(dev)).cpu()
        r_cpu = k_sample_rollout(gen_cpu, c_cpu["obsvs"], c_cpu["scene_ids"],
                                 K, cfg, noise=noise)
        v = c_cpu["valid"]
        diff = (r_dev - r_cpu)[:, v].abs()
        worst = max(worst, float(diff.max()))
        worst_mean = max(worst_mean, float(diff.mean()))
        s_dev = eval_chunk(gen, c_dev, K, cfg, noise=noise.to(dev))
        s_cpu = eval_chunk(gen_cpu, c_cpu, K, cfg, noise=noise)
        for a, b in zip(s_dev[:4], s_cpu[:4]):
            worst_sum = max(worst_sum, abs(float(a) - float(b)) / float(b))
    if worst > 5e-2 or worst_mean > 1e-3 or worst_sum > 1e-2:
        raise AssertionError(f"bf16 serving cuda vs cpu: rollout max abs "
                             f"{worst:.3e} (5e-2), mean {worst_mean:.3e} "
                             f"(1e-3), sums rel {worst_sum:.3e} (1e-2)")
    print(f"bf16 serving cuda vs cpu: K={K} rollout of the first chunks max "
          f"abs {worst:.3e} (bound 5e-2), mean {worst_mean:.3e} (bound "
          f"1e-3), ADE/FDE sums rel {worst_sum:.3e} (bound 1e-2)")
    n_valid = int(t_dev.test_packed.n_valid.sum())
    n_chunks = t_dev.test_packed.n_chunks
    rng_dev = torch.Generator(device=dev).manual_seed(0)

    def rollouts():
        for i in range(n_chunks):
            c = chunk_of(t_dev.test_dev, i)
            k_sample_rollout(gen, c["obsvs"], c["scene_ids"], K, cfg, rng_dev)
    rollouts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(3):
        rollouts()
    torch.cuda.synchronize()
    roll_s = (time.perf_counter() - tic) / 3
    rate = n_valid * K * N_NEXT / roll_s
    print(f"bf16 rollout: {n_valid} windows x K={K} x {N_NEXT} steps in "
          f"{roll_s * 1e3:.2f} ms = {rate:.4g} agent-steps/s [{card}]")
    return {"ade_fde": ade, "rollout_rate": rate,
            "cuda_vs_cpu_max_abs": worst, "launches": launches}


def bf16_simulate(torch, sa, cli_main, dev, ckpt, card):
    """Phase 12d: ``cli simulate --bf16`` at 32,768 and 1,048,576 agents
    (8 bf16 forwards a run, no float32 kernel), the trajectories at 10,000
    agents and 1 window on the card against the CPU under bf16, and one
    profiled 1,048,576-agent window."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.engine.losses import sample_noise
    from socialways_torch.engine.simulate import crowd_simulate, initial_crowd
    from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                                restore_generator)
    rates, launches = {}, {"fwd": 0, "dq": 0, "dkv": 0}
    for agents in (CROWD_BF16, CROWD_1M):
        reset_launches(sa)
        out = run_cli(cli_main, ["simulate", "--model-file", ckpt, "--agents",
                                 str(agents), "--bf16"],
                      f"simulate --bf16 {agents} agents", card)
        torch.cuda.synchronize()
        got = bf16_launches(sa, f"simulate --bf16 {agents}")
        if got != {"fwd": 8, "dq": 0, "dkv": 0}:
            raise AssertionError(f"simulate --bf16 {agents}: launched {got}")
        for k in launches:
            launches[k] += got[k]
        m = re.search(r"x (\d+) steps .* in ([\d.]+) ms = ", out)
        if not m or "route=cuda kernel" not in out:
            raise AssertionError(f"simulate {agents}: printed {out!r}")
        steps, ms = int(m.group(1)), float(m.group(2))
        rates[agents] = agents * steps / (ms * 1e-3)
        print(f"simulate --bf16 {agents} agents x {steps} steps: {ms} ms, "
              f"{rates[agents]} agent-steps/s, bf16 launches {got} [{card}]")
    cfg = adopt_checkpoint_config(TrainConfig(), ckpt).replace(
        max_scene_size=CROWD_SCENE, compute_dtype="bfloat16")
    obsv0, ids = initial_crowd(CROWD_N, CROWD_SCENE, cfg.n_past, 0)
    noise = sample_noise((1, CROWD_N), cfg, torch.Generator().manual_seed(9))
    traj = []
    for where in (dev, torch.device("cpu")):
        gen = restore_generator(ckpt, cfg, where)[0]
        traj.append(crowd_simulate(
            gen, torch.from_numpy(obsv0).to(where),
            torch.from_numpy(ids).to(where), 1, cfg,
            noise=noise.to(where)).cpu())
    diff = (traj[0] - traj[1]).abs()
    if (not bool(traj[0].isfinite().all()) or float(diff.max()) > 2e-2
            or float(diff.mean()) > 1e-3):
        raise AssertionError(f"simulate --bf16 cuda vs cpu: max abs "
                             f"{float(diff.max()):.3e} (2e-2), mean "
                             f"{float(diff.mean()):.3e} (1e-3)")
    print(f"simulate bf16 cuda vs cpu: {CROWD_N} agents x 1 window, max abs "
          f"{float(diff.max()):.3e} (bound 2e-2), mean "
          f"{float(diff.mean()):.3e} (bound 1e-3), normalized units")
    gen = restore_generator(ckpt, cfg, dev)[0]
    obsv0, ids = (torch.from_numpy(a).to(dev) for a in initial_crowd(
        CROWD_1M, CROWD_SCENE, cfg.n_past, 0))
    noise = sample_noise((1, CROWD_1M), cfg, torch.Generator(
        device=dev).manual_seed(3), dev)
    profile_step(torch, f"one bf16 simulate window of {CROWD_1M} agents "
                        f"[{card}]",
                 lambda: crowd_simulate(gen, obsv0, ids, 1, cfg,
                                        noise=noise))
    return rates, launches


def bf16_phase(torch, sa, cli_main, dev, npz, ckpt, work, train_chunk,
               card):
    """Phase 12, bf16: (a) the bf16 kernels against their plain bf16
    versions at the loo training chunk, at N = 10,000 in sorted scenes of
    16 (w = 16 and w = 0, equal bits) and, forward only, at N = 32,768;
    (b) ``cli train --recipe loo --bf16``; (c) bf16 serving; (d) ``cli
    simulate --bf16``; (e) JAX's crowd memory recipe under bf16."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.models.generator import init_generator
    tic_phase = time.perf_counter()
    cfg = TrainConfig(hidden_size=HIDDEN, social_feature_size=HIDDEN,
                      noise_len=HIDDEN // 2)
    g_path, x4_np, h_np, ids_np = train_chunk
    t = lambda a: torch.from_numpy(a).to(dev)
    reset_launches(sa)
    kernels, errs = {}, {}
    kernels["path"], errs["path"] = bf16_kernel_case(
        torch, sa, g_path, t(x4_np), t(ids_np), t(h_np), 0,
        "loo train chunk 0", card)
    g = init_generator(cfg, torch.Generator().manual_seed(17), dev)
    rng = np.random.RandomState(29)
    for n, backward in ((CROWD_N, True), (CROWD_BF16, False)):
        x4c, hc, idsc = crowd_inputs(rng, n, HIDDEN)
        kernels[n], errs[n] = bf16_kernel_case(
            torch, sa, g, t(x4c), t(idsc), t(hc), CROWD_SCENE,
            f"crowd N={n}", card, backward=backward)
    launches, rates = {}, {}
    launches["bf16_loo"], rates["bf16_loo"], mdir = gan_run(
        torch, sa, cli_main, dev, npz, work, "bf16_loo", BF16_RUNS["bf16_loo"],
        card=card)
    with np.load(os.path.join(mdir, "socialWays-hotel.npz")) as d:
        bad = [k for k in d.files if k.startswith((".g_", ".d_"))
               and not k.endswith(".count") and d[k].dtype != np.float32]
    if bad:
        raise AssertionError(f"bf16 checkpoint: state not float32: {bad}")
    print("bf16 loo checkpoint: every parameter and optimizer tensor float32")
    serving = bf16_serving(torch, sa, cli_main, dev, npz, ckpt, card)
    launches.update(serving["launches"])
    sim_rates, launches["simulate"] = bf16_simulate(torch, sa, cli_main, dev,
                                                    ckpt, card)
    crowd = os.path.join(work, "crowd16-8-12.npz")
    make_ethucy_like_npz(crowd, n_windows=82_000, seed=1, scene=CROWD_SCENE)
    launches["bf16_crowd_train"], rates["bf16_crowd_train"], _ = gan_run(
        torch, sa, cli_main, dev, crowd, work, "bf16_crowd_train",
        BF16_RUNS["bf16_crowd_train"], cpu_check=False, card=card)
    wall = time.perf_counter() - tic_phase
    print(f"bf16 phase: {wall:.2f} s wall [{card}]")
    return {"kernels": kernels, "errs": errs, "launches": launches,
            "train_rates": rates, "serving": serving,
            "simulate_rates": sim_rates, "wall_s": wall}


#: phase 13: the ensemble's members (ROADMAP Queue 1 item 9), the member
#: counts whose rates it measures, and the toy protocol's robust1 base
#: (benchmarks/coverage_ensemble.py:88-93) for its coverage check
ENSEMBLE_M, ENSEMBLE_RATE_MS = 4, (1, 4, 8)
ROBUST1_BASE = dict(batch_size=256, n_unrolling_steps=1, lr_d=5e-4,
                    latent_code_type="categorical", n_latent_codes=3,
                    loss_info_w=1.0, d_lr_decay_rate=0.7,
                    d_lr_decay_steps=10000)


def member_operands(torch, gens, hs, op):
    """M members' kernel operands: each member's feature MLP and attention
    weights (generators ``gens``) and hidden states ``hs`` (float32),
    wh = h W + b, stacked on a leading member axis in the operand dtype
    ``op`` as the wrappers take them (bf16: the Pallas rounding of JAX's
    cast)."""
    from socialways_torch.ops.nn import cast_params, linear_apply
    h_m, wh_m, w_m = [], [], []
    for g, h in zip(gens, hs):
        g = cast_params(g, op)
        h = h.to(op)
        with torch.no_grad():
            wh_m.append(linear_apply(g.attn_w, h.float()).to(op))
        h_m.append(h)
        w_m.append([t.detach() for layer in g.feat_mlp
                    for t in (layer.w, layer.b)])
    stack = lambda ts: torch.stack(ts).contiguous()
    return stack(h_m), stack(wh_m), [stack(list(t)) for t in zip(*w_m)]


def member_kernel_case(torch, sa, dev, x4, ids, gens, hs, tag, card, op,
                       max_scene=0, backward=True, plain=True, dx_rows=True):
    """Phase 13a on one input: the member launch of each kernel (forward
    with and without stats, dq, dkv with its finalize, with and without
    dx_j) for the members' generators ``gens`` and hidden states ``hs`` on
    shared x4 and ids, against M = len(gens) solo launches (M = 1) on the
    members' operands (equal bits), against the member plain version
    (float32: ``check_close``'s bounds; bf16: ``check_bf16``'s; ``plain``
    False: at crowd N, where the solo launches were held against the
    windowed plain form in phase 11), and timed beside M solo launches and
    the member launch's bound (x4 and ids read once).  ``dx_rows`` False
    holds dx (dq's, dkv's dx_j) by ``dx_same_inputs``, not at the per-row
    bound against the plain version."""
    m, (n,) = len(gens), ids.shape
    hdim = hs[0].shape[-1]
    h, wh, w = member_operands(torch, gens, hs, op)
    gout = torch.from_numpy(np.random.RandomState(60).randn(
        m, n, hdim).astype(np.float32)).to(dev)
    bf16 = op == torch.bfloat16
    with torch.no_grad():
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, True, max_scene)
        out0 = sa._launch_fwd(x4, ids, h, wh, w, False, max_scene)[0]
        r = (gout * out).sum(-1)
        args = (x4, ids, h, wh, gout, stats, r, w)
        if backward:
            dq = sa.social_attention_bwd_dq(*args, u, c, max_scene=max_scene)
            dkv = sa.social_attention_bwd_dkv(*args, u, c, need_dx=False,
                                              max_scene=max_scene)
            dkv_x = sa.social_attention_bwd_dkv(*args, u, c,
                                                max_scene=max_scene)
        solo = lambda i: (x4, ids, h[i], wh[i], [t[i] for t in w])
        for i in range(m):
            o, st, ui, ci = sa._launch_fwd(*solo(i), True, max_scene)
            same = [torch.equal(o, out[i]), torch.equal(st, stats[i]),
                    torch.equal(ui, u[i]), torch.equal(ci, c[i]),
                    torch.equal(sa._launch_fwd(*solo(i), False,
                                               max_scene)[0], out0[i])]
            if backward:
                a_i = (x4, ids, h[i], wh[i], gout[i], st, r[i],
                       [t[i] for t in w], ui, ci)
                same.append(torch.equal(sa.social_attention_bwd_dq(
                    *a_i, max_scene=max_scene), dq[i]))
                for full, part in ((dkv, sa.social_attention_bwd_dkv(
                        *a_i, need_dx=False, max_scene=max_scene)),
                                   (dkv_x, sa.social_attention_bwd_dkv(
                                       *a_i, max_scene=max_scene))):
                    same += [torch.equal(a[i], b) for a, b in zip(full, part)
                             if b is not None]
            if not all(same):
                raise AssertionError(f"member kernels [{tag}]: member {i} "
                                     f"differs from its solo launches "
                                     f"({same})")
        torch.cuda.synchronize()
    # against the member plain versions
    errs = {}
    with torch.no_grad():
        p_out, p_stats = (sa.social_attention_fwd_members_plain(
            x4, ids, h, wh, w) if plain else (None, None))
    if plain and bf16:
        errs["fwd"] = max(check_bf16(f"member fwd out [{tag}]", out, p_out,
                                     "out")[0],
                          check_bf16(f"member fwd m [{tag}]", stats[..., 0],
                                     p_stats[..., 0], "m")[0],
                          check_bf16(f"member fwd l [{tag}]", stats[..., 1],
                                     p_stats[..., 1], "l")[0])
    elif plain:
        errs["fwd"] = max(check_close(out, p_out, f"member fwd out [{tag}]"),
                          check_close(stats, p_stats,
                                      f"member fwd stats [{tag}]"))
    if backward and plain:
        p_dq = sa.social_attention_bwd_dq_members_plain(*args)
        p_dkv = sa.social_attention_bwd_dkv_members_plain(*args)
        kinds = ["dx", "value", "value"] + ["weight"] * 6
        dq_err, dkv_err = 0.0, 0.0
        if not dx_rows:
            dq_err = dx_same_inputs(torch, sa, f"member {tag}", args,
                                    {"dq dx_i": (dq, p_dq)})
            dkv_err = dx_same_inputs(torch, sa, f"member {tag}", args,
                                     {"dkv dx_j": (dkv_x[0], p_dkv[0])})
        for i in range(m):
            if not dx_rows:
                pass                                    # held above
            elif bf16:
                dq_err = max(dq_err, check_bf16(f"member dq [{tag}]", dq[i],
                                                p_dq[i], "dx")[0])
            else:
                dq_err = max(dq_err, check_close(dq[i], p_dq[i],
                                                 f"member dq [{tag}]", "dx"))
            for kd, a, b in zip(kinds, dkv_x, p_dkv):
                kd = ("grad" if kd == "weight" else kd) if bf16 else kd
                if kd == "dx" and not dx_rows:
                    continue                            # held above
                else:
                    chk = (check_bf16(f"member dkv [{tag}]", a[i], b[i],
                                      kd)[0]
                           if bf16 else check_close(a[i], b[i],
                                                    f"member dkv [{tag}]",
                                                    kd))
                dkv_err = max(dkv_err, chk)
        errs["dq"], errs["dkv"] = dq_err, dkv_err
    # times: the member launch, M solo launches, the member plain version
    with torch.no_grad():
        solo_fwd = lambda st: (lambda: [sa._launch_fwd(*solo(i), st,
                                                       max_scene)
                                        for i in range(m)])
        calls = {"fwd": (lambda: sa._launch_fwd(x4, ids, h, wh, w, False,
                                                max_scene), solo_fwd(False)),
                 "fwd_stats": (lambda: sa._launch_fwd(x4, ids, h, wh, w, True,
                                                      max_scene),
                               solo_fwd(True))}
        if backward:
            solo_args = [(x4, ids, h[i], wh[i], gout[i], stats[i], r[i],
                          [t[i] for t in w], u[i], c[i]) for i in range(m)]
            calls["dq"] = (lambda: sa.social_attention_bwd_dq(
                *args, u, c, max_scene=max_scene),
                lambda: [sa.social_attention_bwd_dq(*a, max_scene=max_scene)
                         for a in solo_args])
            calls["dkv"] = (lambda: sa.social_attention_bwd_dkv(
                *args, u, c, need_dx=False, max_scene=max_scene),
                lambda: [sa.social_attention_bwd_dkv(
                    *a, need_dx=False, max_scene=max_scene)
                    for a in solo_args])
        # M solo wrapper calls take more host time than M device kernels:
        # a short run keeps their enqueue inside median_ms's device sleep
        ms = {k: (median_ms(torch, a), median_ms(torch, b, budget_s=0.01))
              for k, (a, b) in calls.items()}
        plain_ms = {"fwd_stats": median_ms(
            torch, lambda: sa.social_attention_fwd_members_plain(
                x4, ids, h, wh, w))} if plain else {}
        if backward and plain:
            plain_ms["dq"] = median_ms(
                torch, lambda: sa.social_attention_bwd_dq_members_plain(*args))
            plain_ms["dkv"] = median_ms(
                torch, lambda: sa.social_attention_bwd_dkv_members_plain(
                    *args, need_dx=False))
    ids_np = ids.cpu().numpy()
    op_bytes = 2 if bf16 else 4
    n_mlp = sum(t[0].numel() for t in w)
    # the member launch's own operands: x4 and ids once (shared), the rest
    # and every operation once a member
    bound = {
        "fwd_stats": attention_bound(ids_np, n, hdim, hdim, n_mlp,
                                     op_bytes=op_bytes, members=m),
        "dq": attention_bwd_bound(ids_np, n, hdim, hdim, n_mlp, "dq",
                                  op_bytes=op_bytes, members=m),
        "dkv": attention_bwd_bound(ids_np, n, hdim, hdim, n_mlp, "dkv",
                                   op_bytes=op_bytes, members=m)}
    bound["fwd"] = bound["fwd_stats"]
    res = {}
    for k, (k_ms, s_ms) in ms.items():
        b = bound[k]
        res[k] = {"ms": k_ms, "solo_ms": s_ms, "plain_ms": plain_ms.get(k),
                  "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                  "max_abs_err": errs.get("fwd" if k.startswith("fwd")
                                          else k)}
        print(f"member {k} [{tag}, M = {m}, {'bf16' if bf16 else 'float32'}"
              f"]: one launch {k_ms * 1e3:.2f} us, {m} solo launches "
              f"{s_ms * 1e3:.2f} us, member plain "
              + (f"{plain_ms[k] * 1e3:.2f} us" if k in plain_ms else "-")
              + f", bound {b['bound_ms'] * 1e3:.3f} us "
              f"({b['bound_by']}) [{card}]")
    print(f"member kernels [{tag}, {'bf16' if bf16 else 'float32'}]: every "
          f"member equals its solo launches bit for bit; max abs error "
          f"against the member plain versions {errs or 'not compared'}")
    return res, errs


#: phase 14: hidden sizes JAX runs that are not the kernels' native
#: multiples of 16 up to 128 (padded: 24, 100; looped over: 256, 512), the
#: ones also checked at M = 4, and the CLI runs at two of them
WIDTHS, WIDTH_MEMBERS = (24, 100, 256, 512), (24, 256)
WIDTH_RUNS = {
    "loo_h256": (["--recipe", "loo", "--hidden-size", "256"], 1, 1, (1, 1)),
    "loo_h24": (["--recipe", "loo", "--hidden-size", "24"], 1, 1, (1, 1)),
}


def width_kernels(torch, sa, dev, obsv_in, x4, ids, card):
    """Phase 14a: at H = F = 64 and each of ``WIDTHS`` on the first loo
    training chunk (its canonicalized observations ``obsv_in``, x4 and
    ids; generators of that width drawn from seeds, their encoder states
    h): the forward with stats, dq and dkv in float32
    (``backward_case``: the Function and each kernel against the plain
    versions at phase 4's bounds, timed) and in bf16 (``bf16_kernel_case``,
    phase 12's bounds), and at M = 4 for ``WIDTH_MEMBERS``
    (``member_kernel_case``, phase 13's checks), each kernel's float32
    (bf16) launch counter going up in its float32 (bf16) case.  Returns
    {width: {"fwd_stats" | "dq" | "dkv": times and bounds}}."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.models.generator import (encode_observation,
                                                   init_generator)
    from socialways_torch.ops.traj import obsv_to_4d
    x4_np, ids_np = x4.cpu().numpy(), ids.cpu().numpy()
    res = {}

    def encoded(g):
        with torch.no_grad():
            return encode_observation(g, obsv_to_4d(obsv_in))[0].contiguous()

    for width in (HIDDEN,) + WIDTHS:
        cfg = TrainConfig(hidden_size=width, social_feature_size=width,
                          noise_len=width // 2)
        g = init_generator(cfg, torch.Generator().manual_seed(140 + width),
                           dev)
        h_np = encoded(g).cpu().numpy()
        tag = f"loo train chunk 0 H=F={width}"
        reset_launches(sa)
        f32 = backward_case(torch, sa, tag, g, x4_np, h_np, ids_np,
                            seed=140 + width, dx_rows=False)
        counts = read_launches(sa)
        if not all(counts.values()) or any(read_launches(sa, True).values()):
            raise AssertionError(f"{tag}: float32 launches {counts}, bf16 "
                                 f"{read_launches(sa, True)}")
        reset_launches(sa)
        entries, _ = bf16_kernel_case(
            torch, sa, g, x4, ids, torch.from_numpy(h_np).to(dev), 0, tag,
            card, dx_rows=False)
        counts16 = read_launches(sa, True)
        if not all(counts16.values()):
            raise AssertionError(f"{tag}: bf16 launches {counts16}")
        res[width] = {
            "fwd_stats": {"ms": f32["stats_ms"],
                          "plain_ms": f32["stats_plain_ms"],
                          "bound_ms": f32["bounds"]["fwd"]["bound_ms"]},
            **{k: {"ms": f32["ms"][k][0], "plain_ms": f32["ms"][k][1],
                   "bound_ms": f32["bounds"][k]["bound_ms"]}
               for k in ("dq", "dkv")},
            "bf16": {k: {"ms": e["ms"], "bound_ms": e["bound_ms"]}
                     for k, e in entries.items()},
            "launches": counts, "launches_bf16": counts16}
        if width in WIDTH_MEMBERS:
            gens = [init_generator(cfg, torch.Generator().manual_seed(
                150 + width + i), dev) for i in range(ENSEMBLE_M)]
            hs = [encoded(gi) for gi in gens]
            for op in (torch.float32, torch.bfloat16):
                reset_launches(sa)
                member, _ = member_kernel_case(torch, sa, dev, x4, ids, gens,
                                               hs, tag, card, op,
                                               dx_rows=False)
                got = read_launches(sa, op == torch.bfloat16)
                if not all(got.values()):
                    raise AssertionError(f"{tag} M = {ENSEMBLE_M} {op}: "
                                         f"launches {got}")
                res[width][f"members_{str(op).split('.')[-1]}"] = {
                    k: {"ms": e["ms"], "bound_ms": e["bound_ms"]}
                    for k, e in member.items()}
    print("widths: " + "; ".join(
        f"H=F={w}: fwd+stats {r['fwd_stats']['ms'] * 1e3:.2f} us, dq "
        f"{r['dq']['ms'] * 1e3:.2f}, dkv {r['dkv']['ms'] * 1e3:.2f} (bf16 "
        f"{r['bf16']['fwd']['ms'] * 1e3:.2f} / {r['bf16']['dq']['ms'] * 1e3:.2f}"
        f" / {r['bf16']['dkv']['ms'] * 1e3:.2f})" for w, r in res.items())
        + f" [{card}]")
    return res


def widths_phase(torch, sa, cli_main, dev, npz, train_chunk, work, card):
    """Phase 14, every width JAX runs: (a) ``width_kernels`` on the first
    loo training chunk (``train_chunk``: its canonicalized observations,
    x4 and ids); (b) ``cli train --recipe loo --hidden-size`` 256 and 24
    for an epoch (``WIDTH_RUNS`` through ``gan_run``: the first step on
    the card against the CPU, a profiled step, launches one forward and
    one dkv a step plus one forward an eval chunk, no dq)."""
    tic_phase = time.perf_counter()
    kernels = width_kernels(torch, sa, dev, *train_chunk, card)
    launches, rates = {}, {}
    for tag, run in WIDTH_RUNS.items():
        launches[tag], rates[tag], _ = gan_run(torch, sa, cli_main, dev, npz,
                                               work, tag, run, card=card)
    wall = time.perf_counter() - tic_phase
    print(f"widths phase: {wall:.2f} s wall; train steps/s {rates} "
          f"[{card}]")
    return {"kernels": kernels, "launches": launches, "train_rates": rates,
            "wall_s": wall}


#: phase 15: JAX's loop flags on train (a block of 2 epochs, a save and an
#: eval at each block's end) and simulate
LOOP_FLAGS = ["--recipe", "loo", "--fused-epochs", "--block-size", "2",
              "--epochs", "4", "--test-interval", "2", "--save-interval", "2",
              "--pallas", "--host-loop", "--latent-dim", "10"]


def loop_flags_phase(torch, sa, cli_main, npz, ckpt, work, card):
    """Phase 15: ``cli train`` with JAX's loop flags (``LOOP_FLAGS``) on
    phase 7's npz: forward launches = steps + eval chunks and dkv = steps
    exactly, no dq; one print (" (2 fused epochs)") and one metrics row
    (``n_block`` 2) a block, a checkpoint and an eval at each block's end;
    then ``cli simulate --pallas`` at 10,000 agents from phase 7's
    checkpoint, 8 forward launches exactly."""
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset
    ds = load_npz_dataset(npz)
    steps = 4 * len(greedy_chunks(ds.train_batches, BATCH))
    evals = 2 * len(greedy_chunks(ds.test_batches, BATCH))
    mdir, log = (os.path.join(work, f"loop_flags_{n}") for n in ("m", "log"))
    reset_launches(sa)
    out = run_cli(cli_main, ["train", "--data", npz, "--model-dir", mdir,
                             "--metrics-log", log] + LOOP_FLAGS,
                  "train " + " ".join(LOOP_FLAGS), card)
    torch.cuda.synchronize()
    launches = {"train": read_launches(sa)}
    check_launches("train with the loop flags", launches["train"], steps,
                   evals)
    lines = out.splitlines()
    epc = [line for line in lines if "Epc=" in line]
    with open(log) as fh:
        recs = [json.loads(line) for line in fh]
    rows = [(r["kind"], r["epoch"], r.get("n_block")) for r in recs]
    saved = [line for line in lines if line.startswith("saved checkpoint")]
    with np.load(os.path.join(mdir, "socialWays-hotel.npz")) as d:
        last = int(d["__epoch__"])
    if (len(epc) != 2 or not all(line.endswith("(2 fused epochs)")
                                 for line in epc)
            or rows != [("train", 2, 2), ("eval", 2, None), ("train", 4, 2),
                        ("eval", 4, None)]
            or len(saved) != 2 or last != 4):
        raise AssertionError(f"loop flags: prints {epc}, log {rows}, saves "
                             f"{saved}, checkpoint epoch {last}")
    print(f"loop flags: 2 blocks of 2 epochs, one print and one metrics row "
          f"(n_block 2) a block, a checkpoint and an eval at epochs 2 and 4 "
          f"[{card}]")
    reset_launches(sa)
    run_cli(cli_main, ["simulate", "--model-file", ckpt, "--agents",
                       str(CROWD_N), "--pallas"], "simulate --pallas", card)
    torch.cuda.synchronize()
    launches["simulate"] = read_launches(sa)
    if launches["simulate"] != {"fwd": 8, "dq": 0, "dkv": 0}:
        raise AssertionError(f"simulate --pallas launched "
                             f"{launches['simulate']}, not 2 calls x 4 "
                             f"windows forwards")
    return launches


def ensemble_loo(torch, sa, dev, npz, cfg, card):
    """Phase 13b: ``EnsembleTrainer`` on the loo recipe at full width, M =
    ENSEMBLE_M seeds: the first member step against the members' solo
    steps under the same draws, one epoch and ``evaluate`` against solo
    runs, and the kernels' launches over that epoch and evaluate."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import (EnsembleTrainer,
                                                  member_state, stack_draws)
    from socialways_torch.engine.train_step import (draw_step, eval_params,
                                                    gan_step)
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.io.checkpoint import flatten_state

    tr = Trainer(cfg, load_npz_dataset(npz), dev)
    ens = EnsembleTrainer(tr)
    seeds = [1 + i for i in range(ENSEMBLE_M)]
    width, nv0 = tr.train_packed.width, int(tr.train_packed.n_valid[0])
    # the first step: member-batched against solo, the same draws
    draws = [draw_step(width, tr.cfg, torch.Generator(device=dev).manual_seed(
        70 + s), dev) for s in seeds]
    stacked, m = gan_step(ens.init_states(seeds), chunk_of(tr.train_dev, 0),
                          stack_draws(draws), tr.cfg, nv0, members=True)
    worst = 0.0
    for i, s in enumerate(seeds):
        solo, ms = gan_step(tr.init_state(s), chunk_of(tr.train_dev, 0),
                            draws[i], tr.cfg, nv0)
        for nm in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            a, b = float(getattr(m, nm)[i]), float(getattr(ms, nm))
            if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b):
                raise AssertionError(f"ensemble first step member {i} {nm}: "
                                     f"{a} vs solo {b}")
        f_m, f_s = flatten_state(member_state(stacked, i)), flatten_state(solo)
        for key, ref in f_s.items():
            if key.endswith(".count"):
                if int(f_m[key]) != int(ref):
                    raise AssertionError(f"ensemble {key}: {f_m[key]} vs "
                                         f"{ref}")
                continue
            err = float(np.abs(f_m[key] - ref).max())
            scale = float(np.abs(ref).max())
            if err > 1e-3 * scale + 1e-9:
                raise AssertionError(f"ensemble first step member {i} {key}:"
                                     f" max abs {err:.3e}, scale {scale:.3e}")
            worst = max(worst, err / (1e-3 * scale + 1e-9))
    print(f"ensemble first step (M = {ENSEMBLE_M}, loo width) vs {ENSEMBLE_M}"
          f" solo steps: losses and sums within rel 1e-4, every state "
          f"tensor at most {worst:.3f} of 1e-3 its scale")
    # one epoch and evaluate: the main path of the slice
    gens = lambda: [torch.Generator(device=dev).manual_seed(90 + s)
                    for s in seeds]
    states = ens.init_states(seeds)
    reset_launches(sa)
    for fn in (sa.social_attention_fwd, sa.social_attention_bwd_dq,
               sa.social_attention_bwd_dkv):
        fn.member_launches = fn.member_launches_bf16 = 0
    states, me = ens.train_epoch(states, gens())
    epoch_launches = read_launches(sa)
    ev = ens.evaluate(states, seeds)
    torch.cuda.synchronize()
    launches = read_launches(sa)
    member_launches = {"fwd": sa.social_attention_fwd.member_launches,
                       "dq": sa.social_attention_bwd_dq.member_launches,
                       "dkv": sa.social_attention_bwd_dkv.member_launches}
    n_steps, n_eval = tr.n_steps_per_epoch, tr.test_packed.n_chunks
    want = {"fwd": n_steps + n_eval, "dq": 0, "dkv": n_steps}
    if launches != want or member_launches != want or epoch_launches != {
            "fwd": n_steps, "dq": 0, "dkv": n_steps}:
        raise AssertionError(f"ensemble epoch + evaluate launched {launches} "
                             f"(member launches {member_launches}, epoch "
                             f"{epoch_launches}), want {want}: one launch a "
                             f"step and an eval chunk for all members")
    for i, s in enumerate(seeds):
        solo, ms = tr.train_epoch(tr.init_state(s), gens()[i])
        ev_s = tr.evaluate(eval_params(solo), s)
        pairs = [(f"train {k}", me[k][i], ms[k]) for k in
                 ("d_loss", "g_loss", "train_ade", "train_fde")]
        pairs += [(f"eval {k}", ev[i][k], ev_s[k]) for k in ev_s]
        for nm, a, b in pairs:
            if not np.isfinite(a) or abs(a - b) > 2e-4 * abs(b):
                raise AssertionError(f"ensemble member {i} {nm}: {a} vs solo "
                                     f"{b} (rel 2e-4)")
    print(f"ensemble epoch (M = {ENSEMBLE_M}, {n_steps} steps) + evaluate "
          f"({n_eval} chunks): launches fwd {launches['fwd']} = {n_steps} + "
          f"{n_eval}, dkv {launches['dkv']}, dq {launches['dq']}, every one "
          f"a member launch; each member's train metrics and evaluate ADE/FDE"
          f" within rel 2e-4 of its solo run (member 0: ade_min "
          f"{ev[0]['ade_min']:.6f}) [{card}]")
    return {"launches": launches, "trainer": tr}


def ensemble_rates(torch, dev, tr, card):
    """Phase 13c: member-steps/s of an ensemble epoch at each M of
    ENSEMBLE_RATE_MS and the solo train steps/s, in one process, the runs
    alternated over two rounds (medians); one ensemble step at M =
    ENSEMBLE_M profiled."""
    from socialways_torch.engine.ensemble import EnsembleTrainer, stack_draws
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import chunk_of
    ens = EnsembleTrainer(tr)
    n_steps = tr.n_steps_per_epoch
    runs = {m: (ens.init_states(list(range(m))),
                [torch.Generator(device=dev).manual_seed(s)
                 for s in range(m)]) for m in ENSEMBLE_RATE_MS}
    solo = [tr.init_state(0), torch.Generator(device=dev).manual_seed(0)]
    times = {m: [] for m in (*ENSEMBLE_RATE_MS, "solo")}
    for rnd in range(3):            # round 0 warms every run up
        for key in (*ENSEMBLE_RATE_MS, "solo"):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            if key == "solo":
                solo[0], _ = tr.train_epoch(*solo)
            else:
                st, gens = runs[key]
                runs[key] = (ens.train_epoch(st, gens)[0], gens)
            torch.cuda.synchronize()
            if rnd:
                times[key].append(time.perf_counter() - tic)
    rates = {f"M={m}": m * n_steps / float(np.median(times[m]))
             for m in ENSEMBLE_RATE_MS}
    rates["solo"] = n_steps / float(np.median(times["solo"]))
    print(f"ensemble rates (loo width, batch {BATCH}, {n_steps} steps an "
          f"epoch, 2 alternated rounds, medians): member-steps/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items() if k != "solo")
          + f"; solo train steps/s {rates['solo']:.2f} [{card}]")
    st, gens = runs[ENSEMBLE_M]
    width = tr.train_packed.width
    c1, nv1 = chunk_of(tr.train_dev, 1), int(tr.train_packed.n_valid[1])
    prof = profile_step(torch, f"one ensemble step (M = {ENSEMBLE_M})",
                        lambda: gan_step(st, c1, stack_draws(
                            [draw_step(width, tr.cfg, g, dev) for g in gens]),
                            tr.cfg, nv1, members=True))
    return rates, prof


def ensemble_coverage(torch, dev, work, card):
    """Phase 13d: the robust1 base on the big toy set, seeds 0, 1, 2 for 2
    epochs: each member's coverage equals its solo run's (the CLI's
    ``_coverage`` with the member's seed)."""
    from socialways_torch.cli.main import _coverage
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.data.toy import make_toy_npz_arrays
    from socialways_torch.engine.ensemble import EnsembleTrainer
    from socialways_torch.engine.train_step import eval_params
    from socialways_torch.engine.trainer import Trainer
    toy = os.path.join(work, "toy-ensemble.npz")
    np.savez(toy, **make_toy_npz_arrays(n_conditions=8, n_samples=768,
                                        n_per_batch=8))
    ds = load_npz_dataset(toy)
    tr = Trainer(TrainConfig(**ROBUST1_BASE), ds, dev)
    ens, seeds = EnsembleTrainer(tr), [0, 1, 2]
    gens = lambda: [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    states, _ = ens.train_epochs(ens.init_states(seeds), gens(), 2)
    covs = ens.coverage(states, seeds)
    solo_covs = []
    for i, s in enumerate(seeds):
        solo, _ = tr.train_epochs(tr.init_state(s), gens()[i], 2)
        solo_covs.append(_coverage(eval_params(solo), ds, tr.cfg,
                                   tr.cfg.n_gen_samples, s, dev))
    if covs != solo_covs:
        raise AssertionError(f"ensemble coverage {covs} != solo {solo_covs}")
    print(f"ensemble coverage (robust1 base, big toy set, seeds {seeds}, 2 "
          f"epochs): {covs}, equal to each member's solo run [{card}]")
    return covs


def ensemble_phase(torch, sa, dev, npz, work, train_cfg, card):
    """Phase 13, the ensemble: (a) the member kernels, (b) EnsembleTrainer
    on the loo recipe, (c) rates and a profiled step, (d) coverage."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.models.generator import (encode_observation,
                                                   init_generator)
    from socialways_torch.ops.traj import (canonicalize_for_rollout,
                                           obsv_to_4d)
    tic_phase = time.perf_counter()
    # (a) on the operands of the ensemble's first step: the first loo
    # training chunk, the generators of seeds 1..M (as Trainer.init_state
    # draws them) and their encoder states
    tr = Trainer(train_cfg, load_npz_dataset(npz), dev)
    chunk = chunk_of(tr.train_dev, 0)
    obsv_in, _, x4 = canonicalize_for_rollout(chunk["obsvs"], True, True)
    gens = [init_generator(tr.cfg, torch.Generator().manual_seed(1 + i), dev)
            for i in range(ENSEMBLE_M)]
    with torch.no_grad():
        hs = [encode_observation(g, obsv_to_4d(obsv_in))[0] for g in gens]
    kernels = {}
    for op in (torch.float32, torch.bfloat16):
        kernels[str(op).split(".")[-1]] = member_kernel_case(
            torch, sa, dev, x4.contiguous(), chunk["scene_ids"], gens, hs,
            "loo train chunk 0", card, op)
    x4c, _, idsc = crowd_inputs(np.random.RandomState(62), CROWD_N, HIDDEN)
    rng = np.random.RandomState(63)
    hc = [torch.from_numpy(np.tanh(rng.randn(CROWD_N, HIDDEN)).astype(
        np.float32)).to(dev) for _ in gens]
    kernels["crowd"] = member_kernel_case(
        torch, sa, dev, torch.from_numpy(x4c).to(dev),
        torch.from_numpy(idsc).to(dev), gens, hc,
        f"crowd N={CROWD_N} w={CROWD_SCENE}", card, torch.float32,
        max_scene=CROWD_SCENE, backward=False, plain=False)
    loo = ensemble_loo(torch, sa, dev, npz, train_cfg, card)
    rates, prof = ensemble_rates(torch, dev, loo["trainer"], card)
    covs = ensemble_coverage(torch, dev, work, card)
    wall = time.perf_counter() - tic_phase
    print(f"ensemble phase: {wall:.2f} s wall [{card}]")
    return {"kernels": kernels, "launches": loo["launches"], "rates": rates,
            "profile": prof, "coverage": covs, "wall_s": wall}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from socialways_torch.cli.main import main as cli_main
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.eval.metrics import (draw_noise, eval_chunk,
                                               k_sample_rollout)
    from socialways_torch.io.checkpoint import (restore_generator,
                                                save_generator_checkpoint)
    from socialways_torch.kernels import _build
    from socialways_torch.kernels import social_attention as sa
    from socialways_torch.models.generator import (encode_observation,
                                                   init_generator)
    from socialways_torch.ops.nn import linear_apply
    from socialways_torch.ops.traj import canonicalize_for_rollout, obsv_to_4d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn (f32 parity)")
    t_start = time.perf_counter()

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, cuda "
          f"{torch.version.cuda})")
    print(smi)

    # ---- 2. build
    build_kernels(_build)

    dev = torch.device("cuda")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        npz = os.path.join(work, "ethucy_like-8-12.npz")
        make_ethucy_like_npz(npz)
        cfg = TrainConfig(agent_frame=True, use_social=True,
                          g_ema_decay=0.999, hidden_size=HIDDEN,
                          social_feature_size=HIDDEN, noise_len=HIDDEN // 2,
                          batch_size=BATCH, n_past=N_PAST, n_next=N_NEXT,
                          n_gen_samples=K)
        ds = load_npz_dataset(npz)
        gen_cpu = init_generator(cfg, torch.Generator().manual_seed(1), "cpu")
        ckpt = os.path.join(work, "loo-init.npz")
        save_generator_checkpoint(ckpt, gen_cpu, 0, ds.scale, cfg)
        gen = restore_generator(ckpt, cfg, dev)[0]
        trainer = Trainer(cfg, ds, dev)

        # ---- 3. forward kernel against plain on the card
        # the launch floor: device time of the smallest op there is, the
        # yardstick beside bounds that sit below any launch at N = 256
        tiny = torch.zeros(1, device=dev)
        floor_ms = median_ms(torch, lambda: tiny.add_(1.0))
        print(f"launch floor (one-element add_, CUDA events): "
              f"{floor_ms * 1e3:.2f} us")
        rng = np.random.RandomState(0)
        cases = []
        for name, n, hdim, scene in SHAPES + EXTRA_SHAPES:
            g = init_generator(cfg.replace(hidden_size=hdim,
                                           social_feature_size=hdim,
                                           noise_len=hdim // 2),
                               torch.Generator().manual_seed(n + hdim), dev)
            cases.append((name, g) + attention_inputs(rng, n, hdim, scene))
        # the serving path's input: test chunk 0 as evaluate builds it
        chunk = chunk_of(trainer.test_dev, 0)
        obsv_in, _, sx4 = canonicalize_for_rollout(chunk["obsvs"], True, True)
        with torch.no_grad():
            h_path = encode_observation(gen, obsv_to_4d(obsv_in))[0]
        cases.append(("path: test chunk 0", gen, sx4.contiguous().cpu().numpy(),
                      h_path.cpu().numpy(), chunk["scene_ids"].cpu().numpy()))

        max_err, path_timing = 0.0, None
        for name, g, x4, h, ids in cases:
            args = (g.feat_mlp, g.attn_w, torch.from_numpy(x4).to(dev),
                    torch.from_numpy(h).to(dev), torch.from_numpy(ids).to(dev))
            w = [t.detach() for layer in g.feat_mlp for t in (layer.w, layer.b)]
            with torch.no_grad():
                got = sa.social_attention_fwd(*args)
                want = sa.social_attention_plain(*args)
                torch.cuda.synchronize()
                err = (got - want).abs()
                rel = float((err / want.abs().clamp_min(1e-30)).max())
                check_close(got, want, f"forward {name}")
                wh = linear_apply(g.attn_w, args[3])
                k_ms = median_ms(torch, lambda: sa._launch_fwd(
                    args[2], args[4], args[3], wh, w, with_stats=False))
                wr_ms = median_ms(torch, lambda: sa.social_attention_fwd(*args))
                p_ms = median_ms(torch,
                                 lambda: sa.social_attention_plain(*args))
            n, hdim = h.shape
            feat = g.attn_w.w.shape[1]
            n_mlp = sum(t.numel() for t in g.feat_mlp.parameters())
            bound = attention_bound(ids, n, hdim, feat, n_mlp)
            bound_wr = attention_bound(ids, n, hdim, feat, n_mlp,
                                       with_wh=True)
            max_err = max(max_err, float(err.max()))
            print(f"forward vs plain [{name}]: max abs {float(err.max()):.3e} "
                  f"max rel {rel:.3e} (rtol {RTOL}, atol {ATOL}) ok | kernel "
                  f"alone {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
                  f"bound {bound['bound_ms'] * 1e3:.3f} us "
                  f"({bound['bound_by']}; {bound['pairs_needed']} pairs need "
                  f"the MLP, {bound['pairs_id_tested']} id tests), launch "
                  f"floor {floor_ms * 1e3:.2f} us")
            print(f"  forward wrapper with wh = h W + b [{name}]: "
                  f"{wr_ms * 1e3:.2f} us (bound {bound_wr['bound_ms'] * 1e3:.3f}"
                  f" us)")
            if name.startswith("path"):
                path_timing = (k_ms, p_ms, bound, wr_ms)
                print(f"  forward bound at the serving path: u-form "
                      f"{bound['bound_ms'] * 1e3:.3f} us; the f . wh form "
                      f"(64 F + 2 F MAC a pair instead of 64) "
                      f"{bound['old_bound_ms'] * 1e3:.3f} us; with wh "
                      f"{bound_wr['bound_ms'] * 1e3:.3f} / "
                      f"{bound_wr['old_bound_ms'] * 1e3:.3f} us")

        # ---- 4. backward kernels against plain, synthetic inputs + the path
        train_cfg = cfg.replace(d_input_noise=0.05, d_input_noise_steps=-1,
                                d_input_noise_floor=0.02, n_epochs=200)
        t_tr = Trainer(train_cfg, ds, dev)
        st0 = t_tr.init_state(seed=1)
        tc = chunk_of(t_tr.train_dev, 0)
        t_in, _, t_sx4 = canonicalize_for_rollout(tc["obsvs"], True, True)
        with torch.no_grad():
            t_h = encode_observation(st0.g, obsv_to_4d(t_in))[0]
        bwd_cases = cases[:-1] + [("path: train chunk 0", st0.g,
                                   t_sx4.contiguous().cpu().numpy(),
                                   t_h.cpu().numpy(),
                                   tc["scene_ids"].cpu().numpy())]
        bwd_err = {"dq": 0.0, "dkv": 0.0}
        dq_by_input = {}
        for i, (name, g, x4, h, ids) in enumerate(bwd_cases):
            res = backward_case(torch, sa, name, g, x4, h, ids, seed=100 + i)
            for k in bwd_err:
                bwd_err[k] = max(bwd_err[k], res["err"][k])
            dq_by_input[name] = {
                "ms": res["ms"]["dq"][0], "plain_ms": res["ms"]["dq"][1],
                "bound_ms": res["bounds"]["dq"]["bound_ms"],
                "by_launch_us": res["split"]["dq"]}
            if name.startswith("path"):
                bwd_path = res
        del t_tr, st0

        # ---- 5. the serving slice end to end through the CLI, on the card
        n_chunks = trainer.test_packed.n_chunks
        sa.social_attention_fwd.launches = 0
        tic = time.perf_counter()
        rc = cli_main(["evaluate", "--data", npz, "--model-file", ckpt])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - tic
        launches_eval = sa.social_attention_fwd.launches
        out = os.path.join(work, "predictions.npz")
        tic = time.perf_counter()
        rc |= cli_main(["predict", "--data", npz, "--model-file", ckpt,
                        "--out", out])
        predict_s = time.perf_counter() - tic
        launches_serving = sa.social_attention_fwd.launches
        if rc != 0:
            raise AssertionError(f"CLI returned {rc}")
        if launches_eval < n_chunks:
            raise AssertionError(f"evaluate launched the kernel "
                                 f"{launches_eval} times for {n_chunks} "
                                 f"test chunks")
        with np.load(out) as d:
            n_win = d["obsvs"].shape[0]
            shape = d["preds_our"].shape
            if shape != (K, n_win, N_NEXT, 2) or not np.isfinite(
                    d["preds_our"]).all():
                raise AssertionError(f"predict wrote preds_our {shape}")
        print(f"evaluate: {n_chunks} test chunks, {launches_eval} kernel "
              f"launches, {eval_s:.3f} s wall (CLI, incl. load)")
        print(f"predict: {n_win} windows, {launches_serving - launches_eval} "
              f"kernel launches, {predict_s:.3f} s wall (CLI, incl. load)")

        # CUDA vs CPU on the first chunks, same weights and noise
        trainer_cpu = Trainer(cfg, ds, "cpu")
        gen_ref = restore_generator(ckpt, cfg, "cpu")[0]
        noise_rng = torch.Generator().manual_seed(5)
        worst = 0.0
        for i in range(min(2, n_chunks)):
            noise = draw_noise(K, trainer.test_packed.width, cfg, noise_rng)
            c_gpu, c_cpu = (chunk_of(trainer.test_dev, i),
                            chunk_of(trainer_cpu.test_dev, i))
            r_gpu = k_sample_rollout(gen, c_gpu["obsvs"], c_gpu["scene_ids"],
                                     K, cfg, noise=noise.to(dev))
            r_cpu = k_sample_rollout(gen_ref, c_cpu["obsvs"],
                                     c_cpu["scene_ids"], K, cfg, noise=noise)
            diff = float((r_gpu.cpu() - r_cpu).abs().max())
            worst = max(worst, diff)
            if diff > 1e-4:
                raise AssertionError(f"chunk {i}: CUDA and CPU rollouts "
                                     f"differ by {diff:.3e} > 1e-4")
            s_gpu = eval_chunk(gen, c_gpu, K, cfg, noise=noise.to(dev))
            s_cpu = eval_chunk(gen_ref, c_cpu, K, cfg, noise=noise)
            for a, b in zip(s_gpu, s_cpu):
                if abs(float(a) - float(b)) > 1e-4 * abs(float(b)):
                    raise AssertionError(f"chunk {i}: ADE/FDE sums differ: "
                                         f"{tuple(s_gpu)} vs {tuple(s_cpu)}")
        print(f"serving cuda vs cpu: first {min(2, n_chunks)} chunks, "
              f"rollout max abs diff {worst:.3e} (atol 1e-4, normalized "
              f"units), sums within rel 1e-4")

        # K=20 rollout rate over the whole test split
        n_valid = int(trainer.test_packed.n_valid.sum())
        rng_dev = torch.Generator(device=dev).manual_seed(0)

        def rollouts():
            for i in range(n_chunks):
                c = chunk_of(trainer.test_dev, i)
                k_sample_rollout(gen, c["obsvs"], c["scene_ids"], K, cfg,
                                 rng_dev)
        rollouts()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(3):
            rollouts()
        torch.cuda.synchronize()
        roll_s = (time.perf_counter() - tic) / 3
        rate = n_valid * K * N_NEXT / roll_s
        print(f"rollout: {n_valid} windows x K={K} x {N_NEXT} steps in "
              f"{roll_s * 1e3:.2f} ms = {rate:.4g} agent-steps/s "
              f"({roll_s / n_chunks * 1e3:.3f} ms per chunk of {BATCH})")
        profile_step(torch, "one chunk's K=20 rollout",
                     lambda: k_sample_rollout(gen, chunk["obsvs"],
                                              chunk["scene_ids"], K, cfg,
                                              rng_dev))

        # ---- 6. the training slice at full loo width, on the card
        launches_train, steps_s = training_phase(torch, sa, dev, npz,
                                                 train_cfg)

        # ---- 7. the CLI's train --recipe loo, resume, evaluate
        loo_ckpt = cli_phase(torch, cli_main, npz, work)

        # ---- 8. the real-data pipeline: eth-ucy, raw predict, Kalman
        launches_loo, launches_raw = realdata_phase(torch, sa, cli_main, dev,
                                                    ckpt, work)

        # ---- 9. the toy protocol: train with its outputs, stats, sweep
        launches_toy, launches_sweep, toy_rate, sweep_s = toy_phase(
            torch, sa, cli_main, dev, work)

        # ---- 10. every gan_step variant: loo (G side), toy (D side, accum)
        launches_gan, gan_rates = gan_variants_phase(torch, sa, cli_main,
                                                     dev, npz, work)

        # ---- 11. crowd scale: window-scan kernels, simulate, training
        crowd = crowd_phase(torch, sa, cli_main, dev, loo_ckpt, work, smi)

        # ---- 12. bf16: the kernels' bf16 mode, train, serve, simulate
        bf16 = bf16_phase(torch, sa, cli_main, dev, npz, loo_ckpt, work,
                          bwd_cases[-1][1:], smi)

        # ---- 13. the ensemble: member kernels, EnsembleTrainer, rates
        ens = ensemble_phase(torch, sa, dev, npz, work, train_cfg, smi)

        # ---- 14. every width JAX runs: the kernels, train at 256 and 24
        widths = widths_phase(torch, sa, cli_main, dev, npz,
                              (t_in, t_sx4.contiguous(), tc["scene_ids"]),
                              work, smi)

        # ---- 15. JAX's loop flags: train --fused-epochs, simulate --pallas
        loops = loop_flags_phase(torch, sa, cli_main, npz, loo_ckpt, work,
                                 smi)

        k_ms, p_ms, bound, wr_ms = path_timing
        src = "socialways_torch/kernels/csrc/"
        tpu = "socialways_tpu/kernels/social_attention.py"
        # ms: the kernel's launches alone, at the training chunk, as the
        # training path calls them; the forward's serving-chunk times beside
        kernels = [{
            "name": "social_attention_fwd",
            "route": "cuda",
            "source": src + "social_attention_fwd.cuh",
            "replaces": f"{tpu}:150 (_kernel)",
            "launches": launches_train["fwd"],
            "launches_by_path": {"serving": launches_serving,
                                 "training": launches_train["fwd"],
                                 "eth_ucy": launches_loo["fwd"],
                                 "raw_predict": launches_raw,
                                 "toy_train": launches_toy["fwd"],
                                 "sweep": launches_sweep["fwd"],
                                 **{f"gan_{k}": v["fwd"]
                                    for k, v in launches_gan.items()},
                                 **{k: v["fwd"] for k, v in
                                    crowd["launches"].items()},
                                 **{k: v["fwd"] for k, v in
                                    widths["launches"].items()},
                                 **{f"loop_flags_{k}": v["fwd"]
                                    for k, v in loops.items()}},
            "max_abs_err": max_err,
            "ms": bwd_path["stats_ms"],
            "kernel_ms": bwd_path["stats_ms"],
            "plain_ms": bwd_path["stats_plain_ms"],
            "bound_ms": bwd_path["bounds"]["fwd"]["bound_ms"],
            "bound_by": bwd_path["bounds"]["fwd"]["bound_by"],
            "library_ms": None,
            "launch_floor_ms": floor_ms,
            "by_launch_us": bwd_path["split"]["fwd"],
            "serving_kernel_ms": k_ms,
            "serving_plain_ms": p_ms,
            "serving_bound_ms": bound["bound_ms"],
            "serving_wrapper_ms": wr_ms,
            "crowd": crowd["kernels"]["fwd"],
            "crowd_stats": crowd["kernels"]["fwd_stats"],
            "crowd_1m": crowd["kernels"]["fwd_1m"],
            "widths": {w: r["fwd_stats"] for w, r in
                       widths["kernels"].items()},
        }]
        for key, fn, line in (("dq", "_bwd_dq_kernel", 317),
                              ("dkv", "_bwd_dkv_kernel", 372)):
            kernels.append({
                "name": f"social_attention_bwd_{key}",
                "route": "cuda",
                "source": src + "social_attention_bwd.cuh",
                "replaces": f"{tpu}:{line} ({fn})",
                "launches": launches_train[key],
                "launches_by_path": {"training": launches_train[key],
                                     "eth_ucy": launches_loo[key],
                                     "toy_train": launches_toy[key],
                                     "sweep": launches_sweep[key],
                                     **{f"gan_{k}": v[key]
                                        for k, v in launches_gan.items()},
                                     **{k: v[key] for k, v in
                                        crowd["launches"].items()},
                                     **{k: v[key] for k, v in
                                        widths["launches"].items()},
                                     **{f"loop_flags_{k}": v[key]
                                        for k, v in loops.items()}},
                "max_abs_err": bwd_err[key],
                "ms": bwd_path["ms"][key][0],
                "kernel_ms": bwd_path["ms"][key][0],
                "plain_ms": bwd_path["ms"][key][1],
                "bound_ms": bwd_path["bounds"][key]["bound_ms"],
                "bound_by": bwd_path["bounds"][key]["bound_by"],
                "library_ms": None,
                "launch_floor_ms": floor_ms,
                "crowd": crowd["kernels"][key],
                "widths": {w: r[key] for w, r in widths["kernels"].items()},
            })
        kernels[1]["by_launch_us"] = bwd_path["split"]["dq"]
        kernels[1]["by_input"] = dq_by_input
        kernels[2]["by_launch_us"] = bwd_path["split"]["dkv"]
        # the bf16 entry points: launches from the bf16 loo training run,
        # times at its first chunk (N = 256), crowd checks beside
        for key, fn, line, f in (("fwd", "_kernel", 150, "fwd"),
                                 ("dq", "_bwd_dq_kernel", 317, "bwd"),
                                 ("dkv", "_bwd_dkv_kernel", 372, "bwd")):
            e = bf16["kernels"]["path"][key]
            name = ("social_attention_fwd" if key == "fwd"
                    else f"social_attention_bwd_{key}")
            kernels.append({
                "name": name + "_bf16",
                "route": "cuda",
                "source": src + f"social_attention_{f}.cuh",
                "replaces": f"{tpu}:{line} ({fn}, bf16 operands)",
                "launches": bf16["launches"]["bf16_loo"][key],
                "launches_by_path": {
                    k: v[key] for k, v in bf16["launches"].items()},
                "max_abs_err": max(v[key][0] for v in bf16["errs"].values()
                                   if key in v),
                "median_abs_err": max(v[key][1] for v in
                                      bf16["errs"].values() if key in v),
                "ms": e["ms"],
                "plain_ms": e["plain_ms"],
                "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"],
                "library_ms": None,
                "launch_floor_ms": floor_ms,
                "f32_kernel_ms_same_values": e["f32_ms"],
                "crowd": bf16["kernels"][CROWD_N][key],
                "widths": {w: r["bf16"][key] for w, r in
                           widths["kernels"].items()},
                **({"crowd_32k": bf16["kernels"][CROWD_BF16]["fwd"]}
                   if key == "fwd" else {}),
            })
        # the member launches (the same entries, M > 1): launches from the
        # ensemble's epoch and evaluate (float32; the ensemble refuses
        # bf16), times at M = 4 on the first loo training chunk
        for dt, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            res = ens["kernels"][dt][0]
            for key, fn, line, f, t_key in (
                    ("fwd", "_kernel", 150, "fwd", "fwd_stats"),
                    ("dq", "_bwd_dq_kernel", 317, "bwd", "dq"),
                    ("dkv", "_bwd_dkv_kernel", 372, "bwd", "dkv")):
                e = res[t_key]
                name = ("social_attention_fwd" if key == "fwd"
                        else f"social_attention_bwd_{key}")
                kernels.append({
                    "name": name + suffix + "_members",
                    "route": "cuda",
                    "source": src + f"social_attention_{f}.cuh",
                    "replaces": f"{tpu}:{line} ({fn}, a member axis)",
                    "launches": (ens["launches"][key] if not suffix
                                 else 0),
                    "max_abs_err": e["max_abs_err"],
                    "ms": e["ms"],
                    "plain_ms": e["plain_ms"],
                    "bound_ms": e["bound_ms"],
                    "bound_by": e["bound_by"],
                    "library_ms": None,
                    "members": ENSEMBLE_M,
                    "solo_launches_ms": e["solo_ms"],
                    **({"crowd": ens["kernels"]["crowd"][0]["fwd_stats"]}
                       if key == "fwd" and not suffix else {}),
                })
        print(f"train steps/s (epoch 2, loo width, batch {BATCH}): "
              f"{steps_s:.2f}; toy train steps/s {toy_rate:.2f}; sweep "
              f"{sweep_s:.2f} s; gan variants train steps/s "
              f"{', '.join(f'{k} {v:.2f}' for k, v in gan_rates.items())}; "
              f"crowd: simulate {crowd['simulate_rates']} agent-steps/s, "
              f"crowd train steps/s {crowd['train_rates']}; bf16: train "
              f"steps/s {bf16['train_rates']}, rollout "
              f"{bf16['serving']['rollout_rate']:.4g} agent-steps/s, "
              f"simulate {bf16['simulate_rates']} agent-steps/s, phase 12 "
              f"{bf16['wall_s']:.1f} s; ensemble: member-steps/s "
              f"{ens['rates']}, a step at M = {ENSEMBLE_M} "
              f"{ens['profile']['ops']} device ops, "
              f"{ens['profile']['device_us']:.1f} us, "
              f"{ens['profile']['idle']:.1%} idle, phase 13 "
              f"{ens['wall_s']:.1f} s; widths: train steps/s "
              f"{widths['train_rates']}, phase 14 {widths['wall_s']:.1f} s; "
              f"chip_smoke wall "
              f"{time.perf_counter() - t_start:.1f} s [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
