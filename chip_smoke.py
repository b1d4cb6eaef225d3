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
   ``PTXAS_KERNELS``; the fused decode at every padded shape and the loo
   widths' own instantiation, that one without a spill; the fused
   encoder at every padded hidden width (16, 32, 48, 64) without a spill;
   ``cuobjdump -sass`` of every library: the bf16
   forward, dq and dkv must contain HMMA (the tensor cores), the bf16 dq
   more than the 16 of layer 2 alone, and no float32 kernel may;
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
   the float32 kernel on the same values and its bound; the fused decode
   (``kernels/decode_rollout.py``) at 1,048,576 x 1 and 16,384 x 20 rows
   against the plain bf16 loop (max and mean bounds, a float32 control
   that misses the mean bound), timed beside the loop and its bound; the
   fused encoder (``kernels/encode_observation.py``) at 1,048,576 and
   16,384 rows of 8 steps against the plain bf16 encode likewise
   (``chip_smoke.py --encode`` runs its build check and these cases
   alone); (b) ``cli train --recipe loo --bf16`` (first step card vs CPU, a
   profiled step,
   launches equal to the float32 run's counts, float32 state); (c)
   ``evaluate --bf16`` and ``predict --bf16`` of phase 7's checkpoint, ADE/
   FDE against its float32 evaluate, the K = 20 rollout card vs CPU and
   its rate; (d) ``cli simulate --bf16`` at 32,768 and 1,048,576 agents,
   trajectories card vs CPU at 10,000, a profiled 1M window; (e) ``cli
   train --recipe loo --bf16 --grad-accum 4 --remat-steps
   --max-scene-size 16`` at batch 16,384 on a crowd npz of scenes of 16.
   Every bf16 run launches no float32 kernel, and the fused decode and
   the fused encoder launch once a simulated window, evaluated or
   predicted chunk and K-draw rollout each, none in float32; (f) Social GAN's pool kernel
   (``kernels/social_pool.py``) at the sgan-crowd-sim cell's crowd
   (1,048,576 agents in scenes of 2-64, w = 64) and at N = 10,000 against
   the plain bf16 scene-window form (max and mean bounds, a float32
   kernel control that misses the mean bound), timed beside the plain
   form and its bound, and its launches from a reset on ``--model sgan``
   ``simulate --bf16`` (one a window), ``evaluate`` and ``predict
   --bf16`` (one a chunk), with no attention kernel or fused decode
   (``chip_smoke.py --sgan`` runs (f) alone);
13. the ensemble (``engine/ensemble.py``, the kernels' member axis): (a)
   each kernel's member launch at M = 4 on the loo training chunk's ids,
   float32 and bf16 (forward with and without stats, dq, dkv with and
   without dx_j), each member bit for bit equal to a launch of its
   operands alone (M = 1), held against the member plain versions at
   phase 4's and phase 12's bounds and timed beside 4 solo launches and
   the member launch's bound; the float32 forward at N = 10,000, w = 16 likewise; (b)
   ``EnsembleTrainer`` on the loo recipe at full width, 4 seeds: the
   first member-batched step against 4 solo steps (``hold_member_step``:
   losses rel 1e-4, every state leaf 1e-3 of its scale but the G
   parameters whose gradient is rounding noise, counted), one epoch and ``evaluate`` against solo runs
   (rel 2e-4), launches forward = steps + eval chunks and dkv = steps, as
   a solo run's, every one a member launch, dq 0; (c) member-steps/s at M
   = 1, 4, 8 against solo train steps/s, alternated, and one profiled
   step at M = 4; (d) the robust1 base on the big toy set, 3 seeds x 2
   epochs: each member's coverage equals its solo run's;
14. every width JAX runs (the kernels took H and F in multiples of 16 up
   to 128): (a) at H = F = 64, 24, 100, 256, 512, 640 and 1024 on the
   first loo training chunk (generators of that width, their encoder
   states), the forward with stats, dq and dkv in float32 (phase 4's
   checks, dx held on the kernels' own inputs) and bf16 (phase 12's), and
   at M = 4 for 24, 256 and 640 (phase 13's), each timed, the kernel
   launch counters going up in each; (b) ``cli train --recipe loo
   --hidden-size`` 256, 24 and 640 for an epoch: the first step on the
   card against the CPU, launches exact;
15. JAX's loop flags: ``cli train --recipe loo --fused-epochs --block-size
   2 --epochs 4 --test-interval 2 --save-interval 2 --pallas --host-loop
   --latent-dim 10`` on phase 7's npz (launches exact, one print and one
   metrics row a block, a checkpoint and an eval at each block's end) and
   ``cli simulate --pallas`` at 10,000 agents (8 launches exactly);
16. the ensemble on every configuration (``gan_step(..., members=True)``
   with the fields it once refused), seeds 1-4 at M = 4 and full loo
   width: (a) one member step for each of R1, the variety loss (K = 20),
   mode seeking, the diversity hinge (ds_k 4), the serial rollout,
   ``grad_accum`` 4 (on an npz of scenes of 16, which tile its
   micro-chunks), ``remat_steps`` and bf16, each against the members' four
   solo steps under the same draws (float32 at phase 13b's bounds, bf16 at
   phase 12's first-step bounds), its forward and dkv launches exactly
   what phase 10 predicts for one solo step, every one a member launch,
   and member-steps/s beside solo steps/s in the same process over
   graphed epochs (each run's first epoch captures), alternated over two
   rounds; (b) peak
   device memory of one member step at batch 4,608 (phase 11's crowd npz)
   with ``remat_steps`` off and on, lower with it on; (c) a bf16
   ``EnsembleTrainer`` epoch and ``evaluate``, launches exact;
17. data parallelism (parallel/, ``train --mesh``): (a) ``cli train
   --recipe loo --mesh 1`` (NCCL at world size 1: NCCL takes one card a
   rank and the machine has one), graphed (every DP step a replay, its
   all-reduces captured), for 2 epochs equal bit for bit to ``--mesh 1
   --host-loop`` and to the graphed run without ``--mesh``, checkpoints
   and launches; a profiled replayed ``--mesh 1`` epoch whose kernels
   agree with the credited counters (up to three epochs traced where the
   trace loses records; and the NCCL kernels it names), and
   train steps/s of the three in alternated processes; on 2 gloo ranks
   sharing the card: (b) a gloo mesh with ``epoch_on_device`` refused,
   then eagerly a full-width loo DP step on a group of 2 chunks against the
   single-process step on the concatenated group (losses rel 1e-5, the
   state by ``hold_step``), an epoch (one forward and one dkv launch a
   group step on each rank) and the DP ``evaluate`` against the
   single-process one (rel 1e-4); (c) ``crowd_simulate_sharded`` (gather)
   at 4,096 agents in scenes of 16, 2 windows, against ``crowd_simulate``
   on the card (atol 1e-4), timed (the ring form is held on the CPU only:
   gloo aborts on CUDA point to point); (d) ``EnsembleTrainer(mesh=)``, 2
   ranks x 2 members, graphed against eager bit for bit and against the
   4-member ensemble in one process (rel 2e-4), member-steps/s of both;
   (e) with 2 cards, 2 NCCL ranks graphed against eager bit for bit (with
   one, a line saying it did not run);
18. JAX's epoch on the device (engine/graphed.py: every training step a
   replay of a captured CUDA graph): (a) a forward and a dkv launch
   captured alone and replayed bit for bit against eager launches, before
   and after their inputs change in place; then ``cli train`` graphed
   against ``--host-loop``, every checkpoint leaf, metrics row and launch
   counter bit for bit, for the loo recipe (and a second eager run), under
   ``--bf16``, with every schedule moving, ``--fused-epochs``, and the
   toy-flagship recipe with a coverage rescue resetting D, then resumed;
   (f) an ``EnsembleTrainer`` epoch from members at different counts; (g)
   a profiled replayed epoch whose kernel names agree with the credited
   launch counters (up to three traced, as in 17a), and a graphed step's
   ops and idle share; (h) train steps/s and member-steps/s graphed
   against eager in alternated processes;
19. JAX's serving command lines and library surface: (a) a loo-width
   generator (``SERVE_FLAGS``: ``--recipe loo`` with the LSTM decoder,
   gaussian noise and 3 categorical codes, its raw G jittered off the
   EMA) saved with ``__config__`` and without; ``cli evaluate`` and ``cli
   predict`` of both with those flags on phase 5's npz, equal printouts
   and predict npz bit for bit, one forward launch a chunk; ``predict`` of
   the configless file on the card against ``--cpu`` under one CPU noise
   stream (rtol 1e-4 / atol 1e-5); (b) ``cli simulate`` of both at 10,000
   agents x 1 window, trajectories bit for bit, 2 launches a run; (c)
   ``kernels.social_attention_fused`` at the loo training chunk and
   ``social_attention_chunked`` at N = 10,000 in scenes of 16, forward and
   every gradient against autograd through their plain forms (phase 4's
   and phase 11's bounds), one forward, dq and dkv launch each, timed; (d)
   ``jitter_generator`` on the card against the CPU, sigma 0 the identity,
   the EMA and optimizers untouched;
20. a ``kernels`` JSON line, then the device JSON as the last line.
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
    dh_j (H), the dW2 outer product (2048), db2 (64), A_j (64) and
    dW1/db1 (128), and per column dwh_j (N 64 F) and dW3, db3 (N 64 F +
    N F).  Neither computes u or c: both read the forward's.  Bytes: x4,
    ids, h, wh, g, stats, r, u, c and the MLP weights read once, the
    outputs written once; h, wh and the weights ``op_bytes`` an element.
    With bf16 operands the products the bf16 kernels take on the tensor
    cores are costed at the bf16 tensor-core peak: the recomputed 3->32
    and 32->64 layers (2144 MAC a pair, bf16 x bf16) once, and each
    product of a float32 cotangent, which enters as three exact bf16
    pieces, three times (dq: 64->32; dkv: 64->32, dW2, db2, dW1/db1);
    every other product (with u, g or h_j's float cotangent sums) at the
    FP32 peak.  ``members`` as in ``attention_bound``: x4 and ids once,
    the rest M times."""
    pairs = _pairs(ids)
    layers = 96 + 2048
    if kernel == "dq":
        split, fma = 2048, 64 + hdim + 64 + 96
    else:
        split, fma = 2048 + 2048 + 64 + 128, 64 + hdim + 64 + hdim + 64
    if op_bytes == 2:
        tc_mac = members * pairs * (layers + 3 * split)
        mac = members * pairs * fma
    else:
        tc_mac = 0
        mac = members * pairs * (layers + split + fma)
    in_bytes = 4 * (4 * n + n) + members * (
        4 * (n * hdim + 3 * n + 65 * n)
        + op_bytes * (n * hdim + n * feat + n_mlp))
    if kernel == "dq":
        out_bytes = members * 4 * 4 * n
    else:
        mac += members * (2 * n * 64 * feat + n * feat)
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
            entry = _entry_name(m.group(1), wide)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), *spills)
            entry, spills = None, (0, 0)
    return out


def _entry_name(mangled: str, wide: bool) -> str:
    """"kernel[float|bf16(,wide)]" of a mangled kernel name."""
    name = next((k for k in PTXAS_KERNELS if k in mangled), None)
    if name is None:
        raise AssertionError(f"unknown kernel {mangled}")
    typ = "bf16" if f"{name}I13__nv_bfloat16" in mangled else "float"
    return f"{name}[{typ}{',wide' if wide else ''}]"


def sass_hmma(sass: str, wide: bool = False) -> dict:
    """{"kernel[float|bf16(,wide)]": HMMA instructions} of every kernel in
    a library's ``cuobjdump -sass`` listing."""
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:       # a kernel, or a device function it calls (not counted)
            entry = (_entry_name(m.group(1), wide) if any(
                k in m.group(1) for k in PTXAS_KERNELS) else None)
            if entry is not None:
                out[entry] = 0
        elif entry is not None and "HMMA" in line:
            out[entry] += 1
    return out


#: the bf16 kernels whose pair MLP runs on the tensor cores
HMMA_KERNELS = ("social_attention_fwd_kernel", "bwd_dkv_kernel",
                "bwd_dq_kernel")
#: the HMMA that the shared layer-2 + score routine gives a kernel (16
#: products): the bf16 dq's own products (da1 = dz2 W2^T) must add to them
LAYER2_HMMA = 16

#: the bf16 dq's times before its warp-owned tensor-core design, us, by
#: (members, N, window, H = F), printed beside this run's: PERF.md section
#: 6, row 5 and its widths (kernel_times.py, bf16_times.py; NVIDIA H100
#: 80GB HBM3, 700 W)
EARLIER_BF16_DQ_US = {
    (1, 256, 0, 64): 10.08, (1, 10_000, 16, 64): 102.33,
    (4, 256, 0, 64): 13.64, (1, 256, 0, 24): 32.80, (1, 256, 0, 100): 34.77,
    (1, 256, 0, 256): 15.21, (1, 256, 0, 512): 21.65,
    (1, 256, 0, 640): 24.97, (1, 256, 0, 1024): 35.29}


def earlier_dq(members, n, w, hdim, sep: str = ", ") -> str:
    """``sep`` + "the earlier ... dq X us" for a bf16 dq case of
    ``EARLIER_BF16_DQ_US``, else ""."""
    us = EARLIER_BF16_DQ_US.get((members, n, w, hdim))
    return "" if us is None else (f"{sep}the earlier block-wide FFMA dq "
                                  f"{us:.2f} us (PERF.md row 5)")


def check_sass(_build) -> dict:
    """Phase 2's SASS check: ``cuobjdump -sass`` of every library; the bf16
    libraries' ``HMMA_KERNELS`` contain HMMA, no float32 kernel does, and
    the bf16 dq (narrow and wide) more than ``LAYER2_HMMA``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for name in KERNELS:
        sass = subprocess.run([tool, "-sass", _build._target(name)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts.update(sass_hmma(sass, wide="_wide" in name))
    for entry, k in sorted(counts.items()):
        print(f"sass: {entry} {k} HMMA")
    bad = [e for e, k in counts.items()
           if ("[float" in e and k) or ("[bf16" in e and not k
                                         and e.split("[")[0] in HMMA_KERNELS)]
    bad += [e for e in ("bwd_dq_kernel[bf16]", "bwd_dq_kernel[bf16,wide]")
            if counts.get(e, 0) <= LAYER2_HMMA]
    if bad or len(counts) != 4 * len(PTXAS_KERNELS):
        raise AssertionError(f"sass: HMMA where it does not belong or "
                             f"missing where it does (the bf16 dq above "
                             f"{LAYER2_HMMA}): {bad}; {counts}")
    return counts


#: the fused decode's library (kernels/decode_rollout.py) and its
#: instantiation for the crowd and loo widths (64, 64, 32): the (4, 2)
#: padded shape with the widths known at compile time
DECODE_LIB, DECODE_CROWD_SHAPE = "decode_rollout_bf16", (4, 2, True)


def _entry_ptxas(log: str, entry: str, key) -> dict:
    """{key(match): (registers, spill store bytes, spill load bytes)} of
    the entry functions whose mangled name matches the regex ``entry``,
    from nvcc's ``-Xptxas -v`` output."""
    out, found, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '[^']*" + entry, line)
        if m:
            found = key(m)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and found is not None:
            out[found] = (int(m.group(1)), *spills)
            found, spills = None, (0, 0)
    return out


def decode_ptxas(log: str) -> dict:
    """{(T, ZT, exact): (registers, spill store bytes, spill load bytes)}
    of the fused decode's instantiations."""
    return _entry_ptxas(
        log, r"decode_rollout_kernelILi(\d+)ELi(\d+)ELb([01])E",
        lambda m: (int(m.group(1)), int(m.group(2)), m.group(3) == "1"))


#: the fused encoder's library (kernels/encode_observation.py) and its
#: instantiations, one a padded hidden width of 16 HT columns
ENCODE_LIB, ENCODE_TILES = "encode_observation_bf16", (1, 2, 3, 4)


def encode_ptxas(log: str) -> dict:
    """{HT: (registers, spill store bytes, spill load bytes)} of the fused
    encoder's instantiations."""
    return _entry_ptxas(log, r"encode_observation_kernelILi(\d+)E",
                        lambda m: int(m.group(1)))


def check_encode_build(_build) -> dict:
    """The fused encoder's ptxas lines, printed; fails unless every padded
    width is built without a spill."""
    enc = encode_ptxas(_build.build_logs.get(ENCODE_LIB, ""))
    for ht, (regs, st, ld) in sorted(enc.items()):
        print(f"ptxas: encode_observation_kernel<{ht}> {regs} registers, "
              f"spill stores/loads {st}/{ld} bytes")
    if sorted(enc) != list(ENCODE_TILES) or any(
            sum(v[1:]) for v in enc.values()):
        raise AssertionError(f"ptxas: want the fused encoder at "
                             f"{ENCODE_TILES} without spills, got {enc}")
    return enc


def build_kernels(_build) -> None:
    """Phase 2: build every kernel (one nvcc a source, in parallel), print
    ptxas's lines, and fail if a kernel spills or a narrow float32
    kernel's registers move more than 2 from ``PTXAS_KERNELS`` (the wide
    kernels, H or F above 128, have no earlier build to hold them to);
    the fused decode's every padded shape built, the crowd's without a
    spill; the fused encoder's every width without a spill
    (``check_encode_build``); then the SASS check (``check_sass``)."""
    from socialways_torch.kernels.decode_rollout import SHAPES
    tic = time.perf_counter()
    _build.build(KERNELS + [DECODE_LIB, ENCODE_LIB])
    print(f"build: {', '.join(KERNELS + [DECODE_LIB, ENCODE_LIB])} in "
          f"{time.perf_counter() - tic:.2f} s (parallel nvcc)")
    dec = decode_ptxas(_build.build_logs.get(DECODE_LIB, ""))
    for shape, (regs, st, ld) in sorted(dec.items()):
        print(f"ptxas: decode_rollout_kernel{list(shape)} {regs} registers, "
              f"spill stores/loads {st}/{ld} bytes")
    want = sorted([(t, zt, False) for t, zt in SHAPES] + [DECODE_CROWD_SHAPE])
    if sorted(dec) != want or sum(dec[DECODE_CROWD_SHAPE][1:]):
        raise AssertionError(f"ptxas: want the fused decode at {want}, "
                             f"{DECODE_CROWD_SHAPE} without spills, got "
                             f"{dec}")
    check_encode_build(_build)
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
    check_sass(_build)


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
    dev_events = [e for e in prof.events() if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)]
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
    """Every kernel's counts to 0: the float32 and the bf16 entries', their
    member launches and the fused decode's launches (``launch_counts``)."""
    for fn, counter in sa.launch_counts():
        setattr(fn, counter, 0)


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


def hold_step(what, f_got, f_ref, m_got, m_ref, tcfg) -> dict:
    """One ``gan_step`` computed twice from one fresh state under the same
    draws (on the card and the CPU, or as an ensemble member and solo),
    the sums taken in other orders: ``f_*`` the flattened new states,
    ``m_*`` the (d_loss, g_loss, ade_sum, fde_sum) floats.  Losses and
    ADE/FDE sums within rel 1e-4, gradients (Adam's first moments) within
    1e-3 of their scale, new parameters within 1e-2 lr plus, for G, what
    that gradient bound allows Adam's first update.  Under
    ``compute_dtype="bfloat16"`` the two round to bf16 after sums taken in
    other orders, and a flipped rounding travels through the rollout:
    losses and sums within rel 1e-2, gradients within 5e-2 of their scale,
    every state tensor float32 on both; the new parameters are not
    compared (where |g| is under that noise, the sign of Adam's first
    update, +-lr, may differ).  Counts equal.  Returns the worst ratios."""
    bf16 = tcfg.compute_dtype == "bfloat16"
    rel, g_rel = (1e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    for nm, a, b in zip(("d_loss", "g_loss", "ade_sum", "fde_sum"), m_got,
                        m_ref):
        if not np.isfinite(a) or abs(a - b) > rel * abs(b):
            raise AssertionError(f"{what} {nm}: {a} vs {b}")
    # gradients: Adam's first moment after one G update is 0.1 g_G, after
    # the D updates a weighted sum of D's gradients -- compared leaf by leaf
    # at max|err| <= g_rel max|ref| + 1e-9 (sums over the rows through the
    # rollout and the attention, in another order)
    if sorted(f_got) != sorted(f_ref):
        raise AssertionError(f"{what}: the two states' leaves differ")
    not_f32 = [k for f in (f_got, f_ref) for k, v in f.items()
               if not k.endswith(".count") and v.dtype != np.float32]
    if not_f32:
        raise AssertionError(f"{what}: state leaves not float32: {not_f32}")
    worst_g, worst_p, loose = (0.0, ""), {"G": 0.0, "D": 0.0}, [0, 0]
    for key, ref in f_ref.items():
        got = f_got[key]
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
            # lr eps d / (|g| - d + eps)^2 (at most 2 lr) between the two
            (mu_key,) = [k for k in f_ref if k.startswith(".g_opt/")
                         and k.endswith("/.mu/" + key[len(".g_params/"):])]
            mu = f_ref[mu_key].astype(np.float64)
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
    # both start from one state, so the new D parameters differ by the
    # difference of their updates, each about +-lr: held at 1e-2 lr
    if worst_p["D"] > 1e-2 * tcfg.lr_d:
        raise AssertionError(f"{what}: new D params differ by "
                             f"{worst_p['D']:.3e} > 1e-2 lr ({tcfg.lr_d:g})")
    return {"gradient": worst_g, "params": worst_p, "loose": loose,
            "rel": rel, "g_rel": g_rel}


def first_step_cuda_vs_cpu(torch, trainer, state, dev, what: str) -> None:
    """One ``gan_step`` of ``trainer``'s first training chunk on the card
    and on the CPU, from copies of ``state`` (a fresh one) under the same
    draws, held by ``hold_step``."""
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
    got = hold_step(what, flatten_state(s_dev), flatten_state(s_cpu),
                    [float(v) for v in m_dev[:4]],
                    [float(v) for v in m_cpu[:4]], tcfg)
    worst_g, worst_p, loose = got["gradient"], got["params"], got["loose"]
    if tcfg.compute_dtype == "bfloat16":
        print(f"{what} cuda vs cpu (bf16): losses and ADE/FDE sums within "
              f"rel {got['rel']:g} (d_loss {float(m_dev.d_loss):.6f}/"
              f"{float(m_cpu.d_loss):.6f}, g_loss {float(m_dev.g_loss):.6f}/"
              f"{float(m_cpu.g_loss):.6f}, ade_sum {float(m_dev.ade_sum):.4f}"
              f"/{float(m_cpu.ade_sum):.4f}); gradients (Adam first "
              f"moments) at most {worst_g[0]:.3f} of their bound "
              f"{got['g_rel']:g} max|ref| (at {worst_g[1]}); every state "
              f"tensor float32 on both devices; counts equal")
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
    (trace,) = [f for f in os.listdir(prof) if f != "spans.json"]
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
                      f"{summary[key][1]:.3e}"
                      + (earlier_dq(1, n, w, hdim) if key == "dq" else "")
                      + f" [{card}]")
    print(f"bf16 kernels [{tag}] N={n}: " + ", ".join(
        f"{k} max/median abs err {v[0]:.3e}/{v[1]:.3e}"
        for k, v in summary.items())
        + (f"; w={w} bits == w=0 bits" if w else ""))
    return entries, summary


#: phase 12's fused decode cases, (prepared rows, draws): a crowd-sim
#: window and a large forecast request; held to the card test's bounds
#: (tests/test_torch_decode_rollout_cuda.py): every output within
#: DECODE_ATOL + DECODE_RTOL |plain| of the plain bf16 loop and the mean
#: gap within DECODE_MEAN_GAP
DECODE_CASES = ((CROWD_1M, 1), (16_384, K))
DECODE_ATOL, DECODE_RTOL, DECODE_MEAN_GAP = 0.05, 0.02, 1e-5


def fused_launches(what: str, want: int) -> tuple:
    """(decode, encoder): the fused decode's and the fused encoder's
    launches since the last ``reset_launches`` as read, each held to
    ``want`` (one a bf16 window, chunk or K-draw rollout)."""
    from socialways_torch.kernels.decode_rollout import decode_rollout_bf16
    from socialways_torch.kernels.encode_observation import (
        encode_observation_bf16)
    got = (decode_rollout_bf16.launches, encode_observation_bf16.launches)
    if got != (want, want):
        raise AssertionError(f"{what}: the fused decode and encoder "
                             f"launched {got} times, want {want} each")
    return got


def decode_kernel_case(torch, dev, n, r, card) -> dict:
    """Phase 12a': the fused decode of ``r`` draws of ``n`` prepared rows
    at the loo widths against the plain bf16 loop on the same operands
    (grad on, nothing requiring it), one launch; the float32 plain loop on
    the same values as a control that must miss the mean bound; each
    timed alone beside the decode's bound (its products at the bf16
    tensor-core peak against its bytes)."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.kernels.decode_rollout import decode_rollout_bf16
    from socialways_torch.models.generator import (decode_rollout,
                                                   init_generator)
    from socialways_torch.ops.nn import cast_params
    bf, hd, z = torch.bfloat16, HIDDEN, HIDDEN // 2
    cfg = TrainConfig(hidden_size=hd, social_feature_size=hd, noise_len=z)
    g16 = cast_params(init_generator(cfg, torch.Generator().manual_seed(
        n + r), dev).requires_grad_(False), bf)
    g32 = cast_params(g16, torch.float32)
    rng = np.random.RandomState(n + r)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, bf)
    obsv = t(rng.rand(n, N_PAST, 2) * 4 - 2)
    prep = (t(np.tanh(rng.randn(n, hd))), t(rng.randn(n, hd) * 0.7),
            t(rng.randn(n, hd) * 0.5), obsv[:, -1])
    noise = t(rng.rand(r * n, z))

    def fused():
        with torch.no_grad():
            return decode_rollout(g16, prep, noise, N_NEXT)

    def plain():
        with torch.enable_grad():
            return decode_rollout(g16, prep, noise, N_NEXT)
    before = decode_rollout_bf16.launches
    got = fused()
    launched = decode_rollout_bf16.launches - before
    if launched != 1:
        raise AssertionError(f"decode {n}x{r}: {launched} launches, want 1")
    want = plain().float()
    with torch.no_grad():
        ctrl = decode_rollout(g32, tuple(a.float() for a in prep),
                              noise.float(), N_NEXT)
    gap = (got.float() - want).abs()
    mx, mean = float(gap.max()), float(gap.mean())
    ctrl_mean = float((ctrl - want).abs().mean())
    if (got.shape != (r * n, N_NEXT, 4) or not bool(got.isfinite().all())
            or not bool((gap <= DECODE_ATOL + DECODE_RTOL
                         * want.abs()).all())
            or mean > DECODE_MEAN_GAP):
        raise AssertionError(f"decode {n}x{r}: fused vs plain bf16 max abs "
                             f"{mx:.3e}, mean {mean:.3e} (bounds "
                             f"{DECODE_ATOL} + {DECODE_RTOL} |plain|, "
                             f"{DECODE_MEAN_GAP})")
    if ctrl_mean <= DECODE_MEAN_GAP:
        raise AssertionError(f"decode {n}x{r}: the float32 loop on the same "
                             f"values passes the mean bound ({ctrl_mean:.3e})")
    d = 2 * hd + z
    macs = (d * d + d * (d // 2) + (d // 2) * (d // 4) + (d // 4) * 2
            + 4 * hd + 2 * hd * 4 * hd)            # a row-step; the weights
    b = _bound(0.0, 2 * (n * (3 * hd + 2) + r * n * (z + N_NEXT * 4)
                         + macs), tc_flop=2 * r * n * N_NEXT * macs)
    entry = {"n": n, "r": r, "ms": median_ms(torch, fused),
             "plain_ms": median_ms(torch, plain, repeats=3),
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "max_abs_err": mx, "mean_abs_err": mean,
             "control_mean_abs_err": ctrl_mean}
    print(f"bf16 fused decode {n} rows x {r} draws x {N_NEXT} steps: "
          f"{entry['ms']:.3f} ms, plain bf16 loop {entry['plain_ms']:.2f} "
          f"ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']}); vs plain max "
          f"/ mean abs {mx:.3e} / {mean:.3e} (bounds {DECODE_ATOL} + "
          f"{DECODE_RTOL} |plain|, {DECODE_MEAN_GAP}), float32 control mean "
          f"{ctrl_mean:.3e} [{card}]")
    return entry


#: phase 12a's fused encoder cases, rows of N_PAST steps at hidden 64: a
#: crowd-sim window and a large forecast request; held to the card test's
#: bounds (tests/test_torch_encode_observation_cuda.py): h and c within
#: ENCODE_ATOL + ENCODE_RTOL |plain| of the plain bf16 encode and the
#: mean gap within ENCODE_MEAN_GAP
ENCODE_CASES = (CROWD_1M, 16_384)
ENCODE_ATOL, ENCODE_RTOL, ENCODE_MEAN_GAP = 0.02, 0.02, 1.5e-6


def encode_operands(torch, dev, n, seed, steps=N_PAST):
    """A bf16 generator of hidden HIDDEN drawn from ``seed`` (nothing
    requiring grad) and obsv_4d [n, steps, 4] bf16 of ``n`` random walks in
    a canonical frame, on ``dev``: the fused encoder's operands here and
    in kernel_times.py."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.models.generator import init_generator
    from socialways_torch.ops.nn import cast_params
    from socialways_torch.ops.traj import obsv_to_4d
    cfg = TrainConfig(hidden_size=HIDDEN, social_feature_size=HIDDEN,
                      noise_len=HIDDEN // 2)
    g16 = cast_params(init_generator(cfg, torch.Generator().manual_seed(
        seed), dev).requires_grad_(False), torch.bfloat16)
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randn(n, steps, 2) * 0.1, axis=1)
    p = rng.rand(n, 1, 2) * 4 - 2 + walk - walk[:, -1:]
    x = obsv_to_4d(torch.from_numpy(p.astype(np.float32)).to(
        dev, torch.bfloat16))
    return g16, x


def encode_bound(n, steps=N_PAST) -> dict:
    """The fused encoder's bound at hidden HIDDEN: its products (the
    embedding and the LSTM's [e | h] W, a row-step) at the bf16
    tensor-core peak against its bytes (x, the final h and c, the
    weights)."""
    hd = HIDDEN
    macs = 4 * hd + 2 * hd * 4 * hd                # a row-step; the weights
    return _bound(0.0, 2 * (n * steps * 4 + 2 * n * hd + macs),
                  tc_flop=2 * n * steps * macs)


def encode_kernel_case(torch, dev, n, card) -> dict:
    """Phase 12a: the fused encoder on ``n`` random walks of N_PAST steps
    at hidden 64 against the plain bf16 encode on the same operands (grad
    on, nothing requiring it), one launch; the float32 plain encode on the
    same values as a control that must miss the mean bound; each timed
    alone beside the encoder's bound (``encode_bound``)."""
    from socialways_torch.kernels.encode_observation import (
        encode_observation_bf16)
    from socialways_torch.models.generator import encode_observation
    from socialways_torch.ops.nn import cast_params
    hd = HIDDEN
    g16, x = encode_operands(torch, dev, n, n)
    g32 = cast_params(g16, torch.float32)

    def fused():
        with torch.no_grad():
            return encode_observation(g16, x)

    def plain():
        with torch.enable_grad():
            return encode_observation(g16, x)
    before = encode_observation_bf16.launches
    got = fused()
    if encode_observation_bf16.launches - before != 1:
        raise AssertionError(f"encode {n}: the fused encoder was not "
                             f"launched once")
    want = plain()
    with torch.no_grad():
        ctrl = encode_observation(g32, x.float())
    mx = mean = ctrl_mean = 0.0
    for a, b, cf in zip(got, want, ctrl):
        gap = (a.float() - b.float()).abs()
        if (a.shape != (n, hd) or not bool(a.isfinite().all())
                or not bool((gap <= ENCODE_ATOL + ENCODE_RTOL
                             * b.float().abs()).all())):
            raise AssertionError(f"encode {n}: fused vs plain bf16 max abs "
                                 f"{float(gap.max()):.3e} (bound "
                                 f"{ENCODE_ATOL} + {ENCODE_RTOL} |plain|)")
        mx, mean = max(mx, float(gap.max())), max(mean, float(gap.mean()))
        ctrl_mean = max(ctrl_mean, float((cf - b.float()).abs().mean()))
    if mean > ENCODE_MEAN_GAP:
        raise AssertionError(f"encode {n}: fused vs plain bf16 mean abs "
                             f"{mean:.3e} (bound {ENCODE_MEAN_GAP})")
    if ctrl_mean <= ENCODE_MEAN_GAP:
        raise AssertionError(f"encode {n}: the float32 encode on the same "
                             f"values passes the mean bound ({ctrl_mean:.3e})")
    b = encode_bound(n)
    entry = {"n": n, "steps": N_PAST, "ms": median_ms(torch, fused),
             "plain_ms": median_ms(torch, plain, repeats=3),
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "max_abs_err": mx, "mean_abs_err": mean,
             "control_mean_abs_err": ctrl_mean}
    print(f"bf16 fused encoder {n} rows x {N_PAST} steps: {entry['ms']:.3f} "
          f"ms, plain bf16 encode {entry['plain_ms']:.2f} ms, bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']}, "
          f"{100 * b['bound_ms'] / entry['ms']:.1f} % of it); vs plain max / "
          f"mean abs {mx:.3e} / {mean:.3e} (bounds {ENCODE_ATOL} + "
          f"{ENCODE_RTOL} |plain|, {ENCODE_MEAN_GAP}), float32 control mean "
          f"{ctrl_mean:.3e} [{card}]")
    return entry


#: phase 12a'': Social GAN's pool kernel (kernels/social_pool.py) at the
#: sgan-crowd-sim cell's crowd (1,048,576 agents in sorted scenes of 2-64,
#: scene window 64) and at N = 10,000 (scenes of 1-64), each (n, smallest
#: scene, w); the plain scene-window form takes row blocks of
#: POOL_PLAIN_BLOCK.  The bounds are the card test's
#: (tests/test_torch_sgan_cuda.py ATOL and MEAN_GAP for bf16): every output
#: within POOL_ATOL of the plain bf16 form, the mean gap within
#: POOL_MEAN_GAP
POOL_CASES = ((CROWD_1M, 2, 64), (CROWD_N, 1, 64))
POOL_PLAIN_BLOCK = 512
POOL_ATOL, POOL_MEAN_GAP = 2e-3, 2e-5
SGAN_WIDTHS = dict(model="sgan", noise_len=8, noise_dist="gaussian")


def pool_launches(what: str, want: int) -> int:
    """The bf16 pool kernel's launches since the last ``reset_launches``,
    held to ``want`` (one a bf16 pooling), the float32 entry's to 0."""
    from socialways_torch.kernels.social_pool import social_pool_fused
    got = (social_pool_fused.launches_bf16, social_pool_fused.launches)
    if got != (want, 0):
        raise AssertionError(f"{what}: the pool kernel launched {got} (bf16, "
                             f"float32) times, want ({want}, 0)")
    return want


def pool_kernel_case(torch, dev, n, smallest, w, card) -> dict:
    """Phase 12a'': the pool kernel on ``n`` agents in sorted scenes of
    ``smallest``-64 (h from the bf16 encoder on random walks) against the
    plain bf16 scene-window form on the same operands, one launch; the
    float32 kernel on the same values as a control that must miss the mean
    bound; the kernel timed alone and the plain form once, beside the
    pool's bound (``perfbench/sgan_counts.pool_bound``)."""
    from perfbench.sgan_counts import pool_bound
    from socialways_torch.config import TrainConfig
    from socialways_torch.kernels.social_pool import social_pool_fused
    from socialways_torch.models.sgan import encode, init_sgan
    from socialways_torch.ops.nn import cast_params
    from socialways_torch.ops.sgan_pool import social_pool_windowed
    cfg = TrainConfig(**SGAN_WIDTHS, max_scene_size=w,
                      compute_dtype="bfloat16")
    g16 = cast_params(init_sgan(cfg, torch.Generator().manual_seed(n),
                                dev).requires_grad_(False), torch.bfloat16)
    g32 = cast_params(g16, torch.float32)
    rng = np.random.default_rng(n)
    sizes = rng.integers(smallest, 65, size=n // smallest + 1)
    ids_np = np.repeat(np.arange(len(sizes)), sizes)[:n].astype(np.int32)
    walk = np.cumsum(rng.standard_normal((n, N_PAST, 2)) * 0.05, axis=1)
    obsv = torch.from_numpy((rng.random((n, 1, 2)) * 4 - 2 + walk).astype(
        np.float32)).to(dev, torch.bfloat16)
    ids = torch.from_numpy(ids_np).to(dev)
    with torch.no_grad():
        h = encode(g16, obsv)
    pos = obsv[:, -1].contiguous()

    def fused():
        with torch.no_grad():
            return social_pool_fused(g16.pool_embed, g16.pool_mlp, pos, h,
                                     ids, w)

    def plain():
        with torch.no_grad():
            return social_pool_windowed(g16.pool_embed, g16.pool_mlp, pos, h,
                                        ids, w, block=POOL_PLAIN_BLOCK)
    before = social_pool_fused.launches_bf16
    got = fused()
    if social_pool_fused.launches_bf16 - before != 1:
        raise AssertionError(f"pool {n}: the bf16 kernel was not launched "
                             f"once")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    with torch.no_grad():
        ctrl = social_pool_fused(g32.pool_embed, g32.pool_mlp, pos.float(),
                                 h.float(), ids, w)
    gap = (got - want).abs()
    mx, mean = float(gap.max()), float(gap.mean())
    ctrl_mean = float((ctrl - want).abs().mean())
    if (got.shape != (n, 32) or not bool(got.isfinite().all())
            or mx > POOL_ATOL or mean > POOL_MEAN_GAP):
        raise AssertionError(f"pool {n}: kernel vs plain bf16 max abs "
                             f"{mx:.3e}, mean {mean:.3e} (bounds {POOL_ATOL}, "
                             f"{POOL_MEAN_GAP})")
    if ctrl_mean <= POOL_MEAN_GAP:
        raise AssertionError(f"pool {n}: the float32 kernel on the same "
                             f"values passes the mean bound ({ctrl_mean:.3e})")
    b = pool_bound(vars(cfg), ids_np)
    entry = {"n": n, "scenes": f"{smallest}-64", "w": w, "pairs": b["pairs"],
             "ms": median_ms(torch, fused), "plain_ms": plain_ms,
             "plain_block": POOL_PLAIN_BLOCK, "bound_ms": b["bound_ms"],
             "bound_by": b["bound_by"], "max_abs_err": mx,
             "mean_abs_err": mean, "control_mean_abs_err": ctrl_mean}
    print(f"bf16 pool kernel {n} agents (scenes {smallest}-64, {b['pairs']} "
          f"pairs, w {w}): {entry['ms']:.3f} ms, plain windowed form "
          f"{plain_ms:.1f} ms (one call, blocks of {POOL_PLAIN_BLOCK}), bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']}); vs plain max / mean abs "
          f"{mx:.3e} / {mean:.3e} (bounds {POOL_ATOL}, {POOL_MEAN_GAP}), "
          f"float32 kernel control mean {ctrl_mean:.3e} [{card}]")
    return entry


def sgan_phase(torch, sa, cli_main, dev, npz, work, card) -> dict:
    """Phase 12f, Social GAN's pool kernel: ``POOL_CASES``, then its
    launches after ``reset_launches`` on each bf16 serving path of
    ``--model sgan``: ``cli simulate`` at 1,048,576 agents in scenes of 64
    (one a window, 2 calls of 4 windows), ``evaluate`` and ``predict`` of
    a saved Social GAN checkpoint on phase 5's npz (one a chunk), with no
    attention kernel and no fused decode launched."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import greedy_chunks, load_npz_dataset
    from socialways_torch.io.checkpoint import save_generator_checkpoint
    from socialways_torch.kernels import social_pool  # noqa: F401 registers
    from socialways_torch.models.sgan import init_sgan
    cases = [pool_kernel_case(torch, dev, n, smallest, w, card)
             for n, smallest, w in POOL_CASES]
    launches = {}

    def others(what):
        f32, b16 = read_launches(sa), read_launches(sa, bf16=True)
        if any(f32.values()) or any(b16.values()):
            raise AssertionError(f"{what}: attention kernels launched "
                                 f"{f32} {b16}")
        fused_launches(what, 0)
    reset_launches(sa)
    out = run_cli(cli_main, ["simulate", "--model", "sgan", "--agents",
                             str(CROWD_1M), "--scene-size", "64", "--bf16"],
                  f"simulate --model sgan --bf16 {CROWD_1M} agents", card)
    if "route=cuda kernel" not in out:
        raise AssertionError(f"simulate --model sgan: printed {out!r}")
    launches["simulate"] = pool_launches("simulate --model sgan", 8)
    others("simulate --model sgan")
    ds = load_npz_dataset(npz)
    test_chunks = len(greedy_chunks(ds.test_batches, BATCH))
    with np.load(npz) as d:
        all_chunks = len(greedy_chunks(d["batches"], BATCH))
    cfg = TrainConfig(**SGAN_WIDTHS)
    ckpt = os.path.join(work, "sgan-init.npz")
    save_generator_checkpoint(ckpt, init_sgan(
        cfg, torch.Generator().manual_seed(23), "cpu"), 0, ds.scale, cfg)
    pred = os.path.join(work, "sgan_predictions.npz")
    for cmd, argv, want in (
            ("evaluate", ["evaluate", "--data", npz], test_chunks),
            ("predict", ["predict", "--data", npz, "--out", pred],
             all_chunks)):
        reset_launches(sa)
        run_cli(cli_main, argv + ["--model-file", ckpt, "--bf16"],
                f"{cmd} --bf16 (Social GAN checkpoint)", card)
        launches[cmd] = pool_launches(f"{cmd} of a Social GAN checkpoint",
                                      want)
        others(f"{cmd} of a Social GAN checkpoint")
    print(f"Social GAN pool launches by path {launches} [{card}]")
    return {"cases": cases, "launches": launches}


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
    ade, launches, fused = {}, {}, {}
    for tag, extra in (("float32", []), ("bf16", ["--bf16"])):
        reset_launches(sa)
        out = run_cli(cli_main, ["evaluate", "--data", npz, "--model-file",
                                 ckpt] + extra, f"evaluate ({tag})", card)
        got = (bf16_launches(sa, "evaluate --bf16") if extra
               else read_launches(sa))
        if got != {"fwd": test_chunks, "dq": 0, "dkv": 0}:
            raise AssertionError(f"evaluate {tag}: launched {got}")
        n_fused = fused_launches(f"evaluate ({tag})",
                                 test_chunks if extra else 0)
        if extra:
            launches["evaluate"], fused["evaluate"] = got, n_fused
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
    fused["predict"] = fused_launches("predict --bf16", all_chunks)
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
    reset_launches(sa)
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
    # a K-draw rollout and an eval_chunk a chunk on the card
    fused["k_sample"] = fused_launches(
        "bf16 serving cuda vs cpu", 2 * min(2, t_dev.test_packed.n_chunks))
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
    reset_launches(sa)
    rollouts()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(3):
        rollouts()
    torch.cuda.synchronize()
    roll_s = (time.perf_counter() - tic) / 3
    fused["rollouts"] = fused_launches("bf16 rollouts", 4 * n_chunks)
    rate = n_valid * K * N_NEXT / roll_s
    print(f"bf16 rollout: {n_valid} windows x K={K} x {N_NEXT} steps in "
          f"{roll_s * 1e3:.2f} ms = {rate:.4g} agent-steps/s [{card}]")
    return {"ade_fde": ade, "rollout_rate": rate,
            "cuda_vs_cpu_max_abs": worst, "launches": launches,
            "fused_launches": fused}


def bf16_simulate(torch, sa, cli_main, dev, ckpt, card):
    """Phase 12d: ``cli simulate --bf16`` at 32,768 and 1,048,576 agents
    (8 bf16 forwards and 8 fused decodes a run, no float32 kernel), the
    trajectories at 10,000 agents and 1 window on the card against the CPU
    under bf16 (one fused decode), and one profiled 1,048,576-agent
    window.  Returns (rates, attention launches, decode launches)."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.engine.losses import sample_noise
    from socialways_torch.engine.simulate import crowd_simulate, initial_crowd
    from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                                restore_generator)
    rates, launches, fused = {}, {"fwd": 0, "dq": 0, "dkv": 0}, {}
    for agents in (CROWD_BF16, CROWD_1M):
        reset_launches(sa)
        out = run_cli(cli_main, ["simulate", "--model-file", ckpt, "--agents",
                                 str(agents), "--bf16"],
                      f"simulate --bf16 {agents} agents", card)
        torch.cuda.synchronize()
        got = bf16_launches(sa, f"simulate --bf16 {agents}")
        if got != {"fwd": 8, "dq": 0, "dkv": 0}:
            raise AssertionError(f"simulate --bf16 {agents}: launched {got}")
        fused[f"simulate_{agents}"] = fused_launches(
            f"simulate --bf16 {agents}", 8)
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
    reset_launches(sa)
    for where in (dev, torch.device("cpu")):
        gen = restore_generator(ckpt, cfg, where)[0]
        traj.append(crowd_simulate(
            gen, torch.from_numpy(obsv0).to(where),
            torch.from_numpy(ids).to(where), 1, cfg,
            noise=noise.to(where)).cpu())
    fused["simulate_window"] = fused_launches(
        "simulate bf16 cuda vs cpu", 1)
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
    return rates, launches, fused


def bf16_phase(torch, sa, cli_main, dev, npz, ckpt, work, train_chunk,
               card):
    """Phase 12, bf16: (a) the bf16 kernels against their plain bf16
    versions at the loo training chunk, at N = 10,000 in sorted scenes of
    16 (w = 16 and w = 0, equal bits) and, forward only, at N = 32,768,
    the fused decode against the plain bf16 loop (``DECODE_CASES``) and
    the fused encoder against the plain bf16 encode (``ENCODE_CASES``);
    (b) ``cli train --recipe loo --bf16``; (c) bf16 serving; (d) ``cli
    simulate --bf16``; (e) JAX's crowd memory recipe under bf16; (f)
    Social GAN's pool kernel and its launches (``sgan_phase``)."""
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
    decode = [decode_kernel_case(torch, dev, n, r, card)
              for n, r in DECODE_CASES]
    encode = [encode_kernel_case(torch, dev, n, card) for n in ENCODE_CASES]
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
    sim_rates, launches["simulate"], sim_fused = bf16_simulate(
        torch, sa, cli_main, dev, ckpt, card)
    crowd = os.path.join(work, "crowd16-8-12.npz")
    make_ethucy_like_npz(crowd, n_windows=82_000, seed=1, scene=CROWD_SCENE)
    launches["bf16_crowd_train"], rates["bf16_crowd_train"], _ = gan_run(
        torch, sa, cli_main, dev, crowd, work, "bf16_crowd_train",
        BF16_RUNS["bf16_crowd_train"], cpu_check=False, card=card)
    sgan = sgan_phase(torch, sa, cli_main, dev, npz, work, card)
    wall = time.perf_counter() - tic_phase
    print(f"bf16 phase: {wall:.2f} s wall [{card}]")
    return {"kernels": kernels, "errs": errs, "launches": launches,
            "train_rates": rates, "serving": serving, "decode": decode,
            "encode": encode, "sgan": sgan,
            "fused_launches": {**serving["fused_launches"],
                               **sim_fused},
            "simulate_rates": sim_rates, "wall_s": wall}


#: phase 13: the ensemble's members (ROADMAP Queue 1 item 3), the member
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
              f"({b['bound_by']})"
              + (earlier_dq(m, n, max_scene, hdim) if bf16 and k == "dq"
                 else "") + f" [{card}]")
    print(f"member kernels [{tag}, {'bf16' if bf16 else 'float32'}]: every "
          f"member equals its solo launches bit for bit; max abs error "
          f"against the member plain versions {errs or 'not compared'}")
    return res, errs


#: phase 14: hidden sizes JAX runs that are not the kernels' native
#: multiples of 16 up to 128 (padded: 24, 100; looped over: 256, 512, and
#: past dkv's whole h_j stage: 640, 1024), the ones also checked at M = 4,
#: and the CLI runs at three of them
WIDTHS, WIDTH_MEMBERS = (24, 100, 256, 512, 640, 1024), (24, 256, 640)
WIDTH_RUNS = {
    "loo_h256": (["--recipe", "loo", "--hidden-size", "256"], 1, 1, (1, 1)),
    "loo_h24": (["--recipe", "loo", "--hidden-size", "24"], 1, 1, (1, 1)),
    "loo_h640": (["--recipe", "loo", "--hidden-size", "640"], 1, 1, (1, 1)),
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
        f" / {r['bf16']['dkv']['ms'] * 1e3:.2f}"
        + earlier_dq(1, 256, 0, w, sep="; ")
        + ")" for w, r in res.items()) + f" [{card}]")
    return res


def widths_phase(torch, sa, cli_main, dev, npz, train_chunk, work, card):
    """Phase 14, every width JAX runs: (a) ``width_kernels`` on the first
    loo training chunk (``train_chunk``: its canonicalized observations,
    x4 and ids); (b) ``cli train --recipe loo --hidden-size`` 256, 24 and
    640 for an epoch (``WIDTH_RUNS`` through ``gan_run``: the first step on
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


def member_launches(sa, bf16: bool) -> dict:
    """The member launches of the float32 (bf16) kernels."""
    attr = "member_launches_bf16" if bf16 else "member_launches"
    return {"fwd": getattr(sa.social_attention_fwd, attr),
            "dq": getattr(sa.social_attention_bwd_dq, attr),
            "dkv": getattr(sa.social_attention_bwd_dkv, attr)}


def path_launches(sa, what: str, bf16: bool, want: dict) -> dict:
    """The launches of a member path, held to ``want`` exactly: every one a
    member launch of the path's operand type, none of the other type."""
    got = bf16_launches(sa, what) if bf16 else read_launches(sa)
    other = read_launches(sa, bf16=not bf16)
    if got != want or member_launches(sa, bf16) != want or any(
            other.values()):
        raise AssertionError(f"{what}: launched {got} (member launches "
                             f"{member_launches(sa, bf16)}, other type "
                             f"{other}), want {want}")
    return got


def hold_member_step(what, stacked, m, solos, tcfg) -> dict:
    """A member step from fresh states (``stacked``, metrics ``m``)
    against each member's solo step (``solos``: (state, metrics) a member,
    from the same state and draws), member by member: ``hold_step``, and
    in float32 also every state leaf within 1e-3 of its scale.  A new G
    parameter whose gradient is within the gradient check's noise (|mu| at
    most 1e-3 max|mu| of its leaf + 1e-9) moves by Adam's first update,
    about +-lr, whichever way its rounding fell: past the 1e-3 rule such an
    element keeps ``hold_step``'s bound (at most 2 lr).  Returns the worst
    gradient ratio, the G elements within the noise, and those of them
    that needed the allowance."""
    from socialways_torch.engine.ensemble import member_state
    from socialways_torch.io.checkpoint import flatten_state
    worst, noisy, used = 0.0, 0, 0
    for i, (solo, ms) in enumerate(solos):
        f_m, f_s = flatten_state(member_state(stacked, i)), flatten_state(solo)
        got = hold_step(f"{what} member {i}", f_m, f_s,
                        [float(v[i]) for v in m[:4]],
                        [float(v) for v in ms[:4]], tcfg)
        worst = max(worst, got["gradient"][0])
        if tcfg.compute_dtype == "bfloat16":
            continue
        for key, ref in f_s.items():
            if key.endswith(".count"):
                continue
            err = np.abs(f_m[key] - ref)
            bad = err > 1e-3 * float(np.abs(ref).max()) + 1e-9
            if key.startswith(".g_params/"):
                (mu_key,) = [k for k in f_s if k.startswith(".g_opt/") and
                             k.endswith("/.mu/" + key[len(".g_params/"):])]
                mu = np.abs(f_s[mu_key])
                noise = mu <= 1e-3 * float(mu.max()) + 1e-9
                noisy += int(noise.sum())
                used += int((bad & noise).sum())
                bad &= ~noise
            if bad.any():
                raise AssertionError(
                    f"{what} member {i} {key}: max abs {float(err.max()):.3e}"
                    f", scale {float(np.abs(ref).max()):.3e}")
    return {"gradient": worst, "noise": noisy, "allowance": used}


def ensemble_loo(torch, sa, dev, npz, cfg, card):
    """Phase 13b: ``EnsembleTrainer`` on the loo recipe at full width, M =
    ENSEMBLE_M seeds: the first member step against the members' solo
    steps under the same draws, one epoch and ``evaluate`` against solo
    runs, and the kernels' launches over that epoch and evaluate."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import EnsembleTrainer, stack_draws
    from socialways_torch.engine.train_step import (draw_step, eval_params,
                                                    gan_step)
    from socialways_torch.engine.trainer import Trainer, chunk_of

    tr = Trainer(cfg, load_npz_dataset(npz), dev)
    ens = EnsembleTrainer(tr)
    seeds = [1 + i for i in range(ENSEMBLE_M)]
    width, nv0 = tr.train_packed.width, int(tr.train_packed.n_valid[0])
    # the first step: member-batched against solo, the same draws
    draws = [draw_step(width, tr.cfg, torch.Generator(device=dev).manual_seed(
        70 + s), dev) for s in seeds]
    stacked, m = gan_step(ens.init_states(seeds), chunk_of(tr.train_dev, 0),
                          stack_draws(draws), tr.cfg, nv0, members=True)
    held = hold_member_step("ensemble first step", stacked, m, [
        gan_step(tr.init_state(s), chunk_of(tr.train_dev, 0), draws[i],
                 tr.cfg, nv0) for i, s in enumerate(seeds)], tr.cfg)
    print(f"ensemble first step (M = {ENSEMBLE_M}, loo width) vs {ENSEMBLE_M}"
          f" solo steps (hold_member_step): losses and sums within rel "
          f"1e-4, gradients at most {held['gradient']:.3f} of 1e-3 their "
          f"scale, every state leaf within 1e-3 of its scale but "
          f"{held['allowance']} of the {held['noise']} G parameters whose "
          f"gradient is rounding noise (within their first-update bound)")
    # one epoch and evaluate: the main path of the slice
    gens = lambda: [torch.Generator(device=dev).manual_seed(90 + s)
                    for s in seeds]
    states = ens.init_states(seeds)
    reset_launches(sa)
    states, me = ens.train_epoch(states, gens())
    epoch_launches = read_launches(sa)
    ev = ens.evaluate(states, seeds)
    torch.cuda.synchronize()
    n_steps, n_eval = tr.n_steps_per_epoch, tr.test_packed.n_chunks
    if epoch_launches != {"fwd": n_steps, "dq": 0, "dkv": n_steps}:
        raise AssertionError(f"ensemble epoch launched {epoch_launches}: "
                             f"one launch a step for all members")
    launches = path_launches(sa, "ensemble epoch + evaluate", False,
                             {"fwd": n_steps + n_eval, "dq": 0,
                              "dkv": n_steps})
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
    ENSEMBLE_M profiled.  Each M has an ``EnsembleTrainer`` of its own:
    one trainer's epoch graphs hold one state's tensors, and another
    state through it is captured anew."""
    from socialways_torch.engine.ensemble import EnsembleTrainer, stack_draws
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import chunk_of
    enss = {m: EnsembleTrainer(tr) for m in ENSEMBLE_RATE_MS}
    n_steps = tr.n_steps_per_epoch
    runs = {m: (enss[m].init_states(list(range(m))),
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
                runs[key] = (enss[key].train_epoch(st, gens)[0], gens)
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


#: phase 16: one member step for each field the ensemble once refused, at
#: phase 10's values (variety_k at JAX's default, 20), with the forward and
#: dkv launches of one solo step as phase 10 predicts them: a member step
#: launches once for all members.  grad_accum runs on an npz of scenes of
#: 16, which tile its four 64-row micro-chunks at batch 256.
MEMBER_FIELDS = {
    "r1_gamma": (dict(r1_gamma=1.0), (1, 1)),
    "use_variety_loss": (dict(use_variety_loss=True, variety_k=20), (2, 1)),
    "ms_weight": (dict(ms_weight=0.1), (2, 1)),
    "ds_weight": (dict(ds_weight=0.1, ds_k=4), (2, 1)),
    "serial_rollout": (dict(serial_rollout=True), (2, 1)),
    "grad_accum": (dict(grad_accum=4), (8, 4)),
    "remat_steps": (dict(remat_steps=True), (1, 1)),
    "bf16": (dict(compute_dtype="bfloat16"), (1, 1)),
}
MEMBER_SEEDS, REMAT_BATCH = (1, 2, 3, 4), 4608


def member_field(torch, sa, dev, tr, tag, per_step, card):
    """Phase 16a for one field: ``tr``'s first chunk, one member step of
    MEMBER_SEEDS against their solo steps under the same draws
    (``hold_member_step``), launches exact; then member-steps/s and solo
    steps/s of graphed epochs (the main path; a first epoch captures),
    alternated over two rounds (means)."""
    from socialways_torch.engine.ensemble import EnsembleTrainer, stack_draws
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import chunk_of
    cfg, width = tr.cfg, tr.train_packed.width
    bf16 = cfg.compute_dtype == "bfloat16"
    ens, m_ = EnsembleTrainer(tr), len(MEMBER_SEEDS)
    draws = [draw_step(width, cfg, torch.Generator(device=dev).manual_seed(
        70 + s), dev) for s in MEMBER_SEEDS]
    chunk, nv = chunk_of(tr.train_dev, 0), int(tr.train_packed.n_valid[0])
    stacked = ens.init_states(MEMBER_SEEDS)
    reset_launches(sa)
    stacked, m = gan_step(stacked, chunk, stack_draws(draws), cfg, nv,
                          members=True)
    torch.cuda.synchronize()
    launches = path_launches(sa, f"member step {tag}", bf16,
                             {"fwd": per_step[0], "dq": 0,
                              "dkv": per_step[1]})
    held = hold_member_step(f"member step {tag}", stacked, m, [
        gan_step(tr.init_state(s), chunk, draws[i], cfg, nv)
        for i, s in enumerate(MEMBER_SEEDS)], cfg)
    solo = tr.init_state(MEMBER_SEEDS[0])
    gens = [torch.Generator(device=dev).manual_seed(s) for s in MEMBER_SEEDS]
    n_steps = tr.n_steps_per_epoch
    times = {"members": [], "solo": []}
    for rnd in range(3):             # round 0 captures
        for key in times:
            if key == "solo":
                solo, m = tr.train_epoch(solo, gens[0])
            else:
                stacked, m = ens.train_epoch(stacked, gens)
            if not np.isfinite(m["g_loss"]).all():
                raise AssertionError(f"member field {tag} {key}: {m}")
            if rnd:
                times[key].append(m["epoch_time_s"])
    rate = m_ * n_steps / float(np.mean(times["members"]))
    solo_rate = n_steps / float(np.mean(times["solo"]))
    rule = ("hold_step, bf16" if bf16 else
            f"hold_step and every leaf within 1e-3 of its scale but "
            f"{held['allowance']} of {held['noise']} noise-gradient G "
            f"parameters")
    print(f"member step {tag} (M = {m_}, batch {width}): each member equals "
          f"its solo step ({rule}; gradients at most "
          f"{held['gradient']:.3f} of their bound); launches {launches}, "
          f"every one a member launch; {rate:.2f} member-steps/s, solo "
          f"{solo_rate:.2f} steps/s ({rate / solo_rate:.2f}x; "
          f"graphed epochs of {n_steps} steps, 2 alternated rounds, means) "
          f"[{card}]")
    return {"launches": launches, "member_steps_s": rate,
            "solo_steps_s": solo_rate, "held": held}


def remat_memory(torch, dev, crowd_npz, cfg, card):
    """Phase 16b: peak device memory of one member step of MEMBER_SEEDS at
    batch REMAT_BATCH on ``crowd_npz`` (--max-scene-size 16) with
    ``remat_steps`` off and on; with it on the step keeps only each LSTM
    and decode step's inputs, so its peak must be lower."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import EnsembleTrainer, stack_draws
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import Trainer, chunk_of
    ds, peaks = load_npz_dataset(crowd_npz), {}
    for remat in (False, True):
        tr = Trainer(cfg.replace(batch_size=REMAT_BATCH, max_scene_size=16,
                                 remat_steps=remat), ds, dev)
        stacked = EnsembleTrainer(tr).init_states(MEMBER_SEEDS)
        draws = stack_draws([draw_step(
            tr.train_packed.width, tr.cfg, torch.Generator(
                device=dev).manual_seed(80 + s), dev) for s in MEMBER_SEEDS])
        chunk = chunk_of(tr.train_dev, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, m = gan_step(stacked, chunk, draws, tr.cfg,
                        int(tr.train_packed.n_valid[0]), members=True)
        torch.cuda.synchronize()
        if not all(np.isfinite(float(v)) for t in m for v in t.flatten()):
            raise AssertionError(f"remat {remat}: metrics {m}")
        peaks[remat] = (torch.cuda.max_memory_allocated(),
                        torch.cuda.max_memory_allocated() - before)
        del tr, stacked, draws, chunk
    print(f"member step at batch {REMAT_BATCH} (M = {len(MEMBER_SEEDS)}, "
          f"--max-scene-size 16): torch.cuda.max_memory_allocated "
          f"{peaks[False][0] / 2**20:.1f} MiB without remat_steps, "
          f"{peaks[True][0] / 2**20:.1f} MiB with it (the step's own: "
          f"{peaks[False][1] / 2**20:.1f} / {peaks[True][1] / 2**20:.1f} MiB)"
          f" [{card}]")
    if peaks[True][1] >= peaks[False][1]:
        raise AssertionError(f"remat_steps did not lower a member step's "
                             f"peak memory: {peaks}")
    return {"off_bytes": peaks[False][0], "on_bytes": peaks[True][0],
            "off_step_bytes": peaks[False][1],
            "on_step_bytes": peaks[True][1]}


def bf16_ensemble(torch, sa, dev, npz, cfg, card):
    """Phase 16c: a bf16 ``EnsembleTrainer`` epoch and ``evaluate`` of
    MEMBER_SEEDS on the loo recipe: one bf16 member launch a step and an
    eval chunk, no float32 launch, finite metrics."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import EnsembleTrainer
    from socialways_torch.engine.trainer import Trainer
    tr = Trainer(cfg.replace(compute_dtype="bfloat16"),
                 load_npz_dataset(npz), dev)
    ens = EnsembleTrainer(tr)
    states = ens.init_states(MEMBER_SEEDS)
    gens = [torch.Generator(device=dev).manual_seed(90 + s)
            for s in MEMBER_SEEDS]
    n_steps, n_eval = tr.n_steps_per_epoch, tr.test_packed.n_chunks
    reset_launches(sa)
    states, me = ens.train_epoch(states, gens)
    ev = ens.evaluate(states, MEMBER_SEEDS)
    torch.cuda.synchronize()
    launches = path_launches(sa, "bf16 ensemble epoch + evaluate", True,
                             {"fwd": n_steps + n_eval, "dq": 0,
                              "dkv": n_steps})
    vals = [me[k] for k in ("d_loss", "g_loss", "train_ade", "train_fde")]
    if not np.isfinite(vals).all() or not all(
            np.isfinite(v) for e in ev for v in e.values()):
        raise AssertionError(f"bf16 ensemble: epoch {me}, evaluate {ev}")
    print(f"bf16 ensemble epoch (M = {len(MEMBER_SEEDS)}, {n_steps} steps, "
          f"{me['epoch_time_s']:.2f} s) + evaluate ({n_eval} chunks): bf16 "
          f"launches {launches}, every one a member launch, no float32 "
          f"launch; member ade_min {[round(e['ade_min'], 4) for e in ev]} "
          f"[{card}]")
    return launches


def member_variants_phase(torch, sa, dev, npz, crowd_npz, crowd16_npz,
                          train_cfg, card):
    """Phase 16, the ensemble on every configuration: (a) ``member_field``
    for each of MEMBER_FIELDS on the loo recipe (grad_accum on
    ``crowd16_npz``, scenes of 16), (b) ``remat_memory`` on
    ``crowd_npz``, (c) ``bf16_ensemble``."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer
    tic_phase = time.perf_counter()
    data = {p: load_npz_dataset(p) for p in (npz, crowd16_npz)}
    fields = {}
    for tag, (flags, per_step) in MEMBER_FIELDS.items():
        ds = data[crowd16_npz if "grad_accum" in flags else npz]
        fields[tag] = member_field(torch, sa, dev,
                                   Trainer(train_cfg.replace(**flags), ds,
                                           dev), tag, per_step, card)
    memory = remat_memory(torch, dev, crowd_npz, train_cfg, card)
    ens16 = bf16_ensemble(torch, sa, dev, npz, train_cfg, card)
    wall = time.perf_counter() - tic_phase
    print(f"member variants phase: {wall:.2f} s wall [{card}]")
    return {"fields": fields, "remat_memory": memory,
            "bf16_ensemble": ens16, "wall_s": wall}


#: phase 17: data parallelism (parallel/, ``train --mesh``).  The card is
#: one H100 and NCCL takes one card a rank, so the CLI runs ``--mesh 1``
#: (NCCL at world size 1); the 2-rank checks put both gloo ranks on it.
#: ``crowd_simulate_sharded``'s crowd is cut from simulate's 10,000 agents
#: to DP_CROWD_N so that two ranks' dense [N/2, N, 64] float32 pair
#: tensors fit the one card.
DP_CROWD_N, DP_CROWD_WINDOWS, DP_SEEDS = 4096, 2, (1, 2, 3, 4)


def loo_cfg(**kw):
    """The loo training configuration of the phases (main's ``train_cfg``),
    for the functions that run in a process or rank of their own."""
    from socialways_torch.config import TrainConfig
    return TrainConfig(agent_frame=True, use_social=True, g_ema_decay=0.999,
                       hidden_size=HIDDEN, social_feature_size=HIDDEN,
                       noise_len=HIDDEN // 2, batch_size=BATCH,
                       n_past=N_PAST, n_next=N_NEXT, n_gen_samples=K,
                       d_input_noise=0.05, d_input_noise_steps=-1,
                       d_input_noise_floor=0.02, n_epochs=200, **kw)


def dp_mesh1_cli(torch, sa, cli_main, npz, work, card):
    """Phase 17a: ``cli train --recipe loo --mesh 1`` for 2 epochs, graphed
    (NCCL at world size 1: every DP step a replay, its all-reduces
    captured), against ``--mesh 1 --host-loop`` and against the graphed
    run without ``--mesh``, in this process: the checkpoints equal bit
    for bit (the count weight is exactly 1 at D = 1 and a one-rank
    all-reduce is the identity), so do the kernels' launches.  Then a
    profiled replayed ``--mesh 1`` epoch (``dp_graph_profile``) and train
    steps/s of the three in alternated processes."""
    from socialways_torch.parallel.mesh import run
    base = ["train", "--recipe", "loo", "--data", npz, "--epochs", "2",
            "--test-interval", "1", "--save-interval", "1"]
    modes = {"plain": [], "mesh1": ["--mesh", "1"],
             "mesh1_host": ["--mesh", "1", "--host-loop"]}
    runs = {}
    for tag, extra in modes.items():
        mdir = os.path.join(work, f"dp_{tag}")
        buf = io.StringIO()
        reset_launches(sa)
        with contextlib.redirect_stdout(buf):
            rc = cli_main(base + ["--model-dir", mdir] + extra)
        launches = read_launches(sa)
        if rc != 0:
            raise AssertionError(f"cli train {extra}: rc {rc}\n"
                                 f"{buf.getvalue()}")
        runs[tag] = (mdir, launches, buf.getvalue())
    files = sorted(os.listdir(runs["mesh1"][0]))
    n_leaves = 0
    for other in ("mesh1_host", "plain"):
        if runs[other][1] != runs["mesh1"][1]:
            raise AssertionError(f"--mesh 1 launched {runs['mesh1'][1]}, "
                                 f"{other} {runs[other][1]}")
        if files != sorted(os.listdir(runs[other][0])) or not files:
            raise AssertionError(f"checkpoints differ: {files}")
        for f in files:
            with np.load(os.path.join(runs["mesh1"][0], f)) as a, \
                    np.load(os.path.join(runs[other][0], f)) as b:
                if sorted(a.files) != sorted(b.files):
                    raise AssertionError(f"{f}: keys differ")
                for k in a.files:
                    if not np.array_equal(a[k], b[k]):
                        raise AssertionError(f"--mesh 1 {f} {k} differs from "
                                             f"{other}")
                n_leaves += len(a.files)
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    for tag in ("mesh1", "mesh1_host"):
        if f"mesh 1: 1 ranks, {backend}" not in runs[tag][2]:
            raise AssertionError(f"{tag} did not run {backend} at world "
                                 "size 1")
    print(f"cli train --recipe loo --mesh 1 ({backend}, world size 1, "
          f"graphed) vs --mesh 1 --host-loop and vs graphed without --mesh,"
          f" 2 epochs: {len(files)} checkpoints ({n_leaves} leaf "
          f"comparisons) equal bit for bit; launches {runs['mesh1'][1]} "
          f"equal")
    prof = run(dp_graph_profile, 1, "cuda", args=(npz, card))
    rates = {tag: [] for tag in modes}
    for tag in ("plain", "mesh1", "mesh1_host", "mesh1_host", "mesh1",
                "plain"):
        mdir = tempfile.mkdtemp(prefix=f"dp_rate_{tag}_", dir=work)
        log = os.path.join(mdir, "metrics.jsonl")
        out = subprocess.run(
            [sys.executable, "-m", "socialways_torch.cli.main"] + base[:7]
            + ["--test-interval", "10", "--save-interval", "10",
               "--model-dir", mdir, "--metrics-log", log] + modes[tag],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"{tag} process: rc {out.returncode}\n"
                                 f"{out.stderr[-2000:]}")
        steps = int(re.search(r"chunks: (\d+)", out.stdout).group(1))
        with open(log) as fh:
            secs = [row["epoch_time_s"] for row in map(json.loads, fh)
                    if row["kind"] == "train" and row["epoch"] == 2][0]
        rates[tag].append(steps / secs)
    # one card: --mesh 2 is JAX's error, and nothing runs
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(base + ["--model-dir", os.path.join(work, "dp_mesh2"),
                              "--mesh", "2"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if have < 2 and (rc != 1 or f"ERROR: --mesh 2 needs 2 devices, have "
                     f"{have}" not in err.getvalue()):
        raise AssertionError(f"--mesh 2 on one device: rc {rc}, "
                             f"{err.getvalue()!r}")
    print(f"cli train --mesh 2 on {have} device(s): rc {rc}, "
          f"{err.getvalue().strip()!r}")
    fmt = lambda tag: [round(r, 2) for r in rates[tag]]
    print(f"train steps/s, epoch 2 (loo, batch {BATCH}), alternated "
          f"processes: graphed without --mesh {fmt('plain')}, graphed "
          f"--mesh 1 {fmt('mesh1')}, --mesh 1 --host-loop "
          f"{fmt('mesh1_host')} [{card}]")
    return {"launches": runs["mesh1"][1], "rates": rates, "profile": prof}


def dp_graph_profile(mesh, npz, card):
    """Phase 17a's profiled replayed epoch of ``Trainer(mesh=)`` on a mesh
    of one NCCL rank (``parallel.run`` in this process)."""
    import torch
    from socialways_torch.kernels import social_attention as sa
    if mesh.backend != "nccl":
        raise AssertionError(f"17a: a {mesh.backend} mesh")
    return graph_profile(torch, sa, mesh.device, npz, loo_cfg(), card, mesh,
                         tag="17a")


def dp_ranks(mesh, job):
    """Phase 17b-d on one rank of 2 gloo ranks sharing the card (run by
    ``parallel.spawn``): (b) a full-width loo DP step, an epoch and the DP
    evaluate, (c) ``crowd_simulate_sharded``, (d) ``EnsembleTrainer``
    sharding 4 members; rank 0 also runs each single-process counterpart
    on the card and holds the pair.  Returns the rank's launches and
    measurements."""
    import torch
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import EnsembleTrainer, member_state
    from socialways_torch.engine.losses import sample_noise
    from socialways_torch.engine.simulate import (crowd_simulate,
                                                  crowd_simulate_sharded,
                                                  initial_crowd)
    from socialways_torch.engine.train_step import (StepDraws, draw_step,
                                                    eval_params, gan_step)
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.eval.metrics import (EvalSums, draw_noise,
                                               eval_chunk, finalize_eval)
    from socialways_torch.io.checkpoint import (flatten_state,
                                                restore_generator,
                                                state_from_flat)
    from socialways_torch.kernels import social_attention as sa
    from socialways_torch.parallel.mesh import (rank_column,
                                                shard_packed_for_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, r, d = mesh.device, mesh.rank, mesh.size
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    out = {}
    ds = load_npz_dataset(job["npz"])
    # gloo's collectives cannot be captured: the graphed epoch refuses
    try:
        Trainer(job["cfg"], ds, mesh=mesh)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    tr = Trainer(job["cfg"].replace(epoch_on_device=False), ds, mesh=mesh)
    cfg, width = tr.cfg, tr.train_packed.width

    def to_dev(draws):
        return StepDraws(*(None if t is None else t.to(dev) for t in draws))

    def group(packed, g):
        """Group g concatenated, scene ids unique across its chunks (the
        single-process counterpart of the ranks' chunks)."""
        grouped = shard_packed_for_mesh(packed, d)
        b = {k: torch.from_numpy(v[g]).to(dev) for k, v in grouped.items()}
        ids = grouped["scene_ids"][g].copy()
        for p in range(d):
            part = ids[p * width:(p + 1) * width]
            part[part >= 0] += p * width
        b["scene_ids"] = torch.from_numpy(ids).to(dev)
        return b

    # (b) one DP step on group 0 (2 chunks), then an epoch, then evaluate
    flat0 = flatten_state(tr.init_state(seed=1))
    draws = to_dev(draw_step(d * width, cfg,
                             torch.Generator().manual_seed(7)))
    counts = tr.train_counts
    reset_launches(sa)
    st, m = gan_step(state_from_flat(flat0, cfg, dev),
                     chunk_of(tr.train_dev, 0), draws, cfg,
                     n_valid=int(counts[0, r]), mesh=mesh,
                     n_valid_global=int(counts[0].sum()))
    sync()
    out["step_launches"] = read_launches(sa)
    out["step_flat"] = flatten_state(st)
    out["step_metrics"] = [float(v) for v in m[:4]]
    if r == 0:
        ref, m_ref = gan_step(state_from_flat(flat0, cfg, dev),
                              group(tr.train_packed, 0), draws, cfg)
        out["single_flat"] = flatten_state(ref)
        out["single_metrics"] = [float(v) for v in m_ref[:4]]
    st = state_from_flat(flat0, cfg, dev)
    reset_launches(sa)
    st, me = tr.train_epoch(st, torch.Generator(device=dev).manual_seed(3))
    out["epoch_launches"] = read_launches(sa)
    out["epoch"] = me
    reset_launches(sa)
    test_groups = tr.test_dev["valid"].shape[0]
    k = cfg.n_gen_samples
    gen = torch.Generator().manual_seed(11)
    noises = [draw_noise(k, d * width, cfg, gen).to(dev)
              for _ in range(test_groups)]
    out["eval"] = tr.evaluate(eval_params(st), noises=noises)
    out["eval_launches"] = read_launches(sa)
    if r == 0:
        total = None
        for g in range(test_groups):
            s = eval_chunk(eval_params(st), group(tr.test_packed, g), k, cfg,
                           noise=noises[g])
            total = s if total is None else EvalSums(
                *(a + b for a, b in zip(total, s)))
        out["single_eval"] = finalize_eval(total, ds.ss, ds.n_test_samples)

    # (c) crowd_simulate_sharded (gather) against crowd_simulate
    g_sim, _, _ = restore_generator(job["ckpt"], job["sim_cfg"], dev)
    obsv0, ids = initial_crowd(job["crowd_n"], CROWD_SCENE, N_PAST, 0)
    obsv0, ids = torch.from_numpy(obsv0).to(dev), torch.from_numpy(ids).to(dev)
    noise = sample_noise((DP_CROWD_WINDOWS, job["crowd_n"]), job["sim_cfg"],
                         torch.Generator().manual_seed(5)).to(dev)
    sim = lambda: crowd_simulate_sharded(
        g_sim, obsv0, ids, DP_CROWD_WINDOWS, job["sim_cfg"], mesh,
        noise=noise)
    traj = sim()
    sync()
    tic = time.perf_counter()
    traj2 = sim()
    sync()
    out["sim_s"] = time.perf_counter() - tic
    out["sim_repeat_equal"] = bool(torch.equal(traj, traj2))
    out["sim_shape"] = tuple(traj.shape)
    if r == 0:
        ref = crowd_simulate(g_sim, obsv0, ids, DP_CROWD_WINDOWS,
                             job["sim_cfg"], noise=noise)
        out["sim_err"] = float((traj - ref).abs().max())
        out["sim_finite"] = bool(torch.isfinite(traj).all())

    # (d) EnsembleTrainer(mesh=): 2 members a rank, graphed (each rank
    # replays its own member step) and eager; a second epoch timed
    seeds = list(DP_SEEDS)
    gens = lambda: [torch.Generator(device=dev).manual_seed(90 + s)
                    for s in seeds]
    for mode in ("graph", "eager"):
        ens = EnsembleTrainer(Trainer(job["cfg"].replace(
            epoch_on_device=mode == "graph"), ds, dev), mesh)
        if ens.graphed != (mode == "graph"):
            raise AssertionError(f"ensemble mesh {mode}: graphed "
                                 f"{ens.graphed}")
        g = gens()
        reset_launches(sa)
        states, m_ens = ens.train_epoch(ens.init_states(seeds), g)
        sync()
        launches = read_launches(sa)
        ev = ens.evaluate(states, seeds)
        sync()
        tic = time.perf_counter()
        states, m2 = ens.train_epoch(states, g)
        sync()
        out[f"ens_{mode}"] = {
            "launches": launches, "epochs": (m_ens, m2), "eval": ev,
            "secs": time.perf_counter() - tic,
            "flats": [flatten_state(member_state(states, i))
                      for i in range(len(seeds) // d)]}
    out["ens_epoch_launches"] = out["ens_graph"]["launches"]
    if r == 0:
        solo = EnsembleTrainer(Trainer(job["cfg"], ds, dev))
        states1, m1 = solo.train_epoch(solo.init_states(seeds), gens())
        out["ens_single"] = (m1, solo.evaluate(states1, seeds))
    return out


def dp_nccl_ranks(mesh, job):
    """Phase 17e on one rank of 2 NCCL ranks (one card each):
    ``Trainer(mesh=)`` 2 loo epochs graphed and eager
    (``epoch_on_device=False``) from one state and seed; the rank's final
    states and metrics."""
    import torch
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer
    from socialways_torch.io.checkpoint import flatten_state
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = load_npz_dataset(job["npz"])
    out = {}
    for mode in ("graph", "eager"):
        tr = Trainer(job["cfg"].replace(epoch_on_device=mode == "graph"), ds,
                     mesh=mesh)
        if tr.graphed != (mode == "graph"):
            raise AssertionError(f"17e {mode}: graphed {tr.graphed}")
        state = tr.init_state(1)
        rng = torch.Generator(device=mesh.device).manual_seed(3)
        ms = []
        for _ in range(2):
            state, m = tr.train_epoch(state, rng)
            ms.append({k: m[k] for k in ("d_loss", "g_loss", "train_ade",
                                         "train_fde")})
        out[mode] = (flatten_state(state), ms)
        out[f"{mode}_steps_s"] = tr.n_steps_per_epoch / m["epoch_time_s"]
    out["counts"] = tr.train_counts.tolist()
    return out


def dp_nccl_phase(torch, npz, card, world=2):
    """Phase 17e: with ``world`` cards, a ``world``-rank NCCL graphed DP
    run (its all-reduces captured) against the same ranks run eagerly,
    bit for bit, and group-steps/s of both (the second epoch); with fewer
    cards, one line saying that it did not run and why."""
    from socialways_torch.parallel.mesh import spawn
    have = torch.cuda.device_count()
    if have < world:
        print(f"17e NOT RUN: a {world}-rank NCCL graphed DP epoch needs "
              f"{world} cards (NCCL takes one card a rank), this machine has "
              f"{have}; a captured multi-rank all-reduce is not checked "
              f"here [{card}]")
        return None
    ranks = spawn(dp_nccl_ranks, world, "cuda",
                  args=({"npz": npz, "cfg": loo_cfg()},), timeout=300)
    for rank, res in enumerate(ranks):
        (fg, mg), (fe, me) = res["graph"], res["eager"]
        bad = [k for k in fg if not np.array_equal(fg[k], fe[k])]
        if bad or mg != me:
            raise AssertionError(f"17e rank {rank}: graphed differs from "
                                 f"eager in {bad[:5]} / {mg} vs {me}")
        if any(not np.array_equal(v, ranks[0]["graph"][0][k])
               for k, v in fg.items()):
            raise AssertionError("17e: the ranks' states differ")
    rates = {mode: min(r[f"{mode}_steps_s"] for r in ranks)
             for mode in ("graph", "eager")}
    print(f"17e {world} NCCL ranks, 2 loo epochs (last group's counts "
          f"{ranks[0]['counts'][-1]}): graphed (all-reduces captured) = "
          f"eager bit for bit on every rank ({len(fg)} leaves); "
          f"group-steps/s (second epoch, slowest rank) graphed "
          f"{rates['graph']:.2f}, eager {rates['eager']:.2f} [{card}]")
    return rates


def dp_phase(torch, sa, cli_main, npz, ckpt, work, train_cfg, card):
    """Phase 17: data parallelism.  (a) ``dp_mesh1_cli``; (b)-(d)
    ``dp_ranks`` on 2 gloo ranks sharing the card, held here: a gloo mesh
    with ``epoch_on_device`` refused (its collectives cannot be captured),
    then eagerly the DP step against the single-process step on the
    concatenated group (losses and sums rel 1e-5, the state by
    ``hold_step``), each rank's launches one forward and one dkv a step
    and a forward an eval group, the DP evaluate within rel 1e-4 of the
    single-process one; the sharded simulate within atol 1e-4 of
    ``crowd_simulate`` on the card; the member-sharded ensemble graphed
    against eager bit for bit, and its epoch and evaluate within rel 2e-4
    of the 4-member ensemble in one process; (e) ``dp_nccl_phase``.  The
    ring form is not run on the card: gloo aborts the process on
    point-to-point sends of CUDA tensors (the CPU tests hold it)."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer
    from socialways_torch.config import TrainConfig
    from socialways_torch.io.checkpoint import adopt_checkpoint_config
    from socialways_torch.parallel.mesh import spawn
    tic_phase = time.perf_counter()
    mesh1 = dp_mesh1_cli(torch, sa, cli_main, npz, work, card)

    # simulate's configuration of phase 7's checkpoint (scene window 16)
    sim_cfg = adopt_checkpoint_config(TrainConfig(), ckpt).replace(
        max_scene_size=CROWD_SCENE)
    tr = Trainer(train_cfg, load_npz_dataset(npz), "cpu")
    groups, test_groups = (-(-tr.train_packed.n_chunks // 2),
                           -(-tr.test_packed.n_chunks // 2))
    tic = time.perf_counter()
    ranks = spawn(dp_ranks, 2, "cuda", backend="gloo",
                  args=({"npz": npz, "cfg": train_cfg, "ckpt": ckpt,
                         "sim_cfg": sim_cfg, "crowd_n": DP_CROWD_N},),
                  timeout=400)
    spawn_s = time.perf_counter() - tic
    r0 = ranks[0]
    # (b) gloo on the card refuses the graphed epoch, naming --host-loop
    for rank, res in enumerate(ranks):
        if not res["refusal"] or "--host-loop" not in res["refusal"]:
            raise AssertionError(f"rank {rank}: a gloo mesh on the card with "
                                 f"epoch_on_device gave {res['refusal']!r}")
    print(f"17b gloo + CUDA + epoch_on_device refused on both ranks: "
          f"{r0['refusal']!r}; the DP checks below run "
          f"epoch_on_device=False")
    # (b) the DP step against the single-process step
    held = hold_step("DP step (2 gloo ranks) vs single process",
                     r0["step_flat"], r0["single_flat"], r0["step_metrics"],
                     r0["single_metrics"], tr.cfg)
    for nm, a, b in zip(("d_loss", "g_loss", "ade_sum", "fde_sum"),
                        r0["step_metrics"], r0["single_metrics"]):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"DP step {nm}: {a} vs {b} (rel 1e-5)")
    # and the CPU tests' bound on every parameter (JAX's DP tests')
    outside = sum(int((~np.isclose(r0["step_flat"][k], v, rtol=2e-4,
                                   atol=1e-6)).sum())
                  for k, v in r0["single_flat"].items()
                  if k.startswith((".g_params/", ".d_params/")))
    if outside:
        raise AssertionError(f"DP step: {outside} parameter elements "
                             "outside rtol 2e-4 / atol 1e-6")
    for k, v in r0["step_flat"].items():
        if not np.array_equal(ranks[1]["step_flat"][k], v):
            raise AssertionError(f"DP step: rank 1's {k} differs")
    per_step = {"fwd": 1, "dq": 0, "dkv": 1}
    per_epoch = {"fwd": groups, "dq": 0, "dkv": groups}
    per_eval = {"fwd": test_groups, "dq": 0, "dkv": 0}
    for rank, res in enumerate(ranks):
        for what, got, want in (("step", res["step_launches"], per_step),
                                ("epoch", res["epoch_launches"], per_epoch),
                                ("evaluate", res["eval_launches"], per_eval)):
            if got != want:
                raise AssertionError(f"rank {rank} DP {what} launched {got}"
                                     f", want {want}")
    m = r0["epoch"]
    if not all(np.isfinite(v) for v in m.values()) or ranks[1]["epoch"][
            "train_ade"] != m["train_ade"]:
        raise AssertionError(f"DP epoch metrics {m} / {ranks[1]['epoch']}")
    eval_rel = 0.0
    for key, b in r0["single_eval"].items():
        a = r0["eval"][key]
        if not np.isfinite(a) or abs(a - b) > 1e-4 * abs(b) or \
                ranks[1]["eval"][key] != a:
            raise AssertionError(f"DP evaluate {key}: {a} vs single "
                                 f"process {b} (rel 1e-4)")
        eval_rel = max(eval_rel, abs(a - b) / abs(b))
    print(f"DP step (2 gloo ranks on one card, loo width, group of 2 chunks "
          f"of {tr.train_packed.width}) vs the single-process step on the "
          f"concatenated group: losses and sums within rel 1e-5, gradients "
          f"at most {held['gradient'][0]:.3f} of 1e-3 their scale, new "
          f"params G at most {held['params']['G']:.3f} of hold_step's bound,"
          f" D max abs diff {held['params']['D']:.3e}; every parameter "
          f"within rtol 2e-4 / atol 1e-6; both ranks equal; "
          f"launches a rank {per_step}")
    print(f"DP epoch: {groups} group steps a rank, launches {per_epoch} on "
          f"each rank, {groups / m['epoch_time_s']:.2f} group-steps/s "
          f"({m['epoch_time_s'] / groups * 1e3:.1f} ms a step; rank 1 "
          f"{groups / ranks[1]['epoch']['epoch_time_s']:.2f}); DP evaluate "
          f"({test_groups} groups, launches {per_eval} a rank) within rel "
          f"1e-4 of the single process (worst rel {eval_rel:.2e}; ade_min "
          f"{r0['eval']['ade_min']:.6f}) [{card}]")
    # (c) crowd_simulate_sharded
    n_steps = DP_CROWD_N * DP_CROWD_WINDOWS * N_NEXT
    if not (r0["sim_finite"] and r0["sim_err"] <= 1e-4
            and r0["sim_repeat_equal"]
            and r0["sim_shape"] == (DP_CROWD_N, DP_CROWD_WINDOWS * N_NEXT, 2)):
        raise AssertionError(f"crowd_simulate_sharded: max abs diff "
                             f"{r0['sim_err']:.3e} against crowd_simulate "
                             f"(atol 1e-4), shape {r0['sim_shape']}")
    sim_rate = n_steps / max(r0["sim_s"], ranks[1]["sim_s"])
    print(f"crowd_simulate_sharded (gather, 2 gloo ranks) at {DP_CROWD_N} "
          f"agents in scenes of {CROWD_SCENE}, {DP_CROWD_WINDOWS} windows: "
          f"max abs diff {r0['sim_err']:.3e} against crowd_simulate on the "
          f"card (atol 1e-4), {sim_rate:.4g} agent-steps/s (second call); "
          f"ring: not run on the card (gloo aborts on CUDA point to point) "
          f"[{card}]")
    # (d) the member-sharded ensemble: graphed = eager, bit for bit
    for rank, res in enumerate(ranks):
        a, b = res["ens_graph"], res["ens_eager"]
        for i, (fa, fb) in enumerate(zip(a["flats"], b["flats"])):
            bad = [k for k in fa if not np.array_equal(fa[k], fb[k])]
            if bad:
                raise AssertionError(f"rank {rank} ensemble member {i}: "
                                     f"graphed differs from eager in "
                                     f"{bad[:5]}")
        for ma, mb in zip(a["epochs"], b["epochs"]):
            for key in ("d_loss", "g_loss", "train_ade", "train_fde"):
                if not np.array_equal(ma[key], mb[key]):
                    raise AssertionError(f"rank {rank} ensemble {key}: "
                                         f"{ma[key]} vs {mb[key]}")
        if a["eval"] != b["eval"] or a["launches"] != b["launches"]:
            raise AssertionError(f"rank {rank} ensemble: evaluate or "
                                 "launches differ graphed and eager")
    m_mesh, ev_mesh = r0["ens_graph"]["epochs"][0], r0["ens_graph"]["eval"]
    m_one, ev_one = r0["ens_single"]
    ens_rel = 0.0
    for key in ("d_loss", "g_loss", "train_ade", "train_fde"):
        a, b = np.asarray(m_mesh[key]), np.asarray(m_one[key])
        if a.shape != (len(DP_SEEDS),) or not np.allclose(a, b, rtol=2e-4,
                                                          atol=0):
            raise AssertionError(f"ensemble mesh {key}: {a} vs {b}")
        ens_rel = max(ens_rel, float(np.max(np.abs(a - b) / np.abs(b))))
    for i, (a, b) in enumerate(zip(ev_mesh, ev_one)):
        for key in b:
            if abs(a[key] - b[key]) > 2e-4 * abs(b[key]):
                raise AssertionError(f"ensemble mesh member {i} eval {key}:"
                                     f" {a[key]} vs {b[key]}")
            ens_rel = max(ens_rel, abs(a[key] - b[key]) / abs(b[key]))
    if ranks[1]["ens_graph"]["eval"] != ev_mesh or len(ev_mesh) != len(
            DP_SEEDS):
        raise AssertionError("the ranks' ensemble evaluations differ")
    n_steps_ens = tr.n_steps_per_epoch
    for rank, res in enumerate(ranks):
        want = {"fwd": n_steps_ens, "dq": 0, "dkv": n_steps_ens}
        if res["ens_epoch_launches"] != want:
            raise AssertionError(f"rank {rank} ensemble epoch launched "
                                 f"{res['ens_epoch_launches']}, want {want}")
    ens_rates = {mode: len(DP_SEEDS) * n_steps_ens / max(
        res[f"ens_{mode}"]["secs"] for res in ranks)
        for mode in ("graph", "eager")}
    print(f"EnsembleTrainer(mesh=) 2 gloo ranks x 2 members, graphed (each "
          f"rank replays its member step) = eager bit for bit over 2 epochs "
          f"(every member's leaves, the metrics, evaluate and launches), and"
          f" vs the 4-member ensemble in one process: epoch metrics and "
          f"evaluate within rel 2e-4 for every member (worst rel "
          f"{ens_rel:.2e}), on both ranks; launches a rank "
          f"{ranks[0]['ens_epoch_launches']} over {n_steps_ens} steps; "
          f"member-steps/s (second epoch, both ranks on the card) graphed "
          f"{ens_rates['graph']:.2f}, eager {ens_rates['eager']:.2f} "
          f"[{card}]")
    nccl2 = dp_nccl_phase(torch, npz, card)
    wall = time.perf_counter() - tic_phase
    print(f"data-parallel phase: {wall:.2f} s wall (2-rank spawn "
          f"{spawn_s:.2f} s) [{card}]")
    return {"mesh1": mesh1, "ranks": [{k: res[k] for k in (
        "step_launches", "epoch_launches", "eval_launches",
        "ens_epoch_launches")} for res in ranks],
        "dp_steps_s": groups / m["epoch_time_s"], "sim_rate": sim_rate,
        "ens_rates": ens_rates, "nccl2": nccl2, "wall_s": wall}


#: phase 18: JAX's epoch on the device (engine/graphed.py).  Each run of
#: ``graph_vs_eager`` trains the same command twice, graphed (the default)
#: and with ``--host-loop``; the runs' configurations: (a) the loo recipe,
#: (b) under --bf16, (c) every schedule moving (the lr decays with warmup,
#: the D/G ratio switching from 2 to 1 inside the run, the info ramp, the
#: clip, the unroll's full restore, noise annealed over the planned run),
#: (d) fused epochs, and (e) the toy-flagship recipe with a coverage
#: rescue that resets D, then resumed
GRAPH_EPOCHS = 3
GRAPH_SCHEDULES = ["--lr-decay-rate", "0.9", "--lr-decay-steps", "7",
                   "--lr-warmup-steps", "5", "--d-lr-decay-rate", "0.8",
                   "--d-lr-decay-steps", "11", "--d-update-every", "2",
                   "--d-update-every-end", "1", "--d-update-every-switch",
                   "40", "--info-weight-end", "1.5", "--info-weight-steps",
                   "60", "--grad-clip", "1.0", "--unroll", "1",
                   "--d-restore", "full"]
GRAPH_TOY = ["--recipe", "toy-flagship", "--test-interval", "1",
             "--track-coverage", "--stall-recover", "1", "--stall-reset-d"]


def graph_kernel_probe(torch, sa, dev, cfg, card):
    """Phase 18a: a forward (with stats) and a dkv launch captured alone in
    a CUDA graph and replayed, against eager launches on the same inputs
    bit for bit, then again after the inputs change in place: the kernels'
    own CUDA runtime launches onto the capturing stream, and the forward's
    and the finalize's programmatic dependent launches become the graph's
    edges.  The capture counts no launch; its record holds one of each."""
    from socialways_torch.models.generator import init_generator
    from socialways_torch.ops.nn import linear_apply
    rng = np.random.RandomState(18)
    g = init_generator(cfg, torch.Generator().manual_seed(18), dev)
    x4, h, ids = (torch.from_numpy(a).to(dev)
                  for a in attention_inputs(rng, BATCH, HIDDEN))
    gout = torch.from_numpy(rng.randn(BATCH, HIDDEN).astype(
        np.float32)).to(dev)
    w = [t.detach() for layer in g.feat_mlp for t in (layer.w, layer.b)]
    with torch.no_grad():
        wh = linear_apply(g.attn_w, h)

    def pair():
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, with_stats=True)
        grads = sa.social_attention_bwd_dkv(x4, ids, h, wh, gout, stats,
                                            (gout * out).sum(-1), w, u, c)
        return [out, stats, u, c] + grads

    with torch.no_grad():
        pair()                                   # warm-up
        graph = torch.cuda.CUDAGraph()
        before = sa.launch_counts()
        with sa.captured_launches() as record:
            with torch.cuda.graph(graph):
                outs = pair()
        if sa.launch_counts() != before:
            raise AssertionError("a capture counted launches")
        want = {(sa.social_attention_fwd, "launches"): 1,
                (sa.social_attention_bwd_dkv, "launches"): 1}
        if record != want:
            raise AssertionError(f"the capture recorded {record}")
        for step in ("as captured", "after h, wh and g change in place"):
            if step.startswith("after"):
                h.mul_(0.5)
                wh.copy_(linear_apply(g.attn_w, h))
                gout.mul_(-1.5)
            graph.replay()
            ref = pair()
            torch.cuda.synchronize()
            names = ["out", "stats", "u", "c", "dx", "dh", "dwh", "dw1",
                     "db1", "dw2", "db2", "dw3", "db3"]
            for nm, a, b in zip(names, outs, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"replayed {nm} ({step}) differs "
                                         "from the eager launch")
        replay_ms = median_ms(torch, graph.replay)
        eager_ms = median_ms(torch, pair)
    print(f"graph probe: forward + dkv captured alone (PDL edges, the "
          f"kernels' own CUDA runtime), replays equal eager launches bit "
          f"for bit as captured and after the inputs change in place (13 "
          f"outputs); capture counted 0, recorded {len(record)} launches; "
          f"replay {replay_ms * 1e3:.2f} us, eager {eager_ms * 1e3:.2f} us "
          f"[{card}]")


def _named_launches(sa) -> dict:
    """The counters as names (for printing and comparing)."""
    return {f"{w.__name__}.{c}": n for (w, c), n in sa.launch_counts().items()
            if n}


def graph_vs_eager(torch, sa, cli_main, argv, work, tag, card,
                   resume_epochs=0, eager_twice=False, must_print=None):
    """One CLI ``train`` command graphed and with ``--host-loop`` (and a
    second ``--host-loop`` run when ``eager_twice``), each in a model dir
    of its own with a metrics log: every checkpoint leaf (the counts too),
    every metrics row but its times, and every launch counter equal
    bit for bit.  ``resume_epochs`` > 0 trains each dir again to that
    many epochs (a resumed run).  ``must_print``: text the graphed run
    must print (a rescue firing).  Returns the graphed run's launches."""
    modes = ["graph", "eager"] + (["eager2"] if eager_twice else [])
    runs, tic = {}, time.perf_counter()
    for mode in modes:
        mdir = os.path.join(work, f"g18_{tag}_{mode}")
        log = mdir + ".jsonl"
        extra = [] if mode == "graph" else ["--host-loop"]
        reset_launches(sa)
        outs = []
        for epochs in [None] + ([resume_epochs] if resume_epochs else []):
            buf = io.StringIO()
            cmd = argv + ["--model-dir", mdir, "--metrics-log", log] + extra
            if epochs:
                cmd = cmd + ["--epochs", str(epochs)]
            with contextlib.redirect_stdout(buf):
                rc = cli_main(cmd)
            outs.append(buf.getvalue())
            if rc != 0:
                raise AssertionError(f"18 {tag} {mode}: rc {rc}\n{outs[-1]}")
        torch.cuda.synchronize()
        with open(log) as fh:
            rows = [{k: v for k, v in json.loads(line).items()
                     if k not in ("epoch_time_s", "t")} for line in fh]
        runs[mode] = (mdir, rows, _named_launches(sa), "".join(outs))
    if resume_epochs and "resumed from" not in runs["graph"][3]:
        raise AssertionError(f"18 {tag}: the second run did not resume")
    if must_print and must_print not in runs["graph"][3]:
        raise AssertionError(f"18 {tag}: no {must_print!r} in\n"
                             f"{runs['graph'][3]}")
    n_leaves, files = 0, sorted(os.listdir(runs["graph"][0]))
    for other in modes[1:]:
        a, b = runs["graph"], runs[other]
        if other == "eager2":
            a = runs["eager"]
        if sorted(os.listdir(b[0])) != files or not files:
            raise AssertionError(f"18 {tag} {other}: checkpoints "
                                 f"{os.listdir(b[0])} vs {files}")
        for f in files:
            with np.load(os.path.join(a[0], f)) as x, \
                    np.load(os.path.join(b[0], f)) as y:
                if sorted(x.files) != sorted(y.files):
                    raise AssertionError(f"18 {tag} {f}: keys differ")
                for k in x.files:
                    if not np.array_equal(x[k], y[k]):
                        raise AssertionError(f"18 {tag} {f} {k}: {other} "
                                             "differs")
                n_leaves += len(x.files)
        if a[1] != b[1]:
            raise AssertionError(f"18 {tag} metrics rows differ ({other}):\n"
                                 f"{a[1]}\n{b[1]}")
        if a[2] != b[2]:
            raise AssertionError(f"18 {tag} launches differ ({other}): "
                                 f"{a[2]} vs {b[2]}")
    rescues = runs["graph"][3].count("STALLED")
    print(f"18 {tag}: graphed = --host-loop"
          + (" = --host-loop again" if eager_twice else "")
          + f" bit for bit: {len(files)} checkpoints ({n_leaves} leaf "
          f"comparisons, counts included), {len(runs['graph'][1])} metrics "
          f"rows, launches {runs['graph'][2]}"
          + (f", {rescues} rescues" if rescues else "")
          + (", resumed" if resume_epochs else "")
          + f" ({time.perf_counter() - tic:.1f} s) [{card}]")
    return runs["graph"][2]


def graph_ensemble(torch, sa, dev, npz, cfg, card):
    """Phase 18f: an ``EnsembleTrainer`` epoch at M = ENSEMBLE_M on the loo
    recipe from members stacked at counts 0 to M - 1 (member i trained i
    solo steps first), graphed against ``epoch_on_device=False``: every
    member's state, the counts and the metrics bit for bit, launches
    equal (one forward and one dkv a step for all members)."""
    import copy
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import (EnsembleTrainer,
                                                  member_state, stack_states)
    from socialways_torch.engine.train_step import draw_step, gan_step
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.io.checkpoint import flatten_state
    ds = load_npz_dataset(npz)
    trs = {"graph": Trainer(cfg, ds, dev),
           "eager": Trainer(cfg.replace(epoch_on_device=False), ds, dev)}
    tr = trs["graph"]
    solos = []
    for i in range(ENSEMBLE_M):
        s = tr.init_state(1 + i)
        for j in range(i):
            s, _ = gan_step(s, chunk_of(tr.train_dev, j), draw_step(
                tr.train_packed.width, tr.cfg,
                torch.Generator(device=dev).manual_seed(40 + j), dev),
                tr.cfg, int(tr.train_packed.n_valid[j]))
        solos.append(s)
    stacked = stack_states(solos)
    if stacked.g_opt.count.tolist() != list(range(ENSEMBLE_M)):
        raise AssertionError(f"member counts {stacked.g_opt.count}")
    out = {}
    for mode, t in trs.items():
        ens = EnsembleTrainer(t)
        if ens.graphed != (mode == "graph"):
            raise AssertionError(f"18f {mode}: graphed {ens.graphed}")
        reset_launches(sa)
        st, m = ens.train_epoch(copy.deepcopy(stacked), [
            torch.Generator(device=dev).manual_seed(90 + s)
            for s in range(ENSEMBLE_M)])
        torch.cuda.synchronize()
        out[mode] = ([flatten_state(member_state(st, i))
                      for i in range(ENSEMBLE_M)], m, _named_launches(sa))
    (fa, ma, la), (fb, mb, lb) = out["graph"], out["eager"]
    for i in range(ENSEMBLE_M):
        for k in fa[i]:
            if not np.array_equal(fa[i][k], fb[i][k]):
                raise AssertionError(f"18f member {i} {k} differs")
    for k in ("d_loss", "g_loss", "train_ade", "train_fde"):
        if not np.array_equal(ma[k], mb[k]):
            raise AssertionError(f"18f {k}: {ma[k]} vs {mb[k]}")
    n = tr.n_steps_per_epoch
    want = {"social_attention_fwd.launches": n,
            "social_attention_fwd.member_launches": n,
            "social_attention_bwd_dkv.launches": n,
            "social_attention_bwd_dkv.member_launches": n}
    if la != lb or la != want:
        raise AssertionError(f"18f launches {la} / eager {lb}, want {want}")
    counts = [int(f[".g_opt/[0]/.count"]) for f in fa]
    print(f"18f EnsembleTrainer M = {ENSEMBLE_M} loo epoch from counts "
          f"{list(range(ENSEMBLE_M))} (now {counts}): graphed = eager bit "
          f"for bit for every member's {len(fa[0])} leaves and the "
          f"metrics; launches {la} [{card}]")
    return la


def graph_profile(torch, sa, dev, npz, cfg, card, mesh=None,
                  tag="18g"):
    """Phase 18g (17a with a ``mesh``): one graphed epoch (every step a
    replay) under torch.profiler: the kernels it names, counted, against
    the credited launch counters of the same epoch, and the NCCL kernels
    it names; and the device ops, device time and idle share of a graphed
    epoch.  The trace can lose device records (on an H100 one profiled
    epoch in 60 lost about 4,700 of its 64,200, and with them a forward
    and two dkv launches; a few others lost 100-150), so an epoch whose
    trace names fewer launches than the counters is traced again, up to
    three epochs in all, each one's counts printed; a trace that names
    more, or a count that is not one a step, fails at once."""
    from torch.profiler import ProfilerActivity, profile
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer
    tr = Trainer(cfg, load_npz_dataset(npz), dev, mesh)
    if not tr.graphed:
        raise AssertionError(f"{tag}: the epoch is not graphed")
    state = tr.init_state(1)
    rng = torch.Generator(device=dev).manual_seed(3)
    state, _ = tr.train_epoch(state, rng)        # the captures
    steps = tr.n_steps_per_epoch
    traces = []
    for _ in range(3):
        reset_launches(sa)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = tr.train_epoch(state, rng)
            torch.cuda.synchronize()
        credited = read_launches(sa)
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        seen = {"fwd": sum("social_attention_fwd_kernel" in n
                           for n in names),
                "dq": sum("bwd_dq_kernel" in n for n in names),
                "dkv": sum("bwd_dkv_kernel" in n for n in names)}
        traces.append(f"{seen} of {len(names)} device records")
        if credited["fwd"] != steps or any(seen[k] > credited[k]
                                           for k in seen):
            raise AssertionError(f"{tag} profiled replayed epoch: kernels "
                                 f"{seen}, credited counters {credited}")
        if seen == credited:
            break
    else:
        raise AssertionError(f"{tag} profiled replayed epochs: kernels "
                             f"{traces}, credited counters {credited}")
    nccl = sorted({n[:60] for n in names if "nccl" in n.lower()})
    print(f"{tag} profiled graphed epoch ({steps} replays"
          + ("" if mesh is None else f", a mesh of {mesh.size} "
             f"{mesh.backend} rank") + f"): the trace names {seen} kernel "
          f"launches, the credited counters {credited}; NCCL kernels: "
          f"{nccl or 'none'}; traces taken: {traces}")
    prof_ep = profile_step(torch, f"one graphed epoch ({steps} steps)",
                           lambda: tr.train_epoch(state, rng))
    print(f"{tag} a graphed step: {prof_ep['ops'] / steps:.0f} device ops, "
          f"{prof_ep['device_us'] / steps:.1f} us device time, "
          f"{prof_ep['wall_us'] / steps:.1f} us wall, idle "
          f"{prof_ep['idle']:.1%} [{card}]")
    return dict(prof_ep, credited=credited, nccl=nccl)


def graph_rate(npz: str, mode: str) -> None:
    """``chip_smoke.py --graph-rate graph|eager NPZ`` (phase 18h's child
    process): train steps/s of a loo epoch and member-steps/s of an M =
    ENSEMBLE_M epoch, each the second epoch of its run, graphed or eager;
    prints one JSON line."""
    import torch
    sys.path.insert(0, REPO)
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.ensemble import EnsembleTrainer
    from socialways_torch.engine.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = loo_cfg(epoch_on_device=mode == "graph")
    tr = Trainer(cfg, load_npz_dataset(npz), dev)
    state = tr.init_state(1)
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(2):
        state, m = tr.train_epoch(state, gen)
    ens = EnsembleTrainer(tr)
    states = ens.init_states(list(range(ENSEMBLE_M)))
    gens = [torch.Generator(device=dev).manual_seed(s)
            for s in range(ENSEMBLE_M)]
    for _ in range(2):
        states, me = ens.train_epoch(states, gens)
    n = tr.n_steps_per_epoch
    print(json.dumps({"mode": mode, "steps_s": n / m["epoch_time_s"],
                      "member_steps_s": ENSEMBLE_M * n / me["epoch_time_s"]}))


def graph_rates(npz, card):
    """Phase 18h: train steps/s and member-steps/s graphed against eager
    in alternated processes (graph, eager, eager, graph)."""
    rates = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        out = subprocess.run([sys.executable, os.path.join(REPO,
                                                           "chip_smoke.py"),
                              "--graph-rate", mode, npz], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"--graph-rate {mode}: rc {out.returncode}"
                                 f"\n{out.stderr[-2000:]}")
        rates[mode].append(json.loads(out.stdout.strip().splitlines()[-1]))
    fmt = lambda key, mode: [round(r[key], 2) for r in rates[mode]]
    print(f"18h alternated processes (loo, batch {BATCH}, second epoch): "
          f"train steps/s graphed {fmt('steps_s', 'graph')}, eager "
          f"{fmt('steps_s', 'eager')}; member-steps/s (M = {ENSEMBLE_M}) "
          f"graphed {fmt('member_steps_s', 'graph')}, eager "
          f"{fmt('member_steps_s', 'eager')} [{card}]")
    return rates


def graph_phase(torch, sa, cli_main, dev, npz, work, train_cfg, card):
    """Phase 18: JAX's epoch on the device, every step a replayed CUDA
    graph (engine/graphed.py), held bit for bit against the eager loop:
    (a) the kernels captured alone, then ``graph_vs_eager`` of (a) ``cli
    train --recipe loo`` (and a second eager run), (b) ``--bf16``, (c)
    every schedule moving, (d) ``--fused-epochs --block-size 2``, (e) the
    toy-flagship recipe with a rescue, resumed; (f) the ensemble at
    different counts; (g) a profiled replayed epoch; (h) the rates."""
    tic = time.perf_counter()
    graph_kernel_probe(torch, sa, dev, train_cfg, card)
    loo = ["train", "--recipe", "loo", "--data", npz, "--epochs",
           str(GRAPH_EPOCHS), "--test-interval", "1", "--save-interval", "1"]
    launches = {}
    launches["loo"] = graph_vs_eager(torch, sa, cli_main, loo, work, "a loo",
                                     card, eager_twice=True)
    launches["bf16"] = graph_vs_eager(torch, sa, cli_main, loo + ["--bf16"],
                                      work, "b bf16", card)
    launches["schedules"] = graph_vs_eager(
        torch, sa, cli_main, loo + GRAPH_SCHEDULES, work, "c schedules",
        card)
    launches["fused"] = graph_vs_eager(
        torch, sa, cli_main, loo[:6] + ["4", "--test-interval", "2",
                                        "--save-interval", "2",
                                        "--fused-epochs", "--block-size",
                                        "2"], work, "d fused", card)
    toy = os.path.join(work, "toy-graph.npz")
    run_cli(cli_main, ["create-toy", "--npz", toy], "create-toy")
    launches["toy_rescue"] = graph_vs_eager(
        torch, sa, cli_main, ["train", "--data", toy, "--epochs", "4"]
        + GRAPH_TOY, work, "e toy rescue", card, resume_epochs=6,
        must_print="coverage STALLED")
    launches["ensemble"] = graph_ensemble(torch, sa, dev, npz, train_cfg,
                                          card)
    prof = graph_profile(torch, sa, dev, npz, train_cfg, card)
    rates = graph_rates(npz, card)
    wall = time.perf_counter() - tic
    print(f"graph phase: {wall:.1f} s wall [{card}]")
    return {"launches": launches, "profile": prof, "rates": rates,
            "wall_s": wall}


#: phase 19's served model: the loo recipe at full width with the LSTM
#: decoder, gaussian noise and 3 categorical codes (EMA on, from loo)
SERVE_FLAGS = ["--recipe", "loo", "--decoder", "lstm", "--noise-dist",
               "gaussian", "--latent-code", "categorical",
               "--n-latent-codes", "3"]


def serve_checkpoints(torch, npz, work):
    """19a's checkpoints: a state of ``SERVE_FLAGS``'s model whose raw G is
    jittered off its EMA (``jitter_generator``), so that serving the wrong
    one shows; saved once with ``__config__`` and once without."""
    from socialways_torch.cli.main import _train_cfg, parse_args
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.rescue import (draw_jitter_noises,
                                                jitter_generator)
    from socialways_torch.engine.train_step import init_train_state
    from socialways_torch.io.checkpoint import save_checkpoint
    cfg = _train_cfg(parse_args(["train", "--data", npz] + SERVE_FLAGS))
    state = init_train_state(cfg, torch.Generator().manual_seed(19), "cpu")
    state = jitter_generator(state, draw_jitter_noises(
        state, torch.Generator().manual_seed(20)), 0.05)
    scale = load_npz_dataset(npz).scale
    paths = {}
    for tag, saved in (("configful", cfg), ("configless", None)):
        paths[tag] = os.path.join(work, f"serve-{tag}.npz")
        save_checkpoint(paths[tag], state, 7,
                        torch.Generator().manual_seed(0), scale, saved)
    return cfg, paths


def head_npz(npz: str, path: str, n_max: int) -> int:
    """The scenes of ``npz`` that end within its first ``n_max`` windows,
    written to ``path``; returns their window count."""
    with np.load(npz) as d:
        batches = np.asarray(d["batches"])
        keep = batches[batches[:, 1] <= n_max]
        m = int(keep[-1, 1])
        np.savez(path, obsvs=d["obsvs"][:m], preds=d["preds"][:m],
                 times=d["times"][:m], batches=keep)
    return m


def serve_flags_cli(torch, sa, cli_main, dev, npz, work, card):
    """19a and 19b: ``evaluate``, ``predict`` and ``simulate`` of the
    configless checkpoint with ``SERVE_FLAGS`` against the configful one,
    bit for bit, with the forward launches the chunk counts predict; then
    ``predict`` on the card against ``--cpu`` under the same draws."""
    import socialways_torch.eval.metrics as tmetrics
    from socialways_torch.data.dataset import greedy_chunks

    cfg, paths = serve_checkpoints(torch, npz, work)
    with np.load(npz) as d:
        all_chunks = len(greedy_chunks(np.asarray(d["batches"]), BATCH))
    from socialways_torch.data.dataset import load_npz_dataset
    eval_chunks = len(greedy_chunks(load_npz_dataset(npz).test_batches,
                                    BATCH))
    want = {"evaluate": eval_chunks, "predict": all_chunks, "simulate": 2}
    runs, launches = {}, {}
    for tag, path in paths.items():
        pred = os.path.join(work, f"serve-pred-{tag}.npz")
        traj = os.path.join(work, f"serve-sim-{tag}.npz")
        argvs = {"evaluate": ["evaluate", "--data", npz],
                 "predict": ["predict", "--data", npz, "--out", pred],
                 "simulate": ["simulate", "--agents", str(CROWD_N),
                              "--windows", "1", "--out", traj]}
        res = {}
        for cmd, argv in argvs.items():
            reset_launches(sa)
            out = run_cli(cli_main, argv + ["--model-file", path]
                          + SERVE_FLAGS, f"{cmd} {tag} {' '.join(SERVE_FLAGS)}",
                          card)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            got = read_launches(sa)
            if got != {"fwd": want[cmd], "dq": 0, "dkv": 0}:
                raise AssertionError(f"{cmd} {tag}: launched {got}, not "
                                     f"{want[cmd]} forwards")
            launches[f"serve_flags_{cmd}_{tag}"] = got
            # the timed simulate line varies: compare what it computed
            res[cmd] = (re.sub(r"in [\d.]+ ms = [\d.]+M", "in T", out)
                        .replace(path, "CKPT").replace(pred, "OUT")
                        .replace(traj, "OUT"))
        with np.load(pred) as f:
            res["predict_npz"] = {k: f[k] for k in f.files}
        with np.load(traj) as f:
            res["simulate_npz"] = f["trajectories"]
        runs[tag] = res
    a, b = runs["configless"], runs["configful"]
    for key in ("evaluate", "predict", "simulate"):
        if a[key] != b[key]:
            raise AssertionError(f"{key}: configless printed {a[key]!r}, "
                                 f"configful {b[key]!r}")
    for key, arr in b["predict_npz"].items():
        if not np.array_equal(a["predict_npz"][key], arr):
            raise AssertionError(f"predict npz {key}: configless differs "
                                 f"from configful in its bits")
    if not np.array_equal(a["simulate_npz"], b["simulate_npz"]):
        raise AssertionError("simulate: configless trajectories differ from "
                             "configful in their bits")
    if not np.isfinite(b["predict_npz"]["preds_our"]).all():
        raise AssertionError("predict wrote non-finite predictions")
    print(f"serving flags: configless = configful bit for bit for evaluate "
          f"({eval_chunks} forward launches), predict ({all_chunks}) and "
          f"simulate {CROWD_N} agents x 1 window (2 calls, 2 launches) "
          f"[{card}]")

    # predict on the card against --cpu, both drawing their noise from one
    # CPU stream, on the scenes of the first 600 windows
    sub = os.path.join(work, "serve-head.npz")
    m = head_npz(npz, sub, 600)
    real_draw, arrays = tmetrics.draw_noise, {}
    try:
        for where in ("card", "cpu"):
            stream = torch.Generator().manual_seed(11)
            tmetrics.draw_noise = (
                lambda k, n, c, generator=None, device=None:
                real_draw(k, n, c, stream, "cpu").to(device))
            out = os.path.join(work, f"serve-head-{where}.npz")
            run_cli(cli_main, (["--cpu"] if where == "cpu" else [])
                    + ["predict", "--data", sub, "--model-file",
                       paths["configless"], "--out", out] + SERVE_FLAGS,
                    f"predict {m} windows on the {where}", card)
            with np.load(out) as f:
                arrays[where] = {k: f[k] for k in f.files}
    finally:
        tmetrics.draw_noise = real_draw
    worst = {}
    for key, want_arr in arrays["cpu"].items():
        got = arrays["card"][key]
        np.testing.assert_allclose(got, want_arr, rtol=1e-4, atol=1e-5,
                                   err_msg=f"predict card vs cpu {key}")
        worst[key] = float(np.abs(got.astype(np.float64) - want_arr).max())
    print(f"serving flags: predict card vs --cpu under the same draws, {m} "
          f"windows: max abs diff {worst} (rtol 1e-4, atol 1e-5, world "
          f"units)")
    return launches


def library_attention(torch, sa, dev, train_chunk, card):
    """19c: ``kernels.social_attention_fused`` at the loo training chunk
    and ``social_attention_chunked`` at N = 10,000 in scenes of 16, each
    forward and gradient (x4, h, the MLP and attention weights) against
    autograd through its plain form at phase 4's and phase 11's bounds,
    timed (forward, and forward + backward) beside the plain forms."""
    import socialways_torch.kernels as kernels
    from socialways_torch.models.generator import init_generator
    from socialways_torch.ops.social import social_context_windowed

    g0, x4_np, h_np, ids_np = train_chunk
    cfg = loo_cfg()
    g1 = init_generator(cfg, torch.Generator().manual_seed(17), dev)
    crowd = crowd_inputs(np.random.RandomState(29), CROWD_N, HIDDEN)
    w = CROWD_SCENE
    cases = {
        "fused": (kernels.social_attention_fused, sa.social_attention_plain,
                  g0, (x4_np, h_np, ids_np), {}),
        "chunked": (sa.social_attention_chunked,
                    lambda *a: social_context_windowed(*a, w), g1, crowd,
                    {"max_scene": w, "chunk": 0}),
    }
    names = ["dx", "dh", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dWw",
             "dbw"]
    launches, entries = {}, {}
    for tag, (fn, plain, g, arrays, kw) in cases.items():
        x4, h, ids = (torch.from_numpy(a).to(dev) for a in arrays)
        gout = torch.from_numpy(np.random.RandomState(31).randn(
            *h.shape).astype(np.float32)).to(dev)
        weights = [t for layer in g.feat_mlp for t in (layer.w, layer.b)]

        def grads(f, x4=x4, h=h, g=g, weights=weights, gout=gout, ids=ids,
                  kw=None):
            xk, hk = x4.clone().requires_grad_(), h.clone().requires_grad_()
            out = f(g.feat_mlp, g.attn_w, xk, hk, ids, **(kw or {}))
            return out, torch.autograd.grad(
                (out * gout).sum(), [xk, hk] + weights
                + [g.attn_w.w, g.attn_w.b])

        reset_launches(sa)
        out, got = grads(fn, kw=kw)
        torch.cuda.synchronize()
        launches[f"library_{tag}"] = read_launches(sa)
        if launches[f"library_{tag}"] != {"fwd": 1, "dq": 1, "dkv": 1}:
            raise AssertionError(f"{tag}: launched "
                                 f"{launches[f'library_{tag}']}, not one "
                                 f"forward, dq and dkv")
        ref_out, want = grads(plain)
        err = check_close(out, ref_out, f"{tag} out")
        for i, (nm, a, b) in enumerate(zip(names, got, want)):
            err = max(err, check_close(
                a, b, f"{tag} {nm}",
                "dx" if nm == "dx" else "weight" if i >= 2 else "value"))
        with torch.no_grad():
            fwd_ms = median_ms(torch, lambda: fn(g.feat_mlp, g.attn_w, x4, h,
                                                 ids, **kw))
            fwd_plain_ms = median_ms(torch, lambda: plain(
                g.feat_mlp, g.attn_w, x4, h, ids), repeats=3)
        both_ms = median_ms(torch, lambda: grads(fn, kw=kw))
        both_plain_ms = median_ms(torch, lambda: grads(plain), repeats=3)
        n = h.shape[0]
        entries[tag] = {"n": n, "max_abs_err": err, "fwd_ms": fwd_ms,
                        "fwd_plain_ms": fwd_plain_ms,
                        "fwd_bwd_ms": both_ms,
                        "fwd_bwd_plain_ms": both_plain_ms}
        print(f"library social_attention_{tag} N={n}: forward and gradient "
              f"vs plain "
              f"max abs {err:.3e} ok; forward {fwd_ms * 1e3:.2f} us (plain "
              f"{fwd_plain_ms * 1e3:.2f} us), forward + backward "
              f"{both_ms * 1e3:.2f} us (plain {both_plain_ms * 1e3:.2f} us), "
              f"launches {launches[f'library_{tag}']} [{card}]")
    return launches, entries


def library_jitter(torch, dev, card):
    """19d: ``jitter_generator`` on the card against the CPU under the same
    draws (each leaf within 1e-6 of its values' magnitude plus its RMS:
    the leaf's RMS is a sum in another order), ``sigma == 0`` the state
    itself, and the EMA, D and both optimizers untouched."""
    from socialways_torch.engine.rescue import (draw_jitter_noises,
                                                jitter_generator)
    from socialways_torch.engine.train_step import init_train_state
    from socialways_torch.io.checkpoint import flatten_state
    cfg = loo_cfg()
    noises = None
    flat = {}
    for where in (dev, torch.device("cpu")):
        state = init_train_state(cfg, torch.Generator().manual_seed(41),
                                 where)
        if noises is None:
            noises = draw_jitter_noises(state, torch.Generator().manual_seed(
                43))
        before = {k: v.copy() for k, v in flatten_state(state).items()}
        out = jitter_generator(state, [t.to(where) for t in noises], 0.1)
        if jitter_generator(state, noises, 0.0) is not state:
            raise AssertionError("jitter_generator at sigma 0 is not the "
                                 "identity")
        after = flatten_state(out)
        for k, v in before.items():
            moved = not np.array_equal(after[k], v)
            if moved != k.startswith(".g_params/"):
                raise AssertionError(f"jitter {where}: leaf {k} "
                                     f"{'moved' if moved else 'stayed'}")
        if any(not np.array_equal(v, before[k])
               for k, v in flatten_state(state).items()):
            raise AssertionError("jitter_generator moved its input state")
        flat[where.type] = after
    worst = 0.0
    for k, want in flat["cpu"].items():
        if not k.startswith(".g_params/"):
            continue
        got = flat[dev.type][k]
        rms = float(np.sqrt(np.mean(np.square(want))))
        err = np.abs(got - want)
        if (err > 1e-6 * (np.abs(want) + rms)).any():
            raise AssertionError(f"jitter card vs cpu {k}: max abs "
                                 f"{float(err.max()):.3e} (rms {rms:.3e})")
        worst = max(worst, float((err / (np.abs(want) + rms)).max()))
    print(f"library jitter_generator: card vs cpu max |err| / (|w| + "
          f"rms) {worst:.3e} (<= 1e-6); sigma 0 is the identity; EMA, D and "
          f"both optimizers untouched [{card}]")


def library_phase(torch, sa, cli_main, dev, npz, work, train_chunk, card):
    """Phase 19: JAX's serving command lines and library surface on the
    card.  Returns the launches of its paths and the attention entries'
    times."""
    tic = time.perf_counter()
    launches = serve_flags_cli(torch, sa, cli_main, dev, npz, work, card)
    more, entries = library_attention(torch, sa, dev, train_chunk, card)
    launches.update(more)
    library_jitter(torch, dev, card)
    wall = time.perf_counter() - tic
    print(f"phase 19 (serving flags, library surface): {wall:.1f} s "
          f"[{card}]")
    return {"launches": launches, "kernels": entries, "wall_s": wall}


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

        # ---- 16. the ensemble on every configuration
        variants = member_variants_phase(
            torch, sa, dev, npz, os.path.join(work, "crowd-8-12.npz"),
            os.path.join(work, "crowd16-8-12.npz"), train_cfg, smi)

        # ---- 17. data parallelism: --mesh 1, 2 gloo ranks on the card
        dp = dp_phase(torch, sa, cli_main, npz, loo_ckpt, work, train_cfg,
                      smi)
        # ---- 18. JAX's epoch on the device: graphed = eager, bit for bit
        graph = graph_phase(torch, sa, cli_main, dev, npz, work, train_cfg,
                            smi)
        # ---- 19. JAX's serving command lines and library surface
        library = library_phase(torch, sa, cli_main, dev, npz, work,
                                bwd_cases[-1][1:], smi)
        dp_paths = {"dp_mesh1_cli": dp["mesh1"]["launches"],
                    "dp_mesh1_replayed_epoch": dp["mesh1"]["profile"][
                        "credited"],
                    **{f"dp_{what}_rank{r}": launches[f"{what}_launches"]
                       for r, launches in enumerate(dp["ranks"])
                       for what in ("step", "epoch", "eval")},
                    **{f"graph_{k}": {key: v.get(
                        f"social_attention_{name}.launches", 0)
                        for key, name in (("fwd", "fwd"), ("dq", "bwd_dq"),
                                          ("dkv", "bwd_dkv"))}
                       for k, v in graph["launches"].items()
                       if k not in ("bf16", "ensemble")}}

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
                                    for k, v in loops.items()},
                                 **{k: v["fwd"] for k, v in
                                    dp_paths.items()},
                                 **{k: v["fwd"] for k, v in
                                    library["launches"].items()}},
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
            "library_entries": library["kernels"],
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
                                        for k, v in loops.items()},
                                     **{k: v[key] for k, v in
                                        dp_paths.items()},
                                     **{k: v[key] for k, v in
                                        library["launches"].items()
                                        if k.startswith("library_")}},
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
        # the fused decode (no TPU counterpart): launches on each bf16
        # serving path of phase 12, times at a crowd-sim window's rows
        cases = bf16["decode"]
        kernels.append({
            "name": "decode_rollout_bf16",
            "route": "cuda",
            "source": src + "decode_rollout_bf16.cu",
            "replaces": "none (the JAX package leaves the decode to XLA)",
            "launches": bf16["fused_launches"][f"simulate_{CROWD_1M}"][0],
            "launches_by_path": {k: v[0] for k, v in
                                 bf16["fused_launches"].items()},
            "max_abs_err": max(e["max_abs_err"] for e in cases),
            "mean_abs_err": max(e["mean_abs_err"] for e in cases),
            "ms": cases[0]["ms"],
            "plain_ms": cases[0]["plain_ms"],
            "bound_ms": cases[0]["bound_ms"],
            "bound_by": cases[0]["bound_by"],
            "library_ms": None,
            "launch_floor_ms": floor_ms,
            "cases": cases,
        })
        # the fused encoder (no TPU counterpart): launches on each bf16
        # serving path of phase 12 (its own counter), times at a crowd-sim
        # window's rows
        cases = bf16["encode"]
        kernels.append({
            "name": "encode_observation_bf16",
            "route": "cuda",
            "source": src + "encode_observation_bf16.cu",
            "replaces": "none (the JAX package leaves the encoder to XLA)",
            "launches": bf16["fused_launches"][f"simulate_{CROWD_1M}"][1],
            "launches_by_path": {k: v[1] for k, v in
                                 bf16["fused_launches"].items()},
            "max_abs_err": max(e["max_abs_err"] for e in cases),
            "mean_abs_err": max(e["mean_abs_err"] for e in cases),
            "ms": cases[0]["ms"],
            "plain_ms": cases[0]["plain_ms"],
            "bound_ms": cases[0]["bound_ms"],
            "bound_by": cases[0]["bound_by"],
            "library_ms": None,
            "launch_floor_ms": floor_ms,
            "cases": cases,
        })
        # Social GAN's pool (no TPU counterpart): launches on each bf16
        # --model sgan serving path of phase 12f, times at the
        # sgan-crowd-sim cell's crowd
        cases = bf16["sgan"]["cases"]
        kernels.append({
            "name": "social_pool_bf16",
            "route": "cuda",
            "source": src + "social_pool.cuh",
            "replaces": "none (the JAX package has no Social GAN)",
            "launches": bf16["sgan"]["launches"]["simulate"],
            "launches_by_path": bf16["sgan"]["launches"],
            "max_abs_err": max(e["max_abs_err"] for e in cases),
            "mean_abs_err": max(e["mean_abs_err"] for e in cases),
            "ms": cases[0]["ms"],
            "plain_ms": cases[0]["plain_ms"],
            "bound_ms": cases[0]["bound_ms"],
            "bound_by": cases[0]["bound_by"],
            "library_ms": None,
            "launch_floor_ms": floor_ms,
            "cases": cases,
        })
        # the member launches (the same entries, M > 1): launches from the
        # ensemble's epoch and evaluate (float32, phase 13; bf16, phase
        # 16c) and from phase 16a's member steps, times at M = 4 on the
        # first loo training chunk
        for dt, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            res = ens["kernels"][dt][0]
            by_path = ({"ensemble_loo": ens["launches"],
                        **{f"dp_ensemble_rank{r}": launches[
                            "ens_epoch_launches"]
                           for r, launches in enumerate(dp["ranks"])}}
                       if not suffix else
                       {"ensemble_loo_bf16": variants["bf16_ensemble"]})
            by_path.update({f"member_{k}": v["launches"] for k, v in
                            variants["fields"].items()
                            if (k == "bf16") == bool(suffix)})
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
                    "launches": next(iter(by_path.values()))[key],
                    "launches_by_path": {k: v[key]
                                         for k, v in by_path.items()},
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
              f"member variants: member-steps/s (solo steps/s) "
              + ", ".join(f"{k} {v['member_steps_s']:.2f} "
                          f"({v['solo_steps_s']:.2f})"
                          for k, v in variants["fields"].items())
              + f", phase 16 {variants['wall_s']:.1f} s; data parallel: "
              f"train steps/s graphed without --mesh "
              f"{[round(r, 2) for r in dp['mesh1']['rates']['plain']]}, "
              f"graphed --mesh 1 "
              f"{[round(r, 2) for r in dp['mesh1']['rates']['mesh1']]}, "
              f"--mesh 1 --host-loop "
              f"{[round(r, 2) for r in dp['mesh1']['rates']['mesh1_host']]}"
              f", 2 gloo ranks {dp['dp_steps_s']:.2f} group-steps/s, "
              f"member-sharded ensemble member-steps/s graphed "
              f"{dp['ens_rates']['graph']:.2f} (eager "
              f"{dp['ens_rates']['eager']:.2f}), sharded simulate "
              f"{dp['sim_rate']:.4g} agent-steps/s, phase 17 "
              f"{dp['wall_s']:.1f} s; graphed epochs: train steps/s "
              f"{[round(r['steps_s'], 2) for r in graph['rates']['graph']]}"
              f" (eager {[round(r['steps_s'], 2) for r in graph['rates']['eager']]}"
              f"), member-steps/s "
              f"{[round(r['member_steps_s'], 2) for r in graph['rates']['graph']]}"
              f" (eager "
              f"{[round(r['member_steps_s'], 2) for r in graph['rates']['eager']]}"
              f"), a graphed epoch {graph['profile']['idle']:.1%} idle, phase "
              f"18 {graph['wall_s']:.1f} s; phase 19 "
              f"{library['wall_s']:.1f} s; chip_smoke wall "
              f"{time.perf_counter() - t_start:.1f} s [{smi}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def sgan_only() -> int:
    """``chip_smoke.py --sgan``: phase 12f alone (Social GAN's pool
    kernel and its launches on the serving paths), on phase 5's npz
    made afresh; prints the ``social_pool_bf16`` cases and launches as
    one JSON line."""
    import torch
    sys.path.insert(0, REPO)
    from socialways_torch.cli.main import main as cli_main
    from socialways_torch.kernels import social_attention as sa
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        npz = os.path.join(work, "ethucy_like-8-12.npz")
        make_ethucy_like_npz(npz)
        out = sgan_phase(torch, sa, cli_main, torch.device("cuda"), npz,
                         work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"social_pool_bf16": out}))
    return 0


def encode_only() -> int:
    """``chip_smoke.py --encode``: the fused encoder's build check
    (``check_encode_build``) and phase 12a's ``ENCODE_CASES``; prints the
    ``encode_observation_bf16`` cases as one JSON line."""
    import torch
    sys.path.insert(0, REPO)
    from socialways_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build([ENCODE_LIB])
    check_encode_build(_build)
    cases = [encode_kernel_case(torch, torch.device("cuda"), n, smi)
             for n in ENCODE_CASES]
    print(json.dumps({"encode_observation_bf16": cases}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--graph-rate"]:
        graph_rate(sys.argv[3], sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--sgan"]:
        sys.exit(sgan_only())
    if sys.argv[1:2] == ["--encode"]:
        sys.exit(encode_only())
    sys.exit(main())
