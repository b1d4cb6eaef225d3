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
2. build every kernel from csrc/ (one nvcc per source, in parallel) and
   print ptxas's register and spill lines;
3. the forward kernel against its plain PyTorch version on the card, f32,
   at rtol 2e-4 / atol 2e-5, timed with CUDA events (median of repeats),
   with and without the softmax stats the backward needs;
4. the backward kernels (dq, dkv) and the autograd Function against their
   plain versions and autograd through the plain forward, at three
   synthetic shapes and on the training path's first chunk, timed;
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
8. a ``kernels`` JSON line, then the device JSON as the last line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 2e-4, 2e-5             # kernel vs plain (sums in another order)
H100_F32_FLOPS = 67e12              # FP32 (non-tensor) peak, H100 SXM
H100_BYTES_PER_S = 3.35e12          # HBM3
K, N_PAST, N_NEXT, BATCH, HIDDEN = 20, 8, 12, 256, 64
KERNELS = ["social_attention_fwd", "social_attention_bwd"]
SHAPES = [("eth-like N=256 H=F=64", 256, 64, 0),
          ("eth-like N=256 H=F=32", 256, 32, 0),
          ("scenes of 64 N=2048 H=F=64", 2048, 64, 64)]


def make_ethucy_like_npz(path: str, n_windows: int = 8000, seed: int = 0
                         ) -> None:
    """Windowed npz ({obsvs, preds, times, batches}, meters) shaped like the
    ETH/UCY sets: scenes of 2-16 pedestrians in a 15 m square walking
    0.8-1.6 m/s at 0.4 s a step with slight turns; 5 % stand still (zero
    displacement, the agent-frame identity fallback)."""
    rng = np.random.RandomState(seed)
    obsvs, preds, times, batches = [], [], [], []
    n = 0
    while n < n_windows:
        s = int(rng.randint(2, 17))
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


def _bound(flop: float, nbytes: float) -> dict:
    ops_ms = flop / H100_F32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"flop": flop, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                    n_params: int) -> dict:
    """Least time of the social-attention forward on this input: the FLOP
    it does (same-scene ordered pairs x the 3->32->64->F MLP and the score,
    plus wh = h W + b) at the f32 peak, against the bytes of x4, ids, h,
    the weights and out at the HBM rate."""
    pairs = _pairs(ids)
    mac = pairs * (3 * 32 + 32 * 64 + 64 * feat + 2 * feat) + n * hdim * feat
    out = _bound(2 * mac, 4 * (4 * n + n + 2 * n * hdim + n_params))
    out.update(pairs_needed=pairs, pairs_id_tested=n * 32 * ((n + 31) // 32))
    return out


def attention_bwd_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                        n_mlp: int, kernel: str) -> dict:
    """Least time of a backward kernel on this input.  Per same-scene pair
    both recompute the score (features, 3->32 and 32->64 layers, and
    a2 . u_j with u_j = W3 wh_j: 96 + 2048 + 64 MAC), take g_i . h_j (H)
    and pull ds back to the features (the z2 cotangent 64, 64->32: 2048).
    dq adds the 32->3 feature cotangent (96); dkv adds dh_j (H), the dW2
    outer product (2048), db2/A_j (128) and dW1/db1 (128).  Fixed work:
    u and c (N 64 F + N F); dkv also dwh_j (N 64 F), dW3 and db3 (N 64 F +
    N F).  Bytes: x4, ids, h, wh, g, stats, r and the MLP weights read
    once, the outputs written once."""
    pairs = _pairs(ids)
    common = 96 + 2048 + 64 + hdim + 64 + 2048
    in_bytes = 4 * (4 * n + n + 2 * n * hdim + n * feat + 3 * n + n_mlp)
    if kernel == "dq":
        mac = pairs * (common + 96) + n * 64 * feat + n * feat
        out_bytes = 4 * 4 * n
    else:
        mac = (pairs * (common + hdim + 2048 + 128 + 128)
               + 3 * n * 64 * feat + 2 * n * feat)
        out_bytes = 4 * (n * hdim + n * feat + n_mlp)
    out = _bound(2 * mac, in_bytes + out_bytes)
    out["pairs_needed"] = pairs
    return out


def attention_inputs(rng, n: int, hdim: int, scene: int = 0):
    """Last-frame states in normalized units and tanh-range hidden states.
    Scene ids: ``scene`` > 0 gives equal scenes of that size; 0 gives sorted
    ETH/UCY-like scenes of 2-16 agents with one singleton scene and a padded
    tail (-1) of about 10 %."""
    if scene:
        ids = (np.arange(n) // scene).astype(np.int32)
    else:
        ids = np.full(n, -1, np.int32)
        row, sid, n_real = 0, 0, int(n * 0.9)
        while row < n_real:
            s = 1 if sid == 3 else int(rng.randint(2, 17))
            ids[row:row + s] = sid
            row, sid = row + s, sid + 1
        ids[n_real:] = -1
    x4 = np.concatenate([rng.rand(n, 2), rng.randn(n, 2) * 0.02], axis=1)
    h = np.tanh(rng.randn(n, hdim))
    return x4.astype(np.float32), h.astype(np.float32), ids


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


def dx_witness(torch, sa, name, g, x4, h, ids, gout, pairs) -> None:
    """Why dx has a per-row bound: the f64 plain version of the same
    function on the same f32 inputs, against which both the kernel and the
    f32 plain version are held at that bound.  Prints, for each, the worst
    row's error over its scale and the elements outside the forward's
    elementwise rtol 2e-4 / atol 2e-5."""
    import copy
    from socialways_torch.ops.nn import linear_apply
    fm = copy.deepcopy(g.feat_mlp).double()
    aw = copy.deepcopy(g.attn_w).double()
    x64, h64, g64 = x4.double(), h.double(), gout.double()
    w64 = [t.detach() for layer in fm for t in (layer.w, layer.b)]
    with torch.no_grad():
        wh64 = linear_apply(aw, h64)
        out64, m64, l64 = sa.social_attention_stats_plain(fm, aw, x64, h64,
                                                          ids)
    args = (x64, ids, h64, wh64, g64, torch.stack([m64, l64], 1),
            (g64 * out64).sum(-1), w64)
    refs = {"dq dx_i": sa.social_attention_bwd_dq_plain(*args),
            "dkv dx_j": sa.social_attention_bwd_dkv_plain(*args)[0]}
    parts = []
    for key, (kern, plain) in pairs.items():
        ref = refs[key]
        for who, got in (("kernel", kern), ("plain f32", plain)):
            err = (got.double() - ref).abs()
            used = float((err.amax(dim=1)
                          / (1e-3 * ref.abs().amax(dim=1) + 2e-5)).max())
            if used > 1.0:
                raise AssertionError(f"{name} {key}: {who} outside the "
                                     f"per-row bound against f64 ({used:.2f})")
            n_out = int((err > ATOL + RTOL * ref.abs()).sum())
            parts.append(f"{key} {who} {used:.3f} of the row bound, "
                         f"{n_out}/{err.numel()} outside rtol/atol")
    print(f"dx vs f64 plain [{name}]: " + "; ".join(parts))


def backward_case(torch, sa, name, g, x4, h, ids, seed):
    """Phase 4 on one input: the Function and each backward kernel against
    the plain versions, and their times and bounds."""
    from socialways_torch.ops.nn import linear_apply
    dev = torch.device("cuda")
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
        check_close(a, b, f"{name} autograd {nm}",
                    "dx" if nm == "dx" else "weight" if i >= 2 else "value")

    # each kernel against its plain version on the same inputs
    w = [t.detach() for t in weights]
    with torch.no_grad():
        wh = linear_apply(g.attn_w, h)
        k_out, stats = sa._launch_fwd(x4, ids, h, wh, w, with_stats=True)
        p_out, m, l = sa.social_attention_stats_plain(g.feat_mlp, g.attn_w,
                                                      x4, h, ids)
    check_close(stats[:, 0], m, f"{name} m")
    check_close(stats[:, 1], l, f"{name} l")
    r = (gout * k_out).sum(-1)
    args = (x4, ids, h, wh, gout, stats, r, w)
    dq = sa.social_attention_bwd_dq(*args)
    dq_ref = sa.social_attention_bwd_dq_plain(*args)
    err_q = check_close(dq, dq_ref, f"{name} dq dx_i", "dx")
    dkv = sa.social_attention_bwd_dkv(*args, need_dx=False)
    dkv_ref = sa.social_attention_bwd_dkv_plain(*args, need_dx=False)
    kv_names = ["dh_j", "dwh_j", "dw1", "db1", "dw2", "db2", "dw3", "db3"]
    err_kv = max(check_close(a, b, f"{name} dkv {nm}",
                             "weight" if i >= 2 else "value")
                 for i, (nm, a, b) in enumerate(zip(kv_names, dkv[1:],
                                                    dkv_ref[1:])))
    dkv_x = sa.social_attention_bwd_dkv(*args)
    dkv_x_ref = sa.social_attention_bwd_dkv_plain(*args)
    err_kv = max(err_kv, check_close(dkv_x[0], dkv_x_ref[0],
                                     f"{name} dkv dx_j", "dx"))
    dx_witness(torch, sa, name, g, x4, h, ids, gout,
               {"dq dx_i": (dq, dq_ref), "dkv dx_j": (dkv_x[0], dkv_x_ref[0])})

    with torch.no_grad():
        fwd_ms = median_ms(torch, lambda: sa._launch_fwd(
            x4, ids, h, wh, w, with_stats=False))
        stats_ms = median_ms(torch, lambda: sa._launch_fwd(
            x4, ids, h, wh, w, with_stats=True))
        stats_plain_ms = median_ms(
            torch, lambda: sa.social_attention_stats_plain(
                g.feat_mlp, g.attn_w, x4, h, ids))
    t = {"dq": (median_ms(torch, lambda: sa.social_attention_bwd_dq(*args)),
                median_ms(torch,
                          lambda: sa.social_attention_bwd_dq_plain(*args))),
         "dkv": (median_ms(torch, lambda: sa.social_attention_bwd_dkv(
                     *args, need_dx=False)),
                 median_ms(torch, lambda: sa.social_attention_bwd_dkv_plain(
                     *args, need_dx=False)))}
    n, hdim = h.shape
    feat = wh.shape[1]
    n_mlp = sum(t_.numel() for t_ in w)
    ids_np = ids.cpu().numpy()
    bounds = {k: attention_bwd_bound(ids_np, n, hdim, feat, n_mlp, k)
              for k in ("dq", "dkv")}
    print(f"backward [{name}]: Function vs autograd of plain ok; m, l ok; "
          f"dq max abs {err_q:.3e}, dkv max abs {err_kv:.3e} | forward "
          f"{fwd_ms * 1e3:.2f} us, with stats {stats_ms * 1e3:.2f} us "
          f"(plain {stats_plain_ms * 1e3:.2f} us) | dq {t['dq'][0] * 1e3:.2f}"
          f" us (plain {t['dq'][1] * 1e3:.2f}, bound "
          f"{bounds['dq']['bound_ms'] * 1e3:.3f} {bounds['dq']['bound_by']})"
          f" | dkv {t['dkv'][0] * 1e3:.2f} us (plain "
          f"{t['dkv'][1] * 1e3:.2f}, bound "
          f"{bounds['dkv']['bound_ms'] * 1e3:.3f} "
          f"{bounds['dkv']['bound_by']}) | "
          f"{bounds['dq']['pairs_needed']} same-scene pairs")
    return {"err": {"dq": err_q, "dkv": err_kv}, "ms": t, "bounds": bounds,
            "stats_ms": stats_ms, "fwd_ms": fwd_ms}


def profile_step(torch, what: str, fn) -> None:
    """Device kernels/copies and device time of one ``fn()`` under
    torch.profiler, against the median untraced wall of 5 calls (the
    profiler inflates the wall it traces); the top device ops by time."""
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
    by_name = {}
    for e in dev_events:
        n_t = by_name.setdefault(e.name, [0, 0.0])
        n_t[0] += 1
        n_t[1] += e.device_time
    for nm, (cnt, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us:9.1f} us {cnt:4d}x {nm[:90]}")


def training_phase(torch, sa, dev, npz, cfg):
    """Phase 6: the training slice at full loo width on the card."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.rescue import reinit_discriminator
    from socialways_torch.engine.train_step import (StepDraws, draw_step,
                                                    gan_step)
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.io.checkpoint import (state_from_flat,
                                                flatten_state)

    ds = load_npz_dataset(npz)
    trainer = Trainer(cfg, ds, dev)
    tcfg = trainer.cfg
    state = trainer.init_state(seed=1)
    width, n_steps = trainer.train_packed.width, trainer.n_steps_per_epoch

    # the first step on the card and on the CPU from one state, one draw
    s_dev = state_from_flat(flatten_state(state), tcfg, dev)
    s_cpu = state_from_flat(flatten_state(state), tcfg, "cpu")
    draws = draw_step(width, tcfg, torch.Generator().manual_seed(7))
    draws_dev = StepDraws(*(None if t is None else t.to(dev) for t in draws))
    packed = trainer.train_packed
    c_cpu = {k: torch.from_numpy(getattr(packed, k)[0])
             for k in ("obsvs", "preds", "scene_ids", "valid")}
    nv0 = int(packed.n_valid[0])
    s_dev, m_dev = gan_step(s_dev, chunk_of(trainer.train_dev, 0), draws_dev,
                            tcfg, nv0)
    s_cpu, m_cpu = gan_step(s_cpu, c_cpu, draws, tcfg, nv0)
    for nm in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
        a, b = float(getattr(m_dev, nm)), float(getattr(m_cpu, nm))
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"first step {nm}: cuda {a} vs cpu {b}")
    # gradients: Adam's first moment after one G update is 0.1 g_G, after
    # the two D updates 0.09 g_D1 + 0.1 g_D2 -- compared leaf by leaf at
    # max|err| <= 1e-3 max|ref| + 1e-9 (sums over 256 rows through the
    # 20-step rollout and the attention, in another order)
    f_dev, f_cpu = flatten_state(s_dev), flatten_state(s_cpu)
    worst_g, worst_p = 0.0, {"G": 0.0, "D": 0.0}
    for key, ref in f_cpu.items():
        got = f_dev[key]
        if "/.mu/" in key:
            err = float(np.abs(got - ref).max())
            scale = float(np.abs(ref).max())
            if err > 1e-3 * scale + 1e-9:
                raise AssertionError(f"first step gradient {key}: max abs "
                                     f"{err:.3e} vs max ref {scale:.3e}")
            worst_g = max(worst_g, err / max(scale, 1e-30))
        elif key.startswith((".g_params/", ".d_params/")):
            side = "G" if key.startswith(".g") else "D"
            worst_p[side] = max(worst_p[side],
                                float(np.abs(got - ref).max()))
    # both devices start from one state, so the new parameters differ by
    # the difference of their updates, each about +-lr: held at 1e-2 lr
    for side, lr in (("G", tcfg.lr_g), ("D", tcfg.lr_d)):
        if worst_p[side] > 1e-2 * lr:
            raise AssertionError(f"first step new {side} params differ by "
                                 f"{worst_p[side]:.3e} > 1e-2 lr ({lr:g})")
    print(f"train step cuda vs cpu: losses and ADE/FDE sums within rel "
          f"1e-4 (d_loss {float(m_dev.d_loss):.6f}/{float(m_cpu.d_loss):.6f}"
          f", g_loss {float(m_dev.g_loss):.6f}/{float(m_cpu.g_loss):.6f}); "
          f"gradients (Adam first moments) max rel {worst_g:.3e} (bound "
          f"1e-3); new params max abs diff G {worst_p['G']:.3e} (bound "
          f"{1e-2 * tcfg.lr_g:g}), D {worst_p['D']:.3e} (bound "
          f"{1e-2 * tcfg.lr_d:g})")

    # one epoch: the kernels' launch counts on the main path
    rng = torch.Generator(device=dev).manual_seed(3)
    sa.social_attention_fwd.launches = 0
    sa.social_attention_bwd_dq.launches = 0
    sa.social_attention_bwd_dkv.launches = 0
    state, m1 = trainer.train_epoch(state, rng)
    launches = {"fwd": sa.social_attention_fwd.launches,
                "dq": sa.social_attention_bwd_dq.launches,
                "dkv": sa.social_attention_bwd_dkv.launches}
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
    """Phase 7: cli train --recipe loo, a resumed epoch, evaluate."""
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
    tic = time.perf_counter()
    _build.build(KERNELS)
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - tic:.2f} s"
          f" (parallel nvcc)")
    for name in KERNELS:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  ptxas {name}: {line.strip()[:150]}")

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
        rng = np.random.RandomState(0)
        cases = []
        for name, n, hdim, scene in SHAPES:
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
            with torch.no_grad():
                got = sa.social_attention_fwd(*args)
                want = sa.social_attention_plain(*args)
                torch.cuda.synchronize()
                err = (got - want).abs()
                rel = float((err / want.abs().clamp_min(1e-30)).max())
                check_close(got, want, f"forward {name}")
                k_ms = median_ms(torch, lambda: sa.social_attention_fwd(*args))
                p_ms = median_ms(torch,
                                 lambda: sa.social_attention_plain(*args))
            n, hdim = h.shape
            n_params = sum(t.numel() for m in (g.feat_mlp, g.attn_w)
                           for t in m.parameters())
            bound = attention_bound(ids, n, hdim, g.attn_w.w.shape[1],
                                    n_params)
            max_err = max(max_err, float(err.max()))
            print(f"forward vs plain [{name}]: max abs {float(err.max()):.3e} "
                  f"max rel {rel:.3e} (rtol {RTOL}, atol {ATOL}) ok | kernel "
                  f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                  f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']}; "
                  f"{bound['pairs_needed']} pairs need the MLP, "
                  f"{bound['pairs_id_tested']} id tests)")
            if name.startswith("path"):
                path_timing = (k_ms, p_ms, bound)

        # ---- 4. backward kernels against plain, three shapes + the path
        train_cfg = cfg.replace(d_input_noise=0.05, d_input_noise_steps=-1,
                                d_input_noise_floor=0.02, n_epochs=200)
        t_tr = Trainer(train_cfg, ds, dev)
        st0 = t_tr.init_state(seed=1)
        tc = chunk_of(t_tr.train_dev, 0)
        t_in, _, t_sx4 = canonicalize_for_rollout(tc["obsvs"], True, True)
        with torch.no_grad():
            t_h = encode_observation(st0.g, obsv_to_4d(t_in))[0]
        bwd_cases = cases[:3] + [("path: train chunk 0", st0.g,
                                  t_sx4.contiguous().cpu().numpy(),
                                  t_h.cpu().numpy(),
                                  tc["scene_ids"].cpu().numpy())]
        bwd_err = {"dq": 0.0, "dkv": 0.0}
        for i, (name, g, x4, h, ids) in enumerate(bwd_cases):
            res = backward_case(torch, sa, name, g, x4, h, ids, seed=100 + i)
            for k in bwd_err:
                bwd_err[k] = max(bwd_err[k], res["err"][k])
        bwd_path = res                 # the last case: the training path
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
        cli_phase(torch, cli_main, npz, work)

        k_ms, p_ms, bound = path_timing
        src = "socialways_torch/kernels/csrc/"
        tpu = "socialways_tpu/kernels/social_attention.py"
        kernels = [{
            "name": "social_attention_fwd",
            "route": "cuda",
            "source": src + "social_attention_fwd.cu",
            "replaces": f"{tpu}:150 (_kernel)",
            "launches": launches_train["fwd"],
            "launches_by_path": {"serving": launches_serving,
                                 "training": launches_train["fwd"]},
            "max_abs_err": max_err,
            "ms": k_ms,
            "kernel_ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "library_ms": None,
            "with_stats_ms": bwd_path["stats_ms"],
        }]
        for key, fn, line in (("dq", "_bwd_dq_kernel", 317),
                              ("dkv", "_bwd_dkv_kernel", 372)):
            kernels.append({
                "name": f"social_attention_bwd_{key}",
                "route": "cuda",
                "source": src + "social_attention_bwd.cu",
                "replaces": f"{tpu}:{line} ({fn})",
                "launches": launches_train[key],
                "max_abs_err": bwd_err[key],
                "ms": bwd_path["ms"][key][0],
                "kernel_ms": bwd_path["ms"][key][0],
                "plain_ms": bwd_path["ms"][key][1],
                "bound_ms": bwd_path["bounds"][key]["bound_ms"],
                "bound_by": bwd_path["bounds"][key]["bound_by"],
                "library_ms": None,
            })
        print(f"train steps/s (epoch 2, loo width, batch {BATCH}): "
              f"{steps_s:.2f}; chip_smoke wall "
              f"{time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
