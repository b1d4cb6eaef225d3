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
2. build every kernel from csrc/ (one nvcc per source, in parallel);
3. each kernel against its plain PyTorch version on the card, f32, at
   rtol 2e-4 / atol 2e-5, timed with CUDA events (median of repeats);
4. the serving slice end to end through the CLI entry points at the loo
   model's full width (hidden 64, batch 256, K 20, 8+12 steps) on a seeded
   synthetic ETH/UCY-scale windowed npz: ``evaluate`` and ``predict`` on
   the card, the kernel's launch count over them, a CPU rerun of the first
   chunks under the same weights and noise, and the K=20 rollout rate;
5. a ``kernels`` JSON line, then the device JSON as the last line.
"""

from __future__ import annotations

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


def median_ms(torch, fn, reps: int = 50, repeats: int = 7) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``reps`` calls
    queued behind a device sleep (so host overhead is hidden), median of
    ``repeats``."""
    for _ in range(5):
        fn()
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


def attention_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                    n_params: int) -> dict:
    """Least time of the social-attention forward on this input: the needed
    FLOP (same-scene ordered pairs x the 3->32->64->F MLP and the score,
    plus wh = h W + b) at the f32 peak, against the bytes of x4, ids, h,
    the weights and out at the HBM rate."""
    valid = ids[ids >= 0]
    _, sizes = np.unique(valid, return_counts=True)
    pairs = int(np.sum(sizes * (sizes - 1)))
    mac = pairs * (3 * 32 + 32 * 64 + 64 * feat + 2 * feat) + n * hdim * feat
    flop = 2 * mac
    nbytes = 4 * (4 * n + n + 2 * n * hdim + n_params)
    ops_ms = flop / H100_F32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"pairs_needed": pairs,
            "pairs_id_tested": n * 32 * ((n + 31) // 32),
            "flop": flop, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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
    _build.build(["social_attention_fwd"])
    print(f"build: social_attention_fwd in {time.perf_counter() - tic:.2f} s")
    for line in _build.build_logs.get("social_attention_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

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

        # ---- 3. kernel against plain on the card
        rng = np.random.RandomState(0)
        cases = []
        for name, n, hdim, scene in [
                ("eth-like N=256 H=F=64", 256, 64, 0),
                ("eth-like N=256 H=F=32", 256, 32, 0),
                ("scenes of 64 N=2048 H=F=64", 2048, 64, 64)]:
            g = init_generator(cfg.replace(hidden_size=hdim,
                                           social_feature_size=hdim,
                                           noise_len=hdim // 2),
                               torch.Generator().manual_seed(n + hdim), dev)
            cases.append((name, g) + attention_inputs(rng, n, hdim, scene))
        # the path's own input: test chunk 0 as the serving path builds it
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
                bad = err > ATOL + RTOL * want.abs()
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(
                        f"social_attention_fwd disagrees with plain on {name}:"
                        f" max abs {float(err.max()):.3e}, {int(bad.sum())} "
                        f"elements over rtol {RTOL} / atol {ATOL}")
                k_ms = median_ms(torch, lambda: sa.social_attention_fwd(*args))
                p_ms = median_ms(torch,
                                 lambda: sa.social_attention_plain(*args))
            n, hdim = h.shape
            n_params = sum(t.numel() for m in (g.feat_mlp, g.attn_w)
                           for t in m.parameters())
            bound = attention_bound(ids, n, hdim, g.attn_w.w.shape[1],
                                    n_params)
            max_err = max(max_err, float(err.max()))
            print(f"kernel vs plain [{name}]: max abs {float(err.max()):.3e} "
                  f"max rel {rel:.3e} (rtol {RTOL}, atol {ATOL}) ok | kernel "
                  f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
                  f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']}; "
                  f"{bound['pairs_needed']} pairs need the MLP, "
                  f"{bound['pairs_id_tested']} id tests)")
            if name.startswith("path"):
                path_timing = (k_ms, p_ms, bound)

        # ---- 4. the slice end to end through the CLI, on the card
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
        launches = sa.social_attention_fwd.launches
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
        print(f"predict: {n_win} windows, {launches - launches_eval} kernel "
              f"launches, {predict_s:.3f} s wall (CLI, incl. load)")

        # CUDA vs CPU on the first chunks, same weights and noise
        trainer_cpu = Trainer(cfg, ds, "cpu")
        gen_ref = restore_generator(ckpt, cfg, "cpu")[0]
        noise_rng = torch.Generator().manual_seed(5)
        worst = 0.0
        for i in range(min(3, n_chunks)):
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
        print(f"cuda vs cpu: first {min(3, n_chunks)} chunks, rollout max "
              f"abs diff {worst:.3e} (atol 1e-4, normalized units), sums "
              f"within rel 1e-4")

        ev = trainer.evaluate(gen, cfg.seed)
        print(f"ADE/FDE avg {ev['ade_avg']:.4f}/{ev['fde_avg']:.4f} min-of-"
              f"{K} {ev['ade_min']:.4f}/{ev['fde_min']:.4f} (random "
              f"weights, meters)")

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

        from torch.profiler import ProfilerActivity, profile
        c = chunk_of(trainer.test_dev, 0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            k_sample_rollout(gen, c["obsvs"], c["scene_ids"], K, cfg, rng_dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - tic) * 1e6
        dev_events = [e for e in prof.events()
                      if e.device_type.name == "CUDA"]
        busy_us = sum(e.device_time for e in dev_events)
        print(f"profile of one chunk's K={K} rollout: {len(dev_events)} "
              f"device kernels/copies, {busy_us:.1f} us device time in "
              f"{wall_us:.1f} us wall (device idle "
              f"{1 - busy_us / wall_us:.1%}, profiler on)")
        by_name = {}
        for e in dev_events:
            n_t = by_name.setdefault(e.name, [0, 0.0])
            n_t[0] += 1
            n_t[1] += e.device_time
        for name, (cnt, us) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][1])[:6]:
            print(f"  {us:9.1f} us {cnt:4d}x {name[:90]}")

        k_ms, p_ms, bound = path_timing
        kernels = [{
            "name": "social_attention_fwd",
            "route": "cuda",
            "source": "socialways_torch/kernels/csrc/social_attention_fwd.cu",
            "replaces": "socialways_tpu/kernels/social_attention.py:150 "
                        "(_kernel)",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": k_ms,
            "kernel_ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "library_ms": None,
        }]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
