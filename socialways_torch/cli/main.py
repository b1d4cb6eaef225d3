"""Command-line entry points of the port: training, serving, the
real-data pipeline and the toy protocol.

    python -m socialways_torch.cli.main create-dataset obsmat.txt hotel-8-12.npz
    python -m socialways_torch.cli.main create-toy --npz toy.npz
    python -m socialways_torch.cli.main train --recipe loo --data hotel-8-12.npz --epochs 100
    python -m socialways_torch.cli.main train --recipe toy-flagship --data toy.npz --dump-dir dumps --track-coverage
    python -m socialways_torch.cli.main stats --preds-dir dumps/hotel/socialWays --real-npz toy.npz --plot curves.png
    python -m socialways_torch.cli.main visualize --preds-dir dumps/hotel/socialWays --out figs
    python -m socialways_torch.cli.main animate --npz toy.npz --out toy.gif
    python -m socialways_torch.cli.main plot-tracks annotations.txt --parser sdd --out tracks.png
    python -m socialways_torch.cli.main sweep --data toy.npz --unrolls 0,1,5 --info-weights 0.0,1.0
    python -m socialways_torch.cli.main eth-ucy --data-dir ethucy/ --epochs 30000
    python -m socialways_torch.cli.main evaluate --data hotel-8-12.npz --model-file ckpt.npz
    python -m socialways_torch.cli.main evaluate --data hotel-8-12.npz --linear kalman
    python -m socialways_torch.cli.main predict --data hotel-8-12.npz --model-file ckpt.npz --out preds.npz
    python -m socialways_torch.cli.main predict --data obsmat.txt --model-file ckpt.npz
    python -m socialways_torch.cli.main simulate --agents 10000 --scene-size 16 --model-file ckpt.npz
    python -m socialways_torch.cli.main --cpu train ...   # run on the CPU
    python -m socialways_torch.cli.main --cpu --cpu-devices 4 train --mesh 4 ...

Flags, outputs and printouts follow socialways_tpu/cli/main.py:475-516
(create-toy, create-dataset), :519-819 (train), :822-974 (evaluate,
predict), :977-1036 (sweep), :1039-1101 (eth-ucy), :1104-1169 (simulate)
and :1172-1225 (stats, animate, plot-tracks, visualize).
Everything that runs a model runs on the GPU unless ``--cpu`` is given;
``create-*``, ``stats``, ``visualize``, ``animate`` and ``plot-tracks``
are host-only (numpy in, files out; viz/ imports matplotlib and cv2 where
it uses them).  Every command that takes a model (``train``,
``evaluate``, ``predict``, ``sweep``, ``eth-ucy``, ``simulate``) takes
JAX's whole model flag set and recipes (``_add_train_flags``) and builds
its config with the one ``_train_cfg``, as JAX's commands take its
``_add_model_flags`` and ``_cfg_from_args``: each subcommand's options
are JAX's, but for ``eth-ucy``'s ``--compare-reference`` and
``--ref-epochs`` (they run the upstream reference, which is not in the
repository) and ``simulate``'s ``--no-pallas``.  Among them are JAX's loop
flags (``--fused-epochs``, ``--block-size``, ``--host-loop``,
``--latent-dim``, ``--pallas``, ``--mesh``): ``train --fused-epochs``
prints, logs, checkpoints and evaluates once a block of epochs as JAX
does, and reads the metrics once a block; on the card every training step
is a replay of a captured CUDA graph of the step (JAX's epoch on the
device) unless ``--host-loop`` asks for the eager per-chunk loop, bit for
bit the same steps; with ``--mesh`` on NCCL ranks every data-parallel step
is such a replay too, its all-reduces captured with it, and
``--host-loop`` runs it eagerly; ``--cpu`` trains eagerly.  The kernels
run on the card whatever ``--pallas`` says.  ``train --mesh N`` (or
``AxB``) trains data-parallel over N ranks (parallel/mesh.py): N cards
on NCCL, or with ``--cpu --cpu-devices N`` N gloo processes on the CPU;
inside ``torchrun`` each process is one rank.  Rank 0 alone prints and
writes checkpoints, logs, dumps and traces; every rank evaluates, since
the data-parallel eval reduces over the ranks.  NCCL takes one card a
rank, so one card runs ``--mesh 1``.  The other commands take ``--mesh``
and ignore it, as JAX's do.
``--bf16`` runs the forward math of every command that takes a model in
bfloat16 (the attention kernels' bf16 mode on the card), with float32
master weights, losses, gradients and optimizer state.
``--max-scene-size`` (a bound on rows per scene, ids sorted and
contiguous) lets the social attention scan scene windows on every
subcommand that runs a model.  ``simulate`` has no ``--no-pallas``: on the
card the CUDA kernel is its only path.  The loop's outputs and rescues
(dumps, metrics log, profiler trace, coverage, ``--auto-recover``, ...)
are ``train``'s alone: ``eth-ucy`` and ``sweep`` refuse them when they
are given on the command line rather than ignore them (a recipe's bundle
may bring them: ``sweep --recipe robust1`` carries ``--auto-recover``,
read by nothing, as in JAX); ``evaluate``, ``predict`` and ``simulate``
accept them and the ``--ade-stall-*`` flags, as JAX's do, read none of
them, and print one stderr NOTE naming each one given.  ``eth-ucy`` takes
``--recipe loo`` alone, and without ``--recipe`` runs it (``--recipe=``
opts out).  The structure flags of a served model (the widths,
``--decoder``, ``--noise-dist``, ``--latent-code``, ``--n-latent-codes``,
``--pac``, ``--mb-std``, ``--spectral-norm``, ``--use-social``,
``--agent-frame``, ``--g-ema-decay``) set the config before a
checkpoint's embedded config is adopted, which wins with a warning; a
checkpoint without one (JAX's before it embedded it) is served as the
flags name it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time
from typing import Callable

import numpy as np
import torch


#: ``--recipe NAME`` expands to these flags right after the subcommand, so
#: explicit flags override them (socialways_tpu/cli/main.py:27-58, token for
#: token).  The toy protocol's bundles: robust1 = categorical codes + a
#: cooled D + the divergence rescue; inoise2 = + D instance noise annealed
#: over the run; toy-flagship = + agent frame, social attention and EMA.
#: loo is the record real-data arm: agent frame + social attention + EMA +
#: annealed D instance noise with a 0.02 floor + the signature-gated
#: ADE-stall rescue.
RECIPES = {
    "robust1": ["--latent-code", "categorical", "--n-latent-codes", "3",
                "--d-lr", "5e-4", "--info-weight", "1.0",
                "--d-lr-decay-rate", "0.7", "--d-lr-decay-steps", "10000",
                "--auto-recover"],
}
RECIPES["inoise2"] = RECIPES["robust1"] + [
    "--d-input-noise", "0.05", "--d-input-noise-steps", "-1"]
RECIPES["toy-flagship"] = RECIPES["inoise2"] + [
    "--agent-frame", "--use-social", "--g-ema-decay", "0.999"]
RECIPES["loo"] = ["--agent-frame", "--use-social", "--g-ema-decay", "0.999",
                  "--d-input-noise", "0.05", "--d-input-noise-steps", "-1",
                  "--d-input-noise-floor", "0.02",
                  "--ade-stall-recover", "-1", "--ade-stall-classify", "5"]

#: deprecated recipe names -> their replacement (expanded with a note)
RECIPE_ALIASES = {"flagship": "toy-flagship"}
ALL_RECIPES = list(RECIPES) + list(RECIPE_ALIASES)

#: train's loop outputs and rescues (``_add_loop_flags``), read by train
#: alone, and the ADE-stall rescue's flags, read by train and eth-ucy
_LOOP_OUTPUTS = ("dump_dir", "lnr_model", "metrics_log", "profile_dir",
                 "auto_recover", "track_coverage", "stall_recover",
                 "stall_reset_d", "rescue_keep_clock")
_ADE_STALL = ("ade_stall_recover", "ade_stall_grace",
              "ade_stall_max_rescues", "ade_stall_classify")
#: flags a command refuses when they are given on its command line: it
#: writes none of those outputs (a recipe's bundle may still bring them)
_REFUSED = {"eth-ucy": _LOOP_OUTPUTS, "sweep": _LOOP_OUTPUTS}
#: flags a command accepts and reads nothing of, as JAX's do (the recipes
#: bring --auto-recover and the --ade-stall-* flags): a NOTE names each
#: one given on its command line
_IGNORED = {"evaluate": _LOOP_OUTPUTS + _ADE_STALL,
            "predict": _LOOP_OUTPUTS + _ADE_STALL,
            "simulate": tuple(f for f in _LOOP_OUTPUTS + _ADE_STALL
                              if f != "profile_dir"),
            "sweep": _ADE_STALL}


def _add_loop_mode_flags(p: argparse.ArgumentParser) -> None:
    """JAX's loop flags, on every command that takes a model
    (socialways_tpu/cli/main.py:134, 181, 187, 381, 386)."""
    p.add_argument("--latent-dim", "--ld", type=int, default=10,
                   help="the reference's --latent-dim (read by nothing)")
    p.add_argument("--host-loop", action="store_true",
                   help="per-chunk host loop (eager steps) instead of "
                        "epoch-on-device (a replayed CUDA graph a step)")
    p.add_argument("--pallas", action="store_true",
                   help="use the fused social-attention kernels (the port "
                        "runs its CUDA kernels on the card anyway)")
    p.add_argument("--block-size", type=int, default=0,
                   help="fused-epoch block size (0 = gcd of the test and "
                        "save intervals)")
    p.add_argument("--fused-epochs", action="store_true",
                   help="train blocks of epochs: one print, one metrics "
                        "row and one divergence check a block; save and "
                        "eval at block ends (train only)")
    p.add_argument("--mesh", type=str, default="0",
                   help="train data-parallel over N ranks, one a device: "
                        "chunk groups of N, gradients count-weighted and "
                        "averaged over the ranks every step (an epoch has "
                        "ceil(chunks/N) steps; 0 = off).  'AxB' (e.g. 2x4) "
                        "is the hierarchical (dcn, data) mesh of A x B "
                        "ranks.  Acted on by train only")


def _load_generator(args, cfg, device):
    """The checkpoint's generator, or a fresh one drawn from ``cfg.seed``
    when no checkpoint is given."""
    from socialways_torch.io.checkpoint import restore_generator
    from socialways_torch.models import init_model
    if args.model_file:
        gen, epoch, scale = restore_generator(args.model_file, cfg, device)
        print(f"loaded {args.model_file} (epoch {epoch})")
        return gen, epoch, scale
    gen = init_model(cfg, torch.Generator().manual_seed(cfg.seed), device)
    return gen, 0, None


def cmd_create_toy(args) -> int:
    from socialways_torch.data.toy import (create_toy_samples,
                                           make_toy_npz_arrays, write_toy_txt)
    arrays = make_toy_npz_arrays(n_samples=args.n_samples,
                                 n_conditions=args.n_conditions,
                                 n_modes=args.n_modes,
                                 n_per_batch=args.n_per_batch,
                                 seed=args.seed)
    if args.npz:
        np.savez(args.npz, **arrays)
        print(f"wrote {args.npz}: obsvs {arrays['obsvs'].shape}, "
              f"{len(arrays['batches'])} scene batches")
    if args.txt:
        rng = np.random.RandomState(args.seed)
        samples, stamps = create_toy_samples(
            args.n_samples, args.n_conditions, args.n_modes,
            args.n_per_batch, rng=rng)
        write_toy_txt(samples, stamps, args.txt)
        print(f"wrote {args.txt}")
    return 0


def cmd_create_dataset(args) -> int:
    from socialways_torch.data.parsers import PARSERS
    from socialways_torch.data.windowing import create_dataset
    p = PARSERS[args.parser]()
    p.load(args.input, down_sample=args.down_sample)
    if not p.p_data:
        raise SystemExit(f"error: no trajectories parsed from {args.input} "
                         f"with the '{args.parser}' parser — wrong format?")
    interval = p.interval if p.interval > 0 else 1
    # the half-open range of the JAX CLI (eth-ucy's scene build closes it)
    t_range = range(int(p.min_t), int(p.max_t), interval)
    obsvs, preds, times, batches = create_dataset(
        p.p_data, p.t_data, t_range, n_past=args.n_past, n_next=args.n_next)
    np.savez(args.output, obsvs=obsvs, preds=preds, times=times,
             batches=batches)
    print(f"wrote {args.output}: {obsvs.shape[0]} samples "
          f"({args.n_past} obs / {args.n_next} pred), "
          f"{len(batches)} scene batches, interval {interval}")
    return 0


def cmd_evaluate(args, device) -> int:
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.io.checkpoint import adopt_checkpoint_config

    cfg = _train_cfg(args)
    if args.model_file:
        cfg = adopt_checkpoint_config(cfg, args.model_file)
    ds = load_npz_dataset(args.data)
    trainer = Trainer(cfg, ds, device)
    cfg = trainer.cfg
    gen, _, _ = _load_generator(args, cfg, device)

    if args.linear:
        from socialways_torch.eval.metrics import k_sample_errors
        from socialways_torch.ops.kalman import predict_kalman
        from socialways_torch.ops.traj import predict_cv
        lnr_fn = predict_kalman if args.linear == "kalman" else predict_cv
        total_ade = total_fde = 0.0
        n = 0
        for i in range(trainer.test_packed.n_chunks):
            chunk = chunk_of(trainer.test_dev, i)
            lnr = lnr_fn(chunk["obsvs"], cfg.n_next)
            err = k_sample_errors(lnr[None], chunk["preds"])[0]
            valid = chunk["valid"]
            total_ade += float(err.mean(dim=-1)[valid].sum())
            total_fde += float(err[:, -1][valid].sum())
            n += int(valid.sum())
        ss = ds.ss
        print(f"Linear baseline ({args.linear}): ADE,FDE ({cfg.n_next}) = "
              f"({total_ade / ss / max(n, 1):.3f}, "
              f"{total_fde / ss / max(n, 1):.3f})")
        return 0

    ev = trainer.evaluate(gen, cfg.seed, n_gen_samples=args.n_gen_samples)
    print(f"Avg ADE,FDE ({cfg.n_next})= ({ev['ade_avg']:.3f}, "
          f"{ev['fde_avg']:.3f}) | Min({args.n_gen_samples}) ADE,FDE "
          f"({cfg.n_next})= ({ev['ade_min']:.3f}, {ev['fde_min']:.3f})")
    return 0


def cmd_predict(args, device) -> int:
    """Inference-only forecasting from a checkpoint — the serving path: (a)
    every window of a ``create-dataset`` npz, or (b) everyone in the scene
    at ``--at-time`` of a RAW annotation file (``data/forecast.py`` builds
    the observation-only windows).  Normalization uses the CHECKPOINT's
    Scale, never one refit on the inference data."""
    from socialways_torch.data.dataset import pack_scene_batches
    from socialways_torch.eval.metrics import draw_noise, k_sample_rollout
    from socialways_torch.io.checkpoint import adopt_checkpoint_config
    from socialways_torch.ops.traj import predict_cv

    cfg = adopt_checkpoint_config(_train_cfg(args), args.model_file)
    agent_idx = at_time = None
    # explicit flags win, else the checkpoint's training horizons
    n_past = args.n_past if args.n_past is not None else cfg.n_past
    n_next = args.n_next if args.n_next is not None else cfg.n_next
    if args.data.endswith(".npz"):
        with np.load(args.data) as d:
            obsvs_w = np.asarray(d["obsvs"], np.float32)      # world coords
            batches = np.asarray(d["batches"], np.int64)
            if "preds" in d.files:   # windowed training npz: its horizon
                n_next = d["preds"].shape[1]
    else:
        from socialways_torch.data.forecast import forecast_windows
        from socialways_torch.data.parsers import PARSERS
        p = PARSERS[args.parser]()
        p.load(args.data, down_sample=args.down_sample)
        obsvs_w, agent_idx, at_time = forecast_windows(
            p.p_data, p.t_data, n_past=n_past,
            at_time=args.at_time if args.at_time >= 0 else None)
        obsvs_w = obsvs_w.astype(np.float32)
        batches = np.asarray([[0, len(obsvs_w)]], np.int64)
        print(f"forecasting {len(obsvs_w)} agents at t={at_time}")
    cfg = cfg.replace(n_past=obsvs_w.shape[1], n_next=n_next)

    gen, epoch, scale = _load_generator(args, cfg, device)
    if scale is None:
        raise SystemExit("error: checkpoint carries no Scale — cannot "
                         "normalize inference data consistently with "
                         "training")

    obsvs_n = scale.normalize(obsvs_w)
    zeros_pred = np.zeros((len(obsvs_n), cfg.n_next, 2), np.float32)
    packed = pack_scene_batches(obsvs_n, zeros_pred, batches,
                                args.batch_size)
    k = args.n_gen_samples
    rng = torch.Generator(device=device)
    rng.manual_seed(cfg.seed)
    preds_n = np.empty((k, len(obsvs_n), cfg.n_next, 2), np.float32)
    lnr_n = np.empty((len(obsvs_n), cfg.n_next, 2), np.float32)
    for ci in range(packed.n_chunks):
        obsv = torch.from_numpy(packed.obsvs[ci]).to(device)
        ids = torch.from_numpy(packed.scene_ids[ci]).to(device)
        noise = draw_noise(k, packed.width, cfg, rng, device)
        out = k_sample_rollout(gen, obsv, ids, k, cfg, noise=noise)
        out = out[..., :2].cpu().numpy()
        cv = predict_cv(obsv, cfg.n_next).cpu().numpy()
        rows = np.flatnonzero(packed.valid[ci])
        orig = packed.row_map[ci][rows]        # original window indices
        preds_n[:, orig] = out[:, rows]
        lnr_n[orig] = cv[rows]

    payload = {
        "obsvs": obsvs_w,
        "preds_our": scale.denormalize(preds_n),
        "preds_lnr": scale.denormalize(lnr_n),
        "epoch": np.asarray(epoch, np.int64),
        "k": np.asarray(k, np.int64),
    }
    if agent_idx is not None:
        payload["agent_idx"] = agent_idx
        payload["timestamp"] = np.asarray(at_time, np.int64)
    np.savez(args.out, **payload)
    print(f"wrote {args.out}: preds_our {payload['preds_our'].shape} "
          f"(K={k}, world units) + CV baseline")
    return 0


def _add_gan_flags(p: argparse.ArgumentParser) -> None:
    """The run's length, model and GAN-step flags that train, eth-ucy and
    sweep share (the JAX names and defaults,
    socialways_tpu/cli/main.py:130-346)."""
    p.add_argument("--epochs", "--e", type=int, default=1000)
    p.add_argument("--batch-size", "--b", type=int, default=256)
    p.add_argument("--hidden-size", "--h-size", type=int, default=64)
    p.add_argument("--g-learning-rate", "--g-lr", type=float, default=1e-4)
    p.add_argument("--d-learning-rate", "--d-lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-gen-samples", "--k", type=int, default=20)
    p.add_argument("--use-social", action="store_true",
                   help="social attention pooling (the paper's mechanism)")
    p.add_argument("--agent-frame", action="store_true",
                   help="per-agent canonical heading frames (pairwise "
                        "social geometry stays world-frame)")
    p.add_argument("--g-ema-decay", type=float, default=0.0,
                   help="EMA of the generator (e.g. 0.999); evaluation, "
                        "dumps and the best checkpoints use it (0 = off)")
    p.add_argument("--d-input-noise", type=float, default=0.0,
                   help="D instance noise: Gaussian std on the prediction "
                        "inputs of every D evaluation (0 = off)")
    p.add_argument("--d-input-noise-steps", type=int, default=0,
                   help="anneal --d-input-noise linearly to 0 over this "
                        "many GAN steps (0 = constant; -1 = the whole run)")
    p.add_argument("--d-input-noise-floor", type=float, default=0.0,
                   help="clamp the annealed noise std from below")
    p.add_argument("--unrolling-steps", "--unroll", type=int, default=1,
                   help="lookahead D updates before the G update")
    p.add_argument("--d-restore", default="full",
                   choices=["full", "reference", "none"],
                   help="D after the G update: the post-first-update "
                        "snapshot (full), its linear layers only "
                        "(reference, the reference's partial restore) or "
                        "the unrolled D (none)")
    p.add_argument("--no-info-loss", action="store_true")
    p.add_argument("--info-weight", type=float, default=0.5)
    p.add_argument("--n-latent-codes", type=int, default=2)
    p.add_argument("--latent-code", default="continuous",
                   choices=["continuous", "categorical"],
                   help="InfoGAN code: continuous (MSE Q-loss on the first "
                        "noise dims, reference parity) or categorical "
                        "(one-hot code + cross-entropy Q-loss)")
    p.add_argument("--lr-decay-rate", type=float, default=1.0,
                   help="staircase exponential lr decay factor for both "
                        "optimizers (1.0 = constant)")
    p.add_argument("--lr-decay-steps", type=int, default=0,
                   help="optimizer updates per decay stair")
    p.add_argument("--d-lr-decay-rate", type=float, default=1.0,
                   help="D-only staircase lr decay factor (overrides the "
                        "shared schedule for D)")
    p.add_argument("--d-lr-decay-steps", type=int, default=0,
                   help="optimizer updates per D-only decay stair")
    p.add_argument("--lr-warmup-steps", type=int, default=0,
                   help="linear lr warmup over the first N optimizer "
                        "updates, both optimizers (0 = off)")
    p.add_argument("--d-lr-warmup-steps", type=int, default=0,
                   help="D-only lr warmup override (0 = use "
                        "--lr-warmup-steps)")
    p.add_argument("--info-weight-end", type=float, default=0.0,
                   help="ramp the info weight linearly from --info-weight "
                        "to this over --info-weight-steps GAN steps (0 = "
                        "constant, reference parity)")
    p.add_argument("--info-weight-steps", type=int, default=0)
    p.add_argument("--decoder", default="fc", choices=["fc", "lstm"])
    p.add_argument("--noise-dist", default=None,
                   choices=["uniform", "gaussian"],
                   help="generator noise distribution (default uniform, as "
                        "the reference draws U(0,1), torch.rand at "
                        "train.py:473; --model sgan draws gaussian and "
                        "refuses uniform)")
    p.add_argument("--use-l2-loss", action="store_true")
    p.add_argument("--use-variety-loss", action="store_true")
    p.add_argument("--l2-weight", type=float, default=0.5)
    p.add_argument("--r1-gamma", type=float, default=0.0,
                   help="R1 gradient penalty weight on the real-data D "
                        "output (0 = off, reference behavior)")
    p.add_argument("--pac", type=int, default=1,
                   help="PacGAN: the LSGAN classifier scores packs of "
                        "this many consecutive samples (one label per "
                        "pack); the InfoGAN Q-head stays per-sample (1 = "
                        "off, reference parity)")
    p.add_argument("--spectral-norm", action="store_true",
                   help="SN-GAN: spectrally normalize D's feed-forward "
                        "Linear weights at every evaluation (stateless "
                        "power iteration; Q-head and LSTM untouched)")
    p.add_argument("--mb-std", action="store_true",
                   help="ProGAN minibatch stddev: append the fake/real "
                        "block's diversity scalar to D's classifier input")
    p.add_argument("--ms-weight", type=float, default=0.0,
                   help="MSGAN mode-seeking regularizer weight: the G "
                        "loss adds w/(r+1e-5) with r = output-diversity / "
                        "latent-distance between noise draws (0 = off)")
    p.add_argument("--ds-weight", type=float, default=0.0,
                   help="DSGAN diversity hinge weight: per-sample "
                        "max(0, tau - d_i/dz_i) over extra rollouts (0 = "
                        "off)")
    p.add_argument("--ds-tau", type=float, default=1.0,
                   help="diversity-ratio target for --ds-weight")
    p.add_argument("--ds-k", type=int, default=2,
                   help="rollouts pooled by the diversity regularizers "
                        "(d_i/dz_i = mean over all K(K-1)/2 pairs; K-1 "
                        "extra rollouts)")
    p.add_argument("--d-update-every", type=int, default=1,
                   help="run the D phase only on every k-th GAN step "
                        "(skipped steps leave D untouched and train G "
                        "against the current D; 1 = reference parity)")
    p.add_argument("--d-update-every-end", type=int, default=0,
                   help="warmup-style D/G ratio schedule: switch "
                        "--d-update-every to this value after "
                        "--d-update-every-switch steps (0 = constant)")
    p.add_argument("--d-update-every-switch", type=int, default=0,
                   help="G-step count at which the D/G ratio switches")
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off, reference "
                        "behavior)")
    p.add_argument("--serial-rollout", action="store_true",
                   help="the D phase sees a no-grad rollout and the G "
                        "phase recomputes it under grad: the two phases' "
                        "saved activations are never held together")
    p.add_argument("--remat-steps", action="store_true",
                   help="checkpoint the LSTM and decode steps in training "
                        "(recomputed in the backward: less memory, more "
                        "compute)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="exact gradient accumulation over N micro-chunks "
                        "per step (valid-share-weighted; equals the "
                        "full-batch gradient). Batch rows must divide by "
                        "N and (with --use-social) scene boundaries must "
                        "align to chunk boundaries")
    p.add_argument("--max-scene-size", type=int, default=0,
                   help="static bound on agents per scene (ids sorted + "
                        "contiguous): the social attention scans only each "
                        "agent's scene window, O(N*max_scene) at crowd "
                        "scale (0 = unknown)")
    p.add_argument("--bf16", action="store_true",
                   help="run generator/discriminator forward math in "
                        "bfloat16 (f32 master params, f32 losses); float32 "
                        "remains the parity default")
    _add_loop_mode_flags(p)


def _add_train_flags(p: argparse.ArgumentParser, recipes) -> None:
    """JAX's whole model flag set (socialways_tpu/cli/main.py:112-400), on
    every command that takes a model: a recipe out of ``recipes``, the
    checkpoint layout, the ADE-stall rescue, the GAN flags and train's loop
    outputs and rescues.  ``parse_args`` refuses or notes the flags a
    command does not read (``_REFUSED``, ``_IGNORED``)."""
    p.add_argument("--recipe", default="", choices=[""] + list(recipes),
                   help="expand a documented flag bundle; explicit flags "
                        "override it.  Real data: 'loo' = the record arm "
                        "(--agent-frame --use-social --g-ema-decay 0.999 "
                        "+ D instance noise 0.05 annealed over the run to "
                        "a 0.02 floor + the signature-gated ADE-stall "
                        "rescue).  Toy protocol: robust1 = categorical "
                        "codes + cooled D + --auto-recover; inoise2 = + "
                        "annealed D instance noise; toy-flagship = + agent "
                        "frame, social attention and EMA")
    p.add_argument("--test-interval", type=int, default=5)
    p.add_argument("--save-interval", type=int, default=50)
    p.add_argument("--model-dir", default="trained_models")
    p.add_argument("--model", "--m", default="socialWays",
                   choices=["socialWays", "sgan"],
                   help="socialWays, or sgan: Social GAN with its pooling "
                        "module (arXiv:1803.10892), served only (simulate, "
                        "predict, evaluate; its widths: --embedding-dim "
                        "and the flags beside it)")
    p.add_argument("--dataset", "--data-name", default="hotel")
    p.add_argument("--ade-stall-recover", type=int, default=0,
                   help="after N evals without a >2%% better min-K ADE, "
                        "restore the best checkpoint with a re-initialized "
                        "discriminator (0 = off; -1 = fire only on the "
                        "--ade-stall-classify signature)")
    p.add_argument("--ade-stall-grace", type=int, default=2,
                   help="skip stall counting for G evals after a rescue")
    p.add_argument("--ade-stall-max-rescues", type=int, default=3,
                   help="stop rescuing after M consecutive rescues without "
                        "a new best (0 = unlimited)")
    p.add_argument("--ade-stall-classify", type=int, default=0,
                   help="fire after N flat evals matching the under-fit "
                        "or diversity-collapse signature (0 = off)")
    _add_gan_flags(p)
    _add_loop_flags(p)


def _add_sgan_flags(p: argparse.ArgumentParser) -> None:
    """Social GAN's widths (sgan's ``--embedding_dim``,
    ``--encoder_h_dim_g``, ``--decoder_h_dim_g``, ``--mlp_dim``,
    ``--bottleneck_dim``, ``--noise_dim``; its documented training
    command's values), read with ``--model sgan`` on the serving
    commands."""
    p.add_argument("--embedding-dim", type=int, default=16)
    p.add_argument("--encoder-h-dim", type=int, default=32)
    p.add_argument("--decoder-h-dim", type=int, default=32)
    p.add_argument("--mlp-dim", type=int, default=64)
    p.add_argument("--bottleneck-dim", type=int, default=32)
    p.add_argument("--noise-dim", type=int, default=8,
                   help="--model sgan: the noise width (N(0, I), one draw "
                        "a scene)")


def _refuse_untrainable(args) -> bool:
    """Print why ``args.model`` cannot be trained (True), or False."""
    from socialways_torch.config import check_trainable
    try:
        check_trainable(_train_cfg(args))
    except NotImplementedError as err:
        print(f"error: {err}", file=sys.stderr)
        return True
    return False


def _add_loop_flags(p: argparse.ArgumentParser) -> None:
    """train's outputs and rescues (socialways_tpu/cli/main.py:177-254,
    350-357)."""
    p.add_argument("--dump-dir", default="",
                   help="each test interval, dump the first test chunk's "
                        "K predictions in the reference's npz schema under "
                        "DIR/<dataset>/socialWays/<epoch>/")
    p.add_argument("--lnr-model", default="cv", choices=["cv", "kalman"],
                   help="linear baseline written to the dumps' preds_lnr "
                        "(cv = reference parity)")
    p.add_argument("--metrics-log", default="",
                   help="append one JSON line per train epoch, eval, "
                        "coverage eval and rescue to this file")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler Chrome trace of the second "
                        "epoch of the run (the first holds the kernels' "
                        "build) into this directory")
    p.add_argument("--auto-recover", action="store_true",
                   help="on training divergence (non-finite train ADE or "
                        "> 5x the best + 0.1), restore the best checkpoint "
                        "and continue")
    p.add_argument("--track-coverage", action="store_true",
                   help="also score toy mode coverage at each eval and "
                        "keep the best-coverage checkpoint (-bestcov.npz)")
    p.add_argument("--stall-recover", type=int, default=0,
                   help="with --track-coverage: after N consecutive "
                        "coverage evals without a new best, restore the "
                        "best-coverage checkpoint and continue (0 = off)")
    p.add_argument("--stall-reset-d", action="store_true",
                   help="with --stall-recover: also re-initialize the "
                        "discriminator (params + optimizer) on each stall "
                        "rescue")
    p.add_argument("--rescue-keep-clock", action="store_true",
                   help="checkpoint-restore rescues (--auto-recover, "
                        "--stall-recover, the ADE-stall rescue) keep the "
                        "optimizer step counts instead of rewinding them, "
                        "so count-keyed schedules (the instance-noise "
                        "anneal, lr decay) continue forward")


def _train_cfg(args):
    """The config of any command that takes a model, from its flags (JAX's
    one ``_cfg_from_args``, socialways_tpu/cli/main.py:402-470); a
    checkpoint's embedded config is adopted over it afterwards."""
    from socialways_torch.config import TrainConfig
    if args.d_lr_decay_rate != 1.0 and args.d_lr_decay_steps == 0:
        print("WARNING: --d-lr-decay-rate is ignored without "
              "--d-lr-decay-steps > 0 (the D optimizer falls back to the "
              "shared --lr-decay-* schedule)", file=sys.stderr)
    h = args.hidden_size
    sgan = {}
    if args.model == "sgan":
        sgan = dict(noise_len=getattr(args, "noise_dim", 8))
        for f in ("embedding_dim", "encoder_h_dim", "decoder_h_dim",
                  "mlp_dim", "bottleneck_dim"):
            if hasattr(args, f):
                sgan[f] = getattr(args, f)
    noise_dist = args.noise_dist or ("gaussian" if args.model == "sgan"
                                     else "uniform")
    cfg = TrainConfig(
        dataset=args.dataset,
        batch_size=args.batch_size, n_epochs=args.epochs,
        lr_g=args.g_learning_rate, lr_d=args.d_learning_rate,
        n_unrolling_steps=args.unrolling_steps,
        use_info_loss=not args.no_info_loss, loss_info_w=args.info_weight,
        loss_info_w_end=args.info_weight_end,
        loss_info_w_steps=args.info_weight_steps,
        d_restore=args.d_restore,
        hidden_size=h, social_feature_size=h, noise_len=h // 2,
        latent_dim=args.latent_dim, use_pallas=args.pallas,
        epoch_on_device=not args.host_loop, decoder=args.decoder,
        noise_dist=noise_dist,
        n_latent_codes=args.n_latent_codes,
        latent_code_type=args.latent_code,
        use_l2_loss=args.use_l2_loss,
        use_variety_loss=args.use_variety_loss, loss_l2_w=args.l2_weight,
        r1_gamma=args.r1_gamma, pac=args.pac,
        spectral_norm=args.spectral_norm, mb_std=args.mb_std,
        ms_weight=args.ms_weight, ds_weight=args.ds_weight,
        ds_tau=args.ds_tau, ds_k=args.ds_k,
        d_update_every=args.d_update_every,
        d_update_every_end=args.d_update_every_end,
        d_update_every_switch=args.d_update_every_switch,
        grad_clip=args.grad_clip, serial_rollout=args.serial_rollout,
        remat_steps=args.remat_steps, grad_accum=args.grad_accum,
        max_scene_size=args.max_scene_size,
        use_social=args.use_social, agent_frame=args.agent_frame,
        d_input_noise=args.d_input_noise,
        d_input_noise_steps=args.d_input_noise_steps,
        d_input_noise_floor=args.d_input_noise_floor,
        g_ema_decay=args.g_ema_decay,
        lr_decay_rate=args.lr_decay_rate, lr_decay_steps=args.lr_decay_steps,
        d_lr_decay_rate=args.d_lr_decay_rate,
        d_lr_decay_steps=args.d_lr_decay_steps,
        lr_warmup_steps=args.lr_warmup_steps,
        d_lr_warmup_steps=args.d_lr_warmup_steps,
        seed=args.seed, n_gen_samples=args.n_gen_samples,
        test_interval=args.test_interval, save_interval=args.save_interval,
        model_dir=args.model_dir, dump_dir=args.dump_dir,
        lnr_model=args.lnr_model, model=args.model,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    return cfg.replace(**sgan) if sgan else cfg


def _resumed_train_cfg(args, exists: Callable[[str], bool]):
    """``train``'s config: the flags', or, where ``exists`` finds the run's
    checkpoint, its model-defining config (resume continues THE run on
    disk)."""
    from socialways_torch.io.checkpoint import adopt_checkpoint_config
    cfg = _train_cfg(args)
    resume_file = os.path.join(cfg.model_dir,
                               f"{args.model}-{args.dataset}.npz")
    if exists(resume_file):
        cfg = adopt_checkpoint_config(cfg, resume_file)
    return cfg


def _log_metrics(path: str, **record) -> None:
    """Append one JSON line to ``path`` (nothing when it is empty): the
    machine-readable counterpart of train's prints
    (socialways_tpu/cli/main.py:765-773)."""
    if not path:
        return
    record["t"] = round(time.time(), 3)
    with open(path, "a") as fh:
        fh.write(json.dumps(record) + "\n")


def _coverage(g_params, ds, cfg, k: int, seed: int, device) -> float:
    """Toy mode coverage of ``k`` rollouts of (up to) the first 64 test
    samples, their noise seeded with ``seed`` (socialways_tpu/cli/main.py:
    776-792, 1011-1021)."""
    from socialways_torch.eval.metrics import k_sample_rollout
    from socialways_torch.eval.stats import toy_mode_coverage
    nt = ds.n_train_samples
    obs = ds.obsvs[nt:nt + 64]
    ids = ds.scene_ids_for_rows(nt, obs.shape[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    pk = k_sample_rollout(g_params, torch.from_numpy(obs).to(device),
                          torch.from_numpy(ids).to(device), k, cfg, gen)
    return toy_mode_coverage(ds.scale.denormalize(obs),
                             ds.scale.denormalize(pk[..., :2].cpu().numpy()))


def _dump_first_chunk(trainer, g_params, epoch: int, seed: int) -> str:
    """The first test chunk's K rollouts (noise seeded with ``seed``), its
    truth and the linear baseline, dumped in the reference's schema
    (socialways_tpu/cli/main.py:795-819)."""
    from socialways_torch.engine.trainer import chunk_of
    from socialways_torch.eval.metrics import k_sample_rollout
    from socialways_torch.io.dumps import dump_predictions
    if trainer.cfg.lnr_model == "kalman":
        from socialways_torch.ops.kalman import predict_kalman as lnr_fn
    else:
        from socialways_torch.ops.traj import predict_cv as lnr_fn
    cfg, ds = trainer.cfg, trainer.dataset
    chunk = chunk_of(trainer.test_dev, 0)
    nv = int(trainer.test_packed.n_valid[0])
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    pred_k = k_sample_rollout(g_params, chunk["obsvs"], chunk["scene_ids"],
                              cfg.n_gen_samples, cfg, gen)
    lnr = lnr_fn(chunk["obsvs"], cfg.n_next)
    nt = ds.n_train_samples
    t0 = ds.times[nt] if len(ds.times) > nt else 0
    wr_dir = os.path.join(cfg.dump_dir, cfg.dataset, "socialWays",
                          str(epoch))
    return dump_predictions(wr_dir, epoch, t0,
                            chunk["obsvs"][:nv].cpu().numpy(),
                            pred_k[:, :nv].cpu().numpy(),
                            chunk["preds"][:nv].cpu().numpy(),
                            lnr[:nv].cpu().numpy(), ds.scale)


#: side streams of a train run, keyed by (cfg.seed, stream, epoch): the
#: coverage and dump rollouts draw their noise there, so tracking them does
#: not move the training draws (JAX folds its key, cli/main.py:789, 754)
_COVERAGE_STREAM, _DUMP_STREAM = 99, 98


def _n_devices(args, device) -> int:
    """Devices ``--mesh`` may take: the torchrun world, the cards, or
    ``--cpu-devices`` (one CPU device without it)."""
    from socialways_torch.parallel.mesh import in_torchrun
    if in_torchrun():
        return int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        return torch.cuda.device_count()
    return args.cpu_devices or 1


def cmd_train(args, device) -> int:
    """``train``: the loop below on ``device``, or with ``--mesh`` on every
    rank of a mesh (socialways_tpu/cli/main.py:539-554): too few devices
    print JAX's error and give 1; on the card the kernels are built here
    before the ranks start."""
    from socialways_torch.parallel.mesh import mesh_shape, run
    if _refuse_untrainable(args):
        return 2
    shape = mesh_shape(str(args.mesh))
    if not shape:
        return _train(args, device)
    need, have = math.prod(shape), _n_devices(args, device)
    if have < need:
        print(f"ERROR: --mesh {args.mesh} needs {need} devices, have "
              f"{have}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        from socialways_torch.kernels.social_attention import prebuild
        cfg = _resumed_train_cfg(args, os.path.isfile)
        prebuild(cfg.hidden_size, cfg.social_feature_size,
                 torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
    return run(_train_rank, shape, device.type, args=(args,))


def _train_rank(mesh, args) -> int:
    """One rank's ``train``; the others than rank 0 print nothing."""
    import contextlib
    if mesh.rank == 0:
        return _train(args, mesh.device, mesh)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return _train(args, mesh.device, mesh)


def _train(args, device, mesh=None) -> int:
    """The JAX training loop (socialways_tpu/cli/main.py:519-762): resume
    with the checkpoint's config, the optional profiled epoch, the metrics
    log, the divergence rescue, periodic checkpoints, eval and a ``-best``
    checkpoint, the gated ADE-stall rescue, toy coverage with its
    ``-bestcov`` checkpoint and stall rescue, prediction dumps, and always
    a final checkpoint.  On a ``mesh`` every rank runs it on its chunks
    and takes the same decisions (the metrics and evaluations come back
    reduced, the coverage is rank 0's); rank 0 alone writes files, and
    every rank waits for each checkpoint before it goes on."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.rescue import (StallTracker,
                                                reinit_discriminator)
    from socialways_torch.engine.train_step import (eval_params,
                                                    transplant_schedule_clock)
    from socialways_torch.engine.trainer import (Trainer, fork_seed,
                                                 stream_seed)
    from socialways_torch.io.checkpoint import (restore_checkpoint,
                                                save_checkpoint)

    main = mesh is None or mesh.rank == 0

    def shared(value: float) -> float:
        """Rank 0's ``value`` on every rank."""
        if mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=device)
        torch.distributed.broadcast(t, 0)
        return float(t)

    def on_disk(path: str) -> bool:
        """Whether rank 0 sees ``path``: every rank takes the branch that
        rank 0 takes, also while rank 0 is writing it."""
        return bool(shared(float(main and os.path.isfile(path))))

    cfg = _resumed_train_cfg(args, on_disk)
    ds = load_npz_dataset(args.data)
    trainer = Trainer(cfg, ds, device, mesh)
    log = functools.partial(_log_metrics, args.metrics_log if main else "")

    def save(path: str, st, at_epoch: int) -> None:
        if main:
            save_checkpoint(path, st, at_epoch, rng, ds.scale, cfg)
        if mesh is not None:
            torch.distributed.barrier()

    if cfg.d_input_noise_steps < 0:
        print(f"instance-noise anneal over the full run: "
              f"{trainer.cfg.d_input_noise_steps} GAN steps")
    cfg = trainer.cfg

    stem = os.path.join(cfg.model_dir, f"{args.model}-{cfg.dataset}")
    model_file, best_file = stem + ".npz", stem + "-best.npz"
    bestcov_file = stem + "-bestcov.npz"
    best_ade = best_train_ade = float("inf")
    best_cov, cov_stall = -1.0, 0
    tracker = StallTracker(args.ade_stall_recover,
                           grace=args.ade_stall_grace,
                           max_rescues=args.ade_stall_max_rescues,
                           classify_patience=args.ade_stall_classify)
    if ((args.ade_stall_recover or args.ade_stall_classify)
            and (trainer.test_packed is None
                 or cfg.test_interval >= cfg.n_epochs)):
        print("WARNING: --ade-stall-recover is inert — the dataset has "
              "no test split or --test-interval reaches --epochs (the "
              "only eval would land at run end, where rescue is "
              "pointless), so no rescue can ever fire")
    if args.ade_stall_recover < 0 and args.ade_stall_classify <= 0:
        print("WARNING: --ade-stall-recover -1 (gated mode) without "
              "--ade-stall-classify N is inert — the patience path is "
              "disabled and no signature trigger is armed")
    state = trainer.init_state()
    rng = torch.Generator(device=device).manual_seed(cfg.seed)
    start_epoch = 1
    if on_disk(model_file):
        state, last_epoch, rng_state, _ = restore_checkpoint(
            model_file, cfg, device)
        if rng_state is not None and rng_state[0] == device.type:
            rng.set_state(rng_state[1])
        start_epoch = last_epoch + 1
        print(f"resumed from {model_file} at epoch {last_epoch}")
    if args.auto_recover and not on_disk(best_file):
        # a baseline, so that a divergence before the first eval restores
        # the initial state
        save(best_file, state, 0)

    def rescue_restore(path: str):
        """The checkpoint at ``path``, on the run's clock under
        --rescue-keep-clock (``state`` is only read)."""
        restored, at_epoch, _, _ = restore_checkpoint(path, cfg, device)
        if args.rescue_keep_clock:
            restored = transplant_schedule_clock(restored, state)
        return restored, at_epoch

    print(f"{args.data}  # training samples: {ds.n_train_samples}  "
          f"chunks: {trainer.train_packed.n_chunks}  "
          f"width: {trainer.train_packed.width}")
    print(f"hidden dim = {cfg.hidden_size} | lr(G) = {cfg.lr_g:.5f} | "
          f"lr(D) = {cfg.lr_d:.5f} | devices: [{device}]"
          + ("" if mesh is None else f" | mesh {args.mesh}: {mesh.size} "
             f"ranks, {torch.distributed.get_backend()}"))

    # --fused-epochs: blocks of --block-size epochs (or gcd of the save
    # and test intervals), each one print, metrics row and divergence
    # check; save and eval only where a block ends on their interval
    block = ((args.block_size or math.gcd(cfg.save_interval,
                                          cfg.test_interval))
             if args.fused_epochs else 1)
    epoch = start_epoch - 1
    while epoch < cfg.n_epochs:
        n_block = min(block, cfg.n_epochs - epoch) if block > 1 else 1
        if (args.profile_dir and main
                and epoch == start_epoch + n_block - 1):
            # the run's second block: the first holds the kernels' build
            from socialways_torch.utils.profiling import trace
            with trace(args.profile_dir):
                state, m = trainer.train_epochs(state, rng, n_block)
            print(f"wrote profiler trace to {args.profile_dir}")
        else:
            state, m = trainer.train_epochs(state, rng, n_block)
        epoch += n_block
        print(f" Epc={epoch:4d}, Train ADE,FDE = ({m['train_ade']:.3f}, "
              f"{m['train_fde']:.3f}) | time = {m['epoch_time_s']:.2f}s"
              + (f" ({n_block} fused epochs)" if n_block > 1 else ""))
        log(kind="train", epoch=epoch, train_ade=m["train_ade"],
            train_fde=m["train_fde"], epoch_time_s=m["epoch_time_s"],
            n_block=n_block)

        # divergence: a non-finite train ADE or a jump past 5x the best
        diverged = (not math.isfinite(m["train_ade"])
                    or m["train_ade"] > 5 * best_train_ade + 0.1)
        best_train_ade = min(best_train_ade, m["train_ade"])
        if args.auto_recover and diverged and on_disk(best_file):
            state, b_epoch = rescue_restore(best_file)
            print(f"DIVERGED at epoch {epoch} (ADE {m['train_ade']:.3f}); "
                  f"restored best checkpoint from epoch {b_epoch}")

        if epoch % cfg.save_interval == 0:
            save(model_file, state, epoch)
            print(f"saved checkpoint to {model_file}")
        if epoch % cfg.test_interval or trainer.test_packed is None:
            continue
        ev = trainer.evaluate(eval_params(state), fork_seed(rng))
        print(f"Avg ADE,FDE ({cfg.n_next})= ({ev['ade_avg']:.3f}, "
              f"{ev['fde_avg']:.3f}) | Min({cfg.n_gen_samples}) ADE,FDE "
              f"({cfg.n_next})= ({ev['ade_min']:.3f}, "
              f"{ev['fde_min']:.3f})")
        log(kind="eval", epoch=epoch, ade_avg=ev["ade_avg"],
            fde_avg=ev["fde_avg"], ade_min=ev["ade_min"],
            fde_min=ev["fde_min"])
        if ev["ade_min"] < best_ade:
            best_ade = ev["ade_min"]
            save(best_file, state, epoch)
            print(f"new best (ADE {best_ade:.3f}) saved to {best_file}")
        if (tracker.observe(ev["ade_min"], ade_avg=ev["ade_avg"],
                            train_ade=m["train_ade"])
                and epoch < cfg.n_epochs and on_disk(best_file)):
            state, b_epoch = rescue_restore(best_file)
            state = reinit_discriminator(
                state, cfg, torch.Generator().manual_seed(fork_seed(rng)))
            tracker.fired(best_ade, at_epoch=epoch)
            trigger = (f"{tracker.last_signature} signature matched for "
                       f"{args.ade_stall_classify} evals"
                       if tracker.last_trigger == "classifier"
                       else f"unimproved for {args.ade_stall_recover} "
                            f"evals")
            print(f"ADE STALLED at epoch {epoch} (best {best_ade:.3f}, "
                  f"{trigger}); restored best checkpoint from epoch "
                  f"{b_epoch} with a RE-INITIALIZED discriminator")
            log(kind="rescue", epoch=epoch, ade_stall=True,
                trigger=tracker.last_trigger,
                signature=tracker.last_signature)
        if args.track_coverage:
            cov = shared(_coverage(
                eval_params(state), ds, cfg, cfg.n_gen_samples,
                stream_seed(cfg.seed, _COVERAGE_STREAM, epoch), device)
                if main else 0.0)
            print(f"mode coverage = {cov:.2f}")
            log(kind="coverage", epoch=epoch, coverage=cov)
            if cov > best_cov:
                best_cov, cov_stall = cov, 0
                save(bestcov_file, state, epoch)
                print(f"new best coverage saved to {bestcov_file}")
            else:
                cov_stall += 1
                if (args.stall_recover > 0
                        and cov_stall >= args.stall_recover
                        and best_cov < 1.0
                        and on_disk(bestcov_file)):
                    state, c_epoch = rescue_restore(bestcov_file)
                    cov_stall = 0
                    extra = ""
                    if args.stall_reset_d:
                        state = reinit_discriminator(
                            state, cfg,
                            torch.Generator().manual_seed(fork_seed(rng)))
                        extra = " with a RE-INITIALIZED discriminator"
                    print(f"coverage STALLED at epoch {epoch} "
                          f"({cov:.2f} < best {best_cov:.2f}); restored "
                          f"best-coverage checkpoint from epoch "
                          f"{c_epoch}{extra}, continuing on a fresh "
                          f"stream")
        if cfg.dump_dir and main:
            f = _dump_first_chunk(trainer, eval_params(state), epoch,
                                  stream_seed(cfg.seed, _DUMP_STREAM, epoch))
            print(f"saved predictions to {f}")

    # always leave a final checkpoint (evaluate and resume then work)
    if epoch % cfg.save_interval != 0:
        save(model_file, state, epoch)
        print(f"saved final checkpoint to {model_file}")
    return 0


def cmd_simulate(args, device) -> int:
    """A crowd rolled forward on the card (socialways_tpu/cli/main.py:
    1104-1169): ``--agents`` agents in scenes of ``--scene-size``, each
    starting from a grid point and a random walk of n_past steps drawn from
    numpy's ``RandomState(seed)`` as in JAX, simulated for ``--windows``
    windows twice; the second call is timed, and with ``--profile-dir`` traced
    (``utils.profiling.trace``: the Chrome trace and ``spans.json``, the
    windows' phases and counters).  A checkpoint decides the model and
    keeps its own n_past / n_next (JAX forces 8 / 12); ``--model sgan``
    simulates Social GAN."""
    from socialways_torch.engine.simulate import (initial_crowd,
                                                  make_crowd_sim,
                                                  throughput_agent_steps)
    from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                                load_checkpoint_config)
    cfg = _train_cfg(args)
    if args.model_file:
        cfg = adopt_checkpoint_config(cfg, args.model_file)
        # configless checkpoints keep the legacy social default
        if load_checkpoint_config(args.model_file) is None \
                and not args.use_social:
            cfg = cfg.replace(use_social=True)
    elif cfg.model == "socialWays":
        cfg = cfg.replace(use_social=True)
    cfg = cfg.replace(max_scene_size=args.scene_size)
    gen, _, _ = _load_generator(args, cfg, device)

    n = args.agents
    obsv0, scene_ids = initial_crowd(n, args.scene_size, cfg.n_past,
                                     cfg.seed)
    obsv0 = torch.from_numpy(obsv0).to(device)
    scene_ids = torch.from_numpy(scene_ids).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sim = make_crowd_sim(cfg, args.windows)
    rng = torch.Generator(device=device)
    sim(gen, obsv0, scene_ids, rng.manual_seed(1))   # builds the kernels
    sync()
    traced = contextlib.nullcontext()
    if args.profile_dir:
        from socialways_torch.utils.profiling import trace
        traced = trace(args.profile_dir)
    with traced:
        tic = time.perf_counter()
        out = sim(gen, obsv0, scene_ids, rng.manual_seed(2))
        sync()
        dt = time.perf_counter() - tic

    route = (f"cuda kernel on {torch.cuda.get_device_name(device)}"
             if device.type == "cuda" else "cpu")
    social = ("on" if cfg.use_social
              else "OFF — checkpoint trained without social")
    kind = "attention"
    if cfg.model == "sgan":
        kind, social = "pooling", "SGAN-P (max over each scene)"
    rate = throughput_agent_steps(n, args.windows, cfg.n_next, dt)
    print(f"simulated {n} agents x {args.windows * cfg.n_next} steps "
          f"(scenes of {args.scene_size}, social {kind} {social}, "
          f"route={route}) in {dt * 1e3:.3f} ms "
          f"= {rate / 1e6:.2f}M agent-steps/s")
    if args.out:
        np.savez(args.out, trajectories=out.cpu().numpy())
        print(f"wrote {args.out}")
    return 0


def cmd_stats(args) -> int:
    """1-NN accuracy and EMD of each dumped epoch against the real toy
    sample sets (socialways_tpu/cli/main.py:1172-1180), cached to
    ``stats<num_samples>.npz`` in the dump directory."""
    from socialways_torch.eval.stats import (calc_and_store_stats,
                                             load_real_samples)
    real = load_real_samples(args.real_npz, group=args.group)
    per_epoch = calc_and_store_stats(args.preds_dir, real,
                                     num_samples=args.num_samples)
    for epoch in sorted(per_epoch):
        one_nn, emd = per_epoch[epoch]
        print(f"epoch = {epoch}, EMD = {emd:.5f}, 1nn = {one_nn:.5f}")
    print(f"cached to "
          f"{os.path.join(args.preds_dir, f'stats{args.num_samples}.npz')}")
    if args.plot:
        from socialways_torch.viz.stats_plots import plot_stats_curves
        for d in args.extra_dirs:     # the overlays need their caches too
            calc_and_store_stats(d, real, num_samples=args.num_samples)
        out = plot_stats_curves([args.preds_dir] + list(args.extra_dirs),
                                args.plot, labels=args.labels or None,
                                num_samples=args.num_samples,
                                iters_per_epoch=args.iters_per_epoch)
        print(f"wrote {out}")
    return 0


def cmd_animate(args) -> int:
    """The toy set's trajectories as a gif (socialways_tpu/cli/main.py:
    1194-1201)."""
    from socialways_torch.viz.animation import ToyAnimation
    with np.load(args.npz) as d:
        samples = np.concatenate([d["obsvs"], d["preds"]], axis=1)
    ToyAnimation(samples, duration_s=args.duration, seed=args.seed).save(
        args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_plot_tracks(args) -> int:
    """Every parsed track of a raw annotation file in one PNG
    (socialways_tpu/cli/main.py:1204-1216)."""
    from socialways_torch.data.parsers import PARSERS
    from socialways_torch.viz.tracks import plot_tracks
    p = PARSERS[args.parser]()
    p.load(args.input, down_sample=args.down_sample)
    n = plot_tracks(p.p_data, args.out, min_len=args.min_len,
                    title=os.path.basename(args.input))
    print(f"wrote {args.out}: {n}/{len(p.p_data)} tracks "
          f"(min_len {args.min_len})")
    return 0


def cmd_visualize(args) -> int:
    """Prediction heatmaps of a dump tree, one PNG a dump
    (socialways_tpu/cli/main.py:1219-1225)."""
    from socialways_torch.viz.heatmap import render_preds_dir
    out = render_preds_dir(args.preds_dir, args.out,
                           bg_image=args.bg_image,
                           homography=args.homography)
    print(f"wrote {out}")
    return 0


def cmd_sweep(args, device) -> int:
    """The unroll x info-weight grid (socialways_tpu/cli/main.py:977-1036):
    train each variant for ``--sweep-epochs`` from the same seed, then
    score its eval ADE/FDE and the toy mode coverage of ``--coverage-k``
    rollouts over 64 test samples; write JAX's JSON."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.train_step import eval_params
    from socialways_torch.engine.trainer import Trainer, fork_seed

    if _refuse_untrainable(args):
        return 2
    base = _train_cfg(args)
    ds = load_npz_dataset(args.data)
    results = {}
    for unroll in [int(u) for u in args.unrolls.split(",")]:
        for info_w in [float(w) for w in args.info_weights.split(",")]:
            cfg = base.replace(n_unrolling_steps=unroll, loss_info_w=info_w,
                               use_info_loss=info_w > 0)
            tr = Trainer(cfg, ds, device)
            state = tr.init_state()
            rng = torch.Generator(device=device).manual_seed(cfg.seed)
            state, m = tr.train_epochs(state, rng, args.sweep_epochs)
            ev = tr.evaluate(eval_params(state), fork_seed(rng))
            cov = _coverage(eval_params(state), ds, tr.cfg, args.coverage_k,
                            fork_seed(rng), device)
            key = f"unroll{unroll}-info{info_w}"
            results[key] = {**ev, "mode_coverage": cov,
                            "final_train_ade": m["train_ade"]}
            print(f"{key}: ADE/FDE min-{base.n_gen_samples} = "
                  f"{ev['ade_min']:.3f}/{ev['fde_min']:.3f} | "
                  f"coverage = {cov:.2f}")
            del tr, state
    best = max(results, key=lambda k: results[k]["mode_coverage"])
    print(f"best coverage: {best} ({results[best]['mode_coverage']:.2f})")
    with open(args.out_json, "w") as fh:
        json.dump(results, fh, indent=2)
    print(f"wrote {args.out_json}")
    return 0


def cmd_eth_ucy(args, device) -> int:
    """The leave-one-scene-out protocol; obsmat files found under
    ``--data-dir`` are windowed first when a scene npz is missing."""
    import json
    from socialways_torch.engine.ethucy import (prepare_scenes,
                                                run_leave_one_out)

    if _refuse_untrainable(args):
        return 2
    cfg = _train_cfg(args)
    scenes = tuple(args.scenes.split(","))
    out = {}
    npz_missing = [s for s in scenes if not os.path.exists(os.path.join(
        args.data_dir, f"{s}-{cfg.n_past}-{cfg.n_next}.npz"))]
    if npz_missing or args.prepare_only:
        manifest = prepare_scenes(args.data_dir, cfg, scenes=scenes)
        out["scenes"] = manifest
        if args.prepare_only:
            print(json.dumps(manifest, indent=2, default=str))
            if args.out_json:
                with open(args.out_json, "w") as fh:
                    json.dump(out, fh, indent=2, default=str)
            return 0

    out["folds"] = run_leave_one_out(
        args.data_dir, cfg, scenes=scenes, fused_block=args.fused_block,
        eval_every=args.eval_every,
        ade_stall_recover=args.ade_stall_recover,
        ade_stall_grace=args.ade_stall_grace,
        ade_stall_max_rescues=args.ade_stall_max_rescues,
        ade_stall_classify=args.ade_stall_classify, device=device)

    if args.out_json:
        with open(args.out_json, "w") as fh:
            json.dump(out, fh, indent=2, default=str)
        print(f"wrote {args.out_json}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="socialways-torch",
        description="Social Ways training and serving on PyTorch/CUDA")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; "
                         "without one the command fails)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="with --cpu: N CPU devices, so that --mesh N runs "
                         "N gloo processes without cards")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("create-toy", help="generate the toy dataset")
    p.add_argument("--npz", default="")
    p.add_argument("--txt", default="")
    p.add_argument("--n_conditions", type=int, default=6)
    p.add_argument("--n_modes", type=int, default=3)
    p.add_argument("--n_samples", type=int, default=3 * 6 * 12)
    p.add_argument("--n_per_batch", type=int, default=6)
    p.add_argument("--seed", type=int, default=30)
    p.set_defaults(fn=cmd_create_toy, host_only=True)

    p = sub.add_parser("create-dataset",
                       help="parse raw annotations into a training npz")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--parser", default="biwi",
                   choices=["biwi", "trajnet", "sdd", "seyfried"])
    p.add_argument("--n-past", type=int, default=8)
    p.add_argument("--n-next", type=int, default=12)
    p.add_argument("--down-sample", type=int, default=None,
                   help="frame subsampling; default = the parser's own "
                        "(SDD: 12, others: 1)")
    p.set_defaults(fn=cmd_create_dataset, host_only=True)

    p = sub.add_parser("train", help="train the GAN (checkpoints, eval, "
                                     "dumps, coverage, the rescues)")
    p.add_argument("--data", required=True, help="a windowed .npz")
    _add_train_flags(p, ALL_RECIPES)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("stats",
                       help="EMD + 1-NN distribution stats over dumps")
    p.add_argument("--preds-dir", required=True)
    p.add_argument("--real-npz", required=True,
                   help="dataset npz providing the real sample sets")
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--group", type=int, default=6,
                   help="pedestrians per real sample set")
    p.add_argument("--plot", default="",
                   help="also render the EMD & 1-NN vs-iteration curve "
                        "figure (calc_statistics.py:122-144) to this PNG")
    p.add_argument("--extra-dirs", nargs="*", default=[],
                   help="additional dump dirs to overlay in --plot "
                        "(multi-variant comparison)")
    p.add_argument("--labels", nargs="*", default=[],
                   help="curve labels for --plot (default: dir names)")
    p.add_argument("--iters-per-epoch", type=int, default=1,
                   help="x-axis scale: training steps per epoch")
    p.set_defaults(fn=cmd_stats, host_only=True)

    p = sub.add_parser("visualize", help="render prediction heatmaps")
    p.add_argument("--preds-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--bg-image", default="")
    p.add_argument("--homography", default="")
    p.set_defaults(fn=cmd_visualize, host_only=True)

    p = sub.add_parser("plot-tracks",
                       help="eyeball raw parsed tracks (reference "
                            "pick_subset.py as a real subcommand)")
    p.add_argument("input")
    p.add_argument("--out", required=True)
    p.add_argument("--parser", default="sdd",
                   choices=["biwi", "trajnet", "sdd", "seyfried"])
    p.add_argument("--down-sample", type=int, default=None,
                   help="frame subsampling; default = the parser's own "
                        "(SDD: 12, others: 1)")
    p.add_argument("--min-len", type=int, default=0)
    p.set_defaults(fn=cmd_plot_tracks, host_only=True)

    p = sub.add_parser("animate", help="toy-dataset gif animation")
    p.add_argument("--npz", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=int, default=5)
    p.set_defaults(fn=cmd_animate, host_only=True)

    p = sub.add_parser("sweep",
                       help="unrolled-GAN x info-weight sweep on the toy "
                            "set with mode-coverage scoring")
    p.add_argument("--data", required=True)
    p.add_argument("--unrolls", default="0,1,5")
    p.add_argument("--info-weights", default="0.0,0.5,1.0")
    p.add_argument("--sweep-epochs", type=int, default=20000)
    p.add_argument("--coverage-k", type=int, default=64)
    p.add_argument("--out-json", default="sweep.json")
    _add_train_flags(p, ALL_RECIPES)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("evaluate", help="evaluate a checkpoint")
    p.add_argument("--data", required=True)
    p.add_argument("--model-file", default="")
    p.add_argument("--linear", nargs="?", const="cv", default="",
                   choices=["cv", "kalman"],
                   help="evaluate a linear baseline instead: 'cv' "
                        "(constant velocity, reference "
                        "utils/linear_models.py:9-20; bare --linear) or "
                        "'kalman' (the constant-acceleration Kalman filter "
                        "of ops/kalman.py, rolled forward)")
    _add_train_flags(p, ALL_RECIPES)
    _add_sgan_flags(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict",
                       help="inference-only forecasting from a checkpoint "
                            "(no ground-truth futures needed)")
    p.add_argument("--data", required=True,
                   help="a create-dataset npz (forecast every window) or "
                        "a RAW annotation file (forecast everyone in the "
                        "scene at --at-time; see --parser)")
    p.add_argument("--model-file", required=True)
    p.add_argument("--out", default="predictions.npz")
    p.add_argument("--parser", default="biwi",
                   choices=["biwi", "trajnet", "sdd", "seyfried"],
                   help="raw-mode annotation format")
    p.add_argument("--down-sample", type=int, default=None)
    p.add_argument("--n-past", type=int, default=None,
                   help="raw mode: observation window length (default: "
                        "the checkpoint's training n_past)")
    p.add_argument("--n-next", type=int, default=None,
                   help="forecast horizon when the npz has no preds "
                        "(default: the checkpoint's training n_next)")
    p.add_argument("--at-time", type=int, default=-1,
                   help="raw mode: forecast the scene at this timestamp "
                        "(-1 = the latest with a full-history agent)")
    _add_train_flags(p, ALL_RECIPES)
    _add_sgan_flags(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("eth-ucy",
                       help="leave-one-scene-out ETH/UCY benchmark")
    p.add_argument("--data-dir", required=True,
                   help="directory with <scene>-8-12.npz files, OR raw "
                        "obsmat annotation files in any standard layout "
                        "(detected, validated, fingerprinted and windowed)")
    p.add_argument("--scenes", default="eth,hotel,univ,zara1,zara2")
    p.add_argument("--fused-block", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate the held-out scene every N epochs and "
                        "report the best state (best_ade_min/best_fde_min/"
                        "best_at_epoch) beside the final eval; 0 = final "
                        "eval only (the stall rescue defaults it to "
                        "n_epochs/30)")
    p.add_argument("--prepare-only", action="store_true",
                   help="stop after obsmat discovery + npz building")
    p.add_argument("--out-json", default="")
    # the toy bundles are the toy protocol's (6.4x worse than the defaults
    # on the leave-one-out protocol, BASELINE.md r4m): loo alone
    _add_train_flags(p, ["loo"])
    p.set_defaults(fn=cmd_eth_ucy)

    p = sub.add_parser("simulate",
                       help="large-scale crowd rollout with social attention "
                            "(the CUDA kernel on the card; no --no-pallas)")
    p.add_argument("--agents", type=int, default=10000)
    p.add_argument("--scene-size", type=int, default=16,
                   help="agents per scene; also the attention's "
                        "--max-scene-size")
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--model-file", default="",
                   help="checkpoint to simulate (default: a generator drawn "
                        "from torch.Generator().manual_seed(--seed), whose "
                        "weights are not the JAX package's)")
    p.add_argument("--out", default="", help="optional npz to write")
    _add_train_flags(p, ALL_RECIPES)
    _add_sgan_flags(p)
    p.set_defaults(fn=cmd_simulate)
    return ap


def _given(ap: argparse.ArgumentParser, args, dests) -> list:
    """The option strings of ``dests`` that ``args``, parsed from the
    command line before any recipe's expansion, holds off their default:
    the ones given there."""
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    return [a.option_strings[0] for a in sub.choices[args.command]._actions
            if a.dest in dests and getattr(args, a.dest) != a.default]


def parse_args(argv):
    """Parse ``argv``; a ``--recipe NAME`` is expanded into its flags right
    after the subcommand (explicit flags, wherever they stand, then
    override the bundle) and parsed again.  ``eth-ucy`` without a
    ``--recipe`` runs ``loo``; ``--recipe=`` opts out.  A flag of
    ``_REFUSED`` given on the command line exits 2; one of ``_IGNORED``
    prints a NOTE."""
    ap = build_parser()
    args = ap.parse_args(argv)
    refused = _given(ap, args, _REFUSED.get(args.command, ()))
    if refused:
        ap.error(f"{args.command} writes none of train's loop outputs and "
                 f"runs none of its rescues: {', '.join(refused)} (run "
                 f"train for them)")
    ignored = _given(ap, args, _IGNORED.get(args.command, ()))
    if ignored:
        print(f"NOTE: {args.command} reads none of {', '.join(ignored)} "
              f"(train's outputs and rescues; accepted as JAX accepts "
              f"them, and ignored)", file=sys.stderr)
    given = any(tok == "--recipe" or tok.startswith("--recipe=")
                for tok in argv)
    name = getattr(args, "recipe", "")
    if args.command == "eth-ucy" and not given:
        print("NOTE: eth-ucy defaults to --recipe loo (the record arm: "
              "af+social+EMA+noise-floor+gated rescue); pass --recipe= "
              "for bare reference-default hyperparameters",
              file=sys.stderr)
        name = "loo"
    if not name:
        return args
    if name in RECIPE_ALIASES:
        new = RECIPE_ALIASES[name]
        print(f"NOTE: --recipe {name} is deprecated — it is the TOY "
              f"bundle (6.4x worse than defaults on the LOO protocol, "
              f"BASELINE.md r4m); renamed to '{new}'. For real "
              f"trajectory data use --recipe loo.", file=sys.stderr)
        name = new
    rest, i = [], 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--recipe":
            i += 2
            continue
        if not tok.startswith("--recipe="):
            rest.append(tok)
        i += 1
    sub_i = 0
    while rest[sub_i].startswith("-"):     # the global flags before it
        sub_i += 2 if rest[sub_i] == "--cpu-devices" else 1
    return ap.parse_args(rest[:sub_i + 1] + RECIPES[name] + rest[sub_i + 1:])


def main(argv=None) -> int:
    from socialways_torch.device import resolve_device
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.cpu_devices and not args.cpu:
        print("--cpu-devices requires --cpu", file=sys.stderr)
        return 1
    if getattr(args, "host_only", False):
        return args.fn(args)
    device = resolve_device("cpu" if args.cpu else None)
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
