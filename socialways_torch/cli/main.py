"""Command-line entry points of the port: training and serving.

    python -m socialways_torch.cli.main train --recipe loo --data hotel-8-12.npz --epochs 100
    python -m socialways_torch.cli.main evaluate --data hotel-8-12.npz --model-file ckpt.npz
    python -m socialways_torch.cli.main evaluate --data hotel-8-12.npz --linear
    python -m socialways_torch.cli.main predict --data hotel-8-12.npz --model-file ckpt.npz --out preds.npz
    python -m socialways_torch.cli.main --cpu train ...   # run on the CPU

Flags, outputs and printouts follow socialways_tpu/cli/main.py:519-762
(train) and :822-974 (evaluate, predict).  Everything runs on the GPU
unless ``--cpu`` is given.  ``train`` takes only the flags of what the port
implements (the loo recipe's feature set); argparse refuses the others.
The model flags of evaluate/predict are the widths and switches of the
served FC generator; a checkpoint's embedded config overrides them.  The
other recipes, ``eth-ucy``, ``predict`` on raw annotation files and
``--linear kalman`` belong to later slices of the port.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


#: ``train --recipe NAME`` expands to these flags right after ``train``, so
#: explicit flags override them (socialways_tpu/cli/main.py:50-58: the
#: record real-data arm: agent frame + social attention + EMA + annealed D
#: instance noise with a 0.02 floor + the signature-gated ADE-stall
#: rescue).  The JAX package's other recipes are not ported.
RECIPES = {
    "loo": ["--agent-frame", "--use-social", "--g-ema-decay", "0.999",
            "--d-input-noise", "0.05", "--d-input-noise-steps", "-1",
            "--d-input-noise-floor", "0.02",
            "--ade-stall-recover", "-1", "--ade-stall-classify", "5"],
}


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    """Flags of the served model; a checkpoint's embedded config wins."""
    p.add_argument("--batch-size", "--b", type=int, default=256)
    p.add_argument("--hidden-size", "--h-size", type=int, default=64)
    p.add_argument("--use-social", action="store_true",
                   help="social attention pooling (the paper's mechanism)")
    p.add_argument("--agent-frame", action="store_true",
                   help="per-agent canonical heading frames (pairwise "
                        "social geometry stays world-frame)")
    p.add_argument("--g-ema-decay", type=float, default=0.0,
                   help="> 0: serve the checkpoint's EMA generator")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 forward (not ported yet: raises)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-gen-samples", "--k", type=int, default=20)


def _cfg_from_args(args):
    from socialways_torch.config import TrainConfig
    return TrainConfig(
        batch_size=args.batch_size,
        hidden_size=args.hidden_size,
        social_feature_size=args.hidden_size,
        noise_len=args.hidden_size // 2,
        use_social=args.use_social,
        agent_frame=args.agent_frame,
        g_ema_decay=args.g_ema_decay,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        seed=args.seed,
        n_gen_samples=args.n_gen_samples,
    )


def _load_generator(args, cfg, device):
    """The checkpoint's generator, or a fresh one drawn from ``cfg.seed``
    when no checkpoint is given."""
    from socialways_torch.io.checkpoint import restore_generator
    from socialways_torch.models.generator import init_generator
    if args.model_file:
        gen, epoch, scale = restore_generator(args.model_file, cfg, device)
        print(f"loaded {args.model_file} (epoch {epoch})")
        return gen, epoch, scale
    gen = init_generator(cfg, torch.Generator().manual_seed(cfg.seed),
                         device)
    return gen, 0, None


def cmd_evaluate(args, device) -> int:
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.io.checkpoint import adopt_checkpoint_config

    cfg = _cfg_from_args(args)
    if args.model_file:
        cfg = adopt_checkpoint_config(cfg, args.model_file)
    ds = load_npz_dataset(args.data)
    trainer = Trainer(cfg, ds, device)
    cfg = trainer.cfg
    gen, _, _ = _load_generator(args, cfg, device)

    if args.linear:
        from socialways_torch.eval.metrics import k_sample_errors
        from socialways_torch.ops.traj import predict_cv
        total_ade = total_fde = 0.0
        n = 0
        for i in range(trainer.test_packed.n_chunks):
            chunk = chunk_of(trainer.test_dev, i)
            lnr = predict_cv(chunk["obsvs"], cfg.n_next)
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
    """Inference-only forecasting of every window of a windowed npz from a
    checkpoint — the serving path.  Normalization uses the CHECKPOINT's
    Scale, never one refit on the inference data."""
    from socialways_torch.data.dataset import pack_scene_batches
    from socialways_torch.eval.metrics import draw_noise, k_sample_rollout
    from socialways_torch.io.checkpoint import adopt_checkpoint_config
    from socialways_torch.ops.traj import predict_cv

    if not args.data.endswith(".npz"):
        raise SystemExit("error: predict takes a windowed .npz; raw "
                         "annotation input is not ported yet")
    cfg = adopt_checkpoint_config(_cfg_from_args(args), args.model_file)
    n_next = args.n_next if args.n_next is not None else cfg.n_next
    with np.load(args.data) as d:
        obsvs_w = np.asarray(d["obsvs"], np.float32)          # world coords
        batches = np.asarray(d["batches"], np.int64)
        if "preds" in d.files:       # windowed training npz: its horizon
            n_next = d["preds"].shape[1]
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
    np.savez(args.out, **payload)
    print(f"wrote {args.out}: preds_our {payload['preds_our'].shape} "
          f"(K={k}, world units) + CV baseline")
    return 0


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    """The flags of the training this port implements (the JAX names and
    defaults, socialways_tpu/cli/main.py:98-399)."""
    p.add_argument("--recipe", default="", choices=[""] + list(RECIPES),
                   help="expand a documented flag bundle: 'loo' = the "
                        "record real-data arm (--agent-frame --use-social "
                        "--g-ema-decay 0.999 + D instance noise 0.05 "
                        "annealed over the run to a 0.02 floor + the "
                        "signature-gated ADE-stall rescue); explicit flags "
                        "override it")
    p.add_argument("--data", required=True, help="a windowed .npz")
    p.add_argument("--epochs", "--e", type=int, default=1000)
    p.add_argument("--batch-size", "--b", type=int, default=256)
    p.add_argument("--hidden-size", "--h-size", type=int, default=64)
    p.add_argument("--g-learning-rate", "--g-lr", "--lr-g", type=float,
                   default=1e-4)
    p.add_argument("--d-learning-rate", "--d-lr", "--lr-d", type=float,
                   default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-gen-samples", "--k", type=int, default=20)
    p.add_argument("--test-interval", type=int, default=5)
    p.add_argument("--save-interval", type=int, default=50)
    p.add_argument("--model-dir", default="trained_models")
    p.add_argument("--model", "--m", default="socialWays",
                   choices=["socialWays"])
    p.add_argument("--dataset", "--data-name", default="hotel")
    p.add_argument("--use-social", action="store_true",
                   help="social attention pooling (the paper's mechanism)")
    p.add_argument("--agent-frame", action="store_true",
                   help="per-agent canonical heading frames (pairwise "
                        "social geometry stays world-frame)")
    p.add_argument("--g-ema-decay", type=float, default=0.0,
                   help="EMA of the generator (e.g. 0.999); evaluation "
                        "and the best checkpoint use it (0 = off)")
    p.add_argument("--d-input-noise", type=float, default=0.0,
                   help="D instance noise: Gaussian std on the prediction "
                        "inputs of every D evaluation (0 = off)")
    p.add_argument("--d-input-noise-steps", type=int, default=0,
                   help="anneal --d-input-noise linearly to 0 over this "
                        "many GAN steps (0 = constant; -1 = the whole run)")
    p.add_argument("--d-input-noise-floor", type=float, default=0.0,
                   help="clamp the annealed noise std from below")
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


def _train_cfg(args):
    from socialways_torch.config import TrainConfig
    h = args.hidden_size
    return TrainConfig(
        dataset=args.dataset, batch_size=args.batch_size,
        n_epochs=args.epochs, lr_g=args.g_learning_rate,
        lr_d=args.d_learning_rate,
        hidden_size=h, social_feature_size=h, noise_len=h // 2,
        use_social=args.use_social, agent_frame=args.agent_frame,
        d_input_noise=args.d_input_noise,
        d_input_noise_steps=args.d_input_noise_steps,
        d_input_noise_floor=args.d_input_noise_floor,
        g_ema_decay=args.g_ema_decay, seed=args.seed,
        n_gen_samples=args.n_gen_samples, test_interval=args.test_interval,
        save_interval=args.save_interval, model_dir=args.model_dir)


def _fork(rng: torch.Generator) -> int:
    """A seed drawn from the training stream (for the eval noise and a
    re-initialized discriminator)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device))


def cmd_train(args, device) -> int:
    """The JAX training loop (socialways_tpu/cli/main.py:519-762) for the
    ported feature set: resume with the checkpoint's config, periodic
    checkpoints, eval and a ``-best`` checkpoint, the gated ADE-stall
    rescue, and always a final checkpoint."""
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.rescue import (StallTracker,
                                                reinit_discriminator)
    from socialways_torch.engine.train_step import eval_params
    from socialways_torch.engine.trainer import Trainer
    from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                                restore_checkpoint,
                                                save_checkpoint)

    cfg = _train_cfg(args)
    # resume continues THE run on disk: adopt its model-defining config
    resume_file = os.path.join(cfg.model_dir,
                               f"{args.model}-{args.dataset}.npz")
    if os.path.isfile(resume_file):
        cfg = adopt_checkpoint_config(cfg, resume_file)
    ds = load_npz_dataset(args.data)
    trainer = Trainer(cfg, ds, device)
    if cfg.d_input_noise_steps < 0:
        print(f"instance-noise anneal over the full run: "
              f"{trainer.cfg.d_input_noise_steps} GAN steps")
    cfg = trainer.cfg

    model_file = os.path.join(cfg.model_dir,
                              f"{args.model}-{cfg.dataset}.npz")
    best_file = os.path.join(cfg.model_dir,
                             f"{args.model}-{cfg.dataset}-best.npz")
    best_ade = float("inf")
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
    if os.path.isfile(model_file):
        state, last_epoch, rng_state, _ = restore_checkpoint(
            model_file, cfg, device)
        if rng_state is not None and rng_state[0] == device.type:
            rng.set_state(rng_state[1])
        start_epoch = last_epoch + 1
        print(f"resumed from {model_file} at epoch {last_epoch}")

    print(f"{args.data}  # training samples: {ds.n_train_samples}  "
          f"chunks: {trainer.train_packed.n_chunks}  "
          f"width: {trainer.train_packed.width}")
    print(f"hidden dim = {cfg.hidden_size} | lr(G) = {cfg.lr_g:.5f} | "
          f"lr(D) = {cfg.lr_d:.5f} | devices: [{device}]")

    epoch = start_epoch - 1
    while epoch < cfg.n_epochs:
        state, m = trainer.train_epoch(state, rng)
        epoch += 1
        print(f" Epc={epoch:4d}, Train ADE,FDE = ({m['train_ade']:.3f}, "
              f"{m['train_fde']:.3f}) | time = {m['epoch_time_s']:.2f}s")
        if epoch % cfg.save_interval == 0:
            save_checkpoint(model_file, state, epoch, rng, ds.scale, cfg)
            print(f"saved checkpoint to {model_file}")
        if epoch % cfg.test_interval or trainer.test_packed is None:
            continue
        ev = trainer.evaluate(eval_params(state), _fork(rng))
        print(f"Avg ADE,FDE ({cfg.n_next})= ({ev['ade_avg']:.3f}, "
              f"{ev['fde_avg']:.3f}) | Min({cfg.n_gen_samples}) ADE,FDE "
              f"({cfg.n_next})= ({ev['ade_min']:.3f}, "
              f"{ev['fde_min']:.3f})")
        if ev["ade_min"] < best_ade:
            best_ade = ev["ade_min"]
            save_checkpoint(best_file, state, epoch, rng, ds.scale, cfg)
            print(f"new best (ADE {best_ade:.3f}) saved to {best_file}")
        if (tracker.observe(ev["ade_min"], ade_avg=ev["ade_avg"],
                            train_ade=m["train_ade"])
                and epoch < cfg.n_epochs and os.path.isfile(best_file)):
            state, b_epoch, _, _ = restore_checkpoint(best_file, cfg, device)
            state = reinit_discriminator(
                state, cfg, torch.Generator().manual_seed(_fork(rng)))
            tracker.fired(best_ade, at_epoch=epoch)
            trigger = (f"{tracker.last_signature} signature matched for "
                       f"{args.ade_stall_classify} evals"
                       if tracker.last_trigger == "classifier"
                       else f"unimproved for {args.ade_stall_recover} "
                            f"evals")
            print(f"ADE STALLED at epoch {epoch} (best {best_ade:.3f}, "
                  f"{trigger}); restored best checkpoint from epoch "
                  f"{b_epoch} with a RE-INITIALIZED discriminator")

    # always leave a final checkpoint (evaluate and resume then work)
    if epoch % cfg.save_interval != 0:
        save_checkpoint(model_file, state, epoch, rng, ds.scale, cfg)
        print(f"saved final checkpoint to {model_file}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="socialways-torch",
        description="Social Ways training and serving on PyTorch/CUDA")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; "
                         "without one the command fails)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train the GAN (checkpoints, eval, "
                                     "the gated stall rescue)")
    _add_train_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate a checkpoint")
    p.add_argument("--data", required=True)
    p.add_argument("--model-file", default="")
    p.add_argument("--linear", nargs="?", const="cv", default="",
                   choices=["cv"],
                   help="evaluate the constant-velocity baseline instead "
                        "(reference utils/linear_models.py:9-20)")
    _add_model_flags(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict",
                       help="forecast every window of a windowed npz from "
                            "a checkpoint (no ground-truth futures needed)")
    p.add_argument("--data", required=True, help="a create-dataset npz")
    p.add_argument("--model-file", required=True)
    p.add_argument("--out", default="predictions.npz")
    p.add_argument("--n-next", type=int, default=None,
                   help="forecast horizon when the npz has no preds "
                        "(default: the checkpoint's training n_next)")
    _add_model_flags(p)
    p.set_defaults(fn=cmd_predict)
    return ap


def parse_args(argv):
    """Parse ``argv``; a ``train --recipe NAME`` is expanded into its flags
    right after the subcommand (explicit flags, wherever they stand, then
    override the bundle) and parsed again."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if getattr(args, "recipe", ""):
        rest, i = [], 0
        while i < len(argv):
            tok = argv[i]
            if tok == "--recipe":
                i += 2
                continue
            if not tok.startswith("--recipe="):
                rest.append(tok)
            i += 1
        sub_i = next(k for k, tok in enumerate(rest)
                     if not tok.startswith("-"))
        args = ap.parse_args(rest[:sub_i + 1] + RECIPES[args.recipe]
                             + rest[sub_i + 1:])
    return args


def main(argv=None) -> int:
    from socialways_torch.device import resolve_device
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    device = resolve_device("cpu" if args.cpu else None)
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
