"""Command-line entry points of the port: the serving path.

    python -m socialways_torch.cli.main evaluate --data hotel-8-12.npz --model-file ckpt.npz
    python -m socialways_torch.cli.main evaluate --data hotel-8-12.npz --linear
    python -m socialways_torch.cli.main predict --data hotel-8-12.npz --model-file ckpt.npz --out preds.npz
    python -m socialways_torch.cli.main --cpu evaluate ...   # run on the CPU

Flags, outputs and printouts follow socialways_tpu/cli/main.py:822-974.
Everything runs on the GPU unless ``--cpu`` is given.  The model flags are
the widths and switches of the served FC generator; a checkpoint's
embedded config overrides them.  Training flags, recipes, ``predict`` on
raw annotation files and ``--linear kalman`` belong to later slices of the
port.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="socialways-torch",
        description="Social Ways serving path on PyTorch/CUDA")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; "
                         "without one the command fails)")
    sub = ap.add_subparsers(dest="command", required=True)

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


def main(argv=None) -> int:
    from socialways_torch.device import resolve_device
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device("cpu" if args.cpu else None)
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
