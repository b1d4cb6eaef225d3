#!/usr/bin/env python3
"""K=20 rollout rate of the port's serving path on one GPU, alone.

    python3 rollout_rate.py [--repo DIR] [--repeats 20]

Imports ``socialways_torch`` from DIR (default: this checkout), so two
trees are compared under one harness: run it alternately with ``--repo``
of each, one process a run.  Model, data and rate are those of
``chip_smoke.py``'s serving phase: the loo model at full width (hidden 64,
batch 256, K 20, 8+12 steps) with random weights from seed 1, on its
seeded synthetic ETH/UCY-scale npz; agent-steps/s = valid windows x K x
n_next / seconds of the rollouts of the whole test split.  Prints the
median rate over the repeats, then where the attention's share of it goes:
- the same rollouts with the attention call replaced by a fixed output
  tensor (no wrapper, no kernel), alternated with the real ones in this
  process, so the difference is the attention's cost in the rollout;
- the host time of one ``social_attention`` call (the generator's entry
  to the kernels) on test chunk 0's agents (the call returns before the
  device runs it; synchronized between calls);
- one chunk's device time and untraced wall (torch.profiler, as
  ``chip_smoke.py`` takes them).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose socialways_torch is measured")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs              # numpy only at import
    sys.path.insert(0, os.path.abspath(args.repo))
    import socialways_torch
    from socialways_torch.config import TrainConfig
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer, chunk_of
    from socialways_torch.eval.metrics import k_sample_rollout
    from socialways_torch.io.checkpoint import (restore_generator,
                                                save_generator_checkpoint)
    from socialways_torch.kernels import _build
    from socialways_torch.models.generator import init_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"socialways_torch from {os.path.dirname(socialways_torch.__file__)}"
          f" on {torch.cuda.get_device_name(0)}")
    _build.build(["social_attention_fwd"])
    work = tempfile.mkdtemp(prefix="rollout_rate_")
    try:
        npz = os.path.join(work, "ethucy_like-8-12.npz")
        cs.make_ethucy_like_npz(npz)
        cfg = TrainConfig(agent_frame=True, use_social=True,
                          g_ema_decay=0.999, hidden_size=cs.HIDDEN,
                          social_feature_size=cs.HIDDEN,
                          noise_len=cs.HIDDEN // 2, batch_size=cs.BATCH,
                          n_past=cs.N_PAST, n_next=cs.N_NEXT,
                          n_gen_samples=cs.K)
        ds = load_npz_dataset(npz)
        ckpt = os.path.join(work, "loo-init.npz")
        save_generator_checkpoint(
            ckpt, init_generator(cfg, torch.Generator().manual_seed(1),
                                 "cpu"), 0, ds.scale, cfg)
        gen = restore_generator(ckpt, cfg, dev)[0]
        trainer = Trainer(cfg, ds, dev)
        n_chunks = trainer.test_packed.n_chunks
        n_valid = int(trainer.test_packed.n_valid.sum())
        rng = torch.Generator(device=dev).manual_seed(0)
        chunks = [chunk_of(trainer.test_dev, i) for i in range(n_chunks)]

        import socialways_torch.models.generator as gmod
        attention = gmod.social_attention
        fixed = torch.zeros((cs.BATCH, cs.HIDDEN), device=dev)

        def rollouts():
            for c in chunks:
                k_sample_rollout(gen, c["obsvs"], c["scene_ids"], cs.K, cfg,
                                 rng)

        def rate(fwd) -> float:
            gmod.social_attention = fwd
            torch.cuda.synchronize()
            tic = time.perf_counter()
            rollouts()
            torch.cuda.synchronize()
            gmod.social_attention = attention
            return n_valid * cs.K * cs.N_NEXT / (time.perf_counter() - tic)
        for _ in range(2):
            rollouts()
        rates, bare = [], []
        for _ in range(args.repeats):
            rates.append(rate(attention))
            bare.append(rate(lambda *a: fixed))
        ms = lambda r: n_valid * cs.K * cs.N_NEXT / r / n_chunks * 1e3
        print(f"rollout: {n_valid} windows x K={cs.K} x {cs.N_NEXT} steps, "
              f"{n_chunks} chunks, {args.repeats} repeats: median "
              f"{np.median(rates):.4g} agent-steps/s (min {min(rates):.4g}, "
              f"max {max(rates):.4g}); {ms(np.median(rates)):.3f} ms a chunk")
        print(f"rollout with the attention replaced by a fixed tensor, "
              f"alternated: median {np.median(bare):.4g} agent-steps/s, "
              f"{ms(np.median(bare)):.3f} ms a chunk -> the attention "
              f"{ms(np.median(rates)) - ms(np.median(bare)):.3f} ms a chunk")
        c0 = chunks[0]
        x4 = torch.rand((cs.BATCH, 4), device=dev)
        h = torch.tanh(torch.randn((cs.BATCH, cs.HIDDEN), device=dev))
        host = []
        with torch.no_grad():
            for _ in range(200):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                attention(gen.feat_mlp, gen.attn_w, x4, h, c0["scene_ids"])
                host.append((time.perf_counter() - tic) * 1e6)
        torch.cuda.synchronize()
        print(f"social_attention host time a call: median "
              f"{np.median(host[20:]):.1f} us (180 calls after 20)")
        cs.profile_step(torch, "one chunk's K=20 rollout",
                        lambda: k_sample_rollout(gen, c0["obsvs"],
                                                 c0["scene_ids"], cs.K, cfg,
                                                 rng))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"repo": os.path.abspath(args.repo),
                      "median_agent_steps_s": float(np.median(rates)),
                      "median_without_attention": float(np.median(bare)),
                      "fwd_host_us": float(np.median(host[20:]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
