"""Trainer: packed data on the device, the epoch loop, and K-sample
evaluation.

Counterpart of socialways_tpu/engine/trainer.py:51-77 (the grad-accum
alignment check), :91-134 (packing and the one-time transfer of both
splits, the -1 anneal sentinel), :153-266 (the
epoch loop) and :269-290 (``evaluate``), without a mesh.  JAX scans the GAN
step over the chunks on the device; here an epoch is a Python loop of
``gan_step`` over the chunks (no CUDA graph, no ``torch.compile``) with the
per-chunk metrics summed on the device and read once at the epoch's end.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.data.dataset import (PackedBatches, TrajectoryDataset,
                                           pack_scene_batches)
from socialways_torch.device import resolve_device
from socialways_torch.engine.train_step import (StepDraws, StepMetrics,
                                                TrainState, draw_step,
                                                gan_step, init_train_state)
from socialways_torch.eval.metrics import EvalSums, eval_chunk, finalize_eval
from socialways_torch.models.generator import Generator


def packed_to_device(packed: PackedBatches, device) -> Dict[str, torch.Tensor]:
    """One host-to-device copy of every packed chunk."""
    return {
        "obsvs": torch.from_numpy(packed.obsvs).to(device),
        "preds": torch.from_numpy(packed.preds).to(device),
        "scene_ids": torch.from_numpy(packed.scene_ids).to(device),
        "valid": torch.from_numpy(packed.valid).to(device),
    }


def fork_seed(rng: torch.Generator) -> int:
    """A seed drawn from ``rng``'s stream (for an eval's noise or a
    re-initialized discriminator)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device))


def stream_seed(seed: int, *stream: int) -> int:
    """A 32-bit seed for random stream ``stream`` of a run seeded ``seed``
    (numpy's SeedSequence hash of the tuple): draws from it leave the run's
    own stream where it is, as ``jax.random.fold_in`` does."""
    return int(np.random.SeedSequence((seed,) + stream).generate_state(1)[0])


def check_grad_accum_alignment(packed: PackedBatches, grad_accum: int,
                               use_social: bool) -> None:
    """``grad_accum``'s contract on the packed chunks
    (socialways_tpu/engine/trainer.py:51-77): the width divides into equal
    micro-chunks and, with social attention (the one case where rows
    interact), no scene crosses a micro-chunk boundary."""
    width = packed.scene_ids.shape[1]
    if width % grad_accum:
        raise ValueError(
            f"packed chunk width {width} is not divisible by "
            f"grad_accum={grad_accum}; pick a divisor of the width "
            "(= max(batch_size, largest scene group))")
    if not use_social:
        return
    sub = width // grad_accum
    for b in range(sub, width, sub):
        left, right = packed.scene_ids[:, b - 1], packed.scene_ids[:, b]
        bad = (left == right) & (right != -1)
        if bad.any():
            ci = int(np.argmax(bad))
            raise ValueError(
                f"grad_accum={grad_accum} splits scene "
                f"{int(right[ci])} of packed chunk {ci} at row {b}: "
                "social attention must not cross micro-chunk boundaries "
                "(re-pack with scene-aligned widths or use a smaller "
                "grad_accum)")


def chunk_of(batches: Dict[str, torch.Tensor], i: int
             ) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batches.items()}


class Trainer:
    """Owns both packed splits on ``device`` (``None`` = ``cuda``; it
    raises when there is no GPU rather than run on the CPU).  The training
    split is packed and copied on its first use, so that evaluation alone
    does no training-only work."""

    def __init__(self, cfg: TrainConfig, dataset: TrajectoryDataset,
                 device=None):
        self.cfg = cfg.replace(n_past=dataset.n_past, n_next=dataset.n_next)
        check_supported(self.cfg)
        self.dataset = dataset
        self.device = resolve_device(device)
        nt = dataset.n_train_samples
        if len(dataset.test_batches):
            test_batches = dataset.test_batches - dataset.test_batches[0][0]
            self.test_packed = pack_scene_batches(
                dataset.obsvs[nt:], dataset.preds[nt:], test_batches,
                cfg.batch_size)
            self.test_dev = packed_to_device(self.test_packed, self.device)
        else:
            self.test_packed = None
            self.test_dev = None
        if self.cfg.d_input_noise_steps < 0:
            # -1 = anneal over the whole planned run, in optimizer steps
            # (socialways_tpu/engine/trainer.py:125-134)
            self.cfg = self.cfg.replace(
                d_input_noise_steps=cfg.n_epochs * self.n_steps_per_epoch)

    @functools.cached_property
    def train_packed(self) -> PackedBatches:
        ds = self.dataset
        nt = ds.n_train_samples
        packed = pack_scene_batches(ds.obsvs[:nt], ds.preds[:nt],
                                    ds.train_batches, self.cfg.batch_size)
        if self.cfg.grad_accum > 1:
            check_grad_accum_alignment(packed, self.cfg.grad_accum,
                                       self.cfg.use_social)
        return packed

    @functools.cached_property
    def train_dev(self) -> Dict[str, torch.Tensor]:
        """One host-to-device copy of the training split."""
        return packed_to_device(self.train_packed, self.device)

    @property
    def n_steps_per_epoch(self) -> int:
        """Optimizer steps one epoch performs: one per packed chunk."""
        return self.train_packed.n_chunks

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """G, D, both optimizers and the EMA, drawn from ``seed``
        (default ``cfg.seed``) on the CPU and moved to the device."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed if seed is None else seed)
        return init_train_state(self.cfg, gen, self.device)

    def train_epoch(self, state: TrainState,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Sequence[StepDraws]] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """One ``gan_step`` per chunk.  The draws come from ``generator``
        (a ``torch.Generator`` on the device), one ``StepDraws`` per chunk,
        or from ``draws``.  Returns the same metrics as JAX: per-chunk mean
        losses, train ADE/FDE in meters, wall time and step count."""
        tic = time.perf_counter()
        if draws is None:
            draws = [draw_step(self.train_packed.width, self.cfg, generator,
                               self.device)
                     for _ in range(self.n_steps_per_epoch)]
        sums = None
        for i in range(self.n_steps_per_epoch):
            state, m = gan_step(state, chunk_of(self.train_dev, i),
                                draws[i], self.cfg,
                                n_valid=int(self.train_packed.n_valid[i]))
            sums = m if sums is None else StepMetrics(
                *(a + b for a, b in zip(sums, m)))
        n_chunks = self.n_steps_per_epoch
        vals = torch.stack([sums.d_loss / n_chunks, sums.g_loss / n_chunks,
                            sums.ade_sum, sums.fde_sum,
                            sums.n_samples.to(sums.ade_sum.dtype)]).tolist()
        d_loss, g_loss, ade_sum, fde_sum, n_samp = vals
        toc = time.perf_counter()
        n, ss = max(int(n_samp), 1), self.dataset.ss
        return state, {
            "d_loss": d_loss,
            "g_loss": g_loss,
            "train_ade": ade_sum / ss / n,
            "train_fde": fde_sum / ss / n,
            "epoch_time_s": toc - tic,
            "steps": n_chunks,
        }

    def train_epochs(self, state: TrainState, generator: torch.Generator,
                     n: int) -> Tuple[TrainState, Dict[str, float]]:
        """``n`` epochs; the LAST epoch's metrics, with the mean epoch time
        and the steps of all ``n``."""
        tic = time.perf_counter()
        for _ in range(n):
            state, m = self.train_epoch(state, generator)
        m["epoch_time_s"] = (time.perf_counter() - tic) / n
        m["steps"] = self.n_steps_per_epoch * n
        return state, m

    def evaluate(self, g_params: Generator, seed: int = 0,
                 n_gen_samples: Optional[int] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None
                 ) -> Dict[str, float]:
        """Min-of-K / avg-of-K ADE & FDE over the test split, in meters.

        One noise draw per chunk from a ``torch.Generator`` seeded with
        ``seed`` on the device; ``noises`` (one [K, W, noise_len] tensor per
        chunk) replaces the draws."""
        if self.test_dev is None:
            return {}
        k = n_gen_samples or self.cfg.n_gen_samples
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)
        total = None
        for i in range(self.test_packed.n_chunks):
            noise = None if noises is None else noises[i].to(self.device)
            s = eval_chunk(g_params, chunk_of(self.test_dev, i), k, self.cfg,
                           rng, noise)
            total = s if total is None else EvalSums(
                *(a + b for a, b in zip(total, s)))
        return finalize_eval(total, self.dataset.ss,
                             self.dataset.n_test_samples)

