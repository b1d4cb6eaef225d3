"""Trainer: packed test data on the device, and K-sample evaluation.

Counterpart of socialways_tpu/engine/trainer.py:91-115 (test-split packing
and its one-time transfer) and :269-290 (``evaluate``), without a mesh.
The training methods come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.data.dataset import (PackedBatches, TrajectoryDataset,
                                           pack_scene_batches)
from socialways_torch.device import resolve_device
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


def chunk_of(batches: Dict[str, torch.Tensor], i: int
             ) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batches.items()}


class Trainer:
    """Owns the packed test split on ``device`` (``None`` = ``cuda``; it
    raises when there is no GPU rather than run on the CPU)."""

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

