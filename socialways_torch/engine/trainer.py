"""Trainer: packed data on the device, the epoch loop, and K-sample
evaluation.

Counterpart of socialways_tpu/engine/trainer.py:51-77 (the grad-accum
alignment check), :83-160 (packing and the one-time transfer of both
splits, the -1 anneal sentinel), :153-266 (the epoch loop) and :269-290
(``evaluate``).  JAX scans the GAN step over the chunks on the device
(``epoch_on_device``, its default; socialways_tpu/engine/trainer.py:
138-231).  So does the port on the card: with ``epoch_on_device`` every
step of ``train_epoch`` and ``train_epochs`` is the replay of a captured
CUDA graph of ``gan_step`` (engine/graphed.py), bit for bit the eager
step, with no host read of a device value between the epoch's start (the
G count, read once when the D/G ratio needs it) and its one metrics read.
``epoch_on_device=False`` (``--host-loop``) runs the same steps eagerly,
one Python call of ``gan_step`` a chunk, as JAX keeps its per-chunk host
loop; on the CPU (the tests, ``--cpu``) the loop is eager, since graphs
are CUDA's.  Either way the metrics are summed on the device and read
once at the epoch's end.

With a ``mesh`` (``parallel.Mesh``, one rank of a data-parallel group)
the same loop runs data-parallel: the chunks are grouped D at a time
(``parallel.shard_packed_for_mesh``, filler chunks padding the last
group), each rank holds its column of the groups on its device, and a
step is one group (JAX's :206-231): the draws are the group's global
draws, identical on every rank, and the metrics come back reduced.  The
[groups, D] valid counts go to the device once, and the step's count
weights are computed there from them.  On the card with
``epoch_on_device`` and NCCL every step is again a replay of a captured
graph, its gradient and metric all-reduces captured with it (JAX's
``make_dp_epoch_fn``; engine/graphed.py), and ``--host-loop`` runs the
same DP steps eagerly, bit for bit.  gloo's collectives are staged on the
host and cannot be captured: a gloo mesh on a CUDA device with
``epoch_on_device`` raises rather than train eagerly without a word.  On
the CPU (gloo ranks, ``--cpu --mesh``) the DP loop is eager; the tests
run the graphed DP loop there with the capture stubbed.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.data.dataset import (PackedBatches, TrajectoryDataset,
                                           pack_scene_batches)
from socialways_torch.device import resolve_device
from socialways_torch.engine.graphed import (EpochGraphs, add_metrics,
                                             epoch_means, solo_clock)
from socialways_torch.engine.train_step import (StepDraws, StepMetrics,
                                                TrainState, draw_step,
                                                gan_step, init_train_state,
                                                stack_draws)
from socialways_torch.eval.metrics import EvalSums, eval_chunk, finalize_eval
from socialways_torch.models.generator import Generator
from socialways_torch.parallel.mesh import (group_valid_counts, rank_column,
                                            shard_packed_for_mesh)


def packed_to_device(packed: PackedBatches, device, mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """One host-to-device copy of every packed chunk; with a ``mesh``, of
    this rank's column of the chunk groups ([groups, width, ...])."""
    arrays = {"obsvs": packed.obsvs, "preds": packed.preds,
              "scene_ids": packed.scene_ids, "valid": packed.valid}
    if mesh is not None:
        arrays = rank_column(shard_packed_for_mesh(packed, mesh.size),
                             mesh.rank, mesh.size)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


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


def run_epoch(state: TrainState, batches: Dict[str, torch.Tensor],
              draws: Sequence[StepDraws], cfg: TrainConfig,
              counts: Optional[np.ndarray] = None, mesh=None
              ) -> Tuple[TrainState, StepMetrics]:
    """One ``gan_step`` a step of ``batches`` ([steps, width, ...]: the
    chunks, or this rank's column of the chunk groups on a ``mesh``) with
    ``draws[i]`` (the group's global draws on a mesh).  ``counts``: the
    [steps, D] host valid counts (None: each step counts its rows on the
    device); under a mesh they are copied to the device once, and each
    step takes the rank's and the group's counts as device tensors, as the
    graphed epoch's steps do (a group that is all padding is the no-op,
    known from packing).  Returns the state and
    the epoch's metrics on the device: mean losses, summed errors and
    sample counts (socialways_tpu/parallel/mesh.py:126-147).  The solo D/G
    ratio takes its G count from one read at the start (every step with
    valid rows advances it by one)."""
    n = batches["valid"].shape[0]
    g_count = None if counts is None else solo_clock(cfg, state)
    on_dev = (None if counts is None or mesh is None
              else torch.from_numpy(counts).to(batches["valid"].device))
    sums = None
    for i in range(n):
        if counts is None:
            kw = {}
        elif mesh is None:
            kw = dict(n_valid=int(counts[i, 0]))
        elif not counts[i].sum():
            kw = dict(n_valid=0, n_valid_global=0)
        else:
            kw = dict(n_valid=on_dev[i, mesh.rank],
                      n_valid_global=on_dev[i].sum())
        state, m = gan_step(state, chunk_of(batches, i), draws[i], cfg,
                            mesh=mesh, g_count=g_count, **kw)
        sums = add_metrics(sums, m)
        if g_count is not None and counts[i].sum():
            g_count += 1
    return state, epoch_means(sums, n)


def check_graphable(cfg: TrainConfig, device: torch.device, mesh=None
                    ) -> bool:
    """Whether a trainer's epochs run as CUDA graph replays:
    ``epoch_on_device`` on a CUDA device.  A mesh whose backend is not
    NCCL there raises: its collectives cannot be captured."""
    if not (cfg.epoch_on_device and device.type == "cuda"):
        return False
    if mesh is not None and mesh.backend != "nccl":
        raise ValueError(
            f"a {mesh.backend} mesh on {device} cannot capture its "
            "collectives in a CUDA graph: train it eagerly with "
            "epoch_on_device=False (--host-loop), or use NCCL")
    return True


class Trainer:
    """Owns both packed splits on ``device`` (``None`` = ``cuda``; it
    raises when there is no GPU rather than run on the CPU), or, with a
    ``mesh``, this rank's column of them on the mesh's device.  The
    training split is packed and copied on its first use, so that
    evaluation alone does no training-only work.  On the card with
    ``epoch_on_device`` it also owns the epoch's CUDA graphs, freed with
    it."""

    def __init__(self, cfg: TrainConfig, dataset: TrajectoryDataset,
                 device=None, mesh=None):
        self.cfg = cfg.replace(n_past=dataset.n_past, n_next=dataset.n_next)
        check_supported(self.cfg)
        self.dataset = dataset
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        check_graphable(self.cfg, self.device, mesh)
        self.n_dev = 1 if mesh is None else mesh.size
        nt = dataset.n_train_samples
        if len(dataset.test_batches):
            test_batches = dataset.test_batches - dataset.test_batches[0][0]
            self.test_packed = pack_scene_batches(
                dataset.obsvs[nt:], dataset.preds[nt:], test_batches,
                cfg.batch_size)
            self.test_dev = packed_to_device(self.test_packed, self.device,
                                             mesh)
        else:
            self.test_packed = None
            self.test_dev = None
        if self.cfg.d_input_noise_steps < 0:
            # -1 = anneal over the whole planned run, in optimizer steps
            # (groups on a mesh; socialways_tpu/engine/trainer.py:125-134)
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
        """One host-to-device copy of the training split (this rank's
        column on a mesh)."""
        return packed_to_device(self.train_packed, self.device, self.mesh)

    @functools.cached_property
    def train_counts(self) -> np.ndarray:
        """[steps, D] valid rows of each rank's chunk of each step."""
        return group_valid_counts(self.train_packed, self.n_dev)

    @property
    def n_steps_per_epoch(self) -> int:
        """Optimizer steps one epoch performs: one per packed chunk, one
        per chunk group on a mesh."""
        return -(-self.train_packed.n_chunks // self.n_dev)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """G, D, both optimizers and the EMA, drawn from ``seed``
        (default ``cfg.seed``) on the CPU and moved to the device."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed if seed is None else seed)
        return init_train_state(self.cfg, gen, self.device)

    def _draws(self, generator: torch.Generator) -> List[StepDraws]:
        """One epoch's draws: one ``StepDraws`` a step, for its global
        batch on a mesh."""
        return [draw_step(self.n_dev * self.train_packed.width, self.cfg,
                          generator, self.device)
                for _ in range(self.n_steps_per_epoch)]

    @property
    def graphed(self) -> bool:
        """Whether the epochs run as CUDA graph replays: ``epoch_on_device``
        on a CUDA device (under a mesh, an NCCL one)."""
        return check_graphable(self.cfg, self.device, self.mesh)

    @functools.cached_property
    def epoch_graphs(self) -> EpochGraphs:
        """The captured steps of the training split, or of this rank's
        column of its groups (built on first use)."""
        return EpochGraphs(self.cfg, self.train_dev, self.train_counts,
                           mesh=self.mesh)

    def _graphed_epochs(self, state: TrainState, n: int,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Sequence[StepDraws]] = None
                        ) -> Tuple[TrainState, StepMetrics]:
        """``n`` graphed epochs (``draws``: the one epoch's); the last
        epoch's device metrics.  The solo G count is read once for all
        ``n``."""
        g_count = solo_clock(self.cfg, state)
        steps = int((self.train_counts.sum(axis=1) > 0).sum())
        for _ in range(n):
            m = self.epoch_graphs.epoch(state, stack_draws(
                self._draws(generator) if draws is None else draws), g_count)
            if g_count is not None:
                g_count += steps
        return state, m

    def _host_metrics(self, m: StepMetrics, tic: float) -> Dict[str, float]:
        """JAX's epoch metrics from the device's (one host read): mean
        losses, train ADE/FDE in meters, the time since ``tic`` and the
        step count."""
        d_loss, g_loss, ade_sum, fde_sum, n_samp = torch.stack(
            [m.d_loss, m.g_loss, m.ade_sum, m.fde_sum,
             m.n_samples.to(m.ade_sum.dtype)]).tolist()
        n_s, ss = max(int(n_samp), 1), self.dataset.ss
        return {
            "d_loss": d_loss,
            "g_loss": g_loss,
            "train_ade": ade_sum / ss / n_s,
            "train_fde": fde_sum / ss / n_s,
            "epoch_time_s": time.perf_counter() - tic,
            "steps": self.n_steps_per_epoch,
        }

    def train_epoch(self, state: TrainState,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Sequence[StepDraws]] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """One ``gan_step`` per chunk (per chunk group on a mesh).  The
        draws come from ``generator`` (a ``torch.Generator`` on the
        device), one ``StepDraws`` per step, or from ``draws``.  Returns
        the same metrics as JAX: per-step mean losses, train ADE/FDE in
        meters, wall time and step count."""
        tic = time.perf_counter()
        if self.graphed:
            state, m = self._graphed_epochs(state, 1, generator, draws)
        else:
            state, m = run_epoch(
                state, self.train_dev,
                self._draws(generator) if draws is None else draws,
                self.cfg, self.train_counts, self.mesh)
        return state, self._host_metrics(m, tic)

    def train_epochs(self, state: TrainState, generator: torch.Generator,
                     n: int) -> Tuple[TrainState, Dict[str, float]]:
        """``n`` epochs (JAX's ``_epochs_fn``: graphed, n x steps replays
        and one metrics read); the LAST epoch's metrics, with the mean
        epoch time and the steps of all ``n``."""
        tic = time.perf_counter()
        if self.graphed:
            state, m = self._graphed_epochs(state, n, generator)
            m = self._host_metrics(m, tic)
        else:
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

        One noise draw per chunk (per chunk group on a mesh, for the
        group's global batch) from a ``torch.Generator`` seeded with
        ``seed`` on the device; ``noises`` (one [K, W, noise_len] tensor per
        chunk, [K, D W, noise_len] per group) replaces the draws.  On a
        mesh every rank evaluates its rows and the sums are reduced."""
        if self.test_dev is None:
            return {}
        k = n_gen_samples or self.cfg.n_gen_samples
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)
        total = None
        for i in range(self.test_dev["valid"].shape[0]):
            noise = None if noises is None else noises[i].to(self.device)
            s = eval_chunk(g_params, chunk_of(self.test_dev, i), k, self.cfg,
                           rng, noise, mesh=self.mesh)
            total = s if total is None else EvalSums(
                *(a + b for a, b in zip(total, s)))
        return finalize_eval(total, self.dataset.ss,
                             self.dataset.n_test_samples)

