"""Multi-seed ensemble training: M independent GAN replicas trained as one
batched step.

Counterpart of socialways_tpu/engine/ensemble.py.
Seed-robustness protocols train one recipe under several seeds and score
each final model (benchmarks/coverage_ensemble.py).  The model is small
and a solo step leaves the card idle between its ~2.4k launches, so the
members train together: ``gan_step(..., members=True)`` runs the step's
loss code once under ``torch.func.vmap`` over the stacked members
(models/stacked.py), every product a batched product and each attention
kernel one launch for all members.

Member independence is exact: member m keeps its own parameters,
optimizer moments and EMA (the stacked leaves' slice m) and its own
random streams, drawn as a solo run with its seed draws them:
- init: ``Trainer.init_state(seed_m)`` (a CPU generator seeded seed_m);
- step draws: ``draw_step`` from member m's own device generator, in the
  order ``Trainer.train_epoch`` draws them;
- eval noise: a device generator seeded seed_m, one ``draw_noise`` a test
  chunk, as ``Trainer.evaluate(g, seed_m)``;
- coverage noise: as the CLI's ``_coverage`` with seed_m.
The packed data is shared (JAX's ``in_axes=(0, 0, None)``).  So member m
equals the solo run up to float reassociation of the batched products.

Each member keeps its own optimizer counts, as JAX's stacked leaves do
(``[M]`` int32 tensors): members at different counts follow their own
schedules, instance noise, info weight and D/G ratio.

On the card with ``epoch_on_device`` (the default) every step of an epoch
is a replay of a captured CUDA graph of the member step
(``engine/graphed.py``), JAX's ``jit`` of ``vmap`` of the epoch scan.

With a ``mesh`` (``parallel.Mesh``) the member axis is sharded over the
ranks (JAX's :50-94): rank r trains members [r M/D, (r + 1) M/D) with no
collective in the step (members are independent), and the per-member
metrics, evaluations and coverages are all-gathered, so every rank returns
all M.  Callers pass every member's seed and generator on every rank.  On
the card each rank's epoch is graphed as without a mesh (JAX's ``jit`` of
``shard_map`` of ``vmap`` of the scan, :60-125): nothing collective is
captured, so this holds on gloo too, and the metrics are gathered once an
epoch.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from socialways_torch.engine.graphed import (EpochGraphs, add_metrics,
                                             epoch_means)
from socialways_torch.engine.train_step import (AdamState, StepMetrics,
                                                TrainState, draw_step,
                                                eval_params, gan_step,
                                                stack_draws)
from socialways_torch.engine.trainer import Trainer, chunk_of
from socialways_torch.eval.metrics import (EvalSums, draw_noise,
                                           eval_chunk_members,
                                           finalize_eval,
                                           k_sample_rollout_members)
from socialways_torch.eval.stats import toy_mode_coverage
from socialways_torch.models.stacked import member_module, stack_modules
from socialways_torch.parallel.mesh import all_gather_rows


def _stack_opts(opts: Sequence[AdamState]) -> AdamState:
    """The members' optimizer states as one: moments [M, ...], counts
    [M]."""
    first = opts[0]
    stack = lambda key: {k: torch.stack([getattr(o, key)[k] for o in opts])
                         for k in getattr(first, key)}
    return dataclasses.replace(
        first, count=torch.stack([o.count for o in opts]),
        schedule_count=(None if first.schedule_count is None else
                        torch.stack([o.schedule_count for o in opts])),
        mu=stack("mu"), nu=stack("nu"))


def stack_states(states: Sequence[TrainState]) -> TrainState:
    """The members' TrainStates as one, every tensor leaf (the optimizer
    counts too) stacked on a leading member axis."""
    emas = [s.g_ema for s in states]
    return TrainState(
        stack_modules([s.g for s in states]),
        stack_modules([s.d for s in states]),
        _stack_opts([s.g_opt for s in states]),
        _stack_opts([s.d_opt for s in states]),
        None if emas[0] is None else stack_modules(emas))


def member_state(stacked: TrainState, i: int) -> TrainState:
    """Member ``i``'s TrainState, a solo state (copies), e.g. to checkpoint
    it with ``io.checkpoint.save_checkpoint``."""
    def opt(o: AdamState) -> AdamState:
        return dataclasses.replace(
            o, count=o.count[i].clone(),
            schedule_count=(None if o.schedule_count is None
                            else o.schedule_count[i].clone()),
            mu={k: v[i].clone() for k, v in o.mu.items()},
            nu={k: v[i].clone() for k, v in o.nu.items()})
    return TrainState(member_module(stacked.g, i),
                      member_module(stacked.d, i), opt(stacked.g_opt),
                      opt(stacked.d_opt),
                      None if stacked.g_ema is None
                      else member_module(stacked.g_ema, i))


class EnsembleTrainer:
    """Wraps a single-device :class:`Trainer` (its packed data, config and
    device) and trains M members jointly, one member-batched ``gan_step``
    a chunk.  It takes every configuration the solo ``Trainer`` takes
    (bf16, accumulation, remat and every loss).  ``mesh``: this rank's
    view of a mesh over which the members are sharded (the trainer on
    the rank's device)."""

    def __init__(self, trainer: Trainer, mesh=None):
        if trainer.mesh is not None:
            raise ValueError("EnsembleTrainer wraps a SINGLE-DEVICE "
                             "trainer; pass mesh= to EnsembleTrainer to "
                             "shard the member axis instead")
        if mesh is not None and trainer.device != mesh.device:
            raise ValueError(f"the trainer's device {trainer.device} is "
                             f"not the rank's {mesh.device}")
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.mesh = mesh

    def _span(self, n_members: int) -> slice:
        """This rank's members (all of them without a mesh), after JAX's
        check that the members divide over the mesh."""
        d = 1 if self.mesh is None else self.mesh.size
        if n_members % d:
            raise ValueError(
                f"{n_members} ensemble members not divisible by the "
                f"{d}-device mesh")
        m, r = n_members // d, 0 if self.mesh is None else self.mesh.rank
        return slice(r * m, (r + 1) * m)

    def _local(self, members: Sequence) -> Sequence:
        return members[self._span(len(members))]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """[m_local, ...] of every rank -> [M, ...] in member order."""
        return t if self.mesh is None else all_gather_rows(t, self.mesh)

    def init_states(self, seeds: Sequence[int]) -> TrainState:
        """Member m drawn as ``Trainer.init_state(seeds[m])`` (this rank's
        members on a mesh)."""
        return stack_states([self.trainer.init_state(s)
                             for s in self._local(seeds)])

    @property
    def graphed(self) -> bool:
        """Whether the epochs run as CUDA graph replays of the member step
        (the trainer's ``graphed``; under a member mesh each rank replays
        its own members' step, which holds no collective)."""
        return self.trainer.graphed

    @functools.cached_property
    def epoch_graphs(self) -> EpochGraphs:
        """The captured member steps of the training split."""
        tr = self.trainer
        return EpochGraphs(self.cfg, tr.train_dev, tr.train_counts,
                           members=True)

    def _epoch(self, states: TrainState,
               generators: Sequence[torch.Generator]
               ) -> Tuple[TrainState, StepMetrics]:
        """One epoch of member-batched steps; member m's draws from
        ``generators[m]``, drawn as ``Trainer.train_epoch`` draws them.
        The per-member metrics [M] on the device."""
        tr, cfg = self.trainer, self.cfg
        per_member = [[draw_step(tr.train_packed.width, cfg, g, tr.device)
                       for _ in range(tr.n_steps_per_epoch)]
                      for g in self._local(generators)]
        draws = [stack_draws([d[i] for d in per_member])
                 for i in range(tr.n_steps_per_epoch)]
        if self.graphed:
            return states, self.epoch_graphs.epoch(states,
                                                   stack_draws(draws))
        sums = None
        for i in range(tr.n_steps_per_epoch):
            states, m = gan_step(states, chunk_of(tr.train_dev, i), draws[i],
                                 cfg, n_valid=int(tr.train_packed.n_valid[i]),
                                 members=True)
            sums = add_metrics(sums, m)
        return states, epoch_means(sums, tr.n_steps_per_epoch)

    def _metrics(self, m: StepMetrics, tic: float, n: int = 1) -> Dict:
        """Per-member metrics (numpy [M], one host read) as
        ``Trainer.train_epoch`` gives a solo run's, with the wall time a
        epoch and the step count of ``n`` epochs."""
        tr = self.trainer
        vals = np.array(self._gather(torch.stack([
            m.d_loss, m.g_loss, m.ade_sum, m.fde_sum,
            m.n_samples.to(m.ade_sum.dtype)], dim=1)).T.tolist())
        d_loss, g_loss, ade_sum, fde_sum, n_samp = vals
        n_s, ss = np.maximum(n_samp, 1), tr.dataset.ss
        return {
            "d_loss": d_loss,
            "g_loss": g_loss,
            "train_ade": ade_sum / ss / n_s,
            "train_fde": fde_sum / ss / n_s,
            "epoch_time_s": (time.perf_counter() - tic) / n,
            "steps": tr.n_steps_per_epoch * n,
        }

    def train_epoch(self, states: TrainState,
                    generators: Sequence[torch.Generator]
                    ) -> Tuple[TrainState, Dict]:
        """One member-batched ``gan_step`` a chunk (graphed on the card
        with ``epoch_on_device``); member m's draws come from
        ``generators[m]`` (a device generator), drawn as
        ``Trainer.train_epoch`` draws them.  Per-member metrics (numpy
        [M]) as ``Trainer.train_epoch`` gives a solo run's, with the wall
        time and step count."""
        tic = time.perf_counter()
        states, m = self._epoch(states, generators)
        return states, self._metrics(m, tic)

    def train_epochs(self, states: TrainState,
                     generators: Sequence[torch.Generator], n: int
                     ) -> Tuple[TrainState, Dict]:
        """``n`` epochs and one metrics read (JAX's ``jit`` of ``vmap`` of
        the epochs scan); the LAST epoch's per-member metrics (d_loss,
        g_loss, train_ade, train_fde), with the mean epoch time and the
        steps of all ``n``."""
        tic = time.perf_counter()
        for _ in range(n):
            states, m = self._epoch(states, generators)
        return states, self._metrics(m, tic, n)

    def _noise_rngs(self, seeds: Sequence[int]) -> List[torch.Generator]:
        return [torch.Generator(device=self.trainer.device).manual_seed(s)
                for s in seeds]

    def evaluate(self, states: TrainState, seeds: Sequence[int],
                 n_gen_samples: Optional[int] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[Dict[str, float]]:
        """One metrics dict per member, as ``Trainer.evaluate(member's
        eval generator, seeds[m], n_gen_samples)`` gives it: member m's
        noise from a device generator seeded ``seeds[m]``, one draw a test
        chunk.  ``noises`` (one [M, K, W, noise_len] tensor a chunk)
        replaces the draws."""
        tr = self.trainer
        if tr.test_dev is None:
            return []
        k = n_gen_samples or self.cfg.n_gen_samples
        rngs = self._noise_rngs(self._local(seeds))
        g, total = eval_params(states), None
        for i in range(tr.test_packed.n_chunks):
            noise = torch.stack([draw_noise(k, tr.test_packed.width,
                                            self.cfg, r, tr.device)
                                 for r in rngs]) if noises is None else (
                noises[i][self._span(len(seeds))].to(tr.device))
            s = eval_chunk_members(g, chunk_of(tr.test_dev, i), k, self.cfg,
                                   noise)
            total = s if total is None else EvalSums(
                *(a + b for a, b in zip(total, s)))
        sums = self._gather(torch.stack(
            [x.to(total.ade_avg.dtype) for x in total], dim=1)).cpu()
        return [finalize_eval(EvalSums(*sums[m]), tr.dataset.ss,
                              tr.dataset.n_test_samples)
                for m in range(len(seeds))]

    def coverage(self, states: TrainState, seeds: Sequence[int],
                 n_samples: int = 64) -> List[float]:
        """Per-member toy mode coverage of ``cfg.n_gen_samples`` rollouts
        of (up to) the first ``n_samples`` test samples, member m's noise
        seeded ``seeds[m]``: the protocol of ``cli train
        --track-coverage`` (the CLI's ``_coverage``)."""
        tr, ds, cfg = self.trainer, self.trainer.dataset, self.cfg
        nt = ds.n_train_samples
        obs = ds.obsvs[nt:nt + n_samples]
        ids = ds.scene_ids_for_rows(nt, obs.shape[0])
        k = cfg.n_gen_samples
        local = self._local(seeds)
        noise = torch.stack([draw_noise(k, obs.shape[0], cfg, r, tr.device)
                             for r in self._noise_rngs(local)])
        pk = k_sample_rollout_members(
            eval_params(states), torch.from_numpy(obs).to(tr.device),
            torch.from_numpy(ids).to(tr.device), k, cfg, noise)
        finals = ds.scale.denormalize(pk[..., :2].cpu().numpy())
        obs_w = ds.scale.denormalize(obs)
        cov = torch.tensor([toy_mode_coverage(obs_w, finals[m])
                            for m in range(len(local))], dtype=torch.float64,
                           device=tr.device)
        return self._gather(cov).tolist()
