"""Multi-seed ensemble training: M independent GAN replicas trained as one
batched step.

Counterpart of socialways_tpu/engine/ensemble.py without a mesh.
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

One deliberate limit: the optimizer counts are host integers shared by
the members (the schedules read them on the host), where JAX keeps one
device count a member; ``stack_states`` refuses members whose counts
differ.  ``mesh`` (JAX's member sharding) waits for the port's
``parallel/`` (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from socialways_torch.engine.train_step import (AdamState, StepDraws,
                                                StepMetrics, TrainState,
                                                check_members_supported,
                                                draw_step, eval_params,
                                                gan_step)
from socialways_torch.engine.trainer import Trainer, chunk_of
from socialways_torch.eval.metrics import (EvalSums, draw_noise,
                                           eval_chunk_members,
                                           finalize_eval,
                                           k_sample_rollout_members)
from socialways_torch.eval.stats import toy_mode_coverage
from socialways_torch.models.stacked import member_module, stack_modules


def _stack_opts(opts: Sequence[AdamState]) -> AdamState:
    first = opts[0]
    for o in opts[1:]:
        if (o.count, o.schedule_count, o.clipped) != (
                first.count, first.schedule_count, first.clipped):
            raise ValueError(
                f"ensemble members' optimizer counts differ ({o.count}, "
                f"schedule {o.schedule_count} against {first.count}, "
                f"{first.schedule_count}): the ensemble keeps one host "
                "count for all members")
    stack = lambda key: {k: torch.stack([getattr(o, key)[k] for o in opts])
                         for k in getattr(first, key)}
    return dataclasses.replace(first, mu=stack("mu"), nu=stack("nu"))


def stack_states(states: Sequence[TrainState]) -> TrainState:
    """The members' TrainStates as one, every tensor leaf stacked on a
    leading member axis; the optimizer counts, equal in every member, stay
    host integers."""
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
            o, mu={k: v[i].clone() for k, v in o.mu.items()},
            nu={k: v[i].clone() for k, v in o.nu.items()})
    return TrainState(member_module(stacked.g, i),
                      member_module(stacked.d, i), opt(stacked.g_opt),
                      opt(stacked.d_opt),
                      None if stacked.g_ema is None
                      else member_module(stacked.g_ema, i))


def stack_draws(draws: Sequence[StepDraws]) -> StepDraws:
    """The members' step draws stacked on a leading member axis."""
    return StepDraws(*(None if f[0] is None else torch.stack(f)
                       for f in zip(*draws)))


class EnsembleTrainer:
    """Wraps a :class:`Trainer` (its packed data, config and device) and
    trains M members jointly, one member-batched ``gan_step`` a chunk.

    The configurations ``gan_step``'s member mode does not batch are
    refused here, naming the field (``check_members_supported``), and so
    is ``mesh``."""

    def __init__(self, trainer: Trainer, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: sharding the ensemble's members over devices waits "
                "for the port's parallel/ (ROADMAP Queue 1, item 10)")
        check_members_supported(trainer.cfg)
        self.trainer = trainer
        self.cfg = trainer.cfg

    def init_states(self, seeds: Sequence[int]) -> TrainState:
        """Member m drawn as ``Trainer.init_state(seeds[m])``."""
        return stack_states([self.trainer.init_state(s) for s in seeds])

    def train_epoch(self, states: TrainState,
                    generators: Sequence[torch.Generator]
                    ) -> Tuple[TrainState, Dict]:
        """One member-batched ``gan_step`` a chunk; member m's draws come
        from ``generators[m]`` (a device generator), drawn as
        ``Trainer.train_epoch`` draws them.  Per-member metrics (numpy
        [M]) as ``Trainer.train_epoch`` gives a solo run's, with the wall
        time and step count."""
        tic = time.perf_counter()
        tr, cfg = self.trainer, self.cfg
        per_member = [[draw_step(tr.train_packed.width, cfg, g, tr.device)
                       for _ in range(tr.n_steps_per_epoch)]
                      for g in generators]
        sums = None
        for i in range(tr.n_steps_per_epoch):
            states, m = gan_step(states, chunk_of(tr.train_dev, i),
                                 stack_draws([d[i] for d in per_member]), cfg,
                                 n_valid=int(tr.train_packed.n_valid[i]),
                                 members=True)
            sums = m if sums is None else StepMetrics(
                *(a + b for a, b in zip(sums, m)))
        n_chunks = tr.n_steps_per_epoch
        vals = np.array(torch.stack([
            sums.d_loss / n_chunks, sums.g_loss / n_chunks, sums.ade_sum,
            sums.fde_sum, sums.n_samples.to(sums.ade_sum.dtype)]).tolist())
        d_loss, g_loss, ade_sum, fde_sum, n_samp = vals
        n, ss = np.maximum(n_samp, 1), tr.dataset.ss
        return states, {
            "d_loss": d_loss,
            "g_loss": g_loss,
            "train_ade": ade_sum / ss / n,
            "train_fde": fde_sum / ss / n,
            "epoch_time_s": time.perf_counter() - tic,
            "steps": n_chunks,
        }

    def train_epochs(self, states: TrainState,
                     generators: Sequence[torch.Generator], n: int
                     ) -> Tuple[TrainState, Dict]:
        """``n`` epochs; the LAST epoch's per-member metrics (d_loss,
        g_loss, train_ade, train_fde), with the mean epoch time and the
        steps of all ``n``."""
        tic = time.perf_counter()
        for _ in range(n):
            states, m = self.train_epoch(states, generators)
        m["epoch_time_s"] = (time.perf_counter() - tic) / n
        m["steps"] = self.trainer.n_steps_per_epoch * n
        return states, m

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
        rngs = self._noise_rngs(seeds)
        g, total = eval_params(states), None
        for i in range(tr.test_packed.n_chunks):
            noise = torch.stack([draw_noise(k, tr.test_packed.width,
                                            self.cfg, r, tr.device)
                                 for r in rngs]) if noises is None else (
                noises[i].to(tr.device))
            s = eval_chunk_members(g, chunk_of(tr.test_dev, i), k, self.cfg,
                                   noise)
            total = s if total is None else EvalSums(
                *(a + b for a, b in zip(total, s)))
        return [finalize_eval(EvalSums(*(x[m] for x in total)),
                              tr.dataset.ss, tr.dataset.n_test_samples)
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
        noise = torch.stack([draw_noise(k, obs.shape[0], cfg, r, tr.device)
                             for r in self._noise_rngs(seeds)])
        pk = k_sample_rollout_members(
            eval_params(states), torch.from_numpy(obs).to(tr.device),
            torch.from_numpy(ids).to(tr.device), k, cfg, noise)
        finals = ds.scale.denormalize(pk[..., :2].cpu().numpy())
        obs_w = ds.scale.denormalize(obs)
        return [toy_mode_coverage(obs_w, finals[m])
                for m in range(len(seeds))]
