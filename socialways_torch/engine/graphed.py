"""JAX's epoch on the device: every step of an epoch as the replay of a
captured CUDA graph of ``gan_step``.

Counterpart of socialways_tpu/engine/trainer.py:138-141, 167-231 (the
``jax.jit`` of the step, ``_epoch_fn``'s ``lax.scan`` of ``gan_step`` over
the chunks, ``_epochs_fn`` and ``train_epoch``'s on-device path) and
socialways_tpu/engine/ensemble.py:101-125 (the ``jit`` of ``vmap`` of that
scan).  JAX compiles the epoch into one device program with no host round
trip inside it; here the state, the step's clock and the metric sums stay
on the device, and one captured graph of the step is replayed once a
step, so the host pays one launch a step instead of one an op.

``EpochGraphs`` owns the static inputs of one step: the epoch's chunks
(the trainer's packed split, [steps, width, ...]), a buffer of the epoch's
draws ([steps, ...], drawn by the caller as the eager loop draws them and
copied in at the epoch's start) and a device step index that selects both
inside the graph and advances there.  The metric sums are device buffers
the step adds into.  The first step of each outcome runs eagerly (the
warm-up: kernel builds, cuBLAS handles and the unroll backup are in place
before the capture), then the step is captured; a capture runs nothing,
so the state does not move, and every later step of that outcome is a
replay.  The outcomes are the solo D/G ratio's two branches (JAX's
``lax.cond``): the host knows each step's outcome from the G count read
once an epoch, since every non-empty chunk advances it by one.  Members
have one outcome (the D phase runs and each member selects its own).

Under a ``mesh`` (``parallel.Mesh``, one rank of a data-parallel group on
NCCL) the step is the DP step (JAX's ``make_dp_epoch_fn``: the ``jit`` of
``shard_map`` of the scan, socialways_tpu/parallel/mesh.py:111-171):
``batches`` is this rank's column of the chunk groups, the draws are each
group's global draws (``gan_step`` keeps the rank's rows), and the
[groups, D] valid counts are copied to the device once, so that the graph
selects the rank's and the group's counts by the step index and the count
weights are computed on the device at each replay.  The gradient and
metric all-reduces are captured in the graph (NCCL enqueues them on the
capturing stream's work; a capture runs none of them, and an eager step
and a replay issue the same ones in the same order).  Every rank must
therefore take its eager warm-up steps and its captures at the same
steps: the decision to drop the graphs is taken once an epoch over the
mesh (an all-reduce of each rank's wish, read on the host like the G
count), so the ranks recapture in lockstep.  A group that is all padding
is skipped on every rank, as packing tells each rank alike.  Graphs are
CUDA's: on the CPU the loops are eager, and the tests run this runner
there with its capture stubbed (tests/torch_dist_workers.py), on gloo
ranks under a mesh; on the card the mesh is NCCL's (``--mesh 1`` on a
machine of one card).

The graph holds the addresses of the state's tensors.  A state whose
tensors are not the captured ones (a resumed run, a rescue, a best-state
restore, ``reinit_discriminator``, ``transplant_schedule_clock``) drops
the graphs and is captured anew after a first eager step, so no step ever
trains stale tensors.  The runner holds one binding: states alternated
through one trainer are each captured anew as they come back.  A capture
that fails raises: the loop never falls back to eager.  The launch counters of the kernels count at
call time, so each capture's launches are taken back out and credited
once a replay (``kernels.launches.captured_launches``).

Tracing (``utils/profiling.py``): the captured step holds the device
stamps of its phase boundaries (``gan_step``'s ``train.step`` unit), the
stamp kernel loaded before the capture; with tracing on each replay is a
``train.step`` unit whose phases are those stamps.  The counters
``graph.eager_steps``, ``graph.captures`` and ``graph.replays`` count at
the call sites, outside the graph.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine.train_step import (StepDraws, StepMetrics,
                                                TrainState, d_phase_due,
                                                d_ratio_on, gan_step)
from socialways_torch.kernels.launches import (Launches, captured_launches,
                                              credit_launches)
from socialways_torch.parallel.mesh import any_rank
from socialways_torch.utils.profiling import (captured_marks, count,
                                              prepare_stamps, span)


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a step reads or updates in place: the modules'
    parameters and buffers and both optimizers' moments and counts."""
    out = []
    for m in (state.g, state.d, state.g_ema):
        if m is not None:
            out += [*m.parameters(), *m.buffers()]
    return out + state.g_opt.tensors() + state.d_opt.tensors()


def solo_clock(cfg: TrainConfig, state: TrainState) -> Optional[int]:
    """The G count the solo D/G ratio branches on, read once (None when
    the ratio is off and nothing needs it)."""
    return int(state.g_opt.count) if d_ratio_on(cfg) else None


def add_metrics(sums: Optional[List[torch.Tensor]], m: StepMetrics
                ) -> List[torch.Tensor]:
    """The epoch's device sums with the step's metrics added in place
    (zeros first): the eager loop and the graphs sum alike."""
    if sums is None:
        sums = [torch.zeros_like(t) for t in m]
    torch._foreach_add_(sums, list(m))
    return sums


def epoch_means(sums: List[torch.Tensor], n_steps: int) -> StepMetrics:
    """JAX's epoch metrics from the sums: mean losses, summed errors and
    sample counts (copies)."""
    d, g, ade, fde, n = sums
    return StepMetrics(d / n_steps, g / n_steps, ade.clone(), fde.clone(),
                       n.clone())


class EpochGraphs:
    """Replays of captured CUDA graphs of ``gan_step`` over the chunks of
    ``batches`` ([steps, width, ...] on a CUDA device; this rank's column
    of the chunk groups under a ``mesh``), whose valid counts are
    ``counts`` ([steps], or [steps, D] of each rank's chunk under a mesh;
    from packing: a step with none is no step).  ``members``: the member
    step of stacked states."""

    def __init__(self, cfg: TrainConfig, batches: Dict[str, torch.Tensor],
                 counts, members: bool = False, mesh=None):
        self.cfg, self.batches, self.members = cfg, batches, members
        self.mesh = mesh
        dev = batches["valid"].device
        counts = np.asarray(counts).reshape(len(counts), -1)
        self.n_valid = [int(v) for v in counts.sum(axis=1)]
        self.counts = (None if mesh is None
                       else torch.from_numpy(counts).to(dev))
        self.idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.draws: Optional[StepDraws] = None
        self.bound: List[torch.Tensor] = []
        self._drop()

    def _drop(self) -> None:
        """Drop the graphs, and with them their memory."""
        self.graphs: Dict[bool, Tuple[torch.cuda.CUDAGraph, Launches,
                                      Tuple]] = {}
        self.pool = None
        self.sums: Optional[List[torch.Tensor]] = None

    def _bind(self, state: TrainState) -> None:
        """Keep the graphs when ``state`` holds the captured tensors (the
        bound list keeps them alive, so equal addresses are the same
        tensors), else drop them; under a mesh every rank drops when any
        rank does."""
        tensors = state_tensors(state)
        drop = [t.data_ptr() for t in tensors] != [t.data_ptr()
                                                  for t in self.bound]
        if self.mesh is not None:
            drop = any_rank(drop, self.mesh)
        if drop:
            self._drop()
            self.bound = tensors

    def _load_draws(self, draws: StepDraws) -> None:
        if self.draws is not None and all(
                (a is None) == (b is None) and (a is None
                                                or a.shape == b.shape)
                for a, b in zip(self.draws, draws)):
            torch._foreach_copy_([a for a in self.draws if a is not None],
                                 [b for b in draws if b is not None])
            return
        self._drop()
        self.draws = StepDraws(*(None if t is None else t.clone()
                                 for t in draws))

    def _step(self, state: TrainState, n_valid: int,
              g_count: Optional[int]) -> None:
        """The step at the device index: its chunk and draws selected on
        the device, its metrics added to the sums, the index advanced."""
        pick = lambda t: t.index_select(0, self.idx).squeeze(0)
        chunk = {k: pick(v) for k, v in self.batches.items()}
        draws = StepDraws(*(None if t is None else pick(t)
                            for t in self.draws))
        kw = dict(n_valid=n_valid)
        if self.mesh is not None:
            c = pick(self.counts)
            kw = dict(n_valid=c[self.mesh.rank], n_valid_global=c.sum(),
                      mesh=self.mesh)
        _, m = gan_step(state, chunk, draws, self.cfg, members=self.members,
                        g_count=g_count, **kw)
        self.sums = add_metrics(self.sums, m)
        self.idx.add_(1)

    def _capture(self, step) -> Tuple[torch.cuda.CUDAGraph, Launches]:
        """A CUDA graph of ``step()`` (nothing runs) and its launches.
        Under a mesh the capture's error mode is ``thread_local``: NCCL's
        watchdog thread queries its events while a rank captures."""
        graph = torch.cuda.CUDAGraph()
        mode = "global" if self.mesh is None else "thread_local"
        with captured_launches() as launches:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode=mode):
                step()
        self.pool = graph.pool()
        return graph, launches

    def epoch(self, state: TrainState, draws: StepDraws,
              g_count: Optional[int] = None) -> StepMetrics:
        """One epoch of ``state`` in place under ``draws`` (``stack_draws``
        of the eager loop's draws); ``g_count``: the solo G count at the
        epoch's start (``solo_clock``).  Returns the epoch's metrics on
        the device, as ``trainer.run_epoch``."""
        self._bind(state)
        self._load_draws(draws)
        if self.sums is not None:
            torch._foreach_zero_(self.sums)
        self.idx.zero_()
        ratio = not self.members and d_ratio_on(self.cfg)
        for n_valid in self.n_valid:
            if n_valid == 0:
                self.idx.add_(1)
                continue
            outcome = d_phase_due(self.cfg, g_count) if ratio else True
            entry = self.graphs.get(outcome)
            if entry is None:
                count("graph.eager_steps")
                self._step(state, n_valid, g_count)
                prepare_stamps(self.idx.device)
                count("graph.captures")
                with captured_marks() as marks:
                    graph = self._capture(functools.partial(
                        self._step, state, n_valid, g_count))
                self.graphs[outcome] = (*graph, tuple(marks))
            else:
                with span("train.step", unit=True, device=self.idx.device,
                          replay=entry[2]):
                    count("graph.replays")
                    entry[0].replay()
                credit_launches(entry[1])
            if g_count is not None:
                g_count += 1
        return epoch_means(self.sums, len(self.n_valid))
