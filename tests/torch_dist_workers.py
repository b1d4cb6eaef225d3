"""Rank functions of tests/test_torch_parallel.py and
tests/test_torch_dp_graphed.py, and the CPU stand-ins of a CUDA graph's
capture they share with tests/test_torch_device_clock.py.

``socialways_torch.parallel.spawn`` starts each rank in a fresh process
that unpickles these functions by import path, so this module imports
torch, numpy and socialways_torch only (no JAX: a rank starts in seconds).
Inputs come as numpy arrays and plain dicts; each function returns numpy
arrays and floats."""

import contextlib
import copy

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from socialways_torch.config import TrainConfig
from socialways_torch.engine.train_step import StepDraws, gan_step
from socialways_torch.io.checkpoint import flatten_state, state_from_flat
from socialways_torch.kernels import social_attention as sa


# ------------------------------------------ a CUDA graph's capture on the CPU
class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor's value on the host."""
    FORBIDDEN = (torch.ops.aten._local_scalar_dense.default,
                 torch.ops.aten.nonzero.default)

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            raise AssertionError(f"host read inside the epoch: {func}")
        self.ops += 1
        return func(*args, **(kwargs or {}))


class _Replay:
    """A captured step as a CPU stand-in: a replay runs the step again
    (its launches counted by the runner's credit alone)."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        with sa.captured_launches():
            self.step()


def stub_capture(self, step):
    """``EpochGraphs._capture`` on the CPU: like a capture, it leaves the
    state, the sums and the index as they were (under a mesh it runs the
    step's collectives, so the ranks must capture at the same steps).  It
    runs the warm-up's step again: the index has moved past it, and past
    the epoch's end when the warm-up was its last step."""
    kept = self.bound + (self.sums or []) + [self.idx]
    saved = [t.detach().clone() for t in kept]
    self.idx.sub_(1)
    with sa.captured_launches() as launches:
        step()
    with torch.no_grad():
        for t, s in zip(kept, saved):
            t.copy_(s)
    return _Replay(step), launches


@contextlib.contextmanager
def stubbed_graphs(captures: list):
    """Inside: ``epoch_on_device`` graphs the epochs on the CPU too (the
    trainers' and ``make_dp_epoch_fn``'s), each capture stubbed and
    appended to ``captures``."""
    from socialways_torch.engine import graphed, trainer
    saved = graphed.EpochGraphs._capture, trainer.check_graphable

    def capture(self, step):
        captures.append(1)
        return stub_capture(self, step)
    graphed.EpochGraphs._capture = capture
    trainer.check_graphable = lambda cfg, device, mesh=None: \
        cfg.epoch_on_device
    try:
        yield
    finally:
        graphed.EpochGraphs._capture, trainer.check_graphable = saved


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rows(batch, mesh):
    """This rank's rows of a global batch (equal parts in rank order)."""
    n = len(batch["valid"]) // mesh.size
    return {k: v[mesh.rank * n:(mesh.rank + 1) * n] for k, v in batch.items()}


def _draws(arrays) -> StepDraws:
    return StepDraws(*(None if a is None else torch.from_numpy(np.array(a))
                       for a in arrays))


def _metrics(m):
    return {k: float(v) for k, v in m._asdict().items()}


def step_case(mesh, case):
    """One DP step of ``case`` (cfg, state leaves, global batch and draws)
    on ``mesh`` (its 2-D form when ``case["shape"]`` says so); rank 0 also
    runs the single-process step on the global batch when ``single``."""
    from socialways_torch.parallel.mesh import make_mesh_2d
    torch.set_num_threads(1)
    if case.get("shape"):
        mesh = make_mesh_2d(*case["shape"], device="cpu")
    cfg = TrainConfig(**case["cfg"])
    state = state_from_flat(case["flat"], cfg, "cpu")
    state, m = gan_step(state, _tensors(_rows(case["batch"], mesh)),
                        _draws(case["draws"]), cfg, mesh=mesh)
    out = {"dp": (flatten_state(state), _metrics(m))}
    if case.get("single") and mesh.rank == 0:
        ref = state_from_flat(case["flat"], cfg, "cpu")
        ref, m = gan_step(ref, _tensors(case["batch"]), _draws(case["draws"]),
                          cfg)
        out["single"] = (flatten_state(ref), _metrics(m))
    return out


def eval_case(mesh, case):
    """The DP eval of this rank's rows under the global noise, and rank 0's
    single-process eval of the global batch under it."""
    from socialways_torch.eval.metrics import eval_chunk
    from socialways_torch.parallel.mesh import make_dp_eval_chunk
    torch.set_num_threads(1)
    cfg = TrainConfig(**case["cfg"])
    g = state_from_flat(case["flat"], cfg, "cpu").g
    noise = torch.from_numpy(case["noise"])
    k = noise.shape[0]
    dp = make_dp_eval_chunk(cfg, mesh, k)(
        g, _tensors(_rows(case["batch"], mesh)), noise=noise)
    out = {"dp": [float(x) for x in dp]}
    if mesh.rank == 0:
        sp = eval_chunk(g, _tensors(case["batch"]), k, cfg, noise=noise)
        out["single"] = [float(x) for x in sp]
    return out


def _toy_trainer(case, mesh=None):
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine.trainer import Trainer
    return Trainer(TrainConfig(**case["cfg"]),
                   load_npz_dataset(case["npz"]), "cpu", mesh)


def epoch_case(mesh, case):
    """``make_dp_epoch_fn`` against a loop of DP steps over the same groups
    and draws, ``Trainer(mesh=)``'s epoch and evaluate against the epoch
    function, and the single-process steps of each concatenated group
    (rank 0), all from one state."""
    from socialways_torch.engine.train_step import draw_step
    from socialways_torch.parallel.mesh import (make_dp_epoch_fn,
                                                make_dp_epochs_fn,
                                                make_dp_train_step)
    torch.set_num_threads(1)
    tr = _toy_trainer(case, mesh)
    cfg, width = tr.cfg, tr.train_packed.width
    gen = torch.Generator().manual_seed(case["seed"])
    draws = [draw_step(mesh.size * width, cfg, gen)
             for _ in range(tr.n_steps_per_epoch)]
    flat0 = flatten_state(tr.init_state(0))
    fused, m_fused = make_dp_epoch_fn(cfg, mesh)(
        state_from_flat(flat0, cfg, "cpu"), tr.train_dev, draws,
        tr.train_counts)
    epochs, _ = make_dp_epochs_fn(cfg, mesh)(
        state_from_flat(flat0, cfg, "cpu"), tr.train_dev, lambda e: draws, 1,
        tr.train_counts)
    step = make_dp_train_step(cfg, mesh)
    loop = state_from_flat(flat0, cfg, "cpu")
    for gi in range(tr.n_steps_per_epoch):
        loop, _ = step(loop, {k: v[gi] for k, v in tr.train_dev.items()},
                       draws[gi])
    trained, m_tr = tr.train_epoch(state_from_flat(flat0, cfg, "cpu"),
                                   torch.Generator().manual_seed(
                                       case["seed"]))
    ev = tr.evaluate(trained.g, seed=5, n_gen_samples=3)
    out = {"fused": flatten_state(fused), "loop": flatten_state(loop),
           "epochs": flatten_state(epochs),
           "trainer": flatten_state(trained), "m_fused": _metrics(m_fused),
           "m_trainer": m_tr, "eval": ev, "steps": tr.n_steps_per_epoch}
    if mesh.rank == 0:
        out["single"] = _single_process_epoch(tr, flat0, draws, mesh.size)
    return out


def _single_process_epoch(tr, flat0, draws, n_dev):
    """The same epoch in one process: each step on its concatenated group,
    the ranks' scene ids made unique across chunks."""
    from socialways_torch.parallel.mesh import shard_packed_for_mesh
    cfg = tr.cfg
    grouped = shard_packed_for_mesh(tr.train_packed, n_dev)
    state = state_from_flat(flat0, cfg, "cpu")
    for gi in range(grouped["obsvs"].shape[0]):
        batch = {k: v[gi] for k, v in grouped.items()}
        batch["scene_ids"] = unique_ids(batch["scene_ids"], n_dev)
        state, _ = gan_step(state, _tensors(batch), draws[gi], cfg)
    return flatten_state(state)


def unique_ids(ids, n_parts):
    """Scene ids of a concatenated group, offset by part so that no scene
    id of one chunk meets another's (packing restarts them in each)."""
    ids = np.asarray(ids).copy()
    width = len(ids) // n_parts
    for r in range(n_parts):
        part = ids[r * width:(r + 1) * width]
        part[part >= 0] += r * width
    return ids


def crowd_case(mesh, case):
    """``crowd_simulate_sharded`` (gather and ring) and the two sharded
    context forms on the whole crowd of ``case``."""
    from socialways_torch.engine.simulate import crowd_simulate_sharded
    from socialways_torch.parallel.agents import (make_sharded_social_context,
                                                  ring_social_context)
    from socialways_torch.parallel.mesh import all_gather_rows
    torch.set_num_threads(1)
    cfg = TrainConfig(**case["cfg"])
    g = state_from_flat(case["flat"], cfg, "cpu").g
    out = {}
    if "obsv0" in case:
        for ex in ("gather", "ring"):
            out[ex] = crowd_simulate_sharded(
                g, torch.from_numpy(case["obsv0"]),
                torch.from_numpy(case["ids"]), case["windows"], cfg, mesh,
                noise=torch.from_numpy(case["noise"]),
                neighbor_exchange=ex).numpy()
    if "x4" in case:
        n = len(case["ctx_ids"]) // mesh.size
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
        args = (torch.from_numpy(case["x4"][rows]),
                torch.from_numpy(case["h"][rows]),
                torch.from_numpy(case["ctx_ids"][rows]))
        out["ctx_gather"] = all_gather_rows(
            make_sharded_social_context(g, mesh)(*args), mesh).numpy()
        out["ctx_ring"] = all_gather_rows(
            ring_social_context(g, *args, mesh), mesh).numpy()
    return out


def ensemble_case(mesh, case):
    """``EnsembleTrainer(mesh=)``: ``evaluate`` of the given members
    (``flats``) under the given noise, then an epoch and ``evaluate`` of M
    members drawn from ``seeds``, sharded over the ranks; rank 0 also runs
    the M-member ensemble in one process from the same seeds and
    generators."""
    from socialways_torch.engine.ensemble import (EnsembleTrainer,
                                                  member_state, stack_states)
    torch.set_num_threads(1)
    seeds = case["seeds"]
    noises = [torch.from_numpy(z) for z in case["noises"]]

    def run(ens):
        states = ens.init_states(seeds)
        gens = [torch.Generator().manual_seed(100 + s) for s in seeds]
        states, m = ens.train_epoch(states, gens)
        ev = ens.evaluate(states, seeds, n_gen_samples=case["k"],
                          noises=noises)
        n_local = len(seeds) // (ens.mesh.size if ens.mesh else 1)
        flats = [flatten_state(member_state(states, i))
                 for i in range(n_local)]
        return {k: np.asarray(v) for k, v in m.items()
                if k in ("d_loss", "g_loss", "train_ade",
                         "train_fde")}, ev, flats

    ens = EnsembleTrainer(_toy_trainer(case), mesh)
    given = stack_states([state_from_flat(f, ens.cfg, "cpu")
                          for f in ens._local(case["flats"])])
    out = {"given": ens.evaluate(given, seeds, n_gen_samples=case["k"],
                                 noises=noises),
           "mesh": run(ens)}
    if mesh.rank == 0:
        out["single"] = run(EnsembleTrainer(_toy_trainer(case)))
    return out


# ------------------------------------------------ the graphed DP epoch
_METRICS = ("d_loss", "g_loss", "train_ade", "train_fde", "steps")


def graphed_dp_case(mesh, case):
    """``Trainer(mesh=)`` epochs graphed (capture stubbed) and eager
    (``epoch_on_device=False``) from one state and draw seed: each run's
    final state, its metrics a call, and the graphed run's captures.
    ``case["rescue"]`` {epoch: "all" | "rank0"}: after that epoch every
    rank replaces its state by one with a re-initialized D (seeded alike),
    or rank 0 alone by a copy of equal values (the runner must recapture
    on every rank in lockstep).  ``case["fused"]``: all epochs in one
    ``train_epochs`` call."""
    from socialways_torch.engine.rescue import reinit_discriminator
    torch.set_num_threads(1)
    captures, out = [], {}
    with stubbed_graphs(captures):
        for mode in ("graph", "eager"):
            tr = _toy_trainer(dict(case, cfg=dict(
                case["cfg"], epoch_on_device=mode == "graph")), mesh)
            assert tr.graphed == (mode == "graph")
            state = tr.init_state(1)
            gen = torch.Generator().manual_seed(case["seed"])
            ms = []
            if case.get("fused"):
                state, m = tr.train_epochs(state, gen, case["epochs"])
                ms.append(m)
            for e in range(0 if case.get("fused") else case["epochs"]):
                state, m = tr.train_epoch(state, gen)
                ms.append(m)
                rescue = case.get("rescue", {}).get(e)
                if rescue == "all":
                    state = reinit_discriminator(
                        state, tr.cfg, torch.Generator().manual_seed(9))
                elif rescue == "rank0" and mesh.rank == 0:
                    state = copy.deepcopy(state)
            out[mode] = (flatten_state(state),
                         [{k: m[k] for k in _METRICS} for m in ms])
    out["captures"] = len(captures)
    out["steps"] = tr.n_steps_per_epoch
    out["counts"] = tr.train_counts.tolist()
    return out


def no_host_read_case(mesh, case):
    """One ``Trainer(mesh=)`` epoch, graphed (capture stubbed) or eager,
    with every step after the first under ``NoHostRead`` until the epoch's
    one metrics read: each step's dispatched op count."""
    from socialways_torch.engine import graphed, trainer
    from socialways_torch.engine.trainer import Trainer
    torch.set_num_threads(1)
    graph = case["mode"] == "graph"
    tr = _toy_trainer(dict(case, cfg=dict(case["cfg"],
                                          epoch_on_device=graph)), mesh)
    mode, calls, left = NoHostRead(), [], []
    mod = graphed if graph else trainer
    real_step, real_metrics = mod.gan_step, Trainer._host_metrics

    def step(*args, **kwargs):
        out = real_step(*args, **kwargs)
        calls.append(mode.ops)
        if len(calls) == 1:
            mode.__enter__()
        return out

    def metrics(self, *args):
        if calls and not left:
            left.append(1)
            mode.__exit__(None, None, None)
        return real_metrics(self, *args)
    mod.gan_step, Trainer._host_metrics = step, metrics
    try:
        with stubbed_graphs([]):
            assert tr.graphed == graph
            _, m = tr.train_epoch(tr.init_state(1),
                                  torch.Generator().manual_seed(3))
    finally:
        mod.gan_step, Trainer._host_metrics = real_step, real_metrics
        if calls and not left:
            mode.__exit__(None, None, None)
    return {"calls": calls, "left": bool(left), "g_loss": m["g_loss"],
            "steps": tr.n_steps_per_epoch}


def jax_epoch_case(mesh, case):
    """The graphed DP epoch (capture stubbed) under the given global draws
    (JAX's) from the given state, three ways: ``Trainer(mesh=)
    .train_epoch``, ``make_dp_epoch_fn`` (its own runner) and
    ``make_dp_epochs_fn`` given the trainer's runner."""
    from socialways_torch.parallel.mesh import (make_dp_epoch_fn,
                                                make_dp_epochs_fn)
    torch.set_num_threads(1)
    draws = [_draws(d) for d in case["draws"]]
    out = {}
    with stubbed_graphs([]):
        tr = _toy_trainer(case, mesh)
        cfg = tr.cfg
        assert tr.graphed
        state, m = tr.train_epoch(state_from_flat(case["flat"], cfg, "cpu"),
                                  draws=draws)
        out["trainer"] = (flatten_state(state), {k: m[k] for k in _METRICS})
        state, m = make_dp_epoch_fn(cfg, mesh)(
            state_from_flat(case["flat"], cfg, "cpu"), tr.train_dev, draws)
        out["epoch_fn"] = (flatten_state(state), _metrics(m))
        state, m = make_dp_epochs_fn(cfg, mesh, tr.epoch_graphs)(
            state_from_flat(case["flat"], cfg, "cpu"), tr.train_dev,
            lambda e: draws, 1, tr.train_counts)
        out["epochs_fn"] = (flatten_state(state), _metrics(m))
    return out


def graphed_ensemble_case(mesh, case):
    """``EnsembleTrainer(mesh=)`` epochs graphed (capture stubbed) and
    eager from the same seeds and generators: each rank's members' final
    states and the metrics of every member; rank 0 also runs the
    M-member ensemble in one process, eager."""
    from socialways_torch.engine.ensemble import EnsembleTrainer, member_state
    torch.set_num_threads(1)
    seeds = case["seeds"]

    def run(ens):
        states = ens.init_states(seeds)
        gens = [torch.Generator().manual_seed(100 + s) for s in seeds]
        ms = []
        for _ in range(case["epochs"]):
            states, m = ens.train_epoch(states, gens)
            ms.append({k: np.asarray(m[k]) for k in _METRICS[:4]})
        n_local = len(seeds) // (ens.mesh.size if ens.mesh else 1)
        return [flatten_state(member_state(states, i))
                for i in range(n_local)], ms

    out, captures = {}, []
    with stubbed_graphs(captures):
        for mode in ("graph", "eager"):
            ens = EnsembleTrainer(_toy_trainer(dict(case, cfg=dict(
                case["cfg"], epoch_on_device=mode == "graph"))), mesh)
            assert ens.graphed == (mode == "graph")
            out[mode] = run(ens)
        if mesh.rank == 0:
            out["single"] = run(EnsembleTrainer(_toy_trainer(dict(
                case, cfg=dict(case["cfg"], epoch_on_device=False)))))
    out["captures"] = len(captures)
    return out


def run_cases(mesh, cases):
    """Every (function name, case) of ``cases`` in order, one spawn."""
    return [globals()[fn](mesh, case) for fn, case in cases]
