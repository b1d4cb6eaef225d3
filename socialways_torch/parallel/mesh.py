"""Device meshes and data-parallel training on ``torch.distributed``.

Counterpart of socialways_tpu/parallel/mesh.py.  JAX runs a mesh in one
process under ``shard_map``; here each device is one process (a rank) of
a ``torch.distributed`` group, and a :class:`Mesh` is a rank's view of it:
its rank, the world size, its device and the axis names.  Every rank runs
the same collectives in the same order, so no host branch may be taken on
a rank's own data alone: the DP step decides its no-op from the group's
valid count (engine/train_step.py).

Scene alignment is the invariant, as in JAX: each rank receives whole
packed chunks, so the social attention (which never crosses a scene) needs
no communication inside the step; the collectives are the gradient and
metric reductions.  The noise is drawn for the global batch on every rank
from one generator and each rank keeps its rows, so N-way training equals
single-process training on the concatenated group up to float
reassociation.

Processes: inside ``torchrun`` (``WORLD_SIZE`` set) a process joins the
group it was started in (:func:`join_env`); otherwise :func:`spawn` starts
one process a rank with the ``spawn`` start method and a ``file://``
rendezvous in a temporary directory.  The backend is NCCL on ``cuda`` and
gloo on ``cpu``; gloo on ``cuda`` is taken only when asked for
(``backend="gloo"``), which is how two ranks share one card.  Nothing falls
back to the CPU.

Under NCCL the DP step's collectives are captured in the graphed epoch's
CUDA graphs (engine/graphed.py): the communicator exists before any
capture (``device_id`` when the group is joined, and the eager warm-up
step), nothing is read on the host between the flatten, the all-reduce
and the split of ``all_reduce_sum`` and ``psum``, and ``dist.all_reduce``
is called without ``async_op``, so the capturing stream waits for it.
ProcessGroupNCCL keeps captured work off its watchdog's list, so a
captured collective that hangs is not reported: ``spawn``'s timeout
stays the guard.  gloo stages its collectives on the host and cannot be
captured.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from socialways_torch.device import resolve_device

DATA_AXIS = "data"
DCN_AXIS = "dcn"

Shape = Union[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a device mesh: ``shape`` (``(D,)``, or ``(n_dcn,
    n_ici)`` for the hierarchical form), its ``axis_names``, this process's
    ``rank`` (dcn-major over the shape, so the 1-D and 2-D forms slice the
    same noise rows), its ``device`` and the group's ``backend``.  Its
    collectives run on the process's default group, the whole world:
    gradients and metrics reduce over every rank."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str = "gloo"

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _rank_device(device_type: str) -> torch.device:
    """This process's device: ``cpu``, or the card it selected."""
    if device_type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device())


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed group: start the ranks "
                           "with parallel.spawn or torchrun")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    dev = _rank_device(torch.device(device or "cuda").type)
    return Mesh(shape, names, dist.get_rank(), dev, dist.get_backend())


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D ``data`` mesh over the group's ranks (all of them by
    default; ``n_devices`` must equal the world size).  ``device``: its
    type (``cuda``, the default, or ``cpu``)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _mesh((n,), (DATA_AXIS,), device)


def make_mesh_2d(n_dcn: int, n_ici: int, device=None) -> Mesh:
    """The hierarchical ``(dcn, data)`` mesh, ranks laid out dcn-major:
    rank = dcn index * n_ici + data index, so the flat rank order is the
    1-D mesh's and both forms consume the same noise rows.  NCCL and gloo
    choose their own all-reduce schedule over the whole group (JAX lets
    XLA lower its psum over the axis tuple hierarchically)."""
    return _mesh((n_dcn, n_ici), (DCN_AXIS, DATA_AXIS), device)


def mesh_shape(spec: str) -> Tuple[int, ...]:
    """``--mesh`` as a shape: ``"N"`` -> (N,), ``"AxB"`` -> (A, B);
    ``"0"`` or ``""`` -> () (no mesh)."""
    if spec in ("0", ""):
        return ()
    if "x" in spec:
        return tuple(int(v) for v in spec.split("x", 1))
    return (int(spec),)


def _make(shape: Tuple[int, ...], device) -> Mesh:
    return (make_mesh(shape[0], device) if len(shape) == 1
            else make_mesh_2d(shape[0], shape[1], device))


def _backend(device_type: str, backend: Optional[str]) -> str:
    return backend or ("nccl" if device_type == "cuda" else "gloo")


def _init(device_type: str, backend: str, rank: int, world: int,
          init_method: str, local_rank: int) -> None:
    """Join the group; on ``cuda`` select the card first (the local rank
    mod the count: with gloo, ranks may share one)."""
    kw = {}
    if device_type == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        if backend == "nccl":
            kw["device_id"] = _rank_device("cuda")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)


def _rank_main(fn, shape, rank, device_type, backend, init_method, args,
               results) -> None:
    """A spawned rank: join, build the mesh, run ``fn(mesh, *args)`` and
    put ``(rank, ok, result or traceback)`` on ``results``."""
    try:
        _init(device_type, backend, rank, math.prod(shape), init_method,
              rank)
        out = (rank, True, fn(_make(shape, device_type), *args))
    except BaseException:                      # reported, then the rank ends
        out = (rank, False, traceback.format_exc())
    results.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, shape: Shape, device,
          backend: Optional[str] = None, args: Sequence = (),
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a new mesh of ``shape``
    (an int or ``(n_dcn, n_ici)``) on ``device`` (its type: ``cuda`` or
    ``cpu``), one spawned process a rank, and return the ranks' results in
    rank order.  ``fn``, ``args`` and the results
    are pickled (``fn`` by import path).  The backend is NCCL on ``cuda``
    and gloo on ``cpu`` unless ``backend`` says otherwise.  A rank that
    raises, or ``timeout`` seconds passing, ends every rank and raises
    here.  On ``cuda`` build the kernels before (``kernels.prebuild``): each
    rank would otherwise run nvcc."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    world = math.prod(shape)
    device_type = torch.device(device).type
    backend = _backend(device_type, backend)
    if device_type == "cuda":
        resolve_device("cuda")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one card a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards")
    ctx = multiprocessing.get_context("spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="socialways_mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, shape, r, device_type, backend,
                                   init_method, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done: Dict[int, Any] = {}
        try:
            while len(done) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"mesh of {world} ranks: no "
                                           f"result within {timeout} s")
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with "
                                           f"{procs[dead[0]].exitcode} "
                                           "before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                done[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10 if len(done) == world else 0.5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [done[r] for r in range(world)]


def in_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ


def join_env(shape: Shape, device="cuda",
             backend: Optional[str] = None) -> Mesh:
    """Inside ``torchrun``: join the group from the environment
    (``env://``: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK
    selects the card) and return this rank's mesh of ``shape``.  Leave
    with ``dist.destroy_process_group()``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    device_type = torch.device(device).type
    _init(device_type, _backend(device_type, backend),
          int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
          int(os.environ.get("LOCAL_RANK", 0)))
    return _make(shape, device_type)


def run(fn: Callable, shape: Shape, device="cuda",
        backend: Optional[str] = None, args: Sequence = ()) -> Any:
    """``fn(mesh, *args)`` on a mesh of ``shape``, returning this process's
    result (rank 0's when it starts the ranks): inside ``torchrun`` this
    process is one rank; a world of one runs here (a group of one
    process); otherwise :func:`spawn`."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    device_type = torch.device(device).type
    if not in_torchrun() and math.prod(shape) > 1:
        return spawn(fn, shape, device_type, backend, args)[0]
    with tempfile.TemporaryDirectory(prefix="socialways_mesh_") as tmp:
        if in_torchrun():
            mesh = join_env(shape, device_type, backend)
        else:
            _init(device_type, _backend(device_type, backend), 0, 1,
                  "file://" + os.path.join(tmp, "rendezvous"), 0)
            mesh = _make(shape, device_type)
        try:
            return fn(mesh, *args)
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------------ collectives
def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh
                   ) -> List[torch.Tensor]:
    """The sums over the mesh of ``tensors`` (one dtype), through ONE
    flattened buffer and one all-reduce, as DDP's buckets do."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """A sum over the mesh whose backward is again a sum over the mesh
    (the transpose of JAX's psum): each rank's gradient sums every rank's
    cotangent.  Defined with ``setup_context`` so that it also runs under
    ``torch.func.grad`` (R1's input gradient)."""

    @staticmethod
    def forward(t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous())


def psum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """JAX's ``psum``: the differentiable sum of ``t`` over the mesh (``t``
    itself without one)."""
    return t if mesh is None else _AllReduceSum.apply(t)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` holds on any rank: one all-reduce (max) and a host
    read, so that every rank takes the same host branch."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``t`` [n, ...] concatenated in rank order: [D n, ...]."""
    t = t.contiguous()
    out = t.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t)
    return out


# ------------------------------------------------------------- DP layout
def shard_packed_for_mesh(packed, n_dev: int) -> Dict[str, np.ndarray]:
    """Pad the chunk axis to a multiple of ``n_dev`` with filler chunks
    (scene ids -1, valid False) and group it: [groups, n_dev * width, ...],
    chunk g * n_dev + r in rows [r width, (r + 1) width) of group g (JAX's
    layout, :193-219).  Host arrays: each rank copies its own column
    (:func:`rank_column`) to its device."""
    n = packed.n_chunks
    pad = (-n) % n_dev

    def prep(x):
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((x.shape[0] // n_dev, n_dev * x.shape[1])
                         + x.shape[2:])

    out = {"obsvs": prep(packed.obsvs), "preds": prep(packed.preds),
           "scene_ids": prep(packed.scene_ids), "valid": prep(packed.valid)}
    if pad:
        out["scene_ids"][-1, -pad * packed.width:] = -1
        out["valid"][-1, -pad * packed.width:] = False
    return out


def rank_column(grouped: Dict[str, np.ndarray], rank: int, n_dev: int
                ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of every group: [groups, width, ...]."""
    out = {}
    for k, v in grouped.items():
        width = v.shape[1] // n_dev
        out[k] = np.ascontiguousarray(v[:, rank * width:(rank + 1) * width])
    return out


def group_valid_counts(packed, n_dev: int) -> np.ndarray:
    """[groups, n_dev] valid rows of each rank's chunk in each group
    (filler chunks count 0): the host counts of the DP step's weights."""
    n = packed.n_chunks
    counts = np.zeros(-(-n // n_dev) * n_dev, np.int64)
    counts[:n] = packed.n_valid
    return counts.reshape(-1, n_dev)


# ---------------------------------------------------------------- DP steps
def make_dp_train_step(cfg, mesh: Mesh):
    """The data-parallel GAN step: ``step(state, batch, draws, n_valid=None,
    n_valid_global=None)`` with this rank's scene-aligned ``batch`` and the
    GLOBAL batch's ``draws``.  Gradients are count-weighted and averaged
    over the mesh in one all-reduce a sync, metrics come back reduced
    (equal on every rank), and the step is a no-op only when every rank's
    chunk is padding."""
    from socialways_torch.engine.train_step import gan_step

    def step(state, batch, draws, n_valid=None, n_valid_global=None):
        return gan_step(state, batch, draws, cfg, n_valid=n_valid,
                        mesh=mesh, n_valid_global=n_valid_global)
    return step


def make_dp_epoch_fn(cfg, mesh: Mesh, runner=None):
    """The data-parallel epoch: ``epoch(state, batches, draws,
    counts=None)`` runs the DP step over this rank's column of groups
    (``batches`` [groups, width, ...] on the device, one global
    ``StepDraws`` a group, ``counts`` the [groups, D] host valid counts)
    and returns the state and the epoch's reduced metrics (JAX's
    ``make_dp_epoch_fn``): the Trainer's epoch on the mesh.  On a CUDA
    device with ``cfg.epoch_on_device`` (NCCL; another backend raises) it
    is the graphed epoch, as JAX's is one program: ``runner`` (an
    ``engine.graphed.EpochGraphs`` of ``batches``, such as
    ``Trainer(mesh=).epoch_graphs``), or one built for ``batches`` at the
    first call, replays a captured DP step a group.  Otherwise it is the
    eager loop, ``engine.trainer.run_epoch``."""
    from socialways_torch.engine.graphed import EpochGraphs, solo_clock
    from socialways_torch.engine.train_step import stack_draws
    from socialways_torch.engine.trainer import check_graphable, run_epoch
    graphed = check_graphable(cfg, mesh.device, mesh)

    def epoch(state, batches, draws, counts=None):
        nonlocal runner
        if not graphed:
            return run_epoch(state, batches, draws, cfg, counts, mesh)
        if runner is None or runner.batches is not batches:
            if counts is None:
                counts = _group_counts(batches, mesh)
            runner = EpochGraphs(cfg, batches, counts, mesh=mesh)
        return state, runner.epoch(state, stack_draws(draws),
                                   solo_clock(cfg, state))
    return epoch


def _group_counts(batches, mesh: Mesh) -> np.ndarray:
    """[groups, D] valid rows of every rank's chunk of each group (one
    all-gather and a host read)."""
    local = batches["valid"].sum(dim=1)
    return all_gather_rows(local[None], mesh).T.cpu().numpy()


def make_dp_epochs_fn(cfg, mesh: Mesh, runner=None):
    """``n`` DP epochs: ``epochs(state, batches, draws_of_epoch, n,
    counts=None)`` with ``draws_of_epoch(e)`` the e-th epoch's draws; the
    LAST epoch's metrics (JAX's ``make_dp_epochs_fn``), graphed as
    ``make_dp_epoch_fn``'s epoch."""
    epoch = make_dp_epoch_fn(cfg, mesh, runner)

    def epochs(state, batches, draws_of_epoch, n, counts=None):
        for e in range(n):
            state, m = epoch(state, batches, draws_of_epoch(e), counts)
        return state, m
    return epochs


def make_dp_eval_chunk(cfg, mesh: Mesh, k: int):
    """The data-parallel K-sample eval of this rank's rows: ``fn(g_params,
    batch, generator=None, noise=None)``; the noise is the GLOBAL batch's
    (drawn here from ``generator``, identical on every rank, or given) and
    each rank keeps its rows, so the sums equal the single-process
    ``eval_chunk`` on the concatenated group; the sums come back reduced."""
    from socialways_torch.eval.metrics import eval_chunk

    def fn(g_params, batch, generator=None, noise=None):
        return eval_chunk(g_params, batch, k, cfg, generator, noise,
                          mesh=mesh)
    return fn
