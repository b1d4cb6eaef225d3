"""The data-parallel epoch on the device (socialways_torch/engine/graphed.py
under a mesh, ``Trainer(mesh=)``, ``EnsembleTrainer(mesh=)``,
``make_dp_epoch_fn``) on the CPU, where a CUDA graph's capture is stubbed
(``torch_dist_workers.stub_capture``: the step runs and the state, the
sums and the step index are put back, and a replay runs the step again
from the device index, so that anything the capture baked would show).

The ranks are gloo processes (``parallel.spawn``, the rank functions in
``torch_dist_workers``): one spawn of 2 ranks and one of 4 run every case,
started in threads while this process compiles JAX's ``make_dp_epoch_fn``
on 4 CPU devices.

- (a) graphed DP epochs equal the eager DP loop (``epoch_on_device=False``,
  ``--host-loop``) bit for bit at 2 and 4 ranks: a ragged last group with
  filler ranks (its count weights differ from the first group's), a D/G
  ratio of 2 (both outcomes captured) in one ``train_epochs`` call, mb_std
  under R1 (the coupled loss weight), bf16, and rescues that replace the
  state on every rank and then on rank 0 alone (recaptured in lockstep).
- (b) no host read in any DP step after the first until the epoch's one
  metrics read (``NoHostRead``), graphed and eager.
- (c) the graphed DP epoch against JAX's ``make_dp_epoch_fn`` on 4
  devices under JAX's draws: the state within rtol 2e-4 / atol 1e-6 (the
  bound of ``test_torch_dp_epoch_fn_equals_step_loop_and_trainer``), the
  counts exactly, the metrics within rtol 1e-4 / atol 1e-5 (the port's
  epoch against JAX's in test_torch_training.py).
- (d) ``EnsembleTrainer(mesh=)`` graphed equals its eager epochs bit for
  bit and the 4-member ensemble in one process within rtol 2e-4.
- (e) a gloo mesh on a CUDA device with ``epoch_on_device`` raises,
  naming ``--host-loop``.
"""

import threading
import types

import numpy as np
import jax
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.parallel import make_dp_epoch_fn as jax_dp_epoch_fn
from socialways_tpu.parallel import make_mesh
from socialways_torch.config import TrainConfig
from socialways_torch.data.toy import make_toy_npz_arrays
from socialways_torch.engine import trainer as trainer_mod
from socialways_torch.engine.trainer import Trainer, check_graphable
from socialways_torch.io.checkpoint import flatten_state, train_state_from_jax
from socialways_torch.parallel import make_dp_epoch_fn, spawn
from test_torch_gan_variants import jax_draws
from test_torch_train_step import jax_init
from torch_dist_workers import run_cases

dist = pytest.importorskip("torch.distributed")
if not dist.is_available() or not dist.is_gloo_available():
    pytest.skip("torch.distributed with gloo is not available",
                allow_module_level=True)

H = 16
#: the loo features at the test width; batch 40 packs the toy set's
#: training split into chunks of [36, 36, 36, 36, 24] valid rows: groups
#: [36, 36], [36, 36], [24, 0] at 2 ranks and [36] * 4, [24, 0, 0, 0] at 4
BASE = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
            batch_size=40, agent_frame=True, use_social=True,
            g_ema_decay=0.99, n_unrolling_steps=1, d_input_noise=0.05,
            d_input_noise_steps=12, d_input_noise_floor=0.02, n_epochs=4)
#: (a): the case and the captures each rank's graphed run takes
CASES = {
    "ragged_filler": (dict(cfg=BASE, epochs=2), 1),
    "d_ratio_2": (dict(cfg=dict(BASE, d_update_every=2, lr_decay_rate=0.9,
                                lr_decay_steps=2), epochs=2, fused=True), 2),
    "mb_std_r1": (dict(cfg=dict(BASE, mb_std=True, r1_gamma=0.5),
                       epochs=2), 1),
    "bf16": (dict(cfg=dict(BASE, compute_dtype="bfloat16"), epochs=2), 1),
    "rescue_lockstep": (dict(cfg=BASE, epochs=3,
                             rescue={0: "all", 1: "rank0"}), 3),
}
NO_READ = {2: ("graph", "eager"), 4: ("graph",)}
#: (c): JAX's configuration (no anneal sentinel: both sides resolve it)
JAX_FLAGS = dict(BASE, n_past=2, n_next=2)
SEEDS = [0, 1, 2, 3]
TIMEOUT = 240


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp_graphed") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays())
    return path


def _spawn_thread(world, cases, box):
    def target():
        try:
            box["out"] = spawn(run_cases, world, "cpu", args=(cases,),
                               timeout=TIMEOUT)
        except BaseException as e:              # re-raised by the fixture
            box["err"] = e
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def runs(toy_npz):
    """Both spawns' results and JAX's epoch, keyed by case."""
    jcfg = JaxConfig(**JAX_FLAGS)
    mesh4 = make_mesh(4)
    jtr = JaxTrainer(jcfg, jax_load(toy_npz), mesh=mesh4)
    j0 = jax_init(jax.random.PRNGKey(0), jtr.cfg)
    rng = jax.random.PRNGKey(21)
    n_groups = jtr.n_steps_per_epoch
    width = jtr.train_packed.width
    draws = [[None if t is None else t.numpy() for t in jax_draws(
        k, 4 * width, jtr.cfg)] for k in jax.random.split(rng, n_groups)]
    flat0 = flatten_state(train_state_from_jax(
        jax.device_get(j0), TrainConfig(**JAX_FLAGS), "cpu"))

    cases = {2: [], 4: []}
    for world in (2, 4):
        for tag, (case, _) in CASES.items():
            cases[world].append(("graphed_dp_case",
                                 dict(case, npz=toy_npz, seed=4)))
        for mode in NO_READ[world]:
            cases[world].append(("no_host_read_case",
                                 dict(cfg=BASE, npz=toy_npz, mode=mode)))
    cases[4].append(("jax_epoch_case", dict(cfg=JAX_FLAGS, npz=toy_npz,
                                            flat=flat0, draws=draws)))
    cases[2].append(("graphed_ensemble_case", dict(
        cfg=dict(BASE, batch_size=64), npz=toy_npz, seeds=SEEDS,
        epochs=2)))
    boxes = {2: {}, 4: {}}
    threads = [_spawn_thread(w, cases[w], boxes[w]) for w in (2, 4)]

    # JAX's side while the ranks run
    epoch, _ = jax_dp_epoch_fn(jtr.cfg, mesh4)
    j1, jm = epoch(j0, jtr._train_dev, rng)
    want = (_flatten(jax.device_get(j1)), jax.device_get(jm), n_groups)

    for t in threads:
        t.join(TIMEOUT + 30)
    for box in boxes.values():
        if "err" in box:
            raise box["err"]
    return {"w2": boxes[2]["out"], "w4": boxes[4]["out"], "jax": want}


def _result(runs, world, fn, index=0):
    """Every rank's result of the ``index``-th case of ``fn``."""
    at = [i for i, (name, _) in enumerate(_case_names(world)) if name == fn]
    return [rank[at[index]] for rank in runs[f"w{world}"]]


def _case_names(world):
    names = [("graphed_dp_case", t) for t in CASES]
    names += [("no_host_read_case", m) for m in NO_READ[world]]
    names += ([("jax_epoch_case", "")] if world == 4
              else [("graphed_ensemble_case", "")])
    return names


def _assert_equal_flat(got, want, tag):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{tag} {key}")


# -------------------------------------------------------------------- (a)
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", list(CASES))
def test_torch_graphed_dp_epochs_equal_the_eager_dp_loop(runs, world, tag):
    """Every rank's graphed DP epochs (the capture stubbed) equal the eager
    DP loop bit for bit: the state, every count and the metrics of every
    call; every rank holds the same state and took the same captures."""
    res = _result(runs, world, "graphed_dp_case", list(CASES).index(tag))
    want_captures = CASES[tag][1]
    counts = np.array(res[0]["counts"])
    assert counts.shape == (res[0]["steps"], world)
    assert counts[-1, -1] == 0 and counts[-1].sum() < counts[0].sum()
    for rank, r in enumerate(res):
        (flat_g, m_g), (flat_e, m_e) = r["graph"], r["eager"]
        _assert_equal_flat(flat_g, flat_e, f"{tag} rank {rank}")
        assert m_g == m_e
        assert all(np.isfinite(m["g_loss"]) for m in m_g)
        assert r["captures"] == want_captures, rank
        _assert_equal_flat(flat_g, res[0]["graph"][0], f"{tag} rank {rank}")
    g_count = int(res[0]["graph"][0][".g_opt/[0]/.count"])
    assert g_count == CASES[tag][0]["epochs"] * res[0]["steps"]


# -------------------------------------------------------------------- (b)
@pytest.mark.parametrize("world,mode", [(w, m) for w in NO_READ
                                        for m in NO_READ[w]])
def test_torch_dp_epoch_reads_nothing_on_the_host_between_steps(runs, world,
                                                                mode):
    """Every DP step of an epoch after the first runs under ``NoHostRead``
    on every rank, until the epoch's one metrics read."""
    res = _result(runs, world, "no_host_read_case",
                  NO_READ[world].index(mode))
    for r in res:
        # graphed: the warm-up, the stubbed capture and a replay a step
        want = r["steps"] + (1 if mode == "graph" else 0)
        assert len(r["calls"]) == want and r["left"]
        assert r["calls"][-1] > r["calls"][0] == 0
        assert np.isfinite(r["g_loss"])


# -------------------------------------------------------------------- (c)
def test_torch_graphed_dp_epoch_matches_jax_dp_epoch_fn(runs):
    """The graphed DP epoch at 4 ranks under JAX's draws equals JAX's
    ``make_dp_epoch_fn`` on 4 devices (a ragged group with 3 filler
    ranks), through ``Trainer(mesh=)``, ``make_dp_epoch_fn`` and
    ``make_dp_epochs_fn`` given the trainer's runner, which agree bit for
    bit; every rank holds the same state."""
    jflat, jm, n_groups = runs["jax"]
    res = _result(runs, 4, "jax_epoch_case")
    flat, m = res[0]["trainer"]
    assert m["steps"] == n_groups == 2
    assert sorted(flat) == sorted(jflat)
    for key in jflat:
        if key.endswith(".count"):
            assert int(flat[key]) == int(jflat[key]), key
            continue
        np.testing.assert_allclose(flat[key], np.asarray(jflat[key]),
                                   rtol=2e-4, atol=1e-6, err_msg=key)
    for way in ("epoch_fn", "epochs_fn"):
        _assert_equal_flat(res[0][way][0], flat, way)
        assert res[0][way][1]["n_samples"] == int(jm.n_samples)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(res[0][way][1][name],
                                       float(getattr(jm, name)), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{way} {name}")
    for r in res[1:]:
        for way in ("trainer", "epoch_fn", "epochs_fn"):
            _assert_equal_flat(r[way][0], flat, way)


# -------------------------------------------------------------------- (d)
def test_torch_graphed_ensemble_mesh_equals_eager_and_single_process(runs):
    """``EnsembleTrainer(mesh=)`` with 2 members a rank, graphed (each rank
    its own captures: the member step holds no collective) against its
    eager epochs bit for bit, and against the 4-member ensemble in one
    process within rtol 2e-4 (parameters atol 1e-6)."""
    res = _result(runs, 2, "graphed_ensemble_case")
    single_flats, single_ms = res[0]["single"]
    flats = []
    for r in res:
        (fg, mg), (fe, me) = r["graph"], r["eager"]
        assert r["captures"] == 1
        for i, (a, b) in enumerate(zip(fg, fe)):
            _assert_equal_flat(a, b, f"member {i}")
        for a, b in zip(mg, me):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], key)
        flats += fg
    assert len(flats) == len(SEEDS)
    for got, want in zip(flats, single_flats):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                       atol=1e-6, err_msg=key)
    for a, b in zip(res[0]["graph"][1], single_ms):
        for key in a:
            assert a[key].shape == (len(SEEDS),)
            np.testing.assert_allclose(a[key], b[key], rtol=2e-4,
                                       err_msg=key)


# -------------------------------------------------------------------- (e)
def _stand_in(backend):
    """A rank's mesh on a card, as ``parallel.Mesh`` gives it."""
    return types.SimpleNamespace(shape=(2,), axis_names=("data",), rank=0,
                                 device=torch.device("cuda", 0),
                                 backend=backend, size=2)


@pytest.mark.parametrize("entry", ["Trainer", "make_dp_epoch_fn"])
def test_torch_gloo_mesh_on_cuda_refuses_the_graphed_epoch(entry, toy_npz,
                                                           monkeypatch):
    """A gloo mesh on a CUDA device with ``epoch_on_device`` raises before
    anything moves to the card, naming ``--host-loop``; with
    ``epoch_on_device=False`` it is taken (eager)."""
    from socialways_torch.data.dataset import load_npz_dataset
    mesh = _stand_in("gloo")
    cfg = TrainConfig(**BASE)
    monkeypatch.setattr(trainer_mod, "resolve_device", lambda d: d)
    with pytest.raises(ValueError, match="--host-loop"):
        if entry == "Trainer":
            Trainer(cfg, load_npz_dataset(toy_npz), mesh=mesh)
        else:
            make_dp_epoch_fn(cfg, mesh)
    assert not check_graphable(cfg.replace(epoch_on_device=False),
                               mesh.device, mesh)
    if entry == "make_dp_epoch_fn":
        make_dp_epoch_fn(cfg.replace(epoch_on_device=False), mesh)


@pytest.mark.parametrize("device,backend,want", [
    ("cuda", "nccl", True), ("cuda", None, True), ("cpu", "gloo", False),
    ("cpu", None, False)])
def test_torch_graphed_epoch_runs_on_cuda_alone_and_nccl(device, backend,
                                                         want):
    """Which trainers graph their epochs: ``epoch_on_device`` on a CUDA
    device, without a mesh or on NCCL; never on the CPU."""
    mesh = None if backend is None else _stand_in(backend)
    cfg = TrainConfig(**BASE)
    assert check_graphable(cfg, torch.device(device), mesh) == want
    assert not check_graphable(cfg.replace(epoch_on_device=False),
                               torch.device(device), mesh)
