"""The port's tracer (socialways_torch/utils/profiling.py) on the CPU, and
its device stamps on the card.

- Off (no profiler session): ``span`` and ``phase`` call neither
  ``record_function`` nor the stamp, in the tracer's calls and in an
  eager ``gan_step``, ``crowd_simulate`` and ``k_sample_rollout``.
- On (under ``torch.profiler``): the three paths record their documented
  spans (``train.step`` with rollout, d_update, g_update, finish;
  ``sim.call`` holding ``sim.window`` units; ``forecast.request``; the
  rollout units' encode, attention, decode, frame), each with its
  parent, a unit's spans sharing its id; the profiler's trace names them.
- A second session leaves only its own spans for the readers, whether or
  not an untraced call came between the two.
- With tracing on, an epoch reads nothing on the host between its steps
  (the ``TorchDispatchMode`` of tests/test_torch_device_clock.py).
- The graph counters with ``EpochGraphs``' capture stubbed: one eager
  step and one capture an outcome, a replay every later step.
- The benchmark's readers of the tracer: None outside a traced run and
  from a program without the tracer's functions; the host metrics read
  the units of the block.
- ``cuda``: a captured, replayed ``gan_step`` holds 5 stamps a replay, in
  order, and its phases sum to within 5 % of the replay's CUDA-event
  time (``python -m pytest tests/test_torch_tracing.py -m cuda
  --noconftest``).
"""

import contextlib
import ctypes
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.data.toy import make_toy_npz_arrays
from socialways_torch.engine import graphed
from socialways_torch.engine import trainer as trainer_mod
from socialways_torch.engine.simulate import crowd_simulate, initial_crowd
from socialways_torch.engine.train_step import (STEP_PHASES, draw_step,
                                                gan_step)
from socialways_torch.engine.trainer import Trainer
from socialways_torch.eval.metrics import k_sample_rollout
from socialways_torch.models.generator import ROLLOUT_PHASES, init_generator
from socialways_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_workers import NoHostRead, stub_capture  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 16
CFG = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
           batch_size=48, agent_frame=True, use_social=True,
           g_ema_decay=0.999, d_input_noise=0.05, d_input_noise_steps=-1,
           d_input_noise_floor=0.02, n_epochs=10)
READERS = ["rollout_device_ms", "d_update_device_ms", "g_update_device_ms",
           "finish_device_ms", "replayed_share", "encode_device_ms",
           "attention_device_ms", "decode_device_ms", "frame_device_ms",
           "rollout_host_ms", "host_lead_ms"]


@pytest.fixture(scope="module")
def toy_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tracing") / "toy.npz"
    np.savez(path, **make_toy_npz_arrays(n_samples=3 * 6 * 12,
                                         n_conditions=6, n_modes=3,
                                         n_per_batch=6, seed=30))
    return str(path)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def run_path(name, device="cpu"):
    """One call of the path ``name`` at a tiny size; returns the number
    of units it runs."""
    cfg = TrainConfig(**CFG)
    if name == "gan_step":
        tr = Trainer(cfg, load_npz_dataset(run_path.toy), device)
        state = tr.init_state(1)
        chunk = {k: v[0] for k, v in tr.train_dev.items()}
        draws = draw_step(chunk["valid"].shape[0], tr.cfg,
                          torch.Generator().manual_seed(2), device)
        gan_step(state, chunk, draws, tr.cfg)
        return 1
    g = init_generator(cfg, torch.Generator().manual_seed(0), device)
    obsv, ids = initial_crowd(40, 8, cfg.n_past, 0)
    obsv, ids = torch.from_numpy(obsv), torch.from_numpy(ids)
    gen = torch.Generator().manual_seed(1)
    if name == "crowd_simulate":
        crowd_simulate(g, obsv, ids, 2, cfg, gen)
        return 2
    k_sample_rollout(g, obsv, ids, 3, cfg, gen)
    return 1


PATHS = ["gan_step", "crowd_simulate", "k_sample_rollout"]


@pytest.fixture(autouse=True)
def _toy(toy_path):
    run_path.toy = toy_path


def _refuse(*a, **k):
    raise AssertionError("called with tracing off")


@pytest.mark.parametrize("path", ["spans"] + PATHS)
def test_torch_tracing_off_calls_nothing(path, monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(profiling, "_launch", _refuse)
    monkeypatch.setattr(profiling, "_stamps", _refuse)
    if path == "spans":
        for _ in range(3):
            with profiling.span("u", unit=True, phases=("a",),
                                device=torch.device("cpu")) as rec:
                assert rec is None
                profiling.phase("a")
                with profiling.span("inner"):
                    profiling.phase("a")
        assert profiling.span("x") is profiling.span("y")
    else:
        run_path(path)
    assert not profiling._stack


#: the documented spans of each path: (name, parent's name) in order
WANT = {
    "gan_step": [("train.step", None)]
    + [(p, "train.step") for p in STEP_PHASES],
    "crowd_simulate": [("sim.call", None)]
    + 2 * ([("sim.window", "sim.call")]
           + [(p, "sim.window") for p in ROLLOUT_PHASES]),
    "k_sample_rollout": [("forecast.request", None)]
    + [(p, "forecast.request") for p in ROLLOUT_PHASES],
}


@pytest.mark.parametrize("path", PATHS)
def test_torch_tracing_records_the_documented_spans(path):
    run_path(path)                 # untraced: the next session is fresh
    with traced() as prof:
        n_units = run_path(path)
    recs = profiling._session.records
    by_id = {r.id: r for r in recs}
    got = [(r.name, None if r.parent is None else by_id[r.parent].name)
           for r in recs]
    assert got == WANT[path]
    units = [r for r in recs if r.is_unit]
    assert len(units) == n_units
    for r in recs:
        if r.is_unit:
            assert r.unit == r.id
            assert [p.name for p in r.phases] == list(
                STEP_PHASES if path == "gan_step" else ROLLOUT_PHASES)
        elif r.parent is not None and by_id[r.parent].is_unit:
            assert r.unit == r.parent
        assert r.t1 >= r.t0 > 0
    for u in units:
        # the phases are contiguous and span the unit
        assert u.phases[0].t0 == u.t0 and u.phases[-1].t1 == u.t1
        assert all(a.t1 == b.t0 for a, b in zip(u.phases, u.phases[1:]))
    names = {e.name for e in prof.events()}
    assert {n for n, _ in WANT[path]} <= names
    assert profiling.unit_host_ms(n_units) > 0
    # the CPU launches no stamp: the device aggregations read nothing
    assert profiling.phase_device_ms(WANT[path][1][0], n_units) is None
    assert profiling.host_lead_ms(n_units) is None


@pytest.mark.parametrize("between", ["untraced_call", "back_to_back"])
def test_torch_second_session_leaves_its_own_spans(between):
    with traced():
        run_path("crowd_simulate")
    first = profiling._session
    if between == "untraced_call":
        run_path("k_sample_rollout")
    with traced():
        run_path("k_sample_rollout")
    units = profiling.last_units(1, device=False)
    assert [u.record.name for u in units] == ["forecast.request"]
    assert profiling.unit_host_ms(1) == pytest.approx(
        1e-6 * (units[0].record.t1 - units[0].record.t0))
    # the last units are of one kind: none reach back into the first
    assert profiling.last_units(2, device=False) is None
    if between == "untraced_call":
        assert profiling._session is not first
        assert len([r for r in profiling._session.records
                    if r.is_unit]) == 1


def test_torch_trace_writes_the_sessions_spans(tmp_path):
    with traced():
        run_path("crowd_simulate")
    with profiling.trace(str(tmp_path)):
        run_path("k_sample_rollout")
    with open(tmp_path / "spans.json") as f:
        out = json.load(f)
    assert [s["name"] for s in out["spans"]] == [
        n for n, _ in WANT["k_sample_rollout"]]
    assert not out["lost"]
    assert all(s["device_start_ns"] is None for s in out["spans"])
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("members", [False, True], ids=["solo", "members"])
def test_torch_tracing_on_reads_nothing_on_the_host(members, toy_path,
                                                    monkeypatch):
    """Every step of a traced epoch after the first runs under
    ``NoHostRead``, until the epoch's metrics read."""
    from socialways_torch.engine import ensemble as ensemble_mod
    from socialways_torch.engine.ensemble import EnsembleTrainer
    tr = Trainer(TrainConfig(**CFG), load_npz_dataset(toy_path), "cpu")
    mode, calls, left = NoHostRead(), [], []
    mod = ensemble_mod if members else trainer_mod
    real_step = mod.gan_step

    def step(*args, **kwargs):
        out = real_step(*args, **kwargs)
        calls.append(mode.ops)
        if len(calls) == 1:
            mode.__enter__()
        return out

    def leave():
        if len(calls) and not left:
            left.append(1)
            mode.__exit__(None, None, None)
    monkeypatch.setattr(mod, "gan_step", step)
    cls, attr = ((EnsembleTrainer, "_metrics") if members
                 else (Trainer, "_host_metrics"))
    real_metrics = getattr(cls, attr)
    monkeypatch.setattr(cls, attr, lambda self, *a:
                        (leave(), real_metrics(self, *a))[1])
    gen = lambda s: torch.Generator().manual_seed(s)
    try:
        with traced():
            if members:
                ens = EnsembleTrainer(tr)
                ens.train_epoch(ens.init_states([1, 2]), [gen(3), gen(4)])
            else:
                tr.train_epoch(tr.init_state(1), gen(3))
    finally:
        leave()
    assert len(calls) == tr.n_steps_per_epoch and calls[-1] > 0
    units = profiling.last_units(tr.n_steps_per_epoch, device=False)
    assert [u.record.name for u in units] == ["train.step"] * len(units)


def test_torch_graph_counters_count_each_replay(toy_path, monkeypatch):
    """With the capture stubbed: an eager step and a capture for each of
    the D/G ratio's two outcomes, a replay for every other step; traced,
    the replays' share of the block's steps."""
    monkeypatch.setattr(graphed.EpochGraphs, "_capture", stub_capture)
    monkeypatch.setattr(Trainer, "graphed", property(lambda self: True))
    cfg = TrainConfig(**dict(CFG, d_update_every=2))
    tr = Trainer(cfg, load_npz_dataset(toy_path), "cpu")
    state, steps = tr.init_state(1), tr.n_steps_per_epoch
    before = dict(profiling.counters)
    gain = lambda: {k: profiling.counters.get(k, 0) - before.get(k, 0)
                    for k in ("graph.eager_steps", "graph.captures",
                              "graph.replays")}
    tr.train_epochs(state, torch.Generator().manual_seed(3), 2)
    assert gain() == {"graph.eager_steps": 2, "graph.captures": 2,
                      "graph.replays": 2 * steps - 2}
    with traced():
        tr.train_epochs(state, torch.Generator().manual_seed(4), 1)
    assert gain()["graph.replays"] == 3 * steps - 2
    assert profiling.counted_share("graph.replays", steps) == 100.0
    units = profiling.last_units(steps, device=False)
    assert all(u.record.counted == {"graph.replays": 1} for u in units)


def _reader(stem):
    path = os.path.join(ROOT, "perfbench", "metrics", stem + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ctx:
    def __init__(self, trace, units):
        self.trace, self.traced_units, self.trace_whole = trace, units, True


@pytest.mark.parametrize("stem", READERS)
def test_torch_tracing_readers(stem, monkeypatch):
    """Each reader: None outside a traced run; None from a program whose
    tracer lacks its function (a parent program); on the CPU a number
    for the host metrics alone."""
    read = _reader(stem).read
    with traced():
        run_path("k_sample_rollout")
    assert read(_Ctx(None, 1)) is None
    got = read(_Ctx(object(), 1))
    if stem == "rollout_host_ms":
        assert got == pytest.approx(profiling.unit_host_ms(1)) and got > 0
    elif stem == "replayed_share":
        assert got == 0.0
    else:
        assert got is None
    for fn in ("phase_device_ms", "unit_host_ms", "host_lead_ms",
               "counted_share"):
        monkeypatch.delattr(profiling, fn)
    assert read(_Ctx(object(), 1)) is None


class _FakeRing:
    """The stamp library's read on the CPU: ``stamps`` [(code, ns)] in
    launch order, written into a ring of ``size`` slots as the kernel
    writes them."""

    def __init__(self, stamps, size):
        self.stamps, self.size = stamps, size

    def trace_ring_size(self):
        return self.size

    def trace_read(self, cursor, buf):
        ring = np.zeros((self.size, 2), np.int64)
        for seq, stamp in enumerate(self.stamps):
            ring[seq % self.size] = stamp
        cursor._obj.value = len(self.stamps)
        dst = np.ctypeslib.as_array(
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_int64)),
            (self.size * 2,))
        dst[:] = ring.ravel()
        return 0


@pytest.mark.parametrize("before, after", [(0, 0), (9, 0), (0, 4)],
                         ids=["fresh", "wrapped", "lost"])
def test_torch_ring_reads_stamps_back_in_launch_order(before, after,
                                                      monkeypatch):
    """A replayed unit (entry, the graph's 5 stamps, exit) and an eager
    one (entry, 3 boundaries, exit), ``before`` older stamps ahead of
    them and ``after`` later ones (a replay's when tracing is off) behind,
    in a ring of 16: their phases in order; a ring that overwrote one of
    the session's stamps reads as a loss."""
    marks = STEP_PHASES + (None,)
    s = profiling._Session()
    s.anchor, s.launched = 100, {100: 1000}
    replay = profiling.SpanRecord("train.step", 1, None, 1, 0, 10, d0=101,
                                  d1=102, is_unit=True, marks=marks)
    eager = profiling.SpanRecord("train.step", 2, None, 2, 10, 20, d0=103,
                                 d1=107, is_unit=True)
    codes = [103, 104, 105, 106, 107]
    eager.phases = [profiling.SpanRecord(p, 3 + i, 2, 2, 0, d0=a, d1=b)
                    for i, (p, a, b) in enumerate(zip(STEP_PHASES, codes,
                                                      codes[1:]))]
    s.records = [replay, eager]
    stamps = [(7, 1)] * before + [(100, 5000)]
    for i, c in enumerate([101, -1, -2, -3, -4, -5, 102] + codes):
        s.launched.setdefault(c, 2000 + 10 * i) if c > 0 else None
        stamps.append((c, 6000 + 100 * i * (i + 1)))
    stamps += [(-1, 9 ** 9)] * after
    monkeypatch.setattr(profiling, "_session", s)
    monkeypatch.setattr(profiling, "_stamps",
                        lambda: _FakeRing(stamps, 16))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    if after:
        assert profiling._ring(s) is None
        assert profiling.last_units(2) is None
        assert profiling.phase_device_ms("rollout", 2) is None
        return
    units = profiling.last_units(2)
    ns = [t for _, t in stamps[before + 1:]]
    assert units[0].phases == [(p, ns[1 + k], ns[2 + k])
                               for k, p in enumerate(STEP_PHASES)]
    assert units[1].phases == [(p, ns[7 + k], ns[8 + k])
                               for k, p in enumerate(STEP_PHASES)]
    want = [(ns[2 + k] - ns[1 + k]) + (ns[8 + k] - ns[7 + k])
            for k in range(4)]
    for p, w in zip(STEP_PHASES, want):
        assert profiling.phase_device_ms(p, 2) == pytest.approx(1e-6 * w / 2)
    assert [(u.start, u.end) for u in units] == [(ns[1], ns[5]),
                                                 (ns[7], ns[11])]
    # each eager stamp's lag behind its launch, against the anchor's
    lags = [(t - 5000) - (s.launched[c] - 1000)
            for c, t in stamps[before + 1:] if c in (101, 102, *codes)]
    assert profiling.host_lead_ms(2) == pytest.approx(
        1e-6 * float(np.median(lags)))


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_torch_captured_step_stamps_each_replay_cuda(toy_path):
    """A graphed epoch: the captured step holds 5 stamps (4 phases), and
    each traced replay reads them back in order between its own entry
    and exit stamps; the phases sum to within 5 % of the replay's CUDA
    event time.  The replays queue behind a device sleep, so the events
    time the device's work and not the host's launches (the profiler
    slows each graph launch to about a millisecond)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamp is a CUDA kernel")
    cfg = TrainConfig(**CFG)
    tr = Trainer(cfg, load_npz_dataset(toy_path), "cuda")
    assert tr.graphed
    state = tr.init_state(1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tr.train_epochs(state, gen, 1)
    runner = tr.epoch_graphs
    (graph, _, marks), = runner.graphs.values()
    assert marks == STEP_PHASES + (None,)
    steps = len(runner.n_valid)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    runner.idx.zero_()
    with traced():
        with profiling.span("anchor", device=runner.idx.device):
            pass                   # the session's synchronize and anchor
        torch.cuda._sleep(int(2e8 + 1e8 * steps))
        for e0, e1 in events:
            e0.record()
            with profiling.span("train.step", unit=True,
                                device=runner.idx.device, replay=marks):
                graph.replay()
            e1.record()
        torch.cuda.synchronize()
    units = profiling.last_units(steps)
    assert units is not None
    for u, (e0, e1) in zip(units, events):
        assert [p[0] for p in u.phases] == list(STEP_PHASES)
        assert all(a[2] == b[1] for a, b in zip(u.phases, u.phases[1:]))
        phases_ms = 1e-6 * sum(e - s for _, s, e in u.phases)
        assert phases_ms == pytest.approx(e0.elapsed_time(e1), rel=0.05)
    assert profiling.phase_device_ms("g_update", steps) > 0
    assert profiling.counted_share("graph.replays", steps) == 0.0
    # the ring holds the stamps in launch order: a replay's entry, the 5
    # captured ones, its exit
    ring = profiling._ring(profiling._session)
    codes = [int(c) for c in ring.codes]
    start = codes.index(units[0].record.d0)
    for i, u in enumerate(units):
        assert codes[start + 7 * i:start + 7 * i + 7] == [
            u.record.d0, -1, -2, -3, -4, -5, u.record.d1]
