"""The port's ETH/UCY leave-one-scene-out protocol against socialways_tpu:
obsmat discovery, validation and scene building, ``merge_scenes`` bit for
bit, ``run_leave_one_out``'s eval / best-tracking / rescue decisions against
JAX's loop on scripted evals, the best-state snapshot under in-place training, the
independence of the training draws from the evals, and the CLI
(``eth-ucy`` JSON, ``predict`` on a raw obsmat file)."""

import copy
import itertools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from socialways_tpu.cli.main import main as jax_cli
from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.engine import ethucy as jethucy
from socialways_tpu.engine import train_step as jtrain_step
from socialways_torch.cli.main import main as torch_cli
from socialways_torch.config import TrainConfig
from socialways_torch.engine import ethucy
from socialways_torch.engine.trainer import Trainer
from socialways_torch.io.checkpoint import save_checkpoint
from native_lib import load_native
from test_torch_data_pipeline import ETHUCY_LAYOUT as LAYOUT
from test_torch_data_pipeline import write_ethucy_layout
from test_torch_serving import _feed, _jax_noises

H, BATCH, K = 16, 64, 4
TINY = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
            batch_size=BATCH, n_gen_samples=2)
LOO = dict(TINY, agent_frame=True, use_social=True, g_ema_decay=0.999,
           d_input_noise=0.05, d_input_noise_steps=-1,
           d_input_noise_floor=0.02)


@pytest.fixture(autouse=True)
def _native_parser(monkeypatch):
    """JAX's default ``load()`` with its native parser in every test here,
    the library built once across workers (``native_lib``)."""
    load_native(monkeypatch)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    return write_ethucy_layout(tmp_path_factory.mktemp("ethucy") / "raw")


def _copy(raw_dir, dst):
    shutil.copytree(raw_dir, str(dst))
    return str(dst)


@pytest.fixture(scope="module")
def scenes_dir(raw_dir, tmp_path_factory):
    """A copy of the raw layout with every scene npz built by the port."""
    d = _copy(raw_dir, tmp_path_factory.mktemp("built") / "raw")
    ethucy.prepare_scenes(d, TrainConfig(), verbose=False)
    return d


def test_torch_discovery_and_validation_equal_jax(raw_dir):
    found = ethucy.discover_obsmat(raw_dir)
    assert found == jethucy.discover_obsmat(raw_dir)
    assert found == {s: os.path.join(raw_dir, rel)
                     for s, rel in LAYOUT.items()}
    assert ethucy.discover_obsmat(raw_dir, ("hotel", "zara1")) == \
        jethucy.discover_obsmat(raw_dir, ("hotel", "zara1"))
    for rel in list(LAYOUT.values()) + ["notes_obsmat.txt",
                                        "ethucy/obsmat.txt"]:
        path = os.path.join(raw_dir, rel)
        assert ethucy.validate_obsmat(path) == jethucy.validate_obsmat(path)
    assert not ethucy.validate_obsmat(
        os.path.join(raw_dir, "notes_obsmat.txt"))["ok"]


def test_torch_prepare_scenes_builds_what_jax_builds(raw_dir, tmp_path,
                                                      capsys):
    dirs = {"jax": _copy(raw_dir, tmp_path / "jax"),
            "torch": _copy(raw_dir, tmp_path / "torch")}
    out, manifests = {}, {}
    for name, mod, cfg in (("jax", jethucy, JaxConfig()),
                           ("torch", ethucy, TrainConfig())):
        for rnd in range(2):            # the second finds the npz fresh
            m = mod.prepare_scenes(dirs[name], cfg)
            text = capsys.readouterr().out.replace(dirs[name], "DIR")
            manifests[name, rnd] = json.loads(
                json.dumps(m).replace(dirs[name], "DIR"))
            out[name, rnd] = text
    for rnd in range(2):
        assert manifests["torch", rnd] == manifests["jax", rnd]
        assert out["torch", rnd] == out["jax", rnd]
    assert all(v["built"] and v["n_batches"] > 5
               for v in manifests["torch", 0].values())
    assert not any(v["built"] for v in manifests["torch", 1].values())
    for scene in LAYOUT:
        npz = f"{scene}-8-12.npz"
        with np.load(os.path.join(dirs["jax"], npz)) as a, \
                np.load(os.path.join(dirs["torch"], npz)) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_torch_merge_scenes_equals_jax(scenes_dir):
    files = [os.path.join(scenes_dir, f"{s}-8-12.npz") for s in LAYOUT]
    for held in (0, 4):
        train = files[:held] + files[held + 1:]
        want = jethucy.merge_scenes(train, files[held])
        got = ethucy.merge_scenes(train, files[held])
        for key in ("obsvs", "preds", "times", "batches"):
            w, g = getattr(want, key), getattr(got, key)
            assert w.dtype == g.dtype, key
            np.testing.assert_array_equal(w, g, err_msg=key)
        assert got.train_size == want.train_size
        assert got.ss == want.ss
        assert got.scale.to_dict() == want.scale.to_dict()


def _scripted_eval(script, ratio):
    """A held-out eval whose n-th call in a fold returns ADE ``script[n]``
    (FDE twice it, avg-of-K ``ratio`` times it)."""
    def metrics(n):
        ade = script[n % len(script)]
        return {"ade_min": ade, "fde_min": 2 * ade, "ade_avg": ratio * ade,
                "fde_avg": 2 * ratio * ade}
    return metrics


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _g_bits(g_params):
    return {k: v.detach().clone() for k, v in g_params.state_dict().items()}


# LOO arguments, the held-out ADE of each eval in a fold, and avg/min-of-K
DECISION_CASES = {
    # JAX's pinned case (tests/test_ethucy_protocol.py:152-189): the best
    # stays at the first eval and the rescue fires at every eval but the
    # last, twice before a new best
    "pinned": (dict(n_epochs=4, fused_block=2, eval_every=1,
                    ade_stall_recover=1, ade_stall_grace=0,
                    ade_stall_max_rescues=0), [1.0] * 4, 1.0),
    # evals at 2, 4, 6, 8 and a final one at 9: the second rescue restores
    # the best found after the first, the final eval sets a new best
    "new best between rescues": (dict(n_epochs=9, fused_block=2,
                                      eval_every=2, ade_stall_recover=1,
                                      ade_stall_grace=0,
                                      ade_stall_max_rescues=0),
                                 [2.0, 2.0, 1.5, 1.5, 1.0], 2.0),
    # classify-only: the diversity-collapse signature (avg <= 1.2x min)
    # fires after one flat eval; not at the run's end
    "classifier trigger": (dict(n_epochs=4, fused_block=2, eval_every=1,
                                ade_stall_recover=-1, ade_stall_classify=1,
                                ade_stall_grace=0, ade_stall_max_rescues=0),
                           [1.0, 1.0, 0.5, 0.5], 1.1),
}


def _jax_decisions(scenes_dir, kw, metrics, monkeypatch):
    """JAX's run_leave_one_out with a stubbed Trainer whose states are
    serial numbers: the results, and for each rescue the index (in its
    fold) of the eval whose state it restored."""
    evaluated, restored = [], []
    _stub_jax_trainer(monkeypatch)

    def evaluate(self, state, rng, n_gen_samples=None):
        evaluated.append(state)
        return metrics(len(evaluated) - 1)

    def reinit(state, cfg, key):
        restored.append(state)
        return -state                    # a state of its own, untrained

    monkeypatch.setattr(JaxTrainer, "evaluate", evaluate)
    monkeypatch.setattr(jethucy, "reinit_discriminator", reinit)
    res = jethucy.run_leave_one_out(
        scenes_dir, JaxConfig(**TINY), scenes=("eth", "hotel"),
        verbose=False, **kw)
    per_fold = len(evaluated) // 2
    fold_of = {s: i // per_fold for i, s in enumerate(evaluated)}
    return res, len(evaluated), [
        (fold_of[s], evaluated.index(s) % per_fold) for s in restored]


@pytest.mark.parametrize("case", list(DECISION_CASES))
def test_torch_loo_eval_best_tracking_and_rescue(case, scenes_dir,
                                                 monkeypatch):
    """run_leave_one_out's evals, best tracking and rescues equal JAX's on
    the same scenes and the same scripted evals, value by value; each
    rescue starts from the bits of the G that JAX's rescue restores, also a
    second one before a new best."""
    kw, script, ratio = DECISION_CASES[case]
    metrics = _scripted_eval(script, ratio)
    want, want_evals, want_restored = _jax_decisions(scenes_dir, kw,
                                                     metrics, monkeypatch)

    evals, rescued = [], []

    def evaluate(self, g_params, seed=0, n_gen_samples=None, noises=None):
        evals.append(_g_bits(g_params))
        return metrics(len(evals) - 1)

    reinit = ethucy.reinit_discriminator

    def recording_reinit(state, cfg, generator=None):
        rescued.append(_g_bits(state.g))
        d_before = copy.deepcopy(state.d.state_dict())
        out = reinit(state, cfg, generator)
        assert not _equal(out.d.state_dict(), d_before)
        return out

    monkeypatch.setattr(Trainer, "evaluate", evaluate)
    monkeypatch.setattr(ethucy, "reinit_discriminator", recording_reinit)
    got = ethucy.run_leave_one_out(
        scenes_dir, TrainConfig(**TINY), scenes=("eth", "hotel"),
        verbose=False, device="cpu", **kw)

    assert len(evals) == want_evals == 2 * len(script)
    assert len(rescued) == len(want_restored) > 0
    for scene in ("eth", "hotel"):
        w, g = want[scene], got[scene]
        assert sorted(g) == sorted(w)
        assert np.isfinite(g["train_time_s"]) and g["total_wall_s"] > 0
        for key in set(w) - {"train_time_s", "total_wall_s"}:
            assert g[key] == w[key], (scene, key)
    per_fold = len(script)
    for bits, (fold, idx) in zip(rescued, want_restored):
        # the rescued G is exactly that eval's G, and no other eval's
        same = [i for i in range(per_fold)
                if _equal(bits, evals[fold * per_fold + i])]
        assert same == [idx], (fold, idx, same)
    if case == "pinned":
        for scene in ("eth", "hotel"):
            assert got[scene]["rescues"] == [2, 3]
            assert got[scene]["best_at_epoch"] == 1
        assert want_restored == [(0, 0), (0, 0), (1, 0), (1, 0)]


def test_torch_loo_evals_do_not_change_the_training_draws(scenes_dir,
                                                          monkeypatch):
    """eval_every=1 and eval_every=0 train to the same G bits: evals draw
    from a stream of their own."""
    calls = []
    original = Trainer.evaluate

    def recording(self, g_params, seed=0, n_gen_samples=None, noises=None):
        calls.append({k: v.detach().clone()
                      for k, v in g_params.state_dict().items()})
        return original(self, g_params, seed, n_gen_samples, noises)

    monkeypatch.setattr(Trainer, "evaluate", recording)
    finals = {}
    for every in (1, 0):
        calls.clear()
        res = ethucy.run_leave_one_out(
            scenes_dir, TrainConfig(n_epochs=3, seed=4, **LOO),
            scenes=("hotel", "zara2"), fused_block=2, eval_every=every,
            verbose=False, device="cpu")
        assert len(calls) == (2 * 3 if every else 2)
        finals[every] = [calls[len(calls) // 2 - 1], calls[-1]]
        assert all(np.isfinite(res[s]["ade_min"]) for s in res)
    for a, b in zip(finals[1], finals[0]):
        assert _equal(a, b)


def _stub_jax_trainer(monkeypatch):
    """JAX's Trainer without training or rollouts: the LOO loop's control
    flow and the JSON it writes, at no compile cost.  Its states are serial
    numbers, a new one for each init and each training call."""
    metrics = {"d_loss": 0.5, "g_loss": 0.5, "train_ade": 1.0,
               "train_fde": 2.0}
    serial = itertools.count(1)
    monkeypatch.setattr(JaxTrainer, "init_state",
                        lambda self, seed=None: next(serial))
    monkeypatch.setattr(JaxTrainer, "train_epoch", lambda self, state, rng: (
        next(serial), dict(metrics)))
    monkeypatch.setattr(JaxTrainer, "train_epochs",
                        lambda self, state, rng, n: (next(serial),
                                                     dict(metrics)))
    monkeypatch.setattr(JaxTrainer, "evaluate",
                        lambda self, state, rng, n_gen_samples=None: {
                            "ade_avg": 1.5, "fde_avg": 2.5, "ade_min": 1.0,
                            "fde_min": 2.0})


def test_torch_cli_eth_ucy_writes_jax_json_keys(raw_dir, tmp_path,
                                                monkeypatch, capsys):
    args = ["eth-ucy", "--scenes", "eth,hotel", "--epochs", "2", "--h-size",
            str(H), "--batch-size", str(BATCH), "--k", "2",
            "--eval-every", "1"]
    out = {}
    for name, cli in (("torch", torch_cli), ("jax", jax_cli)):
        if name == "jax":
            _stub_jax_trainer(monkeypatch)
        d = _copy(raw_dir, tmp_path / name)
        path = str(tmp_path / f"{name}.json")
        assert cli(["--cpu"] + args + ["--data-dir", d, "--out-json",
                                       path]) == 0
        with open(path) as fh:
            out[name] = json.load(fh)
        printed = capsys.readouterr()
        assert "NOTE: eth-ucy defaults to --recipe loo" in printed.err
        assert f"wrote {path}" in printed.out
    want, got = out["jax"], out["torch"]
    assert sorted(got) == sorted(want) == ["folds", "scenes"]
    for part in ("scenes", "folds"):
        assert sorted(got[part]) == sorted(want[part])
        for scene in want[part]:
            assert sorted(got[part][scene]) == sorted(want[part][scene])
    for scene, fold in got["folds"].items():
        for key in ("ade_min", "fde_min", "best_ade_min", "train_time_s"):
            assert np.isfinite(fold[key]), (scene, key)


def test_torch_cli_eth_ucy_recipe_and_prepare_only(raw_dir, tmp_path,
                                                   capsys):
    from socialways_torch.cli.main import parse_args
    args = parse_args(["eth-ucy", "--data-dir", "x"])
    assert args.agent_frame and args.use_social and args.ade_stall_classify
    assert "defaults to --recipe loo" in capsys.readouterr().err
    bare = parse_args(["eth-ucy", "--data-dir", "x", "--recipe="])
    assert not bare.agent_frame and bare.ade_stall_recover == 0
    assert capsys.readouterr().err == ""
    d = _copy(raw_dir, tmp_path / "raw")
    path = str(tmp_path / "manifest.json")
    assert torch_cli(["--cpu", "eth-ucy", "--data-dir", d, "--prepare-only",
                      "--out-json", path]) == 0
    with open(path) as fh:
        manifest = json.load(fh)["scenes"]
    assert sorted(manifest) == sorted(LAYOUT)
    assert all(os.path.exists(m["npz"]) for m in manifest.values())


@pytest.fixture(scope="module")
def loo_ckpt(scenes_dir, tmp_path_factory):
    """A full-state loo checkpoint written by the port, Scale from the
    hotel scene."""
    from socialways_torch.data.dataset import load_npz_dataset
    ds = load_npz_dataset(os.path.join(scenes_dir, "hotel-8-12.npz"))
    tr = Trainer(TrainConfig(**LOO), ds, "cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "loo.npz")
    save_checkpoint(path, tr.init_state(seed=5), 9, None, ds.scale, tr.cfg)
    return path


def test_torch_cli_predict_raw_obsmat_writes_what_jax_writes(
        raw_dir, loo_ckpt, tmp_path, monkeypatch):
    from socialways_torch.data.forecast import forecast_windows
    from socialways_torch.data.parsers import BIWIParser
    raw = os.path.join(raw_dir, LAYOUT["eth"])
    p = BIWIParser().load(raw)

    def n_agents(t):            # agents with 8 observed frames ending at t
        try:
            return len(forecast_windows(p.p_data, p.t_data, 8, 10, t)[1])
        except ValueError:
            return 0
    busiest = max(np.unique(np.concatenate(p.t_data)), key=n_agents)
    args = ["predict", "--data", raw, "--model-file", loo_ckpt, "--k",
            str(K), "--batch-size", str(BATCH), "--at-time", str(busiest)]
    # JAX draws a template state (~140 small compiles) only for its
    # structure before restoring: give it zeros of the traced shapes
    init = jtrain_step.init_train_state
    monkeypatch.setattr(jtrain_step, "init_train_state", lambda key, cfg: (
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               jax.eval_shape(lambda k: init(k, cfg), key))))
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jax_cli(["--cpu"] + args + ["--out", out_j]) == 0
    dj = dict(np.load(out_j))
    width = max(BATCH, dj["obsvs"].shape[0])
    _feed(monkeypatch, _jax_noises(0, 1, K, width, H // 2))
    assert torch_cli(["--cpu"] + args + ["--out", out_t]) == 0
    dt = dict(np.load(out_t))
    assert sorted(dt) == sorted(dj) == sorted(
        ["obsvs", "preds_our", "preds_lnr", "epoch", "k", "agent_idx",
         "timestamp"])
    n = dj["obsvs"].shape[0]
    assert n > 1 and dt["preds_our"].shape == (K, n, 12, 2)
    np.testing.assert_array_equal(dt["agent_idx"], dj["agent_idx"])
    assert int(dt["timestamp"]) == int(dj["timestamp"])
    ss = float(np.load(loo_ckpt)["__scale__/sx"])
    for key in dj:
        assert dt[key].shape == dj[key].shape, key
        np.testing.assert_allclose(dt[key], dj[key], rtol=1e-4,
                                   atol=1e-5 / ss, err_msg=key)


def test_torch_real_data_entry_points_need_a_card_or_cpu(
        raw_dir, scenes_dir, loo_ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = os.path.join(raw_dir, LAYOUT["hotel"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["eth-ucy", "--data-dir", raw_dir, "--prepare-only"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["predict", "--data", raw, "--model-file", loo_ckpt,
                   "--out", str(tmp_path / "p.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ethucy.run_leave_one_out(scenes_dir, TrainConfig(**TINY),
                                 scenes=("eth", "hotel"), verbose=False)
    # windowing is host work and needs neither
    out = str(tmp_path / "hotel.npz")
    assert torch_cli(["create-dataset", raw, out]) == 0
    assert np.load(out)["obsvs"].shape[1:] == (8, 2)
