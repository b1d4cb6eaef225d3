"""The port's serving path end to end against socialways_tpu: JAX
checkpoints restore in the port, and ``Trainer.evaluate``, ``cli evaluate``
and ``cli predict`` give JAX's numbers under JAX's noise.  Also: the port
imports no JAX, and its entry points refuse to fall back to the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from socialways_tpu.cli.main import main as jax_cli
from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.io.checkpoint import save_checkpoint
from socialways_torch.cli.main import main as torch_cli
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.device import resolve_device
from socialways_torch.engine.trainer import Trainer
from socialways_torch.eval import metrics as tmetrics
from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                            load_checkpoint_config,
                                            restore_generator,
                                            save_generator_checkpoint)
from socialways_torch.models.generator import init_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
H, BATCH, K = 16, 64, 6
LOO = dict(agent_frame=True, use_social=True, g_ema_decay=0.999)


@pytest.fixture(scope="module")
def loo_ckpt(tmp_path_factory):
    """A toy npz and a JAX checkpoint of the loo model (agent frame, social
    attention, EMA generator) whose EMA weights differ from the raw ones."""
    d = tmp_path_factory.mktemp("serving")
    npz = str(d / "toy.npz")
    np.savez(npz, **make_toy_npz_arrays(n_per_batch=6))
    cfg = JaxConfig(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                    batch_size=BATCH, **LOO)
    tr = JaxTrainer(cfg, jax_load(npz))
    state = tr.init_state(seed=3)
    ema = jax.tree_util.tree_map(lambda x: 0.8 * x + 0.01, state.g_params)
    state = state._replace(g_ema=ema)
    ckpt = str(d / "loo.npz")
    save_checkpoint(ckpt, state, 7, jax.random.PRNGKey(0), tr.dataset.scale,
                    tr.cfg)
    return npz, ckpt, tr, state


def _jax_noises(seed, n_chunks, k, width, noise_len):
    """Each chunk's noise as JAX draws it: uniform(split(key, n)[i])."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)
    return [torch.from_numpy(np.array(jax.random.uniform(
        key, (k, width, noise_len)))) for key in keys]


def _feed(monkeypatch, noises):
    """Route the port's noise draws through ``noises``, in order."""
    it = iter(noises)
    monkeypatch.setattr(tmetrics, "draw_noise",
                        lambda k, n, cfg, generator=None, device=None:
                        next(it).to(device))


def test_torch_restores_jax_loo_checkpoint_and_evaluates_like_jax(loo_ckpt):
    npz, ckpt, jtr, state = loo_ckpt
    cfg = adopt_checkpoint_config(TrainConfig(batch_size=BATCH), ckpt)
    assert (cfg.agent_frame, cfg.use_social, cfg.hidden_size) == (
        True, True, H)
    gen, epoch, scale = restore_generator(ckpt, cfg, "cpu")
    assert epoch == 7 and scale.sx == pytest.approx(jtr.dataset.ss)
    np.testing.assert_array_equal(                 # the EMA generator
        gen.decoder[0].w.detach().numpy(),
        np.asarray(state.g_ema["decoder"][0]["w"]))

    tr = Trainer(cfg, load_npz_dataset(npz), "cpu")
    n_chunks = tr.test_packed.n_chunks
    assert n_chunks == jtr.test_packed.n_chunks
    want = jtr.evaluate(state, jax.random.PRNGKey(42), n_gen_samples=K)
    got = tr.evaluate(gen, n_gen_samples=K, noises=_jax_noises(
        42, n_chunks, K, tr.test_packed.width, cfg.noise_len))
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-4), key


def test_torch_reproduces_golden_eval_metrics(tmp_path):
    """The frozen pre-config golden checkpoint (no __config__: the flags
    decide) gives the recorded metrics under JAX's PRNGKey(777) noise."""
    want = json.load(open(os.path.join(FIXTURES,
                                       "golden_toy_h16_metrics.json")))
    npz = str(tmp_path / "toy.npz")
    np.savez(npz, **make_toy_npz_arrays())
    cfg = TrainConfig(hidden_size=16, social_feature_size=16, noise_len=8,
                      batch_size=64, seed=123)
    ckpt = os.path.join(FIXTURES, "golden_toy_h16.npz")
    assert load_checkpoint_config(ckpt) is None
    gen, epoch, _ = restore_generator(ckpt, cfg, "cpu")
    assert epoch == 20
    tr = Trainer(cfg, load_npz_dataset(npz), "cpu")
    ev = tr.evaluate(gen, n_gen_samples=8, noises=_jax_noises(
        777, tr.test_packed.n_chunks, 8, tr.test_packed.width, 8))
    for key in ("ade_avg", "fde_avg", "ade_min", "fde_min"):
        assert ev[key] == pytest.approx(want[key], rel=2e-3), key


def test_torch_cli_evaluate_and_linear_print_what_jax_prints(
        loo_ckpt, capsys, monkeypatch):
    npz, ckpt, jtr, _ = loo_ckpt
    args = ["evaluate", "--data", npz, "--model-file", ckpt,
            "--batch-size", str(BATCH), "--k", str(K)]
    assert jax_cli(["--cpu"] + args) == 0
    want = capsys.readouterr().out
    _feed(monkeypatch, _jax_noises(0, jtr.test_packed.n_chunks, K,
                                   jtr.test_packed.width, H // 2))
    assert torch_cli(["--cpu"] + args) == 0
    assert capsys.readouterr().out == want

    lin = ["evaluate", "--data", npz, "--linear", "cv"]
    assert jax_cli(["--cpu"] + lin) == 0
    want = capsys.readouterr().out
    assert torch_cli(["--cpu"] + lin) == 0
    assert capsys.readouterr().out == want
    assert "Linear baseline (cv)" in want


def test_torch_cli_predict_writes_what_jax_writes(loo_ckpt, tmp_path,
                                                  capsys, monkeypatch):
    npz, ckpt, _, _ = loo_ckpt
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    args = ["predict", "--data", npz, "--model-file", ckpt,
            "--batch-size", str(BATCH), "--k", str(K)]
    assert jax_cli(["--cpu"] + args + ["--out", out_j]) == 0
    n = np.load(npz)["obsvs"].shape[0]
    from socialways_torch.data.dataset import pack_scene_batches
    packed = pack_scene_batches(np.zeros((n, 8, 2), np.float32),
                                np.zeros((n, 12, 2), np.float32),
                                np.load(npz)["batches"], BATCH)
    _feed(monkeypatch, _jax_noises(0, packed.n_chunks, K, packed.width,
                                   H // 2))
    assert torch_cli(["--cpu"] + args + ["--out", out_t]) == 0
    dj, dt = np.load(out_j), np.load(out_t)
    assert sorted(dt.files) == sorted(dj.files) == sorted(
        ["obsvs", "preds_our", "preds_lnr", "epoch", "k"])
    ss = float(np.load(ckpt)["__scale__/sx"])
    for key in dj.files:           # world units: 1e-5 normalized = 1e-5/ss
        np.testing.assert_allclose(dt[key], dj[key], rtol=1e-4,
                                   atol=1e-5 / ss, err_msg=key)


def test_torch_generator_checkpoint_round_trip(tmp_path):
    cfg = TrainConfig(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                      **LOO)
    gen = init_generator(cfg, torch.Generator().manual_seed(5), "cpu")
    path = str(tmp_path / "g.npz")
    save_generator_checkpoint(path, gen, 11, cfg=cfg)
    saved = load_checkpoint_config(path)
    assert saved["agent_frame"] and saved["hidden_size"] == H
    assert any(k.startswith(".g_ema/['feat_mlp']/[2]")
               for k in np.load(path).files)

    warn = []
    stream = type("S", (), {"write": lambda self, s: warn.append(s)})()
    adopted = adopt_checkpoint_config(TrainConfig(hidden_size=32), path,
                                      warn_stream=stream)
    assert adopted.hidden_size == H and adopted.use_social
    assert "hidden_size" in "".join(warn)
    back, epoch, scale = restore_generator(path, adopted, "cpu")
    assert epoch == 11 and scale is None
    for a, b in zip(gen.parameters(), back.parameters()):
        assert torch.equal(a, b)

    # an FC generator under an LSTM-decoder config is refused by its
    # missing leaves; an LSTM-decoder generator round-trips
    lstm = str(tmp_path / "lstm.npz")
    save_generator_checkpoint(lstm, gen, 1, cfg=cfg.replace(decoder="lstm"))
    with pytest.raises(KeyError, match="dec_lstm"):
        restore_generator(lstm, adopt_checkpoint_config(TrainConfig(), lstm),
                          "cpu")
    lstm_cfg = cfg.replace(decoder="lstm")
    gen = init_generator(lstm_cfg, torch.Generator().manual_seed(6), "cpu")
    save_generator_checkpoint(lstm, gen, 2, cfg=lstm_cfg)
    back, epoch, _ = restore_generator(
        lstm, adopt_checkpoint_config(TrainConfig(), lstm), "cpu")
    assert epoch == 2 and hasattr(back, "dec_fc")
    for a, b in zip(gen.parameters(), back.parameters()):
        assert torch.equal(a, b)


def test_torch_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['socialways_tpu'] = None\n"
        "import socialways_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "socialways_torch.__path__, 'socialways_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'socialways_tpu'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 20


def test_torch_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    npz = str(tmp_path / "toy.npz")
    np.savez(npz, **make_toy_npz_arrays())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(hidden_size=16), load_npz_dataset(npz))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_generator(TrainConfig(hidden_size=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["evaluate", "--data", npz, "--linear"])
