"""``simulate`` and ``--max-scene-size`` through the port's CLI against
socialways_tpu's: the initial crowd is JAX's construction bit for bit, a
checkpoint's own horizons are kept (n_past 4 / n_next 3 simulates W x 3
steps), the trajectories are the library's under the CLI's draws,
``--no-pallas`` is refused, a run without ``--cpu`` on a machine with no
GPU raises, and ``--max-scene-size`` builds JAX's config on every
subcommand that takes it.  Everything runs on the CPU at hidden 16."""

import dataclasses

import numpy as np
import pytest
import torch

from socialways_tpu.cli import main as jax_cli
from socialways_torch.cli import main as cli
from socialways_torch.config import TrainConfig
from socialways_torch.engine import simulate as tsim
from socialways_torch.io.checkpoint import save_generator_checkpoint
from socialways_torch.models.generator import init_generator
from test_torch_gan_cli import _same_config

H = 16


def _capture_sim(monkeypatch, module, result):
    """Replace ``module.make_crowd_sim`` by a recorder of the simulator's
    inputs that returns ``result(n, windows)``."""
    seen = {}

    def make(cfg, n_windows):
        def run(params, obsv0, scene_ids, *rest):
            seen.update(obsv0=np.asarray(obsv0), ids=np.asarray(scene_ids),
                        cfg=cfg)
            return result(len(seen["ids"]), n_windows * cfg.n_next)
        return run

    monkeypatch.setattr(module, "make_crowd_sim", make)
    return seen


@pytest.mark.parametrize("agents,scene,seed", [(50, 7, 3), (64, 16, 0)])
def test_torch_simulate_initial_crowd_is_jax_construction(
        agents, scene, seed, monkeypatch, capsys):
    """The crowd both CLIs hand their simulator: grid base + a cumulative
    random walk from ``RandomState(seed)``, ids ``arange(n) // scene``,
    equal bits; the scene size is the attention's max_scene in both."""
    import jax.numpy as jnp
    from socialways_tpu.engine import simulate as jsim
    flags = ["--agents", str(agents), "--scene-size", str(scene),
             "--windows", "1", "--seed", str(seed), "--h-size", str(H)]
    want = _capture_sim(monkeypatch, jsim,
                        lambda n, t: jnp.zeros((n, t, 2), jnp.float32))
    assert jax_cli.main(["simulate"] + flags) == 0
    got = _capture_sim(monkeypatch, tsim,
                       lambda n, t: torch.zeros((n, t, 2)))
    assert cli.main(["--cpu", "simulate"] + flags) == 0
    assert got["obsv0"].dtype == want["obsv0"].dtype == np.float32
    np.testing.assert_array_equal(got["obsv0"], want["obsv0"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["ids"].dtype == np.int32
    assert got["cfg"].max_scene_size == want["cfg"].max_scene_size == scene
    assert got["cfg"].use_social and want["cfg"].use_social
    ref_obsv, ref_ids = tsim.initial_crowd(agents, scene, 8, seed)
    np.testing.assert_array_equal(ref_obsv, want["obsv0"])
    np.testing.assert_array_equal(ref_ids, want["ids"])
    assert "route=cpu" in capsys.readouterr().out


def test_torch_simulate_keeps_checkpoint_horizons(tmp_path, capsys):
    """A checkpoint trained at n_past 4 / n_next 3 simulates W x 3 steps
    from 4-step observations (JAX forces 8 / 12 and fails to restore it),
    and the written trajectories are ``crowd_simulate``'s under the CLI's
    timed draw (a CPU ``torch.Generator`` seeded 2)."""
    cfg = TrainConfig(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                      n_past=4, n_next=3, use_social=True, agent_frame=True)
    gen = init_generator(cfg, torch.Generator().manual_seed(5), "cpu")
    ckpt, out = str(tmp_path / "short.npz"), str(tmp_path / "traj.npz")
    save_generator_checkpoint(ckpt, gen, 7, cfg=cfg)
    assert cli.main(["--cpu", "simulate", "--agents", "40", "--scene-size",
                     "8", "--windows", "2", "--model-file", ckpt, "--out",
                     out]) == 0
    assert "simulated 40 agents x 6 steps" in capsys.readouterr().out
    with np.load(out) as d:
        traj = d["trajectories"]
    assert traj.shape == (40, 6, 2) and np.isfinite(traj).all()
    obsv0, ids = tsim.initial_crowd(40, 8, 4, cfg.seed)
    run_cfg = cfg.replace(max_scene_size=8)
    noise = tsim.sample_noise((2, 40), run_cfg,
                              torch.Generator().manual_seed(2))
    want = tsim.crowd_simulate(gen, torch.from_numpy(obsv0),
                               torch.from_numpy(ids), 2, run_cfg,
                               noise=noise)
    np.testing.assert_array_equal(traj, want.numpy())


def test_torch_simulate_refuses_no_pallas(capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--cpu", "simulate", "--no-pallas"])
    assert "--no-pallas" in capsys.readouterr().err
    # JAX's simulate takes it
    jax_cli.build_parser().parse_args(["simulate", "--no-pallas"])


def test_torch_simulate_without_cpu_and_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["simulate", "--agents", "8", "--windows", "1"])


@pytest.mark.parametrize("command", ["train", "eth-ucy", "sweep"])
def test_torch_max_scene_size_builds_jax_config(command, tmp_path):
    """``--max-scene-size`` on train (alone and with the loo recipe),
    eth-ucy and sweep gives JAX's config field for field."""
    data = str(tmp_path / "x.npz")
    head = {"train": ["train", "--data", data],
            "eth-ucy": ["eth-ucy", "--data-dir", str(tmp_path)],
            "sweep": ["sweep", "--data", data]}[command]
    cfg = _same_config(head + ["--max-scene-size", "16"])
    assert cfg.max_scene_size == 16
    if command == "train":
        cfg = _same_config(head + ["--recipe", "loo", "--max-scene-size",
                                   "12", "--use-social"])
        assert cfg.max_scene_size == 12 and cfg.use_social


@pytest.mark.parametrize("command", ["evaluate", "predict"])
def test_torch_max_scene_size_on_serving_commands(command):
    """evaluate and predict take the flag and build JAX's model config."""
    argv = [command, "--data", "x.npz", "--model-file", "m.npz",
            "--max-scene-size", "9", "--use-social", "--h-size", str(H)]
    want = jax_cli._cfg_from_args(jax_cli.build_parser().parse_args(argv))
    got = cli._cfg_from_args(cli.parse_args(["--cpu"] + argv))
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("batch_size", "hidden_size", "social_feature_size",
                      "noise_len", "use_social", "agent_frame",
                      "g_ema_decay", "seed", "n_gen_samples",
                      "max_scene_size"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.max_scene_size == 9
