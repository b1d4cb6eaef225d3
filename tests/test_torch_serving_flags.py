"""The serving command lines take JAX's whole model flag set and recipes.

A checkpoint without ``__config__`` (how a JAX checkpoint older than its
embedded config looks) is served by ``evaluate``, ``predict`` and
``simulate`` as the flags name it: JAX's command line for such a
checkpoint prints JAX's numbers in the port under JAX's per-chunk draws,
and the recipes serve a configless checkpoint as its configful twin.
``sweep`` takes every recipe.  Every subcommand's option set equals JAX's
but for the named deliberate differences.

Tolerances: ``evaluate``'s printout exactly (three decimals), ``predict``'s
arrays rtol 1e-4 / atol 1e-5 (float32 rollouts, as
test_torch_lstm_decoder.py); configless against configful bit for bit."""

import argparse
import dataclasses

import numpy as np
import jax
import pytest
import torch

from socialways_tpu.cli import main as jax_cli
from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.engine import losses as jlosses
from socialways_tpu.io.checkpoint import save_checkpoint as jax_save
from socialways_torch.cli import main as cli
from socialways_torch.config import SGAN_CONFIG_FIELDS, TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.engine.train_step import init_train_state
from socialways_torch.eval import metrics as tmetrics
from socialways_torch.io.checkpoint import save_checkpoint

H = 16
#: the structure flags of the configless checkpoint
STRUCTURE = ["--noise-dist", "gaussian", "--latent-code", "categorical",
             "--n-latent-codes", "3", "--decoder", "lstm", "--use-social"]
#: JAX options the port leaves out on purpose (ROADMAP.md, deliberate
#: deviations): eth-ucy's run of the upstream reference, which is not in the
#: repository, and simulate's XLA route, which the card does not have
DELIBERATE = {"eth-ucy": {"--compare-reference", "--ref-epochs"},
              "simulate": {"--no-pallas"}}
#: options the port adds to JAX's: Social GAN's widths on the commands that
#: serve it (``--model sgan``; JAX has no Social GAN)
_SGAN_WIDTHS = {"--embedding-dim", "--encoder-h-dim", "--decoder-h-dim",
                "--mlp-dim", "--bottleneck-dim", "--noise-dim"}
ADDED = {"evaluate": _SGAN_WIDTHS, "predict": _SGAN_WIDTHS,
         "simulate": _SGAN_WIDTHS}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serving") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays(n_per_batch=6))
    return path


def _jax_configless(toy, path):
    """A JAX training state of the STRUCTURE model saved without
    ``__config__``; returns the JAX config and trainer."""
    jcfg = JaxConfig(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                     batch_size=64, decoder="lstm", noise_dist="gaussian",
                     latent_code_type="categorical", n_latent_codes=3,
                     use_social=True)
    tr = JaxTrainer(jcfg, jax_load(toy))
    jax_save(path, tr.init_state(seed=2), 3, jax.random.PRNGKey(0),
             tr.dataset.scale, None)
    return jcfg, tr


def _jax_chunk_noises(jcfg, n_chunks, width, k, seed=0):
    """JAX's serving draws: one key a chunk from PRNGKey(seed), K noise
    draws from its split (socialways_tpu/eval/metrics.py:54-58)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)
    return iter([torch.from_numpy(np.array(jax.vmap(
        lambda kk: jlosses.sample_noise(kk, width, jcfg))(
        jax.random.split(key, k)))) for key in keys])


def _feed(monkeypatch, noises):
    monkeypatch.setattr(tmetrics, "draw_noise",
                        lambda k, n, cfg, generator=None, device=None:
                        next(noises).to(device))


def test_torch_configless_checkpoint_served_with_jax_structure_flags(
        toy, tmp_path, capsys, monkeypatch):
    """JAX's ``evaluate`` and ``predict`` command lines for a configless
    LSTM-decoder, gaussian, categorical checkpoint run unchanged in the
    port: the same printout, and the predict npz at rtol 1e-4 / atol 1e-5,
    under JAX's per-chunk draws."""
    ckpt = str(tmp_path / "configless.npz")
    jcfg, tr = _jax_configless(toy, ckpt)
    k = 4
    common = ["--model-file", ckpt, "--batch-size", "64", "--k", str(k),
              "--h-size", str(H)] + STRUCTURE
    evaluate = ["evaluate", "--data", toy] + common
    assert jax_cli.main(["--cpu"] + evaluate) == 0
    want = capsys.readouterr().out
    _feed(monkeypatch, _jax_chunk_noises(jcfg, tr.test_packed.n_chunks,
                                         tr.test_packed.width, k))
    assert cli.main(["--cpu"] + evaluate) == 0
    assert capsys.readouterr().out == want

    from socialways_tpu.data.dataset import pack_scene_batches
    with np.load(toy) as d:
        packed = pack_scene_batches(d["obsvs"], d["preds"], d["batches"], 64)
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = str(tmp_path / f"{name}.npz")
        if name == "port":
            _feed(monkeypatch, _jax_chunk_noises(jcfg, packed.n_chunks,
                                                 packed.width, k))
        assert main(["--cpu", "predict", "--data", toy, "--out", out]
                    + common) == 0
        with np.load(out) as f:
            outs[name] = {key: f[key] for key in f.files}
    assert sorted(outs["jax"]) == sorted(outs["port"])
    for key, want in outs["jax"].items():
        np.testing.assert_allclose(outs["port"][key], want, rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def _port_pair(toy, tmp_path, recipe):
    """A port training state of ``recipe``'s model at H = 16, saved with its
    config and without; returns the two paths."""
    argv = ["--cpu", "train", "--data", toy, "--recipe", recipe,
            "--h-size", str(H)]
    cfg = cli._train_cfg(cli.parse_args(argv))
    state = init_train_state(cfg, torch.Generator().manual_seed(5), "cpu")
    scale = load_npz_dataset(toy).scale
    paths = []
    for tag, saved_cfg in (("configful", cfg), ("configless", None)):
        path = str(tmp_path / tag / "ckpt.npz")
        save_checkpoint(path, state, 2, torch.Generator().manual_seed(0),
                        scale, saved_cfg)
        paths.append(path)
    return paths


@pytest.mark.parametrize("recipe", ["loo", "robust1"])
def test_torch_recipe_serves_a_configless_checkpoint_as_its_configful_twin(
        recipe, toy, tmp_path, capsys):
    """``evaluate --recipe R`` of the configless checkpoint prints what the
    configful one prints; without the recipe it serves another model."""
    configful, configless = _port_pair(toy, tmp_path, recipe)

    def served(path, *flags):
        argv = ["--cpu", "evaluate", "--data", toy, "--model-file", path,
                "--batch-size", "64", "--k", "4", "--h-size", str(H)]
        assert cli.main(argv + list(flags)) == 0
        return capsys.readouterr().out.replace(path, "CKPT")

    want = served(configful)
    assert served(configless, "--recipe", recipe) == want
    assert served(configful, "--recipe", recipe) == want
    assert served(configless) != want


def test_torch_simulate_configless_with_structure_flags_equals_configful(
        toy, tmp_path, capsys):
    """``simulate`` of the configless loo checkpoint with ``--recipe loo``
    writes the configful run's trajectories bit for bit."""
    trajectories = []
    for path, flags in zip(_port_pair(toy, tmp_path, "loo"),
                           ([], ["--recipe", "loo"])):
        out = path.replace(".npz", "-traj.npz")
        assert cli.main(["--cpu", "simulate", "--agents", "40", "--windows",
                         "1", "--h-size", str(H), "--model-file", path,
                         "--out", out] + flags) == 0
        with np.load(out) as f:
            trajectories.append(f["trajectories"])
    capsys.readouterr()
    np.testing.assert_array_equal(*trajectories)


@pytest.mark.parametrize("recipe", ["loo", "robust1", "toy-flagship"])
def test_torch_sweep_takes_every_recipe(recipe, capsys):
    """``sweep --recipe R`` parses (a bundle's own loop flags included) and
    builds JAX's config for the same command line."""
    argv = ["sweep", "--data", "x.npz", "--recipe", recipe, "--h-size", "32"]
    got = cli._train_cfg(cli.parse_args(["--cpu"] + argv))
    want = jax_cli._cfg_from_args(jax_cli.build_parser().parse_args(
        jax_cli._apply_recipe(argv)))
    for f in dataclasses.fields(TrainConfig):
        if f.name in SGAN_CONFIG_FIELDS:        # JAX has no Social GAN
            assert getattr(got, f.name) == getattr(TrainConfig(), f.name)
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert "NOTE" not in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--auto-recover"], ["--dump-dir", "d"],
                                  ["--metrics-log", "m.jsonl"]])
def test_torch_sweep_refuses_explicit_loop_outputs(flag, capsys):
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["sweep", "--data", "x.npz", "--recipe", "loo"]
                       + flag)
    assert e.value.code == 2 and flag[0] in capsys.readouterr().err


@pytest.mark.parametrize("command", ["evaluate", "predict", "simulate"])
def test_torch_serving_commands_note_the_loop_flags_they_ignore(command,
                                                                capsys):
    """A loop flag given on a serving command parses, as in JAX, and one
    NOTE on stderr names it; a recipe's own loop flags draw none."""
    head = {"evaluate": ["evaluate", "--data", "x.npz"],
            "predict": ["predict", "--data", "x.npz", "--model-file", "m"],
            "simulate": ["simulate"]}[command]
    args = cli.parse_args(head + ["--recipe", "robust1"])
    assert args.auto_recover and "NOTE" not in capsys.readouterr().err
    args = cli.parse_args(head + ["--recipe", "loo", "--track-coverage",
                                  "--ade-stall-grace", "4", "--epochs", "3"])
    err = capsys.readouterr().err
    assert args.track_coverage and args.ade_stall_grace == 4
    assert err.count("NOTE") == 1
    assert "--track-coverage" in err and "--ade-stall-grace" in err
    assert "--epochs" not in err


def _subparsers(ap):
    return next(a for a in ap._actions
                if isinstance(a, argparse._SubParsersAction)).choices


@pytest.mark.parametrize("command", sorted(_subparsers(
    jax_cli.build_parser())))
def test_torch_subcommand_options_equal_jax(command):
    """Each subcommand's option strings are JAX's, apart from
    ``DELIBERATE`` and the port's ``ADDED``; the port's own ``--lr-g`` /
    ``--lr-d`` aliases are gone."""
    want = {s for a in _subparsers(jax_cli.build_parser())[command]._actions
            for s in a.option_strings}
    got = {s for a in _subparsers(cli.build_parser())[command]._actions
           for s in a.option_strings}
    assert got == ((want - DELIBERATE.get(command, set()))
                   | ADDED.get(command, set()))
    assert not {"--lr-g", "--lr-d"} & got
