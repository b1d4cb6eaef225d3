"""The ``gan_step`` variant flags through the port's CLI against
socialways_tpu's: every new flag, alone with each recipe and all together,
builds JAX's config for ``train``, ``eth-ucy`` and ``sweep``; and a short
``--cpu train`` with the LSTM decoder, PacGAN, minibatch stddev and
gradient accumulation writes a checkpoint that JAX's
``restore_checkpoint`` reads, and resumes from one JAX wrote.  Everything
runs on the CPU at a toy width (hidden 16, batch 64, K 4)."""

import dataclasses
import os

import numpy as np
import jax
import pytest

from socialways_tpu.cli import main as jax_cli
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.io.checkpoint import restore_checkpoint as jax_restore
from socialways_tpu.io.checkpoint import save_checkpoint as jax_save
from socialways_torch.cli import main as cli
from socialways_torch.config import SGAN_CONFIG_FIELDS, TrainConfig
from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                            flatten_state,
                                            load_checkpoint_config,
                                            restore_checkpoint)

H, BATCH, K = 16, 64, 4
SMALL = ["--h-size", str(H), "--batch-size", str(BATCH), "--k", str(K)]

#: every flag this slice adds, each at a value other than its default
NEW_FLAGS = [
    ["--decoder", "lstm"], ["--noise-dist", "gaussian"], ["--use-l2-loss"],
    ["--use-variety-loss"], ["--l2-weight", "0.3"], ["--r1-gamma", "0.5"],
    ["--pac", "2"], ["--spectral-norm"], ["--mb-std"], ["--ms-weight", "0.2"],
    ["--ds-weight", "0.3"], ["--ds-tau", "0.7"], ["--ds-k", "4"],
    ["--info-weight-end", "1.5"], ["--info-weight-steps", "40"],
    ["--d-update-every", "2"], ["--d-update-every-end", "3"],
    ["--d-update-every-switch", "9"], ["--grad-clip", "1.0"],
    ["--serial-rollout"], ["--remat-steps"], ["--grad-accum", "2"]]
ALL_NEW = [tok for flag in NEW_FLAGS for tok in flag]


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gancli") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays(n_per_batch=6))
    return path


def _same_config(cmd):
    """The port's and JAX's configs for ``cmd`` agree on every port
    field."""
    want = jax_cli._cfg_from_args(jax_cli.build_parser().parse_args(
        jax_cli._apply_recipe(cmd)))
    got = cli._train_cfg(cli.parse_args(["--cpu"] + cmd))
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("n_past", "n_next"):
            continue
        if f.name in SGAN_CONFIG_FIELDS:        # JAX has no Social GAN
            assert getattr(got, f.name) == getattr(TrainConfig(), f.name)
            continue
        assert getattr(got, f.name) == getattr(want, f.name), (f.name, cmd)
    return got


@pytest.mark.parametrize("recipe", ["", "robust1", "inoise2",
                                    "toy-flagship", "loo"])
def test_torch_new_flags_build_jax_config_with_each_recipe(recipe, toy_npz):
    head = ["train", "--data", toy_npz, "--epochs", "7"]
    if recipe:
        head += ["--recipe", recipe]
    for flag in NEW_FLAGS:
        _same_config(head + flag)
    cfg = _same_config(head + ALL_NEW)
    assert (cfg.decoder, cfg.pac, cfg.grad_accum, cfg.ds_k) == (
        "lstm", 2, 2, 4)


@pytest.mark.parametrize("command", ["eth-ucy", "sweep"])
def test_torch_eth_ucy_and_sweep_take_the_new_flags(command, toy_npz,
                                                    tmp_path):
    head = ([command, "--data-dir", str(tmp_path), "--recipe", "loo"]
            if command == "eth-ucy" else [command, "--data", toy_npz])
    cfg = _same_config(head + ALL_NEW)
    assert cfg.mb_std and cfg.spectral_norm and cfg.remat_steps


#: the short run: LSTM decoder, packs of 2, the mb_std input, A = 2
RUN = ["--decoder", "lstm", "--pac", "2", "--mb-std", "--grad-accum", "2"]


def _jax_trainer(toy_npz, argv):
    jcfg = jax_cli._cfg_from_args(jax_cli.build_parser().parse_args(argv))
    return JaxTrainer(jcfg, jax_load(toy_npz))


def test_torch_cli_variant_checkpoints_load_both_ways(toy_npz, tmp_path,
                                                      capsys):
    mdir = str(tmp_path / "port")
    cmd = ["train", "--data", toy_npz, "--epochs", "2", "--test-interval",
           "1", "--save-interval", "1", "--model-dir", mdir] + SMALL + RUN
    assert cli.main(["--cpu"] + cmd) == 0
    ckpt = os.path.join(mdir, "socialWays-hotel.npz")
    saved = load_checkpoint_config(ckpt)
    assert (saved["decoder"], saved["pac"], saved["mb_std"]) == (
        "lstm", 2, True)
    # JAX restores the port's run into the template its own CLI builds
    jtr = _jax_trainer(toy_npz, cmd)
    jstate, epoch, _, _ = jax_restore(ckpt, jtr.init_state(seed=0))
    tcfg = adopt_checkpoint_config(
        cli._train_cfg(cli.parse_args(["--cpu"] + cmd)), ckpt)
    want = flatten_state(restore_checkpoint(ckpt, tcfg, "cpu")[0])
    got = _flatten(jax.device_get(jstate))
    assert epoch == 2 and sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)
    assert int(got[".g_opt/[0]/.count"]) == 2 * jtr.n_steps_per_epoch

    # and the port resumes a JAX checkpoint of the same run
    jdir = str(tmp_path / "jax")
    jsave = os.path.join(jdir, "socialWays-hotel.npz")
    jax_save(jsave, jstate, 2, jax.random.PRNGKey(0), jtr.dataset.scale,
             jtr.cfg)
    capsys.readouterr()
    jcmd = [a if a != mdir else jdir for a in cmd]
    jcmd[jcmd.index("--epochs") + 1] = "3"
    assert cli.main(["--cpu"] + jcmd) == 0
    assert f"resumed from {jsave} at epoch 2" in capsys.readouterr().out
    state = restore_checkpoint(jsave, tcfg, "cpu")[0]
    assert state.g_opt.count == 3 * jtr.n_steps_per_epoch
    assert hasattr(state.g, "dec_lstm")
    assert tuple(state.d.classifier[0].w.shape) == ((H + 1) * 2, H // 2)
