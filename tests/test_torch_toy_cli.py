"""The toy protocol through the port's CLI against socialways_tpu's: the
toy recipes token for token and the configs every flag bundle builds,
``cli train`` with dumps, metrics log, profiler trace and coverage
tracking, the coverage-stall and divergence rescues (with and without the
schedule clock kept), ``cli stats``'s printout and ``cli sweep``'s JSON.
Everything runs on the CPU at a toy width (hidden 16, batch 64, K 4)."""

import dataclasses
import json
import math
import os

import numpy as np
import jax
import pytest

from socialways_tpu.cli import main as jax_cli
from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.eval.metrics import EvalSums, finalize_eval
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.io.checkpoint import restore_checkpoint as jax_restore
from socialways_torch.cli import main as cli
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.engine.trainer import Trainer
from test_torch_toy_stats import write_dump_tree

H, BATCH, K = 16, 64, 4
SMALL = ["--h-size", str(H), "--batch-size", str(BATCH), "--k", str(K)]


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toycli") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays())
    return path


def jax_args(argv):
    return jax_cli.build_parser().parse_args(jax_cli._apply_recipe(argv))


@pytest.mark.parametrize("name", ["robust1", "inoise2", "toy-flagship",
                                  "loo"])
def test_torch_recipes_are_jax_bundles(name):
    assert cli.RECIPES[name] == jax_cli._RECIPES[name]


@pytest.mark.parametrize("argv", [
    ["--recipe", "robust1"],
    ["--recipe", "inoise2", "--unroll", "5"],
    ["--recipe", "toy-flagship", "--latent-code", "continuous",
     "--n-latent-codes", "2", "--no-info-loss"],
    ["--recipe", "loo", "--d-restore", "reference", "--info-weight", "0.2"],
    ["--lr-decay-rate", "0.5", "--lr-decay-steps", "7",
     "--lr-warmup-steps", "3", "--d-lr-warmup-steps", "9",
     "--unrolling-steps", "0"],
], ids=["robust1", "inoise2_unroll5", "flagship_continuous", "loo_reference",
        "schedules"])
def test_torch_train_flags_build_jax_config(argv, toy_npz):
    """Every field of the port's TrainConfig that ``train``'s flags set
    equals the JAX CLI's value for the same command line."""
    cmd = ["train", "--data", toy_npz, "--epochs", "7"] + argv
    want = jax_cli._cfg_from_args(jax_args(cmd))
    got = cli._train_cfg(cli.parse_args(["--cpu"] + cmd))
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("n_past", "n_next"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_torch_flagship_alias_expands_with_the_note(toy_npz, capsys):
    args = cli.parse_args(["train", "--data", toy_npz, "--recipe",
                           "flagship"])
    assert "--recipe flagship is deprecated" in capsys.readouterr().err
    assert (args.latent_code, args.use_social, args.auto_recover,
            args.d_lr_decay_steps) == ("categorical", True, True, 10000)


def test_torch_d_lr_decay_rate_without_steps_warns(toy_npz, capsys):
    cli._train_cfg(cli.parse_args(["train", "--data", toy_npz,
                                   "--d-lr-decay-rate", "0.5"]))
    assert "--d-lr-decay-rate is ignored" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--auto-recover"], ["--dump-dir", "d"], ["--track-coverage"],
    ["--recipe", "robust1"], ["--metrics-log", "x"]])
def test_torch_eth_ucy_refuses_train_loop_flags(argv, tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["eth-ucy", "--data-dir", str(tmp_path)] + argv)
    assert argv[0] in capsys.readouterr().err


def test_torch_eth_ucy_takes_the_gan_flags(tmp_path):
    args = cli.parse_args(["eth-ucy", "--data-dir", str(tmp_path),
                           "--unroll", "3", "--latent-code", "categorical",
                           "--n-latent-codes", "3", "--d-lr-decay-rate",
                           "0.7", "--d-lr-decay-steps", "100"])
    cfg = cli._train_cfg(args)
    assert (cfg.n_unrolling_steps, cfg.latent_code_type, cfg.n_latent_codes,
            cfg.d_lr_decay_steps, cfg.agent_frame) == (
        3, "categorical", 3, 100, True)


def _train(toy_npz, tmp_path, *extra):
    mdir = str(tmp_path / "models")
    argv = ["--cpu", "train", "--recipe", "toy-flagship", "--data", toy_npz,
            "--model-dir", mdir] + SMALL + list(extra)
    assert cli.main(argv) == 0
    return mdir


def test_torch_cli_train_writes_dumps_log_trace_and_bestcov(toy_npz,
                                                            tmp_path,
                                                            capsys):
    dump, log, prof = (str(tmp_path / n) for n in ("dumps", "log", "prof"))
    mdir = _train(toy_npz, tmp_path, "--epochs", "4", "--test-interval", "2",
                  "--dump-dir", dump, "--metrics-log", log, "--profile-dir",
                  prof, "--track-coverage", "--lnr-model", "kalman")
    out = capsys.readouterr().out
    assert f"wrote profiler trace to {prof}" in out
    assert out.count("mode coverage = ") == 2
    # one dump per eval epoch, in JAX's schema
    root = os.path.join(dump, "hotel", "socialWays")
    assert sorted(os.listdir(root)) == ["2", "4"]
    for e in ("2", "4"):
        (f,) = os.listdir(os.path.join(root, e))
        assert f.startswith(f"{e}-") and f.endswith(".npz")
        with np.load(os.path.join(root, e, f)) as d:
            assert sorted(d.files) == ["obsvs", "preds_gtt", "preds_lnr",
                                       "preds_our", "timestamp"]
            n = d["obsvs"].shape[0]
            assert d["obsvs"].shape == (n, 2, 2)
            assert d["preds_our"].shape == (K, n, 2, 2)
            assert d["preds_gtt"].shape == d["preds_lnr"].shape == (n, 2, 2)
            assert all(np.isfinite(d[k]).all() for k in d.files)
    with open(log) as fh:
        recs = [json.loads(line) for line in fh]
    assert [(r["kind"], r["epoch"]) for r in recs] == [
        ("train", 1), ("train", 2), ("eval", 2), ("coverage", 2),
        ("train", 3), ("train", 4), ("eval", 4), ("coverage", 4)]
    assert all(0.0 <= r["coverage"] <= 1.0 for r in recs
               if r["kind"] == "coverage")
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as fh:
        assert json.load(fh)["traceEvents"]
    for name in ("", "-best", "-bestcov"):
        assert os.path.isfile(os.path.join(mdir,
                                           f"socialWays-hotel{name}.npz"))
    # the final checkpoint, categorical and with D's schedule, loads in JAX
    jcfg = jax_cli._cfg_from_args(jax_args(
        ["train", "--data", toy_npz, "--recipe", "toy-flagship"] + SMALL))
    template = JaxTrainer(jcfg, jax_load(toy_npz)).init_state()
    jstate, epoch, _, _ = jax_restore(
        os.path.join(mdir, "socialWays-hotel.npz"), template)
    flat = _flatten(jax.device_get(jstate))
    assert epoch == 4 and int(flat[".d_opt/[1]/.count"]) == int(
        flat[".d_opt/[0]/.count"]) > 0


def test_torch_coverage_stall_restores_bestcov_with_fresh_d(
        toy_npz, tmp_path, capsys, monkeypatch):
    covs = iter([0.5, 0.2, 0.2, 0.6, 0.3])
    monkeypatch.setattr(cli, "_coverage", lambda *a, **k: next(covs))
    inits = []
    import socialways_torch.engine.rescue as rescue
    orig = rescue.reinit_discriminator
    monkeypatch.setattr(rescue, "reinit_discriminator",
                        lambda *a, **k: inits.append(1) or orig(*a, **k))
    _train(toy_npz, tmp_path, "--epochs", "5", "--test-interval", "1",
           "--track-coverage", "--stall-recover", "2", "--stall-reset-d")
    out = capsys.readouterr().out
    assert ("coverage STALLED at epoch 3 (0.20 < best 0.50); restored "
            "best-coverage checkpoint from epoch 1 with a RE-INITIALIZED "
            "discriminator, continuing on a fresh stream") in out, out
    assert inits == [1] and "Epc=   5" in out
    assert out.count("new best coverage saved") == 2


@pytest.mark.parametrize("keep_clock", [False, True])
def test_torch_divergence_restores_best_under_auto_recover(
        keep_clock, toy_npz, tmp_path, capsys, monkeypatch):
    """A NaN train ADE at epoch 3 restores the pre-training ``-best``
    baseline; with --rescue-keep-clock the optimizer counts go on from the
    diverged state instead of rewinding to 0."""
    orig = Trainer.train_epoch
    calls = []

    def train_epoch(self, state, *a, **k):
        state, m = orig(self, state, *a, **k)
        calls.append(1)
        if len(calls) == 3:
            m = dict(m, train_ade=math.nan)
        return state, m
    monkeypatch.setattr(Trainer, "train_epoch", train_epoch)
    mdir = _train(toy_npz, tmp_path, "--epochs", "4", "--test-interval",
                  "10", *(["--rescue-keep-clock"] if keep_clock else []))
    out = capsys.readouterr().out
    assert ("DIVERGED at epoch 3 (ADE nan); restored best checkpoint from "
            "epoch 0") in out, out
    with np.load(os.path.join(mdir, "socialWays-hotel.npz")) as d:
        g_count, d_sched = int(d[".g_opt/[0]/.count"]), int(
            d[".d_opt/[1]/.count"])
    steps = Trainer(TrainConfig(batch_size=BATCH), load_npz_dataset(toy_npz),
                    "cpu").n_steps_per_epoch
    epochs_counted = 4 if keep_clock else 1
    assert g_count == epochs_counted * steps
    assert d_sched == 2 * epochs_counted * steps


def test_torch_cli_stats_prints_jax_numbers(tmp_path, capsys):
    tree = str(tmp_path / "dumps")
    write_dump_tree(tree, 3, epochs=(2, 4, 6))
    real = str(tmp_path / "real.npz")
    rng = np.random.RandomState(4)
    np.savez(real, obsvs=rng.randn(240, 2, 2), preds=rng.randn(240, 2, 2),
             times=np.arange(240), batches=np.array([[0, 240]]))
    argv = ["stats", "--preds-dir", tree, "--real-npz", real, "--group", "8"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    os.remove(os.path.join(tree, "stats20.npz"))
    assert cli.main(argv) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 4
    assert got[0].startswith("epoch = 2, EMD = ")
    assert os.path.isfile(os.path.join(tree, "stats20.npz"))


def test_torch_cli_sweep_writes_jax_keys(toy_npz, tmp_path, capsys):
    out_json = str(tmp_path / "sweep.json")
    assert cli.main(["--cpu", "sweep", "--data", toy_npz, "--unrolls", "0,1",
                     "--info-weights", "0.0,0.5", "--sweep-epochs", "1",
                     "--coverage-k", "8", "--out-json", out_json]
                    + SMALL) == 0
    with open(out_json) as fh:
        res = json.load(fh)
    assert list(res) == [f"unroll{u}-info{w}" for u in (0, 1)
                         for w in (0.0, 0.5)]
    fields = set(finalize_eval(EvalSums(*[1.0] * 5), 1.0, 1)) | {
        "mode_coverage", "final_train_ade"}
    for r in res.values():
        assert set(r) == fields
        assert 0.0 <= r["mode_coverage"] <= 1.0
        assert all(math.isfinite(v) for v in r.values())
    out = capsys.readouterr().out
    assert out.count("ADE/FDE min-4 = ") == 4 and "best coverage: " in out


def test_torch_jax_config_has_every_port_field():
    """The port's TrainConfig is a subset of JAX's, default for default."""
    for f in dataclasses.fields(TrainConfig):
        assert getattr(JaxConfig(), f.name) == getattr(TrainConfig(), f.name)


def test_torch_step_timer_summarizes_as_jax():
    from socialways_tpu.utils.profiling import StepTimer as JaxStepTimer
    from socialways_torch.utils.profiling import StepTimer
    times = list(np.random.RandomState(2).rand(17))
    got, want = StepTimer(), JaxStepTimer()
    got.times, want.times = list(times), list(times)
    assert got.summary() == want.summary()
    with got:
        pass
    assert len(got.times) == 18 and got.times[-1] >= 0.0
    assert StepTimer().summary() == {}
