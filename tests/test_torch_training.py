"""The port's training loop against socialways_tpu: ``Trainer.train_epoch``
under JAX's per-chunk draws, the -1 anneal sentinel, ``StallTracker``,
``reinit_discriminator``, full-state checkpoints both ways, the port's own
resume, and ``cli train --recipe loo``.

Tolerances as in test_torch_train_step.py: f32 rtol 1e-4 / atol 1e-5 on
metrics; parameters and moments after Adam steps at atol 1e-5 plus 1e-3
times the leaf's scale."""

import numpy as np
import jax
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.engine.rescue import StallTracker as JaxStallTracker
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.io.checkpoint import restore_checkpoint as jax_restore
from socialways_tpu.io.checkpoint import save_checkpoint as jax_save
from socialways_torch.cli.main import main as torch_cli
from socialways_torch.cli.main import parse_args
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.engine.rescue import (StallTracker,
                                            reinit_discriminator)
from socialways_torch.engine.trainer import Trainer
from socialways_torch.io.checkpoint import (flatten_state,
                                            restore_checkpoint,
                                            save_checkpoint,
                                            train_state_from_jax)
from test_torch_train_step import assert_state_close, jax_draws

H, BATCH = 16, 64
LOO = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
           batch_size=BATCH, agent_frame=True, use_social=True,
           g_ema_decay=0.999, d_input_noise=0.05, d_input_noise_steps=-1,
           d_input_noise_floor=0.02, n_epochs=4)


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("training") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays(n_per_batch=6))
    return path


@pytest.fixture(scope="module")
def jax_epoch(toy_npz, tmp_path_factory):
    """A JAX checkpoint of an initial loo state, and one JAX epoch from it
    (the epoch scan compiles once)."""
    jtr = JaxTrainer(JaxConfig(**LOO), jax_load(toy_npz))
    state0 = jtr.init_state(seed=3)
    ckpt = str(tmp_path_factory.mktemp("jaxckpt") / "init.npz")
    jax_save(ckpt, state0, 0, jax.random.PRNGKey(0), jtr.dataset.scale,
             jtr.cfg)
    rng = jax.random.PRNGKey(21)
    state1, metrics = jtr.train_epoch(state0, rng)
    return jtr, ckpt, jax.device_get(state0), rng, jax.device_get(state1), \
        metrics


def _port_trainer(toy_npz, **kw):
    return Trainer(TrainConfig(**dict(LOO, **kw)), load_npz_dataset(toy_npz),
                   "cpu")


def test_torch_anneal_sentinel_resolves_as_jax(jax_epoch, toy_npz):
    jtr = jax_epoch[0]
    tr = _port_trainer(toy_npz)
    assert tr.n_steps_per_epoch == jtr.n_steps_per_epoch
    assert tr.cfg.d_input_noise_steps == jtr.cfg.d_input_noise_steps == \
        LOO["n_epochs"] * tr.n_steps_per_epoch
    assert _port_trainer(toy_npz, d_input_noise_steps=7).cfg \
        .d_input_noise_steps == 7


def test_torch_trainer_packs_the_training_split_on_first_use(toy_npz):
    tr = _port_trainer(toy_npz, d_input_noise_steps=0)
    tr.evaluate(tr.init_state(seed=0).g)
    assert "train_packed" not in vars(tr) and "train_dev" not in vars(tr)
    assert tr.n_steps_per_epoch == tr.train_packed.n_chunks > 0
    assert "train_dev" not in vars(tr)
    assert tr.train_dev["obsvs"].shape[0] == tr.n_steps_per_epoch


def test_torch_train_epoch_from_jax_checkpoint_matches_jax(jax_epoch,
                                                           toy_npz):
    """A JAX checkpoint restores in the port, and one port epoch from it,
    fed JAX's per-chunk draws, gives JAX's metrics and state."""
    jtr, ckpt, state0, rng, state1, want = jax_epoch
    tr = _port_trainer(toy_npz)
    state, epoch, port_rng, scale = restore_checkpoint(ckpt, tr.cfg, "cpu")
    assert epoch == 0 and port_rng is None
    assert scale.sx == pytest.approx(jtr.dataset.ss)
    bridged = flatten_state(train_state_from_jax(state0, tr.cfg, "cpu"))
    for k, v in flatten_state(state).items():
        np.testing.assert_array_equal(v, bridged[k], err_msg=k)
    keys = jax.random.split(rng, tr.n_steps_per_epoch)
    draws = [jax_draws(k, tr.train_packed.width, tr.cfg) for k in keys]
    state, got = tr.train_epoch(state, draws=draws)
    assert_state_close(state, state1, tag="epoch")
    for name in ("d_loss", "g_loss", "train_ade", "train_fde"):
        assert got[name] == pytest.approx(want[name], rel=1e-4, abs=1e-5), \
            name
    assert got["steps"] == want["steps"] == tr.n_steps_per_epoch


def test_torch_checkpoint_loads_in_jax(jax_epoch, toy_npz, tmp_path):
    jtr = jax_epoch[0]
    tr = _port_trainer(toy_npz)
    state = tr.init_state(seed=5)
    rng = torch.Generator().manual_seed(9)
    state, _ = tr.train_epoch(state, rng)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, state, 3, rng, tr.dataset.scale, tr.cfg)
    template = jtr.init_state(seed=0)
    jstate, epoch, _, scale = jax_restore(path, template)
    assert epoch == 3 and scale.sx == pytest.approx(tr.dataset.ss)
    want = flatten_state(state)
    got = _flatten(jax.device_get(jstate))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert int(got[".g_opt/[0]/.count"]) == tr.n_steps_per_epoch
    assert int(got[".d_opt/[0]/.count"]) == 2 * tr.n_steps_per_epoch


def test_torch_resume_continues_the_run_identically(toy_npz, tmp_path):
    """2 epochs straight == 1 epoch + save + restore + 1 epoch, the random
    stream included."""
    tr = _port_trainer(toy_npz)
    a = tr.init_state(seed=1)
    rng_a = torch.Generator().manual_seed(4)
    a, m_a = tr.train_epochs(a, rng_a, 2)
    assert m_a["steps"] == 2 * tr.n_steps_per_epoch

    b = tr.init_state(seed=1)
    rng_b = torch.Generator().manual_seed(4)
    b, m_1 = tr.train_epochs(b, rng_b, 1)
    assert m_1["steps"] == tr.n_steps_per_epoch
    path = str(tmp_path / "mid.npz")
    save_checkpoint(path, b, 1, rng_b, tr.dataset.scale, tr.cfg)
    b, epoch, rng_state, _ = restore_checkpoint(path, tr.cfg, "cpu")
    assert epoch == 1 and rng_state[0] == "cpu"
    rng_c = torch.Generator().manual_seed(0)
    rng_c.set_state(rng_state[1])
    b, m_b = tr.train_epoch(b, rng_c)
    fa, fb = flatten_state(a), flatten_state(b)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    for k in ("d_loss", "g_loss", "train_ade", "train_fde"):
        assert m_a[k] == m_b[k]


def _tracker_trace(cls, seq, **kw):
    t = cls(**kw)
    out = []
    for i, (ade, avg, train) in enumerate(seq):
        fire = t.observe(ade, ade_avg=avg, train_ade=train)
        out.append((fire, t.stall, t.grace, t.signature_hits,
                     t.last_signature, t.last_trigger))
        if fire:
            out.append(("fired", t.fired(min(a for a, _, _ in seq[:i + 1]),
                                         at_epoch=i)))
    return out, (t.rescues, t.fired_early, t.ineffective, t.bar)


@pytest.mark.parametrize("kw", [
    dict(patience=3),
    dict(patience=2, grace=1, max_rescues=1),
    dict(patience=-1, classify_patience=2),
    dict(patience=0, classify_patience=3, grace=2, max_rescues=2),
    dict(patience=4, classify_patience=2, classify_ratio=2.0),
])
def test_torch_stall_tracker_decides_as_jax(kw):
    rng = np.random.RandomState(len(str(kw)))
    seq = []
    ade = 1.0
    for i in range(60):
        if rng.rand() < 0.2:
            ade *= rng.uniform(0.8, 0.97)      # an improvement
        kind = i // 15 % 3                     # under-fit, collapse, neither
        avg = ade * (3.5 if kind == 0 else 1.1 if kind == 1 else 2.0)
        seq.append((ade * rng.uniform(1.0, 1.01), avg, avg * 0.9))
    assert _tracker_trace(StallTracker, seq, **kw) == \
        _tracker_trace(JaxStallTracker, seq, **kw)


def test_torch_reinit_discriminator_keeps_the_generator(toy_npz):
    tr = _port_trainer(toy_npz)
    state, _ = tr.train_epoch(tr.init_state(seed=2),
                              torch.Generator().manual_seed(3))
    before = flatten_state(state)
    new = reinit_discriminator(state, tr.cfg, torch.Generator().manual_seed(8))
    after = flatten_state(new)
    for k in before:
        if k.startswith((".g_params/", ".g_ema/", ".g_opt/")):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert new.d_opt.count == 0 and state.d_opt.count > 0
    assert not np.array_equal(after[".d_params/['obsv_lstm']/['w']"],
                              before[".d_params/['obsv_lstm']/['w']"])
    assert all(not v.any() for k, v in after.items()
               if k.startswith(".d_opt/[0]/.mu"))
    m = tr.train_epoch(new, torch.Generator().manual_seed(1))[1]
    assert np.isfinite(m["d_loss"]) and np.isfinite(m["train_ade"])


def test_torch_cli_train_recipe_loo_then_evaluate(toy_npz, tmp_path,
                                                  capsys):
    args = ["--cpu", "train", "--recipe", "loo", "--data", toy_npz,
            "--epochs", "2", "--test-interval", "1", "--save-interval", "1",
            "--model-dir", str(tmp_path), "--h-size", str(H),
            "--batch-size", str(BATCH), "--k", "4"]
    assert torch_cli(args) == 0
    out = capsys.readouterr().out
    assert "instance-noise anneal over the full run:" in out
    assert "Epc=   2" in out and "new best (ADE" in out
    final = tmp_path / "socialWays-hotel.npz"
    assert final.exists() and (tmp_path / "socialWays-hotel-best.npz").exists()
    # a third epoch resumes from the final checkpoint
    assert args[6:8] == ["--epochs", "2"]
    assert torch_cli(args[:7] + ["3"] + args[8:]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {final} at epoch 2" in out and "Epc=   3" in out
    assert torch_cli(["--cpu", "evaluate", "--data", toy_npz,
                      "--model-file", str(final), "--k", "4",
                      "--batch-size", str(BATCH)]) == 0
    assert "loaded" in capsys.readouterr().out


@pytest.mark.parametrize("flags,avg,trigger", [
    (["--ade-stall-recover", "2", "--ade-stall-classify", "0"], 4.0,
     "unimproved for 2 evals"),
    (["--ade-stall-recover", "-1", "--ade-stall-classify", "2"], 1.1,
     "collapse signature matched for 2 evals")])
def test_torch_cli_stall_rescue_restores_best_with_fresh_d(
        flags, avg, trigger, toy_npz, tmp_path, capsys, monkeypatch):
    """A flat eval ADE fires the rescue (patience, or the gated
    diversity-collapse signature): the best checkpoint comes back with a
    re-initialized discriminator, and training goes on."""
    flat = {"ade_avg": avg, "fde_avg": 2 * avg, "ade_min": 1.0,
            "fde_min": 2.0}
    monkeypatch.setattr(Trainer, "evaluate", lambda self, *a, **k: flat)
    inits = []
    import socialways_torch.engine.rescue as rescue
    orig = rescue.reinit_discriminator
    monkeypatch.setattr(rescue, "reinit_discriminator",
                        lambda *a, **k: inits.append(1) or orig(*a, **k))
    assert torch_cli(["--cpu", "train", "--recipe", "loo", "--data", toy_npz,
                      "--epochs", "5", "--test-interval", "1",
                      "--save-interval", "5", "--model-dir", str(tmp_path),
                      "--h-size", str(H), "--batch-size", str(BATCH),
                      "--k", "4"] + flags) == 0
    out = capsys.readouterr().out
    assert (f"ADE STALLED at epoch 3 (best 1.000, {trigger}); restored best "
            f"checkpoint from epoch 1 with a RE-INITIALIZED discriminator"
            in out), out
    assert inits == [1] and "Epc=   5" in out


def test_torch_cli_recipe_expands_and_explicit_flags_override(toy_npz):
    args = parse_args(["--cpu", "train", "--data", toy_npz,
                       "--g-ema-decay", "0.5", "--recipe", "loo"])
    assert (args.agent_frame, args.use_social, args.g_ema_decay,
            args.d_input_noise_steps, args.ade_stall_classify) == (
        True, True, 0.5, -1, 5)
    with pytest.raises(SystemExit):
        parse_args(["train", "--data", toy_npz, "--recipe", "robust9"])


#: flags once refused and ported now: their argv and the field they set
PORTED_FLAGS = {"--grad-clip": (["--grad-clip", "1"], "grad_clip", 1.0),
                "--pac": (["--pac", "2"], "pac", 2),
                "--spectral-norm": (["--spectral-norm"], "spectral_norm",
                                    True),
                "--mb-std": (["--mb-std"], "mb_std", True),
                "--grad-accum": (["--grad-accum", "2"], "grad_accum", 2),
                "--bf16": (["--bf16"], "compute_dtype", "bfloat16"),
                "--pallas": (["--pallas"], "use_pallas", True)}


@pytest.mark.parametrize("flag", ["--grad-clip", "--pallas", "--bf16",
                                  "--pac", "--spectral-norm", "--mb-std",
                                  "--grad-accum"])
def test_torch_cli_refuses_unported_training_flags(flag, toy_npz, capsys):
    """Every flag here is ported now and sets its field (``--pallas``,
    JAX's loop flag, since the loop flags were ported); an unported one
    would be refused, naming the flag."""
    if flag in PORTED_FLAGS:
        argv, field, value = PORTED_FLAGS[flag]
        args = parse_args(["--cpu", "train", "--data", toy_npz] + argv)
        from socialways_torch.cli.main import _train_cfg
        assert getattr(_train_cfg(args), field) == value
        return
    with pytest.raises(SystemExit):
        parse_args(["train", "--data", toy_npz, flag, "1"])
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize("field,value", [
    ("grad_clip", 1.0), ("use_l2_loss", True), ("r1_gamma", 0.1),
    ("d_update_every", 2), ("grad_accum", 2), ("serial_rollout", True),
    ("loss_info_w_end", 1.0), ("mesh_shape", 4)])
def test_torch_unported_config_fields_raise_naming_them(field, value,
                                                        toy_npz):
    """``mesh_shape`` stays refused.  The other fields are ported: the
    trainer takes them, except ``grad_accum`` 2 on this toy set, whose
    packing splits a scene of 6 at the micro-chunk boundary (JAX's
    alignment error, naming the field)."""
    if field == "mesh_shape":
        with pytest.raises(NotImplementedError, match=field):
            _port_trainer(toy_npz, **{field: value})
    elif field == "grad_accum":
        with pytest.raises(ValueError, match=f"{field}=2 splits scene"):
            _port_trainer(toy_npz, **{field: value})
    else:
        assert getattr(_port_trainer(toy_npz, **{field: value}).cfg,
                       field) == value


def test_torch_train_refuses_a_missing_card(toy_npz, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["train", "--recipe", "loo", "--data", toy_npz,
                   "--epochs", "1", "--model-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(**LOO), load_npz_dataset(toy_npz))
