"""The LSTM decoder (the reference's DecoderLstm) of socialways_torch
against socialways_tpu: the rollout and its gradient, plain and with the
loo features, with and without step rematerialization; the K-sample
rollout under gaussian noise; ``cli evaluate`` of a JAX LSTM-decoder
checkpoint; and full training states of the new layouts (LSTM decoder, a
pac/mb_std classifier, the grad-clip optimizer chain with a schedule)
loading both ways, with ``transplant_schedule_clock`` and
``reinit_discriminator`` under that layout.

Tolerances: f32 rtol 1e-4 / atol 1e-5 on rollouts and gradients (as
test_torch_train_step.py); checkpoint leaves exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.cli.main import main as jax_cli
from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.engine import losses as jlosses
from socialways_tpu.engine.train_step import \
    transplant_schedule_clock as jax_transplant
from socialways_tpu.eval.metrics import k_sample_rollout as jax_k_rollout
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.io.checkpoint import restore_checkpoint as jax_restore
from socialways_tpu.io.checkpoint import save_checkpoint as jax_save
from socialways_tpu.models import generator_rollout as jax_rollout
from socialways_tpu.models import init_generator as jax_init_generator
from socialways_tpu.ops.traj import canonicalize_for_rollout as jax_canon
from socialways_torch.cli.main import main as torch_cli
from socialways_torch.config import TrainConfig
from socialways_torch.engine.rescue import reinit_discriminator
from socialways_torch.engine.train_step import transplant_schedule_clock
from socialways_torch.eval import metrics as tmetrics
from socialways_torch.eval.metrics import k_sample_rollout
from socialways_torch.io.checkpoint import (flatten_state,
                                            generator_params_from_jax,
                                            restore_checkpoint,
                                            save_checkpoint,
                                            train_state_from_jax)
from socialways_torch.models.generator import (generator_rollout,
                                               init_generator)
from socialways_torch.ops.traj import canonicalize_for_rollout
from test_torch_train_step import ATOL, RTOL, jax_init, make_chunk

H = 16
LSTM = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
            n_past=8, n_next=12, decoder="lstm")
SOCIAL = dict(use_social=True, agent_frame=True)


def _generators(seed, **flags):
    jcfg, tcfg = JaxConfig(**LSTM, **flags), TrainConfig(**LSTM, **flags)
    jp = jax.jit(jax_init_generator, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    gen = init_generator(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen.load_state_dict(generator_params_from_jax(jax.device_get(jp)))
    return jcfg, tcfg, jp, gen


@pytest.mark.parametrize("social,remat", [(False, False), (True, False),
                                          (True, True)],
                         ids=["plain", "social_af", "social_af_remat"])
def test_torch_lstm_decoder_rollout_and_gradient_match_jax(social, remat):
    """The rollout and d(sum(rollout * r))/d(params) at every leaf; under
    ``remat`` both sides checkpoint the encoder and decode steps."""
    flags = SOCIAL if social else {}
    jcfg, tcfg, jp, gen = _generators(3, **flags)
    assert sorted(n for n, _ in gen.named_parameters()) == sorted(
        generator_params_from_jax(jax.device_get(jp)))
    b = make_chunk(4, n=24)
    rng = np.random.RandomState(5)
    noise = rng.randn(24, H // 2).astype(np.float32)
    r = rng.randn(24, 12, 4).astype(np.float32)
    ids = jnp.asarray(b["scene_ids"])

    def jax_loss(p):
        obsv, _, sx4 = jax_canon(jnp.asarray(b["obsvs"]), social, social)
        out = jax_rollout(p, obsv, jnp.asarray(noise), 12, ids, social,
                          "lstm", False, 0, remat, sx4)
        return jnp.sum(out * jnp.asarray(r)), out

    (_, want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(jp)
    obsv, _, sx4 = canonicalize_for_rollout(torch.from_numpy(b["obsvs"]),
                                            social, social)
    out = generator_rollout(gen, obsv, torch.from_numpy(noise), 12,
                            torch.from_numpy(b["scene_ids"]), social, sx4,
                            "lstm", remat)
    names = [n for n, _ in gen.named_parameters()]
    params = list(gen.parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), params,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g       # JAX's zeros
             for p, g in zip(params, grads)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    g_want = generator_params_from_jax(jax.device_get(g_want))
    for name, g in zip(names, grads):
        scale = float(np.abs(g_want[name].numpy()).max())
        np.testing.assert_allclose(g.numpy(), g_want[name].numpy(),
                                   rtol=RTOL, atol=ATOL + 1e-5 * scale,
                                   err_msg=name)


def test_torch_lstm_decoder_k_sample_rollout_matches_jax():
    """K gaussian draws decoded as K·N rows equal JAX's vmapped decode."""
    jcfg, tcfg, jp, gen = _generators(6, noise_dist="gaussian", **SOCIAL)
    b, k, rng = make_chunk(7, n=24), 5, jax.random.PRNGKey(8)
    want = jax.jit(lambda p, o, s, kk: jax_k_rollout(p, o, s, kk, k, jcfg))(
        jp, jnp.asarray(b["obsvs"]), jnp.asarray(b["scene_ids"]), rng)
    noise = jax.vmap(lambda kk: jlosses.sample_noise(kk, 24, jcfg))(
        jax.random.split(rng, k))
    assert float(jnp.min(noise)) < 0          # the gaussian draw
    got = k_sample_rollout(gen, torch.from_numpy(b["obsvs"]),
                           torch.from_numpy(b["scene_ids"]), k, tcfg,
                           noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_torch_cli_evaluate_serves_a_jax_lstm_checkpoint(tmp_path, capsys,
                                                         monkeypatch):
    """``cli evaluate`` of a JAX checkpoint with the LSTM decoder and
    gaussian noise adopts both from its config and prints JAX's numbers
    under JAX's per-chunk draws."""
    npz = str(tmp_path / "toy.npz")
    np.savez(npz, **make_toy_npz_arrays(n_per_batch=6))
    jcfg = JaxConfig(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                     batch_size=64, decoder="lstm", noise_dist="gaussian",
                     **SOCIAL)
    tr = JaxTrainer(jcfg, jax_load(npz))
    ckpt = str(tmp_path / "lstm.npz")
    jax_save(ckpt, tr.init_state(seed=2), 3, jax.random.PRNGKey(0),
             tr.dataset.scale, tr.cfg)
    args = ["evaluate", "--data", npz, "--model-file", ckpt, "--batch-size",
            "64", "--k", "4"]
    assert jax_cli(["--cpu"] + args) == 0
    want = capsys.readouterr().out
    # JAX's evaluate: one key a chunk, K gaussian draws from its split
    keys = jax.random.split(jax.random.PRNGKey(0), tr.test_packed.n_chunks)
    noises = iter([torch.from_numpy(np.array(jax.vmap(
        lambda kk: jlosses.sample_noise(kk, tr.test_packed.width, jcfg))(
        jax.random.split(key, 4)))) for key in keys])
    monkeypatch.setattr(tmetrics, "draw_noise",
                        lambda k, n, cfg, generator=None, device=None:
                        next(noises).to(device))
    assert torch_cli(["--cpu"] + args) == 0
    assert capsys.readouterr().out == want


#: every new layout at once: the LSTM decoder, a classifier over packs of 2
#: with the mb_std input, and both optimizers behind a clip, one scheduled
VARIANT = dict(LSTM, pac=2, mb_std=True, spectral_norm=True, grad_clip=1.0,
               d_lr_decay_rate=0.7, d_lr_decay_steps=2)


def _jax_state(seed, counts):
    """A JAX state of VARIANT whose leaves are all non-trivial: parameters
    and moments perturbed, every count set to ``counts``."""
    rng = np.random.RandomState(seed)
    state = jax.device_get(jax_init(jax.random.PRNGKey(seed),
                                    JaxConfig(**VARIANT)))

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.asarray(counts, x.dtype)
        return (x + 0.01 * rng.randn(*x.shape)).astype(x.dtype)
    return jax.tree_util.tree_map(fill, state)


def test_torch_variant_checkpoints_load_both_ways(tmp_path):
    jstate = _jax_state(1, 5)
    want = _flatten(jstate)
    assert ".g_opt/[1]/[0]/.count" in want and ".d_opt/[1]/[1]/.count" in want
    assert ".g_params/['dec_lstm']/['w']" in want
    tcfg = TrainConfig(**VARIANT)
    # JAX -> port, through the tree and through JAX's npz
    path = str(tmp_path / "jax.npz")
    jax_save(path, jstate, 4, jax.random.PRNGKey(0), None,
             JaxConfig(**VARIANT))
    for state in (train_state_from_jax(jstate, tcfg, "cpu"),
                  restore_checkpoint(path, tcfg, "cpu")[0]):
        got = flatten_state(state)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)
        assert state.g_opt.clipped and state.d_opt.schedule_count == 5
    # port -> JAX
    out = str(tmp_path / "port.npz")
    save_checkpoint(out, state, 4, torch.Generator().manual_seed(0), None,
                    tcfg)
    template = jax_init(jax.random.PRNGKey(0), JaxConfig(**VARIANT))
    back, epoch, _, _ = jax_restore(out, template)
    back = _flatten(jax.device_get(back))
    assert epoch == 4 and sorted(back) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(back[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_torch_clock_and_fresh_d_under_the_clip_layout(tmp_path):
    """``transplant_schedule_clock`` moves every count of the clip chain as
    JAX's does; a rescue's fresh D is built at the pac/mb_std width with a
    fresh clipped, scheduled optimizer that JAX restores."""
    tcfg = TrainConfig(**VARIANT)
    restored, clock = _jax_state(2, 3), _jax_state(3, 9)
    want = _flatten(jax_transplant(restored, clock))
    got = flatten_state(transplant_schedule_clock(
        train_state_from_jax(restored, tcfg, "cpu"),
        train_state_from_jax(clock, tcfg, "cpu")))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    assert int(got[".d_opt/[1]/[1]/.count"]) == 9

    state = train_state_from_jax(clock, tcfg, "cpu")
    fresh = reinit_discriminator(state, tcfg, torch.Generator().manual_seed(4))
    assert tuple(fresh.d.classifier[0].w.shape) == ((H + 1) * 2, H // 2)
    assert fresh.d_opt.clipped and fresh.d_opt.count == 0
    assert fresh.d_opt.schedule_count == 0
    path = str(tmp_path / "fresh.npz")
    save_checkpoint(path, fresh, 1, None, None, tcfg)
    jstate = jax_restore(path, jax_init(jax.random.PRNGKey(0),
                                        JaxConfig(**VARIANT)))[0]
    assert int(jstate.d_opt[1][1].count) == 0
    assert int(jstate.g_opt[1][0].count) == 9
