"""socialways_torch ``gan_step`` variants against socialways_tpu under
JAX's draws: unroll 0 and 5, the info loss off, categorical latent codes
(on the plain generator, and once on the toy-flagship feature set: agent
frame, social attention, EMA, D instance noise, a decayed D lr), plus the
categorical losses and K-sample noise.  Parameters come from JAX through
the weight bridge.

Tolerances as in test_torch_train_step.py: f32 rtol 1e-4 / atol 1e-5 on
losses and metrics; updated parameters and moments at atol 1e-5 plus 1e-3
times the leaf's scale, and each step's change of every G and D parameter
at atol 1e-2 * lr."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine import losses as jlosses
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_tpu.eval.metrics import k_sample_rollout as jax_rollout
from socialways_tpu.eval.stats import toy_mode_coverage
from socialways_torch.config import TrainConfig
from socialways_torch.engine import losses as tlosses
from socialways_torch.engine.train_step import StepDraws, gan_step
from socialways_torch.eval.metrics import draw_noise, k_sample_rollout
from socialways_torch.io.checkpoint import (flatten_state,
                                            generator_params_from_jax,
                                            train_state_from_jax)
from socialways_torch.models.generator import init_generator
from test_torch_train_step import (ATOL, LOO, RTOL, assert_state_close,
                                   jax_init, make_chunk, to_torch)

H = 16
PLAIN = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
             n_past=8, n_next=12)
CATEGORICAL = dict(latent_code_type="categorical", n_latent_codes=3,
                   loss_info_w=1.0)


def jax_draws(key, n, jcfg) -> StepDraws:
    """Every draw JAX's gan_step makes from ``key`` (train_step.py:233,
    282-287, 428-443, 603-619), the noise through JAX's own
    ``sample_noise`` (the categorical code from ``randint(fold_in(k_noise,
    1), ...)``), the variety draws from ``split(k_var, variety_k)`` and the
    extra draws of the diversity terms from ``fold_in(key, 17 + j)``."""
    k_noise, k_zero, k_one, k_var = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    draw = lambda k: jlosses.sample_noise(k, n, jcfg)
    zero = jax.random.uniform(k_zero, (), jnp.float32, 0.0, 0.1)
    one = jax.random.uniform(k_one, (), jnp.float32, 0.9, 1.0)
    eps = [None] * 3
    if jcfg.d_input_noise > 0:
        kf, kr, kg = jax.random.split(jax.random.fold_in(key, 13), 3)
        eps = [t(jax.random.normal(k, (n, jcfg.n_next, 4)))
               for k in (kf, kr, kg)]
    variety = extra = None
    if jcfg.use_variety_loss:
        variety = t(jax.vmap(draw)(jax.random.split(k_var, jcfg.variety_k)))
    if jcfg.ms_weight > 0 or jcfg.ds_weight > 0:
        extra = t(jnp.stack([draw(jax.random.fold_in(key, 17 + j))
                             for j in range(max(1, jcfg.ds_k - 1))]))
    return StepDraws(t(draw(k_noise)), t(zero), t(one), *eps, variety, extra)


def run_one_step(flags, seed=7, n=32):
    """One JAX step and one port step from the same state and draws."""
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    j0 = jax_init(jax.random.PRNGKey(seed), jcfg)
    b, key = make_chunk(seed + 1, n=n), jax.random.PRNGKey(seed + 2)
    j1, jm = jax.jit(lambda s, bb, k: jax_gan_step(s, bb, k, jcfg))(
        j0, {a: jnp.asarray(v) for a, v in b.items()}, key)
    state = train_state_from_jax(jax.device_get(j0), tcfg, "cpu")
    old = {k: v.copy() for k, v in flatten_state(state).items()}
    state, m = gan_step(state, to_torch(b), jax_draws(key, n, jcfg), tcfg)
    assert_state_close(state, j1, tag=str(flags), t_old=old, j_old=j0,
                       cfg=tcfg)
    jm = jax.device_get(jm)
    for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert int(m.n_samples) == int(jm.n_samples)
    return tcfg, state


@pytest.mark.parametrize("variant", [
    dict(n_unrolling_steps=0),
    dict(n_unrolling_steps=5),
    dict(use_info_loss=False),
    CATEGORICAL,
], ids=["unroll0", "unroll5", "info_off", "categorical"])
def test_torch_gan_step_variant_matches_jax(variant):
    # a plain generator keeps JAX's compile short; the variants touch only
    # the D phase's count and the losses
    tcfg, state = run_one_step(dict(PLAIN, **variant))
    assert state.g_opt.count == 1
    assert state.d_opt.count == tcfg.n_unrolling_steps + 1


def test_torch_gan_step_categorical_toy_flagship_features_match_jax():
    """The toy-flagship feature set at a small width: agent frame, social
    attention, EMA, annealed D instance noise, categorical codes, a
    staircase-decayed D lr (one stair per update)."""
    flags = dict(LOO, **CATEGORICAL, lr_d=5e-4, d_lr_decay_rate=0.7,
                 d_lr_decay_steps=1, d_input_noise_floor=0.0)
    tcfg, state = run_one_step(flags, seed=21, n=40)
    assert state.d_opt.schedule_count == state.d_opt.count == 2
    assert state.g_opt.schedule_count is None


def test_torch_categorical_losses_match_jax():
    rng = np.random.RandomState(3)
    n, c = 24, 3
    logits = rng.randn(n, c).astype(np.float32) * 2
    codes = rng.randint(0, c, n)
    noise = np.concatenate([np.eye(c, dtype=np.float32)[codes],
                            rng.rand(n, 5).astype(np.float32)], 1)
    valid = rng.rand(n) > 0.3
    label = rng.randn(n, 1).astype(np.float32)
    ones = np.full((n, 1), 0.93, np.float32)
    zeros = np.full((n, 1), 0.04, np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))
    j = jnp.asarray
    pairs = [
        (tlosses.masked_xent(t(logits), t(codes), t(valid)),
         jlosses.masked_xent(j(logits), j(codes), j(valid))),
        (tlosses.info_loss(t(logits), t(noise), t(valid), c, "categorical"),
         jlosses.info_loss(j(logits), j(noise), j(valid), c, "categorical")),
        (tlosses.lsgan_d_loss(t(label), t(-label), t(logits), t(noise),
                              t(valid), t(zeros), t(ones), True, 1.0, c,
                              "categorical"),
         jlosses.lsgan_d_loss(j(label), j(-label), j(logits), j(noise),
                              j(valid), j(zeros), j(ones), True, 1.0, c,
                              "categorical")),
        (tlosses.lsgan_g_loss(t(label), t(logits), t(noise), t(valid),
                              t(ones), True, 1.0, c, "categorical"),
         jlosses.lsgan_g_loss(j(label), j(logits), j(noise), j(valid),
                              j(ones), True, 1.0, c, "categorical")),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    none = torch.zeros(n, dtype=torch.bool)
    assert float(tlosses.masked_xent(t(logits), t(codes), none)) == 0.0


@pytest.mark.parametrize("shape", [(64,), (5, 64)])
def test_torch_categorical_noise_embeds_one_hot_codes(shape):
    cfg = TrainConfig(**PLAIN, **CATEGORICAL)
    gen = torch.Generator().manual_seed(0)
    z = (tlosses.sample_noise(shape, cfg, gen) if len(shape) == 1
         else draw_noise(shape[0], shape[1], cfg, gen))
    assert z.shape == shape + (cfg.noise_len,)
    code, rest = z[..., :3], z[..., 3:]
    assert torch.equal(code.sum(-1), torch.ones(shape))
    assert set(code.unique().tolist()) == {0.0, 1.0}
    assert set(code.argmax(-1).unique().tolist()) == {0, 1, 2}
    assert bool(((rest >= 0) & (rest < 1)).all())
    cont = tlosses.sample_noise(shape, TrainConfig(**PLAIN), gen)
    assert cont.shape == z.shape and not bool((cont[..., :3] == 1).all())


@pytest.mark.parametrize("social", [False, True])
def test_torch_categorical_k_sample_rollout_matches_jax(social):
    """K rollouts under JAX's eval noise (``vmap(sample_noise)`` over
    ``split(rng, K)``) equal JAX's, and so does their toy coverage."""
    flags = dict(PLAIN, **CATEGORICAL, use_social=social, agent_frame=social)
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    from socialways_tpu.models.generator import \
        init_generator as jax_init_generator
    jp = jax.jit(jax_init_generator, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg)
    gen = init_generator(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen.load_state_dict(generator_params_from_jax(jax.device_get(jp)))
    b, k, rng = make_chunk(5, n=24), 6, jax.random.PRNGKey(8)
    want = jax.jit(lambda p, o, s, r: jax_rollout(p, o, s, r, k, jcfg))(
        jp, jnp.asarray(b["obsvs"]), jnp.asarray(b["scene_ids"]), rng)
    noise = jax.vmap(lambda kk: jlosses.sample_noise(kk, 24, jcfg))(
        jax.random.split(rng, k))
    got = k_sample_rollout(gen, torch.from_numpy(b["obsvs"]),
                           torch.from_numpy(b["scene_ids"]), k, tcfg,
                           noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert toy_mode_coverage(b["obsvs"], got[..., :2].numpy()) == \
        toy_mode_coverage(b["obsvs"], np.asarray(want)[..., :2])
