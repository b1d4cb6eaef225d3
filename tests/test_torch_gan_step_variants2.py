"""socialways_torch ``gan_step`` against socialways_tpu's under JAX's draws,
the D-side variants: PacGAN (pac 2), minibatch stddev, spectral norm, R1
(with the loo features: agent frame, social attention, EMA, D instance
noise), the D/G update-ratio schedule over a taken, a skipped and a
switched step, and the global-norm gradient clip.  Parameters come from JAX
through the weight bridge.

Tolerances as in test_torch_train_step.py: f32 rtol 1e-4 / atol 1e-5 on
losses and metrics; updated parameters and moments at atol 1e-5 plus 1e-3
times the leaf's scale, and each step's change of every G and D parameter
at atol 1e-2 * lr.  R1 differentiates D's gradient once more; it holds at
the same tolerances."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_torch.config import TrainConfig
from socialways_torch.engine.train_step import gan_step
from socialways_torch.io.checkpoint import flatten_state, train_state_from_jax
from test_torch_gan_variants import PLAIN, jax_draws
from test_torch_train_step import (ATOL, LOO, RTOL, assert_state_close,
                                   jax_init, make_chunk, to_torch)


def run_steps(flags, seed=7, n=32, steps=1, chunk=make_chunk):
    """``steps`` JAX gan_steps (one compile) and as many port steps from
    the same state under the same draws, each held against JAX's; returns
    the port's config and the flattened states before and after each."""
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    jstate = jax_init(jax.random.PRNGKey(seed), jcfg)
    step = jax.jit(lambda s, bb, k: jax_gan_step(s, bb, k, jcfg))
    state = train_state_from_jax(jax.device_get(jstate), tcfg, "cpu")

    def snapshot():      # flatten_state's arrays share the CPU tensors
        return {k: v.copy() for k, v in flatten_state(state).items()}
    flats = [snapshot()]
    for i in range(steps):
        b, key = chunk(seed + 1 + i, n=n), jax.random.PRNGKey(seed + 2 + i)
        j_next, jm = step(jstate, {a: jnp.asarray(v) for a, v in b.items()},
                          key)
        state, m = gan_step(state, to_torch(b), jax_draws(key, n, jcfg),
                            tcfg)
        assert_state_close(state, j_next, tag=f"{flags} step {i}",
                           t_old=flats[-1], j_old=jstate, cfg=tcfg)
        jm = jax.device_get(jm)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(float(getattr(m, name)),
                                       float(getattr(jm, name)), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} step {i}")
        assert int(m.n_samples) == int(jm.n_samples)
        flats.append(snapshot())
        jstate = j_next
    return tcfg, state, flats


@pytest.mark.parametrize("variant", [
    dict(pac=2), dict(mb_std=True), dict(spectral_norm=True),
    dict(grad_clip=0.05)], ids=["pac2", "mb_std", "spectral_norm",
                                "grad_clip"])
def test_torch_gan_step_d_side_variant_matches_jax(variant):
    # a plain generator keeps JAX's compile short; these variants change
    # the discriminator, its losses and the optimizers
    tcfg, state, _ = run_steps(dict(PLAIN, **variant))
    assert state.g_opt.count == 1 and state.d_opt.count == 2
    assert state.g_opt.clipped == (tcfg.grad_clip > 0)


def test_torch_gan_step_r1_with_pac_mb_std_and_loo_features_matches_jax():
    """R1 on the noised real futures under pac 2 and minibatch stddev (the
    penalty's gradient runs through the mb_std statistic too), with the
    agent frame, social attention, EMA and D instance noise."""
    run_steps(dict(LOO, r1_gamma=1.0, pac=2, mb_std=True), seed=11, n=40)


def test_torch_gan_step_d_update_ratio_schedule_matches_jax():
    """Every 2nd step, then every step from G step 2: step 0 runs the D
    phase, step 1 skips it (D, its moments and counts untouched; d_loss the
    forward loss of the current D; G against that D), step 2 runs it."""
    flags = dict(PLAIN, d_update_every=2, d_update_every_end=1,
                 d_update_every_switch=2)
    _, state, flats = run_steps(flags, steps=3)
    d_keys = [k for k in flats[0] if k.startswith((".d_params/", ".d_opt/"))]
    for key in d_keys:
        np.testing.assert_array_equal(flats[2][key], flats[1][key],
                                      err_msg=key)
    assert any(not np.array_equal(flats[3][k], flats[2][k]) for k in d_keys)
    assert state.g_opt.count == 3 and state.d_opt.count == 4
