"""socialways_torch ``gan_step`` against socialways_tpu's under JAX's draws,
the G-side variants: the l2 and variety losses, mode seeking, the
diversity hinge at ds_k 4, the info-weight ramp over two steps, the serial
rollout, step rematerialization, and the LSTM decoder under gaussian noise
with the loo features (agent frame, social attention, EMA, D instance
noise) and the variety, mode-seeking and diversity terms together.  The
port decodes the extra draws as rows of one batch beside the step's own;
JAX vmaps a rollout over them.  Parameters come from JAX through the
weight bridge.

Tolerances as in test_torch_train_step.py (see there)."""

import pytest

from test_torch_gan_step_variants2 import run_steps
from test_torch_gan_variants import PLAIN
from test_torch_train_step import LOO


@pytest.mark.parametrize("variant", [
    dict(use_variety_loss=True, use_l2_loss=True, variety_k=5),
    dict(ms_weight=0.1), dict(ds_weight=0.1, ds_k=4),
    dict(serial_rollout=True), dict(remat_steps=True)],
    ids=["variety_l2", "ms", "ds_k4", "serial_rollout", "remat_steps"])
def test_torch_gan_step_g_side_variant_matches_jax(variant):
    tcfg, state, _ = run_steps(dict(PLAIN, **variant))
    assert state.g_opt.count == 1 and state.d_opt.count == 2


def test_torch_gan_step_info_ramp_matches_jax():
    """The info weight ramps 0.5 -> 1.0 over 3 G steps, read from the
    count before each update: two steps at two weights."""
    run_steps(dict(PLAIN, loss_info_w_end=1.0, loss_info_w_steps=3),
              steps=2)


def test_torch_gan_step_lstm_decoder_with_every_g_loss_matches_jax():
    flags = dict(LOO, decoder="lstm", noise_dist="gaussian",
                 use_variety_loss=True, use_l2_loss=True, variety_k=3,
                 ms_weight=0.1, ds_weight=0.1, ds_k=3, remat_steps=True)
    run_steps(flags, seed=13, n=40)
