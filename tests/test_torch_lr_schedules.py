"""socialways_torch's lr schedules against socialways_tpu: Adam under
JAX's staircase decay and warmup (shared and D-only) against optax's,
two ``gan_step``s under a decayed D lr and under warmup against JAX's,
``transplant_schedule_clock``, checkpoints of scheduled optimizers both
ways, and the categorical config a checkpoint carries.

Tolerances: the schedule's values within 3e-7 relative of optax's (f32
``pow`` differs by an ulp at some counts); Adam alone at atol 1e-4 * lr
over twelve updates of about +-lr each (f32 rounding in two libraries; a
wrong stair or a schedule read one count off moves an update by at least
14 % of lr); gan_steps as in test_torch_train_step.py; counts and
checkpoint leaves exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_tpu.engine.train_step import \
    make_optimizers as jax_make_optimizers
from socialways_tpu.engine.train_step import \
    transplant_schedule_clock as jax_transplant
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.io.checkpoint import restore_checkpoint as jax_restore
from socialways_tpu.io.checkpoint import save_checkpoint as jax_save
from socialways_torch.config import TrainConfig
from socialways_torch.engine.rescue import reinit_discriminator
from socialways_torch.engine.train_step import (gan_step, lr_schedule,
                                                make_optimizers,
                                                transplant_schedule_clock)
from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                            flatten_state,
                                            restore_checkpoint,
                                            save_checkpoint,
                                            train_state_from_jax)
from test_torch_gan_variants import CATEGORICAL, PLAIN, jax_draws
from test_torch_train_step import (assert_state_close, jax_init, make_chunk,
                                   to_torch)

SCHEDULES = {
    "d_decay": dict(d_lr_decay_rate=0.7, d_lr_decay_steps=1),
    "warmup": dict(lr_warmup_steps=3, d_lr_warmup_steps=5),
    "shared_decay": dict(lr_decay_rate=0.5, lr_decay_steps=2,
                         lr_warmup_steps=2),
}


@pytest.mark.parametrize("flags", [
    dict(), dict(lr_decay_rate=0.5, lr_decay_steps=3),
    dict(lr_decay_rate=0.5, lr_decay_steps=3, d_lr_decay_rate=0.7,
         d_lr_decay_steps=2),
    dict(d_lr_decay_rate=0.7, d_lr_decay_steps=0),
    dict(lr_warmup_steps=4), dict(lr_warmup_steps=4, d_lr_warmup_steps=7),
    dict(lr_decay_rate=0.9, lr_decay_steps=2, lr_warmup_steps=5),
    dict(lr_decay_rate=0.0, lr_decay_steps=2),
], ids=["constant", "shared_decay", "d_decay_override", "d_rate_no_steps",
        "warmup", "d_warmup_override", "decay_and_warmup", "zero_rate"])
def test_torch_adam_schedules_match_optax(flags):
    """Twelve updates of one parameter vector under each optimizer of
    ``make_optimizers`` against JAX's optax chain on the same gradients;
    the state layout (a schedule count or none) matches too."""
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    grads = np.random.RandomState(len(str(flags))).randn(12, 5).astype(
        np.float32)
    for jtx, ttx, lr in zip(jax_make_optimizers(jcfg), make_optimizers(tcfg),
                            (tcfg.lr_g, tcfg.lr_d)):
        jp = {"w": jnp.zeros(5, jnp.float32)}
        js = jtx.init(jp)
        module = torch.nn.Module()
        module.w = torch.nn.Parameter(torch.zeros(5))
        ts = ttx.init(module)
        for g in grads:
            upd, js = jtx.update({"w": jnp.asarray(g)}, js, jp)
            jp = optax.apply_updates(jp, upd)
            ttx.step(ts, module, [torch.from_numpy(g)])
            np.testing.assert_allclose(module.w.detach().numpy(),
                                       np.asarray(jp["w"]), rtol=0,
                                       atol=1e-4 * lr)
        has_schedule = isinstance(js[1], optax.ScaleByScheduleState)
        assert (ts.schedule_count is not None) == has_schedule
        if has_schedule:
            assert ts.schedule_count == int(js[1].count) == 12
        assert ts.count == int(js[0].count) == 12


@pytest.mark.parametrize("rate,steps", [(0.7, 1), (0.5, 3), (0.9, 10)])
def test_torch_staircase_decay_matches_optax(rate, steps):
    sched = lr_schedule(1e-3, rate, steps, 0)
    want = optax.exponential_decay(1e-3, transition_steps=steps,
                                   decay_rate=rate, staircase=True)
    for c in range(0, 40):
        assert sched(c) == pytest.approx(float(want(jnp.int32(c))),
                                         rel=3e-7, abs=0), c
    assert lr_schedule(1e-3, 1.0, 5, 0) == 1e-3


@pytest.fixture(scope="module")
def jax_runs():
    """Two JAX gan_steps of the plain generator under each schedule, each
    jitted once; built on first use per schedule."""
    cache = {}

    def run(name):
        if name not in cache:
            flags = dict(PLAIN, **SCHEDULES[name])
            jcfg = JaxConfig(**flags)
            step = jax.jit(lambda s, b, k: jax_gan_step(s, b, k, jcfg))
            states = [jax_init(jax.random.PRNGKey(3), jcfg)]
            batches = [make_chunk(30, n=32), make_chunk(31, n=32)]
            keys = [jax.random.PRNGKey(40), jax.random.PRNGKey(41)]
            metrics = []
            for b, k in zip(batches, keys):
                s, m = step(states[-1],
                            {a: jnp.asarray(v) for a, v in b.items()}, k)
                states.append(s)
                metrics.append(jax.device_get(m))
            cache[name] = (flags, jcfg, batches, keys,
                           [jax.device_get(s) for s in states], metrics)
        return cache[name]
    return run


@pytest.mark.parametrize("name", ["d_decay", "warmup"])
def test_torch_two_scheduled_gan_steps_match_jax(name, jax_runs):
    flags, jcfg, batches, keys, jstates, jmetrics = jax_runs(name)
    tcfg = TrainConfig(**flags)
    state = train_state_from_jax(jstates[0], tcfg, "cpu")
    for i, (b, k) in enumerate(zip(batches, keys)):
        old = {key: v.copy() for key, v in flatten_state(state).items()}
        state, m = gan_step(state, to_torch(b), jax_draws(k, 32, jcfg), tcfg)
        assert_state_close(state, jstates[i + 1], tag=f"{name} step {i}",
                           t_old=old, j_old=jstates[i], cfg=tcfg)
        for field in ("d_loss", "g_loss"):
            np.testing.assert_allclose(float(getattr(m, field)),
                                       float(getattr(jmetrics[i], field)),
                                       rtol=1e-4, atol=1e-5)
    assert state.d_opt.schedule_count == state.d_opt.count == 4
    assert (state.g_opt.schedule_count is None) == (name == "d_decay")


def test_torch_transplant_schedule_clock_matches_jax(jax_runs):
    flags, jcfg, _, _, jstates, _ = jax_runs("shared_decay")
    tcfg = TrainConfig(**flags)
    want = _flatten(jax_transplant(jstates[0], jstates[2]))
    restored = train_state_from_jax(jstates[0], tcfg, "cpu")
    clock = train_state_from_jax(jstates[2], tcfg, "cpu")
    got = flatten_state(transplant_schedule_clock(restored, clock))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    assert int(got[".g_opt/[1]/.count"]) == 2
    assert int(got[".d_opt/[0]/.count"]) == 4
    assert restored.g_opt.count == 0 and clock.g_opt.count == 2


def test_torch_scheduled_checkpoint_loads_in_jax(jax_runs, tmp_path):
    flags, jcfg, _, _, jstates, _ = jax_runs("shared_decay")
    tcfg = TrainConfig(**flags)
    state = train_state_from_jax(jstates[2], tcfg, "cpu")
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, state, 2, torch.Generator().manual_seed(0), None,
                    tcfg)
    template = jax_init(jax.random.PRNGKey(0), jcfg)
    jstate, epoch, _, _ = jax_restore(path, template)
    got, want = _flatten(jax.device_get(jstate)), flatten_state(state)
    assert epoch == 2 and sorted(got) == sorted(want)
    assert ".g_opt/[1]/.count" in want and ".d_opt/[1]/.count" in want
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)
    # a fresh D of the rescue starts its schedule at 0, as in JAX
    fresh = reinit_discriminator(state, tcfg, torch.Generator().manual_seed(1))
    assert fresh.d_opt.schedule_count == fresh.d_opt.count == 0
    save_checkpoint(path, fresh, 3, None, None, tcfg)
    jstate = jax_restore(path, template)[0]
    assert int(jstate.d_opt[1].count) == 0
    assert int(jstate.g_opt[1].count) == 2


def test_torch_jax_scheduled_checkpoint_restores_in_port(jax_runs, tmp_path):
    flags, jcfg, _, _, jstates, _ = jax_runs("d_decay")
    path = str(tmp_path / "jax.npz")
    jax_save(path, jstates[2], 2, jax.random.PRNGKey(0), None, jcfg)
    tcfg = TrainConfig(**flags)
    state, epoch, rng, _ = restore_checkpoint(path, tcfg, "cpu")
    assert epoch == 2 and rng is None
    want = _flatten(jstates[2])
    got = flatten_state(state)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    # a config with no D schedule ignores the leaf, as JAX's restore does;
    # one that needs a leaf the checkpoint lacks fails as JAX's does
    plain = TrainConfig(**PLAIN)
    assert restore_checkpoint(path, plain, "cpu")[0].d_opt.schedule_count \
        is None
    with pytest.raises(KeyError, match=r"\.g_opt/\[1\]/\.count"):
        restore_checkpoint(path, tcfg.replace(lr_warmup_steps=3), "cpu")
    with pytest.raises(KeyError, match=r"\.g_opt/\[1\]/\.count"):
        jax_restore(path, jax_init(jax.random.PRNGKey(0),
                                   jcfg.replace(lr_warmup_steps=3)))


def test_torch_categorical_checkpoint_config_is_adopted(tmp_path):
    flags = dict(PLAIN, **CATEGORICAL)
    jcfg = JaxConfig(**flags)
    path = str(tmp_path / "cat.npz")
    jax_save(path, jax_init(jax.random.PRNGKey(2), jcfg), 5,
             jax.random.PRNGKey(0), None, jcfg)
    cfg = adopt_checkpoint_config(TrainConfig(**PLAIN), path)
    assert (cfg.latent_code_type, cfg.n_latent_codes) == ("categorical", 3)
    state = restore_checkpoint(path, cfg, "cpu")[0]
    assert state.d.latent_dec[1].w.shape[1] == 3
