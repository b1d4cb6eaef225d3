"""The step's clock on the device (socialways_torch/engine/train_step.py)
and the graphed epoch (socialways_torch/engine/graphed.py) on the CPU.

- The device schedules against JAX's own formulas, bit for bit, at counts
  0 to 60: the lr schedules (optax's staircase decay with JAX's warmup,
  socialways_tpu/engine/train_step.py:75-98), the instance-noise sigma
  (:415-427), the info ramp (:291-300) and the D/G outcome (:551-569).
  The decay's power is XLA's float32 ``power``, which is not correctly
  rounded: the port rounds a float64 power once, which agrees with it on
  the schedules here and within one ulp on a grid of rates.
- ``gan_step`` on a state at a nonzero count (built in JAX, stepped 7
  times, carried across) against JAX's ``gan_step`` under JAX's draws, in
  a configuration where every schedule moves: f32 rtol 1e-4 / atol 1e-5.
- No host read between the first step and the epoch's metrics read: a
  ``TorchDispatchMode`` raises on ``aten._local_scalar_dense`` (what
  ``.item()``, ``int()``, ``float()`` and ``bool()`` of a tensor reach)
  and ``aten.nonzero`` (a data-dependent shape) in every step of an
  epoch after the first.
- The launch counters: a capture counts nothing and each replay counts
  the capture's launches.
- ``EpochGraphs`` with its capture stubbed (a CUDA graph is CUDA's): the
  graphed epochs equal the eager loop bit for bit, through both D/G
  outcomes, a state replaced by a rescue and the member step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.engine import ensemble as ensemble_mod
from socialways_torch.engine import graphed
from socialways_torch.engine import trainer as trainer_mod
from socialways_torch.engine.ensemble import EnsembleTrainer
from socialways_torch.engine.rescue import reinit_discriminator
from socialways_torch.engine.train_step import (_pow32, d_phase_due,
                                                gan_step, info_weight,
                                                instance_noise_sigma,
                                                make_optimizers,
                                                transplant_schedule_clock)
from socialways_torch.engine.trainer import Trainer
from socialways_torch.io.checkpoint import flatten_state, train_state_from_jax
from socialways_torch.kernels import social_attention as sa
from test_torch_train_step import (ATOL, LOO, RTOL, assert_state_close,
                                   jax_draws, jax_init, make_chunk, to_torch)
from torch_dist_workers import NoHostRead, stub_capture

COUNTS = 61

#: a step where every schedule moves: lr decay with warmup (G and D apart),
#: the D/G ratio switching from 2 to 1 at count 8, the info ramp, the clip,
#: an unroll with the full restore and instance noise annealed to a floor
SCHED = dict(LOO, lr_decay_rate=0.9, lr_decay_steps=3, lr_warmup_steps=4,
             d_lr_decay_rate=0.8, d_lr_decay_steps=2, d_update_every=2,
             d_update_every_end=1, d_update_every_switch=8,
             loss_info_w_end=1.0, loss_info_w_steps=10, grad_clip=0.5,
             n_unrolling_steps=1, d_restore="full", d_input_noise=0.05,
             d_input_noise_steps=12, d_input_noise_floor=0.02)


def jax_lr(lr, rate, steps, warmup):
    """JAX's lr of ``make_optimizers`` (socialways_tpu/engine/
    train_step.py:75-84), a function of the int32 count."""
    if rate != 1.0 and steps > 0:
        lr = optax.exponential_decay(lr, transition_steps=steps,
                                     decay_rate=rate, staircase=True)
    if warmup > 0:
        base = lr if callable(lr) else (lambda step, v=lr: v)

        def lr(step, base=base, w=warmup):
            return base(step) * jnp.minimum(1.0, (step + 1.0) / w)
    return lr


def jax_schedule(name, cfg):
    """What JAX's step computes from the G count (or the optimizer's)."""
    count = jnp.arange(COUNTS, dtype=jnp.int32)
    step = count.astype(jnp.float32)
    if name == "lr_g":
        return jax_lr(cfg.lr_g, cfg.lr_decay_rate, cfg.lr_decay_steps,
                      cfg.lr_warmup_steps)(count)
    if name == "lr_d":
        # the D-only decay and warmup override the shared ones (:90-98)
        decay = ((cfg.d_lr_decay_rate, cfg.d_lr_decay_steps)
                 if cfg.d_lr_decay_steps > 0
                 else (cfg.lr_decay_rate, cfg.lr_decay_steps))
        return jax_lr(cfg.lr_d, *decay,
                      cfg.d_lr_warmup_steps or cfg.lr_warmup_steps)(count)
    if name == "sigma":
        sigma = cfg.d_input_noise * jnp.maximum(
            0.0, 1.0 - step / cfg.d_input_noise_steps)
        if cfg.d_input_noise_floor > 0:
            sigma = jnp.maximum(sigma, jnp.asarray(cfg.d_input_noise_floor,
                                                   jnp.float32))
        return sigma
    if name == "info":
        frac = jnp.minimum(1.0, step / cfg.loss_info_w_steps)
        return cfg.loss_info_w + (cfg.loss_info_w_end
                                  - cfg.loss_info_w) * frac
    every = jnp.where(count < cfg.d_update_every_switch, cfg.d_update_every,
                      cfg.d_update_every_end)
    return (count % every) == 0


SCHEDULES = {
    "lr_shared_decay_warmup": ("lr_g", dict(lr_decay_rate=0.9,
                                            lr_decay_steps=7,
                                            lr_warmup_steps=5)),
    "lr_d_only_decay_warmup": ("lr_d", dict(d_lr_decay_rate=0.7,
                                            d_lr_decay_steps=3,
                                            d_lr_warmup_steps=9)),
    "lr_d_shares_the_decay": ("lr_d", dict(lr_decay_rate=0.5,
                                           lr_decay_steps=4,
                                           lr_warmup_steps=6)),
    "sigma_anneal": ("sigma", dict(d_input_noise=0.05,
                                   d_input_noise_steps=37)),
    "sigma_floor": ("sigma", dict(d_input_noise=0.05, d_input_noise_steps=29,
                                  d_input_noise_floor=0.02)),
    "info_ramp": ("info", dict(loss_info_w=0.3, loss_info_w_end=1.1,
                               loss_info_w_steps=23)),
    "d_ratio_switch": ("ratio", dict(d_update_every=3, d_update_every_end=2,
                                     d_update_every_switch=17)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_torch_device_schedules_match_jax_bit_for_bit(case):
    name, flags = SCHEDULES[case]
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    count = torch.arange(COUNTS, dtype=torch.int32)
    if name in ("lr_g", "lr_d"):
        sched = make_optimizers(tcfg)[name == "lr_d"].lr
        got = sched(count)
    elif name == "sigma":
        got = instance_noise_sigma(tcfg, count)
    elif name == "info":
        got = info_weight(tcfg, count)
    else:
        got = d_phase_due(tcfg, count)
    want = np.asarray(jax_schedule(name, jcfg))
    assert got.shape == (COUNTS,) and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want, err_msg=case)
    # a host count gives the same value, and an [M] count each member's
    for c in (0, 7, COUNTS - 1):
        host = (sched(c) if name in ("lr_g", "lr_d") else
                instance_noise_sigma(tcfg, c) if name == "sigma" else
                info_weight(tcfg, c) if name == "info" else
                d_phase_due(tcfg, c))
        assert host == want[c].item(), (case, c)


def test_torch_decay_power_within_one_ulp_of_xla():
    """``_pow32`` (float64, rounded once) against XLA's float32 ``power`` on
    a grid of rates x the powers 0-60 (where XLA's result is a normal
    float): equal on at least 99.5 % of the pairs, and one ulp apart on
    the rest."""
    rates = np.linspace(0.05, 0.999, 200).astype(np.float32)
    p = np.arange(COUNTS, dtype=np.float32)
    want = np.stack([np.asarray(jnp.power(r, jnp.asarray(p))) for r in rates])
    got = np.stack([_pow32(float(r), torch.from_numpy(p)).numpy()
                    for r in rates])
    # XLA flushes subnormal results to zero; a schedule never reaches one
    normal = want >= np.finfo(np.float32).tiny
    assert normal.mean() > 0.9
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))[normal]
    assert ulps.max() <= 1
    assert (ulps == 0).mean() >= 0.995, (ulps != 0).sum()


@pytest.fixture(scope="module")
def jax_at_count_7():
    """A JAX state stepped 7 times under SCHED, then two more steps (at
    counts 7 and 8: the ratio skips the D phase, then runs it)."""
    jcfg, n = JaxConfig(**SCHED), 32
    step = jax.jit(lambda s, b, k: jax_gan_step(s, b, k, jcfg))
    state = jax_init(jax.random.PRNGKey(11), jcfg)
    for i in range(7):
        state = step(state, {k: jnp.asarray(v) for k, v in
                             make_chunk(60 + i, n=n).items()},
                     jax.random.PRNGKey(70 + i))[0]
    states, metrics, chunks, keys = [state], [], [], []
    for i in range(2):
        chunk, key = make_chunk(80 + i, n=n), jax.random.PRNGKey(90 + i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in chunk.items()},
                        key)
        states.append(state)
        metrics.append(jax.device_get(m))
        chunks.append(chunk)
        keys.append(key)
    return jcfg, n, [jax.device_get(s) for s in states], metrics, chunks, keys


def test_torch_gan_step_at_a_nonzero_count_matches_jax(jax_at_count_7):
    jcfg, n, jstates, jmetrics, chunks, keys = jax_at_count_7
    tcfg = TrainConfig(**SCHED)
    state = train_state_from_jax(jstates[0], tcfg, "cpu")
    assert int(state.g_opt.count) == 7 and int(state.d_opt.count) == 8
    for i, (chunk, key) in enumerate(zip(chunks, keys)):
        old = {k: v.copy() for k, v in flatten_state(state).items()}
        state, m = gan_step(state, to_torch(chunk), jax_draws(key, n, jcfg),
                            tcfg)
        assert_state_close(state, jstates[i + 1], tag=f"count {7 + i}",
                           t_old=old, j_old=jstates[i], cfg=tcfg)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(float(getattr(m, name)),
                                       float(getattr(jmetrics[i], name)),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
    # count 7 skipped the D phase (every 2), count 8 ran it (every 1)
    assert int(state.g_opt.count) == 9 and int(state.d_opt.count) == 10


# ------------------------------------------------------------ host reads
H = 16
BASE = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
            batch_size=48, agent_frame=True, use_social=True,
            g_ema_decay=0.999, d_input_noise=0.05, d_input_noise_steps=-1,
            d_input_noise_floor=0.02, n_epochs=10)
NO_READ = {
    "loo": BASE,
    "loo_r1": dict(BASE, r1_gamma=1.0),
    "remat": dict(BASE, remat_steps=True),
    "grad_accum": dict(BASE, grad_accum=2),
    "ensemble_m2": BASE,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", sorted(NO_READ))
def test_torch_epoch_reads_nothing_on_the_host_between_steps(
        case, toy_npz, monkeypatch):
    """Every step of one epoch after the first runs under ``NoHostRead``,
    until the epoch's one metrics read."""
    tr = Trainer(TrainConfig(**NO_READ[case]), load_npz_dataset(toy_npz),
                 "cpu")
    assert tr.n_steps_per_epoch >= 3
    mode, calls, left = NoHostRead(), [], []
    members = case.startswith("ensemble")
    mod = ensemble_mod if members else trainer_mod
    real_step = mod.gan_step

    def step(*args, **kwargs):
        out = real_step(*args, **kwargs)
        calls.append(mode.ops)
        if len(calls) == 1:
            mode.__enter__()
        return out

    def leave():
        if len(calls) and not left:
            left.append(1)
            mode.__exit__(None, None, None)
    monkeypatch.setattr(mod, "gan_step", step)
    if members:
        real_metrics = EnsembleTrainer._metrics
        monkeypatch.setattr(EnsembleTrainer, "_metrics", lambda self, *a:
                            (leave(), real_metrics(self, *a))[1])
    else:
        real_metrics = Trainer._host_metrics
        monkeypatch.setattr(Trainer, "_host_metrics", lambda self, *a:
                            (leave(), real_metrics(self, *a))[1])
    gen = lambda s: torch.Generator().manual_seed(s)
    try:
        if members:
            ens = EnsembleTrainer(tr)
            _, m = ens.train_epoch(ens.init_states([1, 2]), [gen(3), gen(4)])
            assert np.isfinite(m["g_loss"]).all() and len(m["g_loss"]) == 2
        else:
            _, m = tr.train_epoch(tr.init_state(1), gen(3))
            assert np.isfinite(m["g_loss"])
    finally:
        leave()
    assert len(calls) == tr.n_steps_per_epoch
    assert calls[-1] > 0          # the later steps ran under the mode


# ------------------------------------------------------- launch counters
def test_torch_launch_counters_credit_each_replay():
    """A stub runner: the capture counts nothing, each replay counts the
    capture's launches, as the wrappers would have counted them."""
    h32, h16 = torch.zeros(4, 16), torch.zeros(2, 4, 16, dtype=torch.bfloat16)

    class StubGraph:
        def __init__(self, fn):
            with sa.captured_launches() as self.launches:
                fn()

        def replay(self):
            sa.credit_launches(self.launches)

    def step():
        sa._count(sa.social_attention_fwd, h32)
        sa._count(sa.social_attention_bwd_dkv, h32)
        sa._count(sa.social_attention_fwd, h16)     # a bf16 member launch

    before = sa.launch_counts()
    graph = StubGraph(step)
    assert sa.launch_counts() == before
    assert graph.launches == {
        (sa.social_attention_fwd, "launches"): 1,
        (sa.social_attention_bwd_dkv, "launches"): 1,
        (sa.social_attention_fwd, "launches_bf16"): 1,
        (sa.social_attention_fwd, "member_launches_bf16"): 1}
    for _ in range(5):
        graph.replay()
    sa.credit_launches(graph.launches, times=2)
    after = sa.launch_counts()
    for key, n in before.items():
        assert after[key] == n + 7 * graph.launches.get(key, 0), key


# ------------------------------------------- the runner, capture stubbed
def _assert_same(a, b, what):
    fa, fb = flatten_state(a), flatten_state(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("members", [False, True], ids=["solo", "members"])
def test_torch_graphed_epochs_equal_the_eager_loop(members, toy_npz,
                                                   monkeypatch):
    """Trainer (or EnsembleTrainer) epochs through ``EpochGraphs`` with the
    capture stubbed, against the eager loop: bit for bit over 2 epochs at
    a D/G ratio of 2 (both outcomes captured), then after a rescue and a
    clock transplant replace the state, which the runner recaptures."""
    captures = []
    monkeypatch.setattr(graphed.EpochGraphs, "_capture",
                        lambda self, step: (captures.append(1),
                                            stub_capture(self, step))[1])
    cfg = TrainConfig(**dict(BASE, d_update_every=2, lr_decay_rate=0.9,
                             lr_decay_steps=2))
    ds = load_npz_dataset(toy_npz)
    eager, graph = Trainer(cfg, ds, "cpu"), Trainer(cfg, ds, "cpu")
    monkeypatch.setattr(Trainer, "graphed",
                        property(lambda self: self is graph))
    gen = lambda: [torch.Generator().manual_seed(5),
                   torch.Generator().manual_seed(6)]
    if members:
        runs = [EnsembleTrainer(eager), EnsembleTrainer(graph)]
        states = [r.init_states([1, 2]) for r in runs]
        epochs = lambda r, s, g, n: r.train_epochs(s, g, n)
    else:
        runs = [eager, graph]
        states = [r.init_state(1) for r in runs]
        epochs = lambda r, s, g, n: r.train_epochs(s, g[0], n)
    assert runs[1].graphed and not runs[0].graphed
    gens = [gen(), gen()]
    for phase in range(3):
        ms = []
        for i, r in enumerate(runs):
            states[i], m = epochs(r, states[i], gens[i], 2)
            ms.append(m)
        for key in ("d_loss", "g_loss", "train_ade", "train_fde", "steps"):
            np.testing.assert_array_equal(ms[0][key], ms[1][key], key)
        if members:
            for m in range(2):
                _assert_same(ensemble_mod.member_state(states[0], m),
                             ensemble_mod.member_state(states[1], m),
                             f"phase {phase} member {m}")
        else:
            _assert_same(states[0], states[1], f"phase {phase}")
        # the state replaced: a rescue's fresh D, then a transplanted clock
        for i in range(2):
            if phase == 0 and not members:
                states[i] = reinit_discriminator(
                    states[i], runs[i].cfg, torch.Generator().manual_seed(9))
            elif phase == 1:
                states[i] = transplant_schedule_clock(states[i], states[i])
    # solo: two outcomes a binding, three bindings; members: one outcome,
    # bound anew after the transplant only
    assert len(captures) == (2 if members else 6)
