"""The pieces of socialways_torch's ``gan_step`` variants against
socialways_tpu's on the CPU: gaussian noise, the l2 and variety losses,
PacGAN's label masks and term weights, the discriminator under pac and
minibatch stddev, ``mb_std_feature``, ``spectral_normalize`` and
``spectral_normalize_d`` (values and gradients), the global-norm clip and
Adam behind it, and the host schedules (info-weight ramp, D/G ratio).

Tolerances: f32 rtol 1e-4 / atol 1e-5 on values and gradients (as
test_torch_train_step.py); Adam behind the clip at atol 1e-4 * lr over
twelve updates (as test_torch_lr_schedules.py); the schedules exactly in
float32."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine import losses as jlosses
from socialways_tpu.engine.train_step import \
    make_optimizers as jax_make_optimizers
from socialways_tpu.models import discriminator as jdisc
from socialways_tpu.ops.nn import spectral_normalize as jax_sn
from socialways_torch.config import TrainConfig
from socialways_torch.engine import losses as tlosses
from socialways_torch.engine.train_step import (clip_by_global_norm,
                                                d_phase_due, info_weight,
                                                make_optimizers)
from socialways_torch.io.checkpoint import train_state_from_jax
from socialways_torch.models import discriminator as tdisc
from socialways_torch.ops.nn import spectral_normalize
from test_torch_gan_variants import PLAIN
from test_torch_train_step import ATOL, RTOL, jax_init

t = lambda a: torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().numpy()
                                          if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("code", ["continuous", "categorical"])
def test_torch_gaussian_noise_draws_standard_normal(code):
    """``noise_dist="gaussian"`` draws N(0, 1) where JAX does, with the
    categorical one-hot in the first dims; the statistics of JAX's own
    draw and the port's agree."""
    flags = dict(PLAIN, noise_dist="gaussian", latent_code_type=code,
                 n_latent_codes=3)
    cfg = TrainConfig(**flags)
    z = tlosses.sample_noise((20000,), cfg, torch.Generator().manual_seed(0))
    zj = np.asarray(jlosses.sample_noise(jax.random.PRNGKey(0), 20000,
                                         JaxConfig(**flags)))
    start = 3 if code == "categorical" else 0
    for a in (z.numpy(), zj):
        rest = a[:, start:]
        assert abs(rest.mean()) < 0.02 and abs(rest.std() - 1.0) < 0.02
        assert (rest < 0).mean() == pytest.approx(0.5, abs=0.02)
        if code == "categorical":
            assert set(np.unique(a[:, :3])) == {0.0, 1.0}
            np.testing.assert_array_equal(a[:, :3].sum(1), 1.0)


def test_torch_l2_and_variety_losses_match_jax():
    rng = np.random.RandomState(1)
    k, n = 5, 24
    pk = rng.randn(k, n, 12, 2).astype(np.float32)
    pred = rng.randn(n, 12, 2).astype(np.float32)
    valid = rng.rand(n) > 0.3
    close(tlosses.l2_traj_loss(t(pk[0]), t(pred), t(valid)),
          jlosses.l2_traj_loss(jnp.asarray(pk[0]), jnp.asarray(pred),
                               jnp.asarray(valid)))
    # the variety loss and its gradient (the min picks one draw a row)
    pt = t(pk).requires_grad_(True)
    got = tlosses.variety_loss(pt, t(pred), t(valid))
    (g_got,) = torch.autograd.grad(got, pt)
    want, g_want = jax.value_and_grad(jlosses.variety_loss)(
        jnp.asarray(pk), jnp.asarray(pred), jnp.asarray(valid))
    close(got, want)
    close(g_got, g_want)
    none = torch.zeros(n, dtype=torch.bool)
    assert float(tlosses.variety_loss(t(pk), t(pred), none)) == 0.0


@pytest.mark.parametrize("pac", [1, 2, 4])
def test_torch_pac_label_masks_and_term_weights_match_jax(pac):
    """One label a pack, masked by the packs' validity (a pack with a
    padded row does not count), the info term per sample; the label and
    info terms weighted apart as gradient accumulation weights them."""
    rng = np.random.RandomState(pac)
    n = 24
    valid = np.arange(n) < 21                 # a mixed pack at the tail
    lv = valid.reshape(-1, pac).all(1)
    fake, real = (rng.randn(n // pac, 1).astype(np.float32) for _ in "ab")
    code, noise = rng.randn(n, 2).astype(np.float32), rng.rand(n, 8)
    noise = noise.astype(np.float32)
    zeros = np.full((n, 1), 0.05, np.float32)
    ones = np.full((n, 1), 0.95, np.float32)
    j = jnp.asarray
    for w_label, w_info in ((1.0, 1.0), (0.25, 0.7)):
        kw = dict(w_label=w_label, w_info=w_info)
        close(tlosses.lsgan_d_loss(t(fake), t(real), t(code), t(noise),
                                   t(valid), t(zeros), t(ones), True, 0.5, 2,
                                   label_valid=t(lv), **kw),
              jlosses.lsgan_d_loss(j(fake), j(real), j(code), j(noise),
                                   j(valid), j(zeros), j(ones), True, 0.5, 2,
                                   label_valid=j(lv), **kw))
        close(tlosses.lsgan_g_loss(t(fake), t(code), t(noise), t(valid),
                                   t(ones), True, 0.5, 2, label_valid=t(lv),
                                   **kw),
              jlosses.lsgan_g_loss(j(fake), j(code), j(noise), j(valid),
                                   j(ones), True, 0.5, 2, label_valid=j(lv),
                                   **kw))


def test_torch_mb_std_feature_and_its_gradient_match_jax():
    rng = np.random.RandomState(2)
    p4 = rng.randn(20, 12, 4).astype(np.float32)
    valid = rng.rand(20) > 0.25
    w = rng.randn(20, 1).astype(np.float32)
    pt = t(p4).requires_grad_(True)
    got = tdisc.mb_std_feature(pt, t(valid))
    (g_got,) = torch.autograd.grad((got * t(w)).sum(), pt)
    want = jdisc.mb_std_feature(jnp.asarray(p4), jnp.asarray(valid))
    g_want = jax.grad(lambda x: jnp.sum(
        jdisc.mb_std_feature(x, jnp.asarray(valid)) * jnp.asarray(w)))(
        jnp.asarray(p4))
    assert tuple(got.shape) == (20, 1)
    close(got, want)
    close(g_got, g_want)
    # padded rows take no part in the statistic
    p4b = p4.copy()
    p4b[~valid] = 1e3
    close(tdisc.mb_std_feature(t(p4b), t(valid)), want)


@pytest.mark.parametrize("shape", [(8, 16), (48, 8), (17, 1)])
def test_torch_spectral_normalize_and_its_gradient_match_jax(shape):
    """JAX's 30 power iterations from 1/sqrt(rows): the value and the
    gradient through w (numerator and sigma, u and v held constant)."""
    rng = np.random.RandomState(shape[0])
    w = rng.randn(*shape).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    wt = t(w).requires_grad_(True)
    got = spectral_normalize(wt)
    (g_got,) = torch.autograd.grad((got * t(r)).sum(), wt)
    want = jax_sn(jnp.asarray(w))
    g_want = jax.grad(lambda x: jnp.sum(jax_sn(x) * jnp.asarray(r)))(
        jnp.asarray(w))
    close(got, want)
    close(g_got, g_want)
    top = np.linalg.svd(got.detach().numpy(), compute_uv=False)[0]
    assert top == pytest.approx(1.0, abs=1e-3)


@pytest.fixture(scope="module")
def d_pac_mbstd():
    """A JAX discriminator at pac 2 with the minibatch-stddev input, and the
    port's from the same leaves."""
    flags = dict(PLAIN, pac=2, mb_std=True, spectral_norm=True)
    jstate = jax.device_get(jax_init(jax.random.PRNGKey(4),
                                     JaxConfig(**flags)))
    return jstate.d_params, train_state_from_jax(
        jstate, TrainConfig(**flags), "cpu").d


def test_torch_spectral_normalize_d_matches_jax(d_pac_mbstd):
    jd, d = d_pac_mbstd
    want = jdisc.spectral_normalize_d(jd)
    got = tdisc.spectral_normalize_d(d)
    for block in ("obsv_fc", "pred_fc", "classifier"):
        for i, layer in enumerate(want[block]):
            close(getattr(got, block)[i].w, layer["w"], msg=f"{block}.{i}")
            assert getattr(got, block)[i].b is getattr(d, block)[i].b
    for block in ("obsv_lstm", "latent_dec"):
        assert getattr(got, block) is getattr(d, block)


@pytest.mark.parametrize("normalized", [False, True])
def test_torch_discriminator_under_pac_and_mb_std_matches_jax(d_pac_mbstd,
                                                              normalized):
    """Packs of 2 rows a label, the mb_std scalar in the classifier input
    only, optionally through the normalized weights."""
    jd, d = d_pac_mbstd
    rng = np.random.RandomState(6)
    o4 = rng.randn(16, 8, 4).astype(np.float32)
    p4 = rng.randn(16, 12, 4).astype(np.float32)
    valid = np.arange(16) < 13
    jp = jdisc.spectral_normalize_d(jd) if normalized else jd
    tp = tdisc.spectral_normalize_d(d) if normalized else d
    extra_j = jdisc.mb_std_feature(jnp.asarray(p4), jnp.asarray(valid))
    j_lbl, j_q = jdisc.discriminator_apply(jp, jnp.asarray(o4),
                                           jnp.asarray(p4), False, 2,
                                           extra_j)
    with torch.no_grad():
        extra_t = tdisc.mb_std_feature(t(p4), t(valid))
        t_lbl, t_q = tdisc.discriminator_apply(tp, t(o4), t(p4), False, 2,
                                               extra_t)
    assert tuple(t_lbl.shape) == (8, 1) and tuple(t_q.shape) == (16, 2)
    close(t_lbl, j_lbl)
    close(t_q, j_q)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_torch_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(3)
    leaves = [rng.randn(4, 3).astype(np.float32),
              rng.randn(7).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(x) for x in leaves], optax.EmptyState())
    got = clip_by_global_norm([t(x) for x in leaves], max_norm)
    for g, w in zip(got, want):
        close(g, w)
    if max_norm > 1:                   # under the norm: untouched
        for g, x in zip(got, leaves):
            np.testing.assert_array_equal(g.numpy(), x)


def test_torch_adam_behind_the_clip_matches_optax_chain():
    """``make_optimizers`` under ``grad_clip``: twelve updates against
    optax's ``chain(clip_by_global_norm, adam)`` with a decayed D lr, and
    the same state layout (the clip's empty state first)."""
    flags = dict(grad_clip=0.5, d_lr_decay_rate=0.7, d_lr_decay_steps=2)
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    grads = np.random.RandomState(9).randn(12, 5).astype(np.float32)
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
        assert ts.clipped and js[0] == optax.EmptyState()
        assert ts.count == int(js[1][0].count) == 12


def test_torch_schedules_read_the_count_as_jax():
    """The info ramp in float32 as JAX's traced scalar (:291-300), and the
    D/G ratio with its switch as JAX's ``step % every == 0`` (:551-569)."""
    cfg = TrainConfig(loss_info_w=0.3, loss_info_w_end=1.1,
                      loss_info_w_steps=7)
    for step in range(12):
        frac = jnp.minimum(1.0, jnp.float32(step) / 7)
        want = 0.3 + (1.1 - 0.3) * frac
        assert info_weight(cfg, step) == float(want), step
    assert info_weight(TrainConfig(loss_info_w_end=1.0), 5) == 0.5
    sched = TrainConfig(d_update_every=3, d_update_every_end=2,
                        d_update_every_switch=5)
    for step in range(12):
        every = jnp.where(step < 5, 3, 2)
        assert d_phase_due(sched, step) == bool(step % every == 0), step
    assert [d_phase_due(TrainConfig(d_update_every=2), s)
            for s in range(4)] == [True, False, True, False]
    assert all(d_phase_due(TrainConfig(), s) for s in range(4))
    # an end equal to the start is no schedule (JAX's ratio_scheduled)
    same = TrainConfig(d_update_every=2, d_update_every_end=2,
                       d_update_every_switch=1)
    assert [d_phase_due(same, s) for s in range(4)] == [True, False, True,
                                                          False]
