"""socialways_torch discriminator, losses and ``gan_step`` against
socialways_tpu, with the loo feature set (agent frame, social attention,
EMA, D instance noise annealed to a floor, unroll 1).  Parameters come from
JAX through the weight bridge; every random draw is JAX's own, split from
the step key as ``gan_step`` splits it.

Tolerance: f32 rtol 1e-4 / atol 1e-5 on forward values and losses.  After
an Adam step each parameter has moved by about +-lr * m/sqrt(v); a
gradient element near zero turns float-rounding noise into a visible
change of that ratio, so updated values and moments are compared at atol
1e-5 plus 1e-3 times the leaf's scale.  That allowance is larger than a G
step (lr_g = 1e-4), so each step's change of every G and D parameter (new
minus old) is also held against JAX's change at atol 1e-2 * lr: a missing
update, a wrong sign or a wrong bias correction moves it by about lr."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine import losses as jlosses
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_tpu.engine.train_step import \
    init_train_state as jax_init_train_state
from socialways_tpu.models import discriminator as jdisc
from socialways_tpu.ops.traj import get_traj_4d
from socialways_torch.config import TrainConfig
from socialways_torch.engine import losses as tlosses
from socialways_torch.engine.train_step import (StepDraws, gan_step,
                                                init_train_state,
                                                instance_noise_sigma)
from socialways_torch.io.checkpoint import (flatten_state,
                                            train_state_from_jax)
from socialways_torch.models import discriminator as tdisc
from socialways_torch.ops.traj import obsv_to_4d, pred_to_4d

RTOL, ATOL = 1e-4, 1e-5
H = 16
LOO = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
           n_past=8, n_next=12, agent_frame=True, use_social=True,
           g_ema_decay=0.999, d_input_noise=0.05, d_input_noise_steps=3,
           d_input_noise_floor=0.02)


def jax_init(key, cfg):
    """JAX ``init_train_state``, jitted (eager init takes seconds here)."""
    return jax.jit(jax_init_train_state, static_argnums=1)(key, cfg)


def jax_draws(key, n, cfg) -> StepDraws:
    """The draws JAX's gan_step makes from ``key`` (train_step.py:233,
    282-287, 428-443), as torch tensors."""
    k_noise, k_zero, k_one, _ = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    noise = jax.random.uniform(k_noise, (n, cfg.noise_len))
    zero = jax.random.uniform(k_zero, (), jnp.float32, 0.0, 0.1)
    one = jax.random.uniform(k_one, (), jnp.float32, 0.9, 1.0)
    eps = [None] * 3
    if cfg.d_input_noise > 0:
        kf, kr, kg = jax.random.split(jax.random.fold_in(key, 13), 3)
        eps = [t(jax.random.normal(k, (n, cfg.n_next, 4)))
               for k in (kf, kr, kg)]
    return StepDraws(t(noise), t(zero), t(one), *eps)


def make_chunk(seed, n=40, pad=6, scene_max=9):
    """Random-walk windows in scenes of 2..scene_max agents, padded tail."""
    rng = np.random.RandomState(seed)
    steps = rng.randn(n, 20, 2).astype(np.float32) * 0.05
    traj = np.cumsum(steps, axis=1) + rng.rand(n, 1, 2).astype(np.float32)
    ids = np.full(n, -1, np.int32)
    row, sid = 0, 0
    while row < n - pad:
        s = min(int(rng.randint(2, scene_max + 1)), n - pad - row)
        ids[row:row + s] = sid
        row, sid = row + s, sid + 1
    valid = ids >= 0
    obsv, pred = traj[:, :8].copy(), traj[:, 8:].copy()
    obsv[~valid] = 0.0
    pred[~valid] = 0.0
    return {"obsvs": obsv, "preds": pred, "scene_ids": ids, "valid": valid}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def assert_state_close(tstate, jstate, tag="", t_old=None, j_old=None,
                       cfg=None):
    """Every leaf of the port state against JAX's, counts exactly.  Given
    both states before the step (``t_old`` flattened), each G and D
    parameter's change is held against JAX's at atol 1e-2 * lr."""
    got = flatten_state(tstate)
    from socialways_tpu.io.checkpoint import _flatten
    want = _flatten(jax.device_get(jstate))
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key]
        if key.endswith(".count"):
            assert int(g) == int(w), key
            continue
        tol = ATOL + 1e-3 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=tol,
                                   err_msg=f"{tag} {key}")
    if t_old is None:
        return
    j_prev = _flatten(jax.device_get(j_old))
    for key in want:
        if not key.startswith((".g_params/", ".d_params/")):
            continue
        lr = cfg.lr_g if key.startswith(".g_") else cfg.lr_d
        np.testing.assert_allclose(
            got[key] - t_old[key], np.asarray(want[key]) - j_prev[key],
            rtol=0, atol=1e-2 * lr, err_msg=f"{tag} change of {key}")


@pytest.fixture(scope="module")
def jax_two_steps():
    """Two consecutive JAX gan_steps of the loo feature set on two chunks,
    jitted once."""
    jcfg = JaxConfig(**LOO)
    state0 = jax_init(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(lambda s, b, k: jax_gan_step(s, b, k, jcfg))
    batches = [make_chunk(1), make_chunk(2)]
    keys = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    states, metrics = [state0], []
    for b, k in zip(batches, keys):
        s, m = step(states[-1], {a: jnp.asarray(v) for a, v in b.items()}, k)
        states.append(s)
        metrics.append(jax.device_get(m))
    return jcfg, batches, keys, [jax.device_get(s) for s in states], metrics


def test_torch_discriminator_matches_jax():
    jstate = jax_init(jax.random.PRNGKey(3), JaxConfig(**LOO))
    jd = jstate.d_params
    d = train_state_from_jax(jax.device_get(jstate), TrainConfig(**LOO),
                             "cpu").d
    b = make_chunk(4)
    o4, p4 = get_traj_4d(jnp.asarray(b["obsvs"]), jnp.asarray(b["preds"]))
    p4k = jnp.concatenate([p4, p4 * 0.5])           # two futures per row
    j_code = jax.jit(jdisc.encode_obsv)(jd, o4)
    j_lbl, j_q = jax.jit(jdisc.discriminator_heads)(jd, j_code, p4k)
    to4, tp4 = (obsv_to_4d(torch.from_numpy(b["obsvs"])),
                pred_to_4d(torch.from_numpy(b["obsvs"]),
                           torch.from_numpy(b["preds"])))
    np.testing.assert_allclose(tp4.numpy(), np.asarray(p4), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():
        t_code = tdisc.encode_obsv(d, to4)
        t_lbl, t_q = tdisc.discriminator_heads(d, t_code,
                                               torch.cat([tp4, tp4 * 0.5]))
        a_lbl, a_q = tdisc.discriminator_apply(d, to4, tp4)
    for got, want in [(t_code, j_code), (t_lbl, j_lbl), (t_q, j_q),
                      (a_lbl, j_lbl[:len(tp4)]), (a_q, j_q[:len(tp4)])]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_torch_gan_losses_match_jax():
    rng = np.random.RandomState(5)
    n = 24
    fake, real = rng.randn(n, 1), rng.randn(n, 1)
    code, noise = rng.randn(n, 2), rng.rand(n, 8)
    valid = rng.rand(n) > 0.3
    zeros, ones = np.full((n, 1), 0.07), np.full((n, 1), 0.93)
    a = [x.astype(np.float32) for x in (fake, real, code, noise)]
    j = [jnp.asarray(x) for x in a] + [jnp.asarray(valid)]
    t = [torch.from_numpy(x) for x in a] + [torch.from_numpy(valid)]
    zj, oj = jnp.asarray(zeros, jnp.float32), jnp.asarray(ones, jnp.float32)
    zt, ot = (torch.from_numpy(zeros.astype(np.float32)),
              torch.from_numpy(ones.astype(np.float32)))
    pairs = [
        (tlosses.lsgan_d_loss(t[0], t[1], t[2], t[3], t[4], zt, ot, True,
                              0.5, 2),
         jlosses.lsgan_d_loss(j[0], j[1], j[2], j[3], j[4], zj, oj, True,
                              0.5, 2)),
        (tlosses.lsgan_g_loss(t[0], t[2], t[3], t[4], ot, True, 0.5, 2),
         jlosses.lsgan_g_loss(j[0], j[2], j[3], j[4], oj, True, 0.5, 2)),
        (tlosses.masked_mse(t[2], t[3][:, :2], t[4]),
         jlosses.masked_mse(j[2], j[3][:, :2], j[4])),
        (tlosses.info_loss(t[2], t[3], t[4], 2),
         jlosses.info_loss(j[2], j[3], j[4], 2, "continuous")),
        (tlosses.traj_errors(t[2], t[3][:, 2:4]),
         jlosses.traj_errors(j[2], j[3][:, 2:4])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    empty = torch.zeros(n, dtype=torch.bool)
    assert float(tlosses.masked_mse(t[0], zt, empty)) == 0.0


def test_torch_gan_step_loo_two_steps_match_jax(jax_two_steps):
    jcfg, batches, keys, jstates, jmetrics = jax_two_steps
    tcfg = TrainConfig(**LOO)
    state = train_state_from_jax(jstates[0], tcfg, "cpu")
    for i, (b, k) in enumerate(zip(batches, keys)):
        draws = jax_draws(k, len(b["valid"]), tcfg)
        old = {key: v.copy() for key, v in flatten_state(state).items()}
        state, m = gan_step(state, to_torch(b), draws, tcfg)
        assert_state_close(state, jstates[i + 1], tag=f"step {i}",
                           t_old=old, j_old=jstates[i], cfg=tcfg)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(float(getattr(m, name)),
                                       float(getattr(jmetrics[i], name)),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        assert int(m.n_samples) == int(jmetrics[i].n_samples)
    assert state.g_opt.count == 2 and state.d_opt.count == 4


def test_torch_instance_noise_schedule_matches_jax_formula():
    cfg = TrainConfig(**LOO)
    assert instance_noise_sigma(cfg, 0) == pytest.approx(0.05)
    assert instance_noise_sigma(cfg, 1) == pytest.approx(0.05 * 2 / 3)
    assert instance_noise_sigma(cfg, 3) == pytest.approx(0.02)   # floor
    assert instance_noise_sigma(cfg.replace(d_input_noise_steps=0), 7) == \
        pytest.approx(0.05)
    assert instance_noise_sigma(cfg.replace(d_input_noise=0.0), 0) is None


def test_torch_gan_step_fully_padded_chunk_leaves_state(jax_two_steps):
    _, batches, keys, jstates, _ = jax_two_steps
    tcfg = TrainConfig(**LOO)
    state = train_state_from_jax(jstates[0], tcfg, "cpu")
    before = {k: v.copy() for k, v in flatten_state(state).items()}
    b = dict(batches[0])
    b["valid"] = np.zeros_like(b["valid"])
    b["scene_ids"] = np.full_like(b["scene_ids"], -1)
    state, m = gan_step(state, to_torch(b),
                        jax_draws(keys[0], len(b["valid"]), tcfg), tcfg)
    after = flatten_state(state)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert float(m.d_loss) == 0.0 and int(m.n_samples) == 0


@pytest.mark.parametrize("mode", ["reference", "none"])
def test_torch_gan_step_d_restore_modes_match_jax(mode):
    # the restore is independent of the rollout's features: a plain
    # generator keeps JAX's compile short
    flags = dict(LOO, d_restore=mode, d_input_noise=0.0,
                 d_input_noise_steps=0, d_input_noise_floor=0.0,
                 use_social=False, agent_frame=False, g_ema_decay=0.0)
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    j0 = jax_init(jax.random.PRNGKey(7), jcfg)
    b, key = make_chunk(8, n=32), jax.random.PRNGKey(9)
    j1, jm = jax.jit(lambda s, bb, k: jax_gan_step(s, bb, k, jcfg))(
        j0, {a: jnp.asarray(v) for a, v in b.items()}, key)
    state = train_state_from_jax(jax.device_get(j0), tcfg, "cpu")
    old = {k: v.copy() for k, v in flatten_state(state).items()}
    state, m = gan_step(state, to_torch(b), jax_draws(key, 32, tcfg), tcfg)
    assert_state_close(state, j1, tag=mode, t_old=old, j_old=j0, cfg=tcfg)
    np.testing.assert_allclose(float(m.g_loss), float(jm.g_loss), rtol=RTOL,
                               atol=ATOL)


def test_torch_init_train_state_layout():
    cfg = TrainConfig(**LOO)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    jstate = jax_init(jax.random.PRNGKey(0), JaxConfig(**LOO))
    from socialways_tpu.io.checkpoint import _flatten
    want = _flatten(jax.device_get(jstate))
    got = flatten_state(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
    for a, b in zip(state.g.parameters(), state.g_ema.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
