"""The port's multi-seed ensemble (socialways_torch/engine/ensemble.py,
``gan_step(..., members=True)``) against solo runs of the port and against
socialways_tpu's ``EnsembleTrainer`` and ``jax.vmap`` of its ``gan_step``;
the mesh refusals; the host helpers of ``utils``.  The member axis of the
social-attention wrappers, and the card, are in test_torch_members.py
(no JAX); R1, the extra G losses, the serial rollout, accumulation, remat
and bf16 in member mode are in test_torch_member_variants.py.

Tolerances.  A member equals its solo run up to float reassociation of the
batched products: metrics, eval and parameters at rel 2e-4 over epochs
(JAX's own bound, tests/test_engine.py:944-951).  One step against JAX:
f32 rtol 1e-4 / atol 1e-5 on losses and metrics, updated parameters and
moments at atol 1e-5 plus 1e-3 of the leaf's scale with each parameter's
change held at atol 1e-2 * lr (test_torch_train_step.py's rule).

The ensemble's batched CPU products run one torch thread here: under the
suite's parallel workers a multi-threaded batched product oversubscribes
the cores (tens of times slower, same values)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.engine import EnsembleTrainer as JaxEnsemble
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.engine import member_state as jax_member_state
from socialways_tpu.engine import stack_states as jax_stack_states
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_tpu.io.checkpoint import _flatten
from socialways_tpu.io.checkpoint import restore_checkpoint as jax_restore
from socialways_tpu.utils import learning_utils as jlearn
from socialways_tpu.utils import math_utils as jmath
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset
from socialways_torch.data.toy import make_toy_npz_arrays
from socialways_torch.engine import (EnsembleTrainer, Trainer, gan_step,
                                     member_state, stack_states)
from socialways_torch.engine.ensemble import stack_draws
from socialways_torch.engine.train_step import draw_step, init_train_state
from socialways_torch.io.checkpoint import (flatten_state, save_checkpoint,
                                            train_state_from_jax)
from socialways_torch.utils import learning_utils as tlearn
from socialways_torch.utils import math_utils as tmath
from test_torch_gan_variants import jax_draws
from test_torch_train_step import (ATOL, LOO, RTOL, assert_state_close,
                                   jax_init, make_chunk, to_torch)

H = 16
#: JAX's own ensemble test configuration (tests/test_engine.py:931-932)
JAX_TEST = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                batch_size=64, n_unrolling_steps=1, seed=0)
#: the robust1 base of benchmarks/coverage_ensemble.py:88-93 at the test
#: width, with the overrides its usage documents (:6-21) and spectral norm
ROBUST1 = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
               n_past=8, n_next=12, n_unrolling_steps=1, lr_d=5e-4,
               latent_code_type="categorical", n_latent_codes=3,
               loss_info_w=2.0, d_lr_decay_rate=0.7, d_lr_decay_steps=1,
               d_input_noise=0.05, d_input_noise_steps=40,
               spectral_norm=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ensemble") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays())
    return path


def _rel_close(got, want, rel, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel,
                               atol=0, err_msg=what)


# ----------------------------------------------------- members = solo runs
def test_torch_ensemble_members_match_solo_runs(toy_npz):
    """JAX's own ensemble test on the port: 2 seeds x 3 epochs, each
    member's metrics, eval and parameters against its solo run."""
    tr = Trainer(TrainConfig(**JAX_TEST), load_npz_dataset(toy_npz), "cpu")
    ens = EnsembleTrainer(tr)
    seeds = [0, 1]
    states = ens.init_states(seeds)
    gens = [torch.Generator().manual_seed(100 + s) for s in seeds]
    states, m = ens.train_epochs(states, gens, n=3)
    ev = ens.evaluate(states, seeds, n_gen_samples=4)
    assert m["steps"] == 3 * tr.n_steps_per_epoch
    for i, seed in enumerate(seeds):
        solo, ms = tr.train_epochs(tr.init_state(seed),
                                   torch.Generator().manual_seed(100 + seed),
                                   n=3)
        for key in ("d_loss", "g_loss", "train_ade", "train_fde"):
            _rel_close(m[key][i], ms[key], 2e-4, key)
        ev_solo = tr.evaluate(solo.g, seed, n_gen_samples=4)
        for key in ev_solo:
            _rel_close(ev[i][key], ev_solo[key], 2e-4, key)
        got, want = flatten_state(member_state(states, i)), flatten_state(solo)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                       atol=1e-6, err_msg=key)
    assert m["g_loss"][0] != m["g_loss"][1]       # genuinely different models


#: one member-batched step against the members' solo steps, for the loo
#: recipe, the robust1 base with its documented overrides and
#: spectral norm, a scene window, and the variants that need no extra
#: machinery under vmap (the others: test_torch_member_variants.py)
MEMBER_VARIANTS = {
    "loo": LOO,
    "robust1_sn": ROBUST1,
    "loo_max_scene": dict(LOO, max_scene_size=9),
    "unroll0_gaussian_l2": dict(LOO, n_unrolling_steps=0,
                                noise_dist="gaussian", use_l2_loss=True),
    "unroll3_reference_restore": dict(LOO, n_unrolling_steps=3,
                                      d_restore="reference"),
    "lstm_decoder_clip": dict(LOO, decoder="lstm", grad_clip=0.05),
    "pac_mb_std": dict(ROBUST1, pac=2, mb_std=True),
    "ratio_ramp_warmup": dict(LOO, d_update_every=2, loss_info_w_end=1.0,
                              loss_info_w_steps=4, lr_warmup_steps=3),
}


@pytest.mark.parametrize("variant", sorted(MEMBER_VARIANTS))
def test_torch_member_step_matches_solo_steps(variant):
    cfg = TrainConfig(**MEMBER_VARIANTS[variant])
    n, seeds = 40, [3, 4, 5]
    solos = [init_train_state(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in seeds]
    stacked = stack_states(solos)
    gens = [torch.Generator().manual_seed(50 + s) for s in seeds]
    for step in range(2):
        batch = to_torch(make_chunk(10 * step + 1, n=n))
        draws = [draw_step(n, cfg, g) for g in gens]
        stacked, m = gan_step(stacked, batch, stack_draws(draws), cfg,
                              members=True)
        for i in range(len(seeds)):
            solos[i], ms = gan_step(solos[i], batch, draws[i], cfg)
            for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
                np.testing.assert_allclose(
                    float(getattr(m, name)[i]), float(getattr(ms, name)),
                    rtol=RTOL, atol=ATOL, err_msg=f"{variant} {name}")
            assert int(m.n_samples[i]) == int(ms.n_samples)
    for i, solo in enumerate(solos):
        got, want = flatten_state(member_state(stacked, i)), flatten_state(
            solo)
        for key in want:
            tol = ATOL + 1e-3 * float(np.abs(want[key]).max())
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=tol, err_msg=f"{variant} {key}")
    assert (stacked.g_opt.count == solos[0].g_opt.count).all()


# ------------------------------------------------------------------ vs JAX
@pytest.mark.parametrize("flags", [LOO, ROBUST1], ids=["loo", "robust1_sn"])
def test_torch_member_step_matches_jax_vmap_gan_step(flags):
    """One member-batched step equals ``jax.vmap`` of JAX's gan_step over
    the stacked JAX states, each member under its own JAX draws."""
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    seeds, n = [7, 8], 32
    j0 = jax_stack_states([jax_init(jax.random.PRNGKey(s), jcfg)
                           for s in seeds])
    b = make_chunk(9, n=n)
    keys = jnp.stack([jax.random.PRNGKey(20 + s) for s in seeds])
    step = jax.jit(jax.vmap(lambda s, bb, k: jax_gan_step(s, bb, k, jcfg),
                            in_axes=(0, None, 0)))
    j1, jm = step(j0, {a: jnp.asarray(v) for a, v in b.items()}, keys)
    j0, j1, jm = jax.device_get((j0, j1, jm))
    state = stack_states([
        train_state_from_jax(jax_member_state(j0, i), tcfg, "cpu")
        for i in range(len(seeds))])
    olds = [{k: v.copy() for k, v in flatten_state(
        member_state(state, i)).items()} for i in range(len(seeds))]
    draws = stack_draws([jax_draws(k, n, jcfg) for k in keys])
    state, m = gan_step(state, to_torch(b), draws, tcfg, members=True)
    for i in range(len(seeds)):
        assert_state_close(member_state(state, i), jax_member_state(j1, i),
                           tag=f"member {i}", t_old=olds[i],
                           j_old=jax_member_state(j0, i), cfg=tcfg)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(float(getattr(m, name)[i]),
                                       float(getattr(jm, name)[i]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        assert int(m.n_samples[i]) == int(jm.n_samples[i])


def test_torch_ensemble_evaluate_matches_jax_ensemble(toy_npz):
    """``evaluate`` under JAX's noise equals JAX's EnsembleTrainer.evaluate
    for every member (the loo feature set: the social attention runs)."""
    flags = dict(LOO, batch_size=64)
    jtr = JaxTrainer(JaxConfig(**flags), jax_load(toy_npz))
    jens = JaxEnsemble(jtr)
    seeds, k = [1, 2], 6
    jstates = jens.init_states(seeds)
    rngs = jnp.stack([jax.random.PRNGKey(30 + s) for s in seeds])
    want = jens.evaluate(jstates, rngs, n_gen_samples=k)

    tr = Trainer(TrainConfig(**flags), load_npz_dataset(toy_npz), "cpu")
    n_chunks, width = tr.test_packed.n_chunks, tr.test_packed.width
    assert n_chunks == jtr.test_packed.n_chunks
    keys = jax.vmap(lambda r: jax.random.split(r, n_chunks))(rngs)
    noises = [torch.from_numpy(np.array(jax.vmap(
        lambda kk: jax.random.uniform(kk, (k, width, H // 2)))(keys[:, c])))
        for c in range(n_chunks)]
    js = jax.device_get(jstates)
    state = stack_states([train_state_from_jax(jax_member_state(js, i),
                                               tr.cfg, "cpu")
                          for i in range(len(seeds))])
    got = EnsembleTrainer(tr).evaluate(state, seeds, n_gen_samples=k,
                                       noises=noises)
    assert len(got) == len(want) == len(seeds)
    for g, w in zip(got, want):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-4), key


def test_torch_ensemble_coverage_matches_solo_coverage(toy_npz):
    """Per-member coverage equals the CLI's solo ``_coverage`` of each
    member under the member's seed."""
    from socialways_torch.cli.main import _coverage
    cfg = TrainConfig(**dict(JAX_TEST, n_unrolling_steps=0,
                             n_gen_samples=4))
    tr = Trainer(cfg, load_npz_dataset(toy_npz), "cpu")
    ens = EnsembleTrainer(tr)
    seeds = [0, 1]
    states, _ = ens.train_epochs(
        ens.init_states(seeds),
        [torch.Generator().manual_seed(s) for s in seeds], n=1)
    covs = ens.coverage(states, seeds)
    assert len(covs) == 2
    for i, s in enumerate(seeds):
        g = member_state(states, i).g
        want = _coverage(g, tr.dataset, tr.cfg, 4, s, "cpu")
        assert 0.0 <= covs[i] <= 1.0
        assert covs[i] == pytest.approx(want, abs=1e-12)


# ------------------------------------------------ state stacking, checkpoints
def test_torch_stack_and_member_state_round_trip():
    cfg = TrainConfig(**dict(LOO, d_lr_decay_rate=0.5, d_lr_decay_steps=2))
    states = [init_train_state(cfg, torch.Generator().manual_seed(s), "cpu")
              for s in (0, 1, 2)]
    stacked = stack_states(states)
    flat = flatten_state(stacked)
    for i, s in enumerate(states):
        want = flatten_state(s)
        got = flatten_state(member_state(stacked, i))
        assert sorted(got) == sorted(want) == sorted(flat)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            if not key.endswith(".count"):
                np.testing.assert_array_equal(flat[key][i], want[key])
    # the stack and its members are copies: changing one leaves the
    # others as they were
    before = flatten_state(member_state(stacked, 0))
    with torch.no_grad():
        for p in stacked.g.parameters():
            p.add_(1.0)
    after = flatten_state(member_state(stacked, 0))
    assert any(not np.array_equal(before[k], after[k]) for k in before)
    solo = flatten_state(states[0])
    for key in before:
        np.testing.assert_array_equal(solo[key], before[key], err_msg=key)


def test_torch_member_checkpoint_restores_in_jax(toy_npz, tmp_path):
    """A member of a port ensemble, saved by ``io.checkpoint``, restores in
    JAX and equals JAX's ``member_state`` of the same stacked JAX state
    (both sides loaded from one JAX init)."""
    jcfg, tcfg = JaxConfig(**ROBUST1), TrainConfig(**ROBUST1)
    js = jax.device_get(jax_stack_states(
        [jax_init(jax.random.PRNGKey(s), jcfg) for s in (11, 12)]))
    state = stack_states([train_state_from_jax(jax_member_state(js, i),
                                               tcfg, "cpu")
                          for i in range(2)])
    template = jax_init(jax.random.PRNGKey(0), jcfg)
    for i in range(2):
        path = str(tmp_path / f"member{i}.npz")
        save_checkpoint(path, member_state(state, i), 5,
                        torch.Generator().manual_seed(i), None, tcfg)
        restored, epoch, _, _ = jax_restore(path, template)
        assert epoch == 5
        got = _flatten(jax.device_get(restored))
        want = _flatten(jax_member_state(js, i))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------- refusals
def test_torch_ensemble_refuses_a_mesh_and_differing_counts(toy_npz):
    """JAX's refusals (socialways_tpu/engine/ensemble.py:58-77): a trainer
    that has a mesh, and members that do not divide over the mesh; and
    members at different counts, which are taken, each on its own clock."""
    from socialways_torch.parallel import Mesh
    mesh = Mesh((2,), ("data",), 0, torch.device("cpu"))
    ds = load_npz_dataset(toy_npz)
    with pytest.raises(ValueError, match="wraps a SINGLE-DEVICE trainer"):
        EnsembleTrainer(Trainer(TrainConfig(**JAX_TEST), ds, "cpu", mesh))
    tr = Trainer(TrainConfig(**JAX_TEST), ds, "cpu")
    with pytest.raises(ValueError, match="3 ensemble members not divisible "
                                         "by the 2-device mesh"):
        EnsembleTrainer(tr, mesh=mesh).init_states([0, 1, 2])
    # members at different counts (0 and 3) are taken, each on its own
    # clock: the member step equals jax.vmap of JAX's gan_step on the same
    # stacked state, with lr decay and the D/G ratio on (member 0's D
    # phase is due, member 1's is not)
    flags = dict(LOO, lr_decay_rate=0.9, lr_decay_steps=2, d_update_every=2)
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    n = 32
    solo = jax.jit(lambda st, bb, k: jax_gan_step(st, bb, k, jcfg))
    ja, jb = (jax_init(jax.random.PRNGKey(s), jcfg) for s in (7, 8))
    for i in range(3):
        jb = solo(jb, {k: jnp.asarray(v) for k, v in
                       make_chunk(40 + i, n=n).items()},
                  jax.random.PRNGKey(50 + i))[0]
    j0 = jax_stack_states([ja, jb])
    batch = make_chunk(9, n=n)
    keys = jnp.stack([jax.random.PRNGKey(20 + s) for s in (7, 8)])
    step = jax.jit(jax.vmap(lambda st, bb, k: jax_gan_step(st, bb, k, jcfg),
                            in_axes=(0, None, 0)))
    j1, jm = step(j0, {k: jnp.asarray(v) for k, v in batch.items()}, keys)
    j0, j1, jm = jax.device_get((j0, j1, jm))
    state = stack_states([train_state_from_jax(jax_member_state(j0, i),
                                               tcfg, "cpu")
                          for i in range(2)])
    assert state.g_opt.count.tolist() == [0, 3]
    olds = [{k: v.copy() for k, v in flatten_state(
        member_state(state, i)).items()} for i in range(2)]
    state, m = gan_step(state, to_torch(batch),
                        stack_draws([jax_draws(k, n, jcfg) for k in keys]),
                        tcfg, members=True)
    for i in range(2):
        assert_state_close(member_state(state, i), jax_member_state(j1, i),
                           tag=f"member {i}", t_old=olds[i],
                           j_old=jax_member_state(j0, i), cfg=tcfg)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(float(getattr(m, name)[i]),
                                       float(getattr(jm, name)[i]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
    assert state.g_opt.count.tolist() == [1, 4]
    assert state.d_opt.count.tolist() == [2, 4]


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("fn", ["cart2pol", "pol2cart", "norm", "unit"])
def test_torch_math_utils_match_jax(fn):
    rng = np.random.RandomState(3)
    a, b = rng.randn(7, 5), rng.randn(7, 5)
    if fn in ("cart2pol", "pol2cart"):
        got, want = getattr(tmath, fn)(a, b), getattr(jmath, fn)(a, b)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    else:
        v = np.concatenate([rng.randn(6, 2), np.zeros((1, 2))])
        np.testing.assert_array_equal(getattr(tmath, fn)(v),
                                      getattr(jmath, fn)(v))


def test_torch_learning_utils_match_jax():
    for args in [(), (0.01, 0.5, 7)]:
        got, want = tlearn.step_decay_lr(*args), jlearn.step_decay_lr(*args)
        assert [got(e) for e in range(0, 400, 13)] == [want(e) for e in
                                                       range(0, 400, 13)]
    got = tlearn.make_step_decay_optax(0.002, 0.9, 11)
    want = jlearn.make_step_decay_optax(0.002, 0.9, 11)
    assert [got(c) for c in range(100)] == [want(c) for c in range(100)]
