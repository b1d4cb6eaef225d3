"""The ensemble's member step (``gan_step(..., members=True)``) on the eight
configurations that need more than a plain ``vmap`` of the solo loss: R1
(an input gradient inside the loss), the variety, mode-seeking and
diversity losses and the serial rollout (the G phase's recomputed
rollouts), micro-chunk accumulation, step rematerialization and bf16.
Each against the members' solo steps, and against ``jax.vmap`` of JAX's
``gan_step`` over the stacked JAX states; a witness that ``remat_steps``
really recomputes in member mode; ``EnsembleTrainer`` end to end (epoch,
evaluate, coverage) in bf16 and under accumulation + remat + R1; and a
member step on the CPU's crowd forms, whose blocks are rematerialized.

Tolerances.  A member against its solo step: test_torch_ensemble.py's
rule (losses and metrics at rtol 1e-4 / atol 1e-5, parameters and moments
at atol 1e-5 plus 1e-3 of the leaf's scale).  Against JAX: f32 rtol 1e-4 /
atol 1e-5 with each parameter's change at atol 1e-2 * lr
(test_torch_train_step.py); bf16 metrics at ``assert_bf16_close``'s
bounds against JAX's bf16 step on its Pallas path in interpret mode
(test_torch_bf16.py), JAX's float32 step setting the scale.

The JAX side keeps two members at n = 32 (one compile a case)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.engine import member_state as jax_member_state
from socialways_tpu.engine import stack_states as jax_stack_states
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_torch.config import TrainConfig
from socialways_torch.engine import gan_step, member_state, stack_states
from socialways_torch.engine.ensemble import stack_draws
from socialways_torch.engine.train_step import (draw_step, eval_params,
                                                init_train_state)
from socialways_torch.io.checkpoint import (flatten_state,
                                            train_state_from_jax)
from socialways_torch.ops import lstm as tlstm
from socialways_torch.models import generator as tgen
from test_torch_bf16 import LOO16, _PallasInterpret, assert_bf16_close
from test_torch_gan_variants import jax_draws
from test_torch_train_step import (ATOL, LOO, RTOL, assert_state_close,
                                   jax_init, make_chunk, to_torch)

#: one configuration per field the ensemble once refused, on the loo
#: feature set (agent frame, social attention, EMA, D instance noise)
FIELDS = {
    "r1_gamma": dict(LOO, r1_gamma=1.0),
    "use_variety_loss": dict(LOO, use_variety_loss=True, variety_k=5),
    "ms_weight": dict(LOO, ms_weight=0.1),
    "ds_weight": dict(LOO, ds_weight=0.1, ds_k=4),
    "serial_rollout": dict(LOO, serial_rollout=True),
    "grad_accum": dict(LOO, grad_accum=2),
    "remat_steps": dict(LOO, remat_steps=True),
    "compute_dtype": dict(LOO, compute_dtype="bfloat16"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_torch_member_variant_matches_solo_steps(field):
    """Two member steps of three seeds against each member's solo steps
    under the same draws."""
    cfg = TrainConfig(**FIELDS[field])
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
                    rtol=RTOL, atol=ATOL, err_msg=f"{field} {name}")
            assert int(m.n_samples[i]) == int(ms.n_samples)
    for i, solo in enumerate(solos):
        got, want = flatten_state(member_state(stacked, i)), flatten_state(
            solo)
        assert sorted(got) == sorted(want)
        for key in want:
            tol = ATOL + 1e-3 * float(np.abs(want[key]).max())
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=tol, err_msg=f"{field} {key}")
    assert (stacked.g_opt.count == solos[0].g_opt.count).all()
    assert solos[0].g_opt.count == 2


def _jax_vmap_step(flags, j0, batch, keys, dtype=None):
    """``jax.vmap`` of JAX's gan_step over the stacked states ``j0``, each
    member under its key; with ``dtype``, on the Pallas path in interpret
    mode, compiled so that each bf16 op rounds as torch's do."""
    jcfg = JaxConfig(**flags) if dtype is None else JaxConfig(
        **flags, use_pallas=True, compute_dtype=dtype)
    jb = {a: jnp.asarray(v) for a, v in batch.items()}
    step = jax.jit(jax.vmap(lambda s, bb, k: jax_gan_step(s, bb, k, jcfg),
                            in_axes=(0, None, 0)))
    if dtype is None:
        return jax.device_get(step(j0, jb, keys))
    with _PallasInterpret():
        compiled = step.lower(j0, jb, keys).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return jax.device_get(compiled(j0, jb, keys))


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_torch_member_variant_matches_jax_vmap_gan_step(field):
    """One member step of two members against ``jax.vmap`` of JAX's
    gan_step, every member under its own JAX draws."""
    bf16 = field == "compute_dtype"
    # bf16 at test_torch_bf16.py's width; JAX's dtype is set per run
    flags = LOO16 if bf16 else FIELDS[field]
    seeds, n = [7, 8], 32
    jcfg = JaxConfig(**flags)
    tcfg = TrainConfig(**dict(flags, compute_dtype="bfloat16") if bf16
                       else flags)
    j0 = jax.device_get(jax_stack_states(
        [jax_init(jax.random.PRNGKey(s), jcfg) for s in seeds]))
    b = make_chunk(9, n=n)
    keys = jnp.stack([jax.random.PRNGKey(20 + s) for s in seeds])
    state = stack_states([
        train_state_from_jax(jax_member_state(j0, i), tcfg, "cpu")
        for i in range(len(seeds))])
    olds = [{k: v.copy() for k, v in flatten_state(
        member_state(state, i)).items()} for i in range(len(seeds))]
    draws = stack_draws([jax_draws(k, n, jcfg) for k in keys])
    state, m = gan_step(state, to_torch(b), draws, tcfg, members=True)
    names = ("d_loss", "g_loss", "ade_sum", "fde_sum")
    if bf16:
        _, m16 = _jax_vmap_step(flags, j0, b, keys, "bfloat16")
        _, m32 = _jax_vmap_step(flags, j0, b, keys, "float32")
        for i in range(len(seeds)):
            for name in names:
                assert_bf16_close(np.float32(getattr(m, name)[i]),
                                  np.float32(getattr(m16, name)[i]),
                                  np.float32(getattr(m32, name)[i]),
                                  f"member {i} {name}")
            assert int(m.n_samples[i]) == int(m16.n_samples[i])
        for key, leaf in flatten_state(state).items():
            if not key.endswith(".count"):
                assert leaf.dtype == np.float32, key
        return
    j1, jm = _jax_vmap_step(flags, j0, b, keys)
    for i in range(len(seeds)):
        assert_state_close(member_state(state, i), jax_member_state(j1, i),
                           tag=f"{field} member {i}", t_old=olds[i],
                           j_old=jax_member_state(j0, i), cfg=tcfg)
        for name in names:
            np.testing.assert_allclose(float(getattr(m, name)[i]),
                                       float(getattr(jm, name)[i]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{field} {name}")
        assert int(m.n_samples[i]) == int(jm.n_samples[i])


def test_torch_member_remat_recomputes_steps(monkeypatch):
    """``remat_steps`` in member mode runs every LSTM cell (the encoders'
    steps and the decode's feedback) and every decode step again in the
    backward, for all members in one mapped call, and gives the gradients
    of the run without it (rtol 1e-5)."""
    from socialways_torch.engine import train_step as tstep
    calls = {"cell": 0, "decode": 0}
    grads, take_grads = [], tstep._grads

    def recorded(loss, params):
        out = take_grads(loss, params)
        grads.append([g.detach().clone() for g in out])
        return out
    monkeypatch.setattr(tstep, "_grads", recorded)
    cell, decode = tlstm.lstm_cell, tgen._decoder_fc_apply

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tlstm, "lstm_cell", counted("cell", cell))
    monkeypatch.setattr(tgen, "lstm_cell", counted("cell", cell))
    monkeypatch.setattr(tgen, "_decoder_fc_apply",
                        counted("decode", decode))
    batch = to_torch(make_chunk(3, n=24))
    runs = {}
    for remat in (False, True):
        cfg = TrainConfig(**dict(LOO, n_unrolling_steps=0,
                                 remat_steps=remat))
        stacked = stack_states([init_train_state(
            cfg, torch.Generator().manual_seed(s), "cpu") for s in (1, 2)])
        draws = stack_draws([draw_step(24, cfg, torch.Generator()
                                       .manual_seed(40 + s)) for s in (1, 2)])
        for k in calls:
            calls[k] = 0
        grads.clear()
        gan_step(stacked, batch, draws, cfg, members=True)
        runs[remat] = (dict(calls), list(grads))
    (plain_calls, plain), (remat_calls, got) = runs[False], runs[True]
    # one D update and one G update: the cells of D's encoder (twice), G's
    # encoder and decode feedback, and the 12 decode steps, each run again
    assert remat_calls["cell"] > plain_calls["cell"] > 0, (remat_calls,
                                                            plain_calls)
    assert remat_calls["decode"] > plain_calls["decode"] > 0, (
        remat_calls, plain_calls)
    assert remat_calls["decode"] == 2 * plain_calls["decode"]
    assert len(got) == len(plain) == 2            # D's and G's gradients
    for a, b in zip(got, plain):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                       atol=0)


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    from socialways_torch.data.toy import make_toy_npz_arrays
    path = str(tmp_path_factory.mktemp("member_variants") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays())
    return path


@pytest.mark.parametrize("flags", [
    dict(compute_dtype="bfloat16"),
    dict(grad_accum=2, remat_steps=True, r1_gamma=1.0)],
    ids=["bf16", "accum_remat_r1"])
def test_torch_ensemble_epoch_evaluate_and_coverage_match_solo_runs(
        flags, toy_npz):
    """``EnsembleTrainer`` end to end on a refused-before configuration:
    an epoch, ``evaluate`` and ``coverage`` of each member against the
    solo ``Trainer`` run of its seed (test_torch_ensemble.py's bound, rel
    2e-4; coverage exactly)."""
    from socialways_torch.cli.main import _coverage
    from socialways_torch.data.dataset import load_npz_dataset
    from socialways_torch.engine import EnsembleTrainer, Trainer
    cfg = TrainConfig(hidden_size=16, social_feature_size=16, noise_len=8,
                      batch_size=64, n_unrolling_steps=1, n_gen_samples=4,
                      **flags)
    tr = Trainer(cfg, load_npz_dataset(toy_npz), "cpu")
    ens = EnsembleTrainer(tr)
    seeds = [0, 1]
    states, m = ens.train_epochs(
        ens.init_states(seeds),
        [torch.Generator().manual_seed(100 + s) for s in seeds], n=1)
    ev, covs = ens.evaluate(states, seeds), ens.coverage(states, seeds)
    for i, seed in enumerate(seeds):
        solo, ms = tr.train_epochs(tr.init_state(seed),
                                   torch.Generator().manual_seed(100 + seed),
                                   n=1)
        for key in ("d_loss", "g_loss", "train_ade", "train_fde"):
            np.testing.assert_allclose(m[key][i], ms[key], rtol=2e-4,
                                       err_msg=key)
        want = tr.evaluate(eval_params(solo), seed)
        for key in want:
            np.testing.assert_allclose(ev[i][key], want[key], rtol=2e-4,
                                       err_msg=key)
        assert covs[i] == pytest.approx(
            _coverage(member_state(states, i).g, tr.dataset, tr.cfg, 4,
                      seed, "cpu"), abs=1e-12)


@pytest.mark.parametrize("max_scene, n", [(0, 40), (9, 1100)],
                         ids=["blockwise", "windowed"])
def test_torch_member_step_on_the_cpu_crowd_forms(monkeypatch, max_scene, n):
    """Above the CPU's dense size the social context runs the blockwise
    (no scene window) or, past one window of rows, the windowed form, each
    block rematerialized: a member step with R1 and ``remat_steps`` there
    equals its solo steps (the dense cutoff patched to 16 rows, as
    tests/test_torch_crowd.py reaches the crowd forms at small N)."""
    from socialways_torch.kernels import social_attention as sa
    monkeypatch.setattr(sa, "_DENSE_MAX_AGENTS", 16)
    cfg = TrainConfig(**dict(LOO, max_scene_size=max_scene, r1_gamma=1.0,
                             remat_steps=True))
    seeds = [3, 4]
    solos = [init_train_state(cfg, torch.Generator().manual_seed(s), "cpu")
             for s in seeds]
    stacked = stack_states(solos)
    batch = to_torch(make_chunk(5, n=n, pad=20))
    draws = [draw_step(n, cfg, torch.Generator().manual_seed(60 + s))
             for s in seeds]
    stacked, m = gan_step(stacked, batch, stack_draws(draws), cfg,
                          members=True)
    for i in range(len(seeds)):
        solos[i], ms = gan_step(solos[i], batch, draws[i], cfg)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(
                float(getattr(m, name)[i]), float(getattr(ms, name)),
                rtol=RTOL, atol=ATOL, err_msg=name)
        got, want = flatten_state(member_state(stacked, i)), flatten_state(
            solos[i])
        for key in want:
            tol = ATOL + 1e-3 * float(np.abs(want[key]).max())
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=tol, err_msg=key)
