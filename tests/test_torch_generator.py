"""socialways_torch generator and K-sample rollout against socialways_tpu,
with the loo model's features (social attention, agent frame, world-frame
social states).  Params come from JAX ``init_generator`` through the weight
bridge; the noise is drawn by JAX and passed in."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.eval.metrics import eval_chunk as jax_eval_chunk
from socialways_tpu.eval.metrics import k_sample_rollout as jax_k_rollout
from socialways_tpu.models import generator_rollout as jax_rollout
from socialways_tpu.models import init_generator as jax_init_generator
from socialways_tpu.ops.traj import canonicalize_for_rollout as jax_canon
from socialways_torch.config import TrainConfig
from socialways_torch.eval.metrics import eval_chunk, k_sample_rollout
from socialways_torch.io.checkpoint import generator_params_from_jax
from socialways_torch.models.generator import (generator_rollout,
                                               init_generator)
from socialways_torch.ops.traj import canonicalize_for_rollout

RTOL, ATOL = 1e-4, 1e-5
H = 16
FLAGS = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
             n_past=8, n_next=12)


def _models(seed, **flags):
    jcfg = JaxConfig(**FLAGS, **flags)
    tcfg = TrainConfig(**FLAGS, **flags)
    jparams = jax_init_generator(jax.random.PRNGKey(seed), jcfg)
    gen = init_generator(tcfg, device="cpu")
    gen.load_state_dict(generator_params_from_jax(jax.device_get(jparams)))
    return jcfg, tcfg, jparams, gen


def _chunk(seed, n=48):
    """Random-walk observations in scenes of 2-9 agents, a padded tail."""
    rng = np.random.RandomState(seed)
    steps = rng.randn(n, 20, 2).astype(np.float32) * 0.05
    traj = np.cumsum(steps, axis=1) + rng.rand(n, 1, 2).astype(np.float32)
    sizes, ids = [], np.full(n, -1, np.int32)
    row = 0
    while row < n - 6:
        s = min(int(rng.randint(2, 10)), n - 6 - row)
        ids[row:row + s] = len(sizes)
        sizes.append(s)
        row += s
    return traj[:, :8], traj[:, 8:], ids


def test_torch_weight_bridge_keeps_every_jax_leaf():
    _, _, jparams, gen = _models(0, use_social=True)
    names = dict(gen.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(names) == len(leaves)
    for path, leaf in leaves:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                        for p in path)
        np.testing.assert_array_equal(names[name].detach().numpy(),
                                      np.asarray(leaf))


@torch.no_grad()
@pytest.mark.parametrize("agent_frame", [False, True])
def test_torch_generator_rollout_social_matches_jax(agent_frame):
    _, _, jparams, gen = _models(1, use_social=True, agent_frame=agent_frame)
    obsv, _, ids = _chunk(2)
    noise = np.random.RandomState(3).rand(len(obsv), H // 2).astype(
        np.float32)
    o_in, _, sx4 = jax_canon(jnp.asarray(obsv), agent_frame, True)
    want = jax_rollout(jparams, o_in, jnp.asarray(noise), 12,
                       jnp.asarray(ids), use_social=True, social_states=sx4)
    to_in, _, tsx4 = canonicalize_for_rollout(torch.from_numpy(obsv),
                                              agent_frame, True)
    got = generator_rollout(gen, to_in, torch.from_numpy(noise), 12,
                            torch.from_numpy(ids), use_social=True,
                            social_states=tsx4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _loo_flags():
    return dict(use_social=True, agent_frame=True, g_ema_decay=0.999)


def test_torch_k_sample_rollout_loo_matches_jax():
    jcfg, tcfg, jparams, gen = _models(4, **_loo_flags())
    obsv, _, ids = _chunk(5)
    k, key = 5, jax.random.PRNGKey(6)
    want = jax_k_rollout(jparams, jnp.asarray(obsv), jnp.asarray(ids), key,
                         k, jcfg)
    noise = jax.random.uniform(key, (k, len(obsv), jcfg.noise_len))
    got = k_sample_rollout(gen, torch.from_numpy(obsv),
                           torch.from_numpy(ids), k, tcfg,
                           noise=torch.from_numpy(np.array(noise)))
    assert got.shape == (k, len(obsv), 12, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_torch_eval_chunk_loo_matches_jax():
    jcfg, tcfg, jparams, gen = _models(7, **_loo_flags())
    obsv, preds, ids = _chunk(8)
    batch = {"obsvs": obsv, "preds": preds, "scene_ids": ids,
             "valid": ids >= 0}
    k, key = 6, jax.random.PRNGKey(9)
    want = jax_eval_chunk(jparams, {a: jnp.asarray(b)
                                    for a, b in batch.items()}, key, k, jcfg)
    noise = jax.random.uniform(key, (k, len(obsv), jcfg.noise_len))
    got = eval_chunk(gen, {a: torch.from_numpy(b) for a, b in batch.items()},
                     k, tcfg, noise=torch.from_numpy(np.array(noise)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL, atol=ATOL)


def test_torch_k_sample_rollout_draws_from_generator():
    _, tcfg, _, gen = _models(10, use_social=True)
    obsv, _, ids = _chunk(11, n=16)
    run = lambda seed: k_sample_rollout(
        gen, torch.from_numpy(obsv), torch.from_numpy(ids), 3, tcfg,
        torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
