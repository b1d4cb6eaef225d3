"""The port's public library surface against the JAX package's: every name
a JAX package exports resolves in the port's package of the same name,
and the functions that had no counterpart before (``social_pool``,
``get_traj_4d``, ``social_attention_fused``, ``social_attention_chunked``,
``jitter_generator``, ``checkpoint_exists``, ``make_step_decay_optax``)
compute JAX's values on the same inputs, made from a seed with numpy, with
JAX's parameters brought across by the weight bridge.  JAX's attention
runs its Pallas kernels in interpret mode, as its own tests run them on
the CPU.

Tolerances: rtol 1e-4 / atol 1e-5 on values and gradients (the kernels'
plain versions sum in another order than the Pallas kernels); schedules
and file tests exactly."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.models import init_generator as jax_init_generator
from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.io.checkpoint import (generator_params_from_jax,
                                            train_state_from_jax)
from socialways_torch.models.generator import init_generator
from test_torch_train_step import LOO, jax_init

RTOL, ATOL = 1e-4, 1e-5
H = 16
PACKAGES = ["", "data", "eval", "io", "kernels", "models", "ops", "utils",
            "engine", "parallel", "viz"]


def _jax_exports(package: str):
    module = importlib.import_module(
        "socialways_tpu" + (f".{package}" if package else ""))
    return getattr(module, "__all__", None) or ["TrainConfig"]


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_torch_package_exports_every_jax_name(package):
    """``from socialways_torch.<P> import <N>`` works for every ``N`` in
    ``socialways_tpu.<P>.__all__`` (the root: ``TrainConfig``), and each
    name is in the port package's ``__all__``."""
    name = "socialways_torch" + (f".{package}" if package else "")
    names = _jax_exports(package)
    assert names
    for n in names:
        scope = {}
        exec(f"from {name} import {n}", scope)
        assert scope[n] is not None, n
        if not isinstance(scope[n], str):        # parallel's axis names
            assert callable(scope[n]) or n == "losses", n
    assert set(names) <= set(importlib.import_module(name).__all__)


def test_torch_kernels_social_attention_is_the_module_and_the_function():
    """The module name JAX's package gives to its dispatch function: the
    port's module, which called is ``social_attention``."""
    from socialways_torch.kernels import social_attention as sa
    gen, x4, h, ids = _port_inputs(40, 3)
    with torch.no_grad():
        want = sa.social_attention(gen.feat_mlp, gen.attn_w, x4, h, ids)
        got = sa(gen.feat_mlp, gen.attn_w, x4, h, ids)
    assert hasattr(sa, "social_attention_fwd") and torch.equal(got, want)


def _cfg():
    return dict(hidden_size=H, social_feature_size=H, noise_len=H // 2)


def _generators(seed):
    """JAX generator parameters and the port's generator holding them."""
    jp = jax.device_get(jax.jit(jax_init_generator, static_argnums=1)(
        jax.random.PRNGKey(seed), JaxConfig(**_cfg())))
    gen = init_generator(TrainConfig(**_cfg()), device="cpu")
    gen.load_state_dict(generator_params_from_jax(jp))
    return jp, gen


def _inputs(n, seed, scene=7, pad=5):
    """Sorted, contiguous scenes of at most ``scene`` rows, a padded
    tail."""
    rng = np.random.RandomState(seed)
    x4 = rng.randn(n, 4).astype(np.float32)
    h = rng.randn(n, H).astype(np.float32)
    ids = (np.arange(n) // scene).astype(np.int32)
    ids[n - pad:] = -1
    return x4, h, ids


def _port_inputs(n, seed):
    _, gen = _generators(seed)
    return (gen,) + tuple(torch.from_numpy(a) for a in _inputs(n, seed))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_torch_social_pool_matches_jax():
    from socialways_tpu.ops.nn import mlp_apply as jax_mlp
    from socialways_tpu.ops.social import social_pool as jax_social_pool
    from socialways_torch.ops import social_pool
    from socialways_torch.ops.nn import mlp_apply
    jp, gen = _generators(11)
    x4, h, ids = _inputs(45, 11)
    want = jax_social_pool(jp["attn_w"],
                           lambda f: jax_mlp(jp["feat_mlp"], f),
                           jnp.asarray(x4), jnp.asarray(h), jnp.asarray(ids))
    with torch.no_grad():
        got = social_pool(gen.attn_w, lambda f: mlp_apply(gen.feat_mlp, f),
                          torch.from_numpy(x4), torch.from_numpy(h),
                          torch.from_numpy(ids))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got[-5:].numpy(), 0.0)


def test_torch_get_traj_4d_matches_jax():
    from socialways_tpu.ops.traj import get_traj_4d as jax_get_traj_4d
    from socialways_torch.ops import get_traj_4d
    rng = np.random.RandomState(4)
    obsv = rng.randn(6, 8, 2).astype(np.float32)
    pred = rng.randn(6, 12, 2).astype(np.float32)
    _close(get_traj_4d(torch.from_numpy(obsv)).numpy(),
           jax_get_traj_4d(jnp.asarray(obsv)))
    got = get_traj_4d(torch.from_numpy(obsv), torch.from_numpy(pred))
    want = jax_get_traj_4d(jnp.asarray(obsv), jnp.asarray(pred))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _attention_grads(fn, gen, x4, h, ids):
    """``fn``'s output and the gradient of sum(sin(out)) with respect to
    x4, h and the feature-MLP and attention weights (JAX's names)."""
    x4 = torch.from_numpy(x4).requires_grad_()
    h = torch.from_numpy(h).requires_grad_()
    out = fn(gen.feat_mlp, gen.attn_w, x4, h, torch.from_numpy(ids))
    gen.zero_grad()
    torch.sin(out).sum().backward()
    grads = {"x4": x4.grad, "h": h.grad}
    for name, p in gen.named_parameters():
        if name.startswith(("feat_mlp", "attn_w")):
            grads[name] = p.grad
    return out.detach(), grads


def _jax_attention_grads(fn, jp, x4, h, ids):
    p = {"feat_mlp": jp["feat_mlp"], "attn_w": jp["attn_w"]}

    def loss(p, x, hh):
        out = fn(p, x, hh, jnp.asarray(ids))
        return jnp.sum(jnp.sin(out)), out

    (_, out), (dp, dx, dh) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(p, jnp.asarray(x4),
                                               jnp.asarray(h))
    grads = {"x4": dx, "h": dh}
    grads.update(generator_params_from_jax(jax.device_get(dp)))
    return out, grads


@pytest.mark.parametrize("entry", ["fused", "chunked"])
def test_torch_fused_and_chunked_attention_match_jax(entry, monkeypatch):
    """``social_attention_fused`` (the dense plain form on the CPU) against
    JAX's fused kernel, and ``social_attention_chunked`` (the windowed plain
    form) against JAX's chunked kernel over row chunks with scene halos:
    the output and the gradients of x4, h and every weight."""
    from socialways_tpu.kernels import social_attention as _  # noqa: F401
    import sys
    jsa = sys.modules["socialways_tpu.kernels.social_attention"]
    import socialways_torch.kernels as kernels
    from socialways_torch.kernels.social_attention import (
        social_attention_chunked)
    monkeypatch.setattr(jsa, "_FWD_INTERPRET", True)
    monkeypatch.setattr(jsa, "_BWD_INTERPRET", True)
    n, w = (48, 0) if entry == "fused" else (100, 8)
    jp, gen = _generators(21 if entry == "fused" else 22)
    x4, h, ids = _inputs(n, 5, scene=7 if entry == "fused" else w)
    if entry == "fused":
        jfn = jsa.social_attention_fused
        fn = kernels.social_attention_fused
    else:
        def jfn(p, x, hh, i):
            return jsa.social_attention_chunked(p, x, hh, i, w, chunk=32)

        def fn(*args):
            return social_attention_chunked(*args, max_scene=w, chunk=32)
    want, jgrads = _jax_attention_grads(jfn, jp, x4, h, ids)
    got, grads = _attention_grads(fn, gen, x4, h, ids)
    _close(got.numpy(), want)
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        _close(g.numpy(), jgrads[name])


def test_torch_chunked_attention_requires_a_scene_bound():
    from socialways_torch.kernels.social_attention import (
        social_attention_chunked)
    gen, x4, h, ids = _port_inputs(20, 1)
    with pytest.raises(ValueError, match="max_scene > 0"):
        social_attention_chunked(gen.feat_mlp, gen.attn_w, x4, h, ids, 0)


@pytest.mark.cuda
def test_torch_fused_and_chunked_attention_on_the_card():
    """On the card both entry points launch the kernels and agree with
    their plain forms, forward and the gradient of h."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from socialways_torch.kernels import social_attention as sa
    from socialways_torch.ops.social import social_context_windowed
    gen, x4, h, ids = _port_inputs(300, 7)
    for fn, plain, w in [
            (sa.social_attention_fused, sa.social_attention_plain, 0),
            (sa.social_attention_chunked, social_context_windowed, 7)]:
        outs = []
        for dev in ("cuda", "cpu"):
            g = gen.to(dev)
            hh = h.to(dev).requires_grad_()
            args = (g.feat_mlp, g.attn_w, x4.to(dev), hh, ids.to(dev))
            before = sa.social_attention_fwd.launches
            out = (fn(*args, max_scene=w) if dev == "cuda"
                   else plain(*args, *((w,) if w else ())))
            if dev == "cuda":
                assert sa.social_attention_fwd.launches == before + 1
            torch.sin(out).sum().backward()
            outs.append((out.detach().cpu(), hh.grad.cpu()))
        for a, b in zip(*outs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-5)
    gen.cpu()


def _jax_jitter_noises(jstate, key):
    """The normal draws JAX's ``jitter_generator`` makes from ``key``, one
    a G leaf in its leaf order."""
    leaves = jax.tree_util.tree_leaves(jstate.g_params)
    keys = jax.random.split(key, len(leaves))
    return [torch.from_numpy(np.array(jax.random.normal(k, x.shape, x.dtype)))
            for x, k in zip(leaves, keys)]


def test_torch_jitter_generator_matches_jax():
    """Fed JAX's per-leaf draws, the jittered raw G equals JAX's; the EMA,
    D and both optimizers keep their values, and ``sigma == 0`` gives the
    state itself."""
    from socialways_tpu.engine.rescue import \
        jitter_generator as jax_jitter_generator
    from socialways_torch.engine.rescue import (draw_jitter_noises,
                                                jax_leaf_order,
                                                jitter_generator)
    from socialways_torch.io.checkpoint import flatten_state
    jcfg, tcfg = JaxConfig(**LOO), TrainConfig(**LOO)
    jstate = jax.device_get(jax_init(jax.random.PRNGKey(3), jcfg))
    state = train_state_from_jax(jstate, tcfg, "cpu")
    key = jax.random.PRNGKey(17)
    noises = _jax_jitter_noises(jstate, key)
    names = [n for n, _ in jax_leaf_order(state.g)]
    assert [tuple(t.shape) for t in noises] == [
        tuple(dict(state.g.named_parameters())[n].shape) for n in names]
    before = flatten_state(state)
    before = {k: v.copy() for k, v in before.items()}
    want = generator_params_from_jax(
        jax_jitter_generator(jstate, key, 0.05).g_params)
    out = jitter_generator(state, noises, 0.05)
    got = dict(out.g.named_parameters())
    for name in names:
        _close(got[name].detach().numpy(), want[name].numpy())
        assert not torch.equal(got[name], dict(
            state.g.named_parameters())[name]), name
    after = flatten_state(out)
    for k, v in before.items():
        if not k.startswith(".g_params/"):
            np.testing.assert_array_equal(after[k], v, err_msg=k)
    # the input state is not moved, and sigma 0 is the identity
    for k, v in flatten_state(state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert jitter_generator(state, noises, 0.0) is state
    drawn = draw_jitter_noises(state, torch.Generator().manual_seed(0))
    assert [t.shape for t in drawn] == [t.shape for t in noises]


def test_torch_checkpoint_exists_and_step_decay_match_jax(tmp_path):
    from socialways_tpu.io.checkpoint import \
        checkpoint_exists as jax_checkpoint_exists
    from socialways_tpu.utils.learning_utils import \
        make_step_decay_optax as jax_step_decay
    from socialways_torch.io import checkpoint_exists
    from socialways_torch.utils.learning_utils import make_step_decay_optax
    f = tmp_path / "c.npz"
    f.write_bytes(b"x")
    for path in (str(f), str(tmp_path), str(tmp_path / "missing.npz")):
        assert checkpoint_exists(path) == jax_checkpoint_exists(path)
    assert checkpoint_exists(str(f)) and not checkpoint_exists(str(tmp_path))
    for args in [(0.01,), (0.002, 0.9, 11), (1e-3, 0.5, 1)]:
        got, want = make_step_decay_optax(*args), jax_step_decay(*args)
        assert [got(c) for c in range(0, 300, 7)] == [
            want(c) for c in range(0, 300, 7)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_torch_config_takes_dtype_and_data_file(dtype):
    """JAX's ``dtype`` and ``data_file`` construct; a master dtype other
    than float32 is refused by name, where the model is built."""
    cfg = TrainConfig(dtype="float32", data_file="x.npz", **_cfg())
    check_supported(cfg)
    assert (cfg.dtype, cfg.data_file) == (JaxConfig().dtype, "x.npz")
    bad = cfg.replace(dtype=dtype)
    with pytest.raises(NotImplementedError, match="^dtype="):
        check_supported(bad)
    with pytest.raises(NotImplementedError, match="^dtype="):
        init_generator(bad, device="cpu")
