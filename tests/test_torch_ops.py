"""socialways_torch ops (nn, lstm, traj, dense social forms) against their
JAX twins in socialways_tpu, on the same numpy inputs.  f32, CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.ops import lstm as jlstm
from socialways_tpu.ops import nn as jnn
from socialways_tpu.ops import social as jsocial
from socialways_tpu.ops import traj as jtraj
from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.ops import lstm as tlstm
from socialways_torch.ops import nn as tnn
from socialways_torch.ops import social as tsocial
from socialways_torch.ops import traj as ttraj

RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _linear(rng, i, o):
    w, b = rng.randn(i, o).astype(np.float32), rng.randn(o).astype(np.float32)
    lin = tnn.Linear(i, o)
    with torch.no_grad():
        lin.w.copy_(_t(w))
        lin.b.copy_(_t(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, lin


@torch.no_grad()
def test_torch_linear_mlp_leaky_relu_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7, 3).astype(np.float32)
    pj, pt = _linear(rng, 3, 8)
    _close(tnn.linear_apply(pt, _t(x)), jnn.linear_apply(pj, jnp.asarray(x)))
    _close(tnn.leaky_relu(_t(x)), jnn.leaky_relu(jnp.asarray(x)))

    layers = [_linear(rng, a, b) for a, b in [(3, 32), (32, 64), (64, 16)]]
    mlp = tnn.MLP([t for _, t in layers])
    want = jnn.mlp_apply([j for j, _ in layers], jnp.asarray(x))
    _close(mlp(_t(x)), want)


@torch.no_grad()
def test_torch_init_rules_are_torch_uniform_and_seeded():
    g = torch.Generator().manual_seed(3)
    mlp = tnn.mlp_init([3, 32, 64, 16], g)
    assert [tuple(l.w.shape) for l in mlp] == [(3, 32), (32, 64), (64, 16)]
    for layer in mlp:
        bound = 1.0 / np.sqrt(layer.w.shape[0])
        assert float(layer.w.abs().max()) <= bound
        assert float(layer.b.abs().max()) <= bound
    cell = tlstm.lstm_init(16, 8, torch.Generator().manual_seed(3))
    assert tuple(cell.w.shape) == (24, 32) and tuple(cell.b.shape) == (32,)
    assert float(cell.w.abs().max()) <= 1 / np.sqrt(8)
    assert float(cell.b.abs().max()) <= 2 / np.sqrt(8)    # sum of two draws
    again = tnn.mlp_init([3, 32, 64, 16], torch.Generator().manual_seed(3))
    for a, b in zip(mlp.parameters(), again.parameters()):
        assert torch.equal(a, b)


@torch.no_grad()
def test_torch_lstm_cell_and_seq_match_jax():
    rng = np.random.RandomState(1)
    n, t, d, h = 6, 8, 5, 16
    w = rng.randn(d + h, 4 * h).astype(np.float32) * 0.3
    b = rng.randn(4 * h).astype(np.float32) * 0.3
    xs = rng.randn(n, t, d).astype(np.float32)
    h0 = rng.randn(n, h).astype(np.float32)
    c0 = rng.randn(n, h).astype(np.float32)
    pj = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    pt = tlstm.LSTMCell(d, h)
    pt.w.copy_(_t(w))
    pt.b.copy_(_t(b))

    hj, cj = jlstm.lstm_cell(pj, jnp.asarray(xs[:, 0]),
                             (jnp.asarray(h0), jnp.asarray(c0)))
    ht, ct = tlstm.lstm_cell(pt, _t(xs[:, 0]), (_t(h0), _t(c0)))
    _close(ht, hj)
    _close(ct, cj)

    ysj, (hj, cj) = jlstm.lstm_seq(pj, jnp.asarray(xs),
                                   jlstm.zero_state(n, h))
    yst, (ht, ct) = tlstm.lstm_seq(pt, _t(xs), tlstm.zero_state(n, h))
    _close(yst, ysj)
    _close(ht, hj)
    _close(ct, cj)


def test_torch_traj_ops_match_jax():
    rng = np.random.RandomState(2)
    obsv = rng.randn(7, 8, 2).astype(np.float32)
    obsv[3, -1] = obsv[3, -2]            # zero last displacement: identity
    oj, ot = jnp.asarray(obsv), _t(obsv)

    _close(ttraj.obsv_to_4d(ot), jtraj.obsv_to_4d(oj))
    fj, ft = jtraj.agent_frame_of(oj), ttraj.agent_frame_of(ot)
    for a, b in zip(ft, fj):
        _close(a, b)
    assert float(ft[1][3]) == 1.0 and float(ft[2][3]) == 0.0

    pts = rng.randn(3, 7, 12, 2).astype(np.float32)     # K-sample axis
    _close(ttraj.to_agent_frame(_t(pts), ft),
           jtraj.to_agent_frame(jnp.asarray(pts), fj))
    st = rng.randn(3, 7, 12, 4).astype(np.float32)
    _close(ttraj.from_agent_frame_4d(_t(st), ft),
           jtraj.from_agent_frame_4d(jnp.asarray(st), fj))

    for af in (False, True):
        for soc in (False, True):
            got = ttraj.canonicalize_for_rollout(ot, af, soc)
            want = jtraj.canonicalize_for_rollout(oj, af, soc)
            _close(got[0], want[0])
            assert (got[1] is None) == (want[1] is None)
            assert (got[2] is None) == (want[2] is None)
            if want[2] is not None:
                _close(got[2], want[2])

    for t in (8, 2):
        _close(ttraj.predict_cv(ot[:, :t], 12),
               jtraj.predict_cv(oj[:, :t], 12))


def _scene_inputs(seed, n, h, f):
    rng = np.random.RandomState(seed)
    x4 = rng.randn(n, 4).astype(np.float32)
    x4[1, 2:] = 0.0                      # an agent standing still
    x4[2] = x4[3]                        # two agents at the same state
    ids = (np.arange(n) // 5).astype(np.int32)
    ids[n - 6:] = -1                     # padded tail
    ids[n - 7] = 99                      # singleton scene
    hh = rng.randn(n, h).astype(np.float32)
    f_emb = rng.randn(n, n, f).astype(np.float32)
    return rng, x4, ids, hh, f_emb


@torch.no_grad()
def test_torch_social_dense_forms_match_jax():
    rng, x4, ids, hh, f_emb = _scene_inputs(3, 40, 16, 16)
    v = rng.randn(6, 2).astype(np.float32)
    v[2] = 0.0
    _close(tsocial.safe_norm(_t(v)), jsocial.safe_norm(jnp.asarray(v)))

    _close(tsocial.social_features(_t(x4)),
           jsocial.social_features(jnp.asarray(x4)))
    mask_t = tsocial.scene_mask(torch.from_numpy(ids))
    mask_j = jsocial.scene_mask(jnp.asarray(ids))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))

    wj, wt = _linear(rng, 16, 16)
    got = tsocial.attention_pool(wt, _t(f_emb), _t(hh), mask_t)
    want = jsocial.attention_pool(wj, jnp.asarray(f_emb), jnp.asarray(hh),
                                  mask_j)
    _close(got, want)
    assert float(got[len(ids) - 7:].abs().max()) == 0.0


@pytest.mark.parametrize("field,value", [
    ("decoder", "lstm"), ("latent_code_type", "binary"),
    ("noise_dist", "gaussian"), ("compute_dtype", "bfloat16"),
    ("pac", 2), ("mb_std", True), ("spectral_norm", True)])
def test_torch_config_rejects_unported_models(field, value):
    """Binary codes and compute dtypes other than float32 and bfloat16
    (float16) are refused, naming the field.  bf16, the LSTM decoder,
    gaussian noise, PacGAN, minibatch stddev and spectral norm are ported:
    they pass and build JAX's parameter shapes."""
    from socialways_torch.engine.losses import sample_noise
    from socialways_torch.models.discriminator import init_discriminator
    from socialways_torch.models.generator import init_generator
    check_supported(TrainConfig())
    cfg = TrainConfig().replace(**{field: value})
    if field == "latent_code_type":
        with pytest.raises(NotImplementedError, match=field):
            check_supported(cfg)
        return
    if field == "compute_dtype":
        with pytest.raises(NotImplementedError, match=field):
            check_supported(cfg.replace(compute_dtype="float16"))
    check_supported(cfg)
    gen = torch.Generator().manual_seed(0)
    g = init_generator(cfg, gen, "cpu")
    d = init_discriminator(cfg, gen, "cpu")
    h = cfg.hidden_size
    assert hasattr(g, "dec_lstm") == (cfg.decoder == "lstm")
    assert hasattr(g, "decoder") == (cfg.decoder == "fc")
    assert tuple(d.classifier[0].w.shape) == (
        (h + int(cfg.mb_std)) * cfg.pac, h // 2)
    z = sample_noise((4096,), cfg, gen)
    assert bool((z < 0).any()) == (cfg.noise_dist == "gaussian")
