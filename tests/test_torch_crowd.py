"""Crowd scale in the port: the blockwise and windowed social-context forms,
the size-aware dispatch, the kernels' scene-window scan range,
``crowd_simulate`` and a ``gan_step`` with ``max_scene_size``, each against
the JAX package on the CPU at f32 rtol 1e-4 / atol 1e-5 on inputs made
from numpy seeds (hidden 16, N <= 600).  The dense cutoff is patched low in
both packages where a test needs a crowd branch at a small N, as
tests/test_engine.py:476 does.

The ``cuda`` tests hold the kernels' scene window on the card: a w > 0
launch gives the bits of a w = 0 launch on sorted, contiguous scenes of at
most w rows, and the C entries refuse w < 0.  JAX is imported inside the
tests that use it, so they also run where JAX is missing:
``python -m pytest tests/test_torch_crowd.py -m cuda --noconftest``."""

import sys

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator
from socialways_torch.ops.nn import linear_apply, mlp_apply
from socialways_torch.ops.social import (attention_pool, scene_mask,
                                         social_context_blockwise,
                                         social_context_windowed,
                                         social_features)

RTOL, ATOL = 1e-4, 1e-5
H = 16


def crowd_inputs(n, seed, w=8, hidden=H, tail=None):
    """Sorted, contiguous scenes of 1..w rows and a padded tail (id -1):
    the windowed contract."""
    rng = np.random.RandomState(seed)
    tail = n // 10 if tail is None else tail
    ids = np.full(n, -1, np.int32)
    row, sid = 0, 0
    while row < n - tail:
        s = min(int(rng.randint(1, w + 1)), n - tail - row)
        ids[row:row + s] = sid
        row, sid = row + s, sid + 1
    x4 = np.concatenate([rng.rand(n, 2), rng.randn(n, 2) * 0.3], axis=1)
    h = np.tanh(rng.randn(n, hidden))
    return (torch.from_numpy(x4.astype(np.float32)),
            torch.from_numpy(h.astype(np.float32)), torch.from_numpy(ids))


def port_gen(seed, hidden=H):
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=hidden // 2)
    return init_generator(cfg, torch.Generator().manual_seed(seed), "cpu")


def jax_params(gen):
    """The JAX ``{"feat_mlp", "attn_w"}`` tree holding ``gen``'s weights."""
    jnp = pytest.importorskip("jax.numpy")
    lin = lambda m: {"w": jnp.asarray(m.w.detach().numpy()),
                     "b": jnp.asarray(m.b.detach().numpy())}
    return {"feat_mlp": [lin(m) for m in gen.feat_mlp],
            "attn_w": lin(gen.attn_w)}


def jax_sa_module():
    """socialways_tpu.kernels.social_attention the module (its package
    re-exports a function of the same name)."""
    import socialways_tpu.kernels.social_attention  # noqa: F401
    return sys.modules["socialways_tpu.kernels.social_attention"]


def port_value_and_grads(fn, gen, x4, h, cot):
    """fn(x4, h) and the gradients of sum(fn * cot) for the feature MLP,
    the attention weights, x4 and h."""
    x4 = x4.clone().requires_grad_()
    h = h.clone().requires_grad_()
    params = [t for m in [*gen.feat_mlp, gen.attn_w] for t in (m.w, m.b)]
    out = fn(x4, h)
    grads = torch.autograd.grad((out * cot).sum(), params + [x4, h])
    return out.detach().numpy(), [g.numpy() for g in grads]


def jax_value_and_grads(fn, gen, x4, h, cot):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    p = jax_params(gen)
    out, vjp = jax.vjp(fn, p, jnp.asarray(x4.numpy()),
                       jnp.asarray(h.numpy()))
    dp, dx, dh = vjp(jnp.asarray(cot.numpy()))
    flat = [leaf for m in [*dp["feat_mlp"], dp["attn_w"]]
            for leaf in (m["w"], m["b"])]
    return np.asarray(out), [np.asarray(g) for g in flat + [dx, dh]]


def assert_all_close(got, want, tag):
    (go, gg), (wo, wg) = got, want
    np.testing.assert_allclose(go, wo, rtol=RTOL, atol=ATOL,
                               err_msg=f"{tag} out")
    names = ["w1", "b1", "w2", "b2", "w3", "b3", "attn_w", "attn_b", "x4",
             "h"]
    for name, a, b in zip(names, gg, wg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag} d{name}")


# ---------------------------------------------------- blockwise and windowed
@pytest.mark.parametrize("form,n,kw", [
    ("blockwise", 150, dict(block=64)),
    ("windowed", 300, dict(max_scene=8, block=64)),
    ("windowed_fallback", 100, dict(max_scene=8)),
], ids=["blockwise", "windowed", "windowed_fallback"])
def test_torch_crowd_forms_match_jax_and_dense(form, n, kw):
    """Forward and the gradients of every input against JAX's
    ``social_context_blockwise`` / ``_windowed`` and the port's dense
    form.  ``windowed`` runs the real window (block + 2 w = 80 < 320
    rows); ``windowed_fallback`` covers every row (512 + 16 >= 512) and
    falls back to blockwise at block 256."""
    from socialways_tpu.ops import social as jsocial
    gen = port_gen(seed=n)
    x4, h, ids = crowd_inputs(n, seed=n + 1)
    cot = torch.from_numpy(np.random.RandomState(n + 2)
                           .randn(n, H).astype(np.float32))
    if form == "blockwise":
        port = lambda x, hh: social_context_blockwise(
            gen.feat_mlp, gen.attn_w, x, hh, ids, **kw)
        jfn = lambda p, x, hh: jsocial.social_context_blockwise(
            p, x, hh, ids.numpy(), **kw)
    else:
        port = lambda x, hh: social_context_windowed(
            gen.feat_mlp, gen.attn_w, x, hh, ids, **kw)
        jfn = lambda p, x, hh: jsocial.social_context_windowed(
            p, x, hh, ids.numpy(), **kw)
    got = port_value_and_grads(port, gen, x4, h, cot)
    assert_all_close(got, jax_value_and_grads(jfn, gen, x4, h, cot), "jax")
    dense = lambda x, hh: sa.social_attention_plain(gen.feat_mlp, gen.attn_w,
                                                    x, hh, ids)
    assert_all_close(got, port_value_and_grads(dense, gen, x4, h, cot),
                     "dense")
    lonely = ~scene_mask(ids).any(-1)
    assert int(lonely.sum()) > 0 and float(np.abs(got[0][lonely]).max()) == 0


def test_torch_windowed_falls_back_to_blockwise_at_block_256(monkeypatch):
    """A window that would cover every row runs the blockwise form at
    ``min(block, 256)``, as JAX's does; one that does not (block 32 + 16
    < 128 rows) runs the window."""
    import socialways_torch.ops.social as tsocial
    calls = []
    real = tsocial.social_context_blockwise

    def spy(*a, **k):
        calls.append(k["block"])
        return real(*a, **k)

    monkeypatch.setattr(tsocial, "social_context_blockwise", spy)
    gen = port_gen(seed=3)
    x4, h, ids = crowd_inputs(100, seed=4)
    with torch.no_grad():
        tsocial.social_context_windowed(gen.feat_mlp, gen.attn_w, x4, h, ids,
                                        max_scene=8)
        tsocial.social_context_windowed(gen.feat_mlp, gen.attn_w, x4, h, ids,
                                        max_scene=8, block=32)
        tsocial.social_context_windowed(gen.feat_mlp, gen.attn_w, x4, h, ids,
                                        max_scene=8, block=128)
    assert calls == [256, 128]


# -------------------------------------------------------------- the dispatch
@pytest.mark.parametrize("n,max_scene,branch", [
    (40, 8, "dense"), (600, 8, "windowed"), (300, 0, "blockwise")])
def test_torch_dispatch_matches_jax_social_attention(n, max_scene, branch,
                                                     monkeypatch):
    """``social_attention`` on the CPU against JAX's ``social_attention``
    with ``use_pallas=False``, the dense cutoff patched to 64 in both
    packages so each branch runs; the branch taken is recorded."""
    jnp = pytest.importorskip("jax.numpy")
    jsa = jax_sa_module()
    monkeypatch.setattr(jsa, "_DENSE_MAX_AGENTS", 64)
    monkeypatch.setattr(sa, "_DENSE_MAX_AGENTS", 64)
    taken = []
    for name in ("social_context_windowed", "social_context_blockwise",
                 "social_attention_fwd"):
        real = getattr(sa, name)
        monkeypatch.setattr(sa, name, lambda *a, _r=real, _n=name, **k: (
            taken.append(_n), _r(*a, **k))[1])
    gen = port_gen(seed=n)
    x4, h, ids = crowd_inputs(n, seed=n + 5)
    with torch.no_grad():
        got = sa.social_attention(gen.feat_mlp, gen.attn_w, x4, h, ids,
                                  max_scene)
    want = jsa.social_attention(jax_params(gen), jnp.asarray(x4.numpy()),
                                jnp.asarray(h.numpy()),
                                jnp.asarray(ids.numpy()), use_pallas=False,
                                max_scene=max_scene)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    first = {"dense": "social_attention_fwd",
             "windowed": "social_context_windowed",
             "blockwise": "social_context_blockwise"}[branch]
    assert taken[0] == first
    with pytest.raises(ValueError):
        sa.social_attention(gen.feat_mlp, gen.attn_w, x4, h, ids, -1)


# ----------------------------------------------------------- the scan range
@pytest.mark.parametrize("w", [1, 2, 5, 16])
def test_torch_scan_range_holds_every_partner(w):
    """On sorted, contiguous scenes of at most w rows, every same-scene
    partner of every tile agent lies in its tile's ``scan_range``, for row
    tiles (forward, dq) and column tiles (dkv) alike; w = 0 scans all N."""
    n = 301
    _, _, ids = crowd_inputs(n, seed=w, w=w)
    mask = scene_mask(ids).numpy()
    for t0 in range(0, n, 2):
        lo, hi = sa.scan_range(n, t0, w)
        assert 0 <= lo <= t0 and min(n, t0 + 2) <= hi <= n
        for a in range(t0, min(t0 + 2, n)):
            partners = np.flatnonzero(mask[a])
            assert ((partners >= lo) & (partners < hi)).all(), (w, a)
        assert sa.scan_range(n, t0, 0) == (0, n)
    with pytest.raises(ValueError):
        sa.scan_range(n, 0, -1)


def test_torch_plain_restricted_to_scan_ranges_equals_dense():
    """A plain forward that scores each row tile only against its
    ``scan_range`` columns (what a w > 0 launch scans) equals the dense
    plain form."""
    n, w = 257, 6
    gen = port_gen(seed=11)
    x4, h, ids = crowd_inputs(n, seed=12, w=w)
    with torch.no_grad():
        wh = linear_apply(gen.attn_w, h)
        rows = []
        for t0 in range(0, n, 2):
            lo, hi = sa.scan_range(n, t0, w)
            r = slice(t0, min(t0 + 2, n))
            f_emb = mlp_apply(gen.feat_mlp, social_features(x4[r], x4[lo:hi]))
            mask = ((ids[r, None] == ids[None, lo:hi]) & (ids[r, None] >= 0)
                    & (ids[None, lo:hi] >= 0)
                    & (torch.arange(t0, r.stop)[:, None]
                       != torch.arange(lo, hi)[None, :]))
            s = torch.where(mask, torch.einsum("ijf,jf->ij", f_emb,
                                               wh[lo:hi]), -1e9)
            p = torch.where(mask, torch.exp(s - s.max(-1, keepdim=True)
                                            .values), 0.0)
            out = (p / p.sum(-1, keepdim=True).clamp_min(1e-20)) @ h[lo:hi]
            rows.append(torch.where(mask.any(-1, keepdim=True), out, 0.0))
        got = torch.cat(rows)
        dense = sa.social_attention_plain(gen.feat_mlp, gen.attn_w, x4, h,
                                          ids)
        full = attention_pool(gen.attn_w, mlp_apply(
            gen.feat_mlp, social_features(x4)), h, scene_mask(ids))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(full, dense)


# ------------------------------------------------------------- simulation
@pytest.mark.parametrize("agent_frame,n,cap", [
    (False, 120, None), (True, 120, None), (True, 600, 64)],
    ids=["world", "agent_frame", "agent_frame_windowed"])
def test_torch_crowd_simulate_matches_jax(agent_frame, n, cap, monkeypatch):
    """``crowd_simulate`` over 3 windows under JAX's own ``noise``, from
    JAX's initial-crowd construction at scenes of 8; the last case patches
    the dense cutoff so every window pools through the windowed form."""
    jax = pytest.importorskip("jax")
    from socialways_tpu.config import TrainConfig as JaxConfig
    from socialways_tpu.engine.losses import sample_noise as jax_noise
    from socialways_tpu.engine.simulate import crowd_simulate as jax_sim
    from socialways_tpu.models import init_generator as jax_init_generator
    from socialways_torch.engine.simulate import (crowd_simulate,
                                                  initial_crowd)
    from socialways_torch.io.checkpoint import generator_params_from_jax
    if cap is not None:
        monkeypatch.setattr(jax_sa_module(), "_DENSE_MAX_AGENTS", cap)
        monkeypatch.setattr(sa, "_DENSE_MAX_AGENTS", cap)
    flags = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                 use_social=True, agent_frame=agent_frame, max_scene_size=8)
    jcfg, tcfg = JaxConfig(**flags), TrainConfig(**flags)
    jparams = jax_init_generator(jax.random.PRNGKey(n), jcfg)
    gen = init_generator(tcfg, device="cpu")
    gen.load_state_dict(generator_params_from_jax(jax.device_get(jparams)))
    obsv0, ids = initial_crowd(n, 8, tcfg.n_past, seed=n)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    noise = np.array(jax.vmap(lambda k: jax_noise(k, n, jcfg))(keys))
    want = np.asarray(jax_sim(jparams, obsv0, ids, 3, None, jcfg,
                              noise=noise))
    got = crowd_simulate(gen, torch.from_numpy(obsv0), torch.from_numpy(ids),
                         3, tcfg, noise=torch.from_numpy(noise))
    assert got.shape == (n, 3 * tcfg.n_next, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_torch_gan_step_windowed_social_matches_jax(monkeypatch):
    """One loo ``gan_step`` with ``max_scene_size`` under JAX's draws, the
    dense cutoff patched so both packages pool 600 rows through the
    windowed form (block 512 + 2 x 9 < 1024 rows): the counterpart of
    ``test_gan_step_windowed_social_matches_dense``
    (tests/test_engine.py:449)."""
    pytest.importorskip("jax")
    from test_torch_train_step import LOO
    from test_torch_gan_variants import run_one_step
    monkeypatch.setattr(jax_sa_module(), "_DENSE_MAX_AGENTS", 64)
    monkeypatch.setattr(sa, "_DENSE_MAX_AGENTS", 64)
    taken = []
    real = sa.social_context_windowed
    monkeypatch.setattr(sa, "social_context_windowed",
                        lambda *a, **k: (taken.append(1), real(*a, **k))[1])
    tcfg, state = run_one_step(dict(LOO, max_scene_size=9), seed=31, n=600)
    assert tcfg.max_scene_size == 9 and taken
    assert state.g_opt.count == 1


# ------------------------------------------------------------------ the card
def _card_inputs(n, seed, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = port_gen(seed, hidden=64)
    x4, h, ids = crowd_inputs(n, seed, w=w, hidden=64)
    gen.cuda()
    weights = [t.detach() for m in gen.feat_mlp for t in (m.w, m.b)]
    wh = linear_apply(gen.attn_w, h.cuda()).detach()
    return gen, x4.cuda(), h.cuda(), ids.cuda(), wh, weights


@pytest.mark.cuda
def test_torch_scene_window_gives_full_scan_bits_on_the_card():
    """Forward with stats, dq and dkv at w = 16 equal their w = 0 launch
    bit for bit on sorted scenes of at most 16 rows, and the forward
    matches the plain windowed form."""
    n, w = 1000, 16
    gen, x4, h, ids, wh, weights = _card_inputs(n, 5, w)
    res = {}
    for ww in (0, w):
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, weights, True, ww)
        g = torch.randn(n, 64, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        r = (g * out).sum(-1)
        dq = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, weights,
                                        u, c, max_scene=ww)
        dkv = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r,
                                          weights, u, c, max_scene=ww)
        torch.cuda.synchronize()
        res[ww] = [out, stats, u, c, dq, *dkv]
    for a, b in zip(res[0], res[w]):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain = social_context_windowed(gen.feat_mlp, gen.attn_w, x4, h, ids,
                                        max_scene=w)
    np.testing.assert_allclose(res[w][0].cpu().numpy(), plain.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_torch_c_entries_refuse_a_negative_window():
    """Each C entry returns cudaErrorInvalidValue (1) for w < 0 and
    launches nothing; the wrappers raise before they call it."""
    n = 64
    gen, x4, h, ids, wh, weights = _card_inputs(n, 7, 8)
    kw = dict(device="cuda", dtype=torch.float32)
    out, stats = torch.empty((n, 64), **kw), torch.empty((n, 2), **kw)
    u, c = torch.empty((n, 64), **kw), torch.empty((n,), **kw)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    fwd = sa._lib(sa._FWD, "social_attention_fwd", 14, 5)
    assert fwd(*ptr(x4, ids, h, wh, *weights, out, stats, u, c), n, 64, 64,
               sa.fwd_blocks(n), -1, 1, None, stream) == 1
    sa._launch_fwd(x4, ids, h, wh, weights, True, 0)
    g, r = torch.zeros((n, 64), **kw), torch.zeros((n,), **kw)
    dq = sa._lib(sa._BWD, "social_attention_bwd_dq", 13, 4)
    dx = torch.empty((n, 4), **kw)
    assert dq(*ptr(x4, ids, h, g, stats, r, u, c, *weights[:4], dx), n, 64,
              sa.dq_blocks(n), -1, 1, None, stream) == 1
    dkv = sa._lib(sa._BWD, "social_attention_bwd_dkv", 24, 6)
    scratch = [torch.empty(s, **kw) for s in [
        (n, 64), (n,), (sa.dkv_partial_floats(n),), (n, 4), (n, 64), (n, 64),
        (64, 64), (64,), (sa._PARTIAL,)]]
    assert dkv(*ptr(x4, ids, h, wh, g, stats, r, u, c, *weights, *scratch),
               n, 64, 64, sa.dkv_blocks(n), sa.dkv_partial_floats(n), -1,
               1, None, stream) == 1
    torch.cuda.synchronize()
    for call in (lambda: sa._launch_fwd(x4, ids, h, wh, weights, True, -1),
                 lambda: sa.social_attention_bwd_dq(
                     x4, ids, h, wh, g, stats, r, weights, u, c,
                     max_scene=-1),
                 lambda: sa.social_attention_bwd_dkv(
                     x4, ids, h, wh, g, stats, r, weights, u, c,
                     max_scene=-1)):
        with pytest.raises(ValueError):
            call()
