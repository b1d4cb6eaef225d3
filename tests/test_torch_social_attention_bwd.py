"""The social-attention backward of socialways_torch: the plain stats and
both plain backward versions against the JAX package's Pallas kernels
(``_pallas_forward(with_stats=True)`` and ``_pallas_backward``, interpret
mode) and against ``jax.vjp`` of its dense ``_xla_reference``; the port's
CPU autograd against the same; and, on a CUDA card, the autograd Function
(forward with stats, dq and dkv kernels) against the plain versions.

Inputs: scenes sorted by id with a padded tail, a singleton scene and a
stationary agent (the safe-norm edge), made with numpy from a seed.
Tolerance f32 rtol 1e-4 / atol 1e-5 (the gradients are sums over pairs in
another order than JAX's).  JAX is imported inside the tests that use it,
so the CUDA tests also run on a machine without JAX:
``python -m pytest tests/test_torch_social_attention_bwd.py -m cuda
--noconftest``."""

import importlib

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator
from socialways_torch.ops.nn import linear_apply

RTOL, ATOL = 1e-4, 1e-5
# kernel vs plain on the card: the forward's rtol 2e-4 / atol 2e-5 for
# values (out, stats, dh, dwh).  Weight gradients are sums over every pair
# in another order: max|err| <= 1e-4 max|ref| + 1e-6.  dx sums pair terms
# with 1/dist, 1/|dv|^2 and 1/(dist |v| + 1e-6) factors, so f32 rounding
# differences (the kernel's FMA-contracted, hand-derived chain against the
# plain form's separate ops under autograd) grow with them: each row is
# held at max|err| <= 1e-3 max|ref row| + 2e-5.
K_RTOL, K_ATOL = 2e-4, 2e-5


def _inputs(n, hidden, seed, scene=7):
    rng = np.random.RandomState(seed)
    x4 = rng.randn(n, 4).astype(np.float32)
    x4[3, 2:] = 0.0                       # stationary agent
    h = np.tanh(rng.randn(n, hidden)).astype(np.float32)
    g = rng.randn(n, hidden).astype(np.float32)
    ids = (np.arange(n) // scene).astype(np.int32)
    ids[n - 8:] = -1                      # padded tail
    ids[n - 9] = ids[n - 10] + 1          # singleton scene, ids stay sorted
    return x4, h, g, ids


def _gen(hidden, seed, device="cpu"):
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=hidden // 2)
    return init_generator(cfg, torch.Generator().manual_seed(seed), device)


def _jax_params(gen):
    """The port generator's feature/attention weights as a JAX tree."""
    jnp = pytest.importorskip("jax.numpy")
    lin = lambda m: {"w": jnp.asarray(m.w.detach().numpy()),
                     "b": jnp.asarray(m.b.detach().numpy())}
    return {"feat_mlp": [lin(m) for m in gen.feat_mlp],
            "attn_w": lin(gen.attn_w)}


def _weights(gen):
    return [t for layer in gen.feat_mlp for t in (layer.w, layer.b)]


def _port_grads(gen, x4, h, g, ids):
    """dL/d(x4, h, w1..b3, Ww, bw) for L = sum(out * g), assembled from the
    plain stats and the two plain backward versions, with dL/dwh pulled
    back through wh = h W + b as _pallas_backward's epilogue does."""
    x4, h, g = (torch.from_numpy(a) for a in (x4, h, g))
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        out, m, l = sa.social_attention_stats_plain(gen.feat_mlp, gen.attn_w,
                                                    x4, h, ids)
        wh = linear_apply(gen.attn_w, h)
        stats = torch.stack([m, l], dim=-1)
        r = (g * out).sum(-1)
        w = [t.detach() for t in _weights(gen)]
        dxi = sa.social_attention_bwd_dq_plain(x4, ids, h, wh, g, stats, r, w)
        dxj, dh, dwh, *dw = sa.social_attention_bwd_dkv_plain(
            x4, ids, h, wh, g, stats, r, w)
        ww = gen.attn_w.w.detach()
    return (out, m, l), [dxi + dxj, dh + dwh @ ww.T, *dw, h.T @ dwh,
                         dwh.sum(0)]


def _jax_vjp_reference(p, x4, h, g, ids):
    """jax.vjp of the dense ``_xla_reference``, flattened as _port_grads."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    ref = importlib.import_module("socialways_tpu.kernels.social_attention")
    out, vjp = jax.vjp(lambda p_, x_, h_: ref._xla_reference(
        p_, x_, h_, jnp.asarray(ids)), p, jnp.asarray(x4), jnp.asarray(h))
    dp, dx, dh = vjp(jnp.asarray(g))
    flat = [dx, dh] + [t for layer in dp["feat_mlp"]
                       for t in (layer["w"], layer["b"])]
    return np.asarray(out), [np.asarray(a) for a in
                             flat + [dp["attn_w"]["w"], dp["attn_w"]["b"]]]


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_torch_attention_bwd_plain_matches_pallas_interpret():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    ref = importlib.import_module("socialways_tpu.kernels.social_attention")
    n, hidden = 64, 16
    gen = _gen(hidden, 1)
    x4, h, g, ids = _inputs(n, hidden, seed=2)
    p = _jax_params(gen)
    args = (p, jnp.asarray(x4), jnp.asarray(h), jnp.asarray(ids))
    out_pad, stats = ref._pallas_forward(*args, with_stats=True,
                                         interpret=True)
    assert stats.shape[0] == 128              # padded to the backward tile
    dp, dx, dh = ref._pallas_backward(*args, jnp.asarray(g), out_pad, stats,
                                      interpret=True)
    (out, m, l), grads = _port_grads(gen, x4, h, g, ids)
    _close(out, np.asarray(out_pad)[:n], "out")
    _close(m, np.asarray(stats)[:n, 0], "m")
    _close(l, np.asarray(stats)[:n, 1], "l")
    assert float(l[n - 9]) == 0.0 and float(m[n - 9]) == -1e9  # singleton
    want = [dx, dh] + [t for layer in dp["feat_mlp"]
                       for t in (layer["w"], layer["b"])]
    want += [dp["attn_w"]["w"], dp["attn_w"]["b"]]
    names = ["dx", "dh", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dWw",
             "dbw"]
    for name, a, b in zip(names, grads, want):
        _close(a, b, name)


def test_torch_attention_bwd_plain_matches_xla_vjp():
    n, hidden = 48, 16
    gen = _gen(hidden, 3)
    x4, h, g, ids = _inputs(n, hidden, seed=4, scene=5)
    want_out, want = _jax_vjp_reference(_jax_params(gen), x4, h, g, ids)
    (out, _, _), grads = _port_grads(gen, x4, h, g, ids)
    _close(out, want_out, "out")
    for i, (a, b) in enumerate(zip(grads, want)):
        _close(a, b, f"grad {i}")


def test_torch_attention_cpu_autograd_matches_xla_vjp():
    """The CPU path of ``social_attention_fwd`` under autograd (the dense
    form) is the gradient JAX takes."""
    n, hidden = 48, 16
    gen = _gen(hidden, 5)
    x4, h, g, ids = _inputs(n, hidden, seed=6, scene=6)
    want_out, want = _jax_vjp_reference(_jax_params(gen), x4, h, g, ids)
    xt = torch.from_numpy(x4).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    out = sa.social_attention_fwd(gen.feat_mlp, gen.attn_w, xt, ht,
                                  torch.from_numpy(ids))
    leaves = [xt, ht] + _weights(gen) + [gen.attn_w.w, gen.attn_w.b]
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    _close(out.detach(), want_out, "out")
    for i, (a, b) in enumerate(zip(grads, want)):
        _close(a, b, f"grad {i}")


def test_torch_attention_bwd_wrappers_take_plain_path_on_cpu():
    n, hidden = 32, 16
    gen = _gen(hidden, 7)
    x4, h, g, ids = (torch.from_numpy(a) for a in _inputs(n, hidden, 8))
    with torch.no_grad():
        out, m, l = sa.social_attention_stats_plain(gen.feat_mlp, gen.attn_w,
                                                    x4, h, ids)
        wh = linear_apply(gen.attn_w, h)
    stats, r, w = torch.stack([m, l], -1), (g * out).sum(-1), _weights(gen)
    u, c = wh @ w[4].detach().T, wh @ w[5].detach()
    before = (sa.social_attention_bwd_dq.launches,
              sa.social_attention_bwd_dkv.launches)
    dq = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, w, u, c)
    dkv = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w, u, c,
                                      need_dx=False)
    assert dkv[0] is None and len(dkv) == 9
    assert torch.equal(dq, sa.social_attention_bwd_dq_plain(
        x4, ids, h, wh, g, stats, r, w))
    assert (sa.social_attention_bwd_dq.launches,
            sa.social_attention_bwd_dkv.launches) == before


# ---------------------------------------------------------------- the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _assert_kernel_close(got, want, name, weight=False):
    got, want = got.detach().cpu(), want.detach().cpu()
    assert torch.isfinite(got).all(), name
    if weight:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6, (name, err)
    elif name.startswith("dx"):
        err = (got - want).abs().amax(dim=1)
        bound = 1e-3 * want.abs().amax(dim=1) + 2e-5
        assert bool((err <= bound).all()), (name, float(err.max()))
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K_RTOL,
                                   atol=K_ATOL, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hidden,scene", [(256, 64, 7), (256, 32, 13),
                                            (300, 64, 16), (2048, 64, 64)])
def test_torch_attention_function_matches_plain_on_cuda(n, hidden, scene):
    _need_cuda()
    gen = _gen(hidden, n, "cuda")
    x4, h, g, ids = (torch.from_numpy(a).cuda()
                     for a in _inputs(n, hidden, n, scene))
    xt, ht = x4.clone().requires_grad_(), h.clone().requires_grad_()
    counts = lambda: (sa.social_attention_fwd.launches,
                      sa.social_attention_bwd_dq.launches,
                      sa.social_attention_bwd_dkv.launches)
    c0 = counts()
    out = sa.social_attention_fwd(gen.feat_mlp, gen.attn_w, xt, ht, ids)
    leaves = [xt, ht] + _weights(gen) + [gen.attn_w.w, gen.attn_w.b]
    grads = torch.autograd.grad((out * g).sum(), leaves)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, counts())] == [1, 1, 1]

    xp, hp = x4.clone().requires_grad_(), h.clone().requires_grad_()
    want_out = sa.social_attention_plain(gen.feat_mlp, gen.attn_w, xp, hp,
                                         ids)
    want = torch.autograd.grad((want_out * g).sum(),
                               [xp, hp] + _weights(gen)
                               + [gen.attn_w.w, gen.attn_w.b])
    _assert_kernel_close(out, want_out, "out")
    names = ["dx", "dh", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dWw",
             "dbw"]
    for i, (name, a, b) in enumerate(zip(names, grads, want)):
        _assert_kernel_close(a, b, name, weight=i >= 2)


@pytest.mark.cuda
def test_torch_attention_kernels_match_plain_versions_on_cuda():
    """Each backward kernel against its plain version on the same inputs,
    and the forward's stats against ``social_attention_stats_plain``."""
    _need_cuda()
    n, hidden = 256, 64
    gen = _gen(hidden, 3, "cuda")
    x4, h, g, ids = (torch.from_numpy(a).cuda()
                     for a in _inputs(n, hidden, 9, 11))
    w = [t.detach() for t in _weights(gen)]
    with torch.no_grad():
        wh = linear_apply(gen.attn_w, h)
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, with_stats=True)
        p_out, m, l = sa.social_attention_stats_plain(gen.feat_mlp,
                                                      gen.attn_w, x4, h, ids)
    _assert_kernel_close(out, p_out, "out")
    _assert_kernel_close(stats[:, 0], m, "m")
    _assert_kernel_close(stats[:, 1], l, "l")
    _assert_kernel_close(u, wh @ w[4].T, "u")
    _assert_kernel_close(c, wh @ w[5], "c")
    r = (g * out).sum(-1)
    got_q = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, w, u, c)
    want_q = sa.social_attention_bwd_dq_plain(x4, ids, h, wh, g, stats, r, w)
    _assert_kernel_close(got_q, want_q, "dx_i")
    got = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w, u, c)
    want = sa.social_attention_bwd_dkv_plain(x4, ids, h, wh, g, stats, r, w)
    names = ["dx_j", "dh_j", "dwh_j", "dw1", "db1", "dw2", "db2", "dw3",
             "db3"]
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        _assert_kernel_close(a, b, name, weight=i >= 3)
    no_dx = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w, u, c,
                                        need_dx=False)
    assert no_dx[0] is None
    for a, b in zip(no_dx[1:], got[1:]):
        assert torch.equal(a, b)             # deterministic, no atomics


@pytest.mark.cuda
def test_torch_attention_skips_dq_when_x4_is_data_on_cuda():
    """On the training path x4 is data: the backward launches dkv only."""
    _need_cuda()
    gen = _gen(64, 4, "cuda")
    x4, h, g, ids = (torch.from_numpy(a).cuda() for a in _inputs(256, 64, 5))
    ht = h.clone().requires_grad_()
    dq0, dkv0 = (sa.social_attention_bwd_dq.launches,
                 sa.social_attention_bwd_dkv.launches)
    out = sa.social_attention_fwd(gen.feat_mlp, gen.attn_w, x4, ht, ids)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert sa.social_attention_bwd_dq.launches == dq0
    assert sa.social_attention_bwd_dkv.launches == dkv0 + 1
    assert torch.isfinite(ht.grad).all()
