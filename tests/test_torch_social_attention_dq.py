"""The dq backward of the social attention (dL/dx_i, the query side of every
pair) on the inputs where a one-warp-per-row kernel is weakest: ETH-like
scenes of 2-16 agents with sorted ids, the same kind of ids shuffled, one
dense scene, and a ragged N.

On the CPU the plain version ``social_attention_bwd_dq_plain`` is held
against JAX's gradient through ``jax.vjp`` of the JAX package's dense
``_xla_reference``.  Agent k's output depends on x_k only through the query
side of its pairs (the self pair is masked), so the query-side gradient of
agent k is the gradient of g_k . out_k with respect to x_k: row k of the
vjp whose cotangent keeps g on row k alone (one vjp per row, vmapped).
With the plain dkv's dx_j it also gives JAX's whole dL/dx4.  Inputs come
from a numpy seed; f32 at rtol 1e-4 / atol 1e-5, the tolerance of the other
backward tests (the same sums in another order).

On a CUDA card the dq kernel is held against its plain version at the
per-row dx bound, and two runs give equal bits (skipped without a card):
``python -m pytest tests/test_torch_social_attention_dq.py -m cuda
--noconftest``.  JAX is imported inside the tests that use it."""

import importlib

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator
from socialways_torch.ops.nn import linear_apply

RTOL, ATOL = 1e-4, 1e-5


def _ids(kind, n, rng):
    """ETH-like scenes of 2-16 agents sorted by id, the fourth a singleton,
    a padded tail of 10 % (``shuffled``: the same ids in random order), or
    one scene of all n agents (``dense``)."""
    if kind == "dense":
        return np.zeros(n, np.int32)
    ids = np.full(n, -1, np.int32)
    row, sid = 0, 0
    while row < int(n * 0.9):
        s = 1 if sid == 3 else int(rng.randint(2, 17))
        ids[row:row + s] = sid
        row, sid = row + s, sid + 1
    ids[int(n * 0.9):] = -1
    return ids[rng.permutation(n)] if kind == "shuffled" else ids


def _case(kind, n, hidden, seed, device="cpu"):
    """Generator weights and (x4, h, g, ids) from seeded numpy: positions in
    a 4 m square, velocities ~0.3, one agent standing still."""
    rng = np.random.RandomState(seed)
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=hidden // 2)
    gen = init_generator(cfg, torch.Generator().manual_seed(seed), device)
    x4 = np.concatenate([rng.rand(n, 2) * 4.0, rng.randn(n, 2) * 0.3], 1)
    x4[min(5, n - 1), 2:] = 0.0
    h = np.tanh(rng.randn(n, hidden))
    g = rng.randn(n, hidden)
    arrays = [a.astype(np.float32) for a in (x4, h, g)] + [_ids(kind, n, rng)]
    return gen, arrays


def _plain_args(gen, x4, h, g, ids):
    """(x4, ids, h, wh, g, stats, r, weights) for the backward wrappers,
    from the plain forward's stats."""
    with torch.no_grad():
        out, m, l = sa.social_attention_stats_plain(gen.feat_mlp, gen.attn_w,
                                                    x4, h, ids)
        wh = linear_apply(gen.attn_w, h)
    w = [t.detach() for layer in gen.feat_mlp for t in (layer.w, layer.b)]
    return (x4, ids, h, wh, g, torch.stack([m, l], -1), (g * out).sum(-1), w)


def _jax_dx(gen, x4, h, g, ids):
    """(query-side dx [N, 4], whole dx [N, 4]) from jax.vjp of JAX's dense
    ``_xla_reference``."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    ref = importlib.import_module("socialways_tpu.kernels.social_attention")
    lin = lambda m: {"w": jnp.asarray(m.w.detach().numpy()),
                     "b": jnp.asarray(m.b.detach().numpy())}
    p = {"feat_mlp": [lin(m) for m in gen.feat_mlp],
         "attn_w": lin(gen.attn_w)}
    n = x4.shape[0]

    @jax.jit
    def dx(x_, h_, g_):
        _, vjp = jax.vjp(lambda xx: ref._xla_reference(
            p, xx, h_, jnp.asarray(ids)), x_)
        per_row = jax.vmap(lambda e: vjp(e[:, None] * g_)[0])(
            jnp.eye(n, dtype=jnp.float32))           # [row k, N, 4]
        return per_row[jnp.arange(n), jnp.arange(n)], vjp(g_)[0]

    query, whole = dx(jnp.asarray(x4), jnp.asarray(h), jnp.asarray(g))
    return np.asarray(query), np.asarray(whole)


@pytest.mark.parametrize("kind,n,hidden", [("sorted", 64, 16),
                                           ("shuffled", 64, 32),
                                           ("dense", 48, 16),
                                           ("ragged", 37, 16)])
def test_torch_dq_plain_matches_jax_query_side_gradient(kind, n, hidden):
    gen, arrays = _case("sorted" if kind == "ragged" else kind, n, hidden,
                        seed=n + hidden)
    want_q, want_x = _jax_dx(gen, *arrays)
    args = _plain_args(gen, *(torch.from_numpy(a) for a in arrays))
    dq = sa.social_attention_bwd_dq_plain(*args)
    dxj = sa.social_attention_bwd_dkv_plain(*args)[0]
    ids = arrays[3]
    lonely = [k for k in range(n) if ids[k] < 0 or (ids == ids[k]).sum() == 1]
    assert all(float(dq[k].abs().max()) == 0.0 for k in lonely)  # no pair
    assert float(np.abs(want_q).min(axis=1).max()) > 0.0
    np.testing.assert_allclose(dq.numpy(), want_q, rtol=RTOL, atol=ATOL,
                               err_msg="query side")
    np.testing.assert_allclose((dq + dxj).numpy(), want_x, rtol=RTOL,
                               atol=ATOL, err_msg="whole dx")


# ---------------------------------------------------------------- the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cuda_args(kind, n, hidden):
    """Inputs on the card, with the forward kernel's stats, u and c."""
    gen, arrays = _case(kind, n, hidden, seed=n, device="cuda")
    x4, h, g, ids = (torch.from_numpy(a).cuda() for a in arrays)
    w = [t.detach() for layer in gen.feat_mlp for t in (layer.w, layer.b)]
    with torch.no_grad():
        wh = linear_apply(gen.attn_w, h)
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, with_stats=True)
    return (x4, ids, h, wh, g, stats, (g * out).sum(-1), w), (u, c)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("shuffled", 256), ("dense", 256),
                                    ("sorted", 301)])
def test_torch_dq_kernel_matches_plain_on_cuda(kind, n):
    """Shuffled ids, one dense scene of 256 and a ragged N = 301: the kernel
    against its plain version at the per-row dx bound (its pair terms carry
    1/dist and 1/|dv|^2 factors that grow f32 rounding), one launch a call,
    and equal bits on two runs."""
    _need_cuda()
    args, uc = _cuda_args(kind, n, 64)
    before = sa.social_attention_bwd_dq.launches
    got = sa.social_attention_bwd_dq(*args, *uc)
    again = sa.social_attention_bwd_dq(*args, *uc)
    torch.cuda.synchronize()
    assert sa.social_attention_bwd_dq.launches == before + 2
    want = sa.social_attention_bwd_dq_plain(*args)
    assert torch.isfinite(got).all()
    err = (got - want).abs().amax(dim=1)
    bound = 1e-3 * want.abs().amax(dim=1) + 2e-5
    assert bool((err <= bound).all()), float(err.max())
    assert torch.equal(got, again)                 # fixed order, no atomics


@pytest.mark.cuda
def test_torch_dq_kernel_bits_do_not_depend_on_the_grid_on_cuda():
    """A row's dx is added inside the one tile that holds it, so a grid of
    7 blocks walking the tiles with a stride gives the bits of the full
    grid; the C entry refuses 0 blocks and an H it does not take."""
    _need_cuda()
    args, uc = _cuda_args("shuffled", 256, 64)
    x4, ids, h, wh, g, stats, r, w = args
    fn = sa._lib(sa._BWD, "social_attention_bwd_dq", 13, 4)
    dx = {}
    for blocks in (sa.dq_blocks(256), 7):
        dx[blocks] = torch.empty(256, 4, device="cuda")
        sa._call(sa._BWD, fn, x4, ids, h, g, stats, r, *uc, *w[:4],
                 dx[blocks], 256, 64, blocks, 0, 1, None)
    torch.cuda.synchronize()
    assert torch.equal(dx[7], dx[sa.dq_blocks(256)])
    for hdim, blocks in ((64, 0), (136, 128), (40, 128)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            sa._call(sa._BWD, fn, x4, ids, h, g, stats, r, *uc, *w[:4],
                     dx[7], 256, hdim, blocks, 0, 1, None)
