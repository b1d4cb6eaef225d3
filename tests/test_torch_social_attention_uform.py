"""The u-form of the social-attention scores, the launch sizes the wrappers
compute in Python, and the saved u and c of the autograd Function.

The CUDA forward and dkv score a pair as ``a2_ij . u_j + c_j`` with
``u_j = W3 wh_j`` and ``c_j = b3 . wh_j`` instead of ``f_ij . wh_j``.  The
u-form is built here, in the test, from seeded numpy inputs (ETH-like
sorted scenes, unsorted ids, a singleton scene, a padded tail; H = F = 32
and 64), and held against JAX's ``_pair_scores`` and the port's dense
plain form at f32 rtol 1e-4 / atol 1e-5 (the same sums in another order).
The scores' test holds each of the three float32 computations (the
u-form, the plain form, JAX's ``_pair_scores``) against a float64 numpy
oracle of the same scores at that tolerance, one check a side, so that a
failure names the side that moved.  JAX is imported inside the tests that
use it."""

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator
from socialways_torch.ops.nn import linear_apply, mlp_apply
from socialways_torch.ops.social import scene_mask, social_features

RTOL, ATOL = 1e-4, 1e-5


def _ids(kind, n, rng):
    """ETH-like scenes of 2-16 agents sorted by id, the fourth a singleton,
    and a padded tail of 10 %; ``unsorted`` shuffles them."""
    ids = np.full(n, -1, np.int32)
    row, sid = 0, 0
    while row < int(n * 0.9):
        s = 1 if sid == 3 else int(rng.randint(2, 17))
        ids[row:row + s] = sid
        row, sid = row + s, sid + 1
    ids[int(n * 0.9):] = -1
    return ids[rng.permutation(n)] if kind == "unsorted" else ids


def _setup(kind, hidden, seed, n=96):
    rng = np.random.RandomState(seed)
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=hidden // 2)
    gen = init_generator(cfg, torch.Generator().manual_seed(seed), "cpu")
    x4 = np.concatenate([rng.rand(n, 2), rng.randn(n, 2) * 0.3], axis=1)
    x4[min(5, n - 1), 2:] = 0.0           # a stationary agent
    h = np.tanh(rng.randn(n, hidden))
    return (gen, torch.from_numpy(x4.astype(np.float32)),
            torch.from_numpy(h.astype(np.float32)),
            torch.from_numpy(_ids(kind, n, rng)))


def _uform_scores(gen, x4, h):
    """s_ij = relu(relu(feat_ij W1 + b1) W2 + b2) . u_j + c_j."""
    (w1, b1), (w2, b2), (w3, b3) = ((m.w, m.b) for m in gen.feat_mlp)
    wh = linear_apply(gen.attn_w, h)
    a2 = torch.relu(torch.relu(social_features(x4) @ w1 + b1) @ w2 + b2)
    u, c = wh @ w3.T, wh @ b3
    return torch.einsum("ijk,jk->ij", a2, u) + c[None, :]


def _scores_f64(gen, x4, wh) -> np.ndarray:
    """The pair scores ``f_ij . wh_j`` in float64 numpy from the float32
    inputs: the oracle each float32 computation is held against."""
    x = x4.numpy().astype(np.float64)
    p, v = x[:, :2], x[:, 2:]
    dp, dv = p[:, None] - p[None], v[:, None] - v[None]
    norm = lambda a: np.sqrt((a * a).sum(-1))
    dist = norm(dp)
    bearing = (np.einsum("ijk,ik->ij", dp, v)
               / (dist * norm(v)[:, None] + 1e-6))
    ttca = -(dp * dv).sum(-1) / ((dv * dv).sum(-1) + 1e-6)
    f = np.stack([dist, bearing, norm(dp + ttca[..., None] * dv)], -1)
    for k, layer in enumerate(gen.feat_mlp):
        w, b = (t.detach().numpy().astype(np.float64)
                for t in (layer.w, layer.b))
        f = (np.maximum(f, 0.0) if k else f) @ w + b
    return np.einsum("ijf,jf->ij", f, wh.numpy().astype(np.float64))


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("kind", ["sorted", "unsorted"])
@pytest.mark.parametrize("side", ["uform", "plain", "jax"])
def test_torch_uform_scores_match_jax_pair_scores_and_plain(side, kind,
                                                            hidden):
    """The u-form, the plain form and JAX's ``_pair_scores``, each against
    the float64 oracle at f32 rtol 1e-4 / atol 1e-5 (every pair of the
    three then agrees within twice that).  One test a side, so that a
    failure names the side that moved and the port's own sides do not
    depend on JAX's."""
    gen, x4, h, ids = _setup(kind, hidden, seed=hidden + len(kind))
    mask = scene_mask(ids)
    assert int(mask.sum()) > 0 and int((ids < 0).sum()) > 0
    with torch.no_grad():
        wh = linear_apply(gen.attn_w, h)
        if side == "uform":
            scores = _uform_scores(gen, x4, h).numpy()
        elif side == "plain":
            scores = torch.einsum(
                "ijf,jf->ij", mlp_apply(gen.feat_mlp, social_features(x4)),
                wh).numpy()
    if side == "jax":
        jnp = pytest.importorskip("jax.numpy")
        from socialways_tpu.kernels.social_attention import _pair_scores
        weights = [jnp.asarray(t.detach().numpy()) for m in gen.feat_mlp
                   for t in (m.w, m.b)]
        scores = np.asarray(_pair_scores(jnp.asarray(x4.numpy()),
                                         jnp.asarray(x4.numpy()),
                                         jnp.asarray(wh.numpy()), *weights))
    m = mask.numpy()
    np.testing.assert_allclose(scores[m], _scores_f64(gen, x4, wh)[m],
                               rtol=RTOL, atol=ATOL,
                               err_msg=f"{side} against float64")


@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("kind", ["sorted", "unsorted"])
def test_torch_uform_attention_matches_xla_reference(kind, hidden):
    """The pooled output through the u-form scores (what the kernels
    compute) equals JAX's dense ``_xla_reference`` and the port's plain
    version; the singleton and padded rows give 0."""
    jnp = pytest.importorskip("jax.numpy")
    from socialways_tpu.kernels.social_attention import _xla_reference
    gen, x4, h, ids = _setup(kind, hidden, seed=7 * hidden + len(kind))
    mask = scene_mask(ids)
    with torch.no_grad():
        s = torch.where(mask, _uform_scores(gen, x4, h), -1e9)
        p = torch.where(mask, torch.exp(s - s.max(-1, keepdim=True).values),
                        0.0)
        got = (p / p.sum(-1, keepdim=True).clamp_min(1e-20)) @ h
        plain = sa.social_attention_plain(gen.feat_mlp, gen.attn_w, x4, h,
                                          ids)
    lin = lambda m_: {"w": jnp.asarray(m_.w.detach().numpy()),
                      "b": jnp.asarray(m_.b.detach().numpy())}
    params = {"feat_mlp": [lin(m_) for m_ in gen.feat_mlp],
              "attn_w": lin(gen.attn_w)}
    want = np.asarray(_xla_reference(params, jnp.asarray(x4.numpy()),
                                     jnp.asarray(h.numpy()),
                                     jnp.asarray(ids.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    lonely = ~mask.any(-1)
    assert int(lonely.sum()) >= 1 + int((ids < 0).sum())
    assert float(got[lonely].abs().max()) == 0.0


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 1055, 1056, 1057,
                               2048, 100_000])
def test_torch_attention_launch_sizes(n):
    """Tiles of 2 agents: ceil(N / 2) forward and dq blocks (dq keeps no
    per-block partials, so its grid is not capped); dkv at most 528
    blocks, one 2240-float partial slot each; a block walks tiles b,
    b + blocks, ... so every tile is taken exactly once."""
    tiles = (n + 1) // 2
    assert sa.fwd_blocks(n) == tiles
    assert sa.dq_blocks(n) == tiles
    assert sa.dkv_blocks(n) == min(tiles, 528)
    assert sa.dkv_partial_floats(n) == sa.dkv_blocks(n) * 2240
    assert sa.fwd_blocks(256) == sa.dq_blocks(256) == 128   # ~ the 132 SMs
    for blocks in (sa.fwd_blocks(n), sa.dq_blocks(n), sa.dkv_blocks(n)):
        walked = np.concatenate([np.arange(b, tiles, blocks)
                                 for b in range(blocks)])
        assert walked.size == tiles
        assert np.array_equal(np.sort(walked), np.arange(tiles))


@pytest.mark.parametrize("case", ["one agent", "all padding", "one scene"])
def test_torch_attention_plain_edge_scenes(case):
    """The oracle the kernels are held to, at the sizing edge cases: N = 1
    and all padding give 0 and stats (-1e9, 0) with zero gradients; one
    scene of N gives every row N - 1 neighbours."""
    n = {"one agent": 1, "all padding": 9, "one scene": 33}[case]
    gen, x4, h, _ = _setup("sorted", 32, seed=n, n=n)
    ids = torch.full((n,), -1 if case == "all padding" else 0,
                     dtype=torch.int32)
    g = torch.from_numpy(np.random.RandomState(n).randn(n, 32)
                         .astype(np.float32))
    with torch.no_grad():
        out, m, l = sa.social_attention_stats_plain(gen.feat_mlp, gen.attn_w,
                                                    x4, h, ids)
        wh = linear_apply(gen.attn_w, h)
    stats, r = torch.stack([m, l], -1), (g * out).sum(-1)
    w = [t.detach() for m_ in gen.feat_mlp for t in (m_.w, m_.b)]
    u, c = wh @ w[4].T, wh @ w[5]
    dkv = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w, u, c)
    dq = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, w, u, c)
    if case == "one scene":
        assert int(scene_mask(ids).sum()) == n * (n - 1)
        assert bool((l >= 1.0).all()) and bool(out.abs().sum(-1).gt(0).all())
        assert all(bool(torch.isfinite(t).all()) for t in [dq, *dkv])
    else:
        assert float(out.abs().max()) == 0.0
        assert bool((m == -1e9).all()) and bool((l == 0).all())
        assert float(dq.abs().max()) == 0.0
        assert all(float(t.abs().max()) == 0.0 for t in dkv)


# ---------------------------------------------------------------- the card
@pytest.mark.cuda
def test_torch_attention_function_hands_u_c_to_both_backwards(monkeypatch):
    """u and c that ``_SocialAttention`` saves from its forward reach the dq
    and the dkv wrapper unchanged (no second computation of them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen, x4, h, ids = _setup("unsorted", 64, seed=3, n=256)
    for m_ in [*gen.feat_mlp, gen.attn_w]:
        m_.cuda()
    x4, h, ids = x4.cuda().requires_grad_(), h.cuda().requires_grad_(), \
        ids.cuda()
    seen = {}
    launch, dq, dkv = (sa._launch_fwd, sa.social_attention_bwd_dq,
                       sa.social_attention_bwd_dkv)

    def rec_launch(*a, **k):
        seen["fwd"] = launch(*a, **k)
        return seen["fwd"]

    def rec(name, fn):
        def inner(*a, **k):
            seen[name] = a[8:10]         # u, c follow the weights
            return fn(*a, **k)
        inner.launches = fn.launches     # the wrapper counts on its name
        return inner

    monkeypatch.setattr(sa, "_launch_fwd", rec_launch)
    monkeypatch.setattr(sa, "social_attention_bwd_dq", rec("dq", dq))
    monkeypatch.setattr(sa, "social_attention_bwd_dkv", rec("dkv", dkv))
    out = sa.social_attention_fwd(gen.feat_mlp, gen.attn_w, x4, h, ids)
    out.square().sum().backward()
    torch.cuda.synchronize()
    _, _, u, c = seen["fwd"]
    for name in ("dq", "dkv"):
        assert seen[name][0] is u and seen[name][1] is c, name
    with torch.no_grad():
        wh = linear_apply(gen.attn_w, h)
    w3, b3 = gen.feat_mlp[2].w.detach(), gen.feat_mlp[2].b.detach()
    np.testing.assert_allclose(u.cpu().numpy(), (wh @ w3.T).cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(c.cpu().numpy(), (wh @ b3).cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    assert torch.isfinite(x4.grad).all() and torch.isfinite(h.grad).all()


@pytest.mark.cuda
def test_torch_attention_dkv_refuses_a_partial_size_not_its_own():
    """The dkv C entry owns the partial slot's size: scratch sized for
    another slot (one float short, or one slot too few) is refused before
    any launch instead of written past."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, feat = 256, 64
    blocks = sa.dkv_blocks(n)
    kw = dict(device="cuda", dtype=torch.float32)
    ids = torch.zeros(n, device="cuda", dtype=torch.int32)
    ins = [torch.zeros(n, 4, **kw), ids, torch.zeros(n, 64, **kw),
           torch.zeros(n, feat, **kw), torch.zeros(n, 64, **kw),
           torch.zeros(n, 2, **kw), torch.zeros(n, **kw),
           torch.zeros(n, 64, **kw), torch.zeros(n, **kw)]
    shapes = [(3, 32), (32,), (32, 64), (64,), (64, feat), (feat,)]
    weights = [torch.zeros(s_, **kw) for s_ in shapes]
    outs = [torch.empty(n, 64, **kw), torch.empty(n, **kw)]
    tail = [None, torch.empty(n, 64, **kw), torch.empty(n, feat, **kw),
            torch.empty(64, feat, **kw), torch.empty(feat, **kw),
            torch.empty(2240, **kw)]
    fn = sa._lib(sa._BWD, "social_attention_bwd_dkv", 24, 6)
    for floats in (blocks * 2240 - 1, (blocks - 1) * 2240):
        partial = torch.empty(blocks * 2240, **kw)
        with pytest.raises(RuntimeError, match="CUDA error"):
            sa._call(sa._BWD, fn, *ins, *weights, *outs, partial, *tail, n,
                     64, feat, blocks, floats, 0, 1, None)
