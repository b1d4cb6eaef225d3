"""bf16 mixed precision (``compute_dtype="bfloat16"``, ``--bf16``) of
socialways_torch against socialways_tpu: ``linear_apply`` and
``lstm_cell``, the social attention's plain bf16 forms (the contract of the
bf16 CUDA kernels) against the Pallas kernels in interpret mode, a loo
``gan_step`` (also accumulated) with JAX's attention on its Pallas path,
``eval_chunk``, ``crowd_simulate``, the CLI's ``--bf16`` and a CPU training
run.  Inputs are made with numpy from a seed; weights and inputs hold
bf16-representable values, so the float32 runs see the same numbers.

Tolerances.  ``linear_apply`` and ``lstm_cell`` differ from JAX only in the
order of a float32 sum before the one rounding to bf16: at most one bf16
ulp apart, bit-equal on >= 99 % of the elements.  Everything else is held
by ``assert_bf16_close``: the port's bf16 result against JAX's bf16 one at
a quarter (values, losses) or half (gradients) of the mean distance, and
half the max distance, between JAX's bf16 and JAX's float32 results on the
same inputs (or one bf16 ulp of the largest value, where that is more:
outputs that are themselves bf16 differ by whole ulps).  A port that
quietly ran float32 sits at JAX's float32 distance and fails the mean
bound.  The remaining gap between the port and JAX's bf16 has two known
sources: the Pallas forward rounds p against the running max of its
64-column tile (the port against the row's max, as the CUDA kernel against
its batch's), and JAX's vjp rounds per-pair and per-tile cotangents to
bf16 where the port keeps them float32 (hence the gradients' half); JAX's
backward runs with one tile of 128 rows, so each weight gradient is
rounded once.

CUDA cases (``cuda`` mark, skipped without a card) hold the bf16 kernels
against the plain bf16 forms on the card; they import no JAX:
``python -m pytest tests/test_torch_bf16.py -m cuda --noconftest``."""

import functools
import importlib

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator
from socialways_torch.ops.nn import cast_params, linear_apply

BF = torch.bfloat16
H = 32


def r16(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to bf16 values."""
    return torch.tensor(np.asarray(a, np.float32)).to(BF).float().numpy()


def ulp16(x: float) -> float:
    """The bf16 spacing at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def assert_bf16_close(got, want16, want32, what: str, rowwise=False,
                      frac=0.25):
    """``got`` (the port, bf16) against ``want16`` (JAX, bf16), with
    ``want32`` (JAX, float32) setting the scale: mean distance at most
    ``frac`` of JAX's bf16-to-f32 one (0.5 for gradients), max at most half
    of it; see the module docstring.  ``rowwise``: distances relative to
    each row's largest |want16|."""
    got, want16, want32 = (np.asarray(a, np.float32)
                           for a in (got, want16, want32))
    assert np.isfinite(got).all(), what

    def dist(a):
        e = np.abs(a - want16)
        if rowwise:
            e = e / (np.abs(want16).max(axis=-1, keepdims=True) + 1e-30)
        return e
    ref = dist(want32)
    assert ref.mean() > 0, f"{what}: JAX's bf16 and f32 agree"
    bound_max = max(0.5 * ref.max(),
                    0.0 if rowwise else ulp16(np.abs(want16).max()))
    e = dist(got)
    assert e.max() <= bound_max and e.mean() <= frac * ref.mean(), (
        f"{what}: max {e.max():.3e} (bound {bound_max:.3e}), mean "
        f"{e.mean():.3e} (bound {frac * ref.mean():.3e}); JAX bf16 vs f32 "
        f"max {ref.max():.3e} mean {ref.mean():.3e}")


def _gen16(hidden=H, seed=3, **kw):
    """A CPU generator whose float32 weights hold bf16 values."""
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=hidden // 2, **kw)
    gen = init_generator(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(p.to(BF).float())
    return gen


def _inputs(n, hidden, seed, scene=7):
    """x4, h, g, ids: sorted scenes, a padded tail, a singleton scene and a
    stationary agent (the safe-norm edge); x4 and h bf16 values."""
    rng = np.random.RandomState(seed)
    x4 = r16(rng.randn(n, 4))
    x4[3, 2:] = 0.0
    h = r16(np.tanh(rng.randn(n, hidden)))
    g = rng.randn(n, hidden).astype(np.float32)
    ids = (np.arange(n) // scene).astype(np.int32)
    ids[n - 8:] = -1
    ids[n - 9] = ids[n - 10] + 1
    return x4, h, g, ids


def _jax_params(gen):
    jnp = pytest.importorskip("jax.numpy")
    lin = lambda m: {"w": jnp.asarray(m.w.detach().numpy()),
                     "b": jnp.asarray(m.b.detach().numpy())}
    return {"feat_mlp": [lin(m) for m in gen.feat_mlp],
            "attn_w": lin(gen.attn_w)}


def _jsa():
    pytest.importorskip("jax")
    return importlib.import_module("socialways_tpu.kernels.social_attention")


# --------------------------------------------------------------- the layers
def test_torch_bf16_linear_and_lstm_cell_match_jax():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from socialways_tpu.ops import lstm as jlstm
    from socialways_tpu.ops import nn as jnn
    from socialways_torch.ops.lstm import LSTMCell, lstm_cell
    from socialways_torch.ops.nn import Linear
    rng = np.random.RandomState(0)
    x = r16(rng.randn(512, 48))
    w, b = r16(rng.randn(48, 40) / 7), r16(rng.randn(40))
    lw, lb = r16(rng.randn(48 + 32, 128) / 9), r16(rng.randn(128))
    h, c = r16(rng.randn(512, 32)), r16(rng.randn(512, 32))
    j16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    t16 = lambda a: torch.from_numpy(a).to(BF)
    want = [jnn.linear_apply({"w": j16(w), "b": j16(b)}, j16(x)),
            *jlstm.lstm_cell({"w": j16(lw), "b": j16(lb)}, j16(x),
                             (j16(h), j16(c)))]
    lin, cell = Linear(48, 40), LSTMCell(48, 32)
    with torch.no_grad():
        for m, ww, bb in ((lin, w, b), (cell, lw, lb)):
            m.w.copy_(torch.from_numpy(ww))
            m.b.copy_(torch.from_numpy(bb))
        got = [linear_apply(cast_params(lin, BF), t16(x)),
               *lstm_cell(cast_params(cell, BF), t16(x), (t16(h), t16(c)))]
    for name, g, wv in zip(["linear", "lstm h", "lstm c"], got, want):
        assert g.dtype == BF, name
        g, wv = g.float().numpy(), np.asarray(wv, np.float32)
        ulps = np.abs(g - wv) / np.vectorize(ulp16)(wv)
        assert ulps.max() <= 1.0, (name, ulps.max())
        assert np.mean(g == wv) >= 0.99, (name, np.mean(g == wv))


# ------------------------------------------------------ the social attention
def test_torch_bf16_attention_forward_matches_pallas_interpret():
    """The plain bf16 forward with its stats against ``_pallas_forward(h
    bf16)``; out, m and l float32, as the kernel writes them."""
    jsa = _jsa()
    jnp = pytest.importorskip("jax.numpy")
    n = 96
    gen = _gen16()
    x4, h, _, ids = _inputs(n, H, 5)
    p = _jax_params(gen)
    want = {}
    for dt in ("bfloat16", "float32"):
        o, st = jsa._pallas_forward(p, jnp.asarray(x4),
                                    jnp.asarray(h).astype(dt),
                                    jnp.asarray(ids), interpret=True,
                                    with_stats=True)
        want[dt] = [np.asarray(o)[:n], np.asarray(st)[:n, 0],
                    np.asarray(st)[:n, 1]]
    g16 = cast_params(gen, BF)
    with torch.no_grad():
        got = sa.social_attention_stats_plain(
            g16.feat_mlp, g16.attn_w, torch.from_numpy(x4).to(BF),
            torch.from_numpy(h).to(BF), torch.from_numpy(ids))
        served = sa.social_attention_fwd(
            g16.feat_mlp, g16.attn_w, torch.from_numpy(x4).to(BF),
            torch.from_numpy(h).to(BF), torch.from_numpy(ids))
    for name, a, w16, w32 in zip(["out", "m", "l"], got, want["bfloat16"],
                                 want["float32"]):
        assert a.dtype == torch.float32, name
        assert_bf16_close(a.numpy(), w16, w32, f"forward {name}")
    # the wrapper's output: the same values, cast to bf16
    assert served.dtype == BF
    assert torch.equal(served, got[0].to(BF))
    assert float(got[0][n - 9].abs().max()) == 0.0     # singleton scene
    assert float(got[2][n - 9]) == 0.0 and float(got[1][n - 9]) == -1e9


def _port_bwd(gen, x4, h, g, ids):
    """dx, dh, dw1..db3, dWw, dbw for L = sum(out * g) from the plain bf16
    stats, dq and dkv, with dL/dwh pulled back through wh = h W + b."""
    x4, hb, g = (torch.from_numpy(x4), torch.from_numpy(h).to(BF),
                 torch.from_numpy(g))
    ids = torch.from_numpy(ids)
    w = [t.detach() for layer in gen.feat_mlp for t in (layer.w, layer.b)]
    with torch.no_grad():
        out, m, l = sa.social_attention_stats_plain(gen.feat_mlp, gen.attn_w,
                                                    x4, hb, ids)
        wh = linear_apply(gen.attn_w, hb)
        stats, r = torch.stack([m, l], dim=-1), (g * out).sum(-1)
        dxi = sa.social_attention_bwd_dq_plain(x4, ids, hb, wh, g, stats, r,
                                               w)
        dxj, dh, dwh, *dw = sa.social_attention_bwd_dkv_plain(
            x4, ids, hb, wh, g, stats, r, w)
        assert all(t.dtype == torch.float32 for t in [dxi, dxj, dh, dwh, *dw])
        ww = gen.attn_w.w.detach()
        return [dxi + dxj, dh + dwh @ ww.T, *dw, hb.float().T @ dwh,
                dwh.sum(0)]


def _jax_bwd(jsa, p, x4, h, g, ids, dtype):
    """JAX's ``_pallas_backward`` after a with-stats forward, h in
    ``dtype`` (the operand mode), float32 weights and x4; one 128-row tile
    each way."""
    jnp = pytest.importorskip("jax.numpy")
    args = (p, jnp.asarray(x4), jnp.asarray(h).astype(dtype),
            jnp.asarray(ids))
    out_pad, stats = jsa._pallas_forward(*args, with_stats=True,
                                         interpret=True)
    dp, dx, dh = jsa._pallas_backward(*args, jnp.asarray(g), out_pad, stats,
                                      tile_big=128, tile_small=128,
                                      interpret=True)
    flat = [dx, dh] + [t for layer in dp["feat_mlp"]
                       for t in (layer["w"], layer["b"])]
    return [np.asarray(a, np.float32)
            for a in flat + [dp["attn_w"]["w"], dp["attn_w"]["b"]]]


_GRADS = ["dx", "dh", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dWw", "dbw"]
# JAX's dh is bf16 (h's dtype) and each feature-MLP gradient one bf16
# rounding of a float32 sum; the port's are compared after the same rounding
_ROUNDED = {"dh", "dw1", "db1", "dw2", "db2", "dw3", "db3"}


def test_torch_bf16_attention_backward_matches_pallas_interpret():
    """The plain dq and dkv in bf16 mode against ``_pallas_backward`` with
    bf16 h, a padding row, a singleton scene and a stationary agent among
    the inputs.  dx is held row by row (the stationary agent's row carries
    the 1/(dist |v| + 1e-6) factor of the bearing)."""
    jsa = _jsa()
    n = 96
    gen = _gen16()
    x4, h, g, ids = _inputs(n, H, 5)
    p = _jax_params(gen)
    w16 = _jax_bwd(jsa, p, x4, h, g, ids, "bfloat16")
    w32 = _jax_bwd(jsa, p, x4, h, g, ids, "float32")
    got = [t.numpy() for t in _port_bwd(gen, x4, h, g, ids)]
    for name, a, b16, b32 in zip(_GRADS, got, w16, w32):
        if name in _ROUNDED:
            a, b32 = r16(a), r16(b32)
        assert_bf16_close(a, b16, b32, f"backward {name}",
                          rowwise=name == "dx", frac=0.5)
    assert np.abs(got[0][n - 8:]).max() == 0.0         # padding rows


def test_torch_bf16_attention_autograd_matches_pallas_custom_vjp(
        monkeypatch):
    """The CPU path's autograd through the dense bf16 form (weights and h
    cast to bf16 from float32 masters; x4 float32, as the kernels read it,
    so dx is float32 in both) against ``jax.grad`` through
    ``social_attention_fused`` with its Pallas forward and backward."""
    jsa = _jsa()
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    n = 64
    gen = _gen16(seed=4)
    x4, h, _, ids = _inputs(n, H, 6, scene=6)
    p = _jax_params(gen)
    monkeypatch.setattr(jsa, "_FWD_INTERPRET", True)
    monkeypatch.setattr(jsa, "_BWD_INTERPRET", True)
    monkeypatch.setattr(jsa, "_pallas_backward", functools.partial(
        jsa._pallas_backward, tile_small=128))

    def jloss(dt):
        def f(p_, x_, h_):
            c = lambda t: t.astype(dt)
            out = jsa.social_attention_fused(
                jax.tree_util.tree_map(c, p_), x_, c(h_), jnp.asarray(ids))
            return jnp.sum(jnp.sin(out.astype(jnp.float32)))
        gp, gx, gh = jax.grad(f, argnums=(0, 1, 2))(p, jnp.asarray(x4),
                                                    jnp.asarray(h))
        return [gx, gh] + [t for layer in gp["feat_mlp"]
                           for t in (layer["w"], layer["b"])] + [
            gp["attn_w"]["w"], gp["attn_w"]["b"]]
    want16, want32 = jloss(jnp.bfloat16), jloss(jnp.float32)

    xt = torch.from_numpy(x4).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    g16 = cast_params(gen, BF)
    out = sa.social_attention(g16.feat_mlp, g16.attn_w, xt, ht.to(BF),
                              torch.from_numpy(ids))
    assert out.dtype == BF
    torch.sin(out.float()).sum().backward()
    got = [xt.grad, ht.grad] + [t.grad for layer in gen.feat_mlp
                                for t in (layer.w, layer.b)] + [
        gen.attn_w.w.grad, gen.attn_w.b.grad]
    for name, a, b16, b32 in zip(_GRADS, got, want16, want32):
        assert a.dtype == torch.float32, name
        b32 = np.asarray(b32, np.float32)
        if name != "dx":
            # the gradient reaches its float32 master through a bf16 cast
            assert torch.equal(a, a.to(BF).float()), name
            b32 = r16(b32)
        assert_bf16_close(a.numpy(), b16, b32, f"autograd {name}",
                          rowwise=name == "dx", frac=0.5)


@pytest.mark.parametrize("form", ["windowed", "blockwise"])
def test_torch_bf16_crowd_forms_match_dense(form):
    """The windowed and blockwise bf16 forms against the dense bf16 plain
    form (bf16 outputs: whole ulps), scale set by the dense float32 form
    on the same values."""
    n, scene = 96, 8
    gen = _gen16(seed=5)
    x4, h, _, _ = _inputs(n, H, 7)
    ids = (np.arange(n) // scene).astype(np.int32)
    ids[n - 5:] = -1
    g16 = cast_params(gen, BF)
    t = lambda a, dt: torch.from_numpy(a).to(dt)
    with torch.no_grad():
        if form == "windowed":
            got = sa.social_context_windowed(g16.feat_mlp, g16.attn_w,
                                             t(x4, BF), t(h, BF),
                                             torch.from_numpy(ids), scene,
                                             block=16)
        else:
            got = sa.social_context_blockwise(g16.feat_mlp, g16.attn_w,
                                              t(x4, BF), t(h, BF),
                                              torch.from_numpy(ids), block=32)
        dense = sa.social_attention_plain(g16.feat_mlp, g16.attn_w,
                                          t(x4, BF), t(h, BF),
                                          torch.from_numpy(ids))
        dense32 = sa.social_attention_plain(gen.feat_mlp, gen.attn_w,
                                            t(x4, torch.float32),
                                            t(h, torch.float32),
                                            torch.from_numpy(ids))
    assert got.dtype == BF and dense.dtype == BF
    assert_bf16_close(got.float().numpy(), dense.float().numpy(),
                      r16(dense32.numpy()), form)


def test_torch_bf16_kernel_wrappers_refuse_mixed_operands():
    """h, wh and the six MLP tensors share one operand dtype, float32 or
    bf16; the wrappers raise before any launch (on any device)."""
    gen = _gen16(hidden=64)
    x4, h, _, ids = _inputs(32, 64, 1)
    x4, ids = torch.from_numpy(x4), torch.from_numpy(ids)
    hb = torch.from_numpy(h).to(BF)
    w16 = [t.detach().to(BF) for m in gen.feat_mlp for t in (m.w, m.b)]
    wh = linear_apply(gen.attn_w, hb.float()).detach()
    with pytest.raises(ValueError, match="wh has dtype"):
        sa._launch_fwd(x4, ids, hb, wh, w16, with_stats=False)
    with pytest.raises(ValueError, match="feat_mlp w1 has dtype"):
        sa._launch_fwd(x4, ids, hb, wh.to(BF), [w.float() for w in w16],
                       with_stats=False)
    with pytest.raises(ValueError, match="expected float32 or bfloat16"):
        sa._launch_fwd(x4, ids, hb.half(), wh.half(),
                       [w.half() for w in w16], with_stats=False)
    with pytest.raises(ValueError, match="x4_last has dtype"):
        sa._launch_fwd(x4.to(BF), ids, hb, wh.to(BF), w16, with_stats=False)


# ------------------------------------------------------------------ the card
def _card_case(n, seed, scene):
    """The loo width (H = F = 64) on the card: a bf16 view of a generator,
    float32 x4, bf16 h, sorted ids (``scene`` rows a scene, or 2-16 when
    0) with a padded tail, and wh = h W + b rounded to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(seed)
    if scene:
        ids = (np.arange(n) // scene).astype(np.int32)
    else:
        ids = np.repeat(np.arange(n), rng.randint(2, 17, n))[:n]
        ids = ids.astype(np.int32)
    ids[n - n // 25:] = -1
    dev = torch.device("cuda")
    gen = _gen16(hidden=64, seed=seed).to(dev)
    g16 = cast_params(gen, BF)
    x4 = torch.from_numpy(rng.randn(n, 4).astype(np.float32)).to(dev)
    h = torch.from_numpy(np.tanh(rng.randn(n, 64))).to(dev, BF)
    ids = torch.from_numpy(ids).to(dev)
    w16 = [t.detach() for m in g16.feat_mlp for t in (m.w, m.b)]
    wh = linear_apply(g16.attn_w, h.float()).detach().to(BF)
    return g16, x4, h, ids, wh, w16


def _close_scaled(got, want, rel, what):
    """max |got - want| <= rel * max |want| (+ 1e-6)."""
    err = float((got.float() - want.float()).abs().max())
    bound = rel * float(want.float().abs().max()) + 1e-6
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,scene,w", [(256, 0, 0), (1000, 16, 16)])
def test_torch_bf16_kernels_match_plain_on_the_card(n, scene, w):
    """The bf16 forward (with stats), dq and dkv against their plain bf16
    versions on the card, from the same stats, u and c; a w > 0 launch
    gives the w = 0 launch's bits.  Bounds (sums in another order flip a
    bf16 rounding of a1 or a2 now and then, and the kernel rounds p against
    its batch's running max): out within 8e-3 (two bf16 ulps of |h| <= 1),
    m within 1e-3 (1 + |m|), l within 1e-2 l, dx within 3e-2 of its row's
    largest value, the other gradients within 1e-2 of their largest."""
    g16, x4, h, ids, wh, w16 = _card_case(n, 7, scene)
    counts = {f: (f.launches, f.launches_bf16) for f in (
        sa.social_attention_fwd, sa.social_attention_bwd_dq,
        sa.social_attention_bwd_dkv)}
    res = {}
    for ww in sorted({0, w}):
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w16, True, ww)
        g = torch.randn(n, 64, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
        r = (g * out).sum(-1)
        dx = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, w16, u,
                                        c, max_scene=ww)
        dkv = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w16,
                                          u, c, max_scene=ww)
        torch.cuda.synchronize()
        res[ww] = [out, stats, dx] + [t for t in dkv]
    for a, b in zip(res[0], res[w]):
        assert torch.equal(a, b)
    for f, (l32, l16) in counts.items():
        assert f.launches == l32, "a bf16 call launched a float32 kernel"
    assert sa.social_attention_fwd.launches_bf16 - counts[
        sa.social_attention_fwd][1] == len(res)
    assert sa.social_attention_bwd_dkv.launches_bf16 - counts[
        sa.social_attention_bwd_dkv][1] == len(res)
    out, stats, dx, dxj, dh, dwh, *dws = res[0]
    with torch.no_grad():
        p_out, p_m, p_l = sa.social_attention_stats_plain(
            g16.feat_mlp, g16.attn_w, x4, h, ids)
        p_dxi = sa.social_attention_bwd_dq_plain(x4, ids, h, wh, g, stats, r,
                                                 w16)
        p_dxj, p_dh, p_dwh, *p_dws = sa.social_attention_bwd_dkv_plain(
            x4, ids, h, wh, g, stats, r, w16)
    assert out.dtype == torch.float32
    assert float((out - p_out).abs().max()) <= 8e-3
    assert bool(((stats[:, 0] - p_m).abs() <= 1e-3 * (1 + p_m.abs())).all())
    assert bool(((stats[:, 1] - p_l).abs() <= 1e-2 * p_l).all())
    rows = (p_dxi + p_dxj).abs().max(dim=1).values
    assert bool(((dx + dxj - p_dxi - p_dxj).abs().max(dim=1).values
                 <= 3e-2 * rows + 1e-6).all())
    for name, a, b in zip(["dh", "dwh", "dw1", "db1", "dw2", "db2", "dw3",
                           "db3"], [dh, dwh, *dws], [p_dh, p_dwh, *p_dws]):
        _close_scaled(a, b, 1e-2, name)


@pytest.mark.cuda
def test_torch_bf16_autograd_on_the_card_matches_the_cpu():
    """Gradients through the CUDA Function (bf16 kernels) against the CPU's
    autograd through the dense bf16 form, from float32 masters through bf16
    casts; every master gradient float32, within 2e-2 of its largest (x4's
    row by row)."""
    gen_c, x4, h, ids, _, _ = _card_case(256, 9, 0)
    grads = {}
    for dev in ("cuda", "cpu"):
        gen = _gen16(hidden=64, seed=9).to(dev)
        xt = x4.detach().to(dev).requires_grad_()
        ht = h.detach().float().to(dev).requires_grad_()
        g16 = cast_params(gen, BF)
        out = sa.social_attention_fwd(g16.feat_mlp, g16.attn_w, xt.to(BF),
                                      ht.to(BF), ids.to(dev))
        assert out.dtype == BF
        torch.sin(out.float()).sum().backward()
        grads[dev] = [xt.grad, ht.grad] + [p.grad for p in (
            *[t for m in gen.feat_mlp for t in (m.w, m.b)], gen.attn_w.w,
            gen.attn_w.b)]
        assert all(a.dtype == torch.float32 for a in grads[dev])
    rows = grads["cpu"][0].abs().max(dim=1).values
    assert bool(((grads["cuda"][0].cpu() - grads["cpu"][0]).abs().max(
        dim=1).values <= 2e-2 * rows + 1e-6).all())
    for i, (a, b) in enumerate(zip(grads["cuda"][1:], grads["cpu"][1:])):
        _close_scaled(a.cpu(), b, 2e-2, f"grad {i}")


# ------------------------------------------------- the step, eval, simulate
LOO16 = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
             n_past=8, n_next=12, agent_frame=True, use_social=True,
             g_ema_decay=0.999, d_input_noise=0.05, d_input_noise_steps=3,
             d_input_noise_floor=0.02)


class _PallasInterpret:
    """JAX's attention on its Pallas path in interpret mode (the dispatch
    and the custom vjp), its backward with one tile of 128 rows."""

    def __enter__(self):
        self.jsa = _jsa()
        self.saved = (self.jsa._FWD_INTERPRET, self.jsa._BWD_INTERPRET,
                      self.jsa._pallas_backward)
        self.jsa._FWD_INTERPRET = self.jsa._BWD_INTERPRET = True
        self.jsa._pallas_backward = functools.partial(self.saved[2],
                                                      tile_small=128)

    def __exit__(self, *exc):
        (self.jsa._FWD_INTERPRET, self.jsa._BWD_INTERPRET,
         self.jsa._pallas_backward) = self.saved


def _jax_steps(flags, batch, seed):
    """JAX's gan_step with ``use_pallas`` from one init, in bf16 and in
    float32: (init state, {dtype: (state, metrics)})."""
    jax = pytest.importorskip("jax")
    from socialways_tpu.config import TrainConfig as JaxConfig
    from socialways_tpu.engine.train_step import gan_step as jax_gan_step
    from test_torch_train_step import jax_init
    j0 = jax_init(jax.random.PRNGKey(seed), JaxConfig(**flags))
    jb = {a: jax.numpy.asarray(v) for a, v in batch.items()}
    out = {}
    key = jax.random.PRNGKey(seed + 1)
    with _PallasInterpret():
        for dt in ("bfloat16", "float32"):
            jcfg = JaxConfig(**flags, use_pallas=True, compute_dtype=dt)
            # XLA keeps fused chains of bf16 elementwise ops in float32
            # (xla_allow_excess_precision); off, each op rounds to bf16 as
            # JAX's eager ops and the port's torch ops do
            step = jax.jit(lambda s, b, k: jax_gan_step(s, b, k, jcfg)).lower(
                j0, jb, key).compile(
                compiler_options={"xla_allow_excess_precision": False})
            out[dt] = jax.device_get(step(j0, jb, key))
    return jax.device_get(j0), out


def _port_step(flags, batch, seed, j0):
    from socialways_torch.engine.train_step import gan_step
    from socialways_torch.io.checkpoint import (flatten_state,
                                                train_state_from_jax)
    from test_torch_train_step import jax_draws, to_torch
    jax = pytest.importorskip("jax")
    tcfg = TrainConfig(**flags, compute_dtype="bfloat16")
    state = train_state_from_jax(j0, tcfg, "cpu")
    state, m = gan_step(state, to_torch(batch),
                        jax_draws(jax.random.PRNGKey(seed + 1),
                                  len(batch["valid"]), tcfg), tcfg)
    for key, leaf in flatten_state(state).items():
        if not key.endswith(".count"):
            assert leaf.dtype == np.float32, key
    return state, m


def _hold_metrics(m, want, names=("d_loss", "g_loss", "ade_sum",
                                  "fde_sum")):
    for name in names:
        assert_bf16_close(np.float32(getattr(m, name)),
                          np.float32(getattr(want["bfloat16"][1], name)),
                          np.float32(getattr(want["float32"][1], name)),
                          f"gan_step {name}")
    assert int(m.n_samples) == int(want["bfloat16"][1].n_samples)


def test_torch_bf16_loo_gan_step_matches_jax():
    """One loo ``gan_step`` in bf16 (social attention, agent frame, EMA,
    annealed instance noise, unroll 1) under JAX's draws against JAX's bf16
    step: the losses and the rollout's errors; every state leaf float32."""
    from test_torch_train_step import make_chunk
    batch = make_chunk(5)
    j0, want = _jax_steps(LOO16, batch, 40)
    _, m = _port_step(LOO16, batch, 40, j0)
    _hold_metrics(m, want)


def test_torch_bf16_grad_accum_step_matches_jax():
    """``grad_accum=2`` with a padded tail under bf16 (JAX's
    tests/test_bf16.py:97-132 case: 16 rows in 2 scene-aligned halves, the
    last two padding): the accumulated step's losses against JAX's."""
    flags = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                 n_past=4, n_next=4, batch_size=64, n_unrolling_steps=1,
                 use_social=True, grad_accum=2)
    rng = np.random.RandomState(3)
    n = 16
    batch = {"obsvs": rng.rand(n, 4, 2).astype(np.float32),
             "preds": rng.rand(n, 4, 2).astype(np.float32),
             "scene_ids": (np.arange(n) * 2 // n).astype(np.int32),
             "valid": np.ones(n, bool)}
    batch["valid"][14:] = False
    batch["scene_ids"][14:] = -1
    j0, want = _jax_steps(flags, batch, 6)
    state, m = _port_step(flags, batch, 6, j0)
    _hold_metrics(m, want, names=("d_loss", "g_loss"))
    assert state.g_opt.count == 1 and state.d_opt.count == 2


def test_torch_bf16_rollout_eval_and_simulate_match_jax():
    """``generator_rollout``, ``eval_chunk`` (K = 6) and ``crowd_simulate``
    (3 windows, sorted scenes of 8) in bf16 against JAX's with its
    attention on the Pallas path, under the same bf16 noise values; the
    rollouts and the trajectories compared as bf16 values.  JAX's eval
    draws its noise in the compute dtype, so its float32 run would see
    other noise: the K-sample rollout's float32 scale is the port's float32
    rollout under the bf16 draw (the port's float32 path equals JAX's to
    1e-5, tests/test_torch_serving.py)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from socialways_tpu.config import TrainConfig as JaxConfig
    from socialways_tpu.engine.simulate import crowd_simulate as jsim
    from socialways_tpu.eval.metrics import eval_chunk as jeval
    from socialways_tpu.eval.metrics import k_sample_rollout as jk
    from socialways_tpu.models.generator import (generator_rollout as jroll,
                                                 init_generator as jinit)
    from socialways_torch.engine.simulate import crowd_simulate
    from socialways_torch.eval.metrics import eval_chunk, k_sample_rollout
    from socialways_torch.io.checkpoint import generator_params_from_jax
    from socialways_torch.models.generator import generator_rollout
    from test_torch_train_step import make_chunk
    flags = dict(LOO16, g_ema_decay=0.0, d_input_noise=0.0)
    params = jax.device_get(jinit(jax.random.PRNGKey(8), JaxConfig(**flags)))
    tcfg = TrainConfig(**flags, compute_dtype="bfloat16")
    gen = init_generator(tcfg, torch.Generator().manual_seed(0), "cpu")
    gen.load_state_dict(generator_params_from_jax(params))
    cast = lambda t, dt: jax.tree_util.tree_map(lambda x: x.astype(dt), t)
    b = make_chunk(9)
    n = len(b["valid"])
    jb = {a: jnp.asarray(v) for a, v in b.items()}
    noise = r16(np.asarray(jax.random.uniform(jax.random.PRNGKey(2),
                                              (n, H // 2))))
    k_noise = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(3), (6, n, H // 2), jnp.bfloat16), np.float32)
    rng = np.random.RandomState(4)
    n_sim = 40
    obsv0 = (rng.rand(n_sim, 1, 2) + np.cumsum(
        rng.randn(n_sim, 8, 2) * 0.01, axis=1)).astype(np.float32)
    ids_sim = (np.arange(n_sim) // 8).astype(np.int32)
    sim_noise = r16(np.asarray(jax.random.uniform(jax.random.PRNGKey(5),
                                                  (3, n_sim, H // 2))))
    want = {}
    with _PallasInterpret():
        for dt in ("bfloat16", "float32"):
            jcfg = JaxConfig(**flags, use_pallas=True, compute_dtype=dt)
            roll = jroll(cast(params, dt), cast(jb["obsvs"], dt),
                         jnp.asarray(noise).astype(dt), 12, jb["scene_ids"],
                         use_social=True, use_pallas=True)
            sim = jsim(params, jnp.asarray(obsv0), jnp.asarray(ids_sim), 3,
                       jax.random.PRNGKey(0), jcfg,
                       noise=jnp.asarray(sim_noise).astype(dt))
            want[dt] = (np.asarray(roll, np.float32), np.asarray(sim))
        # JAX's bf16 eval draws from PRNGKey(3) in bf16: k_noise above
        jcfg16 = JaxConfig(**flags, use_pallas=True, compute_dtype="bfloat16")
        ev16 = jeval(params, jb, jax.random.PRNGKey(3), 6, jcfg16)
        rk16 = jk(params, jb["obsvs"], jb["scene_ids"], jax.random.PRNGKey(3),
                  6, jcfg16)
    t = lambda a: torch.from_numpy(np.asarray(a))
    tb = {a: t(v) for a, v in b.items()}
    with torch.no_grad():
        roll = generator_rollout(cast_params(gen, BF), t(b["obsvs"]).to(BF),
                                 t(noise).to(BF), 12, t(b["scene_ids"]),
                                 use_social=True)
        ev = eval_chunk(gen, tb, 6, tcfg, noise=t(k_noise))
        rk = k_sample_rollout(gen, tb["obsvs"], tb["scene_ids"], 6, tcfg,
                              noise=t(k_noise))
        rk32 = k_sample_rollout(gen, tb["obsvs"], tb["scene_ids"], 6,
                                tcfg.replace(compute_dtype="float32"),
                                noise=t(k_noise))
        sim = crowd_simulate(gen, t(obsv0), t(ids_sim), 3, tcfg,
                             noise=t(sim_noise))
    assert roll.dtype == BF and rk.dtype == sim.dtype == torch.float32
    assert_bf16_close(roll.float().numpy(), want["bfloat16"][0],
                      r16(want["float32"][0]), "rollout")
    v = b["valid"]
    assert_bf16_close(rk.numpy()[:, v], np.asarray(rk16, np.float32)[:, v],
                      r16(rk32.numpy())[:, v], "K-sample rollout")
    # the sums add rows' errors whose rounding noise partly cancels, so
    # their distance to JAX's float32 sets no scale: relative 2e-3
    for name in ("ade_avg", "fde_avg", "ade_min", "fde_min"):
        np.testing.assert_allclose(float(getattr(ev, name)),
                                   float(getattr(ev16, name)), rtol=2e-3,
                                   err_msg=f"eval {name}")
    assert int(ev.n_samples) == int(ev16.n_samples)
    assert_bf16_close(sim.numpy(), want["bfloat16"][1],
                      r16(want["float32"][1]), "simulate")


# ----------------------------------------------------------------- the CLI
@pytest.mark.parametrize("command", ["train", "evaluate", "predict", "sweep",
                                     "eth-ucy", "simulate"])
def test_torch_bf16_flag_builds_jax_config(command):
    """``--bf16`` sets JAX's ``compute_dtype`` on every command that takes a
    model, and the model fields JAX's CLI builds from the same argv."""
    pytest.importorskip("jax")
    from socialways_tpu.cli import main as jax_cli
    from socialways_torch.cli import main as cli
    from socialways_torch.config import MODEL_CONFIG_FIELDS
    argv = {"train": ["train", "--data", "x.npz"],
            "evaluate": ["evaluate", "--data", "x.npz"],
            "predict": ["predict", "--data", "x.npz", "--model-file", "m"],
            "sweep": ["sweep", "--data", "x.npz"],
            "eth-ucy": ["eth-ucy", "--data-dir", "d", "--recipe="],
            "simulate": ["simulate"]}[command] + ["--bf16", "--h-size", "32"]
    args = cli.parse_args(["--cpu"] + argv)
    build = cli._train_cfg
    got = build(args)
    want = jax_cli._cfg_from_args(jax_cli.build_parser().parse_args(
        jax_cli._apply_recipe(argv)))
    assert got.compute_dtype == want.compute_dtype == "bfloat16"
    for field in MODEL_CONFIG_FIELDS:
        if field not in ("n_past", "n_next"):
            assert getattr(got, field) == getattr(want, field), field
    assert build(cli.parse_args(["--cpu"] + argv[:-3])).compute_dtype == (
        "float32")


def test_torch_cpu_train_bf16_cli_run(tmp_path):
    """``--cpu train --recipe loo --bf16`` for 2 epochs on a toy set:
    finite metrics, a checkpoint of float32 arrays, and ``evaluate
    --bf16`` of it."""
    from socialways_tpu.data.toy import make_toy_npz_arrays
    from socialways_torch.cli.main import main as torch_cli
    data = str(tmp_path / "toy.npz")
    np.savez(data, **make_toy_npz_arrays(n_per_batch=6))
    log = str(tmp_path / "log.jsonl")
    assert torch_cli(["--cpu", "train", "--recipe", "loo", "--bf16",
                      "--data", data, "--epochs", "2", "--test-interval",
                      "1", "--save-interval", "2", "--h-size", "16",
                      "--batch-size", "64", "--k", "4", "--model-dir",
                      str(tmp_path), "--metrics-log", log]) == 0
    import json
    with open(log) as f:
        records = [json.loads(line) for line in f]
    values = [v for r in records for v in r.values()
              if isinstance(v, float)]
    assert values and np.isfinite(values).all()
    ckpt = tmp_path / "socialWays-hotel.npz"
    with np.load(ckpt) as d:
        state = [k for k in d.files if k.startswith((".g_", ".d_"))
                 and not k.endswith(".count")]
        assert state and all(d[k].dtype == np.float32 for k in state)
    assert torch_cli(["--cpu", "evaluate", "--bf16", "--data", data,
                      "--model-file", str(ckpt), "--h-size", "16",
                      "--k", "4"]) == 0
