"""Hidden sizes the kernels do not take natively (H and F multiples of 16
up to 128): the wrappers zero-pad H and F to multiples of 16
(``pad_widths``) and launch the wide kernels above 128, at any width.
Here, on the CPU: the padded plain path equals the unpadded one at H = F
= 24, 100 and 640 (the forward and every gradient, float32 and bf16: a
zero column adds an exact zero to every sum, so only the order of a sum
may move a bit: every output within 4 float32 ulp of its largest
element); the port's
``social_attention`` and a loo ``gan_step`` at H = 24 and 256 against
JAX's at f32 rtol 1e-4 / atol 1e-5, JAX's draws fed in as
tests/test_torch_train_step.py feeds them; the entries each width
launches.  On the card (``cuda``, skipped here): each width's kernels
against the plain function in f64 on the kernels' own long float32 sums,
each sum first held to its order.  JAX is imported inside the tests that
compare with it, so the CUDA tests also run where there is no JAX."""

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine.train_step import gan_step
from socialways_torch.io.checkpoint import (flatten_state,
                                            train_state_from_jax)
from socialways_torch.kernels import social_attention as sa
from socialways_torch.ops.nn import LinearView
from socialways_torch.ops.social import pair_embed, scene_mask
from test_torch_social_attention import _jax_reference, _port, _setup

RTOL, ATOL = 1e-4, 1e-5
K_RTOL, K_ATOL = 2e-4, 2e-5      # the kernels' elementwise bounds (phase 4)


def _operands(n, hidden, seed, dtype):
    """The kernels' operands (x4, ids, h, wh, the six MLP tensors, g) at
    H = F = ``hidden`` in ``dtype``, scenes of 7 with a padded tail."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x4 = t(np.concatenate([rng.rand(n, 2), rng.randn(n, 2) * 0.02], 1))
    ids = torch.from_numpy((np.arange(n) // 7).astype(np.int32))
    ids[n - 5:] = -1
    shapes = [(3, 32), (32,), (32, 64), (64,), (64, hidden), (hidden,)]
    w = [t(rng.randn(*s) * 0.3).to(dtype) for s in shapes]
    h = t(np.tanh(rng.randn(n, hidden))).to(dtype)
    wh = t(rng.randn(n, hidden)).to(dtype)
    return x4, ids, h, wh, w, t(rng.randn(n, hidden))


def _padded_equals(got, want):
    """``got`` from padded operands, sliced to ``want``'s widths, equal to
    ``want`` up to the order of float sums: within 4 float32 ulp of
    ``want``'s largest element (at H = 24 db3, a sum over every pair whose
    reduction follows F's layout, moves by one or two; every other output
    is equal bit for bit)."""
    got = got[tuple(slice(0, s) for s in want.shape)]
    assert got.dtype == want.dtype
    ulp = torch.finfo(torch.float32).eps
    assert float((got - want).abs().max()) <= 4 * ulp * float(
        want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hidden", [24, 100, 640])
def test_torch_padded_plain_equals_unpadded(hidden, dtype):
    x4, ids, h, wh, w, g = _operands(48, hidden, hidden, dtype)
    hp, whp, wp, gp = sa.pad_widths(h, wh, w, g)
    width = sa.padded_width(hidden)
    assert hp.shape[-1] == whp.shape[-1] == gp.shape[-1] == width
    assert wp[4].shape == (64, width) and wp[5].shape == (width,)
    assert all(a is b for a, b in zip(wp[:4], w[:4]))
    out, stats = sa.social_attention_fwd_kernel_plain(x4, ids, h, wh, w)
    out_p, stats_p = sa.social_attention_fwd_kernel_plain(x4, ids, hp, whp,
                                                          wp)
    _padded_equals(out_p, out)
    assert not out_p[:, hidden:].any()
    _padded_equals(stats_p, stats)
    r = (g * out).sum(-1)
    _padded_equals(sa.social_attention_bwd_dq_plain(x4, ids, hp, whp, gp,
                                                    stats, r, wp),
                   sa.social_attention_bwd_dq_plain(x4, ids, h, wh, g,
                                                    stats, r, w))
    got = sa.social_attention_bwd_dkv_plain(x4, ids, hp, whp, gp, stats, r,
                                            wp)
    want = sa.social_attention_bwd_dkv_plain(x4, ids, h, wh, g, stats, r, w)
    for a, b in zip(got, want):      # dx_j, dh_j, dwh_j, dW1 .. db3
        _padded_equals(a, b)


def test_torch_widths_pick_entries_and_refuse_past_the_limit():
    f32 = torch.zeros(2, 8)
    bf = f32.to(torch.bfloat16)
    assert sa._entry("social_attention_fwd", f32, 128) == \
        "social_attention_fwd"
    assert sa._entry("social_attention_fwd", f32, 144) == \
        "social_attention_fwd_wide"
    assert sa._entry("social_attention_bwd_dkv", bf, 512) == \
        "social_attention_bwd_dkv_wide_bf16"
    for width in (640, 1024):
        assert sa._entry("social_attention_bwd_dq", f32, width) == \
            "social_attention_bwd_dq_wide"
        assert sa._entry("social_attention_fwd", bf, width) == \
            "social_attention_fwd_wide_bf16"
    assert [sa.padded_width(w) for w in (1, 16, 24, 100, 500, 512, 1000)] == [
        16, 16, 32, 112, 512, 512, 1008]
    # no width ceiling: 640 and 1024 pass as they are, 1000 pads to 1008
    for width, padded in ((640, 640), (1024, 1024), (1000, 1008)):
        x4, ids, h, wh, w, g = _operands(8, width, 0, torch.float32)
        hp, whp, wp, gp = sa.pad_widths(h, wh, w, g)
        assert hp.shape[-1] == whp.shape[-1] == gp.shape[-1] == padded
        assert wp[4].shape == (64, padded)
        assert sa._check_common(x4, ids, hp, whp, wp) is None
    # the one limit left: the C entries index in int (M N max(H, F, 64))
    x4, ids, h, wh, w, g = _operands(8, 1024, 0, torch.float32)
    huge = torch.zeros(1).expand(2 ** 21, 1024)
    with pytest.raises(ValueError, match="below 2\\^31"):
        sa._check_common(x4, ids, huge, huge, w)


@pytest.mark.parametrize("hidden", [24, 256])
def test_torch_social_attention_matches_jax_at_width(hidden):
    p, gen, x4, h, ids = _setup(64, hidden, seed=hidden)
    got = _port(gen, x4, h, ids).numpy()
    want = _jax_reference(p, x4, h, ids)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [24, 256])
def test_torch_loo_gan_step_matches_jax_at_width(hidden):
    """One loo ``gan_step`` (agent frame, social attention, EMA, annealed
    instance noise) at H = F = ``hidden`` from JAX's initial state under
    JAX's draws: losses and sums at rtol 1e-4 / atol 1e-5, every state
    leaf as tests/test_torch_train_step.py holds it.  Each parameter's
    change against JAX's (atol 1e-2 lr) is held at H = 24; at 256 one of
    the 409,600 decoder weights moves 1.02e-6 from JAX's: its gradient sits
    near Adam's eps, where a rounding of g moves lr g / (|g| + eps) by a
    visible fraction (the first update's sensitivity that chip_smoke's
    first-step bound allows for), so H = 256 holds the leaves alone."""
    jax = pytest.importorskip("jax")
    from socialways_tpu.config import TrainConfig as JaxConfig
    from socialways_tpu.engine.train_step import gan_step as jax_gan_step
    from test_torch_train_step import (LOO, assert_state_close, jax_draws,
                                       jax_init, make_chunk, to_torch)
    loo = dict(LOO, hidden_size=hidden, social_feature_size=hidden,
               noise_len=hidden // 2)
    jcfg, tcfg = JaxConfig(**loo), TrainConfig(**loo)
    jstate = jax_init(jax.random.PRNGKey(hidden), jcfg)
    b, key = make_chunk(hidden), jax.random.PRNGKey(hidden + 1)
    jnext, jm = jax.jit(lambda s, c, k: jax_gan_step(s, c, k, jcfg))(
        jstate, {a: jax.numpy.asarray(v) for a, v in b.items()}, key)
    j0 = jax.device_get(jstate)
    state = train_state_from_jax(j0, tcfg, "cpu")
    old = {k: v.copy() for k, v in flatten_state(state).items()}
    state, m = gan_step(state, to_torch(b), jax_draws(key, len(b["valid"]),
                                                      tcfg), tcfg)
    assert_state_close(state, jax.device_get(jnext), tag=f"H={hidden}",
                       **(dict(t_old=old, j_old=j0, cfg=tcfg)
                          if hidden < 128 else {}))
    for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


_U = 2.0 ** -24                  # float32 unit roundoff


def _gamma(n: int) -> float:
    """Higham's gamma_n: a sum of n + 1 terms in float32, in any order, is
    within gamma_n times the sum of their magnitudes of the exact one."""
    return n * _U / (1 - n * _U)


def _sequential_u_c(wh, w3, b3):
    """u = wh W3^T [N, 64] and c = wh . b3 [N] in float32, one fused
    multiply-add after another over f = 0 .. F - 1: u_prep's order in the
    narrow and the wide kernels.  Each product is exact in f64 and each
    step is rounded to float32 (a double rounding may move a step by one
    ulp where fmaf would not)."""
    u = torch.zeros(wh.shape[0], w3.shape[0], device=wh.device)
    c = torch.zeros(wh.shape[0], device=wh.device)
    whd, w3d, b3d = wh.double(), w3.double(), b3.double()
    for f in range(wh.shape[1]):
        u = (u.double() + whd[:, f:f + 1] * w3d[None, :, f]).float()
        c = (c.double() + whd[:, f] * b3d[f]).float()
    return u, c


def _lane_gh(g, h):
    """g_i . h_j [N, N] in float32 in dkv's order (``gh_half_warp``, and
    ``gh_chunked`` above 512): H zero-padded to a multiple of 16, lane l of
    a half warp adds g[l + 16 q] h[l + 16 q] one fused multiply-add after
    another, then the 16 partials meet in the xor tree 8, 4, 2, 1."""
    width = sa.padded_width(g.shape[-1])
    g = torch.nn.functional.pad(g, (0, width - g.shape[-1])).double()
    h = torch.nn.functional.pad(h, (0, width - h.shape[-1])).double()
    part = torch.zeros(g.shape[0], h.shape[0], 16, device=g.device)
    for q in range(width // 16):
        part = (part.double() + g[:, None, 16 * q:16 * q + 16]
                * h[None, :, 16 * q:16 * q + 16]).float()
    lane = torch.arange(16, device=g.device)
    for off in (8, 4, 2, 1):
        part = part + part[..., lane ^ off]
    return part[..., 0]


def _on_kernel_sums(x4, ids, h, wh, g, r, w, u, c, gh):
    """Every output of the forward, dq and dkv in f64, with the three long
    float32 sums taken as the kernels round them: the scores' u and c
    (F-long) and dkv's g . h (H-long).  The scores are f . wh plus the
    kernel's rounding of u and c, (a2 . (u - W3 wh) + (c - b3 . wh)), held
    constant under autograd; the cotangent weights are a (gh - r).  Also
    the scales of dwh's rounding: D = sum_i |ds_ij| |f_ij| (the magnitudes
    of its terms) and D2 = sum_i |ds_ij| E_i |f_ij|, E_i the largest
    magnitude sum of a score of row i (sum_k |a2_k u_k| + |c|)."""
    d = lambda t: t.detach().double()
    xi, xj = d(x4).requires_grad_(), d(x4).requires_grad_()
    ws = [d(t).requires_grad_() for t in w]
    whd = d(wh).requires_grad_()
    layers = [LinearView(ws[2 * k], ws[2 * k + 1]) for k in range(3)]
    mask = scene_mask(ids)
    s = torch.einsum("ijf,jf->ij",
                     pair_embed(layers, xi, xj, torch.float64), whd)
    with torch.no_grad():
        a2 = torch.relu(pair_embed(layers[:2], xi, xj, torch.float64))
        rounding = (torch.einsum("ijk,jk->ij", a2,
                                 d(u) - d(wh) @ d(w[4]).T)
                    + (d(c) - d(wh) @ d(w[5]))[None, :])
    s = torch.where(mask, s + rounding, -1e9)
    m = s.max(dim=-1).values
    p = torch.where(mask, torch.exp(s - m[:, None]), 0.0)
    l = p.sum(dim=-1)
    a = (p / torch.clamp(l[:, None], min=1e-20)).detach()
    ds = a * (d(gh) - d(r)[:, None])
    grads = torch.autograd.grad((ds * s).sum(), [xi, xj, *ws, whd])
    with torch.no_grad():
        f_abs = a2.abs() @ d(w[4]).abs() + d(w[5]).abs()
        e_row = torch.where(mask, torch.einsum("ijk,jk->ij", a2, d(u).abs())
                            + d(c).abs()[None, :], 0.0).amax(dim=-1)
        dsa = ds.abs()
        return dict(
            out=torch.where(mask.any(dim=-1, keepdim=True), a @ d(h), 0.0),
            stats=torch.stack([m, l], dim=-1).detach(), dx=grads[0],
            dh=a.T @ d(g), dwh=grads[-1], dw=grads[2:-1],
            D=torch.einsum("ij,ijf->jf", dsa, f_abs),
            D2=torch.einsum("ij,ijf->jf", dsa * e_row[:, None], f_abs))


def _ulps(a, b) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (their ordered integer images)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [24, 100, 256, 512, 640, 1024])
def test_torch_kernels_at_width_match_plain_cuda(hidden):
    """On the card: the forward with stats, dq and dkv at H = F =
    ``hidden`` (padded below 128 where needed, the wide entries above)
    against the plain function in f64 on the kernels' own long sums
    (``_on_kernel_sums``), each float32 launch counted.  The sums are
    held first: u and c within 2 ulp of u_prep's sequential order.  Then
    out, stats and dh_j at rtol 2e-4 / atol 2e-5; dq's dx within 1e-3 of
    its largest value (its per-row bound and f64 witness are
    chip_smoke's); dW1 .. db3 within 1e-4 of their largest.  dwh_j =
    S_j b3 + A_j W3 cancels in places, so past rtol / atol it may take
    the first-order rounding bound of its order: each term through at most
    81 float32 roundings (up to 16 pairs, then 65 products), gamma_81 D,
    and each pair's weight off by twice its score's rounding, 2 gamma_65
    D2.  The wide kernels' distance from the f32 plain version at H >= 256
    (outside its rtol / atol) is the order of these sums, not a fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x4, ids, h, wh, w, g = (
        [t.to(dev) for t in a] if isinstance(a, list) else a.to(dev)
        for a in _operands(256, hidden, hidden, torch.float32))
    before = (sa.social_attention_fwd.launches,
              sa.social_attention_bwd_dq.launches,
              sa.social_attention_bwd_dkv.launches)
    out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, True)
    r = (g * out).sum(-1)
    args = (x4, ids, h, wh, g, stats, r, w)
    dq = sa.social_attention_bwd_dq(*args, u, c)
    dkv = sa.social_attention_bwd_dkv(*args, u, c, need_dx=False)
    assert (sa.social_attention_fwd.launches,
            sa.social_attention_bwd_dq.launches,
            sa.social_attention_bwd_dkv.launches) == tuple(
                n + 1 for n in before)
    _, whp, wp, _ = sa.pad_widths(h, wh, w, g)
    u_seq, c_seq = _sequential_u_c(whp, wp[4], wp[5])
    ulps = (_ulps(u, u_seq), _ulps(c, c_seq))
    assert max(ulps) <= 2, f"u, c {ulps} ulp from the sequential order"
    ref = _on_kernel_sums(x4, ids, h, wh, g, r, w, u, c, _lane_gh(g, h))
    worst = {}
    for name, got in (("out", out), ("stats", stats), ("dh", dkv[1])):
        err = (got.double() - ref[name]).abs()
        worst[name] = float(err.max())
        assert bool((err <= K_ATOL + K_RTOL * ref[name].abs()).all()), (
            f"{name}: max abs {worst[name]:.3e}")
    err = (dq.double() - ref["dx"]).abs()
    worst["dx"] = float(err.max() / ref["dx"].abs().max())
    assert float(err.max()) <= 1e-3 * float(ref["dx"].abs().max()) + 2e-5
    for i, (a, b) in enumerate(zip(dkv[3:], ref["dw"])):   # dW1 .. db3
        assert a.shape == b.shape and float((a.double() - b).abs().max()) <= (
            1e-4 * float(b.abs().max()) + 1e-6), f"dW {i}"
    err = (dkv[2].double() - ref["dwh"]).abs()
    past = (err - K_ATOL - K_RTOL * ref["dwh"].abs()).clamp(min=0)
    bound = _gamma(81) * ref["D"] + 2 * _gamma(65) * ref["D2"]
    worst["dwh"] = float(err.max())
    used = float((past / bound.clamp(min=1e-300)).max())
    assert used <= 1.0, f"dwh past rtol / atol: {used:.3g} of its bound"
    # beside it, how far the kernels and the f32 plain version each sit
    # from the exact function (f64 throughout), for the record
    exact = _on_kernel_sums(x4, ids, h, wh, g, r, w, whp.double() @ wp[4].T
                            .double(), whp.double() @ wp[5].double(),
                            g.double() @ h.double().T)
    p_out, _ = sa.social_attention_fwd_kernel_plain(x4, ids, h, wh, w)
    p_dh = sa.social_attention_bwd_dkv_plain(*args, need_dx=False)[1]
    far = {k: (float((a.double() - exact[k]).abs().max()),
               float((b.double() - exact[k]).abs().max()))
           for k, a, b in (("out", out, p_out), ("dh", dkv[1], p_dh))}
    print(f"H = F = {hidden}: u, c {ulps} ulp from the sequential order; "
          f"vs f64 on the kernels' sums: out {worst['out']:.3e}, stats "
          f"{worst['stats']:.3e}, dh {worst['dh']:.3e}, dwh "
          f"{worst['dwh']:.3e} ({int((past > 0).sum())} past rtol / atol, "
          f"{used:.3g} of the rounding bound), dq dx {worst['dx']:.3e} of "
          f"its largest; vs f64, kernel / plain f32: out {far['out'][0]:.3e}"
          f" / {far['out'][1]:.3e}, dh {far['dh'][0]:.3e} / "
          f"{far['dh'][1]:.3e}")
