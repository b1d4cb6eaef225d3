"""Hidden sizes the kernels do not take natively (H and F multiples of 16
up to 128): the wrappers zero-pad H and F to multiples of 16
(``pad_widths``) and launch the wide kernels above 128.  Here, on the CPU:
the padded plain path equals the unpadded one at H = F = 24 and 100 (the
forward and every gradient, float32 and bf16: a zero column adds an exact
zero to every sum, so only the order of a sum may move a bit: every
output within 4 float32 ulp of its largest element); the port's
``social_attention`` and a loo ``gan_step`` at H = 24 and 256 against
JAX's at f32 rtol 1e-4 / atol 1e-5, JAX's draws fed in as
tests/test_torch_train_step.py feeds them; the entries each width
launches.  On the card (``cuda``, skipped here): each width's kernels
against their plain versions.  JAX is imported inside the tests that
compare with it, so the CUDA tests also run where there is no JAX."""

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine.train_step import gan_step
from socialways_torch.io.checkpoint import (flatten_state,
                                            train_state_from_jax)
from socialways_torch.kernels import social_attention as sa
from test_torch_social_attention import _jax_reference, _port, _setup

RTOL, ATOL = 1e-4, 1e-5


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
@pytest.mark.parametrize("hidden", [24, 100])
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
    assert [sa.padded_width(w) for w in (1, 16, 24, 100, 500, 512)] == [
        16, 16, 32, 112, 512, 512]
    x4, ids, h, wh, w, g = _operands(8, sa.MAX_WIDTH + 1, 0, torch.float32)
    with pytest.raises(ValueError, match=f"up to {sa.MAX_WIDTH}"):
        sa.pad_widths(h, wh, w, g)


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


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [24, 100, 256, 512])
def test_torch_kernels_at_width_match_plain_cuda(hidden):
    """On the card: the forward with stats, dq and dkv at H = F =
    ``hidden`` (padded below 128 where needed, the wide entries above)
    against their plain versions at chip_smoke's phase-4 bounds (dq's dx
    within 1e-3 of its largest value: its per-row bound and f64 witness
    are chip_smoke's); each float32 launch counted."""
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
    p_out, p_stats = sa.social_attention_fwd_kernel_plain(x4, ids, h, wh, w)
    torch.testing.assert_close(out, p_out, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(stats, p_stats, rtol=2e-4, atol=2e-5)
    r = (g * out).sum(-1)
    args = (x4, ids, h, wh, g, stats, r, w)
    dq = sa.social_attention_bwd_dq(*args, u, c)
    p_dq = sa.social_attention_bwd_dq_plain(*args)
    assert float((dq - p_dq).abs().max()) <= 1e-3 * float(
        p_dq.abs().max()) + 2e-5
    got = sa.social_attention_bwd_dkv(*args, u, c, need_dx=False)[1:]
    want = sa.social_attention_bwd_dkv_plain(*args, need_dx=False)[1:]
    for i, (a, b) in enumerate(zip(got, want)):   # dh_j, dwh_j, dW1 .. db3
        if i < 2:
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        else:
            assert a.shape == b.shape and float((a - b).abs().max()) <= (
                1e-4 * float(b.abs().max()) + 1e-6)
    assert (sa.social_attention_fwd.launches,
            sa.social_attention_bwd_dq.launches,
            sa.social_attention_bwd_dkv.launches) == tuple(
                n + 1 for n in before)
