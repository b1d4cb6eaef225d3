"""The member axis of the social attention (the ensemble's,
socialways_torch/engine/ensemble.py) without JAX: ``torch.func.vmap`` of
the wrapper over stacked generators on the CPU, ``_SocialAttention``'s
``vmap`` rule, the member plain versions; and on the card, the member
launches against solo launches and a member-batched step against solo
steps (``cuda``-marked: run with ``-m cuda --noconftest``).

Tolerances: the member forms against their per-member loops rtol 1e-5 /
atol 1e-6 (the same float32 sums in a batched order); the vmap rule's
gradients, which come from the backward's plain dq/dkv forms, against
autograd through the dense form at rtol 1e-4 / atol 1e-5; on the card,
bits equal, and losses at rel 1e-4 (test_torch_train_step.py's rule)."""

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine import gan_step, stack_states
from socialways_torch.engine.ensemble import stack_draws
from socialways_torch.engine.train_step import draw_step, init_train_state
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator
from socialways_torch.models.stacked import Members, stack_modules
from socialways_torch.ops.nn import linear_apply


# ------------------------------------------ the attention's member axis
def _attention_members(m=3, n=24, hdim=16, seed=0):
    """Stacked feat_mlp/attn_w parameters of ``m`` generators, h [M, N, H],
    shared x4 and ids (three scenes, a padded tail)."""
    cfg = TrainConfig(hidden_size=hdim, social_feature_size=hdim,
                      noise_len=hdim // 2)
    gens = [init_generator(cfg, torch.Generator().manual_seed(seed + i),
                           "cpu") for i in range(m)]
    rng = np.random.RandomState(seed)
    x4 = torch.from_numpy(np.concatenate(
        [rng.rand(n, 2), rng.randn(n, 2) * 0.3], 1).astype(np.float32))
    ids = torch.from_numpy(np.array([0] * 9 + [1] * 6 + [2] * 5
                                    + [-1] * (n - 20), np.int32))
    h = torch.from_numpy(np.tanh(rng.randn(m, n, hdim)).astype(np.float32))
    return gens, stack_modules(gens), x4, ids, h


def _attention_loss(out, i):
    w = torch.linspace(-1.0, 1.0, out.shape[-1])
    return ((out * w) ** 2).sum() + out.sum() * (i + 1)


@pytest.mark.parametrize("x4_grad", [False, True], ids=["x4_data",
                                                         "x4_grad"])
def test_torch_attention_under_vmap_matches_member_loop(x4_grad):
    """``torch.func.vmap`` of ``social_attention_fwd`` over stacked
    generators (the CPU path: the dense plain form as ordinary ops), its
    forward and every gradient, against a loop over the members."""
    gens, stacked, x4, ids, h = _attention_members()
    x4 = x4.requires_grad_(x4_grad)
    h = h.requires_grad_()
    out = Members(len(gens))(
        lambda g, hh: sa.social_attention_fwd(g.feat_mlp, g.attn_w, x4, hh,
                                              ids), (stacked,), h)
    loss = sum(_attention_loss(out[i], i) for i in range(len(gens)))
    params = [p for n_, p in stacked.named_parameters()
              if n_.startswith(("feat_mlp", "attn_w"))]
    got = torch.autograd.grad(loss, params + [h] + ([x4] if x4_grad else []))
    loop = [sa.social_attention_fwd(g.feat_mlp, g.attn_w, x4, h[i], ids)
            for i, g in enumerate(gens)]
    want_loss = sum(_attention_loss(o, i) for i, o in enumerate(loop))
    own = [[p for n_, p in g.named_parameters()
            if n_.startswith(("feat_mlp", "attn_w"))] for g in gens]
    want = torch.autograd.grad(want_loss, sum(own, []) + [h]
                               + ([x4] if x4_grad else []))
    np.testing.assert_allclose(out.detach().numpy(),
                               torch.stack(loop).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    k = len(params)
    for j in range(k):
        w = torch.stack([want[i * k + j] for i in range(len(gens))])
        np.testing.assert_allclose(got[j].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"param {j}")
    for g_, w_ in zip(got[k:], want[len(gens) * k:]):
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _plain_launch(x4, ids, h, wh, weights, with_stats, max_scene=0):
    """A stand-in for ``_launch_fwd`` on the CPU: the member plain forward
    (u and c are read only by the kernels, which the CPU backward does
    not run)."""
    plain = (sa.social_attention_fwd_members_plain if h.dim() == 3
             else lambda *a: sa.social_attention_fwd_kernel_plain(*a))
    out, stats = plain(x4, ids, h, wh, weights)
    lead = tuple(h.shape[:-1])
    return (out, stats if with_stats else None,
            torch.zeros(lead + (64,)), torch.zeros(lead))


def test_torch_attention_function_vmap_rule_stacks_the_members(monkeypatch):
    """``_SocialAttention`` under ``torch.func.vmap`` goes through its
    ``vmap`` rule: one member-stacked application of the Function, whose
    regular autograd backward reaches the member backward wrappers (here
    on the CPU, their member plain versions); forward and every gradient
    against the per-member dense plain form."""
    calls = []

    def launch(*a, **kw):
        calls.append(a[2].shape)
        return _plain_launch(*a, **kw)
    monkeypatch.setattr(sa, "_launch_fwd", launch)
    gens, stacked, x4, ids, h = _attention_members(seed=5)
    h = h.requires_grad_()
    x4 = x4.requires_grad_()

    def one(g, hh):
        w = [t for layer in g.feat_mlp for t in (layer.w, layer.b)]
        wh = linear_apply(g.attn_w, hh)
        return sa._SocialAttention.apply(0, torch.float32, True, x4, ids, hh,
                                         wh, *w)[0]
    out = Members(len(gens))(one, (stacked,), h)
    assert calls == [h.shape]                 # one stacked launch
    params = [p for n_, p in stacked.named_parameters()
              if n_.startswith(("feat_mlp", "attn_w"))]
    loss = sum(_attention_loss(out[i], i) for i in range(len(gens)))
    got = torch.autograd.grad(loss, params + [h, x4])
    loop = [sa.social_attention_plain(g.feat_mlp, g.attn_w, x4, h[i], ids)
            for i, g in enumerate(gens)]
    own = [[p for n_, p in g.named_parameters()
            if n_.startswith(("feat_mlp", "attn_w"))] for g in gens]
    want = torch.autograd.grad(
        sum(_attention_loss(o, i) for i, o in enumerate(loop)),
        sum(own, []) + [h, x4])
    np.testing.assert_allclose(out.detach().numpy(),
                               torch.stack(loop).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    k = len(params)
    for j in range(k):
        w = torch.stack([want[i * k + j] for i in range(len(gens))])
        np.testing.assert_allclose(got[j].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"param {j}")
    for g_, w_, name in zip(got[k:], want[len(gens) * k:], ("h", "x4")):
        np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    with torch.no_grad():
        calls.clear()
        out0 = Members(len(gens))(one, (stacked,), h)
    assert calls == [h.shape]
    np.testing.assert_array_equal(out0.numpy(), out.detach().numpy())


def test_torch_member_plain_forms_match_the_solo_plain_versions():
    """The member plain versions (what the member kernels are held to on
    the card) are the solo plain versions member by member, with x4 and
    ids shared or stacked; the kernel-operand forward equals the module
    form."""
    gens, stacked, x4, ids, h = _attention_members(seed=9)
    with torch.no_grad():
        wh = torch.stack([linear_apply(g.attn_w, h[i])
                          for i, g in enumerate(gens)])
        w = [torch.stack([t.detach() for t in ts]) for ts in zip(
            *[[t for layer in g.feat_mlp for t in (layer.w, layer.b)]
              for g in gens])]
        out, stats = sa.social_attention_fwd_members_plain(x4, ids, h, wh, w)
        out_s, stats_s = sa.social_attention_fwd_members_plain(
            x4.expand(3, -1, -1), ids.expand(3, -1), h, wh, w)
        g = torch.randn(h.shape, generator=torch.Generator().manual_seed(1))
        r = (g * out).sum(-1)
        dq = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, w,
                                        None, None)
        dkv = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w,
                                          None, None)
        for i, gen in enumerate(gens):
            o, mm, ll = sa.social_attention_stats_plain(gen.feat_mlp,
                                                        gen.attn_w, x4, h[i],
                                                        ids)
            np.testing.assert_array_equal(out[i].numpy(), o.numpy())
            np.testing.assert_array_equal(stats[i].numpy(),
                                          torch.stack([mm, ll], -1).numpy())
            wi = [t[i] for t in w]
            np.testing.assert_array_equal(dq[i].numpy(), (
                sa.social_attention_bwd_dq_plain(
                    x4, ids, h[i], wh[i], g[i], stats[i], r[i], wi)).numpy())
            for a, b in zip(dkv, sa.social_attention_bwd_dkv_plain(
                    x4, ids, h[i], wh[i], g[i], stats[i], r[i], wi)):
                np.testing.assert_array_equal(a[i].numpy(), b.numpy())
    np.testing.assert_array_equal(out_s.numpy(), out.numpy())
    np.testing.assert_array_equal(stats_s.numpy(), stats.numpy())
    assert sa.dkv_partial_floats(256, 4) == 4 * sa.dkv_partial_floats(256)


# ---------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_member_launches_give_each_member_the_solo_bits(dtype):
    """One member launch of each kernel (forward with and without stats,
    dq, dkv) gives member m the bits of a solo launch on member m's
    operands; x4 and ids shared or stacked give the same bits."""
    dev, op = _card(), getattr(torch, dtype)
    m, n, hdim = 3, 256, 64
    gen = torch.Generator().manual_seed(4)
    x4 = torch.cat([torch.rand(n, 2, generator=gen),
                    torch.randn(n, 2, generator=gen) * 0.3], 1).to(dev)
    ids = torch.arange(n, dtype=torch.int32).div(8, rounding_mode="floor")
    ids = ids.to(torch.int32).to(dev)
    h = torch.tanh(torch.randn(m, n, hdim, generator=gen)).to(dev, op)
    wh = (torch.randn(m, n, hdim, generator=gen) * 0.5).to(dev, op)
    shapes = [(3, 32), (32,), (32, 64), (64,), (64, hdim), (hdim,)]
    w = [(torch.randn((m,) + s, generator=gen) * 0.3).to(dev, op)
         for s in shapes]
    g = torch.randn(m, n, hdim, generator=gen).to(dev)
    out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w, True)
    out0 = sa._launch_fwd(x4, ids, h, wh, w, False)[0]
    r = (g * out).sum(-1)
    dq = sa.social_attention_bwd_dq(x4, ids, h, wh, g, stats, r, w, u, c)
    dkv = sa.social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r, w, u, c)
    stacked = sa._launch_fwd(x4.expand(m, -1, -1).contiguous(),
                             ids.expand(m, -1).contiguous(), h, wh, w, True)
    assert torch.equal(stacked[0], out) and torch.equal(stacked[1], stats)
    for i in range(m):
        wi = [t[i] for t in w]
        o, st, ui, ci = sa._launch_fwd(x4, ids, h[i], wh[i], wi, True)
        assert torch.equal(o, out[i]) and torch.equal(st, stats[i])
        assert torch.equal(ui, u[i]) and torch.equal(ci, c[i])
        assert torch.equal(sa._launch_fwd(x4, ids, h[i], wh[i], wi,
                                          False)[0], out0[i])
        assert torch.equal(sa.social_attention_bwd_dq(
            x4, ids, h[i], wh[i], g[i], st, r[i], wi, ui, ci), dq[i])
        for a, b in zip(sa.social_attention_bwd_dkv(
                x4, ids, h[i], wh[i], g[i], st, r[i], wi, ui, ci), dkv):
            assert torch.equal(a, b[i])


def _chunk(n, dev):
    """Random-walk windows in scenes of 2-9 agents and a padded tail."""
    rng = np.random.RandomState(2)
    traj = (np.cumsum(rng.randn(n, 20, 2) * 0.05, axis=1)
            + rng.rand(n, 1, 2)).astype(np.float32)
    ids = np.full(n, -1, np.int32)
    row, sid = 0, 0
    while row < n - 6:
        s = min(int(rng.randint(2, 10)), n - 6 - row)
        ids[row:row + s] = sid
        row, sid = row + s, sid + 1
    valid = ids >= 0
    traj[~valid] = 0.0
    arrays = {"obsvs": traj[:, :8], "preds": traj[:, 8:], "scene_ids": ids,
              "valid": valid}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


@pytest.mark.cuda
def test_torch_ensemble_step_on_the_card_matches_solo_steps():
    """A member-batched loo step on the card against each member's solo
    step: the kernels launch once for all members."""
    dev = _card()
    cfg = TrainConfig(agent_frame=True, use_social=True, g_ema_decay=0.999,
                      d_input_noise=0.05, d_input_noise_steps=3,
                      d_input_noise_floor=0.02)
    n, seeds = 64, [0, 1, 2]
    solos = [init_train_state(cfg, torch.Generator().manual_seed(s), dev)
             for s in seeds]
    stacked = stack_states(solos)
    batch = _chunk(n, dev)
    draws = [draw_step(n, cfg, torch.Generator(device=dev).manual_seed(s),
                       dev) for s in seeds]
    before = (sa.social_attention_fwd.member_launches,
              sa.social_attention_bwd_dkv.member_launches)
    stacked, m = gan_step(stacked, batch, stack_draws(draws), cfg,
                          members=True)
    assert (sa.social_attention_fwd.member_launches,
            sa.social_attention_bwd_dkv.member_launches) == (
        before[0] + 1, before[1] + 1)
    for i in range(len(seeds)):
        solos[i], ms = gan_step(solos[i], batch, draws[i], cfg)
        for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
            np.testing.assert_allclose(float(getattr(m, name)[i]),
                                       float(getattr(ms, name)), rtol=1e-4,
                                       err_msg=name)
