"""The bf16 social-attention kernels on Hopper's tensor cores
(csrc/social_attention_pairs.cuh, "bf16 operands on Hopper's tensor
cores"): the bf16 forward, dq and dkv run the pair MLP one warp and 16
pairs at a time on ``mma.sync`` bf16 -> f32, a warp owning a row (a
column); dq also takes da1 = dz2 W2^T on the tensor cores.

On the CPU (every run): the bf16 launch sizes, which these kernels read from
the wrapper: the forward's and dq's grids are functions of N and the member
count, capped; dkv's of N alone (its weight gradients are summed block by block, so
a member launch keeps a solo launch's grid and bits), and its partial
scratch follows its grid; the caps on those grids match the kernels'
launch bounds; and chip_smoke.py's readers of ptxas's and
cuobjdump's output, on text in their formats.

On the card (``cuda`` mark, skipped without one; no JAX: run with ``python
-m pytest tests/test_torch_bf16_tensor_cores.py -m cuda --noconftest``):
each bf16 kernel against its plain bf16 version at N = 256 (scenes of 2-16,
w = 0), N = 1,000 and 10,000 in scenes of 16 (a w = 16 launch equal to the
w = 0 launch bit for bit), a ragged N = 301, and H = F = 256, 144 and 400
(the wide entries; the forward pools columns past 128 in slices of 128,
which 144 and 400 leave partly filled); M = 4
members, each equal to its solo launch bit for bit; two dkv runs with
equal bits; and the forward and dq with their memory filled with NaN
first (dq also twice with equal bits).  Bounds, those of tests/test_torch_bf16.py's card
case (sums in another order flip a bf16 rounding of a1 or a2 now and then,
and the forward rounds p against the running max of its m-tile): out within
8e-3, m within 1e-3 (1 + |m|), l within 1e-2 l, dx (dq's and dkv's summed)
within 3e-2 of its row's largest value, every other gradient within 1e-2
of its largest.  On ETH/UCY-like scenes of 2-16, dx is held on the kernels'
own inputs against the f64 plain version instead (chip_smoke.py's
``dx_same_inputs``), as chip_smoke does where a row cancels: a scene of two
gives a dx that is rounding noise, and the FFMA kernels before these missed
the per-row bound there too (row 140 at N = 256).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (numpy only at import)
from socialways_torch.kernels import social_attention as sa  # noqa: E402
from socialways_torch.models.generator import init_generator  # noqa: E402
from socialways_torch.config import TrainConfig  # noqa: E402
from socialways_torch.ops.nn import cast_params, linear_apply  # noqa: E402

BF = torch.bfloat16


# ------------------------------------------------------------ launch sizes
@pytest.mark.parametrize("n", [1, 3, 4, 5, 256, 301, 1000, 2112, 2113,
                               10_000, 32_768, 1_048_576])
@pytest.mark.parametrize("members", [1, 2, 4, 8])
def test_torch_bf16_fwd_grid_is_a_function_of_n_and_members(n, members):
    """The bf16 forward: one block a 4 rows, at most 528 blocks over all
    members (4 an SM of the H100, one wave: the weights are staged once a
    block and every warp walks rows with the grid's stride); the float32
    forward keeps one block a tile of 2 rows, whatever the members."""
    blocks = sa.fwd_blocks(n, members, BF)
    assert blocks == min(-(-n // 4), max(1, 528 // members))
    assert 1 <= blocks * members <= max(528, members)
    assert sa.fwd_blocks(n, members, torch.float32) == sa.fwd_blocks(n)
    assert sa.fwd_blocks(n) == -(-n // 2)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 256, 301, 1000, 2112, 2113,
                               10_000, 32_768, 1_048_576])
@pytest.mark.parametrize("members", [1, 2, 4, 8])
def test_torch_bf16_dq_grid_is_a_function_of_n_and_members(n, members):
    """The bf16 dq: one block a 4 rows, at most 528 blocks over all members
    (4 an SM of the H100, one wave; a warp owns a row and walks rows with
    the grid's stride, so a row's bits do not depend on the grid); the
    float32 dq keeps one block a tile of 2 rows, whatever the members."""
    blocks = sa.dq_blocks(n, members, BF)
    assert blocks == min(-(-n // 4), max(1, 528 // members))
    assert 1 <= blocks * members <= max(528, members)
    assert sa.dq_blocks(n, members, torch.float32) == sa.dq_blocks(n)
    assert sa.dq_blocks(n) == -(-n // 2)


@pytest.mark.parametrize("n", [1, 7, 256, 301, 2112, 2113, 10_000,
                               1_048_576])
@pytest.mark.parametrize("members", [1, 4])
def test_torch_bf16_dkv_partial_floats_follow_its_grid(n, members):
    """bf16 dkv: one block a 4 columns up to 396 (3 an SM of the H100, one
    wave), the same for any member count; one partial slot of 2240 floats a
    warp (4 a block) and member.  float32 keeps its grid (a tile of 2
    columns a block, up to 528) and a slot a block."""
    blocks = sa.dkv_blocks(n, BF)
    assert blocks == min(-(-n // 4), 396)
    assert sa.dkv_partial_floats(n, members, BF) == (
        members * blocks * 4 * 2240)
    assert sa.dkv_blocks(n, torch.float32) == sa.dkv_blocks(n) == min(
        -(-n // 2), 528)
    assert sa.dkv_partial_floats(n, members) == (
        members * sa.dkv_blocks(n) * 2240)
    assert sa.dq_blocks(n) == sa.fwd_blocks(n)


@pytest.mark.parametrize("source,name,cap", [
    ("social_attention_fwd.cuh", "kMmaFwdMinBlocks", "_MMA_FWD_MAX_BLOCKS"),
    ("social_attention_bwd.cuh", "kMmaDqMinBlocks", "_MMA_DQ_MAX_BLOCKS"),
    ("social_attention_bwd.cuh", "kMmaDkvMinBlocks", "_MMA_DKV_MAX_BLOCKS")])
def test_torch_bf16_grid_caps_match_the_launch_bounds(source, name, cap):
    """The bf16 forward's, dq's and dkv's grid caps are one wave of the blocks
    their ``__launch_bounds__`` keep resident on each of the H100's 132
    SMs: the Python cap and the CUDA constant state one number."""
    path = os.path.join(os.path.dirname(sa.__file__), "csrc", source)
    with open(path) as f:
        text = f.read()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, f"{source}: {name} defined {len(found)} times"
    assert getattr(sa, cap) == int(found[0]) * 132
    assert len(re.findall(rf"__launch_bounds__\(kThreads, {name}\)",
                          text)) == 2


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_127social_attention_fwd_kernelI13__nv_bfloat16Lb0EEEvPK6float4PKiPKT_PKfSD_SB_SB_SB_SB_PfP6float2iiiN2sa7MembersE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_127social_attention_fwd_kernelI13__nv_bfloat16Lb0EEEvPK6float4PKiPKT_PKfSD_SB_SB_SB_SB_PfP6float2iiiN2sa7MembersE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, 6912 bytes smem, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113u_prep_kernelIfLb0EEEvPKT_S3_S3_PfS4_iiN2sa7MembersE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113u_prep_kernelIfLb0EEEvPKT_S3_S3_PfS4_iiN2sa7MembersE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 74 registers, 37376 bytes smem, 400 bytes cmem[0]
"""

_SASS = """\
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114bwd_dkv_kernelI13__nv_bfloat16Lb1EEEvPK6float4PKiPKT_PKfPK6float2SB_SB_SB_SA_SA_SA_SA_SA_SA_PS1_PfSG_SG_SG_SG_iiiiN2sa7MembersE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0c50*/                   HMMA.16816.F32.BF16 R24, R16, R20, R24 ;       /* 0x000000141018723c */
        /*0c60*/                   HMMA.16816.F32.BF16 R28, R16, R22, R28 ;       /* 0x000000161018723c */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_113u_prep_kernelI13__nv_bfloat16Lb1EEEvPKT_S4_S4_PfS5_iiN2sa7MembersE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                         /* 0x00000a00ff017b82 */
\t\t..........
"""


def test_torch_chip_smoke_reads_ptxas_and_sass():
    """chip_smoke.py's phase-2 readers: ptxas's registers and spills per
    kernel and operand type, and the HMMA count of each kernel in a
    library's ``cuobjdump -sass``."""
    assert cs.ptxas_entries(_PTXAS) == {
        "social_attention_fwd_kernel[bf16]": (90, 0, 0),
        "u_prep_kernel[float]": (74, 8, 12)}
    assert cs.sass_hmma(_SASS, wide=True) == {
        "bwd_dkv_kernel[bf16,wide]": 2, "u_prep_kernel[bf16,wide]": 0}


# ------------------------------------------------------------------ the card
def _card_case(n, seed, scene, hidden=64):
    """The loo model's feature MLP at width ``hidden`` on the card: a bf16
    view of a generator whose float32 weights hold bf16 values, float32 x4,
    bf16 h, ids from chip_smoke (``scene`` rows a scene with a padded tail,
    or ETH/UCY-like scenes of 2-16 when 0), wh = h W + b rounded to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(seed)
    if scene:
        x4, h, ids = cs.crowd_inputs(rng, n, hidden, scene)
    else:
        x4, h, ids = cs.attention_inputs(rng, n, hidden)
    dev = torch.device("cuda")
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=32)
    gen = init_generator(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for prm in gen.parameters():
            prm.copy_(prm.to(BF).float())
    g16 = cast_params(gen.to(dev), BF)
    h16 = torch.from_numpy(h).to(dev, BF)
    w16 = [t.detach() for m in g16.feat_mlp for t in (m.w, m.b)]
    with torch.no_grad():
        wh = linear_apply(g16.attn_w, h16.float()).to(BF)
    gout = torch.from_numpy(rng.randn(n, hidden).astype(np.float32)).to(dev)
    return (g16, torch.from_numpy(x4).to(dev), h16,
            torch.from_numpy(ids).to(dev), wh, w16, gout)


def _launch_all(x4, ids, h, wh, w16, gout, w):
    """The bf16 forward with stats, dq and dkv (with dx_j) at window w."""
    with torch.no_grad():
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w16, True, w)
        r = (gout * out).sum(-1)
        args = (x4, ids, h, wh, gout, stats, r, w16, u, c)
        dx = sa.social_attention_bwd_dq(*args, max_scene=w)
        dkv = sa.social_attention_bwd_dkv(*args, max_scene=w)
    torch.cuda.synchronize()
    return [out, stats, u, c, r, dx, *dkv]


def _plain(g16, x4, ids, h, wh, w16, gout, stats, r, w):
    """(out, m, l, dx_i, dkv list) of the plain bf16 versions, dense up to
    4,096 rows, else window by window (chip_smoke.windowed_plain)."""
    n = h.shape[0]
    if n > 4096:
        out, st, dq, dkv = cs.windowed_plain(torch, sa, g16, x4, ids, h, wh,
                                             gout, w)
        return out, st[:, 0], st[:, 1], dq, dkv
    with torch.no_grad():
        out, m, l = sa.social_attention_stats_plain(g16.feat_mlp, g16.attn_w,
                                                     x4, h, ids)
    dq = sa.social_attention_bwd_dq_plain(x4, ids, h, wh, gout, stats, r, w16)
    dkv = sa.social_attention_bwd_dkv_plain(x4, ids, h, wh, gout, stats, r,
                                            w16)
    return out, m, l, dq, list(dkv)


def _close_scaled(got, want, rel, what):
    err = float((got.float() - want.float()).abs().max())
    bound = rel * float(want.float().abs().max()) + 1e-6
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,scene,w,hidden", [
    (256, 0, 0, 64), (1000, 16, 16, 64), (10_000, 16, 16, 64),
    (301, 0, 0, 64), (256, 0, 0, 256), (256, 0, 0, 144), (256, 0, 0, 400)])
def test_torch_bf16_tensor_core_kernels_match_plain_cuda(n, scene, w,
                                                         hidden):
    """Each redesigned bf16 kernel against its plain bf16 version, the
    w > 0 launch against the w = 0 launch's bits, and no float32 launch."""
    g16, x4, h, ids, wh, w16, gout = _card_case(n, 11, scene, hidden)
    f32 = cs.read_launches(sa)
    res = {ww: _launch_all(x4, ids, h, wh, w16, gout, ww)
           for ww in sorted({0, w})}
    assert cs.read_launches(sa) == f32, "a bf16 call launched float32 kernels"
    for k, (a, b) in enumerate(zip(res[0], res[w])):
        assert torch.equal(a, b), f"output {k}: w = {w} bits != w = 0 bits"
    out, stats, _, _, r, dx, dxj, dh, dwh, *dws = res[w]
    p_out, p_m, p_l, p_dx, p_dkv = _plain(g16, x4, ids, h, wh, w16, gout,
                                          stats, r, w)
    assert out.dtype == torch.float32 and bool(out.isfinite().all())
    assert float((out - p_out).abs().max()) <= 8e-3
    assert bool(((stats[:, 0] - p_m).abs() <= 1e-3 * (1 + p_m.abs())).all())
    assert bool(((stats[:, 1] - p_l).abs() <= 1e-2 * p_l).all())
    if scene:
        rows = (p_dx + p_dkv[0]).abs().max(dim=1).values
        assert bool(((dx + dxj - p_dx - p_dkv[0]).abs().max(dim=1).values
                     <= 3e-2 * rows + 1e-6).all())
    else:
        # scenes of 2: dx_i = d s_ij / dx_i (g . h_j - r_i), where r_i =
        # g . h_j up to rounding, so dx is rounding noise (the parent's FFMA
        # kernels and the plain version disagree there as much): dx on
        # the kernels' own inputs against the f64 plain version, within 2x
        # the f32 plain version's distance (chip_smoke.dx_same_inputs)
        cs.dx_same_inputs(torch, sa, f"bf16 N={n}",
                          (x4, ids, h, wh, gout, stats, r, w16),
                          {"dq dx_i": (dx, p_dx), "dkv dx_j": (dxj, p_dkv[0])})
    for name, a, b in zip(["dh", "dwh", "dw1", "db1", "dw2", "db2", "dw3",
                           "db3"], [dh, dwh, *dws], p_dkv[1:]):
        _close_scaled(a, b, 1e-2, name)


@pytest.mark.cuda
def test_torch_bf16_dkv_twice_gives_equal_bits_cuda():
    """dkv's weight gradients are per-block partials added in a fixed
    order, with no atomics: two runs give equal bits (N = 1,000, w = 16,
    so that many blocks hold several columns)."""
    g16, x4, h, ids, wh, w16, gout = _card_case(1000, 12, 16)
    first = _launch_all(x4, ids, h, wh, w16, gout, 16)
    second = _launch_all(x4, ids, h, wh, w16, gout, 16)
    for k, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), f"output {k} differs between two runs"


@pytest.mark.cuda
@pytest.mark.parametrize("n,scene,w", [(256, 0, 0), (1000, 16, 16)])
def test_torch_bf16_member_launch_equals_solo_launches_cuda(n, scene, w):
    """M = 4 members (different weights and h, shared x4 and ids) in one
    launch of each bf16 kernel: member m's every output equals the launch
    on member m's operands alone, bit for bit."""
    cases = [_card_case(n, 20 + k, scene) for k in range(4)]
    x4, ids = cases[0][1], cases[0][3]
    solo = [_launch_all(x4, ids, c[2], c[4], c[5], c[6], w) for c in cases]
    stack = lambda k: torch.stack([c[k] for c in cases]).contiguous()
    w16 = [torch.stack([c[5][i] for c in cases]).contiguous()
           for i in range(6)]
    h, wh, gout = stack(2), stack(4), stack(6)
    before = sa.social_attention_fwd.member_launches_bf16
    members = _launch_all(x4, ids, h, wh, w16, gout, w)
    assert sa.social_attention_fwd.member_launches_bf16 == before + 1
    for k, got in enumerate(members):
        for m in range(4):
            assert torch.equal(got[m], solo[m][k]), (
                f"output {k} of member {m} != its solo launch")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10_000, 32_768])
def test_torch_bf16_forward_reads_no_stale_memory_cuda(n):
    """The forward's main kernel starts before its u prologue ends
    (programmatic dependent launch) and may read u and c only after its
    wait: with the memory the launch's u, c and out come from filled with
    NaN first, the w = 0 and w = 16 launches give equal, finite bits."""
    g16, x4, h, ids, wh, w16, _ = _card_case(n, 29, 16)
    res = []
    for w in (0, 16, 0):
        junk = torch.full((1 << 26,), float("nan"), device="cuda")
        del junk
        with torch.no_grad():
            res.append(sa._launch_fwd(x4, ids, h, wh, w16, True, w))
        torch.cuda.synchronize()
    for outs in res[1:]:
        for k, (a, b) in enumerate(zip(res[0], outs)):
            assert bool(a.isfinite().all()), f"output {k} not finite"
            assert torch.equal(a, b), f"output {k} differs between launches"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10_000, 32_768])
def test_torch_bf16_dq_writes_every_row_cuda(n):
    """dq writes every row of dx once (a warp a row, rows without partners
    0): launched into memory filled with NaN first (a freed block of dx's
    own size, which the caching allocator hands out again), the w = 0, w =
    16 and a second w = 0 launch give equal, finite bits."""
    g16, x4, h, ids, wh, w16, gout = _card_case(n, 31, 16)
    with torch.no_grad():
        out, stats, u, c = sa._launch_fwd(x4, ids, h, wh, w16, True, 16)
        args = (x4, ids, h, wh, gout, stats, (gout * out).sum(-1), w16, u, c)
    res = []
    for w in (0, 16, 0):
        junk = torch.full((n, 4), float("nan"), device="cuda")
        del junk
        res.append(sa.social_attention_bwd_dq(*args, max_scene=w))
        torch.cuda.synchronize()
    assert bool(res[0].isfinite().all()), "dx not finite"
    for k, dx in enumerate(res[1:]):
        assert torch.equal(res[0], dx), f"launch {k + 1} differs from the first"
