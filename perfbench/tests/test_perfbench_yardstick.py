"""The frozen yardstick: FLOP counts against hand counts, the attention
bounds against the program's originals, the trace arithmetic."""

import numpy as np
import pytest

from perfbench import bounds, flops, trace

CFG = {"hidden_size": 64, "social_feature_size": 64, "noise_len": 32,
       "n_past": 8, "n_next": 12, "n_latent_codes": 2,
       "n_unrolling_steps": 1}


def test_pairs():
    ids = np.array([0, 0, 0, 1, 1, 2, -1, -1], np.int32)
    assert flops.pairs(ids) == 3 * 2 + 2 * 1 + 0


def test_rollout_by_hand():
    # encode: 8 x (embed 4x64 + LSTM 128x256); decode: 160x160 + 160x80 +
    # 80x40 + 40x2 + the same feedback; attention: wh 64x64 + u 64x64 a
    # row, 96 + 2048 + 64 + 64 a pair
    feedback = 4 * 64 + 128 * 256
    row = 8 * feedback + 64 * 64 + 64 * 64 + 12 * (
        160 * 160 + 160 * 80 + 80 * 40 + 40 * 2 + feedback)
    assert flops.rollout_macs(CFG, 3, 5) == 3 * row + 5 * (96 + 2048 + 128)
    assert flops.simulate_flops(CFG, 3, 5, 4) == 2.0 * 4 * (
        3 * row + 5 * 2272)


def test_forecast_decodes_k_times():
    one = flops.forecast_flops(CFG, 10, 0, 1)
    twenty = flops.forecast_flops(CFG, 10, 0, 20)
    feedback = 4 * 64 + 128 * 256
    step = 160 * 160 + 160 * 80 + 80 * 40 + 40 * 2 + feedback
    assert twenty - one == 2.0 * 10 * 19 * 12 * step


def test_train_step_by_hand():
    rows = 7
    d_obsv = 8 * 68 * 256 + 64 * 32 + 32 * 32
    d_heads = 48 * 32 + 32 * 32 + 64 * 32 + 32 + 64 * 32 + 32 * 2
    r = flops.rollout_macs(CFG, rows, 0)
    want = 2.0 * (3 * r + 2 * 3 * rows * (d_obsv + 2 * d_heads)
                  + rows * (d_obsv + 2 * d_heads))
    assert flops.train_step_flops(CFG, rows, 0) == want


def _ids(kind, rng, n):
    if kind == "scenes16":
        return (np.arange(n) // 16).astype(np.int32)
    ids = np.full(n, -1, np.int32)
    row, sid = 0, 0
    while row < int(n * 0.9):
        s = int(rng.integers(2, 17))
        ids[row:row + s] = sid
        row, sid = row + s, sid + 1
    ids[int(n * 0.9):] = -1
    return ids


@pytest.mark.parametrize("kind,n,hdim,feat,op_bytes,members", [
    ("eth", 256, 64, 64, 4, 1),
    ("scenes16", 10000, 64, 64, 2, 1),
    ("eth", 301, 128, 96, 4, 4),
])
def test_bounds_equal_the_programs(kind, n, hdim, feat, op_bytes, members):
    import chip_smoke
    ids = _ids(kind, np.random.default_rng(n), n)
    n_mlp = bounds.feat_mlp_elems(feat)
    for with_wh in (False, True):
        assert bounds.attention_bound(
            ids, n, hdim, feat, n_mlp, with_wh, op_bytes, members) == \
            chip_smoke.attention_bound(ids, n, hdim, feat, n_mlp, with_wh,
                                       op_bytes, members)
    for kernel in ("dq", "dkv"):
        assert bounds.attention_bwd_bound(
            ids, n, hdim, feat, n_mlp, kernel, op_bytes, members) == \
            chip_smoke.attention_bwd_bound(ids, n, hdim, feat, n_mlp, kernel,
                                           op_bytes, members)


def test_bound_by_hand():
    ids = np.zeros(2, np.int32)                  # one scene of two: 2 pairs
    b = bounds.attention_bound(ids, 2, 64, 64, bounds.feat_mlp_elems(64))
    assert b["pairs_needed"] == 2
    assert b["flop"] == 2 * (2 * (96 + 2048 + 64) + 2 * 64 * 64)


def test_union_and_names():
    busy, merged = trace.union_seconds(np.array(
        [[0.0, 10.0], [5.0, 20.0], [30.0, 40.0], [35.0, 36.0]]))
    assert busy == pytest.approx(30e-6)
    assert merged.tolist() == [[0.0, 20.0], [30.0, 40.0]]
    assert trace.short_name(
        "void (anonymous namespace)::bwd_dkv_kernel<__nv_bfloat16, true>"
        "(float const*, int)") == "bwd_dkv_kernel"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
