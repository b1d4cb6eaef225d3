"""The port's toy-protocol host analysis against socialways_tpu: 1-NN and
EMD distribution statistics, the dump-tree walk and its cache, the real
sample sets, toy mode coverage, and the prediction dumps.  Inputs are
numpy draws from fixed seeds.

Tolerance: the port runs the same float64 numpy arithmetic (and the same
scipy assignment) as JAX's host code, so statistics are held to 1e-12 and
dumps bit for bit."""

import os

import numpy as np
import pytest

from socialways_tpu.data.scale import Scale as JaxScale
from socialways_tpu.eval import stats as jstats
from socialways_tpu.io.dumps import dump_predictions as jax_dump
from socialways_torch.data.scale import Scale
from socialways_torch.eval import stats as tstats
from socialways_torch.io.dumps import dump_predictions

TOL = 1e-12


def trajs(seed, k, n_ped, t=4):
    """K sets of n_ped random-walk trajectories of t steps, [K, nPed, t, 2]."""
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.randn(k, n_ped, t, 2), axis=2)


@pytest.mark.parametrize("k_real,k_fake,obsv_len", [
    (20, 20, 2), (20, 7, 2), (5, 12, 1), (8, 8, 3)])
def test_torch_1nn_and_emd_match_jax(k_real, k_fake, obsv_len):
    reals = trajs(k_real, k_real, 6)
    fakes = trajs(100 + k_fake, k_fake, 6) * 0.9 + 0.1
    np.testing.assert_allclose(
        tstats.compute_1nn(reals, fakes, obsv_len),
        jstats.compute_1nn(reals, fakes, obsv_len), rtol=0, atol=TOL)
    assert tstats.compute_wasserstein(reals, fakes, obsv_len) == \
        pytest.approx(jstats.compute_wasserstein(reals, fakes, obsv_len),
                      rel=0, abs=TOL)


def test_torch_1nn_of_near_identical_sets_matches_jax():
    reals = trajs(3, 10, 4)
    got = tstats.compute_1nn(reals, reals + 1e-9)
    np.testing.assert_allclose(got, jstats.compute_1nn(reals, reals + 1e-9),
                               rtol=0, atol=TOL)


def write_dump_tree(root, seed, epochs=(2, 4, 10), k=20, n_ped=8,
                    per_epoch=2):
    """A dump tree as ``cli train --dump-dir`` writes it: epoch
    sub-directories of npz files in the dumps' schema, plus a stray file
    that is not a dump."""
    rng = np.random.RandomState(seed)
    for e in epochs:
        d = os.path.join(root, str(e))
        os.makedirs(d)
        for i in range(per_epoch):
            obsvs = rng.randn(n_ped - i, 2, 2)
            np.savez(os.path.join(d, f"{e}-{i}.npz"), timestamp=i,
                     obsvs=obsvs,
                     preds_our=obsvs[None, :, -1:] + rng.randn(
                         k, n_ped - i, 2, 2),
                     preds_gtt=rng.randn(n_ped - i, 2, 2),
                     preds_lnr=rng.randn(n_ped - i, 2, 2))
    os.makedirs(os.path.join(root, "notes"))
    np.savez(os.path.join(root, "notes", "x.npz"), a=np.zeros(1))


def write_toy_npz(path, seed, n=96, t_obs=2, t_pred=2):
    rng = np.random.RandomState(seed)
    np.savez(path, obsvs=rng.randn(n, t_obs, 2), preds=rng.randn(n, t_pred, 2),
             times=np.arange(n), batches=np.stack(
                 [np.arange(0, n, 8), np.arange(8, n + 1, 8)], 1))


@pytest.mark.parametrize("group", [6, 8])
def test_torch_real_samples_match_jax(tmp_path, group):
    path = str(tmp_path / "toy.npz")
    write_toy_npz(path, group)
    got = tstats.load_real_samples(path, group)
    want = jstats.load_real_samples(path, group)
    assert got.shape == want.shape == (96 // group, group, 4, 2)
    np.testing.assert_array_equal(got, want)


def test_torch_stats_for_dump_matches_jax(tmp_path):
    write_dump_tree(str(tmp_path), 5)
    real = jstats.load_real_samples(str(_toy(tmp_path)), 8)
    f = str(tmp_path / "4" / "4-1.npz")
    for k in (20, 6):
        got = tstats.stats_for_dump(f, real[:k])
        want = jstats.stats_for_dump(f, real[:k])
        assert got[2] == want[2] == 7
        assert got[0] == pytest.approx(want[0], rel=0, abs=TOL)
        assert got[1] == pytest.approx(want[1], rel=0, abs=TOL)


def _toy(tmp_path):
    path = tmp_path / "real.npz"
    write_toy_npz(str(path), 9, n=200 * 8)
    return path


def test_torch_stats_for_dump_with_fewer_draws_than_real_sets(tmp_path):
    """A dump of K=4 draws against 20 real sets: the port scores the 4
    fake sets it has (JAX's concatenate raises on it)."""
    write_dump_tree(str(tmp_path), 6, epochs=(1,), k=4)
    real = jstats.load_real_samples(str(_toy(tmp_path)), 8)[:20]
    f = str(tmp_path / "1" / "1-0.npz")
    with pytest.raises(ValueError):
        jstats.stats_for_dump(f, real)
    one_nn, emd, n_ped = tstats.stats_for_dump(f, real)
    with np.load(f) as d:
        fake = np.concatenate([np.broadcast_to(d["obsvs"][None],
                                               (4,) + d["obsvs"].shape),
                               d["preds_our"]], axis=2)
    assert n_ped == 8
    assert one_nn == pytest.approx(
        jstats.compute_1nn(real[:, :8], fake, 2)[0], rel=0, abs=TOL)
    assert emd == pytest.approx(
        jstats.compute_wasserstein(real[:, :8], fake, 2), rel=0, abs=TOL)


@pytest.mark.parametrize("num_samples,min_peds", [(20, 6), (12, 8)])
def test_torch_calc_and_store_stats_matches_jax(tmp_path, num_samples,
                                                min_peds):
    real = jstats.load_real_samples(str(_toy(tmp_path)), 8)
    tree_t, tree_j = tmp_path / "t", tmp_path / "j"
    for d in (tree_t, tree_j):
        write_dump_tree(str(d), 7)
    got = tstats.calc_and_store_stats(str(tree_t), real, num_samples,
                                      min_peds)
    want = jstats.calc_and_store_stats(str(tree_j), real, num_samples,
                                       min_peds)
    assert sorted(got) == sorted(want) == [2, 4, 10]
    for e in want:
        np.testing.assert_allclose(got[e], want[e], rtol=0, atol=TOL)
    name = f"stats{num_samples}.npz"
    with np.load(tree_t / name) as a, np.load(tree_j / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=TOL)


def toy_like(seed, n=40, k=16):
    """Approach points on a circle and K finals turned by about -16, 0 or
    16 degrees (some off every mode), world coordinates."""
    rng = np.random.RandomState(seed)
    a0 = rng.uniform(-np.pi, np.pi, n)
    obsvs = np.stack([np.cos(a0), np.sin(a0)], -1)[:, None] * np.array(
        [[4.0], [3.0]])[None]
    turn = np.radians(rng.choice([-16.0, 0.0, 16.0, 30.0], (k, n))
                      + rng.randn(k, n) * 3.0)
    ang = a0[None] + turn
    preds = np.stack([np.cos(ang), np.sin(ang)], -1)[:, :, None] * np.array(
        [1.0, 2.0])[None, None, :, None]
    return obsvs, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_toy_mode_coverage_matches_jax(seed):
    obsvs, preds = toy_like(seed)
    for kw in ({}, {"tol_deg": 4.0}, {"mode_angles": (-16.0, 16.0)}):
        got = tstats.toy_mode_coverage(obsvs, preds, **kw)
        assert got == pytest.approx(
            jstats.toy_mode_coverage(obsvs, preds, **kw), rel=0, abs=TOL)
    modes = tstats.toy_turn_modes(obsvs, preds[..., -1, :])
    np.testing.assert_array_equal(
        modes, jstats.toy_turn_modes(obsvs, preds[..., -1, :]))
    assert set(np.unique(modes)) <= {-1, 0, 1, 2}
    # leading axes of the finals broadcast
    np.testing.assert_array_equal(
        tstats.toy_turn_modes(obsvs, preds[None, ..., -1, :]),
        jstats.toy_turn_modes(obsvs, preds[None, ..., -1, :]))


def test_torch_collapsed_samples_cover_one_mode_in_three():
    obsvs, preds = toy_like(3, k=1)
    preds = np.repeat(preds, 8, axis=0)
    assert tstats.toy_mode_coverage(obsvs, preds) <= 1 / 3 + TOL


@pytest.mark.parametrize("with_scale", [True, False])
def test_torch_dump_predictions_matches_jax(tmp_path, with_scale):
    rng = np.random.RandomState(11)
    world = rng.rand(30, 2) * 10
    scale, jscale = Scale(), JaxScale()
    scale.fit(world).calc_scale(keep_ratio=True)
    jscale.fit(world).calc_scale(keep_ratio=True)
    args = (rng.randn(9, 8, 2).astype(np.float32),
            rng.randn(5, 9, 12, 4).astype(np.float32),
            rng.randn(9, 12, 2).astype(np.float32),
            rng.randn(9, 12, 2).astype(np.float32))
    got = dump_predictions(str(tmp_path / "t"), 7, 340, *args,
                           scale if with_scale else None)
    want = jax_dump(str(tmp_path / "j"), 7, 340, *args,
                    jscale if with_scale else None)
    assert os.path.basename(got) == os.path.basename(want) == "7-340.npz"
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "obsvs", "preds_gtt", "preds_lnr", "preds_our", "timestamp"]
        assert a["preds_our"].shape == (5, 9, 12, 2)
        for key in b.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
