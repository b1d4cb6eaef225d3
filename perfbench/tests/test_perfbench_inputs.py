"""The inputs a run makes from its seed: the same seed gives the same
inputs, another seed other inputs with the same set of sizes."""

import numpy as np
import torch

from perfbench import data
from perfbench.reference import model


def test_ethucy_windows_follow_the_seed():
    a = data.ethucy_windows(500, 2 ** 31 + 17)
    b = data.ethucy_windows(500, 2 ** 31 + 17)
    c = data.ethucy_windows(500, 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["obsvs"][:50], c["obsvs"][:50])
    np.testing.assert_array_equal(a["batches"], c["batches"])
    sizes = np.diff(a["batches"], axis=1).ravel()
    assert sizes.min() >= 2 and sizes.max() <= 16
    assert a["obsvs"].shape[1:] == (8, 2) and a["preds"].shape[1:] == (12, 2)


def test_crowd_follows_the_seed_and_keeps_its_scenes():
    a = data.crowd(5000, 2, 64, 8, data.rng_of(9, data.DATA))
    b = data.crowd(5000, 2, 64, 8, data.rng_of(9, data.DATA))
    c = data.crowd(5000, 2, 64, 8, data.rng_of(10, data.DATA))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    ids = a[1]
    assert len(ids) == 5000 and ids[0] == 0
    assert np.all(np.diff(ids) >= 0) and np.all(np.diff(ids) <= 1)
    _, sizes = np.unique(ids, return_counts=True)
    assert sizes[:-1].min() >= 2 and sizes.max() <= 64


def test_weights_follow_the_seed_within_their_ranges():
    shape_of = model.shapes(64, 64, 32, 12, 2)
    bound = lambda k: model.fan_bound(k, shape_of)
    a = data.weights(shape_of, bound, 3 * 2 ** 32 + 1, "cpu")
    b = data.weights(shape_of, bound, 3 * 2 ** 32 + 1, "cpu")
    c = data.weights(shape_of, bound, 4, "cpu")
    for k, t in a.items():
        assert tuple(t.shape) == shape_of[k]
        assert torch.equal(t, b[k])
        assert float(t.abs().max()) <= bound(k)
    assert not torch.equal(a["decoder.0.w"], c["decoder.0.w"])


def test_streams_are_apart():
    assert data.seed_of(7, data.NOISE, 1) != data.seed_of(7, data.NOISE, 2)
    assert data.seed_of(7, data.NOISE, 1) == data.seed_of(7, data.NOISE, 1)
    assert 0 <= data.seed_of(2 ** 40, data.DATA) < 2 ** 63


def test_forecast_pool_sizes_do_not_depend_on_the_seed(tiny):
    from perfbench.drivers.forecast import Driver
    from perfbench.harness import load_cell
    cell = load_cell("crowd-forecast", overrides=tiny["crowd-forecast"])
    sizes = []
    for seed in (1, 2):
        d = Driver(cell.config, cell.mix, seed, "cpu")
        d.setup()
        sizes.append(sorted(q["obsv"].shape[0] for q in d.pool))
    assert sizes[0] == sizes[1]
