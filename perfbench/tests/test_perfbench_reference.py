"""The plain reference against the program's plain CPU paths at a tiny
size: the forecast, the simulation and three training steps."""

import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.drivers import load_params
from perfbench.reference import model
from perfbench.reference.precision import Precision


def _generator(dtype, seed=3):
    from socialways_torch.config import TrainConfig
    from socialways_torch.models.generator import init_generator
    cfg = TrainConfig(agent_frame=True, use_social=True, compute_dtype=dtype,
                      max_scene_size=16)
    shape_of = model.shapes(64, 64, 32, 12, 2)
    g_shapes = {k: shape_of[k] for k in model.generator_names()}
    params = data.weights(g_shapes, lambda k: model.fan_bound(k, shape_of),
                          seed, "cpu")
    gen = init_generator(cfg, torch.Generator().manual_seed(0), "cpu")
    load_params(gen, params)
    return cfg, gen, params


def _crowd(n, seed=5):
    obsv, ids = data.crowd(n, 2, 16, 8, data.rng_of(seed, data.DATA))
    return torch.from_numpy(obsv), torch.from_numpy(ids)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.0)])
def test_forecast_matches_the_program(dtype, tol):
    from socialways_torch.eval.metrics import k_sample_rollout
    cfg, gen, params = _generator(dtype)
    obsv, ids = _crowd(90)
    noise = torch.rand(3, 90, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = k_sample_rollout(gen, obsv, ids, 3, cfg, noise=noise)
    want = model.k_sample_forecast(params, obsv, ids, noise, 12,
                                   Precision(dtype), window=16)
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.0)])
def test_simulation_matches_the_program(dtype, tol):
    from socialways_torch.engine.simulate import crowd_simulate
    cfg, gen, params = _generator(dtype)
    obsv, ids = _crowd(70)
    noise = torch.rand(2, 70, 32, generator=torch.Generator().manual_seed(2))
    got = crowd_simulate(gen, obsv, ids, 2, cfg, noise=noise)
    want = model.simulate(params, obsv, ids, noise, 12, Precision(dtype),
                          window=16)
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max())


def test_windowed_attention_equals_dense():
    _, _, params = _generator("float32")
    x4 = torch.rand(300, 4)
    h = torch.rand(300, 64) - 0.5
    ids = torch.from_numpy(data.scene_ids(300, 2, 16, data.rng_of(1)))
    P = Precision("float32")
    dense = model.social_context(params, x4, h, ids, P)
    windowed = model.social_context(params, x4, h, ids, P, window=16,
                                    block=64)
    torch.testing.assert_close(windowed, dense, rtol=1e-5, atol=1e-6)


def test_training_steps_match_the_program(tiny):
    """The train driver's check on the CPU: the program's eager epoch loop
    against the reference, three steps."""
    from perfbench.harness import load_cell
    from perfbench.drivers.train import Driver
    cell = load_cell("loo-train", overrides=tiny["loo-train"])
    d = Driver(cell.config, cell.mix, 2 ** 33 + 5, "cpu")
    d.setup()
    d.release()
    checks = {c.name: c.value for c in d.check(cell.limits)}
    assert checks["loss_gap"] < 1e-6
    assert checks["grad_gap"] < 1e-6
    assert checks["change_gap"] < 1e-6


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10)])
    from perfbench.reference.precision import round_tf32
    np.testing.assert_array_equal(
        round_tf32(x).numpy(), np.array([1.0, 1.0 + 2 ** -9,
                                         -(1.0 + 2 ** -10)], np.float32))
