"""The port's constant-acceleration Kalman baseline against
socialways_tpu/ops/kalman.py: filter, RTS smoother and forecast at f32
rtol 1e-4 / atol 1e-5 (JAX's own f32 result sits within 5.1e-6 of its f64
one on tracks of |x| <= 4), the single-measurement guard, and
``evaluate --linear kalman``'s printed line."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialways_tpu.cli.main import main as jax_cli
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.ops import kalman as jkalman
from socialways_torch.cli.main import main as torch_cli
from socialways_torch.data.windowing import create_dataset
from socialways_torch.ops import kalman
from test_torch_data_pipeline import obsmat_rows

RTOL, ATOL = 1e-4, 1e-5


def tracks(seed, shape, t):
    """Smooth random tracks [*shape, t, 2] within |x| <= 4."""
    rng = np.random.RandomState(seed)
    vel = rng.randn(*shape, 1, 2) * 0.2 + np.cumsum(
        rng.randn(*shape, t, 2) * 0.05, axis=-2)
    x = rng.uniform(-2, 2, (*shape, 1, 2)) + np.cumsum(vel, axis=-2)
    return np.clip(x, -4, 4).astype(np.float32)


CASES = [((), 8, 1.0), ((3, 4), 8, 0.4), ((4,), 20, 0.4)]


@pytest.mark.parametrize("shape,t,dt", CASES)
def test_torch_kalman_filter_and_smoother_match_jax(shape, t, dt):
    z = tracks(sum(shape) + t, shape, t)
    for name in ("kalman_filter", "kalman_smooth"):
        want = jax.jit(getattr(jkalman, name), static_argnums=1)(
            jnp.asarray(z), dt)
        got = getattr(kalman, name)(torch.from_numpy(z), dt)
        for w, g, part in zip(want, got, ("positions", "velocities")):
            assert g.shape == tuple(w.shape) and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} {part}")


@pytest.mark.parametrize("shape,t,dt", CASES + [((5,), 8, 1.0),
                                                 ((6,), 3, 1.0)])
def test_torch_predict_kalman_matches_jax(shape, t, dt):
    z = tracks(7 + t, shape, t)
    want = jax.jit(jkalman.predict_kalman, static_argnums=(1, 2))(
        jnp.asarray(z), 12, dt)
    got = kalman.predict_kalman(torch.from_numpy(z), 12, dt)
    assert got.shape == tuple(want.shape) == shape + (12, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_torch_kalman_single_measurement_guard():
    z = tracks(3, (4,), 1)
    pos, vel = kalman.kalman_smooth(torch.from_numpy(z))
    want_pos, want_vel = jkalman.kalman_smooth(jnp.asarray(z))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(vel.numpy(), np.asarray(want_vel))
    assert torch.equal(pos, torch.from_numpy(z)) and not vel.any()


def test_torch_kalman_matrices_equal_jax():
    for dt in (1.0, 0.4):
        for a, b in zip(jkalman.kalman_matrices(dt), kalman.kalman_matrices(dt)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_torch_cli_linear_kalman_prints_what_jax_prints(tmp_path, capsys,
                                                       monkeypatch):
    rng_rows = obsmat_rows(21, n_agents=24)
    p_data, t_data = {}, {}
    for ts, aid, px, _, py, *_ in rng_rows:
        p_data.setdefault(aid, []).append((px, py))
        t_data.setdefault(aid, []).append(ts)
    obsvs, preds, times, batches = create_dataset(
        [np.asarray(p_data[a]) for a in p_data],
        [np.asarray(t_data[a], np.int32) for a in t_data],
        range(0, 600, 10))
    npz = str(tmp_path / "scene-8-12.npz")
    np.savez(npz, obsvs=obsvs, preds=preds, times=np.asarray(times),
             batches=batches)
    assert len(batches) >= 5
    args = ["--cpu", "evaluate", "--data", npz, "--linear", "kalman",
            "--batch-size", "64"]
    # the linear branch never reads the model state JAX's evaluate draws
    # first (~140 small XLA compiles here): skip the draw
    monkeypatch.setattr(JaxTrainer, "init_state", lambda self: None)
    assert jax_cli(args) == 0
    want = capsys.readouterr().out
    assert torch_cli(args) == 0
    assert capsys.readouterr().out == want
    assert "Linear baseline (kalman)" in want
