"""A whole run on the CPU at a tiny size (the look for a card skipped),
with the timed path broken underneath: ``correct`` has to come out false
for each fault the cell can have.  One chip, so no exchange between chips
to leave out."""

import copy
import time

import pytest
import torch

from perfbench.harness import run_cell


def _run(name, tiny):
    return run_cell(name, 2 ** 32 + 77, 0.5, False, time.perf_counter(),
                    device="cpu", overrides=tiny[name])


def _unchanged_step(real):
    def step(state, batch, draws, cfg, **kw):
        _, m = real(copy.deepcopy(state), batch, draws, cfg, **kw)
        return state, m
    return step


def _half_batch(real):
    def step(state, batch, draws, cfg, **kw):
        valid = batch["valid"].clone()
        valid[valid.shape[0] // 2:] = False
        kw["n_valid"] = int(valid.sum())
        return real(state, dict(batch, valid=valid), draws, cfg, **kw)
    return step


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch])
def test_training_faults_are_refused(fault, monkeypatch, tiny):
    import socialways_torch.engine.trainer as trainer
    monkeypatch.setattr(trainer, "gan_step", fault(trainer.gan_step))
    assert _run("loo-train", tiny)["correct"] is False


def _frozen_rollout(real):
    """The crowd left where it was: every step the last observed point."""
    def rollout(params, obsv_p, noise, n_next, *a, **k):
        out = real(params, obsv_p, noise, n_next, *a, **k)
        last = obsv_p[:, -1:, :].expand(-1, n_next, -1)
        return torch.cat([last, torch.zeros_like(last)], -1).to(out.dtype)
    return rollout


def _frozen_decode(real):
    def decode(params, prep, noise, n_next, *a, **k):
        out = real(params, prep, noise, n_next, *a, **k)
        last = prep[3][:, None, :].expand(-1, n_next, -1)
        return torch.cat([last, torch.zeros_like(last)], -1).to(out.dtype)
    return decode


def _altered(real):
    """One step of every answer moved where it is produced."""
    def call(*a, **k):
        out = real(*a, **k).clone()
        out[..., 5, 0] += 1.0
        return out
    return call


def _half_left_out(real):
    def call(*a, **k):
        out = real(*a, **k).clone()
        n = out.shape[-3]
        out[..., n // 2:, :, :] = 0.0
        return out
    return call


@pytest.mark.parametrize("target,fault", [
    ("socialways_torch.engine.simulate.generator_rollout", _frozen_rollout),
    ("socialways_torch.engine.simulate.crowd_simulate", _altered),
    ("socialways_torch.engine.simulate.crowd_simulate", _half_left_out),
])
def test_simulation_faults_are_refused(target, fault, monkeypatch, tiny):
    import importlib
    mod, name = target.rsplit(".", 1)
    mod = importlib.import_module(mod)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    assert _run("crowd-sim", tiny)["correct"] is False


@pytest.mark.parametrize("target,fault", [
    ("socialways_torch.eval.metrics.decode_rollout", _frozen_decode),
    ("socialways_torch.eval.metrics.k_sample_rollout", _altered),
    ("socialways_torch.eval.metrics.k_sample_rollout", _half_left_out),
])
def test_forecast_faults_are_refused(target, fault, monkeypatch, tiny):
    import importlib
    mod, name = target.rsplit(".", 1)
    mod = importlib.import_module(mod)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    assert _run("crowd-forecast", tiny)["correct"] is False


@pytest.mark.parametrize("name", ["loo-train", "crowd-sim", "crowd-forecast"])
def test_sound_runs_are_correct(name, tiny):
    assert _run(name, tiny)["correct"] is True
