"""The ``sgan-crowd-sim`` cell at a tiny size on the CPU (the program's
plain pool): correct against the reference, the float8 control refused
by its limits, the yardstick's counts at the cell's own crowd, and the
new readers' None from a program without what they read."""

import sys
import time
import types

import numpy as np
import pytest

from perfbench import data, sgan_counts
from perfbench.harness import Context, load_cell, reader, run_cell

TINY = {"agents": 1500, "check_share": 0.25}


def test_sgan_cell_runs_correct_on_the_plain_path():
    r = run_cell("sgan-crowd-sim", 2 ** 33 + 19, 0.5, False,
                 time.perf_counter(), device="cpu", overrides=TINY)
    assert r["correct"] and r["attempted"] >= 4
    assert set(r["metrics"]) == {"sim_agent_steps_per_s", "setup_s"}


def test_sgan_cell_refuses_the_float8_control():
    from perfbench.control import readings
    r = readings("sgan-crowd-sim", 2 ** 33 + 23, 0.5, device="cpu",
                 overrides=TINY)
    limits = load_cell("sgan-crowd-sim").limits
    assert all(r["program"][k] <= limits[k] for k in limits)
    assert any(r["control_readings"][k] > limits[k] for k in limits)


def test_sgan_counts_at_the_cells_crowd():
    """Pairs with the diagonal, the pool's least time and model FLOPs a
    window at the cell's 1,048,576 agents, against hand counts."""
    cell = load_cell("sgan-crowd-sim")
    cfg, mix = cell.config["train_config"], cell.mix
    _, ids = data.crowd(mix["agents"], mix["scene_min"], mix["scene_max"],
                        cfg["n_past"], data.rng_of(5, data.DATA))
    _, sizes = np.unique(ids, return_counts=True)
    n_pairs = int(np.sum(sizes.astype(np.int64) ** 2))
    assert sgan_counts.pairs(ids) == n_pairs
    assert 44e6 < n_pairs < 46.5e6                  # E[s^2] / E[s] ~ 43
    b = sgan_counts.pool_bound(cfg, ids)
    flop = 2.0 * (n_pairs * 512 * 32 + len(ids) * 34 * 512)
    assert b["flop"] == flop and b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(flop / 989e12 * 1e3)
    per_pair = 2 * 16 + 48 * 512 + 512 * 32
    per_agent = (8 * (2 * 16 + 48 * 128) + 64 * 64 + 64 * 24
                 + 2 * 16 + 12 * (48 * 128 + 32 * 2 + 2 * 16))
    assert sgan_counts.simulate_flops(cfg, ids, 1) == 2.0 * (
        n_pairs * per_pair + len(ids) * per_agent)


@pytest.mark.parametrize("name", ["pool_device_ms.sgan", "pool_roofline.sgan",
                                  "fused_pool_share.sgan"])
def test_sgan_readers_read_nothing_from_a_program_without_them(
        name, monkeypatch):
    """Untraced: None.  Traced, but the program lacks the phase, the
    kernel's records or the fused pool: None, without raising."""
    mod = reader(name)
    assert mod.read(Context(window=None, peak_flops=1.0)) is None
    trace = types.SimpleNamespace(by_name={"social_attention_fwd_kernel":
                                           1.0})
    ctx = Context(window=None, peak_flops=1.0, trace=trace, trace_whole=True,
                  traced_units=4, traced_bound_s=0.01)
    monkeypatch.setitem(sys.modules, "socialways_torch.models.sgan", None)
    from socialways_torch.utils import profiling
    monkeypatch.setattr(profiling, "_session", None)
    assert mod.read(ctx) is None
