"""The control at a tiny size on the CPU: the plain reference in the next
precision below the configuration's, put in the program's place, has to
fail the cell's limits (the full-size readings come from
``perfbench/control.py`` on the card)."""

import pytest

from perfbench.control import readings
from perfbench.harness import load_cell


@pytest.mark.parametrize("name", ["loo-train", "crowd-sim",
                                  "crowd-forecast"])
def test_control_is_refused(name, tiny):
    limits = load_cell(name).limits
    for seed in (3, 2 ** 31 + 9):
        r = readings(name, seed, 0.5, device="cpu", overrides=tiny[name])
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["control_readings"].items()), r
