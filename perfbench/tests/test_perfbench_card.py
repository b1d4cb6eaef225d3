"""On a card: one short run of each cell through the command the driver
runs, correct, with a result line of the promised form."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench.harness import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["loo-train", "crowd-sim",
                                  "crowd-forecast"])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join("perfbench", "run.py"), "--workload",
         name, "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, out.stderr[-4000:]
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in r["metrics"].items()
                   if "roofline" in k or "mfu" in k)
