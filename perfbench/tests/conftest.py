"""Tiny sizes of the cells for the CPU, where the program takes its plain
paths (no kernels, no graphs)."""

import os
import sys

import pytest
import torch

# the runs here are CPU-bound and the suite runs in several workers
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"loo-train": {"windows": 1200},
        "crowd-sim": {"agents": 600, "check_share": 0.5},
        "crowd-forecast": {"agents_min": 200, "agents_max": 400, "pool": 3,
                           "k": 4, "check_requests": 2}}


@pytest.fixture
def tiny():
    return TINY
