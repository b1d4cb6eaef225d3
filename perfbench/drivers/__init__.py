"""The loops a traffic mix drives, one module a kind, named by the mix's
``driver`` key.  A driver module defines ``Driver(config, mix, seed,
device)`` with:

- ``setup()``: everything before the first timed step (data, weights,
  the program's objects, warm-up of every shape the window uses);
- ``window(seconds) -> Window``: the measured loop;
- ``traced() -> (units, bound_s)``: a short block of the same loop (the
  mix's ``trace_*`` length), run under the profiler, and the sum of its
  attention launches' least times (``perfbench.bounds``);
- ``release()``: drops the program's state before the reference runs;
- ``check(limits) -> [Check]``: the comparison with the plain reference
  of what the window produced, each number beside its limit;
- ``unit``: what ``window`` counts (step, window, request).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch


@dataclasses.dataclass
class Window:
    seconds: float                  # the window's length, host clock
    units: int                      # steps, calls or requests completed
    values: Dict[str, float]        # end-to-end metrics by name
    flops: float                    # model FLOPs the window completed
    samples: Dict[str, List[float]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_params(module: torch.nn.Module, params: Dict[str, torch.Tensor]
                ) -> None:
    """Copy ``params`` into ``module``'s parameters of the same names,
    which must be exactly these names and shapes."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        raise RuntimeError(f"parameter names differ: program {sorted(own)}, "
                           f"benchmark {sorted(params)}")
    with torch.no_grad():
        for k, p in own.items():
            if p.shape != params[k].shape:
                raise RuntimeError(f"{k}: program shape {tuple(p.shape)}, "
                                   f"benchmark {tuple(params[k].shape)}")
            p.copy_(params[k])


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)
