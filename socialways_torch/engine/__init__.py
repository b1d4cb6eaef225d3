"""The training engine: the GAN step, the epoch loop, the ensemble.

The names below load their module on first use (PEP 562), since
``eval/metrics.py`` imports ``engine.losses`` and ``engine.trainer``
imports ``eval/metrics.py``: importing them here eagerly would be a cycle.
"""

import importlib

_EXPORTS = {
    "StepMetrics": "train_step", "TrainState": "train_step",
    "eval_params": "train_step", "gan_step": "train_step",
    "init_train_state": "train_step", "make_optimizers": "train_step",
    "transplant_schedule_clock": "train_step", "Trainer": "trainer",
    "EnsembleTrainer": "ensemble", "member_state": "ensemble",
    "stack_states": "ensemble", "EpochGraphs": "graphed",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
