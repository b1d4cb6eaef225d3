"""Step-decay learning-rate schedules, plain Python (counterpart of
socialways_tpu/utils/learning_utils.py; reference
utils/learning_utils.py:13-27).

The reference's ``adjust_learning_rate`` mutates optimizer state with lr =
base * decay^(epoch // interval); here the schedule is a pure function of
the epoch, or of the update count (what ``engine/train_step.py``'s
``Adam`` passes a callable lr)."""

from __future__ import annotations


def step_decay_lr(base_lr: float = 0.005, decay: float = 0.6,
                  interval: int = 50):
    """Returns epoch -> lr with step decay every ``interval`` epochs."""

    def schedule(epoch: int) -> float:
        return base_lr * decay ** (epoch // interval)

    return schedule


def make_step_decay_optax(base_lr: float, decay: float = 0.6,
                          interval_steps: int = 50):
    """The same schedule indexed by the update count, JAX's name: a
    callable lr that ``engine/train_step.py``'s ``Adam`` takes as optax
    takes it."""
    def schedule(count: int) -> float:
        return base_lr * decay ** (count // interval_steps)
    return schedule
