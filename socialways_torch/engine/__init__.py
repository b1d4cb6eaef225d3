"""The training engine: the GAN step, the epoch loop, the ensemble, the
crowd simulation, the leave-one-out protocol and the rescues.  JAX's
``__all__`` and the port's ``EpochGraphs``.

The names load their module on first use (PEP 562), since
``eval/metrics.py`` imports ``engine.losses`` and ``engine.trainer``
imports ``eval/metrics.py``: importing them here eagerly would be a cycle.
"""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "StepMetrics": ".train_step",
    "TrainState": ".train_step",
    "eval_params": ".train_step",
    "gan_step": ".train_step",
    "init_train_state": ".train_step",
    "make_optimizers": ".train_step",
    "transplant_schedule_clock": ".train_step",
    "Trainer": ".trainer",
    "EnsembleTrainer": ".ensemble",
    "member_state": ".ensemble",
    "stack_states": ".ensemble",
    "losses": ".losses",
    "crowd_simulate": ".simulate",
    "crowd_simulate_sharded": ".simulate",
    "make_crowd_sim": ".simulate",
    "merge_scenes": ".ethucy",
    "run_leave_one_out": ".ethucy",
    "StallTracker": ".rescue",
    "reinit_discriminator": ".rescue",
    "EpochGraphs": ".graphed",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
