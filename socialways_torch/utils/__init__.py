"""Host-side helpers: profiling, geometry, lr schedules.  JAX's
``__all__``, each name loaded with its module on first use."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "cart2pol": ".math_utils",
    "pol2cart": ".math_utils",
    "norm": ".math_utils",
    "unit": ".math_utils",
    "step_decay_lr": ".learning_utils",
    "StepTimer": ".profiling",
    "trace": ".profiling",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
