"""Checkpoint I/O in the JAX package's npz format, and the reference's
prediction dumps.  JAX's ``__all__``, each name loaded with its module on
first use."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "checkpoint_exists": ".checkpoint",
    "restore_checkpoint": ".checkpoint",
    "save_checkpoint": ".checkpoint",
    "dump_predictions": ".dumps",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
