"""K-sample ADE/FDE evaluation, the constant-velocity baseline and the
toy set's EMD / 1-NN statistics.  JAX's ``__all__`` (``predict_cv`` comes
from ``ops.traj``, as in JAX), each name loaded with its module on first
use."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "EvalSums": ".metrics",
    "eval_chunk": ".metrics",
    "finalize_eval": ".metrics",
    "k_sample_errors": ".metrics",
    "k_sample_rollout": ".metrics",
    "predict_cv": "..ops.traj",
    "calc_and_store_stats": ".stats",
    "compute_1nn": ".stats",
    "compute_wasserstein": ".stats",
    "load_real_samples": ".stats",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
