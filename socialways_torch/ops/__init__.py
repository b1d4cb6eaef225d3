"""Plain tensor ops: linear/MLP, LSTM, trajectory states, the Kalman
filter, dense social attention.  JAX's ``__all__``, each name loaded with
its module on first use."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "get_traj_4d": ".traj",
    "obsv_to_4d": ".traj",
    "pred_to_4d": ".traj",
    "predict_cv": ".traj",
    "kalman_filter": ".kalman",
    "kalman_matrices": ".kalman",
    "kalman_smooth": ".kalman",
    "predict_kalman": ".kalman",
    "attention_pool": ".social",
    "scene_mask": ".social",
    "social_features": ".social",
    "social_pool": ".social",
    "lstm_cell": ".lstm",
    "lstm_init": ".lstm",
    "lstm_seq": ".lstm",
    "zero_state": ".lstm",
    "leaky_relu": ".nn",
    "linear_apply": ".nn",
    "linear_init": ".nn",
    "mlp_apply": ".nn",
    "mlp_init": ".nn",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
