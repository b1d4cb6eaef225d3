"""numpy-only data layer (copies of socialways_tpu/data): the parsers,
Scale, windowing, forecast windows, the toy set and the npz dataset.
JAX's ``__all__``, each name loaded with its module on first use."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "Scale": ".scale",
    "BIWIParser": ".parsers",
    "SDDParser": ".parsers",
    "SeyfriedParser": ".parsers",
    "TrajnetParser": ".parsers",
    "create_dataset": ".windowing",
    "forecast_windows": ".forecast",
    "create_toy_samples": ".toy",
    "make_toy_npz_arrays": ".toy",
    "TrajectoryDataset": ".dataset",
    "load_npz_dataset": ".dataset",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
