"""Small geometry helpers on the host, in numpy (counterpart of
socialways_tpu/utils/math_utils.py; reference utils/math_utils.py:1-27)."""

from __future__ import annotations

import numpy as np


def cart2pol(x, y):
    """Cartesian -> polar (rho, phi)."""
    return np.hypot(x, y), np.arctan2(y, x)


def pol2cart(rho, phi):
    """Polar -> cartesian (x, y)."""
    return rho * np.cos(phi), rho * np.sin(phi)


def norm(v):
    """Euclidean norm of the last axis."""
    return np.linalg.norm(np.asarray(v), axis=-1)


def unit(v):
    """Unit vector(s) along the last axis (zero stays zero)."""
    v = np.asarray(v, dtype=float)
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.maximum(n, 1e-12), 0.0)
