"""Prediction npz dumps in the reference's schema.

Counterpart of socialways_tpu/io/dumps.py:20-43 (reference
train.py:591-599): one npz per evaluated scene batch, named
``{epoch}-{timestamp}.npz``, with keys ``timestamp, obsvs, preds_our [K,
N, T, 2], preds_gtt, preds_lnr``, all denormalized to world units.  The
offline tools (``stats``, the reference's visualize.py and
calc_statistics.py) read exactly this schema.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from socialways_torch.data.scale import Scale


def dump_predictions(
    dump_dir: str,
    epoch: int,
    timestamp,
    obsvs: np.ndarray,        # [N, n_past, 2] normalized
    preds_our: np.ndarray,    # [K, N, n_next, {2,4}] normalized
    preds_gtt: np.ndarray,    # [N, n_next, 2] normalized
    preds_lnr: np.ndarray,    # [N, n_next, 2] normalized (linear baseline)
    scale: Optional[Scale] = None,
) -> str:
    """Write one dump into ``dump_dir``; returns its path."""
    os.makedirs(dump_dir, exist_ok=True)
    file_name = os.path.join(dump_dir, f"{epoch}-{timestamp}.npz")

    def denorm(x):
        x = np.asarray(x[..., :2], dtype=np.float32)
        return scale.denormalize(x) if scale is not None else x

    np.savez(file_name,
             timestamp=timestamp,
             obsvs=denorm(obsvs),
             preds_our=denorm(preds_our),
             preds_gtt=denorm(preds_gtt),
             preds_lnr=denorm(preds_lnr))
    return file_name
