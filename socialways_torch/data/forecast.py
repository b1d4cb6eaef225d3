"""Forecast windows: observation-only inputs for inference.

A numpy copy of socialways_tpu/data/forecast.py:24-90.

The reference has no standalone inference path at all — its ``predict``
lives inside the training script and always rides windows that carry
ground-truth futures (train.py:571-607), and ``create_dataset`` DROPS
any window without ``n_next`` future frames (create_dataset.py:20-38;
our parity copy `data/windowing.py` keeps that behavior for training
data).  For serving, the interesting windows are exactly the ones
without futures: "everyone currently in the scene, forecast them now".

:func:`forecast_windows` builds those: for a query timestamp, every
agent with ``n_past`` consecutive observed frames ENDING there
contributes one window; the group forms one scene (social pooling sees
all of them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def forecast_windows(
    p_data: Sequence[np.ndarray],
    t_data: Sequence[np.ndarray],
    n_past: int,
    interval: Optional[int] = None,
    at_time: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Last-``n_past`` observation windows for agents present at
    ``at_time``.

    ``p_data``/``t_data`` are the per-agent position/timestamp arrays a
    parser produces (`data/parsers.py`).  ``interval`` defaults to the
    modal consecutive-timestamp gap over all agents.  ``at_time``
    defaults to the latest timestamp at which at least one agent has a
    full history (so "forecast now" works out of the box on a raw
    annotation file).

    Returns ``(obsvs [N, n_past, 2] world coordinates, agent_idx [N]
    indices into p_data, at_time)``.  Raises ValueError when no agent
    qualifies.
    """
    if interval is None:
        gaps: List[int] = []
        for t in t_data:
            if len(t) > 1:
                gaps.extend(np.diff(np.asarray(t)).tolist())
        interval = int(np.bincount(np.asarray(gaps, int)).argmax()) \
            if gaps else 1
    interval = max(int(interval), 1)

    def window_ending_at(i: int, ts: int) -> Optional[np.ndarray]:
        t = np.asarray(t_data[i])
        j = np.searchsorted(t, ts)
        if j >= len(t) or t[j] != ts or j < n_past - 1:
            return None
        idx = np.arange(j - n_past + 1, j + 1)
        if not np.array_equal(t[idx],
                              ts - interval * np.arange(n_past - 1, -1, -1)):
            return None                  # gap in the history
        return np.asarray(p_data[i])[idx, :2]

    if at_time is None:
        candidates = sorted({int(t[-1]) for t in t_data if len(t)},
                            reverse=True)
        for ts in candidates:
            if any(window_ending_at(i, ts) is not None
                   for i in range(len(t_data))):
                at_time = ts
                break
        else:
            raise ValueError(
                f"no agent has {n_past} consecutive frames at interval "
                f"{interval} — nothing to forecast")
    at_time = int(at_time)

    obs, idx = [], []
    for i in range(len(t_data)):
        w = window_ending_at(i, at_time)
        if w is not None:
            obs.append(w)
            idx.append(i)
    if not obs:
        raise ValueError(
            f"no agent has {n_past} consecutive frames ending at "
            f"t={at_time} (interval {interval})")
    return (np.stack(obs).astype(np.float64),
            np.asarray(idx, np.int64), at_time)
