"""Sliding-window dataset assembly.

A numpy copy of socialways_tpu/data/windowing.py:24-79 with the window
enumeration of socialways_tpu/native/loader.py:115-148 (reference
``create_dataset``, utils/parse_utils.py:457-508): for every frame ``t`` and
agent with a full past (``n_past`` frames ending at ``t-step``) and future
(``n_next`` frames starting at ``t``), emit an (obs, pred) pair anchored at
``t``; group samples sharing an anchor frame into contiguous
``sub_batches`` [start, end) ranges and re-pack arrays batch-contiguous.

Quirks preserved on purpose (callers depend on the grouping):
- anchors are scanned with stride 1 regardless of the frame interval;
- a sample whose anchor is exactly ``last_included_t + 1`` falls in neither
  grouping branch and is dropped from the packed output (reference
  parse_utils.py:482-488) — harmless for interval>1 data;
- obs is the slice ``p_data[a][kp:k0]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def window_indices(t_data: Sequence[np.ndarray], t_start: int, t_stop: int,
                   step: int, n_past: int, n_next: int) -> np.ndarray:
    """Window hits [(agent, kp, k0, kf, t), ...] in the reference's order:
    anchor-major, then agent.  An agent contributes at anchor t in
    [t_start, t_stop) when its timestamps hold t, t - step·n_past and
    t + step·(n_next - 1); they are sorted per agent, as the parsers
    produce them from these formats."""
    hits = []
    for a, t in enumerate(t_data):
        t = np.asarray(t, np.int64)
        if not len(t):
            continue
        anchors = np.unique(t[(t >= t_start) & (t < t_stop)])
        k0 = np.searchsorted(t, anchors)
        kp = np.searchsorted(t, anchors - step * n_past)
        kf = np.searchsorted(t, anchors + step * (n_next - 1))
        ok = ((kp < len(t)) & (kf < len(t)))
        ok[ok] &= ((t[kp[ok]] == anchors[ok] - step * n_past)
                   & (t[kf[ok]] == anchors[ok] + step * (n_next - 1)))
        hits.append(np.stack([np.full(int(ok.sum()), a), kp[ok], k0[ok],
                              kf[ok], anchors[ok]], axis=1))
    if not hits:
        return np.zeros((0, 5), np.int64)
    hits = np.concatenate(hits).astype(np.int64)
    return hits[np.lexsort((hits[:, 0], hits[:, 4]))]


def create_dataset(
    p_data: Sequence[np.ndarray],
    t_data: Sequence[np.ndarray],
    t_range: range,
    n_past: int = 8,
    n_next: int = 12,
) -> Tuple[np.ndarray, np.ndarray, List[int], np.ndarray]:
    """Returns (obsvs [N, n_past, 2], preds [N, n_next, 2], times, batches)."""
    hits = window_indices(t_data, t_range.start, t_range.stop, t_range.step,
                          n_past, n_next)
    anchor_t = [int(t) for t in hits[:, 4]]
    obs_list = [p_data[a][kp:k0] for a, kp, k0, _, _ in hits]
    pred_list = [p_data[a][k0:kf + 1] for a, _, k0, kf, _ in hits]

    # group consecutive equal anchors into [start, end) sub-batches
    sub_batches: List[List[int]] = []
    last_included_t = -1000
    min_interval = 1
    for i, t in enumerate(anchor_t):
        if t > last_included_t + min_interval:
            sub_batches.append([i, i + 1])
            last_included_t = t
        elif t == last_included_t:
            sub_batches[-1][1] = i + 1

    # re-pack batch-contiguous and re-base the ranges
    obs_kept, pred_kept, t_kept = [], [], []
    batches = []
    cursor = 0
    for s, e in sub_batches:
        obs_kept.extend(obs_list[s:e])
        pred_kept.extend(pred_list[s:e])
        t_kept.extend(anchor_t[s:e])
        batches.append([cursor, cursor + (e - s)])
        cursor += e - s

    if obs_kept:
        obsvs = np.asarray(obs_kept, dtype=np.float32)
        preds = np.asarray(pred_kept, dtype=np.float32)
        batches_arr = np.asarray(batches, dtype=np.int32)
    else:
        obsvs = np.zeros((0, n_past, 2), np.float32)
        preds = np.zeros((0, n_next, 2), np.float32)
        batches_arr = np.zeros((0, 2), np.int32)
    return obsvs, preds, t_kept, batches_arr
