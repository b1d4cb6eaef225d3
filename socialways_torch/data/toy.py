"""Synthetic multi-modal toy dataset.

A numpy copy of socialways_tpu/data/toy.py:20-103.

Math parity with the reference toy generator (create_toy.py:11-54,143-192):
``n_conditions`` start angles on a radius-4 circle, each splitting into
``n_modes`` turn modes at ±16°·k with small uniform angle noise; 4 points per
trajectory at radii 4, 3, 2, 1, scaled by 1/4; observation = first 2 points,
prediction = last 2 points; samples grouped into scene batches by shared t0.

With ``seed=30`` and the reference defaults this reproduces the reference's
fixed dataset bit-for-bit (same np.random draw order).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def create_toy_samples(
    n_samples: int,
    n_conditions: int,
    n_modes: int,
    n_per_batch: int = 2,
    rng: np.random.RandomState | None = None,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Returns (samples [n_samples, 4, 2] scaled to radius 1, time_stamps)."""
    if rng is None:
        rng = np.random
    samples = []
    time_stamps = []
    for ii in range(n_samples):
        selected_way = (ii * n_conditions) // n_samples
        # float modulo, as in the reference (create_toy.py:18) — with the
        # defaults n_conditions == n_per_batch so w_i is always 0.0
        w_i = selected_way % (n_conditions / n_per_batch)
        t0 = ii % (n_samples // n_conditions) + w_i * (n_samples // n_conditions)
        data_angle = selected_way * (2.0 * np.pi / n_conditions)

        # first two points on the same radial line (radii 4 and 3)
        p0 = np.array([np.cos(data_angle), np.sin(data_angle)]) * 4
        p1 = np.array([np.cos(data_angle), np.sin(data_angle)]) * 3

        # mode = turn level, centered around 0 at ±16° increments
        fixed_turn = ((ii % n_modes) - n_modes // 2) * 16 * np.pi / 180

        # third point on radius 2 with ±2° uniform jitter
        p2_turn_rand = (rng.rand(1) - 0.5) * 4 * np.pi / 180
        a2 = data_angle + fixed_turn + p2_turn_rand
        p2 = np.concatenate([np.cos(a2), np.sin(a2)]) * 2

        # fourth point on radius 1 with further ±3° uniform jitter
        p3_turn_rand = (rng.rand(1) - 0.5) * 6 * np.pi / 180
        a3 = a2 + p3_turn_rand
        p3 = np.concatenate([np.cos(a3), np.sin(a3)])

        samples.append(np.stack([p0, p1, p2, p3]))
        time_stamps.append(np.array([t0 * 4, t0 * 4 + 1, t0 * 4 + 2, t0 * 4 + 3]))

    return np.array(samples) / 4, time_stamps


def make_toy_npz_arrays(
    n_samples: int = 3 * 6 * 12,
    n_conditions: int = 6,
    n_modes: int = 3,
    n_per_batch: int = 6,
    seed: int = 30,
) -> dict:
    """Build the {obsvs, preds, times, batches} arrays of the toy npz
    (create_toy.py:143-187 semantics, including the seed-30 default)."""
    rng = np.random.RandomState(seed)
    samples, time_stamps = create_toy_samples(
        n_samples, n_conditions, n_modes, n_per_batch, rng=rng)

    # group sample indices by their starting timestamp, insertion-ordered
    t_dict: dict = {}
    for ii in range(n_samples):
        t_dict.setdefault(time_stamps[ii][0], []).append(ii)

    obsvs, preds, times, batches = [], [], [], []
    for _, values in t_dict.items():
        batches.append([len(obsvs), len(obsvs) + len(values)])
        for v in values:
            obsvs.append(samples[v][:2])
            preds.append(samples[v][2:])
            times.append(time_stamps[v][0])

    return {
        "obsvs": np.asarray(obsvs, dtype=np.float32),
        "preds": np.asarray(preds, dtype=np.float32),
        "times": np.asarray(times, dtype=np.int32),
        "batches": np.asarray(batches, dtype=np.int32),
    }


def write_toy_txt(samples: np.ndarray, time_stamps, filename: str) -> None:
    """Reference-format text export (create_toy.py:57-67)."""
    with open(filename, "w+") as fh:
        for ii, sample in enumerate(samples):
            for tt, val in enumerate(np.reshape(sample, (-1, 2))):
                fh.write("%.1f %.1f %.3f %.3f\n"
                         % (time_stamps[ii][tt], ii + 1, val[0], val[1]))
