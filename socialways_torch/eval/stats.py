"""Generated-vs-real distribution metrics and toy mode coverage (host,
numpy).

Counterpart of socialways_tpu/eval/stats.py:28-187 (reference
calc_statistics.py:7-119):

- ``compute_1nn``: mix K real and K fake trajectory sets per pedestrian,
  label them +-1, and measure the leave-one-out 1-nearest-neighbour
  accuracy on the post-observation part (50 % = indistinguishable);
- ``compute_wasserstein``: per pedestrian, the Earth Mover's Distance
  between the real and fake sets under the mean-per-step Euclidean cost,
  solved as an assignment by scipy's ``linear_sum_assignment``, as JAX
  does;
- ``calc_and_store_stats``: walk an epoch dump tree (``io/dumps.py``),
  average both metrics per epoch, cache them to ``stats<K>.npz``;
- ``toy_mode_coverage`` / ``toy_turn_modes``: the toy set's turn modes
  reached by K samples.

Offline analysis on the host: nothing here runs on the card.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def _pairwise_traj_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: [Ka, T, 2], b: [Kb, T, 2] -> [Ka, Kb] mean-per-step Euclidean."""
    d = a[:, None] - b[None, :]
    return np.sqrt((d ** 2).sum(-1)).mean(-1)


def compute_1nn(reals: np.ndarray, fakes: np.ndarray,
                obsv_len: int = 2) -> np.ndarray:
    """reals/fakes: [K, nPed, T, 2].  Returns [overall_acc, real_acc,
    fake_acc] (calc_statistics.py:7-45)."""
    n_reals, n_fakes = reals.shape[0], fakes.shape[0]
    n_mixed = n_reals + n_fakes
    n_ped = reals.shape[1]
    labels = np.array([1] * n_reals + [-1] * n_fakes)
    real_pos = fake_pos = 0
    for kk in range(n_ped):
        mixed = np.concatenate([reals[:, kk, obsv_len:],
                                fakes[:, kk, obsv_len:]])
        d = _pairwise_traj_dist(mixed, mixed)
        np.fill_diagonal(d, np.inf)          # leave-one-out
        same = labels == labels[np.argmin(d, axis=1)]
        real_pos += int(same[:n_reals].sum())
        fake_pos += int(same[n_reals:].sum())
    return np.array([(real_pos + fake_pos) / (n_mixed * n_ped),
                     real_pos / (n_reals * n_ped),
                     fake_pos / (n_fakes * n_ped)])


def compute_wasserstein(reals: np.ndarray, fakes: np.ndarray,
                        obsv_len: int = 2) -> float:
    """EMD by optimal assignment, averaged over the min(K_real, K_fake)
    matched pairs and the pedestrians (calc_statistics.py:48-66)."""
    n_pairs = min(reals.shape[0], fakes.shape[0])
    n_ped = reals.shape[1]
    cost = 0.0
    for kk in range(n_ped):
        d = _pairwise_traj_dist(reals[:, kk, obsv_len:],
                                fakes[:, kk, obsv_len:])
        ri, ci = linear_sum_assignment(d)
        cost += d[ri, ci].sum()
    return cost / (n_pairs * n_ped)


def stats_for_dump(npz_path: str, real_samples: np.ndarray,
                   obsv_len: Optional[int] = None
                   ) -> Tuple[float, float, int]:
    """One dumped npz against the real sample sets [K, nPed, T, 2] (full
    trajectories, observation and prediction).  Returns (1-NN accuracy,
    EMD, nPed).

    The fake sets are the dump's observation, repeated, followed by its
    first K predictions.  A dump with fewer draws than K gives that many
    fake sets (JAX's version raises on it)."""
    with np.load(npz_path) as data:
        obsvs, preds_our = data["obsvs"], data["preds_our"]
    k = min(real_samples.shape[0], preds_our.shape[0])
    n_ped = obsvs.shape[0]
    if obsv_len is None:
        obsv_len = obsvs.shape[1]
    fake = np.concatenate(
        [np.broadcast_to(obsvs[None], (k,) + obsvs.shape),
         preds_our[:k, ..., :2]], axis=2)
    reals = real_samples[:, :n_ped]
    one_nn = compute_1nn(reals, fake, obsv_len)[0]
    emd = compute_wasserstein(reals, fake, obsv_len)
    return one_nn, emd, n_ped


def calc_and_store_stats(main_dir: str, real_samples: np.ndarray,
                         num_samples: int = 20, min_peds: int = 6
                         ) -> Dict[int, Tuple[float, float]]:
    """Walk the epoch sub-directories of ``main_dir`` (as ``cli train
    --dump-dir`` writes them), average 1-NN and EMD per epoch over the
    dumps of at least ``min_peds`` pedestrians, and cache them to
    ``stats<num_samples>.npz`` (calc_statistics.py:70-119)."""
    per_epoch: Dict[int, Tuple[float, float]] = {}
    for dirpath, _, filenames in sorted(os.walk(main_dir)):
        cur = os.path.basename(dirpath)
        if not cur.isdigit():
            continue
        s1 = sw = nf = 0
        for f in sorted(filenames):
            if "npz" not in f or "stats" in f:
                continue
            one_nn, emd, n_ped = stats_for_dump(
                os.path.join(dirpath, f), real_samples[:num_samples])
            if n_ped < min_peds:
                continue
            s1 += one_nn
            sw += emd
            nf += 1
        if nf:
            per_epoch[int(cur)] = (s1 / nf, sw / nf)

    epochs = sorted(per_epoch)
    np.savez(os.path.join(main_dir, f"stats{num_samples}.npz"),
             epochs=np.array(epochs),
             stats_1nn=np.array([per_epoch[e][0] for e in epochs]),
             stats_wst=np.array([per_epoch[e][1] for e in epochs]))
    return per_epoch


def load_real_samples(dataset_npz: str, group: int = 6) -> np.ndarray:
    """The real toy trajectories as sample sets of ``group`` pedestrians:
    [K, group, T, 2] (calc_statistics.py:164-172)."""
    with np.load(dataset_npz) as real:
        samples = np.concatenate([real["obsvs"], real["preds"]], axis=1)
    return samples.reshape(-1, group, samples.shape[1], 2)


def toy_mode_coverage(obsvs: np.ndarray, preds_k: np.ndarray,
                      mode_angles=(-16.0, 0.0, 16.0),
                      tol_deg: float = 8.0) -> float:
    """The share of the toy set's turn modes reached by K samples: the
    mean over agents of (modes hit by the K final points) / n_modes; 1.0
    is full multi-modal coverage, 1/n_modes a collapse.

    obsvs [N, n_past, 2] and preds_k [K, N, T, 2] in world coordinates."""
    modes = toy_turn_modes(obsvs, preds_k[..., -1, :], mode_angles, tol_deg)
    hits = np.stack([(modes == mi).any(axis=0)
                     for mi in range(len(mode_angles))])
    return float(hits.mean())


def toy_turn_modes(obsvs: np.ndarray, finals: np.ndarray,
                   mode_angles=(-16.0, 0.0, 16.0),
                   tol_deg: float = 8.0) -> np.ndarray:
    """Each final point's toy mode index into ``mode_angles`` (-1 = off
    every mode): its bearing relative to the approach direction within
    ``tol_deg`` of a mode's angle.  obsvs [N, n_past, 2], finals [..., N,
    2], world coordinates; the leading axes of ``finals`` broadcast."""
    approach = np.degrees(np.arctan2(obsvs[:, 0, 1], obsvs[:, 0, 0]))
    ang = np.degrees(np.arctan2(finals[..., 1], finals[..., 0]))
    turn = (ang - approach + 180.0) % 360.0 - 180.0
    mode = np.full(turn.shape, -1, np.int32)
    for mi, m in enumerate(mode_angles):
        mode = np.where(np.abs(turn - m) < tol_deg, mi, mode)
    return mode
