"""Constant-acceleration Kalman filter/smoother for trajectories.

Counterpart of socialways_tpu/ops/kalman.py:34-183 (the reference's dead
``MyKalman``, utils/linear_models.py:23-97): the 6-state
constant-acceleration model — state (x, y, vx, vy, ax, ay), position-only
observations, the same A/C/Q/R matrices (Q the continuous-white-noise-
acceleration form scaled by 0.5, R = I) and fixed matrices (no EM).

JAX scans one track and vmaps over tracks; here the leading dimensions are
one batch dimension and a Python loop over T runs batched 6x6 products:
the gain and the RTS gain by ``torch.linalg.solve``, the covariance update
in Joseph form.  The reference's single-measurement smoother guard (return
the measurement and zero velocity) is kept.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class KalmanModel(NamedTuple):
    """Fixed linear-Gaussian model matrices ([6,6], [2,6], [6,6], [2,2])."""
    A: torch.Tensor   # transition
    C: torch.Tensor   # observation (selects position)
    Q: torch.Tensor   # process noise
    R: torch.Tensor   # observation noise


def kalman_matrices(dt: float, dtype=torch.float32, device=None
                    ) -> KalmanModel:
    """The reference's constant-acceleration model (linear_models.py:28-66)."""
    t = float(dt)
    mk = lambda rows: torch.tensor(rows, dtype=dtype, device=device)
    A = mk([[1, 0, t, 0, t ** 2, 0],
            [0, 1, 0, t, 0, t ** 2],
            [0, 0, 1, 0, t, 0],
            [0, 0, 0, 1, 0, t],
            [0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 1]])
    C = mk([[1, 0, 0, 0, 0, 0],
            [0, 1, 0, 0, 0, 0]])
    Q = mk([[t**5 / 20, 0, t**4 / 8, 0, t**3 / 6, 0],
            [0, t**5 / 20, 0, t**4 / 8, 0, t**3 / 6],
            [t**4 / 8, 0, t**3 / 3, 0, t**2 / 2, 0],
            [0, t**4 / 8, 0, t**3 / 3, 0, t**2 / 2],
            [t**3 / 6, 0, t**2 / 2, 0, t, 0],
            [0, t**3 / 6, 0, t**2 / 2, 0, t]]) * 0.5
    R = torch.eye(2, dtype=dtype, device=device)      # r = 1
    return KalmanModel(A, C, Q, R)


def _update(m: torch.Tensor, P: torch.Tensor, z: torch.Tensor,
            model: KalmanModel) -> Tuple[torch.Tensor, torch.Tensor]:
    """Measurement update of [B, 6] means and [B, 6, 6] covariances by
    [B, 2] positions."""
    _, C, _, R = model
    S = C @ P @ C.T + R                                  # innovation
    K = torch.linalg.solve(S.mT, (P @ C.T).mT).mT       # gain, via solve
    m_new = m + (K @ (z - m @ C.T)[..., None])[..., 0]
    I_KC = torch.eye(6, dtype=m.dtype, device=m.device) - K @ C
    # Joseph form: keeps P symmetric PSD under f32 round-off
    return m_new, I_KC @ P @ I_KC.mT + K @ R @ K.mT


def _filter(z: torch.Tensor, model: KalmanModel):
    """Forward pass over [B, T, 2] tracks.  Returns the filtered means and
    covariances and the one-step-ahead priors used at each t (needed by
    RTS), each as a list over T of [B, 6] / [B, 6, 6]."""
    A, _, Q, _ = model
    b = z.shape[0]
    # prior: mean at the first measurement with zero velocity/acceleration,
    # diffuse velocity/acceleration variance
    m = torch.cat([z[:, 0], z.new_zeros(b, 4)], dim=1)
    P = torch.diag(z.new_tensor([1.0, 1.0, 10.0, 10.0, 10.0, 10.0])
                   ).expand(b, 6, 6)
    ms, Ps, mps, Pps = [], [], [m], [P]
    # step 0 updates the diffuse prior with z0 directly (no transition)
    m, P = _update(m, P, z[:, 0], model)
    ms.append(m)
    Ps.append(P)
    for t in range(1, z.shape[1]):
        mp = m @ A.T                                     # predict
        Pp = A @ P @ A.T + Q
        m, P = _update(mp, Pp, z[:, t], model)
        ms.append(m)
        Ps.append(P)
        mps.append(mp)
        Pps.append(Pp)
    return ms, Ps, mps, Pps


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[-2:]))


def kalman_filter(measurements: torch.Tensor, dt: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter [..., T, 2] position tracks.  Returns (positions [..., T, 2],
    velocities [..., T, 2]), the filtered state means (the reference's
    ``MyKalman.filter`` slices)."""
    model = kalman_matrices(dt, measurements.dtype, measurements.device)
    ms = torch.stack(_filter(_flat(measurements), model)[0], dim=1)
    ms = ms.reshape(measurements.shape[:-1] + (6,))
    return ms[..., 0:2], ms[..., 2:4]


def kalman_smooth(measurements: torch.Tensor, dt: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RTS-smooth [..., T, 2] tracks -> (positions, velocities).  A
    single-measurement track returns (measurement, zero velocity), the
    reference's explicit guard (linear_models.py:78-80)."""
    if measurements.shape[-2] == 1:
        return measurements, torch.zeros_like(measurements)
    model = kalman_matrices(dt, measurements.dtype, measurements.device)
    A = model.A
    ms, Ps, mps, Pps = _filter(_flat(measurements), model)
    m_s, P_s = ms[-1], Ps[-1]
    out = [m_s]
    for t in range(len(ms) - 2, -1, -1):
        # G = P_f A^T Pp_next^{-1}, via solve on the symmetric Pp
        G = torch.linalg.solve(Pps[t + 1], (Ps[t] @ A.T).mT).mT
        m_s, P_s = (ms[t] + (G @ (m_s - mps[t + 1])[..., None])[..., 0],
                    Ps[t] + G @ (P_s - Pps[t + 1]) @ G.mT)
        out.append(m_s)
    sm = torch.stack(out[::-1], dim=1).reshape(measurements.shape[:-1]
                                               + (6,))
    return sm[..., 0:2], sm[..., 2:4]


def predict_kalman(obsv: torch.Tensor, n_next: int, dt: float = 1.0
                   ) -> torch.Tensor:
    """Forecasting baseline: Kalman-filter the observation, then roll the
    final state forward ``n_next`` steps with the transition A.  Same
    contract as ``predict_cv``: [..., T, 2] -> [..., n_next, 2]."""
    model = kalman_matrices(dt, obsv.dtype, obsv.device)
    m = _filter(_flat(obsv), model)[0][-1]
    pos = []
    for _ in range(n_next):
        m = m @ model.A.T
        pos.append(m[:, 0:2])
    return torch.stack(pos, dim=1).reshape(obsv.shape[:-2] + (n_next, 2))
