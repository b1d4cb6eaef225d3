"""Trajectory state ops (counterpart of socialways_tpu/ops/traj.py:16-120).

4-D states (x, y, vx, vy) from positions, with backward-difference
velocities and the first step repeating the second's (reference
train.py:130-138); per-agent canonical frames; the constant-velocity
baseline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Frame = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]    # (c, cos, sin)


def obsv_to_4d(obsv_p: torch.Tensor) -> torch.Tensor:
    """[..., T, 2] positions -> [..., T, 4] (pos, backward-diff vel)."""
    v = obsv_p[..., 1:, :] - obsv_p[..., :-1, :]
    v = torch.cat([v[..., :1, :], v], dim=-2)
    return torch.cat([obsv_p, v], dim=-1)


def agent_frame_of(obsv_p: torch.Tensor) -> Frame:
    """Per-agent frame: origin = the last observed point, +x = the last
    observed displacement; zero displacement falls back to the identity
    rotation.  Returns ``(c [..., 2], cos [...], sin [...])``."""
    c = obsv_p[..., -1, :]
    d = obsv_p[..., -1, :] - obsv_p[..., -2, :]
    nrm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    identity = torch.tensor([1.0, 0.0], dtype=d.dtype, device=d.device)
    unit = torch.where(nrm > 1e-8, d / torch.clamp(nrm, min=1e-8), identity)
    return c, unit[..., 0], unit[..., 1]


def to_agent_frame(points: torch.Tensor, frame: Frame) -> torch.Tensor:
    """World -> agent frame for ``points [..., T, 2]``."""
    c, cos, sin = frame
    q = points - c[..., None, :]
    x = q[..., 0] * cos[..., None] + q[..., 1] * sin[..., None]
    y = -q[..., 0] * sin[..., None] + q[..., 1] * cos[..., None]
    return torch.stack([x, y], dim=-1)


def from_agent_frame_4d(states: torch.Tensor, frame: Frame) -> torch.Tensor:
    """Agent frame -> world for 4-D states ``[..., T, 4]``: positions rotate
    and translate, velocities only rotate.  Extra leading axes of
    ``states`` (a K-sample axis) broadcast against the frame."""
    c, cos, sin = frame
    px, py = states[..., 0], states[..., 1]
    vx, vy = states[..., 2], states[..., 3]
    wx = px * cos[..., None] - py * sin[..., None] + c[..., None, 0]
    wy = px * sin[..., None] + py * cos[..., None] + c[..., None, 1]
    wvx = vx * cos[..., None] - vy * sin[..., None]
    wvy = vx * sin[..., None] + vy * cos[..., None]
    return torch.stack([wx, wy, wvx, wvy], dim=-1)


def canonicalize_for_rollout(obsv_p: torch.Tensor, agent_frame: bool,
                             use_social: bool
                             ) -> Tuple[torch.Tensor, Optional[Frame],
                                        Optional[torch.Tensor]]:
    """THE agent_frame x use_social composition, in one place.

    Returns ``(obsv_in, frame, social_x4)``: the encoder input (canonical
    when ``agent_frame``), the frame (None when off), and the WORLD-frame
    last-observed 4-D states for the pairwise social geometry (None unless
    both flags are on).  Distance, bearing and DCA need one shared frame,
    so they are captured before canonicalization while the pooled h_j stay
    canonical."""
    if not agent_frame:
        return obsv_p, None, None
    social_x4 = obsv_to_4d(obsv_p)[:, -1] if use_social else None
    frame = agent_frame_of(obsv_p)
    return to_agent_frame(obsv_p, frame), frame, social_x4


def predict_cv(obsv: torch.Tensor, n_next: int) -> torch.Tensor:
    """Constant-velocity baseline (reference utils/linear_models.py:9-20):
    v = (p[-1] - p[-3]) / 2 when possible, else one diff.
    [..., T, 2] -> [..., n_next, 2]."""
    if obsv.shape[-2] > 2:
        vel = (obsv[..., -1, :] - obsv[..., -3, :]) / 2.0
    else:
        vel = obsv[..., -1, :] - obsv[..., -2, :]
    steps = torch.arange(1, n_next + 1, dtype=obsv.dtype, device=obsv.device)
    return obsv[..., -1:, :] + steps[:, None] * vel[..., None, :]
