"""Crowd simulation: roll a crowd forward window after window.

Counterpart of socialways_tpu/engine/simulate.py:27-80 and :185-195.  Each
window runs the whole generator (encode, social attention over every
agent's scene, autoregressive decode); its predicted steps are appended to
the observation buffer and the last ``n_past`` of it observe the next
window, so the social context refreshes every ``n_next`` steps and stays
frozen within a window (the reference's ``predict`` semantics,
train.py:409-413).  JAX scans the windows in one jitted program; here the
window loop is a Python loop of device work with no host sync inside it.
On CUDA the attention is the hand-written forward kernel, scanning scene
windows when ``cfg.max_scene_size > 0``.  Under
``compute_dtype="bfloat16"`` the weights, the observations, the noise and
the world-frame buffer are bf16 (socialways_tpu/engine/simulate.py:41-47,
60-83); the trajectories come back float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine.losses import sample_noise
from socialways_torch.models.generator import Generator, generator_rollout
from socialways_torch.ops.nn import cast_params
from socialways_torch.ops.traj import (canonicalize_for_rollout,
                                       from_agent_frame_4d)


@torch.no_grad()
def crowd_simulate(g_params: Generator, obsv0: torch.Tensor,
                   scene_ids: torch.Tensor, n_windows: int, cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Positions ``[N, n_windows * n_next, 2]`` (float32) of ``n_windows``
    prediction windows from the observed windows ``obsv0 [N, n_past, 2]``.

    ``noise [n_windows, N, noise_len]`` overrides the draw from
    ``generator`` (tests pass JAX's draw in)."""
    n, n_past, _ = obsv0.shape
    if noise is None:
        noise = sample_noise((n_windows, n), cfg, generator, obsv0.device)
    cdt = getattr(torch, cfg.compute_dtype)
    if cdt != obsv0.dtype:
        g_params = cast_params(g_params, cdt)
        obsv0 = obsv0.to(cdt)
    noise = noise.to(cdt)
    obsv, windows = obsv0, []
    for z in noise:
        # each window canonicalizes its own buffer, and predictions map
        # back to the world before they re-enter it
        obsv_in, frame, social_x4 = canonicalize_for_rollout(
            obsv, cfg.agent_frame, cfg.use_social)
        pred = generator_rollout(g_params, obsv_in, z, cfg.n_next, scene_ids,
                                 cfg.use_social, social_x4, cfg.decoder,
                                 max_scene=cfg.max_scene_size)
        if frame is not None:
            pred = from_agent_frame_4d(pred, frame)
        pos = pred[..., :2]
        windows.append(pos)
        obsv = torch.cat([obsv, pos], dim=1)[:, -n_past:]
    return torch.cat(windows, dim=1).float()


def initial_crowd(n: int, scene_size: int, n_past: int, seed: int):
    """(obsv0 [N, n_past, 2] float32, scene_ids [N] int32): agents on a
    unit square, each with a small random walk as its observed history,
    packed into sorted scenes of ``scene_size`` (JAX's construction in
    socialways_tpu/cli/main.py:1138-1145, draw for draw)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, 1, 2).astype(np.float32)
    steps = rng.randn(n, n_past, 2).astype(np.float32) * 0.005
    obsv0 = base + np.cumsum(steps, axis=1)
    scene_ids = (np.arange(n) // scene_size).astype(np.int32)
    return obsv0, scene_ids


def make_crowd_sim(cfg: TrainConfig, n_windows: int):
    """``run(g_params, obsv0, scene_ids, generator)``: the simulator at a
    fixed window count (JAX's jitted closure; here a plain one)."""
    def run(g_params, obsv0, scene_ids, generator=None):
        return crowd_simulate(g_params, obsv0, scene_ids, n_windows, cfg,
                              generator)
    return run


def throughput_agent_steps(n_agents: int, n_windows: int, n_next: int,
                           elapsed_s: float) -> float:
    return n_agents * n_windows * n_next / elapsed_s
