"""Crowd simulation: roll a crowd forward window after window.

Counterpart of socialways_tpu/engine/simulate.py:27-195.  Each
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

``crowd_simulate_sharded`` splits the agents over the ranks of a mesh
(JAX's :83-182): each rank encodes and decodes its own agents, and each
window's social attention runs the agents-axis sharded form
(parallel/agents.py: one all-gather of the keys, or the ring), plain torch
as JAX's is plain XLA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine.losses import sample_noise
from socialways_torch.models.generator import (ROLLOUT_PHASES, Generator,
                                               decode_rollout,
                                               encode_observation,
                                               generator_rollout)
from socialways_torch.models.sgan import SGAN_PHASES, is_sgan
from socialways_torch.models.sgan import rollout as sgan_rollout
from socialways_torch.ops.nn import cast_params
from socialways_torch.ops.traj import (canonicalize_for_rollout,
                                       from_agent_frame_4d, obsv_to_4d)
from socialways_torch.parallel.agents import (ring_social_context,
                                              sharded_social_context)
from socialways_torch.parallel.mesh import all_gather_rows
from socialways_torch.utils.profiling import phase, prepare_stamps, span


def _inputs(g_params, obsv0, n_windows, cfg, generator, noise):
    """The compute-dtype weights, observations and noise (drawn from
    ``generator`` unless given) of a simulation."""
    if noise is None:
        noise = sample_noise((n_windows, obsv0.shape[0]), cfg, generator,
                             obsv0.device)
    cdt = getattr(torch, cfg.compute_dtype)
    if cdt != obsv0.dtype:
        g_params = cast_params(g_params, cdt)
        obsv0 = obsv0.to(cdt)
    return g_params, obsv0, noise.to(cdt)


def _windows(rollout, obsv0, noise, cfg, phases=ROLLOUT_PHASES
             ) -> torch.Tensor:
    """The window loop: each window canonicalizes its own buffer, rolls it
    out with ``rollout(obsv_in, social_x4, z)``, and maps the predictions
    back to the world before they re-enter the buffer.  Each window is a
    ``sim.window`` unit of the tracer with ``phases``: ``encode`` (from
    the canonicalization), ``attention`` (Social GAN: ``pool``),
    ``decode``, ``frame``."""
    n_past, obsv, windows = obsv0.shape[1], obsv0, []
    for z in noise:
        with span("sim.window", unit=True, phases=phases,
                  device=obsv0.device):
            phase("encode")
            obsv_in, frame, social_x4 = canonicalize_for_rollout(
                obsv, cfg.agent_frame, cfg.use_social)
            pred = rollout(obsv_in, social_x4, z)
            phase("frame")
            if frame is not None:
                pred = from_agent_frame_4d(pred, frame)
            pos = pred[..., :2]
            windows.append(pos)
            obsv = torch.cat([obsv, pos], dim=1)[:, -n_past:]
    prepare_stamps(obsv0.device)
    return torch.cat(windows, dim=1).float()


@torch.no_grad()
def crowd_simulate(g_params: Generator, obsv0: torch.Tensor,
                   scene_ids: torch.Tensor, n_windows: int, cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Positions ``[N, n_windows * n_next, 2]`` (float32) of ``n_windows``
    prediction windows from the observed windows ``obsv0 [N, n_past, 2]``.

    ``noise [n_windows, N, noise_len]`` overrides the draw from
    ``generator`` (tests pass JAX's draw in); for Social GAN (``g_params``
    a ``models.sgan`` generator, which rolls out in the world frame) it is
    ``[n_windows, S, noise_len]``, one vector a scene id (a draw makes
    S = N).  A ``sim.call`` span of the tracer holds the windows; its own
    time is the casts and the output."""
    with span("sim.call", device=obsv0.device):
        g_params, obsv0, noise = _inputs(g_params, obsv0, n_windows, cfg,
                                         generator, noise)
        if is_sgan(g_params):
            def rollout_sgan(obsv_in, social_x4, z):
                return sgan_rollout(g_params, obsv_in, scene_ids, z,
                                    cfg.n_next, cfg.max_scene_size)
            return _windows(rollout_sgan, obsv0, noise, cfg, SGAN_PHASES)

        def rollout(obsv_in, social_x4, z):
            return generator_rollout(g_params, obsv_in, z, cfg.n_next,
                                     scene_ids, cfg.use_social, social_x4,
                                     cfg.decoder,
                                     max_scene=cfg.max_scene_size)
        return _windows(rollout, obsv0, noise, cfg)


@torch.no_grad()
def crowd_simulate_sharded(g_params: Generator, obsv0: torch.Tensor,
                           scene_ids: torch.Tensor, n_windows: int,
                           cfg: TrainConfig, mesh,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           neighbor_exchange: str = "gather"
                           ) -> torch.Tensor:
    """:func:`crowd_simulate` with the agents split over ``mesh``'s ranks.

    Every rank passes the whole crowd (``obsv0`` [N, n_past, 2],
    ``scene_ids`` [N], the noise [n_windows, N, noise_len] drawn from
    ``generator``, the same on every rank, or given) and keeps its rows
    [r N/D, (r + 1) N/D); the trajectories [N, n_windows * n_next, 2]
    (float32) come back gathered to every rank.  ``neighbor_exchange``:
    "gather" (one all-gather of the keys a window) or "ring" (the key
    blocks passed round the ranks, one block held at a time).  Equals
    :func:`crowd_simulate` under the same noise up to float
    reassociation."""
    if is_sgan(g_params):
        raise NotImplementedError("model='sgan': the sharded simulation "
                                  "runs Social Ways only")
    if neighbor_exchange not in ("gather", "ring"):
        raise ValueError(f"neighbor_exchange must be gather or ring, got "
                         f"{neighbor_exchange!r}")
    n = obsv0.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} agents do not split over {mesh.size} ranks")
    social_ctx = (ring_social_context if neighbor_exchange == "ring"
                  else sharded_social_context)
    g_params, obsv0, noise = _inputs(g_params, obsv0, n_windows, cfg,
                                     generator, noise)
    rows = slice(mesh.rank * (n // mesh.size),
                 (mesh.rank + 1) * (n // mesh.size))
    ids = scene_ids[rows]

    def rollout(obsv_in, social_x4, z):
        obsv_4d = obsv_to_4d(obsv_in)
        h, c = encode_observation(g_params, obsv_4d)
        phase("attention")
        if cfg.use_social:
            x4 = obsv_4d[:, -1] if social_x4 is None else social_x4
            s = social_ctx(g_params, x4, h, ids, mesh)
        else:
            s = torch.zeros_like(h)
        return decode_rollout(g_params, (h, c, s, obsv_in[:, -1]), z,
                              cfg.n_next, cfg.decoder)
    local = _windows(rollout, obsv0[rows], noise[:, rows], cfg)
    return all_gather_rows(local, mesh)


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
