"""Inputs and weights of a run, all drawn from ``--seed``.

Every stream is its own ``numpy.random.SeedSequence((seed, stream))``, so
``--seed`` may be any whole number (the drivers' are larger than 32 bits)
and one stream's draws never move another's.  The weights are drawn on the
device in one call of a seeded ``torch.Generator`` and scaled leaf by leaf
to torch's default init ranges.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

# stream numbers of ``seed_of``
DATA, WEIGHTS, DRAWS, ORDER, NOISE, SAMPLE, SIZES = range(1, 8)


def seed_of(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``stream`` of a run seeded ``seed``."""
    state = np.random.SeedSequence((int(seed),) + stream).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2 ** 63 - 1)


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((int(seed),) + stream))


def device_generator(device, seed: int, *stream: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, *stream))
    return gen


def ethucy_windows(n_windows: int, seed: int, scene_min: int = 2,
                   scene_max: int = 16, n_past: int = 8, n_next: int = 12
                   ) -> Dict[str, np.ndarray]:
    """Windowed trajectories ({obsvs, preds, times, batches}, meters) shaped
    like the ETH/UCY sets: scenes of ``scene_min``-``scene_max`` pedestrians
    in a 15 m square walking 0.8-1.6 m/s at 0.4 s a step with slight turns;
    5 % stand still.  Scenes are added until ``n_windows`` windows exist.
    The sequence of scene sizes is the same for every seed, so every seed
    packs into the same chunks and trains the same work; the seed draws
    the trajectories."""
    rng, sizes = rng_of(seed, DATA), rng_of(0, SIZES)
    obsvs, preds, times, batches = [], [], [], []
    n, steps_total = 0, n_past + n_next
    while n < n_windows:
        s = int(sizes.integers(scene_min, scene_max + 1))
        start = rng.uniform(0.0, 15.0, (s, 1, 2))
        heading = rng.uniform(0.0, 2 * np.pi, (s, 1))
        ang = heading + np.cumsum(rng.normal(0.0, 0.05, (s, steps_total)),
                                  axis=1)
        speed = rng.uniform(0.8, 1.6, (s, 1, 1)) * 0.4
        speed[rng.random(s) < 0.05] = 0.0
        step = speed * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        traj = (start + np.cumsum(step, axis=1)).astype(np.float32)
        obsvs.append(traj[:, :n_past])
        preds.append(traj[:, n_past:])
        times.append(np.full(s, len(batches) * 10, np.int64))
        batches.append([n, n + s])
        n += s
    return {"obsvs": np.concatenate(obsvs), "preds": np.concatenate(preds),
            "times": np.concatenate(times),
            "batches": np.asarray(batches, np.int64)}


def scene_ids(n_agents: int, scene_min: int, scene_max: int,
              rng: np.random.Generator) -> np.ndarray:
    """[N] int32 ids of sorted, contiguous scenes whose sizes are drawn
    uniformly from ``scene_min``-``scene_max`` (the last one cut to fit)."""
    sizes = rng.integers(scene_min, scene_max + 1,
                         size=n_agents // scene_min + 1)
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, n_agents)) + 1
    return np.repeat(np.arange(k, dtype=np.int32), sizes[:k])[:n_agents]


def crowd(n_agents: int, scene_min: int, scene_max: int, n_past: int,
          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(obsv [N, n_past, 2] float32, ids [N] int32): agents on the unit
    square, each with a small random walk as its observed history (the
    construction of the program's ``simulate``), in sorted contiguous
    scenes of random sizes."""
    base = rng.random((n_agents, 1, 2), dtype=np.float32)
    walk = rng.standard_normal((n_agents, n_past, 2),
                               dtype=np.float32) * np.float32(0.005)
    return base + np.cumsum(walk, axis=1), scene_ids(
        n_agents, scene_min, scene_max, rng)


def weights(shapes: Dict[str, Tuple[int, ...]],
            bound: Callable[[str], float], seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """Every leaf U(-bound, bound) in float32, from one device draw."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=device_generator(
        device, seed, WEIGHTS), device=device)
    scale = np.repeat(np.asarray([2.0 * bound(k) for k in shapes],
                                 np.float32), sizes)
    flat = (flat - 0.5) * torch.from_numpy(scale).to(device)
    return {k: t.view(s) for (k, s), t in
            zip(shapes.items(), flat.split(sizes))}
