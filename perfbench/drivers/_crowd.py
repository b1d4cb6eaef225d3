"""What the crowd drivers share: the served generator from weights drawn
here, the noise of a call drawn from its own stream, and the comparison
of world-frame trajectories with the reference's."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench import data
from perfbench.drivers import load_params
from perfbench.reference import model


def served_generator(config: Dict, seed: int, device):
    """(the program's TrainConfig, its Generator holding this run's
    weights, the weights as the reference takes them)."""
    from socialways_torch.config import TrainConfig
    from socialways_torch.models.generator import init_generator
    cfg = TrainConfig(**config["train_config"])
    if not (cfg.agent_frame and cfg.use_social and cfg.decoder == "fc"
            and cfg.latent_code_type == "continuous"
            and cfg.noise_dist == "uniform"):
        raise NotImplementedError("the reference serves the record arm's "
                                  "generator only")
    shape_of = model.shapes(cfg.hidden_size, cfg.social_feature_size,
                            cfg.noise_len, cfg.n_next, cfg.n_latent_codes)
    g_shapes = {k: shape_of[k] for k in model.generator_names()}
    params = data.weights(g_shapes, lambda k: model.fan_bound(k, shape_of),
                          seed, device)
    gen = init_generator(cfg, torch.Generator().manual_seed(0), device)
    load_params(gen, params)
    gen.requires_grad_(False)
    return cfg, gen, params


class NoiseStream:
    """U(0, 1) noise of call ``i`` from stream (seed, NOISE, i): the same
    draw again for the reference."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, device
        self.gen = torch.Generator(device=device)

    def draw(self, i: int, shape: Tuple[int, ...]) -> torch.Tensor:
        self.gen.manual_seed(data.seed_of(self.seed, data.NOISE, i))
        return torch.rand(shape, generator=self.gen, device=self.device)


def trajectory_gaps(prog: torch.Tensor, ref: torch.Tensor,
                    last: torch.Tensor) -> Tuple[float, float]:
    """(widest, rms) gap of the program's positions ``prog`` from the
    reference's ``ref`` ([N, T, 2]), in units of the reference's rms
    motion from the last observed positions ``last`` [N, 2]; NaN where
    the program's are not all finite."""
    prog, ref = prog.double(), ref.double()
    motion = ref - last.double()[:, None, :]
    scale = float(torch.sqrt(torch.mean(motion * motion)))
    d = prog - ref
    if not bool(torch.isfinite(prog).all()):
        return float("nan"), float("nan")
    return (float(torch.max(torch.abs(d))) / scale,
            float(torch.sqrt(torch.mean(d * d))) / scale)


def worst(a: Tuple[float, ...], b: Tuple[float, ...]) -> Tuple[float, ...]:
    """Element-wise maximum, NaN winning."""
    return tuple(float("nan") if x != x or y != y else max(x, y)
                 for x, y in zip(a, b))


def sample_scenes(ids: np.ndarray, share: float, seed: int) -> np.ndarray:
    """Rows of whole scenes, about ``share`` of all, drawn from the seed,
    in order (so the sample's scenes stay sorted and contiguous)."""
    rng = data.rng_of(seed, data.SAMPLE)
    scenes = np.unique(ids)
    k = max(1, int(round(share * len(scenes))))
    chosen = rng.choice(scenes, size=k, replace=False)
    return np.nonzero(np.isin(ids, chosen))[0]
