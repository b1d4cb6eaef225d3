"""K-sample ADE/FDE evaluation (counterpart of socialways_tpu/eval/metrics.py).

Reference ``test()`` (train.py:563-616): K stochastic rollouts per sample,
scored as the average and the min over K of the mean (ADE) and final (FDE)
Euclidean error, in normalized units; divide by ``Scale.sx`` for meters.
The K draws are a batch dimension: the observation is encoded and pooled
once, then ONE decode runs over K·N rows.  Under
``compute_dtype="bfloat16"`` the rollout runs in bf16 and the errors are
scored in float32 (socialways_tpu/eval/metrics.py:47-61, 85-91).
The ``*_members`` forms run the same functions for M stacked generators
(an ensemble, models/stacked.py) under ``torch.func.vmap``, each member
with its own noise, as JAX's ``EnsembleTrainer`` vmaps them
(socialways_tpu/engine/ensemble.py:135-196).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from socialways_torch.config import TrainConfig
from socialways_torch.engine.losses import sample_noise
from socialways_torch.models.generator import (Generator, decode_rollout,
                                               prepare_rollout)
from socialways_torch.models.stacked import Members
from socialways_torch.ops.nn import cast_params
from socialways_torch.ops.traj import (canonicalize_for_rollout,
                                       from_agent_frame_4d)


class EvalSums(NamedTuple):
    ade_avg: torch.Tensor
    fde_avg: torch.Tensor
    ade_min: torch.Tensor
    fde_min: torch.Tensor
    n_samples: torch.Tensor


def draw_noise(k: int, n: int, cfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """The rollout noise [K, N, noise_len], U(0, 1) as the reference draws
    it (train.py:583-585) or N(0, 1) (``noise_dist="gaussian"``); with
    categorical codes each of the K draws embeds its own one-hot code, as
    ``sample_noise`` per K sample does in JAX
    (socialways_tpu/eval/metrics.py:54-58).  torch cannot reproduce
    ``jax.random``'s stream; tests pass JAX's draw in instead."""
    return sample_noise((k, n), cfg, generator, device)


@torch.no_grad()
def k_sample_rollout(g_params: Generator, obsv: torch.Tensor,
                     scene_ids: torch.Tensor, k: int, cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K stochastic rollouts in world coordinates: [K, N, n_next, 4],
    float32 (under bf16, the bf16 values).

    ``noise`` [K, N, noise_len] overrides the draw from ``generator``.
    Under bf16 the weights, ``obsv`` and the noise are cast before the
    canonicalization, as JAX casts them."""
    n = obsv.shape[0]
    if noise is None:
        noise = draw_noise(k, n, cfg, generator, obsv.device)
    cdt = getattr(torch, cfg.compute_dtype)
    if cdt != obsv.dtype:
        g_params = cast_params(g_params, cdt)
        obsv = obsv.to(cdt)
    noise = noise.to(cdt)
    obsv_in, frame, social_x4 = canonicalize_for_rollout(
        obsv, cfg.agent_frame, cfg.use_social)
    prep = prepare_rollout(g_params, obsv_in, scene_ids, cfg.use_social,
                           social_states=social_x4,
                           max_scene=cfg.max_scene_size)
    # K draws as a batch: row kk*N + i is sample kk of agent i
    prep_k = tuple(t.repeat(k, 1) for t in prep)
    out = decode_rollout(g_params, prep_k, noise.reshape(k * n, -1),
                         cfg.n_next, cfg.decoder)
    out = out.reshape(k, n, cfg.n_next, 4)
    if frame is not None:
        out = from_agent_frame_4d(out, frame)    # frame [N] broadcasts to K
    return out.float()


def k_sample_rollout_members(g_params: Generator, obsv: torch.Tensor,
                             scene_ids: torch.Tensor, k: int,
                             cfg: TrainConfig, noise: torch.Tensor
                             ) -> torch.Tensor:
    """``k_sample_rollout`` of each member of the stacked generator
    ``g_params`` under its own noise ``noise[m]`` [K, N, noise_len], on
    shared observations: [M, K, N, n_next, 4]."""
    return Members(noise.shape[0])(
        lambda g, z: k_sample_rollout(g, obsv, scene_ids, k, cfg, noise=z),
        (g_params,), noise)


def k_sample_errors(pred_hat_k: torch.Tensor, pred: torch.Tensor
                    ) -> torch.Tensor:
    """[K, N, T, {2,4}] predictions vs [N, T, 2] truth -> [K, N, T]."""
    d = pred_hat_k[..., :2].float() - pred[None, ..., :2].float()
    return torch.sqrt(torch.sum(d * d, dim=-1))


def eval_chunk(g_params: Generator, batch: Dict[str, torch.Tensor], k: int,
               cfg: TrainConfig, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> EvalSums:
    """Min-of-K / avg-of-K ADE & FDE sums over one padded chunk
    (train.py:602-607)."""
    valid = batch["valid"]
    pred_hat_k = k_sample_rollout(g_params, batch["obsvs"],
                                  batch["scene_ids"], k, cfg, generator,
                                  noise)
    err = k_sample_errors(pred_hat_k, batch["preds"])      # [K, N, T]
    ade_per_k = err.mean(dim=-1)
    fde_per_k = err[..., -1]

    def msum(x):
        return torch.where(valid, x, 0.0).sum()

    return EvalSums(
        ade_avg=msum(ade_per_k.mean(dim=0)),
        fde_avg=msum(fde_per_k.mean(dim=0)),
        ade_min=msum(ade_per_k.min(dim=0).values),
        fde_min=msum(fde_per_k.min(dim=0).values),
        n_samples=valid.sum(),
    )


def eval_chunk_members(g_params: Generator, batch: Dict[str, torch.Tensor],
                       k: int, cfg: TrainConfig, noise: torch.Tensor
                       ) -> EvalSums:
    """``eval_chunk`` of each member of the stacked generator ``g_params``
    under its own noise ``noise[m]`` [K, N, noise_len]: every sum [M]."""
    return Members(noise.shape[0])(
        lambda g, z: eval_chunk(g, batch, k, cfg, noise=z), (g_params,),
        noise)


def finalize_eval(sums: EvalSums, ss: float, n_test_samples: int
                  ) -> Dict[str, float]:
    """Summed normalized errors -> per-sample meters (train.py:611-614)."""
    denom = ss * n_test_samples
    return {
        "ade_avg": float(sums.ade_avg) / denom,
        "fde_avg": float(sums.fde_avg) / denom,
        "ade_min": float(sums.ade_min) / denom,
        "fde_min": float(sums.fde_min) / denom,
    }
