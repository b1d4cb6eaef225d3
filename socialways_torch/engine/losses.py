"""GAN losses (LSGAN + continuous InfoGAN) with padding-aware masking.

Counterpart of socialways_tpu/engine/losses.py:21-139 for the continuous
code and ``pac == 1`` (reference train.py:471-536):
- LSGAN MSE labels with one smoothing scalar per batch: fake targets are
  U(0, 0.1), real targets U(0.9, 1.0) (train.py:471-472);
- InfoGAN Q-loss: MSE between the Q-head output and the first
  ``n_latent_codes`` dims of the uniform noise (train.py:485, 516).

Every mean is masked: padded samples contribute nothing and the denominator
counts only valid elements.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_noise(n: int, noise_len: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """The generator's noise [n, noise_len], U(0, 1) as the reference draws
    it (train.py:473).  torch cannot reproduce ``jax.random``'s stream;
    tests pass JAX's draw in instead."""
    return torch.rand((n, noise_len), generator=generator, device=device)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Mean squared error over valid samples; equals nn.MSELoss when all
    are valid.  pred/target [N, ...], valid [N] bool."""
    sq = (pred - target) ** 2
    v = valid.reshape(valid.shape + (1,) * (sq.ndim - valid.ndim))
    total = torch.sum(torch.where(v, sq, 0.0))
    per_sample = 1
    for d in sq.shape[valid.ndim:]:
        per_sample *= d
    count = torch.clamp(valid.sum() * per_sample, min=1)
    return total / count


def info_loss(code_hat: torch.Tensor, noise: torch.Tensor,
              valid: torch.Tensor, n_latent_codes: int) -> torch.Tensor:
    """Continuous InfoGAN surrogate: regress the first ``n_latent_codes``
    noise dims."""
    return masked_mse(code_hat, noise[:, :n_latent_codes], valid)


def lsgan_d_loss(fake_label, real_label, fake_code, noise, valid,
                 zeros_target, ones_target, use_info_loss: bool,
                 loss_info_w: float, n_latent_codes: int) -> torch.Tensor:
    """Discriminator loss (train.py:482-494); labels [N, 1]."""
    loss = (masked_mse(fake_label, zeros_target, valid)
            + masked_mse(real_label, ones_target, valid))
    if use_info_loss:
        loss = loss + loss_info_w * info_loss(fake_code, noise, valid,
                                              n_latent_codes)
    return loss


def lsgan_g_loss(gen_label, gen_code, noise, valid, ones_target,
                 use_info_loss: bool, loss_info_w: float,
                 n_latent_codes: int) -> torch.Tensor:
    """Generator fooling (+ info) loss (train.py:510-523)."""
    loss = masked_mse(gen_label, ones_target, valid)
    if use_info_loss:
        loss = loss + loss_info_w * info_loss(gen_code, noise, valid,
                                              n_latent_codes)
    return loss


def traj_errors(pred_hat_p: torch.Tensor, pred_p: torch.Tensor
                ) -> torch.Tensor:
    """Per-sample, per-step Euclidean error [N, T] in normalized units."""
    return torch.sqrt(torch.sum((pred_hat_p - pred_p) ** 2, dim=-1))
