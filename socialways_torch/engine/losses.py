"""GAN losses (LSGAN + InfoGAN) with padding-aware masking.

Counterpart of socialways_tpu/engine/losses.py:21-139 (reference
train.py:471-536):
- LSGAN MSE labels with one smoothing scalar per batch: fake targets are
  U(0, 0.1), real targets U(0.9, 1.0) (train.py:471-472);
- InfoGAN Q-loss: MSE between the Q-head output and the first
  ``n_latent_codes`` dims of the uniform noise (train.py:485, 516), or, for
  categorical codes, the cross-entropy of the Q-head's logits against the
  one-hot code embedded in those dims;
- under PacGAN the labels are one a pack, masked by ``label_valid``;
- the l2 loss and the min-over-K variety loss (off by default).

Every mean is masked: padded samples contribute nothing and the denominator
counts only valid elements.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_noise(shape: Tuple[int, ...], cfg,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """The generator's noise [*shape, noise_len], U(0, 1) as the reference
    draws it (train.py:473), or N(0, 1) for ``noise_dist="gaussian"``.
    With categorical codes a uniform code in [0, n_latent_codes) is
    one-hot embedded into the first ``n_latent_codes`` dims.  torch cannot
    reproduce ``jax.random``'s stream; tests pass JAX's draw in instead."""
    draw = torch.randn if cfg.noise_dist == "gaussian" else torch.rand
    z = draw(tuple(shape) + (cfg.noise_len,), generator=generator,
             device=device)
    if cfg.latent_code_type == "categorical":
        n_codes = cfg.n_latent_codes
        c = torch.randint(0, n_codes, tuple(shape), generator=generator,
                          device=device)
        # F.one_hot would read its input's range back to the host
        onehot = (c[..., None] == torch.arange(n_codes, device=c.device))
        z = torch.cat([onehot.to(z.dtype), z[..., n_codes:]], dim=-1)
    return z


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


def masked_xent(logits: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over valid samples.  logits [N, C], labels
    [N]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
    return (torch.where(valid, nll, 0.0).sum()
            / torch.clamp(valid.sum(), min=1))


def info_loss(code_hat: torch.Tensor, noise: torch.Tensor,
              valid: torch.Tensor, n_latent_codes: int,
              latent_code_type: str = "continuous") -> torch.Tensor:
    """InfoGAN surrogate against the code in the first ``n_latent_codes``
    noise dims: regression for continuous codes, cross-entropy against the
    one-hot's index for categorical ones."""
    target = noise[:, :n_latent_codes]
    if latent_code_type == "categorical":
        return masked_xent(code_hat, torch.argmax(target, dim=-1), valid)
    return masked_mse(code_hat, target, valid)


def lsgan_d_loss(fake_label, real_label, fake_code, noise, valid,
                 zeros_target, ones_target, use_info_loss: bool,
                 loss_info_w: float, n_latent_codes: int,
                 latent_code_type: str = "continuous", label_valid=None,
                 w_label=1.0, w_info=1.0) -> torch.Tensor:
    """Discriminator loss (train.py:482-494).  Labels are [N, 1], or under
    PacGAN [N/pac, 1] with ``label_valid`` the packs' validity (the info
    term stays per sample on ``valid``).  ``w_label`` and ``w_info`` weight
    the two terms apart: gradient accumulation weights a micro-chunk's
    label term by its share of valid packs and its info term by its share
    of valid samples."""
    lv = valid if label_valid is None else label_valid
    m = fake_label.shape[0]
    loss = w_label * (masked_mse(fake_label, zeros_target[:m], lv)
                      + masked_mse(real_label, ones_target[:m], lv))
    if use_info_loss:
        loss = loss + w_info * loss_info_w * info_loss(
            fake_code, noise, valid, n_latent_codes, latent_code_type)
    return loss


def lsgan_g_loss(gen_label, gen_code, noise, valid, ones_target,
                 use_info_loss: bool, loss_info_w: float,
                 n_latent_codes: int, latent_code_type: str = "continuous",
                 label_valid=None, w_label=1.0, w_info=1.0) -> torch.Tensor:
    """Generator fooling (+ info) loss (train.py:510-523); ``label_valid``
    and the term weights as in :func:`lsgan_d_loss`."""
    lv = valid if label_valid is None else label_valid
    m = gen_label.shape[0]
    loss = w_label * masked_mse(gen_label, ones_target[:m], lv)
    if use_info_loss:
        loss = loss + w_info * loss_info_w * info_loss(
            gen_code, noise, valid, n_latent_codes, latent_code_type)
    return loss


def l2_traj_loss(pred_hat_p: torch.Tensor, pred_p: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Plain L2 between predicted and true positions (train.py:512)."""
    return masked_mse(pred_hat_p, pred_p, valid)


def variety_loss(pred_hat_p_k: torch.Tensor, pred_p: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Min-over-K per-sample L2 (the SGAN variety loss; JAX's corrected
    form of train.py:527-536).  pred_hat_p_k [K, N, T, 2], pred_p
    [N, T, 2]."""
    sq = torch.mean((pred_hat_p_k - pred_p[None]) ** 2, dim=(-2, -1))
    per_sample_min = torch.min(sq, dim=0).values
    return (torch.where(valid, per_sample_min, 0.0).sum()
            / torch.clamp(valid.sum(), min=1))


def traj_errors(pred_hat_p: torch.Tensor, pred_p: torch.Tensor
                ) -> torch.Tensor:
    """Per-sample, per-step Euclidean error [N, T] in normalized units."""
    return torch.sqrt(torch.sum((pred_hat_p - pred_p) ** 2, dim=-1))
