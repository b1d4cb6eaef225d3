"""The unrolled LSGAN + InfoGAN training step of the loo model.

Counterpart of socialways_tpu/engine/train_step.py:49-171, 174-764 for the
feature set of ``cli train --recipe loo``: agent frame, social attention,
EMA generator, D instance noise annealed to a floor, ``n_unrolling_steps``
lookahead D updates with a configurable restore, the continuous info loss,
``pac == 1``, float32.  The other ``gan_step`` variants raise in
``check_supported``.

The step, in JAX's order:
1. canonicalize to the agent frame, keeping the world-frame last states
   for the social geometry (:210-220);
2. ONE rollout with its autograd graph; the D phase sees it detached and
   the G phase backpropagates through it once (:403-405);
3. D instance noise with sigma from the G optimizer's count BEFORE the
   update, annealed and floored (:407-443);
4. the D phase: ``n_unrolling_steps + 1`` Adam updates, D snapshotted after
   the first (:536-549);
5. the G phase against the unrolled D with a fresh eps (:583-598, 687-693);
6. the EMA of G (:705-710);
7. D restored by ``d_restore`` while its optimizer keeps every update
   (:712-718);
8. the metrics; ``d_loss`` is the first D update's loss (:720-729).

State lives in modules updated in place.  Every random draw is an explicit
tensor in a ``StepDraws`` (torch cannot reproduce ``jax.random``; tests
feed JAX's draws in).  A chunk with no valid row leaves the state as it is
(:732-763), decided on the host from its valid count.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from socialways_torch.config import TrainConfig
from socialways_torch.engine.losses import (lsgan_d_loss, lsgan_g_loss,
                                            sample_noise, traj_errors)
from socialways_torch.models.discriminator import (Discriminator,
                                                   discriminator_apply,
                                                   discriminator_heads,
                                                   encode_obsv,
                                                   init_discriminator,
                                                   restore_linear_only)
from socialways_torch.models.generator import (Generator, generator_rollout,
                                               init_generator)
from socialways_torch.ops.traj import (canonicalize_for_rollout, obsv_to_4d,
                                       pred_to_4d, to_agent_frame)


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the two moments, keyed
    by parameter name.  The count is a host integer: the schedules read it
    without a device round trip."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam with a constant learning rate:
    ``p -= lr * m_hat / (sqrt(v_hat) + eps)``, eps outside the root."""
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: nn.Module) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p)
                         for k, p in params.named_parameters()}
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def step(self, opt: AdamState, params: nn.Module,
             grads: Sequence[torch.Tensor]) -> None:
        """One update of ``params`` in place from ``grads`` (in
        ``parameters()`` order)."""
        ps = list(params.parameters())
        mu, nu = list(opt.mu.values()), list(opt.nu.values())
        grads = list(grads)
        opt.count += 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        m_hat = torch._foreach_div(mu, 1.0 - self.b1 ** opt.count)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** opt.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_add_(ps, m_hat, alpha=-self.lr)


@dataclasses.dataclass
class TrainState:
    g: Generator
    d: Discriminator
    g_opt: AdamState
    d_opt: AdamState
    g_ema: Optional[Generator] = None    # cfg.g_ema_decay > 0


class StepMetrics(NamedTuple):
    d_loss: torch.Tensor
    g_loss: torch.Tensor
    ade_sum: torch.Tensor    # sum of per-sample mean-over-time errors
    fde_sum: torch.Tensor    # sum of per-sample final-step errors
    n_samples: torch.Tensor


class StepDraws(NamedTuple):
    """Every random draw of one ``gan_step`` (train.py:471-473;
    socialways_tpu/engine/train_step.py:282-287, 428-443)."""
    noise: torch.Tensor                  # [N, noise_len], U(0, 1)
    zero_label: torch.Tensor             # scalar, U(0, 0.1)
    one_label: torch.Tensor              # scalar, U(0.9, 1.0)
    eps_fake: Optional[torch.Tensor] = None    # [N, n_next, 4], N(0, 1)
    eps_real: Optional[torch.Tensor] = None
    eps_g: Optional[torch.Tensor] = None


def eval_params(state: TrainState) -> Generator:
    """The generator to evaluate: the EMA shadow when tracked."""
    return state.g_ema if state.g_ema is not None else state.g


def make_optimizers(cfg: TrainConfig) -> Tuple[Adam, Adam]:
    """(G, D) optimizers: Adam with constant learning rates."""
    return (Adam(cfg.lr_g, cfg.adam_b1, cfg.adam_b2),
            Adam(cfg.lr_d, cfg.adam_b1, cfg.adam_b2))


def _ema_copy(g: Generator) -> Generator:
    ema = copy.deepcopy(g)
    ema.requires_grad_(False)
    return ema


def init_train_state(cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """G then D drawn from ``generator`` (a CPU ``torch.Generator``), moved
    to ``device`` (``None`` = ``cuda``); the EMA starts as a copy of G."""
    g = init_generator(cfg, generator, device)
    d = init_discriminator(cfg, generator, device)
    g_tx, d_tx = make_optimizers(cfg)
    return TrainState(g, d, g_tx.init(g), d_tx.init(d),
                      _ema_copy(g) if cfg.g_ema_decay > 0 else None)


def draw_step(n: int, cfg: TrainConfig,
              generator: Optional[torch.Generator] = None,
              device=None) -> StepDraws:
    """One step's draws from ``generator``; the eps tensors only when D
    instance noise is on."""
    noise = sample_noise(n, cfg.noise_len, generator, device)
    u = torch.rand(2, generator=generator, device=device)
    eps = [None] * 3
    if cfg.d_input_noise > 0:
        eps = list(torch.randn((3, n, cfg.n_next, 4), generator=generator,
                               device=device).unbind(0))
    return StepDraws(noise, 0.1 * u[0], 0.9 + 0.1 * u[1], *eps)


def instance_noise_sigma(cfg: TrainConfig, step0: int) -> Optional[float]:
    """The D instance-noise std at G step ``step0`` (None when off),
    computed in float32 as the JAX step does (:415-427)."""
    if cfg.d_input_noise <= 0:
        return None
    f32 = np.float32
    if cfg.d_input_noise_steps > 0:
        sigma = f32(cfg.d_input_noise) * max(
            f32(0.0), f32(1.0) - f32(step0) / f32(cfg.d_input_noise_steps))
        if cfg.d_input_noise_floor > 0:
            sigma = max(sigma, f32(cfg.d_input_noise_floor))
        return float(sigma)
    return cfg.d_input_noise


def _grads(loss: torch.Tensor, params: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros
    (JAX's value for it)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if gr is None else gr
            for p, gr in zip(params, grads)]


@torch.no_grad()
def _copy_params(dst: nn.Module, src: nn.Module) -> None:
    for a, b in zip(dst.parameters(), src.parameters()):
        a.copy_(b)


def gan_step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws, cfg: TrainConfig,
             n_valid: Optional[int] = None
             ) -> Tuple[TrainState, StepMetrics]:
    """One GAN update on a padded scene chunk, in place on ``state``.

    batch: obsvs [N, n_past, 2], preds [N, n_next, 2], scene_ids [N] int32,
    valid [N] bool.  ``n_valid`` (the chunk's valid count, known on the
    host from packing) saves a device round trip."""
    valid = batch["valid"]
    dev = valid.device
    if n_valid is None:
        n_valid = int(valid.sum())
    if n_valid == 0:
        zero = torch.zeros((), device=dev)
        return state, StepMetrics(zero, zero, zero, zero,
                                  torch.zeros((), dtype=torch.int64,
                                              device=dev))
    g_tx, d_tx = make_optimizers(cfg)
    obsv, frame, social_x4 = canonicalize_for_rollout(
        batch["obsvs"], cfg.agent_frame, cfg.use_social)
    pred = batch["preds"]
    if frame is not None:
        pred = to_agent_frame(pred, frame)
    n = obsv.shape[0]
    noise = draws.noise
    zeros_t = torch.zeros((n, 1), device=dev) + draws.zero_label
    ones_t = torch.ones((n, 1), device=dev) * draws.one_label
    obsv_4d, pred_4d = obsv_to_4d(obsv), pred_to_4d(obsv, pred)
    info = (cfg.use_info_loss, cfg.loss_info_w, cfg.n_latent_codes)

    # one rollout with its graph: the D phase reads it detached, the G
    # phase backpropagates through it once
    g_params = list(state.g.parameters())
    with torch.enable_grad():
        pred_hat = generator_rollout(state.g, obsv, noise, cfg.n_next,
                                     batch["scene_ids"], cfg.use_social,
                                     social_x4)

    # D instance noise on the prediction inputs (observations stay clean);
    # sigma from the G step count before this step's update
    sigma = instance_noise_sigma(cfg, state.g_opt.count)
    pred_hat_d, pred_4d_d = pred_hat.detach(), pred_4d
    if sigma is not None:
        pred_hat_d = pred_hat_d + sigma * draws.eps_fake
        pred_4d_d = pred_4d + sigma * draws.eps_real
    futures_d = torch.cat([pred_hat_d, pred_4d_d], dim=0)

    # D phase: n_unrolling_steps + 1 updates, snapshot after the first
    d_params = list(state.d.parameters())
    d_backup, d_loss_first = None, None
    for u in range(cfg.n_unrolling_steps + 1):
        with torch.enable_grad():
            labels, codes = discriminator_heads(
                state.d, encode_obsv(state.d, obsv_4d), futures_d)
            d_loss = lsgan_d_loss(labels[:n], labels[n:], codes[:n], noise,
                                  valid, zeros_t, ones_t, *info)
            d_grads = _grads(d_loss, d_params)
        d_tx.step(state.d_opt, state.d, d_grads)
        if u == 0:
            d_loss_first = d_loss.detach()
            if cfg.n_unrolling_steps > 0:
                d_backup = copy.deepcopy(state.d)

    # G phase against the unrolled D, through the saved rollout
    with torch.enable_grad():
        ph_in = pred_hat if sigma is None else pred_hat + sigma * draws.eps_g
        gen_label, gen_code = discriminator_apply(state.d, obsv_4d, ph_in)
        g_loss = lsgan_g_loss(gen_label, gen_code, noise, valid, ones_t,
                              *info)
        g_grads = _grads(g_loss, g_params)
    g_tx.step(state.g_opt, state.g, g_grads)

    if cfg.g_ema_decay > 0:
        with torch.no_grad():
            ema = list(state.g_ema.parameters())
            torch._foreach_mul_(ema, cfg.g_ema_decay)
            torch._foreach_add_(ema, g_params, alpha=1.0 - cfg.g_ema_decay)

    # restore D (unrolled-GAN bookkeeping); its optimizer keeps every update
    if d_backup is not None:
        if cfg.d_restore == "full":
            _copy_params(state.d, d_backup)
        elif cfg.d_restore == "reference":
            restore_linear_only(d_backup, state.d)

    with torch.no_grad():
        err = traj_errors(pred_hat.detach()[..., :2], pred)
        err = torch.where(valid[:, None], err, 0.0)
        metrics = StepMetrics(d_loss=d_loss_first, g_loss=g_loss.detach(),
                              ade_sum=err.sum() / cfg.n_next,
                              fde_sum=err[:, -1].sum(),
                              n_samples=valid.sum())
    return state, metrics
