"""The unrolled LSGAN + InfoGAN training step.

Counterpart of socialways_tpu/engine/train_step.py:49-171, 174-764 without a
mesh, in float32 or bf16 mixed precision: agent frame, social attention,
EMA generator, D instance noise annealed to a floor, ``n_unrolling_steps``
lookahead D updates with a configurable restore, the continuous or categorical info loss and its
ramp, lr schedules and a global-norm gradient clip, the LSTM decoder,
PacGAN, minibatch stddev, spectral norm, R1, the l2, variety, mode-seeking
and diversity-hinge losses, the D/G update-ratio schedule, the serial
rollout, step rematerialization and exact gradient accumulation.

The step, in JAX's order:
1. canonicalize to the agent frame, keeping the world-frame last states
   for the social geometry (:210-220);
2. the fake rollout (:376-405): by default ONE rollout with its autograd
   graph, which the D phase sees detached and the G phase backpropagates
   through once; a no-grad rollout for the D phase and a second one under
   grad in the G phase when a loss needs extra rollouts (variety, mode
   seeking, diversity hinge) or under ``serial_rollout``; a no-grad
   rollout per micro-chunk under ``grad_accum``;
3. D instance noise with sigma from the G optimizer's count BEFORE the
   update, annealed and floored (:407-443);
4. the D phase: ``n_unrolling_steps + 1`` Adam updates, D snapshotted after
   the first (:536-549), or, on a step the D/G ratio skips, only the
   forward loss of the current D (:551-576);
5. the G phase against the unrolled D with a fresh eps (:580-701);
6. the EMA of G (:705-710);
7. D restored by ``d_restore`` while its optimizer keeps every update
   (:712-718);
8. the metrics; ``d_loss`` is the first D update's loss (:720-729).

Mixed precision (``compute_dtype="bfloat16"``, JAX's cast points
:198-207, 295-308, 472-503, 588-594, 664-682): the observations, targets
and canonicalization stay float32; the rollout takes a bf16 view of G and
bf16 observations, noise and world-frame states, and its output returns
to float32; D takes a bf16 view (spectral norm on the float32 masters
first) and bf16 inputs, and its labels and codes return to float32 before
the losses.  Losses, the gradient clip, accumulation, Adam, the EMA and
R1's penalty stay float32, and so does every state tensor.  At float32
every cast is the identity (JAX's exact-parity path).

The extra rollouts of the G phase share one encode and one social pooling
and decode as K·N rows, as ``k_sample_rollout`` does: JAX's ``vmap`` over
the noise leaves that half unbatched, so the gradient is the same up to
float reassociation, and the step launches one social-attention forward
and one backward for them together.

State lives in modules updated in place.  Every random draw is an explicit
tensor in a ``StepDraws`` (torch cannot reproduce ``jax.random``; tests
feed JAX's draws in).  The schedules (info weight, instance noise, D/G
ratio) read the G optimizer's count on the host.  A chunk with no valid
row leaves the state as it is (:732-763), decided on the host from its
valid count.

Member mode (``members=True``, engine/ensemble.py): the state holds M
models stacked on a leading member axis (every parameter, moment and EMA
leaf [M, ...]; the optimizer counts shared host integers) and the draws
carry a leading M; the data is shared.  The same loss code runs under
``torch.func.vmap`` over the members (``models/stacked.py``: each stacked
module enters as its parameters, seen inside as one member's namespace),
the kernels launching once for all members (``_SocialAttention``'s vmap
rule); each gradient is one ``torch.autograd.grad`` of the sum of the
members' losses, outside ``vmap`` (members are independent, so the
gradient of the sum with respect to member m's slice is member m's
gradient); Adam, the clip (one norm per member) and the EMA run on the
stacked leaves.  The variants it does not batch yet (R1's gradient inside
the loss, the G phase's recomputed rollouts, accumulation, remat, bf16)
are refused there (``check_members_supported``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn

from socialways_torch.config import TrainConfig
from socialways_torch.engine.losses import (l2_traj_loss, lsgan_d_loss,
                                            lsgan_g_loss, sample_noise,
                                            traj_errors, variety_loss)
from socialways_torch.models.discriminator import (Discriminator,
                                                   discriminator_apply,
                                                   discriminator_heads,
                                                   encode_obsv,
                                                   init_discriminator,
                                                   mb_std_feature,
                                                   restore_linear_only,
                                                   spectral_normalize_d)
from socialways_torch.models.generator import (Generator, decode_rollout,
                                               generator_rollout,
                                               init_generator,
                                               prepare_rollout)
from socialways_torch.models.stacked import Members
from socialways_torch.ops.nn import cast_params
from socialways_torch.ops.traj import (canonicalize_for_rollout, obsv_to_4d,
                                       pred_to_4d, to_agent_frame)


@dataclasses.dataclass
class AdamState:
    """optax's state of ``adam(lr)``: ``ScaleByAdamState`` (the step count
    and the two moments, keyed by parameter name) and, when the lr is a
    schedule, ``ScaleByScheduleState``'s count (``schedule_count``; None
    for a constant lr, whose state is empty).  ``clipped``: the optimizer
    is ``chain(clip_by_global_norm, adam)``, whose (empty) clip state comes
    first and nests the Adam state one level deeper.  The counts are host
    integers: the schedules read them without a device round trip."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: Optional[int] = None
    clipped: bool = False


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``, eps outside
    the root.  ``lr`` is a constant or a schedule of the update count,
    which, as optax's ``scale_by_schedule``, reads the count BEFORE the
    update; the bias correction reads the count after it.  ``clip`` > 0
    puts optax's ``clip_by_global_norm(clip)`` before it."""
    lr: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = 0.0

    def init(self, params: nn.Module) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p)
                         for k, p in params.named_parameters()}
        return AdamState(0, zeros(), zeros(),
                         0 if callable(self.lr) else None, self.clip > 0)

    @torch.no_grad()
    def step(self, opt: AdamState, params: nn.Module,
             grads: Sequence[torch.Tensor], members: bool = False) -> None:
        """One update of ``params`` in place from ``grads`` (in
        ``parameters()`` order).  ``members``: every leaf is stacked on a
        leading member axis, and the clip takes one norm per member (the
        rest is elementwise)."""
        lr = self.lr
        if callable(lr):
            lr = lr(opt.schedule_count)
            opt.schedule_count += 1
        ps = list(params.parameters())
        mu, nu = list(opt.mu.values()), list(opt.nu.values())
        grads = list(grads)
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip, members)
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
        torch._foreach_add_(ps, m_hat, alpha=-lr)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        members: bool = False) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: every leaf times ``max_norm / g``
    when the norm ``g`` of all leaves together reaches ``max_norm``.  The
    test stays on the device.  ``members``: the leaves are stacked on a
    leading member axis, and each member's leaves take their own norm."""
    if not members:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < max_norm
        return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]
    g_norm = torch.sqrt(sum(torch.sum(g * g, dim=tuple(range(1, g.dim())))
                            for g in grads))
    out = []
    for g in grads:
        n = g_norm.reshape((-1,) + (1,) * (g.dim() - 1))
        out.append(torch.where(n < max_norm, g, (g / n) * max_norm))
    return out


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
    socialways_tpu/engine/train_step.py:233, 282-287, 428-443, 603-619)."""
    noise: torch.Tensor                  # [N, noise_len], sample_noise
    zero_label: torch.Tensor             # scalar, U(0, 0.1)
    one_label: torch.Tensor              # scalar, U(0.9, 1.0)
    eps_fake: Optional[torch.Tensor] = None    # [N, n_next, 4], N(0, 1)
    eps_real: Optional[torch.Tensor] = None
    eps_g: Optional[torch.Tensor] = None
    # [variety_k, N, noise_len]: JAX's draw_noise over split(k_var, K)
    variety_noise: Optional[torch.Tensor] = None
    # [max(1, ds_k - 1), N, noise_len]: draw_noise(fold_in(rng, 17 + j))
    extra_noise: Optional[torch.Tensor] = None


def eval_params(state: TrainState) -> Generator:
    """The generator to evaluate: the EMA shadow when tracked."""
    return state.g_ema if state.g_ema is not None else state.g


def lr_schedule(lr: float, decay_rate: float, decay_steps: int,
                warmup_steps: int) -> Union[float, Callable[[int], float]]:
    """``lr``, or JAX's schedule of it (socialways_tpu/engine/train_step.py:
    75-84): optax's staircase ``exponential_decay`` when ``decay_rate`` !=
    1 and ``decay_steps`` > 0, times the linear warmup ``min(1, (count +
    1) / warmup_steps)`` when ``warmup_steps`` > 0.  Computed in float32,
    as the JAX step computes it."""
    decay = decay_rate != 1.0 and decay_steps > 0
    if not decay and warmup_steps <= 0:
        return lr
    f32 = np.float32

    def schedule(count: int) -> float:
        v = f32(lr)
        # optax keeps a zero rate's schedule constant
        if decay and decay_rate != 0 and count > 0:
            p = np.floor(f32(count) / f32(decay_steps))
            v = f32(lr) * np.power(f32(decay_rate), p)
        if warmup_steps > 0:
            v = v * min(f32(1.0), (f32(count) + f32(1.0)) / f32(warmup_steps))
        return float(v)
    return schedule


def make_optimizers(cfg: TrainConfig) -> Tuple[Adam, Adam]:
    """(G, D) Adam optimizers with JAX's lr schedules; the D-only decay and
    warmup override the shared ones for D (:90-98)."""
    if cfg.d_lr_decay_steps > 0:
        d_decay = (cfg.d_lr_decay_rate, cfg.d_lr_decay_steps)
    else:
        d_decay = (cfg.lr_decay_rate, cfg.lr_decay_steps)
    d_warmup = cfg.d_lr_warmup_steps or cfg.lr_warmup_steps
    g_lr = lr_schedule(cfg.lr_g, cfg.lr_decay_rate, cfg.lr_decay_steps,
                       cfg.lr_warmup_steps)
    d_lr = lr_schedule(cfg.lr_d, *d_decay, d_warmup)
    return (Adam(g_lr, cfg.adam_b1, cfg.adam_b2, clip=cfg.grad_clip),
            Adam(d_lr, cfg.adam_b1, cfg.adam_b2, clip=cfg.grad_clip))


def transplant_schedule_clock(restored: TrainState,
                              clock: TrainState) -> TrainState:
    """``restored`` with every optimizer count (Adam's and the schedule's)
    taken from ``clock`` (socialways_tpu/engine/train_step.py:129-153).

    A checkpoint-restore rescue rewinds the counts and with them every
    count-keyed schedule (the instance-noise anneal, lr decay); with this
    transplant the rescue restores parameters and moments but keeps the
    schedules on the run's clock.  ``clock`` is only read: pass the state
    as it was before the restore."""
    def merge(r: AdamState, c: AdamState) -> AdamState:
        return dataclasses.replace(
            r, count=c.count,
            schedule_count=(c.schedule_count
                            if r.schedule_count is not None else None))
    return dataclasses.replace(restored,
                               g_opt=merge(restored.g_opt, clock.g_opt),
                               d_opt=merge(restored.d_opt, clock.d_opt))


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


def n_extra_draws(cfg: TrainConfig) -> int:
    """Extra noise draws the mode-seeking and diversity terms pair with the
    step's own (JAX's ``k_extra``)."""
    return max(1, cfg.ds_k - 1)


def draw_step(n: int, cfg: TrainConfig,
              generator: Optional[torch.Generator] = None,
              device=None) -> StepDraws:
    """One step's draws from ``generator``; the eps tensors only when D
    instance noise is on, the variety and extra noise only for the losses
    that decode them."""
    noise = sample_noise((n,), cfg, generator, device)
    u = torch.rand(2, generator=generator, device=device)
    eps = [None] * 3
    if cfg.d_input_noise > 0:
        eps = list(torch.randn((3, n, cfg.n_next, 4), generator=generator,
                               device=device).unbind(0))
    variety = extra = None
    if cfg.use_variety_loss:
        variety = sample_noise((cfg.variety_k, n), cfg, generator, device)
    if cfg.ms_weight > 0 or cfg.ds_weight > 0:
        extra = sample_noise((n_extra_draws(cfg), n), cfg, generator, device)
    return StepDraws(noise, 0.1 * u[0], 0.9 + 0.1 * u[1], *eps, variety,
                     extra)


def info_weight(cfg: TrainConfig, step: int) -> float:
    """The info-loss weight at G step ``step``: the ramp from
    ``loss_info_w`` to ``loss_info_w_end`` over ``loss_info_w_steps``
    steps, in float32 as the JAX step computes it (:291-300)."""
    if cfg.loss_info_w_end > 0 and cfg.loss_info_w_steps > 0:
        f32 = np.float32
        frac = min(f32(1.0), f32(step) / f32(cfg.loss_info_w_steps))
        return float(f32(cfg.loss_info_w)
                     + f32(cfg.loss_info_w_end - cfg.loss_info_w) * frac)
    return cfg.loss_info_w


def d_phase_due(cfg: TrainConfig, step: int) -> bool:
    """Whether the D phase runs at G step ``step``: every
    ``d_update_every``-th step, every ``d_update_every_end``-th from
    ``d_update_every_switch`` on (:551-569).  JAX decides it on the device
    (``lax.cond``); here it is a host branch on the host count."""
    scheduled = (cfg.d_update_every_end > 0 and cfg.d_update_every_switch > 0
                 and cfg.d_update_every_end != cfg.d_update_every)
    if cfg.d_update_every <= 1 and not scheduled:
        return True
    every = cfg.d_update_every
    if scheduled and step >= cfg.d_update_every_switch:
        every = cfg.d_update_every_end
    return step % every == 0


def check_rows(cfg: TrainConfig, n: int) -> None:
    """JAX's argument checks of a chunk of ``n`` rows (:223-224, 321-335)."""
    if cfg.pac > 1 and n % cfg.pac:
        raise ValueError(f"batch rows {n} not divisible by pac {cfg.pac}")
    if cfg.grad_accum <= 1:
        return
    if cfg.use_variety_loss:
        raise ValueError("grad_accum>1 does not support the variety "
                         "loss (each chunk would re-draw K rollouts)")
    if cfg.ms_weight > 0 or cfg.ds_weight > 0:
        raise ValueError("grad_accum>1 does not support the "
                         "mode-seeking/diversity-hinge losses (they "
                         "need a second rollout under grad)")
    if n % cfg.grad_accum:
        raise ValueError(f"batch rows {n} not divisible by "
                         f"grad_accum {cfg.grad_accum}")
    n_chunk = n // cfg.grad_accum
    if cfg.pac > 1 and n_chunk % cfg.pac:
        raise ValueError(f"micro-chunk rows {n_chunk} not divisible "
                         f"by pac {cfg.pac}")


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
    (JAX's value for it).  Member losses [M] are summed first: the members
    are independent, so each stacked parameter's slice m gets member m's
    gradient."""
    grads = torch.autograd.grad(loss if loss.dim() == 0 else loss.sum(),
                                params, allow_unused=True)
    return [torch.zeros_like(p) if gr is None else gr
            for p, gr in zip(params, grads)]


@torch.no_grad()
def _copy_params(dst: nn.Module, src: nn.Module) -> None:
    for a, b in zip(dst.parameters(), src.parameters()):
        a.copy_(b)


#: the members' own entries of a step's per-part tensors (the draws and what
#: is made from them); the rest is data every member shares
_MEMBER_KEYS = ("noise", "zeros", "ones", "pred_hat", "eps_g", "ph")

#: the variants member mode does not batch: a gradient inside the loss (R1),
#: a rollout recomputed under grad in the G phase (variety, mode seeking,
#: diversity, serial rollout), micro-chunk accumulation, checkpointed steps
#: (torch.utils.checkpoint under vmap) and bf16 compute
_MEMBERS_REFUSE = (("r1_gamma", lambda c: c.r1_gamma > 0),
                   ("use_variety_loss", lambda c: c.use_variety_loss),
                   ("ms_weight", lambda c: c.ms_weight > 0),
                   ("ds_weight", lambda c: c.ds_weight > 0),
                   ("serial_rollout", lambda c: c.serial_rollout),
                   ("grad_accum", lambda c: c.grad_accum > 1),
                   ("remat_steps", lambda c: c.remat_steps),
                   ("compute_dtype", lambda c: c.compute_dtype != "float32"))


def check_members_supported(cfg: TrainConfig) -> None:
    """Raise, naming the field, for a configuration member mode does not
    batch (ROADMAP Queue 1 lists each)."""
    for field, bad in _MEMBERS_REFUSE:
        if bad(cfg):
            raise ValueError(f"{field}={getattr(cfg, field)!r} is not "
                             "supported by the ensemble (member mode of "
                             "gan_step) yet")


def _pair_mean(t: torch.Tensor) -> torch.Tensor:
    """[K, n, ...] -> per-row mean |t_a - t_b| over all K(K-1)/2 pairs."""
    k, n = t.shape[0], t.shape[1]
    acc = 0.0
    for a in range(k):
        for b in range(a + 1, k):
            acc = acc + torch.abs(t[a] - t[b]).reshape(n, -1).mean(dim=-1)
    return acc / (k * (k - 1) // 2)


def _masked_mean(per: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return (torch.where(valid, per, 0.0).sum()
            / torch.clamp(valid.sum().float(), min=1.0))


def gan_step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws, cfg: TrainConfig,
             n_valid: Optional[int] = None, members: bool = False
             ) -> Tuple[TrainState, StepMetrics]:
    """One GAN update on a padded scene chunk, in place on ``state``.

    batch: obsvs [N, n_past, 2], preds [N, n_next, 2], scene_ids [N] int32,
    valid [N] bool.  ``n_valid`` (the chunk's valid count, known on the
    host from packing) saves a device round trip.  ``members``: ``state``
    and ``draws`` hold M stacked members (``stack_states``, draws with a
    leading M), the batch is shared, and every metric is [M]."""
    valid = batch["valid"]
    dev = valid.device
    if members:
        check_members_supported(cfg)
    vm = Members(draws.noise.shape[0] if members else None)
    if n_valid is None:
        n_valid = int(valid.sum())
    if n_valid == 0:
        zero = torch.zeros(vm.lead, device=dev)
        return state, StepMetrics(zero, zero, zero, zero,
                                  torch.zeros(vm.lead, dtype=torch.int64,
                                              device=dev))
    g_tx, d_tx = make_optimizers(cfg)
    obsv, frame, social_x4 = canonicalize_for_rollout(
        batch["obsvs"], cfg.agent_frame, cfg.use_social)
    pred = batch["preds"]
    if frame is not None:
        pred = to_agent_frame(pred, frame)
    n = obsv.shape[0]
    check_rows(cfg, n)
    scene_ids, noise = batch["scene_ids"], draws.noise
    rows = lambda label: label[..., None, None]    # [1, 1] or [M, 1, 1]
    zeros_t = torch.zeros((n, 1), device=dev) + rows(draws.zero_label)
    ones_t = torch.ones((n, 1), device=dev) * rows(draws.one_label)
    obsv_4d, pred_4d = obsv_to_4d(obsv), pred_to_4d(obsv, pred)
    step0 = state.g_opt.count
    info = (cfg.use_info_loss, info_weight(cfg, step0), cfg.n_latent_codes,
            cfg.latent_code_type)
    accum = cfg.grad_accum > 1
    diverse = cfg.ms_weight > 0 or cfg.ds_weight > 0
    separate = not accum and (cfg.use_variety_loss or cfg.serial_rollout
                              or diverse)

    def group_valid(v):
        """A pack counts only when all its rows are valid."""
        return v if cfg.pac == 1 else v.reshape(-1, cfg.pac).all(dim=1)

    def mb_feat(block, valid_):
        return mb_std_feature(block, valid_) if cfg.mb_std else None

    cdt = getattr(torch, cfg.compute_dtype)

    def cast(t):
        """JAX's ``cast``: a tensor or a model's weights in the compute
        dtype; the identity at float32."""
        if t is None or cdt == torch.float32:
            return t
        return t.to(cdt) if isinstance(t, torch.Tensor) else cast_params(
            t, cdt)

    def rollout_on(g, obsv_, z, sids, sx4):
        return generator_rollout(cast(g), cast(obsv_), cast(z),
                                 cfg.n_next, sids, cfg.use_social, cast(sx4),
                                 cfg.decoder, cfg.remat_steps,
                                 cfg.max_scene_size).float()

    # micro-chunks: the rows split into grad_accum equal scene-aligned parts
    rows = {"obsv": obsv, "obsv_4d": obsv_4d, "noise": noise,
            "scene_ids": scene_ids, "valid": valid, "zeros": zeros_t,
            "ones": ones_t, "pred": pred, "social_x4": social_x4}
    n_parts = cfg.grad_accum if accum else 1
    parts = [{k: None if v is None else v.chunk(n_parts)[a]
              for k, v in rows.items()} for a in range(n_parts)]

    # the fake rollout: with its graph (shared by both phases), or
    # forward-only for the D phase when the G phase recomputes it
    pred_hat = None
    if accum or separate:
        with torch.no_grad():
            pred_hat_fwd = torch.cat([
                rollout_on(state.g, c["obsv"], c["noise"], c["scene_ids"],
                           c["social_x4"]) for c in parts])
    else:
        with torch.enable_grad():
            pred_hat = vm(lambda g, z: rollout_on(g, obsv, z, scene_ids,
                                                  social_x4),
                          (state.g,), noise)
        pred_hat_fwd = pred_hat.detach()

    # D instance noise on the prediction inputs (observations stay clean);
    # sigma from the G step count before this step's update
    sigma = instance_noise_sigma(cfg, step0)
    pred_hat_d, pred_4d_d, eps_g = pred_hat_fwd, pred_4d, None
    if sigma is not None:
        pred_hat_d = pred_hat_d + sigma * draws.eps_fake
        pred_4d_d = pred_4d + sigma * draws.eps_real
        eps_g = draws.eps_g
    for k, v in (("pred_hat", pred_hat_d), ("pred_4d", pred_4d_d),
                 ("eps_g", eps_g)):
        for a, c in enumerate(parts):
            c[k] = None if v is None else v.chunk(n_parts)[a]
    # each part's loss is weighted by its share of the valid samples (info,
    # r1, l2) and of the valid packs (labels): their sums are the
    # full-batch masked means (:347-357)
    if accum:
        w_sample = (valid.reshape(n_parts, -1).sum(dim=1).float()
                    / torch.clamp(valid.sum(), min=1).float()).unbind(0)
        gv = group_valid(valid).reshape(n_parts, -1)
        w_pack = (gv.sum(dim=1).float()
                  / torch.clamp(gv.sum(), min=1).float()).unbind(0)
    else:
        w_sample = w_pack = (1.0,)

    sn = spectral_normalize_d if cfg.spectral_norm else (lambda p: p)
    member_keys = _MEMBER_KEYS + (() if sigma is None else ("pred_4d",))

    def on_members(fn, modules, c, *args):
        """``fn(*modules, c, *args)`` through ``vm``: the part's member
        entries per member, its data shared."""
        cm = {k: v for k, v in c.items() if k in member_keys and v is not None}
        return vm(lambda *a: fn(*a[:-1], {**c, **a[-1]}, *args), modules, cm)

    def d_part_loss(d, c, w_label, w_rest):
        """The D loss of one part (:469-509), at the current D ``d``."""
        dp = cast(sn(d))
        nn_ = c["obsv_4d"].shape[0]
        obsv_code = encode_obsv(dp, cast(c["obsv_4d"]), cfg.remat_steps)
        extra = None
        if cfg.mb_std:
            # one statistic per provenance block, fake and real apart
            extra = torch.cat([mb_feat(c["pred_hat"], c["valid"]),
                               mb_feat(c["pred_4d"], c["valid"])])
        labels, codes = discriminator_heads(
            dp, obsv_code, cast(torch.cat([c["pred_hat"], c["pred_4d"]])),
            cfg.pac, extra)
        labels, codes = labels.float(), codes.float()
        n_packs = nn_ // cfg.pac
        gv_c = group_valid(c["valid"])
        loss = lsgan_d_loss(labels[:n_packs], labels[n_packs:], codes[:nn_],
                            c["noise"], c["valid"], c["zeros"], c["ones"],
                            *info, label_valid=gv_c, w_label=w_label,
                            w_info=w_rest)
        if cfg.r1_gamma > 0:
            # R1: |d D(obsv, real) / d real|^2, differentiated again below
            p4 = c["pred_4d"].detach().requires_grad_(True)
            lbl, _ = discriminator_heads(dp, obsv_code, cast(p4), cfg.pac,
                                         mb_feat(p4, c["valid"]))
            (g_real,) = torch.autograd.grad((lbl.float()
                                             * gv_c[:, None]).sum(), p4,
                                            create_graph=True)
            per = (g_real.reshape(nn_, -1) ** 2).sum(dim=-1)
            r1 = (torch.where(c["valid"], per, 0.0).sum()
                  / torch.clamp(c["valid"].sum(), min=1))
            loss = loss + w_rest * 0.5 * cfg.r1_gamma * r1
        return loss

    d_params = list(state.d.parameters())

    def d_value_and_grad(with_grads: bool = True):
        """(loss, grads) summed over the parts; grads None when not
        asked for."""
        total, grads = None, None
        graph = with_grads or cfg.r1_gamma > 0
        with torch.enable_grad() if graph else torch.no_grad():
            for c, wp, ws in zip(parts, w_pack, w_sample):
                loss = on_members(d_part_loss, (state.d,), c, wp, ws)
                total = loss.detach() if total is None else (
                    total + loss.detach())
                if with_grads:
                    g = _grads(loss, d_params)
                    grads = g if grads is None else [
                        a + b for a, b in zip(grads, g)]
        return total, grads

    # D phase: n_unrolling_steps + 1 updates, snapshot after the first; a
    # step the D/G ratio skips leaves D and its optimizer as they are
    d_backup = None
    if d_phase_due(cfg, step0):
        for u in range(cfg.n_unrolling_steps + 1):
            d_loss, d_grads = d_value_and_grad()
            d_tx.step(state.d_opt, state.d, d_grads, members)
            if u == 0:
                d_loss_first = d_loss
                if cfg.n_unrolling_steps > 0:
                    d_backup = copy.deepcopy(state.d)
    else:
        d_loss_first, _ = d_value_and_grad(with_grads=False)

    # G phase against the unrolled D, normalized once (per member)
    def sn_const(d):
        with torch.no_grad():
            return sn(d)
    d_g = vm.defer(sn_const, state.d)

    def g_part_loss(d_g, c, w_label, w_info):
        """The G loss of one part against D (:583-601, 664-682), of the
        part's rollout ``c["ph"]`` under grad."""
        ph = c["ph"]
        ph_in = ph if c["eps_g"] is None else ph + sigma * c["eps_g"]
        gen_label, gen_code = discriminator_apply(
            cast(d_g), cast(c["obsv_4d"]), cast(ph_in), cfg.remat_steps,
            cfg.pac, mb_feat(ph_in, c["valid"]))
        loss = lsgan_g_loss(gen_label.float(), gen_code.float(), c["noise"],
                            c["valid"], c["ones"], *info,
                            label_valid=group_valid(c["valid"]),
                            w_label=w_label, w_info=w_info)
        if cfg.use_l2_loss:
            loss = loss + w_info * cfg.loss_l2_w * l2_traj_loss(
                ph[..., :2], c["pred"], c["valid"])
        return loss

    g_params = list(state.g.parameters())
    with torch.enable_grad():
        if accum:
            g_loss, g_grads = None, None
            for c, wp, ws in zip(parts, w_pack, w_sample):
                ph = rollout_on(state.g, c["obsv"], c["noise"],
                                c["scene_ids"], c["social_x4"])
                loss = g_part_loss(d_g, {**c, "ph": ph}, wp, ws)
                g_loss = loss.detach() if g_loss is None else (
                    g_loss + loss.detach())
                g = _grads(loss, g_params)
                g_grads = g if g_grads is None else [
                    a + b for a, b in zip(g_grads, g)]
            pred_hat = pred_hat_fwd
        elif not separate:
            g_loss = on_members(g_part_loss, (d_g,),
                                {**parts[0], "ph": pred_hat}, 1.0, 1.0)
            g_grads = _grads(g_loss, g_params)
        else:
            # recompute under grad: encode and pool once, decode the step's
            # noise and every extra draw as rows of one batch
            noises = [noise[None]]
            if cfg.use_variety_loss:
                noises.append(draws.variety_noise)
            if diverse:
                noises.append(draws.extra_noise)
            z = torch.cat(noises)
            r = z.shape[0]
            g_view = cast(state.g)
            prep = prepare_rollout(g_view, cast(obsv), scene_ids,
                                   cfg.use_social, cast(social_x4),
                                   cfg.remat_steps, cfg.max_scene_size)
            out = decode_rollout(g_view, tuple(t.repeat(r, 1) for t in prep),
                                 cast(z.reshape(r * n, -1)), cfg.n_next,
                                 cfg.decoder, cfg.remat_steps)
            out = out.float().reshape(r, n, cfg.n_next, 4)
            pred_hat = out[0]
            g_loss = g_part_loss(d_g, {**parts[0], "ph": pred_hat}, 1.0, 1.0)
            first = 1
            if cfg.use_variety_loss:
                first += cfg.variety_k
                g_loss = g_loss + cfg.loss_l2_w * variety_loss(
                    out[1:first, ..., :2], pred, valid)
            if diverse:
                # pairs of the step's draw and the extra ones (:609-661)
                d_row = _pair_mean(out[[0] + list(range(first, r)), ..., :2])
                dz_row = _pair_mean(torch.cat([noise[None],
                                               draws.extra_noise]))
                if cfg.ms_weight > 0:
                    ratio = (_masked_mean(d_row, valid)
                             / (_masked_mean(dz_row, valid) + 1e-8))
                    g_loss = g_loss + cfg.ms_weight / (ratio + 1e-5)
                if cfg.ds_weight > 0:
                    hinge = torch.clamp(cfg.ds_tau - d_row / (dz_row + 1e-8),
                                        min=0.0)
                    g_loss = g_loss + cfg.ds_weight * _masked_mean(hinge,
                                                                   valid)
            g_grads = _grads(g_loss, g_params)
    g_tx.step(state.g_opt, state.g, g_grads, members)

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

    def errors(ph):
        err = traj_errors(ph[..., :2], pred)
        err = torch.where(valid[:, None], err, 0.0)
        return err.sum() / cfg.n_next, err[:, -1].sum(), valid.sum()

    with torch.no_grad():
        ade_sum, fde_sum, n_samples = vm(errors, (), pred_hat.detach())
        metrics = StepMetrics(d_loss=d_loss_first, g_loss=g_loss.detach(),
                              ade_sum=ade_sum, fde_sum=fde_sum,
                              n_samples=n_samples)
    return state, metrics
