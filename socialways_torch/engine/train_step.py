"""The unrolled LSGAN + InfoGAN training step.

Counterpart of socialways_tpu/engine/train_step.py:49-171, 174-764, in
float32 or bf16 mixed precision, on one device or data-parallel over a
mesh: agent frame, social attention, EMA generator, D instance noise
annealed to a floor, ``n_unrolling_steps`` lookahead D updates with a
configurable restore, the continuous or categorical info loss and its
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
feed JAX's draws in).  The step's clock is on the device, as optax's is:
the optimizer counts are int32 tensors, and the lr schedules, the info
weight and the instance-noise sigma are float32 tensors computed from them
(JAX's formulas), so a CUDA graph of the step (engine/graphed.py) replays
it at any count.  The one host decision on the count is the solo D/G
ratio (JAX's ``lax.cond``): the caller passes the G count it knows
(``g_count``; the trainer reads it once an epoch), else the step reads it.
A chunk with no valid row leaves the state as it is (:732-763), decided
on the host from its valid count.

Data parallelism (``mesh``, parallel/mesh.py; JAX's ``axis_name``
branches): each rank holds whole scenes and the draws of the GLOBAL batch,
of which it keeps its rows (``shard_draws``, :234-245, 428-437).  Each
gradient sync weights the rank's gradients by its share of the valid rows,
``local * D / max(global, 1)`` (float32, computed on the device from the
counts, so that a captured step replays any group's), and averages them
over the ranks in one all-reduce of one flattened buffer (:266-279).  Under ``mb_std``,
``ms_weight`` or ``ds_weight`` the rank's LOSS carries that weight
instead, since those losses couple the ranks through sums over the mesh
(``parallel.mesh.psum``, whose backward sums every rank's cotangent, as
the transpose of JAX's psum does; :247-264, 638-661).  The metrics come
back reduced (:734-757).  The step is a no-op only when every rank's chunk
is padding (:758-763): a rank whose chunk is filler still runs every
collective.  The counts stay equal on every rank, since every rank
takes every step.

Member mode (``members=True``, engine/ensemble.py): the state holds M
models stacked on a leading member axis (every parameter, moment and EMA
leaf [M, ...], every optimizer count [M]) and the draws carry a leading
M; the data is shared.  Each member's schedules, sigma and info weight
follow its own count; under a D/G ratio the D phase runs for all and each
member keeps its update only where its count makes the phase due (what
JAX's ``vmap`` of ``lax.cond`` lowers to).  The same loss code runs under
``torch.func.vmap`` over the members (``models/stacked.py``: each stacked
module enters as its parameters, seen inside as one member's namespace),
the kernels launching once for all members (``_SocialAttention``'s vmap
rule); each gradient is one ``torch.autograd.grad`` of the sum of the
members' losses, outside ``vmap`` (members are independent, so the
gradient of the sum with respect to member m's slice is member m's
gradient); Adam, the clip (one norm per member) and the EMA run on the
stacked leaves.  Every configuration of the solo step runs so: R1's
input gradient is a ``torch.func.grad`` inside the mapped loss (the
penalty's gradient then reaches the stacked parameters outside, as every
loss does); the G phase's recomputed rollouts, the micro-chunks of
``grad_accum`` and the D phase's no-grad rollouts map over the members
like the shared rollout (the micro-chunks split each member's draws along
their rows); ``remat_steps`` recomputes each mapped step once for all
members (``ops.lstm.remat_call``); bf16 casts each member's view.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import weakref
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

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
from socialways_torch.parallel.mesh import all_reduce_sum, psum
from socialways_torch.utils.profiling import phase, span


@dataclasses.dataclass
class AdamState:
    """optax's state of ``adam(lr)``: ``ScaleByAdamState`` (the step count
    and the two moments, keyed by parameter name) and, when the lr is a
    schedule, ``ScaleByScheduleState``'s count (``schedule_count``; None
    for a constant lr, whose state is empty).  ``clipped``: the optimizer
    is ``chain(clip_by_global_norm, adam)``, whose (empty) clip state comes
    first and nests the Adam state one level deeper.  The counts are int32
    tensors on the parameters' device, [] or [M] for stacked members, as
    optax's are: the step updates and reads them on the device."""
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: Optional[torch.Tensor] = None
    clipped: bool = False

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state: the moments and the counts."""
        out = [*self.mu.values(), *self.nu.values(), self.count]
        return out + ([] if self.schedule_count is None
                      else [self.schedule_count])


def _count_tensor(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _per_leaf(t: Union[float, torch.Tensor], leaves: Sequence[torch.Tensor]):
    """A per-optimizer scalar (a float, a [] tensor or, for members, an [M]
    tensor) as a foreach operand of ``leaves``: members' [M] values
    broadcast along each leaf's leading axis."""
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    return [t.view((-1,) + (1,) * (x.dim() - 1)) for x in leaves]


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``, eps outside
    the root.  ``lr`` is a constant or a schedule of the update count,
    which, as optax's ``scale_by_schedule``, reads the count BEFORE the
    update; the bias correction ``1 - b**count`` (float32, optax's) reads
    the count after it.  ``clip`` > 0 puts optax's
    ``clip_by_global_norm(clip)`` before it."""
    lr: Union[float, Callable]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = 0.0

    def init(self, params: nn.Module) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p)
                         for k, p in params.named_parameters()}
        dev = next(params.parameters()).device
        return AdamState(_count_tensor(dev), zeros(), zeros(),
                         _count_tensor(dev) if callable(self.lr) else None,
                         self.clip > 0)

    @torch.no_grad()
    def step(self, opt: AdamState, params: nn.Module,
             grads: Sequence[torch.Tensor], members: bool = False) -> None:
        """One update of ``params`` in place from ``grads`` (in
        ``parameters()`` order), the counts advanced in place.  Nothing is
        read on the host.  ``members``: every leaf is stacked on a leading
        member axis, each member with its own counts, and the clip takes
        one norm per member (the rest is elementwise)."""
        ps = list(params.parameters())
        mu, nu = list(opt.mu.values()), list(opt.nu.values())
        grads = list(grads)
        lr = self.lr
        if callable(lr):
            lr = lr(opt.schedule_count)
            opt.schedule_count.add_(1)
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip, members)
        opt.count.add_(1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count = opt.count.float()
        m_hat = torch._foreach_div(mu, _per_leaf(1.0 - _pow32(self.b1, count),
                                                 mu))
        denom = torch._foreach_div(nu, _per_leaf(1.0 - _pow32(self.b2, count),
                                                 nu))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        # optax's scale_by_learning_rate, then apply_updates
        torch._foreach_mul_(m_hat, _per_leaf(-lr, m_hat))
        torch._foreach_add_(ps, m_hat)


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


def _on_device(fn: Callable) -> Callable:
    """``fn`` of a count tensor (int32, [] or [M]) -> float32 tensor, also
    taking a host int and then returning a Python float (the same float32
    value)."""
    @functools.wraps(fn)
    def call(*args):
        count = args[-1]
        if isinstance(count, torch.Tensor):
            return fn(*args)
        return float(fn(*args[:-1], torch.tensor(count, dtype=torch.int32)))
    return call


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 tensor on ``like``'s device, made there (a
    fill, which a CUDA graph captures).  A divisor is a tensor: torch
    divides by a Python scalar as a product with its reciprocal, not as
    the correctly rounded quotient XLA computes."""
    return torch.full(like.shape, value, dtype=torch.float32,
                      device=like.device)


def _pow32(base: float, p: torch.Tensor) -> torch.Tensor:
    """float32 ``base ** p`` for float32 ``p`` (``base`` rounded to float32
    first, as JAX's weak scalar), computed in float64 and
    rounded once.  XLA's float32 power, which the JAX step's optax calls,
    equals it on all but about 0.1 % of (base, p) pairs (there by one
    ulp), where torch's float32 ``pow`` misses on about 4 %."""
    return torch.pow(_f32(base, p).double(), p.double()).float()


def lr_schedule(lr: float, decay_rate: float, decay_steps: int,
                warmup_steps: int) -> Union[float, Callable]:
    """``lr``, or JAX's schedule of it (socialways_tpu/engine/train_step.py:
    75-84): optax's staircase ``exponential_decay`` when ``decay_rate`` !=
    1 and ``decay_steps`` > 0, times the linear warmup ``min(1, (count +
    1) / warmup_steps)`` when ``warmup_steps`` > 0.  The schedule maps a
    count tensor to the float32 lr tensor, as optax computes it on the
    device (a host int gives a float)."""
    decay = decay_rate != 1.0 and decay_steps > 0
    if not decay and warmup_steps <= 0:
        return lr

    @_on_device
    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        v = _f32(lr, c)
        # optax keeps a zero rate's schedule constant
        if decay and decay_rate != 0:
            p = torch.floor(c / _f32(decay_steps, c))
            v = torch.where(count > 0,
                            lr * _pow32(decay_rate, p), v)
        if warmup_steps > 0:
            v = v * torch.clamp((c + 1.0) / _f32(warmup_steps, c), max=1.0)
        return v
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
    copied from ``clock`` (socialways_tpu/engine/train_step.py:129-153).

    A checkpoint-restore rescue rewinds the counts and with them every
    count-keyed schedule (the instance-noise anneal, lr decay); with this
    transplant the rescue restores parameters and moments but keeps the
    schedules on the run's clock.  Neither input changes: the result's
    counts are copies of ``clock``'s."""
    def merge(r: AdamState, c: AdamState) -> AdamState:
        return dataclasses.replace(
            r, count=c.count.clone(),
            schedule_count=(c.schedule_count.clone()
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


def stack_draws(draws: Sequence[StepDraws]) -> StepDraws:
    """Step draws stacked on a new leading axis: the members' draws of a
    step, or an epoch's draws of its steps."""
    return StepDraws(*(None if f[0] is None else torch.stack(f)
                       for f in zip(*draws)))


def shard_draws(draws: StepDraws, rank: int, n_ranks: int) -> StepDraws:
    """Rank ``rank``'s rows of a global batch's draws, the batch split into
    ``n_ranks`` equal parts in rank order: the noise and the eps tensors on
    their row axis, the variety and extra noise (a leading K) on axis 1;
    the two label scalars are shared."""
    def rows(t, dim):
        if t is None:
            return None
        n = t.shape[dim] // n_ranks
        return t.narrow(dim, rank * n, n)
    return StepDraws(rows(draws.noise, 0), draws.zero_label,
                     draws.one_label, rows(draws.eps_fake, 0),
                     rows(draws.eps_real, 0), rows(draws.eps_g, 0),
                     rows(draws.variety_noise, 1), rows(draws.extra_noise, 1))


def info_weight(cfg: TrainConfig, step):
    """The info-loss weight at G step ``step`` (the G count: a tensor, or
    a host int): the ramp from ``loss_info_w`` to ``loss_info_w_end`` over
    ``loss_info_w_steps`` steps, a float32 tensor as the JAX step computes
    it (:291-300); without a ramp the constant."""
    if cfg.loss_info_w_end > 0 and cfg.loss_info_w_steps > 0:
        return _info_ramp(cfg, step)
    return cfg.loss_info_w


@_on_device
def _info_ramp(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    frac = torch.clamp(s / _f32(cfg.loss_info_w_steps, s), max=1.0)
    return cfg.loss_info_w + (cfg.loss_info_w_end - cfg.loss_info_w) * frac


def d_ratio_on(cfg: TrainConfig) -> bool:
    """Whether the D/G update ratio can skip a D phase (:551-557)."""
    return cfg.d_update_every > 1 or _ratio_scheduled(cfg)


def _ratio_scheduled(cfg: TrainConfig) -> bool:
    return (cfg.d_update_every_end > 0 and cfg.d_update_every_switch > 0
            and cfg.d_update_every_end != cfg.d_update_every)


def d_phase_due(cfg: TrainConfig, step):
    """Whether the D phase runs at G step ``step``: every
    ``d_update_every``-th step, every ``d_update_every_end``-th from
    ``d_update_every_switch`` on (:551-569).  A host int gives a bool; a
    count tensor gives a bool tensor of its shape (JAX's ``lax.cond``
    predicate)."""
    if not d_ratio_on(cfg):
        return (True if not isinstance(step, torch.Tensor)
                else torch.ones_like(step, dtype=torch.bool))
    every, end = cfg.d_update_every, cfg.d_update_every_end
    if isinstance(step, torch.Tensor):
        if _ratio_scheduled(cfg):
            every = torch.where(step < cfg.d_update_every_switch,
                                every, end).to(step.dtype)
        return step % every == 0
    if _ratio_scheduled(cfg) and step >= cfg.d_update_every_switch:
        every = end
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


def instance_noise_sigma(cfg: TrainConfig, step0):
    """The D instance-noise std at G step ``step0`` (the G count: a
    tensor, or a host int; None when off): annealed and floored, a float32
    tensor as the JAX step computes it (:415-427); unannealed the
    constant."""
    if cfg.d_input_noise <= 0:
        return None
    if cfg.d_input_noise_steps > 0:
        return _annealed_sigma(cfg, step0)
    return cfg.d_input_noise


@_on_device
def _annealed_sigma(cfg: TrainConfig, step0: torch.Tensor) -> torch.Tensor:
    s = step0.float()
    sigma = cfg.d_input_noise * torch.clamp(
        1.0 - s / _f32(cfg.d_input_noise_steps, s), min=0.0)
    if cfg.d_input_noise_floor > 0:
        sigma = torch.clamp(sigma, min=cfg.d_input_noise_floor)
    return sigma


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
    torch._foreach_copy_(list(dst.parameters()), list(src.parameters()))


#: each discriminator's unroll backup, allocated at its first snapshot
_BACKUPS: "weakref.WeakKeyDictionary[nn.Module, nn.Module]" = (
    weakref.WeakKeyDictionary())


def _backup_of(d: nn.Module) -> nn.Module:
    """The module ``d``'s snapshot is copied into (same structure)."""
    backup = _BACKUPS.get(d)
    if backup is None:
        backup = _BACKUPS[d] = copy.deepcopy(d).requires_grad_(False)
    return backup


@torch.no_grad()
def _select_members(due: torch.Tensor, out: Sequence[torch.Tensor],
                    if_due: Sequence[torch.Tensor],
                    if_not: Sequence[torch.Tensor]) -> None:
    """``out[i]`` = member-wise ``if_due[i]`` where ``due`` [M], else
    ``if_not[i]``, in place (every tensor with a leading M)."""
    torch._foreach_copy_(list(out), [
        torch.where(due.view((-1,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(if_due, if_not)])


#: the members' own entries of a step's per-part tensors (the draws and what
#: is made from them); the rest is data every member shares
_MEMBER_KEYS = ("noise", "zeros", "ones", "pred_hat", "eps_g", "ph",
                "variety", "extra")


def _pair_mean(t: torch.Tensor) -> torch.Tensor:
    """[K, n, ...] -> per-row mean |t_a - t_b| over all K(K-1)/2 pairs."""
    k, n = t.shape[0], t.shape[1]
    acc = 0.0
    for a in range(k):
        for b in range(a + 1, k):
            acc = acc + torch.abs(t[a] - t[b]).reshape(n, -1).mean(dim=-1)
    return acc / (k * (k - 1) // 2)


def _masked_mean(per: torch.Tensor, valid: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """The mean of ``per`` over the valid rows (of every rank, with a
    mesh)."""
    return (psum(torch.where(valid, per, 0.0).sum(), mesh)
            / torch.clamp(psum(valid.sum().float(), mesh), min=1.0))


class _DataParallel:
    """The DP step's weights and its gradient and metric reductions over
    ``mesh``, from the rank's and the group's valid counts (0-dim int
    tensors on the step's device: the weights are device values, so a
    captured step reads each group's counts at its replay).
    ``coupled``: a loss sums over the mesh (mb_std, mode seeking,
    diversity hinge), so the loss carries the rank's weight and the
    gradients are plainly averaged (JAX's ``_shard_weight``)."""

    def __init__(self, mesh, cfg: TrainConfig, n_valid: torch.Tensor,
                 n_valid_global: torch.Tensor):
        self.mesh = mesh
        self.coupled = cfg.mb_std or cfg.ms_weight > 0 or cfg.ds_weight > 0
        local = n_valid.float()
        total = torch.clamp(n_valid_global.float(), min=1.0)
        # the rank's share of the valid rows, times D, in float32 (:274-277)
        self.weight = local * float(mesh.size) / total
        # the metrics' weight and divisor (:734-757)
        self.w, self.div = ((1.0, float(mesh.size)) if self.coupled
                            else (local, total))

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.weight if self.coupled else loss

    def grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """pmean of the count-weighted gradients: one all-reduce."""
        if not self.coupled:
            grads = torch._foreach_mul(grads, self.weight)
        return torch._foreach_div(all_reduce_sum(grads, self.mesh),
                                  float(self.mesh.size))

    def metrics(self, m: StepMetrics) -> StepMetrics:
        """Losses as JAX averages them (the global masked mean), errors and
        counts summed (:734-757): one all-reduce."""
        d, g, ade, fde, n = all_reduce_sum(
            [torch.stack([m.d_loss * self.w, m.g_loss * self.w, m.ade_sum,
                          m.fde_sum, m.n_samples.to(m.ade_sum.dtype)])],
            self.mesh)[0].unbind(0)
        return StepMetrics(d / self.div, g / self.div, ade, fde,
                           n.round().to(m.n_samples.dtype))


#: a training step's phases, in order: device stamps at their 5
#: boundaries, captured into the step's CUDA graph (utils/profiling.py)
STEP_PHASES = ("rollout", "d_update", "g_update", "finish")


def _count(n, device) -> torch.Tensor:
    """A valid count as a 0-dim tensor on ``device`` (a host int is copied
    there: the eager step's form of the runner's device counts)."""
    return (n if isinstance(n, torch.Tensor)
            else torch.tensor(n, dtype=torch.int64, device=device))


def gan_step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: StepDraws, cfg: TrainConfig,
             n_valid: Optional[Union[int, torch.Tensor]] = None,
             members: bool = False, mesh=None,
             n_valid_global: Optional[Union[int, torch.Tensor]] = None,
             g_count: Optional[int] = None
             ) -> Tuple[TrainState, StepMetrics]:
    """One GAN update on a padded scene chunk, in place on ``state``.

    batch: obsvs [N, n_past, 2], preds [N, n_next, 2], scene_ids [N] int32,
    valid [N] bool.  ``n_valid`` (the chunk's valid count, known on the
    host from packing) saves a device round trip.  ``members``: ``state``
    and ``draws`` hold M stacked members (``stack_states``, draws with a
    leading M), the batch is shared, and every metric is [M].  ``mesh``
    (``parallel.Mesh``): this rank's chunk of a data-parallel step, with
    the GLOBAL batch's ``draws``; ``n_valid_global`` (the group's valid
    count, from packing) saves an all-reduce, and every metric comes back
    reduced over the mesh.  Under a mesh both counts may be 0-dim int
    tensors on the device (the graphed epoch's, selected by its step
    index): the weights are computed from them on the device, and a
    device count is the caller's word that the group has a valid row (the
    no-op of an all-padding group is decided on the host, from packing).
    ``g_count``: the G count before this step as
    the caller knows it on the host; the solo D/G ratio branches on it
    (None reads the device count, a host sync).  Otherwise nothing of the
    step is read on the host."""
    with span("train.step", unit=True, phases=STEP_PHASES,
              device=batch["valid"].device, graphed=True):
        return _gan_step(state, batch, draws, cfg, n_valid, members, mesh,
                         n_valid_global, g_count)


def _gan_step(state, batch, draws, cfg, n_valid, members, mesh,
              n_valid_global, g_count):
    phase("rollout")
    valid = batch["valid"]
    dev = valid.device
    vm = Members(draws.noise.shape[0] if members else None)
    if n_valid is None:
        n_valid = int(valid.sum())
    dp = None
    if mesh is not None:
        if members:
            raise ValueError("a member step takes no mesh: "
                             "EnsembleTrainer(mesh=) shards the members")
        draws = shard_draws(draws, mesh.rank, mesh.size)
        if n_valid_global is None:
            n_valid_global = int(all_reduce_sum(
                [_count(n_valid, dev).reshape(1)], mesh)[0])
        dp = _DataParallel(mesh, cfg, _count(n_valid, dev),
                           _count(n_valid_global, dev))
    total = n_valid if dp is None else n_valid_global
    if not isinstance(total, torch.Tensor) and total == 0:
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
    # the schedules from the G count before this step's update, on the
    # device; members' [M] values enter each member's call as its own
    step0 = state.g_opt.count
    scalars = {"info_w": info_weight(cfg, step0),
               # D instance noise on the prediction inputs (observations
               # stay clean)
               "sigma": instance_noise_sigma(cfg, step0)}
    sigma = scalars["sigma"]

    def info(c):
        return (cfg.use_info_loss, c["info_w"], cfg.n_latent_codes,
                cfg.latent_code_type)
    accum = cfg.grad_accum > 1
    diverse = cfg.ms_weight > 0 or cfg.ds_weight > 0
    separate = not accum and (cfg.use_variety_loss or cfg.serial_rollout
                              or diverse)

    def group_valid(v):
        """A pack counts only when all its rows are valid."""
        return v if cfg.pac == 1 else v.reshape(-1, cfg.pac).all(dim=1)

    def mb_feat(block, valid_):
        return mb_std_feature(block, valid_, mesh) if cfg.mb_std else None

    def weighted(loss):
        """The loss a rank differentiates (its DP share when coupled)."""
        return loss if dp is None else dp.loss(loss)

    def synced(grads):
        return grads if dp is None else dp.grads(grads)

    cdt = getattr(torch, cfg.compute_dtype)

    def cast(t):
        """JAX's ``cast``: a tensor or a model's weights in the compute
        dtype; the identity at float32."""
        if t is None or cdt == torch.float32:
            return t
        return t.to(cdt) if isinstance(t, torch.Tensor) else cast_params(
            t, cdt)

    def rollout_on(g, c):
        """The part ``c``'s rollout by G ``g`` under its noise."""
        return generator_rollout(cast(g), cast(c["obsv"]), cast(c["noise"]),
                                 cfg.n_next, c["scene_ids"], cfg.use_social,
                                 cast(c["social_x4"]), cfg.decoder,
                                 cfg.remat_steps, cfg.max_scene_size).float()

    member_keys = _MEMBER_KEYS + (() if sigma is None else ("pred_4d",))
    member_keys += tuple(k for k, v in scalars.items()
                         if isinstance(v, torch.Tensor))
    n_parts = cfg.grad_accum if accum else 1

    def split(key, v):
        """``v`` in ``n_parts`` row chunks (a member entry's rows follow
        its member axis)."""
        if v is None:
            return [None] * n_parts
        return v.chunk(n_parts, dim=len(vm.lead) if key in member_keys else 0)

    # micro-chunks: the rows split into grad_accum equal scene-aligned parts
    rows = {"obsv": obsv, "obsv_4d": obsv_4d, "noise": noise,
            "scene_ids": scene_ids, "valid": valid, "zeros": zeros_t,
            "ones": ones_t, "pred": pred, "social_x4": social_x4}
    parts = [dict(scalars) for _ in range(n_parts)]
    for k, v in rows.items():
        for c, part in zip(parts, split(k, v)):
            c[k] = part

    def on_members(fn, modules, c, *args):
        """``fn(*modules, c, *args)`` through ``vm``: the part's member
        entries per member, its data shared."""
        cm = {k: v for k, v in c.items() if k in member_keys and v is not None}
        return vm(lambda *a: fn(*a[:-1], {**c, **a[-1]}, *args), modules, cm)

    # the fake rollout: with its graph (shared by both phases), or
    # forward-only for the D phase when the G phase recomputes it
    pred_hat = None
    if accum or separate:
        with torch.no_grad():
            pred_hat_fwd = torch.cat([on_members(rollout_on, (state.g,), c)
                                      for c in parts], dim=len(vm.lead))
    else:
        with torch.enable_grad():
            pred_hat = on_members(rollout_on, (state.g,), parts[0])
        pred_hat_fwd = pred_hat.detach()

    pred_hat_d, pred_4d_d, eps_g = pred_hat_fwd, pred_4d, None
    if sigma is not None:
        s = sigma.view(-1, 1, 1, 1) if members and isinstance(
            sigma, torch.Tensor) else sigma
        pred_hat_d = pred_hat_d + s * draws.eps_fake
        pred_4d_d = pred_4d + s * draws.eps_real
        eps_g = draws.eps_g
    for k, v in (("pred_hat", pred_hat_d), ("pred_4d", pred_4d_d),
                 ("eps_g", eps_g)):
        for c, part in zip(parts, split(k, v)):
            c[k] = part
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
                            *info(c), label_valid=gv_c, w_label=w_label,
                            w_info=w_rest)
        if cfg.r1_gamma > 0:
            # R1: |d D(obsv, real) / d real|^2, a function of D that the
            # step's gradient differentiates again; torch.func.grad, so
            # that it also runs per member under vmap
            def real_labels(p4):
                lbl, _ = discriminator_heads(dp, obsv_code, cast(p4),
                                             cfg.pac, mb_feat(p4, c["valid"]))
                return (lbl.float() * gv_c[:, None]).sum()
            g_real = torch.func.grad(real_labels)(c["pred_4d"].detach())
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
                loss = weighted(on_members(d_part_loss, (state.d,), c, wp,
                                           ws))
                total = loss.detach() if total is None else (
                    total + loss.detach())
                if with_grads:
                    g = _grads(loss, d_params)
                    grads = g if grads is None else [
                        a + b for a, b in zip(grads, g)]
        return total, grads

    phase("d_update")
    # D phase: n_unrolling_steps + 1 updates, snapshot after the first
    # (into a backup allocated once); a step the D/G ratio skips leaves D
    # and its optimizer as they are.  Members run it, and each keeps its
    # update where its own count makes the phase due (the select JAX's
    # vmap of lax.cond lowers to)
    d_backup, due = None, True
    if members and d_ratio_on(cfg):
        due = d_phase_due(cfg, step0)
        before = [t.clone() for t in d_params + state.d_opt.tensors()]
    elif d_ratio_on(cfg):
        due = d_phase_due(cfg, int(step0) if g_count is None else g_count)
    if due is True or members:
        for u in range(cfg.n_unrolling_steps + 1):
            d_loss, d_grads = d_value_and_grad()
            d_tx.step(state.d_opt, state.d, synced(d_grads), members)
            if u == 0:
                d_loss_first = d_loss
                if cfg.n_unrolling_steps > 0:
                    d_backup = _backup_of(state.d)
                    _copy_params(d_backup, state.d)
    else:
        d_loss_first, _ = d_value_and_grad(with_grads=False)
    if due is not True and members:
        after = d_params + state.d_opt.tensors()
        _select_members(due, after, after, before)
        if d_backup is not None:
            b = list(d_backup.parameters())
            _select_members(due, b, b, before[:len(b)])

    phase("g_update")
    # G phase against the unrolled D, normalized once (per member)
    def sn_const(d):
        with torch.no_grad():
            return sn(d)
    d_g = vm.defer(sn_const, state.d)

    def g_part_loss(d_g, c, w_label, w_info):
        """The G loss of one part against D (:583-601, 664-682), of the
        part's rollout ``c["ph"]`` under grad."""
        ph = c["ph"]
        ph_in = ph if c["eps_g"] is None else ph + c["sigma"] * c["eps_g"]
        gen_label, gen_code = discriminator_apply(
            cast(d_g), cast(c["obsv_4d"]), cast(ph_in), cfg.remat_steps,
            cfg.pac, mb_feat(ph_in, c["valid"]))
        loss = lsgan_g_loss(gen_label.float(), gen_code.float(), c["noise"],
                            c["valid"], c["ones"], *info(c),
                            label_valid=group_valid(c["valid"]),
                            w_label=w_label, w_info=w_info)
        if cfg.use_l2_loss:
            loss = loss + w_info * cfg.loss_l2_w * l2_traj_loss(
                ph[..., :2], c["pred"], c["valid"])
        return loss

    def g_rollout_loss(g, d_g, c, w_label, w_info):
        """The G loss of one part with its rollout by ``g`` under grad."""
        return g_part_loss(d_g, {**c, "ph": rollout_on(g, c)}, w_label,
                           w_info)

    def g_separate_loss(g, d_g, c):
        """(G loss, rollout) with the extra terms: encode and pool once,
        decode the step's noise and every extra draw as rows of one
        batch."""
        noises = [c["noise"][None]]
        if cfg.use_variety_loss:
            noises.append(c["variety"])
        if diverse:
            noises.append(c["extra"])
        z = torch.cat(noises)
        r = z.shape[0]
        g_view = cast(g)
        prep = prepare_rollout(g_view, cast(obsv), scene_ids,
                               cfg.use_social, cast(social_x4),
                               cfg.remat_steps, cfg.max_scene_size)
        out = decode_rollout(g_view, prep, cast(z.reshape(r * n, -1)),
                             cfg.n_next, cfg.decoder, cfg.remat_steps)
        out = out.float().reshape(r, n, cfg.n_next, 4)
        loss = g_part_loss(d_g, {**c, "ph": out[0]}, 1.0, 1.0)
        first = 1
        if cfg.use_variety_loss:
            first += cfg.variety_k
            loss = loss + cfg.loss_l2_w * variety_loss(
                out[1:first, ..., :2], pred, valid)
        if diverse:
            # pairs of the step's draw and the extra ones (:609-661)
            d_row = _pair_mean(torch.cat([out[:1], out[first:]])[..., :2])
            dz_row = _pair_mean(torch.cat([c["noise"][None], c["extra"]]))
            if cfg.ms_weight > 0:
                ratio = (_masked_mean(d_row, valid, mesh)
                         / (_masked_mean(dz_row, valid, mesh) + 1e-8))
                loss = loss + cfg.ms_weight / (ratio + 1e-5)
            if cfg.ds_weight > 0:
                hinge = torch.clamp(cfg.ds_tau - d_row / (dz_row + 1e-8),
                                    min=0.0)
                loss = loss + cfg.ds_weight * _masked_mean(hinge, valid,
                                                           mesh)
        return loss, out[0]

    g_params = list(state.g.parameters())
    with torch.enable_grad():
        if accum:
            g_loss, g_grads = None, None
            for c, wp, ws in zip(parts, w_pack, w_sample):
                loss = weighted(on_members(g_rollout_loss, (state.g, d_g), c,
                                           wp, ws))
                g_loss = loss.detach() if g_loss is None else (
                    g_loss + loss.detach())
                g = _grads(loss, g_params)
                g_grads = g if g_grads is None else [
                    a + b for a, b in zip(g_grads, g)]
            pred_hat = pred_hat_fwd
        elif not separate:
            g_loss = weighted(on_members(g_part_loss, (d_g,),
                                         {**parts[0], "ph": pred_hat}, 1.0,
                                         1.0))
            g_grads = _grads(g_loss, g_params)
        else:
            g_loss, pred_hat = on_members(
                g_separate_loss, (state.g, d_g),
                {**parts[0], "variety": draws.variety_noise,
                 "extra": draws.extra_noise})
            g_loss = weighted(g_loss)
            g_grads = _grads(g_loss, g_params)
    g_tx.step(state.g_opt, state.g, synced(g_grads), members)

    phase("finish")
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
    return state, metrics if dp is None else dp.metrics(metrics)
