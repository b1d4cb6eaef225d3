"""Discriminator with the InfoGAN Q-head.

Counterpart of socialways_tpu/models/discriminator.py:29-103, 154-160
(reference train.py:272-316) for ``pac == 1`` without the minibatch-stddev
feature:

- observation branch: LSTM(4 -> h) over the observed 4-D sequence, its last
  output through FC h -> h/2 (LReLU 0.2) -> h/2;
- prediction branch: the whole predicted 4-D trajectory flattened
  (n_next * 4) through FC -> h/2 (LReLU 0.2) -> h/2;
- concat -> classifier FC h -> h/2 (LReLU) -> 1 (no sigmoid: LSGAN) and the
  latent decoder (Q-head) FC h -> h/2 (LReLU) -> n_latent_codes.

Parameter names are the JAX ones (``obsv_lstm``, ``obsv_fc``, ``pred_fc``,
``classifier``, ``latent_dec``), so ``state_dict`` keys map one to one onto
the JAX tree paths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.device import resolve_device
from socialways_torch.ops.lstm import LSTMCell, lstm_init, lstm_seq, zero_state
from socialways_torch.ops.nn import MLP, leaky_relu, linear_apply, mlp_init

#: the fully connected blocks; ``restore_linear_only`` takes these
LINEAR_BLOCKS = ("obsv_fc", "pred_fc", "classifier", "latent_dec")


class Discriminator(nn.Module):
    def __init__(self, obsv_lstm: LSTMCell, obsv_fc: MLP, pred_fc: MLP,
                 classifier: MLP, latent_dec: MLP):
        super().__init__()
        self.obsv_lstm = obsv_lstm
        self.obsv_fc = obsv_fc
        self.pred_fc = pred_fc
        self.classifier = classifier
        self.latent_dec = latent_dec


def init_discriminator(cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Discriminator:
    """Draw a discriminator from ``generator`` (a CPU ``torch.Generator``)
    on the CPU, then move it to ``device`` (``None`` = ``cuda``)."""
    check_supported(cfg)
    h, g = cfg.hidden_size, generator
    disc = Discriminator(
        obsv_lstm=lstm_init(4, h, g),
        obsv_fc=mlp_init([h, h // 2, h // 2], g),
        pred_fc=mlp_init([cfg.n_next * 4, h // 2, h // 2], g),
        classifier=mlp_init([h, h // 2, 1], g),
        latent_dec=mlp_init([h, h // 2, cfg.n_latent_codes], g))
    return disc.to(resolve_device(device))


def _fc2(layers: MLP, x: torch.Tensor) -> torch.Tensor:
    """Two linears with LeakyReLU(0.2) between (the reference's FC blocks)."""
    return linear_apply(layers[1], leaky_relu(linear_apply(layers[0], x)))


def encode_obsv(params: Discriminator, obsv_4d: torch.Tensor) -> torch.Tensor:
    """Observation branch: LSTM over the observed sequence -> FC code.  One
    GAN step scores the same observation against fake AND real futures, so
    callers compute this once per D evaluation and reuse it."""
    hidden = params.obsv_lstm.w.shape[1] // 4
    state = zero_state(obsv_4d.shape[0], hidden, obsv_4d.device,
                       obsv_4d.dtype)
    ys, _ = lstm_seq(params.obsv_lstm, obsv_4d, state)
    return _fc2(params.obsv_fc, ys[:, -1])


def discriminator_heads(params: Discriminator, obsv_code: torch.Tensor,
                        pred_4d: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prediction branch + classifier + Q-head given an observation code.
    ``pred_4d`` [K*N, n_next, 4] with ``obsv_code`` [N, h/2] tiles the code
    K times.  Returns (label [K*N, 1], code_hat [K*N, n_latent_codes])."""
    m = pred_4d.shape[0]
    if obsv_code.shape[0] != m:
        obsv_code = obsv_code.repeat(m // obsv_code.shape[0], 1)
    pred_code = _fc2(params.pred_fc, pred_4d.reshape(m, -1))
    both = torch.cat([obsv_code, pred_code], dim=-1)
    return _fc2(params.classifier, both), _fc2(params.latent_dec, both)


def discriminator_apply(params: Discriminator, obsv_4d: torch.Tensor,
                        pred_4d: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obsv_4d [N, n_past, 4], pred_4d [N, n_next, 4] ->
    (label [N, 1], code_hat [N, n_latent_codes])."""
    return discriminator_heads(params, encode_obsv(params, obsv_4d), pred_4d)


@torch.no_grad()
def restore_linear_only(backup: Discriminator,
                        current: Discriminator) -> None:
    """The reference's partial restore (train.py:311-316), in place: the FC
    blocks of ``current`` take ``backup``'s values, its LSTM keeps its own."""
    for block in LINEAR_BLOCKS:
        for dst, src in zip(getattr(current, block).parameters(),
                            getattr(backup, block).parameters()):
            dst.copy_(src)
