"""Generator: LSTM path encoder + social attention + autoregressive decoder.

Counterpart of socialways_tpu/models/generator.py (reference train.py:245-269,
320-335, 392-432), FC decoder only:

- the observation is embedded (4 -> h) and encoded by the fused LSTM;
- the social context is pooled once from the last observed frame and never
  refreshed during decode (train.py:409-413);
- the 12-step decode feeds each prediction back through the SAME encoder
  LSTM (train.py:430).

DecoderFC (train.py:320-335): with d = hidden + social + noise the stack is
Linear(d,d)+LReLU, Linear(d,d/2)+LReLU, Linear(d/2,d/4), Linear(d/4,2), with
no activation after the third layer.

The rollout is differentiable on both devices: on CUDA the social context
goes through the kernels' autograd Function, on the CPU through the dense
plain form under autograd.

Parameter names are the JAX ones (``embed``, ``encoder``, ``feat_mlp``,
``attn_w``, ``decoder``), so ``state_dict`` keys such as ``feat_mlp.0.w``
map one to one onto the JAX tree paths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.device import resolve_device
from socialways_torch.kernels.social_attention import social_attention_fwd
from socialways_torch.ops.lstm import (LSTMCell, lstm_cell, lstm_init,
                                       lstm_seq, zero_state)
from socialways_torch.ops.nn import (MLP, Linear, leaky_relu, linear_apply,
                                     linear_init, mlp_init)
from socialways_torch.ops.traj import obsv_to_4d

Prep = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Generator(nn.Module):
    def __init__(self, embed: Linear, encoder: LSTMCell, feat_mlp: MLP,
                 attn_w: Linear, decoder: MLP):
        super().__init__()
        self.embed = embed
        self.encoder = encoder
        self.feat_mlp = feat_mlp
        self.attn_w = attn_w
        self.decoder = decoder

    @property
    def hidden_size(self) -> int:
        return self.embed.w.shape[1]


def init_generator(cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Generator:
    """Draw a generator from ``generator`` (a CPU ``torch.Generator``) on the
    CPU, then move it to ``device`` (``None`` = ``cuda``): one seed gives
    the same weights on every device."""
    check_supported(cfg)
    h, f, d = cfg.hidden_size, cfg.social_feature_size, cfg.decoder_input
    g = generator
    gen = Generator(
        embed=linear_init(4, h, g),
        encoder=lstm_init(h, h, g),
        feat_mlp=mlp_init([cfg.num_social_features, 32, 64, f], g),
        attn_w=linear_init(h, f, g),
        decoder=mlp_init([d, d, d // 2, d // 4, 2], g))
    return gen.to(resolve_device(device))


def _decoder_fc_apply(layers: MLP, x: torch.Tensor) -> torch.Tensor:
    """DecoderFC: LReLU(0.2) after the first two layers only."""
    x = leaky_relu(linear_apply(layers[0], x))
    x = leaky_relu(linear_apply(layers[1], x))
    x = linear_apply(layers[2], x)
    return linear_apply(layers[3], x)


def encode_observation(params: Generator, obsv_4d: torch.Tensor):
    """obsv_4d [N, T, 4] -> (h, c), each [N, hidden]."""
    emb = linear_apply(params.embed, obsv_4d)
    state = zero_state(obsv_4d.shape[0], params.hidden_size,
                       obsv_4d.device, obsv_4d.dtype)
    _, state = lstm_seq(params.encoder, emb, state)
    return state


def social_context(params: Generator, obsv_4d: torch.Tensor, h: torch.Tensor,
                   scene_ids: torch.Tensor,
                   x4_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention-pooled social context from the last observed frame.
    ``x4_last`` overrides the geometry source: under agent_frame the
    pairwise features come from WORLD-frame states while ``h`` stays
    canonical."""
    x4 = obsv_4d[:, -1] if x4_last is None else x4_last
    return social_attention_fwd(params.feat_mlp, params.attn_w,
                                x4.contiguous(), h, scene_ids)


def prepare_rollout(params: Generator, obsv_p: torch.Tensor,
                    scene_ids: Optional[torch.Tensor] = None,
                    use_social: bool = False,
                    social_states: Optional[torch.Tensor] = None) -> Prep:
    """Noise-independent half of the rollout: encode and pool once.
    Returns ``(h, c, s, last_p)``.  ``social_states`` [N, 4] are the
    world-frame last-observed states when ``obsv_p`` is canonical."""
    obsv_4d = obsv_to_4d(obsv_p)
    h, c = encode_observation(params, obsv_4d)
    if use_social:
        if scene_ids is None:
            scene_ids = torch.zeros(obsv_p.shape[0], dtype=torch.int32,
                                    device=obsv_p.device)
        s = social_context(params, obsv_4d, h, scene_ids,
                           x4_last=social_states)
    else:
        s = torch.zeros_like(h)
    return h, c, s, obsv_p[:, -1]


def decode_rollout(params: Generator, prep: Prep, noise: torch.Tensor,
                   n_next: int) -> torch.Tensor:
    """Noise-dependent autoregressive decode -> pred_4d [N, n_next, 4]
    (reference ``predict``, train.py:392-432)."""
    h, c, s, last_p = prep
    steps = []
    for _ in range(n_next):
        new_v = _decoder_fc_apply(params.decoder,
                                  torch.cat([h, s, noise], dim=-1))
        last_p = new_v + last_p
        step_4d = torch.cat([last_p, new_v], dim=-1)
        h, c = lstm_cell(params.encoder,
                         linear_apply(params.embed, step_4d), (h, c))
        steps.append(step_4d)
    return torch.stack(steps, dim=1)


def generator_rollout(params: Generator, obsv_p: torch.Tensor,
                      noise: torch.Tensor, n_next: int,
                      scene_ids: Optional[torch.Tensor] = None,
                      use_social: bool = False,
                      social_states: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Full prediction rollout (prepare + decode): [N, n_next, 4]."""
    prep = prepare_rollout(params, obsv_p, scene_ids, use_social,
                           social_states)
    return decode_rollout(params, prep, noise, n_next)
