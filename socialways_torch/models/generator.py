"""Generator: LSTM path encoder + social attention + autoregressive decoder.

Counterpart of socialways_tpu/models/generator.py (reference train.py:245-269,
320-366, 392-432):

- the observation is embedded (4 -> h) and encoded by the fused LSTM;
- the social context is pooled once from the last observed frame and never
  refreshed during decode (train.py:409-413);
- the 12-step decode feeds each prediction back through the SAME encoder
  LSTM (train.py:430).

DecoderFC (train.py:320-335, ``decoder="fc"``): with d = hidden + social +
noise the stack is Linear(d,d)+LReLU, Linear(d,d/2)+LReLU, Linear(d/2,d/4),
Linear(d/4,2), with no activation after the third layer.  DecoderLstm
(train.py:339-366, ``decoder="lstm"``): an LSTM(d -> h) whose state starts
at zero each rollout and rides in the decode carry, then FC h -> 64
(Sigmoid) -> 64 (LReLU) -> 32 (LReLU) -> 2.  Under ``remat`` each encoder
step and each decode step is checkpointed; the social attention is not (its
forward kernel would run again in the backward).

Under bf16 on CUDA with no gradient recorded, the encoder (the embedding
and every observed LSTM step) is one hand-written kernel
(``kernels/encode_observation.py``; ``fused_encode`` says when), and so is
the FC decode of all the steps (``kernels/decode_rollout.py``;
``fused_decode`` says when), whose K draws read the prepared rows in
place; the plain loop copies them.

The rollout is differentiable on both devices: on CUDA the social context
goes through the kernels' autograd Function, on the CPU through the
size-aware dispatch's plain forms under autograd (dense at small N;
windowed or blockwise at crowd scale, ``max_scene``).

Activations flow in the dtype of the observation: under
``compute_dtype="bfloat16"`` the caller passes a bf16 view of the weights
(``ops.nn.cast_params``) and bf16 inputs, every layer takes bf16 operands
with float32 accumulation, the social call gets bf16 ``h`` and ``x4`` (the
kernels' bf16 mode) and the decode, with its feedback through the encoder,
stays bf16, as in JAX's generator.

Parameter names are the JAX ones (``embed``, ``encoder``, ``feat_mlp``,
``attn_w`` and ``decoder`` or ``dec_lstm`` + ``dec_fc``), so ``state_dict`` keys such as ``feat_mlp.0.w``
map one to one onto the JAX tree paths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch._C._functorch import is_functorch_wrapped_tensor

from socialways_torch.config import TrainConfig, check_supported
from socialways_torch.device import resolve_device
from socialways_torch.kernels.decode_rollout import decode_rollout_bf16
from socialways_torch.kernels.encode_observation import (
    encode_observation_bf16)
from socialways_torch.kernels.social_attention import social_attention
from socialways_torch.ops.lstm import (LSTMCell, lstm_cell, lstm_init,
                                       lstm_seq, remat_call, zero_state)
from socialways_torch.ops.nn import (MLP, Linear, leaky_relu, linear_apply,
                                     linear_init, mlp_init)
from socialways_torch.ops.traj import obsv_to_4d
from socialways_torch.utils.profiling import count, phase

Prep = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
#: the phases of a rollout unit (a simulated window, a forecast request):
#: ``prepare_rollout`` starts ``encode`` and ``attention``,
#: ``decode_rollout`` starts ``decode``, and the caller starts ``frame``
#: (utils/profiling.py; inside a training step they are not its phases)
ROLLOUT_PHASES = ("encode", "attention", "decode", "frame")


class Generator(nn.Module):
    """``decoder`` (the FC decoder) or ``dec_lstm`` + ``dec_fc`` (the LSTM
    decoder)."""

    def __init__(self, embed: Linear, encoder: LSTMCell, feat_mlp: MLP,
                 attn_w: Linear, decoder: Optional[MLP] = None,
                 dec_lstm: Optional[LSTMCell] = None,
                 dec_fc: Optional[MLP] = None):
        super().__init__()
        self.embed = embed
        self.encoder = encoder
        self.feat_mlp = feat_mlp
        self.attn_w = attn_w
        if decoder is not None:
            self.decoder = decoder
        else:
            self.dec_lstm = dec_lstm
            self.dec_fc = dec_fc


def init_generator(cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Generator:
    """Draw a generator from ``generator`` (a CPU ``torch.Generator``) on the
    CPU, then move it to ``device`` (``None`` = ``cuda``): one seed gives
    the same weights on every device."""
    check_supported(cfg)
    h, f, d = cfg.hidden_size, cfg.social_feature_size, cfg.decoder_input
    g = generator
    parts = dict(embed=linear_init(4, h, g), encoder=lstm_init(h, h, g),
                 feat_mlp=mlp_init([cfg.num_social_features, 32, 64, f], g),
                 attn_w=linear_init(h, f, g))
    if cfg.decoder == "lstm":
        parts.update(dec_lstm=lstm_init(d, h, g),
                     dec_fc=mlp_init([h, 64, 64, 32, 2], g))
    else:
        parts.update(decoder=mlp_init([d, d, d // 2, d // 4, 2], g))
    return Generator(**parts).to(resolve_device(device))


def _decoder_fc_apply(layers: MLP, x: torch.Tensor) -> torch.Tensor:
    """DecoderFC: LReLU(0.2) after the first two layers only."""
    x = leaky_relu(linear_apply(layers[0], x))
    x = leaky_relu(linear_apply(layers[1], x))
    x = linear_apply(layers[2], x)
    return linear_apply(layers[3], x)


def _decoder_lstm_fc_apply(layers: MLP, x: torch.Tensor) -> torch.Tensor:
    """DecoderLstm's head: Sigmoid, LReLU, LReLU between the layers."""
    x = torch.sigmoid(linear_apply(layers[0], x))
    x = leaky_relu(linear_apply(layers[1], x))
    x = leaky_relu(linear_apply(layers[2], x))
    return linear_apply(layers[3], x)


def fused_encode(params: Generator, obsv_4d: torch.Tensor) -> bool:
    """Whether ``encode_observation`` takes the fused kernel
    (``kernels/encode_observation.py``): ``obsv_4d`` on CUDA, it and the
    embedding's and encoder's weights bf16, no gradient being recorded and
    no functorch transform over them (an ensemble's member ``vmap``).
    Everything else (the CPU, float32, an encode under autograd, with or
    without ``remat``, members) takes the plain path.  Past hidden 64 the
    kernel raises, naming its widths, as the fused decode does."""
    weights = (params.embed.w, params.embed.b, params.encoder.w,
               params.encoder.b)
    return (_on_card(obsv_4d) and not torch.is_grad_enabled()
            and all(t.dtype == torch.bfloat16 for t in (obsv_4d, *weights))
            and not any(is_functorch_wrapped_tensor(t)
                        for t in (obsv_4d, *weights)))


def encode_observation(params: Generator, obsv_4d: torch.Tensor,
                       remat: bool = False):
    """obsv_4d [N, T, 4] -> (h, c), each [N, hidden]: the embedding, then
    the encoder LSTM from a zero state over the T steps.  Where
    ``fused_encode`` holds, one kernel launch."""
    if fused_encode(params, obsv_4d):
        state = encode_observation_bf16(params, obsv_4d)
        count("encode.fused")
        return state
    emb = linear_apply(params.embed, obsv_4d)
    state = zero_state(obsv_4d.shape[0], params.embed.w.shape[1],
                       obsv_4d.device, obsv_4d.dtype)
    _, state = lstm_seq(params.encoder, emb, state, remat)
    return state


def social_context(params: Generator, obsv_4d: torch.Tensor, h: torch.Tensor,
                   scene_ids: torch.Tensor,
                   x4_last: Optional[torch.Tensor] = None,
                   max_scene: int = 0) -> torch.Tensor:
    """Attention-pooled social context from the last observed frame,
    through the size-aware dispatch (``max_scene`` > 0: sorted, contiguous
    scenes of at most that many rows).  ``x4_last`` overrides the geometry
    source: under agent_frame the pairwise features come from WORLD-frame
    states while ``h`` stays canonical."""
    x4 = obsv_4d[:, -1] if x4_last is None else x4_last
    return social_attention(params.feat_mlp, params.attn_w, x4.contiguous(),
                            h, scene_ids, max_scene)


def prepare_rollout(params: Generator, obsv_p: torch.Tensor,
                    scene_ids: Optional[torch.Tensor] = None,
                    use_social: bool = False,
                    social_states: Optional[torch.Tensor] = None,
                    remat: bool = False, max_scene: int = 0) -> Prep:
    """Noise-independent half of the rollout: encode and pool once.
    Returns ``(h, c, s, last_p)``.  ``social_states`` [N, 4] are the
    world-frame last-observed states when ``obsv_p`` is canonical."""
    phase("encode")
    obsv_4d = obsv_to_4d(obsv_p)
    h, c = encode_observation(params, obsv_4d, remat)
    phase("attention")
    if use_social:
        if scene_ids is None:
            scene_ids = torch.zeros(obsv_p.shape[0], dtype=torch.int32,
                                    device=obsv_p.device)
        s = social_context(params, obsv_4d, h, scene_ids,
                           x4_last=social_states, max_scene=max_scene)
    else:
        s = torch.zeros_like(h)
    return h, c, s, obsv_p[:, -1]


def _on_card(t: torch.Tensor) -> bool:
    """``t`` lies on a CUDA device (the CPU tests fake it true)."""
    return t.is_cuda


def fused_decode(params: Generator, prep: Prep, noise: torch.Tensor,
                 decoder: str) -> bool:
    """Whether ``decode_rollout`` takes the fused kernel
    (``kernels/decode_rollout.py``): bf16 operands on CUDA, the FC decoder,
    no gradient being recorded and no functorch transform over ``prep``,
    ``noise`` or the weights (an ensemble's member ``vmap``).  Everything
    else (the CPU, float32, the LSTM decoder, a rollout under autograd,
    with or without ``remat``, members) takes the plain loop."""
    h = prep[0]
    return (_on_card(h) and h.dtype == torch.bfloat16 and decoder == "fc"
            and not torch.is_grad_enabled()
            and not any(is_functorch_wrapped_tensor(t) for t in
                        (*prep, noise, params.decoder[0].w)))


def _draw_copies(prep: Prep, rows: int) -> Prep:
    """``rows`` / N copies of the N prepared rows, row r N + i a copy of
    row i (``prep`` itself when it has ``rows``)."""
    n = prep[0].shape[0]
    return prep if rows == n else tuple(t.repeat(rows // n, 1) for t in prep)


def prep_for_draws(params: Generator, prep: Prep, noise: torch.Tensor,
                   decoder: str = "fc") -> Prep:
    """``prep`` of N rows for a decode of ``noise`` of R N rows as the
    decode reads it: as it is where ``fused_decode`` holds (the kernel
    reads row i for every draw), else R copies (``decode_rollout`` makes
    the same copies itself; a caller that passes them keeps the prepared
    rows one to one with the output rows)."""
    if fused_decode(params, prep, noise, decoder):
        return prep
    return _draw_copies(prep, noise.shape[0])


def decode_rollout(params: Generator, prep: Prep, noise: torch.Tensor,
                   n_next: int, decoder: str = "fc",
                   remat: bool = False) -> torch.Tensor:
    """Noise-dependent autoregressive decode -> pred_4d [R N, n_next, 4]
    (reference ``predict``, train.py:392-432) of ``prep`` = (h, c, s,
    last_p) of N rows and ``noise`` of R N: row r N + i is draw r of
    prepared row i (``prep`` of R N rows is taken as it is).  The carry is
    (h, c, last position) and, for the LSTM decoder, its own (h, c) from
    zeros.  Where ``fused_decode`` holds, one kernel launch decodes and
    reads each prepared row for its R draws; the plain loop takes R
    copies of ``prep``."""
    phase("decode")
    if fused_decode(params, prep, noise, decoder):
        count("decode.fused")
        return decode_rollout_bf16(params, prep, noise, n_next)
    h, c, s, last_p = _draw_copies(prep, noise.shape[0])
    lstm_dec = decoder == "lstm"

    def step(params, s, noise, h, c, last_p, *dec):
        inp = torch.cat([h, s, noise], dim=-1)
        if lstm_dec:
            dec = lstm_cell(params.dec_lstm, inp, dec)
            new_v = _decoder_lstm_fc_apply(params.dec_fc, dec[0])
        else:
            new_v = _decoder_fc_apply(params.decoder, inp)
        new_p = new_v + last_p
        step_4d = torch.cat([new_p, new_v], dim=-1)
        # feed the prediction back through the encoder (train.py:430)
        h, c = lstm_cell(params.encoder,
                         linear_apply(params.embed, step_4d), (h, c))
        return (step_4d, h, c, new_p) + tuple(dec)

    carry = (h, c, last_p)
    if lstm_dec:
        carry += zero_state(h.shape[0], params.dec_lstm.w.shape[1] // 4,
                            h.device, h.dtype)
    steps = []
    for _ in range(n_next):
        step_4d, *carry = remat_call(remat, step, params, s, noise, *carry)
        steps.append(step_4d)
    return torch.stack(steps, dim=1)


def generator_rollout(params: Generator, obsv_p: torch.Tensor,
                      noise: torch.Tensor, n_next: int,
                      scene_ids: Optional[torch.Tensor] = None,
                      use_social: bool = False,
                      social_states: Optional[torch.Tensor] = None,
                      decoder: str = "fc", remat: bool = False,
                      max_scene: int = 0) -> torch.Tensor:
    """Full prediction rollout (prepare + decode): [N, n_next, 4]."""
    prep = prepare_rollout(params, obsv_p, scene_ids, use_social,
                           social_states, remat, max_scene)
    return decode_rollout(params, prep, noise, n_next, decoder, remat)
