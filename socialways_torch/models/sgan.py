"""Social GAN with its pooling module (SGAN-P): the generator, served.

Gupta, Johnson, Fei-Fei, Savarese and Alahi, "Social GAN", CVPR 2018
(arXiv:1803.10892); github.com/agrimgupta92/sgan ``sgan/models.py``
(``Encoder``, ``PoolHiddenNet``, ``Decoder``, ``TrajectoryGenerator``)
with ``pooling_type pool_net``, ``pool_every_timestep 0``, ``noise_mix_type
global``, batch norm off and dropout 0.  With x_t the observed positions
(t = 1..T) and p = x_T the last one:

- Δx_t = x_t - x_{t-1}, Δx_1 = 0.
- Encoder: e_t = Δx_t W_se + b_se (2 -> E, no activation), an LSTM (E -> H)
  from a zero state over the T steps; h_i is its last hidden state.
- Pool: for every j of i's scene, j = i included,
  b_ij = relu(relu([(p_j - p_i) W_pe + b_pe ; h_j] W_1 + b_1) W_2 + b_2)
  (E + H -> 512 -> B), and P_i = max_j b_ij element-wise
  (``ops/sgan_pool.py`` on the CPU; on CUDA one launch of
  ``kernels/social_pool.py``, built for E = 16, H = 32, B = 32 alone).
- Context: c_i = relu(relu([h_i ; P_i] W_c1 + b_c1) W_c2 + b_c2)
  (H + B -> mlp_dim -> D - Z; ``make_mlp`` puts a ReLU after every layer).
- Noise: z ~ N(0, I_Z) once a scene, shared by its agents; the decoder
  starts from h_0 = [c_i ; z_scene(i)] (D) and c_0 = 0.
- Decoder: d_0 = Δx_T W_de + b_de (2 -> E); for t = 1..n_next,
  (h, c) = LSTM(d_{t-1}, (h, c)) (E -> D), Δŷ_t = h W_o + b_o (D -> 2),
  ŷ_t = ŷ_{t-1} + Δŷ_t from ŷ_0 = p, d_t = Δŷ_t W_de + b_de.

E, H, D, B, Z are ``cfg.embedding_dim``, ``encoder_h_dim``,
``decoder_h_dim``, ``bottleneck_dim`` and ``noise_len``.  Parameters keep
the port's layout (``w [in, out]``; an LSTM's ``w [in + h, 4h]`` with one
bias b_ih + b_hh, gates i, f, g, o); ``from_sgan_state_dict`` and
``to_sgan_state_dict`` map them to and from the published module names
(``pool_net.mlp_pre_pool.0.weight``, ``decoder.hidden2pos.bias``, ...).
The discriminator and SGAN's training are not ported.

A rollout is ``prepare`` (phases ``encode``, ``pool``: encoder, pool and
context once on N rows) then ``decode`` (phase ``decode``: R N rows).
Under ``compute_dtype="bfloat16"`` the caller passes the bf16 view of the
weights and bf16 positions; every layer takes bf16 operands with float32
sums (``linear_apply``, ``lstm_cell``) and the pool computes the contract
of ``ops/sgan_pool.py``, as Social Ways' rollout does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from socialways_torch.config import SGAN_POOL_WIDTH, TrainConfig, \
    check_supported
from socialways_torch.device import resolve_device
from socialways_torch.kernels.social_pool import social_pool_fused
from socialways_torch.ops.lstm import (LSTMCell, lstm_cell, lstm_init,
                                       zero_state)
from socialways_torch.ops.nn import MLP, Linear, linear_apply, linear_init, \
    mlp_init
from socialways_torch.ops.sgan_pool import social_pool_plain
from socialways_torch.utils.profiling import count, phase

#: the phases of an SGAN rollout unit (a simulated window, a forecast
#: request): ``prepare`` starts ``encode`` and ``pool``, ``decode``
#: starts ``decode``, and the caller starts ``frame``
SGAN_PHASES = ("encode", "pool", "decode", "frame")
#: (context [N, D - Z], last position [N, 2], last step Δx_T [N, 2])
SganPrep = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class SganGenerator(nn.Module):
    def __init__(self, spatial_embed: Linear, encoder: LSTMCell,
                 pool_embed: Linear, pool_mlp: MLP, context_mlp: MLP,
                 dec_embed: Linear, decoder: LSTMCell, hidden2pos: Linear):
        super().__init__()
        self.spatial_embed = spatial_embed
        self.encoder = encoder
        self.pool_embed = pool_embed
        self.pool_mlp = pool_mlp
        self.context_mlp = context_mlp
        self.dec_embed = dec_embed
        self.decoder = decoder
        self.hidden2pos = hidden2pos


def init_sgan(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
              device=None) -> SganGenerator:
    """Draw the generator from ``generator`` (a CPU ``torch.Generator``) on
    the CPU with torch's default ranges, then move it to ``device``."""
    check_supported(cfg)
    e, hid, dec = cfg.embedding_dim, cfg.encoder_h_dim, cfg.decoder_h_dim
    g = generator
    gen = SganGenerator(
        spatial_embed=linear_init(2, e, g), encoder=lstm_init(e, hid, g),
        pool_embed=linear_init(2, e, g),
        pool_mlp=mlp_init([e + hid, SGAN_POOL_WIDTH, cfg.bottleneck_dim], g),
        context_mlp=mlp_init([hid + cfg.bottleneck_dim, cfg.mlp_dim,
                              dec - cfg.noise_len], g),
        dec_embed=linear_init(2, e, g), decoder=lstm_init(e, dec, g),
        hidden2pos=linear_init(dec, 2, g))
    return gen.to(resolve_device(device))


# the published names of each linear layer and LSTM (sgan/models.py)
_LINEAR = {"spatial_embed": "encoder.spatial_embedding",
           "pool_embed": "pool_net.spatial_embedding",
           "pool_mlp.0": "pool_net.mlp_pre_pool.0",
           "pool_mlp.1": "pool_net.mlp_pre_pool.2",
           "context_mlp.0": "mlp_decoder_context.0",
           "context_mlp.1": "mlp_decoder_context.2",
           "dec_embed": "decoder.spatial_embedding",
           "hidden2pos": "decoder.hidden2pos"}
_LSTM = {"encoder": "encoder.encoder", "decoder": "decoder.decoder"}


def from_sgan_state_dict(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A ``TrajectoryGenerator`` state dict (sgan's names, ``nn.Linear``
    weights [out, in], ``nn.LSTM``'s ``weight_ih_l0`` / ``weight_hh_l0``
    / ``bias_ih_l0`` / ``bias_hh_l0``) as the port's ``state_dict``."""
    out = {}
    for ours, theirs in _LINEAR.items():
        out[ours + ".w"] = state[theirs + ".weight"].t().contiguous()
        out[ours + ".b"] = state[theirs + ".bias"].clone()
    for ours, theirs in _LSTM.items():
        out[ours + ".w"] = torch.cat([state[theirs + ".weight_ih_l0"].t(),
                                      state[theirs + ".weight_hh_l0"].t()])
        out[ours + ".b"] = (state[theirs + ".bias_ih_l0"]
                            + state[theirs + ".bias_hh_l0"])
    return {k: v.float() for k, v in out.items()}


def to_sgan_state_dict(gen: SganGenerator) -> Dict[str, torch.Tensor]:
    """The port's weights under sgan's names: the inverse of
    ``from_sgan_state_dict`` up to the split of an LSTM's bias, which is
    all in ``bias_ih_l0`` (``bias_hh_l0`` zero; the function is the
    same)."""
    sd = {k: v.detach() for k, v in gen.state_dict().items()}
    out = {}
    for ours, theirs in _LINEAR.items():
        out[theirs + ".weight"] = sd[ours + ".w"].t().contiguous()
        out[theirs + ".bias"] = sd[ours + ".b"].clone()
    for ours, theirs in _LSTM.items():
        w, b = sd[ours + ".w"], sd[ours + ".b"]
        n_in = w.shape[0] - w.shape[1] // 4
        out[theirs + ".weight_ih_l0"] = w[:n_in].t().contiguous()
        out[theirs + ".weight_hh_l0"] = w[n_in:].t().contiguous()
        out[theirs + ".bias_ih_l0"] = b.clone()
        out[theirs + ".bias_hh_l0"] = torch.zeros_like(b)
    return out


def _steps(obsv: torch.Tensor) -> torch.Tensor:
    """Δx [N, T, 2] of the positions [N, T, 2], Δx_1 = 0."""
    return torch.cat([torch.zeros_like(obsv[:, :1]),
                      obsv[:, 1:] - obsv[:, :-1]], dim=1)


def encode(params: SganGenerator, obsv: torch.Tensor) -> torch.Tensor:
    """h [N, H]: the encoder's last hidden state over the observed
    steps."""
    e = linear_apply(params.spatial_embed, _steps(obsv))
    state = zero_state(obsv.shape[0], params.encoder.w.shape[1] // 4,
                       obsv.device, obsv.dtype)
    for t in range(e.shape[1]):
        state = lstm_cell(params.encoder, e[:, t], state)
    return state[0]


def is_sgan(params) -> bool:
    """Whether ``params`` (a generator or its ``cast_params`` view) is
    Social GAN's: the engines choose the rollout by it."""
    return hasattr(params, "pool_mlp")


def _on_card(t: torch.Tensor) -> bool:
    """``t`` lies on a CUDA device (the CPU tests fake it true)."""
    return t.is_cuda


def pool(params: SganGenerator, pos: torch.Tensor, h: torch.Tensor,
         scene_ids: torch.Tensor, max_scene: int = 0) -> torch.Tensor:
    """P [N, B] in float32 (float64 for float64 operands).  On CUDA one
    launch of the kernel, counted as ``pool.fused``: it raises for the
    widths, dtypes or a gradient it is not built for, and names its
    widths; the plain forms serve the CPU alone."""
    if not _on_card(h):
        return social_pool_plain(params.pool_embed, params.pool_mlp, pos, h,
                                 scene_ids, max_scene)
    out = social_pool_fused(params.pool_embed, params.pool_mlp, pos, h,
                            scene_ids, max_scene)
    count("pool.fused")
    return out


def prepare(params: SganGenerator, obsv: torch.Tensor,
            scene_ids: Optional[torch.Tensor] = None,
            max_scene: int = 0) -> SganPrep:
    """Encode, pool and the context MLP once, on the observed positions
    ``obsv`` [N, T, 2] (world frame) of scenes ``scene_ids`` (None: one
    scene)."""
    phase("encode")
    h = encode(params, obsv)
    phase("pool")
    if scene_ids is None:
        scene_ids = torch.zeros(obsv.shape[0], dtype=torch.int32,
                                device=obsv.device)
    p = pool(params, obsv[:, -1], h, scene_ids, max_scene).to(h.dtype)
    x = torch.cat([h, p], dim=-1)
    for layer in params.context_mlp:
        x = torch.relu(linear_apply(layer, x))
    return x, obsv[:, -1], obsv[:, -1] - obsv[:, -2]


def scene_noise(noise: torch.Tensor, scene_ids: torch.Tensor
                ) -> torch.Tensor:
    """Each row's draw of the per-scene ``noise`` [..., S, Z]: [..., N, Z]
    (a padded row, id -1, reads scene 0's)."""
    return noise.index_select(-2, scene_ids.clamp(min=0).long())


def decode(params: SganGenerator, prep: SganPrep, z: torch.Tensor,
           n_next: int) -> torch.Tensor:
    """States [R N, n_next, 4] (position, step) of the decode of ``prep``
    (N rows) under the rows' noise ``z`` [R N, Z]: row r N + i is draw r
    of prepared row i."""
    phase("decode")
    ctx, pos, rel = prep
    reps = z.shape[0] // ctx.shape[0]
    if reps != 1:
        ctx, pos, rel = (t.repeat(reps, 1) for t in (ctx, pos, rel))
    h = torch.cat([ctx, z.to(ctx.dtype)], dim=-1)
    state = (h, torch.zeros_like(h))
    d = linear_apply(params.dec_embed, rel)
    steps = []
    for _ in range(n_next):
        state = lstm_cell(params.decoder, d, state)
        rel = linear_apply(params.hidden2pos, state[0])
        pos = pos + rel
        d = linear_apply(params.dec_embed, rel)
        steps.append(torch.cat([pos, rel], dim=-1))
    return torch.stack(steps, dim=1)


def rollout(params: SganGenerator, obsv: torch.Tensor,
            scene_ids: torch.Tensor, noise: torch.Tensor, n_next: int,
            max_scene: int = 0) -> torch.Tensor:
    """[N, n_next, 4] of one draw: ``noise`` [S, Z] holds a vector a
    scene."""
    prep = prepare(params, obsv, scene_ids, max_scene)
    return decode(params, prep, scene_noise(noise, scene_ids), n_next)
