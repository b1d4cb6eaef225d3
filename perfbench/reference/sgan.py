"""Social GAN with its pooling module (SGAN-P), the served generator,
plainly: the benchmark's reference for the ``sgan-crowd-sim`` cell,
written from the paper (Gupta et al., "Social GAN", CVPR 2018,
arXiv:1803.10892) and the published code (github.com/agrimgupta92/sgan
``sgan/models.py``), with nothing of the program under test.

The ``nn.Module`` tree mirrors ``TrajectoryGenerator`` with
``pooling_type pool_net``, ``pool_every_timestep 0``, ``noise_mix_type
global``, batch norm off and dropout 0, so its ``state_dict`` keys are
sgan's (``encoder.encoder.weight_ih_l0``, ``pool_net.mlp_pre_pool.0.weight``,
``mlp_decoder_context.2.bias``, ``decoder.hidden2pos.bias``).  The modules
hold the weights; the arithmetic below reads them.  With x_t the observed
positions (t = 1..T), p = x_T, E, H, D, B, Z the embedding, encoder,
decoder, bottleneck and noise widths:

- Δx_t = x_t - x_{t-1}, Δx_1 = 0.
- Encoder: e_t = Δx_t W_se + b_se (2 -> E, no activation), an LSTM (E -> H)
  from a zero state over the T steps; h_i its last hidden state.
- Pool: for every j of i's scene, j = i included,
  b_ij = relu(relu([(p_j - p_i) W_pe + b_pe ; h_j] W_1 + b_1) W_2 + b_2)
  (E + H -> 512 -> B), the published concatenation, and P_i = max_j b_ij.
- Context: c_i = relu(relu([h_i ; P_i] W_c1 + b_c1) W_c2 + b_c2)
  (H + B -> mlp -> D - Z).
- Noise: z ~ N(0, I_Z) once a scene; h_0 = [c_i ; z_scene(i)], c_0 = 0.
- Decoder: d_0 = Δx_T W_de + b_de; for t = 1..n_next, (h, c) = LSTM(d_{t-1},
  (h, c)) (E -> D), Δŷ_t = h W_o + b_o, ŷ_t = ŷ_{t-1} + Δŷ_t from ŷ_0 = p,
  d_t = Δŷ_t W_de + b_de.

An LSTM step computes ``[x | h] [W_ih ; W_hh]^T + (b_ih + b_hh)``, gates
i, f, g, o in float32.  ``Precision`` says where values are rounded:
every weight (an LSTM's summed bias as one) and every stored activation
(``store``: the steps, embeddings, LSTM states, the relu of the pool's
first layer, P, the context, positions), each product summing in float32
over rounded operands; the relu and the max of the pool's last layer run
on float32 values.  bfloat16 is the configuration's precision; float8 is
the control the comparison has to refuse.  TF32 is off.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from perfbench.reference.precision import Precision

POOL_WIDTH = 512        # PoolHiddenNet's hidden width (fixed in sgan)


class Encoder(nn.Module):
    def __init__(self, e: int, h: int):
        super().__init__()
        self.spatial_embedding = nn.Linear(2, e)
        self.encoder = nn.LSTM(e, h, 1)


class PoolHiddenNet(nn.Module):
    def __init__(self, e: int, h: int, bottleneck: int):
        super().__init__()
        self.spatial_embedding = nn.Linear(2, e)
        self.mlp_pre_pool = nn.Sequential(
            nn.Linear(e + h, POOL_WIDTH), nn.ReLU(),
            nn.Linear(POOL_WIDTH, bottleneck), nn.ReLU())


class Decoder(nn.Module):
    def __init__(self, e: int, d: int):
        super().__init__()
        self.decoder = nn.LSTM(e, d, 1)
        self.spatial_embedding = nn.Linear(2, e)
        self.hidden2pos = nn.Linear(d, 2)


class TrajectoryGenerator(nn.Module):
    def __init__(self, embedding_dim: int = 16, encoder_h_dim: int = 32,
                 decoder_h_dim: int = 32, mlp_dim: int = 64,
                 bottleneck_dim: int = 32, noise_dim: int = 8):
        super().__init__()
        e, h, d = embedding_dim, encoder_h_dim, decoder_h_dim
        self.encoder = Encoder(e, h)
        self.decoder = Decoder(e, d)
        self.pool_net = PoolHiddenNet(e, h, bottleneck_dim)
        self.mlp_decoder_context = nn.Sequential(
            nn.Linear(h + bottleneck_dim, mlp_dim), nn.ReLU(),
            nn.Linear(mlp_dim, d - noise_dim), nn.ReLU())


def fan_bound(name: str, shapes: Dict[str, Tuple[int, ...]]) -> float:
    """torch's default init range of a leaf: 1/sqrt(in) for nn.Linear,
    1/sqrt(hidden) for nn.LSTM."""
    if ".weight_" in name or ".bias_" in name:
        return shapes[name.rsplit(".", 1)[0] + ".weight_hh_l0"][1] ** -0.5
    return shapes[name.rsplit(".", 1)[0] + ".weight"][1] ** -0.5


class _Weights:
    """The generator's weights as the arithmetic reads them, each rounded
    by ``P.store``: a linear layer (W^T [in, out], b), an LSTM ([W_ih ;
    W_hh]^T [in + h, 4h], b_ih + b_hh)."""

    def __init__(self, state: Dict[str, torch.Tensor], P: Precision):
        s = {k: v.float() for k, v in state.items()}
        self.lin = {}
        for name in ("encoder.spatial_embedding", "pool_net.spatial_embedding",
                     "pool_net.mlp_pre_pool.0", "pool_net.mlp_pre_pool.2",
                     "mlp_decoder_context.0", "mlp_decoder_context.2",
                     "decoder.spatial_embedding", "decoder.hidden2pos"):
            self.lin[name] = (P.store(s[name + ".weight"].t().contiguous()),
                              P.store(s[name + ".bias"]))
        self.lstm = {}
        for name in ("encoder.encoder", "decoder.decoder"):
            w = torch.cat([s[name + ".weight_ih_l0"].t(),
                           s[name + ".weight_hh_l0"].t()])
            self.lstm[name] = (P.store(w.contiguous()), P.store(
                s[name + ".bias_ih_l0"] + s[name + ".bias_hh_l0"]))


def _linear(W: _Weights, name: str, x: torch.Tensor, P: Precision
            ) -> torch.Tensor:
    w, b = W.lin[name]
    return P.store(P.mm(x, w) + b)


def _lstm(W: _Weights, name: str, x, h, c, P: Precision):
    w, b = W.lstm[name]
    gates = P.mm(torch.cat([x, h], dim=-1), w) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return P.store(h_new), P.store(c_new)


def encode(W: _Weights, obsv: torch.Tensor, P: Precision) -> torch.Tensor:
    steps = torch.cat([torch.zeros_like(obsv[:, :1]),
                       P.store(obsv[:, 1:] - obsv[:, :-1])], dim=1)
    e = _linear(W, "encoder.spatial_embedding", steps, P)
    hid = W.lstm["encoder.encoder"][0].shape[1] // 4
    h = c = torch.zeros(obsv.shape[0], hid, device=obsv.device)
    for t in range(obsv.shape[1]):
        h, c = _lstm(W, "encoder.encoder", e[:, t], h, c, P)
    return h


def scene_blocks(ids: np.ndarray, rows: int = 128) -> List[Tuple[int, int]]:
    """[start, end) blocks of whole scenes (sorted, contiguous ids), each
    as many scenes as fit ``rows`` rows (a larger scene alone)."""
    cuts = np.flatnonzero(np.diff(ids)) + 1
    starts = np.concatenate([[0], cuts]).tolist()
    ends = np.concatenate([cuts, [len(ids)]]).tolist()
    blocks, b0 = [], None
    for s, e in zip(starts, ends):
        if b0 is not None and e - b0 > rows:
            blocks.append((b0, s))
            b0 = None
        if b0 is None:
            b0 = s
    if b0 is not None:
        blocks.append((b0, len(ids)))
    return blocks


def pool(W: _Weights, pos: torch.Tensor, h: torch.Tensor, ids: torch.Tensor,
         P: Precision) -> torch.Tensor:
    """P [N, B] (rounded by ``store``) over each row's scene, its own row
    included; padded rows (-1) get zeros."""
    w1, b1 = W.lin["pool_net.mlp_pre_pool.0"]
    w2, b2 = W.lin["pool_net.mlp_pre_pool.2"]
    out = torch.zeros(h.shape[0], w2.shape[1], device=h.device)
    for a, b in scene_blocks(ids.cpu().numpy()):
        pi, hj, si = pos[a:b], h[a:b], ids[a:b]
        rel = P.store(pi[None, :, :] - pi[:, None, :])     # [i, j]: p_j - p_i
        e = _linear(W, "pool_net.spatial_embedding", rel, P)
        x = torch.cat([e, hj[None].expand(b - a, -1, -1)], dim=-1)
        z = P.store(torch.relu(P.mm(x, w1) + b1))
        z = torch.relu(P.mm(z, w2) + b2)
        mask = (si[:, None] == si[None, :]) & (si[:, None] >= 0)
        z = torch.where(mask[..., None], z, torch.zeros_like(z))
        out[a:b] = torch.where(mask.any(1, keepdim=True), z.amax(1), 0.0)
    return P.store(out)


def rollout(W: _Weights, obsv: torch.Tensor, ids: torch.Tensor,
            z: torch.Tensor, n_next: int, P: Precision) -> torch.Tensor:
    """[N, n_next, 2] positions of one draw; ``z`` [S, Z] a scene."""
    h = encode(W, obsv, P)
    p = pool(W, obsv[:, -1], h, ids, P)
    c = torch.cat([h, p], dim=-1)
    for name in ("mlp_decoder_context.0", "mlp_decoder_context.2"):
        c = torch.relu(_linear(W, name, c, P))
    zi = P.store(z.float())[ids.clamp(min=0).long()]
    hd = torch.cat([c, zi], dim=-1)
    cd = torch.zeros_like(hd)
    pos = obsv[:, -1]
    rel = P.store(obsv[:, -1] - obsv[:, -2])
    d = _linear(W, "decoder.spatial_embedding", rel, P)
    out = []
    for _ in range(n_next):
        hd, cd = _lstm(W, "decoder.decoder", d, hd, cd, P)
        rel = _linear(W, "decoder.hidden2pos", hd, P)
        pos = P.store(pos + rel)
        d = _linear(W, "decoder.spatial_embedding", rel, P)
        out.append(pos)
    return torch.stack(out, dim=1)


@torch.no_grad()
def simulate(state: Dict[str, torch.Tensor], obsv0: torch.Tensor,
             ids: torch.Tensor, noise: torch.Tensor, n_next: int,
             P: Precision) -> torch.Tensor:
    """[N, W n_next, 2] world positions of W windows under ``noise`` [W, S,
    Z] (row i reads its scene id's vector): each window rolls out the last
    ``n_past`` positions of the buffer and appends its predictions.  Rows
    are sorted, contiguous scenes; any whole scenes of a crowd give their
    own rows' trajectories."""
    torch.backends.cuda.matmul.allow_tf32 = False
    W = _Weights(state, P)
    n_past = obsv0.shape[1]
    obsv = P.store(obsv0.float())
    out = []
    for z in noise:
        pos = rollout(W, obsv, ids, z, n_next, P)
        out.append(pos)
        obsv = torch.cat([obsv, pos], dim=1)[:, -n_past:]
    return torch.cat(out, dim=1)
