"""The Social Ways generator and discriminator, plainly.

Parameters are a dict of float32 tensors keyed by the published layout's
names (``embed.w``, ``encoder.w``, ``feat_mlp.0.w``, ``attn_w.w``,
``decoder.0.w``; ``obsv_lstm.w``, ``obsv_fc.0.w``, ``pred_fc.0.w``,
``classifier.0.w``, ``latent_dec.0.w``): a linear layer computes ``x @ w
+ b`` with ``w [in, out]``; an LSTM cell ``[x | h] @ w + b`` with gates in
the order i, f, g, o.

Generator (reference train.py:245-269, 320-335, 392-432): the observed
4-D states (position, backward-difference velocity) are embedded (4 -> h)
and encoded by the LSTM; the social context is pooled once from the last
observed frame; each of the ``n_next`` decode steps feeds
``[h | social | noise]`` through the FC decoder d -> d -> d/2 -> d/4 -> 2
(LeakyReLU 0.2 after the first two layers) for a velocity, and feeds the
new state back through the same embedding and encoder.

Social attention: per ordered pair (i, j) of one scene (ids equal and not
-1, i != j) the features of j seen from i (distance, bearing, distance of
closest approach) go through the MLP 3 -> 32 -> 64 -> F (ReLU between);
the score is that embedding dotted with ``attn_w(h_j)``; a softmax over
the row's partners weighs ``h_j``; a row with no partner gets zeros.  It
is computed over windows of columns: a block of rows against the columns
within ``window`` rows of it (all columns when ``window`` is 0), which is
exact for sorted, contiguous scenes of at most ``window`` rows.

Discriminator (train.py:272-316): an LSTM (4 -> h) over the observed
states and FC h -> h/2 -> h/2; the flattened predicted states through FC
-> h/2 -> h/2; the classifier h -> h/2 -> 1 and the Q-head h -> h/2 ->
n_codes on their concatenation (LeakyReLU 0.2 inside each FC block).

Mixed precision follows the program's contract for ``compute_dtype``
bfloat16 (JAX's cast points): weights, observations, noise and every
activation are held in the activation dtype (``Precision.store``), each
product sums in float32, the LSTM's gates run in float32, and the social
features, scores and softmax are float32 with the embedding MLP's
operands and the pooling weights rounded.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]
_NEG = -1e9


def linear(p: Params, name: str, x: torch.Tensor, P: Precision
           ) -> torch.Tensor:
    return P.store(P.mm(x, p[name + ".w"]) + p[name + ".b"])


def leaky(x: torch.Tensor, P: Precision) -> torch.Tensor:
    slope = P.scalar(0.2)
    return P.store(torch.where(x > 0, x, x * slope))


def fc2(p: Params, name: str, x: torch.Tensor, P: Precision) -> torch.Tensor:
    return linear(p, name + ".1", leaky(linear(p, name + ".0", x, P), P), P)


def lstm(p: Params, name: str, x: torch.Tensor, h: torch.Tensor,
         c: torch.Tensor, P: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    gates = P.mm(torch.cat([x, h], dim=-1), p[name + ".w"]) + p[name + ".b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return P.store(h_new), P.store(c_new)


def to_4d(obsv: torch.Tensor, P: Precision) -> torch.Tensor:
    """[..., T, 2] positions -> [..., T, 4]: positions and backward
    differences, the first step repeating the second's."""
    v = P.store(obsv[..., 1:, :] - obsv[..., :-1, :])
    return torch.cat([obsv, torch.cat([v[..., :1, :], v], dim=-2)], dim=-1)


def pred_to_4d(obsv: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([obsv[..., -1:, :], pred[..., :-1, :]], dim=-2)
    return torch.cat([pred, pred - prev], dim=-1)


def agent_frame(obsv: torch.Tensor, P: Precision):
    """(origin, cos, sin): the last observed point and the direction of the
    last observed step (the identity where the agent stood still)."""
    c = obsv[..., -1, :]
    d = P.store(obsv[..., -1, :] - obsv[..., -2, :])
    nrm = P.store(torch.sqrt(P.store(P.store(d * d).sum(-1, keepdim=True))))
    unit = P.store(d / torch.where(nrm > 1e-8, nrm, torch.ones_like(nrm)))
    ident = torch.tensor([1.0, 0.0], device=obsv.device)
    unit = torch.where(nrm > 1e-8, unit, ident)
    return c, unit[..., 0], unit[..., 1]


def to_frame(points: torch.Tensor, frame, P: Precision) -> torch.Tensor:
    c, cos, sin = frame
    q = P.store(points - c[..., None, :])
    s = P.store
    x = s(s(q[..., 0] * cos[..., None]) + s(q[..., 1] * sin[..., None]))
    y = s(s(-q[..., 0] * sin[..., None]) + s(q[..., 1] * cos[..., None]))
    return torch.stack([x, y], dim=-1)


def from_frame_4d(states: torch.Tensor, frame, P: Precision) -> torch.Tensor:
    c, cos, sin = frame
    s = P.store
    px, py, vx, vy = states.unbind(-1)
    cs, sn = cos[..., None], sin[..., None]
    wx = s(s(s(px * cs) - s(py * sn)) + c[..., None, 0])
    wy = s(s(s(px * sn) + s(py * cs)) + c[..., None, 1])
    wvx = s(s(vx * cs) - s(vy * sn))
    wvy = s(s(vx * sn) + s(vy * cs))
    return torch.stack([wx, wy, wvx, wvy], dim=-1)


def social_features(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """[I, 4] seeing rows, [J, 4] seen columns -> [I, J, 3]: distance,
    bearing and distance of closest approach of j as seen from i."""
    dp = xi[:, None, :2] - xj[None, :, :2]
    dv = xi[:, None, 2:] - xj[None, :, 2:]
    v = xi[:, 2:]

    def norm(t):
        sq = (t * t).sum(-1)
        pos = sq > 0
        return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)

    dist = norm(dp)
    bearing = (dp * v[:, None, :]).sum(-1) / (dist * norm(v)[:, None] + 1e-6)
    ttca = -(dp * dv).sum(-1) / ((dv * dv).sum(-1) + 1e-6)
    dca = norm(dp + ttca[..., None] * dv)
    return torch.stack([dist, bearing, dca], dim=-1)


def social_context(p: Params, x4: torch.Tensor, h: torch.Tensor,
                   ids: torch.Tensor, P: Precision, window: int = 0,
                   block: int = 2048) -> torch.Tensor:
    """The pooled social context [N, H] in the activation dtype."""
    n = h.shape[0]
    wh = P.store(P.mm(h, p["attn_w.w"]) + p["attn_w.b"])
    mlp = [(p[f"feat_mlp.{k}.w"], p[f"feat_mlp.{k}.b"]) for k in range(3)]
    outs = []
    step = n if window <= 0 else block
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        j0, j1 = (0, n) if window <= 0 else (max(0, i0 - window),
                                             min(n, i1 + window))
        a = social_features(x4[i0:i1], x4[j0:j1])
        for k, (w, b) in enumerate(mlp):
            if k:
                a = torch.relu(a)
            a = P.mm(P.store(a), P.store(w)) + P.store(b)
        scores = (P.operand(a) * P.operand(wh[j0:j1])[None]).sum(-1)
        rows = torch.arange(i0, i1, device=h.device)[:, None]
        cols = torch.arange(j0, j1, device=h.device)[None, :]
        si, sj = ids[i0:i1, None], ids[None, j0:j1]
        mask = (si == sj) & (si >= 0) & (sj >= 0) & (rows != cols)
        scores = torch.where(mask, scores, _NEG)
        m = scores.max(dim=-1, keepdim=True).values
        e = torch.where(mask, torch.exp(scores - m), 0.0)
        l = e.sum(dim=-1, keepdim=True)
        pooled = P.mm(P.store(e), h[j0:j1]) / torch.clamp(l, min=1e-20)
        outs.append(torch.where(l > 0, pooled, 0.0))
    return P.store(torch.cat(outs))


def encode(p: Params, obsv_4d: torch.Tensor, P: Precision):
    emb = linear(p, "embed", obsv_4d, P)
    hid = p["embed.w"].shape[1]
    h = c = torch.zeros(obsv_4d.shape[0], hid, device=obsv_4d.device)
    for t in range(obsv_4d.shape[1]):
        h, c = lstm(p, "encoder", emb[:, t], h, c, P)
    return h, c


def decode(p: Params, h, c, s, last_p, noise, n_next: int, P: Precision
           ) -> torch.Tensor:
    """[N, n_next, 4] states from the carry (h, c, last position) and the
    social context ``s`` under ``noise`` [N, noise_len]."""
    steps = []
    for _ in range(n_next):
        x = torch.cat([h, s, noise], dim=-1)
        x = leaky(linear(p, "decoder.0", x, P), P)
        x = leaky(linear(p, "decoder.1", x, P), P)
        x = linear(p, "decoder.2", x, P)
        new_v = linear(p, "decoder.3", x, P)
        new_p = P.store(new_v + last_p)
        state = torch.cat([new_p, new_v], dim=-1)
        h, c = lstm(p, "encoder", linear(p, "embed", state, P), h, c, P)
        last_p = new_p
        steps.append(state)
    return torch.stack(steps, dim=1)


def canonical(obsv: torch.Tensor, P: Precision):
    """(agent-frame observations, frame, world-frame last 4-D states)."""
    x4 = to_4d(obsv, P)[:, -1]
    frame = agent_frame(obsv, P)
    return to_frame(obsv, frame, P), frame, x4


def prepare(p: Params, obsv_in: torch.Tensor, x4: torch.Tensor,
            ids: torch.Tensor, P: Precision, window: int = 0):
    h, c = encode(p, to_4d(obsv_in, P), P)
    s = social_context(p, x4, h, ids, P, window)
    return h, c, s, obsv_in[:, -1]


def rollout(p: Params, obsv_in, x4, ids, noise, n_next: int, P: Precision,
            window: int = 0) -> torch.Tensor:
    h, c, s, last = prepare(p, obsv_in, x4, ids, P, window)
    return decode(p, h, c, s, last, noise, n_next, P)


def rounded_params(p: Params, P: Precision) -> Params:
    return {k: P.store(v.float()) for k, v in p.items()}


@torch.no_grad()
def k_sample_forecast(p: Params, obsv: torch.Tensor, ids: torch.Tensor,
                      noise: torch.Tensor, n_next: int, P: Precision,
                      window: int = 0) -> torch.Tensor:
    """[K, N, n_next, 4] world-frame forecasts of the observed windows
    ``obsv`` [N, n_past, 2] under ``noise`` [K, N, noise_len]: encode and
    pool once, decode the K draws as K N rows (row k N + i)."""
    k, n = noise.shape[0], obsv.shape[0]
    p = rounded_params(p, P)
    obsv = P.store(obsv.float())
    obsv_in, frame, x4 = canonical(obsv, P)
    h, c, s, last = prepare(p, obsv_in, x4, ids, P, window)
    rep = lambda t: t.repeat(k, 1)
    out = decode(p, rep(h), rep(c), rep(s), rep(last),
                 P.store(noise.float()).reshape(k * n, -1), n_next, P)
    return from_frame_4d(out.reshape(k, n, n_next, 4), frame, P)


@torch.no_grad()
def simulate(p: Params, obsv0: torch.Tensor, ids: torch.Tensor,
             noise: torch.Tensor, n_next: int, P: Precision,
             window: int = 0) -> torch.Tensor:
    """[N, W n_next, 2] world positions of W windows under ``noise`` [W, N,
    noise_len]: each window rolls out its canonical buffer and appends its
    world positions; the last ``n_past`` observe the next window."""
    p = rounded_params(p, P)
    n_past = obsv0.shape[1]
    obsv = P.store(obsv0.float())
    out = []
    for z in noise:
        obsv_in, frame, x4 = canonical(obsv, P)
        pred = rollout(p, obsv_in, x4, ids, P.store(z.float()), n_next, P,
                       window)
        pos = from_frame_4d(pred, frame, P)[..., :2]
        out.append(pos)
        obsv = torch.cat([obsv, pos], dim=1)[:, -n_past:]
    return torch.cat(out, dim=1)


def discriminator(p: Params, obsv_4d: torch.Tensor, pred_4d: torch.Tensor,
                  P: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(label [M, 1], code [M, n_codes]) of ``pred_4d`` [M, n_next, 4]
    against the observation code of ``obsv_4d`` [N, n_past, 4], tiled when
    M is a multiple of N."""
    hid = p["obsv_lstm.w"].shape[1] // 4
    h = c = torch.zeros(obsv_4d.shape[0], hid, device=obsv_4d.device)
    for t in range(obsv_4d.shape[1]):
        h, c = lstm(p, "obsv_lstm", obsv_4d[:, t], h, c, P)
    code = fc2(p, "obsv_fc", h, P)
    m = pred_4d.shape[0]
    if code.shape[0] != m:
        code = code.repeat(m // code.shape[0], 1)
    both = torch.cat([code, fc2(p, "pred_fc", pred_4d.reshape(m, -1), P)],
                     dim=-1)
    return fc2(p, "classifier", both, P), fc2(p, "latent_dec", both, P)


def generator_names() -> Tuple[str, ...]:
    names = ["embed", "encoder", "feat_mlp.0", "feat_mlp.1", "feat_mlp.2",
             "attn_w"] + [f"decoder.{k}" for k in range(4)]
    return tuple(f"{n}.{t}" for n in names for t in ("w", "b"))


def discriminator_names() -> Tuple[str, ...]:
    names = ["obsv_lstm", "obsv_fc.0", "obsv_fc.1", "pred_fc.0", "pred_fc.1",
             "classifier.0", "classifier.1", "latent_dec.0", "latent_dec.1"]
    return tuple(f"{n}.{t}" for n in names for t in ("w", "b"))


def shapes(hidden: int, feat: int, noise: int, n_next: int, n_codes: int,
           ) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape, generator then discriminator, at these widths."""
    d = hidden + feat + noise
    lin = {"embed": (4, hidden), "feat_mlp.0": (3, 32), "feat_mlp.1": (32, 64),
           "feat_mlp.2": (64, feat), "attn_w": (hidden, feat),
           "decoder.0": (d, d), "decoder.1": (d, d // 2),
           "decoder.2": (d // 2, d // 4), "decoder.3": (d // 4, 2),
           "obsv_fc.0": (hidden, hidden // 2),
           "obsv_fc.1": (hidden // 2, hidden // 2),
           "pred_fc.0": (n_next * 4, hidden // 2),
           "pred_fc.1": (hidden // 2, hidden // 2),
           "classifier.0": (hidden, hidden // 2), "classifier.1": (hidden // 2, 1),
           "latent_dec.0": (hidden, hidden // 2),
           "latent_dec.1": (hidden // 2, n_codes)}
    out: Dict[str, Tuple[int, ...]] = {}
    for name in generator_names() + discriminator_names():
        layer, leaf = name.rsplit(".", 1)
        if layer in ("encoder", "obsv_lstm"):
            rows = (hidden if layer == "encoder" else 4) + hidden
            out[name] = (rows, 4 * hidden) if leaf == "w" else (4 * hidden,)
        else:
            i, o = lin[layer]
            out[name] = (i, o) if leaf == "w" else (o,)
    return out


def fan_bound(name: str, shape_of: Dict[str, Tuple[int, ...]]) -> float:
    """torch's default init range of a leaf: 1/sqrt(fan_in) for a linear
    layer's weight and bias, 1/sqrt(hidden) for an LSTM's."""
    layer = name.rsplit(".", 1)[0]
    w = shape_of[layer + ".w"]
    if layer in ("encoder", "obsv_lstm"):
        return (w[1] // 4) ** -0.5
    return w[0] ** -0.5


def only(p: Params, names) -> Params:
    return {k: p[k] for k in names}
