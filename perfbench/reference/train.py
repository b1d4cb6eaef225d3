"""The Social Ways training step, plainly: the data's split, normalization
and greedy scene packing, and one unrolled LSGAN + InfoGAN step with Adam
and the generator's EMA.

Data (reference train.py:89-124, 446-456): the first 4/5 of the scene
batches train; positions are mapped into the unit box by one scale for
both axes (the smaller of 1/range x and 1/range y) after subtracting the
box's minimum; scenes are grouped greedily in order while a chunk stays
within ``batch_size`` rows, and every chunk is padded to one width
(scene ids local to the chunk, -1 for padding).

One step on a chunk (the record real-data arm: agent frame, social
attention, EMA, D instance noise), given its draws:
1. canonicalize to each agent's frame (origin the last observed point, +x
   the last observed step); the social geometry keeps the world frame;
2. one generator rollout ``pred_hat``;
3. sigma = max(floor, noise (1 - g_count / anneal_steps)), with the G
   optimizer's count before the update; D sees ``pred_hat + sigma eps_fake``
   and the truth plus ``sigma eps_real``;
4. 1 + ``n_unroll`` D updates with Adam on the LSGAN loss (fake labels to
   the smoothed zero, real to the smoothed one) plus ``info_w`` times the
   Q-head's MSE to the first ``n_codes`` noise dims; D is kept after the
   first update;
5. G updates against the unrolled D on ``pred_hat + sigma eps_g``: the
   fooling MSE plus the same info term;
6. the EMA of G; D restored to its copy after the first update (its
   optimizer keeps every update).
Losses are means over valid rows.  Adam is optax's: eps outside the root,
bias corrections from the count after the update.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference.model import (Params, canonical, discriminator,
                                       discriminator_names, generator_names,
                                       pred_to_4d, rollout, to_4d, to_frame)
from perfbench.reference.precision import Precision


def normalize(obsvs: np.ndarray, preds: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    pts = np.concatenate([obsvs.reshape(-1, 2), preds.reshape(-1, 2)])
    lo = pts.min(axis=0).astype(np.float64)
    hi = pts.max(axis=0).astype(np.float64)
    s = min(1.0 / (hi[0] - lo[0]), 1.0 / (hi[1] - lo[1]))

    def norm(a):
        out = np.array(a, dtype=np.float32, copy=True)
        out[..., 0] = (out[..., 0] - float(lo[0])) * s
        out[..., 1] = (out[..., 1] - float(lo[1])) * s
        return out
    return norm(obsvs), norm(preds)


def train_chunks(obsvs: np.ndarray, preds: np.ndarray, batches: np.ndarray,
                 batch_size: int) -> Dict[str, np.ndarray]:
    """The training split packed into chunks: obsvs [C, W, T, 2], preds,
    scene_ids [C, W] and valid [C, W], normalized."""
    obsvs, preds = normalize(obsvs, preds)
    train = batches[:max(1, len(batches) * 4 // 5)]
    sizes = [int(e - s) for s, e in train]
    groups, cur, acc = [], [], 0
    for i, size in enumerate(sizes):
        cur.append(i)
        acc += size
        nxt = sizes[i + 1] if i + 1 < len(sizes) else 0
        if i == len(sizes) - 1 or acc + nxt > batch_size:
            groups.append(cur)
            cur, acc = [], 0
    width = max([batch_size] + [sum(sizes[i] for i in g) for g in groups])
    c, t_o, t_p = len(groups), obsvs.shape[1], preds.shape[1]
    out = {"obsvs": np.zeros((c, width, t_o, 2), np.float32),
           "preds": np.zeros((c, width, t_p, 2), np.float32),
           "scene_ids": np.full((c, width), -1, np.int32),
           "valid": np.zeros((c, width), bool)}
    for ci, grp in enumerate(groups):
        row = 0
        for local, bi in enumerate(grp):
            s, e = int(train[bi][0]), int(train[bi][1])
            out["obsvs"][ci, row:row + e - s] = obsvs[s:e]
            out["preds"][ci, row:row + e - s] = preds[s:e]
            out["scene_ids"][ci, row:row + e - s] = local
            out["valid"][ci, row:row + e - s] = True
            row += e - s
    return out


class Adam:
    """optax.adam on a dict of leaves: moments, an int count, lr."""

    def __init__(self, params: Params, lr: float, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def _corr(self, b: float, like: torch.Tensor) -> torch.Tensor:
        base = torch.tensor(b, dtype=torch.float32).double()
        return 1.0 - (base ** self.count).float().to(like.device)

    @torch.no_grad()
    def step(self, params: Params, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        for k, g in grads.items():
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            m_hat = self.mu[k] / self._corr(self.b1, g)
            v_hat = self.nu[k] / self._corr(self.b2, g)
            params[k].add_(m_hat / (torch.sqrt(v_hat) + self.eps)
                           * -self.lr)


def _mse(pred, target, valid) -> torch.Tensor:
    sq = (pred - target) ** 2
    v = valid.reshape(valid.shape + (1,) * (sq.dim() - valid.dim()))
    per = 1
    for d in sq.shape[valid.dim():]:
        per *= d
    return torch.where(v, sq, 0.0).sum() / max(int(valid.sum()) * per, 1)


class TrainReference:
    """G, D, their Adam states and the EMA, stepped chunk by chunk.

    ``cfg``: hidden_size, n_next, n_latent_codes, loss_info_w, lr_g, lr_d,
    adam_b1, adam_b2, g_ema_decay, n_unrolling_steps, d_input_noise,
    d_input_noise_floor and ``anneal_steps`` (the resolved count)."""

    def __init__(self, params: Params, cfg: Dict, P: Precision):
        self.cfg, self.P = cfg, P
        self.g = {k: params[k].clone() for k in generator_names()}
        self.d = {k: params[k].clone() for k in discriminator_names()}
        self.ema = {k: v.clone() for k, v in self.g.items()}
        b = (cfg["adam_b1"], cfg["adam_b2"])
        self.g_opt = Adam(self.g, cfg["lr_g"], *b)
        self.d_opt = Adam(self.d, cfg["lr_d"], *b)

    def _sigma(self) -> float:
        c = self.cfg
        frac = max(0.0, 1.0 - self.g_opt.count / c["anneal_steps"])
        return max(c["d_input_noise_floor"], c["d_input_noise"] * frac)

    def step(self, chunk: Dict[str, torch.Tensor], draws: Dict
             ) -> Tuple[float, float]:
        """One GAN step in place; returns (first D loss, G loss)."""
        cfg, P = self.cfg, self.P
        valid, ids = chunk["valid"], chunk["scene_ids"]
        obsv, frame, x4 = canonical(chunk["obsvs"], P)
        pred = to_frame(chunk["preds"], frame, P)
        obsv_4d, pred_4d = to_4d(obsv, P), pred_to_4d(obsv, pred)
        n = obsv.shape[0]
        zeros = torch.zeros(n, 1, device=obsv.device) + draws["zero_label"]
        ones = torch.ones(n, 1, device=obsv.device) * draws["one_label"]
        noise, codes = draws["noise"], cfg["n_latent_codes"]
        info_w = cfg["loss_info_w"]
        sigma = torch.tensor(self._sigma(), dtype=torch.float32)

        g_leaves = {k: v.requires_grad_(True) for k, v in self.g.items()}
        pred_hat = rollout(g_leaves, obsv, x4, ids, noise, cfg["n_next"], P)
        fake = pred_hat.detach() + sigma * draws["eps_fake"]
        real = pred_4d + sigma * draws["eps_real"]

        def d_loss(d):
            labels, code = discriminator(d, obsv_4d, torch.cat([fake, real]),
                                         P)
            return (_mse(labels[:n], zeros, valid)
                    + _mse(labels[n:], ones, valid)
                    + info_w * _mse(code[:n], noise[:, :codes], valid))

        d_first, backup = None, None
        for u in range(cfg["n_unrolling_steps"] + 1):
            d_leaves = {k: v.detach().requires_grad_(True)
                        for k, v in self.d.items()}
            loss = d_loss(d_leaves)
            grads = torch.autograd.grad(loss, list(d_leaves.values()))
            self.d_opt.step(self.d, dict(zip(d_leaves, grads)))
            if u == 0:
                d_first = float(loss.detach())
                backup = {k: v.clone() for k, v in self.d.items()}

        label, code = discriminator(self.d, obsv_4d,
                                    pred_hat + sigma * draws["eps_g"], P)
        g_loss = (_mse(label, ones, valid)
                  + info_w * _mse(code, noise[:, :codes], valid))
        grads = torch.autograd.grad(g_loss, list(g_leaves.values()))
        for v in self.g.values():
            v.requires_grad_(False)
        self.g_opt.step(self.g, dict(zip(g_leaves, grads)))
        decay = cfg["g_ema_decay"]
        with torch.no_grad():
            for k, v in self.ema.items():
                v.mul_(decay).add_(self.g[k], alpha=1.0 - decay)
        if cfg["n_unrolling_steps"] > 0:
            self.d = backup
        return d_first, float(g_loss.detach())


def leaf_norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in t.items()}


def first_moments(ref: TrainReference) -> Dict[str, torch.Tensor]:
    out = {f"g.{k}": v.clone() for k, v in ref.g_opt.mu.items()}
    out.update({f"d.{k}": v.clone() for k, v in ref.d_opt.mu.items()})
    return out


def params_of(ref: TrainReference) -> Dict[str, torch.Tensor]:
    out = {f"g.{k}": v.detach().clone() for k, v in ref.g.items()}
    out.update({f"d.{k}": v.detach().clone() for k, v in ref.d.items()})
    return out

