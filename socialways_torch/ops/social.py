"""Dense social features and masked attention pooling.

Counterpart of socialways_tpu/ops/social.py:29-111 (reference
train.py:153-241).  One batched N x N computation with a scene-membership
mask replaces the reference's per-scene loops; padded rows (scene id -1)
are masked out.  This is the plain version of the CUDA kernel in
``kernels/social_attention.py``: the CPU path and the kernel's oracle.

Features per ordered pair (i, j), from last-observed states x = (p, v):
- distance ``‖p_i − p_j‖``;
- bearing ``(Δp·v_i) / (‖Δp‖‖v_i‖ + 1e-6)`` with Δp = p_i − p_j;
- distance of closest approach ``‖Δp + ttca·Δv‖``,
  ``ttca = −(Δp·Δv)/(‖Δv‖² + 1e-6)`` (not clamped).
"""

from __future__ import annotations

from typing import Optional

import torch

from socialways_torch.ops.nn import Linear, linear_apply

_NEG_INF = -1e9


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """‖x‖ whose gradient at x = 0 is 0 instead of NaN; value-exact."""
    sq = torch.sum(x * x, dim=dim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def social_features(x4d_last: torch.Tensor,
                    x4d_cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, 4] (px, py, vx, vy) -> [N, N, 3] (dist, bearing, dca); entry
    [i, j] describes agent j as seen from agent i.  ``x4d_cols`` gives the
    seen agents' states separately (default: the same tensor), so that a
    gradient can be taken on the seeing and the seen side apart."""
    cols = x4d_last if x4d_cols is None else x4d_cols
    p = x4d_last[:, :2]
    v = x4d_last[:, 2:]
    dp = p[:, None, :] - cols[None, :, :2]
    dv = v[:, None, :] - cols[None, :, 2:]

    dist = safe_norm(dp)
    dot_dp_v = torch.einsum("ijk,ik->ij", dp, v)
    v_norm = safe_norm(v)
    bearing = dot_dp_v / (dist * v_norm[:, None] + 1e-6)

    dot_dp_dv = torch.sum(dp * dv, dim=-1)
    dv_sq = torch.sum(dv * dv, dim=-1) + 1e-6
    ttca = -dot_dp_dv / dv_sq
    dca = safe_norm(dp + ttca[..., None] * dv)
    return torch.stack([dist, bearing, dca], dim=-1)


def scene_mask(scene_ids: torch.Tensor) -> torch.Tensor:
    """[N] scene ids (-1 = padding) -> [N, N] bool: same scene, both
    valid, i != j."""
    valid = scene_ids >= 0
    same = scene_ids[:, None] == scene_ids[None, :]
    both_valid = valid[:, None] & valid[None, :]
    not_self = ~torch.eye(scene_ids.shape[0], dtype=torch.bool,
                          device=scene_ids.device)
    return same & both_valid & not_self


def attention_pool(w: Linear, f_emb: torch.Tensor, h: torch.Tensor,
                   neighbor_mask: torch.Tensor) -> torch.Tensor:
    """Scores σ_ij = f_ij · (W h_j), masked softmax over each agent's scene
    neighbours, S_i = Σ_j a_ij h_j.  A row with no neighbour gives 0."""
    wh = linear_apply(w, h)
    scores = torch.einsum("ijf,jf->ij", f_emb, wh)
    scores = torch.where(neighbor_mask, scores, _NEG_INF)
    scores_max = torch.max(scores, dim=-1, keepdim=True).values
    unnorm = torch.where(neighbor_mask, torch.exp(scores - scores_max), 0.0)
    denom = torch.sum(unnorm, dim=-1, keepdim=True)
    attn = unnorm / torch.clamp(denom, min=1e-20)
    pooled = attn @ h
    has_neighbor = torch.any(neighbor_mask, dim=-1, keepdim=True)
    return torch.where(has_neighbor, pooled, 0.0)
