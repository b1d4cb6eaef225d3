"""Social features and masked attention pooling: the dense form and the
two memory-bounded forms of crowd scale.

Counterpart of socialways_tpu/ops/social.py (reference train.py:153-241).
One batched N x N computation with a scene-membership mask replaces the
reference's per-scene loops; padded rows (scene id -1) are masked out.
The dense form is the plain version of the CUDA kernel in
``kernels/social_attention.py``: the CPU path and the kernel's oracle at
small N.  Above the dense size the CPU takes ``social_context_blockwise``
(O(N^2) work, O(N block) memory) or, when scenes are sorted, contiguous
and at most ``max_scene`` rows, ``social_context_windowed`` (O(N
max_scene)); windowed is also the plain version the kernels' scene-window
scan is held against on the card.

bf16 operands (``h`` bf16, socialways_tpu/kernels/social_attention.py:
96-105, 183-185, 248-258): every form computes the Pallas kernel's
contract, which the CUDA kernels compute too.  Features in float32 from
``x4`` in float32; the features, a1, a2 and the MLP's weights and biases
rounded to bf16 before each of the MLP's three products, which accumulate
in float32; relu masks from the float32 pre-activations; ``wh = h W + b``
in float32, then bf16; scores, softmax, ``m`` and ``l`` in float32, ``l``
summed from the unrounded ``p``; ``p`` rounded to bf16 before ``p . h``; a
float32 output, which the callers cast to bf16.  Under autograd the
roundings pass float32 cotangents straight through, as the backward
kernels keep them (``round_to``, ``attention_values``, ``pool``).  JAX's
all-bf16 XLA form (``_xla_reference`` under bf16) is not ported: the
port's card path is the kernel everywhere, and the CPU computes what the
card computes.

Features per ordered pair (i, j), from last-observed states x = (p, v):
- distance ``‖p_i − p_j‖``;
- bearing ``(Δp·v_i) / (‖Δp‖‖v_i‖ + 1e-6)`` with Δp = p_i − p_j;
- distance of closest approach ``‖Δp + ttca·Δv‖``,
  ``ttca = −(Δp·Δv)/(‖Δv‖² + 1e-6)`` (not clamped).
"""

from __future__ import annotations

from typing import Optional

import torch

from socialways_torch.ops.lstm import remat_call
from socialways_torch.ops.nn import MLP, Linear, linear_apply, wide

_NEG_INF = -1e9


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``'s precision, kept in ``x``'s dtype; the
    identity under autograd (a float32 cotangent passes unrounded).  ``r -
    x`` is exact, so ``x + (r - x)`` is ``r``.  The identity where
    ``dtype`` is as wide as its sums (float32, float64)."""
    if wide(dtype) == dtype:
        return x
    return x + (x.to(dtype).to(x.dtype) - x).detach()


def pair_embed(feat_mlp: MLP, xi: torch.Tensor,
               xj: Optional[torch.Tensor] = None,
               op_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pair embeddings ``[.., F]`` in float32 (float64 for float64
    operands): the feature MLP on ``social_features(xi, xj)`` with
    ``op_dtype`` operands.  Each layer's input, weight and bias are
    rounded to ``op_dtype`` (no-ops for float32), the product and the bias
    add run in the wide dtype and relu takes the wide result (the Pallas
    kernel's ``_pair_embed``)."""
    acc = wide(op_dtype)
    x = social_features(xi.to(acc), None if xj is None else xj.to(acc))
    for k, layer in enumerate(feat_mlp):
        if k:
            x = torch.relu(x)
        x = (torch.matmul(round_to(x, op_dtype),
                          round_to(layer.w.to(acc), op_dtype))
             + round_to(layer.b.to(acc), op_dtype))
    return x


def attention_values(w: Linear, hf: torch.Tensor, op_dtype: torch.dtype
                     ) -> torch.Tensor:
    """``wh = h W + b`` in float32 from float32 ``hf``, rounded to
    ``op_dtype`` (the Pallas wrapper's ``wh``, :252-254) with a float32
    gradient: dL/dwh stays float32 up to dW = h^T dwh and dh = dwh W^T, and
    ``h``'s gradient is rounded once, after both of its paths are summed,
    as JAX rounds it (:585-591)."""
    return round_to(linear_apply(w, hf), op_dtype)


def pool(p: torch.Tensor, hf: torch.Tensor,
         op_dtype: torch.dtype) -> torch.Tensor:
    """``p @ h`` in float32 from float32 weights ``p`` and values ``hf``.
    For bf16 operands ``p`` is rounded to bf16 first (the Pallas kernel's
    ``p . h``), and under autograd both factors see the unrounded ``p``, as
    the backward kernels do (dh_j = sum_i a_ij g_i)."""
    if wide(op_dtype) == op_dtype:
        return p @ hf
    return p @ hf + ((round_to(p, op_dtype) - p) @ hf).detach()


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
    neighbours, S_i = Σ_j a_ij h_j.  A row with no neighbour gives 0.
    bf16 ``h``: ``(pool(p, h) / l)`` in float32, the Pallas kernel's order;
    the result stays float32."""
    hf = h.to(wide(h.dtype))
    wh = attention_values(w, hf, h.dtype)
    scores = torch.einsum("ijf,jf->ij", f_emb, wh)
    scores = torch.where(neighbor_mask, scores, _NEG_INF)
    scores_max = torch.max(scores, dim=-1, keepdim=True).values
    unnorm = torch.where(neighbor_mask, torch.exp(scores - scores_max), 0.0)
    denom = torch.sum(unnorm, dim=-1, keepdim=True)
    if hf.dtype == h.dtype:
        pooled = (unnorm / torch.clamp(denom, min=1e-20)) @ h
    else:
        pooled = pool(unnorm, hf, h.dtype) / torch.clamp(denom, min=1e-20)
    has_neighbor = torch.any(neighbor_mask, dim=-1, keepdim=True)
    return torch.where(has_neighbor, pooled, 0.0)


def _pad_rows(x4: torch.Tensor, h: torch.Tensor, ids: torch.Tensor,
              n_pad: int):
    """Append ``n_pad`` rows of zeros with scene id -1."""
    if not n_pad:
        return x4, h, ids
    return (torch.cat([x4, x4.new_zeros((n_pad, 4))]),
            torch.cat([h, h.new_zeros((n_pad, h.shape[1]))]),
            torch.cat([ids, ids.new_full((n_pad,), -1)]))


def _masked_scores(feat_mlp: MLP, xi, xj, whj, idsi, idsj, i0, j0, op_dtype):
    """Scores of rows ``xi`` (global index i0 + r) against columns ``xj``
    (j0 + c), -1e9 off the same-scene, both-valid, not-self mask; and the
    mask.  ``whj`` float32; the MLP takes ``op_dtype`` operands."""
    scores = torch.einsum("ijf,jf->ij",
                          pair_embed(feat_mlp, xi, xj, op_dtype), whj)
    row_g = i0 + torch.arange(xi.shape[0], device=xi.device)[:, None]
    col_g = j0 + torch.arange(xj.shape[0], device=xi.device)[None, :]
    mask = ((idsi[:, None] == idsj[None, :]) & (idsi[:, None] >= 0)
            & (idsj[None, :] >= 0) & (row_g != col_g))
    return torch.where(mask, scores, _NEG_INF), mask


def social_context_blockwise(feat_mlp: MLP, attn_w: Linear,
                             x4_last: torch.Tensor, h: torch.Tensor,
                             scene_ids: torch.Tensor,
                             block: int = 64) -> torch.Tensor:
    """Memory-bounded social context (socialways_tpu/ops/social.py:114-189):
    the dense form's math streamed over column blocks with an online
    softmax (m, l, acc), O(N block F) memory instead of O(N^2 F).  Each
    block runs under a non-reentrant checkpoint when a graph is recorded,
    so the backward recomputes it and keeps its memory bounded too.  The
    output has ``h``'s dtype."""
    n, hdim = h.shape
    op = h.dtype
    x4_p, h_p, ids_p = _pad_rows(x4_last, h.to(wide(op)), scene_ids,
                                 (-n) % block)
    n_tot = x4_p.shape[0]

    def tile(m, l, acc, j0):
        xj, hj = x4_p[j0:j0 + block], h_p[j0:j0 + block]
        scores, mask = _masked_scores(
            feat_mlp, x4_p, xj, attention_values(attn_w, hj, op), ids_p,
            ids_p[j0:j0 + block], 0, j0, op)
        m_new = torch.maximum(m, scores.max(dim=-1, keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(scores - m_new), 0.0)
        return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
                acc * corr + pool(p, hj, op))

    m = h_p.new_full((n_tot, 1), _NEG_INF)
    l = h_p.new_zeros((n_tot, 1))
    acc = h_p.new_zeros((n_tot, hdim))
    for j0 in range(0, n_tot, block):
        m, l, acc = remat_call(True, tile, m, l, acc, j0)
    out = torch.where(l > 0, acc / torch.clamp(l, min=1e-20), 0.0)
    return out[:n].to(op)


def social_context_windowed(feat_mlp: MLP, attn_w: Linear,
                            x4_last: torch.Tensor, h: torch.Tensor,
                            scene_ids: torch.Tensor, max_scene: int,
                            block: int = 512) -> torch.Tensor:
    """Linear-time social context (socialways_tpu/ops/social.py:192-276)
    for sorted, contiguous scenes of at most ``max_scene`` rows (padding
    -1): a row's partners lie within ``max_scene`` rows of it, so each row
    block scores only a window of ``block + 2 max_scene`` columns starting
    at ``clip(i0 - max_scene, 0, n_tot - win)``.  O(N max_scene) work and
    memory; each block is checkpointed as in the blockwise form.  When the
    window would cover every row it falls back to the blockwise form at
    ``min(block, 256)``.  The output has ``h``'s dtype."""
    n, hdim = h.shape
    w = max_scene
    n_tot = n + (-n) % block
    win = block + 2 * w
    if win >= n_tot:
        return social_context_blockwise(feat_mlp, attn_w, x4_last, h,
                                        scene_ids, block=min(block, 256))
    op = h.dtype
    x4_p, h_p, ids_p = _pad_rows(x4_last, h.to(wide(op)), scene_ids,
                                 n_tot - n)
    wh_p = attention_values(attn_w, h_p, op)

    def one_block(i0):
        j0 = min(max(i0 - w, 0), n_tot - win)
        scores, mask = _masked_scores(
            feat_mlp, x4_p[i0:i0 + block], x4_p[j0:j0 + win],
            wh_p[j0:j0 + win], ids_p[i0:i0 + block], ids_p[j0:j0 + win],
            i0, j0, op)
        m = scores.max(dim=-1, keepdim=True).values
        p = torch.where(mask, torch.exp(scores - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        pooled = pool(p, h_p[j0:j0 + win], op)
        return torch.where(l > 0, pooled / torch.clamp(l, min=1e-20), 0.0)

    outs = [remat_call(True, one_block, i0) for i0 in range(0, n_tot, block)]
    return torch.cat(outs)[:n].to(op)
