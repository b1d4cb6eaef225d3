"""Social GAN's pooling module (``PoolHiddenNet``, sgan/models.py) in plain
torch: the dense form, the blocked form and the scene-window form.

For every agent i and every agent j of its scene, i itself included, the
pair MLP reads where j stands from i and j's encoding::

    e_ij = (p_j - p_i) W_pe + b_pe                       2 -> 16
    b_ij = relu(relu([e_ij ; h_j] W_1 + b_1) W_2 + b_2)  48 -> 512 -> 32
    P_i  = max_j b_ij                                    element-wise

Padded rows (scene id -1) pair with nothing and get zeros.  These forms
are the CPU path and the oracle of the CUDA kernel
(``kernels/social_pool.py``): the dense form holds N x N pairs and serves
small N; the blocked form streams row blocks against column blocks
(O(N^2) work, O(block^2 512) memory); the scene-window form, for sorted,
contiguous scenes of at most ``max_scene`` rows, scores each row block
against the columns within ``max_scene`` rows of it (O(N max_scene)).

Mixed precision (``op_dtype`` bf16, the port's contract): positions, h
and the weights come in as bf16 values; ``p_j - p_i`` and ``e_ij`` are
rounded to bf16 (each a stored activation), every product sums in
float32 with the bias added in float32, the relu of layer 1 is rounded
to bf16 (the operand of layer 2), and layer 2's relu and the max run on
float32 values.  The result is float32; callers cast it.  Only the order
of the float32 sums differs from the kernel's.  Because every b_ij is a
relu, a masked pair can enter the max as 0: it never exceeds a row's own
pair (i, i), which every valid row has.
"""

from __future__ import annotations

import torch

from socialways_torch.ops.nn import MLP, Linear, linear_apply, wide
from socialways_torch.ops.social import round_to

#: rows at most for which ``social_pool_plain`` takes the dense form
DENSE_MAX_AGENTS = 256


def _columns(pool_mlp: MLP, h_j: torch.Tensor, acc: torch.dtype
             ) -> torch.Tensor:
    """h_j W_1h + b_1 [J, 512] in the wide dtype: the part of layer 1
    that only the column reads."""
    w1 = pool_mlp[0].w
    emb = w1.shape[0] - h_j.shape[1]
    return (torch.matmul(h_j.to(acc), w1[emb:].to(acc))
            + pool_mlp[0].b.to(acc))


def _pair_max(pool_embed: Linear, pool_mlp: MLP, p_i: torch.Tensor,
              p_j: torch.Tensor, col: torch.Tensor, mask: torch.Tensor,
              op: torch.dtype) -> torch.Tensor:
    """max over the columns of b_ij [I, 32] (wide), pairs off ``mask``
    entering as 0.  ``col`` = ``_columns`` of the J columns."""
    acc = wide(op)
    rel = p_j[None, :, :] - p_i[:, None, :]           # rounded to op
    e = linear_apply(pool_embed, rel)
    w1 = pool_mlp[0].w
    z1 = torch.matmul(e.to(acc), w1[:e.shape[-1]].to(acc)) + col[None]
    z1 = round_to(torch.relu(z1), op)
    z2 = torch.relu(linear_apply(pool_mlp[1], z1))
    return torch.where(mask[..., None], z2, 0.0).amax(dim=1)


def _mask(ids_i: torch.Tensor, ids_j: torch.Tensor) -> torch.Tensor:
    return (ids_i[:, None] == ids_j[None, :]) & (ids_i[:, None] >= 0)


def social_pool_dense(pool_embed: Linear, pool_mlp: MLP, pos: torch.Tensor,
                      h: torch.Tensor, scene_ids: torch.Tensor
                      ) -> torch.Tensor:
    """P [N, bottleneck] (wide dtype) over all N x N pairs."""
    op = h.dtype
    col = _columns(pool_mlp, h, wide(op))
    return _pair_max(pool_embed, pool_mlp, pos, pos, col,
                     _mask(scene_ids, scene_ids), op)


def social_pool_blocked(pool_embed: Linear, pool_mlp: MLP,
                        pos: torch.Tensor, h: torch.Tensor,
                        scene_ids: torch.Tensor, block: int = 64
                        ) -> torch.Tensor:
    """The dense form's P, row blocks against column blocks with a running
    max."""
    n, op = h.shape[0], h.dtype
    width = pool_mlp[-1].w.shape[1]
    out = torch.zeros((n, width), dtype=wide(op), device=h.device)
    for j0 in range(0, n, block):
        col = _columns(pool_mlp, h[j0:j0 + block], wide(op))
        for i0 in range(0, n, block):
            mask = _mask(scene_ids[i0:i0 + block], scene_ids[j0:j0 + block])
            if not bool(mask.any()):
                continue
            part = _pair_max(pool_embed, pool_mlp, pos[i0:i0 + block],
                             pos[j0:j0 + block], col, mask, op)
            out[i0:i0 + block] = torch.maximum(out[i0:i0 + block], part)
    return out


def social_pool_windowed(pool_embed: Linear, pool_mlp: MLP,
                         pos: torch.Tensor, h: torch.Tensor,
                         scene_ids: torch.Tensor, max_scene: int,
                         block: int = 64) -> torch.Tensor:
    """The dense form's P for sorted, contiguous scenes of at most
    ``max_scene`` rows (padding -1): row block [i0, i1) against the
    columns [i0 - max_scene, i1 + max_scene), which hold every partner."""
    n, op = h.shape[0], h.dtype
    outs = []
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        j0, j1 = max(0, i0 - max_scene), min(n, i1 + max_scene)
        col = _columns(pool_mlp, h[j0:j1], wide(op))
        outs.append(_pair_max(pool_embed, pool_mlp, pos[i0:i1], pos[j0:j1],
                              col, _mask(scene_ids[i0:i1],
                                         scene_ids[j0:j1]), op))
    return torch.cat(outs) if outs else h.new_zeros(
        (0, pool_mlp[-1].w.shape[1]), dtype=wide(op))


def social_pool_plain(pool_embed: Linear, pool_mlp: MLP, pos: torch.Tensor,
                      h: torch.Tensor, scene_ids: torch.Tensor,
                      max_scene: int = 0) -> torch.Tensor:
    """The size-aware plain pool: dense up to ``DENSE_MAX_AGENTS`` rows,
    else the scene-window form (``max_scene`` > 0) or the blocked one."""
    n = h.shape[0]
    if n <= DENSE_MAX_AGENTS:
        return social_pool_dense(pool_embed, pool_mlp, pos, h, scene_ids)
    if max_scene > 0:
        return social_pool_windowed(pool_embed, pool_mlp, pos, h,
                                    scene_ids, max_scene)
    return social_pool_blocked(pool_embed, pool_mlp, pos, h, scene_ids)
