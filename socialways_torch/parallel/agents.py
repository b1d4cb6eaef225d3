"""Agents-axis sharded social attention (counterpart of
socialways_tpu/parallel/agents.py).

Data parallelism keeps whole scenes on one rank; when one scene's agents
exceed a device (the 10k-agent regime), the agents x neighbours attention
itself shards.  The agents axis is split over the mesh's ranks, each rank
holding rows [r N_local, (r + 1) N_local).  :func:`sharded_social_context`
gathers the small per-agent keys (last-frame state, hidden state, scene
id) with one all-gather and computes its local rows of the N_local x
N_global attention; :func:`ring_social_context` passes the key block round
the ring of ranks instead, point to point, with a streaming softmax, so a
rank holds one remote block at a time.

Both are plain torch, as JAX's are plain XLA (no ``pallas_call``): the
dense [N_local, N_global, F] pair embedding, in the operands' dtype.  They
take no gradient (the simulator's forward).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from socialways_torch.ops.nn import linear_apply, mlp_apply
from socialways_torch.ops.social import safe_norm
from socialways_torch.parallel.mesh import Mesh, all_gather_rows

_NEG = -1e9


def _block_scores(feat_mlp, attn_w, x4_last, scene_ids, x4_j, h_j, ids_j,
                  row_g, col_g):
    """Masked scores of the local queries against ONE neighbour block:
    (scores [N_local, N_block] with -1e9 at masked pairs, mask).  The math
    of ops.social.social_features and attention_pool's score side (the
    same 1e-6 epsilons; JAX's :97-124)."""
    p_i, v_i = x4_last[:, :2], x4_last[:, 2:]
    dp = p_i[:, None, :] - x4_j[None, :, :2]
    dv = v_i[:, None, :] - x4_j[None, :, 2:]
    dist_ = safe_norm(dp)
    bearing = (torch.einsum("ijk,ik->ij", dp, v_i)
               / (dist_ * safe_norm(v_i)[:, None] + 1e-6))
    ttca = -torch.sum(dp * dv, dim=-1) / (torch.sum(dv * dv, dim=-1) + 1e-6)
    dca = safe_norm(dp + ttca[..., None] * dv)
    f_emb = mlp_apply(feat_mlp, torch.stack([dist_, bearing, dca], dim=-1))
    wh_j = linear_apply(attn_w, h_j)
    scores = torch.einsum("ijf,jf->ij", f_emb, wh_j)
    mask = ((scene_ids[:, None] == ids_j[None, :])
            & (scene_ids[:, None] >= 0) & (ids_j[None, :] >= 0)
            & (row_g != col_g))
    return torch.where(mask, scores, _NEG), mask


def _rows(n: int, origin: int, device) -> torch.Tensor:
    """Global indices of the n rows that started on rank ``origin``."""
    return origin * n + torch.arange(n, device=device)


@torch.no_grad()
def sharded_social_context(g_params, x4_last: torch.Tensor, h: torch.Tensor,
                           scene_ids: torch.Tensor, mesh: Mesh
                           ) -> torch.Tensor:
    """The social context of this rank's agents (x4_last [N_local, 4], h
    [N_local, H], scene_ids [N_local]) against every agent of the mesh:
    one all-gather of the keys, self-exclusion by global index.  The
    generator ``g_params`` gives ``feat_mlp`` and ``attn_w``."""
    x4_all = all_gather_rows(x4_last, mesh)
    h_all = all_gather_rows(h, mesh)
    ids_all = all_gather_rows(scene_ids, mesh)
    n = x4_last.shape[0]
    row_g = _rows(n, mesh.rank, h.device)[:, None]
    col_g = torch.arange(x4_all.shape[0], device=h.device)[None, :]
    scores, mask = _block_scores(g_params.feat_mlp, g_params.attn_w, x4_last,
                                 scene_ids, x4_all, h_all, ids_all, row_g,
                                 col_g)
    smax = torch.max(scores, dim=-1, keepdim=True).values
    unnorm = torch.where(mask, torch.exp(scores - smax), 0.0)
    denom = torch.sum(unnorm, dim=-1, keepdim=True)
    pooled = (unnorm / torch.clamp(denom, min=1e-20)) @ h_all
    return torch.where(torch.any(mask, dim=-1, keepdim=True), pooled, 0.0)


@torch.no_grad()
def ring_social_context(g_params, x4_last: torch.Tensor, h: torch.Tensor,
                        scene_ids: torch.Tensor, mesh: Mesh
                        ) -> torch.Tensor:
    """The ring form: at hop r each rank scores its queries against the
    block that started on rank (rank - r) mod D, folds it into a streaming
    masked softmax, and passes the block to rank + 1.  Hop r + 1's
    send and receive are posted before hop r's compute, so the transfer
    runs under it (JAX's :127-171).  Equals :func:`sharded_social_context`
    up to float reassociation of the softmax.  Needs a backend that sends
    the operands' device type point to point: gloo aborts the process on
    CUDA tensors (writev: Bad address), so that pairing raises here."""
    if h.is_cuda and dist.get_backend() == "gloo":
        raise RuntimeError("ring_social_context: gloo cannot send CUDA "
                           "tensors point to point; use NCCL or "
                           "neighbor_exchange='gather'")
    d, n, me = mesh.size, x4_last.shape[0], mesh.rank
    row_g = _rows(n, me, h.device)[:, None]
    m = torch.full((n, 1), _NEG, dtype=x4_last.dtype, device=h.device)
    l = torch.zeros((n, 1), dtype=x4_last.dtype, device=h.device)
    acc = torch.zeros_like(h)
    block = (x4_last.contiguous(), h.contiguous(), scene_ids.contiguous())
    peers = [(me + 1) % d, (me - 1) % d]
    for r in range(d):
        pending: Optional[list] = None
        if r < d - 1:
            nxt = tuple(torch.empty_like(t) for t in block)
            ops = [dist.P2POp(dist.isend, t, peers[0]) for t in block]
            ops += [dist.P2POp(dist.irecv, t, peers[1]) for t in nxt]
            pending = dist.batch_isend_irecv(ops)
        x4_j, h_j, ids_j = block
        col_g = _rows(n, (me - r) % d, h.device)[None, :]
        scores, mask = _block_scores(g_params.feat_mlp, g_params.attn_w,
                                     x4_last, scene_ids, x4_j, h_j, ids_j,
                                     row_g, col_g)
        m_new = torch.maximum(m, torch.max(scores, dim=-1,
                                           keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(scores - m_new), 0.0)
        acc = acc * corr + p @ h_j
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        m = m_new
        if pending is not None:
            for work in pending:
                work.wait()
            block = nxt
    return torch.where(l > 0, acc / torch.clamp(l, min=1e-20), 0.0)


def make_sharded_social_context(g_params, mesh: Mesh):
    """``fn(x4, h, ids)`` on this rank's agents: the gathered form bound to
    the generator's weights (JAX's ``shard_map`` wrapper)."""
    def fn(x4, h, ids):
        return sharded_social_context(g_params, x4, h, ids, mesh)
    return fn
