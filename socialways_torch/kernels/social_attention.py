"""Social attention: the hand-written CUDA kernels, their plain versions and
the autograd Function that ties them together.

``social_attention_fwd`` computes
``attention_pool(attn_w, mlp(feat_mlp, social_features(x4)), h,
scene_mask(ids))`` (ops/social.py) and, under autograd, its gradient.

Source notes.
- Forward (csrc/social_attention_fwd.cu) replaces the Pallas TPU kernel
  ``_kernel`` of socialways_tpu/kernels/social_attention.py:150-198, driven
  by ``_pallas_forward`` (:219-314).  The TPU kernel kept all agents
  resident in VMEM and skipped j-tiles outside a band computed from sorted
  scene ids; the CUDA kernel gives each query row one warp, stages only the
  feature-MLP weights in shared memory, tests the scene mask before any
  pair work, and so needs neither the VMEM agent caps nor sorted ids.
  Under autograd it also writes the per-row softmax stats (m, l).
- Backward (csrc/social_attention_bwd.cu) replaces ``_bwd_dq_kernel``
  (:317-369) and ``_bwd_dkv_kernel`` (:372-461), driven by
  ``_pallas_backward`` (:464-591): dq gives dL/dx_i (one warp per row), dkv
  gives dL/dx_j, dL/dh_j, dL/d(wh)_j and the feature-MLP weight gradients
  (one warp per column, per-warp partial sums added in a fixed order by a
  second pass instead of the TPU's sequential-grid accumulation).
- Bound on the H100: operations.  Per same-scene pair the forward's
  3->32->64->F MLP and score cost ~12.8k FLOP at F = 64, dq ~8.8k and dkv
  ~13k (f32 FMA, no tensor cores), against ~1-2 KB a row of bytes.  The
  kernels keep the pair intermediates in registers and shared memory and
  run the MLP only for pairs that exist.
- ``wh = h W + b`` is one matmul outside the kernels, as the JAX wrapper
  computes it outside the Pallas call (:252-254); autograd pulls dL/d(wh)
  back through it, as the epilogue at :574-579 does.

Dispatch: a CPU tensor takes the plain dense form (under autograd when a
gradient is needed); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from socialways_torch.ops.nn import MLP, Linear, linear_apply, mlp_apply
from socialways_torch.ops.social import (_NEG_INF, attention_pool,
                                         scene_mask, social_features)

_FWD = "social_attention_fwd"
_BWD = "social_attention_bwd"
_H2 = 64                      # second hidden width of the feature MLP


# ----------------------------------------------------------- plain versions
def social_attention_plain(feat_mlp: MLP, attn_w: Linear,
                           x4_last: torch.Tensor, h: torch.Tensor,
                           scene_ids: torch.Tensor) -> torch.Tensor:
    """Dense plain PyTorch version: the CPU path and the kernel's oracle."""
    f_emb = mlp_apply(feat_mlp, social_features(x4_last))
    return attention_pool(attn_w, f_emb, h, scene_mask(scene_ids))


def social_attention_stats_plain(feat_mlp: MLP, attn_w: Linear,
                                 x4_last: torch.Tensor, h: torch.Tensor,
                                 scene_ids: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(out [N, H], m [N], l [N]): the forward and its per-row softmax max
    and normalizer; a row with no neighbour has (-1e9, 0)."""
    f_emb = mlp_apply(feat_mlp, social_features(x4_last))
    mask = scene_mask(scene_ids)
    scores = torch.einsum("ijf,jf->ij", f_emb, linear_apply(attn_w, h))
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.max(dim=-1).values
    l = torch.where(mask, torch.exp(scores - m[:, None]), 0.0).sum(dim=-1)
    return attention_pool(attn_w, f_emb, h, mask), m, l


def _bwd_plain(x4, ids, h, wh, g, stats, r, weights, need_dxi: bool,
               need_dxj: bool):
    """Shared dense form of both backward kernels: rebuild s_ij and a_ij
    from the saved stats, form ds_ij = a_ij (g_i . h_j - r_i), and take
    d(sum ds_ij s_ij) with ds held constant, which is sum_ij ds_ij ds_ij/dv
    for every input v of the scores."""
    with torch.enable_grad():
        xi = x4.detach().requires_grad_(need_dxi)
        xj = x4.detach().requires_grad_(need_dxj)
        ws = [w.detach().requires_grad_() for w in weights]
        whd = wh.detach().requires_grad_()
        x = social_features(xi, xj)
        for k in range(3):
            x = torch.matmul(x, ws[2 * k]) + ws[2 * k + 1]
            if k < 2:
                x = torch.relu(x)
        s = torch.einsum("ijf,jf->ij", x, whd)
        mask = scene_mask(ids)
        p = torch.where(mask, torch.exp(s.detach() - stats[:, :1]), 0.0)
        a = p / torch.clamp(stats[:, 1:], min=1e-20)
        ds = a * (g @ h.T - r[:, None])
        leaves = ([xi] if need_dxi else []) + ([xj] if need_dxj else [])
        grads = torch.autograd.grad((ds * s).sum(), leaves + ws + [whd])
    return a, list(grads)


def social_attention_bwd_dq_plain(x4, ids, h, wh, g, stats, r, weights
                                  ) -> torch.Tensor:
    """dL/dx_i [N, 4] (the query side of every pair)."""
    _, grads = _bwd_plain(x4, ids, h, wh, g, stats, r, weights, True, False)
    return grads[0]


def social_attention_bwd_dkv_plain(x4, ids, h, wh, g, stats, r, weights,
                                   need_dx: bool = True):
    """(dx_j [N, 4] or None, dh_j [N, H], dwh_j [N, F], dw1, db1, dw2, db2,
    dw3, db3): the neighbour side of every pair and the feature-MLP weight
    gradients.  dh_j is the value path sum_i a_ij g_i only."""
    a, grads = _bwd_plain(x4, ids, h, wh, g, stats, r, weights, False,
                          need_dx)
    dxj = grads.pop(0) if need_dx else None
    dwh = grads.pop()
    return (dxj, a.T @ g, dwh, *grads)


# ------------------------------------------------------------------ launches
def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_common(x4, ids, h, wh, weights) -> None:
    n, hdim = h.shape
    feat = wh.shape[1]
    dev, f32 = h.device, torch.float32
    if hdim % 16 or not 16 <= hdim <= 128 or feat % 16 or not 16 <= feat <= 128:
        raise ValueError(f"social attention kernels need H and F multiples "
                         f"of 16 up to 128, got H={hdim}, F={feat}")
    _check("x4_last", x4, (n, 4), f32, dev)
    _check("scene_ids", ids, (n,), torch.int32, dev)
    _check("h", h, (n, hdim), f32, dev)
    _check("wh", wh, (n, feat), f32, dev)
    shapes = [(3, 32), (32,), (32, _H2), (_H2,), (_H2, feat), (feat,)]
    for name, t, shape in zip(["w1", "b1", "w2", "b2", "w3", "b3"],
                              weights, shapes):
        _check(f"feat_mlp {name}", t, shape, f32, dev)


def _check_bwd(x4, ids, h, wh, g, stats, r, weights) -> None:
    _check_common(x4, ids, h, wh, weights)
    n, dev = h.shape[0], h.device
    _check("g", g, tuple(h.shape), torch.float32, dev)
    _check("stats", stats, (n, 2), torch.float32, dev)
    _check("r", r, (n,), torch.float32, dev)


def _lib(name: str, fn: str, n_ptr: int, n_int: int):
    from socialways_torch.kernels._build import load
    f = getattr(load(name), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _call(name: str, f, *args) -> None:
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor)
            else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = f(*ptrs, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch_fwd(x4, ids, h, wh, weights: Sequence[torch.Tensor],
                with_stats: bool):
    _check_common(x4, ids, h, wh, weights)
    n, hdim = h.shape
    out = torch.empty((n, hdim), device=h.device, dtype=torch.float32)
    stats = (torch.empty((n, 2), device=h.device, dtype=torch.float32)
             if with_stats else None)
    _call(_FWD, _lib(_FWD, "social_attention_fwd", 12, 3),
          x4, ids, h, wh, *weights, out, stats, n, hdim, wh.shape[1])
    social_attention_fwd.launches += 1
    return out, stats


# -------------------------------------------------------- backward wrappers
def social_attention_bwd_dq(x4, ids, h, wh, g, stats, r,
                            weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """dL/dx_i [N, 4] from the cotangent ``g`` [N, H], the forward's
    ``stats`` [N, 2] = (m, l) and ``r`` [N] = g . out.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if h.device.type == "cpu":
        return social_attention_bwd_dq_plain(x4, ids, h, wh, g, stats, r,
                                             weights)
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_bwd_dq: unsupported device "
                         f"{h.device}")
    _check_bwd(x4, ids, h, wh, g, stats, r, weights)
    n, hdim = h.shape
    kw = dict(device=h.device, dtype=torch.float32)
    u, c = torch.empty((n, _H2), **kw), torch.empty((n,), **kw)
    dx = torch.empty((n, 4), **kw)
    _call(_BWD, _lib(_BWD, "social_attention_bwd_dq", 16, 3),
          x4, ids, h, wh, g, stats, r, *weights, u, c, dx, n, hdim,
          wh.shape[1])
    social_attention_bwd_dq.launches += 1
    return dx


def social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r,
                             weights: Sequence[torch.Tensor],
                             need_dx: bool = True) -> List:
    """[dx_j or None, dh_j, dwh_j, dw1, db1, dw2, db2, dw3, db3]; see
    ``social_attention_bwd_dkv_plain``.  ``need_dx=False`` skips the
    feature backward of the neighbour side."""
    if h.device.type == "cpu":
        return list(social_attention_bwd_dkv_plain(
            x4, ids, h, wh, g, stats, r, weights, need_dx))
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_bwd_dkv: unsupported device "
                         f"{h.device}")
    _check_bwd(x4, ids, h, wh, g, stats, r, weights)
    n, hdim = h.shape
    feat = wh.shape[1]
    kw = dict(device=h.device, dtype=torch.float32)
    lib = _lib(_BWD, "social_attention_bwd_dkv", 24, 3)
    from socialways_torch.kernels._build import load
    partial_floats = load(_BWD).social_attention_bwd_partial_floats
    partial_floats.argtypes = [ctypes.c_int]
    partial_floats.restype = ctypes.c_int
    u, c = torch.empty((n, _H2), **kw), torch.empty((n,), **kw)
    a_sum, s_sum = torch.empty((n, _H2), **kw), torch.empty((n,), **kw)
    partial = torch.empty((partial_floats(n),), **kw)
    dx = torch.empty((n, 4), **kw) if need_dx else None
    dh, dwh = torch.empty((n, hdim), **kw), torch.empty((n, feat), **kw)
    dw3, db3 = torch.empty((_H2, feat), **kw), torch.empty((feat,), **kw)
    dmlp12 = torch.empty((32 * _H2 + _H2 + 3 * 32 + 32,), **kw)
    _call(_BWD, lib, x4, ids, h, wh, g, stats, r, *weights, u, c, a_sum,
          s_sum, partial, dx, dh, dwh, dw3, db3, dmlp12, n, hdim, feat)
    social_attention_bwd_dkv.launches += 1
    dw2 = dmlp12[:32 * _H2].view(32, _H2)
    db2 = dmlp12[32 * _H2:32 * _H2 + _H2]
    dw1 = dmlp12[32 * _H2 + _H2:32 * _H2 + _H2 + 96].view(3, 32)
    db1 = dmlp12[32 * _H2 + _H2 + 96:]
    return [dx, dh, dwh, dw1, db1, dw2, db2, dw3, db3]


class _SocialAttention(torch.autograd.Function):
    """The CUDA forward with stats and its backward kernels (replaces the
    ``custom_vjp`` at socialways_tpu/kernels/social_attention.py:601-679).
    Inputs: x4, ids, h, wh, w1, b1, w2, b2, w3, b3."""

    @staticmethod
    def forward(ctx, x4, ids, h, wh, *weights):
        out, stats = _launch_fwd(x4, ids, h, wh, weights, with_stats=True)
        ctx.save_for_backward(x4, ids, h, wh, out, stats, *weights)
        return out

    @staticmethod
    def backward(ctx, g):
        x4, ids, h, wh, out, stats, *weights = ctx.saved_tensors
        g = g.contiguous()
        r = (g * out).sum(dim=-1)
        need_x = ctx.needs_input_grad[0]
        dxj, dh, dwh, *dweights = social_attention_bwd_dkv(
            x4, ids, h, wh, g, stats, r, weights, need_dx=need_x)
        dx = None
        if need_x:
            dx = social_attention_bwd_dq(x4, ids, h, wh, g, stats, r,
                                         weights) + dxj
        return (dx, None, dh, dwh, *dweights)


def social_attention_fwd(feat_mlp: MLP, attn_w: Linear,
                         x4_last: torch.Tensor, h: torch.Tensor,
                         scene_ids: torch.Tensor) -> torch.Tensor:
    """Social context ``[N, H]`` from last-frame states ``x4_last [N, 4]``,
    hidden states ``h [N, H]`` and scene ids ``[N]`` (-1 = padding).

    On CUDA with a gradient to take, the forward keeps its softmax stats
    and the backward runs the dq/dkv kernels; without one, the forward
    alone runs and writes no stats."""
    if h.device.type == "cpu":
        return social_attention_plain(feat_mlp, attn_w, x4_last, h, scene_ids)
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_fwd: unsupported device {h.device}")
    weights = [t for layer in feat_mlp for t in (layer.w, layer.b)]
    wh = linear_apply(attn_w, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x4_last, h, wh, *weights]):
        return _SocialAttention.apply(x4_last, scene_ids, h, wh, *weights)
    return _launch_fwd(x4_last, scene_ids, h, wh, weights,
                       with_stats=False)[0]


social_attention_fwd.launches = 0
social_attention_bwd_dq.launches = 0
social_attention_bwd_dkv.launches = 0
