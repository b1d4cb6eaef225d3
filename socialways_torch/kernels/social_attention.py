"""Social-attention forward: the hand-written CUDA kernel and its dispatch.

``social_attention_fwd`` computes
``attention_pool(attn_w, mlp(feat_mlp, social_features(x4)), h,
scene_mask(ids))`` (ops/social.py).

Source note.
- Replaces the Pallas TPU kernel ``_kernel`` of
  socialways_tpu/kernels/social_attention.py:150-198, driven by
  ``_pallas_forward`` (:219-314).  The TPU kernel kept all agents resident
  in VMEM and skipped j-tiles outside a band computed from sorted scene
  ids; the CUDA kernel (csrc/social_attention_fwd.cu) gives each query row
  one warp, stages only the feature-MLP weights in shared memory, tests
  the scene mask before any pair work, and so needs neither the VMEM agent
  caps nor sorted ids (unsorted ids are masked, never dropped).
- Bound on the H100: operations.  Per same-scene pair the 3->32->64->F MLP
  and the score cost ~12.8k FLOP at F = 64 (f32 FMA, no tensor cores),
  against ~1 KB a row of x4, h, wh and out.  The kernel keeps the pair
  intermediates in registers and runs the MLP only for pairs that exist.
- ``wh = h W + b`` is one matmul outside the kernel, as the JAX wrapper
  computes it outside the Pallas call (:252-254).

Dispatch: a CPU tensor takes the plain version (ops/social.py); a CUDA
tensor launches the kernel or raises.  The backward kernels belong to the
training slice, so the CUDA path refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from socialways_torch.ops.nn import MLP, Linear, linear_apply, mlp_apply
from socialways_torch.ops.social import (attention_pool, scene_mask,
                                         social_features)

_KERNEL = "social_attention_fwd"


def social_attention_plain(feat_mlp: MLP, attn_w: Linear,
                           x4_last: torch.Tensor, h: torch.Tensor,
                           scene_ids: torch.Tensor) -> torch.Tensor:
    """Dense plain PyTorch version: the CPU path and the kernel's oracle."""
    f_emb = mlp_apply(feat_mlp, social_features(x4_last))
    return attention_pool(attn_w, f_emb, h, scene_mask(scene_ids))


def social_attention_fwd(feat_mlp: MLP, attn_w: Linear,
                         x4_last: torch.Tensor, h: torch.Tensor,
                         scene_ids: torch.Tensor) -> torch.Tensor:
    """Social context ``[N, H]`` from last-frame states ``x4_last [N, 4]``,
    hidden states ``h [N, H]`` and scene ids ``[N]`` (-1 = padding)."""
    if h.device.type == "cpu":
        return social_attention_plain(feat_mlp, attn_w, x4_last, h, scene_ids)
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_fwd: unsupported device {h.device}")
    weights = [t for layer in feat_mlp for t in (layer.w, layer.b)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x4_last, h, attn_w.w, attn_w.b,
                                      *weights]):
        raise NotImplementedError(
            "social_attention_fwd has no backward kernel yet; call it "
            "under torch.no_grad()")
    wh = linear_apply(attn_w, h)
    return _launch(x4_last, scene_ids, h, wh, weights)


social_attention_fwd.launches = 0


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


def _launch(x4: torch.Tensor, ids: torch.Tensor, h: torch.Tensor,
            wh: torch.Tensor, weights) -> torch.Tensor:
    n, hdim = h.shape
    feat = wh.shape[1]
    dev, f32 = h.device, torch.float32
    if hdim % 16 or not 16 <= hdim <= 128 or feat % 16 or not 16 <= feat <= 128:
        raise ValueError(f"social_attention_fwd needs H and F multiples of "
                         f"16 up to 128, got H={hdim}, F={feat}")
    _check("x4_last", x4, (n, 4), f32, dev)
    _check("scene_ids", ids, (n,), torch.int32, dev)
    _check("h", h, (n, hdim), f32, dev)
    _check("wh", wh, (n, feat), f32, dev)
    shapes = [(3, 32), (32,), (32, 64), (64,), (64, feat), (feat,)]
    for name, t, shape in zip(["w1", "b1", "w2", "b2", "w3", "b3"],
                              weights, shapes):
        _check(f"feat_mlp {name}", t, shape, f32, dev)

    from socialways_torch.kernels._build import load
    lib = load(_KERNEL)
    fn = lib.social_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    out = torch.empty((n, hdim), device=dev, dtype=f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x4.data_ptr(), ids.data_ptr(), h.data_ptr(), wh.data_ptr(),
                 *(t.data_ptr() for t in weights), out.data_ptr(),
                 n, hdim, feat, stream)
    if err:
        raise RuntimeError(f"social_attention_fwd launch failed: CUDA error "
                           f"{err}")
    social_attention_fwd.launches += 1
    return out
