"""Social GAN's pooling module as one hand-written CUDA kernel.

``social_pool_fused`` computes ``ops/sgan_pool.py``'s P [N, 32] (the
max over every same-scene pair, the diagonal included, of the pair MLP
48 -> 512 -> 32) in one launch of ``csrc/social_pool.cuh``: bf16 operands
on ``mma.sync`` (``csrc/social_pool_bf16.cu``), float32 with FFMA products
(``csrc/social_pool.cu``).  It replaces no TPU kernel (the JAX package
has no Social GAN); its plain versions are the dense, blocked and
scene-window forms of ``ops/sgan_pool.py``, whose rounding points it
keeps.  ``max_scene`` > 0 promises sorted, contiguous scenes of at most
that many rows (padding -1) and scans only the scene window of each row
pair; 0 scans all N, with equal bits.

The kernel is built at its first launch (``_build``), so nothing that
runs no Social GAN compiles it.  It computes no gradient and refuses a
call that would need one.  ``launches`` and ``launches_bf16`` count its
launches, registered with kernels/launches.py.
"""

from __future__ import annotations

import ctypes

import torch

from socialways_torch.kernels.launches import register
from socialways_torch.ops.nn import MLP, Linear

#: the widths the kernel is built for: embedding, encoder hidden, the
#: pool's hidden width and the bottleneck (csrc/social_pool.cuh)
EMBED, HIDDEN, INNER, OUT = 16, 32, 512, 32
_LIBS = {torch.bfloat16: ("social_pool_bf16", "social_pool_bf16"),
         torch.float32: ("social_pool", "social_pool_f32")}


def widths_ok(pool_embed, pool_mlp, h: torch.Tensor) -> bool:
    """Whether the kernel holds these weights and ``h``: its widths, two
    layers, and an operand type it is built for."""
    return (h.dtype in _LIBS and h.dim() == 2 and h.shape[1] == HIDDEN
            and tuple(pool_embed.w.shape) == (2, EMBED) and len(pool_mlp) == 2
            and tuple(pool_mlp[0].w.shape) == (EMBED + HIDDEN, INNER)
            and tuple(pool_mlp[1].w.shape) == (INNER, OUT))


def _entry(dtype: torch.dtype):
    from socialways_torch.kernels._build import load
    lib, name = _LIBS[dtype]
    f = getattr(load(lib), name)
    f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def social_pool_fused(pool_embed: Linear, pool_mlp: MLP, pos: torch.Tensor,
                      h: torch.Tensor, scene_ids: torch.Tensor,
                      max_scene: int = 0) -> torch.Tensor:
    """P [N, 32] float32 of positions ``pos`` [N, 2] and encodings ``h``
    [N, 32] (bf16 or float32, one CUDA device) in scenes ``scene_ids``
    [N] (-1: padding), with the weights in ``h``'s dtype.  Raises on
    widths, dtypes or devices the kernel does not take, and where a
    gradient would be recorded."""
    n = h.shape[0]
    if not widths_ok(pool_embed, pool_mlp, h):
        got = " -> ".join(str(tuple(layer.w.shape)) for layer in pool_mlp)
        raise ValueError(f"the fused pool is built for h [N, {HIDDEN}] in "
                         f"bf16 or float32, the embedding 2 -> {EMBED} and "
                         f"the pool MLP {EMBED} + {HIDDEN} -> {INNER} -> "
                         f"{OUT}; got h {tuple(h.shape)} {h.dtype}, the "
                         f"embedding {tuple(pool_embed.w.shape)} and the "
                         f"MLP {got}")
    tensors = [pos, h, pool_embed.w, pool_embed.b, pool_mlp[0].w,
               pool_mlp[0].b, pool_mlp[1].w, pool_mlp[1].b]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the fused pool has no backward: call it under "
                           "torch.no_grad()")
    if any(t.dtype != h.dtype for t in tensors):
        raise ValueError(f"every operand must be {h.dtype}")
    if tuple(pos.shape) != (n, 2) or tuple(scene_ids.shape) != (n,):
        raise ValueError(f"pos must be [{n}, 2] and scene_ids [{n}], got "
                         f"{tuple(pos.shape)} and {tuple(scene_ids.shape)}")
    if max_scene < 0:
        raise ValueError(f"max_scene must be >= 0, got {max_scene}")
    dev = h.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the fused pool runs on one CUDA device, h is on "
                         f"{dev}")
    out = torch.empty((n, OUT), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    args = [t.contiguous() for t in tensors]
    ids = scene_ids.to(device=dev, dtype=torch.int32).contiguous()
    ptrs = [args[0].data_ptr(), ids.data_ptr()] + [t.data_ptr()
                                                   for t in args[1:]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(h.dtype)(*ptrs, out.data_ptr(), n, max_scene, stream)
    if err:
        raise RuntimeError(f"{_LIBS[h.dtype][1]} launch failed: CUDA error "
                           f"{err}")
    if h.dtype == torch.bfloat16:
        social_pool_fused.launches_bf16 += 1
    else:
        social_pool_fused.launches += 1
    return out


register(social_pool_fused, "launches", "launches_bf16")
