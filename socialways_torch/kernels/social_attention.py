"""Social attention: the hand-written CUDA kernels, their plain versions and
the autograd Function that ties them together.

``social_attention_fwd`` computes
``attention_pool(attn_w, mlp(feat_mlp, social_features(x4)), h,
scene_mask(ids))`` (ops/social.py) and, under autograd, its gradient.

Source notes.
- Forward (csrc/social_attention_fwd.cuh) replaces the Pallas TPU kernel
  ``_kernel`` of socialways_tpu/kernels/social_attention.py:150-198, driven
  by ``_pallas_forward`` (:219-314).  The TPU kernel kept all agents
  resident in VMEM and skipped j-tiles outside a band computed from sorted
  scene ids.  The CUDA forward is two launches: a prologue computes
  u_j = W3 wh_j [64] and c_j = b3 . wh_j once per agent, so a pair's score
  is a2_ij . u_j + c_j (2.2k MAC instead of 6.3k at F = 64); the main
  kernel gives each block a tile of 2 query rows, finds their same-scene
  columns by id tests (no sorted-id assumption, no VMEM agent caps) and runs
  the pair MLP over batches of 32 pairs with all its threads.  It returns
  u and c, and under autograd the per-row softmax stats (m, l).
- Backward (csrc/social_attention_bwd.cuh) replaces ``_bwd_dq_kernel``
  (:317-369) and ``_bwd_dkv_kernel`` (:372-461), driven by
  ``_pallas_backward`` (:464-591); both read the forward's u and c and take
  a tile of 2 agents a block over batches of their pairs from the same
  shared-memory pair ring as the forward, with the same register-tiled
  cotangent steps.  dq gives dL/dx_i: a tile of 2 query rows, each row's
  sum added in ring order and written once (one launch, no scratch).  dkv
  gives dL/dx_j, dL/dh_j, dL/d(wh)_j and the feature-MLP weight gradients:
  a tile of 2 columns, one partial slot per block, then a finalize launch
  that adds the partials and forms dW3, db3 in parallel fixed-order trees
  instead of the TPU's sequential-grid accumulation.  No atomics in
  either: two runs give equal bits.
- Bound on the H100: operations.  Per same-scene pair the forward costs
  ~4.4k FLOP at F = 64, dq ~8.8k and dkv ~13k (f32 FMA, no tensor cores),
  against ~1-2 KB a row of bytes.  The kernels keep the pair intermediates
  in registers and shared memory and run the MLP only for pairs that
  exist.
- ``wh = h W + b`` is one matmul outside the kernels, as the JAX wrapper
  computes it outside the Pallas call (:252-254); autograd pulls dL/d(wh)
  back through it, as the epilogue at :574-579 does.

- Scene window.  Every kernel takes ``max_scene`` (w).  With w = 0 a
  tile id-tests all N agents, O(N^2) id tests a launch.  With w > 0 the
  caller promises JAX's windowed contract (sorted, contiguous scenes of at
  most w rows, padding -1; socialways_tpu/ops/social.py:197-210), and a
  tile starting at agent t0 scans only ``scan_range(n, t0, w)``: the CUDA
  counterpart of the TPU kernel's sorted-id band (``_tile_bands``,
  :201-216).  The scan keeps its order, so on such inputs a w > 0 launch
  finds the same pairs in the same ring order as a w = 0 launch and gives
  equal bits.

- bf16 operands.  When ``h`` is bf16 the kernels run their bf16 entry
  points (``*_bf16``, in libraries of their own built from
  ``csrc/*_bf16.cu``): h, wh and the feature-MLP weights bf16, x4, the
  cotangents, stats, u and c float32, with the Pallas kernel's rounding
  (ops/social.py gives the contract; ``_pallas_forward`` :248-258 and
  ``_pallas_backward`` :464-477 set it).  A bf16 tensor on CUDA launches a
  bf16 kernel or raises: it is never cast up to reach the float32 ones.
  Each entry point counts its own launches: ``launches`` for float32,
  ``launches_bf16`` for bf16.

- Member axis.  An ensemble (engine/ensemble.py) trains M models on the
  same data as one batched step under ``torch.func.vmap``.  Every launch
  wrapper also takes member-stacked operands (``h`` [M, N, H]; ``wh`` and
  the six MLP tensors with a leading M; ``x4`` and ``ids`` shared or
  stacked) and launches each kernel once for all members: the grid's y
  axis is the member and every operand has a member stride (0: shared).
  A single model is the launch at M = 1, and member m's slice of every
  output has the bits of the launch on member m's operands alone.
  ``_SocialAttention``'s ``vmap`` rule hands the stacked operands to the
  same Function outside ``vmap``, so the regular autograd backward reaches
  the member-batched dq and dkv launches.  A member launch counts once in
  ``launches`` (``launches_bf16``) and once in ``member_launches``
  (``member_launches_bf16``).  The member plain versions
  (``*_members_plain``) loop the solo plain versions over the members: the
  CPU wrappers take them for stacked CPU tensors, and the tests and
  ``chip_smoke.py`` hold the kernels against them.

Dispatch: ``social_attention_fwd`` takes the plain dense form for a CPU
tensor (under autograd when a gradient is needed) and launches the kernels
or raises for a CUDA tensor.  ``social_attention`` is the size-aware
dispatch of socialways_tpu/kernels/social_attention.py:747-784 with
``use_pallas`` off: on the CPU dense up to ``_DENSE_MAX_AGENTS``, then
windowed (``max_scene > 0``) or blockwise; on CUDA always the kernels.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch._C._functorch import is_batchedtensor

from socialways_torch.ops.nn import (MLP, Linear, LinearView, linear_apply,
                                     wide)
from socialways_torch.ops.social import (_NEG_INF, attention_pool,
                                         attention_values, pair_embed, pool,
                                         scene_mask,
                                         social_context_blockwise,
                                         social_context_windowed)

_FWD = "social_attention_fwd"
_BWD = "social_attention_bwd"
_H2 = 64                      # second hidden width of the feature MLP
_TILE = 2                     # rows (forward, dq) or columns (dkv) a block takes
_DKV_MAX_BLOCKS = 4 * 132     # 4 a streaming multiprocessor of an H100
_PARTIAL = 32 * _H2 + _H2 + 3 * 32 + 32   # dW2 | db2 | dW1 | db1 per block
# above this the dense form's N^2 F pair tensors stop being a good idea on
# the CPU (>= 1 GB at F = 64): stream blocks instead (the JAX threshold)
_DENSE_MAX_AGENTS = 4096


# ----------------------------------------------------------- plain versions
def social_attention_plain(feat_mlp: MLP, attn_w: Linear,
                           x4_last: torch.Tensor, h: torch.Tensor,
                           scene_ids: torch.Tensor) -> torch.Tensor:
    """Dense plain PyTorch version: the CPU path and the kernel's oracle.
    The MLP's operands and the output take ``h``'s dtype."""
    f_emb = pair_embed(feat_mlp, x4_last, op_dtype=h.dtype)
    return attention_pool(attn_w, f_emb, h,
                          scene_mask(scene_ids)).to(h.dtype)


def social_attention_stats_plain(feat_mlp: MLP, attn_w: Linear,
                                 x4_last: torch.Tensor, h: torch.Tensor,
                                 scene_ids: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(out [N, H], m [N], l [N]), all float32: the forward, as the kernel
    writes it before any cast, and its per-row softmax max and normalizer;
    a row with no neighbour has (-1e9, 0)."""
    f_emb = pair_embed(feat_mlp, x4_last, op_dtype=h.dtype)
    mask = scene_mask(scene_ids)
    scores = torch.einsum("ijf,jf->ij", f_emb,
                          attention_values(attn_w, h.to(wide(h.dtype)),
                                           h.dtype))
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.max(dim=-1).values
    l = torch.where(mask, torch.exp(scores - m[:, None]), 0.0).sum(dim=-1)
    return attention_pool(attn_w, f_emb, h, mask), m, l


def _bwd_plain(x4, ids, h, wh, g, stats, r, weights, need_dxi: bool,
               need_dxj: bool):
    """Shared dense form of both backward kernels: rebuild s_ij and a_ij
    from the saved stats, form ds_ij = a_ij (g_i . h_j - r_i), and take
    d(sum ds_ij s_ij) with ds held constant, which is sum_ij ds_ij ds_ij/dv
    for every input v of the scores.  The scores are rebuilt with the
    forward's operand dtype (``h``'s), and every gradient is float32 (for
    bf16 or float32 operands; float64 stays float64)."""
    acc = wide(h.dtype)
    with torch.enable_grad():
        xi = x4.detach().to(acc).requires_grad_(need_dxi)
        xj = x4.detach().to(acc).requires_grad_(need_dxj)
        ws = [w.detach().to(acc).requires_grad_() for w in weights]
        whd = wh.detach().to(acc).requires_grad_()
        layers = [LinearView(ws[2 * k], ws[2 * k + 1]) for k in range(3)]
        x = pair_embed(layers, xi, xj, h.dtype)
        s = torch.einsum("ijf,jf->ij", x, whd)
        mask = scene_mask(ids)
        p = torch.where(mask, torch.exp(s.detach() - stats[:, :1]), 0.0)
        a = p / torch.clamp(stats[:, 1:], min=1e-20)
        ds = a * (g @ h.to(acc).T - r[:, None])
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


def social_attention_fwd_kernel_plain(x4, ids, h, wh, weights
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [N, H], stats [N, 2]) from the forward kernel's own operands
    (``wh`` and the six MLP tensors in ``h``'s dtype), all float32: what
    ``_launch_fwd`` writes, computed as ``social_attention_stats_plain``
    computes it from the modules."""
    acc = wide(h.dtype)
    layers = [LinearView(weights[2 * k], weights[2 * k + 1]) for k in range(3)]
    mask = scene_mask(ids)
    s = torch.einsum("ijf,jf->ij", pair_embed(layers, x4, op_dtype=h.dtype),
                     wh.to(acc))
    s = torch.where(mask, s, _NEG_INF)
    m = s.max(dim=-1).values
    p = torch.where(mask, torch.exp(s - m[:, None]), 0.0)
    l = p.sum(dim=-1)
    if acc == h.dtype:
        out = (p / torch.clamp(l[:, None], min=1e-20)) @ h
    else:
        out = pool(p, h.to(acc), h.dtype) / torch.clamp(l[:, None], min=1e-20)
    out = torch.where(mask.any(dim=-1, keepdim=True), out, 0.0)
    return out, torch.stack([m, l], dim=-1)


def _member_of(t: Optional[torch.Tensor], i: int, solo_dim: int):
    """Member ``i``'s operand: ``t`` itself when it is shared (``solo_dim``
    dimensions), else its slice ``i``."""
    return t if t is None or t.dim() == solo_dim else t[i]


def _members_loop(fn, h: torch.Tensor, operands, solo_dims):
    """``fn`` on each member's operands (``h`` is [M, N, H]), its outputs
    stacked on a leading member axis (None stays None)."""
    outs = [fn(*(_member_of(t, i, d) for t, d in zip(operands, solo_dims)))
            for i in range(h.shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return [None if o[0] is None else torch.stack(o) for o in zip(*outs)]


_SOLO_DIMS = (2, 1, 2, 2, 2, 2, 1)         # x4, ids, h, wh, g, stats, r
_WEIGHT_DIMS = (2, 1, 2, 1, 2, 1)          # w1, b1, w2, b2, w3, b3


def social_attention_fwd_members_plain(x4, ids, h, wh, weights):
    """The member version of ``social_attention_fwd_kernel_plain``: ``h``
    [M, N, H], the other operands stacked or shared; (out [M, N, H], stats
    [M, N, 2]).  A loop of the solo plain version over the members."""
    return _members_loop(
        lambda a, b, c, d, *w: social_attention_fwd_kernel_plain(a, b, c, d, w),
        h, (x4, ids, h, wh, *weights), _SOLO_DIMS[:4] + _WEIGHT_DIMS)


def social_attention_bwd_dq_members_plain(x4, ids, h, wh, g, stats, r,
                                          weights) -> torch.Tensor:
    """dL/dx_i [M, N, 4]: ``social_attention_bwd_dq_plain`` of each
    member."""
    return _members_loop(
        lambda *a: social_attention_bwd_dq_plain(*a[:7], a[7:]), h,
        (x4, ids, h, wh, g, stats, r, *weights), _SOLO_DIMS + _WEIGHT_DIMS)


def social_attention_bwd_dkv_members_plain(x4, ids, h, wh, g, stats, r,
                                           weights, need_dx: bool = True):
    """``social_attention_bwd_dkv_plain`` of each member, every output
    stacked on a leading member axis (dx_j None when not asked for)."""
    return _members_loop(
        lambda *a: social_attention_bwd_dkv_plain(*a[:7], a[7:], need_dx), h,
        (x4, ids, h, wh, g, stats, r, *weights), _SOLO_DIMS + _WEIGHT_DIMS)


# ------------------------------------------------------------- launch sizes
def fwd_blocks(n: int) -> int:
    """Blocks of the forward's main kernel: one per tile of ``_TILE`` rows
    (128 at N = 256, enough for the H100's 132 SMs)."""
    return -(-n // _TILE)


def dq_blocks(n: int) -> int:
    """Blocks of dq: one per tile of ``_TILE`` query rows, as the forward.
    dq keeps no per-block partials, so its grid needs no cap."""
    return fwd_blocks(n)


def dkv_blocks(n: int) -> int:
    """Blocks of dkv: one per tile of ``_TILE`` columns, at most
    ``_DKV_MAX_BLOCKS``; a block walks tiles with a stride of the grid, so
    the per-block partials stay bounded at any N."""
    return min(fwd_blocks(n), _DKV_MAX_BLOCKS)


def _check_window(max_scene: int) -> None:
    if max_scene < 0:
        raise ValueError(f"max_scene must be >= 0, got {max_scene}")


def scan_range(n: int, t0: int, w: int) -> Tuple[int, int]:
    """[lo, hi): the agents a tile whose first agent is ``t0`` id-tests,
    as every kernel computes it.  ``w = 0``: all N.  ``w > 0``: sorted,
    contiguous scenes of at most w rows put every partner of the tile's
    ``_TILE`` agents within w rows of them."""
    _check_window(w)
    if w == 0:
        return 0, n
    return max(0, t0 - w), min(n, t0 + _TILE + w)


def dkv_partial_floats(n: int, members: int = 1) -> int:
    """Floats of dkv's partial scratch: one slot of dW2, db2, dW1, db1 per
    block and member.  The pair batches live in shared memory, fixed in
    size."""
    return members * dkv_blocks(n) * _PARTIAL


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


_OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _lead(h: torch.Tensor) -> Tuple[int, ...]:
    """``(M,)`` for member-stacked operands (``h`` [M, N, H]), else ``()``."""
    return tuple(h.shape[:-2])


def _check_common(x4, ids, h, wh, weights) -> Optional[List[int]]:
    """The operand dtype is ``h``'s, float32 or bf16: ``wh`` and the six
    MLP tensors share it; ``x4`` is float32.  Solo: ``h`` [N, H]; returns
    None.  Members: ``h`` [M, N, H], each other operand [M, ...] or shared
    without the member axis; returns the ten member strides of x4, ids, h,
    wh, w1, b1, w2, b2, w3, b3 (elements, 0 for a shared operand)."""
    if h.dim() not in (2, 3):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected [N, H] or "
                         f"[M, N, H]")
    lead = _lead(h)
    n, hdim = h.shape[-2:]
    feat = wh.shape[-1]
    dev, f32, op = h.device, torch.float32, h.dtype
    if hdim % 16 or not 16 <= hdim <= 128 or feat % 16 or not 16 <= feat <= 128:
        raise ValueError(f"social attention kernels need H and F multiples "
                         f"of 16 up to 128, got H={hdim}, F={feat}")
    if op not in _OPERAND_DTYPES:
        raise ValueError(f"h has dtype {op}, expected float32 or bfloat16")

    def operand(name, t, shape, dtype, shared_ok=True) -> int:
        if lead and shared_ok and t.dim() == len(shape):
            _check(name, t, shape, dtype, dev)      # one copy for all
            return 0
        _check(name, t, lead + shape, dtype, dev)
        return t[0].numel() if lead else 0

    strides = [operand("x4_last", x4, (n, 4), f32),
               operand("scene_ids", ids, (n,), torch.int32),
               operand("h", h, (n, hdim), op, shared_ok=False),
               operand("wh", wh, (n, feat), op)]
    shapes = [(3, 32), (32,), (32, _H2), (_H2,), (_H2, feat), (feat,)]
    for name, t, shape in zip(["w1", "b1", "w2", "b2", "w3", "b3"],
                              weights, shapes):
        strides.append(operand(f"feat_mlp {name}", t, shape, op))
    return strides if lead else None


def _entry(name: str, h: torch.Tensor) -> str:
    """The library (csrc/<name>.cu) or C entry point ``name`` for ``h``'s
    operand dtype: bf16 takes the ``_bf16`` one."""
    return name if h.dtype == torch.float32 else name + "_bf16"


def _count(wrapper, h: torch.Tensor) -> None:
    """One launch of ``wrapper``'s float32 or bf16 kernel; a member launch
    (``h`` [M, N, H]) also counts in ``member_launches`` (``_bf16``)."""
    suffix = "" if h.dtype == torch.float32 else "_bf16"
    setattr(wrapper, "launches" + suffix,
            getattr(wrapper, "launches" + suffix) + 1)
    if h.dim() == 3:
        setattr(wrapper, "member_launches" + suffix,
                getattr(wrapper, "member_launches" + suffix) + 1)


def _check_bwd(x4, ids, h, wh, g, stats, r, weights, u, c
               ) -> Optional[List[int]]:
    strides = _check_common(x4, ids, h, wh, weights)
    lead, n, dev = _lead(h), h.shape[-2], h.device
    _check("g", g, tuple(h.shape), torch.float32, dev)
    _check("stats", stats, lead + (n, 2), torch.float32, dev)
    _check("r", r, lead + (n,), torch.float32, dev)
    _check("u", u, lead + (n, _H2), torch.float32, dev)
    _check("c", c, lead + (n,), torch.float32, dev)
    return strides


def _lib(name: str, fn: str, n_ptr: int, n_int: int):
    """C entry ``fn`` of library ``name``: ``n_ptr`` pointers, ``n_int``
    ints, the member count, the strides' pointer and the stream."""
    from socialways_torch.kernels._build import load
    f = getattr(load(name), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (n_int + 1)
                  + [ctypes.c_void_p, ctypes.c_void_p])
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


def _launch(lib: str, entry: str, h: torch.Tensor, n_ptr: int, n_int: int,
            strides: Optional[List[int]], *args) -> None:
    """C entry ``entry`` for ``h``'s operand dtype with ``args``, the
    member count and the member strides: a single model (``strides`` None)
    is M = 1 with a null stride array."""
    f = _lib(_entry(lib, h), _entry(entry, h), n_ptr, n_int)
    if strides is None:
        _call(lib, f, *args, 1, None)
    else:
        _call(lib, f, *args, h.shape[0], (ctypes.c_longlong * 10)(*strides))


def _launch_fwd(x4, ids, h, wh, weights: Sequence[torch.Tensor],
                with_stats: bool, max_scene: int = 0):
    """(out [N, H], stats [N, 2] or None, u [N, 64], c [N]) from the two
    launches of the forward kernel; u = wh W3^T and c = wh . b3 are what
    the backward kernels read.  ``max_scene`` > 0 scans each tile's scene
    window only (``scan_range``).  Every output is float32; bf16 ``h``
    launches the bf16 kernel.  Member-stacked operands (``h`` [M, N, H],
    ``_check_common``) launch once for all members and give [M, ...]
    outputs."""
    _check_window(max_scene)
    strides = _check_common(x4, ids, h, wh, weights)
    lead, (n, hdim) = _lead(h), h.shape[-2:]
    kw = dict(device=h.device, dtype=torch.float32)
    out = torch.empty(lead + (n, hdim), **kw)
    stats = torch.empty(lead + (n, 2), **kw) if with_stats else None
    u, c = torch.empty(lead + (n, _H2), **kw), torch.empty(lead + (n,), **kw)
    _launch(_FWD, "social_attention_fwd", h, 14, 5, strides, x4, ids, h, wh,
            *weights, out, stats, u, c, n, hdim, wh.shape[-1], fwd_blocks(n),
            max_scene)
    _count(social_attention_fwd, h)
    return out, stats, u, c


# -------------------------------------------------------- backward wrappers
def social_attention_bwd_dq(x4, ids, h, wh, g, stats, r,
                            weights: Sequence[torch.Tensor], u: torch.Tensor,
                            c: torch.Tensor, max_scene: int = 0
                            ) -> torch.Tensor:
    """dL/dx_i [N, 4] from the cotangent ``g`` [N, H], the forward's
    ``stats`` [N, 2] = (m, l), ``r`` [N] = g . out and its ``u`` [N, 64] and
    ``c`` [N].  CPU tensors take the plain version, which rebuilds the
    scores from ``wh`` and ignores u and c; CUDA tensors launch the kernel
    (one launch of ``dq_blocks(N)`` blocks, each tile scanning
    ``scan_range(N, t0, max_scene)``) or raise.  ``h``, ``wh`` and the
    weights are float32 or bf16 together; the rest and dx are float32.
    Member-stacked operands (``h`` [M, N, H], ``_check_common``; g, stats,
    r, u, c with a leading M) give dx [M, N, 4] from one launch, or on the
    CPU from ``social_attention_bwd_dq_members_plain``."""
    _check_window(max_scene)
    if h.device.type == "cpu":
        plain = (social_attention_bwd_dq_members_plain if h.dim() == 3
                 else social_attention_bwd_dq_plain)
        return plain(x4, ids, h, wh, g, stats, r, weights)
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_bwd_dq: unsupported device "
                         f"{h.device}")
    strides = _check_bwd(x4, ids, h, wh, g, stats, r, weights, u, c)
    lead, (n, hdim) = _lead(h), h.shape[-2:]
    dx = torch.empty(lead + (n, 4), device=h.device, dtype=torch.float32)
    _launch(_BWD, "social_attention_bwd_dq", h, 13, 4, strides, x4, ids, h,
            g, stats, r, u, c, *weights[:4], dx, n, hdim, dq_blocks(n),
            max_scene)
    _count(social_attention_bwd_dq, h)
    return dx


def social_attention_bwd_dkv(x4, ids, h, wh, g, stats, r,
                             weights: Sequence[torch.Tensor], u: torch.Tensor,
                             c: torch.Tensor, need_dx: bool = True,
                             max_scene: int = 0) -> List:
    """[dx_j or None, dh_j, dwh_j, dw1, db1, dw2, db2, dw3, db3]; see
    ``social_attention_bwd_dkv_plain``, which the CPU path runs (it ignores
    the forward's ``u`` and ``c``).  ``need_dx=False`` skips the feature
    backward of the neighbour side.  On CUDA: two launches, dkv (each
    column tile scanning ``scan_range(N, t0, max_scene)``: a column's
    partners lie in the same window) and its finalize.  Operand dtypes as
    in ``social_attention_bwd_dq``; every gradient is float32.  Member-
    stacked operands give every output with a leading M, from one launch
    of each kernel, or on the CPU from
    ``social_attention_bwd_dkv_members_plain``."""
    _check_window(max_scene)
    if h.device.type == "cpu":
        plain = (social_attention_bwd_dkv_members_plain if h.dim() == 3
                 else social_attention_bwd_dkv_plain)
        return list(plain(x4, ids, h, wh, g, stats, r, weights, need_dx))
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_bwd_dkv: unsupported device "
                         f"{h.device}")
    strides = _check_bwd(x4, ids, h, wh, g, stats, r, weights, u, c)
    lead, (n, hdim) = _lead(h), h.shape[-2:]
    feat = wh.shape[-1]
    kw = dict(device=h.device, dtype=torch.float32)
    a_sum = torch.empty(lead + (n, _H2), **kw)
    s_sum = torch.empty(lead + (n,), **kw)
    partial = torch.empty((dkv_partial_floats(n, h.shape[0] if lead else 1),),
                          **kw)
    dx = torch.empty(lead + (n, 4), **kw) if need_dx else None
    dh = torch.empty(lead + (n, hdim), **kw)
    dwh = torch.empty(lead + (n, feat), **kw)
    dw3 = torch.empty(lead + (_H2, feat), **kw)
    db3 = torch.empty(lead + (feat,), **kw)
    dmlp12 = torch.empty(lead + (_PARTIAL,), **kw)
    # the C entry refuses a partial size other than its own M x blocks x slot
    _launch(_BWD, "social_attention_bwd_dkv", h, 24, 6, strides, x4, ids, h,
            wh, g, stats, r, u, c, *weights, a_sum, s_sum, partial, dx, dh,
            dwh, dw3, db3, dmlp12, n, hdim, feat, dkv_blocks(n),
            partial.numel(), max_scene)
    _count(social_attention_bwd_dkv, h)
    dw2 = dmlp12[..., :32 * _H2].view(lead + (32, _H2))
    db2 = dmlp12[..., 32 * _H2:32 * _H2 + _H2]
    dw1 = dmlp12[..., 32 * _H2 + _H2:32 * _H2 + _H2 + 96].view(lead + (3, 32))
    db1 = dmlp12[..., 32 * _H2 + _H2 + 96:]
    return [dx, dh, dwh, dw1, db1, dw2, db2, dw3, db3]


class _SocialAttention(torch.autograd.Function):
    """The CUDA forward with stats and its backward kernels (replaces the
    ``custom_vjp`` at socialways_tpu/kernels/social_attention.py:601-679).
    Inputs: max_scene, op (the operand dtype), with_stats, x4, ids, h, wh,
    w1, b1, w2, b2, w3, b3; x4, h and wh float32, the weights in ``op``.
    ``h`` and ``wh`` (h W + b) are rounded to ``op`` here, so their
    gradients leave in float32 and autograd sums both of h's paths before
    the one rounding of dh, as JAX's epilogue does (:574-591).  It keeps
    the forward's float32 output for ``r = g . out`` (JAX's ``out_pad``)
    and returns it in ``op``; the weights' gradients return in ``op``, from
    the kernels' float32 ones.

    Outputs: (out in ``op``; the float32 out when ``op`` is narrower, else
    None; stats or None; u; c; h and wh in ``op`` when it is narrower, else
    None: the one rounding, launched and saved), all but the first
    non-differentiable.
    ``with_stats`` False (no gradient will be taken) launches the forward
    without stats.  Solo operands or member-stacked ones (``h`` [M, N, H],
    see ``_check_common``); a shared ``x4``'s gradient is summed over the
    members.  Under ``torch.func.vmap`` the ``vmap`` rule stacks the
    operands on a leading member axis and applies this Function to them
    outside ``vmap``: one member launch of each kernel for all members,
    and a node of the regular autograd graph whose backward launches the
    member dq and dkv kernels."""

    @staticmethod
    def forward(max_scene, op, with_stats, x4, ids, h, wh, *weights):
        h_op, wh_op = h.to(op), wh.to(op)
        out, stats, u, c = _launch_fwd(x4, ids, h_op, wh_op, weights,
                                       with_stats=with_stats,
                                       max_scene=max_scene)
        if op == torch.float32:
            return out, None, stats, u, c, None, None
        return out.to(op), out, stats, u, c, h_op, wh_op

    @staticmethod
    def setup_context(ctx, inputs, output):
        max_scene, op, _, x4, ids, h, wh, *weights = inputs
        out_op, out_f32, stats, u, c, h_op, wh_op = output
        ctx.mark_non_differentiable(*(t for t in output[1:] if t is not None))
        ctx.save_for_backward(x4, ids, h if h_op is None else h_op,
                              wh if wh_op is None else wh_op,
                              out_op if out_f32 is None else out_f32, stats,
                              u, c, *weights)
        ctx.max_scene = max_scene

    @staticmethod
    def backward(ctx, g, *_):
        x4, ids, h, wh, out, stats, u, c, *weights = ctx.saved_tensors
        g = g.float().contiguous()
        r = (g * out).sum(dim=-1)
        need_x = ctx.needs_input_grad[3]
        w = ctx.max_scene
        dxj, dh, dwh, *dweights = social_attention_bwd_dkv(
            x4, ids, h, wh, g, stats, r, weights, u, c, need_dx=need_x,
            max_scene=w)
        dx = None
        if need_x:
            dx = social_attention_bwd_dq(x4, ids, h, wh, g, stats, r,
                                         weights, u, c, max_scene=w) + dxj
            if x4.dim() < h.dim():          # x4 shared by the members
                dx = dx.sum(dim=0)
        return (None, None, None, dx, None, dh, dwh,
                *(d.to(t.dtype) for d, t in zip(dweights, weights)))

    @staticmethod
    def vmap(info, in_dims, max_scene, op, with_stats, x4, ids, h, wh,
             *weights):
        """Member-stack the operands (the member axis first; x4 and ids
        stay shared when they are not batched, h, wh and the weights are
        expanded to every member) and apply the Function to them."""
        m = info.batch_size

        def stacked(t, d):
            t = t.expand(m, *t.shape) if d is None else t.movedim(d, 0)
            return t.contiguous()

        x4d, idsd, *rest_d = in_dims[3:]
        x4 = x4 if x4d is None else x4.movedim(x4d, 0).contiguous()
        ids = ids if idsd is None else ids.movedim(idsd, 0).contiguous()
        rest = [stacked(t, d) for t, d in zip((h, wh, *weights), rest_d)]
        with_stats = with_stats and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x4, *rest))
        outs = _SocialAttention.apply(max_scene, op, with_stats, x4, ids,
                                      *rest)
        return outs, tuple(None if t is None else 0 for t in outs)


def social_attention_fwd(feat_mlp: MLP, attn_w: Linear,
                         x4_last: torch.Tensor, h: torch.Tensor,
                         scene_ids: torch.Tensor,
                         max_scene: int = 0) -> torch.Tensor:
    """Social context ``[N, H]`` from last-frame states ``x4_last [N, 4]``,
    hidden states ``h [N, H]`` and scene ids ``[N]`` (-1 = padding).

    On CUDA with a gradient to take, the forward keeps its softmax stats
    and the backward runs the dq/dkv kernels; without one, the forward
    alone runs and writes no stats.  ``max_scene`` > 0 promises sorted,
    contiguous scenes of at most that many rows and lets every kernel scan
    only its tile's window (the dense CPU form finds the same pairs).
    Under ``torch.func.vmap`` over ensemble members (any operand batched)
    the call goes through ``_SocialAttention``'s ``vmap`` rule: one member
    launch for all members, with stats when grad mode is on.

    The operand dtype is ``h``'s (float32 or bf16), as in JAX's kernel
    wrapper: ``wh`` (computed in float32) and the MLP's weights are cast to
    it, ``x4_last`` to float32, and the output has ``h``'s dtype."""
    _check_window(max_scene)
    if h.device.type == "cpu":
        return social_attention_plain(feat_mlp, attn_w, x4_last, h, scene_ids)
    if h.device.type != "cuda":
        raise ValueError(f"social_attention_fwd: unsupported device {h.device}")
    op = h.dtype
    weights = [t.to(op) for layer in feat_mlp for t in (layer.w, layer.b)]
    hf = h.float()
    wh = linear_apply(attn_w, hf)
    x4 = x4_last.float()
    operands = [x4, scene_ids, hf, wh, *weights]
    grad = torch.is_grad_enabled()
    if any(is_batchedtensor(t) for t in operands) or (grad and any(
            t.requires_grad for t in operands)):
        return _SocialAttention.apply(max_scene, op, grad, *operands)[0]
    return _launch_fwd(x4, scene_ids, h, wh.to(op), weights,
                       with_stats=False, max_scene=max_scene)[0].to(op)


def social_attention(feat_mlp: MLP, attn_w: Linear, x4_last: torch.Tensor,
                     h: torch.Tensor, scene_ids: torch.Tensor,
                     max_scene: int = 0) -> torch.Tensor:
    """Size-aware dispatch (socialways_tpu/kernels/social_attention.py:
    747-784 with ``use_pallas`` off).  CPU: the dense form up to
    ``_DENSE_MAX_AGENTS`` agents; above, the windowed form when
    ``max_scene > 0`` (sorted, contiguous scenes of at most that many
    rows), else the blockwise form at block 256.  CUDA: the kernels at
    every N, scanning scene windows when ``max_scene > 0``.  Any other
    device raises."""
    _check_window(max_scene)
    if h.device.type == "cpu" and h.shape[0] > _DENSE_MAX_AGENTS:
        if max_scene > 0:
            return social_context_windowed(feat_mlp, attn_w, x4_last, h,
                                           scene_ids, max_scene)
        return social_context_blockwise(feat_mlp, attn_w, x4_last, h,
                                        scene_ids, block=256)
    return social_attention_fwd(feat_mlp, attn_w, x4_last, h, scene_ids,
                                max_scene)


for _wrapper in (social_attention_fwd, social_attention_bwd_dq,
                 social_attention_bwd_dkv):
    _wrapper.launches = 0          # float32 kernel
    _wrapper.launches_bf16 = 0     # bf16 kernel
    _wrapper.member_launches = 0        # of which member launches
    _wrapper.member_launches_bf16 = 0
