"""The bf16 observation encoder of a rollout as one hand-written CUDA kernel.

``encode_observation_bf16`` runs ``models/generator.py``
``encode_observation`` (the embedding 4 -> hidden and T steps of the
encoder LSTM from a zero state) in one launch of
``csrc/encode_observation_bf16.cu``: the weights resident in each block's
shared memory, a warp's 16 rows in registers for all the steps, both
products of a step on ``mma.sync`` bf16 -> f32, precise gate math.  The
library holds one instantiation for each padded hidden width of 16, 32,
48 and 64 (the width itself is read at run time); a wider model is
refused.  It rounds where the plain path rounds; only the order of float32
sums differs (the kernel's notes).  It replaces no TPU kernel (JAX leaves
the encoder to XLA), and has no plain version of its own: the plain
encoder is ``encode_observation``'s embedding and ``ops/lstm.lstm_seq``,
which the CPU, float32, an encode under autograd and ensemble members
take (the dispatch is ``models/generator.py`` ``fused_encode``); a bf16
encode on the card past hidden 64 raises here, as the fused decode
does.

The launch allocates nothing but its outputs and does not synchronise, so
a CUDA graph can capture it; ``launches`` counts launches the way the
other wrappers do, registered with kernels/launches.py.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from socialways_torch.kernels.decode_rollout import check_bf16
from socialways_torch.kernels.launches import register

_LIB = "encode_observation_bf16"
#: the widest hidden size the library holds (csrc: four k-tiles of 16)
MAX_HIDDEN = 64


def _entry():
    from socialways_torch.kernels._build import load
    f = getattr(load(_LIB), _LIB)
    f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def encode_observation_bf16(params, obsv_4d: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, c) [N, hidden] bf16 of ``encode_observation``: ``params`` is the
    bf16 view of a generator (``embed``, ``encoder``) and ``obsv_4d`` [N,
    T, 4] bf16, its rows and steps at any even stride and its columns
    unit-strided.  Raises on widths, dtypes or layouts the kernel does not
    take."""
    x = obsv_4d
    dev = x.device
    if x.dim() != 3 or x.shape[-1] != 4:
        raise ValueError(f"obsv_4d must be [N, T, 4], got {tuple(x.shape)}")
    n, steps = x.shape[0], x.shape[1]
    check_bf16("obsv_4d", x, (n, steps, 4), dev, rows_strided=True)
    hid = params.embed.w.shape[-1]
    if hid > MAX_HIDDEN:
        raise ValueError(f"the fused encoder holds hidden widths up to "
                         f"{MAX_HIDDEN} in registers, got {hid}")
    for name, t, shape in [("embed.w", params.embed.w, (4, hid)),
                           ("embed.b", params.embed.b, (hid,)),
                           ("encoder.w", params.encoder.w, (2 * hid, 4 * hid)),
                           ("encoder.b", params.encoder.b, (4 * hid,))]:
        check_bf16(name, t, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"the fused encoder runs on CUDA, obsv_4d is on "
                         f"{dev}")
    h, c = (torch.empty((n, hid), dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    if n == 0:
        return h, c
    ptrs = [t.data_ptr() for t in (x, params.embed.w, params.embed.b,
                                   params.encoder.w, params.encoder.b, h, c)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(*ptrs, n, x.stride(0), x.stride(1), steps, hid, stream)
    if err:
        raise RuntimeError(f"{_LIB} launch failed: CUDA error {err}")
    encode_observation_bf16.launches += 1
    return h, c


register(encode_observation_bf16, "launches")
