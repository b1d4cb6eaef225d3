"""The bf16 FC decode of a rollout as one hand-written CUDA kernel.

``decode_rollout_bf16`` runs the whole ``n_next``-step decode of
``models/generator.py`` ``decode_rollout`` (FC decoder, feedback through
the encoder LSTM) in one launch of ``csrc/decode_rollout_bf16.cu``: the
weights resident in each block's shared memory, a warp's 16 rows in
registers for all the steps, every product on ``mma.sync`` bf16 -> f32.
The library holds one instantiation for each padded shape of ``SHAPES``,
which cover hidden and social widths up to 64 and noise up to 64, and
one with the crowd widths (64, 64, 32) compiled in; a wider model does
not fit an SM's shared memory and is refused.
It rounds where the plain decode rounds; only the order of float32 sums
differs (the kernel's notes).  It replaces no TPU kernel (JAX leaves the
decode to XLA), and has no plain version of its own: the plain decode is
``decode_rollout``'s loop, which the CPU, float32, the LSTM decoder, a
rollout under autograd and ensemble members take (the dispatch is
``models/generator.py`` ``fused_decode``).

The prepared ``(h, c, s, last_p)`` hold N rows and the noise R N: output
row r N + i reads prepared row i, so K draws of a forecast need no K
copies of the encoding.  The launch allocates nothing but its output and
does not synchronise, so a CUDA graph can capture it; ``launches`` counts
launches the way the attention wrappers do, registered with
kernels/launches.py (a capture's count is taken back out and credited a
replay by ``captured_launches`` and ``credit_launches``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from socialways_torch.kernels.launches import register

_LIB = "decode_rollout_bf16"
#: the padded shapes the library is built for (csrc/decode_rollout_bf16.cu
#: ``kShapes``), smallest first: (hidden and social tiles, noise tiles) of
#: 16 columns
SHAPES = ((1, 1), (2, 1), (3, 2), (4, 2), (4, 4))


def padded_shape(hidden: int, social: int, noise: int):
    """The instantiation a model of these widths runs on, or None when
    none holds it (the weights would not fit an SM's shared memory)."""
    t, zt = -(-max(hidden, social) // 16), -(-noise // 16)
    return next((sh for sh in SHAPES if sh[0] >= t and sh[1] >= zt), None)


def _entry():
    from socialways_torch.kernels._build import load
    f = getattr(load(_LIB), _LIB)
    f.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_longlong] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check_bf16(name: str, t: torch.Tensor, shape: Tuple[int, ...],
               device: torch.device, rows_strided: bool = False) -> None:
    """bf16 on ``device`` with ``shape``; contiguous, or (``rows_strided``,
    read two columns at a time) unit columns, even strides in every other
    dimension and 4-byte aligned.  The operand check of the fused LSTM
    kernels' wrappers (this one and ``kernels/encode_observation.py``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} has dtype {t.dtype}, expected bfloat16")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if rows_strided:
        if t.stride(-1) != 1 or any(st % 2 for st in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit columns and even strides "
                             f"in the other dimensions, got strides "
                             f"{t.stride()}")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def decode_rollout_bf16(params, prep: Sequence[torch.Tensor],
                        noise: torch.Tensor, n_next: int) -> torch.Tensor:
    """pred_4d [R N, n_next, 4] bf16 of ``decode_rollout`` with the FC
    decoder: ``params`` is the bf16 view of a generator (``decoder``,
    ``embed``, ``encoder``), ``prep`` = ``(h, c, s, last_p)`` of N rows
    (h, c [N, hidden], s [N, social], last_p [N, 2]) and ``noise`` [R N,
    noise].  Raises on widths, dtypes or layouts the kernel does not
    take."""
    h, c, s, last_p = prep
    dev = h.device
    if h.dim() != 2 or noise.dim() != 2:
        raise ValueError(f"h and noise must be 2-d, got {tuple(h.shape)} "
                         f"and {tuple(noise.shape)}")
    n, rows = h.shape[0], noise.shape[0]
    if n == rows == 0:
        return torch.empty((0, n_next, 4), dtype=torch.bfloat16, device=dev)
    if n == 0 or rows % n:
        raise ValueError(f"noise rows ({rows}) must be a multiple of the "
                         f"prepared rows ({n})")
    if n_next < 0:
        raise ValueError(f"n_next must be >= 0, got {n_next}")
    hid, soc, nz = h.shape[1], s.shape[-1], noise.shape[1]
    if padded_shape(hid, soc, nz) is None:
        raise ValueError(f"the fused decode holds hidden and social widths "
                         f"up to 64 and noise up to 64 in an SM's shared "
                         f"memory, got {hid}, {soc} and {nz}")
    d = hid + soc + nz
    layers = params.decoder
    widths = [d, d, d // 2, d // 4, 2]
    if len(layers) != 4:
        raise ValueError(f"the fused decode takes the 4-layer FC decoder, "
                         f"got {len(layers)} layers")
    for name, t, shape in [("h", h, (n, hid)), ("c", c, (n, hid)),
                           ("s", s, (n, soc)), ("noise", noise, (rows, nz))]:
        check_bf16(name, t, shape, dev)
    check_bf16("last_p", last_p, (n, 2), dev, rows_strided=True)
    weights = []
    for i, p in enumerate(layers):
        weights += [(f"decoder.{i}.w", p.w, (widths[i], widths[i + 1])),
                    (f"decoder.{i}.b", p.b, (widths[i + 1],))]
    weights += [("embed.w", params.embed.w, (4, hid)),
                ("embed.b", params.embed.b, (hid,)),
                ("encoder.w", params.encoder.w, (2 * hid, 4 * hid)),
                ("encoder.b", params.encoder.b, (4 * hid,))]
    for name, t, shape in weights:
        check_bf16(name, t, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"the fused decode runs on CUDA, h is on {dev}")
    out = torch.empty((rows, n_next, 4), dtype=torch.bfloat16, device=dev)
    args = [t for _, t, _ in weights] + [h, c, s, last_p, noise, out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(*[t.data_ptr() for t in args], n, rows,
                       last_p.stride(0), n_next, hid, soc, nz, stream)
    if err:
        raise RuntimeError(f"{_LIB} launch failed: CUDA error {err}")
    decode_rollout_bf16.launches += 1
    return out


register(decode_rollout_bf16, "launches")
