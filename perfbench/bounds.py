"""The attention kernels' least times on the H100: frozen copies of the
program's bound arithmetic (``chip_smoke.py``'s ``attention_bound`` and
``attention_bwd_bound``, with the tensor-core recount of the bf16
backward's float32 cotangents), kept here so that a change to the program
cannot move the yardstick.  A CPU test holds them equal to the originals.

A bound is the larger of the operations at the peak rates (FP32 FMA 67
TFLOP/s; products of two bf16 operands 989 TFLOP/s on the tensor cores)
and the bytes at 3.35 TB/s, published for one H100 SXM at 700 W, dense.
"""

from __future__ import annotations

import numpy as np

H100_F32_FLOPS = 67e12              # FP32 (non-tensor) peak, H100 SXM
H100_BF16_TC_FLOPS = 989e12         # bf16 dense tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12          # HBM3


def _pairs(ids: np.ndarray) -> int:
    _, sizes = np.unique(ids[ids >= 0], return_counts=True)
    return int(np.sum(sizes * (sizes - 1)))


def _bound(flop: float, nbytes: float, tc_flop: float = 0.0) -> dict:
    """``flop`` at the FP32 peak plus ``tc_flop`` (products of bf16
    operands) at the bf16 tensor-core peak, against ``nbytes`` at the HBM
    rate."""
    ops_ms = (flop / H100_F32_FLOPS + tc_flop / H100_BF16_TC_FLOPS) * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"flop": flop, "tc_flop": tc_flop, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                    n_mlp: int, with_wh: bool = False,
                    op_bytes: int = 4, members: int = 1) -> dict:
    """Least time of the social-attention forward on this input, in the
    u-form the kernel computes: same-scene ordered pairs x (3->32 and
    32->64 layers and a2 . u_j: 96 + 2048 + 64 MAC), u = W3 wh (N 64 F)
    and, where the timed call includes it, wh = h W + b (N H F), at the f32
    peak; against the bytes of x4, ids, h, wh (or, with ``with_wh``, the
    attention weights W, b), the ``n_mlp`` feature-MLP weights, out, u and
    c at the HBM rate.  ``old_*``: the count of the f_ij . wh_j form
    (64 F + 2 F MAC a pair instead of 64), for comparison.  ``op_bytes``:
    the bytes of an element of h, wh and the weights (4, or 2 for bf16
    operands).  With bf16 operands the same operations are counted, but
    every product of two bf16 operands with float32 sums (the 3->32 and
    32->64 layers, u = W3 wh and wh = h W) is costed at the bf16
    tensor-core peak; a2 . u_j (u float32) stays at the FP32 peak.
    ``members``: M stacked models in one launch on one shared x4 and ids,
    which are read once; every other byte and every operation counts M
    times."""
    pairs = _pairs(ids)
    wh_mac = n * hdim * feat if with_wh else 0
    bf16_able = members * (pairs * (96 + 2048) + n * 64 * feat + wh_mac)
    tc_mac = bf16_able if op_bytes == 2 else 0
    f32_mac = members * pairs * 64 + bf16_able - tc_mac
    old_f32_mac = (members * pairs * (64 * feat + 2 * feat) + bf16_able
                   - tc_mac)
    own = op_bytes * (n_mlp + (hdim * feat + feat if with_wh else n * feat))
    nbytes = (4 * (4 * n + n)
              + members * (4 * (n * hdim + 65 * n) + op_bytes * n * hdim
                           + own))
    out = _bound(2 * f32_mac, nbytes, 2 * tc_mac)
    out.update(pairs_needed=pairs, pairs_id_tested=n * n,
               old_bound_ms=_bound(2 * old_f32_mac, nbytes,
                                   2 * tc_mac)["bound_ms"])
    return out


def attention_bwd_bound(ids: np.ndarray, n: int, hdim: int, feat: int,
                        n_mlp: int, kernel: str, op_bytes: int = 4,
                        members: int = 1) -> dict:
    """Least time of a backward kernel on this input.  Per same-scene pair
    both recompute the score (features, 3->32 and 32->64 layers, and
    a2 . u_j with the forward's u_j = W3 wh_j: 96 + 2048 + 64 MAC), take
    g_i . h_j (H) and pull ds back to the features (the z2 cotangent 64,
    64->32: 2048).  dq adds the 32->3 feature cotangent (96); dkv adds
    dh_j (H), the dW2 outer product (2048), db2 (64), A_j (64) and
    dW1/db1 (128), and per column dwh_j (N 64 F) and dW3, db3 (N 64 F +
    N F).  Neither computes u or c: both read the forward's.  Bytes: x4,
    ids, h, wh, g, stats, r, u, c and the MLP weights read once, the
    outputs written once; h, wh and the weights ``op_bytes`` an element.
    With bf16 operands the products the bf16 kernels take on the tensor
    cores are costed at the bf16 tensor-core peak: the recomputed 3->32
    and 32->64 layers (2144 MAC a pair, bf16 x bf16) once, and each
    product of a float32 cotangent, which enters as three exact bf16
    pieces, three times (dq: 64->32; dkv: 64->32, dW2, db2, dW1/db1);
    every other product (with u, g or h_j's float cotangent sums) at the
    FP32 peak.  ``members`` as in ``attention_bound``: x4 and ids once,
    the rest M times."""
    pairs = _pairs(ids)
    layers = 96 + 2048
    if kernel == "dq":
        split, fma = 2048, 64 + hdim + 64 + 96
    else:
        split, fma = 2048 + 2048 + 64 + 128, 64 + hdim + 64 + hdim + 64
    if op_bytes == 2:
        tc_mac = members * pairs * (layers + 3 * split)
        mac = members * pairs * fma
    else:
        tc_mac = 0
        mac = members * pairs * (layers + split + fma)
    in_bytes = 4 * (4 * n + n) + members * (
        4 * (n * hdim + 3 * n + 65 * n)
        + op_bytes * (n * hdim + n * feat + n_mlp))
    if kernel == "dq":
        out_bytes = members * 4 * 4 * n
    else:
        mac += members * (2 * n * 64 * feat + n * feat)
        out_bytes = members * 4 * (n * hdim + n * feat + n_mlp)
    out = _bound(2 * mac, in_bytes + out_bytes, 2 * tc_mac)
    out["pairs_needed"] = pairs
    return out


def feat_mlp_elems(feat: int) -> int:
    """Elements of the feature MLP's weights and biases (3 -> 32 -> 64 ->
    F), the ``n_mlp`` the bounds read."""
    return 3 * 32 + 32 + 32 * 64 + 64 + 64 * feat + feat
