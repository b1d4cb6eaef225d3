"""Social GAN's yardstick: model FLOPs of a simulated window and the pool
kernel's least time on the H100, counted from the shapes.

Model FLOPs count the published form (sgan/models.py), two FLOPs a
multiply-add of every product: a pair (i, j) of one scene, i = j
included, takes the embedding 2 x E, layer 1 (E + H) x 512 and layer 2
512 x B; an agent takes the encoder (T steps of the embedding 2 x E and
the LSTM's (E + H) x 4H gate product), the context MLP and the decoder
(the first embedding, then n_next steps of the LSTM, hidden2pos and the
embedding).  Elementwise work is not counted.

The pool's least time is the larger of its products at the bf16
tensor-core peak (989 TFLOP/s) and its bytes at 3.35 TB/s, for one H100
SXM at 700 W, dense.  The products are the least the pool needs: layer 2
for every pair (512 B), and layer 1 folded into per-agent terms (h_j W_1h
and p_j W_pe W_1e, (H + 2) 512 an agent; the pair then only adds).  The
bytes: positions, ids and h read once, the weights once, P written once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

POOL_WIDTH = 512
TC_FLOPS = 989e12           # bf16 dense tensor-core peak, H100 SXM
BYTES_PER_S = 3.35e12       # HBM3


def pairs(ids: np.ndarray) -> int:
    """Ordered same-scene pairs, each agent with itself included (-1 is
    padding)."""
    _, sizes = np.unique(ids[ids >= 0], return_counts=True)
    return int(np.sum(sizes.astype(np.int64) ** 2))


def _widths(cfg: Dict):
    return (cfg["embedding_dim"], cfg["encoder_h_dim"], cfg["decoder_h_dim"],
            cfg["mlp_dim"], cfg["bottleneck_dim"], cfg["noise_len"])


def window_macs(cfg: Dict, rows: int, n_pairs: int) -> int:
    e, h, d, mlp, b, z = _widths(cfg)
    pair = 2 * e + (e + h) * POOL_WIDTH + POOL_WIDTH * b
    encode = cfg["n_past"] * (2 * e + (e + h) * 4 * h)
    context = (h + b) * mlp + mlp * (d - z)
    decode = 2 * e + cfg["n_next"] * ((e + d) * 4 * d + d * 2 + 2 * e)
    return n_pairs * pair + rows * (encode + context + decode)


def simulate_flops(cfg: Dict, ids: np.ndarray, windows: int) -> float:
    rows = int(np.sum(ids >= 0))
    return 2.0 * windows * window_macs(cfg, rows, pairs(ids))


def pool_bound(cfg: Dict, ids: np.ndarray, op_bytes: int = 2) -> dict:
    """Least time of one pooling of the crowd ``ids`` (ms) and its
    parts."""
    e, h, _, _, b, _ = _widths(cfg)
    n, n_pairs = len(ids), pairs(ids)
    flop = 2.0 * (n_pairs * POOL_WIDTH * b + n * (h + 2) * POOL_WIDTH)
    weights = 2 * e + e + (e + h) * POOL_WIDTH + POOL_WIDTH + POOL_WIDTH * b + b
    nbytes = (n * (2 * op_bytes + 4 + h * op_bytes + b * 4)
              + weights * op_bytes)
    ops_ms, bytes_ms = flop / TC_FLOPS * 1e3, nbytes / BYTES_PER_S * 1e3
    return {"flop": flop, "bytes": nbytes, "pairs": n_pairs,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
