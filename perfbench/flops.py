"""Model FLOPs of a training step, a simulated window and a K-sample
forecast, counted from the shapes: the multiply-adds of every product the
algorithm needs (linear layers, LSTM gates, the social attention's pair
MLP, scores and pooling), two FLOPs each.  Elementwise work (activations,
gate math, Adam, the EMA) is not counted, nor is any recomputation: a
backward counts twice its forward's products (weights and inputs), or
once where only the inputs' gradient is taken.  Rows are the valid rows
(padding is not useful work) and pairs the ordered same-scene pairs.

The attention is counted in the form the kernels compute, which is the
cheapest: per pair the 3 -> 32 -> 64 layers and ``a2 . u_j`` (96 + 2048
+ 64), per row ``u_j = W3 wh_j`` (64 F) and ``wh_j = h_j W`` (H F), and
the pooling ``sum_j a_ij h_j`` (H a pair).

The peaks are NVIDIA's for one H100 SXM at 700 W, dense: 67 TFLOP/s in
float32 outside the tensor cores (TF32 off) and 989 TFLOP/s in bf16.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def pairs(ids: np.ndarray) -> int:
    """Ordered same-scene pairs of ``ids`` (-1 is padding)."""
    _, sizes = np.unique(ids[ids >= 0], return_counts=True)
    return int(np.sum(sizes.astype(np.int64) * (sizes - 1)))


def _macs(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds a row of each part takes, at the config's widths."""
    h, f, z = cfg["hidden_size"], cfg["social_feature_size"], cfg["noise_len"]
    t_p, t_n = cfg["n_past"], cfg["n_next"]
    d = h + f + z
    lstm_h = 2 * h * 4 * h
    feedback = 4 * h + lstm_h                   # embed + encoder LSTM
    return {
        "encode": t_p * feedback,
        "decode_step": (d * d + d * (d // 2) + (d // 2) * (d // 4)
                        + (d // 4) * 2 + feedback),
        "attn_row": h * f + 64 * f,
        "attn_pair": 96 + 2048 + 64 + h,
        "d_obsv": t_p * (4 + h) * 4 * h + h * (h // 2) + (h // 2) ** 2,
        "d_heads": (t_n * 4 * (h // 2) + (h // 2) ** 2
                    + h * (h // 2) + h // 2
                    + h * (h // 2) + (h // 2) * cfg["n_latent_codes"]),
    }


def rollout_macs(cfg: Dict, rows: int, n_pairs: int) -> int:
    m = _macs(cfg)
    return (rows * (m["encode"] + m["attn_row"]
                    + cfg["n_next"] * m["decode_step"])
            + n_pairs * m["attn_pair"])


def train_step_flops(cfg: Dict, rows: int, n_pairs: int) -> float:
    """One GAN step on ``rows`` valid rows: the rollout forward and its
    backward, 1 + ``n_unrolling_steps`` D updates (forward on the
    observations and on fake and real futures, and its backward), and the
    G phase's D forward with the backward to its inputs."""
    m = _macs(cfg)
    r = rollout_macs(cfg, rows, n_pairs)
    d_fwd = rows * (m["d_obsv"] + 2 * m["d_heads"])
    d_updates = 1 + cfg["n_unrolling_steps"]
    g_phase = rows * (m["d_obsv"] + 2 * m["d_heads"])
    return 2.0 * (3 * r + d_updates * 3 * d_fwd + g_phase)


def simulate_flops(cfg: Dict, rows: int, n_pairs: int, windows: int
                   ) -> float:
    return 2.0 * windows * rollout_macs(cfg, rows, n_pairs)


def forecast_flops(cfg: Dict, rows: int, n_pairs: int, k: int) -> float:
    """Encode and pool once, decode ``k`` draws of every row."""
    m = _macs(cfg)
    return 2.0 * (rows * (m["encode"] + m["attn_row"]
                          + k * cfg["n_next"] * m["decode_step"])
                  + n_pairs * m["attn_pair"])
