"""EMD / 1-NN vs-iteration curve figures (calc_statistics.py:122-144), on
the host: a copy of socialways_tpu/viz/stats_plots.py.

The reference's ``plot_stats_1nn`` / ``plot_stats_wst`` overlay the cached
``stats<K>.npz`` curves of several GAN variants (VanillaGAN, InfoGAN,
Unrolled10, ...) — the paper's Fig. 5 machinery.  Same semantics here:
1-NN accuracy is plotted in percent with the 50% two-sample-ideal line
shaded toward each curve, EMD raw with the zero line shaded, x axis in
training iterations.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_STYLE = ["-o", "-s", "-^", "-v", "-x", "-d", "-*"]


def _load_cache(run_dir: str, num_samples: int):
    f = os.path.join(run_dir, f"stats{num_samples}.npz")
    if not os.path.exists(f):
        raise FileNotFoundError(
            f"{f} missing — run `cli stats --preds-dir {run_dir}` first "
            "(or pass --real-npz so it can be computed)")
    with np.load(f) as d:
        return d["epochs"], d["stats_1nn"], d["stats_wst"]


def plot_stats_curves(run_dirs: Sequence[str],
                      out_png: str,
                      labels: Optional[Sequence[str]] = None,
                      num_samples: int = 20,
                      iters_per_epoch: int = 1) -> str:
    """Two-panel comparison figure: 1-NN accuracy (%) and EMD vs training
    iteration, one curve per run dir (multi-variant overlay like the
    reference's plot_stats_* with its ``args``/``colors`` tables)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = list(labels or [os.path.basename(os.path.normpath(d)) or d
                             for d in run_dirs])
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))

    for i, run_dir in enumerate(run_dirs):
        epochs, one_nn, wst = _load_cache(run_dir, num_samples)
        iters = epochs * iters_per_epoch
        style = _STYLE[i % len(_STYLE)]
        acc = one_nn * 100.0
        (line,) = ax1.plot(iters, acc, style, lw=1, ms=3, label=labels[i])
        ax1.fill_between(iters, acc, np.full_like(acc, 50.0),
                         color=line.get_color(), alpha=0.2)
        (line2,) = ax2.plot(iters, wst, style, lw=1, ms=3, label=labels[i])
        ax2.fill_between(iters, wst, np.zeros_like(wst),
                         color=line2.get_color(), alpha=0.2)

    ax1.axhline(50.0, color="k", lw=0.8, ls="--")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("1-NN accuracy (%)  [50% = ideal]")
    ax1.set_title("1-NN two-sample test")
    ax1.legend(fontsize=8)
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("EMD (Wasserstein)")
    ax2.set_title("Earth mover's distance")
    ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return out_png
