"""Raw-track eyeballing plot, on the host: a copy of
socialways_tpu/viz/tracks.py.

Capability parity with the reference's scratch script ``pick_subset.py:1-22``
(parse an annotation file, draw every agent's track in blue with a red star
at its start, to eyeball which subset of a recording is usable).  Differences:
writes a PNG instead of blocking on ``plt.show()``; the reference's unused
``min_len`` variable (pick_subset.py:14) is an actual filter here; any of the
four parsers can feed it, not just SDD.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def plot_tracks(p_data: Sequence[np.ndarray], out_path: str,
                min_len: int = 0, title: Optional[str] = None,
                max_tracks: int = 0) -> int:
    """Render per-agent [Ti, 2] tracks to ``out_path``.

    Returns the number of tracks drawn (those with Ti >= min_len, first
    ``max_tracks`` if positive)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kept: List[np.ndarray] = [np.asarray(p) for p in p_data
                              if len(p) >= min_len]
    if max_tracks > 0:
        kept = kept[:max_tracks]
    fig, ax = plt.subplots(figsize=(8, 8))
    for track in kept:
        ax.plot(track[:, 0], track[:, 1], "b", linewidth=0.7)
        ax.plot(track[0, 0], track[0, 1], "r*", markersize=4)
    ax.set_aspect("equal", adjustable="datalim")
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return len(kept)
