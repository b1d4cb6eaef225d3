"""Spatial normalization to the unit box.

A copy of socialways_tpu/data/scale.py.  Semantics-parity with the
reference ``Scale`` (utils/parse_utils.py:11-76):
fit a min/max box, optionally preserve aspect ratio by taking the smaller of
the two axis scales for both, and map (x, y) into [0, 1].  Works on arrays of
any rank whose last axis is (x, y); the reference special-cased ndim 1-4 —
here a single vectorized path covers all ranks.
"""

from __future__ import annotations

import math

import numpy as np


class Scale:
    """Fit/apply a [0,1]-box normalization over 2-D positions."""

    def __init__(self) -> None:
        self.min_x = math.inf
        self.max_x = -math.inf
        self.min_y = math.inf
        self.max_y = -math.inf
        self.sx = 1.0
        self.sy = 1.0

    # -- fitting -----------------------------------------------------------
    def fit(self, points: np.ndarray) -> "Scale":
        """Grow the box to cover ``points`` ([..., 2])."""
        pts = np.asarray(points).reshape(-1, 2)
        if pts.size:
            self.min_x = min(self.min_x, float(pts[:, 0].min()))
            self.max_x = max(self.max_x, float(pts[:, 0].max()))
            self.min_y = min(self.min_y, float(pts[:, 1].min()))
            self.max_y = max(self.max_y, float(pts[:, 1].max()))
        return self

    def calc_scale(self, keep_ratio: bool = True) -> "Scale":
        self.sx = 1.0 / (self.max_x - self.min_x)
        self.sy = 1.0 / (self.max_y - self.min_y)
        if keep_ratio:
            # Both axes use the smaller scale (reference parse_utils.py:26-30).
            s = min(self.sx, self.sy)
            self.sx = s
            self.sy = s
        return self

    # -- transforms --------------------------------------------------------
    def normalize(self, data: np.ndarray, shift: bool = True,
                  in_place: bool = False) -> np.ndarray:
        out = np.asarray(data) if in_place else np.array(data, copy=True)
        sh = 1.0 if shift else 0.0
        out[..., 0] = (out[..., 0] - self.min_x * sh) * self.sx
        out[..., 1] = (out[..., 1] - self.min_y * sh) * self.sy
        return out

    def denormalize(self, data: np.ndarray, shift: bool = True,
                    in_place: bool = False) -> np.ndarray:
        out = np.asarray(data) if in_place else np.array(data, copy=True)
        sh = 1.0 if shift else 0.0
        out[..., 0] = out[..., 0] / self.sx + self.min_x * sh
        out[..., 1] = out[..., 1] / self.sy + self.min_y * sh
        return out

    # -- (de)serialization (checkpointing needs the fit box) ---------------
    def to_dict(self) -> dict:
        return {
            "min_x": self.min_x, "max_x": self.max_x,
            "min_y": self.min_y, "max_y": self.max_y,
            "sx": self.sx, "sy": self.sy,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scale":
        s = cls()
        for k, v in d.items():
            setattr(s, k, float(v))
        return s

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Scale(x=[{self.min_x:.3f},{self.max_x:.3f}], "
                f"y=[{self.min_y:.3f},{self.max_y:.3f}], "
                f"s=({self.sx:.5f},{self.sy:.5f}))")
