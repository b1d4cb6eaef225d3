"""Offline prediction-heatmap rendering, on the host (numpy and cv2).

A copy of socialways_tpu/viz/heatmap.py (reference visualize.py:8-57,
156-252): world to pixel through an inverse homography, per-sample
prediction polylines rasterized and accumulated into a density map,
box-blurred, colored with cv2's magma map and alpha-blended over the
scene (a camera frame or a blank canvas), observed trajectories
overdrawn.  cv2 is imported where it is used, so the module imports on a
host without it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def to_image_frame(hinv: np.ndarray, loc: np.ndarray) -> np.ndarray:
    """World to pixel coordinates via H^-1 (reference visualize.py:8-21).

    loc: [T, 2] -> [T, 2] int pixel coords."""
    homo = np.hstack((loc, np.ones((loc.shape[0], 1))))
    pix = (hinv @ homo.T)
    pix = (pix / pix[2]).T
    return pix[:, :2].astype(int)


def _line(im: np.ndarray, pts: np.ndarray, value, width: int) -> None:
    """Polyline with the reference's (row, col) -> (x, y) swap
    (visualize.py:24-26)."""
    import cv2
    for t in range(pts.shape[0] - 1):
        cv2.line(im, (int(pts[t][1]), int(pts[t][0])),
                 (int(pts[t + 1][1]), int(pts[t + 1][0])), value, width)


def default_toy_hinv(im_size: int = 480) -> np.ndarray:
    """The reference's toy projection: 200x scale, centered
    (visualize.py:152-153)."""
    hinv = np.eye(3)
    hinv[0, 0] = hinv[1, 1] = 200.0
    hinv[0, 2] = hinv[1, 2] = im_size / 2.0
    return hinv


def prediction_density(preds_our: np.ndarray, hinv: np.ndarray,
                       shape: Tuple[int, int], line_width: int = 10,
                       blur: int = 15, max_samples: Optional[int] = None
                       ) -> np.ndarray:
    """Rasterize K-sample predictions into a blurred density map [H, W].

    preds_our: [K, N, T, 2] world coords.  The reference rasterizes only
    K//8 samples (visualize.py:38): pass max_samples to match."""
    import cv2
    k, n = preds_our.shape[0], preds_our.shape[1]
    if max_samples is not None:
        k = min(k, max_samples)
    acc = np.zeros(shape, np.float32)
    layer = np.zeros(shape, np.uint8)
    for kk in range(k):
        layer[:] = 0
        for ii in range(n):
            _line(layer, to_image_frame(hinv, preds_our[kk, ii]), 1,
                  line_width)
        acc += layer
    return cv2.blur(acc, (blur, blur))


def render_scene(obsvs: np.ndarray, preds_our: np.ndarray,
                 hinv: Optional[np.ndarray] = None,
                 bg: Optional[np.ndarray] = None,
                 im_size: int = 480,
                 epoch: Optional[int] = None) -> np.ndarray:
    """Render one dumped scene: prediction heatmap + observed trajectories.

    obsvs: [N, n_past, 2]; preds_our: [K, N, n_next, 2] (world coords, as
    dumped).  Returns a BGR uint8 image."""
    import cv2
    if hinv is None:
        hinv = default_toy_hinv(im_size)
    if bg is None:
        im = np.full((im_size, im_size, 3), 128, np.uint8)
    else:
        im = bg.copy()

    n = obsvs.shape[0]
    # the predictions start from the last observation, so the lines connect
    last = np.broadcast_to(obsvs[None, :, -1:, :],
                           (preds_our.shape[0], n, 1, 2))
    preds_aug = np.concatenate([last, preds_our], axis=2)

    dens = prediction_density(preds_aug, hinv, im.shape[:2])
    if dens.max() > 0:
        dens_n = (dens / dens.max() * 255).astype(np.uint8)
        heat = cv2.applyColorMap(dens_n, cv2.COLORMAP_MAGMA)
        mask = (dens_n > 8)[..., None].astype(np.float32)
        im = (im * (1 - 0.6 * mask) + heat * (0.6 * mask)).astype(np.uint8)

    for ii in range(n):
        _line(im, to_image_frame(hinv, obsvs[ii]), (255, 20, 0), 2)

    if epoch is not None:
        cv2.putText(im, f"Epoch= {epoch:05d}", (15, 50),
                    cv2.FONT_HERSHEY_DUPLEX, 0.8, (50, 50, 250))
    return im


def render_preds_dir(preds_dir: str, out_dir: str,
                     bg_image: str = "", homography: str = "") -> str:
    """Render every npz of a prediction-dump tree (the io/dumps.py schema)
    to ``out_dir/<epoch>.png`` (reference visualize.py:156-252)."""
    import cv2
    hinv = None
    if homography and os.path.exists(homography):
        hinv = np.linalg.inv(np.loadtxt(homography))
    bg = cv2.imread(bg_image) if bg_image and os.path.exists(bg_image) \
        else None

    os.makedirs(out_dir, exist_ok=True)
    n_rendered = 0
    for dirpath, _, filenames in sorted(os.walk(preds_dir)):
        for f in sorted(filenames):
            if "stats" in f or not f.endswith(".npz"):
                continue
            with np.load(os.path.join(dirpath, f)) as data:
                obsvs, preds_our = data["obsvs"], data["preds_our"]
            epc_str = f[:f.rfind("-")]
            epoch = int(epc_str) if epc_str.isdigit() else n_rendered
            im = render_scene(obsvs, preds_our, hinv, bg, epoch=epoch)
            cv2.imwrite(os.path.join(out_dir, f"{epoch:05d}.png"), im)
            n_rendered += 1
    return out_dir
