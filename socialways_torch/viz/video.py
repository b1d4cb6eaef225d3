"""Video / scene display utilities, on the host: a copy of
socialways_tpu/viz/video.py.

Capability parity with the reference ``utils/visualization_utils.py``:
``Display`` overlays agents and paths on dataset video frames through a
homography (the reference version references an un-imported cv2 and cannot
run — this one works); ``FakeDisplay`` is the no-op stand-in for headless
runs; ``parse_annotations`` re-shapes an obsmat into per-frame agent lists;
``plot_prediction_metrics`` renders error curves.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def to_pixels(hinv: np.ndarray, loc: np.ndarray) -> tuple:
    """World (x, y, 1) to integer pixel (col, row) for cv2 drawing
    (visualization_utils.py:257-263)."""
    loc = np.dot(hinv, np.asarray([loc[0], loc[1], 1.0]))
    return (int(loc[1] / loc[2]), int(loc[0] / loc[2]))


_COLORS = {"b": (255, 0, 0), "g": (0, 255, 0), "r": (0, 0, 255),
           "m": (255, 0, 255), "y": (0, 255, 255)}


class FakeDisplay:
    """No-op display for headless pipelines (visualization_utils.py:12-24)."""

    def __init__(self, datadir: str = "") -> None:
        pass

    def grab_frame(self, frame_id) -> bool:
        return False

    def plot_path(self, path, pid=-1, args="") -> None:
        pass

    def plot_ped(self, pos=(0, 0), pid=-1, color=(0, 0, 192)) -> None:
        pass

    def add_orig_frame(self, alpha=0.5) -> None:
        pass

    def show(self, title="frame") -> None:
        pass

    def save(self, path: str) -> None:
        pass


class Display(FakeDisplay):
    """Overlay agents/paths on dataset video frames via the homography.

    Expects ``datadir`` to hold ``H.txt`` and a video file (``*.avi``); a
    still reference image works too (``reference.jpg``/``map.png``).
    """

    def __init__(self, datadir: str, video_name: Optional[str] = None,
                 scale: float = 1.0) -> None:
        import cv2
        self._cv2 = cv2
        self.H = np.loadtxt(os.path.join(datadir, "H.txt"))
        self.Hinv = np.linalg.inv(self.H)
        s = np.eye(3)
        s[0, 0] = s[1, 1] = scale
        self.Hinv = s @ self.Hinv @ np.linalg.inv(s)
        self.scale = scale

        self.cap = None
        if video_name is None:
            avis = [f for f in sorted(os.listdir(datadir))
                    if f.endswith((".avi", ".mp4"))]
            video_name = avis[0] if avis else None
        if video_name:
            self.cap = cv2.VideoCapture(os.path.join(datadir, video_name))
        self._still = None
        for still in ("reference.jpg", "map.png"):
            p = os.path.join(datadir, still)
            if self._still is None and os.path.exists(p):
                self._still = cv2.imread(p)
        self.output = None
        self.orig_frame = None

    def grab_frame(self, frame_id) -> bool:
        cv2 = self._cv2
        if self.cap is not None and self.cap.isOpened():
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_id)
            ret, frame = self.cap.read()
            if not ret:
                return False
        elif self._still is not None:
            frame = self._still.copy()
        else:
            return False
        if self.scale != 1.0:
            frame = cv2.resize(frame, (0, 0), fx=self.scale, fy=self.scale)
        self.output = frame
        self.orig_frame = frame.copy()
        return True

    def plot_ped(self, pos=(0, 0), pid=-1, color=(0, 0, 192)) -> None:
        cv2 = self._cv2
        pix = to_pixels(self.Hinv, np.asarray(pos))
        cv2.circle(self.output, pix, 5, color, 1, cv2.LINE_AA)
        if pid >= 0:
            cv2.putText(self.output, f"{pid}", pix,
                        cv2.FONT_HERSHEY_SCRIPT_SIMPLEX, 0.5, (0, 0, 200), 2)

    def plot_path(self, path, pid=-1, args="") -> None:
        cv2 = self._cv2
        color = _COLORS.get(args[:1], (255, 255, 255))
        last = None
        for pos in np.asarray(path):
            pix = to_pixels(self.Hinv, pos[:2])
            if "--" in args:
                if last is not None:
                    cv2.line(self.output, last, pix, color, 1, cv2.LINE_AA)
                last = pix
            elif "." in args:
                cv2.circle(self.output, pix, 3, color, -1, cv2.LINE_AA)
            else:
                cv2.circle(self.output, pix, 5, color, 1, cv2.LINE_AA)

    def add_orig_frame(self, alpha: float = 0.5) -> None:
        self.output = self._cv2.addWeighted(self.orig_frame, alpha,
                                            self.output, 1 - alpha, 0)

    def save(self, path: str) -> None:
        self._cv2.imwrite(path, self.output)

    def show(self, title: str = "frame") -> None:  # pragma: no cover
        self._cv2.imshow(title, self.output)
        self._cv2.waitKey(1)


def parse_annotations(obsmat_txt: str):
    """obsmat rows to (frames, timesteps, agents-per-frame) structure
    (visualization_utils.py:286-310 semantics, minus the pixel projection).

    Returns (timesteps [F], agent_ids [F][...], positions [F][...,2])."""
    mat = np.loadtxt(obsmat_txt)
    ts = np.unique(mat[:, 0].astype(int))
    agent_ids, positions = [], []
    for t in ts:
        rows = mat[mat[:, 0].astype(int) == t]
        agent_ids.append(rows[:, 1].astype(int))
        positions.append(rows[:, [2, 4]])
    return ts, agent_ids, positions


def plot_prediction_metrics(prediction_errors, path_errors, agents,
                            out_file: Optional[str] = None) -> None:
    """Error-curve figure (visualization_utils.py:152-172)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(1, (10, 10))
    plt.clf()
    if len(prediction_errors) > 0:
        for sub, (title, errors) in enumerate(
                [("Prediction Error", prediction_errors),
                 ("Path Error", path_errors)], start=1):
            plt.subplot(2, 1, sub)
            plt.title(title)
            plt.xlabel("Time (frames)")
            plt.ylabel("Error")
            e = np.asarray(errors, dtype=float)
            lines = plt.plot(e)
            mean = plt.plot(np.nanmean(e, axis=1), "k--", lw=4)
            plt.legend(lines + mean,
                       [f"{a}" for a in agents] + ["mean"])
    if out_file:
        plt.savefig(out_file)
