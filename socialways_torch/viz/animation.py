"""Toy-dataset animation (reference ``ToyAnimation``, create_toy.py:70-141),
on the host: a copy of socialways_tpu/viz/animation.py.

Draws the toy trajectories (observed part blue, future red) and animates a
green agent walking randomly chosen paths with linear interpolation between
waypoints; saved as a gif by matplotlib's pillow writer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ToyAnimation:
    """samples: [N, T, 2] toy trajectories (radius <= 1)."""

    def __init__(self, samples: np.ndarray, fps: int = 15,
                 duration_s: int = 15, seed: Optional[int] = None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import animation

        self.samples = np.asarray(samples)
        self.rng = np.random.RandomState(seed)
        self.fig = plt.figure(figsize=(8, 8), dpi=80)
        ax = plt.axes(xlim=(-1.2, 1.2), ylim=(-1.2, 1.2))

        for ii in range(self.samples.shape[0]):
            plt.plot(self.samples[ii, 0, 0], self.samples[ii, 0, 1], "bo",
                     alpha=0.2, zorder=1)
            plt.plot(self.samples[ii, 0:2, 0], self.samples[ii, 0:2, 1],
                     "b", linewidth=2, alpha=0.2, zorder=0)
            plt.plot(self.samples[ii, 1:, 0], self.samples[ii, 1:, 1],
                     "r", linewidth=2, alpha=0.2, zorder=0)

        self.dt = 0.04
        self.cur_id = 0
        self.cur_progress = 0.0
        self.cur_loc = self.samples[0, 0, :]
        self.scat = ax.scatter([], [], c="green", s=72, lw=2, zorder=2)
        self.fps = fps
        self.frames = fps * duration_s
        self.anim = animation.FuncAnimation(
            self.fig, self.animate, init_func=self.init,
            frames=self.frames, interval=5, blit=False)

    def step_animation(self, dt: float) -> None:
        if self.cur_progress > 1:
            self.cur_id = int(self.rng.randint(0, self.samples.shape[0]))
            self.cur_progress = 0.0
        points = self.samples[self.cur_id]
        n_seg = points.shape[0] - 1
        x = self.cur_progress * n_seg
        s = int(min(np.floor(x), n_seg - 1))
        self.cur_loc = points[s + 1] * (x - s) + points[s] * (s + 1 - x)
        self.cur_progress += dt

    def init(self):
        self.scat.set_offsets(np.zeros((1, 2), np.float32))
        return (self.scat,)

    def animate(self, i):
        self.step_animation(self.dt)
        self.scat.set_offsets(np.asarray(self.cur_loc).reshape(1, 2))
        return (self.scat,)

    def save(self, filename: str, writer: str = "pillow") -> None:
        self.anim.save(filename, fps=self.fps, writer=writer)
