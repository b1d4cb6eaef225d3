"""Crowd simulation: ``engine.simulate.crowd_simulate`` of one crowd,
called back to back, each call ``windows`` prediction windows under fresh
noise and ending in a synchronize; the trajectories stay on the device.

The crowd (agents on the unit square, each with a small random walk as
its observed history, in sorted contiguous scenes of random sizes) and the
weights come from the seed.  Set-up warms one call.  The check draws two
of the window's calls and a share of whole scenes from the seed, and runs
the reference over those scenes' rows with the same calls' noise: a scene
sees only its own rows, so its trajectories are the whole crowd's.  It
compares the widest gap over each call's first window and the rms gap
over all its windows: each later window observes the bf16-rounded
predictions of the one before, so a rounding that flips grows over the
autoregressive steps, and the widest gap of the last windows swings from
seed to seed (0.39-0.76 of the rms motion on six seeds, against the
control's 5.3-8.0).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from perfbench import bounds, data, flops
from perfbench.drivers import Check, Window, sync
from perfbench.drivers._crowd import (NoiseStream, sample_scenes,
                                      served_generator, trajectory_gaps,
                                      worst)
from perfbench.reference import model
from perfbench.reference.precision import Precision

CHECK_CALLS = 2


class Driver:
    unit = "window"

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from socialways_torch.engine.simulate import crowd_simulate
        self.sim = crowd_simulate
        mix, dev = self.mix, self.device
        self.cfg, self.gen, self.params = served_generator(
            self.config, self.seed, dev)
        obsv0, ids = data.crowd(mix["agents"], mix["scene_min"],
                                mix["scene_max"], self.cfg.n_past,
                                data.rng_of(self.seed, data.DATA))
        self.ids_np = ids
        self.obsv0 = torch.from_numpy(obsv0).to(dev)
        self.ids = torch.from_numpy(ids).to(dev)
        self.rows = torch.from_numpy(
            sample_scenes(ids, mix["check_share"], self.seed)).to(dev)
        self.noise = NoiseStream(self.seed, dev)
        self.windows = int(mix["windows_per_call"])
        self.kept: List[torch.Tensor] = []
        self.calls = 0
        self._call(keep=False)
        sync(dev)
        cfg = vars(self.cfg)
        n_pairs = flops.pairs(ids)
        self.call_flops = flops.simulate_flops(cfg, len(ids), n_pairs,
                                               self.windows)
        feat = self.cfg.social_feature_size
        self.call_bound_s = 1e-3 * self.windows * bounds.attention_bound(
            ids, len(ids), self.cfg.hidden_size, feat,
            bounds.feat_mlp_elems(feat), op_bytes=2)["bound_ms"]

    def _call(self, keep: bool = True) -> None:
        """One call under the noise of call ``self.calls`` (the warm-up is
        call 0); a window's call keeps the sampled scenes' rows."""
        shape = (self.windows, self.obsv0.shape[0], self.cfg.noise_len)
        out = self.sim(self.gen, self.obsv0, self.ids, self.windows,
                       self.cfg, noise=self.noise.draw(self.calls, shape))
        if keep:
            self.kept.append(out.index_select(0, self.rows))
        self.calls += 1

    def window(self, seconds: float) -> Window:
        first, tic = self.calls, time.perf_counter()
        while True:
            self._call()
            sync(self.device)
            elapsed = time.perf_counter() - tic
            if elapsed >= seconds:
                break
        calls = self.calls - first
        self.window_calls = list(range(first, self.calls))
        steps = calls * self.windows * self.cfg.n_next * len(self.ids_np)
        return Window(elapsed, calls * self.windows,
                      {"sim_agent_steps_per_s": steps / elapsed},
                      calls * self.call_flops)

    def traced(self) -> Tuple[int, float]:
        calls = int(self.mix["trace_calls"])
        for _ in range(calls):
            self._call(keep=False)
            sync(self.device)
        return calls * self.windows, calls * self.call_bound_s

    def release(self) -> None:
        self.gen = None

    def check(self, limits: Dict[str, float]) -> List[Check]:
        widest, rms, widest_all = self.gaps(
            Precision(self.cfg.compute_dtype))
        return [Check("traj_widest", widest, limits["traj_widest"]),
                Check("traj_rms", rms, limits["traj_rms"],
                      f"widest gap over all windows {widest_all!r}")]

    def gaps(self, P: Precision, against: Precision = None
             ) -> Tuple[float, float, float]:
        """The worst (widest over the first window, rms over all, widest
        over all) gap over the sampled calls of the program's trajectories
        from the reference at ``P`` (or, with ``against``, of the reference
        at ``P`` from the one at ``against``: the control)."""
        rng = data.rng_of(self.seed, data.SAMPLE, 1)
        calls = rng.choice(len(self.window_calls),
                           size=min(CHECK_CALLS, len(self.window_calls)),
                           replace=False)
        rows, dev = self.rows, self.device
        obsv, ids = self.obsv0[rows], self.ids[rows]
        shape = (self.windows, self.obsv0.shape[0], self.cfg.noise_len)
        out = (0.0, 0.0, 0.0)
        t1 = self.cfg.n_next
        for c in sorted(int(c) for c in calls):
            noise = self.noise.draw(self.window_calls[c], shape)[:, rows]
            run = lambda prec: model.simulate(
                self.params, obsv, ids, noise, self.cfg.n_next, prec,
                window=self.cfg.max_scene_size)
            ref = run(P if against is None else against)
            got = self.kept[c].to(dev) if against is None else run(P)
            first = trajectory_gaps(got[:, :t1], ref[:, :t1], obsv[:, -1])
            every = trajectory_gaps(got, ref, obsv[:, -1])
            out = worst(out, (first[0], every[1], every[0]))
        return out
