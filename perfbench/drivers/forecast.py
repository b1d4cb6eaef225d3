"""K-sample forecasting as a service: one client in a closed loop sends
crowd snapshots, each answered with K futures of every agent.

A request is a snapshot of N agents (sorted contiguous scenes of random
sizes; the construction of the crowd driver) held in pinned host memory.
Serving it copies the observations and scene ids to the device, runs
``eval.metrics.k_sample_rollout`` under K draws of noise made for that
request, and copies the K forecasts' positions back into the request's
pinned host buffer; its latency runs from the first copy to the last.
The pool's sizes are the same for every seed (log-spaced between the
mix's bounds); the seed draws the snapshots and the order, which the
client cycles through.  Set-up serves every request of the pool once.

The check compares, for a sample of the pool drawn from the seed with
the largest snapshot in it, the last answer the window gave with the
reference's forecast of the same snapshot under the same noise.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import bounds, data, flops
from perfbench.drivers import Check, Window, sync
from perfbench.drivers._crowd import (NoiseStream, served_generator,
                                      trajectory_gaps, worst)
from perfbench.reference import model
from perfbench.reference.precision import Precision


class Driver:
    unit = "request"

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from socialways_torch.eval.metrics import k_sample_rollout
        self.rollout = k_sample_rollout
        mix, dev = self.mix, self.device
        pin = dev.type == "cuda"
        self.cfg, self.gen, self.params = served_generator(
            self.config, self.seed, dev)
        self.k = int(mix["k"])
        sizes = np.geomspace(mix["agents_min"], mix["agents_max"],
                             int(mix["pool"])).round().astype(int)
        self.pool = []
        for r, n in enumerate(sizes):
            obsv, ids = data.crowd(int(n), mix["scene_min"], mix["scene_max"],
                                   self.cfg.n_past,
                                   data.rng_of(self.seed, data.DATA, r))
            out = torch.empty((self.k, int(n), self.cfg.n_next, 2),
                              pin_memory=pin)
            self.pool.append({"obsv": torch.from_numpy(obsv).pin_memory()
                              if pin else torch.from_numpy(obsv),
                              "ids": torch.from_numpy(ids).pin_memory()
                              if pin else torch.from_numpy(ids),
                              "out": out, "last": None})
        self.order = data.rng_of(self.seed, data.ORDER).permutation(len(sizes))
        self.noise = NoiseStream(self.seed, dev)
        self.served = 0
        for r in range(len(self.pool)):
            self._serve(r)
        feat = self.cfg.social_feature_size
        n_mlp = bounds.feat_mlp_elems(feat)
        cfg = vars(self.cfg)
        for req in self.pool:
            ids = req["ids"].numpy()
            n_pairs = flops.pairs(ids)
            req["flops"] = flops.forecast_flops(cfg, len(ids), n_pairs,
                                                self.k)
            req["bound_s"] = 1e-3 * bounds.attention_bound(
                ids, len(ids), self.cfg.hidden_size, feat, n_mlp,
                op_bytes=2)["bound_ms"]

    def _serve(self, r: int) -> Tuple[float, float]:
        """Request ``r`` of the pool, answered into its host buffer under
        the noise of request ``self.served``: (latency, enqueue) seconds."""
        req, dev = self.pool[r], self.device
        tic = time.perf_counter()
        obsv = req["obsv"].to(dev)
        ids = req["ids"].to(dev)
        noise = self.noise.draw(self.served, (self.k, obsv.shape[0],
                                              self.cfg.noise_len))
        out = self.rollout(self.gen, obsv, ids, self.k, self.cfg,
                           noise=noise)
        enqueued = time.perf_counter()
        req["out"].copy_(out[..., :2])
        done = time.perf_counter()
        req["last"] = self.served
        self.served += 1
        return done - tic, enqueued - tic

    def _next(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def window(self, seconds: float) -> Window:
        lat: List[float] = []
        enq: List[float] = []
        agents, fl, i = 0, 0.0, 0
        self.first_window_request = self.served
        tic = time.perf_counter()
        while True:
            r = self._next(i)
            t, e = self._serve(r)
            lat.append(t)
            enq.append(e)
            agents += self.pool[r]["obsv"].shape[0]
            fl += self.pool[r]["flops"]
            i += 1
            elapsed = time.perf_counter() - tic
            if elapsed >= seconds:
                break
        self.next_i = i
        lat_ms = np.asarray(lat) * 1e3
        p95 = float(np.percentile(lat_ms, 95, method="linear"))
        return Window(elapsed, len(lat),
                      {"forecast_agents_per_s": agents / elapsed,
                       "forecast_p95_ms": p95},
                      fl, {"latency_ms": list(lat_ms),
                           "enqueue_ms": list(np.asarray(enq) * 1e3)})

    def traced(self) -> Tuple[int, float]:
        n, bound = int(self.mix["trace_requests"]), 0.0
        for j in range(n):
            r = self._next(self.next_i + j)
            self._serve(r)
            bound += self.pool[r]["bound_s"]
        self.next_i += n
        sync(self.device)
        return n, bound

    def release(self) -> None:
        self.gen = None

    def check(self, limits: Dict[str, float]) -> List[Check]:
        widest, rms = self.gaps(Precision(self.cfg.compute_dtype))
        return [Check("traj_widest", widest, limits["traj_widest"]),
                Check("traj_rms", rms, limits["traj_rms"])]

    def sample(self) -> List[int]:
        """The pool entries compared: the largest, and others drawn from
        the seed, among those the window answered."""
        answered = [r for r, q in enumerate(self.pool)
                    if q["last"] >= self.first_window_request]
        rng = data.rng_of(self.seed, data.SAMPLE)
        n = min(int(self.mix["check_requests"]), len(answered))
        largest = max(answered, key=lambda r: self.pool[r]["obsv"].shape[0])
        rest = [r for r in answered if r != largest]
        return [largest] + [int(r) for r in rng.choice(
            rest, size=min(n - 1, len(rest)), replace=False)]

    def gaps(self, P: Precision, against: Precision = None
             ) -> Tuple[float, float]:
        """The worst (widest, rms) gap over the sampled requests of the
        program's answers from the reference at ``P`` (with ``against``,
        of the reference at ``P`` from the one at ``against``)."""
        dev, out = self.device, (0.0, 0.0)
        for r in self.sample():
            req = self.pool[r]
            obsv = req["obsv"].to(dev)
            ids = req["ids"].to(dev)
            noise = self.noise.draw(req["last"], (self.k, obsv.shape[0],
                                                  self.cfg.noise_len))
            run = lambda prec: model.k_sample_forecast(
                self.params, obsv, ids, noise, self.cfg.n_next, prec,
                window=self.cfg.max_scene_size)[..., :2]
            ref = run(P if against is None else against)
            got = req["out"].to(dev) if against is None else run(P)
            g = trajectory_gaps(got.reshape(-1, *got.shape[2:]),
                                ref.reshape(-1, *ref.shape[2:]),
                                obsv[:, -1].repeat(self.k, 1))
            out = worst(out, g)
        return out
