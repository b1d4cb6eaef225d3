"""Crowd simulation of Social GAN: crowd-sim's loop (``drivers/sim.py``:
``engine.simulate.crowd_simulate`` of one crowd called back to back,
``windows`` prediction windows a call under fresh noise, a synchronize
after each) under the ``sgan`` model.

The crowd is crowd-sim's (``data.crowd``).  The weights are drawn from
the seed under the published module names of the reference
(``perfbench/reference/sgan.py``) and given to the program through its
state-dict mapping (``models.sgan.from_sgan_state_dict``).  The noise of
call ``i`` is one N(0, I) vector a scene and window, from stream (seed,
NOISE, i).  The check is crowd-sim's: two of the window's calls and a
share of whole scenes drawn from the seed, the reference run over those
scenes' rows with the same calls' noise (a scene sees only its own rows),
the widest gap over each call's first window and the rms gap over all
its windows, in units of the reference's rms motion.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench import data, sgan_counts
from perfbench.drivers import load_params, sync
from perfbench.drivers import sim
from perfbench.drivers._crowd import sample_scenes, trajectory_gaps, worst
from perfbench.reference import sgan as ref
from perfbench.reference.precision import Precision


class Driver(sim.Driver):

    def setup(self) -> None:
        from socialways_torch.config import TrainConfig
        from socialways_torch.engine.simulate import crowd_simulate
        from socialways_torch.models.sgan import (from_sgan_state_dict,
                                                  init_sgan)
        self.sim = crowd_simulate
        mix, dev = self.mix, self.device
        self.cfg = cfg = TrainConfig(**self.config["train_config"])
        shapes = {k: tuple(v.shape) for k, v in ref.TrajectoryGenerator(
            cfg.embedding_dim, cfg.encoder_h_dim, cfg.decoder_h_dim,
            cfg.mlp_dim, cfg.bottleneck_dim, cfg.noise_len
        ).state_dict().items()}
        self.state = data.weights(shapes, lambda k: ref.fan_bound(k, shapes),
                                  self.seed, dev)
        self.gen = init_sgan(cfg, torch.Generator().manual_seed(0), dev)
        load_params(self.gen, from_sgan_state_dict(self.state))
        self.gen.requires_grad_(False)
        obsv0, ids = data.crowd(mix["agents"], mix["scene_min"],
                                mix["scene_max"], cfg.n_past,
                                data.rng_of(self.seed, data.DATA))
        self.ids_np = ids
        self.obsv0 = torch.from_numpy(obsv0).to(dev)
        self.ids = torch.from_numpy(ids).to(dev)
        self.scenes = int(ids.max()) + 1
        self.rows = torch.from_numpy(
            sample_scenes(ids, mix["check_share"], self.seed)).to(dev)
        self.noise_gen = torch.Generator(device=dev)
        self.windows = int(mix["windows_per_call"])
        self.kept = []
        self.calls = 0
        self._call(keep=False)
        sync(dev)
        self.call_flops = sgan_counts.simulate_flops(vars(cfg), ids,
                                                     self.windows)
        self.call_bound_s = 1e-3 * self.windows * sgan_counts.pool_bound(
            vars(cfg), ids)["bound_ms"]

    def noise(self, i: int) -> torch.Tensor:
        """[windows, S, noise_len] N(0, 1) of call ``i``."""
        self.noise_gen.manual_seed(data.seed_of(self.seed, data.NOISE, i))
        return torch.randn((self.windows, self.scenes, self.cfg.noise_len),
                           generator=self.noise_gen, device=self.device)

    def _call(self, keep: bool = True) -> None:
        out = self.sim(self.gen, self.obsv0, self.ids, self.windows,
                       self.cfg, noise=self.noise(self.calls))
        if keep:
            self.kept.append(out.index_select(0, self.rows))
        self.calls += 1

    def gaps(self, P: Precision, against: Precision = None
             ) -> Tuple[float, float, float]:
        """crowd-sim's gaps (``sim.Driver.gaps``) against the Social GAN
        reference."""
        rng = data.rng_of(self.seed, data.SAMPLE, 1)
        calls = rng.choice(len(self.window_calls),
                           size=min(sim.CHECK_CALLS, len(self.window_calls)),
                           replace=False)
        obsv, ids = self.obsv0[self.rows], self.ids[self.rows]
        out = (0.0, 0.0, 0.0)
        t1 = self.cfg.n_next
        for c in sorted(int(c) for c in calls):
            noise = self.noise(self.window_calls[c])
            run = lambda prec: ref.simulate(self.state, obsv, ids, noise,
                                            self.cfg.n_next, prec)
            want = run(P if against is None else against)
            got = (self.kept[c].to(self.device) if against is None
                   else run(P))
            first = trajectory_gaps(got[:, :t1], want[:, :t1], obsv[:, -1])
            every = trajectory_gaps(got, want, obsv[:, -1])
            out = worst(out, (first[0], every[1], every[0]))
        return out
