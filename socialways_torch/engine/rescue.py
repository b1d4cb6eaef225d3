"""Eval-keyed stall detection and the discriminator-reset rescue.

Counterpart of socialways_tpu/engine/rescue.py:45-200.  ``StallTracker`` is
pure Python and is copied as it is (its comments cite the JAX package's
measurements, BASELINE.md r4k-r5).  ``reinit_discriminator`` gives the
state a fresh D and a fresh D optimizer and leaves G, the EMA and the G
optimizer (with its schedule clock) untouched: a GAN stuck in a
bad-but-stable equilibrium is restored to its best generator and handed a
new random discriminator.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from socialways_torch.config import TrainConfig


class StallTracker:
    """Stall/rescue bookkeeping keyed on a monotone "lower is better"
    eval metric (eval ADE here; the toy coverage path keys on coverage
    and keeps its own simpler counter).

    Protocol, once per eval::

        if tracker.observe(ev["ade_min"]) and done < n_epochs:
            state = reinit_discriminator(best_state, cfg, key)
            streak = tracker.fired(best_ade, at_epoch=done)

    ``observe`` returns True when a rescue should fire now (patience
    exhausted, not in a post-rescue grace window, ineffective-streak
    cap not reached).  Callers keep their own end-of-run / checkpoint-
    exists guards.
    """

    def __init__(self, patience: int, grace: int = 0,
                 max_rescues: int = 0, improve: float = 0.98,
                 classify_patience: int = 0, classify_ratio: float = 3.0,
                 collapse_ratio: float = 1.2):
        self.patience = patience
        self.grace_n = grace
        self.max_rescues = max_rescues
        self.improve = improve
        # signature-matched EARLY trigger (r4m diagnosis → r5 lever):
        # the stalled folds are a broad-distribution under-fit
        # equilibrium with a signature the harness already logs per
        # eval — avg-of-K ≥ classify_ratio × min-of-K (samples stay
        # diverse) while train ADE tracks the eval avg (not overfit).
        # Healthy folds run avg/min ≈ 1.3-1.9 (stall_diagnosis_r4m:
        # 1.8 vs 3.3/4.1 stalled), so signature-matching stalls can
        # fire after only ``classify_patience`` flat evals instead of
        # the blunter ``patience``, cutting detection latency without
        # touching healthy folds.  0 = off (patience-only, the r4l
        # shipped policy).
        self.classify_patience = classify_patience
        self.classify_ratio = classify_ratio
        # second stall class, found by the round-5 out-of-sample seed
        # extension (seed 9 / eth, benchmarks/
        # tpu_runbook_r5_gated_ext.log): min-of-K ≈ avg-of-K ≈ const
        # for 25k epochs with D dominating (d_loss → 0.19) — the K=20
        # noise draws produce near-identical rollouts, i.e. DIVERSITY
        # COLLAPSE, the opposite tail from the under-fit signature and
        # invisible to it (avg/min ≈ 1.0 vs its ≥ 3.0 gate).  Healthy
        # folds never leave avg/min ≈ 1.3-3.4 on this protocol (the
        # post-EMA late-run floor is ≈ 2.4), so a stalled streak at
        # avg ≤ collapse_ratio × min is unambiguous.  Shares
        # ``classify_patience`` and the fresh-D rescue (D dominance is
        # exactly what a re-initialized D removes).
        self.collapse_ratio = collapse_ratio
        self.last_signature = ""      # "underfit" | "collapse" — which
                                      # signature the current streak hit
        self.bar = float("inf")
        self.stall = 0
        self.grace = 0
        self.ineffective = 0
        self.best_at_last_rescue = float("inf")
        self.rescues: List[int] = []
        self.signature_hits = 0       # consecutive signature-matching evals
        self.fired_early = 0          # EXECUTED rescues fired by the
                                      # classifier (counted in fired())
        self.last_trigger = ""        # "patience" | "classifier" — what
                                      # made the latest observe() True
        self._pending_early = False   # latest True came from the classifier

    def observe(self, ade: float, ade_avg: float | None = None,
                train_ade: float | None = None) -> bool:
        """Record one eval; True when a rescue should fire now.

        ``ade_avg``/``train_ade`` (both optional) feed the signature
        classifier (under-fit and diversity-collapse, see __init__);
        patience-only callers are unchanged.
        ``patience < 0`` (or 0 with ``classify_patience > 0``) =
        classify-ONLY (gated) mode: the tracker is armed but the blunt
        patience path never fires — the measured winner of the r5 gated
        A/B (false fires eliminated at zero loss; the s6/univ 0.193
        matrix cell was rescue-induced)."""
        if not self.patience and not self.classify_patience:
            return False
        if self.grace > 0:
            # post-rescue transient (G vs the fresh random D): these
            # evals neither count as stalls nor move the bar
            self.grace -= 1
            self.signature_hits = 0
            return False
        if ade < self.improve * self.bar:
            self.bar = ade
            self.stall = 0
            self.signature_hits = 0
        else:
            self.stall += 1
            # under-fit signature: diverse-but-inaccurate (avg >> min)
            # and NOT overfit (train tracks the eval avg) — the exact
            # ratios of benchmarks/stall_diagnosis_r4m.json
            underfit = (ade_avg is not None
                        and ade_avg >= self.classify_ratio * ade
                        and (train_ade is None
                             or train_ade > 0.5 * ade_avg))
            # diversity-collapse signature (r5 seed-9/eth): the K
            # samples are near-identical, so min-of-K ≈ avg-of-K —
            # healthy runs never stall at avg/min ≤ ~1.2 (see __init__)
            collapse = (ade_avg is not None
                        and ade_avg <= self.collapse_ratio * ade)
            if self.classify_patience and (underfit or collapse):
                self.signature_hits += 1
                self.last_signature = ("underfit" if underfit
                                       else "collapse")
            else:
                self.signature_hits = 0
        capped = (self.max_rescues
                  and self.ineffective >= self.max_rescues)
        if capped:
            return False
        if self.patience > 0 and self.stall >= self.patience:
            self.last_trigger, self._pending_early = "patience", False
            return True
        if (self.classify_patience
                and self.signature_hits >= self.classify_patience):
            self.last_trigger, self._pending_early = "classifier", True
            return True
        return False

    def fired(self, best_ade: float, at_epoch: int) -> int:
        """Record a rescue that just EXECUTED; returns the consecutive-
        ineffective streak (0 = the interval since the previous rescue
        produced a new global best).  ``fired_early`` counts executed
        classifier-triggered rescues here — not in observe(), whose
        True can still be suppressed by caller guards (e.g. the
        run-end ``done < n_epochs`` check)."""
        if self._pending_early:
            self.fired_early += 1
            self._pending_early = False
        if best_ade < self.best_at_last_rescue * self.improve:
            self.ineffective = 0      # the last rescue found a new
        else:                         # basin — reset the cap
            self.ineffective += 1
        self.best_at_last_rescue = best_ade
        self.rescues.append(at_epoch)
        self.stall = 0
        self.signature_hits = 0
        self.grace = self.grace_n
        self.bar = best_ade
        return self.ineffective


def reinit_discriminator(state, cfg: TrainConfig,
                         generator: Optional[torch.Generator] = None):
    """``state`` with a fresh discriminator drawn from ``generator`` (a CPU
    ``torch.Generator``) on the device of its G, and a fresh D optimizer.
    The core of the ``--stall-reset-d`` rescue."""
    from socialways_torch.engine.train_step import make_optimizers
    from socialways_torch.models.discriminator import init_discriminator

    device = next(state.g.parameters()).device
    d = init_discriminator(cfg, generator, device)
    _, d_tx = make_optimizers(cfg)
    return dataclasses.replace(state, d=d, d_opt=d_tx.init(d))
