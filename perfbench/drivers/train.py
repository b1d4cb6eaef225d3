"""Training epochs: ``Trainer.train_epochs`` back to back on a windowed
trajectory set drawn from the seed, every step a replay of the captured
``gan_step`` on the card.

Set-up builds one ``Trainer`` and its state from weights drawn here, and
drives that same object through the first three steps of an epoch with
draws made here, through the epoch call the window uses (on the card the
epoch runner's captured step, with every other step of the epoch left
out; on the CPU the eager epoch loop on those chunks).  It keeps the
first moments after step 1 and the parameters after step 3.  Then one
whole epoch warms every step, and the window trains whole epochs until
``--seconds`` have passed.

The check follows the same three steps with the plain reference from the
same weights, data and draws (the reference packs the data itself) and
compares each step's D and G loss, and each leaf's first moment after
step 1 (the first gradient as the optimizer holds it) and change over the
three steps, at the median leaf (``compare``).
"""

from __future__ import annotations

import io
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import bounds, data, flops
from perfbench.drivers import Check, Window, load_params, rel_gap, sync
from perfbench.reference import model, train as ref_train
from perfbench.reference.precision import Precision

CHECK_STEPS = 3
ATTENTION_LEAVES = ("g.feat_mlp.", "g.attn_w.")


def reference_cfg(cfg, n_chunks: int) -> Dict:
    """The reference's settings from the program's config: the instance
    noise's anneal length resolved as the trainer resolves -1 (the whole
    planned run)."""
    steps = cfg.d_input_noise_steps
    return {"hidden_size": cfg.hidden_size, "n_next": cfg.n_next,
            "n_latent_codes": cfg.n_latent_codes,
            "loss_info_w": cfg.loss_info_w, "lr_g": cfg.lr_g,
            "lr_d": cfg.lr_d, "adam_b1": cfg.adam_b1,
            "adam_b2": cfg.adam_b2, "g_ema_decay": cfg.g_ema_decay,
            "n_unrolling_steps": cfg.n_unrolling_steps,
            "d_input_noise": cfg.d_input_noise,
            "d_input_noise_floor": cfg.d_input_noise_floor,
            "anneal_steps": (cfg.n_epochs * n_chunks if steps < 0 else steps)}


def supported(cfg) -> None:
    """The reference implements the record arm's step and no other."""
    want = dict(agent_frame=True, use_social=True, decoder="fc",
                latent_code_type="continuous", noise_dist="uniform",
                use_info_loss=True, d_restore="full", pac=1, mb_std=False,
                spectral_norm=False, grad_accum=1, grad_clip=0.0,
                use_l2_loss=False, use_variety_loss=False, r1_gamma=0.0,
                ms_weight=0.0, ds_weight=0.0, d_update_every=1,
                compute_dtype="float32", lr_decay_rate=1.0,
                d_lr_decay_steps=0, lr_warmup_steps=0, d_lr_warmup_steps=0,
                loss_info_w_end=0.0, serial_rollout=False,
                remat_steps=False)
    bad = {k: getattr(cfg, k) for k, v in want.items()
           if getattr(cfg, k) != v}
    if bad:
        raise NotImplementedError(f"the training reference has no {bad}")


def compare(prog: Dict, ref: Dict) -> List[Tuple[str, float, str]]:
    """(name, value, note) of the compared numbers, from the two sides'
    step losses, first moments after step 1 and parameters after step 3,
    and the initial parameters ``ref["p0"]``: the worst step's loss gap;
    for the first moments (the first gradient as the optimizer holds it)
    and for the change over the three steps, the gap of each leaf's norm
    against the larger of the reference leaf's norm and the median
    leaf's, taken at the median leaf.  The worst leaf is not compared: a
    pre-activation that rounds to the other side of a ReLU or LeakyReLU
    kink on one side only moves that unit's gradient whole, which no
    rounding bound covers (the notes give the worst leaf's reading).  A
    leaf whose reference moment is under a thousandth of the median
    leaf's moves under Adam by round-off alone and is left out of the
    change; the notes also give the attention leaves' median gap against
    their own norms."""
    loss = max(rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"]))
    mu_ref = ref_train.leaf_norms(ref["mu1"])
    mu_prog = ref_train.leaf_norms(prog["mu1"])
    med = float(np.median(list(mu_ref.values())))
    grad = {k: abs(mu_prog[k] - mu_ref[k]) / max(mu_ref[k], med)
            for k in mu_ref}
    keep = [k for k in mu_ref if mu_ref[k] >= 1e-3 * med]
    d_ref = {k: float(torch.linalg.vector_norm(
        (ref["p3"][k] - ref["p0"][k]).double())) for k in keep}
    d_prog = {k: float(torch.linalg.vector_norm(
        (prog["p3"][k] - ref["p0"][k]).double())) for k in keep}
    med_d = float(np.median(list(d_ref.values())))
    change = {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med_d)
              for k in keep}
    attn = [rel_gap(mu_prog[k], mu_ref[k]) for k in mu_ref
            if k.startswith(ATTENTION_LEAVES)]

    def worst(gaps):
        k = max(gaps, key=gaps.get)
        return f"worst leaf {k} {gaps[k]!r}"
    left_out = sorted(set(mu_ref) - set(keep))
    return [("loss_gap", loss, ""),
            ("grad_gap", float(np.median(list(grad.values()))),
             f"{worst(grad)}; attention leaves' median against their own "
             f"norms {float(np.median(attn))!r}"),
            ("change_gap", float(np.median(list(change.values()))),
             worst(change) + (f"; left out: {left_out}" if left_out
                              else ""))]


def run_reference(p0: Dict[str, torch.Tensor], chunks: Dict[str, np.ndarray],
                  draws: Sequence[Dict], rcfg: Dict, P: Precision,
                  device, half: bool = False) -> Dict:
    """The reference's three steps: losses, first moments after step 1,
    parameters after step 3 (keys ``g.*`` and ``d.*``).  ``half``: the
    fault of half of each batch left out, the means taken over the rest
    (for the fault's readings)."""
    if half:
        valid = chunks["valid"].copy()
        valid[:, valid.shape[1] // 2:] = False
        chunks = dict(chunks, valid=valid)
    ref = ref_train.TrainReference(p0, rcfg, P)
    out = {"losses": [], "p0": {f"g.{k}": p0[k] for k in model.generator_names()}}
    out["p0"].update({f"d.{k}": p0[k] for k in model.discriminator_names()})
    for i in range(CHECK_STEPS):
        chunk = {k: torch.from_numpy(v[i]).to(device)
                 for k, v in chunks.items()}
        out["losses"] += list(ref.step(chunk, draws[i]))
        if i == 0:
            out["mu1"] = ref_train.first_moments(ref)
    out["p3"] = ref_train.params_of(ref)
    return out


class Driver:
    unit = "step"

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        self.fields, self.mix, self.seed = config["train_config"], mix, seed
        self.device = torch.device(device)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from socialways_torch.config import TrainConfig
        from socialways_torch.data.dataset import load_npz_dataset
        from socialways_torch.engine.trainer import Trainer
        cfg = TrainConfig(**self.fields)
        supported(cfg)
        mix = self.mix
        self.raw = data.ethucy_windows(mix["windows"], self.seed,
                                       mix["scene_min"], mix["scene_max"],
                                       cfg.n_past, cfg.n_next)
        buf = io.BytesIO()
        np.savez(buf, **self.raw)
        buf.seek(0)
        trainer = Trainer(cfg, load_npz_dataset(buf), self.device)
        self.chunks = ref_train.train_chunks(
            self.raw["obsvs"], self.raw["preds"], self.raw["batches"],
            cfg.batch_size)
        shape_of = model.shapes(cfg.hidden_size, cfg.social_feature_size,
                                cfg.noise_len, cfg.n_next, cfg.n_latent_codes)
        self.p0 = data.weights(shape_of,
                               lambda k: model.fan_bound(k, shape_of),
                               self.seed, self.device)
        state = trainer.init_state(0)
        g = model.only(self.p0, model.generator_names())
        load_params(state.g, g)
        load_params(state.d, model.only(self.p0, model.discriminator_names()))
        if state.g_ema is not None:
            load_params(state.g_ema, g)
        self.cfg, self.trainer, self.state = cfg, trainer, state
        self.draws = self._draws()
        self.prog = self._first_steps()
        self.rng = data.device_generator(self.device, self.seed, data.DRAWS, 1)
        trainer.train_epochs(state, self.rng, 1)
        sync(self.device)
        counts = self.chunks["valid"].sum(axis=1)
        self.samples_per_epoch = int(counts.sum())
        self.steps_per_epoch = int((counts > 0).sum())
        self.epoch_flops = sum(
            flops.train_step_flops(vars(cfg), int(v.sum()), flops.pairs(ids))
            for ids, v in zip(self.chunks["scene_ids"], self.chunks["valid"]))
        feat = cfg.social_feature_size
        n_mlp = bounds.feat_mlp_elems(feat)
        self.epoch_bound_s = 1e-3 * sum(
            bounds.attention_bound(ids, len(ids), cfg.hidden_size, feat,
                                   n_mlp)["bound_ms"]
            + bounds.attention_bwd_bound(ids, len(ids), cfg.hidden_size,
                                         feat, n_mlp, "dkv")["bound_ms"]
            for ids, v in zip(self.chunks["scene_ids"], self.chunks["valid"])
            if v.any())

    def _draws(self) -> List:
        """One epoch's step draws (the program's ``StepDraws``), made here
        in a few device calls: U(0, 1) noise, the smoothed labels U(0, 0.1)
        and U(0.9, 1), and the three N(0, 1) instance-noise draws."""
        from socialways_torch.engine.train_step import StepDraws
        cfg, dev = self.cfg, self.device
        steps = self.trainer.n_steps_per_epoch
        width = self.trainer.train_packed.width
        gen = data.device_generator(dev, self.seed, data.DRAWS, 0)
        noise = torch.rand((steps, width, cfg.noise_len), generator=gen,
                           device=dev)
        u = torch.rand((steps, 2), generator=gen, device=dev)
        eps = torch.randn((steps, 3, width, cfg.n_next, 4), generator=gen,
                          device=dev)
        return [StepDraws(noise[i], 0.1 * u[i, 0], 0.9 + 0.1 * u[i, 1],
                          eps[i, 0], eps[i, 1], eps[i, 2])
                for i in range(steps)]

    def _steps(self, which: Sequence[int]) -> Tuple[float, float]:
        """Steps ``which`` of an epoch (the rest left out) through the
        trainer's epoch call; their summed (D, G) losses."""
        from socialways_torch.engine.train_step import stack_draws
        from socialways_torch.engine.trainer import run_epoch
        tr, state = self.trainer, self.state
        if tr.graphed:
            runner = tr.epoch_graphs
            full = runner.n_valid
            runner.n_valid = [n if i in which else 0
                              for i, n in enumerate(full)]
            try:
                m = runner.epoch(state, stack_draws(self.draws))
            finally:
                runner.n_valid = full
            scale = len(full)
        else:
            sel = list(which)
            batches = {k: v[sel] for k, v in tr.train_dev.items()}
            _, m = run_epoch(state, batches, [self.draws[i] for i in sel],
                             tr.cfg, tr.train_counts[sel])
            scale = len(sel)
        return float(m.d_loss) * scale, float(m.g_loss) * scale

    def _first_steps(self) -> Dict:
        state, out = self.state, {"losses": []}
        for i in range(CHECK_STEPS):
            out["losses"] += list(self._steps([i]))
            if i == 0:
                out["mu1"] = {f"g.{k}": v.detach().clone()
                              for k, v in state.g_opt.mu.items()}
                out["mu1"].update({f"d.{k}": v.detach().clone()
                                   for k, v in state.d_opt.mu.items()})
        out["p3"] = {f"g.{k}": v.detach().clone()
                     for k, v in state.g.named_parameters()}
        out["p3"].update({f"d.{k}": v.detach().clone()
                          for k, v in state.d.named_parameters()})
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Window:
        epochs, tic = 0, time.perf_counter()
        while True:
            self.trainer.train_epochs(self.state, self.rng, 1)
            epochs += 1
            elapsed = time.perf_counter() - tic
            if elapsed >= seconds:
                break
        samples = epochs * self.samples_per_epoch
        return Window(elapsed, epochs * self.steps_per_epoch,
                      {"train_samples_per_s": samples / elapsed},
                      epochs * self.epoch_flops)

    def traced(self) -> Tuple[int, float]:
        n = int(self.mix["trace_epochs"])
        self.trainer.train_epochs(self.state, self.rng, n)
        sync(self.device)
        return n * self.steps_per_epoch, n * self.epoch_bound_s

    def release(self) -> None:
        self.trainer = self.state = None

    # ------------------------------------------------------------- check
    def reference(self, precision: str = "float32",
                  half: bool = False) -> Dict:
        """The reference's first three steps from this run's weights,
        data and draws, at ``precision`` (``half``: the half-batch
        fault)."""
        rcfg = reference_cfg(self.cfg, len(self.chunks["valid"]))
        draws = [{"noise": d.noise, "zero_label": float(d.zero_label),
                  "one_label": float(d.one_label), "eps_fake": d.eps_fake,
                  "eps_real": d.eps_real, "eps_g": d.eps_g}
                 for d in self.draws[:CHECK_STEPS]]
        return run_reference(self.p0, self.chunks, draws, rcfg,
                             Precision(precision), self.device, half)

    def check(self, limits: Dict[str, float]) -> List[Check]:
        return [Check(name, value, limits[name], note)
                for name, value, note in compare(self.prog, self.reference())
                if name in limits]
