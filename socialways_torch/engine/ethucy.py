"""ETH/UCY leave-one-scene-out benchmark runner.

Counterpart of socialways_tpu/engine/ethucy.py:30-422: the paper's protocol
is leave-one-scene-out over {eth, hotel, univ, zara1, zara2}.  For each
held-out scene, train on the concatenation of the other scenes' windows and
report avg / min-of-K ADE/FDE on the held-out scene in meters.

Scene npz files follow the standard ``{obsvs, preds, times, batches}``
schema (``cli create-dataset``, or built here from obsmat files found under
the data directory).

The port's training state lives in modules updated in place, so the best
state seen is a copy taken at each new best, and a rescue re-initializes the
discriminator of a fresh copy of it: the snapshot keeps its bits through any
number of rescues.
"""

from __future__ import annotations

import copy
import hashlib
import os
import re
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import TrajectoryDataset
from socialways_torch.data.scale import Scale
from socialways_torch.engine.rescue import StallTracker, reinit_discriminator
from socialways_torch.engine.train_step import eval_params
from socialways_torch.engine.trainer import Trainer, fork_seed, stream_seed

SCENES = ("eth", "hotel", "univ", "zara1", "zara2")

# path-component tokens identifying each scene in the common public layouts
# (ewap_dataset/seq_eth/obsmat.txt, crowds/data/zara01/..., obsmat_eth.txt)
_SCENE_TOKENS = {
    "eth": ("seq_eth", "biwi_eth", "eth"),
    "hotel": ("seq_hotel", "biwi_hotel", "hotel"),
    "univ": ("students003", "students", "univ"),
    "zara1": ("zara01", "zara1"),
    "zara2": ("zara02", "zara2"),
}


def validate_obsmat(path: str, max_rows: int = 50) -> Dict:
    """Format-validate an obsmat candidate and fingerprint it.

    BIWI obsmat rows are 8 whitespace-separated floats
    ``(ts id px pz py vx vz vy)`` (reference utils/parse_utils.py:231-320).
    Returns {ok, rows_checked, sha256, error}."""
    h = hashlib.sha256()
    rows = 0
    err = None
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            parts = line.split()
            if len(parts) != 8:
                err = (f"row {rows}: {len(parts)} columns, expected 8 "
                       f"(ts id px pz py vx vz vy)")
                break
            try:
                vals = [float(v) for v in parts]
            except ValueError:
                err = f"row {rows}: non-numeric field"
                break
            if not all(np.isfinite(vals)):
                err = f"row {rows}: non-finite value"
                break
            rows += 1
            if rows >= max_rows:
                break
    if rows == 0 and err is None:
        err = "no data rows"
    return {"ok": err is None, "rows_checked": rows,
            "sha256": h.hexdigest(), "error": err}


def discover_obsmat(data_dir: str, scenes: Sequence[str] = SCENES
                    ) -> Dict[str, str]:
    """Find real obsmat annotation files under ``data_dir`` and map them to
    scene names by path tokens (deepest matching path component wins;
    longer token beats shorter on the same component).  Only candidates
    that pass :func:`validate_obsmat` are considered."""
    candidates = []
    for root, _, files in os.walk(data_dir):
        for f in files:
            low = f.lower()
            if low.endswith(".txt") and "obsmat" in low:
                candidates.append(os.path.join(root, f))
    found: Dict[str, str] = {}
    for path in sorted(candidates):
        rel = os.path.relpath(path, data_dir).lower()
        parts = list(reversed(rel.split(os.sep)))   # filename first
        scene_hit = None
        for part in parts:
            # tokens match at delimiter boundaries only: a component like
            # "ethucy" must NOT classify as scene "eth" (trailing digits
            # stay legal: students003, zara01)
            hits = [(len(tok), s) for s in scenes
                    for tok in _SCENE_TOKENS[s]
                    if re.search(r"(?<![a-z0-9])" + re.escape(tok)
                                 + r"(?![a-z])", part)]
            if hits:
                hits.sort(reverse=True)
                if len(hits) > 1 and hits[0][0] == hits[1][0] \
                        and hits[0][1] != hits[1][1]:
                    raise ValueError(
                        f"ambiguous scene for {path!r}: component "
                        f"{part!r} matches {sorted(set(h[1] for h in hits))}")
                scene_hit = hits[0][1]
                break
        if scene_hit is None:
            continue
        if not validate_obsmat(path)["ok"]:
            continue
        if scene_hit in found:
            raise ValueError(
                f"scene {scene_hit!r} matched by both "
                f"{found[scene_hit]!r} and {path!r} — pass an unambiguous "
                f"--data-dir or remove one")
        found[scene_hit] = path
    return found


def build_scene_npz(obsmat: str, out: str, n_past: int = 8,
                    n_next: int = 12, down_sample: int = 1) -> int:
    """obsmat → windowed ``{obsvs, preds, times, batches}`` npz through the
    parser and windowing of ``cli create-dataset`` (over the closed range
    of timestamps).  Returns the scene-batch count."""
    from socialways_torch.data.parsers import BIWIParser
    from socialways_torch.data.windowing import create_dataset

    parser = BIWIParser()
    parser.load(obsmat, down_sample=down_sample)
    if not parser.p_data:
        raise ValueError(f"no trajectories parsed from {obsmat}")
    t_all = np.concatenate(parser.t_data)
    interval = parser.interval if parser.interval > 0 else 1
    t_range = range(int(t_all.min()), int(t_all.max()) + 1, int(interval))
    obsvs, preds, times, batches = create_dataset(
        parser.p_data, parser.t_data, t_range, n_past, n_next)
    np.savez(out, obsvs=obsvs, preds=preds, times=np.asarray(times),
             batches=batches)
    return len(batches)


def prepare_scenes(data_dir: str, cfg: TrainConfig,
                   scenes: Sequence[str] = SCENES,
                   verbose: bool = True) -> Dict[str, Dict]:
    """Detect obsmat files under ``data_dir``, validate and fingerprint
    each, and (re)build any missing or stale ``<scene>-<past>-<next>.npz``.
    Returns a manifest {scene: {obsmat, sha256, npz, n_batches, built}}."""
    found = discover_obsmat(data_dir, scenes)
    missing = [s for s in scenes if s not in found]
    if missing:
        raise FileNotFoundError(
            f"no valid obsmat file found for scenes {missing} under "
            f"{data_dir} (looked for *obsmat*.txt with 8-column rows and "
            f"path tokens like {[_SCENE_TOKENS[s][0] for s in missing]})")
    manifest: Dict[str, Dict] = {}
    for s in scenes:
        om = found[s]
        info = validate_obsmat(om)
        npz = os.path.join(data_dir, f"{s}-{cfg.n_past}-{cfg.n_next}.npz")
        stale = (not os.path.exists(npz)
                 or os.path.getmtime(npz) < os.path.getmtime(om))
        n_batches = None
        if stale:
            n_batches = build_scene_npz(om, npz, cfg.n_past, cfg.n_next)
        manifest[s] = {"obsmat": om, "sha256": info["sha256"], "npz": npz,
                       "n_batches": n_batches, "built": stale}
        if verbose:
            state = "built" if stale else "up-to-date"
            print(f"[{s}] {om} (sha256 {info['sha256'][:12]}…) → "
                  f"{npz} [{state}]")
    return manifest


def _load_raw(path: str):
    with np.load(path) as d:
        return (np.array(d["obsvs"], np.float32),
                np.array(d["preds"], np.float32),
                np.array(d["times"]), np.array(d["batches"], np.int64))


def merge_scenes(files_train: Sequence[str], file_test: str
                 ) -> TrajectoryDataset:
    """Concatenate training scenes' windows, append the held-out scene as
    the test portion, fit one keep-ratio Scale over everything and
    normalize (the reference's global-min/max normalization,
    train.py:113-120, extended to the multi-scene protocol)."""
    obs_parts, pred_parts, time_parts, batch_parts = [], [], [], []
    offset = 0
    for f in list(files_train) + [file_test]:
        o, p, t, b = _load_raw(f)
        obs_parts.append(o)
        pred_parts.append(p)
        time_parts.append(t)
        batch_parts.append(b + offset)
        offset += o.shape[0]

    obsvs = np.concatenate(obs_parts)
    preds = np.concatenate(pred_parts)
    times = np.concatenate(time_parts)
    batches = np.concatenate(batch_parts)
    train_size = sum(len(b) for b in batch_parts[:-1])

    scale = Scale()
    scale.fit(obsvs.reshape(-1, 2)).fit(preds.reshape(-1, 2))
    scale.calc_scale(keep_ratio=True)
    obsvs = scale.normalize(obsvs)
    preds = scale.normalize(preds)

    return TrajectoryDataset(obsvs=obsvs, preds=preds, times=times,
                             batches=batches, scale=scale,
                             train_size=train_size)


def _evaluate(trainer: Trainer, state, eval_rng: torch.Generator
              ) -> Dict[str, float]:
    """The held-out eval of ``state``'s eval generator, its noise seeded by
    a draw from ``eval_rng``."""
    return trainer.evaluate(eval_params(state), fork_seed(eval_rng))


def run_leave_one_out(
    data_dir: str,
    cfg: TrainConfig,
    scenes: Sequence[str] = SCENES,
    n_epochs: Optional[int] = None,
    fused_block: int = 10,
    verbose: bool = True,
    eval_every: int = 0,
    ade_stall_recover: int = 0,
    ade_stall_grace: int = 2,
    ade_stall_max_rescues: int = 3,
    ade_stall_classify: int = 0,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Train + evaluate each leave-one-out fold on ``device`` (``None`` =
    ``cuda``; it raises when there is no GPU).  Returns {scene: {ade_min,
    fde_min, ade_avg, fde_avg, train_time_s, total_wall_s}}, plus
    {best_ade_min, best_fde_min, best_at_epoch, rescues,
    rescues_fired_by_classifier} when ``eval_every`` > 0.
    ``train_time_s`` counts only the training windows (each ends in a host
    read of the epoch's metrics, which waits for the device);
    ``total_wall_s`` is the whole fold loop.

    ``eval_every`` > 0 evaluates the held-out scene every that many epochs
    and reports the best state seen.  ``ade_stall_recover`` = N restores
    the best state with a re-initialized discriminator after N evals without
    a >2% best-ADE improvement (-1: only on the ``ade_stall_classify``
    signature trigger); either implies ``eval_every`` = n_epochs/30 when it
    is not set.  ``ade_stall_grace`` and ``ade_stall_max_rescues`` are
    ``StallTracker``'s grace and cap (socialways_tpu/engine/ethucy.py:254-283
    gives their measured reasons).
    """
    n_epochs = n_epochs or cfg.n_epochs
    if (ade_stall_recover or ade_stall_classify) and eval_every <= 0:
        eval_every = max(n_epochs // 30, 1)
    # before the Trainer sees it: the -1 whole-run anneal horizon must
    # track the epochs actually run
    cfg = cfg.replace(n_epochs=n_epochs)
    files = {s: os.path.join(data_dir, f"{s}-{cfg.n_past}-{cfg.n_next}.npz")
             for s in scenes}
    missing = [f for f in files.values() if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(
            f"missing scene files: {missing} — create them with "
            "`cli create-dataset <obsmat> <out.npz>`")

    results: Dict[str, Dict[str, float]] = {}
    for held_out in scenes:
        ds = merge_scenes([files[s] for s in scenes if s != held_out],
                          files[held_out])
        trainer = Trainer(cfg, ds, device)
        # pack and copy the training split before the clocks start (JAX's
        # Trainer does so when built): train_time_s counts steps only
        trainer.train_dev
        tcfg = trainer.cfg
        state = trainer.init_state()
        # three independent streams, so the NUMBER of evals and rescues does
        # not change the training draws: training on the device from
        # cfg.seed (as cli train); eval seeds and the fresh discriminators'
        # weights on the CPU, seeded with the SeedSequence hashes of
        # (cfg.seed, 1) and (cfg.seed, 2)
        rng = torch.Generator(device=trainer.device).manual_seed(cfg.seed)
        eval_rng = torch.Generator().manual_seed(stream_seed(cfg.seed, 1))
        rescue_rng = torch.Generator().manual_seed(stream_seed(cfg.seed, 2))
        best = {"best_ade_min": float("inf"), "best_fde_min": float("inf"),
                "best_at_epoch": 0}
        best_state = copy.deepcopy(state)
        tracker = StallTracker(ade_stall_recover, grace=ade_stall_grace,
                               max_rescues=ade_stall_max_rescues,
                               classify_patience=ade_stall_classify)
        tic_total = time.perf_counter()
        train_time = 0.0
        done = 0
        last_ev = None                # in-loop eval reused as the final
        last_ev_at = -1               # eval when the epochs line up
        next_eval = eval_every if eval_every > 0 else n_epochs + 1
        while done < n_epochs:
            block = min(fused_block, n_epochs - done, next_eval - done)
            tic = time.perf_counter()
            if block > 1:
                state, m = trainer.train_epochs(state, rng, block)
            else:
                state, m = trainer.train_epoch(state, rng)
            train_time += time.perf_counter() - tic
            done += block
            if verbose and (done % max(fused_block * 5, 1) == 0
                            or done == n_epochs):
                print(f"  [{held_out}] epoch {done}/{n_epochs} "
                      f"train ADE={m['train_ade']:.3f}")
            if done < next_eval:
                continue
            next_eval += eval_every
            ev = _evaluate(trainer, state, eval_rng)
            last_ev, last_ev_at = ev, done
            if ev["ade_min"] < best["best_ade_min"]:
                best = {"best_ade_min": ev["ade_min"],
                        "best_fde_min": ev["fde_min"],
                        "best_at_epoch": done}
                best_state = copy.deepcopy(state)
            if verbose:
                # avg-of-K alongside min-of-K: avg≈min means the K samples
                # collapsed (no diversity)
                print(f"  [{held_out}] eval @{done}: min-ADE/FDE "
                      f"{ev['ade_min']:.3f}/{ev['fde_min']:.3f} "
                      f"avg {ev['ade_avg']:.3f} "
                      f"(best {best['best_ade_min']:.3f} "
                      f"@{best['best_at_epoch']})")
            if tracker.observe(ev["ade_min"], ade_avg=ev["ade_avg"],
                               train_ade=m.get("train_ade")) \
                    and done < n_epochs:
                # stalled adversarial equilibrium: restore the best state
                # seen (a fresh copy: the snapshot stays as it is) with a
                # fresh discriminator
                state = reinit_discriminator(copy.deepcopy(best_state),
                                             tcfg, rescue_rng)
                tracker.fired(best["best_ade_min"], at_epoch=done)
                if verbose:
                    sig = (f" [{tracker.last_signature}]"
                           if tracker.last_trigger == "classifier" else "")
                    print(f"  [{held_out}] ADE stalled @{done} "
                          f"({tracker.last_trigger} trigger{sig}); "
                          f"restored best (epoch {best['best_at_epoch']}) "
                          f"with a re-initialized discriminator")
        total_wall = time.perf_counter() - tic_total

        if last_ev_at == done:
            ev = last_ev              # the loop already evaluated this
        else:                         # exact state — don't re-draw it
            ev = _evaluate(trainer, state, eval_rng)
        ev["train_time_s"] = train_time
        ev["total_wall_s"] = total_wall
        if eval_every > 0:
            if ev["ade_min"] < best["best_ade_min"]:
                best = {"best_ade_min": ev["ade_min"],
                        "best_fde_min": ev["fde_min"],
                        "best_at_epoch": done}
            ev.update(best)
            ev["rescues"] = tracker.rescues
            ev["rescues_fired_by_classifier"] = tracker.fired_early
        results[held_out] = ev
        if verbose:
            print(f"{held_out}: ADE/FDE (min-{cfg.n_gen_samples}) = "
                  f"{ev['ade_min']:.3f}/{ev['fde_min']:.3f} | avg = "
                  f"{ev['ade_avg']:.3f}/{ev['fde_avg']:.3f} "
                  f"({train_time:.0f}s train)")
        # this fold's device state goes before the next fold's is built
        del trainer, state, best_state

    if verbose and results:
        avg_ade = np.mean([r["ade_min"] for r in results.values()])
        avg_fde = np.mean([r["fde_min"] for r in results.values()])
        print(f"AVG: ADE/FDE (min-{cfg.n_gen_samples}) = "
              f"{avg_ade:.3f}/{avg_fde:.3f}")
        if eval_every > 0:
            avg_bade = np.mean([r["best_ade_min"]
                                for r in results.values()])
            avg_bfde = np.mean([r["best_fde_min"]
                                for r in results.values()])
            print(f"AVG best-over-training: {avg_bade:.3f}/{avg_bfde:.3f}")
    return results
