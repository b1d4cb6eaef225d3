"""Exact gradient accumulation of socialways_torch's ``gan_step`` against
socialways_tpu's under JAX's draws: A = 2 and 4 micro-chunks with social
attention, the agent frame, PacGAN (pac 2, a mixed pack at the padded
tail), minibatch stddev (chunk-local, as JAX documents) and annealed D
instance noise; the alignment check of the packed split; and the
arguments JAX refuses.

Tolerances as in test_torch_train_step.py (see there)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_tpu.engine.train_step import gan_step as jax_gan_step
from socialways_tpu.engine.trainer import \
    _check_grad_accum_alignment as jax_check_alignment
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import (load_npz_dataset,
                                           pack_scene_batches)
from socialways_torch.engine.train_step import draw_step, gan_step
from socialways_torch.engine.trainer import (Trainer,
                                             check_grad_accum_alignment)
from socialways_torch.io.checkpoint import train_state_from_jax
from test_torch_gan_step_variants2 import run_steps
from test_torch_gan_variants import PLAIN
from test_torch_train_step import LOO, jax_init, to_torch


def aligned_chunk(seed, n=32, part=8, pad=3):
    """Random-walk windows whose scenes never cross a multiple of ``part``
    rows, the last ``pad`` rows padding (so with pac 2 the tail holds a
    pack of a valid and a padded row)."""
    rng = np.random.RandomState(seed)
    steps = rng.randn(n, 20, 2).astype(np.float32) * 0.05
    traj = np.cumsum(steps, axis=1) + rng.rand(n, 1, 2).astype(np.float32)
    ids = np.full(n, -1, np.int32)
    sid = 0
    for start in range(0, n, part):
        row, end = start, min(start + part, n - pad)
        while row < end:
            s = min(int(rng.randint(1, part + 1)), end - row)
            ids[row:row + s] = sid
            row, sid = row + s, sid + 1
    valid = ids >= 0
    obsv, pred = traj[:, :8].copy(), traj[:, 8:].copy()
    obsv[~valid] = 0.0
    pred[~valid] = 0.0
    return {"obsvs": obsv, "preds": pred, "scene_ids": ids, "valid": valid}


@pytest.mark.parametrize("accum", [2, 4])
def test_torch_grad_accum_step_matches_jax(accum):
    """Two accumulated steps: D and G gradients summed over the parts, the
    label terms weighted by valid-pack share and the rest by valid-sample
    share; the D phase on a no-grad rollout of each part."""
    flags = dict(LOO, grad_accum=accum, pac=2, mb_std=True)
    tcfg, state, _ = run_steps(flags, seed=17, steps=2, chunk=aligned_chunk)
    assert state.g_opt.count == 2 and state.d_opt.count == 4


def test_torch_grad_accum_check_refuses_split_scenes_as_jax(tmp_path):
    """The packed toy split (scenes of 6 at width 64) splits a scene at
    A = 2 with social attention; both packages refuse it alike, and
    accept it without social attention or at a divisor that aligns."""
    path = str(tmp_path / "toy.npz")
    np.savez(path, **make_toy_npz_arrays(n_per_batch=6))
    flags = dict(PLAIN, batch_size=64, use_social=True)
    tr = Trainer(TrainConfig(**flags, grad_accum=2), load_npz_dataset(path),
                 "cpu")
    with pytest.raises(ValueError) as got:
        tr.train_packed
    with pytest.raises(ValueError) as want:
        jax_check_alignment(_packed(path, 64), 2, True)
    assert str(got.value) == str(want.value)
    assert "splits scene" in str(got.value)
    check_grad_accum_alignment(_packed(path, 64), 2, False)
    with pytest.raises(ValueError) as got:
        check_grad_accum_alignment(_packed(path, 64), 3, False)
    with pytest.raises(ValueError) as want:
        jax_check_alignment(_packed(path, 64), 3, False)
    assert str(got.value) == str(want.value)


def _packed(path, batch):
    ds = load_npz_dataset(path)
    nt = ds.n_train_samples
    return pack_scene_batches(ds.obsvs[:nt], ds.preds[:nt],
                              ds.train_batches, batch)


@pytest.mark.parametrize("flags", [
    dict(grad_accum=2, use_variety_loss=True),
    dict(grad_accum=2, ms_weight=0.1), dict(grad_accum=2, ds_weight=0.1),
    dict(grad_accum=3), dict(grad_accum=8, pac=8), dict(pac=3)],
    ids=["variety", "ms", "ds", "rows", "chunk_pac", "pac_rows"])
def test_torch_gan_step_refuses_what_jax_refuses(flags):
    """The same ValueError as JAX's gan_step, before any update."""
    flags = dict(PLAIN, **flags)
    b = aligned_chunk(3, n=32, part=8)
    jstate = jax_init(jax.random.PRNGKey(0), JaxConfig(**flags))
    with pytest.raises(ValueError) as want:
        jax_gan_step(jstate, {a: jnp.asarray(v) for a, v in b.items()},
                     jax.random.PRNGKey(1), JaxConfig(**flags))
    tcfg = TrainConfig(**flags)
    state = train_state_from_jax(jax.device_get(jstate), tcfg, "cpu")
    draws = draw_step(32, tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as got:
        gan_step(state, to_torch(b), draws, tcfg)
    assert str(got.value) == str(want.value)
    assert state.g_opt.count == 0 and state.d_opt.count == 0
