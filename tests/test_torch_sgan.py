"""Social GAN with its pooling module on the port's serving path
(models/sgan.py, ops/sgan_pool.py) against the benchmark's plain
reference (perfbench/reference/sgan.py, written from the published
code), on the CPU at small sizes with seeded weights given to both
through the state-dict mapping.  No JAX: the JAX package has no Social
GAN.

Tolerances.  The port and the reference round at the same points; only
the order of float32 sums differs (the port adds h_j W_1h + b_1 once a
column, the reference sums the published concatenation).  float32: the
results agree to float32 rounding, ``F32_TOL`` relative to the outputs'
scale.  bf16: a sum on the other side of a bf16 rounding boundary moves
a value by a bf16 ulp now and then; the pool's outputs (|P| < 1) by a
few 1e-4 at most (``BF16_POOL_TOL``), trajectories by a bf16 ulp of a
position (``BF16_TRAJ_TOL``, positions within [-2, 3]).

Two checks must catch purpose-made faults of the pool: the diagonal pair
left out and a mean taken in place of the max (``test_*_fault_*``).
"""

import numpy as np
import pytest
import torch

from socialways_torch.cli import main as cli
from socialways_torch.config import TrainConfig
from socialways_torch.engine.simulate import crowd_simulate
from socialways_torch.eval.metrics import k_sample_rollout
from socialways_torch.io.checkpoint import (adopt_checkpoint_config,
                                            load_checkpoint_config,
                                            restore_generator,
                                            save_generator_checkpoint)
from socialways_torch.models import sgan
from socialways_torch.ops import sgan_pool as sp
from socialways_torch.ops.nn import cast_params

from perfbench.reference import sgan as ref
from perfbench.reference.precision import Precision

F32_TOL = 1e-5
BF16_POOL_TOL = 2e-3
BF16_TRAJ_TOL = 1.6e-2
CFG = TrainConfig(model="sgan", noise_len=8, noise_dist="gaussian",
                  max_scene_size=16)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(seed: int = 0):
    """(the reference's sgan-named state dict, the port's generator holding
    the same weights)."""
    torch.manual_seed(seed)
    state = ref.TrajectoryGenerator().state_dict()
    gen = sgan.init_sgan(CFG, None, "cpu")
    gen.load_state_dict(sgan.from_sgan_state_dict(state))
    return state, gen.requires_grad_(False)


def _crowd(n: int, seed: int, max_scene: int = 16, pad: int = 0):
    """(obsv [N, 8, 2], ids [N]): sorted contiguous scenes of 1-max_scene,
    the last ``pad`` rows padding (-1)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_scene + 1, size=n)
    ids = np.repeat(np.arange(n), sizes)[:n].astype(np.int32)
    if pad:
        ids[-pad:] = -1
    base = rng.random((n, 1, 2), dtype=np.float32)
    walk = rng.standard_normal((n, 8, 2), dtype=np.float32) * 0.005
    return (torch.from_numpy(base + np.cumsum(walk, axis=1)),
            torch.from_numpy(ids))


def _pool_inputs(gen, dtype, n=150, seed=1, pad=5):
    obsv, ids = _crowd(n, seed, pad=pad)
    g = cast_params(gen, dtype)
    h = sgan.encode(g, obsv.to(dtype))
    return g, obsv[:, -1].to(dtype), h, ids


def _ref_pool(state, pos, h, ids, dtype):
    P = Precision(dtype)
    W = ref._Weights(state, P)
    return ref.pool(W, pos.float(), h.float(), ids, P)


def _pool_gap(got, want) -> float:
    return float((got.float() - want).abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_sgan_pool_forms_match_reference(dtype):
    """Dense, blocked and scene-window forms against the reference's
    published form, float32 and the bf16 contract; the three forms
    agree with each other to float32 rounding."""
    state, gen = _weights()
    g, pos, h, ids = _pool_inputs(gen, DTYPES[dtype])
    want = _ref_pool(state, pos, h, ids, dtype)
    forms = {"dense": sp.social_pool_dense(g.pool_embed, g.pool_mlp, pos, h,
                                           ids),
             "blocked": sp.social_pool_blocked(g.pool_embed, g.pool_mlp, pos,
                                               h, ids, block=32),
             "windowed": sp.social_pool_windowed(g.pool_embed, g.pool_mlp,
                                                 pos, h, ids, 16, block=32)}
    tol = F32_TOL if dtype == "float32" else BF16_POOL_TOL
    for name, got in forms.items():
        assert got.dtype == torch.float32, name
        assert _pool_gap(got.to(DTYPES[dtype]), want) <= tol, name
        assert torch.allclose(got, forms["dense"], rtol=1e-6, atol=1e-6)
    assert float(want.abs().max()) > 0.05       # the pool is not trivial


def test_torch_sgan_pool_scene_of_one_and_padding():
    """A scene of one agent pools its own pair alone; padded rows get
    zeros; the plain dispatch takes the windowed form above the dense
    size and agrees with the dense form."""
    state, gen = _weights(2)
    g, pos, h, ids = _pool_inputs(gen, torch.float32, n=40, seed=3, pad=4)
    ids = ids.clone()
    ids[:3] = torch.tensor([100, 101, 101], dtype=torch.int32)
    out = sp.social_pool_dense(g.pool_embed, g.pool_mlp, pos, h, ids)
    e = g.pool_embed.b                         # p_i - p_i = 0
    z = torch.relu(torch.cat([e, h[0]]) @ g.pool_mlp[0].w + g.pool_mlp[0].b)
    own = torch.relu(z @ g.pool_mlp[1].w + g.pool_mlp[1].b)
    assert torch.allclose(out[0], own, atol=1e-6)
    assert torch.equal(out[-4:], torch.zeros_like(out[-4:]))
    assert bool((out[:-4].abs().sum(1) > 0).all())
    big, big_ids = _crowd(300, 4, pad=3)
    big_h = torch.randn(300, 32, generator=torch.Generator().manual_seed(4))
    plain = sp.social_pool_plain(g.pool_embed, g.pool_mlp, big[:, -1],
                                 big_h, big_ids, 16)
    dense = sp.social_pool_dense(g.pool_embed, g.pool_mlp, big[:, -1], big_h,
                                 big_ids)
    assert torch.allclose(plain, dense, rtol=1e-6, atol=1e-6)


def _faulty_pool_gap(monkeypatch, fault) -> float:
    state, gen = _weights()
    g, pos, h, ids = _pool_inputs(gen, torch.float32)
    want = _ref_pool(state, pos, h, ids, "float32")
    monkeypatch.setattr(sp, "_pair_max", fault(sp._pair_max))
    return _pool_gap(sp.social_pool_dense(g.pool_embed, g.pool_mlp, pos, h,
                                          ids), want)


def test_torch_sgan_pool_fault_diagonal_left_out_is_caught(monkeypatch):
    """The check of ``test_torch_sgan_pool_forms_match_reference`` fails
    when the pool leaves the pair (i, i) out."""
    def fault(pair_max):
        def no_diagonal(pe, mlp, p_i, p_j, col, mask, op):
            eye = torch.eye(mask.shape[0], mask.shape[1], dtype=torch.bool)
            return pair_max(pe, mlp, p_i, p_j, col, mask & ~eye, op)
        return no_diagonal
    assert _faulty_pool_gap(monkeypatch, fault) > 100 * F32_TOL


def test_torch_sgan_pool_fault_mean_for_max_is_caught(monkeypatch):
    """The same check fails when the pool takes a masked mean over j in
    place of the max."""
    def fault(pair_max):
        def mean_pool(pe, mlp, p_i, p_j, col, mask, op):
            best = pair_max(pe, mlp, p_i, p_j, col, mask, op)
            rel = p_j[None] - p_i[:, None]
            e = sp.linear_apply(pe, rel)
            z = torch.relu(e @ mlp[0].w[:e.shape[-1]] + col[None])
            z = torch.relu(sp.linear_apply(mlp[1], z))
            z = torch.where(mask[..., None], z, 0.0)
            cnt = mask.sum(1, keepdim=True).clamp(min=1)
            return torch.where(best > 0, z.sum(1) / cnt, best)
        return mean_pool
    assert _faulty_pool_gap(monkeypatch, fault) > 100 * F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_sgan_crowd_simulate_matches_reference(dtype):
    """Two windows of ``crowd_simulate`` (the scene-window pool, noise
    [W, S, 8] by scene id) against the reference's simulate."""
    state, gen = _weights(5)
    obsv, ids = _crowd(120, 6)
    noise = torch.randn(2, 120, 8, generator=torch.Generator().manual_seed(7))
    got = crowd_simulate(gen, obsv, ids, 2, CFG.replace(compute_dtype=dtype),
                         noise=noise)
    want = ref.simulate(state, obsv, ids, noise, 12, Precision(dtype))
    assert got.shape == (120, 24, 2) and got.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TRAJ_TOL
    assert float((got - want).abs().max()) <= tol
    assert float((got[:, -1] - obsv[:, -1]).abs().max()) > 0.01


def test_torch_sgan_k_sample_rollout_matches_reference():
    """K = 3 forecasts (encode and pool once, the decode on K N rows) equal
    the reference's rollout of each draw; positions and steps agree."""
    state, gen = _weights(8)
    obsv, ids = _crowd(90, 9, pad=2)
    noise = torch.randn(3, 90, 8, generator=torch.Generator().manual_seed(1))
    got = k_sample_rollout(gen, obsv, ids, 3, CFG, noise=noise)
    assert got.shape == (3, 90, 12, 4)
    P = Precision("float32")
    W = ref._Weights(state, P)
    for k in range(3):
        want = ref.rollout(W, obsv, ids, noise[k], 12, P)
        assert float((got[k, :, :, :2] - want).abs().max()) <= F32_TOL
    steps = got[..., :2] - torch.cat([obsv[None, :, -1:].expand(3, -1, -1, -1),
                                      got[:, :, :-1, :2]], dim=2)
    assert torch.allclose(steps, got[..., 2:], atol=1e-5)


def test_torch_sgan_one_noise_vector_a_scene():
    """The noise is one vector a scene: changing scene s's vector moves
    every row of scene s and no other row."""
    _, gen = _weights(10)
    obsv, ids = _crowd(80, 11)
    noise = torch.randn(1, 80, 8, generator=torch.Generator().manual_seed(2))
    base = k_sample_rollout(gen, obsv, ids, 1, CFG, noise=noise)
    s = int(ids[40])
    moved = noise.clone()
    moved[0, s] += 1.0
    out = k_sample_rollout(gen, obsv, ids, 1, CFG, noise=moved)
    diff = (out - base).abs().amax(dim=(0, 2, 3))
    in_scene = ids == s
    assert bool((diff[in_scene] > 0).all())
    assert float(diff[~in_scene].max()) == 0.0
    z = sgan.scene_noise(noise[0], ids)
    assert torch.equal(z[in_scene], noise[0, s].expand(int(in_scene.sum()),
                                                        -1))


def test_torch_sgan_state_dict_mapping_round_trip():
    """sgan-named weights -> the port -> sgan's names: the linear layers
    and LSTM weights come back equal, each LSTM's bias as the sum."""
    state, gen = _weights(12)
    back = sgan.to_sgan_state_dict(gen)
    assert set(back) == set(state)
    for k, v in state.items():
        if k.endswith("bias_ih_l0"):
            other = k.replace("bias_ih_l0", "bias_hh_l0")
            assert torch.allclose(back[k], v + state[other])
        elif not k.endswith("bias_hh_l0"):
            assert torch.equal(back[k], v), k
    again = sgan.init_sgan(CFG, None, "cpu")
    again.load_state_dict(sgan.from_sgan_state_dict(back))
    for (k, a), b in zip(gen.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_torch_sgan_checkpoint_round_trip(tmp_path):
    """A Social GAN checkpoint carries its model fields and restores the
    same generator under a config built without them."""
    _, gen = _weights(13)
    cfg = CFG.replace(mlp_dim=48)
    gen = sgan.init_sgan(cfg, torch.Generator().manual_seed(3), "cpu")
    path = str(tmp_path / "sgan.npz")
    save_generator_checkpoint(path, gen, 7, cfg=cfg)
    saved = load_checkpoint_config(path)
    assert saved["model"] == "sgan" and saved["mlp_dim"] == 48
    adopted = adopt_checkpoint_config(TrainConfig(), path)
    assert adopted.model == "sgan" and adopted.mlp_dim == 48
    back, epoch, _ = restore_generator(path, adopted, "cpu")
    assert epoch == 7 and isinstance(back, sgan.SganGenerator)
    for (k, a), b in zip(gen.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k
    sw = TrainConfig()
    assert "model" not in load_checkpoint_config(_social_ways_ckpt(
        tmp_path, sw))


def _social_ways_ckpt(tmp_path, cfg):
    from socialways_torch.models.generator import init_generator
    path = str(tmp_path / "sw.npz")
    save_generator_checkpoint(path, init_generator(
        cfg, torch.Generator().manual_seed(0), "cpu"), 1, cfg=cfg)
    return path


def test_torch_sgan_cli_simulate_and_serving(tmp_path, capsys):
    """``simulate --model sgan`` through the CLI (with a traced window
    whose spans hold the ``pool`` phase), then ``predict`` and
    ``evaluate`` of a saved Social GAN checkpoint."""
    out, prof = str(tmp_path / "traj.npz"), str(tmp_path / "prof")
    assert cli.main(["--cpu", "simulate", "--model", "sgan", "--agents",
                     "64", "--windows", "2", "--scene-size", "8", "--out",
                     out, "--profile-dir", prof]) == 0
    with np.load(out) as d:
        assert d["trajectories"].shape == (64, 24, 2)
        assert np.isfinite(d["trajectories"]).all()
    import json
    import os
    with open(os.path.join(prof, "spans.json")) as f:
        names = {s["name"] for s in json.load(f)["spans"]}
    assert {"sim.window", "encode", "pool", "decode", "frame"} <= names
    from socialways_torch.data.scale import Scale
    from socialways_torch.data.toy import make_toy_npz_arrays
    data = str(tmp_path / "toy.npz")
    np.savez(data, **make_toy_npz_arrays(n_samples=48, n_per_batch=6))
    gen = sgan.init_sgan(CFG, torch.Generator().manual_seed(0), "cpu")
    ckpt = str(tmp_path / "sgan.npz")
    scale = Scale().fit(np.load(data)["obsvs"].reshape(-1, 2))
    save_generator_checkpoint(ckpt, gen, 1, scale, cfg=CFG)
    preds = str(tmp_path / "preds.npz")
    assert cli.main(["--cpu", "predict", "--data", data, "--model-file",
                     ckpt, "--n-gen-samples", "3", "--out", preds]) == 0
    with np.load(preds) as d:
        assert d["preds_our"].shape[0] == 3
    assert cli.main(["--cpu", "evaluate", "--data", data, "--model-file",
                     ckpt, "--n-gen-samples", "3"]) == 0
    assert "ADE,FDE" in capsys.readouterr().out


@pytest.mark.parametrize("command", [
    ["train", "--data", "x.npz"], ["sweep", "--data", "x.npz"],
    ["eth-ucy", "--data-dir", "d", "--recipe", "loo"]])
def test_torch_sgan_training_commands_refuse_it(command, capsys):
    """``train``, ``sweep`` and ``eth-ucy`` refuse ``--model sgan``, naming
    the field, before reading any data."""
    assert cli.main(["--cpu"] + command + ["--model", "sgan"]) == 2
    err = capsys.readouterr().err
    assert "model='sgan'" in err and "served only" in err


def test_torch_sgan_fused_pool_refuses_before_any_launch():
    """The kernel's wrapper raises on what the kernel does not take (the
    CPU, other widths, a gradient to record) before it loads anything;
    the CPU rollout takes the plain forms."""
    from socialways_torch.kernels import social_pool as spk
    _, gen = _weights(14)
    g, pos, h, ids = _pool_inputs(gen, torch.bfloat16, n=20, pad=0)
    assert torch.equal(sgan.pool(g, pos, h, ids, 16),
                       sp.social_pool_plain(g.pool_embed, g.pool_mlp, pos, h,
                                            ids, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        spk.social_pool_fused(g.pool_embed, g.pool_mlp, pos, h, ids, 16)
    with pytest.raises(ValueError, match="pool MLP"):
        spk.social_pool_fused(g.pool_embed, g.pool_mlp, pos, h[:, :16], ids)
    with pytest.raises(ValueError, match="every operand"):
        spk.social_pool_fused(g.pool_embed, g.pool_mlp, pos.float(), h, ids)
    with pytest.raises(RuntimeError, match="no backward"):
        spk.social_pool_fused(g.pool_embed, g.pool_mlp, pos,
                              h.clone().requires_grad_(True), ids)


@pytest.mark.parametrize("change", [
    dict(bottleneck_dim=8), dict(embedding_dim=8), dict(encoder_h_dim=16),
    dict(grad=True)], ids=["bottleneck", "embedding", "encoder", "grad"])
def test_torch_sgan_pool_on_the_card_never_falls_back(change, monkeypatch):
    """On a CUDA tensor the pool is the kernel's launch or an error that
    names the kernel's widths: other widths, or a gradient to record,
    raise before anything is loaded, and the plain forms are not run
    (``_on_card`` faked true on the CPU)."""
    change = dict(change)
    grad = change.pop("grad", False)
    cfg = CFG.replace(**change)
    gen = sgan.init_sgan(cfg, torch.Generator().manual_seed(15), "cpu")
    obsv, ids = _crowd(20, 15)
    monkeypatch.setattr(sgan, "_on_card", lambda t: True)
    monkeypatch.setattr(sgan, "social_pool_plain", None)
    with torch.set_grad_enabled(grad):
        h = sgan.encode(gen, obsv)
        err = RuntimeError if grad else ValueError
        with pytest.raises(err, match="no backward" if grad else
                           "built for h \\[N, 32\\].* 16 \\+ 32 -> 512 -> 32"):
            sgan.pool(gen, obsv[:, -1], h, ids, 16)


@pytest.mark.parametrize("field,value", [
    ("agent_frame", True), ("use_social", True), ("decoder", "lstm"),
    ("hidden_size", 32), ("noise_dist", "uniform")])
def test_torch_sgan_refuses_what_it_would_ignore(field, value):
    """Social Ways' own fields, and uniform noise, are refused under
    ``model='sgan'`` by name, where SGAN would ignore them."""
    with pytest.raises(NotImplementedError, match=f"{field}=.*'sgan'"):
        sgan.init_sgan(CFG.replace(**{field: value}))


def test_torch_sgan_cli_noise_and_models_agree(tmp_path):
    """``--model sgan`` draws Gaussian noise and refuses ``--noise-dist
    uniform`` by name; Social Ways keeps uniform; ``init_model`` builds
    the generator ``cfg.model`` names, and a Social Ways checkpoint
    served under ``--model sgan`` is read as Social Ways'."""
    from socialways_torch.models import init_model
    from socialways_torch.models.generator import Generator
    parse = lambda *a: cli._train_cfg(cli.parse_args(["--cpu", "simulate",
                                                      *a]))
    assert parse("--model", "sgan").noise_dist == "gaussian"
    assert parse().noise_dist == "uniform"
    with pytest.raises(NotImplementedError, match="noise_dist='uniform'"):
        init_model(parse("--model", "sgan", "--noise-dist", "uniform"),
                   device="cpu")
    assert isinstance(init_model(parse("--model", "sgan"), device="cpu"),
                      sgan.SganGenerator)
    assert isinstance(init_model(parse(), device="cpu"), Generator)
    path = _social_ways_ckpt(tmp_path, TrainConfig())
    assert adopt_checkpoint_config(parse("--model", "sgan"),
                                   path).model == "socialWays"
