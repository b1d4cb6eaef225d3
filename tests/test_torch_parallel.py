"""socialways_torch's data parallelism (parallel/, ``gan_step(mesh=)``,
``eval_chunk(mesh=)``, ``Trainer(mesh=)``, ``EnsembleTrainer(mesh=)``,
``crowd_simulate_sharded``, ``train --mesh``) against socialways_tpu's
parallel/ on the CPU.

The port's ranks are gloo processes (``parallel.spawn``, the rank
functions in ``torch_dist_workers``): one spawn of 2 ranks and one of 4
run every case, started in threads while this process compiles JAX's
programs (four on the 8-device CPU mesh of ``conftest.py``: the DP step
at 4 devices, the DP eval, ``crowd_simulate_sharded`` and the
member-sharded ensemble's evaluate, at 2).  Each spawn gives up after 120
s and ends its ranks.

Tolerances: the DP step against JAX's at rtol 1e-4 / atol 1e-5 on the
metrics and ``assert_state_close``'s bounds on the state (the port's
single-device step against JAX's uses the same); the port's DP step
against its own single-process step on the concatenated group at JAX's
DP test tolerances (losses rtol 1e-5, parameters rtol 2e-4 / atol 1e-6);
the sharded forms against JAX's at rtol 2e-4 / atol 2e-5 (JAX's own
sharded tests); evaluations at rel 1e-4 (2e-4 for an ensemble member
against its solo run, as tests/test_torch_ensemble.py holds them)."""

import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from socialways_tpu.config import TrainConfig as JaxConfig
from socialways_tpu.data.dataset import load_npz_dataset as jax_load
from socialways_tpu.data.dataset import pack_scene_batches as jax_pack
from socialways_tpu.engine import EnsembleTrainer as JaxEnsemble
from socialways_tpu.engine import Trainer as JaxTrainer
from socialways_tpu.engine import stack_states as jax_stack_states
from socialways_tpu.engine.simulate import \
    crowd_simulate_sharded as jax_crowd_sharded
from socialways_tpu.kernels.social_attention import _xla_reference
from socialways_tpu.parallel import host_chunk_feed as jax_feed
from socialways_tpu.parallel import local_group_slice as jax_group_slice
from socialways_tpu.parallel import (make_dp_eval_chunk, make_dp_train_step,
                                     make_mesh)
from socialways_tpu.parallel import shard_packed_for_mesh as jax_shard
from socialways_torch.cli import main as cli
from socialways_torch.config import TrainConfig
from socialways_torch.data.dataset import load_npz_dataset, \
    pack_scene_batches
from socialways_torch.data.toy import make_toy_npz_arrays
from socialways_torch.engine.train_step import draw_step, init_train_state
from socialways_torch.io.checkpoint import (flatten_state, state_from_flat,
                                            train_state_from_jax)
from socialways_torch.parallel import (Mesh, host_chunk_feed,
                                       local_group_slice,
                                       shard_packed_for_mesh, spawn)
from test_torch_gan_variants import jax_draws
from test_torch_train_step import assert_state_close, jax_init
from torch_dist_workers import run_cases, unique_ids

dist = pytest.importorskip("torch.distributed")
if not dist.is_available() or not dist.is_gloo_available():
    pytest.skip("torch.distributed with gloo is not available",
                allow_module_level=True)

H, WIDTH = 16, 8
SMALL = dict(hidden_size=H, social_feature_size=H, noise_len=H // 2,
             n_past=4, n_next=3, n_unrolling_steps=1)
#: the loo model's features at the test width (unroll 1, info loss on)
LOO = dict(SMALL, agent_frame=True, use_social=True, g_ema_decay=0.99)
TIMEOUT = 120


def global_batch(seed, n_dev, pad=None):
    """``n_dev`` chunks of WIDTH rows in scenes of 2, concatenated, scene
    ids unique across chunks; ``pad`` {chunk: rows} marks that many tail
    rows of the chunk padding (ids -1, valid False, zeros)."""
    rng = np.random.RandomState(seed)
    n = n_dev * WIDTH
    traj = np.cumsum(rng.randn(n, 7, 2).astype(np.float32) * 0.05, axis=1)
    traj += rng.rand(n, 1, 2).astype(np.float32)
    ids = (np.arange(n) // 2).astype(np.int32)
    valid = np.ones(n, bool)
    for chunk, rows in (pad or {}).items():
        end = (chunk + 1) * WIDTH
        ids[end - rows:end], valid[end - rows:end] = -1, False
    traj[~valid] = 0.0
    return {"obsvs": traj[:, :4].copy(), "preds": traj[:, 4:].copy(),
            "scene_ids": ids, "valid": valid}


def numpy_draws(key, n, jcfg):
    return [None if t is None else t.numpy()
            for t in jax_draws(key, n, jcfg)]


def port_flat(jstate, flags):
    return flatten_state(train_state_from_jax(jax.device_get(jstate),
                                              TrainConfig(**flags), "cpu"))


#: port DP step against the port's single-process step on the concatenated
#: group (2 ranks): flags, the padding {chunk: rows}
DP_CASES = {
    "uneven_padding": (dict(SMALL, n_unrolling_steps=0), {1: 4}),
    "one_rank_filler": (LOO, {1: WIDTH}),
    "all_filler": (SMALL, {0: WIDTH, 1: WIDTH}),
    "agent_frame_social": (LOO, {0: 2}),
    "instance_noise": (dict(LOO, d_input_noise=0.3, d_input_noise_steps=5),
                       {}),
    "grad_accum": (dict(LOO, grad_accum=2), {1: 2}),
    "mb_std": (dict(SMALL, mb_std=True), {1: 2}),
    # R1's input gradient (torch.func.grad) through mb_std's sums over the
    # ranks: parallel.mesh.psum is a Function that torch.func transforms
    "r1_mb_std": (dict(SMALL, mb_std=True, r1_gamma=0.5), {0: 3}),
    "mode_seeking_diversity": (dict(SMALL, ms_weight=0.1, ds_weight=0.5,
                                    ds_tau=100.0, ds_k=3), {0: 2}),
}
#: the toy set's 2 + 2 steps
ENSEMBLE = dict(SMALL, n_past=2, n_next=2, batch_size=64, use_social=True,
                agent_frame=True)
SEEDS, ENSEMBLE_K = [0, 1, 2, 3], 3


def _spawn_thread(world, cases, box):
    def target():
        try:
            box["out"] = spawn(run_cases, world, "cpu", args=(cases,),
                               timeout=TIMEOUT)
        except BaseException as e:              # re-raised by the fixture
            box["err"] = e
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("parallel") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays())
    return path


@pytest.fixture(scope="module")
def runs(toy_npz):
    """Both spawns' results and JAX's, keyed by case."""
    flats, cases2, cases4, inputs = {}, [], [], {}
    # -- the DP step against JAX's at 4 ranks, and its 2x2 form
    jl = JaxConfig(**LOO)
    j0 = jax_init(jax.random.PRNGKey(0), jl)
    flats["loo"] = port_flat(j0, LOO)
    b4 = global_batch(11, 4, pad={2: 3})
    key4 = jax.random.PRNGKey(42)
    step4 = dict(cfg=LOO, flat=flats["loo"], batch=b4,
                 draws=numpy_draws(key4, 4 * WIDTH, jl))
    cases4 += [("step_case", step4), ("step_case", dict(step4, shape=(2, 2)))]
    # -- the ring and the gathered context at 4 ranks (one scene spans
    #    ranks, a singleton, padding)
    rng = np.random.RandomState(1)
    x4 = rng.randn(64, 4).astype(np.float32)
    hh = rng.randn(64, H).astype(np.float32)
    ctx_ids = np.zeros(64, np.int32)
    ctx_ids[20:40], ctx_ids[50:51], ctx_ids[-6:] = 1, 5, -1
    ctx = dict(cfg=LOO, flat=flats["loo"], x4=x4, h=hh, ctx_ids=ctx_ids)
    cases4.append(("crowd_case", ctx))
    # -- port DP against the port's single process, 2 ranks (the port's
    #    own init and draws: no JAX program to compile)
    for tag, (flags, pad) in DP_CASES.items():
        cfg = TrainConfig(**flags)
        flat = flatten_state(init_train_state(
            cfg, torch.Generator().manual_seed(3), "cpu"))
        inputs[tag] = flat
        draws = draw_step(2 * WIDTH, cfg, torch.Generator().manual_seed(7))
        cases2.append(("step_case", dict(
            cfg=flags, flat=flat, batch=global_batch(5, 2, pad), single=True,
            draws=[None if t is None else t.numpy() for t in draws])))
    # -- the DP eval against JAX's (2 ranks)
    b2 = global_batch(9, 2, pad={1: 3})
    key_e, k = jax.random.PRNGKey(21), 4
    noise = np.array(jax.random.uniform(key_e, (k, 2 * WIDTH, H // 2)))
    cases2.append(("eval_case", dict(cfg=LOO, flat=flats["loo"], batch=b2,
                                     noise=noise)))
    # -- the DP epoch, Trainer(mesh=) and the single-process epoch
    cases2.append(("epoch_case", dict(cfg=dict(LOO, batch_size=32),
                                      npz=toy_npz, seed=4)))
    # -- crowd_simulate_sharded (a scene spans the ranks) and the contexts
    crowd_cfg = dict(LOO, agent_frame=False)
    jcrowd = JaxConfig(**crowd_cfg)
    jc0 = jax_init(jax.random.PRNGKey(2), jcrowd)
    rng = np.random.RandomState(0)
    obsv0 = np.cumsum(rng.randn(32, 4, 2) * 0.01, 1).astype(np.float32)
    cids = np.zeros(32, np.int32)
    cids[10:22], cids[22:] = 1, 2
    cnoise = rng.rand(2, 32, H // 2).astype(np.float32)
    cases2.append(("crowd_case", dict(
        cfg=crowd_cfg, flat=port_flat(jc0, crowd_cfg), obsv0=obsv0,
        ids=cids, windows=2, noise=cnoise, x4=x4[:32], h=hh[:32],
        ctx_ids=ctx_ids[:32])))
    # -- EnsembleTrainer(mesh=): 2 ranks x 2 members
    jtr = JaxTrainer(JaxConfig(**ENSEMBLE), jax_load(toy_npz))
    n_chunks, width = jtr.test_packed.n_chunks, jtr.test_packed.width
    rngs = jnp.stack([jax.random.PRNGKey(30 + s) for s in SEEDS])
    keys = jax.vmap(lambda r: jax.random.split(r, n_chunks))(rngs)
    noises = [np.array(jax.vmap(lambda kk: jax.random.uniform(
        kk, (ENSEMBLE_K, width, H // 2)))(keys[:, c]))
        for c in range(n_chunks)]
    jstates = jax_stack_states([jax_init(jax.random.PRNGKey(s), jtr.cfg)
                                for s in SEEDS])
    member_flats = [port_flat(jax.tree_util.tree_map(
        lambda x, i=i: x[i], jstates), ENSEMBLE) for i in range(len(SEEDS))]
    cases2.append(("ensemble_case", dict(
        cfg=ENSEMBLE, npz=toy_npz, seeds=SEEDS, k=ENSEMBLE_K,
        noises=noises, flats=member_flats)))

    box2, box4 = {}, {}
    threads = [_spawn_thread(2, cases2, box2), _spawn_thread(4, cases4, box4)]

    # JAX's side while the ranks run
    want = {}
    s4, m4 = make_dp_train_step(jl, make_mesh(4))(
        j0, {a: jnp.asarray(v) for a, v in b4.items()}, key4)
    want["step4"] = (jax.device_get(s4), jax.device_get(m4), j0)
    want["eval"] = jax.device_get(make_dp_eval_chunk(jl, make_mesh(2), k)(
        j0.g_params, {a: jnp.asarray(v) for a, v in b2.items()}, key_e))
    p = {"feat_mlp": j0.g_params["feat_mlp"], "attn_w": j0.g_params["attn_w"]}
    want["ctx"] = np.asarray(_xla_reference(
        p, jnp.asarray(x4), jnp.asarray(hh), jnp.asarray(ctx_ids)))
    want["ctx32"] = np.asarray(_xla_reference(
        {"feat_mlp": jc0.g_params["feat_mlp"],
         "attn_w": jc0.g_params["attn_w"]}, jnp.asarray(x4[:32]),
        jnp.asarray(hh[:32]), jnp.asarray(ctx_ids[:32])))
    want["crowd"] = np.asarray(jax_crowd_sharded(
        jc0.g_params, jnp.asarray(obsv0), jnp.asarray(cids), 2,
        jax.random.PRNGKey(1), jcrowd, make_mesh(2),
        noise=jnp.asarray(cnoise)))
    want["ens_eval"] = JaxEnsemble(jtr, mesh=make_mesh(2)).evaluate(
        jstates, rngs, n_gen_samples=ENSEMBLE_K)

    for t in threads:
        t.join(TIMEOUT + 30)
    for box in (box2, box4):
        if "err" in box:
            raise box["err"]
    return {"w2": box2["out"], "w4": box4["out"], "jax": want,
            "inputs": inputs, "cases2": cases2}


def _state(flat, flags):
    return state_from_flat(flat, TrainConfig(**flags), "cpu")


def _assert_flat_close(got, want, rtol, atol, tag):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=f"{tag} {key}")


# ------------------------------------------------------- against JAX's
def test_torch_dp_step_matches_jax_dp_step_at_4_ranks(runs):
    """``gan_step(mesh=)`` at 4 ranks under JAX's global draws equals
    ``make_dp_train_step`` on 4 devices (loo features, uneven padding),
    and every rank holds the same state."""
    jstate, jm, j0 = runs["jax"]["step4"]
    flat, m = runs["w4"][0][0]["dp"]
    assert_state_close(_state(flat, LOO), jstate, "dp4", t_old=port_flat(
        j0, LOO), j_old=j0, cfg=TrainConfig(**LOO))
    for name in ("d_loss", "g_loss", "ade_sum", "fde_sum"):
        np.testing.assert_allclose(m[name], float(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert m["n_samples"] == int(jm.n_samples) == 4 * WIDTH - 3
    for rank in range(1, 4):
        other = runs["w4"][rank][0]["dp"][0]
        for key in flat:
            np.testing.assert_array_equal(other[key], flat[key], key)


def test_torch_2x2_mesh_equals_flat_4(runs):
    """The (dcn, data) mesh of 2 x 2 ranks gives the flat 4-rank step:
    the rank order is dcn-major and the reduction spans every rank."""
    flat, m = runs["w4"][0][0]["dp"]
    flat2, m2 = runs["w4"][0][1]["dp"]
    assert m2 == m
    for key in flat:
        np.testing.assert_array_equal(flat2[key], flat[key], key)


def test_torch_dp_eval_matches_jax_dp_eval(runs):
    """``eval_chunk(mesh=)`` slices the global noise and reduces the sums:
    JAX's ``make_dp_eval_chunk`` on 2 devices, and the single-process
    eval of the concatenated group."""
    got = runs["w2"][0][len(DP_CASES)]
    want = runs["jax"]["eval"]
    for g, s, w in zip(got["dp"], got["single"], want):
        assert g == pytest.approx(float(w), rel=1e-4)
        assert g == pytest.approx(s, rel=1e-5)
    assert got["dp"][4] == int(want.n_samples) == 2 * WIDTH - 3
    assert runs["w2"][1][len(DP_CASES)]["dp"] == got["dp"]


@pytest.mark.parametrize("world", [2, 4])
def test_torch_sharded_and_ring_context_match_jax(runs, world):
    """The gathered and the ring form of the agents-axis context against
    JAX's single-device reference (a scene spanning ranks, a singleton,
    padding)."""
    if world == 2:
        got = runs["w2"][0][len(DP_CASES) + 2]
        want = runs["jax"]["ctx32"]
    else:
        got, want = runs["w4"][0][2], runs["jax"]["ctx"]
    for form in ("ctx_gather", "ctx_ring"):
        np.testing.assert_allclose(got[form], want, rtol=2e-4, atol=2e-5,
                                   err_msg=form)


@pytest.mark.parametrize("exchange", ["gather", "ring"])
def test_torch_crowd_simulate_sharded_matches_jax(runs, exchange):
    """``crowd_simulate_sharded`` at 2 ranks equals JAX's (gather form) on
    2 devices under the same noise, and every rank holds the whole crowd's
    trajectories."""
    got = runs["w2"][0][len(DP_CASES) + 2][exchange]
    assert got.shape == (32, 2 * SMALL["n_next"], 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, runs["jax"]["crowd"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(runs["w2"][1][len(DP_CASES) + 2][exchange],
                                  got)


def test_torch_ensemble_mesh_matches_jax_and_single_process(runs):
    """``EnsembleTrainer(mesh=)`` with 2 members a rank: ``evaluate`` of
    JAX's initial members under JAX's noise equals JAX's member-sharded
    ``evaluate``; an epoch and ``evaluate`` of the port's own members
    equal the 4-member ensemble in one process; every rank returns all
    4 members."""
    res = runs["w2"][0][len(DP_CASES) + 3]
    ev_jax = res["given"]
    assert len(ev_jax) == len(runs["jax"]["ens_eval"]) == 4
    for g, w in zip(ev_jax, runs["jax"]["ens_eval"]):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-4), key
    (m, ev, flats), (m1, ev1, flats1) = res["mesh"], res["single"]
    flats = flats + runs["w2"][1][len(DP_CASES) + 3]["mesh"][2]
    for key in m1:
        np.testing.assert_allclose(m[key], m1[key], rtol=2e-4, err_msg=key)
    for g, w in zip(ev, ev1):
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=2e-4), key
    for got, want in zip(flats, flats1):
        _assert_flat_close(got, want, 2e-4, 1e-6, "member")
    assert runs["w2"][1][len(DP_CASES) + 3]["mesh"][1] == ev


# ----------------------------------------- against the single process
@pytest.mark.parametrize("tag", list(DP_CASES))
def test_torch_dp_step_matches_single_process_step(runs, tag):
    """The 2-rank DP step equals the single-process step on the
    concatenated group: uneven padding, one rank holding only filler (it
    runs every collective: no hang), agent frame with social attention,
    instance noise, grad_accum, mb_std (a differentiable sum over the
    ranks) alone and under R1, mode seeking with the diversity hinge.  A step on filler
    alone changes nothing."""
    i = list(DP_CASES).index(tag)
    flags = DP_CASES[tag][0]
    flat, m = runs["w2"][0][i]["dp"]
    ref, m_ref = runs["w2"][0][i]["single"]
    for name in ("d_loss", "g_loss"):
        np.testing.assert_allclose(m[name], m_ref[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for name in ("ade_sum", "fde_sum"):
        np.testing.assert_allclose(m[name], m_ref[name], rtol=1e-5,
                                   err_msg=name)
    assert m["n_samples"] == m_ref["n_samples"]
    _assert_flat_close(flat, ref, 2e-4, 1e-6, tag)
    other = runs["w2"][1][i]["dp"][0]
    for key in flat:
        np.testing.assert_array_equal(other[key], flat[key], key)
    init = runs["inputs"][tag]
    changed = any(not np.array_equal(flat[k], init[k]) for k in init)
    assert changed == (tag != "all_filler")
    if tag == "all_filler":
        assert m["n_samples"] == 0 and m["g_loss"] == 0.0


def test_torch_dp_epoch_fn_equals_step_loop_and_trainer(runs):
    """``make_dp_epoch_fn`` equals a loop of DP steps over the same groups
    and draws bit for bit, and so does ``make_dp_epochs_fn`` over one
    epoch; ``Trainer(mesh=)``'s epoch (its own draws from
    the same seed) equals both; the epoch equals single-process steps on
    the concatenated groups; its evaluate is finite and has min <= avg."""
    res = runs["w2"][0][len(DP_CASES) + 1]
    for key in res["fused"]:
        np.testing.assert_array_equal(res["loop"][key], res["fused"][key])
        np.testing.assert_array_equal(res["epochs"][key], res["fused"][key])
        np.testing.assert_array_equal(res["trainer"][key],
                                      res["fused"][key])
    _assert_flat_close(res["fused"], res["single"], 2e-4, 1e-6, "epoch")
    m, mt = res["m_fused"], res["m_trainer"]
    assert mt["steps"] == res["steps"]
    assert mt["d_loss"] == pytest.approx(m["d_loss"], rel=1e-6)
    ds = load_npz_dataset(runs["cases2"][len(DP_CASES) + 1][1]["npz"])
    assert m["n_samples"] == ds.n_train_samples
    assert np.isfinite(res["eval"]["ade_min"])
    assert res["eval"]["ade_min"] <= res["eval"]["ade_avg"] + 1e-9
    assert runs["w2"][1][len(DP_CASES) + 1]["eval"] == res["eval"]


# ------------------------------------------------------------ host layout
@pytest.mark.parametrize("n_dev", [2, 4])
def test_torch_shard_packed_and_feed_match_jax(toy_npz, n_dev):
    """``shard_packed_for_mesh``, the ranks' ``host_chunk_feed`` rows in
    rank order and ``local_group_slice`` equal JAX's arrays."""
    ds, jds = load_npz_dataset(toy_npz), jax_load(toy_npz)
    packed = pack_scene_batches(ds.obsvs, ds.preds, ds.batches, 40)
    jpacked = jax_pack(jds.obsvs, jds.preds, jds.batches, 40)
    got = shard_packed_for_mesh(packed, n_dev)
    want = jax_shard(jpacked, make_mesh(n_dev))
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    feeds = [list(host_chunk_feed(packed, Mesh((n_dev,), ("data",), r,
                                               torch.device("cpu")),
                                  process_index=r, process_count=n_dev))
             for r in range(n_dev)]
    jfeed = list(jax_feed(jpacked, make_mesh(n_dev)))
    assert [g for g, _ in feeds[0]] == [g for g, _ in jfeed]
    for gi, (_, jb) in enumerate(jfeed):
        for key in jb:
            cat = np.concatenate([f[gi][1][key].numpy() for f in feeds])
            np.testing.assert_array_equal(cat, np.asarray(jb[key]), key)
    for n_groups in (1, 7, 8):
        for pc in (1, 3, 4):
            assert [local_group_slice(n_groups, pi, pc)
                    for pi in range(pc)] == [
                jax_group_slice(n_groups, pi, pc) for pi in range(pc)]


def test_torch_unique_ids_offsets_each_part():
    ids = np.array([0, 0, 1, -1, 0, 1, 1, -1], np.int32)
    np.testing.assert_array_equal(unique_ids(ids, 2),
                                  [0, 0, 1, -1, 4, 5, 5, -1])


# --------------------------------------------------------------------- CLI
def test_torch_cli_train_mesh_2_on_cpu_devices(toy_npz, tmp_path):
    """``--cpu --cpu-devices 2 train --mesh 2 --auto-recover`` trains 2
    gloo ranks end to end: rank 0 prints once and writes the checkpoint,
    which restores, and the baseline ``-best`` checkpoint, whose existence
    every rank takes from rank 0 (a rank that tested the file itself after
    rank 0 wrote it would skip the checkpoint's barrier).  The command
    runs in a session of its own, ended with its ranks if it outlasts the
    spawn timeout."""
    import os
    import signal
    import subprocess
    import sys
    mdir = tmp_path / "m"
    proc = subprocess.Popen(
        [sys.executable, "-m", "socialways_torch.cli.main", "--cpu",
         "--cpu-devices", "2", "train", "--data", toy_npz, "--mesh", "2",
         "--epochs", "1", "--h-size", str(H), "--batch-size", "64", "--k",
         "4", "--model-dir", str(mdir), "--auto-recover"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out
    assert out.count("Epc=") == 1 and "mesh 2: 2 ranks, gloo" in out
    assert sorted(p.name for p in mdir.iterdir()) == [
        "socialWays-hotel-best.npz", "socialWays-hotel.npz"]
    from socialways_torch.io.checkpoint import restore_checkpoint
    cfg = TrainConfig(hidden_size=H, social_feature_size=H, noise_len=H // 2,
                      batch_size=64, n_past=2, n_next=2)
    state, epoch, _, _ = restore_checkpoint(str(mdir / "socialWays-hotel.npz"),
                                            cfg, "cpu")
    assert epoch == 1 and state.g_opt.count > 0


def test_torch_cli_train_mesh_joins_a_torchrun_group(toy_npz, tmp_path,
                                                    monkeypatch):
    """Under ``torchrun`` (its environment: WORLD_SIZE, RANK, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) ``train --mesh`` joins the group it was
    started in instead of starting ranks: here a world of one process."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    mdir = tmp_path / "m"
    assert cli.main(["--cpu", "train", "--data", toy_npz, "--mesh", "1",
                     "--epochs", "1", "--h-size", str(H), "--batch-size",
                     "64", "--k", "4", "--model-dir", str(mdir)]) == 0
    assert not dist.is_initialized()
    assert sorted(p.name for p in mdir.iterdir()) == ["socialWays-hotel.npz"]


@pytest.mark.parametrize("argv,message", [
    (["--cpu", "--cpu-devices", "2", "train", "--mesh", "3"],
     "ERROR: --mesh 3 needs 3 devices, have 2"),
    (["--cpu", "train", "--mesh", "2x2"],
     "ERROR: --mesh 2x2 needs 4 devices, have 1"),
    (["--cpu-devices", "2", "train", "--mesh", "2"],
     "--cpu-devices requires --cpu"),
])
def test_torch_cli_mesh_refusals(argv, message, toy_npz, tmp_path, capsys):
    """Too few devices give rc 1 and JAX's message; ``--cpu-devices``
    without ``--cpu`` gives rc 1."""
    rc = cli.main(argv + ["--data", toy_npz, "--model-dir",
                          str(tmp_path / "m")])
    assert rc == 1
    assert message in capsys.readouterr().err
    assert not (tmp_path / "m").exists()
