"""The port's viz/ and its four commands against socialways_tpu's: the
arrays bit for bit (``to_image_frame``, ``to_pixels``,
``prediction_density``, ``parse_annotations``), the rendered PNGs and GIF
frames as decoded pixel arrays (not file bytes: PNG and GIF metadata may
differ), each command's printout; then JAX's own viz tests
(tests/test_aux.py:113-160, 209; tests/test_io_cli.py:187, 332) on the
port.  Host only: numpy, cv2 and matplotlib on the CPU."""

import os

import cv2
import numpy as np
import pytest

from socialways_tpu.cli import main as jax_cli
from socialways_tpu.io.dumps import dump_predictions as jax_dump
from socialways_tpu.viz import heatmap as jax_heatmap
from socialways_tpu.viz import video as jax_video
from socialways_torch.cli import main as cli
from socialways_torch.eval.stats import calc_and_store_stats, load_real_samples
from socialways_torch.io.dumps import dump_predictions
from socialways_torch.viz import heatmap, video


def _scene(seed, n=6, k=8, t_obs=2, t_pred=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, t_obs, 2).astype(np.float32) - 0.5,
            rng.rand(k, n, t_pred, 2).astype(np.float32) - 0.5,
            rng.rand(n, t_pred, 2).astype(np.float32) - 0.5)


def _obsmat(path):
    rows = ["0.0 1.0 5.0 0.0 6.0 0.1 0.0 0.1",
            "0.0 2.0 7.0 0.0 8.0 0.1 0.0 0.1",
            "10.0 1.0 5.5 0.0 6.5 0.1 0.0 0.1",
            "10.0 3.0 1.5 0.0 2.5 0.1 0.0 0.1",
            "20.0 3.0 1.75 0.0 2.25 0.1 0.0 0.1"]
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _hinv(seed):
    rng = np.random.RandomState(seed)
    h = heatmap.default_toy_hinv(480)
    h[:2, :2] += rng.randn(2, 2) * 10.0
    h[2, :2] = rng.randn(2) * 1e-3
    return h


# ------------------------------------------------- arrays, bit for bit
@pytest.mark.parametrize("fn", ["to_image_frame", "to_pixels",
                                "prediction_density", "parse_annotations"])
def test_torch_viz_arrays_equal_jax(fn, tmp_path):
    hinv = _hinv(3)
    loc = np.random.RandomState(4).randn(12, 2)
    if fn == "to_image_frame":
        got, want = (m.to_image_frame(hinv, loc)
                     for m in (heatmap, jax_heatmap))
    elif fn == "to_pixels":
        got, want = ([m.to_pixels(hinv, p) for p in loc]
                     for m in (video, jax_video))
    elif fn == "prediction_density":
        _, preds, _ = _scene(5, k=5)
        got, want = (m.prediction_density(preds, hinv, (480, 480),
                                          max_samples=4)
                     for m in (heatmap, jax_heatmap))
        assert got.max() > 0
    else:
        path = _obsmat(tmp_path / "obsmat.txt")
        got, want = (m.parse_annotations(path) for m in (video, jax_video))
        assert [a.tolist() for a in got[1]] == [a.tolist() for a in want[1]]
        for a, b in zip(got[2], want[2]):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        got, want = got[0], want[0]
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("with_bg", [False, True])
def test_torch_render_scene_pixels_equal_jax(with_bg):
    obsvs, preds, _ = _scene(6)
    bg = (np.random.RandomState(7).rand(480, 480, 3) * 255).astype(
        np.uint8) if with_bg else None
    got, want = (m.render_scene(obsvs, preds, _hinv(8), bg, epoch=12)
                 for m in (heatmap, jax_heatmap))
    assert got.dtype == np.uint8 and got.shape == (480, 480, 3)
    assert np.array_equal(got, want)


# ------------------------------------------- the commands against JAX's
def _run_both(argv, capsys, read):
    """``argv`` through JAX's CLI and then the port's (the same output
    paths); their printouts and what ``read`` decodes after each."""
    res = []
    for main in (jax_cli.main, cli.main):
        capsys.readouterr()
        assert main(list(argv)) == 0
        res.append((capsys.readouterr().out, read()))
    return res


def _png(path):
    return lambda: cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


def test_torch_cli_visualize_equals_jax(tmp_path, capsys):
    for epoch, seed in ((5, 0), (10, 1)):
        obsvs, preds_our, preds = _scene(seed)
        jax_dump(str(tmp_path / "preds" / str(epoch)), epoch, 0, obsvs,
                 preds_our, preds, preds)
    out = tmp_path / "figs"
    (jo, jpngs), (to, tpngs) = _run_both(
        ["visualize", "--preds-dir", str(tmp_path / "preds"), "--out",
         str(out)], capsys,
        lambda: {f: cv2.imread(str(out / f)) for f in sorted(os.listdir(out))})
    assert to == jo == f"wrote {out}\n"
    assert sorted(tpngs) == ["00005.png", "00010.png"] == sorted(jpngs)
    for f in tpngs:
        assert np.array_equal(tpngs[f], jpngs[f])


def test_torch_cli_animate_frames_equal_jax(tmp_path, capsys, toy_arrays):
    from PIL import Image, ImageSequence
    npz = str(tmp_path / "toy12.npz")
    np.savez(npz, obsvs=toy_arrays["obsvs"][:12],
             preds=toy_arrays["preds"][:12])
    out = tmp_path / "toy.gif"

    def frames():
        with Image.open(out) as im:
            return [np.asarray(f.convert("RGB"))
                    for f in ImageSequence.Iterator(im)]

    (jo, jf), (to, tf) = _run_both(
        ["animate", "--npz", npz, "--out", str(out), "--seed", "3",
         "--duration", "1"], capsys, frames)
    assert to == jo == f"wrote {out}\n"
    assert len(tf) == len(jf) > 1
    for a, b in zip(tf, jf):
        assert np.array_equal(a, b)


def test_torch_cli_plot_tracks_equals_jax(tmp_path, capsys):
    ann = tmp_path / "biwi.txt"
    rows = [f"{10 * (k + 1)} {aid} {0.1 * k + aid} 0 {0.2 * k} 0 0 0"
            for aid in (1, 2, 3) for k in range(6 if aid < 3 else 2)]
    ann.write_text("\n".join(rows) + "\n")
    out = tmp_path / "tracks.png"
    (jo, jp), (to, tp) = _run_both(
        ["plot-tracks", str(ann), "--parser", "biwi", "--out", str(out),
         "--min-len", "3"], capsys, _png(out))
    assert to == jo == f"wrote {out}: 2/3 tracks (min_len 3)\n"
    assert np.array_equal(tp, jp)


def _stats_runs(root, toy_npz):
    """Two dump trees (a and b) of two epochs each, JAX's
    test_stats_curve_plot's draws."""
    real = load_real_samples(toy_npz, group=6)
    rng = np.random.RandomState(0)
    for run in ("a", "b"):
        for epoch in (50, 100):
            preds_k = real[:20, :, 2:] + rng.randn(
                20, 6, real.shape[2] - 2, 2) * 0.05
            dump_predictions(str(root / run / str(epoch)), epoch, 0,
                             real[0, :, :2], preds_k, real[0, :, 2:],
                             real[0, :, 2:])
    return [str(root / r) for r in ("a", "b")]


def test_torch_cli_stats_plot_equals_jax(tmp_path, capsys, toy_npz):
    runs = _stats_runs(tmp_path, toy_npz)
    out = tmp_path / "curves.png"
    (jo, jp), (to, tp) = _run_both(
        ["stats", "--preds-dir", runs[0], "--real-npz", toy_npz,
         "--plot", str(out), "--extra-dirs", runs[1], "--labels",
         "variant-a", "variant-b", "--iters-per-epoch", "3"], capsys,
        _png(out))
    assert to == jo and f"wrote {out}\n" in to
    assert tp.shape == jp.shape and np.array_equal(tp, jp)


# ------------------------------------------------ JAX's own viz tests
def test_torch_toy_animation_saves_gif(tmp_path, toy_arrays):
    from socialways_torch.viz.animation import ToyAnimation
    samples = np.concatenate([toy_arrays["obsvs"][:12],
                              toy_arrays["preds"][:12]], axis=1)
    out = str(tmp_path / "toy.gif")
    ToyAnimation(samples, fps=5, duration_s=1, seed=0).save(out)
    assert os.path.getsize(out) > 1000


def test_torch_display_still_image_overlay(tmp_path):
    from socialways_torch.viz.video import Display, parse_annotations
    np.savetxt(str(tmp_path / "H.txt"), np.eye(3))
    cv2.imwrite(str(tmp_path / "reference.jpg"),
                np.full((100, 100, 3), 60, np.uint8))
    d = Display(str(tmp_path))
    assert d.grab_frame(0)
    d.plot_ped((50, 50), pid=1)
    d.plot_path(np.array([[10.0, 10.0], [20.0, 20.0]]), args="g--")
    d.add_orig_frame(0.5)
    out = str(tmp_path / "out.png")
    d.save(out)
    assert cv2.imread(out).std() > 0.5      # something was drawn
    ts, ids, pos = parse_annotations(_obsmat(tmp_path / "obsmat.txt"))
    assert ts.tolist() == [0, 10, 20]
    assert ids[0].tolist() == [1, 2] and ids[1].tolist() == [1, 3]
    np.testing.assert_allclose(pos[0][0], [5.0, 6.0])


def test_torch_fake_display_noop():
    from socialways_torch.viz.video import FakeDisplay
    d = FakeDisplay()
    assert d.grab_frame(0) is False
    d.plot_ped()
    d.plot_path([])
    d.show()


def test_torch_stats_curve_plot(tmp_path, toy_npz):
    from socialways_torch.viz.stats_plots import plot_stats_curves
    runs = _stats_runs(tmp_path, toy_npz)
    real = load_real_samples(toy_npz, group=6)
    for run in runs:
        calc_and_store_stats(run, real, num_samples=20, min_peds=3)
    out = plot_stats_curves(runs, str(tmp_path / "curves.png"),
                            labels=["variant-a", "variant-b"],
                            iters_per_epoch=3)
    assert os.path.exists(out) and os.path.getsize(out) > 10000


def test_torch_viz_render(tmp_path):
    obsvs, preds_our, preds = _scene(0)
    dump_predictions(str(tmp_path / "preds" / "5"), 5, 0, obsvs, preds_our,
                     preds, preds)
    out_dir = str(tmp_path / "figs")
    heatmap.render_preds_dir(str(tmp_path / "preds"), out_dir)
    assert os.listdir(out_dir) == ["00005.png"]
    im = cv2.imread(os.path.join(out_dir, "00005.png"))
    assert im.shape == (480, 480, 3) and im.std() > 1.0


def test_torch_cli_plot_tracks(tmp_path):
    ann = tmp_path / "biwi.txt"
    rows = [f"{10 * (k + 1)} {aid} {0.1 * k + aid} 0 {0.2 * k} 0 0 0"
            for aid in (1, 2, 3) for k in range(6)]
    ann.write_text("\n".join(rows) + "\n")
    out = tmp_path / "tracks.png"
    assert cli.main(["plot-tracks", str(ann), "--parser", "biwi", "--out",
                     str(out), "--min-len", "3"]) == 0
    assert out.exists() and out.stat().st_size > 0
