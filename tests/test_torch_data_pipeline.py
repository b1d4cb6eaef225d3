"""The port's raw-annotation data path against socialways_tpu: the parsers
(what JAX's default ``load()`` gives, its C++ table semantics included),
``create_dataset`` windowing, ``forecast_windows``, the toy generator, and
the ``create-dataset`` / ``create-toy`` CLI files.  Everything here is
numpy on both sides, so equality is bit for bit."""

import os

import numpy as np
import pytest

from socialways_tpu.cli.main import main as jax_cli
from socialways_tpu.data import forecast as jforecast
from socialways_tpu.data import parsers as jparsers
from socialways_tpu.data import toy as jtoy
from socialways_tpu.data import windowing as jwindowing
from socialways_tpu.native.loader import get_lib
from socialways_torch.cli.main import main as torch_cli
from socialways_torch.data import forecast, parsers, toy, windowing


def obsmat_rows(seed, n_agents=12, interval=10, max_len=30):
    """BIWI rows (ts id px pz py vx vz vy) of seeded random walks, sorted
    by (ts, id) as obsmat files are."""
    rng = np.random.RandomState(seed)
    rows = []
    for aid in range(1, n_agents + 1):
        t0 = int(rng.randint(0, 20)) * interval
        n = int(rng.randint(5, max_len))
        pos = np.cumsum(rng.randn(n, 2) * 0.3, 0) + rng.uniform(0, 10, 2)
        vel = rng.randn(n, 2)
        rows += [(t0 + k * interval, aid, pos[k, 0], 0.0, pos[k, 1],
                  vel[k, 0], 0.0, vel[k, 1]) for k in range(n)]
    rows.sort(key=lambda r: (r[0], r[1]))
    return rows


def write_rows(path, rows, sep=" ", extra=()):
    """``rows`` as text; ``extra`` lines (index, text) inserted."""
    lines = [sep.join(f"{v:.6f}" for v in r) for r in rows]
    for i, text in extra:
        lines.insert(i, text)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


# the public layout of tests/test_ethucy_protocol.py:98-118; the zara files
# are space-separated although their names set BIWI's tab delimiter
ETHUCY_LAYOUT = {
    "eth": "ewap_dataset/seq_eth/obsmat.txt",
    "hotel": "ewap_dataset/seq_hotel/obsmat.txt",
    "univ": "crowds/students003/obsmat.txt",
    "zara1": "crowds/zara01/obsmat.txt",
    "zara2": "obsmat_zara2.txt",
}


def write_ethucy_layout(root, n_agents=30, seed=1):
    """The five scenes of ETHUCY_LAYOUT as seeded obsmat files under
    ``root``, plus an obsmat under the 'ethucy' umbrella directory (no
    scene) and a decoy that fails validation."""
    rels = list(ETHUCY_LAYOUT.values()) + ["ethucy/obsmat.txt"]
    for i, rel in enumerate(rels):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        write_rows(os.path.join(root, rel),
                   obsmat_rows(seed + i, n_agents, max_len=40))
    with open(os.path.join(root, "notes_obsmat.txt"), "w") as fh:
        fh.write("1 2 3\n4 5 6\n")
    return str(root)


def assert_same_parse(a, b):
    for field in ("p_data", "v_data", "t_data"):
        xs, ys = getattr(a, field), getattr(b, field)
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
    assert (a.interval, a.min_t, a.max_t) == (b.interval, b.min_t, b.max_t)
    assert a.all_ids == b.all_ids
    assert a.scale.to_dict() == b.scale.to_dict()


def _need_native():
    if get_lib() is None:
        pytest.skip("the JAX package's native table parser did not build")


def _biwi_tab_zara(tmp_path):
    return write_rows(tmp_path / "obsmat_zara1.txt", obsmat_rows(1), "\t")


def _biwi_junk_ragged(tmp_path):
    _need_native()        # JAX's line loop raises on the junk row
    rows = obsmat_rows(2)
    return write_rows(tmp_path / "obsmat_eth.txt", rows, extra=[
        (5, "frame id x z y vx vz vy"),
        (9, " ".join(["1.0"] * 7)),
        (14, "20.0 3.0 1.5abc 0 1 0 0 0")])


def _trajnet_glob(tmp_path):
    d = tmp_path / "trajnet"
    os.makedirs(d)
    for i, seed in enumerate((3, 4)):
        rows = [(r[0], r[1] + 10 * i, r[2], r[4]) for r in
                obsmat_rows(seed, n_agents=6, interval=6)]
        write_rows(d / f"part{i}.txt", rows)
    write_rows(d / "notes.csv", [(1, 2, 3, 4)])
    return str(d) + "/*.txt"


def _sdd(tmp_path):
    rng = np.random.RandomState(5)
    lines = []
    for aid in range(4):
        x, y = rng.randint(0, 900, 2)
        for ts in range(0, 120, 3):
            x, y = x + rng.randint(-3, 4), y + rng.randint(-3, 4)
            lines.append(f"{aid} {x} {y} {x + 31} {y + 47} {ts} 0 0 0 "
                         f'"Pedestrian"')
    path = tmp_path / "annotations.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _seyfried(tmp_path):
    rng = np.random.RandomState(6)
    lines = ["2", "10.0 20.0 30.0 40.0", "50.0 60.0 70.0 80.0", "16"]
    for aid in ("1", "2", "p7"):
        x, y = rng.uniform(0, 500, 2)
        for ts in range(3, 60):
            x, y = x + rng.randn() * 5, y + rng.randn() * 5
            lines.append(f"{aid} {ts} {x:.2f} {y:.2f} 170.0")
    path = tmp_path / "seyfried.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


PARSE_CASES = {
    "biwi tab-delimited zara": ("BIWIParser", _biwi_tab_zara),
    "biwi junk and ragged rows": ("BIWIParser", _biwi_junk_ragged),
    "trajnet glob": ("TrajnetParser", _trajnet_glob),
    "sdd default down-sampling": ("SDDParser", _sdd),
    "seyfried": ("SeyfriedParser", _seyfried),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_torch_parsers_equal_jax_default_load(case, tmp_path):
    cls, make = PARSE_CASES[case]
    path = make(tmp_path)
    want, got = getattr(jparsers, cls)(), getattr(parsers, cls)()
    want.load(path)
    got.load(path)
    assert len(got.p_data) > 1
    assert_same_parse(want, got)


def test_torch_biwi_reads_a_space_separated_zara_file(tmp_path):
    """The BIWI 'zara' rule sets a tab delimiter; the JAX package's native
    table parser still splits on spaces (its default ``load()``), its line
    loop does not.  The port gives the native result."""
    _need_native()
    path = write_rows(tmp_path / "obsmat_zara2.txt", obsmat_rows(7))
    want = jparsers.BIWIParser().load(path, native=True)
    got = parsers.BIWIParser().load(path)
    assert len(got.p_data) == 12 and got.interval == 10
    assert_same_parse(want, got)
    assert jparsers.BIWIParser().load(path, native=False).p_data == []


def test_torch_table_rows_read_tokens_as_strtod(tmp_path):
    """The rows the table parser keeps: any run of space, tab, CR and LF
    delimits; a header, a row with a junk token and a row of another width
    than the first data row are skipped."""
    path = tmp_path / "t.txt"
    path.write_text("# header\n1 2\t3\r\n4 5\n6 1.5abc 8\n \t7  8 9 \n")
    np.testing.assert_array_equal(parsers._parse_table(str(path)),
                                  [[1, 2, 3], [7, 8, 9]])


def _gap_agent_scene():
    """Agent 0 with a gap of 15.5 intervals (no window spans it), agent 1
    whole; interval 10."""
    rng = np.random.RandomState(8)
    t0 = np.concatenate([np.arange(0, 300, 10), np.arange(455, 800, 10)])
    t1 = np.arange(100, 600, 10)
    return ([rng.randn(len(t0), 2), rng.randn(len(t1), 2)],
            [t0.astype(np.int32), t1.astype(np.int32)])


def _parsed(seed, interval, max_len=30):
    def make(tmp_path):
        path = write_rows(tmp_path / "obsmat_eth.txt",
                          obsmat_rows(seed, 25, interval, max_len))
        p = parsers.BIWIParser().load(path)
        return p.p_data, p.t_data
    return make


WINDOW_CASES = {
    "obsmat interval 10": (_parsed(9, 10), 10, 1),
    "obsmat interval 10, half-open range": (_parsed(9, 10), 10, 0),
    "interval 1 (anchor + 1 dropped)": (_parsed(10, 1), 1, 1),
    "an agent with a gap": (lambda _: _gap_agent_scene(), 10, 1),
    "no window": (_parsed(11, 10, max_len=19), 10, 1),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_torch_create_dataset_equals_jax(case, tmp_path):
    make, interval, closed = WINDOW_CASES[case]
    p_data, t_data = make(tmp_path)
    t_all = np.concatenate(t_data)
    t_range = range(int(t_all.min()), int(t_all.max()) + closed, interval)
    want = jwindowing.create_dataset(p_data, t_data, t_range, 8, 12)
    got = windowing.create_dataset(p_data, t_data, t_range, 8, 12)
    for w, g, name in zip(want, got, ("obsvs", "preds", "times", "batches")):
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype and w.shape == g.shape, name
        np.testing.assert_array_equal(w, g, err_msg=name)
    if case == "no window":
        assert got[0].shape == (0, 8, 2)
    else:
        assert len(got[3]) > 1


def test_torch_forecast_windows_equal_jax(tmp_path):
    path = write_rows(tmp_path / "obsmat_hotel.txt", obsmat_rows(12, 25))
    p = parsers.BIWIParser().load(path)
    for kw in ({}, {"at_time": 150}, {"interval": 10, "at_time": 200},
               {"n_past": 4}):
        kw = dict({"n_past": 8}, **kw)
        want = jforecast.forecast_windows(p.p_data, p.t_data, **kw)
        got = forecast.forecast_windows(p.p_data, p.t_data, **kw)
        for w, g in zip(want, got):
            assert np.asarray(w).dtype == np.asarray(g).dtype
            np.testing.assert_array_equal(w, g)
    for mod in (jforecast, forecast):
        with pytest.raises(ValueError, match="nothing to forecast"):
            mod.forecast_windows(p.p_data, p.t_data, n_past=40)


def test_torch_toy_equals_jax(tmp_path):
    for kw in ({}, {"n_samples": 48, "n_conditions": 4, "n_modes": 2,
                    "n_per_batch": 2, "seed": 5}):
        want, got = jtoy.make_toy_npz_arrays(**kw), toy.make_toy_npz_arrays(**kw)
        assert sorted(want) == sorted(got)
        for key in want:
            assert want[key].dtype == got[key].dtype
            np.testing.assert_array_equal(want[key], got[key], err_msg=key)
    ws, wt = jtoy.create_toy_samples(36, 6, 3, 6, np.random.RandomState(1))
    gs, gt = toy.create_toy_samples(36, 6, 3, 6, np.random.RandomState(1))
    np.testing.assert_array_equal(ws, gs)
    np.testing.assert_array_equal(np.asarray(wt), np.asarray(gt))
    jtoy.write_toy_txt(ws, wt, str(tmp_path / "j.txt"))
    toy.write_toy_txt(gs, gt, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()


def _assert_same_npz(a, b):
    with np.load(a) as da, np.load(b) as db:
        assert sorted(da.files) == sorted(db.files)
        for key in da.files:
            assert da[key].dtype == db[key].dtype, key
            np.testing.assert_array_equal(da[key], db[key], err_msg=key)


@pytest.mark.parametrize("extra", [[], ["--parser", "trajnet", "--n-past",
                                        "4", "--n-next", "6"]])
def test_torch_cli_create_dataset_writes_what_jax_writes(extra, tmp_path,
                                                         capsys):
    if extra:
        src = _trajnet_glob(tmp_path)
    else:
        src = write_rows(tmp_path / "obsmat_univ.txt", obsmat_rows(13, 30))
    out_j, out_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jax_cli(["create-dataset", src, out_j] + extra) == 0
    want = capsys.readouterr().out.replace(out_j, "OUT")
    assert torch_cli(["create-dataset", src, out_t] + extra) == 0
    assert capsys.readouterr().out.replace(out_t, "OUT") == want
    _assert_same_npz(out_j, out_t)
    assert np.load(out_t)["obsvs"].shape[0] > 0


def test_torch_cli_create_toy_writes_what_jax_writes(tmp_path, capsys):
    args = ["--n_samples", "72", "--n_modes", "2", "--seed", "4"]
    paths = {}
    for name, cli in (("j", jax_cli), ("t", torch_cli)):
        paths[name] = (str(tmp_path / f"{name}.npz"),
                       str(tmp_path / f"{name}.txt"))
        assert cli(["create-toy", "--npz", paths[name][0], "--txt",
                    paths[name][1]] + args) == 0
        out = capsys.readouterr().out
        for p in paths[name]:
            out = out.replace(p, "OUT")
        paths[name] += (out,)
    assert paths["j"][2] == paths["t"][2]
    _assert_same_npz(paths["j"][0], paths["t"][0])
    with open(paths["j"][1]) as fj, open(paths["t"][1]) as ft:
        assert fj.read() == ft.read()
