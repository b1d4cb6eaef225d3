"""``BENCHMARK.json`` against the form the benchmark promises, and every
file it names present."""

import json
import os
import re

import pytest

from perfbench.harness import HERE, ROOT, load_json, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return load_json(ROOT, "BENCHMARK.json")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])


def test_names_units_and_entries(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert os.path.isfile(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(HERE, "limits",
                                           w["name"] + ".json"))
        cells.add(w["name"])
    metrics = set()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metrics
        metrics.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert reader(m["name"]) is not None


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        n = w["name"]
        on = lambda m: n in m.get("workloads", [n])
        e2e = [m["name"] for m in bench["end_to_end"] if on(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(on(m) for m in bench["per_layer"])


def test_layers_named_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        stem = m["name"].split(".")[0]
        by_layer.setdefault(stem, set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_configs_state_what_was_cut(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert "train_config" in cfg and "assumed" in cfg
