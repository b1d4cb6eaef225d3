"""A configuration, a traffic mix, limits and a per-layer metric added as
new files, and a cell added to a copy of ``BENCHMARK.json``, run with no
edit of the harness."""

import json
import os
import time

import pytest

from perfbench.harness import HERE, ROOT, load_json, run_cell

STEM = "zz_discovery_probe"


@pytest.fixture
def added_files(tmp_path, tiny):
    made = []

    def write(path, obj):
        with open(path, "w") as f:
            if isinstance(obj, str):
                f.write(obj)
            else:
                json.dump(obj, f)
        made.append(path)

    cfg = load_json(HERE, "configs", "socialways-crowd-bf16.json")
    cfg["train_config"]["compute_dtype"] = "float32"
    write(os.path.join(HERE, "configs", STEM + ".json"), cfg)
    mix = load_json(HERE, "traffic", "crowd-snapshots.json")
    mix.update(tiny["crowd-forecast"])
    write(os.path.join(HERE, "traffic", STEM + ".json"), mix)
    write(os.path.join(HERE, "limits", STEM + ".json"),
          {"traj_widest": 0.6, "traj_rms": 0.03})
    write(os.path.join(HERE, "metrics", STEM + ".py"),
          "def read(ctx):\n    return 1.0 + ctx.window.units\n")
    bench = load_json(ROOT, "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][1], name=STEM,
                                 file=f"perfbench/configs/{STEM}.json"))
    bench["workloads"].append({"name": STEM, "config": STEM,
                               "traffic": STEM, "chips": 1, "why": "probe"})
    for m in bench["end_to_end"]:
        if m["name"] == "forecast_agents_per_s":
            m["workloads"].append(STEM)
    bench["per_layer"].append({"name": STEM + ".x", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "probe",
                               "moves": "forecast_agents_per_s",
                               "workloads": [STEM]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    try:
        yield str(path)
    finally:
        for p in made:
            os.unlink(p)


def test_new_files_are_found_by_name(added_files, monkeypatch):
    import perfbench.harness as h
    monkeypatch.setattr(h, "traced_block",
                        lambda driver, log: (_FakeTrace(), True,
                                             *driver.traced()))
    r = run_cell(STEM, 11, 0.5, False, time.perf_counter(), device="cpu",
                 bench_path=added_files)
    assert r["correct"] and "forecast_agents_per_s" in r["metrics"]
    assert "forecast_p95_ms" not in r["metrics"]
    r = run_cell(STEM, 11, 0.5, True, time.perf_counter(), device="cpu",
                 bench_path=added_files)
    assert r["metrics"][STEM + ".x"]["value"] >= 2.0


class _FakeTrace:
    """A trace summary with the fields the result line reads (the CPU has
    no device trace)."""
    busy_s, window_s, by_name, gaps = 0.5, 1.0, {}, []

    def attn_seconds(self):
        return 0.0
