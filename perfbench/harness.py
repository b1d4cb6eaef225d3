"""One run of one cell: everything the harness finds by name, the window,
the traced block, the check and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files:
``perfbench/configs/<config>.json`` (the model as it is run),
``perfbench/traffic/<traffic>.json`` (the mix: a ``driver`` name and its
parameters), ``perfbench/limits/<workload>.json`` (the limits of the
numbers the check compares) and, for every per-layer metric the cell
reports, a reader ``perfbench/metrics/<name>.py`` or, failing that,
``perfbench/metrics/<name up to its first dot>.py``.  The driver is
``perfbench/drivers/<driver>.py``.  Adding a cell, a mix or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from perfbench import trace as tr

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules that must not be loaded in a run's process (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "socialways_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[str] = None,
              overrides: Optional[Dict] = None) -> Cell:
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", spec["config"] + ".json")
    mix = load_json(HERE, "traffic", spec["traffic"] + ".json")
    mix.update(overrides or {})
    return Cell(name, config, mix,
                load_json(HERE, "limits", name + ".json"),
                [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader module of a per-layer metric: its own file, or the file
    of the name up to its first dot."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.isfile(path):
            return _load_file(path, "perfbench_metric_" + stem.replace(
                ".", "_"))
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} "
                            f"under perfbench/metrics/")


def driver_class(mix: Dict):
    return importlib.import_module(f"perfbench.drivers.{mix['driver']}").Driver


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    window: object                  # drivers.Window
    peak_flops: float
    trace: Optional[tr.TraceSummary] = None
    trace_whole: bool = False
    traced_units: int = 0
    traced_bound_s: float = 0.0


#: traces of a block before its idle and device-time metrics are left out
TRACE_ATTEMPTS = 4


def traced_block(driver, log) -> tuple:
    """Trace the driver's block; while the trace names other attention
    launches than the program counted (the profiler drops records of
    replayed graphs now and then), trace it again.  Returns (summary,
    whole, units, bound seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from socialways_torch.kernels import social_attention as sa
    for attempt in range(TRACE_ATTEMPTS):
        before = sa.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(tr.WINDOW):
                units, bound_s = driver.traced()
        after = sa.launch_counts()
        counted = {k: sum(after[(w, c)] - before[(w, c)]
                          for (w, c) in after
                          if w.__name__ == tr.LAUNCH_WRAPPER[k]
                          and c in ("launches", "launches_bf16"))
                   for k in tr.LAUNCH_RECORD}
        summary = tr.summarize(prof)
        whole = summary.attn_records == counted
        if whole:
            return summary, True, units, bound_s
        log(f"trace {attempt + 1}: the trace names attention launches "
            f"{summary.attn_records}, the program counted {counted}")
    log(f"the trace lost device records {TRACE_ATTEMPTS} times: idle share, "
        "device times and the attention roofline are left out")
    return summary, False, units, bound_s


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[Dict] = None,
             bench_path: Optional[str] = None) -> Dict:
    """Run ``name`` once; returns the result line's object."""
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    cell = load_cell(name, bench_path, overrides)
    dev = torch.device(device)
    driver = driver_class(cell.mix)(cell.config, cell.mix, seed, dev)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = driver.window(seconds)
    ctx = Context(win, _peak(cell.config))
    if trace:
        (ctx.trace, ctx.trace_whole, ctx.traced_units,
         ctx.traced_bound_s) = traced_block(driver, log)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = dict(win.values, setup_s=setup_s)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    checks = driver.check(cell.limits)
    for c in checks:
        if c.note:
            log(f"check {c.name}: {c.note}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks),
              "attempted": win.units, "failed": 0, "metrics": metrics,
              "device": device_info}
    if dev.type == "cuda":
        device_info["power"] = power_limit()
    if trace:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": tr.top(ctx.trace.by_name),
                               "idle_gaps": [list(g) for g in
                                             ctx.trace.gaps[:10]]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    log(f"setup_s {setup_s:.3f}; window {win.seconds:.3f} s, "
        f"{win.units} {driver.unit}s")
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r}"
            + ("" if c.ok else " FAILED"))
    return result


def _peak(config: Dict) -> float:
    from perfbench.flops import PEAK_FLOPS
    return PEAK_FLOPS[config["train_config"].get("compute_dtype", "float32")]
