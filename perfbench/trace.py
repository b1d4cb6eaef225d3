"""Reading torch.profiler's trace of a window: the device's busy time as the
union of its kernel, copy and set intervals, the device time by operation,
the idle gaps named by what the host was doing, and the attention
kernels' records against the launches the program counted.

The traced block is wrapped in ``record_function(WINDOW)``; that host
span is the window, and device intervals are clipped to it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "perfbench.traced"
#: the attention kernels by launch: a forward launch runs the u prologue
#: and the forward kernel, a dkv launch the dkv and finalize kernels
ATTN_KERNELS = {"fwd": ("u_prep_kernel", "social_attention_fwd_kernel"),
                "dkv": ("bwd_dkv_kernel", "bwd_finalize_kernel"),
                "dq": ("bwd_dq_kernel",)}
#: the kernel whose records count a launch (one record a launch), and the
#: program's wrapper whose counters count it
LAUNCH_RECORD = {"fwd": "social_attention_fwd_kernel",
                 "dkv": "bwd_dkv_kernel", "dq": "bwd_dq_kernel"}
LAUNCH_WRAPPER = {"fwd": "social_attention_fwd",
                  "dkv": "social_attention_bwd_dkv",
                  "dq": "social_attention_bwd_dq"}


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_name: Dict[str, float]           # seconds of device time by op
    gaps: List[Tuple[str, float]]       # idle seconds by host activity
    attn_records: Dict[str, int]        # launches seen, by kernel

    def attn_seconds(self) -> float:
        names = {n for ks in ATTN_KERNELS.values() for n in ks}
        return sum(s for k, s in self.by_name.items() if k in names)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments,
    parameters and namespaces."""
    full = name
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    name = "".join(out).split("(")[0].strip()
    return (name.split("::")[-1] or full)[:96]


def union_seconds(intervals: np.ndarray) -> Tuple[float, np.ndarray]:
    """(total covered, the merged intervals) of [n, 2] microsecond
    intervals."""
    if not len(intervals):
        return 0.0, intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.asarray(merged)
    return float(np.sum(m[:, 1] - m[:, 0])) * 1e-6, m


def summarize(prof, gaps_to_name: int = 400) -> TraceSummary:
    """The summary of a profile whose block ran under ``WINDOW``."""
    events = prof.events()
    window = [e for e in events if e.name == WINDOW]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w0 = min(e.time_range.start for e in window)
    w1 = max(e.time_range.end for e in window)
    dev, host = [], []
    for e in events:
        if e.name == WINDOW or getattr(e, "is_user_annotation", False):
            continue                 # spans, also where mirrored on the device
        kind = e.device_type.name
        if kind == "CUDA":
            dev.append(e)
        elif kind == "CPU":
            host.append(e)
    iv = np.asarray([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                     for e in dev], dtype=np.float64).reshape(-1, 2)
    iv = iv[iv[:, 1] > iv[:, 0]]
    busy_s, merged = union_seconds(iv)
    by_name: Dict[str, float] = {}
    records: Dict[str, int] = {k: 0 for k in LAUNCH_RECORD}
    for e in dev:
        name = short_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) * 1e-6
        for k, rec in LAUNCH_RECORD.items():
            if name == rec:
                records[k] += 1
    edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
    gap_len = edges[:, 1] - edges[:, 0]
    order = np.argsort(-gap_len)[:gaps_to_name]
    h_start = np.asarray([e.time_range.start for e in host], np.float64)
    h_end = np.asarray([e.time_range.end for e in host], np.float64)
    h_names = [e.name for e in host]
    gaps: Dict[str, float] = {}
    named = 0.0
    for i in order:
        if gap_len[i] <= 0:
            break
        mid = 0.5 * (edges[i, 0] + edges[i, 1])
        inside = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        label = ("no host op" if not len(inside) else
                 h_names[inside[np.argmin(h_end[inside] - h_start[inside])]])
        gaps[label] = gaps.get(label, 0.0) + gap_len[i] * 1e-6
        named += gap_len[i] * 1e-6
    rest = float(np.sum(gap_len[gap_len > 0])) * 1e-6 - named
    if rest > 0:
        gaps["shorter gaps"] = rest
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        by_name=by_name, gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
        attn_records=records)


def top(items: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(items.items(),
                                      key=lambda kv: -kv[1])[:n]]
