"""Tracing, the program's spans and counters, and step timing.

Counterpart of socialways_tpu/utils/profiling.py: ``trace`` captures a
``torch.profiler`` trace of a block (host activity and, where there is a
card, its kernels and copies) as a Chrome trace that TensorBoard and
Perfetto read, and the block's spans as ``spans.json`` beside it;
``StepTimer`` keeps per-step wall times with percentile summaries.

**Spans.**  ``span(name)`` marks a block of the program.  Tracing is on
exactly while a ``torch.profiler`` session records; otherwise a span is a
shared no-op after one flag check (no ``record_function``, no allocation,
no launch).  When on, a span opens a ``record_function(name)`` range, so
it shows in the profiler's trace on the clock of the device's kernels;
keeps a record (name, id, parent's id, unit's id, host start and end from
``time.perf_counter_ns``); and, on a CUDA device, launches a **device
stamp** at entry and exit: a one-thread kernel (``kernels/csrc/
trace_stamp.cu``) that writes a code and the device's ``%globaltimer``
into a ring of 65,536 slots in device memory.  The ring is read once,
after the block (one synchronize, one copy).

A *unit* is a span with ``unit=True`` (a training step, a simulated
window, a forecast request) opened where no unit is open; the spans
inside it share its id.  A unit declares its ``phases``: ``phase(name)``
ends the unit's current phase and starts ``name`` at one stamp, so the
phases are contiguous, the first starts at the unit's entry and the last
ends at its exit, and their device times add up to the unit's.  A
``phase`` call the innermost open span does not declare does nothing (the
generator's phases inside a training step).

**Graphs.**  A replay runs no host code, so a ``graphed`` unit (the
training step) launches its boundary stamps while a CUDA graph captures
it, whether tracing is on or off: 5 stamp nodes for 4 phases, which
write new slots at every replay.  ``captured_marks`` collects the phase
each captured stamp starts; a replay's host unit (``replay=`` those
marks) stamps its entry and exit eagerly, and the graph's stamps between
the two are its phases.  ``prepare_stamps`` loads the stamp kernel
without a launch, once a device; the graphed epoch calls it before a
capture and a simulation or forecast call on a card at its end, so that
a traced block does not load it.

**Sessions.**  A span that finds tracing on after one that found it off
starts a new session and drops the old one's records (``trace`` starts
one too).  The first stamp of a session synchronizes the device and
launches an anchor stamp, which puts ``%globaltimer`` on the host's
``perf_counter_ns`` clock.  Back-to-back profiler sessions with no span
between them are one session here: the aggregations take the last ``n``
units, the traced block's.  A stamp the ring no longer holds (more than
65,536 since) is a loss, and the device aggregations then return None.

**Counters.**  ``count(name)`` adds to ``counters`` (always on, a dict
update): ``graph.replays``, ``graph.captures`` and ``graph.eager_steps``
from ``engine/graphed.py``.  A unit records what its counters gained
while it was open.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()

#: the program's counters, by name (never reset)
counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    counters[name] = counters.get(name, 0) + n


@dataclasses.dataclass
class SpanRecord:
    """One span of a session.  ``d0``, ``d1``: the codes of its entry and
    exit stamps (None without a device stamp); a phase shares its
    boundaries' codes with its neighbours."""
    name: str
    id: int
    parent: Optional[int]
    unit: Optional[int]
    t0: int
    t1: int = 0
    d0: Optional[int] = None
    d1: Optional[int] = None
    is_unit: bool = False
    marks: Tuple = ()
    phases: List["SpanRecord"] = dataclasses.field(default_factory=list)
    counted: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Session:
    def __init__(self) -> None:
        self.records: List[SpanRecord] = []
        self.launched: Dict[int, int] = {}    # stamp code -> host ns at launch
        self.anchor: Optional[int] = None
        self.device: Optional[torch.device] = None
        self.view: Optional[Tuple[int, "_Ring"]] = None


_session: Optional[_Session] = None
_live = False                  # the last span found tracing on
_stack: List = []              # the open spans that record (or stamp a graph)
_ids = itertools.count(1)      # span ids and eager stamp codes
_marks: Optional[List] = None  # captured_marks' list, while one is open


# ------------------------------------------------------------------ stamps
_lib = None
_prepared = set()


def _stamps():
    """The stamp library (built by ``kernels/_build.py`` beside every
    kernel build, loaded at first use)."""
    global _lib
    if _lib is None:
        from socialways_torch.kernels._build import load
        lib = load("trace_stamp")
        lib.trace_stamp.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
        lib.trace_stamp.restype = ctypes.c_int
        lib.trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.trace_read.restype = ctypes.c_int
        for fn in (lib.trace_ring_size, lib.trace_prepare):
            fn.argtypes, fn.restype = [], ctypes.c_int
        _lib = lib
    return _lib


def _launch(code: int, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = _stamps().trace_stamp(
            code, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"trace stamp launch failed: CUDA error {err}")


def prepare_stamps(device: torch.device) -> None:
    """Load the stamp library and its kernel on ``device`` without a
    launch, once (nothing off a CUDA device): a capture that follows
    finds the kernel loaded, and a traced block does not load it."""
    if device.type == "cuda" and device not in _prepared:
        with torch.cuda.device(device):
            err = _stamps().trace_prepare()
        if err:
            raise RuntimeError(f"trace stamp load failed: CUDA error {err}")
        _prepared.add(device)


def _capturing(device) -> bool:
    return (getattr(device, "type", None) == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _stamp(session: _Session, device: torch.device) -> int:
    """An eager stamp's code, launched on ``device``'s current stream; the
    session's first synchronizes and anchors the clocks."""
    if session.anchor is None:
        torch.cuda.synchronize(device)
        session.device, session.anchor = device, next(_ids)
        session.launched[session.anchor] = time.perf_counter_ns()
        _launch(session.anchor, device)
    code = next(_ids)
    session.launched[code] = time.perf_counter_ns()
    _launch(code, device)
    return code


# ------------------------------------------------------------------- spans
class _Span:
    """A recording span (tracing on)."""

    def __init__(self, name, unit, phases, device, replay):
        self.name, self.unit, self.phases = name, unit, phases
        self.device = None if device is None else torch.device(device)
        self.replay = replay
        self.current: Optional[str] = None
        self.phase: Optional[SpanRecord] = None
        self.phase_rf = None

    def _stamped(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def __enter__(self):
        global _session, _live
        if not _live or _session is None:
            _session = _Session()
        _live = True
        self.session = s = _session
        outer = _stack[-1] if _stack else None
        unit = next((o.record.unit for o in reversed(_stack)
                     if isinstance(o, _Span) and o.record.unit), None)
        is_unit = self.unit and unit is None
        parent = None
        if isinstance(outer, _Span):
            parent = (outer.phase or outer.record).id
        rec = SpanRecord(self.name, next(_ids), parent, unit, 0,
                         is_unit=is_unit, marks=tuple(self.replay))
        if is_unit:
            rec.unit = rec.id
            self.c0 = dict(counters)
        else:
            self.phases = ()
        self.record = rec
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        rec.t0 = time.perf_counter_ns()
        if self._stamped():
            rec.d0 = _stamp(s, self.device)
        s.records.append(rec)
        _stack.append(self)
        return rec

    def boundary(self, name: str) -> None:
        """End the current phase and start ``name``, at one stamp."""
        rec, now = self.record, time.perf_counter_ns()
        code = rec.d0
        if self.phase is not None:
            code = _stamp(self.session, self.device) if self._stamped() \
                else None
            self.phase.t1, self.phase.d1 = now, code
            self.phase_rf.__exit__(None, None, None)
        else:
            now = rec.t0
        self.phase = SpanRecord(name, next(_ids), rec.id, rec.unit, now,
                                d0=code)
        rec.phases.append(self.phase)
        self.session.records.append(self.phase)
        self.phase_rf = torch.autograd.profiler.record_function(name)
        self.phase_rf.__enter__()

    def __exit__(self, *exc):
        rec = self.record
        rec.t1 = time.perf_counter_ns()
        if self._stamped():
            rec.d1 = _stamp(self.session, self.device)
        if self.phase is not None:
            self.phase.t1, self.phase.d1 = rec.t1, rec.d1
            self.phase_rf.__exit__(*exc)
        if rec.is_unit:
            rec.counted = {k: v - self.c0.get(k, 0)
                           for k, v in counters.items()
                           if v != self.c0.get(k, 0)}
        _stack.pop()
        self.rf.__exit__(*exc)
        return False


class _GraphUnit:
    """A graphed unit under capture: its boundaries as captured stamps,
    codes -1, -2, ... in order, and the phase each starts in the open
    ``captured_marks`` list (None: the unit's exit)."""

    def __init__(self, phases, device):
        self.phases, self.device = phases, device
        self.marks: List[Optional[str]] = []
        self.current: Optional[str] = None

    def _mark(self, name: Optional[str]) -> None:
        self.marks.append(name)
        _launch(-len(self.marks), self.device)

    def __enter__(self):
        _stamps()
        self._mark(None)
        _stack.append(self)

    def boundary(self, name: str) -> None:
        if self.current is None:
            self.marks[0] = name
        else:
            self._mark(name)

    def __exit__(self, *exc):
        _stack.pop()
        self._mark(None)
        if _marks is not None:
            _marks.extend(self.marks)
        return False


def span(name: str, unit: bool = False, phases: Sequence[str] = (),
         device=None, graphed: bool = False, replay: Sequence = ()):
    """A context for the block ``name`` (see the module's notes).
    ``unit``: a unit of work with ``phases``; ``device``: the CUDA device
    whose current stream takes the stamps (None: host only); ``graphed``:
    stamp the unit's boundaries inside a CUDA graph capture, tracing on or
    off; ``replay``: the marks of the graph this unit replays."""
    global _live
    if graphed and _capturing(device):
        return _GraphUnit(tuple(phases), torch.device(device))
    if not _enabled():
        _live = False
        return _NULL
    if _capturing(device):
        return _NULL
    return _Span(name, unit, tuple(phases), device, replay)


def phase(name: str) -> None:
    """Start phase ``name`` of the innermost open span, if it declares it
    and is not in it already."""
    if not _stack:
        return
    top = _stack[-1]
    if name in top.phases and name != top.current:
        top.boundary(name)
        top.current = name


@contextlib.contextmanager
def captured_marks():
    """Around a CUDA graph's capture: yields the list that receives the
    marks of the graphed units captured inside."""
    global _marks
    saved, _marks = _marks, []
    try:
        yield _marks
    finally:
        _marks = saved


# ----------------------------------------------------------- reading back
class _Ring:
    """The session's stamps as the ring holds them, in launch order."""

    def __init__(self, cursor: int, ring: np.ndarray):
        size = len(ring)
        slots = np.arange(min(cursor, size))
        seq = cursor - 1 - ((cursor - 1 - slots) % size)
        order = np.argsort(seq)
        self.codes = ring[slots[order], 0]
        self.ns = ring[slots[order], 1]
        eager = np.nonzero(self.codes > 0)[0]
        self.at = dict(zip(self.codes[eager].tolist(), eager.tolist()))

    def ns_of(self, code: Optional[int]) -> Optional[int]:
        i = self.at.get(code) if code is not None else None
        return None if i is None else int(self.ns[i])


def _ring(session: _Session) -> Optional[_Ring]:
    """The ring read back (once for each state of the session), or None
    when the session launched no stamp or the ring lost one of them."""
    if session is None or session.anchor is None:
        return None
    n = len(session.launched)
    if session.view is None or session.view[0] != n:
        lib, dev = _stamps(), session.device
        torch.cuda.synchronize(dev)
        size = lib.trace_ring_size()
        buf = np.zeros((size, 2), dtype=np.int64)
        cursor = ctypes.c_ulonglong(0)
        with torch.cuda.device(dev):
            err = lib.trace_read(ctypes.byref(cursor),
                                 buf.ctypes.data_as(ctypes.c_void_p))
        if err:
            raise RuntimeError(f"trace ring read failed: CUDA error {err}")
        view = _Ring(cursor.value, buf)
        if any(c not in view.at for c in session.launched):
            view = None
        session.view = (n, view)
    return session.view[1]


@dataclasses.dataclass
class Unit:
    """A unit of the session with its device times (ns, device clock):
    ``phases`` [(name, start, end)], or None where nothing was stamped."""
    record: SpanRecord
    start: Optional[int]
    end: Optional[int]
    phases: Optional[List[Tuple[str, int, int]]]
    stamps: List[int]            # the eager stamp codes of its boundaries


def _resolve(rec: SpanRecord, ring: Optional[_Ring]) -> Optional[Unit]:
    if ring is None or rec.d0 is None:
        return Unit(rec, None, None, None, [])
    if rec.marks:
        i0, i1 = ring.at[rec.d0], ring.at[rec.d1]
        codes = ring.codes[i0 + 1:i1]
        if list(codes) != [-(k + 1) for k in range(len(rec.marks))]:
            return None
        ns = [int(t) for t in ring.ns[i0 + 1:i1]]
        phases = [(rec.marks[k], ns[k], ns[k + 1])
                  for k in range(len(ns) - 1)]
        return Unit(rec, ns[0], ns[-1], phases, [rec.d0, rec.d1])
    phases = [(p.name, ring.ns_of(p.d0), ring.ns_of(p.d1))
              for p in rec.phases]
    stamps = [rec.d0] + [p.d1 for p in rec.phases[:-1]] + [rec.d1]
    return Unit(rec, ring.ns_of(rec.d0), ring.ns_of(rec.d1), phases, stamps)


def last_units(n: int, device: bool = True) -> Optional[List[Unit]]:
    """The session's last ``n`` units (all of one name), with their device
    times; None when there are fewer, names differ, or (``device``) their
    stamps are lost or missing."""
    s = _session
    if s is None or n <= 0:
        return None
    recs = [r for r in s.records if r.is_unit][-n:]
    if len(recs) < n or len({r.name for r in recs}) != 1:
        return None
    ring = _ring(s) if device else None
    units = [_resolve(r, ring) for r in recs]
    if device and any(u is None or u.start is None for u in units):
        return None
    return units


def phase_device_ms(name: str, n: int) -> Optional[float]:
    """Device ms a unit of phase ``name`` over the last ``n`` units (the
    sum of its stamped intervals over ``n``)."""
    units = last_units(n)
    if units is None or not any(p[0] == name for p in units[0].phases):
        return None
    return 1e-6 * sum(e - s for u in units for p, s, e in u.phases
                      if p == name) / n


def unit_host_ms(n: int) -> Optional[float]:
    """Median host ms of the last ``n`` units, from entry until the last
    launch inside returned."""
    units = last_units(n, device=False)
    return None if units is None else statistics.median(
        1e-6 * (u.record.t1 - u.record.t0) for u in units)


def host_lead_ms(n: int) -> Optional[float]:
    """Median, over the last ``n`` units' eager stamps, of how far the
    device ran each stamp behind the host's launch of it (ms), on one
    clock through the session's anchor stamp."""
    units = last_units(n)
    if units is None:
        return None
    s, ring = _session, _ring(_session)
    a_dev, a_host = ring.ns_of(s.anchor), s.launched[s.anchor]
    return statistics.median(
        1e-6 * ((ring.ns_of(c) - a_dev) - (s.launched[c] - a_host))
        for u in units for c in u.stamps)


def counted_share(name: str, n: int) -> Optional[float]:
    """Percent of the last ``n`` units during which counter ``name``
    gained."""
    units = last_units(n, device=False)
    return None if units is None else 100.0 * sum(
        u.record.counted.get(name, 0) for u in units) / n


def spans() -> List[Dict]:
    """The session's spans as JSON objects: host and (on the host's clock,
    through the anchor) device start and end in ns, and the phases of
    each replayed unit from its graph's stamps."""
    s = _session
    if s is None:
        return []
    ring = _ring(s)
    shift = None
    if ring is not None:
        shift = s.launched[s.anchor] - ring.ns_of(s.anchor)
    on_host = lambda t: None if t is None or shift is None else t + shift
    out = []
    for r in s.records:
        d0 = on_host(ring.ns_of(r.d0)) if ring is not None else None
        d1 = on_host(ring.ns_of(r.d1)) if ring is not None else None
        out.append({"name": r.name, "id": r.id, "parent": r.parent,
                    "unit": r.unit, "host_start_ns": r.t0,
                    "host_end_ns": r.t1, "device_start_ns": d0,
                    "device_end_ns": d1, "counted": r.counted})
        if r.marks and ring is not None:
            u = _resolve(r, ring)
            for name, a, b in (u.phases if u is not None else []):
                out.append({"name": name, "id": None, "parent": r.id,
                            "unit": r.id, "host_start_ns": None,
                            "host_end_ns": None,
                            "device_start_ns": on_host(a),
                            "device_end_ns": on_host(b), "counted": {}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``<host>_<pid>.<ns>.pt.trace.json`` and
    the block's spans, ``spans.json``, into ``log_dir``.  The device is
    synchronized before the trace stops, so every kernel the block queued
    is in it."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    global _live
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _live = False                   # the block's first span starts a session
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": spans(), "counters": counters,
                   "lost": _session is not None
                   and _session.anchor is not None
                   and _ring(_session) is None}, f)


class StepTimer:
    """Accumulates per-step wall times; reports mean/p50/p99.  The times
    are the host's: on a CUDA device a step returns once its work is
    queued, so they time the host's enqueue unless the step synchronizes."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0 = 0.0

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p99_s": float(np.percentile(t, 99)),
            "total_s": float(t.sum()),
        }
