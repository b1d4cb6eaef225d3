"""The launch counters of the hand-written kernels' wrappers.

A wrapper counts its launches in attributes of its own (the attention
wrappers ``launches``, ``launches_bf16`` and their member counts; the
fused decode ``launches``) and registers them here.  A count is taken
when the wrapper is called, so a CUDA graph's capture would count launches
that never ran and its replays none: ``captured_launches`` takes a
capture's counts back out and records them, and ``credit_launches`` adds
them once a replay (engine/graphed.py), so the counters keep meaning
launches on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

#: a record of launches: (wrapper, counter) -> launches
Launches = Dict[Tuple[object, str], int]
_REGISTERED: List[Tuple[object, str]] = []


def register(wrapper, *counters: str) -> None:
    """Start ``wrapper``'s ``counters`` at 0 and keep them in the
    records."""
    for counter in counters:
        setattr(wrapper, counter, 0)
        _REGISTERED.append((wrapper, counter))


def launch_counts() -> Launches:
    """Every registered counter, as it stands."""
    return {(w, c): getattr(w, c) for w, c in _REGISTERED}


@contextlib.contextmanager
def captured_launches() -> Iterator[Launches]:
    """Around a CUDA graph's capture: yields a record that, when the block
    ends, holds the launches counted inside it, and takes them back out of
    the counters (a capture launches nothing)."""
    before, record = launch_counts(), {}
    try:
        yield record
    finally:
        for key, n in before.items():
            wrapper, counter = key
            if getattr(wrapper, counter) != n:
                record[key] = getattr(wrapper, counter) - n
                setattr(wrapper, counter, n)


def credit_launches(record: Launches, times: int = 1) -> None:
    """Count ``record``'s launches ``times`` more times: once for each
    replay of the graph whose capture recorded them."""
    for (wrapper, counter), n in record.items():
        setattr(wrapper, counter, getattr(wrapper, counter) + n * times)
