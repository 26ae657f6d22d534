"""The kernel wrappers' launch counters, also under CUDA graphs.

Each wrapper keeps counters of its own (module globals such as
`launches`, set to 0 to reset) and adds to them through `add` where it
launches its kernel. A launch issued while the calling thread's stream
captures a CUDA graph runs nothing then, so it is not counted: inside
`recording()` it is noted instead, and `replayed(notes)` adds what one
replay of that graph launches (`generate/graph.py`). A counter therefore
counts the kernels that ran, whether a wrapper call or a replay launched
them. Wrappers call `add` on their CUDA branch only.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

import torch

Notes = Dict[Tuple[str, str], int]  # (module, counter) -> launches

_local = threading.local()  # .notes: the launches the thread's capture records


def add(module: str, **counts: int) -> None:
    """Add `counts` to the counters of `module` (a wrapper's `__name__`),
    or note them for the thread's `recording()` while its stream captures."""
    if torch.cuda.is_current_stream_capturing():
        notes = getattr(_local, "notes", None)
        if notes is not None:
            for name, n in counts.items():
                notes[(module, name)] = notes.get((module, name), 0) + n
        return
    mod = sys.modules[module]
    for name, n in counts.items():
        setattr(mod, name, getattr(mod, name) + n)


@contextmanager
def recording() -> Iterator[Notes]:
    """Note the launches the calling thread's captures record."""
    outer = getattr(_local, "notes", None)
    _local.notes = {}
    try:
        yield _local.notes
    finally:
        _local.notes = outer


def replayed(notes: Notes) -> None:
    """Count the launches of one replay of a graph whose capture noted `notes`."""
    for (module, name), n in notes.items():
        mod = sys.modules[module]
        setattr(mod, name, getattr(mod, name) + n)
