"""Device profiling on `torch.profiler`: the port's counterpart of the
JAX package's `utils/profiling.py`. Usage:

    with device_trace("traces/") as trace:
        with annotate("decode"):           # a named region in the trace
            engine.decode_step(state, sampling)
    trace.path                              # the Chrome trace file written
    trace.prof.key_averages()               # the recorded events

On a card the trace holds the CUDA kernels (CUPTI) beside the host's
events; on the CPU it holds the host's events only.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

import torch


class Trace:
    """What `device_trace` recorded: the profiler, whose events callers
    read, and the trace file, set once the block has ended."""

    def __init__(self, prof) -> None:
        self.prof = prof
        self.path: Optional[Path] = None


@contextmanager
def device_trace(log_dir: str | Path):
    """Profile the enclosed block (CPU, and CUDA where a card is present)
    and write its Chrome trace under log_dir, also when the block raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    trace = None
    try:
        with profile(activities=activities, acc_events=True) as prof:
            trace = Trace(prof)
            yield trace
    finally:
        if trace is not None:
            path = log_dir / f"trace.{os.getpid()}.{time.time_ns()}.json"
            trace.prof.export_chrome_trace(str(path))
            trace.path = path


@contextmanager
def annotate(name: str):
    """A named region inside an active trace."""
    with torch.profiler.record_function(name):
        yield


def memory_stats() -> Dict[str, Optional[dict]]:
    """Per-device memory statistics: `torch.cuda.memory_stats` for each
    card (bytes; the peak allocated under "allocated_bytes.all.peak"), and
    None for the CPU, which keeps none, as the JAX version gives None for
    a device without them."""
    out: Dict[str, Optional[dict]] = {"cpu": None}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = torch.cuda.memory_stats(i)
    return out
