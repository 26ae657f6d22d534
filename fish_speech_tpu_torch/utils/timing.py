"""Structured per-phase wall-clock timing: the port's copy of the JAX
package's `utils/timing.py` (it has no JAX). On the card, time spans
that end in `torch.cuda.synchronize()`: a CUDA call returns before the
work is done."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Tuple


class Timer:
    """Collects named wall-clock spans; cheap enough for per-request use."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, float]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, time.perf_counter() - t0))

    def total(self, name: str) -> float:
        return sum(dt for n, dt in self.spans if n == name)

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.spans:
            out[name] = out.get(name, 0.0) + dt
        return out
