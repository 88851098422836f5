"""Per-phase wall timing for the training loops.

A copy of ``PhaseTimer`` and ``profiling_phase`` from
``video_r2_tpu/utils/profiling.py`` (tests/test_torch_host.py holds them
equal to the originals' source). Every GRPO cycle reports its phases'
means as ``profiling/<phase>_s``. The JAX profiler hook ``profile_trace``
is not ported (ROADMAP Queue 1 #10); ``torch.profiler`` takes its place.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall time per named phase; `metrics()` emits
    profiling/<phase>_s means since the last flush."""

    def __init__(self):
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def metrics(self, flush: bool = True) -> dict[str, float]:
        out = {f"profiling/{k}_s": v / max(self._count[k], 1)
               for k, v in self._acc.items()}
        if flush:
            self._acc.clear()
            self._count.clear()
        return out


@contextlib.contextmanager
def profiling_phase(timer: "PhaseTimer | None", name: str):
    """No-op when timer is None (zero-cost opt-in)."""
    if timer is None:
        yield
    else:
        with timer.phase(name):
            yield
