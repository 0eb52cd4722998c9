"""Per-stage timing and device profiling.

The reference's only instrumentation is the L-BFGS progress callback printing
``fx, xnorm, gnorm, step`` per iteration under ``--verbose``
(``pydca/plmdca/plmdcaBackend.cpp:130-146``).  This module adds the
observability layer SURVEY.md section 5 specifies for the new framework:
wall-clock stage timers with a run summary (iterations/s, sequences/s), and
an optional ``jax.profiler`` trace context for a device timeline.

Usage::

    timers = StageTimers()
    with timers.stage("weights"):
        w = jax.block_until_ready(stats.sequence_weights(...))
    logger.info("%s", timers.summary())

    with device_trace("/tmp/dca-trace"):   # no-op when the dir is falsy
        fit_plm(...)
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = ["StageTimers", "device_trace"]


class StageTimers:
    """Ordered wall-clock timers keyed by stage name.

    Re-entering a stage accumulates (so per-chunk optimizer calls sum into
    one row).  ``rates`` attaches work counts to stages, and ``summary``
    renders one line per stage with the derived rate.
    """

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}
        self._order: List[str] = []
        self._counts: Dict[str, Tuple[float, str]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self._elapsed:
                self._order.append(name)
                self._elapsed[name] = 0.0
            self._elapsed[name] += dt

    def add_rate(self, name: str, count: float, unit: str) -> None:
        """Attach a work count to a stage, e.g. ``add_rate("fit", 100, "iters")``."""
        self._counts[name] = (count, unit)

    def elapsed(self, name: str) -> float:
        return self._elapsed.get(name, 0.0)

    @property
    def total(self) -> float:
        return sum(self._elapsed.values())

    def summary(self) -> str:
        if not self._order:
            return "no stages timed"
        width = max(len(n) for n in self._order)
        lines = []
        for name in self._order:
            dt = self._elapsed[name]
            line = f"{name:<{width}}  {dt:9.3f}s"
            if name in self._counts and dt > 0:
                count, unit = self._counts[name]
                line += f"  ({count / dt:,.1f} {unit}/s)"
            lines.append(line)
        lines.append(f"{'total':<{width}}  {self.total:9.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``jax.profiler.trace`` context; a no-op when ``log_dir`` is falsy.

    A trace that was asked for and cannot start raises.
    """
    if not log_dir:
        yield
        return
    import jax.profiler

    with jax.profiler.trace(log_dir):
        yield
