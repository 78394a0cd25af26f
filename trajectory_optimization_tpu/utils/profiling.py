"""Profiling & metrics: step timers and jax.profiler integration.

Replaces the reference's ad-hoc ``time.time()`` debug prints scattered
through forward passes and loops (SURVEY.md §5: `src/model.py:100-120`,
`src/pose_optimization_sample.py:100-124`, ...). Provides:

  * :class:`StepTimer` — named span/step timing that waits for the device
    (``jax.block_until_ready``) and mean/percentile summaries;
  * :func:`trace` — context manager around ``jax.profiler`` for full XLA
    traces viewable in TensorBoard/XProf;
  * :class:`Metrics` — counter/gauge sink the nodes report into (the
    reference's equivalent is rospy.loginfo + rviz inspection).
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict

import numpy as np


def device_sync(x) -> None:
    """Wait until the device work producing ``x`` has finished."""
    import jax

    jax.block_until_ready(x)


class StepTimer:
    """Accumulates wall-time samples per named span."""

    def __init__(self):
        self._samples: Dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": len(a),
                "mean_ms": float(a.mean() * 1000),
                "p50_ms": float(np.percentile(a, 50) * 1000),
                "p99_ms": float(np.percentile(a, 99) * 1000),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:30s} n={s['count']:5d} mean={s['mean_ms']:8.3f}ms "
                f"p50={s['p50_ms']:8.3f}ms p99={s['p99_ms']:8.3f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/trajopt_trace"):
    """XLA profiler trace around a code block (open in TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class Metrics:
    """Minimal counters/gauges for node observability."""

    def __init__(self):
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.gauges: Dict[str, float] = {}

    def incr(self, name: str, by: float = 1.0) -> None:
        self.counters[name] += by

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def snapshot(self) -> Dict[str, float]:
        return {**self.counters, **self.gauges}
