"""Structured tracing and metrics.

The reference scatters `TicToc` stopwatches and ROS_DEBUG prints across
stages (SURVEY.md §5.1: `tic_toc.h`, per-stage chrono spans, FAST-LIO's
matlab log dumps) with no registry. Here one `Tracer` keeps the
reference's stage names (prepare / associate / solve / update /
compose) as named spans with wall-clock stats, and a `Metrics` registry
holds counters/gauges the pipeline publishes (loops found, PCM
rejections, optimizer cost, fitness values) — queryable and dumpable as
JSON. `jax.profiler` traces can be layered on for device-level detail.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    last_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Tracer:
    """Named wall-clock spans. Use `with tracer.span("associate"):` —
    nesting builds dotted paths (solve.rotation, solve.pose)."""

    def __init__(self) -> None:
        self.stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._stack: list[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        path = ".".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            s = self.stats[path]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)
            s.last_s = dt

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: dict(count=v.count, mean_ms=v.mean_s * 1e3, max_ms=v.max_s * 1e3,
                    total_s=v.total_s)
            for k, v in sorted(self.stats.items())
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


class Metrics:
    """Counters, gauges and histograms-lite (running min/max/mean)."""

    def __init__(self) -> None:
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self._agg: dict[str, list[float]] = defaultdict(list)

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def set(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self._agg[name].append(float(value))

    def report(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
        }
        out["observations"] = {
            k: dict(
                n=len(v), mean=sum(v) / len(v), min=min(v), max=max(v)
            )
            for k, v in self._agg.items() if v
        }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


# module-level defaults, importable anywhere
tracer = Tracer()
metrics = Metrics()
