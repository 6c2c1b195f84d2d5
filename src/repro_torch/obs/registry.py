"""Process-local metrics primitives: counters, gauges, rolling-window
histograms, and the single quantile codepath shared by every
p50/p95/p99 in the repo (a copy of ``repro/obs/registry.py``, which is
framework-free).

The quantile convention is the one ``serve.engine.latency_stats`` uses
(nearest-rank on the sorted sample,
``xs[min(int(p/100 * n), n - 1)]``): p50 of an odd-length sample is the
middle element — exactly the guards' rolling-median element
``xs[n // 2]`` — so delegating both callers here changes no numbers.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Sequence


def quantile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank quantile of an already **sorted** sample.

    ``p`` is in percent (50.0 = median).  Raises ``ValueError`` on an
    empty sample — callers decide what "no data" means (the engine
    reports zeros, the guards wait for warmup).
    """
    n = len(xs)
    if n == 0:
        raise ValueError("quantile of empty sample")
    if p <= 0.0:
        return float(xs[0])
    return float(xs[min(int(p / 100.0 * n), n - 1)])


@dataclass
class Counter:
    """Monotonic event count."""

    name: str
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


@dataclass
class Gauge:
    """Last-write-wins scalar."""

    name: str
    value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)


@dataclass
class Histogram:
    """Rolling-window sample with nearest-rank quantiles.

    ``window=None`` keeps every sample (the serve-latency use: bounded
    by request count); a finite window drops the oldest (the guards'
    rolling loss median).
    """

    name: str
    window: Optional[int] = None
    _xs: Deque[float] = field(default_factory=deque, repr=False)

    def __post_init__(self) -> None:
        if self.window is not None:
            self._xs = deque(self._xs, maxlen=self.window)

    def add(self, value: float) -> None:
        self._xs.append(float(value))

    def reset(self) -> None:
        self._xs.clear()

    def __len__(self) -> int:
        return len(self._xs)

    @property
    def count(self) -> int:
        return len(self._xs)

    def sorted_values(self):
        return sorted(self._xs)

    def quantile(self, p: float) -> float:
        return quantile(self.sorted_values(), p)

    def median(self) -> float:
        return self.quantile(50.0)

    def mad(self) -> float:
        """Median absolute deviation (same element convention as
        :meth:`median`); the guards' spike detector scales this by
        1.4826 into a robust sigma."""
        med = self.median()
        return quantile(sorted(abs(x - med) for x in self._xs), 50.0)

    def summary(self) -> Dict[str, float]:
        """``{count, min, max, mean, p50, p95, p99}`` (zeros when
        empty, so rollup emitters never have to special-case)."""
        xs = self.sorted_values()
        n = len(xs)
        if n == 0:
            return {"count": 0, "min": 0.0, "max": 0.0, "mean": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": n,
            "min": xs[0],
            "max": xs[-1],
            "mean": sum(xs) / n,
            "p50": quantile(xs, 50.0),
            "p95": quantile(xs, 95.0),
            "p99": quantile(xs, 99.0),
        }


class Registry:
    """Named metric instruments, created on first touch.

    One instance per subsystem (trainer, engine) — or use the module
    default via :func:`default_registry`.  ``snapshot()`` flattens
    everything into one JSON-ready dict for periodic rollup events.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, window: Optional[int] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, window=window)
        return h

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            if g.value is not None:
                out[name] = g.value
        for name, h in self._histograms.items():
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out


_DEFAULT: Optional[Registry] = None


def default_registry() -> Registry:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Registry()
    return _DEFAULT
