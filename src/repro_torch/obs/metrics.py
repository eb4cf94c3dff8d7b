"""Unified metrics registry: thread-safe counters, gauges and histograms
(port of the JAX package's ``obs/metrics.py``; it imports nothing of the
port at import time, so every module may import it without cycles).

One process-wide :class:`MetricsRegistry` (:func:`registry`) holds the
port's telemetry:

* plan-cache hit/miss counters (``core.partitioner.PlanCacheStats``): every
  ``record_hit``/``record_miss`` of a scoped cache also lands in
  ``plan_cache.<scope>.{hits,misses}`` here (scopes "process" and "runner");
* the lattice-search counters (``core.collective_planner.search_telemetry``),
  the verifier's (``core.plan_verify.verify_telemetry``) and the process plan
  cache's (``core.partitioner.process_plan_cache_stats``), joined into every
  :func:`snapshot` as read-only *sources* (their modules stay the owners);
* the train loop's ``train.step_ms`` / ``train.tokens_per_s`` histograms and
  ``train.guard.{faults,skips}`` counters (``train/loop.py``), and the
  profile fit's gauges (``obs/profile.py``).

Histograms keep raw samples (bounded at :data:`MAX_SAMPLES`, then thinned
2:1) so percentiles are exact for the short-lived processes this repo runs;
``summary()`` reports count / sum / min / max / mean / p50 / p90 / p99.

:func:`snapshot` returns a JSON-ready dict; ``REPRO_TORCH_METRICS_DUMP=path``
registers an ``atexit`` dump of the final snapshot (and :func:`maybe_dump`
does it on demand).  The variable is the port's own, apart from the JAX
package's ``REPRO_METRICS_DUMP``, so that one process holding both packages
does not cross their dumps.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

MAX_SAMPLES = 65536  # histogram raw-sample cap; thinned 2:1 when exceeded

DUMP_ENV = "REPRO_TORCH_METRICS_DUMP"


class Counter:
    """Monotone counter.  ``inc`` is lock-guarded so concurrent increments
    (plan-cache runners on several threads) never drop updates between the
    read and the write of a bare ``+= 1``."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (e.g. a fit's residual, a profile's age)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Raw-sample histogram with exact percentiles.

    Samples are kept verbatim up to :data:`MAX_SAMPLES`, then thinned 2:1
    (every other retained sample) — count / sum / min / max stay exact, and
    percentiles stay representative.  ``percentile(p)`` uses the linear
    interpolation convention (rank ``p/100 * (n-1)``), matching
    ``numpy.percentile``'s default without importing numpy.
    """

    __slots__ = ("name", "_values", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._values: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            self._values.append(v)
            if len(self._values) > MAX_SAMPLES:
                self._values = self._values[::2]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return None
        if len(vals) == 1:
            return vals[0]
        rank = (min(max(p, 0.0), 100.0) / 100.0) * (len(vals) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def summary(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        out = {
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "mean": (total / count) if count else None,
        }
        for p in (50, 90, 99):
            out[f"p{p}"] = self.percentile(p)
        return out


class MetricsRegistry:
    """Name-keyed store of counters / gauges / histograms plus joined
    read-only *sources* (callables returning JSON-ready dicts).

    Instruments are created on first use (``counter(name)`` get-or-creates)
    and are themselves thread-safe; the registry lock only guards the name
    maps, so hot-path increments never serialize on a global lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sources: Dict[str, Callable[[], Dict]] = {}

    # -- instruments ---------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
        return h

    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- sources -------------------------------------------------------------
    def register_source(self, name: str, fn: Callable[[], Dict]) -> None:
        """Join an externally owned telemetry dict into every snapshot
        (``fn`` is called at snapshot time; exceptions degrade to an error
        marker instead of poisoning the whole snapshot)."""
        with self._lock:
            self._sources[name] = fn

    # -- snapshot / dump -----------------------------------------------------
    def snapshot(self, include_sources: bool = True) -> Dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            sources = dict(self._sources)
        out: Dict = {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(histograms.items())
            },
        }
        if include_sources:
            src: Dict[str, Dict] = {}
            for name, fn in list(_builtin_sources().items()) + sorted(
                    sources.items()):
                try:
                    src[name] = fn()
                except Exception as e:  # a broken source must not take down
                    src[name] = {"error": str(e)}  # the whole snapshot
            out["sources"] = src
        return out

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, default=str)
        return path

    def reset(self) -> None:
        """Drop every instrument (sources stay registered) — test isolation."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def _builtin_sources() -> Dict[str, Callable[[], Dict]]:
    """The module-owned telemetry surfaces, joined lazily so that this module
    never imports ``repro_torch.core`` (a snapshot taken before those
    modules load omits them)."""
    import sys

    out: Dict[str, Callable[[], Dict]] = {}
    cp = sys.modules.get("repro_torch.core.collective_planner")
    if cp is not None:
        out["lattice"] = cp.search_telemetry
    pv = sys.modules.get("repro_torch.core.plan_verify")
    if pv is not None:
        out["plan_verify"] = pv.verify_telemetry
    pt = sys.modules.get("repro_torch.core.partitioner")
    if pt is not None:
        out["process_plan_cache"] = lambda: pt.process_plan_cache_stats(
        ).as_dict()
    return out


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry (one per process, like the plan cache)."""
    return _REGISTRY


def inc(name: str, n: float = 1.0) -> None:
    _REGISTRY.inc(name, n)


def set_gauge(name: str, v: float) -> None:
    _REGISTRY.set_gauge(name, v)


def observe(name: str, v: float) -> None:
    _REGISTRY.observe(name, v)


@contextlib.contextmanager
def timed(name: str):
    """Time a block into histogram ``name`` (milliseconds, host clock)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _REGISTRY.observe(name, (time.perf_counter() - t0) * 1e3)


def snapshot(include_sources: bool = True) -> Dict:
    return _REGISTRY.snapshot(include_sources=include_sources)


def maybe_dump() -> Optional[str]:
    """Dump the registry snapshot to ``$REPRO_TORCH_METRICS_DUMP`` if set."""
    path = os.environ.get(DUMP_ENV)
    if not path:
        return None
    return _REGISTRY.dump(path)


if os.environ.get(DUMP_ENV):  # final snapshot on interpreter exit
    atexit.register(maybe_dump)
