"""Thread-safe metrics registry with Prometheus text exposition.

A copy of the part of ``deeplearning4j_tpu/obs/metrics.py`` (``:49-311``)
that the serving metrics use: counters, gauges (settable, or a callback
read at scrape time), the bounded ring histogram, the Prometheus text and
the process-wide :func:`default_registry`. The
training and data-pipeline publishers come with their slices (ROADMAP
§ A).

- **Bounded memory.** Histograms keep a fixed-size ring of recent
  observations, never an unbounded list.
- **Get-or-create.** Re-requesting a metric returns the existing instance
  (same name and labels); re-registering a name as a different type
  raises.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    esc = [(k, v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n"))
           for k, v in key]
    return "{" + ",".join(f'{k}="{v}"' for k, v in esc) + "}"


class Counter:
    """Monotonic float counter (Prometheus ``counter``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc({n}))")
        with self._lock:
            self._value += n

    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Settable value, or a callback read at scrape time (queue depths)."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        with self._lock:
            self._fn = fn

    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 — a dying gauge callback must not fail the scrape
            return 0.0


class Histogram:
    """Bounded histogram: total count/sum forever, quantiles over a
    fixed-size ring of the most recent observations. Exposed in
    Prometheus text as a ``summary`` (quantile series + _sum/_count)."""

    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self, ring_size: int = 2048):
        self._lock = threading.Lock()
        self._ring_size = int(ring_size)
        self._ring = [0.0] * self._ring_size
        self._n = 0  # total ever observed (write head = n % size)
        self._sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._ring[self._n % self._ring_size] = float(v)
            self._n += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def window(self) -> List[float]:
        """Sorted copy of the current ring window."""
        with self._lock:
            n = min(self._n, self._ring_size)
            return sorted(self._ring[:n])

    def quantile(self, q: float) -> Optional[float]:
        """q in [0, 1] over the ring window; None before any observation."""
        w = self.window()
        if not w:
            return None
        return w[min(int(q * len(w)), len(w) - 1)]


class MetricsRegistry:
    """Named metrics with optional labels; one instance per surface, or the
    process-wide :func:`default_registry` (``cli serve`` wires serving
    into it)."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, help); (name, label_key) -> metric object
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._metrics: Dict[Tuple[str, _LabelKey], object] = {}

    # -- registration --------------------------------------------------------
    def _get_or_create(self, kind: str, name: str, help: str,
                       labels: Optional[Dict[str, str]], **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            meta = self._meta.get(name)
            if meta is not None and meta[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {meta[0]}, "
                    f"cannot re-register as {kind}")
            if meta is None:
                self._meta[name] = (kind, help)
            elif help and not meta[1]:
                self._meta[name] = (kind, help)
            m = self._metrics.get(key)
            if m is None:
                m = self._TYPES[kind](**kwargs)
                self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create("gauge", name, help, labels)
        if fn is not None:
            g.set_function(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  ring_size: int = 2048) -> Histogram:
        return self._get_or_create("histogram", name, help, labels,
                                   ring_size=ring_size)

    def family_values(self, name: str) -> Dict[str, float]:
        """One family's per-label-set values as ``{label-string: value}``,
        read from the members directly (no callback gauge is evaluated)."""
        with self._lock:
            members = [(lkey, m) for (n, lkey), m in self._metrics.items()
                       if n == name]
        return {",".join(f"{k}={v}" for k, v in lkey): float(m.value())
                for lkey, m in members}

    # -- reading -------------------------------------------------------------
    def _series(self) -> Iterable[Tuple[str, str, str, _LabelKey, object]]:
        with self._lock:
            items = sorted(self._metrics.items())
            meta = dict(self._meta)
        for (name, lkey), m in items:
            kind, help = meta[name]
            yield name, kind, help, lkey, m

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4). Histograms are
        rendered as summaries (quantile series + ``_sum``/``_count``)."""
        lines: List[str] = []
        seen_header = set()
        for name, kind, help, lkey, m in self._series():
            if name not in seen_header:
                seen_header.add(name)
                if help:
                    lines.append(f"# HELP {name} {help}")
                lines.append(
                    f"# TYPE {name} "
                    f"{'summary' if kind == 'histogram' else kind}")
            if kind == "histogram":
                for q in Histogram.QUANTILES:
                    v = m.quantile(q)
                    qkey = lkey + (("quantile", f"{q:g}"),)
                    lines.append(
                        f"{name}{_label_str(qkey)} "
                        f"{'NaN' if v is None else repr(float(v))}")
                lines.append(f"{name}_sum{_label_str(lkey)} "
                             f"{repr(float(m.sum))}")
                lines.append(f"{name}_count{_label_str(lkey)} {m.count}")
            else:
                v = float(m.value())
                txt = repr(v) if v != int(v) else str(int(v))
                lines.append(f"{name}{_label_str(lkey)} {txt}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# default (process-wide) registry
# --------------------------------------------------------------------------
_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry: one Prometheus surface per process."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
