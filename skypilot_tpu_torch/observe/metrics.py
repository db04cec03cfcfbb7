"""Thread-safe metrics registry with declared, bounded label sets (a
copy of skypilot_tpu/observe/metrics.py: ``Counter``, ``Gauge``,
``Histogram`` and ``Registry`` with its ``render``, the same Prometheus
text exposition, so a port engine's
``/metrics`` reads as the JAX engine's does to the serve plane's
scraper).

Label sets are declared up front as finite tuples and an undeclared
label value is a ``ValueError`` at the call site: the cardinality
discipline of the JAX package. Names are ``skytpu_<subsystem>_<name>``,
snake_case. Rendering follows the text exposition format 0.0.4
(``# HELP`` / ``# TYPE`` lines, cumulative histogram buckets with a
``+Inf`` bucket equal to ``_count``).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

NAME_RE = re.compile(r'^skytpu_[a-z0-9]+(_[a-z0-9]+)+$')
_LABEL_RE = re.compile(r'^[a-z][a-z0-9_]*$')

# Latency buckets (seconds): sub-ms to minutes — control-plane
# operations span request-queue waits (ms) to provisioning (minutes).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0)

LabelSpec = Mapping[str, Sequence[str]]


def _fmt(value: float) -> str:
    if value == math.inf:
        return '+Inf'
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _escape(text: str) -> str:
    return (text.replace('\\', r'\\').replace('\n', r'\n')
            .replace('"', r'\"'))


class _Metric:
    kind = ''

    def __init__(self, name: str, help_text: str,
                 labels: Optional[LabelSpec] = None):
        if not NAME_RE.match(name):
            raise ValueError(
                f'metric name {name!r} must be skytpu_<subsystem>_<name> '
                f'snake_case (see docs/OBSERVABILITY.md)')
        self.name = name
        self.help_text = help_text
        self._label_names: Tuple[str, ...] = tuple((labels or {}).keys())
        self._label_values: Dict[str, frozenset] = {}
        for lname, values in (labels or {}).items():
            if not _LABEL_RE.match(lname):
                raise ValueError(f'label name {lname!r} is not snake_case')
            vals = frozenset(str(v) for v in values)
            if not vals:
                raise ValueError(f'label {lname!r} declares no values')
            self._label_values[lname] = vals
        self._lock = threading.Lock()

    def _labelspec(self) -> Dict[str, Tuple[str, ...]]:
        return {k: tuple(sorted(v)) for k, v in self._label_values.items()}

    def _key(self, labels: Mapping[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self._label_names):
            raise ValueError(
                f'{self.name}: got labels {sorted(labels)}, declared '
                f'{sorted(self._label_names)}')
        out = []
        for lname in self._label_names:
            value = str(labels[lname])
            if value not in self._label_values[lname]:
                raise ValueError(
                    f'{self.name}: undeclared value {value!r} for label '
                    f'{lname!r} (declared: '
                    f'{sorted(self._label_values[lname])}) — bounded '
                    f'label sets are the cardinality contract')
            out.append(value)
        return tuple(out)

    def _label_str(self, key: Tuple[str, ...],
                   extra: Optional[Tuple[Tuple[str, str], ...]] = None
                   ) -> str:
        pairs = list(zip(self._label_names, key)) + list(extra or ())
        if not pairs:
            return ''
        inner = ','.join(f'{k}="{_escape(v)}"' for k, v in pairs)
        return '{' + inner + '}'

    def _header(self) -> List[str]:
        return [f'# HELP {self.name} {_escape(self.help_text)}',
                f'# TYPE {self.name} {self.kind}']

    def render(self) -> List[str]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count."""
    kind = 'counter'

    def __init__(self, name: str, help_text: str,
                 labels: Optional[LabelSpec] = None):
        super().__init__(name, help_text, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError('counters only go up')
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            out.append(f'{self.name}{self._label_str(key)} {_fmt(value)}')
        return out

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Gauge(_Metric):
    """A value that can go up and down."""
    kind = 'gauge'

    def __init__(self, name: str, help_text: str,
                 labels: Optional[LabelSpec] = None):
        super().__init__(name, help_text, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        for key, value in items:
            out.append(f'{self.name}{self._label_str(key)} {_fmt(value)}')
        return out

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Histogram(_Metric):
    """Cumulative-bucket histogram (``_bucket``/``_sum``/``_count``)."""
    kind = 'histogram'

    def __init__(self, name: str, help_text: str,
                 labels: Optional[LabelSpec] = None,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_text, labels)
        bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError('histogram needs at least one bucket bound')
        self.buckets = bounds
        # key -> (per-bucket counts, sum, count)
        self._data: Dict[Tuple[str, ...], List] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                entry = [[0] * len(self.buckets), 0.0, 0]
                self._data[key] = entry
            counts, _, _ = entry
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            entry[1] += value
            entry[2] += 1

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted((k, ([*v[0]], v[1], v[2]))
                           for k, v in self._data.items())
        for key, (counts, total, count) in items:
            cumulative = 0
            for bound, n in zip(self.buckets, counts):
                cumulative += n
                le = (('le', _fmt(bound)),)
                out.append(f'{self.name}_bucket'
                           f'{self._label_str(key, le)} {cumulative}')
            out.append(f'{self.name}_bucket'
                       f'{self._label_str(key, (("le", "+Inf"),))} '
                       f'{count}')
            out.append(f'{self.name}_sum{self._label_str(key)} '
                       f'{_fmt(total)}')
            out.append(f'{self.name}_count{self._label_str(key)} {count}')
        return out

    def reset(self) -> None:
        with self._lock:
            self._data.clear()


class Registry:
    """A metric registry (the port's engine keeps one per engine).

    Declarations are idempotent get-or-create: a module may re-declare
    the same metric (same kind, help and label spec) and receive the
    existing instance — but a conflicting redeclaration raises, so two
    subsystems cannot silently share a name with different meanings.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_text: str,
                       labels: Optional[LabelSpec], **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                want_labels = {k: tuple(sorted(str(x) for x in v))
                               for k, v in (labels or {}).items()}
                want_buckets = kwargs.get('buckets')
                bucket_conflict = (
                    isinstance(existing, Histogram) and
                    want_buckets is not None and
                    tuple(sorted(want_buckets)) != existing.buckets)
                if (type(existing) is not cls or
                        existing._labelspec() != want_labels or
                        bucket_conflict):
                    raise ValueError(
                        f'metric {name!r} already registered with a '
                        f'different kind, label spec or buckets')
                return existing
            metric = cls(name, help_text, labels, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str,
                labels: Optional[LabelSpec] = None) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str,
              labels: Optional[LabelSpec] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str,
                  labels: Optional[LabelSpec] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format."""
        lines: List[str] = []
        for metric in self.metrics():
            lines.extend(metric.render())
        return '\n'.join(lines) + ('\n' if lines else '')

    def reset_for_tests(self) -> None:
        """Zero every metric's samples. Registrations are KEPT: modules
        hold references to their metric objects, so dropping the
        registration would silently disconnect them."""
        for metric in self.metrics():
            metric.reset()
