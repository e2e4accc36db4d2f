"""Process-wide metrics: Prometheus text exposition: a copy of
keto_tpu/x/metrics.py.

Every signal the serving system emits used to live in a different silo —
``DurationStats``/``MaintenanceStats`` snapshots reachable only
in-process, the tracer's drop/export counters invisible, the health state
machine unscrapeable. This module is the single pane of glass over them:
a ``MetricsRegistry`` holding counters, gauges, and fixed-bucket
histograms, rendered in the Prometheus text exposition format at REST
``GET /metrics`` (keto_tpu_torch/servers/rest.py) on both API ports.

Two instrument kinds, matching the two ways stats already flow:

- **direct instruments** (``counter``/``gauge``/``histogram``) for hot
  paths that record per event: per-route request counters and latency
  histograms in the REST/gRPC layers, engine slice service times. The
  record path is allocation-free after the first observation of a label
  set — a dict lookup, a striped lock, and integer/float adds; no string
  formatting, no per-event objects. Rendering cost is paid by the
  scraper, never the request.
- **callback families** (``register_callback``) for components that
  already keep their own counters (CheckBatcher shed/deadline counts,
  ``MaintenanceStats``, the health monitor, the tracer, the persisters):
  the callback reads the live values at scrape time, so the hot path of
  those components is untouched.

Latency histograms carry **slowest-sample exemplars**: the single
slowest observation per label set keeps its trace id, and the OpenMetrics
rendering (negotiated via ``Accept: application/openmetrics-text``, the
way a Prometheus server asks for exemplars) attaches it to the bucket
that observation landed in — an operator jumps from "p99 spiked" straight
to the trace of a worst-case request.

``parse_exposition`` is the strict self-check parser the metrics-lint CI
step (scripts/metrics_lint.py) and the conformance tests share: every
scrape line must satisfy the naming/escaping conventions, histogram
buckets must be monotone, and ``_count``/``_sum`` must be consistent.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Any, Callable, Iterable, Optional

#: default latency buckets (seconds): 0.5 ms .. 10 s, roughly doubling —
#: wide enough for a CPU-fallback check, fine enough to see a 40 ms
#: slice target move
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: routes the REST surface declares (spec/api.json); anything else is
#: folded into "other" so a path-scanning client cannot grow the label
#: maps without bound (one unknown path == one counter key forever)
KNOWN_ROUTES = frozenset(
    {
        "/check",
        "/check/batch",
        "/check/explain",
        "/expand",
        "/relation-tuples",
        "/relation-tuples/list-objects",
        "/relation-tuples/list-subjects",
        "/snapshot/export",
        "/watch",
        "/version",
        "/metrics",
        "/debug/requests",
        "/slo",
        "/fleet",
        "/health/alive",
        "/health/ready",
    }
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: number of lock stripes instruments hash onto: concurrent observes of
#: DIFFERENT label sets rarely contend, while per-child locks would cost
#: one lock object per route×code combination
_N_STRIPES = 16


def normalize_route(path: str) -> str:
    """A bounded-cardinality route label for ``path``: declared routes
    pass through, everything else (scans, typos, parameterized paths) is
    ``other``."""
    return path if path in KNOWN_ROUTES else "other"


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Prometheus value formatting: integers render bare (no exponent),
    +Inf/-Inf/NaN use the spec spellings."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer() and abs(v) < 2**53):
        return str(int(v))
    return repr(float(v))


def _label_str(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Counter:
    """Monotone counter family. Hot path: ``inc(labels, by)`` — dict get,
    striped lock, float add."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: tuple, lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = lock
        self._children: dict[tuple, float] = {}

    def inc(self, labels: tuple = (), by: float = 1.0) -> None:
        with self._lock:
            self._children[labels] = self._children.get(labels, 0.0) + by

    def samples(self):
        with self._lock:
            items = sorted(self._children.items())
        for labels, value in items:
            yield self.name, self.labelnames, labels, value, None


class _Gauge:
    """Settable gauge family."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: tuple, lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = lock
        self._children: dict[tuple, float] = {}

    def set(self, labels: tuple = (), value: float = 0.0) -> None:
        with self._lock:
            self._children[labels] = float(value)

    def inc(self, labels: tuple = (), by: float = 1.0) -> None:
        with self._lock:
            self._children[labels] = self._children.get(labels, 0.0) + by

    def samples(self):
        with self._lock:
            items = sorted(self._children.items())
        for labels, value in items:
            yield self.name, self.labelnames, labels, value, None


class _HistChild:
    __slots__ = ("counts", "sum", "exemplar")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        # slowest sample seen: (value, trace_id, unix_seconds)
        self.exemplar: Optional[tuple[float, str, float]] = None


class _Histogram:
    """Fixed-bucket histogram family with slowest-sample exemplars.

    ``observe`` is the hot path: bisect into the bucket list, striped
    lock, two adds. The exemplar only updates when a new slowest sample
    arrives, so steady-state traffic never touches it."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: tuple,
        buckets: tuple,
        lock: threading.Lock,
    ):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"histogram {name}: buckets must be strictly ascending")
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = lock
        self._children: dict[tuple, _HistChild] = {}

    def observe(self, labels: tuple = (), value: float = 0.0, trace_id: str = "") -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            child = self._children.get(labels)
            if child is None:
                child = self._children[labels] = _HistChild(len(self.buckets) + 1)
            child.counts[i] += 1
            child.sum += value
            if trace_id and (child.exemplar is None or value > child.exemplar[0]):
                child.exemplar = (value, trace_id, time.time())

    def samples(self):
        with self._lock:
            items = [
                (labels, list(c.counts), c.sum, c.exemplar)
                for labels, c in sorted(self._children.items())
            ]
        for labels, counts, total_sum, exemplar in items:
            cum = 0
            for i, le in enumerate(self.buckets + (math.inf,)):
                cum += counts[i]
                ex = None
                if (
                    exemplar is not None
                    and exemplar[0] <= le
                    and (i == 0 or exemplar[0] > self.buckets[i - 1])
                ):
                    ex = exemplar
                yield (
                    f"{self.name}_bucket",
                    self.labelnames + ("le",),
                    labels + (_fmt_value(le),),
                    cum,
                    ex,
                )
            yield f"{self.name}_sum", self.labelnames, labels, total_sum, None
            yield f"{self.name}_count", self.labelnames, labels, cum, None


class _CallbackFamily:
    """A family whose samples are produced by a callable at scrape time
    — the bridge for components that already keep their own counters."""

    def __init__(self, name: str, kind: str, help: str, labelnames: tuple, fn: Callable):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self._fn = fn

    def samples(self):
        try:
            rows = list(self._fn())
        except Exception:
            # a broken stat source must not take /metrics down with it
            rows = []
        for labels, value in sorted(rows):
            yield self.name, self.labelnames, tuple(labels), value, None


class MetricsRegistry:
    """Instrument factory + Prometheus renderer. Instrument creation is
    idempotent by (name, kind, labelnames), so layers can declare the
    instruments they record into without coordinating construction
    order."""

    def __init__(self):
        self._lock = threading.Lock()  # guards: _families
        self._families: dict[str, Any] = {}
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        #: scrapes served (itself a family, registered lazily by render)
        self.enabled = True

    # -- instrument construction ----------------------------------------------

    def _stripe(self, name: str) -> threading.Lock:
        return self._stripes[hash(name) % _N_STRIPES]

    def _declare(self, cls, name, help, labelnames, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            got = self._families.get(name)
            if got is not None:
                if type(got) is not cls or got.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name!r} re-declared with a different shape")
                return got
            fam = cls(name, help, tuple(labelnames), lock=self._stripe(name), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str, labelnames: Iterable[str] = ()) -> _Counter:
        if not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end in _total")
        return self._declare(_Counter, name, help, tuple(labelnames))

    def gauge(self, name: str, help: str, labelnames: Iterable[str] = ()) -> _Gauge:
        return self._declare(_Gauge, name, help, tuple(labelnames))

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> _Histogram:
        return self._declare(
            _Histogram, name, help, tuple(labelnames), buckets=tuple(buckets)
        )

    def register_callback(
        self,
        name: str,
        kind: str,
        help: str,
        fn: Callable[[], Iterable[tuple[tuple, float]]],
        labelnames: Iterable[str] = (),
    ) -> None:
        """``fn()`` yields ``(label_values, value)`` rows at every scrape;
        kind is ``counter`` or ``gauge`` (counter names must end
        ``_total``)."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"callback kind must be counter|gauge, got {kind!r}")
        if kind == "counter" and not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end in _total")
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            if name in self._families:
                raise ValueError(f"metric {name!r} already registered")
            self._families[name] = _CallbackFamily(
                name, kind, help, tuple(labelnames), fn
            )

    # -- exposition ------------------------------------------------------------

    def render(self, openmetrics: bool = False) -> str:
        """The scrape body. Plain Prometheus text format by default;
        ``openmetrics`` adds exemplars on histogram buckets and the
        ``# EOF`` terminator (what a scraper asking via ``Accept:
        application/openmetrics-text`` gets)."""
        with self._lock:
            families = [self._families[k] for k in sorted(self._families)]
        out: list[str] = []
        for fam in families:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for sample_name, names, values, value, exemplar in fam.samples():
                line = f"{sample_name}{_label_str(names, values)} {_fmt_value(value)}"
                if openmetrics and exemplar is not None:
                    ev, etid, ets = exemplar
                    line += (
                        f' # {{trace_id="{_escape_label_value(etid)}"}}'
                        f" {_fmt_value(ev)} {ets:.3f}"
                    )
                out.append(line)
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"

    def family_names(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def family(self, name: str):
        """The live family object for ``name`` (or None) — the SLO
        engine reads request counters/histograms through this instead of
        parsing a rendered exposition, so sampling inside a scrape-time
        callback can never recurse into ``render``."""
        with self._lock:
            return self._families.get(name)


class _NullInstrument:
    """Accepts every record call and does nothing — what instruments
    resolve to with ``metrics.enabled: false``, so recording sites stay
    unconditional."""

    def inc(self, labels=(), by=1.0):
        pass

    def set(self, labels=(), value=0.0):
        pass

    def observe(self, labels=(), value=0.0, trace_id=""):
        pass


class NullMetricsRegistry:
    """The disabled registry: same construction surface, zero overhead,
    renders an empty exposition (REST answers 404 for /metrics)."""

    enabled = False

    def __init__(self):
        self._null = _NullInstrument()

    def counter(self, name, help, labelnames=()):
        return self._null

    def gauge(self, name, help, labelnames=()):
        return self._null

    def histogram(self, name, help, labelnames=(), buckets=DEFAULT_LATENCY_BUCKETS):
        return self._null

    def register_callback(self, name, kind, help, fn, labelnames=()):
        pass

    def render(self, openmetrics: bool = False) -> str:
        return ""

    def family_names(self) -> list[str]:
        return []

    def family(self, name: str):
        return None


# -- strict exposition parser (lint + conformance seam) ------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[^ #]+)"
    r"(?P<exemplar> # \{[^{}]*\} [^ ]+( [^ ]+)?)?$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    return float(raw)


def parse_exposition(text: str) -> dict[str, dict]:
    """Strictly parse a text exposition; raises ``ValueError`` on any
    convention violation. Returns ``{family: {"type", "help", "samples":
    [(sample_name, {label: value}, float)]}}``.

    Checks: HELP-before-TYPE-before-samples ordering, name/label syntax,
    counters ending ``_total``, no duplicate (name, labelset) samples,
    histogram bucket monotonicity, and ``_count`` == the ``+Inf`` bucket
    with a ``_sum`` present."""
    families: dict[str, dict] = {}
    current: Optional[str] = None
    seen_samples: set[tuple] = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            raise ValueError(f"line {lineno}: blank line in exposition")
        if line == "# EOF":
            current = None
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            if name in families:
                raise ValueError(f"line {lineno}: duplicate HELP for {name}")
            families[name] = {"type": None, "help": help_text, "samples": []}
            current = name
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            if name != current:
                raise ValueError(f"line {lineno}: TYPE {name} without preceding HELP")
            if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: unknown type {kind!r}")
            if kind == "counter" and not name.endswith("_total"):
                raise ValueError(f"line {lineno}: counter {name} must end in _total")
            families[name]["type"] = kind
            continue
        if line.startswith("#"):
            raise ValueError(f"line {lineno}: unexpected comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        sample_name = m.group("name")
        fam_name = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix) and sample_name[: -len(suffix)] in families:
                fam_name = sample_name[: -len(suffix)]
                break
        if fam_name != current or fam_name not in families:
            raise ValueError(
                f"line {lineno}: sample {sample_name} outside its family block"
            )
        fam = families[fam_name]
        if fam["type"] is None:
            raise ValueError(f"line {lineno}: sample before TYPE for {fam_name}")
        if fam["type"] == "histogram":
            if sample_name == fam_name:
                raise ValueError(
                    f"line {lineno}: bare histogram sample {sample_name}"
                )
        elif sample_name != fam_name:
            raise ValueError(
                f"line {lineno}: suffixed sample {sample_name} on {fam['type']}"
            )
        raw_labels = m.group("labels") or ""
        labels = dict(_LABEL_PAIR_RE.findall(raw_labels[1:-1])) if raw_labels else {}
        if raw_labels:
            rebuilt = ",".join(f'{k}="{v}"' for k, v in labels.items())
            if "{" + rebuilt + "}" != raw_labels:
                raise ValueError(f"line {lineno}: malformed labels {raw_labels!r}")
        key = (sample_name, tuple(sorted(labels.items())))
        if key in seen_samples:
            raise ValueError(f"line {lineno}: duplicate sample {key}")
        seen_samples.add(key)
        value = _parse_value(m.group("value"))
        if fam["type"] == "counter" and value < 0:
            raise ValueError(f"line {lineno}: negative counter {sample_name}")
        fam["samples"].append((sample_name, labels, value))

    # histogram consistency: per label set, buckets must be cumulative
    # (monotone nondecreasing), end at +Inf, and agree with _count/_sum
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        by_child: dict[tuple, dict] = {}
        for sample_name, labels, value in fam["samples"]:
            child_key = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            child = by_child.setdefault(child_key, {"buckets": [], "sum": None, "count": None})
            if sample_name == f"{name}_bucket":
                child["buckets"].append((_parse_value(labels["le"]), value))
            elif sample_name == f"{name}_sum":
                child["sum"] = value
            elif sample_name == f"{name}_count":
                child["count"] = value
        for child_key, child in by_child.items():
            buckets = child["buckets"]
            if not buckets:
                raise ValueError(f"{name}{dict(child_key)}: histogram without buckets")
            les = [le for le, _ in buckets]
            if les != sorted(les):
                raise ValueError(f"{name}{dict(child_key)}: bucket le values not ascending")
            counts = [c for _, c in buckets]
            if counts != sorted(counts):
                raise ValueError(f"{name}{dict(child_key)}: bucket counts not cumulative")
            if les[-1] != math.inf:
                raise ValueError(f"{name}{dict(child_key)}: missing +Inf bucket")
            if child["count"] is None or child["sum"] is None:
                raise ValueError(f"{name}{dict(child_key)}: missing _count or _sum")
            if child["count"] != counts[-1]:
                raise ValueError(
                    f"{name}{dict(child_key)}: _count {child['count']} != "
                    f"+Inf bucket {counts[-1]}"
                )
    return families
