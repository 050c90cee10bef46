"""Reduce a ``torch.profiler`` trace to the benchmark's device numbers.

The traced run exports the profiler's Chrome trace and reads from it:
the device operations (kernels, copies, sets) as intervals on the
device's clock; the benchmark's own spans (``record_function``, host
side); and the launch calls that tie each kernel to the host time at
which it was launched (the ``correlation`` id).  Times in the trace are
microseconds; everything returned is in seconds.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

from .spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged, a, b):
    """Length of [a, b] that the merged intervals cover."""
    tot = 0.0
    for x, y in merged:
        if y <= a:
            continue
        if x >= b:
            break
        tot += min(y, b) - max(x, a)
    return tot


@dataclass
class Trace:
    window: tuple            # (start, end) of the benchmark's window span
    ops: list                # (start, end, name, correlation)
    spans: list              # (start, end, name) of the benchmark's spans
    launches: dict           # correlation -> host time of the launch
    busy: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return covered(self.busy, *self.window) / 1e6

    def idle_in(self, name: str) -> float:
        """Seconds of the spans called ``name`` (``portbench/<name>#i``)
        in which no device operation ran."""
        tot = 0.0
        for a, b, nm in self.spans:
            if base(nm) == name:
                tot += (b - a) - covered(self.busy, a, b)
        return tot / 1e6

    def device_by_span(self, names) -> dict:
        """{span name in ``names``: device seconds of the operations
        launched inside it}."""
        inner = [s for s in self.spans if s[2] in names]
        inner.sort()
        starts = [s[0] for s in inner]
        out = {}
        for a, b, _, corr in self.ops:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= inner[i][1]:
                nm = inner[i][2]
                out[nm] = out.get(nm, 0.0) + (b - a) / 1e6
        return out

    def top_ops(self, count: int = 10):
        per = {}
        for a, b, nm, _ in self.ops:
            if self.window[0] <= a < self.window[1]:
                per[nm] = per.get(nm, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in per.items()),
                      key=lambda kv: -kv[1])[:count]

    def idle_gaps(self, count: int = 10):
        """The longest idle stretches of the device inside the window,
        each named by the innermost benchmark span the host was in when
        it began."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        gaps = []
        for i in range(0, len(edges) - 1, 2):
            a, b = max(edges[i], w0), min(edges[i + 1], w1)
            if b > a:
                gaps.append((b - a, a))
        gaps.sort(reverse=True)
        out = []
        for length, a in gaps[:count]:
            holders = [s for s in self.spans if s[0] <= a < s[1]]
            name = (base(min(holders, key=lambda s: s[1] - s[0])[2])
                    if holders else "between spans")
            out.append([name, length / 1e6])
        return out


def base(span: str) -> str:
    """``portbench/pca#12`` -> ``pca``."""
    return span[len(PREFIX):].split("#", 1)[0]


def load(path: str, window_name: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    ops, spans, launches = [], [], {}
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(
            e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((ts, ts + dur, e["name"], args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            if e["name"] == window_name:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, e["name"]))
    if window is None:
        raise RuntimeError(f"the trace holds no {window_name} span")
    spans = [s for s in spans if window[0] <= s[0] and s[1] <= window[1]]
    tr = Trace(window, ops, spans, launches)
    tr.busy = merge([(a, b) for a, b, _, _ in ops])
    return tr
