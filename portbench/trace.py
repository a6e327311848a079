"""Reading a ``torch.profiler`` trace: the device's busy time inside the
traced window, each kernel's device time and launches, the device time
of the work launched under one of the benchmark's spans, and the
breakdown of device operations and idle gaps; and the busy time of a
trace that records the device's work alone (``device_busy_s``).

The trace is the profiler's Chrome trace (``export_chrome_trace``),
read as JSON.  Device work is every kernel, copy and set on the card;
a launch is tied to its host call by the trace's correlation id.  The
window is the host span ``WINDOW`` that the harness puts around the
traced steps; it ends after a synchronise, so it holds their device
work.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

WINDOW = "portbench/window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = ("cuda_runtime", "cuda_driver")
_HOST = ("cpu_op", "user_annotation", "python_function")


def _events(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merged(intervals):
    """The union of sorted (start, end) intervals, as disjoint ones."""
    merged = []
    for a, b in intervals:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_busy_s(path) -> float:
    """Seconds in which an operation ran on the device, over a whole
    trace: the union of its device intervals."""
    ivs = sorted((float(e["ts"]) * 1e-6,
                  (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6)
                 for e in _events(path)
                 if e.get("ph") == "X" and e.get("cat", "") in _DEVICE)
    return sum(b - a for a, b in _merged(ivs))


class Trace:
    """The events of one rank's trace, times in seconds."""

    def __init__(self, events):
        self.device, self.runtime, self.host, self.spans = [], {}, [], []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in _DEVICE:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in _RUNTIME:
                if corr is not None:
                    self.runtime[corr] = ts
            elif cat in _HOST:
                name = e.get("name", "")
                if name == WINDOW:
                    window = (ts, ts + dur)
                    continue
                if not name.startswith("ProfilerStep#"):
                    self.host.append((ts, ts + dur, name))
                if cat == "user_annotation":
                    self.spans.append((ts, ts + dur, name))
        if window is None:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        self.window = window
        self.device.sort()
        self.host.sort()

    @classmethod
    def load(cls, path):
        return cls(_events(path))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _busy_intervals(self):
        """The union of device intervals inside the window, merged."""
        lo, hi = self.window
        return _merged((max(a, lo), min(b, hi)) for a, b, _, _ in self.device)

    def _of_window(self, a, b, corr) -> bool:
        """Whether a device operation is the window's work: the host call
        that launched it lies in the window, or, with no launch on
        record, the operation itself does.  The launch is stamped on the
        host's clock, as the window is; the device's stamps are converted
        to that clock and can put the last kernels before the closing
        synchronise past the window's end."""
        lo, hi = self.window
        t = self.runtime.get(corr)
        if t is not None:
            return lo <= t <= hi
        return a >= lo and b <= hi

    def kernels(self, needle: str):
        """(device seconds, launches) of the kernels whose name holds
        ``needle``, of the window's work."""
        mine = [(a, b) for a, b, name, corr in self.device
                if needle in name and self._of_window(a, b, corr)]
        return sum(b - a for a, b in mine), len(mine)

    def kernels_by_span(self, needle: str, span: str):
        """(device seconds, launches) of the kernels whose name holds
        ``needle``, for each host span named ``span`` in turn: those
        whose launch's host call lies in it."""
        ivs = sorted((a, b) for a, b, name in self.spans if name == span)
        starts = [a for a, _ in ivs]
        out = [[0.0, 0] for _ in ivs]
        for a, b, name, corr in self.device:
            t = self.runtime.get(corr)
            if t is None or needle not in name:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1]:
                out[i][0] += b - a
                out[i][1] += 1
        return [tuple(x) for x in out]

    def span_device_s(self, span: str) -> float:
        """Device seconds of the work launched from inside a host span
        named ``span`` (the launch's host call lies in the span)."""
        return sum(t for t, _ in self.kernels_by_span("", span))

    def span_count(self, span: str) -> int:
        return sum(1 for _, _, name in self.spans if name == span)

    def breakdown(self, top: int = 10) -> dict:
        """The ``top`` device operations by device time, and the idle
        gaps inside the window summed by the innermost host call that
        was running when each began."""
        by_op = defaultdict(float)
        lo, hi = self.window
        for a, b, name, corr in self.device:
            if self._of_window(a, b, corr):
                by_op[name[:120]] += b - a
        gaps = defaultdict(float)
        starts = [h[0] for h in self.host]
        prev = lo
        for a, b in self._busy_intervals() + [[hi, hi]]:
            if a > prev:
                gaps[self._host_at(prev, starts)] += a - prev
            prev = max(prev, b)
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}

    def _host_at(self, t, starts) -> str:
        """The innermost host call that spans time ``t``: the latest
        started of those that do (calls on a thread nest)."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 20000, -1), -1):
            a, b, name = self.host[j]
            if b >= t:
                return name
        return "(between host calls)"
