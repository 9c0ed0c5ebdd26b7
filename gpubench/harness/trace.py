"""The device trace of a window: ``torch.profiler`` over CPU and CUDA.

The traced run wraps its window in a ``gpubench.window`` annotation, each
call into the program in a ``gpubench.call`` annotation and the harness's
own work between calls (the next call's draw, the answers kept) in a
``gpubench.draw`` annotation, exports the profiler's
Chrome trace, and reads it back here: what ran on each card and when, and
what the host was doing while no card ran anything. Times in a Chrome
trace are microseconds on one clock for host and device events.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from typing import Iterator

WINDOW = "gpubench.window"
CALL = "gpubench.call"
DRAW = "gpubench.draw"   # the harness's own work between calls
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_HOST_CATS = {"cpu_op", "operator", "cuda_runtime", "runtime", "cuda_driver",
              "user_annotation"}


@contextlib.contextmanager
def profiled(path: str) -> Iterator[None]:
    """Profile the block's host and device activity and write its Chrome
    trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A host span the trace keeps under ``name``."""
    from torch.profiler import record_function

    return record_function(name)


def _merge(spans: list) -> list:
    spans = sorted(spans)
    out: list = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _overlap(merged: list, starts: list, a: float, b: float) -> float:
    """Length of [a, b] covered by the sorted, disjoint ``merged`` spans."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces left anonymous
    and argument list; a copy's or any other operation's name as it is."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
        depth = 0
        for i, ch in enumerate(name):
            if ch == "<":
                depth += 1
            elif ch == ">":
                depth -= 1
            elif ch == "(" and depth == 0:
                name = name[:i]
                break
    return name[:96]


class Trace:
    """The events of one exported Chrome trace."""

    def __init__(self, events: list):
        self.device_events = []   # (device, start, end, name)
        host = []
        windows, calls = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            a = float(e["ts"])
            b = a + float(e["dur"])
            if cat in _DEVICE_CATS:
                args = e.get("args") or {}
                dev = args.get("device", e.get("pid"))
                self.device_events.append((int(dev), a, b, str(e.get("name", ""))))
            elif cat in _HOST_CATS:
                name = str(e.get("name", ""))
                if name == WINDOW:
                    windows.append((a, b, e.get("tid")))
                elif name == CALL:
                    calls.append((a, b))
                host.append((a, b, name, e.get("tid")))
        if not windows:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        self.window = max(windows, key=lambda w: w[1] - w[0])
        w0, w1, tid = self.window
        self.calls = sorted(c for c in calls if w0 <= c[0] and c[1] <= w1)
        self.host = [h for h in host if h[3] == tid]
        per_dev = defaultdict(list)
        for dev, a, b, _ in self.device_events:
            if min(b, w1) > max(a, w0):
                per_dev[dev].append((max(a, w0), min(b, w1)))
        self.busy = {d: _merge(v) for d, v in per_dev.items()}
        self.any_busy = _merge([tuple(s) for v in self.busy.values() for s in v])
        self._any_starts = [s[0] for s in self.any_busy]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    # -- readings, in seconds ------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self, device: int) -> float:
        return sum(b - a for a, b in self.busy.get(device, [])) * 1e-6

    def mean_busy_s(self, devices: list) -> float:
        return sum(self.busy_s(d) for d in devices) / len(devices)

    def kernel_s(self, match: str) -> float:
        """Summed duration, over every card, of the device operations whose
        name holds ``match``, inside the window."""
        w0, w1, _ = self.window
        return sum(
            max(0.0, min(b, w1) - max(a, w0))
            for _, a, b, name in self.device_events if match in name
        ) * 1e-6

    def device_busy_within_s(self, a: float, b: float) -> float:
        """Seconds of [a, b] (trace microseconds) in which any card ran
        something."""
        return _overlap(self.any_busy, self._any_starts, a, b) * 1e-6

    def call_split_quantiles(self) -> dict:
        """Quantiles (5, 50, 90, 95, 99, 100) over the window's calls of
        each call's device-busy ms and of the rest of its span."""
        import numpy as np

        if not self.calls:
            return {}
        busy = [1e3 * self.device_busy_within_s(a, b) for a, b in self.calls]
        host = [(b - a) * 1e-3 - x for (a, b), x in zip(self.calls, busy)]
        q = [5, 50, 90, 95, 99, 100]
        return {
            "call_busy_ms_quantiles": [round(float(v), 4) for v in np.percentile(busy, q)],
            "call_host_ms_quantiles": [round(float(v), 4) for v in np.percentile(host, q)],
        }

    def top_device_ops(self, k: int = 10) -> list:
        w0, w1, _ = self.window
        total: dict = defaultdict(float)
        for _, a, b, name in self.device_events:
            d = min(b, w1) - max(a, w0)
            if d > 0:
                total[short_name(name)] += d * 1e-6
        return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])[:k]

    def _host_segments(self) -> list:
        """The window's thread as disjoint (start, end, name) pieces, each
        named by the innermost host event that holds it."""
        segs, stack, cur = [], [], None
        for a, b, name, _ in sorted(self.host, key=lambda h: (h[0], -h[1])):
            if name == WINDOW:
                continue
            while stack and stack[-1][0] <= a:
                end, top = stack.pop()
                if cur is not None and end > cur:
                    segs.append((cur, end, top))
                    cur = end
            if stack and cur is not None and a > cur:
                segs.append((cur, a, stack[-1][1]))
            cur = a if cur is None else max(cur, a)
            stack.append((b, name))
        while stack:
            end, top = stack.pop()
            if end > cur:
                segs.append((cur, end, top))
                cur = end
        return segs

    def idle_gaps(self, k: int = 10) -> list:
        """Seconds in which no card ran anything, split by what the host's
        innermost event was meanwhile ("host" where it was in none), the
        largest ``k``."""
        w0, w1, _ = self.window
        gaps, t = [], w0
        for a, b in self.any_busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        segs = self._host_segments()
        total: dict = defaultdict(float)
        i = 0
        for a, b in gaps:
            named = 0.0
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                lo, hi = max(segs[j][0], a), min(segs[j][1], b)
                if hi > lo:
                    total[segs[j][2]] += (hi - lo) * 1e-6
                    named += hi - lo
                j += 1
            if b - a > named:
                total["host"] += (b - a - named) * 1e-6
        return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])[:k]
