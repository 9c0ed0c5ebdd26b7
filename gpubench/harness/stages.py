"""The engine's stage spans in a traced window, and the card's idle time in
each.

The program marks each stage of a ``solve_batch_np`` call with a host span
(``engine.pad``, ``engine.h2d``, ... ``engine.merge``: the port's
``utils/profiling.py`` lists them), on the clock of the card's kernels and
copies. Here each ``gpubench.call`` of the window is split into its
outermost stage spans (a deep retry's own stages count to the retry), and
each stage's time in which no card ran anything is summed, in ms a call.
A program without the spans gives no stages, and the readers read nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "engine."
LAUNCH = ("engine.pad", "engine.h2d", "engine.launch")
FINALIZE = ("engine.wait", "engine.rows", "engine.rerun", "engine.cost",
            "engine.deep_retry", "engine.merge")


def _outermost(spans: list) -> list:
    """The spans no other span holds, in order (siblings do not overlap;
    a span nested in another starts before that one ends)."""
    out, end = [], float("-inf")
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        if a >= end:
            out.append((a, b, name))
            end = b
    return out


def idle_by_stage(trace) -> dict:
    """``{stage: card-idle ms a call}`` over the window's calls, and under
    ``None`` the card-idle ms a call inside a call but in no stage span;
    empty where the window holds no stage span."""
    spans = [(a, b, name) for a, b, name, _ in trace.host
             if name.startswith(PREFIX)]
    if not spans or not trace.calls:
        return {}
    stages = _outermost(spans)
    starts = [s[0] for s in stages]
    idle: dict = defaultdict(float)
    for c0, c1 in trace.calls:
        staged = 0.0
        i = bisect.bisect_left(starts, c0)
        while i < len(stages) and stages[i][1] <= c1:
            a, b, name = stages[i]
            gap = (b - a) * 1e-6 - trace.device_busy_within_s(a, b)
            idle[name] += gap
            staged += gap
            i += 1
        whole = (c1 - c0) * 1e-6 - trace.device_busy_within_s(c0, c1)
        idle[None] += whole - staged
    n = len(trace.calls)
    return {k: 1e3 * v / n for k, v in idle.items()}


def idle_ms_per_call(run, names: tuple):
    """The card-idle ms a call inside the stage spans ``names``, or None
    where the window holds no stage span. Puts the whole split, by stage,
    in ``run.context``."""
    if run.trace is None:
        return None
    split = idle_by_stage(run.trace)
    if not split:
        return None
    run.context["idle_ms_per_call_by_stage"] = {
        k: v for k, v in split.items() if k is not None}
    run.context["idle_ms_per_call_unstaged"] = split.get(None, 0.0)
    return sum(v for k, v in split.items() if k in names)
