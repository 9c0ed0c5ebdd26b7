"""Boards returned by every call of the window, over the whole window
(host clock)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c[2] for c in run.calls) / run.window_s
