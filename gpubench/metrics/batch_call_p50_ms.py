"""The median of every call's wall time in the window (host clock, linear
interpolation between order statistics): how long a batch job's typical
call takes, its deepest board's chain and the engine's host work."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([(c[1] - c[0]) * 1e3 for c in run.calls], 50))
