"""The engine's host time a call: each ``gpubench.call`` span of the traced
window less the time inside it in which any card ran a kernel or a copy,
the mean over the window's calls, in ms."""


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    host = [(b - a) * 1e-6 - tr.device_busy_within_s(a, b) for a, b in tr.calls]
    return 1e3 * sum(host) / len(host)
