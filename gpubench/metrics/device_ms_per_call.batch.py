"""The card's time a call by its own clock, in ms: the window's growth of
the engine's cost plane ``gpu_s`` over the window's calls. ``gpu_s`` is the
engine's event-timed stage span (obs/cost.py): CUDA events from before a
one-card call's boards are copied to the card to after its rows are copied
back, and around each rerun and deep retry, so it holds any time the stream
waits on the host inside a stage. Its growth by stage
(``first``, ``rerun``, ``deep_retry``), in ms a call, and the trace's
device-busy ms inside a call go to the run's context. A program whose cost
plane has no ``gpu_s`` reads nothing."""


def read(run):
    if not run.calls or "gpu_s" not in run.cost_after:
        return None
    n = len(run.calls)
    before = run.cost_before.get("gpu_s_by_stage", {})
    run.context["device_ms_per_call_by_stage"] = {
        k: 1e3 * (v - before.get(k, 0.0)) / n
        for k, v in run.cost_after["gpu_s_by_stage"].items()
    }
    tr = run.trace
    if tr is not None and tr.calls:
        run.context["trace_busy_ms_per_call"] = 1e3 * sum(
            tr.device_busy_within_s(a, b) for a, b in tr.calls) / len(tr.calls)
    gpu_s = run.cost_after["gpu_s"] - run.cost_before.get("gpu_s", 0.0)
    return 1e3 * gpu_s / n
