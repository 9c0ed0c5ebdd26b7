"""The card-idle time a call spends finalizing, in ms: as
``launch_idle_ms_per_call.batch`` over the program's ``engine.wait``,
``engine.rows``, ``engine.rerun``, ``engine.cost``, ``engine.deep_retry``
and ``engine.merge`` spans. A program without the spans reads nothing."""

from gpubench.harness.stages import FINALIZE, idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, FINALIZE)
