"""The card-idle time a call spends launching, in ms: inside each
``gpubench.call`` of the traced window, the time in the program's
``engine.pad``, ``engine.h2d`` and ``engine.launch`` spans in which no card
ran a kernel or a copy, summed, over the window's calls. The split by stage
and the idle time in no stage span go to the run's context. A program
without the spans reads nothing."""

from gpubench.harness.stages import LAUNCH, idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, LAUNCH)
