"""K1's share of its roofline in the traced window, in %: the least time of
the window's K1 work (harness/bounds.py: the analysis sweeps the calls
report, and their boards' bytes) over K1's summed kernel time on every card
in the trace."""

from gpubench.harness.bounds import k1_bound_s
from gpubench.harness.runner import K1_NAME


def read(run):
    tr = run.trace
    if tr is None or not run.calls:
        return None
    k1_s = tr.kernel_s(K1_NAME)
    if k1_s <= 0:
        return None
    sweeps = sum(c[3] for c in run.calls)
    boards = sum(c[2] for c in run.calls)
    bound_s, by = k1_bound_s(sweeps, boards, run.cells, run.locked)
    run.context["k1_bound_by"] = by
    run.context["k1_kernel_s"] = k1_s
    run.context["k1_bound_s"] = bound_s
    return 100.0 * bound_s / k1_s
