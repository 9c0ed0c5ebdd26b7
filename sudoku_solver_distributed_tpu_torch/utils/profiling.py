"""Request metrics, device traces and named spans for ``torch.profiler``.

The port of ``sudoku_solver_distributed_tpu/utils/profiling.py``:

  * ``RequestMetrics`` — the per-route latency recorder (count / errors /
    shed / p50 / p95 / p99 / max) behind the ``/metrics`` route blocks,
    an alias of ``obs.histo.RouteMetrics``: one recording machinery for
    route and stage latency.
  * ``device_trace`` — a ``torch.profiler`` capture (CPU and CUDA
    activities) of a code region, written as a Chrome / TensorBoard trace
    into a directory; the counterpart of the JAX package's
    ``jax.profiler.trace``. The engine wires it to the CLI's
    ``--device-trace-dir`` and ``--profile-dir``.
  * ``annotate`` — a named host span in any active ``torch.profiler``
    trace, the counterpart of ``jax.profiler.TraceAnnotation``.

Span naming on the coalesced serving path (parallel/coalescer.py), so a
trace separates host scheduling from device time:

  * ``coalescer_dispatch_b<N>`` — dispatcher thread: stack/pad a batch of N
    requests and enqueue its device work;
  * ``coalescer_device_wait`` — completion thread: waiting for the
    in-flight batch's rows (device compute + transfer; overlaps the NEXT
    batch's dispatch span when the pipeline is full);
  * ``coalescer_segment_a<N>`` — the segment loop: one segment with N
    lanes holding a request.

Span naming on the bucket path (engine.py), so each idle gap of the card
in a capture can be put down to an engine stage. A ``solve_batch_np``
call runs these stages one after another, without overlap:

  * ``engine.pad`` — bucket choice, the supervisor's token, the fault
    seam, the pad rows;
  * ``engine.h2d`` — the boards into pinned memory and their copy to the
    card;
  * ``engine.launch`` — the first depth stage's kernel and ops enqueued,
    and the copy of its rows to the host;
  * ``engine.wait`` — waiting for those rows (the stage's device time);
  * ``engine.rows`` — the rows copied out and the OVERFLOW test;
  * ``engine.rerun`` — one deeper depth stage of the OVERFLOW boards;
  * ``engine.cost`` — the cost-plane record and the RUNNING test;
  * ``engine.deep_retry`` — the RUNNING boards' deep retry (its own
    ``engine.h2d`` … ``engine.rerun`` inside);
  * ``engine.merge`` — the chunks' rows joined and the counters folded.

The coalescer's threads run the same stages except ``engine.merge``,
below their ``coalescer_*`` spans. A span shows only in a capture that records
on the thread while it runs. The engine's own captures
(``--device-trace-dir``, ``--profile-dir``, ``arm_device_trace``) record
only around a bucket call's launch, so they hold ``engine.h2d`` and
``engine.launch`` inside ``solve_bucket_<N>``; every stage shows in a
capture that wraps whole calls, such as a benchmark's traced window.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from ..obs.histo import RouteMetrics as RequestMetrics  # noqa: F401


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region into ``log_dir``
    (no-op if None): one ``trace-<pid>-<ns>.pt.trace.json`` per capture,
    Chrome trace-event JSON that Perfetto and TensorBoard open. CUDA
    activity is recorded when a card is present; the region's device work
    is waited for before the capture stops, so kernels it enqueued land
    in the trace. Only one capture may be active in a process (the
    engine's profile mutex serializes them). Keep regions short."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json")
    )


# whether a torch.profiler capture records on this thread (the profiler's
# state is per thread); a build without the check records every span
_profiler_on = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)
# the range a span records: the profiler's RecordFunction entered from C++
# where the build has it (~2 µs a span under a capture, where
# ``torch.profiler.record_function``'s op calls take ~15; it shows as a
# ``cpu_op`` event), else ``record_function``
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Named span in any active profiler trace (host timeline): a
    RecordFunction range while a capture records on this thread, else one
    shared no-op context, so a span costs one flag check when nothing
    records (no RecordFunction, no generator)."""
    if not _profiler_on():
        return _OFF
    if _range is None:
        return torch.profiler.record_function(name)
    return _range(name)
