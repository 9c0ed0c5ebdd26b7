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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span in any active profiler trace (host timeline)."""
    with torch.profiler.record_function(name):
        yield
