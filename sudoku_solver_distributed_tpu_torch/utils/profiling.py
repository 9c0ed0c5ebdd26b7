"""Named spans for a ``torch.profiler`` trace.

``annotate`` marks a host region so it shows as a named span in any
active ``torch.profiler`` trace, the counterpart of the JAX package's
``jax.profiler.TraceAnnotation`` passthrough. The coalesced serving path
(parallel/coalescer.py) names its spans so a trace separates host
scheduling from device time:

  * ``coalescer_dispatch_b<N>`` — dispatcher thread: stack/pad a batch of N
    requests and enqueue its device work;
  * ``coalescer_device_wait`` — completion thread: waiting for the
    in-flight batch's rows (device compute + transfer; overlaps the NEXT
    batch's dispatch span when the pipeline is full).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span in any active profiler trace (host timeline)."""
    with torch.profiler.record_function(name):
        yield
