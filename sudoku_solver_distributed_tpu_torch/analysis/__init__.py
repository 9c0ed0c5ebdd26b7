"""graftcheck for the PyTorch/CUDA package: AST-based static analyzers
gating this package's tree.

The package is a threaded serving system: a dozen
``threading.Lock``/``Condition`` instances across the node, coalescer,
admission and membership layers, a CUDA device hot path whose kernels
are launched through ctypes and whose results come back through pinned
host copies, and a hand-rolled UDP/HTTP JSON protocol whose producers
and consumers can silently drift. These analyzers mechanically prove
the invariants the serving code established by hand, so the next
cross-thread or cross-host feature cannot quietly regress them.

Five analyzers, all stdlib-``ast``, no third-party deps, no imports of
the code under analysis (pure source analysis — safe to run anywhere,
including hosts without torch or a CUDA toolkit). They share one
parsed-AST pass and one inter-procedural call graph (``callgraph.py``),
built once per run by the runner:

  * ``locks``  — lock-discipline: lock-order cycles (per-class AND
                 cross-class along call-graph edges), blocking calls
                 (device syncs and collectives included) while holding
                 a lock, condition-on-foreign-lock, guarded-attribute
                 write races (LOCK1xx).
  * ``torch``  — serving-path torch hygiene: implicit host syncs on
                 device tensors, pinned copies read before their event,
                 per-call kernel builds or loads, reuse of a consumed
                 ``SegmentPool`` (TORCH1xx).
  * ``wire``   — wire-protocol drift: the key sets each ``wire.py``
                 constructor produces vs the keys each UDP handler
                 consumes, per message ``type`` (WIRE1xx); consumer
                 modules are auto-discovered from the call graph.
  * ``seams``  — dispatch-contract coverage: every route-core →
                 kernel-launch path, per dispatch shape, must carry
                 supervision, trace, cost, deadline and fallback legs
                 (SEAM1xx); also emits the five-shape contract matrix
                 (``--json``).
  * ``thread`` — thread-context hazards: expensive or indefinitely
                 blocking work reachable on singleton loop threads
                 (UDP loop, coalescer drivers, watchdog) (THREAD1xx).

Usage::

    python -m sudoku_solver_distributed_tpu_torch.analysis            # report
    python -m sudoku_solver_distributed_tpu_torch.analysis --strict   # gate

Library API::

    from sudoku_solver_distributed_tpu_torch import analysis
    findings = analysis.run_analyzers(analysis.default_config())

Suppression is ONLY via the committed baseline file
(``analysis/baseline.toml``): new violations fail ``--strict`` while
baselined ones stay visible debt, each entry carrying an in-file
``reason``. There are no inline suppression comments by design.
"""

from __future__ import annotations

from .findings import (  # noqa: F401
    BaselineEntry,
    Finding,
    apply_baseline,
    load_baseline,
)
from .runner import (  # noqa: F401
    AnalysisResult,
    Config,
    default_config,
    run_analysis,
    run_analyzers,
)

__all__ = [
    "AnalysisResult",
    "BaselineEntry",
    "Config",
    "Finding",
    "apply_baseline",
    "default_config",
    "load_baseline",
    "run_analysis",
    "run_analyzers",
]
