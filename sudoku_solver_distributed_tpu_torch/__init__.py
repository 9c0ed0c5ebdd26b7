"""sudoku_solver_distributed_tpu_torch — the PyTorch/CUDA port of
``sudoku_solver_distributed_tpu``.

The same ``/solve`` / ``/stats`` / ``/network`` HTTP surface and the same
per-board search as the JAX package, with the device solver a CUDA kernel
written for NVIDIA Hopper (csrc/dfs_solver.cu) instead of a Pallas kernel
for the TPU. The JAX package stays the reference: this package imports
neither ``jax`` nor anything of it, and its tests hold it against it.

Layout (mirrors the JAX package):
  ops/       board encoding, validation, propagation, the plain solver and
             the CUDA kernel's wrapper (ops/cuda_solver.py)
  csrc/      the CUDA C++ kernel sources, built at first use
  engine.py  SolverEngine: bucketed batch solving behind the kernel
  parallel/  the request coalescer (closed loop and continuous segments)
  cache/     the canonical-form answer cache of the /solve front door
  serving/   admission control, deadlines, load estimation and engine
             supervision (watchdog, breaker, oracle fallback)
  obs/       observability: request spans, the device cost plane, SLO
             burn rates, the flight recorder, trace export, Prometheus
  models/    the trusted host-side oracle solver
  net/       wire protocol, membership, stats gossip, node, HTTP API and
             its two transports (fastserve.py, the default, and the stdlib
             server), the reference's SudokuSolver surface, CLI
  utils/     handicap rate limiter, board rendering, fault injectors,
             request metrics, torch.profiler traces and spans
  api.py     the ``Sudoku`` host-facing class (reference sudoku.py surface)

``Sudoku`` and ``SudokuSolver`` are importable from the package itself;
they load on first use, so importing the package stays light.

Entry points run on the GPU unless the caller asks for the CPU
(``SolverEngine(device="cpu")``, the CLI's ``--platform cpu``, or a CPU
tensor handed to the solver); with no GPU and no such request they raise.
"""

__version__ = "0.1.0"

__all__ = ["Sudoku", "SudokuSolver"]


def __getattr__(name):
    if name == "Sudoku":
        from .api import Sudoku

        return Sudoku
    if name == "SudokuSolver":
        from .net.solver_api import SudokuSolver

        return SudokuSolver
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
