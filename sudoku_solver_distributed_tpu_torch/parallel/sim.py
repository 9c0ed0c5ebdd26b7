"""Virtual-mesh simulation harness: mesh code in child interpreters.

The port's own copy of ``sudoku_solver_distributed_tpu/parallel/sim.py``.
A child started here sees an ``n``-shard virtual mesh through the
environment (``SUDOKU_VIRTUAL_MESH``, read by parallel/mesh.default_mesh
alone): ``n`` shards on one device, each with its own stream, the port's
analog of ``XLA_FLAGS=--xla_force_host_platform_device_count``. The
sharded bucket and segment programs, mesh-divisible padding, the race
across shards and the serving loop's fan-out (parallel/serving_loop.py, a
one-rank or multi-rank process group) then run for real in that child; a
CLI node started this way logs its virtual shard count.

``run_py`` / ``run_json`` run a snippet with the repo root as the working
directory and on ``sys.path``; the child's stdout and stderr are merged so
a failing child's traceback is in the assertion message. The default
device is the CPU (the tests' configuration); on a card pass
``device="cuda:0"``.

Imports no torch: importing this module never touches a device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Optional

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

VIRTUAL_MESH_ENV = "SUDOKU_VIRTUAL_MESH"  # parallel/mesh.py reads it


def virtual_mesh_env(n_shards: int, *, device: str = "cpu",
                     base: Optional[dict] = None) -> dict:
    """A child process's environment for an ``n_shards``-way virtual mesh
    on ``device``: ``SUDOKU_VIRTUAL_MESH=n@device``, the repo root on
    ``PYTHONPATH``, and one intra-op thread a process, so several CPU
    children on one host do not oversubscribe its cores."""
    env = dict(os.environ if base is None else base)
    env[VIRTUAL_MESH_ENV] = f"{int(n_shards)}@{device}"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, env.get("PYTHONPATH", "")) if p
    )
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def run_py(
    code: str,
    n_shards: int,
    *,
    args: tuple = (),
    timeout: float = 600.0,
    device: str = "cpu",
    check: bool = True,
) -> subprocess.CompletedProcess:
    """Run a Python snippet in a fresh child that sees an ``n_shards``
    virtual mesh on ``device``. ``code`` receives ``args`` as
    ``sys.argv[1:]``. Returns the CompletedProcess (stderr merged into
    stdout); ``check=True`` raises with that output on a non-zero exit.
    ``timeout`` bounds the child (``subprocess.TimeoutExpired``)."""
    proc = subprocess.run(
        [sys.executable, "-c", code, *[str(a) for a in args]],
        env=virtual_mesh_env(n_shards, device=device),
        cwd=REPO_ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        timeout=timeout,
    )
    if check and proc.returncode != 0:
        raise AssertionError(
            f"virtual-mesh child (n={n_shards}) failed "
            f"rc={proc.returncode}:\n{proc.stdout[-4000:]}"
        )
    return proc


def run_json(
    code: str,
    n_shards: int,
    *,
    args: tuple = (),
    timeout: float = 600.0,
    device: str = "cpu",
) -> dict:
    """``run_py`` for children that print ONE JSON object as their last
    stdout line (everything above it is free-form progress or log output).
    Returns the parsed object."""
    proc = run_py(code, n_shards, args=args, timeout=timeout, device=device)
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    if not lines:
        raise AssertionError(
            f"virtual-mesh child (n={n_shards}) printed no output"
        )
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        raise AssertionError(
            f"virtual-mesh child (n={n_shards}) last line is not JSON:\n"
            f"{proc.stdout[-4000:]}"
        ) from None
