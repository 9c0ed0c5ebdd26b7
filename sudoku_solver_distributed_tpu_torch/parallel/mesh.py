"""The device mesh: an ordered 1-D tuple of shards on one ``data`` axis.

The port of ``sudoku_solver_distributed_tpu/parallel/mesh.py``. Puzzle
batches (parallel/shard.py) and a race's seeded states
(parallel/frontier.py) are split along the one axis, shard ``i`` taking the
``i``-th row block. A shard is a ``torch.device`` and, on CUDA, a stream of
its own, so the shards' launches overlap.

``default_mesh()`` spans every visible CUDA device, each once. The
environment variable ``SUDOKU_VIRTUAL_MESH`` (``"N"`` or ``"N@device"``,
set by parallel/sim.py for its child interpreters) replaces that with
``virtual_mesh(device, N)``: N shards on one device, each with its own
stream, the analog of the JAX package's
``--xla_force_host_platform_device_count``. It is read here and nowhere
else. A mesh that names one device more than once is only ever built by
``virtual_mesh``: ``Mesh`` and ``default_mesh`` refuse repeats.

``data_sharding`` and ``replicated`` are plain descriptors of how an array
lies on a mesh (split on its leading axis, or whole on every shard); the
programs of parallel/shard.py and utils/checkpoint.py read them.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import torch

VIRTUAL_MESH_ENV = "SUDOKU_VIRTUAL_MESH"


class Mesh:
    """An ordered 1-D mesh of shards on the ``data`` axis.

    ``devices`` are the shards' devices in shard order; ``streams`` their
    CUDA streams (None for a CPU shard), made at construction. Two meshes
    are the same mesh only if they are the same object: the programs built
    over a mesh are memoized on it, as the JAX package memoizes on its
    ``Mesh``."""

    axis_names = ("data",)

    def __init__(self, devices: Sequence, *, virtual: bool = False):
        devs = tuple(torch.device(d) for d in devices)
        devs = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in devs
        )
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {devs}")
        if not virtual and len(set(devs)) != len(devs):
            raise ValueError(
                f"mesh devices repeat ({[str(d) for d in devs]}): a mesh of "
                "several shards on one device is built by virtual_mesh only"
            )
        for d in devs:
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"a mesh runs on cuda or cpu devices, not {d}")
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; build the mesh over 'cpu' "
                    "to run the plain PyTorch solver"
                )
        self.devices = devs
        self.virtual = bool(virtual)
        self.streams = tuple(
            torch.cuda.Stream(d) if d.type == "cuda" else None for d in devs
        )

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """Shard 0's device: where a mesh program gathers its outputs."""
        return self.devices[0]

    @property
    def distinct_devices(self) -> tuple:
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        kind = "virtual_mesh" if self.virtual else "Mesh"
        return f"{kind}({[str(d) for d in self.devices]}, axis='data')"


def virtual_mesh(device, n: int) -> Mesh:
    """``n`` shards on the one ``device``, each with its own CUDA stream on
    a card: the port's counterpart of a fake-device mesh. Every splitting,
    padding, per-shard launch and cross-shard fold runs for real; the
    shards share the device's memory and SMs."""
    if int(n) < 1:
        raise ValueError(f"a virtual mesh needs n >= 1 shards, got {n}")
    return Mesh([device] * int(n), virtual=True)


def virtual_mesh_setting() -> Optional[tuple]:
    """``(n, device)`` from ``SUDOKU_VIRTUAL_MESH`` (``"N"`` or
    ``"N@device"``; the device defaults to ``cuda:0``), or None when it is
    unset or empty."""
    raw = os.environ.get(VIRTUAL_MESH_ENV, "").strip()
    if not raw:
        return None
    n, _, device = raw.partition("@")
    try:
        count = int(n)
    except ValueError:
        raise ValueError(
            f"{VIRTUAL_MESH_ENV}={raw!r}: want N or N@device"
        ) from None
    if count < 1:
        raise ValueError(f"{VIRTUAL_MESH_ENV}={raw!r}: N must be >= 1")
    return count, torch.device(device or "cuda:0")


def default_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D ``data`` mesh over the given devices, else every visible
    CUDA device once, else the virtual mesh ``SUDOKU_VIRTUAL_MESH`` names
    (which takes the place of the visible devices when it is set). Raises
    without a CUDA device when none is given and no virtual mesh is set."""
    if devices is not None:
        return Mesh(devices)
    setting = virtual_mesh_setting()
    if setting is not None:
        n, device = setting
        return virtual_mesh(device, n)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for the default mesh; pass devices "
            "(e.g. virtual_mesh('cpu', n)) to run the plain PyTorch solver"
        )
    return Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])


class DataSharding(NamedTuple):
    """The leading (batch / frontier-state) axis split over ``data``:
    shard ``i`` holds the ``i``-th of ``mesh.size`` equal row blocks."""

    mesh: Mesh
    axis: str = "data"


class Replicated(NamedTuple):
    """The whole array on every shard."""

    mesh: Mesh


def data_sharding(mesh: Mesh) -> DataSharding:
    """Shard the leading (batch / frontier-state) axis over ``data``."""
    return DataSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
