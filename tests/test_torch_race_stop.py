"""The stop and the fold of the port's race across shards, on the CPU.

Where a race across shards keeps its stop is chosen from the topology of
its shards' devices (``ops/cuda_solver.race_layout``), here on faked
topologies; the real one is read on the card (tests/test_torch_isolation.py
and chip_smoke.py phase 13). The whole race across shards with its fold
(``dfs_race_shards(..., fold=True)`` on CPU shards: each shard's plain
runs, then ``fold_race`` over them all) is held to the JAX package's mesh
racer over its 8 CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sudoku_solver_distributed_tpu.ops import spec_for_size as jax_spec_for_size
from sudoku_solver_distributed_tpu.parallel import frontier as JF
from sudoku_solver_distributed_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sudoku_solver_distributed_tpu_torch.ops import solver as TS
from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import (
    KernelLaunchError,
    _alloc_race_slots,
    dfs_race_shards,
    race_layout,
)
from sudoku_solver_distributed_tpu_torch.parallel import frontier as TF
from sudoku_solver_distributed_tpu_torch.parallel.mesh import virtual_mesh

README = np.zeros((9, 9), np.int32)
for (r, c), v in {(0, 3): 1, (1, 3): 3, (1, 4): 2, (2, 5): 9, (3, 7): 7, (5, 3): 9,
                  (6, 6): 9, (7, 8): 3}.items():
    README[r, c] = v
DEEP16 = np.load("benchmarks/corpus_16x16_deep_anneal_64.npz")["boards"]


def _cards(*indices):
    return [torch.device("cuda", i) for i in indices]


def _peers(missing=()):
    """A topology where every two cards reach each other but the ordered
    pairs in ``missing``."""
    return lambda a, b: (a, b) not in set(missing)


@pytest.mark.parametrize("devices, missing, want", [
    (_cards(0, 0, 0, 0), (), "device"),          # a virtual mesh: one card
    (_cards(0), (), "device"),
    (_cards(0, 1, 2, 3), (), "peer"),             # NVLink all to all
    (_cards(2, 0), (), "peer"),
    (_cards(0, 1, 2, 3), ((1, 3), (3, 1)), "host"),  # one pair without
    (_cards(0, 1), ((1, 0),), "host"),            # peer access one way only
    (_cards(0, 1, 2, 3), ((0, 0), (4, 5)), "peer"),  # pairs that are not cards
])
def test_stop_layout_follows_the_topology(devices, missing, want):
    asked = []

    def can_access_peer(a, b):
        asked.append((a, b))
        return _peers(missing)(a, b)

    assert race_layout(devices, can_access_peer) == want
    cards = list(dict.fromkeys(d.index for d in devices))
    # every ordered pair of distinct cards is asked, until one says no
    assert set(asked) <= {(a, b) for a in cards for b in cards if a != b}
    if want == "peer":
        assert len(asked) == len(cards) * (len(cards) - 1)
    if len(cards) == 1:
        assert asked == []


class _PeerLibrary:
    """Stands in for the kernel library when a race's stop is allocated:
    records the cards it is asked to join and returns ``error``."""

    def __init__(self, error=0):
        self.error = error
        self.enabled = []

    def dfs_race_max_shards(self):
        return 16

    def dfs_race_peer_enable(self, n, devices):
        self.enabled.append(list(devices[:n]))
        return self.error


def test_a_peer_layout_whose_enable_fails_raises():
    """Cards that report peer access but whose enable fails raise
    ``KernelLaunchError``; nothing falls back to host memory."""
    lib = _PeerLibrary(error=217)  # cudaErrorPeerAccessUnsupported
    with pytest.raises(KernelLaunchError, match="peer access"):
        _alloc_race_slots(lib, _cards(1, 0, 3, 2), _peers())
    assert lib.enabled == [[1, 0, 3, 2]]
    with pytest.raises(ValueError, match="at most 16"):
        _alloc_race_slots(lib, _cards(*range(17)), _peers())


def test_a_one_card_stop_is_one_set_of_words():
    """Every shard of a one-device mesh shares one set of idle words."""
    slots = _alloc_race_slots(_PeerLibrary(), [torch.device("cpu")] * 4, _peers())
    assert slots.layout == "device" and slots.n == 4
    assert all(w is slots.words[0] for w in slots.words)
    assert slots.words[0].view(torch.uint32)[0].item() == 0xFFFFFFFF
    assert slots.words[0][1:].tolist() == [0, 0]
    assert (slots.address, slots.host) == (0, 0)


@pytest.mark.parametrize("size, board, per_shard, shards", [
    (9, README, 8, 8), (9, README, 16, 4), (9, README, 4, 2), (16, DEEP16[0], 1, 8),
    (16, DEEP16[0], 2, 4),
])
def test_race_across_cpu_shards_with_its_fold_matches_jax(size, board, per_shard, shards):
    """The race across shards with its fold on CPU shards (each shard's
    own runs, then ``fold_race`` over every shard's records) against the
    JAX package's mesh racer over as many of its CPU devices on the same
    padded states: the packed row exactly; the fold and the records are
    those of the plain race across the CPU mesh."""
    cfg = dict(locked_candidates=True, waves=3 if size == 9 else 1, naked_pairs=False)
    spec = spec_for_size(size)
    states, early = TF.seed_frontier(board, spec, target=shards * per_shard, locked=True,
                                     device="cpu")
    assert early is None
    states = TF.bucket_states(states, spec, per_shard, shards).numpy()
    M, C = len(states), spec.cells
    flat = torch.from_numpy(np.ascontiguousarray(states.reshape(M, C)))
    per = M // shards
    parts = [flat[i * per:(i + 1) * per].contiguous() for i in range(shards)]
    row, fold, meta = dfs_race_shards(parts, spec, spec.max_depth, JF.DEFAULT_MAX_ITERS,
                                      fold=True, **cfg)
    prow, pfold, pmeta = TF.race_on_mesh(states, virtual_mesh("cpu", shards), spec,
                                         spec.max_depth, JF.DEFAULT_MAX_ITERS, **cfg)
    assert torch.equal(row, prow) and torch.equal(fold, pfold) and torch.equal(meta, pmeta)
    jmesh = jax_default_mesh(jax.devices()[:shards])
    racer = JF._make_racer(jmesh, jax_spec_for_size(size), JF.DEFAULT_MAX_ITERS,
                           spec.max_depth, True, cfg["waves"], False)
    assert np.array_equal(row.numpy(), np.asarray(racer(jnp.asarray(states))))
    assert bool(row[C]) and bool((fold[:, 0] == TS.SOLVED).any())
