"""The one generator of batch traffic: calls drawn from a seed.

A configuration names two pools of boards, ``hard`` and ``deep``. A mix
names a call's width and how many of its boards are deep. Each pool is
dealt out in cycles: cycle ``j`` of a pool is a seeded permutation of the
whole pool, and the calls take the pool's boards in that order, call after
call. So every seed deals every board of a pool equally often, cycle for
cycle, and only the order and the grouping of boards into calls differ
from seed to seed: the same work in another order. ``deep_per_call`` slots
of each call, at seeded positions, hold the next deep boards dealt; the
other slots the next hard boards dealt. No board is transformed. A seeded
draw also marks a share of the calls whose every answer the check reads
(``check.full_call_share``).

Everything of call ``k`` follows from ``(seed, k)``, whichever calls were
drawn before it. A call holds where its boards come from, not the boards:
the loop draws its calls before the window opens and, in the window,
gathers each call's boards into one buffer it reuses (``Call.gather``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .catalog import Catalog

_CALL_STREAM = 1
_CHECK_STREAM = 2
_HARD_STREAM = 3
_DEEP_STREAM = 4


def seed_words(seed: int, *more: int) -> list:
    """Entropy words for numpy's SeedSequence from a seed of any size or
    sign (two's complement within 64 bits)."""
    return [int(seed) & (2 ** 64 - 1), *more]


def load_pools(catalog: Catalog, config: dict) -> dict:
    """The configuration's pools as (P, N, N) int32 arrays, by role."""
    pools = {}
    n = config["board_size"]
    for role, rel in config["pools"].items():
        with np.load(catalog.path(rel)) as z:
            boards = np.ascontiguousarray(z["boards"], dtype=np.int32)
        if boards.ndim != 3 or boards.shape[1:] != (n, n):
            raise ValueError(f"pool {rel} holds {boards.shape}, not (P, {n}, {n})")
        pools[role] = boards
    return pools


@dataclass
class Call:
    """Where one call's boards come from."""

    index: int
    pool: np.ndarray        # (P, N, N) both pools, hard then deep (shared)
    src: np.ndarray         # (W,) int32 index into ``pool``, a slot each
    n_hard: int             # the hard pool's size: ``pool``'s first rows
    deep_pos: np.ndarray    # (D,) slots holding deep boards
    deep_idx: np.ndarray    # (D,) index into the deep pool
    full_check: bool        # every answer of this call is checked

    @property
    def hard_idx(self) -> np.ndarray:
        """(W,) index into the hard pool, -1 in a deep slot."""
        return np.where(self.src < self.n_hard, self.src, -1)

    @property
    def boards(self) -> np.ndarray:
        """The call's (W, N, N) int32 boards, a new array."""
        return self.pool.take(self.src, axis=0)

    def gather(self, out: np.ndarray) -> np.ndarray:
        """The call's boards written into ``out``, a (W, N, N) int32 buffer
        (``mode="clip"`` skips numpy's buffered copy; every index is in
        range by construction)."""
        return np.take(self.pool, self.src, axis=0, out=out, mode="clip")


class _Dealer:
    """A pool dealt out in seeded cycles, each a permutation of the pool."""

    def __init__(self, size: int, seed: int, stream: int):
        self.size, self.seed, self.stream = size, seed, stream
        self._cycles: dict = {}

    def _cycle(self, j: int) -> np.ndarray:
        perm = self._cycles.get(j)
        if perm is None:
            if len(self._cycles) > 2:
                self._cycles.pop(min(self._cycles))
            rng = np.random.default_rng(seed_words(self.seed, self.stream, j))
            perm = self._cycles[j] = rng.permutation(self.size)
        return perm

    def deal(self, start: int, count: int) -> np.ndarray:
        """Entries ``start`` .. ``start + count`` of the dealt sequence."""
        out = np.empty(count, dtype=np.int64)
        done = 0
        while done < count:
            j, at = divmod(start + done, self.size)
            take = min(count - done, self.size - at)
            out[done: done + take] = self._cycle(j)[at: at + take]
            done += take
        return out


class BatchPlan:
    """The seeded calls of a batch mix over a configuration's pools."""

    def __init__(self, pools: dict, traffic: dict, seed: int):
        self.hard = pools["hard"]
        self.deep = pools["deep"]
        self.width = int(traffic["width"])
        self.deep_per_call = int(traffic["deep_per_call"])
        if not 0 <= self.deep_per_call <= self.width:
            raise ValueError("deep_per_call must lie in 0..width")
        self.full_share = float(traffic["check"]["full_call_share"])
        self.seed = int(seed)
        # one array of both pools, so a call's boards are one gather
        self._pool = np.concatenate([self.hard, self.deep])
        self._hard = _Dealer(len(self.hard), self.seed, _HARD_STREAM)
        self._deep = _Dealer(len(self.deep), self.seed, _DEEP_STREAM)

    def call(self, k: int) -> Call:
        rng = np.random.default_rng(seed_words(self.seed, _CALL_STREAM, k))
        d = self.deep_per_call
        deep_pos = np.sort(rng.choice(self.width, d, replace=False))
        full = bool(rng.random() < self.full_share)
        deep_idx = self._deep.deal(k * d, d)
        hard_slots = np.ones(self.width, dtype=bool)
        hard_slots[deep_pos] = False
        src = np.empty(self.width, dtype=np.int32)
        src[hard_slots] = self._hard.deal(k * (self.width - d), self.width - d)
        src[deep_pos] = len(self.hard) + deep_idx
        return Call(k, self._pool, src, len(self.hard), deep_pos, deep_idx, full)

    def buffer(self) -> np.ndarray:
        """A (W, N, N) int32 buffer for ``Call.gather``."""
        return np.empty((self.width, *self._pool.shape[1:]), dtype=np.int32)

    def check_rng(self) -> np.random.Generator:
        """The seeded stream the check draws its reference sample from."""
        return np.random.default_rng(seed_words(self.seed, _CHECK_STREAM))
