"""Verified canonical-form answer store: sharded, bounded, poison-proof.

A copy of ``sudoku_solver_distributed_tpu/cache/store.py``, with the
gossip surface (``get_canonical``, ``store_canonical``, ``hot_set`` and the
peer counters) that cache/gossip.py calls.

The LRU behind the front door (net/http_api.py). Entries are keyed by
the canonical hash (cache/canonical.py) and hold the CANONICAL board +
CANONICAL solution pair, so one entry serves the puzzle's whole symmetry
orbit: a hit de-canonicalizes the stored solution back through the
requester's own inverse transform.

Two verification gates make cache poisoning impossible by construction:

  * **write gate** — ``store`` re-verifies every candidate answer
    host-side (clue match + strict rule check, models/oracle.py) before
    it enters, whatever path produced it (device, fallback, farm, or a
    peer's ``cache_answer`` datagram). A wrong answer is counted and
    dropped; it never becomes cache state. This is the same host-side
    verification contract the engine supervisor (serving/health.py) applies
    to device answers
    — here it is unconditional, because a cache write outlives the
    request that produced it.
  * **hit gate** — a hit first proves the requester's board actually IS
    a symmetry of the stored entry by applying the requester's transform
    and comparing grids (never trusting hash equality), then rule-checks
    the de-canonicalized answer against the requester's clues before
    serving. A mismatch (hash collision, tie-resolution divergence, or a
    corrupted entry) reads as a miss — and drops the entry when the
    stored pair itself no longer verifies.

Sharding: the canonical hash picks one of ``shards`` independent
LRU segments, each with its own lock, so concurrent handler threads
(the HTTP server's request threads) don't serialize on one cache mutex. Capacity
is divided across shards; eviction is per-shard LRU.
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from .canonical import CanonicalForm, canonicalize


def _solves(board: np.ndarray, solution: np.ndarray) -> bool:
    """Host-side proof that ``solution`` answers ``board``: every clue
    preserved and every row/col/box a permutation of 1..N. The single
    verification predicate both gates use — vectorized (three
    axis-sorts), because it runs on every hit and the hit path's whole
    budget is microseconds. Semantics identical to the test oracle's
    ``oracle_is_valid_solution`` (pinned by tests/test_cache.py)."""
    if (
        board.ndim != 2
        or board.shape[0] != board.shape[1]
        or solution.shape != board.shape
    ):
        return False
    n = board.shape[0]
    b = math.isqrt(n)
    if b * b != n:
        # a Latin-square-shaped payload with a non-perfect-square edge
        # (e.g. a hostile 3×3 cache_answer) passes the row/col checks
        # but has no box structure — reject here, where every gate
        # funnels, instead of letting reshape raise out of the UDP loop
        return False
    clue = board > 0
    if not bool((solution[clue] == board[clue]).all()):
        return False
    want = np.arange(1, n + 1, dtype=solution.dtype)
    if not bool((np.sort(solution, axis=1) == want).all()):
        return False
    if not bool((np.sort(solution, axis=0) == want[:, None]).all()):
        return False
    boxes = solution.reshape(b, b, b, b).transpose(0, 2, 1, 3).reshape(
        n, n
    )
    return bool((np.sort(boxes, axis=1) == want).all())


class _Entry:
    __slots__ = ("board", "solution", "hits", "created")

    def __init__(self, board: np.ndarray, solution: np.ndarray):
        self.board = board
        self.solution = solution
        self.hits = 0
        self.created = time.monotonic()


class AnswerCache:
    """Sharded bounded LRU of verified canonical (board, solution) pairs.

    Args:
      capacity: max entries across all shards (evictions are per-shard
        LRU once a shard's slice fills).
      shards: independent lock domains; the canonical hash picks one.
    """

    def __init__(self, capacity: int = 4096, shards: int = 8):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if shards < 1:
            raise ValueError("shards must be >= 1")
        self.capacity = int(capacity)
        # never more shards than entries (a zero-limit shard would
        # instantly evict everything hashing to it), and distribute the
        # remainder so the shard limits sum to EXACTLY the configured
        # capacity — an operator tuning --answer-cache-capacity must
        # get neither silently more entries (capacity 4 / 8 shards used
        # to hold 8) nor fewer (100/8 used to cap at 96)
        self.shards = max(1, min(int(shards), self.capacity))
        base, extra = divmod(self.capacity, self.shards)
        self._limits = [
            base + (1 if i < extra else 0) for i in range(self.shards)
        ]
        self._maps: List[OrderedDict] = [
            OrderedDict() for _ in range(self.shards)
        ]
        self._locks = [threading.Lock() for _ in range(self.shards)]
        # counters: a benign-race-free single lock — every update is a
        # couple of int ops, far off the shard locks' hot path
        self._stats_lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        self.rejected_writes = 0   # failed the write gate (wrong answer)
        self.hit_mismatches = 0    # hash matched, symmetry proof failed
        self.peer_fetches = 0      # cache_get datagrams this node sent
        self.peer_answers = 0      # verified peer answers folded in
        self.peer_rejects = 0      # peer answers that failed verification

    # -- internals ---------------------------------------------------------
    def _shard(self, key: str) -> int:
        return int(key[:8], 16) % self.shards

    def _count(self, field: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self, field, getattr(self, field) + n)

    def _put(self, key: str, entry: _Entry) -> None:
        i = self._shard(key)
        evicted = 0
        with self._locks[i]:
            m = self._maps[i]
            if key in m:
                m.move_to_end(key)
                return
            m[key] = entry
            while len(m) > self._limits[i]:
                m.popitem(last=False)
                evicted += 1
        with self._stats_lock:
            self.stores += 1
            self.evictions += evicted

    def _get(self, key: str) -> Optional[_Entry]:
        i = self._shard(key)
        with self._locks[i]:
            m = self._maps[i]
            entry = m.get(key)
            if entry is not None:
                m.move_to_end(key)
                entry.hits += 1
            return entry

    def _peek(self, key: str) -> Optional[_Entry]:
        """Non-mutating read: no hit bump, no LRU touch. The peer-serve
        path uses it — remote ``cache_get`` demand must not pin entries
        against eviction or promote them into the gossiped hot set
        (hot_set ranks by ``hits``; a retry-looping peer would
        otherwise organically inflate a cold key past genuinely
        request-hot ones, sidestepping the advertised-count bounds).
        Peer demand has its own ledger: ``gossip.peer_serves``."""
        i = self._shard(key)
        with self._locks[i]:
            return self._maps[i].get(key)

    def _drop(self, key: str) -> None:
        i = self._shard(key)
        with self._locks[i]:
            self._maps[i].pop(key, None)

    # -- front-door surface ------------------------------------------------
    def lookup(
        self,
        board,
        form: Optional[CanonicalForm] = None,
        count_miss: bool = True,
    ) -> Tuple[Optional[List[List[int]]], Optional[CanonicalForm]]:
        """(solution-in-the-requester's-frame | None, canonical form).

        The returned form is reused by ``store`` on a miss so the
        canonicalization is paid once per request. A hit has been proven
        symmetric (transform application, not hash trust) AND
        rule-checked in the requester's frame before it returns.

        ``count_miss=False`` defers miss accounting to the caller: the
        front door's peer-fetch path probes the store twice for ONE
        request (local miss → fetch → re-probe) and must record exactly
        one hit OR one miss, never both (net/http_api._cache_lookup).
        """
        try:
            form = form or canonicalize(board)
        except (ValueError, TypeError):
            return None, None
        entry = self._get(form.key)
        if entry is None:
            if count_miss:
                self._count("misses")
            return None, form
        # soundness: the recorded transform must actually map the
        # requester's board onto the stored canonical board — equal
        # hashes are evidence, the permutation is the proof
        if not np.array_equal(form.transform.apply(board), entry.board):
            self._count("hit_mismatches")
            if count_miss:
                self._count("misses")
            return None, form
        answer = form.transform.invert(entry.solution)
        if not _solves(np.asarray(board, np.int32), answer):
            # the stored pair no longer verifies in this frame — a
            # corrupted entry must not survive to mislead again
            self._drop(form.key)
            self._count("hit_mismatches")
            if count_miss:
                self._count("misses")
            return None, form
        self._count("hits")
        return answer.tolist(), form

    def _admit(
        self,
        arr: np.ndarray,
        sol: np.ndarray,
        form: Optional[CanonicalForm] = None,
    ) -> bool:
        """THE write pipeline — verify host-side, canonicalize, store —
        shared by every admission path (request answers AND peer
        datagrams), so a future hardening can never apply to one and
        silently skip the other."""
        if not _solves(arr, sol):
            return False
        try:
            form = form or canonicalize(arr)
        except (ValueError, TypeError):
            return False
        self._put(
            form.key,
            _Entry(form.transform.apply(arr), form.transform.apply(sol)),
        )
        return True

    def store(
        self, board, solution, form: Optional[CanonicalForm] = None
    ) -> bool:
        """Admit one answered board. Returns True iff it entered the
        cache — i.e. iff the answer PROVED correct under the write
        gate's host-side verification. Callers never pre-verify; this
        is the single admission point."""
        if solution is None:
            return False
        if not self._admit(
            np.asarray(board, np.int32),
            np.asarray(solution, np.int32),
            form,
        ):
            self._count("rejected_writes")
            return False
        return True

    # -- gossip surface (cache/gossip.py) ----------------------------------
    def get_canonical(self, key: str) -> Optional[Tuple[list, list]]:
        """The stored canonical (board, solution) pair for a peer's
        ``cache_get``, as JSON-ready lists; None when unknown. A PEEK,
        not a hit — see ``_peek``."""
        entry = self._peek(key)
        if entry is None:
            return None
        return entry.board.tolist(), entry.solution.tolist()

    def store_canonical(self, board, solution) -> bool:
        """Fold a peer's ``cache_answer`` payload: the SAME ``_admit``
        pipeline as every other write (a hostile datagram can no more
        poison the cache than a poisoned device program can), keyed by
        OUR OWN canonicalization of the claimed board so the peer
        cannot choose the key it lands under. Only the counters differ:
        the peer ledger, not ``rejected_writes``."""
        try:
            arr = np.asarray(board, np.int32)
            sol = np.asarray(solution, np.int32)
        except (ValueError, TypeError):
            self._count("peer_rejects")
            return False
        if not self._admit(arr, sol):
            self._count("peer_rejects")
            return False
        self._count("peer_answers")
        return True

    def contains(self, key: str) -> bool:
        i = self._shard(key)
        with self._locks[i]:
            return key in self._maps[i]

    def hot_set(self, k: int = 16) -> List[Tuple[str, int]]:
        """Top-``k`` entries by hit count — the gossip digest payload
        (cache/gossip.py). Reads every shard under its own lock; called
        at most once per gossip-digest rebuild, never per request."""
        rows: List[Tuple[str, int]] = []
        for i in range(self.shards):
            with self._locks[i]:
                rows.extend(
                    (key, e.hits) for key, e in self._maps[i].items()
                )
        rows.sort(key=lambda r: (-r[1], r[0]))
        return rows[: max(0, k)]

    # -- operator surface --------------------------------------------------
    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)

    def snapshot(self) -> dict:
        """The ``engine.cost.cache`` block of ``GET /metrics``."""
        with self._stats_lock:
            hits, misses = self.hits, self.misses
            out = {
                "entries": len(self),
                "capacity": self.capacity,
                "shards": self.shards,
                "hits": hits,
                "misses": misses,
                "hit_rate_pct": round(
                    100.0 * hits / (hits + misses), 2
                )
                if hits + misses
                else 0.0,
                "stores": self.stores,
                "evictions": self.evictions,
                "rejected_writes": self.rejected_writes,
                "hit_mismatches": self.hit_mismatches,
                "peer_fetches": self.peer_fetches,
                "peer_answers": self.peer_answers,
                "peer_rejects": self.peer_rejects,
            }
        return out
