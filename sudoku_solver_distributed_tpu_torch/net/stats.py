"""Stats gossip: eventually-consistent max-merge counters (CRDT-style).

A copy of ``StatsGossip`` and ``serving_snapshot`` from
``sudoku_solver_distributed_tpu/net/stats.py``: the port imports nothing from
the JAX package. (The per-peer health and telemetry maps come with the P2P
slice.)

Reproduces the reference's stats plane exactly (reference node.py:264-331,
580-620): every node carries ``all_stats`` = {"all": {"solved",
"validations"}, "nodes": [{"address", "validations"}]} plus a per-node
``stats_solved`` map; incoming ``stats`` messages are merged by taking
per-node maxima (a G-counter per node) and global sums are recomputed from
the merged per-node values. The same two JSON shapes surface at GET /stats —
part of the byte-identical API contract.

Thread-safe, unlike the reference (its UDP and HTTP threads mutate all_stats
concurrently with no locks, SURVEY.md §5).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from .wire import Msg


class StatsGossip:
    def __init__(self, node_id: str, own_counters: Callable[[], tuple]):
        """own_counters: () -> (solved_puzzles, validations) for this node."""
        self.node_id = node_id
        self._own = own_counters
        self._lock = threading.Lock()
        self.stats_solved: Dict[str, int] = {}
        self.all_stats: Msg = {
            "all": {"solved": 0, "validations": 0},
            "nodes": [],
        }

    # -- helpers (hold the lock) -------------------------------------------
    def _node_entry(self, address: str):
        for node in self.all_stats["nodes"]:
            if node["address"] == address:
                return node
        return None

    def _fold_node(self, address: str, validations: int) -> None:
        entry = self._node_entry(address)
        if entry is None:
            self.all_stats["nodes"].append(
                {"address": address, "validations": validations}
            )
        elif entry["validations"] < validations:
            entry["validations"] = validations

    def _fold_solved(self, address: str, solved: int) -> None:
        if solved != 0 or address in self.stats_solved:
            prev = self.stats_solved.get(address, 0)
            if solved > prev:
                self.stats_solved[address] = solved
            elif address not in self.stats_solved:
                self.stats_solved[address] = solved

    def _fold_own(self) -> None:
        solved, validations = self._own()
        self._fold_solved(self.node_id, solved)
        self._fold_node(self.node_id, validations)

    def _recompute_totals(self) -> None:
        # The reference recomputes totals as the plain sum of its local
        # per-sender maps (node.py:327-328), which *overwrites* the max-merged
        # global and so never propagates a non-neighbor's solved count
        # transitively (per-node solved isn't on the wire — only per-node
        # validations are). Taking the max of (local sum, merged global)
        # keeps the same wire shape while making the counters actually
        # eventually consistent network-wide.
        self.all_stats["all"]["solved"] = max(
            self.all_stats["all"]["solved"], sum(self.stats_solved.values())
        )
        self.all_stats["all"]["validations"] = max(
            self.all_stats["all"]["validations"],
            sum(node["validations"] for node in self.all_stats["nodes"]),
        )

    # -- public API --------------------------------------------------------
    def merge(self, msg: Msg) -> None:
        """Fold one incoming ``stats`` message (reference node.py:264-328)."""
        address = msg["stats"]["address"]
        validations = msg["stats"]["validations"]
        solved = msg["solved"]
        received = msg["all_stats"]
        with self._lock:
            # global max-merge (monotone; sums recomputed below can only grow)
            for key in ("solved", "validations"):
                if received["all"][key] > self.all_stats["all"][key]:
                    self.all_stats["all"][key] = received["all"][key]
            # per-node max-merge of the sender's whole view
            for received_node in received["nodes"]:
                self._fold_node(
                    received_node["address"], received_node["validations"]
                )
            # the sender's own fresh counters
            self._fold_solved(address, solved)
            self._fold_node(address, validations)
            # our own counters
            self._fold_own()
            self._recompute_totals()

    def snapshot(self) -> Msg:
        """Current merged stats, own counters folded in — the GET /stats body
        (reference node.py:598-620) and the ``all_stats`` field of outgoing
        stats messages."""
        with self._lock:
            self._fold_own()
            self._recompute_totals()
            # deep-ish copy so callers can serialize without racing the gossip
            return {
                "all": dict(self.all_stats["all"]),
                "nodes": [dict(n) for n in self.all_stats["nodes"]],
            }

    # NB: departed peers intentionally stay in the "nodes" list — /stats
    # reports "the whole network since it started" (reference README.md:46);
    # their validations happened and the totals stay monotone. This matches
    # the reference's observed behavior (SURVEY.md §3.5).


def serving_snapshot(engine) -> Msg:
    """The opt-in ``serving`` block of GET /stats (CLI ``--serving-stats``):
    the request coalescer's realized batch-fill, queue depth and wait
    times (parallel/coalescer.py). Off by default so the reference's
    /stats body stays byte-identical."""
    out = {
        "coalesce": bool(getattr(engine, "coalesce", False)),
        "batches": 0,
        "boards": 0,
        "batch_fill_avg": 0.0,
    }
    co = getattr(engine, "_coalescer", None)
    if co is not None:
        out.update(co.stats())
    return out
