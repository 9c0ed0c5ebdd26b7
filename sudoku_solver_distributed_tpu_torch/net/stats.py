"""Stats gossip: eventually-consistent max-merge counters (CRDT-style).

A copy of ``sudoku_solver_distributed_tpu/net/stats.py``: ``StatsGossip``,
the per-peer ``PeerHealth`` and ``PeerTelemetry`` maps the task farm and the
cluster view read, and ``serving_snapshot``. The port imports nothing from
the JAX package.

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
from typing import Callable, Dict, Optional

from .peermap import PeerMap
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


class PeerHealth(PeerMap):
    """Last-known engine-supervisor state per peer, carried by the
    ``health`` piggyback on stats gossip (wire.stats_msg).

    The task farm reads this to skip LOST peers when dispatching cells
    (net/node.py _farm_solve): a peer whose device is gone still answers
    correctly — from its oracle fallback — but multi-second slower, and
    a master under a request deadline should prefer peers that aren't
    rebuilding an engine. The TTL'd/bounded/sanitized machinery lives in
    the shared base (net/peermap.PeerMap): a stale "lost"
    claim expires instead of excluding a peer forever, departures forget
    the peer, and a spoofed-origin stats flood exhausts a constant.
    """

    _STATES = frozenset({"warming", "healthy", "degraded", "lost"})

    @classmethod
    def sanitize(cls, raw) -> Optional[str]:
        """Non-states are rejected at the boundary (hostile datagrams
        must not grow this map with garbage — same ingress rule as every
        other wire field). The isinstance guard matters: an unhashable
        payload (a hostile dict in the ``health`` slot) must read as
        not-a-state, not raise out of the UDP handler."""
        return raw if isinstance(raw, str) and raw in cls._STATES else None

    def is_lost(self, peer: str) -> bool:
        return self.get(peer) == "lost"

    def snapshot(self) -> Dict[str, str]:
        """Unexpired claims, for the /metrics health block."""
        return {p: s for p, (s, _age) in self.items().items()}


class PeerTelemetry(PeerMap):
    """Last-known fleet-observability digest per peer, carried by the
    ``telemetry`` piggyback on stats gossip (wire.stats_msg) —
    the generalization of :class:`PeerHealth` from one enum to the whole
    per-node digest (goodput, stage latencies, shed rate, warm fraction,
    supervisor state, mesh topology; obs/cluster.py builds it).

    Same evidence-not-membership contract, via the shared base
    (net/peermap.PeerMap): entries EXPIRE so a stale digest can never
    render as live fleet state, departures forget the peer entirely
    (net/node.py prunes on disconnect/goodbye), and the map is bounded
    with ingress sanitization so a hostile datagram can neither grow the
    heap nor smuggle arbitrary structure onto the /metrics/cluster
    surface. The fleet autopilot's farm ranking reads the same map
    (serving/autopilot.py), so every hardening here guards a control
    loop, not just a dashboard.
    """

    MAX_KEYS = 32            # digest keys accepted per peer
    MAX_STR = 64             # digest string-value length cap

    @classmethod
    def sanitize(cls, raw) -> Optional[dict]:
        """Boundary validation: a digest is a flat dict of short string
        keys to scalars (numbers / bools / short strings / None).
        Anything else — nested structure, huge blobs, non-dict garbage —
        is rejected whole; partial acceptance would let one valid key
        carry a payload of junk siblings onto the operator surface."""
        if not isinstance(raw, dict) or len(raw) > cls.MAX_KEYS:
            return None
        out = {}
        for k, v in raw.items():
            if not isinstance(k, str) or not 0 < len(k) <= cls.MAX_STR:
                return None
            if isinstance(v, bool) or v is None:
                out[k] = v
            elif isinstance(v, (int, float)):
                # NaN/inf survive JSON round-trips as valid floats but
                # poison downstream min/max rollups — normalize to None
                out[k] = v if v == v and abs(v) != float("inf") else None
            elif isinstance(v, str) and len(v) <= cls.MAX_STR:
                out[k] = v
            else:
                return None
        return out

    def snapshot(self) -> Dict[str, dict]:
        """Unexpired digests with their age:
        {peer: {**digest, "age_s": float, "fresh": bool}} — ``fresh``
        marks entries younger than half the TTL (the /metrics/cluster
        freshness column). The digest spreads FIRST: age_s/fresh are
        OUR receive-side bookkeeping, and a peer-supplied key of the
        same name (sanitize accepts any short scalar key) must never
        override them — a spoofed negative age would otherwise rank
        that peer above every honest one in the autopilot's farm
        scoring forever."""
        return {
            p: {
                **d,
                "age_s": round(age, 3),
                "fresh": age <= self.ttl_s / 2,
            }
            for p, (d, age) in self.items().items()
        }


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
