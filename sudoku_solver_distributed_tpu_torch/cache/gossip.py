"""Fleet cache convergence: hot-set gossip + peer answer fetch.

A copy of ``sudoku_solver_distributed_tpu/cache/gossip.py``, the code
line for line, over the port's ``net/peermap``, ``net/wire`` and ``cache/store``;
the port imports nothing from the JAX package.

The cluster layer of the answer cache. Two wire
surfaces, both speaking the existing UDP protocol's idioms:

  * **hot-set digest** — each node's top-K canonical hashes (+ hit
    counts) ride the 1 Hz stats heartbeat as an optional trailing
    ``hotset`` key (net/wire.stats_msg — the health/telemetry variant pattern;
    absent key keeps reference traffic byte-identical). Peers fold the
    digest into a TTL'd, bounded, ingress-sanitized map
    (:class:`PeerHotset`) — evidence, not membership, exactly like
    PeerHealth/PeerTelemetry.
  * **cache_get / cache_answer** — a node that MISSES locally on a key
    some fresh peer advertises sends ``cache_get`` and waits a bounded
    beat for the ``cache_answer`` carrying the canonical (board,
    solution) pair. The UDP ingress thread only DELIVERS the payload to
    the parked fetcher (bounded append + event set — the receive loop
    never canonicalizes, THREAD101); the fetcher thread verifies it
    through the store's write gate (cache/store.py ``store_canonical``:
    re-hashed under OUR canonicalization, rule-checked host-side), so a
    hostile or corrupt peer answer is counted and dropped, never
    served. The fetch replaces a device dispatch; a timeout just falls
    through to the normal solve path.

Net effect: one node solves the viral puzzle, every node answers its
whole symmetry orbit from cache within a gossip interval.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..net.peermap import PeerMap

logger = logging.getLogger(__name__)

# a canonical key is a 64-char lowercase sha256 hex digest — the ingress
# shape gate for every wire-carried hash field
_KEY_RE = re.compile(r"^[0-9a-f]{64}$")

DIGEST_VERSION = 1


def valid_key(raw) -> Optional[str]:
    """Wire-ingress validation of a canonical hash; None when malformed."""
    if isinstance(raw, str) and _KEY_RE.fullmatch(raw):
        return raw
    return None


class PeerHotset(PeerMap):
    """Last-known hot-set digest per peer, carried by the ``hotset``
    piggyback on stats gossip. Same evidence-not-membership contract as
    net/stats.PeerHealth, via the shared base (net/peermap.PeerMap):
    entries EXPIRE (``ttl_s``) — so holders() can never offer
    a fetch target snapshot() already considers dead — departures forget
    the peer, and both the peer count and the keys-per-peer are bounded
    with full ingress sanitization: a hostile datagram can neither grow
    the heap nor plant garbage keys."""

    MAX_KEYS = 32       # hot keys accepted per peer digest

    @classmethod
    def sanitize(cls, raw) -> Optional[Dict[str, int]]:
        """{"v": 1, "keys": [[hex, hits], ...]} → {hex: hits}, or None.
        Rejected whole on any malformed element — partial acceptance
        would let one valid key smuggle junk siblings in."""
        if not isinstance(raw, dict):
            return None
        keys = raw.get("keys")
        if not isinstance(keys, list) or len(keys) > cls.MAX_KEYS:
            return None
        out: Dict[str, int] = {}
        for item in keys:
            if not isinstance(item, (list, tuple)) or len(item) != 2:
                return None
            key, hits = item
            if valid_key(key) is None:
                return None
            if not isinstance(hits, int) or isinstance(hits, bool) or (
                not 0 <= hits < 1 << 31
            ):
                # an absurd claimed count is a lie, and lies rank fetch
                # targets (holders sorts hottest-first) — rejected
                # whole like every other malformed digest
                return None
            out[key] = hits
        return out

    def holders(self, key: str) -> List[str]:
        """Peers whose FRESH (unexpired) digest advertises ``key``,
        hottest-first (the advertised hit count ranks fetch targets: a
        peer serving the key thousands of times is the likeliest to
        still hold it and the least bothered by one more get)."""
        matches = [
            (p, hits.get(key, 0))
            for p, (hits, _age) in self.items().items()
            if key in hits
        ]
        matches.sort(key=lambda ph: -ph[1])
        return [p for p, _ in matches]

    def advertised(self) -> Dict[str, Dict[str, int]]:
        """Every FRESH advertisement: {peer: {key: hits}} — the joiner
        prewarm's shopping list (CacheGossip.prewarm)."""
        return {p: dict(hits) for p, (hits, _age) in self.items().items()}

    def snapshot(self) -> Dict[str, dict]:
        return {
            p: {"age_s": round(age, 3), "keys": len(hits)}
            for p, (hits, age) in self.items().items()
        }


class _Waiter:
    """One key's parked fetchers: the wake event, how many threads are
    registered on it, and the raw answer payloads delivered by the UDP
    loop awaiting verification on a fetcher thread. Payloads are capped:
    a flood of answers for a solicited key can park at most
    ``MAX_PAYLOADS`` boards here, not grow the heap."""

    MAX_PAYLOADS = 4

    __slots__ = ("event", "count", "payloads")

    def __init__(self):
        self.event = threading.Event()
        self.count = 0
        self.payloads: List[Tuple[object, object]] = []


class CacheGossip:
    """One node's cache-convergence plane: builds the outgoing hot-set
    digest (cached between heartbeats, like obs/cluster's publisher),
    folds peers' digests, answers ``cache_get``, verifies
    ``cache_answer``, and runs the bounded blocking fetch the front door
    calls on a peer-hot miss.

    Args:
      cache: the node's AnswerCache.
      node: the owning P2PNode (send surface + identity).
      top_k: hot-set size gossiped per heartbeat.
      fetch_timeout_s: how long a miss waits for a peer answer before
        falling through to the normal solve path. Bounded and small on
        purpose: the fallback is not an error, it is the device doing
        its job.
      fanout: peers asked per fetch (first answer wins; the rest are
        idempotent folds).
      max_concurrent_fetches: handler threads allowed to be parked in
        ``try_peer_fetch`` at once. The fetch runs BEFORE admission (a
        hot key must be answerable even when the backlog would shed),
        so without a bound a burst of misses on stale-advertised keys
        could park the whole transport worker pool for a fetch-timeout
        each; at the cap a miss just dispatches normally.
    """

    def __init__(
        self,
        cache,
        node,
        *,
        top_k: int = 16,
        ttl_s: float = 15.0,
        fetch_timeout_s: float = 0.25,
        fanout: int = 2,
        min_interval_s: float = 1.0,
        max_concurrent_fetches: int = 8,
    ):
        self.cache = cache
        self.node = node
        self.top_k = int(top_k)
        self.fetch_timeout_s = float(fetch_timeout_s)
        self.fanout = max(1, int(fanout))
        self.peers = PeerHotset(ttl_s=ttl_s)
        self.min_interval_s = min_interval_s
        self.max_concurrent_fetches = max(1, int(max_concurrent_fetches))
        self._fetching = 0  # parked fetchers (under _waiters_lock)
        self.fetches_capped = 0  # misses that skipped the fetch at cap
        self.unsolicited_answers = 0  # answers dropped, no fetch waiting
        self._fetch_rotation = 0  # round-robin over non-top holders
        # joiner prewarm counters (see prewarm())
        self.prewarm_runs = 0
        self.prewarm_requested = 0
        self.prewarm_landed = 0
        self._digest_lock = threading.Lock()
        self._cached_digest: Optional[dict] = None
        self._cached_at = 0.0
        # key -> _Waiter; on_cache_answer appends the RAW payload and
        # signals — the waiting fetcher thread verifies (the UDP loop
        # must never canonicalize)
        self._waiters: Dict[str, _Waiter] = {}
        self._waiters_lock = threading.Lock()
        self.peer_serves = 0  # cache_get datagrams answered (benign race)

    # -- outgoing digest ---------------------------------------------------
    def digest(self) -> Optional[dict]:
        """The ``hotset`` payload for the next stats heartbeat, rebuilt
        at most once per ``min_interval_s`` (broadcast_stats runs once
        per /solve on the serving path); None — key absent on the wire —
        while the cache is empty."""
        now = time.monotonic()
        with self._digest_lock:
            if (
                self._cached_digest is not None
                and now - self._cached_at < self.min_interval_s
            ):
                return self._cached_digest or None
            hot = self.cache.hot_set(self.top_k)
            self._cached_digest = (
                {"v": DIGEST_VERSION, "keys": [[k, h] for k, h in hot]}
                if hot
                else {}
            )
            self._cached_at = now
            return self._cached_digest or None

    # -- ingress (UDP loop thread, net/node.py) ----------------------------
    def note_hotset(self, peer: str, raw) -> None:
        self.peers.note(peer, raw)

    def on_cache_get(self, msg, source=None) -> None:
        """Answer a peer's fetch from our store; unknown keys are
        silently ignored (the peer's timeout is the negative reply —
        a 'not found' datagram would only invite spoofed floods).

        Reflection guard: the multi-KB positive reply goes to the
        claimed ``address`` only when it matches the datagram's UDP
        ``source`` (wire.same_endpoint — nodes send from their bound
        socket, the same identity rule goodbyes use). Without the
        check, a ~120-byte spoofed get for a gossip-advertised hot key
        would reflect a 15-30× larger cache_answer at any victim."""
        from ..net import wire

        key = valid_key(msg["hash"])
        if key is None:
            return
        if source is not None:
            try:
                claimed = wire.parse_address(msg["address"])
            except (ValueError, TypeError):
                return
            if not wire.same_endpoint(tuple(source[:2]), claimed):
                logger.warning(
                    "dropping cache_get whose address %r does not "
                    "match its source %r", msg["address"], source,
                )
                return
        pair = self.cache.get_canonical(key)
        if pair is None:
            return
        board, solution = pair
        self.node.send_to(
            msg["address"],
            wire.cache_answer_msg(key, board, solution, self.node.id),
        )
        self.peer_serves += 1

    def on_cache_answer(self, msg) -> None:
        """Deliver a peer's answer to the fetch parked on that key and
        wake it. This runs on the UDP receive loop, so it does ONLY
        O(1) work — a bounded payload append and an event set; the
        woken fetcher thread runs the store's write gate
        (``_verify_delivered`` → store_canonical), where the claimed
        hash is never trusted: the carried board is re-canonicalized so
        the entry lands under the key WE compute, and the waiter's
        post-verify ``contains`` check closes the loop.

        SOLICITED answers only: a datagram for a key no fetch is
        waiting on is dropped on arrival. Without the gate, an attacker
        streaming valid-but-unsolicited (board, solution) pairs —
        trivial to mint from any complete grid — would flush the
        genuine hot set through the per-shard LRU; the delivery cap
        (``_Waiter.MAX_PAYLOADS``) bounds what a flood on a SOLICITED
        key can park. Waiters register BEFORE the gets go out
        (try_peer_fetch), so a legitimate answer always finds its
        waiter; late answers after the timeout are dropped like any
        other unsolicited datagram (the asking node will re-fetch or
        has already dispatched)."""
        key = valid_key(msg["hash"])
        if key is None:
            return
        board, solution = msg["board"], msg["solution"]
        with self._waiters_lock:
            entry = self._waiters.get(key)
            if entry is None:
                self.unsolicited_answers += 1  # benign-race counter
                return
            if len(entry.payloads) < _Waiter.MAX_PAYLOADS:
                entry.payloads.append((board, solution))
            entry.event.set()

    # -- waiter bookkeeping (fetcher threads) ------------------------------
    def _register_waiter(self, key: str) -> _Waiter:
        """Caller holds ``_waiters_lock``."""
        entry = self._waiters.get(key)
        if entry is None:
            entry = self._waiters[key] = _Waiter()
        entry.count += 1
        return entry

    def _release_waiter(self, key: str) -> None:
        """Drop one registration; the last one out verifies any
        payloads still parked (an answer that raced the timeout should
        still land for the NEXT request) and removes the entry."""
        self._verify_delivered(key)
        with self._waiters_lock:
            entry = self._waiters.get(key)
            if entry is None:
                return
            entry.count -= 1
            if entry.count <= 0:
                self._waiters.pop(key, None)

    def _verify_delivered(self, key: str) -> bool:
        """Run delivered payloads through the store's write gate — on
        the CALLING (fetcher) thread, never the UDP loop. True iff a
        payload verified and landed."""
        while True:
            with self._waiters_lock:
                entry = self._waiters.get(key)
                if entry is None or not entry.payloads:
                    return False
                board, solution = entry.payloads.pop(0)
            if self.cache.store_canonical(board, solution):
                return True

    # -- the front door's fetch (handler thread) ---------------------------
    def try_peer_fetch(self, key: str, timeout_s=None) -> bool:
        """On a local miss: if any fresh peer advertises ``key``, ask up
        to ``fanout`` of them and wait (bounded) for a verified answer
        to land. True iff the cache now holds the key — the caller
        re-runs its lookup and serves the hit.

        ``timeout_s`` caps the wait BELOW the configured fetch timeout
        (never above): the front door passes the request's remaining
        deadline budget, so a 50 ms-budget request never parks 250 ms
        for an answer it could no longer use."""
        wait_s = self.fetch_timeout_s
        if timeout_s is not None:
            wait_s = min(wait_s, timeout_s)
        if wait_s <= 0:
            return False  # disabled (CLI timeout 0) or budget spent
        holders = self.peers.holders(key)
        if not holders:
            return False
        from ..net import wire

        with self._waiters_lock:
            if self._fetching >= self.max_concurrent_fetches:
                # the park budget is spent: this miss dispatches
                # normally instead of joining a pile-up that could
                # exhaust the transport worker pool pre-admission
                self.fetches_capped += 1
                return False
            self._fetching += 1
            entry = self._register_waiter(key)
        try:
            self.cache._count("peer_fetches")
            msg = wire.cache_get_msg(key, self.node.id)
            # top-(fanout−1) hottest holders plus ONE rotated from the
            # rest: a pair of hostile peers advertising inflated counts
            # can then monopolize at most fanout−1 slots — an honest
            # holder is still asked within len(holders) fetches
            targets = holders[: max(1, self.fanout - 1)]
            rest = holders[len(targets):]
            if rest and len(targets) < self.fanout:
                self._fetch_rotation += 1
                targets.append(rest[self._fetch_rotation % len(rest)])
            for peer in targets:
                self.node.send_to(peer, msg)
            deadline = time.monotonic() + wait_s
            while not self.cache.contains(key):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not entry.event.wait(remaining):
                    break  # budget spent with no delivery
                if self._verify_delivered(key):
                    break  # verified fold landed under our key
                # a hostile/corrupt answer must not end the wait early:
                # re-arm and keep waiting for an honest one — unless a
                # further delivery raced in while we were verifying
                with self._waiters_lock:
                    if not entry.payloads:
                        entry.event.clear()
        finally:
            with self._waiters_lock:
                self._fetching -= 1
            self._release_waiter(key)
        return self.cache.contains(key)

    # -- joiner prewarm -------------------------------
    def prewarm(
        self,
        *,
        max_keys: int = 64,
        budget_s: float = 2.0,
        per_peer: int = 16,
    ) -> Tuple[int, int]:
        """Bulk-fetch peers' advertised hot sets on join, instead of
        converging one front-door miss at a time (the natural partner of elastic membership: a
        node that defers gossip advertisement until it is servable
        should arrive already holding the fleet's viral answers).

        Bounded on every axis: at most ``max_keys`` keys total (the
        hottest advertised keys we don't already hold), at most
        ``per_peer`` gets sent to any one holder, and one total
        ``budget_s`` wall-clock wait for the whole run. Every reply
        folds through the store's verified write gate exactly like a
        front-door fetch (on_cache_answer → store_canonical → _admit:
        re-canonicalized under OUR key, rule-verified host-side), so a
        hostile peer can poison nothing — a bad answer is counted and
        dropped, and the key simply stays cold.

        Returns (requested, landed). Idempotent and safe to call again
        (e.g. after a partition heals); the autopilot's membership loop
        runs it once per join (serving/autopilot.py).
        """
        t_end = time.monotonic() + max(0.0, budget_s)
        adv = self.peers.advertised()
        score: Dict[str, int] = {}
        holders: Dict[str, List[str]] = {}
        for peer, keys in adv.items():
            for k, h in keys.items():
                if self.cache.contains(k):
                    continue
                score[k] = max(score.get(k, 0), h)
                holders.setdefault(k, []).append(peer)
        wanted = sorted(score, key=lambda k: (-score[k], k))[
            : max(0, int(max_keys))
        ]
        self.prewarm_runs += 1
        if not wanted:
            return 0, 0
        from ..net import wire

        # register every waiter BEFORE any get goes out (the solicited-
        # answers gate in on_cache_answer) — same discipline as
        # try_peer_fetch, shared waiter table
        entries = {}
        with self._waiters_lock:
            for k in wanted:
                entries[k] = self._register_waiter(k)
        sent_per_peer: Dict[str, int] = {}
        try:
            asked = []
            for k in wanted:
                # hottest holder first, skipping peers already at their
                # per-peer budget — an advertised-everywhere key must
                # not concentrate the whole run on one node
                target = None
                ranked = sorted(
                    holders[k],
                    key=lambda p: (-adv[p].get(k, 0), p),
                )
                for p in ranked:
                    if sent_per_peer.get(p, 0) < per_peer:
                        target = p
                        break
                if target is None:
                    continue
                sent_per_peer[target] = sent_per_peer.get(target, 0) + 1
                self.node.send_to(
                    target, wire.cache_get_msg(k, self.node.id)
                )
                asked.append(k)
            self.prewarm_requested += len(asked)
            for k in asked:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                if entries[k].event.wait(remaining):
                    # fold the delivery on THIS thread; the UDP loop
                    # only parked the raw payload
                    self._verify_delivered(k)
        finally:
            for k in wanted:
                # _release_waiter drains any answer that raced the
                # budget before dropping the registration
                self._release_waiter(k)
        landed = sum(1 for k in wanted if self.cache.contains(k))
        self.prewarm_landed += landed
        return len(wanted), landed

    def forget(self, peer: str) -> None:
        """A departed peer's advertisements die with it."""
        self.peers.forget(peer)

    def snapshot(self) -> dict:
        """The gossip half of the ``engine.cost.cache`` metrics block —
        scalar gauges only (the block flattens into Prometheus names;
        per-peer detail lives on ``peers.snapshot()`` for tests/debug)."""
        return {
            "peers_advertising": len(self.peers.snapshot()),
            "peer_serves": self.peer_serves,
            "fetches_capped": self.fetches_capped,
            "unsolicited_answers": self.unsolicited_answers,
            "top_k": self.top_k,
            "fetch_timeout_ms": round(self.fetch_timeout_s * 1e3, 1),
            # joiner prewarm: bulk hot-set fetch on join
            "prewarm_runs": self.prewarm_runs,
            "prewarm_requested": self.prewarm_requested,
            "prewarm_landed": self.prewarm_landed,
        }
