"""Shared TTL'd / bounded / ingress-sanitized per-peer evidence map.

A copy of ``sudoku_solver_distributed_tpu/net/peermap.py``, the code line
for line; the port imports nothing from the JAX package.

ONE implementation of the expiry/bound/sanitize machinery that
``PeerHealth`` (supervisor-state gossip), ``PeerTelemetry``
(fleet-observability digests), and ``PeerHotset``
(answer-cache hot-set advertisements) share, in one place because the
fleet autopilot reads all three maps to make control decisions, so a
hardening (or a bug) in the shared machinery must land in exactly one
place.

The contract every subclass inherits:

  * **evidence, not membership** — entries EXPIRE (``ttl_s``): a stale
    claim can never render as live fleet state or exclude a peer whose
    gossip has since gone quiet; departures ``forget`` the peer
    entirely (rejoiners start with a clean slate).
  * **bounded** — at most ``MAX_ENTRIES`` peers tracked; past the bound,
    expired entries purge first, then the OLDEST claims evict (real
    neighbors re-gossip within a second; a spoofed-origin flood's fake
    peers never do — a hostile datagram stream exhausts a constant, not
    the heap).
  * **sanitized at ingress** — ``note`` folds a claim only after the
    subclass's :meth:`sanitize` accepts it whole; anything malformed is
    dropped at the boundary (partial acceptance would let one valid
    field smuggle junk siblings onto an operator surface), exactly the
    same ingress rule every other wire field follows.

Thread-safety: one lock per map; every critical section is a few
dict/float ops (no I/O, no sleeps under the lock — analysis/locks.py
discipline). Subclasses never touch the lock: they override pure hooks
(``sanitize``) and read through the locked accessors.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple


class PeerMap:
    """Base TTL'd/bounded map of ``peer -> sanitized claim``.

    Subclass by overriding :meth:`sanitize` (return the value to store,
    or None to drop the claim at the boundary) and, when the rendered
    view needs shaping, building it from :meth:`items`.
    """

    MAX_ENTRIES = 256  # flood bound — see module docstring

    def __init__(self, ttl_s: float = 15.0):
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        # peer -> (sanitized value, monotonic receive time)
        self._entries: Dict[str, Tuple[Any, float]] = {}

    # -- the subclass hook --------------------------------------------------
    @classmethod
    def sanitize(cls, raw) -> Optional[Any]:
        """Boundary validation: the value to store, or None to reject the
        claim whole. The base accepts anything non-None (subclasses that
        carry wire-ingested payloads MUST override)."""
        return raw

    # -- ingress ------------------------------------------------------------
    def note(self, peer: str, raw) -> bool:
        """Fold one gossip-carried claim; returns True iff it was stored
        (malformed payloads are dropped at the boundary)."""
        value = self.sanitize(raw)
        if value is None:
            return False
        now = time.monotonic()
        with self._lock:
            self._entries[peer] = (value, now)
            if len(self._entries) > self.MAX_ENTRIES:
                self._purge_locked(now)
            while len(self._entries) > self.MAX_ENTRIES:
                # still over after expiry: evict the oldest claims
                oldest = min(
                    self._entries.items(), key=lambda kv: kv[1][1]
                )
                del self._entries[oldest[0]]
        return True

    # -- expiry (ONE rule, every reader applies it) --------------------------
    def _purge_locked(self, now: float) -> None:
        for p in [
            p
            for p, (_, t) in self._entries.items()
            if now - t > self.ttl_s
        ]:
            del self._entries[p]

    # -- reads ---------------------------------------------------------------
    def get(self, peer: str) -> Optional[Any]:
        """The peer's unexpired claim, or None when unknown/expired
        (expired entries are dropped on read, so a dead claim can never
        be observed twice)."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(peer)
            if entry is None:
                return None
            value, t = entry
            if now - t > self.ttl_s:
                del self._entries[peer]
                return None
            return value

    def items(self) -> Dict[str, Tuple[Any, float]]:
        """Unexpired claims as ``{peer: (value, age_s)}`` — the one
        locked read every subclass view (snapshot/holders/ranking) is
        built from."""
        now = time.monotonic()
        with self._lock:
            self._purge_locked(now)
            return {
                p: (v, now - t) for p, (v, t) in self._entries.items()
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- departures ----------------------------------------------------------
    def forget(self, peer: str) -> None:
        """A departed peer's claims die with it (rejoiners start fresh)."""
        with self._lock:
            self._entries.pop(peer, None)
