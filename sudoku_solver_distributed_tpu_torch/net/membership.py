"""Membership & topology: anchor join, flood merge, disconnect pruning.

A copy of ``sudoku_solver_distributed_tpu/net/membership.py``: the port
imports nothing from the JAX package.

Reproduces the reference's topology semantics (reference node.py:195-260,
334-381, 559-577):

  * a newcomer dials an anchor with ``connect``; the anchor records it in
    ``peers_out`` and replies ``connected``; the newcomer records the anchor
    in ``peers_in`` and notes ``all_peers[anchor] = [self]``;
  * ``all_peers`` ({parent: [children...]}) floods on every change with a
    grow-only union merge, until the network converges;
  * a node with only one link opportunistically dials a second peer
    (reference node.py:243-249);
  * on ``disconnect`` the departed address is pruned everywhere it appears,
    the change re-floods, and an orphaned child re-dials another node
    (reference node.py:344-372);
  * ``peers_to_reconnect`` tracks liveness flags exactly as the reference
    does (True on sight, False on disconnect, revived on re-sight).

Beyond the reference (churn-soak findings, tests/test_churn_soak.py):

  * **tombstones** — a pruned address is remembered dead for
    ``tombstone_ttl_s``; the grow-only union merge filters tombstoned
    addresses from incoming floods, so a node holding a stale pre-death
    view can no longer *resurrect* a dead peer network-wide by re-flooding
    it (the add-wins race the reference's merge loses permanently,
    reference node.py:227-231). Direct evidence of life (any datagram
    from the address — ``mark_alive``) clears the tombstone instantly, so
    a false-positive death or a genuine rejoin heals on first contact.
  * **stale-flood pushback** — tombstoned addresses seen in an incoming
    flood are reported to the caller (``drain_stale``), which answers the
    sender's neighborhood with ``disconnect`` relays: the deletion chases
    the stale view instead of waiting for the holder to stumble on it.
  * **orphan re-dial** — ``reconnect_candidate`` rotates through
    ``peers_to_reconnect`` so a fully-orphaned node (e.g. the original
    anchor after every neighbor died: it has no ``anchor_node`` to retry)
    re-dials remembered addresses until the network heals. The reference
    keeps this very structure and never dials from it (SURVEY.md §5).

Tombstone TTL tradeoff (``tombstone_ttl_s``, default 30 s): the TTL
bounds BOTH how long a same-address rejoin churns against third-party
tombstones (direct contact heals instantly; distant nodes filter the
rejoin from floods until their tombstones expire) AND the protection
window against resurrection — a node stalled/partitioned for longer
than the TTL while a peer died can re-introduce the dead non-neighbor
entry via its later floods, after which nothing reaps it (heartbeats
watch neighbors only). That residual leak is strictly better than the
reference, which leaks EVERY dead peer in EVERY view permanently
(SURVEY.md §3.5 [verified live]); deployments with long GC/compile
stalls should raise the TTL, accepting slower distant-rejoin
visibility.

The ``all_peers`` dict is the GET /network body — byte-identical shape.
Thread-safe behind one lock (the reference mutates these sets from two
threads, unlocked).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set

from .wire import valid_address

logger = logging.getLogger(__name__)


class Membership:
    def __init__(
        self,
        node_id: str,
        tombstone_ttl_s: float = 30.0,
        max_known_addresses: int = 4096,
    ):
        self.node_id = node_id
        self.tombstone_ttl_s = tombstone_ttl_s
        # Hostile-flood memory bound: ingress validation
        # keeps garbage out, but a flood of WELL-FORMED fake "host:port"
        # strings would still grow all_peers and peers_to_reconnect without
        # limit (the grow-only union merge never removes, and the re-dial
        # pool remembers every address it sees). Past this many distinct
        # addresses, merge_all_peers refuses new ones (logged); remembered
        # non-view addresses additionally age out past the same 10x-TTL
        # horizon node._reap_dead_neighbors uses for _last_seen.
        self.max_known_addresses = max_known_addresses
        self._lock = threading.Lock()
        self.peers_out: Set[str] = set()   # peers that dialed us
        self.peers_in: Set[str] = set()    # peers we dialed
        self.all_peers: Dict[str, List[str]] = {}
        self.peers_to_reconnect: Dict[str, bool] = {}
        self._remembered_at: Dict[str, float] = {}  # re-dial pool refresh time
        self._tombstones: Dict[str, float] = {}  # addr -> monotonic expiry
        self._buried_at: Dict[str, float] = {}   # addr -> first burial time
        self._stale_seen: List[str] = []         # pushback queue (drain_stale)
        self._redial_rotation: int = 0
        self._missing_rotation: int = 0

    # -- join --------------------------------------------------------------
    def on_connect(self, address: str) -> None:
        """Inbound ``connect`` (we are the anchor side). A live dial is
        ground truth: it clears any tombstone for the dialer."""
        with self._lock:
            self._tombstones.pop(address, None)
            self._buried_at.pop(address, None)  # revival resets burial age
            self.peers_out.add(address)
            self.peers_to_reconnect[address] = True
            self._remembered_at[address] = time.monotonic()

    def on_connected(self, address: str) -> None:
        """Inbound ``connected`` (our dial was accepted)."""
        with self._lock:
            self._tombstones.pop(address, None)
            self._buried_at.pop(address, None)
            self.peers_in.add(address)
            self.peers_to_reconnect[address] = True
            self._remembered_at[address] = time.monotonic()
            self.all_peers[address] = [self.node_id]

    def mark_alive(self, address: str) -> None:
        """Direct evidence of life (a datagram FROM ``address``): clear its
        tombstone so a false-positive death heals on first contact."""
        with self._lock:
            self._tombstones.pop(address, None)
            self._buried_at.pop(address, None)

    # -- flood merge -------------------------------------------------------
    def merge_all_peers(self, received: Dict[str, List[str]]) -> bool:
        """Union merge with tombstone filtering; True if our view changed
        (=> re-flood). Tombstoned addresses in ``received`` are recorded
        for ``drain_stale`` pushback instead of being merged."""
        changed = False
        now = time.monotonic()
        with self._lock:
            self._purge_tombstones(now)
            self._gc_remembered_locked(now)
            # Address budget: a flood of well-formed fake
            # addresses must not grow the view without bound. Entries past
            # the cap are refused wholesale — in a legitimate network the
            # cap is orders of magnitude above the node count, and a later
            # flood re-offers anything a hostile burst crowded out.
            known = self._total_peers_locked()
            budget = self.max_known_addresses - len(known)
            refused = 0
            stale = set()
            for parent, children in received.items():
                if not valid_address(parent) or not isinstance(
                    children, list
                ):
                    continue  # hostile/corrupt flood entry (wire-fuzz)
                live_children = []
                for addr in children:
                    if not valid_address(addr):
                        continue
                    if addr in self._tombstones:
                        stale.add(addr)
                        self._renew_tombstone_locked(addr, now)
                    else:
                        live_children.append(addr)
                if parent in self._tombstones:
                    stale.add(parent)
                    self._renew_tombstone_locked(parent, now)
                    # the parent is dead but its children may be live
                    # survivors only ever advertised through it — remember
                    # them as re-dial candidates even though there is no
                    # live edge to merge them under
                    for addr in live_children:
                        if addr != self.node_id and self.peers_to_reconnect.get(
                            addr
                        ) is not True:
                            if (
                                addr in self.peers_to_reconnect
                                or len(self.peers_to_reconnect)
                                < self.max_known_addresses
                            ):
                                self.peers_to_reconnect[addr] = True
                                self._remembered_at[addr] = now
                    continue
                if parent not in self.all_peers:
                    # an entry whose every child was tombstone-filtered is
                    # itself stale — adding {parent: []} would pollute the
                    # view (pruning deletes emptied parents)
                    if live_children or not children:
                        new = {
                            a
                            for a in (parent, *live_children)
                            if a not in known and a != self.node_id
                        }
                        if len(new) > budget:
                            refused += len(new)
                            continue
                        budget -= len(new)
                        known |= new
                        self.all_peers[parent] = list(live_children)
                        changed = True
                else:
                    have = set(self.all_peers[parent])
                    allowed = []
                    for addr in live_children:
                        if addr in have:
                            continue
                        if addr in known or addr == self.node_id:
                            allowed.append(addr)
                        elif budget > 0:
                            budget -= 1
                            known.add(addr)
                            allowed.append(addr)
                        else:
                            refused += 1
                    if allowed:
                        self.all_peers[parent] = sorted(have | set(allowed))
                        changed = True
            if refused:
                logger.warning(
                    "flood merge refused %d new addresses past the "
                    "%d-address view cap",
                    refused,
                    self.max_known_addresses,
                )
            self._stale_seen.extend(
                a for a in sorted(stale) if a not in self._stale_seen
            )
            # revive liveness flags for any address we can now see, and
            # REMEMBER every address (reconnect_candidate's pool: a node
            # orphaned later must be able to re-dial survivors it only
            # ever knew transitively, not just its own ex-neighbors).
            # The view itself is capped above, so this pool's growth from
            # here is bounded by the same budget.
            for parent, children in self.all_peers.items():
                for addr in (parent, *children):
                    if addr == self.node_id:
                        continue
                    self._remembered_at[addr] = now
                    if self.peers_to_reconnect.get(addr) is not True:
                        self.peers_to_reconnect[addr] = True
        return changed

    def _gc_remembered_locked(self, now: float) -> None:
        """Age out remembered addresses that are neither neighbors nor in
        the current view and have not been re-attested within 10x the
        tombstone TTL — the same horizon node._reap_dead_neighbors applies
        to ``_last_seen``. Without this, every address a hostile flood
        ever slipped into the re-dial pool (or every long-dead ex-peer)
        would be remembered forever; with it the pool
        self-heals once the flood stops, and the view cap's budget frees
        back up."""
        horizon = 10.0 * self.tombstone_ttl_s
        keep = self._total_peers_locked() | self.peers_in | self.peers_out
        for addr in list(self.peers_to_reconnect):
            if addr in keep:
                continue
            t0 = self._remembered_at.setdefault(addr, now)
            if now - t0 > horizon:
                del self.peers_to_reconnect[addr]
                del self._remembered_at[addr]
        # drop orphaned timestamps (address left the pool some other way)
        for addr in [
            a for a in self._remembered_at if a not in self.peers_to_reconnect
        ]:
            del self._remembered_at[addr]

    def drain_stale(self) -> List[str]:
        """Tombstoned addresses observed in incoming floods since the last
        drain — the caller relays ``disconnect`` for each so the deletion
        reaches whichever node still holds the stale view."""
        with self._lock:
            out, self._stale_seen = self._stale_seen, []
            return out

    def live_tombstones(self) -> List[str]:
        """Currently-tombstoned addresses (for the periodic deletion
        re-broadcast): tombstones are NODE-LOCAL state, so a node that
        joins after a death has none and any stale view reaching it
        resurrects the dead peer permanently (extended churn soak, seed
        101). Re-relaying ``disconnect`` for live tombstones every
        anti-entropy tick makes the deletion a rumor with the same
        lifetime as the tombstone — joiners and stale holders both get
        re-killed copies for the whole TTL."""
        with self._lock:
            self._purge_tombstones(time.monotonic())
            return sorted(self._tombstones)

    def _renew_tombstone_locked(self, addr: str, now: float) -> None:
        """Seeing a tombstoned address still CIRCULATING in a flood means
        some node holds a stale copy — extend the deletion memory so it
        outlives the circulation (extended churn soak, seed 101: fixed
        TTLs expired while a stale view survived, and the dead peer
        resurrected permanently). Capped at 6x TTL from first burial so
        a same-address rejoin is delayed at most that long at distant
        nodes (direct contact still heals instantly via mark_alive, and
        nodes that heard the address recently REFUSE deletion rumors —
        node._on_disconnect)."""
        cap = self._buried_at.get(addr, now) + 6.0 * self.tombstone_ttl_s
        self._tombstones[addr] = min(now + self.tombstone_ttl_s, cap)

    def _purge_tombstones(self, now: float) -> None:
        for addr in [a for a, t in self._tombstones.items() if t < now]:
            del self._tombstones[addr]
        # the burial record outlives the tombstone by the full renewal cap:
        # a re-infection (neighbor's re-broadcast right after our purge)
        # then RESUMES the capped clock instead of restarting it — without
        # this, holders with staggered burial windows could alternately
        # re-infect each other and flap a live rejoined address in and out
        # of distant views without bound
        horizon = 6.0 * self.tombstone_ttl_s
        for addr in [
            a
            for a, t0 in self._buried_at.items()
            if a not in self._tombstones and now - t0 > horizon
        ]:
            del self._buried_at[addr]

    def second_link_target(self) -> Optional[str]:
        """If singly-connected, an address worth dialing for redundancy
        (reference node.py:243-249)."""
        with self._lock:
            if not (len(self.peers_in) == 1 or len(self.peers_out) == 1):
                return None
            for parent in self.all_peers:
                if (
                    parent not in self.peers_in
                    and parent not in self.peers_out
                    and parent != self.node_id
                ):
                    return parent
        return None

    # -- departure ---------------------------------------------------------
    def on_disconnect(self, address: str) -> tuple[bool, Optional[str]]:
        """Prune a departed peer.

        Returns (changed, redial): changed => our all_peers view shrank and
        should re-flood; redial is an address to dial if the departed peer
        was our parent (orphan re-join, reference node.py:360-372).
        """
        redial: Optional[str] = None
        if address == self.node_id:
            # We can never "depart" from our own view, and tombstoning our
            # own id would filter US out of every incoming flood merge.
            # Defense in depth behind the node-level ingress drop of spoofed
            # self-disconnects (node._on_message): every other path into
            # on_disconnect (dead-neighbor declarations, relayed deletions)
            # names a peer, so a self-address here is always hostile or a
            # bug.
            return False, None
        with self._lock:
            now = time.monotonic()
            self._purge_tombstones(now)
            self.peers_in.discard(address)
            self.peers_out.discard(address)

            before = {k: list(v) for k, v in self.all_peers.items()}
            was_parent_of_us = address in before and self.node_id in before[address]

            for parent in list(self.all_peers):
                children = self.all_peers[parent]
                if address in children:
                    children.remove(address)
                    if not children:
                        del self.all_peers[parent]
            self.all_peers.pop(address, None)
            changed = before != self.all_peers

            if changed:
                self.peers_to_reconnect[address] = False
                self._buried_at.setdefault(address, now)
                # Tombstone only when the disconnect actually changed our
                # view: a relayed pushback about an already-pruned address
                # must NOT renew the tombstone, or mutually-renewing relays
                # could exclude a same-address rejoin indefinitely.
                # Worst case after a rejoin inside the
                # TTL: ~one TTL of pushback churn, then the un-renewed
                # tombstones expire and the rejoin merges everywhere.
                self._tombstones[address] = now + self.tombstone_ttl_s

            if was_parent_of_us:
                # never redial ourselves (a key == node_id appears whenever
                # someone's second-link flood records us as a parent; a
                # self-dial would handshake with ourselves and write a
                # {self: [self]} loop into every view — verify r5) nor the
                # peer that just departed
                for candidate in self.all_peers:
                    if candidate not in (self.node_id, address):
                        redial = candidate
                        break
                else:
                    for sibling in before.get(address, []):
                        if sibling != self.node_id:
                            redial = sibling
                            break
        return changed, redial

    def reconnect_candidate(self) -> Optional[str]:
        """An address worth re-dialing when we have no neighbors left.

        Rotates through ``peers_to_reconnect`` (the reference's own
        remembered-peers structure, which it populates but never dials
        from — SURVEY.md §5), preferring addresses last seen alive (flag
        True) and skipping currently-tombstoned ones. Returns None when
        nothing is remembered."""
        with self._lock:
            self._purge_tombstones(time.monotonic())
            known = [
                a
                for a in self.peers_to_reconnect
                if a != self.node_id and a not in self._tombstones
            ]
            if not known:
                return None
            known.sort(
                key=lambda a: (not self.peers_to_reconnect.get(a, False), a)
            )
            self._redial_rotation += 1
            return known[self._redial_rotation % len(known)]

    def missing_candidate(self) -> Optional[str]:
        """A remembered, non-tombstoned address absent from the current
        view — the partition-repair dial target. A bridge node's death
        can split the overlay into camps that are each internally content
        (every node keeps neighbors, so the orphan re-dial never fires)
        yet permanently partitioned (extended churn soak, seed 101);
        occasionally dialing a remembered absentee re-merges the camps.
        Dead absentees cost one ignored connect datagram each."""
        with self._lock:
            self._purge_tombstones(time.monotonic())
            known = self._total_peers_locked()
            missing = [
                a
                for a in self.peers_to_reconnect
                if a != self.node_id
                and a not in known
                and a not in self._tombstones
            ]
            if not missing:
                return None
            # flag-True (last seen alive) first: repair latency must not
            # scale with the count of permanently-dead remembered
            # addresses
            missing.sort(
                key=lambda a: (not self.peers_to_reconnect.get(a, False), a)
            )
            self._missing_rotation += 1
            live_count = sum(
                1 for a in missing if self.peers_to_reconnect.get(a, False)
            )
            pool = missing[:live_count] if live_count else missing
            return pool[self._missing_rotation % len(pool)]

    # -- views -------------------------------------------------------------
    def neighbors(self) -> List[str]:
        """Directly-connected peers (the flood/gossip fan-out set,
        reference node.py:574, 593)."""
        with self._lock:
            return list(self.peers_out) + list(self.peers_in)

    def total_peers(self) -> List[str]:
        """Every known address except ourselves (the task-farm worker pool,
        reference node.py:251-260)."""
        with self._lock:
            return sorted(self._total_peers_locked())

    def _total_peers_locked(self) -> set:
        """Union of parents and children minus self; callers hold _lock.
        ONE definition shared by total_peers and health."""
        total = set(self.all_peers.keys())
        for children in self.all_peers.values():
            total.update(children)
        total.discard(self.node_id)
        return total

    def network_view(self) -> Dict[str, List[str]]:
        """The GET /network body (reference node.py:696-702)."""
        with self._lock:
            if self.all_peers:
                return {k: list(v) for k, v in self.all_peers.items()}
            return {self.node_id: []}

    def health(self) -> dict:
        """Operator view of the churn machinery (GET /metrics
        ``membership`` block): live tombstones mean recent deaths are
        being held out of flood merges; ``remembered`` is the orphan
        re-dial pool."""
        with self._lock:
            self._purge_tombstones(time.monotonic())
            return {
                # distinct peers: a pair that dialed each other lands in
                # both sets
                "neighbors": len(self.peers_in | self.peers_out),
                "known_peers": len(self._total_peers_locked()),
                "tombstones": len(self._tombstones),
                "remembered": len(self.peers_to_reconnect),
            }
