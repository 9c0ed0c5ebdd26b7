"""Fleet autopilot: the telemetry plane's closed control loops.

A copy of ``sudoku_solver_distributed_tpu/serving/autopilot.py``, the
code line for line, over the port's ``obs/histo``; the port imports nothing from
the JAX package. The join gate reads the port engine's ``ready()``: its
tier 0 is warm once the K1 and K3 builds have loaded and launched (the
JAX engine's AOT prewarm has no counterpart here).

The telemetry plane gives the fleet eyes — per-bucket device cost,
gossip-aggregated cluster digests, SLO burn rates — but every signal is
read-only: a human watches ``/metrics/cluster`` and acts, and a master
farms to peers blindly except for the binary LOST-skip. This module
closes the loop. Four control laws, each default-ON with its own escape hatch
(CLI ``--no-autopilot`` plus per-loop flags), each deterministically
provokable by the fault injectors (tests/test_autopilot.py), all
individually observable under the ``/metrics`` ``autopilot`` block:

  1. **Burn-aware admission** — an SLO fast-burn rising edge
     (obs/slo.py, event-driven via ``add_burn_listener``) tightens the
     admission controller's projected-wait shed
     (``AdmissionController.set_budget_scale``) so shedding starts
     BEFORE the p99 objective is gone; recovery relaxes with hysteresis
     (the burn must stay clear for ``relax_after_s`` before the scale
     restores — a flapping burn must not flap the admission door).
  2. **Telemetry-weighted farming** — ``rank_farm_peers`` orders farm
     candidates by a freshness-decayed load score from the gossip
     digests (net/stats.PeerTelemetry: goodput, p99, warm fraction,
     supervisor state, readiness, admission backlog) instead of plain
     sorted order — the binary LOST-skip generalized into a
     continuous preference with staleness decay (a digest aging toward
     its TTL counts for less; an expired one counts as unknown).
  3. **Hedged dispatch** — a farm cell straggling past the measured
     farm-task p99 (Dean & Barroso, "The Tail at Scale": hedge at the
     tail quantile, not a fixed timeout) is duplicated to the
     best-ranked IDLE peer; the first verified answer wins, the loser's
     late reply is deduped in the merge fold and counted
     (``engine.cost.farm.dup_solutions``), and a hedge budget bounds
     duplicates to a fraction of primary dispatches so hedging can
     never amplify an overload.
  4. **Elastic membership** — ``allow_join`` gates the joiner's anchor
     dial until ``/readyz`` would pass (engine tier-0 warm and not
     LOST), so a node joining under traffic absorbs load
     instead of timing out its first tasks; once joined, the membership
     loop bulk-prewarms the answer cache from peers' advertised hot
     sets (cache/gossip.CacheGossip.prewarm) exactly once per join.

The Autopilot holds no lock while calling into other subsystems'
locked surfaces (admission, slo, peer maps) — its own lock guards only
its counters and control state, so no ordering cycle can form
(analysis/locks.py discipline).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Iterable, List, Optional

from ..obs.histo import Histogram, LatencyWindow

logger = logging.getLogger(__name__)

# burn-aware admission defaults: halve the projected-wait budget on a
# fast-burn edge (shed at half the deadline headroom), restore after the
# burn has been clear this long
TIGHTEN_SCALE = 0.5
RELAX_AFTER_S = 5.0

# hedged dispatch defaults (the tail-at-scale knobs): hedge a cell
# straggling past max(floor, rtt_p99 × mult); before enough RTT history
# exists (< MIN_RTT_SAMPLES folds) use the cold threshold. The budget
# bounds lifetime hedges to max(1, frac × primary dispatches).
HEDGE_BUDGET_FRAC = 0.25
HEDGE_MIN_S = 0.10
HEDGE_COLD_S = 1.0
HEDGE_RTT_MULT = 1.0
MIN_RTT_SAMPLES = 8

# elastic membership: how long a joiner may defer its anchor dial while
# warming before it joins anyway — an engine that can never warm (no
# devices, broken cache dir) must not be unreachable forever
JOIN_DEFER_MAX_S = 120.0


def peer_score(digest: Optional[dict], health: Optional[str]) -> float:
    """One peer's farm preference in [0, 1] from its freshness-marked
    telemetry digest (net/stats.PeerTelemetry.snapshot row) and its
    gossip-carried supervisor state (net/stats.PeerHealth).

    Pure and deterministic — the unit-testable heart of control law 2.
    A peer with NO digest scores a neutral 0.5 (reference peers gossip
    no telemetry and must keep farming exactly as before), degraded by
    the health claim when one exists. LOST peers are excluded upstream
    (the LOST skip — this function only orders the usable set).
    """
    if digest is None:
        quality = 1.0
        freshness = 0.5
    else:
        # staleness decay: a digest about to expire counts for little —
        # acting confidently on old telemetry is how a control loop
        # chases ghosts. Clamped to [0.1, 1.0] even though expired
        # entries never reach here: age_s is receive-side bookkeeping
        # (PeerTelemetry.snapshot overwrites any wire-carried key of
        # that name), but a scoring function fed by gossip must bound
        # its output by construction, not by trusting its caller's
        # sanitizers
        age = float(digest.get("age_s") or 0.0)
        ttl = max(1e-6, float(digest.get("ttl_s") or 15.0))
        freshness = min(1.0, max(0.1, 1.0 - age / ttl))
        quality = 1.0
        if digest.get("ready") is False:
            # a joiner that defers advertisement never shows up here;
            # a peer that LOST readiness mid-run (engine rebuilding)
            # still answers — from its fallback — but should be last
            quality *= 0.2
        p99 = float(digest.get("p99_ms") or 0.0)
        quality *= 1.0 / (1.0 + p99 / 250.0)
        pending = float(digest.get("pending") or 0.0)
        quality *= 1.0 / (1.0 + pending / 8.0)
        wf = digest.get("warm_frac")
        if wf is not None:
            quality *= 0.5 + 0.5 * float(wf)
        sup = digest.get("supervisor")
        if sup == "degraded":
            quality *= 0.4
        elif sup == "warming":
            quality *= 0.6
        elif sup == "lost":
            quality *= 0.05
    if health == "degraded":
        quality *= 0.4
    elif health == "warming":
        quality *= 0.6
    return freshness * quality


class Autopilot:
    """The decision layer over the telemetry plane — see module docstring.

    Args:
      node: the owning P2PNode (peer maps, engine, cache gossip).
      admission: the node's AdmissionController (None → law 1 no-ops).
      slo: the node's SloEngine (None → law 1 no-ops).
      admission/farm/hedge/join: per-loop enables (the CLI's
        ``--no-autopilot-*`` escape hatches). A disabled loop restores
        the plain behavior byte-identically — callers check the flag
        before consulting the autopilot at all.
      interval_s: the control thread's tick cadence (relax hysteresis
        and the join/prewarm sequencing run here; tightening is
        event-driven off the SLO burn edge).
    """

    def __init__(
        self,
        node,
        *,
        admission=None,
        slo=None,
        admission_loop: bool = True,
        farm_loop: bool = True,
        hedge_loop: bool = True,
        join_loop: bool = True,
        tighten_scale: float = TIGHTEN_SCALE,
        relax_after_s: float = RELAX_AFTER_S,
        hedge_budget_frac: float = HEDGE_BUDGET_FRAC,
        hedge_min_s: float = HEDGE_MIN_S,
        hedge_cold_s: float = HEDGE_COLD_S,
        hedge_rtt_mult: float = HEDGE_RTT_MULT,
        join_defer_max_s: float = JOIN_DEFER_MAX_S,
        interval_s: float = 0.25,
    ):
        self.node = node
        self.admission = admission
        self.slo = slo
        self.admission_enabled = bool(
            admission_loop and admission is not None and slo is not None
        )
        self.farm_enabled = bool(farm_loop)
        self.hedge_enabled = bool(hedge_loop)
        self.join_enabled = bool(join_loop)
        self.tighten_scale = float(tighten_scale)
        self.relax_after_s = float(relax_after_s)
        self.hedge_budget_frac = float(hedge_budget_frac)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_cold_s = float(hedge_cold_s)
        self.hedge_rtt_mult = float(hedge_rtt_mult)
        self.join_defer_max_s = float(join_defer_max_s)
        self.interval_s = float(interval_s)

        self._lock = threading.Lock()
        # law 1 state/counters
        self.tightens = 0
        self.relaxes = 0
        self._tightened = False
        self._burn_clear_since: Optional[float] = None
        # law 2 counters
        self.rank_calls = 0
        # law 3 state/counters (RTT window under the autopilot lock —
        # the histo classes are owner-locked by contract)
        self._rtt = LatencyWindow(window=512)
        # histogram twin of the window: the telemetry digest reads its
        # p99 from HERE (O(buckets)) because build_digest runs on the
        # UDP gossip loop, where sorting the window per wakeup is the
        # THREAD104 loop-stall class; the hedge threshold keeps the
        # exact window percentile (it runs on farm handler threads)
        self._rtt_hist = Histogram()
        self._rtt_count = 0
        # cold-threshold gossip seeding: times the hedge threshold was answered from a peer's
        # gossiped farm p99 because local RTT history was still cold
        self.hedge_gossip_seeds = 0
        self.primary_dispatches = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.hedge_losses = 0
        self.hedges_denied_budget = 0
        self.late_dups = 0
        # law 4 state/counters
        self._born = time.monotonic()
        self.deferred_dials = 0
        self._join_ready_at: Optional[float] = None
        self._prewarm_done = False
        self._prewarm_thread: Optional[threading.Thread] = None

        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        if self.admission_enabled:
            # event-driven tighten: the rising edge lands here the tick
            # it happens, not up to interval_s later
            slo.add_burn_listener(self._on_burn_edge)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Start the control thread (relax hysteresis + membership
        sequencing). Idempotent."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="autopilot", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._shutdown = True
        if self.admission_enabled:
            # a retired autopilot must stop steering admission: a later
            # burn edge would otherwise reach this object's stale
            # hysteresis state and fight whatever replaced it
            self.slo.remove_burn_listener(self._on_burn_edge)

    def _run(self) -> None:
        while not self._shutdown:
            try:
                self.tick()
            except Exception:  # a control-law bug must not kill the loop
                logger.exception("autopilot tick failed")
            time.sleep(self.interval_s)

    def tick(self, now: Optional[float] = None) -> None:
        """One control evaluation — called by the thread, and directly
        (with an explicit clock) by tests."""
        now = time.monotonic() if now is None else now
        if self.admission_enabled:
            self.slo.maybe_tick()
            self._admission_control(self.slo.fast_burn_active(), now)
        self._membership_control(now)

    # -- law 1: burn-aware admission -----------------------------------------
    def _on_burn_edge(self, active: bool) -> None:
        if self.admission_enabled:
            self._admission_control(active, time.monotonic())

    def _admission_control(self, burning: bool, now: float) -> None:
        """Tighten on burn, relax with hysteresis on recovery."""
        with self._lock:
            if burning:
                self._burn_clear_since = None
                if not self._tightened:
                    self._tightened = True
                    self.tightens += 1
                    apply = self.tighten_scale
                else:
                    return
            else:
                if not self._tightened:
                    return
                if self._burn_clear_since is None:
                    self._burn_clear_since = now
                    return
                if now - self._burn_clear_since < self.relax_after_s:
                    return
                self._tightened = False
                self._burn_clear_since = None
                self.relaxes += 1
                apply = 1.0
        # admission's own lock, never nested under ours
        self.admission.set_budget_scale(apply)
        logger.info(
            "autopilot admission: budget scale -> %.2f (%s)",
            apply, "fast burn" if apply < 1.0 else "recovered",
        )

    # -- law 2: telemetry-weighted farming -----------------------------------
    def rank_farm_peers(self, peers: Iterable[str]) -> List[str]:
        """Order the usable farm candidates best-first by freshness-
        decayed load score. Deterministic: score desc, peer id asc —
        peers with no telemetry keep a stable middle rank (the digest-
        free reference fleet farms in a fixed order, as before)."""
        telemetry = getattr(self.node, "peer_telemetry", None)
        health = getattr(self.node, "peer_health", None)
        digests: Dict[str, dict] = (
            telemetry.snapshot() if telemetry is not None else {}
        )
        ttl = getattr(telemetry, "ttl_s", 15.0)
        with self._lock:
            self.rank_calls += 1
        scored = []
        for p in peers:
            d = digests.get(p)
            if d is not None:
                d = dict(d, ttl_s=ttl)
            h = health.get(p) if health is not None else None
            scored.append((-peer_score(d, h), p))
        scored.sort()
        return [p for _, p in scored]

    # -- law 3: hedged dispatch ----------------------------------------------
    def note_primary_dispatch(self, n: int = 1) -> None:
        with self._lock:
            self.primary_dispatches += n

    def note_farm_rtt(self, seconds: float) -> None:
        """One completed farm task's dispatch→fold round trip — the
        sample stream the hedge threshold's p99 is read from."""
        with self._lock:
            self._rtt.add(max(0.0, seconds))
            self._rtt_hist.add(max(0.0, seconds))
            self._rtt_count += 1

    def hedge_threshold_s(self) -> float:
        """How long a dispatched cell may straggle before it is hedged:
        the measured farm-task p99 (floored) once enough history exists;
        under ``MIN_RTT_SAMPLES`` local folds, a FRESH peer's gossiped
        farm p99 (telemetry digest ``farm_rtt_p99_ms`` — only nodes
        with real history publish it) replaces the cold guess, so an
        idle master inherits the fleet's measured tail instead of
        keeping the 1 s default forever; the
        conservative cold threshold only when the whole fleet is cold."""
        with self._lock:
            cold = self._rtt_count < MIN_RTT_SAMPLES
            p99 = (
                None if cold else self._rtt.summary_ms()["p99_ms"] / 1e3
            )
        if p99 is None:
            # peer telemetry read OUTSIDE our lock (its own lock)
            p99 = self._gossiped_farm_p99_s()
            if p99 is None:
                return self.hedge_cold_s
            with self._lock:
                self.hedge_gossip_seeds += 1
        return max(self.hedge_min_s, p99 * self.hedge_rtt_mult)

    def _gossiped_farm_p99_s(self) -> Optional[float]:
        """The fleet's measured farm-task p99, from FRESH peer telemetry
        digests only. The MAX across peers — hedging too eagerly on one
        fast peer's number is the failure shape; too conservatively just
        keeps the cold behavior. None when no fresh peer publishes one
        (digests carry ``farm_rtt_p99_ms`` only past MIN_RTT_SAMPLES
        local folds — obs/cluster.build_digest — so a fleet of idle
        masters can never anchor each other to the re-gossiped cold
        default)."""
        telemetry = getattr(self.node, "peer_telemetry", None)
        if telemetry is None:
            return None
        vals = []
        for d in telemetry.snapshot().values():
            if not d.get("fresh"):
                continue
            v = d.get("farm_rtt_p99_ms")
            if isinstance(v, (int, float)) and 0 < float(v) < 1e7:
                vals.append(float(v))
        return max(vals) / 1e3 if vals else None

    def farm_rtt_p99_ms(self) -> Optional[float]:
        """This node's own MEASURED farm-task RTT p99 for the telemetry
        digest (obs/cluster.build_digest) — None until MIN_RTT_SAMPLES
        local folds exist, so the cold guess is never gossiped around
        the fleet."""
        with self._lock:
            if self._rtt_count < MIN_RTT_SAMPLES:
                return None
            # histogram estimate, not the window sort: this runs on the
            # UDP gossip loop via build_digest (THREAD104)
            return self._rtt_hist.quantile_ms(0.99)

    def try_hedge(self) -> bool:
        """Spend one unit of hedge budget, or refuse: lifetime hedges
        stay under max(1, frac × primary dispatches) — the bound that
        keeps tail-chasing from amplifying an overload."""
        with self._lock:
            allowance = max(
                1.0, self.hedge_budget_frac * self.primary_dispatches
            )
            if self.hedges + 1 > allowance:
                self.hedges_denied_budget += 1
                return False
            self.hedges += 1
            return True

    def note_hedge_result(self, won: bool) -> None:
        """First verified answer landed for a hedged cell: ``won`` True
        when the HEDGE copy beat the primary."""
        with self._lock:
            if won:
                self.hedge_wins += 1
            else:
                self.hedge_losses += 1

    def note_late_dup(self) -> None:
        """One late duplicate solution datagram deduped in the merge
        fold (hedged loser or UDP retransmit) — counted exactly once
        per datagram, mirrored into the cost plane by the caller."""
        with self._lock:
            self.late_dups += 1

    # -- law 4: elastic membership -------------------------------------------
    def allow_join(self) -> bool:
        """May the node dial its anchor yet? True once ``/readyz`` would
        pass (engine.ready()), or past the defer horizon — an engine
        that can never warm must not be unreachable forever."""
        if not self.join_enabled:
            return True
        engine = getattr(self.node, "engine", None)
        ready = bool(engine is not None and engine.ready())
        now = time.monotonic()
        if ready:
            with self._lock:
                if self._join_ready_at is None:
                    self._join_ready_at = now
            return True
        return now - self._born > self.join_defer_max_s

    def note_deferred_dial(self) -> None:
        with self._lock:
            self.deferred_dials += 1

    def _membership_control(self, now: float) -> None:
        """Once joined, bulk-prewarm the answer cache from peers'
        advertised hot sets — exactly once per process (the gossip layer
        itself is idempotent; re-runs after partitions are an operator
        call via cache_gossip.prewarm)."""
        if not self.join_enabled or self._prewarm_done:
            return
        gossip = getattr(self.node, "cache_gossip", None)
        membership = getattr(self.node, "membership", None)
        if gossip is None or membership is None:
            self._prewarm_done = True  # nothing to prewarm, ever
            return
        if not membership.neighbors():
            return
        if not gossip.peers.advertised():
            return  # joined, but no hot-set heartbeat has landed yet
        self._prewarm_done = True
        t = threading.Thread(
            target=self._run_prewarm, name="cache-prewarm", daemon=True
        )
        self._prewarm_thread = t
        t.start()

    def _run_prewarm(self) -> None:
        try:
            requested, landed = self.node.cache_gossip.prewarm()
            logger.info(
                "autopilot joiner prewarm: %d/%d advertised keys landed",
                landed, requested,
            )
        except Exception:
            logger.exception("joiner cache prewarm failed")

    # -- observability --------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``/metrics`` ``autopilot`` block — every loop's enable
        flag, knobs, and counters as scalar leaves (obs/prom.render
        flattens them, so the prom exposition agrees by construction)."""
        engine = getattr(self.node, "engine", None)
        adm = self.admission
        with self._lock:
            rtt_ms = self._rtt.summary_ms()
            out = {
                "enabled": {
                    "admission": self.admission_enabled,
                    "farm": self.farm_enabled,
                    "hedge": self.hedge_enabled,
                    "join": self.join_enabled,
                },
                "admission": {
                    "tightened": self._tightened,
                    "tightens": self.tightens,
                    "relaxes": self.relaxes,
                    "tighten_scale": self.tighten_scale,
                    "relax_after_s": self.relax_after_s,
                },
                "farm": {
                    "rank_calls": self.rank_calls,
                },
                "hedge": {
                    "fired": self.hedges,
                    "won": self.hedge_wins,
                    "lost": self.hedge_losses,
                    "denied_budget": self.hedges_denied_budget,
                    "late_dups": self.late_dups,
                    "primary_dispatches": self.primary_dispatches,
                    "budget_frac": self.hedge_budget_frac,
                    "rtt_samples": self._rtt_count,
                    "rtt_p99_ms": rtt_ms["p99_ms"],
                    "gossip_seeds": self.hedge_gossip_seeds,
                },
                "join": {
                    "deferred_dials": self.deferred_dials,
                    "ready_at_s": (
                        round(self._join_ready_at - self._born, 3)
                        if self._join_ready_at is not None
                        else None
                    ),
                    "prewarm_started": self._prewarm_done,
                },
            }
        # locked surfaces of OTHER subsystems, read outside our lock
        out["hedge"]["threshold_ms"] = round(
            self.hedge_threshold_s() * 1e3, 3
        )
        if adm is not None:
            out["admission"]["budget_scale"] = adm.snapshot()[
                "budget_scale"
            ]
        if self.slo is not None:
            out["admission"]["fast_burn_active"] = (
                self.slo.fast_burn_active()
            )
        if engine is not None:
            out["join"]["ready"] = engine.ready()
        out["hedge"]["tasks_received"] = getattr(
            self.node, "hedge_tasks_received", 0
        )
        return out
