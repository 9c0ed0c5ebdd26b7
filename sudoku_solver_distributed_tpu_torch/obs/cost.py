"""Per-bucket device cost accounting: where device time actually goes.

A copy of ``sudoku_solver_distributed_tpu/obs/cost.py``, the ``engine.cost``
block of ``GET /metrics``. Every bucket call the engine finalizes —
coalesced, direct or deep-retry — records ONE sample here:

  device_s        dispatch → rows-on-the-host wall time, host clock (the
                  same span the request tracer stamps as the ``device``
                  stage)
  boards          real boards in the call (batch fill)
  pad_coalesce    pad rows added to reach the bucket width (the coalescer
                  fed fewer boards than the bucket)
  pad_mesh        pad rows a mesh's rounding adds on top; always 0 in this
                  package, which has no mesh (the key stays so the block
                  reads as the JAX package's)
  lane_steps /    the call's loop-work counters (``LoopStats``), carried
  idle_lane_steps as two trailing packed-row columns: lane utilization =
                  1 − idle/lane. The DFS kernel runs each board on its own
                  warp, so on the card it reports idle 0 and lane = Σ own
                  steps; the plain version reports lockstep counts
                  (ops/cuda_solver.py).

Every continuous-batching segment records one sample too
(``note_segment``, from the segment digest's columns), kept as the
``continuous`` sub-block with the sustained gauges the open loop is read
by.

Recording is PER BATCH, not per request (one locked append per device
call or segment). ``snapshot()`` renders cumulative totals, a rolling
recent window (pps as the operator sees it now, not since boot),
per-bucket breakdowns, and — when the engine passes its warm state —
device-seconds served per warm-up second paid.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


def _pct(part: float, whole: float) -> float:
    return round(100.0 * part / whole, 2) if whole else 0.0


class _BucketCost:
    """Cumulative counters + a bounded recent-sample ring for one width."""

    __slots__ = (
        "dispatches", "boards", "pad_coalesce", "pad_mesh", "device_s",
        "lane_steps", "idle_lane_steps", "deep_retries", "recent",
    )

    def __init__(self, window: int):
        self.dispatches = 0
        self.boards = 0
        self.pad_coalesce = 0
        self.pad_mesh = 0
        self.device_s = 0.0
        self.lane_steps = 0
        self.idle_lane_steps = 0
        self.deep_retries = 0
        # (monotonic t, device_s, boards) — the recent-throughput window
        self.recent: deque = deque(maxlen=window)


class CostAccounting:
    """Per-bucket rolling device-cost recorder (the ``engine.cost`` block).

    Args:
      window: recent-sample ring depth per bucket (throughput "now").
      recent_horizon_s: samples older than this are ignored by the
        recent-pps computation even if still in the ring — a burst an
        hour ago must not read as current throughput.
    """

    def __init__(self, window: int = 256, recent_horizon_s: float = 60.0):
        self._lock = threading.Lock()
        self._window = window
        self.recent_horizon_s = recent_horizon_s
        self._buckets: Dict[int, _BucketCost] = {}
        # batch-formation samples fed by the coalescer (one per dispatched
        # batch): how long the OLDEST rider waited for the batch to form,
        # and the realized fill — the latency the batching layer itself
        # adds, next to the device time it buys
        self._formation: deque = deque(maxlen=window)
        # continuous-batching segment samples: one per
        # dispatched segment — (t, device_s, active, width, injected,
        # resolved, lane_steps, idle_lane_steps). The recent ring feeds
        # the SUSTAINED lane-utilization gauge the open-loop acceptance
        # reads; the cumulative dict feeds the lifetime view.
        self._segments: deque = deque(maxlen=window)
        self._seg_totals = {
            "segments": 0,
            "injected": 0,
            "resolved": 0,
            "device_s": 0.0,
            "lane_steps": 0,
            "idle_lane_steps": 0,
            # pipelined-boundary evidence: speculative dispatches
            # issued before the previous digest was read, the host-side
            # boundary gap the pipeline exists to close, and the bytes
            # actually moved per boundary (digest + phase-2 solution
            # prefix on the pipelined arm, full packed rows on the
            # full-row arm — the fetch cut reads straight off this)
            "pipelined": 0,
            "boundary_host_s": 0.0,
            "fetch_bytes": 0,
        }
        # farm-route counters, fed by the task farm's merge fold (not in
        # this package yet): cell dispatches and hedge duplicates are
        # dispatch-plane spend, and a LATE duplicate ``solution``
        # datagram is counted here exactly once and NEVER as a
        # completion anywhere
        self._farm = {"dispatches": 0, "hedges": 0, "dup_solutions": 0}
        # frontier-route counters (engine._frontier_raw): races run,
        # handoff escalations among them, and the races' wall time; the
        # per-bucket ledger can't carry these because a race has no
        # bucket width
        self._frontier = {"races": 0, "escalations": 0, "device_s": 0.0}

    def record_call(
        self,
        *,
        bucket: int,
        boards: int,
        pad_coalesce: int,
        pad_mesh: int,
        device_s: float,
        lane_steps: int = 0,
        idle_lane_steps: int = 0,
        deep_retry: bool = False,
    ) -> None:
        """Fold one finalized device call. A few int adds and a deque
        append under one lock — per BATCH, never per request."""
        if device_s < 0.0:
            device_s = 0.0
        with self._lock:
            b = self._buckets.get(bucket)
            if b is None:
                b = self._buckets[bucket] = _BucketCost(self._window)
            b.dispatches += 1
            b.boards += boards
            b.pad_coalesce += pad_coalesce
            b.pad_mesh += pad_mesh
            b.device_s += device_s
            b.lane_steps += lane_steps
            b.idle_lane_steps += idle_lane_steps
            if deep_retry:
                b.deep_retries += 1
            b.recent.append((time.monotonic(), device_s, boards))

    def note_farm(
        self,
        *,
        dispatches: int = 0,
        hedges: int = 0,
        dup_solutions: int = 0,
    ) -> None:
        """Fold farm-route dispatch-plane events: primary cell
        dispatches, hedge duplicates, and late duplicate solution
        datagrams (deduped in the merge fold)."""
        with self._lock:
            self._farm["dispatches"] += dispatches
            self._farm["hedges"] += hedges
            self._farm["dup_solutions"] += dup_solutions

    def note_frontier(
        self, *, device_s: float = 0.0, escalated: bool = False
    ) -> None:
        """Fold one completed frontier race: its
        dispatch→answer wall time, and whether it was an escalation from
        a quick-probe miss rather than a direct frontier request."""
        with self._lock:
            self._frontier["races"] += 1
            self._frontier["escalations"] += int(bool(escalated))
            self._frontier["device_s"] += max(0.0, device_s)

    def note_formation(self, wait_s: float, fill: int) -> None:
        """One coalesced batch formed: the oldest rider's queue wait and
        the realized fill (parallel/coalescer.py)."""
        with self._lock:
            self._formation.append((max(0.0, wait_s), fill))

    def note_segment(
        self,
        *,
        width: int,
        active: int,
        injected: int,
        resolved: int,
        device_s: float,
        lane_steps: int = 0,
        idle_lane_steps: int = 0,
        pipelined: bool = False,
        boundary_host_s: float = 0.0,
        fetch_bytes: int = 0,
    ) -> None:
        """One continuous-batching segment finalized
        (engine.finalize_segment): lane-pool width, lanes carrying a
        live request, boards injected/resolved this boundary, and the
        segment's LoopStats. One locked append per SEGMENT.

        A segment IS a device call at the pool width, so it folds into
        the same per-bucket ledger as a closed dispatch — ``boards`` are
        the requests RESOLVED at this boundary (so bucket pps stays
        boards-answered-per-device-second), lanes without a live request
        bill as coalescer pad. The ``engine.cost`` headline totals and
        per-bucket breakdown therefore read identically across the
        closed/continuous arms; the ``continuous`` block adds the
        open-loop-only sustained gauges on top."""
        if device_s < 0.0:
            device_s = 0.0
        with self._lock:
            b = self._buckets.get(width)
            if b is None:
                b = self._buckets[width] = _BucketCost(self._window)
            b.dispatches += 1
            b.boards += resolved
            b.pad_coalesce += max(0, width - active)
            b.device_s += device_s
            b.lane_steps += lane_steps
            b.idle_lane_steps += idle_lane_steps
            b.recent.append((time.monotonic(), device_s, resolved))
            t = self._seg_totals
            t["segments"] += 1
            t["injected"] += injected
            t["resolved"] += resolved
            t["device_s"] += device_s
            t["lane_steps"] += lane_steps
            t["idle_lane_steps"] += idle_lane_steps
            t["pipelined"] += int(bool(pipelined))
            t["boundary_host_s"] += max(0.0, boundary_host_s)
            t["fetch_bytes"] += max(0, int(fetch_bytes))
            self._segments.append(
                (
                    time.monotonic(), device_s, active, width, injected,
                    resolved, lane_steps, idle_lane_steps,
                    int(bool(pipelined)), max(0.0, boundary_host_s),
                    max(0, int(fetch_bytes)),
                )
            )

    # -- reporting -----------------------------------------------------------
    def _bucket_entry(self, width: int, b: _BucketCost, now: float) -> dict:
        lanes = width * b.dispatches  # slots paid for across all calls
        rec_s = rec_boards = 0.0
        for t, dev_s, boards in b.recent:
            if now - t <= self.recent_horizon_s:
                rec_s += dev_s
                rec_boards += boards
        return {
            "dispatches": b.dispatches,
            "boards": b.boards,
            "deep_retries": b.deep_retries,
            "device_s": round(b.device_s, 4),
            "pps": round(b.boards / b.device_s, 1) if b.device_s else 0.0,
            "recent_pps": round(rec_boards / rec_s, 1) if rec_s else 0.0,
            "fill_pct": _pct(b.boards, lanes),
            "pad_coalesce_pct": _pct(b.pad_coalesce, lanes),
            "pad_mesh_pct": _pct(b.pad_mesh, lanes),
            "lane_util_pct": (
                _pct(b.lane_steps - b.idle_lane_steps, b.lane_steps)
            ),
            "lane_steps": b.lane_steps,
            "idle_lane_steps": b.idle_lane_steps,
        }

    def snapshot(self, warm_info: Optional[dict] = None) -> dict:
        """The ``engine.cost`` block: totals + per-bucket breakdown, and
        compile amortization when the engine hands over its warm state
        (device-seconds served per compile-second paid)."""
        now = time.monotonic()
        with self._lock:
            per_bucket = {
                str(w): self._bucket_entry(w, b, now)
                for w, b in sorted(self._buckets.items())
            }
            dispatches = sum(b.dispatches for b in self._buckets.values())
            boards = sum(b.boards for b in self._buckets.values())
            device_s = sum(b.device_s for b in self._buckets.values())
            pad_c = sum(b.pad_coalesce for b in self._buckets.values())
            pad_m = sum(b.pad_mesh for b in self._buckets.values())
            lanes = sum(
                w * b.dispatches for w, b in self._buckets.items()
            )
            lane_steps = sum(b.lane_steps for b in self._buckets.values())
            idle = sum(b.idle_lane_steps for b in self._buckets.values())
            formation = list(self._formation)
            seg_totals = dict(self._seg_totals)
            segments = list(self._segments)
            farm = dict(self._farm)
            frontier = dict(self._frontier)
        out = {
            "dispatches": dispatches,
            "boards": boards,
            "device_s": round(device_s, 4),
            "pps": round(boards / device_s, 1) if device_s else 0.0,
            "fill_pct": _pct(boards, lanes),
            "pad_coalesce_pct": _pct(pad_c, lanes),
            "pad_mesh_pct": _pct(pad_m, lanes),
            "pad_waste_pct": _pct(pad_c + pad_m, lanes),
            "lane_util_pct": _pct(lane_steps - idle, lane_steps),
            # raw loop-work totals (bucket + segment planes): windowed
            # deltas of these ARE the sustained-utilization measurement
            "lane_steps": lane_steps,
            "idle_lane_steps": idle,
            "buckets": per_bucket,
        }
        if seg_totals["segments"]:
            # the continuous-batching block: lifetime totals +
            # the SUSTAINED recent-window gauges — utilization and
            # resolved-board throughput over the last recent_horizon_s of
            # segments, the "is refill actually keeping lanes busy right
            # now" number
            rec = [s for s in segments if now - s[0] <= self.recent_horizon_s]
            rec_lane = sum(s[6] for s in rec)
            rec_idle = sum(s[7] for s in rec)
            rec_dev = sum(s[1] for s in rec)
            rec_resolved = sum(s[5] for s in rec)
            rec_occ = sum(s[2] for s in rec)
            rec_slots = sum(s[3] for s in rec)
            rec_piped = sum(s[8] for s in rec)
            rec_boundary = sum(s[9] for s in rec)
            rec_fetch = sum(s[10] for s in rec)
            out["continuous"] = {
                "segments": seg_totals["segments"],
                "injected": seg_totals["injected"],
                "resolved": seg_totals["resolved"],
                "device_s": round(seg_totals["device_s"], 4),
                "lane_util_pct": _pct(
                    seg_totals["lane_steps"] - seg_totals["idle_lane_steps"],
                    seg_totals["lane_steps"],
                ),
                "sustained_lane_util_pct": _pct(
                    rec_lane - rec_idle, rec_lane
                ),
                "sustained_pps": (
                    round(rec_resolved / rec_dev, 1) if rec_dev else 0.0
                ),
                "sustained_occupancy_pct": _pct(rec_occ, rec_slots),
                "recent_segments": len(rec),
                # pipelined-boundary gauges: lifetime totals plus
                # the sustained recent-window view — is the boundary
                # actually overlapped RIGHT NOW, and what does a boundary
                # cost in host ms and fetched bytes. ``pipeline_depth``
                # is the mean in-flight segment depth (1 = strictly
                # serial boundaries, 2 = every segment had its successor
                # dispatched before its digest was read).
                "pipelined": seg_totals["pipelined"],
                "fetch_bytes": seg_totals["fetch_bytes"],
                "boundary_host_ms": round(
                    1e3 * seg_totals["boundary_host_s"]
                    / seg_totals["segments"],
                    3,
                ),
                "sustained_boundary_host_ms": (
                    round(1e3 * rec_boundary / len(rec), 3) if rec else 0.0
                ),
                "sustained_fetch_bytes_per_segment": (
                    round(rec_fetch / len(rec), 1) if rec else 0.0
                ),
                "sustained_pipeline_depth": (
                    round(1.0 + rec_piped / len(rec), 3) if rec else 0.0
                ),
            }
        if any(farm.values()):
            # the farm dispatch plane: present only once the node has
            # actually farmed, so single-node /metrics bodies never carry
            # it
            out["farm"] = farm
        if frontier["races"]:
            # same presence contract as the farm block: nodes that never
            # race keep their previous /metrics surface
            out["frontier"] = {
                "races": frontier["races"],
                "escalations": frontier["escalations"],
                "device_s": round(frontier["device_s"], 4),
            }
        if formation:
            out["formation"] = {
                "batches": len(formation),
                "avg_wait_ms": round(
                    sum(w for w, _ in formation) / len(formation) * 1e3, 3
                ),
                "avg_fill": round(
                    sum(f for _, f in formation) / len(formation), 2
                ),
            }
        if warm_info is not None:
            compile_s = 0.0
            for st in (warm_info.get("buckets") or {}).values():
                compile_s += float(st.get("compile_s") or 0.0)
            out["compile_amortization"] = {
                "compile_s": round(compile_s, 3),
                "device_s": round(device_s, 3),
                # >1 means the node has already served more device time
                # than it paid in warm-up this process lifetime
                "ratio": (
                    round(device_s / compile_s, 3) if compile_s else 0.0
                ),
            }
        return out
