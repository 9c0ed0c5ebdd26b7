"""Gossip-aggregated cluster metrics: the fleet view from any node.

A copy of ``sudoku_solver_distributed_tpu/obs/cluster.py``, the code
line for line, over the port's ``obs/prom``. The port's engine has no ``mesh``
attribute, so ``mesh_devices`` reads 1, as on a JAX node without a mesh;
the port imports nothing from the JAX package.

The request tracer gives ONE node request-lifecycle observability;
this module makes the *fleet* observable from any member: each node
builds a compact flat telemetry digest (goodput, stage latencies, shed
rate, warm fraction, supervisor state, mesh topology, device cost), the
digest rides the existing 1 Hz stats gossip as an optional trailing
``telemetry`` key (net/wire.stats_msg — absent key keeps reference
traffic byte-identical), peers fold it into a TTL'd map
(net/stats.PeerTelemetry), and ``GET /metrics/cluster`` renders the
merged view — per-peer rows with freshness, plus fleet rollups — as
JSON or Prometheus text on both transports (net/http_api route cores).

The digest is rebuilt at most once per ``min_interval_s`` no matter how
often gossip fires (``broadcast_stats`` runs once per /solve on the
serving path — a per-call histogram summary there would be a real
serving cost; a 1 s cache is invisible at gossip granularity). Rates
(goodput, shed) are deltas between consecutive rebuilds, so a node
serving nothing reports 0, not its lifetime average.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .prom import _label, _name, _num, _walk

# bump when digest fields change shape — receivers tolerate unknown keys
# (PeerTelemetry only sanitizes types), so this is documentation, not a
# compatibility gate
DIGEST_VERSION = 1


def build_digest(node, prev: Optional[tuple] = None) -> tuple:
    """One node's flat telemetry digest. Returns (digest, rate_state)
    where ``rate_state`` is (monotonic t, served count, shed count) — the
    anchor the NEXT build computes its rates against.

    Every value is a scalar (PeerTelemetry.sanitize's wire contract): the
    digest must survive a hostile-ingress sanitizer unchanged, so nothing
    nested rides it.
    """
    now = time.monotonic()
    digest: dict = {"v": DIGEST_VERSION}

    served = shed = 0
    metrics = getattr(node, "metrics", None)
    # counts(), not summary(): the digest needs only the counters, and
    # this runs on the UDP gossip loop — summary() sorts every route's
    # sample window per call (THREAD104)
    if metrics is not None and hasattr(metrics, "counts"):
        for route, entry in metrics.counts().items():
            if not route.startswith("/"):
                continue
            # goodput = answered useful work: sheds are recorded with
            # error=False (they are the control plane WORKING, histo.py)
            # but they must not count as goodput — a shedding node would
            # otherwise report goodput RISING exactly while refusing work
            served += (
                int(entry.get("count", 0))
                - int(entry.get("errors", 0))
                - int(entry.get("shed", 0))
            )
            shed += int(entry.get("shed", 0))
    if prev is not None:
        t_prev, served_prev, shed_prev = prev
        dt = max(now - t_prev, 1e-6)
        digest["goodput_rps"] = round(max(0, served - served_prev) / dt, 3)
        digest["shed_rps"] = round(max(0, shed - shed_prev) / dt, 3)
    else:
        digest["goodput_rps"] = 0.0
        digest["shed_rps"] = 0.0
    digest["served_total"] = served
    digest["shed_total"] = shed

    tracer = getattr(node, "tracer", None)
    if tracer is not None:
        # histogram-estimated quantiles (O(buckets)), NOT summary()'s
        # exact window percentiles (O(n log n) sort per stage) — gossip-
        # grade precision on the gossip thread; /metrics keeps the exact
        # ones on its pull path
        p50, p99 = tracer.stages.digest_quantiles("total", (0.5, 0.99))
        dev_p50, dev_p99 = tracer.stages.digest_quantiles(
            "device", (0.5, 0.99)
        )
        digest["p50_ms"] = p50
        digest["p99_ms"] = p99
        digest["device_p50_ms"] = dev_p50
        digest["device_p99_ms"] = dev_p99

    engine = getattr(node, "engine", None)
    if engine is not None:
        warm = getattr(engine, "_warm_state", None)
        buckets = getattr(engine, "buckets", ())
        if buckets:
            warm_count = sum(
                1
                for b in buckets
                if (warm or {}).get(b, {}).get("warm")
            )
            digest["warm_frac"] = round(warm_count / len(buckets), 3)
        sup = getattr(engine, "supervisor", None)
        if sup is not None:
            digest["supervisor"] = sup.state
        mesh = getattr(engine, "mesh", None)
        digest["mesh_devices"] = (
            int(mesh.devices.size) if mesh is not None else 1
        )
        cost = getattr(engine, "cost", None)
        if cost is not None:
            snap = cost.snapshot()
            digest["pps"] = snap["pps"]
            digest["lane_util_pct"] = snap["lane_util_pct"]
            digest["pad_waste_pct"] = snap["pad_waste_pct"]
        if hasattr(engine, "ready"):
            # readiness: /readyz's predicate, gossiped so a
            # farm master — and the autopilot's peer ranking — can
            # deprioritize a peer whose engine is rebuilding without
            # waiting for a probe round trip
            digest["ready"] = bool(engine.ready())

    adm = getattr(node, "admission", None)
    if adm is not None:
        # admission backlog: the autopilot's "least-loaded
        # eligible peer" signal for hedge target choice — a bare int
        # read (the controller's lock guards compound updates; a torn
        # read here is impossible for a CPython int)
        digest["pending"] = int(adm.pending)

    slo = getattr(node, "slo", None)
    if slo is not None:
        digest["slo_fast_burn"] = bool(slo.fast_burn_active())

    autopilot = getattr(node, "autopilot", None)
    if autopilot is not None and hasattr(autopilot, "farm_rtt_p99_ms"):
        # the node's MEASURED farm-task RTT p99: published only
        # once enough local folds exist (never the cold default — a
        # fleet of idle masters must not anchor each other to it), so a
        # cold master can seed its hedge threshold from the fleet's
        # real tail instead of guessing 1 s (serving/autopilot.py
        # hedge_threshold_s)
        farm_p99 = autopilot.farm_rtt_p99_ms()
        if farm_p99 is not None:
            digest["farm_rtt_p99_ms"] = farm_p99

    cache = getattr(node, "answer_cache", None)
    if cache is not None:
        # the answer cache's scalars: absolute hit/miss
        # counts ride the digest (not just the rate) so the fleet
        # rollup can compute a true fleet-wide hit rate instead of
        # averaging per-node percentages across unequal traffic
        snap = cache.snapshot()
        digest["cache_hits"] = snap["hits"]
        digest["cache_misses"] = snap["misses"]
        digest["cache_hit_rate_pct"] = snap["hit_rate_pct"]
        digest["cache_entries"] = snap["entries"]

    return digest, (now, served, shed)


class TelemetryPublisher:
    """Caches the node's digest between gossip sends (min_interval_s) and
    carries the rate anchor across rebuilds. The single producer the
    node's ``broadcast_stats`` asks for a ``telemetry`` payload."""

    def __init__(self, node, min_interval_s: float = 1.0):
        self.node = node
        self.min_interval_s = min_interval_s
        self._lock = threading.Lock()
        self._cached: Optional[dict] = None
        self._cached_at = 0.0
        self._rate_state: Optional[tuple] = None

    def digest(self, force: bool = False) -> dict:
        now = time.monotonic()
        with self._lock:
            if (
                not force
                and self._cached is not None
                and now - self._cached_at < self.min_interval_s
            ):
                return self._cached
            # built under the publisher lock: the builders below take
            # only leaf metric locks (RouteMetrics/StageMetrics/cost),
            # never this one — no ordering cycle, and a double build
            # under gossip concurrency would waste the exact work the
            # cache exists to save
            digest, self._rate_state = build_digest(
                self.node, self._rate_state
            )
            self._cached = digest
            self._cached_at = now
            return digest


def cluster_snapshot(node) -> dict:
    """The ``GET /metrics/cluster`` JSON body: this node's own digest,
    every unexpired peer digest with age/freshness, and fleet rollups."""
    pub = getattr(node, "telemetry", None)
    if pub is not None:
        self_digest = dict(pub.digest())
    else:
        self_digest, _ = build_digest(node)
    peers_obj = getattr(node, "peer_telemetry", None)
    peers: Dict[str, dict] = (
        peers_obj.snapshot() if peers_obj is not None else {}
    )

    # fleet rollup over self + FRESH peers only: a digest in its TTL
    # back half still renders per-peer (age visible) but must not skew
    # "what is the fleet doing now"
    rows: List[dict] = [self_digest] + [
        d for d in peers.values() if d.get("fresh")
    ]
    states: Dict[str, int] = {}
    for d in rows:
        s = d.get("supervisor")
        if isinstance(s, str):
            states[s] = states.get(s, 0) + 1
    fleet = {
        "nodes": len(rows),
        "goodput_rps": round(
            sum(float(d.get("goodput_rps") or 0.0) for d in rows), 3
        ),
        "shed_rps": round(
            sum(float(d.get("shed_rps") or 0.0) for d in rows), 3
        ),
        "pps": round(sum(float(d.get("pps") or 0.0) for d in rows), 1),
        "p99_ms_max": max(
            (float(d.get("p99_ms") or 0.0) for d in rows), default=0.0
        ),
        "warm_frac_min": min(
            (
                float(d["warm_frac"])
                for d in rows
                if d.get("warm_frac") is not None
            ),
            default=0.0,
        ),
        "mesh_devices": int(
            sum(int(d.get("mesh_devices") or 0) for d in rows)
        ),
        "supervisor_states": states,
        "slo_fast_burn": any(d.get("slo_fast_burn") for d in rows),
        # readiness rollup: how many FRESH members would pass
        # /readyz right now — the chaos bench's recovery gauge
        "ready_nodes": sum(1 for d in rows if d.get("ready")),
    }
    # fleet answer-cache hit rate: summed counts, so a busy
    # node weighs what it serves — visible from any member the moment
    # hot-set gossip converges the fleet on a viral puzzle
    c_hits = sum(int(d.get("cache_hits") or 0) for d in rows)
    c_misses = sum(int(d.get("cache_misses") or 0) for d in rows)
    if c_hits + c_misses:
        fleet["cache_hits"] = c_hits
        fleet["cache_hit_rate_pct"] = round(
            100.0 * c_hits / (c_hits + c_misses), 2
        )
    return {
        "self": {"id": getattr(node, "id", "?"), **self_digest},
        "peers": peers,
        "peer_ttl_s": getattr(peers_obj, "ttl_s", None),
        "fleet": fleet,
    }


def render_cluster_prom(payload: dict, prefix: str = "sudoku") -> str:
    """Prometheus text for the cluster view: per-node gauges labeled by
    node id (``<prefix>_cluster_node_<field>{node="host:port"}`` — the
    node id is a LABEL, not a mangled metric name, so one scrape config
    covers any fleet size), plus flattened fleet rollups. Deterministic
    walk of the same dict the JSON body serializes — the two agree by
    construction, same contract as obs/prom.render."""
    lines: list = []

    def node_rows(node_id: str, digest: dict) -> None:
        label = _label(node_id)
        for field, value in digest.items():
            if field == "id":
                continue
            if isinstance(value, bool) or isinstance(value, (int, float)):
                lines.append(
                    f"{prefix}_cluster_node_{_name(field)}"
                    f'{{node="{label}"}} {_num(value)}'
                )
            elif isinstance(value, str):
                lines.append(
                    f"{prefix}_cluster_node_{_name(field)}_info"
                    f'{{node="{label}",value="{_label(value)}"}} 1'
                )

    node_rows(payload["self"].get("id", "?"), payload["self"])
    for peer, digest in payload["peers"].items():
        node_rows(peer, digest)
    _walk(lines, (prefix, "cluster", "fleet"), payload["fleet"])
    if payload.get("peer_ttl_s") is not None:
        lines.append(
            f"{prefix}_cluster_peer_ttl_s {_num(payload['peer_ttl_s'])}"
        )
    return "\n".join(lines) + "\n"
