"""Node CLI — the port's counterpart of ``sudoku_solver_distributed_tpu/net/cli.py``.

    python -m sudoku_solver_distributed_tpu_torch.net.cli -p 8001 -s 7001 -h 1

The reference's flags, with the same meanings and defaults:
  -p  HTTP port (default 8001)
  -s  P2P/UDP port (default 7000)
  -a  anchor node "host:port" to join through
  -h  handicap in ms, divided by 100 into base_delay seconds (the
      reference's conversion); -h means handicap, not help, as in the
      reference
Extensions:
  --host        bind address (default 127.0.0.1)
  --buckets     comma-separated engine batch widths
  --board-size  board edge length the engine serves: 4, 9 (default), 16 or
                25; a body of another size answers 400
  --platform    gpu (default: the DFS kernel on the CUDA device) or cpu (the
                plain PyTorch solver); gpu with no CUDA device fails
  --no-warmup   skip the warm-up; otherwise it runs in a background thread
                after the node is built, tiered: tier 0 (the smallest
                bucket, the coalescer's batch-cap width, one segment over
                the serving pool) flips /readyz to 200, then the rest of
                the ladder widens; once every bucket is warm the process
                runs gc.collect() and gc.freeze()
  --compile-cache-dir
                root of the compile plane (compilecache/; env default
                SUDOKU_COMPILE_CACHE_DIR): the kernel library is built into
                and loaded from the kernel store under <dir>/kernels, keyed
                by its source and flags and named by the backend's
                fingerprint, so a second process loads it without nvcc;
                every warm width's warm-up launch verifies it by a
                round-trip solve (a library that fails is rebuilt once; a
                second failure fails the warm-up). Unset: _build/ beside
                the package
  --warmup-budget-s
                bound the widening past tier 0 to this many seconds; the
                buckets past it are skipped and batches tile over the warm
                widths (0, the default: warm the whole ladder)
  --batch-api   expose POST /solve_batch: many boards per request through
                the engine's bucketed batch path (up to 4096 boards); off
                by default (404)
  --seed-serving
                serve as the seed did, the baseline of transport A/Bs:
                requests serialized behind one lock, no coalescer, and the
                stdlib HTTP/1.0 transport, a connection per request
  --http-workers
                the bound of the default transport's connection-worker
                pool (net/fastserve.py; default 128). The default
                transport speaks HTTP/1.1 with keep-alive
  --no-coalesce / --coalesce-max-wait-ms / --coalesce-max-batch
                disable or tune the request coalescer
                (parallel/coalescer.py) that merges concurrent /solve
                requests into one bucketed kernel launch (default on, 2 ms
                max-wait, batches up to the largest bucket)
  --adaptive-coalesce
                scale the coalescer's wait budgets with the measured
                arrival rate (near zero when idle, the configured caps
                under load — serving/load.py)
  --no-continuous / --segment-iters / --no-segment-pipeline / --deep-lane-cap
                continuous batching, on by default with the coalescer: the
                segment kernel over a lane pool, finished lanes answered
                and refilled at every segment boundary. The first flag
                restores the closed-loop coalescer; the others set the
                segment's step budget, the serial boundary and the cap on
                lanes held by deep boards while requests queue
  --admission-capacity / --default-deadline-ms
                overload control (serving/admission.py): a bounded pending
                budget and per-request deadlines (the X-Deadline-Ms
                header); overload answers 429 + Retry-After, and requests
                that expire while queued are dropped before the kernel
                runs them. Both default off
  --serving-stats
                add a "serving" block (coalescer batch-fill, queue depth,
                wait times) to GET /stats; off by default so the
                reference's {"all", "nodes"} body stays byte-identical
  --no-answer-cache / --answer-cache-capacity
                canonical-form answer cache (cache/; ON by default): /solve
                boards canonicalize over the sudoku symmetry group at the
                front door, and repeats — or symmetries — of already
                verified answers are served from an LRU (X-Cache: hit)
                without touching admission or the device.
                --no-answer-cache is the A/B escape hatch
  --supervise-engine / --watchdog-budget-s / --breaker-threshold /
  --probe-interval-s / --fallback-concurrency / --fallback-budget-s
                failure-domain supervision (serving/health.py; off by
                default): a watchdog bounds every device call's wall time,
                a circuit breaker drives WARMING/HEALTHY/DEGRADED/LOST,
                DEGRADED/LOST answer from a bounded host-oracle fallback
                (X-Degraded: true) while half-open probes — verified
                kernel round trips — re-admit the device
  --chaos-injector
                arm the engine-seam fault injector (utils/faults.py) and
                expose POST /debug/faults to drive it (fail_next, delay_s,
                poison_bucket, clear); off by default: the route 404s
  --metrics     expose GET /metrics (per-route percentiles, the engine's
                health, warm state and device cost plane, cache,
                admission, supervision, faults, obs and SLO blocks) and
                its Prometheus spellings /metrics.prom and
                /metrics?format=prom; off by default (404)
  --no-obs      turn off the observability plane (obs/, on by default):
                request spans and the X-Timing breakdown, the /metrics obs
                block and stage histograms, the flight recorder
                (/debug/trace and POST /debug/flightrecord 404) and SLOs.
                X-Request-Id stays on every response either way
  --slo / --slo-windows / --slo-fast-burn
                declarative latency objectives (obs/slo.py, repeatable:
                --slo latency_p99_ms=500@99.9) evaluated as burn rates over
                a short and a long window (default 300,3600 s); a fast
                burn over both (default 14.4x the budget rate) records a
                flight-recorder event and dumps it
  --flightrecord-dir
                where flight-recorder dumps land (breaker trip, shed storm,
                SLO fast burn, SIGUSR2, POST /debug/flightrecord); env
                default SUDOKU_FLIGHTRECORD_DIR, else ./flightrecords
  --device-trace-dir / --device-trace-calls
                torch.profiler captures: the warm-up and the first N
                bucket calls (default 4) each write a Chrome/TensorBoard
                trace into the dir; the state rides /metrics engine.warm
  --profile-dir trace every bucket call with torch.profiler into the dir
  --failure-timeout
                declare a silent neighbor dead after this many seconds
                (default 5; 0 = only a graceful disconnect prunes a peer)
  --cache-fetch-timeout-ms
                how long a miss on a key a peer advertises waits for that
                peer's verified answer before it reaches the engine
                (cache/gossip.py; default 250; 0 = no peer fetch)
  --no-autopilot / --no-autopilot-admission / --no-autopilot-farm /
  --no-autopilot-hedge / --no-autopilot-join / --hedge-budget-pct
                the fleet autopilot (serving/autopilot.py; on by default):
                burn-aware admission, telemetry-ranked farm dispatch,
                hedged dispatch of straggling cells (at most
                --hedge-budget-pct, default 25, of primary dispatches) and
                a join deferred until /readyz would pass; the first flag
                turns all four off, the others one each
  --mesh-peers  N: surface N TPU-core pseudo-peers at /network (the JAX
                node's names, ``{id}/tpu{k}``); default 0
  --no-mesh     disable mesh-parallel bucket serving. DEFAULT ON with more
                than one shard: every bucket and segment program splits
                over the mesh (parallel/shard.py: one kernel launch a
                shard), bucket widths round up to mesh-divisible multiples
                (observable at /metrics engine.mesh); the mesh is every
                visible CUDA device, or the virtual mesh
                SUDOKU_VIRTUAL_MESH names (N or N@device: N shards on one
                device, each with its own stream; parallel/sim.py sets it
                for its children and the node logs it at startup).
                --no-mesh restores the single-device programs for A/B
  --coordinator / --num-hosts / --host-id
                multi-host mode: torch.distributed.init_process_group
                against the coordinator ("host:port", tcp://) with NCCL on
                GPU hosts and gloo on CPU hosts; every host runs this CLI,
                and the leader (--host-id 0) fans its coalesced batches and
                its frontier races out to every host's shards through the
                lockstep serving loop (parallel/serving_loop.py); the
                P2P/HTTP control plane is unchanged
  --frontier STATES_PER_DEVICE / --frontier-route / --frontier-escalate-iters
  / --frontier-handoff
                route single-board /solve through the frontier race
                (parallel/frontier.py) across the mesh's shards (the
                engine's device without one), seeding this many subtree
                states a shard (0, the default: off). With
                --frontier-route auto (default) a probe of
                --frontier-escalate-iters steps (512) answers easy boards
                and only the rest race; 'always' races every board.
                --frontier-handoff seeds an escalated race from the
                probe's unexplored subtrees instead of the board's root
"""

from __future__ import annotations

import argparse
import gc
import logging
import os
import signal
import threading
import time
from datetime import timedelta

from ..cache import AnswerCache
from ..cache.gossip import CacheGossip
from ..engine import SolverEngine
from ..obs import FlightRecorder, Tracer
from ..obs.cluster import TelemetryPublisher
from ..obs.slo import DEFAULT_WINDOWS_S, SloEngine, parse_slo
from ..ops.spec import spec_for_size
from ..parallel.mesh import Mesh, default_mesh, virtual_mesh_setting
from ..serving.admission import AdmissionController
from ..serving.autopilot import Autopilot
from ..serving.health import EngineSupervisor
from ..utils.faults import EngineFaultInjector
from ..utils.profiling import RequestMetrics
from .http_api import make_http_server
from .node import P2PNode

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Sudoku Solver Node (PyTorch/CUDA)",
        conflict_handler="resolve",
    )
    parser.add_argument("-p", type=int, default=8001, help="HTTP port")
    parser.add_argument("-s", type=int, default=7000, help="P2P port")
    parser.add_argument("-a", help="Anchor node address (host:port)")
    parser.add_argument(
        "-h", type=float, default=1, help="Handicap (delay in ms) for validation"
    )
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument(
        "--mesh-peers",
        type=int,
        default=0,
        help="surface N TPU-core pseudo-peers at /network",
    )
    parser.add_argument(
        "--buckets", default=None, help="comma-separated batch bucket widths"
    )
    parser.add_argument(
        "--board-size",
        type=int,
        default=9,
        choices=[4, 9, 16, 25],
        help="board edge length the engine serves (9, 16 hexadoku, or 25)",
    )
    parser.add_argument(
        "--platform",
        default="gpu",
        choices=["gpu", "cpu"],
        help="run the solver on the CUDA device (default) or the CPU",
    )
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument(
        "--compile-cache-dir",
        default=os.environ.get("SUDOKU_COMPILE_CACHE_DIR") or None,
        help="root of the compile plane (compilecache/): <dir>/kernels "
        "holds the kernel store the warm-up loads a verified kernel library "
        "from (and saves new builds into), <dir>/native the native "
        "oracle's. Env default: SUDOKU_COMPILE_CACHE_DIR. Unset (default): "
        "the library is built into _build/ beside the package",
    )
    parser.add_argument(
        "--warmup-budget-s",
        type=float,
        default=0.0,
        help="bound the background warm-up's ladder widening to this many "
        "seconds: tier 0 (smallest + coalescer-preferred buckets and the "
        "segment pool) always runs and flips serving warm; buckets past "
        "the budget are skipped and requests tile over the warm widths "
        "instead. 0 (default) = no budget, warm the full ladder",
    )
    parser.add_argument(
        "--frontier",
        type=int,
        default=0,
        metavar="STATES_PER_DEVICE",
        help="route single-board /solve through the search-frontier race on "
        "the engine's device with this many speculative states "
        "(0 = off: bucket-1 batch solve)",
    )
    parser.add_argument(
        "--frontier-route",
        default="auto",
        choices=["auto", "always"],
        help="with --frontier: 'auto' (default) answers easy requests from "
        "a short bucket-path probe and escalates only deep-search boards "
        "to the race; 'always' races every request",
    )
    parser.add_argument(
        "--frontier-escalate-iters",
        type=int,
        default=512,
        help="auto-route probe budget in lockstep iterations before a "
        "request escalates to the frontier race",
    )
    parser.add_argument(
        "--frontier-handoff",
        action="store_true",
        help="seed escalated races from the auto-route probe's unexplored "
        "subtrees instead of restarting from the board's root (off by "
        "default)",
    )
    parser.add_argument(
        "--batch-api",
        action="store_true",
        help="expose POST /solve_batch (the engine's bucketed batch path "
        "over HTTP; opt-in — off keeps the reference 404 surface)",
    )
    parser.add_argument(
        "--seed-serving",
        action="store_true",
        help="serve as the seed did, for A/B measurement: requests "
        "serialized behind one lock, no coalescer, the stdlib HTTP/1.0 "
        "transport",
    )
    parser.add_argument(
        "--http-workers",
        type=int,
        default=128,
        help="connection-worker pool bound for the serving transport "
        "(net/fastserve.py): a connection flood exhausts a queue, not "
        "the process thread table",
    )
    parser.add_argument(
        "--serving-stats",
        action="store_true",
        help="add a 'serving' block (coalescer batch-fill / queue-depth / "
        "wait-time) to GET /stats; off keeps the reference stats body "
        "byte-identical",
    )
    parser.add_argument(
        "--no-coalesce",
        action="store_true",
        help="disable the request coalescer: every /solve pays its own "
        "width-1 kernel launch (for A/B measurement)",
    )
    parser.add_argument(
        "--coalesce-max-wait-ms",
        type=float,
        default=2.0,
        help="longest a lone request waits for batch co-riders before its "
        "bucket dispatches anyway (default 2 ms)",
    )
    parser.add_argument(
        "--coalesce-max-batch",
        type=int,
        default=None,
        help="cap boards per coalesced kernel launch (default: the largest "
        "bucket)",
    )
    parser.add_argument(
        "--adaptive-coalesce",
        action="store_true",
        help="scale the coalescer wait budgets with the measured arrival "
        "rate: near-zero wait when idle, the configured budgets under "
        "load. Off by default: fixed budgets",
    )
    parser.add_argument(
        "--no-continuous",
        action="store_true",
        help="disable continuous batching: the coalesced serving path "
        "falls back to the closed-loop run-to-completion dispatcher "
        "instead of the open-loop segmented lane pool with mid-flight "
        "refill (parallel/coalescer.py). Answers are the same boards",
    )
    parser.add_argument(
        "--segment-iters",
        type=int,
        default=None,
        help="lockstep iterations per continuous-batching segment (the "
        "sweepable k; default: ops.config.SEGMENT per board size). "
        "Smaller = finished lanes refill sooner, larger amortizes "
        "segment dispatch overhead",
    )
    parser.add_argument(
        "--no-segment-pipeline",
        action="store_true",
        help="disable the pipelined segment boundary: the continuous "
        "segment loop reads the full packed rows every segment and runs its "
        "boundaries strictly serially. Answers are bit-identical either "
        "way",
    )
    parser.add_argument(
        "--deep-lane-cap",
        type=int,
        default=0,
        help="with continuous batching: max lanes boards resident past "
        "a few segment boundaries may hold while fresh demand queues — "
        "overage evicts to the deep-retry net so deep-heavy overload "
        "stops squeezing refill goodput (parallel/coalescer.py). "
        "0 (default) = no cap",
    )
    parser.add_argument(
        "--admission-capacity",
        type=int,
        default=0,
        help="max admitted /solve requests in flight; arrivals past it "
        "answer 429 + Retry-After instead of queueing without bound. 0 "
        "(default) disables the pending bound",
    )
    parser.add_argument(
        "--default-deadline-ms",
        type=float,
        default=0.0,
        help="latency budget for /solve requests without an X-Deadline-Ms "
        "header: requests whose projected queue wait exceeds it are shed "
        "429 at arrival, and admitted requests that expire waiting are "
        "dropped before the kernel runs them. 0 (default) = no deadline",
    )
    parser.add_argument(
        "--no-answer-cache",
        action="store_true",
        help="disable the canonical-form answer cache (cache/): every "
        "request pays full admission and a kernel run even for a repeat or "
        "a symmetry of an already-answered puzzle",
    )
    parser.add_argument(
        "--answer-cache-capacity",
        type=int,
        default=4096,
        help="answer-cache entries across all shards (one entry serves a "
        "puzzle's whole symmetry orbit); per-shard LRU eviction past it",
    )
    parser.add_argument(
        "--cache-fetch-timeout-ms",
        type=float,
        default=250.0,
        help="how long a local cache miss on a peer-advertised hot key "
        "waits for the peer's cache_answer before dispatching normally "
        "(cache/gossip.py); 0 disables peer fetching",
    )
    parser.add_argument(
        "--supervise-engine",
        action="store_true",
        help="failure-domain supervision for the engine/device plane "
        "(serving/health.py): a watchdog bounds device-call wall time, a "
        "circuit breaker drives WARMING/HEALTHY/DEGRADED/LOST, "
        "DEGRADED/LOST serve correct answers from a bounded host-oracle "
        "fallback (X-Degraded header) while half-open probes — verified "
        "round-trip solves — re-admit the device. Off by default",
    )
    parser.add_argument(
        "--watchdog-budget-s",
        type=float,
        default=30.0,
        help="with --supervise-engine: wall-time budget per device call "
        "before it is declared hung (bucket quarantined, breaker fed)",
    )
    parser.add_argument(
        "--breaker-threshold",
        type=int,
        default=3,
        help="with --supervise-engine: consecutive failures before "
        "DEGRADED escalates to LOST (engine rebuild + probe-gated "
        "re-admission)",
    )
    parser.add_argument(
        "--probe-interval-s",
        type=float,
        default=2.0,
        help="with --supervise-engine: half-open probe cadence while the "
        "breaker is open",
    )
    parser.add_argument(
        "--fallback-concurrency",
        type=int,
        default=2,
        help="with --supervise-engine: max concurrent host-oracle "
        "fallback solves while DEGRADED/LOST",
    )
    parser.add_argument(
        "--fallback-budget-s",
        type=float,
        default=30.0,
        help="with --supervise-engine: wall-time budget per host-oracle "
        "fallback solve; a degraded node answers 503 on boards whose "
        "search runs past it (0 = unbudgeted)",
    )
    parser.add_argument(
        "--chaos-injector",
        action="store_true",
        help="arm an engine-seam fault injector (utils/faults."
        "EngineFaultInjector) and expose POST /debug/faults to drive it "
        "(fail_next / delay_s / poison_bucket / clear). Off by default: "
        "the route 404s and no injector exists",
    )
    parser.add_argument(
        "--metrics", action="store_true", help="expose GET /metrics"
    )
    parser.add_argument(
        "--no-obs",
        action="store_true",
        help="disable the observability plane (obs/): span recording, the "
        "X-Timing breakdown, the /metrics obs block and stage histograms, "
        "the incident flight recorder and SLOs (X-Request-Id stays). On "
        "by default",
    )
    parser.add_argument(
        "--slo",
        action="append",
        default=[],
        metavar="NAME=MS@PCT",
        help="declarative latency objective, repeatable (obs/slo.py): "
        "e.g. --slo latency_p99_ms=500@99.9 means 99.9%% of requests "
        "under 500 ms; a stage prefix picks a span stage "
        "(device_latency_p99_ms=50@99). Evaluated as burn rates over two "
        "windows from the stage histograms, exposed as an 'slo' /metrics "
        "block; a fast burn records a flight-recorder event and dumps it. "
        "Needs the observability plane (not --no-obs)",
    )
    parser.add_argument(
        "--slo-windows",
        default=None,
        metavar="SHORT_S,LONG_S",
        help="with --slo: the burn-rate window pair in seconds (default "
        "300,3600)",
    )
    parser.add_argument(
        "--slo-fast-burn",
        type=float,
        default=14.4,
        help="with --slo: the fast-burn bar in multiples of the "
        "sustainable budget-spend rate (default 14.4)",
    )
    parser.add_argument(
        "--no-autopilot",
        action="store_true",
        help="disable the fleet autopilot (serving/autopilot.py): no "
        "burn-aware admission tightening, no telemetry-weighted farm "
        "ranking, no hedged dispatch, no join deferral. On by default: "
        "the loops do nothing when their inputs (SLO engine, admission, "
        "telemetry) are absent",
    )
    parser.add_argument(
        "--no-autopilot-admission",
        action="store_true",
        help="disable only the burn-aware admission loop (an SLO "
        "fast-burn edge tightening the projected-wait shed budget, "
        "relaxing with hysteresis on recovery)",
    )
    parser.add_argument(
        "--no-autopilot-farm",
        action="store_true",
        help="disable only telemetry-weighted farm ranking (masters farm "
        "in sorted peer order; LOST peers are skipped either way)",
    )
    parser.add_argument(
        "--no-autopilot-hedge",
        action="store_true",
        help="disable only hedged dispatch (a farm cell straggling past "
        "the measured farm-task p99 is no longer duplicated to an idle "
        "peer)",
    )
    parser.add_argument(
        "--no-autopilot-join",
        action="store_true",
        help="disable only elastic membership (the joiner dials its "
        "anchor at once instead of deferring until /readyz would pass, "
        "and skips the hot-set cache prewarm)",
    )
    parser.add_argument(
        "--hedge-budget-pct",
        type=float,
        default=25.0,
        help="with the autopilot's hedge loop: lifetime hedge dispatches "
        "stay under this percentage of primary dispatches (floor: one "
        "outstanding hedge)",
    )
    parser.add_argument(
        "--flightrecord-dir",
        default=os.environ.get("SUDOKU_FLIGHTRECORD_DIR") or "flightrecords",
        help="directory flight-recorder dumps are written to (breaker "
        "trip, shed storm, SLO fast burn, SIGUSR2, POST "
        "/debug/flightrecord). Env default: SUDOKU_FLIGHTRECORD_DIR",
    )
    parser.add_argument(
        "--device-trace-dir",
        default=None,
        help="record the warm-up and the first N bucket calls "
        "(--device-trace-calls) as torch.profiler traces into this dir; "
        "the capture state rides /metrics engine.warm",
    )
    parser.add_argument(
        "--device-trace-calls",
        type=int,
        default=4,
        help="with --device-trace-dir: how many bucket calls to capture "
        "after the warm-up (default 4)",
    )
    parser.add_argument(
        "--no-mesh",
        action="store_true",
        help="disable mesh-parallel bucket serving: single-device bucket "
        "programs even with more than one shard (for A/B). Default: with "
        "more than one shard, bucket batches and segments dispatch one "
        "kernel launch a shard over every local device (parallel/shard.py) "
        "and bucket widths round to mesh-divisible multiples",
    )
    parser.add_argument(
        "--coordinator",
        default=None,
        help="torch.distributed coordinator host:port (multi-host)",
    )
    parser.add_argument("--num-hosts", type=int, default=1)
    parser.add_argument("--host-id", type=int, default=0)
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="trace every bucket call with torch.profiler into this dir",
    )
    parser.add_argument(
        "--failure-timeout",
        type=float,
        default=5.0,
        help="declare a silent neighbor dead after this many seconds (0=off)",
    )
    return parser


def build_obs(args: argparse.Namespace):
    """The observability plane the arguments ask for: ``(tracer, flight,
    slo)``, each None when off. The SLO objectives are parsed here, so a
    malformed one fails the start, not a later scrape."""
    if args.no_obs:
        if args.slo:
            raise SystemExit(
                "--slo needs the observability plane (stage histograms): "
                "remove --no-obs"
            )
        return None, None, None
    flight = FlightRecorder(dump_dir=args.flightrecord_dir)
    tracer = Tracer(recorder=flight)
    slo = None
    if args.slo:
        windows = DEFAULT_WINDOWS_S
        if args.slo_windows:
            try:
                windows = tuple(float(w) for w in args.slo_windows.split(","))
                if len(windows) != 2 or min(windows) <= 0:
                    raise ValueError
            except ValueError:
                raise SystemExit(
                    f"--slo-windows wants SHORT_S,LONG_S (got "
                    f"{args.slo_windows!r})"
                ) from None
        slo = SloEngine(
            tracer.stages,
            [parse_slo(spec) for spec in args.slo],
            recorder=flight,
            windows_s=windows,
            fast_burn_threshold=args.slo_fast_burn,
        )
        tracer.slo = slo
    return tracer, flight, slo


def build_node(args: argparse.Namespace):
    """Construct the engine, the node and its HTTP server from parsed CLI
    arguments, and start the engine's tiered warm-up (unless --no-warmup),
    the GC freeze after it and the autopilot (unless --no-autopilot), each
    in a daemon thread. Returns (node, httpd), the server bound; the
    caller starts ``httpd.serve_forever`` and ``node.run`` (which joins
    the anchor given by -a) and closes ``node.autopilot`` at the end.
    ``/readyz`` answers 503 until tier 0 is warm.

    By default a node gossips what a default JAX node gossips: the answer
    cache's hot set (``cache_gossip``, with the peer fetch), the telemetry
    digest (``telemetry``, with the observability plane) and runs the
    autopilot."""
    kwargs = {
        "spec": spec_for_size(args.board_size),
        "device": "cuda" if args.platform == "gpu" else "cpu",
        "coalesce": not (args.no_coalesce or args.seed_serving),
        "coalesce_max_wait_s": args.coalesce_max_wait_ms / 1e3,
        "coalesce_max_batch": args.coalesce_max_batch,
        "coalesce_adaptive": args.adaptive_coalesce,
        # continuous batching: None resolves ops.config.CONTINUOUS_SERVING
        # (on with the coalescer); the flag is the closed-loop escape hatch
        "continuous": False if args.no_continuous else None,
        "segment_iters": args.segment_iters,
        "segment_pipeline": False if args.no_segment_pipeline else None,
        "deep_lane_cap": args.deep_lane_cap,
        "compile_cache_dir": args.compile_cache_dir,
    }
    if args.buckets:
        kwargs["buckets"] = tuple(int(b) for b in args.buckets.split(","))
    multi_host = init_hosts(args)
    setting = virtual_mesh_setting()
    if setting is not None:
        logger.info(
            "virtual mesh: %d shards on %s (SUDOKU_VIRTUAL_MESH)", *setting
        )
    local = platform_mesh(kwargs["device"])
    mesh_fanout = False
    if not args.no_mesh:
        if multi_host:
            # every host's own programs run on its local shards, while
            # bucket widths round to the GLOBAL shard count so the
            # leader's fan-out batches divide every host's
            if local.size > 1:
                kwargs["mesh"] = local
            mesh_fanout = True
            kwargs["bucket_multiple"] = args.num_hosts * local.size
        else:
            # one host: every bucket and segment program splits over the
            # local shards when there is more than one
            kwargs["mesh"] = "auto"
    if args.frontier > 0 and not multi_host:
        # the race spans the engine's mesh, else every local shard
        kwargs["frontier_mesh"] = "auto" if not args.no_mesh else local
    if args.frontier > 0:
        kwargs["frontier_states_per_device"] = args.frontier
        kwargs["frontier_route"] = args.frontier_route
        kwargs["frontier_escalate_iters"] = args.frontier_escalate_iters
        kwargs["frontier_handoff"] = args.frontier_handoff
    tracer, flight, slo = build_obs(args)
    engine = SolverEngine(**kwargs)
    serving_loop = None
    if multi_host and (args.frontier > 0 or mesh_fanout):
        serving_loop = start_serving_loop(
            engine, engine.mesh or local, args.frontier, mesh_fanout
        )
    if args.profile_dir:
        engine.profile_dir = args.profile_dir
    if args.device_trace_dir:
        # armed before the warm-up thread starts, so the warm-up is the
        # first capture
        engine.arm_device_trace(
            args.device_trace_dir, calls=args.device_trace_calls
        )
    admission = None
    if args.admission_capacity > 0 or args.default_deadline_ms > 0:
        admission = AdmissionController(
            capacity=args.admission_capacity,
            default_deadline_ms=args.default_deadline_ms,
        )
    if args.supervise_engine:
        supervisor = EngineSupervisor(
            engine,
            watchdog_budget_s=args.watchdog_budget_s,
            breaker_threshold=args.breaker_threshold,
            probe_interval_s=args.probe_interval_s,
            fallback_concurrency=args.fallback_concurrency,
            fallback_budget_s=args.fallback_budget_s or None,
        )
        if admission is not None:
            # every regime change — device lost AND device re-admitted —
            # re-anchors the capacity estimator on the throughput the node
            # can deliver NOW (serving/admission.py)
            supervisor.add_transition_callback(
                lambda _old, _new: admission.reanchor()
            )
        if flight is not None:
            # breaker trips and watchdog hangs land in the event ring and
            # dump the black box
            flight.attach_supervisor(supervisor)
    node = P2PNode(
        args.host, args.s, anchor_node=args.a, handicap=args.h / 100,
        engine=engine, mesh_peer_count=args.mesh_peers,
        failure_timeout=args.failure_timeout,
        admission=admission,
        # one recording machinery: with tracing on, the node's per-route
        # recorder IS the tracer's
        metrics=tracer.routes if tracer is not None else RequestMetrics(),
        serialize_solves=args.seed_serving,
    )
    node.tracer = tracer
    node.flight = flight
    node.slo = slo
    node.serving_loop = serving_loop
    if not args.no_answer_cache:
        node.answer_cache = AnswerCache(
            capacity=max(1, args.answer_cache_capacity)
        )
        # hot-set gossip on the stats heartbeat and the peer fetch of
        # advertised keys
        node.cache_gossip = CacheGossip(
            node.answer_cache,
            node,
            fetch_timeout_s=max(0.0, args.cache_fetch_timeout_ms) / 1e3,
        )
    if tracer is not None:
        # this node's telemetry digest rides every stats heartbeat
        # (rebuilt at most once a second), so any peer can render GET
        # /metrics/cluster
        node.telemetry = TelemetryPublisher(node)
    if args.chaos_injector:
        engine.fault_injector = EngineFaultInjector()
        node.chaos_routes = True
    if not args.no_autopilot:
        # each loop does nothing when its inputs are absent (no SLO engine:
        # no tightening; no telemetry: neutral ranking). The join loop
        # waits for the warm-up, so a --no-warmup node, which never flips
        # warm, does not defer its join
        node.autopilot = Autopilot(
            node,
            admission=admission,
            slo=slo,
            admission_loop=not args.no_autopilot_admission,
            farm_loop=not args.no_autopilot_farm,
            hedge_loop=not args.no_autopilot_hedge,
            join_loop=not args.no_autopilot_join and not args.no_warmup,
            hedge_budget_frac=max(0.0, args.hedge_budget_pct) / 100.0,
        )
        node.autopilot.start()
    if not args.no_warmup:
        # tiered: the thread flips `warmed` (and /readyz) once tier 0 ran,
        # then widens the ladder, bounded by --warmup-budget-s when set
        threading.Thread(
            target=engine.warmup,
            kwargs={"budget_s": args.warmup_budget_s or None},
            name="engine-warmup",
            daemon=True,
        ).start()
    threading.Thread(
        target=_freeze_after_warmup, args=(engine, not args.no_warmup),
        name="gc-freeze", daemon=True,
    ).start()
    httpd = make_http_server(
        node, args.host, args.p,
        expose_metrics=args.metrics,
        expose_batch=args.batch_api,
        expose_serving=args.serving_stats,
        legacy_transport=args.seed_serving,
        max_workers=args.http_workers,
    )
    return node, httpd


def init_hosts(args: argparse.Namespace) -> bool:
    """With ``--coordinator``, join the torch.distributed group: NCCL on a
    GPU host, gloo on a CPU one, ``--num-hosts`` ranks with this one
    ``--host-id``, a rendezvous over ``tcp://<coordinator>`` and a 600 s
    timeout on the rendezvous and on every collective. Returns whether
    the node is one of several hosts."""
    if not args.coordinator:
        return False
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if args.platform == "gpu" else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_hosts,
            rank=args.host_id,
            timeout=timedelta(seconds=600),
        )
    return args.num_hosts > 1


def platform_mesh(device: str):
    """This host's own shards for the platform: the virtual mesh
    SUDOKU_VIRTUAL_MESH names when it is on the platform's device type,
    else every visible CUDA device on ``cuda``, else the one CPU."""
    setting = virtual_mesh_setting()
    if setting is not None and setting[1].type == device:
        return default_mesh()
    if device == "cuda":
        from ..engine import resolve_device

        resolve_device("cuda")  # no GPU: the usual error
        return default_mesh()
    return Mesh(["cpu"])


def start_serving_loop(engine, mesh, frontier: int, fanout: bool):
    """The multi-host serving loop on every host (parallel/serving_loop.py),
    with the engine's resolved solver knobs: the batch lane armed on every
    host when ``fanout``, then started. On the leader the engine's races
    (``frontier_runner``) and bucket calls (``mesh_runner``) ride it, and
    every fan-out width is warmed: the smallest at once, the rest in the
    background in ladder order. Other hosts serve their own bucket path."""
    from ..parallel import FrontierServingLoop

    loop = FrontierServingLoop(
        mesh,
        engine.spec,
        states_per_device=max(frontier, 1),
        max_depth=engine.max_depth,
        locked=engine.locked_candidates,
        waves=engine.waves,
        naked_pairs=engine.naked_pairs,
    )
    if fanout:
        loop.enable_batch_fanout(engine)
    loop.start(warm_race=frontier > 0)
    if not loop.is_leader:
        return loop
    if frontier > 0:
        engine.frontier_runner = loop.solve
    engine.frontier_loop = loop
    if fanout:
        engine.mesh_runner = loop.solve_padded
        loop.warm_batch_fanout(engine.buckets[0], engine.max_iters)

        def _warm_remaining_widths():
            for b in engine.buckets[1:]:
                try:
                    loop.warm_batch_fanout(b, engine.max_iters)
                except Exception:  # noqa: BLE001 — warm only
                    logger.warning("background fan-out warm failed at width "
                                   "%d", b, exc_info=True)
                    return

        if len(engine.buckets) > 1:
            threading.Thread(target=_warm_remaining_widths, daemon=True,
                             name="fanout-warm").start()
    return loop


def _freeze_after_warmup(engine, warming: bool) -> None:
    """GC hygiene for a serving process: once the ladder is warm, the heap
    it built is long-lived, and a full collection over it every few
    thousand request-path allocations is wasted work. ``gc.freeze()``
    moves it to the permanent generation, so steady-state collections
    scan only the young per-request objects. Waits for ``fully_warmed``
    at most 600 s (a budget-cut warm-up never flips it: what exists by
    then is frozen)."""
    if warming:
        deadline = time.monotonic() + 600.0
        while not engine.fully_warmed and time.monotonic() < deadline:
            time.sleep(1.0)
    gc.collect()
    gc.freeze()


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )
    node, httpd = build_node(args)
    if node.flight is not None:
        try:
            # operator dump trigger: kill -USR2 <pid> writes the flight
            # record without touching the HTTP surface
            signal.signal(
                signal.SIGUSR2,
                lambda _sig, _frm: node.flight.dump(reason="sigusr2"),
            )
        except (ValueError, AttributeError, OSError):
            # not the main thread, or no SIGUSR2 on this platform: the
            # HTTP trigger still works
            pass
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        node.run()
    except KeyboardInterrupt:
        node.shutdown()
    finally:
        httpd.shutdown()
        httpd.server_close()
        if node.autopilot is not None:
            node.autopilot.close()
        node.engine.close()  # drain the coalescer (in-flight futures resolve)
        if node.serving_loop is not None and node.serving_loop.is_leader:
            node.serving_loop.stop()


if __name__ == "__main__":
    main()
