"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

``--seed`` seeds the generated board sets (symmetry transforms, 4x4
boards, pool rotations). Phases, each of which fails the run (non-zero
exit) on any error:

0. The static gate: ``python -m sudoku_solver_distributed_tpu_torch.analysis
   --strict --json`` in a child on this host whose imports of ``jax``
   fail (the gate is pure stdlib ``ast``: it may import neither JAX, nor
   the JAX package, nor torch). It must exit 0 (no unbaselined error, no
   stale baseline entry) with all five dispatch shapes covering all five
   legs of the dispatch contract; one ``{"static_gate": {...}}`` line
   gives its counts and wall seconds.
1. Build the kernel library from sudoku_solver_distributed_tpu_torch/csrc/
   (into its store, ``_build/``) and print ``ptxas -v``'s registers, stack
   and spills (kept in the store's record) per instance of
   every kernel (dfs_solver_kernel, dfs_segment_kernel, segment_digest_
   kernel, each at 4x4, 9x9, 16x16 and 25x25); every instance must use
   no stack and spill nothing.
2. Hold the DFS kernel (ops/cuda_solver.solve_batch_cuda) against its
   plain PyTorch version (ops/solver.solve_batch), both on CUDA tensors,
   under each board size's node configuration (``serving_config(n)``:
   locked candidates, and three sweeps a step on 9x9; on 4x4, which has
   none, the engine's defaults), on the committed
   corpora (the deep 9x9 one to a 512-step budget), on seeded symmetry
   transforms of them (which move MRV ties and
   singles across the kernel's lane boundaries), on degenerate boards,
   on the README board alone (width 1, both depth stages), and on seeded
   4x4 boards at each width of a 4x4 node's ladder (1 to 4096; clue
   conflicts at 512); and on the 9x9
   hard corpus also with naked pairs, with ``waves`` 1 and 2, and in the
   singles configuration. Grid, status, guesses and validations must be
   equal per board, and every SOLVED grid must pass the host oracle and
   keep its clues.
3. Golden counters: the DFS kernel under ``serving_config(9)`` with a
   65,536 step budget on benchmarks/corpus_9x9_deep_union.npz must meet
   tests/golden_counters.json exactly.
4. The segment kernels (ops/cuda_solver.dfs_segment: K3 and its digest
   kernel K3b) against their plain version, segment by segment: the 9x9
   hard corpus over a 4096-lane pool under budgets (3, 7, 1, 13), seeded
   rotations of new boards into freed and running lanes (pad re-seeds
   included) at pools of 512 and 64, the 16x16 and 25x25 corpora in their
   serving configs (16x16 also over the 4096-lane pool its node runs,
   25x25 over the 64-lane pool of phase 9's node), seeded 4x4 boards with
   clue conflicts rotated through a 4096-lane pool, the degenerate boards
   and the README board in a one-lane pool. State, stack frames below
   each lane's depth, digest and
   solution block must be equal in every lane. Then a chain of segments
   over the 4096 hard boards must equal one flat DFS launch at the flat
   depth, and the deep-union corpus through the engine's segment seam
   under budgets (997, 251), in both boundary arms, must equal the flat
   launch and stay inside the golden counters' +5% envelope.
5. Engine: SolverEngine over the (1, 8, 64, 512, 4096) buckets, warmed,
   solves the 4096-board hard corpus; prints boards/s.
6. The serving path without the answer cache (every node arm here runs
   with ``--no-answer-cache``, so each README /solve reaches the kernels),
   with the segment kernels' launch counter set to 0 just before and read
   just after: a node and its HTTP server built by the CLI's construction
   function (continuous batching over a 4096-lane pool, pipelined, as by
   default) answer POST /solve (README puzzle + corpus
   boards, an unsolvable board, a malformed body), GET /stats, GET
   /network and an unknown path; 16 client threads send concurrent /solve
   requests, which must all board the pool (``refills``) and share
   segments (``batch_fill_max`` above 1), and 16 more go through the
   node's solve entry point, whose answers' validations must add up to the
   /stats delta. The README /solve 20 times, each growing /stats by 109
   validations, with its p50, segments per request and the boundary host
   time; ``engine.solve_one`` alone 20 times, each 109 validations and 35
   guesses. A ``--no-segment-pipeline`` node must give the same answers. A
   node built with ``--admission-capacity`` answers ``X-Deadline-Ms: 0``
   with 429 and ``Retry-After``. Then, with the DFS kernel's counter set
   to 0, the closed loop: a ``--no-continuous`` node (105 validations, 67
   guesses per README answer) and a ``--no-coalesce`` node give their
   README p50s.
6b. The front door and supervision, each arm with both kernels' counters
   set to 0 before it and read after. (a) The default node, answer cache
   on: a README miss (109 validations) then a byte-identical
   ``X-Cache: hit`` that counts nothing; a hard-corpus board, then its
   seeded ``random_symmetry`` twin as a hit that launches no segment; the
   p50 of 20 README hits beside 20 corpus misses, and of 50 in-process
   lookups of each hit board. (b) A node with
   ``--no-answer-cache --supervise-engine --chaos-injector
   --watchdog-budget-s 0.5 --probe-interval-s 0.2``: README at 109/35 and
   its p50 beside phase 6's unsupervised one; ``poison_bucket`` at the
   pool width answers correctly with ``X-Degraded: true`` and leaves the
   node degraded; ``clear`` lets a probe (a DFS kernel launch) re-admit
   it, timed; ``fail_next 3`` drives it LOST (``/readyz`` 503), then a
   rebuild and a probe bring it back healthy, timed; a 1 s fetch delay is
   declared a hang. The oracle checks every answer.
7. Timing with CUDA events: the DFS kernel at bucket widths 1 (the README
   board, both depth stages, one sweep a step), 64, 512 and 4096 (the hard
   corpus, first depth stage, three sweeps a step) in the serving
   configuration, and in the singles configuration at the same widths,
   each beside its bound and the plain version on the same inputs; and one
   segment (k = 8) of the segment kernels over pools of 8, 64, 512 and
   4096 lanes all injected from the hard corpus, over a 4096 pool with one
   and with 16 live lanes, and each at k = 0: the pair with CUDA events,
   and K3 and K3b each on its own from torch.profiler's kernel records,
   each beside its bound and its part of the plain version. The first
   launch of each is held against the plain version.
8. The observability plane (obs/), with both kernels' counters set to 0
   before it and read after: a default node with ``--metrics`` (answer
   cache off) answers 20 README /solves with ``X-Timing``. Each echoes its
   ``X-Request-Id``, reports device time, the pool width as its bucket and
   the same segment count; its device stage equals the sum of its
   segments' dispatch-to-fetch times (host clock), and its stages sum to
   no more than its total once the pipelined segments' overlap (their
   summed times less the wall span from the first dispatch to the last
   fetch) is taken off; every segment's device stage is at least K3 +
   K3b's time by CUDA events around the launches. After 16
   concurrent clients the cost plane's segment count and its pool
   bucket's lane_steps / idle_lane_steps equal the count and the sum of
   the K3b digests' columns; ``/metrics.prom`` parses, equals
   ``?format=prom`` and every leaf of the JSON body; ``/debug/trace`` is
   trace-event JSON with the /solve spans; ``POST /debug/flightrecord``
   writes a dump holding them (in a temporary directory). A
   ``--device-trace-dir`` node's torch.profiler warm-up trace must name
   the three kernels; the README p50 of a node with the plane on and a
   ``--no-obs`` node are read in turns (on, off, off, on).
9. The rest of the single-node surface, each path with both kernels'
   counters set to 0 before it and read after. (a) Transports: the
   default node (``--no-answer-cache``) serves its keep-alive transport
   (net/fastserve.py) and, over the same node object, the stdlib arm
   (``legacy_transport=True``); in turns (fast, legacy, legacy, fast) the
   README /solve p50 over 20 requests on a keep-alive connection and a
   connection per request, the same for cache hits on a cached node, and
   16 concurrent clients (4 boards each) whose /stats validations must
   equal the same boards replayed through the node; then a
   ``--seed-serving`` node's README p50 and 16-client wall time. (b)
   ``POST /solve_batch`` (``--batch-api``): the 4096-board hard corpus in
   one request must equal ``solve_batch_np`` on a fresh engine row for
   row (SOLVED rows oracle-valid, ``solved`` / ``capped`` equal), grow
   /stats by its validations, and launch K1 only at 4096 wide; its
   boards/s over HTTP beside in-process, and the JSON encode / decode
   time; the same batch while 16 keep-alive /solve clients are in flight
   answers the same rows; a 64-board batch twice on a cached node is an
   ``X-Cache: hit``; a supervised node's batch carries no degraded flag
   before any fault and, after ``fail_next``, is a 200 with per-board
   ``degraded`` flags and ``X-Degraded: true``; no answer of an
   unsupervised node carries one. (c)
   ``--board-size 16`` (the default ladder: 16 boards sequential and 16
   concurrent, a 256-board batch, a 9x9 body's 400), ``--board-size 25
   --buckets 1,8,64`` (8 boards) and ``--board-size 4`` (16 seeded
   boards): every answer
   oracle-valid with its clues, K3 launched at each size. (d) Tiered
   warm-up: with tier 0 held at a gate, /readyz answers 503, then 200
   once the gate opens; the seconds to ready and to ``fully_warmed``;
   the GC freeze once fully warm; a CLI node in a process of its own,
   seconds from spawn to ready and to fully warm; a budget-cut node
   lists its skipped widths and tiles a 4096-board batch over its
   largest warm width (K1's launch widths), with (b)'s answers. (e)
   ``Sudoku`` on the card answers the README board's checks as on the
   CPU, and ``SudokuSolver()`` solves it on the card.
10. The P2P cluster on one card: 4 processes of the port's CLI (each its
   own CUDA context and engine) in their default configuration
   (continuous batching over the 4096-lane pool, answer cache, autopilot
   and tracing on) with ``-h 0 --metrics --failure-timeout 2`` (``-h 0``:
   the reference's handicap throttle would be what the timings measure);
   node 0 is
   the anchor and nodes 1-3 join with ``-a``. Each process starts its
   kernel wrappers' launch counts at 0 and writes them on SIGUSR1. Once
   every ``/network`` lists the 4 nodes, every ``/readyz`` answers 200 and
   every engine is fully warm: (a) the README board on node 3, a miss, is
   farmed: an oracle-valid answer with its clues (a board of many
   solutions: which one the merge keeps depends on the order the cells'
   answers arrive, as on the JAX cluster), /stats ``solved`` +1, the
   segment count of every worker's ``engine.cost`` grew (K3 ran there),
   and the farm's dispatches are counted (fewer than the 73 empty cells
   when a merged board turns unsolvable and the master's engine answers
   it); (b) 20 farmed
   corpus misses (one solution each), each equal to the single-node
   answer, each empty cell dispatched, timed beside phases 6 and 6b's
   single-node misses; (c) a board solved on node 1 and its
   ``random_symmetry`` twin sent to node 2 (or, when node 2 is not linked
   to node 1, a node that is: hot sets ride the stats gossip to direct
   links), which answers ``X-Cache: hit`` through the peer fetch; (d)
   ``/metrics/cluster`` on node 0 lists the 4 nodes and its Prometheus
   spellings answer; the launch counts are read (from each process's
   start, warm-up included, and after the warm-up) and both kernels must
   have run; (e) node 2 is SIGKILLed while a farm is in flight: the
   request still answers the single-node answer, and the survivors drop
   it within the failure timeout plus one gossip period; (f) node 1 stops
   (SIGINT, the graceful departure) and its disconnect prunes it before
   the failure timeout could. Every process is stopped at the end, and
   their logs print when the phase fails.
11. The frontier race. (a) The race kernel
   (ops/cuda_solver.dfs_race: ``dfs_race_kernel``, K4, one launch a race:
   a thread block a state, the fold in the last block) against the plain
   lockstep race (``_dfs_race_plain``) on seeded
   states (``parallel/frontier.seed_frontier``, locked, as the engine
   seeds; on the card, so K5 seeds them): four 9x9 deep-corpus boards picked by ``--seed`` at 64 states,
   the README board at 512 (2048 raced), two 16x16 deep-anneal boards at
   64 and a 25x25 one at 8 (the seeding BFS solves the rest itself,
   and two deep boards at 512 are checked to be answered that way), the
   README at 64 and capped at 8 steps, an UNSAT board, a 4x4 board with one
   clue at 8, and the first 16x16 set tiled to 1024 states; each size in the
   configuration its node races with. The packed row and every state's
   status and validations after the race must be equal, a found row's
   solution must be valid, and every state whose K4 run ended by t* must
   have K1's status, steps and validations for it. (b) Early exit: the
   steps K4's blocks ran in all beside the sum of each state's steps to its
   own end (K1 over the same states); two races back to back on one stream
   (the first stops early, the second runs past it: the scratch was reset)
   and two at once on two CUDA streams, each equal to its plain race. (c)
   K4's threads a state, stack placement and resident states per SM; its
   time per race by CUDA events (beside the parent's build in turns with
   ``--race-parent FILE``) and torch.profiler (one kernel record a race, no
   other kernel or memset), the plain race's time, the bound (the lockstep
   race's sweeps), t*, microseconds per sweep of the slowest state and the
   seeding's time (the host rounds and ``seed_frontier`` on the card,
   host clock, beside K5 alone by CUDA events), on five sets
   (``race_timing_sets``).
   (d) A ``--frontier 64`` node in its default configuration, counters set
   to 0 once warm: the README board stays on the probe (no escalation);
   16 deep 9x9 boards /solve, each escalated (``frontier_escalations``),
   correct and stamped with ``coalesce`` and ``device`` in ``X-Timing``; 4
   more through the node's solve entry point, whose race validations plus
   their probes' equal the /stats delta; the launches are read (K4, K5
   and the K1 probe must have run); then ``engine.solve_one`` on 6 of the
   deep boards, race route and ``frontier=False`` bucket path in turns
   (host clock), printed beside the deep /solve p50 and its ``coalesce``
   (seeding) and ``device`` stage p50s from ``X-Timing``; a
   ``--frontier-handoff`` node on 4 deep boards (K3 probe states seed the
   races), and ``--board-size 16`` and ``25`` frontier nodes (``--buckets
   1,8,64``) on 3 deep boards each. (e) The seeding kernel
   (ops/cuda_solver.seed_frontier_cuda: ``seed_frontier_kernel``, K5, one
   thread-block cluster whose blocks' parts sweep a state at a time, one
   launch a seeding) against
   its plain version (the host
   rounds, ``_seed_frontier_plain``) exactly: the seeded states, their
   count and the solution, on the boards of phase 11's sets at their own
   targets, boards 0-15 of the deep 9x9 corpus at 64 and 512 (where the
   seeding solves them), locked and unlocked, and a handoff seeding (the
   README's probe state); the sets must reach all three ends (target,
   solved, every state dead). Per set K5 alone (CUDA events, median of
   20), through the wrapper (host clock), the host rounds' time, rounds,
   states analyzed, microseconds a round, the cluster's blocks, the rate
   bound and beside it the round-chain floor (rounds times one block
   sweep of K4 on a board of that size, from (c)); torch.profiler sees one
   kernel record a seeding. ``seed_frontier`` on the card equals
   ``device="cpu"``, and ``frontier_solve`` answers a board its seeding
   solves with the CPU's ``info``.
12. The cold-start and durability plane. (a) The compile plane: a CLI
   node in a process of its own on a fresh ``--compile-cache-dir`` builds
   the kernel library into the store (``/metrics`` ``engine.warm.aot``:
   saved 1) and answers the README board; a second process on the same
   dir loads it (loaded 1, saved 0, every width's source ``aot``) without
   running nvcc (the stored library's file untouched), with the first
   process's README body; the spawn-to-200 seconds of both. Then the
   stored library is truncated and an engine in a process of its own
   (``SolverEngine(compile_cache_dir=...)``, not the CLI) counts an error,
   rebuilds, verifies every width and answers; beside it, an engine run
   from a read-only copy of the package, its cache dir elsewhere, builds
   and answers and writes nothing into the copy, and an engine on a copy
   of the good store whose first round-trip verification is made to fail:
   it rebuilds the library with nvcc, loads it as a new image (from a
   private copy when the bytes equal the stored build's), verifies every
   width again, is ready and answers. (b) Resumable batches
   (utils/checkpoint.py, one K3 segment a chunk): all 4096 hard boards in
   chunks of 32 steps in a child process, SIGKILLed as soon as its first
   snapshot lands, resumed by this process to the rows of an uninterrupted
   run and of the plain version (``ops.solver.solve_batch`` on the card):
   grid, solved, status, guesses, validations and iters, SOLVED grids
   oracle-valid; the deep corpus cut at 512 steps with boards RUNNING,
   resumed to the uncut run's rows; 16x16 [:256] once, equal to one flat
   K1 launch; the chunks, K3 ms a chunk (CUDA events), the snapshot's
   bytes and write ms, and the wall time beside ``solve_batch_np``. (c)
   ``generate_batch``: 64 unique 9x9 and 4 unique 16x16 boards with the
   native oracle built on this host, each solved by K1, valid, with one
   solution; ms a board. (d) A sticky CUDA fault under supervision: a
   ``--supervise-engine --no-continuous`` node in a process of its own,
   whose next K1 launch after a healthy round reads its boards from an
   illegal device address (a patch of the wrapper's launch in that process
   only): the request answers 200 from the oracle (``X-Degraded``) as a
   device fault, the node goes LOST and stays LOST (``/readyz`` 503), and
   every answer before and after is correct. (a)'s two engines and (d)'s
   node run in parallel.

13. The mesh plane on a 4-shard virtual mesh of this card
   (``parallel/mesh.virtual_mesh("cuda:0", 4)``: four shards, a CUDA
   stream each). (a) A mesh engine (its ladder rounded to (4, 8, 64, 512,
   4096)) against the one-device engine: the 4096 hard boards in one
   bucket call each, every row equal (grid, status, guesses,
   validations), 4 K1 launches the call, ``engine.mesh`` showing 4 shards
   of 1024 rows; the README board alone, in the mesh-rounded bucket of 4
   at the serving waves, equal to the plain version of the same 4-shard
   program, its grid to one device's. (b) A CLI node under
   ``SUDOKU_VIRTUAL_MESH`` (parallel/sim.py's environment) with
   ``--mesh-peers 4 --frontier 16``; the references (the plain 4-shard
   engine on the CPU, the one-device engine) answer first, then the
   counts are set to 0: README
   /solve x20 (the auto route's probe, each at the plain 4-shard probe's
   validations), the README 4 times on the mesh pool (``frontier=False``:
   109 validations each), deep /solve raced across the 4 shards (the plain
   4-shard engine's counters, one device's grids) and /solve_batch of the
   deep boards on the mesh bucket path (one device's grids and counters),
   ``/metrics`` ``engine.mesh``, the four ``/tpu{k}`` pseudo-peers at
   ``/network``; every kernel's launches on this path (no fold kernel:
   the race's last block folds). (c) The race across the 4 shards (K4's
   shard form, one launch of every shard's states, stopping on the card's
   one stop word, folded by the last block across every shard) against
   the plain race on phase 11's sets: row and fold equal, every state that
   ended by t* equal to K1's run of it, the stop words idle after; the
   stop's layout (``"device"``); each shard's steps past t*, at most 2 or
   one more than one-shard K4's own on the same states; the one call
   alone and the whole race (CUDA events) beside the one-shard race of
   the same padded states; the ``"host"`` layout (cards without peer
   access: a launch a shard, mapped host slots, the fold kernel) forced on
   the virtual mesh, two races back to back on a 9x9 and a 16x16 set
   against the plain race, its words and slots idle after each; the same
   for the ``"peer"`` layout (cards with peer access: a launch a shard,
   a word set a shard, the last block folding), with each shard's steps
   past t*, its start and the µs from the post to its last stop read from
   the kernel's clock; the shard
   launches of the first set against their plain version, and the fold
   kernel (the multi-host path's) alone over the README @512 records
   against its plain version. (d)
   ``FrontierServingLoop`` in child processes: a one-rank NCCL group (4
   shards), then two ranks on a gloo group on this card (2 shards each,
   gloo asked for by this script): a batch fan-out with one device's
   grids and the plain counters, and the README race equal to the plain
   4-shard race, its launches counted alone (one seeding kernel launch,
   one shard-form launch of this host's shards, which share the card, and
   one fold kernel after the gather). (e) A resumable batch on the mesh in a
   child, SIGKILLed at its first snapshot and resumed on one device to the
   uninterrupted run's rows.

Every node harness waits for the CLI's background warm-up to finish
(``fully_warmed``) before its phase measures, and sends the node's
flight-record dumps to a temporary directory unless the phase names one.

Prints a ``{"static_gate": {...}}`` line (phase 0), a
``{"cache_supervision": {...}}`` line (the phase 6b numbers), the
card's name and power limit, a ``{"obs": {...}}`` line (phase 8), a
``{"front": {...}}`` line (phase 9), a ``{"p2p": {...}}`` line (phase
10), a ``{"frontier": {...}}`` line (phase 11), a ``{"durability":
{...}}`` line (phase 12), a ``{"mesh": {...}}`` line (phase 13), one
``{"kernels": [...]}`` line (dfs_solver, dfs_segment_kernel,
segment_digest_kernel, dfs_race_kernel, dfs_race_shard_kernel,
race_fold_kernel and seed_frontier_kernel, each with its launches on
every path, ``launches_mesh_path`` among them; the fold kernel's on the
multi-host path of (d), the seeding kernel's on the frontier node, the
mesh node and each serving loop), and last
``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is available.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

README_PUZZLE = [
    [0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 3, 2, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 9, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 7, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 9, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 9, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 3],
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
]

# H100 SXM rates: HBM3 at 3.35 TB/s (NVIDIA data sheet); int32 ALU rate
# = 132 SMs × 64 INT32 lanes × 1.98 GHz boost (Hopper white paper).
SM_CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
# Integer operations per cell per analysis sweep: the cheapest path a cell
# takes through one sweep's singles analysis (a filled cell: load, zero and
# range compares, shift, box index and three once/twice unit updates = 21
# for the value masks, then a load and a compare each for the candidates
# and the singles). An empty cell costs about twice that, so this floor
# keeps bound_ms a lower bound. Loop and address arithmetic are not
# counted. A sweep with the locked-candidate pass adds OPS_PER_CELL_LOCKED:
# each cell's OR into its row and its column segment (2), the pointing and
# claiming masks of those two segments shared by the segment's BOX cells
# (two leave-one-out ORs and two and-nots per segment, done with prefix
# and suffix ORs: ~10 per segment, so ~7 per cell on 9x9), and the cell's
# own elimination (2 loads' OR and an and-not: 3).
OPS_PER_CELL_SWEEP = 25
OPS_PER_CELL_LOCKED = 12
SYMMETRY_SEED = 20261016
# phase 6b's supervised node: the watchdog budget, the half-open probe
# interval and the injected fetch delay that must read as a hang
WATCHDOG_BUDGET_S = 0.5
PROBE_INTERVAL_S = 0.2
HANG_DELAY_S = 1.0


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def load_corpus(name: str):
    import numpy as np

    with np.load(os.path.join(ROOT, "benchmarks", name)) as d:
        return d["boards"].astype(np.int32)


def symmetry_transforms(boards, count: int, seed: int):
    """``count`` boards, board i a random symmetry of ``boards[i % len]``:
    digit relabelling, transposition, band and stack order, and the order of
    rows within each band and of columns within each stack. Each keeps its
    source's solvability, and moves its cells (so its MRV ties and singles)
    to other flat indices. Values must lie in 0..N."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boards = np.asarray(boards, np.int32)
    n_src, N, _ = boards.shape
    box = round(N ** 0.5)

    def line_order():
        bands = rng.permutation(box)[:, None] * box
        return (bands + np.stack([rng.permutation(box) for _ in range(box)])).ravel()

    out = np.empty((count, N, N), np.int32)
    for i in range(count):
        b = np.concatenate([[0], rng.permutation(N) + 1])[boards[i % n_src]]
        if rng.random() < 0.5:
            b = b.T
        out[i] = b[line_order()][:, line_order()]
    return out


def degenerate_boards():
    """Clue conflict, empty board (overflows the 32-frame stage), an
    out-of-range value, all 5s, a solved board with one hole, and a
    negative value."""
    import numpy as np

    from sudoku_solver_distributed_tpu_torch.models import oracle_solve

    out = np.zeros((6, 9, 9), np.int32)
    out[0, 0, 0] = out[0, 0, 1] = 4
    out[2] = load_corpus("corpus_9x9_hard_4096.npz")[0]
    out[2, 4, 4] = 36
    out[3, :, :] = 5
    solved = np.asarray(oracle_solve(README_PUZZLE), np.int32)
    solved[3, 3] = 0
    out[4] = solved
    out[5] = load_corpus("corpus_9x9_hard_4096.npz")[1]
    out[5, 8, 0] = -3
    return out


SOLVED_4X4 = [[1, 2, 3, 4], [3, 4, 1, 2], [2, 1, 4, 3], [4, 3, 2, 1]]


def boards_4x4(count: int, seed: int, conflicts: bool = False):
    """``count`` seeded 4x4 boards: random symmetries of a solved grid with
    a random share of their cells emptied, from a quarter to all sixteen
    (so many have several solutions and need guesses); with ``conflicts``,
    every fourth board also gets one random clue written over a cell,
    which may leave it unsolvable."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = symmetry_transforms(np.asarray(SOLVED_4X4, np.int32)[None], count, seed)
    keep = rng.random((count, 4, 4)) >= rng.uniform(0.25, 1.0, (count, 1, 1))
    out = np.where(keep, out, 0).astype(np.int32)
    if conflicts:
        idx = np.arange(0, count, 4)
        r, c = rng.integers(0, 4, (2, idx.size))
        out[idx, r, c] = rng.integers(1, 5, idx.size)
    return out


# phase 0's child: `python -m sudoku_solver_distributed_tpu_torch.analysis
# --strict --json` with any import of jax made to fail (the card host may
# have JAX installed), reporting on stderr which of jax, the JAX package
# and torch it imported
_GATE_CHILD = """
import runpy, sys
sys.modules["jax"] = None
sys.argv[1:] = ["--strict", "--json"]
try:
    runpy.run_module("sudoku_solver_distributed_tpu_torch.analysis",
                     run_name="__main__")
finally:
    print("IMPORTED", sorted(
        n for n, m in sys.modules.items() if m is not None and n.split(".")[0]
        in ("jax", "sudoku_solver_distributed_tpu", "torch")), file=sys.stderr)
"""


def phase_static_gate() -> dict:
    """Phase 0: the port's static gate, strict, in a child process that
    cannot import JAX; its counts. Fails on a non-zero exit, on an import
    of JAX, the JAX package or torch, or on a contract matrix that is not
    five shapes each covering all five legs."""
    import importlib.util

    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _GATE_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"static gate exited {proc.returncode}:\n{proc.stdout[-4000:]}"
          f"{proc.stderr[-4000:]}")
    check("IMPORTED []" in proc.stderr,
          f"the static gate imported more than the stdlib: {proc.stderr[-2000:]}")
    body = json.loads(proc.stdout)
    matrix = body["contract_matrix"]
    green = [s["shape"] for s in matrix["shapes"] if all(s["covered"].values())]
    check(len(matrix["legs"]) == 5 and len(matrix["shapes"]) == 5
          and len(green) == 5, f"dispatch contract not all green: {matrix}")
    check(not body["errors"] and not body["stale_baseline"],
          f"static gate: errors {body['errors']} stale {body['stale_baseline']}")
    return {
        "errors": len(body["errors"]),
        "warnings": len(body["warnings"]),
        "baselined": len(body["suppressed"]),
        "stale_baseline": len(body["stale_baseline"]),
        "shapes_green": len(green),
        "legs": len(matrix["legs"]),
        "wire_consumers": len(body["wire_consumers"]),
        "wall_s": round(wall_s, 3),
        # whether this host has JAX at all; the child could not import it
        "jax_installed": importlib.util.find_spec("jax") is not None,
    }


def node_config(SolverEngine, spec_for_size, serving_config):
    """``config(size)``: the solver knobs (``serving_config``'s keys) that
    a ``--board-size`` node's engine runs. A size with a serving config
    runs it; one without (4x4) runs the engine's defaults, read off an
    engine built for that size."""

    def config(size: int) -> dict:
        try:
            return serving_config(size)
        except ValueError:
            eng = SolverEngine(spec=spec_for_size(size), coalesce=False)
            try:
                return dict(max_depth=eng.max_depth, max_iters=eng.max_iters,
                            locked_candidates=eng.locked_candidates,
                            waves=eng.waves, naked_pairs=eng.naked_pairs)
            finally:
                eng.close()

    return config


def sweeps_of(cfg) -> dict:
    """The sweep knobs of a ``serving_config(n)`` (or any solver config)."""
    return {k: cfg[k] for k in ("locked_candidates", "waves", "naked_pairs")}


SINGLES = dict(locked_candidates=False, waves=1, naked_pairs=False)


def parity_cases(serving_config, seed: int):
    """(name, boards, size, solvable, sweeps, step budget): every set under
    its size's node configuration (``node_config``), and the 9x9 hard
    corpus under four more. The deep set stops at 512 steps (its boards
    take 2,199, and the plain version's steps dominate the run); the
    golden-counter phase runs deep boards to the end. The 4x4 sets are
    made from ``seed`` at each bucket width of a 4x4 node's ladder, one
    with clue conflicts."""
    import numpy as np

    hard = load_corpus("corpus_9x9_hard_4096.npz")
    hexa = load_corpus("corpus_16x16_hard_2048.npz")
    giant = load_corpus("corpus_25x25_hard_512.npz")
    sets = [
        ("9x9 hard 4096", hard, 9, True, None),
        ("9x9 hard symmetry 4096", symmetry_transforms(hard, 4096, seed), 9, True,
         None),
        ("9x9 deep 128", load_corpus("corpus_9x9_deep_128.npz"), 9, False, 512),
        ("16x16 hard 256", hexa[:256], 16, True, None),
        ("16x16 symmetry 64", symmetry_transforms(hexa[:64], 64, seed), 16, True,
         None),
        ("25x25 hard 4", giant[:4], 25, True, None),
        ("25x25 symmetry 128", symmetry_transforms(giant[:64], 128, seed), 25, True,
         None),
        ("9x9 degenerate", degenerate_boards(), 9, False, None),
        ("9x9 README 1", np.asarray(README_PUZZLE, np.int32)[None], 9, True, None),
        ("4x4 random 4096", boards_4x4(4096, seed), 4, True, None),
        ("4x4 conflicts 512", boards_4x4(512, seed + 1, conflicts=True), 4, False,
         None),
        ("4x4 random 64", boards_4x4(64, seed + 2), 4, True, None),
        ("4x4 random 8", boards_4x4(8, seed + 3), 4, True, None),
        ("4x4 random 1", boards_4x4(1, seed + 4), 4, True, None),
    ]
    cases = [
        (f"{name} [serving]", boards, size, solvable,
         sweeps_of(serving_config(size)), iters)
        for name, boards, size, solvable, iters in sets
    ]
    serving9 = sweeps_of(serving_config(9))
    for label, sweeps in [
        ("naked pairs", dict(serving9, naked_pairs=True)),
        ("waves 1", dict(serving9, waves=1)),
        ("waves 2", dict(serving9, waves=2)),
        ("singles", SINGLES),
    ]:
        cases.append((f"9x9 hard 4096 [{label}]", hard, 9, True, sweeps, None))
    return cases


def phase_parity(cs, ts, spec_for_size, serving_config, oracle_ok, seed: int):
    import numpy as np
    import torch

    mismatches = 0
    max_abs_err = 0
    before = cs.dfs_solver.launches
    for name, boards, size, solvable, sweeps, budget in parity_cases(serving_config,
                                                                     seed):
        spec = spec_for_size(size)
        cfg = serving_config(size)
        depth, iters = cfg["max_depth"], budget or cfg["max_iters"]
        g = torch.as_tensor(boards, device="cuda")
        t0 = time.perf_counter()
        k = cs.solve_batch_cuda(g, spec, max_depth=depth, max_iters=iters, **sweeps)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = ts.solve_batch(g, spec, max_depth=depth, max_iters=iters, **sweeps)
        torch.cuda.synchronize()
        tp = time.perf_counter() - t0
        B = boards.shape[0]
        bad = torch.zeros(B, dtype=torch.bool, device="cuda")
        for f in ("grid", "status", "guesses", "validations"):
            a, b = getattr(k, f), getattr(p, f)
            bad |= (a != b).reshape(B, -1).any(dim=1)
            max_abs_err = max(
                max_abs_err, int((a.long() - b.long()).abs().max())
            )
        n_bad = int(bad.sum())
        mismatches += n_bad
        status = k.status.cpu().numpy()
        grids = k.grid.cpu().numpy()
        for i in np.flatnonzero(status == ts.SOLVED):
            clues = boards[i] != 0
            check(
                oracle_ok(grids[i].tolist())
                and (grids[i][clues] == boards[i][clues]).all(),
                f"{name}: board {i} SOLVED with an invalid grid",
            )
        if solvable:
            check(
                (status == ts.SOLVED).all(),
                f"{name}: statuses {np.bincount(status, minlength=4)}",
            )
        log(
            f"parity {name}: {n_bad} mismatching boards, kernel iters "
            f"{int(k.iters)} plain iters {p.iters}, validations "
            f"{int(k.validations.sum())}, statuses "
            f"{np.bincount(status, minlength=4).tolist()}, kernel "
            f"{tk * 1e3:.1f} ms, plain {tp * 1e3:.1f} ms (host clock)"
        )
        check(n_bad == 0, f"{name}: kernel and plain version disagree")
    check(cs.dfs_solver.launches > before, "parity phase launched no kernel")
    return mismatches, max_abs_err


def phase_golden(cs, spec_for_size, serving_config):
    """The kernel on the deep-union corpus against the committed goldens."""
    import torch

    with open(os.path.join(ROOT, "tests", "golden_counters.json")) as f:
        golden = json.load(f)
    boards = load_corpus(golden["corpus"])
    cfg = {**serving_config(9), "max_iters": golden["config"]["max_iters"]}
    t0 = time.perf_counter()
    res = cs.solve_batch_cuda(
        torch.as_tensor(boards, device="cuda"), spec_for_size(9), **cfg
    )
    got = {
        "boards": len(boards),
        "solved": int(res.solved.sum()),
        "iters": int(res.iters),
        "guesses": int(res.guesses.sum()),
        "validations": int(res.validations.sum()),
    }
    dt = time.perf_counter() - t0
    log(f"golden counters {golden['corpus']}: {got} in {dt * 1e3:.1f} ms (host clock)")
    want = {key: golden[key] for key in got}
    check(got == want, f"golden counters differ: {got} vs {want}")
    return got


def phase_engine(SolverEngine, oracle_ok):
    import numpy as np

    boards = load_corpus("corpus_9x9_hard_4096.npz")
    eng = SolverEngine(buckets=(1, 8, 64, 512, 4096))
    t0 = time.perf_counter()
    eng.warmup()
    log(f"engine warmup {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sol, mask, info = eng.solve_batch_np(boards)
    dt = time.perf_counter() - t0
    check(mask.all(), f"engine left {int((~mask).sum())} boards unsolved")
    for i in range(0, len(boards), 97):
        check(oracle_ok(sol[i].tolist()), f"engine board {i} invalid")
    log(
        f"engine solve_batch_np 4096 hard boards: {dt * 1e3:.1f} ms, "
        f"{len(boards) / dt:.0f} boards/s (host clock, one call), "
        f"validations {info['validations']}, guesses {info['guesses']}"
    )


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(base: str, path: str, body=None, headers=None):
    """(status, body bytes, response headers) of one request."""
    req = urllib.request.Request(
        base + path,
        data=body,
        headers={
            **({"Content-Type": "application/json"} if body is not None else {}),
            **(headers or {}),
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


class _Node:
    """A node and its HTTP server built by the CLI's construction function
    from ``argv``, serving on free localhost ports until ``stop()``. The
    CLI warms the engine in a background thread; unless ``wait`` is False
    (or the node has ``--no-warmup``), the constructor returns once the
    whole ladder is warm and a supervisor has left WARMING, so a phase
    never measures a half-warm node."""

    def __init__(self, build_parser, build_node, argv, wait: bool = True):
        http_port, udp_port = _free_port(), _free_port()
        # flight-record dumps (a breaker trip writes one) go to a temporary
        # directory unless the phase names its own
        self.dump_dir = None
        if "--flightrecord-dir" not in argv:
            self.dump_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_fr_")
            argv = [*argv, "--flightrecord-dir", self.dump_dir.name]
        args = build_parser().parse_args(
            ["-p", str(http_port), "-s", str(udp_port), "-h", "1", *argv]
        )
        self.node, self.httpd = build_node(args)
        self.threads = [
            threading.Thread(target=self.httpd.serve_forever, daemon=True),
            threading.Thread(target=self.node.run, daemon=True),
        ]
        for t in self.threads:
            t.start()
        self.base = f"http://127.0.0.1:{http_port}"
        if wait and not args.no_warmup:
            eng = self.node.engine
            sup = eng.supervisor
            _wait(lambda: eng.fully_warmed
                  and (sup is None or sup.state != "warming"),
                  300.0, f"the node {' '.join(argv)} to warm")

    def stop(self) -> None:
        self.node.shutdown()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.node.engine.close()
        for t in self.threads:
            t.join(timeout=10)
        if self.dump_dir is not None:
            self.dump_dir.cleanup()

    def validations(self) -> int:
        return json.loads(_http(self.base, "/stats")[1])["all"]["validations"]

    def readme_p50(self, label: str, oracle_ok, per_answer=None) -> float:
        """The README /solve over 20 requests, host clock; prints and
        returns the p50 in ms. With ``per_answer``, each request must grow
        /stats validations by exactly that (read between requests, off the
        clock)."""
        body = json.dumps({"sudoku": README_PUZZLE}).encode()
        lat_ms = []
        for _ in range(20):
            before = self.validations() if per_answer is not None else 0
            t0 = time.perf_counter()
            status, answer, _ = _http(self.base, "/solve", body)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and oracle_ok(json.loads(answer)),
                  f"/solve answered {status}")
            if per_answer is not None:
                grew = self.validations() - before
                check(grew == per_answer,
                      f"a README /solve counted {grew} validations, not {per_answer}")
        lat_ms.sort()
        log(
            f"/solve README puzzle x20, {label} (host clock, a connection "
            f"per request on localhost): p50 {lat_ms[10]:.3f} ms, min {lat_ms[0]:.3f} ms, "
            f"max {lat_ms[-1]:.3f} ms"
        )
        return lat_ms[10]


def _concurrent(n: int, fn):
    """Run ``fn(i)`` for i < n in n threads released together; returns
    the results in order (an exception in a thread is re-raised)."""
    results = [None] * n
    start = threading.Barrier(n)

    def run(i):
        start.wait()
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for r in results:
        if isinstance(r, BaseException):
            raise r
    return results


def _check_answer(board, sol, oracle_ok, what: str) -> None:
    import numpy as np

    clues = np.asarray(board) != 0
    check(
        sol is not None and oracle_ok(sol)
        and (np.asarray(sol)[clues] == np.asarray(board)[clues]).all(),
        f"{what} is not a solution of its board",
    )


def _engine_p50(engine, label: str, oracle_ok, want=None) -> float:
    """The README board through ``engine.solve_one`` alone (no HTTP, no
    node) 20 times, host clock; prints and returns the p50 in ms. With
    ``want`` = (validations, guesses), every answer must count those."""
    eng_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        sol, info = engine.solve_one(README_PUZZLE)
        eng_ms.append((time.perf_counter() - t0) * 1e3)
        check(sol is not None and oracle_ok(sol), "engine.solve_one failed")
        if want is not None:
            got = (info["validations"], info["guesses"])
            check(got == want, f"engine.solve_one README counted {got}, not {want}")
    eng_ms.sort()
    log(
        f"engine.solve_one README puzzle x20, {label} (host clock, no HTTP): "
        f"p50 {eng_ms[10]:.3f} ms, min {eng_ms[0]:.3f} ms, max {eng_ms[-1]:.3f} ms"
    )
    return eng_ms[10]


def _boundary_recorder(engine):
    """Wrap ``engine.dispatch_segment`` to record each boundary's host
    time: the gap since the previous digest arrived (the segment loop passes it
    as ``boundary_host_s``) plus the dispatch call itself, i.e. digest
    ready to next segment enqueued. Speculative and first dispatches have
    no gap and are not boundaries. Returns the list it fills."""
    real = engine.dispatch_segment
    record = []

    def dispatch(*args, **kw):
        t0 = time.perf_counter()
        handle = real(*args, **kw)
        gap = kw.get("boundary_host_s", 0.0)
        if gap > 0:
            record.append((gap + time.perf_counter() - t0) * 1e3)
        return handle

    engine.dispatch_segment = dispatch
    return record


def _ms_summary(values) -> dict:
    v = sorted(values)
    if not v:
        return {"n": 0}
    return {"n": len(v), "mean": sum(v) / len(v), "p50": v[len(v) // 2],
            "max": v[-1]}


def phase_solve_http(cs, build_parser, build_node, oracle_ok):
    """The main path and the closed-loop paths beside it. Returns the
    launches each made, the p50s it read and the segment numbers."""
    corpus = load_corpus("corpus_9x9_hard_4096.npz")
    out = {}
    # -- this slice's main path: the default node, continuous, pipelined --
    cs.dfs_segment.launches = 0
    cs.dfs_solver.launches = 0
    main = _Node(build_parser, build_node, ["--serving-stats", "--no-answer-cache"])
    eng = main.node.engine
    try:
        check(eng.continuous and eng.segment_pipeline
              and eng.segment_pool_width() == 4096,
              "the default node does not serve continuous batching on 4096 lanes")
        boundary_ms = _boundary_recorder(eng)
        base = main.base
        boards = [README_PUZZLE] + [b.tolist() for b in corpus[:4]]
        per_solve = []
        for board in boards:
            n0 = cs.dfs_segment.launches
            status, body, _ = _http(base, "/solve", json.dumps({"sudoku": board}).encode())
            per_solve.append(cs.dfs_segment.launches - n0)
            check(status == 200, f"/solve answered {status}: {body[:200]!r}")
            _check_answer(board, json.loads(body), oracle_ok, "/solve answer")
        bad = [[0] * 9 for _ in range(9)]
        bad[0][0] = bad[0][1] = 5
        status, body, _ = _http(base, "/solve", json.dumps({"sudoku": bad}).encode())
        check(
            status == 400
            and json.loads(body) == {"error": "No solution found", "solution": None},
            f"unsolvable /solve answered {status} {body!r}",
        )
        status, body, _ = _http(base, "/solve", b"{not json")
        check(status == 400, f"malformed /solve answered {status}")
        status, body, _ = _http(base, "/stats")
        stats = json.loads(body)
        check(
            status == 200 and stats["all"]["solved"] >= 5,
            f"/stats answered {status} {body!r}",
        )
        status, body, _ = _http(base, "/network")
        check(
            status == 200 and json.loads(body) == {main.node.id: []},
            f"/network answered {status} {body!r}",
        )
        status, body, _ = _http(base, "/nope")
        check(
            status == 404 and json.loads(body) == {"error": "Invalid endpoint"},
            f"GET /nope answered {status} {body!r}",
        )

        # 16 concurrent clients over HTTP: their boards share segments
        clients = [b.tolist() for b in corpus[16:32]]
        refills0 = eng.coalescer.stats()["refills"]

        def post(i):
            status, body, _ = _http(
                base, "/solve", json.dumps({"sudoku": clients[i]}).encode()
            )
            check(status == 200, f"concurrent /solve answered {status}")
            return json.loads(body)

        for i, sol in enumerate(_concurrent(16, post)):
            _check_answer(clients[i], sol, oracle_ok, "concurrent /solve answer")
        serving = json.loads(_http(base, "/stats")[1])["serving"]
        log(f"/stats serving block after 16 concurrent clients: {serving}")
        check(serving["continuous"] and serving["refills"] - refills0 >= 16,
              f"16 concurrent /solve requests did not all board the pool: {serving}")
        check(serving["batch_fill_max"] > 1,
              f"16 concurrent /solve requests never shared a segment: {serving}")
        out["batch_fill_max"] = serving["batch_fill_max"]

        # 16 more through the node's solve entry point: their validations
        # must add up to what /stats reports
        before = main.validations()
        more = [b.tolist() for b in corpus[32:48]]
        answers = _concurrent(16, lambda i: main.node.peer_sudoku_solve_info(more[i]))
        for board, (sol, _) in zip(more, answers):
            _check_answer(board, sol, oracle_ok, "peer_sudoku_solve_info answer")
        after = main.validations()
        summed = sum(info["validations"] for _, info in answers)
        log(f"/stats validations grew by {after - before}; the 16 answers' "
            f"info validations sum to {summed}; refills "
            f"{eng.coalescer.stats()['refills'] - refills0}")
        check(after - before == summed, "/stats validations disagree with the answers")

        n0 = cs.dfs_segment.launches
        out["p50_continuous"] = main.readme_p50("continuous (default)", oracle_ok,
                                                per_answer=109)
        out["segments_per_readme"] = (cs.dfs_segment.launches - n0) / 20
        out["engine_p50_continuous"] = _engine_p50(eng, "continuous (default)",
                                                   oracle_ok, want=(109, 35))
        reference = [main.node.peer_sudoku_solve_info(b)
                     for b in [README_PUZZLE] + more[:8]]
        out["boundary_host_ms"] = _ms_summary(boundary_ms)
        log(f"README /solve: {out['segments_per_readme']:.2f} segments each; "
            f"boundary host time, digest ready to next dispatch enqueued "
            f"(host clock): {out['boundary_host_ms']}")
        log(f"coalescer after the main path: {eng.coalescer.stats()}")
    finally:
        main.stop()
    out["segment_launches"] = cs.dfs_segment.launches
    out["solver_launches_continuous"] = cs.dfs_solver.launches
    check(out["segment_launches"] > 0, "the continuous main path launched no segment kernel")
    log(f"continuous main path: {out['segment_launches']} segment launches "
        f"({per_solve} per sequential /solve), {out['solver_launches_continuous']} "
        f"dfs_solver launches (warm-up and deep retries)")

    # the full-row boundary arm answers the same, counters included
    nopipe = _Node(build_parser, build_node, ["--no-segment-pipeline", "--no-answer-cache"])
    try:
        got = [nopipe.node.peer_sudoku_solve_info(b) for b in [README_PUZZLE] + more[:8]]
        check(got == reference, "--no-segment-pipeline answers differ from the default node's")
        out["p50_nopipe"] = nopipe.readme_p50("--no-segment-pipeline", oracle_ok,
                                              per_answer=109)
    finally:
        nopipe.stop()

    # admission: X-Deadline-Ms 0 is already expired at arrival
    adm = _Node(build_parser, build_node, ["--admission-capacity", "64", "--no-warmup",
                                           "--no-answer-cache"])
    try:
        body = json.dumps({"sudoku": README_PUZZLE}).encode()
        status, answer, _ = _http(adm.base, "/solve", body)
        check(status == 200, f"/solve through admission answered {status}")
        status, answer, headers = _http(adm.base, "/solve", body, {"X-Deadline-Ms": "0"})
        retry = headers.get("Retry-After")
        log(f"/solve with X-Deadline-Ms: 0 on --admission-capacity 64: {status} "
            f"{answer!r} Retry-After {retry}")
        check(
            status == 429 and retry is not None and int(retry) >= 1
            and json.loads(answer)["error"] == "Overloaded",
            "the admission node did not shed an expired request with 429",
        )
    finally:
        adm.stop()

    # the closed-loop paths: --no-continuous (the coalescer's closed loop)
    # and --no-coalesce, both through dfs_solver
    cs.dfs_solver.launches = 0
    closed = _Node(build_parser, build_node, ["--no-continuous", "--no-answer-cache"])
    try:
        n0 = cs.dfs_solver.launches
        out["p50_closed"] = closed.readme_p50("--no-continuous", oracle_ok, per_answer=105)
        out["per_readme_closed"] = (cs.dfs_solver.launches - n0) / 20
        out["engine_p50_closed"] = _engine_p50(closed.node.engine, "--no-continuous",
                                               oracle_ok, want=(105, 67))
    finally:
        closed.stop()
    direct = _Node(build_parser, build_node, ["--no-coalesce", "--no-answer-cache"])
    try:
        out["p50_no_coalesce"] = direct.readme_p50("--no-coalesce", oracle_ok)
        out["engine_p50_no_coalesce"] = _engine_p50(
            direct.node.engine, "--no-coalesce", oracle_ok
        )
    finally:
        direct.stop()
    out["solver_launches_closed"] = cs.dfs_solver.launches
    check(out["solver_launches_closed"] > 0, "the closed-loop paths launched no kernel")
    log(f"closed-loop paths: {out['solver_launches_closed']} dfs_solver launches, "
        f"{out['per_readme_closed']:.2f} per README /solve")
    return out


def _faults(base: str, cmd: dict) -> dict:
    status, body, _ = _http(base, "/debug/faults", json.dumps(cmd).encode())
    check(status == 200, f"POST /debug/faults {cmd} answered {status} {body!r}")
    return json.loads(body)["counts"]


def _wait(pred, timeout_s: float, what: str) -> float:
    """Poll ``pred`` until it holds; returns the seconds it took, fails the
    run past ``timeout_s``."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout_s, f"timed out waiting for {what}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _p50_ms(samples) -> float:
    return sorted(samples)[len(samples) // 2]


def phase_cache_and_supervision(cs, build_parser, build_node, oracle_ok, random_symmetry):
    """The slice's front door and supervision on the card. (a) a default
    node, answer cache on; (b) a supervised node with the fault injector,
    driven through every state over HTTP. Every answer is held against the
    host oracle. Returns the launches, p50s and supervisor numbers."""
    import numpy as np

    corpus = load_corpus("corpus_9x9_hard_4096.npz")
    readme = json.dumps({"sudoku": README_PUZZLE}).encode()
    out = {}

    # -- (a) the default node: cache on -------------------------------------
    cs.dfs_segment.launches = 0
    cs.dfs_solver.launches = 0
    node = _Node(build_parser, build_node, [])
    try:
        check(node.node.answer_cache is not None, "the default node has no answer cache")
        before = node.validations()
        status, miss, headers = _http(node.base, "/solve", readme)
        check(status == 200 and headers.get("X-Cache") is None,
              f"README miss answered {status}, X-Cache {headers.get('X-Cache')}")
        _check_answer(README_PUZZLE, json.loads(miss), oracle_ok, "README miss")
        grew = node.validations() - before
        check(grew == 109, f"the README miss counted {grew} validations, not 109")
        status, hit, headers = _http(node.base, "/solve", readme)
        check(status == 200 and headers.get("X-Cache") == "hit" and hit == miss,
              "the repeated README board was not a byte-identical X-Cache hit")
        check(node.validations() - before == 109, "a cache hit counted validations")
        board = corpus[100]
        twin = random_symmetry(board, np.random.default_rng(SYMMETRY_SEED))
        status, body, headers = _http(
            node.base, "/solve", json.dumps({"sudoku": board.tolist()}).encode())
        check(status == 200 and headers.get("X-Cache") is None, "corpus miss failed")
        _check_answer(board, json.loads(body), oracle_ok, "corpus miss")
        n0 = cs.dfs_segment.launches
        status, body, headers = _http(node.base, "/solve", json.dumps({"sudoku": twin}).encode())
        check(status == 200 and headers.get("X-Cache") == "hit",
              f"the symmetric twin was not a hit: {status} {headers.get('X-Cache')}")
        _check_answer(twin, json.loads(body), oracle_ok, "symmetric twin hit")
        check(cs.dfs_segment.launches == n0, "a cache hit launched a segment")
        hits, misses = [], []
        for i in range(20):
            t0 = time.perf_counter()
            status, body, headers = _http(node.base, "/solve", readme)
            hits.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and headers.get("X-Cache") == "hit" and body == miss,
                  "a README repeat was not a hit")
            b = corpus[200 + i]
            t0 = time.perf_counter()
            status, body, headers = _http(
                node.base, "/solve", json.dumps({"sudoku": b.tolist()}).encode())
            misses.append((time.perf_counter() - t0) * 1e3)
            check(status == 200 and headers.get("X-Cache") is None, "a fresh board hit")
            _check_answer(b, json.loads(body), oracle_ok, "corpus miss")
        out["hit_p50_ms"] = _p50_ms(hits)
        out["corpus_miss_p50_ms"] = _p50_ms(misses)
        out["cache"] = node.node.answer_cache.snapshot()
        log(f"answer cache: {out['cache']}")
        # the hit's own cost, in process (canonicalize, lookup, the
        # symmetry proof, invert, the rule check): the rest of a hit's
        # /solve is HTTP and JSON
        cache = node.node.answer_cache
        for key, b in (("readme", README_PUZZLE), ("corpus_twin", twin)):
            lookups = []
            for _ in range(50):
                t0 = time.perf_counter()
                answer, _ = cache.lookup(b)
                lookups.append((time.perf_counter() - t0) * 1e3)
                check(answer is not None, f"in-process lookup of {key} missed")
            out[f"lookup_p50_ms_{key}"] = _p50_ms(lookups)
    finally:
        node.stop()
    out["segment_launches_cache"] = cs.dfs_segment.launches
    out["solver_launches_cache"] = cs.dfs_solver.launches
    check(out["segment_launches_cache"] > 0, "the cached node's misses launched no segment")

    # -- (b) supervised, fault injector armed -------------------------------
    cs.dfs_segment.launches = 0
    cs.dfs_solver.launches = 0
    node = _Node(build_parser, build_node, [
        "--no-answer-cache", "--supervise-engine", "--chaos-injector",
        "--watchdog-budget-s", str(WATCHDOG_BUDGET_S),
        "--probe-interval-s", str(PROBE_INTERVAL_S),
    ])
    eng = node.node.engine
    sup = eng.supervisor
    width = eng.segment_pool_width()

    def solve(label, want_degraded=None):
        status, body, headers = _http(node.base, "/solve", readme)
        check(status == 200, f"{label}: /solve answered {status} {body[:200]!r}")
        _check_answer(README_PUZZLE, json.loads(body), oracle_ok, label)
        degraded = headers.get("X-Degraded") == "true"
        if want_degraded is not None:
            check(degraded == want_degraded, f"{label}: X-Degraded {degraded}")
        return degraded

    try:
        check(sup.state == "healthy", f"a warmed supervised node reads {sup.state}")
        sol, info = node.node.peer_sudoku_solve_info(README_PUZZLE)
        _check_answer(README_PUZZLE, sol, oracle_ok, "supervised README")
        check((info["validations"], info["guesses"]) == (109, 35) and not info.get("degraded"),
              f"the supervised README counted {info}")
        out["p50_supervised"] = node.readme_p50(
            "--supervise-engine --no-answer-cache", oracle_ok, per_answer=109)

        # a poisoned segment at the pool width: served from the oracle
        _faults(node.base, {"poison_bucket": width})
        solve("poisoned", want_degraded=True)
        check(sup.state == "degraded", f"poison left the node {sup.state}")
        k1 = cs.dfs_solver.launches
        _faults(node.base, {"clear": True})
        out["readmit_after_clear_s"] = _wait(
            lambda: sup.state == "healthy", 10.0, "a probe to re-admit the device")
        check(cs.dfs_solver.launches > k1, "re-admission launched no probe")
        solve("after clear", want_degraded=False)

        # three failed device calls: LOST, then a rebuild and a probe
        rebuilds = sup.rebuilds
        _faults(node.base, {"fail_next": 3})
        solve("fail_next", want_degraded=True)
        _wait(lambda: sup.state == "lost", 10.0, "LOST")
        ready_lost = _http(node.base, "/readyz")[0]
        check(ready_lost == 503, f"/readyz answered {ready_lost} while LOST")
        out["relost_to_healthy_s"] = _wait(
            lambda: sup.state == "healthy", 60.0, "the rebuild and probe after LOST")
        check(sup.rebuilds == rebuilds + 1, "LOST did not rebuild the engine")
        status, _, _ = _http(node.base, "/readyz")
        check(status == 200, f"/readyz answered {status} after recovery")
        solve("after rebuild", want_degraded=False)

        # a fetch delayed past the watchdog budget: declared hung
        hangs = sup.hangs
        _faults(node.base, {"delay_s": HANG_DELAY_S})
        result = {}
        t = threading.Thread(target=lambda: result.update(d=solve("hung")), daemon=True)
        t.start()
        seen = {}

        def hung():
            # the watchdog counts a hang and moves the state in one hold of
            # the supervisor's lock (with a log write between the two), so
            # both are read under it
            with sup._lock:
                seen["state"] = sup.state
                return sup.hangs > hangs

        _wait(hung, 10.0, "the watchdog to declare a hang")
        check(seen["state"] == "degraded", f"a hang left the node {seen['state']}")
        _faults(node.base, {"clear": True})
        t.join(timeout=60)
        check("d" in result, "the hung request never answered")
        _wait(lambda: sup.state == "healthy", 10.0, "re-admission after the hang")
        solve("after hang", want_degraded=False)
        snap = sup.snapshot()
        snap.pop("transitions")
        out["supervisor"] = snap
        out["transitions"] = [(t["from"], t["to"], t["reason"])
                              for t in sup.snapshot()["transitions"]]
        out["faults"] = eng.fault_injector.counts()
        log(f"supervisor: {snap}")
        log(f"transitions: {out['transitions']}")
        log(f"injector: {out['faults']}")
        states = [t[1] for t in out["transitions"]]
        check("lost" in states and states[-1] == "healthy",
              f"the supervisor never went LOST and back: {states}")
        check(snap["hangs"] >= 1 and snap["bad_results"] >= 1 and snap["rebuilds"] >= 1,
              f"the fault script missed a detection: {snap}")
    finally:
        node.stop()
    out["segment_launches_supervised"] = cs.dfs_segment.launches
    out["solver_launches_supervised"] = cs.dfs_solver.launches
    check(out["solver_launches_supervised"] > 0, "the supervised node launched no probe")
    log(
        f"cache and supervision: README hit p50 {out['hit_p50_ms']:.3f} ms, "
        f"corpus miss p50 {out['corpus_miss_p50_ms']:.3f} ms (cache on); "
        f"in-process lookup p50 README {out['lookup_p50_ms_readme']:.3f} ms, "
        f"corpus twin {out['lookup_p50_ms_corpus_twin']:.3f} ms; "
        f"supervised README p50 {out['p50_supervised']:.3f} ms; re-admit after "
        f"clear {out['readmit_after_clear_s']:.3f} s; LOST to healthy "
        f"{out['relost_to_healthy_s']:.3f} s; launches: cache phase "
        f"dfs_segment {out['segment_launches_cache']} dfs_solver "
        f"{out['solver_launches_cache']}, supervised phase dfs_segment "
        f"{out['segment_launches_supervised']} dfs_solver "
        f"{out['solver_launches_supervised']}"
    )
    return out


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``reps`` back-to-back calls of ``fn``, by CUDA
    events. A spin of the device (``torch.cuda._sleep``) ahead of the
    first call lets the host enqueue all of them before the device reaches
    them, so a short launch is timed without the host's gaps between
    launches (~200 us of host time a call is allowed for)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(reps * 200e-6 * SM_CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SEGMENT_KERNELS = ("dfs_segment_kernel", "segment_digest_kernel")


def _profiled_kernel_ms(fn, reps: int, kernels=SEGMENT_KERNELS,
                        min_records=None) -> dict:
    """Mean device time per call of each kernel in ``kernels`` (a part of
    its symbol) over ``reps`` calls of ``fn``, from torch.profiler's CUDA
    kernel records. Fails unless every kernel ran exactly once a call; with
    ``min_records``, the mean is per record and each kernel needs that many
    records (torch.profiler drops some of the race kernels' records: as
    few as 8 of 10 were kept)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # kernels that start close to the capture window's opening can
        # lose their records (up to three a window; tools/profiler_edge.py
        # counts them): a 5 ms device sleep queued first keeps the counted
        # launches clear of that edge
        torch.cuda._sleep(int(5e-3 * SM_CLOCK_HZ))
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = dict.fromkeys(kernels, 0.0)
    count = dict.fromkeys(kernels, 0)
    for e in prof.key_averages():
        for k in kernels:
            if k in e.key:
                total_us[k] += e.device_time_total
                count[k] += e.count
    if min_records is None:
        check(all(count[k] == reps for k in kernels),
              f"the profiler recorded {count} kernel launches for {reps} calls")
        return {k: total_us[k] / reps / 1e3 for k in kernels}
    check(all(min_records <= count[k] <= reps for k in kernels),
          f"the profiler recorded {count} kernel launches for {reps} calls")
    return {**{k: total_us[k] / count[k] / 1e3 for k in kernels},
            "records": dict(count), "calls": reps}


def segment_timing_cases():
    """(name, pool width, live lanes): pools of 8, 64, 512 and 4096 lanes
    every lane injected at entry (live None); and a 4096 pool whose other
    lanes have finished, with one lane injected (a lone README /solve) or
    16 (phase 6's 16 concurrent clients)."""
    return [(str(W), W, None) for W in (8, 64, 512, 4096)] + [
        ("4096, 1 live", 4096, 1), ("4096, 16 live", 4096, 16),
    ]


def segment_case_src(W: int, live):
    """The timed segment's source map: every lane injected from its own
    hard board, or only the first ``live`` lanes (the rest kept)."""
    import torch

    if live is None:
        return torch.arange(W, dtype=torch.int32, device="cuda")
    src = torch.full((W,), -1, dtype=torch.int32, device="cuda")
    src[:live] = torch.arange(live, dtype=torch.int32, device="cuda")
    return src


def _bound_ms(boards, grid, meta, cells, locked: bool):
    """The least time for one launch: the larger of its bytes (boards in,
    grid and meta out) over the HBM rate and its integer operations
    (sweeps run x cells x the operations per cell of a sweep) over the
    int32 rate. ``meta[:, 2]`` counts each board's sweeps."""
    per_cell = OPS_PER_CELL_SWEEP + (OPS_PER_CELL_LOCKED if locked else 0)
    bytes_ms = (boards.numel() + grid.numel() + meta.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = int(meta[:, 2].sum()) * cells * per_cell / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def timing_widths():
    """(name, boards, depth) at the widths the engine's buckets give the
    kernel: the README board alone (width 1) at both depth stages, and the
    first 64, 512 and 4096 hard boards at the first stage (32 frames)."""
    import numpy as np

    hard = load_corpus("corpus_9x9_hard_4096.npz")
    readme = np.asarray(README_PUZZLE, np.int32)[None]
    return [
        ("1@32", readme, 32),
        ("1@81", readme, 81),
        ("64", hard[:64], 32),
        ("512", hard[:512], 32),
        ("4096", hard, 32),
    ]


def phase_timing(cs, spec_for_size, serving_config):
    """Times the kernel (4096 steps a board at most) and its plain version
    at every width of ``timing_widths``, in the serving configuration (the
    engine's: one sweep a step at width 1, ``waves`` of serving_config(9)
    above) and in the singles configuration, and holds the kernel's first
    launch at each against the plain version's result. Returns, per
    configuration, the times and step counts by width, and the mismatching
    boards and largest difference of those comparisons."""
    import torch

    spec = spec_for_size(9)
    serving = sweeps_of(serving_config(9))
    n0 = cs.dfs_solver.launches
    out = {"mismatches": 0, "max_abs_err": 0}
    for config in ("serving", "singles"):
        res = out[config] = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "steps": {}}
        for name, boards, depth in timing_widths():
            if config == "singles":
                sweeps = SINGLES
            else:
                sweeps = dict(serving, waves=1 if len(boards) == 1 else serving["waves"])
            flat = torch.as_tensor(boards.reshape(len(boards), -1), device="cuda").contiguous()
            reps = 50 if len(boards) < 512 else 10
            grid, meta = cs.dfs_solver(flat, spec, depth, 4096, **sweeps)
            plain = {}
            plain_ms = _cuda_ms(
                lambda: plain.update(
                    r=cs._dfs_solver_plain(flat, spec, depth, 4096, **sweeps)
                ), 1,
            )
            pgrid, pmeta = plain["r"]
            bad = (grid != pgrid).any(dim=1) | (meta[:, :3] != pmeta[:, :3]).any(dim=1)
            n_bad = int(bad.sum())
            steps, plain_steps = int(meta[:, 3].max()), int(pmeta[0, 3])
            out["mismatches"] += n_bad
            out["max_abs_err"] = max(
                out["max_abs_err"],
                int((grid.long() - pgrid.long()).abs().max()),
                int((meta[:, :3].long() - pmeta[:, :3].long()).abs().max()),
                abs(steps - plain_steps),
            )
            this_ms = _cuda_ms(
                lambda: cs.dfs_solver(flat, spec, depth, 4096, **sweeps), reps
            )
            bound, by = _bound_ms(flat, grid, meta, spec.cells,
                                  sweeps["locked_candidates"])
            res["ms"][name] = this_ms
            res["plain_ms"][name] = plain_ms
            res["bound_ms"][name] = bound
            res["steps"][name] = steps
            log(
                f"timing {config} (waves {sweeps['waves']}) width {name} "
                f"(depth {depth}): kernel {this_ms:.4f} ms (CUDA events, mean "
                f"of {reps}); plain {plain_ms:.1f} ms (1 run); bound "
                f"{bound:.5f} ms by {by} ({bound / this_ms:.2%} of the "
                f"kernel); slowest board {steps} steps (plain {plain_steps}), "
                f"{this_ms / steps * 1e3:.3f} us per step; validations "
                f"{int(meta[:, 2].sum())}; {n_bad} boards differ from the "
                f"plain version"
            )
            check(n_bad == 0 and steps == plain_steps,
                  f"{config} width {name}: kernel and plain version disagree")
            if name == "4096":
                res["bound_by"] = by
    cs.dfs_solver.launches = n0  # timing launches are not main-path launches
    return out


def flat_depth(ts, spec, serving_config):
    """The depth a lane pool runs: the largest stage of the serving config's."""
    return max(ts.staged_depths(serving_config(spec.size)["max_depth"], spec))


def segment_parity_sets(seed: int):
    """(name, stock, size, width, budgets, rotation seed or None, sweeps
    override): the 9x9 hard corpus over a 4096-lane pool under ragged
    budgets; seeded rotations (new boards into random freed lanes at
    random boundaries, pad re-seeds and strangers over running lanes
    included) at widths 512 (prefix-gathered block) and 64 (masked block);
    the 16x16 and 25x25 corpora in their serving configs, each also at the
    pool width its node runs (4096; 64 under phase 9's ``--buckets
    1,8,64``); seeded 4x4 boards with clue conflicts rotated through the
    4x4 node's 4096-lane pool; the degenerate boards; the README board in
    a one-lane pool (one sweep a step)."""
    import numpy as np

    hard = load_corpus("corpus_9x9_hard_4096.npz")
    hexa = load_corpus("corpus_16x16_hard_2048.npz")
    giant = load_corpus("corpus_25x25_hard_512.npz")
    return [
        ("9x9 hard 4096 ragged", hard, 9, 4096, (3, 7, 1, 13), None, {}),
        ("9x9 rotation 512", hard, 9, 512, (2, 5, 3), 1, {}),
        ("9x9 rotation 64", hard[2048:], 9, 64, (8, 3), 2, {}),
        ("16x16 hard 256", hexa[:256], 16, 256, (16,), None, {}),
        ("16x16 hard pool 4096", hexa, 16, 4096, (16,), None, {}),
        ("25x25 hard 4", giant[:4], 25, 4, (32,), None, {}),
        ("25x25 hard pool 64", giant[:64], 25, 64, (32,), None, {}),
        ("4x4 rotation 4096", boards_4x4(4096, seed + 5, conflicts=True), 4, 4096,
         (16, 3, 1), seed, {}),
        ("9x9 degenerate", degenerate_boards(), 9, 6, (8, 3), None, {}),
        ("9x9 README pool 1", np.asarray(README_PUZZLE, np.int32)[None], 9, 1,
         (8,), None, {"waves": 1}),
    ]


def _segment_lane_diffs(pool, plain, kd, pd, kb, pb):
    """Lanes whose kernel state (stack frames below the lane's depth
    included), digest row or block row differ from the plain version's,
    and the largest absolute difference."""
    import torch

    W = plain.grid.shape[0]
    bad = torch.zeros(W, dtype=torch.bool, device=plain.grid.device)
    err = 0
    for f in ("grid", "depth", "status", "guesses", "validations", "board_iters"):
        a, b = getattr(pool.state, f), getattr(plain, f)
        bad |= (a != b).reshape(W, -1).any(dim=1)
        err = max(err, int((a.long() - b.long()).abs().max()))
    D = plain.stack_mask.shape[1]
    live = torch.arange(D, device=bad.device)[None, :] < plain.depth.long()[:, None]
    for f in ("stack_grid", "stack_cell", "stack_mask"):
        a, b = getattr(pool.state, f), getattr(plain, f)
        diff = (a.long() - b.long()).reshape(W, D, -1).abs().amax(dim=2) * live
        bad |= (diff > 0).any(dim=1)
        err = max(err, int(diff.max()))
    for a, b in ((kd, pd), (kb, pb)):
        bad |= (a != b).any(dim=1)
        err = max(err, int((a.long() - b.long()).abs().max()))
    return int(bad.sum()), err


def phase_segment_parity(cs, ts, spec_for_size, serving_config, oracle_ok,
                         seed: int):
    """K3/K3b against the plain version of ops/cuda_solver.dfs_segment,
    segment by segment, on every ``segment_parity_sets`` set under its
    size's serving config: state, frames below each lane's depth, digest
    and solution block. Returns (mismatching lanes, largest difference)."""
    import numpy as np
    import torch

    from sudoku_solver_distributed_tpu_torch.ops.config import segment_prefix_gather

    total_bad = total_err = 0
    for name, stock, size, W, ks, rot, over in segment_parity_sets(seed):
        spec = spec_for_size(size)
        sweeps = dict(sweeps_of(serving_config(size)), **over)
        rng = np.random.default_rng(rot)
        pad = ts.pad_board(spec, "cuda").expand(W, size, size)
        pool = cs.SegmentPool.fresh(pad, spec, flat_depth(ts, spec, serving_config))
        plain = ts.SegmentState(*(t.clone() for t in pool.state))
        boards = torch.as_tensor(stock.reshape(len(stock), -1), device="cuda")
        src_np = np.arange(W, dtype=np.int32) % len(stock)
        prefix = segment_prefix_gather(W, spec.cells)
        t0 = time.perf_counter()
        bad = err = 0
        for seg in range(400):
            src = torch.as_tensor(src_np, device="cuda")
            k = ks[seg % len(ks)]
            pool, kd, kb = cs.dfs_segment(pool, boards, src, k,
                                          prefix_gather=prefix, **sweeps)
            plain, pd, pb = cs._dfs_segment_plain(plain, boards, src, k, spec,
                                                  prefix, **sweeps)
            n_bad, e = _segment_lane_diffs(pool, plain, kd, pd, kb, pb)
            bad, err = bad + n_bad, max(err, e)
            status = plain.status.cpu().numpy()
            src_np = np.full(W, -1, np.int32)
            if rot is not None and seg < 24:
                free = np.flatnonzero(status != ts.RUNNING)
                pick = free[rng.random(free.size) < 0.5]
                src_np[pick] = rng.integers(0, len(stock), pick.size)
                src_np[free[rng.random(free.size) < 0.1]] = -2
                over_running = rng.integers(0, W, max(1, W // 32))
                src_np[over_running] = rng.choice([-2, 0, len(stock) - 1],
                                                  over_running.size)
            elif not (status == ts.RUNNING).any():
                break
        grids = plain.grid.cpu().numpy()
        for i in np.flatnonzero(status == ts.SOLVED)[:64]:
            check(oracle_ok(grids[i].reshape(size, size).tolist()),
                  f"{name}: lane {i} SOLVED with an invalid grid")
        log(
            f"segment parity {name} (pool {W}, budgets {ks}, prefix gather "
            f"{prefix}): {seg + 1} segments, {bad} mismatching lanes, "
            f"statuses {np.bincount(status, minlength=4).tolist()}, "
            f"{time.perf_counter() - t0:.1f} s (host clock)"
        )
        check(bad == 0, f"{name}: the segment kernels and the plain version disagree")
        total_bad += bad
        total_err = max(total_err, err)
    return total_bad, total_err


def segment_chain(cs, pool, boards, ks, *, prefix_gather, sweeps):
    """Run ``pool`` (every lane injected from ``boards`` in the first
    segment) to the end with the cycled budgets ``ks``; returns the last
    pool handle, digest and the number of segments."""
    import torch

    W = pool.width
    src = torch.arange(W, dtype=torch.int32, device="cuda")
    idle = torch.full((W,), -1, dtype=torch.int32, device="cuda")
    for seg in range(100_000):
        pool, digest, _ = cs.dfs_segment(pool, boards, src if seg == 0 else idle,
                                         ks[seg % len(ks)],
                                         prefix_gather=prefix_gather, **sweeps)
        if not bool((digest[:, 0] == 0).any()):
            return pool, digest, seg + 1
    raise RuntimeError("segment chain did not finish")


def phase_chain_vs_flat(cs, ts, spec_for_size, serving_config):
    """A chain of K3 segments (k = 8) over the 4096 hard boards equals one
    flat dfs_solver launch at the flat depth: grid, status, guesses and
    validations per board, and the largest board_iters its step count."""
    import torch

    spec = spec_for_size(9)
    sweeps = sweeps_of(serving_config(9))
    depth = flat_depth(ts, spec, serving_config)
    hard = load_corpus("corpus_9x9_hard_4096.npz")
    flat = torch.as_tensor(hard.reshape(len(hard), -1), device="cuda")
    grid, meta = cs.dfs_solver(flat, spec, depth, 4096, **sweeps)
    pool = cs.SegmentPool.fresh(ts.pad_board(spec, "cuda").expand(4096, 9, 9),
                                spec, depth)
    pool, digest, n = segment_chain(cs, pool, flat, (8,), prefix_gather=True,
                                    sweeps=sweeps)
    same = {
        "grid": bool(torch.equal(pool.state.grid, grid)),
        "status": bool(torch.equal(digest[:, 0], meta[:, 0])),
        "guesses": bool(torch.equal(digest[:, 2], meta[:, 1])),
        "validations": bool(torch.equal(digest[:, 3], meta[:, 2])),
        "iters": int(digest[:, 4].max()) == int(meta[:, 3].max()),
    }
    log(f"segment chain vs flat dfs_solver (4096 hard boards, depth {depth}, "
        f"k 8): {n} segments, equal {same}, slowest board "
        f"{int(meta[:, 3].max())} steps")
    check(all(same.values()), f"the segment chain differs from the flat launch: {same}")


def phase_golden_segments(cs, ts, SolverEngine, spec_for_size, serving_config, oracle_ok):
    """The deep-union corpus through the engine's segment seam under
    budgets (997, 251), in both boundary arms: every board solved, its
    grid, status, guesses and validations those of one flat dfs_solver
    launch at the flat depth, the largest board_iters its step count, and
    the sums within tests/golden_counters.json's +5% envelope (as
    tests/test_continuous.py holds the JAX package)."""
    import numpy as np
    import torch

    with open(os.path.join(ROOT, "tests", "golden_counters.json")) as f:
        golden = json.load(f)
    boards = load_corpus(golden["corpus"])
    B = len(boards)
    spec = spec_for_size(9)
    sweeps = sweeps_of(serving_config(9))
    depth = flat_depth(ts, spec, serving_config)
    flat = torch.as_tensor(boards.reshape(B, -1), device="cuda")
    ref_grid, ref_meta = cs.dfs_solver(flat, spec, depth, golden["config"]["max_iters"],
                                       **sweeps)
    ref_grid, ref_meta = ref_grid.cpu().numpy(), ref_meta.cpu().numpy()
    out = {}
    for pipeline in (True, False):
        eng = SolverEngine(buckets=(B,), segment_pipeline=pipeline)
        try:
            state = eng.new_segment_pool(B)
            src = np.arange(B, dtype=np.int32)
            grids = np.zeros((B, spec.cells), np.int32)
            t0 = time.perf_counter()
            for seg in range(100_000):
                h = eng.dispatch_segment(state, boards, src=src,
                                         seg_iters=(997, 251)[seg % 2])
                rows, _ = eng.finalize_segment(h, active=np.ones(B, bool))
                state = h.state
                newly = (rows[:, spec.cells] == 1) & (grids.sum(axis=1) == 0)
                grids[newly] = rows[newly, : spec.cells]
                src = np.full(B, -1, np.int32)
                if not (rows[:, spec.cells + 1] == ts.RUNNING).any():
                    break
            dt = time.perf_counter() - t0
        finally:
            eng.close()
        C = spec.cells
        got = {
            "solved": int(rows[:, C].sum()),
            "iters": int(rows[:, C + 4].max()),
            "guesses": int(rows[:, C + 2].sum()),
            "validations": int(rows[:, C + 3].sum()),
        }
        arm = "pipelined" if pipeline else "full rows"
        same = (np.array_equal(grids, ref_grid)
                and np.array_equal(rows[:, C + 1], ref_meta[:, 0])
                and np.array_equal(rows[:, C + 2], ref_meta[:, 1])
                and np.array_equal(rows[:, C + 3], ref_meta[:, 2])
                and got["iters"] == int(ref_meta[:, 3].max()))
        log(f"golden counters under segmentation ({arm} arm, {seg + 1} "
            f"segments, {dt * 1e3:.1f} ms host clock): {got}; golden "
            f"{ {k: golden[k] for k in got} }; equal to the flat launch: {same}")
        check(same, f"{arm}: segments differ from the flat launch")
        check(got["solved"] == golden["solved"], f"{arm}: solved {got['solved']}")
        for key in ("iters", "guesses", "validations"):
            check(got[key] <= golden[key] * 1.05,
                  f"{arm}: {key} {got[key]} above the golden envelope")
        for i in range(0, B, 17):
            check(oracle_ok(grids[i].reshape(9, 9).tolist()), f"{arm}: board {i}")
        out[arm] = got
    return out


def _segment_bounds_ms(cells, src, entry, running_code, sweeps_run, locked: bool,
                       prefix_gather: bool) -> dict:
    """The least time for one segment, of the pair and of each kernel on
    its own: the larger of the words the function must move for this
    segment's lanes (each input read once, each output written once) over
    the HBM rate, and its integer operations (the sweeps it ran x cells x
    operations per cell of a sweep) over the int32 rate. ``src`` is the
    segment's source map and ``entry`` the pool state it starts from.

    K3 reads every lane's source-map entry; an idle lane (kept, not
    RUNNING) reads its four scalars and writes digest columns 0-4 and its
    step word; a lane injected from a board reads the board, a pad
    re-seed (-2) reads nothing, and both write the state (grid and five
    scalars), digest columns 0-4 and the step word; a lane RUNNING at
    entry also reads its state and, below depth 0, its top frame, and
    writes both back; with the block masked, every lane writes its block
    row. Frames pushed inside the segment are not counted, so this stays
    a lower bound. K3b reads the step words and writes digest columns
    5-7 and, prefix-gathered, reads the grid and writes the block. The
    pair's step words are its own, and it reads only the idle lanes'
    grid for the block (the others' it has just written). Returns
    {"pair" or kernel: (bound ms, "bytes" or "operations")}."""
    per_cell = OPS_PER_CELL_SWEEP + (OPS_PER_CELL_LOCKED if locked else 0)
    W = src.numel()
    kept = src == -1
    running = kept & (entry.status == running_code)
    n_idle = int((kept & ~running).sum())
    n_board = int((src >= 0).sum())
    n_reseed = int((src == -2).sum())
    n_running = int(running.sum())
    n_frames = int((running & (entry.depth > 0)).sum())
    state = cells + 5
    block = W * cells
    k3_words = (W + n_idle * 4 + n_board * cells + (n_board + n_reseed) * state
                + n_running * 2 * state + n_frames * 2 * 2 + W * (5 + 1)
                + (0 if prefix_gather else block))
    k3b_words = W * (1 + 3) + (2 * block if prefix_gather else 0)
    pair_words = (k3_words - W + 3 * W
                  + (block + n_idle * cells if prefix_gather else 0))
    ops_ms = sweeps_run * cells * per_cell / INT32_OPS_PER_S * 1e3
    out = {}
    for name, words, ops in (("pair", pair_words, ops_ms),
                             (SEGMENT_KERNELS[0], k3_words, ops_ms),
                             (SEGMENT_KERNELS[1], k3b_words, 0.0)):
        bytes_ms = words * 4 / HBM_BYTES_PER_S * 1e3
        out[name] = (max(bytes_ms, ops), "operations" if ops >= bytes_ms else "bytes")
    return out


def phase_segment_timing(cs, ts, spec_for_size, serving_config):
    """Times one segment of the segment kernels (K3 then K3b, the serving
    sweeps) at every ``segment_timing_cases`` case, at k = 8 and at k = 0
    (load, store and digest only): both kernels together with CUDA events
    after a device spin, and each on its own from torch.profiler's CUDA
    kernel records over as many segments. Beside each: the plain version's
    time on the same inputs (one run, k = 8) and the bounds, of the pair
    and of each kernel. The first launch of each case is held against the
    plain version."""
    import torch

    from sudoku_solver_distributed_tpu_torch.ops.config import segment_prefix_gather

    spec = spec_for_size(9)
    sweeps = sweeps_of(serving_config(9))
    depth = flat_depth(ts, spec, serving_config)
    hard = torch.as_tensor(load_corpus("corpus_9x9_hard_4096.npz").reshape(4096, -1),
                           device="cuda")
    out = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}, "k0_ms": {},
           "k0_bound_ms": {}, "split": {k: {} for k in SEGMENT_KERNELS},
           "plain_split_ms": {k: {} for k in SEGMENT_KERNELS},
           "warps_per_sm": cs.segment_warps_per_sm(9), "mismatches": 0,
           "max_abs_err": 0}
    log(f"dfs_segment_kernel 9x9: {out['warps_per_sm']} resident warps per SM")
    for name, W, live in segment_timing_cases():
        src = segment_case_src(W, live)
        pad = ts.pad_board(spec, "cuda").expand(W, 9, 9)
        pool = cs.SegmentPool.fresh(pad, spec, depth)
        if live is not None:
            # finish every pad lane first: one step each
            pool, _, _ = cs.dfs_segment(pool, hard, torch.full_like(src, -1), 1,
                                        prefix_gather=True, **sweeps)
        prefix = segment_prefix_gather(W, spec.cells)
        plain_in = ts.SegmentState(*(t.clone() for t in pool.state))
        pool, kd, kb = cs.dfs_segment(pool, hard, src, 8, prefix_gather=prefix, **sweeps)
        # the plain version in its two parts, each timed once: inject and
        # run (K3's function), then the digest (K3b's)
        plain = {}

        def plain_run():
            st = ts.inject_lanes_src(plain_in, hard.reshape(-1, 9, 9), src, spec)
            plain["entry"] = st.status == ts.RUNNING
            plain["state"], plain["stats"] = ts.run_segment(st, 8, spec, **sweeps)

        plain_k3 = _cuda_ms(plain_run, 1)
        plain_k3b = _cuda_ms(lambda: plain.update(out=ts.segment_digest(
            plain["state"], plain["entry"], plain["stats"], prefix)), 1)
        plain_ms = plain_k3 + plain_k3b
        pst, (pd, pb) = plain["state"], plain["out"]
        n_bad, err = _segment_lane_diffs(pool, pst, kd, pd, kb, pb)
        out["mismatches"] += n_bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        reps = 50 if W < 4096 else 20
        handle = [pool]

        def seg(k):
            handle[0], _, _ = cs.dfs_segment(handle[0], hard, src, k,
                                             prefix_gather=prefix, **sweeps)

        ms = _cuda_ms(lambda: seg(8), reps)
        k0 = _cuda_ms(lambda: seg(0), reps)
        split = _profiled_kernel_ms(lambda: seg(8), reps)
        split_k0 = _profiled_kernel_ms(lambda: seg(0), reps)
        sweeps_run = int(kd[:, 3].sum()) - int(plain_in.validations[src < 0].sum())
        locked = sweeps["locked_candidates"]
        bounds, bounds_k0 = (
            _segment_bounds_ms(spec.cells, src, plain_in, ts.RUNNING, n, locked, prefix)
            for n in (sweeps_run, 0)
        )
        bound, by = bounds["pair"]
        k0_bound = bounds_k0["pair"][0]
        out["ms"][name], out["plain_ms"][name], out["k0_ms"][name] = ms, plain_ms, k0
        out["bound_ms"][name], out["bound_by"][name] = bound, by
        out["k0_bound_ms"][name] = k0_bound
        out["plain_split_ms"][SEGMENT_KERNELS[0]][name] = plain_k3
        out["plain_split_ms"][SEGMENT_KERNELS[1]][name] = plain_k3b
        for kern in SEGMENT_KERNELS:
            out["split"][kern][name] = {
                "ms": split[kern], "k0_ms": split_k0[kern],
                "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1],
                "k0_bound_ms": bounds_k0[kern][0],
            }
        log(
            f"timing segment pool {name} (k 8, waves {sweeps['waves']}): kernels "
            f"{ms:.4f} ms (CUDA events, mean of {reps}), k 0 {k0:.4f} ms; plain "
            f"{plain_ms:.1f} ms (1 run); bound {bound:.6f} ms by {by} "
            f"({bound / ms:.2%} of the kernels), k 0 {k0_bound:.6f} ms; "
            f"{sweeps_run} sweeps, lockstep steps {int(kd[0, 6]) // W}; {n_bad} "
            f"lanes differ from the plain version"
        )
        for kern in SEGMENT_KERNELS:
            b, bby = bounds[kern]
            log(
                f"  {kern} (torch.profiler, mean of {reps}): k 8 {split[kern]:.4f} "
                f"ms, bound {b:.6f} ms by {bby} ({b / split[kern]:.2%}); k 0 "
                f"{split_k0[kern]:.4f} ms, bound {bounds_k0[kern][0]:.6f} ms"
            )
        check(n_bad == 0, f"segment timing pool {name}: kernels and plain version disagree")
    return out


STAGE_KEYS = ("cache_ms", "queue_ms", "coalesce_ms", "device_ms", "verify_ms",
              "fallback_ms")
# the series of the /metrics body whose values follow the clock rather
# than the node's work: gauges over a sliding window of the last seconds
# (obs/cost.py's recent and sustained_*, obs/slo.py's burn rates), ages
# and rates (age_s, since_s, *_rate_hz, last_tick_age_s, uptime)
_PROM_CLOCK_SERIES = re.compile(r"age_s|since_s|_rate_hz|burn|sustained_|recent|uptime")


def _prom_clock_moves(a: bytes, b: bytes) -> list:
    """Two Prometheus renderings of one quiescent node, scraped an instant
    apart: every line equal but for the value of a series that follows the
    clock (``_PROM_CLOCK_SERIES``). Returns the names of those that moved."""
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    check(len(la) == len(lb), f"the two prom renderings have {len(la)} and {len(lb)} lines")
    moved = []
    for x, y in zip(la, lb):
        if x == y:
            continue
        mx, my = _PROM_LINE.match(x), _PROM_LINE.match(y)
        name = mx.group(1) if mx is not None and mx.group(1) else None
        check(name is not None and my is not None and my.group(1) == name
              and _PROM_CLOCK_SERIES.search(name) is not None,
              f"the two prom renderings differ: {x!r} against {y!r}")
        moved.append(name)
    return moved


_PROM_LINE = re.compile(
    r"^(?:# (?:TYPE|HELP) .*|"
    r"([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})?) "
    r"([-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|Inf|NaN)))$"
)


def _segment_probe(engine):
    """Wrap the engine's segment seam to record, for every segment, K3 +
    K3b's time by CUDA events (recorded around the two launches, on the
    stream they run on), the digest's lane_steps / idle_lane_steps (left
    on the device until read) and, at its fetch, the dispatch-to-fetch
    time the request spans stamp as device time, with the dispatch and
    fetch instants (monotonic clock). Returns the list of finalized
    segments' records (``_read_segments`` reads their device values)."""
    import torch

    real_kernels = engine._segment_kernels
    real_dispatch = engine.dispatch_segment
    real_finalize = engine.finalize_segment
    local = threading.local()
    pending = {}
    done = []

    def kernels(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_kernels(*args, **kw)
        end.record()
        local.last = (start, end, out[1][0, 6:8].clone())
        return out

    def dispatch(*args, **kw):
        handle = real_dispatch(*args, **kw)
        pending[id(handle)] = local.last
        return handle

    def finalize(handle, **kw):
        rows, device_s = real_finalize(handle, **kw)
        t_fetch = time.monotonic()
        start, end, stats = pending.pop(id(handle))
        done.append({"device_ms": device_s * 1e3, "start": start, "end": end,
                     "stats": stats, "t0": handle.t0, "t_fetch": t_fetch})
        return rows, device_s

    engine._segment_kernels = kernels
    engine.dispatch_segment = dispatch
    engine.finalize_segment = finalize
    return done


def _read_segments(done):
    """The probe's records with their device values read: per segment
    ``(device_ms, kernels_ms, lane_steps, idle_lane_steps)``."""
    import torch

    torch.cuda.synchronize()
    out = []
    for rec in list(done):
        lane, idle = (int(v) for v in rec["stats"].tolist())
        out.append((rec["device_ms"], rec["start"].elapsed_time(rec["end"]),
                    lane, idle))
    return out


def _prom_leaves(body, prefix="sudoku"):
    """{exposition name: value} of every numeric, boolean and string leaf
    of a /metrics body, by the exposition's mapping (route blocks labeled
    by route, other leaves by path, strings as ``_info`` gauges)."""
    from sudoku_solver_distributed_tpu_torch.obs.prom import _label, _name

    out = {}

    def walk(path, v):
        if isinstance(v, bool):
            out[_name(*path)] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[_name(*path)] = float(v)
        elif isinstance(v, str):
            out[f'{_name(*path)}_info{{value="{_label(v)}"}}'] = 1.0
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(path + (str(k),), x)

    for key, value in body.items():
        if key.startswith("/"):
            for field, v in value.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f'{prefix}_route_{_name(field)}{{route="{key}"}}'] = float(v)
        else:
            walk((prefix, key), value)
    return out


def phase_obs(cs, build_parser, build_node, oracle_ok, boundary_p50_ms):
    """Phase 8 (``_phase_obs``) with its dumps and traces in a temporary
    directory, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as out_dir:
        return _phase_obs(cs, build_parser, build_node, oracle_ok,
                          boundary_p50_ms, out_dir)


def _phase_obs(cs, build_parser, build_node, oracle_ok, boundary_p50_ms,
               out_dir):
    """The observability plane on the main path, with both kernels'
    counters set to 0 just before and read just after. A default node
    with ``--metrics`` (answer cache off, so every README /solve reaches
    the kernels): 20 README /solves with ``X-Timing``, each holding its
    stages to its total and every segment's device stage to K3 + K3b's
    CUDA-event time; 16 concurrent clients, then the cost plane's
    segment lane counters against the sum of the K3b digests;
    ``/metrics.prom`` against the JSON body; ``/debug/trace``; a POST
    /debug/flightrecord dump. Then a ``--device-trace-dir`` node's
    warm-up trace must name the kernels, and the README p50 with the
    plane on is read beside a ``--no-obs`` node's, in turns."""
    corpus = load_corpus("corpus_9x9_hard_4096.npz")
    readme = json.dumps({"sudoku": README_PUZZLE}).encode()
    dump_dir = os.path.join(out_dir, "flightrecords")
    out = {}
    cs.dfs_segment.launches = 0
    cs.dfs_solver.launches = 0
    node = _Node(build_parser, build_node,
                 ["--metrics", "--no-answer-cache", "--flightrecord-dir", dump_dir])
    eng = node.node.engine
    try:
        check(node.node.tracer is not None and node.node.flight is not None,
              "the default node has no tracer or flight recorder")
        probe = _segment_probe(eng)
        width = eng.segment_pool_width()
        timings, lat_ms, per_request, windows = [], [], [], []
        for i in range(20):
            n0 = cs.dfs_segment.launches
            t_req = time.monotonic()
            t0 = time.perf_counter()
            status, body, headers = _http(node.base, "/solve", readme,
                                          {"X-Timing": "1", "X-Request-Id": f"readme-{i}"})
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            windows.append((t_req, time.monotonic()))
            check(status == 200, f"/solve answered {status}")
            _check_answer(README_PUZZLE, json.loads(body), oracle_ok, "README /solve")
            check(headers.get("X-Request-Id") == f"readme-{i}", "X-Request-Id not echoed")
            timing = json.loads(headers["X-Timing"])
            timings.append(timing)
            per_request.append(cs.dfs_segment.launches - n0)
            check(timing["device_ms"] > 0, f"README /solve device_ms {timing}")
            check(timing["bucket"] == width and timing["batch_id"] >= 1,
                  f"README /solve span attribution {timing}")
        # The stages against the total. A request's device stage is the sum
        # of its segments' dispatch-to-fetch times, and the pipelined loop
        # dispatches segment N+1 before it fetches N, so those times
        # overlap: the stages' raw sum may pass the total by the overlap.
        # Its segments (the first ``segments`` dispatched in its window,
        # from the probe) give the overlap: their summed device times
        # minus the wall span from the first dispatch to the last fetch.
        records = sorted(probe, key=lambda r: r["t0"])
        overlap_ms, raw_over = [], 0
        for timing, (a, b) in zip(timings, windows):
            mine = [r for r in records if a <= r["t0"] <= b][: timing["segments"]]
            check(len(mine) == timing["segments"],
                  f"the probe saw {len(mine)} segments of a request reporting {timing}")
            summed = sum(r["device_ms"] for r in mine)
            check(abs(summed - timing["device_ms"]) <= 0.01,
                  f"the span's device stage {timing['device_ms']} ms is not its "
                  f"segments' dispatch-to-fetch sum {summed:.3f} ms")
            overlap = summed - (mine[-1]["t_fetch"] - mine[0]["t0"]) * 1e3
            overlap_ms.append(overlap)
            stages = sum(timing[k] for k in STAGE_KEYS)
            raw_over += stages > timing["total_ms"]
            check(stages - overlap <= timing["total_ms"] + 0.01,
                  f"README /solve stages sum to {stages:.3f} ms, {overlap:.3f} ms "
                  f"of it the segments' overlap, past the total {timing}")
        out["readme_segment_overlap_ms_p50"] = _p50_ms(overlap_ms)
        out["readme_stages_past_total"] = raw_over
        log(f"README /solve stages: the raw sum passes total_ms in {raw_over} of "
            f"20 requests; the pipelined segments' overlap p50 "
            f"{out['readme_segment_overlap_ms_p50']:.3f} ms; every sum less its "
            f"overlap is within the total")
        segs = {t["segments"] for t in timings}
        check(len(segs) == 1 and min(segs) >= 1,
              f"README /solves report different segment counts {sorted(segs)}")
        out["readme_segments"] = timings[0]["segments"]
        out["readme_segment_launches"] = sum(per_request) / len(per_request)
        out["readme_stage_p50_ms"] = {
            k: _p50_ms([t[k] for t in timings]) for k in ("total_ms", *STAGE_KEYS)
        }
        out["readme_p50_ms_host"] = _p50_ms(lat_ms)
        log(f"README /solve x20 with X-Timing: {out['readme_segments']} segments "
            f"each in the span, {out['readme_segment_launches']:.2f} segment "
            f"launches per request; stage p50s (ms) {out['readme_stage_p50_ms']}; "
            f"host-clock p50 {out['readme_p50_ms_host']:.3f} ms")
        segments = _read_segments(probe)
        short = [(d, k) for d, k, _, _ in segments if d < k]
        check(segments and not short,
              f"segments whose device stage is under K3 + K3b's event time: {short[:5]}")
        out["segment_device_ms_p50"] = _p50_ms([d for d, _, _, _ in segments])
        out["segment_kernels_ms_p50"] = _p50_ms([k for _, k, _, _ in segments])
        log(f"{len(segments)} README segments: device stage p50 "
            f"{out['segment_device_ms_p50']:.4f} ms (dispatch to fetch, host "
            f"clock) against K3 + K3b p50 {out['segment_kernels_ms_p50']:.4f} ms "
            f"(CUDA events); every segment's device stage is at least its kernels'")

        clients = [b.tolist() for b in corpus[300:316]]

        def post(i):
            status, body, _ = _http(
                node.base, "/solve", json.dumps({"sudoku": clients[i]}).encode())
            check(status == 200, f"concurrent /solve answered {status}")
            return json.loads(body)

        for i, sol in enumerate(_concurrent(16, post)):
            _check_answer(clients[i], sol, oracle_ok, "concurrent /solve answer")

        def cost():
            return json.loads(_http(node.base, "/metrics")[1])["engine"]["cost"]

        _wait(lambda: cost()["continuous"]["segments"] == len(probe), 10.0,
              "every dispatched segment to be fetched")
        segments = _read_segments(probe)
        body = json.loads(_http(node.base, "/metrics")[1])
        c = body["engine"]["cost"]
        lane = sum(s[2] for s in segments)
        idle = sum(s[3] for s in segments)
        bucket = c["buckets"][str(width)]
        check(c["continuous"]["segments"] == bucket["dispatches"] == len(segments),
              f"the cost plane counts {c['continuous']['segments']} segments, "
              f"the probe {len(segments)}")
        check((bucket["lane_steps"], bucket["idle_lane_steps"]) == (lane, idle),
              f"cost plane lane/idle {bucket['lane_steps']}/{bucket['idle_lane_steps']} "
              f"against the K3b digests' {lane}/{idle}")
        out["cost_continuous"] = c["continuous"]
        out["cost_pool"] = {k: bucket[k] for k in (
            "dispatches", "boards", "lane_steps", "idle_lane_steps", "lane_util_pct",
            "fill_pct", "device_s")}
        out["boundary_host_ms_cost_plane"] = c["continuous"]["boundary_host_ms"]
        out["boundary_host_ms_phase6_p50"] = boundary_p50_ms
        log(f"after 16 concurrent clients: engine.cost.continuous {c['continuous']}; "
            f"pool bucket {out['cost_pool']}; K3b digests sum lane {lane} idle "
            f"{idle} over {len(segments)} segments (equal); boundary_host_ms "
            f"(cost plane: mean over every segment, speculative ones at 0) "
            f"{out['boundary_host_ms_cost_plane']} beside phase 6's recorder p50 "
            f"{boundary_p50_ms}")

        # the Prometheus rendering of the same (quiescent) body by both
        # routes, one scrape each: line for line equal, but for the series
        # that follow the clock (_PROM_CLOCK_SERIES), which may move between
        # the two instants; those that moved are named
        status, prom, headers = _http(node.base, "/metrics.prom")
        check(status == 200
              and headers["Content-Type"].startswith("text/plain; version=0.0.4"),
              f"/metrics.prom answered {status}")
        moved = _prom_clock_moves(prom, _http(node.base, "/metrics?format=prom")[1])
        out["prom_clock_series_moved"] = moved
        body = json.loads(_http(node.base, "/metrics")[1])
        values = {}
        for line in prom.decode().strip().splitlines():
            m = _PROM_LINE.match(line)
            check(m is not None, f"unparseable prom line {line!r}")
            if m.group(1):
                values[m.group(1)] = float(m.group(2))
        leaves = _prom_leaves(body)
        differ = {k: (v, values.get(k)) for k, v in leaves.items() if values.get(k) != v}
        check(not differ, f"/metrics.prom disagrees with the JSON body: {list(differ.items())[:5]}")
        check(values['sudoku_stage_latency_ms_count{stage="device"}']
              == body["obs"]["stages"]["device"]["count"], "stage histogram count differs")
        out["prom_series"] = len(values)
        log(f"/metrics.prom: {len(values)} series, every JSON leaf equal; against "
            f"/metrics?format=prom every line equal but the clock's series {moved}")

        status, raw, _ = _http(node.base, "/debug/trace")
        doc = json.loads(raw)
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        check(status == 200 and xs and all(
            isinstance(e["ts"], float) and isinstance(e["dur"], float)
            and e["name"] and e["pid"] == 1 and e["tid"] >= 1 for e in xs),
            "/debug/trace is not valid trace-event JSON")
        check(any(e["name"] == "/solve" for e in xs)
              and any(e["cat"] == "stage" and e["name"] == "device" for e in xs),
              "/debug/trace holds no /solve span with a device stage")
        out["trace_events"] = len(doc["traceEvents"])
        status, raw, _ = _http(node.base, "/debug/flightrecord", b"")
        dump = json.loads(raw)
        check(status == 200 and dump["path"] and os.path.exists(dump["path"]),
              f"POST /debug/flightrecord wrote no dump: {status} {dump}")
        with open(dump["path"]) as f:
            record = json.load(f)
        check(len(record["spans"]) == dump["spans"] >= 36 and record["trace"]["traceEvents"],
              "the flight record lacks the spans")
        out["flightrecord_spans"] = dump["spans"]
        log(f"/debug/trace: {out['trace_events']} events; POST /debug/flightrecord "
            f"wrote {dump['spans']} spans to {os.path.basename(dump['path'])}")
    finally:
        node.stop()
    out["segment_launches"] = cs.dfs_segment.launches
    out["solver_launches"] = cs.dfs_solver.launches
    check(out["segment_launches"] > 0 and out["solver_launches"] > 0,
          "the obs main path launched no kernel")
    log(f"obs main path: {out['segment_launches']} segment launches, "
        f"{out['solver_launches']} dfs_solver launches (warm-up)")

    # a --device-trace-dir node: its warm-up capture names the kernels
    trace_dir = os.path.join(out_dir, "device_trace")
    n_before = len(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else 0
    traced = _Node(build_parser, build_node,
                   ["--no-answer-cache", "--device-trace-dir", trace_dir,
                    "--device-trace-calls", "1"])
    try:
        check(traced.node.engine.warm_info()["device_trace"]["warmup_traced"],
              "the --device-trace-dir node did not trace its warm-up")
        status, body, _ = _http(traced.base, "/solve", readme)
        check(status == 200, f"/solve on the traced node answered {status}")
    finally:
        traced.stop()
    files = sorted(os.listdir(trace_dir))
    check(len(files) > n_before, "the --device-trace-dir node wrote no trace")
    text = "".join(open(os.path.join(trace_dir, f)).read() for f in files)
    named = {k: k in text for k in ("dfs_solver_kernel", "dfs_segment_kernel",
                                    "segment_digest_kernel")}
    check(all(named.values()), f"the torch.profiler trace does not name the kernels: {named}")
    out["device_trace_files"] = len(files)
    log(f"--device-trace-dir: {len(files)} torch.profiler trace(s), naming {sorted(named)}")

    # the plane's cost: README p50 with obs on beside --no-obs, in turns
    on = _Node(build_parser, build_node, ["--no-answer-cache"])
    off = _Node(build_parser, build_node, ["--no-answer-cache", "--no-obs"])
    try:
        check(off.node.tracer is None and off.node.flight is None,
              "the --no-obs node has a tracer")
        status, _, headers = _http(off.base, "/solve", readme, {"X-Timing": "1"})
        check(status == 200 and "X-Timing" not in headers
              and headers.get("X-Request-Id"),
              "the --no-obs node answered X-Timing or no X-Request-Id")
        turns = {"on": [], "off": []}
        for arm, n in (("on", on), ("off", off), ("off", off), ("on", on)):
            turns[arm].append(n.readme_p50(f"obs {arm}", oracle_ok))
        out["readme_p50_ms_obs_on"] = turns["on"]
        out["readme_p50_ms_obs_off"] = turns["off"]
    finally:
        on.stop()
        off.stop()
    return out


# -- phase 9: the rest of the single-node surface -----------------------------

class _Conn:
    """One keep-alive HTTP/1.1 connection to a node."""

    def __init__(self, base: str):
        import http.client

        host, port = base.rsplit("/", 1)[1].split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=300)

    def request(self, method: str, path: str, body=None, headers=None):
        """(status, body bytes, response headers); the connection stays
        open unless the server closed it."""
        self.conn.request(method, path, body, headers or {})
        r = self.conn.getresponse()
        return r.status, r.read(), r.headers

    def post(self, path: str, body: bytes, headers=None):
        return self.request("POST", path, body, headers)

    def close(self) -> None:
        self.conn.close()


def _p50_of(send, n: int, ok) -> float:
    """The p50 in ms of ``n`` calls of ``send`` (host clock); ``ok`` checks
    each (status, body, headers)."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        got = send()
        lat.append((time.perf_counter() - t0) * 1e3)
        ok(*got)
    return _p50_ms(lat)


def _clients(n: int, boards, send_for, oracle_ok, what: str) -> float:
    """``n`` client threads released together, client i sending its share
    of ``boards`` one after another through ``send_for(i)``; every answer
    must be a solution of its board. Returns the wall time in s."""
    per = len(boards) // n

    def run(i):
        send = send_for(i)
        for b in boards[i * per:(i + 1) * per]:
            status, body, _ = send("/solve", json.dumps({"sudoku": b}).encode())
            check(status == 200, f"{what}: /solve answered {status}")
            _check_answer(b, json.loads(body), oracle_ok, what)

    t0 = time.perf_counter()
    _concurrent(n, run)
    return time.perf_counter() - t0


def _keepalive_sender(base: str, conns: list):
    conn = _Conn(base)
    conns.append(conn)
    return conn.post


def _per_conn_sender(base: str):
    return lambda path, body: _http(base, path, body)


def _serve_legacy(make_http_server, node):
    """The stdlib transport (HTTP/1.0) over the same node object."""
    httpd = make_http_server(node, "127.0.0.1", 0, legacy_transport=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _front_transports(cs, build_parser, build_node, make_http_server, oracle_ok):
    """Phase 9 (a): the README /solve p50 on the default node's fastserve
    (keep-alive and a connection per request) and on the stdlib transport
    over the same node, in turns (fast, legacy, legacy, fast); the same for
    cache hits on a cached node; 16 concurrent clients on each transport;
    then a --seed-serving node."""
    corpus = load_corpus("corpus_9x9_hard_4096.npz")
    readme = json.dumps({"sudoku": README_PUZZLE}).encode()
    turns = ("fast", "legacy", "legacy", "fast")
    out = {"readme_p50_ms": {}, "hit_p50_ms": {}, "clients16_wall_s": {}}

    def readme_ok(status, body, headers, hit=False):
        check(status == 200, f"README /solve answered {status}")
        check(oracle_ok(json.loads(body)), "README answer invalid")
        check((headers.get("X-Cache") == "hit") == hit, "unexpected X-Cache")

    for cached in (False, True):
        argv = [] if cached else ["--no-answer-cache"]
        node = _Node(build_parser, build_node, argv)
        legacy, legacy_base = _serve_legacy(make_http_server, node.node)
        key = "hit_p50_ms" if cached else "readme_p50_ms"
        ok = (lambda *a: readme_ok(*a, hit=True)) if cached else readme_ok
        reads = {"fast_keepalive": [], "fast_per_conn": [], "legacy_per_conn": []}
        conns = []
        try:
            if cached:
                status, _, _ = _http(node.base, "/solve", readme)
                check(status == 200, "priming the cache failed")
            for turn in turns:
                if turn == "fast":
                    conn = _Conn(node.base)
                    conns.append(conn)
                    reads["fast_keepalive"].append(
                        _p50_of(lambda: conn.post("/solve", readme), 20, ok))
                    reads["fast_per_conn"].append(
                        _p50_of(lambda: _http(node.base, "/solve", readme), 20, ok))
                else:
                    reads["legacy_per_conn"].append(
                        _p50_of(lambda: _http(legacy_base, "/solve", readme), 20, ok))
            out[key] = reads
            if not cached:
                # 16 concurrent clients, 4 fresh boards each, per turn; the
                # /stats validations they added must equal the same boards'
                # counters replayed through the node's solve entry point
                before = node.validations()
                sent = []
                for k, turn in enumerate(turns):
                    boards = [b.tolist() for b in corpus[600 + 64 * k: 664 + 64 * k]]
                    sent += boards
                    if turn == "fast":
                        wall = _clients(
                            16, boards,
                            lambda i: _keepalive_sender(node.base, conns),
                            oracle_ok, "keep-alive client")
                        out["clients16_wall_s"].setdefault("fast_keepalive", []).append(wall)
                    else:
                        wall = _clients(16, boards,
                                        lambda i: _per_conn_sender(legacy_base),
                                        oracle_ok, "legacy client")
                        out["clients16_wall_s"].setdefault("legacy_per_conn", []).append(wall)
                grew = node.validations() - before
                replay = []
                for lo in range(0, len(sent), 16):
                    replay += _concurrent(
                        16, lambda i, lo=lo: node.node.peer_sudoku_solve_info(sent[lo + i]))
                summed = sum(info["validations"] for _, info in replay)
                log(f"16 concurrent clients x4 turns: /stats validations grew by "
                    f"{grew}; the same 256 boards replayed count {summed}")
                check(grew == summed, "/stats validations disagree with the answers")
        finally:
            for c in conns:
                c.close()
            legacy.shutdown()
            legacy.server_close()
            node.stop()
    seed = _Node(build_parser, build_node, ["--seed-serving", "--no-answer-cache"])
    try:
        check(not seed.node.engine.coalesce and seed.node.serialize_solves,
              "--seed-serving did not serialize without the coalescer")
        out["readme_p50_ms"]["seed_serving"] = _p50_of(
            lambda: _http(seed.base, "/solve", readme), 20, readme_ok)
        boards = [b.tolist() for b in corpus[900:964]]
        out["clients16_wall_s"]["seed_serving"] = _clients(
            16, boards, lambda i: _per_conn_sender(seed.base), oracle_ok,
            "--seed-serving client")
    finally:
        seed.stop()
    log(f"transport A/B (host clock; fast/legacy/legacy/fast): README p50 ms "
        f"{out['readme_p50_ms']}; cache-hit p50 ms {out['hit_p50_ms']}; 16 "
        f"concurrent clients x 4 boards, wall s {out['clients16_wall_s']}")
    return out


def _stage_widths(engine):
    """Record the width of every DFS-kernel stage the engine runs (bucket
    calls, their deeper stages and deep retries): wraps ``_stage_rows``.
    Returns the list it fills."""
    real = engine._stage_rows
    widths = []
    lock = threading.Lock()

    def stage_rows(dev, *a, **kw):
        with lock:
            widths.append(int(dev.shape[0]))
        return real(dev, *a, **kw)

    engine._stage_rows = stage_rows
    return widths


def _rows_of(payload):
    return payload["solutions"], payload["solved"], payload["capped"]


def _front_batch(cs, SolverEngine, build_parser, build_node, oracle_ok):
    """Phase 9 (b): POST /solve_batch. The 4096-board hard corpus in one
    request against ``solve_batch_np`` on a fresh engine, its throughput
    beside in-process, the same batch beside 16 /solve clients, a cached
    repeat, and a supervised node's degraded batch."""
    import numpy as np

    boards = load_corpus("corpus_9x9_hard_4096.npz")
    out = {}
    fresh = SolverEngine()
    try:
        fresh.warmup()
        sols, mask, info = fresh.solve_batch_np(boards)
        t0 = time.perf_counter()
        fresh.solve_batch_np(boards)
        out["inprocess_boards_per_s"] = len(boards) / (time.perf_counter() - t0)
    finally:
        fresh.close()
    want = [s.tolist() if m else None for s, m in zip(sols, mask)]
    want_rows = (want, int(mask.sum()), info["capped"])
    # the path's launches start here: the fresh engine is the reference
    cs.dfs_solver.launches = 0
    cs.dfs_segment.launches = 0
    node = _Node(build_parser, build_node, ["--batch-api", "--no-answer-cache"])
    eng = node.node.engine
    conns = []
    try:
        widths = _stage_widths(eng)
        k1 = cs.dfs_solver.launches
        v0 = node.validations()
        conn = _Conn(node.base)
        conns.append(conn)
        t0 = time.perf_counter()
        body = json.dumps({"sudokus": boards.tolist()}).encode()
        t1 = time.perf_counter()
        status, raw, headers = conn.post("/solve_batch", body)
        t2 = time.perf_counter()
        payload = json.loads(raw)
        t3 = time.perf_counter()
        check(status == 200, f"/solve_batch answered {status}: {raw[:200]!r}")
        check("degraded" not in payload and headers.get("X-Degraded") is None,
              "the unsupervised node's batch carried degraded flags")
        check(_rows_of(payload) == want_rows,
              "/solve_batch rows differ from solve_batch_np on a fresh engine")
        for b, sol in zip(boards, payload["solutions"]):
            if sol is not None:
                _check_answer(b, sol, oracle_ok, "/solve_batch row")
        grew = node.validations() - v0
        check(grew == info["validations"],
              f"/stats validations grew by {grew}, the batch's info says "
              f"{info['validations']}")
        launched = cs.dfs_solver.launches - k1
        check(launched == len(widths) and set(widths) == {eng.buckets[-1]},
              f"K1 launches {launched}, stage widths {widths}: not "
              f"{eng.buckets[-1]}-wide chunks")
        out["http"] = {
            "boards_per_s": len(boards) / (t3 - t0),
            "encode_ms": (t1 - t0) * 1e3,
            "roundtrip_ms": (t2 - t1) * 1e3,
            "decode_ms": (t3 - t2) * 1e3,
            "request_bytes": len(body),
            "response_bytes": len(raw),
            "k1_launches": launched,
        }
        log(f"/solve_batch {len(boards)} hard boards: {out['http']}; in-process "
            f"solve_batch_np {out['inprocess_boards_per_s']:.0f} boards/s (host clock)")

        # the same batch while 16 /solve clients are in flight
        stop = threading.Event()
        answered = []
        k3 = cs.dfs_segment.launches

        def client(i):
            c = _Conn(node.base)
            try:
                j = 0
                while not stop.is_set():
                    b = boards[(i * 37 + j) % len(boards)].tolist()
                    status, raw_i, _ = c.post("/solve", json.dumps({"sudoku": b}).encode())
                    check(status == 200, f"/solve beside the batch answered {status}")
                    _check_answer(b, json.loads(raw_i), oracle_ok, "/solve beside the batch")
                    answered.append(1)
                    j += 1
            finally:
                c.close()

        errors = []

        def guarded(i):
            try:
                client(i)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=guarded, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        _wait(lambda: len(answered) >= 16, 60.0, "the /solve clients to start")
        status, raw, _ = conn.post("/solve_batch", body)
        during = len(answered)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        if errors:
            raise errors[0]
        check(status == 200 and _rows_of(json.loads(raw)) == want_rows,
              "/solve_batch beside 16 /solve clients answered other rows")
        check(cs.dfs_segment.launches > k3, "the /solve clients launched no segment")
        out["concurrent"] = {"solve_answers": len(answered),
                             "solve_answers_by_batch_end": during}
        log(f"/solve_batch beside 16 keep-alive /solve clients: same rows; "
            f"{out['concurrent']}")
    finally:
        for c in conns:
            c.close()
        node.stop()

    cached = _Node(build_parser, build_node, ["--batch-api"])
    try:
        body = json.dumps({"sudokus": boards[:64].tolist()}).encode()
        s1, b1, h1 = _http(cached.base, "/solve_batch", body)
        s2, b2, h2 = _http(cached.base, "/solve_batch", body)
        check(s1 == s2 == 200 and h1.get("X-Cache") is None
              and h2.get("X-Cache") == "hit" and b1 == b2,
              "the repeated 64-board batch was not a byte-identical X-Cache hit")
        out["cache"] = cached.node.answer_cache.snapshot()
    finally:
        cached.stop()

    sup_node = _Node(build_parser, build_node, [
        "--batch-api", "--no-answer-cache", "--supervise-engine", "--chaos-injector"])
    try:
        small = load_corpus("corpus_9x9_hard_64.npz")[:4]
        body = json.dumps({"sudokus": small.tolist()}).encode()
        status, raw, headers = _http(sup_node.base, "/solve_batch", body)
        check(status == 200 and "degraded" not in json.loads(raw)
              and headers.get("X-Degraded") is None,
              f"the supervised batch before any fault answered {status} "
              f"{headers.get('X-Degraded')} {raw[:200]!r}")
        _faults(sup_node.base, {"fail_next": 1})
        status, raw, headers = _http(sup_node.base, "/solve_batch", body)
        check(status == 200, f"the supervised degraded batch answered {status}")
        payload = json.loads(raw)
        check(headers.get("X-Degraded") == "true"
              and payload["degraded"] == [True] * len(small)
              and payload["solved"] == len(small),
              f"the degraded batch carried {headers.get('X-Degraded')} {payload}")
        for b, sol in zip(small, payload["solutions"]):
            _check_answer(b, sol, oracle_ok, "degraded batch row")
        out["supervised"] = {"degraded": payload["degraded"],
                             "state": sup_node.node.engine.supervisor.state}
        log(f"supervised /solve_batch after fail_next 1: 200, X-Degraded true, "
            f"{out['supervised']}")
    finally:
        sup_node.stop()
    return out, want_rows


def _board_sizes(cs, build_parser, build_node, oracle_ok, seed: int):
    """Phase 9 (c): nodes at 16x16 (the default ladder), 25x25 (buckets
    1,8,64) and 4x4 (16 seeded boards), each path's launches counted
    apart."""
    out = {"launches": {}}
    cases = (
        (16, ["--batch-api"], load_corpus("corpus_16x16_hard_2048.npz")),
        (25, ["--buckets", "1,8,64"], load_corpus("corpus_25x25_hard_512.npz")[:8]),
        (4, [], boards_4x4(16, seed + 6)),
    )
    for size, argv, boards in cases:
        cs.dfs_solver.launches = 0
        cs.dfs_segment.launches = 0
        t0 = time.perf_counter()
        node = _Node(build_parser, build_node,
                     ["--board-size", str(size), "--no-answer-cache", *argv])
        warm_s = time.perf_counter() - t0
        conns = []
        try:
            eng = node.node.engine
            check(eng.spec.size == size, f"--board-size {size} built a {eng.spec.size} engine")
            k3 = cs.dfs_segment.launches
            seq = [b.tolist() for b in boards[:16]]
            t0 = time.perf_counter()
            for b in seq:
                status, raw, headers = _http(node.base, "/solve",
                                             json.dumps({"sudoku": b}).encode())
                check(status == 200 and headers.get("X-Degraded") is None,
                      f"{size}x{size} /solve answered {status} "
                      f"X-Degraded {headers.get('X-Degraded')}")
                _check_answer(b, json.loads(raw), oracle_ok, f"{size}x{size} /solve")
            seq_ms = (time.perf_counter() - t0) * 1e3 / len(seq)
            check(cs.dfs_segment.launches > k3, f"{size}x{size} /solve launched no segment")
            entry = {"warm_s": warm_s, "solve_ms_mean": seq_ms, "boards": len(seq)}
            if size == 16:
                entry["clients16_wall_s"] = _clients(
                    16, seq, lambda i: _keepalive_sender(node.base, conns),
                    oracle_ok, "16x16 keep-alive client")
                many = boards[:256]
                status, raw, headers = _http(
                    node.base, "/solve_batch",
                    json.dumps({"sudokus": many.tolist()}).encode())
                payload = json.loads(raw)
                check(status == 200 and payload["solved"] == len(many)
                      and "degraded" not in payload
                      and headers.get("X-Degraded") is None,
                      f"16x16 /solve_batch answered {status} {raw[:200]!r}")
                for b, sol in zip(many, payload["solutions"]):
                    _check_answer(b, sol, oracle_ok, "16x16 /solve_batch row")
                nine = json.dumps({"sudoku": [[0] * 9 for _ in range(9)]}).encode()
                status, raw, _ = _http(node.base, "/solve", nine)
                check(status == 400 and json.loads(raw) == {"error": "Invalid request"},
                      f"a 9x9 body on the 16x16 node answered {status} {raw!r}")
            out[f"{size}x{size}"] = entry
        finally:
            for c in conns:
                c.close()
            node.stop()
        out["launches"][size] = {"dfs_solver": cs.dfs_solver.launches,
                                 "dfs_segment": cs.dfs_segment.launches}
        log(f"--board-size {size}: {out[f'{size}x{size}']}, launches "
            f"{out['launches'][size]}")
    return out


def _fresh_process_ready(argv=(), timeout_s: float = 180.0, probe=None) -> dict:
    """A default CLI node in a process of its own (the kernel library
    loaded from its store, no nvcc, unless ``argv`` names another store):
    seconds from the spawn to the first /readyz 503, to /readyz 200 and to
    ``fully_warmed``; then ``probe(base)``, if given, into ``"probe"``,
    before the node stops."""
    import subprocess as sp

    http_port, udp_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{http_port}"
    dump_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_fr_")
    t0 = time.perf_counter()
    proc = sp.Popen(
        [sys.executable, "-m", "sudoku_solver_distributed_tpu_torch.net.cli",
         "-p", str(http_port), "-s", str(udp_port), "-h", "1", "--metrics",
         "--no-answer-cache", "--flightrecord-dir", dump_dir.name, *argv],
        cwd=ROOT, stdout=sp.DEVNULL, stderr=sp.DEVNULL,
    )
    out = {"first_503_s": None}
    try:
        while True:
            check(proc.poll() is None, "the CLI node exited")
            check(time.perf_counter() - t0 < timeout_s, "the CLI node never became ready")
            try:
                with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
                    status = r.status
            except urllib.error.HTTPError as e:
                status = e.code
            except OSError:
                time.sleep(0.01)  # not bound yet
                continue
            if status == 503 and out["first_503_s"] is None:
                out["first_503_s"] = time.perf_counter() - t0
            if status == 200:
                out["ready_s"] = time.perf_counter() - t0
                break
            time.sleep(0.005)
        while True:
            check(time.perf_counter() - t0 < timeout_s, "the CLI node never warmed fully")
            metrics = json.loads(_http(base, "/metrics")[1])
            if metrics["engine"]["fully_warmed"]:
                out["fully_warmed_s"] = time.perf_counter() - t0
                break
            time.sleep(0.02)
        if probe is not None:
            out["probe"] = probe(base)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except sp.TimeoutExpired:
            proc.kill()
            proc.wait()
        dump_dir.cleanup()
    return out


def _front_warmup(cs, SolverEngine, build_parser, build_node, oracle_ok, want_rows):
    """Phase 9 (d): /readyz 503 until tier 0 ran and 200 after, the GC
    freeze once fully warm, a fresh process's seconds to ready, and a
    budget-cut node's /solve_batch tiled over its largest warm width."""
    import gc

    out = {}
    gate = threading.Event()
    real = SolverEngine._warm_segment_program

    def held(self):
        check(gate.wait(60), "the tier-0 gate was never opened")
        return real(self)

    # the CLI's gc.freeze() calls, each with its thread and what the
    # generations held (an earlier node's freeze thread may fire here too;
    # the count alone cannot tell, and an earlier freeze already moved the
    # heap to the permanent generation)
    real_freeze = gc.freeze
    froze = []

    def freeze():
        froze.append((threading.current_thread(), len(gc.get_objects())))
        real_freeze()

    SolverEngine._warm_segment_program = held
    gc.freeze = freeze
    node = None
    earlier = {t for t in threading.enumerate() if t.name == "gc-freeze"}
    try:
        t0 = time.perf_counter()
        node = _Node(build_parser, build_node, ["--no-answer-cache"], wait=False)
        bound_s = time.perf_counter() - t0
        freezer = [t for t in threading.enumerate()
                   if t.name == "gc-freeze" and t not in earlier]
        check(len(freezer) == 1, f"the node started {len(freezer)} GC-freeze threads")
        status, raw, _ = _http(node.base, "/readyz")
        check(status == 503 and json.loads(raw) == {"ready": False, "warmed": False},
              f"/readyz before tier 0 answered {status} {raw!r}")
        check(not any(t is freezer[0] for t, _ in froze),
              "the node froze its heap before the warm-up")
        t_gate = time.perf_counter()
        gate.set()
        while _http(node.base, "/readyz")[0] != 200:
            check(time.perf_counter() - t_gate < 120, "/readyz never turned 200")
            time.sleep(0.002)
        out["bind_s"] = bound_s
        out["gate_held_s"] = t_gate - t0 - bound_s
        out["ready_after_gate_s"] = time.perf_counter() - t_gate
        eng = node.node.engine
        _wait(lambda: eng.fully_warmed, 120.0, "fully_warmed")
        out["fully_warmed_after_gate_s"] = time.perf_counter() - t_gate
        # the freeze thread polls fully_warmed once a second, then runs a
        # full collection and the freeze
        freezer[0].join(timeout=120)
        out["gc_freeze_done_after_gate_s"] = time.perf_counter() - t_gate
        out["gc_freeze_count"] = gc.get_freeze_count()
        out["gc_objects_at_freeze"] = [n for t, n in froze if t is freezer[0]]
        check(not freezer[0].is_alive() and len(out["gc_objects_at_freeze"]) == 1
              and out["gc_freeze_count"] > 0,
              f"the GC freeze did not run: {out}, all calls {froze}")
        out["order"] = eng.warm_info()["order"]
    finally:
        gate.set()
        SolverEngine._warm_segment_program = real
        gc.freeze = real_freeze
        if node is not None:
            node.stop()
    out["fresh_process"] = _fresh_process_ready()
    log(f"tiered warm-up: {out}")

    # a budget-cut node (a zero budget means none, as in the JAX CLI): the
    # widening skips every bucket past tier 0 ([1, 512] on the default
    # ladder with a 512 batch cap), and a 4096-board batch tiles over 512
    cut = _Node(build_parser, build_node,
                ["--batch-api", "--no-answer-cache", "--warmup-budget-s", "1e-9",
                 "--coalesce-max-batch", "512"], wait=False)
    try:
        eng = cut.node.engine
        _wait(lambda: eng.warm_info()["skipped"], 120.0, "the budget cut")
        info = eng.warm_info()
        tier0 = [eng.buckets[0], min(b for b in eng.buckets if b >= min(512, eng.buckets[-1]))]
        check(info["tier0"] == tier0 and eng.warmed and not eng.fully_warmed
              and info["skipped"] == [b for b in eng.buckets if b not in tier0],
              f"the budget-cut warm-up reads {info}")
        widths = _stage_widths(eng)
        k1 = cs.dfs_solver.launches
        boards = load_corpus("corpus_9x9_hard_4096.npz")
        status, raw, _ = _http(cut.base, "/solve_batch",
                               json.dumps({"sudokus": boards.tolist()}).encode())
        check(status == 200, f"the budget-cut /solve_batch answered {status}")
        got = _rows_of(json.loads(raw))
        check(got[:2] == want_rows[:2],
              "the tiled /solve_batch answered other rows than the 4096-wide one")
        check(set(widths) == {tier0[-1]} and len(widths) >= len(boards) // tier0[-1]
              and cs.dfs_solver.launches - k1 == len(widths),
              f"the tiled batch ran K1 at widths {sorted(set(widths))} x{len(widths)}")
        out["budget_cut"] = {"skipped": info["skipped"], "tier0": info["tier0"],
                             "k1_widths": sorted(set(widths)), "k1_launches": len(widths)}
    finally:
        cut.stop()
    log(f"budget-cut node: {out['budget_cut']}")
    return out


def _host_apis(oracle_ok):
    """Phase 9 (e): ``Sudoku`` on the default device (the card) answers
    the README board's checks as on the CPU; ``SudokuSolver()`` solves it
    on the card."""
    from sudoku_solver_distributed_tpu_torch import Sudoku, SudokuSolver

    def checks(s):
        return ([s.check_row(i) for i in range(9)]
                + [s.check_column(i) for i in range(9)]
                + [s.check_square(3 * i, 3 * j) for i in range(3) for j in range(3)]
                + [s.check_is_valid(0, 0, 1), s.check_is_valid(0, 0, 5), s.check()])

    card = Sudoku(README_PUZZLE, base_delay=0.0)
    check(card.device.type == "cuda", f"Sudoku defaults to {card.device}")
    got, want = checks(card), checks(Sudoku(README_PUZZLE, base_delay=0.0, device="cpu"))
    check(got == want, "Sudoku's checks on the card differ from the CPU's")
    solver = SudokuSolver()
    try:
        check(solver._engine.device.type == "cuda", "SudokuSolver's engine is not on the card")
        board = [row[:] for row in README_PUZZLE]
        sol = solver.solve_sudoku(board)
        _check_answer(README_PUZZLE, sol, oracle_ok, "SudokuSolver answer")
        check(board == sol and Sudoku(sol, base_delay=0.0).check(),
              "SudokuSolver did not solve the README board in place")
    finally:
        solver._engine.close()
    log("host APIs: Sudoku checks on the card equal the CPU's; SudokuSolver "
        "solved the README board on the card")
    return {"sudoku_checks": sum(got), "solver_validations": solver.validations}


def phase_front(cs, SolverEngine, build_parser, build_node, make_http_server, oracle_ok,
                seed: int):
    """Phase 9: the transports, /solve_batch, the board sizes, the tiered
    warm-up and the host APIs. Returns the ``front`` numbers and the
    launches of each new path."""
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = round(now - t0, 1)
        t0 = now

    front = {"transports": _front_transports(cs, build_parser, build_node,
                                             make_http_server, oracle_ok)}
    lap("a_transports")
    front["batch"], want_rows = _front_batch(cs, SolverEngine, build_parser,
                                             build_node, oracle_ok)
    launches = {"batch_api": {"dfs_solver": cs.dfs_solver.launches,
                              "dfs_segment": cs.dfs_segment.launches}}
    lap("b_batch")
    sizes = _board_sizes(cs, build_parser, build_node, oracle_ok, seed)
    for size in (16, 25, 4):
        launches[f"board_{size}"] = sizes["launches"].pop(size)
    front["board_sizes"] = sizes
    lap("c_board_sizes")
    front["warmup"] = _front_warmup(cs, SolverEngine, build_parser, build_node,
                                    oracle_ok, want_rows)
    lap("d_warmup")
    front["host_apis"] = _host_apis(oracle_ok)
    lap("e_host_apis")
    front["seconds"] = seconds
    log(f"phase 9 seconds by part: {seconds}")
    for path, counts in launches.items():
        check(counts["dfs_solver"] > 0 and counts["dfs_segment"] > 0,
              f"the {path} path did not launch every kernel: {counts}")
    front["launches"] = launches
    return front


# -- phase 10: the P2P cluster on one card ------------------------------------

P2P_NODES = 4
P2P_FAILURE_TIMEOUT_S = 2.0  # --failure-timeout of every phase-10 node
GOSSIP_INTERVAL_S = 1.0      # the node's stats gossip period (net/node.py)

# What each phase-10 process runs: the port's CLI, with the kernel
# wrappers' launch counts set to 0 before it starts and SIGUSR1 writing
# them (and a sequence number) to the file CHIP_SMOKE_COUNTS names.
_P2P_BOOT = r"""
import json, os, signal, sys
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
from sudoku_solver_distributed_tpu_torch.net import cli
path = os.environ["CHIP_SMOKE_COUNTS"]
seq = [0]
def dump(*_):
    seq[0] += 1
    with open(path + ".tmp", "w") as f:
        json.dump({"seq": seq[0], "dfs_solver": cs.dfs_solver.launches,
                   "dfs_segment": cs.dfs_segment.launches}, f)
    os.replace(path + ".tmp", path)
cs.dfs_solver.launches = 0
cs.dfs_segment.launches = 0
signal.signal(signal.SIGUSR1, dump)
cli.main(sys.argv[1:])
"""


def _free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ProcNode:
    """One node of the port's CLI in a process of its own (its own CUDA
    context and engine), in its default configuration plus ``--metrics``,
    ``-h 0`` and the phase's ``--failure-timeout``; ``anchor`` is its
    ``-a``. Its log and flight records go to ``tmp``. ``-h 0``: the
    reference's handicap throttle (each farmed task past 5 in 10 s sleeps
    ``h / 100 × (n − 4)`` s on the worker) would otherwise be what the
    farm's timings measure: with ``-h 1``, 20 farmed corpus misses took
    3.8–7.0 s each on the H100."""

    def __init__(self, k: int, tmp: str, anchor=None):
        self.k = k
        http_port, udp_port = _free_port(), _free_udp_port()
        self.id = f"127.0.0.1:{udp_port}"
        self.base = f"http://127.0.0.1:{http_port}"
        self.counts_path = os.path.join(tmp, f"counts{k}.json")
        self.seq = 0
        argv = ["-p", str(http_port), "-s", str(udp_port), "-h", "0",
                "--metrics", "--failure-timeout", str(P2P_FAILURE_TIMEOUT_S),
                "--flightrecord-dir", tmp]
        if anchor is not None:
            argv += ["-a", anchor]
        self.log_path = os.path.join(tmp, f"node{k}.log")
        self.log = open(self.log_path, "wb")
        env = dict(os.environ, CHIP_SMOKE_COUNTS=self.counts_path,
                   PYTHONPATH=os.pathsep.join(
                       p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _P2P_BOOT, *argv], cwd=ROOT, env=env,
            stdout=self.log, stderr=subprocess.STDOUT,
        )

    def alive(self) -> bool:
        return self.proc.poll() is None

    def get(self, path: str):
        """(status, body bytes, headers), or None while nothing listens."""
        try:
            return _http(self.base, path)
        except (urllib.error.URLError, ConnectionError, OSError):
            return None

    def json(self, path: str):
        r = self.get(path)
        check(r is not None and r[0] == 200,
              f"node {self.k} {path}: {r and r[0]}")
        return json.loads(r[1])

    def solve(self, board):
        return _http(self.base, "/solve", json.dumps({"sudoku": board}).encode())

    def network(self) -> set:
        view = self.json("/network")
        return set(view) | {p for v in view.values() for p in v}

    def counts(self) -> dict:
        """The wrappers' launch counts in this process, read through
        SIGUSR1 and the counts file."""
        self.seq += 1
        self.proc.send_signal(signal.SIGUSR1)

        def fresh():
            try:
                with open(self.counts_path) as f:
                    return json.load(f).get("seq") == self.seq
            except (OSError, ValueError):
                return False

        _wait(fresh, 15.0, f"node {self.k}'s launch counts")
        with open(self.counts_path) as f:
            return json.load(f)

    def tail(self, n: int = 3000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                return f.read()[-n:].decode(errors="replace")
        except OSError:
            return ""

    def stop(self, timeout_s: float = 30.0) -> None:
        """SIGINT (the CLI's graceful departure), then SIGKILL past
        ``timeout_s``."""
        if self.alive():
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self.log.close()


def _metric(body: dict, *path, default=0):
    for key in path:
        if not isinstance(body, dict) or key not in body:
            return default
        body = body[key]
    return body


def phase_p2p(oracle_ok, random_symmetry, count_solutions, SolverEngine,
              single_node_p50: dict):
    """Phase 10 (see the module docstring) in a temporary directory that
    holds the nodes' logs, flight records and launch-count files."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p2p_") as tmp:
        nodes = []
        try:
            return _phase_p2p(nodes, tmp, oracle_ok, random_symmetry,
                              count_solutions, SolverEngine, single_node_p50)
        except BaseException:
            for n in nodes:
                log(f"--- phase 10 node {n.k} log tail ---\n{n.tail()}")
            raise
        finally:
            for n in nodes:
                n.stop()


def _phase_p2p(nodes, tmp, oracle_ok, random_symmetry, count_solutions,
               SolverEngine, single_node_p50):
    import numpy as np

    out = {"nodes": P2P_NODES, "failure_timeout_s": P2P_FAILURE_TIMEOUT_S}
    corpus = load_corpus("corpus_9x9_hard_4096.npz")
    timed = [corpus[300 + i].tolist() for i in range(20)]
    crash_board = corpus[320].tolist()
    gossip_board = corpus[330].tolist()
    # the single-node answers: an in-process engine on the card
    single = SolverEngine(buckets=(1, 8))
    try:
        single.warmup()
        want = {}
        for b in [README_PUZZLE, *timed, crash_board, gossip_board]:
            sol, _ = single.solve_one(b)
            _check_answer(b, sol, oracle_ok, "the single-node answer")
            want[json.dumps(b)] = sol
    finally:
        single.close()
    for b in [*timed, crash_board, gossip_board]:
        check(count_solutions(b) == 1, "a phase-10 corpus board is not unique")

    t0 = time.perf_counter()
    nodes.append(_ProcNode(0, tmp))
    for k in range(1, P2P_NODES):
        nodes.append(_ProcNode(k, tmp, anchor=nodes[0].id))
    ids = {n.id for n in nodes}

    def converged():
        time.sleep(0.2)
        for n in nodes:
            check(n.alive(), f"node {n.k} exited: {n.proc.returncode}")
            r = n.get("/readyz")
            if r is None or r[0] != 200:
                return False
            if not _metric(n.json("/metrics"), "engine", "fully_warmed"):
                return False
            if n.network() != ids:
                return False
        return True

    out["converged_s"] = _wait(converged, 240.0,
                               "the 4 nodes to converge through -a and warm")
    log(f"phase 10: {P2P_NODES} CLI processes joined through -a, ready and "
        f"fully warm in {time.perf_counter() - t0:.2f} s")
    warm_counts = [n.counts() for n in nodes]
    metrics0 = [n.json("/metrics") for n in nodes]
    master, workers = nodes[3], nodes[:3]

    # (a) the README board on a non-anchor node, on a miss: farmed
    stats0 = master.json("/stats")["all"]
    t1 = time.perf_counter()
    status, body, headers = master.solve(README_PUZZLE)
    out["readme_farm_ms"] = (time.perf_counter() - t1) * 1e3
    check(status == 200 and headers.get("X-Cache") is None
          and headers.get("X-Degraded") is None,
          f"the farmed README /solve answered {status} {dict(headers)}")
    answer = json.loads(body)
    _check_answer(README_PUZZLE, answer, oracle_ok, "the farmed README answer")
    # the README board has many solutions: which one a farm merges depends
    # on the order its cells' answers arrive (the JAX cluster's farm
    # merges the same way); the corpus boards below have one
    out["readme_equals_single_node"] = answer == want[json.dumps(README_PUZZLE)]
    stats1 = master.json("/stats")["all"]
    check(stats1["solved"] == stats0["solved"] + 1,
          f"/stats solved went {stats0['solved']} -> {stats1['solved']}")
    metrics1 = [n.json("/metrics") for n in nodes]
    seg = [(_metric(m1, "engine", "cost", "continuous", "segments")
            - _metric(m0, "engine", "cost", "continuous", "segments"))
           for m0, m1 in zip(metrics0, metrics1)]
    out["readme_segments_by_node"] = seg
    check(all(s > 0 for s in seg[:3]),
          f"a worker ran no segment kernel for the farm: {seg}")
    farm = _metric(metrics1[3], "engine", "cost", "farm", default={})
    holes = sum(v == 0 for row in README_PUZZLE for v in row)
    out["readme_dispatches"] = farm.get("dispatches", 0)
    check(out["readme_dispatches"] > 0, f"the README farm dispatched {farm}")
    # fewer dispatches than empty cells: cells merged from different
    # solutions left a board a worker proved unsolvable, and the master's
    # engine answered the original board (the farm's authoritative
    # fallback, as on the JAX node)
    out["readme_fell_back"] = out["readme_dispatches"] < holes
    log(f"phase 10 (a): README on node 3 farmed in {out['readme_farm_ms']:.1f} ms, "
        f"{out['readme_dispatches']} dispatches for {holes} empty cells "
        f"(engine fallback: {out['readme_fell_back']}), segments per node "
        f"{seg}, equal to the single-node answer: "
        f"{out['readme_equals_single_node']}")

    # (b) 20 farmed corpus boards, each a miss, timed on the host clock
    lat = []
    for b in timed:
        t1 = time.perf_counter()
        status, body, headers = master.solve(b)
        lat.append((time.perf_counter() - t1) * 1e3)
        check(status == 200 and headers.get("X-Cache") is None,
              f"a farmed corpus /solve answered {status}")
        check(json.loads(body) == want[json.dumps(b)],
              "a farmed corpus answer differs from the single-node answer")
    lat.sort()
    out["farm_ms"] = {"p50": lat[10], "min": lat[0], "max": lat[-1]}
    out["single_node_miss_p50_ms"] = single_node_p50
    metrics2 = [n.json("/metrics") for n in nodes]
    farm2 = _metric(metrics2[3], "engine", "cost", "farm", default={})
    dispatched = farm2.get("dispatches", 0) - out["readme_dispatches"]
    corpus_holes = sum(v == 0 for b in timed for row in b for v in row)
    # one solution each: every answer merges, so every empty cell is
    # dispatched at least once (more with requeues)
    check(dispatched >= corpus_holes,
          f"{dispatched} dispatches for {corpus_holes} empty cells")
    out["dispatches_per_corpus_request"] = dispatched / len(timed)
    out["corpus_requeues"] = dispatched - corpus_holes
    log(f"phase 10 (b): 20 farmed corpus /solve misses on node 3 (host clock): "
        f"p50 {lat[10]:.3f} ms, min {lat[0]:.3f} ms, max {lat[-1]:.3f} ms; "
        f"single-node misses (phases 6/6b): {single_node_p50}; "
        f"{out['dispatches_per_corpus_request']:.1f} dispatches per request")

    # (c) cache gossip: node 1 solves a board, and a node linked to it
    # (node 2 when it is; hot sets ride the stats gossip, which goes to
    # direct links only, as on the JAX node) answers the board's twin
    # from node 1's cache
    status, body, _ = nodes[1].solve(gossip_board)
    check(status == 200 and json.loads(body) == want[json.dumps(gossip_board)],
          "node 1's gossip board")
    # the view maps each dialed node to its dialers: node 1's links are
    # its dialers and the nodes it dialed
    view = nodes[1].json("/network")
    links = set(view.get(nodes[1].id, [])) | {
        k for k, dialers in view.items() if nodes[1].id in dialers}
    fetcher = nodes[2] if nodes[2].id in links else next(
        n for n in nodes if n.id in links)
    out["peer_fetch_node"] = fetcher.k
    time.sleep(2 * GOSSIP_INTERVAL_S + 0.5)  # node 1's next hot-set digest
    twin = random_symmetry(np.asarray(gossip_board), np.random.default_rng(SYMMETRY_SEED))
    c0 = _metric(fetcher.json("/metrics"), "engine", "cost", "cache", default={})
    s0 = _metric(nodes[1].json("/metrics"), "engine", "cost", "cache",
                 "gossip", "peer_serves")
    status, body, headers = fetcher.solve(twin)
    check(status == 200 and headers.get("X-Cache") == "hit",
          f"node {fetcher.k}'s twin was not a peer-fetched hit: {status} "
          f"{dict(headers)}")
    _check_answer(twin, json.loads(body), oracle_ok, "the peer-fetched twin")
    c1 = _metric(fetcher.json("/metrics"), "engine", "cost", "cache", default={})
    s1 = _metric(nodes[1].json("/metrics"), "engine", "cost", "cache",
                 "gossip", "peer_serves")
    out["peer_fetch"] = {k: c1.get(k, 0) - c0.get(k, 0)
                         for k in ("hits", "misses", "peer_fetches", "peer_answers")}
    out["peer_fetch"]["peer_serves"] = s1 - s0
    check(out["peer_fetch"]["peer_fetches"] >= 1
          and out["peer_fetch"]["peer_answers"] >= 1
          and out["peer_fetch"]["hits"] == 1 and s1 > s0,
          f"the twin was not answered through the peer fetch: {out['peer_fetch']}")
    log(f"phase 10 (c): the twin on node {fetcher.k} answered from node 1's "
        f"cache: {out['peer_fetch']}")

    # (d) the cluster view lists every live node, in both spellings
    view = nodes[0].json("/metrics/cluster")
    listed = {view["self"]["id"], *view["peers"]}
    check(listed == ids, f"/metrics/cluster lists {sorted(listed)}")
    r1 = nodes[0].get("/metrics/cluster.prom")
    r2 = nodes[0].get("/metrics/cluster?format=prom")
    check(r1 is not None and r2 is not None and r1[0] == r2[0] == 200
          and b"sudoku_cluster_fleet_nodes" in r1[1],
          "the cluster view's Prometheus spellings")
    out["cluster_fleet"] = view["fleet"]

    # the launch counts of the path: from each process's start (warm-up
    # included) to here, and the farm's share after the warm-up
    end_counts = [n.counts() for n in nodes]
    out["launches"] = {
        k: sum(c[k] for c in end_counts) for k in ("dfs_solver", "dfs_segment")}
    out["launches_farm"] = {
        k: sum(c[k] - w[k] for c, w in zip(end_counts, warm_counts))
        for k in ("dfs_solver", "dfs_segment")}
    out["launches_by_node"] = end_counts
    check(out["launches"]["dfs_solver"] > 0 and out["launches"]["dfs_segment"] > 0,
          f"a kernel of the P2P path was never launched: {out['launches']}")
    ap = [n.json("/metrics").get("autopilot", {}) for n in nodes]
    out["autopilot"] = {
        "hedges": sum(_metric(a, "hedge", "fired") for a in ap),
        "late_dups": sum(_metric(a, "hedge", "late_dups") for a in ap),
        "hedge_tasks_received": sum(_metric(a, "hedge", "tasks_received")
                                    for a in ap),
    }
    log(f"phase 10 (d): /metrics/cluster lists all {len(listed)} nodes; "
        f"launches from start {out['launches']}, in the farm window "
        f"{out['launches_farm']}; autopilot {out['autopilot']}")

    # (e) SIGKILL a worker while a farm is in flight
    victim = nodes[2]
    result = {}

    def farm_crash_board():
        result["r"] = master.solve(crash_board)

    survivors = [n for n in nodes if n is not victim]

    def dropped():
        time.sleep(0.02)
        return all(victim.id not in n.network() for n in survivors)

    def watch_views():
        _wait(dropped, 30.0, "the survivors to drop the killed node")
        result["detect_s"] = time.perf_counter() - t_kill

    th = threading.Thread(target=farm_crash_board)
    th.start()
    time.sleep(0.05)
    victim.proc.kill()
    t_kill = time.perf_counter()
    watcher = threading.Thread(target=watch_views)
    watcher.start()
    th.join(timeout=120)
    check("r" in result, "the farm across the crash never answered")
    out["crash_request_s"] = time.perf_counter() - t_kill
    status, body, _ = result["r"]
    check(status == 200 and json.loads(body) == want[json.dumps(crash_board)],
          f"the farm across the crash answered {status}")
    watcher.join(timeout=60)
    check("detect_s" in result, "the survivors never dropped the killed node")
    out["crash_detect_s"] = result["detect_s"]
    # the killed worker's cell reaches a survivor by a hedge (the autopilot
    # duplicates a cell straggling past the farm's measured p99), by the
    # crash detector's requeue or by the task deadline's, whichever first
    ap = [n.json("/metrics").get("autopilot", {}) for n in survivors]
    out["crash_hedges_total"] = sum(_metric(a, "hedge", "fired") for a in ap)
    log(f"phase 10 (e): SIGKILL of node 2 mid-farm: the request answered "
        f"correctly {out['crash_request_s']:.2f} s after the kill; the survivors "
        f"dropped it {out['crash_detect_s']:.2f} s after the kill (failure "
        f"timeout {P2P_FAILURE_TIMEOUT_S} s + gossip period {GOSSIP_INTERVAL_S} s); "
        f"hedges fired by the survivors so far: {out['crash_hedges_total']}")
    check(out["crash_detect_s"] <= P2P_FAILURE_TIMEOUT_S + GOSSIP_INTERVAL_S,
          f"the crash took {out['crash_detect_s']:.2f} s to detect")

    # (f) a graceful departure prunes at once
    leaver = nodes[1]
    t1 = time.perf_counter()
    leaver.proc.send_signal(signal.SIGINT)
    stay = [n for n in survivors if n is not leaver]
    def departed():
        time.sleep(0.01)
        return all(leaver.id not in n.network() for n in stay)

    _wait(departed, 30.0, "the survivors to drop the departed node")
    out["depart_prune_s"] = time.perf_counter() - t1
    check(out["depart_prune_s"] < P2P_FAILURE_TIMEOUT_S,
          f"the departure took {out['depart_prune_s']:.2f} s to prune: the "
          "crash detector, not its disconnect")
    leaver.proc.wait(timeout=60)
    log(f"phase 10 (f): node 1's graceful departure pruned in "
        f"{out['depart_prune_s']:.3f} s; it exited {leaver.proc.returncode}")
    for n in stay:
        check(n.alive(), f"node {n.k} died")
    return out


# -- phase 11: the frontier race on one card ---------------------------------

RACE_KERNELS = ("dfs_race_kernel",)  # K4 folds in its own launch
# a race across shards: K4's shard form a shard, then one fold launch
MESH_RACE_KERNELS = ("dfs_race_shard_kernel", "race_fold_kernel")
SEED_KERNEL = "seed_frontier_kernel"  # K5: a race's seeding, one launch
# the wrappers whose launch counts phase 13 (b) reads on the mesh node
MESH_PATH_KERNELS = ("dfs_solver", "dfs_segment", "dfs_race", "dfs_race_shards",
                     "race_fold", "seed_frontier_cuda")
FRONTIER_STATES = 64  # --frontier of phase 11's nodes: the engine's default
FRONTIER_BUCKET_BOARDS = 6  # deep boards timed on both routes in phase 11 (d)


def _race_states(F, board, spec, target: int):
    """``seed_frontier`` at ``target`` states, padded to the race's rung as
    ``frontier_solve`` pads; None when seeding alone solves the board."""
    states, early = F.seed_frontier(board, spec, target=target, locked=True)
    if early is not None:
        return None
    return F.bucket_states(states, spec, target).numpy()


def frontier_race_sets(F, spec_for_size, seed: int):
    """(name, board, spec, states, max_iters, target) of the race parity
    phase: four 9x9 deep-corpus boards picked by ``--seed``, seeded at 64
    states as a ``--frontier 64`` node seeds them (104 or 92 states, raced
    as 128); the README board at 512 (1872 states, raced as 2048: at 512
    every deep-corpus board is solved by the seeding BFS itself, so the
    deep corpus gives no race there); the first two 16x16 deep-anneal boards
    whose seeding leaves a race at 64 states; the first 25x25 one at 8 (at
    64 the seeding solves every 25x25 deep board); the README board at
    64, and capped at 8 steps (before its first solve, at 31); an UNSAT
    board; a 4x4 board with one clue at 8 states (12 seeded, raced as 16;
    every 4x4 board with more clues is solved by its seeding)."""
    import numpy as np

    spec9 = spec_for_size(9)
    deep9 = load_corpus("corpus_9x9_deep_128.npz")
    picks = np.random.default_rng(seed).choice(len(deep9), 4, replace=False)
    sets = []
    for k in picks:
        sets.append((f"9x9 deep #{k} @64", deep9[k], spec9,
                     _race_states(F, deep9[k], spec9, 64), 65536, 64))
    readme = np.asarray(README_PUZZLE, np.int32)
    sets.append(("README @512", readme, spec9, _race_states(F, readme, spec9, 512),
                 65536, 512))
    for size, name, target, want in ((16, "corpus_16x16_deep_anneal_64.npz", 64, 2),
                                     (25, "corpus_25x25_deep_anneal_32.npz", 8, 1)):
        spec, found = spec_for_size(size), 0
        for k, b in enumerate(load_corpus(name)):
            states = _race_states(F, b, spec, target)
            if states is not None:
                sets.append((f"{size}x{size} deep #{k} @{target}", b, spec, states,
                             65536, target))
                found += 1
                if found == want:
                    break
        check(found == want, f"no {size}x{size} deep board leaves a race at {target} states")
    readme64 = _race_states(F, readme, spec9, 64)
    sets.append(("README @64", readme, spec9, readme64, 65536, 64))
    unsat = np.zeros((9, 9), np.int32)
    unsat[0, 0] = unsat[0, 1] = 5
    sets.append(("UNSAT @64", unsat, spec9, _race_states(F, unsat, spec9, 64), 65536, 64))
    # its lockstep race solves at step 31: capped at 8, every state is cut
    sets.append(("README @64 capped at 8", readme, spec9, readme64, 8, 64))
    spec4 = spec_for_size(4)
    one_clue = np.zeros((4, 4), np.int32)
    one_clue[0, 0] = 1
    sets.append(("4x4 one clue @8", one_clue, spec4, _race_states(F, one_clue, spec4, 8),
                 65536, 8))
    for name, _, _, states, _, _ in sets:
        check(states is not None, f"{name}: seeding solved the board; nothing to race")
    return sets


def _seeding_answers_at_512(F, spec_for_size, oracle_ok, seed: int):
    """At 512 states the seeding BFS itself solves the deep-corpus boards:
    ``frontier_solve`` answers them with no race (validations 0)."""
    import numpy as np

    deep9 = load_corpus("corpus_9x9_deep_128.npz")
    n0 = F.dfs_race.launches
    for k in np.random.default_rng(seed + 1).choice(len(deep9), 2, replace=False):
        sol, info = F.frontier_solve(deep9[k], "cuda", spec_for_size(9),
                                     states_per_device=512, max_depth=(32, 81),
                                     locked=True, waves=3, naked_pairs=False)
        _check_answer(deep9[k], sol, oracle_ok, f"frontier_solve @512 of deep #{k}")
        log(f"phase 11 (a): deep #{k} at 512 states: {info} (seeding answered)")
    check(F.dfs_race.launches == n0, "a deep board raced at 512 states")


def race_timing_sets(sets):
    """The race sets phase 11 (c) and ``tools/dfs_solver_ab.py`` time: a 9x9
    deep board at 64 (128 states, a ``--frontier 64`` node's own race), the
    README at 512 (2048 states), a 16x16 deep board at 64 (128), the 25x25
    at 8; and a 16x16 race at 1024 states, the 16x16 set's states tiled 8
    times (at 1024 the seeding solves every 16x16 corpus board), for the
    occupancy of a wide race."""
    import numpy as np

    by_name = {s[0]: s for s in sets}
    names = [sets[0][0], "README @512", sets[5][0], sets[7][0]]
    out = [by_name[n] for n in names]
    name, board, spec, states, max_iters, _ = sets[5]
    out.append((f"{name} tiled to 1024", board, spec, np.tile(states, (8, 1, 1)),
                max_iters, 1024))
    return out


def _race_bound_ms(states, fold, cells, locked: bool):
    """The least time for one race: the larger of its bytes (the states in;
    grids, run records, fold and row out) over the HBM rate and its integer
    operations over the int32 rate, counting the sweeps the lockstep race
    needs (the fold's validations: the sweeps this race's data needs; the
    kernel's blocks run past t* and sweep more)."""
    M = states.shape[0]
    per_cell = OPS_PER_CELL_SWEEP + (OPS_PER_CELL_LOCKED if locked else 0)
    words = 2 * M * cells + M * (4 + 2) + cells + 3
    bytes_ms = words * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = int(fold[:, 1].sum()) * cells * per_cell / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def race_trajectory_diffs(kmeta, own, t_star: int) -> tuple:
    """(mismatches, ended): of the states whose K4 run ended (not RUNNING)
    at or before t*, those whose status, steps and validations differ from
    K1's run of the same state to its own end (``own``: K1's meta, status,
    guesses, validations, steps)."""
    ended = (kmeta[:, 0] != 0) & (kmeta[:, 1] <= t_star)
    k, o = kmeta[ended], own[ended]
    bad = (k[:, 0] != o[:, 0]) | (k[:, 1] != o[:, 3]) | (k[:, 2] != o[:, 2])
    return int(bad.sum()), int(ended.sum())


def _race_diffs(a, b) -> tuple:
    """(mismatches, largest difference) of two races' (row, fold)."""
    (arow, afold), (brow, bfold) = a, b
    bad = int((arow != brow).any()) + int((afold != bfold).any(dim=1).sum())
    err = max(int((arow.long() - brow.long()).abs().max()),
              int((afold.long() - bfold.long()).abs().max()))
    return bad, err


RACE_PROFILE_WINDOWS = 3  # capture windows a race profile may take


def race_profile(fn, reps: int, kernel: str = RACE_KERNELS[0]) -> dict:
    """torch.profiler's device records over ``reps`` calls of a race (or of
    another one-kernel call, ``kernel`` naming its kernel): the kernel's
    mean per record, plus every other kernel or memset in the window by
    name (the device sleep that opens the window aside). The
    profiler has lost every race record of a window once (H100, torch
    2.11): a window with fewer than 5 records is captured again, up to
    ``RACE_PROFILE_WINDOWS`` windows, and each loss is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for window in range(RACE_PROFILE_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(5e-3 * SM_CLOCK_HZ))
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        count, total_us, others = 0, 0.0, {}
        for e in prof.key_averages():
            if e.device_time_total <= 0:
                continue
            if kernel in e.key:
                count += e.count
                total_us += e.device_time_total
            elif "spin_kernel" not in e.key:
                others[e.key] = others.get(e.key, 0) + e.count
        if count >= 5:
            break
        log(f"profile: window {window + 1} kept {count} {kernel} records of {reps} calls")
    check(5 <= count <= reps, f"the profiler recorded {count} {kernel} records for {reps} calls")
    return {"ms": total_us / count / 1e3, "records": count, "calls": reps,
            "other_records": others, "windows": window + 1}


def _race_parent(cs, source):
    """The parent's kernel library for phase 11 (c)'s turns, built from
    ``source`` (``--race-parent``) by ``tools/dfs_solver_ab.build_other``;
    None without one."""
    from pathlib import Path

    if source is None:
        return None
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import dfs_solver_ab

    lib, _ = dfs_solver_ab.build_other(cs, Path(source).resolve())
    return lib


def _race_streams(cs, sets, config) -> dict:
    """Two races back to back on one stream (the first posts an early stop,
    the second races far past it, so its result shows the scratch was
    reset), and two races at once on two CUDA streams: each equal to its
    plain race."""
    import torch

    by_name = {s[0]: s for s in sets}
    short, long_ = sets[0], by_name["README @64"]

    def run(entry):
        name, _, spec, states, max_iters, _ = entry
        flat = torch.as_tensor(states.reshape(len(states), -1), device="cuda").contiguous()
        args = (flat, spec, spec.max_depth, max_iters)
        return name, flat, args, sweeps_of(config(spec.size))

    out = {"mismatches": 0}
    runs = [run(short), run(long_)]
    plain = [cs._dfs_race_plain(*args, **sw) for _, _, args, sw in runs]
    t_stars = [int(meta[:, 1].max()) for _, _, meta in plain]
    plain = [p[:2] for p in plain]
    check(t_stars[0] < t_stars[1], f"the first race (t* {t_stars[0]}) does not stop "
                                   f"before the second needs to (t* {t_stars[1]})")
    torch.cuda.synchronize()
    got = [cs.dfs_race(*args, **sw)[:2] for _, _, args, sw in runs]
    torch.cuda.synchronize()
    bad = sum(_race_diffs(g, p)[0] for g, p in zip(got, plain))
    out["back_to_back"] = bad
    log(f"phase 11 (b) back to back on one stream: {runs[0][0]} (t* {t_stars[0]}) "
        f"then {runs[1][0]} (t* {t_stars[1]}): {bad} mismatches")
    check(bad == 0, "back-to-back races disagree with their plain races")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [None, None]
    for k, (st, (_, _, args, sw)) in enumerate(zip(streams, runs[::-1])):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            got[k] = cs.dfs_race(*args, **sw)[:2]
    torch.cuda.synchronize()
    bad = sum(_race_diffs(g, p)[0] for g, p in zip(got, plain[::-1]))
    out["two_streams"] = bad
    out["mismatches"] = out["back_to_back"] + bad
    log(f"phase 11 (b) {runs[1][0]} and {runs[0][0]} at once on two streams: "
        f"{bad} mismatches")
    check(bad == 0, "races on two streams disagree with their plain races")
    return out


def _frontier_parity(cs, F, spec_for_size, config, oracle_ok, seed: int,
                     race_parent, sets):
    """(a)-(c): K4 against its plain version on every set of
    ``frontier_race_sets`` (``sets``), each ended state's
    run against K1's, the early exit, back-to-back races and two streams,
    and the timing (the parent's build in turns, with ``race_parent``).
    Restores the launch counters: none of this is the main path."""
    import numpy as np
    import torch

    counts = (cs.dfs_race.launches, cs.dfs_solver.launches,
              cs.seed_frontier_cuda.launches)
    out = {"mismatches": 0, "max_abs_err": 0, "sets": {}, "timing": {}}
    out["states_per_sm"] = {size: cs.race_states_per_sm(size) for size in (4, 9, 16, 25)}
    lib = cs.load_library()
    out["threads"] = {size: lib.dfs_race_threads(round(size ** 0.5))
                      for size in (4, 9, 16, 25)}
    out["stack_in_slab"] = {size: cs.race_stack_in_slab(lib, round(size ** 0.5))
                            for size in (4, 9, 16, 25)}
    log(f"phase 11: K4 threads a state {out['threads']}, stack in the device slab "
        f"{out['stack_in_slab']}, resident states per SM {out['states_per_sm']}")
    _seeding_answers_at_512(F, spec_for_size, oracle_ok, seed)
    parent = _race_parent(cs, race_parent)
    timing_sets = race_timing_sets(sets)
    timed = {s[0] for s in timing_sets}
    # the timing sets are parity sets too; only the tiled 16x16 one is new
    for name, board, spec, states, max_iters, target in sets + timing_sets[4:]:
        sweeps = sweeps_of(config(spec.size))
        depth = spec.max_depth
        flat = torch.as_tensor(states.reshape(len(states), -1), device="cuda").contiguous()
        krow, kfold, kmeta = cs.dfs_race(flat, spec, depth, max_iters, **sweeps)
        plain = {}
        plain_ms = _cuda_ms(lambda: plain.update(
            r=cs._dfs_race_plain(flat, spec, depth, max_iters, **sweeps)), 1)
        prow, pfold, pmeta = plain["r"]
        _, own = cs.dfs_solver(flat, spec, depth, max_iters, **sweeps)
        torch.cuda.synchronize()
        bad, err = _race_diffs((krow, kfold), (prow, pfold))
        out["mismatches"] += bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        C = spec.cells
        found = int(krow[C])
        if found:
            _check_answer(board, krow[:C].reshape(spec.size, spec.size).tolist(),
                          oracle_ok, f"the race's answer on {name}")
        t_star = int(pmeta[:, 1].max())
        traj_bad, ended = race_trajectory_diffs(kmeta, own, t_star)
        raced, to_end = int(kmeta[:, 1].sum()), int(own[:, 3].sum())
        rec = {"states": len(states), "found": found, "t_star": t_star,
               "validations": int(krow[C + 1]), "undecided": int(krow[C + 2]),
               "k4_steps_all_blocks": raced, "steps_each_to_own_end": to_end,
               "lockstep_steps": int(pmeta[:, 1].sum()), "mismatches": bad,
               "trajectory_mismatches": traj_bad, "ended_by_t_star": ended}
        out["sets"][name] = rec
        log(f"phase 11 (a/b) {name}: {len(states)} states, found {found}, t* "
            f"{t_star}, validations {rec['validations']}, undecided "
            f"{rec['undecided']}; K4's blocks ran {raced} steps in all against "
            f"{to_end} for every state to its own end (lockstep "
            f"{rec['lockstep_steps']}); {bad} mismatches vs the plain race; "
            f"{traj_bad} of the {ended} states ended by t* differ from K1's run")
        check(bad == 0, f"{name}: K4 and the plain race disagree")
        check(traj_bad == 0, f"{name}: an ended state's K4 run differs from K1's")
        if name not in timed:
            continue
        waves = sweeps["waves"]
        knobs = cs.sweep_knobs(spec, **sweeps)

        def this_race():
            cs.dfs_race(flat, spec, depth, max_iters, **sweeps)

        timing = {}
        if parent is not None:
            parent_scratch = torch.tensor(cs.RACE_SCRATCH_IDLE, dtype=torch.int32,
                                          device="cuda")

            def parent_race():
                return cs._launch_race(parent, flat, spec, depth, max_iters, waves,
                                       cs._options(knobs), slab=True,
                                       scratch=parent_scratch)[:2]

            pbad, _ = _race_diffs(parent_race(), (krow, kfold))
            check(pbad == 0, f"{name}: the parent's build disagrees with this one")
            turns = [_cuda_ms(f, 20) for f in (parent_race, this_race, this_race,
                                                parent_race)]
            this_ms = (turns[1] + turns[2]) / 2
            timing.update(parent_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
        else:
            this_ms = _cuda_ms(this_race, 20)
        prof = race_profile(this_race, 10)
        check(not prof["other_records"],
              f"{name}: a race launched more than its kernel: {prof['other_records']}")
        seed_ms = {"cpu": [], "cuda": []}
        for _ in range(3):
            for where, times in seed_ms.items():
                t0 = time.perf_counter()
                F.seed_frontier(board, spec, target=target, locked=True, device=where)
                times.append((time.perf_counter() - t0) * 1e3)
        host_seed_ms, card_seed_ms = (sorted(seed_ms[k])[1] for k in ("cpu", "cuda"))
        k5_ms = _seed_kernel_ms(
            cs, torch.as_tensor(np.asarray(board, np.int32).reshape(1, C), device="cuda"),
            spec, target, True)
        bound, by = _race_bound_ms(flat, pfold, C, sweeps["locked_candidates"])
        sweeps_slowest = int(kmeta[:, 2].max())
        out["timing"][name] = dict(
            timing, ms=this_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            kernel_ms=prof["ms"], profiler_records=prof["records"], t_star=t_star,
            us_per_sweep_slowest=this_ms * 1e3 / max(sweeps_slowest, 1),
            seed_ms=host_seed_ms, card_seed_ms=card_seed_ms, k5_ms=k5_ms,
            states=len(states),
        )
        parent_note = (f"; parent {timing['parent_ms']:.4f} ms (turns "
                       + ", ".join(f"{x:.4f}" for x in timing["turns_ms"]) + ")"
                       if parent is not None else "")
        log(f"phase 11 (c) {name}: K4 {this_ms:.4f} ms a race (CUDA events, mean of "
            f"20{parent_note}); profiler {prof['ms']:.4f} ms in {prof['records']} "
            f"records of {prof['calls']} races, no other kernel or memset; plain "
            f"{plain_ms:.1f} ms; bound {bound:.5f} ms by {by} ({bound / this_ms:.2%}); "
            f"t* {t_star}; {this_ms * 1e3 / max(sweeps_slowest, 1):.3f} us per sweep "
            f"of the slowest state ({sweeps_slowest} sweeps); seeding: host rounds "
            f"{host_seed_ms:.2f} ms, seed_frontier on the card {card_seed_ms:.3f} ms "
            f"(host clock, medians of 3), K5 alone {k5_ms:.4f} ms (CUDA events, "
            f"median of 20)")
    out["streams"] = _race_streams(cs, sets, config)
    out["mismatches"] += out["streams"]["mismatches"]
    cs.dfs_race.launches, cs.dfs_solver.launches, cs.seed_frontier_cuda.launches = counts
    check(any(r["found"] and r["k4_steps_all_blocks"] < r["steps_each_to_own_end"]
              for r in out["sets"].values()),
          "no race stopped its blocks short of their own ends: no early exit")
    return out


def _solve_timed(base, board, oracle_ok, what):
    t0 = time.perf_counter()
    status, body, headers = _http(base, "/solve", json.dumps({"sudoku": board}).encode(),
                                  {"X-Timing": "1"})
    ms = (time.perf_counter() - t0) * 1e3
    check(status == 200, f"{what} answered {status}: {body[:200]!r}")
    _check_answer(board, json.loads(body), oracle_ok, what)
    return ms, json.loads(headers["X-Timing"])


def _frontier_node(cs, build_parser, build_node, oracle_ok):
    """(d): a ``--frontier 64`` node in its default configuration. Counts
    are set to 0 once it is warm and read after its frontier requests."""
    deep = load_corpus("corpus_9x9_deep_128.npz")
    out = {}
    node = _Node(build_parser, build_node, ["--frontier", str(FRONTIER_STATES)])
    eng = node.node.engine
    try:
        check(eng.frontier_enabled and eng.frontier_route == "auto"
              and eng.continuous, "the --frontier node is not the default auto route")
        probe_vals = []
        real_probe = eng._probe_quick

        def probe(arr):
            v0 = eng.validations
            answered = real_probe(arr)
            if answered is None:  # escalated: its sweeps are billed, not answered
                probe_vals.append(eng.validations - v0)
            return answered

        eng._probe_quick = probe
        cs.dfs_race.launches = cs.dfs_solver.launches = cs.dfs_segment.launches = 0
        cs.seed_frontier_cuda.launches = 0
        esc0, races0 = eng.frontier_escalations, eng.cost.snapshot().get(
            "frontier", {}).get("races", 0)
        _solve_timed(node.base, README_PUZZLE, oracle_ok, "README /solve on the frontier node")
        check(eng.frontier_escalations == esc0,
              "the README board escalated instead of staying bucket-quick")
        race_ms, timings = [], []
        boards = [b.tolist() for b in deep[:16]]
        for board in boards:
            ms, timing = _solve_timed(node.base, board, oracle_ok, "deep /solve")
            race_ms.append(ms)
            timings.append(timing)
            check(timing["coalesce_ms"] > 0 and timing["device_ms"] > 0,
                  f"an escalated /solve lacks its seeding or race stamp: {timing}")
        check(eng.frontier_escalations - esc0 == len(boards),
              f"frontier_escalations grew by {eng.frontier_escalations - esc0}, "
              f"not {len(boards)}")
        before = json.loads(_http(node.base, "/stats")[1])["all"]
        n_probe = len(probe_vals)
        more = [b.tolist() for b in deep[16:20]]
        answers = [node.node.peer_sudoku_solve_info(b) for b in more]
        for board, (sol, info) in zip(more, answers):
            _check_answer(board, sol, oracle_ok, "peer_sudoku_solve_info answer")
            check(info.get("frontier") is True, f"a deep board did not race: {info}")
        after = json.loads(_http(node.base, "/stats")[1])["all"]
        summed = sum(info["validations"] for _, info in answers) + sum(probe_vals[n_probe:])
        log(f"phase 11 (d): /stats validations grew by "
            f"{after['validations'] - before['validations']}, the 4 race answers' "
            f"validations and their probes' sum to {summed}; solved grew by "
            f"{after['solved'] - before['solved']}")
        check(after["validations"] - before["validations"] == summed
              and after["solved"] - before["solved"] == len(more),
              "/stats disagrees with the answers")
        out["launches"] = {"dfs_race": cs.dfs_race.launches,
                           "dfs_solver": cs.dfs_solver.launches,
                           "dfs_segment": cs.dfs_segment.launches,
                           "seed_frontier_cuda": cs.seed_frontier_cuda.launches}
        log(f"phase 11 (d): launches on the frontier path (README, 16 deep "
            f"/solve, 4 in process): {out['launches']}")
        check(out["launches"]["dfs_race"] > 0 and out["launches"]["dfs_solver"] > 0
              and out["launches"]["seed_frontier_cuda"] > 0,
              f"the frontier path did not launch K4, K5 and the K1 probe: "
              f"{out['launches']}")
        out["escalations"] = eng.frontier_escalations - esc0
        out["races"] = eng.cost.snapshot()["frontier"]["races"] - races0
        out["race_p50_ms_http"] = _p50_ms(race_ms)
        out["race_max_ms_http"] = max(race_ms)
        out["stage_p50_ms"] = {
            k: _p50_ms([t[k] for t in timings]) for k in ("coalesce_ms", "device_ms",
                                                           "total_ms")}
        # the same node's bucket path on the same boards (frontier=False),
        # beside its race route, in process and in turns
        eng_race, eng_bucket = [], []
        for board in boards[:FRONTIER_BUCKET_BOARDS]:
            for arm, sink in ((None, eng_race), (False, eng_bucket)):
                t0 = time.perf_counter()
                sol, info = eng.solve_one(board, frontier=arm)
                sink.append((time.perf_counter() - t0) * 1e3)
                _check_answer(board, sol, oracle_ok, f"engine.solve_one frontier={arm}")
                check((arm is None) == bool(info.get("frontier")),
                      f"engine.solve_one frontier={arm} took the wrong route: {info}")
        out["engine_race_p50_ms"] = _p50_ms(eng_race)
        out["engine_bucket_p50_ms"] = _p50_ms(eng_bucket)
        log(f"phase 11 (d): 16 deep 9x9 /solve on the --frontier "
            f"{FRONTIER_STATES} node (host clock): p50 {out['race_p50_ms_http']:.3f} ms, "
            f"max {out['race_max_ms_http']:.3f} ms; stage p50s {out['stage_p50_ms']}; "
            f"engine.solve_one on {FRONTIER_BUCKET_BOARDS} of them: race route p50 "
            f"{out['engine_race_p50_ms']:.3f} ms vs the bucket path (frontier=False) "
            f"p50 {out['engine_bucket_p50_ms']:.3f} ms "
            f"({out['engine_bucket_p50_ms'] / out['engine_race_p50_ms']:.2f}x)")
        log(f"phase 11 (d): deep /solve p50 {out['race_p50_ms_http']:.3f} ms, its "
            f"coalesce stage (the seeding, K5 on the card) p50 "
            f"{out['stage_p50_ms']['coalesce_ms']:.3f} ms and device stage p50 "
            f"{out['stage_p50_ms']['device_ms']:.3f} ms; the bucket path's p50 "
            f"{out['engine_bucket_p50_ms']:.3f} ms beside the race route's "
            f"{out['engine_race_p50_ms']:.3f} ms (in turns)")
    finally:
        node.stop()
    # the handoff arm: the probe's K3 segment state seeds the race
    k3 = cs.dfs_segment.launches
    hand = _Node(build_parser, build_node,
                 ["--frontier", str(FRONTIER_STATES), "--frontier-handoff"])
    try:
        k3 = cs.dfs_segment.launches
        ms = [_solve_timed(hand.base, b.tolist(), oracle_ok, "handoff /solve")[0]
              for b in deep[:4]]
        snap = hand.node.engine.cost.snapshot()["frontier"]
        check(snap["escalations"] == 4 and cs.dfs_segment.launches - k3 >= 4,
              f"the handoff arm did not hand 4 probe states to the race: {snap}")
        out["handoff_p50_ms_http"] = _p50_ms(ms)
        log(f"phase 11 (d): --frontier-handoff node: 4 deep /solve answered, "
            f"p50 {out['handoff_p50_ms_http']:.3f} ms; cost.frontier {snap}")
    finally:
        hand.stop()
    # 16x16 and 25x25 deep boards on frontier nodes of those sizes
    for size, name in ((16, "corpus_16x16_deep_anneal_64.npz"),
                       (25, "corpus_25x25_deep_anneal_32.npz")):
        sized = _Node(build_parser, build_node,
                      ["--frontier", str(FRONTIER_STATES), "--board-size", str(size),
                       "--buckets", "1,8,64"])
        try:
            ms = [_solve_timed(sized.base, b.tolist(), oracle_ok,
                               f"{size}x{size} deep /solve")[0]
                  for b in load_corpus(name)[:3]]
            out[f"p50_ms_http_{size}"] = _p50_ms(ms)
            log(f"phase 11 (d): 3 deep {size}x{size} /solve on a --frontier node: "
                f"p50 {_p50_ms(ms):.3f} ms; escalations "
                f"{sized.node.engine.frontier_escalations}")
        finally:
            sized.stop()
    return out


def _seed_kernel_ms(cs, flat, spec, target: int, locked: bool, reps: int = 20) -> float:
    """K5 alone: CUDA events around each of ``reps`` of the wrapper's
    launch steps (``cs._seed_launch``: no header read), after one warm
    launch, all enqueued behind a device spin so the host's enqueue is off
    the clock; the median ms. Restores the launch counter: these launches
    are a measurement, not the main path."""
    import torch

    lib = cs.load_library()
    count0 = cs.seed_frontier_cuda.launches
    events = []
    torch.cuda.synchronize()
    torch.cuda._sleep(int((reps + 1) * 200e-6 * SM_CLOCK_HZ))
    for _ in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        cs._seed_launch(lib, flat, spec, target, spec.cells + 16, locked)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    cs.seed_frontier_cuda.launches = count0
    times = sorted(a.elapsed_time(b) for a, b in events[1:])
    return times[len(times) // 2]


def _seed_bound_ms(states_in: int, count: int, analyzed: int, cells: int,
                   locked: bool, solved: bool = False):
    """The least time for one seeding: the larger of its bytes (the states
    in read once, the seeded states and the header, with the solution row
    where one solved, written once) over the HBM rate and its integer
    operations (a sweep analysis of every state each round analyzed, as
    this seeding's header counts them) over the int32 rate. The chain of
    dependent rounds is a latency floor beside it, not a rate bound
    (``_seed_floor_ms``)."""
    per_cell = OPS_PER_CELL_SWEEP + (OPS_PER_CELL_LOCKED if locked else 0)
    words = (states_in + count) * cells + SEED_HEADER_WORDS + (cells if solved else 0)
    bytes_ms = words * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = analyzed * cells * per_cell / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _seed_floor_ms(rounds: int, us_per_sweep):
    """The round-chain floor of one seeding: its rounds run one after
    another and each sweeps at least one state, so no seeding takes less
    than its rounds times one block sweep of a board that size (K4's
    microseconds per sweep of its slowest state, phase 11 (c)); None where
    (c) timed no race of that size."""
    return None if us_per_sweep is None else rounds * us_per_sweep / 1e3


SEED_DEEP_BOARDS = 16  # 11 (e): boards 0-15 of the deep 9x9 corpus
SEED_HEADER_WORDS = 5  # the seeding kernel's header (cuda_solver.SEED_HEADER_COLS)


def seeding_sets(sets, spec_for_size):
    """(name, states, spec, target, locked) of phase 11 (e): the boards of
    phase 11's race sets at their own targets, locked as the nodes seed;
    boards 0-15 of the deep 9x9 corpus at 64 and 512, locked and not; a
    handoff seeding (the README's K3 probe state after 64 steps, on the
    CPU engine, cut into its unexplored subtrees); the UNSAT root (among
    phase 11's sets); a board that the seeding solves (deep boards at
    512); a 4x4 one-clue board, 16x16 and 25x25 deep boards (phase 11's)."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    out, seen = [], set()
    for name, board, spec, _, _, target in sets:
        key = (np.asarray(board).tobytes(), target)
        if key not in seen:
            seen.add(key)
            out.append((f"{name.split(' @')[0]} @{target}", np.asarray(board)[None], spec,
                        target, True))
    spec9 = spec_for_size(9)
    deep9 = load_corpus("corpus_9x9_deep_128.npz")
    for k in range(SEED_DEEP_BOARDS):
        for target in (64, 512):
            for locked in (True, False):
                out.append((f"9x9 deep #{k} @{target}{'' if locked else ' unlocked'}",
                            deep9[k][None], spec9, target, locked))
    eng = SolverEngine(device="cpu", buckets=(1,), frontier_mesh="auto",
                       frontier_escalate_iters=64)
    try:
        _, pool = eng._quick_state(np.asarray(README_PUZZLE, np.int32))
        seeds = F.state_handoff_frontier(pool.state, spec9)
    finally:
        eng.close()
    out.append((f"README handoff ({len(seeds)} states) @64", seeds, spec9, 64, True))
    return out


def _seeding_parity(cs, F, spec_for_size, oracle_ok, sets, sweep_us) -> dict:
    """(e): the seeding kernel (K5, ``seed_frontier_cuda`` on the card)
    against its plain version (the host rounds) on every set of
    ``seeding_sets``, exactly: the seeded states, their count and the
    solution; ``seed_frontier`` on the card against ``device="cpu"`` and
    ``frontier_solve``'s ``info`` (``seeded``) where the seeding solves.
    Per set: K5 alone (CUDA events, median of 20), the wrapper (host clock,
    median of 5: the launch, the header read and the solution row), the
    plain version (host clock, one run), rounds, states analyzed, the
    bound and the round-chain floor (``sweep_us``: K4's microseconds a
    block sweep by board size, from (c)). Restores the launch counter: none
    of this is the main path."""
    import numpy as np
    import torch

    count0 = cs.seed_frontier_cuda.launches
    lib = cs.load_library()
    out = {"mismatches": 0, "max_abs_err": 0, "sets": {},
           "cluster": {n: lib.seed_frontier_cluster(spec_for_size(n).box)
                       for n in (4, 9, 16, 25)},
           "clusters_resident": {n: lib.seed_clusters[spec_for_size(n).box]
                                 for n in (4, 9, 16, 25)}}
    log(f"phase 11 (e): K5's cluster, blocks by board size {out['cluster']}; clusters the "
        f"card holds at once {out['clusters_resident']}; K4's us a block sweep from (c) "
        f"{sweep_us}")
    outcomes = set()
    for name, states, spec, target, locked in seeding_sets(sets, spec_for_size):
        C, rounds_cap = spec.cells, spec.cells + 16
        cpu = torch.as_tensor(np.ascontiguousarray(states.reshape(len(states), C)))
        t0 = time.perf_counter()
        pstates, psolved, _ = cs._seed_frontier_plain(cpu, spec, target, rounds_cap, locked)
        plain_ms = (time.perf_counter() - t0) * 1e3
        flat = cpu.cuda()
        wrapper_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            kstates, ksolved, header = cs.seed_frontier_cuda(flat, spec, target, rounds_cap,
                                                             locked)
            wrapper_ms.append((time.perf_counter() - t0) * 1e3)
        kstates = kstates.cpu()
        same = kstates.shape == pstates.shape and torch.equal(kstates, pstates)
        err = (int((kstates.long() - pstates.long()).abs().max())
               if kstates.shape == pstates.shape and len(pstates) else 0)
        same = same and (ksolved is None) == (psolved is None) and (
            psolved is None or torch.equal(ksolved, psolved))
        out["mismatches"] += not same
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if psolved is not None:
            _check_answer(states[0] if len(states) == 1 else README_PUZZLE,
                          ksolved.reshape(spec.size, spec.size).tolist(), oracle_ok,
                          f"11 (e) {name}: the seeding's solution")
        check(same, f"11 (e) {name}: K5 and the host rounds disagree ({len(kstates)} vs "
                    f"{len(pstates)} states, solved {ksolved is not None} vs "
                    f"{psolved is not None})")
        ms = _seed_kernel_ms(cs, flat, spec, target, locked)
        bound, by = _seed_bound_ms(len(states), header["count"], header["analyzed"], C,
                                   locked, psolved is not None)
        floor = _seed_floor_ms(header["rounds"], sweep_us.get(spec.size))
        outcomes.add(header["outcome"])
        rec = dict(states_in=len(states), target=target, locked=locked,
                   count=header["count"], outcome=header["outcome"],
                   rounds=header["rounds"], analyzed=header["analyzed"], ms=ms,
                   wrapper_ms=sorted(wrapper_ms)[2], plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, floor_ms=floor,
                   us_per_round=ms * 1e3 / max(header["rounds"], 1))
        out["sets"][name] = rec
        floor_note = ("not measured" if floor is None else
                      f"{floor:.4f} ms ({header['rounds']} rounds x "
                      f"{sweep_us[spec.size]:.3f} us)")
        log(f"phase 11 (e) {name}: K5 {ms:.4f} ms (CUDA events, median of 20; cluster of "
            f"{out['cluster'][spec.size]}), through the wrapper {rec['wrapper_ms']:.3f} ms "
            f"(host clock), the host rounds {plain_ms:.1f} ms; {header['rounds']} rounds, "
            f"{header['analyzed']} states analyzed, {header['count']} seeded "
            f"({header['outcome']}); {rec['us_per_round']:.2f} us a round; rate bound "
            f"{bound:.6f} ms by {by}, round-chain floor {floor_note}; equal")
    check(outcomes == {"target", "solved", "dead"},
          f"11 (e): the sets reached outcomes {sorted(outcomes)}")
    # one kernel record a seeding: the cluster launch and nothing else
    spec9 = spec_for_size(9)
    flat = torch.as_tensor(load_corpus("corpus_9x9_deep_128.npz")[0].reshape(1, -1),
                           device="cuda")
    prof = race_profile(lambda: cs._seed_launch(lib, flat, spec9, FRONTIER_STATES,
                                                spec9.cells + 16, True), 10, SEED_KERNEL)
    check(not prof["other_records"],
          f"11 (e): a seeding launched more than its kernel: {prof['other_records']}")
    out["profile"] = prof
    log(f"phase 11 (e): torch.profiler, 9x9 deep #0 @{FRONTIER_STATES}: {prof['records']} "
        f"{SEED_KERNEL} records of {prof['calls']} seedings, {prof['ms']:.4f} ms a record, "
        f"no other kernel or memset")
    # the entry points: seed_frontier on the card (its default) and
    # frontier_solve's seeded count where the seeding answers
    deep9 = load_corpus("corpus_9x9_deep_128.npz")
    for k, target in ((0, 64), (1, 512)):
        got = F.seed_frontier(deep9[k], spec9, target=target, locked=True)
        want = F.seed_frontier(deep9[k], spec9, target=target, locked=True, device="cpu")
        check(np.array_equal(got[0], want[0]) and (got[1] is None) == (want[1] is None),
              f"11 (e): seed_frontier of deep #{k} @{target} differs on the card")
    kw = dict(states_per_device=512, max_depth=(32, 81), locked=True, waves=3,
              naked_pairs=False)
    card = F.frontier_solve(deep9[1], "cuda", spec9, **kw)
    host = F.frontier_solve(deep9[1], "cpu", spec9, **kw)
    check(card == host and card[1]["validations"] == 0,
          f"11 (e): frontier_solve of deep #1 @512: {card[1]} on the card, {host[1]} "
          f"on the CPU")
    out["frontier_solve_info"] = card[1]
    cs.seed_frontier_cuda.launches = count0
    deep = [r for n, r in out["sets"].items() if n.startswith("9x9 deep #")
            and n.endswith("@64")]
    out["deep64_ms_median"] = sorted(r["ms"] for r in deep)[len(deep) // 2]
    out["deep64_plain_ms_median"] = sorted(r["plain_ms"] for r in deep)[len(deep) // 2]
    log(f"phase 11 (e): {len(out['sets'])} seedings equal to the host rounds; deep 9x9 "
        f"@64 locked: K5 median {out['deep64_ms_median']:.4f} ms against the host "
        f"rounds' {out['deep64_plain_ms_median']:.1f} ms")
    return out


def phase_frontier(cs, build_parser, build_node, spec_for_size, config,
                   oracle_ok, seed: int, race_parent=None):
    """Phase 11: the frontier race on the card (K4 parity, early exit,
    streams, timing; the frontier nodes). ``config(size)``: the knobs a
    node of that size races with (``node_config``). Returns its numbers."""
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    t0 = time.perf_counter()
    sets = frontier_race_sets(F, spec_for_size, seed)
    log(f"phase 11 (a): {len(sets)} race sets seeded in "
        f"{time.perf_counter() - t0:.2f} s (on the card)")
    out = _frontier_parity(cs, F, spec_for_size, config, oracle_ok, seed, race_parent,
                           sets)
    t1 = time.perf_counter()
    out["node"] = _frontier_node(cs, build_parser, build_node, oracle_ok)
    t2 = time.perf_counter()
    sweep_us = {}
    for name, _, spec, *_ in sets:
        timed = out["timing"].get(name)
        if timed is not None and spec.size not in sweep_us:
            sweep_us[spec.size] = timed["us_per_sweep_slowest"]
    out["seeding"] = _seeding_parity(cs, F, spec_for_size, oracle_ok, sets, sweep_us)
    out["seconds"] = {"parity_timing": round(t1 - t0, 1), "nodes": round(t2 - t1, 1),
                      "seeding": round(time.perf_counter() - t2, 1)}
    log(f"phase 11 seconds by part: {out['seconds']}")
    return out


# -- phase 12: the cold-start and durability plane ------------------------------

DURABLE_CHUNK_ITERS = 32   # 12(b): the 4096 hard boards' chunk budget (~10 chunks)
DEEP_CHUNK_ITERS = 256     # 12(b): the deep corpus's chunk budget
DEEP_CUT_ITERS = 512       # 12(b): the deep corpus's first budget: boards still RUNNING
FAULT_ADDRESS = 0x10       # 12(d): the illegal device address one K1 launch reads

# 12(a): an engine in a process of its own, not the CLI: the package root to
# import from (the checkout, or a read-only copy of the package), the
# compile cache dir and the README board on argv, and "fail-once" to make
# the first round-trip verification fail (the engine's check of the
# answer, patched in this process only), so the real rebuild runs: nvcc,
# the loader, every width verified again; prints one JSON line
_ENGINE_CHILD = r"""
import json, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
cs.dfs_solver.launches = cs.dfs_segment.launches = 0
failed = []
if sys.argv[4:] == ["fail-once"]:
    real_ok = SolverEngine._round_trip_ok

    def round_trip_ok(self, status, grid):
        if not failed:
            failed.append(status)
            return False
        return real_ok(self, status, grid)

    SolverEngine._round_trip_ok = round_trip_ok
eng = SolverEngine(compile_cache_dir=sys.argv[2])
eng.warmup()
sol, info = eng.solve_one(json.loads(sys.argv[3]))
warm = eng.warm_info()
print(json.dumps({
    "aot": warm["aot"], "answer": sol, "info": info,
    "sources": {b: v.get("source") for b, v in warm["buckets"].items()},
    "store": str(cs.kernel_store().root), "package": cs.__file__,
    "launches": {"dfs_solver": cs.dfs_solver.launches,
                 "dfs_segment": cs.dfs_segment.launches},
    "failed": failed, "ready": eng.ready(),
    "library": os.path.basename(cs.load_library()._name),
    "kernels": sorted(os.listdir(cs.kernel_store().root)),
    "seconds": time.perf_counter() - t0,
}), flush=True)
eng.close()
"""

# 12(b): a resumable batch of every board of a corpus, SIGKILLed by the
# parent once its first snapshot lands
_RESUMABLE_CHILD = r"""
import sys
import numpy as np
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
with np.load(sys.argv[1]) as d:
    boards = d["boards"].astype(np.int32)
eng = SolverEngine()
print("solving", flush=True)
eng.solve_batch_resumable_np(boards, sys.argv[2], chunk_iters=int(sys.argv[3]))
print("finished", flush=True)
"""

# 12(d): a supervised --no-continuous node (README /solve on K1) whose next
# K1 launch, after a healthy round, reads its boards from an illegal device
# address (the wrapper's inner launch patched in this process only): the
# context's fault is sticky. Boards on argv; prints one JSON line.
_FAULT_CHILD = r"""
import json, os, sys, threading, time, urllib.error, urllib.request
from sudoku_solver_distributed_tpu_torch import engine as engine_mod
from sudoku_solver_distributed_tpu_torch.net import cli
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
boards = json.loads(sys.argv[1])
args = cli.build_parser().parse_args(
    ["-p", "0", "-s", "0", "-h", "0", "--no-answer-cache", "--no-continuous",
     "--supervise-engine", "--metrics", "--buckets", "1,8", "--no-autopilot",
     "--probe-interval-s", "0.2", "--flightrecord-dir", sys.argv[2]])
node, httpd = cli.build_node(args)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
base = f"http://127.0.0.1:{httpd.server_address[1]}"

def get(path, body=None):
    req = urllib.request.Request(base + path, data=body, headers={
        "Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)

def state():
    return json.loads(get("/metrics")[1])["health"]

def solve(board):
    status, body, headers = get("/solve", json.dumps({"sudoku": board}).encode())
    return {"status": status, "answer": json.loads(body),
            "degraded": headers.get("X-Degraded") == "true"}

deadline = time.monotonic() + 120
while not (node.engine.fully_warmed and state()["state"] == "healthy"):
    assert time.monotonic() < deadline, "the node never became healthy"
    time.sleep(0.02)
out = {"healthy": [solve(b) for b in boards], "seen": []}
real_fault = engine_mod.device_fault

def device_fault(exc):
    verdict = real_fault(exc)
    out["seen"].append([type(exc).__name__, str(exc)[:160], verdict])
    return verdict

engine_mod.device_fault = device_fault

class IllegalBoards:
    def __init__(self, lib):
        self.lib = lib
    def dfs_solver_launch(self, boards_ptr, *rest):
        return self.lib.dfs_solver_launch(int(sys.argv[3]), *rest)

real_launch, armed = cs._launch, [True]

def launch(lib, *a, **k):
    if armed[0]:
        armed[0] = False
        lib = IllegalBoards(lib)
    return real_launch(lib, *a, **k)

cs._launch = launch
t0 = time.monotonic()
out["faulted"] = solve(boards[0])
while state()["state"] != "lost" and time.monotonic() - t0 < 30:
    time.sleep(0.02)
out["lost_s"] = time.monotonic() - t0
out["after"] = [solve(b) for b in boards]
time.sleep(1.0)  # probes keep running while LOST
out["after_1s"] = [solve(b) for b in boards]
out["readyz"] = get("/readyz")[0]
out["health"] = {k: v for k, v in state().items() if k != "transitions"}
out["transitions"] = [t.get("to") for t in state()["transitions"]]
print(json.dumps(out), flush=True)
os._exit(0)  # the context is broken: skip CUDA teardown
"""


def _child_json(proc, what: str, timeout_s: float) -> dict:
    """The last stdout line of a child process as JSON, once it exits 0;
    its stderr's tail is in the error otherwise."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise RuntimeError(f"{what} did not finish in {timeout_s} s:\n{err[-3000:]}")
    check(proc.returncode == 0 and out.strip(),
          f"{what} exited {proc.returncode}:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _spawn_engine_child(pkg_root: str, cache: str, env=None, *mode):
    return subprocess.Popen(
        [sys.executable, "-c", _ENGINE_CHILD, pkg_root, cache, json.dumps(README_PUZZLE),
         *mode],
        cwd=pkg_root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def _read_only_package_copy(tmp: str) -> str:
    """The package copied to ``tmp``/pkg without its build directories,
    every file and directory made read-only. Returns the copy's root."""
    import shutil

    root = os.path.join(tmp, "pkg")
    shutil.copytree(
        os.path.join(ROOT, "sudoku_solver_distributed_tpu_torch"),
        os.path.join(root, "sudoku_solver_distributed_tpu_torch"),
        ignore=shutil.ignore_patterns("_build", "__pycache__"),
    )
    for dirpath, dirs, files in os.walk(root):
        for name in files:
            os.chmod(os.path.join(dirpath, name), 0o444)
    for dirpath, dirs, files in os.walk(root, topdown=False):
        os.chmod(dirpath, 0o555)
    return root


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, dirs, files in os.walk(root) for n in dirs + files)


def _compile_plane(oracle_ok) -> dict:
    """Phase 12(a): a cold CLI node on a fresh --compile-cache-dir builds
    and saves the library; a second process loads it without nvcc; a
    truncated stored library is rebuilt by the next engine; an engine run
    from a read-only copy of the package builds into its cache dir."""
    import numpy as np

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cc_")
    cache = os.path.join(tmp, "cache")
    kernels = os.path.join(cache, "kernels")
    readme = json.dumps({"sudoku": README_PUZZLE}).encode()

    def probe(base):
        status, body, _ = _http(base, "/solve", readme)
        warm = json.loads(_http(base, "/metrics")[1])["engine"]["warm"]
        return {"status": status, "answer": json.loads(body), "aot": warm.get("aot"),
                "sources": {b: v.get("source") for b, v in warm["buckets"].items()}}

    try:
        cold = _fresh_process_ready(["--compile-cache-dir", cache], probe=probe)
        libs = sorted(n for n in os.listdir(kernels) if n.endswith(".so"))
        check(len(libs) == 1, f"the cold node stored {libs}")
        lib = os.path.join(kernels, libs[0])
        stamp = (os.stat(lib).st_mtime_ns, os.stat(lib).st_ino)
        warm = _fresh_process_ready(["--compile-cache-dir", cache], probe=probe)
        for name, node, want in (("cold", cold, {"loaded": 0, "saved": 1, "errors": 0}),
                                 ("warm", warm, {"loaded": 1, "saved": 0, "errors": 0})):
            p = node["probe"]
            check(p["aot"] == want, f"the {name} node's engine.warm.aot is {p['aot']}, not {want}")
            check(p["status"] == 200, f"the {name} node answered README /solve {p['status']}")
            _check_answer(README_PUZZLE, p["answer"], oracle_ok, f"{name} README /solve")
        check(warm["probe"]["answer"] == cold["probe"]["answer"],
              "the warm node's README body differs from the cold node's")
        check((os.stat(lib).st_mtime_ns, os.stat(lib).st_ino) == stamp
              and sorted(n for n in os.listdir(kernels) if n.endswith(".so")) == libs,
              "the warm node rewrote the stored library (nvcc ran)")
        check(set(warm["probe"]["sources"].values()) == {"aot"}
              and set(cold["probe"]["sources"].values()) == {"compile+save"},
              f"warm-up sources: cold {cold['probe']['sources']}, warm {warm['probe']['sources']}")
        out["cold"] = {k: cold[k] for k in ("first_503_s", "ready_s", "fully_warmed_s")}
        out["warm"] = {k: warm[k] for k in ("first_503_s", "ready_s", "fully_warmed_s")}
        out["cold"]["aot"], out["warm"]["aot"] = cold["probe"]["aot"], warm["probe"]["aot"]
        out["stored_library_bytes"] = os.path.getsize(lib)
        log(f"phase 12 (a): spawn to /readyz 200 cold {cold['ready_s']:.3f} s "
            f"(nvcc and store: aot {cold['probe']['aot']}), warm {warm['ready_s']:.3f} s "
            f"(aot {warm['probe']['aot']}, library untouched); fully warm "
            f"{cold['fully_warmed_s']:.3f} / {warm['fully_warmed_s']:.3f} s")
        # a truncated stored library, a read-only package with its cache
        # elsewhere, and a good stored library whose first verification
        # fails, each in an engine of its own (in parallel)
        import shutil

        rebuilt_cache = os.path.join(tmp, "rebuilt_cache")
        shutil.copytree(kernels, os.path.join(rebuilt_cache, "kernels"))
        os.truncate(lib, os.path.getsize(lib) // 2)
        ro = _read_only_package_copy(tmp)
        before = _tree(ro)
        ro_cache = os.path.join(tmp, "ro_cache")
        t0 = time.perf_counter()
        procs = {
            "truncated": _spawn_engine_child(ROOT, cache),
            "read_only": _spawn_engine_child(
                ro, ro_cache, env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1")),
            "rebuilt": _spawn_engine_child(ROOT, rebuilt_cache, None, "fail-once"),
        }
        return out, procs, (ro, before, ro_cache, tmp, t0, libs[0])
    except BaseException:
        _rmtree_writable(tmp)
        raise


def _rmtree_writable(path: str) -> None:
    import shutil

    for dirpath, dirs, files in os.walk(path):
        os.chmod(dirpath, 0o755)
    shutil.rmtree(path, ignore_errors=True)


def _compile_plane_finish(out, procs, ctx, oracle_ok) -> dict:
    ro, before, ro_cache, tmp, t0, stored = ctx
    try:
        res = {name: _child_json(p, f"the {name} engine", 300) for name, p in procs.items()}
        out["children_s"] = time.perf_counter() - t0
        want = {"truncated": {"loaded": 0, "saved": 1, "errors": 1},
                "read_only": {"loaded": 0, "saved": 1, "errors": 0},
                "rebuilt": {"loaded": 1, "saved": 1, "errors": 1}}
        for name, r in res.items():
            check(r["aot"] == want[name], f"the {name} engine's aot is {r['aot']}, not {want[name]}")
            check(r["ready"], f"the {name} engine is not ready")
            _check_answer(README_PUZZLE, r["answer"], oracle_ok, f"{name} engine README")
            out[name] = {k: r[k] for k in ("aot", "seconds", "launches", "sources")}
        check(res["truncated"]["answer"] == res["read_only"]["answer"]
              == res["rebuilt"]["answer"], "the engines' README answers differ")
        # the forced failure: one rebuild by nvcc, loaded as a new image (a
        # private copy when nvcc gave the stored build's bytes, hence its
        # name), and no copy left in the store
        rb = res["rebuilt"]
        libs = [n for n in rb["kernels"] if n.endswith(".so")]
        same_bytes = libs == [stored]
        private = rb["library"] not in libs and rb["library"].startswith(".")
        check(rb["failed"] == [1] and len(libs) == 1 and len(rb["kernels"]) == 2
              and same_bytes == private,
              f"the rebuilt engine: failed {rb['failed']}, library {rb['library']}, "
              f"store {rb['kernels']}, stored {stored}")
        out["rebuilt"].update(same_bytes=same_bytes, library=rb["library"])
        check(res["read_only"]["package"].startswith(ro)
              and res["read_only"]["store"] == os.path.join(ro_cache, "kernels"),
              f"the read-only engine ran {res['read_only']['package']} on "
              f"{res['read_only']['store']}")
        check(_tree(ro) == before, "the read-only package copy was written to")
        log(f"phase 12 (a): a forced verification failure: rebuilt by nvcc "
            f"({'the same bytes, loaded from a private copy' if same_bytes else 'new bytes'}), "
            f"every width verified again and served (aot {rb['aot']}, {rb['seconds']:.2f} s)")
        log(f"phase 12 (a): truncated library: counted, rebuilt, verified and served "
            f"(aot {res['truncated']['aot']}, {res['truncated']['seconds']:.2f} s); "
            f"read-only package with its cache elsewhere: built and served "
            f"(aot {res['read_only']['aot']}, {res['read_only']['seconds']:.2f} s)")
        return out
    finally:
        _rmtree_writable(tmp)


def _timed_chunks(ck):
    """Wrap utils/checkpoint's segment launch and snapshot write: CUDA
    events around every chunk's K3 + K3b launch, host time and bytes of
    every snapshot. Returns (record, restore)."""
    import torch

    rec = {"events": [], "snap_ms": [], "snap_bytes": []}
    seg, save = ck.dfs_segment, ck.save_solver_state

    def timed_segment(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = seg(*a, **k)
        end.record()
        rec["events"].append((start, end))
        return res

    def timed_save(path, *a, **k):
        t = time.perf_counter()
        save(path, *a, **k)
        rec["snap_ms"].append((time.perf_counter() - t) * 1e3)
        rec["snap_bytes"].append(os.path.getsize(path))

    ck.dfs_segment, ck.save_solver_state = timed_segment, timed_save

    def restore():
        ck.dfs_segment, ck.save_solver_state = seg, save

    return rec, restore


def _chunk_summary(rec) -> dict:
    import torch

    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in rec["events"]]
    out = {"chunks": len(ms), "k3_ms_per_chunk": _ms_summary(ms) if ms else None,
           "snapshots": len(rec["snap_ms"])}
    if rec["snap_ms"]:
        out["snapshot_ms"] = _ms_summary(rec["snap_ms"])
        out["snapshot_bytes"] = max(rec["snap_bytes"])
    return out


def _rows_equal(a, b, what: str) -> None:
    import torch

    for f in ("grid", "solved", "status", "guesses", "validations"):
        x, y = getattr(a, f), getattr(b, f)
        check(torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()),
              f"{what}: {f} differs")
    check(int(a.iters) == int(b.iters), f"{what}: iters {int(a.iters)} != {int(b.iters)}")


def _resumable(cs, ts, SolverEngine, spec_for_size, serving_config, oracle_ok) -> dict:
    """Phase 12(b): the 4096 hard boards killed mid-batch and resumed, the
    deep corpus cut at a budget and resumed, 16x16 [:256] once."""
    import numpy as np
    import torch

    from sudoku_solver_distributed_tpu_torch.utils import checkpoint as ck

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    corpus_path = os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz")
    boards = load_corpus("corpus_9x9_hard_4096.npz")
    spec = spec_for_size(9)
    cfg = serving_config(9)
    knobs = dict(locked=cfg["locked_candidates"], waves=cfg["waves"],
                 naked_pairs=cfg["naked_pairs"], max_depth=max(cfg["max_depth"]))
    try:
        # the child: killed as soon as its first snapshot lands
        killed = os.path.join(tmp, "killed.npz")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", _RESUMABLE_CHILD, corpus_path, killed,
             str(DURABLE_CHUNK_ITERS)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            while not os.path.exists(killed):
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"the resumable child exited ({proc.returncode}) before "
                        f"its first snapshot: {proc.communicate()[1][-2000:]}")
                check(time.perf_counter() - t0 < 180, "no snapshot within 180 s")
                time.sleep(0.002)
            proc.send_signal(signal.SIGKILL)
        finally:
            proc.wait()
        check(proc.returncode == -signal.SIGKILL,
              f"the resumable child was not killed mid-batch (exit {proc.returncode})")
        snap_iters = int(np.load(killed)["iters"])
        out["killed_after_s"] = time.perf_counter() - t0
        cs.dfs_segment.launches = 0
        cs.dfs_solver.launches = 0
        rec, restore = _timed_chunks(ck)
        try:
            t = time.perf_counter()
            resumed = ck.solve_batch_resumable(
                boards, spec, checkpoint_path=killed,
                chunk_iters=DURABLE_CHUNK_ITERS, **knobs)
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t
            resumed_rec = _chunk_summary(rec)
            rec["events"].clear(), rec["snap_ms"].clear(), rec["snap_bytes"].clear()
            t = time.perf_counter()
            whole = ck.solve_batch_resumable(
                boards, spec, checkpoint_path=os.path.join(tmp, "whole.npz"),
                chunk_iters=DURABLE_CHUNK_ITERS, **knobs)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t
            whole_rec = _chunk_summary(rec)
            rec["events"].clear(), rec["snap_ms"].clear(), rec["snap_bytes"].clear()
            # the deep corpus: cut at a budget with boards RUNNING, resumed
            deep = load_corpus("corpus_9x9_deep_128.npz")
            deep_path = os.path.join(tmp, "deep.npz")
            cut = ck.solve_batch_resumable(
                deep, spec, checkpoint_path=deep_path, chunk_iters=DEEP_CHUNK_ITERS,
                max_iters=DEEP_CUT_ITERS, **knobs)
            check(os.path.exists(deep_path) and int(cut.iters) == DEEP_CUT_ITERS
                  and bool((cut.status == ts.RUNNING).any()),
                  "the deep corpus's cut run left no RUNNING boards or no snapshot")
            deep_resumed = ck.solve_batch_resumable(
                deep, spec, checkpoint_path=deep_path, chunk_iters=DEEP_CHUNK_ITERS, **knobs)
            deep_whole = ck.solve_batch_resumable(
                deep, spec, checkpoint_path=os.path.join(tmp, "deep_whole.npz"),
                chunk_iters=DEEP_CHUNK_ITERS, **knobs)
            deep_rec = _chunk_summary(rec)
            rec["events"].clear(), rec["snap_ms"].clear(), rec["snap_bytes"].clear()
            # 16x16 [:256] once, in its serving configuration
            b16 = load_corpus("corpus_16x16_hard_2048.npz")[:256]
            spec16, cfg16 = spec_for_size(16), serving_config(16)
            knobs16 = dict(locked=cfg16["locked_candidates"], waves=cfg16["waves"],
                           naked_pairs=cfg16["naked_pairs"], max_depth=max(cfg16["max_depth"]))
            r16 = ck.solve_batch_resumable(
                b16, spec16, checkpoint_path=os.path.join(tmp, "b16.npz"),
                chunk_iters=16, **knobs16)
            r16_rec = _chunk_summary(rec)
        finally:
            restore()
        out["launches"] = {"dfs_segment": cs.dfs_segment.launches,
                           "dfs_solver": cs.dfs_solver.launches}
        check(cs.dfs_segment.launches == (
            resumed_rec["chunks"] + whole_rec["chunks"] + deep_rec["chunks"]
            + r16_rec["chunks"]), "a resumable chunk did not launch the segment kernels")
        # every row against the uninterrupted run and the plain version
        _rows_equal(resumed, whole, "4096 resumed vs uninterrupted")
        plain = ts.solve_batch(torch.as_tensor(boards, device="cuda"), spec,
                               max_iters=65536, max_depth=knobs["max_depth"],
                               locked_candidates=knobs["locked"], waves=knobs["waves"],
                               naked_pairs=knobs["naked_pairs"])
        _rows_equal(whole, plain, "4096 resumable vs the plain version")
        grids = whole.grid.cpu().numpy()
        solved = whole.solved.cpu().numpy()
        check(solved.all(), "a hard board was not solved")
        for k in np.flatnonzero(solved):
            _check_answer(boards[k], grids[k].tolist(), oracle_ok, "resumable 4096")
        _rows_equal(deep_resumed, deep_whole, "deep cut and resumed vs uncut")
        check(bool(deep_whole.solved.all()), "a deep board was not solved")
        k16 = cs.solve_batch_cuda(torch.as_tensor(b16, device="cuda"), spec16,
                                  max_depth=knobs16["max_depth"], max_iters=65536,
                                  locked_candidates=knobs16["locked"],
                                  waves=knobs16["waves"], naked_pairs=knobs16["naked_pairs"])
        _rows_equal(r16, k16, "16x16 resumable vs one flat K1 launch")
        for b, g in zip(b16, r16.grid.cpu().numpy()):
            _check_answer(b, g.tolist(), oracle_ok, "resumable 16x16")
        # the whole batch's wall time beside solve_batch_np on a warm engine
        eng = SolverEngine()
        try:
            eng.warmup()
            t = time.perf_counter()
            _, mask, _ = eng.solve_batch_np(boards)
            batch_np_s = time.perf_counter() - t
        finally:
            eng.close()
        check(mask.all(), "solve_batch_np left a hard board unsolved")
        out.update(
            snapshot_iters_at_kill=snap_iters, iters=int(whole.iters),
            resumed=dict(resumed_rec, wall_s=resumed_s),
            uninterrupted=dict(whole_rec, wall_s=whole_s),
            solve_batch_np_s=batch_np_s,
            deep=dict(deep_rec, cut_iters=DEEP_CUT_ITERS, iters=int(deep_whole.iters)),
            b16=dict(r16_rec, iters=int(r16.iters)),
        )
        log(f"phase 12 (b): 4096 hard boards, chunk {DURABLE_CHUNK_ITERS}: child killed "
            f"at its first snapshot (iters {snap_iters}); resumed to the uninterrupted "
            f"run's and the plain version's rows (iters {int(whole.iters)}); "
            f"uninterrupted: {whole_rec['chunks']} chunks, K3 ms/chunk "
            f"{whole_rec['k3_ms_per_chunk']}, snapshot {whole_rec.get('snapshot_bytes')} B "
            f"in {whole_rec.get('snapshot_ms')} ms, wall {whole_s:.3f} s beside "
            f"solve_batch_np {batch_np_s:.3f} s; deep: {deep_rec['chunks']} chunks, "
            f"cut at {DEEP_CUT_ITERS} and resumed = uncut; 16x16 [:256]: "
            f"{r16_rec['chunks']} chunks = one K1 launch")
        return out
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def _generator(cs, spec_for_size, serving_config, oracle_ok, count_solutions) -> dict:
    """Phase 12(c): 64 unique 9x9 boards and 4 unique 16x16 boards from the
    generator, with the native oracle built on this host; each solved by
    K1, valid, with one solution."""
    import numpy as np
    import torch

    from sudoku_solver_distributed_tpu_torch import native
    from sudoku_solver_distributed_tpu_torch.models import generate_batch

    check(native.available(), "no C++ compiler: the native oracle did not build")
    out = {"native_store": str(native.native_store().root)}
    cs.dfs_solver.launches = 0
    cs.dfs_segment.launches = 0
    for size, count, holes in ((9, 64, 55), (16, 4, 120)):
        t = time.perf_counter()
        boards = generate_batch(count, holes, size=size, seed=SYMMETRY_SEED, unique=True)
        gen_ms = (time.perf_counter() - t) * 1e3 / count
        spec = spec_for_size(size)
        cfg = serving_config(size)
        res = cs.solve_batch_cuda(torch.as_tensor(boards, device="cuda"), spec, **cfg)
        check(bool(res.solved.all()), f"K1 left a generated {size}x{size} board unsolved")
        for b, g in zip(boards, res.grid.cpu().numpy()):
            _check_answer(b, g.tolist(), oracle_ok, f"generated {size}x{size}")
            check(count_solutions(b.tolist(), limit=2) == 1,
                  f"a generated {size}x{size} board has more than one solution")
        out[f"{size}x{size}"] = {"boards": count, "holes_asked": holes,
                                 "holes_mean": float((boards == 0).sum((1, 2)).mean()),
                                 "ms_per_board": gen_ms}
    out["launches"] = {"dfs_solver": cs.dfs_solver.launches,
                       "dfs_segment": cs.dfs_segment.launches}
    log(f"phase 12 (c): generated and solved by K1: {out}")
    return out


def _sticky_fault(proc, boards) -> dict:
    """Phase 12(d): the sticky-fault child's record, checked: the faulted
    request answered correctly from the oracle as a device fault, the node
    went LOST, stayed so, and served no wrong answer."""
    from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution

    out = _child_json(proc, "the sticky-fault node", 180)
    for k, r in enumerate(out["healthy"]):
        check(r["status"] == 200 and not r["degraded"], f"healthy answer {k}: {r}")
    f = out["faulted"]
    check(f["status"] == 200 and f["degraded"],
          f"the faulted request was not answered from the fallback: {f}")
    check(any(v for _, _, v in out["seen"]),
          f"no exception of the faulted call counted as a device fault: {out['seen']}")
    for key in ("faulted", "after", "after_1s"):
        answers = [out[key]] if key == "faulted" else out[key]
        for b, r in zip(boards, answers):
            check(r["status"] == 200 and r["degraded"], f"{key}: {r}")
            _check_answer(b, r["answer"], oracle_is_valid_solution, f"sticky fault {key}")
    check(out["health"]["state"] == "lost" and out["readyz"] == 503,
          f"the node is {out['health']['state']} (readyz {out['readyz']}) after a sticky fault")
    log(f"phase 12 (d): a K1 launch handed address {FAULT_ADDRESS:#x}: "
        f"{out['seen'][0][:2]} counted as a device fault; LOST after "
        f"{out['lost_s']:.3f} s; transitions {out['transitions']}; "
        f"failures {out['health']['failures']}, probes {out['health']['probes']} "
        f"({out['health']['probe_failures']} failed), rebuilds {out['health']['rebuilds']}; "
        f"every answer from the oracle, correct")
    return {k: out[k] for k in ("seen", "lost_s", "readyz", "health", "transitions")}


def phase_durability(cs, ts, SolverEngine, spec_for_size, serving_config, oracle_ok,
                     count_solutions) -> dict:
    """Phase 12: (a) the compile plane, (b) resumable batches, (c) the
    generator, (d) a sticky CUDA fault under supervision. (a)'s two engine
    children and (d)'s node run in parallel with each other."""
    seconds = {}
    t = time.perf_counter()
    out = {}
    compile_out, procs, ctx = _compile_plane(oracle_ok)
    corpus = load_corpus("corpus_9x9_hard_4096.npz")
    fault_boards = [README_PUZZLE] + [b.tolist() for b in corpus[40:43]]
    flight = tempfile.TemporaryDirectory(prefix="chip_smoke_fr_")
    fault = subprocess.Popen(
        [sys.executable, "-c", _FAULT_CHILD, json.dumps(fault_boards), flight.name,
         str(FAULT_ADDRESS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out["compile_plane"] = _compile_plane_finish(compile_out, procs, ctx, oracle_ok)
        seconds["a"] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
        out["sticky_fault"] = _sticky_fault(fault, fault_boards)
        seconds["d"] = round(time.perf_counter() - t, 1)
    finally:
        for proc in (*procs.values(), fault):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        flight.cleanup()
    t = time.perf_counter()
    out["resumable"] = _resumable(cs, ts, SolverEngine, spec_for_size, serving_config, oracle_ok)
    seconds["b"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    out["generator"] = _generator(cs, spec_for_size, serving_config, oracle_ok, count_solutions)
    seconds["c"] = round(time.perf_counter() - t, 1)
    out["seconds"] = seconds
    log(f"phase 12 seconds by part: {seconds}")
    return out


# -- phase 13: the mesh plane ----------------------------------------------------

MESH_SHARDS = 4        # the virtual mesh's shards on cuda:0
MESH_FRONTIER = 16     # 13(b): the node's --frontier (states a shard)
MESH_DEEP_BOARDS = 2   # 13(b): deep boards on each route
MESH_RESUMABLE_BOARDS = 1024  # 13(e): hard boards in the killed batch


def _mesh(where: str = "cuda:0"):
    from sudoku_solver_distributed_tpu_torch.parallel.mesh import virtual_mesh

    return virtual_mesh(where, MESH_SHARDS)


def _mesh_engine(cs, SolverEngine, oracle_ok) -> dict:
    """13(a): a 4-shard virtual-mesh engine against the one-device engine
    on the 4096 hard boards (one bucket call each: rows equal, 4 K1
    launches), and the lone README board in its mesh-rounded bucket of 4
    against the plain version of the same 4-shard program."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.parallel.shard import (
        make_packed_serving_program,
    )

    boards = load_corpus("corpus_9x9_hard_4096.npz")
    ladder = (1, 8, 64, 512, 4096)
    em = SolverEngine(mesh=_mesh(), buckets=ladder, coalesce=False)
    es = SolverEngine(buckets=ladder, coalesce=False)
    out = {}
    try:
        check(em.buckets == (4, 8, 64, 512, 4096), f"mesh ladder {em.buckets}")
        em.warmup()
        es.warmup()
        C = em.spec.cells
        n0 = cs.dfs_solver.launches
        t0 = time.perf_counter()
        rm = em._solve_padded(boards)
        mesh_s = time.perf_counter() - t0
        k1 = cs.dfs_solver.launches - n0
        t0 = time.perf_counter()
        rs = es._solve_padded(boards)
        one_s = time.perf_counter() - t0
        bad = int((rm[:, :C + 4] != rs[:, :C + 4]).any(axis=1).sum())
        check(bad == 0, f"13(a): {bad} of 4096 mesh rows differ from one device's")
        check(k1 == MESH_SHARDS, f"13(a): a 4096 bucket call launched K1 {k1} times")
        mi = em.mesh_info()
        check(mi["devices"] == MESH_SHARDS
              and mi["last_split"] == {"devices": MESH_SHARDS, "rows_per_device": 1024},
              f"13(a): engine.mesh {mi}")
        readme = np.asarray(README_PUZZLE, np.int32)
        r1 = em._solve_padded(readme[None])
        plain = make_packed_serving_program(
            _mesh("cpu"), em.spec, max_depth=em.max_depth,
            locked_candidates=em.locked_candidates, waves=em.waves,
            naked_pairs=em.naked_pairs,
        )(np.broadcast_to(readme, (MESH_SHARDS, 9, 9)), em.max_iters)
        check(np.array_equal(r1[0, :C + 4], plain[0, :C + 4]),
              "13(a): the README row differs from the plain 4-shard program's")
        r1s = es._solve_padded(readme[None])
        check(np.array_equal(r1[0, :C], r1s[0, :C]) and oracle_ok(
            r1[0, :C].reshape(9, 9).tolist()), "13(a): the README grid differs")
        out = {
            "rows_equal": 4096 - bad, "k1_launches_a_bucket_call": k1,
            "mesh_call_ms": round(mesh_s * 1e3, 3), "one_device_call_ms": round(one_s * 1e3, 3),
            "readme_validations_mesh": int(r1[0, C + 3]),
            "readme_validations_one_device": int(r1s[0, C + 3]),
            "lane_steps_mesh": int(rm[0, C + 4]), "idle_lane_steps_mesh": int(rm[0, C + 5]),
            "engine_mesh": {k: mi[k] for k in ("devices", "buckets", "last_split",
                                                "min_devices_seen", "dispatches")},
        }
        log(f"phase 13 (a): 4096 hard boards, 4-shard virtual mesh vs one device: rows "
            f"equal, {k1} K1 launches, {out['mesh_call_ms']} vs {out['one_device_call_ms']} "
            f"ms (host clock, one call each); README in the bucket of 4: "
            f"{out['readme_validations_mesh']} validations (the plain 4-shard program's) "
            f"vs {out['readme_validations_one_device']} at width 1 on one device")
    finally:
        em.close()
        es.close()
    return out


def _mesh_node(cs, build_parser, build_node, SolverEngine, oracle_ok) -> dict:
    """13(b): a CLI node on the 4-shard virtual mesh (SUDOKU_VIRTUAL_MESH
    from parallel/sim.py's environment) with --mesh-peers 4 --frontier 16.
    The references (the plain 4-shard engine on the CPU, the one-device
    engine on this card) answer first; the counts are then set to 0 and
    read after the node's requests: the mesh path's launches alone."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.parallel import sim

    key = sim.VIRTUAL_MESH_ENV
    saved = os.environ.get(key)
    os.environ[key] = sim.virtual_mesh_env(MESH_SHARDS, device="cuda:0")[key]
    try:
        node = _Node(build_parser, build_node,
                     ["--mesh-peers", str(MESH_SHARDS), "--frontier", str(MESH_FRONTIER),
                      "--metrics", "--no-answer-cache", "--batch-api"])
    finally:
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved
    eng = node.node.engine
    deep = load_corpus("corpus_9x9_deep_128.npz")[:MESH_DEEP_BOARDS]
    plain = SolverEngine(device="cpu", mesh=_mesh("cpu"), frontier_mesh="auto",
                         frontier_states_per_device=MESH_FRONTIER, coalesce=False)
    single = SolverEngine(coalesce=False)
    out = {}
    try:
        check(eng.mesh is not None and eng.mesh.size == MESH_SHARDS
              and eng.race_mesh is eng.mesh, "13(b): the node is not on the 4-shard mesh")
        # the README /solve: the auto route's probe answers it, one K1 call
        # at the mesh-rounded width 4 (the serving waves), as the plain
        # 4-shard engine's probe does
        p0 = plain.validations
        plain.solve_one(README_PUZZLE)
        out["readme_probe_validations"] = plain.validations - p0
        want = []
        for board in deep:
            p0 = plain.validations
            _, pinfo = plain.solve_one(board.tolist())
            ssol, _ = single.solve_one(board.tolist(), frontier=False)
            want.append((plain.validations - p0, pinfo, ssol))
        batch_sols, _, batch_info = single.solve_batch_np(deep)
        for k in MESH_PATH_KERNELS:
            getattr(cs, k).launches = 0
        out["readme_p50_ms"] = node.readme_p50(
            "13(b) 4-shard virtual-mesh node", oracle_ok,
            per_answer=out["readme_probe_validations"])
        # the bucket path's own README: the continuous pool over the mesh
        # (K3 + K3b a shard), the serving waves at every width: 109 each
        for _ in range(4):
            sol, info = eng.solve_one(README_PUZZLE, frontier=False)
            _check_answer(README_PUZZLE, sol, oracle_ok, "13(b) README on the mesh pool")
            check(info["validations"] == 109 and info["routed"] == "continuous",
                  f"13(b): the README on the mesh pool: {info}")
        races, ok = [], 0
        for k, board in enumerate(deep):
            v0 = node.validations()
            status, body, _ = _http(node.base, "/solve",
                                    json.dumps({"sudoku": board.tolist()}).encode())
            grew = node.validations() - v0
            sol = json.loads(body)
            _check_answer(board, sol, oracle_ok, f"13(b) deep #{k} /solve")
            pvalid, pinfo, ssol = want[k]
            check(sol == ssol, f"13(b): deep #{k}'s grid differs from one device's")
            check(grew == pvalid and pinfo.get("frontier") is True,
                  f"13(b): deep #{k} /solve counted {grew} validations, the plain "
                  f"4-shard mesh {pvalid} ({pinfo})")
            races.append({"validations": grew, "seeded": pinfo.get("seeded")})
        v0 = node.validations()
        status, body, _ = _http(node.base, "/solve_batch",
                                json.dumps({"sudokus": deep.tolist()}).encode())
        check(status == 200, f"13(b): /solve_batch answered {status}")
        grew = node.validations() - v0
        got = json.loads(body)["solutions"]
        check(got == batch_sols.tolist() and grew == batch_info["validations"],
              f"13(b): the bucket route's deep answers or counters differ ({grew} vs "
              f"{batch_info['validations']})")
        metrics = json.loads(_http(node.base, "/metrics")[1])
        mesh_block = metrics["engine"]["mesh"]
        check(mesh_block["devices"] == MESH_SHARDS
              and mesh_block["buckets"] == [4, 8, 64, 512, 4096]
              and mesh_block["runner_dispatches"] == 0, f"13(b): engine.mesh {mesh_block}")
        network = json.loads(_http(node.base, "/network")[1])
        me = node.node.id
        check([p for p in network.get(me, []) if "/tpu" in p]
              == [f"{me}/tpu{k}" for k in range(MESH_SHARDS)],
              f"13(b): /network {network}")
        out["launches"] = {k: getattr(cs, k).launches for k in MESH_PATH_KERNELS}
        # a race across the 4 shards runs K4's shard form, never the
        # one-shard K4 (dfs_race, counted here all the same), and its last
        # block folds: no fold kernel on this path (the multi-host one's, 13(d))
        check(all(v > 0 for k, v in out["launches"].items()
                  if k not in ("dfs_race", "race_fold"))
              and out["launches"]["race_fold"] == 0,
              f"13(b): the mesh path's launches {out['launches']}")
        out.update(deep_race=races, batch_validations=grew, engine_mesh=mesh_block)
        log(f"phase 13 (b): mesh node: README p50 {out['readme_p50_ms']:.3f} ms at 109 "
            f"validations each; deep /solve raced across {MESH_SHARDS} shards "
            f"{races} (the plain 4-shard mesh's counters, one device's grids); "
            f"/solve_batch of {len(deep)} deep boards on the mesh bucket path: "
            f"{grew} validations; launches {out['launches']}; /network pseudo-peers ok")
    finally:
        node.stop()
        plain.close()
        single.close()
    return out


def _event_ms(fn, reps: int, spin_s: float = 2e-3, after=None) -> list:
    """Device time of each of ``reps`` calls of ``fn``, by CUDA events on
    the current stream around it, each call enqueued behind a device spin
    of ``spin_s`` so the host's enqueue is off the clock; ``after`` runs
    once each call has finished, off the clock."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_s * SM_CLOCK_HZ))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if after is not None:
            after()
        times.append(start.elapsed_time(end))
    return times


def _fold_bound_ms(M: int, cells: int):
    """The fold's least time: its bytes (each record read, each state's
    fold and the row written, the winner's grid read) over the HBM rate; a
    few integer operations a record is far below that."""
    words = M * 4 + M * 2 + cells + 3 + cells
    return words * 4 / HBM_BYTES_PER_S * 1e3, "bytes"


# 13(c): a shard's blocks stop this close to t*, or within a step of where
# one-shard K4's blocks stop on the same states: on a race of two waves of
# blocks, or of 16x16 states (a step of one sweep), K4's blocks run 2 or 3
# past t* from one race to the next (5 races of each set), and the shards'
# blocks, one grid on the card as K4's are, 2 or 3 as well
MESH_MAX_STEPS_PAST_T_STAR = 2


def _forced_layout_slots(cs, mesh, layout: str):
    """A race's stop over the shards of a virtual mesh, whose devices would
    choose ``"device"``, laid out as ``layout`` instead: ``"host"`` (mapped
    host slots relayed into each shard's own words: cards without peer
    access) or ``"peer"`` (a word set a shard, a launch a shard, solves
    posted to every shard's words with system atomics: cards with peer
    access). How a race across cards stops, run on one card."""
    import ctypes
    import threading

    import torch

    address = host = 0
    if layout == "host":
        out, hp = ctypes.c_void_p(), ctypes.c_void_p()
        err = cs.load_library().dfs_race_slots_alloc(mesh.size, ctypes.byref(out),
                                                      ctypes.byref(hp))
        check(err == 0, f"13(c): dfs_race_slots_alloc failed: cudaError {err}")
        address, host = int(out.value), int(hp.value)
    words = tuple(torch.tensor(cs.RACE_SCRATCH_IDLE, dtype=torch.int32, device=d)
                  for d in mesh.devices)
    torch.cuda.synchronize()
    return cs.RaceSlots(layout, words, threading.Lock(), address, host)


def _forced_layout_race(cs, mesh, slots, spec, states, max_iters, sweeps, plain,
                        t_star: int) -> dict:
    """13(c): two races back to back over ``slots`` (``_forced_layout_slots``)
    as ``race_on_mesh`` runs a race across cards, each against the plain
    race ``plain`` (row, fold), with every shard's words (and under
    ``"host"`` every slot) idle after it. Under ``"host"``: a launch a
    shard, the records gathered on shard 0's device and the fold kernel
    there, which sets the slots idle. Under ``"peer"``: a launch a shard,
    the last block across every shard folding, with the kernel's clock
    (one card's timer for every shard): each shard's steps past t*, how
    long after the first shard's start each shard started, and the stop's
    latency, the µs from the post (the first block that solved at t*
    ending its search) to the last block each shard stopped on it."""
    import ctypes

    import numpy as np
    import torch

    M, C = len(states), spec.cells
    n = mesh.size
    per = M // n
    flat = torch.as_tensor(states.reshape(M, C), device="cuda").contiguous()
    parts = [flat[i * per:(i + 1) * per] for i in range(n)]
    bad = err = 0
    out = {"layout": slots.layout}
    for _ in range(2):
        for st in mesh.streams:
            st.wait_stream(torch.cuda.current_stream())
        if slots.layout == "host":
            runs = cs.dfs_race_shards(parts, spec, spec.max_depth, max_iters,
                                      streams=list(mesh.streams), slots=slots, **sweeps)
            with torch.cuda.stream(mesh.streams[0]):
                row, fold = cs.race_fold(torch.cat([m for m, _ in runs]),
                                         torch.cat([g for _, g in runs]), spec,
                                         sweeps["waves"], slots=slots.address,
                                         n_slots=slots.n)
        else:
            clock = torch.zeros((M, 3), dtype=torch.int64, device="cuda")
            row, fold, meta = cs.dfs_race_shards(parts, spec, spec.max_depth, max_iters,
                                                 streams=list(mesh.streams), slots=slots,
                                                 fold=True, clock=clock, **sweeps)
        torch.cuda.synchronize()
        b, e = _race_diffs((row, fold), plain)
        words = [w.tolist() for w in slots.words]
        b += sum(w != list(cs.RACE_SCRATCH_IDLE) for w in words)
        if slots.layout == "host":
            posted = list((ctypes.c_uint32 * slots.n).from_address(slots.host))
            b += sum(v != cs.RACE_SLOT_IDLE for v in posted)
            out["slots_after"] = posted
        else:
            rec = meta.cpu().numpy().reshape(n, per, 4)
            ns = clock.cpu().numpy().reshape(n, per, 3).astype(np.float64)
            status, steps, end = rec[:, :, 0], rec[:, :, 1], ns[:, :, 1]
            won = (status == 1) & (steps == t_star)
            post = end[won].min() if won.any() else None
            out.setdefault("steps_past_t_star_by_shard", []).append(
                [max(0, int(steps[k].max()) - t_star) for k in range(n)])
            out.setdefault("start_us_by_shard", []).append(
                [round(float(ns[k, :, 0].min() - ns[:, :, 0].min()) / 1e3, 3)
                 for k in range(n)])
            out.setdefault("stop_latency_us_by_shard", []).append(
                [round(float(end[k][status[k] == 0].max() - post) / 1e3, 3)
                 if post is not None and (status[k] == 0).any() else None
                 for k in range(n)])
        bad, err = bad + b, max(err, e)
    out.update(mismatches=bad, max_abs_err=err, words_after=words)
    return out


def _mesh_race(cs, F, spec_for_size, config, seed: int) -> dict:
    """13(c): the race across 4 shards of cuda:0 (K4's shard form, one
    launch of every shard's states, stopping on the card's one stop word,
    folded by the last block across every shard) against the plain race on phase 11's
    sets, and each state whose shard-form run ended by t* against K1's run
    of it to its own end; the stop's layout (``"device"`` on one card);
    each shard's steps past t* (at most ``MESH_MAX_STEPS_PAST_T_STAR``, or
    one more than the most one-shard K4's blocks run past it in 5 races of
    the states); the time of the one library call alone and of the whole
    race (``race_on_mesh``) against the one-shard race of the same padded
    states; the ``"host"`` and ``"peer"`` layouts forced on the mesh
    (``_forced_layout_race``) on the first 9x9 and 16x16 sets; the shard launches of the first set
    against their plain version (``race_runs`` a shard and ``fold_race``)
    and their bound; and the fold kernel of the multi-host path alone over
    the README @512 records against its plain version. Restores the
    counters."""
    import numpy as np
    import torch
    from sudoku_solver_distributed_tpu_torch.ops.solver import race_runs

    counts = {k: getattr(cs, k).launches for k in MESH_PATH_KERNELS}
    mesh = _mesh()
    streams = list(mesh.streams)
    slots = F.mesh_race_slots(mesh)
    check(slots.layout == "device",
          f"13(c): a virtual mesh of one card keeps its stop as {slots.layout!r}")
    sets = frontier_race_sets(F, spec_for_size, seed)
    out = {"layout": slots.layout, "mismatches": 0, "max_abs_err": 0, "sets": {},
           "host_layout": {}, "peer_layout": {}}
    forced = {k: _forced_layout_slots(cs, mesh, k) for k in ("host", "peer")}
    fold_rec = shard_rec = None
    for name, board, spec, states, max_iters, target in sets:
        sweeps = sweeps_of(config(spec.size))
        depth, C, M = spec.max_depth, spec.cells, len(states)
        flat = torch.as_tensor(states.reshape(M, C), device="cuda").contiguous()
        prow, pfold, pmeta = cs._dfs_race_plain(flat, spec, depth, max_iters, **sweeps)
        _, own = cs.dfs_solver(flat, spec, depth, max_iters, **sweeps)

        def race():
            mesh.streams[0].wait_stream(torch.cuda.current_stream())
            return F.race_on_mesh(states, mesh, spec, depth, max_iters, **sweeps)

        krow, kfold, kmeta = race()
        torch.cuda.synchronize()
        bad, err = _race_diffs((krow, kfold), (prow, pfold))
        steps = kmeta[:, 1].cpu().numpy()
        status = kmeta[:, 0].cpu().numpy()
        solved = status == 1
        t_star = int(steps[solved].min()) if solved.any() else int(steps.max())
        traj_bad, ended = race_trajectory_diffs(kmeta, own, t_star)
        bad += traj_bad
        idle = [w.tolist() for w in dict.fromkeys(slots.words)]
        bad += sum(w != list(cs.RACE_SCRATCH_IDLE) for w in idle)
        out["mismatches"] += bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        per = M // MESH_SHARDS
        past = [max(0, int(steps[i * per:(i + 1) * per].max()) - t_star)
                for i in range(MESH_SHARDS)]
        parts = [flat[i * per:(i + 1) * per].contiguous() for i in range(MESH_SHARDS)]

        def shards():
            cur = torch.cuda.current_stream()
            for st in streams:
                st.wait_stream(cur)
            with slots.lock:
                cs.dfs_race_shards(parts, spec, depth, max_iters, streams=streams,
                                   slots=slots, fold=True, **sweeps)
            cur.wait_stream(streams[0])

        shard_ms = _event_ms(shards, 5)
        mesh_ms = _event_ms(race, 5)
        k4_meta = []
        one_ms = _event_ms(lambda: k4_meta.append(
            cs.dfs_race(flat, spec, depth, max_iters, **sweeps)[2]), 5)
        k4_past = max(int(m[:, 1].max()) - t_star for m in k4_meta)
        rec = {"states": M, "t_star": t_star, "steps_past_t_star_by_shard": past,
               "k4_steps_past_t_star": k4_past,
               "shards_ms": float(np.median(shard_ms)),
               "race_ms": float(np.median(mesh_ms)),
               "one_shard_ms": float(np.median(one_ms)), "mismatches": bad,
               "trajectory_mismatches": traj_bad, "ended_by_t_star": ended,
               "words_after": idle}
        rec["race_over_one_shard"] = rec["race_ms"] / rec["one_shard_ms"]
        out["sets"][name] = rec
        log(f"phase 13 (c) {name}: {M} states over {MESH_SHARDS} shards ({slots.layout} "
            f"stop): {bad} mismatches vs the plain race ({traj_bad} of the {ended} states "
            f"ended by t* differ from K1's run; words after {idle}); the one call "
            f"{rec['shards_ms']:.4f} ms, the whole race {rec['race_ms']:.4f} ms vs "
            f"one-shard K4 {rec['one_shard_ms']:.4f} ms ({rec['race_over_one_shard']:.2f}x; "
            f"CUDA events, medians of 5); t* {t_star}, steps past t* by shard {past} "
            f"(one-shard K4's blocks: {k4_past})")
        check(max(past) <= max(MESH_MAX_STEPS_PAST_T_STAR, k4_past + 1),
              f"13(c) {name}: steps past t* by shard {past}, more than "
              f"{MESH_MAX_STEPS_PAST_T_STAR} and than one-shard K4's {k4_past} + 1")
        if shard_rec is None:
            knobs = cs.sweep_knobs(spec, **sweeps)
            N = spec.size

            def plain():
                runs = [race_runs(p.reshape(per, N, N), spec, max_iters, depth, **knobs)
                        for p in parts]
                cs.fold_race(torch.cat([m for m, _ in runs]),
                             torch.cat([g for _, g in runs]), spec, sweeps["waves"])

            plain_ms = _cuda_ms(plain, 1)
            bound, by = _race_bound_ms(flat, pfold, C, sweeps["locked_candidates"])
            shard_rec = {"set": name, "states": M, "ms": rec["shards_ms"],
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
            log(f"phase 13 (c) {name}: the shard launches and their fold "
                f"{rec['shards_ms']:.4f} ms vs their plain version (race_runs a shard "
                f"and fold_race, on the card) {plain_ms:.1f} ms; bound "
                f"{bound:.6f} ms ({by})")
        for layout, fslots in forced.items() if spec.size in (9, 16) else ():
            # the layouts of races across cards, which one card never chooses
            if spec.size in out[f"{layout}_layout"]:
                continue
            frec = _forced_layout_race(cs, mesh, fslots, spec, states, max_iters, sweeps,
                                       (prow, pfold), t_star)
            out[f"{layout}_layout"][spec.size] = dict(frec, set=name)
            out["mismatches"] += frec["mismatches"]
            out["max_abs_err"] = max(out["max_abs_err"], frec["max_abs_err"])
            if layout == "host":
                how = (f"a launch a shard, the fold kernel), twice: {frec['mismatches']} "
                       f"mismatches vs the plain race; words after {frec['words_after']}, "
                       f"slots after {frec['slots_after']}")
            else:
                how = (f"a launch a shard, system atomics, the last block folding), twice: "
                       f"{frec['mismatches']} mismatches vs the plain race; words after "
                       f"{frec['words_after']}; steps past t* by shard "
                       f"{frec['steps_past_t_star_by_shard']}, the shards' starts (µs "
                       f"after the first) {frec['start_us_by_shard']}, µs from the post "
                       f"to each shard's last stop {frec['stop_latency_us_by_shard']} "
                       f"(the kernel's clock)")
            log(f"phase 13 (c) {name}: the '{layout}' layout's race ({how}")
        if name == "README @512":
            grid0 = torch.zeros((M, C), dtype=torch.int32, device="cuda")
            meta_d = kmeta.contiguous()
            frow, ffold = cs.race_fold(meta_d, grid0, spec, sweeps["waves"])
            pr, pf = cs.fold_race(meta_d, grid0, spec, sweeps["waves"])
            torch.cuda.synchronize()
            fbad, ferr = _race_diffs((frow, ffold), (pr, pf))
            out["mismatches"] += fbad
            out["max_abs_err"] = max(out["max_abs_err"], ferr)
            bound, by = _fold_bound_ms(M, C)
            fold_rec = {
                "states": M, "mismatches": fbad, "max_abs_err": ferr,
                "ms": _cuda_ms(lambda: cs.race_fold(meta_d, grid0, spec, sweeps["waves"]), 50),
                "plain_ms": _cuda_ms(lambda: cs.fold_race(meta_d, grid0, spec,
                                                           sweeps["waves"]), 5),
                "bound_ms": bound, "bound_by": by,
            }
            log(f"phase 13 (c): the fold kernel (the multi-host path's) alone over {M} "
                f"records: {fold_rec['ms']:.4f} ms (CUDA events, mean of 50) vs the plain "
                f"fold {fold_rec['plain_ms']:.4f} ms; bound {bound:.6f} ms ({by}); "
                f"{fbad} mismatches")
    check(out["mismatches"] == 0, f"13(c): {out['mismatches']} race mismatches")
    check(fold_rec is not None, "13(c): the README @512 set is missing")
    out["fold"] = fold_rec
    out["shard"] = shard_rec
    for k, v in counts.items():
        getattr(cs, k).launches = v
    return out


# 13(d): one rank of a serving loop on this card: a mesh engine over this
# rank's shards (SUDOKU_VIRTUAL_MESH), the ladder rounded to the global 4
# shards; rank 0 solves a batch through the fan-out and races the README
# across every rank. argv: rank, world, port, backend, boards, README.
_LOOP_CHILD = r"""
import json, sys, time
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, backend = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
t0 = time.perf_counter()
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank, timeout=timedelta(seconds=120))
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, default_mesh

mesh = default_mesh()
eng = SolverEngine(mesh=mesh, buckets=(4, 8), coalesce=False, bucket_multiple=4)
loop = FrontierServingLoop(mesh, eng.spec, states_per_device=8, max_depth=eng.max_depth,
                           locked=eng.locked_candidates, waves=eng.waves,
                           naked_pairs=eng.naked_pairs, collective_timeout_s=120,
                           allow_gloo_on_cuda=backend == "gloo")
loop.enable_batch_fanout(eng)
loop.start(warm_race=False)
if rank == 0:
    loop.warm_batch_fanout(eng.buckets[0], eng.max_iters)
    eng.mesh_runner = loop.solve_padded
    boards = np.asarray(json.loads(sys.argv[5]), np.int32)
    t1 = time.perf_counter()
    sols, mask, info = eng.solve_batch_np(boards)
    launches = {"dfs_solver": cs.dfs_solver.launches}
    # the race's path (the seeding, the records gathered, then the fold
    # kernel) alone
    for k in ("dfs_race", "dfs_race_shards", "race_fold", "seed_frontier_cuda"):
        getattr(cs, k).launches = 0
    t2 = time.perf_counter()
    race = loop.solve(np.asarray(json.loads(sys.argv[6]), np.int32))
    t3 = time.perf_counter()
    launches.update({k: getattr(cs, k).launches
                     for k in ("dfs_race", "dfs_race_shards", "race_fold",
                               "seed_frontier_cuda")})
    out = {"sols": sols.tolist(), "info": info, "race": race,
           "backend": loop.backend, "collective_device": str(loop._collective_device),
           "batch_ms": (t2 - t1) * 1e3, "race_ms": (t3 - t2) * 1e3,
           "start_s": t1 - t0, "batches": loop.health()["batches"],
           "launches": launches}
    loop.stop()
    print(json.dumps(out), flush=True)
else:
    loop.join(timeout=300)
    print(json.dumps({"follower": True, "launches": {
        "dfs_solver": cs.dfs_solver.launches, "dfs_race": cs.dfs_race.launches,
        "dfs_race_shards": cs.dfs_race_shards.launches}}), flush=True)
dist.destroy_process_group()
"""


def _loop_run(world: int, backend: str, boards, timeout_s: float = 240.0) -> list:
    """Run ``world`` ranks of ``_LOOP_CHILD`` on this card, each on a
    virtual mesh of 4 / world shards; returns each rank's JSON line."""
    from sudoku_solver_distributed_tpu_torch.parallel import sim

    port = _free_port()
    env = sim.virtual_mesh_env(MESH_SHARDS // world, device="cuda:0")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOOP_CHILD, str(r), str(world), str(port), backend,
         json.dumps(boards.tolist()), json.dumps(README_PUZZLE)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        check(p.returncode == 0, f"13(d) {backend} x{world}: a rank failed:\n{o[-3000:]}")
    return [json.loads([ln for ln in o.splitlines() if ln.startswith("{")][-1]) for o in outs]


def _mesh_loop(SolverEngine, oracle_ok) -> dict:
    """13(d): FrontierServingLoop on a one-rank NCCL group (4 shards), then
    two ranks on a gloo group on this card (2 shards each), the gloo
    group asked for here (``allow_gloo_on_cuda``), never chosen by the
    loop. The batch's grids equal one device's, its counters and the
    race's (the README board has many solutions) equal the plain versions
    over 4 shards, which the CPU two-process test holds to the JAX
    package's."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.models import generate_batch
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    boards = generate_batch(6, 55, seed=43)
    cpu = SolverEngine(device="cpu", buckets=(4, 8), coalesce=False)
    single = SolverEngine(buckets=(4, 8), coalesce=False)
    try:
        _, _, want_info = cpu.solve_batch_np(boards)
        want_sols, _, _ = single.solve_batch_np(boards)
        want_race = F.frontier_solve(
            np.asarray(README_PUZZLE), _mesh("cpu"), cpu.spec, states_per_device=8,
            max_depth=cpu.max_depth, locked=cpu.locked_candidates, waves=cpu.waves,
            naked_pairs=cpu.naked_pairs)
    finally:
        cpu.close()
        single.close()
    out = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        lead = _loop_run(world, backend, boards)[0]
        wall = time.perf_counter() - t0
        check(lead["sols"] == want_sols.tolist() and lead["info"] == want_info,
              f"13(d) {backend} x{world}: the fan-out's answers {lead['info']} differ "
              f"from {want_info}")
        # the README board has many solutions: the race's is the plain race's
        # over as many shards (the lowest-index solved state's), not K1's
        _check_answer(README_PUZZLE, lead["race"][0], oracle_ok, f"13(d) {backend} race")
        check(lead["race"] == list(want_race),
              f"13(d) {backend} x{world}: the race {lead['race'][1]} differs from "
              f"{want_race[1]}")
        check(lead["backend"] == backend, f"13(d): the loop ran on {lead['backend']}")
        # the race across hosts: this host's shards (one card) in one launch
        # of K4's shard form, the records gathered, then one fold kernel
        race_launches = {k: lead["launches"][k]
                         for k in ("dfs_race", "dfs_race_shards", "race_fold",
                                   "seed_frontier_cuda")}
        check(race_launches == {"dfs_race": 0, "dfs_race_shards": 1,
                                "race_fold": 1, "seed_frontier_cuda": 1},
              f"13(d) {backend} x{world}: the race's launches {race_launches}")
        out[f"{backend}_x{world}"] = {k: lead[k] for k in (
            "info", "backend", "collective_device", "batch_ms", "race_ms", "start_s",
            "batches", "launches")} | {"race_info": lead["race"][1], "wall_s": wall}
        log(f"phase 13 (d) {backend} x{world}: fan-out of 6 boards {lead['batch_ms']:.1f} ms, "
            f"README race {lead['race_ms']:.1f} ms (host clock, leader), {lead['race'][1]}; "
            f"counters {lead['info']}; collectives on {lead['collective_device']}; "
            f"{wall:.1f} s with the ranks' start")
    return out


# 13(d)'s relay sets: a deep board turned (np.rot90 k % 4 times, then
# transposed for k >= 4) so that in a race of 2 ranks of 2 virtual shards,
# one rank's half of the seeded states solves early and the other's runs
# long: (name, corpus, board, k, size, states a device). In the plain race
# (steps): rank 1 solves at 25, rank 0 runs to 186; rank 0 at 25, rank 1
# to 40; rank 0 at 9, rank 1 to 216; rank 0 at 137, rank 1 to 504; and at
# the serving loop's own 64 states a device (512 states raced, 128 a
# shard), rank 0 at 21, rank 1 to 250; rank 0 at 13, rank 1 to 127.
RELAY_SETS = (
    ("9x9 #12 rt @8", "corpus_9x9_deep_128.npz", 12, 5, 9, 8),
    ("9x9 #0 rt @8", "corpus_9x9_deep_128.npz", 0, 5, 9, 8),
    ("16x16 #0 r @2", "corpus_16x16_deep_anneal_64.npz", 0, 1, 16, 2),
    ("16x16 #0 r2t @1", "corpus_16x16_deep_anneal_64.npz", 0, 6, 16, 1),
    ("16x16 #17 r2 @64", "corpus_16x16_deep_anneal_64.npz", 17, 2, 16, 64),
    ("16x16 #18 r2 @64", "corpus_16x16_deep_anneal_64.npz", 18, 2, 16, 64),
)
RELAY_RACES = 6  # races a set, the first not counted

# 13(d)'s relay races: one rank of the serving loop on this card (gloo, a
# virtual mesh of SUDOKU_VIRTUAL_MESH shards), a loop a (size, states a
# device) group; rank 0 races each board of the group `races` times and
# times each whole request (loop.solve: the header's broadcast, seeding,
# the race, the gather and the fold; host ms). Each
# rank taps the gather (the records of every race), its relay's finish
# (the race's posts, host monotonic ns) and race_on_mesh (host ms, from
# the call to the folded row after a sync). It runs from any tree of the
# port, one without a relay too (tools/race_relay_ab.py runs the parent's),
# and with relay "off" drops the loop's relay before it starts (a
# diagnostic: the same tree, the parent's race path across hosts).
# argv: rank, world, port, groups, races, backend, relay
_RELAY_CHILD = r"""
import json, sys, time
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, groups, races, backend, relay_on = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4]),
    int(sys.argv[5]), sys.argv[6], sys.argv[7] == "on")
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank, timeout=timedelta(seconds=120))
from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs, spec_for_size
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, default_mesh
from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

times = []
race_on_mesh = F.race_on_mesh
def timed(*args, **kw):
    t0 = time.perf_counter()
    out = race_on_mesh(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    return out
F.race_on_mesh = timed
out = {"rank": rank, "groups": []}
for size, spd, boards in groups:
    loop = FrontierServingLoop(default_mesh(), spec_for_size(size), states_per_device=spd,
                               locked=True, waves=3 if size == 9 else 1, naked_pairs=False,
                               collective_timeout_s=120,
                               allow_gloo_on_cuda=backend == "gloo")
    records, posts, gather_ms = [], [], []
    def tap(meta, grid, gather=loop._gather_records, records=records):
        t0 = time.perf_counter()
        meta, grid = gather(meta, grid)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        records.append(meta.cpu().tolist())
        return meta, grid
    loop._gather_records = tap
    if not relay_on:
        loop.relay = None
    relay = getattr(loop, "relay", None)
    if relay is not None:
        def finish(link, *a, done=relay.finish, posts=posts, **k):
            done(link, *a, **k)
            posts.append(link.summary())
        relay.finish = finish
    del times[:]
    cs.dfs_race_shards.launches = 0
    loop.start(warm_race=False)
    answers, solve_ms = [], []
    if rank == 0:
        for board in boards:
            for _ in range(races):
                t0 = time.perf_counter()
                answers.append(loop.solve(np.asarray(board, np.int32)))
                solve_ms.append((time.perf_counter() - t0) * 1e3)
        loop.stop()
    else:
        loop.join(timeout=600)
    out["groups"].append({
        "size": size, "spd": spd, "answers": answers, "records": records, "posts": posts,
        "race_ms": list(times), "gather_ms": gather_ms, "solve_ms": solve_ms,
        "launches": cs.dfs_race_shards.launches,
        "relay": relay.health() if relay is not None else None})
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def relay_board(corpus: str, index: int, k: int):
    """Board ``index`` of ``benchmarks/<corpus>`` turned as RELAY_SETS says."""
    import numpy as np

    board = np.rot90(np.load(os.path.join(ROOT, "benchmarks", corpus))["boards"][index], k % 4)
    return np.ascontiguousarray(board.T if k >= 4 else board)


def relay_run(root: str = ROOT, timeout_s: float = 300.0, device: str = "cuda:0",
              visible=None, backend: str = "gloo", relay: bool = True) -> dict:
    """RELAY_SETS through two ranks of the serving loop of the tree at
    ``root`` (``_RELAY_CHILD``; ``relay`` False drops the loops' relay):
    by default on ``device``, 2 virtual shards
    a rank over gloo (the CPU rehearses it); with ``visible`` (each rank's
    ``CUDA_VISIBLE_DEVICES``) a shard a visible card, over ``backend``. Returns, by set name, each counted race's answer, gathered
    records' t* and each rank's steps past it, the rank that solved at t*,
    the relay's latency (µs, from the sender seeing its post to the
    receiver's inbox written; None where nothing was relayed), each rank's
    race ms, the leader's whole request ms and the ranks' relay health and
    shard-race launches."""
    groups = {}
    for name, corpus, index, k, size, spd in RELAY_SETS:
        groups.setdefault((size, spd), []).append(
            (name, relay_board(corpus, index, k).tolist()))
    arg = json.dumps([[size, spd, [b for _, b in sets]]
                      for (size, spd), sets in groups.items()])
    port = _free_port()
    env = dict(os.environ, SUDOKU_VIRTUAL_MESH=f"2@{device}", PYTHONPATH=root)
    envs = [env] * 2
    if visible is not None:
        env.pop("SUDOKU_VIRTUAL_MESH")
        envs = [dict(env, CUDA_VISIBLE_DEVICES=v) for v in visible]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RELAY_CHILD, str(r), "2", str(port), arg, str(RELAY_RACES),
         backend, "on" if relay else "off"],
        env=envs[r], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        check(p.returncode == 0, f"13(d) relay ({root}): a rank failed:\n{o[-3000:]}")
    ranks = [json.loads([ln for ln in o.splitlines() if ln.startswith("{")][-1])
             for o in outs]
    out = {}
    for g, (key, sets) in enumerate(groups.items()):
        lead, follow = (r["groups"][g] for r in ranks)
        for b, (name, board) in enumerate(sets):
            races = []
            for j in range(b * RELAY_RACES + 1, (b + 1) * RELAY_RACES):
                meta = lead["records"][j]
                steps = [m[1] for m in meta]
                solved = [m[1] for m in meta if m[0] == 1]
                t_star = min(solved) if solved else max(steps)
                half = len(meta) // 2
                latency = stages = None
                if follow["posts"] and lead["posts"]:
                    sent, got = ((lead["posts"][j], follow["posts"][j])
                                 if lead["posts"][j]["sent_step"] is not None
                                 else (follow["posts"][j], lead["posts"][j]))
                    if sent["sent_ns"] is not None and got["delivered_ns"] is not None:
                        latency = (got["delivered_ns"] - sent["sent_ns"]) / 1e3
                        # µs: the sender's sends, the channel to the
                        # receiver's read, its inbox write
                        stages = [(sent["posted_ns"] - sent["sent_ns"]) / 1e3,
                                  (got["received_ns"] - sent["posted_ns"]) / 1e3,
                                  (got["delivered_ns"] - got["received_ns"]) / 1e3]
                polls = [(p["left_ns"] - p["picked_ns"]) / 1e3 / max(p["polls"], 1)
                         if p.get("polls") else None
                         for p in (lead["posts"][j] if lead["posts"] else {},
                                   follow["posts"][j] if follow["posts"] else {})]
                races.append({
                    "answer": lead["answers"][j], "t_star": t_star,
                    "solver_rank": 0 if [1, t_star] in [m[:2] for m in meta[:half]] else 1,
                    "past_by_rank": [max(steps[:half]) - t_star, max(steps[half:]) - t_star],
                    "below_t_star": sum(m[0] == 0 and m[1] < t_star for m in meta),
                    "gathered_equal": follow["records"][j] == meta,
                    "latency_us": latency, "latency_stages_us": stages,
                    "us_a_poll_by_rank": polls,
                    "race_ms": [lead["race_ms"][j], follow["race_ms"][j]],
                    "gather_ms": [lead["gather_ms"][j], follow["gather_ms"][j]],
                    "solve_ms": lead["solve_ms"][j]})
            out[name] = {"board": board, "size": key[0], "states_per_shard": key[1],
                         "races": races}
        for name, _ in sets:
            out[name]["relay"] = [lead["relay"], follow["relay"]]
            out[name]["launches"] = [lead["launches"], follow["launches"]]
    return out


def relay_us_a_step(board, size: int, spd: int, rank: int) -> float:
    """µs a step of rank ``rank``'s half of a RELAY_SETS race on this card,
    alone (no relay, no other process on the card): its 2 virtual shards'
    one launch with the kernel clock, from the first block's start to the
    last search's end, over the most steps a state ran (the second of two
    races; the first builds and warms). Restores the launch count."""
    import torch
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
    from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F
    from sudoku_solver_distributed_tpu_torch.parallel.mesh import virtual_mesh

    spec = spec_for_size(size)
    states, _ = F.seed_frontier(board, spec, target=4 * spd, locked=True)
    states = F.bucket_states(states, spec, spd, 4).numpy().reshape(-1, spec.cells)
    half = len(states) // 2
    flat = torch.as_tensor(states[rank * half:(rank + 1) * half], device="cuda").contiguous()
    mesh = virtual_mesh("cuda:0", 2)
    slots = F.mesh_race_slots(mesh)
    launches = cs.dfs_race_shards.launches
    for _ in range(2):
        clock = torch.zeros((half, 3), dtype=torch.int64, device="cuda")
        for st in mesh.streams:
            st.wait_stream(torch.cuda.current_stream())
        runs = cs.dfs_race_shards([flat[:half // 2], flat[half // 2:]], spec, spec.max_depth,
                                  F.DEFAULT_MAX_ITERS, streams=list(mesh.streams), slots=slots,
                                  clock=clock, locked_candidates=True,
                                  waves=3 if size == 9 else 1, naked_pairs=False)
        torch.cuda.synchronize()
    cs.dfs_race_shards.launches = launches
    steps = max(int(m[:, 1].max()) for m, _ in runs)
    ns = clock.cpu()
    return float(ns[:, 1].max() - ns[:, 0].min()) / 1e3 / max(steps, 1)


def _mesh_relay(oracle_ok, **run) -> dict:
    """13(d), the race's relay across hosts: RELAY_SETS raced by two ranks
    of the serving loop on this card (``relay_run``, given ``run``). Every answer equals
    the plain race over 4 CPU shards (row, statuses and counters) and, when
    found, the oracle's check; no state of either rank halted RUNNING
    before t*; the ranks gathered the same records; neither relay counted
    an error or a missed race. Prints, for each set, each rank's steps past
    t* and the relay's latency race by race, in µs and in steps of the rank
    that did not solve (``relay_us_a_step``), the leader's race ms and its
    whole request ms."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.ops import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    out = relay_run(**run)
    # the relay's path: some rank took another's post in some race (a rank
    # whose kernel runs to its end before the post lands takes none)
    relayed = sum(r["latency_us"] is not None for rec in out.values() for r in rec["races"])
    check(relayed > 0, f"13(d) relay: no post was relayed in {len(out)} sets")
    for name, rec in out.items():
        spec = spec_for_size(rec["size"])
        board = np.asarray(rec["board"], np.int32)
        want = list(F.frontier_solve(
            board, _mesh("cpu"), spec, states_per_device=rec["states_per_shard"],
            locked=True, waves=3 if rec["size"] == 9 else 1, naked_pairs=False))
        for race in rec["races"]:
            check(race["answer"] == want,
                  f"13(d) relay {name}: {race['answer'][1]} differs from the plain "
                  f"race's {want[1]}")
            if want[0] is not None:
                _check_answer(board, race["answer"][0], oracle_ok, f"13(d) relay {name}")
            check(race["below_t_star"] == 0 and race["gathered_equal"],
                  f"13(d) relay {name}: {race['below_t_star']} states halted before t*"
                  f" {race['t_star']} (records equal on both ranks: "
                  f"{race['gathered_equal']})")
        check(all(h is not None and h["errors"] == h["missed"] == 0 for h in rec["relay"]),
              f"13(d) relay {name}: the relays {rec['relay']}")
        check(rec["launches"][0] > 0, f"13(d) relay {name}: no shard race launched")
        lat = [r["latency_us"] for r in rec["races"]]
        lead_ms = [r["race_ms"][0] for r in rec["races"]]
        rec["race_ms_median"] = float(np.median(lead_ms))
        rec["solve_ms_median"] = float(np.median([r["solve_ms"] for r in rec["races"]]))
        long_rank = 1 - rec["races"][0]["solver_rank"]
        rec["us_a_step"] = relay_us_a_step(board, rec["size"], rec["states_per_shard"],
                                           long_rank)
        lat_steps = [None if x is None else round(x / rec["us_a_step"], 1) for x in lat]
        log(f"phase 13 (d) relay {name}: t* {[r['t_star'] for r in rec['races']]}, steps "
            f"past t* by rank {[r['past_by_rank'] for r in rec['races']]}; relay latency "
            f"{[None if x is None else round(x, 1) for x in lat]} us (host clock; "
            f"stages: sender's sends, channel, inbox write "
            f"{[r['latency_stages_us'] and [round(x, 1) for x in r['latency_stages_us']] for r in rec['races']]}"
            f"; us a poll by rank "
            f"{[[x and round(x, 1) for x in r['us_a_poll_by_rank']] for r in rec['races']]}); "
            f"the leader's race {rec['race_ms_median']:.3f} ms (median of "
            f"{len(lead_ms)}; {[round(x, 3) for x in lead_ms]}), its whole request "
            f"{rec['solve_ms_median']:.3f} ms; in steps of rank {long_rank} "
            f"({rec['us_a_step']:.3f} us a step alone on the card, kernel clock) the "
            f"latency is {lat_steps}")
    return out


# 13(e): a resumable batch on the 4-shard virtual mesh, SIGKILLed by the
# parent once its first snapshot lands
_MESH_RESUMABLE_CHILD = r"""
import sys
import numpy as np
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
with np.load(sys.argv[1]) as d:
    boards = d["boards"][: int(sys.argv[4])].astype(np.int32)
eng = SolverEngine(mesh="auto", coalesce=False)
assert eng.mesh is not None and eng.mesh.size == 4, eng.mesh
print("solving", flush=True)
eng.solve_batch_resumable_np(boards, sys.argv[2], chunk_iters=int(sys.argv[3]))
print("finished", flush=True)
"""


def _mesh_resumable(SolverEngine) -> dict:
    """13(e): hard boards in chunks on the 4-shard virtual mesh, killed as
    its first snapshot lands, resumed on one device to the rows of an
    uninterrupted one-device run."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.parallel import sim

    n = MESH_RESUMABLE_BOARDS
    boards = load_corpus("corpus_9x9_hard_4096.npz")[:n]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ck_") as tmp:
        path = os.path.join(tmp, "batch.npz")
        proc = subprocess.Popen(
            [sys.executable, "-c", _MESH_RESUMABLE_CHILD,
             os.path.join(ROOT, "benchmarks", "corpus_9x9_hard_4096.npz"), path,
             str(DURABLE_CHUNK_ITERS), str(n)],
            env=sim.virtual_mesh_env(MESH_SHARDS, device="cuda:0"), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            _wait(lambda: os.path.exists(path) or proc.poll() is not None, 180.0,
                  "13(e)'s first snapshot")
            killed = proc.poll() is None
            proc.kill()
            log_out = proc.communicate(timeout=30)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(killed and os.path.exists(path),
              f"13(e): the mesh child finished before its kill:\n{log_out[-2000:]}")
        snap = dict(np.load(path))
        eng = SolverEngine(coalesce=False)
        try:
            sols, mask, info = eng.solve_batch_resumable_np(
                boards, path, chunk_iters=DURABLE_CHUNK_ITERS)
            ref = eng.solve_batch_resumable_np(
                boards, os.path.join(tmp, "ref.npz"), chunk_iters=DURABLE_CHUNK_ITERS)
        finally:
            eng.close()
        check(np.array_equal(sols, ref[0]) and np.array_equal(mask, ref[1])
              and info == ref[2], "13(e): the resumed rows differ from the uninterrupted run")
    out = {"boards": n, "snapshot_iters": int(snap["iters"]), "validations": info["validations"],
           "guesses": info["guesses"]}
    log(f"phase 13 (e): {n} hard boards on the 4-shard mesh killed at the snapshot of step "
        f"{out['snapshot_iters']}, resumed on one device: equal to the uninterrupted run "
        f"({info})")
    return out


def phase_mesh(cs, build_parser, build_node, SolverEngine, spec_for_size, config,
               oracle_ok, seed: int) -> dict:
    """Phase 13: the mesh plane on one card, a 4-shard virtual mesh."""
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    marks, out = {}, {}
    for key, fn in (
        ("engine", lambda: _mesh_engine(cs, SolverEngine, oracle_ok)),
        ("node", lambda: _mesh_node(cs, build_parser, build_node, SolverEngine, oracle_ok)),
        ("race", lambda: _mesh_race(cs, F, spec_for_size, config, seed)),
        ("loop", lambda: _mesh_loop(SolverEngine, oracle_ok)),
        ("relay", lambda: _mesh_relay(oracle_ok)),
        ("resumable", lambda: _mesh_resumable(SolverEngine)),
    ):
        t0 = time.perf_counter()
        out[key] = fn()
        marks[key] = round(time.perf_counter() - t0, 1)
    out["seconds"] = marks
    log(f"phase 13 seconds by part: {marks}")
    return out


def card_name_and_power_limit() -> str:
    return card_name_and_power_limit_all()[0]


def card_name_and_power_limit_all() -> list:
    """Every card's ``name, power.limit`` line, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def ptxas_report(build_log: str, label: str = "ptxas"):
    """Registers, stack and spill bytes per kernel instance, from the
    ``-Xptxas -v`` report in the text ``build_log``, keyed
    "dfs_solver_kernel 9x9", "dfs_segment_kernel 16x16",
    "segment_digest_kernel 25x25", "dfs_race_shard_kernel 9x9 relay" (the
    relay's instance), ..."""
    report, key = {}, None
    for line in build_log.splitlines():
        m = re.search(
            r"Compiling entry function '\S*?(dfs_solver_kernel|dfs_segment_kernel|"
            r"segment_digest_kernel|dfs_race_kernel|dfs_race_shard_kernel|race_fold_kernel|"
            r"seed_frontier_kernel)"
            r"(?:ILi(\d)E(Lb1E)?)?",
            line
        )
        if m:
            key = m.group(1) + (f" {int(m.group(2)) ** 2}x{int(m.group(2)) ** 2}"
                                if m.group(2) else "") + (" relay" if m.group(3) else "")
            continue
        if key is None:
            continue
        inst = report.setdefault(key, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            inst.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            inst["registers"] = int(m[1])
    for name, inst in sorted(report.items()):
        log(f"{label} {name}: {inst}")
    return report


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one NVIDIA GPU and check "
        "it end to end (see the module docstring).")
    parser.add_argument(
        "--seed", type=int, default=SYMMETRY_SEED,
        help="seed of the generated board sets: symmetry transforms, 4x4 "
        "boards and pool rotations (default %(default)s)")
    parser.add_argument(
        "--race-parent", metavar="FILE", default=None,
        help="another dfs_solver.cu of the same C interface inside the checkout "
        "(e.g. the parent commit's, from git archive into _archive/): phase 11 "
        "(c) times its race kernel in turns with this one's")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sudoku_solver_distributed_tpu_torch.cache.canonical import random_symmetry
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
    from sudoku_solver_distributed_tpu_torch.models.oracle import count_solutions
    from sudoku_solver_distributed_tpu_torch.net.cli import build_node, build_parser
    from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs
    from sudoku_solver_distributed_tpu_torch.ops import solver as ts
    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size

    t_start = time.perf_counter()
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    )
    log(f"card: {card_name_and_power_limit()}")
    gate = phase_static_gate()
    log(f"[{time.perf_counter() - t_start:.1f} s] phase_static_gate took "
        f"{gate['wall_s']} s")
    print(json.dumps({"static_gate": gate}), flush=True)
    t0 = time.perf_counter()
    cs.load_library()
    log(f"build: dfs_solver library built and loaded in {time.perf_counter() - t0:.2f} s")
    build_log = cs.build_log()
    check(build_log is not None, "the kernel store kept no build log")
    ptxas = ptxas_report(build_log)
    for kernel in ("dfs_solver_kernel", *SEGMENT_KERNELS, *RACE_KERNELS, *MESH_RACE_KERNELS,
                   SEED_KERNEL):
        for size in (4, 9, 16, 25):
            key = f"{kernel} {size}x{size}"
            inst = ptxas.get(key, {})
            check(inst.get("stack") == 0 and inst.get("spill_stores") == 0
                  and inst.get("spill_loads") == 0, f"{key} uses local memory: {inst}")
    marks = {}
    t_mark = [time.perf_counter()]

    def _mark(name):
        now = time.perf_counter()
        marks[name] = round(now - t_mark[0], 1)
        t_mark[0] = now
        log(f"[{now - t_start:.1f} s] {name} took {marks[name]} s")

    config = node_config(SolverEngine, spec_for_size, serving_config)
    mismatches, max_abs_err = phase_parity(
        cs, ts, spec_for_size, config, oracle_is_valid_solution, args.seed
    )
    _mark("phase_parity")
    golden = phase_golden(cs, spec_for_size, serving_config)
    _mark("phase_golden")
    seg_bad, seg_err = phase_segment_parity(
        cs, ts, spec_for_size, config, oracle_is_valid_solution, args.seed
    )
    _mark("phase_segment_parity")
    phase_chain_vs_flat(cs, ts, spec_for_size, serving_config)
    _mark("phase_chain_vs_flat")
    seg_golden = phase_golden_segments(
        cs, ts, SolverEngine, spec_for_size, serving_config, oracle_is_valid_solution
    )
    _mark("phase_golden_segments")
    phase_engine(SolverEngine, oracle_is_valid_solution)
    _mark("phase_engine")
    main_path = phase_solve_http(
        cs, build_parser, build_node, oracle_is_valid_solution
    )
    _mark("phase_solve_http")
    front = phase_cache_and_supervision(
        cs, build_parser, build_node, oracle_is_valid_solution, random_symmetry
    )
    _mark("phase_cache_and_supervision")
    log(
        f"README /solve p50 side by side (host clock): cache hit "
        f"{front['hit_p50_ms']:.3f} ms vs miss (--no-answer-cache) "
        f"{main_path['p50_continuous']:.3f} ms; supervised "
        f"{front['p50_supervised']:.3f} ms vs unsupervised "
        f"{main_path['p50_continuous']:.3f} ms"
    )
    timing = phase_timing(cs, spec_for_size, serving_config)
    _mark("phase_timing")
    seg_timing = phase_segment_timing(cs, ts, spec_for_size, serving_config)
    _mark("phase_segment_timing")
    obs = phase_obs(cs, build_parser, build_node, oracle_is_valid_solution,
                    main_path["boundary_host_ms"].get("p50"))
    _mark("phase_obs")
    surface = phase_front(cs, SolverEngine, build_parser, build_node,
                          make_http_server, oracle_is_valid_solution, args.seed)
    _mark("phase_front")
    p2p = phase_p2p(oracle_is_valid_solution, random_symmetry, count_solutions,
                    SolverEngine, {
                        "readme_no_answer_cache": main_path["p50_continuous"],
                        "corpus": front["corpus_miss_p50_ms"],
                    })
    _mark("phase_p2p")
    frontier = phase_frontier(cs, build_parser, build_node, spec_for_size,
                              config, oracle_is_valid_solution, args.seed,
                              args.race_parent)
    _mark("phase_frontier")
    durability = phase_durability(cs, ts, SolverEngine, spec_for_size, serving_config,
                                  oracle_is_valid_solution, count_solutions)
    _mark("phase_durability")
    mesh = phase_mesh(cs, build_parser, build_node, SolverEngine, spec_for_size, config,
                      oracle_is_valid_solution, args.seed)
    _mark("phase_mesh")

    log(f"total {time.perf_counter() - t_start:.1f} s; seconds by phase {marks}")
    print(json.dumps({"cache_supervision": {
        "readme_hit_p50_ms": front["hit_p50_ms"],
        "readme_miss_p50_ms_no_answer_cache": main_path["p50_continuous"],
        "corpus_miss_p50_ms": front["corpus_miss_p50_ms"],
        "lookup_p50_ms_readme": front["lookup_p50_ms_readme"],
        "lookup_p50_ms_corpus_twin": front["lookup_p50_ms_corpus_twin"],
        "readme_supervised_p50_ms": front["p50_supervised"],
        "readme_unsupervised_p50_ms": main_path["p50_continuous"],
        "readmit_after_clear_s": front["readmit_after_clear_s"],
        "lost_to_healthy_s": front["relost_to_healthy_s"],
        "cache": front["cache"],
        "supervisor": front["supervisor"],
        "transitions": front["transitions"],
        "faults": front["faults"],
    }}), flush=True)
    card = card_name_and_power_limit()
    log(card)
    print(json.dumps({"obs": dict(obs, card=card)}), flush=True)
    print(json.dumps({"front": dict(surface, card=card)}), flush=True)
    print(json.dumps({"p2p": dict(p2p, card=card)}), flush=True)
    print(json.dumps({"frontier": dict(frontier, card=card)}), flush=True)
    print(json.dumps({"durability": dict(durability, card=card)}), flush=True)
    print(json.dumps({"mesh": dict(mesh, card=card)}), flush=True)
    on_mesh = mesh["node"]["launches"]
    on_durable = {
        "resumable": durability["resumable"]["launches"],
        "generator": durability["generator"]["launches"],
        # each 12(a) engine child's, from its start (warm-up verification)
        "compile_plane_truncated": durability["compile_plane"]["truncated"]["launches"],
        "compile_plane_read_only": durability["compile_plane"]["read_only"]["launches"],
    }
    on_frontier = frontier["node"]["launches"]
    new_paths = {f"launches_{path}": counts
                 for path, counts in surface["launches"].items()}
    serving, singles = timing["serving"], timing["singles"]
    readme_p50 = {
        "continuous": main_path["p50_continuous"],
        "continuous_no_segment_pipeline": main_path["p50_nopipe"],
        "no_continuous": main_path["p50_closed"],
        "no_coalesce": main_path["p50_no_coalesce"],
        "engine_continuous": main_path["engine_p50_continuous"],
        "engine_no_continuous": main_path["engine_p50_closed"],
        "engine_no_coalesce": main_path["engine_p50_no_coalesce"],
        "cache_hit": front["hit_p50_ms"],
        "supervised": front["p50_supervised"],
    }
    kernel = {
        "name": "dfs_solver",
        "route": "cuda",
        "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
        "replaces": "sudoku_solver_distributed_tpu/ops/pallas_solver.py:98",
        # the closed-loop paths (--no-continuous, --no-coalesce); on the
        # continuous path it runs the warm-up and the deep retries
        "launches": main_path["solver_launches_closed"],
        "launches_continuous_path": main_path["solver_launches_continuous"],
        # the cached default node (warm-up) and the supervised node
        # (warm-up, half-open probes and the LOST rebuild)
        "launches_cache_path": front["solver_launches_cache"],
        "launches_supervised_path": front["solver_launches_supervised"],
        # the observability plane's node (phase 8): its warm-up
        "launches_obs_path": obs["solver_launches"],
        # phase 9's paths: /solve_batch, and nodes at 16x16, 25x25, 4x4
        **{k: v["dfs_solver"] for k, v in new_paths.items()},
        # phase 10's 4 node processes, from their start (warm-up included)
        # to the cluster view, summed; and the farm's share after warm-up
        "launches_p2p_path": p2p["launches"]["dfs_solver"],
        "launches_p2p_farm": p2p["launches_farm"]["dfs_solver"],
        # phase 11's frontier node: the auto route's probes
        "launches_frontier_path": on_frontier["dfs_solver"],
        # phase 12's paths: K1 solves the generated boards; an engine's
        # warm-up verifies a stored library at every bucket width
        **{f"launches_{k}_path": v["dfs_solver"] for k, v in on_durable.items()},
        # phase 13's 4-shard virtual-mesh node (probes, /solve_batch)
        "launches_mesh_path": on_mesh["dfs_solver"],
        "launches_per_readme_solve": main_path["per_readme_closed"],
        "mismatches": mismatches + timing["mismatches"],
        "max_abs_err": max(max_abs_err, timing["max_abs_err"]),
        # the serving configuration at width 4096
        "ms": serving["ms"]["4096"],
        "plain_ms": serving["plain_ms"]["4096"],
        "bound_ms": serving["bound_ms"]["4096"],
        "bound_by": serving["bound_by"],
        "library_ms": None,
        "ms_by_width": serving["ms"],
        "plain_ms_by_width": serving["plain_ms"],
        "bound_ms_by_width": serving["bound_ms"],
        "steps_by_width": serving["steps"],
        "singles_ms_by_width": singles["ms"],
        "singles_plain_ms_by_width": singles["plain_ms"],
        "singles_bound_ms_by_width": singles["bound_ms"],
        "singles_steps_by_width": singles["steps"],
        "golden": golden,
        "readme_p50_ms": readme_p50,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("dfs_solver_kernel")},
    }
    # the segment kernels: no Pallas kernel (the JAX package runs segments
    # as XLA code, engine.py:873); each stands for its plain function
    replaces = {
        "dfs_segment_kernel": "sudoku_solver_distributed_tpu/ops/solver.py:875",
        "segment_digest_kernel": "sudoku_solver_distributed_tpu/ops/solver.py:801",
    }
    segment_kernels = []
    for kern in SEGMENT_KERNELS:
        split = seg_timing["split"][kern]
        segment_kernels.append({
            "name": kern,
            "route": "cuda",
            "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
            "replaces": replaces[kern],
            # both launch once a segment, from the one wrapper
            # ops/cuda_solver.dfs_segment
            "launches": main_path["segment_launches"],
            "segments_per_readme_solve": main_path["segments_per_readme"],
            "launches_cache_path": front["segment_launches_cache"],
            "launches_supervised_path": front["segment_launches_supervised"],
            "launches_obs_path": obs["segment_launches"],
            **{k: v["dfs_segment"] for k, v in new_paths.items()},
            "launches_p2p_path": p2p["launches"]["dfs_segment"],
            "launches_p2p_farm": p2p["launches_farm"]["dfs_segment"],
            "launches_frontier_path": on_frontier["dfs_segment"],
            # phase 13's mesh node: its README on the mesh pool, a launch a shard
            "launches_mesh_path": on_mesh["dfs_segment"],
            # phase 12's paths: one segment a resumable chunk; the pool's
            # warm-up verification in each 12(a) engine child
            **{f"launches_{k}_path": v["dfs_segment"] for k, v in on_durable.items()},
            "mismatches": seg_bad + seg_timing["mismatches"],
            "max_abs_err": max(seg_err, seg_timing["max_abs_err"]),
            # one segment (k = 8) over a 4096-lane pool, every lane
            # injected; torch.profiler's kernel time
            "ms": split["4096"]["ms"],
            "plain_ms": seg_timing["plain_split_ms"][kern]["4096"],
            "bound_ms": split["4096"]["bound_ms"],
            "bound_by": split["4096"]["bound_by"],
            "library_ms": None,
            "by_pool": split,
            "plain_ms_by_pool": seg_timing["plain_split_ms"][kern],
            "ptxas": {k: v for k, v in ptxas.items() if k.startswith(kern)},
        })
    segment_kernels[0].update(
        warps_per_sm_9x9=seg_timing["warps_per_sm"],
        pair_ms_by_pool=seg_timing["ms"],
        pair_k0_ms_by_pool=seg_timing["k0_ms"],
        pair_plain_ms_by_pool=seg_timing["plain_ms"],
        pair_bound_ms_by_pool=seg_timing["bound_ms"],
        boundary_host_ms=main_path["boundary_host_ms"],
        golden_segmented=seg_golden,
        batch_fill_max=main_path["batch_fill_max"],
    )
    # the race kernel, one launch of ops/cuda_solver.dfs_race (its last block
    # folds); the counterpart of XLA code (JAX parallel/frontier.py:337 race)
    main_race = frontier["timing"][next(iter(frontier["timing"]))]
    race_kernel = {
        "name": "dfs_race_kernel",
        "route": "cuda",
        "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
        "replaces": "sudoku_solver_distributed_tpu/parallel/frontier.py:337",
        # phase 11's --frontier 64 node: README, 16 deep /solve, 4 in process
        "launches": on_frontier["dfs_race"],
        "mismatches": frontier["mismatches"],
        "max_abs_err": frontier["max_abs_err"],
        # one race (CUDA events) on a 9x9 deep board's 64-state seeding
        # (raced as 128 states), the node's own race
        "ms": main_race["ms"],
        "plain_ms": main_race["plain_ms"],
        "bound_ms": main_race["bound_ms"],
        "bound_by": main_race["bound_by"],
        "library_ms": None,
        "timing_by_set": frontier["timing"],
        # the parent's build in turns (--race-parent), else None
        "parent_ms_by_set": {k: v.get("parent_ms") for k, v in frontier["timing"].items()},
        "threads_by_size": frontier["threads"],
        "stack_in_slab_by_size": frontier["stack_in_slab"],
        "states_per_sm_by_size": frontier["states_per_sm"],
        "streams": frontier["streams"],
        "early_exit_by_set": {
            k: {x: v[x] for x in ("states", "t_star", "k4_steps_all_blocks",
                                  "steps_each_to_own_end", "lockstep_steps",
                                  "trajectory_mismatches", "ended_by_t_star")}
            for k, v in frontier["sets"].items()
        },
        "frontier_node": frontier["node"],
        # phase 13's mesh node races across its 4 shards in K4's shard
        # form (its own entry below), so this is 0 there
        "launches_mesh_path": on_mesh["dfs_race"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(RACE_KERNELS)},
    }
    shard = mesh["race"]["shard"]
    shard_kernel = {
        "name": "dfs_race_shard_kernel",
        "route": "cuda",
        "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
        # the per-device body of the JAX mesh race (the shard_map'd lockstep
        # loop with its per-step psum early exit)
        "replaces": "sudoku_solver_distributed_tpu/parallel/frontier.py:337",
        # its path is the mesh's: phase 13's node, one launch a race (the
        # virtual mesh's 4 shards share the card, so one grid)
        "launches": on_mesh["dfs_race_shards"],
        "launches_mesh_path": on_mesh["dfs_race_shards"],
        # the relay's path (13(d)): each rank's launches over its relay races
        # (counted in its own process from 0 at its loop's start)
        "launches_relay_path": {name: rec["launches"]
                                for name, rec in mesh["relay"].items()},
        # the folded races against the plain race, and each state ended by
        # t* against K1's run of it
        "mismatches": mesh["race"]["mismatches"],
        "max_abs_err": mesh["race"]["max_abs_err"],
        # the one library call of the 4 shard launches, their last block
        # folding (CUDA events, median of 5), on the first phase 11 set, a
        # 9x9 deep board at 64 (128 states)
        "ms": shard["ms"],
        "plain_ms": shard["plain_ms"],
        "bound_ms": shard["bound_ms"],
        "bound_by": shard["bound_by"],
        "library_ms": None,
        "set": shard["set"],
        "states": shard["states"],
        "stop_layout": mesh["race"]["layout"],
        "mesh_race_by_set": mesh["race"]["sets"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(MESH_RACE_KERNELS[0])},
    }
    check(shard_kernel["launches"] > 0, "the mesh path launched no shard race kernel")
    fold = mesh["race"]["fold"]
    on_gather = {k: v["launches"]["race_fold"] for k, v in mesh["loop"].items()}
    fold_kernel = {
        "name": "race_fold_kernel",
        "route": "cuda",
        "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
        # the cross-device all_gather + argmax of the JAX mesh race
        "replaces": "sudoku_solver_distributed_tpu/parallel/frontier.py:359",
        # its path is the multi-host loop's (13(d): the README raced by each
        # loop, its records gathered, then folded), a fold a race; the
        # mesh node's races fold in their last block (0 there)
        "launches": sum(on_gather.values()),
        "launches_gather_path": on_gather,
        "launches_mesh_path": on_mesh["race_fold"],
        "mismatches": fold["mismatches"] + mesh["race"]["mismatches"],
        "max_abs_err": max(fold["max_abs_err"], mesh["race"]["max_abs_err"]),
        # the fold kernel alone over the README @512 race's 2048 records
        "ms": fold["ms"],
        "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"],
        "bound_by": fold["bound_by"],
        "library_ms": None,
        "states": fold["states"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("race_fold_kernel")},
    }
    check(fold_kernel["launches"] > 0, "the multi-host path launched no fold kernel")
    seeding = frontier["seeding"]
    main_seed = seeding["sets"][f"9x9 deep #0 @{FRONTIER_STATES}"]
    seed_kernel = {
        "name": SEED_KERNEL,
        "route": "cuda",
        "source": "sudoku_solver_distributed_tpu_torch/csrc/dfs_solver.cu",
        # the JAX package's jitted seeding programs (_seed_jits: analyze_j,
        # assign_j) and the host rounds that drive them (_seed_rounds, :194)
        "replaces": "sudoku_solver_distributed_tpu/parallel/frontier.py:54",
        # one launch of one thread-block cluster; each block's parts sweep a
        # state at a time with K4's block sweep; the round's decision
        # through distributed shared memory
        "design": "one thread-block cluster, parts of a block a state (K4's block sweep)",
        "cluster_blocks": seeding["cluster"],
        # phase 11's --frontier 64 node: one seeding a raced request
        "launches": on_frontier["seed_frontier_cuda"],
        "launches_frontier_path": on_frontier["seed_frontier_cuda"],
        # phase 13's mesh node (its races across 4 shards seed on the card)
        "launches_mesh_path": on_mesh["seed_frontier_cuda"],
        # 13(d): the README race through each loop, every host seeding alike
        "launches_loop_path": {k: v["launches"]["seed_frontier_cuda"]
                               for k, v in mesh["loop"].items()},
        "mismatches": seeding["mismatches"],
        "max_abs_err": seeding["max_abs_err"],
        # the node's own seeding: a deep 9x9 board at 64 states, locked
        "ms": main_seed["ms"],
        "plain_ms": main_seed["plain_ms"],
        "bound_ms": main_seed["bound_ms"],
        "bound_by": main_seed["bound_by"],
        "library_ms": None,
        "rounds": main_seed["rounds"],
        "analyzed": main_seed["analyzed"],
        "us_per_round": main_seed["us_per_round"],
        # the chain of its rounds, one K4 block sweep each (11 (c))
        "round_chain_floor_ms": main_seed["floor_ms"],
        "by_set": seeding["sets"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(SEED_KERNEL)},
    }
    check(seed_kernel["launches"] > 0 and seed_kernel["launches_mesh_path"] > 0,
          "the frontier and mesh paths launched no seeding kernel")
    print(json.dumps({"kernels": [kernel, *segment_kernels, race_kernel, shard_kernel,
                                  fold_kernel, seed_kernel]}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
