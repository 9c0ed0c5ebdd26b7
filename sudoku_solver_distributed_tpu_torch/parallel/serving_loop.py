"""SPMD multi-host serving loop on torch.distributed: the frontier race and
the coalesced batch fan-out across every host's shards.

The port of ``sudoku_solver_distributed_tpu/parallel/serving_loop.py``. A
``/solve`` reaches ONE host's HTTP thread, but a race or a batch over every
host's shards needs every host in the same program at the same point.
Every host runs the same loop:

    tick:    header = broadcast from rank 0 (idle | request | batch | stop)
    request: every host seeds the board alike on its own first device
             (the seeding kernel on a card: deterministic and exact, so
             every host holds the same states), races its slice of the
             padded states on its own shards, the hosts gather each
             other's run records and every host folds them
    batch:   boards = broadcast from rank 0; every host solves its row
             block on its shards; the hosts gather each other's rows
    rank 0:  hands the result back to the waiting HTTP thread

Two kinds of traffic, two groups:

  * headers and boards are host data (numpy on every host). They travel
    over a gloo group on every host (``host_group``, made with
    ``torch.distributed.new_group(backend="gloo")``), on GPU hosts too:
    no device copy, and a tick costs the card nothing;
  * the race's run records and the batch's rows are the device-side
    collectives. They go over the default group: NCCL on GPU hosts (CUDA
    tensors, all_gather), gloo on CPU hosts (CPU tensors). A GPU host
    whose default group is not NCCL is refused unless the caller asks for
    gloo with ``allow_gloo_on_cuda=True``; gloo then gathers copies on the
    host. The loop never picks gloo on a GPU host by itself.

Every collective is issued asynchronously and waited on with
``collective_timeout_s``; the groups get the same timeout when they are
made. A host that dies outside a collective (SIGKILL while the loop
idles) makes the others' next broadcast fail or stall: the loop thread
exits, or ``health()`` reports it stalled after ``stall_after_s``, and a
pending ``solve`` raises ``ServingLoopError`` instead of hanging, which
the engine answers from its bucket path (a fault of the device path).

A race's stop crosses hosts through the relay (parallel/relay.py), on
whenever the loop has more than one rank, as the JAX race's per-step
``psum`` always is: a thread on every host sends this host's solve posts
(the kernel's outbox) to the other hosts' relays in datagrams (their
addresses met through the process group's store) and writes theirs into
this host's inbox, which the shards' blocks read in turns, so every
host's shards stop soon after the first solve on any host. The fold over every host's gathered records (the fold
kernel) stays exact however late a post lands; a relay that fails is
logged and counted in ``health()``, as is a race another host solved
whose posts never reached this host (``missed``: the gathered records say
who solved), and the gather's timeout still decides a host that died.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from ..ops.solver import SOLVED
from ..ops.spec import SPEC_9, BoardSpec
from .relay import RaceRelay, relay_channel

logger = logging.getLogger(__name__)

_IDLE, _REQUEST, _STOP, _BATCH = 0, 1, 2, 3
_POLL_S = 0.05  # idle tick cadence; latency floor for a quiet cluster


class ServingLoopError(RuntimeError):
    """The serving loop could not answer: it died, a collective failed, or
    no result came in time. A fault of the multi-host device path
    (``engine.device_fault``), answered from the bucket path."""


class ServingLoopTimeout(ServingLoopError, TimeoutError):
    """No result from the serving loop within the caller's timeout."""


class FrontierServingLoop:
    """Lockstep serving across all ranks of a torch.distributed group.

    Construct (with identical arguments) and ``start()`` on EVERY rank,
    after ``torch.distributed.init_process_group``. ``mesh`` is this
    host's own shards (parallel/mesh.py); the global mesh is every rank's,
    rank by rank. Rank 0 additionally calls ``solve``/``solve_padded`` per
    request and ``stop()`` at shutdown; the other ranks follow through the
    broadcasts.
    """

    _made = 0  # loops made in this process: each relays on a channel of its own

    def __init__(
        self,
        mesh,
        spec: BoardSpec = SPEC_9,
        *,
        states_per_device: int = 64,
        max_depth: Optional[int] = None,
        locked: bool = False,
        waves: int = 1,
        naked_pairs: Optional[bool] = None,
        max_restarts: int = 2,
        stall_after_s: float = 30.0,
        collective_stall_after_s: float = 600.0,
        collective_timeout_s: float = 600.0,
        allow_gloo_on_cuda: bool = False,
    ):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "FrontierServingLoop needs torch.distributed.init_process_group "
                "first (the CLI's --coordinator/--num-hosts/--host-id)"
            )
        self.mesh = mesh
        self.spec = spec
        self.states_per_device = states_per_device
        self.max_depth = max_depth
        self.locked = locked  # must be identical on every rank
        self.waves = waves    # ditto
        self.naked_pairs = naked_pairs  # ditto
        self.max_restarts = max_restarts  # ditto
        # liveness thresholds: an idle loop ticks every _POLL_S, so a tick
        # that has not completed in ``stall_after_s`` means this rank is
        # wedged; a collective solve is legitimately slow and gets its own
        self.stall_after_s = stall_after_s
        self.collective_stall_after_s = collective_stall_after_s
        self.timeout = timedelta(seconds=float(collective_timeout_s))
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.is_leader = self.rank == 0
        self.backend = str(dist.get_backend())
        on_cuda = mesh.primary.type == "cuda"
        if on_cuda and self.backend != "nccl" and not allow_gloo_on_cuda:
            raise ValueError(
                f"a GPU host's serving loop gathers over NCCL, but the default "
                f"group is {self.backend!r}; pass allow_gloo_on_cuda=True to "
                "gather host copies over gloo instead"
            )
        # the device-side collectives' tensors: CUDA under NCCL, else the
        # host (gloo gathers CPU tensors)
        self._collective_device = (
            mesh.primary if on_cuda and self.backend == "nccl" else torch.device("cpu")
        )
        self.host_group = (
            dist.new_group(backend="gloo", timeout=self.timeout)
            if self.backend != "gloo" else None
        )
        # the race's early exit across hosts: always on above one rank, its
        # channel one of this loop's own (every rank makes its loops in the
        # same order, as its groups)
        FrontierServingLoop._made += 1
        self.relay = None
        if self.world > 1:
            store, host = relay_channel(f"race-relay-{FrontierServingLoop._made}")
            self.relay = RaceRelay(store, self.rank, self.world, host=host)
        self.restarts = 0
        self.batches = 0
        self._last_tick = time.monotonic()
        self._collective_since: Optional[float] = None
        self._requests: queue.Queue = queue.Queue()
        self._results: queue.Queue = queue.Queue()
        self._solve_mutex = threading.Lock()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._batch_program = None  # enable_batch_fanout
        self._pending_batch = None  # leader: boards riding the next header
        self._req_seq = 0

    # -- collectives -------------------------------------------------------
    def _wait(self, work) -> None:
        """Wait for an asynchronous collective, bounded by the timeout."""
        if work is not None:
            work.wait(timeout=self.timeout)

    def _broadcast_host(self, buf: np.ndarray) -> np.ndarray:
        """Rank 0's int32 host buffer on every rank (the gloo group)."""
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(buf, np.int32))
        self._wait(dist.broadcast(t, src=0, group=self.host_group, async_op=True))
        return t.numpy()

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's equal-shaped ``t``, concatenated in rank order on
        ``t``'s device (the device-side group: NCCL on GPU hosts)."""
        import torch.distributed as dist

        src = t.contiguous().to(self._collective_device)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        self._wait(dist.all_gather(parts, src, async_op=True))
        return torch.cat(parts).to(t.device)

    def _gather_records(self, meta: torch.Tensor, grid: torch.Tensor):
        """The race's cross-host step: every host's run records."""
        return self._all_gather(meta), self._all_gather(grid)

    # -- internals ---------------------------------------------------------
    def _payload(self, flag: int, board=None, req_id: int = 0, a: int = 0,
                 b: int = 0) -> np.ndarray:
        # [flag | request id | a | b | flattened board]: the id lets the
        # leader match results to requests (a late result of a timed-out
        # solve is never handed to the next caller); a/b are the batch
        # lane's width and step budget
        C = self.spec.cells
        buf = np.zeros((C + 4,), np.int32)
        buf[0] = flag
        buf[1] = req_id
        buf[2] = a
        buf[3] = b
        if board is not None:
            buf[4:] = np.asarray(board, np.int32).reshape(C)
        return buf

    def _solve_collective(self, board: np.ndarray, race: int):
        """Race one board across every host's shards; ``race`` (the
        request id, the same on every rank) names the race to the relay."""
        from .frontier import frontier_solve

        solved = []  # from the gathered records: by rank, whether it solved

        def gather(meta, grid):
            meta, grid = self._gather_records(meta, grid)
            solved.append((meta[:, 0] == SOLVED).reshape(self.world, -1).any(1))
            return meta, grid

        link = (self.relay.begin(race, card=self.mesh.primary.type == "cuda")
                if self.relay is not None else None)
        elsewhere = False
        try:
            out = frontier_solve(
                board.reshape(self.spec.size, self.spec.size),
                self.mesh,
                self.spec,
                states_per_device=self.states_per_device,
                max_depth=self.max_depth,
                locked=self.locked,
                waves=self.waves,
                naked_pairs=self.naked_pairs,
                hosts=(self.rank, self.world,
                       gather if link is not None else self._gather_records, link),
            )
            elsewhere = bool(solved) and any(
                s for r, s in enumerate(solved[0].tolist()) if r != self.rank)
            return out
        finally:
            if link is not None:
                self.relay.finish(link, elsewhere)

    def _solve_batch_collective(self, header: np.ndarray) -> np.ndarray:
        """The batch lane: a second broadcast carries the padded bucket
        batch, every rank solves its row block on its shards (the sharded
        bucket program), and the ranks gather the rows. Returns the packed
        (bucket, C+6) host rows, the LoopStats columns summed over every
        rank's shards."""
        bucket, iters = int(header[2]), int(header[3])
        C, N = self.spec.cells, self.spec.size
        if self.is_leader and self._pending_batch is not None:
            flat = np.ascontiguousarray(self._pending_batch, np.int32).reshape(bucket * C)
        else:
            flat = np.zeros((bucket * C,), np.int32)
        boards = self._broadcast_host(flat).reshape(bucket, N, N)
        per = bucket // self.world
        mine = boards[self.rank * per:(self.rank + 1) * per]
        rows = self._batch_program(mine, iters)
        out = self._all_gather(torch.from_numpy(np.ascontiguousarray(rows))).numpy()
        for c in (C + 4, C + 5):
            out[:, c] = int(out[::per, c].astype(np.int64).sum())
        return out

    def _run_round(self) -> str:
        """One broadcast/solve loop; returns why it exited: "stop" on the
        leader's STOP broadcast, "failed" after a failed collective."""
        while True:
            self._pending_batch = None
            if self.is_leader:
                try:
                    payload, self._pending_batch = self._requests.get(timeout=_POLL_S)
                except queue.Empty:
                    payload = self._payload(_IDLE)
            else:
                payload = self._payload(_IDLE)  # ignored off the leader
            buf = self._broadcast_host(payload)
            self._last_tick = time.monotonic()  # heartbeat: the tick is done
            flag, req_id = int(buf[0]), int(buf[1])
            if flag == _STOP:
                return "stop"
            if flag == _IDLE:
                continue
            try:
                self._collective_since = time.monotonic()
                if flag == _BATCH:
                    logger.info("serving loop: fanning out a coalesced batch "
                                "(%d boards)", int(buf[2]))
                    result = (req_id, "ok", self._solve_batch_collective(buf))
                    self.batches += 1
                else:
                    logger.info("frontier serving loop: racing a board (%d clues)",
                                int((buf[4:] > 0).sum()))
                    result = (req_id, "ok", self._solve_collective(buf[4:], req_id))
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                # a failed collective may leave the ranks out of step: leave
                # the round rather than risk a deadlocked next broadcast
                logger.exception("frontier serving loop: solve failed")
                if self.is_leader:
                    self._results.put((req_id, "error", ServingLoopError(
                        f"serving loop collective failed: {e}")))
                return "failed"
            finally:
                # the tick before the marker: the other order leaves a
                # window where health() reads a stale tick and no marker
                self._last_tick = time.monotonic()
                self._collective_since = None
            if self.is_leader:
                self._results.put(result)

    def _run(self) -> None:
        """Re-enter the loop after a failed collective, up to
        ``max_restarts`` times; a collective that fails fails on every
        rank, so every rank re-enters at the same tick. A broadcast that
        fails (a peer died outside a collective) ends the thread; queued
        leader requests are answered with an error either way."""
        try:
            while True:
                reason = self._run_round()
                if reason == "stop":
                    return
                if self.restarts >= self.max_restarts:
                    logger.error(
                        "frontier serving loop: %d failures — giving up; "
                        "single-board solves fall back to the bucket path",
                        self.restarts + 1,
                    )
                    return
                self.restarts += 1
                logger.warning("frontier serving loop: restarting after "
                               "failure (%d/%d)", self.restarts, self.max_restarts)
        except Exception:  # noqa: BLE001 — a dead peer ends the loop
            logger.exception("frontier serving loop: broadcast failed — the "
                             "loop stops; requests fall back to the bucket path")
        finally:
            if self.relay is not None:
                self.relay.stop()
            self._stopped.set()
            if self.is_leader:
                while True:
                    try:
                        self._requests.get_nowait()
                    except queue.Empty:
                        break
                    self._results.put(
                        (-1, "error", ServingLoopError("frontier serving loop died"))
                    )

    # -- batch fan-out -----------------------------------------------------
    def enable_batch_fanout(self, engine) -> None:
        """Arm the coalesced-batch lane. Call on EVERY rank, with the same
        engine configuration, BEFORE ``start()``: the sharded bucket
        program over this rank's shards, with the engine's resolved
        knobs, the same memoized program the engine's own mesh dispatch
        uses. The CLI then points ``engine.mesh_runner`` at
        ``solve_padded`` on the leader."""
        from .shard import make_packed_serving_program

        self._batch_program = make_packed_serving_program(
            self.mesh,
            engine.spec,
            max_depth=engine.max_depth,
            locked_candidates=engine.locked_candidates,
            waves=engine.waves,
            naked_pairs=engine.naked_pairs,
        )

    def solve_padded(self, boards: np.ndarray, iters: int,
                     timeout: float = 600.0) -> np.ndarray:
        """Leader only: fan one PADDED bucket batch out across every
        rank's shards. ``boards`` is (bucket, N, N), bucket divisible by
        the global shard count, as ``engine._dispatch_padded`` hands its
        ``mesh_runner``. Returns the packed (bucket, C+6) host rows. Raises
        ``ServingLoopError`` if the loop died or the collective failed."""
        if self._batch_program is None:
            raise RuntimeError(
                "batch fan-out not armed — call enable_batch_fanout() on "
                "every rank before start()"
            )
        boards = np.asarray(boards, np.int32)
        if boards.shape[0] % (self.world * self.mesh.size):
            raise ValueError(
                f"a fan-out batch of {boards.shape[0]} does not divide the "
                f"{self.world * self.mesh.size}-shard global mesh"
            )
        header = self._payload(_BATCH, a=int(boards.shape[0]), b=int(iters))
        return self._roundtrip(header, boards, timeout)

    # -- public API --------------------------------------------------------
    def health(self) -> dict:
        """Liveness for operator surfaces (engine.health → /metrics):
        ``alive`` goes False when the loop stopped, or when no tick
        completed within ``stall_after_s`` while idle, or a collective has
        run past ``collective_stall_after_s``. ``relay`` (above one rank):
        the relay thread's ``RaceRelay.health()``: alive, races, posts sent
        and delivered, errors and the last error, races missed (another
        host solved, none of its posts came) and late, the last race's
        posts."""
        now = time.monotonic()
        started = self._thread is not None
        stalled = False
        if started and not self._stopped.is_set():
            since = self._collective_since
            if since is not None:
                stalled = now - since > self.collective_stall_after_s
            else:
                stalled = now - self._last_tick > self.stall_after_s
        return {
            "alive": started and not self._stopped.is_set() and not stalled,
            "started": started,
            "stalled": stalled,
            "last_tick_age_s": round(now - self._last_tick, 1),
            "restarts": self.restarts,
            "batches": self.batches,
            **({"relay": self.relay.health()} if self.relay is not None else {}),
        }

    def start(self, warm_race: bool = True) -> None:
        """Start the loop thread (every rank). The leader warms the race
        path by racing one empty board through the loop, unless
        ``warm_race=False`` (a fan-out-only loop warms its bucket widths
        with ``warm_batch_fanout``). Above one rank the race's relay
        thread starts first."""
        if self.relay is not None:
            self.relay.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-loop")
        self._thread.start()
        if self.is_leader and warm_race:
            self.solve(np.zeros((self.spec.size, self.spec.size), np.int32))

    def warm_batch_fanout(self, bucket: int, iters: int) -> None:
        """Leader only, after ``start()``: one bucket of instantly-UNSAT
        pad boards through the fan-out lane, so every rank has launched
        the bucket program at that width before real traffic does."""
        from ..ops.solver import pad_board

        boards = np.broadcast_to(
            pad_board(self.spec).numpy(), (bucket, self.spec.size, self.spec.size)
        )
        self.solve_padded(np.ascontiguousarray(boards), iters)

    def solve(self, board, timeout: float = 600.0):
        """Leader only: race one board across every rank's shards. Returns
        (solution | None, info) like ``frontier_solve``. Serialized; raises
        ``ServingLoopError`` if the loop died or the collective failed,
        never hangs the caller."""
        return self._roundtrip(self._payload(_REQUEST, board), None, timeout)

    def _roundtrip(self, header: np.ndarray, extra, timeout: float):
        """Submit one request (race or batch fan-out) and await ITS
        result."""
        if not self.is_leader:
            raise RuntimeError("solve() is for rank 0; the other ranks follow")
        with self._solve_mutex:
            if self._stopped.is_set():
                raise ServingLoopError("frontier serving loop is stopped")
            self._req_seq += 1
            my_id = self._req_seq
            header[1] = my_id
            self._requests.put((header, extra))
            deadline = time.monotonic() + timeout

            def _next(block_s: float):
                """The next result for THIS request; older ids are late
                answers of a timed-out call (-1: the final drain)."""
                end = time.monotonic() + block_s
                while True:
                    left = end - time.monotonic()
                    if left <= 0:
                        raise queue.Empty
                    rid, kind, value = self._results.get(timeout=left)
                    if rid == my_id or rid == -1:
                        return kind, value
                    logger.warning("frontier serving loop: discarding stale "
                                   "result (request %d, now serving %d)", rid, my_id)

            while True:
                try:
                    kind, value = _next(0.1)
                    break
                except queue.Empty:
                    if self._stopped.is_set():
                        try:
                            kind, value = _next(1.0)
                            break
                        except queue.Empty:
                            raise ServingLoopError(
                                "frontier serving loop died"
                            ) from None
                    if time.monotonic() > deadline:
                        raise ServingLoopTimeout(
                            f"frontier serving loop: no result in {timeout}s"
                        ) from None
            if kind == "error":
                raise value
            return value

    def stop(self) -> None:
        """Leader only: stop the loop on every rank (via the broadcast)."""
        if self.is_leader and not self._stopped.is_set():
            self._requests.put((self._payload(_STOP), None))
        self._stopped.wait(timeout=30)
        if self.relay is not None:
            self.relay.stop()

    def join(self, timeout: Optional[float] = None) -> None:
        """The other ranks: block until the leader broadcasts STOP (or the
        loop dies)."""
        self._stopped.wait(timeout=timeout)
