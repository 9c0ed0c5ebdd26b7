"""The race's early exit across hosts (parallel/relay.py), on the CPU.

A race across hosts runs each host's slice of the seeded states on its own
shards; the JAX package stops every device of every host at the first
solve with a per-step ``psum``. The port relays each host's solve posts to
the others while the race runs, and the plain race polls the relayed step
once a step (``race_runs(..., stop=)``). Here: a posted step halts the
plain race at exactly that step, and the fold over the halted records is
still the JAX race's row; two relays (datagrams on loopback, addresses
met through one in-process store) carry a post from one host's race to
the other's; a post of an earlier race, a stranger's datagram, no post,
and a relay that cannot find the other hosts leave today's runs; two gloo ranks race a deep
board through the serving loop with the relay on, as JAX's 4-device mesh
answers it, no state halting before t*. The kernel's inbox and outbox are
held to the plain version on the card (tests/test_torch_isolation.py).
"""

import json
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sudoku_solver_distributed_tpu.ops import SPEC_9 as JAX_SPEC_9
from sudoku_solver_distributed_tpu.parallel import frontier as JF
from sudoku_solver_distributed_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sudoku_solver_distributed_tpu_torch.ops import SPEC_9
from sudoku_solver_distributed_tpu_torch.ops.cuda_solver import dfs_race_shards, sweep_knobs
from sudoku_solver_distributed_tpu_torch.ops.solver import RUNNING, SOLVED, fold_race, race_runs
from sudoku_solver_distributed_tpu_torch.parallel import frontier as TF
from sudoku_solver_distributed_tpu_torch.parallel import sim
from sudoku_solver_distributed_tpu_torch.parallel.relay import RaceRelay

DEEP9 = np.load("benchmarks/corpus_9x9_deep_128.npz")["boards"]
CFG = dict(locked_candidates=True, waves=3, naked_pairs=False)
MAX_ITERS = JF.DEFAULT_MAX_ITERS
CHILD_TIMEOUT_S = 120


def _board(k: int) -> np.ndarray:
    """Deep board 12 under a symmetry: ``k`` 0 as stored (host 0's half
    has no solve and runs 106 steps, host 1's solves at 59), 5 rotated
    and transposed (host 0 runs 186, host 1 solves at 25)."""
    b = np.rot90(DEEP9[12], k % 4)
    return np.ascontiguousarray(b.T if k >= 4 else b)


def _hosts(board):
    """The states a 2-host, 2-shards-a-host race of 8 a shard runs, and
    each host's half."""
    states, early = TF.seed_frontier(board, SPEC_9, target=32, locked=True, device="cpu")
    assert early is None
    states = TF.bucket_states(states, SPEC_9, 8, 4).numpy()
    half = len(states) // 2
    return states, (states[:half], states[half:])


def _runs(part, stop=None):
    return race_runs(torch.from_numpy(np.ascontiguousarray(part)), SPEC_9, MAX_ITERS,
                     SPEC_9.max_depth, stop=stop, **sweep_knobs(SPEC_9, **CFG))


def _first_solve(meta) -> int:
    solved = meta[:, 0] == SOLVED
    assert bool(solved.any())
    return int(meta[solved, 1].min())


def _jax_row(states) -> np.ndarray:
    racer = JF._make_racer(jax_default_mesh(jax.devices()[:2]), JAX_SPEC_9, MAX_ITERS,
                           SPEC_9.max_depth, True, CFG["waves"], False)
    return np.asarray(racer(jnp.asarray(states)))


def _fold(parts):
    meta = torch.cat([m for m, _ in parts])
    grid = torch.cat([g for _, g in parts])
    return fold_race(meta, grid, SPEC_9, CFG["waves"])


@pytest.mark.parametrize("k, past", [(0, 0), (0, 4), (5, 0), (5, 30)])
def test_a_remote_post_halts_the_plain_race_at_its_step(k, past):
    """A host's plain race given, before it starts, a step ``s`` another
    host posted halts at exactly ``s``: every state it leaves RUNNING has
    run ``s`` steps and none ran more. Its records folded with the solving
    host's give JAX's race row over both halves, as its full runs do."""
    states, (quiet, solving) = _hosts(_board(k))
    solver = _runs(solving)
    t_star = _first_solve(solver[0])
    own = _runs(quiet)
    assert int(own[0][:, 1].max()) > t_star + past  # it would run on past s
    s = t_star + past
    halted = _runs(quiet, stop=lambda: s)
    status, steps = halted[0][:, 0], halted[0][:, 1]
    assert int(steps.max()) == s and bool((steps[status == RUNNING] == s).all())
    row, fold = _fold([halted, solver])
    want = _jax_row(states)
    assert np.array_equal(row.numpy(), want)
    full_row, full_fold = _fold([own, solver])
    assert torch.equal(row, full_row) and torch.equal(fold, full_fold)


def _pair(store=None):
    store = dist.HashStore() if store is None else store
    relays = [RaceRelay(store, r, 2) for r in (0, 1)]
    for r in relays:
        r.start()
    return store, relays


def _stop(relays):
    for r in relays:
        r.stop()
    assert not any(r.alive for r in relays)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def test_a_post_relayed_between_two_hosts_halts_the_other_host():
    """Two hosts' relays (datagrams on loopback, addresses met through one
    store): host 1's plain race posts its solve through the shards'
    wrapper, the relay carries it to host 0, whose race, started after it
    landed, halts at exactly that step; the fold over both is JAX's row.
    Each thread ends with ``stop``."""
    states, (quiet, solving) = _hosts(_board(0))
    _, (r0, r1) = _pair()
    try:
        l0, l1 = r0.begin(7), r1.begin(7)
        n = len(solving) // 2
        parts = [torch.from_numpy(np.ascontiguousarray(solving[i * n:(i + 1) * n].reshape(
            n, -1))) for i in (0, 1)]
        runs = dfs_race_shards(parts, SPEC_9, SPEC_9.max_depth, MAX_ITERS, relay=l1, **CFG)
        l1.local_done()
        t_star = _first_solve(torch.cat([m for m, _ in runs]))
        assert l1.stop_step() == t_star
        _wait(lambda: l0.stop_step() is not None)
        assert l0.stop_step() == t_star and l0.remote == t_star
        halted = _runs(quiet, stop=l0.stop_step)
        l0.local_done()
        assert int(halted[0][:, 1].max()) == t_star
        for relay, link in ((r0, l0), (r1, l1)):
            relay.finish(link)
            assert link.quiet.is_set()
        row, _ = _fold([halted, (torch.cat([m for m, _ in runs]),
                                 torch.cat([g for _, g in runs]))])
        assert np.array_equal(row.numpy(), _jax_row(states))
        h0, h1 = r0.health(), r1.health()
        assert h1["posts_sent"] == 1 and h0["posts_delivered"] == 1
        assert h0["errors"] == h1["errors"] == h0["foreign"] == 0
        assert h0["last"]["received_step"] == t_star and h1["last"]["sent_step"] == t_star
    finally:
        _stop((r0, r1))


def test_a_post_of_an_earlier_race_is_dropped_and_no_post_changes_nothing():
    """A post of race 7 that lands while race 8 runs is dropped: no host of
    race 8 takes it, and race 8's plain runs with the relay (no post of
    its own) equal today's runs, step for step. A post of a race a host
    has not begun yet waits for that race; a datagram from an address that
    is no other host's relay is ignored; a host sends only a step below
    every one it sent in the race."""
    _, (quiet, _) = _hosts(_board(0))
    _, (r0, r1) = _pair()
    try:
        l0 = r0.begin(8)
        _wait(lambda: l0.picked)
        r1._sock.sendto(b"7:3", r0.address)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as stranger:
            stranger.sendto(b"8:1", r0.address)
        _wait(lambda: r0.health()["foreign"] == 1)
        time.sleep(0.05)  # the thread has read its socket many times since
        assert l0.stop_step() is None
        with_relay, own = _runs(quiet, stop=l0.stop_step), _runs(quiet)
        assert torch.equal(with_relay[0], own[0]) and torch.equal(with_relay[1], own[1])
        l0.local_done()
        r0.finish(l0)
        assert r0.health()["posts_delivered"] == 0
        # host 1 runs ahead: its posts of race 9 reach host 0 before host 0
        # begins race 9, and only its lower steps go out
        l1 = r1.begin(9)
        for s, sent in ((9, 1), (5, 2), (12, 2)):
            l1.post(s)
            _wait(lambda: r1.health()["posts_sent"] == sent)
        time.sleep(0.05)
        assert r1.health()["posts_sent"] == 2 and l1.sent_step == 9
        l0 = r0.begin(9)
        _wait(lambda: l0.stop_step() is not None)
        assert l0.stop_step() == 5
        for relay, link in ((r0, l0), (r1, l1)):
            link.local_done()
            relay.finish(link)
        assert r0.health()["posts_delivered"] in (1, 2)  # 9, then 5 (or 5 alone)
    finally:
        _stop((r0, r1))


class _BrokenStore:
    """A store that takes a relay's address but never shows it the other
    hosts' (a host that lost the store)."""

    def set(self, key, value):
        pass

    def check(self, keys):
        raise RuntimeError("store unreachable")


def test_a_relay_that_cannot_find_the_other_hosts_reports_it_and_never_stops_a_race():
    """A relay that cannot learn the other hosts' addresses logs and counts
    it and reports it in its health, delivers nothing, and the race runs
    as it would without a relay (no stop of its own making); the thread
    lives on."""
    _, (quiet, _) = _hosts(_board(0))
    relay = RaceRelay(_BrokenStore(), 1, 2)
    relay.start()
    try:
        link = relay.begin(3)
        _wait(lambda: relay.health()["errors"] >= 1)
        assert link.stop_step() is None and link.failed
        assert torch.equal(_runs(quiet, stop=link.stop_step)[0], _runs(quiet)[0])
        link.local_done()
        relay.finish(link)
        h = relay.health()
        assert h["alive"] and "store unreachable" in h["last_error"]
    finally:
        relay.stop()
    assert not relay.alive


def test_a_race_whose_posts_are_dropped_is_counted_missed_and_a_late_one_late():
    """A datagram lost on the way leaves no error on either side: host 1's
    posts of race 5 go to an address host 0 never reads (a sink standing
    in for a filtered port), host 1 counts them sent, and host 0's race
    runs without a stop. Told at ``finish`` that another host solved the
    race, host 0 waits ``RELAY_LATE_S`` for a post of it, counts the race
    missed and reports it in its health, with no error. A post that lands
    after host 0's race ended but before its ``finish`` counts late; a race
    nobody else solved counts neither."""
    from sudoku_solver_distributed_tpu_torch.parallel.relay import RELAY_LATE_S

    store, (r0, r1) = _pair()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sink:
        sink.bind(("127.0.0.1", 0))
        try:
            # a post that lands after host 0's race ended: late
            l0, l1 = r0.begin(4), r1.begin(4)
            l0.local_done()
            _wait(lambda: l0.quiet.is_set())
            l1.post(9)
            _wait(lambda: r1.health()["posts_sent"] == 1)
            r0.finish(l0, solved_elsewhere=True)
            l1.local_done()
            r1.finish(l1)
            assert (r0.health()["late"], r0.health()["missed"]) == (1, 0)
            # host 1's datagrams to host 0 go to the sink from here on
            r1._peers = (sink.getsockname(),)
            l0, l1 = r0.begin(5), r1.begin(5)
            l1.post(7)
            _wait(lambda: r1.health()["posts_sent"] == 2)
            assert l0.stop_step() is None
            l0.local_done()
            _wait(lambda: l0.quiet.is_set())
            t0 = time.monotonic()
            r0.finish(l0, solved_elsewhere=True)
            assert time.monotonic() - t0 >= RELAY_LATE_S
            l1.local_done()
            r1.finish(l1)
            h0 = r0.health()
            assert (h0["missed"], h0["late"], h0["errors"], h0["posts_delivered"]) == (1, 1, 0, 0)
            assert h0["last"]["race"] == 5 and not h0["last"]["heard"]
            assert r1.health()["errors"] == 0 and sink.recv(64) == b"5:7"
            # a race no other host solved: nothing is missed
            l0 = r0.begin(6)
            l0.local_done()
            r0.finish(l0)
            assert (r0.health()["missed"], r0.health()["late"]) == (1, 1)
        finally:
            _stop((r0, r1))


# two ranks of the serving loop (2 shards each) race one deep board with
# the relay on; each prints every race's gathered records and its relay's
# health, the leader the answer. argv: rank, port, board
_RANK = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch.distributed as dist

rank, port, board = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank, timeout=timedelta(seconds=60))
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, default_mesh

loop = FrontierServingLoop(default_mesh(), states_per_device=8, locked=True, waves=3,
                           naked_pairs=False, collective_timeout_s=60)
records = []
gather = loop._gather_records
def tap(meta, grid):
    meta, grid = gather(meta, grid)
    records.append(meta.tolist())
    return meta, grid
loop._gather_records = tap
loop.start(warm_race=False)
out = {"rank": rank, "relay_alive": loop.relay.alive}
if rank == 0:
    out["race"] = loop.solve(np.asarray(board, np.int32))
    out["health"] = loop.health()
    loop.stop()
else:
    loop.join(timeout=100)
    out["health"] = loop.health()
out["records"] = records
out["relay_alive_after_stop"] = loop.relay.alive
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def test_two_ranks_race_a_deep_board_with_the_relay_as_the_jax_four_device_mesh():
    """Two gloo ranks of the serving loop race deep board 12 (rank 1's
    shards hold its first solve, rank 0's run 106 steps alone): the answer
    and counters are JAX's 4-device mesh race's; in the gathered records
    no state halted RUNNING before t*; both relays saw the race, with no
    error, and ended with the loop."""
    board = _board(0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(port), json.dumps(board.tolist())],
        env=sim.virtual_mesh_env(2, device="cpu"), cwd=sim.REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in ranks] == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    lead, follow = (json.loads([ln for ln in o.splitlines() if ln.startswith("{")][-1])
                    for o in outs)
    want = JF.frontier_solve(board, jax_default_mesh(jax.devices()[:4]), JAX_SPEC_9,
                             states_per_device=8, locked=True, waves=3, naked_pairs=False)
    assert lead["race"] == list(want)
    for out in (lead, follow):
        (meta,) = out["records"]
        meta = np.asarray(meta)
        solved = meta[:, 0] == SOLVED
        t_star = int(meta[solved, 1].min())
        assert (meta[meta[:, 0] == RUNNING, 1] >= t_star).all()
        relay = out["health"]["relay"]
        assert relay["races"] == 1 and relay["errors"] == 0, relay
        assert out["relay_alive"] and not out["relay_alive_after_stop"]
    # the solve is rank 1's, so rank 1 sent it
    assert follow["health"]["relay"]["posts_sent"] == 1
    assert lead["records"] == follow["records"]


def test_relays_under_a_short_switch_interval_keep_every_race_s_least_post():
    """Stress: two relays serve 40 races back to back, each host's race
    posting a few random steps while the relay threads run and the
    interpreter switches threads every 10 µs; every race's link on each host ends
    with the other host's least post of that race, never another race's
    and never a lost lower one. Time-bounded."""
    rng = np.random.default_rng(7)
    interval = sys.getswitchinterval()
    _, relays = _pair()
    try:
        sys.setswitchinterval(1e-5)
        for race in range(1, 41):
            links = [r.begin(race) for r in relays]
            posts = [rng.integers(5, 500, size=rng.integers(1, 4)).tolist() for _ in relays]
            for link, steps in zip(links, posts):
                for step in steps:
                    link.post(step)
            for k, link in enumerate(links):
                _wait(lambda link=link, want=min(posts[1 - k]): link.remote == want)
            for relay, link in zip(relays, links):
                link.local_done()
                relay.finish(link)
                assert link.quiet.is_set()
            assert [link.stop_step() for link in links] == [min(min(p) for p in posts)] * 2
    finally:
        sys.setswitchinterval(interval)
        _stop(relays)
    assert all(r.health()["errors"] == 0 and r.health()["foreign"] == 0 for r in relays)


def test_relay_threads_stop_even_mid_race():
    """``stop`` ends a relay thread that is serving a race nobody
    finished, within its join timeout."""
    _, relays = _pair()
    links = [r.begin(1) for r in relays]
    _wait(lambda: all(link.picked for link in links))
    t0 = time.monotonic()
    _stop(relays)
    assert time.monotonic() - t0 < 2.0
