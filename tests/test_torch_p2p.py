"""The port's P2P plane held against the JAX node's: clusters of real nodes
exchanging real UDP datagrams on localhost, on the CPU.

Each case runs a port cluster and, where the two can be compared, the same
cluster of JAX nodes: join and network view, 4-node convergence, a farmed
README solve (one worker, so the farm's dispatch order is deterministic: the
answer and every node's validations must be equal, tolerance 0), an UNSAT
board, the spoofed self-disconnect, goodbye against rumour, the failure
cases of ``tests/test_net_failure.py`` (crash detection, the detector off, a
solve past a crashed worker, a graceful departure) and mixed clusters of
both packages, whose farms must complete with the unique solution in both
directions: the datagrams interoperate. Engines are CPU engines with
``buckets=(1,)``; boards have a few holes, except for the README farm.
"""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.net import wire as jax_wire
from sudoku_solver_distributed_tpu.net.node import P2PNode as JaxNode
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.models.oracle import oracle_solve
from sudoku_solver_distributed_tpu_torch.net import wire
from sudoku_solver_distributed_tpu_torch.net.http_api import make_http_server
from sudoku_solver_distributed_tpu_torch.net.node import P2PNode
from sudoku_solver_distributed_tpu_torch.utils.profiling import RequestMetrics

PORT, JAX = "port", "jax"
NODE = {PORT: P2PNode, JAX: JaxNode}


def make_engine(pkg):
    eng = (SolverEngine(device="cpu", buckets=(1,)) if pkg == PORT
           else JaxEngine(buckets=(1,)))
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engines():
    """One shared engine per package, for the cases that count nothing."""
    out = {pkg: make_engine(pkg) for pkg in (PORT, JAX)}
    yield out
    for eng in out.values():
        eng.close()


def free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_for(pred, timeout=10.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _bound(node) -> bool:
    try:
        return node.sock.getsockname()[1] == node.port
    except OSError:
        return False


def start_node(pkg, engine, anchor=None, **kw):
    """A running node on a free port. ``free_port`` closes its probe socket
    before the node binds, so another process may take the port in
    between: a node whose ``run`` died binding is rebuilt on another."""
    for _ in range(3):
        node = NODE[pkg]("127.0.0.1", free_port(), anchor_node=anchor,
                         handicap=0.0, engine=engine, **kw)
        t = threading.Thread(target=node.run, daemon=True)
        t.start()
        wait_for(lambda: _bound(node) or not t.is_alive(), timeout=5.0)
        if t.is_alive() and _bound(node):
            return node, t
        node.shutdown()
    raise RuntimeError("no free UDP port would bind")


class Cluster:
    """N running nodes wired as the reference README launches them: node 0
    is the anchor, the others join with ``-a`` pointing at it. ``pkgs``
    names each node's package; ``engines`` gives each its engine."""

    def __init__(self, pkgs, engines, **kw):
        self.nodes, self.threads = [], []
        try:
            anchor = None
            for pkg, eng in zip(pkgs, engines):
                node, t = start_node(pkg, eng, anchor=anchor, **kw)
                anchor = anchor or node.id
                self.nodes.append(node)
                self.threads.append(t)
        except BaseException:
            self.stop()
            raise

    def converged(self, timeout=10.0) -> bool:
        want = {n.id for n in self.nodes}
        return wait_for(lambda: all(
            set(n.membership.total_peers()) | {n.id} == want
            for n in self.nodes), timeout=timeout)

    def stop(self):
        for node in self.nodes:
            if not node.shutdown_flag:
                node.shutdown()
        for t in self.threads:
            t.join(timeout=5)


def crash(node):
    """SIGKILL-equivalent: the loop stops with no disconnect message."""
    node.shutdown_flag = True
    node.sock.close()


def renamed(view, nodes):
    """A network view with node ids replaced by their index in the cluster
    (ports differ between two clusters)."""
    names = {n.id: f"n{k}" for k, n in enumerate(nodes)}
    return {names[k]: sorted(names[p] for p in v) for k, v in view.items()}


def few_holes(seed, holes):
    """A unique-solution board with ``holes`` empty cells, and its solution."""
    full = np.asarray(oracle_solve(
        generate_batch(1, 30, size=9, seed=seed, unique=True)[0].tolist()))
    rng = np.random.default_rng(seed)
    board = full.copy()
    board.flat[rng.choice(81, size=holes, replace=False)] = 0
    return board.tolist(), full.tolist()


def _clues_kept(board, solution) -> bool:
    b = np.asarray(board)
    return bool((np.asarray(solution)[b > 0] == b[b > 0]).all())


# -- clusters of one package ---------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_join_and_network_view_match_jax(engines, n):
    """The anchor join converges, every node holds one view, and the view
    is the JAX cluster's with node ids renamed."""
    views = {}
    for pkg in (JAX, PORT):
        c = Cluster([pkg] * n, [engines[pkg]] * n)
        try:
            assert c.converged(), [x.membership.all_peers for x in c.nodes]
            assert wait_for(lambda: all(
                x.network_view() == c.nodes[0].network_view()
                for x in c.nodes))
            views[pkg] = renamed(c.nodes[0].network_view(), c.nodes)
        finally:
            c.stop()
    if n == 2:
        # the flood's topology is timing-free on two nodes
        assert views[PORT] == views[JAX] == {"n0": ["n1"], "n1": ["n0"]}
    else:
        assert set(views[PORT]) <= {f"n{k}" for k in range(n)}


def test_farmed_readme_matches_jax_cluster(readme_puzzle):
    """A README /solve on the joiner farms its 73 cells to the one worker,
    cell by cell in a fixed order: the answer, the solved count and every
    node's validations equal the JAX cluster's, and each node's /stats
    sums the validations of both."""
    out = {}
    for pkg in (JAX, PORT):
        engs = [make_engine(pkg) for _ in range(2)]
        c = Cluster([pkg] * 2, engs)
        try:
            assert c.converged()
            worker, master = c.nodes
            before = [e.validations for e in engs]
            solution = master.peer_sudoku_solve(readme_puzzle)
            assert solution is not None and oracle_is_valid_solution(solution)
            assert _clues_kept(readme_puzzle, solution)
            counts = [e.validations - b for e, b in zip(engs, before)]
            total = sum(e.validations for e in engs)
            assert wait_for(lambda: all(
                x.get_stats()["all"] == {"solved": 1, "validations": total}
                for x in c.nodes), timeout=5.0), [x.get_stats() for x in c.nodes]
            farm = (engs[1].cost.snapshot().get("farm") if pkg == PORT
                    else None)
            out[pkg] = (solution, master.solved_puzzles, counts, farm)
        finally:
            c.stop()
            for e in engs:
                e.close()
    assert out[PORT][:3] == out[JAX][:3]
    assert out[PORT][1] == 1 and out[PORT][2][0] > 0  # the worker did the work
    assert out[PORT][3]["dispatches"] == 73


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_unsat_farm_returns_none(engines, pkg):
    c = Cluster([pkg] * 2, [engines[pkg]] * 2)
    try:
        assert c.converged()
        bad = [[0] * 9 for _ in range(9)]
        bad[0][0] = bad[0][1] = 5
        assert c.nodes[0].peer_sudoku_solve(bad) is None
        assert c.nodes[0].solved_puzzles == 0  # a failure is not a solve
    finally:
        c.stop()


def test_spoofed_self_disconnect_dropped(engines):
    """A hostile ``disconnect{address: victim}`` sent to the victim is
    dropped at ingress: the victim keeps itself and stays in every view."""
    c = Cluster([PORT] * 3, [engines[PORT]] * 3)
    try:
        assert c.converged()
        victim = c.nodes[0]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as attacker:
            attacker.sendto(wire.encode_msg(wire.disconnect_msg(victim.id)),
                            ("127.0.0.1", victim.port))
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            assert c.converged(timeout=1.0), [
                n.membership.all_peers for n in c.nodes]
            time.sleep(0.2)
        assert victim.id not in victim.membership._tombstones
    finally:
        c.stop()


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_goodbye_vs_rumor_same_port_multi_host(engines, pkg):
    """A third-party deletion relay from another host's same-port node is a
    rumour (rejected while its subject was heard recently); a goodbye from
    the departing address, or a loopback alias of it, prunes at once."""
    w = wire if pkg == PORT else jax_wire
    node = NODE[pkg]("127.0.0.1", free_port(), engine=engines[pkg])
    try:
        victim = "10.0.0.1:7000"
        node.membership.on_connect(victim)
        node._last_seen[victim] = time.monotonic()
        node.handle_message(w.disconnect_msg(victim), source=("10.0.0.2", 7000))
        assert victim in node.membership.neighbors()
        node.handle_message(w.disconnect_msg(victim), source=("10.0.0.1", 7000))
        assert victim not in node.membership.neighbors()
        alias = "localhost:9123"
        node.membership.on_connect(alias)
        node._last_seen[alias] = time.monotonic()
        node.handle_message(w.disconnect_msg(alias), source=("127.0.0.1", 9123))
        assert alias not in node.membership.neighbors()
    finally:
        node.shutdown_flag = True
        node.sock.close()


# -- the failure cases ---------------------------------------------------------

def test_crashed_peer_is_pruned(engines):
    c = Cluster([PORT] * 3, [engines[PORT]] * 3, failure_timeout=1.5)
    try:
        assert c.converged()
        victim = c.nodes[2]
        crash(victim)
        assert wait_for(lambda: all(
            victim.id not in n.membership.total_peers() for n in c.nodes[:2]),
            timeout=10.0), [n.membership.all_peers for n in c.nodes[:2]]
    finally:
        c.stop()


def test_failure_detector_off_keeps_reference_semantics(engines):
    """``failure_timeout=0``: only a graceful disconnect prunes."""
    c = Cluster([PORT] * 2, [engines[PORT]] * 2, failure_timeout=0.0)
    try:
        assert c.converged()
        crash(c.nodes[1])
        time.sleep(2.0)
        assert c.nodes[1].id in c.nodes[0].membership.total_peers()
    finally:
        c.stop()


def test_solve_completes_despite_crashed_worker(engines):
    """A farm whose worker died before the solve still answers: the task
    deadline or the crash detector requeues, and with every worker gone
    the master's engine answers the board."""
    c = Cluster([PORT] * 2, [engines[PORT]] * 2, failure_timeout=1.0)
    try:
        assert c.converged()
        master, worker = c.nodes
        crash(worker)
        board, full = few_holes(3, 6)
        assert master.peer_sudoku_solve(board) == full
        assert master.solved_puzzles == 1
    finally:
        c.stop()


def test_departing_worker_is_pruned_at_once(engines):
    """A graceful shutdown's disconnect prunes the node from every view at
    once, with the crash detector off."""
    c = Cluster([PORT] * 3, [engines[PORT]] * 3, failure_timeout=0.0)
    try:
        assert c.converged()
        victim = c.nodes[2]
        victim.shutdown()
        assert wait_for(lambda: all(
            victim.id not in n.membership.total_peers() for n in c.nodes[:2]),
            timeout=3.0), [n.membership.all_peers for n in c.nodes[:2]]
    finally:
        c.stop()


def test_metrics_endpoint_opt_in(engines):
    """/metrics answers only with ``expose_metrics``, on a node with peers
    too, with the JAX node's blocks."""
    c = Cluster([PORT] * 2, [engines[PORT]] * 2, metrics=RequestMetrics())
    httpd = make_http_server(c.nodes[0], "127.0.0.1", 0, expose_metrics=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert c.converged()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            body = json.load(r)
        assert {"engine", "membership"} <= set(body)
        assert body["membership"]["neighbors"] == 1
    finally:
        httpd.shutdown()
        c.stop()


# -- mixed clusters --------------------------------------------------------------

@pytest.mark.parametrize("master_pkg, worker_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-anchor-port-workers",
                              "port-master-jax-workers"])
def test_mixed_cluster_farms_the_unique_solution(master_pkg, worker_pkg):
    """The anchor of one package and two workers of the other converge and
    farm a 12-hole board to its unique solution: every cell is dispatched
    to a worker of the other package, which answers it."""
    engs = [make_engine(master_pkg)] + [make_engine(worker_pkg)
                                        for _ in range(2)]
    c = Cluster([master_pkg, worker_pkg, worker_pkg], engs)
    try:
        assert c.converged(), [n.membership.all_peers for n in c.nodes]
        board, full = few_holes(11, 12)
        before = [e.validations for e in engs]
        master = c.nodes[0]
        assert master.peer_sudoku_solve(board) == full
        assert master.solved_puzzles == 1
        worked = [e.validations - b for e, b in zip(engs, before)]
        assert worked[1] + worked[2] > 0, worked
        farm = engs[0].cost.snapshot()["farm"]
        assert farm["dispatches"] == 12, farm
        # the other package's stats gossip folded in as its own
        assert wait_for(lambda: len(master.get_stats()["nodes"]) == 3,
                        timeout=5.0), master.get_stats()
    finally:
        c.stop()
        for e in engs:
            e.close()
