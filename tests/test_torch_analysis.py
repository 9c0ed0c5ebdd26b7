"""graftcheck for the PyTorch/CUDA package
(sudoku_solver_distributed_tpu_torch/analysis): parity with the JAX
package's analyzers, the torch-hygiene rules, and the gate on the port.

Four parts:

  * (a) every LOCK, WIRE, SEAM and THREAD fixture tree of
    tests/test_analysis.py, written out the same way, goes through BOTH
    analyzers with the same explicit configuration: rule, path, line,
    symbol, severity and message must be equal for every finding (a
    message may differ only where it names the analyzer's own file or
    the JAX package's history), and each case still checks the rules it
    was written to show;
  * (b) both analyzers over the JAX package's own tree, with the JAX
    registries passed explicitly, find the same LOCK, WIRE, SEAM and
    THREAD findings — the copies held against drift on real code;
  * (c) each TORCH rule flagged and clean, mirroring the JAX1xx fixture
    pairs;
  * (d) the real port: ``--strict`` clean with a live, justified
    baseline, the five-shape contract matrix green with port providers,
    the wire consumers, and the CLI's JSON and SARIF contracts.

The analyzers are pure stdlib-``ast``: nothing here imports torch or
jax through them. The wall time of a run is printed, never asserted.
"""

import dataclasses
import json
import re
import textwrap
from pathlib import Path

import pytest

from sudoku_solver_distributed_tpu import analysis as jax_analysis
from sudoku_solver_distributed_tpu.analysis import seams as jax_seams
from sudoku_solver_distributed_tpu.analysis import threadctx as jax_threadctx
from sudoku_solver_distributed_tpu.analysis.__main__ import (
    JSON_SCHEMA_VERSION as JAX_JSON_SCHEMA_VERSION,
)
from sudoku_solver_distributed_tpu.analysis.__main__ import (
    _JSON_KEYS as JAX_JSON_KEYS,
)
from sudoku_solver_distributed_tpu.analysis.__main__ import main as jax_main
from sudoku_solver_distributed_tpu.analysis._astutil import (
    iter_modules as jax_iter_modules,
)
from sudoku_solver_distributed_tpu.analysis.callgraph import (
    build_graph as jax_build_graph,
)
from sudoku_solver_distributed_tpu_torch import analysis
from sudoku_solver_distributed_tpu_torch.analysis import seams, threadctx
from sudoku_solver_distributed_tpu_torch.analysis.__main__ import (
    JSON_SCHEMA_VERSION,
    _JSON_KEYS,
    main,
)
from sudoku_solver_distributed_tpu_torch.analysis._astutil import iter_modules
from sudoku_solver_distributed_tpu_torch.analysis.callgraph import build_graph
from sudoku_solver_distributed_tpu_torch.analysis.sarif import to_sarif
from sudoku_solver_distributed_tpu_torch.analysis.seams import (
    MATRIX_SCHEMA_VERSION,
    ShapeSpec,
)

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = "sudoku_solver_distributed_tpu_torch"
JAX_PKG = "sudoku_solver_distributed_tpu"


# -- harness -----------------------------------------------------------------

def write_pkg(tmp_path, files):
    pkg = tmp_path / "pkg"
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return pkg


def _configs(tmp_path, pkg, *, serving, consumers, analyzers, shapes):
    """The same explicit configuration for both analyzers."""
    common = dict(
        root=tmp_path,
        package=pkg,
        serving=tuple(serving),
        wire_producer="net/wire.py",
        wire_consumers=None if consumers is None else tuple(consumers),
        baseline=None,
        analyzers=tuple(analyzers),
    )
    jax_shapes = None
    if shapes is not None:
        jax_shapes = tuple(
            jax_seams.ShapeSpec(**dataclasses.asdict(s)) for s in shapes
        )
    return (
        jax_analysis.Config(shapes=jax_shapes, **common),
        analysis.Config(shapes=shapes, **common),
    )


def run_both(
    tmp_path,
    files,
    *,
    serving=(),
    consumers=(),
    analyzers=("locks",),
    shapes=None,
):
    """Write a fixture package and run both analyzers over it; returns
    (jax result, port result)."""
    pkg = write_pkg(tmp_path, files)
    jax_cfg, port_cfg = _configs(
        tmp_path, pkg, serving=serving, consumers=consumers,
        analyzers=analyzers, shapes=shapes,
    )
    return jax_analysis.run_analysis(jax_cfg), analysis.run_analysis(port_cfg)


def run_port(tmp_path, files, *, serving=("engine.py",), analyzers=("torch",)):
    """The port's analyzers alone over a fixture package (TORCH rules)."""
    pkg = write_pkg(tmp_path, files)
    cfg = analysis.Config(
        root=tmp_path,
        package=pkg,
        serving=tuple(serving),
        wire_producer="net/wire.py",
        wire_consumers=(),
        baseline=None,
        analyzers=tuple(analyzers),
    )
    return analysis.run_analysis(cfg).findings


_HISTORY = re.compile(r"\bPR \d+ ")
_OWN_FILE = re.compile(r"^sudoku_solver_distributed_tpu(_torch)?/analysis/")


def comparable(findings):
    """Findings as comparable tuples. Two differences between the copies
    are by design and normalized here, nothing else: the JAX package's
    messages may cite its own history ("the PR n ... class"), and a
    registry-rot finding's path names the analyzer's own file."""
    out = []
    for f in findings:
        path = _OWN_FILE.sub("<analysis>/", f.path)
        out.append(
            (f.rule, path, f.line, f.symbol, f.severity,
             _HISTORY.sub("", f.message))
        )
    return sorted(out)


def rules_of(findings):
    return sorted({f.rule for f in findings})


# -- (a) shared fixture trees ------------------------------------------------

LOCK_HEADER = "import queue\nimport socket\nimport threading\n"


def lock_mod(body):
    return LOCK_HEADER + textwrap.dedent(body)


WIRE_PRODUCER = """
    def a_msg(x):
        return {"type": "a", "x": x}

    def b_msg(y, extra=None):
        if extra is None:
            return {"type": "b", "y": y}
        return {"type": "b", "y": y, "extra": extra}

    def c_msg():
        return {"type": "c"}
"""

MINI_ENGINE = """
    class Engine:
        def __init__(self, prog):
            self._prog = prog

        def dispatch(self, board):
            return self._prog(board)
"""

THREAD_HEADER = "import threading\nimport time\n"


def _mini_shape():
    return ShapeSpec(
        shape="mini",
        entry=("api.py", "solve_route"),
        sinks=(("engine.py", "Engine.dispatch"),),
    )


SEAM_DEAD_PATH_FILES = {
    "api.py": """
    def solve_route(node, body):
        return parse(body)

    def parse(body):
        return body
    """,
    "engine.py": MINI_ENGINE,
}

# name -> (files, run_both kwargs, expected rules)
SHARED_CASES = {
    "lock_blocking_queue_put_under_lock": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=2)

            def bad(self):
                with self._lock:
                    self._q.put(1)

            def good(self):
                self._q.put(1)
                with self._lock:
                    self._q.put_nowait(2)
        """)},
        dict(analyzers=("locks",)),
        ["LOCK102"],
    ),
    "lock_unbounded_put_ok_get_still_blocks": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()

            def fine(self):
                with self._lock:
                    self._q.put(1)   # unbounded: never blocks

            def bad(self):
                with self._lock:
                    return self._q.get()
        """)},
        dict(analyzers=("locks",)),
        ["LOCK102"],
    ),
    "lock_blocking_through_call_chain": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.sock = socket.socket()

            def outer(self):
                with self._lock:
                    self._send()

            def _send(self):
                self.sock.sendto(b"x", ("h", 1))
        """)},
        dict(analyzers=("locks",)),
        ["LOCK102"],
    ),
    "lock_future_result_and_sleep_under_lock": (
        {"mod.py": lock_mod("""
        import time

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def bad_result(self, fut):
                with self._lock:
                    return fut.result()

            def bad_sleep(self):
                with self._lock:
                    time.sleep(0.1)

            def good(self, fut):
                r = fut.result()
                with self._lock:
                    return r
        """)},
        dict(analyzers=("locks",)),
        ["LOCK102"],
    ),
    "lock_order_cycle": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def m1(self):
                with self._a:
                    with self._b:
                        pass

            def m2(self):
                with self._b:
                    with self._a:
                        pass
        """)},
        dict(analyzers=("locks",)),
        ["LOCK101"],
    ),
    "lock_consistent_order_clean": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def m1(self):
                with self._a:
                    with self._b:
                        pass

            def m2(self):
                with self._a:
                    with self._b:
                        pass
        """)},
        dict(analyzers=("locks",)),
        [],
    ),
    "lock_self_reacquire_direct_and_via_callee": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._r = threading.RLock()

            def direct(self):
                with self._lock:
                    with self._lock:
                        pass

            def via_callee(self):
                with self._lock:
                    self._helper()

            def _helper(self):
                with self._lock:
                    pass

            def reentrant_ok(self):
                with self._r:
                    with self._r:
                        pass
        """)},
        dict(analyzers=("locks",)),
        ["LOCK104"],
    ),
    "lock_condition_wait_on_foreign_lock": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self._cv_b = threading.Condition(self._b)

            def bad(self):
                with self._a:
                    self._cv_b.wait()

            def good(self):
                with self._cv_b:
                    self._cv_b.wait()
        """)},
        dict(analyzers=("locks",)),
        ["LOCK105"],
    ),
    "lock_guarded_attribute_written_bare": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def locked_write(self):
                with self._lock:
                    self.count += 1

            def bare_write(self):
                self.count = 0
        """)},
        dict(analyzers=("locks",)),
        ["LOCK103"],
    ),
    "lock_condition_on_injected_lock": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self, lk):
                self._lk = lk
                self._cond = threading.Condition(self._lk)

            def waiter(self):
                with self._cond:
                    self._cond.wait()

            def nested(self):
                with self._cond:
                    self._helper()

            def _helper(self):
                with self._cond:
                    pass
        """)},
        dict(analyzers=("locks",)),
        ["LOCK104"],
    ),
    "lock_lambda_defined_under_lock_not_attributed": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=1)
                self.cb = None

            def register(self):
                with self._lock:
                    self.cb = lambda: self._q.put(1)
        """)},
        dict(analyzers=("locks",)),
        [],
    ),
    "lock_guarded_attribute_hold_the_lock_helper": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def write(self):
                with self._lock:
                    self._bump_locked()

            def other(self):
                with self._lock:
                    self.count = 0

            def _bump_locked(self):
                self.count += 1
        """)},
        dict(analyzers=("locks",)),
        [],
    ),
    "lock_cross_class_abba_cycle": (
        {"mod.py": lock_mod("""
        class Alpha:
            def __init__(self, beta):
                self._a_lock = threading.Lock()
                self.beta = beta

            def forward(self):
                with self._a_lock:
                    self.beta.absorb()

            def reenter(self):
                with self._a_lock:
                    pass

        class Beta:
            def __init__(self, alpha):
                self._b_lock = threading.Lock()
                self.alpha = alpha

            def absorb(self):
                with self._b_lock:
                    pass

            def backward(self):
                with self._b_lock:
                    self.alpha.reenter()
        """)},
        dict(analyzers=("locks",)),
        ["LOCK106"],
    ),
    "lock_cross_class_consistent_order_clean": (
        {"mod.py": lock_mod("""
        class Alpha:
            def __init__(self, beta):
                self._a_lock = threading.Lock()
                self.beta = beta

            def forward(self):
                with self._a_lock:
                    self.beta.absorb()

            def reenter(self):
                with self._a_lock:
                    pass

        class Beta:
            def __init__(self, alpha):
                self._b_lock = threading.Lock()
                self.alpha = alpha

            def absorb(self):
                with self._b_lock:
                    pass

            def backward(self):
                self.alpha.reenter()
                with self._b_lock:
                    pass
        """)},
        dict(analyzers=("locks",)),
        [],
    ),
    "lock_baseline_one_finding": (
        {"mod.py": lock_mod("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=1)

            def bad(self):
                with self._lock:
                    self._q.put(1)
        """)},
        dict(analyzers=("locks",)),
        ["LOCK102"],
    ),
    "wire_missing_key_and_optional_key": (
        {
            "net/wire.py": WIRE_PRODUCER,
            "net/node.py": """
            def handle(msg):
                t = msg.get("type")
                if t == "a":
                    return msg["x"], msg["missing"]
                if t == "b":
                    return msg["y"], msg["extra"]
                if t == "c":
                    return True
                return None
            """,
        },
        dict(consumers=("net/node.py",), analyzers=("wire",)),
        ["WIRE101", "WIRE102"],
    ),
    "wire_clean_consumer_quiet": (
        {
            "net/wire.py": WIRE_PRODUCER,
            "net/node.py": """
            def handle(msg):
                t = msg.get("type")
                if t == "a":
                    return msg["x"]
                if t == "b":
                    return msg["y"], msg.get("extra")
                if t == "c":
                    return True
                return None
            """,
        },
        dict(consumers=("net/node.py",), analyzers=("wire",)),
        [],
    ),
    "wire_helper_call_accesses_attributed_to_branch_type": (
        {
            "net/wire.py": WIRE_PRODUCER,
            "net/node.py": """
            class Node:
                def handle(self, msg):
                    t = msg.get("type")
                    if t == "a":
                        self._on_a(msg)
                    elif t == "b":
                        return msg["y"]
                    elif t == "c":
                        return True

                def _on_a(self, msg):
                    return msg["nope"]
            """,
        },
        dict(consumers=("net/node.py",), analyzers=("wire",)),
        ["WIRE101", "WIRE104"],
    ),
    "wire_rebound_type_alias_not_attributed": (
        {
            "net/wire.py": WIRE_PRODUCER,
            "net/node.py": """
            def handle(msg):
                t = msg.get("type")
                if t == "a":
                    return msg["x"]
                t = msg.get("kind")
                if t == "ghost":
                    return msg.get("z")
                return None
            """,
        },
        dict(consumers=("net/node.py",), analyzers=("wire",)),
        ["WIRE103"],
    ),
    "wire_phantom_and_dead_types": (
        {
            "net/wire.py": WIRE_PRODUCER,
            "net/node.py": """
            def handle(msg):
                t = msg.get("type")
                if t == "a":
                    return msg["x"]
                if t == "b":
                    return msg["y"]
                if t == "ghost":
                    return msg.get("z")
                return None
            """,
        },
        dict(consumers=("net/node.py",), analyzers=("wire",)),
        ["WIRE103"],
    ),
    "wire_inline_message_construction": (
        {
            "net/wire.py": WIRE_PRODUCER,
            "net/node.py": """
            def handle(msg):
                t = msg.get("type")
                if t == "a":
                    return msg["x"]
                if t == "b":
                    return msg["y"]
                if t == "c":
                    return {"type": "a", "x": 1}
                return None
            """,
        },
        dict(consumers=("net/node.py",), analyzers=("wire",)),
        ["WIRE105"],
    ),
    "wire_consumers_auto_discovered": (
        {
            "net/wire.py": WIRE_PRODUCER + """
    def decode_msg(raw):
        return raw
            """,
            "net/node.py": """
            class Node:
                def on_datagram(self, raw):
                    msg = decode_msg(raw)
                    self.handle(msg)
                    self.stats.ingest(msg)

                def handle(self, msg):
                    t = msg.get("type")
                    if t == "a":
                        return msg["x"]
                    return None
            """,
            "net/stats.py": """
            class Stats:
                def ingest(self, msg):
                    t = msg.get("type")
                    if t == "b":
                        return msg["y"], msg["nope"]
                    return None
            """,
        },
        dict(consumers=None, analyzers=("wire",)),
        ["WIRE101", "WIRE103"],
    ),
    "seam_uncontracted_dispatch_flags_all_five_legs": (
        {
            "api.py": """
            def solve_route(node, body):
                return node.engine.dispatch(parse(body))

            def parse(body):
                return body
            """,
            "engine.py": MINI_ENGINE,
        },
        dict(analyzers=("seams",), shapes=(_mini_shape(),)),
        ["SEAM101", "SEAM102", "SEAM103", "SEAM104", "SEAM105"],
    ),
    "seam_legs_across_handoff_and_extras_cover": (
        {
            "api.py": """
            def solve_route(node, body, deadline_s):
                token = node.supervisor.call_started(9)
                if deadline_s <= 0:
                    raise DeadlineExceeded()
                try:
                    out = node.coalescer.submit(parse(body))
                except Exception:
                    node.supervisor.call_finished(token, ok=False)
                    return node.supervisor.fallback_solve(body)
                node.supervisor.call_finished(token, ok=True)
                return out

            def parse(body):
                return body
            """,
            "coalescer.py": """
            class Coalescer:
                def submit(self, board):
                    self._pending.append(board)

                def _driver_loop(self, tr):
                    while True:
                        tr.mark("device")
                        self.engine.dispatch(self._pending.pop())
            """,
            "engine.py": MINI_ENGINE + """
        def finalize(self, out):
            self.cost.record_call(1)
            return out
            """,
        },
        dict(
            analyzers=("seams",),
            shapes=(
                ShapeSpec(
                    shape="mini",
                    entry=("api.py", "solve_route"),
                    sinks=(("engine.py", "Engine.dispatch"),),
                    handoffs=(
                        (
                            ("coalescer.py", "Coalescer.submit"),
                            ("coalescer.py", "Coalescer._driver_loop"),
                        ),
                    ),
                    extras=(("engine.py", "Engine.finalize"),),
                ),
            ),
        ),
        [],
    ),
    "seam_registry_rot_missing_symbol": (
        SEAM_DEAD_PATH_FILES,
        dict(
            analyzers=("seams",),
            shapes=(
                ShapeSpec(
                    shape="ghost",
                    entry=("api.py", "solve_route"),
                    sinks=(("engine.py", "Engine.vanished"),),
                ),
            ),
        ),
        ["SEAM106"],
    ),
    "seam_registry_rot_dead_path": (
        SEAM_DEAD_PATH_FILES,
        dict(analyzers=("seams",), shapes=(_mini_shape(),)),
        ["SEAM106"],
    ),
    "thread_loop_thread_hazards_all_flagged": (
        {"mod.py": THREAD_HEADER + textwrap.dedent("""
        def canonicalize(batch):
            return batch

        class Driver:
            def __init__(self):
                self._pending = []
                self._t = threading.Thread(
                    target=self._loop, name="driver"
                )

            def _loop(self):
                while True:
                    self._step()

            def _step(self):
                batch = sorted(self._pending)
                canonicalize(batch)
                time.sleep(5)
                return self._q.get()

            def add(self, x):
                self._pending.append(x)
        """)},
        dict(analyzers=("thread",)),
        ["THREAD101", "THREAD102", "THREAD103", "THREAD104"],
    ),
    "thread_bounded_loop_and_pool_idiom_clean": (
        {"mod.py": THREAD_HEADER + textwrap.dedent("""
        import heapq

        class Driver:
            def __init__(self):
                self._pending = []
                self._t = threading.Thread(
                    target=self._loop, name="driver"
                )

            def _loop(self):
                while True:
                    self._q.get()
                    self._step()

            def _step(self):
                batch = heapq.nsmallest(8, self._pending)
                self._q.get(timeout=0.5)
                time.sleep(0.05)
                return batch

            def add(self, x):
                self._pending.append(x)

        class Pool:
            def __init__(self):
                self._ts = []
                for i in range(4):
                    t = threading.Thread(
                        target=self._work, name=f"w-{i}"
                    )
                    self._ts.append(t)

            def _work(self):
                while True:
                    self._q.get()
        """)},
        dict(analyzers=("thread",)),
        [],
    ),
}


def run_case(tmp_path, case):
    """One shared case through both analyzers, in a directory of its own."""
    files, kwargs, _expected = SHARED_CASES[case]
    sub = tmp_path / case
    sub.mkdir()
    return run_both(sub, files, **kwargs)


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_shared_fixture_findings_equal_the_jax_analyzers(tmp_path, case):
    expected = SHARED_CASES[case][2]
    jax_res, port_res = run_case(tmp_path, case)
    assert comparable(port_res.findings) == comparable(jax_res.findings)
    assert rules_of(port_res.findings) == expected, "\n".join(
        f.format() for f in port_res.findings
    )
    assert port_res.wire_consumers == jax_res.wire_consumers
    assert port_res.contract_matrix == jax_res.contract_matrix


def test_thread_registry_rot_equal_the_jax_analyzer(tmp_path):
    # THREAD105 through each side's own call graph and explicit registry
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        THREAD_HEADER
        + textwrap.dedent("""
        class Driver:
            def __init__(self):
                self._t = threading.Thread(
                    target=self._loop, name="driver"
                )

            def _loop(self):
                while True:
                    self._tick()

            def _tick(self):
                return None
        """)
    )
    registry = dict(
        extra_roots=(("gone.py", "Ghost.run", "ghost-loop"),),
        exempt=(("name", "ghost-thread"),),
    )
    port = threadctx.analyze(
        build_graph(list(iter_modules(pkg, tmp_path))), **registry
    )
    jax = jax_threadctx.analyze(
        jax_build_graph(list(jax_iter_modules(pkg, tmp_path))), **registry
    )
    assert comparable(port) == comparable(jax)
    assert rules_of(port) == ["THREAD105"]
    (f,) = port
    assert f.path == f"{PORT_PKG}/analysis/threadctx.py"
    assert "name:ghost-thread" in f.message
    assert "gone.py::Ghost.run" in f.message


def test_shared_case_messages_name_what_the_jax_tests_check(tmp_path):
    # the spot checks test_analysis.py makes on these trees hold on the
    # port's copy too (symbols, the hazard named in the message)
    _, res = run_case(tmp_path, "lock_blocking_through_call_chain")
    (f,) = res.findings
    assert f.symbol == "C.outer" and "self._send" in f.message
    _, res = run_case(tmp_path, "lock_cross_class_abba_cycle")
    (f,) = res.findings
    assert "Alpha._a_lock" in f.message and "Beta._b_lock" in f.message
    _, res = run_case(tmp_path, "lock_future_result_and_sleep_under_lock")
    assert sorted(f.symbol for f in res.findings) == [
        "C.bad_result", "C.bad_sleep",
    ]
    _, res = run_case(tmp_path, "wire_missing_key_and_optional_key")
    by_rule = {f.rule: f for f in res.findings}
    assert "missing" in by_rule["WIRE101"].message
    assert "extra" in by_rule["WIRE102"].message
    _, res = run_case(tmp_path, "wire_phantom_and_dead_types")
    assert len(res.findings) == 2
    assert any("'ghost'" in f.message for f in res.findings)
    _, res = run_case(tmp_path, "wire_rebound_type_alias_not_attributed")
    assert not any("'ghost'" in f.message for f in res.findings)
    _, res = run_case(tmp_path, "thread_loop_thread_hazards_all_flagged")
    assert all(f.symbol == "Driver._step" for f in res.findings)
    assert all("'driver'" in f.message for f in res.findings)
    _, res = run_case(tmp_path, "wire_consumers_auto_discovered")
    assert res.wire_consumers == ("net/node.py", "net/stats.py")
    assert any(
        f.rule == "WIRE101" and f.path.endswith("net/stats.py")
        and "nope" in f.message
        for f in res.findings
    )
    _, res = run_case(tmp_path, "seam_legs_across_handoff_and_extras_cover")
    (shape,) = res.contract_matrix["shapes"]
    assert all(shape["covered"].values())
    assert any(
        "Coalescer._driver_loop" in k for k in shape["provided_by"]["trace"]
    )


@pytest.mark.parametrize("rule", ["locks", "wire"])
def test_cli_strict_nonzero_on_each_shared_rule_fixture(tmp_path, capsys, rule):
    trees = {
        "locks": {
            "mod.py": LOCK_HEADER
            + "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._q = queue.Queue(maxsize=1)\n"
            "    def bad(self):\n"
            "        with self._lock:\n"
            "            self._q.put(1)\n",
        },
        "wire": {
            "net/wire.py": 'def a_msg(x):\n'
            '    return {"type": "a", "x": x}\n'
            'def decode_msg(raw):\n'
            '    return raw\n',
            "net/node.py": 'def on_datagram(raw):\n'
            '    return handle(decode_msg(raw))\n'
            'def handle(msg):\n'
            '    if msg.get("type") == "a":\n'
            '        return msg["missing"]\n',
        },
    }
    pkg = write_pkg(tmp_path, trees[rule])
    assert main(["--strict", "--package", str(pkg)]) == 1
    assert jax_main(["--strict", "--package", str(pkg)]) == 1
    capsys.readouterr()


def test_cli_strict_zero_on_clean_fixture(tmp_path, capsys):
    pkg = write_pkg(
        tmp_path,
        {
            "mod.py": "class C:\n    pass\n",
            "engine.py": "import numpy as np\n"
            "def f(a):\n    return np.asarray(a)\n",
            "net/wire.py": 'def a_msg(x):\n'
            '    return {"type": "a", "x": x}\n',
            "net/node.py": 'def handle(msg):\n'
            '    if msg.get("type") == "a":\n'
            '        return msg["x"]\n',
        },
    )
    assert main(["--strict", "--package", str(pkg)]) == 0
    capsys.readouterr()


def _lock_pkg(tmp_path):
    return write_pkg(tmp_path, {"mod.py": SHARED_CASES[
        "lock_baseline_one_finding"][0]["mod.py"]})


def test_cli_json_and_sarif_on_a_fixture_equal_the_jax_cli(tmp_path, capsys):
    pkg = _lock_pkg(tmp_path)
    out_port, out_jax = tmp_path / "port.sarif", tmp_path / "jax.sarif"
    assert main(["--json", "--package", str(pkg), "--sarif", str(out_port)]) == 0
    port_body = json.loads(capsys.readouterr().out)
    assert jax_main(["--json", "--package", str(pkg), "--sarif", str(out_jax)]) == 0
    jax_body = json.loads(capsys.readouterr().out)
    assert port_body == jax_body
    assert port_body["errors"][0]["rule"] == "LOCK102"
    # the SARIF documents are the same document: one LOCK102 result, its
    # location, fingerprint and rule table
    assert json.loads(out_port.read_text()) == json.loads(out_jax.read_text())
    run = json.loads(out_port.read_text())["runs"][0]
    (res,) = run["results"]
    assert res["ruleId"] == "LOCK102" and res["level"] == "error"
    assert res["partialFingerprints"]["graftcheckFindingKey/v1"].startswith(
        "LOCK102:"
    )
    assert "suppressions" not in res


# -- baseline machinery (the copy keeps the JAX loader's rules) --------------

def test_baseline_suppresses_by_symbol_and_reports_stale(tmp_path):
    _, res = run_case(tmp_path, "lock_baseline_one_finding")
    assert len(res.findings) == 1
    baseline = tmp_path / "baseline.toml"
    baseline.write_text(
        '[[suppress]]\n'
        'rule = "LOCK102"\n'
        'path = "pkg/mod.py"\n'
        'symbol = "C.bad"\n'
        'reason = "fixture: accepted debt"\n'
        '[[suppress]]\n'
        'rule = "LOCK102"\n'
        'path = "pkg/gone.py"\n'
        'symbol = "C.old"\n'
        'reason = "fixture: already fixed"\n'
    )
    entries = analysis.load_baseline(baseline)
    active, suppressed, stale = analysis.apply_baseline(res.findings, entries)
    assert active == []
    assert len(suppressed) == 1
    assert [e.symbol for e in stale] == ["C.old"]
    assert entries == [
        analysis.BaselineEntry(**dataclasses.asdict(e))
        for e in jax_analysis.load_baseline(baseline)
    ]


def test_baseline_requires_reason_and_rejects_duplicates(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text(
        '[[suppress]]\nrule = "X"\npath = "p"\nsymbol = "s"\nreason = ""\n'
    )
    with pytest.raises(ValueError, match="reason"):
        analysis.load_baseline(p)
    p.write_text(
        '[[suppress]]\nrule = "X"\npath = "p"\nsymbol = "s"\n'
        'reason = "r"\n'
        '[[suppress]]\nrule = "X"\npath = "p"\nsymbol = "s"\n'
        'reason = "again"\n'
    )
    with pytest.raises(ValueError, match="duplicates"):
        analysis.load_baseline(p)
    assert analysis.load_baseline(tmp_path / "does-not-exist.toml") == []


def test_cli_invalid_baseline_is_always_fatal(tmp_path, capsys):
    bad = tmp_path / "baseline.toml"
    bad.write_text(
        '[[suppress]]\nrule = "LOCK102"\npath = "x.py"\nsymbol = "C.m"\n'
    )  # no reason
    pkg = _lock_pkg(tmp_path)
    assert main(["--package", str(pkg), "--baseline", str(bad)]) == 2
    assert "reason" in capsys.readouterr().err


def test_cli_rejects_unknown_rules_and_the_jax_rule_name(capsys):
    # a typo'd subset must error out, not run zero analyzers and pass;
    # "jax" is not an analyzer of the port
    for rules in ("lokcs", "jax"):
        with pytest.raises(SystemExit) as exc:
            main(["--strict", "--rules", rules])
        assert exc.value.code == 2
        assert "unknown analyzer" in capsys.readouterr().err


# -- (b) the JAX package's tree through both analyzers -----------------------

@pytest.fixture(scope="module")
def jax_tree_results():
    """Both analyzers over the JAX package's tree with the JAX registries
    passed explicitly (dispatch shapes; loop-thread roots and exemptions,
    given to the port's threadctx over its own call graph of the tree;
    wire consumers auto-discovered by both). Returns (JAX findings, the
    port's findings, JAX result, port result)."""
    common = dict(
        root=REPO_ROOT,
        package=REPO_ROOT / JAX_PKG,
        serving=("engine.py", "parallel"),
        wire_producer="net/wire.py",
        wire_consumers=None,
        baseline=None,
        analyzers=("locks", "wire", "seams"),
    )
    jax_res = jax_analysis.run_analysis(
        jax_analysis.Config(
            shapes=jax_seams.REPO_SHAPES,
            **dict(common, analyzers=common["analyzers"] + ("thread",)),
        )
    )
    port_res = analysis.run_analysis(
        analysis.Config(
            shapes=tuple(
                ShapeSpec(**dataclasses.asdict(s))
                for s in jax_seams.REPO_SHAPES
            ),
            **common,
        )
    )
    graph = build_graph(list(iter_modules(REPO_ROOT / JAX_PKG, REPO_ROOT)))
    port_thread = threadctx.analyze(
        graph,
        extra_roots=jax_threadctx.REPO_EXTRA_ROOTS,
        exempt=jax_threadctx.REPO_EXEMPT,
    )
    print(f"JAX tree: JAX analyzers {jax_res.wall_s:.2f} s, port's "
          f"{port_res.wall_s:.2f} s (wall, not asserted)")
    return (
        jax_res.findings, port_res.findings + port_thread, jax_res, port_res
    )


@pytest.mark.parametrize("prefix", ["LOCK", "WIRE", "SEAM", "THREAD"])
def test_jax_tree_findings_equal_the_jax_analyzers(jax_tree_results, prefix):
    jax_all, port_all, _, _ = jax_tree_results
    jax_f = [f for f in jax_all if f.rule.startswith(prefix)]
    port_f = [f for f in port_all if f.rule.startswith(prefix)]
    assert comparable(port_f) == comparable(jax_f)
    if prefix == "LOCK":
        # the JAX baseline's by-design debt is found by the copy too
        assert {f.symbol for f in port_f} >= {
            "P2PNode.peer_sudoku_solve_info",
            "FrontierServingLoop._roundtrip",
        }


def test_jax_tree_matrix_and_consumers_equal_the_jax_analyzers(jax_tree_results):
    _, _, jax_res, port_res = jax_tree_results
    assert port_res.contract_matrix == jax_res.contract_matrix
    assert port_res.wire_consumers == jax_res.wire_consumers
    assert len(port_res.contract_matrix["shapes"]) == 5


# -- (c) TORCH rules ---------------------------------------------------------

KERNEL_IMPORTS = (
    "import ctypes\n"
    "import numpy as np\n"
    "import torch\n"
    "from .ops.cuda_solver import dfs_segment, dfs_solver, load_library\n"
)


def torch_mod(body):
    return KERNEL_IMPORTS + textwrap.dedent(body)


def test_torch101_implicit_sync_on_kernel_result_flagged(tmp_path):
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    class E:
        def fetch(self, boards, spec):
            out, meta = dfs_solver(boards, spec, 81, 100)
            return np.asarray(meta)

        def explicit(self, boards, spec):
            out, meta = dfs_solver(boards, spec, 81, 100)
            return np.asarray(meta.cpu())

        def host_only(self, boards):
            return np.asarray(boards)
    """)})
    assert rules_of(findings) == ["TORCH101"]
    (f,) = findings
    assert f.symbol == "E.fetch" and "np.asarray" in f.message


def test_torch101_seeding_kernel_output_flagged_explicit_transfer_clean(tmp_path):
    # the seeding wrapper is a device source: an implicit sync on its
    # states flags; the explicit .cpu() its callers use (and the one of
    # its header inside the wrapper) reads as host-safe
    findings = run_port(tmp_path, {"engine.py": KERNEL_IMPORTS + textwrap.dedent("""
    from .ops.cuda_solver import seed_frontier_cuda

    def implicit(flat, spec):
        states, solved, header = seed_frontier_cuda(flat, spec, 64, 97)
        return np.asarray(states)

    def explicit(flat, spec):
        states, solved, header = seed_frontier_cuda(flat, spec, 64, 97)
        head = states.cpu()
        return head.numpy(), solved.cpu().numpy(), int(head[0, 0])
    """)})
    assert rules_of(findings) == ["TORCH101"]
    (f,) = findings
    assert f.symbol == "implicit" and "np.asarray" in f.message


def test_torch101_scoped_to_serving_modules(tmp_path):
    findings = run_port(tmp_path, {"offline.py": torch_mod("""
    def fetch(boards, spec):
        out, meta = dfs_solver(boards, spec, 81, 100)
        return int(meta[0, 0])
    """)})
    assert findings == []


def test_torch101_item_int_tolist_and_branch_on_device_values(tmp_path):
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    def f(a, dev):
        t = torch.as_tensor(a).to(dev)
        n = t.sum().item()
        m = int(t[0])
        rows = t.tolist()
        if (t > 0).any():
            return n, m, rows
        return None
    """)})
    assert rules_of(findings) == ["TORCH101"]
    assert len(findings) == 4
    kinds = " ".join(f.message for f in findings)
    assert ".item()" in kinds and "int()" in kinds and ".tolist()" in kinds
    assert "if (Tensor.__bool__)" in kinds


def test_torch101_static_metadata_explicit_transfer_and_cpu_tensors_clean(
    tmp_path
):
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    def f(a, dev):
        t = torch.zeros((4, 81), dtype=torch.int32, device=dev)
        width = int(t.shape[0])
        n = int(t.numel())
        host = t.to("cpu")
        first = int(host[0, 0])
        back = t.cpu().numpy()
        if back[0, 0] > 0:
            return width, n, first
        c = torch.zeros((4,), device="cpu")
        return int(c[0]), t.to(torch.int64).shape
    """)})
    assert findings == []


def test_torch101_factory_made_source_taints_its_results(tmp_path):
    # a module function or method returning a kernel's tensors is a source
    # itself; a tuple return is tracked per position, so the host half of
    # (packed, pool) stays clean while the device half flags
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    def _rows(boards, spec):
        out, meta = dfs_solver(boards, spec, 81, 100)
        return meta

    class E:
        def _probe(self, pool, boards, src):
            pool, digest, block = dfs_segment(pool, boards, src, 8)
            packed = digest.cpu().numpy()
            return packed, pool

        def serve(self, board, spec):
            return np.asarray(_rows(board, spec))

        def probe(self, pool, boards, src):
            packed, pool = self._probe(pool, boards, src)
            status = int(packed[0, 0])
            return status, bool(pool.state.status[0])
    """)})
    assert rules_of(findings) == ["TORCH101"]
    assert sorted(
        (f.symbol, f.message.split(" on ")[0]) for f in findings
    ) == [
        ("E.probe", "implicit host sync: bool()"),
        ("E.serve", "implicit host sync: np.asarray"),
    ]


def test_torch102_pinned_read_before_its_event_flagged(tmp_path):
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    class E:
        @staticmethod
        def _to_host(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(t.device))
            return host, ready

        def early_copy_read(self, t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host.numpy()

        def early_pair_read(self, t):
            host, ready = self._to_host(t)
            rows = host[0]
            ready.synchronize()
            return rows

        def never_recorded(self, t):
            ready = torch.cuda.Event()
            ready.synchronize()
            return t
    """)})
    assert rules_of(findings) == ["TORCH102"]
    assert sorted(f.symbol for f in findings) == [
        "E.early_copy_read", "E.early_pair_read", "E.never_recorded",
    ]
    (never,) = [f for f in findings if f.symbol == "E.never_recorded"]
    assert "records" in never.message


def test_torch102_copy_event_synchronize_then_read_clean(tmp_path):
    # the engine's patterns: the (host, ready) pair read after its event,
    # a pair carried in a handle, a copy on a side stream read after the
    # stream's synchronize(), and a wait on a recorded event
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    class E:
        def __init__(self):
            self._done = torch.cuda.Event()

        @staticmethod
        def _to_host(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(t.device))
            return host, ready

        def pair(self, t):
            host, ready = self._to_host(t)
            ready.synchronize()
            return host.numpy()

        def handle(self, call):
            if call.ready is not None:
                call.ready.synchronize()
            return call.host.numpy().copy()

        def side_stream(self, block, n):
            with torch.cuda.stream(self._fetch_stream):
                host = torch.empty((n, 81), dtype=block.dtype, pin_memory=True)
                host.copy_(block[:n], non_blocking=True)
            self._fetch_stream.synchronize()
            return host.numpy()

        def mark(self):
            self._done.record()

        def wait_done(self):
            torch.cuda.current_stream().wait_event(self._done)
    """)})
    assert findings == []


def test_torch104_per_call_build_or_load_flagged_memoized_clean(tmp_path):
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    from functools import lru_cache

    from .ops import cuda_solver as cs

    _LIB = load_library()

    def per_call(boards):
        lib = load_library()
        return lib

    def per_call_dlopen(path):
        return ctypes.CDLL(path)

    def per_call_build():
        return cs.build()

    @lru_cache(maxsize=None)
    def cached():
        return load_library()

    class SolverEngine:
        def __init__(self):
            self._lib = load_library()

        def _verified(self, what, launch):
            return cs.rebuild_library()

        def solve(self, boards):
            return cs.rebuild_library()
    """)})
    assert rules_of(findings) == ["TORCH104"]
    assert sorted(f.symbol for f in findings) == [
        "SolverEngine.solve", "per_call", "per_call_build", "per_call_dlopen",
    ]


def test_torch105_consumed_pool_reuse_flagged(tmp_path):
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    def bad(pool, boards, src):
        nxt, digest, block = dfs_segment(pool, boards, src, 8)
        return pool.state  # consumed: its tensors hold the next state

    def bad_rebind_rhs(pool, boards, src, refresh):
        nxt, digest, block = dfs_segment(pool, boards, src, 8)
        pool = refresh(pool)  # the RHS still reads the consumed pool
        return pool
    """)})
    assert rules_of(findings) == ["TORCH105"]
    assert len(findings) == 2
    assert {f.symbol for f in findings} == {"bad", "bad_rebind_rhs"}


def test_torch105_rebind_patterns_clean(tmp_path):
    # rebinding the name from the consuming call's own results (the
    # carried pool), reads of arguments that are not consumed, a use
    # strictly after an independent fresh rebind, and the self-attribute
    # pool rebound in the same statement
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    def carried(pool, boards, src):
        for _ in range(4):
            pool, digest, block = dfs_segment(pool, boards, src, 8)
        return pool

    def non_consumed_arg_ok(pool, boards, src):
        nxt, digest, block = dfs_segment(pool, boards, src, 8)
        return boards  # only the pool is consumed

    def fresh_rebind_ok(pool, boards, src, make):
        nxt, digest, block = dfs_segment(pool, boards, src, 8)
        pool = make()  # a fresh pool, the old one never read
        return pool

    class Loop:
        def step(self, boards, src):
            self._pool, digest, block = dfs_segment(self._pool, boards, src, 8)
            return self._pool.width

        def seam(self, eng, boards, src):
            handle = eng.dispatch_segment(self._state, boards, src=src)
            self._state = handle.state
            return self._state
    """)})
    assert findings == []


def test_torch105_self_attr_pool_reuse_flagged(tmp_path):
    # the engine's seam consumes a self-attribute pool; compound
    # statements don't double-count
    findings = run_port(tmp_path, {"engine.py": torch_mod("""
    class Loop:
        def bad(self, eng, boards, src, flag):
            if flag:
                handle = eng.dispatch_segment(self._pool, boards, src=src)
            return self._pool.width
    """)})
    assert rules_of(findings) == ["TORCH105"]
    (f,) = findings
    assert f.symbol == "Loop.bad" and "self._pool" in f.message


def test_cli_strict_nonzero_on_a_torch_fixture(tmp_path, capsys):
    pkg = write_pkg(tmp_path, {"engine.py": torch_mod("""
    def fetch(boards, spec):
        out, meta = dfs_solver(boards, spec, 81, 100)
        return int(meta[0, 0])
    """)})
    assert main(["--strict", "--package", str(pkg)]) == 1
    assert "TORCH101" in capsys.readouterr().out


# -- (d) the real port -------------------------------------------------------

@pytest.fixture(scope="module")
def port_result():
    result = analysis.run_analysis(analysis.default_config())
    print(f"the port's gate over its own tree: {result.wall_s:.2f} s wall "
          f"(not asserted)")
    return result


def test_port_is_strict_clean_with_live_justified_baseline(port_result):
    cfg = analysis.default_config()
    assert cfg.package == REPO_ROOT / PORT_PKG
    assert cfg.analyzers == ("locks", "torch", "wire", "seams", "thread")
    entries = analysis.load_baseline(cfg.baseline)
    active, suppressed, stale = analysis.apply_baseline(
        port_result.findings, entries
    )
    errors = [f for f in active if f.severity == "error"]
    assert errors == [], "unsuppressed errors:\n" + "\n".join(
        f.format() for f in errors
    )
    assert stale == [], f"stale baseline entries: {stale}"
    assert suppressed, "baseline exists but suppresses nothing"
    for e in entries:
        assert len(e.reason) > 60, f"thin justification: {e}"
        assert e.path.startswith(f"{PORT_PKG}/")
    assert {(e.rule, e.symbol) for e in entries} == {
        ("LOCK102", "P2PNode.peer_sudoku_solve_info"),
        ("LOCK102", "FrontierServingLoop._roundtrip"),
    }


def test_port_torch_rules_find_nothing_on_the_serving_modules(port_result):
    torch_findings = [f for f in port_result.findings
                      if f.rule.startswith("TORCH")]
    assert torch_findings == [], "\n".join(f.format() for f in torch_findings)


def test_port_wire_consumers_auto_discovery_matches_known_set(port_result):
    assert port_result.wire_consumers == (
        "cache/gossip.py", "net/node.py", "net/stats.py", "utils/faults.py",
    )


def test_port_contract_matrix_all_shapes_all_legs_green(port_result):
    m = port_result.contract_matrix
    assert m["schema_version"] == MATRIX_SCHEMA_VERSION == 1
    assert m["legs"] == ["supervision", "trace", "cost", "deadline", "fallback"]
    shapes = {s["shape"]: s for s in m["shapes"]}
    assert [s["shape"] for s in m["shapes"]] == [
        "single", "batch", "frontier", "farm", "segments",
    ]
    for name, s in shapes.items():
        assert s["paths"] >= 1, f"shape {name} has no dispatch path"
        assert s["witness"][0] == s["entry"]
        missing = [leg for leg, ok in s["covered"].items() if not ok]
        assert not missing, f"shape {name} missing legs: {missing}"
        for leg in m["legs"]:
            assert s["provided_by"][leg], (name, leg)
            for key in s["provided_by"][leg]:
                assert key.startswith(f"{PORT_PKG}/"), key
    assert shapes["single"]["sinks"] == [f"{PORT_PKG}/engine.py::SolverEngine._launch"]
    assert shapes["segments"]["sinks"] == [
        f"{PORT_PKG}/engine.py::SolverEngine.dispatch_segment"
    ]
    frontier = shapes["frontier"]
    for leg in ("supervision", "cost"):
        assert any(
            k.endswith("SolverEngine._frontier_raw")
            for k in frontier["provided_by"][leg]
        ), frontier["provided_by"][leg]


def test_port_thread_registry_resolves_every_entry():
    graph = build_graph(
        list(iter_modules(REPO_ROOT / PORT_PKG, REPO_ROOT))
    )
    roots, matched = threadctx.discover_roots(
        graph, threadctx.REPO_EXTRA_ROOTS, threadctx.REPO_EXEMPT
    )
    assert set(threadctx.REPO_EXEMPT) <= matched
    assert ("target", "FrontierServingLoop._run") in matched
    assert ("target", "P2PNode._worker_loop") in matched
    assert ("root", "net/node.py::P2PNode.run") in matched
    labels = {r.label for r in roots}
    assert {"udp-loop", "coalescer-dispatch", "coalescer-complete",
            "engine-watchdog"} <= labels


def test_port_cli_strict_green_and_red_without_baseline(capsys):
    assert main(["--strict"]) == 0
    capsys.readouterr()
    assert main(["--strict", "--baseline", "none"]) == 1
    out = capsys.readouterr().out
    assert "LOCK102" in out and "2 error(s)" in out


def test_port_cli_rules_subset_keeps_other_analyzers_baseline_live(capsys):
    assert main(["--strict", "--rules", "torch"]) == 0
    out = capsys.readouterr().out
    assert "debt paid" not in out
    assert "0 stale baseline" in out


def test_port_cli_json_schema_matches_the_jax_pins(capsys):
    assert JSON_SCHEMA_VERSION == JAX_JSON_SCHEMA_VERSION == 2
    assert _JSON_KEYS == JAX_JSON_KEYS
    assert main(["--json"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert body["schema_version"] == JSON_SCHEMA_VERSION
    assert set(body) == set(_JSON_KEYS)
    assert body["errors"] == [] and body["stale_baseline"] == []
    assert len(body["suppressed"]) == 2
    for f in body["suppressed"]:
        assert set(f) == {
            "rule", "severity", "path", "line", "symbol", "message",
        }
    m = body["contract_matrix"]
    assert m["schema_version"] == MATRIX_SCHEMA_VERSION
    for s in m["shapes"]:
        assert set(s) == {
            "shape", "entry", "sinks", "paths", "witness",
            "covered", "provided_by",
        }
        assert all(s["covered"].values()), s
    assert body["wire_consumers"] == [
        "cache/gossip.py", "net/node.py", "net/stats.py", "utils/faults.py",
    ]


def test_port_cli_sarif_baselined_debt_stays_visible(tmp_path, capsys):
    out = tmp_path / "port.sarif"
    assert main(["--strict", "--sarif", str(out)]) == 0
    capsys.readouterr()
    body = json.loads(out.read_text())
    assert body["version"] == "2.1.0"
    run = body["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftcheck"
    results = run["results"]
    suppressed = [r for r in results if "suppressions" in r]
    assert len(suppressed) == 2
    for r in suppressed:
        assert r["suppressions"][0]["kind"] == "external"
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].startswith(f"{PORT_PKG}/")
        assert loc["artifactLocation"]["uriBaseId"] == "SRCROOT"
    assert not any(
        r["level"] == "error" for r in results if "suppressions" not in r
    )


def test_sarif_rule_family_for_torch_findings():
    f = analysis.Finding("TORCH101", "error", "p.py", 3, "f", "m")
    (rule,) = to_sarif([f])["runs"][0]["tool"]["driver"]["rules"]
    assert rule["id"] == "TORCH101"
    assert "torch hygiene" in rule["shortDescription"]["text"]
