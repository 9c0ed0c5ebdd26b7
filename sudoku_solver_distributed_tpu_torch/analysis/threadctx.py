"""Thread-context analyzer (THREAD1xx): what runs on the singleton loop
threads.

This process interleaves an HTTP surface, a UDP gossip loop, and device
dispatch in one interpreter — so a handful of SINGLETON LOOP THREADS are
latency-critical shared infrastructure: the UDP receive loop
(``P2PNode.run``), the coalescer's dispatcher/completer/segment drivers,
and the engine watchdog. Anything expensive or indefinitely blocking
that becomes reachable on one of them stalls every request behind it.
Both known incidents of this class were found at runtime, late:
``canonicalize`` on the UDP thread (~0.5 ms per datagram) and
full-queue sorts on the segment driver. These rules make the class
mechanical.

Loop-thread discovery is structural, from the shared call graph's
``threading.Thread(...)`` index: a spawn is a singleton loop when its
handle or name marks it a singleton (constant ``name=`` string, or a
``self.X = Thread(...)`` assignment), it is NOT constructed inside a
loop statement (pool idiom, e.g. ``fastserve-worker-{n}``), and its
target function contains a ``while`` loop. The UDP loop is added by
registry (it runs on the MAIN thread by construction — ``run()`` is
called, not spawned). Deliberate offload threads — whose entire purpose
is to absorb blocking/expensive work — are exempted by the registry
below, each with its reason; the exemption list is validated against
the graph (THREAD105) so it can never rot into silently exempting
nothing.

Rules (all error severity):

  THREAD101  expensive CPU call (``oracle_solve``, ``canonicalize``)
             reachable on a singleton loop thread via the call graph.
  THREAD102  indefinite blocking wait reachable on a loop thread
             through a CALLEE: zero-argument ``.get()``/``.wait()``/
             ``.join()``, any ``.result()`` without a timeout, or
             ``.accept()``. The loop function's OWN top-level wait is
             exempt — that wait IS the loop's scheduler (e.g. the
             completer's ``_inflight.get()``); buried in a callee it is
             an unbounded stall nobody scheduled.
  THREAD103  ``time.sleep`` with a constant budget > 1 s reachable on a
             loop thread — a loop parked that long misses deadlines;
             long sleeps belong on offload threads or interval waits.
  THREAD104  full-collection sort (``sorted(self.X…)``/``self.X.sort()``)
             of a GROWABLE shared attribute (one the class appends to)
             reachable on a loop thread — the segment-driver stall
             class; use a bounded selection (``heapq.nsmallest``)
             instead.
  THREAD105  registry rot: an exemption or extra-root entry below
             matches nothing in the analyzed tree.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ._astutil import self_attr
from .callgraph import CallGraph, FuncNode, ThreadSpawn
from .findings import Finding

_EXPENSIVE = {"oracle_solve", "canonicalize"}

# loop roots that are not Thread spawns: the UDP receive loop runs on
# the process main thread by construction (cli calls node.run())
REPO_EXTRA_ROOTS: Tuple[Tuple[str, str, str], ...] = (
    ("net/node.py", "P2PNode.run", "udp-loop"),
)

# deliberate offload/management threads: blocking or expensive work on
# them is their PURPOSE, not a hazard. Entries match a spawn's constant
# name= string or the resolved target symbol. Derived from this
# package's own ``threading.Thread(...)`` sites:
#   parallel/coalescer.py  BatchCoalescer prestager, deep retry
#   serving/autopilot.py   Autopilot loop and its cache prewarm
#   engine.py, net/cli.py  background warm-up of the bucket ladder
#   net/node.py            P2PNode._worker_loop (unnamed, on self)
#   parallel/serving_loop  FrontierServingLoop._run ("serving-loop")
#   parallel/relay         RaceRelay._run ("race-relay")
REPO_EXEMPT: Tuple[Tuple[str, str], ...] = (
    ("name", "coalescer-prestage"),     # host-staging offload
    ("name", "coalescer-deep-retry"),   # one-shot deep-budget retry
    ("name", "autopilot"),              # management loop; prewarm work
                                        # (canonicalize) is deliberate
    ("name", "cache-prewarm"),          # bulk verify/store offload
    ("name", "engine-warmup"),          # kernel build + verified warm-up
    ("name", "fanout-warm"),            # the leader's remaining widths
    ("target", "P2PNode._worker_loop"),  # the offload worker: absorbs
                                         # solve tasks so the UDP loop
                                         # never does
    ("target", "FrontierServingLoop._run"),  # collective loop on
                                             # torch.distributed: device
                                             # round trips and collectives
                                             # are its entire job
    ("target", "RaceRelay._run"),  # the race's relay across hosts:
                                   # datagrams, the mapped outbox and
                                   # inbox, and the shards' end events
                                   # while a race runs are its entire job
)


@dataclasses.dataclass(frozen=True)
class LoopRoot:
    key: str        # call-graph node key of the loop function
    label: str      # human name ("coalescer-dispatch", "udp-loop", …)


def _resolve_target(
    graph: CallGraph, spawn: ThreadSpawn
) -> Optional[str]:
    if spawn.target is None:
        return None
    owner = graph.nodes.get(spawn.owner)
    if owner is not None and owner.cls_name is not None:
        methods = graph.methods.get(
            (owner.mod.rel_path, owner.cls_name), {}
        )
        if spawn.target in methods:
            return methods[spawn.target]
    if owner is not None:
        # nested defs / module functions of the spawning module — prefer
        # a def nested in the OWNER (deep-retry's `run`) over the
        # module-level index entry
        nested = f"{owner.key}.{spawn.target}"
        if nested in graph.nodes:
            return nested
        local = graph.module_funcs.get(owner.mod.rel_path, {})
        if spawn.target in local:
            return local[spawn.target]
    keys = graph.by_name.get(spawn.target, [])
    if len(keys) == 1:
        return keys[0]
    return None


def discover_roots(
    graph: CallGraph,
    extra_roots: Sequence[Tuple[str, str, str]],
    exempt: Sequence[Tuple[str, str]],
) -> Tuple[List[LoopRoot], Set[Tuple[str, str]]]:
    """(singleton loop roots, registry entries that matched something)."""
    roots: List[LoopRoot] = []
    matched: Set[Tuple[str, str]] = set()
    exempt_names = {v for k, v in exempt if k == "name"}
    exempt_targets = {v for k, v in exempt if k == "target"}
    seen_keys: Set[str] = set()
    for spawn in graph.spawns:
        if spawn.in_loop or spawn.dynamic_name:
            continue  # pool idiom
        if spawn.thread_name is None and not spawn.on_self:
            continue  # fire-and-forget helper thread
        target_key = _resolve_target(graph, spawn)
        if target_key is None:
            continue
        node = graph.nodes[target_key]
        if spawn.thread_name in exempt_names:
            matched.add(("name", spawn.thread_name))
            continue
        if node.symbol in exempt_targets:
            matched.add(("target", node.symbol))
            continue
        if not node.has_while:
            continue  # one-shot worker (probe, freeze hook, …)
        if target_key in seen_keys:
            continue
        seen_keys.add(target_key)
        roots.append(
            LoopRoot(target_key, spawn.thread_name or node.symbol)
        )
    for path_suffix, symbol, label in extra_roots:
        key = graph.find(path_suffix, symbol)
        if key is None:
            continue
        matched.add(("root", f"{path_suffix}::{symbol}"))
        if key not in seen_keys:
            seen_keys.add(key)
            roots.append(LoopRoot(key, label))
    return roots, matched


def _chain(
    graph: CallGraph, root: str, target: str
) -> List[str]:
    """Shortest call chain root→target, as symbols, for messages."""
    parents: Dict[str, str] = {root: root}
    frontier = [root]
    while frontier and target not in parents:
        nxt: List[str] = []
        for key in frontier:
            for callee, _site in graph.edges.get(key, ()):
                if callee not in parents:
                    parents[callee] = key
                    nxt.append(callee)
        frontier = nxt
    if target not in parents:
        return []
    chain = [target]
    while chain[-1] != root:
        chain.append(parents[chain[-1]])
    return [graph.nodes[k].symbol for k in reversed(chain)]


def _fmt_chain(symbols: List[str]) -> str:
    if len(symbols) > 6:
        symbols = symbols[:3] + ["…"] + symbols[-2:]
    return " → ".join(symbols)


def _grows(node: FuncNode, attr: str) -> bool:
    """Does the node's class append/extend ``self.<attr>`` anywhere —
    i.e. is the attribute a growable queue rather than a small fixed
    tuple/list?"""
    if node.cls_name is None:
        return False
    for stmt in node.mod.tree.body:
        if (
            isinstance(stmt, ast.ClassDef)
            and stmt.name == node.cls_name
        ):
            for sub in ast.walk(stmt):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in ("append", "extend", "insert")
                    and self_attr(sub.func.value) == attr
                ):
                    return True
    return False


def _mentions_self_attr(expr: ast.AST) -> Optional[str]:
    for sub in ast.walk(expr):
        name = self_attr(sub)
        if name is not None:
            return name
    return None


def _scan_node(
    graph: CallGraph,
    node: FuncNode,
    root: LoopRoot,
    is_root_fn: bool,
    findings: List[Finding],
    seen: Set[Tuple[str, str, int]],
) -> None:
    chain_cache: Optional[str] = None

    def chain() -> str:
        nonlocal chain_cache
        if chain_cache is None:
            chain_cache = _fmt_chain(
                _chain(graph, root.key, node.key) or [node.symbol]
            )
        return chain_cache

    def add(rule: str, line: int, msg: str):
        dedup = (rule, node.key, line)
        if dedup in seen:
            return
        seen.add(dedup)
        findings.append(
            Finding(
                rule, "error", node.mod.rel_path, line, node.symbol, msg
            )
        )

    for site in node.calls:
        # THREAD101: expensive CPU work
        if site.name in _EXPENSIVE:
            add(
                "THREAD101",
                site.line,
                f"{site.name}() runs on singleton loop thread "
                f"{root.label!r} ({chain()}) — move it to the waiting/"
                f"offload thread; the loop must stay cheap",
            )
        # THREAD103: long parked sleep
        if site.dotted == "time.sleep" and site.call.args:
            arg = site.call.args[0]
            if (
                isinstance(arg, ast.Constant)
                and isinstance(arg.value, (int, float))
                and arg.value > 1.0
            ):
                add(
                    "THREAD103",
                    site.line,
                    f"time.sleep({arg.value}) parks loop thread "
                    f"{root.label!r} ({chain()}) — a loop stalled "
                    f"past 1 s misses deadlines; use an interval "
                    f"wait or an offload thread",
                )
        # THREAD104: full sort of growable shared state
        if site.name == "sorted" and site.kind == "name" and site.call.args:
            attr = _mentions_self_attr(site.call.args[0])
            if attr is not None and _grows(node, attr):
                add(
                    "THREAD104",
                    site.line,
                    f"sorted(self.{attr}) on loop thread "
                    f"{root.label!r} ({chain()}) — full sort of a "
                    f"growable queue is O(n log n) per wakeup (the "
                    f"driver-stall class); take a bounded "
                    f"selection (heapq.nsmallest) instead",
                )
        if site.name == "sort" and site.kind != "name":
            func = site.call.func
            attr = (
                self_attr(func.value)
                if isinstance(func, ast.Attribute)
                else None
            )
            if attr is not None and _grows(node, attr):
                add(
                    "THREAD104",
                    site.line,
                    f"self.{attr}.sort() on loop thread "
                    f"{root.label!r} ({chain()}) — full sort of a "
                    f"growable queue on the loop; use a bounded "
                    f"selection (heapq.nsmallest)",
                )
        # THREAD102: indefinite blocking waits, callees only (the
        # root's own top-level wait is its scheduler)
        if is_root_fn or site.deferred:
            continue
        blocked: Optional[str] = None
        has_timeout = any(
            kw.arg == "timeout" for kw in site.call.keywords
        )
        argless = not site.call.args and not site.call.keywords
        if site.name in ("get", "wait", "join") and argless:
            blocked = f".{site.name}() with no timeout"
        elif site.name == "result" and not has_timeout and not (
            site.call.args
        ):
            blocked = ".result() with no timeout"
        elif site.name == "accept" and site.kind != "name":
            blocked = ".accept()"
        if blocked is not None:
            add(
                "THREAD102",
                site.line,
                f"indefinite {blocked} reachable on loop thread "
                f"{root.label!r} ({chain()}) — a wait the loop "
                f"didn't schedule can stall it forever; bound it "
                f"with a timeout or move it off the loop",
            )


def analyze(
    graph: CallGraph,
    extra_roots: Optional[Sequence[Tuple[str, str, str]]] = None,
    exempt: Optional[Sequence[Tuple[str, str]]] = None,
) -> List[Finding]:
    registry_mode = extra_roots is None and exempt is None
    extra = REPO_EXTRA_ROOTS if extra_roots is None else tuple(extra_roots)
    exem = REPO_EXEMPT if exempt is None else tuple(exempt)
    findings: List[Finding] = []
    roots, matched = discover_roots(graph, extra, exem)

    # THREAD105 registry-rot: only when the registry plausibly describes
    # this tree (at least one entry matched) — fixture trees analyzed
    # with the repo defaults must not drown in rot noise
    if matched or not registry_mode:
        spawn_names = {s.thread_name for s in graph.spawns}
        symbols = {n.symbol for n in graph.nodes.values()}
        stale: List[str] = []
        for kind, value in exem:
            if (kind, value) in matched:
                continue
            exists = (
                value in spawn_names
                if kind == "name"
                else value in symbols
            )
            if not exists:
                stale.append(f"{kind}:{value}")
        for path_suffix, symbol, _label in extra:
            if graph.find(path_suffix, symbol) is None:
                stale.append(f"root:{path_suffix}::{symbol}")
        if stale:
            findings.append(
                Finding(
                    "THREAD105",
                    "error",
                    "sudoku_solver_distributed_tpu_torch/analysis/"
                    "threadctx.py",
                    1,
                    "<registry>",
                    "thread registry rot: "
                    + ", ".join(sorted(stale))
                    + " matches nothing — fix the registry",
                )
            )

    seen: Set[Tuple[str, str, int]] = set()
    for root in roots:
        for key in sorted(graph.reachable([root.key])):
            _scan_node(
                graph,
                graph.nodes[key],
                root,
                is_root_fn=(key == root.key),
                findings=findings,
                seen=seen,
            )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
