"""Package-wide call graph + parsed-AST cache (graftcheck v2 core).

Every inter-procedural rule family (SEAM1xx dispatch-contract seams,
THREAD1xx thread-context hazards, cross-class LOCK106 ordering) runs on
ONE shared :class:`CallGraph` built from the runner's single parse pass —
analyzers never re-read or re-parse source, which is what keeps the whole
gate inside its ~2 s budget.

Resolution model (deliberately CHA-like, documented so findings can be
audited against it):

  * ``self.method()`` resolves inside the enclosing class only — this
    codebase composes objects rather than inheriting across modules, so
    a miss means a dynamic attribute (kernel program, injected hook) and
    produces no edge.
  * bare ``name()`` prefers a definition in the same module (top-level
    or nested), then falls back to same-named top-level functions
    anywhere in the package.
  * ``recv.method()`` on any other receiver resolves by METHOD NAME to
    every same-named definition in the package (class-hierarchy-analysis
    style), except when the receiver resolves to a known external import
    (``threading.*``, ``np.*``, ``torch.*``, ``ctypes.*`` …). Names
    defined more than
    ``MAX_FANOUT`` times are too generic to resolve and produce no
    edges — precision over recall: an analyzer edge that sprays is
    worse than one that misses.
  * a ``lambda`` passed as a call argument is ALSO attributed to the
    callee when the callee resolves into the package (higher-order
    idiom: ``_supervised_answer(sup, arr, lambda: submit(...))`` runs
    the lambda inside ``_supervised_answer``, so the submit edge
    belongs on it); its calls stay on the enclosing function too,
    marked deferred.
  * nested ``def``s are their own nodes (``outer.inner``) — they are
    thread targets and deferred callbacks, not part of the enclosing
    body's synchronous flow. Being closures, they resolve ONLY from
    their enclosing function (or sibling nested defs), never by
    package-wide name.

Thread construction sites (``threading.Thread(...)``) are indexed with
their target, constant ``name=`` (or the fact it was dynamic), whether
the spawn sits inside a loop statement (pool idiom), and whether the
handle is kept on ``self`` (singleton idiom) — threadctx.py classifies
loop threads from exactly these facts.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ._astutil import Module, call_kw, const_str, self_attr

# a callee name defined more than this many times package-wide is too
# generic (get/put/append territory) to resolve by name
MAX_FANOUT = 6

# receiver roots that mark a call as external (stdlib / third-party):
# resolve_name() normalizes import aliases, so these are real module
# names, not whatever the file aliased them to
_EXTERNAL_ROOTS = {
    "numpy", "jax", "jaxlib", "np", "jnp", "torch", "ctypes", "threading",
    "queue", "socket",
    "time", "logging", "os", "sys", "json", "math", "heapq", "collections",
    "functools", "itertools", "struct", "random", "dataclasses", "argparse",
    "signal", "gc", "http", "socketserver", "urllib", "contextlib", "enum",
    "pathlib", "typing", "traceback", "uuid", "hashlib", "concurrent",
    "subprocess", "shutil", "tempfile", "re", "io", "csv", "base64",
}


@dataclasses.dataclass
class CallSite:
    """One call expression inside a function body."""

    name: str                 # final callee name ("submit", "mark", …)
    kind: str                 # "self" | "name" | "attr"
    dotted: Optional[str]     # resolve_call() result, if any
    line: int
    deferred: bool            # lexically inside a lambda
    call: ast.Call


@dataclasses.dataclass
class ThreadSpawn:
    """One ``threading.Thread(...)`` construction site."""

    owner: str                    # key of the constructing function
    path: str
    line: int
    target: Optional[str]         # final name of the target callable
    thread_name: Optional[str]    # constant name= string, else None
    dynamic_name: bool            # name= present but not a constant
    in_loop: bool                 # constructed inside for/while (pool idiom)
    on_self: bool                 # handle kept on self.X (singleton idiom)


class FuncNode:
    """One function/method definition plus everything the rule families
    ask about it."""

    def __init__(
        self,
        mod: Module,
        fn: ast.FunctionDef,
        symbol: str,
        cls_name: Optional[str],
        nested: bool = False,
    ):
        self.mod = mod
        self.fn = fn
        self.symbol = symbol
        self.cls_name = cls_name
        self.nested = nested
        self.key = f"{mod.rel_path}::{symbol}"
        self.calls: List[CallSite] = []
        self.spawns: List[ThreadSpawn] = []
        self.has_while = False
        self._idents: Optional[Set[str]] = None

    @property
    def identifiers(self) -> Set[str]:
        """Every Name id and Attribute attr appearing in the body —
        the marker predicates (seams.py) match against this."""
        if self._idents is None:
            idents: Set[str] = set()
            for node in ast.walk(self.fn):
                if isinstance(node, ast.Name):
                    idents.add(node.id)
                elif isinstance(node, ast.Attribute):
                    idents.add(node.attr)
            self._idents = idents
        return self._idents

    @property
    def call_names(self) -> Set[str]:
        return {c.name for c in self.calls}

    def params(self) -> List[str]:
        a = self.fn.args
        return [
            p.arg
            for p in (a.posonlyargs + a.args + a.kwonlyargs)
        ]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<FuncNode {self.key}>"


def _direct_nested_defs(fn: ast.FunctionDef) -> List[ast.FunctionDef]:
    """FunctionDefs nested directly under ``fn`` (not inside a deeper
    def)."""
    out: List[ast.FunctionDef] = []

    def scan(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
                continue  # deeper defs belong to this child
            scan(child)

    scan(fn)
    return out


class CallGraph:
    """The shared inter-procedural index over one parsed package."""

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        self.by_rel_pkg: Dict[str, Module] = {}
        self.nodes: Dict[str, FuncNode] = {}
        # final name -> node keys (methods and functions)
        self.by_name: Dict[str, List[str]] = {}
        # (rel_path, class) -> {method name -> key}
        self.methods: Dict[Tuple[str, str], Dict[str, str]] = {}
        # rel_path -> {bare function name -> key} (top-level + nested)
        self.module_funcs: Dict[str, Dict[str, str]] = {}
        for mod in self.modules:
            self._index_module(mod)
        self._reattribute_lambdas()
        self.edges: Dict[str, List[Tuple[str, CallSite]]] = {}
        for key, node in self.nodes.items():
            out: List[Tuple[str, CallSite]] = []
            for site in node.calls:
                for target in self._resolve_site(node, site):
                    out.append((target, site))
            self.edges[key] = out
        self.spawns: List[ThreadSpawn] = [
            s for n in self.nodes.values() for s in n.spawns
        ]

    # -- indexing ----------------------------------------------------------

    def _index_module(self, mod: Module) -> None:
        mfuncs: Dict[str, str] = {}
        self.module_funcs[mod.rel_path] = mfuncs

        def add(
            fn: ast.FunctionDef,
            symbol: str,
            cls: Optional[str],
            nested: bool = False,
        ):
            node = FuncNode(mod, fn, symbol, cls, nested=nested)
            self.nodes[node.key] = node
            if not nested:
                # a nested def is a closure: callable only from its
                # enclosing function, so it must NOT participate in
                # package-wide name/attr resolution (a CHA edge from
                # some set's .add() to a helper named add sprays the
                # whole graph)
                self.by_name.setdefault(fn.name, []).append(node.key)
                mfuncs.setdefault(fn.name, node.key)
            _BodyWalker(mod, node).run()
            for sub in _direct_nested_defs(fn):
                add(sub, f"{symbol}.{sub.name}", cls, nested=True)
            return node

        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(stmt, stmt.name, None)
            elif isinstance(stmt, ast.ClassDef):
                methods: Dict[str, str] = {}
                self.methods[(mod.rel_path, stmt.name)] = methods
                for sub in stmt.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        node = add(
                            sub, f"{stmt.name}.{sub.name}", stmt.name
                        )
                        methods[sub.name] = node.key

    def _reattribute_lambdas(self) -> None:
        """A lambda passed as an argument to a resolvable package callee
        runs inside that callee (higher-order idiom) — copy its calls
        onto the callee node so dispatch paths flow THROUGH it."""
        for node in list(self.nodes.values()):
            for site in list(node.calls):
                lambdas = [
                    a
                    for a in (
                        list(site.call.args)
                        + [kw.value for kw in site.call.keywords]
                    )
                    if isinstance(a, ast.Lambda)
                ]
                if not lambdas:
                    continue
                targets = self._resolve_site(node, site)
                if not targets:
                    continue
                inner: List[CallSite] = []
                for lam in lambdas:
                    for sub in ast.walk(lam.body):
                        if not isinstance(sub, ast.Call):
                            continue
                        func = sub.func
                        dotted = node.mod.resolve_call(sub)
                        if isinstance(func, ast.Name):
                            inner.append(
                                CallSite(
                                    func.id, "name", dotted,
                                    sub.lineno, True, sub,
                                )
                            )
                        elif isinstance(func, ast.Attribute):
                            # the lambda's ``self`` is the ENCLOSING
                            # instance, not the callee's — resolve
                            # globally, never against the callee class
                            inner.append(
                                CallSite(
                                    func.attr, "attr", dotted,
                                    sub.lineno, True, sub,
                                )
                            )
                for target in targets:
                    self.nodes[target].calls.extend(inner)

    # -- resolution --------------------------------------------------------

    def _resolve_site(
        self, node: FuncNode, site: CallSite
    ) -> List[str]:
        if site.dotted is not None:
            root = site.dotted.split(".", 1)[0]
            if root in _EXTERNAL_ROOTS:
                return []
        if site.kind == "self":
            if node.cls_name is not None:
                methods = self.methods.get(
                    (node.mod.rel_path, node.cls_name), {}
                )
                if site.name in methods:
                    return [methods[site.name]]
            return []
        if site.kind == "name":
            # nested defs first: callable from the enclosing function
            # (or a sibling nested def) only
            nested_child = f"{node.key}.{site.name}"
            if nested_child in self.nodes:
                return [nested_child]
            if node.nested:
                sibling = (
                    f"{node.key.rsplit('.', 1)[0]}.{site.name}"
                )
                if sibling in self.nodes:
                    return [sibling]
            local = self.module_funcs.get(node.mod.rel_path, {})
            if site.name in local and local[site.name] != node.key:
                return [local[site.name]]
        candidates = self.by_name.get(site.name, [])
        if not candidates or len(candidates) > MAX_FANOUT:
            return []
        if site.kind == "name":
            # bare-name fallback: module-level functions only
            candidates = [
                k for k in candidates if self.nodes[k].cls_name is None
            ]
        return [k for k in candidates if k != node.key]

    # -- queries -----------------------------------------------------------

    def callees(self, key: str) -> List[Tuple[str, CallSite]]:
        return self.edges.get(key, [])

    def reachable(
        self, roots: Iterable[str], include_deferred: bool = True
    ) -> Set[str]:
        """Every node key reachable from ``roots`` along call edges."""
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.nodes]
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            for target, site in self.edges.get(key, ()):
                if not include_deferred and site.deferred:
                    continue
                if target not in seen:
                    stack.append(target)
        return seen

    def find(self, rel_path_suffix: str, symbol: str) -> Optional[str]:
        """Node key for (path suffix, symbol), e.g.
        ``find("net/node.py", "P2PNode.run")`` — suffix-matched so
        callers don't care about the package prefix."""
        for key, node in self.nodes.items():
            if node.symbol == symbol and node.mod.rel_path.endswith(
                rel_path_suffix
            ):
                return key
        return None

    def paths(
        self,
        entry: str,
        sinks: Set[str],
        extra_edges: Optional[Dict[str, List[str]]] = None,
        max_paths: int = 16,
        max_depth: int = 24,
    ) -> List[List[str]]:
        """Up to ``max_paths`` simple paths entry→any sink over call
        edges plus ``extra_edges`` (declared queue/condition handoffs)."""
        extra = extra_edges or {}
        # restrict the DFS to nodes from which a sink is reachable —
        # without this the search wanders the whole call web under the
        # entry before finding anything
        rev: Dict[str, List[str]] = {}
        for src, outs in self.edges.items():
            for target, _site in outs:
                rev.setdefault(target, []).append(src)
        for src, outs2 in extra.items():
            for target in outs2:
                rev.setdefault(target, []).append(src)
        allowed: Set[str] = set()
        stack = [s for s in sinks]
        while stack:
            key = stack.pop()
            if key in allowed:
                continue
            allowed.add(key)
            stack.extend(rev.get(key, ()))
        out: List[List[str]] = []

        def step(key: str, trail: List[str]):
            if len(out) >= max_paths or len(trail) > max_depth:
                return
            trail = trail + [key]
            if key in sinks:
                out.append(trail)
                return
            nexts = [t for t, _s in self.edges.get(key, ())]
            nexts += extra.get(key, [])
            seen_next: Set[str] = set()
            for target in nexts:
                if (
                    target in trail
                    or target in seen_next
                    or target not in allowed
                ):
                    continue
                seen_next.add(target)
                step(target, trail)

        if entry in self.nodes:
            step(entry, [])
        return out


class _BodyWalker:
    """Collect call sites + thread spawns for one function body,
    pruning nested defs (own nodes) and marking lambda bodies
    deferred."""

    def __init__(self, mod: Module, node: FuncNode):
        self.mod = mod
        self.node = node
        # lines of Thread(...) calls assigned to self.X in this body
        self._self_assigned_lines: Set[int] = set()

    def run(self) -> None:
        fn = self.node.fn
        for stmt in fn.body:
            self._mark_self_assigns(stmt)
        for stmt in fn.body:
            self._walk(stmt, deferred=False, in_loop=False)

    def _mark_self_assigns(self, stmt: ast.AST) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if any(
                    self_attr(t) is not None for t in node.targets
                ):
                    self._self_assigned_lines.add(node.value.lineno)

    def _walk(self, node: ast.AST, deferred: bool, in_loop: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested def: its own FuncNode
        if isinstance(node, ast.Lambda):
            self._walk(node.body, deferred=True, in_loop=in_loop)
            return
        if isinstance(node, ast.While):
            self.node.has_while = True
            in_loop = True
        elif isinstance(node, ast.For):
            in_loop = True
        if isinstance(node, ast.Call):
            self._record_call(node, deferred, in_loop)
        for child in ast.iter_child_nodes(node):
            self._walk(child, deferred, in_loop)

    def _record_call(
        self, call: ast.Call, deferred: bool, in_loop: bool
    ) -> None:
        dotted = self.mod.resolve_call(call)
        if dotted == "threading.Thread":
            self._record_spawn(call, in_loop)
        func = call.func
        site: Optional[CallSite] = None
        if isinstance(func, ast.Name):
            site = CallSite(
                func.id, "name", dotted, call.lineno, deferred, call
            )
        elif isinstance(func, ast.Attribute):
            if (
                isinstance(func.value, ast.Name)
                and func.value.id == "self"
            ):
                kind = "self"
            else:
                kind = "attr"
            site = CallSite(
                func.attr, kind, dotted, call.lineno, deferred, call
            )
        if site is not None:
            self.node.calls.append(site)

    def _record_spawn(self, call: ast.Call, in_loop: bool) -> None:
        target_expr = call_kw(call, "target")
        target: Optional[str] = None
        if isinstance(target_expr, ast.Name):
            target = target_expr.id
        elif isinstance(target_expr, ast.Attribute):
            target = target_expr.attr
        name_expr = call_kw(call, "name")
        thread_name = const_str(name_expr) if name_expr is not None else None
        self.node.spawns.append(
            ThreadSpawn(
                owner=self.node.key,
                path=self.mod.rel_path,
                line=call.lineno,
                target=target,
                thread_name=thread_name,
                dynamic_name=(
                    name_expr is not None and thread_name is None
                ),
                in_loop=in_loop,
                on_self=call.lineno in self._self_assigned_lines,
            )
        )


def build_graph(modules: Sequence[Module]) -> CallGraph:
    return CallGraph(modules)
