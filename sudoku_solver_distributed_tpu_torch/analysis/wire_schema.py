"""Wire-schema drift analyzer (WIRE1xx).

The UDP protocol is JSON dicts built by ``net/wire.py`` constructors and
consumed by hand dispatch in ``net/node.py`` (plus the helpers it hands
messages to). Nothing but convention keeps the two sides aligned — a
goodbye handler reading a key only the rumor message carries is this
drift. This analyzer recovers both sides from source:

  * **producers**: every ``wire.py`` function returning dict literals
    with a constant ``"type"`` key. Multiple returns give per-type
    variants: a key in every variant is *required*, a key in some is
    *optional* (``disconnect`` carries row/col only at shutdown).
  * **consumers**: every function with a ``msg`` parameter. A dispatch
    function compares ``msg["type"]``/``msg.get("type")`` against string
    constants; key accesses are attributed to the message types the
    enclosing branch's tests allow (``==``, ``in (tuple)``), hard
    subscripts ``msg["k"]`` tracked separately from tolerant
    ``msg.get("k")``/``"k" in msg``. One level of intra-class/module
    ``helper(msg)`` calls is followed (to a fixed point), so
    ``self._on_disconnect(msg)``'s accesses count for the disconnect
    branch.

Rules:

  WIRE101 (error)   a consumer branch for type T hard-subscripts a key
                    no constructor of T ever emits → KeyError on every
                    such message.
  WIRE102 (error)   hard-subscript of a key only SOME variants of T
                    emit → KeyError on the variants without it.
  WIRE103 (warning) consumed-but-never-produced / produced-but-never-
                    consumed message types (dead or phantom messages).
  WIRE104 (warning) a ``msg`` key accessed anywhere (typed or not) that
                    no constructor emits at all — drift smell even when
                    the dispatch attribution can't see the type.
  WIRE105 (warning) a dict literal with a ``"type"`` key constructed in
                    a consumer module — wire messages belong in the
                    producer module, where this analyzer (and the
                    goldens) can see their schema.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ._astutil import Module, const_str
from .findings import Finding

MSG_PARAM = "msg"


# -- producer side -----------------------------------------------------------

@dataclasses.dataclass
class ProducerSchema:
    """Per message type: key sets of each return-dict variant."""

    variants: List[Tuple[str, int, Set[str]]] = dataclasses.field(
        default_factory=list
    )  # (function, line, keys)

    @property
    def all_keys(self) -> Set[str]:
        out: Set[str] = set()
        for _f, _l, keys in self.variants:
            out |= keys
        return out

    @property
    def required_keys(self) -> Set[str]:
        out: Optional[Set[str]] = None
        for _f, _l, keys in self.variants:
            out = set(keys) if out is None else out & keys
        return out or set()


def extract_producers(mod: Module) -> Dict[str, ProducerSchema]:
    """type → schema from every function returning dict literals with a
    constant "type" entry."""
    schemas: Dict[str, ProducerSchema] = {}
    for fn in mod.functions():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            for d in _dict_literals(node.value):
                keys = _dict_keys(d)
                if keys is None or "type" not in keys:
                    continue
                mtype = _dict_type_value(d)
                if mtype is None:
                    continue
                schema = schemas.setdefault(mtype, ProducerSchema())
                schema.variants.append((fn.name, d.lineno, keys))
    return schemas


def _dict_literals(expr: ast.expr) -> List[ast.Dict]:
    return [n for n in ast.walk(expr) if isinstance(n, ast.Dict)]


def _dict_keys(d: ast.Dict) -> Optional[Set[str]]:
    keys: Set[str] = set()
    for k in d.keys:
        s = const_str(k) if k is not None else None
        if s is None:
            return None  # computed/splatted key: schema unknowable
        keys.add(s)
    return keys


def _dict_type_value(d: ast.Dict) -> Optional[str]:
    for k, v in zip(d.keys, d.values):
        if k is not None and const_str(k) == "type":
            return const_str(v)
    return None


# -- consumer side -----------------------------------------------------------

@dataclasses.dataclass
class _Access:
    key: str
    line: int
    hard: bool                      # msg["k"] vs msg.get("k") / "k" in msg
    types: Optional[Tuple[str, ...]]  # constrained types; None = any


class _ConsumerWalker:
    """Collect key accesses on the ``msg`` param of one function,
    attributed to the message types the enclosing branches allow."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.accesses: List[_Access] = []
        self.helper_calls: List[Tuple[str, Optional[Tuple[str, ...]]]] = []
        # types this function's branches dispatch on — consumption
        # evidence even when the branch body hands msg straight to a
        # cross-module helper (e.g. self.stats.merge(msg))
        self.dispatched_types: Set[str] = set()
        # names bound to msg["type"] / msg.get("type")
        self.type_aliases: Set[str] = set()
        self._prescan_aliases()
        self._walk(fn.body, None)

    def _prescan_aliases(self):
        # a name is a type alias only if EVERY assignment to it is a
        # msg["type"]/msg.get("type") read — one rebinding to anything
        # else (e.g. `t = msg.get("kind")`) and branch tests on it must
        # not be attributed to wire message types
        rebound: Set[str] = set()
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if not isinstance(t, ast.Name):
                    continue
                if self._is_type_access(node.value):
                    self.type_aliases.add(t.id)
                else:
                    rebound.add(t.id)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(node.target, ast.Name):
                    rebound.add(node.target.id)
        self.type_aliases -= rebound

    def _is_type_access(self, expr: ast.expr) -> bool:
        if (
            isinstance(expr, ast.Subscript)
            and _is_msg(expr.value)
            and const_str(_slice(expr)) == "type"
        ):
            return True
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "get"
            and _is_msg(expr.func.value)
            and expr.args
            and const_str(expr.args[0]) == "type"
        ):
            return True
        return False

    # -- type constraints --------------------------------------------------
    def _types_from_test(
        self, test: ast.expr
    ) -> Optional[Tuple[str, ...]]:
        """The message types a branch test constrains to, or None."""
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for v in test.values:
                got = self._types_from_test(v)
                if got is not None:
                    return got
            return None
        if not isinstance(test, ast.Compare) or len(test.ops) != 1:
            return None
        left, op, right = test.left, test.ops[0], test.comparators[0]
        if not (
            (isinstance(left, ast.Name) and left.id in self.type_aliases)
            or self._is_type_access(left)
        ):
            return None
        if isinstance(op, ast.Eq):
            s = const_str(right)
            return (s,) if s is not None else None
        if isinstance(op, ast.In) and isinstance(
            right, (ast.Tuple, ast.List, ast.Set)
        ):
            vals = [const_str(e) for e in right.elts]
            if all(v is not None for v in vals):
                return tuple(vals)  # type: ignore[arg-type]
        return None

    # -- walk --------------------------------------------------------------
    def _walk(self, body: List[ast.stmt], types: Optional[Tuple[str, ...]]):
        for stmt in body:
            if isinstance(stmt, ast.If):
                constrained = self._types_from_test(stmt.test)
                branch_types = constrained or types
                if constrained:
                    self.dispatched_types |= set(constrained)
                # short-circuit: msg accesses in an `mtype == T and ...`
                # test only evaluate once the type check passed, so they
                # belong to the branch's types
                self._scan_expr(stmt.test, branch_types)
                self._walk(stmt.body, branch_types)
                self._walk(stmt.orelse, types)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk(stmt.body, types)
                continue
            for field, value in ast.iter_fields(stmt):
                if field in ("body", "orelse", "finalbody"):
                    if isinstance(value, list):
                        self._walk(
                            [s for s in value if isinstance(s, ast.stmt)],
                            types,
                        )
                    continue
                if field == "handlers":
                    for h in value or []:
                        self._walk(h.body, types)
                    continue
                if isinstance(value, ast.expr):
                    self._scan_expr(value, types)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._scan_expr(v, types)

    def _scan_expr(
        self, expr: ast.expr, types: Optional[Tuple[str, ...]]
    ):
        for node in ast.walk(expr):
            if isinstance(node, ast.Subscript) and _is_msg(node.value):
                key = const_str(_slice(node))
                if key is not None and key != "type":
                    self.accesses.append(
                        _Access(key, node.lineno, True, types)
                    )
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr == "get"
                    and _is_msg(func.value)
                    and node.args
                ):
                    key = const_str(node.args[0])
                    if key is not None and key != "type":
                        self.accesses.append(
                            _Access(key, node.lineno, False, types)
                        )
                elif any(
                    _is_msg(a) for a in node.args
                ):
                    callee = func.attr if isinstance(
                        func, ast.Attribute
                    ) else (func.id if isinstance(func, ast.Name) else None)
                    if callee is not None:
                        self.helper_calls.append((callee, types))
            elif isinstance(node, ast.Compare) and any(
                _is_msg(c) for c in node.comparators
            ):
                # "key" in msg
                if len(node.ops) == 1 and isinstance(
                    node.ops[0], (ast.In, ast.NotIn)
                ):
                    key = const_str(node.left)
                    if key is not None and key != "type":
                        self.accesses.append(
                            _Access(key, node.lineno, False, None)
                        )


def _is_msg(node: ast.expr) -> bool:
    return isinstance(node, ast.Name) and node.id == MSG_PARAM


def _slice(node: ast.Subscript) -> ast.expr:
    s = node.slice
    return s.value if isinstance(s, ast.Index) else s  # py<3.9 compat


def extract_consumers(
    mod: Module,
) -> Dict[str, _ConsumerWalker]:
    """function symbol → walker, for every function taking a ``msg``
    param; helper accesses folded into callers to a fixed point."""
    walkers: Dict[str, _ConsumerWalker] = {}
    by_name: Dict[str, str] = {}
    for cls in mod.classes():
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _takes_msg(node):
                    symbol = f"{cls.name}.{node.name}"
                    walkers[symbol] = _ConsumerWalker(node)
                    by_name[node.name] = symbol
    for fn in mod.functions():
        if _takes_msg(fn):
            walkers[fn.name] = _ConsumerWalker(fn)
            by_name.setdefault(fn.name, fn.name)

    # fold helper accesses into callers (fixed point; helper accesses
    # inherit the CALL SITE's type constraint when the helper itself had
    # none)
    changed = True
    guard = 0
    while changed and guard < 20:
        changed = False
        guard += 1
        for symbol, w in walkers.items():
            for callee, call_types in w.helper_calls:
                target = by_name.get(callee)
                if target is None or target == symbol:
                    continue
                for acc in walkers[target].accesses:
                    merged = _Access(
                        acc.key,
                        acc.line,
                        acc.hard,
                        acc.types if acc.types is not None else call_types,
                    )
                    if not _has_access(w.accesses, merged):
                        w.accesses.append(merged)
                        changed = True
    return walkers


def _has_access(accesses: List[_Access], a: _Access) -> bool:
    return any(
        x.key == a.key
        and x.line == a.line
        and x.hard == a.hard
        and x.types == a.types
        for x in accesses
    )


def _takes_msg(fn: ast.FunctionDef) -> bool:
    return any(
        a.arg == MSG_PARAM
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    )


# -- the drift check ---------------------------------------------------------

def analyze(
    producer_mod: Module, consumer_mods: List[Module]
) -> List[Finding]:
    findings: List[Finding] = []
    schemas = extract_producers(producer_mod)
    produced_types = set(schemas)
    consumed_types: Set[str] = set()
    all_produced_keys: Set[str] = set()
    for s in schemas.values():
        all_produced_keys |= s.all_keys

    for mod in consumer_mods:
        walkers = extract_consumers(mod)
        for symbol, w in walkers.items():
            consumed_types |= w.dispatched_types
            for acc in w.accesses:
                if acc.types is not None:
                    consumed_types |= set(acc.types)
                types = acc.types
                if types is None:
                    if acc.key not in all_produced_keys and acc.hard:
                        findings.append(
                            Finding(
                                "WIRE104",
                                "warning",
                                mod.rel_path,
                                acc.line,
                                symbol,
                                f"msg[{acc.key!r}] accessed but no "
                                f"wire constructor emits a "
                                f"{acc.key!r} key at all",
                            )
                        )
                    continue
                for t in types:
                    if t not in schemas:
                        continue  # WIRE103 covers unknown types
                    schema = schemas[t]
                    if acc.hard and acc.key not in schema.all_keys:
                        findings.append(
                            Finding(
                                "WIRE101",
                                "error",
                                mod.rel_path,
                                acc.line,
                                symbol,
                                f"handler for type {t!r} subscripts "
                                f"msg[{acc.key!r}] but no "
                                f"constructor of {t!r} emits that key "
                                f"(produced: "
                                f"{sorted(schema.all_keys)})",
                            )
                        )
                    elif (
                        acc.hard
                        and acc.key not in schema.required_keys
                    ):
                        variants = [
                            f
                            for f, _l, keys in schema.variants
                            if acc.key not in keys
                        ]
                        findings.append(
                            Finding(
                                "WIRE102",
                                "error",
                                mod.rel_path,
                                acc.line,
                                symbol,
                                f"handler for type {t!r} subscripts "
                                f"msg[{acc.key!r}], which only some "
                                f"variants emit (missing from "
                                f"{sorted(set(variants))}) — use "
                                f".get() or handle KeyError",
                            )
                        )
        # WIRE105: inline wire-message construction in consumer modules
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                keys = _dict_keys(node)
                if keys and "type" in keys and _dict_type_value(node):
                    findings.append(
                        Finding(
                            "WIRE105",
                            "warning",
                            mod.rel_path,
                            node.lineno,
                            "<module>",
                            f"inline wire message "
                            f"{{'type': "
                            f"{_dict_type_value(node)!r}, ...}} "
                            f"constructed outside the producer module "
                            f"— add/use a constructor in wire.py",
                        )
                    )

    # WIRE103: types produced but never consumed / consumed but never
    # produced
    for t in sorted(produced_types - consumed_types):
        f, line, _keys = schemas[t].variants[0]
        findings.append(
            Finding(
                "WIRE103",
                "warning",
                producer_mod.rel_path,
                line,
                f,
                f"message type {t!r} is produced but no handler "
                f"dispatches on it",
            )
        )
    for t in sorted(consumed_types - produced_types):
        findings.append(
            Finding(
                "WIRE103",
                "warning",
                producer_mod.rel_path,
                1,
                "<module>",
                f"message type {t!r} is consumed but no constructor "
                f"produces it",
            )
        )
    return findings
