"""Shared AST plumbing for the graftcheck analyzers.

Everything here is pure ``ast`` — the analyzers never import the code
they inspect, so they run identically on a GPU host and on a bare CI
runner with neither torch nor a CUDA toolkit installed.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple


class Module:
    """One parsed source file plus the lookups every analyzer needs."""

    def __init__(self, path: Path, rel_path: str):
        self.path = path
        self.rel_path = rel_path  # repo-relative posix path, for findings
        self.tree = ast.parse(path.read_text(), filename=str(path))
        # import alias → dotted module name ("np" → "numpy"); and
        # from-imports: local name → "module.attr" ("Lock" →
        # "threading.Lock")
        self.import_aliases: Dict[str, str] = {}
        self.from_imports: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_aliases[alias.asname or alias.name] = (
                        alias.name
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )

    def resolve_call(self, call: ast.Call) -> Optional[str]:
        """Best-effort dotted name of a call target, with import aliases
        normalized: ``_queue.Queue(...)`` → "queue.Queue", ``Lock()``
        after ``from threading import Lock`` → "threading.Lock"."""
        return self.resolve_name(call.func)

    def resolve_name(self, node: ast.AST) -> Optional[str]:
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = node.id
        if root in self.import_aliases:
            root = self.import_aliases[root]
        elif root in self.from_imports:
            root = self.from_imports[root]
        parts.append(root)
        return ".".join(reversed(parts))

    def classes(self) -> Iterator[ast.ClassDef]:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                yield node

    def functions(self) -> Iterator[ast.FunctionDef]:
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


def iter_modules(root: Path, rel_to: Path) -> Iterator[Module]:
    """Parse every .py under ``root`` (skipping caches), reporting paths
    relative to ``rel_to``. Syntax errors propagate — an unparseable
    file must fail the gate loudly, not vanish from coverage."""
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        yield Module(path, path.relative_to(rel_to).as_posix())


def self_attr(node: ast.AST) -> Optional[str]:
    """"X" for a ``self.X`` expression, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def call_kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def methods_of(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    out: Dict[str, ast.FunctionDef] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def decorator_names(fn: ast.FunctionDef, mod: Module) -> List[str]:
    """Dotted names of a function's decorators (call decorators resolve
    to their callee: ``@lru_cache(maxsize=None)`` → "functools.lru_cache")."""
    names = []
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        resolved = mod.resolve_name(target)
        if resolved:
            names.append(resolved)
    return names


def names_in(node: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)]


def assign_targets(stmt: ast.stmt) -> List[Tuple[ast.expr, ast.expr]]:
    """(target, value) pairs for plain/annotated/augmented assignments,
    with tuple targets flattened pairwise where the value is a matching
    tuple, else each element paired with the whole value."""
    pairs: List[Tuple[ast.expr, ast.expr]] = []
    if isinstance(stmt, ast.Assign):
        for target in stmt.targets:
            pairs.extend(_flatten(target, stmt.value))
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        pairs.extend(_flatten(stmt.target, stmt.value))
    elif isinstance(stmt, ast.AugAssign):
        pairs.append((stmt.target, stmt.value))
    return pairs


def _flatten(
    target: ast.expr, value: ast.expr
) -> List[Tuple[ast.expr, ast.expr]]:
    if isinstance(target, (ast.Tuple, ast.List)):
        if (
            isinstance(value, (ast.Tuple, ast.List))
            and len(value.elts) == len(target.elts)
        ):
            out = []
            for t, v in zip(target.elts, value.elts):
                out.extend(_flatten(t, v))
            return out
        return [(t, value) for t in target.elts]
    return [(target, value)]
