"""Torch hot-path hygiene analyzer (TORCH1xx) for serving-path modules.

The serving path (``engine.py``, ``parallel/``) has a hard contract: one
device→host transfer per request, at a documented sync point, on kernels
that were built and loaded before serving began. Four hazard classes
silently break it:

  * an *implicit* host sync — ``.item()``/``.tolist()``/``float``/
    ``int``/``bool``/``np.asarray``/``np.array``, or an ``if``/``while``/
    ``assert`` through ``Tensor.__bool__``, applied to a device tensor —
    stalls the calling thread mid-pipeline where nobody expects a
    transfer. The allowed forms are an explicit ``.cpu()`` /
    ``.to("cpu")``, or a ``copy_`` into a pinned host buffer followed by
    a ``synchronize()``, at the documented sync point: their results read
    as host-safe;
  * a pinned host buffer filled by a ``non_blocking=True`` copy and read
    before the event recorded after the copy (or its stream, or the
    device) was synchronized reads whatever the buffer held before — a
    wrong answer, not a slow one;
  * a kernel library built or loaded per call (``nvcc`` or ``dlopen`` on
    the request path);
  * a ``SegmentPool`` read after a call that consumed it: the segment
    kernels update the pool's tensors in place and return the next
    handle, so the old handle's tensors already hold the next state.

Rules (all error severity; each number keeps the JAX1xx hazard it
mirrors):

  TORCH101  implicit host sync on a device-derived value in a
            serving-path module (JAX101).
  TORCH102  host read (``.numpy()``, ``.tolist()``, ``.item()``,
            subscript, ``np.asarray``) of a pinned buffer filled by a
            ``non_blocking=True`` ``copy_``, or of a ``(host, ready)``
            pair's host, with no ``synchronize()`` of its event, a stream
            or the device between the copy and the read; and a
            ``wait_event``/``synchronize``/``wait`` on an event created
            in the function or class that nothing there ever records
            (a never-recorded event is complete at once, so the wait
            protects nothing).
  TORCH104  ``load_library``/``build``/``rebuild_library``/
            ``ctypes.CDLL`` called inside a function that is neither
            module setup (``__init__``) nor memoized with
            ``functools.lru_cache``/``cache``, nor a declared rebuild
            seam (:data:`REBUILD_SEAMS`) — a per-call ``nvcc`` build or
            ``dlopen`` (JAX104).
  TORCH105  read of a ``SegmentPool`` after a call that consumed it
            (``dfs_segment`` and the engine's segment seams, see
            :data:`POOL_CONSUMERS`), unless the same statement rebinds
            the name from the call's results; a later independent rebind
            launders reads strictly after it. Locals and ``self.X``
            attributes (JAX105).

The port traces nothing — no ``torch.compile``, no ``torch.jit`` — so
JAX102 (a Python branch on a traced value) and JAX103 (an unhashable
static jit argument), both trace-time hazards, have no counterpart, and
the numbers TORCH102/TORCH103 do not take their JAX meaning.

Device taint is tracked per function, lexically by line: a name reads
as its nearest earlier assignment; a name used before any assignment
reads as a parameter (untainted), unless a loop around the use binds it
later in its body (the loop-carried case). Sources are the kernel
wrappers of ``ops/cuda_solver`` (:data:`DEVICE_SOURCES`), ``.to(<device>)``,
``.cuda()``, ``torch.*`` calls given a ``device=`` that is not
``"cpu"``, and *device factories*: functions and methods of the module
whose return value is device-derived (to a fixed point, with tuple
returns tracked per position, so ``packed, pool = self._quick_state()``
taints only ``pool``). Attribute, subscript, arithmetic, method calls
on a device tensor and ``torch.*`` calls over one propagate;
``.shape``/``.dtype``/``.ndim``/``.device``/``.numel()``/``.size()``
are static metadata and drop the taint. ``self.X`` attributes assigned
a device value in any method of the class read as device values.
Function parameters are untainted by default (host arrays until proven
otherwise), so ``np.asarray(board, np.int32)``-style ingress
normalization never false-positives.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple, Union

from ._astutil import Module, assign_targets, call_kw, decorator_names, self_attr
from .findings import Finding

# the kernel wrappers of ops/cuda_solver, and the entry points there that
# return their outputs: a call to one yields device tensors
DEVICE_SOURCES = frozenset((
    "dfs_solver",
    "dfs_segment",
    "dfs_race",
    "dfs_race_shards",
    "race_fold",
    "seed_frontier_cuda",
    "solve_stage",
    "solve_stage_lockstep",
    "solve_batch_cuda",
))
_SOURCE_MODULE = "cuda_solver"

# calls that consume the SegmentPool at the given positional index (or
# keyword): dfs_segment consumes ``pool`` (ops/cuda_solver.py), and the
# engine's segment seams pass their ``state`` straight to it
POOL_CONSUMERS: Dict[str, Tuple[int, str]] = {
    "dfs_segment": (0, "pool"),
    "dispatch_segment": (0, "state"),
    "run_segment_supervised": (0, "state"),
    "_segment_kernels": (0, "state"),
}

# functions allowed to rebuild the kernel library per call: the engine's
# verified warm-up rebuilds once after a failed round trip, by design
REBUILD_SEAMS = frozenset(("SolverEngine._verified",))

_LOADERS = frozenset(("load_library", "rebuild_library"))
_BUILD_MODULES = ("cuda_solver", "compilecache", "native")

_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}
_STATIC_METHODS = {"numel", "size", "dim", "element_size", "get_device",
                   "is_pinned", "is_contiguous", "data_ptr"}
# host-side results: an explicit transfer, or a conversion that itself
# syncs (flagged where its argument is a device value, clean after)
_HOST_METHODS = {"cpu", "numpy", "item", "tolist"}
_ITER_BUILTINS = {"enumerate", "zip", "reversed", "list", "tuple", "sorted",
                  "iter", "next"}
_MEMO_DECORATORS = {
    "functools.lru_cache",
    "functools.cache",
    "lru_cache",
    "cache",
}
_TORCH_DTYPES = {
    "bool", "uint8", "int8", "int16", "int32", "int64", "long", "int",
    "short", "float", "float16", "float32", "float64", "double", "half",
    "bfloat16", "complex64", "complex128",
}

# a function's return taint: one bool, or one bool per position of a
# tuple it always returns
Taint = Union[bool, Tuple[bool, ...]]


def _any(t: Taint) -> bool:
    return any(t) if isinstance(t, tuple) else bool(t)


def _is_cpu_const(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _source_name(mod: Module, call: ast.Call) -> Optional[str]:
    """The kernel wrapper a call names, or None: ``dfs_solver(...)``
    imported from ops/cuda_solver, or ``cs.dfs_solver(...)`` on the
    module."""
    resolved = mod.resolve_call(call)
    if resolved is None:
        return None
    parts = resolved.split(".")
    if parts[-1] not in DEVICE_SOURCES:
        return None
    if len(parts) >= 2 and parts[-2] == _SOURCE_MODULE:
        return parts[-1]
    if len(parts) == 1:
        return parts[0]  # a bare name defined in the analyzed module
    return None


def _final_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_dtype(mod: Module, node: ast.expr) -> bool:
    resolved = mod.resolve_name(node)
    return (
        resolved is not None
        and resolved.startswith("torch.")
        and resolved.rsplit(".", 1)[1] in _TORCH_DTYPES
    )


class _ModuleIndex:
    """Module-wide pass: which functions are device factories (and with
    which per-position taint), and which ``self`` attributes of each
    class hold device values."""

    def __init__(self, mod: Module):
        self.mod = mod
        # bare function name -> return taint (module-level defs)
        self.func_taint: Dict[str, Taint] = {}
        # (class, method) -> return taint
        self.method_taint: Dict[Tuple[str, str], Taint] = {}
        # class -> device-valued self attributes
        self.attr_taint: Dict[str, Set[str]] = {}
        self._index()

    def units(self):
        """(class name | None, function def, symbol) for every top-level
        function and method."""
        for cls in self.mod.classes():
            for node in cls.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield cls.name, node, f"{cls.name}.{node.name}"
        for fn in self.mod.functions():
            yield None, fn, fn.name

    def _index(self):
        units = list(self.units())
        for _ in range(6):  # fixed point; real modules settle in 2-3
            changed = False
            for cls, fn, _symbol in units:
                walker = _TaintWalker(self.mod, self, fn, cls)
                ret = walker.return_taint()
                table = self.method_taint if cls else self.func_taint
                key = (cls, fn.name) if cls else fn.name
                if ret != table.get(key, False) and _any(ret):
                    table[key] = ret
                    changed = True
                if cls is not None:
                    attrs = self.attr_taint.setdefault(cls, set())
                    new = walker.tainted_self_attrs() - attrs
                    if new:
                        attrs |= new
                        changed = True
            if not changed:
                break


class _TaintWalker:
    """Per-function device taint, lexically by line."""

    def __init__(
        self,
        mod: Module,
        index: _ModuleIndex,
        fn: ast.FunctionDef,
        cls: Optional[str],
    ):
        self.mod = mod
        self.index = index
        self.fn = fn
        self.cls = cls
        # name -> [(line, taint)] in line order
        self.events: Dict[str, List[Tuple[int, bool]]] = {}
        # (first, last) lines of every loop statement in the function
        self.loops: List[Tuple[int, int]] = [
            (n.lineno, getattr(n, "end_lineno", n.lineno))
            for n in ast.walk(fn)
            if isinstance(n, (ast.For, ast.AsyncFor, ast.While))
        ]
        self._build()

    # -- binding events ----------------------------------------------------
    def _bindings(self):
        """(line, target, value, per-position) for every binding in the
        function: assignments, for-loop targets, with-as targets."""
        for node in ast.walk(self.fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                value = node.value
                if value is None:
                    continue
                for target in targets:
                    yield node.lineno, target, value
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                yield node.lineno, node.target, node.iter
            elif isinstance(node, ast.comprehension):
                yield getattr(node.target, "lineno", 0), node.target, node.iter
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        yield node.lineno, item.optional_vars, item.context_expr

    def _build(self):
        bindings = sorted(
            self._bindings(), key=lambda b: b[0]
        )
        for _ in range(3):  # loop-carried names settle in two passes
            events: Dict[str, List[Tuple[int, bool]]] = {}
            for line, target, value in bindings:
                for name, tainted in self._bind(target, value, line):
                    events.setdefault(name, []).append((line, tainted))
            if events == self.events:
                break
            self.events = events

    def _bind(self, target, value, line) -> List[Tuple[str, bool]]:
        if isinstance(target, ast.Name):
            return [(target.id, self.is_tainted(value, line))]
        if isinstance(target, (ast.Tuple, ast.List)):
            if (
                isinstance(value, (ast.Tuple, ast.List))
                and len(value.elts) == len(target.elts)
            ):
                out: List[Tuple[str, bool]] = []
                for t, v in zip(target.elts, value.elts):
                    out.extend(self._bind(t, v, line))
                return out
            per = self._call_taint(value, line)
            if isinstance(per, tuple) and len(per) == len(target.elts):
                out = []
                for t, tainted in zip(target.elts, per):
                    out.extend(
                        (n, tainted) for n in _target_names(t)
                    )
                return out
            whole = self.is_tainted(value, line)
            return [
                (n, whole) for t in target.elts for n in _target_names(t)
            ]
        if isinstance(target, ast.Starred):
            return self._bind(target.value, value, line)
        return []

    def name_tainted(self, name: str, line: int) -> bool:
        events = self.events.get(name)
        if not events:
            return False
        before = [t for ln, t in events if ln < line]
        if before:
            return before[-1]
        # no earlier binding: a parameter (untainted) unless a loop around
        # the use binds the name later in its body (loop-carried)
        return any(
            t
            for ln, t in events
            for first, last in self.loops
            if first <= line <= last and line < ln <= last
        )

    # -- expression taint ----------------------------------------------------
    def _call_taint(self, value: ast.expr, line: int) -> Taint:
        """A call's taint with tuple positions kept where the callee is a
        device factory returning a tuple."""
        if isinstance(value, ast.Call):
            factory = self._factory_taint(value)
            if factory is not None:
                return factory
        return self.is_tainted(value, line)

    def _factory_taint(self, call: ast.Call) -> Optional[Taint]:
        func = call.func
        if isinstance(func, ast.Name):
            return self.index.func_taint.get(func.id)
        attr = self_attr(func)
        if attr is not None and self.cls is not None:
            return self.index.method_taint.get((self.cls, attr))
        return None

    def is_source(self, call: ast.Call) -> bool:
        if _source_name(self.mod, call) is not None:
            return True
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr == "cuda":
                return True
            if func.attr == "to":
                return self._to_device(call)
        resolved = self.mod.resolve_call(call)
        if resolved is not None and resolved.startswith("torch."):
            device = call_kw(call, "device")
            if device is not None and not _is_cpu_const(device):
                return True
        factory = self._factory_taint(call)
        return factory is not None and _any(factory)

    def _to_device(self, call: ast.Call) -> bool:
        """``.to(x)`` moves to a device unless it names the CPU or only a
        dtype."""
        device = call_kw(call, "device")
        if device is not None:
            return not _is_cpu_const(device)
        if not call.args:
            return False
        first = call.args[0]
        if _is_cpu_const(first):
            return False
        if _is_dtype(self.mod, first):
            return False
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return True  # "cuda", "cuda:1"
        return True  # a device expression (self.device, t.device, …)

    def is_launder(self, call: ast.Call) -> bool:
        """An explicit transfer or a host conversion: the result is a
        host value."""
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr in _HOST_METHODS or func.attr in _STATIC_METHODS:
                return True
            if func.attr == "to":
                device = call_kw(call, "device")
                first = call.args[0] if call.args else None
                return _is_cpu_const(device) or _is_cpu_const(first)
        return self.sync_kind(call) is not None

    def is_tainted(self, expr: ast.expr, line: int) -> bool:
        if isinstance(expr, ast.Name):
            return self.name_tainted(expr.id, line)
        if isinstance(expr, ast.Call):
            if self.is_launder(expr):
                return False
            if self.is_source(expr):
                return True
            func = expr.func
            name = _final_name(func)
            if isinstance(func, ast.Attribute) and self_attr(func) is None:
                # a method of a device tensor returns a device tensor
                if self.is_tainted(func.value, line):
                    return True
            resolved = self.mod.resolve_call(expr)
            if (
                resolved is not None and resolved.startswith("torch.")
            ) or (isinstance(func, ast.Name) and name in _ITER_BUILTINS):
                return any(
                    self.is_tainted(a, line) for a in expr.args
                ) or any(
                    self.is_tainted(kw.value, line) for kw in expr.keywords
                )
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            attr = self_attr(expr)
            if attr is not None:
                return attr in self.index.attr_taint.get(self.cls or "", set())
            return self.is_tainted(expr.value, line)
        if isinstance(expr, ast.Subscript):
            return self.is_tainted(expr.value, line)
        if isinstance(expr, ast.BinOp):
            return self.is_tainted(expr.left, line) or self.is_tainted(
                expr.right, line
            )
        if isinstance(expr, ast.UnaryOp):
            return self.is_tainted(expr.operand, line)
        if isinstance(expr, ast.BoolOp):
            return any(self.is_tainted(v, line) for v in expr.values)
        if isinstance(expr, ast.Compare):
            if any(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in expr.ops
            ):
                return False  # identity/membership tests read no values
            return self.is_tainted(expr.left, line) or any(
                self.is_tainted(c, line) for c in expr.comparators
            )
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e, line) for e in expr.elts)
        if isinstance(expr, ast.IfExp):
            return self.is_tainted(expr.body, line) or self.is_tainted(
                expr.orelse, line
            )
        if isinstance(expr, ast.Starred):
            return self.is_tainted(expr.value, line)
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            return self.is_tainted(expr.elt, line)
        return False

    def sync_kind(self, call: ast.Call) -> Optional[str]:
        """The human name of the implicit sync this call performs, or
        None. ``.cpu()`` is NOT here — it is the allowed explicit form."""
        func = call.func
        resolved = self.mod.resolve_call(call)
        if resolved in ("numpy.asarray", "numpy.array"):
            return resolved.replace("numpy.", "np.")
        if isinstance(func, ast.Name) and func.id in _SYNC_BUILTINS:
            return f"{func.id}()"
        if isinstance(func, ast.Attribute) and func.attr in ("item", "tolist"):
            return f".{func.attr}()"
        return None

    # -- module-index queries ----------------------------------------------
    def return_taint(self) -> Taint:
        rets: List[Taint] = []
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Return) and node.value is not None:
                if _enclosing_def(self.fn, node) is not self.fn:
                    continue  # a nested def's return
                value = node.value
                if isinstance(value, ast.Tuple):
                    rets.append(
                        tuple(
                            self.is_tainted(e, node.lineno)
                            for e in value.elts
                        )
                    )
                else:
                    rets.append(self._call_taint(value, node.lineno))
        if not rets:
            return False
        tuples = [r for r in rets if isinstance(r, tuple)]
        if len(tuples) == len(rets) and len({len(t) for t in tuples}) == 1:
            return tuple(
                any(t[i] for t in tuples) for i in range(len(tuples[0]))
            )
        return any(_any(r) for r in rets)

    def tainted_self_attrs(self) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(self.fn):
            for target, value in assign_targets(node) if isinstance(
                node, (ast.Assign, ast.AnnAssign)
            ) else []:
                name = self_attr(target)
                if name is not None and self.is_tainted(value, node.lineno):
                    out.add(name)
        return out


def _target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _target_names(e)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _enclosing_def(root: ast.AST, target: ast.AST) -> Optional[ast.AST]:
    """The innermost def under ``root`` (``root`` included) containing
    ``target``."""
    best = None

    def visit(node, current):
        nonlocal best
        if node is target:
            best = current
            return
        for child in ast.iter_child_nodes(node):
            visit(
                child,
                child
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda))
                else current,
            )

    visit(root, root)
    return best


# -- TORCH101 ----------------------------------------------------------------

def _implicit_sync_findings(
    mod: Module, index: _ModuleIndex, findings: List[Finding]
) -> None:
    for cls, fn, symbol in index.units():
        walker = _TaintWalker(mod, index, fn, cls)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                kind = walker.sync_kind(node)
                if kind is None:
                    continue
                if kind in (".item()", ".tolist()"):
                    args = [node.func.value]
                else:
                    args = list(node.args[:1])
                if any(walker.is_tainted(a, node.lineno) for a in args):
                    findings.append(_sync_finding(mod, node, symbol, kind))
                continue
            test = None
            if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                test = node.test
            if test is not None and walker.is_tainted(test, node.lineno):
                kind = {
                    ast.If: "if", ast.While: "while", ast.Assert: "assert",
                    ast.IfExp: "conditional expression",
                }[type(node)]
                findings.append(
                    _sync_finding(mod, node, symbol, f"{kind} (Tensor.__bool__)")
                )


def _sync_finding(mod: Module, node: ast.AST, symbol: str, kind: str) -> Finding:
    return Finding(
        "TORCH101",
        "error",
        mod.rel_path,
        node.lineno,
        symbol,
        f"implicit host sync: {kind} on a device tensor — fetch it "
        f"explicitly (.cpu(), or a pinned copy_ and its event's "
        f"synchronize()) at a documented sync point",
    )


# -- TORCH102 ----------------------------------------------------------------

def _is_event_ctor(mod: Module, value: ast.expr) -> bool:
    return (
        isinstance(value, ast.Call)
        and mod.resolve_call(value) in ("torch.cuda.Event", "torch.Event")
    )


def _recv_key(node: ast.expr) -> Optional[str]:
    """A stable key for a receiver: ``name`` or ``self.X`` or
    ``name.attr``."""
    if isinstance(node, ast.Name):
        return node.id
    attr = self_attr(node)
    if attr is not None:
        return f"self.{attr}"
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    return None


def _class_events(mod: Module, cls: ast.ClassDef) -> Tuple[Set[str], Set[str]]:
    """(self attrs assigned an event, self attrs recorded) over a class."""
    created: Set[str] = set()
    recorded: Set[str] = set()
    for node in ast.walk(cls):
        for target, value in assign_targets(node) if isinstance(
            node, (ast.Assign, ast.AnnAssign)
        ) else []:
            name = self_attr(target)
            if name is None:
                continue
            if _is_event_ctor(mod, value):
                created.add(name)
            elif _is_record_event(value):
                recorded.add(name)
        if isinstance(node, ast.Call):
            key = _recorded_key(node)
            if key is not None and key.startswith("self."):
                recorded.add(key[5:])
    return created, recorded


def _is_record_event(value: ast.expr) -> bool:
    """``stream.record_event()``: returns an event already recorded."""
    return (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Attribute)
        and value.func.attr == "record_event"
    )


def _recorded_key(call: ast.Call) -> Optional[str]:
    """The event a call records: ``E.record(...)`` or
    ``stream.record_event(E)``."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "record":
        return _recv_key(func.value)
    if func.attr == "record_event" and call.args:
        return _recv_key(call.args[0])
    return None


def _pair_producers(index: _ModuleIndex) -> Set[Tuple[Optional[str], str]]:
    """Functions returning a ``(host, ready)`` pair: a 2-tuple whose
    second element is a name bound to ``torch.cuda.Event(...)``."""
    out: Set[Tuple[Optional[str], str]] = set()
    for cls, fn, _symbol in index.units():
        events = {
            target.id
            for node in ast.walk(fn)
            for target, value in (
                assign_targets(node)
                if isinstance(node, (ast.Assign, ast.AnnAssign)) else []
            )
            if isinstance(target, ast.Name)
            and _is_event_ctor(index.mod, value)
        }
        if not events:
            continue
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Return)
                and isinstance(node.value, ast.Tuple)
                and len(node.value.elts) == 2
                and isinstance(node.value.elts[1], ast.Name)
                and node.value.elts[1].id in events
            ):
                out.add((cls, fn.name))
    return out


def _pinned_read_findings(
    mod: Module, index: _ModuleIndex, findings: List[Finding]
) -> None:
    producers = _pair_producers(index)
    class_events = {
        cls.name: _class_events(mod, cls) for cls in mod.classes()
    }
    for cls, fn, symbol in index.units():
        # pending buffers: key -> (line the copy was enqueued, event key)
        pending: List[Tuple[str, int, Optional[str]]] = []
        syncs: List[Tuple[int, Optional[str]]] = []  # (line, receiver)
        local_events: Set[str] = set()
        recorded: Set[str] = set()
        waits: List[Tuple[int, str, str]] = []  # line, event key, how
        pair_objects: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target, value in assign_targets(node):
                    if isinstance(target, ast.Name) and _is_event_ctor(
                        mod, value
                    ):
                        local_events.add(target.id)
                    if isinstance(target, ast.Name) and _is_record_event(value):
                        recorded.add(target.id)
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and len(node.targets[0].elts) == 2
                    and isinstance(node.value, ast.Call)
                ):
                    callee = node.value.func
                    name = _final_name(callee)
                    owner = cls if self_attr(callee) is not None else None
                    if (owner, name) in producers or (None, name) in producers:
                        host, ready = node.targets[0].elts
                        if isinstance(host, ast.Name):
                            pending.append(
                                (host.id, node.lineno, _recv_key(ready))
                            )
            if not isinstance(node, ast.Call):
                if (
                    isinstance(node, ast.Attribute)
                    and node.attr == "ready"
                    and isinstance(node.value, ast.Name)
                ):
                    pair_objects.add(node.value.id)
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                if mod.resolve_call(node) == "torch.cuda.synchronize":
                    syncs.append((node.lineno, None))
                continue
            key = _recorded_key(node)
            if key is not None:
                recorded.add(key)
            if func.attr == "copy_":
                nb = call_kw(node, "non_blocking")
                if isinstance(nb, ast.Constant) and nb.value is True:
                    buf = _recv_key(func.value)
                    if buf is not None:
                        pending.append((buf, node.lineno, None))
            elif func.attr == "synchronize":
                if mod.resolve_call(node) == "torch.cuda.synchronize":
                    syncs.append((node.lineno, None))
                else:
                    recv = _recv_key(func.value)
                    syncs.append((node.lineno, recv))
                    if recv is not None:
                        waits.append((node.lineno, recv, "synchronize()"))
            elif func.attr == "wait" and not node.args:
                recv = _recv_key(func.value)
                if recv is not None:
                    waits.append((node.lineno, recv, "wait()"))
            elif func.attr == "wait_event" and node.args:
                recv = _recv_key(node.args[0])
                if recv is not None:
                    waits.append((node.lineno, recv, "wait_event()"))
        # pair objects carried in from elsewhere: `call.host` with
        # `call.ready` in the same function, copied before it began
        for obj in pair_objects:
            pending.append((f"{obj}.host", fn.lineno, f"{obj}.ready"))
        events = local_events | {
            f"self.{a}" for a in class_events.get(cls or "", (set(), set()))[0]
        }
        # fill in the event recorded after each copy_ (the next record)
        reads = _host_reads(mod, fn)
        flagged: Set[str] = set()
        for buf, line, event in pending:
            for read_line, read_key, how in reads:
                if read_key != buf or read_line < line or buf in flagged:
                    continue
                if read_line == line and event is None:
                    continue  # the copy_ call itself
                if _synced(syncs, events, line, read_line, event):
                    continue
                flagged.add(buf)
                findings.append(
                    Finding(
                        "TORCH102",
                        "error",
                        mod.rel_path,
                        read_line,
                        symbol,
                        f"{how} reads pinned buffer {buf!r} filled by a "
                        f"non_blocking copy with no synchronize() of its "
                        f"event, stream or the device before the read — "
                        f"it may still hold the previous contents",
                    )
                )
        cls_recorded = {
            f"self.{a}"
            for a in class_events.get(cls or "", (set(), set()))[1]
        }
        for line, key, how in waits:
            if key not in events:
                continue  # an event made elsewhere (a parameter, a pair)
            if key in recorded or key in cls_recorded:
                continue
            findings.append(
                Finding(
                    "TORCH102",
                    "error",
                    mod.rel_path,
                    line,
                    symbol,
                    f"{how} on event {key!r} that nothing in this "
                    f"function or class records — a never-recorded event "
                    f"is complete at once, so the wait orders nothing",
                )
            )


def _synced(syncs, events, start: int, end: int, event: Optional[str]) -> bool:
    for line, recv in syncs:
        if not (start <= line <= end):
            continue
        if recv is None:
            return True  # torch.cuda.synchronize(): the whole device
        if event is not None and recv == event:
            return True
        if recv not in events and not recv.endswith(".ready"):
            return True  # a stream's synchronize()
        if event is None and recv in events:
            return True  # the event recorded after a copy_
    return False


def _host_reads(mod: Module, fn: ast.FunctionDef) -> List[Tuple[int, str, str]]:
    """(line, buffer key, how) for every host read in the function."""
    out: List[Tuple[int, str, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in (
                "numpy", "tolist", "item"
            ):
                key = _recv_key(func.value)
                if key is not None:
                    out.append((node.lineno, key, f".{func.attr}()"))
            elif mod.resolve_call(node) in ("numpy.asarray", "numpy.array"):
                if node.args:
                    key = _recv_key(node.args[0])
                    if key is not None:
                        out.append((node.lineno, key, "np.asarray()"))
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            key = _recv_key(node.value)
            if key is not None:
                out.append((node.lineno, key, "a subscript"))
    out.sort()
    return out


# -- TORCH104 ----------------------------------------------------------------

def _is_build_or_load(mod: Module, call: ast.Call) -> Optional[str]:
    resolved = mod.resolve_call(call)
    if resolved == "ctypes.CDLL":
        return "ctypes.CDLL"
    name = _final_name(call.func)
    if name in _LOADERS:
        return name
    if name == "build" and resolved is not None:
        parts = resolved.split(".")
        if len(parts) >= 2 and parts[-2] in _BUILD_MODULES:
            return resolved
    return None


def _build_in_function_findings(mod: Module, findings: List[Finding]) -> None:
    def walk(body, owner: Optional[str], allowed: bool, cls: Optional[str]):
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk(node.body, None, False, node.name)
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{cls}.{node.name}" if cls else node.name
                ok = (
                    allowed
                    or bool(set(decorator_names(node, mod)) & _MEMO_DECORATORS)
                    or node.name == "__init__"
                    or name in REBUILD_SEAMS
                )
                walk(node.body, owner or name, ok, cls)
                continue
            if owner is None or allowed:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                what = _is_build_or_load(mod, sub)
                if what is None:
                    continue
                findings.append(
                    Finding(
                        "TORCH104",
                        "error",
                        mod.rel_path,
                        sub.lineno,
                        owner,
                        f"{what} called inside {owner!r}, which is neither "
                        f"setup nor lru_cache-memoized nor a declared "
                        f"rebuild seam — a per-call kernel build or dlopen "
                        f"on the serving path; load once and keep the handle",
                    )
                )

    walk(mod.tree.body, None, False, None)


# -- TORCH105 ----------------------------------------------------------------

def _consumed_arg(call: ast.Call) -> Optional[ast.expr]:
    name = _final_name(call.func)
    if name not in POOL_CONSUMERS:
        return None
    index, keyword = POOL_CONSUMERS[name]
    if len(call.args) > index:
        return call.args[index]
    return call_kw(call, keyword)


def _ref_key(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    attr = self_attr(node)
    if attr is not None:
        return f"self.{attr}"
    return None


def _consumed_pool_findings(
    mod: Module, index: _ModuleIndex, findings: List[Finding]
) -> None:
    for _cls, fn, symbol in index.units():
        consumed: List[Tuple[str, int, str]] = []  # key, end line, callee
        assigns: List[Tuple[str, int]] = []
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.stmt):
                continue
            rebound: Set[str] = set()
            for target, _value in assign_targets(stmt):
                for t in (
                    target.elts if isinstance(target, (ast.Tuple, ast.List))
                    else [target]
                ):
                    key = _ref_key(t)
                    if key is not None:
                        rebound.add(key)
                        assigns.append((key, stmt.lineno))
            # only THIS statement's own expressions: a compound statement
            # must not re-visit its children's statements
            exprs: List[ast.expr] = []
            for _field, value in ast.iter_fields(stmt):
                if isinstance(value, ast.expr):
                    exprs.append(value)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.expr):
                            exprs.append(v)
                        elif isinstance(v, ast.withitem):
                            exprs.append(v.context_expr)
            for sub in (n for e in exprs for n in ast.walk(e)):
                if not isinstance(sub, ast.Call):
                    continue
                arg = _consumed_arg(sub)
                key = _ref_key(arg) if arg is not None else None
                if key is None or key in rebound:
                    continue
                end = getattr(sub, "end_lineno", None) or sub.lineno
                consumed.append((key, end, _final_name(sub.func) or "?"))
        for key, end, callee in consumed:
            later = [ln for k, ln in assigns if k == key and ln > end]
            clear_at = min(later) if later else None
            for node in ast.walk(fn):
                if (
                    isinstance(node, (ast.Name, ast.Attribute))
                    and isinstance(node.ctx, ast.Load)
                    and _ref_key(node) == key
                    and node.lineno > end
                    and (clear_at is None or node.lineno <= clear_at)
                ):
                    findings.append(
                        Finding(
                            "TORCH105",
                            "error",
                            mod.rel_path,
                            node.lineno,
                            symbol,
                            f"use of {key!r} after {callee!r} consumed "
                            f"it — the segment kernels updated its tensors "
                            f"in place and returned the next handle; "
                            f"rebind the name from the call's results",
                        )
                    )
                    break  # one finding per consumption is signal enough


def analyze_module(mod: Module) -> List[Finding]:
    """All torch-hygiene rules over one serving-path module."""
    findings: List[Finding] = []
    index = _ModuleIndex(mod)
    _implicit_sync_findings(mod, index, findings)
    _pinned_read_findings(mod, index, findings)
    _build_in_function_findings(mod, findings)
    _consumed_pool_findings(mod, index, findings)
    return findings
