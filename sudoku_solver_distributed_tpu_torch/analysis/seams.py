"""Dispatch-contract seam analyzer (SEAM1xx) + the five-shape contract
matrix.

Every device dispatch in this package is supposed to run under one
five-part contract, threaded by hand through five dispatch shapes
(single, batch, frontier, farm, continuous segments):

  1. **supervision** — a watchdog token opens before the device call and
     closes after it (``call_started``/``call_finished``/
     ``call_abandoned``, serving/health.py), so a hung program is
     declared, its bucket quarantined, and the breaker fed.
  2. **trace** — per-request stage stamps (``tr.mark("queue"/"coalesce"/
     "device"/"verify"/"cache")``, obs/trace.py) so a slow answer can be
     attributed to a stage.
  3. **cost** — a cost-plane record (``record_call``/``note_formation``/
     ``note_segment``/``note_farm``/``note_frontier``, obs/cost.py) so
     device spend reconciles with admission.
  4. **deadline** — the admission deadline is checked before (and,
     where the shape allows, during) dispatch, shedding expired work
     with ``DeadlineExceeded`` instead of burning device time on it.
  5. **fallback** — a reachable degraded path (``fallback_solve`` and
     friends) so a broken device demotes service instead of erroring.

This analyzer enumerates, over the shared call graph
(analysis/callgraph.py), every path from a shape's route-core entry to
its kernel-launch seam (the declared sink function), bridging
thread handoffs (coalescer submit → driver loop) with a declared,
validated handoff table. A leg is covered when any function on any
enumerated path — or a declared completion-side function
(``extras``, e.g. ``_finalize_padded``, which runs on the completer
thread) — directly contains that leg's marker. Coverage is the UNION
over a shape's paths: the contract is per-shape, and markers commonly
sit on exactly one spine function.

Rules (all error severity):

  SEAM101  dispatch shape has no supervision open/close on any path.
  SEAM102  dispatch shape has no trace-stage stamp on any path.
  SEAM103  dispatch shape has no cost-plane record on any path.
  SEAM104  dispatch shape has no deadline check on any path.
  SEAM105  dispatch shape has no reachable degraded fallback.
  SEAM106  shape registry rot: a declared entry/sink/handoff/extra
           symbol no longer exists, or no path connects entry to sink —
           the registry must be corrected, never left silently dead.

The ``contract_matrix`` output (``--json``) is the machine-readable
five-shape × five-leg inventory: for each shape it lists the witness
path, per-leg coverage, and WHICH functions currently provide each
leg — i.e. exactly the code a refactor of the dispatch seams must
absorb or re-home.

Package registry vs fixtures: with ``shapes=None`` the analyzer uses
the package's declared shapes and silently no-ops when NONE of their
entries resolve (fixture trees); tests pass explicit
:class:`ShapeSpec`\\ s.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import CallGraph, FuncNode
from .findings import Finding

LEGS = ("supervision", "trace", "cost", "deadline", "fallback")

_LEG_RULE = {
    "supervision": "SEAM101",
    "trace": "SEAM102",
    "cost": "SEAM103",
    "deadline": "SEAM104",
    "fallback": "SEAM105",
}

_SUPERVISION_CALLS = {"call_started", "call_finished", "call_abandoned"}
_TRACE_CALLS = {"mark", "start_trace"}
_COST_CALLS = {
    "record_call",
    "_record_call_cost",
    "note_formation",
    "note_segment",
    "note_farm",
    "note_frontier",
}

MATRIX_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One declared dispatch shape: route-core entry, kernel-launch
    sink(s), thread handoffs bridged by queues/conditions, and
    completion-side functions whose markers count as on-path."""

    shape: str
    entry: Tuple[str, str]                    # (path suffix, symbol)
    sinks: Tuple[Tuple[str, str], ...]
    handoffs: Tuple[
        Tuple[Tuple[str, str], Tuple[str, str]], ...
    ] = ()
    extras: Tuple[Tuple[str, str], ...] = ()


# The five dispatch shapes of THIS package. Entries are the HTTP route
# cores (net/http_api.py); the segments/single shapes share the /solve
# entry and fork at the coalescer handoff (which driver loop picks the
# request up). Sinks are the kernel-launch seams: ``SolverEngine._launch``
# enqueues a bucket's first depth stage (K1, or one launch a shard on a
# mesh), ``dispatch_segment`` the segment kernels (K3/K3b),
# ``frontier_solve`` the race (K4), ``P2PNode._farm_solve`` the farm's
# per-cell fan-out. SEAM106 validates every symbol here against the call
# graph, so registry rot fails the gate instead of going silently dead.
REPO_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(
        shape="single",
        entry=("net/http_api.py", "solve_route"),
        sinks=(("engine.py", "SolverEngine._launch"),),
        handoffs=(
            (
                ("parallel/coalescer.py", "BatchCoalescer.submit"),
                ("parallel/coalescer.py", "BatchCoalescer._dispatcher_loop"),
            ),
        ),
        extras=(
            ("parallel/coalescer.py", "BatchCoalescer._completer_loop"),
            ("engine.py", "SolverEngine._finalize_padded"),
        ),
    ),
    ShapeSpec(
        shape="batch",
        entry=("net/http_api.py", "solve_batch_route"),
        # same launch seam as the single shape: each chunk runs through the
        # synchronous _solve_padded composition of _dispatch_padded +
        # _finalize_padded, so the supervision token and cost record ride
        # the shared seam; the finalize pair is the off-spine
        # continuation, exactly like single's completer extras
        sinks=(("engine.py", "SolverEngine._launch"),),
        extras=(
            ("engine.py", "SolverEngine._finalize_padded"),
            ("engine.py", "SolverEngine._finalize_padded_inner"),
        ),
    ),
    ShapeSpec(
        shape="frontier",
        entry=("net/http_api.py", "solve_route"),
        sinks=(("parallel/frontier.py", "frontier_solve"),),
    ),
    ShapeSpec(
        shape="farm",
        entry=("net/http_api.py", "solve_route"),
        sinks=(("net/node.py", "P2PNode._farm_solve"),),
    ),
    ShapeSpec(
        shape="segments",
        entry=("net/http_api.py", "solve_route"),
        sinks=(("engine.py", "SolverEngine.dispatch_segment"),),
        handoffs=(
            (
                ("parallel/coalescer.py", "BatchCoalescer.submit"),
                ("parallel/coalescer.py", "BatchCoalescer._segment_loop"),
            ),
            (
                ("parallel/coalescer.py", "BatchCoalescer.submit"),
                (
                    "parallel/coalescer.py",
                    "BatchCoalescer._segment_loop_pipelined",
                ),
            ),
        ),
        extras=(("engine.py", "SolverEngine.finalize_segment"),),
    ),
)


def _compares_deadline(node: FuncNode) -> bool:
    for sub in ast.walk(node.fn):
        if not isinstance(sub, ast.Compare):
            continue
        for name_node in ast.walk(sub):
            ident = None
            if isinstance(name_node, ast.Name):
                ident = name_node.id
            elif isinstance(name_node, ast.Attribute):
                ident = name_node.attr
            if ident is not None and "deadline" in ident.lower():
                return True
    return False


def leg_markers(node: FuncNode) -> Dict[str, bool]:
    """Which of the five contract legs this one function directly
    carries a marker for."""
    names = node.call_names
    idents = node.identifiers
    return {
        "supervision": bool(names & _SUPERVISION_CALLS),
        "trace": bool(names & _TRACE_CALLS),
        "cost": bool(names & _COST_CALLS),
        "deadline": (
            "DeadlineExceeded" in idents or _compares_deadline(node)
        ),
        "fallback": any("fallback" in i.lower() for i in idents),
    }


def evaluate(
    graph: CallGraph,
    shapes: Optional[Sequence[ShapeSpec]] = None,
) -> Tuple[List[Finding], Dict]:
    """(findings, contract matrix) for the given shapes.

    ``shapes=None`` uses :data:`REPO_SHAPES`; if none of their entries
    resolve (a fixture tree), the result is empty rather than a wall of
    SEAM106 noise about a registry that was never meant to describe the
    analyzed tree.
    """
    registry_mode = shapes is None
    specs = REPO_SHAPES if shapes is None else tuple(shapes)
    findings: List[Finding] = []
    matrix: Dict = {
        "schema_version": MATRIX_SCHEMA_VERSION,
        "legs": list(LEGS),
        "shapes": [],
    }
    if registry_mode and not any(
        graph.find(*spec.entry) for spec in specs
    ):
        return findings, matrix

    for spec in specs:
        entry_key = graph.find(*spec.entry)
        missing: List[str] = []
        if entry_key is None:
            missing.append(f"entry {spec.entry[0]}::{spec.entry[1]}")
        sink_keys: Set[str] = set()
        for ref in spec.sinks:
            key = graph.find(*ref)
            if key is None:
                missing.append(f"sink {ref[0]}::{ref[1]}")
            else:
                sink_keys.add(key)
        extra_edges: Dict[str, List[str]] = {}
        for src_ref, dst_ref in spec.handoffs:
            src = graph.find(*src_ref)
            dst = graph.find(*dst_ref)
            if src is None:
                missing.append(f"handoff {src_ref[0]}::{src_ref[1]}")
            if dst is None:
                missing.append(f"handoff {dst_ref[0]}::{dst_ref[1]}")
            if src is not None and dst is not None:
                extra_edges.setdefault(src, []).append(dst)
        extra_keys: Set[str] = set()
        for ref in spec.extras:
            key = graph.find(*ref)
            if key is None:
                missing.append(f"extra {ref[0]}::{ref[1]}")
            else:
                extra_keys.add(key)
        if missing:
            findings.append(
                _shape_finding(
                    graph,
                    spec,
                    entry_key,
                    "SEAM106",
                    "shape registry rot: "
                    + "; ".join(missing)
                    + " not found in the call graph — fix the "
                    "registry in analysis/seams.py",
                )
            )
            continue

        paths = graph.paths(entry_key, sink_keys, extra_edges)
        if not paths:
            findings.append(
                _shape_finding(
                    graph,
                    spec,
                    entry_key,
                    "SEAM106",
                    f"no dispatch path from "
                    f"{spec.entry[1]} to any declared sink — the "
                    f"shape registry no longer matches the code",
                )
            )
            continue

        on_path: Set[str] = set()
        for trail in paths:
            on_path.update(trail)
        on_path |= extra_keys

        coverage: Dict[str, List[str]] = {leg: [] for leg in LEGS}
        for key in sorted(on_path):
            marks = leg_markers(graph.nodes[key])
            for leg in LEGS:
                if marks[leg]:
                    coverage[leg].append(key)

        witness = min(paths, key=len)
        matrix["shapes"].append(
            {
                "shape": spec.shape,
                "entry": entry_key,
                "sinks": sorted(sink_keys),
                "paths": len(paths),
                "witness": witness,
                "covered": {
                    leg: bool(coverage[leg]) for leg in LEGS
                },
                "provided_by": {
                    leg: coverage[leg] for leg in LEGS
                },
            }
        )
        for leg in LEGS:
            if not coverage[leg]:
                findings.append(
                    _shape_finding(
                        graph,
                        spec,
                        entry_key,
                        _LEG_RULE[leg],
                        f"dispatch shape {spec.shape!r} "
                        f"({spec.entry[1]} → "
                        f"{spec.sinks[0][1]}) has no {leg} leg on any "
                        f"of its {len(paths)} path(s) — the five-part "
                        f"dispatch contract requires one on the spine",
                    )
                )
    return findings, matrix


def analyze(
    graph: CallGraph,
    shapes: Optional[Sequence[ShapeSpec]] = None,
) -> List[Finding]:
    return evaluate(graph, shapes)[0]


def contract_matrix(
    graph: CallGraph,
    shapes: Optional[Sequence[ShapeSpec]] = None,
) -> Dict:
    return evaluate(graph, shapes)[1]


def _shape_finding(
    graph: CallGraph,
    spec: ShapeSpec,
    entry_key: Optional[str],
    rule: str,
    message: str,
) -> Finding:
    if entry_key is not None:
        node = graph.nodes[entry_key]
        path, line = node.mod.rel_path, node.fn.lineno
    else:
        path, line = spec.entry[0], 1
    return Finding(
        rule, "error", path, line, f"dispatch:{spec.shape}", message
    )
