"""Analyzer orchestration: configuration, module discovery, one entry
point shared by the CLI (``__main__``) and the tier-1 test suite.

The package tree is parsed exactly once (``iter_modules``) and the
inter-procedural call graph (analysis/callgraph.py) is built exactly
once; every analyzer that needs cross-function reachability — seams,
thread-context, cross-class lock order, wire-consumer discovery —
shares both. That keeps the whole gate to a few seconds of one core, so
it can run on every commit and as the first phase of ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import callgraph, locks, seams, threadctx, torch_hygiene, wire_schema
from ._astutil import Module, iter_modules
from .findings import Finding

_PKG_DIR = Path(__file__).resolve().parent.parent   # the package
_REPO_ROOT = _PKG_DIR.parent                        # its checkout


@dataclasses.dataclass
class Config:
    """What to analyze. Defaults describe THIS package's tree; tests
    point the fields at fixture trees."""

    # repo root: findings are reported relative to it
    root: Path = _REPO_ROOT
    # package tree the lock analyzer sweeps (every class with a lock)
    package: Path = _PKG_DIR
    # serving-path scope for the torch-hygiene rules, relative to package
    serving: Tuple[str, ...] = ("engine.py", "parallel")
    # wire producer module, relative to package
    wire_producer: str = "net/wire.py"
    # wire consumer modules, relative to package. None (the default)
    # AUTO-DISCOVERS them from the call graph: every module with a
    # ``msg``-param function reachable from a ``decode_msg`` call site,
    # so a new handler module (cache/gossip.py, say) is analyzed without
    # anyone remembering to list it; an explicit tuple is still honored
    # for fixture trees.
    wire_consumers: Optional[Tuple[str, ...]] = None
    # baseline file (None = no suppression)
    baseline: Optional[Path] = _PKG_DIR / "analysis" / "baseline.toml"
    # which analyzers to run
    analyzers: Tuple[str, ...] = ("locks", "torch", "wire", "seams", "thread")
    # dispatch shapes for the seam analyzer (None = the package registry,
    # which silently no-ops on fixture trees; tests pass ShapeSpecs)
    shapes: Optional[Sequence[seams.ShapeSpec]] = None


@dataclasses.dataclass
class AnalysisResult:
    """Everything one analysis run produced: raw findings (baseline NOT
    applied), the five-shape contract matrix (empty dict unless the
    seam analyzer ran), the wire-consumer modules actually analyzed
    (relative to the package), and wall time."""

    findings: List[Finding]
    contract_matrix: Dict
    wire_consumers: Tuple[str, ...]
    wall_s: float


def default_config() -> Config:
    return Config()


def _is_serving(rel_to_pkg: str, serving: Sequence[str]) -> bool:
    for entry in serving:
        if rel_to_pkg == entry or rel_to_pkg.startswith(
            entry.rstrip("/") + "/"
        ):
            return True
    return False


def discover_wire_consumers(
    graph: callgraph.CallGraph,
    by_rel_pkg: Dict[str, Module],
    producer: str,
) -> Tuple[str, ...]:
    """Modules that consume wire messages, from the call graph: walk
    forward from every function that calls ``decode_msg``; any reached
    function taking a ``msg`` parameter marks its module. The producer
    module itself is excluded (``encode_msg(msg)`` is reached too), and
    only modules where the wire analyzer can actually extract consumer
    accesses survive the filter."""
    rel_of = {id(mod): rel for rel, mod in by_rel_pkg.items()}
    roots = [
        key
        for key, node in graph.nodes.items()
        if "decode_msg" in node.call_names
    ]
    marked: set = set()
    for key in graph.reachable(roots):
        node = graph.nodes[key]
        rel = rel_of.get(id(node.mod))
        if rel is None or rel == producer:
            continue
        if "msg" in node.params():
            marked.add(rel)
    return tuple(
        rel
        for rel in sorted(marked)
        if wire_schema.extract_consumers(by_rel_pkg[rel])
    )


def run_analysis(config: Optional[Config] = None) -> AnalysisResult:
    """Parse once, build the call graph once, run the configured
    analyzers. Findings are RAW (baseline not applied — callers use
    ``load_baseline``/``apply_baseline``, or the CLI which does it for
    them)."""
    cfg = config or default_config()
    t0 = time.perf_counter()
    findings: List[Finding] = []
    matrix: Dict = {}
    consumers_used: Tuple[str, ...] = ()

    modules = list(iter_modules(cfg.package, cfg.root))
    by_rel_pkg = {
        m.path.relative_to(cfg.package).as_posix(): m for m in modules
    }
    need_graph = bool(
        {"locks", "seams", "thread"} & set(cfg.analyzers)
    ) or ("wire" in cfg.analyzers and cfg.wire_consumers is None)
    graph = callgraph.build_graph(modules) if need_graph else None

    if "locks" in cfg.analyzers:
        for mod in modules:
            findings.extend(locks.analyze_module(mod))
        findings.extend(locks.analyze_cross(modules, graph))

    if "torch" in cfg.analyzers:
        for rel, mod in by_rel_pkg.items():
            if _is_serving(rel, cfg.serving):
                findings.extend(torch_hygiene.analyze_module(mod))

    if "seams" in cfg.analyzers:
        seam_findings, matrix = seams.evaluate(graph, cfg.shapes)
        findings.extend(seam_findings)

    if "thread" in cfg.analyzers:
        findings.extend(threadctx.analyze(graph))

    if "wire" in cfg.analyzers:
        producer = by_rel_pkg.get(cfg.wire_producer)
        if producer is None:
            producer_path = cfg.package / cfg.wire_producer
            if producer_path.exists():
                producer = Module(
                    producer_path,
                    producer_path.relative_to(cfg.root).as_posix(),
                )
        if cfg.wire_consumers is not None:
            consumers_used = tuple(
                c for c in cfg.wire_consumers if c in by_rel_pkg
            )
        elif graph is not None:
            consumers_used = discover_wire_consumers(
                graph, by_rel_pkg, cfg.wire_producer
            )
        consumers = [by_rel_pkg[c] for c in consumers_used]
        if producer is not None and consumers:
            findings.extend(wire_schema.analyze(producer, consumers))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return AnalysisResult(
        findings=findings,
        contract_matrix=matrix,
        wire_consumers=consumers_used,
        wall_s=time.perf_counter() - t0,
    )


def run_analyzers(config: Optional[Config] = None) -> List[Finding]:
    """Findings-only wrapper kept for existing callers/tests."""
    return run_analysis(config).findings
