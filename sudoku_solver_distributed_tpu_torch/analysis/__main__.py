"""CLI: ``python -m sudoku_solver_distributed_tpu_torch.analysis [--strict]``.

Exit codes: 0 — no unsuppressed error-severity findings (warnings and
baselined debt are printed but never fail); 1 — unsuppressed errors
exist AND ``--strict`` was given; 2 — the baseline file itself is
invalid (always fatal: an unauditable suppression list means the gate
isn't gating).

The default (non-strict) run is a report: it prints everything and
exits 0, so operators can look at debt without wiring the exit code
into anything. CI runs ``--strict`` (.github/workflows/ci_torch.yml), and
``chip_smoke.py`` runs ``--strict --json`` on the GPU host as its first
phase.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .findings import apply_baseline, load_baseline
from .runner import Config, default_config, run_analysis
from .sarif import to_sarif
from .seams import MATRIX_SCHEMA_VERSION

# rule-id prefix per analyzer: a partial --rules run must only judge the
# baseline entries its analyzers could have re-confirmed
_RULE_PREFIXES = {
    "locks": "LOCK",
    "torch": "TORCH",
    "wire": "WIRE",
    "seams": "SEAM",
    "thread": "THREAD",
}

# --json output contract (pinned by the tests, equal to the JAX
# package's gate): tooling consumes contract_matrix, so additions bump
# JSON_SCHEMA_VERSION and removals/renames are breaking
JSON_SCHEMA_VERSION = 2
_JSON_KEYS = (
    "schema_version",
    "errors",
    "warnings",
    "suppressed",
    "stale_baseline",
    "contract_matrix",
    "wire_consumers",
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sudoku_solver_distributed_tpu_torch.analysis",
        description=(
            "graftcheck: lock-discipline, torch-hygiene, wire-schema, "
            "dispatch-seam and thread-context static analysis for "
            "the PyTorch/CUDA package"
        ),
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="exit 1 on any unsuppressed error-severity finding",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable output (one JSON object)",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help="baseline file (default: analysis/baseline.toml; "
        "'none' disables suppression)",
    )
    parser.add_argument(
        "--package",
        type=Path,
        default=None,
        help="package tree to analyze instead of this package (fixture "
        "trees in tests use this); findings are reported relative to "
        "its parent",
    )
    parser.add_argument(
        "--rules",
        default="locks,torch,wire,seams,thread",
        help="comma-separated analyzer subset "
        "(locks,torch,wire,seams,thread)",
    )
    parser.add_argument(
        "--sarif",
        type=Path,
        default=None,
        help="also write findings as SARIF 2.1.0 to this path "
        "(uploaded by CI so findings annotate PRs inline)",
    )
    args = parser.parse_args(argv)

    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    unknown = [r for r in rules if r not in _RULE_PREFIXES]
    if unknown or not rules:
        # a typo'd subset must not silently run ZERO analyzers and
        # report green — that is a gate that gates nothing
        parser.error(
            f"unknown analyzer(s) {unknown or '(none)'} — valid: "
            f"{sorted(_RULE_PREFIXES)}"
        )

    cfg = default_config()
    package = (args.package or cfg.package).resolve()
    if args.package is not None:
        # fixture mode: report relative to the tree's parent, and use
        # its own baseline (if any) unless one was given explicitly
        default_baseline = package / "analysis" / "baseline.toml"
        root = package.parent
    else:
        default_baseline = cfg.baseline
        root = cfg.root
    cfg = Config(
        root=root,
        package=package,
        serving=cfg.serving,
        wire_producer=cfg.wire_producer,
        wire_consumers=cfg.wire_consumers,
        baseline=(
            None
            if str(args.baseline) == "none"
            else (args.baseline or default_baseline)
        ),
        analyzers=rules,
    )

    result = run_analysis(cfg)
    findings = result.findings
    try:
        entries = (
            load_baseline(cfg.baseline) if cfg.baseline is not None else []
        )
    except ValueError as e:
        print(f"graftcheck: invalid baseline: {e}", file=sys.stderr)
        return 2
    active, suppressed, stale = apply_baseline(findings, entries)
    # an entry can only be stale if the analyzer that would re-confirm it
    # actually ran: `--rules locks` must not report the torch/wire entries
    # as "debt paid — delete it" and talk someone into deleting them
    ran_prefixes = tuple(_RULE_PREFIXES[r] for r in cfg.analyzers)
    stale = [e for e in stale if e.rule.startswith(ran_prefixes)]
    errors = [f for f in active if f.severity == "error"]
    warnings = [f for f in active if f.severity == "warning"]

    if args.sarif is not None:
        args.sarif.write_text(
            json.dumps(to_sarif(active, suppressed), indent=2) + "\n"
        )

    if args.json:
        payload = {
            "schema_version": JSON_SCHEMA_VERSION,
            "errors": [vars(f) for f in errors],
            "warnings": [vars(f) for f in warnings],
            "suppressed": [vars(f) for f in suppressed],
            "stale_baseline": [vars(e) for e in stale],
            # the five-shape × five-leg dispatch-contract inventory
            # (seams.MATRIX_SCHEMA_VERSION inside; {} if seams not run)
            "contract_matrix": result.contract_matrix,
            "wire_consumers": list(result.wire_consumers),
        }
        assert set(payload) == set(_JSON_KEYS)
        assert (
            not result.contract_matrix
            or result.contract_matrix["schema_version"]
            == MATRIX_SCHEMA_VERSION
        )
        print(json.dumps(payload, indent=2))
    else:
        for f in active:
            print(f.format())
        if suppressed:
            print(
                f"-- {len(suppressed)} baselined finding(s) "
                f"(visible debt; see analysis/baseline.toml):"
            )
            for f in suppressed:
                print(f"   {f.format()}")
        for e in stale:
            print(
                f"-- stale baseline entry (debt paid — delete it): "
                f"{e.rule} {e.path} {e.symbol}"
            )
        print(
            f"graftcheck: {len(errors)} error(s), {len(warnings)} "
            f"warning(s), {len(suppressed)} baselined, {len(stale)} "
            f"stale baseline entr{'y' if len(stale) == 1 else 'ies'}"
        )

    if args.strict and errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
