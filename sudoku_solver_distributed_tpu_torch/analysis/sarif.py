"""SARIF 2.1.0 emitter for graftcheck findings.

SARIF is the interchange format GitHub code scanning ingests: the CI
workflow runs ``python -m …analysis --strict --sarif graftcheck.sarif``
and uploads the file, so findings annotate the PR diff inline instead
of living only in a job log. The emitter is deliberately minimal — one
run, one driver, one result per finding — and uses only stdlib types
so it stays importable everywhere the analyzers are.

Baselined findings are still emitted, carrying a ``suppressions``
entry, so the debt stays visible in the scanning UI without failing
the gate — the same philosophy as the CLI's "visible debt" output.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .findings import Finding

SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
SARIF_VERSION = "2.1.0"

# one-line rule descriptions, surfaced in the scanning UI
_RULE_FAMILIES = {
    "LOCK": "lock discipline (ordering, blocking under locks, guarded state)",
    "TORCH": "torch hygiene on the serving path (host syncs, pinned copies, "
    "kernel builds, consumed segment pools)",
    "WIRE": "wire-schema drift between producer and consumers",
    "SEAM": "five-part dispatch contract coverage per dispatch shape",
    "THREAD": "blocking/expensive work reachable on singleton loop threads",
}


def _rule_description(rule: str) -> str:
    for prefix, desc in _RULE_FAMILIES.items():
        if rule.startswith(prefix):
            return desc
    return "graftcheck finding"


def _level(severity: str) -> str:
    return "error" if severity == "error" else "warning"


def _result(finding: Finding, suppressed: bool) -> Dict:
    result: Dict = {
        "ruleId": finding.rule,
        "level": _level(finding.severity),
        "message": {"text": f"{finding.symbol}: {finding.message}"},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(1, finding.line)},
                },
                "logicalLocations": [
                    {"fullyQualifiedName": finding.symbol}
                ],
            }
        ],
        # stable identity across line churn: rule + file + symbol is
        # how the baseline keys findings too
        "partialFingerprints": {
            "graftcheckFindingKey/v1": (
                f"{finding.rule}:{finding.path}:{finding.symbol}"
            )
        },
    }
    if suppressed:
        result["suppressions"] = [
            {
                "kind": "external",
                "justification": "baselined in analysis/baseline.toml",
            }
        ]
    return result


def to_sarif(
    findings: Sequence[Finding],
    suppressed: Sequence[Finding] = (),
) -> Dict:
    """One SARIF log for an analysis run: ``findings`` are live,
    ``suppressed`` are baselined (emitted with a suppression record)."""
    rules_seen: List[str] = []
    for f in list(findings) + list(suppressed):
        if f.rule not in rules_seen:
            rules_seen.append(f.rule)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftcheck",
                        "informationUri": (
                            "docs/OPERATIONS.md#static-analysis"
                        ),
                        "rules": [
                            {
                                "id": rule,
                                "shortDescription": {
                                    "text": _rule_description(rule)
                                },
                            }
                            for rule in sorted(rules_seen)
                        ],
                    }
                },
                "originalUriBaseIds": {
                    "SRCROOT": {"description": {"text": "repo root"}}
                },
                "results": [
                    _result(f, suppressed=False) for f in findings
                ]
                + [_result(f, suppressed=True) for f in suppressed],
            }
        ],
    }
