"""Finding records and the baseline suppression file.

A finding is keyed for suppression by (rule, path, symbol) — NOT by line:
lines shift on every edit, and a baseline that rots on unrelated edits
trains people to regenerate it blindly, which defeats its purpose. The
symbol is the enclosing ``Class.method`` (or function, or ``<module>``),
so one justified entry covers all same-rule findings in that symbol —
coarse on purpose: a symbol whose design triggers a rule usually triggers
it at several sites for the same reason.

Baseline format (``analysis/baseline.toml``)::

    [[suppress]]
    rule = "LOCK102"
    path = "sudoku_solver_distributed_tpu_torch/net/node.py"
    symbol = "P2PNode.peer_sudoku_solve_info"
    reason = "why this legacy violation is acceptable debt"

Every entry MUST carry a non-empty ``reason`` — an unjustified entry is a
load error, not a warning: the file is the audit trail. Entries that no
longer match anything are reported as stale so fixed debt gets deleted
rather than silently accumulating.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # e.g. "LOCK102"
    severity: str   # "error" | "warning"
    path: str       # repo-relative posix path
    line: int
    symbol: str     # enclosing Class.method / function / "<module>"
    message: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.severity}] "
            f"{self.symbol}: {self.message}"
        )


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    reason: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)


def _parse_toml(text: str) -> dict:
    """Parse TOML with whatever the interpreter has (tomllib on 3.11+,
    tomli where installed), falling back to a minimal parser that covers
    exactly the baseline's subset: ``[[suppress]]`` array-of-tables with
    one-line ``key = "string"`` pairs. The fallback keeps the analyzers
    dependency-free on 3.10 containers — the suppression file must never
    be the reason the gate can't run."""
    try:
        import tomllib  # Python >= 3.11

        return tomllib.loads(text)
    except ImportError:
        pass
    try:
        import tomli

        return tomli.loads(text)
    except ImportError:
        pass
    tables: List[dict] = []
    current: Optional[dict] = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[suppress]]":
            current = {}
            tables.append(current)
            continue
        if line.startswith("["):
            raise ValueError(
                f"baseline fallback parser: unsupported table at line "
                f"{lineno}: {line!r}"
            )
        if current is None or "=" not in line:
            raise ValueError(
                f"baseline fallback parser: cannot parse line {lineno}: "
                f"{line!r}"
            )
        key, _, value = line.partition("=")
        value = value.strip()
        if not (len(value) >= 2 and value[0] == value[-1] == '"'):
            raise ValueError(
                f"baseline fallback parser: value must be a quoted string "
                f"at line {lineno}: {line!r}"
            )
        current[key.strip()] = value[1:-1]
    return {"suppress": tables}


def load_baseline(path: Path) -> List[BaselineEntry]:
    """Load and validate the baseline file; a missing file is an empty
    baseline (the desired steady state)."""
    if not path.exists():
        return []
    data = _parse_toml(path.read_text())
    entries: List[BaselineEntry] = []
    seen: Dict[Tuple[str, str, str], int] = {}
    for i, tbl in enumerate(data.get("suppress", []), 1):
        missing = [
            k for k in ("rule", "path", "symbol", "reason") if not tbl.get(k)
        ]
        if missing:
            raise ValueError(
                f"baseline entry #{i} is missing required field(s) "
                f"{missing}: every suppression must name rule/path/symbol "
                f"and justify itself with a non-empty reason"
            )
        entry = BaselineEntry(
            rule=str(tbl["rule"]),
            path=str(tbl["path"]),
            symbol=str(tbl["symbol"]),
            reason=str(tbl["reason"]),
        )
        if entry.key() in seen:
            raise ValueError(
                f"baseline entry #{i} duplicates entry "
                f"#{seen[entry.key()]} ({entry.rule} {entry.path} "
                f"{entry.symbol})"
            )
        seen[entry.key()] = i
        entries.append(entry)
    return entries


def apply_baseline(
    findings: Sequence[Finding], entries: Sequence[BaselineEntry]
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split findings into (active, suppressed) and return the stale
    baseline entries — entries that matched nothing, i.e. debt that was
    paid off but whose IOU was never torn up."""
    by_key = {e.key(): e for e in entries}
    matched = set()
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if f.key() in by_key:
            matched.add(f.key())
            suppressed.append(f)
        else:
            active.append(f)
    stale = [e for e in entries if e.key() not in matched]
    return active, suppressed, stale
