"""Whether what the timed path returned is right.

During the window the loop keeps, for every call, the number of rows it
returned and of boards it flagged solved, the answers in its deep slots,
and, for the calls the seed marked, every answer. Once the window has
closed, the memory peak read and the program freed, this compares them
with the plain reference (reference/solver.py), which sees only the
boards the benchmark drew:

  rows_missing  rows a call owed and did not return, summed over calls
  unsolved      boards not flagged solved (every pool board has a unique
                solution, so each must come back solved)
  invalid       kept answers that drop a clue or break a row, column or
                box
  mismatch      kept answers that differ from the reference's solution,
                for a seeded sample of the distinct boards kept (every
                deep board kept, up to ``reference_deep``; hard boards up
                to ``reference_hard``)

Each is exact: its limit is 0. ``correct`` also needs at least one call.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from gpubench.reference.solver import solve, valid_completions

LIMITS = {"rows_missing": 0, "unsolved": 0, "invalid": 0, "mismatch": 0}


@dataclass
class Answers:
    """What the window keeps for the check."""

    width: int
    calls: int = 0
    rows_missing: int = 0
    unsolved: int = 0
    # (Call, (W, N, N) solutions) of the calls the seed marked
    full: list = field(default_factory=list)
    # (deep_idx (D,), (D, N, N) solutions) of every call
    deep: list = field(default_factory=list)

    def keep(self, call, solutions: np.ndarray, solved: np.ndarray) -> None:
        """Record one call's answers; cheap enough to run between calls."""
        self.calls += 1
        rows = len(solutions)
        self.rows_missing += abs(self.width - rows) + abs(self.width - len(solved))
        self.unsolved += self.width - int(np.count_nonzero(solved[: self.width]))
        if len(call.deep_pos) and rows == self.width:
            self.deep.append((call.deep_idx, solutions[call.deep_pos].copy()))
        if call.full_check:
            self.full.append((call, solutions))


def evaluate(answers: Answers, plan, check_cfg: dict) -> tuple:
    """``(checks, counts)``: each compared number beside its limit, and how
    many answers each part read."""
    invalid = kept = 0
    by_hard: dict = {}
    by_deep: dict = {}
    for call, sols in answers.full:
        if len(sols) != len(call.boards):
            continue  # counted under rows_missing
        ok = valid_completions(call.boards, sols)
        invalid += int(np.count_nonzero(~ok))
        kept += len(ok)
        for slot in np.flatnonzero(call.hard_idx >= 0):
            by_hard.setdefault(int(call.hard_idx[slot]), []).append(sols[slot])
    for deep_idx, sols in answers.deep:
        ok = valid_completions(plan.deep[deep_idx], sols)
        invalid += int(np.count_nonzero(~ok))
        kept += len(ok)
        for i, s in zip(deep_idx.tolist(), sols):
            by_deep.setdefault(int(i), []).append(s)

    rng = plan.check_rng()
    mismatch = compared = solved_by_ref = 0
    for pool, found, cap in (
        (plan.hard, by_hard, int(check_cfg["reference_hard"])),
        (plan.deep, by_deep, int(check_cfg["reference_deep"])),
    ):
        keys = np.array(sorted(found), dtype=np.int64)
        if len(keys) > cap:
            keys = rng.choice(keys, cap, replace=False)
        for i in keys.tolist():
            want = solve(pool[i])
            solved_by_ref += 1
            for got in found[i]:
                compared += 1
                if want is None or not np.array_equal(np.asarray(got), want):
                    mismatch += 1
    checks = {
        "rows_missing": answers.rows_missing,
        "unsolved": answers.unsolved,
        "invalid": invalid,
        "mismatch": mismatch,
    }
    counts = {
        "calls": answers.calls,
        "answers_kept": kept,
        "answers_compared": compared,
        "reference_solves": solved_by_ref,
    }
    return checks, counts


def verdict(checks: dict, calls: int) -> bool:
    return calls > 0 and all(checks[k] <= LIMITS[k] for k in LIMITS)


def report(checks: dict, out=sys.stderr) -> dict:
    """Print each compared number beside its limit (the run's last lines on
    standard error) and return them for the result line."""
    table = {k: {"value": int(checks[k]), "limit": LIMITS[k]} for k in LIMITS}
    for k, v in table.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=out)
    return table
