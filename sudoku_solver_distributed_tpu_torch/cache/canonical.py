"""Symmetry canonicalization: one key per puzzle orbit, with a receipt.

Sudoku's validity-preserving symmetry group is huge (transpose ×
band/stack permutations × row/col permutations within bands/stacks ×
digit relabeling — ~3.4e9 elements at 9×9 before relabeling), which is
why an exact-match answer cache is nearly useless at the front door: the
viral puzzle arrives as thousands of *variants*, not thousands of
copies. This module reduces a board to a deterministic minimal form over
that generator set so all variants share one cache key.

The reduction is hierarchical: transpose is brute-forced (2 arms), then
bands, stacks, rows-within-bands, cols-within-stacks are each ordered by
keys that are INVARIANT under everything not yet fixed (clue-count
profiles plus global digit-frequency multisets — relabeling a digit
cannot change how often it appears), then digits are relabeled by first
occurrence. Key ties are resolved by enumerating the tied orders and
taking the lexicographically smallest final grid, bounded by
``MAX_CANDIDATES`` so an adversarial all-ties board (e.g. near-empty)
costs a constant, not a factorial. Every count/frequency table is
precomputed once per transpose arm; the enumeration loops are pure
Python tuple comparisons (the hit path must stay microseconds-cheap —
cache/store.py serves under it).

Soundness does NOT depend on the reduction being complete: every
canonicalization also returns a :class:`Transform` — the composed
(transpose, row, col, digit) permutation — and the cache proves two
boards symmetric by *applying* the transform and comparing grids, never
by trusting hash equality (cache/store.py). A missed equivalence (a tie
the bounded enumeration resolved differently on the two variants) only
costs hit rate; it can never serve a wrong answer.

A copy of ``sudoku_solver_distributed_tpu/cache/canonical.py``: numpy and
hashlib on the host, fed the same int32 C-order bytes, so a board's key is
the same in both packages (keys go on the wire once cache gossip is
ported). Boards are host arrays or nested lists, never tensors.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# bound on the tie-break search per canonicalization: orders explored at
# one level × candidates carried overall. Generic puzzles (the committed
# corpora) resolve every level with ZERO ties — the caps exist so a
# hostile near-empty board degrades to a deterministic-but-arbitrary
# representative instead of a factorial walk.
MAX_ORDERS_PER_LEVEL = 24
MAX_CANDIDATES = 64


class Transform:
    """The invertible receipt of one canonicalization.

    ``canonical[i][j] == digits[base[rows[i], cols[j]]]`` where ``base``
    is the original board transposed iff ``transposed`` and ``digits``
    maps original values → canonical values (``digits[0] == 0``: empty
    cells are never relabeled).
    """

    __slots__ = ("size", "transposed", "rows", "cols", "digits")

    def __init__(self, size, transposed, rows, cols, digits):
        self.size = int(size)
        self.transposed = bool(transposed)
        self.rows = tuple(int(r) for r in rows)
        self.cols = tuple(int(c) for c in cols)
        self.digits = tuple(int(d) for d in digits)  # len size+1, [0]==0

    def apply(self, board) -> np.ndarray:
        """Original-frame board → its canonical-frame image. The cache's
        soundness check re-applies this and compares against the stored
        canonical grid — symmetry proven by construction, not hashing."""
        arr = np.asarray(board, np.int32)
        base = arr.T if self.transposed else arr
        out = base[np.ix_(self.rows, self.cols)]
        return np.asarray(self.digits, np.int32)[out]

    def invert(self, canonical_grid) -> np.ndarray:
        """Canonical-frame grid (e.g. a cached solution) → the
        original frame. Exact inverse of :meth:`apply`."""
        arr = np.asarray(canonical_grid, np.int32)
        inv_digits = np.zeros(self.size + 1, np.int32)
        for orig, canon in enumerate(self.digits):
            inv_digits[canon] = orig
        base = np.zeros((self.size, self.size), np.int32)
        base[np.ix_(self.rows, self.cols)] = inv_digits[arr]
        return base.T if self.transposed else base


class CanonicalForm:
    """One board's canonical reduction: the minimal grid, its hash key,
    and the transform that maps the ORIGINAL board onto it."""

    __slots__ = ("grid", "key", "transform")

    def __init__(self, grid: np.ndarray, transform: Transform):
        self.grid = grid
        self.transform = transform
        self.key = grid_key(grid)


def grid_key(grid: np.ndarray) -> str:
    """The cache key of a canonical grid: size-tagged sha256 hex. One
    definition — the store, the gossip digests, and peer fetch replies
    all hash through here so keys agree across nodes byte-for-byte."""
    h = hashlib.sha256()
    h.update(b"sudoku-canon-v1:%d:" % grid.shape[0])
    h.update(np.ascontiguousarray(grid, np.int32).tobytes())
    return h.hexdigest()


def _tie_orders(keys: Sequence[tuple]) -> List[Tuple[int, ...]]:
    """All orderings of ``range(len(keys))`` that sort ``keys``
    ascending, tied items permuted — bounded at MAX_ORDERS_PER_LEVEL
    (stable order first, so truncation keeps a deterministic
    representative)."""
    order = sorted(range(len(keys)), key=lambda i: keys[i])
    groups: List[List[int]] = []
    for i in order:
        if groups and keys[groups[-1][0]] == keys[i]:
            groups[-1].append(i)
        else:
            groups.append([i])
    if all(len(g) == 1 for g in groups):
        return [tuple(order)]
    out: List[Tuple[int, ...]] = []
    for combo in itertools.product(
        *(itertools.permutations(g) for g in groups)
    ):
        out.append(tuple(i for g in combo for i in g))
        if len(out) >= MAX_ORDERS_PER_LEVEL:
            break
    return out


class _Arm:
    """Everything the enumeration needs about one transpose arm,
    precomputed with a handful of vectorized ops: per-line/per-box clue
    counts and per-line digit-frequency multisets. All keys assembled in
    the loops below are pure-Python reads of these tables."""

    __slots__ = (
        "base", "boxcnt", "rowstack", "colband", "rowtot", "coltot",
        "rowfreq", "colfreq", "bandfreq", "stackfreq",
    )

    def __init__(self, base: np.ndarray, freq: np.ndarray, b: int):
        n = b * b
        occ = (base > 0).astype(np.int32)
        self.base = base
        # per-box clue counts (band, stack)
        self.boxcnt = (
            occ.reshape(b, b, b, b).sum(axis=(1, 3)).tolist()
        )
        # per-row per-stack counts (N, b) and per-col per-band counts
        self.rowstack = occ.reshape(n, b, b).sum(axis=2).tolist()
        self.colband = occ.reshape(b, b, n).sum(axis=1).T.tolist()
        self.rowtot = occ.sum(axis=1).tolist()
        self.coltot = occ.sum(axis=0).tolist()
        # digit-frequency multisets: sorted global counts of each line's
        # clues — invariant under every permutation generator AND digit
        # relabeling (a relabel permutes digits; a multiset of their
        # global counts is blind to which digit is which). The
        # tie-breaker that makes count-profile collisions rare.
        # Vectorized: empty cells carry a sentinel ABOVE any real count,
        # so one axis-sort per table yields every line's multiset at
        # once (sentinel tails encode the clue count consistently).
        # Comparison keys stay plain lists — Python compares them
        # lexicographically exactly like tuples.
        f = np.where(base > 0, freq[base], n * n + 1)
        self.rowfreq = np.sort(f, axis=1).tolist()
        self.colfreq = np.sort(f, axis=0).T.tolist()
        self.bandfreq = np.sort(f.reshape(b, -1), axis=1).tolist()
        self.stackfreq = np.sort(
            np.ascontiguousarray(f.T).reshape(b, -1), axis=1
        ).tolist()


def canonicalize(board) -> CanonicalForm:
    """Reduce ``board`` to its canonical form. Deterministic; a handful
    of vectorized precomputes plus a bounded pure-Python enumeration.
    Raises ValueError on a non-square or non-perfect-square board."""
    arr = np.asarray(board, np.int32)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"board must be square, got {arr.shape}")
    n = int(arr.shape[0])
    b = math.isqrt(n)
    if b * b != n:
        raise ValueError(f"board edge {n} is not a perfect square")
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) > n):
        # out-of-range cells must raise the ValueError every caller
        # catches — NOT index into the relabel table (a hostile
        # cache_answer board with a -999 cell raised IndexError out of
        # the UDP loop; small negatives aliased digits silently)
        raise ValueError(f"cell values must be in 0..{n}")

    # global digit frequencies are transpose/permutation-invariant: one
    # computation serves both arms and every candidate
    freq = np.bincount(arr.ravel(), minlength=n + 1)

    best: Optional[Tuple[bytes, np.ndarray, Transform]] = None
    candidates = 0
    rng_b = range(b)

    for transposed in (False, True):
        arm = _Arm(arr.T if transposed else arr, freq, b)

        # -- bands: key invariant under stack perms + inner perms +
        #    relabel = (sorted per-box counts, sorted per-row counts,
        #    band digit-frequency multiset) ---------------------------
        band_keys = [
            (
                tuple(sorted(arm.boxcnt[g])),
                tuple(sorted(arm.rowtot[g * b : g * b + b])),
                arm.bandfreq[g],
            )
            for g in rng_b
        ]
        for band_order in _tie_orders(band_keys):
            # -- stacks: band order now fixed, so per-box counts are an
            #    ORDERED tuple over bands (stronger than sorted) -------
            stack_keys = [
                (
                    tuple(arm.boxcnt[g][s] for g in band_order),
                    tuple(sorted(arm.coltot[s * b : s * b + b])),
                    arm.stackfreq[s],
                )
                for s in rng_b
            ]
            for stack_order in _tie_orders(stack_keys):
                # -- rows within each band: per-stack counts in the
                #    now-canonical stack order + frequency multiset ----
                per_band_orders = []
                for g in band_order:
                    keys = []
                    for i in rng_b:
                        r = g * b + i
                        rs = arm.rowstack[r]
                        keys.append(
                            (
                                tuple(rs[s] for s in stack_order),
                                arm.rowfreq[r],
                            )
                        )
                    per_band_orders.append(_tie_orders(keys))
                # -- cols within each stack (independent of the row
                #    choice: per-band counts only see band MEMBERSHIP,
                #    which in-band row perms never change) -------------
                per_stack_orders = []
                for s in stack_order:
                    keys = []
                    for j in rng_b:
                        c = s * b + j
                        cb = arm.colband[c]
                        keys.append(
                            (
                                tuple(cb[g] for g in band_order),
                                arm.colfreq[c],
                            )
                        )
                    per_stack_orders.append(_tie_orders(keys))

                for row_choice in itertools.islice(
                    itertools.product(*per_band_orders),
                    MAX_ORDERS_PER_LEVEL,
                ):
                    rows_final = [
                        g * b + i
                        for g, order in zip(band_order, row_choice)
                        for i in order
                    ]
                    for col_choice in itertools.islice(
                        itertools.product(*per_stack_orders),
                        MAX_ORDERS_PER_LEVEL,
                    ):
                        cols_final = [
                            s * b + j
                            for s, order in zip(
                                stack_order, col_choice
                            )
                            for j in order
                        ]
                        g4 = arm.base[np.ix_(rows_final, cols_final)]

                        # -- digit relabeling: first occurrence, row-
                        #    major over the now-fixed cell order -------
                        digits = [0] * (n + 1)
                        next_label = 1
                        for v in g4.ravel().tolist():
                            if v and digits[v] == 0:
                                digits[v] = next_label
                                next_label += 1
                        for v in range(1, n + 1):
                            # unused digits keep the transform a true
                            # permutation of 1..N
                            if digits[v] == 0:
                                digits[v] = next_label
                                next_label += 1
                        dig = np.asarray(digits, np.int32)
                        g5 = dig[g4]

                        key_bytes = g5.tobytes()
                        if best is None or key_bytes < best[0]:
                            best = (
                                key_bytes,
                                g5,
                                Transform(
                                    n, transposed, rows_final,
                                    cols_final, digits,
                                ),
                            )
                        candidates += 1
                        if candidates >= MAX_CANDIDATES:
                            return CanonicalForm(best[1], best[2])
    assert best is not None  # the loops always emit ≥1 candidate
    return CanonicalForm(best[1], best[2])


def random_symmetry(board, rng: np.random.Generator) -> List[List[int]]:
    """Apply a uniformly sampled element of the documented generator set
    (transpose × band perm × stack perm × in-band row perms × in-stack
    col perms × digit relabeling) — the test/bench utility that
    manufactures 'the same viral puzzle, differently dressed'."""
    arr = np.asarray(board, np.int32)
    n = arr.shape[0]
    b = math.isqrt(n)
    if rng.integers(2):
        arr = arr.T.copy()
    band_perm = rng.permutation(b)
    rows = np.concatenate(
        [np.arange(g * b, g * b + b)[rng.permutation(b)] for g in band_perm]
    )
    stack_perm = rng.permutation(b)
    cols = np.concatenate(
        [np.arange(s * b, s * b + b)[rng.permutation(b)] for s in stack_perm]
    )
    relabel = np.concatenate(
        [[0], rng.permutation(np.arange(1, n + 1))]
    ).astype(np.int32)
    return relabel[arr[np.ix_(rows, cols)]].tolist()
