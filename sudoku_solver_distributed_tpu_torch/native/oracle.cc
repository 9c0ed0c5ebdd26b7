// Native host oracle: bitmask MRV backtracking solver / solution counter.
//
// C++ twin of the pure-Python oracle (models/oracle.py) with byte-identical
// deterministic behavior: cells are chosen by a row-major scan taking the
// first strictly-smaller candidate count (early exit at 1), and candidate
// values are tried lowest-set-bit first. Because the tie-breaking matches,
// `ss_solve` returns the exact same solution grid as `oracle_solve`, which
// lets the test suite assert native ≡ Python ≡ TPU-kernel agreement.
//
// The reference has no native code at all (SURVEY.md §2); this exists because
// the framework's corpus generator certifies unique-solution puzzles with a
// solution-count probe per blanked cell (models/generator.py), and that host
// loop is worth real native speed (~100× over CPython on 9×9 counting).
//
// Board sizes: N×N for N in {4, 9, 16, 25} (box edge 2..5). Candidate sets are
// uint32 bitmasks; values are 1..N, 0 = empty.

#include <cstdint>

namespace {

constexpr int kMaxN = 25;

struct Ctx {
  int size = 0;
  int box = 0;
  uint32_t full = 0;
  uint32_t rows[kMaxN];
  uint32_t cols[kMaxN];
  uint32_t boxes[kMaxN];
  int32_t grid[kMaxN][kMaxN];
  long long found = 0;
  long long limit = 0;
  long long nodes = 0;       // search nodes expanded so far
  long long max_nodes = 0;   // 0 = unbounded
  bool budget_hit = false;
  uint64_t rng = 0;          // 0 = deterministic lowest-bit-first ordering
};

inline uint64_t next_rng(uint64_t& s) {  // xorshift64*
  s ^= s >> 12;
  s ^= s << 25;
  s ^= s >> 27;
  return s * 0x2545F4914F6CDD1DULL;
}

inline int box_of(const Ctx& c, int i, int j) {
  return (i / c.box) * c.box + (j / c.box);
}

// Load a board into ctx; returns false on a direct clue conflict (duplicate
// value in a unit) or an out-of-range value — unsatisfiable as given.
bool load(Ctx& c, const int32_t* board, int size, int box) {
  c.size = size;
  c.box = box;
  c.full = (size == 32) ? 0xffffffffu : ((1u << size) - 1u);
  for (int u = 0; u < size; ++u) c.rows[u] = c.cols[u] = c.boxes[u] = 0;
  for (int i = 0; i < size; ++i) {
    for (int j = 0; j < size; ++j) {
      int32_t v = board[i * size + j];
      c.grid[i][j] = v;
      if (v == 0) continue;
      if (v < 0 || v > size) return false;
      uint32_t bit = 1u << (v - 1);
      int b = box_of(c, i, j);
      if ((c.rows[i] & bit) || (c.cols[j] & bit) || (c.boxes[b] & bit))
        return false;
      c.rows[i] |= bit;
      c.cols[j] |= bit;
      c.boxes[b] |= bit;
    }
  }
  return true;
}

// MRV backtracking step. Returns true when the search should stop (for
// solving: a solution was found; for counting: the limit was reached; for
// either: the node budget was exhausted).
bool step(Ctx& c) {
  if (c.max_nodes && ++c.nodes > c.max_nodes) {
    c.budget_hit = true;
    return true;
  }
  int bi = -1, bj = -1, bn = c.size + 1;
  uint32_t bcand = 0;
  for (int i = 0; i < c.size && bn > 1; ++i) {
    for (int j = 0; j < c.size; ++j) {
      if (c.grid[i][j]) continue;
      uint32_t cand =
          c.full & ~(c.rows[i] | c.cols[j] | c.boxes[box_of(c, i, j)]);
      int n = __builtin_popcount(cand);
      if (n == 0) return false;
      if (n < bn) {
        bi = i;
        bj = j;
        bn = n;
        bcand = cand;
        if (n == 1) break;
      }
    }
  }
  if (bi < 0) {  // complete
    ++c.found;
    return c.found >= c.limit;
  }
  int b = box_of(c, bi, bj);
  // candidate order: deterministic lowest-bit-first (the Python-oracle
  // contract), or Fisher-Yates shuffled when an rng stream is active
  // (randomized-restart solving for generation; see ss_solve_seeded)
  uint32_t order[kMaxN];
  int ncand = 0;
  uint32_t cand = bcand;
  while (cand) {
    uint32_t bit = cand & (~cand + 1u);
    cand &= ~bit;
    order[ncand++] = bit;
  }
  if (c.rng) {
    for (int i = ncand - 1; i > 0; --i) {
      int j = static_cast<int>(next_rng(c.rng) % (i + 1));
      uint32_t t = order[i];
      order[i] = order[j];
      order[j] = t;
    }
  }
  for (int k = 0; k < ncand; ++k) {
    uint32_t bit = order[k];
    c.grid[bi][bj] = __builtin_ctz(bit) + 1;
    c.rows[bi] |= bit;
    c.cols[bj] |= bit;
    c.boxes[b] |= bit;
    bool done = step(c);
    if (done && c.limit == 1) return true;  // solving: keep the filled grid
    c.grid[bi][bj] = 0;
    c.rows[bi] &= ~bit;
    c.cols[bj] &= ~bit;
    c.boxes[b] &= ~bit;
    if (done) return true;
  }
  return false;
}

int geometry_box(int size) {
  for (int b = 2; b <= 5; ++b)
    if (b * b == size) return b;
  return -1;
}

}  // namespace

extern "C" {

// Solve `board` (size*size int32, row-major). On success writes the solved
// grid to `out` and returns 1; returns 0 if unsatisfiable, -1 on bad geometry.
int ss_solve(const int32_t* board, int32_t* out, int size) {
  int box = geometry_box(size);
  if (box < 0) return -1;
  static thread_local Ctx c;
  if (!load(c, board, size, box)) return 0;
  c.found = 0;
  c.limit = 1;
  c.nodes = 0;
  c.max_nodes = 0;
  c.budget_hit = false;
  c.rng = 0;
  if (!step(c)) return 0;
  for (int i = 0; i < size; ++i)
    for (int j = 0; j < size; ++j) out[i * size + j] = c.grid[i][j];
  return 1;
}

// Count solutions of `board`, stopping at `limit`. Returns the count
// (saturated at limit), or -1 on bad geometry.
long long ss_count(const int32_t* board, int size, long long limit) {
  int box = geometry_box(size);
  if (box < 0) return -1;
  if (limit <= 0) return 0;
  static thread_local Ctx c;
  if (!load(c, board, size, box)) return 0;
  c.found = 0;
  c.limit = limit;
  c.nodes = 0;
  c.max_nodes = 0;
  c.budget_hit = false;
  c.rng = 0;
  step(c);
  return c.found;
}

// As ss_count, but give up after expanding `max_nodes` search nodes
// (0 = unbounded). Returns -2 when the budget was exhausted before the
// count was settled — callers must treat that as "unknown", not a count.
// Bounds the pathological tail of uniqueness probes on large boards (a
// near-multi-solution 16x16 can take minutes unbounded).
long long ss_count_budget(const int32_t* board, int size, long long limit,
                          long long max_nodes) {
  int box = geometry_box(size);
  if (box < 0) return -1;
  if (limit <= 0) return 0;
  static thread_local Ctx c;
  if (!load(c, board, size, box)) return 0;
  c.found = 0;
  c.limit = limit;
  c.nodes = 0;
  c.max_nodes = max_nodes;
  c.budget_hit = false;
  c.rng = 0;
  step(c);
  if (c.budget_hit && c.found < limit) return -2;
  return c.found;
}

// Randomized-restart solve: candidate values tried in a seeded-shuffled
// order, restarting with a fresh stream whenever `max_nodes` search nodes
// are exhausted (Las Vegas — deterministic MRV orderings have pathological
// tails on large near-empty boards, e.g. minutes on some 16x16 diagonal
// seeds; shuffled restarts finish in milliseconds with overwhelming
// probability). Returns 1 + fills `out` on success, 0 if proven
// unsatisfiable, -1 on bad geometry, -2 if every restart exhausted its
// budget (UNKNOWN — only possible on unsatisfiable-or-adversarial inputs;
// callers fall back or reseed).
int ss_solve_seeded(const int32_t* board, int32_t* out, int size,
                    uint64_t seed, long long max_nodes, int restarts) {
  int box = geometry_box(size);
  if (box < 0) return -1;
  static thread_local Ctx c;
  if (max_nodes <= 0) max_nodes = 200000;
  if (restarts <= 0) restarts = 32;
  for (int attempt = 0; attempt < restarts; ++attempt) {
    if (!load(c, board, size, box)) return 0;
    c.found = 0;
    c.limit = 1;
    c.nodes = 0;
    c.max_nodes = max_nodes;
    c.budget_hit = false;
    c.rng = seed + 0x9E3779B97F4A7C15ULL * (attempt + 1);
    if (c.rng == 0) c.rng = 1;
    bool done = step(c);
    if (done && !c.budget_hit) {
      for (int i = 0; i < size; ++i)
        for (int j = 0; j < size; ++j) out[i * size + j] = c.grid[i][j];
      return 1;
    }
    if (!done && !c.budget_hit) return 0;  // full search: unsatisfiable
  }
  return -2;
}

}  // extern "C"
