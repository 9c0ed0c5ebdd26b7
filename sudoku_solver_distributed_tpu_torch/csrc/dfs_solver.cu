// dfs_solver.cu — the whole DFS sudoku solve of a batch, one warp per board.
//
// Replaces the TPU kernel sudoku_solver_distributed_tpu/ops/pallas_solver.py
// ::_make_kernel (pallas_solver.py:98, launched by solve_batch_pallas through
// pl.pallas_call), and carries what that kernel refused and the JAX xla
// solver runs in its serving configuration (ops/solver.py::_step): locked-set
// eliminations and extra propagation sweeps. Board for board it computes:
// each step runs one fused sweep analysis (unit once/twice value masks,
// candidates, optionally narrowed by locked candidates — pointing and
// claiming — and naked pairs, then naked and hidden singles, duplicate /
// dead-cell / out-of-range / solved verdicts), then takes one action —
// assign every forced single; or branch on the minimum-remaining-values cell
// (lowest cell index on ties, lowest candidate bit guessed, OVERFLOW when
// the stack is full); or backtrack (UNSAT on an empty stack, pop an
// exhausted frame without restoring the grid, or restore the frame's
// snapshot and try its next candidate bit). A board still RUNNING after the
// action then runs `waves - 1` extra sweeps, each assigning its singles
// unless it finds a contradiction or a solved board (under `light` they
// skip the eliminations). A board is RUNNING until an action ends it or it
// has taken max_iters steps; a closing analysis then flips a board completed
// on the capped step to SOLVED. Counters per board: guesses (+1 per branch),
// validations (+1 per sweep: every sweep runs while RUNNING), steps.
//
// What is not carried over is the TPU layout: the Pallas kernel puts 128
// boards on the lanes and finds unit counts as matmuls against a
// unit-incidence matrix, because the MXU is where a TPU does wide work.
// Here a warp owns one board and spreads it across its 32 lanes:
//
//   * cells: lane l holds cells l, l+32, l+64, ... of the flat board in
//     registers (3 per lane on 9x9, 8 on 16x16, 20 on 25x25), in arrays
//     indexed only by unrolled compile-time loops;
//   * units: lane l owns units l, l+32, l+64 (rows 0..N-1, columns N..2N-1,
//     boxes 2N..3N-1): 27 lanes on 9x9, 48 units on 16x16, 75 on 25x25. A
//     unit's N cells are an arithmetic walk base + (k/BOX)*sa + (k%BOX)*sb;
//   * line segments (the BOX cells a row or a column shares with a box):
//     lane l owns segments l, l+32, ... of the N*BOX row segments followed by
//     the N*BOX column segments (54 on 9x9, 128 on 16x16, 250 on 25x25).
//
// A sweep is a few passes over the warp's slice of shared memory, each a
// handful of instructions per lane between __syncwarp()s: (A) cell lanes
// write their value masks; (B) unit lanes fold their N cells into once/twice
// masks (a pairwise tree, log2(N) deep) and write the unit's value mask; the
// empty / out-of-range / duplicate verdicts are one __reduce_or_sync; (C)
// cell lanes form candidates from three unit masks and write them. With the
// eliminations on, (L) segment lanes OR their segments' candidates, then
// form each segment's "only here in its box" (pointing) and "only in this
// box on its line" (claiming) masks from the other segments of its band and
// line, then each segment's elimination from those of its neighbours; when
// naked pairs are on, unit lanes compare their unit's two-candidate cells
// and OR each cell's pair elimination into it with a shared atomic; cell
// lanes then drop their row segment's, column segment's and pair
// eliminations. All eliminations come from the candidates before any of
// them, as in the plain version. `dead` is then one vote. (D) unit lanes
// fold the candidates into the unit's hidden-single mask (once & ~twice);
// (E) cell lanes assign their singles. Every single of a sweep is taken
// from the same analysis, as in the lockstep solvers, so assigning them in
// parallel is exact. With no single, MRV is one __reduce_min_sync of the key
// (popcount << 10 | cell): lowest popcount, ties to the lowest flat cell, as
// the plain version's explicit min-index does; the winning cell's mask is
// one __reduce_or_sync.
//
// The guess stack stays in the device-memory scratch slab the wrapper
// allocates — (B, D, C) int8 snapshots plus the (B, D) cell and
// untried-mask frames — so there is no on-chip stack budget and every depth
// stage runs the kernel (25x25 at its full depth is 625 frames of 625 B).
// Push and restore are coalesced: each lane stores / loads its own cells'
// bytes, so no cross-lane ordering is needed for the snapshots. The top
// frame's cell and untried mask live in (warp-uniform) registers and are
// written back to the slab only when a deeper frame is pushed over them.
//
// A block is kWarps independent warps (one board each) with no block-wide
// barrier: a warp leaves as soon as its board finishes, and B boards take
// ceil(B / kWarps) blocks, so the one-board /solve bucket is one warp and
// the 4096-board bucket is 4096 warps, all resident.
//
// What bounds it on an H100: neither bytes (C ints in and out per board)
// nor the integer rate, but the latency of one sweep's dependent chain —
// shared-memory round trips between __syncwarp()s (four without the
// eliminations, seven with them), two or three warp votes and reductions,
// a few dozen dependent integer operations, and on a backtrack one load of
// the snapshot from L1/L2 — times the slowest board's sweep count. Boards
// overlap across warps; the sweeps of one board cannot (PERF.md has the
// per-step time). The eliminations make each sweep longer and the search
// shorter.
//
// The same step body (`search`) also runs continuous batching's segments:
// dfs_segment_kernel (K3) resumes a lane pool whose whole state — grid,
// counters, the guess-stack slab and its top frame — lives in device memory,
// injects new boards into freed lanes, steps each lane at most seg_iters
// steps and writes the state back in place; segment_digest_kernel (K3b)
// then builds the per-lane digest and the solution block the host reads at
// the boundary. They replace no Pallas kernel: the JAX package runs this as
// XLA code (engine.py's segment program: inject_lanes_src, run_segment,
// segment_digest), and its Pallas backend refuses continuous batching. A
// segment at k = 8 steps is ~25 sweeps of its slowest lane, so K3 is bound
// like the whole solve: by the latency of a lane's sweep chain, not bytes.
// Around that chain, the serving pool is 4096 lanes wide, and most of them
// are idle under light traffic: K3's warp of an idle lane leaves after a
// few words. K3 keeps the default register bounds on every size (its note
// says why a cap that fits all 4096 warps at once does not pay). K3b is
// bound by bytes: it copies the pool's whole grid into
// the solution block every segment, so its copy is spread over W / 32
// blocks with several words in flight a thread (its note has the numbers).
//
// The same step body runs the frontier race too: dfs_race_kernel (K4) steps
// each of one board's seeded subtree states in its own thread block (the
// step body is templated on the group that carries a board: a warp for K1
// and K3, a block for K4) until the earliest solve any block has posted,
// and the last block to finish folds the blocks' run records into the
// lockstep race's result, in the same launch. It replaces no Pallas kernel
// either: the JAX package races in XLA code (parallel/frontier.py:337). Its
// note below has the design.
//
// Interface: plain C, for ctypes. A launch uses the caller's stream, does
// not synchronize and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRunning = 0;
constexpr int kSolved = 1;
constexpr int kUnsat = 2;
constexpr int kOverflow = 3;
constexpr int kLanes = 32;
constexpr int kWarps = 4;     // boards per block, one per warp
constexpr int kMetaCols = 4;  // status, guesses, validations, steps
constexpr int kDigestCols = 8;  // a segment's digest row per lane (ops/solver.py)
constexpr int kDigestThreads = 256;  // threads per block of the digest kernel
constexpr int kDigestLanes = 32;     // pool lanes per block of the digest kernel
constexpr int kCopyInFlight = 4;     // block words a digest thread loads before storing
constexpr int kRaceMetaCols = 4;  // a race state's run: status, steps, validations, complete
constexpr int kRaceRowExtra = 3;  // after the solution: found, validations, undecided
// K4's threads a state, by box edge: about a cell a thread (dfs_race_kernel's
// note has the measurements behind each)
constexpr int kRaceThreads[6] = {0, 0, 32, 96, 256, 320};
// the largest box edge whose race keeps its guess stack in shared memory
constexpr int kRaceOnChipMaxBox = 4;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCellBits = 10;  // MRV key: popcount << kCellBits | cell
constexpr unsigned kNoKey = 0xffffffffu;

// verdict bits of the value pass, OR-reduced over the warp
constexpr int kEmpty = 1;  // some cell is 0
constexpr int kBad = 2;    // some value lies outside 1..N
constexpr int kDup = 4;    // some unit holds a value twice

// option bits of the launch
constexpr int kOptLocked = 1;  // locked-candidate eliminations in every sweep
constexpr int kOptPairs = 2;   // naked pairs with them
constexpr int kOptLight = 4;   // the extra sweeps without eliminations

// outcome of one sweep (warp-uniform)
constexpr int kSweepSolved = 0;    // every unit a permutation of 1..N
constexpr int kSweepContra = 1;    // duplicate, out-of-range value or dead cell
constexpr int kSweepAssigned = 2;  // its singles were assigned
constexpr int kSweepStuck = 3;     // no single: the key holds the MRV candidates

// A board spread over the T threads of its group (a warp unless said).
template <int BOX, int T = kLanes>
struct Geometry {
  static constexpr int N = BOX * BOX;
  static constexpr int C = N * N;
  static constexpr int U = 3 * N;                        // rows, columns, boxes
  static constexpr int FULL = (1 << N) - 1;
  static constexpr int CPL = (C + T - 1) / T;            // cells per thread
  static constexpr int UPL = (U + T - 1) / T;            // units per thread
  static constexpr int NB = N * BOX;                     // segments per direction
  static constexpr int S = 2 * NB;                       // row, then column segments
  static constexpr int SPL = (S + T - 1) / T;            // segments per thread
  static constexpr int WORDS = 2 * C + 2 * U + 3 * S;    // shared int32 per group
  static_assert(C <= (1 << kCellBits), "MRV key packs the cell in kCellBits");
  static_assert(N <= 32, "a unit's pair flags fit one word");
};

// Warp reductions by operation, for the block's two-level reductions.
struct OrOp {
  static constexpr unsigned kIdentity = 0;
  __device__ static unsigned warp(unsigned v) { return __reduce_or_sync(kAll, v); }
};
struct MinOp {
  static constexpr unsigned kIdentity = kNoKey;
  __device__ static unsigned warp(unsigned v) { return __reduce_min_sync(kAll, v); }
};
struct MaxOp {
  static constexpr unsigned kIdentity = 0;
  __device__ static unsigned warp(unsigned v) { return __reduce_max_sync(kAll, v); }
};
struct AddOp {
  static constexpr unsigned kIdentity = 0;
  __device__ static unsigned warp(unsigned v) { return __reduce_add_sync(kAll, v); }
};

// The threads that carry one board: its barrier and its votes. `t` is the
// thread's index in the group. K1 and K3 give a board a warp.
struct WarpGroup {
  static constexpr int kThreads = kLanes;
  static constexpr bool kBlock = false;
  int t;  // the lane
  __device__ __forceinline__ void sync() { __syncwarp(); }
  // a warp's votes order no memory: the passes sync before one
  __device__ __forceinline__ void sync_before_vote() { __syncwarp(); }
  __device__ __forceinline__ bool any(bool p) { return __any_sync(kAll, p); }
  __device__ __forceinline__ unsigned reduce_or(unsigned v) { return OrOp::warp(v); }
};

// K4 gives a state a block of T threads. Its votes are barriers
// (__syncthreads_or); a reduction is one warp reduction a warp, a word a
// warp into shared memory, a barrier and one more warp reduction over
// those words. The words alternate between two slots, so a reduction never
// overwrites words a slower thread has still to read: between reductions
// k and k + 2 lies reduction k + 1's barrier.
template <int T>
struct BlockGroup {
  static constexpr int kThreads = T;
  static constexpr bool kBlock = true;
  static constexpr int kWarpsIn = T / kLanes;
  static constexpr int kRedWords = 4 * kWarpsIn;  // two slots of (key, payload) a warp
  static_assert(T % kLanes == 0 && kWarpsIn <= kLanes, "one warp folds the warps' words");
  int t;
  unsigned* red;  // shared, kRedWords
  int slot;
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ void sync_before_vote() {}  // the vote is a barrier
  __device__ __forceinline__ bool any(bool p) { return __syncthreads_or(p) != 0; }
  __device__ __forceinline__ unsigned* next_slot() {
    unsigned* r = red + slot * 2 * kWarpsIn;
    slot ^= 1;
    return r;
  }
  template <class Op>
  __device__ __forceinline__ unsigned reduce(unsigned v) {
    v = Op::warp(v);
    unsigned* r = next_slot();
    const int lane = t % kLanes;
    if (lane == 0) r[t / kLanes] = v;
    __syncthreads();
    return Op::warp(lane < kWarpsIn ? r[lane] : Op::kIdentity);
  }
  __device__ __forceinline__ unsigned reduce_or(unsigned v) { return reduce<OrOp>(v); }
  // The least of the threads' distinct keys (kNoKey: none), and in
  // `payload_out` the payload of the thread that holds it.
  __device__ __forceinline__ unsigned min_key(unsigned key, unsigned payload,
                                              unsigned& payload_out) {
    const int lane = t % kLanes;
    const unsigned wmin = MinOp::warp(key);
    const unsigned wpay =
        __shfl_sync(kAll, payload, __ffs(__ballot_sync(kAll, key == wmin)) - 1);
    unsigned* r = next_slot();
    if (lane == 0) {
      r[t / kLanes] = wmin;
      r[kWarpsIn + t / kLanes] = wpay;
    }
    __syncthreads();
    const unsigned k = lane < kWarpsIn ? r[lane] : kNoKey;
    const unsigned p = lane < kWarpsIn ? r[kWarpsIn + lane] : 0;
    const unsigned bmin = MinOp::warp(k);
    payload_out = __shfl_sync(kAll, p, __ffs(__ballot_sync(kAll, k == bmin)) - 1);
    return bmin;
  }
};

// The group's slice of shared memory.
struct Smem {
  int32_t* cm;   // per cell: value mask (A-B), then candidates (C-D)
  int32_t* uo;   // per unit: values present
  int32_t* hid;  // per unit: candidates with one admitting cell
  int32_t* seg;  // per segment: candidates' OR, then its elimination
  int32_t* os;   // per segment: candidates found nowhere else in its box
  int32_t* ob;   // per segment: candidates found nowhere else on its line
  int32_t* pe;   // per cell: naked-pair eliminations
};

// Slot j of a thread holds cell t + T j; the last slot may run off the board.
template <int BOX, int T>
__device__ __forceinline__ bool owns(int t, int j) {
  constexpr int C = Geometry<BOX>::C;
  return (j + 1) * T <= C || t + j * T < C;
}

// A unit's cells: base + (k / BOX) * sa + (k % BOX) * sb for k in 0..N-1.
struct UnitWalk {
  int unit, base, sa, sb;
};

template <int BOX>
__device__ __forceinline__ UnitWalk unit_walk(int unit) {
  constexpr int N = Geometry<BOX>::N;
  const int kind = unit / N, idx = unit % N;
  if (kind == 0) return {unit, idx * N, BOX, 1};                          // row
  if (kind == 1) return {unit, idx, BOX * N, N};                          // column
  return {unit, (idx / BOX) * BOX * N + (idx % BOX) * BOX, N, 1};         // box
}

template <int BOX>
__device__ __forceinline__ int walk_cell(const UnitWalk& w, int k) {
  return w.base + (k / BOX) * w.sa + (k % BOX) * w.sb;
}

// Segment i = dir * NB + line * BOX + part: the BOX cells of row `line` in
// box column `part` (dir 0), or of column `line` in box row `part` (dir 1).
template <int BOX>
__device__ __forceinline__ int segment_cell(int i, int t) {
  constexpr int N = Geometry<BOX>::N;
  constexpr int NB = Geometry<BOX>::NB;
  const int line = (i % NB) / BOX, part = i % BOX;
  return i < NB ? line * N + part * BOX + t : (part * BOX + t) * N + line;
}

// Bits set in >= 1 / >= 2 of the unit's N cell masks, folded as a pairwise
// tree so the dependent chain is log2(N) combines deep.
template <int BOX>
__device__ __forceinline__ void unit_once_twice(const int32_t* cm, const UnitWalk& w,
                                                int& once, int& twice) {
  constexpr int N = Geometry<BOX>::N;
  int o[N], t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    o[k] = cm[walk_cell<BOX>(w, k)];
    t[k] = 0;
  }
#pragma unroll
  for (int s = 1; s < N; s *= 2) {
#pragma unroll
    for (int k = 0; k + s < N; k += 2 * s) {
      t[k] |= t[k + s] | (o[k] & o[k + s]);
      o[k] |= o[k + s];
    }
  }
  once = o[0];
  twice = t[0];
}

// The thread's share of a board in a group G.
template <int BOX, class G>
using GeoOf = Geometry<BOX, G::kThreads>;

// Passes A and B: value masks per cell, then per unit; writes uo[] and
// returns the group's verdict bits (0 ⇔ the board is solved).
template <int BOX, class G>
__device__ __forceinline__ int value_pass(const int (&g)[GeoOf<BOX, G>::CPL],
                                          const UnitWalk (&uw)[GeoOf<BOX, G>::UPL],
                                          int32_t* cm, int32_t* uo, G& grp) {
  using Geo = GeoOf<BOX, G>;
  constexpr int T = G::kThreads;
  int flags = 0;
#pragma unroll
  for (int j = 0; j < Geo::CPL; ++j) {
    if (!owns<BOX, T>(grp.t, j)) continue;
    const int v = g[j];
    const bool in_range = v >= 1 && v <= Geo::N;
    flags |= v == 0 ? kEmpty : (in_range ? 0 : kBad);
    cm[grp.t + j * T] = in_range ? 1 << (v - 1) : 0;
  }
  grp.sync();
#pragma unroll
  for (int s = 0; s < Geo::UPL; ++s) {
    if (uw[s].unit >= Geo::U) continue;
    int once, twice;
    unit_once_twice<BOX>(cm, uw[s], once, twice);
    uo[uw[s].unit] = once;
    if (twice) flags |= kDup;
  }
  grp.sync_before_vote();
  return (int)grp.reduce_or((unsigned)flags);
}

// Naked pairs of the thread's units, from the candidates in cm: two cells
// of a unit with the same two candidates take them from every other cell of
// the unit. Cells of several units collect theirs with atomicOr into pe
// (zeroed in pass C). Quadratic in N per unit, from shared memory.
template <int BOX, class G>
__device__ __forceinline__ void pair_pass(const UnitWalk (&uw)[GeoOf<BOX, G>::UPL],
                                          const Smem& sh) {
  using Geo = GeoOf<BOX, G>;
#pragma unroll
  for (int s = 0; s < Geo::UPL; ++s) {
    const UnitWalk& w = uw[s];
    if (w.unit >= Geo::U) continue;
    unsigned twins = 0;
    int pairs = 0;
#pragma unroll 1
    for (int k = 0; k < Geo::N; ++k) {
      const int ck = sh.cm[walk_cell<BOX>(w, k)];
      if (__popc(ck) != 2) continue;
#pragma unroll 1
      for (int k2 = 0; k2 < Geo::N; ++k2) {
        if (k2 != k && sh.cm[walk_cell<BOX>(w, k2)] == ck) {
          twins |= 1u << k;
          pairs |= ck;
          break;
        }
      }
    }
    if (pairs == 0) continue;
#pragma unroll 1
    for (int k = 0; k < Geo::N; ++k) {
      const int cell = walk_cell<BOX>(w, k);
      const int ck = sh.cm[cell];
      const int e = pairs & ~(((twins >> k) & 1u) ? ck : 0);
      if (e & ck) atomicOr(&sh.pe[cell], e);
    }
  }
}

// Pass L: the elimination of every line segment from locked candidates, into
// seg[] (and the naked pairs into pe[] when asked). Starts after a sync that
// published the candidates in cm; ends with one.
template <int BOX, class G>
__device__ __forceinline__ void locked_pass(const UnitWalk (&uw)[GeoOf<BOX, G>::UPL],
                                            const Smem& sh, G& grp, bool pairs) {
  using Geo = GeoOf<BOX, G>;
  constexpr int T = G::kThreads;
  constexpr int NB = Geo::NB;
  if (pairs) pair_pass<BOX, G>(uw, sh);
#pragma unroll
  for (int k = 0; k < Geo::SPL; ++k) {
    const int i = grp.t + k * T;
    if (i >= Geo::S) continue;
    int m = 0;
#pragma unroll
    for (int t = 0; t < BOX; ++t) m |= sh.cm[segment_cell<BOX>(i, t)];
    sh.seg[i] = m;
  }
  grp.sync();
  // leave-one-out ORs: over the band's other lines in the same box
  // (pointing), and over the line's other boxes (claiming)
#pragma unroll
  for (int k = 0; k < Geo::SPL; ++k) {
    const int i = grp.t + k * T;
    if (i >= Geo::S) continue;
    const int* dir = sh.seg + (i < NB ? 0 : NB);
    const int line = (i % NB) / BOX, part = i % BOX, band0 = line - line % BOX;
    int seg_other = 0, box_other = 0;
#pragma unroll
    for (int t = 0; t < BOX; ++t) {
      if (band0 + t != line) seg_other |= dir[(band0 + t) * BOX + part];
      if (t != part) box_other |= dir[line * BOX + t];
    }
    const int m = sh.seg[i];
    sh.os[i] = m & ~seg_other;
    sh.ob[i] = m & ~box_other;
  }
  grp.sync();
  // a value confined to this line in another box of the line leaves this
  // segment; so does one confined to this box on another line of the band
#pragma unroll
  for (int k = 0; k < Geo::SPL; ++k) {
    const int i = grp.t + k * T;
    if (i >= Geo::S) continue;
    const int off = i < NB ? 0 : NB;
    const int line = (i % NB) / BOX, part = i % BOX, band0 = line - line % BOX;
    int e = 0;
#pragma unroll
    for (int t = 0; t < BOX; ++t) {
      if (t != part) e |= sh.os[off + line * BOX + t];
      if (band0 + t != line) e |= sh.ob[off + (band0 + t) * BOX + part];
    }
    sh.seg[i] = e;
  }
  grp.sync();
}

// One sweep analysis of the board in g: its outcome, with cand[] holding the
// candidates. Assigns the sweep's singles into g (kSweepAssigned) unless the
// board is solved or contradictory; with none, leaves the thread's MRV key.
template <int BOX, class G>
__device__ __forceinline__ int sweep(int (&g)[GeoOf<BOX, G>::CPL],
                                     int (&cand)[GeoOf<BOX, G>::CPL],
                                     const int (&pk)[GeoOf<BOX, G>::CPL],
                                     const UnitWalk (&uw)[GeoOf<BOX, G>::UPL],
                                     const Smem& sh, G& grp, bool locked, bool pairs,
                                     unsigned& key) {
  using Geo = GeoOf<BOX, G>;
  constexpr int T = G::kThreads;
  constexpr int N = Geo::N;
  const int t = grp.t;
  const int flags = value_pass<BOX>(g, uw, sh.cm, sh.uo, grp);
  if (flags == 0) return kSweepSolved;
  if (flags & (kDup | kBad)) return kSweepContra;

  // Pass C: candidates of the empty cells.
#pragma unroll
  for (int j = 0; j < Geo::CPL; ++j) {
    int c = 0;
    if (owns<BOX, T>(t, j)) {
      if (g[j] == 0) {
        const int p = pk[j];
        c = ~(sh.uo[p & 0xff] | sh.uo[(p >> 8) & 0xff] | sh.uo[p >> 16]) & Geo::FULL;
      }
      sh.cm[t + j * T] = c;
      if (pairs) sh.pe[t + j * T] = 0;
    }
    cand[j] = c;
  }

  if (locked) {
    grp.sync();
    locked_pass<BOX>(uw, sh, grp, pairs);
#pragma unroll
    for (int j = 0; j < Geo::CPL; ++j) {
      if (cand[j] == 0) continue;
      const int cell = t + j * T;
      const int r = pk[j] & 0xff, c = ((pk[j] >> 8) & 0xff) - N;
      int e = sh.seg[r * BOX + c / BOX] | sh.seg[Geo::NB + c * BOX + r / BOX];
      if (pairs) e |= sh.pe[cell];
      cand[j] &= ~e;
      sh.cm[cell] = cand[j];
    }
  }

  bool dead = false;
#pragma unroll
  for (int j = 0; j < Geo::CPL; ++j) {
    dead |= owns<BOX, T>(t, j) && g[j] == 0 && cand[j] == 0;
  }
  if (grp.any(dead)) return kSweepContra;

  // Pass D: per-unit hidden-single masks from the candidates.
  grp.sync_before_vote();
#pragma unroll
  for (int s = 0; s < Geo::UPL; ++s) {
    if (uw[s].unit >= Geo::U) continue;
    int once, twice;
    unit_once_twice<BOX>(sh.cm, uw[s], once, twice);
    sh.hid[uw[s].unit] = once & ~twice;
  }
  grp.sync();

  // Pass E: assign every forced single; otherwise key the MRV candidates.
  bool assigned = false;
  key = kNoKey;
#pragma unroll
  for (int j = 0; j < Geo::CPL; ++j) {
    const int c = cand[j];
    if (c == 0) continue;
    const int p = pk[j];
    const int exact1 = sh.hid[p & 0xff] | sh.hid[(p >> 8) & 0xff] | sh.hid[p >> 16];
    const int pc = __popc(c);
    int a = pc == 1 ? c : (c & exact1);
    a &= -a;
    if (a != 0) {
      g[j] = __ffs(a);
      assigned = true;
    } else {
      key = min(key, (unsigned)(pc << kCellBits | (t + j * T)));
    }
  }
  return grp.any(assigned) ? kSweepAssigned : kSweepStuck;
}

// The group's slice of shared memory, carved from its array.
template <int BOX>
__device__ __forceinline__ Smem group_smem(int32_t* base) {
  using Geo = Geometry<BOX>;
  Smem sh;
  sh.cm = base;
  sh.uo = sh.cm + Geo::C;
  sh.hid = sh.uo + Geo::U;
  sh.seg = sh.hid + Geo::U;
  sh.os = sh.seg + Geo::S;
  sh.ob = sh.os + Geo::S;
  sh.pe = sh.ob + Geo::S;
  return sh;
}

// Per cell slot, its row / column / box unit ids packed a byte each; per
// unit slot, the unit's walk.
template <int BOX, class G>
__device__ __forceinline__ void lane_layout(int t, int (&pk)[GeoOf<BOX, G>::CPL],
                                            UnitWalk (&uw)[GeoOf<BOX, G>::UPL]) {
  using Geo = GeoOf<BOX, G>;
  constexpr int T = G::kThreads;
  constexpr int N = Geo::N;
#pragma unroll
  for (int j = 0; j < Geo::CPL; ++j) {
    const int cell = t + j * T;
    const int r = cell / N, c = cell % N;
    pk[j] = r | (N + c) << 8 | (2 * N + (r / BOX) * BOX + c / BOX) << 16;
  }
#pragma unroll
  for (int s = 0; s < Geo::UPL; ++s) uw[s] = unit_walk<BOX>(t + s * T);
}

// A board's search state between steps; every field is uniform over its
// group.
struct Search {
  int status, depth, guesses, validations, steps;
  int top_cell, top_mask;  // frame depth-1, kept out of the stack
};

// The step-boundary check of `search`: NoPoll never stops a board (K1 and
// K3, whose code it leaves as it was); the race kernel's RacePoll stops it
// once it has run more steps than the earliest solve any block has posted.
struct NoPoll {
  __device__ __forceinline__ bool operator()(int) const { return false; }
};

// The race's stop step, read by thread 0 through a volatile pointer (so the
// compiler cannot hoist the load out of the step loop, nor serve it from a
// register or L1) and broadcast by the boundary's __syncthreads_or. The
// value a boundary decides on was loaded at the boundary before, so the
// load's L2 latency never stalls the chain; a state may run one step more
// than a fresh read would let it, which the fold allows for (every posted
// step is at least t*).
struct RacePoll {
  const volatile unsigned* stop;
  int t;
  unsigned seen;  // thread 0: the posted step as of the previous boundary
  __device__ __forceinline__ bool operator()(int steps) {
    const bool halt = __syncthreads_or(t == 0 && (unsigned)steps > seen) != 0;
    if (t == 0) seen = *stop;
    return halt;
  }
};

// Run a RUNNING board's steps until its status changes, it has taken
// `max_steps` steps in all or `poll` stops it at a step boundary: the step
// body shared by the kernels, for a board carried by the group `grp`. The
// stack (sg, sc, sm: device memory or, for K4, shared memory) holds frames
// 0..depth-2; frame depth-1 is in s.top_cell / s.top_mask. Each thread
// pushes and restores only its own cells' snapshot bytes.
template <int BOX, class G, class Poll = NoPoll>
__device__ __forceinline__ void search(int (&g)[GeoOf<BOX, G>::CPL],
                                       const int (&pk)[GeoOf<BOX, G>::CPL],
                                       const UnitWalk (&uw)[GeoOf<BOX, G>::UPL],
                                       const Smem& sh, G& grp, int8_t* sg, int32_t* sc,
                                       int32_t* sm, int D, int max_steps, int waves,
                                       int options, Search& s, Poll poll = Poll{}) {
  using Geo = GeoOf<BOX, G>;
  constexpr int T = G::kThreads;
  constexpr int C = Geo::C;
  constexpr int CPL = Geo::CPL;
  const int t = grp.t;
  const bool locked = options & kOptLocked;
  const bool pairs = locked && (options & kOptPairs);
  const bool wave_locked = locked && !(options & kOptLight);
  const bool wave_pairs = wave_locked && pairs;
  int cand[CPL];

  // One sweep per iteration: sweep 0 of a step takes the step's action,
  // sweeps 1..waves-1 only assign their singles.
  for (int wave = 0;; wave = wave + 1 == waves ? 0 : wave + 1) {
    if (wave == 0) {
      if (s.steps >= max_steps || poll(s.steps)) break;
      ++s.steps;
    }
    ++s.validations;
    unsigned key;
    const int v = sweep<BOX>(g, cand, pk, uw, sh, grp, wave ? wave_locked : locked,
                             wave ? wave_pairs : pairs, key);
    if (wave) continue;
    if (v == kSweepSolved) {
      s.status = kSolved;
      break;
    }
    if (v == kSweepContra) {
      // backtrack
      if (s.depth == 0) {
        s.status = kUnsat;
        break;
      }
      if (s.top_mask == 0) {
        // exhausted frame: pop; the grid stays contradictory
        if (--s.depth) {
          s.top_cell = sc[s.depth - 1];
          s.top_mask = sm[s.depth - 1];
        }
        continue;
      }
      const int bit = s.top_mask & -s.top_mask;
      const int8_t* f = sg + (size_t)(s.depth - 1) * C;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int cell = t + j * T;
        if (owns<BOX, T>(t, j)) g[j] = cell == s.top_cell ? __ffs(bit) : f[cell];
      }
      s.top_mask &= ~bit;
      continue;
    }
    if (v == kSweepAssigned) continue;

    // branch on the MRV cell
    if (s.depth >= D) {
      s.status = kOverflow;
      break;
    }
    int cell, mask;
    if constexpr (G::kBlock) {
      // the key's owner hands its cell's mask on through the reduction
      const int mine_cell = (int)(key & ((1u << kCellBits) - 1));
      int mine = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (t + j * T == mine_cell) mine = cand[j];
      }
      unsigned m;
      cell = (int)(grp.min_key(key, (unsigned)mine, m) & ((1u << kCellBits) - 1));
      mask = (int)m;
    } else {
      cell = (int)(__reduce_min_sync(kAll, key) & ((1u << kCellBits) - 1));
      int mine = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (t + j * T == cell) mine = cand[j];
      }
      mask = (int)__reduce_or_sync(kAll, (unsigned)mine);
    }
    const int bit = mask & -mask;
    int8_t* f = sg + (size_t)s.depth * C;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = t + j * T;
      if (!owns<BOX, T>(t, j)) continue;
      f[c] = (int8_t)g[j];
      if (c == cell) g[j] = __ffs(bit);
    }
    if (s.depth > 0 && t == 0) {
      sc[s.depth - 1] = s.top_cell;
      sm[s.depth - 1] = s.top_mask;
    }
    s.top_cell = cell;
    s.top_mask = mask & ~bit;
    ++s.depth;
    ++s.guesses;
  }
}

template <int BOX>
__global__ void __launch_bounds__(kWarps * kLanes)
dfs_solver_kernel(const int32_t* __restrict__ boards, int32_t* __restrict__ grid_out,
                  int32_t* __restrict__ meta, int8_t* __restrict__ stack_grid,
                  int32_t* __restrict__ stack_cell, int32_t* __restrict__ stack_mask,
                  int B, int D, int max_iters, int waves, int options) {
  using Geo = Geometry<BOX>;
  constexpr int C = Geo::C;
  constexpr int CPL = Geo::CPL;
  __shared__ int32_t smem[kWarps][Geo::WORDS];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int board = blockIdx.x * kWarps + warp;
  if (board >= B) return;  // the whole warp leaves; no block-wide barrier follows
  const Smem sh = group_smem<BOX>(smem[warp]);
  WarpGroup grp{lane};
  int g[CPL], pk[CPL];
  UnitWalk uw[Geo::UPL];
  lane_layout<BOX, WarpGroup>(lane, pk, uw);
  const int32_t* in = boards + (size_t)board * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    g[j] = owns<BOX, kLanes>(lane, j) ? in[lane + j * kLanes] : 0;

  Search s{kRunning, 0, 0, 0, 0, 0, 0};
  search<BOX>(g, pk, uw, sh, grp, stack_grid + (size_t)board * D * C,
              stack_cell + (size_t)board * D, stack_mask + (size_t)board * D, D, max_iters,
              waves, options, s);

  // the step cap stopped a board that its last step may have completed
  if (s.status == kRunning && value_pass<BOX>(g, uw, sh.cm, sh.uo, grp) == 0)
    s.status = kSolved;

  int32_t* out = grid_out + (size_t)board * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (owns<BOX, kLanes>(lane, j)) out[lane + j * kLanes] = g[j];
  }
  if (lane == 0) {
    int32_t* m = meta + (size_t)board * kMetaCols;
    m[0] = s.status;
    m[1] = s.guesses;
    m[2] = s.validations;
    m[3] = s.steps;
  }
}

// The segment kernel (K3): one bounded segment of continuous batching over a
// lane pool whose whole state lives in device memory and is updated in
// place. Per lane (one warp, as in dfs_solver_kernel):
//   * injection: src >= 0 restarts the lane from boards[src], -2 from the
//     instantly-UNSAT pad board (two 1s in row 0), with depth, guesses,
//     validations and board_iters 0 and status RUNNING; -1 resumes it. The
//     slab rows of an injected lane are not cleared: rows at or above its
//     depth are never read;
//   * resume: the grid, the counters and the top frame (from the slab) are
//     loaded, the lane steps while RUNNING for at most seg_iters steps, and
//     everything is written back, the top frame into the slab included, so
//     the next segment resumes exactly where this one stopped;
//   * no closing analysis: a lane completed on its last step stays RUNNING
//     and pays its discovery sweep in the next segment, as the closed loop
//     does, so validations do not depend on where segments are cut;
//   * out: digest columns 0-4, the lane's step count and its "solved in this
//     segment" bit for the digest kernel (lane_steps), and, when the
//     solution block is not prefix-gathered, the lane's block row (its grid
//     if it solved in this segment, else zeros).
//
// What bounds it on an H100: a segment over live lanes is the latency of its
// slowest lane's sweep chain, as in dfs_solver_kernel; and the serving pool
// is 4096 lanes, one warp each. Two things the design does about that:
//   * an idle lane (kept with src == -1, and not RUNNING) cannot change, so
//     its warp leaves at once: it reads the lane's four scalars and writes
//     digest columns 0-4, its step word and, with the block masked, its zero
//     row; no grid load or store, no top frame, no shared-memory layout. A
//     lone /solve in the 4096-lane pool is 4095 such warps;
//   * no register cap: uncapped, 9x9 takes ~81 registers and an SM holds
//     fewer than 32 of these warps, so a fully live 4096 pool runs in more
//     than one wave. Capped at 64 registers (8 blocks of 4 warps an SM)
//     all 4096 fit, and a full pool ran ~8% faster, but every lane's sweep
//     chain ran ~10% slower, so every case the serving path produces (a
//     few live lanes in the pool, pools of 8 to 512) ran 4-10% slower
//     (PERF.md has the A/B). The cap would pay only at a full pool.
template <int BOX>
__global__ void __launch_bounds__(kWarps * kLanes)
dfs_segment_kernel(const int32_t* __restrict__ boards, int n_boards,
                   const int32_t* __restrict__ src, int32_t* __restrict__ grid,
                   int8_t* __restrict__ stack_grid, int32_t* __restrict__ stack_cell,
                   int32_t* __restrict__ stack_mask, int32_t* __restrict__ depth,
                   int32_t* __restrict__ status, int32_t* __restrict__ guesses,
                   int32_t* __restrict__ validations, int32_t* __restrict__ board_iters,
                   int32_t* __restrict__ digest, int32_t* __restrict__ gathered,
                   int32_t* __restrict__ lane_steps, int W, int D, int seg_iters,
                   int waves, int options, int prefix_gather) {
  using Geo = Geometry<BOX>;
  constexpr int C = Geo::C;
  constexpr int CPL = Geo::CPL;
  __shared__ int32_t smem[kWarps][Geo::WORDS];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= W) return;  // the whole warp leaves; no block-wide barrier follows
  const int from = src[b];
  if (from == -1 && status[b] != kRunning) {
    // An idle lane (kept, and finished in an earlier segment): its state
    // cannot change, so nothing of it is loaded or stored but the digest
    // columns, its step word and, with the block masked, its zero row.
    if (!prefix_gather) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (owns<BOX, kLanes>(lane, j)) gathered[(size_t)b * C + lane + j * kLanes] = 0;
      }
    }
    if (lane == 0) {
      const int st = status[b];
      int32_t* d = digest + (size_t)b * kDigestCols;
      d[0] = st;
      d[1] = st == kSolved;
      d[2] = guesses[b];
      d[3] = validations[b];
      d[4] = board_iters[b];
      lane_steps[b] = 0;
    }
    return;  // the whole warp leaves
  }
  const Smem sh = group_smem<BOX>(smem[warp]);
  WarpGroup grp{lane};
  int g[CPL], pk[CPL];
  UnitWalk uw[Geo::UPL];
  lane_layout<BOX, WarpGroup>(lane, pk, uw);

  int32_t* row = grid + (size_t)b * C;
  int8_t* sg = stack_grid + (size_t)b * D * C;
  int32_t* sc = stack_cell + (size_t)b * D;
  int32_t* sm = stack_mask + (size_t)b * D;
  Search s;
  if (from == -1) {
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      g[j] = owns<BOX, kLanes>(lane, j) ? row[lane + j * kLanes] : 0;
    s = Search{status[b], depth[b], guesses[b], validations[b], 0, 0, 0};
    if (s.depth > 0) {
      s.top_cell = sc[s.depth - 1];
      s.top_mask = sm[s.depth - 1];
    }
  } else {
    const int32_t* in =
        boards + (size_t)min(max(from, 0), n_boards - 1) * C;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int cell = lane + j * kLanes;
      g[j] = !owns<BOX, kLanes>(lane, j) ? 0 : from == -2 ? (cell < 2 ? 1 : 0) : in[cell];
    }
    s = Search{kRunning, 0, 0, 0, 0, 0, 0};
  }
  const int iters0 = from == -1 ? board_iters[b] : 0;
  // past the idle exit every lane is RUNNING at entry
  search<BOX>(g, pk, uw, sh, grp, sg, sc, sm, D, seg_iters, waves, options, s);
  const bool newly = s.status == kSolved;

#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int cell = lane + j * kLanes;
    if (!owns<BOX, kLanes>(lane, j)) continue;
    row[cell] = g[j];
    if (!prefix_gather) gathered[(size_t)b * C + cell] = newly ? g[j] : 0;
  }
  if (lane == 0) {
    if (s.depth > 0) {
      sc[s.depth - 1] = s.top_cell;
      sm[s.depth - 1] = s.top_mask;
    }
    depth[b] = s.depth;
    status[b] = s.status;
    guesses[b] = s.guesses;
    validations[b] = s.validations;
    board_iters[b] = iters0 + s.steps;
    int32_t* d = digest + (size_t)b * kDigestCols;
    d[0] = s.status;
    d[1] = s.status == kSolved;
    d[2] = s.guesses;
    d[3] = s.validations;
    d[4] = iters0 + s.steps;
    lane_steps[b] = s.steps << 1 | (newly ? 1 : 0);
  }
}

// The digest kernel (K3b), after the segment kernel on the same stream.
// The pool's lockstep work counters come from the lanes' own step counts
// r_i: the segment ran I = max r_i lockstep steps, so lane_steps = I * W and
// idle_lane_steps = I * W - sum r_i. With prefix_gather the solution block
// is the pool's grid with the lanes solved in this segment first, in lane
// order, then the others in lane order (a stable partition), and fetch_slot
// is a solved lane's row in it; without, fetch_slot is the lane index (the
// segment kernel wrote the block).
//
// What bounds it: the block copy, W * C words read and written (1.33 MB
// each way at W = 4096 on 9x9), whether or not any lane solved. So the
// copy is spread over the card: block k handles the kDigestLanes lanes
// [k * kDigestLanes, (k + 1) * kDigestLanes), W / kDigestLanes blocks (128
// at 4096), and each thread keeps kCopyInFlight words of the block's
// contiguous rows in flight before it stores them. Every block first reads
// all W step words itself (16 KB at 4096, from L2, a few words a thread)
// for the totals and the count of solved lanes ahead of its range, so the
// blocks need no cross-block scan or atomics; one ballot then places its
// lanes.
template <int BOX>
__global__ void __launch_bounds__(kDigestThreads)
segment_digest_kernel(const int32_t* __restrict__ lane_steps,
                      const int32_t* __restrict__ grid, int32_t* __restrict__ digest,
                      int32_t* __restrict__ gathered, int W, int prefix_gather) {
  constexpr int C = Geometry<BOX>::C;
  constexpr int kWarpsHere = kDigestThreads / kLanes;
  static_assert(kDigestLanes == kLanes, "one ballot places the block's lanes");
  __shared__ int red[4][kWarpsHere];
  __shared__ int dest[kDigestLanes];
  const int t = threadIdx.x, lane = t % kLanes, warp = t / kLanes;
  const int first = blockIdx.x * kDigestLanes;
  int r_max = 0, r_sum = 0, solved = 0, solved_before = 0;
#pragma unroll 4
  for (int i = t; i < W; i += kDigestThreads) {
    const int v = lane_steps[i];
    r_max = max(r_max, v >> 1);
    r_sum += v >> 1;
    solved += v & 1;
    if (i < first) solved_before += v & 1;
  }
  r_max = __reduce_max_sync(kAll, r_max);
  r_sum = __reduce_add_sync(kAll, r_sum);
  solved = __reduce_add_sync(kAll, solved);
  solved_before = __reduce_add_sync(kAll, solved_before);
  if (lane == 0) {
    red[0][warp] = r_max;
    red[1][warp] = r_sum;
    red[2][warp] = solved;
    red[3][warp] = solved_before;
  }
  __syncthreads();
  r_max = r_sum = solved = solved_before = 0;
#pragma unroll
  for (int w = 0; w < kWarpsHere; ++w) {
    r_max = max(r_max, red[0][w]);
    r_sum += red[1][w];
    solved += red[2][w];
    solved_before += red[3][w];
  }

  // warp 0 places the block's lanes: a solved lane after the solved lanes
  // before it, any other after every solved lane and the unsolved ones
  // before it
  if (warp == 0) {
    const int i = first + lane;
    const int mine = i < W ? lane_steps[i] & 1 : 0;
    const unsigned bits = __ballot_sync(kAll, mine);
    const int ahead = solved_before + __popc(bits & ((1u << lane) - 1u));
    if (i < W) {
      const int lockstep = r_max * W;
      int32_t* d = digest + (size_t)i * kDigestCols;
      d[5] = mine ? (prefix_gather ? ahead : i) : -1;
      d[6] = lockstep;
      d[7] = lockstep - r_sum;
      dest[lane] = mine ? ahead : solved + (i - ahead);
    }
  }
  if (!prefix_gather) return;  // uniform over the block
  __syncthreads();
  const int n = min(kDigestLanes, W - first) * C;
  const int32_t* rows = grid + (size_t)first * C;
  for (int k0 = t; k0 < n; k0 += kCopyInFlight * kDigestThreads) {
    int v[kCopyInFlight];
#pragma unroll
    for (int u = 0; u < kCopyInFlight; ++u) {
      const int k = k0 + u * kDigestThreads;
      if (k < n) v[u] = rows[k];
    }
#pragma unroll
    for (int u = 0; u < kCopyInFlight; ++u) {
      const int k = k0 + u * kDigestThreads;
      if (k < n) {
        const int l = k / C;
        gathered[(size_t)dest[l] * C + (k - l * C)] = v[u];
      }
    }
  }
}

// The race kernel (K4): one board's frontier race on one device, in one
// launch. The JAX package races the (M, C) seeded subtree states of one
// hard board in lockstep (parallel/frontier.py:337, a while_loop of
// ops/solver.step with a psum early exit: every state takes step t
// together, and the loop stops after the first step t* at which any state
// is SOLVED, or when none is RUNNING, or at max_iters; then
// finalize_status). It is XLA code, not a Pallas kernel. Here each state is
// one thread block running the step body `search` on its own trajectory
// (the trajectories are independent), out of step with the others:
//   * T = kRaceThreads[BOX] threads a state, about a cell a thread (4x4 32,
//     9x9 96, 16x16 256, 25x25 320: two cells a thread), with the units and
//     line segments spread over the same threads (BlockGroup): a pass is a
//     cell or two, one unit or one segment a thread between block barriers,
//     where a warp a state walked 3 (9x9), 8 (16x16) or 20 (25x25) cells a
//     lane serially; the votes are __syncthreads_or, the MRV key a
//     two-level reduction that also carries the winning cell's mask from
//     its owner;
//   * the guess stack (snapshots, cell and mask frames) lives in dynamic
//     shared memory where it fits: D x (C + 8) bytes, 0.4 KB for 4x4, 7.2 KB
//     for 9x9 and 67.6 KB for 16x16 at their full depth (opted in above
//     48 KB; 3 states an SM against 4 with the slab). 25x25 (390 KB, more
//     than an SM holds) keeps the device slab the wrapper allocates;
//   * a block whose state solves at step e posts e with atomicMin into the
//     device-global stop word; at every step boundary `search` polls it
//     (RacePoll) and the block stops once it has run more steps than the
//     posted value. Every posted e is at least t*, so a block still RUNNING
//     at t* always runs step t* + 1 (or reaches max_iters), which is what
//     the fold needs;
//   * each block writes its run record (status, steps, validations, and
//     whether a state stopped RUNNING is complete: the closing analysis)
//     and its grid, fences, and takes a ticket from a device counter. The
//     block that takes the last ticket rebuilds the lockstep result exactly
//     from the records (ops/solver.py fold_race has the argument; its
//     loads bypass L1), writes the packed row [solution (C), found,
//     validations, undecided] and each state's [status, validations] after
//     the race, so the host fetches one row of C + 3 words, and resets the
//     stop word and the counter to their idle values (0xffffffff, 0) for
//     the next race on the stream. That two-word scratch belongs to the
//     wrapper, one per (device, stream): a race is one launch, with no
//     memset and no second kernel.
// What bounds it on an H100: like K1, the latency of the sweep chain of the
// slowest state up to t* + 1 steps; its bytes (M * C words in and out, a
// 25x25 stack slab touched only on branches) are far below that. A race
// has few states (128 at the 9x9 default rung, 8 at 25x25), so a warp a
// state left most of the card idle and each sweep serial within its
// warp; a block a state spends that idle width on a shorter chain. The
// early exit is the design's other answer: the race costs the steps to the
// first solve, not those of the slowest subtree.
// How T and the stack's place were chosen (tools/dfs_solver_ab.py --arms
// race, one-constant variants of this file in turns, H100 80GB HBM3 at
// 700 W; PERF.md has every number): a warp a state (T = 32 here too) is
// slower at 9x9, 16x16 and 25x25 on the node's own race sizes (128 9x9
// states 0.036 against 0.026 ms, 16x16 0.091 against 0.039, 25x25 1.42
// against 0.26) but faster on a 2048-state 9x9 race (0.172 against 0.214
// ms: a 96-thread block of 59 registers fits 10 states an SM, so 2048
// states take two waves); 9x9 keeps 96 for the 128-state race that a
// --frontier 64 node runs. T = 64 on 9x9 spilled. 25x25 at 640 threads
// spilled (48 registers) and took 0.31 ms, at 320 threads 113 registers
// and 0.26 ms. The 16x16 stack on chip was 2-3 % faster than the slab at
// 128 and at 1024 states.
// Left out: folding the pad states into the launch (a pad is a block that
// dies in its first sweep, adding no serial time); wgmma and TMA (no
// matrix work; a 25x25 frame push is 625 bytes); thread-block clusters (a
// 25x25 stack would need two SMs a state).
template <int BOX>
constexpr bool kRaceOnChip = BOX <= kRaceOnChipMaxBox;

// Dynamic shared memory of a race block at stack depth D: the cell and
// mask frames (D int32 each), then the D snapshots of C bytes; none when
// the stack lives in the device slab.
template <int BOX>
size_t race_stack_bytes(int D) {
  return kRaceOnChip<BOX> ? (size_t)D * (Geometry<BOX>::C + 2 * sizeof(int32_t))
                                   : 0;
}

// The fold of the race, by the last block: t* is the earliest step any
// state solved at, else the last step any state ran. A state that ended at
// or before t* keeps its status and validations; any other ran RUNNING
// through t* (t* * waves validations) and is SOLVED after the race exactly
// when its grid was complete after step t*: it solved at t* + 1, or it
// stopped at t* (max_iters) and its closing analysis found it complete. The
// winner is the lowest SOLVED index. Validations sum in unsigned (int32
// wraparound, as the JAX psum of int32).
template <int BOX, class G>
__device__ __forceinline__ void race_fold(G& grp, const int32_t* meta, const int32_t* grid,
                                          int32_t* fold, int32_t* row, int M, int waves) {
  constexpr int C = Geometry<BOX>::C;
  constexpr int T = G::kThreads;
  const int t = grp.t;
  unsigned first_solve = kNoKey, last_step = 0;
  for (int i = t; i < M; i += T) {
    const int32_t* m = meta + (size_t)i * kRaceMetaCols;
    const int steps = __ldcg(m + 1);
    if (__ldcg(m) == kSolved) first_solve = min(first_solve, (unsigned)steps);
    last_step = max(last_step, (unsigned)steps);
  }
  first_solve = grp.template reduce<MinOp>(first_solve);
  last_step = grp.template reduce<MaxOp>(last_step);
  const int t_star = (int)(first_solve != kNoKey ? first_solve : last_step);

  unsigned winner = kNoKey, total = 0, undecided = 0;
  for (int i = t; i < M; i += T) {
    const int32_t* m = meta + (size_t)i * kRaceMetaCols;
    const int status = __ldcg(m), steps = __ldcg(m + 1);
    const bool ended = status != kRunning && steps <= t_star;
    const bool flip =
        !ended && ((status == kSolved && steps == t_star + 1) ||
                   (status == kRunning && steps == t_star && __ldcg(m + 3) != 0));
    const int st = ended ? status : (flip ? kSolved : kRunning);
    const int vals = ended ? __ldcg(m + 2) : t_star * waves;
    fold[(size_t)i * 2] = st;
    fold[(size_t)i * 2 + 1] = vals;
    if (st == kSolved) winner = min(winner, (unsigned)i);
    total += (unsigned)vals;
    undecided |= st == kRunning || st == kOverflow;
  }
  winner = grp.template reduce<MinOp>(winner);
  total = grp.template reduce<AddOp>(total);
  undecided = grp.template reduce<OrOp>(undecided);
  const bool found = winner != kNoKey;
  for (int c = t; c < C; c += T) row[c] = found ? __ldcg(grid + (size_t)winner * C + c) : 0;
  if (t == 0) {
    row[C] = found;
    row[C + 1] = (int32_t)total;
    row[C + 2] = undecided != 0;
  }
}

template <int BOX>
__global__ void __launch_bounds__(kRaceThreads[BOX])
dfs_race_kernel(const int32_t* __restrict__ states, int32_t* __restrict__ grid_out,
                int32_t* __restrict__ meta, int32_t* __restrict__ fold,
                int32_t* __restrict__ row, int8_t* __restrict__ stack_grid,
                int32_t* __restrict__ stack_cell, int32_t* __restrict__ stack_mask,
                unsigned* scratch, int M, int D, int max_iters, int waves, int options) {
  constexpr int T = kRaceThreads[BOX];
  using G = BlockGroup<T>;
  using Geo = Geometry<BOX, T>;
  constexpr int C = Geo::C;
  constexpr int CPL = Geo::CPL;
  __shared__ int32_t words[Geo::WORDS];
  __shared__ unsigned red[G::kRedWords];
  __shared__ int last;
  extern __shared__ __align__(16) unsigned char race_stack[];
  const int t = threadIdx.x;
  const int i = blockIdx.x;
  G grp{t, red, 0};
  const Smem sh = group_smem<BOX>(words);
  int g[CPL], pk[CPL];
  UnitWalk uw[Geo::UPL];
  lane_layout<BOX, G>(t, pk, uw);
  const int32_t* in = states + (size_t)i * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) g[j] = owns<BOX, T>(t, j) ? in[t + j * T] : 0;
  int8_t* sg;
  int32_t *sc, *sm;
  if constexpr (kRaceOnChip<BOX>) {
    sc = reinterpret_cast<int32_t*>(race_stack);
    sm = sc + D;
    sg = reinterpret_cast<int8_t*>(sm + D);
  } else {
    sg = stack_grid + (size_t)i * D * C;
    sc = stack_cell + (size_t)i * D;
    sm = stack_mask + (size_t)i * D;
  }

  Search s{kRunning, 0, 0, 0, 0, 0, 0};
  search<BOX>(g, pk, uw, sh, grp, sg, sc, sm, D, max_iters, waves, options, s,
              RacePoll{scratch, t, kNoKey});
  if (s.status == kSolved && t == 0) atomicMin(scratch, (unsigned)s.steps);
  // the closing analysis of a state stopped RUNNING (uniform over the block)
  const int complete =
      s.status == kRunning && value_pass<BOX>(g, uw, sh.cm, sh.uo, grp) == 0;

  int32_t* out = grid_out + (size_t)i * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (owns<BOX, T>(t, j)) out[t + j * T] = g[j];
  }
  if (t == 0) {
    int32_t* m = meta + (size_t)i * kRaceMetaCols;
    m[0] = s.status;
    m[1] = s.steps;
    m[2] = s.validations;
    m[3] = complete;
  }
  // the last block to finish folds: each block's writes are fenced before
  // its ticket, and the fold reads them from L2
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(scratch + 1, 1u) == (unsigned)(M - 1);
  __syncthreads();
  if (!last) return;  // uniform over the block
  __threadfence();
  race_fold<BOX>(grp, meta, grid_out, fold, row, M, waves);
  if (t == 0) {
    // every block has taken its ticket, so none reads the stop word again
    scratch[0] = kNoKey;
    scratch[1] = 0;
  }
}

template <int BOX>
int launch(const void* boards, void* grid_out, void* meta, void* stack_grid,
           void* stack_cell, void* stack_mask, int B, int D, int max_iters, int waves,
           int options, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  dfs_solver_kernel<BOX><<<blocks, kWarps * kLanes, 0, stream>>>(
      static_cast<const int32_t*>(boards), static_cast<int32_t*>(grid_out),
      static_cast<int32_t*>(meta), static_cast<int8_t*>(stack_grid),
      static_cast<int32_t*>(stack_cell), static_cast<int32_t*>(stack_mask), B, D,
      max_iters, waves, options);
  return (int)cudaGetLastError();
}

// The state pointers of a lane pool, in the order of dfs_segment_launch.
struct Pool {
  void *grid, *stack_grid, *stack_cell, *stack_mask, *depth, *status, *guesses,
      *validations, *board_iters;
};

template <int BOX>
int launch_segment(const void* boards, int n_boards, const void* src, const Pool& p,
                   void* digest, void* gathered, void* lane_steps, int W, int D,
                   int seg_iters, int waves, int options, int prefix_gather,
                   cudaStream_t stream) {
  const int blocks = (W + kWarps - 1) / kWarps;
  dfs_segment_kernel<BOX><<<blocks, kWarps * kLanes, 0, stream>>>(
      static_cast<const int32_t*>(boards), n_boards, static_cast<const int32_t*>(src),
      static_cast<int32_t*>(p.grid), static_cast<int8_t*>(p.stack_grid),
      static_cast<int32_t*>(p.stack_cell), static_cast<int32_t*>(p.stack_mask),
      static_cast<int32_t*>(p.depth), static_cast<int32_t*>(p.status),
      static_cast<int32_t*>(p.guesses), static_cast<int32_t*>(p.validations),
      static_cast<int32_t*>(p.board_iters), static_cast<int32_t*>(digest),
      static_cast<int32_t*>(gathered), static_cast<int32_t*>(lane_steps), W, D,
      seg_iters, waves, options, prefix_gather);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  segment_digest_kernel<BOX><<<(W + kDigestLanes - 1) / kDigestLanes, kDigestThreads, 0,
                               stream>>>(
      static_cast<const int32_t*>(lane_steps), static_cast<const int32_t*>(p.grid),
      static_cast<int32_t*>(digest), static_cast<int32_t*>(gathered), W, prefix_gather);
  return (int)cudaGetLastError();
}

// Opt the race kernel in to the dynamic shared memory of its on-chip stack
// above 32 KB, which leaves its static arrays (under 16 KB at every size)
// room below the default 48 KB a block.
template <int BOX>
cudaError_t race_smem_opt_in(size_t bytes) {
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(dfs_race_kernel<BOX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int BOX>
int launch_race(const void* states, void* grid_out, void* meta, void* fold, void* row,
                void* stack_grid, void* stack_cell, void* stack_mask, void* scratch, int M,
                int D, int max_iters, int waves, int options, cudaStream_t stream) {
  // a search holds at most C - 1 frames (each pushed frame guessed another
  // empty cell), so a deeper stack is never reached and never OVERFLOWs
  if (D > Geometry<BOX>::C) D = Geometry<BOX>::C;
  const size_t smem = race_stack_bytes<BOX>(D);
  if (!kRaceOnChip<BOX> && (!stack_grid || !stack_cell || !stack_mask))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = race_smem_opt_in<BOX>(smem);
  if (err != cudaSuccess) return (int)err;
  dfs_race_kernel<BOX><<<M, kRaceThreads[BOX], smem, stream>>>(
      static_cast<const int32_t*>(states), static_cast<int32_t*>(grid_out),
      static_cast<int32_t*>(meta), static_cast<int32_t*>(fold), static_cast<int32_t*>(row),
      static_cast<int8_t*>(stack_grid), static_cast<int32_t*>(stack_cell),
      static_cast<int32_t*>(stack_mask), static_cast<unsigned*>(scratch), M, D, max_iters,
      waves, options);
  return (int)cudaGetLastError();
}

// Race blocks resident on one SM of the current device at once (the
// occupancy its threads, registers and shared memory allow at the full
// depth C), or -1 on an error.
template <int BOX>
int race_states_per_sm() {
  const size_t smem = race_stack_bytes<BOX>(Geometry<BOX>::C);
  int blocks = -1;
  cudaError_t err = race_smem_opt_in<BOX>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dfs_race_kernel<BOX>,
                                                        kRaceThreads[BOX], smem);
  return err == cudaSuccess ? blocks : -1;
}

// f(std::integral_constant<int, box>{}) for a box edge 2..5, else `bad`.
template <class F>
int by_box(int box, int bad, F f) {
  switch (box) {
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 3:
      return f(std::integral_constant<int, 3>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 5:
      return f(std::integral_constant<int, 5>{});
    default:
      return bad;
  }
}

}  // namespace

extern "C" {

// Meta columns per board, so the wrapper can check its layout.
int dfs_solver_meta_cols() { return kMetaCols; }

// Digest columns per lane of a segment, likewise.
int dfs_segment_digest_cols() { return kDigestCols; }

// Warps of the segment kernel resident on one SM of the current device at
// once, for board box edge `box` (the occupancy its registers and shared
// memory allow), or -1 on an error.
int dfs_segment_warps_per_sm(int box) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (box) {
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dfs_segment_kernel<2>,
                                                          kWarps * kLanes, 0);
      break;
    case 3:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dfs_segment_kernel<3>,
                                                          kWarps * kLanes, 0);
      break;
    case 4:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dfs_segment_kernel<4>,
                                                          kWarps * kLanes, 0);
      break;
    case 5:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dfs_segment_kernel<5>,
                                                          kWarps * kLanes, 0);
      break;
  }
  return err == cudaSuccess ? blocks * kWarps : -1;
}

// boards (B, C) int32 in, grid_out (B, C) int32 and meta (B, 4) int32 out,
// scratch stack_grid (B, D, C) int8, stack_cell and stack_mask (B, D) int32.
// box is the board's box edge (2..5); waves >= 1 sweeps a step; options is
// a mask of 1 (locked candidates), 2 (naked pairs, with 1) and 4 (the extra
// sweeps without eliminations). Returns a cudaError_t.
int dfs_solver_launch(const void* boards, void* grid_out, void* meta,
                      void* stack_grid, void* stack_cell, void* stack_mask, int B,
                      int box, int D, int max_iters, int waves, int options,
                      void* stream) {
  if (B <= 0 || D <= 0 || max_iters < 0 || waves < 1 || (options & ~7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (box) {
    case 2:
      return launch<2>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, waves, options, s);
    case 3:
      return launch<3>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, waves, options, s);
    case 4:
      return launch<4>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, waves, options, s);
    case 5:
      return launch<5>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, waves, options, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One segment over a pool of W lanes: the segment kernel, then the digest
// kernel, on `stream`. boards (n_boards, C) int32 and src (W,) int32 in; the
// pool's grid (W, C), stack_grid (W, D, C) int8, stack_cell and stack_mask
// (W, D), and depth, status, guesses, validations and board_iters (W,) int32
// are read and updated in place; digest (W, 8) and gathered (W, C) int32
// out; lane_steps (W,) int32 scratch. box, waves and options as for
// dfs_solver_launch; seg_iters >= 0 steps a lane at most; prefix_gather
// picks the solution block's form. Returns a cudaError_t.
int dfs_segment_launch(const void* boards, int n_boards, const void* src, void* grid,
                       void* stack_grid, void* stack_cell, void* stack_mask,
                       void* depth, void* status, void* guesses, void* validations,
                       void* board_iters, void* digest, void* gathered,
                       void* lane_steps, int W, int box, int D, int seg_iters,
                       int waves, int options, int prefix_gather, void* stream) {
  if (W <= 0 || n_boards <= 0 || D <= 0 || seg_iters < 0 || waves < 1 ||
      (options & ~7))
    return (int)cudaErrorInvalidValue;
  const Pool p{grid, stack_grid, stack_cell, stack_mask, depth, status,
               guesses, validations, board_iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (box) {
    case 2:
      return launch_segment<2>(boards, n_boards, src, p, digest, gathered, lane_steps,
                               W, D, seg_iters, waves, options, prefix_gather, s);
    case 3:
      return launch_segment<3>(boards, n_boards, src, p, digest, gathered, lane_steps,
                               W, D, seg_iters, waves, options, prefix_gather, s);
    case 4:
      return launch_segment<4>(boards, n_boards, src, p, digest, gathered, lane_steps,
                               W, D, seg_iters, waves, options, prefix_gather, s);
    case 5:
      return launch_segment<5>(boards, n_boards, src, p, digest, gathered, lane_steps,
                               W, D, seg_iters, waves, options, prefix_gather, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Run-record columns per race state, and the packed row's columns after the
// solution, so the wrapper can check its layout.
int dfs_race_meta_cols() { return kRaceMetaCols; }
int dfs_race_row_extra() { return kRaceRowExtra; }

// The race kernel's threads a state for box edge `box`, and whether its
// guess stack lives on chip (1: the wrapper passes no slab), or -1.
int dfs_race_threads(int box) {
  return box >= 2 && box <= 5 ? kRaceThreads[box] : -1;
}
int dfs_race_stack_on_chip(int box) {
  return box >= 2 && box <= 5 ? (int)(box <= kRaceOnChipMaxBox) : -1;
}

// Race states resident on one SM of the current device at once for box
// edge `box` (one block each), or -1 on an error.
int dfs_race_states_per_sm(int box) {
  return by_box(box, -1, [](auto b) { return race_states_per_sm<decltype(b)::value>(); });
}

// One frontier race over M states, one launch on `stream`. states (M, C)
// int32 in; grid_out (M, C) and meta (M, 4) int32 out (each state's run:
// its grid and status, steps, validations, complete); fold (M, 2) int32 out
// (status and validations after the lockstep race); row (C + 3) int32 out
// (solution, found, validations, undecided). stop: the race's two-word
// scratch (stop step, ticket count), idle at 0xffffffff, 0 before the
// launch and left so after it; races on one stream may share it, races on
// two streams may not. stack_grid (M, D', C) int8, stack_cell and
// stack_mask (M, D') int32, with D' = min(D, C): the guess-stack slab,
// scratch, for a box whose stack does not live on chip
// (dfs_race_stack_on_chip), else ignored and may be null. box, waves and
// options as for dfs_solver_launch; a state takes at most max_iters steps.
// Returns a cudaError_t.
int dfs_race_launch(const void* states, void* grid_out, void* meta, void* fold, void* row,
                    void* stack_grid, void* stack_cell, void* stack_mask, void* stop, int M,
                    int box, int D, int max_iters, int waves, int options, void* stream) {
  if (M <= 0 || D <= 0 || max_iters < 0 || waves < 1 || (options & ~7) || !stop)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_box(box, (int)cudaErrorInvalidValue, [&](auto b) {
    return launch_race<decltype(b)::value>(states, grid_out, meta, fold, row, stack_grid,
                                           stack_cell, stack_mask, stop, M, D, max_iters,
                                           waves, options, s);
  });
}

}  // extern "C"
