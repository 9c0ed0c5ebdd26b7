// dfs_solver.cu — the whole DFS sudoku solve of a batch, one warp per board.
//
// Replaces the TPU kernel sudoku_solver_distributed_tpu/ops/pallas_solver.py
// ::_make_kernel (pallas_solver.py:98, launched by solve_batch_pallas through
// pl.pallas_call). It computes what that kernel computes, board for board:
// each step runs the fused singles analysis (unit once/twice value masks,
// candidates, naked and hidden singles, duplicate / dead-cell / out-of-range
// / solved verdicts), then takes one action — assign every forced single; or
// branch on the minimum-remaining-values cell (lowest cell index on ties,
// lowest candidate bit guessed, OVERFLOW when the stack is full); or
// backtrack (UNSAT on an empty stack, pop an exhausted frame without
// restoring the grid, or restore the frame's snapshot and try its next
// candidate bit). A board is RUNNING until one of those ends it or it has
// taken max_iters steps; a closing analysis then flips a board completed on
// the capped step to SOLVED. Counters per board: guesses (+1 per branch),
// validations (+1 per step, every step is taken while RUNNING), steps.
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
//     unit's N cells are an arithmetic walk base + (k/BOX)*sa + (k%BOX)*sb.
//
// One step is five passes over the warp's slice of shared memory, each a
// handful of instructions per lane between __syncwarp()s: (A) cell lanes
// write their value masks; (B) unit lanes fold their N cells into once/twice
// masks (a pairwise tree, log2(N) deep) and write the unit's value mask;
// the empty / out-of-range / duplicate verdicts are one __reduce_or_sync;
// (C) cell lanes form candidates from three unit masks and write them, and
// `dead` is one vote; (D) unit lanes fold the candidates into the unit's
// hidden-single mask (once & ~twice); (E) cell lanes assign their singles.
// Every single of a step is taken from the same pre-step analysis, as in
// the lockstep solvers, so assigning them in parallel is exact. With no
// single, MRV is one __reduce_min_sync of the key (popcount << 10 | cell):
// lowest popcount, ties to the lowest flat cell, as the plain version's
// explicit min-index does; the winning cell's mask is one __reduce_or_sync.
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
// the 4096-board bucket is 4096 warps, ~31 per SM, all resident.
//
// What bounds it on an H100: neither bytes (C ints in and out per board)
// nor the integer rate, but the latency of one step's dependent chain —
// four shared-memory round trips between __syncwarp()s, two or three warp
// votes and reductions, a few dozen dependent integer operations, and on a
// backtrack one load of the snapshot from L1/L2 — times the slowest
// board's step count. Boards overlap across warps; the steps of one board
// cannot (PERF.md has the per-step time). Locked-candidate sweeps (the
// serving config's K2, not in this kernel) would slot in as one more pass
// over the units between (D) and (E), with the box/line intersections as
// further arithmetic walks.
//
// Interface: plain C, for ctypes. The launch uses the caller's stream, does
// not synchronize and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRunning = 0;
constexpr int kSolved = 1;
constexpr int kUnsat = 2;
constexpr int kOverflow = 3;
constexpr int kLanes = 32;
constexpr int kWarps = 4;     // boards per block, one per warp
constexpr int kMetaCols = 4;  // status, guesses, validations, steps
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCellBits = 10;  // MRV key: popcount << kCellBits | cell
constexpr unsigned kNoKey = 0xffffffffu;

// verdict bits of the value pass, OR-reduced over the warp
constexpr int kEmpty = 1;  // some cell is 0
constexpr int kBad = 2;    // some value lies outside 1..N
constexpr int kDup = 4;    // some unit holds a value twice

template <int BOX>
struct Geometry {
  static constexpr int N = BOX * BOX;
  static constexpr int C = N * N;
  static constexpr int U = 3 * N;                        // rows, columns, boxes
  static constexpr int FULL = (1 << N) - 1;
  static constexpr int CPL = (C + kLanes - 1) / kLanes;  // cells per lane
  static constexpr int UPL = (U + kLanes - 1) / kLanes;  // units per lane
  static constexpr int WORDS = C + 2 * U;                // shared int32 per warp
  static_assert(C <= (1 << kCellBits), "MRV key packs the cell in kCellBits");
};

// Slot j of a lane holds cell lane + 32 j; the last slot may run off the board.
template <int BOX>
__device__ __forceinline__ bool owns(int lane, int j) {
  constexpr int C = Geometry<BOX>::C;
  return (j + 1) * kLanes <= C || lane + j * kLanes < C;
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

// Bits set in >= 1 / >= 2 of the unit's N cell masks, folded as a pairwise
// tree so the dependent chain is log2(N) combines deep.
template <int BOX>
__device__ __forceinline__ void unit_once_twice(const int32_t* cm, const UnitWalk& w,
                                                int& once, int& twice) {
  constexpr int N = Geometry<BOX>::N;
  int o[N], t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    o[k] = cm[w.base + (k / BOX) * w.sa + (k % BOX) * w.sb];
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

// Passes A and B: value masks per cell, then per unit; writes uo[] and
// returns the warp's verdict bits (0 ⇔ the board is solved).
template <int BOX>
__device__ __forceinline__ int value_pass(const int (&g)[Geometry<BOX>::CPL],
                                          const UnitWalk (&uw)[Geometry<BOX>::UPL],
                                          int32_t* cm, int32_t* uo, int lane) {
  using Geo = Geometry<BOX>;
  int flags = 0;
#pragma unroll
  for (int j = 0; j < Geo::CPL; ++j) {
    if (!owns<BOX>(lane, j)) continue;
    const int v = g[j];
    const bool in_range = v >= 1 && v <= Geo::N;
    flags |= v == 0 ? kEmpty : (in_range ? 0 : kBad);
    cm[lane + j * kLanes] = in_range ? 1 << (v - 1) : 0;
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < Geo::UPL; ++s) {
    if (uw[s].unit >= Geo::U) continue;
    int once, twice;
    unit_once_twice<BOX>(cm, uw[s], once, twice);
    uo[uw[s].unit] = once;
    if (twice) flags |= kDup;
  }
  __syncwarp();
  return (int)__reduce_or_sync(kAll, (unsigned)flags);
}

template <int BOX>
__global__ void __launch_bounds__(kWarps * kLanes)
dfs_solver_kernel(const int32_t* __restrict__ boards, int32_t* __restrict__ grid_out,
                  int32_t* __restrict__ meta, int8_t* __restrict__ stack_grid,
                  int32_t* __restrict__ stack_cell, int32_t* __restrict__ stack_mask,
                  int B, int D, int max_iters) {
  using Geo = Geometry<BOX>;
  constexpr int N = Geo::N;
  constexpr int C = Geo::C;
  constexpr int CPL = Geo::CPL;
  constexpr int UPL = Geo::UPL;
  __shared__ int32_t smem[kWarps][Geo::WORDS];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int board = blockIdx.x * kWarps + warp;
  if (board >= B) return;  // the whole warp leaves; no block-wide barrier follows
  int32_t* cm = smem[warp];  // per cell: value mask (A-B), then candidates (C-D)
  int32_t* uo = cm + C;      // per unit: values present
  int32_t* hid = uo + Geo::U;  // per unit: candidates with one admitting cell

  // per cell slot: its value, its candidates, and its row / column / box
  // unit ids packed a byte each
  int g[CPL], cand[CPL], pk[CPL];
  const int32_t* in = boards + (size_t)board * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int cell = lane + j * kLanes;
    const int r = cell / N, c = cell % N;
    pk[j] = r | (N + c) << 8 | (2 * N + (r / BOX) * BOX + c / BOX) << 16;
    g[j] = owns<BOX>(lane, j) ? in[cell] : 0;
  }
  UnitWalk uw[UPL];
#pragma unroll
  for (int s = 0; s < UPL; ++s) uw[s] = unit_walk<BOX>(lane + s * kLanes);

  int8_t* sg = stack_grid + (size_t)board * D * C;
  int32_t* sc = stack_cell + (size_t)board * D;
  int32_t* sm = stack_mask + (size_t)board * D;
  // every value below is warp-uniform
  int status = kRunning, depth = 0, guesses = 0, steps = 0;
  int top_cell = 0, top_mask = 0;  // frame depth-1, kept out of the slab

  while (steps < max_iters) {
    ++steps;
    const int flags = value_pass<BOX>(g, uw, cm, uo, lane);
    if (flags == 0) {
      status = kSolved;
      break;
    }

    // Pass C: candidates of the empty cells, and dead cells.
    bool dead = false;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      int c = 0;
      if (owns<BOX>(lane, j)) {
        if (g[j] == 0) {
          const int p = pk[j];
          c = ~(uo[p & 0xff] | uo[(p >> 8) & 0xff] | uo[p >> 16]) & Geo::FULL;
          dead |= c == 0;
        }
        cm[lane + j * kLanes] = c;
      }
      cand[j] = c;
    }

    if ((flags & (kDup | kBad)) || __any_sync(kAll, dead)) {
      // backtrack
      if (depth == 0) {
        status = kUnsat;
        break;
      }
      if (top_mask == 0) {
        // exhausted frame: pop; the grid stays contradictory
        if (--depth) {
          top_cell = sc[depth - 1];
          top_mask = sm[depth - 1];
        }
        continue;
      }
      const int bit = top_mask & -top_mask;
      const int8_t* f = sg + (size_t)(depth - 1) * C;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int cell = lane + j * kLanes;
        if (owns<BOX>(lane, j)) g[j] = cell == top_cell ? __ffs(bit) : f[cell];
      }
      top_mask &= ~bit;
      continue;
    }

    // Pass D: per-unit hidden-single masks from the candidates.
    __syncwarp();
#pragma unroll
    for (int s = 0; s < UPL; ++s) {
      if (uw[s].unit >= Geo::U) continue;
      int once, twice;
      unit_once_twice<BOX>(cm, uw[s], once, twice);
      hid[uw[s].unit] = once & ~twice;
    }
    __syncwarp();

    // Pass E: assign every forced single; otherwise key the MRV candidates.
    bool assigned = false;
    unsigned key = kNoKey;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = cand[j];
      if (c == 0) continue;
      const int p = pk[j];
      const int exact1 = hid[p & 0xff] | hid[(p >> 8) & 0xff] | hid[p >> 16];
      const int pc = __popc(c);
      int a = pc == 1 ? c : (c & exact1);
      a &= -a;
      if (a != 0) {
        g[j] = __ffs(a);
        assigned = true;
      } else {
        key = min(key, (unsigned)(pc << kCellBits | (lane + j * kLanes)));
      }
    }
    if (__any_sync(kAll, assigned)) continue;

    // branch on the MRV cell
    if (depth >= D) {
      status = kOverflow;
      break;
    }
    const int cell = (int)(__reduce_min_sync(kAll, key) & ((1u << kCellBits) - 1));
    int mine = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (lane + j * kLanes == cell) mine = cand[j];
    }
    const int mask = (int)__reduce_or_sync(kAll, (unsigned)mine);
    const int bit = mask & -mask;
    int8_t* f = sg + (size_t)depth * C;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + j * kLanes;
      if (!owns<BOX>(lane, j)) continue;
      f[c] = (int8_t)g[j];
      if (c == cell) g[j] = __ffs(bit);
    }
    if (depth > 0 && lane == 0) {
      sc[depth - 1] = top_cell;
      sm[depth - 1] = top_mask;
    }
    top_cell = cell;
    top_mask = mask & ~bit;
    ++depth;
    ++guesses;
  }

  // the step cap stopped a board that its last step may have completed
  if (status == kRunning && value_pass<BOX>(g, uw, cm, uo, lane) == 0) status = kSolved;

  int32_t* out = grid_out + (size_t)board * C;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (owns<BOX>(lane, j)) out[lane + j * kLanes] = g[j];
  }
  if (lane == 0) {
    int32_t* m = meta + (size_t)board * kMetaCols;
    m[0] = status;
    m[1] = guesses;
    m[2] = steps;  // validations: every step is taken while RUNNING
    m[3] = steps;
  }
}

template <int BOX>
int launch(const void* boards, void* grid_out, void* meta, void* stack_grid,
           void* stack_cell, void* stack_mask, int B, int D, int max_iters,
           cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  dfs_solver_kernel<BOX><<<blocks, kWarps * kLanes, 0, stream>>>(
      static_cast<const int32_t*>(boards), static_cast<int32_t*>(grid_out),
      static_cast<int32_t*>(meta), static_cast<int8_t*>(stack_grid),
      static_cast<int32_t*>(stack_cell), static_cast<int32_t*>(stack_mask), B, D,
      max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Meta columns per board, so the wrapper can check its layout.
int dfs_solver_meta_cols() { return kMetaCols; }

// boards (B, C) int32 in, grid_out (B, C) int32 and meta (B, 4) int32 out,
// scratch stack_grid (B, D, C) int8, stack_cell and stack_mask (B, D) int32.
// box is the board's box edge (2..5). Returns a cudaError_t.
int dfs_solver_launch(const void* boards, void* grid_out, void* meta,
                      void* stack_grid, void* stack_cell, void* stack_mask, int B,
                      int box, int D, int max_iters, void* stream) {
  if (B <= 0 || D <= 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (box) {
    case 2:
      return launch<2>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, s);
    case 3:
      return launch<3>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, s);
    case 4:
      return launch<4>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, s);
    case 5:
      return launch<5>(boards, grid_out, meta, stack_grid, stack_cell, stack_mask, B,
                       D, max_iters, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
