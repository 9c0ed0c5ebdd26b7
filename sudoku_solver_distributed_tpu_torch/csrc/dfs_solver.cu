// dfs_solver.cu — the whole DFS sudoku solve of a batch, one thread per board.
//
// Replaces the TPU kernel sudoku_solver_distributed_tpu/ops/pallas_solver.py
// ::_make_kernel (launched by solve_batch_pallas through pl.pallas_call). It
// computes what that kernel computes, board for board: each step runs the
// fused singles analysis (unit once/twice value masks, candidates, naked and
// hidden singles, duplicate / dead-cell / out-of-range / solved verdicts),
// then takes one action — assign every forced single; or branch on the
// minimum-remaining-values cell (lowest cell index on ties, lowest candidate
// bit guessed, OVERFLOW when the stack is full); or backtrack (UNSAT on an
// empty stack, pop an exhausted frame, or restore the frame's snapshot and
// try its next candidate bit). A board is RUNNING until one of those ends
// it or it has taken max_iters steps; a closing analysis then flips a board
// completed on the capped step to SOLVED. Counters per board: guesses (+1
// per branch), validations (+1 per step taken while RUNNING), steps.
//
// What is not carried over is the TPU layout: the Pallas kernel puts boards
// on the 128 lanes and finds unit counts as matmuls against a unit-incidence
// matrix, because the MXU is where a TPU does wide work. Here each thread
// owns one board and walks its cells with __popc / __ffs / m & -m on int32
// masks. Every per-board output depends only on that board's own trajectory
// (a finished board is a fixed point of the lockstep step), so this equals
// the lockstep result although boards no longer step together. The two
// schedule counters differ: a board's own step count replaces the lockstep
// iteration count (the wrapper reports the maximum), and there are no idle
// lanes to count.
//
// What bounds it on an H100: operations, not bytes. The inputs and outputs
// are C ints per board; the work is three sweeps over the C cells per step
// (25 integer operations per cell on the cheapest path, more for an empty
// cell), and hard boards take hundreds of steps. The
// limit in practice is latency, not the integer rate: with one thread per
// board a 4096-board batch is 128 warps, one per SM, so each SM issues from
// a single warp and every shared- or local-memory access stalls it. The
// design keeps each board's grid in shared memory laid out [cell][thread]
// (a warp touching cell c of its 32 boards hits 32 distinct banks), the
// unit masks in per-thread local arrays (interleaved by the hardware, so
// also conflict-free), and the guess stack — (B, D, C) int8 snapshots plus
// the (B, D) cell and untried-mask frames — in a device-memory scratch slab
// the wrapper allocates, so the stack depth is bounded only by memory. A
// warp runs until its slowest board finishes, which is the Pallas kernel's
// per-block early exit at a width of 32 boards instead of 128.
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
constexpr int kThreads = 32;  // boards per block: one warp
constexpr int kMetaCols = 4;  // status, guesses, validations, steps

template <int BOX>
struct Geometry {
  static constexpr int N = BOX * BOX;
  static constexpr int C = N * N;
  static constexpr int FULL = (1 << N) - 1;
  __device__ static int box_of(int r, int c) { return (r / BOX) * BOX + c / BOX; }
};

// Pass 1 of the analysis: per-unit once/twice value masks (rows 0..N-1,
// columns N..2N-1, boxes 2N..3N-1), plus the board-wide verdicts. A value
// outside 1..N contributes no bit and sets `bad`.
template <int BOX>
__device__ void value_masks(const int32_t* g, int T, int* uo, int* ut,
                            bool& dup, bool& bad, int& empties) {
  using Geo = Geometry<BOX>;
  constexpr int N = Geo::N;
  for (int u = 0; u < 3 * N; ++u) {
    uo[u] = 0;
    ut[u] = 0;
  }
  bad = false;
  empties = 0;
  for (int r = 0; r < N; ++r) {
    for (int c = 0; c < N; ++c) {
      int v = g[(r * N + c) * T];
      if (v == 0) {
        ++empties;
      } else if (v < 0 || v > N) {
        bad = true;
      } else {
        int m = 1 << (v - 1);
        int b = Geo::box_of(r, c);
        ut[r] |= uo[r] & m;
        uo[r] |= m;
        ut[N + c] |= uo[N + c] & m;
        uo[N + c] |= m;
        ut[2 * N + b] |= uo[2 * N + b] & m;
        uo[2 * N + b] |= m;
      }
    }
  }
  int any_dup = 0;
  for (int u = 0; u < 3 * N; ++u) any_dup |= ut[u];
  dup = any_dup != 0;
}

template <int BOX>
__global__ void __launch_bounds__(kThreads)
dfs_solver_kernel(const int32_t* __restrict__ boards, int32_t* __restrict__ grid_out,
                  int32_t* __restrict__ meta, int8_t* __restrict__ stack_grid,
                  int32_t* __restrict__ stack_cell, int32_t* __restrict__ stack_mask,
                  int B, int D, int max_iters) {
  using Geo = Geometry<BOX>;
  constexpr int N = Geo::N;
  constexpr int C = Geo::C;
  extern __shared__ int32_t smem[];
  const int T = blockDim.x;
  const int board = blockIdx.x * T + threadIdx.x;
  if (board >= B) return;  // no block-wide barrier follows
  int32_t* g = smem + threadIdx.x;  // cell c lives at g[c * T]

  const int32_t* in = boards + (size_t)board * C;
  for (int c = 0; c < C; ++c) g[c * T] = in[c];
  int8_t* sg = stack_grid + (size_t)board * D * C;
  int32_t* sc = stack_cell + (size_t)board * D;
  int32_t* sm = stack_mask + (size_t)board * D;

  int uo[3 * N], ut[3 * N];  // value masks per unit: seen once / twice
  int ho[3 * N], ht[3 * N];  // candidate masks per unit: once / twice
  int status = kRunning, depth = 0, guesses = 0, validations = 0, steps = 0;

  while (status == kRunning && steps < max_iters) {
    ++steps;
    ++validations;
    bool dup, bad;
    int empties;
    value_masks<BOX>(g, T, uo, ut, dup, bad, empties);
    if (empties == 0 && !dup && !bad) {
      status = kSolved;
      break;
    }

    // Pass 2: candidates of the empty cells, dead cells, and per-unit
    // once/twice candidate masks for the hidden singles.
    for (int u = 0; u < 3 * N; ++u) {
      ho[u] = 0;
      ht[u] = 0;
    }
    bool dead = false;
    for (int r = 0; r < N; ++r) {
      for (int c = 0; c < N; ++c) {
        if (g[(r * N + c) * T] != 0) continue;
        int b = Geo::box_of(r, c);
        int cand = ~(uo[r] | uo[N + c] | uo[2 * N + b]) & Geo::FULL;
        dead |= cand == 0;
        ht[r] |= ho[r] & cand;
        ho[r] |= cand;
        ht[N + c] |= ho[N + c] & cand;
        ho[N + c] |= cand;
        ht[2 * N + b] |= ho[2 * N + b] & cand;
        ho[2 * N + b] |= cand;
      }
    }

    if (dup || dead || bad) {
      // backtrack
      if (depth == 0) {
        status = kUnsat;
      } else {
        int top = depth - 1;
        int tm = sm[top];
        if (tm == 0) {
          --depth;  // exhausted frame: pop; the grid stays contradictory
        } else {
          int bit = tm & -tm;
          const int8_t* f = sg + (size_t)top * C;
          for (int c = 0; c < C; ++c) g[c * T] = f[c];
          g[sc[top] * T] = __ffs(bit);
          sm[top] = tm & ~bit;
        }
      }
      continue;
    }

    // Pass 3: assign every forced single in place (the analysis above is
    // complete, and a cell's candidates depend only on the unit masks, so
    // writing cell k never changes what cell k+1 sees), and track the MRV
    // cell for the case that no single exists.
    bool assigned = false;
    int best = 1 << 30, best_cell = 0, best_mask = 0;
    for (int r = 0; r < N; ++r) {
      for (int c = 0; c < N; ++c) {
        int cell = r * N + c;
        if (g[cell * T] != 0) continue;
        int b = Geo::box_of(r, c);
        int cand = ~(uo[r] | uo[N + c] | uo[2 * N + b]) & Geo::FULL;
        int pc = __popc(cand);
        int exact1 = (ho[r] & ~ht[r]) | (ho[N + c] & ~ht[N + c]) |
                     (ho[2 * N + b] & ~ht[2 * N + b]);
        int a = pc == 1 ? cand : (cand & exact1);
        a &= -a;
        if (a != 0) {
          g[cell * T] = __ffs(a);
          assigned = true;
        } else if (pc < best) {
          best = pc;
          best_cell = cell;
          best_mask = cand;
        }
      }
    }
    if (assigned) continue;

    // branch on the MRV cell
    if (depth >= D) {
      status = kOverflow;
      continue;
    }
    int8_t* f = sg + (size_t)depth * C;
    for (int c = 0; c < C; ++c) f[c] = (int8_t)g[c * T];
    int bit = best_mask & -best_mask;
    sc[depth] = best_cell;
    sm[depth] = best_mask & ~bit;
    g[best_cell * T] = __ffs(bit);
    ++depth;
    ++guesses;
  }

  if (status == kRunning) {
    // the step cap stopped a board that its last step may have completed
    bool dup, bad;
    int empties;
    value_masks<BOX>(g, T, uo, ut, dup, bad, empties);
    if (empties == 0 && !dup && !bad) status = kSolved;
  }

  int32_t* out = grid_out + (size_t)board * C;
  for (int c = 0; c < C; ++c) out[c] = g[c * T];
  int32_t* m = meta + (size_t)board * kMetaCols;
  m[0] = status;
  m[1] = guesses;
  m[2] = validations;
  m[3] = steps;
}

template <int BOX>
int launch(const void* boards, void* grid_out, void* meta, void* stack_grid,
           void* stack_cell, void* stack_mask, int B, int D, int max_iters,
           cudaStream_t stream) {
  constexpr int C = Geometry<BOX>::C;
  const int smem = C * kThreads * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      dfs_solver_kernel<BOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kThreads - 1) / kThreads;
  dfs_solver_kernel<BOX><<<blocks, kThreads, smem, stream>>>(
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
