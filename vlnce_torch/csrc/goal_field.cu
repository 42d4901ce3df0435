// Geodesic distance fields on occupancy grids: one block per goal.
//
// Replaces no TPU kernel. The JAX package builds these fields on the host, as
// the port did: a Python Dijkstra per goal (vlnce_tpu/envs/gridworld.py,
// BaseScene._dijkstra), cached per scene and goal cell. The closed loops on
// the card meet a new goal with almost every path of a split, so a chunk of
// 64 episodes built about 22 fields of 27 ms each on the host while the card
// sat idle. This kernel builds a chunk's distinct fields in one launch.
//
// What it computes. For each field f, cells[f] = (row, gi, gj): the grid is
// occupancy[row] ([n, n] bytes, nonzero = blocked) and (gi, gj) a free goal
// cell. out[f] is the host's 8-connected geodesic distance in f64: 0 at the
// goal, +inf where blocked or unreachable, a step of `step` to an orthogonal
// neighbour and of `diag` to a diagonal one, no move into a blocked cell or
// off the grid, no diagonal past a blocked orthogonal neighbour.
//
// Why it matches the host bit for bit. Every step is positive and IEEE
// addition rounds monotonically, so the equations d[v] = min over moves u->v
// of fl(d[u] + w) (d[goal] = 0) have one solution, and the host's Dijkstra
// ends at it. Here each block relaxes its field in place, sweep after sweep,
// with the same f64 additions, until a whole sweep changes no cell. Every
// value a cell takes is the rounded length of a real path, so it never falls
// below the solution; a sweep that changes nothing means every cell already
// satisfies its equation, so the field is the solution. The block never stops
// after a fixed count. A thread may read a neighbour that another thread is
// rewriting in the same sweep: either value is a path's length, and a sweep
// in which anything changed is followed by another.
//
// What bounds it. Not bytes: the least traffic is reading the grid and
// writing the field, 9 bytes a cell (F x n^2 x 9 over 3.35 TB/s, under a
// microsecond for a chunk's 22 fields at n = 64). The sweeps are the work,
// each a pass over n^2 cells of up to eight neighbour reads and f64 additions,
// and a barrier; their number follows the longest path in cells (about 60 for
// the procedural 64 x 64 scenes). The fields are independent, so a chunk's F
// blocks run side by side on F of the card's SMs.
//
// Design.
// - The moves into each cell are worked out once, before the sweeps, as an
//   8-bit mask (bit k: the step from neighbour k is allowed), so a sweep reads
//   no occupancy and tests no bounds.
// - Sweeps alternate between ascending and descending cell order, so that a
//   thread's later cells see its earlier updates in both directions.
// - Where the field and the masks fit in one block's shared memory (9 n^2
//   bytes; up to n = 160 on this card), they live there and the field is
//   written out once at the end (`shared_bytes` > 0). Larger grids (imported
//   scenes) keep the field in `out` itself and the masks in `scratch`, both in
//   device memory (L2 holds them), with the same code.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    goal_field_kernel(const uint8_t* __restrict__ occupancy, const int* __restrict__ cells,
                      double* out, uint8_t* scratch, int n, double step, double diag) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells_n = n * n;
  const int row = cells[3 * blockIdx.x], gi = cells[3 * blockIdx.x + 1],
            gj = cells[3 * blockIdx.x + 2];
  const uint8_t* occ = occupancy + (size_t)row * cells_n;
  double* field = kShared ? reinterpret_cast<double*>(smem) : out + (size_t)blockIdx.x * cells_n;
  uint8_t* mask = kShared ? smem + (size_t)cells_n * sizeof(double)
                          : scratch + (size_t)blockIdx.x * cells_n;

  // the host's eight moves, as the neighbour (i + di, j + dj) a step arrives from
  const int di[8] = {1, -1, 0, 0, 1, 1, -1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, 1, -1};
  for (int c = threadIdx.x; c < cells_n; c += kThreads) {
    const int i = c / n, j = c - i * n;
    unsigned m = 0;
    if (!occ[c]) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ni = i + di[k], nj = j + dj[k];
        if (ni < 0 || ni >= n || nj < 0 || nj >= n || occ[ni * n + nj]) continue;
        if (di[k] && dj[k] && (occ[i * n + nj] || occ[ni * n + j])) continue;  // no corner cutting
        m |= 1u << k;
      }
    }
    mask[c] = (uint8_t)m;
    field[c] = (i == gi && j == gj) ? 0.0 : CUDART_INF;
  }
  __syncthreads();

  const int offset[8] = {n, -n, 1, -1, n + 1, n - 1, -n + 1, -n - 1};
  volatile double* d = field;
  for (int sweep = 0;; ++sweep) {
    int changed = 0;
    for (int c0 = threadIdx.x; c0 < cells_n; c0 += kThreads) {
      const int c = (sweep & 1) ? cells_n - 1 - c0 : c0;
      const unsigned m = mask[c];
      if (!m) continue;
      const double current = d[c];
      double best = current;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (m & (1u << k)) {
          const double through = d[c + offset[k]] + (k < 4 ? step : diag);
          if (through < best) best = through;
        }
      }
      if (best < current) {
        d[c] = best;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  if (kShared) {
    double* dst = out + (size_t)blockIdx.x * cells_n;
    for (int c = threadIdx.x; c < cells_n; c += kThreads) dst[c] = field[c];
  }
}

}  // namespace

// occupancy: device bytes [R, n, n] (nonzero = blocked); cells: device int32
// [F, 3], each (row of occupancy, goal i, goal j) with the goal cell free;
// out: device f64 [F, n, n]. shared_bytes > 0 (at least 9 n^2) keeps each
// field in shared memory; 0 keeps it in `out` and its masks in `scratch`
// (device bytes [F, n, n]), which may otherwise be null. step and diag are the
// host's move lengths. Launches F blocks on `stream`; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for sizes it
// does not take.
extern "C" int goal_distance_fields(const uint8_t* occupancy, const int* cells, double* out,
                                    uint8_t* scratch, int F, int n, double step, double diag,
                                    int shared_bytes, cudaStream_t stream) {
  if (F < 1 || n < 1 || shared_bytes < 0) return (int)cudaErrorInvalidValue;
  if (shared_bytes == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    goal_field_kernel<false><<<F, kThreads, 0, stream>>>(occupancy, cells, out, scratch, n, step,
                                                         diag);
    return (int)cudaGetLastError();
  }
  if ((long long)shared_bytes < 9LL * n * n) return (int)cudaErrorInvalidValue;
  static int configured[kMaxDevices];  // dynamic shared memory granted so far, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (shared_bytes > 48 * 1024 && shared_bytes > configured[device]) {
    err = cudaFuncSetAttribute(goal_field_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    configured[device] = shared_bytes;
  }
  goal_field_kernel<true><<<F, kThreads, shared_bytes, stream>>>(occupancy, cells, out, scratch,
                                                                 n, step, diag);
  return (int)cudaGetLastError();
}
