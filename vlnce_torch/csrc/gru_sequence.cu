// Masked GRU over a whole sequence, forward and backward, f32 in and out.
//
// Replaces the Pallas kernel vlnce_tpu/ops/pallas_rnn.py:gru_sequence
// (body _gru_step_kernel). Each step t, for every batch row b:
//   h  *= mask[t, b]
//   hh  = h . w_hh^T + b_hh                  (torch gate order r, z, n)
//   r   = sigmoid(xi_r + hh_r), z = sigmoid(xi_z + hh_z)
//   n   = tanh(xi_n + r * hh_n)
//   h   = (1 - z) * n + z * h,  out[t, b] = h
// xi [T, B, 3H] holds the input projections with b_ih already added.
//
// What bounds it. Bytes: at the act shape (T=1, B=32, H=512) the function
// moves w_hh once (3.1 MB) plus xi, h0, masks and out (0.33 MB), about 1 us
// at 3.35 TB/s, and its 0.05 GFLOP take under 1 us at 67 TFLOP/s. Both are
// below the latency of a kernel launch, which is the floor that can be
// reached. Tensor cores are not used: TF32 would break the 1e-5 tolerance,
// and at 14 FLOP per byte the work is far below the line where they help.
//
// Design. The TPU kernel pins w_hh and h in VMEM and walks T as a sequential
// grid on one core. Here the hidden units, not the batch, are partitioned
// over the SMs: a block owns a multiple of 4 hidden units (4 at H=512: 128
// blocks on 132 SMs), that is rows g*H + j of w_hh for the three
// gates, for every batch row. So w_hh is read from device memory once per
// launch in total. Thread 0 asks for the block's slice (three contiguous runs
// of rows, 24 KB at H=512) with bulk asynchronous copies that complete on an
// mbarrier, while all threads load h * mask for a tile of batch rows into
// shared memory; the slice stays in shared memory for all T steps.
//
// Shared-memory bandwidth is what the dot products cost, so a warp's task is
// a register tile: 4 batch rows x 2 hidden units (6 rows of w_hh), with the
// 32 lanes splitting the dot products' length. A lane holds 24 running sums
// and reads 6 float4 of w_hh and 4 float4 of h per 96 multiply-adds (a warp
// reads 512 contiguous bytes at a time: no bank conflicts, and no byte read
// twice by one instruction); at B=32 a block has 16 such tasks for its 16
// warps. The sums are reduced over the lanes by recursive halving (about one
// shuffle per sum, not five), which leaves lane l with the three gates of
// row l / 8, unit (l / 4) % 2; the first of the four lanes that share them
// applies the gates and writes out[t, b, j]. It asks for xi and b_hh before
// the dot products so their latency hides behind them.
//
// T = 1 (the act step) needs nothing between blocks and is an ordinary
// launch. For T > 1 step t needs all of h from step t-1, which is out[t-1]:
// the kernel is launched cooperatively, every block waits at a grid-wide
// barrier after each step and then reads out[t-1] (past L1, since other SMs
// wrote it) times mask[t]. No scratch buffer is needed. The grid must be
// co-resident, so the launcher gives a block more units until the
// occupancy the runtime reports covers the grid.
//
// The training forward (reserve not null) also stores r, z, n and hh_n =
// h_prev . w_hh_n^T + b_hh_n of every step into reserve [T, B, 4H]; the lane
// that finishes a row and unit writes them beside out. The act step's launch
// is the same kernel without the store (a template flag).
//
// Backward (the Pallas kernel has none; the JAX package differentiates a
// lax.scan instead). Two routes, chosen by shape, then one launch for the
// weight gradient.
//
// Cluster route (gru_sequence_backward_cluster_f32), where the training
// forward's gates are given and B <= 8: one thread-block cluster walks t =
// T-1 .. 0. Each block owns H / cluster units (32 at H=512 in a cluster of
// 16, the non-portable size) and keeps their 3 x 32 rows of w_hh (192 KB) in
// shared memory for all T steps, so the cluster holds all of w_hh. Per step:
//   - a thread per owned (row b, unit j) sums the 16 blocks' parts of column
//     j of step t+1 from their shared memory (distributed shared memory),
//     times mask[t+1], plus dh * z of step t+1 and d_out[t]: dh[b, j]. With
//     the gates r, z, n, hh_n read from the reserve (asked for a step ahead),
//     it forms da_r, da_z, da_n and d_gh[t] = (da_r, da_z, da_n * r), and
//     leaves d_gh in shared memory; nothing recomputes h_prev . w_hh^T;
//   - d_gh[t] . w_hh sums over all 3H rows, that is over all blocks: each
//     block forms the part its own rows give for every column, a thread per
//     column quad and group of 48 rows (B x 4 running sums; the two groups
//     are summed by shuffles), into one of two planes [2][B][H] of its own
//     shared memory;
//   - one cluster barrier; its arrival releases the plane, then the step's
//     d_xi and d_gh go to device memory before the wait. Two planes
//     alternate, so one barrier per step is enough.
// After step 0 the owners sum the parts of step 0 into d_h0 in the same
// launch. What bounds it (H100, 1980 MHz; each part the time its removal
// saves per step, scripts/cluster_step_costs.py): the block's 245,760 FMAs
// (about 1 us at 128 per clock; 1.3 us), the cluster barrier (0.6 us) and
// the sums of 16 remote loads per owned value (0.5 us): the latency of T
// dependent steps on 16 of the card's 132 SMs. Bytes are far below that.
//
// Grid route (gru_sequence_backward_f32), for every other shape and where no
// gates are given: the forward's partition and its slice of w_hh in shared
// memory serve both recurrent products. The gates are recomputed from h_prev
// = out[t-1] * mask[t] (h0 at t = 0) by the forward's register tiles; the
// finishing lane turns dh into d_xi and d_gh; each block writes the part of
// d_gh[t] . w_hh its rows give for every column (plus dh * z for its own
// columns) to scratch[t & 1][block][b][k], and after the grid-wide barrier
// the next step's owners sum the parts of all blocks. An ordinary launch for
// T = 1, a cooperative one for T > 1, then a small launch sums d_h0.
//
// Weight gradient (gru_weight_gradient_f32), for both routes: d_w_hh =
// sum over t, b of d_gh[t, b]^T . (h_prev * mask[t, b]) and d_b_hh = sum of
// d_gh, as 64 x 64 tiles of d_w_hh over (H / 64) x (3H / 64) blocks, each
// walking the T * B rows in passes of 16 staged in shared memory (the next
// pass's loads in flight), h_prev formed on the way. f32 FMAs: TF32 would
// break the 1e-5 tolerance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;        // batch rows of a warp's task
constexpr int kUnits = 2;       // hidden units of a warp's task
constexpr int kSums = kRows * kUnits * 3;  // running sums a lane holds
constexpr int kSharers = 32 / (kRows * kUnits);  // lanes that end with the same sums
constexpr int kBlockUnits = 4;  // a block owns a multiple of this many units
constexpr int kMaxDevices = 64;
static_assert(kRows * kUnits * kSharers == 32 && kBlockUnits % kUnits == 0, "rows x units divides a warp");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Sums v[0..kCount) over the 32 lanes by recursive halving: while kCount is
// even, the lanes whose `kOffset` bit is set keep the upper half of the sums,
// the others the lower, and each adds what its partner (lane ^ kOffset) held
// of the half it keeps; the odd rest is summed by plain exchanges. kSums sums
// cost about kSums shuffles in place of kSums x 5. With v laid out
// [row][unit][gate], lane l ends with the three gates of row
// l / (kUnits * kSharers), unit (l / kSharers) % kUnits in v[0..2].
template <int kCount, int kOffset>
__device__ __forceinline__ void reduce_over_lanes(float (&v)[kSums], int lane) {
  if constexpr (kCount % 2 == 0) {
    const bool upper = lane & kOffset;
#pragma unroll
    for (int i = 0; i < kCount / 2; ++i) {
      const float send = upper ? v[i] : v[i + kCount / 2];
      const float keep = upper ? v[i + kCount / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOffset);
    }
    reduce_over_lanes<kCount / 2, kOffset / 2>(v, lane);
  } else {
#pragma unroll
    for (int offset = kOffset; offset > 0; offset >>= 1)
#pragma unroll
      for (int i = 0; i < kCount; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], offset);
  }
}

// h_prev * mask[t] for a tile of batch rows into shared memory, a warp per
// row; rows past nb are zero. h_prev is h0 at t = 0 and out[t-1] after; out
// is read past L1, since in the forward other SMs wrote it.
__device__ __forceinline__ void load_h_tile(float* h_s, const float* h0, long long h0_stride, int h0_aligned,
                                            const float* out, const float* masks, int t, int b0, int nb,
                                            int nb_padded, int B, int H, int warp, int lane) {
  const int H4 = H >> 2;
  for (int r = warp; r < nb_padded; r += kWarps) {
    const int b = b0 + r;
    float4* row = reinterpret_cast<float4*>(h_s + (size_t)r * H);
    if (r >= nb) {
      for (int k4 = lane; k4 < H4; k4 += 32) row[k4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* prev = t == 0 ? h0 + (size_t)b * h0_stride : out + ((size_t)(t - 1) * B + b) * H;
    const float m = masks[(size_t)t * B + b];
    if (t > 0 || h0_aligned) {
      const float4* prev4 = reinterpret_cast<const float4*>(prev);
      for (int k4 = lane; k4 < H4; k4 += 32) {
        float4 v = __ldcg(prev4 + k4);
        v.x *= m, v.y *= m, v.z *= m, v.w *= m;
        row[k4] = v;
      }
    } else {
      for (int k = lane; k < H; k += 32) h_s[(size_t)r * H + k] = __ldcg(prev + k) * m;
    }
  }
}

// A warp's task: the dot products of kRows rows of h_s (from row_group *
// kRows) with the three gates' rows of w_s for kUnits units (from
// unit_first), lane l taking every 32nd float4 of their length, then summed
// over the lanes: lane l ends with the three gates of row l / (kUnits *
// kSharers), unit (l / kSharers) % kUnits in acc[0..2].
__device__ __forceinline__ void warp_dot_products(const float* w_s, const float* h_s, int unit_first, int row_group,
                                                  int units_per_block, int H4, int lane, float (&acc)[kSums]) {
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + (size_t)unit_first * H4;
  const float4* h4 = reinterpret_cast<const float4*>(h_s) + (size_t)row_group * kRows * H4;
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  for (int k4 = lane; k4 < H4; k4 += 32) {
    float4 w[kUnits * 3];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int g = 0; g < 3; ++g) w[u * 3 + g] = w4[(size_t)(g * units_per_block + u) * H4 + k4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 hv = h4[i * H4 + k4];
#pragma unroll
      for (int c = 0; c < kUnits * 3; ++c) acc[i * kUnits * 3 + c] = dot4(w[c], hv, acc[i * kUnits * 3 + c]);
    }
  }
  reduce_over_lanes<kSums, 16>(acc, lane);
}

// Thread 0 starts the bulk copies of the block's slice of w_hh (three runs of
// my_units rows) into w_s; every thread waits on w_arrived before reading it.
__device__ __forceinline__ void start_w_copies(uint64_t* w_arrived, float* w_s, const float* w_hh, int unit0,
                                               int my_units, int units_per_block, int H) {
  const uint32_t bytes = (uint32_t)(my_units * H * (int)sizeof(float));
  async_copy::barrier_init(w_arrived, 1);
  async_copy::barrier_expect(w_arrived, 3 * bytes);
  for (int g = 0; g < 3; ++g)
    async_copy::bulk_copy(w_s + (size_t)g * units_per_block * H, w_hh + ((size_t)g * H + unit0) * H, bytes, w_arrived);
}

// Dynamic shared memory: [0, 16) the barrier; w_hh's slice
// [3][units_per_block][H]; h [batch_tile][H], batch_tile a multiple of kRows.
// kSteps: T > 1, launched cooperatively. kReserve: also store r, z, n and
// hh_n of every step into reserve [T, B, 4H] for the backward. h0_aligned:
// h0's rows can be read as float4 (out's always can: H is a multiple of 4).
template <bool kSteps, bool kReserve>
__global__ void __launch_bounds__(kThreads) gru_sequence_kernel(
    const float* __restrict__ xi, const float* __restrict__ masks, const float* __restrict__ h0,
    long long h0_stride, int h0_aligned, const float* __restrict__ w_hh, const float* __restrict__ b_hh,
    float* out, float* __restrict__ reserve, int T, int B, int H, int units_per_block, int batch_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* w_arrived = reinterpret_cast<uint64_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + 16);
  float* h_s = w_s + (size_t)3 * units_per_block * H;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H4 = H >> 2;
  const int unit0 = blockIdx.x * units_per_block;
  const int my_units = min(units_per_block, H - unit0);

  if (tid == 0) start_w_copies(w_arrived, w_s, w_hh, unit0, my_units, units_per_block, H);
  bool w_ready = false;

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += batch_tile) {
      const int nb = min(batch_tile, B - b0);
      const int nb_padded = (nb + kRows - 1) / kRows * kRows;
      load_h_tile(h_s, h0, h0_stride, h0_aligned, out, masks, t, b0, nb, nb_padded, B, H, warp, lane);
      __syncthreads();  // also orders the barrier's initialisation before the wait
      if (!w_ready) {
        async_copy::barrier_wait(w_arrived, 0);
        w_ready = true;
      }

      const int unit_sets = my_units / kUnits;
      const int tasks = nb_padded / kRows * unit_sets;
      for (int task = warp; task < tasks; task += kWarps) {
        const int row_group = task / unit_sets;
        const int unit_first = (task - row_group * unit_sets) * kUnits;  // within the block
        // the first lane of those that end with a row's and unit's sums
        // finishes them: its inputs are asked for now, so their latency hides
        // behind the dot products
        const int r = row_group * kRows + lane / (kUnits * kSharers);
        const int unit = unit_first + lane / kSharers % kUnits;
        const bool finishes = lane % kSharers == 0 && r < nb;
        const int b = b0 + r, j = unit0 + unit;
        float x_r = 0.0f, x_z = 0.0f, x_n = 0.0f, b_r = 0.0f, b_z = 0.0f, b_n = 0.0f;
        if (finishes) {
          const float* x = xi + ((size_t)t * B + b) * 3 * H;
          x_r = __ldg(x + j), x_z = __ldg(x + H + j), x_n = __ldg(x + 2 * H + j);
          b_r = __ldg(b_hh + j), b_z = __ldg(b_hh + H + j), b_n = __ldg(b_hh + 2 * H + j);
        }

        float acc[kSums];  // [row][unit][gate]
        warp_dot_products(w_s, h_s, unit_first, row_group, units_per_block, H4, lane, acc);
        if (finishes) {
          const float hh_n = acc[2] + b_n;
          const float gate_r = sigmoid(x_r + (acc[0] + b_r));
          const float gate_z = sigmoid(x_z + (acc[1] + b_z));
          const float n = tanhf(x_n + gate_r * hh_n);
          out[((size_t)t * B + b) * H + j] = (1.0f - gate_z) * n + gate_z * h_s[(size_t)r * H + j];
          if constexpr (kReserve) {
            float* saved = reserve + ((size_t)t * B + b) * 4 * H + j;
            saved[0] = gate_r, saved[H] = gate_z, saved[2 * H] = n, saved[3 * H] = hh_n;
          }
        }
      }
      __syncthreads();  // h_s is overwritten by the next tile or step
    }
    if constexpr (kSteps) {
      if (t + 1 < T) cg::this_grid().sync();  // out[t] is complete and visible
    }
  }
}

__global__ void empty_kernel() {}

// The current device, its SM count and the most dynamic shared memory a block
// may ask for; the two attributes are asked once per device.
cudaError_t device_limits(int* device, int* sm_count, int* smem_limit) {
  static int sms[kMaxDevices], smem[kMaxDevices];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem[*device] == 0) {
    err = cudaDeviceGetAttribute(&sms[*device], cudaDevAttrMultiProcessorCount, *device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&smem[*device], cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
    if (err != cudaSuccess) return err;
  }
  *sm_count = sms[*device], *smem_limit = smem[*device];
  return cudaSuccess;
}

template <bool kSteps, bool kReserve>
int launch(const float* xi, const float* masks, const float* h0, long long h0_stride,
           const float* w_hh, const float* b_hh, float* out, float* reserve, int T, int B, int H,
           cudaStream_t stream) {
  auto kernel = gru_sequence_kernel<kSteps, kReserve>;
  static int configured[kMaxDevices];  // dynamic shared memory granted so far, per device
  int device = 0, sm_count = 0, smem_limit = 0;
  cudaError_t err = device_limits(&device, &sm_count, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  int h0_aligned = reinterpret_cast<uintptr_t>(h0) % 16 == 0 && h0_stride % 4 == 0;

  // T = 1 takes the smallest slice (most blocks). T > 1 must have every block
  // resident at once for the grid barrier, so a block takes more units until
  // the occupancy the runtime reports covers the grid.
  const long long row_bytes = (long long)H * sizeof(float);
  for (int units_per_block = kBlockUnits; units_per_block <= H; units_per_block += kBlockUnits) {
    const long long w_bytes = 3LL * units_per_block * row_bytes;
    const long long room = (long long)smem_limit - 16 - w_bytes;
    long long batch_tile = room / row_bytes / kRows * kRows;
    if (batch_tile < kRows) break;  // H too large for shared memory
    if (batch_tile > B) batch_tile = (B + kRows - 1) / kRows * kRows;
    const int smem_bytes = (int)(16 + w_bytes + batch_tile * row_bytes);
    const int blocks = (H + units_per_block - 1) / units_per_block;
    if (smem_bytes > 48 * 1024 && smem_bytes > configured[device]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      configured[device] = smem_bytes;
    }
    int tile = (int)batch_tile;
    if constexpr (!kSteps) {
      kernel<<<blocks, kThreads, smem_bytes, stream>>>(xi, masks, h0, h0_stride, h0_aligned, w_hh, b_hh, out,
                                                      reserve, T, B, H, units_per_block, tile);
      return (int)cudaGetLastError();
    } else {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      if (per_sm * sm_count < blocks) continue;
      void* args[] = {&xi, &masks, &h0, &h0_stride, &h0_aligned, &w_hh, &b_hh, &out, &reserve,
                      &T,  &B,     &H,  &units_per_block, &tile};
      return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads),
                                              args, smem_bytes, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBackwardRowFloats = 5;  // per batch row and owned unit: d_gh (3), dh, dh * z

// Dynamic shared memory: the forward's (barrier, w_hh's slice, h_prev's
// tile), then per batch row of the tile d_gh [3][units_per_block], dh
// [units_per_block] and dh * z [units_per_block] of the block's own units.
// scratch [2][gridDim.x][B][H]: every block's part of dh_prev, two planes.
template <bool kSteps>
__global__ void __launch_bounds__(kThreads) gru_sequence_backward_kernel(
    const float* __restrict__ d_out, const float* __restrict__ xi, const float* __restrict__ masks,
    const float* __restrict__ h0, long long h0_stride, int h0_aligned, const float* __restrict__ w_hh,
    const float* __restrict__ b_hh, const float* __restrict__ out, float* __restrict__ d_xi,
    float* __restrict__ d_gh, float* scratch, int T, int B, int H, int units_per_block, int batch_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* w_arrived = reinterpret_cast<uint64_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + 16);
  float* h_s = w_s + (size_t)3 * units_per_block * H;
  float* dgh_s = h_s + (size_t)batch_tile * H;
  float* dh_s = dgh_s + (size_t)batch_tile * 3 * units_per_block;
  float* dhz_s = dh_s + (size_t)batch_tile * units_per_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H4 = H >> 2;
  const int unit0 = blockIdx.x * units_per_block;
  const int my_units = min(units_per_block, H - unit0);
  const int blocks = gridDim.x;
  const size_t plane = (size_t)blocks * B * H;

  if (tid == 0) start_w_copies(w_arrived, w_s, w_hh, unit0, my_units, units_per_block, H);
  bool w_ready = false;

  for (int t = T - 1; t >= 0; --t) {
    float* mine = scratch + (size_t)(t & 1) * plane + (size_t)blockIdx.x * B * H;
    const float* parts = scratch + (size_t)((t + 1) & 1) * plane;  // of step t + 1, all blocks
    for (int b0 = 0; b0 < B; b0 += batch_tile) {
      const int nb = min(batch_tile, B - b0);
      const int nb_padded = (nb + kRows - 1) / kRows * kRows;
      load_h_tile(h_s, h0, h0_stride, h0_aligned, out, masks, t, b0, nb, nb_padded, B, H, warp, lane);

      // dh[b, j] of the block's own units, a warp per value: the parts that
      // all blocks wrote at step t + 1 (past L1), times mask[t + 1], plus
      // d_out[t]
      for (int v = warp; v < nb * my_units; v += kWarps) {
        const int r = v / my_units, u = v - r * my_units;
        const int b = b0 + r, j = unit0 + u;
        float sum = 0.0f;
        if (t + 1 < T) {
          for (int blk = lane; blk < blocks; blk += 32) sum += __ldcg(parts + ((size_t)blk * B + b) * H + j);
#pragma unroll
          for (int offset = 16; offset > 0; offset >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, offset);
          sum *= masks[(size_t)(t + 1) * B + b];
        }
        if (lane == 0) dh_s[r * units_per_block + u] = sum + d_out[((size_t)t * B + b) * H + j];
      }
      __syncthreads();  // also orders the barrier's initialisation before the wait
      if (!w_ready) {
        async_copy::barrier_wait(w_arrived, 0);
        w_ready = true;
      }

      // the forward's tasks recompute the gates; the finishing lane goes on
      // to the gradients of its row and unit
      const int unit_sets = my_units / kUnits;
      const int tasks = nb_padded / kRows * unit_sets;
      for (int task = warp; task < tasks; task += kWarps) {
        const int row_group = task / unit_sets;
        const int unit_first = (task - row_group * unit_sets) * kUnits;
        const int r = row_group * kRows + lane / (kUnits * kSharers);
        const int unit = unit_first + lane / kSharers % kUnits;
        const bool finishes = lane % kSharers == 0 && r < nb;
        const int b = b0 + r, j = unit0 + unit;
        float x_r = 0.0f, x_z = 0.0f, x_n = 0.0f, b_r = 0.0f, b_z = 0.0f, b_n = 0.0f;
        if (finishes) {
          const float* x = xi + ((size_t)t * B + b) * 3 * H;
          x_r = __ldg(x + j), x_z = __ldg(x + H + j), x_n = __ldg(x + 2 * H + j);
          b_r = __ldg(b_hh + j), b_z = __ldg(b_hh + H + j), b_n = __ldg(b_hh + 2 * H + j);
        }

        float acc[kSums];  // [row][unit][gate]
        warp_dot_products(w_s, h_s, unit_first, row_group, units_per_block, H4, lane, acc);
        if (finishes) {
          const float hh_n = acc[2] + b_n;
          const float gate_r = sigmoid(x_r + (acc[0] + b_r));
          const float gate_z = sigmoid(x_z + (acc[1] + b_z));
          const float n = tanhf(x_n + gate_r * hh_n);
          const float h_prev = h_s[(size_t)r * H + j];
          const float dh = dh_s[r * units_per_block + unit];
          const float da_n = dh * (1.0f - gate_z) * (1.0f - n * n);
          const float da_r = da_n * hh_n * gate_r * (1.0f - gate_r);
          const float da_z = dh * (h_prev - n) * gate_z * (1.0f - gate_z);
          const size_t at = ((size_t)t * B + b) * 3 * H + j;
          d_xi[at] = da_r, d_xi[at + H] = da_z, d_xi[at + 2 * H] = da_n;
          d_gh[at] = da_r, d_gh[at + H] = da_z, d_gh[at + 2 * H] = da_n * gate_r;
          float* row = dgh_s + (size_t)r * 3 * units_per_block;
          row[unit] = da_r, row[units_per_block + unit] = da_z, row[2 * units_per_block + unit] = da_n * gate_r;
          dhz_s[r * units_per_block + unit] = dh * gate_z;
        }
      }
      __syncthreads();

      // the block's part of dh_prev = dh * z + d_gh . w_hh: thread k sums its
      // column over the block's rows of w_hh, kRows batch rows at a time
      for (int k = tid; k < H; k += kThreads) {
        const bool own = k >= unit0 && k < unit0 + my_units;
        for (int r0 = 0; r0 < nb; r0 += kRows) {
          float part[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) part[i] = 0.0f;
          for (int g = 0; g < 3; ++g)
            for (int u = 0; u < my_units; ++u) {
              const int row = g * units_per_block + u;
              const float w = w_s[(size_t)row * H + k];
#pragma unroll
              for (int i = 0; i < kRows; ++i)
                part[i] = fmaf(dgh_s[(size_t)(r0 + i) * 3 * units_per_block + row], w, part[i]);
            }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (r0 + i >= nb) break;  // rows past nb hold nothing
            if (own) part[i] += dhz_s[(r0 + i) * units_per_block + (k - unit0)];
            mine[(size_t)(b0 + r0 + i) * H + k] = part[i];
          }
        }
      }
      __syncthreads();  // the tile's shared memory is overwritten by the next tile or step
    }
    if constexpr (kSteps) {
      if (t > 0) cg::this_grid().sync();  // every block's part of step t is complete and visible
    }
  }
}

// d_h0[b, k] = mask[0, b] * the sum over the blocks of their parts of step 0
// (plane 0 of scratch).
__global__ void gru_sequence_backward_h0_kernel(const float* __restrict__ scratch, const float* __restrict__ masks,
                                                float* __restrict__ d_h0, int blocks, int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // b * H + k
  if (i >= B * H) return;
  float sum = 0.0f;
  for (int blk = 0; blk < blocks; ++blk) sum += scratch[(size_t)blk * B * H + i];
  d_h0[i] = sum * masks[i / H];
}

template <bool kSteps>
int launch_backward(const float* d_out, const float* xi, const float* masks, const float* h0, long long h0_stride,
                    const float* w_hh, const float* b_hh, const float* out, float* d_xi, float* d_h0, float* d_gh,
                    float* scratch, int T, int B, int H, cudaStream_t stream) {
  auto kernel = gru_sequence_backward_kernel<kSteps>;
  static int configured[kMaxDevices];  // dynamic shared memory granted so far, per device
  int device = 0, sm_count = 0, smem_limit = 0;
  cudaError_t err = device_limits(&device, &sm_count, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  int h0_aligned = reinterpret_cast<uintptr_t>(h0) % 16 == 0 && h0_stride % 4 == 0;

  // as the forward's launcher, with kBackwardRowFloats more floats per batch
  // row and owned unit
  const long long row_bytes = (long long)H * sizeof(float);
  for (int units_per_block = kBlockUnits; units_per_block <= H; units_per_block += kBlockUnits) {
    const long long w_bytes = 3LL * units_per_block * row_bytes;
    const long long tile_row_bytes = row_bytes + (long long)kBackwardRowFloats * units_per_block * sizeof(float);
    const long long room = (long long)smem_limit - 16 - w_bytes;
    long long batch_tile = room / tile_row_bytes / kRows * kRows;
    if (batch_tile < kRows) break;  // H too large for shared memory
    if (batch_tile > B) batch_tile = (B + kRows - 1) / kRows * kRows;
    const int smem_bytes = (int)(16 + w_bytes + batch_tile * tile_row_bytes);
    int blocks = (H + units_per_block - 1) / units_per_block;
    if (smem_bytes > 48 * 1024 && smem_bytes > configured[device]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      configured[device] = smem_bytes;
    }
    int tile = (int)batch_tile;
    if constexpr (!kSteps) {
      kernel<<<blocks, kThreads, smem_bytes, stream>>>(d_out, xi, masks, h0, h0_stride, h0_aligned, w_hh, b_hh, out,
                                                      d_xi, d_gh, scratch, T, B, H, units_per_block, tile);
      err = cudaGetLastError();
    } else {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      if (per_sm * sm_count < blocks) continue;
      void* args[] = {&d_out, &xi,  &masks, &h0,   &h0_stride, &h0_aligned, &w_hh, &b_hh, &out,
                      &d_xi,  &d_gh, &scratch, &T, &B,         &H,          &units_per_block, &tile};
      err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads), args,
                                        smem_bytes, stream);
    }
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    gru_sequence_backward_h0_kernel<<<(B * H + threads - 1) / threads, threads, 0, stream>>>(scratch, masks, d_h0,
                                                                                           blocks, B, H);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward, cluster route: one thread-block cluster, w_hh in distributed
// shared memory, gates read from the training forward's reserve
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 16;  // the most a launch may ask for with the non-portable attribute
constexpr int kClusterRows = 8;  // the most batch rows the route takes (its register tile)
constexpr int kPairSlots = 2;    // (row, unit) pairs a thread owns, at most
constexpr int kGroupRows = 48;   // rows of w_hh that a thread of the product walks (3 * units / groups)

// The two halves of a cluster barrier: arrive (release: this thread's earlier
// writes become visible to the cluster) and wait (acquire: for all threads of
// all blocks to arrive). Every thread of the block calls both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// What a cluster of `cluster` blocks needs at B rows: each block owns
// `units` = H / cluster hidden units (3 * units rows of w_hh); the product's
// threads own a column quad and one of `groups` row groups.
struct ClusterShape {
  int units, groups, smem_bytes;
};

// False where the route does not take (B, H, cluster): the shape rules of the
// product and the pairs, or more shared memory than a block may have.
bool cluster_shape(int B, int H, int cluster, int smem_limit, ClusterShape* shape) {
  const int quads = H / 4;
  if (B < 1 || B > kClusterRows || H % 4 || quads < 8 || quads > kClusterThreads || (quads & (quads - 1)))
    return false;
  if (cluster < 1 || cluster > kMaxCluster || H % cluster) return false;
  const int units = H / cluster, groups = min(4, kClusterThreads / quads);
  if (3 * units != kGroupRows * groups || B * units > kPairSlots * kClusterThreads) return false;
  const long long bytes = 16 + 4LL * (3LL * units * H + 2LL * B * H + 3LL * B * units);
  if (bytes > smem_limit) return false;
  *shape = {units, groups, (int)bytes};
  return true;
}

// Dynamic shared memory: [0, 16) the barrier; w_hh's slice [3][units][H];
// two planes [2][kB][H] of the block's part of dh_prev for every column;
// d_gh of the step for the block's rows [kB][3 * units].
// Thread v (and v + kClusterThreads) owns the pair (row b, unit j) = v /
// units, unit0 + v % units: it turns dh into d_xi, d_gh and dh * z, and sums
// the cluster's parts of its column. The product's threads: lane l of warp w
// takes column quad w * (32 / groups) + l % (32 / groups) over row group
// l / (32 / groups); the groups are summed by shuffles.
template <int kB>
__global__ void __launch_bounds__(kClusterThreads) gru_sequence_backward_cluster_kernel(
    const float* __restrict__ d_out, const float* __restrict__ gates, const float* __restrict__ masks,
    const float* __restrict__ h0, long long h0_stride, const float* __restrict__ w_hh,
    const float* __restrict__ out, float* __restrict__ d_xi, float* __restrict__ d_gh, float* __restrict__ d_h0,
    int T, int H, int units, int groups) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* w_arrived = reinterpret_cast<uint64_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + 16);
  float* planes = w_s + (size_t)3 * units * H;
  float* dgh_s = planes + (size_t)2 * kB * H;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit0 = rank * units, rows = 3 * units, pairs = kB * units;
  if (tid == 0) start_w_copies(w_arrived, w_s, w_hh, unit0, units, units, H);

  // the pairs' inputs of a step, asked for one step ahead: r, z, n, hh_n,
  // h_prev * mask, d_out and the mask; then dh * z and the mask of step t + 1,
  // and the step's gradients, stored once the block has arrived at the barrier
  float r[kPairSlots], z[kPairSlots], n[kPairSlots], hh_n[kPairSlots], h_prev[kPairSlots], g_out[kPairSlots];
  float m[kPairSlots], dhz[kPairSlots] = {}, m_next[kPairSlots] = {};
  float da_r[kPairSlots], da_z[kPairSlots], da_n[kPairSlots], dgh_n[kPairSlots];
  auto fetch = [&](int t) {
#pragma unroll
    for (int s = 0; s < kPairSlots; ++s) {
      const int v = tid + s * kClusterThreads;
      if (v >= pairs) break;
      const int b = v / units, j = unit0 + v % units;
      const float* g = gates + ((size_t)t * kB + b) * 4 * H + j;
      r[s] = __ldg(g), z[s] = __ldg(g + H), n[s] = __ldg(g + 2 * H), hh_n[s] = __ldg(g + 3 * H);
      m[s] = __ldg(masks + (size_t)t * kB + b);
      h_prev[s] = (t == 0 ? __ldg(h0 + (size_t)b * h0_stride + j) : __ldg(out + ((size_t)(t - 1) * kB + b) * H + j)) * m[s];
      g_out[s] = __ldg(d_out + ((size_t)t * kB + b) * H + j);
    }
  };
  // the sum over the cluster's blocks of their parts of column j, row b, in
  // plane p: one load from each block's shared memory, all in flight at once
  auto cluster_sum = [&](int p, int b, int j) {
    float part[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < blocks) part[c] = cluster.map_shared_rank(planes, c)[((size_t)p * kB + b) * H + j];
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < blocks) sum += part[c];
    return sum;
  };

  fetch(T - 1);
  const int quads = H / 4, per_warp = 32 / groups;
  const int quad = warp * per_warp + lane % per_warp, group = lane / per_warp;
  const int first = group * kGroupRows;
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + quad;  // rows H / 4 float4 apart
  for (int t = T - 1; t >= 0; --t) {
    // dh of the owned pairs, then the gradients of their gates
#pragma unroll
    for (int s = 0; s < kPairSlots; ++s) {
      const int v = tid + s * kClusterThreads;
      if (v >= pairs) break;
      const int b = v / units, u = v % units, j = unit0 + u;
      float dh = g_out[s];
      if (t + 1 < T) dh += m_next[s] * (dhz[s] + cluster_sum((t + 1) & 1, b, j));
      da_n[s] = dh * (1.0f - z[s]) * (1.0f - n[s] * n[s]);
      da_r[s] = da_n[s] * hh_n[s] * r[s] * (1.0f - r[s]);
      da_z[s] = dh * (h_prev[s] - n[s]) * z[s] * (1.0f - z[s]);
      float* row = dgh_s + (size_t)b * rows;
      dgh_n[s] = da_n[s] * r[s];
      row[u] = da_r[s], row[units + u] = da_z[s], row[2 * units + u] = dgh_n[s];
      dhz[s] = dh * z[s], m_next[s] = m[s];
    }
    __syncthreads();  // d_gh of the step is in shared memory; also orders the barrier's initialisation
    if (t == T - 1) async_copy::barrier_wait(w_arrived, 0);
    if (t > 0) fetch(t - 1);  // its latency hides behind the product

    // the block's part of d_gh . w_hh for every column, into plane t & 1
    if (quad < quads) {
      float acc[kB][4];
#pragma unroll
      for (int b = 0; b < kB; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.0f;
#pragma unroll
      for (int row = 0; row < kGroupRows; row += 4) {
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = w4[(size_t)(first + row + i) * quads];
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const float4 d = *reinterpret_cast<const float4*>(dgh_s + (size_t)b * rows + first + row);
          const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[b][0] = fmaf(dv[i], w[i].x, acc[b][0]);
            acc[b][1] = fmaf(dv[i], w[i].y, acc[b][1]);
            acc[b][2] = fmaf(dv[i], w[i].z, acc[b][2]);
            acc[b][3] = fmaf(dv[i], w[i].w, acc[b][3]);
          }
        }
      }
      for (int offset = per_warp; offset < 32; offset <<= 1)
#pragma unroll
        for (int b = 0; b < kB; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[b][c] += __shfl_xor_sync(0xffffffffu, acc[b][c], offset);
      if (group == 0) {
        float4* plane = reinterpret_cast<float4*>(planes + (size_t)(t & 1) * kB * H) + quad;
#pragma unroll
        for (int b = 0; b < kB; ++b) plane[(size_t)b * quads] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      }
    }
    // every block's part of step t is complete and visible to the cluster
    // once all have arrived; the arrival orders what came before it, so the
    // step's stores to device memory go after it
    cluster_arrive();
#pragma unroll
    for (int s = 0; s < kPairSlots; ++s) {
      const int v = tid + s * kClusterThreads;
      if (v >= pairs) break;
      const int b = v / units, j = unit0 + v % units;
      const size_t at = ((size_t)t * kB + b) * 3 * H + j;
      d_xi[at] = da_r[s], d_xi[at + H] = da_z[s], d_xi[at + 2 * H] = da_n[s];
      d_gh[at] = da_r[s], d_gh[at + H] = da_z[s], d_gh[at + 2 * H] = dgh_n[s];
    }
    cluster_wait();
  }

  // d_h0 from the parts of step 0, then a last barrier: no block may leave
  // while another still reads its shared memory
#pragma unroll
  for (int s = 0; s < kPairSlots; ++s) {
    const int v = tid + s * kClusterThreads;
    if (v >= pairs) break;
    const int b = v / units, j = unit0 + v % units;
    d_h0[(size_t)b * H + j] = m_next[s] * (dhz[s] + cluster_sum(0, b, j));
  }
  cluster.sync();
}

using ClusterKernel = void (*)(const float*, const float*, const float*, const float*, long long, const float*,
                               const float*, float*, float*, float*, int, int, int, int);

ClusterKernel cluster_kernel(int B) {
  switch (B) {
    case 1: return gru_sequence_backward_cluster_kernel<1>;
    case 2: return gru_sequence_backward_cluster_kernel<2>;
    case 3: return gru_sequence_backward_cluster_kernel<3>;
    case 4: return gru_sequence_backward_cluster_kernel<4>;
    case 5: return gru_sequence_backward_cluster_kernel<5>;
    case 6: return gru_sequence_backward_cluster_kernel<6>;
    case 7: return gru_sequence_backward_cluster_kernel<7>;
    case 8: return gru_sequence_backward_cluster_kernel<8>;
    default: return nullptr;
  }
}

// The launch configuration of a cluster of `cluster` blocks; attrs must
// outlive it.
cudaLaunchConfig_t cluster_config(int cluster, int smem_bytes, cudaStream_t stream, cudaLaunchAttribute* attrs) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster, attrs[0].val.clusterDim.y = 1, attrs[0].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = 1;
  return config;
}

// Grants the kernel of B rows its shared memory and, above 8 blocks, the
// non-portable cluster size (once per device and size).
cudaError_t configure_cluster_kernel(ClusterKernel kernel, int B, int cluster, int smem_bytes, int device) {
  static int granted[kMaxDevices][kClusterRows + 1], non_portable[kMaxDevices][kClusterRows + 1];
  if (smem_bytes > granted[device][B]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    granted[device][B] = smem_bytes;
  }
  if (cluster > 8 && !non_portable[device][B]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable[device][B] = 1;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// the weight gradient: d_w_hh = sum over T * B rows of d_gh^T . h_prev, and
// d_b_hh = the sum of d_gh
// ---------------------------------------------------------------------------

constexpr int kWgTile = 64;     // a block's tile of d_w_hh: 64 rows x 64 columns
constexpr int kWgDepth = 16;    // rows of d_gh and h_prev staged per pass
constexpr int kWgThreads = 256;  // a 16 x 16 grid of threads, 4 x 4 outputs each

// Block (x, y) owns d_w_hh[64 y .. 64 y + 63][64 x .. 64 x + 63] and walks
// the T * B rows in passes of 16: d_gh's rows [16][64] and h_prev's [16][64]
// (h_prev formed on the way: h0 or out[t - 1], times mask[t]) come into
// shared memory, and thread (ty, tx) adds the outer product of a_s[.][4 ty
// ..] and h_s[.][4 tx ..]. The blocks of column tile 0 also sum d_b_hh.
__global__ void __launch_bounds__(kWgThreads) gru_weight_gradient_kernel(
    const float* __restrict__ d_gh, const float* __restrict__ masks, const float* __restrict__ h0,
    long long h0_stride, int h0_aligned, const float* __restrict__ out, float* __restrict__ d_w_hh,
    float* __restrict__ d_b_hh, int T, int B, int H) {
  __shared__ __align__(16) float a_s[kWgDepth][kWgTile];
  __shared__ __align__(16) float h_s[kWgDepth][kWgTile];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kWgTile, k0 = blockIdx.x * kWgTile;
  const int rows = T * B, threeH = 3 * H;
  const bool bias = blockIdx.x == 0 && tid < kWgTile;
  float acc[4][4] = {};
  float bias_sum = 0.0f;
  // this thread's share of a pass's loads, one float4 of each tile, asked
  // for a pass ahead so that their latency hides behind the outer products
  const int load_row = tid / 16, load_col = 4 * (tid % 16);
  float4 a, h;
  auto fetch = [&](int m0) {
    const int m = m0 + load_row;
    a = h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m < rows && i0 + load_col < threeH) a = __ldg(reinterpret_cast<const float4*>(d_gh + (size_t)m * threeH + i0 + load_col));
    const int k = k0 + load_col;
    if (m < rows && k < H) {
      const int t = m / B, b = m - t * B;
      const float mask = __ldg(masks + m);
      if (t > 0) {
        h = __ldg(reinterpret_cast<const float4*>(out + (size_t)(m - B) * H + k));
      } else if (h0_aligned) {
        h = __ldg(reinterpret_cast<const float4*>(h0 + (size_t)b * h0_stride + k));
      } else {
        const float* src = h0 + (size_t)b * h0_stride + k;
        h = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
      }
      h.x *= mask, h.y *= mask, h.z *= mask, h.w *= mask;
    }
  };
  fetch(0);
  for (int m0 = 0; m0 < rows; m0 += kWgDepth) {
    *reinterpret_cast<float4*>(&a_s[load_row][load_col]) = a;
    *reinterpret_cast<float4*>(&h_s[load_row][load_col]) = h;
    __syncthreads();
    if (m0 + kWgDepth < rows) fetch(m0 + kWgDepth);
#pragma unroll
    for (int mm = 0; mm < kWgDepth; ++mm) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[mm][4 * ty]);
      const float4 hv = *reinterpret_cast<const float4*>(&h_s[mm][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ar[i], hr[c], acc[i][c]);
    }
    if (bias)
#pragma unroll
      for (int mm = 0; mm < kWgDepth; ++mm) bias_sum += a_s[mm][tid];
    __syncthreads();
  }
  const int k = k0 + 4 * tx;
  if (k < H)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + 4 * ty + i;
      if (row < threeH)
        *reinterpret_cast<float4*>(d_w_hh + (size_t)row * H + k) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  if (bias && i0 + tid < threeH) d_b_hh[i0 + tid] = bias_sum;
}

}  // namespace

// Pointers are device pointers to f32; the wrapper checks shapes, types,
// contiguity and alignment. h0 is [B, H] with rows h0_stride elements apart;
// the rest are contiguous. H must be a multiple of 4 and w_hh 16-byte
// aligned. reserve is null, or [T, B, 4H] for r, z, n and hh_n of every step
// (the training forward). One ordinary launch for T = 1, one cooperative
// launch for T > 1.
// Returns the launch's error code, or cudaErrorInvalidValue where the sizes
// do not fit: 16 rows of H floats must fit a block's shared memory and, for
// T > 1, the whole grid must be resident at once.
extern "C" int gru_sequence_f32(const float* xi, const float* masks, const float* h0,
                                long long h0_stride, const float* w_hh, const float* b_hh,
                                float* out, float* reserve, int T, int B, int H, cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  if (reserve)
    return T > 1 ? launch<true, true>(xi, masks, h0, h0_stride, w_hh, b_hh, out, reserve, T, B, H, stream)
                 : launch<false, true>(xi, masks, h0, h0_stride, w_hh, b_hh, out, reserve, T, B, H, stream);
  return T > 1 ? launch<true, false>(xi, masks, h0, h0_stride, w_hh, b_hh, out, nullptr, T, B, H, stream)
               : launch<false, false>(xi, masks, h0, h0_stride, w_hh, b_hh, out, nullptr, T, B, H, stream);
}

// The gradient of gru_sequence_f32 for d_out [T, B, H]: d_xi [T, B, 3H], d_h0
// [B, H] and d_gh [T, B, 3H] (the gradient of h_prev . w_hh^T + b_hh at every
// step, from which the caller sums d_w_hh and d_b_hh over all steps). `out` is
// the forward's output; scratch holds 2 * (H / 4) * B * H floats. All buffers
// are contiguous f32 but h0, as in the forward. The recurrence is one
// ordinary launch for T = 1 and one cooperative launch for T > 1, followed by
// one small ordinary launch that sums d_h0. Error codes as the forward's.
extern "C" int gru_sequence_backward_f32(const float* d_out, const float* xi, const float* masks, const float* h0,
                                         long long h0_stride, const float* w_hh, const float* b_hh,
                                         const float* out, float* d_xi, float* d_h0, float* d_gh, float* scratch,
                                         int T, int B, int H, cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  return T > 1 ? launch_backward<true>(d_out, xi, masks, h0, h0_stride, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch,
                                       T, B, H, stream)
               : launch_backward<false>(d_out, xi, masks, h0, h0_stride, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch,
                                        T, B, H, stream);
}

// The cluster route's size at B rows of H units: the smallest cluster
// (1, 2, 4, 8 or 16 blocks) whose blocks hold their slice of w_hh, the two
// planes and d_gh in shared memory and of which the card can run at least
// one at once. Sets *cluster (0 where the route does not take B and H: B
// above 8, H / 4 no power of two from 8 to 256, or no cluster fits) and
// *active_clusters (cudaOccupancyMaxActiveClusters at that size). Returns a
// CUDA error code.
extern "C" int gru_sequence_backward_cluster_plan(int B, int H, int* cluster, int* active_clusters) {
  *cluster = 0, *active_clusters = 0;
  int device = 0, sm_count = 0, smem_limit = 0;
  cudaError_t err = device_limits(&device, &sm_count, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  for (int size = 1; size <= kMaxCluster; size *= 2) {
    ClusterShape shape;
    if (!cluster_shape(B, H, size, smem_limit, &shape)) continue;
    ClusterKernel kernel = cluster_kernel(B);
    err = configure_cluster_kernel(kernel, B, size, shape.smem_bytes, device);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attrs[1];
    cudaLaunchConfig_t config = cluster_config(size, shape.smem_bytes, 0, attrs);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(kernel), &config);
    if (err != cudaSuccess) return (int)err;
    if (active < 1) continue;
    *cluster = size, *active_clusters = active;
    return cudaSuccess;
  }
  return cudaSuccess;
}

// The gradient of gru_sequence_f32 by the cluster route, for d_out [T, B,
// H] given the training forward's reserve `gates` [T, B, 4H] (r, z, n,
// hh_n): d_xi and d_gh [T, B, 3H] and d_h0 [B, H], in one launch of one
// cluster of `cluster` blocks (the size gru_sequence_backward_cluster_plan
// gave). Buffers as gru_sequence_backward_f32's; w_hh 16-byte aligned.
// Returns the launch's error code, or cudaErrorInvalidValue where the route
// does not take B, H and cluster.
extern "C" int gru_sequence_backward_cluster_f32(const float* d_out, const float* gates, const float* masks,
                                                 const float* h0, long long h0_stride, const float* w_hh,
                                                 const float* out, float* d_xi, float* d_h0, float* d_gh, int T,
                                                 int B, int H, int cluster, cudaStream_t stream) {
  int device = 0, sm_count = 0, smem_limit = 0;
  cudaError_t err = device_limits(&device, &sm_count, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  ClusterShape shape;
  if (T < 1 || !cluster_shape(B, H, cluster, smem_limit, &shape)) return (int)cudaErrorInvalidValue;
  ClusterKernel kernel = cluster_kernel(B);
  err = configure_cluster_kernel(kernel, B, cluster, shape.smem_bytes, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[1];
  cudaLaunchConfig_t config = cluster_config(cluster, shape.smem_bytes, stream, attrs);
  return (int)cudaLaunchKernelEx(&config, kernel, d_out, gates, masks, h0, h0_stride, w_hh, out, d_xi, d_gh, d_h0, T,
                                 H, shape.units, shape.groups);
}

// d_w_hh [3H, H] = the sum over t, b of d_gh[t, b]^T . (h_prev * mask[t, b])
// with h_prev = h0 at t = 0 and out[t - 1] after, and d_b_hh [3H] = the sum
// of d_gh, in one ordinary launch of (H / 64) x (3H / 64) blocks. d_gh [T,
// B, 3H], masks and out contiguous, h0 rows h0_stride apart; H a multiple of
// 4. Returns the launch's error code.
extern "C" int gru_weight_gradient_f32(const float* d_gh, const float* masks, const float* h0, long long h0_stride,
                                       const float* out, float* d_w_hh, float* d_b_hh, int T, int B, int H,
                                       cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const int h0_aligned = reinterpret_cast<uintptr_t>(h0) % 16 == 0 && h0_stride % 4 == 0;
  const dim3 grid((H + kWgTile - 1) / kWgTile, (3 * H + kWgTile - 1) / kWgTile);
  gru_weight_gradient_kernel<<<grid, kWgThreads, 0, stream>>>(d_gh, masks, h0, h0_stride, h0_aligned, out, d_w_hh,
                                                             d_b_hh, T, B, H);
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing: timed beside gru_sequence_f32, it
// is the floor under any single launch.
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
