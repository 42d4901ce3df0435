// Masked GRU over a whole sequence, forward only, f32 in and out.
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

// Dynamic shared memory: [0, 16) the barrier; w_hh's slice
// [3][units_per_block][H]; h [batch_tile][H], batch_tile a multiple of kRows.
// kSteps: T > 1, launched cooperatively. h0_aligned: h0's rows can be read as
// float4 (out's always can: H is a multiple of 4).
template <bool kSteps>
__global__ void __launch_bounds__(kThreads) gru_sequence_kernel(
    const float* __restrict__ xi, const float* __restrict__ masks, const float* __restrict__ h0,
    long long h0_stride, int h0_aligned, const float* __restrict__ w_hh, const float* __restrict__ b_hh,
    float* out, int T, int B, int H, int units_per_block, int batch_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* w_arrived = reinterpret_cast<uint64_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + 16);
  float* h_s = w_s + (size_t)3 * units_per_block * H;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H4 = H >> 2;
  const int unit0 = blockIdx.x * units_per_block;
  const int my_units = min(units_per_block, H - unit0);

  if (tid == 0) {
    const uint32_t bytes = (uint32_t)(my_units * H * (int)sizeof(float));
    async_copy::barrier_init(w_arrived, 1);
    async_copy::barrier_expect(w_arrived, 3 * bytes);
    for (int g = 0; g < 3; ++g)
      async_copy::bulk_copy(w_s + (size_t)g * units_per_block * H, w_hh + ((size_t)g * H + unit0) * H, bytes, w_arrived);
  }
  bool w_ready = false;

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += batch_tile) {
      const int nb = min(batch_tile, B - b0);
      const int nb_padded = (nb + kRows - 1) / kRows * kRows;
      // h * mask[t] for this tile of batch rows; rows past B are zero
      for (int r = warp; r < nb_padded; r += kWarps) {
        const int b = b0 + r;
        float4* row = reinterpret_cast<float4*>(h_s + (size_t)r * H);
        if (r >= nb) {
          for (int k4 = lane; k4 < H4; k4 += 32) row[k4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          continue;
        }
        // out[t-1] was written by other SMs: read it past L1
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

        // lane l takes every 32nd float4 of the dot products' length
        const float4* w4 = reinterpret_cast<const float4*>(w_s) + (size_t)unit_first * H4;
        const float4* h4 = reinterpret_cast<const float4*>(h_s) + (size_t)row_group * kRows * H4;
        float acc[kSums];  // [row][unit][gate]
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
        if (finishes) {
          const float gate_r = sigmoid(x_r + (acc[0] + b_r));
          const float gate_z = sigmoid(x_z + (acc[1] + b_z));
          const float n = tanhf(x_n + gate_r * (acc[2] + b_n));
          out[((size_t)t * B + b) * H + j] = (1.0f - gate_z) * n + gate_z * h_s[(size_t)r * H + j];
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

template <bool kSteps>
int launch(const float* xi, const float* masks, const float* h0, long long h0_stride,
           const float* w_hh, const float* b_hh, float* out, int T, int B, int H,
           cudaStream_t stream) {
  auto kernel = gru_sequence_kernel<kSteps>;
  static int configured[kMaxDevices];  // dynamic shared memory granted so far, per device
  static int sm_count[kMaxDevices], smem_limit[kMaxDevices];  // asked once per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_limit[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&smem_limit[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
  }
  int h0_aligned = reinterpret_cast<uintptr_t>(h0) % 16 == 0 && h0_stride % 4 == 0;

  // T = 1 takes the smallest slice (most blocks). T > 1 must have every block
  // resident at once for the grid barrier, so a block takes more units until
  // the occupancy the runtime reports covers the grid.
  const long long row_bytes = (long long)H * sizeof(float);
  for (int units_per_block = kBlockUnits; units_per_block <= H; units_per_block += kBlockUnits) {
    const long long w_bytes = 3LL * units_per_block * row_bytes;
    const long long room = (long long)smem_limit[device] - 16 - w_bytes;
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
      kernel<<<blocks, kThreads, smem_bytes, stream>>>(xi, masks, h0, h0_stride, h0_aligned, w_hh, b_hh, out, T,
                                                      B, H, units_per_block, tile);
      return (int)cudaGetLastError();
    } else {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      if (per_sm * sm_count[device] < blocks) continue;
      void* args[] = {&xi, &masks, &h0, &h0_stride, &h0_aligned, &w_hh, &b_hh, &out,
                      &T,  &B,     &H,  &units_per_block, &tile};
      return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads),
                                              args, smem_bytes, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Pointers are device pointers to f32; the wrapper checks shapes, types,
// contiguity and alignment. h0 is [B, H] with rows h0_stride elements apart;
// the rest are contiguous. H must be a multiple of 4 and w_hh 16-byte
// aligned. One ordinary launch for T = 1, one cooperative launch for T > 1.
// Returns the launch's error code, or cudaErrorInvalidValue where the sizes
// do not fit: 16 rows of H floats must fit a block's shared memory and, for
// T > 1, the whole grid must be resident at once.
extern "C" int gru_sequence_f32(const float* xi, const float* masks, const float* h0,
                                long long h0_stride, const float* w_hh, const float* b_hh,
                                float* out, int T, int B, int H, cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  return T > 1 ? launch<true>(xi, masks, h0, h0_stride, w_hh, b_hh, out, T, B, H, stream)
               : launch<false>(xi, masks, h0, h0_stride, w_hh, b_hh, out, T, B, H, stream);
}

// One launch of a kernel that does nothing: timed beside gru_sequence_f32, it
// is the floor under any single launch.
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
