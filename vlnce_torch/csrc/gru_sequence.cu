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
// Design. The TPU version walks T as a sequential grid and carries h in VMEM
// scratch from one grid step to the next. Blocks on the GPU run in no order,
// so here the T loop runs inside the block and the kernel is launched once
// for any T. Batch rows are independent: block b owns row b for all T steps,
// keeps h and hh in shared memory (4H floats) and needs no grid-wide sync.
// Each of the block's 32 warps computes whole rows of h . w_hh^T with float4
// loads (the k loop unrolled so each lane has several loads in flight) and a
// shuffle reduction; w_hh (3 MB in f32 at H=512) is read from global memory
// and stays resident in the 50 MB L2 across blocks and steps.
//
// Bound at the act shape (T=1, B=32, H=512): the bytes the function must
// move are w_hh once (3.1 MB) plus xi, h0, masks and out (about 0.3 MB),
// about 3.5 MB, or about 1 us at 3.35 TB/s; its 0.05 GFLOP in f32 takes
// under 1 us at 67 TFLOP/s, so bytes bound it. This layout reads w_hh once
// per batch row from L2 and uses B of the 132 SMs, so at T=1 each block's L2
// reads and the launch latency dominate. Spreading the gate rows of a batch
// row over a thread-block cluster, with h exchanged through distributed
// shared memory each step, is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads) gru_sequence_kernel(
    const float* __restrict__ xi, const float* __restrict__ masks, const float* __restrict__ h0,
    const float* __restrict__ w_hh, const float* __restrict__ b_hh, float* __restrict__ out,
    int T, int B, int H) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // [H]
  float* hh = h + H;                            // [3H]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int H4 = H >> 2;

  for (int i = threadIdx.x; i < H; i += blockDim.x) h[i] = h0[(size_t)b * H + i];

  for (int t = 0; t < T; ++t) {
    const float m = masks[(size_t)t * B + b];
    __syncthreads();  // h from the previous step (or h0) is complete
    for (int i = threadIdx.x; i < H; i += blockDim.x) h[i] *= m;
    __syncthreads();

    const float4* h_vec = reinterpret_cast<const float4*>(h);
    for (int row = warp; row < 3 * H; row += nwarps) {
      const float4* w_vec = reinterpret_cast<const float4*>(w_hh + (size_t)row * H);
      float acc = 0.0f;
#pragma unroll 4
      for (int k = lane; k < H4; k += 32) {
        const float4 w = __ldg(w_vec + k);
        const float4 x = h_vec[k];
        acc += w.x * x.x + w.y * x.y + w.z * x.z + w.w * x.w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) hh[row] = acc + b_hh[row];
    }
    __syncthreads();

    const float* x = xi + ((size_t)t * B + b) * 3 * H;
    float* o = out + ((size_t)t * B + b) * H;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float r = sigmoid(x[i] + hh[i]);
      const float z = sigmoid(x[H + i] + hh[H + i]);
      const float n = tanhf(x[2 * H + i] + r * hh[2 * H + i]);
      const float h_new = (1.0f - z) * n + z * h[i];
      o[i] = h_new;
      h[i] = h_new;  // element i belongs to this thread alone in this phase
    }
  }
}

}  // namespace

// Pointers are device pointers; the wrapper checks shapes, types and
// contiguity. H must be a multiple of 4 and 16*H bytes of shared memory must
// fit the default 48 KB. Returns cudaGetLastError() after the launch.
extern "C" int gru_sequence_f32(const float* xi, const float* masks, const float* h0,
                                const float* w_hh, const float* b_hh, float* out,
                                int T, int B, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)H;
  gru_sequence_kernel<<<B, kThreads, smem, stream>>>(xi, masks, h0, w_hh, b_hh, out, T, B, H);
  return (int)cudaGetLastError();
}
