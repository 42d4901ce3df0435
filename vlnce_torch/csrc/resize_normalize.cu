// Fused bilinear resize + per-channel affine on NHWC images.
//
// Replaces the Pallas kernel vlnce_tpu/ops/pallas_preprocess.py:
// fused_resize_normalize (body _preprocess_kernel), which computes per channel
// plane (R_h . img . R_w^T) * scale_c + bias_c with the 2-tap interpolation
// matrices of _bilinear_matrix: half-pixel centers, clamped at the edges,
// identity when a size is unchanged.
//
// What bounds it. Bytes: at the act shapes (rgb u8 [32,480,640,3] -> u8
// [32,256,341,3] and depth f32 [32,480,640,1] -> f32 [32,256,341,1], two
// launches per act step) the function moves 88 MB, 0.0264 ms at 3.35 TB/s,
// and does a dozen operations per output value. The 69 MB of input exceed the
// 50 MB L2, so it is a stream from device memory, and at a 1.875x downscale
// each source row feeds about one output row: the bound is reachable if
// memory instructions, address arithmetic and type conversions stay out of
// the way.
//
// Design.
// - The matrix-product form of the TPU kernel is not carried over: each row
//   of R_h and R_w has two non-zeros, so at these shapes tensor cores would
//   do about 240 times the arithmetic for nothing. The wrapper hands the
//   kernel the non-zeros as tap tables (lo, hi, w_lo, w_hi per output index),
//   computed once per (in_size, out_size) on the host in double exactly as
//   _bilinear_matrix does and cached on the device. The kernel does no double
//   arithmetic and no division per thread.
// - A block owns tiles of one image and R consecutive output rows. The source
//   rows a tile needs are adjacent rows of one image, one contiguous span of
//   bytes. Thread 0 asks for the span with one bulk asynchronous copy
//   (cp.async.bulk) that completes on an mbarrier; there are two stages, so
//   the next tile's span is in flight while this one is computed, and two
//   blocks share an SM. Blocks are persistent: each walks tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... Where the image's base or its row size is not
//   a multiple of 16 bytes, bulk copies cannot be used and the threads load
//   the span element by element into the same stage instead (`bulk` = 0).
// - Each warp takes an output row of the tile, its lanes the pixels. A thread
//   reads its four source pixels per channel from shared memory, interpolates
//   along y then along x in the order of R_h . img . R_w^T with FMA
//   contraction off, applies scale and bias and converts. u8 -> f32 and the
//   u8 rounding (half to even, clipped to [0, 255], as jnp.round/torch.round
//   do) go through the 2^23 trick, one float add each, since conversion
//   instructions run at an eighth of the FP32 rate and the RGB launch needs
//   five per output value.
// - The tile's output is also one contiguous span, but its start is not
//   16-byte aligned in general (a row of 341 x 3 u8 is 1,023 bytes). The tile
//   is staged in shared memory at the same offset modulo 16 as its place in
//   device memory, then the aligned middle is written with 16-byte stores and
//   the head and tail by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 4;
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;

struct Affine {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

// 2^23: adding it to a float in [0, 2^23) leaves the value, rounded half to
// even to an integer, in the low mantissa bits.
constexpr float kTwo23 = 8388608.0f;

__device__ __forceinline__ float load_f(const uint8_t* p) {
  return __fsub_rn(__uint_as_float(0x4B000000u | (uint32_t)*p), kTwo23);
}
__device__ __forceinline__ float load_f(const float* p) { return *p; }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(uint8_t* p, float v) {
  *p = (uint8_t)(__float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), kTwo23)) & 0xFFu);
}

struct Tile {
  int image, row0, rows;  // output rows [row0, row0 + rows) of one image
  int src0, src_rows;     // the source rows they read: [src0, src0 + src_rows)
};

// y_idx is [2, OH]: lo then hi. Both rise with the output row, so a tile reads
// from its first row's lo to its last row's hi.
__device__ __forceinline__ Tile tile_at(int tile, int tiles_per_image, int R, int OH, const int* __restrict__ y_idx) {
  Tile t;
  t.image = tile / tiles_per_image;
  t.row0 = (tile - t.image * tiles_per_image) * R;
  t.rows = min(R, OH - t.row0);
  t.src0 = __ldg(y_idx + t.row0);
  t.src_rows = __ldg(y_idx + OH + t.row0 + t.rows - 1) - t.src0 + 1;
  return t;
}

// Dynamic shared memory: [0, 16) the stages' barriers; OW packed x taps of 16
// bytes; kStages input stages of stage_bytes; the output tile (+ 16).
template <typename TIn, typename TOut, int C>
__global__ void __launch_bounds__(kThreads) resize_normalize_kernel(
    const TIn* __restrict__ in, TOut* __restrict__ out, const int* __restrict__ y_idx,
    const float* __restrict__ y_w, const int* __restrict__ x_idx, const float* __restrict__ x_w,
    Affine affine, int H, int W, int OH, int OW, int R, int tiles_per_image, int num_tiles,
    int stage_bytes, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int4* x_tap = reinterpret_cast<int4*>(smem + 16);
  unsigned char* stage_in = smem + 16 + 16 * (size_t)OW;
  unsigned char* stage_out = stage_in + (size_t)kStages * stage_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_elems = W * C, out_row_elems = OW * C;

  for (int ox = tid; ox < OW; ox += kThreads)
    x_tap[ox] = make_int4(__ldg(x_idx + ox) * C, __ldg(x_idx + OW + ox) * C,
                          __float_as_int(__ldg(x_w + ox)), __float_as_int(__ldg(x_w + OW + ox)));
  if (bulk && tid == 0)
    for (int s = 0; s < kStages; ++s) async_copy::barrier_init(full + s, 1);
  __syncthreads();

  auto source = [&](const Tile& t) { return in + ((size_t)t.image * H + t.src0) * row_elems; };
  auto request = [&](const Tile& t, int s) {  // one thread
    const uint32_t bytes = (uint32_t)(t.src_rows * row_elems * (int)sizeof(TIn));
    async_copy::barrier_expect(full + s, bytes);
    async_copy::bulk_copy(stage_in + (size_t)s * stage_bytes, source(t), bytes, full + s);
  };

  int tile = blockIdx.x;
  if (bulk && tid == 0 && tile < num_tiles) request(tile_at(tile, tiles_per_image, R, OH, y_idx), 0);
  for (int k = 0; tile < num_tiles; tile += gridDim.x, ++k) {
    const int s = k % kStages;
    const Tile t = tile_at(tile, tiles_per_image, R, OH, y_idx);
    const TIn* src = reinterpret_cast<const TIn*>(stage_in + (size_t)s * stage_bytes);
    if (bulk) {
      // the other stage was last read before the barrier that ended the
      // previous tile, so it is free for the next tile's span
      const int next = tile + gridDim.x;
      if (tid == 0 && next < num_tiles) request(tile_at(next, tiles_per_image, R, OH, y_idx), (k + 1) % kStages);
      async_copy::barrier_wait(full + s, (k / kStages) & 1);
    } else {
      TIn* dst = const_cast<TIn*>(src);
      const TIn* from = source(t);
      for (int i = tid; i < t.src_rows * row_elems; i += kThreads) dst[i] = from[i];
      __syncthreads();
    }

    TOut* tile_out = out + ((size_t)t.image * OH + t.row0) * out_row_elems;
    const int pad = (int)(reinterpret_cast<uintptr_t>(tile_out) & 15);
    TOut* staged = reinterpret_cast<TOut*>(stage_out + pad);
    for (int r = warp; r < t.rows; r += kWarps) {
      const int oy = t.row0 + r;
      const TIn* row_lo = src + (__ldg(y_idx + oy) - t.src0) * row_elems;
      const TIn* row_hi = src + (__ldg(y_idx + OH + oy) - t.src0) * row_elems;
      const float wy_lo = __ldg(y_w + oy), wy_hi = __ldg(y_w + OH + oy);
      TOut* dst = staged + r * out_row_elems;
      for (int ox = lane; ox < OW; ox += 32) {
        const int4 tx = x_tap[ox];
        const float wx_lo = __int_as_float(tx.z), wx_hi = __int_as_float(tx.w);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // interpolate along y first (R_h . img), then along x (. R_w^T)
          const float col_lo = __fadd_rn(__fmul_rn(wy_lo, load_f(row_lo + tx.x + c)),
                                         __fmul_rn(wy_hi, load_f(row_hi + tx.x + c)));
          const float col_hi = __fadd_rn(__fmul_rn(wy_lo, load_f(row_lo + tx.y + c)),
                                         __fmul_rn(wy_hi, load_f(row_hi + tx.y + c)));
          const float v = __fadd_rn(__fmul_rn(wx_lo, col_lo), __fmul_rn(wx_hi, col_hi));
          store_f(dst + ox * C + c, __fadd_rn(__fmul_rn(v, affine.scale[c]), affine.bias[c]));
        }
      }
    }
    __syncthreads();

    // the staged tile and its place in device memory agree modulo 16
    const int tile_bytes = t.rows * out_row_elems * (int)sizeof(TOut);
    unsigned char* to = reinterpret_cast<unsigned char*>(tile_out);
    const unsigned char* from = stage_out + pad;
    const int head = min((16 - pad) & 15, tile_bytes);
    const int vectors = (tile_bytes - head) >> 4;
    const int tail = head + (vectors << 4);
    if (tid < head) to[tid] = from[tid];
    const uint4* from16 = reinterpret_cast<const uint4*>(from + head);
    uint4* to16 = reinterpret_cast<uint4*>(to + head);
    for (int i = tid; i < vectors; i += kThreads) to16[i] = from16[i];
    if (tid < tile_bytes - tail) to[tail + tid] = from[tail + tid];
    __syncthreads();  // the staged tile and this input stage may be overwritten
  }
}

template <typename TIn, typename TOut, int C>
int launch(const void* in, void* out, const int* y_idx, const float* y_w, const int* x_idx,
           const float* x_w, const Affine& affine, int B, int H, int W, int OH, int OW, int R,
           int stage_bytes, int smem_bytes, int bulk, int grid, cudaStream_t stream) {
  auto kernel = resize_normalize_kernel<TIn, TOut, C>;
  static int configured[kMaxDevices];  // dynamic shared memory granted so far, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > 48 * 1024 && smem_bytes > configured[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    configured[device] = smem_bytes;
  }
  const int tiles_per_image = (OH + R - 1) / R;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), y_idx, y_w, x_idx, x_w, affine, H, W,
      OH, OW, R, tiles_per_image, B * tiles_per_image, stage_bytes, bulk);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, typename... Args>
int launch_channels(int C, Args... args) {
  switch (C) {
    case 1: return launch<TIn, TOut, 1>(args...);
    case 2: return launch<TIn, TOut, 2>(args...);
    case 3: return launch<TIn, TOut, 3>(args...);
    case 4: return launch<TIn, TOut, 4>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in_type: 0 = uint8, 1 = float32. out_type: 0 = uint8 (uint8 input only),
// 1 = float32, 2 = bfloat16. scale/bias are host arrays of C floats (C <= 4).
// in/out and the tap tables are device pointers: y_idx [2, OH] and x_idx
// [2, OW] hold lo then hi, y_w and x_w the weights in the same layout. The
// wrapper chooses the tiling: R output rows per tile, stage_bytes (a multiple
// of 16 that holds the source rows of any tile), the block's dynamic shared
// memory, the grid, and bulk = 1 where `in` and W * C * sizeof(in) are
// multiples of 16 bytes. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a type or channel count it does not take.
extern "C" int resize_normalize(const void* in, void* out, int in_type, int out_type,
                                const float* scale, const float* bias, const int* y_idx,
                                const float* y_w, const int* x_idx, const float* x_w, int B, int H,
                                int W, int C, int OH, int OW, int R, int stage_bytes,
                                int smem_bytes, int bulk, int grid, cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels || R < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  Affine affine;
  for (int c = 0; c < kMaxChannels; ++c) {
    affine.scale[c] = c < C ? scale[c] : 1.0f;
    affine.bias[c] = c < C ? bias[c] : 0.0f;
  }
#define RESIZE_LAUNCH(TIn, TOut)                                                                  \
  return launch_channels<TIn, TOut>(C, in, out, y_idx, y_w, x_idx, x_w, affine, B, H, W, OH, OW, \
                                    R, stage_bytes, smem_bytes, bulk, grid, stream)
  if (in_type == 0 && out_type == 0) RESIZE_LAUNCH(uint8_t, uint8_t);
  if (in_type == 0 && out_type == 1) RESIZE_LAUNCH(uint8_t, float);
  if (in_type == 0 && out_type == 2) RESIZE_LAUNCH(uint8_t, __nv_bfloat16);
  if (in_type == 1 && out_type == 1) RESIZE_LAUNCH(float, float);
  if (in_type == 1 && out_type == 2) RESIZE_LAUNCH(float, __nv_bfloat16);
#undef RESIZE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
