// Fused bilinear resize + per-channel affine on NHWC images.
//
// Replaces the Pallas kernel vlnce_tpu/ops/pallas_preprocess.py:
// fused_resize_normalize (body _preprocess_kernel), which computes per channel
// plane (R_h . img . R_w^T) * scale_c + bias_c with the 2-tap interpolation
// matrices of _bilinear_matrix: half-pixel centers, clamped at the edges,
// identity when a size is unchanged.
//
// Design. The TPU version moves channels to a leading axis so that each
// program sees a clean [H, W] plane for the matrix unit; that transpose is a
// VMEM-layout fix with no use here. One thread computes one output pixel for
// all C channels straight from NHWC: it derives its two source rows and
// columns and their weights the way _bilinear_matrix does (in double, weights
// rounded to float; where the clamp makes hi == lo one tap gets weight 1),
// interpolates along y then along x in the order of R_h . img . R_w^T, applies
// scale and bias and converts to the output type. u8 output rounds half to
// even (rintf) and clips to [0, 255], as jnp.round/torch.round do, so the
// integer resize of obs_transforms.resize_bilinear fuses into this pass.
//
// Bound at the act shapes, two launches per act step: rgb u8 [32,480,640,3]
// -> u8 [32,256,341,3] moves 29.5 + 8.4 MB, depth f32 [32,480,640,1] -> f32
// [32,256,341,1] moves 39.3 + 11.2 MB; 88 MB in all, about 26 us at
// 3.35 TB/s. Each input byte is needed about once (the 1.875x downscale reads
// each source pixel for about one output pixel), and neighbouring threads
// read neighbouring addresses, so a simple thread-per-pixel kernel can come
// close to that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

struct Affine {
  float scale[kMaxChannels];
  float bias[kMaxChannels];
};

struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

// One row of _bilinear_matrix(in_size, out_size), computed with the same
// double arithmetic (no fused multiply-add) and rounded to float.
__device__ __forceinline__ Tap bilinear_tap(int o, int in_size, int out_size) {
  Tap t;
  if (in_size == out_size) {
    t.lo = t.hi = o;
    t.w_lo = 1.0f;
    t.w_hi = 0.0f;
    return t;
  }
  const double scale = (double)in_size / (double)out_size;
  double src = __dsub_rn(__dmul_rn((double)o + 0.5, scale), 0.5);
  src = fmin(fmax(src, 0.0), (double)(in_size - 1));
  const int lo = (int)floor(src);
  const double w = __dsub_rn(src, (double)lo);
  t.lo = lo;
  t.hi = min(lo + 1, in_size - 1);
  t.w_lo = __double2float_rn(__dsub_rn(1.0, w));
  t.w_hi = __double2float_rn(w);
  return t;
}

__device__ __forceinline__ float load_f(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load_f(const float* p) { return *p; }

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f(uint8_t* p, float v) {
  *p = (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads) resize_normalize_kernel(
    const TIn* __restrict__ in, TOut* __restrict__ out, Affine affine,
    int B, int H, int W, int C, int OH, int OW) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * OH * OW;
  if (idx >= total) return;
  const int ox = (int)(idx % OW);
  const int oy = (int)((idx / OW) % OH);
  const size_t b = idx / ((size_t)OW * OH);
  const Tap ty = bilinear_tap(oy, H, OH);
  const Tap tx = bilinear_tap(ox, W, OW);

  const TIn* row_lo = in + (b * H + ty.lo) * (size_t)W * C;
  const TIn* row_hi = in + (b * H + ty.hi) * (size_t)W * C;
  const size_t c_lo = (size_t)tx.lo * C;
  const size_t c_hi = (size_t)tx.hi * C;
  TOut* dst = out + idx * C;
  for (int c = 0; c < C; ++c) {
    // interpolate along y first (R_h . img), then along x (. R_w^T)
    const float col_lo = __fadd_rn(__fmul_rn(ty.w_lo, load_f(row_lo + c_lo + c)),
                                   __fmul_rn(ty.w_hi, load_f(row_hi + c_lo + c)));
    const float col_hi = __fadd_rn(__fmul_rn(ty.w_lo, load_f(row_lo + c_hi + c)),
                                   __fmul_rn(ty.w_hi, load_f(row_hi + c_hi + c)));
    const float v = __fadd_rn(__fmul_rn(tx.w_lo, col_lo), __fmul_rn(tx.w_hi, col_hi));
    store_f(dst + c, __fadd_rn(__fmul_rn(v, affine.scale[c]), affine.bias[c]));
  }
}

template <typename TIn, typename TOut>
void launch(const void* in, void* out, const Affine& affine, int B, int H, int W, int C,
            int OH, int OW, cudaStream_t stream) {
  const size_t total = (size_t)B * OH * OW;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  resize_normalize_kernel<TIn, TOut><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TIn*>(in), static_cast<TOut*>(out), affine, B, H, W, C, OH, OW);
}

}  // namespace

// in_type: 0 = uint8, 1 = float32. out_type: 0 = uint8 (uint8 input only),
// 1 = float32, 2 = bfloat16. scale/bias are host arrays of C floats (C <= 4). Pointers
// in/out are device pointers. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a type or channel count it does not take.
extern "C" int resize_normalize(const void* in, void* out, int in_type, int out_type,
                                const float* scale, const float* bias,
                                int B, int H, int W, int C, int OH, int OW,
                                cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  Affine affine;
  for (int c = 0; c < kMaxChannels; ++c) {
    affine.scale[c] = c < C ? scale[c] : 1.0f;
    affine.bias[c] = c < C ? bias[c] : 0.0f;
  }
  if (in_type == 0 && out_type == 0) launch<uint8_t, uint8_t>(in, out, affine, B, H, W, C, OH, OW, stream);
  else if (in_type == 0 && out_type == 1) launch<uint8_t, float>(in, out, affine, B, H, W, C, OH, OW, stream);
  else if (in_type == 0 && out_type == 2) launch<uint8_t, __nv_bfloat16>(in, out, affine, B, H, W, C, OH, OW, stream);
  else if (in_type == 1 && out_type == 1) launch<float, float>(in, out, affine, B, H, W, C, OH, OW, stream);
  else if (in_type == 1 && out_type == 2) launch<float, __nv_bfloat16>(in, out, affine, B, H, W, C, OH, OW, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
