// Single-flow bilinear backward warp and its backward pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_warp_kernel`
// (superslomo_tpu/ops/warp_pallas.py, launched from `_warp_image`) and the
// XLA VJP that its custom_vjp falls back to (the VJP of ops/warp.py::_warp_single):
//
//   out[b, c, y, x] = bilinear sample of img[b, c] at (y + flow[b, 1, y, x], x + flow[b, 0, y, x])
//
// with grid_sample(align_corners=True, padding_mode='zeros') semantics: taps
// outside the image count zero. Position and weight math is f32, the sum is
// f32, and only the store rounds to the image dtype (f32 or bf16; a bf16
// image gives the f32 warp of the same image upcast, cast afterwards, bit for
// bit). There is no +-128 px band, no row blocking and no column split: those
// are Mosaic devices, and a Hopper gather reaches any address, so both
// kernels are exact for any flow.
//
// Every tensor is addressed through element strides (b, c, y, x), so the
// channels_last slices the training step passes (the two frames of a pair,
// the flows of a stage head) are read in place: the channel stride is 1 and
// the pixel stride is the parent's channel count.
//
// Bound: device-memory bandwidth. At the training shape (B=32, C=3, 224x224,
// f32) the forward reads the image (19.3 MB) and the flow (12.8 MB) and
// writes the output (19.3 MB): ~15 us at 3.35 TB/s. The flow gradient reads
// the image, the flow and the output gradient and writes the flow gradient
// (~64 MB, ~19 us). The image's 4*C taps per pixel mostly hit L1/L2, since
// neighbouring threads sample neighbouring positions for smooth flows.
//
// Design: one thread per output pixel (b, y, x), x fastest, so flow loads and
// output stores coalesce; the sample position and the four weights are
// computed once per pixel and reused for all C channels.
// - Forward: the round-to-nearest intrinsics in the plain version's order
//   (((v00*w00 + v01*w01) + v10*w10) + v11*w11), so no FMA contraction
//   separates the kernel from the plain version (ops/warp.py).
// - Flow gradient: a gather with no atomics,
//     d/du = sum_c g_c [(1-wy)(v01 - v00) + wy(v11 - v10)],
//     d/dv = sum_c g_c [(1-wx)(v10 - v00) + wx(v11 - v01)],
//   with masked taps read as 0; floor() carries zero gradient, as in JAX.
// - Image gradient (only when asked; the training step never asks, the
//   images are data): g*w scattered with f32 atomicAdd into a zeroed f32
//   buffer that the wrapper casts to the image dtype. Masked taps add
//   nothing (JAX scatters 0 to the clipped index). The summation order
//   follows the atomics and varies from run to run.
// Positions are clamped to [-2, W+1] x [-2, H+1] before the float->int
// conversion (out of range is undefined on CUDA); every tap of a clamped
// position lies outside and is masked, so its value and gradient are 0 either
// way. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides {  // element strides of a (B, C, H, W) tensor
  int64_t b, c, y, x;
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  // bf16 -> f32 is exact: the bf16 bits are the top half of the f32 bits.
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The sample position of one output pixel: its top-left tap, the in-image
// masks of the four taps and the fractional offsets.
struct Taps {
  int x0, y0;
  bool m00, m01, m10, m11;
  float wx, wy, ax, ay;  // ax = 1 - wx, ay = 1 - wy
};

__device__ __forceinline__ Taps sample_taps(int x, int y, float u, float v, int H, int W) {
  Taps t;
  const float sx =
      fminf(fmaxf(__fadd_rn(static_cast<float>(x), u), -2.0f), static_cast<float>(W) + 1.0f);
  const float sy =
      fminf(fmaxf(__fadd_rn(static_cast<float>(y), v), -2.0f), static_cast<float>(H) + 1.0f);
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  t.wx = __fsub_rn(sx, x0f);
  t.wy = __fsub_rn(sy, y0f);
  t.ax = __fsub_rn(1.0f, t.wx);
  t.ay = __fsub_rn(1.0f, t.wy);
  t.x0 = static_cast<int>(x0f);
  t.y0 = static_cast<int>(y0f);
  const bool in_x0 = t.x0 >= 0 && t.x0 < W;
  const bool in_x1 = t.x0 + 1 >= 0 && t.x0 + 1 < W;
  const bool in_y0 = t.y0 >= 0 && t.y0 < H;
  const bool in_y1 = t.y0 + 1 >= 0 && t.y0 + 1 < H;
  t.m00 = in_y0 && in_x0;
  t.m01 = in_y0 && in_x1;
  t.m10 = in_y1 && in_x0;
  t.m11 = in_y1 && in_x1;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_single_forward_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                           T* __restrict__ out, int C, int H, int W, Strides si, Strides sf,
                           Strides so) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= static_cast<int64_t>(H) * W) return;
  const int64_t b = blockIdx.y;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);

  const float* f = flow + b * sf.b + y * sf.y + x * sf.x;
  const Taps t = sample_taps(x, y, load_f32(f), load_f32(f + sf.c), H, W);
  const float w00 = t.m00 ? __fmul_rn(t.ay, t.ax) : 0.0f;
  const float w01 = t.m01 ? __fmul_rn(t.ay, t.wx) : 0.0f;
  const float w10 = t.m10 ? __fmul_rn(t.wy, t.ax) : 0.0f;
  const float w11 = t.m11 ? __fmul_rn(t.wy, t.wx) : 0.0f;
  const int64_t i00 = t.y0 * si.y + t.x0 * si.x;
  const int64_t i01 = i00 + si.x;
  const int64_t i10 = i00 + si.y;
  const int64_t i11 = i10 + si.x;

  const T* src = img + b * si.b;
  T* dst = out + b * so.b + y * so.y + x * so.x;
  for (int c = 0; c < C; ++c) {
    const T* plane = src + c * si.c;
    const float v00 = t.m00 ? load_f32(plane + i00) : 0.0f;
    const float v01 = t.m01 ? load_f32(plane + i01) : 0.0f;
    const float v10 = t.m10 ? load_f32(plane + i10) : 0.0f;
    const float v11 = t.m11 ? load_f32(plane + i11) : 0.0f;
    float acc = __fmul_rn(v00, w00);
    acc = __fadd_rn(acc, __fmul_rn(v01, w01));
    acc = __fadd_rn(acc, __fmul_rn(v10, w10));
    acc = __fadd_rn(acc, __fmul_rn(v11, w11));
    store(dst + c * so.c, acc);
  }
}

// grad_out has the image's dtype (autograd hands back the output's dtype).
template <typename T, bool kFlowGrad, bool kImgGrad>
__global__ void __launch_bounds__(kThreads)
warp_single_backward_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                            const T* __restrict__ grad_out, float* __restrict__ grad_flow,
                            float* __restrict__ grad_img, int C, int H, int W, Strides si,
                            Strides sf, Strides sg, Strides sgf, Strides sgi) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= static_cast<int64_t>(H) * W) return;
  const int64_t b = blockIdx.y;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);

  const float* f = flow + b * sf.b + y * sf.y + x * sf.x;
  const Taps t = sample_taps(x, y, load_f32(f), load_f32(f + sf.c), H, W);
  const T* g_px = grad_out + b * sg.b + y * sg.y + x * sg.x;

  float du = 0.0f, dv = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float g = load_f32(g_px + c * sg.c);
    if (kFlowGrad) {
      const T* plane = img + b * si.b + c * si.c;
      const int64_t i00 = t.y0 * si.y + t.x0 * si.x;
      const float v00 = t.m00 ? load_f32(plane + i00) : 0.0f;
      const float v01 = t.m01 ? load_f32(plane + i00 + si.x) : 0.0f;
      const float v10 = t.m10 ? load_f32(plane + i00 + si.y) : 0.0f;
      const float v11 = t.m11 ? load_f32(plane + i00 + si.y + si.x) : 0.0f;
      du += g * (t.ay * (v01 - v00) + t.wy * (v11 - v10));
      dv += g * (t.ax * (v10 - v00) + t.wx * (v11 - v01));
    }
    if (kImgGrad) {
      float* plane = grad_img + b * sgi.b + c * sgi.c;
      const int64_t i00 = t.y0 * sgi.y + t.x0 * sgi.x;
      if (t.m00) atomicAdd(plane + i00, g * (t.ay * t.ax));
      if (t.m01) atomicAdd(plane + i00 + sgi.x, g * (t.ay * t.wx));
      if (t.m10) atomicAdd(plane + i00 + sgi.y, g * (t.wy * t.ax));
      if (t.m11) atomicAdd(plane + i00 + sgi.y + sgi.x, g * (t.wy * t.wx));
    }
  }
  if (kFlowGrad) {
    float* gf = grad_flow + b * sgf.b + y * sgf.y + x * sgf.x;
    gf[0] = du;
    gf[sgf.c] = dv;
  }
}

Strides strides_at(const int64_t* s) { return Strides{s[0], s[1], s[2], s[3]}; }

dim3 grid_for(int B, int H, int W) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  return dim3(static_cast<unsigned int>((hw + kThreads - 1) / kThreads), B);
}

template <typename T>
void launch_forward(const void* img, const float* flow, void* out, int B, int C, int H, int W,
                    const int64_t* s, cudaStream_t stream) {
  warp_single_forward_kernel<T><<<grid_for(B, H, W), kThreads, 0, stream>>>(
      static_cast<const T*>(img), flow, static_cast<T*>(out), C, H, W, strides_at(s),
      strides_at(s + 4), strides_at(s + 8));
}

template <typename T, bool kFlowGrad, bool kImgGrad>
void launch_backward(const void* img, const float* flow, const void* grad_out, float* grad_flow,
                     float* grad_img, int B, int C, int H, int W, const int64_t* s,
                     cudaStream_t stream) {
  warp_single_backward_kernel<T, kFlowGrad, kImgGrad><<<grid_for(B, H, W), kThreads, 0, stream>>>(
      static_cast<const T*>(img), flow, static_cast<const T*>(grad_out), grad_flow, grad_img, C,
      H, W, strides_at(s), strides_at(s + 4), strides_at(s + 8), strides_at(s + 12),
      strides_at(s + 16));
}

template <typename T>
void dispatch_backward(const void* img, const float* flow, const void* grad_out, float* grad_flow,
                       float* grad_img, int B, int C, int H, int W, const int64_t* s,
                       cudaStream_t stream) {
  if (grad_flow && grad_img)
    launch_backward<T, true, true>(img, flow, grad_out, grad_flow, grad_img, B, C, H, W, s, stream);
  else if (grad_flow)
    launch_backward<T, true, false>(img, flow, grad_out, grad_flow, grad_img, B, C, H, W, s, stream);
  else
    launch_backward<T, false, true>(img, flow, grad_out, grad_flow, grad_img, B, C, H, W, s, stream);
}

}  // namespace

// img (B, C, H, W) f32 or bf16; flow (B, 2, H, W) f32; out (B, C, H, W) in the
// image's dtype; all on one device, any strides. strides: 12 element strides
// (b, c, y, x) of img, flow, out. Returns cudaGetLastError().
extern "C" int warp_single_forward(const void* img, const void* flow, void* out, int bf16, int B,
                                   int C, int H, int W, const int64_t* strides, void* stream) {
  const float* f = static_cast<const float*>(flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_forward<__nv_bfloat16>(img, f, out, B, C, H, W, strides, s);
  else
    launch_forward<float>(img, f, out, B, C, H, W, strides, s);
  return static_cast<int>(cudaGetLastError());
}

// grad_out (B, C, H, W) in the image's dtype; grad_flow (B, 2, H, W) f32 or
// null; grad_img (B, C, H, W) f32, zeroed, or null (not both null). strides:
// 20 element strides (b, c, y, x) of img, flow, grad_out, grad_flow, grad_img
// (those of a null tensor are ignored). Returns cudaGetLastError().
extern "C" int warp_single_backward(const void* img, const void* flow, const void* grad_out,
                                    void* grad_flow, void* grad_img, int bf16, int B, int C, int H,
                                    int W, const int64_t* strides, void* stream) {
  const float* f = static_cast<const float*>(flow);
  float* gf = static_cast<float*>(grad_flow);
  float* gi = static_cast<float*>(grad_img);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!gf && !gi) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    dispatch_backward<__nv_bfloat16>(img, f, grad_out, gf, gi, B, C, H, W, strides, s);
  else
    dispatch_backward<float>(img, f, grad_out, gf, gi, B, C, H, W, strides, s);
  return static_cast<int>(cudaGetLastError());
}
