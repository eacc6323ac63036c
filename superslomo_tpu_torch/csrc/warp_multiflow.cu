// Multi-flow bilinear backward warp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_warp_kernel_mf`
// (superslomo_tpu/ops/warp_pallas.py, launched from `_warp_planes_core`):
// C image planes backward-warped by n flow fields with
// grid_sample(align_corners=True, padding_mode='zeros') semantics,
//
//   out[b, c, k, y, x] = bilinear sample of planes[b, c] at (y + v[b, k, y, x], x + u[b, k, y, x]),
//
// where taps outside the image count zero. The output has the planes' dtype
// (f32 or bf16). Position and weight math is f32, the sum is f32, and only
// the store rounds (bf16 planes give the f32 warp of the same planes upcast,
// cast afterwards, bit for bit: the upcast is exact and the two share all
// code up to the store). Unlike the Pallas kernel there is no +-128 px band:
// a Hopper gather reaches any address, so the kernel is exact for any flow.
//
// Bound: device-memory bandwidth. Each thread reads one u and one v value and
// writes C outputs; the 4*C gathered taps come from the planes, which all n
// flows share and which stay resident in the 50 MB L2 (11 MB for a 736x1280
// f32 image). At the fused 8x step's shapes (C=3, n=7, 736x1280, per image)
// that is ~98 MB for the bf16 stage-2 input warps (~29 us at 3.35 TB/s) and
// ~143 MB for the f32 final warps (~43 us).
//
// Design: one thread per output pixel (b, k, y, x), x fastest, so the u/v
// loads and every channel's store coalesce; the sample position and the four
// weights are computed once and reused for all C channels; taps go through
// the read-only path. Products and sums use the round-to-nearest intrinsics
// in the plain version's order, so no FMA contraction changes the result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  // bf16 -> f32 is exact: the bf16 bits are the top half of the f32 bits.
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_multiflow_kernel(const T* __restrict__ planes, const float* __restrict__ u,
                      const float* __restrict__ v, T* __restrict__ out, int C, int n, int H,
                      int W) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);

  const int64_t flow_off = (static_cast<int64_t>(b) * n + k) * hw + p;
  // Clamp before the float->int conversion (out of range is undefined on
  // CUDA); every tap of a clamped position lies outside and is masked.
  const float sx = fminf(fmaxf(__fadd_rn(static_cast<float>(x), load_f32(u + flow_off)), -2.0f),
                         static_cast<float>(W) + 1.0f);
  const float sy = fminf(fmaxf(__fadd_rn(static_cast<float>(y), load_f32(v + flow_off)), -2.0f),
                         static_cast<float>(H) + 1.0f);
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float wx = __fsub_rn(sx, x0f);
  const float wy = __fsub_rn(sy, y0f);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;

  const bool in_x0 = x0 >= 0 && x0 < W;
  const bool in_x1 = x1 >= 0 && x1 < W;
  const bool in_y0 = y0 >= 0 && y0 < H;
  const bool in_y1 = y1 >= 0 && y1 < H;
  const bool m00 = in_y0 && in_x0;
  const bool m01 = in_y0 && in_x1;
  const bool m10 = in_y1 && in_x0;
  const bool m11 = in_y1 && in_x1;

  const float ax = __fsub_rn(1.0f, wx);
  const float ay = __fsub_rn(1.0f, wy);
  const float w00 = m00 ? __fmul_rn(ay, ax) : 0.0f;
  const float w01 = m01 ? __fmul_rn(ay, wx) : 0.0f;
  const float w10 = m10 ? __fmul_rn(wy, ax) : 0.0f;
  const float w11 = m11 ? __fmul_rn(wy, wx) : 0.0f;

  const int64_t i00 = static_cast<int64_t>(y0) * W + x0;
  const int64_t i01 = i00 + 1;
  const int64_t i10 = i00 + W;
  const int64_t i11 = i10 + 1;

  for (int c = 0; c < C; ++c) {
    const T* plane = planes + (static_cast<int64_t>(b) * C + c) * hw;
    const float v00 = m00 ? load_f32(plane + i00) : 0.0f;
    const float v01 = m01 ? load_f32(plane + i01) : 0.0f;
    const float v10 = m10 ? load_f32(plane + i10) : 0.0f;
    const float v11 = m11 ? load_f32(plane + i11) : 0.0f;
    float acc = __fmul_rn(v00, w00);
    acc = __fadd_rn(acc, __fmul_rn(v01, w01));
    acc = __fadd_rn(acc, __fmul_rn(v10, w10));
    acc = __fadd_rn(acc, __fmul_rn(v11, w11));
    store(out + ((static_cast<int64_t>(b) * C + c) * n + k) * hw + p, acc);
  }
}

template <typename T>
void launch(const void* planes, const float* u, const float* v, void* out, int B, int C, int n,
            int H, int W, cudaStream_t stream) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned int>((hw + kThreads - 1) / kThreads), n, B);
  warp_multiflow_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(planes), u, v, static_cast<T*>(out), C, n, H, W);
}

}  // namespace

// planes (B, C, H, W) f32 or bf16; u, v (B, n, H, W) f32; out (B, C, n, H, W)
// in the planes' dtype; all contiguous on one device. Returns cudaGetLastError().
extern "C" int warp_multiflow_planar(const void* planes, const void* u, const void* v, void* out,
                                     int bf16, int B, int C, int n, int H, int W, void* stream) {
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(planes, uf, vf, out, B, C, n, H, W, s);
  else
    launch<float>(planes, uf, vf, out, B, C, n, H, W, s);
  return static_cast<int>(cudaGetLastError());
}
