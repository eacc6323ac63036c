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
// Bound: device-memory bandwidth. Each (pixel, flow) reads one u and one v
// value and writes C outputs; the planes are read once for all n flows. At
// the fused 8x step's shapes (B=2, C=3, n=7, 736x1280) that is ~286 MB for
// the f32 final warps (~85 us at 3.35 TB/s) and ~196 MB for the bf16 stage-2
// input warps (~59 us).
//
// Design (warp_tile.cuh): a block owns one output tile of one image and loops
// over all n flows, so the plane lines around the tile come from device
// memory once and serve every flow from L1, the Hopper form of the Pallas
// kernel's VMEM residency. For each flow a thread reads its kPX pixels' u and
// v with one vector load each, samples, gathers, and stores each channel's
// kPX values with one vector store (the output is (B, C, n, H, W)
// contiguous). The planes are read through element strides, so the step's
// channels_last slices of its 6-channel pairs need no copy.

#include "warp_tile.cuh"

namespace {

using namespace warp;

template <typename T>
__global__ void __launch_bounds__(Tile::kThreads)
warp_multiflow_kernel(const T* __restrict__ planes, const float* __restrict__ u,
                      const float* __restrict__ v, T* __restrict__ out, int C, int n, int H, int W,
                      Strides sp, Strides su, Strides sv, Plan plan) {
  constexpr int kPX = Tile::kPX;
  const int b = blockIdx.z;
  const int x = blockIdx.x * Tile::kW + (threadIdx.x % Tile::kCols) * kPX;
  const int y = blockIdx.y * Tile::kH + threadIdx.x / Tile::kCols;
  const int valid = y < H ? min(kPX, W - x) : 0;  // this thread's pixels inside the image
  if (valid <= 0) return;
  const T* img = planes + b * sp.b;
  const float* ub = u + b * su.b + static_cast<int64_t>(y) * su.y + x * su.x;
  const float* vb = v + b * sv.b + static_cast<int64_t>(y) * sv.y + x * sv.x;
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int k = 0; k < n; ++k) {
    float uu[kPX], vv[kPX];
    load_uv(ub + k * su.c, su.x, vb + k * sv.c, sv.x, plan.flow_mode, valid, uu, vv);
    Sample s[kPX];
#pragma unroll
    for (int i = 0; i < kPX; ++i) s[i] = make_sample(x + i, y, uu[i], vv[i], H, W);
    for (int c = 0; c < C; ++c) {
      float acc[kPX];
#pragma unroll
      for (int i = 0; i < kPX; ++i) acc[i] = bilinear(s[i], img, sp, c);
      T* dst = out + ((static_cast<int64_t>(b) * C + c) * n + k) * hw + static_cast<int64_t>(y) * W + x;
      store_px(dst, acc, 1, plan.out_mode, valid);
    }
  }
}

template <typename T>
cudaError_t launch(const void* planes, const float* u, const float* v, void* out, int B, int C,
                   int n, int H, int W, const int64_t* s, const Plan& plan, cudaStream_t stream) {
  const dim3 grid((W + Tile::kW - 1) / Tile::kW, (H + Tile::kH - 1) / Tile::kH, B);
  warp_multiflow_kernel<T><<<grid, Tile::kThreads, 0, stream>>>(
      static_cast<const T*>(planes), u, v, static_cast<T*>(out), C, n, H, W,
      Strides{s[0], s[1], s[2], s[3]}, Strides{s[4], s[5], s[6], s[7]},
      Strides{s[8], s[9], s[10], s[11]}, plan);
  return cudaGetLastError();
}

}  // namespace

// planes (B, C, H, W) f32 or bf16; u, v (B, n, H, W) f32; out (B, C, n, H, W)
// contiguous in the planes' dtype; all on one device. strides: 12 element
// strides (b, c, y, x) of planes, u, v (any). plan: the 3 ints of Plan
// (ops/warp_plan.py). Returns the launch's CUDA error (0: launched).
extern "C" int warp_multiflow_planar(const void* planes, const void* u, const void* v, void* out,
                                     int bf16, int B, int C, int n, int H, int W,
                                     const int64_t* strides, const int* plan, void* stream) {
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  const Plan p{plan[0], plan[1], plan[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return static_cast<int>(launch<__nv_bfloat16>(planes, uf, vf, out, B, C, n, H, W, strides, p, s));
  return static_cast<int>(launch<float>(planes, uf, vf, out, B, C, n, H, W, strides, p, s));
}
