// Shared pieces of the bilinear backward-warp kernels (warp_single.cu,
// warp_multiflow.cu) for Hopper (sm_90a), the row window of both included.
//
// The sample arithmetic (`sample_taps`, `make_sample`, `bilinear`) is the
// plain version's (ops/warp.py): f32 position and weight math with the
// round-to-nearest intrinsics in its order, so no FMA contraction separates a
// kernel from it, and positions clamped to [-2, W+1] x [-2, H+1] before the
// float->int conversion (out of range is undefined on CUDA; every tap of a
// clamped position lies outside and is masked).
//
// The tiled kernels share one design:
// - A block owns a Tile::kW x Tile::kH output tile of one image; a thread owns
//   Tile::kPX pixels of one tile row, x fastest: adjacent ones in the forward
//   kernels and the image gradient, Tile::kCols apart in the flow gradient
//   (warp_single.cu).
// - Flows are read with one 8-byte load per pixel where (u, v) are adjacent
//   (the channels_last heads), or one kPX-wide load of u and of v where they
//   are planar; the wrapper picks the mode from the strides and alignment
//   (ops/warp_plan.py). Taps are gathered from device memory through L1.
//   (Staging the tile's source window in shared memory measured slower than
//   L1 at every budget, tile and flow field tried on the H100: PERF.md.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace warp {

struct Strides {  // element strides of a (B, C, H, W) tensor
  int64_t b, c, y, x;
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  // bf16 -> f32 is exact: the bf16 bits are the top half of the f32 bits.
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// Two adjacent elements, 2-element aligned, as f32.
__device__ __forceinline__ float2 load_f32x2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float2 load_f32x2(const __nv_bfloat16* p) {
  const unsigned int bits = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
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

// ---------------------------------------------------------------------------
// Row windows (height sharding, parallel/halo.py): the output and the flows
// are a block of a taller frame's rows, and the image or planes hold other
// rows of it. Each sample position is taken in frame rows, with one
// process's arithmetic, and its taps are then read at the image's rows; a tap
// outside the image's rows reads 0.

// The output's and the flows' first frame row, the image's first frame row
// and its rows, and the frame's rows.
struct RowWindow {
  int y_base, p_base, p_rows, frame_rows;
};

// sample_taps under a row window: position and weights in frame rows, the
// taps' rows moved to the image's rows and masked outside them.
__device__ __forceinline__ Taps sample_taps_rows(int x, int y, float u, float v, const RowWindow& r, int W) {
  Taps t = sample_taps(x, y + r.y_base, u, v, r.frame_rows, W);
  t.y0 -= r.p_base;
  const bool top = t.y0 >= 0 && t.y0 < r.p_rows, bottom = t.y0 + 1 >= 0 && t.y0 + 1 < r.p_rows;
  t.m00 = t.m00 && top;
  t.m01 = t.m01 && top;
  t.m10 = t.m10 && bottom;
  t.m11 = t.m11 && bottom;
  return t;
}

// ---------------------------------------------------------------------------
// The tiled kernels.

// A block's output tile: kW x kH pixels, kPX adjacent ones of a row a thread
// (ops/warp_plan.py holds the same numbers). 64 x 8 x 2 measured fastest of
// the tiles tried on the H100 for both kernels (PERF.md).
struct Tile {
  static constexpr int kW = 64, kH = 8, kPX = 2;
  static constexpr int kCols = kW / kPX;  // threads across a tile row
  static constexpr int kThreads = kCols * kH;
  static constexpr int kWarps = kThreads / 32;
};

// How a kernel reads its flows and output gradient and writes its output,
// chosen by the wrapper (ops/warp_plan.py).
enum FlowMode { kFlowScalar = 0, kFlowPair = 1, kFlowPlanarVec = 2 };
enum InMode { kInScalar = 0, kInPlanarVec = 1 };
// kOutPair: (du, dv) adjacent, one 8-byte store a pixel.
enum OutMode { kOutScalar = 0, kOutRows = 1, kOutPlanarVec = 2, kOutPair = 3 };

struct Plan {
  int flow_mode;  // FlowMode
  int out_mode;   // OutMode
  int smem;       // dynamic shared memory bytes of the launch (at most 48 KB)
};

// The plan of the gradient kernels (warp_single.cu); they take no shared
// memory.
struct GradPlan {
  int flow_mode;  // FlowMode
  int grad_mode;  // InMode of the output gradient (kInScalar for the flow gradient)
  int out_mode;   // OutMode of the flow gradient (kOutScalar for the image gradient)
};

// One pixel's sample: its top-left tap, masks, and the four weights (0 where
// masked), as the plain version computes them.
struct Sample {
  int x0, y0;
  bool m00, m01, m10, m11;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Sample make_sample(int x, int y, float u, float v, int H, int W) {
  const Taps t = sample_taps(x, y, u, v, H, W);
  Sample s;
  s.x0 = t.x0;
  s.y0 = t.y0;
  s.m00 = t.m00;
  s.m01 = t.m01;
  s.m10 = t.m10;
  s.m11 = t.m11;
  s.w00 = t.m00 ? __fmul_rn(t.ay, t.ax) : 0.0f;
  s.w01 = t.m01 ? __fmul_rn(t.ay, t.wx) : 0.0f;
  s.w10 = t.m10 ? __fmul_rn(t.wy, t.ax) : 0.0f;
  s.w11 = t.m11 ? __fmul_rn(t.wy, t.wx) : 0.0f;
  return s;
}

// One pixel's sample under a row window: the position and weights taken in
// frame rows, as one process takes them over the whole frame, then the taps'
// rows moved to the image's rows; a tap outside the image's rows reads 0.
__device__ __forceinline__ Sample make_sample_rows(int x, int y, float u, float v, const RowWindow& r, int W) {
  Sample s = make_sample(x, y + r.y_base, u, v, r.frame_rows, W);
  s.y0 -= r.p_base;
  const bool top = s.y0 >= 0 && s.y0 < r.p_rows, bottom = s.y0 + 1 >= 0 && s.y0 + 1 < r.p_rows;
  s.m00 = s.m00 && top;
  s.m01 = s.m01 && top;
  s.m10 = s.m10 && bottom;
  s.m11 = s.m11 && bottom;
  if (!top) s.w00 = s.w01 = 0.0f;
  if (!bottom) s.w10 = s.w11 = 0.0f;
  return s;
}

// (((v00*w00 + v01*w01) + v10*w10) + v11*w11) with masked taps read as 0,
// gathering channel c of img (one image) from device memory.
template <typename T>
__device__ __forceinline__ float bilinear(const Sample& s, const T* img, const Strides& st, int c) {
  const T* plane = img + c * st.c;
  const float v00 = s.m00 ? load_f32(plane + s.y0 * st.y + s.x0 * st.x) : 0.0f;
  const float v01 = s.m01 ? load_f32(plane + s.y0 * st.y + (s.x0 + 1) * st.x) : 0.0f;
  const float v10 = s.m10 ? load_f32(plane + (s.y0 + 1) * st.y + s.x0 * st.x) : 0.0f;
  const float v11 = s.m11 ? load_f32(plane + (s.y0 + 1) * st.y + (s.x0 + 1) * st.x) : 0.0f;
  float acc = __fmul_rn(v00, s.w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, s.w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, s.w10));
  acc = __fadd_rn(acc, __fmul_rn(v11, s.w11));
  return acc;
}

static_assert(Tile::kPX == 2, "the vector paths below read and write pixel pairs");

// The (u, v) of up to kPX adjacent pixels (the first `valid`): u[i] at
// pu + i*sxu, v[i] at pv + i*sxv. kFlowPair: pv == pu + 1, 8-byte aligned.
// kFlowPlanarVec: x strides 1, pu and pv kPX*4-byte aligned, valid 0 or kPX.
__device__ __forceinline__ void load_uv(const float* pu, int64_t sxu, const float* pv, int64_t sxv,
                                        int mode, int valid, float* u, float* v) {
#pragma unroll
  for (int i = 0; i < Tile::kPX; ++i) u[i] = v[i] = 0.0f;
  if (valid <= 0) return;
  if (mode == kFlowPlanarVec) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(pu));
    const float2 c = __ldg(reinterpret_cast<const float2*>(pv));
    u[0] = a.x; u[1] = a.y;
    v[0] = c.x; v[1] = c.y;
    return;
  }
#pragma unroll
  for (int i = 0; i < Tile::kPX; ++i) {
    if (i < valid) {
      if (mode == kFlowPair) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(pu + i * sxu));
        u[i] = f.x;
        v[i] = f.y;
      } else {
        u[i] = __ldg(pu + i * sxu);
        v[i] = __ldg(pv + i * sxv);
      }
    }
  }
}

// kPX values to p; kOutPlanarVec: one aligned kPX-wide store, else the first
// `valid` one by one, sx apart.
__device__ __forceinline__ void store_px(float* p, const float* a, int64_t sx, int mode, int valid) {
  if (mode == kOutPlanarVec) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
    return;
  }
#pragma unroll
  for (int i = 0; i < Tile::kPX; ++i)
    if (i < valid) p[i * sx] = a[i];
}

__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_px(__nv_bfloat16* p, const float* a, int64_t sx, int mode,
                                         int valid) {
  if (mode == kOutPlanarVec) {
    *reinterpret_cast<unsigned int*>(p) = bf16_bits(a[0]) | (bf16_bits(a[1]) << 16);
    return;
  }
#pragma unroll
  for (int i = 0; i < Tile::kPX; ++i)
    if (i < valid) store(p + i * sx, a[i]);
}

// ---------------------------------------------------------------------------
// The image gradients' store pass (warp_single.cu, warp_multiflow.cu).

// An image gradient from its f32 scratch: acc (B, G, H, W, 4), G = ceil(C /
// 4) groups of 4 channels → grad (B, C, H, W) in the image's dtype, through
// its strides; one thread a pixel, 256 a block, grid (ceil(W / 256), H, B).
template <typename T>
__global__ void __launch_bounds__(256)
grad_store_kernel(const float4* __restrict__ acc, T* __restrict__ grad, int C, int H, int W, Strides so) {
  const int x = blockIdx.x * 256 + threadIdx.x, y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const int groups = (C + 3) / 4;
  T* dst = grad + b * so.b + static_cast<int64_t>(y) * so.y + x * so.x;
  for (int q = 0; q < groups; ++q) {
    const float4 a = acc[(static_cast<int64_t>(b * groups + q) * H + y) * W + x];
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * q + k < C) store(dst + (4 * q + k) * so.c, v[k]);
  }
}

}  // namespace warp
