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
//
// The backward (warp_multiflow_grad_kernel) replaces the kernel's custom VJP,
// `_mfu_p_bwd` (warp_pallas.py:428-432: jax.vjp of the XLA planar warp, for
// f32 planes or bf16 planes upcast, with the output gradient upcast): the
// gradients of the planes, u and v for an output gradient g (B, C, n, H, W).
// bf16 planes and g are read as bf16 and summed in f32 (the upcast is exact),
// and the planes' gradient is rounded once, at its store.
//
// Bound: device-memory bandwidth. The planes, u, v and g read once, the three
// gradients written once: at the step's shapes (B=2, C=3, n=7, 736x1280)
// ~414 MB in f32 (0.1237 ms at 3.35 TB/s) and ~313 MB with bf16 planes
// (0.0934 ms). The planes' gradient is a scatter: 4 taps x C channels of each
// of the 13.2 M (pixel, flow) pairs, summed across the n flows.
//
// Design: one block a 64 x 8 output tile, looping over all n flows as the
// forward does, so the plane lines around the tile serve every flow's
// flow-gradient gather from L1. Each (pixel, flow) is visited once: its
// position, weights and masks serve both gradients. The planes' gradient is
// summed on chip: the block keeps its source window (the tile and 4 more
// pixels on each side) in shared memory and adds every tap inside it there; a
// tap outside it (large flows) goes to an f32 device scratch with a 16-byte
// vector atomic, so the kernel is exact for any flow. A thread owns two
// pixels of a column and the lanes of a warp adjacent columns, so the taps
// that neighbouring pixels share are summed in registers and across lanes
// before they reach shared memory (warp_multiflow_grad_kernel). After the n
// flows the block adds its window's touched pixels to the scratch with one
// vector atomic each, and a store pass writes the planes' dtype and memory
// format: a backward is 3 device operations (zero the scratch, the kernel,
// the store), 1 without the planes' gradient, whatever n. On the H100 this
// measured faster than two adjacent pixels a thread with their loads and
// stores 2 wide, and than a buffer of each block's window summed by a second
// pass (deterministic), at every tile and margin tried (PERF.md).

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

// ---------------------------------------------------------------------------
// The backward: the multi-flow warp's three gradients in one kernel.

// How the backward's blocks are cut (ops/warp_plan.py::plan_multiflow_grad).
struct MfGradPlan {
  int tile_w, tile_h;  // a block's output tile: tile_w * tile_h / 2 threads, whole warps along x
  int margin;     // source pixels kept in shared memory on each side of the tile
  int smem;       // dynamic shared memory bytes: the window of min(C, 4) channels
};

// The most threads a block of the backward has (ops/warp_plan.py:
// MF_GRAD_THREADS); 4 blocks an SM at 64 registers a thread.
constexpr int kMfGradThreads = 256;

// A block's source window: its tile, `margin` more on each side, and one more
// column and row for the right and bottom taps.
struct Window {
  int x0, y0, w, h;
};

__device__ __forceinline__ Window window_of(int bx, int by, const MfGradPlan& p) {
  return Window{bx * p.tile_w - p.margin, by * p.tile_h - p.margin, p.tile_w + 2 * p.margin + 1,
                p.tile_h + 2 * p.margin + 1};
}

// Where one block's taps of the planes' gradient go: inside the window, into
// shared memory (one f32 atomic a channel); outside, into the f32 scratch
// (one 16-byte vector atomic for the group's channels).
struct TapSink {
  float* win;    // [cg][w.h][w.w]
  float4* acc;   // this image's and group's (H, W) plane of the scratch
  Window w;
  int cg, W;

  __device__ __forceinline__ void add(int ty, int tx, const float* vals) const {
    const int lx = tx - w.x0, ly = ty - w.y0;
    if (static_cast<unsigned>(lx) < static_cast<unsigned>(w.w) &&
        static_cast<unsigned>(ly) < static_cast<unsigned>(w.h)) {
      float* p = win + ly * w.w + lx;
      const int plane = w.w * w.h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < cg) atomicAdd(p + j * plane, vals[j]);
    } else {
      atomicAdd(acc + static_cast<int64_t>(ty) * W + tx, make_float4(vals[0], vals[1], vals[2], vals[3]));
    }
  }

  // One tap of weight wt (masked: nothing) for the 4 channel values g.
  __device__ __forceinline__ void tap(bool m, int ty, int tx, float wt, const float* g) const {
    if (!m) return;
    const float vals[4] = {g[0] * wt, g[1] * wt, g[2] * wt, g[3] * wt};
    add(ty, tx, vals);
  }
};

// After its n flows: the block adds its window's in-image pixels that any tap
// reached to the scratch, one vector atomic each; a warp a window row.
__device__ __forceinline__ void flush_window(const float* win, float4* acc, const Window& w, int cg, int H,
                                             int W) {
  const int wsize = w.w * w.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int ly = warp; ly < w.h; ly += nwarps) {
    const int gy = w.y0 + ly;
    if (gy < 0 || gy >= H) continue;
    for (int lx = lane; lx < w.w; lx += 32) {
      const int gx = w.x0 + lx;
      if (gx < 0 || gx >= W) continue;
      const float* p = win + ly * w.w + lx;
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = j < cg ? p[j * wsize] : 0.0f;
      if (s[0] != 0.0f || s[1] != 0.0f || s[2] != 0.0f || s[3] != 0.0f)
        atomicAdd(acc + static_cast<int64_t>(gy) * W + gx, make_float4(s[0], s[1], s[2], s[3]));
    }
  }
}

// d/du and d/dv of one pixel's sample for one channel's output gradient gc:
// the four taps gathered (masked ones read as 0; floor() carries no gradient).
template <typename T>
__device__ __forceinline__ void flow_grad_taps(const Taps& t, const T* plane, int sy, int sx, float gc,
                                               float& du, float& dv) {
  const T* p00 = plane + (t.y0 * sy + t.x0 * sx);
  const float v00 = t.m00 ? load_f32(p00) : 0.0f;
  const float v01 = t.m01 ? load_f32(p00 + sx) : 0.0f;
  const float v10 = t.m10 ? load_f32(p00 + sy) : 0.0f;
  const float v11 = t.m11 ? load_f32(p00 + (sy + sx)) : 0.0f;
  du += gc * (t.ay * (v01 - v00) + t.wy * (v11 - v10));
  dv += gc * (t.ax * (v10 - v00) + t.wx * (v11 - v01));
}

// The gradients of warp_multiflow_kernel for the output gradient g (B, C, n,
// H, W). A block owns a tile_w x tile_h output tile of image b and channel
// group q (4 channels; blockIdx.z = b * groups + q) and loops over all n
// flows; kFlow (group 0 only) computes d/du and d/dv of each flow, kPlanes
// the planes' gradient of the group. A thread owns the pixels (x, y) and
// (x, y + 1) of one tile column, the 32 lanes of a warp 32 adjacent columns. Where the second pixel
// samples one row below the first (its taps' top row is the first's bottom
// row) the pair is aligned: its 8 taps fall on 3 rows x 2 columns, summed in
// registers, and its flow-gradient gather reads 6 taps a channel, not 8.
// Where the next lane's pair is aligned the same way one column right, this
// lane's right column is that lane's left column: it goes to that lane by a
// warp shuffle, and each lane adds only its left column (and its right one
// when no neighbour takes it). An aligned run of lanes makes 3 atomics a
// channel for 2 pixels, against 8 unmerged.
template <typename T, bool kPlanes, bool kFlow>
__global__ void __launch_bounds__(kMfGradThreads, 4)
warp_multiflow_grad_kernel(const T* __restrict__ planes, const float* __restrict__ u,
                           const float* __restrict__ v, const T* __restrict__ grad_out,
                           float* __restrict__ grad_u, float* __restrict__ grad_v, float4* __restrict__ acc,
                           int C, int groups, int n, int H, int W, Strides sp, Strides su, Strides sv,
                           Strides sg, int64_t sgk, MfGradPlan plan) {
  extern __shared__ float4 smem_f4[];
  float* win = reinterpret_cast<float*>(smem_f4);
  const int b = blockIdx.z / groups, q = blockIdx.z - b * groups;
  const int c0 = 4 * q, cg = min(4, C - c0);
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * plan.tile_w + threadIdx.x % plan.tile_w;
  const int y = blockIdx.y * plan.tile_h + 2 * (threadIdx.x / plan.tile_w);
  const int valid = x < W ? max(0, min(2, H - y)) : 0;  // this thread's pixels inside the image
  const Window w = window_of(blockIdx.x, blockIdx.y, plan);
  const TapSink sink{win, acc + static_cast<int64_t>(b * groups + q) * H * W, w, cg, W};
  if (kPlanes) {
    for (int i = threadIdx.x; i < cg * w.w * w.h; i += blockDim.x) win[i] = 0.0f;
    __syncthreads();
  }
  const bool flow = kFlow && q == 0;
  if (kPlanes || flow) {  // every lane runs the loop: the shuffles take the whole warp
    const int xc = min(x, W - 1), yc = min(y, H - 1);  // a pixel inside, for lanes with none
    const float* ub = u + b * su.b + static_cast<int64_t>(yc) * su.y + xc * su.x;
    const float* vb = v + b * sv.b + static_cast<int64_t>(yc) * sv.y + xc * sv.x;
    const T* gb = grad_out + b * sg.b + static_cast<int64_t>(yc) * sg.y + xc * sg.x;
    const T* img = planes + b * sp.b;
    const int sc = static_cast<int>(sp.c), sy = static_cast<int>(sp.y), sx = static_cast<int>(sp.x);
    for (int k = 0; k < n; ++k) {
      float uu[2] = {0.0f, 0.0f}, vv[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i < valid) {
          uu[i] = __ldg(ub + k * su.c + i * su.y);
          vv[i] = __ldg(vb + k * sv.c + i * sv.y);
        }
      }
      Taps t[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) t[i] = sample_taps(x, y + i, uu[i], vv[i], H, W);
      const bool al = valid == 2 && t[1].y0 == t[0].y0 + 1 && t[1].x0 == t[0].x0;
      const T* gk = gb + k * sgk;
      float gv[2][4];  // channels c0 .. c0+3 of each pixel, 0 past C
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) gv[i][j] = (j < cg && i < valid) ? load_f32(gk + (c0 + j) * sg.c + i * sg.y) : 0.0f;
      }
      if (flow) {  // group 0: c0 == 0, so gv holds channels 0..3
        float du[2] = {0.0f, 0.0f}, dv[2] = {0.0f, 0.0f};
        for (int c = 0; c < C; ++c) {
          float g0, g1;
          if (c < 4) {
            g0 = c == 0 ? gv[0][0] : c == 1 ? gv[0][1] : c == 2 ? gv[0][2] : gv[0][3];
            g1 = c == 0 ? gv[1][0] : c == 1 ? gv[1][1] : c == 2 ? gv[1][2] : gv[1][3];
          } else {
            g0 = valid > 0 ? load_f32(gk + c * sg.c) : 0.0f;
            g1 = valid > 1 ? load_f32(gk + c * sg.c + sg.y) : 0.0f;
          }
          const T* plane = img + c * sc;
          if (al) {  // rows y0, y0 + 1, y0 + 2 at columns x0, x0 + 1
            const Taps& a = t[0];
            const Taps& r = t[1];
            const T* p = plane + (a.y0 * sy + a.x0 * sx);
            const float a0 = a.m00 ? load_f32(p) : 0.0f, a1 = a.m01 ? load_f32(p + sx) : 0.0f;
            const float b0 = a.m10 ? load_f32(p + sy) : 0.0f, b1 = a.m11 ? load_f32(p + (sy + sx)) : 0.0f;
            const float e0 = r.m10 ? load_f32(p + 2 * sy) : 0.0f, e1 = r.m11 ? load_f32(p + (2 * sy + sx)) : 0.0f;
            du[0] += g0 * (a.ay * (a1 - a0) + a.wy * (b1 - b0));
            dv[0] += g0 * (a.ax * (b0 - a0) + a.wx * (b1 - a1));
            du[1] += g1 * (r.ay * (b1 - b0) + r.wy * (e1 - e0));
            dv[1] += g1 * (r.ax * (e0 - b0) + r.wx * (e1 - b1));
          } else {
            if (valid > 0) flow_grad_taps(t[0], plane, sy, sx, g0, du[0], dv[0]);
            if (valid > 1) flow_grad_taps(t[1], plane, sy, sx, g1, du[1], dv[1]);
          }
        }
        const int64_t o = static_cast<int64_t>(b * n + k) * H * W + static_cast<int64_t>(y) * W + x;
        if (valid > 0) {
          grad_u[o] = du[0];
          grad_v[o] = dv[0];
        }
        if (valid > 1) {
          grad_u[o + W] = du[1];
          grad_v[o + W] = dv[1];
        }
      }
      if (kPlanes) {
        const Taps& a = t[0];
        const Taps& r = t[1];
        // this lane's pair and its neighbours': anchor column and row, and
        // its shape (0: no pixel, 1: rows kept apart, 2: aligned)
        const int shape = valid == 0 ? 0 : al ? 2 : 1;
        const int nx = __shfl_down_sync(0xffffffffu, a.x0, 1), ny = __shfl_down_sync(0xffffffffu, a.y0, 1);
        const int ns = __shfl_down_sync(0xffffffffu, shape, 1);
        const int px = __shfl_up_sync(0xffffffffu, a.x0, 1), py = __shfl_up_sync(0xffffffffu, a.y0, 1);
        const int ps = __shfl_up_sync(0xffffffffu, shape, 1);
        const bool give = shape > 0 && lane < 31 && ns == shape && nx == a.x0 + 1 && ny == a.y0;
        const bool take = shape > 0 && lane > 0 && ps == shape && px + 1 == a.x0 && py == a.y0;
        const float w00 = __fmul_rn(a.ay, a.ax), w01 = __fmul_rn(a.ay, a.wx);
        const float w10 = __fmul_rn(a.wy, a.ax), w11 = __fmul_rn(a.wy, a.wx);
        const float r00 = al ? __fmul_rn(r.ay, r.ax) : 0.0f, r01 = al ? __fmul_rn(r.ay, r.wx) : 0.0f;
        const float r10 = al ? __fmul_rn(r.wy, r.ax) : 0.0f, r11 = al ? __fmul_rn(r.wy, r.wx) : 0.0f;
#pragma unroll
        for (int row = 0; row < 3; ++row) {
          // the row's two cells: pixel 0's taps, and pixel 1's where aligned
          const float l0 = row == 0 ? w00 : row == 1 ? w10 : 0.0f, l1 = row == 1 ? r00 : row == 2 ? r10 : 0.0f;
          const float q0 = row == 0 ? w01 : row == 1 ? w11 : 0.0f, q1 = row == 1 ? r01 : row == 2 ? r11 : 0.0f;
          float left[4], right[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            left[j] = gv[0][j] * l0 + gv[1][j] * l1;
            right[j] = gv[0][j] * q0 + gv[1][j] * q1;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < cg) {  // cg is the block's: every lane shuffles alike
              const float from_left = __shfl_up_sync(0xffffffffu, right[j], 1);
              if (take) left[j] += from_left;
            }
          }
          const int ty = a.y0 + row;
          if (shape > 0 && (row < 2 || al) && ty >= 0 && ty < H) {
            if (a.x0 >= 0 && a.x0 < W) sink.add(ty, a.x0, left);
            if (!give && a.x0 + 1 >= 0 && a.x0 + 1 < W) sink.add(ty, a.x0 + 1, right);
          }
        }
        if (shape == 1 && valid == 2) {  // pixel 1 apart: its own 4 taps
          sink.tap(r.m00, r.y0, r.x0, __fmul_rn(r.ay, r.ax), gv[1]);
          sink.tap(r.m01, r.y0, r.x0 + 1, __fmul_rn(r.ay, r.wx), gv[1]);
          sink.tap(r.m10, r.y0 + 1, r.x0, __fmul_rn(r.wy, r.ax), gv[1]);
          sink.tap(r.m11, r.y0 + 1, r.x0 + 1, __fmul_rn(r.wy, r.wx), gv[1]);
        }
      }
    }
  }
  if (!kPlanes) return;
  __syncthreads();
  flush_window(win, sink.acc, w, cg, H, W);
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

template <typename T, bool kPlanes, bool kFlow>
cudaError_t launch_grad_kernel(dim3 grid, int threads, cudaStream_t stream, const T* planes, const float* u,
                               const float* v, const T* g, float* gu, float* gv, float4* acc, int C, int groups,
                               int n, int H, int W, const int64_t* s, const MfGradPlan& plan) {
  warp_multiflow_grad_kernel<T, kPlanes, kFlow><<<grid, threads, kPlanes ? plan.smem : 0, stream>>>(
      planes, u, v, g, gu, gv, acc, C, groups, n, H, W, Strides{s[0], s[1], s[2], s[3]},
      Strides{s[4], s[5], s[6], s[7]}, Strides{s[8], s[9], s[10], s[11]}, Strides{s[12], s[13], s[15], s[16]},
      s[14], plan);
  return cudaGetLastError();
}

// Zero the scratch, run the kernel, finish the planes' gradient (without the
// planes' gradient: the kernel alone). s: the 21 element strides of planes
// (b, c, y, x), u, v (b, k, y, x), grad_out (b, c, k, y, x), grad_planes (b,
// c, y, x).
template <typename T>
cudaError_t launch_grad(const void* planes, const float* u, const float* v, const void* grad_out,
                        void* grad_planes, float* gu, float* gv, float4* acc, bool need_planes,
                        bool need_flow, int B, int C, int n, int H, int W, const int64_t* s,
                        const MfGradPlan& plan, cudaStream_t stream) {
  const T* p = static_cast<const T*>(planes);
  const T* g = static_cast<const T*>(grad_out);
  const int groups = need_planes ? (C + 3) / 4 : 1;
  const int nbx = (W + plan.tile_w - 1) / plan.tile_w, nby = (H + plan.tile_h - 1) / plan.tile_h;
  const dim3 grid(nbx, nby, B * groups);
  const int threads = plan.tile_w * plan.tile_h / 2;
  cudaError_t err;
  if (need_planes) {
    err = cudaMemsetAsync(acc, 0, static_cast<size_t>(B) * groups * H * W * sizeof(float4), stream);
    if (err != cudaSuccess) return err;
    err = need_flow ? launch_grad_kernel<T, true, true>(grid, threads, stream, p, u, v, g, gu, gv, acc, C,
                                                        groups, n, H, W, s, plan)
                    : launch_grad_kernel<T, true, false>(grid, threads, stream, p, u, v, g, gu, gv, acc,
                                                         C, groups, n, H, W, s, plan);
    if (err != cudaSuccess) return err;
    const Strides so{s[17], s[18], s[19], s[20]};
    const dim3 rows((W + 255) / 256, H, B);
    grad_store_kernel<T><<<rows, 256, 0, stream>>>(acc, static_cast<T*>(grad_planes), C, H, W, so);
    return cudaGetLastError();
  }
  return launch_grad_kernel<T, false, true>(grid, threads, stream, p, u, v, g, gu, gv, acc, C, groups, n,
                                            H, W, s, plan);
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

// The three gradients of warp_multiflow_planar for grad_out (B, C, n, H, W) in
// the planes' dtype, any strides: grad_planes (B, C, H, W) in the planes'
// dtype (need_planes), grad_u and grad_v (B, n, H, W) f32 contiguous
// (need_flow). scratch: B * ceil(C/4) * H * W float4 (need_planes).
// strides: 21 element strides, planes (b, c, y, x), u, v (b, k, y, x),
// grad_out (b, c, k, y, x), grad_planes (b, c, y, x). plan: the 4 ints of
// MfGradPlan (ops/warp_plan.py). Returns the first CUDA error (0: launched).
extern "C" int warp_multiflow_grad(const void* planes, const void* u, const void* v, const void* grad_out,
                                   void* grad_planes, void* grad_u, void* grad_v, void* scratch,
                                   int bf16, int need_planes, int need_flow, int B, int C, int n, int H, int W,
                                   const int64_t* strides, const int* plan, void* stream) {
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  float* gu = static_cast<float*>(grad_u);
  float* gv = static_cast<float*>(grad_v);
  float4* acc = static_cast<float4*>(scratch);
  const MfGradPlan p{plan[0], plan[1], plan[2], plan[3]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_grad<__nv_bfloat16>(planes, uf, vf, grad_out, grad_planes, gu, gv, acc,
                                                       need_planes, need_flow, B, C, n, H, W, strides, p, s));
  return static_cast<int>(launch_grad<float>(planes, uf, vf, grad_out, grad_planes, gu, gv, acc, need_planes,
                                             need_flow, B, C, n, H, W, strides, p, s));
}
