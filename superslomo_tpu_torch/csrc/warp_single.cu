// Single-flow bilinear backward warp and its two gradients, for Hopper (sm_90a).
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
// Bounds (chip_smoke.single_bounds: each input read once, each output
// written once, over 3.35 TB/s; all three are bound by bytes, not
// operations). At the training shape (B=32, C=3, 224x224, f32):
// - forward: the image (19.3 MB) and the flow (12.8 MB) in, the output
//   (19.3 MB) out: 0.0153 ms;
// - flow gradient: the image, the output gradient and the flow in, the flow
//   gradient out (64.2 MB): 0.0192 ms;
// - image gradient: the output gradient and the flow in, the image gradient
//   out (51.4 MB): 0.0153 ms.
// Read through the step's views (a frame of a 6-channel pair, a flow of a
// 4-channel head) the kernels touch up to twice those bytes, and a gather's
// taps come through L1 and L2 several times over.
//
// Design: the sample position and the four weights are computed once per
// pixel and reused for all C channels. The forward keeps the round-to-nearest
// intrinsics in the plain version's order (((v00*w00 + v01*w01) + v10*w10) +
// v11*w11), so no FMA contraction separates it from the plain version
// (ops/warp.py); the gradients are held to it within a few f32 ulps.
// - Forward: the tiled design of warp_tile.cuh: a block owns a 2-D output
//   tile, a thread 2 adjacent pixels of it; each pixel's (u, v) is one 8-byte
//   load where the pair is adjacent; a channels_last output goes out through
//   a shared tile as contiguous 16-byte row stores.
// - Gradients: they replace the custom VJP of the Pallas kernel
//   (superslomo_tpu/ops/warp_pallas.py:663-666, XLA's VJP of ops/warp.py),
//   which the training step needs; floor() carries no gradient and masked
//   taps contribute nothing to either gradient, as in JAX. Each is its own
//   kernel, launched only when its gradient is asked for (the training step
//   asks only for the flow's: its images are data).
// - Flow gradient (warp_single_flow_grad_kernel): a gather, on the forward's
//   tiles. It replaced a kernel of one pixel a thread on a 1-D grid (a 64-bit
//   division a pixel, u and v as two scalar loads) that took 0.062 ms on
//   noise flows. Each thread owns 2 pixels of a tile row 32 apart, so every
//   load and store instruction of a warp covers 32 consecutive pixels, and
//   indexes inside one image with 32-bit ints: 40 registers, 6 blocks an SM.
// - Image gradient (warp_single_img_grad_kernel): a scatter. It replaced 12
//   scalar f32 atomics a pixel (4 taps x C=3) into a zero-filled f32 buffer
//   and a cast pass (0.21 ms, paced by the atomics). Now each tap adds the
//   C <= 4 channels of a group as one 16-byte vector atomic (global memory,
//   sm_90) into an f32 scratch laid out (B, ceil(C/4), H, W, 4): 4 atomics a
//   pixel, 3 where a thread's two adjacent pixels share taps; one pass then
//   stores the image's dtype and memory format. The launch zeroes the
//   scratch first. Summing the taps of the block's source window in shared
//   memory first measured slower (PERF.md). The summation order follows the
//   atomics and varies from run to run: results agree with the plain
//   version's autograd within 1e-5 of the largest |gradient|
//   (chip_smoke.GRAD_KERNEL_REL), plus one rounding to bf16 for a bf16 image.
// Positions are clamped to [-2, W+1] x [-2, H+1] before the float->int
// conversion (out of range is undefined on CUDA); every tap of a clamped
// position lies outside and is masked, so its value and gradient are 0 either
// way. Offsets are 64-bit, except inside one image in the flow gradient
// (32-bit; the wrapper checks that they fit).

#include "warp_tile.cuh"

namespace {

using namespace warp;

// The forward kernel (warp_tile.cuh's tiled design). Each thread reads its
// kPX pixels' flows and samples them once for all C channels. With kOutRows
// (a dense channels_last output) the block writes its results to a shared
// tile and then stores each tile row, kW * C contiguous values, with 16-byte
// stores where aligned; otherwise each thread stores its pixels.
template <typename T>
__global__ void __launch_bounds__(Tile::kThreads)
warp_single_forward_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                           T* __restrict__ out, int C, int H, int W, Strides si, Strides sf,
                           Strides so, Plan plan) {
  extern __shared__ float4 smem_f4[];
  T* out_tile = reinterpret_cast<T*>(smem_f4);  // kH rows of kW * C values
  constexpr int kPX = Tile::kPX;
  const int b = blockIdx.z;
  const int col = (threadIdx.x % Tile::kCols) * kPX, row = threadIdx.x / Tile::kCols;
  const int tx0 = blockIdx.x * Tile::kW, ty0 = blockIdx.y * Tile::kH;
  const int x = tx0 + col, y = ty0 + row;
  const int valid = y < H ? min(kPX, W - x) : 0;  // this thread's pixels inside the image
  const T* src = img + b * si.b;

  if (valid > 0) {
    const float* f = flow + b * sf.b + static_cast<int64_t>(y) * sf.y + x * sf.x;
    float uu[kPX], vv[kPX];
    load_uv(f, sf.x, f + sf.c, sf.x, plan.flow_mode, valid, uu, vv);
    Sample s[kPX];
#pragma unroll
    for (int i = 0; i < kPX; ++i) s[i] = make_sample(x + i, y, uu[i], vv[i], H, W);
    for (int c = 0; c < C; ++c) {
      float acc[kPX];
#pragma unroll
      for (int i = 0; i < kPX; ++i) acc[i] = bilinear(s[i], src, si, c);
      if (plan.out_mode == kOutRows) {
#pragma unroll
        for (int i = 0; i < kPX; ++i)
          if (i < valid) store(out_tile + (row * Tile::kW + col + i) * C + c, acc[i]);
      } else {
        T* dst = out + b * so.b + c * so.c + static_cast<int64_t>(y) * so.y + x * so.x;
        store_px(dst, acc, so.x, plan.out_mode, valid);
      }
    }
  }
  if (plan.out_mode != kOutRows) return;

  // out is dense channels_last (so.c == 1, so.x == C): a tile row is one span
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = min(Tile::kW, W - tx0) * C;  // values of one tile row inside the image
  for (int r = warp; r < Tile::kH; r += Tile::kWarps) {
    if (ty0 + r >= H) break;
    T* dst = out + b * so.b + static_cast<int64_t>(ty0 + r) * so.y + tx0 * so.x;
    const T* row_vals = out_tile + r * Tile::kW * C;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 && (span * sizeof(T)) % 16 == 0) {
      const int chunks = static_cast<int>(span * sizeof(T) / 16);
      for (int k = lane; k < chunks; k += 32)
        reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(row_vals)[k];
    } else {
      for (int e = lane; e < span; e += 32) dst[e] = row_vals[e];
    }
  }
}

// The flow gradient of the custom VJP at warp_pallas.py:663-666. Bound at the
// training shape: 64.2 MB, 0.0192 ms (bytes). The kernel it replaced gave
// each thread one pixel, one chain of dependent loads; this one gives each
// thread two independent pixels at the same 40 registers (6 blocks an SM),
// so twice the loads are in flight.
// A gather with no atomics, on warp_tile.cuh's tiles: a block owns a
// Tile::kW x Tile::kH tile, a thread Tile::kPX pixels of one tile row,
// Tile::kCols apart, so every load and store instruction of a warp covers 32
// consecutive pixels (2 adjacent pixels a thread measured slower here: each
// tap instruction then spans twice the lines; PERF.md). Each thread samples
// its pixels and, for each channel, gathers the four taps and adds
//   d/du += g_c [(1-wy)(v01 - v00) + wy(v11 - v10)],
//   d/dv += g_c [(1-wx)(v10 - v00) + wx(v11 - v01)],
// with masked taps read as 0 (floor() carries no gradient). Offsets inside
// one image are 32-bit (the wrapper checks that they fit): with 64-bit ones
// the kernel took 48 registers, 5 blocks an SM. grad_out has the image's
// dtype (autograd hands back the output's dtype).
template <typename T>
__global__ void __launch_bounds__(Tile::kThreads)
warp_single_flow_grad_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                             const T* __restrict__ grad_out, float* __restrict__ grad_flow, int C,
                             int H, int W, Strides si, Strides sf, Strides sg, Strides sgf,
                             GradPlan plan) {
  constexpr int kPX = Tile::kPX, kStep = Tile::kCols;  // a thread's pixels are kStep apart
  static_assert(kPX == 2, "`valid` below counts two pixels");
  const int b = blockIdx.z;
  const int x = blockIdx.x * Tile::kW + threadIdx.x % kStep, y = blockIdx.y * Tile::kH + threadIdx.x / kStep;
  if (y >= H || x >= W) return;
  const int valid = x + kStep < W ? kPX : 1;  // this thread's pixels inside the image
  const float* f = flow + b * sf.b + static_cast<int64_t>(y) * sf.y + x * sf.x;
  const T* g = grad_out + b * sg.b + static_cast<int64_t>(y) * sg.y + x * sg.x;
  float* gf = grad_flow + b * sgf.b + static_cast<int64_t>(y) * sgf.y + x * sgf.x;

  float uu[kPX], vv[kPX];
  load_uv(f, kStep * sf.x, f + sf.c, kStep * sf.x, plan.flow_mode, valid, uu, vv);
  Taps t[kPX];
#pragma unroll
  for (int i = 0; i < kPX; ++i) t[i] = sample_taps(x + i * kStep, y, uu[i], vv[i], H, W);
  const T* src = img + b * si.b;
  const int sc = static_cast<int>(si.c), sy = static_cast<int>(si.y), sx = static_cast<int>(si.x);
  float du[kPX], dv[kPX];
#pragma unroll
  for (int i = 0; i < kPX; ++i) du[i] = dv[i] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const T* plane = src + c * sc;
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      if (i < valid) {
        const float gc = load_f32(g + c * sg.c + i * kStep * sg.x);
        const T* p00 = plane + (t[i].y0 * sy + t[i].x0 * sx);
        const float v00 = t[i].m00 ? load_f32(p00) : 0.0f;
        const float v01 = t[i].m01 ? load_f32(p00 + sx) : 0.0f;
        const float v10 = t[i].m10 ? load_f32(p00 + sy) : 0.0f;
        const float v11 = t[i].m11 ? load_f32(p00 + (sy + sx)) : 0.0f;
        du[i] += gc * (t[i].ay * (v01 - v00) + t[i].wy * (v11 - v10));
        dv[i] += gc * (t[i].ax * (v10 - v00) + t[i].wx * (v11 - v01));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    if (i < valid) {
      float* p = gf + i * kStep * sgf.x;
      if (plan.out_mode == kOutPair) {
        *reinterpret_cast<float2*>(p) = make_float2(du[i], dv[i]);
      } else {
        p[0] = du[i];
        p[sgf.c] = dv[i];
      }
    }
  }
}

// Channel c of a thread's kPX adjacent output-gradient values (0 past
// `valid`), the first at g; kInPlanarVec: one aligned kPX-wide load.
template <typename T>
__device__ __forceinline__ void load_grad(const T* g, const Strides& s, int c, int mode, int valid,
                                          float* out) {
  if (mode == kInPlanarVec) {
    const float2 p = load_f32x2(g + c * s.c);
    out[0] = p.x;
    out[1] = p.y;
    return;
  }
#pragma unroll
  for (int i = 0; i < Tile::kPX; ++i) out[i] = i < valid ? load_f32(g + c * s.c + i * s.x) : 0.0f;
}

// acc += w * g (4 channels) with one vector atomic (global memory, sm_90).
__device__ __forceinline__ void scatter4(float4* acc, float w, const float* g) {
  atomicAdd(acc, make_float4(g[0] * w, g[1] * w, g[2] * w, g[3] * w));
}

// The image gradient of the custom VJP at warp_pallas.py:663-666. Bound at
// the training shape: 51.4 MB, 0.0153 ms (bytes). The kernel it replaced was
// paced by its 12 scalar global atomics a pixel; this one makes 3 to 4
// vector atomics a pixel.
// The image gradient's scatter, on warp_tile.cuh's tiles with 2 adjacent
// pixels a thread: each tap of each pixel adds w * g of 4 channels to the f32
// scratch acc, laid out (B, G, H, W, 4) with G = ceil(C / 4) groups of
// channels, as one 16-byte vector atomic. Where a thread's second pixel
// samples one column right of its first (smooth flows), their shared taps
// are summed first: 6 atomics for the pair instead of 8.
template <typename T>
__global__ void __launch_bounds__(Tile::kThreads)
warp_single_img_grad_kernel(const float* __restrict__ flow, const T* __restrict__ grad_out,
                            float4* __restrict__ acc, int C, int H, int W, Strides sf, Strides sg,
                            GradPlan plan) {
  constexpr int kPX = Tile::kPX;
  static_assert(kPX == 2, "the shared-tap merge below pairs two pixels");
  const int b = blockIdx.z;
  const int x = blockIdx.x * Tile::kW + (threadIdx.x % Tile::kCols) * kPX;
  const int y = blockIdx.y * Tile::kH + threadIdx.x / Tile::kCols;
  if (y >= H || x >= W) return;
  const int valid = min(kPX, W - x);  // this thread's pixels inside the image

  const float* f = flow + b * sf.b + static_cast<int64_t>(y) * sf.y + x * sf.x;
  float uu[kPX], vv[kPX];
  load_uv(f, sf.x, f + sf.c, sf.x, plan.flow_mode, valid, uu, vv);
  Sample s[kPX];
#pragma unroll
  for (int i = 0; i < kPX; ++i) s[i] = make_sample(x + i, y, uu[i], vv[i], H, W);
  const bool merge = valid == kPX && s[1].y0 == s[0].y0 && s[1].x0 == s[0].x0 + 1;
  const T* g = grad_out + b * sg.b + static_cast<int64_t>(y) * sg.y + x * sg.x;
  const int groups = (C + 3) / 4;
  for (int q = 0; q < groups; ++q) {
    float gv[kPX][4];  // channels 4q .. 4q+3 of each pixel, 0 past C
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float gc[kPX] = {0.0f, 0.0f};
      if (4 * q + k < C) load_grad(g, sg, 4 * q + k, plan.grad_mode, valid, gc);
#pragma unroll
      for (int i = 0; i < kPX; ++i) gv[i][k] = gc[i];
    }
    float4* plane = acc + static_cast<int64_t>(b * groups + q) * H * W;
    const Sample& a = s[0];
    float4* p = plane + static_cast<int64_t>(a.y0) * W + a.x0;
    if (a.m00) scatter4(p, a.w00, gv[0]);
    if (a.m10) scatter4(p + W, a.w10, gv[0]);
    if (merge) {  // pixel 1's left taps are pixel 0's right taps
      const Sample& n = s[1];
      float m0[4], m1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m0[k] = gv[0][k] * a.w01 + gv[1][k] * n.w00;
        m1[k] = gv[0][k] * a.w11 + gv[1][k] * n.w10;
      }
      if (a.m01) scatter4(p + 1, 1.0f, m0);
      if (a.m11) scatter4(p + W + 1, 1.0f, m1);
      if (n.m01) scatter4(p + 2, n.w01, gv[1]);
      if (n.m11) scatter4(p + W + 2, n.w11, gv[1]);
      continue;
    }
    if (a.m01) scatter4(p + 1, a.w01, gv[0]);
    if (a.m11) scatter4(p + W + 1, a.w11, gv[0]);
    if (valid < kPX) continue;
    const Sample& n = s[1];
    float4* pn = plane + static_cast<int64_t>(n.y0) * W + n.x0;
    if (n.m00) scatter4(pn, n.w00, gv[1]);
    if (n.m01) scatter4(pn + 1, n.w01, gv[1]);
    if (n.m10) scatter4(pn + W, n.w10, gv[1]);
    if (n.m11) scatter4(pn + W + 1, n.w11, gv[1]);
  }
}

Strides strides_at(const int64_t* s) { return Strides{s[0], s[1], s[2], s[3]}; }

dim3 tile_grid(int B, int H, int W) {
  return dim3((W + Tile::kW - 1) / Tile::kW, (H + Tile::kH - 1) / Tile::kH, B);
}

template <typename T>
cudaError_t launch_forward(const void* img, const float* flow, void* out, int B, int C, int H, int W,
                           const int64_t* s, const Plan& plan, cudaStream_t stream) {
  warp_single_forward_kernel<T><<<tile_grid(B, H, W), Tile::kThreads, plan.smem, stream>>>(
      static_cast<const T*>(img), flow, static_cast<T*>(out), C, H, W, strides_at(s),
      strides_at(s + 4), strides_at(s + 8), plan);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flow_grad(const void* img, const float* flow, const void* grad_out,
                             float* grad_flow, int B, int C, int H, int W, const int64_t* s,
                             const GradPlan& plan, cudaStream_t stream) {
  warp_single_flow_grad_kernel<T><<<tile_grid(B, H, W), Tile::kThreads, 0, stream>>>(
      static_cast<const T*>(img), flow, static_cast<const T*>(grad_out), grad_flow, C, H, W,
      strides_at(s), strides_at(s + 4), strides_at(s + 8), strides_at(s + 12), plan);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_img_grad(const float* flow, const void* grad_out, float4* acc, void* grad_img,
                            int B, int C, int H, int W, const int64_t* s, const GradPlan& plan,
                            cudaStream_t stream) {
  const size_t acc_bytes = static_cast<size_t>(B) * ((C + 3) / 4) * H * W * sizeof(float4);
  cudaError_t err = cudaMemsetAsync(acc, 0, acc_bytes, stream);
  if (err != cudaSuccess) return err;
  warp_single_img_grad_kernel<T><<<tile_grid(B, H, W), Tile::kThreads, 0, stream>>>(
      flow, static_cast<const T*>(grad_out), acc, C, H, W, strides_at(s), strides_at(s + 4), plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_store_kernel<T><<<dim3((W + 255) / 256, H, B), 256, 0, stream>>>(
      acc, static_cast<T*>(grad_img), C, H, W, strides_at(s + 8));
  return cudaGetLastError();
}

}  // namespace

// img (B, C, H, W) f32 or bf16; flow (B, 2, H, W) f32; out (B, C, H, W) in the
// image's dtype; all on one device, any strides. strides: 12 element strides
// (b, c, y, x) of img, flow, out. plan: the 3 ints of Plan
// (ops/warp_plan.py). Returns the launch's CUDA error (0: launched).
extern "C" int warp_single_forward(const void* img, const void* flow, void* out, int bf16, int B,
                                   int C, int H, int W, const int64_t* strides, const int* plan,
                                   void* stream) {
  const float* f = static_cast<const float*>(flow);
  const Plan p{plan[0], plan[1], plan[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return static_cast<int>(launch_forward<__nv_bfloat16>(img, f, out, B, C, H, W, strides, p, s));
  return static_cast<int>(launch_forward<float>(img, f, out, B, C, H, W, strides, p, s));
}

// The flow gradient of the forward above. grad_out (B, C, H, W) in the
// image's dtype; grad_flow (B, 2, H, W) f32. strides: 16 element strides (b,
// c, y, x) of img, flow, grad_out, grad_flow. plan: the 3 ints of GradPlan
// (ops/warp_plan.py). Returns the launch's CUDA error (0: launched).
extern "C" int warp_single_flow_grad(const void* img, const void* flow, const void* grad_out,
                                     void* grad_flow, int bf16, int B, int C, int H, int W,
                                     const int64_t* strides, const int* plan, void* stream) {
  const float* f = static_cast<const float*>(flow);
  float* gf = static_cast<float*>(grad_flow);
  const GradPlan p{plan[0], plan[1], plan[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_flow_grad<__nv_bfloat16>(img, f, grad_out, gf, B, C, H, W, strides, p, s));
  return static_cast<int>(launch_flow_grad<float>(img, f, grad_out, gf, B, C, H, W, strides, p, s));
}

// The image gradient of the forward above: zero the scratch, scatter into it,
// store grad_img. grad_out (B, C, H, W) in the image's dtype; scratch: B *
// ceil(C/4) * H * W float4, 16-byte aligned; grad_img (B, C, H, W) in the
// image's dtype. strides: 12 element strides (b, c, y, x) of flow, grad_out,
// grad_img. plan: the 3 ints of GradPlan. Returns the first CUDA error (0:
// launched).
extern "C" int warp_single_img_grad(const void* flow, const void* grad_out, void* scratch,
                                    void* grad_img, int bf16, int B, int C, int H, int W,
                                    const int64_t* strides, const int* plan, void* stream) {
  const float* f = static_cast<const float*>(flow);
  float4* acc = static_cast<float4*>(scratch);
  const GradPlan p{plan[0], plan[1], plan[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(launch_img_grad<__nv_bfloat16>(f, grad_out, acc, grad_img, B, C, H, W, strides, p, s));
  return static_cast<int>(launch_img_grad<float>(f, grad_out, acc, grad_img, B, C, H, W, strides, p, s));
}
