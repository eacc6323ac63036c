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
// (~64 MB, ~19 us). Read through the step's views, a 32-pixel warp access
// spans 4 (flow) to 6 (image) times the bytes it uses, so one-thread-per-pixel
// code is paced by L1 wavefronts and load/store instructions, not by bytes.
//
// Design: the sample position and the four weights are computed once per
// pixel and reused for all C channels, with the round-to-nearest intrinsics
// in the plain version's order (((v00*w00 + v01*w01) + v10*w10) + v11*w11),
// so no FMA contraction separates the kernels from the plain version
// (ops/warp.py).
// - Forward: the tiled design of warp_tile.cuh: a block owns a 2-D output
//   tile, a thread 2 pixels of it; each pixel's (u, v) is one 8-byte load
//   where the pair is adjacent; a channels_last output goes out through a
//   shared tile as contiguous 16-byte row stores.
// - Backward: one thread per output pixel (b, y, x), x fastest.
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

#include "warp_tile.cuh"

namespace {

using namespace warp;

constexpr int kThreads = 256;  // the backward kernel's block

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
cudaError_t launch_forward(const void* img, const float* flow, void* out, int B, int C, int H, int W,
                           const int64_t* s, const Plan& plan, cudaStream_t stream) {
  const dim3 grid((W + Tile::kW - 1) / Tile::kW, (H + Tile::kH - 1) / Tile::kH, B);
  warp_single_forward_kernel<T><<<grid, Tile::kThreads, plan.smem, stream>>>(
      static_cast<const T*>(img), flow, static_cast<T*>(out), C, H, W, strides_at(s),
      strides_at(s + 4), strides_at(s + 8), plan);
  return cudaGetLastError();
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
