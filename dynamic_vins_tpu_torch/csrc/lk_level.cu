// One pyramid level of iterative Lucas-Kanade for N features (Hopper).
//
// Replaces the TPU kernel dynamic_vins_tpu/ops/lk_pallas.py (lk_level,
// body _make_kernel, sampler _bilinear_patch) and computes what that
// kernel computes, not how it tiles:
//   * each feature sees img0/img1 only through a WIN_H x WIN_W window
//     whose origin the wrapper snapped to the (8, 128) tiling (the
//     `meta` rows); reads outside the window are zero (the Pallas
//     one-hot selectors have no match there);
//   * the (2r+1)^2 template and its x/y gradient patches are bilinear
//     samples of window 0; the gradients are central differences of
//     patches shifted by +-1 px (not Scharr);
//   * bilinear weights apply rows first, then columns (R @ win @ C);
//   * ok = det(structure tensor) > 1e-6, then `iters` Newton updates of
//     the flow against window 1, whose patch origin is clamped to
//     [0, WIN - P - 2] (flows that leave the window saturate).
//
// What bounds it on this card: the work is tiny (~1e5 flops and 21x21
// gathers per feature, N = 150), far below both the bandwidth and the
// float32 roofline, so a launch is bound by latency: the dependent
// chain of `iters` block reductions and the gather latency of each
// patch read. Design (the simple one): one block per feature, one thread
// per patch pixel (441 of 448 threads for r = 10); template and gradient
// values stay in registers across the iterations; each iteration is one
// gathered patch read + one two-value block reduction (warp shuffles,
// then every thread sums the per-warp partials in a fixed order, so the
// flow update is identical and deterministic in all threads). Window
// semantics are index checks on global reads. The block sums accumulate
// float32 products in double and round once: the kernel and its plain
// version (which sums in float64 too) then agree to rounding even for
// ill-conditioned features, whose Newton step amplifies any difference
// in summation order (the Pallas kernel sums in float32). Staging the
// windows in shared memory and packing several features per block are
// left to a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

#define WIN_H 48
#define WIN_W 256
#define MAX_WARPS 32

// window read: zero outside the window, else the padded image
__device__ __forceinline__ float win_at(const float* __restrict__ img,
                                        int W, int oy, int ox, int r,
                                        int c) {
  if (r < 0 || r >= WIN_H || c < 0 || c >= WIN_W) return 0.0f;
  return __ldg(img + (size_t)(oy + r) * W + (ox + c));
}

// bilinear sample of patch pixel (p, q) at window-local top-left (ly, lx)
__device__ __forceinline__ float patch_at(const float* __restrict__ img,
                                          int W, int oy, int ox, float ly,
                                          float lx, int p, int q) {
  const float iyf = floorf(ly), ixf = floorf(lx);
  const float fy = ly - iyf, fx = lx - ixf;
  const int r0 = (int)iyf + p, c0 = (int)ixf + q;
  // rows first (R @ win), then columns (@ C)
  const float t0 = (1.0f - fy) * win_at(img, W, oy, ox, r0, c0)
                   + fy * win_at(img, W, oy, ox, r0 + 1, c0);
  const float t1 = (1.0f - fy) * win_at(img, W, oy, ox, r0, c0 + 1)
                   + fy * win_at(img, W, oy, ox, r0 + 1, c0 + 1);
  return (1.0f - fx) * t0 + fx * t1;
}

// sum of (a, b) over the block, accumulated in double and rounded to
// float once; every thread gets the same result
__device__ __forceinline__ void block_sum2(double a, double b, double* sm,
                                           int nwarps, float* A,
                                           float* B) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[2 * warp] = a;
    sm[2 * warp + 1] = b;
  }
  __syncthreads();
  double sa = 0.0, sb = 0.0;
  for (int w = 0; w < nwarps; ++w) {
    sa += sm[2 * w];
    sb += sm[2 * w + 1];
  }
  __syncthreads();  // the partials are rewritten by the next call
  *A = (float)sa;
  *B = (float)sb;
}

__global__ void lk_level_kernel(const float* __restrict__ img0,
                                const float* __restrict__ img1, int W,
                                const float* __restrict__ pts,
                                const float* __restrict__ guess,
                                const int32_t* __restrict__ meta,
                                int radius, int iters,
                                float* __restrict__ flow,
                                uint8_t* __restrict__ ok) {
  __shared__ double sm[2 * MAX_WARPS];
  const int i = blockIdx.x;
  const int P = 2 * radius + 1;
  const int t = threadIdx.x;
  const bool live = t < P * P;
  const int p = live ? t / P : 0, q = live ? t % P : 0;
  const int nwarps = blockDim.x >> 5;

  const int oy0 = meta[4 * i + 0], ox0 = meta[4 * i + 1];
  const int oy1 = meta[4 * i + 2], ox1 = meta[4 * i + 3];
  const float x = pts[2 * i + 0], y = pts[2 * i + 1];
  const float tl_y = (y - (float)oy0) - (float)radius;
  const float tl_x = (x - (float)ox0) - (float)radius;

  float tmpl = 0.0f, gx = 0.0f, gy = 0.0f;
  if (live) {
    tmpl = patch_at(img0, W, oy0, ox0, tl_y, tl_x, p, q);
    gx = 0.5f * (patch_at(img0, W, oy0, ox0, tl_y, tl_x + 1.0f, p, q)
                 - patch_at(img0, W, oy0, ox0, tl_y, tl_x - 1.0f, p, q));
    gy = 0.5f * (patch_at(img0, W, oy0, ox0, tl_y + 1.0f, tl_x, p, q)
                 - patch_at(img0, W, oy0, ox0, tl_y - 1.0f, tl_x, p, q));
  }
  float a11, a12, a22, unused;
  block_sum2(gx * gx, gx * gy, sm, nwarps, &a11, &a12);
  block_sum2(gy * gy, 0.0f, sm, nwarps, &a22, &unused);
  const float det = a11 * a22 - a12 * a12;
  const bool good = det > 1e-6f;
  const float inv_det = good ? 1.0f / fmaxf(det, 1e-6f) : 0.0f;

  float gu = guess[2 * i + 0], gv = guess[2 * i + 1];
  const float hi_y = (float)(WIN_H - P - 2), hi_x = (float)(WIN_W - P - 2);
  for (int it = 0; it < iters; ++it) {
    float l1y = ((y + gv) - (float)oy1) - (float)radius;
    float l1x = ((x + gu) - (float)ox1) - (float)radius;
    l1y = fminf(fmaxf(l1y, 0.0f), hi_y);
    l1x = fminf(fmaxf(l1x, 0.0f), hi_x);
    float d = 0.0f;
    if (live) d = patch_at(img1, W, oy1, ox1, l1y, l1x, p, q) - tmpl;
    float b1, b2;
    block_sum2(d * gx, d * gy, sm, nwarps, &b1, &b2);
    const float du = -(a22 * b1 - a12 * b2) * inv_det;
    const float dv = -(-a12 * b1 + a11 * b2) * inv_det;
    gu += du;
    gv += dv;
  }
  if (t == 0) {
    flow[2 * i + 0] = gu;
    flow[2 * i + 1] = gv;
    ok[i] = good ? 1 : 0;
  }
}

// C entry point: launches on `stream`, returns cudaGetLastError().
// img0/img1: [H, W] float32, padded so every window lies inside; pts,
// guess, flow: [n, 2] float32; meta: [n, 4] int32 window origins
// (oy0, ox0, oy1, ox1); ok: [n] bytes.
extern "C" int lk_level_launch(const float* img0, const float* img1,
                               int W, const float* pts,
                               const float* guess, const int32_t* meta,
                               int n, int radius, int iters, float* flow,
                               uint8_t* ok, void* stream) {
  const int P = 2 * radius + 1;
  const int threads = ((P * P + 31) / 32) * 32;
  if (n <= 0) return (int)cudaSuccess;
  if (threads > 32 * MAX_WARPS) return (int)cudaErrorInvalidValue;
  lk_level_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      img0, img1, W, pts, guess, meta, radius, iters, flow, ok);
  return (int)cudaGetLastError();
}
