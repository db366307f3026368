// Pyramidal Lucas-Kanade for N features on Hopper: a whole track (all
// forward levels, the seeded backward check, the forward-backward and
// border tests) in one launch, and one pyramid level as a second entry.
//
// Replaces the TPU kernel dynamic_vins_tpu/ops/lk_pallas.py (lk_level,
// body _make_kernel, sampler _bilinear_patch) and the per-level glue of
// frontend/lk.track around it, and computes what they compute, not how
// the Pallas kernel tiles:
//   * each feature sees a level's img0/img1 only through a WIN_H x WIN_W
//     window whose origin is snapped to the (8, 128) tiling and clamped
//     inside the edge-padded image (Hp = max(ceil8(H), 48), Wp =
//     max(ceil128(W), 256)); reads outside the window are zero;
//   * the (2r+1)^2 template and its x/y gradient patches are bilinear
//     samples of window 0; the gradients are central differences of
//     patches shifted by +-1 px (not Scharr);
//   * bilinear weights apply rows first, then columns (R @ win @ C);
//   * ok = det(structure tensor) > 1e-6, then `iters` Newton updates of
//     the flow against window 1, whose patch origin is clamped to
//     [0, WIN - P - 2];
//   * the track: coarse-to-fine forward levels (g *= 2 between levels,
//     g kept where a level is not ok), pts1 = pts + g, the backward pass
//     over fb_levels levels seeded with -g / 2^(fb_levels-1), then
//     |pts1 + gb - pts| < fb_thresh and the border test on level 0.
//
// What bounds it on this card: not bytes (0.05-0.5 MB a level) nor
// float32 operations (~1.5e7 a level, 0.2 us at peak), but latency:
// per level a chain of 3 + `iters` dependent reductions over the
// patch, each after a bilinear patch read that depends on the previous
// flow, 5 levels a track. The first port paid that chain in block-wide
// reductions (two __syncthreads and a serial sum over 14 warp partials
// each), every tap a bounds-checked global gather, and one launch per
// level with the padding and window origins made by torch ops on the
// host side between launches.
//
// This design:
//   * one warp per feature, WARPS features per block; each lane owns
//     ceil(P^2 / 32) patch pixels (14 at radius 10, 10 at radius 8),
//     and accumulates its float32
//     products in double; a 5-step __shfl_xor butterfly gives every lane
//     the same sum (commutative pairwise adds), rounded once to float32,
//     so the flow update is uniform and the loop needs no __syncthreads
//     and no shared partials (and the plain version, which sums the same
//     products in float64, agrees to rounding);
//   * no padded copies and no host-side origins: a read at padded (r, c)
//     is img[min(r, H-1), min(c, W-1)], the edge pad itself, and the
//     origins are snapped in the kernel with the float32 operations of
//     ops/lk_level.prepare, in the same order;
//   * each level stages the img0 taps of the template and its gradient
//     patches ((P+5)^2 floats, window zeros and edge clamp applied) and
//     the img1 taps around the first iteration's patch, with a margin of
//     MARGIN px, in the warp's shared memory (both regions' loads in
//     flight together); iterations whose patch leaves that region read
//     global memory through the same value function, so the margin
//     changes no result (staging img1 beat reading it through the
//     read-only cache by ~30% a track on the H100);
//   * one launch per track: the 4 + 1 levels, the glue between them and
//     the final tests run in the warp, from the pyramids' level pointers
//     passed by value.
//
// The patch radius is a template parameter: radius 10 for the background
// tracker, radius 8 for the instance tracker (dynamic_vins_tpu/frontend/
// instance_tracker.py runs the same Pallas kernel at radius 8, 3 levels).
// Both are instantiated; the C entries take the radius and pick one.
//
// Built with --fmad=false: every float32 operation rounds as the plain
// version's torch ops do.

#include <cuda_runtime.h>
#include <stdint.h>

#define WIN_H 48
#define WIN_W 256
#define MARGIN 8
#define WARPS 4
#define MAX_LEVELS 8

// The patch geometry of radius R.
template <int R>
struct Geom {
  static constexpr int P = 2 * R + 1;
  static constexpr int PP = P * P;
  static constexpr int NPIX = (PP + 31) / 32;     // patch pixels per lane
  static constexpr int S0N = P + 5;     // img0 taps: +-1 px shifts, +1 lerp
  static constexpr int S1N = P + 1 + 2 * MARGIN;  // img1 taps + margin
};

struct Level {
  const float* img;   // [H, W] float32, unpadded
  int H, W;
};

// The level pointers and shapes of both pyramids (same shapes).
struct LkPyramids {
  const float* img0[MAX_LEVELS];
  const float* img1[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int levels;
};

// the edge-padded image at (r, c); r, c are clamped below too, so that
// staged taps outside the window stay in bounds (they are never used)
__device__ __forceinline__ float pad_at(const Level& L, int r, int c) {
  r = min(max(r, 0), L.H - 1);
  c = min(max(c, 0), L.W - 1);
  return __ldg(L.img + (size_t)r * L.W + c);
}

// window read: zero outside the window at (oy, ox)
__device__ __forceinline__ float win_at(const Level& L, int oy, int ox,
                                        int r, int c) {
  if ((unsigned)r >= WIN_H || (unsigned)c >= WIN_W) return 0.0f;
  return pad_at(L, oy + r, ox + c);
}

// window origin of a feature at (cy, cx), as ops/lk_level.prepare
__device__ __forceinline__ void snap(float cy, float cx, int Hp, int Wp,
                                     int& oy, int& ox) {
  oy = min(max((int)floorf((cy - 24.0f) / 8.0f) * 8, 0), Hp - WIN_H);
  ox = min(max((int)floorf(cx / 128.0f - 0.5f) * 128, 0), Wp - WIN_W);
}

// rows first (R @ win), then columns (@ C); v_rc = tap (row +r, col +c)
__device__ __forceinline__ float bilerp(float v00, float v10, float v01,
                                        float v11, float fy, float fx) {
  const float t0 = (1.0f - fy) * v00 + fy * v10;
  const float t1 = (1.0f - fy) * v01 + fy * v11;
  return (1.0f - fx) * t0 + fx * t1;
}

// bilinear sample of patch pixel (p, q) at window-local top-left
// (ly, lx) from the staged img0 taps (rows of S0N) at window-local
// origin (ry, rx)
template <int S0N>
__device__ __forceinline__ float patch0(const float* s, int ry, int rx,
                                        float ly, float lx, int p, int q) {
  const float iyf = floorf(ly), ixf = floorf(lx);
  const float* t = s + ((int)iyf + p - ry) * S0N + ((int)ixf + q - rx);
  return bilerp(t[0], t[S0N], t[1], t[S0N + 1], ly - iyf, lx - ixf);
}

__device__ __forceinline__ void warp_sum3(double& a, double& b,
                                          double& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
}

__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// One LK level of one feature, run by one warp. (x, y) is the feature in
// img0 at this level, (gu, gv) the flow guess; returns ok (det > 1e-6)
// and, if ok, leaves the refined flow in (gu, gv), else leaves it as it
// was (the glue's where(ok, g_level, g)). s0 / s1: the warp's staging
// buffers. R: the patch radius.
template <int R>
__device__ bool lk_level_warp(const Level& L0, const Level& L1, float x,
                              float y, float& gu, float& gv, int iters,
                              float* __restrict__ s0,
                              float* __restrict__ s1, int lane) {
  constexpr int P = Geom<R>::P, PP = Geom<R>::PP, NPIX = Geom<R>::NPIX;
  constexpr int S0N = Geom<R>::S0N, S1N = Geom<R>::S1N;
  const int Hp = max((L0.H + 7) / 8 * 8, WIN_H);
  const int Wp = max((L0.W + 127) / 128 * 128, WIN_W);
  int oy0, ox0, oy1, ox1;
  snap(y, x, Hp, Wp, oy0, ox0);
  snap(y + gv, x + gu, Hp, Wp, oy1, ox1);
  const float tl_y = (y - (float)oy0) - (float)R;
  const float tl_x = (x - (float)ox0) - (float)R;

  // every tap of the template and its +-1 px patches: rows and columns
  // floor(tl) - 1 .. floor(tl) + P + 2 (a +-1 shift moves the floor by
  // 0..2 after float32 rounding)
  const int ry0 = (int)floorf(tl_y) - 2, rx0 = (int)floorf(tl_x) - 2;
  const float hi_y = (float)(WIN_H - P - 2), hi_x = (float)(WIN_W - P - 2);
  // the img1 patch origin is clamped to [0, WIN - P - 2], so every img1
  // tap lies inside window 1: no zero fill on this side. Its region is
  // staged here, beside img0's, so that both loads are in flight at once
  const int ry1 = (int)floorf(fminf(fmaxf(((y + gv) - (float)oy1)
                                         - (float)R, 0.0f), hi_y))
                  - MARGIN;
  const int rx1 = (int)floorf(fminf(fmaxf(((x + gu) - (float)ox1)
                                         - (float)R, 0.0f), hi_x))
                  - MARGIN;
  // every load issued before any store (a latency chain otherwise)
  constexpr int N0 = (S0N * S0N + 31) / 32, N1 = (S1N * S1N + 31) / 32;
  float v0[N0], v1[N1];
#pragma unroll
  for (int j = 0; j < N0; ++j) {
    const int t = lane + 32 * j, r = t / S0N;
    if (t < S0N * S0N)
      v0[j] = win_at(L0, oy0, ox0, ry0 + r, rx0 + (t - r * S0N));
  }
#pragma unroll
  for (int j = 0; j < N1; ++j) {
    const int t = lane + 32 * j, r = t / S1N;
    if (t < S1N * S1N)
      v1[j] = pad_at(L1, oy1 + ry1 + r, ox1 + rx1 + (t - r * S1N));
  }
  __syncwarp();   // the previous level's readers are done
#pragma unroll
  for (int j = 0; j < N0; ++j)
    if (lane + 32 * j < S0N * S0N) s0[lane + 32 * j] = v0[j];
#pragma unroll
  for (int j = 0; j < N1; ++j)
    if (lane + 32 * j < S1N * S1N) s1[lane + 32 * j] = v1[j];
  __syncwarp();

  float tm[NPIX], gx[NPIX], gy[NPIX];
  double a11 = 0.0, a12 = 0.0, a22 = 0.0;
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int k = lane + 32 * j;
    tm[j] = gx[j] = gy[j] = 0.0f;
    if (k < PP) {
      const int p = k / P, q = k - (k / P) * P;
      tm[j] = patch0<S0N>(s0, ry0, rx0, tl_y, tl_x, p, q);
      gx[j] = 0.5f * (patch0<S0N>(s0, ry0, rx0, tl_y, tl_x + 1.0f, p, q)
                      - patch0<S0N>(s0, ry0, rx0, tl_y, tl_x - 1.0f, p, q));
      gy[j] = 0.5f * (patch0<S0N>(s0, ry0, rx0, tl_y + 1.0f, tl_x, p, q)
                      - patch0<S0N>(s0, ry0, rx0, tl_y - 1.0f, tl_x, p, q));
      a11 += (double)(gx[j] * gx[j]);
      a12 += (double)(gx[j] * gy[j]);
      a22 += (double)(gy[j] * gy[j]);
    }
  }
  warp_sum3(a11, a12, a22);
  const float A11 = (float)a11, A12 = (float)a12, A22 = (float)a22;
  const float det = A11 * A22 - A12 * A12;
  if (!(det > 1e-6f)) return false;
  const float inv_det = 1.0f / fmaxf(det, 1e-6f);

  float u = gu, v = gv;
  for (int it = 0; it < iters; ++it) {
    float ly = ((y + v) - (float)oy1) - (float)R;
    float lx = ((x + u) - (float)ox1) - (float)R;
    ly = fminf(fmaxf(ly, 0.0f), hi_y);
    lx = fminf(fmaxf(lx, 0.0f), hi_x);
    const float iyf = floorf(ly), ixf = floorf(lx);
    const float fy = ly - iyf, fx = lx - ixf;
    const int iy = (int)iyf, ix = (int)ixf;
    double b1 = 0.0, b2 = 0.0;
    if ((unsigned)(iy - ry1) <= 2 * MARGIN
        && (unsigned)(ix - rx1) <= 2 * MARGIN) {
      const float* base = s1 + (iy - ry1) * S1N + (ix - rx1);
#pragma unroll
      for (int j = 0; j < NPIX; ++j) {
        const int k = lane + 32 * j;
        if (k < PP) {
          const float* t = base + (k / P) * S1N + (k - (k / P) * P);
          const float d = bilerp(t[0], t[S1N], t[1], t[S1N + 1], fy, fx)
                          - tm[j];
          b1 += (double)(d * gx[j]);
          b2 += (double)(d * gy[j]);
        }
      }
    } else {
      const int r0 = oy1 + iy, c0 = ox1 + ix;
#pragma unroll
      for (int j = 0; j < NPIX; ++j) {
        const int k = lane + 32 * j;
        if (k < PP) {
          const int r = r0 + k / P, c = c0 + (k - (k / P) * P);
          const float d = bilerp(pad_at(L1, r, c), pad_at(L1, r + 1, c),
                                 pad_at(L1, r, c + 1),
                                 pad_at(L1, r + 1, c + 1), fy, fx)
                          - tm[j];
          b1 += (double)(d * gx[j]);
          b2 += (double)(d * gy[j]);
        }
      }
    }
    warp_sum2(b1, b2);
    const float B1 = (float)b1, B2 = (float)b2;
    u += -(A22 * B1 - A12 * B2) * inv_det;
    v += -(-A12 * B1 + A11 * B2) * inv_det;
  }
  gu = u;
  gv = v;
  return true;
}

template <int R>
__global__ void __launch_bounds__(32 * WARPS)
lk_track_kernel(LkPyramids pyr, const float* __restrict__ pts,
                const uint8_t* __restrict__ valid, int n, int iters,
                float fb_thresh, int border, int fb_levels,
                float* __restrict__ pts1, uint8_t* __restrict__ ok_out) {
  constexpr int S0N = Geom<R>::S0N, S1N = Geom<R>::S1N;
  __shared__ float s0_all[WARPS][S0N * S0N];
  __shared__ float s1_all[WARPS][S1N * S1N];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n) return;   // whole warps only
  float* s0 = s0_all[warp];
  float* s1 = s1_all[warp];
  const int levels = pyr.levels;

  const float px = pts[2 * i + 0], py = pts[2 * i + 1];
  bool ok = valid[i] != 0;
  float gu = 0.0f, gv = 0.0f;
  for (int l = levels - 1; l >= 0; --l) {
    const Level a = {pyr.img0[l], pyr.H[l], pyr.W[l]};
    const Level b = {pyr.img1[l], pyr.H[l], pyr.W[l]};
    const float s = (float)(1 << l);
    if (l < levels - 1) {
      gu *= 2.0f;
      gv *= 2.0f;
    }
    const bool okl = lk_level_warp<R>(a, b, px / s, py / s, gu, gv, iters,
                                      s0, s1, lane);
    ok = ok && okl;
  }
  const float x1 = px + gu, y1 = py + gv;

  const int nfb = max(1, min(fb_levels, levels));
  float bu = 0.0f, bv = 0.0f;
  if (nfb < levels) {
    const float d = (float)(1 << (nfb - 1));
    bu = -gu / d;
    bv = -gv / d;
  }
  for (int l = nfb - 1; l >= 0; --l) {
    const Level a = {pyr.img1[l], pyr.H[l], pyr.W[l]};
    const Level b = {pyr.img0[l], pyr.H[l], pyr.W[l]};
    const float s = (float)(1 << l);
    if (l < nfb - 1) {
      bu *= 2.0f;
      bv *= 2.0f;
    }
    const bool okl = lk_level_warp<R>(a, b, x1 / s, y1 / s, bu, bv, iters,
                                      s0, s1, lane);
    ok = ok && okl;
  }
  const float ex = (x1 + bu) - px, ey = (y1 + bv) - py;
  ok = ok && sqrtf(ex * ex + ey * ey) < fb_thresh;
  const float W0 = (float)(pyr.W[0] - border), H0 = (float)(pyr.H[0] - border);
  ok = ok && x1 >= (float)border && x1 < W0 && y1 >= (float)border
       && y1 < H0;
  if (lane == 0) {
    pts1[2 * i + 0] = x1;
    pts1[2 * i + 1] = y1;
    ok_out[i] = ok ? 1 : 0;
  }
}

template <int R>
__global__ void __launch_bounds__(32 * WARPS)
lk_level_kernel(Level L0, Level L1, const float* __restrict__ pts,
                const float* __restrict__ guess, int n, int iters,
                float* __restrict__ flow, uint8_t* __restrict__ ok) {
  constexpr int S0N = Geom<R>::S0N, S1N = Geom<R>::S1N;
  __shared__ float s0_all[WARPS][S0N * S0N];
  __shared__ float s1_all[WARPS][S1N * S1N];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n) return;
  float gu = guess[2 * i + 0], gv = guess[2 * i + 1];
  const bool good = lk_level_warp<R>(L0, L1, pts[2 * i + 0],
                                     pts[2 * i + 1], gu, gv, iters,
                                     s0_all[warp], s1_all[warp], lane);
  if (lane == 0) {
    flow[2 * i + 0] = gu;
    flow[2 * i + 1] = gv;
    ok[i] = good ? 1 : 0;
  }
}

// C entry points: launch on `stream`, return cudaGetLastError(). Images
// are unpadded [H, W] float32; pts, guess, flow, pts1: [n, 2] float32;
// valid, ok: [n] bytes. radius: 8 or 10 (cudaErrorInvalidValue else).

template <int R>
static void launch_level(const Level& L0, const Level& L1, const float* pts,
                         const float* guess, int n, int iters, float* flow,
                         uint8_t* ok, cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  lk_level_kernel<R><<<blocks, 32 * WARPS, 0, stream>>>(
      L0, L1, pts, guess, n, iters, flow, ok);
}

template <int R>
static void launch_track(const LkPyramids& pyr, const float* pts,
                         const uint8_t* valid, int n, int iters,
                         float fb_thresh, int border, int fb_levels,
                         float* pts1, uint8_t* ok, cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  lk_track_kernel<R><<<blocks, 32 * WARPS, 0, stream>>>(
      pyr, pts, valid, n, iters, fb_thresh, border, fb_levels, pts1, ok);
}

// One level: flow [n,2] (the guess where not ok) and ok [n].
extern "C" int lk_level_launch(const float* img0, const float* img1, int H,
                               int W, const float* pts, const float* guess,
                               int n, int radius, int iters, float* flow,
                               uint8_t* ok, void* stream) {
  if (radius != 8 && radius != 10) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Level L0 = {img0, H, W}, L1 = {img1, H, W};
  const cudaStream_t s = (cudaStream_t)stream;
  if (radius == 8)
    launch_level<8>(L0, L1, pts, guess, n, iters, flow, ok, s);
  else
    launch_level<10>(L0, L1, pts, guess, n, iters, flow, ok, s);
  return (int)cudaGetLastError();
}

// A whole track from pyramid 0 to pyramid 1: pts1 [n,2] and ok [n].
extern "C" int lk_track_launch(const LkPyramids* pyr, const float* pts,
                               const uint8_t* valid, int n, int radius,
                               int iters, float fb_thresh, int border,
                               int fb_levels, float* pts1, uint8_t* ok,
                               void* stream) {
  if (radius != 8 && radius != 10) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (pyr->levels < 1 || pyr->levels > MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < pyr->levels; ++l)
    if (pyr->H[l] < 1 || pyr->W[l] < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (radius == 8)
    launch_track<8>(*pyr, pts, valid, n, iters, fb_thresh, border,
                    fb_levels, pts1, ok, s);
  else
    launch_track<10>(*pyr, pts, valid, n, iters, fb_thresh, border,
                     fb_levels, pts1, ok, s);
  return (int)cudaGetLastError();
}
