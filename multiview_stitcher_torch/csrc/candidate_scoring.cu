// Candidate scoring of the batched pairwise registration, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package scores a crop-shape bucket's
// candidate shifts with jnp ops (multiview_stitcher_tpu/registration.py,
// _pcc_register_core_batch), and so did the port, in about 520 small
// launches a bucket (the shifts, the counts and boxes, the window choice, the
// SSIM maps and means, then the winner's shift and statistics again), each a
// few microseconds of device work behind about 16 us of host dispatch. In a
// stitch() of a tile grid at fractional stage positions almost every pair has
// an overlap shape of its own, so buckets hold a few pairs and that dispatch
// held most of the registration, which is why the kernel was added: one
// launch scores every candidate of a bucket, a second gives the winners'
// shifted images for the link quality (ops/candidate_scoring.py).
//
// candidate_kernel<NDIM, WINNERS>: one block per (pair, candidate) item. The
// crops (B, Z, Y, X) are float32, NaN outside their data (Z = 1 in 2D). Per item:
// 1. a sweep over the crop computes the moving image at the candidate shift
//    as registration's plain version does (ops/candidate_scoring.py,
//    _translate: axis 0 first, then each later axis on the result, each step
//    (1 - w) v0 + (w > 0 ? w v1 : 0) from clamped taps, valid where the
//    coordinate lies in the crop on every axis, NaN where the shifted mask
//    falls under 1 - 1e-4), every step rounded on its own (__fmul_rn,
//    __fadd_rn: no FMA contraction), so that the image is bit-equal to the
//    plain version's on the card. The same sweep counts the joint mask, the
//    moving crop's valid pixels, the valid boxes of the shifted image and of
//    the fixed crop, and both crops' extremes (the SSIM data range, the
//    moving minimum), reduced in shared memory;
// 2. the scoring box (union of the two boxes, or their intersection where a
//    crop holds NaN or the region mode asks for it) and its window 7, 5 or 3;
// 3. the SSIM mean over the box's interior: the interior is cut into tiles;
//    each tile stages its halo of the fixed crop and of the shifted image in
//    shared memory (a crop of the size the 2D grids give is one tile) and
//    takes the window means of x, x^2, y, y^2 and x y one axis at a time,
//    each a sum in order divided by the window, as the plain version's
//    uniform_filter does; interior windows never reach the crop's border, so
//    its reflect padding plays no part. The staged halos also give the
//    moving image's maximum in the box (their union is the box);
// 4. -inf where the joint mask covers under a tenth of the moving crop or the
//    candidate is not kept, -1 where no window fits or the moving image holds
//    nothing above its minimum in the box, else the mean.
// WINNERS (one block a pair, its winning shift) writes the shifted image, the
// joint mask, whether it covers a tenth of the moving crop and the box's
// maximum, and scores nothing.
//
// Sums run in a fixed order (each thread's pixels in turn, then a fixed
// shuffle tree and the warps in order), with no atomics, so every run gives
// the same scores. The SSIM maps follow the plain version's arithmetic step by
// step; only the mean's order of summation differs from torch's.
//
// What bounds it on the H100: neither bytes nor operations at the shapes the
// main path has. A bucket of the benchmark's grid, 4 pairs of 22 x 102 crops
// with 48 candidates each, reads 72 KB of crops (each tap through L1) for a few
// hundred thousand operations an item; it replaces about 520 launches of a few
// microseconds each, so what it saves is the host's dispatch. In 3D a block
// re-reads its pair's crops through L2 for its tiles' halos (5.2 times the
// interior at window 7 with 4 x 8 x 32 tiles).

#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxR = 3;  // half of the largest window, 7
// the plain version keeps a shifted pixel where its shifted mask is at least
// 1 - 1e-4, compared in float32
constexpr float kMaskMin = static_cast<float>(1.0 - 1e-4);
constexpr float kK1 = 0.01f;
constexpr float kK2 = 0.03f;
// region modes; 1 is the union
constexpr int kRegionAuto = 0;  // the intersection where either crop holds NaN, else the union
constexpr int kRegionIntersection = 2;
constexpr int kBadNdim = -1;

// box-interior outputs a block scores at a time, (z, y, x); RZ: the halo along z
template <int NDIM>
struct Tile;
template <>
struct Tile<2> {
  static constexpr int Z = 1, Y = 16, X = 128, RZ = 0;
};
template <>
struct Tile<3> {
  static constexpr int Z = 4, Y = 8, X = 32, RZ = kMaxR;
};

// dynamic shared memory of the scoring mode, in floats: the two halos, the
// five window sums after the z pass (3D) and after the y pass
template <int NDIM>
struct Smem {
  using T = Tile<NDIM>;
  static constexpr int kHalo = (T::Z + 2 * T::RZ) * (T::Y + 2 * kMaxR) * (T::X + 2 * kMaxR);
  static constexpr int kP0 = NDIM == 3 ? 5 * T::Z * (T::Y + 2 * kMaxR) * (T::X + 2 * kMaxR) : 0;
  static constexpr int kP1 = 5 * T::Z * T::Y * (T::X + 2 * kMaxR);
  static constexpr size_t kBytes = (2 * kHalo + kP0 + kP1) * sizeof(float);
};
static_assert(Smem<2>::kBytes <= 227 * 1024 && Smem<3>::kBytes <= 227 * 1024,
              "a block's shared memory is at most 227 KB");

struct Args {
  const float* im0;           // (B, Z, Y, X) fixed crops
  const float* im1;           // (B, Z, Y, X) moving crops
  const float* shifts;        // (B, C, NDIM)
  const unsigned char* keep;  // (B, C) items to score, or null: every item
  int C;
  int Z, Y, X;
  int region;
  float* scores;           // scoring: (B, C)
  float* img;              // winners: (B, Z, Y, X) the shifted moving crops
  unsigned char* mask;     // winners: (B, Z, Y, X) the joint masks
  unsigned char* frac_ok;  // winners: (B,)
  float* box_max;          // winners: (B,)
};

__device__ __forceinline__ float nan_to_num(float v) {
  return isnan(v) ? 0.0f : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

// (1 - w) v0 + (w > 0 ? w v1 : 0), each step rounded as torch's elementwise ops round it
__device__ __forceinline__ float mix(float w, float v0, float v1) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), v0), w > 0.0f ? __fmul_rn(w, v1) : 0.0f);
}

struct Taps {
  int i0, i1;
  float w;
  bool ok;
};

// the two taps of output index i at shift t along an axis of n samples
__device__ __forceinline__ Taps taps(int i, float t, int n) {
  const float c = __fadd_rn(static_cast<float>(i), t);
  const float f = floorf(c);
  const int fi = static_cast<int>(f);
  Taps k;
  k.w = __fsub_rn(c, f);
  k.i0 = min(max(fi, 0), n - 1);
  k.i1 = min(max(fi + 1, 0), n - 1);
  k.ok = c >= 0.0f && c <= static_cast<float>(n - 1);
  return k;
}

// one tap of the moving crop: its value with NaN as 0 (the plain version's
// filled image) and its mask (1 where the value is not NaN)
struct Px {
  float v, m;
};

__device__ __forceinline__ Px tap(const float* im, int idx) {
  const float v = __ldg(im + idx);
  return {nan_to_num(v), isnan(v) ? 0.0f : 1.0f};
}

// the moving crop at pixel (z, y, x) shifted by t, as the plain version's
// _translate gives it: NaN outside the crop or under the mask threshold
template <int NDIM>
__device__ __forceinline__ float shifted(const float* im, const Args& a, const float (&t)[3],
                                         int z, int y, int x) {
  const Taps ky = taps(y, t[1], a.Y);
  const Taps kx = taps(x, t[2], a.X);
  bool ok = ky.ok && kx.ok;
  float vy[2], my[2];  // after the axes before x, at x's two taps
  if constexpr (NDIM == 3) {
    const Taps kz = taps(z, t[0], a.Z);
    ok = ok && kz.ok;
    const int plane = a.Y * a.X;
#pragma unroll
    for (int jx = 0; jx < 2; ++jx) {
      const int xx = jx ? kx.i1 : kx.i0;
      float vz[2], mz[2];
#pragma unroll
      for (int jy = 0; jy < 2; ++jy) {
        const int row = (jy ? ky.i1 : ky.i0) * a.X + xx;
        const Px p0 = tap(im, kz.i0 * plane + row);
        const Px p1 = tap(im, kz.i1 * plane + row);
        vz[jy] = mix(kz.w, p0.v, p1.v);
        mz[jy] = mix(kz.w, p0.m, p1.m);
      }
      vy[jx] = mix(ky.w, vz[0], vz[1]);
      my[jx] = mix(ky.w, mz[0], mz[1]);
    }
  } else {
#pragma unroll
    for (int jx = 0; jx < 2; ++jx) {
      const int xx = jx ? kx.i1 : kx.i0;
      const Px p0 = tap(im, ky.i0 * a.X + xx);
      const Px p1 = tap(im, ky.i1 * a.X + xx);
      vy[jx] = mix(ky.w, p0.v, p1.v);
      my[jx] = mix(ky.w, p0.m, p1.m);
    }
  }
  const float v = mix(kx.w, vy[0], vy[1]);
  const float m = mix(kx.w, my[0], my[1]);
  return ok && m >= kMaskMin ? v : NAN;
}

// what the first sweep counts; boxes as (n, -1) along an axis where nothing is valid
struct Stats {
  int joint;    // pixels valid in the shifted moving crop and the fixed crop
  int valid1;   // valid pixels of the moving crop
  int any_nan;  // either crop holds NaN
  int lo1[3], hi1[3];
  int lo0[3], hi0[3];
  float max0, min0, max1, min1;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_fmin(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_fmax(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ double warp_dsum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void combine(Stats& s, const Stats& o) {
  s.joint += o.joint;
  s.valid1 += o.valid1;
  s.any_nan |= o.any_nan;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s.lo1[d] = min(s.lo1[d], o.lo1[d]);
    s.hi1[d] = max(s.hi1[d], o.hi1[d]);
    s.lo0[d] = min(s.lo0[d], o.lo0[d]);
    s.hi0[d] = max(s.hi0[d], o.hi0[d]);
  }
  s.max0 = fmaxf(s.max0, o.max0);
  s.min0 = fminf(s.min0, o.min0);
  s.max1 = fmaxf(s.max1, o.max1);
  s.min1 = fminf(s.min1, o.min1);
}

// the block's stats, in every thread; `shared` is used once a block
__device__ Stats block_stats(Stats s, Stats* shared) {
  s.joint = warp_sum(s.joint);
  s.valid1 = warp_sum(s.valid1);
  s.any_nan = warp_max(s.any_nan);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s.lo1[d] = warp_min(s.lo1[d]);
    s.hi1[d] = warp_max(s.hi1[d]);
    s.lo0[d] = warp_min(s.lo0[d]);
    s.hi0[d] = warp_max(s.hi0[d]);
  }
  s.max0 = warp_fmax(s.max0);
  s.min0 = warp_fmin(s.min0);
  s.max1 = warp_fmax(s.max1);
  s.min1 = warp_fmin(s.min1);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = s;
  __syncthreads();
  Stats out = shared[0];
  for (int w = 1; w < kWarps; ++w) combine(out, shared[w]);
  return out;
}

__device__ float block_fmax(float v, float* shared) {
  v = warp_fmax(v);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = shared[0];
  for (int w = 1; w < kWarps; ++w) out = fmaxf(out, shared[w]);
  return out;
}

__device__ double block_dsum(double v, double* shared) {
  v = warp_dsum(v);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = v;
  __syncthreads();
  double out = shared[0];
  for (int w = 1; w < kWarps; ++w) out += shared[w];
  return out;
}

// adds x, x^2, y, y^2 and x y of one pixel to the window sums
__device__ __forceinline__ void add_pixel(float (&s)[5], float x, float y) {
  s[0] = __fadd_rn(s[0], x);
  s[1] = __fadd_rn(s[1], __fmul_rn(x, x));
  s[2] = __fadd_rn(s[2], y);
  s[3] = __fadd_rn(s[3], __fmul_rn(y, y));
  s[4] = __fadd_rn(s[4], __fmul_rn(x, y));
}

// SSIM of one pixel from its window means (ux, uxx, uy, uyy, uxy), in the
// plain version's order of operations (ops/image_metrics.py)
__device__ __forceinline__ float ssim_pixel(const float (&u)[5], float cov, float c1, float c2) {
  const float ux = u[0], uxx = u[1], uy = u[2], uyy = u[3], uxy = u[4];
  const float vx = __fmul_rn(cov, __fsub_rn(uxx, __fmul_rn(ux, ux)));
  const float vy = __fmul_rn(cov, __fsub_rn(uyy, __fmul_rn(uy, uy)));
  const float vxy = __fmul_rn(cov, __fsub_rn(uxy, __fmul_rn(ux, uy)));
  const float a1 = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, ux), uy), c1);
  const float a2 = __fadd_rn(__fmul_rn(2.0f, vxy), c2);
  const float b1 = __fadd_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)), c1);
  const float b2 = __fadd_rn(__fadd_rn(vx, vy), c2);
  return __fdiv_rn(__fmul_rn(a1, a2), __fmul_rn(b1, b2));
}

// the SSIM sum over the interior [ilo, ihi] of the box at window `win`, and
// (through bm) the moving image's maximum over the box
template <int NDIM>
__device__ double ssim_sum(const Args& a, const float* im0, const float* im1, const float (&t)[3],
                           const int (&ilo)[3], const int (&ihi)[3], int win, float cov,
                           float c1, float c2, float& bm) {
  using T = Tile<NDIM>;
  extern __shared__ float smem[];
  float* hx0 = smem;                       // fixed crop's halo
  float* hy1 = smem + Smem<NDIM>::kHalo;   // shifted moving crop's halo
  float* p0 = hy1 + Smem<NDIM>::kHalo;     // window sums along z (3D)
  float* p1 = p0 + Smem<NDIM>::kP0;        // window sums along z and y
  const int r = win / 2;
  const int rz = NDIM == 3 ? r : 0;
  const float fw = static_cast<float>(win);
  double acc = 0.0;
  for (int tz = ilo[0]; tz <= ihi[0]; tz += T::Z) {
    for (int ty = ilo[1]; ty <= ihi[1]; ty += T::Y) {
      for (int tx = ilo[2]; tx <= ihi[2]; tx += T::X) {
        const int nz = min(T::Z, ihi[0] - tz + 1);
        const int ny = min(T::Y, ihi[1] - ty + 1);
        const int nx = min(T::X, ihi[2] - tx + 1);
        const int hz = nz + 2 * rz, hy = ny + 2 * r, hx = nx + 2 * r;
        const int oz = tz - rz, oy = ty - r, ox = tx - r;
        for (int q = threadIdx.x; q < hz * hy * hx; q += kThreads) {
          const int ix = q % hx, iy = (q / hx) % hy, iz = q / (hx * hy);
          const int z = oz + iz, y = oy + iy, x = ox + ix;
          const float sv = shifted<NDIM>(im1, a, t, z, y, x);
          if (!isnan(sv)) bm = fmaxf(bm, fminf(fmaxf(sv, -FLT_MAX), FLT_MAX));
          hy1[q] = nan_to_num(sv);
          hx0[q] = nan_to_num(__ldg(im0 + (z * a.Y + y) * a.X + x));
        }
        __syncthreads();
        const int s0 = nz * hy * hx;  // a channel of p0
        if constexpr (NDIM == 3) {
          for (int q = threadIdx.x; q < s0; q += kThreads) {
            const int ix = q % hx, iy = (q / hx) % hy, iz = q / (hx * hy);
            float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            for (int k = 0; k < win; ++k) {
              const int h = ((iz + k) * hy + iy) * hx + ix;
              add_pixel(s, hx0[h], hy1[h]);
            }
#pragma unroll
            for (int c = 0; c < 5; ++c) p0[c * s0 + q] = __fdiv_rn(s[c], fw);
          }
          __syncthreads();
        }
        const int s1 = nz * ny * hx;  // a channel of p1
        for (int q = threadIdx.x; q < s1; q += kThreads) {
          const int ix = q % hx, iy = (q / hx) % ny, iz = q / (hx * ny);
          float s[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          for (int k = 0; k < win; ++k) {
            const int h = (iz * hy + iy + k) * hx + ix;
            if constexpr (NDIM == 3) {
#pragma unroll
              for (int c = 0; c < 5; ++c) s[c] = __fadd_rn(s[c], p0[c * s0 + h]);
            } else {
              add_pixel(s, hx0[h], hy1[h]);
            }
          }
#pragma unroll
          for (int c = 0; c < 5; ++c) p1[c * s1 + q] = __fdiv_rn(s[c], fw);
        }
        __syncthreads();
        for (int q = threadIdx.x; q < nz * ny * nx; q += kThreads) {
          const int ix = q % nx, iy = (q / nx) % ny, iz = q / (nx * ny);
          float u[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          for (int k = 0; k < win; ++k) {
            const int h = (iz * ny + iy) * hx + ix + k;
#pragma unroll
            for (int c = 0; c < 5; ++c) u[c] = __fadd_rn(u[c], p1[c * s1 + h]);
          }
#pragma unroll
          for (int c = 0; c < 5; ++c) u[c] = __fdiv_rn(u[c], fw);
          acc += ssim_pixel(u, cov, c1, c2);
        }
        __syncthreads();  // the next tile restages the halos
      }
    }
  }
  return acc;
}

template <int NDIM, bool WINNERS>
__global__ void __launch_bounds__(kThreads) candidate_kernel(const Args a) {
  __shared__ Stats warp_stats[kWarps];
  __shared__ float warp_bm[kWarps];
  __shared__ double warp_acc[kWarps];
  const long long item = blockIdx.x;
  const long long pair = item / a.C;
  if (!WINNERS && a.keep != nullptr && !a.keep[item]) {
    if (threadIdx.x == 0) a.scores[item] = -INFINITY;
    return;
  }
  float t[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < NDIM; ++d) t[3 - NDIM + d] = a.shifts[item * NDIM + d];
  const int n = a.Z * a.Y * a.X;
  const float* im0 = a.im0 + pair * n;
  const float* im1 = a.im1 + pair * n;
  const int ext[3] = {a.Z, a.Y, a.X};

  // 1. the shifted crop's counts and boxes, and the crops' own
  Stats s;
  s.joint = s.valid1 = s.any_nan = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    s.lo1[d] = s.lo0[d] = ext[d];
    s.hi1[d] = s.hi0[d] = -1;
  }
  s.max0 = s.max1 = -INFINITY;
  s.min0 = s.min1 = INFINITY;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int x = p % a.X, y = (p / a.X) % a.Y, z = p / (a.X * a.Y);
    const int c[3] = {z, y, x};
    const float v0 = __ldg(im0 + p), v1 = __ldg(im1 + p);
    const float sv = shifted<NDIM>(im1, a, t, z, y, x);
    const bool ok0 = !isnan(v0), ok1 = !isnan(v1), oks = !isnan(sv);
    s.joint += ok0 && oks;
    s.valid1 += ok1;
    s.any_nan |= !(ok0 && ok1);
    if (ok0) {
      s.max0 = fmaxf(s.max0, v0);
      s.min0 = fminf(s.min0, v0);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        s.lo0[d] = min(s.lo0[d], c[d]);
        s.hi0[d] = max(s.hi0[d], c[d]);
      }
    }
    if (ok1) {
      s.max1 = fmaxf(s.max1, v1);
      s.min1 = fminf(s.min1, v1);
    }
    if (oks) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        s.lo1[d] = min(s.lo1[d], c[d]);
        s.hi1[d] = max(s.hi1[d], c[d]);
      }
    }
    if (WINNERS) {
      a.img[pair * n + p] = sv;
      a.mask[pair * n + p] = ok0 && oks;
    }
  }
  s = block_stats(s, warp_stats);

  // 2. the box and its window
  const float share =
      __fdiv_rn(static_cast<float>(s.joint), fmaxf(static_cast<float>(s.valid1), 1.0f));
  const bool frac_ok = s.joint > 0 && share >= 0.1f;
  const bool inter = a.region == kRegionIntersection || (a.region == kRegionAuto && s.any_nan);
  int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
  int min_shape = INT_MAX;
#pragma unroll
  for (int d = 3 - NDIM; d < 3; ++d) {
    lo[d] = inter ? max(s.lo0[d], s.lo1[d]) : min(s.lo0[d], s.lo1[d]);
    hi[d] = inter ? min(s.hi0[d], s.hi1[d]) : max(s.hi0[d], s.hi1[d]);
    min_shape = min(min_shape, hi[d] - lo[d] + 1);
  }

  if (WINNERS) {
    float bm = -INFINITY;
    if (min_shape > 0) {
      const int bz = hi[0] - lo[0] + 1, by = hi[1] - lo[1] + 1, bx = hi[2] - lo[2] + 1;
      for (int q = threadIdx.x; q < bz * by * bx; q += kThreads) {
        const int x = lo[2] + q % bx, y = lo[1] + (q / bx) % by, z = lo[0] + q / (bx * by);
        const float sv = shifted<NDIM>(im1, a, t, z, y, x);
        if (!isnan(sv)) bm = fmaxf(bm, fminf(fmaxf(sv, -FLT_MAX), FLT_MAX));
      }
    }
    bm = block_fmax(bm, warp_bm);
    if (threadIdx.x == 0) {
      a.frac_ok[pair] = frac_ok;
      a.box_max[pair] = bm;
    }
    return;
  }

  // the largest odd extent the box admits, at most 7 (min_shape - 1 & 1 is
  // Python's (min_shape - 1) % 2, also for negative extents)
  const int win_eff = min(min_shape - ((min_shape - 1) & 1), 7);
  float score;
  if (!frac_ok) {
    score = -INFINITY;
  } else if (win_eff < 3) {
    score = -1.0f;
  } else {
    // 3. the SSIM mean over the box's interior
    const int win = win_eff >= 7 ? 7 : (win_eff >= 5 ? 5 : 3);
    const int r = win / 2;
    int ilo[3], ihi[3];
    long long n_int = 1;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int rd = d >= 3 - NDIM ? r : 0;
      ilo[d] = lo[d] + rd;
      ihi[d] = hi[d] - rd;
      n_int *= ihi[d] - ilo[d] + 1;
    }
    int np_ = 1;
    for (int d = 0; d < NDIM; ++d) np_ *= win;
    const float cov = static_cast<float>(static_cast<double>(np_) / (np_ - 1));
    const float range = __fsub_rn(fmaxf(s.max0, s.max1), fminf(s.min0, s.min1));
    const float k1 = __fmul_rn(kK1, range), k2 = __fmul_rn(kK2, range);
    float bm = -INFINITY;
    double acc = ssim_sum<NDIM>(a, im0, im1, t, ilo, ihi, win, cov, __fmul_rn(k1, k1),
                                __fmul_rn(k2, k2), bm);
    acc = block_dsum(acc, warp_acc);
    bm = block_fmax(bm, warp_bm);
    const float mean = __fdiv_rn(static_cast<float>(acc), static_cast<float>(n_int));
    score = bm <= s.min1 ? -1.0f : mean;
  }
  if (threadIdx.x == 0) a.scores[item] = score;
}

// the scoring kernel's dynamic shared memory, allowed above 48 KB once a device
template <int NDIM>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(candidate_kernel<NDIM, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Smem<NDIM>::kBytes));
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <int NDIM, bool WINNERS>
int launch(const Args& a, long long items, cudaStream_t stream) {
  if (items == 0) return 0;
  if (items > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t bytes = WINNERS ? 0 : Smem<NDIM>::kBytes;
  if (!WINNERS) {
    const cudaError_t e = allow_smem<NDIM>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  candidate_kernel<NDIM, WINNERS><<<static_cast<unsigned>(items), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int Z, int Y, int X) {
  return Z >= 1 && Y >= 1 && X >= 1 && static_cast<long long>(Z) * Y * X <= INT_MAX;
}

}  // namespace

// Every entry point launches on `stream` and returns the cudaError_t of
// cudaGetLastError() (0 on success), or kBadNdim for a dimension other than 2 or 3.
extern "C" {

int mvs_score_candidates(int ndim, const float* im0, const float* im1, const float* shifts,
                         const unsigned char* keep, int B, int C, int Z, int Y, int X, int region,
                         float* scores, void* stream) {
  if (B < 0 || C < 1 || !valid_shape(Z, Y, X) || region < kRegionAuto ||
      region > kRegionIntersection) {
    return cudaErrorInvalidValue;
  }
  Args a{im0, im1, shifts, keep, C, Z, Y, X, region, scores, nullptr, nullptr, nullptr, nullptr};
  const long long items = static_cast<long long>(B) * C;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 2) return launch<2, false>(a, items, s);
  if (ndim == 3) return launch<3, false>(a, items, s);
  return kBadNdim;
}

int mvs_shift_winners(int ndim, const float* im0, const float* im1, const float* shifts, int B,
                      int Z, int Y, int X, int region, float* img, unsigned char* mask,
                      unsigned char* frac_ok, float* box_max, void* stream) {
  if (B < 0 || !valid_shape(Z, Y, X) || region < kRegionAuto || region > kRegionIntersection) {
    return cudaErrorInvalidValue;
  }
  Args a{im0, im1, shifts, nullptr, 1, Z, Y, X, region, nullptr, img, mask, frac_ok, box_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 2) return launch<2, true>(a, B, s);
  if (ndim == 3) return launch<3, true>(a, B, s);
  return kBadNdim;
}

const char* mvs_error_string(int code) {
  if (code == kBadNdim) return "crops must be 2D or 3D";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
