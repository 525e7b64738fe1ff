// Translation-tile fusion kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of multiview_stitcher_tpu/ops/pallas_fusion.py:
//   fuse_translation_3d_kernel  <- _fuse_tile_kernel_3d (wrapper fuse_translation_3d)
//   fuse_translation_2d_kernel  <- _fuse_tile_kernel    (wrapper fuse_translation_2d)
//
// Both fuse a whole output from V translation-placed views with the default
// weighted-average blending in one pass. For every output pixel and every
// view slot of its output tile: sample the view (tri/bilinear) at
// scale * o + off, mask by the view's true extents, weight it by the
// hat-expanded 5^ndim EDT-proxy grid with a cosine taper, and accumulate the
// weighted and the plain sums. The result is acc / wsum, or the plain valid
// mean where wsum == 0, passed through nan_to_num and a truncating cast.
//
// What bounds them on the H100: memory. Each output pixel is read from about
// 1.5 views on the main path and written once, at a few tens of f32
// operations per covering view, against 3.35 TB/s and 67 TFLOP/s. The design:
// - gather straight from the (V, [D,] H, W) stack in its native dtype, so a
//   uint16 stack moves 2 bytes a voxel and no f32 copy of it is ever made;
//   neighbouring threads read neighbouring x, and the 2x2(x2) lerp
//   neighbourhood is shared through L1/L2;
// - one block per (sub-)tile of the output; it stages its view-slot list,
//   the views' parameter rows and their 5^ndim grids in shared memory once;
// - in 3D a thread owns one (y, x) column of the tile: the y/x part of the
//   hat expansion is done once per view and reused over the tile's z planes;
// - nan_to_num and the cast to the output dtype are fused into the store.
//
// What the TPU kernels did that does not come across: the zero-padded atlas,
// the (8, 128)-aligned DMA windows, the banded lerp matmuls (Mosaic had no
// dynamic VMEM offsets) and the (ndim, V) SMEM tables. The numerics do come
// across, in this order:
// - the sample position is split at the tile origin: c0 = off + sc * o0 is
//   split into floor(c0) + f and the view is sampled at sc * i + f inside the
//   tile; in 3D uniform mode z keeps the integer stride SZ with the fixed
//   fraction f;
// - validity and the weight coordinates use the absolute index, sc * a + off
//   and wdiag * a + woff, each rounded as a separate f32 multiply and add
//   (no FMA contraction: a pixel on a view border must not flip);
// - the lerp runs z first, then y, then x (the reference's matmul order);
// - the 3D hat expansion is summed as sum_i hz (sum_j hy (sum_k g hx));
// - slots are summed in ascending slot order.
// Reads at a view's last row/column/plane clamp the index to the stack; the
// clamped neighbour has lerp weight 0 there, so the sum is the same.
//
// Interface: plain C, loaded with ctypes. Every launch returns the
// cudaError_t of cudaGetLastError() (0 on success), kBadDtype for an
// unsupported dtype, or cudaErrorInvalidConfiguration for a grid too large.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBadDtype = -1;
constexpr int kSlotChunk = 32;  // view slots staged in shared memory per pass
constexpr float kPi = 3.14159265358979323846f;

// 3D block: 32 x 8 threads, each walking 4 z planes of one (y, x) column.
constexpr int kBX3 = 32, kBY3 = 8, kBZ3 = 4;
// 2D block: 32 x 16 threads, one output pixel each.
constexpr int kBX2 = 32, kBY2 = 16;

enum DType : int { kF32 = 0, kU16 = 1, kU8 = 2 };

template <typename T>
struct Cast;
template <>
struct Cast<float> {
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float store(float v) { return v; }
};
template <>
struct Cast<uint16_t> {
  __device__ static float load(const uint16_t* p) { return static_cast<float>(__ldg(p)); }
  // truncation toward zero, as numpy/JAX astype; fused values of uint16
  // views lie in [0, 65535], the clamp only guards the conversion
  __device__ static uint16_t store(float v) {
    return static_cast<uint16_t>(fminf(fmaxf(v, 0.f), 65535.f));
  }
};
template <>
struct Cast<uint8_t> {
  __device__ static float load(const uint8_t* p) { return static_cast<float>(__ldg(p)); }
  __device__ static uint8_t store(float v) {
    return static_cast<uint8_t>(fminf(fmaxf(v, 0.f), 255.f));
  }
};

// jnp.nan_to_num / torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

// a * x + b with the two roundings of a separate f32 multiply and add
__device__ __forceinline__ float mul_add(float a, int x, float b) {
  return __fadd_rn(__fmul_rn(a, static_cast<float>(x)), b);
}

// Lower sample index and lerp fraction of in-tile index i along one axis of
// a tile whose origin has absolute index o0.
struct Sample {
  int idx;
  float frac;
};
__device__ __forceinline__ Sample tile_sample(float off, float sc, int o0, int i) {
  const float c0 = __fadd_rn(off, __fmul_rn(sc, static_cast<float>(o0)));
  const float b0 = floorf(c0);
  const float pos = __fadd_rn(__fmul_rn(sc, static_cast<float>(i)), __fsub_rn(c0, b0));
  const float b = floorf(pos);
  return {static_cast<int>(b0) + static_cast<int>(b), __fsub_rn(pos, b)};
}

// validity of absolute index a: 0 <= sc * a + off <= extent - 1
__device__ __forceinline__ bool inside(float sc, int a, float off, float ext) {
  const float c = mul_add(sc, a, off);
  return c >= 0.f && c <= ext - 1.f;
}

__device__ __forceinline__ float hat(float g, int i) {
  return fmaxf(0.f, 1.f - fabsf(g - static_cast<float>(i)));
}

// cosine taper of values < 1, then the clip to [0, 1]
__device__ __forceinline__ float taper(float w) {
  if (w < 1.f) w = (cosf((1.f - w) * kPi) + 1.f) / 2.f;
  return fminf(fmaxf(w, 0.f), 1.f);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return (1.f - f) * a + f * b;
}

__device__ __forceinline__ int clamp_idx(int v, int n) { return min(max(v, 0), n - 1); }

__device__ __forceinline__ float fused_value(float acc, float wsum, float vacc, float vcnt) {
  return wsum > 0.f ? acc / fmaxf(wsum, 1e-12f) : vacc / fmaxf(vcnt, 1.f);
}

// Parameter row of one view: off | extent | wdiag | woff | scale, ndim each.
template <int NDIM>
struct Par {
  static constexpr int kRow = 5 * NDIM;
  static constexpr int kGrid = NDIM == 3 ? 125 : 25;
};

// Stages slots [k0, k0 + nk) of the block's list with their parameter rows
// and grids in shared memory. Empty slots (-1) get zeros.
template <int NDIM>
__device__ void stage_slots(const int* slots, int k0, int nk, const float* params,
                            const float* wgrids, int* s_view,
                            float (*s_par)[Par<NDIM>::kRow],
                            float (*s_grid)[Par<NDIM>::kGrid], int tid, int nthreads) {
  constexpr int R = Par<NDIM>::kRow, G = Par<NDIM>::kGrid;
  __syncthreads();  // the previous chunk is consumed
  for (int j = tid; j < nk; j += nthreads) s_view[j] = slots[k0 + j];
  __syncthreads();
  for (int j = tid; j < nk * R; j += nthreads) {
    const int s = j / R, c = j - s * R, v = s_view[s];
    s_par[s][c] = v >= 0 ? params[static_cast<long long>(v) * R + c] : 0.f;
  }
  for (int j = tid; j < nk * G; j += nthreads) {
    const int s = j / G, c = j - s * G, v = s_view[s];
    s_grid[s][c] = v >= 0 ? wgrids[static_cast<long long>(v) * G + c] : 0.f;
  }
  __syncthreads();
}

struct Args3D {
  const void* tiles;
  int D, H, W;
  const int* view_idx;  // (n_tz, n_ty, n_tx, K)
  int K;
  const float* params;  // (V, 15)
  const float* wgrids;  // (V, 125)
  void* out;            // (OZ, OY, OX)
  int OZ, OY, OX, TZ, TY, TX;
  int org_z, org_y, org_x;
  int per_view_z, SZ;
};

struct Args2D {
  const void* tiles;
  int H, W;
  const int* view_idx;  // (n_ty, n_tx, K)
  int K;
  const float* params;  // (V, 10)
  const float* wgrids;  // (V, 25)
  void* out;            // (OY, OX)
  int OY, OX, TY, TX;
  int org_y, org_x;
};

// blockIdx.{x,y,z} = tile index * sub + sub-block index: a block never
// straddles two tiles of the view-list grid, whatever the tile shape.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kBX3* kBY3)
    fuse_translation_3d_kernel(Args3D a, int n_ty, int n_tx, int sub_z, int sub_y, int sub_x) {
  __shared__ int s_view[kSlotChunk];
  __shared__ float s_par[kSlotChunk][Par<3>::kRow];
  __shared__ float s_grid[kSlotChunk][Par<3>::kGrid];

  const int tx = blockIdx.x / sub_x, ix = (blockIdx.x % sub_x) * kBX3 + threadIdx.x;
  const int ty = blockIdx.y / sub_y, iy = (blockIdx.y % sub_y) * kBY3 + threadIdx.y;
  const int tz = blockIdx.z / sub_z, iz0 = (blockIdx.z % sub_z) * kBZ3;
  const int px = tx * a.TX + ix, py = ty * a.TY + iy;
  const bool active = ix < a.TX && iy < a.TY && px < a.OX && py < a.OY;
  // absolute output indices of the tile origin (the reference's o0)
  const int ox0 = tx * a.TX + a.org_x, oy0 = ty * a.TY + a.org_y, oz0 = tz * a.TZ + a.org_z;
  const int tid = threadIdx.y * kBX3 + threadIdx.x;
  const int* slots = a.view_idx + ((static_cast<long long>(tz) * n_ty + ty) * n_tx + tx) * a.K;
  const long long plane = static_cast<long long>(a.H) * a.W;
  const long long vsize = plane * a.D;
  const Tin* tiles = static_cast<const Tin*>(a.tiles);

  float acc[kBZ3], wsum[kBZ3], vacc[kBZ3], vcnt[kBZ3];
#pragma unroll
  for (int j = 0; j < kBZ3; ++j) acc[j] = wsum[j] = vacc[j] = vcnt[j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += kSlotChunk) {
    const int nk = min(kSlotChunk, a.K - k0);
    stage_slots<3>(slots, k0, nk, a.params, a.wgrids, s_view, s_par, s_grid, tid, kBX3 * kBY3);
    if (!active) continue;
    for (int s = 0; s < nk; ++s) {
      const int v = s_view[s];
      if (v < 0) continue;
      const float* p = s_par[s];  // off 0-2 | ext 3-5 | wdiag 6-8 | woff 9-11 | scale 12-14
      // a view not valid at this (y, x) adds exactly 0 on every plane
      if (!inside(p[13], oy0 + iy, p[1], p[4]) || !inside(p[14], ox0 + ix, p[2], p[5])) continue;
      const Sample sy = tile_sample(p[1], p[13], oy0, iy);
      const Sample sx = tile_sample(p[2], p[14], ox0, ix);
      const int y0 = clamp_idx(sy.idx, a.H), y1 = clamp_idx(sy.idx + 1, a.H);
      const int x0 = clamp_idx(sx.idx, a.W), x1 = clamp_idx(sx.idx + 1, a.W);

      // y/x part of the hat expansion, reused over the z planes
      const float gy = mul_add(p[7], oy0 + iy, p[10]);
      const float gx = mul_add(p[8], ox0 + ix, p[11]);
      float hy[5], hx[5], inner[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        hy[i] = hat(gy, i);
        hx[i] = hat(gx, i);
      }
      const float* g = s_grid[s];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        float in_y = 0.f;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          float in_x = 0.f;
#pragma unroll
          for (int k = 0; k < 5; ++k) in_x += g[(i * 5 + j) * 5 + k] * hx[k];
          in_y += hy[j] * in_x;
        }
        inner[i] = in_y;
      }

      // uniform z mode: integer stride SZ from floor(c0), fixed fraction
      const float cz0 = __fadd_rn(p[0], __fmul_rn(p[12], static_cast<float>(oz0)));
      const float bz0 = floorf(cz0);
      const Tin* base = tiles + v * vsize;
#pragma unroll
      for (int j = 0; j < kBZ3; ++j) {
        const int iz = iz0 + j, pz = tz * a.TZ + iz;
        if (iz >= a.TZ || pz >= a.OZ) break;
        const int az = oz0 + iz;
        if (!inside(p[12], az, p[0], p[3])) continue;
        int zlo;
        float fz;
        if (a.per_view_z) {
          const Sample sz = tile_sample(p[0], p[12], oz0, iz);
          zlo = sz.idx;
          fz = sz.frac;
        } else {
          zlo = static_cast<int>(bz0) + a.SZ * iz;
          fz = __fsub_rn(cz0, bz0);
        }
        const Tin* q0 = base + clamp_idx(zlo, a.D) * plane;
        const Tin* q1 = base + clamp_idx(zlo + 1, a.D) * plane;
        const long long r0 = static_cast<long long>(y0) * a.W, r1 = static_cast<long long>(y1) * a.W;
        const float z00 = lerp(Cast<Tin>::load(q0 + r0 + x0), Cast<Tin>::load(q1 + r0 + x0), fz);
        const float z10 = lerp(Cast<Tin>::load(q0 + r1 + x0), Cast<Tin>::load(q1 + r1 + x0), fz);
        const float z01 = lerp(Cast<Tin>::load(q0 + r0 + x1), Cast<Tin>::load(q1 + r0 + x1), fz);
        const float z11 = lerp(Cast<Tin>::load(q0 + r1 + x1), Cast<Tin>::load(q1 + r1 + x1), fz);
        const float val = lerp(lerp(z00, z10, sy.frac), lerp(z01, z11, sy.frac), sx.frac);

        const float gz = mul_add(p[6], az, p[9]);
        float w = 0.f;
#pragma unroll
        for (int i = 0; i < 5; ++i) w += hat(gz, i) * inner[i];
        w = taper(w);
        acc[j] += w * val;
        wsum[j] += w;
        vacc[j] += val;
        vcnt[j] += 1.f;
      }
    }
  }
  if (!active) return;
  Tout* out = static_cast<Tout*>(a.out);
#pragma unroll
  for (int j = 0; j < kBZ3; ++j) {
    const int iz = iz0 + j, pz = tz * a.TZ + iz;
    if (iz >= a.TZ || pz >= a.OZ) break;
    out[(static_cast<long long>(pz) * a.OY + py) * a.OX + px] =
        Cast<Tout>::store(nan_to_num(fused_value(acc[j], wsum[j], vacc[j], vcnt[j])));
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kBX2* kBY2)
    fuse_translation_2d_kernel(Args2D a, int n_tx, int sub_y, int sub_x) {
  __shared__ int s_view[kSlotChunk];
  __shared__ float s_par[kSlotChunk][Par<2>::kRow];
  __shared__ float s_grid[kSlotChunk][Par<2>::kGrid];

  const int tx = blockIdx.x / sub_x, ix = (blockIdx.x % sub_x) * kBX2 + threadIdx.x;
  const int ty = blockIdx.y / sub_y, iy = (blockIdx.y % sub_y) * kBY2 + threadIdx.y;
  const int px = tx * a.TX + ix, py = ty * a.TY + iy;
  const bool active = ix < a.TX && iy < a.TY && px < a.OX && py < a.OY;
  const int ox0 = tx * a.TX + a.org_x, oy0 = ty * a.TY + a.org_y;
  const int tid = threadIdx.y * kBX2 + threadIdx.x;
  const int* slots = a.view_idx + (static_cast<long long>(ty) * n_tx + tx) * a.K;
  const long long vsize = static_cast<long long>(a.H) * a.W;
  const Tin* tiles = static_cast<const Tin*>(a.tiles);

  float acc = 0.f, wsum = 0.f, vacc = 0.f, vcnt = 0.f;
  for (int k0 = 0; k0 < a.K; k0 += kSlotChunk) {
    const int nk = min(kSlotChunk, a.K - k0);
    stage_slots<2>(slots, k0, nk, a.params, a.wgrids, s_view, s_par, s_grid, tid, kBX2 * kBY2);
    if (!active) continue;
    for (int s = 0; s < nk; ++s) {
      const int v = s_view[s];
      if (v < 0) continue;
      const float* p = s_par[s];  // off 0-1 | ext 2-3 | wdiag 4-5 | woff 6-7 | scale 8-9
      if (!inside(p[8], oy0 + iy, p[0], p[2]) || !inside(p[9], ox0 + ix, p[1], p[3])) continue;
      const Sample sy = tile_sample(p[0], p[8], oy0, iy);
      const Sample sx = tile_sample(p[1], p[9], ox0, ix);
      const Tin* base = tiles + v * vsize;
      const Tin* r0 = base + static_cast<long long>(clamp_idx(sy.idx, a.H)) * a.W;
      const Tin* r1 = base + static_cast<long long>(clamp_idx(sy.idx + 1, a.H)) * a.W;
      const int x0 = clamp_idx(sx.idx, a.W), x1 = clamp_idx(sx.idx + 1, a.W);
      // y lerp first, then x (the reference's matmul order)
      const float val = lerp(lerp(Cast<Tin>::load(r0 + x0), Cast<Tin>::load(r1 + x0), sy.frac),
                             lerp(Cast<Tin>::load(r0 + x1), Cast<Tin>::load(r1 + x1), sy.frac),
                             sx.frac);

      const float gy = mul_add(p[4], oy0 + iy, p[6]);
      const float gx = mul_add(p[5], ox0 + ix, p[7]);
      float hx[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) hx[j] = hat(gx, j);
      const float* g = s_grid[s];
      float w = 0.f;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const float h = hat(gy, i);
#pragma unroll
        for (int j = 0; j < 5; ++j) w += g[i * 5 + j] * h * hx[j];
      }
      w = taper(w);
      acc += w * val;
      wsum += w;
      vacc += val;
      vcnt += 1.f;
    }
  }
  if (!active) return;
  static_cast<Tout*>(a.out)[static_cast<long long>(py) * a.OX + px] =
      Cast<Tout>::store(nan_to_num(fused_value(acc, wsum, vacc, vcnt)));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename Tin, typename Tout>
struct Launch3D {
  static int run(const Args3D& a, cudaStream_t stream) {
    const int sub_z = cdiv(a.TZ, kBZ3), sub_y = cdiv(a.TY, kBY3), sub_x = cdiv(a.TX, kBX3);
    const int n_tz = cdiv(a.OZ, a.TZ), n_ty = cdiv(a.OY, a.TY), n_tx = cdiv(a.OX, a.TX);
    const long long gx = static_cast<long long>(n_tx) * sub_x;
    const long long gy = static_cast<long long>(n_ty) * sub_y;
    const long long gz = static_cast<long long>(n_tz) * sub_z;
    if (gx > INT_MAX || gy > 65535 || gz > 65535) return cudaErrorInvalidConfiguration;
    fuse_translation_3d_kernel<Tin, Tout>
        <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(gz)),
           dim3(kBX3, kBY3), 0, stream>>>(a, n_ty, n_tx, sub_z, sub_y, sub_x);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename Tin, typename Tout>
struct Launch2D {
  static int run(const Args2D& a, cudaStream_t stream) {
    const int sub_y = cdiv(a.TY, kBY2), sub_x = cdiv(a.TX, kBX2);
    const int n_ty = cdiv(a.OY, a.TY), n_tx = cdiv(a.OX, a.TX);
    const long long gx = static_cast<long long>(n_tx) * sub_x;
    const long long gy = static_cast<long long>(n_ty) * sub_y;
    if (gx > INT_MAX || gy > 65535) return cudaErrorInvalidConfiguration;
    fuse_translation_2d_kernel<Tin, Tout>
        <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), dim3(kBX2, kBY2), 0,
           stream>>>(a, n_tx, sub_y, sub_x);
    return static_cast<int>(cudaGetLastError());
  }
};

template <template <typename, typename> class L, typename Tin, typename A>
int dispatch_out(int out_dtype, const A& a, cudaStream_t stream) {
  switch (out_dtype) {
    case kF32: return L<Tin, float>::run(a, stream);
    case kU16: return L<Tin, uint16_t>::run(a, stream);
    case kU8: return L<Tin, uint8_t>::run(a, stream);
  }
  return kBadDtype;
}

template <template <typename, typename> class L, typename A>
int dispatch(int in_dtype, int out_dtype, const A& a, cudaStream_t stream) {
  switch (in_dtype) {
    case kF32: return dispatch_out<L, float>(out_dtype, a, stream);
    case kU16: return dispatch_out<L, uint16_t>(out_dtype, a, stream);
    case kU8: return dispatch_out<L, uint8_t>(out_dtype, a, stream);
  }
  return kBadDtype;
}

}  // namespace

extern "C" {

int mvs_fuse_translation_3d(const void* tiles, int in_dtype, int D, int H, int W,
                            const void* view_idx, int K, const void* params,
                            const void* wgrids, void* out, int out_dtype, int OZ, int OY,
                            int OX, int TZ, int TY, int TX, int org_z, int org_y, int org_x,
                            int per_view_z, int SZ, void* stream) {
  const Args3D a{tiles,  D,  H,  W,  static_cast<const int*>(view_idx),
                 K,      static_cast<const float*>(params),
                 static_cast<const float*>(wgrids),
                 out,    OZ, OY, OX, TZ, TY, TX, org_z, org_y, org_x, per_view_z, SZ};
  return dispatch<Launch3D>(in_dtype, out_dtype, a, static_cast<cudaStream_t>(stream));
}

int mvs_fuse_translation_2d(const void* tiles, int in_dtype, int H, int W, const void* view_idx,
                            int K, const void* params, const void* wgrids, void* out,
                            int out_dtype, int OY, int OX, int TY, int TX, int org_y, int org_x,
                            void* stream) {
  const Args2D a{tiles, H, W, static_cast<const int*>(view_idx), K,
                 static_cast<const float*>(params), static_cast<const float*>(wgrids),
                 out,   OY, OX, TY, TX, org_y, org_x};
  return dispatch<Launch2D>(in_dtype, out_dtype, a, static_cast<cudaStream_t>(stream));
}

const char* mvs_error_string(int code) {
  if (code == kBadDtype) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
