// Exact affine resampling kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of multiview_stitcher_tpu/ops/exact_affine.py:
//   exact_affine_2d_kernel          <- _exact2d_kernel         (wrapper exact_affine_batch_2d)
//   exact_affine_3d_sepy_kernel     <- _exact3d_sepy_kernel    (wrapper exact_affine_batch_3d_sepy)
//   exact_affine_3d_general_kernel  <- _exact3d_general_kernel (wrapper exact_affine_batch_3d_general)
//
// Each resamples B items with exact bi/trilinear interpolation: output pixel n
// of item b samples the source at mat[b] @ n + off[b]; a coordinate outside
// [0, extent[b] - 1] gives exactly cval (scipy affine_transform, order 1,
// mode 'constant'). An item names its source array in a (V, *S) stack and an
// integer start inside it, so a batch of chunk/view pairs samples straight from
// the resident tile stack; an item that is marked invalid, or names a source
// outside the stack, is filled with cval.
//
// What bounds them on the H100: memory. The f32 output is written once (4 bytes
// a voxel) and the source window is read about once in its own dtype, against
// 2 x ndim multiply-adds for the coordinates and 3 (2D) or 7 (3D) lerps a
// voxel: bytes over 3.35 TB/s exceed operations over 67 TFLOP/s several times.
// The design:
// - no window, no padded copy, no matmul: a thread computes its coordinate,
//   takes floor and the fraction, reads its 4 or 8 neighbours through the
//   read-only path and lerps. The source is read in its native dtype and
//   converted in registers (float input through nan_to_num), so no f32 copy of
//   the stack exists;
// - threads of a warp lie along x of the output, so the store is coalesced and
//   neighbouring threads read source addresses one map column apart, which a
//   near-identity map keeps within a few cache lines and any map keeps within
//   L2 for a chunk-sized window;
// - the y-decoupled kernel gives a thread one (z, x) output column: the (z, x)
//   coordinates, their mask, the four (z, x) taps and both weights are computed
//   once and reused over the block's y rows, where only y's index and fraction
//   change. The general kernel computes all three coordinates per voxel.
//
// What the TPU kernels did that does not come across: the zero-padded copy of
// the input, the (8, 128)-aligned window DMAs, the banded-hat matmuls on the
// MXU and the lane-flattened output tiles (Mosaic has no gather). The numerics
// that do come across:
// - the mask is computed in f32 from the absolute output index as
//   m_r0 * i0 + m_r1 * i1 (+ m_r2 * i2) + off_r, left to right, every multiply
//   and add rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction, or a
//   pixel on a view border flips between its value and cval). The y-decoupled
//   kernel uses m00 * z + m02 * x, m11 * y and m20 * z + m22 * x;
// - the value is interpolated at the same coordinate, x first, then y, then z;
// - a read one past the last valid row, column or plane has lerp weight
//   exactly 0; its index is clamped to the array.
//
// Interface: plain C, loaded with ctypes. Every launch returns the cudaError_t
// of cudaGetLastError() (0 on success), kBadDtype for an unsupported dtype, or
// cudaErrorInvalidConfiguration for a grid too large. Nothing is allocated and
// nothing synchronises.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBadDtype = -1;

// 2D block: 32 x 8 threads, one output pixel each.
constexpr int kBX2 = 32, kBY2 = 8;
// y-decoupled 3D block: 32 (x) x 4 (z) threads, each walking kYC y rows.
constexpr int kBXS = 32, kBZS = 4, kYC = 16;
// general 3D block: 32 x 4 x 2 threads, one output voxel each.
constexpr int kBXG = 32, kBYG = 4, kBZG = 2;

enum DType : int { kF32 = 0, kU16 = 1, kU8 = 2 };

// jnp.nan_to_num / torch.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

__device__ __forceinline__ float load(const float* p) { return nan_to_num(__ldg(p)); }
__device__ __forceinline__ float load(const uint16_t* p) { return static_cast<float>(__ldg(p)); }
__device__ __forceinline__ float load(const uint8_t* p) { return static_cast<float>(__ldg(p)); }

// a * i, one rounding
__device__ __forceinline__ float mul(float a, int i) {
  return __fmul_rn(a, static_cast<float>(i));
}

__device__ __forceinline__ float lerp(float p, float q, float f) { return (1.f - f) * p + f * q; }

__device__ __forceinline__ bool inside(float c, float ext) { return c >= 0.f && c <= ext - 1.f; }

// Lower tap (clamped), upper tap (clamped) and fraction of coordinate c along
// an axis of `size` entries whose item starts at `start`.
struct Tap {
  int lo, hi;
  float f;
};
__device__ __forceinline__ Tap tap(float c, int start, int size) {
  const float fl = floorf(c);
  const int i = start + static_cast<int>(fl);
  return {min(max(i, 0), size - 1), min(max(i + 1, 0), size - 1), __fsub_rn(c, fl)};
}

// an item is sampled when it is marked valid and names a source of the stack
__device__ __forceinline__ bool item_ok(int source, int valid, int V) {
  return valid != 0 && source >= 0 && source < V;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// 2D
// ---------------------------------------------------------------------------

struct Args2D {
  const void* data;     // (V, H, W)
  int V, H, W;
  const float* fparams; // (B, 8): m00 m01 m10 m11 | off | extent
  const int* iparams;   // (B, 4): source | start y x | valid
  float* out;           // (B, OY, OX)
  int OY, OX;
  float cval;
};

template <typename T>
__global__ void __launch_bounds__(kBX2* kBY2)
    exact_affine_2d_kernel(const Args2D a, int n_by, int n_bx) {
  int blk = blockIdx.x;
  const int bx = blk % n_bx;
  blk /= n_bx;
  const int by = blk % n_by;
  const int b = blk / n_by;
  const int i = by * kBY2 + threadIdx.y;
  const int j = bx * kBX2 + threadIdx.x;
  if (i >= a.OY || j >= a.OX) return;

  const float* fp = a.fparams + static_cast<size_t>(b) * 8;
  const int* ip = a.iparams + static_cast<size_t>(b) * 4;
  float res = a.cval;
  if (item_ok(ip[0], ip[3], a.V)) {
    const float u = __fadd_rn(__fadd_rn(mul(fp[0], i), mul(fp[1], j)), fp[4]);
    const float v = __fadd_rn(__fadd_rn(mul(fp[2], i), mul(fp[3], j)), fp[5]);
    if (inside(u, fp[6]) && inside(v, fp[7])) {
      const Tap ty = tap(u, ip[1], a.H), tx = tap(v, ip[2], a.W);
      const T* src = static_cast<const T*>(a.data) + static_cast<size_t>(ip[0]) * a.H * a.W;
      const T* r0 = src + static_cast<size_t>(ty.lo) * a.W;
      const T* r1 = src + static_cast<size_t>(ty.hi) * a.W;
      res = lerp(lerp(load(r0 + tx.lo), load(r0 + tx.hi), tx.f),
                 lerp(load(r1 + tx.lo), load(r1 + tx.hi), tx.f), ty.f);
    }
  }
  a.out[(static_cast<size_t>(b) * a.OY + i) * a.OX + j] = res;
}

// ---------------------------------------------------------------------------
// 3D
// ---------------------------------------------------------------------------

struct Args3D {
  const void* data;     // (V, D, H, W)
  int V, D, H, W;
  const float* fparams; // (B, 15): 3 x 3 row-major | off | extent
  const int* iparams;   // (B, 5): source | start z y x | valid
  float* out;           // (B, OZ, OY, OX)
  int OZ, OY, OX;
  float cval;
};

// y-decoupled maps: z and x of the source depend on (z, x) of the output, y of
// the source on y of the output alone.
template <typename T>
__global__ void __launch_bounds__(kBXS* kBZS)
    exact_affine_3d_sepy_kernel(const Args3D a, int n_bz, int n_byc, int n_bx) {
  int blk = blockIdx.x;
  const int bx = blk % n_bx;
  blk /= n_bx;
  const int byc = blk % n_byc;
  blk /= n_byc;
  const int bz = blk % n_bz;
  const int b = blk / n_bz;
  const int oz = bz * kBZS + threadIdx.y;
  const int ox = bx * kBXS + threadIdx.x;
  if (oz >= a.OZ || ox >= a.OX) return;
  const int y_begin = byc * kYC;
  const int y_end = min(y_begin + kYC, a.OY);

  const float* fp = a.fparams + static_cast<size_t>(b) * 15;
  const int* ip = a.iparams + static_cast<size_t>(b) * 5;
  float* out = a.out + ((static_cast<size_t>(b) * a.OZ + oz) * a.OY) * a.OX + ox;

  bool ok = item_ok(ip[0], ip[4], a.V);
  float w = 0.f, v = 0.f;
  if (ok) {
    w = __fadd_rn(__fadd_rn(mul(fp[0], oz), mul(fp[2], ox)), fp[9]);
    v = __fadd_rn(__fadd_rn(mul(fp[6], oz), mul(fp[8], ox)), fp[11]);
    ok = inside(w, fp[12]) && inside(v, fp[14]);
  }
  if (!ok) {
    for (int oy = y_begin; oy < y_end; ++oy) out[static_cast<size_t>(oy) * a.OX] = a.cval;
    return;
  }
  const Tap tz = tap(w, ip[1], a.D), tx = tap(v, ip[3], a.W);
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const T* src = static_cast<const T*>(a.data) + static_cast<size_t>(ip[0]) * a.D * plane;
  const T* p0 = src + tz.lo * plane;
  const T* p1 = src + tz.hi * plane;
  const float m11 = fp[4], off_y = fp[10], ext_y = fp[13];
  const int start_y = ip[2];
  for (int oy = y_begin; oy < y_end; ++oy) {
    const float u = __fadd_rn(mul(m11, oy), off_y);
    float res = a.cval;
    if (inside(u, ext_y)) {
      const Tap ty = tap(u, start_y, a.H);
      const size_t r0 = static_cast<size_t>(ty.lo) * a.W, r1 = static_cast<size_t>(ty.hi) * a.W;
      const float z0 = lerp(lerp(load(p0 + r0 + tx.lo), load(p0 + r0 + tx.hi), tx.f),
                            lerp(load(p0 + r1 + tx.lo), load(p0 + r1 + tx.hi), tx.f), ty.f);
      const float z1 = lerp(lerp(load(p1 + r0 + tx.lo), load(p1 + r0 + tx.hi), tx.f),
                            lerp(load(p1 + r1 + tx.lo), load(p1 + r1 + tx.hi), tx.f), ty.f);
      res = lerp(z0, z1, tz.f);
    }
    out[static_cast<size_t>(oy) * a.OX] = res;
  }
}

// fully coupled maps: every source coordinate depends on every output index
template <typename T>
__global__ void __launch_bounds__(kBXG* kBYG* kBZG)
    exact_affine_3d_general_kernel(const Args3D a, int n_bz, int n_by, int n_bx) {
  int blk = blockIdx.x;
  const int bx = blk % n_bx;
  blk /= n_bx;
  const int by = blk % n_by;
  blk /= n_by;
  const int bz = blk % n_bz;
  const int b = blk / n_bz;
  const int oz = bz * kBZG + threadIdx.z;
  const int oy = by * kBYG + threadIdx.y;
  const int ox = bx * kBXG + threadIdx.x;
  if (oz >= a.OZ || oy >= a.OY || ox >= a.OX) return;

  const float* fp = a.fparams + static_cast<size_t>(b) * 15;
  const int* ip = a.iparams + static_cast<size_t>(b) * 5;
  float res = a.cval;
  if (item_ok(ip[0], ip[4], a.V)) {
    float c[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      c[r] = __fadd_rn(
          __fadd_rn(__fadd_rn(mul(fp[3 * r], oz), mul(fp[3 * r + 1], oy)), mul(fp[3 * r + 2], ox)),
          fp[9 + r]);
    }
    if (inside(c[0], fp[12]) && inside(c[1], fp[13]) && inside(c[2], fp[14])) {
      const Tap tz = tap(c[0], ip[1], a.D), ty = tap(c[1], ip[2], a.H), tx = tap(c[2], ip[3], a.W);
      const size_t plane = static_cast<size_t>(a.H) * a.W;
      const T* src = static_cast<const T*>(a.data) + static_cast<size_t>(ip[0]) * a.D * plane;
      const T* p0 = src + tz.lo * plane;
      const T* p1 = src + tz.hi * plane;
      const size_t r0 = static_cast<size_t>(ty.lo) * a.W, r1 = static_cast<size_t>(ty.hi) * a.W;
      const float z0 = lerp(lerp(load(p0 + r0 + tx.lo), load(p0 + r0 + tx.hi), tx.f),
                            lerp(load(p0 + r1 + tx.lo), load(p0 + r1 + tx.hi), tx.f), ty.f);
      const float z1 = lerp(lerp(load(p1 + r0 + tx.lo), load(p1 + r0 + tx.hi), tx.f),
                            lerp(load(p1 + r1 + tx.lo), load(p1 + r1 + tx.hi), tx.f), ty.f);
      res = lerp(z0, z1, tz.f);
    }
  }
  a.out[((static_cast<size_t>(b) * a.OZ + oz) * a.OY + oy) * a.OX + ox] = res;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// blocks of one launch as a 1-D grid, or -1 when they exceed its limit
int grid_1d(long long blocks) { return blocks > INT_MAX ? -1 : static_cast<int>(blocks); }

template <typename T>
int launch_2d(const Args2D& a, int B, cudaStream_t stream) {
  const int n_by = cdiv(a.OY, kBY2), n_bx = cdiv(a.OX, kBX2);
  const int grid = grid_1d(static_cast<long long>(B) * n_by * n_bx);
  if (grid < 0) return cudaErrorInvalidConfiguration;
  exact_affine_2d_kernel<T><<<grid, dim3(kBX2, kBY2), 0, stream>>>(a, n_by, n_bx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_3d_sepy(const Args3D& a, int B, cudaStream_t stream) {
  const int n_bz = cdiv(a.OZ, kBZS), n_byc = cdiv(a.OY, kYC), n_bx = cdiv(a.OX, kBXS);
  const int grid = grid_1d(static_cast<long long>(B) * n_bz * n_byc * n_bx);
  if (grid < 0) return cudaErrorInvalidConfiguration;
  exact_affine_3d_sepy_kernel<T><<<grid, dim3(kBXS, kBZS), 0, stream>>>(a, n_bz, n_byc, n_bx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_3d_general(const Args3D& a, int B, cudaStream_t stream) {
  const int n_bz = cdiv(a.OZ, kBZG), n_by = cdiv(a.OY, kBYG), n_bx = cdiv(a.OX, kBXG);
  const int grid = grid_1d(static_cast<long long>(B) * n_bz * n_by * n_bx);
  if (grid < 0) return cudaErrorInvalidConfiguration;
  exact_affine_3d_general_kernel<T>
      <<<grid, dim3(kBXG, kBYG, kBZG), 0, stream>>>(a, n_bz, n_by, n_bx);
  return static_cast<int>(cudaGetLastError());
}

#define MVS_DISPATCH(dtype, fn, ...)                  \
  switch (dtype) {                                    \
    case kF32: return fn<float>(__VA_ARGS__);         \
    case kU16: return fn<uint16_t>(__VA_ARGS__);      \
    case kU8: return fn<uint8_t>(__VA_ARGS__);        \
  }                                                   \
  return kBadDtype;

}  // namespace

extern "C" {

int mvs_exact_affine_2d(const void* data, int dtype, int V, int H, int W, const void* fparams,
                        const void* iparams, int B, void* out, int OY, int OX, float cval,
                        void* stream) {
  const Args2D a{data, V, H, W, static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams), static_cast<float*>(out), OY, OX, cval};
  MVS_DISPATCH(dtype, launch_2d, a, B, static_cast<cudaStream_t>(stream))
}

int mvs_exact_affine_3d_sepy(const void* data, int dtype, int V, int D, int H, int W,
                             const void* fparams, const void* iparams, int B, void* out, int OZ,
                             int OY, int OX, float cval, void* stream) {
  const Args3D a{data, V, D, H, W, static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams), static_cast<float*>(out), OZ, OY, OX, cval};
  MVS_DISPATCH(dtype, launch_3d_sepy, a, B, static_cast<cudaStream_t>(stream))
}

int mvs_exact_affine_3d_general(const void* data, int dtype, int V, int D, int H, int W,
                                const void* fparams, const void* iparams, int B, void* out,
                                int OZ, int OY, int OX, float cval, void* stream) {
  const Args3D a{data, V, D, H, W, static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams), static_cast<float*>(out), OZ, OY, OX, cval};
  MVS_DISPATCH(dtype, launch_3d_general, a, B, static_cast<cudaStream_t>(stream))
}

const char* mvs_error_string(int code) {
  if (code == kBadDtype) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
