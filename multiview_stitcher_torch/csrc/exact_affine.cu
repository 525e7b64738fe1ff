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
// What bounds them on the H100. On paper all three are bound by bytes: the f32
// output is written once (4 bytes a voxel) and the source window read about
// once in its own dtype, against 2 x ndim multiply-adds and 3 (2D) or 7 (3D)
// lerps a voxel. Measured on the first kernels, which gave a thread one pixel
// (2D), one voxel (general) or one (z, x) column of 16 rows (y-decoupled) and
// let it gather its 4 or 8 neighbours from global memory (H100 80GB HBM3,
// 700 W, builds with the gathers or the stores taken out):
// - the 2D and the general kernel were bound by their instruction count. 2D:
//   0.161 ms for 26 valid of 32 items of 1024^2, still 0.138 ms with neither
//   gathers nor stores. General: 0.218 ms for 12 x 128^3 voxels, 0.182 ms with
//   neither. Divisions for the block index, 12 or 20 parameter loads, 64-bit
//   addresses and integer conversions a voxel cost more than the memory
//   traffic, and a padding item went voxel by voxel through the same code;
// - the y-decoupled kernel was bound by its gathers: 0.106 ms for 4 x 128^3
//   voxels under rotations of 47, 92 and 137 degrees about y, 0.033 ms without
//   them. A warp lies along output x, which such a map spreads over as many
//   source z planes: one load touched up to 32 sectors for 64 useful bytes;
// - a cold L2 changed none by more than 3 %; parameters passed by value
//   changed nothing.
//
// The design, the same for all three:
// - a block of 256 threads owns an output tile: 64 x 32 (x, y) pixels in the 2D
//   kernel, where a thread takes two columns (lane, lane + 32) of four rows
//   and keeps its columns' products; 32 x 8 x 16 (x, y, z) voxels in the
//   general kernel; 32 x 16 (x, z) columns times 16 y rows in the y-decoupled
//   one. It loads the item's parameters into shared memory once, and two or
//   three threads compute, per axis, the range of stack indices the tile's
//   samples can touch. Every coordinate is a sum of products that are each
//   monotone in one output index, and rounding is monotone, so the extreme
//   coordinates of a tile are those of two of its corners, evaluated by the
//   voxels' own formula: the range is exact, with no safety margin;
// - the block copies that box from the stack into shared memory as f32, with
//   16-byte loads along source x where the rows allow it (x range widened to
//   16-byte boundaries; scalar loads otherwise), converting integers and
//   passing floats through nan_to_num on the way, so each source voxel is
//   converted once and global reads are coalesced whatever the rotation;
// - samples are interpolated from shared memory with 32-bit offsets; the
//   thread's products m * index are computed once and reused over its voxels.
//   A warp lies along output x, so its shared-memory reads fall on
//   neighbouring banks and its 4-byte stores fill whole lines (a thread that
//   owned four neighbouring pixels could store 16 bytes, but its warp's reads
//   would collide four ways);
// - the 3D tiles go in runs that fit the box budget (kBoxFloats: 48,000 bytes,
//   four blocks an SM). The y-decoupled kernel walks its y rows in runs of as
//   many as fit and keeps its columns' (z, x) taps and weights in registers
//   across the runs. The general kernel takes its 16 z planes at once, and
//   halves the run, down to 4 planes, while the box is too large. The 2D
//   kernel takes its tile whole: the box of a tile under any rotation, or a
//   map that downscales by 2, fits;
// - a tile or run none of whose samples can be valid, or whose item is
//   padding, is filled with cval (the 2D kernel: 16 bytes a store where the
//   output's rows allow it);
// - a tile or run whose box still exceeds the budget takes the large-footprint
//   route: the per-voxel global gathers of the first design, inside the same
//   kernel. A map that downscales (by 3 or more in 2D), a steep shear, or in
//   the general kernel a steep rotation (its 32-wide tile then spans some 25
//   planes) ends up there.
//
// Measured on the same card and batches: 2D kernel 0.070 ms (from 0.161;
// without its staging 0.060, without its stores 0.069, and writing its 134 MB
// of output alone takes 0.044); general kernel 0.076 ms (from 0.218; without
// its staging 0.060, without its shared-memory reads 0.068, and writing its
// 100 MB of output alone takes 0.034); y-decoupled kernel 0.058 ms (from
// 0.106; without its staging 0.033, without its shared-memory reads 0.042). A
// tile rotated by 47 degrees stages the bounding box of a rotated rectangle,
// 3.8 source voxels for each output voxel in 3D, and its warps read shared
// memory across rows; staging each source row's own x range halved the staged
// voxels but took as long (more, smaller loads), so the bounding box stayed.
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
// cudaErrorInvalidConfiguration for a grid too large (3D: more than 65,535
// items or z tiles, or 2^31 voxels an item). Nothing is allocated and nothing
// synchronises. Every launch takes an optional device array of three counters
// (blocks or runs that took the shared-memory route, the large-footprint
// route, the cval fill); a null pointer counts nothing.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBadDtype = -1;

// every block: 256 threads.
constexpr int kThreads3 = 256;
// 2D tile: 64 x 32 (x, y) pixels; a thread takes the columns lane and lane + 32
// of the rows warp, warp + 8, warp + 16 and warp + 24.
constexpr int kTX2 = 64, kTY2 = 32;
constexpr int kCols2 = kTX2 / 32, kRows2 = kTY2 / (kThreads3 / 32);
// general tile: 32 x 8 x 16 voxels; thread (x, y) walks the z planes.
constexpr int kGX = 32, kGY = 8, kGZ = 16;
// y-decoupled tile: 32 x 16 (x, z) columns, two a thread, times kSY y rows.
constexpr int kSX = 32, kSZ = 16, kSY = 16;
constexpr int kSCols = kSX * kSZ / kThreads3;
// floats of staged source a block may hold: four blocks fit an SM
constexpr int kBoxFloats = 12000;
// blocks an SM should hold, which caps a thread's registers: 64 in the general
// kernel, 80 in the y-decoupled one (which spills at 64 and runs slower)
constexpr int kGBlocksPerSM = 4, kSBlocksPerSM = 3, k2BlocksPerSM = 4;

enum DType : int { kF32 = 0, kU16 = 1, kU8 = 2 };
enum Route : int { kShared = 0, kGather = 1, kFill = 2 };

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
// what the three kernels share
// ---------------------------------------------------------------------------

struct Args2D {
  const void* data;     // (V, H, W)
  int V, H, W;
  const float* fparams; // (B, 8): m00 m01 m10 m11 | off | extent
  const int* iparams;   // (B, 4): source | start y x | valid
  float* out;           // (B, OY, OX)
  int OY, OX;
  float cval;
  int vec;                      // rows of the stack take 16-byte loads
  unsigned long long* routes;   // [kShared, kGather, kFill] counters, or null
};

struct Args3D {
  const void* data;     // (V, D, H, W)
  int V, D, H, W;
  const float* fparams; // (B, 15): 3 x 3 row-major | off | extent
  const int* iparams;   // (B, 5): source | start z y x | valid
  float* out;           // (B, OZ, OY, OX)
  int OZ, OY, OX;
  float cval;
  int vec;                      // rows of the stack take 16-byte loads
  unsigned long long* routes;   // [kShared, kGather, kFill] counters, or null
};

// one item's parameters and the block's box, in shared memory
struct Block3D {
  float f[15];
  int i[5];
  int lo[3], n[3];  // first stack index and count per axis; n == 0: no valid sample
};

__device__ __forceinline__ void load_item(const Args3D& a, int b, Block3D& s) {
  const int t = threadIdx.x;
  if (t < 15) {
    s.f[t] = a.fparams[static_cast<size_t>(b) * 15 + t];
  } else if (t < 20) {
    s.i[t - 15] = a.iparams[static_cast<size_t>(b) * 5 + (t - 15)];
  }
}

// Stack indices [lo, lo + n) that the taps of the valid samples of one axis
// touch, given the least and the largest coordinate of the tile there (exact:
// both are coordinates of tile corners). A valid sample has 0 <= c <= ext - 1,
// so its taps lie in [0, ext]; indices are clamped to the stack as tap() does.
__device__ __forceinline__ void tap_range(float cmin, float cmax, float ext, int start, int size,
                                          int& lo, int& n) {
  constexpr float kBig = 1e9f;  // keeps the conversions to int defined
  const int first = max(static_cast<int>(floorf(fminf(fmaxf(cmin, -kBig), kBig))), 0);
  const int last = min(static_cast<int>(floorf(fminf(fmaxf(cmax, -kBig), kBig))) + 1,
                       static_cast<int>(ceilf(fminf(fmaxf(ext, -kBig), kBig))));
  if (first > last || !(cmin <= cmax)) {
    lo = 0;
    n = 0;
    return;
  }
  lo = min(max(first + start, 0), size - 1);
  n = min(max(last + start, 0), size - 1) - lo + 1;
}

template <typename A>
__device__ __forceinline__ void count_route(const A& a, int route) {
  if (a.routes != nullptr && threadIdx.x == 0) atomicAdd(a.routes + route, 1ull);
}

// exact integer -> float without the conversion pipe: 2^23 + v has v in its
// low mantissa bits
__device__ __forceinline__ float small_uint_to_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}

// 16 bytes of source as floats
__device__ __forceinline__ void unpack(const uint4 q, float (&v)[4], const float*) {
  v[0] = nan_to_num(__uint_as_float(q.x));
  v[1] = nan_to_num(__uint_as_float(q.y));
  v[2] = nan_to_num(__uint_as_float(q.z));
  v[3] = nan_to_num(__uint_as_float(q.w));
}
__device__ __forceinline__ void unpack(const uint4 q, float (&v)[8], const uint16_t*) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = small_uint_to_float(w[k] & 0xFFFFu);
    v[2 * k + 1] = small_uint_to_float(w[k] >> 16);
  }
}
__device__ __forceinline__ void unpack(const uint4 q, float (&v)[16], const uint8_t*) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[4 * k + j] = small_uint_to_float((w[k] >> (8 * j)) & 0xFFu);
  }
}

// Row pitch in shared memory of a staged row of px floats. Widened rows are
// multiples of 8 floats, and a warp that walks source z (a view rotated by 90
// degrees) would then hit 4 banks; 4 more floats spread it over 8 and keep
// the rows' 16-byte alignment for float4 stores.
__device__ __forceinline__ int pitch_of(int px) { return px + 4; }

// A box of one source array, as the block sees it in shared memory.
struct Box {
  int z0, nz, y0, ny, x0, px;  // first index and count per axis
  int pitch;                   // floats between rows in shared memory
};

// x range [lo, lo + n) of a box widened to 16-byte boundaries where rows take
// 16-byte loads
template <typename T, typename A>
__device__ __forceinline__ void widen_x(const A& a, int lo, int n, Box& box) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  box.x0 = a.vec ? lo & ~(kVec - 1) : lo;
  box.px = a.vec ? ((lo + n - 1) | (kVec - 1)) - box.x0 + 1 : n;
  box.pitch = pitch_of(box.px);
}

// Copy the box from `src` (one (D, H, W) array of the stack; D = 1 and nz = 1
// in 2D) to s as f32: element (z, y, x) of the box goes to
// s[z * sz + y * sy + x].
template <typename T, typename A>
__device__ __forceinline__ void stage(const A& a, const T* src, const Box& bx, int sz, int sy,
                                      float* s) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int rows = bx.nz * bx.ny;
  // i / n as float2int((i + 0.5) / n): exact while i < 2^20, and a box holds
  // at most kBoxFloats elements
  const float inv_ny = 1.f / static_cast<float>(bx.ny);
  if (a.vec) {
    const int nv = bx.px / kVec, total = rows * nv;
    const float inv_nv = 1.f / static_cast<float>(nv);
    for (int i = threadIdx.x; i < total; i += kThreads3) {
      const int row = __float2int_rz((static_cast<float>(i) + 0.5f) * inv_nv), xv = i - row * nv;
      const int z = __float2int_rz((static_cast<float>(row) + 0.5f) * inv_ny), y = row - z * bx.ny;
      const T* p = src + (static_cast<size_t>(bx.z0 + z) * a.H + (bx.y0 + y)) * a.W + bx.x0;
      float v[kVec];
      unpack(__ldg(reinterpret_cast<const uint4*>(p) + xv), v, static_cast<const T*>(nullptr));
      float* d = s + z * sz + y * sy + xv * kVec;
#pragma unroll
      for (int k = 0; k < kVec; k += 4) {
        *reinterpret_cast<float4*>(d + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
    }
  } else {
    const int total = rows * bx.px;
    const float inv_px = 1.f / static_cast<float>(bx.px);
    for (int i = threadIdx.x; i < total; i += kThreads3) {
      const int row = __float2int_rz((static_cast<float>(i) + 0.5f) * inv_px), x = i - row * bx.px;
      const int z = __float2int_rz((static_cast<float>(row) + 0.5f) * inv_ny), y = row - z * bx.ny;
      s[z * sz + y * sy + x] =
          load(src + (static_cast<size_t>(bx.z0 + z) * a.H + (bx.y0 + y)) * a.W + bx.x0 + x);
    }
  }
}

// trilinear value from four row offsets (z lo/hi x y lo/hi) and the x taps
template <typename Read, typename Offset>
__device__ __forceinline__ float trilerp(Read at, Offset r00, Offset r01, Offset r10, Offset r11,
                                         const Tap& tx, float fy, float fz) {
  const float z0 = lerp(lerp(at(r00 + tx.lo), at(r00 + tx.hi), tx.f),
                        lerp(at(r01 + tx.lo), at(r01 + tx.hi), tx.f), fy);
  const float z1 = lerp(lerp(at(r10 + tx.lo), at(r10 + tx.hi), tx.f),
                        lerp(at(r11 + tx.lo), at(r11 + tx.hi), tx.f), fy);
  return lerp(z0, z1, fz);
}

// ---------------------------------------------------------------------------
// 2D
// ---------------------------------------------------------------------------

// one item's parameters and the tile's box, in shared memory
struct Block2D {
  float f[8];
  int i[4];
  int lo[2], n[2];  // first stack index and count per axis; n == 0: no valid sample
};

// The tile's pixels. kFromShared: taps are relative to the staged box and read
// from s; else they are stack indices and read from src.
template <typename T, bool kFromShared>
__device__ __forceinline__ void tile_2d(const Args2D& a, const Block2D& blk, const T* src,
                                        const float* s, const Box& box, float* out, int x0,
                                        int y0, int y1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the products of the thread's columns, reused over its rows
  float pj[kCols2][2];
#pragma unroll
  for (int k = 0; k < kCols2; ++k) {
    pj[k][0] = mul(blk.f[1], x0 + lane + 32 * k);
    pj[k][1] = mul(blk.f[3], x0 + lane + 32 * k);
  }
  const float m00 = blk.f[0], m10 = blk.f[2], off_y = blk.f[4], off_x = blk.f[5];
  const float ext_y = blk.f[6], ext_x = blk.f[7];
  const int sy = kFromShared ? blk.i[1] - box.y0 : blk.i[1], ny = kFromShared ? box.ny : a.H;
  const int sx = kFromShared ? blk.i[2] - box.x0 : blk.i[2], nx = kFromShared ? box.px : a.W;
  const int pitch = kFromShared ? box.pitch : a.W;
#pragma unroll
  for (int r = 0; r < kRows2; ++r) {
    const int i = y0 + warp + r * (kThreads3 / 32);
    if (i > y1) break;
    const float pi0 = mul(m00, i), pi1 = mul(m10, i);
    float* row = out + static_cast<size_t>(i) * a.OX;
#pragma unroll
    for (int k = 0; k < kCols2; ++k) {
      const int j = x0 + lane + 32 * k;
      if (j >= a.OX) break;
      const float u = __fadd_rn(__fadd_rn(pi0, pj[k][0]), off_y);
      const float v = __fadd_rn(__fadd_rn(pi1, pj[k][1]), off_x);
      float res = a.cval;
      if (inside(u, ext_y) && inside(v, ext_x)) {
        const Tap ty = tap(u, sy, ny), tx = tap(v, sx, nx);
        if (kFromShared) {
          const int r0 = ty.lo * pitch, r1 = ty.hi * pitch;
          res = lerp(lerp(s[r0 + tx.lo], s[r0 + tx.hi], tx.f),
                     lerp(s[r1 + tx.lo], s[r1 + tx.hi], tx.f), ty.f);
        } else {
          const T* r0 = src + static_cast<size_t>(ty.lo) * a.W;
          const T* r1 = src + static_cast<size_t>(ty.hi) * a.W;
          res = lerp(lerp(load(r0 + tx.lo), load(r0 + tx.hi), tx.f),
                     lerp(load(r1 + tx.lo), load(r1 + tx.hi), tx.f), ty.f);
        }
      }
      row[j] = res;
    }
  }
}

// cval over the tile, 16 bytes a store where the rows of the output allow it
__device__ __forceinline__ void fill_2d(const Args2D& a, float* out, int x0, int x1, int y0,
                                        int y1) {
  if (a.OX % 4 == 0) {
    // x0 and OX are multiples of 4, so the tile's rows are whole float4s
    const float4 c4 = make_float4(a.cval, a.cval, a.cval, a.cval);
    for (int t = threadIdx.x; t < (kTX2 / 4) * kTY2; t += kThreads3) {
      const int i = y0 + t / (kTX2 / 4), j = x0 + 4 * (t % (kTX2 / 4));
      if (i <= y1 && j <= x1) {
        *reinterpret_cast<float4*>(out + static_cast<size_t>(i) * a.OX + j) = c4;
      }
    }
  } else {
    for (int t = threadIdx.x; t < kTX2 * kTY2; t += kThreads3) {
      const int i = y0 + t / kTX2, j = x0 + t % kTX2;
      if (i <= y1 && j <= x1) out[static_cast<size_t>(i) * a.OX + j] = a.cval;
    }
  }
}

// blockIdx.x = (item * n_by + tile row) * n_bx + tile column
template <typename T>
__global__ void __launch_bounds__(kThreads3, k2BlocksPerSM)
    exact_affine_2d_kernel(const Args2D a, int n_by, int n_bx) {
  extern __shared__ __align__(16) float s_box[];
  __shared__ Block2D blk;
  int t = blockIdx.x;
  const int bx = t % n_bx;
  t /= n_bx;
  const int by = t % n_by, b = t / n_by;
  const int x0 = bx * kTX2, y0 = by * kTY2;
  const int x1 = min(x0 + kTX2, a.OX) - 1, y1 = min(y0 + kTY2, a.OY) - 1;
  if (threadIdx.x < 8) {
    blk.f[threadIdx.x] = a.fparams[static_cast<size_t>(b) * 8 + threadIdx.x];
  } else if (threadIdx.x < 12) {
    blk.i[threadIdx.x - 8] = a.iparams[static_cast<size_t>(b) * 4 + (threadIdx.x - 8)];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    // the least and the largest coordinate of row r over the tile: each term is
    // monotone in its index, so both are taken at a corner
    const int r = threadIdx.x;
    const float my = blk.f[2 * r], mx = blk.f[2 * r + 1], off = blk.f[4 + r];
    const float cmin =
        __fadd_rn(__fadd_rn(mul(my, my >= 0.f ? y0 : y1), mul(mx, mx >= 0.f ? x0 : x1)), off);
    const float cmax =
        __fadd_rn(__fadd_rn(mul(my, my >= 0.f ? y1 : y0), mul(mx, mx >= 0.f ? x1 : x0)), off);
    tap_range(cmin, cmax, blk.f[6 + r], blk.i[1 + r], r == 0 ? a.H : a.W, blk.lo[r], blk.n[r]);
  }
  __syncthreads();
  float* out = a.out + static_cast<size_t>(b) * a.OY * a.OX;
  if (!item_ok(blk.i[0], blk.i[3], a.V) || blk.n[0] == 0 || blk.n[1] == 0) {
    count_route(a, kFill);
    fill_2d(a, out, x0, x1, y0, y1);
    return;
  }
  const T* src = static_cast<const T*>(a.data) + static_cast<size_t>(blk.i[0]) * a.H * a.W;
  Box box{0, 1, blk.lo[0], blk.n[0], 0, 0, 0};
  widen_x<T>(a, blk.lo[1], blk.n[1], box);
  if (static_cast<long long>(box.ny) * box.pitch <= kBoxFloats) {
    count_route(a, kShared);
    stage(a, src, box, box.ny * box.pitch, box.pitch, s_box);
    __syncthreads();
    tile_2d<T, true>(a, blk, src, s_box, box, out, x0, y0, y1);
  } else {
    count_route(a, kGather);
    tile_2d<T, false>(a, blk, src, s_box, box, out, x0, y0, y1);
  }
}

// ---------------------------------------------------------------------------
// 3D, fully coupled maps: every source coordinate depends on every output index
// ---------------------------------------------------------------------------

// The tile's voxels, thread (x, y) walking z. kFromShared: taps are relative
// to the staged box (lo, n) and read from s; else they are stack indices and
// read from src.
template <typename T, bool kFromShared>
__device__ __forceinline__ void general_tile(const Args3D& a, const Block3D& blk, const T* src,
                                             const float* s, const Box& box, int b, int x0,
                                             int y0, int z0, int z1) {
  const int ox = x0 + (threadIdx.x & 31), oy = y0 + (threadIdx.x >> 5);
  if (ox >= a.OX || oy >= a.OY) return;
  float m0[3], pyx[2][3], off[3], ext[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    m0[r] = blk.f[3 * r];
    pyx[0][r] = mul(blk.f[3 * r + 1], oy);
    pyx[1][r] = mul(blk.f[3 * r + 2], ox);
    off[r] = blk.f[9 + r];
    ext[r] = blk.f[12 + r];
  }
  // tap() arguments per axis
  const int sz = kFromShared ? blk.i[1] - box.z0 : blk.i[1], nz = kFromShared ? box.nz : a.D;
  const int sy = kFromShared ? blk.i[2] - box.y0 : blk.i[2], ny = kFromShared ? box.ny : a.H;
  const int sx = kFromShared ? blk.i[3] - box.x0 : blk.i[3], nx = kFromShared ? box.px : a.W;
  const int pitch_y = kFromShared ? box.pitch : a.W;
  const int plane = a.OY * a.OX;
  float* out = a.out + ((static_cast<size_t>(b) * a.OZ + z0) * a.OY + oy) * a.OX + ox;
  for (int oz = z0; oz <= z1; ++oz, out += plane) {
    float c[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      c[r] = __fadd_rn(__fadd_rn(__fadd_rn(mul(m0[r], oz), pyx[0][r]), pyx[1][r]), off[r]);
    }
    float res = a.cval;
    if (inside(c[0], ext[0]) && inside(c[1], ext[1]) && inside(c[2], ext[2])) {
      const Tap tz = tap(c[0], sz, nz), ty = tap(c[1], sy, ny), tx = tap(c[2], sx, nx);
      if (kFromShared) {
        const int p0 = tz.lo * ny * pitch_y, p1 = tz.hi * ny * pitch_y;
        const int r0 = ty.lo * pitch_y, r1 = ty.hi * pitch_y;
        res = trilerp([s](int i) { return s[i]; }, p0 + r0, p0 + r1, p1 + r0, p1 + r1, tx, ty.f,
                      tz.f);
      } else {
        const size_t hw = static_cast<size_t>(a.H) * a.W;
        const size_t p0 = tz.lo * hw, p1 = tz.hi * hw;
        const size_t r0 = static_cast<size_t>(ty.lo) * a.W, r1 = static_cast<size_t>(ty.hi) * a.W;
        res = trilerp([src](size_t i) { return load(src + i); }, p0 + r0, p0 + r1, p1 + r0,
                      p1 + r1, tx, ty.f, tz.f);
      }
    }
    *out = res;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads3, kGBlocksPerSM)
    exact_affine_3d_general_kernel(const Args3D a, int n_bx) {
  extern __shared__ __align__(16) float s_box[];
  __shared__ Block3D blk;
  const int b = blockIdx.z;
  const int by = blockIdx.x / n_bx, bx = blockIdx.x - by * n_bx;
  const int x0 = bx * kGX, y0 = by * kGY, z0 = blockIdx.y * kGZ;
  const int x1 = min(x0 + kGX, a.OX) - 1, y1 = min(y0 + kGY, a.OY) - 1,
            z1 = min(z0 + kGZ, a.OZ) - 1;
  load_item(a, b, blk);
  __syncthreads();
  const bool ok = item_ok(blk.i[0], blk.i[4], a.V);
  const T* src = static_cast<const T*>(a.data) +
                 (ok ? static_cast<size_t>(blk.i[0]) * a.D * a.H * a.W : 0);
  // The tile's z planes go in runs. A run starts at the tile's depth; when its
  // box exceeds the budget it is tried again at half the depth, down to
  // kGZ / 4 planes. A run that does not fit even then takes the
  // large-footprint route, and with it the rest of the tile.
  int depth = kGZ;
  bool gave_up = false;
  for (int za = z0; za <= z1;) {
    const int zb = min(za + depth, z1 + 1) - 1;  // planes [za, zb]
    if (za != z0 || depth != kGZ) __syncthreads();  // the last run's reads are done
    if (threadIdx.x < 3) {
      // the least and the largest coordinate of row r over the run: each term
      // is monotone in its index, so both are taken at a corner
      const int r = threadIdx.x;
      const float mz = blk.f[3 * r], my = blk.f[3 * r + 1], mx = blk.f[3 * r + 2],
                  off = blk.f[9 + r];
      const float cmin = __fadd_rn(__fadd_rn(__fadd_rn(mul(mz, mz >= 0.f ? za : zb),
                                                       mul(my, my >= 0.f ? y0 : y1)),
                                             mul(mx, mx >= 0.f ? x0 : x1)), off);
      const float cmax = __fadd_rn(__fadd_rn(__fadd_rn(mul(mz, mz >= 0.f ? zb : za),
                                                       mul(my, my >= 0.f ? y1 : y0)),
                                             mul(mx, mx >= 0.f ? x1 : x0)), off);
      const int size = r == 0 ? a.D : r == 1 ? a.H : a.W;
      tap_range(cmin, cmax, blk.f[12 + r], blk.i[1 + r], size, blk.lo[r], blk.n[r]);
    }
    __syncthreads();
    if (!ok || blk.n[0] == 0 || blk.n[1] == 0 || blk.n[2] == 0) {
      count_route(a, kFill);
      const int ox = x0 + (threadIdx.x & 31), oy = y0 + (threadIdx.x >> 5);
      if (ox < a.OX && oy < a.OY) {
        const int plane = a.OY * a.OX;
        float* out = a.out + ((static_cast<size_t>(b) * a.OZ + za) * a.OY + oy) * a.OX + ox;
        for (int oz = za; oz <= zb; ++oz, out += plane) *out = a.cval;
      }
      za = zb + 1;
      continue;
    }
    Box box{blk.lo[0], blk.n[0], blk.lo[1], blk.n[1], 0, 0, 0};
    widen_x<T>(a, blk.lo[2], blk.n[2], box);
    if (static_cast<long long>(box.nz) * box.ny * box.pitch <= kBoxFloats) {
      count_route(a, kShared);
      stage(a, src, box, box.ny * box.pitch, box.pitch, s_box);
      __syncthreads();
      general_tile<T, true>(a, blk, src, s_box, box, b, x0, y0, za, zb);
    } else if (!gave_up && depth > kGZ / 4) {
      depth >>= 1;
      continue;
    } else {
      count_route(a, kGather);
      general_tile<T, false>(a, blk, src, s_box, box, b, x0, y0, za, zb);
      gave_up = true;
      depth = kGZ;
    }
    za = zb + 1;
  }
}

// ---------------------------------------------------------------------------
// 3D, y-decoupled maps: z and x of the source depend on (z, x) of the output,
// y of the source on y of the output alone
// ---------------------------------------------------------------------------

// a thread's (z, x) column: taps relative to the block's (z, x) box
struct Column {
  bool ok;
  Tap tz, tx;
};

// Rows [y_begin, y_end) of the thread's columns. kFromShared: the rows' source
// rows [box.y0, box.y0 + box.ny) are staged in s as [y][z][x].
template <typename T, bool kFromShared>
__device__ __forceinline__ void sepy_rows(const Args3D& a, const Block3D& blk, const T* src,
                                          const float* s, const Box& box,
                                          const Column* col, float* const* out, int y_begin,
                                          int y_end) {
  const float m11 = blk.f[4], off_y = blk.f[10], ext_y = blk.f[13];
  const int sy = kFromShared ? blk.i[2] - box.y0 : blk.i[2], ny = kFromShared ? box.ny : a.H;
  const int pitch_y = box.nz * box.pitch;
  for (int oy = y_begin; oy < y_end; ++oy) {
    const float u = __fadd_rn(mul(m11, oy), off_y);
    const bool row_ok = inside(u, ext_y);
    const Tap ty = tap(u, sy, ny);
#pragma unroll
    for (int k = 0; k < kSCols; ++k) {
      if (out[k] == nullptr) continue;
      float res = a.cval;
      if (row_ok && col[k].ok) {
        const Tap &tz = col[k].tz, &tx = col[k].tx;
        if (kFromShared) {
          const int r0 = ty.lo * pitch_y, r1 = ty.hi * pitch_y;
          const int p0 = tz.lo * box.pitch, p1 = tz.hi * box.pitch;
          res = trilerp([s](int i) { return s[i]; }, p0 + r0, p0 + r1, p1 + r0, p1 + r1, tx,
                        ty.f, tz.f);
        } else {
          // stack indices: the (z, x) taps are relative to the box
          const size_t hw = static_cast<size_t>(a.H) * a.W;
          const size_t p0 = (box.z0 + tz.lo) * hw + box.x0, p1 = (box.z0 + tz.hi) * hw + box.x0;
          const size_t r0 = static_cast<size_t>(ty.lo) * a.W,
                       r1 = static_cast<size_t>(ty.hi) * a.W;
          res = trilerp([src](size_t i) { return load(src + i); }, p0 + r0, p0 + r1, p1 + r0,
                        p1 + r1, tx, ty.f, tz.f);
        }
      }
      out[k][static_cast<size_t>(oy) * a.OX] = res;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads3, kSBlocksPerSM)
    exact_affine_3d_sepy_kernel(const Args3D a, int n_bx) {
  extern __shared__ __align__(16) float s_box[];
  __shared__ Block3D blk;
  const int b = blockIdx.z;
  const int bz = blockIdx.x / n_bx, bx = blockIdx.x - bz * n_bx;
  const int x0 = bx * kSX, z0 = bz * kSZ, y0 = blockIdx.y * kSY;
  const int x1 = min(x0 + kSX, a.OX) - 1, z1 = min(z0 + kSZ, a.OZ) - 1,
            y1 = min(y0 + kSY, a.OY) - 1;
  load_item(a, b, blk);
  __syncthreads();
  if (threadIdx.x < 3) {
    const int r = threadIdx.x;
    float cmin, cmax;
    if (r == 1) {
      const float m = blk.f[4], off = blk.f[10];
      cmin = __fadd_rn(mul(m, m >= 0.f ? y0 : y1), off);
      cmax = __fadd_rn(mul(m, m >= 0.f ? y1 : y0), off);
    } else {
      const float mz = blk.f[3 * r], mx = blk.f[3 * r + 2], off = blk.f[9 + r];
      cmin = __fadd_rn(__fadd_rn(mul(mz, mz >= 0.f ? z0 : z1), mul(mx, mx >= 0.f ? x0 : x1)), off);
      cmax = __fadd_rn(__fadd_rn(mul(mz, mz >= 0.f ? z1 : z0), mul(mx, mx >= 0.f ? x1 : x0)), off);
    }
    const int size = r == 0 ? a.D : r == 1 ? a.H : a.W;
    tap_range(cmin, cmax, blk.f[12 + r], blk.i[1 + r], size, blk.lo[r], blk.n[r]);
  }
  __syncthreads();

  // the thread's columns: x = lane, z = warp and warp + 8
  const int ox = x0 + (threadIdx.x & 31);
  float* out[kSCols];
#pragma unroll
  for (int k = 0; k < kSCols; ++k) {
    const int oz = z0 + (threadIdx.x >> 5) + k * (kThreads3 / kSX);
    out[k] = ox < a.OX && oz <= z1
                 ? a.out + ((static_cast<size_t>(b) * a.OZ + oz) * a.OY) * a.OX + ox
                 : nullptr;
  }
  const bool ok = item_ok(blk.i[0], blk.i[4], a.V);
  if (!ok || blk.n[0] == 0 || blk.n[1] == 0 || blk.n[2] == 0) {
    count_route(a, kFill);
#pragma unroll
    for (int k = 0; k < kSCols; ++k) {
      if (out[k] == nullptr) continue;
      for (int oy = y0; oy <= y1; ++oy) out[k][static_cast<size_t>(oy) * a.OX] = a.cval;
    }
    return;
  }
  const T* src = static_cast<const T*>(a.data) + static_cast<size_t>(blk.i[0]) * a.D * a.H * a.W;
  Box box{blk.lo[0], blk.n[0], 0, 0, 0, 0, 0};
  widen_x<T>(a, blk.lo[2], blk.n[2], box);

  Column col[kSCols];
#pragma unroll
  for (int k = 0; k < kSCols; ++k) {
    const int oz = z0 + (threadIdx.x >> 5) + k * (kThreads3 / kSX);
    const float w = __fadd_rn(__fadd_rn(mul(blk.f[0], oz), mul(blk.f[2], ox)), blk.f[9]);
    const float v = __fadd_rn(__fadd_rn(mul(blk.f[6], oz), mul(blk.f[8], ox)), blk.f[11]);
    col[k].ok = inside(w, blk.f[12]) && inside(v, blk.f[14]);
    col[k].tz = tap(w, blk.i[1] - box.z0, box.nz);
    col[k].tx = tap(v, blk.i[3] - box.x0, box.px);
  }

  // source rows a box can hold beside its (z, x) footprint; y rows of output
  // go in runs that need no more. n output rows need at most |m11| (n - 1) + 3.
  const long long footprint = static_cast<long long>(box.nz) * box.pitch;
  const int rows_fit = static_cast<int>(min(static_cast<long long>(kBoxFloats) / footprint,
                                            static_cast<long long>(a.H)));
  const float m11 = blk.f[4], off_y = blk.f[10];
  int run = 1;
  if (rows_fit >= 3) {
    const float fit = static_cast<float>(rows_fit - 3) / fmaxf(fabsf(m11), 1e-6f);
    run = 1 + static_cast<int>(fminf(fit, static_cast<float>(kSY)));
  }
  bool staged = false;
  for (int ya = y0; ya <= y1; ya += run) {
    const int yb = min(ya + run, y1 + 1) - 1;  // rows [ya, yb]
    const float cmin = __fadd_rn(mul(m11, m11 >= 0.f ? ya : yb), off_y);
    const float cmax = __fadd_rn(mul(m11, m11 >= 0.f ? yb : ya), off_y);
    tap_range(cmin, cmax, blk.f[13], blk.i[2], a.H, box.y0, box.ny);
    if (box.ny == 0) {
      count_route(a, kFill);
#pragma unroll
      for (int k = 0; k < kSCols; ++k) {
        if (out[k] == nullptr) continue;
        for (int oy = ya; oy <= yb; ++oy) out[k][static_cast<size_t>(oy) * a.OX] = a.cval;
      }
    } else if (box.ny <= rows_fit) {
      count_route(a, kShared);
      if (staged) __syncthreads();  // the last run's reads are done
      stage(a, src, box, box.pitch, box.nz * box.pitch, s_box);
      __syncthreads();
      staged = true;
      sepy_rows<T, true>(a, blk, src, s_box, box, col, out, ya, yb + 1);
    } else {
      count_route(a, kGather);
      sepy_rows<T, false>(a, blk, src, s_box, box, col, out, ya, yb + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// blocks of one launch as a 1-D grid, or -1 when they exceed its limit
int grid_1d(long long blocks) { return blocks > INT_MAX ? -1 : static_cast<int>(blocks); }

// rows of the stack take 16-byte loads: the base is aligned and W is a
// multiple of the vector
template <typename T, typename A>
A with_vec(A a) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  a.vec = reinterpret_cast<uintptr_t>(a.data) % 16 == 0 && a.W % kVec == 0;
  return a;
}

constexpr size_t kBoxBytes = kBoxFloats * sizeof(float);
static_assert(kBoxBytes + sizeof(Block3D) <= 48 * 1024,
              "dynamic shared memory above 48 KB needs cudaFuncSetAttribute");

template <typename T>
int launch_2d(const Args2D& args, int B, cudaStream_t stream) {
  const Args2D a = with_vec<T>(args);
  const int n_by = cdiv(a.OY, kTY2), n_bx = cdiv(a.OX, kTX2);
  const int grid = grid_1d(static_cast<long long>(B) * n_by * n_bx);
  if (grid < 0) return cudaErrorInvalidConfiguration;
  exact_affine_2d_kernel<T><<<grid, kThreads3, kBoxBytes, stream>>>(a, n_by, n_bx);
  return static_cast<int>(cudaGetLastError());
}

// grid (tiles of two axes, tiles of the third, items), or an error
bool grid_3d(const Args3D& a, long long n_xy, int n_third, int B, dim3& grid) {
  if (n_xy > INT_MAX || n_third > 65535 || B > 65535 ||
      static_cast<long long>(a.OZ) * a.OY * a.OX > INT_MAX) {
    return false;
  }
  grid = dim3(static_cast<unsigned>(n_xy), static_cast<unsigned>(n_third),
              static_cast<unsigned>(B));
  return true;
}

template <typename T>
int launch_3d_sepy(const Args3D& args, int B, cudaStream_t stream) {
  const Args3D a = with_vec<T>(args);
  const int n_bx = cdiv(a.OX, kSX);
  dim3 grid;
  if (!grid_3d(a, static_cast<long long>(n_bx) * cdiv(a.OZ, kSZ), cdiv(a.OY, kSY), B, grid)) {
    return cudaErrorInvalidConfiguration;
  }
  exact_affine_3d_sepy_kernel<T><<<grid, kThreads3, kBoxBytes, stream>>>(a, n_bx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_3d_general(const Args3D& args, int B, cudaStream_t stream) {
  const Args3D a = with_vec<T>(args);
  const int n_bx = cdiv(a.OX, kGX);
  dim3 grid;
  if (!grid_3d(a, static_cast<long long>(n_bx) * cdiv(a.OY, kGY), cdiv(a.OZ, kGZ), B, grid)) {
    return cudaErrorInvalidConfiguration;
  }
  exact_affine_3d_general_kernel<T><<<grid, kThreads3, kBoxBytes, stream>>>(a, n_bx);
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
                        void* routes, void* stream) {
  const Args2D a{data, V, H, W, static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams), static_cast<float*>(out), OY, OX, cval, 0,
                 static_cast<unsigned long long*>(routes)};
  MVS_DISPATCH(dtype, launch_2d, a, B, static_cast<cudaStream_t>(stream))
}

int mvs_exact_affine_3d_sepy(const void* data, int dtype, int V, int D, int H, int W,
                             const void* fparams, const void* iparams, int B, void* out, int OZ,
                             int OY, int OX, float cval, void* routes, void* stream) {
  const Args3D a{data, V, D, H, W, static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams), static_cast<float*>(out), OZ, OY, OX, cval, 0,
                 static_cast<unsigned long long*>(routes)};
  MVS_DISPATCH(dtype, launch_3d_sepy, a, B, static_cast<cudaStream_t>(stream))
}

int mvs_exact_affine_3d_general(const void* data, int dtype, int V, int D, int H, int W,
                                const void* fparams, const void* iparams, int B, void* out,
                                int OZ, int OY, int OX, float cval, void* routes, void* stream) {
  const Args3D a{data, V, D, H, W, static_cast<const float*>(fparams),
                 static_cast<const int*>(iparams), static_cast<float*>(out), OZ, OY, OX, cval, 0,
                 static_cast<unsigned long long*>(routes)};
  MVS_DISPATCH(dtype, launch_3d_general, a, B, static_cast<cudaStream_t>(stream))
}

const char* mvs_error_string(int code) {
  if (code == kBadDtype) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
