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
// What bounds them on the H100. On paper, memory: each output pixel is read
// from about 1.3-1.5 views on the main paths and written once, at a few tens
// of f32 operations per covering view, against 3.35 TB/s and 67 TFLOP/s.
// Measured (H100 80GB HBM3, 700 W), it is the instruction count. The first
// designs gave a thread one pixel and took 7.5 ms (3D, output (64, 1676, 1676)
// uint16 from 1024 views of 64^3) and 5.4 ms (2D, output 14400^2 uint16 from
// 1024 views of 512^2); with neither gathers nor stores they still took 4.4
// ms each: per pixel and view they ran both validity tests, both sample
// positions, all 5^ndim hats and the whole hat sum, some 230 machine
// operations in 2D. The kernels below take 2.2 ms (3D) and 1.46 ms (2D); the
// 2D one 1.13 ms with neither gathers nor stores, at some 70 operations per
// pixel and view.
//
// The design:
// - gather straight from the (V, [D,] H, W) stack in its native dtype, so a
//   uint16 stack moves 2 bytes a voxel and no f32 copy of it is ever made;
//   the maps are translations, so a warp's taps are neighbours in x and the
//   2x2(x2) lerp neighbourhood is shared through L1;
// - a block owns a part of one view-list tile that fuse() sizes to it, so a
//   list is staged once for many pixels: (64, 8, 32) in 3D, (64, 32) in 2D.
//   Whatever does not depend on all the indices is computed once a block
//   into shared-memory tables: per view and row or column the tap offsets,
//   the fraction, the validity and the two hats that are not 0; in 3D per
//   view and plane the two source planes, the z fraction, the z validity and
//   the five z hats. A thread owns one column and walks it in runs (3D: 8
//   planes, 2D: 4 rows) with the run's sums in registers, so the view loop is
//   outside the run's loop;
// - only the hat terms that are not 0 are summed (a term with a hat of 0
//   adds exactly 0, so the sums keep their bits): per view and run the four
//   y/x terms in 3D, per row the four terms in 2D;
// - the upper plane (3D, uniform mode, stride 1) or row (2D, where the row
//   table shows it) of one output plane or row is the lower one of the next,
//   and its taps stay in registers;
// - the loop over a run reads every tap, valid or not (the tables' offsets
//   are clamped), and has no branch before its last tap is read, so the
//   run's loads are in flight together. A tap's address is one 32-bit
//   offset added to a 64-bit base;
// - 3D: a warp takes 16 x 2 columns, not 32 x 1: its loads and stores still
//   fill 32-byte sectors, and fewer of its lanes idle through a view that
//   only part of the warp is in. 2D: a warp takes one run of 32 columns, so
//   its lanes share the row table's entries, and a view whose rows miss the
//   run is skipped (each slot keeps the rows it is valid on, by ballot);
// - 2D: a thread walks two runs of 4 rows and five blocks share an SM (48
//   registers): against one run of 8 rows at three blocks, more warps hide
//   more of the gathers' latency;
// - the taper keeps cosf: with the hardware cosine (absolute error 4e-7) a
//   voxel whose weights are all near 0 moved by 0.04 on data up to 900, past
//   the tolerance against the plain version. In 2D it stays behind a branch
//   (most of a tile has w >= 1) and out of line, so that cosf's slow path is
//   not copied into every row of the unrolled loop;
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
// - the 3D hat expansion is summed as sum_i hz (sum_j hy (sum_k g hx)), the
//   2D one row-major, each term (g hy) hx;
// - slots are summed in ascending slot order.
// Reads at a view's last row/column/plane clamp the index to the stack; the
// clamped neighbour has lerp weight 0 there, so the sum is the same.
//
// Interface: plain C, loaded with ctypes. Every launch returns the
// cudaError_t of cudaGetLastError() (0 on success), kBadDtype for an
// unsupported dtype, or cudaErrorInvalidConfiguration for a grid too large
// (3D: a source plane of 2 GiB or more; 2D: a view of 2^31 pixels or more).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBadDtype = -1;
constexpr float kPi = 3.14159265358979323846f;

// 3D block: 32 x 8 threads, one (y, x) column each, walking up to kZSpan planes
// of a view-list tile, kZRun planes at a time in registers. It stages
// kSlotChunk3 view slots per pass; three blocks share an SM.
constexpr int kBX3 = 32, kBY3 = 8;
constexpr int kZSpan = 64, kZRun = 8;
constexpr int kSlotChunk3 = 8;
static_assert(kZSpan % kZRun == 0, "a span is whole runs");
constexpr int kBlocksPerSM3 = 3;
// 2D block: 32 x 8 threads. A thread owns one column and kRuns2 runs of kRun2
// rows, one after the other, with a run's sums in registers; a warp owns the
// same runs of all 32 columns, so its lanes walk the same rows. A block covers
// kBH2 rows of a view-list tile and stages kSlotChunk2 view slots per pass,
// one a warp; five blocks share an SM (48 registers a thread).
constexpr int kBX2 = 32, kBY2 = 8, kRun2 = 4, kRuns2 = 2;
constexpr int kBH2 = kBY2 * kRun2 * kRuns2;
constexpr int kSlotChunk2 = 8;
constexpr int kBlocksPerSM2 = 5;
static_assert(kBX2 == 32 && kBH2 % 32 == 0, "a warp builds a slot's tables 32 entries at a time");
static_assert(kSlotChunk2 <= kBY2, "a warp builds one slot's tables");

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

// (cos((1 - w) * pi) + 1) / 2, out of line: inlined, cosf's slow path (large
// arguments, which a weight never gives) is copied into every call site
__device__ __noinline__ float taper_cos(float w) { return (cosf((1.f - w) * kPi) + 1.f) / 2.f; }

// cosine taper of values < 1, then the clip to [0, 1]; most of a 2D tile has
// w >= 1, and skips the cosine
__device__ __forceinline__ float taper(float w) {
  if (w < 1.f) w = taper_cos(w);
  return fminf(fmaxf(w, 0.f), 1.f);
}

// The same without a branch, for a loop whose planes are to overlap: the
// cosine is taken of every w and dropped where w >= 1.
__device__ __forceinline__ float taper_select(float w) {
  const float t = (cosf((1.f - w) * kPi) + 1.f) / 2.f;
  return fminf(fmaxf(w < 1.f ? t : w, 0.f), 1.f);
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

// What a view needs on one plane of a block's span, the same for every column:
// computed once a block, in shared memory.
struct __align__(16) ZPlane {
  unsigned lo, hi;  // lower and upper source plane, clamped to the stack
  float fz;         // lerp fraction; negative: the view is not valid on this plane
  float hz[5];      // hats of the plane's z weight coordinate
};

// What a view needs on one row (y) or one column (x) of a block, the same on
// every plane: computed once a block, in shared memory.
struct __align__(16) Axis {
  int lo, hi;    // offsets of the lower and the upper tap (clamped) in a source plane
  float f;       // lerp fraction
  int g;         // first grid index of the pair of hats that are not 0; -1: not valid here
  float h0, h1;  // hats at g and g + 1
};

// First of the two neighbouring grid indices, both in [0, 4], that hold every
// non-zero hat of weight coordinate g: hat(g, i) is 0 unless |g - i| < 1.
__device__ __forceinline__ int hat_pair(float g) {
  return static_cast<int>(fminf(fmaxf(floorf(g), 0.f), 3.f));
}

// Entry of in-tile index i (absolute index o0 + i) along axis d (3D: 1 y,
// 2 x; 2D: 0 y, 1 x) of a view with parameter row p (off | ext | wdiag | woff
// | scale, NDIM each); `size` entries of `pitch` elements each.
template <int NDIM>
__device__ __forceinline__ Axis axis_entry(const float* p, int d, int o0, int i, int size,
                                           int pitch) {
  const float sc = p[4 * NDIM + d];
  const Sample sm = tile_sample(p[d], sc, o0, i);
  const float g = mul_add(p[2 * NDIM + d], o0 + i, p[3 * NDIM + d]);
  Axis e;
  e.lo = clamp_idx(sm.idx, size) * pitch;
  e.hi = clamp_idx(sm.idx + 1, size) * pitch;
  e.f = sm.frac;
  const int pair = hat_pair(g);
  e.g = inside(sc, o0 + i, p[d], p[NDIM + d]) ? pair : -1;
  e.h0 = hat(g, pair);
  e.h1 = hat(g, pair + 1);
  return e;
}

// Entries [zb, ze) of the z tables of the staged slots; plane j of the span is
// in-tile plane iz0 + j of the tile whose origin has absolute index oz0. Only
// the span's first nz planes exist: the others are marked not valid, with
// source planes that can be read.
__device__ __forceinline__ void build_z_tables(const Args3D& a, int nk, const int* s_view,
                                               float (*s_par)[Par<3>::kRow],
                                               ZPlane (*s_z)[kZSpan], int zb, int ze, int nz,
                                               int iz0, int oz0, int tid, int nthreads) {
  for (int e = tid; e < nk * kZSpan; e += nthreads) {
    const int s = e / kZSpan, j = zb + e % kZSpan;
    if (j >= ze) continue;
    ZPlane z{0u, 0u, -1.f, {0.f, 0.f, 0.f, 0.f, 0.f}};
    if (s_view[s] >= 0 && j < nz) {
      const float* p = s_par[s];  // off 0-2 | ext 3-5 | wdiag 6-8 | woff 9-11 | scale 12-14
      const int iz = iz0 + j, az = oz0 + iz;
      int zlo;
      float fz;
      if (a.per_view_z) {
        const Sample sz = tile_sample(p[0], p[12], oz0, iz);
        zlo = sz.idx;
        fz = sz.frac;
      } else {
        // uniform z mode: integer stride SZ from floor(c0), fixed fraction
        const float cz0 = __fadd_rn(p[0], __fmul_rn(p[12], static_cast<float>(oz0)));
        const float bz0 = floorf(cz0);
        zlo = static_cast<int>(bz0) + a.SZ * iz;
        fz = __fsub_rn(cz0, bz0);
      }
      z.lo = static_cast<unsigned>(clamp_idx(zlo, a.D));
      z.hi = static_cast<unsigned>(clamp_idx(zlo + 1, a.D));
      if (inside(p[12], az, p[0], p[3])) z.fz = fz;
      const float gz = mul_add(p[6], az, p[9]);
#pragma unroll
      for (int i = 0; i < 5; ++i) z.hz[i] = hat(gz, i);
    }
    s_z[s][j] = z;
  }
}

// One view's part of a run of kZRun planes of a column. q00..q11 point at the
// column's four (y, x) taps in plane 0 of the view and a plane is plane_bytes
// long (32 bits: one multiply-add gives a tap's address); kCarry: the upper
// plane of one output plane is the lower plane of the next (uniform z mode,
// stride 1), so its four taps stay in registers. Every tap is read, valid
// plane or not (the table's source planes are clamped), and no plane is
// skipped, so that the loads of all the run's planes can be in flight at once.
template <typename Tin, bool kCarry>
__device__ __forceinline__ void column_planes(const char* q00, const char* q10, const char* q01,
                                              const char* q11, unsigned plane_bytes, float fy,
                                              float fx, const float (&inner)[5],
                                              const ZPlane* zt, float (&acc)[kZRun],
                                              float (&wsum)[kZRun], float (&vacc)[kZRun],
                                              float (&vcnt)[kZRun]) {
  auto tap = [plane_bytes](const char* q, unsigned z) {
    return Cast<Tin>::load(
        reinterpret_cast<const Tin*>(q + static_cast<unsigned long long>(z) * plane_bytes));
  };
  float l00 = 0.f, l10 = 0.f, l01 = 0.f, l11 = 0.f;
#pragma unroll
  for (int j = 0; j < kZRun; ++j) {
    const ZPlane z = zt[j];
    if (!kCarry || j == 0) {
      l00 = tap(q00, z.lo), l10 = tap(q10, z.lo), l01 = tap(q01, z.lo), l11 = tap(q11, z.lo);
    }
    const float u00 = tap(q00, z.hi), u10 = tap(q10, z.hi);
    const float u01 = tap(q01, z.hi), u11 = tap(q11, z.hi);
    // z first, then y, then x
    const float val = lerp(lerp(lerp(l00, u00, z.fz), lerp(l10, u10, z.fz), fy),
                           lerp(lerp(l01, u01, z.fz), lerp(l11, u11, z.fz), fy), fx);
    float w = 0.f;
#pragma unroll
    for (int i = 0; i < 5; ++i) w += z.hz[i] * inner[i];
    w = taper_select(w);
    if (z.fz >= 0.f) {
      acc[j] += w * val;
      wsum[j] += w;
      vacc[j] += val;
      vcnt[j] += 1.f;
    }
    if (kCarry) l00 = u00, l10 = u10, l01 = u01, l11 = u11;
  }
}

// blockIdx.{x,y,z} = tile index * sub + sub-block index: a block never
// straddles two tiles of the view-list grid, whatever the tile shape. A warp
// takes 16 x 2 of the block's 32 x 8 columns: its loads and stores still fill
// whole 32-byte sectors, and it meets fewer views of which only some of its
// lanes are inside than a warp of 32 x 1 does.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kBX3* kBY3, kBlocksPerSM3)
    fuse_translation_3d_kernel(Args3D a, int n_ty, int n_tx, int sub_z, int sub_y, int sub_x) {
  __shared__ int s_view[kSlotChunk3];
  __shared__ float s_par[kSlotChunk3][Par<3>::kRow];
  __shared__ float s_grid[kSlotChunk3][Par<3>::kGrid];
  __shared__ Axis s_y[kSlotChunk3][kBY3], s_x[kSlotChunk3][kBX3];
  __shared__ ZPlane s_z[kSlotChunk3][kZSpan];

  const int tid = threadIdx.y * kBX3 + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = blockIdx.x / sub_x, ty = blockIdx.y / sub_y, tz = blockIdx.z / sub_z;
  const int bx = (warp & 1) * 16 + (lane & 15), by = (warp >> 1) * 2 + (lane >> 4);
  const int ix0 = (blockIdx.x % sub_x) * kBX3, iy0 = (blockIdx.y % sub_y) * kBY3;
  const int ix = ix0 + bx, iy = iy0 + by;
  const int iz0 = (blockIdx.z % sub_z) * kZSpan;
  const int px = tx * a.TX + ix, py = ty * a.TY + iy, pz0 = tz * a.TZ + iz0;
  // planes of the span that lie in the tile and in the output
  const int nz = min(min(kZSpan, a.TZ - iz0), a.OZ - pz0);
  if (nz <= 0) return;
  const bool active = ix < a.TX && iy < a.TY && px < a.OX && py < a.OY;
  // absolute output indices of the tile origin (the reference's o0)
  const int ox0 = tx * a.TX + a.org_x, oy0 = ty * a.TY + a.org_y, oz0 = tz * a.TZ + a.org_z;
  const int* slots = a.view_idx + ((static_cast<long long>(tz) * n_ty + ty) * n_tx + tx) * a.K;
  const unsigned plane_bytes = static_cast<unsigned>(a.H * a.W) * sizeof(Tin);
  const long long vsize = static_cast<long long>(a.H) * a.W * a.D;
  const Tin* tiles = static_cast<const Tin*>(a.tiles);
  Tout* out = static_cast<Tout*>(a.out);
  const bool carry = !a.per_view_z && a.SZ == 1;
  // a list longer than a pass is staged anew for every run of planes, with
  // the z tables of that run alone; a shorter one once, for the whole span
  const bool restage = a.K > kSlotChunk3;

  for (int z0 = 0; z0 < nz; z0 += kZRun) {
    const int n = min(kZRun, nz - z0);
    float acc[kZRun], wsum[kZRun], vacc[kZRun], vcnt[kZRun];
#pragma unroll
    for (int j = 0; j < kZRun; ++j) acc[j] = wsum[j] = vacc[j] = vcnt[j] = 0.f;

    for (int k0 = 0; k0 < a.K; k0 += kSlotChunk3) {
      const int nk = min(kSlotChunk3, a.K - k0);
      if (restage || z0 == 0) {
        stage_slots<3>(slots, k0, nk, a.params, a.wgrids, s_view, s_par, s_grid, tid,
                       kBX3 * kBY3);
        for (int e = tid; e < nk * (kBY3 + kBX3); e += kBX3 * kBY3) {
          const int s = e / (kBY3 + kBX3), i = e % (kBY3 + kBX3);
          if (i < kBY3) {
            s_y[s][i] = axis_entry<3>(s_par[s], 1, oy0, iy0 + i, a.H, a.W);
          } else {
            s_x[s][i - kBY3] = axis_entry<3>(s_par[s], 2, ox0, ix0 + i - kBY3, a.W, 1);
          }
        }
        build_z_tables(a, nk, s_view, s_par, s_z, restage ? z0 : 0,
                       restage ? z0 + kZRun : kZSpan, nz, iz0, oz0, tid, kBX3 * kBY3);
        __syncthreads();
      }
      if (!active) continue;
      for (int s = 0; s < nk; ++s) {
        const int v = s_view[s];
        if (v < 0) continue;
        // a view not valid at this (y, x) adds exactly 0 on every plane
        const Axis cy = s_y[s][by], cx = s_x[s][bx];
        if (cy.g < 0 || cx.g < 0) continue;
        // y/x part of the hat expansion. At most two neighbouring hats an axis
        // are not 0, and a term with a hat of 0 adds exactly 0 to the sums
        // sum_j hy (sum_k g hx), so the four terms left give the sums' bits.
        const float* g = s_grid[s] + cy.g * 5 + cx.g;
        float inner[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          const float in0 = g[i * 25] * cx.h0 + g[i * 25 + 1] * cx.h1;
          const float in1 = g[i * 25 + 5] * cx.h0 + g[i * 25 + 6] * cx.h1;
          inner[i] = cy.h0 * in0 + cy.h1 * in1;
        }
        const Tin* base = tiles + v * vsize;
        const char* q00 = reinterpret_cast<const char*>(base + cy.lo + cx.lo);
        const char* q10 = reinterpret_cast<const char*>(base + cy.hi + cx.lo);
        const char* q01 = reinterpret_cast<const char*>(base + cy.lo + cx.hi);
        const char* q11 = reinterpret_cast<const char*>(base + cy.hi + cx.hi);
        const ZPlane* zt = s_z[s] + z0;
        if (carry) {
          column_planes<Tin, true>(q00, q10, q01, q11, plane_bytes, cy.f, cx.f, inner, zt, acc,
                                   wsum, vacc, vcnt);
        } else {
          column_planes<Tin, false>(q00, q10, q01, q11, plane_bytes, cy.f, cx.f, inner, zt, acc,
                                    wsum, vacc, vcnt);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kZRun; ++j) {
      if (j >= n) break;
      out[(static_cast<long long>(pz0 + z0 + j) * a.OY + py) * a.OX + px] =
          Cast<Tout>::store(nan_to_num(fused_value(acc[j], wsum[j], vacc[j], vcnt[j])));
    }
  }
}

// What a view needs in one 2D block: its index, the rows of the block on which
// it is valid, and whether its taps can be carried from row to row.
struct __align__(16) Slot2D {
  int view;         // -1: an empty slot
  int first, last;  // first and last row of the block where the view is valid; none: last < first
  int carry;        // every row's lower taps are the upper taps of the row before
};

// Warp w of a 2D block stages view v (slot w of the pass): its parameter row
// and grid, its row and column tables, the rows it is valid on (a view is
// valid on one run of rows) and whether its taps can be carried.
__device__ __forceinline__ void stage_slot_2d(const Args2D& a, int v, int w, int lane, int oy0,
                                              int iy0, int ox0, int ix0, Slot2D* s_slot,
                                              float (*s_par)[Par<2>::kRow],
                                              float (*s_grid)[Par<2>::kGrid],
                                              Axis (*s_y)[kBH2], Axis (*s_x)[kBX2]) {
  Slot2D sl{v, kBH2, -1, 0};
  if (v >= 0) {
    float* p = s_par[w];  // off 0-1 | ext 2-3 | wdiag 4-5 | woff 6-7 | scale 8-9
    if (lane < Par<2>::kRow) p[lane] = a.params[v * Par<2>::kRow + lane];
    if (lane < Par<2>::kGrid) s_grid[w][lane] = a.wgrids[v * Par<2>::kGrid + lane];
    __syncwarp();
#pragma unroll
    for (int i0 = 0; i0 < kBH2; i0 += 32) {
      const Axis e = axis_entry<2>(p, 0, oy0, iy0 + i0 + lane, a.H, a.W);
      s_y[w][i0 + lane] = e;
      const unsigned valid = __ballot_sync(~0u, e.g >= 0);
      if (valid) {
        sl.first = min(sl.first, i0 + __ffs(valid) - 1);
        sl.last = i0 + 31 - __clz(valid);
      }
    }
    s_x[w][lane] = axis_entry<2>(p, 1, ox0, ix0 + lane, a.W, 1);
    __syncwarp();
    bool carry = true;
    for (int i = lane + 1; i < kBH2; i += 32) carry = carry && s_y[w][i].lo == s_y[w][i - 1].hi;
    sl.carry = __all_sync(~0u, carry);
  }
  if (lane == 0) s_slot[w] = sl;
}

// One view's part of a run of kRun2 rows of a column. base: the view's first
// element; c0, c1: the column's lower and upper x tap; rows: the run's
// entries of the view's row table; gcol: the view's grid at the column's first
// x hat. kCarry: each row's lower taps are the upper taps of the row before
// and stay in registers. The taps, lerps and hat sums of all the run's rows
// come first, with no branch between them (every tap is read, valid row or
// not: the tables' offsets are clamped), so that the run's loads are in
// flight together; the tapers and the sums follow.
template <typename Tin, bool kCarry>
__device__ __forceinline__ void column_rows(const Tin* base, unsigned c0, unsigned c1, float fx,
                                            float hx0, float hx1, const float* gcol,
                                            const Axis* rows, float (&acc)[kRun2],
                                            float (&wsum)[kRun2], float (&vacc)[kRun2],
                                            float (&vcnt)[kRun2]) {
  auto tap = [base](unsigned i) { return Cast<Tin>::load(base + i); };
  float val[kRun2], w[kRun2];
  unsigned valid = 0;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < kRun2; ++j) {
    const Axis cy = rows[j];
    const unsigned lo = static_cast<unsigned>(cy.lo), hi = static_cast<unsigned>(cy.hi);
    if (!kCarry || j == 0) l0 = tap(lo + c0), l1 = tap(lo + c1);
    const float u0 = tap(hi + c0), u1 = tap(hi + c1);
    // y lerp first, then x (the reference's matmul order)
    val[j] = lerp(lerp(l0, u0, cy.f), lerp(l1, u1, cy.f), fx);
    // The hat expansion. At most two neighbouring hats an axis are not 0, and
    // a term with a hat of 0 adds exactly 0: the four terms left, in the
    // reference's order (row-major, each (g * hy) * hx), give the sum's bits.
    const float* g = gcol + max(cy.g, 0) * 5;
    w[j] = g[0] * cy.h0 * hx0;
    w[j] += g[1] * cy.h0 * hx1;
    w[j] += g[5] * cy.h1 * hx0;
    w[j] += g[6] * cy.h1 * hx1;
    valid |= static_cast<unsigned>(cy.g >= 0) << j;
    if (kCarry) l0 = u0, l1 = u1;
  }
#pragma unroll
  for (int j = 0; j < kRun2; ++j) {
    if (!(valid >> j & 1u)) continue;
    const float t = taper(w[j]);
    acc[j] += t * val[j];
    wsum[j] += t;
    vacc[j] += val[j];
    vcnt[j] += 1.f;
  }
}

// blockIdx.{x,y} = tile index * sub + sub-block index: a block never straddles
// two tiles of the view-list grid, whatever the tile shape.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kBX2* kBY2, kBlocksPerSM2)
    fuse_translation_2d_kernel(Args2D a, int n_tx, int sub_y, int sub_x) {
  __shared__ Slot2D s_slot[kSlotChunk2];
  __shared__ float s_par[kSlotChunk2][Par<2>::kRow];
  __shared__ float s_grid[kSlotChunk2][Par<2>::kGrid];
  __shared__ Axis s_y[kSlotChunk2][kBH2], s_x[kSlotChunk2][kBX2];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tx = blockIdx.x / sub_x, ty = blockIdx.y / sub_y;
  const int ix0 = (blockIdx.x % sub_x) * kBX2, iy0 = (blockIdx.y % sub_y) * kBH2;
  const int ix = ix0 + lane;
  const int px = tx * a.TX + ix;
  // absolute output indices of the tile origin (the reference's o0)
  const int ox0 = tx * a.TX + a.org_x, oy0 = ty * a.TY + a.org_y;
  const int* slots = a.view_idx + (static_cast<long long>(ty) * n_tx + tx) * a.K;
  const long long vsize = static_cast<long long>(a.H) * a.W;
  const Tin* tiles = static_cast<const Tin*>(a.tiles);
  // a list longer than a pass is staged anew for every run; a shorter one once
  const bool restage = a.K > kSlotChunk2;

  for (int run = 0; run < kRuns2; ++run) {
    const int r0 = (warp * kRuns2 + run) * kRun2;
    const int py0 = ty * a.TY + iy0 + r0;
    // rows of the run that lie in the tile and in the output
    const int nrows = min(min(kRun2, a.TY - iy0 - r0), a.OY - py0);
    const bool active = ix < a.TX && px < a.OX && nrows > 0;
    float acc[kRun2], wsum[kRun2], vacc[kRun2], vcnt[kRun2];
#pragma unroll
    for (int j = 0; j < kRun2; ++j) acc[j] = wsum[j] = vacc[j] = vcnt[j] = 0.f;

    for (int k0 = 0; k0 < a.K; k0 += kSlotChunk2) {
      const int nk = min(kSlotChunk2, a.K - k0);
      if (restage || run == 0) {
        __syncthreads();  // the previous pass is consumed
        if (warp < nk) {
          stage_slot_2d(a, slots[k0 + warp], warp, lane, oy0, iy0, ox0, ix0, s_slot, s_par,
                        s_grid, s_y, s_x);
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int s = 0; s < nk; ++s) {
        const Slot2D sl = s_slot[s];
        // a view not valid on any row of the run, or at this column, adds exactly 0
        if (sl.view < 0 || sl.first >= r0 + kRun2 || sl.last < r0) continue;
        const Axis cx = s_x[s][lane];
        if (cx.g < 0) continue;
        const Tin* base = tiles + sl.view * vsize;
        const unsigned c0 = static_cast<unsigned>(cx.lo), c1 = static_cast<unsigned>(cx.hi);
        const float* gcol = s_grid[s] + cx.g;
        if (sl.carry) {
          column_rows<Tin, true>(base, c0, c1, cx.f, cx.h0, cx.h1, gcol, s_y[s] + r0, acc, wsum,
                                 vacc, vcnt);
        } else {
          column_rows<Tin, false>(base, c0, c1, cx.f, cx.h0, cx.h1, gcol, s_y[s] + r0, acc, wsum,
                                  vacc, vcnt);
        }
      }
    }
    if (!active) continue;
    Tout* out = static_cast<Tout*>(a.out) + static_cast<long long>(py0) * a.OX + px;
#pragma unroll
    for (int j = 0; j < kRun2; ++j) {
      if (j >= nrows) break;
      out[static_cast<long long>(j) * a.OX] =
          Cast<Tout>::store(nan_to_num(fused_value(acc[j], wsum[j], vacc[j], vcnt[j])));
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename Tin, typename Tout>
struct Launch3D {
  static int run(const Args3D& a, cudaStream_t stream) {
    const int sub_z = cdiv(a.TZ, kZSpan), sub_y = cdiv(a.TY, kBY3), sub_x = cdiv(a.TX, kBX3);
    const int n_tz = cdiv(a.OZ, a.TZ), n_ty = cdiv(a.OY, a.TY), n_tx = cdiv(a.OX, a.TX);
    const long long gx = static_cast<long long>(n_tx) * sub_x;
    const long long gy = static_cast<long long>(n_ty) * sub_y;
    const long long gz = static_cast<long long>(n_tz) * sub_z;
    // a thread keeps a plane's length in bytes in 32 bits
    if (gx > INT_MAX || gy > 65535 || gz > 65535 ||
        static_cast<long long>(a.H) * a.W * static_cast<long long>(sizeof(Tin)) > INT_MAX) {
      return cudaErrorInvalidConfiguration;
    }
    fuse_translation_3d_kernel<Tin, Tout>
        <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(gz)),
           dim3(kBX3, kBY3), 0, stream>>>(a, n_ty, n_tx, sub_z, sub_y, sub_x);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename Tin, typename Tout>
struct Launch2D {
  static int run(const Args2D& a, cudaStream_t stream) {
    const int sub_y = cdiv(a.TY, kBH2), sub_x = cdiv(a.TX, kBX2);
    const int n_ty = cdiv(a.OY, a.TY), n_tx = cdiv(a.OX, a.TX);
    const long long gx = static_cast<long long>(n_tx) * sub_x;
    const long long gy = static_cast<long long>(n_ty) * sub_y;
    // a thread keeps a tap's offset in a view in 32 bits
    if (gx > INT_MAX || gy > 65535 || static_cast<long long>(a.H) * a.W > INT_MAX) {
      return cudaErrorInvalidConfiguration;
    }
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
