// Block means of an OME-Zarr pyramid level, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its pyramid levels on the
// host with numpy (msi_utils._coarsen_mean, a float64 mean over reshaped
// factor axes), and so did the port. On the host that mean held about 80 % of
// a zarr-to-OME-Zarr fusion's wall, with the card idle, which is why the
// kernel was added (io/ngff_utils.py::_build_levels sends each block of an
// unsigned integer level here).
//
// coarsen_mean_kernel: the input (B, Z, Y, X) of uint8 or uint16, C-contiguous;
// the output (B, Z / fz, Y / fy, X / fx), each voxel floor(sum / (fz fy fx))
// of the block under it, the trailing planes, rows and columns that fill no
// block dropped. The sum is exact in 32 bits (the wrapper refuses factor
// products whose sum could pass 2^32 - 1: above 65537 for uint16), and for
// non-negative integers the float64 mean truncated to the dtype is that
// floor (a quotient that is no integer lies at least 1 / n from the next
// one, far above float64's rounding), so the output is bit-equal to
// _coarsen_mean's.
//
// What bounds it on the H100: bytes. Each input byte is read once and each
// output byte written once, with a few integer operations each, against
// 3.35 TB/s. The design:
// - a thread owns 16 bytes of one output row: 8 uint16 or 16 uint8 voxels.
//   For each of the fz x fy input rows under them it reads the fx x 16 bytes
//   of that row as fx 16-byte loads, neighbouring threads on neighbouring
//   addresses, so a warp's loads are whole, coalesced 512-byte rows of
//   sectors, and writes its outputs with one 16-byte store;
// - the sums stay in registers (8 or 16 of 32 bits), so no shared memory is
//   needed: nothing is read twice. fx is a template argument for 1-4, so the
//   lane-to-output map unrolls to fixed registers; other fx, rows that are not
//   16-byte aligned (odd widths) and a row's last, partial group take a scalar
//   path with the same sums;
// - a block takes 256 consecutive groups of one output plane (grid x), and
//   grid y walks the planes, so a thread's index math is 32-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kU16 = 1;
constexpr int kU8 = 2;
constexpr int kBadDtype = -1;

struct Args {
  const void* in;
  void* out;
  long long planes;  // B * Zo
  int Z, Y, X;       // input, untrimmed
  int Zo, Yo, Xo;    // output
  int fz, fy, fx;
  int groups;        // 16-byte groups of an output row
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// add the 16 bytes of load v of a row (elements v * E .. v * E + E - 1 of the
// thread's span) to the outputs they fall in
template <typename T, int FX, int V>
__device__ __forceinline__ void add_load(unsigned (&sums)[16 / sizeof(T)], const uint4 w) {
  constexpr int E = 16 / sizeof(T);
  constexpr int PER_WORD = 4 / sizeof(T);
  constexpr int BITS = 8 * sizeof(T);
  constexpr unsigned MASK = (1u << BITS) - 1u;
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int e = 0; e < PER_WORD; ++e) {
      sums[(V * E + k * PER_WORD + e) / FX] += (words[k] >> (BITS * e)) & MASK;
    }
  }
}

template <typename T, int FX>
__device__ __forceinline__ void add_row_vector(unsigned (&sums)[16 / sizeof(T)], const T* row) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
  // every load of the row is issued before any is summed
  uint4 w[FX > 0 ? FX : 1];
#pragma unroll
  for (int i = 0; i < FX; ++i) w[i] = __ldg(v + i);
  if constexpr (FX >= 1) add_load<T, FX, 0>(sums, w[0]);
  if constexpr (FX >= 2) add_load<T, FX, 1>(sums, w[1]);
  if constexpr (FX >= 3) add_load<T, FX, 2>(sums, w[2]);
  if constexpr (FX >= 4) add_load<T, FX, 3>(sums, w[3]);
}

// FX: the x factor when it is 1-4, else 0 (read from the arguments; scalar loads)
template <typename T, int FX>
__global__ void __launch_bounds__(kThreads) coarsen_mean_kernel(const Args a) {
  constexpr int P = 16 / sizeof(T);
  const long long wide = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (wide >= static_cast<long long>(a.groups) * a.Yo) return;
  const int item = static_cast<int>(wide);
  const int yo = item / a.groups;
  const int x0 = (item - yo * a.groups) * P;
  const int n_out = min(P, a.Xo - x0);
  const int fx = FX > 0 ? FX : a.fx;
  const unsigned n = static_cast<unsigned>(a.fz) * a.fy * fx;
  const long long in_plane = static_cast<long long>(a.Y) * a.X;
  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);

  for (long long p = blockIdx.y; p < a.planes; p += gridDim.y) {
    const long long b = p / a.Zo;
    const int zo = static_cast<int>(p - b * a.Zo);
    const T* base = in + (b * a.Z + static_cast<long long>(zo) * a.fz) * in_plane +
                    static_cast<long long>(yo) * a.fy * a.X + static_cast<long long>(x0) * fx;
    unsigned sums[P];
#pragma unroll
    for (int i = 0; i < P; ++i) sums[i] = 0;
    for (int dz = 0; dz < a.fz; ++dz) {
      for (int dy = 0; dy < a.fy; ++dy) {
        const T* row = base + dz * in_plane + static_cast<long long>(dy) * a.X;
        if (FX > 0 && n_out == P && aligned16(row)) {
          add_row_vector<T, FX>(sums, row);
        } else {
#pragma unroll
          for (int i = 0; i < P; ++i) {
            if (i < n_out) {
              unsigned s = 0;
              for (int k = 0; k < fx; ++k) s += __ldg(row + i * fx + k);
              sums[i] += s;
            }
          }
        }
      }
    }
    T* dst = out + (p * a.Yo + yo) * a.Xo + x0;
    if (n_out == P && aligned16(dst)) {
      union {
        uint4 v;
        T t[P];
      } pack;
#pragma unroll
      for (int i = 0; i < P; ++i) pack.t[i] = static_cast<T>(sums[i] / n);
      *reinterpret_cast<uint4*>(dst) = pack.v;
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (i < n_out) dst[i] = static_cast<T>(sums[i] / n);
      }
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const long long items = static_cast<long long>(a.groups) * a.Yo;
  if (a.planes == 0 || items == 0) return 0;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(a.planes < kMaxGridY ? a.planes : kMaxGridY));
  switch (a.fx) {
    case 1: coarsen_mean_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: coarsen_mean_kernel<T, 2><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: coarsen_mean_kernel<T, 3><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: coarsen_mean_kernel<T, 4><<<grid, kThreads, 0, stream>>>(a); break;
    default: coarsen_mean_kernel<T, 0><<<grid, kThreads, 0, stream>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mvs_coarsen_mean(const void* in, int dtype, long long B, int Z, int Y, int X, int fz, int fy,
                     int fx, void* out, void* stream) {
  if (fz < 1 || fy < 1 || fx < 1) return cudaErrorInvalidValue;
  Args a{in, out, 0, Z, Y, X, Z / fz, Y / fy, X / fx, fz, fy, fx, 0};
  a.planes = B * a.Zo;
  const int per_thread = dtype == kU8 ? 16 : 8;  // outputs in 16 bytes
  a.groups = (a.Xo + per_thread - 1) / per_thread;
  if (static_cast<long long>(a.groups) * a.Yo > INT_MAX) return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kU16) return launch<uint16_t>(a, s);
  if (dtype == kU8) return launch<uint8_t>(a, s);
  return kBadDtype;
}

const char* mvs_error_string(int code) {
  if (code == kBadDtype) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
