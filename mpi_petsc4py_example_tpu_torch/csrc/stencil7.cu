// 7-point 3D Poisson stencil kernels for Hopper (sm_90a), plain C entry points.
//
// What they replace (mpi_petsc4py_example_tpu/ops/pallas_stencil.py), all of
// them _stencil_kernel (:83) with a different combine:
//   stencil7_apply_{f32,f64}       -> stencil3d_apply_pallas (:365)
//   stencil7_dot_{f32,f64}         -> stencil3d_dot_pallas (:394), with dot_ref
//   stencil7_smooth_{f32,f64}      -> stencil3d_smooth_pallas (:652)
//   stencil7_residual_{f32,f64}    -> stencil3d_residual_pallas (:686)
//   stencil7_smooth0_pair_{f32,f64} -> stencil3d_smooth0_pair_pallas (:1124)
//   stencil7_apply_many_{f32,f64}  -> stencil3d_apply_many_pallas (:591),
//                                     body _stencil_many_kernel (:430)
//   stencil7_dot_many_{f32,f64}    -> stencil3d_dot_many_pallas (:620)
//
// All compute, on a z-slab u (lz, ny, nx) stored x-fastest,
//   Au = 6 u - u[z-1] - u[z+1] - u[y-1] - u[y+1] - u[x-1] - u[x+1]
// with zero fill at the x and y plane edges, and the z neighbours of the first
// and last plane taken from the separate halo planes halo_lo / halo_hi (ny, nx)
// or, when both halo pointers are null, from zero (Dirichlet) planes.  That
// choice is a template flag: a null test inside the z loop made the apply
// ~24% slower at 512^3.  An epilogue functor then turns (u, Au) into the
// stored value, reading f at the same offset where it needs it:
//   apply / dot      Au                        (the dot also sums u * Au)
//   smooth           u + w (f - Au)             one damped-Jacobi sweep
//   residual         f - Au
//   smooth0_pair     (w1 + w2) u - (w1 w2) Au   two sweeps from a zero guess,
//                                               applied to u = f, zero halos
// As on the TPU, no concatenated extended slab is ever built: the halo planes
// are read where they lie.
//
// What bounds them: HBM bytes.  Each point needs 8 flops (10 with the dot or
// the smooth) against 8 (f32) or 16 (f64) bytes moved for the apply: read u
// once, write y once, plus the two halo planes; smooth and residual also read
// f (3 passes).  The design marches each thread up a column of ZC planes,
// keeping the z-1 / z / z+1 values in registers, so u is read from device
// memory about once; the x and y neighbours come from L1/L2, which hold the
// rows that neighbouring threads of the block have just loaded.
//
// The dot reduction is deterministic: each block writes its partial sum to a
// scratch buffer (allocated by the caller), and a second one-block kernel sums
// the partials in a fixed order.  No float atomics are used, so two runs on the
// same input give the same bits and CG iteration counts do not wobble.
//
// The many-column kernels take k slabs U (k, lz, ny, nx) and halo blocks
// (k, ny, nx) (or null for zero halos) in one launch: grid z covers the
// z-tiles of all k columns, column by column, and each column's slab is
// marched exactly as the single-RHS kernel marches it (same tiles per block,
// same order).  The
// per-column dot writes the single kernel's partial layout for each column
// into a (k, nblocks) scratch and sums it with one block per column, so each
// column's A u and <u, A u> are bit-equal to one stencil7_dot launch on it.
// The TPU kernel's VMEM chunk plan for k resident columns has no counterpart:
// the bound is the same k (2 n + 2 planes) bytes, and the march reads each
// column's u about once.
//
// This first design is simple and right.  Shared-memory plane tiling, TMA and
// fusing the CG update chain are left to later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBX = 32;   // threads along x (one warp: coalesced 128-byte rows)
constexpr int kBY = 8;    // threads along y
constexpr int kZC = 8;    // z-planes marched by each thread per tile
constexpr int kThreads = kBX * kBY;
constexpr int kSumThreads = 1024;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Epilogues: the value stored at offset o from u there and Au = (A u)[o].
// Products go through mul_rn, so nvcc cannot contract them with the
// following add into an FMA and every result rounds as the plain PyTorch
// version's separate operations do.
template <typename T>
struct StoreAu {
  __device__ T operator()(T, T au, int64_t) const { return au; }
};

template <typename T>
struct Smooth {          // u + w (f - A u)
  const T* __restrict__ f;
  T w;
  __device__ T operator()(T u, T au, int64_t o) const { return u + mul_rn(w, f[o] - au); }
};

template <typename T>
struct Residual {        // f - A u
  const T* __restrict__ f;
  __device__ T operator()(T, T au, int64_t o) const { return f[o] - au; }
};

template <typename T>
struct Smooth0Pair {     // (w1 + w2) f - (w1 w2) A f, the kernel run on u = f
  T sum, prod;
  __device__ T operator()(T u, T au, int64_t) const { return mul_rn(sum, u) - mul_rn(prod, au); }
};

// Sum of v over the block, valid in thread 0.  blockDim is a multiple of 32.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? warp_sums[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

struct Tiles {
  int ntx, nty, ntz;
  dim3 grid;
};

Tiles make_tiles(int lz, int ny, int nx) {
  Tiles t;
  t.ntx = (nx - 1) / kBX + 1;
  t.nty = (ny - 1) / kBY + 1;
  t.ntz = (lz - 1) / kZC + 1;
  // gridDim.y/z are limited to 65535; the kernel loops over what lies beyond
  t.grid = dim3(static_cast<unsigned>(t.ntx),
                static_cast<unsigned>(t.nty < 65535 ? t.nty : 65535),
                static_cast<unsigned>(t.ntz < 65535 ? t.ntz : 65535));
  return t;
}

// The tiles (bx + i gx, blockIdx.y + i gridDim.y, bz + i gz) of one slab,
// the grid of one single-slab launch being (gx, gridDim.y, gz); returns the
// block's share of sum(u * Au) when kDot. The tile loops depend on blockIdx
// only, so every thread of a block runs the same trip counts and reaches the
// caller's block_sum.
template <typename T, bool kDot, bool kHalo, class Epilogue>
__device__ __forceinline__ T march(const T* __restrict__ u, const T* __restrict__ halo_lo,
                                   const T* __restrict__ halo_hi, T* __restrict__ y,
                                   int lz, int ny, int nx, int ntx, int nty, int ntz,
                                   int bx, int gx, int bz, int gz, Epilogue epi) {
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  T acc = T(0);
  for (int tz = bz; tz < ntz; tz += gz) {
    for (int ty = blockIdx.y; ty < nty; ty += gridDim.y) {
      for (int tx = bx; tx < ntx; tx += gx) {
        const int x = tx * kBX + static_cast<int>(threadIdx.x);
        const int yy = ty * kBY + static_cast<int>(threadIdx.y);
        if (x >= nx || yy >= ny) continue;
        const int64_t col = static_cast<int64_t>(yy) * nx + x;
        const int z0 = tz * kZC;
        const int z1 = min(z0 + kZC, lz);
        T below = z0 == 0 ? (kHalo ? halo_lo[col] : T(0)) : u[(z0 - 1) * plane + col];
        T cur = u[z0 * plane + col];
        for (int z = z0; z < z1; ++z) {
          const int64_t o = z * plane + col;
          const T above = z == lz - 1 ? (kHalo ? halo_hi[col] : T(0)) : u[o + plane];
          const T xm = x > 0 ? u[o - 1] : T(0);
          const T xp = x < nx - 1 ? u[o + 1] : T(0);
          const T ym = yy > 0 ? u[o - nx] : T(0);
          const T yp = yy < ny - 1 ? u[o + nx] : T(0);
          // the plain version's order of operations, with no fused multiply-add
          T v = mul_rn(T(6), cur);
          v -= below;
          v -= above;
          v -= ym;
          v -= yp;
          v -= xm;
          v -= xp;
          y[o] = epi(cur, v, o);
          if (kDot) acc += cur * v;
          below = cur;
          cur = above;
        }
      }
    }
  }
  return acc;
}

template <typename T, bool kDot, bool kHalo, class Epilogue>
__global__ void __launch_bounds__(kThreads)
stencil7_kernel(const T* __restrict__ u, const T* __restrict__ halo_lo,
                const T* __restrict__ halo_hi, T* __restrict__ y,
                T* __restrict__ partial, int lz, int ny, int nx,
                int ntx, int nty, int ntz, Epilogue epi) {
  const T acc = march<T, kDot, kHalo>(u, halo_lo, halo_hi, y, lz, ny, nx, ntx, nty, ntz,
                                      blockIdx.x, gridDim.x, blockIdx.z, gridDim.z, epi);
  if (kDot) {
    const T s = block_sum(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      partial[blockIdx.x + static_cast<int64_t>(gridDim.x) *
                               (blockIdx.y + static_cast<int64_t>(gridDim.y) * blockIdx.z)] = s;
    }
  }
}

// k slabs in one launch, grid (gx, gy, k gz) for the single kernel's grid
// (gx, gy, gz) of one slab: block z = j gz + bz is block (x, y, bz) of column
// j's single-slab launch, marching the same tiles, and its partial goes to
// partial[j nblk + (the single kernel's index)], nblk = gx gy gz.  The
// launcher lowers gz below the single kernel's where k gz would pass the
// 65535 cap; march's z loop then covers the rest (only the dot's summing
// order differs from a single launch there, at lz > 524280 / k planes).
template <typename T, bool kDot, bool kHalo>
__global__ void __launch_bounds__(kThreads)
stencil7_many_kernel(const T* __restrict__ u, const T* __restrict__ halo_lo,
                     const T* __restrict__ halo_hi, T* __restrict__ y,
                     T* __restrict__ partial, int lz, int ny, int nx,
                     int ntx, int nty, int ntz, int gz) {
  const int j = static_cast<int>(blockIdx.z) / gz;
  const int bz = static_cast<int>(blockIdx.z) - j * gz;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t slab = plane * lz;
  const T acc = march<T, kDot, kHalo>(
      u + j * slab, kHalo ? halo_lo + j * plane : nullptr,
      kHalo ? halo_hi + j * plane : nullptr, y + j * slab, lz, ny, nx, ntx, nty, ntz,
      blockIdx.x, gridDim.x, bz, gz, StoreAu<T>{});
  if (kDot) {
    const T s = block_sum(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      const int64_t nblk = static_cast<int64_t>(gridDim.x) * gridDim.y * gz;
      partial[j * nblk + blockIdx.x +
              static_cast<int64_t>(gridDim.x) * (blockIdx.y + static_cast<int64_t>(gridDim.y) * bz)] = s;
    }
  }
}

// One block per column j: out[j] = sum of partial[j n : (j + 1) n], always in
// the same order (the single-RHS dot launches one block).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const T* __restrict__ partial, int64_t n, T* __restrict__ out) {
  partial += static_cast<int64_t>(blockIdx.x) * n;
  T acc = T(0);
  // unrolled so the loads are issued ahead of the (still in-order) adds
#pragma unroll 16
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  const T s = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// Null lo and hi select the zero-halo instantiation; the caller passes both
// planes or neither (the wrappers check).
template <typename T, class Epilogue>
int launch_apply(const void* u, const void* lo, const void* hi, void* y,
                 int lz, int ny, int nx, void* stream, Epilogue epi) {
  const Tiles t = make_tiles(lz, ny, nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* ut = static_cast<const T*>(u);
  const T* lot = static_cast<const T*>(lo);
  const T* hit = static_cast<const T*>(hi);
  if (lo != nullptr && hi != nullptr) {
    stencil7_kernel<T, false, true, Epilogue><<<t.grid, dim3(kBX, kBY), 0, s>>>(
        ut, lot, hit, static_cast<T*>(y), nullptr, lz, ny, nx, t.ntx, t.nty, t.ntz, epi);
  } else {
    stencil7_kernel<T, false, false, Epilogue><<<t.grid, dim3(kBX, kBY), 0, s>>>(
        ut, nullptr, nullptr, static_cast<T*>(y), nullptr, lz, ny, nx, t.ntx, t.nty, t.ntz,
        epi);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dot(const void* u, const void* lo, const void* hi, void* y,
               void* partial, void* out, int lz, int ny, int nx, void* stream) {
  const Tiles t = make_tiles(lz, ny, nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stencil7_kernel<T, true, true, StoreAu<T>><<<t.grid, dim3(kBX, kBY), 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<T*>(y), static_cast<T*>(partial), lz, ny, nx, t.ntx, t.nty, t.ntz,
      StoreAu<T>{});
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t nblocks = static_cast<int64_t>(t.grid.x) * t.grid.y * t.grid.z;
  sum_partials_kernel<T><<<1, kSumThreads, 0, s>>>(static_cast<const T*>(partial), nblocks,
                                                   static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// k slabs: Y = A U, and with kDot the per-column <u_j, A u_j> into out (k).
// Null lo and hi select zero halos.  1 <= k <= 65535 (the wrappers check).
template <typename T, bool kDot>
int launch_many(const void* u, const void* lo, const void* hi, void* y, void* partial,
                void* out, int k, int lz, int ny, int nx, void* stream) {
  const Tiles t = make_tiles(lz, ny, nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gz = t.grid.z * static_cast<unsigned>(k) <= 65535u
                         ? t.grid.z : 65535u / static_cast<unsigned>(k);
  const dim3 grid(t.grid.x, t.grid.y, gz * static_cast<unsigned>(k));
  const T* ut = static_cast<const T*>(u);
  T* yt = static_cast<T*>(y);
  T* pt = static_cast<T*>(partial);
  if (lo != nullptr && hi != nullptr) {
    stencil7_many_kernel<T, kDot, true><<<grid, dim3(kBX, kBY), 0, s>>>(
        ut, static_cast<const T*>(lo), static_cast<const T*>(hi), yt, pt, lz, ny, nx,
        t.ntx, t.nty, t.ntz, static_cast<int>(gz));
  } else {
    stencil7_many_kernel<T, kDot, false><<<grid, dim3(kBX, kBY), 0, s>>>(
        ut, nullptr, nullptr, yt, pt, lz, ny, nx, t.ntx, t.nty, t.ntz, static_cast<int>(gz));
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !kDot) return err;
  const int64_t nblk = static_cast<int64_t>(t.grid.x) * t.grid.y * gz;
  sum_partials_kernel<T><<<k, kSumThreads, 0, s>>>(pt, nblk, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The CUDA runtime's text for an error code returned by the entry points below.
const char* stencil7_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Length of the partial-sum scratch buffer stencil7_dot_* needs for this shape
// (stencil7_dot_many_* needs k times as much).
long long stencil7_dot_blocks(int lz, int ny, int nx) {
  const Tiles t = make_tiles(lz, ny, nx);
  return static_cast<long long>(t.grid.x) * t.grid.y * t.grid.z;
}

int stencil7_apply_f32(const void* u, const void* lo, const void* hi, void* y,
                       int lz, int ny, int nx, void* stream) {
  return launch_apply<float>(u, lo, hi, y, lz, ny, nx, stream, StoreAu<float>{});
}

int stencil7_apply_f64(const void* u, const void* lo, const void* hi, void* y,
                       int lz, int ny, int nx, void* stream) {
  return launch_apply<double>(u, lo, hi, y, lz, ny, nx, stream, StoreAu<double>{});
}

// out = u + w (f - A u); w is the sweep's omega / 6
int stencil7_smooth_f32(const void* u, const void* f, const void* lo, const void* hi,
                        void* out, int lz, int ny, int nx, double w, void* stream) {
  return launch_apply<float>(u, lo, hi, out, lz, ny, nx, stream,
                             Smooth<float>{static_cast<const float*>(f), static_cast<float>(w)});
}

int stencil7_smooth_f64(const void* u, const void* f, const void* lo, const void* hi,
                        void* out, int lz, int ny, int nx, double w, void* stream) {
  return launch_apply<double>(u, lo, hi, out, lz, ny, nx, stream,
                              Smooth<double>{static_cast<const double*>(f), w});
}

// out = f - A u
int stencil7_residual_f32(const void* u, const void* f, const void* lo, const void* hi,
                          void* out, int lz, int ny, int nx, void* stream) {
  return launch_apply<float>(u, lo, hi, out, lz, ny, nx, stream,
                             Residual<float>{static_cast<const float*>(f)});
}

int stencil7_residual_f64(const void* u, const void* f, const void* lo, const void* hi,
                          void* out, int lz, int ny, int nx, void* stream) {
  return launch_apply<double>(u, lo, hi, out, lz, ny, nx, stream,
                              Residual<double>{static_cast<const double*>(f)});
}

// out = sum f - prod (A f) with zero halo planes; sum = w1 + w2 and
// prod = w1 w2 for the two sweeps' omega / 6, formed by the caller
int stencil7_smooth0_pair_f32(const void* f, void* out, int lz, int ny, int nx,
                              double sum, double prod, void* stream) {
  return launch_apply<float>(f, nullptr, nullptr, out, lz, ny, nx, stream,
                             Smooth0Pair<float>{static_cast<float>(sum),
                                                static_cast<float>(prod)});
}

int stencil7_smooth0_pair_f64(const void* f, void* out, int lz, int ny, int nx,
                              double sum, double prod, void* stream) {
  return launch_apply<double>(f, nullptr, nullptr, out, lz, ny, nx, stream,
                              Smooth0Pair<double>{sum, prod});
}

int stencil7_dot_f32(const void* u, const void* lo, const void* hi, void* y,
                     void* partial, void* out, int lz, int ny, int nx, void* stream) {
  return launch_dot<float>(u, lo, hi, y, partial, out, lz, ny, nx, stream);
}

int stencil7_dot_f64(const void* u, const void* lo, const void* hi, void* y,
                     void* partial, void* out, int lz, int ny, int nx, void* stream) {
  return launch_dot<double>(u, lo, hi, y, partial, out, lz, ny, nx, stream);
}

// k slabs U (k, lz, ny, nx) -> Y = A U; lo, hi are (k, ny, nx) blocks or both null
int stencil7_apply_many_f32(const void* u, const void* lo, const void* hi, void* y,
                            int k, int lz, int ny, int nx, void* stream) {
  return launch_many<float, false>(u, lo, hi, y, nullptr, nullptr, k, lz, ny, nx, stream);
}

int stencil7_apply_many_f64(const void* u, const void* lo, const void* hi, void* y,
                            int k, int lz, int ny, int nx, void* stream) {
  return launch_many<double, false>(u, lo, hi, y, nullptr, nullptr, k, lz, ny, nx, stream);
}

// ... and out[j] = <u_j, A u_j>; partial holds k * stencil7_dot_blocks(lz, ny, nx)
int stencil7_dot_many_f32(const void* u, const void* lo, const void* hi, void* y,
                          void* partial, void* out, int k, int lz, int ny, int nx,
                          void* stream) {
  return launch_many<float, true>(u, lo, hi, y, partial, out, k, lz, ny, nx, stream);
}

int stencil7_dot_many_f64(const void* u, const void* lo, const void* hi, void* y,
                          void* partial, void* out, int k, int lz, int ny, int nx,
                          void* stream) {
  return launch_many<double, true>(u, lo, hi, y, partial, out, k, lz, ny, nx, stream);
}

}  // extern "C"
