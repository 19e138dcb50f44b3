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
//   stencil7_{apply,dot,apply_many,dot_many}_bf16 -> the bfloat16-storage
//                                     instantiations of the same four TPU
//                                     kernels (_compute_dtype :46)
//   stencil7_{smooth,residual,smooth0_pair}_bf16 -> the bfloat16 instantiations
//                                     of stencil3d_smooth_pallas,
//                                     stencil3d_residual_pallas and
//                                     stencil3d_smooth0_pair_pallas, which the
//                                     TPU V-cycle runs at bfloat16 storage
//                                     (mg.py _sweep, _residual, _smooth0);
//                                     the bf16 apply with an epilogue
// The dots of every dtype and everything at bf16 run the run kernel of the
// last section (16-byte runs a thread); the f32/f64 applies and V-cycle
// passes run the march below.
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
// f (3 passes).  The march gives each thread one x column of ZC planes,
// keeping the z-1 / z / z+1 values in registers, so u is read from device
// memory about once; the x and y neighbours come from L1/L2, which hold the
// rows that neighbouring threads of the block have just loaded.
//
// The many-column applies take k slabs U (k, lz, ny, nx) and halo blocks
// (k, ny, nx) (or null for zero halos) in one launch: grid z covers the
// z-tiles of all k columns, column by column, and each column's slab is
// marched exactly as the single-RHS kernel marches it (same tiles per block,
// same order), so each column's A u is bit-equal to one stencil7_apply launch
// on it.  The TPU kernel's VMEM chunk plan for k resident columns has no
// counterpart: the bound is the same k (2 n + 2 planes) bytes, and the march
// reads each column's u about once.
//
// The dots are deterministic: no float atomics, and a fixed order of summing
// the per-block partials (the run kernel's section says how), so two runs on
// the same input give the same bits and CG iteration counts do not wobble.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kBX = 32;   // threads along x (one warp: coalesced 128-byte rows)
constexpr int kBY = 8;    // threads along y
constexpr int kZC = 8;    // z-planes marched by each thread per tile
constexpr int kThreads = kBX * kBY;
constexpr int kSumThreads = 1024;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

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
// the grid of one single-slab launch being (gx, gridDim.y, gz).
template <typename T, bool kHalo, class Epilogue>
__device__ __forceinline__ void march(const T* __restrict__ u, const T* __restrict__ halo_lo,
                                      const T* __restrict__ halo_hi, T* __restrict__ y,
                                      int lz, int ny, int nx, int ntx, int nty, int ntz,
                                      int bx, int gx, int bz, int gz, Epilogue epi) {
  const int64_t plane = static_cast<int64_t>(ny) * nx;
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
          below = cur;
          cur = above;
        }
      }
    }
  }
}

template <typename T, bool kHalo, class Epilogue>
__global__ void __launch_bounds__(kThreads)
stencil7_kernel(const T* __restrict__ u, const T* __restrict__ halo_lo,
                const T* __restrict__ halo_hi, T* __restrict__ y, int lz, int ny, int nx,
                int ntx, int nty, int ntz, Epilogue epi) {
  march<T, kHalo>(u, halo_lo, halo_hi, y, lz, ny, nx, ntx, nty, ntz, blockIdx.x, gridDim.x,
                  blockIdx.z, gridDim.z, epi);
}

// k slabs in one launch, grid (gx, gy, k gz) for the single kernel's grid
// (gx, gy, gz) of one slab: block z = j gz + bz is block (x, y, bz) of column
// j's single-slab launch, marching the same tiles.  The launcher lowers gz
// below the single kernel's where k gz would pass the 65535 cap; march's z
// loop then covers the rest.
template <typename T, bool kHalo>
__global__ void __launch_bounds__(kThreads)
stencil7_many_kernel(const T* __restrict__ u, const T* __restrict__ halo_lo,
                     const T* __restrict__ halo_hi, T* __restrict__ y, int lz, int ny, int nx,
                     int ntx, int nty, int ntz, int gz) {
  const int j = static_cast<int>(blockIdx.z) / gz;
  const int bz = static_cast<int>(blockIdx.z) - j * gz;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t slab = plane * lz;
  march<T, kHalo>(u + j * slab, kHalo ? halo_lo + j * plane : nullptr,
                  kHalo ? halo_hi + j * plane : nullptr, y + j * slab, lz, ny, nx, ntx, nty,
                  ntz, blockIdx.x, gridDim.x, bz, gz, StoreAu<T>{});
}

// One block per column j: out[j] = sum of partial[j n : (j + 1) n], always in
// the same order (the bf16 dots' second launch).
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
    stencil7_kernel<T, true, Epilogue><<<t.grid, dim3(kBX, kBY), 0, s>>>(
        ut, lot, hit, static_cast<T*>(y), lz, ny, nx, t.ntx, t.nty, t.ntz, epi);
  } else {
    stencil7_kernel<T, false, Epilogue><<<t.grid, dim3(kBX, kBY), 0, s>>>(
        ut, nullptr, nullptr, static_cast<T*>(y), lz, ny, nx, t.ntx, t.nty, t.ntz, epi);
  }
  return static_cast<int>(cudaGetLastError());
}

// k slabs: Y = A U.  Null lo and hi select zero halos.  1 <= k <= 65535 (the
// wrappers check).
template <typename T>
int launch_apply_many(const void* u, const void* lo, const void* hi, void* y, int k, int lz,
                      int ny, int nx, void* stream) {
  const Tiles t = make_tiles(lz, ny, nx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gz = t.grid.z * static_cast<unsigned>(k) <= 65535u
                         ? t.grid.z : 65535u / static_cast<unsigned>(k);
  const dim3 grid(t.grid.x, t.grid.y, gz * static_cast<unsigned>(k));
  const T* ut = static_cast<const T*>(u);
  T* yt = static_cast<T*>(y);
  if (lo != nullptr && hi != nullptr) {
    stencil7_many_kernel<T, true><<<grid, dim3(kBX, kBY), 0, s>>>(
        ut, static_cast<const T*>(lo), static_cast<const T*>(hi), yt, lz, ny, nx,
        t.ntx, t.nty, t.ntz, static_cast<int>(gz));
  } else {
    stencil7_many_kernel<T, false><<<grid, dim3(kBX, kBY), 0, s>>>(
        ut, nullptr, nullptr, yt, lz, ny, nx, t.ntx, t.nty, t.ntz, static_cast<int>(gz));
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the run kernel: 16-byte runs a thread ------------------------------------
//
// One kernel for the dots of every dtype (the batched dot with k columns, the
// single-RHS dot as its k = 1 launch) and for the bf16 applies and V-cycle
// passes: a column of a batched launch and a single launch on it march the
// same tiles and write the same partials, so their A u and dot are bit-equal
// by construction, at every shape.  A thread owns kV = 16 / sizeof(T)
// consecutive points of a plane (8 bf16, 4 f32, 2 f64).  The plane is cut by
// its flat index p = y nx + x: a block of kRunThreads threads owns the
// kRunThreads kV consecutive points of a chunk (whole rows, or several blocks
// a row), thread t the run p0 + t kV .. + kV - 1, and the block marches up a
// z-chunk of zc planes.  Per plane a thread reads the run above (loaded
// kRing planes ahead, so the next planes' loads are in flight while it
// computes), the runs at y - 1 and y + 1 (rows of the plane in use that
// neighbouring threads and blocks load, so L1 and L2 serve them), and its two
// x neighbours from the neighbouring lanes by shuffles: one point each,
// loaded only at the warp's two ends.  The z - 1 / z / z + 1 values stay in
// registers.  Two routes, chosen in the launcher (run_vec16):
//   * "vec16": nx a multiple of kV and every pointer 16-byte aligned (then
//     every column, halo plane and row is): one 16-byte load or store a run,
//     which never leaves its row;
//   * "elem": any other shape, such as (37, 45, 131), or a misaligned view:
//     kV loads a run, which may cross rows; each point's edges come from bit
//     masks made once a tile.
// Both compute the same sums in the same order, so they give the same bits.
// The V-cycle's three bf16 entry points run the same march with an epilogue
// (RunSmooth, RunResidual, RunSmooth0Pair below): f's run at the point is
// loaded where the epilogue reads it (one more stream of 2 bytes a point) and
// the stored value is the epilogue's fp32 result, rounded once.
// The z-chunk zc (kZMax, halved down to 1) is the longest that still gives
// kTarget blocks for ONE slab: it depends on the shape alone, never on k.
// k is grid z, so no cap on k z-chunks is needed (k <= 65535, the wrappers
// check).
//
// Arithmetic, in C (fp32 for bf16 and f32, fp64 for f64): each point is
// lifted to C (bf16: bits << 16, as __bfloat162float), the sum is 6 u by
// mul_rn, then minus z-1, z+1, y-1, y+1, x-1, x+1 (the plain version's order,
// a missing neighbour subtracting 0), stored (bf16: rounded once to nearest
// even), or first turned by the epilogue in fp32 (u + w (f - Au), f - Au,
// sum u - prod Au, each product by __fmul_rn, as the f32 epilogues) and then
// rounded once: the TPU kernel's cdt = fp32 arithmetic (pallas_stencil.py:111),
// and the plain versions' lift-compute-round.  The dot sums u * Au from the
// unrounded C Au (pallas_stencil.py:237) with fma_rn in a fixed order: per
// thread over z and its run, then block_sum, one C partial a block.  The f32
// and f64 dots fold the partials in the same launch (fold, below: the last
// block of a column to finish sums them in a fixed order, so the result does
// not depend on which block that is); the bf16 dots sum them with
// sum_partials_kernel, one block a column.  Bound: 2 sizeof(T) bytes a point
// (read u, write Au); the V-cycle passes 6 (smooth, residual: read u and f,
// write out) or 4 (smooth0_pair: read f, write out) at bf16.

using bf16 = __nv_bfloat16;

constexpr int kRunThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Per storage dtype: the arithmetic type C, the points a thread owns, the
// longest z-chunk, the least blocks of one slab the chunk is cut for, and the
// runs above in flight (for the dot, or for the apply: only bf16 applies run
// this kernel).  The values are the fastest of tuning runs on the H100:
// bf16: more, shorter marches (512 or 1024 blocks) measured slower at 128^3
// and the same at 512^3; 2 runs in flight for the dot, whose accumulator
// takes registers, 3 for the apply (4 was slower for both).  f32 and f64
// dots: 1 run in flight (f32: 2-4 runs 4-11% slower at 512^3; f64: 2 and 3
// runs 8% and 14% slower at 512^3, 3 by a third at 128^3); 4-, 16- or
// 32-plane chunks 4-38% slower; capping a column's blocks at 512-4096 (each
// looping over tiles, so the fold has fewer partials to sum) 2-35% slower
// at 512^3.
template <typename T>
struct Run;

template <>
struct Run<bf16> {
  using C = float;
  static constexpr int kV = 8, kZMax = 8, kTarget = 128;
  __host__ __device__ static constexpr int ring(bool dot) { return dot ? 2 : 3; }
};

template <>
struct Run<float> {
  using C = float;
  static constexpr int kV = 4, kZMax = 8, kTarget = 128;
  __host__ __device__ static constexpr int ring(bool) { return 1; }
};

template <>
struct Run<double> {
  using C = double;
  static constexpr int kV = 2, kZMax = 8, kTarget = 128;
  __host__ __device__ static constexpr int ring(bool) { return 1; }
};

struct RunTiles {
  int64_t nch;    // run chunks a plane
  int zc, ntz;    // planes a block marches, z-chunks a slab
  dim3 grid;      // one slab's grid: x chunks, y z-chunks (the kernel loops past the caps)
};

template <typename T>
RunTiles make_run_tiles(int lz, int ny, int nx) {
  constexpr int kPoints = kRunThreads * Run<T>::kV;
  RunTiles t;
  t.nch = (static_cast<int64_t>(ny) * nx - 1) / kPoints + 1;
  t.zc = Run<T>::kZMax;
  while (t.zc > 1 && t.nch * ((lz - 1) / t.zc + 1) < Run<T>::kTarget) t.zc /= 2;
  t.ntz = (lz - 1) / t.zc + 1;
  // within gridDim's limits (2^31 - 1 in x, 65535 in y), and a column's
  // blocks below 2^32 (the fold's ticket is 32 bits); the kernel loops over
  // the tiles past them
  const int64_t gx = std::min<int64_t>(t.nch, INT_MAX);
  const int64_t gy = std::min<int64_t>({t.ntz, 65535, UINT_MAX / gx});
  t.grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), 1);
  return t;
}

template <typename T>
bool run_vec16(int nx, const void* u, const void* lo, const void* hi, const void* y,
               const void* f) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(lo) |
                         reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(f);
  return nx % Run<T>::kV == 0 && bits % 16 == 0;
}

// The stored value from the centre u, A u and f's point (read only when kF);
// every product by __fmul_rn, so no FMA contracts it.
struct RunAu {
  static constexpr bool kF = false;
  template <typename C>
  __device__ C operator()(C, C au, C) const { return au; }
};

struct RunSmooth {         // u + w (f - A u)
  static constexpr bool kF = true;
  float w;
  __device__ float operator()(float u, float au, float f) const {
    return u + __fmul_rn(w, f - au);
  }
};

struct RunResidual {       // f - A u
  static constexpr bool kF = true;
  __device__ float operator()(float, float au, float f) const { return f - au; }
};

struct RunSmooth0Pair {    // (w1 + w2) f - (w1 w2) A f, the kernel run on u = f
  static constexpr bool kF = false;
  float sum, prod;
  __device__ float operator()(float u, float au, float) const {
    return __fmul_rn(sum, u) - __fmul_rn(prod, au);
  }
};

// One stored point lifted to C, and a C value stored (bf16: rounded once).
__device__ __forceinline__ float lift1(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float lift1(float v) { return v; }
__device__ __forceinline__ double lift1(double v) { return v; }
__device__ __forceinline__ void store1(bf16* d, float v) { *d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* d, float v) { *d = v; }
__device__ __forceinline__ void store1(double* d, double v) { *d = v; }
template <typename T>
__device__ __forceinline__ T zero1() { return T(0); }
template <>
__device__ __forceinline__ bf16 zero1<bf16>() { return __ushort_as_bfloat16(0); }

// A run of kV stored points as it is loaded (through the read-only path: no
// launch writes what it reads), lifted to C, and stored; m has bit i set
// where point i exists (the vec16 route: all bits or none).
template <typename T, bool kVec>
struct RunIO;

template <typename T>        // vec16, f32 and f64: the run is one 16-byte vector
struct RunIO<T, true> {
  static constexpr int kV = Run<T>::kV;
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw load(const T* s, unsigned m) {
    return m ? __ldg(reinterpret_cast<const uint4*>(s)) : zero();
  }
  static __device__ __forceinline__ void lift(const Raw& w, T (&v)[kV]) {
    memcpy(v, &w, sizeof(w));
  }
  static __device__ __forceinline__ void store(T* d, const T (&v)[kV], unsigned m) {
    if (m) {
      Raw w;
      memcpy(&w, v, sizeof(w));
      *reinterpret_cast<uint4*>(d) = w;
    }
  }
};

template <>                  // vec16, bf16: 8 points as 4 words, lifted in pairs
struct RunIO<bf16, true> {
  static constexpr int kV = Run<bf16>::kV;
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw load(const bf16* s, unsigned m) {
    return m ? __ldg(reinterpret_cast<const uint4*>(s)) : zero();
  }
  static __device__ __forceinline__ void lift(const Raw& w, float (&v)[kV]) {
    const unsigned q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // point 2i is the low half of word i
      v[2 * i] = __uint_as_float(q[i] << 16);
      v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    unsigned r;
    memcpy(&r, &h, sizeof(r));
    return r;
  }
  static __device__ __forceinline__ void store(bf16* d, const float (&v)[kV], unsigned m) {
    if (m) {
      *reinterpret_cast<uint4*>(d) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                                pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
  }
};

template <typename T>        // elem: kV loads and stores a run
struct RunIO<T, false> {
  static constexpr int kV = Run<T>::kV;
  using C = typename Run<T>::C;
  struct Raw {
    T e[kV];
  };
  static __device__ __forceinline__ Raw zero() {
    Raw r;
#pragma unroll
    for (int i = 0; i < kV; ++i) r.e[i] = zero1<T>();
    return r;
  }
  static __device__ __forceinline__ Raw load(const T* s, unsigned m) {
    Raw r = zero();
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (m >> i & 1u) r.e[i] = __ldg(s + i);
    }
    return r;
  }
  static __device__ __forceinline__ void lift(const Raw& w, C (&v)[kV]) {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = lift1(w.e[i]);
  }
  static __device__ __forceinline__ void store(T* d, const C (&v)[kV], unsigned m) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (m >> i & 1u) store1(d + i, v[i]);
    }
  }
};

// The run starting at in-plane point p over planes z0 .. z1-1 of one slab;
// adds the run's share of sum(u * Au) to acc when kDot.  Every thread of the
// block calls it with the same z0, z1 (the shuffles need the whole warp).
template <typename T, bool kDot, bool kHalo, bool kVec, class Epi>
__device__ __forceinline__ void march_run(const T* __restrict__ u,
                                          const T* __restrict__ halo_lo,
                                          const T* __restrict__ halo_hi,
                                          const T* __restrict__ f,
                                          T* __restrict__ y, int lz, int ny, int nx,
                                          int64_t p, int z0, int z1,
                                          typename Run<T>::C& acc, Epi epi) {
  using C = typename Run<T>::C;
  using IO = RunIO<T, kVec>;
  using Raw = typename IO::Raw;
  constexpr int kV = Run<T>::kV;
  constexpr int kRing = Run<T>::ring(kDot);
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  // bit i: point p + i lies in the plane (in), and has an x-1 (xm), x+1
  // (xp), y-1 (ym), y+1 (yp) neighbour
  unsigned in = 0, xm = 0, xp = 0, ym = 0, yp = 0;
  if (p < plane) {
    int64_t row = p / nx;
    int x = static_cast<int>(p - row * nx);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (i > 0 && ++x == nx) {     // the elem route's runs may cross rows
        x = 0;
        ++row;
      }
      if (p + i < plane) {
        in |= 1u << i;
        xm |= static_cast<unsigned>(x > 0) << i;
        xp |= static_cast<unsigned>(x < nx - 1) << i;
        ym |= static_cast<unsigned>(row > 0) << i;
        yp |= static_cast<unsigned>(row < ny - 1) << i;
      }
    }
  }
  // plane q's run: u, a halo plane, or none (zeros)
  auto load = [&](int q) -> Raw {
    const T* s = q < 0 ? (kHalo ? halo_lo + p : nullptr)
               : q >= lz ? (kHalo ? halo_hi + p : nullptr)
                         : u + q * plane + p;
    return s ? IO::load(s, in) : IO::zero();
  };
  const int lane = static_cast<int>(threadIdx.x) & 31;
  C b[kV], c[kV];
  IO::lift(load(z0 - 1), b);
  IO::lift(load(z0), c);
  // a ring of the runs above: slot s holds the plane step z0 + s (mod kRing)
  // reads as z + 1, reloaded kRing planes ahead as soon as it is read.  The
  // steps are unrolled by kRing, so the slots stay registers with no copies
  // (a copy would wait for its load).
  Raw ring[kRing];
#pragma unroll
  for (int s = 0; s < kRing; ++s) ring[s] = z0 + s < z1 ? load(z0 + 1 + s) : IO::zero();
  for (int zb = z0; zb < z1; zb += kRing) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      const int z = zb + s;
      if (z >= z1) break;
      C a[kV], vym[kV], vyp[kV];
      IO::lift(ring[s], a);
      ring[s] = z + kRing < z1 ? load(z + 1 + kRing) : IO::zero();
      const T* uc = u + z * plane + p;
      IO::lift(IO::load(uc - nx, ym), vym);
      IO::lift(IO::load(uc + nx, yp), vyp);
      // the x neighbours of the run's ends: the neighbouring lanes' end
      // points, loaded where the warp ends
      C xl = __shfl_up_sync(kFull, c[kV - 1], 1);
      C xr = __shfl_down_sync(kFull, c[0], 1);
      if (lane == 0 && (xm & 1u)) xl = lift1(__ldg(uc - 1));
      if (lane == 31 && (xp >> (kV - 1) & 1u)) xr = lift1(__ldg(uc + kV));
      C fv[kV];
      if constexpr (Epi::kF) {
        IO::lift(IO::load(f + z * plane + p, in), fv);
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) fv[i] = C(0);
      }
      C v[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        // on the vec16 route only a run's first and last points can miss an
        // x neighbour
        const bool has_l = (kVec && i > 0) || (xm >> i & 1u);
        const bool has_r = (kVec && i < kV - 1) || (xp >> i & 1u);
        C t = mul_rn(C(6), c[i]);
        t -= b[i];
        t -= a[i];
        t -= vym[i];
        t -= vyp[i];
        t -= has_l ? (i == 0 ? xl : c[i - 1]) : C(0);
        t -= has_r ? (i == kV - 1 ? xr : c[i + 1]) : C(0);
        v[i] = epi(c[i], t, fv[i]);
        if (kDot) acc = fma_rn(c[i], t, acc);
      }
      IO::store(y + z * plane + p, v, in);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        b[i] = c[i];
        c[i] = a[i];
      }
    }
  }
}

// A ticket: an atomic add with acquire-release semantics at device scope
// (what cuda::atomic_ref<unsigned, cuda::thread_scope_device>::fetch_add(1,
// cuda::memory_order_acq_rel) emits).  It publishes the calling thread's
// earlier writes with the ticket, and lets it see every write published
// before the tickets drawn ahead of it.  (__threadfence before and after a
// relaxed atomicAdd measured 3.5% slower at 128^3 in tuning runs on the H100,
// the same at 512^3.)
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned t;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;" : "=r"(t) : "l"(ticket) : "memory");
  return t;
}

// The dot's fold in the launch: each block has written its partial to part
// (nblk of them, one column's) from thread 0, which then draws a ticket from
// the column's counter.  The block that draws the last ticket (__syncthreads
// passes thread 0's view on to it) reads all nblk partials from L2 and sums
// them in a fixed order (thread t the partials t, t + kRunThreads, ..., then
// block_sum), whichever block it is, writes *out and sets the counter back
// to zero, so it is zero at the next launch on the stream (also a graph's
// replay: the counter is the caller's, zeroed once, not per-call scratch).
// No float atomics.  (Summing the partials in a second launch, as the bf16
// dots do, measured 14% slower at 128^3 in tuning runs on the H100 (row 10:
// 7%), and at 512^3 0.6% faster (row 10: 3% slower).)
template <typename C>
__device__ __forceinline__ void fold(const C* part, unsigned nblk, unsigned* ticket, C* out) {
  __shared__ bool last;
  if (threadIdx.x == 0) last = take_ticket(ticket) == nblk - 1;
  __syncthreads();
  if (!last) return;
  C a = C(0);
#pragma unroll 8
  for (unsigned i = threadIdx.x; i < nblk; i += kRunThreads) a += __ldcg(part + i);
  const C total = block_sum(a);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0u;
  }
}

// Y = A U for k slabs (grid z = column j); with kDot the per-block partial
// goes to partial[j nblk + block], nblk = gridDim.x gridDim.y: one single
// launch's layout for each column, and the f32/f64 dots fold column j's
// into out[j] (tickets[j] its counter).
template <typename T, bool kDot, bool kHalo, bool kVec, class Epi>
__global__ void __launch_bounds__(kRunThreads)
stencil7_run_kernel(const T* __restrict__ u, const T* __restrict__ halo_lo,
                    const T* __restrict__ halo_hi, const T* __restrict__ f,
                    T* __restrict__ y, typename Run<T>::C* __restrict__ partial,
                    unsigned* __restrict__ tickets, typename Run<T>::C* __restrict__ out,
                    int lz, int ny, int nx, int64_t nch, int zc, int ntz, Epi epi) {
  using C = typename Run<T>::C;
  constexpr int kPoints = kRunThreads * Run<T>::kV;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t j = blockIdx.z;
  u += j * plane * lz;
  y += j * plane * lz;
  if (Epi::kF) f += j * plane * lz;
  if (kHalo) {
    halo_lo += j * plane;
    halo_hi += j * plane;
  }
  C acc = C(0);
  for (int tz = blockIdx.y; tz < ntz; tz += gridDim.y) {
    const int z0 = tz * zc, z1 = min(z0 + zc, lz);
    for (int64_t ch = blockIdx.x; ch < nch; ch += gridDim.x) {
      march_run<T, kDot, kHalo, kVec>(u, halo_lo, halo_hi, f, y, lz, ny, nx,
                                      ch * kPoints + static_cast<int64_t>(threadIdx.x) *
                                                         Run<T>::kV,
                                      z0, z1, acc, epi);
    }
  }
  if (kDot) {
    const C s = block_sum(acc);
    const unsigned nblk = gridDim.x * gridDim.y;
    C* part = partial + j * nblk;
    if (threadIdx.x == 0) part[blockIdx.x + gridDim.x * blockIdx.y] = s;
    if constexpr (!std::is_same<T, bf16>::value) fold(part, nblk, tickets + j, out + j);
  }
}

// k slabs: Y = A U and, with kDot, out[j] = <u_j, A u_j> (partial and out in
// C; tickets, k counters at zero, for the f32/f64 fold, null for bf16); or,
// with an epilogue and k = 1, the bf16 V-cycle's passes (f null unless
// Epi::kF).  Null lo and hi select zero halos.  1 <= k <= 65535.
template <typename T, bool kDot, class Epi = RunAu>
int launch_run(const void* u, const void* lo, const void* hi, void* y, void* partial,
               void* tickets, void* out, int k, int lz, int ny, int nx, void* stream,
               const void* f = nullptr, Epi epi = Epi{}) {
  using C = typename Run<T>::C;
  using Kernel = void (*)(const T*, const T*, const T*, const T*, T*, C*, unsigned*, C*, int,
                          int, int, int64_t, int, int, Epi);
  const RunTiles t = make_run_tiles<T>(lz, ny, nx);
  const bool vec = run_vec16<T>(nx, u, lo, hi, y, f);
  const Kernel kernel = lo != nullptr && hi != nullptr
                            ? (vec ? stencil7_run_kernel<T, kDot, true, true, Epi>
                                   : stencil7_run_kernel<T, kDot, true, false, Epi>)
                            : (vec ? stencil7_run_kernel<T, kDot, false, true, Epi>
                                   : stencil7_run_kernel<T, kDot, false, false, Epi>);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(t.grid.x, t.grid.y, static_cast<unsigned>(k)), kRunThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<const T*>(f), static_cast<T*>(y), static_cast<C*>(partial),
      static_cast<unsigned*>(tickets), static_cast<C*>(out), lz, ny, nx, t.nch, t.zc, t.ntz,
      epi);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !kDot || !std::is_same<T, bf16>::value) return err;
  const int64_t nblk = static_cast<int64_t>(t.grid.x) * t.grid.y;
  sum_partials_kernel<float><<<k, kSumThreads, 0, s>>>(static_cast<const float*>(partial), nblk,
                                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
long long run_blocks(int lz, int ny, int nx) {
  const RunTiles t = make_run_tiles<T>(lz, ny, nx);
  return static_cast<long long>(t.grid.x) * t.grid.y;
}

}  // namespace

extern "C" {

// The CUDA runtime's text for an error code returned by the entry points below.
const char* stencil7_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Length of the partial-sum scratch buffer stencil7_dot_<dtype> needs for
// this shape (stencil7_dot_many_<dtype> needs k times as much).
long long stencil7_dot_blocks_f32(int lz, int ny, int nx) { return run_blocks<float>(lz, ny, nx); }
long long stencil7_dot_blocks_f64(int lz, int ny, int nx) { return run_blocks<double>(lz, ny, nx); }
long long stencil7_dot_blocks_bf16(int lz, int ny, int nx) { return run_blocks<bf16>(lz, ny, nx); }

// 1 when a run-kernel launch on these pointers takes the vec16 route, 0 for
// elem (f: the bf16 V-cycle passes' right-hand side, null for the others)
int stencil7_run_route_f32(int nx, const void* u, const void* lo, const void* hi,
                           const void* y) {
  return run_vec16<float>(nx, u, lo, hi, y, nullptr) ? 1 : 0;
}

int stencil7_run_route_f64(int nx, const void* u, const void* lo, const void* hi,
                           const void* y) {
  return run_vec16<double>(nx, u, lo, hi, y, nullptr) ? 1 : 0;
}

int stencil7_bf16_route(int nx, const void* u, const void* lo, const void* hi, const void* y,
                        const void* f) {
  return run_vec16<bf16>(nx, u, lo, hi, y, f) ? 1 : 0;
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

// y = A u and *out = <u, A u> in one launch; partial holds
// stencil7_dot_blocks_<dtype>(lz, ny, nx), tickets one unsigned counter that
// is zero (and is zero again when the launch ends)
int stencil7_dot_f32(const void* u, const void* lo, const void* hi, void* y, void* partial,
                     void* tickets, void* out, int lz, int ny, int nx, void* stream) {
  return launch_run<float, true>(u, lo, hi, y, partial, tickets, out, 1, lz, ny, nx, stream);
}

int stencil7_dot_f64(const void* u, const void* lo, const void* hi, void* y, void* partial,
                     void* tickets, void* out, int lz, int ny, int nx, void* stream) {
  return launch_run<double, true>(u, lo, hi, y, partial, tickets, out, 1, lz, ny, nx, stream);
}

// k slabs U (k, lz, ny, nx) -> Y = A U; lo, hi are (k, ny, nx) blocks or both null
int stencil7_apply_many_f32(const void* u, const void* lo, const void* hi, void* y,
                            int k, int lz, int ny, int nx, void* stream) {
  return launch_apply_many<float>(u, lo, hi, y, k, lz, ny, nx, stream);
}

int stencil7_apply_many_f64(const void* u, const void* lo, const void* hi, void* y,
                            int k, int lz, int ny, int nx, void* stream) {
  return launch_apply_many<double>(u, lo, hi, y, k, lz, ny, nx, stream);
}

// ... and out[j] = <u_j, A u_j> in the same launch; partial holds
// k * stencil7_dot_blocks_<dtype>(lz, ny, nx), tickets k counters at zero
int stencil7_dot_many_f32(const void* u, const void* lo, const void* hi, void* y,
                          void* partial, void* tickets, void* out, int k, int lz, int ny,
                          int nx, void* stream) {
  return launch_run<float, true>(u, lo, hi, y, partial, tickets, out, k, lz, ny, nx, stream);
}

int stencil7_dot_many_f64(const void* u, const void* lo, const void* hi, void* y,
                          void* partial, void* tickets, void* out, int k, int lz, int ny,
                          int nx, void* stream) {
  return launch_run<double, true>(u, lo, hi, y, partial, tickets, out, k, lz, ny, nx, stream);
}

// The bfloat16-storage entry points: bf16 u, halos and Au, fp32 arithmetic,
// fp32 partial and out (summed by a second launch).  The single-RHS pair is
// the k = 1 launch of the batched kernel.
int stencil7_apply_bf16(const void* u, const void* lo, const void* hi, void* y,
                        int lz, int ny, int nx, void* stream) {
  return launch_run<bf16, false>(u, lo, hi, y, nullptr, nullptr, nullptr, 1, lz, ny, nx,
                                 stream);
}

int stencil7_dot_bf16(const void* u, const void* lo, const void* hi, void* y,
                      void* partial, void* out, int lz, int ny, int nx, void* stream) {
  return launch_run<bf16, true>(u, lo, hi, y, partial, nullptr, out, 1, lz, ny, nx, stream);
}

int stencil7_apply_many_bf16(const void* u, const void* lo, const void* hi, void* y,
                             int k, int lz, int ny, int nx, void* stream) {
  return launch_run<bf16, false>(u, lo, hi, y, nullptr, nullptr, nullptr, k, lz, ny, nx,
                                 stream);
}

// partial holds k * stencil7_dot_blocks_bf16(lz, ny, nx)
int stencil7_dot_many_bf16(const void* u, const void* lo, const void* hi, void* y,
                           void* partial, void* out, int k, int lz, int ny, int nx,
                           void* stream) {
  return launch_run<bf16, true>(u, lo, hi, y, partial, nullptr, out, k, lz, ny, nx, stream);
}

// The V-cycle's bf16 passes: bf16 u, f, halos (or both null) and out, fp32
// arithmetic rounded once at the store.  out = u + w (f - A u):
int stencil7_smooth_bf16(const void* u, const void* f, const void* lo, const void* hi,
                         void* out, int lz, int ny, int nx, double w, void* stream) {
  return launch_run<bf16, false>(u, lo, hi, out, nullptr, nullptr, nullptr, 1, lz, ny, nx,
                                 stream, f, RunSmooth{static_cast<float>(w)});
}

// out = f - A u
int stencil7_residual_bf16(const void* u, const void* f, const void* lo, const void* hi,
                           void* out, int lz, int ny, int nx, void* stream) {
  return launch_run<bf16, false>(u, lo, hi, out, nullptr, nullptr, nullptr, 1, lz, ny, nx,
                                 stream, f, RunResidual{});
}

// out = sum f - prod (A f) with zero halo planes
int stencil7_smooth0_pair_bf16(const void* f, void* out, int lz, int ny, int nx, double sum,
                               double prod, void* stream) {
  return launch_run<bf16, false>(f, nullptr, nullptr, out, nullptr, nullptr, nullptr, 1, lz,
                                 ny, nx, stream, nullptr,
                                 RunSmooth0Pair{static_cast<float>(sum),
                                                static_cast<float>(prod)});
}

}  // extern "C"
