// Multigrid V-cycle kernels that need two-deep z neighbourhoods, for Hopper
// (sm_90a), plain C entry points.
//
// What they replace (mpi_petsc4py_example_tpu/ops/pallas_stencil.py):
//   mg3d_smooth_pair_{f32,f64}       -> stencil3d_smooth_pair_pallas (:1251),
//                                       body _double_sweep_kernel (:1157)
//   mg3d_residual_restrict_{f32,f64} -> stencil3d_residual_restrict_pallas (:1090),
//                                       body _resid_restrict3_kernel (:987)
//
// Both work on a single-slab z-slab u (lz, ny, nx), x fastest, with zero
// Dirichlet ghosts on every side (no halo planes: the V-cycle's local levels).
// Au below is the 7-point apply 6u - (6 neighbours) in the plain order.
//
// smooth_pair: two damped-Jacobi sweeps, u2 = S_w2(S_w1(u)) with
// S_w(v) = v + w (f - A v).  Sweep 2 needs u1 at the x, y and z neighbours, so a
// block computes u1 on its (32 x 8) tile plus a one-point ring into shared
// memory, keeps a ring of three such u1 planes while it marches up z, and
// evaluates sweep 2 from the ring.  u1 outside the global domain is stored as
// exactly 0 (Dirichlet ghosts stay zero through sweep 1), which is what the
// plain version's zero fill gives.  Bound: read u and f, write u2 (3 fine
// passes); ~20 flop/point, far under the fp32 rate.  The ring recomputes
// sweep 1 on 34 x 10 points per 32 x 8 outputs and one extra plane at each
// end of a z-chunk; u and f re-reads come from L1/L2.
//
// residual_restrict: the coarse right-hand side restrict(f - A u) of shape
// (lz/2, ny/2, nx/2), per axis
//   c[i] = s (0.75 (r[2i] + r[2i+1]) + 0.25 (r[2i-1] + r[2i+2])),  s = RSCALE,
// with r = 0 outside the domain (r at fine index -1 or n is 0, not f - A u
// evaluated there).  The TPU does y/x as two MXU matmuls with the banded _tmat
// weights; here the four taps are computed directly, in the plain version's
// order: z first, then y, then x.  Each thread marches its patch points up
// the fine planes, keeping r at the two planes below in registers, and writes
// the z-restricted plane of the block's patch into shared memory; the block
// then restricts y and x from there.  Neither the fine residual nor any
// intermediate goes to device memory.  Bound: read u and f once, write 1/8 of
// a pass (2.125 fine passes).
//
// Arithmetic: products go through __fmul_rn/__dmul_rn so nvcc cannot contract
// them into FMAs, and every operation rounds as the plain PyTorch version's
// separate operations do.  The kernels launch on the caller's stream, allocate
// nothing and do not synchronise; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBX = 32;   // threads along x
constexpr int kBY = 8;    // threads along y
constexpr int kThreads = kBX * kBY;
constexpr int kPairZC = 16;      // fine planes per smooth_pair tile
constexpr int kRestrictKC = 4;   // coarse planes per residual_restrict tile

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

struct Grid3 {
  int lz, ny, nx;
  int64_t plane;
};

// r = f - A u at (z, y, x) with zero ghosts, and 0 outside the domain.
template <typename T>
__device__ __forceinline__ T residual_at(const T* __restrict__ u, const T* __restrict__ f,
                                         const Grid3& g, int z, int y, int x) {
  if (z < 0 || z >= g.lz || y < 0 || y >= g.ny || x < 0 || x >= g.nx) return T(0);
  const int64_t o = z * g.plane + static_cast<int64_t>(y) * g.nx + x;
  const T c = u[o];
  T v = mul_rn(T(6), c);
  v -= z > 0 ? u[o - g.plane] : T(0);
  v -= z < g.lz - 1 ? u[o + g.plane] : T(0);
  v -= y > 0 ? u[o - g.nx] : T(0);
  v -= y < g.ny - 1 ? u[o + g.nx] : T(0);
  v -= x > 0 ? u[o - 1] : T(0);
  v -= x < g.nx - 1 ? u[o + 1] : T(0);
  return f[o] - v;
}

// One 4-tap restriction: s (0.75 (a + b) + 0.25 (lo + hi)), the plain order.
template <typename T>
__device__ __forceinline__ T taps(T s, T lo, T a, T b, T hi) {
  return mul_rn(s, mul_rn(T(0.75), a + b) + mul_rn(T(0.25), lo + hi));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smooth_pair_kernel(const T* __restrict__ u, const T* __restrict__ f, T* __restrict__ out,
                   Grid3 g, int ntx, int nty, int ntz, T w1, T w2) {
  constexpr int EX = kBX + 2, EY = kBY + 2, NE = EX * EY;
  __shared__ T ring[3][EY][EX];
  const int tid = threadIdx.x + threadIdx.y * kBX;
  for (int tz = blockIdx.z; tz < ntz; tz += gridDim.z) {
    for (int ty = blockIdx.y; ty < nty; ty += gridDim.y) {
      for (int tx = blockIdx.x; tx < ntx; tx += gridDim.x) {
        const int x0 = tx * kBX, y0 = ty * kBY;
        const int z0 = tz * kPairZC;
        const int z1 = min(z0 + kPairZC, g.lz);
        // u1 on planes z0-1 .. z1; plane zz lives in slot (zz - z0 + 1) % 3
        for (int zz = z0 - 1; zz <= z1; ++zz) {
          const int slot = (zz - z0 + 1) % 3;
          for (int e = tid; e < NE; e += kThreads) {
            const int ey = e / EX, ex = e - ey * EX;
            const int y = y0 - 1 + ey, x = x0 - 1 + ex;
            T v = T(0);   // the zero ghost, and anything outside the domain
            if (zz >= 0 && zz < g.lz && y >= 0 && y < g.ny && x >= 0 && x < g.nx) {
              const int64_t o = zz * g.plane + static_cast<int64_t>(y) * g.nx + x;
              const T c = u[o];
              T a = mul_rn(T(6), c);
              a -= zz > 0 ? u[o - g.plane] : T(0);
              a -= zz < g.lz - 1 ? u[o + g.plane] : T(0);
              a -= y > 0 ? u[o - g.nx] : T(0);
              a -= y < g.ny - 1 ? u[o + g.nx] : T(0);
              a -= x > 0 ? u[o - 1] : T(0);
              a -= x < g.nx - 1 ? u[o + 1] : T(0);
              v = c + mul_rn(w1, f[o] - a);
            }
            ring[slot][ey][ex] = v;
          }
          __syncthreads();
          // sweep 2 on plane zz - 1, from the ring's planes zz-2, zz-1, zz
          const int zc = zz - 1;
          const int x = x0 + static_cast<int>(threadIdx.x);
          const int y = y0 + static_cast<int>(threadIdx.y);
          if (zc >= z0 && x < g.nx && y < g.ny) {
            const int sb = (zc - z0) % 3, sc = (zc - z0 + 1) % 3, sa = (zc - z0 + 2) % 3;
            const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
            const T c = ring[sc][ly][lx];
            T a = mul_rn(T(6), c);
            a -= ring[sb][ly][lx];
            a -= ring[sa][ly][lx];
            a -= ring[sc][ly - 1][lx];
            a -= ring[sc][ly + 1][lx];
            a -= ring[sc][ly][lx - 1];
            a -= ring[sc][ly][lx + 1];
            const int64_t o = zc * g.plane + static_cast<int64_t>(y) * g.nx + x;
            out[o] = c + mul_rn(w2, f[o] - a);
          }
          __syncthreads();   // the next plane overwrites the oldest slot
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
residual_restrict_kernel(const T* __restrict__ u, const T* __restrict__ f,
                         T* __restrict__ out, Grid3 g, int ntx, int nty, int ntz, T s) {
  // a block makes a (kBY x kBX) tile of coarse points; its fine patch, with
  // the one-point ring the outer taps reach, is PY x PX
  constexpr int PX = 2 * kBX + 2, PY = 2 * kBY + 2, NP = PX * PY;
  constexpr int NPT = (NP + kThreads - 1) / kThreads;
  __shared__ T rz[PY][PX];    // z-restricted residual of one coarse plane
  __shared__ T ry[kBY][PX];   // ... then y-restricted
  const int tid = threadIdx.x + threadIdx.y * kBX;
  const int lzc = g.lz / 2, nyc = g.ny / 2, nxc = g.nx / 2;
  const int64_t cplane = static_cast<int64_t>(nyc) * nxc;
  for (int tz = blockIdx.z; tz < ntz; tz += gridDim.z) {
    for (int ty = blockIdx.y; ty < nty; ty += gridDim.y) {
      for (int tx = blockIdx.x; tx < ntx; tx += gridDim.x) {
        const int i0 = tx * kBX, j0 = ty * kBY;
        const int k0 = tz * kRestrictKC;
        const int k1 = min(k0 + kRestrictKC, lzc);
        // r at fine planes 2k-1 and 2k for each of this thread's patch points
        T rm[NPT], r0[NPT];
#pragma unroll
        for (int q = 0; q < NPT; ++q) {
          const int p = tid + q * kThreads;
          const int py = p / PX, px = p - py * PX;
          const int y = 2 * j0 - 1 + py, x = 2 * i0 - 1 + px;
          const bool in = p < NP;
          rm[q] = in ? residual_at(u, f, g, 2 * k0 - 1, y, x) : T(0);
          r0[q] = in ? residual_at(u, f, g, 2 * k0, y, x) : T(0);
        }
        for (int k = k0; k < k1; ++k) {
#pragma unroll
          for (int q = 0; q < NPT; ++q) {
            const int p = tid + q * kThreads;
            if (p < NP) {
              const int py = p / PX, px = p - py * PX;
              const int y = 2 * j0 - 1 + py, x = 2 * i0 - 1 + px;
              const T r1 = residual_at(u, f, g, 2 * k + 1, y, x);
              const T r2 = residual_at(u, f, g, 2 * k + 2, y, x);
              rz[py][px] = taps(s, rm[q], r0[q], r1, r2);
              rm[q] = r1;
              r0[q] = r2;
            }
          }
          __syncthreads();
          // y: coarse row jj takes patch rows 2jj .. 2jj+3 (fine 2j-1 .. 2j+2)
          for (int c = tid; c < kBY * PX; c += kThreads) {
            const int jj = c / PX, px = c - jj * PX;
            ry[jj][px] = taps(s, rz[2 * jj][px], rz[2 * jj + 1][px], rz[2 * jj + 2][px],
                              rz[2 * jj + 3][px]);
          }
          __syncthreads();
          // x: coarse column ii takes patch columns 2ii .. 2ii+3
          const int ii = threadIdx.x, jj = threadIdx.y;
          const int i = i0 + ii, j = j0 + jj;
          if (i < nxc && j < nyc) {
            out[k * cplane + static_cast<int64_t>(j) * nxc + i] =
                taps(s, ry[jj][2 * ii], ry[jj][2 * ii + 1], ry[jj][2 * ii + 2], ry[jj][2 * ii + 3]);
          }
          // rz is rewritten only after the next plane's residuals, and ry
          // only after the __syncthreads that follows them: no barrier here
        }
        __syncthreads();   // the next tile rewrites rz
      }
    }
  }
}

dim3 capped(int a, int b, int c) {
  // gridDim.y/z are limited to 65535; the kernels loop over what lies beyond
  return dim3(static_cast<unsigned>(a), static_cast<unsigned>(b < 65535 ? b : 65535),
              static_cast<unsigned>(c < 65535 ? c : 65535));
}

template <typename T>
int launch_smooth_pair(const void* u, const void* f, void* out, int lz, int ny, int nx,
                       double w1, double w2, void* stream) {
  const Grid3 g{lz, ny, nx, static_cast<int64_t>(ny) * nx};
  const int ntx = (nx - 1) / kBX + 1, nty = (ny - 1) / kBY + 1, ntz = (lz - 1) / kPairZC + 1;
  smooth_pair_kernel<T><<<capped(ntx, nty, ntz), dim3(kBX, kBY), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(f), static_cast<T*>(out), g,
      ntx, nty, ntz, static_cast<T>(w1), static_cast<T>(w2));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_residual_restrict(const void* u, const void* f, void* out, int lz, int ny, int nx,
                             double rscale, void* stream) {
  const Grid3 g{lz, ny, nx, static_cast<int64_t>(ny) * nx};
  const int ntx = (nx / 2 - 1) / kBX + 1, nty = (ny / 2 - 1) / kBY + 1;
  const int ntz = (lz / 2 - 1) / kRestrictKC + 1;
  residual_restrict_kernel<T><<<capped(ntx, nty, ntz), dim3(kBX, kBY), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(f), static_cast<T*>(out), g,
      ntx, nty, ntz, static_cast<T>(rscale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The CUDA runtime's text for an error code returned by the entry points below.
const char* mg3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out = S_w2(S_w1(u)); w1/w2 are the sweeps' omega / 6.  out must not alias u or f.
int mg3d_smooth_pair_f32(const void* u, const void* f, void* out, int lz, int ny, int nx,
                         double w1, double w2, void* stream) {
  return launch_smooth_pair<float>(u, f, out, lz, ny, nx, w1, w2, stream);
}

int mg3d_smooth_pair_f64(const void* u, const void* f, void* out, int lz, int ny, int nx,
                         double w1, double w2, void* stream) {
  return launch_smooth_pair<double>(u, f, out, lz, ny, nx, w1, w2, stream);
}

// out (lz/2, ny/2, nx/2) = restrict(f - A u); lz, ny, nx even (the caller checks).
int mg3d_residual_restrict_f32(const void* u, const void* f, void* out, int lz, int ny, int nx,
                               double rscale, void* stream) {
  return launch_residual_restrict<float>(u, f, out, lz, ny, nx, rscale, stream);
}

int mg3d_residual_restrict_f64(const void* u, const void* f, void* out, int lz, int ny, int nx,
                               double rscale, void* stream) {
  return launch_residual_restrict<double>(u, f, out, lz, ny, nx, rscale, stream);
}

}  // extern "C"
