// Multigrid V-cycle kernels that need two-deep z neighbourhoods, for Hopper
// (sm_90a), plain C entry points.
//
// What they replace (mpi_petsc4py_example_tpu/ops/pallas_stencil.py):
//   mg3d_smooth_pair_{f32,f64}       -> stencil3d_smooth_pair_pallas (:1251),
//                                       body _double_sweep_kernel (:1157)
//   mg3d_smooth_pair_bf16            -> the same TPU kernel at bfloat16 storage,
//                                       as the TPU V-cycle runs it (mg.py _smooth)
//   mg3d_residual_restrict_{f32,f64} -> stencil3d_residual_restrict_pallas (:1090),
//                                       body _resid_restrict3_kernel (:987); also
//                                       stencil3d_residual_zrestrict_pallas (:965),
//                                       whose z-only tier this kernel covers
//
// Both work on a single-slab z-slab u (lz, ny, nx), x fastest, with zero
// Dirichlet ghosts on every side (no halo planes: the V-cycle's local levels).
// Au below is the 7-point apply 6u - (6 neighbours) in the plain order.
//
// Bound on the H100: device memory.  smooth_pair reads u and f and writes u2
// (3 fine passes); residual_restrict reads u and f and writes 1/8 of a pass
// (2.125).  Both do ~20 flop per fine point, far under the fp32 rate, but at
// 3.35 TB/s an SM must finish about one fine point per clock, so the
// instructions per point bound the kernels next: the design keeps them few.
//
// Tiles (fp32 and fp64).  A block of 256 threads owns a 64 x 16 tile of fine
// points and one z-chunk, and marches up z.  Thread (lx, g) owns the column
// x0 + lx and the four rows y0 + 4g .. +3 of the tile: it keeps u on the
// planes below and at z, and its results on the planes below, in registers,
// so each point needs only its x and y neighbours from shared memory.  The
// tile's one-point ring (164 points, the x/y taps of the tile's edge) is
// computed one point a thread.  A 32 x 8 tile was measured in tuning runs on
// the H100: no faster on the coarse levels and slower from 64^3 up, so there
// is one tile.
//
// Staging.  Each block stages u and f in shared memory through a ring of
// plane windows, kAhead planes ahead of the plane in use, with cp.async; each
// element leaves device memory once per block (the windows' rings are read
// again by the neighbouring blocks, from L2).  A window covers x0-4 .. x0+67
// (bf16: x0-8 .. x0+71) and y0-2 .. y0+17 (bf16: y0+33): the two-point ring a
// double sweep needs, widened in x to 16-byte boundaries.  Two routes, chosen
// from the shape in the launcher:
//   * "vec16": nx a multiple of 16 bytes' worth of elements and u, f 16-byte
//     aligned (every level of the cycle; bf16 also needs out aligned): one
//     16-byte copy per chunk of a window row; a chunk lies wholly inside or
//     outside the plane (bf16: a chunk outside is a copy of no bytes,
//     zero-filled, so the staging never branches);
//   * "elem": any other shape, such as (17, 9, 33): one 4- or 8-byte copy per
//     element (bf16: a plain 2-byte load).
// Window positions outside the array are zeros, so the ring's x = -1 and
// x = nx columns are zeros, never the neighbouring row's end; the two routes
// fill the windows identically.
//
// smooth_pair: two damped-Jacobi sweeps, u2 = S_w2(S_w1(u)) with
// S_w(v) = v + w (f - A v).  At step z a block computes u1 on plane z over
// the tile and its ring (into a shared plane for the x/y taps, and into the
// owner's registers), then sweep 2 on plane z-1 from the u1 planes z-2 .. z
// it holds; f of plane z-1 comes from the owner's registers, so f is read
// once.  u1 outside the domain is exactly 0: it is not S_w1 of the
// zero-filled u, which is nonzero beside the boundary.  z-chunk (fp32,
// fp64): the longest of 8, 4, 2 planes that still gives kTargetBlocks blocks
// (pick_chunk).  In tuning runs on the H100, marches of 16 to 64 planes were
// slower at 512^3 than 8, and 4 slower again, although each chunk stages 4
// extra u planes; why is not measured.  The coarse levels take chunks of 2
// and keep their blocks (64^3: 128 blocks).  bf16: the longest of 128, ...,
// 2 planes for 256 blocks of its larger tile (512^3 marches 128, 256^3 32,
// 128^3 4, the coarser levels 2).
//
// residual_restrict: the coarse right-hand side restrict(f - A u) of shape
// (lz/2, ny/2, nx/2), per axis
//   c[i] = s (0.75 (r[2i] + r[2i+1]) + 0.25 (r[2i-1] + r[2i+2])),  s = RSCALE,
// with r = 0 outside the domain (r at fine index -1 or n is 0, not f - A u
// evaluated there).  The TPU does y/x as two MXU matmuls with the banded
// _tmat weights; here the four taps are computed directly, in the plain
// version's order: z first, then y, then x.  The fine tile is the 32 x 8
// coarse tile doubled; each thread keeps r at fine planes 2k-1,
// 2k, 2k+1 of its points in registers, and every second fine plane writes
// the z-restricted patch (tile and ring) to shared memory, from which the
// block restricts y and then x.  Neither the fine residual nor any
// intermediate goes to device memory.  Coarse z-chunk: the longest of 16, 8,
// ..., 1 coarse planes that gives kTargetBlocks blocks (512^3 and 256^3
// march 16, 128^3 4, the coarser levels 1).
//
// bfloat16 (smooth_pair only; the TPU V-cycle never runs residual_restrict at
// bfloat16, mg.py _mm_ok): smooth_pair_bf16_kernel, a kernel of its own.
// With half of fp32's bytes the pair must finish about two points an
// SM-clock, so it is designed for instructions a point:
//   * a thread owns a run of 4 x points (two bf16x2 words) on 2 rows of a
//     64 x 32 tile (256 threads); every staged run is one 8-byte shared load
//     lifted by moving bits (lo << 16, hi & 0xffff0000), an x neighbour one
//     32-bit word, the results rounded pairwise (__floats2bfloat162_rn) and
//     stored as 8-byte words;
//   * u1 lives in a bf16 frame (its values are rounded to bf16 where they
//     are made, so the frame is exact) in the window's columns, read in runs;
//   * the ring of u1 that sweep 2 reads is two rows of pairs and two columns
//     of points, no corner (128 tasks on the even threads: every warp takes
//     a share, and the barrier waits on no warp that alone took the ring);
//   * the staged copies ask L2 for whole 128-byte lines; a march of <= 4
//     planes (128^3 and coarser) stages 1 plane ahead, a longer one 2;
//   * one barrier a step (the frame read by sweep 2 is the one the step
//     before wrote), the steps unrolled by 3 so that the planes' registers
//     rotate without copies, the window slots kept as counters, and every
//     domain test a mask (v & all-ones or 0) instead of a branch.
// Each staged value is lifted to fp32 and both sweeps compute in fp32; u1 is
// rounded to bf16 once where it is made (frame and registers hold the rounded
// values) and u2 once at the store, so the pair equals two
// stencil7_smooth_bf16 sweeps bit for bit.  The TPU's _double_sweep_kernel
// (pallas_stencil.py:1157) computes in the storage dtype instead (six, u1 and
// u2 at :1174, :1208, :1217), every operation rounding to bf16; the port keeps
// the rounding of two row-3b sweeps, its check on the card.
// Tuning runs on the H100 (builds of this file with other values of the
// constants below, each checked bit for bit and timed; ms at 512^3 /
// 128^3).  The first design (16-plane chunks) took 0.3953 / 0.01178, against 0.5825 /
// 0.0146 for the fp32 tile staging bf16 that it replaced.  Tiles: 64 x 16 of
// 2 rows (128 threads) 0.3937 / 0.01285, of 1 row 0.5058 / 0.01223; 64 x 32
// of 1 row (512 threads) 0.5156 / 0.01451; 64 x 64 of 4 rows 0.9667 /
// 0.02170.  z-chunks at 512^3: 8 planes 0.4368, 32 0.3775, 64 0.3665, and
// with 3 planes ahead 128 0.3694, 256 0.3802 (128^3 keeps 4: a target of 128
// blocks, chunk 8, took 0.01268, one of 512 0.01527).  Staging 1 plane ahead
// (64-plane chunks) 0.3780 / 0.01106, 3 0.3658 / 0.01169, 4 spills.
// Registers: 2 blocks an SM (<= 128 registers) is the cap; 3 (80, spilling)
// 0.7359 / 0.01676, 1 (184) 0.4987 / 0.01494.  Then the slot counters in
// place of a modulo a step, 0.3606 / 0.01145, and the zero-filling copies and
// masks in place of branches, 0.3566 / 0.01104 (1 plane ahead there 0.3705 /
// 0.01057: faster at 128^3 only).  The L2::128B hint on the copies 0.3450 /
// 0.01106 (L2::256B 0.3531 / 0.01154); the ring on the even threads 0.3359 /
// 0.01076 (on threads 0-127 as before 0.3450, on every fourth thread
// 0.4059); 1 plane ahead in marches of <= 4 planes 0.3360 / 0.01045; then
// 128-plane chunks 0.3298 (64: 0.3360; 1, 3 or 4 planes ahead in the long
// marches 0.3567, 0.3415, 0.3439).  Below the run kernel's 76-81% of the
// bytes bound: see PERF.md.
//
// Arithmetic: products go through __fmul_rn/__dmul_rn so nvcc cannot contract
// them into FMAs, the six neighbours are subtracted in the plain version's
// order (z-1, z+1, y-1, y+1, x-1, x+1), and every operation rounds as the
// plain PyTorch version's separate operations do; a staged zero subtracts
// exactly as the plain version's zero fill.  So both kernels agree with their
// plain versions bit for bit.  The kernels launch on the caller's stream,
// allocate nothing and do not synchronise; each entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kTX = 64, kTY = 16;        // the fine tile a block owns
constexpr int kRows = 4;                 // tile rows a thread owns
constexpr int kAhead = 2;                // planes staged ahead of the one in use
constexpr int kTargetBlocks = 256;      // about two blocks for each of the 132 SMs

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename S>
__device__ __forceinline__ S zero_of() { return S(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __ushort_as_bfloat16(0); }

struct Grid3 {
  int lz, ny, nx;
  int64_t plane;
};

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N)
                 : "memory");
  }
}

// a 16-byte cp.async that reads n (16 or 0) bytes and zero-fills the rest,
// asking L2 to fetch the whole 128-byte line (a window row spans 160 bytes
// from 16 before a line)
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The geometry of the kTX x kTY tile of type T (fp32 or fp64): its staged
// window (WX x WY, corner (y0-2, x0-PADX)) and its one-point-ring frame (EX x
// EY, corner (y0-1, x0-1)).
template <typename T>
struct Tile {
  static constexpr int kThreads = kTX * kTY / kRows;
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));     // elements a 16-byte chunk
  static constexpr int PADX = 4;
  static constexpr int WX = kTX + 2 * PADX, WY = kTY + 4, NW = WX * WY;
  static constexpr int EX = kTX + 2, EY = kTY + 2, NE = EX * EY;
  static constexpr int NRING = 2 * EX + 2 * kTY;
  static constexpr int RPT = (NRING + kThreads - 1) / kThreads;   // ring points a thread
  static constexpr int NCH = NW / kV;                             // chunks a window
  static constexpr int CPT = (NCH + kThreads - 1) / kThreads;     // chunks a thread
  // frame (ey, ex) -> window offset
  static __device__ __forceinline__ int win(int ey, int ex) {
    return (ey + 1) * WX + ex + PADX - 1;
  }
  // the ring's e-th point in the frame: rows 0 and EY-1, then columns 0 and EX-1
  static __device__ __forceinline__ void ring(int e, int& ey, int& ex) {
    if (e < 2 * EX) {
      ey = e < EX ? 0 : EY - 1;
      ex = e < EX ? e : e - EX;
    } else {
      const int k = e - 2 * EX;
      ey = 1 + (k >> 1);
      ex = (k & 1) ? EX - 1 : 0;
    }
  }
};

// Copies plane z of an array into a window of the geometry G (Tile<T>, or
// PairTile for bf16); zeros where the window leaves the array.  kVec: the
// 16-byte route, its chunks decoded once per tile.
template <typename T, bool kVec, typename G = Tile<T>>
struct Stager {
  static constexpr int N = kVec ? G::CPT : 1;
  int soff[N];       // window offset of the chunk, -1 for none
  int64_t goff[N];   // in-plane offset of its first element
  bool inside[N];
  int y0, x0;

  __device__ __forceinline__ void init(const Grid3& g, int ty0, int tx0) {
    y0 = ty0;
    x0 = tx0;
    if constexpr (kVec) {
      constexpr int CX = G::WX / G::kV;   // chunks a window row
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int c = threadIdx.x + q * G::kThreads;
        const int row = c / CX, cx = c - row * CX;
        const int y = y0 - 2 + row, x = x0 - G::PADX + cx * G::kV;
        soff[q] = c < G::NCH ? c * G::kV : -1;
        inside[q] = y >= 0 && y < g.ny && x >= 0 && x < g.nx;
        goff[q] = static_cast<int64_t>(y) * g.nx + x;
      }
    }
  }

  __device__ __forceinline__ void plane(T* dst, const T* __restrict__ src, const Grid3& g,
                                        int z) const {
    const bool zin = z >= 0 && z < g.lz;
    const T* base = src + (zin ? z * g.plane : 0);
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        if (soff[q] < 0) continue;
        if (zin && inside[q]) {
          cp_async<16>(dst + soff[q], base + goff[q]);
        } else {
          *reinterpret_cast<uint4*>(dst + soff[q]) = make_uint4(0, 0, 0, 0);
        }
      }
    } else {
      for (int e = threadIdx.x; e < G::NW; e += G::kThreads) {
        const int ey = e / G::WX, ex = e - ey * G::WX;
        const int y = y0 - 2 + ey, x = x0 - G::PADX + ex;
        if (zin && y >= 0 && y < g.ny && x >= 0 && x < g.nx) {
          const T* s = base + static_cast<int64_t>(y) * g.nx + x;
          if constexpr (sizeof(T) >= 4) {
            cp_async<sizeof(T)>(dst + e, s);
          } else {
            dst[e] = *s;
          }
        } else {
          dst[e] = zero_of<T>();
        }
      }
    }
  }
};

// ... and the vec16 route's plane with no branch and no store: a chunk
// outside the array is a copy of no bytes, zero-filled (the bf16 pair's)
template <typename T, bool kVec, typename G>
__device__ __forceinline__ void stage_zfill(const Stager<T, kVec, G>& st, T* dst,
                                            const T* __restrict__ src, const Grid3& g, int z) {
  static_assert(kVec, "the 16-byte route only");
  const bool zin = z >= 0 && z < g.lz;
  const T* base = src + (zin ? z * g.plane : 0);
#pragma unroll
  for (int q = 0; q < G::CPT; ++q) {
    if (st.soff[q] < 0) continue;
    const bool ok = zin && st.inside[q];
    cp_async_zfill(dst + st.soff[q], ok ? base + st.goff[q] : src, ok ? 16 : 0);
  }
}

// 6 c - (z-1) - (z+1) - (y-1) - (y+1) - (x-1) - (x+1) at offset o of a window of
// row pitch W, from the planes below (m), at (c) and above (p), in type T.
template <typename T, int W>
__device__ __forceinline__ T apply_at(const T* m, const T* c, const T* p, int o) {
  T a = mul_rn(T(6), c[o]);
  a -= m[o];
  a -= p[o];
  a -= c[o - W];
  a -= c[o + W];
  a -= c[o - 1];
  a -= c[o + 1];
  return a;
}

// The same for a thread's four rows with the z taps and the centre column in
// registers (zm, zp, cc) and the rest read from the centre plane c at window
// offset o of row 0: a[r] = A at row r.
template <typename T, int W>
__device__ __forceinline__ void apply_rows(const T (&zm)[kRows], const T (&cc)[kRows],
                                           const T (&zp)[kRows], const T* c, int o,
                                           T (&a)[kRows]) {
  const T ym = c[o - W], yp = c[o + kRows * W];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    T v = mul_rn(T(6), cc[r]);
    v -= zm[r];
    v -= zp[r];
    v -= r == 0 ? ym : cc[r - 1];
    v -= r == kRows - 1 ? yp : cc[r + 1];
    v -= c[o + r * W - 1];
    v -= c[o + r * W + 1];
    a[r] = v;
  }
}

// One 4-tap restriction: s (0.75 (a + b) + 0.25 (lo + hi)), the plain order.
template <typename T>
__device__ __forceinline__ T taps(T s, T lo, T a, T b, T hi) {
  return mul_rn(s, mul_rn(T(0.75), a + b) + mul_rn(T(0.25), lo + hi));
}

template <typename T>
struct PairSmem {
  using G = Tile<T>;
  static constexpr int NU = kAhead + 3, NF = kAhead + 1;   // u and f windows
  static constexpr size_t kBytes = sizeof(T) * ((NU + NF) * G::NW + 2 * G::NE);
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(Tile<T>::kThreads)
smooth_pair_kernel(const T* __restrict__ u, const T* __restrict__ f, T* __restrict__ out,
                   Grid3 g, int zc, int ntx, int nty, int ntz, T w1, T w2) {
  using G = Tile<T>;
  using S = PairSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const su = reinterpret_cast<T*>(smem);
  T* const sf = su + S::NU * G::NW;
  T* const s1 = sf + S::NF * G::NW;   // u1 on planes z-1 and z, the frame
  const int lx = threadIdx.x % kTX, ly = (threadIdx.x / kTX) * kRows;
  const int wo = G::win(ly + 1, lx + 1);   // row 0 of this thread in a window
  const int eo = (ly + 1) * G::EX + lx + 1;   // ... and in the frame
  for (int tz = blockIdx.z; tz < ntz; tz += gridDim.z) {
    for (int ty = blockIdx.y; ty < nty; ty += gridDim.y) {
      for (int tx = blockIdx.x; tx < ntx; tx += gridDim.x) {
        const int x0 = tx * kTX, y0 = ty * kTY;
        const int z0 = tz * zc, z1 = min(z0 + zc, g.lz);
        Stager<T, kVec> stager;
        stager.init(g, y0, x0);
        // plane p of u, f, u1 lives in these slots (p >= z0-2, z0-1, z0-1)
        auto us = [&](int p) { return su + ((p - z0 + 2) % S::NU) * G::NW; };
        auto fs = [&](int p) { return sf + ((p - z0 + 1) % S::NF) * G::NW; };
        auto u1s = [&](int p) { return s1 + ((p - z0 + 1) & 1) * G::NE; };
        // u on planes z0-2 .. z1+1 and f on z0-1 .. z1; step z needs u up to
        // z+1 and f at z, and stages u at z+1+kAhead and f at z+kAhead
        auto stage = [&](int pu, int pf) {
          if (pu <= z1 + 1) stager.plane(us(pu), u, g, pu);
          if (pf <= z1) stager.plane(fs(pf), f, g, pf);
        };
        stager.plane(us(z0 - 2), u, g, z0 - 2);
        stager.plane(us(z0 - 1), u, g, z0 - 1);
        stage(z0, z0 - 1);
        cp_commit();
#pragma unroll
        for (int d = 1; d < kAhead; ++d) {
          stage(z0 + d, z0 - 1 + d);
          cp_commit();
        }
        const int x = x0 + lx;
        bool yin[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) yin[r] = x < g.nx && y0 + ly + r < g.ny;
        // registers: u at z-1 and z; u1 at z-2, z-1, z; f at z-1 and z
        T um[kRows], uc[kRows], u1m[kRows], u1c[kRows], u1p[kRows], fm[kRows], fc[kRows];
        for (int zz = z0 - 1; zz <= z1; ++zz) {
          cp_wait<kAhead - 1>();
          __syncthreads();   // this step's planes are in; last step's readers are done
          stage(zz + 1 + kAhead, zz + kAhead);
          cp_commit();
          const T *Um = us(zz - 1), *Uc = us(zz), *Up = us(zz + 1), *Fc = fs(zz);
          T* const U1 = u1s(zz);
          const bool zin = zz >= 0 && zz < g.lz;
          // sweep 1: u1 on plane zz, this thread's rows
          if (zz == z0 - 1) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              um[r] = Um[wo + r * G::WX];
              uc[r] = Uc[wo + r * G::WX];
            }
          }
          T up[kRows], a[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) up[r] = Up[wo + r * G::WX];
          apply_rows<T, G::WX>(um, uc, up, Uc, wo, a);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            fm[r] = fc[r];
            fc[r] = Fc[wo + r * G::WX];
            u1m[r] = u1c[r];
            u1c[r] = u1p[r];
            u1p[r] = zin && yin[r] ? uc[r] + mul_rn(w1, fc[r] - a[r]) : T(0);
            U1[eo + r * G::EX] = u1p[r];
            um[r] = uc[r];
            uc[r] = up[r];
          }
          // ... and on the tile's ring (the zero ghost outside the domain)
#pragma unroll
          for (int q = 0; q < G::RPT; ++q) {
            const int e = threadIdx.x + q * G::kThreads;
            if (e < G::NRING) {
              int ey, ex;
              G::ring(e, ey, ex);
              const int y = y0 - 1 + ey, xr = x0 - 1 + ex;
              T v = T(0);
              if (zin && y >= 0 && y < g.ny && xr >= 0 && xr < g.nx) {
                const int o = G::win(ey, ex);
                v = Uc[o] + mul_rn(w1, Fc[o] - apply_at<T, G::WX>(Um, Uc, Up, o));
              }
              U1[ey * G::EX + ex] = v;
            }
          }
          __syncthreads();
          // sweep 2 on plane zz - 1, z taps from registers
          const int zo = zz - 1;
          if (zo >= z0) {
            apply_rows<T, G::EX>(u1m, u1c, u1p, u1s(zo), eo, a);
            T* const dst = out + zo * g.plane + static_cast<int64_t>(y0 + ly) * g.nx + x;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (yin[r]) {
                dst[static_cast<int64_t>(r) * g.nx] = u1c[r] + mul_rn(w2, fm[r] - a[r]);
              }
            }
          }
        }
        cp_wait<0>();
        __syncthreads();   // the next tile restages every slot
      }
    }
  }
}

// ---- the bfloat16 double sweep (row 6b), a kernel of its own ---------------
// (the values below were chosen in tuning runs on the H100; the header
// records what was tried)

using bf16 = __nv_bfloat16;

constexpr int kPairTX = 64, kPairTY = 32;   // the bf16 tile
constexpr int kPairRows = 2;                // tile rows a thread owns
constexpr int kPairAhead = 2;               // planes staged ahead in long marches
constexpr int kPairChunk = 128;             // the longest z-chunk
// a march of at most this many planes (128^3 and the coarser levels) stages
// one plane ahead: its prologue, not the loads' latency, is what it waits on
constexpr int kShortMarch = 4;

// The bf16 tile: 64 x 32 points, a thread owning a run of kPV = 4 x points
// (two bf16x2 words) on R = 2 rows.  Its window (WX x WY, corner (y0-2,
// x0-8): the two-point ring widened in x to 16-byte chunks) and its u1 frame
// (WX x TY+2, corner (y0-1, x0-8): the one-point ring, in the window's
// columns so that a run's words stay aligned).  The ring of u1 that sweep 2
// reads is two rows (TX/2 pairs each) and two columns (TY points each), no
// corner.  A: the planes staged ahead of the one in use.
template <int A>
struct PairTile {
  static constexpr int TX = kPairTX, TY = kPairTY, R = kPairRows, kPV = 4;
  static constexpr int kCols = TX / kPV;                          // threads across
  static constexpr int kThreads = kCols * (TY / R);
  static constexpr int kV = 8, PADX = 8;                          // bf16 a 16-byte chunk
  static constexpr int WX = TX + 2 * PADX, WY = TY + 4, NW = WX * WY;
  static constexpr int NE = WX * (TY + 2);
  static constexpr int NCH = NW / kV, CPT = (NCH + kThreads - 1) / kThreads;
  static constexpr int NPAIR = TX;                                // ring-row pairs,
  static constexpr int NRING = NPAIR + 2 * TY;                    // then column points
  static constexpr int NU = A + 3, NF = A + 1;
  static constexpr size_t kBytes = sizeof(bf16) * ((NU + NF) * NW + 2 * NE);
};

// bf16 lifted to fp32 by moving its bits up (exactly __bfloat162float), and
// two fp32 rounded to nearest even into one bf16x2 word, the first low
__device__ __forceinline__ float lo16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned r;
  memcpy(&r, &h, sizeof(r));
  return r;
}

// the run of 4 at s (8-byte aligned), lifted
__device__ __forceinline__ void lift4(const bf16* s, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(s);
  v[0] = lo16(w.x);
  v[1] = hi16(w.x);
  v[2] = lo16(w.y);
  v[3] = hi16(w.y);
}

// the pair at s (4-byte aligned), lifted
__device__ __forceinline__ void lift2(const bf16* s, float (&v)[2]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(s);
  v[0] = lo16(w);
  v[1] = hi16(w);
}

// the point before s and the point at s (s 4-byte aligned), one word each
__device__ __forceinline__ float before(const bf16* s) {
  return hi16(reinterpret_cast<const unsigned*>(s)[-1]);
}
__device__ __forceinline__ float at(const bf16* s) {
  return lo16(*reinterpret_cast<const unsigned*>(s));
}

// v where m is all ones, +0 where it is 0: a select that never branches
__device__ __forceinline__ float masked(float v, unsigned m) {
  return __uint_as_float(__float_as_uint(v) & m);
}

// 6 c - (z-1) - (z+1) - (y-1) - (y+1) - (x-1) - (x+1), the plain order, fp32
__device__ __forceinline__ float apply7(float c, float zm, float zp, float ym, float yp, float xm,
                                        float xp) {
  float a = __fmul_rn(6.0f, c);
  a -= zm;
  a -= zp;
  a -= ym;
  a -= yp;
  a -= xm;
  a -= xp;
  return a;
}

// u1 of a ring pair (N = 2, o even) or a ring point (N = 1) at window offset
// o into frame offset e, from the staged planes Um, Uc, Up and f's plane Fc;
// 0 outside the domain.  The points lie at row y, columns x .. x + N - 1.
template <int N, int WX>
__device__ __forceinline__ void ring_u1(const bf16* Um, const bf16* Uc, const bf16* Up,
                                        const bf16* Fc, bf16* U1, int o, int e, bool zin, int y,
                                        int x, const Grid3& g, float w1) {
  float c[N], zm[N], zp[N], ym[N], yp[N], fv[N], v[N];
  float xm, xp;
  if constexpr (N == 2) {
    lift2(Uc + o, c);
    lift2(Um + o, zm);
    lift2(Up + o, zp);
    lift2(Uc + o - WX, ym);
    lift2(Uc + o + WX, yp);
    lift2(Fc + o, fv);
    xm = before(Uc + o);
    xp = at(Uc + o + 2);
  } else {
    c[0] = __bfloat162float(Uc[o]);
    zm[0] = __bfloat162float(Um[o]);
    zp[0] = __bfloat162float(Up[o]);
    ym[0] = __bfloat162float(Uc[o - WX]);
    yp[0] = __bfloat162float(Uc[o + WX]);
    fv[0] = __bfloat162float(Fc[o]);
    xm = __bfloat162float(Uc[o - 1]);
    xp = __bfloat162float(Uc[o + 1]);
  }
  const bool yok = zin && y >= 0 && y < g.ny;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float a = apply7(c[i], zm[i], zp[i], ym[i], yp[i], i == 0 ? xm : c[i - 1],
                           i == N - 1 ? xp : c[i + 1]);
    const bool in = yok && x + i >= 0 && x + i < g.nx;
    v[i] = masked(c[i] + __fmul_rn(w1, fv[i] - a), in ? 0xffffffffu : 0u);
  }
  if constexpr (N == 2) {
    *reinterpret_cast<unsigned*>(U1 + e) = pack2(v[0], v[1]);
  } else {
    U1[e] = __float2bfloat16_rn(v[0]);
  }
}

// A thread's results on one row: 4 points at d, m[i] nonzero where point i
// lies in the array (the vec16 route: all or none, d 8-byte aligned)
template <bool kVec>
__device__ __forceinline__ void store4(bf16* d, const float (&v)[4], const unsigned (&m)[4]) {
  if constexpr (kVec) {
    if (m[0]) *reinterpret_cast<uint2*>(d) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m[i]) d[i] = __float2bfloat16_rn(v[i]);
    }
  }
}

// The pair with bf16 storage and fp32 sweeps.  Thread (tc, tr) owns the run
// x0 + 4 tc .. +3 on rows y0 + R tr .. +R-1.  At step z it computes u1 on
// plane z (its runs, then its share of the ring) into the frame of plane z
// and its registers, then u2 on plane z-1 from the frame of plane z-1 and the
// u1 of planes z-2 .. z in its registers.  One barrier a step: a frame is
// rewritten the step after it was last read, a window slot kAhead + 3 (u) or
// kAhead + 1 (f) steps after it was first read.  The steps are unrolled by 3
// so that the planes' registers rotate without copies: plane p of u, u1 and
// f lives in slot (p - z0 + 1) % 3 of U, U1 and F.
// (2 blocks an SM: at most 128 registers a thread)
template <int A, bool kVec>
__global__ void __launch_bounds__(PairTile<A>::kThreads, 2)
smooth_pair_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f,
                        bf16* __restrict__ out, Grid3 g, int zc, int ntx, int nty, int ntz,
                        float w1, float w2) {
  using G = PairTile<A>;
  constexpr int TY = G::TY, R = G::R, WX = G::WX, V = G::kPV;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const su = reinterpret_cast<bf16*>(smem);
  bf16* const sf = su + G::NU * G::NW;
  bf16* const s1 = sf + G::NF * G::NW;   // u1 on planes z-1 and z, the frames
  const int lx = (threadIdx.x % G::kCols) * V, ly = (threadIdx.x / G::kCols) * R;
  const int wo = (ly + 2) * WX + G::PADX + lx;   // this thread's row 0 in a window
  const int eo = (ly + 1) * WX + G::PADX + lx;   // ... and in a frame
  for (int tz = blockIdx.z; tz < ntz; tz += gridDim.z) {
    for (int ty = blockIdx.y; ty < nty; ty += gridDim.y) {
      for (int tx = blockIdx.x; tx < ntx; tx += gridDim.x) {
        const int x0 = tx * G::TX, y0 = ty * TY;
        const int z0 = tz * zc, z1 = min(z0 + zc, g.lz);
        Stager<bf16, kVec, G> stager;
        stager.init(g, y0, x0);
        // plane p of u lives in window slot (p - z0 + 2) % NU, of f in
        // (p - z0 + 1) % NF, of u1 in frame (p - z0 + 1) % 2; a step keeps
        // the slots of u at zz - 1 (ku) and of f at zz (kf) as counters
        auto u1s = [&](int p) { return s1 + ((p - z0 + 1) & 1) * G::NE; };
        auto plane = [&](bf16* dst, const bf16* src, int p) {
          if constexpr (kVec) {
            stage_zfill(stager, dst, src, g, p);
          } else {
            stager.plane(dst, src, g, p);
          }
        };
        auto stage = [&](int pu, int ku, int pf, int kf) {
          if (pu <= z1 + 1) plane(su + ku * G::NW, u, pu);
          if (pf <= z1) plane(sf + kf * G::NW, f, pf);
        };
        plane(su, u, z0 - 2);
        plane(su + G::NW, u, z0 - 1);
#pragma unroll
        for (int d = 0; d < A; ++d) {
          stage(z0 + d, 2 + d, z0 - 1 + d, d);
          cp_commit();
        }
        int ku = 0, kf = 0;
        const int x = x0 + lx;
        // all ones where point x + i lies in the array; yin[r]: row r does
        unsigned xmask[V];
#pragma unroll
        for (int i = 0; i < V; ++i) xmask[i] = x + i < g.nx ? 0xffffffffu : 0u;
        bool yin[R];
#pragma unroll
        for (int r = 0; r < R; ++r) yin[r] = y0 + ly + r < g.ny;
        float U[3][R][V], U1[3][R][V], F[3][R][V];
        for (int zb = z0 - 1; zb <= z1; zb += 3) {
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const int zz = zb + s;
            if (zz > z1) break;
            // the slots of planes zz - 1, zz and zz + 1 (u1: zz - 2, zz - 1, zz)
            const int sm = (s + 2) % 3, sc = s, sp = (s + 1) % 3;
            cp_wait<A - 1>();
            __syncthreads();   // this step's planes are in; last step's readers are done
            // u at zz + 1 + kAhead takes the slot of zz - 2 (NU = kAhead + 3),
            // f at zz + kAhead the slot of zz - 1 (NF = kAhead + 1)
            const int ku1 = ku + 1 == G::NU ? 0 : ku + 1, ku2 = ku1 + 1 == G::NU ? 0 : ku1 + 1;
            stage(zz + 1 + A, ku == 0 ? G::NU - 1 : ku - 1, zz + A,
                  kf == 0 ? G::NF - 1 : kf - 1);
            cp_commit();
            const bf16 *Um = su + ku * G::NW, *Uc = su + ku1 * G::NW, *Up = su + ku2 * G::NW;
            const bf16* const Fc = sf + kf * G::NW;
            ku = ku1;
            kf = kf + 1 == G::NF ? 0 : kf + 1;
            bf16* const E = u1s(zz);
            const bool zin = zz >= 0 && zz < g.lz;
            // sweep 1: u1 on plane zz, this thread's runs
            if (s == 0 && zz == z0 - 1) {
#pragma unroll
              for (int r = 0; r < R; ++r) {
                lift4(Um + wo + r * WX, U[sm][r]);
                lift4(Uc + wo + r * WX, U[sc][r]);
              }
            }
            float ym[V], yp[V];
            lift4(Uc + wo - WX, ym);
            lift4(Uc + wo + R * WX, yp);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              lift4(Up + wo + r * WX, U[sp][r]);
              lift4(Fc + wo + r * WX, F[sc][r]);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float(&c)[V] = U[sc][r];
              const float xm = before(Uc + wo + r * WX), xp = at(Uc + wo + r * WX + V);
              // all ones where the point lies in the domain: computed
              // everywhere and masked, so that no point branches
              const unsigned rin = zin && yin[r] ? 0xffffffffu : 0u;
              float v[V];
#pragma unroll
              for (int i = 0; i < V; ++i) {
                const float a = apply7(c[i], U[sm][r][i], U[sp][r][i],
                                       r == 0 ? ym[i] : U[sc][r - 1][i],
                                       r == R - 1 ? yp[i] : U[sc][r + 1][i],
                                       i == 0 ? xm : c[i - 1], i == V - 1 ? xp : c[i + 1]);
                v[i] = masked(c[i] + __fmul_rn(w1, F[sc][r][i] - a), rin & xmask[i]);
              }
              // rounded once; the registers keep the rounded values
              const uint2 w = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
              *reinterpret_cast<uint2*>(E + eo + r * WX) = w;
              U1[sc][r][0] = lo16(w.x);
              U1[sc][r][1] = hi16(w.x);
              U1[sc][r][2] = lo16(w.y);
              U1[sc][r][3] = hi16(w.y);
            }
            // ... and the ring: pairs of its two rows, then points of its columns
            // (on the even threads, so that every warp takes its share)
            for (int e = threadIdx.x & 1 ? G::NRING : threadIdx.x / 2; e < G::NRING;
                 e += G::kThreads / 2) {
              int fy, ex;
              if (e < G::NPAIR) {
                const bool top = e < G::TX / 2;
                fy = top ? 0 : TY + 1;
                ex = 2 * (top ? e : e - G::TX / 2);
              } else {
                const int k = e - G::NPAIR;
                fy = 1 + (k >> 1);
                ex = (k & 1) ? G::TX : -1;
              }
              const int o = (fy + 1) * WX + G::PADX + ex, oe = fy * WX + G::PADX + ex;
              if (e < G::NPAIR) {
                ring_u1<2, WX>(Um, Uc, Up, Fc, E, o, oe, zin, y0 - 1 + fy, x0 + ex, g, w1);
              } else {
                ring_u1<1, WX>(Um, Uc, Up, Fc, E, o, oe, zin, y0 - 1 + fy, x0 + ex, g, w1);
              }
            }
            // sweep 2 on plane zz - 1 from its frame, z taps from registers
            const int zo = zz - 1;
            if (zo >= z0) {
              const bf16* const D = u1s(zo);
              float dm[V], dp[V];
              lift4(D + eo - WX, dm);
              lift4(D + eo + R * WX, dp);
              bf16* const dst = out + zo * g.plane + static_cast<int64_t>(y0 + ly) * g.nx + x;
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float(&c)[V] = U1[sm][r];
                const float xm = before(D + eo + r * WX), xp = at(D + eo + r * WX + V);
                float v[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                  const float a = apply7(c[i], U1[sp][r][i], U1[sc][r][i],
                                         r == 0 ? dm[i] : U1[sm][r - 1][i],
                                         r == R - 1 ? dp[i] : U1[sm][r + 1][i],
                                         i == 0 ? xm : c[i - 1], i == V - 1 ? xp : c[i + 1]);
                  v[i] = c[i] + __fmul_rn(w2, F[sm][r][i] - a);
                }
                if (yin[r]) store4<kVec>(dst + static_cast<int64_t>(r) * g.nx, v, xmask);
              }
            }
          }
        }
        cp_wait<0>();
        __syncthreads();   // the next tile restages every slot
      }
    }
  }
}

template <typename T>
struct RestrictSmem {
  using G = Tile<T>;
  static constexpr int NU = kAhead + 3, NF = kAhead + 1;   // u and f windows
  static constexpr size_t kBytes = sizeof(T) * ((NU + NF) * G::NW + G::NE + (kTY / 2) * G::EX);
};

// The fine tile is kTX x kTY, twice the coarse one.
template <typename T, bool kVec>
__global__ void __launch_bounds__(Tile<T>::kThreads)
residual_restrict_kernel(const T* __restrict__ u, const T* __restrict__ f, T* __restrict__ out,
                         Grid3 g, int kc, int ntx, int nty, int ntz, T s) {
  using G = Tile<T>;
  using S = RestrictSmem<T>;
  constexpr int CX = kTX / 2, CY = kTY / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const su = reinterpret_cast<T*>(smem);
  T* const sf = su + S::NU * G::NW;
  T* const rz = sf + S::NF * G::NW;   // z-restricted residual of a coarse plane, the frame
  T* const ry = rz + G::NE;           // ... then y-restricted, CY x EX
  const int lx = threadIdx.x % kTX, ly = (threadIdx.x / kTX) * kRows;
  const int wo = G::win(ly + 1, lx + 1);
  const int eo = (ly + 1) * G::EX + lx + 1;
  const int lzc = g.lz / 2, nyc = g.ny / 2, nxc = g.nx / 2;
  const int64_t cplane = static_cast<int64_t>(nyc) * nxc;
  for (int tz = blockIdx.z; tz < ntz; tz += gridDim.z) {
    for (int ty = blockIdx.y; ty < nty; ty += gridDim.y) {
      for (int tx = blockIdx.x; tx < ntx; tx += gridDim.x) {
        const int i0 = tx * CX, j0 = ty * CY;
        const int x0 = 2 * i0, y0 = 2 * j0;
        const int k0 = tz * kc, k1 = min(k0 + kc, lzc);
        // r on fine planes p0 .. p1, u on p0-1 .. p1+1, f on p0 .. p1
        const int p0 = 2 * k0 - 1, p1 = 2 * k1;
        Stager<T, kVec> stager;
        stager.init(g, y0, x0);
        auto us = [&](int p) { return su + ((p - p0 + 1) % S::NU) * G::NW; };
        auto fs = [&](int p) { return sf + ((p - p0) % S::NF) * G::NW; };
        auto stage = [&](int pu, int pf) {
          if (pu <= p1 + 1) stager.plane(us(pu), u, g, pu);
          if (pf <= p1) stager.plane(fs(pf), f, g, pf);
        };
        stager.plane(us(p0 - 1), u, g, p0 - 1);
        stager.plane(us(p0), u, g, p0);
        stage(p0 + 1, p0);
        cp_commit();
#pragma unroll
        for (int d = 1; d < kAhead; ++d) {
          stage(p0 + 1 + d, p0 + d);
          cp_commit();
        }
        const int x = x0 + lx;
        bool yin[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) yin[r] = x < g.nx && y0 + ly + r < g.ny;
        // u at p-1 and p; r at fine planes 2k-1, 2k, 2k+1 of this thread's
        // rows and of its ring points
        T um[kRows], uc[kRows];
        T rm[kRows + G::RPT], r0[kRows + G::RPT], r1[kRows + G::RPT];
        for (int p = p0; p <= p1; ++p) {
          cp_wait<kAhead - 1>();
          __syncthreads();
          stage(p + 1 + kAhead, p + kAhead);
          cp_commit();
          const T *Um = us(p - 1), *Uc = us(p), *Up = us(p + 1), *Fc = fs(p);
          const bool zin = p >= 0 && p < g.lz;
          if (p == p0) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              um[r] = Um[wo + r * G::WX];
              uc[r] = Uc[wo + r * G::WX];
            }
          }
          T up[kRows], a[kRows], rn[kRows + G::RPT];
#pragma unroll
          for (int r = 0; r < kRows; ++r) up[r] = Up[wo + r * G::WX];
          apply_rows<T, G::WX>(um, uc, up, Uc, wo, a);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            rn[r] = zin && yin[r] ? Fc[wo + r * G::WX] - a[r] : T(0);
            um[r] = uc[r];
            uc[r] = up[r];
          }
#pragma unroll
          for (int q = 0; q < G::RPT; ++q) {
            const int e = threadIdx.x + q * G::kThreads;
            T v = T(0);   // r is 0 outside the domain
            if (e < G::NRING) {
              int ey, ex;
              G::ring(e, ey, ex);
              const int y = y0 - 1 + ey, xr = x0 - 1 + ex;
              if (zin && y >= 0 && y < g.ny && xr >= 0 && xr < g.nx) {
                const int o = G::win(ey, ex);
                v = Fc[o] - apply_at<T, G::WX>(Um, Uc, Up, o);
              }
            }
            rn[kRows + q] = v;
          }
          const int t = p - p0;
          if (t < 3 || t % 2 == 0) {
            // fine planes 2k-1, 2k and 2k+1 wait for 2k+2
#pragma unroll
            for (int q = 0; q < kRows + G::RPT; ++q) {
              if (t == 0) rm[q] = rn[q];
              else if (t == 1) r0[q] = rn[q];
              else r1[q] = rn[q];
            }
            continue;
          }
          // z: coarse plane k from fine 2k-1 .. 2k+2
#pragma unroll
          for (int q = 0; q < kRows + G::RPT; ++q) {
            const T c = taps(s, rm[q], r0[q], r1[q], rn[q]);
            rm[q] = r1[q];
            r0[q] = rn[q];
            if (q < kRows) {
              rz[eo + q * G::EX] = c;
            } else {
              const int e = threadIdx.x + (q - kRows) * G::kThreads;
              if (e < G::NRING) {
                int ey, ex;
                G::ring(e, ey, ex);
                rz[ey * G::EX + ex] = c;
              }
            }
          }
          __syncthreads();
          // y: coarse row jj takes frame rows 2jj .. 2jj+3 (fine 2j-1 .. 2j+2)
          for (int c = threadIdx.x; c < CY * G::EX; c += G::kThreads) {
            const int jj = c / G::EX, px = c - jj * G::EX;
            const T* col = rz + 2 * jj * G::EX + px;
            ry[c] = taps(s, col[0], col[G::EX], col[2 * G::EX], col[3 * G::EX]);
          }
          __syncthreads();
          // x: coarse column ii takes frame columns 2ii .. 2ii+3
          const int k = k0 + (t - 3) / 2;
          for (int c = threadIdx.x; c < CY * CX; c += G::kThreads) {
            const int jj = c / CX, ii = c - jj * CX;
            const int i = i0 + ii, j = j0 + jj;
            if (i < nxc && j < nyc) {
              const T* row = ry + jj * G::EX + 2 * ii;
              out[k * cplane + static_cast<int64_t>(j) * nxc + i] =
                  taps(s, row[0], row[1], row[2], row[3]);
            }
          }
          // rz is rewritten two fine planes on, ry after the y pass that
          // follows: both after the next step's barrier
        }
        cp_wait<0>();
        __syncthreads();   // the next tile restages every slot
      }
    }
  }
}

dim3 capped(int a, int b, int c) {
  // gridDim.y/z are limited to 65535; the kernels loop over what lies beyond
  return dim3(static_cast<unsigned>(a), static_cast<unsigned>(b < 65535 ? b : 65535),
              static_cast<unsigned>(c < 65535 ? c : 65535));
}

// The z-chunk: the longest of longest, longest/2, ... shortest planes that
// still gives kTargetBlocks blocks over xy_tiles tiles of a depth-plane march.
int pick_chunk(int64_t xy_tiles, int depth, int longest, int shortest) {
  for (int c = longest; c > shortest; c /= 2) {
    if (xy_tiles * ((depth + c - 1) / c) >= kTargetBlocks) return c;
  }
  return shortest;
}

// The "vec16" staging route: rows of nx elements start on 16-byte boundaries.
template <typename T>
bool vec16(const void* u, const void* f, int nx) {
  const auto bits = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(f);
  return nx % (16 / static_cast<int>(sizeof(T))) == 0 && (bits & 15) == 0;
}

// Lifts the kernel's dynamic shared memory limit past 48 KB, once per device
// (the bit mask keeps cudaFuncSetAttribute off the per-launch path).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (*done & bit)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) *done |= bit;
  return static_cast<int>(err);
}

template <typename T, bool kVec>
int launch_smooth_pair_route(const T* u, const T* f, T* out, const Grid3& g, T w1, T w2,
                             cudaStream_t stream) {
  static unsigned configured = 0;
  const size_t bytes = PairSmem<T>::kBytes;
  if (const int err = allow_smem(smooth_pair_kernel<T, kVec>, bytes, &configured)) {
    return err;
  }
  const int ntx = (g.nx - 1) / kTX + 1, nty = (g.ny - 1) / kTY + 1;
  const int zc = pick_chunk(static_cast<int64_t>(ntx) * nty, g.lz, 8, 2);
  const int ntz = (g.lz - 1) / zc + 1;
  smooth_pair_kernel<T, kVec><<<capped(ntx, nty, ntz), Tile<T>::kThreads, bytes, stream>>>(
      u, f, out, g, zc, ntx, nty, ntz, w1, w2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_smooth_pair(const void* u, const void* f, void* out, int lz, int ny, int nx,
                       double w1, double w2, void* stream) {
  const Grid3 g{lz, ny, nx, static_cast<int64_t>(ny) * nx};
  const auto* tu = static_cast<const T*>(u);
  const auto* tf = static_cast<const T*>(f);
  auto* to = static_cast<T*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const T a = static_cast<T>(w1), b = static_cast<T>(w2);
  return vec16<T>(u, f, nx) ? launch_smooth_pair_route<T, true>(tu, tf, to, g, a, b, st)
                            : launch_smooth_pair_route<T, false>(tu, tf, to, g, a, b, st);
}

template <int A, bool kVec>
int launch_pair_bf16_route(const bf16* u, const bf16* f, bf16* out, const Grid3& g, int zc,
                           float w1, float w2, cudaStream_t stream) {
  using G = PairTile<A>;
  const auto kernel = smooth_pair_bf16_kernel<A, kVec>;
  static unsigned configured = 0;
  if (const int err = allow_smem(kernel, G::kBytes, &configured)) return err;
  const int ntx = (g.nx - 1) / G::TX + 1, nty = (g.ny - 1) / G::TY + 1;
  const int ntz = (g.lz - 1) / zc + 1;
  kernel<<<capped(ntx, nty, ntz), G::kThreads, G::kBytes, stream>>>(u, f, out, g, zc, ntx, nty,
                                                                      ntz, w1, w2);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 pair's routes ("vec16" also needs out 16-byte aligned: its runs
// are stored as 8-byte words) and staging depths (kShortMarch)
int launch_pair_bf16(const void* u, const void* f, void* out, int lz, int ny, int nx, double w1,
                     double w2, void* stream) {
  const Grid3 g{lz, ny, nx, static_cast<int64_t>(ny) * nx};
  const auto* tu = static_cast<const bf16*>(u);
  const auto* tf = static_cast<const bf16*>(f);
  auto* to = static_cast<bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const float a = static_cast<float>(w1), b = static_cast<float>(w2);
  const int64_t tiles =
      static_cast<int64_t>((nx - 1) / kPairTX + 1) * ((ny - 1) / kPairTY + 1);
  const int zc = pick_chunk(tiles, lz, kPairChunk, 2);
  const bool vec = vec16<bf16>(u, f, nx) && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (zc <= kShortMarch) {
    return vec ? launch_pair_bf16_route<1, true>(tu, tf, to, g, zc, a, b, st)
               : launch_pair_bf16_route<1, false>(tu, tf, to, g, zc, a, b, st);
  }
  return vec ? launch_pair_bf16_route<kPairAhead, true>(tu, tf, to, g, zc, a, b, st)
             : launch_pair_bf16_route<kPairAhead, false>(tu, tf, to, g, zc, a, b, st);
}

template <typename T, bool kVec>
int launch_residual_restrict_route(const T* u, const T* f, T* out, const Grid3& g, T s,
                                   cudaStream_t stream) {
  static unsigned configured = 0;
  const size_t bytes = RestrictSmem<T>::kBytes;
  if (const int err = allow_smem(residual_restrict_kernel<T, kVec>, bytes, &configured)) {
    return err;
  }
  const int ntx = (g.nx / 2 - 1) / (kTX / 2) + 1, nty = (g.ny / 2 - 1) / (kTY / 2) + 1;
  const int kc = pick_chunk(static_cast<int64_t>(ntx) * nty, g.lz / 2, 16, 1);
  const int ntz = (g.lz / 2 - 1) / kc + 1;
  residual_restrict_kernel<T, kVec><<<capped(ntx, nty, ntz), Tile<T>::kThreads, bytes,
                                      stream>>>(u, f, out, g, kc, ntx, nty, ntz, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_residual_restrict(const void* u, const void* f, void* out, int lz, int ny, int nx,
                             double rscale, void* stream) {
  const Grid3 g{lz, ny, nx, static_cast<int64_t>(ny) * nx};
  const auto* tu = static_cast<const T*>(u);
  const auto* tf = static_cast<const T*>(f);
  auto* to = static_cast<T*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const T s = static_cast<T>(rscale);
  return vec16<T>(u, f, nx) ? launch_residual_restrict_route<T, true>(tu, tf, to, g, s, st)
                            : launch_residual_restrict_route<T, false>(tu, tf, to, g, s, st);
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

// bf16 u, f, out; fp32 sweeps, u1 rounded to bf16 between them
int mg3d_smooth_pair_bf16(const void* u, const void* f, void* out, int lz, int ny, int nx,
                          double w1, double w2, void* stream) {
  return launch_pair_bf16(u, f, out, lz, ny, nx, w1, w2, stream);
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
