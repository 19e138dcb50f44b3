#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mpi_petsc4py_example_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a, one process
per source, all at once, into ``build/torch_kernels/``), holds every kernel
against its plain PyTorch version on the card, times them, and drives the
port's two paths through the public API with the launch counters zeroed just
before each and read just after:

* CG + Jacobi on the 7-point 3D Poisson stencil, fp32, 128^3, rtol 1e-6, as
  ``bench.py`` measures it, checked against scipy's fp64 CG; then 512^3 (134M
  unknowns) with an fp64 true-residual check on the card and the delta-method
  per-iteration time;
* CG + PC mg (the geometric-multigrid V-cycle, ``bench.py``'s second half) on
  the same problems, with the launches of each V-cycle kernel checked against
  the cycle count, per-level times of the two ``csrc/mg3d.cu`` kernels over
  the 512^3 cycle, the plain-version path, the Jacobi smoother, a profiler
  breakdown, and the slab cycle on a 4-shard virtual mesh held against one
  shard (fp64, 64^3);
* the batched multi-RHS solve ``KSP.solve_many`` (``bench.py``'s third part):
  128^3 f32, k = 8 right-hand sides, CG + Jacobi on the fast path
  (``stencil7_dot_many``) and on the general route (a distinct PC operator,
  ``stencil7_apply_many``), each column checked against scipy's fp64 CG and
  its own sequential solve; a mixed easy/hard batch (fp64); then 512^3 k = 8: the
  delta-method per-iteration time, peak memory, and a converged solve with
  every column's fp64 true residual on the card;
* the assembled-matrix path (``Mat``, no kernel of its own: its products are
  torch index and slice ops, as the JAX package's are jnp ops): 128^3 AIJ
  Poisson f32, CG + Jacobi on the DIA route, against the stencil path's
  iterations, scipy parity and per-iteration time; cfg1, cfg3 and cfg4 of
  ``benchmarks/run_all.py`` (64^3 CG + none, 512^2 GMRES(30) + Jacobi, 256^2
  BiCGStab + block Jacobi, each with the true-residual gate and an fp64 host
  check); the ELL route (a permuted 64^3 Poisson); ``solve_many`` with block
  Jacobi; the reference ``test.py`` flow through the port's runner and
  facade at -n 1 and -n 4; and a dense f64 direct solve at n = 4096;
* the eigensolver (``EPS``, Krylov-Schur; its operator applies are
  ``stencil7_apply``'s): the 128^3 fp64 stencil (2,097,152 rows), nev 1,
  the largest magnitude and the smallest real at ncv 16 and 32, against
  the closed form 6 -+ 6 cos(pi/129), with the launches of the apply kernel
  checked against the restart count and a profile per restart; the plain
  path at 32^3; the assembled 128^3 matrix (DIA); NHEP on convdiff2d(64)
  against numpy's eigenvalues; and the reference ``test2.py`` flow through
  the runner at -n 1 and -n 4;
* mixed-precision refinement (``RefinedKSP``) with the bfloat16
  instantiations of the four Krylov kernels (one kernel of their own, two
  routes): each held bit for bit against its plain version (128^3, an odd
  multi-tile shape, the kernel's tile edges, 32^3 and 64^3, k = 1/3/8, the
  route of every launch logged, misaligned copies through the element
  route), timed at 128^3 and 512^3 beside cuDNN's bf16 conv3d and profiled
  at 512^3 (the march apart from the dots' partial sums); 512^3 CG +
  Jacobi at bf16 against f32 (delta method, profile, peak memory, fp64 true
  residual), and the same with k = 8 through ``solve_many`` (delta method,
  the kernel's share of device time, peak memory); the
  refined solves that launch each bf16 kernel (32^3 single-RHS and 64^3
  k = 8, fast path and general route; 64^3 single-RHS, where bf16
  refinement is at the edge of contraction); and cfg11 of
  ``benchmarks/run_all.py`` at 128^3 (inner bf16/f32/f64 on the stencil and
  on the assembled Mat, rtol 1e-10, against scipy's fp64 CG);
* the direct solves past the dense cap (no kernel of their own: the cyclic
  reduction sweeps and the set-up inverses are torch operations): PC lu in
  the ``crtri`` mode on the 1D Laplacian at n = 2^20 and the ``test2.py``
  family at n = 100,000, in the ``crband`` mode on a pentadiagonal at n =
  2^20 set up on the card and on the host, bandwidth 8 at n = 100,000, a
  randomly permuted 160^2 Poisson through RCM and a refined f32 case, each
  fp64 relres <= 1e-10 (f32: 5e-6) and each apply timed against its bytes
  bound with its torch operations; PC sor/ssor/ilu/icc/asm under GMRES(30) on 4
  shards; cfg4 and the dense lu above run their PC set-up on the card
  (``-pc_setup_device auto``) and on the host (``0``);
* the KSP/PC/Mat/Vec surface (no kernel of its own: the transpose product,
  the null-space projection and the composite apply are torch operations):
  the monitored 128^3 f32 stencil CG (history, host syncs and
  ``stencil7_dot`` launches equal with and without the monitor, ms/iter
  both ways) and its warm start from a perturbed solution; the gated k = 8
  ``solve_many`` (``stencil7_dot_many``, one ``stencil7_apply_many`` per
  pass for the epilogue); a ``ShellMat`` whose ``mult`` is the stencil's
  ``stencil7_apply`` (CG within 2% of the stencil's iterations, one launch
  per apply, then cgne and lsqr); the 128^3 fp64 Neumann AIJ with a
  constant null space against the Dirichlet one; ``mult_transpose`` on the
  128^3 AIJ and on ``convdiff2d(1024)`` against its bytes bound and
  ``torch.sparse``, with bicg, cgne and lsqr there; composite and shell PCs
  under FGMRES (advanced.py's 24^2, and 64^2 on 1 and 4 shards); the 128^3
  AIJ through the PETSc binary format; and ``facade/drivers/advanced.py``.

``python3 chip_smoke.py --surface`` builds the kernels, checks the four the
surface slice launches, and runs only its phases.
``python3 chip_smoke.py --refine`` builds the kernels and runs only the
mixed-precision phases. ``python3 chip_smoke.py --direct`` runs only the
direct-solve phases, cfg4, the ``test.py`` flow and the dense lu. ``python3 chip_smoke.py --kernels`` builds the
kernels, prints each one's registers and spills (ptxas), checks every one
against its plain version and times it, and solves nothing.
``python3 chip_smoke.py --eps`` builds the kernels, checks them and runs
only the eigensolver phases. ``python3 chip_smoke.py --mg3d`` builds the
kernels and prints only the per-level table of the two ``csrc/mg3d.cu``
kernels and the warm CG + mg walls at 128^3 and 512^3. A copy of this
script placed in another checkout runs that checkout's kernels, so
``--kernels`` and ``--mg3d`` compare two trees in turns on one card.

Every check raises on failure, so the exit code is 0 only when all phases
passed. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the card's ``name, power.limit`` from nvidia-smi and the
one before that the ``{"kernels": [...]}`` record. Without CUDA, or without the
package beside it, the script exits non-zero and prints no result. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, device memory
F32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside tensor cores
# CG+Jacobi step traffic model of bench.py:49-52 (11 vector passes/iteration)
PASSES_PER_ITER = 11
_CSRC = "mpi_petsc4py_example_tpu_torch/csrc/"
_PALLAS = "mpi_petsc4py_example_tpu/ops/pallas_stencil.py:"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "stencil7_apply": (_CSRC + "stencil7.cu", _PALLAS + "365"),
    "stencil7_dot": (_CSRC + "stencil7.cu", _PALLAS + "394"),
    "stencil7_smooth": (_CSRC + "stencil7.cu", _PALLAS + "652"),
    "stencil7_residual": (_CSRC + "stencil7.cu", _PALLAS + "686"),
    "stencil7_smooth0_pair": (_CSRC + "stencil7.cu", _PALLAS + "1124"),
    "mg3d_smooth_pair": (_CSRC + "mg3d.cu", _PALLAS + "1251"),
    "mg3d_residual_restrict": (_CSRC + "mg3d.cu", _PALLAS + "1090"),
    "stencil7_apply_many": (_CSRC + "stencil7.cu", _PALLAS + "591"),
    "stencil7_dot_many": (_CSRC + "stencil7.cu", _PALLAS + "620"),
}
MG_KERNELS = list(KERNELS)[2:7]
MANY_KERNELS = list(KERNELS)[7:]
K_BATCH = 8     # bench.py:322, the batched episode's k
# check limits on max|kernel - plain|, relative to max|plain| (f32, f64)
Y_TOL = {"float32": 1e-6, "float64": 1e-13}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, inner, reps=25):
    """Median device time of one ``fn()`` call: CUDA events around ``inner``
    back-to-back calls, queued behind a sleep kernel so that host-side launch
    overhead is hidden; median over ``reps`` such runs, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(inner * 400_000))   # ~0.2 ms/call of cover
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(lz, ny, nx, itemsize, dot, k=1):
    """Least time on the card for ``k`` slabs: each input read once, each
    output written once, over the HBM rate; operations over the fp32 rate;
    the larger."""
    n = lz * ny * nx
    nbytes = k * ((2 * n + 2 * ny * nx) * itemsize + (itemsize if dot else 0))
    flops = k * (9 if dot else 7) * n   # 1 mul + 6 sub (+ mul, add)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def random_slab(shape, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    lz, ny, nx = shape
    mk = lambda *s: torch.rand(s, generator=g, device="cuda", dtype=dtype)
    return mk(lz, ny, nx), mk(ny, nx), mk(ny, nx)


def phase_build():
    """One nvcc process per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from mpi_petsc4py_example_tpu_torch.ops import build
    t0 = time.perf_counter()
    names = [src.stem for src in sorted(build.CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    log(f"build: {time.perf_counter() - t0:.2f} s for {names} "
        f"(nvcc {build.nvcc_path()}): {[p.name for p in libs]}")


def phase_kernel_resources():
    """Registers, spills and static shared memory of every kernel of
    ``csrc/*.cu``, as ptxas reports them (``nvcc -Xptxas -v`` with the
    build's flags, into a throw-away object). Returns {kernel: line}."""
    import re
    import tempfile
    from mpi_petsc4py_example_tpu_torch.ops import build
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    out = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, "k.o"), str(src)],
                capture_output=True, text=True, check=True)
        name = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                out[name] = ""
            elif name and ("registers" in line or "spill" in line):
                out[name] += line.split(":", 1)[-1].strip() + "; "
    filt = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    names = list(out)
    if os.access(filt, os.X_OK):
        shown = subprocess.run([filt], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    else:
        shown = names
    for name, pretty in zip(names, shown):
        pretty = pretty.replace("<unnamed>::", "").removeprefix("void ")
        # the template arguments, without the parameter list
        pretty = pretty.split(">(")[0] + ">" if ">(" in pretty else pretty
        log(f"resources {pretty}: {out[name]}")
    return out


def phase_kernel_checks():
    """Kernel vs plain on the card, f32 and f64. The shapes give the dot's
    fixed-order partial sum 1024 partials (128^3, one per summing thread), a
    few (the small planes), 1547 (a ragged multiple of the 1024 summing
    threads) and 65536 (512^3). Returns the largest f32 errors per kernel."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    worst = {"stencil7_apply": 0.0, "stencil7_dot": 0.0, "dot_rel": 0.0}
    limits = {torch.float32: (1e-6, 1e-4), torch.float64: (1e-13, 1e-12)}
    for dtype, (y_tol, dot_tol) in limits.items():
        for i, shape in enumerate([(128, 128, 128), (3, 7, 33), (1, 8, 128),
                                   (100, 130, 200), (512, 512, 512)]):
            u, lo, hi = random_slab(shape, dtype, 100 + i)
            ref = st.stencil3d_apply_plain(u, lo, hi)
            y = st.stencil3d_apply(u, lo, hi)
            yd, d = st.stencil3d_dot(u, lo, hi)
            dref = (u * ref).sum()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            e_apply = float((y - ref).abs().max())
            e_dot_y = float((yd - ref).abs().max())
            e_dot = abs(float(d) - float(dref)) / abs(float(dref))
            log(f"check {str(dtype)[6:]} {shape}: apply max|err| {e_apply:.3e}, "
                f"dot y max|err| {e_dot_y:.3e}, dot rel err {e_dot:.3e} "
                f"(max|y| {scale:.3e}, {st._kernels().stencil7_dot_blocks(*shape)} "
                f"partials)")
            check(e_apply <= y_tol * scale, f"apply {dtype} {shape}: {e_apply}")
            check(e_dot_y <= y_tol * scale, f"dot y {dtype} {shape}: {e_dot_y}")
            check(e_dot <= dot_tol, f"dot sum {dtype} {shape}: rel {e_dot}")
            if dtype == torch.float32:
                worst["stencil7_apply"] = max(worst["stencil7_apply"], e_apply)
                worst["stencil7_dot"] = max(worst["stencil7_dot"], e_dot_y)
                worst["dot_rel"] = max(worst["dot_rel"], e_dot)
            del u, lo, hi, ref, y, yd, d, dref
        torch.cuda.empty_cache()
    # the dot is deterministic: no atomics, fixed-order partial sums
    u, lo, hi = random_slab((128, 128, 128), torch.float32, 7)
    sums = {float(st.stencil3d_dot(u, lo, hi)[1]) for _ in range(5)}
    check(len(sums) == 1, f"dot not deterministic across runs: {sums}")
    bad = torch.float16           # bfloat16 has its own kernels (--refine)
    try:
        st.stencil3d_apply(u.to(bad), lo.to(bad), hi.to(bad))
    except TypeError:
        pass
    else:
        raise SystemExit(f"chip_smoke: FAIL: {bad} on CUDA did not raise")
    log("check: dot deterministic over 5 runs; fp16 raises TypeError")
    return worst


def phase_kernel_times(n):
    """kernel/plain/library/bound times at n^3 f32."""
    import torch
    import torch.nn.functional as F
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    u, lo, hi = random_slab((n, n, n), torch.float32, 11)
    y = torch.empty_like(u)
    inner = 20 if n >= 512 else 100
    out = {}
    # library yardstick: conv3d over the halo-extended slab (built outside
    # the timed region), 7-point weights, zero padding in y and x
    ext = torch.cat([lo[None], u, hi[None]])[None, None]
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda", dtype=torch.float32)
    w[0, 0, 1, 1, 1] = 6.0
    for dz, dy, dx in [(0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)]:
        w[0, 0, dz, dy, dx] = -1.0
    conv = lambda: F.conv3d(ext, w, padding=(0, 1, 1))
    ref = st.stencil3d_apply_plain(u, lo, hi)
    e_conv = float((conv()[0, 0] - ref).abs().max())
    e_apply = float((st.stencil3d_apply(u, lo, hi, out=y) - ref).abs().max())
    yd, d = st.stencil3d_dot(u, lo, hi)
    e_dot = float((yd - ref).abs().max())
    dref = float((u * ref).sum())
    e_sum = abs(float(d) - dref) / abs(dref)
    scale = float(ref.abs().max())
    check(e_apply <= 1e-6 * scale, f"apply {n}^3 f32: {e_apply}")
    check(e_dot <= 1e-6 * scale, f"dot y {n}^3 f32: {e_dot}")
    check(e_sum <= 1e-4, f"dot sum {n}^3 f32: rel {e_sum}")
    check(e_conv <= 1e-5 * scale, f"conv3d yardstick {n}^3: {e_conv}")
    lib_ms = device_ms(conv, inner)
    for name, kern, plain, dot in [
            ("stencil7_apply", lambda: st.stencil3d_apply(u, lo, hi, out=y),
             lambda: st.stencil3d_apply_plain(u, lo, hi), False),
            ("stencil7_dot", lambda: st.stencil3d_dot(u, lo, hi, out=y),
             lambda: st.stencil3d_dot_plain(u, lo, hi), True)]:
        b_ms, b_by = bound_ms(n, n, n, 4, dot)
        out[name] = {"ms": device_ms(kern, inner), "plain_ms": device_ms(plain, inner),
                     "library_ms": None if dot else lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": e_dot if dot else e_apply}
        r = out[name]
        log(f"time {name} {n}^3 f32: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{'conv3d ' + format(lib_ms, '.4f') + ' ms' if not dot else 'no one-call library equivalent'}"
            f", achieved {(2 * n**3 + 2 * n * n) * 4 / r['ms'] / 1e6:.1f} GB/s")
    log(f"time conv3d {n}^3: max|conv3d - plain| {e_conv:.3e}")
    del u, lo, hi, y, ext, ref, yd, d
    torch.cuda.empty_cache()
    return out


def mg_kernel_calls(st, dtype, shape, seed, zero_halo_variants=False):
    """The five V-cycle kernels and their plain versions on one random input:
    ``{name: (kernel(), plain())}`` thunks, smooth and residual with random
    halo planes; ``zero_halo_variants`` adds both again with None for the
    halos (the zero-ghost instantiation the single-slab levels run), keyed
    ``"<name> zero halos"``. residual_restrict only on even dims."""
    import torch
    from mpi_petsc4py_example_tpu_torch.solvers.mg import cheby_omegas
    g = torch.Generator(device="cuda").manual_seed(seed)
    lz, ny, nx = shape
    mk = lambda *sh: torch.rand(sh, generator=g, device="cuda", dtype=dtype)
    u, f = mk(lz, ny, nx), mk(lz, ny, nx)
    lo, hi = mk(ny, nx), mk(ny, nx)
    w = 2.0 / 3.0 / 6.0
    w1, w2 = (c / 6.0 for c in cheby_omegas(2))
    calls = {}
    for suffix, (a, b) in [("", (lo, hi))] + (
            [(" zero halos", (None, None))] if zero_halo_variants else []):
        calls["stencil7_smooth" + suffix] = (
            lambda a=a, b=b: st.stencil3d_smooth(u, f, a, b, w),
            lambda a=a, b=b: st.stencil3d_smooth_plain(u, f, a, b, w))
        calls["stencil7_residual" + suffix] = (
            lambda a=a, b=b: st.stencil3d_residual(u, f, a, b),
            lambda a=a, b=b: st.stencil3d_residual_plain(u, f, a, b))
    calls["stencil7_smooth0_pair"] = (
        lambda: st.stencil3d_smooth0_pair(f, w1, w2),
        lambda: st.stencil3d_smooth0_pair_plain(f, w1, w2))
    calls["mg3d_smooth_pair"] = (
        lambda: st.stencil3d_smooth_pair(u, f, w1, w2),
        lambda: st.stencil3d_smooth_pair_plain(u, f, w1, w2))
    if lz % 2 == 0 and ny % 2 == 0 and nx % 2 == 0:
        calls["mg3d_residual_restrict"] = (
            lambda: st.stencil3d_residual_restrict(u, f),
            lambda: st.stencil3d_residual_restrict_plain(u, f))
    return calls


# the slab cycle's cell: 64^3 on a 4-shard virtual mesh (phase_mg_slab)
SLAB_N, SLAB_SHARDS = 64, 4


def mg_path_shapes():
    """The slabs the V-cycle kernels get on the paths this script drives:
    every level of the single-slab cycle at 128^3, 512^3 and 64^3 (zero
    ghosts), and the local slab of every slab-decomposed level of 64^3 over
    4 shards (the levels whose local plane count is even, as
    ``make_vcycle3d`` splits them; real neighbour halos). Returns
    ``{shape: the paths that give it}``."""
    from mpi_petsc4py_example_tpu_torch.solvers.mg import mg_levels
    paths = {}
    for n in (128, 512, SLAB_N):
        for lvl in mg_levels(n, n, n):
            paths.setdefault(lvl, []).append(f"{n}^3 level")
    for lvl in mg_levels(SLAB_N, SLAB_N, SLAB_N)[:-1]:
        if lvl[0] % (2 * SLAB_SHARDS):
            break
        local = (lvl[0] // SLAB_SHARDS,) + lvl[1:]
        paths.setdefault(local, []).append(
            f"{SLAB_N}^3 / {SLAB_SHARDS} shards slab")
    return {shape: ", ".join(p) for shape, p in paths.items()}


# shapes that straddle the 64 x 16 tiles and the z-chunks of csrc/mg3d.cu:
# x, y = tile +- 1 for smooth_pair (+- 2 for residual_restrict's fine tile),
# lz one or three planes past a multiple of the chunk (smooth_pair: 2 on the
# small planes, 8 on (161, 1025); residual_restrict: 1 coarse plane, 16 on
# (162, 642)); both staging routes in f32 and f64
TILE_EDGE_SHAPES = ((17, 15, 63), (35, 17, 65), (19, 17, 65),
                    (131, 161, 1025), (34, 18, 66), (66, 14, 62),
                    (70, 18, 66), (70, 162, 642), (70, 162, 644))


def mg3d_route(nx, itemsize):
    """The staging route ``csrc/mg3d.cu`` takes for rows of ``nx`` elements
    of ``itemsize`` bytes (on tensors from PyTorch's allocator, whose
    16-byte alignment the route also needs): "vec16" (16-byte copies) or
    "elem" (one copy per element)."""
    return "vec16" if nx % (16 // itemsize) == 0 else "elem"


def phase_mg_kernel_checks():
    """The five V-cycle kernels vs their plain versions on the card, f32 and
    f64, at every shape the driven paths give them (:func:`mg_path_shapes`),
    three ragged ones and :data:`TILE_EDGE_SHAPES` (each line logs the
    ``mg3d`` kernels' staging route); smooth and residual with
    random halos and with zero ones at every shape. The kernels repeat the
    plain order of operations with no FMA contraction, so they must agree
    bit for bit (checked after the per-shape limit max|kernel - plain| <=
    Y_TOL * max|plain|). Returns the largest f32 errors per kernel."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    worst = {name: 0.0 for name in MG_KERNELS}
    exact = True
    shapes = mg_path_shapes()
    for extra in ((100, 130, 200), (17, 9, 33), (18, 10, 66)):
        shapes.setdefault(extra, "ragged")
    for extra in TILE_EDGE_SHAPES:
        shapes.setdefault(extra, "tile edge")
    for dtype in (torch.float32, torch.float64):
        tol = Y_TOL[str(dtype)[6:]]
        for i, (shape, label) in enumerate(shapes.items()):
            calls = mg_kernel_calls(st, dtype, shape, 300 + i, True)
            errs = {}
            for key, (kern, plain) in calls.items():
                ref = plain()
                got = kern()
                torch.cuda.synchronize()
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                errs[key] = err
                exact = exact and err == 0.0
                check(got.shape == ref.shape and err <= tol * scale,
                      f"{key} {dtype} {shape}: max|err| {err} vs "
                      f"{tol} * {scale}")
                if dtype == torch.float32:
                    name = key.split()[0]
                    worst[name] = max(worst[name], err)
                del ref, got
            log(f"check {str(dtype)[6:]} {shape} ({label}): max|err| "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" [mg3d route {mg3d_route(shape[2], dtype.itemsize)}]")
            del calls
            torch.cuda.empty_cache()
    log(f"check: V-cycle kernels bit-exact with their plain versions at "
        f"every shape and dtype: {exact}")
    check(exact, "a V-cycle kernel is not bit-exact with its plain version")
    u = torch.zeros((4, 6, 8), device="cuda", dtype=torch.float32)
    for bad in ((3, 6, 8), (4, 5, 8), (4, 6, 7)):
        try:
            st.stencil3d_residual_restrict(u.new_zeros(bad), u.new_zeros(bad))
        except ValueError:
            continue
        raise SystemExit(f"chip_smoke: FAIL: odd dims {bad} did not raise")
    try:
        st.stencil3d_smooth_pair(u.half(), u.half(), 0.1, 0.1)
    except TypeError:
        pass
    else:
        raise SystemExit("chip_smoke: FAIL: fp16 smooth_pair did not raise")
    log("check: residual_restrict raises on odd dims, fp16 raises TypeError")
    return worst


def mg_bound_ms(name, n, itemsize):
    """Least time on the card for one V-cycle kernel at n^3 (or the shape
    ``n``) from the bytes it must move (inputs read once, output written
    once) and its operations."""
    lz, ny, nx = (n, n, n) if isinstance(n, int) else n
    pts, plane = lz * ny * nx, ny * nx
    nbytes, flops = {
        # u, f in, out; two halo planes; 7 apply + sub + mul + add
        "stencil7_smooth": ((3 * pts + 2 * plane) * itemsize, 10 * pts),
        "stencil7_residual": ((3 * pts + 2 * plane) * itemsize, 8 * pts),
        # f in, out; 7 apply + 2 mul + sub
        "stencil7_smooth0_pair": (2 * pts * itemsize, 10 * pts),
        # u, f in, out; two sweeps
        "mg3d_smooth_pair": (3 * pts * itemsize, 20 * pts),
        # u, f in, out/8; residual 8 + taps 6 on n/2 + n/4 + n/8 points
        "mg3d_residual_restrict": ((2 * pts + pts // 8) * itemsize,
                                   8 * pts + 6 * (pts // 2 + pts // 4 + pts // 8)),
    }[name]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_mg_kernel_times(n):
    """kernel/plain/bound times of the V-cycle kernels at n^3 f32; no single
    PyTorch call computes any of the five, so library_ms is null."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    inner = 20 if n >= 512 else 100
    out = {}
    for name, (kern, plain) in mg_kernel_calls(st, torch.float32, (n, n, n),
                                               41).items():
        err = float((kern() - plain()).abs().max())
        b_ms, b_by = mg_bound_ms(name, n, 4)
        out[name] = {"ms": device_ms(kern, inner), "plain_ms": device_ms(plain, inner),
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err}
        r = out[name]
        log(f"time {name} {n}^3 f32: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / r['ms'] * 100:.1f}% of it), no one-call library "
            f"equivalent, max|err| {err:.3e}")
    torch.cuda.empty_cache()
    return out


def host_us_per_call(fn, calls=50):
    """Host time of one wrapper call, launch included, without waiting for
    the device: the mean over ``calls`` back-to-back calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def phase_mg_level_times(n=512):
    """``mg3d_smooth_pair`` and ``mg3d_residual_restrict`` at every level of
    the n^3 cycle that runs them (n^3 down to 8^3), f32: kernel ms, bound ms,
    % of bound and the wrapper's host us per call, on random inputs, each
    checked bit-exact against its plain version first. Returns ``{name:
    [row per level]}``."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    from mpi_petsc4py_example_tpu_torch.solvers.mg import mg_levels
    out = {"mg3d_smooth_pair": [], "mg3d_residual_restrict": []}
    for lvl in mg_levels(n, n, n)[:-1]:
        calls = mg_kernel_calls(st, torch.float32, lvl, 61)
        big = lvl[0] >= 256
        for name, rows in out.items():
            kern, plain = calls[name]
            err = float((kern() - plain()).abs().max())
            check(err == 0.0, f"{name} {lvl}: max|err| {err}")
            ms = device_ms(kern, 20 if big else 100, reps=15 if big else 25)
            b_ms, _ = mg_bound_ms(name, lvl, 4)
            host = host_us_per_call(kern)
            rows.append({"shape": list(lvl), "ms": ms, "bound_ms": b_ms,
                         "pct_of_bound": b_ms / ms * 100, "host_us": host,
                         "route": mg3d_route(lvl[2], 4)})
            log(f"level {name} {lvl} f32: kernel {ms:.5f} ms, bound "
                f"{b_ms:.5f} ms ({b_ms / ms * 100:.1f}% of it), host "
                f"{host:.2f} us/call, route {mg3d_route(lvl[2], 4)}")
        del calls
        torch.cuda.empty_cache()
    return out


def phase_mg_walls(reps=7):
    """Warm CG + PC mg walls per iteration at 128^3 and 512^3 f32 (rtol
    1e-6, b = A x_true as the mg phases make it): the median and the range
    over ``reps`` solves after one warm-up, with the iterations. Returns
    ``{n: {"ms_per_iter": ..., "samples": [...], "iterations": ...}}``."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    out = {}
    for nx in (128, 512):
        op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
        g = torch.Generator(device="cuda").manual_seed(7)
        n = nx ** 3
        bv = op.mult(pt.Vec(comm, n, data=torch.rand(
            n, generator=g, device="cuda", dtype=torch.float32)))
        x, _ = op.get_vecs()
        ksp = cg_mg(comm, op, 1e-6)
        its = zero_solve(ksp, bv, x)
        samples = []
        for _ in range(reps):
            x.zero()
            r = ksp.solve(bv, x)
            check(r.converged and r.iterations == its,
                  f"{nx}^3 mg warm solve: {r}")
            samples.append(r.wall_time / r.iterations * 1e3)
        out[nx] = {"ms_per_iter": statistics.median(samples),
                   "samples": samples, "iterations": its}
        log(f"mg walls {nx}^3 f32 CG+mg: {its} iterations, warm median "
            f"{out[nx]['ms_per_iter']:.4f} ms/iter (range "
            f"{min(samples):.4f}-{max(samples):.4f} over {reps} solves)")
        del op, bv, x, ksp
        torch.cuda.empty_cache()
    return out


def zero_solve(ksp, bv, x):
    """``ksp.solve`` from a zeroed ``x``; returns the iteration count."""
    x.zero()
    return ksp.solve(bv, x).iterations


def profile_solve(run, label, ops=(), kernels=(), out=None):
    """Device time by kernel over one solve, ``run()`` (which returns its
    iteration count), under ``torch.profiler``, and the device's idle share
    of the window's wall time; for each PyTorch op named in ``ops`` also the
    device time of all the kernels it launched, and the share of the busy
    time of the CUDA kernels whose names hold any of the strings in
    ``kernels`` (into ``out["kernel_share"]``, with the busy us per
    iteration, when ``out`` is a dict). Returns the idle share, or None when
    the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterations = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): the CPU op rows repeat them
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if busy_us == 0:
        log(f"profile {label}: the profiler recorded no device time "
            "(device breakdown not measured)")
        return None
    its = max(iterations, 1)
    log(f"profile {label}: {iterations} iterations, wall "
        f"{wall_us / its:.1f} us/iter, device busy {busy_us / its:.1f} us/iter, "
        f"device idle share {1 - busy_us / wall_us:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / its:9.2f} us/iter  {count / its:6.1f} calls/iter  {key[:120]}")
    for op in ops:
        us = sum(e.device_time_total for e in prof.key_averages() if e.key == op)
        log(f"  {op}: {us / its:.2f} us/iter of device time, "
            f"{us / busy_us * 100:.1f}% of the busy time")
    if kernels:
        us = sum(r[1] for r in rows if any(k in r[0] for k in kernels))
        log(f"  kernels {list(kernels)}: {us / its:.2f} us/iter, "
            f"{us / busy_us * 100:.1f}% of the busy time")
        if out is not None:
            out.update(kernel_share=us / busy_us,
                       kernel_us_per_iter=us / its,
                       busy_us_per_iter=busy_us / its)
    return 1 - busy_us / wall_us


def make_problem(comm, nx, dtype):
    """bench.py:55-72: b = A x_true with x_true from default_rng(7)."""
    import mpi_petsc4py_example_tpu_torch as pt
    op = pt.StencilPoisson3D(comm, nx, dtype=dtype)
    x_true = np.random.default_rng(7).random(nx ** 3).astype(np.float32)
    b = op.mult(pt.Vec.from_global(comm, x_true)).to_numpy()
    return op, b


def cg_jacobi(comm, op, rtol=1e-6, max_it=20000, norm_none=False):
    import mpi_petsc4py_example_tpu_torch as pt
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    if norm_none:
        ksp.set_norm_type("none")
    return ksp


def phase_main_path():
    """The headline solve through the public API, with the launch counters
    zeroed just before and read just after."""
    import scipy.sparse.linalg as spla
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx, rtol = 128, 1e-6
    comm = pt.DeviceComm()
    reset_launches()
    op, b = make_problem(comm, nx, torch.float32)
    ksp = cg_jacobi(comm, op, rtol)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    launches = {"stencil7_apply": st.stencil3d_apply.launches,
                "stencil7_dot": st.stencil3d_dot.launches}
    log(f"main path {nx}^3 f32 CG+jacobi: {res.iterations} iterations, "
        f"{res.reason_name}, wall {res.wall_time * 1e3:.1f} ms, "
        f"{res.wall_time / max(res.iterations, 1) * 1e3:.4f} ms/iter, "
        f"host syncs {res.host_syncs}, launches {launches}")
    check(res.converged, f"main path did not converge: {res}")
    check(launches["stencil7_dot"] == res.iterations + 1,
          f"dot launches {launches['stencil7_dot']} != iterations + 1")
    check(launches["stencil7_apply"] >= 1, "apply kernel never launched")
    x_port = x.to_numpy()
    # a second solve for the warm wall time
    x.zero()
    warm = ksp.solve(bv, x)
    log(f"main path warm solve: wall {warm.wall_time * 1e3:.1f} ms, "
        f"{warm.iterations} iterations")
    profile_solve(lambda: zero_solve(ksp, bv, x), f"{nx}^3 converged solve")
    # the same solve through the plain PyTorch versions, on the card
    op.force_plain = True
    xp, _ = op.get_vecs()
    plain = ksp.solve(bv, xp)
    op.force_plain = False
    log(f"main path with plain versions: {plain.iterations} iterations, "
        f"{plain.reason_name}, wall {plain.wall_time * 1e3:.1f} ms")
    check(abs(plain.iterations - res.iterations) <= 0.02 * res.iterations,
          f"plain path iterations {plain.iterations} vs kernels {res.iterations}")
    # scipy fp64 CG + Jacobi oracle and the residual parity rule of bench.py:334
    A = pt.poisson3d_csr(nx).astype(np.float64)
    bb = b.astype(np.float64)
    M = spla.LinearOperator(A.shape, matvec=lambda v: v / 6.0)
    t0 = time.perf_counter()
    x_cpu, info = spla.cg(A, bb, rtol=rtol, atol=0.0, maxiter=20000, M=M)
    cpu_wall = time.perf_counter() - t0
    bnorm = np.linalg.norm(bb)
    r_port = np.linalg.norm(bb - A @ x_port.astype(np.float64))
    r_cpu = np.linalg.norm(bb - A @ x_cpu)
    parity = bool(r_port <= 10 * max(r_cpu, rtol * bnorm))
    log(f"parity vs scipy fp64 CG (info {info}, {cpu_wall:.2f} s): "
        f"port rel residual {r_port / bnorm:.3e}, scipy {r_cpu / bnorm:.3e}, "
        f"parity {parity}")
    check(parity, "residual parity rule of bench.py:334 failed")
    oracle = {"nx": nx, "b": b, "A": A, "r_cpu": r_cpu, "bnorm": bnorm,
              "k1_ms_per_iter": warm.wall_time / warm.iterations * 1e3,
              "iterations": res.iterations}
    return launches, oracle


def reset_launches():
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    st.reset_launches()


def read_launches():
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    return {name: wrapper.launches for name, wrapper in st.KERNELS.items()}


def cg_mg(comm, op, rtol, max_it=200, smoother="chebyshev"):
    import mpi_petsc4py_example_tpu_torch as pt
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("mg")
    ksp.get_pc().mg_smoother = smoother
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    return ksp


def expected_mg_launches(nx, iterations, smoother="chebyshev"):
    """Kernel launches of one single-slab CG + mg solve: one V-cycle at
    set-up and one per iteration; per cycle, each level above the coarsest
    runs smooth0_pair, residual_restrict and smooth_pair (Chebyshev) or
    1 + 2 single sweeps (Jacobi), and the coarsest 19 sweeps."""
    from mpi_petsc4py_example_tpu_torch.solvers.mg import mg_levels
    cycles = iterations + 1
    above = len(mg_levels(nx, nx, nx)) - 1
    cheb = smoother == "chebyshev"
    return {"stencil7_apply": 0, "stencil7_dot": iterations + 1,
            "stencil7_smooth": (19 + (0 if cheb else 3 * above)) * cycles,
            "stencil7_residual": 0,
            "stencil7_smooth0_pair": above * cycles if cheb else 0,
            "mg3d_smooth_pair": above * cycles if cheb else 0,
            "mg3d_residual_restrict": above * cycles,
            "stencil7_apply_many": 0, "stencil7_dot_many": 0}


def phase_mg_main_path(oracle):
    """128^3 f32 CG + PC mg (Chebyshev) to rtol 1e-6 through the public API,
    launch counters zeroed just before the solve and read just after; the
    answer held to bench.py's parity rule against the same scipy fp64 CG
    oracle as the Jacobi path; the plain-version path; the Jacobi smoother
    through the options database; a profiler breakdown."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    nx, rtol = oracle["nx"], 1e-6
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    ksp = cg_mg(comm, op, rtol)
    x, bv = op.get_vecs()
    bv.set_global(oracle["b"])
    torch.cuda.synchronize()
    reset_launches()
    res = ksp.solve(bv, x)
    launches = read_launches()
    torch.cuda.synchronize()
    want = expected_mg_launches(nx, res.iterations)
    log(f"mg main path {nx}^3 f32 CG+mg(chebyshev): {res.iterations} "
        f"iterations, {res.reason_name}, wall {res.wall_time * 1e3:.1f} ms "
        f"(first solve), host syncs {res.host_syncs}, launches {launches}")
    check(res.converged, f"mg main path did not converge: {res}")
    check(res.host_syncs == res.iterations + 1,
          f"host syncs {res.host_syncs} != iterations + 1")
    check(launches == want, f"mg launches {launches} != expected {want}")
    A, bb, bnorm = oracle["A"], oracle["b"].astype(np.float64), oracle["bnorm"]
    r_mg = np.linalg.norm(bb - A @ x.to_numpy().astype(np.float64))
    parity = bool(r_mg <= 10 * max(oracle["r_cpu"], rtol * bnorm))
    log(f"mg parity vs scipy fp64 CG+jacobi: port rel residual "
        f"{r_mg / bnorm:.3e}, scipy {oracle['r_cpu'] / bnorm:.3e}, parity {parity}")
    check(parity, "mg: residual parity rule of bench.py:334 failed")
    walls = []
    for _ in range(3):
        x.zero()
        walls.append(ksp.solve(bv, x).wall_time)
    warm = statistics.median(walls)
    log(f"mg main path warm solve: median wall {warm * 1e3:.2f} ms "
        f"(samples {[round(w * 1e3, 2) for w in walls]}), "
        f"{warm / res.iterations * 1e3:.4f} ms/iter")
    profile_solve(lambda: zero_solve(ksp, bv, x),
                  f"{nx}^3 CG+mg converged solve", ops=("aten::einsum",))
    # the same solve through the plain PyTorch versions, on the card
    op.force_plain = True
    xp, _ = op.get_vecs()
    reset_launches()
    plain = ksp.solve(bv, xp)
    op.force_plain = False
    plain_launches = sum(read_launches().values())
    # the V-cycle kernels equal their plain versions bit for bit; the two
    # solves differ only in how <p, A p> is summed (the dot kernel's
    # fixed-order block partials vs torch.sum), so the iterates differ at
    # fp32 rounding level
    x_diff = float((x.data - xp.data).abs().max() / xp.data.abs().max())
    log(f"mg main path with plain versions: {plain.iterations} iterations, "
        f"{plain.reason_name}, wall {plain.wall_time * 1e3:.1f} ms, "
        f"kernel launches {plain_launches}, max|x_kernels - x_plain| / "
        f"max|x_plain| {x_diff:.3e} (limit 1e-5)")
    check(plain.converged and abs(plain.iterations - res.iterations) <= 1,
          f"plain mg iterations {plain.iterations} vs kernels {res.iterations}")
    check(plain_launches == 0, "the plain path launched kernels")
    check(x_diff <= 1e-5, f"kernel and plain mg iterates differ by {x_diff}")
    # the library refuses TF32 prolongation einsums on the card
    torch.set_float32_matmul_precision("high")
    try:
        ksp.solve(bv, xp)
    except RuntimeError as e:
        check("TF32" in str(e), f"unexpected error with TF32 on: {e}")
    else:
        raise SystemExit("chip_smoke: FAIL: PC mg solved with TF32 matmuls on")
    finally:
        torch.set_float32_matmul_precision("highest")
    log("check: PC mg raises on the card when TF32 matmuls are enabled")
    # the Jacobi smoother, chosen through the options database
    pt.init(["chip_smoke", "-pc_type", "mg", "-pc_mg_smooth_type", "jacobi"])
    try:
        kj = pt.KSP().create(comm)
        kj.set_operators(op)
        kj.set_type("cg")
        kj.set_from_options()
        kj.set_tolerances(rtol=rtol, atol=0.0, max_it=200)
    finally:
        pt.global_options().clear()
    xj, _ = op.get_vecs()
    reset_launches()
    rj = kj.solve(bv, xj)
    lj = read_launches()
    r_j = np.linalg.norm(bb - A @ xj.to_numpy().astype(np.float64))
    log(f"mg main path, -pc_mg_smooth_type jacobi: {rj.iterations} iterations, "
        f"{rj.reason_name}, rel residual {r_j / bnorm:.3e}, launches {lj}")
    check(kj.get_pc().mg_smoother == "jacobi" and rj.converged,
          f"jacobi-smoothed mg: {rj}")
    check(r_j <= 10 * max(oracle["r_cpu"], rtol * bnorm),
          "jacobi-smoothed mg: parity rule failed")
    check(lj == expected_mg_launches(nx, rj.iterations, "jacobi"),
          f"jacobi-smoothed mg launches {lj}")
    return launches


def phase_mg_realistic():
    """512^3 f32 CG + mg: a converged solve with the launch counts checked,
    an fp64 true residual on the card (the f64 apply kernel), wall per
    iteration, peak memory and a profiler breakdown."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    nx, rtol = 512, 1e-6
    n = nx ** 3
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    x_true = pt.Vec(comm, n, data=torch.rand(n, generator=g, device="cuda",
                                             dtype=torch.float32))
    bv = op.mult(x_true)
    del x_true
    x, _ = op.get_vecs()
    ksp = cg_mg(comm, op, rtol)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = ksp.solve(bv, x)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"512^3 f32 CG+mg: {res.iterations} iterations, {res.reason_name}, "
        f"wall {res.wall_time * 1e3:.1f} ms (first solve), host syncs "
        f"{res.host_syncs}, peak {peak:.2f} GiB, launches {launches}")
    check(res.converged, f"512^3 mg solve did not converge: {res}")
    check(launches == expected_mg_launches(nx, res.iterations),
          f"512^3 mg launches {launches}")
    op64 = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    b64 = bv.data.double()
    ax = op64.mult(pt.Vec(comm, n, data=x.data.double())).data
    true_rel = float(torch.linalg.vector_norm(b64 - ax)
                     / torch.linalg.vector_norm(b64))
    log(f"512^3 mg fp64 true relative residual {true_rel:.3e} (limit {10 * rtol:g})")
    check(true_rel <= 10 * rtol, f"512^3 mg true residual {true_rel}")
    del b64, ax, op64
    torch.cuda.empty_cache()
    walls = []
    for _ in range(3):
        x.zero()
        r = ksp.solve(bv, x)
        walls.append(r.wall_time / r.iterations)
    log(f"512^3 CG+mg warm: median {statistics.median(walls) * 1e3:.4f} ms/iter "
        f"(samples {[round(w * 1e3, 4) for w in walls]}), "
        f"{statistics.median(walls) * r.iterations * 1e3:.1f} ms per solve")
    profile_solve(lambda: zero_solve(ksp, bv, x),
                  f"{nx}^3 CG+mg converged solve", ops=("aten::einsum",))
    del x, bv
    torch.cuda.empty_cache()
    return launches


def phase_mg_slab():
    """The slab V-cycle: 64^3 fp64 CG + mg on a 4-shard virtual mesh against
    one shard. Equal iterations and iterates within 1e-10: the solve does not
    depend on the shard count. The 4-shard run is the path that launches the
    residual kernel."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    nx, rtol = SLAB_N, 1e-8
    A = pt.poisson3d_csr(nx)
    b = A @ np.random.default_rng(3).random(nx ** 3)
    out = {}
    for ndev in (1, SLAB_SHARDS):
        comm = pt.DeviceComm(n_devices=ndev)
        op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
        ksp = cg_mg(comm, op, rtol)
        x, bv = op.get_vecs()
        bv.set_global(b)
        torch.cuda.synchronize()
        reset_launches()
        res = ksp.solve(bv, x)
        out[ndev] = (res, x.to_numpy(), read_launches())
        log(f"slab {nx}^3 fp64 CG+mg on {ndev} shard(s): {res.iterations} "
            f"iterations, {res.reason_name}, wall {res.wall_time * 1e3:.1f} ms, "
            f"launches {out[ndev][2]}")
        check(res.converged, f"slab mg on {ndev} shards: {res}")
    (r1, x1, _), (r4, x4, l4) = out[1], out[SLAB_SHARDS]
    rel = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    log(f"slab: 4 shards vs 1: iterations {r4.iterations} vs {r1.iterations}, "
        f"relative iterate difference {rel:.3e} (limit 1e-10)")
    check(r4.iterations == r1.iterations, "slab iterations differ")
    check(rel <= 1e-10, f"slab iterates differ by {rel}")
    # 64^3 over 4 shards: levels 64..8 run slab-decomposed, one launch per
    # shard for each residual and each of the 1 + 2 single sweeps; the 4^3
    # tail is gathered and smoothed once (19 sweeps)
    cycles = r4.iterations + 1
    check(l4["stencil7_residual"] == 4 * 4 * cycles and
          l4["stencil7_smooth"] == (4 * 4 * 3 + 19) * cycles,
          f"slab launches {l4}")
    return l4


def phase_realistic():
    """512^3 f32 (134M unknowns): converged solve with an fp64 true residual
    on the card, then the delta-method per-iteration time."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx, rtol = 512, 1e-6
    n = nx ** 3
    comm = pt.DeviceComm()
    reset_launches()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    x_true = pt.Vec(comm, n, data=torch.rand(n, generator=g, device="cuda",
                                             dtype=torch.float32))
    bv = op.mult(x_true)
    del x_true
    x, _ = op.get_vecs()
    ksp = cg_jacobi(comm, op, rtol)
    torch.cuda.reset_peak_memory_stats()
    res = ksp.solve(bv, x)
    launches = {"stencil7_apply": st.stencil3d_apply.launches,
                "stencil7_dot": st.stencil3d_dot.launches}
    log(f"512^3 f32 CG+jacobi: {res.iterations} iterations, {res.reason_name}, "
        f"wall {res.wall_time:.3f} s, {res.wall_time / res.iterations * 1e3:.4f} "
        f"ms/iter, host syncs/iter {(res.host_syncs - 1) / res.iterations:.3f}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    check(res.converged, f"512^3 solve did not converge: {res}")
    check(launches["stencil7_dot"] == res.iterations + 1,
          f"512^3 dot launches {launches['stencil7_dot']} != iterations + 1")
    check(launches["stencil7_apply"] == 1,
          f"512^3 apply launches {launches['stencil7_apply']} != 1 (the mult)")
    # fp64 true residual on the card with the port's f64 apply kernel
    op64 = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    b64 = pt.Vec(comm, n, data=bv.data.double())
    ax = op64.mult(pt.Vec(comm, n, data=x.data.double()))
    true_rel = float(torch.linalg.vector_norm(b64.data - ax.data)
                     / torch.linalg.vector_norm(b64.data))
    log(f"512^3 fp64 true relative residual {true_rel:.3e} (limit {10 * rtol:g})")
    check(true_rel <= 10 * rtol, f"512^3 true residual {true_rel}")
    del b64, ax, op64
    torch.cuda.empty_cache()
    # delta method (bench.py:101-136): two fixed-iteration solves
    lo_it, hi_it = 20, 220
    solvers = {m: cg_jacobi(comm, op, 0.0, max_it=m, norm_none=True)
               for m in (lo_it, hi_it)}
    per_iter = []
    for _ in range(3):
        walls = {}
        for m, k in solvers.items():
            x.zero()
            t0 = time.perf_counter()
            r = k.solve(bv, x)
            walls[m] = (time.perf_counter() - t0, r.iterations)
        (w_lo, i_lo), (w_hi, i_hi) = walls[lo_it], walls[hi_it]
        per_iter.append((w_hi - w_lo) / (i_hi - i_lo))
    per = statistics.median(per_iter)
    model_bytes = PASSES_PER_ITER * n * 4
    bound = model_bytes / HBM_BYTES_PER_S
    log(f"512^3 delta-method: {per * 1e3:.4f} ms/iter (samples "
        f"{[round(p * 1e3, 4) for p in per_iter]}), 11-pass model "
        f"{model_bytes / per / 1e9:.1f} GB/s achieved, bound "
        f"{bound * 1e3:.4f} ms/iter ({bound / per * 100:.1f}% of it)")
    profile_solve(lambda: zero_solve(solvers[lo_it], bv, x),
                  f"{nx}^3 {lo_it} fixed iterations")
    return launches


# ---- the batched multi-RHS slice (KSP.solve_many) -----------------------------

def phase_many_kernel_checks():
    """The two batched kernels vs their plain versions on the card: f32 and
    f64, k in {1, 3, 8}, shapes (128,128,128), (17,9,33), (4,4,4), random
    and null (zero) halos. ``A U`` must be bit-exact with the plain version,
    the per-column dots within the single-RHS dot's limit, and every column
    bit-equal (``A u`` and dot) to one ``stencil7_apply``/``stencil7_dot``
    launch on it. Returns the largest f32 errors per kernel."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    worst = {"stencil7_apply_many": 0.0, "stencil7_dot_many": 0.0,
             "dot_many_rel": 0.0}
    dot_tol = {torch.float32: 1e-4, torch.float64: 1e-12}
    seed = 500
    for dtype in (torch.float32, torch.float64):
        for k in (1, 3, K_BATCH):
            for shape in ((128, 128, 128), (17, 9, 33), (4, 4, 4)):
                for halos in (True, False):
                    seed += 1
                    g = torch.Generator(device="cuda").manual_seed(seed)
                    mk = lambda *sh: torch.rand(sh, generator=g, device="cuda",
                                                dtype=dtype)
                    U = mk(k, *shape)
                    lo, hi = ((mk(k, *shape[1:]), mk(k, *shape[1:])) if halos
                              else (None, None))
                    Y = st.stencil3d_apply_many(U, lo, hi)
                    Yd, d = st.stencil3d_dot_many(U, lo, hi)
                    Yp, dp = st.stencil3d_dot_many_plain(U, lo, hi)
                    e_apply = float((Y - Yp).abs().max())
                    e_doty = float((Yd - Yp).abs().max())
                    e_dot = float(((d - dp).abs() / dp.abs()).max())
                    zero = U.new_zeros(shape[1:])
                    same = True
                    for j in range(k):
                        lj, hj = (lo[j], hi[j]) if halos else (None, None)
                        y1 = st.stencil3d_apply(U[j], lj, hj)
                        y2, d2 = st.stencil3d_dot(U[j], lj if halos else zero,
                                                  hj if halos else zero)
                        same = (same and torch.equal(y1, Y[j])
                                and torch.equal(y2, Yd[j])
                                and torch.equal(d2, d[j]))
                    torch.cuda.synchronize()
                    label = (f"{str(dtype)[6:]} k={k} {shape} "
                             f"{'random' if halos else 'null'} halos")
                    log(f"check many {label}: apply max|err| {e_apply:.3e}, "
                        f"dot y max|err| {e_doty:.3e}, dot max rel err "
                        f"{e_dot:.3e}, columns equal single launches {same}")
                    check(e_apply == 0.0 and e_doty == 0.0,
                          f"many kernels not bit-exact, {label}")
                    check(e_dot <= dot_tol[dtype], f"dot_many {label}: {e_dot}")
                    check(same, f"a column differs from its single-RHS launch, "
                                f"{label}")
                    if dtype == torch.float32:
                        worst["stencil7_apply_many"] = max(
                            worst["stencil7_apply_many"], e_apply)
                        worst["stencil7_dot_many"] = max(
                            worst["stencil7_dot_many"], e_doty)
                        worst["dot_many_rel"] = max(worst["dot_many_rel"], e_dot)
                    del U, lo, hi, Y, Yd, d, Yp, dp
        torch.cuda.empty_cache()
    return worst


def phase_many_kernel_times(n, k=K_BATCH):
    """kernel/plain/library/bound times of the batched kernels at k slabs
    of n^3 f32; the library yardstick of the apply is cuDNN's conv3d with
    batch k (none for the dot)."""
    import torch
    import torch.nn.functional as F
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(13)
    U = torch.rand((k, n, n, n), generator=g, device="cuda")
    lo = torch.rand((k, n, n), generator=g, device="cuda")
    hi = torch.rand((k, n, n), generator=g, device="cuda")
    Y = torch.empty_like(U)
    big = n >= 512
    inner, slow = (10, 2) if big else (50, 10)
    reps = 10 if big else 25
    ext = torch.cat([lo[:, None], U, hi[:, None]], dim=1)[:, None]
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda")
    w[0, 0, 1, 1, 1] = 6.0
    for dz, dy, dx in [(0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)]:
        w[0, 0, dz, dy, dx] = -1.0
    conv = lambda: F.conv3d(ext, w, padding=(0, 1, 1))
    ref = st.stencil3d_apply_many_plain(U, lo, hi)
    scale = float(ref.abs().max())
    e_conv = float((conv()[:, 0] - ref).abs().max())
    e_apply = float((st.stencil3d_apply_many(U, lo, hi, out=Y) - ref).abs().max())
    Yd, d = st.stencil3d_dot_many(U, lo, hi)
    e_dot = float((Yd - ref).abs().max())
    dref = (U * ref).sum(dim=(1, 2, 3))
    e_sum = float(((d - dref).abs() / dref.abs()).max())
    del Yd, dref, ref
    check(e_apply == 0.0 and e_dot == 0.0,
          f"many kernels at {k} x {n}^3 not bit-exact: {e_apply}, {e_dot}")
    check(e_sum <= 1e-4, f"dot_many sums at {k} x {n}^3: rel {e_sum}")
    check(e_conv <= 1e-5 * scale, f"conv3d yardstick {k} x {n}^3: {e_conv}")
    lib_ms = device_ms(conv, slow, reps=5 if big else reps)
    del ext
    torch.cuda.empty_cache()
    out = {}
    for name, kern, plain, dot in [
            ("stencil7_apply_many",
             lambda: st.stencil3d_apply_many(U, lo, hi, out=Y),
             lambda: st.stencil3d_apply_many_plain(U, lo, hi), False),
            ("stencil7_dot_many",
             lambda: st.stencil3d_dot_many(U, lo, hi, out=Y),
             lambda: st.stencil3d_dot_many_plain(U, lo, hi), True)]:
        b_ms, b_by = bound_ms(n, n, n, 4, dot, k)
        out[name] = {"ms": device_ms(kern, inner, reps),
                     "plain_ms": device_ms(plain, slow, reps=5 if big else reps),
                     "library_ms": None if dot else lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": e_dot if dot else e_apply}
        r = out[name]
        log(f"time {name} k={k} {n}^3 f32: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / r['ms'] * 100:.1f}% of it), "
            f"{'conv3d ' + format(lib_ms, '.4f') + ' ms' if not dot else 'no one-call library equivalent'}"
            f", achieved {k * (2 * n**3 + 2 * n * n) * 4 / r['ms'] / 1e6:.1f} GB/s")
        torch.cuda.empty_cache()
    log(f"time conv3d batch {k} {n}^3: max|conv3d - plain| {e_conv:.3e}, "
        f"dot_many sum max rel err {e_sum:.3e}")
    del U, lo, hi, Y, d
    torch.cuda.empty_cache()
    return out


def bench_block(comm, op, b, k=K_BATCH):
    """bench.py:187-193 on the card: ``B = [b] + (k - 1)`` columns
    ``A rand`` from ``default_rng(11)``; returns the host block ``(n, k)``
    and its columns as Vecs on the card."""
    import mpi_petsc4py_example_tpu_torch as pt
    rng = np.random.default_rng(11)
    cols = [b] + [op.mult(pt.Vec.from_global(
        comm, rng.random(op.shape[0]).astype(np.float32))).to_numpy()
        for _ in range(k - 1)]
    B = np.stack(cols, axis=1)
    return B, [pt.Vec.from_global(comm, c, layout=op.layout) for c in cols]


def scipy_cg(A, b, rtol):
    import scipy.sparse.linalg as spla
    M = spla.LinearOperator(A.shape, matvec=lambda v: v / 6.0)
    x, info = spla.cg(A, b, rtol=rtol, atol=0.0, maxiter=20000, M=M)
    return x, info


def phase_many_main_path(oracle):
    """128^3 f32, k = 8, rtol 1e-6, CG + Jacobi through ``KSP.solve_many``
    as bench.py's batched episode sets it up, launch counters zeroed just
    before the solve and read just after: every column converged, held to
    bench.py:334's parity rule against scipy's fp64 CG, within 2% of its
    own sequential solve's iterations; ``stencil7_dot_many`` launched
    max(iterations) + 1 times, no single-RHS kernel; host syncs 1 +
    max(iterations); warm walls; a profiled solve."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    nx, rtol, k = oracle["nx"], 1e-6, K_BATCH
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    B, Bv = bench_block(comm, op, oracle["b"], k)
    ksp = cg_jacobi(comm, op, rtol)
    Xv = [op.get_vecs()[0] for _ in range(k)]
    torch.cuda.synchronize()
    reset_launches()
    res = ksp.solve_many(Bv, Xv)
    launches = read_launches()
    torch.cuda.synchronize()
    its = res.iterations
    log(f"many main path {nx}^3 f32 k={k} CG+jacobi: iterations {its}, "
        f"{res.reason_names}, wall {res.wall_time * 1e3:.1f} ms (first "
        f"solve), host syncs {res.host_syncs}, launches {launches}")
    check(res.converged, f"many main path did not converge: {res}")
    check(launches["stencil7_dot_many"] == max(its) + 1,
          f"dot_many launches {launches['stencil7_dot_many']} != "
          f"max(iterations) + 1")
    check(all(v == 0 for name, v in launches.items()
              if name != "stencil7_dot_many"),
          f"the batched fast path launched other kernels: {launches}")
    check(res.host_syncs == 1 + max(its),
          f"host syncs {res.host_syncs} != 1 + max(iterations)")
    X = np.stack([x.to_numpy() for x in Xv], axis=1)
    walls = [ksp.solve_many(Bv, Xv).wall_time for _ in range(3)]
    warm = statistics.median(walls)
    per_iter = warm / max(its) * 1e3
    k1 = oracle["k1_ms_per_iter"]
    log(f"many main path warm: median wall {warm * 1e3:.2f} ms (samples "
        f"{[round(w * 1e3, 2) for w in walls]}), {per_iter:.4f} ms per "
        f"lockstep iteration, {per_iter / k:.4f} ms per RHS-iteration; k=1 "
        f"in this run {k1:.4f} ms/iter ({k1 / (per_iter / k):.2f}x per "
        f"RHS-iteration)")
    host = ksp.solve_many(B)
    log(f"many main path with host arrays in and out: wall "
        f"{host.wall_time * 1e3:.2f} ms (placement excluded, fetch included), "
        f"iterations {host.iterations}")
    check(host.iterations == its, "host-array solve iterations differ")
    idle = profile_solve(lambda: max(ksp.solve_many(Bv, Xv).iterations),
                         f"{nx}^3 k={k} solve_many")
    # every column against scipy's fp64 CG, and against its own sequential
    # port solve
    A = oracle["A"]
    t0 = time.perf_counter()
    seq_its, x_diff, parity = [], 0.0, True
    for j in range(k):
        bb = B[:, j].astype(np.float64)
        r_cpu = oracle["r_cpu"] if j == 0 else np.linalg.norm(
            bb - A @ scipy_cg(A, bb, rtol)[0])
        r_port = np.linalg.norm(bb - A @ X[:, j].astype(np.float64))
        ok = bool(r_port <= 10 * max(r_cpu, rtol * np.linalg.norm(bb)))
        parity = parity and ok
        x, _ = op.get_vecs()
        sres = ksp.solve(Bv[j], x)
        seq_its.append(sres.iterations)
        x_diff = max(x_diff, float(np.abs(x.to_numpy() - X[:, j]).max()
                                   / np.abs(X[:, j]).max()))
        log(f"  column {j}: rel residual {r_port / np.linalg.norm(bb):.3e} "
            f"(scipy {r_cpu / np.linalg.norm(bb):.3e}), parity {ok}; "
            f"sequential {sres.iterations} vs batched {its[j]} iterations")
    log(f"many main path: parity {parity} on all columns "
        f"({time.perf_counter() - t0:.1f} s with the oracles); sequential "
        f"iterations {seq_its}, batched {its}, equal {seq_its == its}; max "
        f"|x_batched - x_seq| / max|x| {x_diff:.3e}")
    check(parity, "many main path: residual parity rule of bench.py:334 failed")
    check(all(abs(a - b) <= 0.02 * b for a, b in zip(its, seq_its)),
          f"batched iterations {its} not within 2% of sequential {seq_its}")
    ctx = {"comm": comm, "op": op, "B": B, "Bv": Bv, "iterations": its,
           "X": X, "per_iter_ms": per_iter, "idle": idle}
    return launches, ctx


def phase_many_general_route(ctx):
    """The same batch with Amat != Pmat (``set_operators(op, op_p)``, PC
    jacobi built on a second operator): the general batched route, whose
    operator apply is ``stencil7_apply_many``, launched max(iterations) + 1
    times; per-column iterations within 2% of the fast path's."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm, op, Bv = ctx["comm"], ctx["op"], ctx["Bv"]
    op_p = pt.StencilPoisson3D(comm, op.nx, dtype=op.dtype)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op, op_p)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=1e-6, atol=0.0, max_it=20000)
    Xv = [op.get_vecs()[0] for _ in Bv]
    torch.cuda.synchronize()
    reset_launches()
    res = ksp.solve_many(Bv, Xv)
    launches = read_launches()
    torch.cuda.synchronize()
    its, fast = res.iterations, ctx["iterations"]
    X = np.stack([x.to_numpy() for x in Xv], axis=1)
    x_diff = float(np.abs(X - ctx["X"]).max() / np.abs(ctx["X"]).max())
    log(f"many general route (Amat != Pmat): iterations {its} (fast path "
        f"{fast}), {res.reason_names}, wall {res.wall_time * 1e3:.1f} ms, "
        f"launches {launches}, max|x - x_fast| / max|x| {x_diff:.3e}")
    check(res.converged, f"general route did not converge: {res}")
    check(launches["stencil7_apply_many"] == max(its) + 1,
          f"apply_many launches {launches['stencil7_apply_many']} != "
          f"max(iterations) + 1")
    check(all(v == 0 for name, v in launches.items()
              if name != "stencil7_apply_many"),
          f"the general route launched other kernels: {launches}")
    check(all(abs(a - b) <= 0.02 * b for a, b in zip(its, fast)),
          f"general route iterations {its} not within 2% of {fast}")
    return launches


def phase_many_mixed(ctx):
    """A mixed batch on the card, fp64: column 0 the exact eigenvector
    sin x sin x sin (a one-dimensional Krylov space), column 1 bench's b.
    The easy column freezes within 3 iterations while the other runs on
    (the masked-select path), and each equals its solo solve. fp64 because
    in fp32 the eigenvector's rounding, amplified by lambda_max/lambda_min
    (about 6600 at 128^3), leaves a 4e-4 relative residual after the first
    step: the column is not easy there."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm, nx = ctx["comm"], ctx["op"].nx
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    v = np.sin(np.pi * np.arange(1, nx + 1) / (nx + 1))
    cols = [pt.Vec.from_global(comm, np.kron(np.kron(v, v), v),
                               layout=op.layout),
            pt.Vec.from_global(comm, ctx["B"][:, 0].astype(np.float64),
                               layout=op.layout)]
    ksp = cg_jacobi(comm, op, 1e-6)
    Xv = [op.get_vecs()[0] for _ in cols]
    res = ksp.solve_many(cols, Xv)
    solo = []
    for j, bv in enumerate(cols):
        x, _ = op.get_vecs()
        r = ksp.solve(bv, x)
        solo.append((r.iterations, float((x.data - Xv[j].data).abs().max()
                                         / x.data.abs().max())))
    torch.cuda.synchronize()
    log(f"many mixed batch (fp64): iterations {res.iterations}, "
        f"{res.reason_names}; solo (iterations, max|x_batched - x_solo| / "
        f"max|x|) {solo}")
    its = res.iterations
    check(res.converged and its[0] <= 3 and its[1] > its[0] + 5,
          f"mixed batch: {res}")
    check(all(s[0] == i and s[1] <= 1e-12 for s, i in zip(solo, its)),
          f"mixed batch columns differ from their solo solves: {solo}")


def phase_many_realistic(k=K_BATCH):
    """512^3 f32 with k = 8 columns A rand: the delta-method per-iteration
    time of fixed-iteration (norm none) batched solves against the k x
    11-pass bound, peak memory, then one converged solve (counters zeroed
    before, read after) with every column's fp64 true residual computed on
    the card through ``local_spmv_many`` in f64."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    nx, rtol = 512, 1e-6
    n = nx ** 3
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(17)
    Bv = []
    for _ in range(k):
        xt = pt.Vec(comm, n, data=torch.rand(n, generator=g, device="cuda"))
        Bv.append(op.mult(xt))
        del xt
    Xv = [op.get_vecs()[0] for _ in range(k)]
    lo_it, hi_it = 20, 120
    solvers = {m: cg_jacobi(comm, op, 0.0, max_it=m, norm_none=True)
               for m in (lo_it, hi_it)}
    solvers[lo_it].solve_many(Bv, Xv)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_iter = []
    for _ in range(3):
        walls = {}
        for m, ksp in solvers.items():
            t0 = time.perf_counter()
            r = ksp.solve_many(Bv, Xv)
            walls[m] = (time.perf_counter() - t0, max(r.iterations))
        (w_lo, i_lo), (w_hi, i_hi) = walls[lo_it], walls[hi_it]
        per_iter.append((w_hi - w_lo) / (i_hi - i_lo))
    peak_fixed = torch.cuda.max_memory_allocated() / 2**30
    per = statistics.median(per_iter)
    bound = k * PASSES_PER_ITER * n * 4 / HBM_BYTES_PER_S
    log(f"512^3 k={k} delta-method: {per * 1e3:.4f} ms per lockstep "
        f"iteration (samples {[round(p * 1e3, 4) for p in per_iter]}), "
        f"{per * 1e3 / k:.4f} ms per RHS-iteration; bound k x 11 passes "
        f"{bound * 1e3:.4f} ms ({bound / per * 100:.1f}% of it); peak "
        f"{peak_fixed:.2f} GiB")
    profile_solve(lambda: max(solvers[lo_it].solve_many(Bv, Xv).iterations),
                  f"512^3 k={k} {lo_it} fixed iterations")
    del solvers
    ksp = cg_jacobi(comm, op, rtol)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = ksp.solve_many(Bv, Xv)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    its = res.iterations
    log(f"512^3 k={k} f32 CG+jacobi solve_many: iterations {its}, "
        f"{res.reason_names}, wall {res.wall_time:.3f} s, "
        f"{res.wall_time / max(its) * 1e3:.4f} ms per lockstep iteration, "
        f"host syncs {res.host_syncs}, peak {peak:.2f} GiB, launches {launches}")
    check(res.converged, f"512^3 k={k} solve did not converge: {res}")
    check(launches["stencil7_dot_many"] == max(its) + 1,
          f"512^3 dot_many launches {launches['stencil7_dot_many']}")
    op64 = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    X64 = torch.stack([x.data.double().view(1, -1) for x in Xv], dim=1)
    AX = op64.local_spmv_many(comm)(X64)
    del X64
    rels = []
    for j, bv in enumerate(Bv):
        b64 = bv.data.double()
        rels.append(float(torch.linalg.vector_norm(b64 - AX[0, j])
                          / torch.linalg.vector_norm(b64)))
        del b64
    log(f"512^3 k={k} fp64 true relative residuals {[f'{r:.3e}' for r in rels]} "
        f"(limit {10 * rtol:g})")
    check(all(r <= 10 * rtol for r in rels), f"512^3 k={k} true residuals {rels}")
    del AX, Bv, Xv
    torch.cuda.empty_cache()
    return launches


# ---- the assembled-matrix slice (Mat, GMRES/BiCGStab/preonly, bjacobi/lu) ----

def aij_ksp(comm, mat, ksp_type, pc_type, rtol, max_it=20000, gate=False,
            margin=1.0, norm_none=False):
    import mpi_petsc4py_example_tpu_torch as pt
    ksp = pt.KSP().create(comm)
    ksp.set_operators(mat)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    ksp.set_true_residual_check(gate)
    ksp.true_residual_margin = margin
    if norm_none:
        ksp.set_norm_type("none")
    return ksp


def manufactured(A, seed=0):
    """benchmarks/run_all.py:103: x from default_rng(seed), b = A x, f32."""
    x = np.random.default_rng(seed).random(A.shape[0]).astype(np.float32)
    return (A @ x).astype(np.float32)


def true_relres(A, x, b):
    """The fp64 true relative residual on the host."""
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b - A @ np.asarray(x, dtype=np.float64))
                 / np.linalg.norm(b))


def assemble(comm, A, dtype):
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    t0 = time.perf_counter()
    m = pt.Mat.from_scipy(comm, A, dtype=dtype)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def delta_per_iter(solvers, bv, x, reps=3):
    """bench.py:101-136's delta method: the wall of two fixed-iteration
    solves (norm type none), their difference over the iteration
    difference; the median of ``reps`` pairs."""
    (lo, k_lo), (hi, k_hi) = sorted(solvers.items())
    per = []
    for _ in range(reps):
        walls = {}
        for m, k in ((lo, k_lo), (hi, k_hi)):
            x.zero()
            t0 = time.perf_counter()
            r = k.solve(bv, x)
            walls[m] = (time.perf_counter() - t0, r.iterations)
        per.append((walls[hi][0] - walls[lo][0])
                   / (walls[hi][1] - walls[lo][1]))
    return statistics.median(per), per


def spmv_times(comm, mat, A):
    """Device ms of one ``Mat.local_spmv`` product (CUDA events), its bound
    (the operator's bytes: DIA values or ELL columns and values, x read
    once, y written once, over the HBM rate) and one PyTorch CSR product of
    the same matrix (``torch.sparse_csr_tensor @ x``) as the yardstick."""
    import torch
    n = A.shape[0]
    x = torch.rand(n, device=comm.device, dtype=mat.dtype)
    spmv = mat.local_spmv(comm)
    xs = x.view(comm.size, -1)
    ms = device_ms(lambda: spmv(xs), inner=20)
    item = mat.dtype.itemsize
    if mat.dia_vals is not None:
        op_bytes = mat.dia_vals.numel() * item
    else:
        op_bytes = mat.ell_vals.numel() * (item + mat.ell_cols.element_size())
    nbytes = op_bytes + 2 * n * item
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    C = A.tocsr()
    Ct = torch.sparse_csr_tensor(
        torch.from_numpy(C.indptr.astype(np.int64)),
        torch.from_numpy(C.indices.astype(np.int64)),
        torch.from_numpy(C.data.astype(np.float32 if item == 4
                                       else np.float64)),
        size=C.shape).to(comm.device)
    lib = device_ms(lambda: Ct @ x, inner=20)
    y = spmv(xs).reshape(-1)[:n]
    err = float((y - Ct @ x).abs().max() / (Ct @ x).abs().max())
    return {"route": mat.spmv_route(comm), "ms": ms, "bound_ms": bound,
            "bytes": nbytes, "library_ms": lib, "rel_err_vs_library": err}


def phase_aij_main(oracle):
    """128^3 f32 (2,097,152 rows) Poisson assembled as a Mat (DIA route), CG
    + Jacobi, rtol 1e-6, on bench.py's b: iterations within 2% of the
    stencil path's in this run, bench.py:334's parity rule against scipy's
    fp64 CG, host syncs, the assembly breakdown, delta-method per-iteration
    times of the AIJ and the stencil path in turns, the DIA product against
    its bound and a profiled solve."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    nx, rtol = oracle["nx"], 1e-6
    comm = pt.DeviceComm()
    A = oracle["A"]
    m, assembly = assemble(comm, A, torch.float32)
    log(f"aij {nx}^3: assembly {assembly:.3f} s {m.assembly_breakdown}, "
        f"route {m.spmv_route(comm)}, program_key {m.program_key()}, "
        f"{m.get_info()}")
    check(m.spmv_route(comm) == "dia-gathered", "128^3 AIJ not on DIA")
    bv = pt.Vec.from_global(comm, oracle["b"], dtype=torch.float32)
    ksp = aij_ksp(comm, m, "cg", "jacobi", rtol)
    x, _ = m.get_vecs()
    res = ksp.solve(bv, x)
    its, its_st = res.iterations, oracle["iterations"]
    r_port = np.linalg.norm(oracle["b"].astype(np.float64)
                            - A @ x.to_numpy().astype(np.float64))
    parity = bool(r_port <= 10 * max(oracle["r_cpu"],
                                     rtol * oracle["bnorm"]))
    log(f"aij {nx}^3 f32 CG+jacobi: {its} iterations ({res.reason_name}; "
        f"stencil path {its_st} in this run), wall {res.wall_time * 1e3:.1f}"
        f" ms, host syncs {res.host_syncs} ({(res.host_syncs - 1) / its:.3f}"
        f"/iter), rel residual {r_port / oracle['bnorm']:.3e}, parity "
        f"{parity}")
    check(res.converged, f"128^3 AIJ did not converge: {res}")
    check(abs(its - its_st) <= 0.02 * its_st,
          f"AIJ iterations {its} not within 2% of the stencil's {its_st}")
    check(parity, "128^3 AIJ: residual parity rule of bench.py:334 failed")
    check(res.host_syncs == 1 + its, "AIJ host syncs != 1 + iterations")
    x.zero()
    warm = ksp.solve(bv, x)
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    lo, hi = 20, 220
    per = {}
    for name, mat in (("aij", m), ("stencil", op), ("aij2", m),
                      ("stencil2", op)):
        solvers = {k: aij_ksp(comm, mat, "cg", "jacobi", 0.0, max_it=k,
                              norm_none=True) for k in (lo, hi)}
        xx, _ = mat.get_vecs()
        per[name] = delta_per_iter(solvers, bv, xx)
    log(f"aij {nx}^3 delta method (ms/iter, aij, stencil, aij, stencil): "
        + ", ".join(f"{name} {p * 1e3:.4f} (samples "
                    f"{[round(q * 1e3, 4) for q in s]})"
                    for name, (p, s) in per.items())
        + f"; warm wall {warm.wall_time / warm.iterations * 1e3:.4f} ms/iter")
    sp = spmv_times(comm, m, A)
    log(f"aij {nx}^3 DIA spmv: {sp['ms']:.4f} ms, bound {sp['bound_ms']:.4f}"
        f" ms ({sp['bytes'] / 1e6:.1f} MB; {sp['bound_ms'] / sp['ms'] * 100:.1f}"
        f"% of it), torch sparse CSR {sp['library_ms']:.4f} ms, max rel diff "
        f"{sp['rel_err_vs_library']:.2e}")
    idle = profile_solve(lambda: zero_solve(ksp, bv, x),
                         f"{nx}^3 AIJ CG+jacobi")
    return {"iterations": its, "per_iter_ms": per["aij"][0] * 1e3,
            "stencil_per_iter_ms": per["stencil"][0] * 1e3,
            "assembly_s": assembly, "spmv": sp, "idle": idle}


def phase_aij_cfg1(nx=64):
    """cfg1 (benchmarks/run_all.py:340-367): 64^3 Poisson assembled, f32, CG
    + none, rtol 1e-6, the true-residual gate on with margin 0.5."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    rtol = 1e-6
    comm = pt.DeviceComm()
    A = pt.poisson3d_csr(nx).astype(np.float64)
    b = manufactured(A)
    m, assembly = assemble(comm, A, torch.float32)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    ksp = aij_ksp(comm, m, "cg", "none", rtol, gate=True, margin=0.5)
    x, _ = m.get_vecs()
    first = ksp.solve(bv, x)
    x.zero()
    t0 = time.perf_counter()
    res = ksp.solve(bv, x)
    wall = time.perf_counter() - t0
    rel = true_relres(A, x.to_numpy(), b)
    log(f"cfg1 {nx}^3 f32 CG+none gate(0.5): {res.iterations} iterations, "
        f"{res.reason_name}, re-entries {ksp._last_reentries}, fp64 true rel "
        f"residual {rel:.3e}, warm wall {wall * 1e3:.2f} ms "
        f"({wall / res.iterations * 1e3:.4f} ms/iter; first solve "
        f"{first.wall_time * 1e3:.1f} ms), host syncs {res.host_syncs}, "
        f"assembly {assembly:.3f} s {m.assembly_breakdown}")
    check(res.converged and rel <= 1.05 * rtol, f"cfg1: {res}, {rel}")
    return {"iterations": res.iterations, "true_relres": rel,
            "reentries": ksp._last_reentries, "wall_s": wall,
            "assembly_s": assembly}


def phase_aij_ell(nx=64):
    """The ELL route: 64^3 Poisson under a seeded symmetric permutation
    (seed 5) has more occupied diagonals than the DIA cap, so the Mat takes
    ELL; CG + Jacobi f32 within 2% of the unpermuted (DIA) solve's
    iterations."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    rtol = 1e-6
    comm = pt.DeviceComm()
    A = pt.poisson3d_csr(nx).astype(np.float64)
    p = np.random.default_rng(5).permutation(A.shape[0])
    Ap = A[p][:, p].tocsr()
    b = manufactured(A, seed=7)
    out = {}
    for name, M, bb in (("dia", A, b), ("ell", Ap, b[p])):
        m, assembly = assemble(comm, M, torch.float32)
        bv = pt.Vec.from_global(comm, bb, dtype=torch.float32)
        ksp = aij_ksp(comm, m, "cg", "jacobi", rtol)
        x, _ = m.get_vecs()
        ksp.solve(bv, x)
        x.zero()
        res = ksp.solve(bv, x)
        sp = spmv_times(comm, m, M)
        out[name] = res.iterations
        log(f"aij route {name}: {nx}^3 route {m.spmv_route(comm)}, program_key "
            f"{m.program_key()}, K {m.K}, {res.iterations} iterations "
            f"{res.reason_name}, warm {res.wall_time / res.iterations * 1e3:.4f}"
            f" ms/iter, fp64 true rel residual "
            f"{true_relres(M, x.to_numpy(), bb):.3e}, assembly {assembly:.3f}"
            f" s; spmv {sp['ms']:.4f} ms vs bound {sp['bound_ms']:.4f} ms, "
            f"torch sparse CSR {sp['library_ms']:.4f} ms")
        check(res.converged, f"{name} route did not converge: {res}")
        check(m.spmv_route(comm).startswith(name), f"{name}: wrong route")
    check(abs(out["ell"] - out["dia"]) <= 0.02 * out["dia"],
          f"ELL iterations {out['ell']} vs DIA {out['dia']}")
    return out


def phase_aij_cfg3(nx=512):
    """cfg3 (benchmarks/run_all.py:497-518): GMRES(30) + Jacobi on 512^2
    Poisson, f32, rtol 1e-6, the true-residual gate with margin 1.0."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    rtol = 1e-6
    comm = pt.DeviceComm()
    A = poisson2d_csr(nx)
    b = manufactured(A)
    m, assembly = assemble(comm, A, torch.float32)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    ksp = aij_ksp(comm, m, "gmres", "jacobi", rtol, max_it=40000, gate=True,
                  margin=1.0)
    x, _ = m.get_vecs()
    first = ksp.solve(bv, x)
    res = ksp.solve(bv, x)
    rel = true_relres(A, x.to_numpy(), b)
    cycles = res.iterations // ksp.restart
    log(f"cfg3 {nx}^2 f32 GMRES(30)+jacobi gate(1.0): {res.iterations} "
        f"iterations ({cycles} cycles), {res.reason_name}, re-entries "
        f"{ksp._last_reentries}, fp64 true rel residual {rel:.3e}, wall "
        f"{res.wall_time:.3f} s ({res.wall_time / res.iterations * 1e3:.4f} "
        f"ms/iter, {res.wall_time / max(cycles, 1) * 1e3:.3f} ms/cycle; first "
        f"solve {first.wall_time:.3f} s), host syncs {res.host_syncs}, "
        f"assembly {assembly:.3f} s")
    check(res.converged and rel <= 1.05 * rtol, f"cfg3: {res}, {rel}")
    return {"iterations": res.iterations, "true_relres": rel,
            "wall_s": res.wall_time, "syncs": res.host_syncs}


def phase_aij_cfg4(nx=256):
    """cfg4 (benchmarks/run_all.py:521-549): BiCGStab + block Jacobi on
    256^2 convection-diffusion (beta 0.4), f32, rtol 1e-6, the gate with
    the benchmark's margin 0.5; the auto-split gives 32 blocks of 2048,
    inverted on the card under -pc_setup_device auto and on the host under
    0, one solve each."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    rtol = 1e-6
    comm = pt.DeviceComm()
    A = convdiff2d(nx, beta=0.4)
    b = manufactured(A)
    m, assembly = assemble(comm, A, torch.float32)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    out = {}
    for placement, mode in (("auto", "device"), ("0", "host")):
        ksp = aij_ksp(comm, m, "bcgs", "bjacobi", rtol, gate=True,
                      margin=0.5)
        pc = ksp.get_pc()
        pc.setup_device = placement
        t0 = time.perf_counter()
        ksp.set_up()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        blocks = tuple(pc._arrays[0].shape)
        x, _ = m.get_vecs()
        first = ksp.solve(bv, x)
        res = ksp.solve(bv, x)
        rel = true_relres(A, x.to_numpy(), b)
        apply = pc.local_apply(comm, A.shape[0])
        r = torch.rand(1, A.shape[0], device=comm.device)
        ms = device_ms(lambda: apply(r), inner=10)
        bound = (pc._arrays[0].numel() + 2 * A.shape[0]) * 4 \
            / HBM_BYTES_PER_S
        log(f"cfg4 {nx}^2 f32 BCGS+bjacobi gate(0.5), -pc_setup_device "
            f"{placement}: {res.iterations} iterations, {res.reason_name}, "
            f"re-entries {ksp._last_reentries}, fp64 true rel residual "
            f"{rel:.3e}, wall {res.wall_time * 1e3:.2f} ms "
            f"({res.wall_time / res.iterations * 1e3:.4f} ms/iter; first "
            f"solve {first.wall_time * 1e3:.1f} ms), host syncs "
            f"{res.host_syncs}, PC setup {setup:.3f} s (mode "
            f"{pc.setup_mode} {pc.setup_breakdown}, blocks {blocks}), "
            f"assembly {assembly:.3f} s {m.assembly_breakdown}; bjacobi "
            f"apply {ms:.4f} ms vs bound {bound * 1e3:.4f} ms")
        check(pc.setup_mode == mode
              and (nx != 256 or blocks == (32, 2048, 2048)),
              f"cfg4 PC set-up {placement}: {pc.setup_mode} {blocks}")
        check(res.converged and rel <= 1.05 * rtol,
              f"cfg4 ({placement}): {res}, {rel}")
        out[placement] = {"iterations": res.iterations, "true_relres": rel,
                          "pc_setup_s": setup,
                          "breakdown": pc.setup_breakdown,
                          "reentries": ksp._last_reentries}
    return out


def phase_aij_many(nx=256, k=K_BATCH):
    """KSP.solve_many, k = 8, on 256^2 Poisson (65,536 rows), CG + block
    Jacobi (32 blocks of 2048), f32, rtol 1e-6: the batched route (one host
    read per lockstep iteration), each column against its sequential
    solve."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    rtol = 1e-6
    comm = pt.DeviceComm()
    A = poisson2d_csr(nx)
    B = (A @ np.random.default_rng(11).random((A.shape[0], k))).astype(
        np.float32)
    m, _ = assemble(comm, A, torch.float32)
    ksp = aij_ksp(comm, m, "cg", "bjacobi", rtol)
    ksp.set_up()
    res = ksp.solve_many(B)
    warm = ksp.solve_many(B)
    its = res.iterations
    check(res.converged, f"solve_many did not converge: {res}")
    check(res.host_syncs == 1 + max(its),
          f"solve_many host syncs {res.host_syncs}: not the batched route")
    seq_its, diff, seq_wall = [], 0.0, 0.0
    for j in range(k):
        x, b = m.get_vecs()
        b.set_global(B[:, j])
        s = ksp.solve(b, x)
        seq_its.append(s.iterations)
        seq_wall += s.wall_time
        diff = max(diff, float(np.abs(x.to_numpy() - res.X[:, j]).max()
                               / np.abs(res.X[:, j]).max()))
    rels = [true_relres(A, res.X[:, j], B[:, j]) for j in range(k)]
    log(f"aij solve_many {nx}^2 f32 k={k} CG+bjacobi: iterations {its}, "
        f"sequential {seq_its} (equal {seq_its == its}), max |x_batched - "
        f"x_seq| / max|x| {diff:.3e}; "
        f"warm batched wall {warm.wall_time * 1e3:.2f} ms "
        f"({warm.wall_time / max(its) * 1e3:.4f} ms per lockstep iteration), "
        f"sequential walls {seq_wall * 1e3:.2f} ms in all, host syncs "
        f"{res.host_syncs}, max fp64 true rel residual {max(rels):.3e}")
    # the batched block-Jacobi apply is one matrix product for the k
    # columns where the single apply is a matrix-vector product: their
    # roundings may differ, so as in the stencil's batched phase each column
    # is held within 2% of its sequential iterations (equality is logged)
    check(all(abs(a - b) <= 0.02 * b for a, b in zip(its, seq_its)),
          f"batched iterations {its} not within 2% of sequential {seq_its}")
    check(diff <= 1e-4, f"batched columns differ from sequential by {diff}")
    return {"iterations": its, "sequential": seq_its, "x_diff": diff}


def phase_aij_reference_flow(n_dense=4096):
    """The reference test.py flow through the port's runner and facade on
    the card (-n 1 and -n 4, preonly + lu + 'mumps', must print True); then
    a dense direct solve in f64 at n = 4096 (random_system(4096, seed 42,
    density 0.01), preonly + lu) with np.allclose(x, X), set up on the card
    (-pc_setup_device auto) and on the host (0)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import random_system
    root = os.path.dirname(os.path.abspath(__file__))
    driver = os.path.join(root, "mpi_petsc4py_example_tpu_torch", "facade",
                          "drivers", "solve_linear.py")
    for n in (1, 4):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "mpi_petsc4py_example_tpu_torch.run", "-n",
                            str(n), driver], capture_output=True, text=True,
                           timeout=600, cwd=root)
        out = r.stdout.strip().splitlines()
        log(f"test.py flow -n {n} on the card: rc {r.returncode}, printed "
            f"{out[-1] if out else None!r}, {time.perf_counter() - t0:.1f} s "
            f"(process included)")
        check(r.returncode == 0 and out and out[-1] == "True",
              f"test.py flow -n {n}: {r.stdout[-500:]} {r.stderr[-2000:]}")
    A, X, B = random_system(n_dense, seed=42, density=0.01)
    comm = pt.DeviceComm()
    m, assembly = assemble(comm, A, torch.float64)
    runs = {}
    for placement, mode in (("auto", "device"), ("0", "host")):
        ksp = pt.KSP().create(comm)
        ksp.set_operators(m)
        ksp.set_type("preonly")
        pc = ksp.get_pc()
        pc.set_type("lu")
        pc.set_factor_solver_type("mumps")
        pc.setup_device = placement
        t0 = time.perf_counter()
        ksp.set_up()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        x, b = m.get_vecs()
        b.set_global(B)
        res = ksp.solve(b, x)
        ok = bool(np.allclose(x.to_numpy(), X))
        err = float(np.abs(x.to_numpy() - X).max())
        log(f"dense direct f64 n={n_dense}, -pc_setup_device {placement}: "
            f"route {m.spmv_route(comm)}, lu mode {pc.kind}, PC setup "
            f"{setup:.3f} s ({pc.setup_mode} {pc.setup_breakdown}), solve "
            f"{res.wall_time * 1e3:.2f} ms (host syncs {res.host_syncs}, "
            f"refinement included), residual {res.residual_norm:.3e}, "
            f"max|x - X| {err:.3e}, allclose {ok}, assembly {assembly:.3f} s")
        check(pc.kind == "lu" and pc.setup_mode == mode,
              f"n={n_dense} lu set-up {placement}: {pc.kind} "
              f"{pc.setup_mode}")
        check(ok, f"n={n_dense} direct solve ({placement}): "
                  "np.allclose(x, X) is False")
        runs[placement] = {"pc_setup_s": setup, "solve_s": res.wall_time,
                          "max_err": err, "breakdown": pc.setup_breakdown}
    return runs


# ---- the eigensolver slice (EPS Krylov-Schur, ST) -----------------------------

EPS_NX = 128          # 2,097,152 rows, fp64
EPS_MAX_IT = 400      # 128^3 needs more than the default 100 restarts


def stencil_extremes(nx):
    """The largest and smallest eigenvalues of the 7-point Dirichlet
    Laplacian on nx^3, in closed form: 6 -+ 6 cos(pi/(nx+1))."""
    c = float(np.cos(np.pi / (nx + 1)))
    return 6.0 + 6.0 * c, 6.0 - 6.0 * c


def eps_hep(comm, op, which, ncv=16, max_it=EPS_MAX_IT, tol=1e-8, nev=1):
    import mpi_petsc4py_example_tpu_torch as pt
    E = pt.EPS().create(comm).set_operators(op).set_problem_type("hep")
    E.set_which_eigenpairs(which).set_dimensions(nev=nev, ncv=ncv)
    return E.set_tolerances(tol=tol, max_it=max_it)


def expected_eps_applies(ncv, restarts, nev=1):
    """Operator applies of one Krylov-Schur solve: ncv for the first
    factorization, ncv - k_keep for each restart after it (k_keep =
    min(max(nev, ncv // 2), ncv - 1), the JAX package's eps.py:1302)."""
    k_keep = min(max(nev, ncv // 2), ncv - 1)
    return ncv + (restarts - 1) * (ncv - k_keep)


def eps_basis_bound_ms(ncv, n, itemsize=8, nev=1):
    """The least time of one restart's basis passes: each of its ncv -
    k_keep CGS2 steps j reads the j+1 built rows of the basis twice for its
    projections and twice for its updates, over the HBM rate."""
    k = min(max(nev, ncv // 2), ncv - 1)
    rows = (ncv * (ncv + 1) - k * (k + 1)) // 2
    return 4 * rows * n * itemsize / HBM_BYTES_PER_S * 1e3


def eps_solve_counted(E):
    """One solve with the launch counters zeroed just before and read just
    after; ``(launches, wall_s)``."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    E.solve()
    torch.cuda.synchronize()
    return read_launches(), time.perf_counter() - t0


def phase_eps_apply_times(nx=EPS_NX):
    """``stencil7_apply`` at the EPS path's shape and dtype (one 128^3 fp64
    slab): kernel, plain and conv3d times and the bound."""
    import torch
    import torch.nn.functional as F
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    u, lo, hi = random_slab((nx, nx, nx), torch.float64, 21)
    y = torch.empty_like(u)
    ref = st.stencil3d_apply_plain(u, lo, hi)
    err = float((st.stencil3d_apply(u, lo, hi, out=y) - ref).abs().max())
    check(err <= 1e-13 * float(ref.abs().max()), f"apply {nx}^3 f64: {err}")
    ext = torch.cat([lo[None], u, hi[None]])[None, None]
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda", dtype=torch.float64)
    w[0, 0, 1, 1, 1] = 6.0
    for dz, dy, dx in [(0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1),
                       (1, 1, 0), (1, 1, 2)]:
        w[0, 0, dz, dy, dx] = -1.0
    conv = lambda: F.conv3d(ext, w, padding=(0, 1, 1))
    b_ms, b_by = bound_ms(nx, nx, nx, 8, False)
    out = {"ms": device_ms(lambda: st.stencil3d_apply(u, lo, hi, out=y), 100),
           "plain_ms": device_ms(lambda: st.stencil3d_apply_plain(u, lo, hi),
                                 100),
           "library_ms": device_ms(conv, 20), "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": err}
    log(f"time stencil7_apply {nx}^3 f64 (the EPS path's shape): kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, conv3d "
        f"{out['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max|err| {err:.3e}")
    del u, lo, hi, y, ref, ext
    torch.cuda.empty_cache()
    return out


def phase_eps_main(nx=EPS_NX):
    """Krylov-Schur on the 128^3 fp64 stencil, nev 1, tol 1e-8, max_it 400,
    the largest magnitude and the smallest real, at ncv 16 (the default)
    and ncv 32: each eigenvalue against its closed form within 1e-9
    relative, compute_error(0) <= 1e-6, host reads = restarts + 1, and the
    ``stencil7_apply`` launches of the solve equal to
    ``expected_eps_applies`` (compute_error adds exactly one); then the
    warm wall and a profiled solve (device busy per restart, idle share,
    the share of the basis products)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    hi, lo = stencil_extremes(nx)
    out, total = {}, 0
    for ncv in (16, 32):
        basis_ms = eps_basis_bound_ms(ncv, nx ** 3)
        log(f"eps {nx}^3 ncv {ncv}: the basis passes of one restart move "
            f"{basis_ms * HBM_BYTES_PER_S / 1e12:.2f} GB, bound "
            f"{basis_ms:.3f} ms")
        for which, want in (("largest_magnitude", hi), ("smallest_real", lo)):
            E = eps_hep(comm, op, which, ncv=ncv)
            torch.cuda.reset_peak_memory_stats()
            launches, wall = eps_solve_counted(E)
            restarts, res = E.get_iteration_number(), E.result
            lam = E.get_eigenvalue(0)
            rel = abs(lam.real - want) / abs(want)
            applies = expected_eps_applies(ncv, restarts)
            reset_launches()
            err = E.compute_error(0)
            err_launches = read_launches()["stencil7_apply"]
            log(f"eps {nx}^3 f64 {which} ncv {ncv}: {restarts} restarts, "
                f"nconv {E.get_converged()}, {res.reason_name}, lambda "
                f"{lam.real!r} (closed form {want!r}, rel err {rel:.3e}), "
                f"compute_error {err:.3e}, host syncs {res.host_syncs}, "
                f"wall {wall:.3f} s ({wall / restarts * 1e3:.3f} ms/restart),"
                f" stencil7_apply launches {launches['stencil7_apply']} "
                f"(expected {applies}) + {err_launches} for compute_error, "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            check(res.converged and E.get_converged() >= 1,
                  f"eps {which} ncv {ncv} did not converge: {res}")
            check(rel <= 1e-9, f"eps {which} ncv {ncv}: lambda rel err {rel}")
            check(err <= 1e-6, f"eps {which} ncv {ncv}: compute_error {err}")
            check(res.host_syncs == restarts + 1,
                  f"eps host syncs {res.host_syncs} != restarts + 1")
            check(launches["stencil7_apply"] == applies,
                  f"eps apply launches {launches['stencil7_apply']} != "
                  f"{applies}")
            check(err_launches == 1, "compute_error did not apply once")
            check(sum(launches.values()) == launches["stencil7_apply"],
                  f"eps launched other kernels: {launches}")
            total += launches["stencil7_apply"]
            E.solve()           # warm
            warm = E.result.wall_time
            log(f"eps {which} ncv {ncv} warm: wall {warm:.3f} s, "
                f"{warm / restarts * 1e3:.3f} ms/restart, "
                f"{warm / (applies) * 1e3:.4f} ms per factorization step")
            # a window of the first 10 restarts: the steady per-restart
            # cost, without the profiler's post-processing of every restart
            E.set_tolerances(max_it=10)
            idle = profile_solve(
                lambda E=E: E.solve().get_iteration_number(),
                f"eps {nx}^3 {which} ncv {ncv} (per restart)",
                ops=("aten::mv", "aten::matmul", "aten::copy_"))
            E.set_tolerances(max_it=EPS_MAX_IT)
            out[(which, ncv)] = {"restarts": restarts, "wall_s": wall,
                                 "warm_s": warm, "idle": idle,
                                 "lambda": lam.real,
                                 "launches": launches["stencil7_apply"]}
    return total, out


def phase_eps_plain(nx=32):
    """The plain path on the card (``force_plain``) at 32^3 fp64: the same
    restarts as the kernel path, the eigenvalue within 1e-12, and no kernel
    launched."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    for which in ("largest_magnitude", "smallest_real"):
        E = eps_hep(comm, op, which)
        launches, _ = eps_solve_counted(E)
        its, lam = E.get_iteration_number(), E.get_eigenvalue(0).real
        op.force_plain = True
        try:
            plain_launches, _ = eps_solve_counted(E)
        finally:
            op.force_plain = False
        p_its, p_lam = E.get_iteration_number(), E.get_eigenvalue(0).real
        log(f"eps {nx}^3 {which}: kernel path {its} restarts, lambda "
            f"{lam!r}, {launches['stencil7_apply']} launches; plain path "
            f"{p_its} restarts, lambda {p_lam!r}, "
            f"{sum(plain_launches.values())} launches")
        check(p_its == its and abs(p_lam - lam) <= 1e-12 * abs(lam),
              f"eps plain path {p_its}, {p_lam} vs {its}, {lam}")
        check(sum(plain_launches.values()) == 0,
              "the plain eps path launched kernels")
        check(launches["stencil7_apply"] == expected_eps_applies(16, its),
              "eps 32^3 kernel path launches")


def phase_eps_aij(stencil_restarts, nx=EPS_NX):
    """The assembled 128^3 Poisson matrix (DIA route), the largest
    magnitude: the closed form within 1e-9 and restarts within one of the
    stencil's."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    m, assembly = assemble(comm, pt.poisson3d_csr(nx), torch.float64)
    check(m.spmv_route(comm) == "dia-gathered", "128^3 f64 AIJ not on DIA")
    E = eps_hep(comm, m, "largest_magnitude")
    launches, wall = eps_solve_counted(E)
    its, lam = E.get_iteration_number(), E.get_eigenvalue(0).real
    want = stencil_extremes(nx)[0]
    rel = abs(lam - want) / want
    log(f"eps aij {nx}^3 f64 largest_magnitude: {its} restarts (stencil "
        f"{stencil_restarts}), lambda {lam!r} (rel err {rel:.3e}), wall "
        f"{wall:.3f} s ({wall / its * 1e3:.3f} ms/restart), host syncs "
        f"{E.result.host_syncs}, assembly {assembly:.3f} s, kernel launches "
        f"{sum(launches.values())}")
    check(E.result.converged and rel <= 1e-9, f"eps aij: {lam} vs {want}")
    check(abs(its - stencil_restarts) <= 1,
          f"eps aij restarts {its} vs stencil {stencil_restarts}")
    del m
    torch.cuda.empty_cache()


def nhep_oracle(nx=64, beta=0.3):
    """``numpy.linalg.eigvals`` of the dense ``convdiff2d(nx)`` (about 20 s
    on the host), started in a thread so that the phases that time nothing
    on the host run meanwhile; ``phase_eps_nhep`` joins it."""
    import threading
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    A = convdiff2d(nx, beta=beta)
    oracle = {"A": A, "nx": nx, "beta": beta}

    def run():
        t0 = time.perf_counter()
        oracle["lam"] = np.linalg.eigvals(A.toarray())
        oracle["seconds"] = time.perf_counter() - t0

    oracle["thread"] = threading.Thread(target=run, daemon=True)
    oracle["thread"].start()
    return oracle


def phase_eps_nhep(oracle):
    """Krylov-Schur on the unsymmetric convection-diffusion operator
    convdiff2d(64) (cfg4's family), NHEP, the largest real part, against
    ``numpy.linalg.eigvals`` of the dense matrix within 1e-8 relative. Its
    eigenvalue is ill-conditioned (the operator is far from normal), so the
    residual tolerance that bounds it is 1e-12; the default 1e-8 run is
    logged beside it."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    A = oracle["A"]
    comm = pt.DeviceComm()
    m = pt.Mat.from_scipy(comm, A, dtype=torch.float64)
    oracle["thread"].join()
    lam_all, t_eig = oracle["lam"], oracle["seconds"]
    want = complex(lam_all[np.argmax(lam_all.real)])
    nx, beta = oracle["nx"], oracle["beta"]
    c = float(np.cos(np.pi / (nx + 1)))
    closed = 4 + 2 * float(np.sqrt(1 - beta * beta)) * c + 2 * c
    for tol in (1e-8, 1e-12):
        E = pt.EPS().create(comm).set_operators(m).set_problem_type("nhep")
        E.set_which_eigenpairs("largest_real").set_tolerances(
            tol=tol, max_it=EPS_MAX_IT)
        launches, wall = eps_solve_counted(E)
        lam = E.get_eigenvalue(0)
        rel = abs(lam - want) / abs(want)
        log(f"eps nhep convdiff2d({nx}) largest_real tol {tol:g}: "
            f"{E.get_iteration_number()} restarts, {E.result.reason_name}, "
            f"lambda {lam!r}, numpy eigvals {want!r} ({t_eig:.1f} s; "
            f"closed form {closed!r}), rel err {rel:.3e}, compute_error "
            f"{E.compute_error(0):.3e}, wall {wall:.3f} s")
        check(E.result.converged, f"nhep tol {tol}: {E.result}")
    check(rel <= 1e-8, f"nhep convdiff2d: lambda rel err {rel}")


def phase_eps_reference_flow():
    """The reference test2.py flow through the port's runner and facade on
    the card at -n 1 and -n 4: the printed eigenvalue within 1e-8 relative
    of eigvalsh(tridiag_family(100)) (cfg2's eigenvalue_rel_err limit,
    benchmarks/run_all.py:493)."""
    from mpi_petsc4py_example_tpu_torch.models.generators import (
        tridiag_family)
    root = os.path.dirname(os.path.abspath(__file__))
    driver = os.path.join(root, "mpi_petsc4py_example_tpu_torch", "facade",
                          "drivers", "eigensolve.py")
    lam = np.linalg.eigvalsh(tridiag_family(100).toarray())
    want = float(lam[np.argmax(np.abs(lam))])
    for n in (1, 4):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "mpi_petsc4py_example_tpu_torch.run", "-n",
                            str(n), driver], capture_output=True, text=True,
                           timeout=600, cwd=root)
        wall = time.perf_counter() - t0
        got = [complex(line.split("Eigenvalue:")[1].strip())
               for line in r.stdout.splitlines() if "Eigenvalue:" in line]
        log(f"test2.py flow -n {n} on the card: rc {r.returncode}, printed "
            f"{got}, eigvalsh {want!r}, process wall {wall:.1f} s (a dense "
            f"host eigensolve ran beside it)")
        check(r.returncode == 0 and len(got) == 1
              and abs(got[0].real - want) <= 1e-8 * abs(want),
              f"test2.py flow -n {n}: {r.stdout[-500:]} {r.stderr[-2000:]}")


def phase_eps():
    """Every phase of the eigensolver slice; the stencil7_apply launches of
    the 128^3 runs and the kernel's fp64 128^3 times."""
    t0 = time.perf_counter()
    times = phase_eps_apply_times()
    launches, runs = phase_eps_main()
    t1 = time.perf_counter()
    phase_eps_aij(runs[("largest_magnitude", 16)]["restarts"])
    t2 = time.perf_counter()
    # the dense host eigensolve runs beside the phases that time nothing
    # on the host
    oracle = nhep_oracle()
    phase_eps_plain()
    phase_eps_reference_flow()
    phase_eps_nhep(oracle)
    log(f"eigensolver phases: {time.perf_counter() - t0:.1f} s (128^3 "
        f"stencil {t1 - t0:.1f} s, 128^3 AIJ {t2 - t1:.1f} s, the rest "
        f"{time.perf_counter() - t2:.1f} s)")
    return launches, times


# ---- the mixed-precision refinement slice (RefinedKSP, bf16 storage) ----------

REFINE_RTOL = 1e-10               # cfg11's rtol (benchmarks/run_all.py:1221)
BF16_NAMES = {"stencil7_apply": "stencil7_apply_bf16",
              "stencil7_dot": "stencil7_dot_bf16",
              "stencil7_apply_many": "stencil7_apply_many_bf16",
              "stencil7_dot_many": "stencil7_dot_many_bf16"}


def max_abs_diff(a, b) -> float:
    """max |a - b| of two bf16 tensors, in fp32."""
    return float((a.float() - b.float()).abs().max())


def read_bf16_launches():
    """The bfloat16 instantiations' launch counters, by kernel name."""
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    return {BF16_NAMES[name]: st.KERNELS[name].launches_bf16
            for name in BF16_NAMES}


# the shapes of phase_bf16_kernel_checks: 128^3; an odd multi-tile slab
# (218,115 points, so at k = 3 every other column is 2-byte aligned); the
# bf16 kernel's tile edges, a warp's 8-point runs spanning nx = 256 (255, 256,
# 257), one row past a block's 2048 points (ny = 9 at nx = 256, ny = 33 at nx
# = 64); a tiny odd slab; and the refinement's 32^3 and 64^3 paths
BF16_CHECK_SHAPES = ((128, 128, 128), (37, 45, 131), (4, 9, 255), (4, 9, 256),
                     (4, 9, 257), (3, 33, 64), (3, 5, 7), (32, 32, 32),
                     (64, 64, 64))


def bf16_route_of(st, u, lo, hi, y):
    """The bf16 kernel's route for this launch, as the library reports it
    (a checkout without ``bf16_route`` has one route)."""
    route = getattr(st, "bf16_route", None)
    return route(u, lo, hi, y) if route else "one"


def misaligned_copy(t):
    """``t``'s values in a tensor whose data starts 2 bytes past a 16-byte
    boundary (the bf16 kernel's element route at any nx)."""
    import torch
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def phase_bf16_kernel_checks():
    """The four bfloat16 kernels against their plain versions on the card,
    at ``BF16_CHECK_SHAPES``, random and zero halos, k in {1, 3, 8} for the
    batched two. ``A u`` must be bit-equal, the dots within 1e-5 relative
    and fp32; each column of a batched launch bit-equal (``A u`` and dot) to
    a single launch on it; every launch's route is logged, and at each shape
    a launch on misaligned copies of the inputs (the element route) must give
    the same bits and dots as the aligned one; float16 raises. Returns the
    largest errors per kernel."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    bf = torch.bfloat16
    worst = {name: 0.0 for name in BF16_NAMES.values()}
    worst["dot_rel"] = worst["dot_many_rel"] = 0.0
    seed = 900
    routes = set()
    for shape in BF16_CHECK_SHAPES:
        for halos in (True, False):
            seed += 1
            g = torch.Generator(device="cuda").manual_seed(seed)
            mk = lambda *sh: torch.rand(sh, generator=g, device="cuda").to(bf)
            u = mk(*shape)
            lo, hi = ((mk(*shape[1:]), mk(*shape[1:])) if halos else
                      (torch.zeros(shape[1:], device="cuda", dtype=bf),) * 2)
            y = st.stencil3d_apply(u, lo if halos else None,
                                   hi if halos else None)
            yd, d = st.stencil3d_dot(u, lo, hi)
            yp, dp = st.stencil3d_dot_plain(u, lo, hi)
            um, lom, him = (misaligned_copy(t) for t in (u, lo, hi))
            ym, dm1 = st.stencil3d_dot(um, lom, him)
            torch.cuda.synchronize()
            e_dot = abs(float(d) - float(dp)) / abs(float(dp))
            route = bf16_route_of(st, u, lo, hi, yd)
            route_m = bf16_route_of(st, um, lom, him, ym)
            routes |= {route, route_m}
            same_m = torch.equal(ym, yd) and torch.equal(dm1, d)
            label = f"{shape} {'random' if halos else 'zero'} halos"
            log(f"check bf16 {label}, route {route}: apply bit-equal "
                f"{torch.equal(y, yp)}, dot y bit-equal {torch.equal(yd, yp)}, "
                f"dot rel err {e_dot:.3e} ({d.dtype}); misaligned inputs "
                f"(route {route_m}) give the same bits and dot {same_m}")
            check(y.dtype == yd.dtype == bf and d.dtype == torch.float32,
                  f"bf16 dtypes {y.dtype} {yd.dtype} {d.dtype}")
            for name, got in (("stencil7_apply_bf16", y),
                              ("stencil7_dot_bf16", yd)):
                worst[name] = max(worst[name], max_abs_diff(got, yp))
            check(torch.equal(y, yp) and torch.equal(yd, yp),
                  f"bf16 apply/dot not bit-equal to plain, {label}")
            check(e_dot <= 1e-5, f"bf16 dot {label}: rel {e_dot}")
            check(same_m, f"bf16 dot on misaligned inputs differs, {label}")
            worst["dot_rel"] = max(worst["dot_rel"], e_dot)
            for k in (1, 3, K_BATCH):
                U = mk(k, *shape)
                blo, bhi = ((mk(k, *shape[1:]), mk(k, *shape[1:])) if halos
                            else (None, None))
                Y = st.stencil3d_apply_many(U, blo, bhi)
                Yd, dm = st.stencil3d_dot_many(U, blo, bhi)
                Yp, dmp = st.stencil3d_dot_many_plain(U, blo, bhi)
                e_many = float(((dm - dmp).abs() / dmp.abs()).max())
                same = True
                for j in range(k):
                    lj, hj = ((blo[j], bhi[j]) if halos else
                              (torch.zeros_like(U[j, 0]),) * 2)
                    y2, d2 = st.stencil3d_dot(U[j], lj, hj)
                    same = same and torch.equal(y2, Yd[j]) and torch.equal(
                        d2, dm[j])
                torch.cuda.synchronize()
                route = bf16_route_of(st, U, blo, bhi, Yd)
                routes.add(route)
                log(f"check bf16 many k={k} {label}, route {route}: apply "
                    f"bit-equal {torch.equal(Y, Yp)}, dot y bit-equal "
                    f"{torch.equal(Yd, Yp)}, dot max rel err {e_many:.3e}, "
                    f"columns equal single launches {same}")
                check(Y.dtype == bf and dm.dtype == torch.float32,
                      f"bf16 many dtypes {Y.dtype} {dm.dtype}")
                for name, got in (("stencil7_apply_many_bf16", Y),
                                  ("stencil7_dot_many_bf16", Yd)):
                    worst[name] = max(worst[name], max_abs_diff(got, Yp))
                check(torch.equal(Y, Yp) and torch.equal(Yd, Yp),
                      f"bf16 many kernels not bit-equal, k={k} {label}")
                check(e_many <= 1e-5, f"bf16 dot_many k={k} {label}: {e_many}")
                check(same, f"bf16 column differs from a single launch, "
                            f"k={k} {label}")
                worst["dot_many_rel"] = max(worst["dot_many_rel"], e_many)
                del U, blo, bhi, Y, Yd, dm, Yp, dmp
            del u, lo, hi, y, yd, d, yp, dp, um, lom, him, ym, dm1
    torch.cuda.empty_cache()
    if hasattr(st, "bf16_route"):
        check(routes == {"vec16", "elem"}, f"bf16 routes checked: {routes}")
    u = torch.ones(4, 6, 10, device="cuda", dtype=torch.float16)
    for fn in (st.stencil3d_apply, st.stencil3d_dot):
        try:
            fn(u, u[0].clone(), u[0].clone())
        except TypeError:
            continue
        raise SystemExit(f"chip_smoke: FAIL: float16 on CUDA did not raise "
                         f"in {fn.__name__}")
    log(f"check bf16: routes {sorted(routes)} checked; float16 raises "
        f"TypeError")
    return worst


def phase_bf16_kernel_times(n, k=K_BATCH):
    """kernel/plain/library/bound times of the four bfloat16 kernels at n^3
    (k x n^3 for the batched two). The library yardstick of the applies is
    cuDNN's conv3d in bfloat16 (batch k for the batched apply); the dots
    have none. The bound counts 2 bytes a point read and written, and the
    dots' fp32 partials."""
    import torch
    import torch.nn.functional as F
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    bf = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(17)
    big = n >= 512
    out = {}
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda", dtype=bf)
    w[0, 0, 1, 1, 1] = 6.0
    for dz, dy, dx in [(0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                       (1, 1, 2)]:
        w[0, 0, dz, dy, dx] = -1.0
    for cols in (1, k):
        mk = lambda *sh: torch.rand(sh, generator=g, device="cuda").to(bf)
        U = mk(cols, n, n, n)
        lo, hi = mk(cols, n, n), mk(cols, n, n)
        Y = torch.empty_like(U)
        ref = st.stencil3d_apply_many_plain(U, lo, hi)
        scale = float(ref.float().abs().max())
        ext = torch.cat([lo[:, None], U, hi[:, None]], dim=1)[:, None]
        conv = lambda: F.conv3d(ext, w, padding=(0, 1, 1))
        e_conv = float((conv()[:, 0].float() - ref.float()).abs().max())
        del ref
        slow = 2 if big else 10
        reps_slow = 5 if big else 25
        lib_ms = device_ms(conv, slow, reps=reps_slow)
        del ext
        torch.cuda.empty_cache()
        if cols == 1:
            u, l1, h1, y = U[0], lo[0], hi[0], Y[0]
            cases = [("stencil7_apply_bf16",
                      lambda: st.stencil3d_apply(u, l1, h1, out=y),
                      lambda: st.stencil3d_apply_plain(u, l1, h1), False),
                     ("stencil7_dot_bf16",
                      lambda: st.stencil3d_dot(u, l1, h1, out=y),
                      lambda: st.stencil3d_dot_plain(u, l1, h1), True)]
        else:
            cases = [("stencil7_apply_many_bf16",
                      lambda: st.stencil3d_apply_many(U, lo, hi, out=Y),
                      lambda: st.stencil3d_apply_many_plain(U, lo, hi), False),
                     ("stencil7_dot_many_bf16",
                      lambda: st.stencil3d_dot_many(U, lo, hi, out=Y),
                      lambda: st.stencil3d_dot_many_plain(U, lo, hi), True)]
        for name, kern, plain, dot in cases:
            res = kern()
            got = res[0] if dot else res
            want = plain()
            err = max_abs_diff(got, want[0] if dot else want)
            check(err == 0.0, f"{name} at {cols} x {n}^3 not bit-equal to "
                              f"its plain version: {err}")
            del want
            b_ms, b_by = bound_ms(n, n, n, 2, False, cols)
            if dot:                       # + the fp32 partial per column
                b_ms += cols * 4 / HBM_BYTES_PER_S * 1e3
            inner = (20 if cols == 1 else 10) if big else 100
            out[name] = {"ms": device_ms(kern, inner, 10 if big else 25),
                         "plain_ms": device_ms(plain, slow, reps=reps_slow),
                         "library_ms": None if dot else lib_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": err}
            r = out[name]
            log(f"time {name} {cols} x {n}^3 bf16: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{b_ms / r['ms'] * 100:.1f}% of it), "
                f"{'conv3d bf16 ' + format(lib_ms, '.4f') + ' ms' if not dot else 'no one-call library equivalent'}"
                f", achieved {cols * (2 * n**3 + 2 * n * n) * 2 / r['ms'] / 1e6:.1f} GB/s")
            torch.cuda.empty_cache()
        log(f"time conv3d bf16 batch {cols} {n}^3: max|conv3d - plain| "
            f"{e_conv:.3e} (max|y| {scale:.3e})")
        del U, lo, hi, Y
        torch.cuda.empty_cache()
    return out


def phase_bf16_kernel_profile(n=512, k=K_BATCH, launches=20):
    """``launches`` calls of each bfloat16 wrapper at n^3 (k x n^3 for the
    batched two) under ``torch.profiler``: device us per call by CUDA kernel,
    so the stencil march and ``sum_partials_kernel`` of the dots are read
    apart. Returns {wrapper: {kernel: us per call}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(23)
    mk = lambda *sh: torch.rand(sh, generator=g, device="cuda").to(bf)
    out = {}
    for cols in (1, k):
        U, lo, hi = mk(cols, n, n, n), mk(cols, n, n), mk(cols, n, n)
        Y = torch.empty_like(U)
        if cols == 1:
            u, l1, h1, y = U[0], lo[0], hi[0], Y[0]
            cases = {"stencil7_apply_bf16":
                     lambda: st.stencil3d_apply(u, l1, h1, out=y),
                     "stencil7_dot_bf16":
                     lambda: st.stencil3d_dot(u, l1, h1, out=y)}
        else:
            cases = {"stencil7_apply_many_bf16":
                     lambda: st.stencil3d_apply_many(U, lo, hi, out=Y),
                     "stencil7_dot_many_bf16":
                     lambda: st.stencil3d_dot_many(U, lo, hi, out=Y)}
        for name, fn in cases.items():
            fn()
            torch.cuda.synchronize()
            # a second window where the first recorded no device time, as
            # the profiler now and then does after earlier profiles
            for _ in range(2):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(launches):
                        fn()
                    torch.cuda.synchronize()
                rows = {e.key: e.self_device_time_total / launches
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0}
                if rows:
                    break
            out[name] = rows
            shape = f"{cols} x {n}^3" if cols > 1 else f"{n}^3"
            if not rows:
                log(f"profile {name} {shape}: the profiler recorded no "
                    "device time (not measured)")
                continue
            log(f"profile {name} {shape}, {launches} launches: device "
                f"{sum(rows.values()):.2f} us/call; " + "; ".join(
                    f"{key[:90]} {us:.2f} us" for key, us in
                    sorted(rows.items(), key=lambda r: -r[1])))
        del U, lo, hi, Y
        torch.cuda.empty_cache()
    return out


def refined(comm, A, prec, inner_op=None, rtol=REFINE_RTOL):
    import mpi_petsc4py_example_tpu_torch as pt
    rk = pt.RefinedKSP().create(comm)
    rk.set_inner_precision(prec)
    rk.set_operators(A, inner_op=inner_op)
    rk.set_type("cg")
    rk.get_pc().set_type("jacobi")
    rk.set_tolerances(rtol=rtol)
    return rk


def cfg11_problem(nx):
    """cfg11's system (benchmarks/run_all.py:1222-1224): 3D Poisson, b = A u
    with u uniform from default_rng(0), fp64."""
    import mpi_petsc4py_example_tpu_torch as pt
    A = pt.poisson3d_csr(nx).astype(np.float64).tocsr()
    u = np.random.default_rng(0).random(A.shape[0])
    return A, A @ u


def refine_outcome(A, b, x, res, rk):
    """The check rule of a refined solve: converged at 1.05 rtol (parity),
    or stopped by the stagnation guard (breakdown); returns which."""
    rel = true_relres(A, x, b)
    if res.converged:
        check(rel <= 1.05 * rk.rtol, f"converged with relres {rel}")
        return "parity", rel
    check(res.reason == -5, f"refined solve ended with reason {res.reason}")
    return "breakdown", rel


def inner_delta(comm, op, b):
    """The delta method on the inner CG + Jacobi alone (norm type none, 20
    and 220 iterations): the inner solve's ms per iteration."""
    import mpi_petsc4py_example_tpu_torch as pt
    bv = pt.Vec.from_global(comm, b, dtype=op.dtype, layout=op.layout)
    x, _ = op.get_vecs()
    solvers = {m: cg_jacobi(comm, op, 0.0, max_it=m, norm_none=True)
               for m in (20, 220)}
    per, _ = delta_per_iter(solvers, bv, x)
    return per


def phase_refine_cfg11(nx=128):
    """cfg11 at 128^3 (benchmarks/run_all.py:1187-1300): CG + Jacobi inside
    fp64 refinement at rtol 1e-10, inner bf16/f32/f64, on the stencil inner
    operator (the bf16 kernels' path) and on the assembled Mat (cfg11 as
    written). Per run: reason, steps, inner iterations, fp64 relres, warm
    wall, the inner delta-method ms/iteration and the bf16 dot launches
    (counters zeroed just before, read just after; on the stencil they must
    be the inner iterations plus one per step). f32 and f64 must reach 1.05
    rtol, as scipy's fp64 CG + Jacobi does; bf16 prints parity or
    DIVERGED_BREAKDOWN (the JAX package stagnates here on the CPU)."""
    import scipy.sparse.linalg as spla
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    A, b = cfg11_problem(nx)
    comm = pt.DeviceComm()
    t0 = time.perf_counter()
    M = spla.LinearOperator(A.shape, matvec=lambda v: v / 6.0)
    x_cpu, info = spla.cg(A, b, rtol=REFINE_RTOL, atol=0.0, maxiter=40000,
                          M=M)
    cpu_rel = true_relres(A, x_cpu, b)
    log(f"refine {nx}^3 scipy fp64 CG+jacobi oracle: info {info}, relres "
        f"{cpu_rel:.3e}, {time.perf_counter() - t0:.1f} s")
    check(cpu_rel <= 1.05 * REFINE_RTOL, f"scipy oracle relres {cpu_rel}")
    runs, launches_path = {}, {}
    for operator in ("stencil", "assembled"):
        for prec in ("bf16", "f32", "f64"):
            from mpi_petsc4py_example_tpu_torch.utils.dtypes import (
                inner_precision_dtype)
            dt = inner_precision_dtype(prec)
            op = (pt.StencilPoisson3D(comm, nx, dtype=dt)
                  if operator == "stencil" else None)
            t_set = time.perf_counter()
            rk = refined(comm, A, prec, op)
            t_set = time.perf_counter() - t_set
            torch.cuda.synchronize()
            st.reset_launches()
            x, res = rk.solve(b)
            torch.cuda.synchronize()
            launches = read_bf16_launches()
            outcome, rel = refine_outcome(A, b, x, res, rk)
            warm = rk.solve(b)[1].wall_time
            per = inner_delta(comm, rk._inner_op, b)
            dots = launches["stencil7_dot_bf16"]
            x_diff = float(np.abs(x - x_cpu).max() / np.abs(x_cpu).max())
            log(f"refine {nx}^3 {operator} {prec}: {outcome}, reason "
                f"{res.reason}, {rk.refine_steps} steps, {res.iterations} "
                f"inner iterations, fp64 relres {rel:.3e}, max|x - "
                f"x_scipy|/max|x| {x_diff:.3e}, wall {res.wall_time:.3f} s "
                f"(warm {warm:.3f} s), inner {per * 1e3:.4f} ms/iter "
                f"(delta method), set-up {t_set:.2f} s, bf16 dot launches "
                f"{dots}")
            if prec != "bf16":
                check(outcome == "parity",
                      f"{operator} {prec} refinement missed rtol: {res}")
            if operator == "stencil" and prec == "bf16":
                check(dots == res.iterations + rk.refine_steps,
                      f"bf16 dot launches {dots} != inner iterations "
                      f"{res.iterations} + steps {rk.refine_steps}")
                launches_path = launches
            else:
                check(dots == 0, f"bf16 dot launched on {operator} {prec}")
            runs[(operator, prec)] = {
                "outcome": outcome, "reason": res.reason,
                "steps": rk.refine_steps, "inner_iterations": res.iterations,
                "relres": rel, "wall_s": res.wall_time, "warm_wall_s": warm,
                "inner_ms_per_iter": per * 1e3}
            del rk, op
            torch.cuda.empty_cache()
    return launches_path, runs


def phase_refine_routes(nx=64, nx_single=32, k=K_BATCH):
    """Every bf16 kernel on a path: the refined single-RHS solve on the
    stencil fast path (``stencil7_dot_bf16``) and on the general route,
    Amat != Pmat (``stencil7_apply_bf16``) at ``nx_single``^3, and the
    refined ``solve_many`` with k columns on the fast path
    (``stencil7_dot_many_bf16``) and on the general route
    (``stencil7_apply_many_bf16``) at nx^3, all on cfg11's system. Counters
    are zeroed just before each solve and read just after; each launch count
    equals the inner iterations plus one per outer step, and every column
    reaches 1.05 rtol. Last, the single-RHS fast path at nx^3, where bf16
    refinement is at the edge of contraction: parity or the stagnation
    guard, printed (ROADMAP Queue C)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    bf = torch.bfloat16
    comm = pt.DeviceComm()
    out, missed = {}, []
    for route, many, size in (("general", False, nx_single),
                              ("fast", True, nx), ("general", True, nx),
                              ("fast", False, nx_single), ("fast", False, nx)):
        A, b = cfg11_problem(size)
        op = pt.StencilPoisson3D(comm, size, dtype=bf)
        rk = refined(comm, A, "bf16", op)
        if route == "general":
            rk.inner.set_operators(op, pt.StencilPoisson3D(comm, size,
                                                           dtype=bf))
        name = (("stencil7_dot" if route == "fast" else "stencil7_apply")
                + ("_many" if many else "") + "_bf16")
        if many:
            rng = np.random.default_rng(11)
            B = np.stack([b] + [A @ rng.random(A.shape[0])
                                for _ in range(k - 1)], axis=1)
        torch.cuda.synchronize()
        st.reset_launches()
        if many:
            X, res = rk.solve_many(B)
            rels = [true_relres(A, X[:, j], B[:, j]) for j in range(k)]
        else:
            x, res = rk.solve(b)
            rels = [true_relres(A, x, b)]
        torch.cuda.synchronize()
        launches = read_bf16_launches()
        label = (f"refine {size}^3 bf16 "
                 f"{'solve_many k=' + str(k) if many else 'solve'} "
                 f"{route} route")
        edge = name in out               # the second single fast-path run
        outcome = ("parity" if res.converged
                   and max(rels) <= 1.05 * REFINE_RTOL else
                   "breakdown" if res.reason == -5 else "missed")
        log(f"{label}: {outcome}, reason {res.reason}, {rk.refine_steps} "
            f"steps, {res.iterations} inner iterations, fp64 relres "
            f"{[float(f'{r:.3e}') for r in rels]}, wall "
            f"{res.wall_time:.3f} s, launches {launches}")
        check(launches[name] > 0, f"{name} never launched ({label})")
        check(launches[name] == res.iterations + rk.refine_steps,
              f"{name} launches {launches[name]} != inner iterations "
              f"{res.iterations} + steps {rk.refine_steps} ({label})")
        check(all(v == 0 for key, v in launches.items() if key != name),
              f"{label} launched other bf16 kernels: {launches}")
        if edge:
            check(outcome != "missed", f"{label}: {res}, {rels}")
            out["edge"] = {"size": size, "outcome": outcome,
                           "reason": res.reason, "steps": rk.refine_steps,
                           "inner_iterations": res.iterations,
                           "relres": rels[0]}
        else:
            if outcome != "parity":
                missed.append(f"{label}: reason {res.reason}, relres {rels}")
            out[name] = {"launches": launches[name],
                         "path": label.removeprefix("refine ")}
        del rk, op
        torch.cuda.empty_cache()
    # every route has run (and logged) before a miss fails the phase
    check(not missed, f"refined bf16 solves missed rtol: {missed}")
    return out


def phase_bf16_inner_512(nx=512):
    """CG + Jacobi on the 512^3 stencil alone, bf16 storage against f32: the
    delta-method ms per iteration against the 11-pass bound (2 and 4 bytes
    a pass), a profile of 20 fixed iterations (device time by kernel), peak
    memory, and a solve to the bf16 floor (rtol 4 x 2^-7) with its fp64
    true residual on the card."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    n = nx ** 3
    comm = pt.DeviceComm()
    g = torch.Generator(device="cuda").manual_seed(7)
    x_true = torch.rand(n, generator=g, device="cuda")
    op32 = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    b32 = op32.mult(pt.Vec(comm, n, data=x_true))
    del x_true
    rtol = 4 * 2.0 ** -7
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        op = pt.StencilPoisson3D(comm, nx, dtype=dtype)
        bv = pt.Vec(comm, n, data=b32.data.to(dtype))
        x, _ = op.get_vecs()
        ksp = cg_jacobi(comm, op, rtol)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = ksp.solve(bv, x)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        op64 = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
        b64 = bv.data.double()
        ax = op64.mult(pt.Vec(comm, n, data=x.data.double())).data
        true_rel = float(torch.linalg.vector_norm(b64 - ax)
                         / torch.linalg.vector_norm(b64))
        del op64, b64, ax
        torch.cuda.empty_cache()
        solvers = {m: cg_jacobi(comm, op, 0.0, max_it=m, norm_none=True)
                   for m in (20, 220)}
        torch.cuda.reset_peak_memory_stats()
        per, samples = delta_per_iter(solvers, bv, x)
        peak_fixed = torch.cuda.max_memory_allocated() / 2 ** 30
        idle = profile_solve(lambda: zero_solve(solvers[20], bv, x),
                             f"512^3 {name} 20 fixed iterations")
        bound = PASSES_PER_ITER * n * dtype.itemsize / HBM_BYTES_PER_S
        log(f"512^3 {name} CG+jacobi to rtol {rtol:g}: {res.iterations} "
            f"iterations, {res.reason_name}, fp64 true relres {true_rel:.3e}, "
            f"peak {peak:.2f} GiB; delta method {per * 1e3:.4f} ms/iter "
            f"(samples {[round(p * 1e3, 4) for p in samples]}), 11-pass bound "
            f"{bound * 1e3:.4f} ms ({bound / per * 100:.1f}% of it), peak "
            f"{peak_fixed:.2f} GiB in the fixed-iteration solves")
        check(res.converged, f"512^3 {name} solve: {res}")
        check(true_rel <= 10 * rtol, f"512^3 {name} true residual {true_rel}")
        out[name] = {"ms_per_iter": per * 1e3, "bound_ms": bound * 1e3,
                     "iterations": res.iterations, "true_relres": true_rel,
                     "peak_gib": max(peak, peak_fixed), "idle_share": idle}
        del op, bv, x, ksp, solvers
        torch.cuda.empty_cache()
    return out


def phase_bf16_many_512(nx=512, k=K_BATCH):
    """The batched twin of ``phase_bf16_inner_512``: CG + Jacobi on the 512^3
    stencil with k right-hand sides through ``KSP.solve_many``, bf16 storage
    against f32 in the same run: the delta method over 20 and 220 fixed
    lockstep iterations against the k x 11-pass bound (2 and 4 bytes a
    pass), one profiled 20-iteration window giving the stencil kernels'
    share of device time (``stencil7_dot_many`` and its partial sums, the
    only stencil kernels of the fast path), and peak memory."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    n = nx ** 3
    comm = pt.DeviceComm()
    g = torch.Generator(device="cuda").manual_seed(19)
    op32 = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    B32 = []
    for _ in range(k):
        xt = pt.Vec(comm, n, data=torch.rand(n, generator=g, device="cuda"))
        B32.append(op32.mult(xt).data)
        del xt
    del op32
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        op = pt.StencilPoisson3D(comm, nx, dtype=dtype)
        Bv = [pt.Vec(comm, n, data=b.to(dtype)) for b in B32]
        Xv = [op.get_vecs()[0] for _ in range(k)]
        solvers = {m: cg_jacobi(comm, op, 0.0, max_it=m, norm_none=True)
                   for m in (20, 220)}
        solvers[20].solve_many(Bv, Xv)                # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_iter = []
        for _ in range(2):      # two pairs: their spread was 0.2% (H100)
            walls = {}
            for m, ksp in solvers.items():
                t0 = time.perf_counter()
                r = ksp.solve_many(Bv, Xv)
                walls[m] = (time.perf_counter() - t0, max(r.iterations))
            (w_lo, i_lo), (w_hi, i_hi) = walls[20], walls[220]
            per_iter.append((w_hi - w_lo) / (i_hi - i_lo))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per = statistics.median(per_iter)
        prof = {}
        idle = profile_solve(
            lambda: max(solvers[20].solve_many(Bv, Xv).iterations),
            f"512^3 k={k} {name} solve_many, 20 fixed iterations",
            kernels=("stencil7_", "sum_partials_kernel"), out=prof)
        bound = k * PASSES_PER_ITER * n * dtype.itemsize / HBM_BYTES_PER_S
        log(f"512^3 k={k} {name} CG+jacobi solve_many: delta method "
            f"{per * 1e3:.4f} ms per lockstep iteration (samples "
            f"{[round(p * 1e3, 4) for p in per_iter]}), "
            f"{per * 1e3 / k:.4f} ms per RHS-iteration; bound k x 11 passes "
            f"{bound * 1e3:.4f} ms ({bound / per * 100:.1f}% of it); stencil "
            f"kernels {prof.get('kernel_share', float('nan')) * 100:.1f}% of "
            f"device time; peak {peak:.2f} GiB")
        check(peak < 80, f"512^3 k={k} {name} peak {peak} GiB")
        out[name] = {"ms_per_iter": per * 1e3, "bound_ms": bound * 1e3,
                     "peak_gib": peak, "idle_share": idle, **prof}
        del op, Bv, Xv, solvers
        torch.cuda.empty_cache()
    del B32
    torch.cuda.empty_cache()
    return out


def phase_refine():
    """Every phase of the mixed-precision slice; returns the bf16 kernels'
    entries for the kernels record."""
    t0 = time.perf_counter()
    worst = phase_bf16_kernel_checks()
    times = {n: phase_bf16_kernel_times(n) for n in (128, 512)}
    profile = phase_bf16_kernel_profile()
    t1 = time.perf_counter()
    inner_512 = phase_bf16_inner_512()
    many_512 = phase_bf16_many_512()
    routes = phase_refine_routes()
    t2 = time.perf_counter()
    launches_dot, runs = phase_refine_cfg11()
    log(f"mixed-precision phases: {time.perf_counter() - t0:.1f} s (kernels "
        f"{t1 - t0:.1f} s, 512^3 and routes {t2 - t1:.1f} s, 128^3 "
        f"refinement {time.perf_counter() - t2:.1f} s)")
    entries = []
    for base, name in BF16_NAMES.items():
        big, small = times[512][name], times[128][name]
        path = routes[name]
        entries.append({
            "name": name, "route": "cuda", "source": KERNELS[base][0],
            "replaces": KERNELS[base][1], "launches": path["launches"],
            "path": path["path"],
            "max_abs_err": max(worst[name], big["max_abs_err"],
                               small["max_abs_err"]),
            "ms": big["ms"], "kernel_ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "shape": ([K_BATCH] if "many" in name else []) + [512] * 3,
            "dtype": "bfloat16", "at_128": small})
        if name == "stencil7_dot_bf16":
            entries[-1]["dot_rel_err"] = worst["dot_rel"]
            entries[-1]["launches_cfg11_128"] = launches_dot[name]
        if name == "stencil7_dot_many_bf16":
            entries[-1]["dot_rel_err"] = worst["dot_many_rel"]
    return entries, {"cfg11": {f"{o} {p}": r for (o, p), r in runs.items()},
                     "inner_512": inner_512, "many_512": many_512,
                     "kernel_profile_512": profile, "edge_64": routes["edge"]}


# ---- the direct solves past the dense cap, PC set-up on the card, block PCs ---

DIRECT_RTOL = 1e-10     # tests/test_tridiag.py's and test_bpcr_device.py's


def apply_operations(fn):
    """The torch operations one ``fn()`` call runs that launch work on the
    device (views excluded), counted at the dispatcher: one launch each,
    except that cuBLAS may split a large batched product into several.
    (``torch.profiler``'s kernel count was exact as the first profiler
    session of a process and undercounted after the earlier phases'.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def cr_apply_record(pc, comm, n):
    """The cyclic-reduction apply of a set-up PC lu on a random vector:
    device ms (CUDA events), the bytes bound (every sweep array, the
    reduced diagonal or its block inverses, the rhs read once and the
    solution written once, over the HBM rate; the operations, 2 multiply-adds
    per coefficient, are far below the fp64 rate), and the torch operations
    one apply runs (3 S + 1)."""
    import torch
    arrs = pc._arrays
    item = arrs[0].element_size()
    nbytes = sum(a.numel() for a in arrs[:3]) * item + 2 * n * item
    nbytes += sum(a.numel() * a.element_size() for a in arrs[3:])
    apply = pc.local_apply(comm, n)
    r = torch.rand(comm.size, comm.local_size(n), device=comm.device,
                   dtype=arrs[0].dtype)
    return {"ms": device_ms(lambda: apply(r), inner=5, reps=11),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": apply_operations(lambda: apply(r)),
            "sweeps": int(arrs[0].shape[0])}


def direct_solve(comm, A, dtype, placement="auto", pc_type="lu"):
    """preonly + PC lu on ``A`` (b = A x, x from default_rng(11)): the PC
    set-up seconds (synced), the first and a warm solve, the warm one's fp64
    true relative residual on the host, and the PC."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    x_true = np.random.default_rng(11).random(A.shape[0])
    b = (A @ x_true).astype(dtype)
    m, _ = assemble(comm, A, torch.float64 if dtype == np.float64
                    else torch.float32)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(m)
    ksp.set_type("preonly")
    pc = ksp.get_pc()
    pc.set_type(pc_type)
    pc.set_factor_solver_type("mumps")
    pc.setup_device = placement
    t0 = time.perf_counter()
    ksp.set_up()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    x, bv = m.get_vecs()
    bv.set_global(b)
    first = ksp.solve(bv, x)
    res = ksp.solve(bv, x)
    rel = true_relres(A, x.to_numpy(), b)
    return {"setup_s": setup, "solve_ms": res.wall_time * 1e3,
            "first_solve_ms": first.wall_time * 1e3,
            "refine_steps": res.host_syncs - 1, "true_relres": rel,
            "mode": pc.kind, "setup_mode": pc.setup_mode,
            "breakdown": pc.setup_breakdown, "arrays": len(pc._arrays),
            "converged": res.converged}, pc, m


def log_direct(label, r, apply=None):
    log(f"{label}: mode {r['mode']}, {r['arrays']} arrays, set-up "
        f"{r['setup_s']:.3f} s ({r['setup_mode']} {r['breakdown']}), warm "
        f"solve {r['solve_ms']:.2f} ms (first {r['first_solve_ms']:.2f}) "
        f"with {r['refine_steps']} refinement steps, "
        f"fp64 true rel residual {r['true_relres']:.3e}"
        + ("" if apply is None else
           f"; apply {apply['ms']:.4f} ms vs bound {apply['bound_ms']:.4f} "
           f"ms ({apply['bound_ms'] / apply['ms'] * 100:.1f}%), "
           f"{apply['operations']} torch operations, S = "
           f"{apply['sweeps']}"))


def laplace1d(n):
    import scipy.sparse as sp
    return sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                     np.full(n - 1, -1.0)], [-1, 0, 1], format="csr")


def pentadiag(n, d1=-1.0, d2=-0.5, main=4.0):
    import scipy.sparse as sp
    return sp.diags([np.full(n - 2, d2), np.full(n - 1, d1), np.full(n, main),
                     np.full(n - 1, d1), np.full(n - 2, d2)],
                    [-2, -1, 0, 1, 2], format="csr")


def phase_direct_crtri(n_lap=1 << 20, n_test2=100_000):
    """PC lu in the crtri mode (parallel cyclic reduction), fp64, preonly,
    -pc_setup_device auto: the 1D Laplacian at n = 2^20 and the test2.py
    family at n = 100,000 (tests/test_tridiag.py:116-143), relres <= 1e-10;
    the apply against its bytes bound, with its operations (3 S + 1)."""
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import tridiag_family
    comm = pt.DeviceComm()
    out = {}
    for label, A in ((f"laplace1d n={n_lap}", laplace1d(n_lap)),
                     (f"test2 family n={n_test2}", tridiag_family(n_test2))):
        r, pc, _ = direct_solve(comm, A, np.float64)
        apply = cr_apply_record(pc, comm, A.shape[0])
        log_direct(f"crtri {label} f64", r, apply)
        check(r["mode"] == "crtri" and r["true_relres"] <= DIRECT_RTOL,
              f"crtri {label}: {r}")
        out[label] = dict(r, apply=apply)
    return out


def phase_direct_crband(n_penta=1 << 20, n_band=100_000, nx_rcm=160,
                        n_f32=17_000):
    """PC lu in the crband mode (block cyclic reduction): pentadiagonal at n =
    2^20 set up on the card (auto) and on the host (0) in one call;
    bandwidth 8 at n = 100,000; a randomly permuted 160^2 2D Poisson through
    RCM (5 arrays); all fp64, relres <= 1e-10; then the n = 17,000
    pentadiagonal in f32 with preonly's refinement, relres <= 5e-6
    (tests/test_tridiag.py:189-221, tests/test_bpcr_device.py:128-134)."""
    import scipy.sparse as sp
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    comm = pt.DeviceComm()
    out = {}
    A = pentadiag(n_penta)
    for placement, mode in (("auto", "device"), ("0", "host")):
        r, pc, _ = direct_solve(comm, A, np.float64, placement)
        apply = cr_apply_record(pc, comm, A.shape[0]) \
            if placement == "auto" else None
        log_direct(f"crband pentadiagonal n={n_penta} f64, "
                   f"-pc_setup_device {placement}", r, apply)
        check(r["mode"] == "crband" and r["setup_mode"] == mode
              and r["true_relres"] <= DIRECT_RTOL,
              f"crband n={n_penta} ({placement}): {r}")
        out[f"penta {n_penta} {placement}"] = dict(r, apply=apply)
    del A, pc
    rng = np.random.default_rng(13)
    n = n_band
    offs = [o for o in range(-8, 9) if o != 0]
    cases = [(f"bandwidth 8 n={n}", (sp.diags(
        [0.1 * (rng.random(n - abs(o)) - 0.5) for o in offs], offs)
        + 3.0 * sp.eye(n)).tocsr(), 3)]
    P = poisson2d_csr(nx_rcm).tocsr()
    p = np.random.default_rng(2).permutation(P.shape[0])
    cases.append((f"permuted poisson2d {nx_rcm}^2 via RCM", P[p][:, p].tocsr(),
                  5))
    for label, A, narrays in cases:
        r, pc, _ = direct_solve(comm, A, np.float64)
        apply = cr_apply_record(pc, comm, A.shape[0])
        log_direct(f"crband {label} f64", r, apply)
        check(r["mode"] == "crband" and r["arrays"] == narrays
              and r["setup_mode"] == "device"
              and r["true_relres"] <= DIRECT_RTOL, f"crband {label}: {r}")
        out[label] = dict(r, apply=apply, band=int(pc._arrays[0].shape[-1]))
    A = pentadiag(n_f32)
    r, _, _ = direct_solve(comm, A, np.float32)
    log_direct(f"crband pentadiagonal n={n_f32} f32 (refined)", r)
    check(r["mode"] == "crband" and r["setup_mode"] == "device"
          and r["true_relres"] <= 5e-6, f"crband f32: {r}")
    out[f"penta {n_f32} f32"] = r
    return out


def phase_block_pcs(nx=64, ndev=4):
    """PC sor/ssor/ilu/icc/asm under GMRES(30), f32, rtol 1e-6, on 4 virtual
    shards of a 64^2 2D Poisson and of cfg4's convection-diffusion at 64^2
    (beta 0.4): iterations, reason and the fp64 true relres, each
    converged."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    rtol = 1e-6
    comm = pt.DeviceComm(ndev)
    out = {}
    for name, A in (("poisson2d", poisson2d_csr(nx)),
                    ("cfg4", convdiff2d(nx, beta=0.4))):
        b = manufactured(A)
        m, _ = assemble(comm, A, torch.float32)
        bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
        for pc_type in ("sor", "ssor", "ilu", "icc", "asm"):
            ksp = aij_ksp(comm, m, "gmres", pc_type, rtol)
            t0 = time.perf_counter()
            ksp.set_up()
            setup = time.perf_counter() - t0
            x, _ = m.get_vecs()
            res = ksp.solve(bv, x)
            rel = true_relres(A, x.to_numpy(), b)
            log(f"block PC {pc_type} on {name} {nx}^2 f32, {ndev} shards, "
                f"GMRES(30): {res.iterations} iterations, {res.reason_name}, "
                f"fp64 true rel residual {rel:.3e}, set-up {setup:.3f} s, "
                f"solve {res.wall_time * 1e3:.2f} ms")
            check(res.converged and rel <= 10 * rtol,
                  f"{pc_type} on {name}: {res}, {rel}")
            out[f"{pc_type} {name}"] = {"iterations": res.iterations,
                                        "reason": res.reason_name,
                                        "true_relres": rel}
    return out


def phase_direct():
    """Every phase of the direct-solve and PC set-up slice (no kernel of its
    own: its sweeps and inverses are torch operations)."""
    t0 = time.perf_counter()
    crtri = phase_direct_crtri()
    t1 = time.perf_counter()
    crband = phase_direct_crband()
    t2 = time.perf_counter()
    blocks = phase_block_pcs()
    log(f"direct-solve phases: {time.perf_counter() - t0:.1f} s (crtri "
        f"{t1 - t0:.1f} s, crband {t2 - t1:.1f} s, block PCs "
        f"{time.perf_counter() - t2:.1f} s)")
    return {"crtri": crtri, "crband": crband, "block_pcs": blocks}


# ---- the KSP/PC/Mat/Vec surface (slice 10): monitors and warm starts, the
# gated solve_many, ShellMat, null spaces, transpose products, composite and
# shell PCs, PETSc binary I/O, the advanced.py flow --------------------------

SURFACE_NX = 128


def timed_solves(ksp, bv, x, reps=3):
    """ms per iteration of ``reps`` warm solves from zero (host clock; each
    solve ends in its last host read): the median, and the samples."""
    samples = []
    for _ in range(reps):
        x.zero()
        t0 = time.perf_counter()
        res = ksp.solve(bv, x)
        samples.append((time.perf_counter() - t0) / max(res.iterations, 1)
                       * 1e3)
    return statistics.median(samples), samples


def phase_surface_monitor(nx=SURFACE_NX, rtol=1e-6):
    """The monitored, warm-started 128^3 f32 stencil CG + Jacobi: the history
    (iterations + 1 entries, the last the result's norm), host syncs and
    ``stencil7_dot`` launches equal with and without the monitor (launches =
    iterations + 1: the fast path stays on), ms/iter in both modes in turns,
    and a solve from a perturbed solution with the initial guess nonzero."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    runs = {}
    for mode in ("plain", "monitored"):
        ksp = cg_jacobi(comm, op, rtol)
        seen = []
        if mode == "monitored":
            ksp.set_monitor(lambda k, it, rn: seen.append((it, rn)))
            ksp.set_convergence_history()
        x, _ = op.get_vecs()
        reset_launches()
        res = ksp.solve(bv, x)
        runs[mode] = (ksp, res, read_launches(), x, seen)
    (k0, r0, l0, _, _), (k1, r1, l1, x1, seen) = runs["plain"], \
        runs["monitored"]
    hist = k1.get_convergence_history()
    its = r1.iterations
    log(f"surface monitor {nx}^3 f32 CG+jacobi: {its} iterations "
        f"({r1.reason_name}), host syncs {r1.host_syncs} monitored / "
        f"{r0.host_syncs} not, stencil7_dot launches {l1['stencil7_dot']} / "
        f"{l0['stencil7_dot']}, history {len(hist)} entries, last "
        f"{hist[-1]:.6e} vs result {r1.residual_norm:.6e}")
    check(r1.converged and its == r0.iterations, "monitored CG differs")
    check(len(hist) == its + 1 and hist[-1] == r1.residual_norm,
          "history is not iterations + 1 entries ending at the result")
    check([i for i, _ in seen] == list(range(its + 1)), "monitor order")
    check(r1.host_syncs == r0.host_syncs == its + 1,
          "a monitor changed the host syncs")
    check(l1["stencil7_dot"] == l0["stencil7_dot"] == its + 1,
          "the monitored solve left the stencil7_dot fast path")
    # ms/iter of both modes in turns: plain, monitored, monitored, plain
    per = {"plain": [], "monitored": []}
    for mode in ("plain", "monitored", "monitored", "plain"):
        ksp, _, _, x, _ = runs[mode]
        per[mode] += timed_solves(ksp, bv, x, reps=2)[1]
    ms = {m: statistics.median(s) for m, s in per.items()}
    log(f"surface monitor ms/iter (warm, host clock): plain {ms['plain']:.4f}"
        f" {[round(s, 4) for s in per['plain']]}, monitored "
        f"{ms['monitored']:.4f} {[round(s, 4) for s in per['monitored']]}")
    # warm start from a perturbed solution
    xs = x1.to_numpy().astype(np.float64)
    rng = np.random.default_rng(11)
    x0 = xs + 1e-3 * np.abs(xs).max() * rng.standard_normal(xs.shape)
    k1.set_initial_guess_nonzero(True)
    xw = pt.Vec.from_global(comm, x0, dtype=torch.float32)
    reset_launches()
    warm = k1.solve(bv, xw)
    lw = read_launches()
    log(f"surface warm start: {warm.iterations} iterations from a 1e-3 "
        f"perturbed solution ({warm.reason_name}) against {its} from zero, "
        f"stencil7_dot launches {lw['stencil7_dot']}")
    check(warm.converged and warm.iterations < its,
          "the warm start did not save iterations")
    check(lw["stencil7_dot"] == warm.iterations + 1, "warm start launches")
    return {"iterations": its, "host_syncs": r1.host_syncs,
            "stencil7_dot_launches": l1["stencil7_dot"],
            "ms_per_iter": ms, "warm_start_iterations": warm.iterations,
            "history_entries": len(hist)}


def phase_surface_gated_many(nx=SURFACE_NX, k=K_BATCH, rtol=1e-5):
    """The gated k = 8 ``solve_many`` at 128^3 f32: the batched fast path
    (``stencil7_dot_many``) with the per-column true-residual epilogue (one
    ``stencil7_apply_many`` per pass), against the ungated solve in the same
    run; each column's fp64 true residual on the host. rtol 1e-5 keeps off
    fp32's floor at 128^3."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    rng = np.random.default_rng(12)
    B = np.stack([b] + [op.mult(pt.Vec.from_global(
        comm, rng.random(nx ** 3).astype(np.float32))).to_numpy()
        for _ in range(k - 1)], axis=1)
    out = {}
    for gate in (False, True):
        ksp = cg_jacobi(comm, op, rtol)
        ksp.set_true_residual_check(gate)
        reset_launches()
        res = ksp.solve_many(B)
        la = read_launches()
        out[gate] = (res, la, ksp._last_reentries)
    (r0, l0, _), (r1, l1, reentries) = out[False], out[True]
    A = pt.poisson3d_csr(nx).astype(np.float64)
    relres = [true_relres(A, r1.X[:, j], B[:, j]) for j in range(k)]
    log(f"surface gated solve_many {nx}^3 f32 k={k} rtol {rtol:g}: "
        f"iterations {r1.iterations} (ungated {r0.iterations}), reasons "
        f"{r1.reason_names}, re-entries {reentries}, host syncs "
        f"{r1.host_syncs} (ungated {r0.host_syncs}), launches dot_many "
        f"{l1['stencil7_dot_many']} / apply_many {l1['stencil7_apply_many']}"
        f" (ungated {l0['stencil7_dot_many']} / {l0['stencil7_apply_many']})"
        f", fp64 true relres max {max(relres):.3e}")
    check(r1.converged, "gated solve_many did not converge")
    check(max(relres) <= 1.05 * rtol, "a gated column misses rtol")
    check(l1["stencil7_apply_many"] == 1 + reentries,
          "one apply_many per pass (the epilogue)")
    check(l1["stencil7_dot_many"] >= max(r1.iterations) + 1,
          "gated solve_many left the dot_many fast path")
    check(l0["stencil7_dot_many"] == max(r0.iterations) + 1
          and l0["stencil7_apply_many"] == 0, "ungated launches")
    check(r1.host_syncs >= max(r1.iterations) + 2, "gated host syncs")
    return {"iterations": r1.iterations, "reentries": reentries,
            "stencil7_dot_many_launches": l1["stencil7_dot_many"],
            "stencil7_apply_many_launches": l1["stencil7_apply_many"],
            "max_true_relres": max(relres)}


def stencil_shell(comm, nx, transpose=True):
    """The 7-point stencil as a ``ShellMat``: its ``mult`` is one
    ``stencil7_apply`` launch through ``ops/stencil.py``'s wrapper on the
    whole vector, with zero (Dirichlet) halo planes; diagonal 6."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    zero = torch.zeros((nx, nx), dtype=torch.float32, device=comm.device)

    def mult(v):
        return st.stencil3d_apply(v.view(nx, nx, nx), zero, zero).view(-1)

    return pt.ShellMat(comm, nx ** 3, mult,
                       mult_transpose=mult if transpose else None,
                       diagonal=np.full(nx ** 3, 6.0), dtype=torch.float32)


def phase_surface_shell(stencil_its, stencil_ms, nx=SURFACE_NX, rtol=1e-6,
                        max_it=400):
    """The ShellMat that wraps the 128^3 stencil: CG + Jacobi within 2% of
    the stencil's own iterations in this run, one ``stencil7_apply`` launch
    per operator apply, ms/iter against the stencil's (the gather and
    re-slice of ``full_vector_local_apply``); then cgne and lsqr on it, its
    ``mult_transpose`` the same apply."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    S = stencil_shell(comm, nx)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    ksp = cg_jacobi(comm, S, rtol)
    x, _ = S.get_vecs()
    reset_launches()
    res = ksp.solve(bv, x)
    la = read_launches()
    its = res.iterations
    ms, samples = timed_solves(ksp, bv, x)
    log(f"surface shell {nx}^3 f32 CG+jacobi: {its} iterations "
        f"({res.reason_name}; stencil {stencil_its}), stencil7_apply "
        f"launches {la['stencil7_apply']} (applies: iterations + 1), "
        f"{ms:.4f} ms/iter warm {[round(s, 4) for s in samples]} against "
        f"the stencil's {stencil_ms:.4f}")
    check(res.converged, "shell CG did not converge")
    check(abs(its - stencil_its) <= 0.02 * stencil_its,
          f"shell iterations {its} vs stencil {stencil_its}")
    check(la["stencil7_apply"] == its + 1, "one stencil7_apply per apply")
    A = pt.poisson3d_csr(nx).astype(np.float64)
    out = {"iterations": its, "ms_per_iter": ms,
           "stencil7_apply_launches": la["stencil7_apply"]}
    for ksp_type, pc_type in (("cgne", "jacobi"), ("lsqr", "none")):
        k2 = pt.KSP().create(comm)
        k2.set_operators(S)
        k2.set_type(ksp_type)
        k2.get_pc().set_type(pc_type)
        k2.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
        x2, _ = S.get_vecs()
        reset_launches()
        t0 = time.perf_counter()
        r2 = k2.solve(bv, x2)
        wall = time.perf_counter() - t0
        l2 = read_launches()
        rr = true_relres(A, x2.to_numpy(), b)
        log(f"surface shell {ksp_type}+{pc_type}: {r2.iterations} iterations"
            f" ({r2.reason_name}, max_it {max_it}), fp64 relres {rr:.3e}, "
            f"{wall / max(r2.iterations, 1) * 1e3:.4f} ms/iter, "
            f"stencil7_apply launches {l2['stencil7_apply']}")
        check(np.isfinite(rr) and rr < 1.0, f"{ksp_type} on the shell")
        out[ksp_type] = {"iterations": r2.iterations, "reason": r2.reason,
                         "relres": rr,
                         "stencil7_apply_launches": l2["stencil7_apply"]}
    return out


def neumann3d_csr(nx):
    """The 7-point Poisson with pure Neumann boundaries: the Dirichlet
    operator with each row's missing neighbours taken off its diagonal
    (singular; null space the constant)."""
    import scipy.sparse as sp
    import mpi_petsc4py_example_tpu_torch as pt
    A = pt.poisson3d_csr(nx).astype(np.float64).tocsr()
    return (A - sp.diags(A @ np.ones(A.shape[0]))).tocsr(), A


def phase_surface_nullspace(nx=SURFACE_NX, rtol=1e-8):
    """The 128^3 Neumann Poisson as an fp64 AIJ (DIA route) with a constant
    ``NullSpace`` and a compatible right-hand side, CG + Jacobi: fp64 true
    residual <= 10 rtol ||b||, mean zero to 1e-10 relative, ms/iter against
    the Dirichlet AIJ of the same size (the two projections per
    iteration). Returns the Dirichlet matrix, its right-hand side and
    iterations for the binary I/O phase."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    AN, AD = neumann3d_csr(nx)
    n = AN.shape[0]
    ns = pt.NullSpace(constant=True)
    b = ns.remove(np.random.default_rng(13).random(n))
    out = {}
    for name, A in (("neumann", AN), ("dirichlet", AD)):
        M, assembly = assemble(comm, A, torch.float64)
        if name == "neumann":
            M.set_nullspace(ns)
        ksp = aij_ksp(comm, M, "cg", "jacobi", rtol)
        bv = pt.Vec.from_global(comm, b, dtype=torch.float64)
        x, _ = M.get_vecs()
        res = ksp.solve(bv, x)
        xh = x.to_numpy()
        rr = true_relres(A, xh, b)
        ms, samples = timed_solves(ksp, bv, x)
        out[name] = {"iterations": res.iterations, "relres": rr,
                     "ms_per_iter": ms, "assembly_s": assembly,
                     "route": M.spmv_route(comm), "mean": float(xh.mean()),
                     "max_abs": float(np.abs(xh).max())}
        log(f"surface {name} {nx}^3 fp64 AIJ CG+jacobi: {res.iterations} "
            f"iterations ({res.reason_name}), route {M.spmv_route(comm)}, "
            f"fp64 relres {rr:.3e}, mean(x) {xh.mean():.3e} (max|x| "
            f"{np.abs(xh).max():.3e}), {ms:.4f} ms/iter warm "
            f"{[round(s, 4) for s in samples]}, assembly {assembly:.3f} s")
        check(res.converged, f"{name} did not converge")
        check(rr <= 10 * rtol, f"{name}: fp64 true residual {rr}")
        if name == "neumann":
            check(abs(xh.mean()) <= 1e-10 * np.abs(xh).max(),
                  "Neumann solution is not mean-free")
        del M, ksp, bv, x
    torch.cuda.empty_cache()
    return out, (AD, b, out["dirichlet"]["iterations"])


def transpose_times(comm, A, dtype):
    """Device ms of one ``Mat.mult_transpose`` product (``local_spmv_t``),
    its bound (CSR values and column indices and both vectors once, over
    the HBM rate) and one ``torch.sparse`` CSR product with ``A^T``."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    M = pt.Mat.from_scipy(comm, A, dtype=dtype)
    n = A.shape[0]
    x = torch.rand(n, device=comm.device, dtype=dtype)
    spmv_t = M.local_spmv_t(comm)
    xs = x.view(comm.size, -1)
    ms = device_ms(lambda: spmv_t(xs), inner=20)
    item = torch.empty(0, dtype=dtype).element_size()
    nbytes = A.nnz * (item + 4) + 2 * n * item
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    C = A.T.tocsr()
    Ct = torch.sparse_csr_tensor(
        torch.from_numpy(C.indptr.astype(np.int64)),
        torch.from_numpy(C.indices.astype(np.int64)),
        torch.from_numpy(C.data.astype(np.float64 if item == 8
                                       else np.float32)),
        size=C.shape).to(comm.device)
    lib = device_ms(lambda: Ct @ x, inner=20)
    y = spmv_t(xs).reshape(-1)[:n]
    ref = Ct @ x
    err = float((y - ref).abs().max() / ref.abs().max())
    again = spmv_t(xs).reshape(-1)[:n]
    check(torch.equal(y, again), "mult_transpose is not deterministic")
    check(err <= 1e-13 if item == 8 else err <= 1e-6,
          f"mult_transpose vs torch.sparse: {err}")
    return M, {"route": M.spmv_route(comm), "ms": ms, "bound_ms": bound,
               "bytes": nbytes, "library_ms": lib, "rel_err": err}


def phase_surface_transpose(AD, nx2=1024, rtol=1e-6):
    """``mult_transpose`` on the 128^3 AIJ and on the unsymmetric 1024^2
    convection-diffusion (fp64, DIA route), against the operator-bytes
    bound and ``torch.sparse``; then bicg, cgne and lsqr on the
    convection-diffusion operator: iterations, reason, fp64 relres."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    comm = pt.DeviceComm()
    out = {}
    C = convdiff2d(nx2).astype(np.float64).tocsr()
    nx = round(AD.shape[0] ** (1 / 3))
    for name, A in ((f"aij{nx}^3", AD), (f"convdiff{nx2}^2", C)):
        M, t = transpose_times(comm, A, torch.float64)
        out[name] = t
        log(f"surface mult_transpose {name} fp64 ({t['route']}): "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bytes'] / 1e6:.1f} MB; {t['bound_ms'] / t['ms'] * 100:.1f}%"
            f" of it), torch.sparse CSR A^T {t['library_ms']:.4f} ms, "
            f"rel diff {t['rel_err']:.2e}")
    b = C @ np.random.default_rng(14).random(C.shape[0])
    bv = pt.Vec.from_global(comm, b, dtype=torch.float64)
    for ksp_type, pc_type, max_it in (("bicg", "jacobi", 5000),
                                      ("cgne", "jacobi", 500),
                                      ("lsqr", "none", 500)):
        ksp = aij_ksp(comm, M, ksp_type, pc_type, rtol, max_it=max_it)
        x, _ = M.get_vecs()
        t0 = time.perf_counter()
        res = ksp.solve(bv, x)
        wall = time.perf_counter() - t0
        rr = true_relres(C, x.to_numpy(), b)
        log(f"surface {ksp_type}+{pc_type} convdiff{nx2} fp64: "
            f"{res.iterations} iterations ({res.reason_name}, max_it "
            f"{max_it}), fp64 relres {rr:.3e}, wall {wall:.2f} s "
            f"({wall / max(res.iterations, 1) * 1e3:.4f} ms/iter)")
        check(np.isfinite(rr) and rr < 1.0, f"{ksp_type} on convdiff")
        check(not res.converged or rr <= 10 * rtol,
              f"{ksp_type}: converged but the fp64 relres is {rr}")
        out[ksp_type] = {"iterations": res.iterations, "reason": res.reason,
                         "relres": rr, "ms_per_iter":
                         wall / max(res.iterations, 1) * 1e3}
    return out


def phase_surface_composite(sizes=(24, 64)):
    """Composite (jacobi, sor) and shell PCs under FGMRES: advanced.py's
    scenario 2 at its own size (24^2 Laplacian plus a variable diagonal,
    rtol 1e-10), and at 64^2 on 1 and 4 shards, multiplicative and additive,
    with the composite apply's device ms. (256^2 is out of reach: one
    shard's SOR block, 65,536^2, is past the dense cap in both packages,
    and on 4 shards the four 16,384^2 blocks are a host fp64 inversion of
    minutes.)"""
    import scipy.sparse as sp
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.facade.drivers.advanced import (
        laplacian2d)
    out = []
    for nx in sizes:
        n = nx * nx
        A = (laplacian2d(nx) + sp.diags(1.0 + np.arange(n) / n)).tocsr()
        b = A @ np.random.default_rng(7).random(n)
        for ndev in ((1,) if nx == sizes[0] else (1, 4)):
            comm = pt.DeviceComm(ndev)
            M = pt.Mat.from_scipy(comm, A)
            for kind in ("multiplicative", "additive", "shell"):
                if nx == sizes[0] and kind != "multiplicative":
                    continue
                pc = pt.PC(comm)
                if kind == "shell":
                    d = torch.tensor(A.diagonal(), device=comm.device)
                    pc.set_type("shell").set_shell_apply(lambda r: r / d)
                else:
                    pc.set_type("composite").set_composite_type(kind)
                    pc.set_composite_pcs("jacobi", "sor")
                ksp = pt.KSP().create(comm)
                ksp.set_operators(M)
                ksp.set_type("fgmres")
                ksp.set_pc(pc)
                rtol = 1e-10 if nx == sizes[0] else 1e-8
                ksp.set_tolerances(rtol=rtol, max_it=5000)
                x, bv = M.get_vecs()
                bv.set_global(b)
                t0 = time.perf_counter()
                res = ksp.solve(bv, x)
                wall = time.perf_counter() - t0
                rr = true_relres(A, x.to_numpy(), b)
                apply = pc.local_apply(comm, n)
                r = torch.rand(ndev, comm.local_size(n), device=comm.device,
                               dtype=torch.float64)
                ms = device_ms(lambda: apply(r), inner=20)
                log(f"surface fgmres+{kind} {nx}^2 on {ndev} shard(s): "
                    f"{res.iterations} iterations ({res.reason_name}), "
                    f"fp64 relres {rr:.3e}, wall {wall:.3f} s, PC apply "
                    f"{ms:.4f} ms")
                check(res.converged and rr <= 10 * rtol,
                      f"fgmres+{kind} at {nx}^2")
                out.append({"nx": nx, "shards": ndev, "pc": kind,
                            "iterations": res.iterations, "relres": rr,
                            "apply_ms": ms})
    return out


def phase_surface_petsc_io(AD, b, its_orig, rtol=1e-8):
    """PETSc binary I/O of the 128^3 fp64 AIJ (14.58 M nonzeros) and its
    right-hand side, Mat then Vec in one file under ``build/``: write and
    load seconds (host clock; the load's device placement synced) against
    ``Mat.from_scipy``'s assembly, and the loaded system solves in the
    original's iterations."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "petsc_io")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "system.petsc")
    try:
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            pt.petsc_io.write_mat(f, AD)
            pt.petsc_io.write_vec(f, b)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            A2 = pt.petsc_io.read_mat(f)
            t_read = time.perf_counter() - t0
            M = pt.Mat.from_scipy(comm, A2, dtype=torch.float64)
            bv = pt.Vec.from_global(comm, pt.petsc_io.read_vec(f),
                                    dtype=torch.float64)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    _, t_assembly = assemble(comm, AD, torch.float64)
    ksp = aij_ksp(comm, M, "cg", "jacobi", rtol)
    x, _ = M.get_vecs()
    res = ksp.solve(bv, x)
    nx = round(AD.shape[0] ** (1 / 3))
    log(f"surface petsc_io {nx}^3 fp64 AIJ ({AD.nnz} nonzeros, {size / 1e6:.1f}"
        f" MB file): write {t_write:.3f} s, read {t_read:.3f} s, load (read"
        f" + assembly + placement) {t_load:.3f} s, against Mat.from_scipy's "
        f"{t_assembly:.3f} s; the loaded system: {res.iterations} iterations"
        f" ({res.reason_name}) against the original's {its_orig}")
    check((A2 != AD).nnz == 0, "the binary round trip changed the matrix")
    check(res.iterations == its_orig, "the loaded system solves differently")
    return {"bytes": size, "write_s": t_write, "read_s": t_read,
            "load_s": t_load, "assembly_s": t_assembly,
            "iterations": res.iterations}


def phase_surface_advanced():
    """``facade/drivers/advanced.py`` on the card: three converged scenarios,
    the errors of 1 and 3 at most 1e-8."""
    import contextlib
    import io
    from mpi_petsc4py_example_tpu_torch.facade.drivers import advanced
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = advanced.main(["advanced.py"])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"surface advanced.py: {line}")
    errs = [float(line.split("max err")[1]) for line in lines
            if "max err" in line]
    check(rc == 0 and len(lines) == 3
          and all("CONVERGED" in line for line in lines),
          "advanced.py did not converge in its three scenarios")
    check(len(errs) == 2 and max(errs) <= 1e-8, f"advanced.py errors {errs}")
    log(f"surface advanced.py: {wall:.2f} s")
    return {"lines": lines, "wall_s": wall}


def phase_surface():
    """Every phase of the KSP/PC/Mat/Vec surface slice."""
    import torch
    t0 = time.perf_counter()
    out = {"monitor": phase_surface_monitor()}
    out["gated_many"] = phase_surface_gated_many()
    out["shell"] = phase_surface_shell(
        out["monitor"]["iterations"], out["monitor"]["ms_per_iter"]["plain"])
    out["nullspace"], (AD, b, its) = phase_surface_nullspace()
    out["transpose"] = phase_surface_transpose(AD)
    out["petsc_io"] = phase_surface_petsc_io(AD, b, its)
    del AD, b
    torch.cuda.empty_cache()
    out["composite"] = phase_surface_composite()
    out["advanced"] = phase_surface_advanced()
    out["wall_s"] = time.perf_counter() - t0
    log(f"surface phases: {out['wall_s']:.1f} s")
    return out


def main():
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: FAIL: torch is not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAIL: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mpi_petsc4py_example_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    # the V-cycle's prolongation einsums must run in full fp32
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on")
    phase_build()
    if sys.argv[1:] == ["--mg3d"]:
        # only the per-level table of the two mg3d kernels and the CG + mg
        # warm walls, e.g. to time another checkout's csrc/ with this script
        # copied beside it
        print(json.dumps({"mg_levels": phase_mg_level_times(),
                          "mg_walls": phase_mg_walls()}))
        print(card_line())
        return
    if sys.argv[1:] == ["--eps"]:
        # only the eigensolver slice's phases
        check(phase_kernel_checks() is not None, "kernel checks")
        launches_eps, _ = phase_eps()
        check(launches_eps > 0, "stencil7_apply never launched on the EPS path")
        print(card_line())
        return
    if sys.argv[1:] == ["--kernels"]:
        # every kernel's resources, against its plain version, and its
        # times, no solve; e.g. to compare another checkout's csrc/ with this
        # script copied beside it
        phase_kernel_resources()
        phase_kernel_checks()
        phase_mg_kernel_checks()
        phase_many_kernel_checks()
        phase_bf16_kernel_checks()
        times = {}
        for n in (128, 512):
            times[n] = phase_kernel_times(n)
            times[n].update(phase_mg_kernel_times(n))
            times[n].update(phase_many_kernel_times(n))
            times[n].update(phase_bf16_kernel_times(n))
        times[128]["stencil7_apply f64"] = phase_eps_apply_times()
        phase_bf16_kernel_profile()
        print(json.dumps({"kernel_ms": {n: {name: r["ms"] for name, r in t.items()}
                                        for n, t in times.items()}}))
        print(card_line())
        return
    if sys.argv[1:] == ["--direct"]:
        # only the direct-solve and PC set-up slice's phases, with the two
        # assembled cells whose set-up it moves to the card
        direct = phase_direct()
        direct["cfg4"] = phase_aij_cfg4()
        direct["dense_lu"] = phase_aij_reference_flow()
        print(json.dumps({"direct": direct}))
        print(card_line())
        return
    if sys.argv[1:] == ["--surface"]:
        # only the KSP/PC/Mat/Vec surface slice's phases, behind the checks
        # of the four kernels they launch
        phase_kernel_checks()
        phase_many_kernel_checks()
        print(json.dumps({"surface": phase_surface()}, default=float))
        print(card_line())
        return
    if sys.argv[1:] == ["--refine"]:
        # only the mixed-precision slice's phases
        entries, refine = phase_refine()
        print(json.dumps({"kernels": entries, "refine": refine}))
        print(card_line())
        return
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    worst = phase_kernel_checks()
    worst.update(phase_mg_kernel_checks())
    times = {n: phase_kernel_times(n) for n in (128, 512)}
    for n in (128, 512):
        times[n].update(phase_mg_kernel_times(n))
    levels = phase_mg_level_times()
    # each path: counters zeroed just before, read just after
    launches, oracle = phase_main_path()
    launches_512 = phase_realistic()
    launches_mg = phase_mg_main_path(oracle)
    launches_mg_512 = phase_mg_realistic()
    launches_slab = phase_mg_slab()
    worst.update(phase_many_kernel_checks())
    for n in (128, 512):
        times[n].update(phase_many_kernel_times(n))
    launches_many, many_ctx = phase_many_main_path(oracle)
    launches_general = phase_many_general_route(many_ctx)
    phase_many_mixed(many_ctx)
    del many_ctx
    launches_many_512 = phase_many_realistic()
    # the assembled-matrix slice: no kernel of its own (its products are
    # torch index and slice ops), so no counter to read
    t_aij = time.perf_counter()
    phase_aij_main(oracle)
    phase_aij_cfg1()
    phase_aij_ell()
    phase_aij_cfg3()
    phase_aij_cfg4()
    phase_aij_many()
    phase_aij_reference_flow()
    log(f"assembled-matrix phases: {time.perf_counter() - t_aij:.1f} s")
    # the eigensolver slice: its operator applies are stencil7_apply's
    launches_eps, apply_f64 = phase_eps()
    # the mixed-precision slice: the bfloat16 instantiations of four kernels
    bf16_entries, _ = phase_refine()
    # the direct solves past the dense cap and the block PCs: no kernel
    phase_direct()
    # the KSP/PC/Mat/Vec surface: its new paths launch rows 1, 2, 9 and 10
    surface = phase_surface()
    surface_launches = {
        "stencil7_dot": (surface["monitor"]["stencil7_dot_launches"],
                         "128^3 CG+jacobi, monitored"),
        "stencil7_apply": (surface["shell"]["stencil7_apply_launches"],
                           "128^3 ShellMat wrapping the stencil, CG+jacobi"),
        "stencil7_dot_many": (
            surface["gated_many"]["stencil7_dot_many_launches"],
            f"128^3 k={K_BATCH} solve_many with the true-residual gate"),
        "stencil7_apply_many": (
            surface["gated_many"]["stencil7_apply_many_launches"],
            f"128^3 k={K_BATCH} solve_many gate's epilogue"),
    }

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        big, small = times[512][name], times[128][name]
        # the path whose run each kernel's launch count comes from
        if name in ("stencil7_apply", "stencil7_dot"):
            path, count, count_512 = ("128^3 CG+jacobi", launches[name],
                                      launches_512[name])
        elif name == "stencil7_residual":
            path, count, count_512 = ("64^3 fp64 CG+mg, 4-shard slab cycle",
                                      launches_slab[name], None)
        elif name == "stencil7_dot_many":
            path, count, count_512 = (f"128^3 k={K_BATCH} solve_many CG+jacobi",
                                      launches_many[name],
                                      launches_many_512[name])
        elif name == "stencil7_apply_many":
            path, count, count_512 = (
                f"128^3 k={K_BATCH} solve_many CG+jacobi, general route "
                "(Amat != Pmat)", launches_general[name], None)
        else:
            path, count, count_512 = ("128^3 CG+mg", launches_mg[name],
                                      launches_mg_512[name])
        check(count > 0, f"{name} was not launched on its path ({path})")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count, "path": path,
            "max_abs_err": max(worst[name], big["max_abs_err"]),
            "ms": big["ms"], "kernel_ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"],
            "shape": ([K_BATCH] if name in MANY_KERNELS else []) + [512] * 3,
            "dtype": "float32", "at_128": small, "launches_512": count_512})
        if name in levels:
            kernels[-1]["levels_512"] = levels[name]
        if name == "stencil7_dot":
            kernels[-1]["dot_rel_err"] = worst["dot_rel"]
        if name == "stencil7_apply":
            # the eigensolver path: 128^3 fp64 Krylov-Schur, four solves
            kernels[-1]["launches_eps"] = launches_eps
            kernels[-1]["eps_128_f64"] = apply_f64
        if name == "stencil7_dot_many":
            kernels[-1]["dot_rel_err"] = worst["dot_many_rel"]
        if name in surface_launches:
            count_s, path_s = surface_launches[name]
            check(count_s > 0, f"{name} was not launched on {path_s}")
            kernels[-1]["launches_surface"] = count_s
            kernels[-1]["path_surface"] = path_s
    for entry in bf16_entries:
        check(entry["launches"] > 0, f"{entry['name']} was not launched on "
                                     f"its path ({entry['path']})")
    kernels += bf16_entries
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
