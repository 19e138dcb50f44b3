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
  AIJ through the PETSc binary format; and ``facade/drivers/advanced.py``;
* the process communicator (``ProcessComm`` on ``torch.distributed``; no
  kernel of its own, every kernel launches per local shard): 128^3 f32 CG +
  Jacobi on NCCL, 1 process x 4 shards, and on gloo, 2 processes x 2
  shards, each against ``DeviceComm(4)`` bit for bit (with the
  ``stencil7_dot`` launches, ms/iter and the us of one psum); k = 8
  ``solve_many`` at 128^3 (fast path and general route) and 64^3 fp64 CG +
  mg on gloo 2 x 2; 512^3 on gloo 2 x 1 against ``DeviceComm(2)`` (equal
  iterations, fp64 true residual, ms/iter with the host copies: one card
  shared by two processes, not scaling); the rest of the stack on both
  (the 128^3 fp64 Krylov-Schur of the eigensolver phases, with its
  restarts, lambda against the closed form, ``stencil7_apply`` launches per
  local shard, ms, psums and shifts per restart; on gloo also cfg11's
  refinement at 128^3 with f32 and bf16 inner solves, the 128^3 Neumann AIJ
  with a null space, CGNE on ``convdiff2d(1024)`` and PC lu crtri at 2^20);
  the ``test.py`` and ``test2.py`` flows through ``run.py --procs`` at -n 1
  (NCCL), 2 and 4 (gloo), and the 128^3 f32 CG + Jacobi as cg, pipecg and
  sstep s = 4 on both (psums and shifts an iteration);
* the Krylov types of ROADMAP Queue A item 5 (no kernel of their own; they
  launch rows 1, 2, 9, 2b and 9b): every type at 128^3 f32 with PC jacobi
  beside cg (iterations, reason, the fp64 true relres held to bench.py's
  parity rule where the JAX package reaches rtol in f32, warm ms/iter, host
  syncs, launches, the plain-version path), pipecg also in fp64, richardson
  and chebyshev at max_it 2000 and on 32^3 fp64; cg, pipecg and sstep s = 4
  at 512^3 (delta method against the passes counted from the code, peak
  memory); k = 8 ``solve_many`` with pipecg and sstep (each column against
  its single solve); bf16 pipecg, sstep and richardson, single and k = 8;
  cfg4 with the unsymmetric types and cfg3 with lgmres beside gmres(30).

* the bf16 V-cycle and the fused program (``--megasolve``): rows 3b-6b
  (``stencil7_{smooth,residual,smooth0_pair}_bf16``, ``mg3d_smooth_pair_bf16``)
  bit for bit against their plain versions at every level shape of the
  driven cycles and at tile edges, on both routes, the pair against two
  smooth launches, timed at 128^3 and 512^3 against their bytes bounds and
  the pair in turns with the two smooth launches it fuses;
  PC mg under refinement at 128^3 (cfg11's problem, bf16 and f32 inner,
  host loop and fused, V-cycle launches against the formula); cfg13 of
  ``benchmarks/run_all.py`` at 128^3 (fused against the host loop, cold
  and warm walls, replays, host reads, masked steps); ``KSP
  -ksp_megasolve`` at 128^3 f32 (cg fast path, cg + mg, pipecg, sstep, a
  k = 8 block; ms/iter fused against unfused, the idle share); every
  captured run bit-equal to an uncaptured one; the fused cases on NCCL 1 x 4
  (captured) and gloo 2 x 2 (uncaptured) bit-equal to ``DeviceComm(4)``;
  and ``-ksp_reduction_auto``'s latencies, ranking and choice on
  ``DeviceComm(1)``, ``DeviceComm(4)``, NCCL 1 x 4 and gloo 2 x 2;
* complex scalars (``--complex``; no kernel of their own: the JAX
  package's complex operators never reach a Pallas kernel): the Helmholtz
  driver's operator at nx = 1024 (1,048,576 unknowns), complex128 GMRES(30)
  and BiCGStab + Jacobi at rtol 1e-10 (the example's ``allclose`` check,
  fp64 true relres) and complex64 GMRES at 1e-5; the 128^3 Laplacian with
  phased x-bonds (Hermitian, complex128 DIA): CG + Jacobi unfused and with
  ``-ksp_megasolve`` (captured bit-equal to uncaptured), and Krylov-Schur
  against 6 + 6 cos(pi/129); the 1D phase Laplacian + 0.5 at 2^20 rows by
  preonly + cholesky on the crtri route; each beside its real twin (ms per
  iteration, restart or apply) in the same call; and, in the process
  phases, complex GMRES at nx = 128 on NCCL 1 x 4 and gloo 2 x 2 bit for
  bit against ``DeviceComm(4)``;
* the resilience layer (``--resilience``; no kernel of its own: the
  guarded loops launch rows 1, 2 and 9): (a) 512^3 f32 CG + Jacobi with
  the guard off, ``-ksp_abft`` and ``-ksp_abft -ksp_residual_replacement
  50`` (iterations, detections, ABFT checks, launches, fp64 relres,
  delta-method ms/iter and the overhead); (b) cfg8 of
  ``benchmarks/run_all.py`` at 64^3 and 128^3 (the assembled CG, PC none,
  guard off and on); (c) the chaos drill at 128^3 fp64 (bitflip and scale
  at ``spmv.result`` and ``pc.apply``, one RHS and k = 8, a ``ksp.program``
  crash, a NaN residual through ``KSPFallbackChain``, a corrupted
  reduction; each recovered to an fp64 relres <= 10 rtol; the unguarded
  control; the chain re-raising a device fault and refusing a host-LU
  stage); (d) guarded pipecg and sstep s = 4 at 128^3 and 512^3; (e) the
  elastic shrink 4 -> 2 and regrow on ``DeviceComm(4)`` from checkpoints;
  (f) the guarded CG with a bitflip on NCCL 1 x 4 and gloo 2 x 2 bit for
  bit against ``DeviceComm(4)``. The no-argument run leaves out (a)'s
  rr 50 run, (b)'s 128^3 cell, (c)'s scale cases and batched cases but
  one, and (d)'s 512^3 timing, runs (e) at 64^3, and takes (f) from the
  process phases' launches.
* the serving layer (``--serving``; no kernel of its own: served blocks
  launch rows 9 and 10) at 128^3: (a) cfg9's shape
  (``benchmarks/run_all.py:912-1030``), f32 CG + Jacobi through a
  ``SolveServer``, 64 seeded Poisson arrivals at 50x the sequential rate,
  ``max_k`` 8, one injected ``ksp.program`` crash; every answer's fp64 true
  relres <= 1.05 rtol from the host workers, the ``stencil7_dot_many``
  launches against the blocks' iterations, solves/s against sequential,
  latency and queue-wait percentiles, batch widths; (b) the same session
  fused (``megasolve``, the stencil fast path): the graphs captured on the
  dispatcher thread, the served block bit-equal to the uncaptured run; (c)
  cfg17's shape (``:2105-2221``) at fp64: 24 requests with their own rtols,
  the persistent program (Q = 8) against per-batch fused dispatch, its
  dispatches a request < 1, each answer within its own rtol.
* the fleet (``--fleet``; ``SolveRouter`` and ``FleetManager``, no kernel of
  their own: routed stencil sessions launch rows 9 and 10; the replicas
  share the one card, so rates against the replica count are comparisons):
  (a1) cfg14's shape (``benchmarks/run_all.py:1614``) on the 128^3 f32
  stencil, four sessions (one fused), 48 requests through fleets of 1 and 2
  replicas; (a2) 32 bulk then 8 interactive requests, interactive p99 below
  bulk's; (a3) a 64^3 f32 AIJ session migrated under load, the held
  submissions replayed; (a4) a 64^3 f32 AIJ replica on ``DeviceComm(4)``
  through a shard loss, ``heal()`` and ``heal_check()`` back to 4 shards;
  (b) cfg18's shape (``:2244``) at 64^3 fp64 AIJ, rtol 1e-10: a 2-host
  ``FleetManager`` over the loopback and the 127.0.0.1 socket transports,
  4 sequential requests each (checkpoint refresh ms a request), then the
  owner killed after a lease step and the failover resumed past iteration
  0. Every answer's fp64 true relres is held to 1.05 rtol.

* the other eigensolver types and SVD (``--eps-types``; no kernel of their
  own: LOBPCG's and GD's block products launch row 9, ``compute_error``
  row 2): row 9 at LOBPCG's shape (9 x 128^3 fp64) against its plain
  version, cuDNN's conv3d and its bound; (a) LOBPCG on the 128^3 fp64
  stencil, the 3 smallest pairs at tol 1e-8, against the closed form
  (lambda(1,1,1), lambda(2,1,1) twice) within 1e-9, its host reads and
  ``stencil7_apply_many`` launches against the formulas, the warm ms an
  iteration and a profile of iterations 11-60 (two profiled solves
  differenced); (b) the same at 32^3 on the plain path; (c) GD on the same
  problem at ``GD_NX``^3 (20^3 in the no-argument run); (d) power,
  subspace and arnoldi on ``tridiag_family(4096)`` as an fp64 Mat against
  EPS lapack; (e) LOBPCG on the 64^2 GHEP (B a seeded diagonal) and the
  complex128 phased 64^2 Laplacian against LAPACK's eigenvalues within
  1e-9; (f) the SVD of the 64^3 gradient (sigma_max and the 3 smallest
  against sqrt of the Laplacian's closed form, within 1e-8); (g) the
  advanced tour's four lines. The dense references run in worker
  processes meanwhile.

``python3 chip_smoke.py --eps-types`` builds the kernels, checks rows 2, 9
and 10 and runs only those phases (a)-(g); ``--gd-sizes`` runs GD on (c)'s
problem at 128^3 down to 24^3, each under a 20 s budget.
``python3 chip_smoke.py --serving`` builds the kernels, checks rows 9 and 10
and runs only the serving phases (a)-(c). ``python3 chip_smoke.py --fleet``
does the same for the fleet's phases (a1)-(a4) and (b).
``python3 chip_smoke.py --resilience`` builds the kernels, checks rows 1,
2, 9 and 10, and runs only the resilience phases (a)-(f).
``python3 chip_smoke.py --megasolve`` builds the kernels and runs only the
phases of the bf16 V-cycle and fused-program item. ``python3 chip_smoke.py
--complex`` runs only the complex-scalar phase. ``python3 chip_smoke.py
--ksp-types`` builds the kernels, checks the ones
the Krylov types launch and runs only their phases. ``python3 chip_smoke.py --surface`` builds the kernels, checks the four the
surface slice launches, and runs only its phases. ``python3 chip_smoke.py
--procs`` runs the kernel checks and the process communicator's phases;
``python3 chip_smoke.py --procs-cards``, on a host of several cards, runs
one rank per card over NCCL against ``DeviceComm(cards)`` on one.
``python3 chip_smoke.py --nccl-capture``, on a host of several cards,
diagnoses CUDA graph capture of the process communicator's collectives
over NCCL, stage by stage, each stage's hang ending in a dump of its
rank's stacks (``phase_nccl_capture``); ``--nccl-capture-release`` drops
the graphs before the ranks' teardown.
``python3 chip_smoke.py --refine`` builds the kernels and runs only the
mixed-precision phases. ``python3 chip_smoke.py --direct`` runs only the
direct-solve phases, cfg4, the ``test.py`` flow and the dense lu. ``python3 chip_smoke.py --kernels`` builds the
kernels, prints each one's registers and spills (ptxas), checks every one
against its plain version and times it, and solves nothing.
``python3 chip_smoke.py --eps`` builds the kernels, checks them and runs
only the eigensolver phases. ``python3 chip_smoke.py --mg3d`` builds the
kernels and prints only the per-level table of the ``csrc/mg3d.cu`` kernels
(the two f32 ones and the bf16 pair over the levels of the 512^3 and 128^3
cycles) and the warm CG + mg walls at 128^3 and 512^3. A copy of this
script placed in another checkout runs that checkout's kernels, so
``--kernels``, ``--mg3d`` and ``--stencil7`` compare two trees in turns on
one card. ``python3 chip_smoke.py --stencil7`` builds the kernels and runs
only rows 1, 2, 9 and 10: their checks against the plain versions, their
times at 128^3 and 512^3 in f32 and f64 with their bounds, the kernels one
dot call launches, and the 128^3 f32 CG + Jacobi ms/iter unfused and fused
with the 512^3 delta-method ms/iter.

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
import shutil
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


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"timing: {fn.__name__} {time.perf_counter() - t0:.1f} s")
    return out


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


# the shapes of phase_kernel_checks: the main paths' 128^3 and 512^3, small
# and odd planes, and the edges of the run kernel behind the f32/f64 dots:
# 128^2 planes one plane past an 8-plane z-chunk (lz = 129), nx one short of
# and one past a multiple of a run (4 f32 points, 2 f64) and of a block's run
# width (1024 f32 points, 512 f64), and a plane of a single row
KERNEL_CHECK_SHAPES = ((128, 128, 128), (3, 7, 33), (1, 8, 128),
                       (100, 130, 200), (512, 512, 512), (129, 128, 128),
                       (9, 5, 127), (9, 5, 129), (3, 2, 511), (3, 2, 513),
                       (3, 2, 1023), (3, 2, 1025), (17, 1, 256))


def dot_route_of(st, u, lo, hi, y):
    """The route of a dot launch on these tensors, as the library reports
    it (a checkout without ``dot_route`` has one route)."""
    route = getattr(st, "dot_route", None)
    return route(u, lo, hi, y) if route else "one"


def dot_blocks(st, dtype, shape):
    """The dot's partials a column at this shape (the library of a checkout
    older than the one-launch dots has one count for f32 and f64)."""
    lib = st._kernels()
    fn = getattr(lib, f"stencil7_dot_blocks_{st._SUFFIX[dtype]}", None)
    return (fn or lib.stencil7_dot_blocks)(*shape)


def phase_kernel_checks():
    """Rows 1 and 2 (the dot and the apply) against their plain versions on
    the card, f32 and f64, at ``KERNEL_CHECK_SHAPES``: ``A u`` bit-exact,
    the dot within 1e-4 (f32) or 1e-12 (f64) relative, and on misaligned
    copies of the inputs (the dot's element route) the same ``A u`` and the
    same sum bit for bit; every dot launch's route and partial count
    logged. Then the dot's determinism: one sum over 5 eager runs and over a
    CUDA graph's capture and 3 replays of row 1 and row 10 (k = 8), which
    also shows that the fold's ticket counters are left at zero. Returns
    the largest f32 errors per kernel."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    t0 = time.perf_counter()
    worst = {"stencil7_apply": 0.0, "stencil7_dot": 0.0, "dot_rel": 0.0}
    limits = {torch.float32: (1e-6, 1e-4), torch.float64: (1e-13, 1e-12)}
    for dtype, (y_tol, dot_tol) in limits.items():
        for i, shape in enumerate(KERNEL_CHECK_SHAPES):
            u, lo, hi = random_slab(shape, dtype, 100 + i)
            ref = st.stencil3d_apply_plain(u, lo, hi)
            y = st.stencil3d_apply(u, lo, hi)
            yd, d = st.stencil3d_dot(u, lo, hi)
            dref = (u * ref).sum()
            um, lom, him = (misaligned_copy(t) for t in (u, lo, hi))
            ym = misaligned_copy(torch.zeros_like(u))
            _, dm = st.stencil3d_dot(um, lom, him, out=ym)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            e_apply = float((y - ref).abs().max())
            e_dot_y = float((yd - ref).abs().max())
            e_dot = abs(float(d) - float(dref)) / abs(float(dref))
            routes = (dot_route_of(st, u, lo, hi, yd),
                      dot_route_of(st, um, lom, him, ym))
            same = bool(torch.equal(ym, yd) and torch.equal(dm, d))
            log(f"check {str(dtype)[6:]} {shape}: apply max|err| {e_apply:.3e}, "
                f"dot y max|err| {e_dot_y:.3e}, dot rel err {e_dot:.3e} "
                f"(max|y| {scale:.3e}, {dot_blocks(st, dtype, shape)} "
                f"partials, route {routes[0]}; misaligned copies, route "
                f"{routes[1]}: the same y and sum {same})")
            check(e_apply <= y_tol * scale, f"apply {dtype} {shape}: {e_apply}")
            check(e_dot_y <= y_tol * scale, f"dot y {dtype} {shape}: {e_dot_y}")
            check(e_dot <= dot_tol, f"dot sum {dtype} {shape}: rel {e_dot}")
            check(same, f"dot on misaligned copies differs, {dtype} {shape}")
            if dtype == torch.float32:
                worst["stencil7_apply"] = max(worst["stencil7_apply"], e_apply)
                worst["stencil7_dot"] = max(worst["stencil7_dot"], e_dot_y)
                worst["dot_rel"] = max(worst["dot_rel"], e_dot)
            del u, lo, hi, ref, y, yd, d, dref, um, lom, him, ym, dm
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # the dot is deterministic: no float atomics, a fixed-order sum of the
    # partials, whichever block finishes last
    for dtype in (torch.float32, torch.float64):
        u, lo, hi = random_slab((128, 128, 128), dtype, 7)
        U = torch.stack([u] * K_BATCH)
        LO, HI = torch.stack([lo] * K_BATCH), torch.stack([hi] * K_BATCH)
        y, Y = torch.empty_like(u), torch.empty_like(U)
        eager = [st.stencil3d_dot(u, lo, hi, out=y)[1].clone() for _ in range(5)]
        eager_many = [st.stencil3d_dot_many(U, LO, HI, out=Y)[1].clone()
                      for _ in range(5)]
        check(all(torch.equal(e, eager[0]) for e in eager),
              f"dot not deterministic across runs ({dtype}): {eager}")
        check(all(torch.equal(e, eager_many[0]) for e in eager_many)
              and bool((eager_many[0] == eager[0]).all()),
              f"dot_many not deterministic or not equal to the single dot "
              f"({dtype})")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm-up outside the capture
            st.stencil3d_dot(u, lo, hi, out=y)
            st.stencil3d_dot_many(U, LO, HI, out=Y)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, d_graph = st.stencil3d_dot(u, lo, hi, out=y)
            _, d_many_graph = st.stencil3d_dot_many(U, LO, HI, out=Y)
        replays = []
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            replays.append((d_graph.clone(), d_many_graph.clone()))
        after = st.stencil3d_dot(u, lo, hi, out=y)[1]
        same = (all(torch.equal(a, eager[0]) and torch.equal(b, eager_many[0])
                    for a, b in replays) and torch.equal(after, eager[0]))
        log(f"check {str(dtype)[6:]} 128^3: dot {float(eager[0])!r} over 5 "
            f"eager runs, dot_many k={K_BATCH} the same in every column, and "
            f"over a graph's 3 replays and an eager run after them: the same "
            f"bits {same}")
        check(same, f"dot under graph replay differs ({dtype})")
        del graph, u, lo, hi, U, LO, HI, y, Y, d_graph, d_many_graph
    torch.cuda.empty_cache()
    bad = torch.float16           # bfloat16 has its own kernels (--refine)
    u, lo, hi = random_slab((8, 8, 8), torch.float32, 7)
    try:
        st.stencil3d_apply(u.to(bad), lo.to(bad), hi.to(bad))
    except TypeError:
        pass
    else:
        raise SystemExit(f"chip_smoke: FAIL: {bad} on CUDA did not raise")
    log(f"check: fp16 raises TypeError; rows 1-2 checks {t1 - t0:.1f} s at "
        f"{len(KERNEL_CHECK_SHAPES)} shapes, determinism and graph replays "
        f"{time.perf_counter() - t1:.1f} s")
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


def row_times(n, dtype, k=K_BATCH):
    """Kernel ms of rows 2 and 1 (apply, dot) at n^3 and of rows 9 and 10
    (apply_many, dot_many) at k x n^3 in ``dtype``, each beside its bytes
    bound and the share of it reached (CUDA events, ``device_ms``)."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    itemsize = torch.empty((), dtype=dtype).element_size()
    big = n >= 512
    u, lo, hi = random_slab((n, n, n), dtype, 11)
    y = torch.empty_like(u)
    cases = [("stencil7_apply", 1, lambda: st.stencil3d_apply(u, lo, hi, out=y)),
             ("stencil7_dot", 1, lambda: st.stencil3d_dot(u, lo, hi, out=y))]
    out = {}
    for kk in (1, k):
        if kk > 1:
            del u, lo, hi, y
            g = torch.Generator(device="cuda").manual_seed(13)
            mk = lambda *sh: torch.rand(sh, generator=g, device="cuda", dtype=dtype)
            U, LO, HI = mk(k, n, n, n), mk(k, n, n), mk(k, n, n)
            Y = torch.empty_like(U)
            cases = [("stencil7_apply_many", k,
                      lambda: st.stencil3d_apply_many(U, LO, HI, out=Y)),
                     ("stencil7_dot_many", k,
                      lambda: st.stencil3d_dot_many(U, LO, HI, out=Y))]
        for name, kk_, fn in cases:
            b_ms, b_by = bound_ms(n, n, n, itemsize, name.startswith("stencil7_dot"), kk_)
            ms = device_ms(fn, (10 if kk_ > 1 else 20) if big else 100,
                           reps=10 if big else 25)
            out[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                         "pct_of_bound": b_ms / ms * 100}
            log(f"time {name} {str(dtype)[6:]} {'' if kk_ == 1 else f'{kk_} x '}"
                f"{n}^3: kernel {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}), "
                f"{b_ms / ms * 100:.1f}% of it")
    del U, LO, HI, Y
    torch.cuda.empty_cache()
    return out


def dot_kernels_per_call(dtype, n=128, k=K_BATCH, calls=20):
    """The CUDA kernels one ``stencil3d_dot`` call (n^3) and one
    ``stencil3d_dot_many`` call (k x n^3) launch, by name, from a
    ``torch.profiler`` window over ``calls`` calls of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    u, lo, hi = random_slab((n, n, n), dtype, 3)
    U = torch.stack([u] * k)
    LO, HI = torch.stack([lo] * k), torch.stack([hi] * k)
    out = {}
    for label, fn in (("dot", lambda: st.stencil3d_dot(u, lo, hi)),
                      ("dot_many", lambda: st.stencil3d_dot_many(U, LO, HI))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = {e.key[:60]: e.count / calls for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0}
        out[label] = rows
        log(f"profile {label} {str(dtype)[6:]}: kernels a call {rows}")
    return out


def stencil7_main_path(nx=128, big=512):
    """The 128^3 f32 CG + Jacobi (bench.py's problem, rtol 1e-6) warm
    ms/iter unfused and fused (``-ksp_megasolve``, best of 3 solves) with the
    dot launches of the unfused solve, and the 512^3 delta-method ms/iter
    (20 and 220 fixed iterations, median of 3)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    out = {}
    for fused in (False, True):
        ksp = ksp_solver(comm, op, "cg", rtol=1e-6, megasolve=fused,
                         megasolve_stencil_fastpath=True)
        x, _ = op.get_vecs()

        def run():
            x.zero()
            return ksp.solve(bv, x)
        run()
        torch.cuda.synchronize()
        st.reset_launches()
        res = run()
        torch.cuda.synchronize()
        dots = st.stencil3d_dot.launches
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        label = "fused" if fused else "unfused"
        out[label] = {"iterations": res.iterations, "reason": res.reason,
                      "ms_per_iter": min(walls) / res.iterations * 1e3,
                      "dot_launches": dots}
        log(f"stencil7 main path {nx}^3 f32 cg+jacobi {label}: "
            f"{res.iterations} iterations, {res.reason_name}, "
            f"{out[label]['ms_per_iter']:.4f} ms/iter (warm best of 3), "
            f"stencil7_dot launches {dots}")
        check(res.converged, f"{nx}^3 {label} solve did not converge")
        check(fused or dots == res.iterations + 1,
              f"dot launches {dots} != iterations + 1")
        del ksp
        ms.clear_cache()
    del op, bv
    torch.cuda.empty_cache()
    n = big ** 3
    op = pt.StencilPoisson3D(comm, big, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    bv = op.mult(pt.Vec(comm, n, data=torch.rand(n, generator=g, device="cuda")))
    x, _ = op.get_vecs()
    solvers = {m: cg_jacobi(comm, op, 0.0, max_it=m, norm_none=True)
               for m in (20, 220)}
    per_iter = []
    for _ in range(3):
        walls = {}
        for m, k in solvers.items():
            x.zero()
            t0 = time.perf_counter()
            r = k.solve(bv, x)
            walls[m] = (time.perf_counter() - t0, r.iterations)
        per_iter.append((walls[220][0] - walls[20][0])
                        / (walls[220][1] - walls[20][1]))
    out["delta_512"] = statistics.median(per_iter) * 1e3
    log(f"stencil7 main path {big}^3 f32 cg+jacobi delta method: "
        f"{out['delta_512']:.4f} ms/iter (samples "
        f"{[round(p * 1e3, 4) for p in per_iter]})")
    del op, bv, x, solvers
    torch.cuda.empty_cache()
    return out


def phase_stencil7():
    """``--stencil7``: rows 1, 2, 9 and 10 against their plain versions
    (``phase_kernel_checks``, ``phase_many_kernel_checks``), their times at
    128^3 and 512^3 in f32 and f64 (k = 8 for rows 9-10), the kernels a dot
    call launches, and the main path's ms/iter."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    t0 = time.perf_counter()
    worst = phase_kernel_checks()
    worst.update(phase_many_kernel_checks())
    t1 = time.perf_counter()
    times = {f"{n} {str(dtype)[6:]}": row_times(n, dtype)
             for n in (128, 512) for dtype in (torch.float32, torch.float64)}
    per_call = {str(dtype)[6:]: dot_kernels_per_call(dtype)
                for dtype in (torch.float32, torch.float64)}
    if hasattr(st, "dot_route"):
        # the one-launch dots: one kernel a call, no second summing launch
        for dt, rows in per_call.items():
            for label, kernels in rows.items():
                check(sum(kernels.values()) == 1
                      and not any("sum_partials" in name for name in kernels),
                      f"{label} {dt}: kernels a call {kernels}")
    t2 = time.perf_counter()
    main = stencil7_main_path()
    log(f"stencil7 phases: checks {t1 - t0:.1f} s, times {t2 - t1:.1f} s, "
        f"main path {time.perf_counter() - t2:.1f} s")
    return {"worst": worst, "times": times, "kernels_per_call": per_call,
            "main_path": main}


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
    the n^3 cycle that runs them (n^3 down to 8^3), f32, and beside them the
    bf16 pair (row 6b; the levels of the 128^3 cycle are the lower ones):
    kernel ms, bound ms, % of bound and the wrapper's host us per call, on
    random inputs, each checked bit-exact against its plain version first.
    Returns ``{name: [row per level]}``."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    from mpi_petsc4py_example_tpu_torch.solvers.mg import mg_levels
    out = {"mg3d_smooth_pair": [], "mg3d_residual_restrict": [],
           "mg3d_smooth_pair_bf16": []}
    t0 = time.perf_counter()
    secs = {name: 0.0 for name in out}
    for lvl in mg_levels(n, n, n)[:-1]:
        calls = mg_kernel_calls(st, torch.float32, lvl, 61)
        g = torch.Generator(device="cuda").manual_seed(62)
        u16, f16 = ((torch.rand(lvl, generator=g, device="cuda") - 0.5).to(
            torch.bfloat16) for _ in range(2))
        calls["mg3d_smooth_pair_bf16"] = vcycle_bf16_calls(
            st, u16, f16, None, None)["mg3d_smooth_pair_bf16"]
        big = lvl[0] >= 256
        for name, rows in out.items():
            t_row = time.perf_counter()
            kern, plain = calls[name]
            err = max_abs_diff(kern(), plain())
            check(err == 0.0, f"{name} {lvl}: max|err| {err}")
            ms = device_ms(kern, 20 if big else 100, reps=15 if big else 25)
            size = 2 if name.endswith("bf16") else 4
            b_ms, _ = mg_bound_ms(name.removesuffix("_bf16"), lvl, size)
            host = host_us_per_call(kern)
            route = mg3d_route(lvl[2], size)
            rows.append({"shape": list(lvl), "ms": ms, "bound_ms": b_ms,
                         "pct_of_bound": b_ms / ms * 100, "host_us": host,
                         "route": route})
            log(f"level {name} {lvl} {'bf16' if size == 2 else 'f32'}: "
                f"kernel {ms:.5f} ms, bound {b_ms:.5f} ms "
                f"({b_ms / ms * 100:.1f}% of it), host {host:.2f} us/call, "
                f"route {route}")
            secs[name] += time.perf_counter() - t_row
        del calls, u16, f16
        torch.cuda.empty_cache()
    log(f"level times: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
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
    t0 = time.perf_counter()
    x_cpu, info, cpu_wall = host_oracle(oracle_cg, nx, bb, rtol).result()
    waited = time.perf_counter() - t0
    bnorm = np.linalg.norm(bb)
    r_port = np.linalg.norm(bb - A @ x_port.astype(np.float64))
    r_cpu = np.linalg.norm(bb - A @ x_cpu)
    parity = bool(r_port <= 10 * max(r_cpu, rtol * bnorm))
    log(f"parity vs scipy fp64 CG (info {info}, {cpu_wall:.2f} s in a worker "
        f"process, {waited:.2f} s waited for here): "
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
    f64, k in {1, 3, 8, 16}, shapes (128,128,128), (17,9,33), (4,4,4) and
    two edges of the dots' run kernel (128^2 planes one plane past a z-chunk,
    nx one short of a run), random and null (zero) halos. ``A U`` must be
    bit-exact with the plain version, the per-column dots within the
    single-RHS dot's limit, and every column bit-equal (``A u`` and dot) to
    one ``stencil7_apply``/``stencil7_dot`` launch on it. Returns the
    largest f32 errors per kernel."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    worst = {"stencil7_apply_many": 0.0, "stencil7_dot_many": 0.0,
             "dot_many_rel": 0.0}
    dot_tol = {torch.float32: 1e-4, torch.float64: 1e-12}
    seed = 500
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        for k in (1, 3, K_BATCH, 16):
            for shape in ((128, 128, 128), (17, 9, 33), (4, 4, 4),
                          (129, 128, 128), (9, 5, 127)):
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
    log(f"check many: {time.perf_counter() - t0:.1f} s")
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


def scipy_cg(A, b, rtol, maxiter=20000):
    import scipy.sparse.linalg as spla
    M = spla.LinearOperator(A.shape, matvec=lambda v: v / 6.0)
    x, info = spla.cg(A, b, rtol=rtol, atol=0.0, maxiter=maxiter, M=M)
    return x, info


# ---- host references, computed in worker processes beside the card's work ----

ORACLE_WORKERS = 4
_ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                "MKL_NUM_THREADS")}
_ORACLES: dict = {}
_ORACLE_POOL: list = []


def oracle_cg(nx, b, rtol, maxiter=20000):
    """scipy's fp64 CG + Jacobi on the ``nx^3`` Poisson matrix:
    ``(x, info, seconds)``."""
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson3d_csr
    A = poisson3d_csr(nx).astype(np.float64)
    t0 = time.perf_counter()
    x, info = scipy_cg(A, b, rtol, maxiter)
    return x, info, time.perf_counter() - t0


def oracle_eigvals(nx, beta):
    """``numpy.linalg.eigvals`` of the dense ``convdiff2d(nx)``:
    ``(eigenvalues, seconds)``."""
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    A = convdiff2d(nx, beta=beta).toarray()
    t0 = time.perf_counter()
    return np.linalg.eigvals(A), time.perf_counter() - t0


def host_oracle(fn, *args, threads=1):
    """``fn(*args)``, a host reference (scipy's fp64 CG, numpy's dense
    eigenvalues), as a future: it runs in one of ``ORACLE_WORKERS`` spawned
    worker processes with one BLAS thread each (a pool of its own for each
    other ``threads``), so that the card's phases go on meanwhile. The same
    call again (the same arrays, by their bytes) returns the same future: a
    reference started early (:func:`start_host_oracles`) is waited for
    where its phase needs it."""
    import concurrent.futures
    import hashlib
    import multiprocessing
    key = (fn.__name__,) + tuple(
        hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()
        if isinstance(a, np.ndarray) else a for a in args)
    if key not in _ORACLES:
        # a worker reads the variables when it starts (on a submit)
        saved = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update({k: str(threads) for k in _ONE_THREAD})
        try:
            pool = dict(_ORACLE_POOL).get(threads)
            if pool is None:
                pool = concurrent.futures.ProcessPoolExecutor(
                    max_workers=ORACLE_WORKERS if threads == 1 else
                    max(1, 6 // threads),
                    mp_context=multiprocessing.get_context("spawn"))
                _ORACLE_POOL.append((threads, pool))
            _ORACLES[key] = pool.submit(fn, *args)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return _ORACLES[key]


def start_host_oracles():
    """Start the no-argument run's host references at once, the longest
    first: the NHEP eigenvalues of the eigensolver phase, cfg11's 128^3
    fp64 CG at rtol 1e-10, and the 128^3 CG + Jacobi of the main path and
    of each other column of the batched main path (right-hand sides made
    on the card, as those phases make them). They run beside the kernel
    checks and times; their phases wait for them."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    t0 = time.perf_counter()
    host_oracle(oracle_eigvals, NHEP_NX, NHEP_BETA)
    _, b = cfg11_problem(EPS_NX)
    host_oracle(oracle_cg, EPS_NX, b, REFINE_RTOL, 40000)
    comm = pt.DeviceComm()
    op, b = make_problem(comm, 128, torch.float32)
    host_oracle(oracle_cg, 128, b.astype(np.float64), 1e-6)
    B, _ = bench_block(comm, op, b, K_BATCH)
    for j in range(1, K_BATCH):
        host_oracle(oracle_cg, 128, B[:, j].astype(np.float64), 1e-6)
    del op, B
    torch.cuda.empty_cache()
    reset_launches()
    log(f"host references: {len(_ORACLES)} started in "
        f"{ORACLE_WORKERS} worker processes ({time.perf_counter() - t0:.1f} "
        "s to make their inputs)")


def stop_background():
    """Stop what this run started beside its phases: the rank launches
    still running (after a failure) and the reference workers, the busy
    ones terminated."""
    for launch in _LAUNCHES:
        launch.stop()
    while _ORACLE_POOL:
        _, pool = _ORACLE_POOL.pop()
        if any(not f.done() for f in _ORACLES.values()):
            for proc in list(getattr(pool, "_processes", {}).values()):
                proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


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
    futures = {j: host_oracle(oracle_cg, nx, B[:, j].astype(np.float64),
                              rtol) for j in range(1, k)}
    for j in range(k):
        bb = B[:, j].astype(np.float64)
        r_cpu = oracle["r_cpu"] if j == 0 else float(
            np.linalg.norm(bb - A @ futures[j].result()[0]))
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


def phase_aij_reference_flow(n_dense=4096, flows=True):
    """The reference test.py flow through the port's runner and facade on
    the card (-n 1 and -n 4, preonly + lu + 'mumps', must print True; the
    no-argument run starts it with the procs phase's launches, ``flows``
    False here); then a dense direct solve in f64 at n = 4096
    (random_system(4096, seed 42, density 0.01), preonly + lu) with
    np.allclose(x, X), set up on the card (-pc_setup_device auto) and on
    the host (0)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import random_system
    if flows:
        finish_flows(start_flows(flow_specs("test.py", procs=False)),
                     "both at once")
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


NHEP_NX, NHEP_BETA = 64, 0.3     # convdiff2d(64), cfg4's family


def phase_eps_nhep(nx=NHEP_NX, beta=NHEP_BETA):
    """Krylov-Schur on the unsymmetric convection-diffusion operator
    convdiff2d(64) (cfg4's family), NHEP, the largest real part, against
    ``numpy.linalg.eigvals`` of the dense matrix within 1e-8 relative. Its
    eigenvalue is ill-conditioned (the operator is far from normal), so the
    residual tolerance that bounds it is 1e-12; the default 1e-8 run is
    logged beside it."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    A = convdiff2d(nx, beta=beta)
    comm = pt.DeviceComm()
    m = pt.Mat.from_scipy(comm, A, dtype=torch.float64)
    lam_all, t_eig = host_oracle(oracle_eigvals, nx, beta).result()
    want = complex(lam_all[np.argmax(lam_all.real)])
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
            f"lambda {lam!r}, numpy eigvals {want!r} ({t_eig:.1f} s in a "
            f"worker process; "
            f"closed form {closed!r}), rel err {rel:.3e}, compute_error "
            f"{E.compute_error(0):.3e}, wall {wall:.3f} s")
        check(E.result.converged, f"nhep tol {tol}: {E.result}")
    check(rel <= 1e-8, f"nhep convdiff2d: lambda rel err {rel}")


def phase_eps_reference_flow():
    """The reference test2.py flow through the port's runner and facade on
    the card at -n 1 and -n 4, both at once: the printed eigenvalue within
    1e-8 relative of eigvalsh(tridiag_family(100)) (cfg2's
    eigenvalue_rel_err limit, benchmarks/run_all.py:493)."""
    finish_flows(start_flows(flow_specs("test2.py", procs=False)),
                 "both at once")


def phase_eps(flows=True):
    """Every phase of the eigensolver slice; the stencil7_apply launches of
    the 128^3 runs and the kernel's fp64 128^3 times. The dense host
    eigensolve runs in a worker process meanwhile (started here unless it
    already was); the no-argument run starts the test2.py flow with the
    procs phase's launches (``flows`` False)."""
    t0 = time.perf_counter()
    host_oracle(oracle_eigvals, NHEP_NX, NHEP_BETA)
    times = phase_eps_apply_times()
    launches, runs = phase_eps_main()
    t1 = time.perf_counter()
    phase_eps_aij(runs[("largest_magnitude", 16)]["restarts"])
    t2 = time.perf_counter()
    phase_eps_plain()
    if flows:
        phase_eps_reference_flow()
    phase_eps_nhep()
    log(f"eigensolver phases: {time.perf_counter() - t0:.1f} s (128^3 "
        f"stencil {t1 - t0:.1f} s, 128^3 AIJ {t2 - t1:.1f} s, the rest "
        f"{time.perf_counter() - t2:.1f} s)")
    return launches, times


# ---- the other eigensolver types and SVD (ROADMAP Queue A items 7.5, 7.7) ---

LOBPCG_NX = 128        # 2,097,152 rows, fp64
LOBPCG_MAX_IT = 2500   # 1240-1242 iterations at 128^3 on the H100 (PERF.md)
LOBPCG_K = 9           # LOBPCG's trial block at nev 3: [X; W; P], 3 x 3 rows
GD_NX = 24             # the largest cube GD converges on in 20 s (--gd-sizes)
GD_NX_FULL = 20        # the no-argument run's depth: 368 iterations, not 4131
GD_MAX_IT = 8000
POWER_MAX_IT = 1000    # chunks of 8 steps; 259 on the H100 (PERF.md)
SVD_NX = 64
SMALL_NX = 64          # (e)'s 2D problems: 64^2 = 4096 rows


def stencil_smallest(nx):
    """The 3 smallest eigenvalues of the 7-point Dirichlet Laplacian on
    nx^3, in closed form: lambda(1,1,1), then lambda(2,1,1) twice, with
    lambda(i,j,k) the sum over the axes of 4 sin^2(m pi / (2 (nx + 1)))."""
    s = lambda m: 4.0 * float(np.sin(m * np.pi / (2 * (nx + 1)))) ** 2
    return [3 * s(1), s(2) + 2 * s(1), s(2) + 2 * s(1)]


def eps_smallest(comm, op, eps_type, max_it, nev=3, tol=1e-8, B=None):
    import mpi_petsc4py_example_tpu_torch as pt
    E = pt.EPS().create(comm).set_operators(op, B)
    E.set_problem_type("ghep" if B is not None else "hep")
    E.set_type(eps_type).set_which_eigenpairs("smallest_real")
    return E.set_dimensions(nev=nev).set_tolerances(tol=tol, max_it=max_it)


def lobpcg_syncs(its):
    """The device route's host reads (``eps.py`` ``_lobpcg_device``): 3 an
    iteration less the last's two, one for the eigenvectors."""
    return 2 if its == 0 else 3 * its - 1


def eps_types_problem(name):
    """The assembled problems of phases (d) and (e), the same in the main
    process and in the lapack worker: ``(A, B)`` scipy matrices."""
    import scipy.sparse as sp
    from mpi_petsc4py_example_tpu_torch.models.generators import (
        tridiag_family)
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    if name == "tridiag4096":
        return tridiag_family(4096), None
    A = poisson2d_csr(SMALL_NX)
    if name == "ghep64":
        d = 1.0 + np.random.default_rng(22).random(A.shape[0])
        return A, sp.diags(d).tocsr()
    return phase_laplacian(A), None             # "chep64", complex128


def oracle_lapack(name, which, nev):
    """EPS 'lapack' (the port's dense host solve) on the problem ``name``
    on the CPU: ``(eigenvalues, seconds)``."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    A, B = eps_types_problem(name)
    if which == "smallest_eigvals":
        # LAPACK's dense Hermitian solve, the eigenvalues alone (?heevr /
        # ?sygvx): EPS 'lapack' also makes every eigenvector, which for the
        # complex 4096-row problem took 108.6 s on two threads
        import scipy.linalg
        t0 = time.perf_counter()
        lam = scipy.linalg.eigh(A.toarray(), None if B is None
                                else B.toarray(), eigvals_only=True,
                                subset_by_index=[0, nev - 1])
        return lam, time.perf_counter() - t0
    dt = torch.complex128 if np.iscomplexobj(A.data) else torch.float64
    comm = pt.DeviceComm(device="cpu")
    E = pt.EPS().create(comm).set_operators(
        pt.Mat.from_scipy(comm, A, dtype=dt),
        pt.Mat.from_scipy(comm, B, dtype=dt) if B is not None else None)
    E.set_problem_type("ghep" if B is not None else "hep").set_type("lapack")
    E.set_which_eigenpairs(which).set_dimensions(nev=nev)
    t0 = time.perf_counter()
    E.solve()
    return np.asarray(E._eigenvalues), time.perf_counter() - t0


LAPACK_ORACLES = (("tridiag4096", "largest_magnitude", 2),
                  ("ghep64", "smallest_eigvals", 3),
                  ("chep64", "smallest_eigvals", 3))


def start_lapack_oracles():
    """The dense references of phases (d) and (e), each a dense eigh of
    4096 rows (5-15 s on two threads), in a pool of three worker processes
    of two BLAS threads each."""
    for args in LAPACK_ORACLES:
        host_oracle(oracle_lapack, *args, threads=2)


def phase_eps_apply_many_times(nx=LOBPCG_NX, k=LOBPCG_K):
    """``stencil7_apply_many`` at the LOBPCG path's shape and dtype (k = 9
    slabs of 128^3 fp64): kernel, plain and conv3d (batch k) times and the
    bound, after a check against the plain version."""
    import torch
    import torch.nn.functional as F
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(23)
    mk = lambda *s: torch.rand(s, generator=g, device="cuda",
                               dtype=torch.float64)
    U, lo, hi = mk(k, nx, nx, nx), mk(k, nx, nx), mk(k, nx, nx)
    Y = torch.empty_like(U)
    ref = st.stencil3d_apply_many_plain(U, lo, hi)
    err = float((st.stencil3d_apply_many(U, lo, hi, out=Y) - ref).abs().max())
    check(err <= Y_TOL["float64"] * float(ref.abs().max()),
          f"apply_many k={k} {nx}^3 f64: {err}")
    ext = torch.cat([lo[:, None], U, hi[:, None]], dim=1)[:, None]
    w = torch.zeros((1, 1, 3, 3, 3), device="cuda", dtype=torch.float64)
    w[0, 0, 1, 1, 1] = 6.0
    for dz, dy, dx in [(0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1),
                       (1, 1, 0), (1, 1, 2)]:
        w[0, 0, dz, dy, dx] = -1.0
    conv = lambda: F.conv3d(ext, w, padding=(0, 1, 1))
    e_conv = float((conv()[:, 0] - ref).abs().max())
    check(e_conv <= 1e-12 * float(ref.abs().max()),
          f"conv3d yardstick k={k} {nx}^3 f64: {e_conv}")
    del ref
    b_ms, b_by = bound_ms(nx, nx, nx, 8, False, k)
    out = {"ms": device_ms(lambda: st.stencil3d_apply_many(U, lo, hi, out=Y),
                           20),
           "plain_ms": device_ms(lambda: st.stencil3d_apply_many_plain(
               U, lo, hi), 3, reps=10),
           "library_ms": device_ms(conv, 3, reps=10), "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": err}
    log(f"time stencil7_apply_many k={k} {nx}^3 f64 (the LOBPCG path's "
        f"shape): kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} "
        f"ms, conv3d {out['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {b_ms / out['ms'] * 100:.1f}% of it), max|err| "
        f"{err:.3e}")
    del U, lo, hi, Y, ext
    torch.cuda.empty_cache()
    return out


def phase_eps_types_lobpcg(nx=LOBPCG_NX):
    """(a) LOBPCG on the 128^3 fp64 stencil, the 3 smallest pairs at tol
    1e-8: the eigenvalues against the closed form within 1e-9 relative,
    compute_error <= 1e-6 each, host reads by the formula, the
    ``stencil7_apply_many`` launches of the solve = its (the start block
    once, then one trial block an iteration but the last) and no other
    kernel; the warm wall and ms an iteration; a profile of iterations
    11-60 (two profiled solves differenced: device busy, idle share, row
    9's share, the GEMMs' and the copies')."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    want = stencil_smallest(nx)
    E = eps_smallest(comm, op, "lobpcg", LOBPCG_MAX_IT)
    torch.cuda.reset_peak_memory_stats()
    launches, wall = eps_solve_counted(E)
    its, res = E.get_iteration_number(), E.result
    lam = np.sort(np.real(E._eigenvalues))
    rel = np.abs(lam - want) / np.asarray(want)
    reset_launches()
    errs = [E.compute_error(i) for i in range(3)]
    err_launches = read_launches()["stencil7_apply"]
    log(f"eps-types (a) lobpcg {nx}^3 f64 smallest_real nev 3: {its} "
        f"iterations, nconv {E.get_converged()}, {res.reason_name}, lambda "
        f"{[repr(x) for x in lam]} (closed form {[repr(x) for x in want]}, "
        f"rel err {rel.max():.3e}), compute_error "
        f"{[f'{e:.3e}' for e in errs]}, host syncs {res.host_syncs}, wall "
        f"{wall:.3f} s ({wall / max(its, 1) * 1e3:.3f} ms/iter), "
        f"stencil7_apply_many launches {launches['stencil7_apply_many']} "
        f"(expected {max(its, 1)}), {err_launches} stencil7_apply for "
        f"compute_error, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(res.converged and E.get_converged() >= 3,
          f"lobpcg {nx}^3 did not converge: {res}")
    check(rel.max() <= 1e-9, f"lobpcg {nx}^3: lambda rel err {rel}")
    check(max(errs) <= 1e-6, f"lobpcg {nx}^3: compute_error {errs}")
    check(res.host_syncs == lobpcg_syncs(its),
          f"lobpcg host syncs {res.host_syncs} != {lobpcg_syncs(its)}")
    check(launches["stencil7_apply_many"] == max(its, 1),
          f"lobpcg apply_many launches {launches['stencil7_apply_many']}")
    check(sum(launches.values()) == launches["stencil7_apply_many"],
          f"lobpcg launched other kernels: {launches}")
    check(err_launches == 3, "compute_error did not apply once a pair")
    E.solve()                # warm
    warm = E.result.wall_time
    log(f"eps-types (a) lobpcg warm: wall {warm:.3f} s, "
        f"{warm / max(its, 1) * 1e3:.3f} ms/iter")
    prof = profile_iterations(E, f"lobpcg {nx}^3")
    out = {"iterations": its, "wall_s": wall, "warm_s": warm,
           "ms_per_iter": warm / max(its, 1) * 1e3, "profile": prof,
           "host_syncs": res.host_syncs, "lambda": lam.tolist(),
           "rel_err": float(rel.max()), "compute_error": errs,
           "launches": launches["stencil7_apply_many"],
           "compute_error_launches": err_launches}
    del E, op
    torch.cuda.empty_cache()
    return out


def profile_rows(run):
    """``run()`` under ``torch.profiler``: ``(wall_us, {device row: us})``,
    the device rows (kernels, copies) only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            rows[e.key] = rows.get(e.key, 0.0) + e.self_device_time_total
    return wall_us, rows


def profile_iterations(E, label, short=10, long=60):
    """The steady iteration of an eigensolve: two profiled solves capped at
    ``short`` and ``long`` iterations, differenced, so that the set-up (the
    start block made and placed) and the eigenvector read drop out (a first
    profiled solve, thrown away, takes the profiler's own start-up). Their
    copies of 50 MB to and from pageable host memory vary by milliseconds
    from solve to solve, so the difference spans 50 iterations. Logs
    and returns the wall and device busy us an iteration, the idle share,
    and the shares of the busy time of row 9 (``stencil7``), the GEMMs
    (the Gram and transform products), the elementwise and reduction
    kernels, and the copies (device-to-host: the host reads)."""
    E.set_tolerances(max_it=short)
    profile_rows(lambda: E.solve())
    w0, r0 = profile_rows(lambda: E.solve())
    E.set_tolerances(max_it=long)
    w1, r1 = profile_rows(lambda: E.solve())
    n = long - short
    rows = {k: (r1.get(k, 0.0) - r0.get(k, 0.0)) / n for k in r1}
    busy = sum(rows.values())
    if busy <= 0:
        log(f"profile {label}: the profiler recorded no device time "
            "(device breakdown not measured)")
        return None
    wall = (w1 - w0) / n

    def share(pred):
        return sum(v for k, v in rows.items() if pred(k)) / busy

    gemm = lambda k: any(t in k.lower() for t in ("gemm", "xmma", "gemv"))
    out = {"wall_us": wall, "busy_us": busy, "idle": 1 - busy / wall,
           "row9": share(lambda k: "stencil7" in k), "gemm": share(gemm),
           "dtoh": share(lambda k: "Memcpy DtoH" in k),
           "copies": share(lambda k: k.startswith("Memcpy")),
           "host_reads_per_iter": 3}
    out["elementwise"] = 1 - out["row9"] - out["gemm"] - out["copies"]
    log(f"profile {label}, iterations {short + 1}-{long} (differenced): "
        f"wall {wall:.1f} us/iter, device busy {busy:.1f} us/iter, idle "
        f"share {out['idle']:.3f}; of the busy time row 9 "
        f"{out['row9'] * 100:.1f}%, GEMMs (Gram/transform products) "
        f"{out['gemm'] * 100:.1f}%, copies {out['copies'] * 100:.1f}% (DtoH, "
        f"the 3 host reads an iteration: {out['dtoh'] * 100:.1f}%), "
        f"elementwise/reductions {out['elementwise'] * 100:.1f}%")
    for key, us in sorted(rows.items(), key=lambda r: -r[1])[:10]:
        log(f"  {us:9.2f} us/iter  {key[:110]}")
    return out


def phase_eps_types_plain(nx=32):
    """(b) the same problem at 32^3 with ``force_plain``: the kernel path's
    iterations, eigenvalues within 1e-12, and no launch."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    E = eps_smallest(comm, op, "lobpcg", LOBPCG_MAX_IT)
    launches, _ = eps_solve_counted(E)
    its, lam = E.get_iteration_number(), np.sort(np.real(E._eigenvalues))
    op.force_plain = True
    try:
        plain_launches, _ = eps_solve_counted(E)
    finally:
        op.force_plain = False
    p_its, p_lam = E.get_iteration_number(), np.sort(np.real(E._eigenvalues))
    d = float(np.max(np.abs(p_lam - lam) / lam))
    log(f"eps-types (b) lobpcg {nx}^3: kernel path {its} iterations, "
        f"{launches['stencil7_apply_many']} launches; plain path {p_its} "
        f"iterations, {sum(plain_launches.values())} launches, lambda rel "
        f"diff {d:.3e}")
    check(p_its == its and d <= 1e-12,
          f"lobpcg plain path {p_its}, {p_lam} vs {its}, {lam}")
    check(sum(plain_launches.values()) == 0, "the plain path launched")
    check(launches["stencil7_apply_many"] == max(its, 1),
          "lobpcg 32^3 kernel path launches")
    return {"iterations": its, "lambda_rel_diff": d}


def phase_eps_types_gd(nx=GD_NX):
    """(c) GD on (a)'s problem at ``GD_NX``^3 (see PERF.md for the size):
    the closed form within 1e-9, outer iterations, launches of
    ``stencil7_apply_many`` (the start block and one correction block an
    iteration but the last: its) and host reads (3 an iteration)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    want = stencil_smallest(nx)
    E = eps_smallest(comm, op, "gd", GD_MAX_IT)
    launches, wall = eps_solve_counted(E)
    its, res = E.get_iteration_number(), E.result
    lam = np.sort(np.real(E._eigenvalues))
    rel = np.abs(lam - want) / np.asarray(want)
    reset_launches()
    errs = [E.compute_error(i) for i in range(3)]
    err_launches = read_launches()["stencil7_apply"]
    log(f"eps-types (c) gd {nx}^3 f64 smallest_real nev 3: {its} outer "
        f"iterations, {res.reason_name}, lambda rel err {rel.max():.3e}, "
        f"compute_error max {max(errs):.3e}, host syncs {res.host_syncs}, "
        f"wall {wall:.3f} s ({wall / max(its, 1) * 1e3:.3f} ms/iter), "
        f"stencil7_apply_many launches {launches['stencil7_apply_many']}")
    check(res.converged and rel.max() <= 1e-9, f"gd {nx}^3: {lam} {res}")
    check(max(errs) <= 1e-6, f"gd {nx}^3: compute_error {errs}")
    check(res.host_syncs == 3 * its, f"gd host syncs {res.host_syncs}")
    check(launches["stencil7_apply_many"] == its
          and sum(launches.values()) == its, f"gd launches {launches}")
    return {"nx": nx, "iterations": its, "wall_s": wall,
            "launches": launches["stencil7_apply_many"],
            "compute_error_launches": err_launches,
            "rel_err": float(rel.max())}


class _OverBudget(Exception):
    """A solve stopped by its wall budget (``phase_gd_sizes``)."""


def phase_gd_sizes(sizes=(128, 64, 32, 28, 26, 24), budget_s=20.0):
    """GD on phase (c)'s problem at each cube of ``sizes``, each with a
    wall budget (a monitor stops the solve past it): outer iterations,
    wall and the largest error estimate of the 3 pairs at the end. The
    largest cube that converges within the budget is ``GD_NX``."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    out = {}
    for nx in sizes:
        op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
        E = eps_smallest(comm, op, "gd", 10 ** 7)
        last = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def monitor(eps, its, nconv, eig, errest):
            last.update(its=its, errest=float(np.max(errest[:3])))
            if time.perf_counter() - t0 > budget_s:
                raise _OverBudget
        E.set_monitor(monitor)
        try:
            E.solve()
            converged = E.result.converged
        except _OverBudget:
            converged = False
        wall = time.perf_counter() - t0
        out[nx] = {"converged": converged, "iterations": last.get("its"),
                   "wall_s": wall, "errest": last.get("errest")}
        log(f"gd sizes {nx}^3: {'converged' if converged else 'stopped'} "
            f"after {last.get('its')} outer iterations, {wall:.2f} s, "
            f"largest error estimate {last.get('errest'):.3e}")
        del E, op
        torch.cuda.empty_cache()
    return out


def phase_eps_types_mat():
    """(d) power, subspace (nev 2, ncv 12) and arnoldi on
    ``tridiag_family(4096)`` as an fp64 ``Mat``, the largest magnitude,
    against EPS 'lapack' on the same matrix (a worker process) within 1e-8
    (cfg2's limit)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    A, _ = eps_types_problem("tridiag4096")
    comm = pt.DeviceComm()
    m = pt.Mat.from_scipy(comm, A, dtype=torch.float64)
    out = {}
    for eps_type, nev, ncv, max_it in (("power", 1, None, POWER_MAX_IT),
                                       ("subspace", 2, 12, 2000),
                                       ("arnoldi", 2, None, 400)):
        E = pt.EPS().create(comm).set_operators(m).set_problem_type("hep")
        E.set_type(eps_type).set_dimensions(nev=nev, ncv=ncv)
        E.set_tolerances(tol=1e-8, max_it=max_it)
        launches, wall = eps_solve_counted(E)
        lam = np.real(E._eigenvalues[:nev])
        out[eps_type] = {"its": E.get_iteration_number(), "wall_s": wall,
                         "host_syncs": E.result.host_syncs,
                         "lambda": lam.tolist(),
                         "launches": sum(launches.values())}
        log(f"eps-types (d) {eps_type} tridiag_family(4096): "
            f"{E.get_iteration_number()} iterations, "
            f"{E.result.reason_name}, lambda {lam.tolist()}, host syncs "
            f"{E.result.host_syncs}, wall {wall:.3f} s, launches "
            f"{sum(launches.values())}")
        check(E.result.converged, f"{eps_type}: {E.result}")
        check(sum(launches.values()) == 0, f"{eps_type} launched a kernel")
    ref, t_ref = host_oracle(oracle_lapack, *LAPACK_ORACLES[0],
                             threads=2).result()
    for eps_type, r in out.items():
        rel = np.abs(np.asarray(r["lambda"]) - ref[:len(r["lambda"])]) \
            / np.abs(ref[:len(r["lambda"])])
        r["rel_err"] = float(rel.max())
        log(f"eps-types (d) {eps_type}: rel err {rel.max():.3e} against "
            f"lapack {ref.tolist()} ({t_ref:.1f} s in a worker process)")
        check(rel.max() <= 1e-8, f"{eps_type}: lambda rel err {rel}")
    return out


def phase_eps_types_small():
    """(e) LOBPCG against LAPACK's dense Hermitian eigenvalues (a worker
    process, ``oracle_lapack``) within 1e-9: the
    GHEP of the 64^2 2D Laplacian with B = diag(1 + U[0, 1)) (a seeded
    numpy generator), and the complex128 HEP of the phased 64^2 Laplacian
    (its x-bonds ``e^{i 0.3}``: the same sparsity, Hermitian)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    out = {}
    for args in LAPACK_ORACLES[1:]:
        name = args[0]
        A, B = eps_types_problem(name)
        dt = torch.complex128 if np.iscomplexobj(A.data) else torch.float64
        MA = pt.Mat.from_scipy(comm, A, dtype=dt)
        MB = pt.Mat.from_scipy(comm, B, dtype=dt) if B is not None else None
        E = eps_smallest(comm, MA, "lobpcg", 2000, B=MB)
        launches, wall = eps_solve_counted(E)
        its = E.get_iteration_number()
        lam = np.sort(np.real(E._eigenvalues))
        ref, t_ref = host_oracle(oracle_lapack, *args, threads=2).result()
        ref = np.sort(np.real(ref))
        rel = np.abs(lam - ref) / np.abs(ref)
        errs = [E.compute_error(i) for i in range(3)]
        out[name] = {"its": its, "wall_s": wall, "rel_err": float(rel.max()),
                     "host_syncs": E.result.host_syncs}
        log(f"eps-types (e) lobpcg {name}: {its} iterations, "
            f"{E.result.reason_name}, lambda {lam.tolist()}, lapack "
            f"{ref.tolist()} ({t_ref:.1f} s in a worker), rel err "
            f"{rel.max():.3e}, compute_error max {max(errs):.3e}, host syncs "
            f"{E.result.host_syncs}, wall {wall:.3f} s")
        check(E.result.converged and rel.max() <= 1e-9,
              f"lobpcg {name}: {lam} vs {ref}")
        check(E.result.host_syncs == lobpcg_syncs(its),
              f"lobpcg {name} host syncs")
        check(sum(launches.values()) == 0, f"lobpcg {name} launched")
    return out


def gradient3d(nx):
    """The 3D forward-difference gradient with Dirichlet ends,
    ``(3 (nx+1) nx^2, nx^3)``: ``G^T G`` is the 7-point Laplacian."""
    import scipy.sparse as sp
    D = sp.diags([np.ones(nx), -np.ones(nx)], [0, -1], shape=(nx + 1, nx))
    eye = sp.identity(nx, format="csr")
    return sp.vstack([sp.kron(sp.kron(eye, eye), D),
                      sp.kron(sp.kron(eye, D), eye),
                      sp.kron(sp.kron(D, eye), eye)]).tocsr()


def phase_eps_types_svd(nx=SVD_NX):
    """(f) SVD of the 3D gradient at 64^3: sigma = sqrt(lambda) of the
    Laplacian, so sigma_max and the 3 smallest are known in closed form
    (within 1e-8 relative); the u/v residuals (the side opposite the
    constructed vector, relative in sigma) at most 1e-6 and ``A v = sigma
    u`` checked on the host."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    G = gradient3d(nx)
    comm = pt.DeviceComm()
    t0 = time.perf_counter()
    M = pt.Mat.from_scipy(comm, G, dtype=torch.float64)
    t_asm = time.perf_counter() - t0
    s = lambda m: 4.0 * float(np.sin(m * np.pi / (2 * (nx + 1)))) ** 2
    out = {"assembly_s": t_asm}
    for which, nsv, want in (("largest", 1, [np.sqrt(3 * s(nx))]),
                             ("smallest", 3,
                              np.sqrt(stencil_smallest(nx)).tolist())):
        svd = pt.SVD().create(comm).set_operator(M)
        svd.set_which_singular_triplets(which).set_dimensions(nsv=nsv)
        svd.set_tolerances(tol=1e-10, max_it=3000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svd.solve()
        wall = time.perf_counter() - t0
        sig = np.array([svd.get_value(i) for i in range(nsv)])
        rel = np.abs(np.sort(sig) - np.sort(want)) / np.asarray(sorted(want))
        vres = [float(np.linalg.norm(G @ svd._V[i] - sig[i] * svd._U[i])
                      / sig[i]) for i in range(nsv)]
        out[which] = {"its": svd.get_iteration_number(), "wall_s": wall,
                      "sigma": sig.tolist(), "rel_err": float(rel.max()),
                      "residuals": svd._residuals.tolist(),
                      "host_syncs": svd.result.host_syncs}
        log(f"eps-types (f) svd gradient {nx}^3 {which} {nsv}: "
            f"{svd.get_iteration_number()} iterations, sigma {sig.tolist()} "
            f"(closed form {want}, rel err {rel.max():.3e}), residuals "
            f"{svd._residuals.tolist()}, |G v - sigma u|/sigma "
            f"{max(vres):.3e}, host syncs {svd.result.host_syncs}, wall "
            f"{wall:.3f} s")
        check(svd.get_converged() >= nsv and rel.max() <= 1e-8,
              f"svd {which}: {sig} vs {want}")
        check(max(svd._residuals) <= 1e-6 and max(vres) <= 1e-6,
              f"svd {which} residuals {svd._residuals} {vres}")
    del M
    torch.cuda.empty_cache()
    return out


def phase_eps_types(advanced=True, gd_nx=GD_NX):
    """Every phase of the other eigensolver types and SVD, (a)-(g) ((g)
    only with ``advanced``: the no-argument run's surface phases run it;
    (c) at ``gd_nx``^3): returns the record and the launches of rows 9 and
    2 on this path."""
    import torch
    t0 = time.perf_counter()
    start_lapack_oracles()
    out = {"apply_many_f64": phase_eps_apply_many_times()}
    t1 = time.perf_counter()
    out["a_lobpcg"] = phase_eps_types_lobpcg()
    t2 = time.perf_counter()
    out["b_plain"] = phase_eps_types_plain()
    out["c_gd"] = phase_eps_types_gd(gd_nx)
    t3 = time.perf_counter()
    out["d_mat"] = phase_eps_types_mat()
    out["e_small"] = phase_eps_types_small()
    t4 = time.perf_counter()
    out["f_svd"] = phase_eps_types_svd()
    t5 = time.perf_counter()
    if advanced:
        out["g_advanced"] = phase_surface_advanced()
    torch.cuda.empty_cache()
    log(f"timing: eps-types phases {time.perf_counter() - t0:.1f} s (times "
        f"{t1 - t0:.1f}, (a) {t2 - t1:.1f}, (b)-(c) {t3 - t2:.1f}, (d)-(e) "
        f"{t4 - t3:.1f}, (f) {t5 - t4:.1f}, (g) "
        f"{time.perf_counter() - t5:.1f} s)")
    a, c = out["a_lobpcg"], out["c_gd"]
    launches = {
        "stencil7_apply_many": (
            a["launches"], f"{LOBPCG_NX}^3 fp64 LOBPCG nev 3 (its "
                           f"{a['iterations']})"),
        "stencil7_apply": (
            a["compute_error_launches"] + c["compute_error_launches"],
            f"compute_error of the {LOBPCG_NX}^3 LOBPCG and the "
            f"{c['nx']}^3 GD pairs")}
    return out, launches


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
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    A, b = cfg11_problem(nx)
    comm = pt.DeviceComm()
    t0 = time.perf_counter()
    x_cpu, info, cpu_wall = host_oracle(oracle_cg, nx, b, REFINE_RTOL,
                                        40000).result()
    cpu_rel = true_relres(A, x_cpu, b)
    log(f"refine {nx}^3 scipy fp64 CG+jacobi oracle: info {info}, relres "
        f"{cpu_rel:.3e}, {cpu_wall:.1f} s in a worker process, "
        f"{time.perf_counter() - t0:.1f} s waited for here")
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
        per, samples = delta_per_iter(solvers, bv, x, reps=1)
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
    against f32 in the same run: the delta method over 20 and 120 fixed
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
                   for m in (20, 120)}
        solvers[20].solve_many(Bv, Xv)                # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = {}              # one pair: two pairs spread by 0.2% (H100)
        for m, ksp in solvers.items():
            t0 = time.perf_counter()
            r = ksp.solve_many(Bv, Xv)
            walls[m] = (time.perf_counter() - t0, max(r.iterations))
        (w_lo, i_lo), (w_hi, i_hi) = walls[20], walls[120]
        per = (w_hi - w_lo) / (i_hi - i_lo)
        per_iter = [per]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
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
    inner_512 = timed(phase_bf16_inner_512)
    many_512 = timed(phase_bf16_many_512)
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


def phase_direct_crband(n_penta=1 << 20, n_host=1 << 17, n_band=100_000,
                        nx_rcm=160, n_f32=17_000):
    """PC lu in the crband mode (block cyclic reduction): pentadiagonal at n =
    2^20 set up on the card (auto), and at n = 2^17 on the card and on the
    host (0) in one call (the host set-up takes 25 s at 2^20);
    bandwidth 8 at n = 100,000; a randomly permuted 160^2 2D Poisson through
    RCM (5 arrays); all fp64, relres <= 1e-10; then the n = 17,000
    pentadiagonal in f32 with preonly's refinement, relres <= 5e-6
    (tests/test_tridiag.py:189-221, tests/test_bpcr_device.py:128-134)."""
    import scipy.sparse as sp
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    comm = pt.DeviceComm()
    out = {}
    for n, placement, mode in ((n_penta, "auto", "device"),
                               (n_host, "auto", "device"),
                               (n_host, "0", "host")):
        A = pentadiag(n)
        r, pc, _ = direct_solve(comm, A, np.float64, placement)
        apply = cr_apply_record(pc, comm, A.shape[0]) \
            if placement == "auto" else None
        log_direct(f"crband pentadiagonal n={n} f64, "
                   f"-pc_setup_device {placement}", r, apply)
        check(r["mode"] == "crband" and r["setup_mode"] == mode
              and r["true_relres"] <= DIRECT_RTOL,
              f"crband n={n} ({placement}): {r}")
        out[f"penta {n} {placement}"] = dict(r, apply=apply)
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
    the errors of 1 and 3 at most 1e-8, and the fourth line LOBPCG's: 3
    pairs, the worst residual at most its tolerance 1e-8."""
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
    check(rc == 0 and len(lines) == 4
          and all("CONVERGED" in line for line in lines[:3]),
          "advanced.py did not converge in its first three scenarios")
    check(len(errs) == 2 and max(errs) <= 1e-8, f"advanced.py errors {errs}")
    check(lines[3].startswith("4. lobpcg: 3 pairs, lambda_min=")
          and float(lines[3].split("worst residual")[1]) <= 1e-8,
          f"advanced.py's LOBPCG line: {lines[3]}")
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


# ---- the process communicator (one process per rank, torch.distributed) ----

PROCS_RTOL = 1e-6


# every rank launch of this run, stopped at its end (:func:`stop_background`)
_LAUNCHES: list = []


class RankLaunch:
    """``python -m mpi_petsc4py_example_tpu_torch.run -n nprocs [--procs]
    args`` started from the checkout's root in a session of its own, so that
    the runner and its ranks can be stopped together; its output goes to
    temporary files (a launch left running beside other work never waits on
    a full pipe), and a thread notes when it ends."""

    def __init__(self, nprocs, args, procs=True):
        import tempfile
        import threading
        root = os.path.dirname(os.path.abspath(__file__))
        self.nprocs, self.args = nprocs, list(args)
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.t0, self.t1 = time.perf_counter(), None
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run",
             "-n", str(nprocs)] + (["--procs"] if procs else []) + self.args,
            stdout=self.out, stderr=self.err, text=True, cwd=root,
            start_new_session=True)
        _LAUNCHES.append(self)
        self.thread = threading.Thread(target=self._wait, daemon=True)
        self.thread.start()

    def _wait(self):
        self.proc.wait()
        self.t1 = time.perf_counter()

    def finish(self, timeout=900):
        """``(stdout, wall seconds)``; raises when a rank failed (the runner
        then stopped the others) or ``timeout`` seconds after the start."""
        self.thread.join(max(timeout - (time.perf_counter() - self.t0), 0.0))
        if self.t1 is None:
            self.stop()
            check(False, f"run -n {self.nprocs} {self.args}: still running "
                         f"after {timeout} s")
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        check(self.proc.returncode == 0,
              f"run -n {self.nprocs} {self.args}: rc {self.proc.returncode}"
              f"\n{out[-1000:]}\n{err[-3000:]}")
        return out, self.t1 - self.t0

    def stop(self):
        import signal
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()


def run_ranks(nprocs, args, timeout=900):
    return RankLaunch(nprocs, args).finish(timeout)


def start_parity(nprocs, cases, backend=None):
    """Start the cases of ``facade/drivers/parity.py`` on ``nprocs`` rank
    processes on the card; :func:`finish_parity` waits for them."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, "mpi_petsc4py_example_tpu_torch", "facade",
                          "drivers", "parity.py")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "cases.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    launch = RankLaunch(nprocs, (["--backend", backend] if backend else [])
                        + [script, path, os.path.join(tmp.name, "out")])
    return launch, tmp, cases


def finish_parity(started):
    """Each case's results and the launch's wall time."""
    launch, tmp, cases = started
    try:
        _, wall = launch.finish()
        return {c["name"]: dict(np.load(os.path.join(tmp.name, "out",
                                                     c["name"] + ".npz")))
                for c in cases}, wall
    finally:
        tmp.cleanup()


def parity_launch(nprocs, cases, backend=None):
    return finish_parity(start_parity(nprocs, cases, backend))


def procs_reference(cases, nshards):
    """The same cases on ``DeviceComm(nshards)`` in this process."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.facade.drivers.parity import run_case
    comm = pt.DeviceComm(nshards)
    out = {c["name"]: run_case(comm, c) for c in cases}
    torch.cuda.empty_cache()
    return out


def procs_compare(label, got, want, bits=True, converged=True):
    """Equal iterations and reasons (positive, with ``converged``); the
    iterate bit for bit (``bits``) or its largest difference reported."""
    its = [int(v) for v in np.atleast_1d(got["its"])]
    its_ref = [int(v) for v in np.atleast_1d(want["its"])]
    reasons = [int(v) for v in np.atleast_1d(got["reason"])]
    check(its == its_ref, f"{label}: iterations {its} != {its_ref}")
    check(reasons == [int(v) for v in np.atleast_1d(want["reason"])]
          and (all(r > 0 for r in reasons) or not converged),
          f"{label}: reasons {reasons}")
    diff = (float(np.abs(got["x"].astype(np.float64)
                         - want["x"].astype(np.float64)).max())
            if "x" in got else None)
    if bits:
        check(np.array_equal(got["x"], want["x"]),
              f"{label}: iterate differs from the virtual mesh's by {diff}")
    return its, diff


def ms_per_iter(res) -> float:
    its = np.atleast_1d(res["its"])
    return float(res["wall_s"]) / max(int(its.max()), 1) * 1e3


def plan_cases(base, prefix, local_shards):
    """The 128^3 f32 CG + Jacobi case ``base`` as cg, pipecg and sstep s = 4
    (ROADMAP item 5.2): one reduction an iteration, or a block; max_it 400
    (unguarded f32 pipecg does not reach rtol, as in the JAX package, and
    f32 sstep's count turns on rounding: on 4 shards it may not)."""
    return [dict(base, name=f"{prefix}_{label}", ksp=t, max_it=400,
                 local_shards=local_shards, time_psum=False, **attrs)
            for label, t, attrs in (("plan_cg", "cg", {}),
                                    ("plan_pipecg", "pipecg", {}),
                                    ("plan_sstep4", "sstep",
                                     {"sstep_s": 4}))]


def procs_plans(label, got, refs, cases, card):
    """cg/pipecg/sstep on a process comm against ``DeviceComm``: equal
    iterations and reasons, x bit for bit, psums and ring shifts an
    iteration (``comm.collectives``), ms an iteration against the
    virtual mesh's."""
    out = {}
    for c in cases:
        g, r = got[c["name"]], refs[c["name"]]
        # unguarded f32 pipecg and sstep may stop at max_it: reported
        its, _ = procs_compare(f"{label} {c['name']}", g, r,
                               converged=c["ksp"] == "cg")
        it = max(its[0], 1)
        psums = int(g["calls_psum"]) / it
        shifts = int(g["calls_shift"]) / it
        check(int(g["calls_psum"]) == int(r["calls_psum"])
              and int(g["calls_shift"]) == int(r["calls_shift"]),
              f"{label} {c['name']}: collectives differ from DeviceComm's")
        if c["ksp"] == "pipecg":
            check(int(g["calls_psum"]) == its[0] + 3,
                  f"{label} pipecg: {int(g['calls_psum'])} psums for "
                  f"{its[0]} iterations")
        out[c["name"]] = {"iterations": its[0],
                          "reason": int(np.atleast_1d(g["reason"])[0]),
                          "psums_per_iter": psums,
                          "shifts_per_iter": shifts,
                          "host_syncs": int(g["host_syncs"]),
                          "ms_per_iter": ms_per_iter(g),
                          "ms_per_iter_virtual": ms_per_iter(r)}
        log(f"procs {label} {c['name']}: {its[0]} iterations, reason "
            f"{out[c['name']]['reason']} (= DeviceComm, x bit-equal), "
            f"{psums:.3f} psums and {shifts:.3f} shifts an iteration, host "
            f"syncs {int(g['host_syncs'])}, "
            f"{out[c['name']]['ms_per_iter']:.4f} ms/iter vs "
            f"{out[c['name']]['ms_per_iter_virtual']:.4f} on the virtual "
            f"mesh; {card}")
    return out


# the 128^3 fp64 Krylov-Schur of the eigensolver phases, on a process comm
EPS_PROCS = dict(kind="eps", op="stencil", grid=[EPS_NX] * 3, tol=1e-8,
                 ncv=16, max_it=EPS_MAX_IT)


def bits_or_close(label, got, want, key="x", tol=1e-12):
    """``(bit-equal, max diff)`` of ``got[key]`` against ``want[key]``;
    where the bits differ the values must agree within ``tol`` of their
    scale."""
    g, w = np.asarray(got[key]), np.asarray(want[key])
    same = np.array_equal(g, w)
    diff = float(np.abs(g - w).max()) if g.size else 0.0
    scale = max(float(np.abs(w).max()), 1.0) if w.size else 1.0
    check(same or diff <= tol * scale,
          f"{label}: {key} differs from the virtual mesh's by {diff}")
    return same, diff


def procs_eps(label, got, ref, local_shards, card):
    """The 128^3 EPS on a process comm against ``DeviceComm`` in this
    process: restarts and reason equal, lambda within 1e-9 of the closed
    form, the pairs bit for bit (or within 1e-12, reported), and
    ``stencil7_apply`` launched ``local_shards`` times the Krylov-Schur
    count; ms, psums and ring shifts per restart."""
    restarts = int(got["its"])
    check(restarts == int(ref["its"]) and int(got["reason"]) ==
          int(ref["reason"]) > 0,
          f"{label}: restarts {restarts} reason {int(got['reason'])} != "
          f"{int(ref['its'])} {int(ref['reason'])}")
    want = stencil_extremes(EPS_NX)[0]
    lam = float(np.real(got["lam"][0]))
    rel = abs(lam - want) / want
    check(rel <= 1e-9, f"{label}: lambda {lam!r} rel err {rel} vs the "
                       "closed form")
    lam_bits, lam_diff = bits_or_close(label, got, ref, "lam")
    vec_bits, vec_diff = bits_or_close(label, got, ref, "x")
    applies = int(got["launches_stencil3d_apply"])
    formula = expected_eps_applies(EPS_PROCS["ncv"], restarts)
    check(applies == local_shards * formula,
          f"{label}: stencil7_apply launches {applies} != {local_shards} "
          f"x {formula}")
    out = {"restarts": restarts, "lambda": lam, "rel_err": rel,
           "lambda_bits": lam_bits, "lambda_diff": lam_diff,
           "vector_bits": vec_bits, "vector_diff": vec_diff,
           "launches": applies, "formula": formula,
           "ms_per_restart": float(got["wall_s"]) / restarts * 1e3,
           "ms_per_restart_virtual": float(ref["wall_s"]) / restarts * 1e3,
           "psums_per_restart": int(got["calls_psum"]) / restarts,
           "shifts_per_restart": int(got["calls_shift"]) / restarts,
           "host_copies": int(got["host_copies_total"])}
    log(f"{label}, 128^3 fp64 Krylov-Schur ncv 16: {restarts} "
        f"restarts (= DeviceComm), lambda {lam!r} (closed form {want!r}, "
        f"rel err {rel:.3e}), lambda bit-equal {lam_bits} (diff "
        f"{lam_diff:.3e}), vector bit-equal {vec_bits} (diff "
        f"{vec_diff:.3e}), stencil7_apply {applies} = {local_shards} x "
        f"{formula}, {out['ms_per_restart']:.3f} ms/restart vs "
        f"{out['ms_per_restart_virtual']:.3f} on DeviceComm, "
        f"{out['psums_per_restart']:.2f} psums + "
        f"{out['shifts_per_restart']:.2f} shifts per restart, host copies "
        f"{out['host_copies']}; {card}")
    return out


def procs_stack(label, got, ref, card, extra=""):
    """A refinement, null-space, transpose or direct case on a process comm
    against ``DeviceComm``: iterations, reason (and outer steps) equal, the
    iterate bit for bit or within 1e-12 (reported)."""
    for key in ("its", "reason", "steps", "pc_kind"):
        if key in ref:
            check(str(got[key]) == str(ref[key]),
                  f"{label}: {key} {got[key]} != {ref[key]}")
    bits, diff = bits_or_close(label, got, ref)
    its = int(got["its"])
    out = {"iterations": its, "reason": int(got["reason"]),
           "x_bits": bits, "x_diff": diff, "ms_per_iter": ms_per_iter(got),
           "ms_per_iter_virtual": ms_per_iter(ref),
           "host_copies": int(got["host_copies_total"]),
           "launches": {k[len("launches_"):]: int(v) for k, v in got.items()
                        if k.startswith("launches_") and int(v)}}
    log(f"{label}: {its} iterations, reason {out['reason']} (= "
        f"DeviceComm), x bit-equal {bits} (diff {diff:.3e}), "
        f"{out['ms_per_iter']:.4f} ms/iter vs "
        f"{out['ms_per_iter_virtual']:.4f}, launches of rank 0 "
        f"{out['launches']}{extra}; {card}")
    return out


def refine_relres(x):
    """cfg11's fp64 relative residual of the 128^3 refinement case (its
    right-hand side as the parity driver makes it)."""
    import mpi_petsc4py_example_tpu_torch as pt
    A = pt.poisson3d_csr(EPS_NX).astype(np.float64).tocsr()
    b = A @ np.random.default_rng(4).random(A.shape[0])
    return true_relres(A, x, b)


def test2_eigenvalue() -> float:
    """The largest eigenvalue of the test2.py flow's matrix, by eigvalsh."""
    from mpi_petsc4py_example_tpu_torch.models.generators import \
        tridiag_family
    lam = np.linalg.eigvalsh(tridiag_family(100).toarray())
    return float(lam[np.argmax(np.abs(lam))])


def test_py_ok(stdout) -> bool:
    """The test.py flow printed True last."""
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1] == "True"


def test2_line_ok(stdout) -> bool:
    """The test2.py flow under ``--procs`` printed one eigenvalue line, the
    largest eigenvalue of its matrix within 1e-9."""
    lines = stdout.strip().splitlines()
    if len(lines) != 1 or not lines[0].startswith("Eigenvalue: "):
        return False
    want = test2_eigenvalue()
    return abs(complex(lines[0].split()[1]) - want) <= 1e-9 * abs(want)


def test2_threads_ok(stdout) -> bool:
    """The test2.py flow in thread mode printed one eigenvalue, within 1e-8
    relative of eigvalsh's (cfg2's eigenvalue_rel_err limit,
    benchmarks/run_all.py:493)."""
    got = [complex(line.split("Eigenvalue:")[1].strip())
           for line in stdout.splitlines() if "Eigenvalue:" in line]
    want = test2_eigenvalue()
    return len(got) == 1 and abs(got[0].real - want) <= 1e-8 * abs(want)


def flow_specs(flow, procs):
    """The reference ``flow`` (test.py or test2.py) through the port's runner
    and facade on the card: in thread mode at -n 1 and -n 4, or with
    ``procs`` one process per rank at -n 1 over NCCL and -n 2, -n 4 over
    gloo."""
    drivers = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mpi_petsc4py_example_tpu_torch", "facade",
                           "drivers")
    name, ok = {"test.py": ("solve_linear.py", test_py_ok),
                "test2.py": ("eigensolve.py",
                             test2_line_ok if procs else test2_threads_ok)
                }[flow]
    driver = os.path.join(drivers, name)
    if procs:
        return [dict(key=f"{flow}_n{n}_{backend}", nprocs=n, procs=True,
                     label=f"procs (d) {flow} flow -n {n} --procs "
                           f"--backend {backend}",
                     args=["--backend", backend, driver], ok=ok)
                for n, backend in ((1, "nccl"), (2, "gloo"), (4, "gloo"))]
    return [dict(key=f"{flow}_n{n}_threads", nprocs=n, procs=False,
                 label=f"{flow} flow -n {n} on the card", args=[driver],
                 ok=ok) for n in (1, 4)]


def start_flows(specs):
    """Every flow of ``specs`` started at once."""
    return [(spec, RankLaunch(spec["nprocs"], spec["args"], spec["procs"]))
            for spec in specs]


def finish_flows(started, note):
    """Each started flow's output checked; its wall time (the process
    included) by key."""
    card = card_line()
    out = {}
    for spec, launch in started:
        stdout, wall = launch.finish()
        check(spec["ok"](stdout), f"{spec['label']}: {stdout[-500:]}")
        out[spec["key"]] = wall
        log(f"{spec['label']}: printed {stdout.strip().splitlines()}, "
            f"{wall:.1f} s (process included, {note}); {card}")
    return out


def phase_procs(res_cases=(), mega=False, flows=()):
    """The process communicator on the card (``--procs``): (a) one process
    over NCCL holding 4 shards against DeviceComm(4), 128^3 f32 CG + jacobi;
    (b) two processes over gloo on the one card, 2 shards each, against
    DeviceComm(4): 128^3 f32 CG + jacobi, solve_many k = 8 at 128^3 (fast
    path and general route), CG + mg at 64^3 fp64, cfg4 BiCGStab + bjacobi
    (set up on the card; within 1e-12), and the rest of the stack: the
    128^3 fp64 Krylov-Schur (also in (a)), cfg11's RefinedKSP at 128^3
    with f32 and bf16 inner solves, the 128^3 fp64 Neumann AIJ with a
    constant NullSpace, CGNE + jacobi on convdiff2d(1024) and PC lu crtri
    at 2^20 (each bit for bit, or within 1e-12, reported); (c) 512^3 f32
    CG + jacobi on 2 processes x 1 shard against DeviceComm(2): one card
    shared by two processes, not scaling; (d) the test.py and test2.py
    flows through ``run.py --procs`` at -n 1 over NCCL and -n 2, -n 4 over
    gloo. ``res_cases`` (the resilience slice's (f)) ride launches (a)
    and (b); their results go to ``_RES_PROCS_GOT``. With ``mega`` the
    fused program's process cases (``megasolve_procs_cases``) ride them
    too, checked here (``out["megasolve"]``). ``flows``: more flows (see
    :func:`flow_specs`) started with (d).

    The launches start at once: (a), and (b) split over four gloo launches
    of 2 processes; the DeviceComm references run in this process
    meanwhile, and the flows start after them. So each ms/iter and wall
    below was taken with the other launches sharing the card and the host's
    cores: a check that the process paths run and agree bit for bit, not a
    timing of them."""
    card = card_line()
    t_all = time.perf_counter()
    out = {"card": card}
    res_a = [dict(c, name="a_" + c["name"], local_shards=4)
             for c in res_cases]
    res_b = [dict(c, name="b_" + c["name"], local_shards=2)
             for c in res_cases]
    mega_cases, auto = megasolve_procs_cases() if mega else ([], None)
    mega_a = [dict(c, name="a_mega_" + c["name"], local_shards=4)
              for c in mega_cases + [auto]] if mega else []
    mega_b = [dict(c, name="b_mega_" + c["name"], local_shards=2)
              for c in mega_cases + [auto]] if mega else []
    # solved twice, the second timed: a rank process starts cold
    cg128 = dict(kind="cg", grid=[128] * 3, pc="jacobi", dtype="f32",
                 rtol=PROCS_RTOL, time_psum=True, repeat=2)
    # (a) one process, NCCL, world size 1, 4 local shards
    case_a = dict(cg128, name="a_cg128", local_shards=4)
    eps_a = dict(EPS_PROCS, name="a_eps128", local_shards=4)
    plans_a = plan_cases(cg128, "a", 4)
    cx_a = complex_procs_cases(4, "a")
    # (b) two processes over gloo, 2 shards each, against DeviceComm(4);
    # (c) rides the second launch: 512^3 on 2 processes x 1 shard
    cases_b = [dict(cg128, name="b_cg128", local_shards=2),
               dict(kind="many", name="b_many_fast", grid=[128] * 3,
                    pc="jacobi", dtype="f32", rtol=PROCS_RTOL, k=K_BATCH,
                    route="fast", local_shards=2),
               dict(kind="many", name="b_many_general", grid=[128] * 3,
                    pc="jacobi", dtype="f32", rtol=PROCS_RTOL, k=K_BATCH,
                    route="general", local_shards=2),
               dict(kind="cg", name="b_mg64", grid=[64] * 3, pc="mg",
                    dtype="f64", rtol=1e-8, local_shards=2),
               # PC bjacobi set up on the card, each process its blocks
               dict(kind="aij", name="b_cfg4_bjacobi", op="cfg4",
                    ksp="bcgs", pc="bjacobi", local_shards=2)]
    # the rest of the stack (ROADMAP item 4b)
    stack_b = [dict(EPS_PROCS, name="b_eps128", local_shards=2)] + [
        dict(kind="refine", name=f"b_refine_{prec}", grid=[EPS_NX] * 3,
             prec=prec, rtol=1e-10, local_shards=2)
        for prec in ("f32", "bf16")] + [
        dict(kind="aij", name="b_neumann128", op="neumann128", ksp="cg",
             pc="jacobi", nullspace=True, rtol=1e-8, local_shards=2),
        dict(kind="aij", name="b_cgne_convdiff1024", op="convdiff1024",
             ksp="cgne", pc="jacobi", rtol=1e-6, max_it=300,
             local_shards=2),
        dict(kind="aij", name="b_lu_crtri_2p20", op="tri2p20",
             ksp="preonly", pc="lu", local_shards=2)]
    case_c = dict(kind="cg", name="c_cg512", grid=[512] * 3, pc="jacobi",
                  dtype="f32", rtol=PROCS_RTOL, local_shards=1,
                  true_res=True, keep_x=False, time_psum=True)
    plans_b = plan_cases(cg128, "b", 2)
    cx_b = complex_procs_cases(2, "b")
    flow_specs_all = [s for flow in ("test.py", "test2.py")
                      for s in flow_specs(flow, procs=True)] + list(flows)
    # gloo is bound by its latency: (b) runs as four launches of 2
    # processes; the fault-injecting cases last in their launches
    started_a = start_parity(1, [case_a, eps_a] + plans_a + cx_a + mega_a
                             + res_a)
    started_b = [start_parity(2, cases, backend="gloo") for cases in (
        cases_b + plans_b + cx_b + res_b, stack_b, [case_c], mega_b)
        if cases]
    # the references on DeviceComm(4): one run of each case, under the
    # names of both launches
    twins = [(case_a, cases_b[0]), (eps_a, stack_b[0])] + list(
        zip(plans_a + cx_a, plans_b + cx_b))
    refs_a = procs_reference([case_a, eps_a] + plans_a + cx_a, 4)
    refs = procs_reference(cases_b[1:] + stack_b[1:], 4)
    refs.update({cb["name"]: refs_a[ca["name"]] for ca, cb in twins})
    ref_c = procs_reference([case_c], 2)["c_cg512"]
    mega_ref = procs_reference(mega_cases, 4) if mega else None
    # the flows once the rank processes above have started
    started_flows = start_flows(flow_specs_all)
    got_a, wall = finish_parity(started_a)
    _RES_PROCS_GOT["nccl 1x4"] = {c["name"]: got_a["a_" + c["name"]]
                                  for c in res_cases}
    ref = refs_a["a_cg128"]
    got = got_a["a_cg128"]
    its, _ = procs_compare("(a) 128^3 CG+jacobi, nccl 1 x 4", got, ref)
    check(str(got["backend"]) == "nccl", f"(a) backend {got['backend']}")
    dots = int(got["launches_stencil3d_dot"])
    check(dots == 4 * (its[0] + 1),
          f"(a) stencil7_dot launches {dots} != 4 local shards x "
          f"({its[0]} iterations + 1)")
    out["a"] = {"iterations": its[0], "stencil7_dot_launches": dots,
                "ms_per_iter": ms_per_iter(got),
                "ms_per_iter_virtual": ms_per_iter(ref),
                "psum_us": float(got["psum_us"]),
                "psum_us_virtual": float(ref["psum_us"]),
                "launch_wall_s": wall}
    log(f"procs (a) nccl, 1 process x 4 shards, 128^3 f32 CG+jacobi: "
        f"{its[0]} iterations (= DeviceComm(4), x bit-equal), "
        f"stencil7_dot {dots} = 4 x (its + 1), "
        f"{out['a']['ms_per_iter']:.4f} ms/iter vs "
        f"{out['a']['ms_per_iter_virtual']:.4f} on DeviceComm(4); psum "
        f"{out['a']['psum_us']:.1f} us vs {out['a']['psum_us_virtual']:.1f} "
        f"us (ended by a host read; the launches share the card); {card}")
    out["a"]["eps"] = procs_eps("procs (a) nccl 1 x 4", got_a["a_eps128"],
                                refs_a["a_eps128"], 4, card)
    out["a"]["plans"] = procs_plans("(a) nccl 1 x 4", got_a, refs_a,
                                    plans_a, card)
    out["a"]["complex"] = complex_procs_check("(a) nccl 1 x 4", got_a,
                                              refs_a, cx_a, card)
    got, walls_b = {}, []
    for started in started_b:
        got_b, wall_b = finish_parity(started)
        got.update(got_b)
        walls_b.append(wall_b)
    _RES_PROCS_GOT["gloo 2x2"] = {c["name"]: got["b_" + c["name"]]
                                  for c in res_cases}
    out["b"] = {"launch_walls_s": walls_b}
    for c in cases_b:
        g, r = got[c["name"]], refs[c["name"]]
        # a batch of 2 blocks against 4: the card's batched inverse may
        # round them differently; held within 1e-12, the diff reported
        aij = c["kind"] == "aij"
        its, diff = procs_compare(f"(b) {c['name']}, gloo 2 x 2", g, r,
                                  bits=not aij)
        if aij:
            scale = max(float(np.abs(r["x"]).max()), 1.0)
            check(diff <= 1e-12 * scale, f"(b) {c['name']}: x differs by "
                                         f"{diff}")
        check(str(g["backend"]) == "gloo", f"(b) backend {g['backend']}")
        launched = {k[len("launches_"):]: int(v) for k, v in g.items()
                    if k.startswith("launches_") and int(v)}
        out["b"][c["name"]] = {
            "iterations": its, "x_max_diff": diff,
            "ms_per_iter": ms_per_iter(g), "ms_per_iter_virtual":
            ms_per_iter(r), "host_copies": int(g["host_copies_total"]),
            "launches": launched}
        psum = ""
        if "psum_us" in g:
            out["b"][c["name"]].update(
                psum_us=float(g["psum_us"]),
                psum_host_us=float(g["psum_host_us"]),
                psum_us_virtual=float(r["psum_us"]))
            psum = (f"psum {float(g['psum_us']):.1f} us (host tensors on "
                    f"the same gloo group {float(g['psum_host_us']):.1f} "
                    f"us) vs {float(r['psum_us']):.1f} us, ")
        log(f"procs (b) gloo, 2 processes x 2 shards, {c['name']}: "
            f"iterations {its} (= DeviceComm(4), x max diff {diff}), "
            f"{out['b'][c['name']]['ms_per_iter']:.4f} ms/iter vs "
            f"{out['b'][c['name']]['ms_per_iter_virtual']:.4f} on "
            f"DeviceComm(4), {psum}gloo host copies "
            f"{int(g['host_copies_total'])}, launches of rank 0 {launched}; "
            f"{card}")
    one = "gloo on ONE card: a comparison, not scaling"
    out["b"]["plans"] = procs_plans(f"(b) gloo 2 x 2 ({one})", got, refs,
                                    plans_b, card)
    out["b"]["complex"] = complex_procs_check(f"(b) gloo 2 x 2 ({one})",
                                              got, refs, cx_b, card)
    out["b"]["eps"] = procs_eps(f"procs (b) gloo 2 x 2 ({one})",
                                got["b_eps128"],
                                refs["b_eps128"], 2, card)
    for c in stack_b[1:]:
        g, r = got[c["name"]], refs[c["name"]]
        extra = ""
        if c["kind"] == "refine":
            rr = refine_relres(g["x"])
            extra = (f", {int(g['steps'])} outer steps, fp64 relres "
                     f"{rr:.3e}")
            if c["prec"] == "f32":
                check(rr <= 1.05e-10, f"{c['name']}: fp64 relres {rr}")
            else:
                check(int(g["launches_stencil3d_dot_bf16"]) > 0,
                      f"{c['name']}: row 1b never launched")
        if c.get("op") == "neumann128":
            mean = float(np.mean(g["x"]))
            extra = f", mean(x) {mean:.3e}"
            check(abs(mean) <= 1e-10 * float(np.abs(g["x"]).max()),
                  "procs Neumann solution is not mean-free")
        out["b"][c["name"]] = procs_stack(
            f"procs (b) gloo 2 x 2 {c['name']} ({one})", g, r, card, extra)
        if c["kind"] == "refine":
            out["b"][c["name"]]["relres"] = rr
    g = got["c_cg512"]
    its, _ = procs_compare("(c) 512^3 CG+jacobi, gloo 2 x 1", g, ref_c,
                           bits=False)
    true_res, bnorm = float(g["true_res"]), float(g["bnorm"])
    check(true_res <= 10 * PROCS_RTOL * bnorm,
          f"(c) fp64 true residual {true_res} > 10 rtol ||b|| "
          f"({10 * PROCS_RTOL * bnorm})")
    plane_bytes = 512 * 512 * 4
    out["c"] = {"iterations": its[0], "true_res": true_res, "bnorm": bnorm,
                "ms_per_iter": ms_per_iter(g),
                "ms_per_iter_virtual": ms_per_iter(ref_c),
                "host_copies": int(g["host_copies"]),
                "psum_us": float(g["psum_us"]),
                "psum_host_us": float(g["psum_host_us"]),
                "psum_us_virtual": float(ref_c["psum_us"]),
                "halo_bytes_per_exchange": 2 * plane_bytes}
    log(f"procs (c) gloo, 2 processes x 1 shard on ONE card (shared, not "
        f"scaling), 512^3 f32 CG+jacobi: {its[0]} iterations (= "
        f"DeviceComm(2)), fp64 true residual {true_res:.3e} <= 10 rtol "
        f"||b|| = {10 * PROCS_RTOL * bnorm:.3e}, "
        f"{out['c']['ms_per_iter']:.4f} ms/iter with "
        f"{out['c']['host_copies']} gloo host copies on rank 0 "
        f"({out['c']['host_copies'] / max(its[0], 1):.1f}/iter) vs "
        f"{out['c']['ms_per_iter_virtual']:.4f} ms/iter on DeviceComm(2); "
        f"psum {out['c']['psum_us']:.1f} us (host tensors on the same gloo "
        f"group {out['c']['psum_host_us']:.1f} us) vs "
        f"{out['c']['psum_us_virtual']:.1f} us; halo {2 * plane_bytes} B "
        f"per exchange; {card}")
    if mega:
        out["megasolve"] = {}
        for label, prefix, got_m, wall_m, captured in (
                ("nccl 1x4", "a_mega_", got_a, wall, True),
                ("gloo 2x2", "b_mega_", got, walls_b[-1], False)):
            got_m = {c["name"]: got_m[prefix + c["name"]]
                     for c in mega_cases + [auto]}
            out["megasolve"][label] = megasolve_procs_check(
                label, got_m, mega_ref, mega_cases, auto, captured)
            out["megasolve"][label]["launch_wall_s"] = wall_m
    # (d) the test.py and test2.py flows through the runner's process mode
    out["d"] = finish_flows(
        started_flows, f"the {len(started_flows)} flows beside (a) and "
                       "(b)")
    log(f"procs phases: {time.perf_counter() - t_all:.1f} s")
    return out


def phase_procs_cards():
    """``--procs-cards``, on a host of several cards: one rank process per
    card over NCCL (its all-gathers and ring ``batch_isend_irecv`` across
    cards), 1 shard each, against ``DeviceComm(cards)`` on card 0: 128^3
    f32 CG + jacobi (psum and ms/iter), ``solve_many`` k = 8 at 128^3, CG +
    mg at 64^3 fp64, the AIJ cfg3 GMRES(30) + jacobi and cfg4 BiCGStab +
    bjacobi, the 128^3 fp64 Krylov-Schur, and the test.py and test2.py
    flows. One shard per process turns the
    shard-batched products of the AIJ path (bjacobi's blocks, GMRES's basis
    updates) into unbatched ones, which cuBLAS rounds differently: those
    iterates are held within 1e-12, the stencil ones bit for bit."""
    import torch
    cards = torch.cuda.device_count()
    check(cards >= 2, f"--procs-cards needs 2 cards or more, found {cards}")
    card = card_line()
    cases = [dict(kind="cg", name="cg128", grid=[128] * 3, pc="jacobi",
                  dtype="f32", rtol=PROCS_RTOL, time_psum=True, repeat=2),
             dict(kind="many", name="many128", grid=[128] * 3, pc="jacobi",
                  dtype="f32", rtol=PROCS_RTOL, k=K_BATCH, route="fast"),
             dict(kind="cg", name="mg64", grid=[64] * 3, pc="mg",
                  dtype="f64", rtol=1e-8),
             dict(kind="aij", name="cfg3_gmres", op="cfg3", ksp="gmres",
                  pc="jacobi"),
             dict(kind="aij", name="cfg4_bcgs", op="cfg4", ksp="bcgs",
                  pc="bjacobi"),
             dict(kind="comm", name="comm", n=1000),
             dict(EPS_PROCS, name="eps128")]
    cases = [dict(c, local_shards=1) for c in cases]
    plans = plan_cases(cases[0], "cards", 1)
    refs = procs_reference(cases + plans, cards)
    got, wall = parity_launch(cards, cases + plans, backend="nccl")
    out = {"card": card, "cards": cards, "launch_wall_s": wall}
    out["plans"] = procs_plans(f"--procs-cards NCCL {cards} x 1", got, refs,
                               plans, card)
    for c in cases:
        g, r = got[c["name"]], refs[c["name"]]
        check(str(g["backend"]) == "nccl", f"backend {g['backend']}")
        if c["kind"] == "comm":
            for key in ("put_fetch", "psum", "pmax", "shift_up", "shift_down",
                        "open_up", "open_down", "all_gather", "cols"):
                check(np.array_equal(g[key], r[key]),
                      f"--procs-cards: {key} differs across {cards} cards")
            log(f"procs-cards: every collective equal to DeviceComm({cards})"
                f" over NCCL on {cards} cards; {card}")
            continue
        if c["kind"] == "eps":
            out["eps"] = procs_eps(f"procs-cards NCCL {cards} x 1", g, r, 1,
                                   card)
            continue
        aij = c["kind"] == "aij"
        its, diff = procs_compare(f"--procs-cards {c['name']}", g, r,
                                  bits=not aij)
        if aij:
            scale = max(float(np.abs(r["x"]).max()), 1.0)
            check(diff <= 1e-12 * scale, f"{c['name']}: x differs by {diff}")
        out[c["name"]] = {"iterations": its, "x_max_diff": diff,
                          "ms_per_iter": ms_per_iter(g),
                          "ms_per_iter_virtual": ms_per_iter(r)}
        if "psum_us" in g:
            out[c["name"]].update(psum_us=float(g["psum_us"]),
                                  psum_us_virtual=float(r["psum_us"]))
        log(f"procs-cards NCCL {cards} x 1, {c['name']}: iterations {its} (= "
            f"DeviceComm({cards}) on one card), x max diff {diff}, "
            f"{out[c['name']]['ms_per_iter']:.4f} ms/iter vs "
            f"{out[c['name']]['ms_per_iter_virtual']:.4f}; "
            + (f"psum {float(g['psum_us']):.1f} us vs "
               f"{float(r['psum_us']):.1f} us; " if "psum_us" in g else "")
            + card)
    root = os.path.dirname(os.path.abspath(__file__))
    driver = os.path.join(root, "mpi_petsc4py_example_tpu_torch", "facade",
                          "drivers", "solve_linear.py")
    stdout, wall = run_ranks(cards, ["--backend", "nccl", driver])
    check(stdout.strip().splitlines() == ["True"],
          f"test.py flow -n {cards} over NCCL: {stdout[-500:]}")
    out["testpy_wall_s"] = wall
    log(f"procs-cards test.py flow -n {cards} --procs (NCCL): printed True, "
        f"{wall:.1f} s; {card}")
    stdout, wall = run_ranks(cards, ["--backend", "nccl", os.path.join(
        os.path.dirname(driver), "eigensolve.py")])
    check(test2_line_ok(stdout),
          f"test2.py flow -n {cards} over NCCL: {stdout[-500:]}")
    out["test2py_wall_s"] = wall
    log(f"procs-cards test2.py flow -n {cards} --procs (NCCL): printed "
        f"{stdout.strip()}, {wall:.1f} s; {card}")
    return out


# ---- the Krylov types of ROADMAP Queue A item 5 (--ksp-types) ---------------

KSP_RTOL = 1e-6
# the 128^3 f32 runs beside cg: (label, type, KSP attributes, parity). The
# parity rule is asserted where the JAX package reaches rtol in f32 too
# (ROADMAP.md Queue C): unguarded pipecg and fbcgsr stagnate or diverge in
# f32 there, and sstep's s = 8 monomial basis (~kappa^4) loses f32; they run
# to KSP_MAX_IT_REPORTED and are reported. minres and symmlq judge their
# reason on the f32 true residual, which may sit just above rtol.
KSP_TYPE_RUNS = [
    ("cg", "cg", {}, True), ("pipecg", "pipecg", {}, False),
    ("sstep s=4", "sstep", {"sstep_s": 4}, True),
    ("sstep s=8", "sstep", {"sstep_s": 8}, False),
    ("cr", "cr", {}, True), ("fcg", "fcg", {}, True),
    ("minres", "minres", {}, True), ("symmlq", "symmlq", {}, True),
    ("gcr", "gcr", {}, True), ("cgs", "cgs", {}, True),
    ("tfqmr", "tfqmr", {}, True), ("bcgsl", "bcgsl", {}, True),
    ("fbcgs", "fbcgs", {}, True), ("fbcgsr", "fbcgsr", {}, False)]
KSP_MAX_IT = 2000
# the cap of the runs that stagnate in f32 (reported, not held to rtol)
KSP_MAX_IT_REPORTED = 1000
# vector passes an iteration of the f32 Jacobi solves at 512^3, counted from
# the code (each operand read once, each result written once; the stencil
# apply 2): cg's fast path 14 (Adot 2, x and r updates 3 each, <r, r> 1,
# p = r/d + beta p 5); pipecg's fast path 33 (the fused dots 5, m = w/d 2,
# n = A m 2, V's four addcmul rows 12, S's one addcmul over four rows 12);
# sstep s = 4, a block of 4 (the basis: 7 applies 14, 8 Jacobi applies 24,
# 17 row copies 34; the Gram read 19; three combinations 9 + 1 and two
# updates 3: 39), 131 / 4
KSP_PASSES = {"cg": 14, "pipecg": 33, "sstep": 131 / 4}


def ksp_solver(comm, op, ksp_type, rtol=KSP_RTOL, max_it=20000,
               pc="jacobi", norm_none=False, **attrs):
    import mpi_petsc4py_example_tpu_torch as pt
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    for k, v in attrs.items():
        setattr(ksp, k, v)
    if norm_none:
        ksp.set_norm_type("none")
    return ksp


def card_relres(comm, nx, b_data, x_data):
    """The fp64 true relative residual of ``x`` on the card, with the fp64
    stencil (columns of a ``(1, k, n)`` block each their own)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    op64 = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    n = nx ** 3
    X = x_data.double().reshape(-1, n)
    B = b_data.double().reshape(-1, n)
    out = []
    for j in range(X.shape[0]):
        ax = op64.mult(pt.Vec(comm, n, data=X[j].contiguous())).data
        out.append(float(torch.linalg.vector_norm(B[j] - ax)
                         / torch.linalg.vector_norm(B[j])))
    return out


def phase_ksp_types_128(card, oracle=None):
    """128^3 f32 stencil, PC jacobi, rtol 1e-6 (bench.py's headline): every
    type of KSP_TYPE_RUNS beside cg, counters zeroed just before each
    solve, the fp64 true relres against scipy's fp64 CG (bench.py:334), the
    warm ms an iteration, host syncs, launches of rows 1 and 2, and the
    plain-version path's iterations (within 2%); pipecg also in fp64 (it
    converges there, with the parity rule); richardson and chebyshev at
    max_it 2000 (Jacobi's spectral radius cos(pi/129) keeps them from rtol)
    and on 32^3 fp64, where both converge. ``oracle`` is the main path's
    (its scipy residual for the same ``b``), or None to solve it here."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx = 128
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    if oracle is not None and oracle["nx"] == nx:
        r_sc = oracle["r_cpu"] / oracle["bnorm"]
    else:
        A = pt.poisson3d_csr(nx).astype(np.float64)
        t0 = time.perf_counter()
        x_cpu, info = scipy_cg(A, b.astype(np.float64), KSP_RTOL)
        bb = b.astype(np.float64)
        r_sc = float(np.linalg.norm(bb - A @ x_cpu) / np.linalg.norm(bb))
        log(f"ksp-types: scipy fp64 CG+jacobi oracle at {nx}^3: info "
            f"{info}, relres {r_sc:.3e} ({time.perf_counter() - t0:.1f} s)")
    limit = 10 * max(r_sc, KSP_RTOL)
    out = {"scipy_relres": r_sc}
    runs = [(lbl, t, a, par, torch.float32) for lbl, t, a, par in
            KSP_TYPE_RUNS] + [("pipecg fp64", "pipecg", {}, True,
                               torch.float64),
                              ("cg fp64", "cg", {}, True, torch.float64)]
    ops = {torch.float32: op}
    for label, t, attrs, parity, dt in runs:
        if dt not in ops:
            ops[dt] = pt.StencilPoisson3D(comm, nx, dtype=dt)
        o = ops[dt]
        ksp = ksp_solver(comm, o, t, max_it=KSP_MAX_IT if parity
                         else KSP_MAX_IT_REPORTED, **attrs)
        x, bv = o.get_vecs()
        bv.set_global(b)
        torch.cuda.synchronize()
        reset_launches()
        res = ksp.solve(bv, x)
        launches = {"stencil7_apply": st.stencil3d_apply.launches,
                    "stencil7_dot": st.stencil3d_dot.launches}
        rel = card_relres(comm, nx, bv.data, x.data)[0]
        x.zero()
        warm = ksp.solve(bv, x)
        o.force_plain = True
        xp, _ = o.get_vecs()
        plain = ksp.solve(bv, xp)
        o.force_plain = False
        ms = warm.wall_time / max(warm.iterations, 1) * 1e3
        out[label] = {"iterations": res.iterations, "reason": res.reason_name,
                      "relres": rel, "ms_per_iter": ms,
                      "host_syncs": res.host_syncs, "launches": launches,
                      "plain_iterations": plain.iterations}
        log(f"ksp-types {nx}^3 {str(dt)[6:]} {label}+jacobi: "
            f"{res.iterations} iterations, {res.reason_name}, fp64 true "
            f"relres {rel:.3e} (scipy {r_sc:.3e}, limit {limit:.1e}"
            f"{'' if parity else ', reported'}), warm {ms:.4f} ms/iter, "
            f"host syncs {res.host_syncs}, launches {launches}, plain path "
            f"{plain.iterations} iterations; {card}")
        check(abs(plain.iterations - res.iterations)
              <= 0.02 * res.iterations,
              f"ksp-types {label}: plain path {plain.iterations} vs kernels "
              f"{res.iterations}")
        if parity:
            check(rel <= limit, f"ksp-types {label}: relres {rel} > {limit}")
        if t == "cg":
            check(launches["stencil7_dot"] == res.iterations + 1,
                  f"ksp-types {label}: dot launches {launches}")
        else:
            check(launches["stencil7_apply"] > 0 and
                  launches["stencil7_dot"] == 0,
                  f"ksp-types {label}: launches {launches}")
        if t == "pipecg":
            check(launches["stencil7_apply"] == res.iterations + 3,
                  f"ksp-types pipecg: apply launches {launches} != "
                  f"iterations + 3")
            check(res.host_syncs == res.iterations + 2,
                  f"pipecg host syncs {res.host_syncs}")
        if t == "sstep":
            blocks = res.host_syncs - 2
            s = attrs["sstep_s"]
            check(launches["stencil7_apply"] == 2 + (2 * s - 1) * blocks,
                  f"ksp-types {label}: apply launches {launches} != 2 + "
                  f"{2 * s - 1} x {blocks} blocks")
            out[label]["blocks"] = blocks
    # the stationary types
    for t in ("richardson", "chebyshev"):
        ksp = ksp_solver(comm, op, t, max_it=KSP_MAX_IT)
        x, bv = op.get_vecs()
        bv.set_global(b)
        reset_launches()
        res = ksp.solve(bv, x)
        apply = st.stencil3d_apply.launches
        rel = card_relres(comm, nx, bv.data, x.data)[0]
        o32 = pt.StencilPoisson3D(comm, 32, dtype=torch.float64)
        b32 = o32.mult(pt.Vec.from_global(
            comm, np.random.default_rng(7).random(32 ** 3))).data
        k32 = ksp_solver(comm, o32, t, max_it=6000)
        x32, bv32 = o32.get_vecs()
        bv32.data = b32.clone()
        r32 = k32.solve(bv32, x32)
        rel32 = card_relres(comm, 32, b32, x32.data)[0]
        out[t] = {"iterations": res.iterations, "reason": res.reason_name,
                  "relres": rel, "stencil7_apply": apply,
                  "ms_per_iter": res.wall_time / res.iterations * 1e3,
                  "at_32_f64": [r32.iterations, r32.reason_name, rel32]}
        log(f"ksp-types {nx}^3 f32 {t}+jacobi, max_it {KSP_MAX_IT}: "
            f"{res.iterations} iterations, {res.reason_name}, fp64 true "
            f"relres {rel:.3e}, {out[t]['ms_per_iter']:.4f} ms/iter, "
            f"stencil7_apply {apply}; 32^3 fp64: {r32.iterations} "
            f"iterations, {r32.reason_name}, relres {rel32:.3e}; {card}")
        check(apply > 0, f"{t}: stencil7_apply never launched")
        check(r32.converged and rel32 <= 10 * KSP_RTOL,
              f"{t} at 32^3 fp64: {r32}, relres {rel32}")
    return out


def phase_ksp_types_512(card):
    """512^3 f32 (cfg5's grid), PC jacobi, rtol 1e-6: cg, pipecg and sstep
    s = 4 to rtol or max_it 600 (fp64 true relres; cg's held to 10 rtol,
    the other two, which stagnate in f32, reported), then the delta-method
    ms an iteration against the passes counted from the code over the
    11-pass bound; host syncs, launches, peak memory."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx = 512
    n = nx ** 3
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    bv = op.mult(pt.Vec(comm, n, data=torch.rand(
        n, generator=g, device="cuda", dtype=torch.float32)))
    x, _ = op.get_vecs()
    pass_ms = n * 4 / HBM_BYTES_PER_S * 1e3
    out = {}
    for label, t, attrs in (("cg", "cg", {}), ("pipecg", "pipecg", {}),
                            ("sstep s=4", "sstep", {"sstep_s": 4})):
        ksp = ksp_solver(comm, op, t, max_it=600 if t != "cg" else 1200,
                         **attrs)
        x.zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = ksp.solve(bv, x)
        launches = {"stencil7_apply": st.stencil3d_apply.launches,
                    "stencil7_dot": st.stencil3d_dot.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rel = card_relres(comm, nx, bv.data, x.data)[0]
        torch.cuda.empty_cache()
        solvers = {m: ksp_solver(comm, op, t, 0.0, max_it=m, norm_none=True,
                                 **attrs) for m in (20, 220)}
        per, samples = delta_per_iter(solvers, bv, x, reps=1)
        passes = KSP_PASSES[t]
        bound = passes * pass_ms
        out[label] = {"iterations": res.iterations, "reason": res.reason_name,
                      "relres": rel, "ms_per_iter": per * 1e3,
                      "samples_ms": [s * 1e3 for s in samples],
                      "host_syncs": res.host_syncs, "launches": launches,
                      "peak_gib": peak, "passes": passes,
                      "passes_bound_ms": bound}
        log(f"ksp-types 512^3 f32 {label}+jacobi: {res.iterations} "
            f"iterations, {res.reason_name}, fp64 true relres {rel:.3e}, "
            f"delta method {per * 1e3:.4f} ms/iter (samples "
            f"{[round(s * 1e3, 4) for s in samples]}), {passes:.2f} passes "
            f"an iteration counted from the code: bound {bound:.4f} ms "
            f"({bound / (per * 1e3) * 100:.1f}% of it reached; the 11-pass "
            f"bound {11 * pass_ms:.4f}), host syncs {res.host_syncs}, "
            f"launches {launches}, peak {peak:.2f} GiB; {card}")
        check(launches["stencil7_apply"] + launches["stencil7_dot"] > 0,
              f"512^3 {label}: no kernel launched")
        if t == "cg":
            check(res.converged and rel <= 10 * KSP_RTOL,
                  f"512^3 {label}: {res}, relres {rel}")
    out["pipecg_over_cg"] = (out["pipecg"]["ms_per_iter"]
                             / out["cg"]["ms_per_iter"])
    out["sstep_over_cg"] = (out["sstep s=4"]["ms_per_iter"]
                            / out["cg"]["ms_per_iter"])
    return out


def phase_ksp_types_many(card, k=K_BATCH):
    """128^3 f32, k = 8 right-hand sides (bench.py's batched block) through
    ``solve_many`` with pipecg and sstep s = 4, PC jacobi on the operator:
    counters zeroed just before; every column's fp64 true relres (the
    parity rule against scipy's CG, whose own stopping test holds its
    residual at rtol), row 9 launches per lockstep, each column's
    iterations within 2% of its single solve."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx = 128
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    B, cols = bench_block(comm, op, b, k)
    out = {}
    for label, t, attrs, parity in (("pipecg", "pipecg", {}, False),
                                    ("sstep s=4", "sstep", {"sstep_s": 4},
                                     True)):
        ksp = ksp_solver(comm, op, t, max_it=KSP_MAX_IT if parity
                         else KSP_MAX_IT_REPORTED, **attrs)
        torch.cuda.synchronize()
        reset_launches()
        res = ksp.solve_many(B)
        many = st.stencil3d_apply_many.launches
        single = st.stencil3d_apply.launches
        X = torch.tensor(res.X.T.copy(), device="cuda")
        rels = card_relres(comm, nx, torch.tensor(B.T.copy(), device="cuda"),
                           X)
        seq = []
        for j, bj in enumerate(cols):
            x, _ = op.get_vecs()
            seq.append(ksp.solve(bj, x).iterations)
        lock = max(res.iterations)
        out[label] = {"iterations": res.iterations, "sequential": seq,
                      "reasons": [int(r) for r in res.reasons],
                      "relres": rels, "stencil7_apply_many": many,
                      "lockstep_iterations": lock,
                      "host_syncs": res.host_syncs,
                      "ms_per_lockstep": res.wall_time / lock * 1e3}
        log(f"ksp-types {nx}^3 f32 k={k} solve_many {label}+jacobi: "
            f"iterations {res.iterations} (sequential {seq}), reasons "
            f"{out[label]['reasons']}, fp64 true relres "
            f"{[f'{r:.2e}' for r in rels]}, stencil7_apply_many {many} "
            f"({many / lock:.3f} a lockstep iteration), stencil7_apply "
            f"{single}, host syncs {res.host_syncs}, "
            f"{out[label]['ms_per_lockstep']:.4f} ms a lockstep; {card}")
        check(many > 0 and single == 0,
              f"k={k} {label}: launches many {many} single {single}")
        for j in range(k):
            check(abs(seq[j] - res.iterations[j]) <= 0.02 * seq[j],
                  f"k={k} {label} column {j}: {res.iterations[j]} vs "
                  f"sequential {seq[j]}")
            if parity:
                check(rels[j] <= 10 * KSP_RTOL,
                      f"k={k} {label} column {j}: relres {rels[j]}")
        if t == "pipecg":
            check(many == lock + 3, f"pipecg k={k}: apply_many {many} != "
                                    f"lockstep iterations + 3")
    return out


def phase_ksp_types_bf16(card, k=K_BATCH):
    """bf16 storage at 128^3 (fp32 reductions), rtol 4 eps_bf16: pipecg (its
    fast path, row 2b), sstep s = 4 and richardson (row 2b), and pipecg and
    sstep with k = 8 through ``solve_many`` (row 9b): reasons, iterations
    and launches. Unguarded bf16 pipecg may stagnate, as in the JAX package
    (its drift bound is the guard, item 6): reported."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx, rtol = 128, 4 * 2.0 ** -7
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.bfloat16)
    out = {}
    for label, t, attrs in (("pipecg", "pipecg", {}),
                            ("sstep s=4", "sstep", {"sstep_s": 4}),
                            ("richardson", "richardson", {})):
        ksp = ksp_solver(comm, op, t, rtol=rtol, max_it=KSP_MAX_IT, **attrs)
        x, bv = op.get_vecs()
        bv.set_global(b)
        reset_launches()
        res = ksp.solve(bv, x)
        row2b = st.stencil3d_apply.launches_bf16
        rel = card_relres(comm, nx, bv.data, x.data)[0]
        out[label] = {"iterations": res.iterations, "reason": res.reason_name,
                      "relres": rel, "stencil7_apply_bf16": row2b}
        log(f"ksp-types {nx}^3 bf16 {label}+jacobi rtol {rtol:g}: "
            f"{res.iterations} iterations, {res.reason_name}, fp64 true "
            f"relres {rel:.3e}, row 2b launches {row2b}; {card}")
        check(row2b > 0, f"bf16 {label}: row 2b never launched")
    B, _ = bench_block(comm, op, b, k)
    for label, t, attrs in (("pipecg k=8", "pipecg", {}),
                            ("sstep s=4 k=8", "sstep", {"sstep_s": 4})):
        ksp = ksp_solver(comm, op, t, rtol=rtol, max_it=KSP_MAX_IT, **attrs)
        reset_launches()
        res = ksp.solve_many(B)
        row9b = st.stencil3d_apply_many.launches_bf16
        out[label] = {"iterations": res.iterations,
                      "reasons": [int(r) for r in res.reasons],
                      "stencil7_apply_many_bf16": row9b}
        log(f"ksp-types {nx}^3 bf16 {label} solve_many: iterations "
            f"{res.iterations}, reasons {out[label]['reasons']}, row 9b "
            f"launches {row9b}; {card}")
        check(row9b > 0, f"bf16 {label}: row 9b never launched")
    return out


def phase_ksp_types_aij(card):
    """cfg4 (``convdiff2d(256, beta=0.4)``, PC bjacobi, f32, rtol 1e-6;
    benchmarks/run_all.py:521-549) with the unsymmetric types, and cfg3
    (``poisson2d(512)``, PC jacobi, :497-518) with lgmres beside
    gmres(30): iterations, fp64 true relres and warm wall."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr
    comm = pt.DeviceComm()
    out = {"cfg4": {}, "cfg3": {}}
    for cfg, A, pc, runs in (
            ("cfg4", convdiff2d(256, beta=0.4), "bjacobi",
             [("bcgs", "bcgs", {}), ("fbcgs", "fbcgs", {}),
              ("fbcgsr", "fbcgsr", {}), ("bcgsl ell=2", "bcgsl", {}),
              ("bcgsl ell=3", "bcgsl", {"bcgsl_ell": 3}),
              ("cgs", "cgs", {}), ("tfqmr", "tfqmr", {}), ("gcr", "gcr", {}),
              ("lgmres", "lgmres", {})]),
            ("cfg3", poisson2d_csr(512), "jacobi",
             [("gmres(30)", "gmres", {}), ("lgmres(30, 2)", "lgmres", {})])):
        b = manufactured(A)
        m, _ = assemble(comm, A, torch.float32)
        bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
        for label, t, attrs in runs:
            # fbcgsr stagnates in f32 on cfg4: capped
            ksp = ksp_solver(comm, m, t, pc=pc, max_it=40000 if cfg == "cfg3"
                             else KSP_MAX_IT, **attrs)
            x, _ = m.get_vecs()
            first = ksp.solve(bv, x)
            x.zero()
            res = ksp.solve(bv, x)
            rel = true_relres(A, x.to_numpy(), b)
            out[cfg][label] = {"iterations": res.iterations,
                               "reason": res.reason_name, "relres": rel,
                               "wall_s": res.wall_time,
                               "host_syncs": res.host_syncs}
            log(f"ksp-types {cfg} f32 {label}+{pc}: {res.iterations} "
                f"iterations, {res.reason_name}, fp64 true relres "
                f"{rel:.3e}, wall {res.wall_time:.3f} s (first "
                f"{first.wall_time:.3f} s), host syncs {res.host_syncs}; "
                f"{card}")
            check(res.iterations > 0, f"{cfg} {label}: no iteration")
    return out


def phase_ksp_types(oracle=None):
    """The Krylov types of ROADMAP Queue A item 5 (5.1 and 5.2) on the card;
    no kernel of their own: they launch rows 1, 2, 9, 2b and 9b."""
    card = card_line()
    t0 = time.perf_counter()
    out = {"card": card, "128": phase_ksp_types_128(card, oracle),
           "512": timed(phase_ksp_types_512, card),
           "many": phase_ksp_types_many(card),
           "bf16": phase_ksp_types_bf16(card),
           "aij": phase_ksp_types_aij(card)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"ksp-types phases: {out['wall_s']:.1f} s")
    return out


# ---- the bf16 V-cycle kernels and the fused megasolve (--megasolve) ---------

# the V-cycle's bfloat16 instantiations (rows 3b-6b), by f32 kernel name
BF16_VCYCLE = {"stencil7_smooth": "stencil7_smooth_bf16",
               "stencil7_residual": "stencil7_residual_bf16",
               "stencil7_smooth0_pair": "stencil7_smooth0_pair_bf16",
               "mg3d_smooth_pair": "mg3d_smooth_pair_bf16"}
# the passes each moves (2 bytes a point): smooth, residual and the pair
# read u and f and write the result; smooth0_pair reads f, writes u
VCYCLE_PASSES = {"stencil7_smooth_bf16": 3, "stencil7_residual_bf16": 3,
                 "stencil7_smooth0_pair_bf16": 2, "mg3d_smooth_pair_bf16": 3}
# shapes past the mg3d tiles and the bf16 runs, beside the cycle's levels;
# for the bf16 pair's 64 x 32 tile, its runs of 4 and its z-chunks: nx one
# short of and one past the tile (63, 65), odd (131, 7), not a whole number
# of runs (66: the elem route), a multiple of 8 short of a tile (72: vec16
# with a part tile); ny one short of and one past the tile (31, 33); lz one
# past a 128-plane chunk on a plane of 144 tiles, where the grid keeps that
# chunk and stages 2 planes ahead (129 planes)
VCYCLE_EDGE_SHAPES = ((17, 15, 63), (35, 17, 65), (37, 45, 131), (4, 9, 255),
                      (3, 5, 7), (19, 31, 64), (18, 33, 72), (9, 33, 66),
                      (129, 257, 1024))


def read_vcycle_bf16_launches():
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    return {bf: st.KERNELS[name].launches_bf16
            for name, bf in BF16_VCYCLE.items()}


def vcycle_bf16_calls(st, u, f, lo, hi):
    """``{name: (kernel(), plain())}`` of rows 3b-6b on these bf16 inputs
    (smooth and residual with the halos given, None for zero planes)."""
    from mpi_petsc4py_example_tpu_torch.solvers.mg import cheby_omegas
    w = 2.0 / 3.0 / 6.0
    w1, w2 = (c / 6.0 for c in cheby_omegas(2))
    return {
        "stencil7_smooth_bf16": (
            lambda: st.stencil3d_smooth(u, f, lo, hi, w),
            lambda: st.stencil3d_smooth_plain(u, f, lo, hi, w)),
        "stencil7_residual_bf16": (
            lambda: st.stencil3d_residual(u, f, lo, hi),
            lambda: st.stencil3d_residual_plain(u, f, lo, hi)),
        "stencil7_smooth0_pair_bf16": (
            lambda: st.stencil3d_smooth0_pair(f, w1, w2),
            lambda: st.stencil3d_smooth0_pair_plain(f, w1, w2)),
        "mg3d_smooth_pair_bf16": (
            lambda: st.stencil3d_smooth_pair(u, f, w1, w2),
            lambda: st.stencil3d_smooth_pair_plain(u, f, w1, w2)),
        "two sweeps": (
            lambda: st.stencil3d_smooth_pair(u, f, w1, w2),
            lambda: st.stencil3d_smooth(st.stencil3d_smooth(
                u, f, None, None, w1), f, None, None, w2))}


def phase_vcycle_bf16_checks():
    """Rows 3b-6b against their plain versions on the card, bit for bit
    (as ``phase_bf16_kernel_checks`` holds rows 1b-10b), at every shape the
    driven V-cycles give them (``mg_path_shapes``) and at tile edges, with
    random and zero halos, on aligned inputs and on misaligned copies (the
    element routes); and ``mg3d_smooth_pair_bf16`` against two
    ``stencil7_smooth_bf16`` launches. The references are computed once
    per shape and halo kind, from the aligned inputs. Every launch's route
    is logged. Returns the largest differences (all 0 when the checks
    pass)."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    bf = torch.bfloat16
    t0 = time.perf_counter()
    worst = {name: 0.0 for name in VCYCLE_PASSES}
    shapes = list(mg_path_shapes()) + list(VCYCLE_EDGE_SHAPES)
    routes = set()
    seed = 3000
    secs = {}
    for shape in shapes:
        t_shape = time.perf_counter()
        for halos in (True, False):
            seed += 1
            g = torch.Generator(device="cuda").manual_seed(seed)
            mk = lambda *sh: (torch.rand(sh, generator=g, device="cuda")
                              - 0.5).to(bf)
            u, f = mk(*shape), mk(*shape)
            lo, hi = ((mk(*shape[1:]), mk(*shape[1:])) if halos
                      else (None, None))
            wants = {name: plain() for name, (_, plain) in
                     vcycle_bf16_calls(st, u, f, lo, hi).items()}
            for aligned in (True, False):
                args = ((u, f, lo, hi) if aligned else tuple(
                    None if t is None else misaligned_copy(t)
                    for t in (u, f, lo, hi)))
                calls = vcycle_bf16_calls(st, *args)
                res = {}
                for name, (kern, _) in calls.items():
                    got, want = kern(), wants[name]
                    res[name] = (torch.equal(got, want),
                                 max_abs_diff(got, want))
                    if name in worst:
                        worst[name] = max(worst[name], res[name][1])
                torch.cuda.synchronize()
                out = torch.empty_like(args[0])
                route = (st.bf16_route(args[0], args[2], args[3], out,
                                       args[1]),
                         mg3d_route(shape[-1], 2) if aligned else "elem")
                routes.add(route)
                label = (f"{shape} {'random' if halos else 'zero'} halos, "
                         f"{'aligned' if aligned else 'misaligned'}")
                log(f"check bf16 vcycle {label}, routes stencil7 {route[0]}"
                    f" / mg3d {route[1]}: " + ", ".join(
                        f"{k} {'bit-equal' if v[0] else 'DIFF ' + str(v[1])}"
                        for k, v in res.items()))
                check(all(v[0] for v in res.values()),
                      f"bf16 V-cycle kernels differ, {label}: {res}")
            del u, f, lo, hi, wants
        torch.cuda.synchronize()
        secs[shape] = time.perf_counter() - t_shape
    torch.cuda.empty_cache()
    check({r[0] for r in routes} == {"vec16", "elem"}
          and {r[1] for r in routes} == {"vec16", "elem"},
          f"bf16 V-cycle routes checked: {routes}")
    h = torch.ones(4, 6, 10, device="cuda", dtype=torch.float16)
    for fn in (lambda: st.stencil3d_smooth(h, h, None, None, 0.1),
               lambda: st.stencil3d_residual_restrict(h.to(bf), h.to(bf))):
        try:
            fn()
        except TypeError:
            continue
        raise SystemExit("chip_smoke: FAIL: a V-cycle kernel took a dtype "
                         "it has no instantiation for")
    log(f"check bf16 vcycle: {len(shapes)} shapes, routes {sorted(routes)}; "
        "float16 and a bf16 residual_restrict raise TypeError; "
        f"{time.perf_counter() - t0:.1f} s, of which the edge shapes "
        + ", ".join(f"{sh} {secs[sh]:.2f} s" for sh in VCYCLE_EDGE_SHAPES))
    return worst


def phase_vcycle_bf16_times(n):
    """Rows 3b-6b at n^3 with zero halos (the single-slab levels' launch):
    kernel and plain times, the bytes bound (``VCYCLE_PASSES`` x n^3 x 2
    bytes over the HBM rate; the fp32 operations, about 10 a point, bound
    lower), no library call (cuDNN's conv3d computes none of these
    epilogues)."""
    import torch
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    g = torch.Generator(device="cuda").manual_seed(41)
    mk = lambda *sh: torch.rand(sh, generator=g, device="cuda").to(
        torch.bfloat16)
    u, f = mk(n, n, n), mk(n, n, n)
    big = n >= 512
    out = {}
    calls = vcycle_bf16_calls(st, u, f, None, None)
    for name, (kern, plain) in calls.items():
        if name not in VCYCLE_PASSES:
            continue
        err = max_abs_diff(kern(), plain())
        check(err == 0.0, f"{name} at {n}^3 not bit-equal: {err}")
        t_bytes = VCYCLE_PASSES[name] * n ** 3 * 2 / HBM_BYTES_PER_S
        t_ops = 10 * n ** 3 / F32_FLOPS_PER_S
        b_ms = max(t_bytes, t_ops) * 1e3
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        out[name] = {"ms": device_ms(kern, 20 if big else 100,
                                     10 if big else 25),
                     "plain_ms": device_ms(plain, 2 if big else 10,
                                           reps=5 if big else 25),
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err}
        r = out[name]
        log(f"time {name} {n}^3 bf16: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / r['ms'] * 100:.1f}% of it), no one-call library "
            "equivalent")
    # the pair against the two row-3b launches it fuses, in turns
    pair, two = calls["two sweeps"]
    pair_ms, two_ms = [], []
    for _ in range(2):
        pair_ms.append(device_ms(pair, 20 if big else 100, 10 if big else 25))
        two_ms.append(device_ms(two, 10 if big else 50, 10 if big else 25))
    r = out["mg3d_smooth_pair_bf16"]
    r["two_3b_ms"] = statistics.median(two_ms)
    r["pair_turns_ms"] = pair_ms
    log(f"time mg3d_smooth_pair_bf16 {n}^3 against two stencil7_smooth_bf16 "
        f"launches, in turns: pair {pair_ms} ms, two sweeps {two_ms} ms "
        f"({(1 - statistics.median(pair_ms) / r['two_3b_ms']) * 100:.1f}% "
        "under)")
    del u, f, calls
    torch.cuda.empty_cache()
    return out


def vcycle_launches(nx, cycles, bf16):
    """Launches of ``cycles`` single-slab V-cycles at nx^3: each level
    above the coarsest runs smooth0_pair, then residual_restrict (f32) or
    residual (bf16), then smooth_pair; the coarsest 19 smooth sweeps."""
    from mpi_petsc4py_example_tpu_torch.solvers.mg import mg_levels
    above = len(mg_levels(nx, nx, nx)) - 1
    out = {"stencil7_smooth": 19 * cycles,
           "stencil7_smooth0_pair": above * cycles,
           "mg3d_smooth_pair": above * cycles}
    out["stencil7_residual" if bf16 else "mg3d_residual_restrict"] = \
        above * cycles
    return out


def refined_mg(comm, A, prec, nx, fused):
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.utils.dtypes import (
        inner_precision_dtype)
    rk = pt.RefinedKSP().create(comm)
    rk.set_inner_precision(prec)
    rk.set_operators(A, inner_op=pt.StencilPoisson3D(
        comm, nx, dtype=inner_precision_dtype(prec)),
        outer_op=(pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
                  if fused else None))
    rk.set_type("cg")
    rk.get_pc().set_type("mg")
    rk.set_tolerances(rtol=REFINE_RTOL)
    rk.megasolve = fused
    return rk


def phase_mg_bf16_refine(nx=128):
    """PC mg under refinement at 128^3 on cfg11's problem, rtol 1e-10: the
    inner CG + mg at bf16 (rows 3b-6b) and at f32 (rows 3-7), host loop and
    fused program. Counters zeroed just before each solve, read just after:
    the host loop's V-cycle launches equal one cycle per inner iteration
    and one per outer step; the fused program's one per masked step
    (``chunks x MEGASOLVE_CHUNK``) and one per inner set-up (1 + steps).
    Reported: reason, outer steps, inner iterations, fp64 relres, warm
    wall, replays, host reads, masked steps; each fused iterate is held bit
    for bit against the same program run uncaptured."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    A, b = cfg11_problem(nx)
    comm = pt.DeviceComm()
    out, launches_path = {}, {}
    for prec in ("bf16", "f32"):
        for fused in (False, True):
            rk = refined_mg(comm, A, prec, nx, fused)
            rk.solve(b)                     # set-up, capture
            torch.cuda.synchronize()
            st.reset_launches()
            t0 = time.perf_counter()
            x, res = rk.solve(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_launches()
            got_bf16 = read_vcycle_bf16_launches()
            rel = true_relres(A, x, b)
            label = (f"refine {nx}^3 {prec} cg+mg "
                     f"{'fused' if fused else 'host loop'}")
            if fused:
                chunks = res.replays - 1 - res.megasolve_steps
                cycles = (chunks * ms.MEGASOLVE_CHUNK + 1
                          + res.megasolve_steps)
                # the same program uncaptured: the replayed kernels (rows
                # 3b-6b at bf16) must give the eager run's iterate
                prog = ms.build_megasolve_program(
                    comm, "cg", rk.get_pc(), rk._inner_op,
                    rk._outer_operator())
                prog.capture = False
                t_e = time.perf_counter()
                x_eager, res_e = rk.solve(b)
                torch.cuda.synchronize()
                t_e = time.perf_counter() - t_e
                prog.capture = True
                same = bool(np.array_equal(x_eager, x))
                check(res.graph and not res_e.graph
                      and res_e.replays == res.replays,
                      f"{label}: the check runs did not run captured then "
                      f"uncaptured ({res.graph}, {res_e.graph})")
                check(same and res_e.iterations == res.iterations,
                      f"{label}: captured and uncaptured differ")
                extra = (f", {res.replays} replays, {res.host_syncs} host "
                         f"reads, {res.masked_steps} masked steps, graph "
                         f"{res.graph}, captured == uncaptured {same} (the "
                         f"uncaptured run {t_e:.2f} s)")
            else:
                cycles = res.iterations + rk.refine_steps
                extra = ""
            want = vcycle_launches(nx, cycles, prec == "bf16")
            seen = (got_bf16 if prec == "bf16"
                    else {kk: got[kk] for kk in want})
            if prec == "bf16":
                ok = all(seen[BF16_VCYCLE[kk]] == v
                         for kk, v in want.items())
                check(got["mg3d_residual_restrict"] == 0,
                      f"{label}: residual_restrict launched at bf16")
            else:
                ok = all(got[k] == v for k, v in want.items())
                check(not any(got_bf16.values()),
                      f"{label}: bf16 kernels launched at f32")
            log(f"{label}: reason {res.reason}, {rk.refine_steps} steps, "
                f"{res.iterations} inner iterations, fp64 relres {rel:.3e}, "
                f"warm wall {wall:.3f} s{extra}; V-cycle launches {seen} "
                f"against {cycles} cycles x per-cycle formula {want}: {ok}")
            check(ok, f"{label}: V-cycle launches off the formula")
            check(res.converged and rel <= 1.05 * REFINE_RTOL,
                  f"{label}: {res}, relres {rel}")
            out[f"{prec} {'fused' if fused else 'host'}"] = {
                "reason": res.reason, "steps": rk.refine_steps,
                "inner_iterations": res.iterations, "relres": rel,
                "warm_wall_s": wall, "host_reads": res.host_syncs,
                "replays": getattr(res, "replays", None),
                "masked_steps": getattr(res, "masked_steps", None),
                "launches": seen}
            if prec == "bf16" and not fused:
                launches_path = dict(got_bf16)
            del rk
            ms.clear_cache()
            torch.cuda.empty_cache()
    return launches_path, out


def phase_cfg13(nx=128):
    """cfg13 of ``benchmarks/run_all.py`` (:1387) at 128^3: RefinedKSP CG +
    Jacobi on the assembled operator (the fp64 outer Mat assembled from the
    host CSR), inner bf16 and f32, rtol 1e-10, fused against the host loop.
    Per run: steps, iterations, reason, fp64 relres; cold wall (the fused
    program built and captured) and warm wall (best of 3); host reads,
    replays, masked steps; the fused run's iterate equals an uncaptured
    run's bit for bit. f32 reaches 1e-10 both ways; bf16 (conditioning
    limited at 128^3) agrees fused and unfused, as cfg13's gate says."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    A = pt.poisson3d_csr(nx).astype(np.float64).tocsr()
    x_true = np.random.default_rng(0).random(A.shape[0])
    b = A @ x_true
    comm = pt.DeviceComm()
    out = {}
    for prec in ("bf16", "f32"):
        row = {}
        for fused in (False, True):
            rk = refined(comm, A, prec)
            rk.megasolve = fused
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, res = rk.solve(b)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            warm = []
            for _ in range(3):
                t0 = time.perf_counter()
                x, res = rk.solve(b)
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
            rel = true_relres(A, x, b)
            r = {"reason": res.reason, "steps": rk.refine_steps,
                 "iterations": res.iterations, "relres": rel,
                 "cold_wall_s": cold, "warm_wall_s": min(warm),
                 "host_reads": res.host_syncs}
            extra = ""
            if fused:
                prog = ms.build_megasolve_program(
                    comm, "cg", rk.get_pc(), rk._inner_op,
                    rk._outer_operator())
                prog.capture = False
                t0 = time.perf_counter()
                x_eager, res_e = rk.solve(b)
                torch.cuda.synchronize()
                eager_wall = time.perf_counter() - t0
                prog.capture = True
                same = bool(np.array_equal(x_eager, x))
                r.update(replays=res.replays, masked_steps=res.masked_steps,
                         graph=res.graph, uncaptured_wall_s=eager_wall,
                         captured_equals_uncaptured=same)
                extra = (f", {res.replays} replays, {res.masked_steps} "
                         f"masked steps, graph {res.graph}; uncaptured "
                         f"{eager_wall:.3f} s, bit-equal {same}")
                check(res.graph and not res_e.graph
                      and res_e.replays == res.replays,
                      f"cfg13 {prec}: the check runs did not run captured "
                      f"then uncaptured ({res.graph}, {res_e.graph})")
                check(same and res_e.iterations == res.iterations,
                      f"cfg13 {prec}: captured and uncaptured differ")
            log(f"cfg13 {nx}^3 {prec} cg+jacobi "
                f"{'fused' if fused else 'host loop'}: reason {res.reason}, "
                f"{rk.refine_steps} steps, {res.iterations} inner "
                f"iterations, fp64 relres {rel:.3e}, cold {cold:.3f} s, warm "
                f"{min(warm):.3f} s, {res.host_syncs} host reads{extra}")
            row["fused" if fused else "host"] = r
            del rk
            ms.clear_cache()
            torch.cuda.empty_cache()
        h, f = row["host"], row["fused"]
        if prec == "f32":
            check(h["relres"] <= 1.05 * REFINE_RTOL
                  and f["relres"] <= 1.05 * REFINE_RTOL,
                  f"cfg13 f32 missed rtol: {row}")
        else:
            check(h["reason"] == f["reason"]
                  and abs(h["steps"] - f["steps"]) <= 1,
                  f"cfg13 bf16 fused and unfused disagree: {row}")
        out[prec] = row
    return out


def phase_ksp_megasolve(nx=128, k=K_BATCH):
    """``KSP -ksp_megasolve`` at 128^3 f32, rtol 1e-6 (bench.py's problem):
    cg + jacobi on the stencil fast path, cg + mg, pipecg, sstep s = 4 and
    a k = 8 block of cg + jacobi, fused against unfused in one call (pipecg
    and sstep at max_it 400: unguarded f32 pipecg does not reach 1e-6 here,
    as in the JAX package, and is reported, not required to): warm
    ms/iter (best of 3), replays, host reads, masked steps, the stencil
    kernels' launches a solve (counters zeroed just before, read just
    after; a replay adds its captured launches), the captured iterate
    against an uncaptured run's bit for bit, and the device idle share of
    a profiled fused and unfused solve of cg + jacobi."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    rng = np.random.default_rng(5)
    B = np.stack([b] + [op.mult(pt.Vec.from_global(
        comm, rng.random(nx ** 3).astype(np.float32))).to_numpy()
        for _ in range(k - 1)], axis=1)
    out = {}
    for label, ksp_type, pc, attrs, many in (
            ("cg+jacobi fast path", "cg", "jacobi",
             {"megasolve_stencil_fastpath": True}, False),
            ("cg+mg", "cg", "mg", {}, False),
            ("pipecg+jacobi", "pipecg", "jacobi", {"max_it": 400}, False),
            ("sstep4+jacobi", "sstep", "jacobi",
             {"sstep_s": 4, "max_it": 400}, False),
            (f"cg+jacobi k={k}", "cg", "jacobi",
             {"megasolve_stencil_fastpath": True}, True)):
        row = {}
        for fused in (False, True):
            ksp = ksp_solver(comm, op, ksp_type, pc=pc, megasolve=fused,
                             **attrs)
            x, _ = op.get_vecs()
            X = np.zeros_like(B)

            def run():
                if many:
                    return ksp.solve_many(B, X)
                x.zero()
                return ksp.solve(bv, x)
            run()                           # set-up, capture
            torch.cuda.synchronize()
            st.reset_launches()
            res = run()
            torch.cuda.synchronize()
            launches = {kk: v for kk, v in read_launches().items() if v}
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            its = max(res.iterations) if many else res.iterations
            reasons = res.reasons if many else [res.reason]
            r = {"iterations": res.iterations, "reasons": reasons,
                 "ms_per_iter": min(walls) / max(its, 1) * 1e3,
                 "wall_s": min(walls), "host_reads": res.host_syncs,
                 "launches": launches}
            extra = ""
            if fused:
                prog = ksp._megasolve_program(many_k=k if many else None)
                x_graph = (X.copy() if many else x.to_numpy())
                prog.capture = False
                res_e = run()
                torch.cuda.synchronize()
                prog.capture = True
                x_eager = X.copy() if many else x.to_numpy()
                same = bool(np.array_equal(x_graph, x_eager))
                r.update(replays=res.replays, masked_steps=res.masked_steps,
                         steps=res.megasolve_steps, graph=res.graph,
                         captured_equals_uncaptured=same)
                extra = (f", {res.megasolve_steps} steps, {res.replays} "
                         f"replays, {res.masked_steps} masked steps, graph "
                         f"{res.graph}, captured == uncaptured {same}")
                check(res.graph and not res_e.graph
                      and res_e.replays == res.replays,
                      f"{label}: the check runs did not run captured then "
                      f"uncaptured ({res.graph}, {res_e.graph})")
                check(same and res_e.iterations == res.iterations,
                      f"{label}: captured run differs from uncaptured")
            log(f"megasolve {nx}^3 f32 {label} "
                f"{'fused' if fused else 'unfused'}: {res.iterations} "
                f"iterations, {reasons}, {r['ms_per_iter']:.4f} ms/iter "
                f"(warm best of 3), {res.host_syncs} host reads, launches "
                f"{launches}{extra}")
            check(ksp_type == "pipecg" or all(rr > 0 for rr in reasons),
                  f"{label}: {reasons}")
            if label.startswith("cg+jacobi fast") and not many:
                r["idle_share"] = profile_solve(
                    lambda: run().iterations,
                    f"128^3 f32 cg+jacobi {'fused' if fused else 'unfused'}")
            row["fused" if fused else "unfused"] = r
            del ksp
            ms.clear_cache()
            torch.cuda.empty_cache()
        out[label] = row
    return out


def phase_autoselect_local():
    """``-ksp_reduction_auto`` on ``DeviceComm(1)`` and ``DeviceComm(4)``
    at 128^3 f32 CG + Jacobi: the measured psum and apply latencies, the
    ranking and the choice (the probe refreshed: this run's numbers)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.solvers import autoselect
    out = {}
    for shards in (1, 4):
        comm = pt.DeviceComm(shards)
        op, _ = make_problem(comm, 128, torch.float32)
        pc = pt.PC(comm).set_type("jacobi")
        pc.set_operators(op)
        rep = autoselect.select_reduction_plan(comm, op, pc, refresh=True)
        out[f"DeviceComm({shards})"] = rep.as_dict()
        log(f"autoselect DeviceComm({shards}) 128^3 f32 cg+jacobi: psum "
            f"{rep.psum_us:.2f} us, apply {rep.apply_us:.2f} us, choice "
            f"{rep.ksp_type} s={rep.s}; ranking " + ", ".join(
                f"{r['ksp_type']}{r['s'] or ''} {r['model_cost_us']:.1f} us"
                for r in rep.ranking))
    return out


def megasolve_procs_cases(nx=128):
    """The parity cases of the fused program on a process communicator at
    nx^3 f32: CG + Jacobi on the fast path, pipecg, sstep s = 4 and an f32
    refinement with PC mg; and the ``-ksp_reduction_auto`` case, whose
    choice's solve is reported (where pipecg or sstep s = 8 wins, which
    the card's load on the measured latencies decides, the f32 solve stops
    at max_it here, as in the JAX package)."""
    base = dict(kind="cg", grid=[nx] * 3, pc="jacobi", dtype="f32",
                rtol=1e-6, megasolve=True, keep_x=True)
    cases = [dict(base, name="fused_cg", fastpath=True),
             dict(base, name="fused_pipecg", ksp="pipecg", max_it=400),
             dict(base, name="fused_sstep4", ksp="sstep", sstep_s=4,
                  max_it=400),
             dict(kind="refine", name="fused_refine_mg", grid=[nx] * 3,
                  prec="f32", pc="mg", megasolve=True)]
    auto = dict(base, name="auto", megasolve=False, reduction_auto=True,
                max_it=400)
    return cases, auto


def megasolve_procs_check(label, got, ref, cases, auto, captured):
    """Each fused case bit-equal to the virtual mesh's, with its steps and
    replays, CUDA graphs where ``captured``; the autoselect case's
    latencies, ranking and choice. Returns the rows."""
    rows = {}
    for c in cases:
        g, r = got[c["name"]], ref[c["name"]]
        procs_compare(f"megasolve {label} {c['name']}", g, r,
                      converged=c["name"] != "fused_pipecg")
        graph = bool(g["graph"])
        check(graph == captured, f"{label} {c['name']}: graph {graph}")
        check(int(g["steps"]) == int(r["steps"])
              and int(g["replays"]) == int(r["replays"]),
              f"{label} {c['name']}: steps/replays differ")
        rows[c["name"]] = {"its": int(np.atleast_1d(g["its"]).max()),
                           "steps": int(g["steps"]),
                           "replays": int(g["replays"]), "graph": graph,
                           "wall_s": float(g["wall_s"])}
        log(f"megasolve {label} {c['name']}: {rows[c['name']]['its']} "
            f"iterations, {int(g['steps'])} steps, {int(g['replays'])} "
            f"replays, graph {graph}, wall {float(g['wall_s']):.3f} s; "
            f"bit-equal to the virtual mesh")
    a = got[auto["name"]]
    row = {"psum_us": float(a["psum_us"]), "apply_us": float(a["apply_us"]),
           "choice": str(a["auto_type"]), "s": int(a["auto_s"]),
           "ranking": json.loads(str(a["ranking"])),
           "its": int(np.atleast_1d(a["its"])[0]),
           "reason": int(np.atleast_1d(a["reason"])[0])}
    log(f"autoselect {label} 128^3 f32 cg+jacobi: psum {row['psum_us']:.2f} "
        f"us, apply {row['apply_us']:.2f} us, choice {row['choice']} "
        f"s={row['s']} ({row['its']} iterations, reason {row['reason']}); "
        "ranking " + ", ".join(f"{r['ksp_type']}{r['s'] or ''} "
                               f"{r['model_cost_us']:.1f} us"
                               for r in row["ranking"]))
    # the choice follows from the agreed latencies; the plan it names may be
    # one that unguarded f32 does not take to 1e-6 on this problem (pipecg,
    # sstep s = 8, as in the JAX package), which then stops at max_it
    from mpi_petsc4py_example_tpu_torch.solvers import autoselect
    best = autoselect.choose(row["ranking"], 0.25)
    check(best["ksp_type"] == row["choice"]
          and int(best.get("s", 0) or 0) == row["s"],
          f"{label} reduction_auto choice {best} against the ranking: {row}")
    if (row["choice"], row["s"]) in (("pipecg", 0), ("sstep", 8)):
        check(row["reason"] > 0 or (row["reason"] == -3
                                    and row["its"] == auto["max_it"]),
              f"{label} reduction_auto solve: {row}")
    else:
        check(row["reason"] > 0, f"{label} reduction_auto solve: {row}")
    rows["autoselect"] = row
    return rows


def phase_megasolve_procs(nx=128):
    """The fused program and ``-ksp_reduction_auto`` on the process
    communicator (``megasolve_procs_cases``): NCCL 1 x 4 (captured) and gloo
    2 x 2 (uncaptured), each bit-equal to ``DeviceComm(4)``; then the
    reduction probe and choice on both."""
    cases, auto = megasolve_procs_cases(nx)
    out = {}
    ref = procs_reference(cases, 4)
    for label, nprocs, local, backend in (("nccl 1x4", 1, 4, "nccl"),
                                          ("gloo 2x2", 2, 2, "gloo")):
        got, wall = parity_launch(
            nprocs, [dict(c, local_shards=local) for c in cases + [auto]],
            backend)
        out[label] = megasolve_procs_check(label, got, ref, cases, auto,
                                           backend == "nccl")
        out[label]["launch_wall_s"] = wall
    return out


NCCL_CAPTURE_DRIVER = """\
import faulthandler
import functools
import gc
import sys
import time

import numpy as np
import torch
from mpi4py import MPI

import mpi_petsc4py_example_tpu_torch as pt

mode, stage_s, release = sys.argv[1], float(sys.argv[2]), sys.argv[3] == "1"
if mode != "global":
    torch.cuda.graph = functools.partial(torch.cuda.graph,
                                         capture_error_mode=mode)
comm = pt.ProcessComm(1, MPI.COMM_WORLD.device_comm.device)
rank, P = comm.rank, comm.nprocs


def stage(name, fn):
    faulthandler.dump_traceback_later(stage_s, exit=True)
    t0 = time.perf_counter()
    ok = bool(fn())
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    print(f"rank {rank} stage {name}: {'ok' if ok else 'WRONG'} "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not ok:
        sys.exit(3)


def graph_of(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    for _ in range(3):
        g.replay()
    return out


v = torch.full((1,), float(rank + 1), device=comm.device)
want = float(P * (P + 1) // 2)
stage("eager psum", lambda: float(comm.psum([v[0]])) == want)
stage("captured psum", lambda: float(graph_of(
    lambda: comm.psum([v[0]]))) == want)
x = torch.full((1, 4), float(rank), device=comm.device)
stage("captured shift", lambda: float(graph_of(
    lambda: comm.shift(x, 1))[0, 0]) == float((rank - 1) % P))


def fused():
    op = pt.StencilPoisson3D(comm, 32, dtype=torch.float32)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=1e-4, max_it=500)
    ksp.megasolve = ksp.megasolve_stencil_fastpath = True
    ksp.set_up()
    ksp._megasolve_program().capture = True   # off across processes
    xv, bv = op.get_vecs()
    bv.set_global(np.ones(op.shape[0], dtype=np.float32))
    res = ksp.solve(bv, xv)
    return res.graph and res.converged


stage("fused cg captured", fused)
if release:
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve

    def drop():
        megasolve.clear_cache()
        gc.collect()
        return True
    stage("graphs released", drop)
# the runner's teardown (destroy_process_group, the interpreter's exit):
# one that does not end in stage_s seconds dumps its stack
faulthandler.dump_traceback_later(stage_s, exit=True)
"""


def phase_nccl_capture(modes=("global", "thread_local"), release=False,
                       stage_s=30):
    """``--nccl-capture``, on a host of several cards: whether CUDA graphs
    capture the process communicator's collectives over NCCL, one rank per
    card, stage by stage: an eager psum, a captured psum (all-gather and
    fold), a captured ring shift (``batch_isend_irecv``), and a 32^3 fused
    CG captured across the processes (which the port does not do); with
    ``release`` the graphs are then dropped (the program cache cleared).
    A stage, or the rank's teardown after the last, that does not end in
    ``stage_s`` seconds dumps every thread's stack and ends its rank. Runs
    each capture error mode of ``modes`` in turn until one ends cleanly,
    and logs each run's stage lines and the end of its standard error.
    A diagnosis: it reports and checks nothing."""
    import signal
    import tempfile
    import torch
    cards = torch.cuda.device_count()
    check(cards >= 2, f"--nccl-capture needs 2 cards or more, found {cards}")
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"card": card_line(), "cards": cards}
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "nccl_capture.py")
        with open(script, "w") as f:
            f.write(NCCL_CAPTURE_DRIVER)
        for mode in modes:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run",
                 "-n", str(cards), "--procs", "--backend", "nccl", script,
                 mode, str(stage_s), "1" if release else "0"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=root, start_new_session=True,
                env=dict(os.environ, NCCL_DEBUG="WARN"))
            try:
                so, se = proc.communicate(timeout=4 * stage_s + 60)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                so, se = proc.communicate()
                rc = "killed"
            stages = [ln for ln in so.splitlines() if " stage " in ln]
            out[mode] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                         "stages": stages}
            log(f"nccl capture, mode {mode}: rc {rc}, "
                f"{time.perf_counter() - t0:.1f} s; " + "; ".join(stages))
            for ln in se.splitlines()[-40:]:
                log(f"  {mode} stderr: {ln}")
            if rc == 0:
                break
    return out


COMPLEX_THETA = 0.3       # the x-bond phase of the Hermitian Laplacians
COMPLEX_NX = 1024         # Helmholtz 2D, 1,048,576 unknowns
COMPLEX_LAP_NX = 128      # the 3D phase Laplacian, 2,097,152 rows
COMPLEX_CR_N = 1 << 20    # the 1D phase Laplacian for cyclic reduction


def phase_laplacian(A, theta=COMPLEX_THETA):
    """``A`` (a Dirichlet Laplacian, x-fastest) with every x-bond given the
    phase ``e^{i theta}``: ``-e^{i theta}`` on the first superdiagonal,
    ``-e^{-i theta}`` on the first subdiagonal. A diagonal unitary gauge
    makes it similar to ``A``: the same spectrum, Hermitian, genuinely
    complex."""
    import scipy.sparse as sp
    C = A.tocoo().astype(np.complex128)
    d = C.col - C.row
    C.data[d == 1] *= np.exp(1j * theta)
    C.data[d == -1] *= np.exp(-1j * theta)
    return sp.csr_matrix(C)


def complex_case(label, ksp, bv, x, A, b, twin=None, x_true=None,
                 twin_rtol=None, profile=0):
    """Solve twice (the second warm and timed), then the real twin (the same
    sparsity in the real dtype of the same width, with ``rtol`` 0 and the
    complex solve's iteration count, or ``twin_rtol``, warm) for its
    ms/iteration; with ``profile`` a profiled solve of that many
    iterations of each (the complex solver is left at that count). Returns the
    case's record: iterations, reason, fp64 true relres, warm wall,
    ms/iteration, host syncs, the twin's ms/iteration and the ratio, with
    the timed solve's iterate on the host."""
    import torch
    t_case = time.perf_counter()
    x.zero()
    ksp.solve(bv, x)
    torch.cuda.synchronize()
    x.zero()
    t0 = time.perf_counter()
    res = ksp.solve(bv, x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xh = x.to_numpy()
    its = max(res.iterations, 1)
    rec = {"iterations": res.iterations, "reason": int(res.reason),
           "relres": float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b)),
           "wall_s": wall, "ms_per_iter": wall / its * 1e3,
           "host_syncs": res.host_syncs}
    if x_true is not None:
        rec["allclose"] = bool(np.allclose(xh, x_true, atol=1e-6))
    if twin is not None:
        tksp, tbv, tx = twin
        if twin_rtol is None:
            tksp.set_tolerances(rtol=0.0, atol=0.0, max_it=res.iterations)
        else:
            tksp.set_tolerances(rtol=twin_rtol, atol=0.0)
        for _ in range(2):
            tx.zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tres = tksp.solve(tbv, tx)
            torch.cuda.synchronize()
        twall = time.perf_counter() - t0
        rec.update(twin_iterations=tres.iterations,
                   twin_ms_per_iter=twall / max(tres.iterations, 1) * 1e3,
                   twin_dtype=str(tx.dtype).removeprefix("torch."))
        rec["ratio"] = rec["ms_per_iter"] / rec["twin_ms_per_iter"]
    if profile:
        # a short window of ``profile`` iterations each: the profiler's
        # post-processing grows with the events it recorded
        for name, (k, bb, xx) in (("complex", (ksp, bv, x)),
                                  ("twin", twin or (ksp, bv, x))):
            k.set_tolerances(rtol=0.0, atol=0.0, max_it=profile)

            def run(k=k, bb=bb, xx=xx):
                xx.zero()
                return k.solve(bb, xx).iterations
            rec[f"idle_share_{name}"] = profile_solve(
                run, f"{label}, {name}, {profile} iterations")
    log(f"complex {label}: {res.iterations} iterations, reason "
        f"{rec['reason']}, fp64 true relres {rec['relres']:.3e}, warm wall "
        f"{wall:.4f} s, {rec['ms_per_iter']:.4f} ms/iter, {res.host_syncs} "
        f"host syncs"
        + (f", allclose(x, x_true, atol=1e-6) {rec['allclose']}"
           if x_true is not None else "")
        + (f"; {rec['twin_dtype']} twin {rec['twin_ms_per_iter']:.4f} "
           f"ms/iter over {rec['twin_iterations']} iterations, ratio "
           f"{rec['ratio']:.3f}" if twin is not None else "")
        + f"; case {time.perf_counter() - t_case:.1f} s; {card_line()}")
    return rec, xh


def device_busy_ms(fn, calls=5):
    """The device time of one ``fn()`` call: the kernels' and copies' self
    time under ``torch.profiler`` over ``calls`` calls, divided by
    ``calls`` (no host launch cost in it); None when the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else None


def phase_complex():
    """Complex scalars on the card (``--complex``; no kernel on this path:
    the JAX package's complex operators never reach ``pl.pallas_call``, so
    the products are the port's torch ELL/DIA routes and the PC applies):

    * the Helmholtz driver's operator ``-Delta_h - (1.5 + 0.5i) I`` at nx =
      1024 (1,048,576 unknowns, DIA), complex128 GMRES(30) + Jacobi at rtol
      1e-10 (the example's ``allclose`` check and the fp64 true relres <=
      10 rtol), BiCGStab + Jacobi on it, and complex64 GMRES at rtol 1e-5
      (fp64 true relres <= 10 rtol, which meets bench.py's parity rule);
    * the 128^3 7-point Laplacian with its x-bonds phased by ``e^{0.3i}``
      (Hermitian, similar to the real one), through ``Mat.from_scipy``
      (DIA, complex128): CG + Jacobi at rtol 1e-6 unfused and with
      ``-ksp_megasolve`` (iterations and reasons equal, the captured iterate
      bit-equal to an uncaptured run), a profile of each, and Krylov-Schur
      (largest magnitude, nev 1, ncv 16, tol 1e-8) against the closed form
      6 + 6 cos(pi/129) within 1e-9, ``compute_error`` <= 1e-6;
    * the 1D phase Laplacian plus 0.5 at 2^20 rows, preonly + cholesky on the
      crtri route, fp64 true relres <= 1e-10, the apply against its bytes
      bound;

    each beside its real twin (the same sparsity, float64 for complex128 and
    float32 for complex64) in this call. The stencil kernels' counters must
    not move: nothing complex reaches them."""
    import scipy.sparse as sp
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.facade.drivers import helmholtz
    from mpi_petsc4py_example_tpu_torch.models.poisson import poisson3d_csr
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    from mpi_petsc4py_example_tpu_torch.solvers import krylov
    t_all = time.perf_counter()
    comm = pt.DeviceComm()
    out = {"card": card_line()}
    # the real path is unchanged: on real tensors on the card torch.vdot is
    # torch.dot bit for bit, and so the program's shard-summed dot
    g = torch.Generator(device="cuda").manual_seed(17)
    comm4 = pt.DeviceComm(4)
    for dt in (torch.float32, torch.float64):
        u, v = (torch.rand(4, COMPLEX_LAP_NX ** 3 // 4, generator=g,
                           device="cuda", dtype=dt) for _ in range(2))
        pdot = krylov.shard_dots(comm4, lambda t: t)[0]
        same = (torch.equal(torch.vdot(u[0], v[0]), torch.dot(u[0], v[0]))
                and torch.equal(pdot(u, v), u[0].dot(v[0]) + u[1].dot(v[1])
                                + u[2].dot(v[2]) + u[3].dot(v[3])))
        check(same, f"vdot differs from dot on real {dt} tensors")
    log(f"complex: on real float32/float64 tensors of {COMPLEX_LAP_NX}^3 "
        "torch.vdot == torch.dot and the 4-shard pdot == the torch.dot sum, "
        "bit for bit")
    reset_launches()

    def solver(mat, ksp_type, pc_type, rtol, max_it=5000, mega=False):
        ksp = aij_ksp(comm, mat, ksp_type, pc_type, rtol, max_it=max_it)
        ksp.megasolve = mega
        return ksp

    # ---- Helmholtz 2D, nx = 1024 --------------------------------------------
    t0 = time.perf_counter()
    A = helmholtz.helmholtz2d(COMPLEX_NX)
    x_true, b = helmholtz.manufactured(A)
    M, asm_s = assemble(comm, A, torch.complex128)
    # the float64 twin: the same five diagonals, the definite Laplacian
    # + 1.5 I (no breakdown when it runs to a fixed iteration count)
    Ar = (A.real + 3.0 * sp.eye(A.shape[0])).tocsr()
    Mr, _ = assemble(comm, Ar, torch.float64)
    check(M.spmv_route(comm) != "ell", "Helmholtz: not on a DIA route")
    x, bv = M.get_vecs()
    bv.set_global(b)
    xr, bvr = Mr.get_vecs()
    bvr.set_global(Ar @ np.random.default_rng(42).random(A.shape[0]))
    log(f"complex Helmholtz {COMPLEX_NX}^2: assembled in {asm_s:.2f} s "
        f"(complex128, {M.spmv_route(comm)}, {len(M.dia_offsets)} "
        f"diagonals), with its float64 twin in "
        f"{time.perf_counter() - t0:.2f} s")
    for ksp_type in ("gmres", "bcgs"):
        rec, _ = complex_case(
            f"Helmholtz {COMPLEX_NX}^2 complex128 {ksp_type}+jacobi rtol "
            "1e-10", solver(M, ksp_type, "jacobi", 1e-10), bv, x, A, b,
            twin=(solver(Mr, ksp_type, "jacobi", 0.0), bvr, xr),
            x_true=x_true, profile=30)
        check(rec["reason"] > 0 and rec["allclose"]
              and rec["relres"] <= 1e-9,
              f"Helmholtz {ksp_type}: {rec}")
        out[f"helmholtz_{ksp_type}"] = rec
    M64 = M.astype(torch.complex64)
    Mr32 = Mr.astype(torch.float32)
    x64, bv64 = M64.get_vecs()
    bv64.set_global(b)
    xr32, bvr32 = Mr32.get_vecs()
    bvr32.set_global(bvr.to_numpy())
    rec, _ = complex_case(
        f"Helmholtz {COMPLEX_NX}^2 complex64 gmres+jacobi rtol 1e-5",
        solver(M64, "gmres", "jacobi", 1e-5), bv64, x64, A, b,
        twin=(solver(Mr32, "gmres", "jacobi", 0.0), bvr32, xr32))
    check(rec["reason"] > 0 and rec["relres"] <= 10 * 1e-5,
          f"Helmholtz complex64: {rec}")
    out["helmholtz_gmres_c64"] = rec
    del M, Mr, M64, Mr32, x, bv, xr, bvr, x64, bv64, xr32, bvr32
    torch.cuda.empty_cache()
    out["helmholtz_s"] = time.perf_counter() - t0

    # ---- the 128^3 phase Laplacian ---------------------------------------
    t0 = time.perf_counter()
    L = poisson3d_csr(COMPLEX_LAP_NX)
    A = phase_laplacian(L)
    M, asm_s = assemble(comm, A, torch.complex128)
    Mr, _ = assemble(comm, L, torch.float64)
    check(M.dia_offsets and len(M.dia_offsets) == 7,
          f"phase Laplacian: DIA offsets {M.dia_offsets}")
    rng = np.random.default_rng(7)
    xt = rng.random(A.shape[0]) + 1j * rng.random(A.shape[0])
    b = A @ xt
    x, bv = M.get_vecs()
    bv.set_global(b)
    xr, bvr = Mr.get_vecs()
    bvr.set_global(L @ xt.real)
    log(f"complex phase Laplacian {COMPLEX_LAP_NX}^3: assembled in "
        f"{asm_s:.2f} s (complex128, {M.spmv_route(comm)}, offsets "
        f"{M.dia_offsets})")
    log(f"complex phase Laplacian: set up in {time.perf_counter() - t0:.1f} "
        "s")
    unf = solver(M, "cg", "jacobi", 1e-6)
    rec_u, x_unf = complex_case(
        f"phase Laplacian {COMPLEX_LAP_NX}^3 complex128 cg+jacobi unfused",
        unf, bv, x, A, b, twin=(solver(Mr, "cg", "jacobi", 0.0), bvr, xr),
        profile=30)
    fused = solver(M, "cg", "jacobi", 1e-6, mega=True)
    rec_f, x_graph = complex_case(
        f"phase Laplacian {COMPLEX_LAP_NX}^3 complex128 cg+jacobi "
        "-ksp_megasolve", fused, bv, x, A, b,
        twin=(solver(Mr, "cg", "jacobi", 1e-6, mega=True), bvr, xr),
        twin_rtol=1e-6)
    graph = fused.result.graph
    prog = fused._megasolve_program()
    prog.capture = False
    x.zero()
    res_e = fused.solve(bv, x)
    torch.cuda.synchronize()
    prog.capture = True
    same = bool(np.array_equal(x_graph, x.to_numpy()))
    check(graph and not res_e.graph,
          "phase Laplacian: the fused runs were not captured, then "
          "uncaptured")
    check(rec_u["reason"] > 0 and rec_u["iterations"] == rec_f["iterations"]
          and rec_u["reason"] == rec_f["reason"] and same
          and res_e.iterations == rec_f["iterations"],
          f"phase Laplacian: unfused {rec_u}, fused {rec_f}, captured == "
          f"uncaptured {same}")
    rec_f.update(captured_equals_uncaptured=same,
                 fused_vs_unfused_max_diff=float(np.abs(x_graph
                                                        - x_unf).max()))
    log(f"complex phase Laplacian: fused iterations = unfused "
        f"({rec_f['iterations']}), captured iterate == uncaptured {same}, "
        f"fused vs unfused max diff {rec_f['fused_vs_unfused_max_diff']:.3e}")
    log(f"complex phase Laplacian: CG done at {time.perf_counter() - t0:.1f} "
        "s")
    out["laplacian_cg_unfused"] = rec_u
    out["laplacian_cg_fused"] = rec_f
    del unf, fused, prog
    ms.clear_cache()
    # Krylov-Schur, largest magnitude, against the closed form
    lam_exact = 6.0 + 6.0 * np.cos(np.pi / (COMPLEX_LAP_NX + 1))
    eps_rec = {}
    for label, mat in (("complex128", M), ("float64 twin", Mr)):
        E = pt.EPS().create(comm)
        E.set_operators(mat)
        E.set_problem_type("hep")
        E.set_dimensions(nev=1, ncv=16)
        E.set_tolerances(tol=1e-8, max_it=EPS_MAX_IT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        E.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        lam = E.get_eigenvalue(0)
        restarts = E.get_iteration_number()
        r = {"restarts": restarts, "nconv": E.get_converged(),
             "lambda": [lam.real, lam.imag],
             "rel_err": abs(lam - lam_exact) / lam_exact,
             "compute_error": E.compute_error(0), "wall_s": wall,
             "ms_per_restart": wall / max(restarts, 1) * 1e3}
        log(f"complex EPS {COMPLEX_LAP_NX}^3 phase Laplacian {label}: "
            f"{restarts} restarts, nconv {r['nconv']}, lambda {lam}, rel err "
            f"{r['rel_err']:.3e} vs 6 + 6 cos(pi/129), compute_error "
            f"{r['compute_error']:.3e}, {wall:.3f} s, "
            f"{r['ms_per_restart']:.3f} ms/restart; {card_line()}")
        check(r["nconv"] >= 1 and r["rel_err"] <= 1e-9
              and r["compute_error"] <= 1e-6, f"EPS {label}: {r}")
        eps_rec[label.split()[0]] = r
    eps_rec["ratio"] = (eps_rec["complex128"]["ms_per_restart"]
                        / eps_rec["float64"]["ms_per_restart"])
    out["laplacian_eps"] = eps_rec
    del M, Mr, x, bv, xr, bvr, E
    torch.cuda.empty_cache()
    out["laplacian_s"] = time.perf_counter() - t0

    # ---- cyclic reduction, 2^20 rows ----------------------------------------
    t0 = time.perf_counter()
    n = COMPLEX_CR_N
    L1 = (laplace1d(n) + 0.5 * sp.eye(n)).tocsr()
    A = phase_laplacian(L1)
    cr = {}
    for label, mat_A, dt in (("complex128", A, torch.complex128),
                             ("float64 twin", L1, torch.float64)):
        m, _ = assemble(comm, mat_A, dt)
        ksp = aij_ksp(comm, m, "preonly", "cholesky", 1e-10)
        t1 = time.perf_counter()
        ksp.set_up()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t1
        rng = np.random.default_rng(11)
        xt = rng.random(n) + (1j * rng.random(n) if dt.is_complex else 0.0)
        b = mat_A @ xt
        x, bv = m.get_vecs()
        bv.set_global(b)
        ksp.solve(bv, x)
        res = ksp.solve(bv, x)
        pc = ksp.get_pc()
        rel = float(np.linalg.norm(b - mat_A @ x.to_numpy())
                    / np.linalg.norm(b))
        apply = cr_apply_record(pc, comm, n)
        cr_fn = pc.local_apply(comm, n)
        r_in = torch.rand(comm.size, comm.local_size(n), device=comm.device,
                          dtype=dt)
        apply["busy_ms"] = device_busy_ms(lambda: cr_fn(r_in))
        r = {"mode": pc.kind, "setup_s": setup, "relres": rel,
             "solve_ms": res.wall_time * 1e3, "host_syncs": res.host_syncs,
             "apply": apply}
        log(f"complex crtri 2^20 phase Laplacian + 0.5 {label}: mode "
            f"{pc.kind}, set-up {setup:.3f} s, warm solve "
            f"{r['solve_ms']:.2f} ms, {res.host_syncs} host syncs, fp64 true "
            f"relres {rel:.3e}; apply {apply['ms']:.4f} ms (device busy "
            f"{apply['busy_ms']} ms, profiler) vs bound "
            f"{apply['bound_ms']:.4f} ms, {apply['operations']} torch "
            f"operations; {card_line()}")
        check(pc.kind == "crtri" and rel <= 1e-10, f"crtri {label}: {r}")
        cr[label.split()[0]] = r
        del m, ksp, x, bv, pc
        torch.cuda.empty_cache()
    c_apply, r_apply = cr["complex128"]["apply"], cr["float64"]["apply"]
    cr["ratio"] = c_apply["ms"] / r_apply["ms"]
    if c_apply["busy_ms"] and r_apply["busy_ms"]:
        cr["busy_ratio"] = c_apply["busy_ms"] / r_apply["busy_ms"]
    out["crtri"] = cr
    out["crtri_s"] = time.perf_counter() - t0
    launched = {k: v for k, v in read_launches().items() if v}
    check(not launched, f"a stencil kernel ran on the complex path: "
                        f"{launched}")
    out["seconds"] = time.perf_counter() - t_all
    log(f"complex phases: {out['seconds']:.1f} s (Helmholtz "
        f"{out['helmholtz_s']:.1f}, phase Laplacian {out['laplacian_s']:.1f}, "
        f"crtri {out['crtri_s']:.1f})")
    return out


def complex_procs_cases(local_shards, prefix):
    """The complex cases of the process phases: Helmholtz at nx = 128,
    complex128 GMRES(30) + Jacobi, rtol 1e-10."""
    return [dict(kind="aij", name=f"{prefix}_helmholtz128_gmres",
                 op="helmholtz128", dtype="c128", ksp="gmres", pc="jacobi",
                 rtol=1e-10, local_shards=local_shards)]


def complex_procs_check(label, got, refs, cases, card):
    """Each complex case bit for bit against ``DeviceComm(4)``."""
    out = {}
    for c in cases:
        g, r = got[c["name"]], refs[c["name"]]
        its, _ = procs_compare(f"{label} {c['name']}", g, r)
        check(np.iscomplexobj(g["x"]), f"{label}: the iterate is not complex")
        out[c["name"]] = {"iterations": its, "ms_per_iter": ms_per_iter(g),
                          "ms_per_iter_virtual": ms_per_iter(r)}
        log(f"procs {label} {c['name']}: {its} iterations (= DeviceComm(4)), "
            f"x bit-equal, {out[c['name']]['ms_per_iter']:.4f} ms/iter vs "
            f"{out[c['name']]['ms_per_iter_virtual']:.4f} on DeviceComm(4); "
            f"{card}")
    return out


def phase_megasolve(procs=None):
    """Every phase of this slice: rows 3b-6b, PC mg under refinement, cfg13,
    KSP megasolve, the process communicator and the reduction plan
    selection. Returns the kernels' entries and the results. ``procs``: the
    process cases' results where the procs phase's launches carried them
    (the no-argument run), instead of launches of their own."""
    t0 = time.perf_counter()
    worst = phase_vcycle_bf16_checks()
    times = {n: phase_vcycle_bf16_times(n) for n in (128, 512)}
    t1 = time.perf_counter()
    launches, refine = phase_mg_bf16_refine()
    cfg13 = phase_cfg13()
    ksp = phase_ksp_megasolve()
    guarded = timed(phase_guarded_fused)
    guarded["g4"] = timed(phase_guarded_refine)
    t2 = time.perf_counter()
    auto = phase_autoselect_local()
    if procs is None:
        procs = phase_megasolve_procs()
    log(f"megasolve phases: {time.perf_counter() - t0:.1f} s (kernels "
        f"{t1 - t0:.1f} s, solves {t2 - t1:.1f} s, autoselect and procs "
        f"{time.perf_counter() - t2:.1f} s)")
    entries = []
    base = {bf: f32 for f32, bf in BF16_VCYCLE.items()}
    for name in VCYCLE_PASSES:
        big, small = times[512][name], times[128][name]
        entries.append({
            "name": name, "route": "cuda", "source": KERNELS[base[name]][0],
            "replaces": KERNELS[base[name]][1], "launches": launches[name],
            "path": "128^3 RefinedKSP bf16 cg+mg (cfg11's problem), host loop",
            "max_abs_err": max(worst[name], big["max_abs_err"],
                               small["max_abs_err"]),
            "ms": big["ms"], "kernel_ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "shape": [512] * 3, "dtype": "bfloat16", "at_128": small})
        if "two_3b_ms" in big:
            entries[-1]["two_3b_ms"] = big["two_3b_ms"]
    return entries, {"refine_mg": refine, "cfg13": cfg13,
                     "ksp_megasolve": ksp, "guarded": guarded,
                     "autoselect": auto, "procs": procs}


# ---- the fused program's guarded modes (item 6.3) -----------------------------

def all_launches():
    """Every nonzero launch counter, the bf16 instantiations' by their own
    names."""
    out = dict(read_launches())
    out.update(read_bf16_launches())
    out.update(read_vcycle_bf16_launches())
    return {k: v for k, v in out.items() if v}


def fused_guarded_ksp(comm, op, guard=True, fused=True, rtol=KSP_RTOL):
    """CG + Jacobi with ``-ksp_abft`` (``guard``) under ``-ksp_megasolve``
    (``fused``): the fused guarded program takes the general route, row 2
    (``stencil7_apply``; the stencil fast path stays off under the guard)."""
    ksp = ksp_solver(comm, op, "cg", rtol=rtol, megasolve=fused)
    ksp.abft = guard
    return ksp


def phase_guarded_fused(nx=128, k=K_BATCH):
    """(g1)-(g3): 128^3 f32 CG + Jacobi, ``-ksp_megasolve -ksp_abft``. (g1)
    clean: iterations and reason against the unfused guarded solve, the
    ABFT checks against the JAX formula (steps + iterations x 2, both
    channels), 0 detections, captured against uncaptured bit for bit, and
    the warm ms/iter of fused guarded, fused unguarded and unfused guarded
    in this one call; (g2) ``spmv.result=bitflip:at=2:times=1`` baked into
    the captured pieces: ``SilentCorruptionError`` with detector ``abft``
    and ``x`` the verified carry (the zero initial iterate), then
    ``resilient_solve`` to an fp64 relres <= 10 rtol, then a clean solve
    that replays the clean program and gives (g1)'s bits; (g3) k = 8
    batched (row 9): captured against uncaptured, and the bitflip
    detected."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    A = pt.poisson3d_csr(nx).tocsr()
    bv = pt.Vec.from_global(comm, b, dtype=torch.float32)
    x, _ = op.get_vecs()
    out = {}

    def warm(ksp, reps=3):
        ksp.solve(bv, x)
        walls = []
        for _ in range(reps):
            x.zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ksp.solve(bv, x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return res, min(walls) / max(res.iterations, 1) * 1e3
    # (g1)
    rows = {}
    for label, guard, fused in (("fused guarded", True, True),
                                ("fused unguarded", False, True),
                                ("unfused guarded", True, False)):
        ksp = fused_guarded_ksp(comm, op, guard, fused)
        reset_launches()
        res, ms_it = warm(ksp)
        launches = {kk: v for kk, v in read_launches().items() if v}
        rows[label] = {"iterations": res.iterations, "reason": res.reason,
                       "ms_per_iter": ms_it, "abft_checks": res.abft_checks,
                       "host_reads": res.host_syncs,
                       "steps": getattr(res, "megasolve_steps", None),
                       "replays": getattr(res, "replays", None),
                       "launches_4_solves": launches}
        log(f"(g1) {nx}^3 f32 cg+jacobi {label}: {res.iterations} its, "
            f"reason {res.reason}, {ms_it:.4f} ms/iter (warm best of 3), "
            f"ABFT checks {res.abft_checks}, {res.host_syncs} host reads, "
            f"launches over 4 solves {launches}")
        if label == "fused guarded":
            g = res
            x_graph = x.to_numpy()
            prog = ksp._megasolve_program(guard=ksp._megasolve_guard())
            prog.capture = False
            x.zero()
            res_e = ksp.solve(bv, x)
            prog.capture = True
            same = bool(np.array_equal(x_graph, x.to_numpy()))
            check(g.graph and not res_e.graph and same
                  and res_e.iterations == g.iterations,
                  f"(g1) captured {g.graph} / uncaptured {res_e.graph} "
                  f"differ (bit-equal {same})")
            check(g.abft_checks == g.megasolve_steps + 2 * g.iterations,
                  f"(g1) ABFT checks {g.abft_checks}, JAX's formula "
                  f"{g.megasolve_steps + 2 * g.iterations}")
            check(launches.get("stencil7_apply", 0) > 0,
                  "(g1) row 2 not launched on the fused guarded path")
            rows[label].update(captured_equals_uncaptured=same,
                               x_bits=x_graph)
        del ksp
    fg, ug = rows["fused guarded"], rows["unfused guarded"]
    check(fg["reason"] == ug["reason"] > 0
          and abs(fg["iterations"] - ug["iterations"])
          <= 0.02 * ug["iterations"],
          f"(g1) fused guarded {fg['iterations']} its / unfused "
          f"{ug['iterations']}")
    x_g1 = rows["fused guarded"].pop("x_bits")
    out["g1"] = rows
    # (g2)
    ksp = fused_guarded_ksp(comm, op)
    n_prog = len(ms._CACHE)
    x.zero()
    with pt.inject_faults("spmv.result=bitflip:at=2:times=1"):
        try:
            ksp.solve(bv, x)
            detector = None
        except pt.SilentCorruptionError as err:
            detector, det_it = err.detector, err.iteration
    carry_zero = bool(np.all(x.to_numpy() == 0))
    check(detector == "abft" and carry_zero,
          f"(g2) detector {detector}, x the zero carry {carry_zero}")
    faulted = [p for p in ms._CACHE.values()][n_prog:]
    check(len(faulted) == 1 and bool(faulted[0].graphs),
          "(g2) the faulted program was not captured apart")
    x.zero()
    with pt.inject_faults("spmv.result=bitflip:at=2:times=1"):
        rres = pt.resilient_solve(ksp, bv, x,
                                  pt.RetryPolicy(sleep=lambda _d: None))
    rel = true_relres(A, x.to_numpy(), b)
    check(rres.converged and rel <= 10 * KSP_RTOL,
          f"(g2) resilient solve {rres.reason}, relres {rel}")
    x.zero()
    clean = ksp.solve(bv, x)
    same = bool(np.array_equal(x.to_numpy(), x_g1))
    check(same and clean.graph, "(g2) the next clean solve did not give "
                                "(g1)'s bits")
    out["g2"] = {"detector": detector, "det_it": det_it,
                 "carry_zero": carry_zero, "attempts": rres.attempts,
                 "events": [e.kind for e in rres.recovery_events],
                 "iterations": rres.iterations, "relres": rel,
                 "clean_after_equals_g1": same}
    log(f"(g2) bitflip under capture: detector {detector} at iteration "
        f"{det_it}, x the zero carry {carry_zero}; resilient_solve "
        f"{rres.attempts} attempts {out['g2']['events']}, {rres.iterations} "
        f"its, fp64 relres {rel:.3e}; the next clean solve equals (g1) "
        f"bit for bit {same}")
    del ksp
    ms.clear_cache()
    # (g3)
    rng = np.random.default_rng(5)
    B = np.stack([b] + [op.mult(pt.Vec.from_global(
        comm, rng.random(nx ** 3).astype(np.float32))).to_numpy()
        for _ in range(k - 1)], axis=1)
    ksp = fused_guarded_ksp(comm, op)
    X = np.zeros_like(B)
    ksp.solve_many(B, X)
    reset_launches()
    X = np.zeros_like(B)
    res = ksp.solve_many(B, X)
    launches = {kk: v for kk, v in read_launches().items() if v}
    prog = ksp._megasolve_program(many_k=k,
                                  guard=ksp._megasolve_guard(many=True))
    prog.capture = False
    X_e = np.zeros_like(B)
    res_e = ksp.solve_many(B, X_e)
    prog.capture = True
    same = bool(np.array_equal(X, X_e))
    check(res.graph and not res_e.graph and same and res.converged,
          f"(g3) k={k}: captured {res.graph}, bit-equal {same}")
    check(launches.get("stencil7_apply_many", 0) > 0,
          "(g3) row 9 not launched")
    with pt.inject_faults("spmv.result=bitflip:at=2:times=1"):
        try:
            ksp.solve_many(B, np.zeros_like(B))
            det3 = None
        except pt.SilentCorruptionError as err:
            det3 = err.detector
    check(det3 == "abft", f"(g3) bitflip detector {det3}")
    out["g3"] = {"iterations": list(res.iterations),
                 "abft_checks": res.abft_checks, "launches": launches,
                 "captured_equals_uncaptured": same, "detector": det3}
    log(f"(g3) k={k} guarded fused: its {list(res.iterations)}, ABFT checks "
        f"{res.abft_checks}, launches {launches}, captured == uncaptured "
        f"{same}; bitflip detector {det3}")
    del ksp
    ms.clear_cache()
    torch.cuda.empty_cache()
    return out


def phase_guarded_refine(nx=128):
    """(g4) cfg13's 128^3 problem (``run_all.py:1387``): ``RefinedKSP``
    under ``-ksp_megasolve`` with the inners that arm the guard (an sstep
    inner at f32 and bf16, a bf16 pipecg inner), on a stencil inner with an
    fp64 stencil outer, so the fused guarded program launches row 2 (f32)
    and 2b (bf16); and the bf16 sstep inner with PC mg (rows 3b-6b). Per
    run: the outcome (the refinement contract of PERF.md section 2:
    relres <= 1.05 rtol, or bf16's breakdown; a guard detection is
    reported as one), whether the fused program gave the answer (an s-step
    demotion reruns the host loop, as in the JAX package), outer steps,
    inner iterations, replacements and the launches of the solve."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    from mpi_petsc4py_example_tpu_torch.utils.dtypes import (
        inner_precision_dtype)
    A = pt.poisson3d_csr(nx).astype(np.float64).tocsr()
    b = A @ np.random.default_rng(0).random(A.shape[0])
    comm = pt.DeviceComm()
    outer = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    out = {}
    for label, prec, ksp_type, pc in (("sstep f32", "f32", "sstep", "jacobi"),
                                      ("sstep bf16", "bf16", "sstep",
                                       "jacobi"),
                                      ("pipecg bf16", "bf16", "pipecg",
                                       "jacobi"),
                                      ("sstep bf16 mg", "bf16", "sstep",
                                       "mg")):
        inner = pt.StencilPoisson3D(comm, nx,
                                    dtype=inner_precision_dtype(prec))
        rk = pt.RefinedKSP().create(comm)
        rk.set_inner_precision(prec)
        rk.set_operators(A, inner_op=inner, outer_op=outer)
        rk.set_type(ksp_type)
        rk.get_pc().set_type(pc)
        rk.set_tolerances(rtol=REFINE_RTOL)
        rk.megasolve = True
        reset_launches()
        t0 = time.perf_counter()
        try:
            x, res = rk.solve(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rel = true_relres(A, x, b)
            # a demotion of the s-step inner reruns the host loop (JAX
            # refine.py:322-328): that result has no fused fields
            fused = hasattr(res, "megasolve_steps")
            row = {"outcome": ("parity" if res.converged else "breakdown"),
                   "reason": res.reason, "steps": rk.refine_steps,
                   "iterations": res.iterations,
                   "replacements": res.residual_replacements,
                   "relres": rel, "fused": fused,
                   "graph": bool(getattr(res, "graph", False)),
                   "wall_s": wall}
            check(not fused or res.graph, f"(g4) {label}: not captured")
            if res.converged:
                check(rel <= 1.05 * REFINE_RTOL, f"(g4) {label}: {rel}")
            else:
                check(prec == "bf16" and res.reason == -5,
                      f"(g4) {label}: reason {res.reason}")
        except pt.SilentCorruptionError as err:
            row = {"outcome": f"detected ({err.detector})",
                   "iterations": err.iteration,
                   "wall_s": time.perf_counter() - t0}
            check(prec == "bf16", f"(g4) {label}: {err.detector}")
        row["launches"] = all_launches()
        log(f"(g4) cfg13 {nx}^3 RefinedKSP {label} inner, fused guarded: "
            + ", ".join(f"{kk} {v}" for kk, v in row.items()))
        need = ("stencil7_apply" if prec == "f32" else
                "stencil7_smooth_bf16" if pc == "mg"
                else "stencil7_apply_bf16")
        check(row["launches"].get(need, 0) > 0,
              f"(g4) {label}: {need} not launched")
        out[label] = row
        del rk, inner
        ms.clear_cache()
        torch.cuda.empty_cache()
    return out


# ---- the telemetry layer (item 6.2, --telemetry) ------------------------------

def telemetry_counts(comm):
    """What arming telemetry must not change: every launch counter, the
    communicator's collectives and the device memory allocated."""
    import torch
    torch.cuda.synchronize()
    return (all_launches(), dict(comm.collectives),
            torch.cuda.memory_allocated())


def telemetry_batch(ksp, bv, x, nsolve):
    """One of cfg12's batches (``run_all.py:1334-1354``): ``nsolve`` solves
    from zero; its wall and the last result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(nsolve):
        x.zero()
        res = ksp.solve(bv, x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def phase_telemetry(nsolve=10, reps=3, nx=128):
    """(t1) cfg12 (``benchmarks/run_all.py:1300-1380``) at its own size: the
    32^3 assembled f32 CG + Jacobi, ``nsolve`` solves a batch, best of
    ``reps``, telemetry off and armed (flight ring 512); and bench.py's
    128^3 stencil f32 CG + Jacobi, unfused and ``-ksp_megasolve``, the same
    way, the off and armed batches in turns, each first in every other
    round. Per cell: the wall overhead of
    the best batches (JAX gates it under 2%), spans a solve, iterations off
    and armed, p50/p99 of ``solve.per_iter_seconds``;
    launches, collectives, host syncs and ``torch.cuda.memory_allocated()``
    equal off and armed. (t2) ``log_view`` of a few solves (its dispatch,
    sync and silent-error rows against the results' own counts), and a
    ``profiling.trace`` of one 128^3 solve with the span export, each
    loaded back as JSON."""
    import io
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch import telemetry as tel
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    from mpi_petsc4py_example_tpu_torch.utils import profiling
    comm = pt.DeviceComm()
    out = {}
    A32 = pt.poisson3d_csr(32).tocsr()
    M = pt.Mat.from_scipy(comm, A32, dtype=torch.float32)
    b32 = (A32 @ np.random.default_rng(0).random(A32.shape[0])).astype(
        np.float32)
    op, b = make_problem(comm, nx, torch.float32)
    cells = (("cfg12 32^3 AIJ", M, b32, False),
             (f"{nx}^3 stencil", op, b, False),
             (f"{nx}^3 stencil -ksp_megasolve", op, b, True))
    for label, mat, rhs, fused in cells:
        ksp = ksp_solver(comm, mat, "cg", rtol=KSP_RTOL / 2,
                         megasolve=fused)
        x, bv = mat.get_vecs()
        bv.set_global(rhs)
        ksp.solve(bv, x)                  # set-up, capture: both sides
        tel.disable()
        tel.reset()
        hist = tel.registry.histogram("solve.per_iter_seconds")
        row = {side: {"wall_s": None, "per_iter": [], "spans": 0,
                      "launches": {}, "collectives": {}, "host_syncs": 0,
                      "mem_delta": 0} for side in ("off", "armed")}
        # off and armed batches in turns, each side first in every other
        # round, so neither the host's drift nor a round's first batch reads
        # as overhead; the best batch a side
        for rep in range(reps):
            for side in (("off", "armed") if rep % 2 == 0
                         else ("armed", "off")):
                r = row[side]
                if side == "armed":
                    tel.enable(flight_len=512)
                n_spans = len(tel.flight_recorder.spans())
                n_obs = len(hist.reservoir())
                syncs = tel.registry.counter("sync.count").total()
                before = telemetry_counts(comm)
                wall, res = telemetry_batch(ksp, bv, x, nsolve)
                after = telemetry_counts(comm)
                tel.disable()
                r["wall_s"] = (wall if r["wall_s"] is None
                               else min(r["wall_s"], wall))
                r["iterations"] = res.iterations
                r["per_iter"] += hist.reservoir()[n_obs:]
                r["spans"] += len(tel.flight_recorder.spans()) - n_spans
                r["host_syncs"] += int(
                    tel.registry.counter("sync.count").total() - syncs)
                for key, i in (("launches", 0), ("collectives", 1)):
                    for k in after[i]:
                        r[key][k] = (r[key].get(k, 0) + after[i][k]
                                     - before[i].get(k, 0))
                r["mem_delta"] += after[2] - before[2]
                r["mem_allocated"] = after[2]
        for r in row.values():
            vals = sorted(r.pop("per_iter"))
            r["per_iter_p50_us"] = tel.percentile(vals, 50) * 1e6
            r["per_iter_p99_us"] = tel.percentile(vals, 99) * 1e6
            r["spans_per_solve"] = r.pop("spans") / (nsolve * reps)
        off, on = row["off"], row["armed"]
        over = (on["wall_s"] - off["wall_s"]) / off["wall_s"]
        row["overhead_pct"] = over * 100
        log(f"(t1) {label} f32 cg+jacobi, {nsolve} solves best of {reps}: "
            f"off {off['wall_s']:.4f} s, armed {on['wall_s']:.4f} s, "
            f"overhead {over * 100:+.2f}%; {on['spans_per_solve']:.2f} "
            f"ksp.solve spans a solve; iterations {off['iterations']} / "
            f"{on['iterations']}; per-iteration p50 {on['per_iter_p50_us']:.2f}"
            f" us, p99 {on['per_iter_p99_us']:.2f} us; launches "
            f"{on['launches']}, collectives {on['collectives']}, host syncs "
            f"{off['host_syncs']} / {on['host_syncs']}, memory allocated "
            f"{off['mem_allocated']} / {on['mem_allocated']} B")
        for key in ("iterations", "launches", "collectives", "host_syncs",
                    "mem_allocated", "mem_delta"):
            check(off[key] == on[key],
                  f"(t1) {label}: {key} off {off[key]} != armed {on[key]}")
        check(on["spans_per_solve"] == 1.0 and off["spans_per_solve"] == 0,
              f"(t1) {label}: spans a solve {on['spans_per_solve']}")
        out[label] = row
        del ksp
        ms.clear_cache()
    # (t2) the log_view rows against the results' own counts
    tel.reset()
    profiling.clear_events()
    results = []
    for fused, guard in ((False, False), (True, False), (True, True)):
        ksp = ksp_solver(comm, op, "cg", megasolve=fused)
        ksp.abft = guard
        x, bv = op.get_vecs()
        bv.set_global(b)
        results.append(ksp.solve(bv, x))
    buf = io.StringIO()
    profiling.log_view(file=buf)
    text = buf.getvalue()
    syncs = sum(r.host_syncs for r in results)
    checks = sum(r.abft_checks for r in results)
    want = (f"compiled-program dispatches: 3 [ksp: 1, megasolve: 2]",
            f"KSP result fetch/solve: {syncs}",
            f"silent-error detection: {checks} ABFT check(s), 0 "
            "detection(s), 0 residual replacement(s)")
    for line in text.splitlines():
        log(f"(t2) log_view | {line}")
    for w in want:
        check(w in text, f"(t2) log_view lacks {w!r}")
    tel.enable()
    trace_dir = os.path.join("build", "telemetry_trace")
    ksp = ksp_solver(comm, op, "cg")
    x, bv = op.get_vecs()
    bv.set_global(b)
    with profiling.trace(trace_dir):
        ksp.solve(bv, x)
    tel.disable()
    spans_doc = tel.export_trace(os.path.join(trace_dir, "spans.json"))
    names = {e["name"] for e in spans_doc["traceEvents"]}
    traces = sorted(p for p in os.listdir(trace_dir)
                    if p.startswith("torch_trace_"))
    with open(os.path.join(trace_dir, traces[-1])) as fh:
        prof_doc = json.load(fh)
    with open(os.path.join(trace_dir, "spans.json")) as fh:
        json.load(fh)
    kernels = sum(1 for e in prof_doc.get("traceEvents", ())
                  if "stencil7" in str(e.get("name", "")))
    check({"ksp.solve", "ksp.dispatch", "ksp.fetch"} <= names,
          f"(t2) span export names {sorted(names)}")
    check(kernels > 0, "(t2) the torch.profiler trace holds no stencil7 "
                       "kernel")
    out["t2"] = {"log_view": text.splitlines(), "span_names": sorted(names),
                 "trace_stencil7_events": kernels}
    log(f"(t2) torch.profiler trace {traces[-1]} ({kernels} stencil7 "
        f"events) and span export {sorted(names)} load as JSON")
    shutil.rmtree(trace_dir, ignore_errors=True)
    tel.reset()
    return out


# ---- the resilience layer (item 6, first half) ------------------------------

RES_RTOL = 1e-6          # (a), (b), (d), (e): bench.py's rtol in f32
CHAOS_RTOL = 1e-8        # (c): the fp64 drill
CHAOS_NX = 128
CHAOS_RR = 50


def guarded_cg(comm, op, rtol=RES_RTOL, abft=True, rr=0, max_it=20000,
               norm_none=False, pmat=None, ksp_type="cg", pc="jacobi"):
    """A cg (or pipecg/sstep) solver with the silent-corruption guard:
    ``-ksp_abft`` and ``-ksp_residual_replacement rr``."""
    import mpi_petsc4py_example_tpu_torch as pt
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op, pmat)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    ksp.abft = abft
    ksp.residual_replacement = rr
    if norm_none:
        ksp.set_norm_type("none")
    return ksp


def events_line(res) -> str:
    """A result's recovery events, one word each: the kind, the detector
    after a slash, a rebuild's shard counts in brackets."""
    def word(e):
        w = e.kind + (f"/{e.detector}" if e.detector else "")
        if e.kind.startswith("mesh"):
            w += f"({e.old_devices}->{e.new_devices})"
        return w
    return ", ".join(word(e) for e in res.recovery_events)


def phase_res_guarded(nx=512, rtol=RES_RTOL, lengths=(50, 150),
                      converged=("off", "abft", "abft+rr50"),
                      timed=("off", "abft", "abft+rr50")):
    """(a) 512^3 f32 CG + Jacobi, the guard off, ``-ksp_abft`` and
    ``-ksp_abft -ksp_residual_replacement 50``: iterations, detections,
    ABFT checks (1 + its), row-1 launches (its + 1), row-2 launches (the
    replacements' b - A x), the fp64 true relres on the card, and the
    delta-method ms/iter with the guard's overhead. A run not in
    ``converged`` is timed only, one not in ``timed`` not at all (the full
    run leaves out the rr 50 run, ~5400 iterations converged)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    op, b = make_problem(comm, nx, torch.float32)
    x, bv = op.get_vecs()
    bv.set_global(b)
    out = {}
    for label, abft, rr in (("off", False, 0), ("abft", True, 0),
                            ("abft+rr50", True, 50)):
        if label not in timed:
            continue
        if label not in converged:
            solvers = {m: guarded_cg(comm, op, rtol, abft=abft, rr=rr,
                                     max_it=m, norm_none=True)
                       for m in lengths}
            ms, per = delta_per_iter(solvers, bv, x)
            out[label] = {"ms_per_iter": ms * 1e3,
                          "ms_runs": [p_ * 1e3 for p_ in per]}
            continue
        ksp = guarded_cg(comm, op, rtol, abft=abft, rr=rr)
        x.zero()
        reset_launches()
        res = ksp.solve(bv, x)
        launches = read_launches()
        relres = card_relres(comm, nx, bv.data, x.data)[0]
        solvers = {m: guarded_cg(comm, op, rtol, abft=abft, rr=rr,
                                 max_it=m, norm_none=True) for m in lengths}
        ms, per = delta_per_iter(solvers, bv, x)
        # where a guarded iteration's device time goes: 30 fixed iterations
        # under the profiler, the guard off and on
        prof = {}
        if label != "abft+rr50":
            fixed = guarded_cg(comm, op, rtol, abft=abft, max_it=30,
                               norm_none=True)
            idle = profile_solve(lambda: zero_solve(fixed, bv, x),
                                 f"(a) {nx}^3 guard {label}, 30 iterations",
                                 kernels=("stencil7", "reduce_kernel"),
                                 out=prof)
            prof["idle_share"] = idle
        out[label] = {"profile": prof,
                      "its": res.iterations, "reason": res.reason,
                      "abft_checks": res.abft_checks,
                      "sdc_detections": res.sdc_detections,
                      "replacements": res.residual_replacements,
                      "stencil7_dot": launches["stencil7_dot"],
                      "stencil7_apply": launches["stencil7_apply"],
                      "relres_fp64": relres, "ms_per_iter": ms * 1e3,
                      "ms_runs": [p * 1e3 for p in per]}
        check(res.converged, f"(a) {label}: {res}")
        check(relres <= 10 * rtol, f"(a) {label}: fp64 relres {relres}")
        check(launches["stencil7_dot"] == res.iterations + 1,
              f"(a) {label}: stencil7_dot launches "
              f"{launches['stencil7_dot']} != its + 1")
        if abft:
            check(res.abft_checks == 1 + res.iterations,
                  f"(a) {label}: abft_checks {res.abft_checks}")
        check(launches["stencil7_apply"] == res.residual_replacements,
              f"(a) {label}: stencil7_apply launches "
              f"{launches['stencil7_apply']} != replacements")
    off = out["off"]["ms_per_iter"]
    for label in ("abft", "abft+rr50"):
        if label in out:
            out[label]["overhead_pct"] = (out[label]["ms_per_iter"] / off
                                          - 1) * 100
    check(out["abft"]["its"] == out["off"]["its"],
          f"(a) iterations with -ksp_abft {out['abft']['its']} != "
          f"{out['off']['its']} without the guard")
    for label, r in out.items():
        if "its" not in r:
            log(f"(a) {nx}^3 f32 CG+jacobi guard {label}: "
                f"{r['ms_per_iter']:.4f} ms/iter (delta method {lengths}), "
                f"overhead {r['overhead_pct']:+.1f}%")
            continue
        log(f"(a) {nx}^3 f32 CG+jacobi guard {label}: {r['its']} its, "
            f"reason {r['reason']}, sdc_detections {r['sdc_detections']}, "
            f"abft_checks {r['abft_checks']}, replacements "
            f"{r['replacements']}, stencil7_dot {r['stencil7_dot']}, "
            f"stencil7_apply {r['stencil7_apply']}, fp64 relres "
            f"{r['relres_fp64']:.3e}, {r['ms_per_iter']:.4f} ms/iter "
            f"(delta method {lengths}, runs "
            f"{[round(v, 4) for v in r['ms_runs']]})"
            + (f", overhead {r['overhead_pct']:+.1f}%"
               if "overhead_pct" in r else ""))
    del op, x, bv
    torch.cuda.empty_cache()
    return out


def phase_res_cfg8(sizes=(64, 128), lengths=(100, 300)):
    """(b) cfg8 (``benchmarks/run_all.py:805-900``): the assembled
    ``poisson3d_csr`` CG, PC none, f32, rtol 0.5e-6 (the cfg suite's margin
    0.5), x_true from default_rng(0); the guard (``-ksp_abft``) off and
    on: best-of-3 warm walls, the delta method, iterations, detections
    and the fp64 true relres against 1.05e-6."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    out = {}
    for nx in sizes:
        A = pt.poisson3d_csr(nx)
        m, _ = assemble(comm, A, torch.float32)
        xt = np.random.default_rng(0).random(A.shape[0]).astype(np.float32)
        b = (A @ xt).astype(np.float32)
        x, bv = m.get_vecs()
        bv.set_global(b)
        row = {}
        for abft in (False, True):
            ksp = guarded_cg(comm, m, 0.5 * RES_RTOL, abft=abft, pc="none")
            ksp.solve(bv, x)
            walls = []
            for _ in range(3):
                x.zero()
                t0 = time.perf_counter()
                res = ksp.solve(bv, x)
                walls.append(time.perf_counter() - t0)
            relres = true_relres(A, x.to_numpy(), b)
            solvers = {k: guarded_cg(comm, m, abft=abft, pc="none",
                                     max_it=k, norm_none=True)
                       for k in lengths}
            ms, _ = delta_per_iter(solvers, bv, x)
            row["on" if abft else "off"] = {
                "its": res.iterations, "wall_s": min(walls),
                "ms_per_iter": ms * 1e3, "relres": relres,
                "abft_checks": res.abft_checks,
                "sdc_detections": res.sdc_detections}
            check(res.converged and relres <= 1.05 * RES_RTOL,
                  f"(b) cfg8 {nx}^3 abft={abft}: {res}, relres {relres}")
        on, off = row["on"], row["off"]
        row["e2e_overhead_pct"] = (on["wall_s"] / off["wall_s"] - 1) * 100
        row["overhead_pct"] = (on["ms_per_iter"] / off["ms_per_iter"]
                               - 1) * 100
        check(on["its"] == off["its"] and on["sdc_detections"] == 0,
              f"(b) cfg8 {nx}^3: its {on['its']} vs {off['its']}")
        log(f"(b) cfg8 {nx}^3 f32 CG, PC none: its {on['its']} (off "
            f"{off['its']}), walls {off['wall_s']:.4f} -> "
            f"{on['wall_s']:.4f} s ({row['e2e_overhead_pct']:+.1f}%), delta "
            f"method {off['ms_per_iter']:.4f} -> {on['ms_per_iter']:.4f} "
            f"ms/iter ({row['overhead_pct']:+.1f}%), detections "
            f"{on['sdc_detections']}, abft_checks {on['abft_checks']}, "
            f"fp64 relres {off['relres']:.3e} / {on['relres']:.3e}")
        out[str(nx)] = row
        del m, x, bv
    torch.cuda.empty_cache()
    return out


CHAOS_SPECS = ("spmv.result=bitflip:at=2:times=1",
               "spmv.result=scale:mag=1e-3:at=2:times=1",
               "pc.apply=bitflip:at=2:times=1",
               "pc.apply=scale:mag=1e-2:at=2:times=1")


def res_chain_refusals(comm, op, b, rtol=CHAOS_RTOL):
    """(c) what ``KSPFallbackChain`` does not do on the card: a device
    fault (``ksp.program=unavailable:times=*``) is re-raised from the
    first stage, not moved to another method or to the host; and where
    every iterative stage fails (``ksp.result=nan``) on an assembled
    operator whose lu is the host sparse LU (the 32^3 Poisson matrix: past
    the dense cap, its band past the block cyclic-reduction cap), the
    chain raises ``HostStageError`` instead of solving on the host."""
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.resilience import faults
    from mpi_petsc4py_example_tpu_torch.resilience.fallback import (
        HostStageError)
    from mpi_petsc4py_example_tpu_torch.solvers.pc import lu_mode
    x, bv = op.get_vecs()
    bv.set_global(b)
    ksp = guarded_cg(comm, op, rtol, abft=False)
    raised = None
    try:
        with faults.inject_faults("ksp.program=unavailable:times=*"):
            pt.KSPFallbackChain(ksp).solve(bv, x)
    except pt.DeviceExecutionError as exc:
        raised = exc.failure_class
    check(raised == "unavailable" and ksp.get_type() == "cg",
          f"(c) chain: a device fault gave {raised!r}, type "
          f"{ksp.get_type()}")
    A = pt.poisson3d_csr(32).tocsr()
    n = A.shape[0]
    M = pt.Mat.from_scipy(comm, A)
    check(lu_mode(M) == "hostlu", "(c) chain: the operator's lu is not "
                                  "the host sparse LU")
    k2 = pt.KSP().create(comm)
    k2.set_operators(M)
    k2.set_type("cg")
    k2.set_tolerances(rtol=rtol, max_it=20)
    x2, b2 = M.get_vecs()
    b2.set_global(A @ np.ones(n))
    refused = None
    try:
        with faults.inject_faults("ksp.result=nan:at=1:times=3"):
            pt.KSPFallbackChain(k2).solve(b2, x2)
    except HostStageError as exc:
        refused = [e.detail for e in exc.recovery_events]
    check(refused == ["cg->bcgs", "bcgs->gmres", "gmres->preonly"],
          f"(c) chain: the host LU stage was not refused ({refused})")
    log(f"(c) KSPFallbackChain on the card: ksp.program=unavailable:times=* "
        f"re-raised ({raised}) from stage 1; ksp.result=nan through "
        f"{' / '.join(refused)}, then HostStageError in place of the host "
        f"sparse LU ({n} rows)")
    return {"device_fault": raised, "host_stage_refused": refused}


def phase_res_chaos(nx=CHAOS_NX, k=K_BATCH, rtol=CHAOS_RTOL,
                    specs=CHAOS_SPECS, many_specs=CHAOS_SPECS):
    """(c) JAX ``tools/chaos_smoke.py``'s drill on the card, 128^3 fp64
    stencil CG + Jacobi with ``-ksp_abft -ksp_residual_replacement 50``:
    bitflip and scale at ``spmv.result`` (the fast path, row 1) and at
    ``pc.apply`` (the general route, row 2: a distinct PC operator), one
    RHS through ``resilient_solve`` and k = 8 through
    ``resilient_solve_many`` (row 9); a mid-solve ``ksp.program`` crash, a
    NaN residual (``KSPFallbackChain``: cg -> bcgs) and a corrupted
    reduction. Each detected or raised, then recovered to an fp64 true
    relres <= 10 rtol; the unguarded ``scale`` control (general route)
    converges far from the answer."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.resilience import faults
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    pmat = op.with_comm(comm)     # a distinct operator: the general route
    n = nx ** 3
    b = np.random.default_rng(0).standard_normal(n)
    B = np.random.default_rng(1).standard_normal((n, k))
    policy = pt.RetryPolicy(sleep=lambda _d: None)
    out = {}

    def single(label, spec, general=False, guard=True, fallback=False):
        x, bv = op.get_vecs()
        bv.set_global(b)
        ksp = guarded_cg(comm, op, rtol, abft=guard,
                         rr=CHAOS_RR if guard else 0,
                         pmat=pmat if general else None)
        reset_launches()
        t0 = time.perf_counter()
        with faults.inject_faults(spec):
            res = (pt.KSPFallbackChain(ksp).solve(bv, x) if fallback
                   else pt.resilient_solve(ksp, bv, x, policy))
        wall = time.perf_counter() - t0
        launches = read_launches()
        relres = card_relres(comm, nx, bv.data, x.data)[0]
        row = {"its": res.iterations, "attempts": res.attempts,
               "events": events_line(res), "sdc": res.sdc_detections,
               "relres": relres, "wall_s": wall,
               "launches": {k_: v for k_, v in launches.items() if v}}
        log(f"(c) {label} [{spec}]: {row['its']} its, {row['attempts']} "
            f"attempts, events [{row['events']}], fp64 relres "
            f"{relres:.3e}, {wall:.2f} s, launches {row['launches']}")
        check(res.converged and relres <= 10 * rtol,
              f"(c) {label}: not recovered: {res}, relres {relres}")
        check(res.recovery_events, f"(c) {label}: no recovery event")
        out[label] = row

    for spec in specs:
        single(spec.split("=")[0] + " " + spec.split("=")[1].split(":")[0],
               spec, general=spec.startswith("pc.apply"))
    single("ksp.program crash", "ksp.program=unavailable:iter=20")
    single("comm.psum corrupt", "comm.psum=corrupt:times=1:at=2")
    single("ksp.result nan (fallback)", "ksp.result=nan:iter=3",
           guard=False, fallback=True)
    out["chain refusals"] = res_chain_refusals(comm, op, b, rtol)
    check(any(e.startswith("fault/") for e in
              out["spmv.result bitflip"]["events"].split(", ")),
          "(c) the bitflip was not detected")
    # the batched drill: k = 8 columns, the general route (row 9)
    for spec in many_specs:
        ksp = guarded_cg(comm, op, rtol, rr=CHAOS_RR)
        X = np.zeros((n, k))
        reset_launches()
        t0 = time.perf_counter()
        with faults.inject_faults(spec):
            res = pt.resilient_solve_many(ksp, B, X, policy)
        wall = time.perf_counter() - t0
        launches = read_launches()
        Xd = comm.put_cols(X, torch.float64)
        Bd = comm.put_cols(B, torch.float64)
        rel = card_relres(comm, nx, Bd, Xd)
        label = "many " + spec.split(":")[0]
        out[label] = {"its": list(res.iterations), "attempts": res.attempts,
                      "events": events_line(res), "relres_max": max(rel),
                      "wall_s": wall,
                      "launches": {k_: v for k_, v in launches.items()
                                   if v}}
        log(f"(c) {label} k={k}: its {list(res.iterations)}, "
            f"{res.attempts} attempts, events [{events_line(res)}], max "
            f"fp64 relres {max(rel):.3e}, {wall:.2f} s, launches "
            f"{out[label]['launches']}")
        check(res.converged and max(rel) <= 10 * rtol,
              f"(c) {label}: not recovered: {res}")
        check(launches["stencil7_apply_many"] > 0,
              f"(c) {label}: stencil7_apply_many never launched")
    # the control: the same scale corruption, unguarded, "converges" (on
    # the general route, whose <p, A p> reads the corrupted product; the
    # fast path's fused dot stays clean, and its recurrence diverges)
    x, bv = op.get_vecs()
    bv.set_global(b)
    ksp = guarded_cg(comm, op, rtol, abft=False, pmat=pmat)
    with faults.inject_faults("spmv.result=scale:mag=1e-3:times=*"):
        res = ksp.solve(bv, x)
    rel = card_relres(comm, nx, bv.data, x.data)[0]
    out["control"] = {"its": res.iterations, "reason": res.reason,
                      "relres": rel}
    log(f"(c) control, unguarded spmv.result=scale:mag=1e-3:times=*: "
        f"{res.iterations} its, reason {res.reason_name} on the "
        f"recurrence's word, fp64 relres {rel:.3e}")
    check(res.converged and rel > 100 * rtol,
          f"(c) control: {res}, relres {rel}")
    del op, pmat
    torch.cuda.empty_cache()
    return out


def phase_res_pipe_sstep(nx=128, big=512, rr=50, lengths=(40, 120)):
    """(d) pipecg and sstep s = 4, 128^3 f32 + Jacobi at rtol 1e-6, without
    the guard and with the automatic replacement (``-ksp_pipeline_auto_
    replacement``/``-ksp_sstep_auto_replacement`` ``rr``): reason,
    iterations, replacements, fp64 relres; then at 512^3 the delta-method
    ms/iter of each, guarded against unguarded (``big`` None: not
    timed)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    comm = pt.DeviceComm()
    out = {}
    op, b = make_problem(comm, nx, torch.float32)
    x, bv = op.get_vecs()
    bv.set_global(b)
    auto = {"pipecg": "pipeline_auto_replacement",
            "sstep": "sstep_auto_replacement"}
    for ksp_type in ("pipecg", "sstep"):
        for guarded in (False, True):
            ksp = guarded_cg(comm, op, abft=False, max_it=2000,
                             ksp_type=ksp_type)
            if guarded:
                setattr(ksp, auto[ksp_type], rr)
            x.zero()
            reset_launches()
            res = ksp.solve(bv, x)
            launches = read_launches()
            rel = card_relres(comm, nx, bv.data, x.data)[0]
            label = f"{ksp_type} {'guarded' if guarded else 'unguarded'}"
            out[label] = {"reason": res.reason, "its": res.iterations,
                          "replacements": res.residual_replacements,
                          "events": events_line(res), "relres": rel,
                          "stencil7_apply": launches["stencil7_apply"]}
            log(f"(d) {nx}^3 f32 {label}: {res.reason_name}, "
                f"{res.iterations} its, {res.residual_replacements} "
                f"replacements, events [{events_line(res)}], fp64 relres "
                f"{rel:.3e}, stencil7_apply {launches['stencil7_apply']}")
            if guarded:
                check(res.converged and rel <= 10 * RES_RTOL,
                      f"(d) {label}: {res}, relres {rel}")
    del op, x, bv
    torch.cuda.empty_cache()
    if big is None:
        return out
    op, b = make_problem(comm, big, torch.float32)
    x, bv = op.get_vecs()
    bv.set_global(b)
    for ksp_type in ("pipecg", "sstep"):
        row = {}
        for guarded in (False, True):
            def mk(m):
                k_ = guarded_cg(comm, op, abft=False, max_it=m,
                                norm_none=True, ksp_type=ksp_type)
                if guarded:
                    setattr(k_, auto[ksp_type], rr)
                return k_
            ms, _ = delta_per_iter({m: mk(m) for m in lengths}, bv, x)
            row["guarded" if guarded else "unguarded"] = ms * 1e3
        row["overhead_pct"] = (row["guarded"] / row["unguarded"] - 1) * 100
        out[f"{ksp_type} {big}"] = row
        log(f"(d) {big}^3 f32 {ksp_type}: {row['unguarded']:.4f} -> "
            f"{row['guarded']:.4f} ms/iter with the replacement every {rr} "
            f"({row['overhead_pct']:+.1f}%, delta method {lengths})")
    del op, x, bv
    torch.cuda.empty_cache()
    return out


def phase_res_elastic(nx=128, rtol=RES_RTOL):
    """(e) ``DeviceComm(4)``, the assembled 128^3 f32 Poisson, CG + Jacobi:
    shard 3 lost at iteration 50 (``device.lost``): the checkpoint, the
    shrink to 2 shards resumed from it; then a crash on the degraded mesh,
    the heal during its backoff, and the regrow to 4 at the next failure,
    resumed from its checkpoint; the fp64 true relres of the answer."""
    import shutil
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.resilience import faults
    root = os.path.dirname(os.path.abspath(__file__))
    ckdir = os.path.join(root, "build", "resilience")
    os.makedirs(ckdir, exist_ok=True)
    comm = pt.DeviceComm(4)
    A = pt.poisson3d_csr(nx)
    m, _ = assemble(comm, A, torch.float32)
    b = manufactured(A)
    ksp = guarded_cg(comm, m, rtol, abft=False)
    x, bv = m.get_vecs()
    bv.set_global(b)
    healed = []

    def sleep_heals(_d):
        if not healed:
            healed.append(faults.heal())

    spec = ("device.lost=unavailable:device=3:at=1:iter=50,"
            "ksp.program=unavailable:at=2:times=2:iter=20")
    t0 = time.perf_counter()
    try:
        with faults.inject_faults(spec):
            res = pt.resilient_solve(ksp, bv, x,
                                     pt.RetryPolicy(sleep=sleep_heals),
                                     checkpoint_path=os.path.join(
                                         ckdir, "elastic.npz"))
    finally:
        faults.heal()
        shutil.rmtree(ckdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    relres = true_relres(A, x.to_numpy(), b)
    shrink = [e for e in res.recovery_events if e.kind == "mesh_shrink"]
    grow = [e for e in res.recovery_events if e.kind == "mesh_regrow"]
    out = {"events": events_line(res), "its": res.iterations,
           "attempts": res.attempts, "relres": relres, "wall_s": wall,
           "shrink": [(e.old_devices, e.new_devices, e.iterations)
                      for e in shrink],
           "regrow": [(e.old_devices, e.new_devices, e.iterations)
                      for e in grow], "final_shards": ksp.comm.size}
    log(f"(e) elastic {nx}^3 f32 AIJ CG+jacobi on DeviceComm(4): events "
        f"[{out['events']}], shrink {out['shrink']}, regrow "
        f"{out['regrow']}, {res.iterations} its in the last attempt, "
        f"{res.attempts} attempts, final shards {ksp.comm.size}, fp64 "
        f"relres {relres:.3e}, {wall:.1f} s")
    check(shrink and shrink[0].new_devices == 2
          and shrink[0].iterations == 50,
          f"(e) no shrink to 2 from iteration 50: {out['shrink']}")
    check(grow and grow[0].new_devices == 4,
          f"(e) no regrow to 4: {out['regrow']}")
    check(ksp.comm.size == 4 and res.converged and relres <= 10 * rtol,
          f"(e) {res}, relres {relres}")
    del m
    torch.cuda.empty_cache()
    return out


# (f)'s cases: guarded 64^3 fp64 CG with a bitflip, one RHS and k = 4
RES_PROCS_CASES = [
    dict(name="sdc_spmv", kind="sdc", grid=[64] * 3,
         spec="spmv.result=bitflip:at=2:times=1", rr=CHAOS_RR),
    dict(name="sdc_pc_many", kind="sdc", grid=[64] * 3, k=4,
         spec="pc.apply=bitflip:at=2:times=1", rr=CHAOS_RR),
    # (g5) the fused guarded program: captured on NCCL 1 x 4 (one process),
    # uncaptured on gloo 2 x 2, against DeviceComm(4) captured
    dict(name="sdc_spmv_fused", kind="sdc", grid=[64] * 3,
         spec="spmv.result=bitflip:at=2:times=1", rr=CHAOS_RR,
         megasolve=True)]
# the full run's procs launches carry (f)'s cases: label -> results
_RES_PROCS_GOT: dict = {}


def phase_res_procs(shared=None):
    """(f) the guard across processes: :data:`RES_PROCS_CASES` on NCCL
    1 x 4 and gloo 2 x 2; the detector, the detection iteration, the
    rolled-back iterate and the recovered one bit-equal to
    ``DeviceComm(4)``'s. ``shared``: the results of the procs phase's
    launches, which carried the cases (the full run), instead of launches
    of their own."""
    base = RES_PROCS_CASES
    ref = procs_reference(base, 4)
    out = {}
    for label, nprocs, local, backend in (("nccl 1x4", 1, 4, "nccl"),
                                          ("gloo 2x2", 2, 2, "gloo")):
        if shared:
            got, wall = shared[label], 0.0
        else:
            got, wall = parity_launch(
                nprocs, [dict(c, local_shards=local) for c in base],
                backend)
        for c in base:
            g, w = got[c["name"]], ref[c["name"]]
            if c.get("megasolve"):
                graph = bool(np.asarray(g["graph"]))
                check(graph == (backend == "nccl")
                      and bool(np.asarray(w["graph"])),
                      f"(g5) {label} {c['name']}: graph {graph}, "
                      f"reference {w['graph']}")
            for key in ("detector", "det_it", "its", "events"):
                check(np.array_equal(np.asarray(g[key]), np.asarray(w[key])),
                      f"(f) {label} {c['name']}: {key} {g[key]} != {w[key]}")
            for key in ("x", "x_rollback"):
                check(np.array_equal(g[key], w[key]),
                      f"(f) {label} {c['name']}: {key} differs")
            out[f"{label} {c['name']}"] = {
                "detector": str(g["detector"]), "det_it": int(g["det_it"]),
                "its": np.atleast_1d(g["its"]).tolist(), "wall_s": wall}
            log(f"(f) {label} {c['name']}: detector {g['detector']} at "
                f"iteration {int(g['det_it'])}, recovered its "
                f"{np.atleast_1d(g['its']).tolist()}, events {g['events']}; "
                f"bit-equal to DeviceComm(4) (launch {wall:.1f} s)")
    return out


def phase_resilience(full=False):
    """The resilience slice's phases (a)-(f); each phase's seconds logged.
    ``full`` (the no-argument run) leaves out (a)'s rr 50 run, (b)'s 128^3
    cell, (c)'s scale cases and batched cases but the ``spmv.result``
    bitflip, and (d)'s 512^3 timing, runs (e) at 64^3, and takes (f) from
    the procs phase's launches: the whole run stays inside its time
    limit."""
    out = {}
    if full:
        steps = (("a_guarded_512",
                  lambda: phase_res_guarded(converged=("off", "abft"),
                                            timed=("off", "abft"))),
                 ("b_cfg8", lambda: phase_res_cfg8(sizes=(64,))),
                 ("c_chaos", lambda: phase_res_chaos(
                     specs=CHAOS_SPECS[::2], many_specs=CHAOS_SPECS[:1])),
                 ("d_pipe_sstep", lambda: phase_res_pipe_sstep(big=None)),
                 ("e_elastic", lambda: phase_res_elastic(nx=64)),
                 ("f_procs", lambda: phase_res_procs(_RES_PROCS_GOT)))
    else:
        steps = (("a_guarded_512", phase_res_guarded),
                 ("b_cfg8", phase_res_cfg8),
                 ("c_chaos", phase_res_chaos),
                 ("d_pipe_sstep", phase_res_pipe_sstep),
                 ("e_elastic", phase_res_elastic),
                 ("f_procs", phase_res_procs))
    for key, fn in steps:
        t0 = time.perf_counter()
        out[key] = fn()
        log(f"resilience phase {key}: {time.perf_counter() - t0:.1f} s")
    return out


# ---- the serving layer (ROADMAP Queue A item 7, first half) ----------------

SERVING_NX = 128      # the repo's 128^3 width: 2,097,152 unknowns
SERVING_RTOL = 1e-6   # each answer's fp64 true relres is held to this
SERVING_REQUESTS = 64
SERVING_MAX_K = 8
PERSISTENT_REQUESTS = 24
PERSISTENT_Q = 8


def oracle_stencil_relres(nx, b_path, x_path, start, stop):
    """fp64 true relative residuals ``||b - A x|| / ||b||`` of the ``nx^3``
    7-point Dirichlet stencil on the host for requests ``start:stop``, one
    a row of the ``.npy`` files at ``b_path``/``x_path`` (read through
    ``mmap``): ``(list, seconds)``."""
    t0 = time.perf_counter()
    brows = np.load(b_path, mmap_mode="r")
    xrows = np.load(x_path, mmap_mode="r")
    out = []
    for j in range(start, stop):
        U = np.asarray(xrows[j], dtype=np.float64).reshape(nx, nx, nx)
        Y = 6.0 * U
        for ax in range(3):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax], hi[ax] = slice(1, None), slice(None, -1)
            Y[tuple(lo)] -= U[tuple(hi)]
            Y[tuple(hi)] -= U[tuple(lo)]
        bb = np.asarray(brows[j], dtype=np.float64)
        out.append(float(np.linalg.norm(bb - Y.reshape(-1))
                         / np.linalg.norm(bb)))
    return out, time.perf_counter() - t0


def oracle_ready(i):
    """Nothing: submitted once a worker, it starts the reference workers
    early (``i`` keeps the calls apart)."""
    return i, os.getpid()


def served_relres(nx, brows, xrows, tag):
    """:func:`oracle_stencil_relres` of every request, split over the host
    reference workers; the rows travel through two files under
    ``build/serving/`` (gitignored, deleted after), not through the
    workers' pipes."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "serving")
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f"{tag}_{name}.npy") for name in ("b", "x")]
    try:
        np.save(paths[0], np.ascontiguousarray(brows))
        np.save(paths[1], np.ascontiguousarray(xrows))
        bounds = np.linspace(0, len(brows), ORACLE_WORKERS + 1).astype(int)
        futs = [host_oracle(oracle_stencil_relres, nx, *paths, int(a), int(b))
                for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        return [r for f in futs for r in f.result()[0]]
    finally:
        for p in paths:
            if os.path.exists(p):
                os.remove(p)


def stencil_rows(comm, op, count, seed, dtype):
    """``count`` right-hand sides ``b = A x`` of the stencil (``x`` seeded on
    the host, the product on the card), one a row."""
    import mpi_petsc4py_example_tpu_torch as pt
    rng = np.random.default_rng(seed)
    n = op.shape[0]
    npdt = np.float32 if dtype.itemsize == 4 else np.float64
    rows = np.empty((count, n), npdt)
    for j in range(count):
        rows[j] = op.mult(pt.Vec.from_global(
            comm, rng.random(n, dtype=npdt), dtype=dtype)).to_numpy()
    return rows


def percentile_ms(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q / 100 * (len(v) - 1))))] * 1e3


def phase_serving_cfg9(card, nx=SERVING_NX, requests=SERVING_REQUESTS,
                       max_k=SERVING_MAX_K):
    """(a) cfg9's shape (``benchmarks/run_all.py:912-1030``) on the 128^3
    stencil: f32 CG + Jacobi at rtol 0.5e-6 (each answer held to 1e-6),
    ``max_k`` 8 with pow2 padding, ``requests`` seeded Poisson arrivals at
    50x the measured sequential rate, one injected
    ``ksp.program=unavailable:at=3:iter=8``. Every future resolves and
    converges with an fp64 true relres <= 1.05 rtol (host workers), at
    least one request took a second attempt, and ``stencil7_dot_many``
    launched the sum over blocks of (max iterations + 1) plus the faulted
    attempt's iter + 1, counters zeroed just before the first submission."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.serving import SolveServer
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    t_rows = time.perf_counter()
    rows = stencil_rows(comm, op, requests, 9, torch.float32)
    t_rows = time.perf_counter() - t_rows
    rtol_inner = 0.5 * SERVING_RTOL
    # the sequential baseline: one KSP.solve a request (the first is warm-up)
    ksp = cg_jacobi(comm, op, rtol=rtol_inner)
    x, bv = op.get_vecs()
    seq = min(8, requests)
    for j in range(seq + 1):
        bv = pt.Vec.from_global(comm, rows[j % seq], dtype=torch.float32)
        if j == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ksp.solve(bv, x)
        x.to_numpy()
    seq_rate = seq / (time.perf_counter() - t0)
    del ksp
    srv = SolveServer(comm, window=0.003, max_k=max_k, pad_pow2=True,
                      retry_policy=pt.RetryPolicy(base_delay=0.01,
                                                  max_delay=0.1))
    blocks = []
    try:
        widths = [1 << p for p in range(max_k.bit_length())
                  if (1 << p) <= max_k]
        srv.register_operator("poisson", op, pc_type="jacobi",
                              rtol=rtol_inner, max_it=20000,
                              warm_widths=widths)
        srv._dispatch_hook = lambda reqs: blocks.append(
            [id(r.future) for r in reqs])
        rng = np.random.default_rng(9)
        lam = max(50.0 * seq_rate, 100.0)
        gaps = rng.exponential(1.0 / lam, requests)
        t_sub, t_done, futs = {}, {}, []
        torch.cuda.synchronize()
        reset_launches()
        with pt.inject_faults("ksp.program=unavailable:at=3:iter=8"):
            t_start = time.monotonic()
            nxt = t_start
            for j in range(requests):
                nxt += gaps[j]
                delay = nxt - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                t_sub[j] = time.monotonic()
                f = srv.submit("poisson", rows[j])
                f.add_done_callback(
                    lambda _f, i=j: t_done.__setitem__(i, time.monotonic()))
                futs.append(f)
            res = [f.result(600) for f in futs]
            t_end = time.monotonic()
        check(srv.drain(600), "serving (a): the server did not drain")
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        stats = srv.stats()
        on_card = all(s.operator.comm.device.type == "cuda"
                      for s in srv._sessions.values())
    finally:
        srv.shutdown()
    check(on_card, "serving (a): a session is not on the card")
    check(all(r.converged for r in res),
          f"serving (a): reasons {[r.reason for r in res]}")
    t_rel = time.perf_counter()
    rel = served_relres(nx, rows, np.stack([r.x for r in res]), "cfg9")
    t_rel = time.perf_counter() - t_rel
    check(max(rel) <= 1.05 * SERVING_RTOL,
          f"serving (a): worst fp64 true relres {max(rel):.3e}")
    retried = [j for j, r in enumerate(res) if r.attempts > 1]
    check(retried, "serving (a): no request recovered from the fault")
    by_future = {id(f): r for f, r in zip(futs, res)}
    block_its = [max(by_future[i].iterations for i in b) for b in blocks]
    fault_its = 8 + 1
    want = sum(its + 1 for its in block_its) + fault_its
    got = launches.get("stencil7_dot_many", 0)
    check(got == want, f"serving (a): stencil7_dot_many launched {got}, "
                       f"expected {want} (blocks {block_its} + the faulted "
                       f"attempt's {fault_its})")
    check(not launches.get("stencil7_dot"),
          "serving (a): a served block took the single-RHS route")
    wall = t_end - t_start
    lat = [t_done[j] - t_sub[j] for j in range(requests)]
    out = {"card": card, "requests": requests, "wall_s": wall,
           "solves_per_s": requests / wall, "sequential_solves_per_s": seq_rate,
           "speedup": requests / wall / seq_rate,
           "p50_latency_ms": percentile_ms(lat, 50),
           "p99_latency_ms": percentile_ms(lat, 99),
           "mean_width": stats["mean_width"],
           "max_width": max(stats["width_hist"]),
           "width_hist": {str(k): v for k, v in stats["width_hist"].items()},
           "queue_wait_p50_ms": stats["queue_wait_p50_s"] * 1e3,
           "queue_wait_p99_ms": stats["queue_wait_p99_s"] * 1e3,
           "queue_wait_max_ms": stats["queue_wait_max_s"] * 1e3,
           "blocks": len(blocks), "block_max_iterations": block_its,
           "retried_requests": len(retried),
           "events": [e.kind for e in res[retried[0]].recovery_events],
           "worst_relres": max(rel), "launches": launches,
           "rhs_s": t_rows, "relres_s": t_rel}
    log(f"serving (a) cfg9 shape, {nx}^3 f32 CG+jacobi, {requests} requests "
        f"at {lam:.0f}/s ({card}): {out['solves_per_s']:.1f} solves/s "
        f"against {seq_rate:.1f} sequential ({out['speedup']:.2f}x), p50 "
        f"{out['p50_latency_ms']:.1f} ms, p99 {out['p99_latency_ms']:.1f} ms, "
        f"width mean {out['mean_width']:.2f} max {out['max_width']} "
        f"{out['width_hist']}, queue wait p50 {out['queue_wait_p50_ms']:.1f} "
        f"/ p99 {out['queue_wait_p99_ms']:.1f} / max "
        f"{out['queue_wait_max_ms']:.1f} ms; {len(blocks)} blocks, "
        f"{len(retried)} requests retried ({out['events']}), worst fp64 "
        f"relres {max(rel):.3e}; launches {launches} = sum(max its + 1) + "
        f"{fault_its}; right-hand sides {t_rows:.1f} s, host relres "
        f"{t_rel:.1f} s")
    return out, rows


def phase_serving_fused(card, rows, nx=SERVING_NX, k=SERVING_MAX_K):
    """(b) The same session shape with ``megasolve=True`` and
    ``-ksp_megasolve_stencil_fastpath``: ``k`` requests in one window ride
    one fused block, whose graphs the dispatcher thread captures; the
    served block is held bit for bit against the same program run
    uncaptured on the caller's thread."""
    import threading
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.serving import SolveServer
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    ms.clear_cache()
    captures = []
    capture = ms.MegasolveProgram._capture

    def recording(self, name, fn):
        captures.append((name, threading.current_thread().name))
        return capture(self, name, fn)

    ms.MegasolveProgram._capture = recording
    opts = pt.global_options()
    srv = SolveServer(comm, window=0.0, max_k=k, autostart=False)
    try:
        opts.set("ksp_megasolve_stencil_fastpath", "1")
        try:
            sess = srv.register_operator("fused", op, pc_type="jacobi",
                                         rtol=0.5 * SERVING_RTOL,
                                         max_it=20000, megasolve=True)
        finally:
            opts.clear("ksp_megasolve_stencil_fastpath")
        futs = [srv.submit("fused", rows[j]) for j in range(k)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        srv.start()
        res = [f.result(600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {kk: v for kk, v in read_launches().items() if v}
        check(srv.drain(600), "serving (b): the server did not drain")
        # a second block of the same width, its graphs captured: the window
        # holds its first request until the other seven are submitted (each
        # submit copies 8 MB), and the wall runs from the block's dispatch
        # to its last result
        srv.window = 0.5
        t_disp, t_done = [], []
        srv._dispatch_hook = lambda reqs: t_disp.append(time.perf_counter())
        wfuts = [srv.submit("fused", rows[k + j]) for j in range(k)]
        for f in wfuts:
            f.add_done_callback(lambda _f: t_done.append(time.perf_counter()))
        warm = [f.result(600) for f in wfuts]
        wall_warm = max(t_done) - t_disp[0]
        check(len(t_disp) == 1 and all(r.converged for r in warm)
              and all(r.batch_width == k for r in warm),
              f"serving (b): the warm burst took {len(t_disp)} blocks")
    finally:
        srv.shutdown()
        ms.MegasolveProgram._capture = capture
    prog = sess.ksp._megasolve_program(many_k=k)
    threads = {t for _, t in captures}
    check(sess.ksp.megasolve_stencil_fastpath, "serving (b): no fast path")
    check({"start", "chunk", "outer"} == set(prog.graphs)
          and len(captures) == 3 and threads == {"SolveServer-dispatch"},
          f"serving (b): captures {captures}, graphs {sorted(prog.graphs)}")
    B = np.stack(rows[:k], axis=1)
    X = np.zeros_like(B)
    prog.capture = False
    try:
        eager = sess.ksp.solve_many(B, X)
    finally:
        prog.capture = True
    served = np.stack([r.x for r in res], axis=1)
    same = bool(np.array_equal(served, X))
    check(same and eager.iterations == [r.iterations for r in res],
          "serving (b): the served block differs from the uncaptured run")
    check(all(r.converged for r in res), "serving (b): not converged")
    out = {"card": card, "wall_s": wall, "warm_wall_s": wall_warm,
           "warm_ms_per_iter": wall_warm / max(r.iterations for r in warm)
           * 1e3, "iterations": eager.iterations,
           "steps": eager.megasolve_steps, "replays": eager.replays,
           "captures": captures, "captured_equals_uncaptured": same,
           "launches": launches}
    log(f"serving (b) fused, {nx}^3 f32 k={k} ({card}): one block in "
        f"{wall * 1e3:.1f} ms (graphs captured there), a second "
        f"{wall_warm * 1e3:.1f} ms ({out['warm_ms_per_iter']:.4f} ms a "
        f"lockstep iteration, dispatch to the last result), iterations "
        f"{eager.iterations}, {eager.megasolve_steps} steps, captured by "
        f"{sorted(threads)} ({len(captures)} pieces), served == uncaptured "
        f"{same}; launches {launches}")
    return out


def phase_serving_persistent(card, nx=SERVING_NX, requests=PERSISTENT_REQUESTS,
                             q=PERSISTENT_Q):
    """(c) cfg17's shape (``benchmarks/run_all.py:2105-2221``) at 128^3
    fp64: ``requests`` seeded Poisson arrivals, each with its own rtol near
    1e-8, Q = 8 slots, the persistent program (fused, stencil fast path)
    against per-batch fused dispatch. Checks: ``persistent_serve``
    dispatches a request < 1, every answer's fp64 true relres within its
    own rtol, the per-batch mode ``requests`` launches."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.serving import SolveServer
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    from mpi_petsc4py_example_tpu_torch.utils.profiling import dispatch_counts
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float64)
    rows = stencil_rows(comm, op, requests, 17, torch.float64)
    rtol0 = 1e-8
    rtols = [rtol0 * (1.0 + j / (2.0 * requests)) for j in range(requests)]
    gaps = np.random.default_rng(17).exponential(0.0005, size=requests)
    opts = pt.global_options()
    out = {"card": card}

    def run(persistent):
        ms.clear_cache()
        srv = SolveServer(comm, window=0.002, max_k=q)
        try:
            opts.set("ksp_megasolve_stencil_fastpath", "1")
            try:
                srv.register_operator("p", op, pc_type="jacobi", rtol=rtol0,
                                      max_it=20000,
                                      megasolve=not persistent,
                                      persistent=persistent)
            finally:
                opts.clear("ksp_megasolve_stencil_fastpath")
            # warm pre-burst: the slot widths (persistent) or the width-1
            # block (per-batch) captured before the measured window
            for w in (q, 3, 1):
                ws = [srv.submit("p", rows[j % requests],
                                 rtol=rtols[j % requests]) for j in range(w)]
                [f.result(600) for f in ws]
                srv.drain(600)
            mid = dispatch_counts()
            torch.cuda.synchronize()
            reset_launches()
            t_sub, t_done, futs = {}, {}, []
            t0 = time.perf_counter()
            for j in range(requests):
                time.sleep(gaps[j])
                t_sub[j] = time.perf_counter()
                f = srv.submit("p", rows[j], rtol=rtols[j])
                f.add_done_callback(
                    lambda _f, i=j: t_done.__setitem__(
                        i, time.perf_counter()))
                futs.append(f)
            served = [f.result(600) for f in futs]
            check(srv.drain(600), "serving (c): the server did not drain")
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in read_launches().items() if v}
            after = dispatch_counts()
            stats = srv.stats()
        finally:
            srv.shutdown()
        disp = {k: int(after.get(k, 0) - mid.get(k, 0)) for k in after
                if after.get(k, 0) != mid.get(k, 0)}
        lat = [t_done[j] - t_sub[j] for j in range(requests)]
        row = {"wall_s": wall, "solves_per_s": requests / wall,
               "p50_latency_ms": percentile_ms(lat, 50),
               "p99_latency_ms": percentile_ms(lat, 99),
               "dispatches": disp,
               "dispatches_per_request": sum(disp.values()) / requests,
               "batches": stats["batches"], "launches": launches,
               "iterations": [r.iterations for r in served]}
        if persistent:
            row["persistent"] = dict(stats["persistent"]["p"])
        check(all(r.converged for r in served),
              f"serving (c): reasons {[r.reason for r in served]}")
        return row, np.stack([r.x for r in served])

    for mode in ("per_batch", "persistent"):
        row, X = run(mode == "persistent")
        t_rel = time.perf_counter()
        rel = served_relres(nx, rows, X, mode)
        row["relres_s"] = time.perf_counter() - t_rel
        bad = [j for j in range(requests) if rel[j] > 1.05 * rtols[j]]
        check(not bad, f"serving (c) {mode}: requests {bad} miss their rtol "
                       f"({[rel[j] for j in bad]})")
        row["worst_relres_over_rtol"] = max(
            rel[j] / rtols[j] for j in range(requests))
        out[mode] = row
        log(f"serving (c) cfg17 shape {mode}, {nx}^3 fp64, {requests} "
            f"requests, Q={q} ({card}): {row['dispatches']} dispatches "
            f"({row['dispatches_per_request']:.3f} a request), "
            f"{row['solves_per_s']:.1f} solves/s, p50 "
            f"{row['p50_latency_ms']:.1f} / p99 {row['p99_latency_ms']:.1f} "
            f"ms, worst relres/rtol {row['worst_relres_over_rtol']:.3f}, "
            f"{row.get('persistent', '')}; launches {row['launches']}; host "
            f"relres {row['relres_s']:.1f} s")
    per, pers = out["per_batch"], out["persistent"]
    check(per["dispatches"] == {"megasolve_many": requests},
          f"serving (c): per-batch dispatches {per['dispatches']}")
    check(set(pers["dispatches"]) == {"persistent_serve"}
          and pers["dispatches_per_request"] < 1.0,
          f"serving (c): persistent dispatches {pers['dispatches']}")
    return out


def phase_serving():
    """The serving layer's phases (a)-(c) at the repo's 128^3 width, each
    logged with the card's name and power limit; returns their records and
    the launch counts of rows 9 and 10 on the served paths."""
    import torch
    card = card_line()
    t0 = time.perf_counter()
    for i in range(ORACLE_WORKERS):
        host_oracle(oracle_ready, i)     # the workers start beside (a)
    cfg9, rows = timed(phase_serving_cfg9, card)
    fused = timed(phase_serving_fused, card, rows)
    del rows
    torch.cuda.empty_cache()
    persistent = timed(phase_serving_persistent, card)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"serving phases: {wall:.1f} s ({card})")
    launches = {
        "stencil7_dot_many": (
            cfg9["launches"]["stencil7_dot_many"],
            f"128^3 f32 SolveServer, {SERVING_REQUESTS} requests, cfg9 "
            "shape (the batched fast path)"),
        "stencil7_apply_many": (
            persistent["persistent"]["launches"].get("stencil7_apply_many", 0),
            f"128^3 fp64 SolveServer, persistent program, "
            f"{PERSISTENT_REQUESTS} requests (the outer true residual)")}
    return {"cfg9": cfg9, "fused": fused, "persistent": persistent,
            "wall_s": wall}, launches


# ---- the fleet (ROADMAP Queue A item 7.2: fleet, transport, remote) --------

FLEET_NX = 128          # cfg14's shape (run_all.py:1614) at the repo's width
FLEET_REQUESTS = 48     # through fleets of 1 and 2 replicas (cfg14: 96)
FLEET_QOS = (32, 8)     # bulk, then interactive (cfg14: 64 + 16)
FLEET_ELASTIC = 16      # before and after the heal (cfg14: 32 + 32)
# the assembled sessions (cfg14's: a 16^3 CSR): 64^3 keeps the migration's
# checkpoint and the elastic rebuilds inside the phases' 60 s (at 128^3 the
# elastic phase took 24.4 s on an H100 80GB HBM3 at 700 W)
FLEET_AIJ_NX = 64
REMOTE_NX = 64          # cfg18's shape (run_all.py:2244) in 3D: fp64 AIJ
REMOTE_RTOL = 1e-10
# sequential, a transport (cfg18: 32): each answer waits for the host's
# checkpoint rewrite, 1.0-1.1 s at 64^3 fp64 on the H100 machine's CPU
REMOTE_REQUESTS = 4


def fleet_policy():
    import mpi_petsc4py_example_tpu_torch as pt
    return pt.RetryPolicy(base_delay=0.01, max_delay=0.1)


def timed_futures(submit, items):
    """Submit ``items`` through ``submit`` at once; ``(results, latencies,
    wall)`` on the host monotonic clock, each latency from its submit to
    its future's resolution."""
    t_sub, t_done, futs = {}, {}, []
    t0 = time.monotonic()
    for j, item in enumerate(items):
        t_sub[j] = time.monotonic()
        f = submit(*item)
        f.add_done_callback(
            lambda _f, i=j: t_done.__setitem__(i, time.monotonic()))
        futs.append(f)
    res = [f.result(600) for f in futs]
    wall = time.monotonic() - t0
    while len(t_done) < len(futs):     # a callback may run after result()
        time.sleep(0.001)
    return res, [t_done[j] - t_sub[j] for j in range(len(futs))], wall


def phase_fleet_routing(card, rows, nx=FLEET_NX, requests=FLEET_REQUESTS):
    """(a1) cfg14's routing and scaling on the 128^3 f32 stencil: sessions
    op0..op3 (op3 fused, ``megasolve=True`` with the stencil fast path, its
    widths 4 and 8 captured at registration), CG + Jacobi at rtol 0.5e-6,
    ``window`` 2 ms, ``max_k`` 8, ``requests`` submitted at once through a
    ``SolveRouter`` of 1 and then 2 replicas (one card: a comparison, no
    scaling claim). Every answer's fp64 true relres <= 1.05e-6; the launch
    counters zeroed just before each fleet's traffic and read after. Returns
    the records and the 2-replica router, left serving for (a2) and (a3)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.serving import SolveRouter
    from mpi_petsc4py_example_tpu_torch.solvers import megasolve as ms
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    names = [f"op{i}" for i in range(4)]
    opts = pt.global_options()
    out, keep = {}, None
    for n in (1, 2):
        ms.clear_cache()
        rt = SolveRouter(n, comm, window=0.002, max_k=SERVING_MAX_K,
                         retry_policy=fleet_policy())
        try:
            t_reg = time.perf_counter()
            for i, name in enumerate(names):
                fused = i == 3
                if fused:
                    opts.set("ksp_megasolve_stencil_fastpath", "1")
                try:
                    rt.register_operator(
                        name, op, pc_type="jacobi", rtol=0.5 * SERVING_RTOL,
                        max_it=20000, megasolve=fused,
                        warm_widths=(4, SERVING_MAX_K) if fused else ())
                finally:
                    opts.clear("ksp_megasolve_stencil_fastpath")
            t_reg = time.perf_counter() - t_reg
            torch.cuda.synchronize()
            reset_launches()
            res, lat, wall = timed_futures(
                rt.submit, [(names[j % 4], rows[j]) for j in range(requests)])
            check(rt.drain(600), f"fleet (a1) n={n}: did not drain")
            torch.cuda.synchronize()
            launches = {k: v for k, v in read_launches().items() if v}
            stats = rt.stats()
        except BaseException:
            rt.shutdown(wait=False)
            raise
        if n == 2:
            keep = rt
        else:
            rt.shutdown()
        check(all(r.converged for r in res),
              f"fleet (a1) n={n}: reasons {[r.reason for r in res]}")
        t_rel = time.perf_counter()
        rel = served_relres(nx, rows[:requests], np.stack([r.x for r in res]),
                            f"fleet{n}")
        t_rel = time.perf_counter() - t_rel
        check(max(rel) <= 1.05 * SERVING_RTOL,
              f"fleet (a1) n={n}: worst fp64 true relres {max(rel):.3e}")
        per = stats["per_replica"]
        row = {"replicas": n, "requests": requests, "wall_s": wall,
               "solves_per_s": requests / wall,
               "p50_latency_ms": percentile_ms(lat, 50),
               "p99_latency_ms": percentile_ms(lat, 99),
               "placement": stats["placement"],
               "requests_by_replica": {k: v["requests"]
                                       for k, v in per.items()},
               "blocks_by_replica": {k: v["batches"] for k, v in per.items()},
               "width_hist": {k: {str(w): c for w, c in
                                  v["width_hist"].items()}
                              for k, v in per.items()},
               "worst_relres": max(rel), "launches": launches,
               "register_s": t_reg, "relres_s": t_rel}
        out[n] = row
        log(f"fleet (a1) {nx}^3 f32, {n} replica(s), {requests} requests "
            f"over op0..op3 (op3 fused) ({card}): {row['solves_per_s']:.1f} "
            f"solves/s, p50 {row['p50_latency_ms']:.1f} / p99 "
            f"{row['p99_latency_ms']:.1f} ms, placement {row['placement']}, "
            f"blocks {row['blocks_by_replica']}, widths {row['width_hist']}, "
            f"worst fp64 relres {max(rel):.3e}; launches {launches}; "
            f"registration {t_reg:.1f} s, host relres {t_rel:.1f} s")
        check(launches.get("stencil7_dot_many", 0) > 0
              and launches.get("stencil7_apply_many", 0) > 0,
              f"fleet (a1) n={n}: rows 9/10 not both launched: {launches}")
    check(len(set(out[2]["placement"].values())) == 2,
          f"fleet (a1): the 4 sessions on one of 2 replicas "
          f"{out[2]['placement']}")
    return out, keep


def phase_fleet_qos(card, rt, rows, bulk=FLEET_QOS[0],
                    interactive=FLEET_QOS[1]):
    """(a2) cfg14's overload QoS on op0 of the 2-replica fleet: ``bulk``
    requests, then ``interactive`` ones, submitted at once; interactive p99
    latency below bulk's (cfg14 folds it into parity)."""
    items = ([("op0", rows[j % len(rows)], "bulk") for j in range(bulk)]
             + [("op0", rows[j % len(rows)], "interactive")
                for j in range(interactive)])
    res, lat, wall = timed_futures(
        lambda op, b, q: rt.submit(op, b, qos=q), items)
    check(all(r.converged for r in res), "fleet (a2): not converged")
    lb, li = lat[:bulk], lat[bulk:]
    out = {"bulk": bulk, "interactive": interactive, "wall_s": wall,
           "bulk_p50_ms": percentile_ms(lb, 50),
           "bulk_p99_ms": percentile_ms(lb, 99),
           "interactive_p50_ms": percentile_ms(li, 50),
           "interactive_p99_ms": percentile_ms(li, 99),
           "qos_hist": rt.replica(rt.owner("op0")).stats()["qos_hist"]}
    log(f"fleet (a2) QoS on op0, {bulk} bulk + {interactive} interactive "
        f"({card}): interactive p50/p99 {out['interactive_p50_ms']:.1f}/"
        f"{out['interactive_p99_ms']:.1f} ms, bulk "
        f"{out['bulk_p50_ms']:.1f}/{out['bulk_p99_ms']:.1f} ms, "
        f"{wall:.2f} s")
    check(out["interactive_p99_ms"] < out["bulk_p99_ms"],
          f"fleet (a2): interactive p99 {out['interactive_p99_ms']:.1f} ms "
          f"not below bulk's {out['bulk_p99_ms']:.1f} ms")
    return out


def phase_fleet_migration(card, rt, nx=FLEET_AIJ_NX, load=8):
    """(a3) migrate an assembled session under load: the ``nx^3`` f32 AIJ,
    CG + Jacobi, on the 2-replica fleet; one request before, ``load``
    queued when the move starts, ``load`` more submitted while it runs
    (held, replayed on the destination), one after. Checks: every future
    resolves with an fp64 true relres <= 1.05e-6, some were held, the
    session moved, and the requests before and after the move (the same
    right-hand side) take equal iterations."""
    import threading
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    A = pt.poisson3d_csr(nx)
    rng = np.random.default_rng(21)
    B = np.stack([(A @ rng.random(A.shape[0])).astype(np.float32)
                  for _ in range(load)])
    t_reg = time.perf_counter()
    rt.register_operator("mig", A, dtype=torch.float32, pc_type="jacobi",
                         rtol=0.5 * SERVING_RTOL, max_it=20000)
    t_reg = time.perf_counter() - t_reg
    src = rt.owner("mig")
    dst = next(r for r in rt.replicas() if r != src)
    before = rt.solve("mig", B[0], timeout=600)
    queued = [rt.submit("mig", b) for b in B]
    t0 = time.perf_counter()
    mig = threading.Thread(target=rt.migrate, args=("mig", dst))
    mig.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and "mig" not in rt._migrating:
        time.sleep(0.001)
    held = [rt.submit("mig", b) for b in B]
    with rt._lock:
        n_held = len(rt._held.get("mig", []))
    mig.join(600)
    move_s = time.perf_counter() - t0
    check(not mig.is_alive(), "fleet (a3): the migration did not end")
    res = [f.result(600) for f in queued + held]
    after = rt.solve("mig", B[0], timeout=600)
    rel = [true_relres(A, r.x, b) for r, b in zip(res, list(B) * 2)]
    rel += [true_relres(A, r.x, B[0]) for r in (before, after)]
    out = {"nx": nx, "src": src, "dst": dst, "owner": rt.owner("mig"),
           "held": n_held, "move_s": move_s, "register_s": t_reg,
           "iterations_before": before.iterations,
           "iterations_after": after.iterations,
           "load_iterations": [r.iterations for r in res],
           "worst_relres": max(rel)}
    log(f"fleet (a3) migration of a {nx}^3 f32 AIJ session {src} -> {dst} "
        f"under load ({card}): {n_held} of {load} mid-move submissions held "
        f"and replayed, the move (drain, checkpoint, reload, register) "
        f"{move_s:.2f} s, iterations before/after {before.iterations}/"
        f"{after.iterations}, load {out['load_iterations']}, worst fp64 "
        f"relres {max(rel):.3e}; registration {t_reg:.2f} s")
    check(out["owner"] == dst and n_held > 0,
          f"fleet (a3): owner {out['owner']}, held {n_held}")
    check(before.iterations == after.iterations,
          f"fleet (a3): iterations {before.iterations} before, "
          f"{after.iterations} after the move")
    check(all(r.converged for r in res) and max(rel) <= 1.05 * SERVING_RTOL,
          f"fleet (a3): worst fp64 relres {max(rel):.3e}")
    return out


def phase_fleet_elastic(card, nx=FLEET_AIJ_NX, requests=FLEET_ELASTIC):
    """(a4) cfg14's elastic round trip: one replica on ``DeviceComm(4)``
    holding the ``nx^3`` f32 AIJ, CG + Jacobi; ``requests`` under
    ``device.lost=unavailable:device=3:at=1:iter=6``, then ``heal()`` and
    ``heal_check()``, then ``requests`` more. Checks: the shrink resumed
    past iteration 0, the replica grew back to 4 shards, every future
    resolves with an fp64 true relres <= 1.05e-6."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.resilience import faults
    from mpi_petsc4py_example_tpu_torch.serving import SolveRouter
    A = pt.poisson3d_csr(nx)
    rng = np.random.default_rng(23)
    B = np.stack([(A @ rng.random(A.shape[0])).astype(np.float32)
                  for _ in range(requests)])
    rt = SolveRouter(1, pt.DeviceComm(4), window=0.002, max_k=SERVING_MAX_K,
                     retry_policy=fleet_policy())
    try:
        t_reg = time.perf_counter()
        rt.register_operator("aij", A, dtype=torch.float32, pc_type="jacobi",
                             rtol=0.5 * SERVING_RTOL, max_it=20000)
        t_reg = time.perf_counter() - t_reg
        t0 = time.perf_counter()
        with faults.inject_faults("device.lost=unavailable:device=3:at=1"
                                  ":iter=6"):
            res1, lat1, wall1 = timed_futures(
                rt.submit, [("aij", b) for b in B])
        shrunk = rt.stats()
        faults.heal()
        t_heal = time.perf_counter()
        grew = rt.heal_check()
        heal_s = time.perf_counter() - t_heal
        res2, lat2, wall2 = timed_futures(rt.submit, [("aij", b) for b in B])
        grown = rt.stats()
        wall = time.perf_counter() - t0
    finally:
        faults.heal()
        rt.shutdown(wait=False)
    rel = [true_relres(A, r.x, b) for r, b in zip(res1 + res2, list(B) * 2)]
    sh = shrunk["per_replica"]["r0"]["mesh_shrinks"]
    rg = grown["per_replica"]["r0"]["mesh_regrows"]
    out = {"shrinks": [(e["old_devices"], e["new_devices"],
                        e["resumed_iteration"]) for e in sh],
           "regrows": [(e["old_devices"], e["new_devices"]) for e in rg],
           "devices_after": grown["per_replica"]["r0"]["devices"],
           "heal_check": grew, "heal_s": heal_s, "register_s": t_reg,
           "p99_before_ms": percentile_ms(lat1, 99),
           "p99_after_ms": percentile_ms(lat2, 99),
           "wall_before_s": wall1, "wall_after_s": wall2,
           "worst_relres": max(rel), "wall_s": wall,
           "attempts": max(r.attempts for r in res1)}
    log(f"fleet (a4) elastic {nx}^3 f32 AIJ on DeviceComm(4), {requests} + "
        f"{requests} requests ({card}): shrinks {out['shrinks']} (old, new, "
        f"resumed iteration), heal_check {grew} in {heal_s:.2f} s, regrows "
        f"{out['regrows']}, {out['devices_after']} shards after; p99 "
        f"{out['p99_before_ms']:.1f} ms under the loss, "
        f"{out['p99_after_ms']:.1f} ms after; worst fp64 relres "
        f"{max(rel):.3e}; {wall:.1f} s, registration {t_reg:.1f} s")
    check(len(sh) == 1 and sh[0]["resumed_iteration"] > 0,
          f"fleet (a4): shrinks {out['shrinks']}")
    check(grew == 1 and out["regrows"] == [(sh[0]["new_devices"], 4)]
          and out["devices_after"] == 4,
          f"fleet (a4): regrows {out['regrows']}, heal_check {grew}")
    check(all(r.converged for r in res1 + res2)
          and max(rel) <= 1.05 * SERVING_RTOL,
          f"fleet (a4): worst fp64 relres {max(rel):.3e}")
    return out


def phase_fleet_remote(card, transport, nx=REMOTE_NX,
                       requests=REMOTE_REQUESTS):
    """(b) cfg18's shape over one transport: a 2-host ``FleetManager`` on
    the card, the ``nx^3`` fp64 AIJ Poisson, CG + Jacobi at rtol 1e-10,
    ``requests`` sequential solves, each followed by the host's checkpoint
    rewrite; then one ``lease_step()``, the owner killed, and two of the
    requests again, the first through the failover. Checks: every answer's fp64 true
    relres <= 1.05 rtol, resumed past iteration 0 on the survivor, one
    owner; logs the wall from the kill to the first re-homed answer."""
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.serving import FleetManager
    A = pt.poisson3d_csr(nx)
    rng = np.random.default_rng(18)
    B = [A @ rng.random(A.shape[0]) for _ in range(requests)]
    mgr = FleetManager(2, pt.DeviceComm(), transport=transport, window=0.0,
                       max_k=SERVING_MAX_K, retry_policy=fleet_policy())
    try:
        t_reg = time.perf_counter()
        mgr.register_operator("p", A, pc_type="jacobi", rtol=REMOTE_RTOL,
                              max_it=20000)
        t_reg = time.perf_counter() - t_reg
        owner = mgr.router.owner("p")
        lat, res = [], []
        t0 = time.perf_counter()
        for b in B:
            t = time.perf_counter()
            res.append(mgr.solve("p", b, timeout=600))
            lat.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        refresh = list(mgr.hosts[owner].refresh_seconds)
        mgr.lease_step()
        t_kill = time.perf_counter()
        mgr.kill_host(owner)
        first = mgr.solve("p", B[0], timeout=600)
        failover_s = time.perf_counter() - t_kill
        again = [first, mgr.solve("p", B[1], timeout=600)]
        ev = mgr.failovers[0] if mgr.failovers else None
        survivor = mgr.router.owner("p")
        resident = {name: stub.client.call("resident", {}, deadline=30.0)
                    for name, stub in mgr.stubs.items() if name != owner}
        lease = mgr.lease_table()
    finally:
        mgr.shutdown(wait=False)
    rel = [true_relres(A, r.x, b) for r, b in zip(res + again, B + B[:2])]
    out = {"transport": transport, "requests": requests, "wall_s": wall,
           "solves_per_s": requests / wall,
           "p50_latency_ms": percentile_ms(lat, 50),
           "p99_latency_ms": percentile_ms(lat, 99),
           "refresh_ms_mean": 1e3 * sum(refresh) / max(1, len(refresh)),
           "refresh_ms_max": 1e3 * max(refresh, default=0.0),
           "refreshes": len(refresh), "register_s": t_reg,
           "iterations": sorted({r.iterations for r in res}),
           "owner": owner, "survivor": survivor,
           "resumed_iteration": ev.resumed_iteration if ev else 0,
           "failover_event_s": ev.wall_s if ev else None,
           "kill_to_answer_s": failover_s,
           "iterations_after": [r.iterations for r in again],
           "worst_relres": max(rel)}
    log(f"fleet (b) cfg18 shape, {nx}^3 fp64 AIJ, 2 hosts over {transport} "
        f"({card}): {requests} sequential requests {out['solves_per_s']:.2f} "
        f"solves/s, p50 {out['p50_latency_ms']:.1f} / p99 "
        f"{out['p99_latency_ms']:.1f} ms, iterations {out['iterations']}, "
        f"checkpoint refresh {out['refresh_ms_mean']:.1f} ms a request (max "
        f"{out['refresh_ms_max']:.1f}, {len(refresh)} refreshes); owner "
        f"{owner} killed after a lease step: first re-homed answer "
        f"{failover_s * 1e3:.1f} ms after the kill (failover "
        f"{(out['failover_event_s'] or 0) * 1e3:.1f} ms), resumed at "
        f"iteration {out['resumed_iteration']} on {survivor}, iterations "
        f"after {out['iterations_after']}; worst fp64 relres "
        f"{max(rel):.3e}; registration {t_reg:.2f} s")
    check(ev is not None and ev.resumed_iteration > 0
          and ev.sessions == ("p",),
          f"fleet (b) {transport}: failover {ev}")
    check(survivor != owner and lease[owner]["status"] == "dead"
          and [n for n, ops in resident.items() if "p" in ops] == [survivor],
          f"fleet (b) {transport}: owner {survivor}, resident {resident}")
    check(max(rel) <= 1.05 * REMOTE_RTOL,
          f"fleet (b) {transport}: worst fp64 relres {max(rel):.3e}")
    check(len(refresh) == requests,
          f"fleet (b) {transport}: {len(refresh)} refreshes")
    return out


def phase_fleet():
    """The fleet's phases (a1)-(a4) and (b), each logged with the card's
    name and power limit and timed; returns their records and the launch
    counts of rows 9 and 10 on the routed path ((a1), 2 replicas)."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    card = card_line()
    t0 = time.perf_counter()
    for i in range(ORACLE_WORKERS):
        host_oracle(oracle_ready, i)     # the workers start beside (a1)
    comm = pt.DeviceComm()
    op = pt.StencilPoisson3D(comm, FLEET_NX, dtype=torch.float32)
    rows = stencil_rows(comm, op, FLEET_REQUESTS, 14, torch.float32)
    del op
    out = {}
    routing, rt = timed(phase_fleet_routing, card, rows)
    out["a1_routing"] = routing
    try:
        out["a2_qos"] = timed(phase_fleet_qos, card, rt, rows)
        out["a3_migration"] = timed(phase_fleet_migration, card, rt)
    finally:
        rt.shutdown(wait=False)
    del rows
    torch.cuda.empty_cache()
    out["a4_elastic"] = timed(phase_fleet_elastic, card)
    torch.cuda.empty_cache()
    out["b_remote"] = {tr: timed(phase_fleet_remote, card, tr)
                       for tr in ("loopback", "socket")}
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"fleet phases: {out['wall_s']:.1f} s ({card})")
    a1 = routing[2]["launches"]
    launches = {
        "stencil7_dot_many": (
            a1.get("stencil7_dot_many", 0),
            f"128^3 f32 SolveRouter of 2 replicas, {FLEET_REQUESTS} requests "
            "over 4 sessions, cfg14 shape (the batched fast path)"),
        "stencil7_apply_many": (
            a1.get("stencil7_apply_many", 0),
            "128^3 f32 SolveRouter of 2 replicas, the fused session op3's "
            "blocks (megasolve, the outer true residual)")}
    return out, launches


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
    if sys.argv[1:] == ["--stencil7"]:
        # only rows 1, 2, 9 and 10: checks, times in f32 and f64, the main
        # path's ms/iter; e.g. to time another checkout's csrc/ with this
        # script copied beside it
        print(json.dumps({"stencil7": phase_stencil7()}, default=float))
        print(card_line())
        return
    if sys.argv[1:] == ["--eps"]:
        # only the eigensolver slice's phases
        check(phase_kernel_checks() is not None, "kernel checks")
        launches_eps, _ = phase_eps()
        check(launches_eps > 0, "stencil7_apply never launched on the EPS path")
        print(card_line())
        return
    if sys.argv[1:] == ["--eps-types"]:
        # only the other eigensolver types' and SVD's phases (a)-(g),
        # behind the checks of the two kernels they launch (rows 2 and 9)
        start_lapack_oracles()
        phase_kernel_checks()
        phase_many_kernel_checks()
        eps_types, launches = phase_eps_types()
        for name, (count, path) in launches.items():
            check(count > 0, f"{name} was not launched on {path}")
        print(json.dumps({"eps_types": eps_types, "launches_eps_types": {
            name: count for name, (count, _) in launches.items()}},
            default=float))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--gd-sizes"]:
        # GD's convergence against the cube's size, each under a 20 s
        # budget: the evidence for GD_NX
        print(json.dumps({"gd_sizes": phase_gd_sizes()}, default=float))
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
    if sys.argv[1:] == ["--procs"]:
        # only the process communicator's phases, behind the kernel checks
        phase_kernel_checks()
        phase_mg_kernel_checks()
        phase_many_kernel_checks()
        print(json.dumps({"procs": phase_procs()}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--procs-cards"]:
        # one rank per card over NCCL, on a host of several cards
        print(json.dumps({"procs_cards": phase_procs_cards()}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--nccl-capture"]:
        # a diagnosis of CUDA graph capture over NCCL, one rank per card
        print(json.dumps({"nccl_capture": phase_nccl_capture()}))
        print(card_line())
        return
    if sys.argv[1:] == ["--nccl-capture-release"]:
        # the same, the graphs dropped before the ranks' teardown
        print(json.dumps({"nccl_capture": phase_nccl_capture(
            modes=("global",), release=True, stage_s=15)}))
        print(card_line())
        return
    if sys.argv[1:] == ["--ksp-types"]:
        # only the Krylov types' phases, behind the checks of the kernels
        # they launch (rows 1, 2, 9, 2b and 9b)
        phase_kernel_checks()
        phase_many_kernel_checks()
        phase_bf16_kernel_checks()
        print(json.dumps({"ksp_types": phase_ksp_types()}, default=float))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--megasolve"]:
        # only this slice's phases: rows 3b-6b, PC mg under bf16
        # refinement, the fused program and the reduction plan selection
        entries, mega = phase_megasolve()
        print(json.dumps({"megasolve": mega}, default=float))
        print(json.dumps({"kernels": entries}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--telemetry"]:
        # only the telemetry layer's phases (t1)-(t2), behind the checks
        # of the kernels they launch (rows 1 and 2)
        phase_kernel_checks()
        print(json.dumps({"telemetry": timed(phase_telemetry)},
                         default=float))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--complex"]:
        # only the complex-scalar slice's phase (no kernel on its path)
        print(json.dumps({"complex": phase_complex()}, default=float))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--resilience"]:
        # only the resilience slice's phases (a)-(f), behind the checks of
        # the kernels they launch (rows 1, 2, 9)
        phase_kernel_checks()
        phase_many_kernel_checks()
        t0 = time.perf_counter()
        print(json.dumps({"resilience": phase_resilience()}, default=float))
        log(f"resilience phases: {time.perf_counter() - t0:.1f} s")
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--serving"]:
        # only the serving layer's phases (a)-(c), behind the checks of the
        # two kernels they launch (rows 9 and 10)
        phase_many_kernel_checks()
        serving, launches = phase_serving()
        for name, (count, path) in launches.items():
            check(count > 0, f"{name} was not launched on {path}")
        print(json.dumps({"serving": serving, "launches_serving": {
            name: count for name, (count, _) in launches.items()}},
            default=float))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--fleet"]:
        # only the fleet's phases (a1)-(a4) and (b), behind the checks of the
        # two kernels the routed sessions launch (rows 9 and 10)
        phase_many_kernel_checks()
        fleet, launches = phase_fleet()
        for name, (count, path) in launches.items():
            check(count > 0, f"{name} was not launched on {path}")
        print(json.dumps({"fleet": fleet, "launches_fleet": {
            name: count for name, (count, _) in launches.items()}},
            default=float))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["--refine"]:
        # only the mixed-precision slice's phases
        entries, refine = phase_refine()
        print(json.dumps({"kernels": entries, "refine": refine}))
        print(card_line())
        return
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    start_host_oracles()
    t_phase = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        log(f"timeline: {label} ended at {now - t_start:.1f} s "
            f"({now - t_phase[0]:.1f} s)")
        t_phase[0] = now
    worst = timed(phase_kernel_checks)
    worst.update(phase_mg_kernel_checks())
    times = {n: phase_kernel_times(n) for n in (128, 512)}
    for n in (128, 512):
        times[n].update(phase_mg_kernel_times(n))
    levels = timed(phase_mg_level_times)
    lap("kernel checks and times")
    # each path: counters zeroed just before, read just after
    launches, oracle = timed(phase_main_path)
    launches_512 = timed(phase_realistic)
    launches_mg = timed(phase_mg_main_path, oracle)
    launches_mg_512 = timed(phase_mg_realistic)
    launches_slab = timed(phase_mg_slab)
    worst.update(phase_many_kernel_checks())
    for n in (128, 512):
        times[n].update(phase_many_kernel_times(n))
    launches_many, many_ctx = timed(phase_many_main_path, oracle)
    launches_general = timed(phase_many_general_route, many_ctx)
    timed(phase_many_mixed, many_ctx)
    del many_ctx
    launches_many_512 = timed(phase_many_realistic)
    lap("stencil, mg and batched paths")
    # the assembled-matrix slice: no kernel of its own (its products are
    # torch index and slice ops), so no counter to read
    t_aij = time.perf_counter()
    timed(phase_aij_main, oracle)
    timed(phase_aij_cfg1)
    timed(phase_aij_ell)
    timed(phase_aij_cfg3)
    timed(phase_aij_cfg4)
    timed(phase_aij_many)
    timed(phase_aij_reference_flow, flows=False)
    log(f"assembled-matrix phases: {time.perf_counter() - t_aij:.1f} s")
    lap("assembled matrices")
    # the eigensolver slice: its operator applies are stencil7_apply's; the
    # dense references of the next slice's phases start beside it
    start_lapack_oracles()
    launches_eps, apply_f64 = timed(phase_eps, flows=False)
    lap("eigensolver")
    # the other eigensolver types and SVD (items 7.5, 7.7): rows 9 and 2
    eps_types, eps_types_launches = phase_eps_types(advanced=False,
                                                    gd_nx=GD_NX_FULL)
    print(json.dumps({"eps_types": eps_types}, default=float))
    lap("eigensolver types and SVD")
    # the mixed-precision slice: the bfloat16 instantiations of four kernels
    bf16_entries, _ = timed(phase_refine)
    lap("mixed precision")
    # the direct solves past the dense cap and the block PCs: no kernel
    timed(phase_direct)
    lap("direct solves")
    # the KSP/PC/Mat/Vec surface: its new paths launch rows 1, 2, 9 and 10
    surface = timed(phase_surface)
    lap("surface")
    # the process communicator: rows 1-10 per local shard in rank processes;
    # its launches carry the fused program's and the resilience slice's
    # process cases, and start the thread-mode test.py/test2.py flows too
    procs = phase_procs(res_cases=RES_PROCS_CASES, mega=True,
                        flows=flow_specs("test.py", procs=False)
                        + flow_specs("test2.py", procs=False))
    print(json.dumps({"procs": procs}))
    lap("process communicator")
    # the Krylov types of item 5: rows 1, 2, 9, 2b and 9b
    ksp_types = phase_ksp_types(oracle)
    print(json.dumps({"ksp_types": ksp_types}, default=float))
    lap("Krylov types")
    # the bf16 V-cycle (rows 3b-6b), the fused program, -ksp_reduction_auto
    vcycle_entries, mega = phase_megasolve(procs=procs.pop("megasolve"))
    print(json.dumps({"megasolve": mega}, default=float))
    lap("bf16 V-cycle and fused program")
    # the telemetry layer (item 6.2): no kernel of its own
    print(json.dumps({"telemetry": timed(phase_telemetry)}, default=float))
    lap("telemetry")
    # complex scalars (item 5.6): no kernel on the path, none may launch
    complex_ = phase_complex()
    print(json.dumps({"complex": complex_}, default=float))
    lap("complex scalars")
    # the resilience layer (item 6): rows 1, 2 and 9 on the guarded paths
    res = phase_resilience(full=True)
    print(json.dumps({"resilience": res}, default=float))
    lap("resilience")
    # the serving layer (item 7, first half): rows 9 and 10 on served blocks
    serving, serving_launches = phase_serving()
    print(json.dumps({"serving": serving}, default=float))
    lap("serving")
    # the fleet (item 7.2): rows 9 and 10 on the routed sessions' blocks
    fleet, fleet_launches = phase_fleet()
    print(json.dumps({"fleet": fleet}, default=float))
    lap("fleet")
    chaos = res["c_chaos"]
    guarded_launches = {
        "stencil7_dot": (res["a_guarded_512"]["abft"]["stencil7_dot"],
                         "512^3 f32 CG+jacobi, -ksp_abft"),
        "stencil7_apply": (
            chaos["pc.apply bitflip"]["launches"]["stencil7_apply"],
            "128^3 fp64 guarded CG, general route, resilient_solve of a "
            "pc.apply bitflip"),
        "stencil7_apply_many": (
            chaos["many spmv.result=bitflip"]["launches"][
                "stencil7_apply_many"],
            f"128^3 fp64 k={K_BATCH} guarded solve_many, "
            "resilient_solve_many of a spmv.result bitflip")}
    ksp_launches = {
        "stencil7_apply": (
            ksp_types["128"]["pipecg"]["launches"]["stencil7_apply"],
            f"128^3 f32 pipecg+jacobi (max_it {KSP_MAX_IT_REPORTED})"),
        "stencil7_apply_many": (
            ksp_types["many"]["pipecg"]["stencil7_apply_many"],
            f"128^3 f32 k={K_BATCH} solve_many pipecg+jacobi"),
        "stencil7_apply_bf16": (
            ksp_types["bf16"]["pipecg"]["stencil7_apply_bf16"],
            "128^3 bf16 pipecg+jacobi"),
        "stencil7_apply_many_bf16": (
            ksp_types["bf16"]["pipecg k=8"]["stencil7_apply_many_bf16"],
            f"128^3 bf16 k={K_BATCH} solve_many pipecg+jacobi")}
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
            # the same Krylov-Schur on the process comm (NCCL, 1 process x
            # 4 shards): this process's launches
            kernels[-1]["launches_procs"] = procs["a"]["eps"]["launches"]
            kernels[-1]["path_procs"] = ("128^3 fp64 Krylov-Schur ncv 16, "
                                         "ProcessComm NCCL 1 x 4")
        if name == "stencil7_dot_many":
            kernels[-1]["dot_rel_err"] = worst["dot_many_rel"]
        if name in surface_launches:
            count_s, path_s = surface_launches[name]
            check(count_s > 0, f"{name} was not launched on {path_s}")
            kernels[-1]["launches_surface"] = count_s
            kernels[-1]["path_surface"] = path_s
    for entry in kernels:
        if entry["name"] in serving_launches:
            count_v, path_v = serving_launches[entry["name"]]
            check(count_v > 0, f"{entry['name']} was not launched on "
                               f"{path_v}")
            entry["launches_serving"] = count_v
            entry["path_serving"] = path_v
        if entry["name"] in fleet_launches:
            count_f, path_f = fleet_launches[entry["name"]]
            check(count_f > 0, f"{entry['name']} was not launched on "
                               f"{path_f}")
            entry["launches_fleet"] = count_f
            entry["path_fleet"] = path_f
        if entry["name"] in eps_types_launches:
            count_e, path_e = eps_types_launches[entry["name"]]
            check(count_e > 0, f"{entry['name']} was not launched on "
                               f"{path_e}")
            entry["launches_eps_types"] = count_e
            entry["path_eps_types"] = path_e
            if entry["name"] == "stencil7_apply_many":
                entry["eps_types_128_f64_k9"] = eps_types["apply_many_f64"]
        if entry["name"] in guarded_launches:
            count_g, path_g = guarded_launches[entry["name"]]
            check(count_g > 0, f"{entry['name']} was not launched on "
                               f"{path_g}")
            entry["launches_guarded"] = count_g
            entry["path_guarded"] = path_g
    for entry in kernels + bf16_entries:
        if entry["name"] in ksp_launches:
            count_k, path_k = ksp_launches[entry["name"]]
            check(count_k > 0, f"{entry['name']} was not launched on "
                               f"{path_k}")
            entry["launches_ksp_types"] = count_k
            entry["path_ksp_types"] = path_k
    for entry in bf16_entries:
        check(entry["launches"] > 0, f"{entry['name']} was not launched on "
                                     f"its path ({entry['path']})")
    kernels += bf16_entries + vcycle_entries
    check(len(kernels) == 17, f"{len(kernels)} kernel entries, not 17")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_background()
