#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mpi_petsc4py_example_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a, into
``build/torch_kernels/``), holds every kernel against its plain PyTorch version
on the card, times them, drives the port's main path (CG + Jacobi on the 7-point
3D Poisson stencil, fp32, 128^3, rtol 1e-6, as ``bench.py`` measures it) through
the public API with the launch counters read around it, checks the answer
against scipy's fp64 CG, and solves a 512^3 problem (134M unknowns) with an fp64
true-residual check on the card and the delta-method per-iteration time.

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
SOURCE = "mpi_petsc4py_example_tpu_torch/csrc/stencil7.cu"
REPLACES = {"stencil7_apply": "mpi_petsc4py_example_tpu/ops/pallas_stencil.py:365",
            "stencil7_dot": "mpi_petsc4py_example_tpu/ops/pallas_stencil.py:394"}


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


def bound_ms(lz, ny, nx, itemsize, dot):
    """Least time on the card: each input read once, each output written
    once, over the HBM rate; operations over the fp32 rate; the larger."""
    n = lz * ny * nx
    nbytes = (2 * n + 2 * ny * nx) * itemsize + (itemsize if dot else 0)
    flops = (9 if dot else 7) * n       # 1 mul + 6 sub (+ mul, add)
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
    from mpi_petsc4py_example_tpu_torch.ops import build
    t0 = time.perf_counter()
    for src in sorted(build.CSRC.glob("*.cu")):
        build.build(src.stem)
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.nvcc_path()})")


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
    for bad in (torch.bfloat16, torch.float16):
        try:
            st.stencil3d_apply(u.to(bad), lo.to(bad), hi.to(bad))
        except TypeError:
            continue
        raise SystemExit(f"chip_smoke: FAIL: {bad} on CUDA did not raise")
    log("check: dot deterministic over 5 runs; bf16/fp16 raise TypeError")
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


def profile_solve(ksp, bv, x, label):
    """Device time by kernel over one solve under ``torch.profiler``, and the
    device's idle share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x.zero()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = ksp.solve(bv, x)
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
        return
    its = max(res.iterations, 1)
    log(f"profile {label}: {res.iterations} iterations, wall "
        f"{wall_us / its:.1f} us/iter, device busy {busy_us / its:.1f} us/iter, "
        f"device idle share {1 - busy_us / wall_us:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"  {us / its:9.2f} us/iter  {count // its:3d} calls/iter  {key[:90]}")


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
    st.stencil3d_apply.launches = 0
    st.stencil3d_dot.launches = 0
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
    profile_solve(ksp, bv, x, f"{nx}^3 converged solve")
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
    return launches


def phase_realistic():
    """512^3 f32 (134M unknowns): converged solve with an fp64 true residual
    on the card, then the delta-method per-iteration time."""
    import torch
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.ops import stencil as st
    nx, rtol = 512, 1e-6
    n = nx ** 3
    comm = pt.DeviceComm()
    st.stencil3d_apply.launches = 0
    st.stencil3d_dot.launches = 0
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
    profile_solve(solvers[lo_it], bv, x, f"{nx}^3 {lo_it} fixed iterations")
    return launches


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
    phase_build()
    worst = phase_kernel_checks()
    times = {n: phase_kernel_times(n) for n in (128, 512)}
    launches = phase_main_path()
    launches_512 = phase_realistic()

    kernels = []
    for name in ("stencil7_dot", "stencil7_apply"):
        big, small = times[512][name], times[128][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(worst[name], big["max_abs_err"]),
            "ms": big["ms"], "kernel_ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"], "shape": [512, 512, 512],
            "dtype": "float32", "at_128": small,
            "launches_512": launches_512[name]})
        if name == "stencil7_dot":
            kernels[-1]["dot_rel_err"] = worst["dot_rel"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
