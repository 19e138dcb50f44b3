"""Run a petsc4py/slepc4py/mpi4py driver on the port under N virtual ranks:
the port's ``mpirun``.

Usage::

    python -m mpi_petsc4py_example_tpu_torch.run [-n N] [--device cpu] \\
        driver.py [driver arguments]

The port's facade (``facade/``: ``petsc4py``, ``slepc4py``, ``mpi4py``,
``petsc_funcs``) leads ``sys.path``, ahead of the driver's own directory, so
the driver's ``import petsc4py``, ``from slepc4py import SLEPc``, ``from
mpi4py import MPI`` and ``import petsc_funcs`` resolve to it. N threads
each execute the driver as ``__main__`` with a thread-local rank;
point-to-point and collective calls rendezvous in the process, and the
device work runs once, on the rank-0 thread, over a ``DeviceComm`` of N
shards. The device is the card (CUDA), which must be present, unless
``--device cpu`` is given. The exit code is 1 when any rank raised.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import traceback

_HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_petsc4py_example_tpu_torch.run")
    ap.add_argument("-n", "--np", type=int, default=1,
                    help="number of virtual ranks (threads)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default: the card)")
    ap.add_argument("script", help="driver script to run")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments passed to the driver")
    opts = ap.parse_args(argv)
    if opts.np < 1:
        ap.error(f"-n must be >= 1, got {opts.np}")

    import torch
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    script_dir = os.path.dirname(os.path.abspath(opts.script))
    for p in (os.path.dirname(_HERE), script_dir,
              os.path.join(_HERE, "facade")):
        if p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)
    sys.argv = [opts.script] + opts.args

    from mpi4py import MPI   # the facade: it leads sys.path now
    MPI._set_device(None if opts.device == "cuda" else "cpu")
    with open(opts.script) as f:
        code = compile(f.read(), opts.script, "exec")

    def run_script():
        exec(code, {"__name__": "__main__", "__file__": opts.script,
                    "__builtins__": __builtins__})

    if opts.np == 1:
        MPI._set_context(None)
        run_script()
        return 0

    ctx = MPI.VirtualContext(opts.np)
    MPI._set_context(ctx)
    errors = []

    def run_rank(rank: int):
        ctx.register(rank)
        try:
            run_script()
        # a rank runs an arbitrary driver: whatever it raises, SystemExit
        # included, is reported and releases the peers blocked on
        # collectives
        except (Exception, SystemExit):  # noqa: BLE001
            errors.append((rank, traceback.format_exc()))
            ctx.barrier.abort()

    threads = [threading.Thread(target=run_rank, args=(r,), name=f"rank{r}")
               for r in range(opts.np)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    MPI._set_context(None)
    for rank, tb in errors:
        print(f"--- rank {rank} failed ---\n{tb}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
