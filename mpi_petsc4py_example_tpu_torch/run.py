"""Run a petsc4py/slepc4py/mpi4py driver on the port under N ranks: the
port's ``mpirun``.

Usage::

    python -m mpi_petsc4py_example_tpu_torch.run [-n N] [--device cpu] \\
        [--procs [--backend nccl|gloo]] driver.py [driver arguments]

The port's facade (``facade/``: ``petsc4py``, ``slepc4py``, ``mpi4py``,
``petsc_funcs``) leads ``sys.path``, ahead of the driver's own directory, so
the driver's ``import petsc4py``, ``from slepc4py import SLEPc``, ``from
mpi4py import MPI`` and ``import petsc_funcs`` resolve to it. The device is
the card (CUDA), which must be present, unless ``--device cpu`` is given.

* Thread mode (the default): N threads each execute the driver as
  ``__main__`` with a thread-local rank; point-to-point and collective calls
  rendezvous in the process, and the device work runs once, on the rank-0
  thread, over a ``DeviceComm`` of N shards.
* Process mode (``--procs``): N processes, one per rank, each joins a
  ``torch.distributed`` group (``RANK``/``WORLD_SIZE``, ``MASTER_ADDR``
  127.0.0.1 and a free port) and executes the driver over a
  ``ProcessComm`` of one shard per rank. The backend is NCCL on the card
  and gloo on the CPU unless ``--backend`` names one; NCCL takes at most
  one rank per card, so more ranks on one card need ``--backend gloo``.
  On the card rank ``r`` uses card ``r % device_count``.

The exit code is 1 when any rank failed; in process mode the peers of a
failed rank are killed.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

_HERE = os.path.dirname(os.path.abspath(__file__))
# set in the environment of the rank processes the parent spawns
_CHILD_ENV = "MPI_PETSC4PY_TORCH_RANK_PROCESS"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs, grace_s: float = 5.0):
    """Terminate every process still running, and kill what outlives
    ``grace_s``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def spawn_ranks(nprocs: int, argv: list, env: dict | None = None) -> int:
    """Run ``python -m mpi_petsc4py_example_tpu_torch.run argv`` as
    ``nprocs`` rank processes of one group and wait for them: 0 when every
    rank exits 0; as soon as one fails, its peers are killed and 1 is
    returned."""
    port = _free_port()
    base = dict(os.environ if env is None else env)
    root = os.path.dirname(_HERE)
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    try:
        for r in range(nprocs):
            penv = dict(base, RANK=str(r), WORLD_SIZE=str(nprocs),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                        **{_CHILD_ENV: "1"})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run"]
                + list(argv), env=penv))
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                print(f"run: rank(s) {failed} failed; stopping the others",
                      file=sys.stderr)
                return 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        _stop(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_petsc4py_example_tpu_torch.run")
    ap.add_argument("-n", "--np", type=int, default=1,
                    help="number of ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default: the card)")
    ap.add_argument("--procs", action="store_true",
                    help="one process per rank over torch.distributed "
                         "(default: one thread per rank)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process mode's device group (default: nccl on "
                         "the card, gloo on the CPU)")
    ap.add_argument("script", help="driver script to run")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments passed to the driver")
    raw = list(sys.argv[1:] if argv is None else argv)
    from mpi_petsc4py_example_tpu_torch.utils.phases import stamp
    stamp("tpurun_main")
    opts = ap.parse_args(raw)
    if opts.np < 1:
        ap.error(f"-n must be >= 1, got {opts.np}")
    if opts.backend and not opts.procs:
        ap.error("--backend needs --procs")

    import torch
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    if opts.procs and not os.environ.get(_CHILD_ENV):
        from mpi_petsc4py_example_tpu_torch.parallel.mesh import \
            resolve_backend
        try:
            resolve_backend(opts.backend, opts.device, opts.np)
        except ValueError as err:
            raise SystemExit(f"run: {err}") from None
        return spawn_ranks(opts.np, raw)

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
        stamp("driver_exec")
        exec(code, {"__name__": "__main__", "__file__": opts.script,
                    "__builtins__": __builtins__})

    if opts.procs:
        return _run_rank_process(opts, MPI, run_script)

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


def _run_rank_process(opts, MPI, run_script) -> int:
    """One rank of process mode: join the group, run the driver over the
    group's ProcessComm, leave the group."""
    import torch.distributed as dist

    from mpi_petsc4py_example_tpu_torch.parallel.mesh import init_multihost
    comm = init_multihost(backend=opts.backend,
                          device=None if opts.device == "cuda" else "cpu")
    rank = comm.rank
    try:
        MPI._set_context(MPI.ProcessContext(comm))
        run_script()
    except SystemExit as err:
        if err.code not in (None, 0):
            print(f"--- rank {rank} failed ---\n{traceback.format_exc()}",
                  file=sys.stderr)
            return 1
    # as in thread mode: whatever else the driver raises fails this rank
    except Exception:  # noqa: BLE001
        print(f"--- rank {rank} failed ---\n{traceback.format_exc()}",
              file=sys.stderr)
        return 1
    finally:
        MPI._set_context(None)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
