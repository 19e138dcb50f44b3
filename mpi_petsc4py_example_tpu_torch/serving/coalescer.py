"""Request coalescing for the solve server (``serving/server.py``).

The port's copy of ``mpi_petsc4py_example_tpu/serving/coalescer.py``: pure
host logic (no threads, no device work), so its grouping is testable alone
and the server's dispatcher thread stays the only place concurrency lives.

* Requests may share one ``KSP.solve_many`` block only when they target the
  same registered operator with the same tolerances (rtol, atol, max_it),
  precision plan and reduction-plan schedule: a block has one convergence
  contract, so mixed-tolerance requests never batch together.
* FIFO order holds within a compatibility group, and groups come in the
  order of their oldest member.
* A group wider than ``max_k`` splits into ceil(k / max_k) blocks.
* With padding on, a block's width is rounded up to the next power of two
  (zero right-hand sides, which converge at iteration 0 and freeze under
  the masked block CG): a server then meets at most log2(max_k) + 1 block
  widths an operator, so the port's fused program captures at most that
  many graphs an operator (``solvers/megasolve.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class SolveRequest:
    """One pending solve, the unit the coalescer groups (JAX
    ``coalescer.py:36``).

    ``future`` is the ``concurrent.futures.Future`` the client holds; the
    server resolves it with a :class:`~.server.ServedSolveResult` once the
    block it rode in returns. ``t_submit`` (``time.monotonic``) feeds the
    queue-wait statistics and the batching window. ``precision`` (the
    session's storage dtype name) and ``schedule`` (``cg``, ``pipecg``,
    ``sstep:<s>``) are part of the compatibility key: both are built into
    the block program. ``qos``/``priority`` (lower is more urgent), the
    detached ``serving.request`` ``span`` and the absolute dispatch
    deadline ``t_deadline`` are not."""
    op: str
    b: Any
    rtol: float
    atol: float
    max_it: int
    future: Any
    precision: str = ""
    schedule: str = ""
    qos: str = ""
    priority: int = 50
    span: Any = None
    t_submit: float = field(default_factory=time.monotonic)
    t_deadline: float | None = None

    @property
    def key(self) -> tuple:
        """Compatibility key: requests batch together iff keys match."""
        return (self.op, str(self.precision), str(self.schedule),
                float(self.rtol), float(self.atol), int(self.max_it))

    def expired(self, now: float) -> bool:
        """Whether the request's dispatch deadline has passed."""
        return self.t_deadline is not None and now >= self.t_deadline


def coalesce(requests, max_k: int):
    """Group pending ``requests`` into dispatchable batches: one list per
    (compatibility key, ``max_k`` chunk), FIFO within each, batches in the
    order of their oldest member; keys never mix."""
    groups: dict = {}
    for r in requests:
        # dict insertion order is the oldest-member order of the groups
        groups.setdefault(r.key, []).append(r)
    max_k = max(1, int(max_k))
    batches = []
    for g in groups.values():
        for s in range(0, len(g), max_k):
            batches.append(g[s:s + max_k])
    return batches


def padded_width(k: int, max_k: int, pad_pow2: bool) -> int:
    """The dispatched block width for ``k`` coalesced requests: ``k``, or
    with padding the next power of two, capped at ``max_k`` (never below
    ``k``)."""
    if not pad_pow2 or k <= 0:
        return k
    p = 1 << max(k - 1, 0).bit_length()
    return min(max(p, 1), max(int(max_k), k))
