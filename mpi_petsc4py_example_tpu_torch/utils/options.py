"""Runtime options database: the PETSc ``-key value`` flags the port reads.

The port's subset of ``mpi_petsc4py_example_tpu/utils/options.py``: the same
argv parsing and typed getters, for the flags ``KSP.set_from_options`` reads
(``-ksp_type``, ``-pc_type``, ``-ksp_rtol``, ``-ksp_atol``, ``-ksp_max_it``,
``-ksp_norm_type``, ``-ksp_batch_limit``, ``-ksp_gmres_restart``,
``-ksp_true_residual_check``, ``-ksp_true_residual_margin``,
``-ksp_megasolve``, ``-ksp_megasolve_stencil_fastpath``,
``-ksp_reduction_auto``, ``-pc_mg_smooth_type``,
``-pc_factor_mat_solver_type``, ``-pc_bjacobi_blocks``,
``-pc_setup_device``, ...: ``KSP.set_from_options`` lists them all) and the
flags ``RefinedKSP.set_from_options`` reads (``-ksp_inner_precision``,
``-ksp_refine_max``, ``-ksp_refine_inner_rtol``, ``-ksp_megasolve``), and
the observability flags: ``-log_view`` (the at-exit solve report of
``utils/profiling.py``), ``-telemetry``, ``-telemetry_flight_len`` and
``-telemetry_dump`` (``telemetry/__init__.py``), which :func:`init` applies
as the JAX package's does (``utils/options.py:382-385``), and the
asynchronous tier's ``-multisplit_*`` flags (:data:`KNOWN_FLAGS`). Each
process has one database, built at its first use from the ``TPU_SOLVE_<KEY>``
environment variables and seeded with :func:`init`.

``Options.get``/``as_dict``/``unused`` are the JAX ``utils/options.py:322-360``
surface: every getter marks its key queried, and ``unused`` lists the keys
set but never queried (PETSc's ``-options_left`` report). :func:`env_value`
reads one ``TPU_SOLVE_<KEY>`` variable as it is now (the fault plan of
``resilience/faults.py`` reads ``TPU_SOLVE_FAULTS`` through it).
"""

from __future__ import annotations

import os

_ENV_PREFIX = "TPU_SOLVE_"


#: flags registered with a description, as the JAX package's ``KNOWN_FLAGS``
#: (``utils/options.py:30``) holds them; the port registers the asynchronous
#: tier's (JAX ``:110-135``), which its modules read through the getters below
KNOWN_FLAGS = {
    # ---- asynchronous multisplitting (solvers/multisplit.py) ----
    "multisplit_blocks": "row blocks of the two-stage splitting (default: "
                         "one per shard; each runs its own inner solve "
                         "thread against stale boundaries)",
    "multisplit_inner_max_it": "inner-solve iteration cap per async outer "
                               "step (keeps steps short so exchanges stay "
                               "fresh)",
    "multisplit_inner_rtol": "inner-solve relative tolerance per outer "
                             "step (loose: the outer iteration absorbs "
                             "the slack)",
    "multisplit_inner_type": "inner KSP type per block (any KSP type; the "
                             "session's PC)",
    "multisplit_max_outer": "outer async step cap per block before "
                            "DIVERGED_MAX_IT",
    "multisplit_max_stale": "bounded-staleness limit: versions a partner "
                            "may trail before the reader re-syncs "
                            "(convergence itself is only ever declared "
                            "at a consistent version cut)",
    "multisplit_resync_timeout": "seconds a re-syncing block waits for a "
                                 "lagging partner before treating it as "
                                 "lost-in-progress and continuing stale",
    "multisplit_urgent_stale": "effective staleness bound for QoS-urgent "
                               "(interactive) serving sessions — tighter "
                               "than -multisplit_max_stale, so urgent "
                               "requests ride fresher exchanges",
}


class Options:
    """A PETSc-style string->string options database, seeded from the
    environment as the JAX package's is (``utils/options.py`` ``load_env``):
    ``TPU_SOLVE_KSP_TYPE=bcgs`` sets ``ksp_type``, for every variable but
    ``TPU_SOLVE_BACKEND``; argv parsed later overrides."""

    def __init__(self):
        self._db: dict[str, str] = {}
        self._queried: set[str] = set()
        self.load_env()

    def load_env(self):
        for k, v in os.environ.items():
            if k.startswith(_ENV_PREFIX) and k != _ENV_PREFIX + "BACKEND":
                self._db[k[len(_ENV_PREFIX):].lower()] = v

    def parse_argv(self, argv):
        """Parse ``-key value`` / ``-key`` (boolean) pairs, PETSc style.

        A token starting with ``-`` is a value (not a new flag) when it
        parses as a number, so negative values work.
        """
        if argv is None:
            return

        def is_value(tok: str) -> bool:
            if not tok.startswith("-"):
                return True
            try:
                float(tok)
                return True
            except ValueError:
                return False

        toks = list(argv)
        i = 1 if toks and not toks[0].startswith("-") else 0  # program name
        while i < len(toks):
            tok = toks[i]
            if tok.startswith("-") and not is_value(tok):
                key = tok.lstrip("-")
                if i + 1 < len(toks) and is_value(toks[i + 1]):
                    self._db[key] = toks[i + 1]
                    i += 2
                else:
                    self._db[key] = "true"
                    i += 1
            else:
                i += 1

    def set(self, key: str, value):
        self._db[key.lstrip("-")] = str(value)

    def has(self, key: str) -> bool:
        key = key.lstrip("-")
        self._queried.add(key)        # a presence check is a use (PETSc too)
        return key in self._db

    def clear(self, key: str | None = None):
        if key is None:
            self._db.clear()
            self._queried.clear()
        else:
            key = key.lstrip("-")
            self._db.pop(key, None)
            self._queried.discard(key)

    def get(self, key: str, default=None):
        key = key.lstrip("-")
        self._queried.add(key)
        return self._db.get(key, default)

    def get_string(self, key: str, default: str | None = None):
        return self.get(key, default)

    def get_int(self, key: str, default: int | None = None):
        v = self.get_string(key)
        return default if v is None else int(v)

    def get_real(self, key: str, default: float | None = None):
        v = self.get_string(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False):
        v = self.get_string(key)
        if v is None:
            return default
        return str(v).lower() not in ("0", "false", "no", "off")

    def as_dict(self) -> dict:
        return dict(self._db)

    def unused(self) -> list[str]:
        """Options set but never queried, sorted: PETSc's
        ``-options_left`` report (a misspelled flag changes nothing; this
        names it)."""
        return sorted(k for k in self._db if k not in self._queried)

    def __repr__(self):
        return f"Options({self._db})"


def env_value(key: str):
    """The ``TPU_SOLVE_<KEY>`` environment variable as it is now, or None."""
    return os.environ.get(_ENV_PREFIX + key.upper())


_global_options: Options | None = None


def global_options() -> Options:
    """The process's options database, built at the first call (so it
    reads the environment as it is then, not at import)."""
    global _global_options
    if _global_options is None:
        _global_options = Options()
    return _global_options


def init(argv=None):
    """Seed the options database from argv (``petsc4py.init`` equivalent)
    and apply the ``-telemetry*`` flags."""
    global_options().parse_argv(argv)
    from ..telemetry import configure_from_options
    configure_from_options()


def backend() -> str:
    """The device type the port's entry points run on (JAX ``options.py:392``
    names its platform from ``TPU_SOLVE_BACKEND``, default ``tpu``): the
    default communicator's, ``"cuda"`` unless a caller set a CPU one with
    ``set_default_comm``. It only reports: the port selects its device by
    the communicator, and ``TPU_SOLVE_BACKEND`` selects nothing here."""
    from ..parallel import mesh
    comm = mesh._default_comm
    return "cuda" if comm is None else comm.device.type
