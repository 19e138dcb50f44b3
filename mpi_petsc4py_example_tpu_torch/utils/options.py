"""Runtime options database: the PETSc ``-key value`` flags the port reads.

The port's subset of ``mpi_petsc4py_example_tpu/utils/options.py``: the same
argv parsing and typed getters, for the flags ``KSP.set_from_options`` reads
(``-ksp_type``, ``-pc_type``, ``-ksp_rtol``, ``-ksp_atol``, ``-ksp_max_it``,
``-ksp_norm_type``, ``-ksp_batch_limit``, ``-ksp_gmres_restart``,
``-ksp_true_residual_check``, ``-ksp_true_residual_margin``,
``-pc_mg_smooth_type``, ``-pc_factor_mat_solver_type``,
``-pc_bjacobi_blocks``, ``-pc_setup_device``) and the flags
``RefinedKSP.set_from_options`` reads (``-ksp_inner_precision``,
``-ksp_refine_max``, ``-ksp_refine_inner_rtol``, ``-ksp_megasolve``). Each
process has one database, seeded with :func:`init`.
"""

from __future__ import annotations

class Options:
    """A PETSc-style string->string options database."""

    def __init__(self):
        self._db: dict[str, str] = {}

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
        return key.lstrip("-") in self._db

    def clear(self, key: str | None = None):
        if key is None:
            self._db.clear()
        else:
            self._db.pop(key.lstrip("-"), None)

    def get_string(self, key: str, default: str | None = None):
        return self._db.get(key.lstrip("-"), default)

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

    def __repr__(self):
        return f"Options({self._db})"


_global_options = Options()


def global_options() -> Options:
    """The process's options database."""
    return _global_options


def init(argv=None):
    """Seed the options database from argv (``petsc4py.init`` equivalent)."""
    _global_options.parse_argv(argv)
