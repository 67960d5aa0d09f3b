"""ut-torch-lint: the JAX package's static analysis (`uptune_tpu.analysis`)
for the port, plus the runtime lock sanitizer that cross-checks its
concurrency rules.

Static side (pure AST: imports nothing it lints, runs on any box)::

    python -m uptune_tpu_torch.analysis uptune_tpu_torch/ --format json
    ut-torch-lint --list-rules

The rules are the JAX package's, R001-R005 (JAX hazards) and R101-R106
(locks), so either analyzer gives the same findings on any tree.

Concurrency side (R101–R106 + the lock sanitizer)::

    UT_LOCK_GUARD=strict python -m uptune_tpu_torch.cli serve ...
    from uptune_tpu_torch.analysis import LockGuard
    with LockGuard(strict=True):
        ...   # locks created in here get order/held-time checked

The JAX package's `TraceGuard` counts `jax.jit` retraces.  The port
traces nothing, so it has no counterpart: `TraceGuard(...)` raises, and
`guard_from_env` raises when UT_TRACE_GUARD asks for one (the CLI
refuses the variable the same way).

Rules, suppression syntax, and the rationale: docs/LINT.md.
"""
from .core import Finding, all_rules, lint_paths, lint_source
from .lock_guard import LockGuard, LockOrderError, lock_guard_from_env

_NO_TRACES = ("the trace guard counts jax.jit retraces, and the port "
              "traces nothing (it runs eagerly): it has no trace guard")


class RetraceError(RuntimeError):
    """The JAX package's retrace error; the port never raises it."""


class TraceGuard:
    """No counterpart: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NO_TRACES)


def guard_from_env(env=None):
    """None when UT_TRACE_GUARD is unset or off; raises when it asks for
    a guard (the port cannot count traces)."""
    import os
    e = os.environ if env is None else env
    if e.get("UT_TRACE_GUARD", "").strip().lower() in ("", "off", "none",
                                                        "0", "false"):
        return None
    raise NotImplementedError(_NO_TRACES)


__all__ = ["Finding", "all_rules", "lint_paths", "lint_source",
           "TraceGuard", "RetraceError", "guard_from_env",
           "LockGuard", "LockOrderError", "lock_guard_from_env"]
