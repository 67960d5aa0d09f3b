"""Content-addressed trial results store (store.py) and its key
derivation (keys.py): cache hits instead of repeated external builds,
cross-tune warm starts, and multi-instance best-exchange over one shared
directory.  The rows and keys are the JAX package's, so a store written
by either package is read by the other.  The networked store (a
``tcp://`` base: the JAX package's `store/server.py` and `remote.py`)
is not ported yet (ROADMAP Queue 1 item 7)."""
from .keys import (canon_config, eval_signature, scope_id,  # noqa: F401
                   trial_key)
from .store import ResultStore  # noqa: F401

__all__ = ["ResultStore", "canon_config", "eval_signature", "scope_id",
           "trial_key", "is_remote_addr", "open_store"]


def is_remote_addr(base) -> bool:
    """True when a store base names a store SERVER (``tcp://...``)
    rather than a directory."""
    return isinstance(base, str) and base.startswith("tcp://")


def open_store(base, space_sig, command, **kw):
    """The one store factory every plug-in site routes through: a
    filesystem `ResultStore` on the directory `base`.  A ``tcp://HOST:PORT``
    base raises: the cooperative store server is ROADMAP Queue 1 item 7.
    Keyword arguments are the shared constructor surface
    (stage/extra_files/env/refresh_interval/fsync)."""
    if is_remote_addr(base):
        raise NotImplementedError(
            f"store {base!r}: a tcp:// store server is not ported yet "
            f"(ROADMAP Queue 1 item 7, store/remote.py and server.py); "
            f"pass a directory")
    return ResultStore(base, space_sig, command, **kw)
