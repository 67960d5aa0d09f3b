"""Content-addressed trial results store (store.py), its key
derivation (keys.py), and the networked cooperative-store plane
(server.py + remote.py): cache hits instead of repeated external
builds, cross-tune warm starts, and multi-instance best-exchange over
one shared directory OR one shared TCP store server (`ut-torch store`).
The rows, keys and wire ops are the JAX package's, so a store written
by either package is read by the other, and either package's
`RemoteStore` joins either package's server."""
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
    ``tcp://HOST:PORT`` base opens a `RemoteStore` on the cooperative
    store server, anything else a filesystem `ResultStore` on that
    directory.  Keyword arguments are the shared constructor surface
    (stage/extra_files/env/refresh_interval/fsync)."""
    if is_remote_addr(base):
        from .remote import RemoteStore   # lazy: keeps dir-store imports lean
        return RemoteStore(base, space_sig, command, **kw)
    return ResultStore(base, space_sig, command, **kw)
