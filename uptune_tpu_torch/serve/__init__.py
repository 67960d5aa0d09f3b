"""Tuning-as-a-service: a multi-tenant session server.

Counterpart of `uptune_tpu/serve/`.  ONE long-lived process multiplexes
many concurrent ask/tell tuning sessions onto the batched engine:

* **Sessions are versioned snapshots**: ``ask`` hands out tickets
  against the session's current published state version; ``tell``
  fills the measured batch, and the commit that completes it publishes
  the next version.  Stale tickets are rejected, never silently merged.
* **Proposal generation batches ACROSS tenants**: sessions whose spaces
  share one structural signature are packed onto one ``BatchedEngine``
  instance axis, so one vmapped propose serves every needy tenant at
  once; join and leave re-seed a single slot, and a tenant's tell
  commits only its own slot (engine/batched.py slot primitives; on the
  card every commit is one launch of the merge kernel).
* **The store is a shared cross-tenant memo**: every session scope
  mounts the content-addressed result store, so a configuration one
  tenant measured is served to any other tenant's ask without a build.

Surface: ``ut-torch serve`` (CLI; on the card unless ``--device cpu``),
``uptune_tpu_torch.connect()`` -> SessionClient (wire protocol:
newline-delimited JSON over TCP, frame for frame the JAX package's), and
``LocalSession`` — the same session mechanics without a server, which
doubles as the matched-seed offline sibling the parity tests hold the
server to.  ``ut-torch route`` (``Router``, serve/router.py) is the
sharded front tier: K ``ut-torch serve --durable`` shard processes
behind one thin process that redirects each open to the shard its
space signature hashes to (``HashRing``, ``routing_key``) and never
proxies.
"""
# Lazy surface: the wire kernel (serve/wire.py) and its light consumers
# — SessionClient above all, which a tenant process imports — must stay
# importable without paying the torch import the session modules pull in.
_LAZY = {
    "SessionClient": ("uptune_tpu_torch.serve.client", "SessionClient"),
    "SessionHandle": ("uptune_tpu_torch.serve.client", "SessionHandle"),
    "ServeError": ("uptune_tpu_torch.serve.client", "ServeError"),
    "ConnectionLostError": ("uptune_tpu_torch.serve.client",
                            "ConnectionLostError"),
    "CheckpointLog": ("uptune_tpu_torch.serve.durable", "CheckpointLog"),
    "SessionRestoredError": ("uptune_tpu_torch.serve.session",
                             "SessionRestoredError"),
    "Trial": ("uptune_tpu_torch.serve.client", "Trial"),
    "connect": ("uptune_tpu_torch.serve.client", "connect"),
    "SessionGroup": ("uptune_tpu_torch.serve.group", "SessionGroup"),
    "group_key": ("uptune_tpu_torch.serve.group", "group_key"),
    "LocalSession": ("uptune_tpu_torch.serve.session", "LocalSession"),
    "Session": ("uptune_tpu_torch.serve.session", "Session"),
    "StaleTicketError": ("uptune_tpu_torch.serve.session",
                         "StaleTicketError"),
    "SessionServer": ("uptune_tpu_torch.serve.server", "SessionServer"),
    "RequestError": ("uptune_tpu_torch.serve.wire", "RequestError"),
    "WireServer": ("uptune_tpu_torch.serve.wire", "WireServer"),
    "WireReply": ("uptune_tpu_torch.serve.wire", "WireReply"),
    "encode_reply": ("uptune_tpu_torch.serve.wire", "encode_reply"),
    "Router": ("uptune_tpu_torch.serve.router", "Router"),
    "HashRing": ("uptune_tpu_torch.serve.router", "HashRing"),
    "routing_key": ("uptune_tpu_torch.serve.router", "routing_key"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value     # cache: resolve once
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
