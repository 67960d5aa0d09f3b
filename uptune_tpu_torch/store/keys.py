"""Canonical content-addressed keys for the trial results store.

A stored QoR may only be served for a trial that would measure the same
thing: the key binds together (1) the structural space signature (the
same `repr(spec)` list the jsonl archive header carries — any change to
names/kinds/bounds invalidates position-indexed replay), (2) the
materialized config dict, and (3) the evaluation signature — what would
actually run: the command with file arguments replaced by their CONTENT
hash (so editing the tuned program invalidates its cached QoRs even if
the path is unchanged, and moving a work dir does NOT invalidate them
even though the absolute path changed) plus the pipeline stage index.

The reference's SQLite results database keys on (configuration hash)
inside a per-program database file (`python/uptune/
api.py` SQLAlchemy sync); content-addressing the eval side lets one
store directory safely hold results for many programs/spaces at once.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

# content hashes of command file arguments, keyed by (path, mtime, size)
# so repeated store opens don't re-read a multi-MB interpreter binary
_FILE_HASH_CACHE: Dict[tuple, str] = {}


def _norm_value(v: Any) -> Any:
    """JSON-stable form of one config value: numpy scalars unwrapped,
    tuples listified, floats kept as floats (json repr of a python
    float is deterministic)."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            v = v.item()
        except (AttributeError, TypeError, ValueError):
            pass
    if isinstance(v, (list, tuple)):
        return [_norm_value(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        # canonical: -0.0 == 0.0 must not fork the key
        return v + 0.0
    return repr(v)


def canon_config(cfg: Dict[str, Any]) -> str:
    """Canonical JSON text of a config dict (sorted keys, normalized
    scalar types) — the per-trial part of the key."""
    return json.dumps({k: _norm_value(v) for k, v in cfg.items()},
                      sort_keys=True, separators=(",", ":"))


def _hash_file(path: str) -> str:
    st = os.stat(path)
    ck = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    h = _FILE_HASH_CACHE.get(ck)
    if h is None:
        d = hashlib.sha1()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                d.update(chunk)
        h = d.hexdigest()[:16]
        _FILE_HASH_CACHE[ck] = h
    return h


def _norm_command_arg(arg: Any) -> str:
    """One command element in content-addressed form.

    * THE running interpreter (``sys.executable``, compared by
      realpath) collapses to ``"python"`` — results must survive venv
      moves and micro-version bumps; the tuned program itself is what
      defines the measurement.  Only the interpreter identity check
      triggers this: a tuned program that happens to be NAMED
      ``python.py`` is still content-hashed;
    * any other existing file becomes ``file:<basename>:<sha1[:16]>``
      of its CONTENT, so editing the program (or a build script passed
      as an argument) invalidates its recorded QoRs;
    * everything else (flags, literals) is kept verbatim.
    """
    if not isinstance(arg, str):
        return repr(arg)
    if os.path.isfile(arg):
        try:
            if os.path.realpath(arg) == os.path.realpath(sys.executable):
                return "python"
        except OSError:
            pass
        base = os.path.basename(arg)
        try:
            return f"file:{base}:{_hash_file(arg)}"
        except OSError:
            return arg
    return arg


def eval_signature(command, stage: int = 0,
                   extra_files: Optional[Sequence[str]] = None,
                   env: Optional[Dict[str, str]] = None) -> str:
    """Canonical signature of what an evaluation runs: the normalized
    command, the stage index, the content hashes of any extra inputs
    that shape the measurement (e.g. a template source whose rendered
    copy is what actually executes), and the extra ENVIRONMENT the
    trials run under — two tunes of one program with different env
    (say CFLAGS) measure different things and must not share rows.
    PYTHONPATH is excluded: the controller wires it for child imports
    (machine-local path plumbing, like the interpreter location), so
    keeping it would fork the scope per checkout without changing the
    measurement."""
    cmd = ([command] if isinstance(command, str) else list(command))
    sig = {"cmd": [_norm_command_arg(a) for a in cmd], "stage": int(stage)}
    extras = sorted(os.path.basename(p) + ":" + _hash_file(p)
                    for p in (extra_files or []) if os.path.isfile(p))
    if extras:
        sig["extra"] = extras
    env = {k: v for k, v in (env or {}).items() if k != "PYTHONPATH"}
    if env:
        sig["env"] = {str(k): str(v) for k, v in sorted(env.items())}
    return json.dumps(sig, sort_keys=True, separators=(",", ":"))


def scope_id(space_sig: Sequence[str], eval_sig: str) -> str:
    """One hex id for a (space, evaluation) pair.  Every stored row
    carries it, so one store directory holds many programs' results and
    warm-start only ingests rows measured by THIS measurement."""
    d = hashlib.sha1()
    for s in space_sig:
        d.update(s.encode())
        d.update(b"\n")
    d.update(eval_sig.encode())
    return d.hexdigest()[:20]


def trial_key(scope: str, cfg: Dict[str, Any]) -> str:
    """The content address of one trial: scope + canonical config."""
    d = hashlib.sha1()
    d.update(scope.encode())
    d.update(b"\n")
    d.update(canon_config(cfg).encode())
    return d.hexdigest()
