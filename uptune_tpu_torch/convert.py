"""A JAX-package engine state, as numpy arrays -> the port's EngineState.

`from_jax_state(space, arrays)` takes the JAX `EngineState` with every
leaf already turned into a numpy array (for example
`jax.tree_util.tree_map(np.asarray, state)`), read by field name, and
builds the port's state on `device`: the per-arm technique states, the
`Best`, the `HistState` (uint32 hashes as int64) and the counters.  A
stacked state (every leaf with a leading instance axis, as the JAX
package's `BatchedEngine` keeps it) becomes the port's stacked state.
The JAX PRNG keys do not carry over (the engine's, the simplex restart
key and the annealing chain's); the port's key is made from `seed`
instead, for a stacked
state as `BatchedEngine.instance_seeds(seed)` makes the instances'.  The
parity tests use it to start both packages from one state.

`from_jax_gp(arrays)` does the same for a JAX `GPState` (numpy leaves):
every field, `mask`, `ls_cat` and the optional `kinv` included, so the
tests score both packages from one fit.  `from_jax_mlp` carries a JAX
`MLPEnsembleState` over, and `from_jax_snapshot` a JAX surrogate
manager's `SurrogateSnapshot` (GP or MLP state), so both managers can
score from one model.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import rng
from .device import DeviceLike, resolve_device
from .driver.history import HistState
from .engine.fused import EngineState
from .space.spec import CandBatch, Space
from .surrogate.gp import GPState
from .surrogate.manager import SurrogateSnapshot
from .surrogate.mlp import MLPEnsembleState
from .techniques.annealing import SAState
from .techniques.banditmutation import BMState
from .techniques.base import Best
from .techniques.cmaes import CMAState
from .techniques.de import DEState
from .techniques.pattern import PatternState
from .techniques.pso import PSOState
from .techniques.simplex import SimplexState

# the technique states, by class name (the JAX package's use the same
# names and fields, plus the PRNG keys the port leaves out)
_TSTATES = {c.__name__: c for c in (DEState, SimplexState, PSOState,
                                    PatternState, SAState, BMState,
                                    CMAState)}


def _t(a: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.array(a)               # a writable copy, 0-dim kept
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)  # a u32 held in int64 keeps its order
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def from_jax_cands(c: Any, device: torch.device) -> CandBatch:
    return CandBatch(_t(c.u, torch.float32, device),
                     tuple(_t(p, torch.int64, device) for p in c.perms))


def from_jax_best(b: Any, device: torch.device) -> Best:
    return Best(_t(b.u, torch.float32, device),
                tuple(_t(p, torch.int64, device) for p in b.perms),
                _t(b.qor, torch.float32, device))


def from_jax_hist(h: Any, device: torch.device) -> HistState:
    i32 = torch.int32
    return HistState(_t(h.h0, torch.int64, device),
                     _t(h.h1, torch.int64, device),
                     _t(h.qor, torch.float32, device), _t(h.n, i32, device),
                     _t(h.age, i32, device), _t(h.step, i32, device),
                     _t(h.dropped, i32, device))


def _tstate_field(x: Any, device: torch.device):
    """One field of a technique state: a candidate batch, a tuple of
    permutation blocks (int64), or an array (float32, bool or int32)."""
    if type(x).__name__ == "CandBatch":
        return from_jax_cands(x, device)
    if isinstance(x, tuple):
        return tuple(_t(p, torch.int64, device) for p in x)
    kind = np.asarray(x).dtype.kind
    dtype = {"f": torch.float32, "b": torch.bool}.get(kind, torch.int32)
    return _t(x, dtype, device)


def from_jax_tstate(ts: Any, device: torch.device):
    """One arm's state: any technique state of `_TSTATES` (its key
    dropped), MultiSimplex's (turn, member states), or the empty tuple
    of the stateless arms."""
    cls = _TSTATES.get(type(ts).__name__)
    if cls is not None:
        return cls(*(_tstate_field(getattr(ts, f), device)
                     for f in cls._fields))
    if isinstance(ts, tuple) and not ts:
        return ()
    if (isinstance(ts, tuple) and len(ts) == 2
            and isinstance(ts[1], tuple)):
        return (_t(ts[0], torch.int32, device),
                tuple(from_jax_tstate(m, device) for m in ts[1]))
    raise TypeError(f"no port of technique state {type(ts).__name__}")


def from_jax_state(space: Space, arrays: Any, seed: int = 0,
                   device: DeviceLike = "cuda") -> EngineState:
    """The JAX EngineState (numpy leaves), single or stacked along a
    leading instance axis -> the port's EngineState."""
    device = resolve_device(device)
    best = from_jax_best(arrays.best, device)
    if best.u.dim() not in (1, 2) or best.u.shape[-1] != space.n_scalar:
        raise ValueError(f"best.u has shape {tuple(best.u.shape)}, the "
                         f"space has {space.n_scalar} scalar lanes")
    key = rng.key(seed, device)
    if best.u.dim() == 2:
        key = rng.split(key, best.u.shape[0])
    i32 = torch.int32
    return EngineState(
        tuple(from_jax_tstate(ts, device) for ts in arrays.tstates),
        best, from_jax_hist(arrays.hist, device),
        key, _t(arrays.evals, i32, device),
        _t(arrays.acqs, i32, device), _t(arrays.arm_pulls, i32, device),
        _t(arrays.arm_hits, i32, device))


def from_jax_gp(arrays: Any, device: DeviceLike = "cuda") -> GPState:
    """A JAX GPState (numpy leaves) -> the port's GPState on `device`."""
    device = resolve_device(device)
    f32 = torch.float32
    return GPState(*(_t(getattr(arrays, name), f32, device)
                     for name in ("x", "alpha", "chol", "y_mean", "y_std",
                                  "lengthscale", "noise", "mask", "ls_cat")),
                   kinv=(None if arrays.kinv is None
                         else _t(arrays.kinv, f32, device)))


def from_jax_mlp(state: Any, device: DeviceLike = "cuda") -> MLPEnsembleState:
    """A JAX MLPEnsembleState (every member's parameters stacked on a
    leading axis) -> the port's on `device`."""
    device = resolve_device(device)
    f32 = torch.float32
    params = tuple((_t(w, f32, device), _t(b, f32, device))
                   for w, b in state.params)
    return MLPEnsembleState(params, *(_t(getattr(state, name), f32, device)
                                      for name in ("x_mean", "x_std",
                                                   "y_mean", "y_std")))


def from_jax_snapshot(snap: Any,
                      device: DeviceLike = "cuda") -> SurrogateSnapshot:
    """A JAX SurrogateSnapshot -> the port's: its GP or MLP state carried
    over, every other field as it is."""
    st = snap.state
    state = (from_jax_mlp(st, device) if hasattr(st, "params")
             else from_jax_gp(st, device))
    return SurrogateSnapshot(state, *snap[1:])
