"""Technique framework: batched search strategies as functions on tensors.

Counterpart of `uptune_tpu/techniques/base.py`.  A technique is a batched
state machine over a state of tensors.  The JAX package's
`propose(space, state, key, best)` becomes two parts here, as does every
stochastic step of the port:

    draws          = t.draw_propose(space, gen)        # consumes a stream
    state, cands   = t.propose(space, state, best, draws)   # pure
    draws          = t.draw_observe(space, gen)        # None when unused
    state          = t.observe(space, state, cands, qor, best, draws)
    state          = t.init_state(space, t.draw_init(space, gen))

The draws' shapes depend only on (space, hyperparameters), never on the
state: every technique draws unconditionally and selects branchlessly, as
in the JAX package.  QoR is always minimized; missing results are +inf.

The registry holds every technique of the JAX package under its name,
the host-side meta-techniques (`bandit.py`) included; `get_root` resolves
the driver's `--technique` arguments as the JAX package's does.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import rng
from ..space.spec import CandBatch, Space


def take_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a [1] index tensor on x's device, without a host read of
    i (indexing with a 0-dim tensor would read it)."""
    return x.index_select(0, i)[0]


class Best(NamedTuple):
    """Global best configuration in flat encoding; qor == +inf before any
    result has been observed."""
    u: torch.Tensor                   # [D] f32
    perms: Tuple[torch.Tensor, ...]   # each [s_k] i64
    qor: torch.Tensor                 # scalar f32

    @staticmethod
    def empty(space: Space, device: torch.device) -> "Best":
        return Best(
            torch.zeros((space.n_scalar,), dtype=torch.float32,
                        device=device),
            tuple(torch.arange(s, device=device) for s in space.perm_sizes),
            torch.tensor(float("inf"), dtype=torch.float32, device=device))

    def update(self, cands: CandBatch, qor: torch.Tensor) -> "Best":
        """Fold a measured batch into the running best (argmin takes the
        first minimum, as jnp.argmin does)."""
        i = torch.argmin(qor).reshape(1)
        qi = take_row(qor, i)
        better = qi < self.qor
        return Best(
            torch.where(better, take_row(cands.u, i), self.u),
            tuple(torch.where(better, take_row(p, i), q)
                  for p, q in zip(cands.perms, self.perms)),
            torch.minimum(self.qor, qi))

    def as_batch(self, n: int) -> CandBatch:
        return CandBatch(self.u[None, :].repeat(n, 1),
                         tuple(p[None, :].repeat(n, 1) for p in self.perms))


class Technique:
    """Base class.  Subclasses take their hyperparameters in __init__ and
    implement the state functions."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__

    def natural_batch(self, space: Space) -> int:
        """Candidates emitted per propose()."""
        raise NotImplementedError

    def supports(self, space: Space) -> bool:
        return True

    def draw_init(self, space: Space, gen: rng.Stream) -> Any:
        return None

    def init_state(self, space: Space, draws: Any):
        raise NotImplementedError

    def draw_propose(self, space: Space, gen: rng.Stream) -> Any:
        raise NotImplementedError

    def propose(self, space: Space, state, best: Best, draws: Any):
        raise NotImplementedError

    def draw_observe(self, space: Space, gen: rng.Stream) -> Any:
        return None

    def observe(self, space: Space, state, cands: CandBatch,
                qor: torch.Tensor, best: Best, draws: Any = None):
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_registry: Dict[str, Technique] = {}
_experimental: set = set()


def register(t: Technique, experimental: bool = False) -> Technique:
    """`experimental=True` flags a name measured behind the defaults; it
    stays selectable by name."""
    if t.name in _registry:
        raise ValueError(f"duplicate technique name {t.name!r}")
    _registry[t.name] = t
    if experimental:
        _experimental.add(t.name)
    return t


def is_experimental(name: str) -> bool:
    _ensure_loaded()
    return name in _experimental


def all_technique_names() -> List[str]:
    _ensure_loaded()
    return sorted(_registry)


def get_technique(name: str) -> Technique:
    _ensure_loaded()
    try:
        return _registry[name]
    except KeyError:
        raise KeyError(f"unknown technique {name!r}; "
                       f"known: {sorted(_registry)}") from None


def get_root(names: Optional[Sequence[str]] = None) -> Technique:
    """Resolve --technique arguments to a root technique: the default
    portfolio (AUCBanditMetaTechniqueA) when none is given, the one
    technique when one is, a round-robin portfolio of them when several
    are.  Returns a deep copy: a meta-technique carries host state (the
    bandit's window, the round-robin cursor) that must not leak between
    runs."""
    import copy
    _ensure_loaded()
    from .bandit import RoundRobinMeta  # bandit imports base
    if not names:
        return copy.deepcopy(_registry["AUCBanditMetaTechniqueA"])
    if len(names) == 1:
        return copy.deepcopy(get_technique(names[0]))
    return RoundRobinMeta([copy.deepcopy(get_technique(n)) for n in names],
                          name="+".join(names))


_loaded = False


def _ensure_loaded():
    """Import every technique module so their register() calls run."""
    global _loaded
    if _loaded:
        return
    from . import purerandom, de, evolutionary, pso, annealing  # noqa: F401
    from . import pattern, simplex, bandit, banditmutation      # noqa: F401
    from . import cmaes                                         # noqa: F401
    _loaded = True
