"""Constraint / covariate registry: `ut.register`, `ut.rule`,
`ut.constraint`, `ut.vars`.

The reference's version (`python/uptune/add/
constraint.py:11-60`) records sympy-symbol VarNodes and decorator lists
but never enforces anything (the wrappers even reference an undefined
`func`).  Here the registry is functional: rules are config predicates the
controller applies before publishing a proposal (invalid configs are
resampled/rejected), and constraints are QoR predicates applied when a
result arrives (violating results are treated as failures).

    ut.register("v1", 8)                 # covariate / symbolic var
    @ut.rule()
    def no_both(cfg):                    # search-space restriction
        return not (cfg["a"] and cfg["b"])
    @ut.constraint()
    def qor_sane(qor, cfg):              # QoR-condition
        return qor < 1e6
    ut.tune(5, (2, ut.vars.v1))          # inter-parameter bound
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class VarNode:
    """A named symbolic value usable as a tune() bound.

    Resolves to its current value via int()/float(), so
    ``ut.tune(5, (2, ut.vars.v1))`` works anywhere a number does.
    """

    def __init__(self, name: str, value: Any = None):
        self.name = name
        self.value = value

    def _resolve(self) -> Any:
        if self.value is None:
            raise ValueError(f"VarNode {self.name!r} has no value yet")
        return self.value

    def __int__(self) -> int:
        return int(self._resolve())

    def __float__(self) -> float:
        return float(self._resolve())

    def __index__(self) -> int:
        return int(self._resolve())

    def __le__(self, other):
        return self._resolve() <= other

    def __ge__(self, other):
        return self._resolve() >= other

    def __lt__(self, other):
        return self._resolve() < other

    def __gt__(self, other):
        return self._resolve() > other

    def __eq__(self, other):
        if isinstance(other, VarNode):
            return self.name == other.name
        return self._resolve() == other

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"VarNode(name={self.name!r}, value={self.value!r})"


class Registry:
    """Process-wide store of vars, rules and QoR constraints."""

    def __init__(self):
        self.nodes: Dict[str, VarNode] = {}
        self.rules: List[Callable[[Dict[str, Any]], bool]] = []
        self.constraints: List[Callable[..., bool]] = []
        self.custom_models: List[Any] = []

    def clear(self) -> None:
        self.nodes.clear()
        self.rules.clear()
        self.constraints.clear()
        self.custom_models.clear()

    # ------------------------------------------------------------------
    def check_config(self, cfg: Dict[str, Any]) -> bool:
        """True iff every registered rule accepts the config."""
        return all(bool(r(cfg)) for r in self.rules)

    def check_qor(self, qor: Any, cfg: Dict[str, Any]) -> bool:
        """True iff every registered QoR constraint accepts the result."""
        for c in self.constraints:
            try:
                ok = c(qor, cfg)
            except TypeError:
                ok = c(qor)  # single-argument constraint
            if not ok:
                return False
        return True


REGISTRY = Registry()


def register(name_or_var: Any, value: Any = None,
             name: Optional[str] = None) -> VarNode:
    """Register a named variable/covariate; returns its VarNode."""
    if isinstance(name_or_var, VarNode):
        node = name_or_var
        node.name = name or node.name
    else:
        node = VarNode(name or str(name_or_var), value)
    REGISTRY.nodes[node.name] = node
    return node


def rule(name: Optional[str] = None) -> Callable:
    """Decorator registering a search-space restriction cfg -> bool."""
    def decorator(fn: Callable[[Dict[str, Any]], bool]) -> Callable:
        fn._ut_rule_name = name or fn.__name__
        REGISTRY.rules.append(fn)
        return fn
    return decorator


def constraint(name: Optional[str] = None) -> Callable:
    """Decorator registering a QoR condition (qor[, cfg]) -> bool."""
    def decorator(fn: Callable) -> Callable:
        fn._ut_constraint_name = name or fn.__name__
        REGISTRY.constraints.append(fn)
        return fn
    return decorator


class _Vars:
    """`ut.vars.<name>` accessor over the registry."""

    def __getattr__(self, name: str) -> VarNode:
        try:
            return REGISTRY.nodes[name]
        except KeyError:
            raise AttributeError(f"no registered variable {name!r}")

    def __dir__(self):
        return sorted(REGISTRY.nodes)


vars = _Vars()
