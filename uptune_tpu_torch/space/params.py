"""Host-side parameter specifications for uptune-tpu search spaces.

These are the declarative equivalents of the reference's parameter classes
(`/root/reference/python/uptune/opentuner/search/manipulator.py:275-1484`),
but they carry *no* mutation logic: all operators act on the flat device
encoding (see `uptune_tpu.space.spec.Space`), so a param spec only describes
the value domain and how a scalar dimension maps between the unit interval
[0, 1] and user-facing values.

Scalar-dimension kinds (the `kind` codes stored per dimension in a Space):

==========  ======================================================
FLOAT       continuous in [lo, hi]             (manipulator.py:703)
INT         integer in [lo, hi]                (manipulator.py:651)
LOG_FLOAT   float searched on log2 scale       (manipulator.py:800)
LOG_INT     integer searched on log2 scale     (manipulator.py:781)
POW2        power of two, searched by exponent (manipulator.py:813)
BOOL        True/False                         (manipulator.py:930)
SWITCH      unordered choice of range(n)       (manipulator.py:999)
ENUM        unordered choice from options list (manipulator.py:1024)
==========  ======================================================

BOOL / SWITCH / ENUM are "complex" (non-cartesian) in the reference: the
differential-evolution linear-combination op degenerates to
randomize-if-parents-differ for them (manipulator.py:866-917).  We keep a
unit-interval storage for them too (so every scalar dim is one f32 lane) but
operators consult the per-dim `complex` mask to reproduce that semantic.

Permutations (PermParam / ScheduleParam, manipulator.py:1048-1445) are stored
as separate fixed-width int32 blocks, not unit lanes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Scalar kind codes (stored in Space.kind as int32).
FLOAT = 0
INT = 1
LOG_FLOAT = 2
LOG_INT = 3
POW2 = 4
BOOL = 5
SWITCH = 6
ENUM = 7

# kinds >= COMPLEX_KIND_START use complex-parameter (randomize-if-differ)
# semantics for linear-combination operators.
COMPLEX_KIND_START = BOOL

_KIND_NAMES = {
    FLOAT: "float", INT: "int", LOG_FLOAT: "log_float", LOG_INT: "log_int",
    POW2: "pow2", BOOL: "bool", SWITCH: "switch", ENUM: "enum",
}


class ParamSpec:
    """Base class for all parameter specs. Scalar specs contribute exactly one
    unit-interval lane; permutation specs contribute one int32 block."""

    name: str

    @property
    def is_permutation(self) -> bool:
        return False

    def search_space_size(self) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class _ScalarSpec(ParamSpec):
    name: str

    @property
    def kind(self) -> int:
        raise NotImplementedError

    # --- unit mapping -----------------------------------------------------
    # Every scalar spec defines the *search-scale* range (slo, shi) that the
    # unit interval maps onto, mirroring `legal_range` + the integer
    # +-0.4999 rounding widening of manipulator.py:473-503.
    def scaled_range(self) -> Tuple[float, float]:
        raise NotImplementedError


@dataclass(frozen=True)
class FloatParam(_ScalarSpec):
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        assert self.lo <= self.hi, (self.name, self.lo, self.hi)

    @property
    def kind(self) -> int:
        return FLOAT

    def scaled_range(self):
        return float(self.lo), float(self.hi)

    def search_space_size(self):
        return 2.0 ** 32


@dataclass(frozen=True)
class IntParam(_ScalarSpec):
    lo: int = 0
    hi: int = 1

    def __post_init__(self):
        assert self.lo <= self.hi, (self.name, self.lo, self.hi)
        # decoded integers are hashed as int32 (spec.canonical_lanes)
        assert -2**31 < self.lo and self.hi < 2**31, (self.name, "range must fit int32")

    @property
    def kind(self) -> int:
        return INT

    def scaled_range(self):
        # integer rounding widening, manipulator.py:477-480
        return self.lo - 0.4999, self.hi + 0.4999

    def search_space_size(self):
        return float(self.hi - self.lo + 1)


@dataclass(frozen=True)
class LogFloatParam(_ScalarSpec):
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        assert self.lo <= self.hi, (self.name, self.lo, self.hi)

    @property
    def kind(self) -> int:
        return LOG_FLOAT

    def scaled_range(self):
        # scale(v) = log2(v + 1 - lo), manipulator.py:800-810
        return 0.0, math.log2(self.hi + 1.0 - self.lo)

    def search_space_size(self):
        return 2.0 ** 32


@dataclass(frozen=True)
class LogIntParam(_ScalarSpec):
    lo: int = 0
    hi: int = 1

    def __post_init__(self):
        assert self.lo <= self.hi, (self.name, self.lo, self.hi)
        assert -2**31 < self.lo and self.hi < 2**31, (self.name, "range must fit int32")

    @property
    def kind(self) -> int:
        return LOG_INT

    def scaled_range(self):
        # widen by 0.4999 *before* scaling, manipulator.py:781-797
        return (math.log2(max(self.lo - 0.4999, -0.999) + 1.0 - self.lo),
                math.log2(self.hi + 0.4999 + 1.0 - self.lo))

    def search_space_size(self):
        return float(self.hi - self.lo + 1)


@dataclass(frozen=True)
class Pow2Param(_ScalarSpec):
    lo: int = 1
    hi: int = 1

    def __post_init__(self):
        assert self.lo >= 1 and self.hi >= self.lo
        assert math.log2(self.lo) % 1 == 0, self.lo
        assert math.log2(self.hi) % 1 == 0, self.hi
        # decoded powers of two are hashed as int32 (spec.canonical_lanes)
        assert self.hi < 2**31, (self.name, "max value must fit int32")

    @property
    def kind(self) -> int:
        return POW2

    @property
    def exp_lo(self) -> int:
        return int(math.log2(self.lo))

    @property
    def exp_hi(self) -> int:
        return int(math.log2(self.hi))

    def scaled_range(self):
        # searched by integer exponent, manipulator.py:813-836
        return self.exp_lo - 0.4999, self.exp_hi + 0.4999

    def search_space_size(self):
        return float(self.exp_hi - self.exp_lo + 1)


@dataclass(frozen=True)
class BoolParam(_ScalarSpec):
    @property
    def kind(self) -> int:
        return BOOL

    def scaled_range(self):
        return -0.4999, 1.4999

    def search_space_size(self):
        return 2.0


@dataclass(frozen=True)
class SwitchParam(_ScalarSpec):
    n: int = 2

    def __post_init__(self):
        assert self.n >= 1

    @property
    def kind(self) -> int:
        return SWITCH

    def scaled_range(self):
        return -0.4999, self.n - 1 + 0.4999

    def search_space_size(self):
        return float(max(1, self.n))


@dataclass(frozen=True)
class EnumParam(_ScalarSpec):
    options: Tuple[Any, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "options", tuple(self.options))
        assert len(self.options) >= 1, self.name

    @property
    def kind(self) -> int:
        return ENUM

    def scaled_range(self):
        return -0.4999, len(self.options) - 1 + 0.4999

    def search_space_size(self):
        return float(max(1, len(self.options)))


@dataclass(frozen=True)
class PermParam(ParamSpec):
    """An ordering of `items` (manipulator.py:1048).  Encoded as an int32
    vector of item *indices*; decode maps back through `items`."""
    name: str
    items: Tuple[Any, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "items", tuple(self.items))
        assert len(self.items) >= 1

    @property
    def is_permutation(self) -> bool:
        return True

    @property
    def size(self) -> int:
        return len(self.items)

    def search_space_size(self):
        return float(math.factorial(max(1, len(self.items))))


@dataclass(frozen=True)
class ScheduleParam(PermParam):
    """Dependency-respecting permutation (manipulator.py:1359-1445).

    `deps` maps item -> items that must come earlier.  Normalisation
    topologically sorts candidate orderings; the dependency closure is
    precomputed host-side into a boolean matrix used by the batched
    topo-normalise kernel (ops/perm.py).
    """
    deps: Tuple[Tuple[Any, Tuple[Any, ...]], ...] = ()

    def __post_init__(self):
        super().__post_init__()
        # normalize deps into a hashable tuple-of-tuples and expand the
        # transitive closure exactly as manipulator.py:1367-1390.
        dep_map: Dict[Any, set] = {k: set(v) for k, v in dict(self.deps).items()}
        changed = True
        while changed:
            changed = False
            for k in list(dep_map):
                before = len(dep_map[k])
                for d in list(dep_map[k]):
                    if d in dep_map:
                        dep_map[k] |= dep_map[d]
                if len(dep_map[k]) != before:
                    changed = True
        items = set(self.items)
        for k, v in dep_map.items():
            if k in v:
                raise ValueError(
                    f"ScheduleParam({self.name!r}) cycle: {k!r} depends on itself")
            if v - items:
                raise ValueError(
                    f"ScheduleParam({self.name!r}): unknown deps {v - items!r}")
        if set(dep_map) - items:
            raise ValueError(
                f"ScheduleParam({self.name!r}): unknown items {set(dep_map) - items!r}")
        object.__setattr__(
            self, "deps",
            tuple(sorted(((k, tuple(sorted(v, key=self.items.index)))
                          for k, v in dep_map.items() if v),
                         key=lambda kv: self.items.index(kv[0]))))

    def dep_matrix(self) -> List[List[bool]]:
        """dep_matrix[i][j] is True iff items[i] requires items[j] earlier."""
        idx = {it: i for i, it in enumerate(self.items)}
        n = len(self.items)
        mat = [[False] * n for _ in range(n)]
        for k, vs in self.deps:
            for v in vs:
                mat[idx[k]][idx[v]] = True
        return mat


@dataclass(frozen=True)
class SelectorParam(_ScalarSpec):
    """Ordered choice: an integer position in [0, max_cutoff) mapped onto
    `choices` by equal intervals.  The reference's SelectorParameter
    (manipulator.py:1448-1484) searches over explicit cutoff lists; the
    TPU-first simplification keeps its essential property — ADJACENT
    positions map to the same or neighboring choice, so ordinary numeric
    mutation moves between related choices — in one INT lane with fixed
    interval boundaries."""
    choices: Tuple[Any, ...] = ()
    max_cutoff: int = 0

    def __post_init__(self):
        object.__setattr__(self, "choices", tuple(self.choices))
        assert len(self.choices) >= 1, self.name
        mc = self.max_cutoff or len(self.choices)
        object.__setattr__(self, "max_cutoff", int(mc))
        assert self.max_cutoff >= len(self.choices), self.name

    @property
    def kind(self) -> int:
        return INT   # ordered lane, NOT complex: locality is the point

    def scaled_range(self):
        return -0.4999, self.max_cutoff - 1 + 0.4999

    def choice_of(self, pos: int) -> Any:
        i = int(pos) * len(self.choices) // self.max_cutoff
        return self.choices[min(max(i, 0), len(self.choices) - 1)]

    def pos_of(self, choice: Any) -> int:
        i = self.choices.index(choice)
        # center of the choice's interval
        return min((2 * i + 1) * self.max_cutoff // (2 * len(self.choices)),
                   self.max_cutoff - 1)

    def search_space_size(self):
        return float(self.max_cutoff)


class ArrayParam(ParamSpec):
    """Base for fixed-length array parameters (manipulator.py:1484-1732
    ParameterArray / BooleanArray / FloatArray / Array): expands into n
    scalar lanes named ``name[i]`` at Space build time; the config value
    is one Python list."""

    name: str
    n: int

    def expand(self) -> List[_ScalarSpec]:
        raise NotImplementedError

    def search_space_size(self) -> float:
        out = 1.0
        for s in self.expand():
            out *= s.search_space_size()
        return out


@dataclass(frozen=True)
class BoolArrayParam(ArrayParam):
    name: str = ""
    n: int = 1

    def __post_init__(self):
        assert self.n >= 1, self.name

    def expand(self):
        return [BoolParam(f"{self.name}[{i}]") for i in range(self.n)]


@dataclass(frozen=True)
class IntArrayParam(ArrayParam):
    name: str = ""
    n: int = 1
    lo: int = 0
    hi: int = 1

    def __post_init__(self):
        assert self.n >= 1, self.name

    def expand(self):
        return [IntParam(f"{self.name}[{i}]", lo=self.lo, hi=self.hi)
                for i in range(self.n)]


@dataclass(frozen=True)
class FloatArrayParam(ArrayParam):
    name: str = ""
    n: int = 1
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        assert self.n >= 1, self.name

    def expand(self):
        return [FloatParam(f"{self.name}[{i}]", lo=self.lo, hi=self.hi)
                for i in range(self.n)]


def infer_param(name: str, default: Any, space: Any) -> ParamSpec:
    """Infer a ParamSpec from a `ut.tune(default, space)` call, mirroring the
    type-dispatch of the reference's tune API
    (`/root/reference/python/uptune/template/tuneapi.py:35-93`)."""
    if isinstance(space, (list,)) and not isinstance(default, (list,)):
        return EnumParam(name, options=tuple(space))
    if isinstance(space, tuple) and len(space) == 2:
        lo, hi = space
        if isinstance(default, bool):
            return BoolParam(name)
        if isinstance(default, int) and isinstance(lo, int) and isinstance(hi, int):
            return IntParam(name, lo=lo, hi=hi)
        return FloatParam(name, lo=float(lo), hi=float(hi))
    if isinstance(default, bool):
        return BoolParam(name)
    if isinstance(default, list) and isinstance(space, list):
        # permutation: space is the item set, default the initial ordering
        return PermParam(name, items=tuple(space))
    raise TypeError(
        f"cannot infer parameter type for {name!r}: default={default!r} space={space!r}")
