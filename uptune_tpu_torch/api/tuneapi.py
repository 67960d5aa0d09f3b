"""`ut.tune()` — the intrusive tuning API.

Type-dispatch and call semantics follow the reference
(`python/uptune/template/tuneapi.py:35-93` and the typed
Tune* value-interception classes `template/types.py:57-235`), without the
instance-registry metaclass: the per-process protocol state lives in
`uptune_tpu_torch.api.state.STATE`.

    x = ut.tune(3, (1, 9))                # IntParam
    r = ut.tune(0.5, (0.0, 2.0))          # FloatParam
    f = ut.tune(True)                     # BoolParam
    o = ut.tune('-O2', ['-O1','-O2'])     # EnumParam
    p = ut.tune([0,1,2], [0,1,2])         # PermutationParam

In DEFAULT mode the call returns its default; in ANALYSIS mode it records
the parameter and returns the default; in TUNE/BEST mode it returns the
proposal value for this call site.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

from .state import ANALYSIS, BEST, STATE, TUNE


def _space_record(name: Optional[str], default: Any,
                  space: Any) -> dict:
    """Classify (default, space) exactly like the reference's tune()
    dispatch (tuneapi.py:35-93) into a serializable param record."""
    if isinstance(default, bool):
        return {"name": name, "type": "bool", "default": default}
    if isinstance(default, list):
        if not isinstance(space, (list, tuple)) or set(space) != set(default):
            raise TypeError(
                f"permutation default must be an ordering of its space: "
                f"{default!r} vs {space!r}")
        return {"name": name, "type": "perm", "default": list(default),
                "items": list(space)}
    if isinstance(space, (list,)):
        if default not in space:
            raise ValueError(f"default {default!r} not in options {space!r}")
        return {"name": name, "type": "enum", "default": default,
                "options": list(space)}
    if isinstance(space, tuple) and len(space) == 2:
        lo, hi = space
        if not (lo <= default <= hi):
            raise ValueError(f"default {default!r} outside ({lo!r}, {hi!r})")
        if isinstance(default, int) and isinstance(lo, int) \
                and isinstance(hi, int):
            return {"name": name, "type": "int", "default": default,
                    "lo": lo, "hi": hi}
        return {"name": name, "type": "float", "default": float(default),
                "lo": float(lo), "hi": float(hi)}
    if space is None and isinstance(default, bool):
        return {"name": name, "type": "bool", "default": default}
    raise TypeError(
        f"cannot classify tunable: default={default!r} space={space!r}")


def tune(default: Any, space: Any = None,
         name: Optional[str] = None) -> Any:
    """Declare a tunable value; returns the served value for this run."""
    if space is None and not isinstance(default, bool):
        raise TypeError("tune() needs a space unless default is a bool")
    mode = STATE.mode
    if mode == ANALYSIS:
        STATE.record_param(_space_record(name, default, space))
        return default
    if mode in (TUNE, BEST):
        val = STATE.next_value(name, default)
        return _coerce(val, default, space)
    return default


def _coerce(val: Any, default: Any, space: Any) -> Any:
    """JSON round-trips lose tuple/int-ness; restore the default's type."""
    if isinstance(default, bool):
        return bool(val)
    if isinstance(default, int) and not isinstance(val, list):
        return int(round(float(val)))
    if isinstance(default, float):
        return float(val)
    return val


# typed aliases mirroring template/types.py:153-235 (usable directly and
# from template-mode annotations)
def TuneInt(default: int, space: Tuple[int, int],
            name: Optional[str] = None) -> int:
    return tune(int(default), (int(space[0]), int(space[1])), name)


def TuneFloat(default: float, space: Tuple[float, float],
              name: Optional[str] = None) -> float:
    return tune(float(default), (float(space[0]), float(space[1])), name)


def TuneEnum(default: Any, options: Sequence[Any],
             name: Optional[str] = None) -> Any:
    return tune(default, list(options), name)


def TuneBool(default: bool, name: Optional[str] = None) -> bool:
    return tune(bool(default), None, name)


def TunePermutation(default: Sequence[Any],
                    name: Optional[str] = None) -> list:
    return tune(list(default), list(default), name)
