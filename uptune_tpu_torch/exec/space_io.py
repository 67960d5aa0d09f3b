"""Bridge between the JSON param records written by the intrusive API
(`ut.params.json`, see api/state.py) and the device-side
`Space`.

The reference builds an OpenTuner ConfigurationManipulator from the same
records (`python/uptune/api.py:179-199` create_params);
here each record becomes one typed ParamSpec lane of a flat-encoded
Space.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from ..space import params as P
from ..space.spec import Space


def _spec_from_record(rec: Dict[str, Any]) -> P.ParamSpec:
    name, kind = rec["name"], rec["type"]
    if kind == "int":
        return P.IntParam(name, int(rec["lo"]), int(rec["hi"]))
    if kind == "float":
        return P.FloatParam(name, float(rec["lo"]), float(rec["hi"]))
    if kind == "bool":
        return P.BoolParam(name)
    if kind == "enum":
        opts = rec["options"]
        # JSON round-trips lists; options must be hashable for codecs
        return P.EnumParam(name, tuple(
            tuple(o) if isinstance(o, list) else o for o in opts))
    if kind == "perm":
        return P.PermParam(name, tuple(
            tuple(o) if isinstance(o, list) else o for o in rec["items"]))
    if kind == "log_int":
        return P.LogIntParam(name, int(rec["lo"]), int(rec["hi"]))
    if kind == "log_float":
        return P.LogFloatParam(name, float(rec["lo"]), float(rec["hi"]))
    if kind == "pow2":
        return P.Pow2Param(name, int(rec["lo"]), int(rec["hi"]))
    if kind == "selector":
        return P.SelectorParam(name, tuple(rec["choices"]),
                               int(rec.get("max_cutoff", 0)))
    if kind == "bool_array":
        return P.BoolArrayParam(name, int(rec["n"]))
    if kind == "int_array":
        return P.IntArrayParam(name, int(rec["n"]), int(rec["lo"]),
                               int(rec["hi"]))
    if kind == "float_array":
        return P.FloatArrayParam(name, int(rec["n"]), float(rec["lo"]),
                                 float(rec["hi"]))
    raise ValueError(f"unknown param record type {kind!r} for {name!r}")


def space_from_params(records: Sequence[Dict[str, Any]]) -> Space:
    """Build a Space from ONE stage's param records."""
    return Space([_spec_from_record(r) for r in records])


def stage_spaces(all_records: Sequence[Sequence[Dict[str, Any]]]
                 ) -> List[Space]:
    """Build one Space per stage from the full ut.params.json payload."""
    return [space_from_params(stage) for stage in all_records]


def records_from_space(space: Space) -> List[Dict[str, Any]]:
    """The inverse bridge: serialize a library `Space` back into the
    JSON param records `space_from_params` consumes.  The session
    client (uptune_tpu/serve) sends these over the wire so a server
    rebuilds an identical Space — identical `Space.signature()`, so two
    tenants opening from the same Space land in the same engine group.
    Only JSON-representable option/item values survive the round trip
    (the wire format is JSON); ScheduleParam dependencies do not cross
    the wire."""
    out: List[Dict[str, Any]] = []
    for s in space.specs:
        if isinstance(s, P.ScheduleParam):
            raise ValueError(
                f"ScheduleParam {s.name!r} is not wire-serializable")
        if isinstance(s, P.PermParam):
            out.append({"name": s.name, "type": "perm",
                        "items": [list(o) if isinstance(o, tuple) else o
                                  for o in s.items]})
        elif isinstance(s, P.SelectorParam):
            out.append({"name": s.name, "type": "selector",
                        "choices": list(s.choices),
                        "max_cutoff": s.max_cutoff})
        elif isinstance(s, P.EnumParam):
            out.append({"name": s.name, "type": "enum",
                        "options": [list(o) if isinstance(o, tuple) else o
                                    for o in s.options]})
        elif isinstance(s, P.BoolArrayParam):
            out.append({"name": s.name, "type": "bool_array", "n": s.n})
        elif isinstance(s, P.IntArrayParam):
            out.append({"name": s.name, "type": "int_array", "n": s.n,
                        "lo": s.lo, "hi": s.hi})
        elif isinstance(s, P.FloatArrayParam):
            out.append({"name": s.name, "type": "float_array", "n": s.n,
                        "lo": s.lo, "hi": s.hi})
        elif isinstance(s, P.BoolParam):
            out.append({"name": s.name, "type": "bool"})
        elif isinstance(s, (P.LogIntParam,)):
            out.append({"name": s.name, "type": "log_int",
                        "lo": s.lo, "hi": s.hi})
        elif isinstance(s, (P.LogFloatParam,)):
            out.append({"name": s.name, "type": "log_float",
                        "lo": s.lo, "hi": s.hi})
        elif isinstance(s, P.Pow2Param):
            out.append({"name": s.name, "type": "pow2",
                        "lo": s.lo, "hi": s.hi})
        elif isinstance(s, P.IntParam):
            out.append({"name": s.name, "type": "int",
                        "lo": s.lo, "hi": s.hi})
        elif isinstance(s, P.FloatParam):
            out.append({"name": s.name, "type": "float",
                        "lo": s.lo, "hi": s.hi})
        else:
            raise ValueError(
                f"no wire form for param {s.name!r} ({type(s).__name__})")
    return out


def default_config(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The program's declared defaults as a config dict (the seed trial —
    the reference captures its QoR in the profiling run)."""
    out = {}
    for r in records:
        v = r.get("default")
        out[r["name"]] = list(v) if r["type"] == "perm" else v
    return out
