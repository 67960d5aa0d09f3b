"""The gcc-options deployment's archived space and trials, and the GP's
training set built from them, in plain NumPy.

An archive (`exp_archives/gccreal_<payload>_<seed>.jsonl`) is a tuning
run of uptune's `samples/gcc-options/tune_gcc.py`: its first line holds
`space_sig`, the space as the tuner built it from the mined flags (one
`EnumParam(name=..., options=(...))` or `IntParam(name=..., lo=...,
hi=...)` a parameter), and each further line one trial: its unit vector
`u` and its QoR, the built binary's wall time in seconds (infinite for
a build or run that failed).

The training set (`training_set`) is the configuration's archived
trials first: the finite ones, each distinct `u` once, in the archives'
order; then rows drawn uniformly from the seed up to `gp.train_rows`,
each with a target drawn from the seed out of the archived QoRs."""
from __future__ import annotations

import ast
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def parse_signature(sig: List[str]) -> List[Dict[str, Any]]:
    """`space_sig` lines -> a configuration's `space` entries, in order
    (each line is read as a call with literal arguments, never run)."""
    out = []
    for line in sig:
        call = ast.parse(line, mode="eval").body
        if not isinstance(call, ast.Call) or call.args:
            raise ValueError(f"not a parameter: {line!r}")
        kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
        kind = getattr(call.func, "id", "")
        if kind == "EnumParam":
            out.append({"name": kw["name"], "kind": "enum",
                        "options": list(kw["options"])})
        elif kind == "IntParam":
            out.append({"name": kw["name"], "kind": "int",
                        "lo": int(kw["lo"]), "hi": int(kw["hi"])})
        else:
            raise ValueError(f"unknown parameter kind in {line!r}")
    return out


def archived(cfg: Dict[str, Any], root: Path = ROOT
             ) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's archived trials: (u [n, D] float32, QoR [n]
    float64), the finite ones, each distinct `u` once (the first), in
    the archives' order.  Raises when an archive's space is not the
    configuration's."""
    seen, us, qs = set(), [], []
    for rel in cfg["trials"]["archives"]:
        with open(root / rel) as fh:
            head = json.loads(fh.readline())
            if parse_signature(head["space_sig"]) != cfg["space"]:
                raise ValueError(f"{rel}: its space is not {cfg['name']}'s")
            for line in fh:
                t = json.loads(line)
                q = t.get("qor")
                if not isinstance(q, (int, float)) or not math.isfinite(q):
                    continue
                u = np.asarray(t["u"], np.float32)
                key = u.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                us.append(u)
                qs.append(float(q))
    return np.stack(us), np.asarray(qs, np.float64)


def training_set(cfg: Dict[str, Any], seed: int, root: Path = ROOT
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The GP's `gp.train_rows` training rows: (u [N, D] float32, targets
    [N] float32), the archived trials first (the first N when there are
    more), then rows drawn from `seed`."""
    n = int(cfg["gp"]["train_rows"])
    u, q = archived(cfg, root)
    u, q = u[:n], q[:n]
    rng = np.random.default_rng(int(seed))
    drawn = n - len(u)
    if drawn > 0:
        u = np.concatenate([u, rng.random((drawn, u.shape[1]),
                                          dtype=np.float32)])
        q = np.concatenate([q, rng.choice(q, size=drawn)])
    return u, q.astype(np.float32)
