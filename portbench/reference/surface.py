"""The QoR surface that stands in for g++ builds in a Tuner campaign:
the float64 posterior mean of a GP over the configuration's archived
mmm builds (`gcc.archived`: the distinct finite trials), at the stated
hyperparameters.  It is computed on the host in float64 and never on
the card.

A configuration is read as the tuner hands it over: one value a
parameter in the space's order, an enum's option (its code is its
index among the options) and an int's integer.  Its features are
`RefSpace.features` of those values, so the surface is smooth over the
numeric flags and moves by whole lanes over the categorical ones."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from . import gcc
from . import gp as ref_gp
from .space import RefSpace


class Surface:
    def __init__(self, cfg: Dict[str, Any]):
        self.params = cfg["space"]
        if any(p["kind"] not in ("enum", "int") for p in self.params):
            raise ValueError("the surface reads enum and int parameters")
        self.ref = RefSpace(self.params, int(cfg["hash"]["multiplier_seed"]))
        self.codes = [{o: i for i, o in enumerate(p["options"])}
                      if p["kind"] == "enum" else None for p in self.params]
        s = cfg["objective"]["surface"]
        u, q = gcc.archived(cfg)
        vals, _ = self.ref.decode(u)
        x = torch.tensor(self.ref.features(u, vals, []), dtype=torch.float64)
        self.post = ref_gp.fit(x, torch.tensor(q, dtype=torch.float64),
                               float(s["lengthscale"]), float(s["noise"]),
                               float(s["ls_cat"]), self.ref.n_cont,
                               self.ref.n_cat)
        self.rows = len(q)

    def values(self, cfgs: Sequence[Sequence[Any]]) -> np.ndarray:
        """[B, D] float64 decoded values of configurations (an enum lane
        its option's code)."""
        out = np.empty((len(cfgs), len(self.params)), np.float64)
        for j, codes in enumerate(self.codes):
            col = [c[j] for c in cfgs]
            out[:, j] = [codes[v] for v in col] if codes is not None else col
        return out

    def __call__(self, cfgs: Sequence[Sequence[Any]]) -> np.ndarray:
        """[B] float64 QoR of configurations."""
        if not len(cfgs):
            return np.zeros(0)
        vals = self.values(cfgs)
        x = torch.tensor(self.ref.features(
            np.zeros((len(cfgs), len(self.params))), vals, []),
            dtype=torch.float64)
        p = self.post
        mu = ref_gp.kernel(p, x) @ p.alpha
        return (mu * p.std + p.mean).numpy()
