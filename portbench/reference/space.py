"""A configuration's search space, in float64 NumPy: decoding a unit
vector into values, membership, the canonical lanes and their hash, and
the GP's features.

Semantics (the configuration file's `space` and `hash`): each scalar
lane holds u in [0, 1], mapped linearly onto its search scale [slo, shi]
(OpenTuner's manipulator, integer kinds widened by 0.4999 on each side):

- float [lo, hi]: the value is s itself;
- int [lo, hi]: round(s) (half to even), clipped to [lo, hi];
- log_int [lo, hi]: s on log2(v + 1 - lo), so v = round(2^s - 1 + lo);
- pow2 [lo, hi]: s is the exponent, v = 2^round(s);
- bool, enum: s is the code, round(s) clipped to the codes.

A permutation block holds a row of item indices.  The canonical lanes
are the integer lanes' values, the float lanes' u on a 2^16 grid, then
the permutation indices; the hash is two multiply-sums of them mod 2^32.

The program decodes in float32, so an integer lane whose unrounded value
lies within float32's reach of a .5 boundary may round either way: such
a lane is `ambiguous`, and either rounding is a member of it.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

NUMERIC = ("float", "int", "log_int", "pow2")
CATEGORICAL = ("bool", "enum")
WIDEN = 0.4999
GRID = 65536.0
U32 = (1 << 32) - 1


def _ambiguity(r: np.ndarray) -> np.ndarray:
    """How close an unrounded value may come to a .5 boundary and still
    round the other way in float32: some float32 ulps of it, and of the
    search scale it came from."""
    return 8e-6 * np.maximum(1.0, np.abs(r)) + 1e-5


class RefSpace:
    def __init__(self, params: List[dict], hash_seed: int):
        self.scalars = [p for p in params if p["kind"] != "perm"]
        self.perms = [p for p in params if p["kind"] == "perm"]
        lo, hi, kinds = [], [], []
        for p in self.scalars:
            k = p["kind"]
            kinds.append(k)
            if k == "float":
                a, b = p["lo"], p["hi"]
            elif k == "int":
                a, b = p["lo"] - WIDEN, p["hi"] + WIDEN
            elif k == "log_int":
                a = math.log2(max(p["lo"] - WIDEN, -0.999) + 1.0 - p["lo"])
                b = math.log2(p["hi"] + WIDEN + 1.0 - p["lo"])
            elif k == "pow2":
                a = math.log2(p["lo"]) - WIDEN
                b = math.log2(p["hi"]) + WIDEN
            elif k == "bool":
                a, b = -WIDEN, 1.0 + WIDEN
            elif k == "enum":
                a, b = -WIDEN, len(p["options"]) - 1 + WIDEN
            else:
                raise ValueError(f"unknown kind {k!r}")
            lo.append(a)
            hi.append(b)
        self.kinds = kinds
        self.slo = np.array(lo, np.float64)
        self.shi = np.array(hi, np.float64)
        self.perm_sizes = [int(p["items"]) for p in self.perms]
        self.num_idx = [i for i, k in enumerate(kinds) if k in NUMERIC]
        self.cat_idx = [i for i, k in enumerate(kinds) if k in CATEGORICAL]
        self.cat_codes = max([self._codes(i) for i in self.cat_idx] or [0])
        n_lanes = len(self.scalars) + sum(self.perm_sizes)
        rs = np.random.RandomState(hash_seed)
        self.mults = (rs.randint(0, 2 ** 31, size=(2, max(1, n_lanes)),
                                 dtype=np.int64) * 2 + 1)

    def _codes(self, i: int) -> int:
        p = self.scalars[i]
        return 2 if p["kind"] == "bool" else len(p["options"])

    @property
    def n_cont(self) -> int:
        return len(self.num_idx) + sum(self.perm_sizes)

    @property
    def n_cat(self) -> int:
        return len(self.cat_idx)

    # -- decoding -------------------------------------------------------------
    def unrounded(self, u: np.ndarray) -> np.ndarray:
        """[B, D] unit lanes -> the value before any rounding (the value
        of a float lane; the exponent of a pow2 lane)."""
        s = np.asarray(u, np.float64) * (self.shi - self.slo) + self.slo
        r = s.copy()
        for i, k in enumerate(self.kinds):
            if k == "log_int":
                r[:, i] = np.expm1(s[:, i] * math.log(2.0)) + \
                    self.scalars[i]["lo"]
        return r

    def decode(self, u: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[B, D] -> (values [B, D] float64, ambiguous [B, D] bool).
        Integer kinds give their integer (a pow2 lane its power of two);
        `ambiguous` marks integer lanes that float32 may round the other
        way."""
        r = self.unrounded(u)
        v = r.copy()
        amb = np.zeros(r.shape, bool)
        for i, k in enumerate(self.kinds):
            if k == "float":
                continue
            lo, hi = self._int_range(i)
            rr = r[:, i]
            amb[:, i] = (np.abs(rr - np.floor(rr) - 0.5) < _ambiguity(rr)) \
                & (rr > lo - 0.5) & (rr < hi + 0.5)
            v[:, i] = np.clip(np.round(rr), lo, hi)
            if k == "pow2":
                v[:, i] = np.exp2(v[:, i])
        return v, amb

    def _int_range(self, i: int) -> Tuple[float, float]:
        """The range of a lane's rounded integer (the exponent's for
        pow2, the code's for bool and enum)."""
        p = self.scalars[i]
        k = p["kind"]
        if k in ("int", "log_int"):
            return p["lo"], p["hi"]
        if k == "pow2":
            return math.log2(p["lo"]), math.log2(p["hi"])
        return 0, self._codes(i) - 1

    def resolve(self, u: np.ndarray, program_vals: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The reference's values, taking the program's rounding on the
        ambiguous lanes where it is one of the two allowed: -> (values,
        [B] count of lanes where the program's value is no member of
        the lane or differs from the reference's)."""
        v, amb = self.decode(u)
        pv = np.asarray(program_vals, np.float64)
        r = self.unrounded(u)
        bad = np.zeros(v.shape[0], np.int64)
        for i, k in enumerate(self.kinds):
            if k == "float":
                tol = 1e-6 * max(abs(self.slo[i]), abs(self.shi[i]), 1.0)
                bad += np.abs(pv[:, i] - v[:, i]) > tol
                continue
            lo, hi = self._int_range(i)
            p_int = np.log2(np.maximum(pv[:, i], 1e-300)) \
                if k == "pow2" else pv[:, i]
            allowed = (p_int == np.floor(r[:, i])) | \
                (p_int == np.ceil(r[:, i]))
            allowed &= (p_int >= lo) & (p_int <= hi)
            take = amb[:, i] & allowed
            v[take, i] = pv[take, i]
            bad += (pv[:, i] != v[:, i])
        return v, bad

    def members(self, u: np.ndarray, perms: List[np.ndarray]) -> np.ndarray:
        """[B] bool: every unit lane finite in [0, 1] and every
        permutation block a permutation of its items."""
        u = np.asarray(u, np.float64)
        ok = np.isfinite(u).all(1) & (u >= 0).all(1) & (u <= 1).all(1)
        for pm, n in zip(perms, self.perm_sizes):
            pm = np.asarray(pm)
            ok &= (pm.shape[1] == n) & (np.sort(pm, 1) == np.arange(n)).all(1)
        return ok

    # -- the hash -------------------------------------------------------------
    def lanes(self, u: np.ndarray, vals: np.ndarray,
              perms: List[np.ndarray]) -> np.ndarray:
        """[B, L] int64 canonical lanes."""
        u = np.asarray(u, np.float64)
        cols = []
        for i, k in enumerate(self.kinds):
            if k == "float":
                cols.append(np.round(u[:, i] * GRID))
            elif k == "pow2":
                cols.append(vals[:, i])          # the power of two
            else:
                cols.append(vals[:, i])
        out = np.stack(cols, 1).astype(np.int64) if cols else \
            np.zeros((u.shape[0], 0), np.int64)
        return np.concatenate([out] + [np.asarray(p, np.int64)
                                       for p in perms], 1)

    def hash(self, lanes: np.ndarray) -> np.ndarray:
        """[B, L] -> [B, 2] u32 values (as int64): the sum of lane * mult
        mod 2^32, each lane taken as its unsigned 32-bit pattern (uint64
        products and sums wrap mod 2^64, which keeps them mod 2^32)."""
        ln = (lanes.astype(np.int64) & U32).astype(np.uint64)
        m = self.mults[:, :lanes.shape[1]].astype(np.uint64)
        with np.errstate(over="ignore"):
            out = (ln[:, None, :] * m[None]).sum(-1, dtype=np.uint64)
        return (out & np.uint64(U32)).astype(np.int64)

    # -- the GP's features ----------------------------------------------------
    def features(self, u: np.ndarray, vals: np.ndarray,
                 perms: List[np.ndarray]) -> np.ndarray:
        """[B, n_cont + n_cat * codes] float64: the numeric lanes at their
        decoded values mapped back onto [0, 1], each permutation's item
        positions over (n - 1), then each categorical lane one-hot over
        the codes scaled by 1/sqrt(2) (its squared distances count
        differing lanes)."""
        cols = []
        for i in self.num_idx:
            k = self.kinds[i]
            v = vals[:, i]
            if k == "float":
                s = np.asarray(u, np.float64)[:, i] * (
                    self.shi[i] - self.slo[i]) + self.slo[i]
            elif k == "int":
                s = v
            elif k == "log_int":
                s = np.log2(v - self.scalars[i]["lo"] + 1.0)
            else:
                s = np.log2(v)
            cols.append(np.clip((s - self.slo[i]) / (self.shi[i]
                                                     - self.slo[i]), 0, 1))
        for pm, n in zip(perms, self.perm_sizes):
            pos = np.argsort(np.asarray(pm), 1).astype(np.float64)
            cols.extend(pos.T / max(1, n - 1))
        for i in self.cat_idx:
            code = vals[:, i].astype(np.int64)
            for c in range(self.cat_codes):
                cols.append((code == c) / math.sqrt(2.0))
        return np.stack(cols, 1)
