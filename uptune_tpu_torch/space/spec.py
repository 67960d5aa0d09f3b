"""The flat search-space encoding, on torch tensors.

Counterpart of `uptune_tpu/space/spec.py`.  A batch of B candidates over
a space with D scalar lanes and perm blocks of sizes (s0, s1, ...) is a
`CandBatch(u=[B, D] f32, perms=([B, s0] i64, ...))`: every scalar
parameter is one float32 lane holding a unit value in [0, 1], every
permutation parameter one block of item indices (int64 here, PyTorch's
index type; the JAX package holds int32 — the values are the same).

`Space` is a static description.  Its constant tables are built once in
numpy and copied to a device the first time a codec meets a tensor on
that device, so one `Space` serves CPU and CUDA tensors alike; the codecs
run on whatever device their input lies on.

Hashes are uint32 in the JAX package.  torch has no general uint32
arithmetic, so the port holds each u32 value in an int64 and masks with
``& 0xFFFFFFFF``: non-negative int64s order as the unsigned values do,
where a reinterpreted int32 would sort wrongly.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import rng
from ..device import DeviceLike, resolve_device
from . import params as P

U32 = 0xFFFFFFFF
_LN2 = 0.6931471805599453
_INV_LN2 = 1.4426950408889634
_LOG_FLOOR = -0.999                  # encode's floor under log1p
_MIN_RANGE = 1e-30                   # encode's least search range
_ONE_HOT = float(1.0 / np.sqrt(2))   # a one-hot column's scale


class CandBatch(NamedTuple):
    """A batch of candidate configurations in flat encoding."""
    u: torch.Tensor                     # [B, D] float32 unit values
    perms: Tuple[torch.Tensor, ...]     # each [B, size_k] int64 item indices

    @property
    def batch(self) -> int:
        return self.u.shape[0]

    def __getitem__(self, idx) -> "CandBatch":
        # batch-axis selection, so `cands[mask]` / `cands[sl]` just work
        if isinstance(idx, int) and not isinstance(idx, bool):
            raise TypeError("use slices/tensors; scalar indexing drops the "
                            "batch dim")
        return CandBatch(self.u[idx], tuple(p[idx] for p in self.perms))

    def concat(self, other: "CandBatch") -> "CandBatch":
        return concat_cands([self, other])


def concat_cands(cands: Sequence[CandBatch]) -> CandBatch:
    return CandBatch(
        torch.cat([c.u for c in cands], dim=0),
        tuple(torch.cat(ps, dim=0) for ps in zip(*[c.perms for c in cands])))


def pad_cands(cands: CandBatch, n: int) -> CandBatch:
    """Pad the batch axis to `n` rows by repeating row 0; a padding row is
    an exact in-batch duplicate of row 0, so dedup never counts it as
    novel."""
    b = cands.batch
    if b >= n:
        return cands
    pad = n - b
    return CandBatch(
        torch.cat([cands.u, cands.u[:1].expand(pad, -1)], dim=0),
        tuple(torch.cat([p, p[:1].expand(pad, -1)], dim=0)
              for p in cands.perms))


class _Tables(NamedTuple):
    """The codec constants of one Space on one device."""
    kind: torch.Tensor         # [D] i32
    slo: torch.Tensor          # [D] f32 search-scale bounds
    shi: torch.Tensor
    vlo: torch.Tensor          # [D] f32 decoded-value bounds
    vhi: torch.Tensor
    int_mask: torch.Tensor     # [D] bool: lanes hashed on their integer
    complex_mask: torch.Tensor  # [D] bool: randomize-if-differ lanes
    hash_lo: torch.Tensor      # [2, n_lanes] i64: low 16 bits of the u32
    hash_hi: torch.Tensor      #   hash multipliers / high 16 bits
    dep_mats: Tuple[Optional[torch.Tensor], ...]
    num_idx: torch.Tensor      # [D - n_cat] i64 numeric lanes
    cat_idx: torch.Tensor      # [n_cat] i64 categorical lanes


class _FeatureTables(NamedTuple):
    """What the features kernel (`csrc/features.cu`) reads besides the
    batch, on one device.  A row's slots are its D lanes (a numeric
    lane's snapped unit value, a categorical lane's code) and then its P
    perm positions."""
    kind: torch.Tensor         # [D] i32
    lanes: torch.Tensor        # [D, 4] f32: a lane's slo, shi, vlo, vhi
    cols: torch.Tensor         # [F, 2] i32: an output column's slot and
    #                            code (-1: the slot itself; else one-hot)
    items_of: torch.Tensor     # [P, 2] i32: a perm item's block, by its
    #                            first item of the P and its size


class Space:
    """Static description of a search space plus its codec tables.

    Mirrors `uptune_tpu.space.spec.Space`: per-lane kind, search-scale
    bounds (slo/shi), decoded-value bounds (vlo/vhi), the integer-lane
    and complex-lane masks, and the fixed-seed hash multipliers."""

    def __init__(self, specs: Sequence[P.ParamSpec]):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names: {names}")
        self.specs: Tuple[P.ParamSpec, ...] = tuple(specs)
        expanded: List[P.ParamSpec] = []
        self.array_groups: Dict[str, List[str]] = {}
        for s in specs:
            if isinstance(s, P.ArrayParam):
                children = s.expand()
                self.array_groups[s.name] = [c.name for c in children]
                expanded.extend(children)
            else:
                expanded.append(s)
        exp_names = [s.name for s in expanded]
        if len(set(exp_names)) != len(exp_names):
            dups = sorted({n for n in exp_names if exp_names.count(n) > 1})
            raise ValueError(
                f"parameter names collide after array expansion: {dups}")
        self.scalars: Tuple[P._ScalarSpec, ...] = tuple(
            s for s in expanded if not s.is_permutation)
        self.perm_specs: Tuple[P.PermParam, ...] = tuple(
            s for s in expanded if s.is_permutation)
        self.name_to_spec = {s.name: s for s in specs}

        D = len(self.scalars)
        kind = np.zeros(D, np.int32)
        slo = np.zeros(D, np.float32)
        shi = np.zeros(D, np.float32)
        vlo = np.zeros(D, np.float32)
        vhi = np.zeros(D, np.float32)
        for i, s in enumerate(self.scalars):
            kind[i] = s.kind
            a, b = s.scaled_range()
            slo[i], shi[i] = a, b
            if isinstance(s, P.SelectorParam):
                vlo[i], vhi[i] = 0, s.max_cutoff - 1
            elif isinstance(s, (P.FloatParam, P.IntParam, P.LogFloatParam,
                                P.LogIntParam)):
                vlo[i], vhi[i] = float(s.lo), float(s.hi)
            elif isinstance(s, P.Pow2Param):
                vlo[i], vhi[i] = s.exp_lo, s.exp_hi  # exponent bounds
            elif isinstance(s, P.BoolParam):
                vlo[i], vhi[i] = 0, 1
            elif isinstance(s, P.SwitchParam):
                vlo[i], vhi[i] = 0, s.n - 1
            elif isinstance(s, P.EnumParam):
                vlo[i], vhi[i] = 0, len(s.options) - 1
            else:  # pragma: no cover
                raise TypeError(s)
        # numpy masters of the tables (the f64 host codecs read these)
        self.kind_np, self.slo_np, self.shi_np = kind, slo, shi
        self.vlo_np, self.vhi_np = vlo, vhi
        self._int_mask_np = np.isin(
            kind, [P.INT, P.LOG_INT, P.POW2, P.BOOL, P.SWITCH, P.ENUM])
        self._complex_mask_np = kind >= P.COMPLEX_KIND_START
        self._cat_mask_np = np.isin(kind, [P.BOOL, P.SWITCH, P.ENUM])
        self.cat_lane_idx = np.nonzero(self._cat_mask_np)[0]
        self.num_lane_idx = np.nonzero(~self._cat_mask_np)[0]
        self.n_cat = int(self._cat_mask_np.sum())
        self.cat_code_counts = (vhi[self._cat_mask_np] + 1).astype(np.int32)
        self.cat_max_codes = (int(self.cat_code_counts.max())
                              if self.n_cat else 0)
        self.n_scalar = D
        self.perm_sizes: Tuple[int, ...] = tuple(
            p.size for p in self.perm_specs)
        self._dep_mats_np = tuple(
            np.array(p.dep_matrix(), dtype=bool)
            if isinstance(p, P.ScheduleParam) else None
            for p in self.perm_specs)
        # universal-hash multipliers (fixed seed => stable across runs and
        # equal to the JAX package's), odd u32 values
        rs = np.random.RandomState(0x5EED)
        n_lanes = D + sum(self.perm_sizes)
        self._hash_mults_np = (
            rs.randint(0, 2**31, size=(2, max(1, n_lanes)), dtype=np.int64)
            * 2 + 1).astype(np.uint32).astype(np.int64)
        self._tables_by_device: Dict[torch.device, _Tables] = {}
        self._feature_tables_by_device: Dict[torch.device,
                                             _FeatureTables] = {}

    # -- tables ------------------------------------------------------------
    def tables(self, device: torch.device) -> _Tables:
        """The codec constants on `device` (copied there once)."""
        device = torch.device(device)
        t = self._tables_by_device.get(device)
        if t is None:
            def put(a):
                return torch.as_tensor(a).to(device)
            m = self._hash_mults_np
            t = _Tables(
                put(self.kind_np), put(self.slo_np), put(self.shi_np),
                put(self.vlo_np), put(self.vhi_np), put(self._int_mask_np),
                put(self._complex_mask_np), put(m & 0xFFFF), put(m >> 16),
                tuple(None if d is None else put(d)
                      for d in self._dep_mats_np),
                put(self.num_lane_idx.astype(np.int64)),
                put(self.cat_lane_idx.astype(np.int64)))
            self._tables_by_device[device] = t
        return t

    def feature_tables(self, device: torch.device) -> _FeatureTables:
        """The features kernel's tables on `device` (copied there once).
        The perm blocks come to the kernel side by side in one tensor
        (`ops/features.py`), so a perm item's column is its index."""
        device = torch.device(device)
        ft = self._feature_tables_by_device.get(device)
        if ft is None:
            D, M = self.n_scalar, self.cat_max_codes
            cols = [(lane, -1) for lane in self.num_lane_idx]
            cols += [(D + q, -1) for q in range(sum(self.perm_sizes))]
            cols += [(lane, m) for lane in self.cat_lane_idx
                     for m in range(M)]
            items_of, start = [], 0
            for size in self.perm_sizes:
                items_of += [(start, size)] * size
                start += size

            def put(a, dtype):
                return torch.as_tensor(np.asarray(a, dtype)).to(device)
            ft = _FeatureTables(
                put(self.kind_np, np.int32),
                put(np.stack([self.slo_np, self.shi_np, self.vlo_np,
                              self.vhi_np], axis=1), np.float32),
                put(np.reshape(cols, (-1, 2)), np.int32),
                put(np.reshape(items_of, (-1, 2)), np.int32))
            self._feature_tables_by_device[device] = ft
        return ft

    # -- python niceties ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:
        return (f"Space(D={self.n_scalar} scalar lanes, "
                f"perms={list(self.perm_sizes)}, params={len(self.specs)})")

    def signature(self) -> List[str]:
        """Ordered structural signature (spec dataclass reprs) — equal to
        the JAX package's for the same specs."""
        return [repr(s) for s in self.specs]

    def search_space_size(self) -> float:
        """Product of per-parameter sizes (the JAX package's
        `Space.search_space_size`)."""
        out = 1.0
        for s in self.specs:
            out *= s.search_space_size()
        return out

    # -- device codecs -----------------------------------------------------
    def decode_scalars(self, u: torch.Tensor) -> torch.Tensor:
        """Unit lanes [..., D] -> decoded values [..., D] float32.

        Same arithmetic, in the same order, as the JAX decode.  `expm1`
        (LOG lanes) differs from XLA's by a few ulps, so a LOG_INT value
        that sits on a .5 rounding boundary can decode to a neighbouring
        integer here and hash differently; away from such boundaries the
        integer lanes decode identically."""
        t = self.tables(u.device)
        s = u * (t.shi - t.slo) + t.slo
        kind = t.kind
        val = s  # FLOAT
        # torch.round, like jnp.round, rounds half to even
        val = torch.where(kind == P.INT,
                          _clip(torch.round(s), t.vlo, t.vhi), val)
        # LOG_FLOAT: 2**s - 1 + lo as expm1(s*ln2) + lo (no cancellation
        # near s == 0 in f32)
        log_val = torch.expm1(s * _LN2) + t.vlo
        val = torch.where(kind == P.LOG_FLOAT, log_val, val)
        val = torch.where(kind == P.LOG_INT,
                          _clip(torch.round(log_val), t.vlo, t.vhi), val)
        # POW2: 2**round(exponent) — an integer exponent, exact in f32
        val = torch.where(kind == P.POW2,
                          torch.exp2(_clip(torch.round(s), t.vlo, t.vhi)),
                          val)
        code = _clip(torch.round(s), t.vlo, t.vhi)
        val = torch.where(kind >= P.BOOL, code, val)
        return val.to(torch.float32)

    def encode_scalars(self, vals: torch.Tensor) -> torch.Tensor:
        """Decoded values [..., D] -> unit lanes (inverse of decode)."""
        t = self.tables(vals.device)
        kind = t.kind
        s = vals
        s = torch.where((kind == P.LOG_FLOAT) | (kind == P.LOG_INT),
                        torch.log1p(torch.clamp_min(vals - t.vlo, _LOG_FLOOR))
                        * _INV_LN2, s)
        s = torch.where(kind == P.POW2,
                        torch.log2(torch.clamp_min(vals, 1.0)), s)
        rng_ = torch.clamp_min(t.shi - t.slo, _MIN_RANGE)
        return torch.clamp((s - t.slo) / rng_, 0.0, 1.0).to(torch.float32)

    def random(self, gen: rng.Stream, n: int) -> CandBatch:
        """Uniform random batch on the stream's device — a draw step:
        u ~ U[0,1)^D per row and one independent permutation per row and
        block, then `normalize` (the only pure part)."""
        u = rng.uniform(gen, (n, self.n_scalar))
        perms = tuple(rng.permutations(gen, n, size)
                      for size in self.perm_sizes)
        return self.normalize(CandBatch(u, perms))

    def seed_default(self, n: int, device: DeviceLike = "cuda") -> CandBatch:
        """n copies of the seed configuration: scalar seed = lo, perm
        seed = identity ordering."""
        device = resolve_device(device)
        t = self.tables(device)
        u0 = self.encode_scalars(
            torch.where(t.kind == P.POW2, torch.exp2(t.vlo), t.vlo))
        u = u0[None, :].repeat(n, 1)
        perms = tuple(
            torch.arange(size, device=device)[None, :].repeat(n, 1)
            for size in self.perm_sizes)
        return self.normalize(CandBatch(u, perms))

    def normalize(self, cands: CandBatch) -> CandBatch:
        """Topologically normalise ScheduleParam blocks; other blocks pass
        through."""
        from ..ops import perm as perm_ops  # local import to avoid cycle
        dev = cands.u.device
        deps = self.tables(dev).dep_mats
        perms = tuple(
            perm_ops.toposort_batch(pm, dep) if dep is not None else pm
            for pm, dep in zip(cands.perms, deps))
        return CandBatch(cands.u, perms)

    def canonical_lanes(self, cands: CandBatch) -> torch.Tensor:
        """[B, n_lanes] int32 hashing representation: integer lanes use
        their decoded integer, float lanes a 2^16 unit-space grid, perm
        blocks append their indices."""
        t = self.tables(cands.u.device)
        vals = self.decode_scalars(cands.u)
        as_int = torch.round(vals).to(torch.int32)
        as_grid = torch.round(cands.u * 65536.0).to(torch.int32)
        lanes = torch.where(t.int_mask, as_int, as_grid)
        parts = [lanes] + [p.to(torch.int32) for p in cands.perms]
        return torch.cat(parts, dim=-1) if len(parts) > 1 else lanes

    @property
    def n_features(self) -> int:
        return self.n_scalar + sum(self.perm_sizes)

    def features(self, cands: CandBatch) -> torch.Tensor:
        """[B, n_features] f32 surrogate features: unit lanes as-is, then
        each perm block's normalized item positions."""
        parts = [cands.u]
        for pm, size in zip(cands.perms, self.perm_sizes):
            pos = torch.argsort(pm, dim=-1).to(torch.float32) / max(
                1, size - 1)
            parts.append(pos)
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    @property
    def n_cont_features(self) -> int:
        """Leading continuous-block width of `surrogate_transform`'s
        output: the numeric lanes, then every perm position lane."""
        return (self.n_scalar - self.n_cat) + sum(self.perm_sizes)

    @property
    def n_surrogate_features(self) -> int:
        # one-hot blocks are padded to cat_max_codes per lane; a padding
        # column is 0 on both sides of any distance, so it is inert
        return self.n_cont_features + self.n_cat * self.cat_max_codes

    def surrogate_transform(self, feats: torch.Tensor) -> torch.Tensor:
        """`features()` output [..., n_features] -> the GP's features
        [..., n_surrogate_features]: numeric lanes snapped to their
        decoded grid (decode, then encode), perm position lanes passed
        through, and each categorical lane one-hot over cat_max_codes
        codes, scaled by 1/sqrt(2) so the squared distance over the
        block is the Hamming distance."""
        D = self.n_scalar
        u = feats[..., :D]
        vals = self.decode_scalars(u)
        u_snap = self.encode_scalars(vals)
        dev = feats.device
        t = self.tables(dev)
        parts = [u_snap[..., t.num_idx], feats[..., D:]]
        if self.n_cat:
            codes = vals[..., t.cat_idx]
            oh = codes[..., None] == torch.arange(
                self.cat_max_codes, dtype=torch.float32, device=dev)
            oh = oh.reshape(*codes.shape[:-1],
                            self.n_cat * self.cat_max_codes)
            parts.append(oh.to(torch.float32) * _ONE_HOT)
        return torch.cat(parts, dim=-1)

    def surrogate_features(self, cands: CandBatch) -> torch.Tensor:
        """`surrogate_transform(features(cands))`, the GP's query
        features [..., n_surrogate_features]: on the CPU that chain of
        torch ops; on a CUDA batch one launch of the features kernel
        (`ops/features.py`, `csrc/features.cu`), bitwise equal."""
        if cands.u.device.type == "cpu":
            return self.surrogate_transform(self.features(cands))
        from ..ops import features as feature_ops
        return feature_ops.surrogate_features(
            cands.u, cands.perms, self.feature_tables(cands.u.device))

    def hash_batch(self, cands: CandBatch) -> torch.Tensor:
        """[B, 2] int64, each holding a u32: the multiply-sum universal
        hash of the canonical lanes, mod 2^32 — bitwise the JAX package's
        uint32 wraparound `(lanes[..., None, :] * mults).sum(-1)`.

        uint32: each lane is taken as u32 (`& 0xFFFFFFFF` of the int32)
        and each multiplier is split into 16-bit halves, so no int64
        product overflows: lane * m = lane * m_lo + (lane * m_hi mod
        2^16) << 16 (mod 2^32)."""
        t = self.tables(cands.u.device)
        lanes = (self.canonical_lanes(cands).to(torch.int64) & U32)
        lanes = lanes[..., None, :]                       # [B, 1, L]
        lo = lanes * t.hash_lo                            # < 2^48
        hi = ((lanes * t.hash_hi) & 0xFFFF) << 16         # < 2^32
        return ((lo + hi) & U32).sum(dim=-1) & U32        # [B, 2]

    # -- host codecs (evaluation boundary), float64 numpy ------------------
    # The device decode agrees with these to f32 transcendental accuracy;
    # these are exact inverses to f64 precision (hash-stable replay).
    def decode_scalars_np(self, u: np.ndarray) -> np.ndarray:
        kind = self.kind_np
        slo = self.slo_np.astype(np.float64)
        shi = self.shi_np.astype(np.float64)
        vlo = self.vlo_np.astype(np.float64)
        vhi = self.vhi_np.astype(np.float64)
        s = np.asarray(u, np.float64) * (shi - slo) + slo
        val = s.copy()
        m = kind == P.INT
        val[..., m] = np.clip(np.round(s[..., m]), vlo[m], vhi[m])
        m = kind == P.LOG_FLOAT
        val[..., m] = np.expm1(s[..., m] * np.log(2.0)) + vlo[m]
        m = kind == P.LOG_INT
        val[..., m] = np.clip(
            np.round(np.expm1(s[..., m] * np.log(2.0)) + vlo[m]),
            vlo[m], vhi[m])
        m = kind == P.POW2
        val[..., m] = np.exp2(np.clip(np.round(s[..., m]), vlo[m], vhi[m]))
        m = kind >= P.BOOL
        val[..., m] = np.clip(np.round(s[..., m]), vlo[m], vhi[m])
        return val

    def encode_scalars_np(self, vals: np.ndarray) -> np.ndarray:
        kind = self.kind_np
        slo = self.slo_np.astype(np.float64)
        shi = self.shi_np.astype(np.float64)
        vlo = self.vlo_np.astype(np.float64)
        s = np.asarray(vals, np.float64).copy()
        m = (kind == P.LOG_FLOAT) | (kind == P.LOG_INT)
        s[..., m] = np.log1p(np.maximum(s[..., m] - vlo[m], -0.999)) / np.log(
            2.0)
        m = kind == P.POW2
        s[..., m] = np.log2(np.maximum(s[..., m], 1.0))
        rng_ = np.maximum(shi - slo, 1e-30)
        return np.clip((s - slo) / rng_, 0.0, 1.0).astype(np.float32)

    def to_configs(self, cands: CandBatch) -> List[Dict[str, Any]]:
        """Decode a batch into user-facing config dicts."""
        vals = self.decode_scalars_np(cands.u.detach().cpu().numpy())
        perms = [p.detach().cpu().numpy() for p in cands.perms]
        out: List[Dict[str, Any]] = []
        for b in range(vals.shape[0]):
            cfg: Dict[str, Any] = {}
            for i, s in enumerate(self.scalars):
                v = vals[b, i]
                if isinstance(s, P.SelectorParam):
                    cfg[s.name] = s.choice_of(int(round(float(v))))
                elif isinstance(s, (P.FloatParam, P.LogFloatParam)):
                    cfg[s.name] = float(v)
                elif isinstance(s, P.EnumParam):
                    cfg[s.name] = s.options[int(round(float(v)))]
                elif isinstance(s, P.BoolParam):
                    cfg[s.name] = bool(round(float(v)))
                else:  # INT / LOG_INT / POW2 / SWITCH
                    cfg[s.name] = int(round(float(v)))
            for k, s in enumerate(self.perm_specs):
                cfg[s.name] = [s.items[int(i)] for i in perms[k][b]]
            for parent, children in self.array_groups.items():
                cfg[parent] = [cfg.pop(c) for c in children]
            out.append(cfg)
        return out

    def from_configs(self, cfgs: Sequence[Dict[str, Any]],
                     device: DeviceLike = "cuda") -> CandBatch:
        """Encode user config dicts into a batch on `device` (same
        hash-stability contract as the JAX package's `from_configs`)."""
        device = resolve_device(device)
        B = len(cfgs)
        if self.array_groups:
            flat = []
            for cfg in cfgs:
                cfg = dict(cfg)
                for parent, children in self.array_groups.items():
                    seq = cfg.pop(parent)
                    if len(seq) != len(children):
                        raise ValueError(
                            f"array {parent!r} needs {len(children)} "
                            f"elements, got {len(seq)}")
                    cfg.update(zip(children, seq))
                flat.append(cfg)
            cfgs = flat
        vals = np.zeros((B, self.n_scalar), np.float64)
        for b, cfg in enumerate(cfgs):
            for i, s in enumerate(self.scalars):
                v = cfg[s.name]
                if isinstance(s, P.SelectorParam):
                    vals[b, i] = s.pos_of(v)
                elif isinstance(s, P.EnumParam):
                    vals[b, i] = s.options.index(v)
                elif isinstance(s, P.BoolParam):
                    vals[b, i] = float(bool(v))
                else:
                    vals[b, i] = float(v)
        u = torch.from_numpy(self.encode_scalars_np(vals)).to(device)
        perms = []
        for s in self.perm_specs:
            block = np.zeros((B, s.size), np.int64)
            for b, cfg in enumerate(cfgs):
                block[b] = [s.items.index(it) for it in cfg[s.name]]
            perms.append(torch.from_numpy(block).to(device))
        return self.normalize(CandBatch(u, tuple(perms)))


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi) with XLA's
    signed zeros: max(-0, +0) is +0 and min(-0, +0) is -0.  torch's
    maximum/minimum return either zero depending on the kernel path (a
    broadcast operand changes it), and round(-0.3) is -0.0, so a code
    lane would otherwise decode to -0.0 where the JAX package has 0.0."""
    x = torch.where((x > lo) | ((x == lo) & ~torch.signbit(x)), x, lo)
    return torch.where((x < hi) | ((x == hi) & torch.signbit(x)), x, hi)
