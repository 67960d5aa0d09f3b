"""QuickEst estimator pipeline, in torch (see package docstring).

Counterpart of `uptune_tpu/quickest/pipeline.py`.  The lasso is an eager
ISTA loop in float32 on the model's device (its step size from the host,
as the JAX package computes it), and the MLP ensemble is the port's
`surrogate/mlp.py`, whose init draws come from the port's generator
(`rng.generator(seed)` through `draw_init`), so a model stays a pure
function of (data, seed); `_TargetModel.fit(..., init=)` takes given
draws instead (the tests replay JAX's).  A model directory has the JAX
package's layout (quickest.json + one npz a target, the MLP leaves in
the same order and shapes), so either package loads what the other
saved.  `device=` (default the card) is not a model option: it is not
saved.

Reference behavior being matched (file:line into the reference's python/
uptune/quickest/):
* per-target model zoo with lasso + tree regressor (`train.py:190-320`
  train_models) -> here lasso (JAX ISTA) + MLP ensemble;
* model assembly: a linear head over member predictions fit on held-out
  data (`train.py:321-500` assemble_models / model_weights);
* feature selection by lasso coefficients (`train.py:369-402`
  select_features);
* metrics: R2 and relative absolute error per target
  (`test.py:91-186` test_models);
* persistence: a model database keyed by target (`train.py` pickles ->
  here a directory of npz + json, no pickle).
"""
from __future__ import annotations

import csv
import json
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:   # the module imports torch only when a model runs
    from ..device import DeviceLike


# ---------------------------------------------------------------- data
def load_csv(path: str, target_cols: Sequence[str]
             ) -> Tuple[np.ndarray, np.ndarray, List[str], List[str]]:
    """Load a feature CSV (header row; numeric cells; non-numeric cells
    become NaN -> imputed by preprocess).  Returns
    (X, Y, feature_names, target_names)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]   # skip blank lines
    if not rows or len(rows) < 2:
        raise ValueError(f"{path}: need a header row + data rows")
    header = [h.strip() for h in rows[0]]
    missing = [t for t in target_cols if t not in header]
    if missing:
        raise ValueError(f"{path}: target columns {missing} not in header")
    t_idx = [header.index(t) for t in target_cols]
    f_idx = [i for i in range(len(header)) if i not in t_idx]

    def num(cell: str) -> float:
        try:
            return float(cell)
        except ValueError:
            return float("nan")

    data = np.asarray([[num(c) for c in r] for r in rows[1:]], np.float32)
    return (data[:, f_idx], data[:, t_idx],
            [header[i] for i in f_idx], [header[i] for i in t_idx])


def preprocess(x: np.ndarray, *, impute: bool = True,
               drop_constant: bool = True
               ) -> Tuple[np.ndarray, Dict[str, list]]:
    """Column-median imputation + constant-column drop (the reference's
    preprocess.py:56-200 cleanup, minus its workload-specific renames).
    Returns (X_clean, meta) where meta['kept'] indexes original columns
    — apply the same meta to inference-time features via
    `apply_preprocess`."""
    x = np.asarray(x, np.float32).copy()
    finite = np.isfinite(x)
    # column-safe median: all-NaN columns (e.g. a text path column from
    # an extractor CSV) impute to 0 without numpy's All-NaN warning
    med = np.zeros(x.shape[1], np.float32)
    for j in range(x.shape[1]):
        col = x[finite[:, j], j]
        if col.size:
            med[j] = np.median(col)
    if impute:
        bad = ~np.isfinite(x)
        x[bad] = np.broadcast_to(med, x.shape)[bad]
    kept = list(range(x.shape[1]))
    if drop_constant:
        keep = x.std(0) > 1e-12
        kept = [i for i in range(x.shape[1]) if keep[i]]
        x = x[:, keep]
    return x, {"kept": kept, "median": med.tolist()}


def apply_preprocess(x: np.ndarray, meta: Dict[str, list]) -> np.ndarray:
    x = np.asarray(x, np.float32).copy()
    med = np.asarray(meta["median"], np.float32)
    bad = ~np.isfinite(x)
    x[bad] = np.broadcast_to(med, x.shape)[bad]
    return x[:, meta["kept"]]


# ------------------------------------------------------------- metrics
def r2_score(y: np.ndarray, pred: np.ndarray) -> float:
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return 1.0 - ss_res / max(ss_tot, 1e-12)


def rae(y: np.ndarray, pred: np.ndarray) -> float:
    """Relative absolute error (the reference's headline metric)."""
    return float(np.abs(y - pred).sum() /
                 max(np.abs(y - y.mean()).sum(), 1e-12))


# -------------------------------------------------------- torch models
def _lasso_fit(x, y, lam: float, steps: int = 500):
    """L1 linear regression by ISTA on standardized inputs (float32
    tensors on one device); returns (w, b) in standardized space, as
    tensors there.  The step size comes from the host copy of x."""
    import torch

    from ..surrogate.gp import full_f32

    n, f = x.shape
    lr = 1.0 / max(float(np.linalg.norm(x.cpu().numpy(), 2) ** 2 / n),
                   1e-8)
    w = torch.zeros(f, device=x.device)
    b = torch.zeros((), device=x.device)
    with full_f32():
        for _ in range(steps):
            pred = x @ w + b
            g_w = (x.T @ (pred - y)) / n
            g_b = torch.mean(pred - y)
            w = w - lr * g_w
            w = torch.sign(w) * torch.clamp_min(torch.abs(w) - lr * lam,
                                                0.0)
            b = b - lr * g_b
    return w, b


class _TargetModel:
    """lasso feature-selection -> MLP ensemble -> stacked head, for one
    target column."""

    def __init__(self, lam: float = 0.02, top_k: int = 32,
                 n_members: int = 4, mlp_steps: int = 400, seed: int = 0,
                 device: DeviceLike = "cuda"):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.lam = lam
        self.top_k = top_k
        self.n_members = n_members
        self.mlp_steps = mlp_steps
        self.seed = seed
        self.sel: Optional[np.ndarray] = None
        self.w = self.b = None            # lasso head (standardized)
        self.x_mean = self.x_std = None
        self.y_mean = self.y_std = None
        self.mlp_state = None
        self.stack = (0.5, 0.5, 0.0)      # (w_linear, w_mlp, bias)

    def fit(self, x: np.ndarray, y: np.ndarray,
            init=None) -> "_TargetModel":
        """`init`: the MLP's init draws (`mlp.draw_init`'s blocks for the
        selected features); by default drawn from the model's seed."""
        from .. import rng
        from ..surrogate import mlp as mlp_mod

        n = x.shape[0]
        if n < 16:
            raise ValueError(
                f"QuickEst needs >= 16 training rows, got {n}")
        self.x_mean = x.mean(0)
        self.x_std = np.maximum(x.std(0), 1e-8)
        self.y_mean = float(y.mean())
        self.y_std = float(max(y.std(), 1e-8))
        xs = (x - self.x_mean) / self.x_std
        ys = (y - self.y_mean) / self.y_std

        # both members train on `tr` only, so the `va` tail is genuinely
        # held out for the stacking weights (the reference assembles on
        # held-out data too, train.py:321-500)
        n_val = max(4, n // 5)
        tr = slice(0, n - n_val)
        va = slice(n - n_val, n)

        w, b = _lasso_fit(self._t(xs[tr]), self._t(ys[tr]), self.lam)
        self.w, self.b = w.cpu().numpy(), float(b)
        order = np.argsort(-np.abs(self.w))
        k = min(self.top_k, xs.shape[1])
        sel = order[:k]
        sel = sel[np.abs(self.w[sel]) > 1e-6]
        if len(sel) == 0:
            sel = order[:1]
        self.sel = np.sort(sel)

        # intentional seed-derived draws: a QuickEst model is a pure
        # function of (training data, seed) — refits on the same rows
        # must reproduce bit-identically, so there is no stored key to
        # split
        if init is None:
            init = mlp_mod.draw_init(
                rng.generator(self.seed, self.device),
                mlp_mod.layer_sizes(len(self.sel)), self.n_members)
        self.mlp_state = mlp_mod.fit(
            init, self._t(xs[tr][:, self.sel]), self._t(ys[tr]),
            n_members=self.n_members, steps=self.mlp_steps)
        lin_va = xs[va] @ self.w + self.b
        mlp_va, _ = mlp_mod.predict(self.mlp_state,
                                    self._t(xs[va][:, self.sel]))
        mlp_va = mlp_va.cpu().numpy()
        a = np.stack([lin_va, mlp_va, np.ones_like(lin_va)], 1)
        coef, *_ = np.linalg.lstsq(a, ys[va], rcond=None)
        self.stack = tuple(float(c) for c in coef)
        return self

    def _t(self, a: np.ndarray):
        """A host array as a float32 tensor on the model's device."""
        import torch

        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def predict(self, x: np.ndarray) -> np.ndarray:
        from ..surrogate import mlp as mlp_mod

        xs = (np.asarray(x, np.float32) - self.x_mean) / self.x_std
        lin = xs @ self.w + self.b
        mlpp, _ = mlp_mod.predict(self.mlp_state, self._t(xs[:, self.sel]))
        wl, wm, c = self.stack
        ys = wl * lin + wm * mlpp.cpu().numpy() + c
        return ys * self.y_std + self.y_mean

    # ------------------------------------------------------ persistence
    def state_arrays(self) -> Dict[str, np.ndarray]:
        out = {"w": self.w, "b": np.asarray([self.b]), "sel": self.sel,
               "x_mean": self.x_mean, "x_std": self.x_std,
               "y_ms": np.asarray([self.y_mean, self.y_std]),
               "stack": np.asarray(self.stack)}
        # the leaves in the JAX pytree's order: each layer's (w, b), then
        # the four normalisation statistics
        leaves = ([t for pair in self.mlp_state.params for t in pair]
                  + list(self.mlp_state[1:]))
        for i, leaf in enumerate(leaves):
            out[f"mlp_{i}"] = leaf.cpu().numpy()
        return out

    def load_arrays(self, arrs: Dict[str, np.ndarray]) -> "_TargetModel":
        from ..surrogate.mlp import MLPEnsembleState

        self.w = arrs["w"]
        self.b = float(arrs["b"][0])
        self.sel = arrs["sel"]
        self.x_mean, self.x_std = arrs["x_mean"], arrs["x_std"]
        self.y_mean, self.y_std = (float(arrs["y_ms"][0]),
                                   float(arrs["y_ms"][1]))
        self.stack = tuple(float(v) for v in arrs["stack"])
        n_layers = len([k for k in arrs if k.startswith("mlp_")])
        leaves = [self._t(arrs[f"mlp_{i}"]) for i in range(n_layers)]
        # reconstruct the pytree structure: params is a tuple of (w, b)
        # layer pairs with leading ensemble axis, then 4 scalar stats
        n_params = n_layers - 4
        params = tuple((leaves[i], leaves[i + 1])
                       for i in range(0, n_params, 2))
        self.mlp_state = MLPEnsembleState(params, *leaves[n_params:])
        return self


class QuickEst:
    """Multi-target QoR estimator (the reference's model database keyed
    by target name, e.g. 'LUT_impl')."""

    def __init__(self, device: DeviceLike = "cuda", **model_opts):
        self.device = device
        self.model_opts = model_opts
        self.models: Dict[str, _TargetModel] = {}
        self.pre_meta: Optional[Dict[str, list]] = None
        self.feature_names: Optional[List[str]] = None

    def fit(self, x: np.ndarray, y: np.ndarray,
            target_names: Sequence[str],
            feature_names: Optional[Sequence[str]] = None) -> "QuickEst":
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        assert y.shape[1] == len(target_names)
        x, self.pre_meta = preprocess(x)
        self.feature_names = (list(feature_names)
                              if feature_names is not None else None)
        opts = dict(self.model_opts)
        base_seed = opts.pop("seed", 0)
        for j, name in enumerate(target_names):
            self.models[name] = _TargetModel(
                seed=base_seed + j, device=self.device, **opts).fit(
                    x, y[:, j])
        return self

    def predict(self, feats: np.ndarray,
                target: str = "LUT_impl") -> np.ndarray:
        """Match test.py:227 predict(feats, target='LUT_impl')."""
        if target not in self.models:
            raise KeyError(
                f"no model for target {target!r}; have "
                f"{sorted(self.models)}")
        feats = np.atleast_2d(np.asarray(feats, np.float32))
        return self.models[target].predict(
            apply_preprocess(feats, self.pre_meta))

    def score(self, x: np.ndarray, y: np.ndarray,
              target_names: Sequence[str]) -> Dict[str, Dict[str, float]]:
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        out = {}
        for j, name in enumerate(target_names):
            pred = self.predict(x, name)
            out[name] = {"r2": r2_score(y[:, j], pred),
                         "rae": rae(y[:, j], pred)}
        return out

    # ------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {"targets": sorted(self.models),
                "pre_meta": self.pre_meta,
                "feature_names": self.feature_names,
                "model_opts": self.model_opts}
        with open(os.path.join(path, "quickest.json"), "w") as f:
            json.dump(meta, f)
        for name, m in self.models.items():
            np.savez(os.path.join(path, f"target_{name}.npz"),
                     **m.state_arrays())

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "QuickEst":
        with open(os.path.join(path, "quickest.json")) as f:
            meta = json.load(f)
        est = cls(device=device, **meta["model_opts"])
        est.pre_meta = meta["pre_meta"]
        est.feature_names = meta["feature_names"]
        for name in meta["targets"]:
            arrs = dict(np.load(os.path.join(path, f"target_{name}.npz")))
            est.models[name] = _TargetModel(
                device=device, **meta["model_opts"]).load_arrays(arrs)
        return est


# ------------------------------------------------- module-level facade
_DEFAULT_DIR = "quickest_models"


def train(x: np.ndarray, y: np.ndarray, target_names: Sequence[str],
          save_dir: Optional[str] = _DEFAULT_DIR,
          feature_names: Optional[Sequence[str]] = None,
          device: DeviceLike = "cuda", **model_opts) -> QuickEst:
    """Train + persist (the reference's `train()` CLI, train.py:500).
    Pass `feature_names` so downstream feature-importance reports name
    real features instead of positional f{i} placeholders."""
    est = QuickEst(device=device, **model_opts).fit(x, y, target_names,
                                     feature_names=feature_names)
    if save_dir:
        est.save(save_dir)
    return est


def test(x: np.ndarray, y: np.ndarray, target_names: Sequence[str],
         model_dir: str = _DEFAULT_DIR,
         device: DeviceLike = "cuda") -> Dict[str, Dict[str, float]]:
    """Score a persisted model DB (test.py:188)."""
    return QuickEst.load(model_dir, device).score(x, y, target_names)


def predict(feats: np.ndarray, target: str = "LUT_impl",
            model_dir: str = _DEFAULT_DIR,
            device: DeviceLike = "cuda") -> np.ndarray:
    """One-shot prediction from the persisted model DB (test.py:227)."""
    return QuickEst.load(model_dir, device).predict(feats, target)
