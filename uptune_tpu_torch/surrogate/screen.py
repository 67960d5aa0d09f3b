"""Cross-payload feature screening for budget-constrained surrogates.

Counterpart of `uptune_tpu/surrogate/screen.py`, kept as the port's own
copy: everything but `archive_rows` is host numpy, unchanged;
`archive_rows` rebuilds the archive's rows as a `CandBatch` of CPU
tensors of the port's `Space`.  The JAX module's account follows.

The r4 gcc-real diagnosis (BENCHREPORT.md "Why the surrogate does not
beat the bandit on gcc-real"): at <=80 observations over ~1,100 one-hot
lanes the GP's marginal-likelihood hyperparameter fit stays
prior-dominated — every lengthscale grid point explains the data about
equally well, so the posterior mean barely ranks candidates.  The fix
measured here (r4 verdict next-step #3) is SUPERVISED SCREENING: rank
feature lanes by their observed effect on QoR in archives from OTHER
payloads over the SAME space (the per-flag sensitivity transfer — gcc
flags that never move runtime on three payloads rarely move it on a
fourth), and restrict the SURROGATE — not the search techniques — to
the top-k lanes.  The bandit arms keep proposing in the full space;
only the model's view narrows, which is exactly the regime split the
budget rule already encodes.

Representation contract (Space.surrogate_transform, space/spec.py):
`[cont block: numeric lanes + perm position lanes | cat block: n_cat
one-hot groups x cat_max_codes]`.  A screen keeps whole groups — a flag
is either visible to the GP (all its code columns) or not — so the
screened layout is again `[cont' | cat']` and the mixed
Matérn x exponential-Hamming kernel applies unchanged with
`n_cont=screen.n_cont, n_cat=screen.n_cat`.
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class FeatureScreen(NamedTuple):
    """A static restriction of the surrogate feature representation.

    idx        : [K] int lane indices into the FULL surrogate rep
                 (cont lanes first, then whole one-hot groups, both in
                 their original order — the kernel split survives).
    n_cont     : width of the kept continuous block.
    n_cat      : number of kept categorical groups.
    cat_weight : [n_scalar] float lane weights over SCALAR lanes
                 (categorical lanes carry their group sensitivity,
                 numeric + dropped lanes 0) — the proposal plane uses
                 it to bias flip moves toward flags that measurably
                 moved QoR on the source payloads.
    scores     : [n_full] per-lane sensitivity over the full rep
                 (introspection / ut-stats).
    lane_weight: [n_full] float in [floor, 1] — the SOFT alternative to
                 hard restriction: scaling the surrogate features by
                 this vector is per-lane ARD (a high-sensitivity lane
                 keeps its resolution, a dead lane's distances shrink
                 toward zero instead of being cut).  Used when the
                 manager runs with screen_mode='soft'.
    """
    idx: np.ndarray
    n_cont: int
    n_cat: int
    cat_weight: np.ndarray
    scores: np.ndarray
    lane_weight: np.ndarray

    def apply(self, feats):
        """Project [B, n_full] surrogate features onto the kept lanes.
        Works on numpy arrays and tensors (fancy-index on the last
        axis)."""
        return feats[..., self.idx]


def lane_sensitivity(feats: np.ndarray, qor: np.ndarray) -> np.ndarray:
    """[N, F] surrogate features x [N] QoR -> [F] |Pearson r| per lane.

    Non-finite QoR rows (failed builds) are dropped — they carry
    "crashed" signal, not magnitude.  Zero-variance lanes score 0.
    """
    feats = np.asarray(feats, np.float64)
    qor = np.asarray(qor, np.float64).reshape(-1)
    ok = np.isfinite(qor)
    feats, qor = feats[ok], qor[ok]
    if len(qor) < 4:
        return np.zeros(feats.shape[1])
    fc = feats - feats.mean(axis=0)
    yc = qor - qor.mean()
    fs = np.sqrt((fc * fc).sum(axis=0))
    ys = np.sqrt((yc * yc).sum())
    denom = fs * ys
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.where(denom > 0, (fc * yc[:, None]).sum(axis=0) / denom,
                     0.0)
    return np.abs(np.nan_to_num(r))


def build_screen(space, sources: Sequence[Tuple[np.ndarray, np.ndarray]],
                 top_cont: int = 16, top_cat: int = 24) -> FeatureScreen:
    """Aggregate per-lane sensitivity over `sources` (list of
    (surrogate_feats [N,F], qor [N]) pairs — one per source payload) and
    keep the `top_cont` continuous lanes + `top_cat` categorical groups.

    Aggregation is the MEAN of per-source |Pearson r| — correlation is
    scale-free, so payloads with different absolute runtimes contribute
    equally; a lane must move QoR consistently across payloads to rank.
    """
    n_full = space.n_surrogate_features
    n_cont = space.n_cont_features
    per = [lane_sensitivity(f, q) for f, q in sources]
    if not per:
        raise ValueError("build_screen needs at least one source")
    scores = np.mean(np.stack(per), axis=0)
    assert scores.shape[0] == n_full, (scores.shape, n_full)

    # continuous block: straight top-k lanes (order preserved)
    kc = min(max(1, int(top_cont)), n_cont) if n_cont else 0
    cont_rank = np.argsort(-scores[:n_cont])[:kc] if n_cont else []
    cont_keep = np.sort(np.asarray(cont_rank, int))

    # categorical block: score per GROUP = max over its code columns
    # (a flag whose "off" column correlates is as real as one whose
    # "on" column does); keep whole groups
    ncat, width = space.n_cat, space.cat_max_codes
    if ncat:
        gs = scores[n_cont:].reshape(ncat, width).max(axis=1)
        kg = min(max(1, int(top_cat)), ncat)
        grp_keep = np.sort(np.argsort(-gs)[:kg])
        cat_idx = (n_cont + (grp_keep[:, None] * width
                             + np.arange(width)[None, :])).reshape(-1)
    else:
        gs = np.zeros(0)
        grp_keep = np.zeros(0, int)
        cat_idx = np.zeros(0, int)

    idx = np.concatenate([cont_keep, cat_idx]).astype(np.int32)

    # flip-move weights over scalar lanes: kept groups carry their
    # (normalized) sensitivity, everything else 0
    cat_weight = np.zeros(space.n_scalar)
    if ncat and len(grp_keep):
        w = gs[grp_keep]
        w = w / w.max() if w.max() > 0 else np.ones_like(w)
        cat_weight[np.asarray(space.cat_lane_idx)[grp_keep]] = w

    # soft ARD weights over the FULL rep: normalize by a high quantile
    # (not the max — one spiky lane must not flatten the rest), floor
    # at 0.1 so no lane is invisible; group lanes share their group's
    # sensitivity so a flag's one-hot columns scale together
    ref = float(np.quantile(scores[scores > 0], 0.9)) \
        if (scores > 0).any() else 1.0
    lane_scores = scores.copy()
    if ncat:
        lane_scores[n_cont:] = np.repeat(gs, width)
    lane_weight = np.clip(lane_scores / max(ref, 1e-12), 0.1, 1.0)

    return FeatureScreen(idx=idx, n_cont=int(len(cont_keep)),
                         n_cat=int(len(grp_keep)),
                         cat_weight=cat_weight, scores=scores,
                         lane_weight=lane_weight)


def archive_rows(space, path: str):
    """Read one driver jsonl archive -> (surrogate_feats [N,F], qor [N]).

    Archives store the exact unit vectors (`u`) and permutations the
    driver evaluated (driver/driver.py _log_trial), so features are
    rebuilt bit-identically to what a live run would have observed.
    Raises on a space-signature mismatch: sensitivities transferred
    across DIFFERENT spaces would be silently meaningless.
    """
    import torch

    from ..space.spec import CandBatch

    us: List[List[float]] = []
    perms: List[List[List[int]]] = []
    qors: List[float] = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "space_sig" in rec:
                sig = [repr(s) for s in space.specs]
                if rec["space_sig"] != sig:
                    raise ValueError(
                        f"archive {path} was recorded for a different "
                        f"space; cross-space screening is meaningless")
                continue
            if "u" not in rec or "qor" not in rec:
                continue
            pm_rec = rec.get("perms", [])
            if (len(pm_rec) != len(space.perm_sizes)
                    or any(len(p) != s
                           for p, s in zip(pm_rec, space.perm_sizes))):
                # a row lacking (or short on) its perm blocks cannot be
                # reassembled into a CandBatch on a permutation space
                continue
            us.append(rec["u"])
            perms.append(pm_rec)
            qors.append(float(rec["qor"]))
    if not us:
        return (np.zeros((0, space.n_surrogate_features), np.float32),
                np.zeros(0, np.float32))
    u = torch.from_numpy(np.asarray(us, np.float32))
    pm = tuple(torch.from_numpy(np.asarray([p[i] for p in perms], np.int64))
               for i in range(len(space.perm_sizes)))
    cands = CandBatch(u, pm)
    feats = space.surrogate_transform(space.features(cands)).numpy()
    return feats, np.asarray(qors, np.float32)


def screen_from_archives(space, paths: Sequence[str],
                         top_cont: int = 16,
                         top_cat: int = 24) -> Optional[FeatureScreen]:
    """Build a FeatureScreen from driver archives of OTHER payloads over
    the same space (the CLI's --surrogate-screen flag).  Archives that
    are missing or empty are skipped; returns None when no source
    contributed rows."""
    sources = []
    for p in paths:
        if not os.path.exists(p):
            continue
        feats, qor = archive_rows(space, p)
        if len(qor) >= 4:
            sources.append((feats, qor))
    if not sources:
        return None
    return build_screen(space, sources, top_cont=top_cont,
                        top_cat=top_cat)
