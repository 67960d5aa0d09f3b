"""Surrogate lifecycle, multivoting prune and proposal pool for the driver.

Counterpart of `uptune_tpu/surrogate/manager.py`: the manager keeps the
evaluated rows in the surrogate representation, refits the GP (or the
MLP ensemble) at a cadence and publishes each model as an immutable
`SurrogateSnapshot`; `keep_mask` prunes a technique's batch by the
model's votes (a candidate survives when it is predicted within the best
`keep_quantile` of history, or, with ``select="topk"``, within the best
`keep_frac` of its batch; an `explore_frac` random share always
survives), and `propose_pool` ranks an oversampled pool of perturbations
of the incumbent and returns its best `propose_batch` rows.

How the port differs from the JAX manager:

* It runs eagerly: there are no per-bucket program fleets, and no
  throwaway extension call warms a compile at publish.  The training
  bucket still grows in powers of two to `max_points` (`fit_bucket`), so
  the fit's shapes and results are the JAX manager's.
* Randomness comes from the manager's counter-based key (`rng`), split
  where the JAX manager splits its PRNG key, and the draws go through
  one method per phase, so a test can feed the numbers JAX drew:
  `_draw_refit` (the host subsample's seed word, the last 32-bit word of
  the refit's subsample key, and the MLP's init normals), `_draw_explore`
  (the keep mask's uniforms) and `_draw_pool` (every draw of one pool,
  each as the `jax.random` call returns it: a ranged uniform already
  scaled).  The pool's candidates are a pure function of its draws
  (`pool_candidates`).
* Host reads are the reference's: `keep_mask` reads the scores and the
  explore draw in one transfer; a refit reads its seed word and waits for
  its device work before it publishes (the reference's
  `block_until_ready`).  `observe` computes the surrogate features on the
  host, where the driver hands the rows over, and moves nothing.
* The pool's route is the reference's static size gate: a GP pool of
  `PALLAS_MIN_POOL` (4096) rows or more is ranked by
  `ops/acquire.py::acquire_topk` (launcher D on the card, its plain
  version for CPU tensors); a smaller pool, and every MLP pool, through
  the materialized moments and a stable argsort.
* The async plane: ``async_refit=True`` runs `_refit_full` on one worker
  thread, as the reference does.  On the card the worker issues its work
  on its own stream of the refit device (the last card when the process
  has more than one, else the manager's), after an event recorded on
  the submitting stream (so it reads the keys the driver split),
  synchronises that stream before it publishes, and marks the published
  tensors used on the driver's stream (`record_stream`), so the caching
  allocator cannot hand their blocks to the worker's stream while the
  driver still reads them.

Left out, each with the work that brings it back: the `obs` events,
spans, gauges and tuning-journal lines (the observability slice), and
`parallel/surrogate_shard.py` (the multi-card slice).
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..calibrated import CALIBRATED_OPTS  # noqa: F401  (re-exported)
from ..device import DeviceLike, resolve_device, to_device, to_host
from ..space.spec import CandBatch, Space
from . import gp as gp_mod
from . import mlp as mlp_mod
from .pallas_score import PALLAS_MIN_POOL

KINDS = ("gp", "mlp")


class SurrogateSnapshot(NamedTuple):
    """One immutable published model state.  Everything scoring reads —
    the fitted state, the prune threshold, the incumbent — travels
    together, so a reader that took `manager._snap` once never sees a
    half-updated model: publication rebinds one reference (atomic under
    the GIL) to a fully built snapshot.

    `version` counts publications (full refits and extensions);
    `n_rows` is the training-row watermark (rows [0, n_rows) are
    conditioned into `state`); `exact` marks that those rows occupy the
    padded bucket verbatim in training order (no subsample ran), which is
    what lets a rank-1 extension fill row `in_bucket`."""
    state: Any
    version: int
    n_rows: int
    threshold: Optional[float]
    best_y: Optional[float]
    exact: bool = True
    in_bucket: int = 0


class RefitDraws(NamedTuple):
    """The draws of one full refit."""
    seed_word: int                     # seeds the host subsample's numpy RNG
    init: Optional[Tuple[torch.Tensor, ...]]   # MLP init normals, or None


class PoolDraws(NamedTuple):
    """The draws of one proposal pool (`_draw_pool`), each as the
    `jax.random` call of the JAX pool returns it."""
    rand: CandBatch                # Space.random's n_rand rows
    dense_log2r: torch.Tensor      # [n_dense, 1] in [-9, -1.5]
    dense_z: torch.Tensor          # [n_dense, D] standard normals
    flip_log2n: torch.Tensor       # [n_flip, 1] in [0, log2(max_flips)]
    flip_sel: torch.Tensor         # [n_flip, D] U[0, 1)
    flip_off: torch.Tensor         # [n_flip, D] U[0, 1)
    sparse_log2rate: torch.Tensor  # [n_sparse, 1] in [-log2 D, max(-2, .)]
    sparse_sel: torch.Tensor       # [n_sparse, D] U[0, 1)
    sparse_val: torch.Tensor       # [n_sparse, D] U[0, 1)
    # per perm block: (small-change coins [n_local, size], shuffle index
    # permutations [n_local, size], mutate-or-shuffle coin [n_local, 1])
    perms: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]


class PoolGeometry(NamedTuple):
    """How one pool's rows split between its move families."""
    n_out: int
    pool: int
    n_rand: int
    n_local: int
    n_dense: int
    n_flip: int
    n_sparse: int
    max_flips: int


def pool_geometry(space: Space, n_out: int, pool_mult: int) -> PoolGeometry:
    """A quarter of the pool uniform at random, the rest around the
    incumbent: a dense Gaussian cloud on numeric lanes, categorical
    flips and sparse re-draws, sized by what the space contains."""
    pool = max(n_out * pool_mult, n_out)
    n_rand = max(pool // 4, 1)
    n_local = pool - n_rand
    n_num = space.n_scalar - space.n_cat
    if space.n_cat == 0:
        n_dense, n_flip = n_local // 2, 0
    elif n_num == 0:
        n_dense, n_flip = 0, n_local // 2
    else:
        n_dense, n_flip = n_local // 3, n_local // 3
    return PoolGeometry(n_out, pool, n_rand, n_local, n_dense, n_flip,
                        n_local - n_dense - n_flip,
                        max(2, space.n_cat // 8))


def _ranged(gen: rng.Stream, shape, lo: float, hi: float) -> torch.Tensor:
    """U[lo, hi) as `jax.random.uniform(minval=lo, maxval=hi)` scales it."""
    return torch.clamp_min(rng.uniform(gen, shape) * (hi - lo) + lo, lo)


def _sparse_range(d: int) -> Tuple[float, float]:
    lo = -float(np.log2(d))
    return lo, max(-2.0, lo)


def draw_pool(space: Space, geo: PoolGeometry, gen: rng.Stream) -> PoolDraws:
    """Every draw of one pool, in the JAX pool's order of keys."""
    from ..ops import perm as perm_ops
    D = space.n_scalar
    d = max(D, 1)
    rand = space.random(gen, geo.n_rand)
    dense_log2r = _ranged(gen, (geo.n_dense, 1), -9.0, -1.5)
    dense_z = rng.normal(gen, (geo.n_dense, D))
    flip_log2n = _ranged(gen, (geo.n_flip, 1), 0.0,
                         float(np.log2(geo.max_flips)))
    flip_sel = rng.uniform(gen, (geo.n_flip, D))
    flip_off = rng.uniform(gen, (geo.n_flip, D))
    sparse_log2rate = _ranged(gen, (geo.n_sparse, 1), *_sparse_range(d))
    sparse_sel = rng.uniform(gen, (geo.n_sparse, d))
    sparse_val = rng.uniform(gen, (geo.n_sparse, d))
    perms = tuple(
        (perm_ops.draw_small_random_change(gen, geo.n_local, size),
         perm_ops.draw_shuffle(gen, geo.n_local, size),
         rng.uniform(gen, (geo.n_local, 1)))
        for size in space.perm_sizes)
    return PoolDraws(rand, dense_log2r, dense_z, flip_log2n, flip_sel,
                     flip_off, sparse_log2rate, sparse_sel, sparse_val,
                     perms)


def pool_candidates(space: Space, geo: PoolGeometry, draws: PoolDraws,
                    best_u: torch.Tensor, best_perms,
                    flip_p: torch.Tensor) -> CandBatch:
    """The pool as a pure function of its draws: the random rows, then
    the dense, flip and sparse rows around the incumbent (`best_u`,
    `best_perms`), their permutations mutated or shuffled, normalised.
    `flip_p` ([D]) weighs the categorical lanes a flip row re-draws."""
    from ..ops import perm as perm_ops
    dev = best_u.device
    cat_row = torch.zeros(space.n_scalar, device=dev)
    if space.n_cat:                  # index_fill_: no host value to copy
        cat_row.index_fill_(0, space.tables(dev).cat_idx, 1.0)
    parts = []
    if geo.n_dense:
        # per-row radius log-uniform over [2^-9, 2^-1.5] of the unit cube
        # on numeric lanes; categorical lanes stay at the incumbent's codes
        r = torch.exp2(draws.dense_log2r)
        noise = draws.dense_z * r * (1.0 - cat_row)
        parts.append(torch.clamp(best_u[None, :] + noise, 0.0, 1.0))
    if geo.n_flip:
        # per-row flip count log-uniform in [1, max_flips]; each lane's
        # probability nf * flip_p is clipped at 1, the clipped mass
        # spread over the other eligible lanes by their headroom
        nf = torch.exp2(draws.flip_log2n)
        p_flip = nf * flip_p[None, :]
        over = torch.clamp_min(p_flip - 1.0, 0.0).sum(-1, keepdim=True)
        p_flip = torch.minimum(p_flip, torch.ones_like(p_flip))
        room = torch.where(flip_p[None, :] > 0, 1.0 - p_flip,
                           torch.zeros_like(p_flip))
        p_flip = torch.clamp_max(
            p_flip + over * room
            / torch.clamp_min(room.sum(-1, keepdim=True), 1e-9), 1.0)
        sel = (draws.flip_sel < p_flip) & (cat_row > 0)
        vals = space.decode_scalars(best_u)
        vhi = space.tables(dev).vhi
        off = 1.0 + torch.floor(draws.flip_off
                                * torch.clamp_min(vhi, 1.0))
        newc = torch.remainder(vals[None, :] + off, vhi + 1.0)
        parts.append(space.encode_scalars(
            torch.where(sel, newc, vals[None, :])))
    # sparse: per-row lane-selection rate log-uniform between ~1 lane
    # and a quarter of the lanes; selected lanes re-draw uniformly
    rate = torch.exp2(draws.sparse_log2rate)
    parts.append(torch.where(draws.sparse_sel < rate, draws.sparse_val,
                             best_u[None, :]))
    u_loc = torch.cat(parts, dim=0)
    perms_loc = []
    for (coins, idx, coin), size, bp in zip(draws.perms, space.perm_sizes,
                                            best_perms):
        base = bp[None, :].expand(geo.n_local, size)
        mut = perm_ops.small_random_change_batch(base, coins,
                                                 2.0 / max(size, 2))
        shuf = perm_ops.shuffle_batch(base, idx)
        perms_loc.append(torch.where(coin < 0.75, mut, shuf))
    local = CandBatch(u_loc, tuple(perms_loc))
    return space.normalize(draws.rand.concat(local))


def _screen_feats(feats, sidx, sw):
    """Apply a FeatureScreen's view to surrogate features: hard lane
    selection (`sidx`), soft ARD scaling (`sw`), or neither.  The one
    projection: the training rows, the prune's queries and the pool's
    all go through it, so model and queries share one representation."""
    if sidx is not None:
        return feats[..., sidx]
    if sw is not None:
        return feats * sw
    return feats


def _leaves(x):
    """The tensors of a (nested) tuple state."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)


def _tree_to(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        vals = [_tree_to(v, dev) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


class SurrogateManager:
    def __init__(self, space: Space, kind: str = "gp", *,
                 min_points: int = 64, refit_interval: int = 64,
                 keep_quantile: float = 0.5, majority: float = 0.5,
                 explore_frac: float = 0.1, max_points: int = 1024,
                 n_members: int = 4, seed: int = 0,
                 hyper_fit: bool = True, select: str = "threshold",
                 keep_frac: float = 0.25, score: str = "lcb",
                 propose_batch: int = 0, propose_every: int = 2,
                 pool_mult: int = 32,
                 min_model_points: Optional[int] = None,
                 auto_passive: bool = True,
                 arbitration: str = "schedule",
                 propose_batch_parity: bool = True,
                 screen=None, screen_mode: str = "hard",
                 flip_bias: str = "none",
                 async_refit: bool = False, incremental: bool = True,
                 device: DeviceLike = "cuda"):
        if kind not in KINDS:
            raise ValueError(f"unknown surrogate {kind!r}; known: {KINDS}")
        if arbitration not in ("schedule", "bandit"):
            raise ValueError(f"unknown arbitration {arbitration!r}; "
                             f"known: schedule, bandit")
        if select not in ("threshold", "topk"):
            raise ValueError(f"unknown select mode {select!r}")
        if score not in ("lcb", "ei"):
            raise ValueError(f"unknown score {score!r}; known: lcb, ei")
        self.device = resolve_device(device)
        # select='threshold' drops candidates predicted worse than the
        # keep_quantile of history; 'topk' keeps the best keep_frac of
        # each batch by acquisition score.  score='lcb' ranks by mean -
        # 2 std, 'ei' by expected improvement over the incumbent.
        self.select = select
        self.keep_frac = keep_frac
        self.score_kind = score
        # propose_batch > 0 turns on the proposal plane: every
        # propose_every-th acquisition (arbitration='schedule') or when
        # the AUC bandit pulls its virtual arm ('bandit') the manager
        # emits its own batch from an oversampled pool; under 'bandit'
        # the driver raises the batch to the median arm's unless
        # propose_batch_parity is False
        self.propose_batch = propose_batch
        self.propose_every = propose_every
        self.arbitration = arbitration
        self.propose_batch_parity = propose_batch_parity
        self.pool_mult = pool_mult
        self._pool_geo: Optional[PoolGeometry] = None
        self.space = space
        self.kind = kind
        self.hyper_fit = hyper_fit
        self.min_points = min_points
        self.refit_interval = refit_interval
        self.keep_quantile = keep_quantile
        self.majority = majority
        self.explore_frac = explore_frac
        self.max_points = max_points
        self.n_members = n_members
        self._xs: list = []
        self._ys: list = []
        self._since_fit = 0
        self._key = rng.key(seed, self.device)
        # elements each draw phase took last time (a stream's block size)
        self._hints: dict = {}

        # the versioned snapshot plane: scoring reads `self._snap` once a
        # call; learning publishes whole snapshots under `_pub_lock`
        # (which orders the background worker's publishes against the
        # driver thread's extensions; readers take no lock)
        self.async_refit = bool(async_refit)
        self.incremental = bool(incremental)
        # rank-1 extensions folded per maybe_refit tick (a backlog is
        # spread over ticks; the cadence's full refit clears the rest)
        self._ext_per_tick = 8
        # a background fit on the driver's card shares it; with several
        # cards the fit takes the last one and publishes back here
        n_cards = (torch.cuda.device_count() if self.device.type == "cuda"
                   else 0)
        self._refit_device = (torch.device("cuda", n_cards - 1)
                              if self.async_refit and n_cards > 1
                              else self.device)
        self._driver_stream = (torch.cuda.current_stream(self.device)
                               if self.device.type == "cuda" else None)
        self._side_streams: dict = {}
        self._snap: Optional[SurrogateSnapshot] = None
        self._pub_lock = threading.Lock()
        self._version = 0
        self._refit_exec = None       # lazy single-worker executor
        self._refit_future = None
        self.refits_started = 0       # full fits launched (sync + bg)
        self.refits = 0               # full fits published
        self.incr_updates = 0         # rank-1 extensions applied
        self.t_refit_last = 0.0       # s of the last blocking full fit
        self.t_refit_total = 0.0      # cumulative blocking-fit seconds
        self.t_refit_bg_total = 0.0   # cumulative background-fit seconds

        # an optional FeatureScreen (surrogate/screen.py) restricts the
        # model's view of the surrogate features; a dict defers its
        # construction to here: {"archives": [paths], "top_cont": int,
        # "top_cat": int}
        if isinstance(screen, dict):
            from .screen import screen_from_archives
            paths = list(screen.get("archives", ()))
            screen = screen_from_archives(
                space, paths,
                top_cont=screen.get("top_cont", 16),
                top_cat=screen.get("top_cat", 24))
            if screen is None and paths:
                # a requested screen never degrades silently
                warnings.warn(
                    f"--surrogate-screen: none of {len(paths)} "
                    f"archive(s) contributed rows (missing, empty, or "
                    f"<4 usable trials) — running UNSCREENED",
                    UserWarning)
        if screen_mode not in ("hard", "soft"):
            raise ValueError(f"unknown screen_mode {screen_mode!r}; "
                             f"known: hard, soft")
        if flip_bias not in ("none", "online"):
            raise ValueError(f"unknown flip_bias {flip_bias!r}; "
                             f"known: none, online")
        # flip_bias='online': at each refit, weigh the pool's flip moves
        # by each categorical group's |Pearson r| against QoR over this
        # run's rows (75% of the mass; 25% stays uniform)
        self.flip_bias = flip_bias
        self._online_cat_w = None
        self.screen = screen
        self.screen_mode = screen_mode
        self._screen_idx = None       # numpy lane indices (hard)
        self._screen_w = None         # numpy lane weights (soft)
        self._screen_dev: dict = {}
        self._n_cont = space.n_cont_features
        self._n_cat = space.n_cat
        # scalar categorical lanes backing the model's cat groups, in
        # group order (the online flip bias maps group weights back)
        self._cat_groups = np.arange(space.n_cat)
        if screen is not None:
            if screen_mode == "hard":
                self._n_cont = int(screen.n_cont)
                self._n_cat = int(screen.n_cat)
                self._screen_idx = np.asarray(screen.idx, np.int64)
                if screen.n_cat and space.cat_max_codes:
                    cat_part = np.asarray(
                        screen.idx[screen.n_cont:], np.int64)
                    self._cat_groups = np.unique(
                        (cat_part - space.n_cont_features)
                        // space.cat_max_codes)
            else:
                self._screen_w = np.asarray(screen.lane_weight, np.float32)

        # activity guards: below min_model_points observations the
        # manager fits but neither prunes nor proposes; `passive` is the
        # driver's run-budget rule (auto_passive=False opts out)
        self.min_model_points = (min_points if min_model_points is None
                                 else min_model_points)
        self.auto_passive = auto_passive
        self.passive = False

    # ------------------------------------------------------------------
    # randomness: the manager's key, split where the JAX manager splits
    # its own, and one draw method per phase
    def _draw_refit(self, ks: torch.Tensor, kf: torch.Tensor) -> RefitDraws:
        """The subsample's seed word (read from the key: the reference
        reads its key here too) and, for the MLP, its init normals."""
        init = None
        if self.kind == "mlp":
            sizes = mlp_mod.layer_sizes(self._n_features())
            init = rng.hinted(kf, self._hints, "init",
                              lambda g: mlp_mod.draw_init(g, sizes,
                                                          self.n_members))
        return RefitDraws(int(ks[-1]), init)

    def _draw_explore(self, ke: torch.Tensor, b: int) -> torch.Tensor:
        """The keep mask's [b] explore uniforms."""
        return rng.uniform(rng.Stream(ke), (b,))

    def _draw_pool(self, key: torch.Tensor) -> PoolDraws:
        return rng.hinted(key, self._hints, "pool",
                          lambda g: draw_pool(self.space, self._pool_geo,
                                              g))

    # ------------------------------------------------------------------
    def _n_features(self) -> int:
        """Width of the model's features (after a screen)."""
        if self._screen_idx is not None:
            return len(self._screen_idx)
        return self.space.n_surrogate_features

    def _screen_on(self, dev: torch.device):
        """(lane indices, lane weights) of the screen on `dev`, or Nones."""
        got = self._screen_dev.get(dev)
        if got is None:
            got = (None if self._screen_idx is None
                   else to_device(self._screen_idx, torch.int64, dev),
                   None if self._screen_w is None
                   else to_device(self._screen_w, torch.float32, dev))
            self._screen_dev[dev] = got
        return got

    def _sx(self, feats: torch.Tensor) -> torch.Tensor:
        """Space features -> the model's representation (snapped numeric
        lanes and one-hot categoricals, then the screen), on the device
        the features lie on."""
        return _screen_feats(self.space.surrogate_transform(feats),
                             *self._screen_on(feats.device))

    @property
    def n_points(self) -> int:
        return len(self._ys)

    @property
    def fitted(self) -> bool:
        return self._snap is not None

    # legacy accessors: views of the published snapshot
    @property
    def _state(self):
        s = self._snap
        return None if s is None else s.state

    @property
    def _threshold(self) -> Optional[float]:
        s = self._snap
        return None if s is None else s.threshold

    @property
    def _best_y(self) -> Optional[float]:
        s = self._snap
        return None if s is None else s.best_y

    @property
    def _use_kinv(self) -> bool:
        """Attach the premasked K^-1 at publish iff pools are large
        enough for the fused top-k (once per refit, never per pool)."""
        return (self.kind == "gp" and self.propose_batch
                * self.pool_mult >= PALLAS_MIN_POOL)

    @property
    def snapshot_version(self) -> int:
        """Monotonic publication counter (0 = never fitted)."""
        s = self._snap
        return 0 if s is None else s.version

    @property
    def refit_lag_rows(self) -> int:
        """Observed training rows the published snapshot has not
        conditioned on yet (= n_points when unfitted)."""
        s = self._snap
        return self.n_points - (0 if s is None else s.n_rows)

    def observe(self, feats: np.ndarray, qor: np.ndarray) -> None:
        """Record evaluated (features, engine-oriented QoR) rows.  `feats`
        is the host `Space.features()` representation the driver hands
        over; it is re-encoded to the model's representation on the
        host."""
        sf = self._sx(torch.from_numpy(
            np.asarray(feats, np.float32))).numpy()
        for f, q in zip(sf, np.asarray(qor)):
            self._xs.append(np.asarray(f, np.float32))
            self._ys.append(float(q))
            self._since_fit += 1

    def maybe_refit(self) -> bool:
        """Advance the learning plane one tick.  Sync mode: run the full
        fit inline when the cadence is due.  Async mode: submit it to the
        worker and return.  Between full fits, rows past the published
        watermark are folded in by rank-1 extension.  Returns True iff a
        full fit was published during this call."""
        published = self._poll_refit()
        if self.n_points >= self.min_points:
            due = self._refit_future is None and (
                not self.fitted or self._since_fit >= self.refit_interval)
            if due:
                args = self._refit_args()
                if self.async_refit:
                    if self._refit_exec is None:
                        from concurrent.futures import ThreadPoolExecutor
                        self._refit_exec = ThreadPoolExecutor(
                            max_workers=1,
                            thread_name_prefix="ut-surrogate-refit")
                    ready = None
                    if self.device.type == "cuda":
                        # the worker's stream waits for the split keys
                        ready = torch.cuda.Event()
                        ready.record(torch.cuda.current_stream(self.device))
                    self._refit_future = self._refit_exec.submit(
                        self._refit_full, *args, background=True,
                        ready=ready)
                else:
                    self._refit_full(*args)
                    published = True
        if self.fitted and not published and self._refit_future is None:
            # no extension while a fit is in flight: that fit covers the
            # rows; later rows fold in from the tick after it publishes
            self._maybe_extend()
        return published

    def _refit_args(self):
        """The training set and keys, taken on the caller's thread, so a
        background fit sees a frozen watermark and the key stream is the
        same in sync and async mode."""
        self.refits_started += 1
        self._since_fit = 0
        self._key, ks, kf = rng.split(self._key, 3).unbind(0)
        return (np.stack(self._xs),
                np.asarray(self._ys, np.float32), ks, kf)

    def fit_bucket(self, n: Optional[int] = None) -> int:
        """The padded training bucket of a full fit over `n` rows
        (default: the current training set): a power of two, capped at
        max_points, with one refit_interval of headroom for extensions."""
        n = min(self.n_points if n is None else n, self.max_points)
        headroom = (self.refit_interval
                    if self.incremental and self.kind == "gp" else 0)
        target = min(n + headroom, max(self.max_points, n))
        return gp_mod.bucket_of(target, self.max_points)

    @staticmethod
    def _host_subsample(xs_np, ys_np, seed_word: int, max_points: int):
        """The best-biased subsample, in host numpy: the best half kept,
        the rest drawn by a numpy RNG seeded from `seed_word`."""
        n = len(ys_np)
        if n <= max_points:
            return xs_np, ys_np
        n_best = max_points // 2
        order = np.argsort(ys_np)
        rest = order[n_best:]
        rs = np.random.RandomState(int(seed_word) & 0x7fffffff)
        pick = rs.choice(len(rest), max_points - n_best, replace=False)
        idx = np.concatenate([order[:n_best], rest[pick]])
        return xs_np[idx], ys_np[idx]

    def _side_stream(self, dev: torch.device) -> torch.cuda.Stream:
        s = self._side_streams.get(dev)
        if s is None:
            s = self._side_streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _refit_full(self, xs_np, ys_np, ks, kf, background: bool = False,
                    ready: Optional[torch.cuda.Event] = None) -> None:
        """The full fit: host subsample and zero-pad to the bucket, one
        fit (fit_auto's sweep with hyper_fit), then publish one
        snapshot.  A background fit on the card runs on the worker's own
        stream, after `ready` (recorded where the keys were split)."""
        t0 = time.perf_counter()
        dev = self._refit_device
        if dev.type != "cuda":
            self._refit_full_body(xs_np, ys_np, ks, kf, background, t0,
                                  None)
            return
        with torch.cuda.device(dev):
            stream = (self._side_stream(dev) if background
                      else torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                self._refit_full_body(xs_np, ys_np, ks, kf, background,
                                      t0, stream)

    def _refit_full_body(self, xs_np, ys_np, ks, kf, background, t0,
                         stream) -> None:
        draws = self._draw_refit(ks, kf)
        n_total = len(ys_np)
        xs_sub, ys_sub = self._host_subsample(xs_np, ys_np,
                                              draws.seed_word,
                                              self.max_points)
        n = len(ys_sub)
        bucket = self.fit_bucket(n_total)
        pad = bucket - n
        xp = np.concatenate(
            [xs_sub, np.zeros((pad, xs_sub.shape[1]), np.float32)])
        yp = np.concatenate([ys_sub, np.zeros(pad, np.float32)])
        mp = np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad, np.float32)])
        dev = self._refit_device
        x, y, mask = (to_device(a, torch.float32, dev) for a in (xp, yp, mp))
        nc, ncat = self._n_cont, self._n_cat
        if self.kind == "gp":
            if self.hyper_fit:
                state = gp_mod.fit_auto(x, y, mask, n_cont=nc, n_cat=ncat)
            else:
                state = gp_mod.fit(x, y, mask=mask, n_cont=nc, n_cat=ncat)
            if self._use_kinv:
                # large pools rank through the fused top-k, which reads
                # the premasked K^-1: attached once per publish
                state = gp_mod.precompute_kinv(state)
        else:
            init = tuple(z.to(dev) for z in draws.init)
            state = mlp_mod.fit(init, x, y, n_members=self.n_members,
                                mask=mask)
        if stream is not None:
            if dev != self.device:
                # home to the driver's card, so scoring never crosses
                state = _tree_to(state, self.device)
                torch.cuda.synchronize(self.device)
            # a published snapshot is done computing (the reference's
            # block_until_ready)
            stream.synchronize()
            if background:
                for t in _leaves(state):
                    t.record_stream(self._driver_stream)
        finite = ys_np[np.isfinite(ys_np)]
        thr = (float(np.quantile(finite, self.keep_quantile))
               if len(finite) else None)
        besty = float(finite.min()) if len(finite) else None
        if self.flip_bias == "online" and self._n_cat:
            # per-group |Pearson r| over this run's rows -> flip weights
            # on the backing scalar lanes
            from .screen import lane_sensitivity
            scores = lane_sensitivity(xs_np, ys_np.astype(np.float64))
            width = self.space.cat_max_codes
            gs = scores[self._n_cont:].reshape(
                self._n_cat, width).max(axis=1)
            w = np.zeros(self.space.n_scalar)
            lanes = np.asarray(self.space.cat_lane_idx)[self._cat_groups]
            w[lanes] = gs / gs.max() if gs.max() > 0 else 1.0
            self._online_cat_w = w
        with self._pub_lock:
            self._version += 1
            self._snap = SurrogateSnapshot(
                state, self._version, n_total, thr, besty,
                exact=n_total <= self.max_points, in_bucket=n)
            self.refits += 1
        dt = time.perf_counter() - t0
        if background:
            self.t_refit_bg_total += dt
        else:
            self.t_refit_last = dt
            self.t_refit_total += dt

    def _poll_refit(self) -> bool:
        """Consume a finished background fit without blocking: True when
        one published since the last poll.  A failed fit warns and
        re-arms the cadence so the next tick retries."""
        f = self._refit_future
        if f is None or not f.done():
            return False
        self._refit_future = None
        exc = f.exception()
        if exc is None:
            return True
        warnings.warn(
            f"background surrogate refit failed: {exc!r}; the last "
            f"published snapshot stays live, retrying at the next "
            f"cadence", RuntimeWarning)
        self._since_fit = max(self._since_fit, self.refit_interval)
        return False

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until an in-flight background refit has published (or
        failed); True when nothing is left in flight."""
        f = self._refit_future
        if f is None:
            return True
        from concurrent.futures import TimeoutError as _FTimeout
        try:
            f.exception(timeout)   # waits; does not raise the fit's exc
        except _FTimeout:
            return False
        self._poll_refit()
        return True

    def close(self) -> None:
        """Let an in-flight background refit publish, then shut the
        worker thread down (`maybe_refit` starts a new one if the
        manager is used again)."""
        self.drain()
        if self._refit_exec is not None:
            self._refit_exec.shutdown(wait=True)
            self._refit_exec = None

    def _maybe_extend(self) -> int:
        """Fold rows past the published watermark into the snapshot by
        rank-1 Cholesky extension (O(N^2) a row inside the padded
        bucket), at the last full fit's hyperparameters and
        standardisation; at most `_ext_per_tick` rows a tick.  Skipped
        after a subsampled fit and when the bucket is full.  Returns the
        rows folded in."""
        snap = self._snap
        if (not self.incremental or self.kind != "gp" or snap is None
                or not snap.exact):
            return 0
        n = self.n_points
        bucket = int(snap.state.x.shape[0])
        if n <= snap.n_rows or snap.in_bucket >= bucket:
            return 0
        ys = self._ys
        worst = max((v for v in ys if np.isfinite(v)), default=None)
        if worst is None:
            return 0
        first = snap.n_rows
        rows = min(n - first, bucket - snap.in_bucket, self._ext_per_tick)
        # the rows' features and targets reach the device in one copy
        xr = to_device(np.stack(self._xs[first:first + rows]),
                       torch.float32, self.device)
        yr = to_device(np.asarray(
            [v if np.isfinite(v) else worst for v in ys[first:first + rows]],
            np.float32), torch.float32, self.device)
        st = snap.state
        for j in range(rows):
            st = gp_mod.extend(st, xr[j], yr[j], snap.in_bucket + j,
                               n_cont=self._n_cont, n_cat=self._n_cat)
        i = first + rows
        fin = np.asarray([v for v in ys[:i] if np.isfinite(v)],
                         np.float32)
        thr = (float(np.quantile(fin, self.keep_quantile))
               if len(fin) else None)
        besty = float(fin.min()) if len(fin) else None
        with self._pub_lock:
            if self._snap is not snap:
                # a background fit published meanwhile: it is the newer
                # model; the next tick extends from its watermark
                return 0
            self._version += 1
            self._snap = snap._replace(
                state=st, version=self._version, n_rows=i,
                threshold=thr, best_y=besty,
                in_bucket=snap.in_bucket + rows)
        self.incr_updates += rows
        return rows

    def force_refit(self) -> bool:
        """Fit now if the point count allows, ignoring the cadence (the
        warm-start hook).  Synchronous even under async_refit, after
        draining a background fit."""
        self.drain()
        self._since_fit = max(self._since_fit, self.refit_interval)
        if self.n_points < self.min_points:
            return False
        self._refit_full(*self._refit_args())
        return True

    def warm_start(self, feats: np.ndarray, qor: np.ndarray) -> bool:
        """Bulk-ingest externally recorded (features, engine-oriented
        QoR) rows and fit at once.  True when the model came out
        fitted."""
        self.observe(feats, qor)
        return self.force_refit()

    def _flip_probs(self) -> torch.Tensor:
        """[n_scalar] float32 weights of the pool's categorical flips, on
        the manager's device: uniform by default; with an online flip
        bias or a transferred screen, 75% of the mass follows the
        sensitivities and 25% stays uniform."""
        space = self.space
        n_cat = space.n_cat
        u = np.zeros(space.n_scalar)
        if n_cat:
            u[np.asarray(space.cat_lane_idx)] = 1.0 / n_cat
        w = None
        if self.flip_bias == "online":
            w = self._online_cat_w
        elif self.screen is not None:
            w = self.screen.cat_weight
        if w is None or not n_cat or float(np.sum(w)) <= 0:
            p = u
        else:
            w = np.asarray(w, np.float64) / float(np.sum(w))
            p = 0.75 * w + 0.25 * u
        return to_device(p.astype(np.float32), torch.float32, self.device)

    def predict_cands(self, cands: CandBatch):
        """Predictive moments of a candidate batch against the current
        snapshot: ``(mu [B], sd [B], version)`` as host numpy arrays
        (engine-oriented targets), or None when not fitted."""
        snap = self._snap
        if snap is None:
            return None
        feats = self._sx(self.space.features(cands))
        if self.kind == "gp":
            mu, sd = gp_mod.predict(snap.state, feats, self._n_cont,
                                    self._n_cat)
        else:
            mu, sd = mlp_mod.predict(snap.state, feats)
        mu, sd = to_host(mu, sd)
        return mu, sd, snap.version

    # ------------------------------------------------------------------
    def keep_mask(self, cands: CandBatch,
                  candidate_mask: Optional[np.ndarray] = None
                  ) -> Optional[np.ndarray]:
        """[B] bool host mask: True = evaluate; None when not fitted.
        `candidate_mask` marks the rows eligible for evaluation; topk
        ranks only among those.  The scores are computed on the device
        and read with the explore draw in one transfer; the rank, the
        threshold and the vote run on host numpy, as in the reference."""
        snap = self._snap
        if snap is None or snap.threshold is None:
            return None
        if self.passive or self.n_points < self.min_model_points:
            return None
        feats = self._sx(self.space.features(cands))
        b = feats.shape[0]
        use_ei = (self.select == "topk" and self.score_kind == "ei"
                  and snap.best_y is not None)
        self._key, ke = rng.split(self._key, 2).unbind(0)
        explore_u = self._draw_explore(ke, b)
        preds = None
        if self.kind == "gp":
            if use_ei:
                dev_score = -gp_mod.expected_improvement(
                    snap.state, feats, snap.best_y, self._n_cont,
                    self._n_cat)
            else:
                dev_score = gp_mod.lower_confidence_bound(
                    snap.state, feats, n_cont=self._n_cont,
                    n_cat=self._n_cat)
            score, explore_u = to_host(dev_score, explore_u)
        else:
            preds, explore_u = to_host(
                mlp_mod.predict_members(snap.state, feats), explore_u)
            score = preds.mean(axis=0)
            if use_ei:
                score = -gp_mod.ei_from_moments(
                    torch.from_numpy(score),
                    torch.from_numpy(preds.std(axis=0)),
                    snap.best_y).numpy()
        if self.select == "topk":
            if candidate_mask is not None:
                n_elig = int(np.asarray(candidate_mask).sum())
                score = np.where(candidate_mask, score, np.inf)
            else:
                n_elig = b
            k = max(1, int(round(n_elig * self.keep_frac)))
            keep = np.zeros(b, bool)
            if n_elig:
                keep[np.argsort(score)[:min(k, n_elig)]] = True
        elif self.kind == "gp":
            keep = score <= snap.threshold
        else:
            votes = (preds <= snap.threshold).mean(axis=0)
            keep = votes >= self.majority
        explore = explore_u < self.explore_frac
        if candidate_mask is not None:
            explore = explore & np.asarray(candidate_mask)
        return keep | explore

    # ------------------------------------------------------------------
    # the proposal plane: the best propose_batch rows of an oversampled
    # pool of perturbations of the incumbent, by the model's acquisition
    def _rank_pool(self, state, cands: CandBatch, best_y: torch.Tensor
                   ) -> torch.Tensor:
        """Indices of the pool's best n_out rows (ties to the lowest
        index).  A GP pool of PALLAS_MIN_POOL rows or more goes through
        the fused top-k; otherwise the moments are materialized and
        sorted."""
        from ..ops import acquire
        n_out = self._pool_geo.n_out
        score_ei = self.score_kind == "ei"
        nc, ncat = self._n_cont, self._n_cat
        feats = self._sx(self.space.features(cands))
        if self.kind == "gp":
            if self._pool_geo.pool >= PALLAS_MIN_POOL:
                _, idx = acquire.acquire_topk(
                    state, feats, n_out, kind="ei" if score_ei else "lcb",
                    best_y=best_y, beta=2.0, n_cont=nc, n_cat=ncat)
                return idx.long()
            if score_ei:
                score = -gp_mod.expected_improvement(state, feats, best_y,
                                                     nc, ncat)
            else:
                score = gp_mod.lower_confidence_bound(state, feats,
                                                      n_cont=nc, n_cat=ncat)
        else:
            preds = mlp_mod.predict_members(state, feats)
            mu, sd = preds.mean(0), preds.std(0, correction=0)
            if score_ei:
                score = -gp_mod.ei_from_moments(mu, sd, best_y)
            else:
                score = mu - 2.0 * sd
        return torch.argsort(score, stable=True)[:n_out]

    def propose_pool(self, key, best_u, best_perms, best_y):
        """The acquisition's best CandBatch of `propose_batch` rows from
        a pool around the incumbent, or None when disabled, not yet
        fitted or passive.  The pool's geometry is fixed at the first
        call, as the JAX manager builds its program then."""
        snap = self._snap
        if self.propose_batch <= 0 or snap is None:
            return None
        if self.passive or self.n_points < self.min_model_points:
            return None
        if self._pool_geo is None:
            self._pool_geo = pool_geometry(self.space, self.propose_batch,
                                           self.pool_mult)
        draws = self._draw_pool(key)
        cands = pool_candidates(self.space, self._pool_geo, draws, best_u,
                                best_perms, self._flip_probs())
        by = torch.full((), float(best_y), dtype=torch.float32,
                        device=self.device)
        return cands[self._rank_pool(snap.state, cands, by)]
