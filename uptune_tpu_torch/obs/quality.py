"""Online search-quality analytics derived from the tuning journal.

`QualityMonitor` consumes journal rows (as a `journal.add_sink`
subscriber) and maintains the live quality signals the system plane
cannot see: the convergence state of the incumbent, a simple-regret
proxy, rolling surrogate calibration (MAE, rank correlation, z-score
interval coverage), per-arm credit shares, dedup/prune/store-hit
rates, and a stall / miscalibration / failure-rate detector that
raises `obs` alert events.

Two properties are load-bearing:

* **Exact offline reproducibility.**  The monitor's only input is the
  journal row stream, its state is plain python floats/deques, and it
  never reads a clock — so `replay(rows)` over a journal FILE produces
  bit-identical gauges to the live run that wrote it (JSON round-trips
  python floats exactly).  The unit tests hold the online
  `obs.metrics` gauges to equality with a replay of the same journal.
* **Free distribution.**  With `publish=True` every gauge update also
  lands in the `obs.metrics` registry, so the signals ride the flight
  recorder timeline, the Prometheus exposition, the serve metrics op
  and the `ut top` "search" panel with zero extra wiring.

`SessionQuality` is the per-tenant sibling: a tiny always-on
accumulator each serve session updates at tell time, surfaced through
the server's ``{"op": "health"}`` op (docs/SERVING.md) so tenants and
a sharded front tier (the serving plane) can poll session health without
scraping the whole registry.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

from . import core, journal, metrics

__all__ = ["QualityConfig", "QualityMonitor", "SessionQuality",
           "attach", "detach", "replay", "add_alert_sink",
           "remove_alert_sink", "Z50", "Z95"]

# alert fan-out beyond the local obs plane: each sink receives every
# PUBLISHED alert record (live monitors only — offline `replay` keeps
# its alerts in `.alerts` and never calls sinks, preserving the
# exactness contract's purity).  The fleet-telemetry shipper
# (obs/ship.py) registers here so `obs.alert` events reach
# the hub the moment they fire, not a window later.
_ALERT_SINKS: List[Any] = []


def add_alert_sink(fn) -> None:
    if fn not in _ALERT_SINKS:
        _ALERT_SINKS.append(fn)


def remove_alert_sink(fn) -> None:
    try:
        _ALERT_SINKS.remove(fn)
    except ValueError:
        pass

# two-sided standard-normal quantiles for the nominal 50% / 95%
# predictive intervals the coverage gauges score
Z50 = 0.6745
Z95 = 1.96


class QualityConfig(NamedTuple):
    """Detector thresholds + rolling-window sizes.  Defaults are
    documented in docs/OBSERVABILITY.md; serve exposes its own
    (smaller) stall default through the health op."""
    cal_window: int = 128      # joined (mu, sigma, qor) rows kept
    qor_window: int = 64       # recent finite QoRs (regret proxy)
    rate_window: int = 64      # recent pulls (dedup/prune rates)
    fail_window: int = 32      # recent tells (failure rate)
    stall_tells: int = 200     # alert: no new best in N tells
    min_cal_rows: int = 40     # calibration alerts need >= this many
    cover95_lo: float = 0.5    # overconfident below this 95% coverage
    # intervals HUNDREDS of times wider than the typical error carry
    # no ranking information: median |z| under this fires the
    # detector (0.674 is the 50%-interval quantile; 1e-3 means the
    # claimed uncertainty is ~670x the actual error — a units bug or
    # a miswired sigma, not a conservative model).  High COVERAGE
    # alone is never a defect, and a cautious GP near convergence
    # legitimately sits at med |z| ~ 0.03 (the committed example)
    wide_z_lo: float = 1e-3
    fail_rate_hi: float = 0.5  # failing above this windowed rate
    # gauge-publication cadence in journal ROWS: detectors run on
    # every row (cheap running counters), but the derived gauges
    # (regret sort, calibration scan, rates, arm shares) recompute
    # every Nth row + at `finalize()` — the exactness contract holds
    # because replay applies the same cadence and both sides finalize
    publish_every: int = 8


def _rankcorr(xs: List[float], ys: List[float]) -> Optional[float]:
    """Spearman rank correlation via ordinal ranks (stable sort, so
    ties break deterministically — replay-exact by construction)."""
    n = len(xs)
    if n < 3:
        return None

    def ranks(v: List[float]) -> List[int]:
        order = sorted(range(n), key=lambda i: (v[i], i))
        r = [0] * n
        for rank, i in enumerate(order):
            r[i] = rank
        return r

    ra, rb = ranks(xs), ranks(ys)
    mean = (n - 1) / 2.0
    num = sum((a - mean) * (b - mean) for a, b in zip(ra, rb))
    den = sum((a - mean) ** 2 for a in ra)
    if den == 0:
        return None
    return num / den


class QualityMonitor:
    """Fold journal rows into live quality gauges + alerts.

    `publish=True` mirrors every gauge into `obs.metrics` (prefix
    ``search.``) and raises alerts as ``obs.alert`` events plus
    ``search.alerts.<kind>`` counters; `publish=False` (the offline
    replay mode) keeps everything in `.gauges` / `.alerts` only."""

    def __init__(self, config: Optional[QualityConfig] = None,
                 publish: bool = False):
        self.cfg = config or QualityConfig()
        self.publish = publish
        self.gauges: Dict[str, float] = {}
        self.alerts: List[Dict[str, Any]] = []
        # counts
        self.tells = 0
        self.new_bests = 0
        self.tells_since_best = 0
        self.store_hits = 0
        self.pulls = 0
        self.best: Optional[float] = None
        # rolling windows.  _ok and _pull_rows keep RUNNING aggregates
        # (count of failures / columnwise sums) updated on append and
        # evict: re-summing a 64-wide window on every step row was one
        # of the measurable costs inside the >= 0.95x hot-path budget
        cfg = self.cfg
        self._cal: deque = deque(maxlen=cfg.cal_window)   # (mu, sd, q)
        self._qors: deque = deque(maxlen=cfg.qor_window)
        self._ok: deque = deque()                         # bool
        self._ok_fails = 0
        self._pull_rows: deque = deque()
        self._pull_sums = [0, 0, 0, 0, 0]  # batch/trials/pruned/filt/dup
        # per-arm attribution (from step rows): [pulls, evals, bests]
        self.arm_stats: Dict[str, List[int]] = {}
        # detector re-arm state: one alert per episode
        self._armed = {"stall": True, "miscalibration": True,
                       "failures": True}
        self._t = 0.0              # last row's journal-relative time
        self._sense_max = False    # set by rows carrying sense="max"
        self._rows = 0             # tell-carrying rows (cadence clock)

    # -- plumbing ------------------------------------------------------
    def _set(self, name: str, value: Optional[float]) -> None:
        if value is None:
            self.gauges.pop(name, None)
            return
        value = float(value)
        # unchanged-value early exit: most per-row publications repeat
        # the previous value (stable arm shares, a flat incumbent) and
        # the metrics-lock round trip is the cost that matters on the
        # driver hot path
        if self.gauges.get(name) == value:
            return
        self.gauges[name] = value
        if self.publish:
            metrics.gauge(name, value)

    def _alert(self, kind: str, row_t: float, **info: Any) -> None:
        if not self._armed[kind]:
            return
        self._armed[kind] = False
        rec = {"kind": kind, "t": round(float(row_t), 6), **info}
        self.alerts.append(rec)
        self._set(f"search.alerts.{kind}",
                  self.gauges.get(f"search.alerts.{kind}", 0) + 1)
        if self.publish:
            core.event("obs.alert", **rec)
            metrics.count("search.alerts")
            for fn in list(_ALERT_SINKS):
                try:
                    fn(rec)
                except Exception:   # a sink must never fail the search
                    pass

    # -- row dispatch --------------------------------------------------
    def on_row(self, row: Dict[str, Any]) -> None:
        self._t = float(row.get("t", 0.0))
        ev = row.get("ev")
        if ev == "step":
            self._on_step(row)
        elif ev == "serve_tell":
            self._on_serve_tell(row)
        elif ev == "store_hit":
            self.store_hits += 1
            self._set("search.store_hit_rate",
                      self.store_hits / max(1, self.tells))
        elif ev == "snapshot":
            self._set("search.snapshot_version", row.get("version"))

    def _push_ok(self, ok: bool) -> None:
        ring = self._ok
        ring.append(ok)
        if not ok:
            self._ok_fails += 1
        if len(ring) > self.cfg.fail_window:
            if not ring.popleft():
                self._ok_fails -= 1

    # -- steps: per-trial outcome arrays + credit ----------------------
    def _on_step(self, row: Dict[str, Any]) -> None:
        if row.get("sense") == "max":
            self._sense_max = True
        arm = str(row.get("arm", "?"))
        st = self.arm_stats.setdefault(arm, [0, 0, 0])
        st[0] += 1
        st[1] += int(row.get("evaluated", 0))
        st[2] += int(bool(row.get("new_best")))
        qors = row.get("qors") or ()
        # fused inline copy of the compact-encoding semantics whose
        # reference decoder is journal.step_tells (absent `ok` = all
        # true, absent `nb` = all false) — change BOTH or neither.
        # The dominant row shape (every trial fine, no new best)
        # takes the BULK path — C-level deque.extend instead of a
        # per-trial python loop; this is the one per-TRIAL code path
        # in the monitor and it is measured against the hot-path
        # budget
        n = len(qors)
        oks = row.get("ok")
        nbs = row.get("nb")
        mus = row.get("mus")
        sigmas = row.get("sigmas")
        qor_ring, cal, ok_ring = self._qors, self._cal, self._ok
        if oks is None and nbs is None:
            self.tells += n
            self.tells_since_best += n
            ok_ring.extend([True] * n)
            over = len(ok_ring) - self.cfg.fail_window
            for _ in range(over if over > 0 else 0):
                if not ok_ring.popleft():
                    self._ok_fails -= 1
            qor_ring.extend(qors)
            if mus is not None:
                cal.extend(zip(mus, sigmas, qors))
        else:
            push_ok = self._push_ok
            since = self.tells_since_best
            for i in range(n):
                q = qors[i]
                ok = True if oks is None else bool(oks[i])
                self.tells += 1
                push_ok(ok)
                if nbs is not None and nbs[i]:
                    self.new_bests += 1
                    since = 0
                    self._armed["stall"] = True
                    if q is not None:
                        self.best = float(q)
                else:
                    since += 1
                if ok and q is not None:
                    qor_ring.append(float(q))
                    if mus is not None:
                        cal.append((float(mus[i]), float(sigmas[i]),
                                    float(q)))
            self.tells_since_best = since
        best = row.get("best")
        if best is not None:
            self.best = float(best)     # authoritative (incl. preload)
        batch = row.get("batch")
        if batch:
            # the pull verdicts ride the step row (captured at ticket
            # open): dedup / prune / filter rates over a rolling pull
            # window, via running columnwise sums
            self.pulls += 1
            rec = (int(batch), int(row.get("trials", 0)),
                   int(row.get("pruned", 0)),
                   int(row.get("filtered", 0)),
                   int(row.get("dup", 0)))
            sums = self._pull_sums
            ring = self._pull_rows
            ring.append(rec)
            for j in range(5):
                sums[j] += rec[j]
            if len(ring) > self.cfg.rate_window:
                old = ring.popleft()
                for j in range(5):
                    sums[j] -= old[j]
        self._after_tells()

    def _on_serve_tell(self, row: Dict[str, Any]) -> None:
        """Serve-session rows: the global stream mixes tenants whose
        QoR scales are incomparable, so ONLY tenant-agnostic signals
        update here — tell count and the failure window.  One
        tenant's new best must not reset the (cross-tenant
        meaningless) stall counter or overwrite `search.best_qor`;
        per-session convergence verdicts live in SessionQuality and
        the health op."""
        self.tells += 1
        self._push_ok(bool(row.get("ok")))
        self._after_tells()

    def _after_tells(self) -> None:
        """Per-row detectors (cheap running counters), plus the full
        gauge publication at the `publish_every` row cadence — the
        heavy recomputation (regret sort, calibration scan, rates,
        arm shares) off the every-row path is what keeps the journal
        inside the >= 0.95x hot-path budget.  `finalize()` publishes
        the terminal state, so end-of-run reads are cadence-exact."""
        cfg = self.cfg
        self._rows += 1
        # detectors run on EVERY row: an alert must not wait out the
        # publication cadence
        if self.tells_since_best >= cfg.stall_tells:
            self._alert("stall", self._t,
                        tells_since_best=self.tells_since_best,
                        best=self.best)
        n_ok = len(self._ok)
        fr = self._ok_fails / n_ok if n_ok else None
        if fr is not None and n_ok >= cfg.fail_window \
                and fr > cfg.fail_rate_hi:
            self._alert("failures", self._t, fail_rate=round(fr, 6))
        elif fr is not None and fr <= cfg.fail_rate_hi:
            self._armed["failures"] = True
        if self._rows % max(1, cfg.publish_every) == 0:
            self._publish()

    def finalize(self) -> None:
        """Publish the terminal gauge state.  Called by `detach` /
        `obs.stop_journal` on the live side and by `replay` on the
        offline side — BOTH finalize, which is what keeps the
        cadence-batched gauges exactly equal across them."""
        self._publish()

    def _publish(self) -> None:
        self._set("search.tells", self.tells)
        self._set("search.new_bests", self.new_bests)
        self._set("search.tells_since_best", self.tells_since_best)
        self._set("search.best_qor", self.best)
        # simple-regret proxy: how far the *typical* recent sample sits
        # above the incumbent (sense-normalized: rows carry
        # user-oriented values, and rows spell out sense="max") — high
        # means still exploring, -> 0 as the search concentrates on the
        # optimum region.  A proxy, not regret: the true optimum is
        # unknown mid-run.
        if self._qors and self.best is not None:
            qs = sorted(self._qors)
            med = qs[len(qs) // 2]
            self._set("search.regret_proxy",
                      self.best - med if self._sense_max
                      else med - self.best)
        if self._ok:
            self._set("search.fail_rate",
                      self._ok_fails / len(self._ok))
        tot = self._pull_sums[0]
        if tot:
            self._set("search.pulls", self.pulls)
            self._set("search.dup_rate", self._pull_sums[4] / tot)
            self._set("search.prune_rate", self._pull_sums[2] / tot)
            self._set("search.novel_rate", self._pull_sums[1] / tot)
        evals = sum(s[1] for s in self.arm_stats.values())
        bests = sum(s[2] for s in self.arm_stats.values())
        for name, s in self.arm_stats.items():
            if evals:
                self._set(f"search.arm_evals_share.{name}",
                          s[1] / evals)
            if bests:
                self._set(f"search.arm_best_share.{name}",
                          s[2] / bests)
        self._recalibrate()

    def _recalibrate(self) -> None:
        cfg = self.cfg
        n = len(self._cal)
        if not n:
            return
        mus = [m for m, _, _ in self._cal]
        qs = [q for _, _, q in self._cal]
        abs_err = [abs(q - m) for m, _, q in self._cal]
        azs = sorted(abs(q - m) / max(s, 1e-12)
                     for m, s, q in self._cal)
        cover50 = sum(1 for z in azs if z <= Z50) / n
        cover95 = sum(1 for z in azs if z <= Z95) / n
        med_z = azs[n // 2]
        self._set("search.cal_rows", n)
        self._set("search.cal_mae", sum(abs_err) / n)
        self._set("search.cal_rank_corr", _rankcorr(mus, qs))
        self._set("search.cal_cover50", cover50)
        self._set("search.cal_cover95", cover95)
        self._set("search.cal_med_abs_z", med_z)
        if n >= cfg.min_cal_rows:
            bad = (cover95 < cfg.cover95_lo or med_z < cfg.wide_z_lo)
            if bad:
                self._alert("miscalibration", self._t,
                            cover50=round(cover50, 6),
                            cover95=round(cover95, 6),
                            med_abs_z=round(med_z, 6))
            else:
                self._armed["miscalibration"] = True

    # journal sink protocol: the monitor IS its row callback
    def __call__(self, row: Dict[str, Any]) -> None:
        self.on_row(row)


def attach(config: Optional[QualityConfig] = None) -> QualityMonitor:
    """Create a publishing monitor and subscribe it to the journal
    stream; the caller owns `detach`."""
    mon = QualityMonitor(config, publish=True)
    journal.add_sink(mon)
    return mon


def detach(mon: QualityMonitor) -> None:
    journal.remove_sink(mon)
    mon.finalize()


def replay(rows, config: Optional[QualityConfig] = None
           ) -> QualityMonitor:
    """Offline recomputation: feed journal rows (as `journal.read`
    returns them) through a fresh non-publishing monitor.  On the rows
    a live run journaled, the result's `.gauges`/`.alerts` equal the
    live monitor's exactly — the property `ut report` and the
    online-vs-offline unit tests rest on."""
    mon = QualityMonitor(config, publish=False)
    for row in rows:
        mon(row)
    mon.finalize()
    return mon


class SessionQuality:
    """Per-serve-session health accumulator: a few integers and one
    bounded ring, updated under the session's group lock at tell time
    (always on — cheap enough that the health op needs no flag)."""

    __slots__ = ("tells", "new_bests", "tells_since_best", "_ok")

    FAIL_WINDOW = 32

    def __init__(self):
        self.tells = 0
        self.new_bests = 0
        self.tells_since_best = 0
        self._ok: deque = deque(maxlen=self.FAIL_WINDOW)

    def on_tell(self, ok: bool, new_best: bool) -> None:
        self.tells += 1
        self._ok.append(bool(ok))
        if new_best:
            self.new_bests += 1
            self.tells_since_best = 0
        else:
            self.tells_since_best += 1

    def fail_rate(self) -> Optional[float]:
        if not self._ok:
            return None
        return round((len(self._ok) - sum(self._ok)) / len(self._ok), 6)

    def health(self, *, stall_tells: int = 64,
               fail_rate_hi: float = 0.5) -> Dict[str, Any]:
        """One status verdict + the numbers behind it.  `cold` = no
        tells yet; `failing` wins over `stalled` (a session whose
        builds all fail is stalled *because* it is failing)."""
        fr = self.fail_rate()
        if self.tells == 0:
            status = "cold"
        elif fr is not None and len(self._ok) >= self._ok.maxlen \
                and fr > fail_rate_hi:
            status = "failing"
        elif self.tells_since_best >= stall_tells:
            status = "stalled"
        else:
            status = "ok"
        return {"status": status, "tells": self.tells,
                "new_bests": self.new_bests,
                "tells_since_best": self.tells_since_best,
                "fail_rate": fr}

    def state(self) -> list:
        """JSON-clean snapshot for the serve checkpoint plane:
        counters + the failure ring as 0/1 bits, so a
        restored session's health verdict replays exactly."""
        return [self.tells, self.new_bests, self.tells_since_best,
                [1 if b else 0 for b in self._ok]]

    def restore(self, state) -> None:
        try:
            tells, new_bests, since, ring = state
            self.tells = int(tells)
            self.new_bests = int(new_bests)
            self.tells_since_best = int(since)
            self._ok = deque((bool(b) for b in ring),
                             maxlen=self.FAIL_WINDOW)
        except (TypeError, ValueError):
            pass        # a malformed record degrades health, not restore
