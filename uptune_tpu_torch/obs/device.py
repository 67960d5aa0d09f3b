"""Device-plane telemetry for the card: dispatch counts, the
per-program registry, roofline utilisation and the profiler capture.

The counterpart of `uptune_tpu/obs/device.py`, redone for CUDA.  The
obs plane watches the host (spans, metrics, distributed traces) and the
search (journal, quality gauges); this module watches the DEVICE:

* **Dispatches** — `instrument(fn, name)` (the implementation behind
  ``obs.instrument_device_fn``, the seam wrapping the engines' steps
  and the driver's per-arm proposals, dedup and commit) runs each call
  under a `device_span` and counts it with its host seconds.  The
  card's own time is the profiler capture's (below): the host spans
  are laid over its kernels on one clock (`obs.to_unix_ns`).
* **Registry + gauges** — per-program records (`programs()`) publish
  ``device.*`` counters, gauges and histograms into ``obs.metrics``, so
  the flight recorder, the Prometheus exposition and ``ut report``'s
  "Device & compile" section carry them.  `record_window(name, wall_s)`
  turns a MEASURED window (caller-blocked wall seconds) and the work
  the caller counted for it (`harvest` / `set_cost`) into achieved
  FLOP/s and HBM B/s and their utilisation against `PEAKS`.
* **Profiler capture** — `start_trace(dir)` / `stop_trace()` wrap
  ``torch.profiler`` so ``--device-trace DIR`` / ``UT_DEVICE_TRACE``
  write a Chrome trace of the CUDA kernels (``DIR/device_trace.json``);
  the directory is referenced from the host trace's export
  (``otherData.device_trace``), and the host spans opened through
  `device_span` appear in it as ``record_function`` ranges of the same
  names, so the two line up.

There is no compiler here to harvest: PyTorch runs eagerly and the CUDA
kernels are built once by `native.build`, outside any instrumented
call.  So there is no cost model read at compile time, no
``engine.compile`` span and no compile-cache listener: `compile_totals`
stays (0, 0.0) and the driver's ``StepStats.n_compiles`` /
``t_compile`` stay 0.  A cost (FLOPs, bytes) comes from the caller,
who counts it (`harvest` of its own record, `set_cost`).

Disabled is free, as in the rest of the package: every entry point
checks the core flag first.  torch is never imported here at module
level: the CUDA paths run only when torch is already in
``sys.modules`` (the driver's process); a tuned program's child never
loads it.
"""
from __future__ import annotations

import functools
import os
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import core, metrics

__all__ = [
    "PEAKS", "resolve_peaks", "utilization", "harvest",
    "validate_record", "instrument", "record_window", "programs",
    "compile_totals", "reset_registry", "start_trace", "stop_trace",
    "trace_dir", "maybe_trace_from_env", "set_cost",
]

# Published peaks for roofline estimates: substring of the device name
# (torch.cuda.get_device_name) -> (peak FLOP/s, peak HBM B/s).  H100 SXM,
# NVIDIA's data sheet: 989.4 TFLOP/s dense BF16 on the tensor cores,
# 3.35 TB/s of HBM3.  The BF16 peak is quoted although the port computes
# in f32 and 3xTF32, so a FLOP utilisation read against it is a
# conservative lower bound.  Other devices (the CPU, other cards)
# resolve to None and get NO utilisation claims.  The keys `mxu_util` /
# `hbm_util` keep the reference's schema (the matrix units' share, here
# the tensor cores').
PEAKS: Dict[str, Tuple[float, float]] = {
    "h100": (989.4e12, 3.35e12),
}


def resolve_peaks(device_kind: Optional[str]
                  ) -> Optional[Tuple[float, float]]:
    """(peak_flops_per_s, peak_hbm_bytes_per_s) for a device name, by
    case-insensitive substring match against `PEAKS`; None when the
    device is unknown (no roofline claims for it)."""
    kind = (device_kind or "").lower()
    for sub, peaks in PEAKS.items():
        if sub in kind:
            return peaks
    return None


def utilization(device_kind: Optional[str],
                flops_per_s: Optional[float] = None,
                bytes_per_s: Optional[float] = None) -> Dict[str, Any]:
    """Roofline utilisation against the published peaks: empty for
    unknown devices, peaks always present for known ones,
    `mxu_util`/`hbm_util` when the achieved rates are given."""
    peaks = resolve_peaks(device_kind)
    if peaks is None:
        return {}
    pf, pb = peaks
    out: Dict[str, Any] = {"peak_flops_per_s": pf,
                           "peak_hbm_bytes_per_s": pb}
    if flops_per_s:
        out["mxu_util"] = round(flops_per_s / pf, 6)
    if bytes_per_s:
        out["hbm_util"] = round(bytes_per_s / pb, 4)
    return out


# ------------------------------------------------------------ harvest
def harvest(cost) -> Dict[str, Any]:
    """A cost record in the reference's schema (`validate_record`) from
    the work a caller counted: a mapping with any of ``flops``,
    ``bytes_accessed``, ``transcendentals`` and ``peak_memory``.  Fields
    it does not give are None; anything else (an object without those
    keys) gives the empty record.  The port has no compiler cost model
    to read."""
    rec: Dict[str, Any] = {"flops": None, "bytes_accessed": None,
                           "transcendentals": None, "peak_memory": None}
    if isinstance(cost, dict):
        for field in ("flops", "bytes_accessed", "transcendentals"):
            v = cost.get(field)
            if isinstance(v, (int, float)) and v > 0:
                rec[field] = float(v)
        pm = cost.get("peak_memory")
        if isinstance(pm, dict):
            rec["peak_memory"] = {k: int(pm.get(k, 0)) for k in _MEM_KEYS}
    if rec["flops"] and rec["bytes_accessed"]:
        rec["arith_intensity"] = round(
            rec["flops"] / rec["bytes_accessed"], 6)
    else:
        rec["arith_intensity"] = None
    return rec


_MEM_KEYS = ("temp_bytes", "argument_bytes", "output_bytes",
             "alias_bytes", "generated_code_bytes")


def validate_record(rec: Any) -> None:
    """Schema contract for a cost record (raises ValueError) — what
    tests and artifact consumers hold `harvest` output to."""
    def fail(msg):
        raise ValueError(f"device record schema: {msg}")

    if not isinstance(rec, dict):
        fail("record must be a dict")
    for k in ("flops", "bytes_accessed", "transcendentals",
              "arith_intensity"):
        if k not in rec:
            fail(f"missing {k!r}")
        v = rec[k]
        if v is not None and (not isinstance(v, (int, float))
                              or v < 0):
            fail(f"{k!r} must be a non-negative number or None")
    if "peak_memory" not in rec:
        fail("missing 'peak_memory'")
    pm = rec["peak_memory"]
    if pm is not None:
        if not isinstance(pm, dict):
            fail("'peak_memory' must be a dict or None")
        for k in _MEM_KEYS:
            if not isinstance(pm.get(k), int) or pm[k] < 0:
                fail(f"peak_memory.{k} must be a non-negative int")


# ----------------------------------------------------------- registry
_LOCK = threading.Lock()
_PROGRAMS: Dict[str, Dict[str, Any]] = {}


def _program(name: str) -> Dict[str, Any]:
    rec = _PROGRAMS.get(name)
    if rec is None:
        rec = _PROGRAMS[name] = {
            "name": name, "cost": None, "compiles": 0,
            "compile_s": 0.0, "cache": None, "cache_hits": 0,
            "cache_misses": 0, "dispatches": 0, "dispatch_s": 0.0,
        }
    return rec


def programs() -> Dict[str, Dict[str, Any]]:
    """Per-program telemetry records (copies): dispatch count and host
    seconds, the caller's cost record if any."""
    with _LOCK:
        return {k: dict(v) for k, v in _PROGRAMS.items()}


def compile_totals() -> Tuple[int, float]:
    """(compile count, compile seconds) since enable: always (0, 0.0) in
    the port, which compiles nothing on an instrumented path (the
    driver's StepStats read deltas of it)."""
    return 0, 0.0


def reset_registry() -> None:
    with _LOCK:
        _PROGRAMS.clear()


def set_cost(name: str, cost: Dict[str, Any]) -> Dict[str, Any]:
    """Attach a cost record (`harvest` of the caller's count) to program
    `name` and publish its gauges; returns the record."""
    rec = harvest(cost)
    with _LOCK:
        _program(name)["cost"] = rec
        n = len(_PROGRAMS)
    if rec.get("flops"):
        metrics.gauge(f"device.flops.{name}", rec["flops"])
    if rec.get("bytes_accessed"):
        metrics.gauge(f"device.bytes.{name}", rec["bytes_accessed"])
    if rec.get("arith_intensity"):
        metrics.gauge(f"device.arith_intensity.{name}",
                      rec["arith_intensity"])
    metrics.gauge("device.programs", n)
    return rec


def _cuda():
    """torch.cuda when torch is already imported and holds a CUDA
    context, else None (no device name on a CPU-only run)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch.cuda if torch.cuda.is_initialized() else None
    except Exception:
        return None


def _device_kind() -> str:
    cuda = _cuda()
    if cuda is None:
        return ""
    try:
        return cuda.get_device_name(cuda.current_device()) or ""
    except Exception:
        return ""


def record_window(name: str, wall_s: float,
                  device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Publish achieved-rate and utilisation gauges for one MEASURED
    window of program `name` (caller-blocked wall seconds, the honest
    denominator) from the cost attached to it (`set_cost`).  Returns
    the computed fields; empty when telemetry is off or `name` has no
    cost."""
    if not core._ENABLED or wall_s <= 0:
        return {}
    with _LOCK:
        rec = _PROGRAMS.get(name)
        cost = dict(rec["cost"]) if rec and rec.get("cost") else None
    if not cost:
        return {}
    kind = _device_kind() if device_kind is None else device_kind
    out: Dict[str, Any] = {}
    flops, nbytes = cost.get("flops"), cost.get("bytes_accessed")
    if flops:
        out["achieved_flops_per_s"] = flops / wall_s
    if nbytes:
        out["achieved_hbm_bytes_per_s"] = nbytes / wall_s
    out.update(utilization(kind, out.get("achieved_flops_per_s"),
                           out.get("achieved_hbm_bytes_per_s")))
    if cost.get("arith_intensity"):
        out["arith_intensity"] = cost["arith_intensity"]
    for k, v in out.items():
        metrics.gauge(f"device.{k}.{name}", v)
        metrics.gauge(f"device.{k}", v)     # aggregate: last window
    return out


# --------------------------------------------------------- instrument
def instrument(fn, name: str, **attrs):
    """Wrap a device-dispatching callable for device telemetry — the
    implementation behind ``obs.instrument_device_fn``.

    Disabled path: one flag check.  Enabled path: the call runs under
    a `device_span`; its host dispatch time is recorded
    (``device.dispatches``, ``device.dispatch_ms``).  Other attributes
    of `fn` stay reachable through ``__wrapped__``."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if not core._ENABLED:
            return fn(*a, **kw)
        t0 = time.perf_counter()
        with core.device_span(name, **attrs):
            out = fn(*a, **kw)
        dur = time.perf_counter() - t0
        metrics.count("device.dispatches")
        metrics.observe("device.dispatch_ms", dur * 1e3)
        with _LOCK:
            rec = _program(name)
            rec["dispatches"] += 1
            rec["dispatch_s"] += dur
        return out

    return wrapper


# ------------------------------------------------- profiler capture
_TRACE: Dict[str, Any] = {"dir": None, "active": False, "prof": None}
TRACE_FILE = "device_trace.json"


def start_trace(out_dir: str) -> Optional[str]:
    """Start a ``torch.profiler`` capture (CPU activity, and CUDA's when
    the card is there) that `stop_trace` writes to
    ``<out_dir>/device_trace.json`` (the ``--device-trace DIR`` /
    ``UT_DEVICE_TRACE`` path); the directory is referenced from the
    host trace's export (``otherData.device_trace``).  Returns the
    directory, or None when the profiler cannot start.  Idempotent
    while a capture is active."""
    if _TRACE["active"]:
        return _TRACE["dir"]
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
    except Exception:
        return None
    _TRACE.update(dir=out_dir, active=True, prof=prof)
    return out_dir


def stop_trace() -> Optional[str]:
    """Stop an active profiler capture and write its Chrome trace;
    returns its directory (kept as `trace_dir()` so a later export
    still references it)."""
    if not _TRACE["active"]:
        return None
    _TRACE["active"] = False
    prof, _TRACE["prof"] = _TRACE["prof"], None
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(_TRACE["dir"], TRACE_FILE))
    except Exception:
        pass
    return _TRACE["dir"]


def trace_dir() -> Optional[str]:
    """Directory of the active (or last finished) profiler capture in
    this process — what the Chrome-trace export references."""
    return _TRACE["dir"]


def maybe_trace_from_env(env: Optional[dict] = None) -> Optional[str]:
    """``UT_DEVICE_TRACE=<dir>`` starts a profiler capture for this
    process (the CLI's ``--device-trace`` flag layers above it)."""
    e = os.environ if env is None else env
    val = e.get("UT_DEVICE_TRACE", "").strip()
    if not val or val.lower() in ("0", "off", "false", "none"):
        return None
    return start_trace(val)
