"""EDA report feature extractors: `ut.vhls` and `ut.quartus`.

Re-implements the reference's report scrapers —
`python/uptune/report.py:122-174` (Vivado HLS XML via
xmltodict, Quartus via add/features.py) and
`python/uptune/add/features.py:4-110` (STA summary,
synthesis report, fitter utilization line parsers) — with stdlib-only
parsing (xml.etree, no xmltodict/tabulate) and numeric feature dicts
instead of printed tables, so the extracted values feed directly into
`ut.feature` covariates, the surrogate, and QuickEst.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from .report import feature as register_feature


def _num(text: str) -> Any:
    """'1,234' -> 1234; '3.52' -> 3.52; otherwise the stripped string."""
    t = str(text).strip().replace(",", "")
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        return t


# ---------------------------------------------------------------- vhls
def vhls(path: str, target: Optional[str] = None,
         register: bool = False) -> Any:
    """Parse a Vivado HLS csynth XML report (report.py:122-161).

    Returns a flat dict: version/family/part/top plus numeric
    target_cp, estimated_cp, latency_min/max, interval_min/max, and
    per-resource {name}_used / {name}_avail / {name}_util_pct.
    `target` returns that single entry; `register=True` additionally
    registers every numeric entry as a `ut.feature` covariate."""
    if not os.path.isfile(path):
        raise RuntimeError(f"Cannot find {path}, run csyn first")
    root = ET.parse(path).getroot()      # <profile>

    def text(xpath: str, default: str = "") -> str:
        el = root.find(xpath)
        return el.text if el is not None and el.text is not None \
            else default

    res: Dict[str, Any] = {
        "hls_version": "Vivado HLS " + text("ReportVersion/Version"),
        "product_family": text("UserAssignments/ProductFamily"),
        "part": text("UserAssignments/Part"),
        "top": text("UserAssignments/TopModelName"),
        "clock_unit": text("UserAssignments/unit", "ns"),
        "target_cp": _num(text("UserAssignments/TargetClockPeriod", "0")),
        "estimated_cp": _num(text(
            "PerformanceEstimates/SummaryOfTimingAnalysis/"
            "EstimatedClockPeriod", "0")),
        "latency_min": _num(text(
            "PerformanceEstimates/SummaryOfOverallLatency/"
            "Best-caseLatency", "0")),
        "latency_max": _num(text(
            "PerformanceEstimates/SummaryOfOverallLatency/"
            "Worst-caseLatency", "0")),
        "interval_min": _num(text(
            "PerformanceEstimates/SummaryOfOverallLatency/"
            "Interval-min", "0")),
        "interval_max": _num(text(
            "PerformanceEstimates/SummaryOfOverallLatency/"
            "Interval-max", "0")),
    }
    est = root.find("AreaEstimates/Resources")
    avail = root.find("AreaEstimates/AvailableResources")
    for name in ("BRAM_18K", "DSP48E", "FF", "LUT"):
        used = _num(est.findtext(name, "0")) if est is not None else 0
        total = _num(avail.findtext(name, "0")) if avail is not None else 0
        key = name.lower()
        res[f"{key}_used"] = used
        res[f"{key}_avail"] = total
        res[f"{key}_util_pct"] = (
            round(100.0 * used / total, 2) if total else 0.0)
    if register:
        for k, v in res.items():
            if isinstance(v, (int, float)):
                register_feature(v, f"vhls_{k}")
    if target is not None:
        return res[target]
    return res


# ------------------------------------------------------------- quartus
def get_timing(design: str, workdir: str,
               stage: str) -> Tuple[Any, Any]:
    """(slack, tns) from {design}.sta.{stage}.summary
    (add/features.py:4-17); 'None' entries become 0."""
    def numeric(text: str) -> Any:
        v = _num(text)
        return 0 if isinstance(v, str) else v   # 'None' etc. -> 0

    slack: Any = 0
    tns: Any = 0
    path = os.path.join(workdir, f"{design}.sta.{stage}.summary")
    with open(path) as f:
        for line in f:
            if "Slack" in line:
                slack = numeric(line.split(":")[-1])
            elif "TNS" in line:
                tns = numeric(line.split(":")[-1])
                break
    return slack, tns


_SYN_KEYS = ("boundary_port", "fourteennm_ff", "fourteennm_lcell_comb",
             "fourteennm_mac", "Max LUT depth", "Average LUT depth")


def get_syn_features(design: str, workdir: str) -> "OrderedDict[str, Any]":
    """Synthesis-report resource rows (add/features.py:38-57): cells are
    the third ';'-separated column of the matching table line."""
    out: "OrderedDict[str, Any]" = OrderedDict(
        (k, 0) for k in _SYN_KEYS)
    path = os.path.join(workdir, f"{design}.syn.rpt")
    with open(path) as f:
        for line in f:
            for key in _SYN_KEYS:
                if key in line and out[key] == 0:
                    parts = line.split(";")
                    if len(parts) > 2:
                        out[key] = _num(parts[2])
                    break
    return out


_FIT_KEYS = ("Logic utilization (in ALMs)",
             "Total dedicated logic registers", "Total pins",
             "Total block memory bits", "Total RAM Blocks",
             "Total DSP Blocks")


def get_utilization(design: str, workdir: str,
                    stage: str) -> "OrderedDict[str, Any]":
    """Fitter summary utilization (add/features.py:60-80): 'key : a / b'
    lines keep the numerator."""
    out: "OrderedDict[str, Any]" = OrderedDict(
        (k, 0) for k in _FIT_KEYS)
    path = os.path.join(workdir, f"{design}.fit.{stage}.summary")
    with open(path) as f:
        for line in f:
            for key in _FIT_KEYS:
                if key in line and out[key] == 0:
                    val = line.split(":", 1)[1]
                    if "/" in val:
                        val = val.split("/")[0]
                    out[key] = _num(val)
                    break
    return out


def quartus(design: str, path: str, target: Optional[str] = None,
            stage: str = "syn", register: bool = True) -> Any:
    """Aggregate Quartus features for a design work dir and register
    them as covariates (report.py:163-174 getQuartus semantics).
    Missing report files contribute nothing rather than raising — the
    flow may not have reached every stage yet."""
    vec: Dict[str, Any] = {}
    try:
        slack, tns = get_timing(design, path, stage)
        vec["slack"], vec["tns"] = slack, tns
    except OSError:
        pass
    try:
        vec.update(get_syn_features(design, path))
    except OSError:
        pass
    try:
        vec.update(get_utilization(design, path, stage))
    except OSError:
        pass
    clean: Dict[str, Any] = {}
    for k, v in vec.items():
        if v == "None" or v is None:
            v = 0
        if not isinstance(v, (int, float)):
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
        clean[k] = v
        if register:
            register_feature(v, k)
    if target is not None:
        if target not in clean:
            raise KeyError(
                f"quartus feature {target!r} unavailable — its report "
                f"file under {path!r} is missing or the value was "
                f"non-numeric; extracted: {sorted(clean)}")
        return clean[target]
    return clean
