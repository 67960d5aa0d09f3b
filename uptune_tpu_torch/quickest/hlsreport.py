"""HLS-report feature extractor: design directories -> QuickEst CSV.

The port's copy of `uptune_tpu/quickest/hlsreport.py` (stdlib only).

The reference front-end walks LegUp HLS output trees and scrapes early
(pre-implementation) features plus post-fit targets into the feature CSV
the estimator trains on (`python/uptune/quickest/extract/
LegUp/funcs.py:270-447` ExtractData/ExtractData_file; the name lists at
funcs.py:154-267).  This module provides the same capability as a
declarative parse table driving one generic scraper — stdlib-only, so it
runs on hosts without the EDA tools installed.

Layout expectations (funcs.py:283-289): a design directory contains one
subdirectory per clock-period checkpoint matching ``*CP_<n>``; each holds
the HLS reports (``scheduling.legup.rpt``, ``resources.legup.rpt``,
``timingReport.legup.rpt``, ``*.v``) and, once implementation ran, the
fit report (``top.fit.rpt``) whose numbers are the prediction TARGETS.

Emitted CSV schema (funcs.py:274-281): ``Design_Path, Design_Index,
Device_Index, <early features...>, <operation counts...>, <targets...>``
— directly loadable by `uptune_tpu_torch.quickest.load_csv` with
``target_cols=TARGETS`` (drop the path column first or let preprocess
impute the non-numeric cells away).
"""
from __future__ import annotations

import csv
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# early scheduling/resource features (funcs.py:154-163)
BASE_FEATURES = [
    "Registers", "DSP Elements", "Combinational", "RAM Elements",
    "Logic Elements", "Clock Period", "Delay_of_path_max",
    "Delay_of_path_min", "Delay_of_path_mean", "Delay_of_path_med",
]

# operation-mix counts (funcs.py:165-244 lists ~80 of these; the set is
# design-suite-dependent, so discover_operations() can mine the actual
# names from a tree instead of hardcoding the reference's suite)
DEFAULT_OPERATIONS = [
    "signed_add_8", "signed_add_16", "signed_add_32", "signed_add_64",
    "signed_subtract_32", "signed_multiply_32", "signed_divide_32",
    "signed_comp_eq_8", "signed_comp_eq_32", "signed_comp_eq_64",
    "signed_comp_eq_mux_32", "signed_comp_lt_32", "signed_comp_gt_32",
    "shift_ll_32", "shift_rl_32", "bitwise_AND_32", "bitwise_OR_32",
    "bitwise_XOR_32", "mux_2_32", "reg_32",
]

# post-implementation targets (funcs.py:246-267)
TARGETS = [
    "Registers_used", "DSP_blocks_used", "ALUT_used",
    "Block_memory_bits_used", "RAM_blocks_used",
]

_CP_DIR = re.compile(r"^.*?CP_[0-9]+$")

# fit-report rows: line marker -> [(field, group)] over '; N / M' or '; N '
_FIT_ROWS: List[Tuple[str, List[Tuple[str, int]]]] = [
    ("; Total registers", [("Registers_used", 1)]),
    ("; Total block memory bits", [("Block_memory_bits_used", 1),
                                   ("Total_Block_memory_bits", 2)]),
    ("; Total RAM Blocks", [("RAM_blocks_used", 1),
                            ("Total_RAM_blocks", 2)]),
    ("; Total DSP Blocks", [("DSP_blocks_used", 1),
                            ("Total_DSP_blocks", 2)]),
    ("; Combinational ALUT usage for logic", [("ALUT_for_logic", 1)]),
    ("; Combinational ALUT usage for route-throughs",
     [("ALUT_for_route-throughs", 1)]),
    ("; Memory ALUT usage", [("ALUT_for_memory", 1)]),
]
_FIT_NUM = re.compile(r"; ([0-9,]+)(?: / ([0-9,]+))?")


def _to_int(txt: str) -> int:
    return int(txt.replace(",", ""))


def scrape_checkpoint(path: str,
                      operations: Sequence[str]) -> Dict[str, object]:
    """Scrape one ``*CP_<n>`` checkpoint directory into a flat record
    (missing reports simply leave their fields absent; operation counts
    default to 0 as in funcs.py:308-310)."""
    rec: Dict[str, object] = {op: 0 for op in operations}

    p = os.path.join(path, "scheduling.legup.rpt")
    if os.path.exists(p):
        with open(p, errors="replace") as f:
            for line in f:
                if "Clock period constraint" in line:
                    m = re.search(r": (.+)ns", line)
                    if m:
                        rec["Clock Period"] = float(m.group(1))
                    break

    p = os.path.join(path, "resources.legup.rpt")
    if os.path.exists(p):
        with open(p, errors="replace") as f:
            for line in f:
                for name in ("Logic Elements", "Combinational",
                             "Registers", "DSP Elements"):
                    if name in line:
                        # first number only: real report lines carry
                        # trailing text ('Registers: 450 / 114480 (12%)')
                        m = re.search(r": ([0-9,]+)", line)
                        if m:
                            rec[name] = _to_int(m.group(1))
                m = re.search(r'Operation "(.+)" x ([0-9,]+)', line)
                if m and m.group(1) in rec:
                    rec[m.group(1)] = _to_int(m.group(2))

    p = os.path.join(path, "timingReport.legup.rpt")
    if os.path.exists(p):
        delays: List[float] = []
        with open(p, errors="replace") as f:
            for line in f:
                m = re.search(r"-Delay of path:([0-9,.]+) ns-", line)
                if m:
                    delays.append(float(m.group(1).replace(",", "")))
        if delays:
            delays.sort()
            n = len(delays)
            med = (delays[n // 2] if n % 2 else
                   0.5 * (delays[n // 2 - 1] + delays[n // 2]))
            rec.update({"Delay_of_path_max": delays[-1],
                        "Delay_of_path_min": delays[0],
                        "Delay_of_path_mean": sum(delays) / n,
                        "Delay_of_path_med": med})
        else:
            rec.update({k: 0 for k in (
                "Delay_of_path_max", "Delay_of_path_min",
                "Delay_of_path_mean", "Delay_of_path_med")})

    # first match across the (sorted, deterministic) .v files wins;
    # generated netlists can be MBs, so stop at the first hit
    for fn in sorted(os.listdir(path)):
        if os.path.splitext(fn)[1] != ".v" or "RAM Elements" in rec:
            continue
        with open(os.path.join(path, fn), errors="replace") as f:
            for line in f:
                m = re.search(
                    r"// Number of RAM elements: ([0-9,]+)", line)
                if m:
                    rec["RAM Elements"] = _to_int(m.group(1))
                    break

    p = os.path.join(path, "top.fit.rpt")
    if os.path.exists(p):
        with open(p, errors="replace") as f:
            for line in f:
                for marker, fields in _FIT_ROWS:
                    if marker in line:
                        m = _FIT_NUM.search(line)
                        if m:
                            for field, g in fields:
                                if m.group(g) is not None:
                                    rec[field] = _to_int(m.group(g))
        aluts = [rec.get(k) for k in ("ALUT_for_logic",
                                      "ALUT_for_route-throughs",
                                      "ALUT_for_memory")]
        if any(a is not None for a in aluts):
            rec["ALUT_used"] = sum(a or 0 for a in aluts)
    return rec


def discover_operations(design_dirs: Iterable[str]) -> List[str]:
    """Mine the operation names actually present in a tree (the
    reference's WhatFeatures pass, funcs.py:454-470) so the CSV schema
    matches the design suite instead of a hardcoded list."""
    ops = set()
    for d in design_dirs:
        for cp in _iter_checkpoints(d):
            p = os.path.join(cp, "resources.legup.rpt")
            if not os.path.exists(p):
                continue
            with open(p, errors="replace") as f:
                for line in f:
                    m = re.search(r'Operation "(.+)" x ', line)
                    if m:
                        ops.add(m.group(1))
    return sorted(ops)


def _iter_checkpoints(design_dir: str) -> List[str]:
    if not os.path.isdir(design_dir):
        return []
    return sorted(os.path.join(design_dir, y)
                  for y in os.listdir(design_dir)
                  if _CP_DIR.match(y)
                  and os.path.isdir(os.path.join(design_dir, y)))


def extract(design_dirs: Sequence[str], out_csv: str,
            operations: Optional[Sequence[str]] = None,
            targets: Sequence[str] = tuple(TARGETS),
            require_targets: bool = True) -> int:
    """Walk design directories and write the QuickEst feature CSV;
    returns the number of data rows written.

    A checkpoint row is emitted only when every REQUESTED target was
    actually scraped (funcs.py:438-439 skips rows whose implementation
    never ran; here the gate follows the caller's `targets` so custom
    target sets aren't silently judged by the reference's two fields)
    unless ``require_targets=False`` (inference-time extraction, where
    the targets are what the estimator will predict)."""
    if operations is None:
        operations = discover_operations(design_dirs) or DEFAULT_OPERATIONS
    feat_cols = BASE_FEATURES + list(operations)
    header = (["Design_Path", "Design_Index", "Device_Index"]
              + feat_cols + list(targets))
    rows = 0
    with open(out_csv, "w", newline="") as out:
        w = csv.writer(out)
        w.writerow(header)
        for di, d in enumerate(design_dirs):
            for cp in _iter_checkpoints(d):
                rec = scrape_checkpoint(cp, operations)
                if require_targets and not all(t in rec for t in targets):
                    continue
                w.writerow([os.path.abspath(cp), di, 0]
                           + [rec.get(c, "") for c in feat_cols]
                           + [rec.get(t, "") for t in targets])
                rows += 1
    return rows
