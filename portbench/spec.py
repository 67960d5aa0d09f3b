"""BENCHMARK.json and the files it names: loading, the name rules, and
the schema of a run's last line."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
TRACE_DEVICE_KEYS = ("busy_s", "window_s")


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    return _named(bench["workloads"], name, "workload")


def config(bench: Dict[str, Any], name: str,
           root: Path = ROOT) -> Dict[str, Any]:
    """The configuration file that BENCHMARK.json names for `name`."""
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def traffic(mix: str) -> Dict[str, Any]:
    """`traffic/<mix>.json`: the mix's parameters and its `driver`."""
    return json.loads((HERE / "traffic" / f"{mix}.json").read_text())


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    `trace` off, its per-layer metrics with it on (each metric without a
    `workloads` key belongs to every cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", (cell,))]


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """`metrics/<name>.py`'s `read(ctx) -> float | None`."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_result(line: Dict[str, Any], trace: bool) -> list:
    """What is wrong with a result line against the contract: [] when
    nothing is."""
    bad = [f"missing key {k}" for k in RESULT_KEYS if k not in line]
    if bad:
        return bad
    if not isinstance(line["correct"], bool):
        bad.append("correct is not a bool")
    for k in ("attempted", "failed"):
        if not isinstance(line[k], int) or line[k] < 0:
            bad.append(f"{k} is not a count")
    for name, m in line["metrics"].items():
        if not NAME.match(name):
            bad.append(f"metric name {name!r}")
        if set(m) != {"value", "unit"} or not UNIT.match(str(m["unit"])):
            bad.append(f"metric {name}: {m}")
        elif not isinstance(m["value"], (int, float)) or m["value"] != \
                m["value"]:
            bad.append(f"metric {name} value {m['value']!r}")
    dev = line["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        if k not in dev:
            bad.append(f"device lacks {k}")
    if trace:
        for k in TRACE_DEVICE_KEYS:
            if not isinstance(dev.get(k), (int, float)):
                bad.append(f"device lacks {k}")
        if "breakdown" in line:
            for k, rows in line["breakdown"].items():
                if k not in ("device_ops", "idle_gaps") or len(rows) > 10:
                    bad.append(f"breakdown {k}")
    return bad
