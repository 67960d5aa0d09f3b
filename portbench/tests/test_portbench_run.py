"""run.py as the driver starts it: no result without a card or without
the program, and on a card (the `card` marker) one correct result line
in the contract's schema."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]


def run_py(cwd: Path, cell: str, seconds: float = 2.0, trace: int = 0):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 12345), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=str(cwd), capture_output=True, text=True,
        timeout=600)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = run_py(ROOT, "flagship-s64.plain")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_with_the_benchmark_alone(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = run_py(tmp_path, "flagship-s64.plain")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card(card, trace):
    p = run_py(ROOT, "flagship-s64.plain", 3.0, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert spec.check_result(line, bool(trace)) == []
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.cell_metrics(bench, "flagship-s64.plain",
                                                 bool(trace))}
    assert set(line["metrics"]) == want
