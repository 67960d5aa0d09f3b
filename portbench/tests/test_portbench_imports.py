"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program either.  Module names are
compared by their top-level name, whole: `uptune_tpu_torch` is not
`uptune_tpu`."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "uptune_tpu"}
PROGRAM = {"uptune_tpu_torch"}


def imported_tops(path: Path) -> set:
    """The top-level names of every module a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_jax_and_no_program(path):
    assert not imported_tops(path) & (JAX | PROGRAM)


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax(path):
    assert not imported_tops(path) & JAX


def test_top_level_names_are_whole(monkeypatch):
    """run.py's look at sys.modules takes `uptune_tpu_torch.x` for the
    program and `uptune_tpu.x` for the JAX package."""
    from portbench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "uptune_tpu_torch.probe", None)
    assert "uptune_tpu" not in forbidden_modules() or \
        "uptune_tpu" in {n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "uptune_tpu.probe", None)
    assert "uptune_tpu" in forbidden_modules()


def test_serve_clients_look_by_whole_names(monkeypatch):
    """Each serve client process reports what it holds by the same
    rule."""
    sys.path.insert(0, str(HERE / "drivers"))
    try:
        from serve_client import forbidden_modules
    finally:
        sys.path.remove(str(HERE / "drivers"))
    monkeypatch.setitem(sys.modules, "uptune_tpu_torch.probe", None)
    assert "uptune_tpu" not in forbidden_modules() or \
        "uptune_tpu" in {n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "uptune_tpu.probe", None)
    assert "uptune_tpu" in forbidden_modules()


RUN_A_CELL = r"""
import copy, json, sys, time
sys.path.insert(0, {root!r})
import portbench.run as R
import torch
from portbench import spec
bench = spec.load_benchmark()
if all(c["name"] != "rosenbrock-4d" for c in bench["configs"]):
    bench["configs"].append({{"name": "rosenbrock-4d",
                             "file": "portbench/configs/rosenbrock-4d.json"}})
cfg_of, mix_of = spec.config, spec.traffic
def small(b, name, root=spec.ROOT):
    c = copy.deepcopy(cfg_of(b, name, root))
    if name == "flagship-s64":
        c["arms"]["scale"] = 1; c["rows_per_step"] = 112
        c["history_capacity"] = 256; c["gp"]["train_rows"] = 64
    else:
        c["serve"]["tenants"] = 8
    return c
def mix(m):
    t = mix_of(m)
    if t.get("topk"): t["topk"] = 8
    if t["driver"] == "serve": t.update(client_processes=1, connections=2)
    return t
spec.config, spec.traffic = small, mix
line = R.run_cell(bench, {entry!r}, 5, 0.5, False,
                  torch.device("cpu"), time.time())
print(json.dumps({{"correct": line["correct"],
                  "loaded": sorted({{m.split(".")[0] for m in sys.modules}}
                                   & set({jax!r}))}}))
"""


@pytest.mark.parametrize("cell", ["flagship-s64.gp",
                                  "rosenbrock-4d.serve1024",
                                  "rosenbrock-4d.tuner"])
def test_a_cells_run_loads_no_jax(cell):
    """Everything a cell's run imports, in a fresh interpreter (here on
    the CPU, at a tiny size), and not one module of JAX or the JAX
    package among them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell),
                 {"name": cell, "config": "rosenbrock-4d",
                  "traffic": cell.split(".")[1], "chips": 1})
    code = RUN_A_CELL.format(root=str(ROOT), entry=entry, jax=sorted(JAX))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loaded": []}
