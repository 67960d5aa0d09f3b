"""The port's package boundary: `uptune_tpu_torch` imports neither JAX nor
the JAX package, its entry points refuse to carry on quietly without a
card, and `chip_smoke.py` fails (printing no `ok` line) where it cannot
run the card."""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "uptune_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_pulls_in_no_jax():
    """Importing every module of the port, in a fresh interpreter (this
    one already has JAX loaded), leaves jax and uptune_tpu unimported."""
    code = (
        "import pkgutil, sys, importlib, uptune_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'uptune_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'uptune_tpu' or n.startswith('uptune_tpu.'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('uptune_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20, out.stdout


def test_batched_surface_and_merge_op_pull_in_no_jax():
    """`tune_batch` (api/batch.py), the batched engine and the merge's
    custom op (`torch.ops.uptune_tpu_torch.merge_rows`, the route vmap
    takes) load in a fresh interpreter without jax or uptune_tpu."""
    code = (
        "import sys, torch, uptune_tpu_torch as p\n"
        "from uptune_tpu_torch.engine import BatchedEngine, exchange_best\n"
        "from uptune_tpu_torch.ops import dedup\n"
        "assert p.tune_batch.__module__ == 'uptune_tpu_torch.api.batch'\n"
        "op = torch.ops.uptune_tpu_torch.merge_rows.default\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'uptune_tpu' or n.startswith('uptune_tpu.'))\n"
        "print(op, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "uptune_tpu_torch.merge_rows" in out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("root", ["uptune_tpu_torch", "chip_smoke.py"])
def test_no_jax_import_in_the_source(root):
    """A static scan: no `import jax`, and no module of the JAX package,
    anywhere under the port or in chip_smoke.py."""
    files = ([REPO / root] if root.endswith(".py")
             else sorted((REPO / root).rglob("*.py")))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "uptune_tpu"), (f, name)


@pytest.mark.parametrize("module", ["surrogate/manager.py",
                                    "surrogate/mlp.py",
                                    "surrogate/screen.py"])
def test_the_surrogate_modules_import_no_jax(module):
    """The surrogate manager and its model and screen modules exist and
    import neither JAX nor the JAX package (each keeps its own copy of
    what it needs)."""
    f = PKG / module
    names = list(_imports(f))
    assert f.is_file() and names
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "uptune_tpu")]


def test_fused_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from uptune_tpu_torch.engine import FusedEngine
    from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space
    space = rosenbrock_space(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedEngine(space, lambda v, p: rosenbrock_device(v))
    eng = FusedEngine(space, lambda v, p: rosenbrock_device(v), device="cpu")
    assert eng.device == torch.device("cpu")


def test_the_kernel_sources_ship_with_the_package():
    """Every launcher: its source under csrc/ exports its symbol, and each
    TPU kernel it replaces is a Pallas kernel body at the cited line."""
    from uptune_tpu_torch import native
    ks = native.KERNELS
    assert [k.name for k in ks] == ["merge_rows", "gp_mean", "gp_mean_var",
                                    "acquire_scores", "acquire_topk"]
    cited = []
    for k in ks:
        assert k.source.is_file() and k.source.parent == PKG / "csrc"
        src = k.source.read_text()
        assert f'extern "C" int {k.symbol}(' in src
        for r in k.replaces:
            path, line = r.split(":")
            text = (REPO / path).read_text().splitlines()[int(line) - 1]
            assert text.startswith("def _") and "kernel" in text, (r, text)
            cited.append(r)
    # the nine Pallas kernels of the JAX package, each replaced once
    assert len(cited) == len(set(cited)) == 9


def test_a_cached_library_reports_its_build_log(tmp_path, monkeypatch):
    """A reused library reads nvcc's output back from beside it, so the
    registers and shared memory of every kernel show on every run; no
    nvcc is run for it."""
    from uptune_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise AssertionError("nvcc run for a cached library")
    monkeypatch.setattr(native, "find_nvcc", no_nvcc)
    k = native.GP_MEAN
    lib = k.library_path()
    assert lib.parent == tmp_path and not lib.exists()
    assert k.build_log == ""
    lib.write_bytes(b"not a real library")
    native.log_path(lib).write_text(
        "ptxas info    : Used 96 registers, 8 bytes smem\n")
    assert native.build([k, native.ACQ_TOPK]) == {
        "gp_mean": lib, "acquire_topk": lib}
    assert "Used 96 registers" in k.build_log
    assert native.ACQ_TOPK.build_log == k.build_log   # one source, one log


def test_a_library_without_its_log_is_rebuilt(tmp_path, monkeypatch):
    """A library left without nvcc's output beside it (built before the
    log was kept) counts as missing: it is built again, so its log is
    there to read.  A stand-in compiler writes the library and a ptxas
    line; no real nvcc is run."""
    from uptune_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; fi; shift\n"
        "done\n"
        "printf rebuilt > \"$out\"\n"
        "echo 'ptxas info    : Used 40 registers'\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(native, "find_nvcc", lambda: str(nvcc))
    k = native.MERGE
    lib = k.library_path()
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"an old library")
    assert k.build_log == ""
    assert native.build([k]) == {"merge_rows": lib}
    assert lib.read_bytes() == b"rebuilt"
    assert "Used 40 registers" in k.build_log
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, native.log_path(lib).name])


GLOBAL_FN = re.compile(
    r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
    r"(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(")


def mangled(name: str, params: str) -> str:
    """The Itanium name of a kernel in an anonymous namespace, as ptxas
    prints it, with every template parameter at a sample value."""
    args = "".join("Lb1E" if p.split()[0] == "bool" else "Li128E"
                   for p in params.split(",")) if params else ""
    return (f"_ZN12_GLOBAL__N_1{len(name)}{name}"
            + (f"I{args}EEvPKf" if args else "EPKf"))


def test_the_ptxas_summary_names_every_kernel_function(monkeypatch):
    """Every `__global__` function of csrc/*.cu, at any template
    arguments, comes out of chip_smoke's ptxas summary by its short name,
    so a kernel cannot slip out of the register and spill report."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    names = []
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for params, name in GLOBAL_FN.findall(src.read_text()):
            names.append(name)
            log = (f"ptxas info    : Compiling entry function "
                   f"'{mangled(name, params.strip())}' for 'sm_90a'\n"
                   f"ptxas info    : Used 40 registers, used 1 barriers\n")
            (line,) = chip_smoke.ptxas_summary(log)
            assert line.startswith(name) and "_ZN" not in line, (src, line)
    assert {"gp_mean_kernel", "krows_kernel", "wq_kernel",
            "merge_rows_kernel"} <= set(names), names
    assert "gp_tile_kernel" not in names


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """In the checkout, and copied into a directory that holds nothing else
    of the repo, the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
