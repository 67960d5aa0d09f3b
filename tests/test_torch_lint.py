"""Static checks of the port on the CPU: the lock rules over
`uptune_tpu_torch/` by the port's own analyzer, and the host side of
launchers B-D's launch planning (`csrc/gp_plan.h`), built with the host
compiler alone.

The lock rules R101-R106 (`python -m uptune_tpu_torch.analysis`, the
JAX package's rules, docs/LINT.md:
locks held across blocking calls, lock order, unguarded shared state)
apply to the port's threads as to the reference's: the surrogate refit
worker, the flight recorder, the telemetry shipper, the pool.  The
planning header holds the tile sizes, the scratch plan and which route
krows takes at a width: up to 361 features all of them in one block's
shared memory on the CUDA cores, past that the tensor cores (wgmma in
3xTF32), whose shared memory does not grow with F and which needs no
scratch word of its own."""
import ctypes
import shutil
import subprocess
import sys

import pytest

from uptune_tpu_torch import native

RULES = "R101,R102,R103,R104,R105,R106"
PLAN_H = native.CSRC / "gp_plan.h"
MAX_SHARED = 232448


def test_lock_rules_hold_over_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "uptune_tpu_torch.analysis",
         "uptune_tpu_torch", "--select", RULES, "--format", "text"],
        cwd=str(native.CSRC.parent.parent), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout + out.stderr


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """gp_plan.h built by the host compiler into a library of its own:
    the same queries the wrappers read from the CUDA library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no host C++ compiler"
    d = tmp_path_factory.mktemp("plan")
    (d / "plan.cpp").write_text('#include "gp_plan.h"\n')
    out = subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror",
         "-I", str(native.CSRC), "-o", str(d / "gp_plan.so"),
         str(d / "plan.cpp")], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    so = ctypes.CDLL(str(d / "gp_plan.so"))
    for name in ("ut_krows_shared_bytes", "ut_acquire_scratch_words"):
        getattr(so, name).restype = ctypes.c_longlong
    return so


def test_the_launch_library_includes_the_plan(tmp_path):
    """gp_tile.cu takes its geometry from the header and keeps no copy
    of it, and the library's name hashes the header with the source, so
    an edited plan rebuilds the launchers."""
    src = (native.CSRC / "gp_tile.cu").read_text()
    assert '#include "gp_plan.h"' in src
    for definition in ("bool make_plan(", "size_t krows_words(",
                       "constexpr int kTileN =", 'extern "C" int '
                       "ut_krows_route("):
        assert definition in PLAN_H.read_text()
        assert definition not in src
    for name in ("gp_tile.cu", "gp_plan.h"):
        shutil.copy(native.CSRC / name, tmp_path / name)
    before = native.library_path(tmp_path / "gp_tile.cu").name
    with open(tmp_path / "gp_plan.h", "a") as f:
        f.write("// edited\n")
    assert native.library_path(tmp_path / "gp_tile.cu").name != before


@pytest.mark.parametrize("f,route", [(1, 0), (31, 0), (360, 0), (361, 0),
                                     (362, 1), (400, 1), (1028, 1),
                                     (100_000, 1), (0, -1), (-3, -1)])
def test_krows_route_by_width(plan, f, route):
    """The CUDA-core route up to the 361 features one block holds, the
    tensor cores past it; nothing below one feature."""
    assert plan.ut_krows_route(f) == route


def test_krows_shared_memory_fits_at_every_width(plan):
    """The CUDA-core route's shared memory grows with F up to the
    block's limit; the tensor-core route's is one size at any F: two
    chunk buffers of both operands' TF32 planes (48 KiB each), the norms
    and the warps' partial means, so that two blocks share an SM."""
    smem = {f: plan.ut_krows_shared_bytes(f)
            for f in (1, 31, 361, 362, 1028, 100_000)}
    assert all(0 < v <= MAX_SHARED for v in smem.values())
    assert smem[31] < smem[361]
    assert smem[362] == smem[1028] == smem[100_000]
    assert smem[362] == 4 * (2 * 2 * (64 + 128) * 32 + 2 * 64 + 2 * 128
                             + 8 * 64) <= MAX_SHARED // 2
    assert plan.ut_krows_shared_bytes(0) == -1


@pytest.mark.parametrize("b,n,var,k", [(6040, 1024, 1, 128),
                                       (6040, 1024, 1, 0),
                                       (6040, 1024, 0, 0),
                                       (4096, 32, 1, 32), (1, 1, 1, 1)])
def test_scratch_words_do_not_depend_on_the_route(plan, b, n, var, k):
    """The scratch plan takes no width: both krows routes write k and
    the per-128-column mean partials to the same words.  The words are
    the partials (one [Bp] row per 128-column tile, for the mean and,
    with var, for q), the [Bp, Np] kernel rows and K^-1's two TF32
    planes with var, and the candidates."""
    tile = 128
    np_, bp = -(-n // tile) * tile, -(-b // tile) * tile
    n1 = -(-b // 256)
    k1 = min(k, 256)
    words = (np_ // tile) * bp * (2 if var else 1)
    if var:
        words += bp * np_ + 2 * np_ * np_
    words += 2 * n1 * k1
    assert plan.ut_acquire_scratch_words(b, n, var, k, 1) == words
    assert plan.ut_acquire_scratch_words(b, n, var, b + 1, 1) == -1


def test_the_wrapper_reads_the_route_from_the_library(monkeypatch):
    """`pallas_score.krows_route` asks the launchers' library (on the
    card: chip_smoke.py's gp_wide phase holds the answers there)."""
    from uptune_tpu_torch.surrogate import pallas_score as ps
    asked = []

    def query(name, *args, restype=None):
        asked.append((name, args))
        return 1
    monkeypatch.setattr(ps.MEAN_VAR_KERNEL, "query", query)
    assert ps.krows_route(1028) == "tensor_cores"
    assert asked == [("ut_krows_route", (1028,))]
